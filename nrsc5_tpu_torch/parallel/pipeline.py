"""Pipeline (stage) parallelism: frontend | FEC on two ranks of a
``stage`` mesh.

PyTorch counterpart of ``nrsc5_tpu/parallel/pipeline.py``.  The two halves
of the receive chain run on two ranks and overlap across frames:

    stage 0 (frontend): acquire derotate/fold/FFT -> Costas sync ->
        equalize -> soft demap       (one P1 frame = 16 L1 blocks a step)
    stage 1 (FEC):      deinterleave -> chunk-parallel Viterbi ->
        descramble -> PIDS decode

Each step stage 0 demodulates frame ``i`` and sends its soft bits ``pm``
[16, 23040] int8 to stage 1, which decodes frame ``i - 1`` meanwhile: a
depth-2 pipeline of ``n_frames + 1`` steps with one fill bubble.  The
exchanges follow :mod:`nrsc5_tpu_torch.parallel.receive` (gloo with CUDA
tensors stages ``pm`` through pinned host memory).  Stage 0 runs the
complex chain's :func:`~nrsc5_tpu_torch.pipeline.scan_chain.
fm_frontend_scan`; stage 1 the P1 and PIDS decodes (K6, K7 and K8 on a
card).  At the end the decoded frames come from stage 1 and the final
carry from stage 0, and both ranks return both.
"""

from __future__ import annotations

import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops.decode_fm import p1_decode, pids_decode
from nrsc5_tpu_torch.parallel.receive import Comm
from nrsc5_tpu_torch.pipeline import scan_chain as sc

PM_SHAPE = (C.P1_FM_BLOCKS, C.PM_BLOCK_SIZE)  # one P1 frame's soft bits


def make_stage_mesh(*, device="cuda"):
    """A 1-D ``DeviceMesh`` of dim ``("stage",)`` over the two ranks of the
    initialized process group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(K.resolve_device(device).type, (2,),
                            mesh_dim_names=("stage",))


def _frame_fec(pm_frame):
    """pm_frame: [16, 23040] int8 -> (p1 bits, margin, pids [16, 80])."""
    p1, margin, _ = p1_decode(pm_frame.reshape(1, -1))
    return p1[0], margin[0], pids_decode(pm_frame)


def pipelined_receive(samples, carry: sc.ChainCarry, n_frames: int, mesh,
                      psmi: int = 1):
    """Decode ``n_frames`` P1 frames with the frontend and the FEC
    pipelined across the two ranks of ``mesh``'s ``stage`` axis; both ranks
    call it with the same arguments.

    samples: [buffer_len(16 * n_frames)] complex64, steady-state framing
    (the first symbol FFTCP//2 + carry.offset in, the first block bc 0).
    Returns (dict with p1 [n_frames, 146176] uint8, p1_margin [n_frames],
    pids [n_frames, 16, 80]; the frontend's final ChainCarry) on every
    rank."""
    if mesh.mesh.shape != (2,):
        raise ValueError("pipeline depth 2: frontend | FEC")
    comm = Comm(mesh, samples.device)
    stage = comm.coord[0]
    peer = comm.ranks[1 - stage]
    p1s, margins, pidss = [], [], []
    cy = carry
    sent = None
    # n_frames + 1 steps: the first only fills stage 0, the last only
    # drains stage 1
    for t in range(n_frames + 1):
        if stage == 0 and t < n_frames:
            pm, _, _, cy = sc.fm_frontend_scan(samples, cy,
                                               C.P1_FM_BLOCKS, psmi)
            if sent is not None:
                sent.wait()
            sent = comm.isend(pm, peer)
        if stage == 1 and t > 0:
            pm, = comm.p2p([], [(PM_SHAPE, torch.int8, peer, 0)])
            p1, margin, pids = _frame_fec(pm)
            p1s.append(p1)
            margins.append(margin)
            pidss.append(pids)
    if sent is not None:
        sent.wait()

    # stage 1 hands the frames to stage 0, stage 0 the carry to stage 1
    leaves = sc.tree_leaves(carry)
    out_like = ((n_frames, C.P1_FRAME_LEN_FM), torch.uint8), \
        ((n_frames,), torch.float32), \
        ((n_frames, C.P1_FM_BLOCKS, C.PIDS_FRAME_LEN), torch.uint8)
    if stage == 0:
        got = comm.p2p([(x, peer, 1 + i) for i, x in
                        enumerate(sc.tree_leaves(cy))],
                       [(shape, dtype, peer, 100 + i)
                        for i, (shape, dtype) in enumerate(out_like)])
        outs = got
    else:
        outs = [torch.stack(p1s), torch.stack(margins), torch.stack(pidss)]
        got = comm.p2p([(x, peer, 100 + i) for i, x in enumerate(outs)],
                       [(x.shape, x.dtype, peer, 1 + i)
                        for i, x in enumerate(leaves)])
        cy = sc.tree_rebuild(carry, iter(got))
    return dict(zip(("p1", "p1_margin", "pids"), outs)), cy

