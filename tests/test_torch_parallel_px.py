"""The port's PX shards (``parallel.receive.sharded_fm_chain_px``, which no
JAX test drives) against the JAX package's on the CPU, over a 1 x 2 mesh
of gloo ranks, and the exchange routes of the sharded steps.  The ranks,
the tolerances and the capture's framing are tests/test_torch_parallel.py's:
every output exact against JAX, the bits against the transmitted ones."""

import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.parallel import receive as JPR
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix, build_px_stream
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu_torch.parallel import receive as TPR

from . import parallel_ranks as PRK
from .test_torch_parallel import _devices, _ranks, _save


def test_sharded_fm_chain_px(rng, tmp_path):
    """``sharded_fm_chain_px`` (no JAX test drives it) over a 1 x 2 mesh of
    MP3: two IV cycles, one a shard, each shard re-priming the IV state
    from its left halo.  Every P1 frame and shard 1's PX1 frames (the
    stream's second IV cycle; shard 0's first is the stream's own warm-up)
    exact against the transmitted bits, and every output as JAX's."""
    _devices(2)
    n_time, n_blocks, psmi = 2, 32, 3
    fl = C.P3_FRAME_LEN_MP3_MP11
    n_frames = n_time * n_blocks // 16
    p1 = rng.integers(0, 2, (n_frames, C.P1_FRAME_LEN_FM)).astype(np.uint8)
    pids = np.zeros((16, C.PIDS_FRAME_LEN), np.uint8)
    px1 = rng.integers(0, 2, (n_time, 16, fl)).astype(np.uint8)
    matrix = np.concatenate([build_pm_matrix(p1[f], pids)
                             for f in range(n_frames)]
                            + [build_pm_matrix(p1[0], pids)[:32]])
    signs = build_px_stream(px1, fl).reshape(n_time * n_blocks * C.BLKSZ, -1)
    signs = np.concatenate([signs, signs[:32]])
    bc_seq = np.concatenate([np.tile(np.arange(16), n_frames), [0]])
    sig = ch.impair(modulate_fm(matrix, bc_seq, psmi, px1_signs=signs),
                    snr_db=25.0, rng=rng)
    total = n_time * JPR.shard_chunk_len(n_blocks)
    buf = np.zeros(total + JPR.HALO, np.complex64)
    start = C.FFTCP_FM // 2
    buf[start:] = sig[:total + JPR.HALO - start]
    samples, tails = buf[None, :total], buf[None, total:]

    want = JPR.sharded_fm_chain_px(JPR.make_mesh(1, n_time), n_blocks,
                                   psmi)(samples, tails)
    res = _ranks(PRK.sharded, 2, "px", (1, n_time),
                 _save(tmp_path, samples=samples, tails=tails), n_blocks,
                 {"psmi": psmi})
    p1_out, px1_out = res[0]["global"]
    np.testing.assert_array_equal(p1_out, np.asarray(want[0]))
    np.testing.assert_array_equal(px1_out, np.asarray(want[1]))
    assert {q for r in res for q in r["quality"]} == {0.0}
    for f in range(n_frames):
        assert np.array_equal(p1_out[0, f], p1[f]), f
    per_shard = px1_out.shape[1] // n_time
    assert per_shard == n_blocks // 2
    for pair in range(16):
        assert np.array_equal(px1_out[0, per_shard + pair], px1[1, pair]), \
            pair


@pytest.mark.parametrize("backend,device,route", [
    ("gloo", "cpu", "direct"), ("nccl", "cuda", "direct"),
    ("gloo", "cuda", "host"), ("nccl", "cpu", None), ("mpi", "cpu", None),
    ("mpi", "cuda", None), ("ucc", "cpu", None), ("ucc", "cuda", None)])
def test_exchange_route(backend, device, route):
    """Which way a backend moves a device's tensors: straight for gloo and
    CPU tensors or NCCL and CUDA ones, through pinned host memory for gloo
    and CUDA tensors, and a raise for any other pairing (never a quiet move
    of the chain to the CPU)."""
    dev = torch.device(device)
    if route is None:
        with pytest.raises(ValueError, match="cannot move"):
            TPR.exchange_route(backend, dev)
    else:
        assert TPR.exchange_route(backend, dev) == route
