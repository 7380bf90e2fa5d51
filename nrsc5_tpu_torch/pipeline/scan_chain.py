"""The fused steady-state FM receive chain on complex64, and the geometry
helpers of the FM chains.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain.py``: once a
station is FINE-synced, its per-block control flow is fixed, so whole
P1 frames run as one call over a long sample stream (acquire's
derotation, fold and FFT, the Costas tracking, equalization and soft
demap, then the batched FEC):

    samples[T] --loop over blocks--> pm[B, 23040] --batched FEC-->
        p1 bits [F, 146176], pids bits [B, 80], PX bits by block pair

with the carried state (sample offset, acquire phase, Costas phase and
frequency, timing feedback) an explicit :class:`ChainCarry`.  The
reference's ``lax.scan`` over blocks is a Python loop of the complex ops
(:mod:`nrsc5_tpu_torch.ops.acquire`, :mod:`nrsc5_tpu_torch.ops.sync_fm`),
plain PyTorch on either device; its ``vmap`` over stations is a loop.
P1, PIDS and PX decode through :func:`~nrsc5_tpu_torch.ops.decode_fm.
p1_decode`, :func:`~nrsc5_tpu_torch.ops.decode_fm.pids_decode` and
:func:`~nrsc5_tpu_torch.ops.decode_fm.px_deinterleave` /
:func:`~nrsc5_tpu_torch.ops.decode_fm.px_fec`: kernels K6, K7, K8 and
K11 on a card, their plain versions on the CPU.  The turbo receiver
(:mod:`nrsc5_tpu_torch.pipeline.turbo`) runs it a frame a dispatch; the
rc chain of the serving path is :mod:`nrsc5_tpu_torch.pipeline.
scan_chain_rc`.

The reference's variable block consumption (src/acquire.c:259-262:
``keep = fftcp·3/2 − samperr``) is a bounded offset walk inside a
fixed-size buffer: in FINE state a block consumes ``32·FFTCP +
samperr_fb`` samples, so the caller provides ``SLACK`` extra samples of
headroom.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.acquire import (WINDOW_FM, AcquireState,
                                         acquire_fm_fine, acquire_init_state)
from nrsc5_tpu_torch.ops.acquire_rc import dynamic_start
from nrsc5_tpu_torch.ops.bits import pack_out
from nrsc5_tpu_torch.ops.decode_fm import (p1_decode, pids_decode,
                                           px_deinterleave, px_fec)
from nrsc5_tpu_torch.ops.sync_fm import (SyncState, sync_fm_block,
                                         sync_init_state)

SLACK = C.FFTCP_FM  # offset headroom for clock drift over a scan


def px_frame_lens(psmi: int) -> tuple[int, int]:
    """(px1 frame_len, px2 frame_len) in bits; 0 = channel absent
    (reference service-mode map: src/sync.c:30-35,339-357)."""
    cm = C.COMPATIBILITY_MODE[psmi]
    px1 = {2: C.P3_FRAME_LEN_MP2, 3: C.P3_FRAME_LEN_MP3_MP11,
           11: C.P3_FRAME_LEN_MP3_MP11}.get(cm, 0)
    px2 = C.P3_FRAME_LEN_MP3_MP11 if cm == 11 else 0
    return px1, px2


def iv_state_len(frame_len: int) -> int:
    """Entries of the carried interleaver-IV state of a PX channel of
    ``frame_len`` bits (0: the channel is absent)."""
    if frame_len == 0:
        return 0
    _, n, _ = IL.p3_iv_tables(frame_len)
    return n


def buffer_len(n_blocks: int) -> int:
    """Sample-buffer length the scan expects for ``n_blocks`` blocks."""
    return n_blocks * C.BLKSZ * C.FFTCP_FM + C.FFTCP_FM + SLACK


class ChainCarry(NamedTuple):
    offset: torch.Tensor  # int32 read position in the sample buffer
    acq: AcquireState
    sync: SyncState
    samperr_fb: torch.Tensor  # int32 previous block's clock-error estimate
    angle_fb: torch.Tensor  # float32 previous block's CFO-angle estimate


def chain_init_carry(offset: int = 0, *, device="cuda") -> ChainCarry:
    dev = K.resolve_device(device)
    return ChainCarry(
        offset=torch.tensor(offset, dtype=torch.int32, device=dev),
        acq=acquire_init_state(device=dev), sync=sync_init_state(device=dev),
        samperr_fb=torch.zeros((), dtype=torch.int32, device=dev),
        angle_fb=torch.zeros((), dtype=torch.float32, device=dev))


class PxState(NamedTuple):
    """Carried interleaver-IV state of the extended (PX) channels."""
    px1_internal: torch.Tensor  # [N or 0] int8
    px1_phase: torch.Tensor  # int32 IV call phase
    px2_internal: torch.Tensor  # [N or 0] int8
    px2_phase: torch.Tensor  # int32


def px_init_state(psmi: int, *, device="cuda") -> PxState:
    dev = K.resolve_device(device)
    fl1, fl2 = px_frame_lens(psmi)

    def zeros(n, dtype=torch.int8):
        return torch.zeros(n, dtype=dtype, device=dev)
    return PxState(px1_internal=zeros(iv_state_len(fl1)),
                   px1_phase=zeros((), torch.int32),
                   px2_internal=zeros(iv_state_len(fl2)),
                   px2_phase=zeros((), torch.int32))


def px_scan_pairs(px_scanned, n_blocks: int, first_bc: int, fl1: int,
                  fl2: int, states: dict):
    """The PX channels' interleaver-IV calls over pair-aligned block soft
    bits, then their Viterbis: ``px_scanned`` holds each active channel's
    [n_blocks, frame_len] int8 soft bits (px1 first), ``states`` maps
    ``"px1"``/``"px2"`` to their ``(iv_internal, call_phase)``.  A block
    pair is one IV call (K11 takes every pair of the call at once, in
    order), and each pair's frame decodes through K7 and K8.  Returns
    ``(outputs, new_states)``, outputs holding ``pxN`` bits [pairs,
    frame_len] and ``pxN_margin`` [pairs]."""
    assert first_bc % 2 == 0 and n_blocks % 2 == 0, \
        "PX decode needs pair-aligned blocks"
    out, new_states = {}, {}
    idx = 0
    for key, fl in (("px1", fl1), ("px2", fl2)):
        if not fl:
            continue
        llr = px_scanned[idx].reshape(1, n_blocks, fl)
        idx += 1
        internal, phase = states[key]
        ext, internal, phase = px_deinterleave(
            llr.contiguous(), internal.reshape(1, -1),
            phase.to(torch.int32).reshape(1))
        out[key], out[key + "_margin"] = px_fec(ext, fl)
        new_states[key] = (internal[0], phase[0])
    return out, new_states


def _window(samples: torch.Tensor, offset: torch.Tensor, n: int):
    """``samples[offset:offset + n]`` as ``lax.dynamic_slice`` cuts it (the
    start clamped into the buffer), by a gather: no host read-back."""
    start = dynamic_start(offset.long(), samples.shape[0], n)
    return samples[start + torch.arange(n, device=samples.device)]


def fm_frontend_scan(samples: torch.Tensor, carry: ChainCarry,
                     n_blocks: int, psmi: int = 1):
    """Run ``n_blocks`` FINE-state L1 blocks over ``samples``.

    samples: [buffer_len(n_blocks)] complex64 at 744187.5 S/s; the first
    OFDM symbol starts ``FFTCP//2 + carry.offset`` samples in.  Returns
    (pm [n_blocks, 23040] int8, diag dict, px_scanned tuple of per-block
    PX1/PX2 soft bits (empty for MP1 and MP5/MP6), new_carry)."""
    fftcp = C.FFTCP_FM
    cy = carry
    zero = torch.zeros((), dtype=torch.int32, device=samples.device)
    rows = []
    for _ in range(n_blocks):
        window = _window(samples, cy.offset, WINDOW_FM)
        spectra, acq, samperr, _, keep = acquire_fm_fine(
            window, cy.acq, cy.samperr_fb, cy.angle_fb, zero)
        out, sync = sync_fm_block(spectra, cy.sync, psmi,
                                  fftcp // 2 - samperr)
        cy = ChainCarry(offset=(cy.offset + WINDOW_FM - keep).to(torch.int32),
                        acq=acq, sync=sync, samperr_fb=out["samperr"],
                        angle_fb=out["angle"])
        rows.append(out)

    def stacked(key):
        return torch.stack([r[key] for r in rows])
    pm = stacked("pm")
    elb, eub = stacked("error_lb"), stacked("error_ub")
    px = tuple(stacked(k) for k in ("px1", "px2") if k in rows[0])
    return pm, {"samperr": stacked("samperr"), "error": elb + eub,
                "error_lb": elb, "error_ub": eub}, px, cy


def fm_chain_scan(samples: torch.Tensor, carry: ChainCarry, n_blocks: int,
                  psmi: int = 1, first_bc: int = 0,
                  px_state: PxState | None = None, packed: bool = False):
    """The full fused chain: :func:`fm_frontend_scan`, then PIDS for every
    block and P1 for every complete frame (16 aligned blocks) inside the
    scan; ``first_bc`` is the block count of the buffer's first block.
    For an extended service mode pass ``px_state`` (from
    :func:`px_init_state` or handed over by the per-block receiver): PX1
    and PX2 decode a block pair at a time, the state returned in
    ``out["px_state"]``; ``first_bc`` and ``n_blocks`` must be even.
    ``packed`` packs the decoded bits 8 to a byte (:func:`~nrsc5_tpu_torch.
    ops.bits.pack_out`).  Returns (dict with p1 [F, 146176] uint8,
    p1_margin [F], p1_bit_errors [F], pids [n_blocks, 80] uint8, diag;
    new carry)."""
    pm, diag, px_scanned, carry = fm_frontend_scan(samples, carry,
                                                   n_blocks, psmi)
    out = {"pids": pids_decode(pm), "diag": diag}
    skip = (C.P1_FM_BLOCKS - first_bc) % C.P1_FM_BLOCKS
    n_frames = (n_blocks - skip) // C.P1_FM_BLOCKS
    if n_frames > 0:
        frames = pm[skip:skip + n_frames * C.P1_FM_BLOCKS].reshape(
            n_frames, -1)
        out["p1"], out["p1_margin"], out["p1_bit_errors"] = p1_decode(frames)
    if px_state is not None:
        fl1, fl2 = px_frame_lens(psmi)
        assert fl1 or fl2, "px_state passed but psmi has no PX channels"
        states = {k: (getattr(px_state, f"{k}_internal"),
                      getattr(px_state, f"{k}_phase"))
                  for k, fl in (("px1", fl1), ("px2", fl2)) if fl}
        px_out, new_states = px_scan_pairs(px_scanned, n_blocks, first_bc,
                                           fl1, fl2, states)
        out.update(px_out)
        new_px = px_state._asdict()
        for k, (internal, ph) in new_states.items():
            new_px[f"{k}_internal"], new_px[f"{k}_phase"] = internal, ph
        out["px_state"] = PxState(**new_px)
    if packed:
        out = pack_out(out)
    return out, carry


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(like, leaves):
    """A tree of ``like``'s structure from an iterator of leaves."""
    if isinstance(like, tuple):
        return type(like)(*(_rebuild(t, leaves) for t in like))
    return next(leaves)


def index_tree(tree, i: int):
    """Station ``i`` of a tree of stacked tensors."""
    return _rebuild(tree, iter([x[i] for x in _leaves(tree)]))


def stack_trees(trees: list):
    """Stack a list of trees of tensors along a new leading axis."""
    cols = zip(*(_leaves(t) for t in trees))
    return _rebuild(trees[0], iter([torch.stack(c) for c in cols]))


def _stack_outputs(outs: list):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack_outputs([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple):
        return stack_trees(outs)
    return torch.stack(outs)


def fm_chain_batch(samples: torch.Tensor, carries: ChainCarry,
                   n_blocks: int, psmi: int = 1, first_bc: int = 0,
                   px_states: PxState | None = None, packed: bool = False):
    """Several stations: :func:`fm_chain_scan` for each (the reference's
    ``vmap``).  samples [S, buffer_len]; carries (and px_states) stacked
    along a leading station axis.  Returns the outputs and carries
    stacked likewise."""
    results = [fm_chain_scan(
        samples[i], index_tree(carries, i), n_blocks, psmi, first_bc,
        None if px_states is None else index_tree(px_states, i), packed)
        for i in range(samples.shape[0])]
    return (_stack_outputs([r[0] for r in results]),
            stack_trees([r[1] for r in results]))


def rebase_carry(carry: ChainCarry, consumed: int) -> ChainCarry:
    """Shift the carry's read offset for the next buffer of a stream: the
    host dropped ``consumed`` samples and presents the rest at the head of
    the next buffer."""
    return carry._replace(offset=(carry.offset - consumed).to(torch.int32))


def carry_to_real(carry: ChainCarry) -> ChainCarry:
    """Each complex leaf as stacked (re, im) float32 [2, ...]: the
    reference's form for the host to read (inverse:
    :func:`carry_from_real`)."""
    return _rebuild(carry, iter([
        torch.stack([x.real, x.imag]) if x.is_complex() else x
        for x in _leaves(carry)]))


def carry_from_real(carry) -> ChainCarry:
    like = chain_init_carry(device="cpu")
    return _rebuild(like, iter([
        torch.complex(x[0], x[1]) if ref.is_complex() else x
        for ref, x in zip(_leaves(like), _leaves(carry))]))
