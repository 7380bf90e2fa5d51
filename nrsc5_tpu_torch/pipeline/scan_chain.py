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
frequency, timing feedback) an explicit :class:`ChainCarry`.

The reference's ``vmap`` over stations is the batch dimension and its
``lax.scan`` over blocks a loop (:func:`scan_blocks_c`) of two kernels a
block for all stations at once: K17 (:func:`~nrsc5_tpu_torch.ops.acquire.
demod_fm_c`: each station's window read at its own offset, derotated,
folded and transformed by its own FFT) and K18 (:func:`~nrsc5_tpu_torch.
ops.sync_fm.sync_fm_c`: the sync block, which also takes the loop's carry
step, so that nothing is read back to the host), after one K5 step ahead
of block 0; the FEC is then flat-batched over stations x frames (or block
pairs).  One station is the same path at S = 1.  P1, PIDS and PX decode
through :func:`~nrsc5_tpu_torch.ops.decode_fm.p1_decode`,
:func:`~nrsc5_tpu_torch.ops.decode_fm.pids_decode` and
:func:`~nrsc5_tpu_torch.ops.decode_fm.px_deinterleave` /
:func:`~nrsc5_tpu_torch.ops.decode_fm.px_fec`: kernels K6, K7, K8 and K11.
On the CPU every kernel wrapper takes its plain version (the complex ops
of :mod:`nrsc5_tpu_torch.ops.acquire` and :mod:`nrsc5_tpu_torch.ops.
sync_fm`, looped over the stations); ``plain=True`` takes the block
step's plain versions on a card too.  The turbo receiver
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
from nrsc5_tpu_torch.ops.acquire import (AcquireState, acquire_init_state,
                                         demod_fm_c, demod_fm_c_plain)
from nrsc5_tpu_torch.ops.decode_fm import (p1_decode, pids_decode,
                                           px_deinterleave, px_fec)
from nrsc5_tpu_torch.ops.sync_fm import (SyncState, sync_block_shapes,
                                         sync_fm_c, sync_fm_c_plain,
                                         sync_init_state)
from nrsc5_tpu_torch.pipeline.block_graph import (block_carry, run_into,
                                                  station_major)

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


def _one(tree):
    """A tree of tensors with a station axis of one added."""
    return tree_rebuild(tree, iter([x[None] for x in tree_leaves(tree)]))


def _first(tree):
    """Station 0 of a tree of stacked tensors (dicts walked by key)."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return index_tree(tree, 0)


def scan_blocks_c(samples: torch.Tensor, carries: ChainCarry,
                  n_blocks: int, psmi: int = 1, plain: bool = False):
    """The block loop for every station at once: samples [S, N]
    complex64, carries stacked along a leading station axis.  Block 0's
    inputs come from K5's step (:func:`~nrsc5_tpu_torch.pipeline.
    block_graph.block_carry`); each block then runs K17 (its spectra,
    phase and keep into reused buffers) and K18 (its pm, PX soft bits and
    diagnostics straight into slot b of block-major buffers, then the
    carry step for the next block).  ``plain`` runs the kernels' plain
    versions instead.  Returns (pm int8 [S, n_blocks, 23040], diag dict of
    [S, n_blocks] tensors, px tuple of the PX channels' soft bits [S,
    n_blocks, 2304 or 4608] (px1 first; empty for MP1 and MP5/MP6), new
    carries)."""
    s, dev = samples.shape[0], samples.device
    shapes = sync_block_shapes(s, psmi)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    pm = empty((n_blocks,) + shapes["pm"][0], torch.int8)
    diag = {k: empty((n_blocks, s), shapes[k][1])
            for k in ("samperr", "error_lb", "error_ub")}
    px = {k: empty((n_blocks,) + shapes[k][0], torch.int8)
          for k in ("px1", "px2") if k in shapes}
    ref = {k: empty(*shapes[k]) for k in ("ref_ok", "ref_bc", "ref_psmi")}
    k18_angle = empty((s,))
    state = {"offset": carries.offset.clone(),
             "prev_angle": carries.acq.prev_angle.clone(),
             "samperr_fb": carries.samperr_fb.clone(),
             "angle_fb": carries.angle_fb.clone()}
    # ping-pong pairs: block b reads [b % 2] and writes [(b + 1) % 2]
    tadj = (empty((s,), torch.int32), empty((s,), torch.int32))
    state.update(samperr=empty((s,), torch.int32), angle=empty((s,)),
                 timing_adj=tadj[0])
    phase = (carries.acq.phase.clone(), empty((s,), torch.complex64))
    cph = (carries.sync.costas_phase.clone(), empty((s, C.FFT_FM)))
    cfr = (carries.sync.costas_freq.clone(), empty((s, C.FFT_FM)))
    spectra = empty((s, C.BLKSZ, C.FFT_FM), torch.complex64)
    keep = empty((s,), torch.int32)
    cfo = torch.zeros(s, dtype=torch.int32, device=dev)
    block_carry(None, None, None, state, True, plain)
    for b in range(n_blocks):
        i, j = b % 2, (b + 1) % 2
        run_into(demod_fm_c, demod_fm_c_plain, plain,
                 (samples, state["offset"], phase[i], state["samperr"],
                  state["angle"], cfo), (spectra, phase[j], keep))
        out = {"pm": pm[b], "angle": k18_angle, **ref,
               **{k: v[b] for k, v in diag.items()},
               **{k: v[b] for k, v in px.items()}}
        step = {**state, "timing_adj": tadj[j], "keep": keep}
        run_into(sync_fm_c, sync_fm_c_plain, plain,
                 (spectra, cph[i], cfr[i], psmi, tadj[i], step),
                 (out, cph[j], cfr[j]))
    last = n_blocks % 2
    diag = {k: station_major(v) for k, v in diag.items()}
    diag["error"] = diag["error_lb"] + diag["error_ub"]
    new = ChainCarry(
        offset=state["offset"],
        acq=AcquireState(phase=phase[last], prev_angle=state["prev_angle"]),
        sync=SyncState(costas_phase=cph[last], costas_freq=cfr[last]),
        samperr_fb=state["samperr_fb"], angle_fb=state["angle_fb"])
    return (station_major(pm),
            {k: diag[k] for k in ("samperr", "error", "error_lb",
                                  "error_ub")},
            tuple(station_major(v) for v in px.values()), new)


def fm_decode_c(pm, diag, px_scanned, n_blocks: int, psmi: int = 1,
                first_bc: int = 0, px_states: PxState | None = None,
                packed: bool = False):
    """The FEC after :func:`scan_blocks_c`, flat-batched over stations ×
    frames (P1) and stations × block pairs (PX): the outputs of
    :func:`fm_chain_batch` from the loop's results."""
    s = pm.shape[0]
    out = {"pids": pids_decode(pm, packed=packed).reshape(s, n_blocks, -1),
           "diag": diag}
    skip = (C.P1_FM_BLOCKS - first_bc) % C.P1_FM_BLOCKS
    n_frames = (n_blocks - skip) // C.P1_FM_BLOCKS
    if n_frames > 0:
        frames = pm[:, skip:skip + n_frames * C.P1_FM_BLOCKS].reshape(
            s, n_frames, -1)
        p1, margin, errors = p1_decode(frames, packed=packed)
        out["p1"] = p1.reshape(s, n_frames, -1)
        out["p1_margin"] = margin.reshape(s, n_frames)
        out["p1_bit_errors"] = errors.reshape(s, n_frames)
    if px_states is not None:
        fl1, fl2 = px_frame_lens(psmi)
        assert fl1 or fl2, "px_state passed but psmi has no PX channels"
        assert first_bc % 2 == 0 and n_blocks % 2 == 0, \
            "PX decode needs pair-aligned blocks"
        new_px = px_states._asdict()
        for key, llr in zip(("px1", "px2"), px_scanned):
            fl = llr.shape[-1]
            ext, internal, phase = px_deinterleave(
                llr, new_px[f"{key}_internal"],
                new_px[f"{key}_phase"].to(torch.int32))
            bits, margin = px_fec(ext, fl, packed=packed)
            out[key] = bits.reshape(s, n_blocks // 2, -1)
            out[key + "_margin"] = margin.reshape(s, n_blocks // 2)
            new_px[f"{key}_internal"], new_px[f"{key}_phase"] = \
                internal, phase
        out["px_state"] = PxState(**new_px)
    return out


def fm_frontend_scan(samples: torch.Tensor, carry: ChainCarry,
                     n_blocks: int, psmi: int = 1, plain: bool = False):
    """Run ``n_blocks`` FINE-state L1 blocks over ``samples``:
    :func:`scan_blocks_c` at one station.

    samples: [buffer_len(n_blocks)] complex64 at 744187.5 S/s; the first
    OFDM symbol starts ``FFTCP//2 + carry.offset`` samples in.  Returns
    (pm [n_blocks, 23040] int8, diag dict, px_scanned tuple of per-block
    PX1/PX2 soft bits (empty for MP1 and MP5/MP6), new_carry)."""
    pm, diag, px, cy = scan_blocks_c(samples[None], _one(carry), n_blocks,
                                     psmi, plain)
    return pm[0], _first(diag), tuple(x[0] for x in px), _first(cy)


def fm_chain_scan(samples: torch.Tensor, carry: ChainCarry, n_blocks: int,
                  psmi: int = 1, first_bc: int = 0,
                  px_state: PxState | None = None, packed: bool = False,
                  plain: bool = False):
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
    new carry).  This is :func:`fm_chain_batch` at one station."""
    out, cy = fm_chain_batch(samples[None], _one(carry), n_blocks, psmi,
                             first_bc, None if px_state is None
                             else _one(px_state), packed, plain)
    return _first(out), _first(cy)


def tree_leaves(tree):
    """The leaves of a tree of tuples (NamedTuple states nested in
    NamedTuples) in field order: ``jax.tree.flatten``'s order."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_rebuild(like, leaves):
    """A tree of ``like``'s structure from an iterator of leaves."""
    if isinstance(like, tuple):
        return type(like)(*(tree_rebuild(t, leaves) for t in like))
    return next(leaves)


def index_tree(tree, i: int):
    """Station ``i`` of a tree of stacked tensors."""
    return tree_rebuild(tree, iter([x[i] for x in tree_leaves(tree)]))


def stack_trees(trees: list):
    """Stack a list of trees of tensors along a new leading axis."""
    cols = zip(*(tree_leaves(t) for t in trees))
    return tree_rebuild(trees[0], iter([torch.stack(c) for c in cols]))


def fm_chain_batch(samples: torch.Tensor, carries: ChainCarry,
                   n_blocks: int, psmi: int = 1, first_bc: int = 0,
                   px_states: PxState | None = None, packed: bool = False,
                   plain: bool = False):
    """Several stations (the reference's ``vmap``): samples [S,
    buffer_len]; carries (and px_states) stacked along a leading station
    axis.  Returns the outputs and carries stacked likewise: every
    station at once, :func:`scan_blocks_c` then :func:`fm_decode_c`.
    ``plain`` runs the block step's plain versions (the FEC as always)."""
    pm, diag, px, cy = scan_blocks_c(samples, carries, n_blocks, psmi, plain)
    return fm_decode_c(pm, diag, px, n_blocks, psmi, first_bc, px_states,
                       packed), cy


def rebase_carry(carry: ChainCarry, consumed: int) -> ChainCarry:
    """Shift the carry's read offset for the next buffer of a stream: the
    host dropped ``consumed`` samples and presents the rest at the head of
    the next buffer."""
    return carry._replace(offset=(carry.offset - consumed).to(torch.int32))


def carry_to_real(carry: ChainCarry) -> ChainCarry:
    """Each complex leaf as stacked (re, im) float32 [2, ...]: the
    reference's form for the host to read (inverse:
    :func:`carry_from_real`)."""
    return tree_rebuild(carry, iter([
        torch.stack([x.real, x.imag]) if x.is_complex() else x
        for x in tree_leaves(carry)]))


def carry_from_real(carry) -> ChainCarry:
    like = chain_init_carry(device="cpu")
    return tree_rebuild(like, iter([
        torch.complex(x[0], x[1]) if ref.is_complex() else x
        for ref, x in zip(tree_leaves(like), tree_leaves(carry))]))
