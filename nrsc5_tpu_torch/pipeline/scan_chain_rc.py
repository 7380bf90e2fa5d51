"""Real-valued fused FM chain: cold start, then acquire -> sync -> FEC over
L1 blocks.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain_rc.py``, PX
channels of MP2/MP3/MP11 included.  The reference
``vmap``s a per-station ``lax.scan``; here the station axis is written out
and leads every tensor, and the block scan (:func:`scan_blocks`) is a loop
whose body runs for all stations at once, with no host work and no
allocation in it, so that on a card a CUDA graph replays it
(:mod:`nrsc5_tpu_torch.pipeline.block_graph`, K5):

  * K2 (:func:`nrsc5_tpu_torch.ops.acquire_rc.demod_fold_bf16`) reads
    each station's window at its own offset and folds it into bfloat16,
    the operand of the DFT kernel
    (:func:`nrsc5_tpu_torch.ops.rcplx.dft_bf16`, a tensor-core product
    with the bf16 DFT table and float32 accumulation);
  * :func:`sync_block_rc` is kernel K4: the Costas PLL on the reference
    subcarriers, then the flip, needles, equalizer, timing regression and
    int8 soft demap of the PM and PX partitions, one launch per block for
    all stations;
  * K4 also takes the carry step of K5 (its FM step, once a dispatch
    :func:`nrsc5_tpu_torch.pipeline.block_graph.block_carry` for block 0):
    offset, prev_angle and the samperr and angle feedback to the next
    block, K2 and K4 writing their block's outputs into slot b;
  * after the loop the P1, PIDS and PX FEC run flat-batched over stations
    × frames (or block pairs): K6 or K11 (gather, depuncture, and for PX
    the interleaver-IV state), K7 (Viterbi), K8 (re-encode, descramble,
    pack), through :mod:`nrsc5_tpu_torch.ops.decode_fm`.

The cold start (:func:`cold_start_rc`) locks a capture with unknown timing
and CFO in two device dispatches for the whole fleet: the timing/CFO probe
(K9, K2, the DFT kernel, K3 and the needle count of K10), then the
block-count probe (K2, the DFT kernel, K4), with the reference's argmax
and votes on the host; :func:`cold_start_device_rc` runs the same probes
with the argmax and votes on the device and no read-back (the
self-synchronizing time shards' lock, :mod:`nrsc5_tpu_torch.parallel.
receive`), and :func:`acquire_fine_rc` is the reference's one-block fine
acquire (K2's fold, then the DFT kernel) for every station.

The chain and cold-start functions take ``plain=True`` to run the
kernels' plain PyTorch versions instead (on any device); on a CPU tensor
the kernel wrappers take the plain versions anyway.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops import sync_fm as SF
from nrsc5_tpu_torch.ops.acquire_rc import (WINDOW_FM, coarse_timing_rc,
                                            coarse_timing_rc_plain,
                                            demod_fold_bf16,
                                            demod_fold_bf16_plain)
from nrsc5_tpu_torch.ops.costas import TWO_PI, costas_track_rc_plain, wrap_pi
from nrsc5_tpu_torch.ops.decode_fm import (p1_decode, pids_decode,
                                           px_deinterleave, px_fec)
from nrsc5_tpu_torch.ops.detect_cfo import CFO_RANGE, detect_cfo_scan_rc
from nrsc5_tpu_torch.pipeline.block_graph import (FM_STATE, block_carry,
                                                  block_carry_plain, run_into,
                                                  station_major)
from nrsc5_tpu_torch.pipeline.scan_chain import iv_state_len, px_frame_lens

W = C.PARTITION_WIDTH_FM


class ChainCarryRC(NamedTuple):
    """Carried chain state, one row per station (leading axis S)."""
    offset: torch.Tensor  # int32 [S]
    phase: torch.Tensor  # float32 [S, 2] sample-clock phasor (rc)
    prev_angle: torch.Tensor  # float32 [S]
    costas_phase: torch.Tensor  # float32 [S, FFT_FM]
    costas_freq: torch.Tensor  # float32 [S, FFT_FM]
    samperr_fb: torch.Tensor  # int32 [S]
    angle_fb: torch.Tensor  # float32 [S]
    cfo: torch.Tensor  # int32 [S] accumulated integer CFO (bins)
    px1_internal: torch.Tensor  # int8 [S, N or 0] interleaver-IV state
    px1_phase: torch.Tensor  # int32 [S] IV call phase
    px2_internal: torch.Tensor  # int8 [S, N or 0]
    px2_phase: torch.Tensor  # int32 [S]


def check_psmi(psmi: int) -> None:
    """A service-mode index the chain decodes: any entry of the
    compatibility-mode table."""
    if not 0 <= psmi < len(C.COMPATIBILITY_MODE):
        raise ValueError(f"psmi {psmi} is not a service mode index")


def check_px_state(carry: ChainCarryRC, psmi: int) -> None:
    """The carry's interleaver-IV state is sized for ``psmi``."""
    for key, fl in zip(("px1", "px2"), px_frame_lens(psmi)):
        n = getattr(carry, f"{key}_internal").shape[-1]
        if n != iv_state_len(fl):
            raise ValueError(f"{key}_internal holds {n} entries; psmi "
                             f"{psmi} carries {iv_state_len(fl)}")


def chain_rc_init_carry(offset: int = 0, psmi: int = 1, cfo: int = 0, *,
                        n_stations: int = 1,
                        device="cuda") -> ChainCarryRC:
    """Initial carry for ``n_stations`` stations of service mode ``psmi``
    on ``device``."""
    check_psmi(psmi)
    dev = K.resolve_device(device)
    s = n_stations
    fl1, fl2 = px_frame_lens(psmi)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return ChainCarryRC(
        offset=full((s,), offset, torch.int32),
        phase=torch.tensor([[1.0, 0.0]], device=dev).repeat(s, 1),
        prev_angle=full((s,), 0.0, torch.float32),
        costas_phase=full((s, C.FFT_FM), 0.0, torch.float32),
        costas_freq=full((s, C.FFT_FM), 0.0, torch.float32),
        samperr_fb=full((s,), 0, torch.int32),
        angle_fb=full((s,), 0.0, torch.float32),
        cfo=full((s,), cfo, torch.int32),
        px1_internal=full((s, iv_state_len(fl1)), 0, torch.int8),
        px1_phase=full((s,), 0, torch.int32),
        px2_internal=full((s, iv_state_len(fl2)), 0, torch.int8),
        px2_phase=full((s,), 0, torch.int32),
    )


def _phase_diff(a, b):
    d = a - b
    return d - math.pi * torch.round(rc.fdiv(d, math.pi))


def acquire_fine_rc(samples, offset, phase, prev_angle, sync_samperr,
                    sync_angle, cfo, plain: bool = False):
    """One FINE-state acquire for every station: samples [S, N, 2]
    conjugated rc, each station's window at ``offset`` (int32 [S]), its
    phasor ``phase`` [S, 2], ``prev_angle`` and the previous block's sync
    feedback (``sync_samperr`` int32, ``sync_angle`` float32) and ``cfo``
    (int32 bins), all [S].  K2's bf16 fold, then the DFT kernel (their
    plain versions with ``plain``).  Returns (spectra [S, 32, 2048, 2],
    phase_out [S, 2], the block's angle [S], samperr [S], keep [S]) as the
    reference's ``acquire_fine_rc`` gives them a station at a time."""
    samperr = (C.FFTCP_FM // 2 + sync_samperr).to(torch.int32)
    angle = prev_angle - sync_angle
    fold = demod_fold_bf16_plain if plain else demod_fold_bf16
    dft = rc.dft_bf16_plain if plain else rc.dft_bf16
    folded, phase_out, keep = fold(samples, offset, phase, samperr, angle,
                                   cfo)
    return dft(folded), phase_out, angle, samperr, keep


# ---------------------------------------------------------------------------
# K4: sync block (any partitions-per-band, with the PX demaps)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def px_columns(psmi: int) -> tuple[tuple, tuple]:
    """The partitions each PX channel demaps, in output order: one
    ``(side, partition, mult_side)`` per column for px1 and for px2, with
    side 0 lower and 1 upper, and the MER multiplier of ``mult_side``
    (rc twin of the reference's src/sync.c:537-595; its px2 takes the lower
    sideband's multiplier on both sidebands)."""
    cm = C.COMPATIBILITY_MODE[psmi]
    px1 = {2: ((0, 10, 0), (1, 10, 1)),
           3: ((0, 10, 0), (0, 11, 0), (1, 11, 1), (1, 10, 1)),
           11: ((0, 10, 0), (0, 11, 0), (1, 11, 1), (1, 10, 1))}.get(cm, ())
    px2 = ((0, 12, 0), (0, 13, 0), (1, 13, 0), (1, 12, 0)) if cm == 11 \
        else ()
    return px1, px2

@functools.lru_cache(maxsize=8)
def _sync_tables(ppb: int, device: str) -> dict:
    r = ppb + 1
    part = np.arange(ppb)
    kk = np.arange(1, W)
    low_bins = C.LB_START + part[:, None] * W + kk[None, :]
    up_bins = C.UB_END - (part[:, None] + 1) * W + kk[None, :]
    vals, known = SF._needles(ppb)
    vals_mask, known_mask = SF.needle_masks(ppb)
    tables = {
        "bins": SF._ref_bins(ppb).astype(np.int64),
        "sync_signs": SF._sync_signs(),
        "vals": np.ascontiguousarray(vals.T),  # [32, R]
        "known": np.ascontiguousarray(known.T),
        "lo_idx": np.concatenate([np.arange(ppb), r + np.arange(ppb) + 1]),
        "hi_idx": np.concatenate([np.arange(ppb) + 1, r + np.arange(ppb)]),
        "data_bins": np.concatenate([low_bins, up_bins]).astype(np.int64),
        "wbc": np.array([8, 4, 2, 1], np.int32),
        "wps": np.array([32, 16, 8, 4, 2, 1], np.int32),
        "k": np.arange(1, W, dtype=np.float32),
        # the needles as bit masks (bit k = symbol k), as K4 reads them
        "vals_mask": vals_mask,
        "known_mask": known_mask,
    }
    out = {k: torch.from_numpy(v).to(device) for k, v in tables.items()}
    out["k_rel"] = (out["bins"] - C.FFT_FM // 2).float()
    # the PX columns of every service mode with this ppb, as K4 reads them:
    # side + 2 * mult_side + 4 * partition, px1's then px2's
    out["px_cols"] = {
        psmi: torch.tensor([side + 2 * ms + 4 * part for cols in
                            px_columns(psmi) for side, part, ms in cols]
                           + [0], dtype=torch.int32, device=device)
        for psmi in range(len(C.COMPATIBILITY_MODE))
        if C.partitions_per_band(psmi) == ppb}
    return out


def sync_block_shapes(s: int, psmi: int) -> dict:
    """{key: (shape, dtype)} of K4's per-station outputs for ``s`` stations
    of service mode ``psmi``."""
    r2 = 2 * (C.partitions_per_band(psmi) + 1)
    shapes = {"pm": ((s, C.PM_BLOCK_SIZE), torch.int8),
              "ref_ok": ((s, r2), torch.bool),
              "ref_bc": ((s, r2), torch.int32),
              "ref_psmi": ((s, r2), torch.int32),
              "samperr": ((s,), torch.int32),
              "angle": ((s,), torch.float32),
              "error_lb": ((s,), torch.float32),
              "error_ub": ((s,), torch.float32)}
    for key, cols in zip(("px1", "px2"), px_columns(psmi)):
        if cols:
            shapes[key] = ((s, C.BLKSZ * len(cols) * 2 * (W - 1)),
                           torch.int8)
    return shapes


def _warp_sum(x):
    """Sum over the last axis in the order one warp of K4 does: lane l adds
    elements l, l + 32, ... in turn, then the 32 lane sums meet in a
    butterfly (lane l + lane l + o, o = 16, 8, 4, 2, 1)."""
    n = x.shape[-1]
    lanes = -(-n // 32) * 32
    x = torch.nn.functional.pad(x, (0, lanes - n))
    acc = rc.ordered_sum(x.reshape(x.shape[:-1] + (lanes // 32, 32)), -2)
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o:2 * o]
    return acc[..., 0]


def _demod(z, mult):
    return torch.round(torch.clamp(z, -1, 1) * mult).to(torch.int8)


def _check_sync(spectra, costas_phase, costas_freq, timing_adj):
    if spectra.ndim != 4 or spectra.shape[1:] != (C.BLKSZ, C.FFT_FM, 2):
        raise ValueError(f"spectra: expected [S, {C.BLKSZ}, {C.FFT_FM}, 2],"
                         f" got {tuple(spectra.shape)}")
    s = spectra.shape[0]
    for name, t, shape in (("costas_phase", costas_phase, (s, C.FFT_FM)),
                           ("costas_freq", costas_freq, (s, C.FFT_FM)),
                           ("timing_adj", timing_adj, (s,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")


def _check_carry(carry: dict, s: int, timing_adj) -> None:
    """The block loop's carry step handed to K4: every name of
    :data:`~nrsc5_tpu_torch.pipeline.block_graph.FM_STATE` and ``keep``,
    each an [S] tensor, its ``timing_adj`` not the one K4 reads."""
    for name in FM_STATE + ("keep",):
        t = carry[name]
        if tuple(t.shape) != (s,):
            raise ValueError(f"carry {name}: expected shape {(s,)}, got "
                             f"{tuple(t.shape)}")
    if carry["timing_adj"] is timing_adj:
        raise ValueError("carry timing_adj: the next block's, not the one "
                         "K4 reads (ping-pong them)")


def sync_block_rc_plain(spectra, costas_phase, costas_freq, psmi: int,
                        timing_adj, carry: dict | None = None):
    """Plain version of K4.  spectra: [S, 32, 2048, 2];
    costas_phase/costas_freq [S, 2048]; timing_adj int32 [S].  ``carry``
    (the block loop's, else None): K5's FM step after this block, in place
    (:func:`~nrsc5_tpu_torch.pipeline.block_graph.block_carry_plain` with
    its ``keep`` and this block's samperr and angle; its ``timing_adj`` the
    next block's).  Returns (out dict of per-station tensors, new_phase,
    new_freq): ``pm`` int8
    [S, 23040], ``ref_ok`` bool [S, 2R], ``ref_bc``/``ref_psmi`` int32
    [S, 2R], ``samperr`` int32 [S], ``angle``, ``error_lb``, ``error_ub``
    float32 [S], and for the modes that carry them ``px1`` int8 [S, 2304]
    (MP2) or [S, 4608] (MP3/MP11) and ``px2`` int8 [S, 4608] (MP11)."""
    check_psmi(psmi)
    _check_sync(spectra, costas_phase, costas_freq, timing_adj)
    if carry is not None:
        _check_carry(carry, spectra.shape[0], timing_adj)
    ppb = C.partitions_per_band(psmi)
    t = _sync_tables(ppb, str(spectra.device))
    s = spectra.shape[0]
    bins, k_rel = t["bins"], t["k_rel"]
    r2 = bins.shape[0]

    adj_phase = timing_adj.float()[:, None] * k_rel * (TWO_PI / C.FFT_FM)
    phase0 = costas_phase[:, bins] - adj_phase  # [S, 2R]
    freq0 = costas_freq[:, bins]

    # stations x refs as independent tracks, step-major: [32, S*2R, 2]
    refs = spectra[:, :, bins].transpose(0, 1).reshape(C.BLKSZ, s * r2, 2)
    derot, phases, ph_out, fr_out = costas_track_rc_plain(
        refs.contiguous(), phase0.reshape(-1), freq0.reshape(-1))
    derot = derot.reshape(C.BLKSZ, s, r2, 2).transpose(0, 1)  # [S, 32, 2R, 2]
    phases = phases.reshape(C.BLKSZ, s, r2).transpose(0, 1)
    ph_out = ph_out.reshape(s, r2)
    fr_out = fr_out.reshape(s, r2)

    # the sums below run in K4's order (rc.ordered_sum, _warp_sum), so that
    # the plain version and the kernel round alike
    score = rc.ordered_sum(derot[..., 0] * t["sync_signs"][:, None], 1)
    flip = score < 0
    derot = torch.where(flip[:, None, :, None], -derot, derot)
    phases = torch.where(flip[:, None, :], phases + math.pi, phases)
    ph_out = torch.where(flip, ph_out + math.pi, ph_out)

    signs = (derot[..., 0] > 0).to(torch.uint8)  # [S, 32, 2R]
    match = torch.where(t["known"], signs == t["vals"], True)
    ref_ok = match.all(dim=1)
    data = signs ^ torch.cat([torch.zeros_like(signs[:, :1]), signs[:, :-1]],
                             dim=1)
    ref_bc = (data[:, 16:20].int() * t["wbc"][:, None]).sum(
        1, dtype=torch.int32)
    ref_psmi = (data[:, 25:31].int() * t["wps"][:, None]).sum(
        1, dtype=torch.int32)

    # equalization
    smag = rc.ordered_sum(derot[..., 0].abs(), 1) / C.BLKSZ  # [S, 2R]
    phi_lo = phases[:, :, t["lo_idx"]]  # [S, 32, 2ppb]
    phi_hi = phases[:, :, t["hi_idx"]]
    smag_lo = smag[:, t["lo_idx"]][:, None, :]
    smag_hi = smag[:, t["hi_idx"]][:, None, :]
    k = t["k"][:, None]  # [18, 1]
    denom = (k * rc.scale(rc.exp_i(phi_hi), smag_hi)[..., None, :]
             + (W - k) * rc.scale(rc.exp_i(phi_lo), smag_lo)[..., None, :])
    num = torch.full_like(denom, float(W))
    eq = rc.div(num, denom)  # [S, 32, 2ppb, 18, 2]

    data_sc = spectra[:, :, t["data_bins"]]  # [S, 32, 2ppb, 18, 2]
    data_eq = rc.mul(data_sc, eq)

    samperr = rc.ordered_sum(_phase_diff(phi_lo[:, 0], phi_hi[:, 0]), -1)
    # divisions by numbers through rc.fdiv: true divisions, as K4 divides
    samperr = rc.fdiv(rc.fdiv(rc.fdiv(samperr, ppb * 2) * C.FFT_FM, W),
                      TWO_PI)
    x = k_rel
    y = fr_out
    slope = rc.ordered_sum(x * y, -1) / rc.ordered_sum(x * x, -1)
    samperr = samperr - rc.fdiv(slope * C.FFT_FM, TWO_PI) \
        * C.ACQUIRE_SYMBOLS
    samperr_i = torch.round(samperr).to(torch.int32)
    angle = rc.fdiv(rc.ordered_sum(fr_out, -1), r2)
    fr_out = fr_out - angle[:, None]

    ideal = torch.sign(data_eq)
    err2 = rc.abs2(ideal - data_eq)  # [S, 32, 2ppb, 18]
    # per symbol and sideband over a warp, then over the symbols in order
    error_lb = rc.ordered_sum(_warp_sum(err2[:, :, :ppb].flatten(2)), 1)
    error_ub = rc.ordered_sum(_warp_sum(err2[:, :, ppb:].flatten(2)), 1)
    # a fill, not a host copy, so that the plain version can run inside a
    # CUDA graph
    sig_block = torch.full_like(
        error_lb, 2.0 * C.BLKSZ * (ppb * C.PARTITION_DATA_CARRIERS))
    mult_lb = torch.clamp(sig_block / error_lb * 10, 1, 127)
    mult_ub = torch.clamp(sig_block / error_ub * 10, 1, 127)

    # per-bin channel-power LLR weighting (the reference's default MMSE
    # weighting, ops/sync_fm.py EQ_MMSE): deep fades become near-erasures
    h2 = 1.0 / torch.clamp(rc.abs2(eq), min=1e-12)  # [S, 32, 2ppb, 18]
    h2_lb, h2_ub = h2[:, :, :ppb], h2[:, :, ppb:]
    per_side = ppb * (W - 1)
    w_lb = torch.clamp(h2_lb / rc.fdiv(_warp_sum(h2_lb.flatten(2)),
                                       per_side)[:, :, None, None],
                       0.0, 1.0)[..., None]
    w_ub = torch.clamp(h2_ub / rc.fdiv(_warp_sum(h2_ub.flatten(2)),
                                       per_side)[:, :, None, None],
                       0.0, 1.0)[..., None]
    mlb = mult_lb[:, None, None, None, None] * w_lb
    mub = mult_ub[:, None, None, None, None] * w_ub

    pm = C.PM_PARTITIONS
    pm_low = _demod(data_eq[:, :, :pm], mlb[:, :, :pm])
    up = data_eq[:, :, ppb:ppb + pm]
    pm_up = _demod(up.flip(2), mub[:, :, :pm].flip(2))
    pm_block = torch.cat([pm_low, pm_up], dim=2).reshape(s, -1)

    out = {
        "pm": pm_block,
        "ref_ok": ref_ok,
        "ref_bc": ref_bc,
        "ref_psmi": ref_psmi,
        "samperr": samperr_i,
        "angle": angle,
        "error_lb": error_lb,
        "error_ub": error_ub,
    }
    mults = (mult_lb[:, None, None, None, None], mult_ub[:, None, None, None,
                                                         None])
    ws = (w_lb, w_ub)
    for key, cols in zip(("px1", "px2"), px_columns(psmi)):
        if cols:
            out[key] = torch.stack([
                _demod(data_eq[:, :, side * ppb + part],
                       mults[ms][:, :, 0] * ws[side][:, :, part])
                for side, part, ms in cols], dim=2).reshape(s, -1)
    new_phase = costas_phase.clone()
    new_phase[:, bins] = wrap_pi(ph_out)
    new_freq = costas_freq.clone()
    new_freq[:, bins] = fr_out
    if carry is not None:
        block_carry_plain(carry["keep"], samperr_i, angle, carry, False)
    return out, new_phase, new_freq


def sync_block_rc(spectra, costas_phase, costas_freq, psmi: int, timing_adj,
                  carry: dict | None = None, out=None):
    """K4: the arguments and results of :func:`sync_block_rc_plain`, written
    into ``out`` = (out dict with every key the plain version returns,
    new_phase, new_freq) where it is given.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (a cluster of 8 CTAs per station, each equalizing and demapping 4 of
    the 32 symbols; it writes whole new Costas rows and the PX channels'
    soft bits; with ``carry``, CTA 0 then takes K5's FM step)."""
    if spectra.device.type == "cpu":
        res = sync_block_rc_plain(spectra, costas_phase, costas_freq, psmi,
                                  timing_adj, carry)
        return res if out is None else K.into(out, res)
    check_psmi(psmi)
    _check_sync(spectra, costas_phase, costas_freq, timing_adj)
    K.check(spectra, "spectra", torch.float32)
    K.check(costas_phase, "costas_phase", torch.float32)
    K.check(costas_freq, "costas_freq", torch.float32)
    K.check(timing_adj, "timing_adj", torch.int32)
    ppb = C.partitions_per_band(psmi)
    dev = spectra.device
    t = _sync_tables(ppb, str(dev))
    s = spectra.shape[0]

    shapes = sync_block_shapes(s, psmi)
    if out is None:
        out = ({k: torch.empty(shape, dtype=dtype, device=dev)
                for k, (shape, dtype) in shapes.items()},
               torch.empty_like(costas_phase), torch.empty_like(costas_freq))
    out, new_phase, new_freq = out
    if set(out) != set(shapes):
        raise ValueError(f"out: expected keys {sorted(shapes)}, got "
                         f"{sorted(out)}")
    for k, (shape, dtype) in shapes.items():
        K.check(out[k], k, dtype, shape)
    K.check(new_phase, "new_phase", torch.float32, (s, C.FFT_FM))
    K.check(new_freq, "new_freq", torch.float32, (s, C.FFT_FM))
    step = (None,) * 8
    if carry is not None:
        _check_carry(carry, s, timing_adj)
        for name in ("keep",) + FM_STATE:
            K.check(carry[name], name, torch.float32 if "angle" in name
                    else torch.int32, (s,))
        step = tuple(carry[name].data_ptr() for name in ("keep",) + FM_STATE)
    px1, px2 = px_columns(psmi)
    K.launch("sync_block", spectra.data_ptr(), costas_phase.data_ptr(),
             costas_freq.data_ptr(), timing_adj.data_ptr(),
             t["sync_signs"].data_ptr(), t["vals_mask"].data_ptr(),
             t["known_mask"].data_ptr(),
             *(out[k].data_ptr() for k in (
                 "pm", "ref_ok", "ref_bc", "ref_psmi", "samperr", "angle",
                 "error_lb", "error_ub")),
             new_phase.data_ptr(), new_freq.data_ptr(),
             *(out[k].data_ptr() if k in out else None
               for k in ("px1", "px2")),
             t["px_cols"][psmi].data_ptr(), len(px1), len(px2), s, ppb,
             SF.ALPHA, SF.BETA, TWO_PI, math.pi, TWO_PI / C.FFT_FM,
             *step, WINDOW_FM, C.FFTCP_FM // 2, device=dev)
    return out, new_phase, new_freq


# ---------------------------------------------------------------------------
# fused chain
# ---------------------------------------------------------------------------

def scan_blocks(samples, carry: ChainCarryRC, n_blocks: int, psmi: int = 1,
                plain: bool = False) -> dict:
    """The per-block acquire + sync loop, with no host work and no
    allocation in its body, so that a CUDA graph can replay it
    (:mod:`nrsc5_tpu_torch.pipeline.block_graph`).  samples: [S, N, 2]
    conjugated rc.  Each block runs K2 (its bf16 fold into a reused
    buffer), the DFT kernel and K4 (its pm, PX soft bits and diagnostics
    straight into slot b of block-major buffers, then K5's carry step for
    the next block); K5 itself runs once, block 0's step.  Reads only the
    carry's loop fields (offset, phase, prev_angle, costas_phase,
    costas_freq, samperr_fb, angle_fb, cfo).  Returns {"pm": int8 [n_blocks, S, 23040],
    "diag": {"samperr", "error_lb", "error_ub": [n_blocks, S]}, "px":
    {"px1": int8 [n_blocks, S, 2304 or 4608], ...} for the channels
    ``psmi`` carries, "carry": {field: [S, ...]} after the last block};
    :func:`finish_scan` makes the station-major outputs and the carry."""
    s, dev = samples.shape[0], samples.device
    fold = demod_fold_bf16_plain if plain else demod_fold_bf16
    dft = rc.dft_bf16_plain if plain else rc.dft_bf16
    sync = sync_block_rc_plain if plain else sync_block_rc
    shapes = sync_block_shapes(s, psmi)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    pm = empty((n_blocks,) + shapes["pm"][0], torch.int8)
    diag = {k: empty((n_blocks, s), shapes[k][1])
            for k in ("samperr", "error_lb", "error_ub")}
    px = {k: empty((n_blocks,) + shapes[k][0], torch.int8)
          for k in ("px1", "px2") if k in shapes}
    ref = {k: empty(*shapes[k]) for k in ("ref_ok", "ref_bc", "ref_psmi")}
    k4_angle = empty((s,))
    state = {k: getattr(carry, k).clone()
             for k in ("offset", "prev_angle", "samperr_fb", "angle_fb")}
    # ping-pong pairs: block b reads [b % 2] and writes [(b + 1) % 2]
    tadj = (empty((s,), torch.int32), empty((s,), torch.int32))
    state.update(samperr=empty((s,), torch.int32), angle=empty((s,)),
                 timing_adj=tadj[0])
    phase = (carry.phase.clone(), empty((s, 2)))
    cph = (carry.costas_phase.clone(), empty((s, C.FFT_FM)))
    cfr = (carry.costas_freq.clone(), empty((s, C.FFT_FM)))
    folded = empty((s, C.BLKSZ, C.FFT_FM, 2), torch.bfloat16)
    spectra = empty((s, C.BLKSZ, C.FFT_FM, 2))
    keep = empty((s,), torch.int32)
    block_carry(None, None, None, state, True, plain)
    for b in range(n_blocks):
        i, j = b % 2, (b + 1) % 2
        run_into(demod_fold_bf16, fold, plain,
                 (samples, state["offset"], phase[i], state["samperr"],
                  state["angle"], carry.cfo), (folded, phase[j], keep))
        run_into(rc.dft_bf16, dft, plain, (folded,), spectra)
        out = {"pm": pm[b], "angle": k4_angle, **ref,
               **{k: v[b] for k, v in diag.items()},
               **{k: v[b] for k, v in px.items()}}
        step = {**state, "timing_adj": tadj[j], "keep": keep}
        run_into(sync_block_rc, sync, plain,
                 (spectra, cph[i], cfr[i], psmi, tadj[i], step),
                 (out, cph[j], cfr[j]))
    last = n_blocks % 2
    loop = {"offset": state["offset"], "phase": phase[last],
            "prev_angle": state["prev_angle"], "costas_phase": cph[last],
            "costas_freq": cfr[last], "samperr_fb": state["samperr_fb"],
            "angle_fb": state["angle_fb"]}
    return {"pm": pm, "diag": diag, "px": px, "carry": loop}


def finish_scan(scanned: dict, carry: ChainCarryRC):
    """:func:`scan_blocks`' block-major results -> (pm int8 [S, n_blocks,
    23040], diag dict of [S, n_blocks] tensors, px dict {"px1": int8 [S,
    n_blocks, 2304 or 4608], ...}, new carry): fresh tensors, so that a
    graph's next replay does not overwrite them (:func:`~nrsc5_tpu_torch.
    pipeline.block_graph.station_major`)."""
    pm = station_major(scanned["pm"])
    diag = {k: station_major(v) for k, v in scanned["diag"].items()}
    px = {k: station_major(v) for k, v in scanned["px"].items()}
    return pm, diag, px, carry._replace(
        **{k: v.clone() for k, v in scanned["carry"].items()})


def frontend_scan_rc(samples, carry: ChainCarryRC, n_blocks: int,
                     psmi: int = 1, plain: bool = False):
    """The per-block acquire + sync loop, run eagerly.  samples: [S, N, 2]
    conjugated rc.  Returns (pm int8 [S, n_blocks, 23040], diag dict of
    [S, n_blocks] tensors, px dict of the PX channels' soft bits
    ``{"px1": int8 [S, n_blocks, 2304 or 4608], "px2": ...}`` for the
    channels ``psmi`` carries, new carry)."""
    return finish_scan(scan_blocks(samples, carry, n_blocks, psmi, plain),
                       carry)


def fm_decode(pm, diag, px, carry: ChainCarryRC, n_blocks: int,
              psmi: int = 1, first_bc: int = 0, packed: bool = False,
              plain: bool = False, px_decode: bool = True):
    """The FEC after the block loop: :func:`frontend_scan_rc`'s results ->
    (out, new carries) as :func:`fm_chain_batch_rc` gives them."""
    s = pm.shape[0]
    out = {"diag": diag}
    out["pids"] = pids_decode(pm, packed=packed,
                              plain=plain).reshape(s, n_blocks, -1)

    skip = (C.P1_FM_BLOCKS - first_bc) % C.P1_FM_BLOCKS
    n_frames = (n_blocks - skip) // C.P1_FM_BLOCKS
    if n_frames > 0:
        frames = pm[:, skip: skip + n_frames * C.P1_FM_BLOCKS].view(
            s, n_frames, -1)
        p1, margin, errors = p1_decode(frames, packed=packed, plain=plain)
        out["p1"] = p1.reshape(s, n_frames, -1)
        out["p1_margin"] = margin.reshape(s, n_frames)
        out["p1_bit_errors"] = errors.reshape(s, n_frames)

    # PX channels: one interleaver-IV call per block pair, the state
    # carried across dispatches; the K=7 FEC flat over stations × pairs
    for key, llr in px.items() if px_decode else ():
        fl = llr.shape[-1]
        ext, internal, phase = px_deinterleave(
            llr, getattr(carry, f"{key}_internal"),
            getattr(carry, f"{key}_phase"), plain=plain)
        bits, margin = px_fec(ext, fl, packed=packed, plain=plain)
        out[key] = bits.reshape(s, n_blocks // 2, -1)
        out[key + "_margin"] = margin.reshape(s, n_blocks // 2)
        carry = carry._replace(**{f"{key}_internal": internal,
                                  f"{key}_phase": phase})
    return out, carry


def check_chain(carries: ChainCarryRC, n_blocks: int, psmi: int,
                first_bc: int, px: bool) -> None:
    """The static arguments of one FM dispatch are ones the chain runs."""
    check_psmi(psmi)
    check_px_state(carries, psmi)
    if px and any(px_frame_lens(psmi)) and (first_bc % 2 or n_blocks % 2):
        raise ValueError(f"PX decode needs pair-aligned blocks: first_bc "
                         f"{first_bc} and n_blocks {n_blocks} must be even")


def fm_chain_batch_rc(samples, carries: ChainCarryRC, n_blocks: int,
                      psmi: int = 1, first_bc: int = 0,
                      packed: bool = False, plain: bool = False,
                      px: bool = True):
    """Station batch: samples [S, N, 2] conjugated rc at 744187.5 S/s
    (N >= buffer_len(n_blocks) for a full walk).  The P1 FEC is
    flat-batched over stations × frames and the PX FEC over stations ×
    block pairs, as in the reference.

    Returns (out, new carries) with ``out["pids"]`` uint8 [S, n_blocks, 80],
    ``out["p1"]`` uint8 [S, F, 146176], ``out["p1_margin"]`` [S, F],
    ``out["p1_bit_errors"]`` [S, F] (when a whole frame lies in the
    dispatch), for the modes with PX channels ``out["px1"]`` (and
    ``"px2"``) uint8 [S, n_blocks // 2, frame_len] with ``"px1_margin"``
    [S, n_blocks // 2], decoded through the carried interleaver-IV state
    (``first_bc`` and ``n_blocks`` even: one IV call per block pair), and
    ``out["diag"]``.  ``packed=True`` packs the decoded bits 8 to a byte
    (:mod:`nrsc5_tpu_torch.ops.bits`).  ``px=False`` skips the PX
    channels and leaves their IV state as it was, as the reference does
    for the partial frame-alignment dispatches, whose block counts may be
    odd (the IV warm-up dropped downstream absorbs the missed history)."""
    check_chain(carries, n_blocks, psmi, first_bc, px)
    pm, diag, px_soft, carry = frontend_scan_rc(samples, carries, n_blocks,
                                                psmi, plain=plain)
    return fm_decode(pm, diag, px_soft, carry, n_blocks, psmi, first_bc,
                     packed, plain, px)


def fm_chain_scan_rc(samples, carry: ChainCarryRC, n_blocks: int,
                     psmi: int = 1, first_bc: int = 0, packed: bool = False,
                     plain: bool = False, px: bool = True):
    """One station: samples [N, 2] and a carry without the station axis.
    Same outputs as :func:`fm_chain_batch_rc` without the station axis."""
    out, new = fm_chain_batch_rc(
        samples[None], ChainCarryRC(*(x[None] for x in carry)), n_blocks,
        psmi, first_bc, packed, plain, px)
    out = {k: ({d: v[0] for d, v in val.items()} if k == "diag" else val[0])
           for k, val in out.items()}
    return out, ChainCarryRC(*(x[0] for x in new))


# ---------------------------------------------------------------------------
# cold start: coarse timing + integer-CFO/block-offset search + bc probe
# ---------------------------------------------------------------------------

def _unit_phase(s: int, device) -> torch.Tensor:
    return torch.tensor([[1.0, 0.0]], device=device).repeat(s, 1)


def coldstart_probe_rc(samples, plain: bool = False):
    """Probe 1, for every station: coarse CP-correlation timing on the
    first 33-symbol window (K9), demodulate that window with the phasor
    1, the timing's angle and CFO 0 (K2's bf16 fold, the DFT kernel), and
    run the batched CFO × offset needle search (K10: the Costas tracks and
    their needle count in one kernel).

    samples: [S, >= WINDOW_FM, 2] conjugated rc.  Returns (samperr int32
    [S], angle float32 [S], count int32 [S, 76, 32])."""
    s, dev = samples.shape[0], samples.device
    timing = coarse_timing_rc_plain if plain else coarse_timing_rc
    samperr, max_v = timing(samples)
    angle = rc.angle(max_v)
    zero = torch.zeros(s, dtype=torch.int32, device=dev)
    fold = demod_fold_bf16_plain if plain else demod_fold_bf16
    dft = rc.dft_bf16_plain if plain else rc.dft_bf16
    folded, _, _ = fold(samples, zero, _unit_phase(s, dev), samperr, angle,
                        zero)
    count = detect_cfo_scan_rc(dft(folded), plain=plain)
    return samperr, angle, count


def bc_probe_rc(samples, offset, angle, cfo, plain: bool = False):
    """Probe 2, for every station: demodulate one block at ``offset`` (int32
    [S]) with the phasor 1, samperr FFTCP//2, ``angle`` and ``cfo`` (K2's
    bf16 fold, the DFT kernel), and read the reference subcarriers'
    control words with a fresh Costas state (K4).

    Returns (ref_ok bool [S, 2R], ref_bc int32 [S, 2R], ref_psmi int32
    [S, 2R])."""
    s, dev = samples.shape[0], samples.device
    samperr = torch.full((s,), C.FFTCP_FM // 2, dtype=torch.int32,
                         device=dev)
    fold = demod_fold_bf16_plain if plain else demod_fold_bf16
    dft = rc.dft_bf16_plain if plain else rc.dft_bf16
    folded, _, _ = fold(samples, offset, _unit_phase(s, dev), samperr, angle,
                        cfo)
    zeros = torch.zeros(s, C.FFT_FM, dtype=torch.float32, device=dev)
    sync = sync_block_rc_plain if plain else sync_block_rc
    out, _, _ = sync(dft(folded), zeros, zeros, 1, torch.zeros_like(samperr))
    return out["ref_ok"], out["ref_bc"], out["ref_psmi"]


def cold_start_device_rc(samples, plain: bool = False):
    """The cold start of every station with no host in the loop (the
    self-synchronizing time shards' lock, :mod:`nrsc5_tpu_torch.parallel.
    receive`): the two probes of :func:`cold_start_rc` with the reference's
    argmax, threshold (a needle count of at least 3), start wrap, block
    count votes and ``ok.sum() >= 4`` on the device, and no read-back.

    samples: [S, N, 2] conjugated rc with N >= WINDOW_FM + 33 blocks.
    Returns (start int32, first_bc int32, cfo int32, angle float32, locked
    bool), each [S]: ``start`` is where the chain starts reading (the
    symbol boundary less FFTCP//2), ``first_bc`` the block count there."""
    fftcp = C.FFTCP_FM
    samperr, angle, count = coldstart_probe_rc(samples, plain=plain)
    flat = count.reshape(count.shape[0], -1)
    best = torch.argmax(flat, dim=1)  # the first of equal maxima, as JAX's
    locked = flat.gather(1, best[:, None])[:, 0] >= 3
    cfo = (torch.div(best, C.BLKSZ, rounding_mode="floor")
           - CFO_RANGE).to(torch.int32)
    start = samperr - fftcp // 2 + (best % C.BLKSZ).to(torch.int32) * fftcp
    start = torch.where(start < 0, start + C.BLKSZ * fftcp, start).to(
        torch.int32)
    ok, bcs, _ = bc_probe_rc(samples, start, angle, cfo, plain=plain)
    bc = torch.arange(C.P1_FM_BLOCKS, device=samples.device)
    votes = ((bcs[:, :, None] == bc) & ok[:, :, None]).sum(dim=1)
    first_bc = torch.argmax(votes, dim=1).to(torch.int32)
    return start, first_bc, cfo, angle, locked & (ok.sum(dim=1) >= 4)


def cold_start_rc(samples_rc, *, device="cuda", plain: bool = False):
    """Cold start of every station of a conjugated rc capture with unknown
    timing, fractional and integer CFO, on ``device``.

    samples_rc: float32 [S, N, 2] (array or tensor), or [N, 2] for one
    station, with N >= WINDOW_FM and room for a block past the lock point
    (the reference receiver probes ``buffer_len(6)`` samples).  Two device
    dispatches for the whole
    fleet, the timing/CFO probe then the bc/psmi probe at each station's
    aligned offset, with the reference's host steps per station between
    and after them.  Returns one lock per station, each
    ``{"offset", "first_bc", "psmi", "cfo", "carry"}`` as the reference's
    ``cold_start_rc`` gives it (``carry`` without the station axis, for
    :func:`fm_chain_scan_rc` on ``samples[offset:]``), or None where the
    station did not lock: a list for [S, N, 2], a lock or None for
    [N, 2]."""
    dev = K.resolve_device(device)
    samples = torch.as_tensor(samples_rc, device=dev)
    single = samples.ndim == 2
    if single:
        samples = samples[None]
    s = samples.shape[0]
    fftcp = C.FFTCP_FM
    samperr, angle, count = coldstart_probe_rc(samples, plain=plain)
    samperr_h = samperr.cpu().numpy()
    count_h = count.cpu().numpy()  # [S, 76, 32]

    starts = np.zeros(s, np.int32)
    cfos = np.zeros(s, np.int32)
    found = np.zeros(s, bool)
    for i in range(s):
        ci, off = np.unravel_index(np.argmax(count_h[i]), count_h[i].shape)
        if count_h[i, ci, off] < 3:
            continue
        found[i] = True
        cfos[i] = int(ci) - CFO_RANGE
        # the needle (block boundary) starts at probe-symbol index ``off``;
        # the chain and the bc probe demodulate with samperr = FFTCP//2
        start = int(samperr_h[i]) - fftcp // 2 + int(off) * fftcp
        while start < 0:
            start += C.BLKSZ * fftcp
        starts[i] = start

    locks = [None] * s
    if found.any():
        cfo = torch.from_numpy(cfos).to(dev)
        ok, bcs, psmis = (x.cpu().numpy() for x in bc_probe_rc(
            samples, torch.from_numpy(starts).to(dev), angle, cfo,
            plain=plain))
        # fresh carries for each service mode voted: the PX state is sized
        # by psmi
        carries = {}
        for i in np.flatnonzero(found):
            good = ok[i]
            if good.sum() < 4:
                continue
            first_bc = int(np.bincount(bcs[i][good]).argmax())
            psmi = int(np.bincount(psmis[i][good]).argmax())
            if not 0 <= psmi < len(C.COMPATIBILITY_MODE):
                psmi = 1
            if psmi not in carries:
                carries[psmi] = chain_rc_init_carry(
                    psmi=psmi, n_stations=s, device=dev)._replace(
                        prev_angle=angle, cfo=cfo)
            locks[i] = {"offset": int(starts[i]), "first_bc": first_bc,
                        "psmi": psmi, "cfo": int(cfos[i]),
                        "carry": ChainCarryRC(*(x[i] for x in
                                                carries[psmi]))}
    return locks[0] if single else locks
