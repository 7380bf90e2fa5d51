"""Real-valued fused AM chain: acquire -> sync -> FEC over AM L1 blocks.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain_am_rc.py`` (lines
34-341): the steady AM chain of MA1 and MA3 from rc I/Q at 46511.7 S/s,
frame-aligned (first symbol FFTCP_AM//2 into the buffer, first block bc
0).  The reference ``vmap``s a per-station ``lax.scan``; here the station
axis is written out and leads every tensor, and the block loop
(:func:`scan_blocks_am`) runs its body for all stations at once, with no
host work and no allocation in it, so that on a card a CUDA graph replays
it (:mod:`nrsc5_tpu_torch.pipeline.block_graph`):

  * K12 (:func:`am_fold`, ``csrc/am_fold.cu``), pass 1: the ramp, the 32 x
    270-sample slice and the shaped 14-sample cyclic-prefix fold with the
    roll, written rounded to bfloat16 as the DFT takes it; the 256-point
    DFT (the float32 matmul alone, :func:`nrsc5_tpu_torch.ops.rcplx.
    dft_rounded_into`); pass 2: the pilot-phase regression from pass 1's
    spectra, then the fold again with the corrected phase and frequency;
    the DFT;
  * K13 (:func:`sync_am_block_rc`, ``csrc/sync_am_block.cu``): the
    sideband combine, the reference bits, the PIDS and partition training
    mults, the sample-clock regression, the interpolated equalizer and the
    QAM64/QAM16/QPSK demaps, one launch per block for all stations, and
    in the loop the carry step of K5 (offset += WINDOW_AM - keep, from K12
    pass 2's keep), so that the loop launches no K5;
  * after the loop, one launch of K15 for every frame of the dispatch,
    then K7 at K=9 and K8 for P1, P3 and PIDS, flat over stations × frames
    (:mod:`nrsc5_tpu_torch.ops.decode_am`).

And the AM cold start (lines 350-540 of the reference): a probe block
(:func:`am_coldstart_block_rc`) runs K14's tone estimate and coarse timing
(:mod:`nrsc5_tpu_torch.ops.acquire_am_rc`), the fine acquire of the block
loop (:func:`acquire_am_fine_rc`), K14's integer-CFO step on its pass-1
spectra and K13 for every station at once, and
:func:`cold_start_am_rc` runs the reference's host lock logic per station
between the probe blocks, all stations in lockstep; on a card the probe
block is the replay of one CUDA graph.

The chain functions take ``plain=True`` to run the kernels' plain
PyTorch versions instead (on any device); on a CPU tensor the kernel
wrappers take the plain versions anyway.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import acquire_am_rc as AA
from nrsc5_tpu_torch.ops import decode_am as DA
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops import sync_am as SA
from nrsc5_tpu_torch.ops.acquire_rc import WINDOW_AM, dynamic_start
from nrsc5_tpu_torch.ops.sync_am import (PLAN_INTS, partitions,  # noqa: F401
                                         sync_am_plan)
from nrsc5_tpu_torch.pipeline import block_graph
from nrsc5_tpu_torch.pipeline.block_graph import (block_carry_am_plain,
                                                  run_into, station_major)
from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len  # noqa: F401

W = C.PARTITION_WIDTH_AM
NSAMP = C.ACQUIRE_SYMBOLS * C.FFTCP_AM  # 8640 samples demodulated a block
ROLL = (C.FFT_AM - C.CP_AM) // 2  # 121: the fold's offset in the FFT input
TWO_PI = 2 * math.pi


class AMChainCarryRC(NamedTuple):
    """Carried AM chain state, one row per station (leading axis S)."""
    offset: torch.Tensor  # int32 [S]
    phase: torch.Tensor  # float32 [S, 2]
    prev_angle: torch.Tensor  # float32 [S]
    samperr_fb: torch.Tensor  # int32 [S]
    cfo: torch.Tensor  # int32 [S] accumulated integer CFO (bins)
    dec: DA.AMDecodeState  # uint8 [S, 54000] each


def am_chain_rc_init_carry(offset: int = 0, cfo: int = 0, *,
                           n_stations: int = 1,
                           device="cuda") -> AMChainCarryRC:
    """Initial carry for ``n_stations`` stations on ``device``."""
    dev = K.resolve_device(device)
    s = n_stations

    def full(value, dtype):
        return torch.full((s,), value, dtype=dtype, device=dev)

    return AMChainCarryRC(
        offset=full(offset, torch.int32),
        phase=torch.tensor([[1.0, 0.0]], device=dev).repeat(s, 1),
        prev_angle=full(0.0, torch.float32),
        samperr_fb=full(0, torch.int32),
        cfo=full(cfo, torch.int32),
        dec=DA.am_decode_init_state(s, device=dev))


# ---------------------------------------------------------------------------
# K12: the two-pass AM acquire fold
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _shape(device: str) -> torch.Tensor:
    return torch.from_numpy(C.ofdm_shape(C.FFT_AM, C.CP_AM)).to(device)


def _check_fold(samples, offset, phase, samperr_fb, prev_angle, cfo):
    s = samples.shape[0]
    if samples.ndim != 3 or samples.shape[-1] != 2 \
            or samples.shape[1] < WINDOW_AM:
        raise ValueError(f"samples: expected [S, >= {WINDOW_AM}, 2], got "
                         f"{tuple(samples.shape)}")
    for name, t, shape in (("offset", offset, (s,)), ("phase", phase, (s, 2)),
                           ("samperr_fb", samperr_fb, (s,)),
                           ("prev_angle", prev_angle, (s,)),
                           ("cfo", cfo, (s,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")


def _fold_plain(samples, start, phase0, angle):
    """The reference's ``_am_fold_fft_rc`` up to its DFT, per station:
    ramp phase0 · e^{i (angle/256) n}, the slice at ``start``, the shaped
    CP fold and the roll by (FFT - CP) // 2."""
    fftcp, fft, cp = C.FFTCP_AM, C.FFT_AM, C.CP_AM
    dev = samples.device
    n = torch.arange(NSAMP, dtype=torch.int64, device=dev)
    ramp = rc.mul(phase0[:, None, :], rc.exp_i(
        rc.fdiv(angle, fft)[:, None] * n.float()))
    idx = start[:, None] + n
    sliced = torch.gather(samples, 1, idx[..., None].expand(-1, -1, 2))
    x = rc.mul(sliced, ramp).reshape(-1, C.ACQUIRE_SYMBOLS, fftcp, 2)
    w = _shape(str(dev))
    head = w[None, None, :cp, None] * x[:, :, :cp] \
        + w[None, None, fft:, None] * x[:, :, fft:]
    folded = torch.cat([head, x[:, :, cp:fft]], dim=2)
    return torch.roll(folded, ROLL, dims=2)


def am_fold_plain(samples, offset, phase, samperr_fb, prev_angle, cfo,
                  spectra1=None, unrounded: bool = False):
    """Plain version of K12 (the reference's ``acquire_am_fine_rc`` with
    ``_am_process_rc`` and ``_am_fold_fft_rc``, up to each DFT, and the
    DFT's rounding of its input to bfloat16).

    samples [S, N, 2] float32 rc (N >= WINDOW_AM); per station offset
    int32 (window start), phase [2] (the sample-clock phasor), samperr_fb
    int32, prev_angle float32, cfo int32 bins.  Pass 1 (``spectra1``
    None) returns the folded symbols float32 [S, 32, 256, 2] of the first
    demodulation.  Pass 2 takes pass 1's spectra [S, 32, 256, 2], fits
    the pilot phase, and returns (folded [S, 32, 256, 2], phase_out
    [S, 2], prev_angle_out [S], keep int32 [S]).  The folded symbols are
    rounded to bfloat16 and widened back (:func:`rcplx.round_bf16`), the
    DFT's operand; ``unrounded`` returns them as float32 computes them,
    what the kernel's gate holds it to.  Sums run from the first term to
    the last, and divisions by numbers are true divisions, as the kernel
    computes them."""
    _check_fold(samples, offset, phase, samperr_fb, prev_angle, cfo)
    fftcp, fft = C.FFTCP_AM, C.FFT_AM
    nsym = C.ACQUIRE_SYMBOLS
    samperr = fftcp // 2 + samperr_fb
    angle = prev_angle - TWO_PI * cfo.float()
    phase0 = rc.normalize(rc.mul(phase, rc.exp_i(rc.fdiv(
        -(fftcp // 2 - samperr).float() * angle, fft))))
    start = dynamic_start(offset.long(), samples.shape[1], WINDOW_AM) \
        + dynamic_start(samperr.long(), WINDOW_AM, NSAMP)
    finish = (lambda f: f) if unrounded else rc.round_bf16
    if spectra1 is None:
        return finish(_fold_plain(samples, start, phase0, angle))

    # pilot-phase regression (reference: src/acquire.c:170-240)
    pilot = spectra1[:, :, C.CENTER_AM]  # [S, 32, 2]
    dphi = rc.angle(rc.mul_conj(pilot[:, 1:], pilot[:, :-1]))  # [S, 31]
    a0 = rc.angle(pilot[:, 0])
    cs = torch.zeros_like(a0)
    ys = [a0 + cs]
    for i in range(nsym - 1):
        cs = cs + dphi[:, i]
        ys.append(a0 + cs)
    y = torch.stack(ys, dim=1)  # [S, 32]
    x = fftcp * (torch.arange(nsym, dtype=torch.float32,
                              device=samples.device) - (nsym - 1) / 2)
    slope = rc.ordered_sum(x * y) / rc.ordered_sum(x * x)
    angle2 = angle - slope * fft
    y_mean = rc.fdiv(rc.ordered_sum(y), nsym)
    phase0b = rc.mul(phase0, rc.exp_i(
        -y_mean + rc.fdiv(slope * nsym * fftcp, 2) - 0.06))

    folded = finish(_fold_plain(samples, start, phase0b, angle2))
    phase_out = rc.normalize(rc.mul(phase0b, rc.exp_i(
        rc.fdiv(angle2, fft) * NSAMP)))
    keep = (fftcp + (fftcp // 2 - samperr)).to(torch.int32)
    prev_angle_out = angle2 + TWO_PI * cfo.float()
    return folded, phase_out, prev_angle_out, keep


def am_fold(samples, offset, phase, samperr_fb, prev_angle, cfo,
            spectra1=None, out=None):
    """K12: the arguments and results of :func:`am_fold_plain`, pass 1 or
    pass 2, written into ``out`` where it is given (pass 1: folded; pass
    2: (folded, phase_out, prev_angle_out, keep)).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one CTA per station and two symbols, one thread per output
    bin; every thread loads its samples first, then in pass 1 forms the
    station's phase itself, while in pass 2 warp 0 forms it and the pilot
    fit for the CTA)."""
    if samples.device.type == "cpu":
        res = am_fold_plain(samples, offset, phase, samperr_fb, prev_angle,
                            cfo, spectra1)
        return res if out is None else K.into(out, res)
    _check_fold(samples, offset, phase, samperr_fb, prev_angle, cfo)
    s, dev = samples.shape[0], samples.device
    K.check(samples, "samples", torch.float32)
    K.check(offset, "offset", torch.int32)
    K.check(phase, "phase", torch.float32)
    K.check(samperr_fb, "samperr_fb", torch.int32)
    K.check(prev_angle, "prev_angle", torch.float32)
    K.check(cfo, "cfo", torch.int32)
    fshape = (s, C.ACQUIRE_SYMBOLS, C.FFT_AM, 2)
    outs = (None, None, None)
    if spectra1 is None:
        folded = torch.empty(fshape, dtype=torch.float32, device=dev) \
            if out is None else out
    else:
        K.check(spectra1, "spectra1", torch.float32, fshape)
        if out is None:
            out = (torch.empty(fshape, dtype=torch.float32, device=dev),
                   torch.empty(s, 2, dtype=torch.float32, device=dev),
                   torch.empty(s, dtype=torch.float32, device=dev),
                   torch.empty(s, dtype=torch.int32, device=dev))
        folded, *outs = out
        for name, t, dtype, shape in zip(
                ("phase_out", "prev_angle_out", "keep"), outs,
                (torch.float32, torch.float32, torch.int32),
                ((s, 2), (s,), (s,))):
            K.check(t, name, dtype, shape)
    K.check(folded, "folded", torch.float32, fshape)
    K.launch("am_fold", samples.data_ptr(), samples.shape[1],
             offset.data_ptr(), phase.data_ptr(), samperr_fb.data_ptr(),
             prev_angle.data_ptr(), cfo.data_ptr(),
             _shape(str(dev)).data_ptr(),
             None if spectra1 is None else spectra1.data_ptr(),
             folded.data_ptr(),
             *(None if t is None else t.data_ptr() for t in outs), s,
             device=dev)
    return folded if spectra1 is None else (folded, *outs)


def acquire_am_fine_rc(samples, offset, phase, samperr_fb, prev_angle, cfo,
                       plain: bool = False, out=None, scratch=None):
    """The reference's ``acquire_am_fine_rc`` for a station batch: K12
    pass 1, the DFT, K12 pass 2, the DFT (each DFT the float32 matmul
    alone on K12's bf16-rounded fold).  Returns (spectra [S, 32, 256, 2],
    phase_out [S, 2], prev_angle_out [S], keep int32 [S]), written into
    ``out`` where it is given.  ``scratch`` is (folded, spectra1): two
    float32 [S, 32, 256, 2] buffers; with ``out`` and ``scratch`` given
    the step allocates nothing, as the block loop
    (:func:`scan_blocks_am`) needs."""
    s, dev = samples.shape[0], samples.device
    fshape = (s, C.BLKSZ, C.FFT_AM, 2)
    if out is None:
        out = (torch.empty(fshape, device=dev),
               torch.empty(s, 2, device=dev), torch.empty(s, device=dev),
               torch.empty(s, dtype=torch.int32, device=dev))
    if scratch is None:
        scratch = (torch.empty(fshape, device=dev),
                   torch.empty(fshape, device=dev))
    spectra, phase_out, prev_angle_out, keep = out
    folded, spectra1 = scratch
    args = (samples, offset, phase, samperr_fb, prev_angle, cfo)
    run_into(am_fold, am_fold_plain, plain, args, folded)
    rc.dft_rounded_into(folded, spectra1, shift=True)
    run_into(am_fold, am_fold_plain, plain, args + (spectra1,),
             (folded, phase_out, prev_angle_out, keep))
    rc.dft_rounded_into(folded, spectra, shift=True)
    return out


# ---------------------------------------------------------------------------
# K13: the AM sync block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sync_tables(ma3: bool, device: str) -> dict:
    """K13's plain version's index and constant tensors on ``device``,
    cached, so that it makes no host copy (and can run inside a CUDA
    graph)."""
    def const(v: complex):
        return torch.tensor([v.real, v.imag], dtype=torch.float32)

    ar = torch.arange(W)
    t1, t2 = torch.from_numpy(SA.TRAIN1), torch.from_numpy(SA.TRAIN2)
    a_lo = torch.minimum(t1, t2)  # the training rows, 16 apart
    parts, _ = partitions(ma3)
    out = {
        "low": SA.CENTER - torch.arange(C.REF_INDEX_AM, C.MAX_INDEX_AM + 1),
        "comb": torch.arange(C.REF_INDEX_AM, C.PIDS_OUTER_INDEX_AM + 1),
        "ar": ar, "t1": t1, "t2": t2, "a_lo": a_lo,
        "u": (torch.arange(C.BLKSZ)[:, None] - a_lo[None, :] - 8) / 16.0,
        "colf": ar.float(), "tq16": const(2 * SA.TRAIN_QAM16),
        "bins": [first + step * ar for first, step, _, _ in parts],
        "nominal": [const(2 * nominal) for _, _, nominal, _ in parts],
    }
    return {k: [t.to(device) for t in v] if isinstance(v, list)
            else v.to(device) for k, v in out.items()}


def _demap(z: torch.Tensor, levels: int) -> torch.Tensor:
    """QAM64 / QAM16 Gray demap or the QPSK sign demap of rc symbols."""
    if levels == 2:
        return ((z[..., 0] >= 0).to(torch.uint8)
                | ((z[..., 1] >= 0).to(torch.uint8) << 1))
    gray, shift = (SA.gray8_map, 3) if levels == 8 else (SA.gray4_map, 2)
    return gray(z[..., 0]) | (gray(z[..., 1]) << shift)


def _check_spectra(spectra):
    if spectra.ndim != 4 or spectra.shape[1:] != (C.BLKSZ, C.FFT_AM, 2):
        raise ValueError(f"spectra: expected [S, {C.BLKSZ}, {C.FFT_AM}, 2],"
                         f" got {tuple(spectra.shape)}")


def _check_carry(carry, s: int) -> None:
    """The block loop's carry step handed to K13: (keep, offset), int32
    [S] each."""
    for name, t in zip(("keep", "offset"), carry):
        if tuple(t.shape) != (s,):
            raise ValueError(f"carry {name}: expected shape {(s,)}, got "
                             f"{tuple(t.shape)}")


def sync_am_block_rc_plain(spectra, ma3: bool = False, carry=None):
    """Plain version of K13 (the reference's ``sync_am_block_rc`` with the
    interpolated equalizer), for a station batch.  spectra [S, 32, 256,
    2].  ``carry`` (the block loop's (keep, offset), else None): K5's AM
    step, ``offset += WINDOW_AM - keep`` in place
    (:func:`~nrsc5_tpu_torch.pipeline.block_graph.block_carry_am_plain`).
    Returns ``codes`` uint8 [S, 4, 800] (pl, pu, s, t, each in
    (symbol, column) order), ``pids`` uint8 [S, 32, 2], ``ref_bits``
    uint8 [S, 32] and ``samperr`` int32 [S].  Sums run from the first
    term to the last and divisions by numbers are true divisions, as K13
    computes them."""
    _check_spectra(spectra)
    if carry is not None:
        _check_carry(carry, spectra.shape[0])
        block_carry_am_plain(*carry)
    t = _sync_tables(ma3, str(spectra.device))
    c = SA.CENTER
    buf = spectra.clone()
    low = buf[:, :, t["low"]]
    buf[:, :, t["low"]] = torch.stack([-low[..., 0], low[..., 1]], dim=-1)
    if not ma3:
        j = t["comb"]
        buf[:, :, c + j] = buf[:, :, c + j] + buf[:, :, c - j]

    ref_bits = (buf[:, :, c + C.REF_INDEX_AM, 1] > 0).to(torch.uint8)

    parts, pids_bins = partitions(ma3)
    pids = []
    for b in pids_bins:
        col = buf[:, :, b]  # [S, 32, 2]
        m = rc.div(t["tq16"], col[:, 8] + col[:, 24])
        pids.append(_demap(rc.mul(col, m[:, None]), 4))
    pids = torch.stack(pids, dim=2)

    ar, t1, t2, a_lo, u, colf = (t[k] for k in ("ar", "t1", "t2", "a_lo",
                                                 "u", "colf"))
    mults, codes = [], []
    for (_, _, _, levels), bins, nominal in zip(parts, t["bins"],
                                                 t["nominal"]):
        cols = buf[:, :, bins]  # [S, 32, W, 2]
        tr = cols[:, t1, ar] + cols[:, t2, ar]  # [S, W, 2]
        mult = rc.div(nominal.expand(tr.shape), tr)
        mults.append(mult)
        # interpolated equalizer (the reference's AM_EQ_INTERP): the
        # anchor-to-anchor phase delta, weighted-linear-fitted across the
        # partition's columns, spread linearly over the 32 symbol rows
        lo, hi = cols[:, a_lo, ar], cols[:, a_lo + 16, ar]
        dphi = SA._wrap_pi(rc.angle(lo) - rc.angle(hi))  # [S, W]
        w = torch.sqrt(rc.abs2(lo) * rc.abs2(hi)) + 1e-12
        wsum = rc.ordered_sum(w)
        cbar = rc.ordered_sum(w * colf) / wsum
        dbar = rc.ordered_sum(w * dphi) / wsum
        xc = colf - cbar[:, None]
        b = rc.ordered_sum(w * xc * (dphi - dbar[:, None])) \
            / (rc.ordered_sum(w * (xc * xc)) + 1e-12)
        fit = dbar[:, None] + b[:, None] * xc  # [S, W]
        rot = rc.exp_i(u[None] * fit[:, None, :])  # [S, 32, W, 2]
        eq = rc.mul(cols, rc.mul(mult[:, None], rot))
        codes.append(_demap(eq, levels).reshape(-1, C.BLKSZ * W))

    # sample clock error from the phase slope across the primary columns
    # (reference: src/sync.c:717-723)
    dp, du = (rc.ordered_sum(SA._wrap_half_pi(rc.angle(m[:, 1:])
                                            - rc.angle(m[:, :-1])))
              for m in mults[:2])
    samperr = rc.fdiv(rc.fdiv(dp + du, 2 * (W - 1)) * C.FFT_AM, TWO_PI)
    return {"codes": torch.stack(codes, dim=1), "pids": pids,
            "ref_bits": ref_bits,
            "samperr": torch.round(samperr).to(torch.int32)}


def sync_am_block_shapes(s: int) -> dict:
    """{key: (shape, dtype)} of K13's outputs for ``s`` stations."""
    return {"codes": ((s, 4, C.BLKSZ * W), torch.uint8),
            "pids": ((s, C.BLKSZ, 2), torch.uint8),
            "ref_bits": ((s, C.BLKSZ), torch.uint8),
            "samperr": ((s,), torch.int32)}


def sync_am_block_rc(spectra, ma3: bool = False, carry=None, out=None):
    """K13: the arguments and results of :func:`sync_am_block_rc_plain`,
    written into ``out`` (a dict of every key it returns) where it is
    given.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (four CTAs a station, one a partition, each loading only the
    bins :func:`sync_am_plan` gives it; with ``carry``, thread 0 of a
    station's first CTA also takes K5's AM step)."""
    if spectra.device.type == "cpu":
        res = sync_am_block_rc_plain(spectra, ma3, carry)
        return res if out is None else K.into(out, res)
    _check_spectra(spectra)
    K.check(spectra, "spectra", torch.float32)
    s, dev = spectra.shape[0], spectra.device
    shapes = sync_am_block_shapes(s)
    if out is None:
        out = {k: torch.empty(shape, dtype=dtype, device=dev)
               for k, (shape, dtype) in shapes.items()}
    if set(out) != set(shapes):
        raise ValueError(f"out: expected keys {sorted(shapes)}, got "
                         f"{sorted(out)}")
    for k, (shape, dtype) in shapes.items():
        K.check(out[k], k, dtype, shape)
    step = (None, None)
    if carry is not None:
        _check_carry(carry, s)
        for name, t in zip(("keep", "offset"), carry):
            K.check(t, name, torch.int32, (s,))
        step = tuple(t.data_ptr() for t in carry)
    K.launch("sync_am_block", spectra.data_ptr(),
             sync_am_plan(bool(ma3)).ctypes.data,
             *(out[k].data_ptr() for k in ("codes", "pids", "ref_bits",
                                           "samperr")),
             s, int(ma3), *step, WINDOW_AM, device=dev)
    return out


# ---------------------------------------------------------------------------
# fused chain
# ---------------------------------------------------------------------------

def scan_blocks_am(samples, carry: AMChainCarryRC, n_blocks: int,
                   ma3: bool = False, plain: bool = False) -> dict:
    """The per-block acquire + sync loop over ``n_blocks`` blocks (8 a
    frame), with no host work and no allocation in its body, so that a
    CUDA graph can replay it (:mod:`nrsc5_tpu_torch.pipeline.block_graph`).
    samples: [S, N, 2] rc.  Each block runs :func:`acquire_am_fine_rc`
    (K12 pass 1, the DFT, K12 pass 2, the DFT) and K13 (its codes and
    PIDS straight into slot b of block-major buffers, its samperr into the
    carried feedback, then K5's carry step).  Reads only the carry's loop
    fields (offset, phase, prev_angle, samperr_fb, cfo).  Returns {"codes":
    uint8 [n_blocks, S, 4, 800], "pids": uint8 [n_blocks, S, 32, 2],
    "carry": {field: [S, ...]} after the last block}; :func:`finish_scan_am`
    makes the station-major outputs and the carry."""
    s, dev = samples.shape[0], samples.device
    sync = sync_am_block_rc_plain if plain else sync_am_block_rc
    shapes = sync_am_block_shapes(s)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    codes = empty((n_blocks,) + shapes["codes"][0], torch.uint8)
    pids = empty((n_blocks,) + shapes["pids"][0], torch.uint8)
    ref_bits = empty(*shapes["ref_bits"])
    offset = carry.offset.clone()
    samperr_fb = carry.samperr_fb.clone()
    # ping-pong pairs: block b reads [b % 2] and writes [(b + 1) % 2]
    phase = (carry.phase.clone(), empty((s, 2)))
    prev_angle = (carry.prev_angle.clone(), empty((s,)))
    fshape = (s, C.BLKSZ, C.FFT_AM, 2)
    spectra = empty(fshape)
    scratch = (empty(fshape), empty(fshape))
    keep = empty((s,), torch.int32)
    for b in range(n_blocks):
        i, j = b % 2, (b + 1) % 2
        acquire_am_fine_rc(samples, offset, phase[i], samperr_fb,
                           prev_angle[i], carry.cfo, plain,
                           (spectra, phase[j], prev_angle[j], keep), scratch)
        run_into(sync_am_block_rc, sync, plain,
                 (spectra, ma3, (keep, offset)),
                 {"codes": codes[b], "pids": pids[b], "ref_bits": ref_bits,
                  "samperr": samperr_fb})
    last = n_blocks % 2
    loop = {"offset": offset, "phase": phase[last],
            "prev_angle": prev_angle[last], "samperr_fb": samperr_fb}
    return {"codes": codes, "pids": pids, "carry": loop}


def finish_scan_am(scanned: dict, carry: AMChainCarryRC):
    """:func:`scan_blocks_am`' block-major results -> (codes uint8 [S,
    n_blocks, 4, 800], pids codes uint8 [S, n_blocks, 32, 2], new carry
    with the delay lines untouched): fresh tensors, so that a graph's next
    replay does not overwrite them (:func:`~nrsc5_tpu_torch.pipeline.
    block_graph.station_major`)."""
    return (station_major(scanned["codes"]),
            station_major(scanned["pids"]),
            carry._replace(**{k: v.clone()
                              for k, v in scanned["carry"].items()}))


def am_frontend_scan_rc(samples, carry: AMChainCarryRC, n_blocks: int,
                        ma3: bool = False, plain: bool = False):
    """The per-block acquire + sync loop over ``n_blocks`` blocks (8 a
    frame), run eagerly.  samples: [S, N, 2] rc.  Returns (codes uint8 [S,
    n_blocks, 4, 800], pids codes uint8 [S, n_blocks, 32, 2], new carry
    without the delay lines touched)."""
    return finish_scan_am(scan_blocks_am(samples, carry, n_blocks, ma3,
                                         plain), carry)


def am_decode(codes, pids, cy: AMChainCarryRC, carries: AMChainCarryRC,
              n_frames: int, ma3: bool = False, packed: bool = False,
              plain: bool = False):
    """The gathers and FEC after the block loop: the loop's codes, PIDS
    codes and carry, and the dispatch's incoming carries (for their delay
    lines) -> (out, new carries) as :func:`am_chain_batch_rc` gives
    them."""
    s = codes.shape[0]
    p1_ext, p3_ext, pids_ext, dec = DA.am_gather(codes, pids, carries.dec,
                                                 ma3, plain=plain)
    p1, m1, p3, m3, pids_bits = DA.am_fec(p1_ext, p3_ext, pids_ext, ma3,
                                          packed, plain)
    sub = 8  # P1 subframes a frame
    out = {"p1": p1.reshape((s, n_frames) + (() if packed else (sub,))
                            + (-1,)),
           "p3": p3.reshape(s, n_frames, -1),
           "pids": pids_bits.reshape(s, n_frames * C.P1_AM_BLOCKS, -1),
           "p1_margin": m1.reshape(s, n_frames, sub),
           "p3_margin": m3.reshape(s, n_frames)}
    return out, cy._replace(dec=dec)


def am_chain_batch_rc(samples, carries: AMChainCarryRC, n_frames: int,
                      ma3: bool = False, packed: bool = False,
                      plain: bool = False):
    """Station batch: samples [S, N, 2] rc at 46511.7 S/s, N >=
    am_buffer_len(n_frames).  The FEC is flat-batched over stations ×
    frames (× subframes), as in the reference.

    Returns (out, new carries) with ``out["p1"]`` uint8 [S, F, 8, 3750]
    (packed: [S, F, 3750], the frame's 30000 bits flattened),
    ``out["p3"]`` [S, F, 24000 or 30000] (or packed), ``out["pids"]``
    [S, 8F, 80] (or [S, 8F, 10]), ``out["p1_margin"]`` float32 [S, F, 8]
    and ``out["p3_margin"]`` [S, F].  P1 and P3 of a stream's first three
    frames are diversity warm-up."""
    codes, pids, cy = am_frontend_scan_rc(
        samples, carries, n_frames * C.P1_AM_BLOCKS, ma3, plain)
    return am_decode(codes, pids, cy, carries, n_frames, ma3, packed, plain)


def am_chain_scan_rc(samples, carry: AMChainCarryRC, n_frames: int,
                     ma3: bool = False, packed: bool = False,
                     plain: bool = False):
    """One station: samples [N, 2] and a carry without the station axis.
    Same outputs as :func:`am_chain_batch_rc` without the station axis."""
    batched = AMChainCarryRC(*(x[None] for x in carry[:-1]),
                             DA.AMDecodeState(*(x[None] for x in carry.dec)))
    out, new = am_chain_batch_rc(samples[None], batched, n_frames, ma3,
                                 packed, plain)
    return ({k: v[0] for k, v in out.items()},
            AMChainCarryRC(*(x[0] for x in new[:-1]),
                           DA.AMDecodeState(*(x[0] for x in new.dec))))


# ---------------------------------------------------------------------------
# cold start (the reference's NONE -> COARSE -> FINE machine of the AM
# receiver; reference: src/acquire.c:129-235 and the find_block_am
# bc-history lock of src/sync.c:635-666)
# ---------------------------------------------------------------------------

# the probe block's small integers, packed after the 32 reference bits in
# the one tensor the host reads back a block
PROBE_INTS = ("samperr", "keep", "cfo_step", "measured")


def unpack_probe(ints: np.ndarray) -> dict:
    """The host's view of :func:`am_coldstart_block_rc`'s ``ints`` [S, 36]:
    ``ref_bits`` uint8 [S, 32] and one int array [S] per PROBE_INTS name."""
    out = {"ref_bits": ints[:, :C.BLKSZ].astype(np.uint8)}
    for k, name in enumerate(PROBE_INTS):
        out[name] = ints[:, C.BLKSZ + k]
    return out


def am_coldstart_block_rc(samples, offset, phase, prev_angle, cfo,
                          coarse_override, plain: bool = False) -> dict:
    """One COARSE probe block for a station batch (the reference's
    ``am_coldstart_block_rc``): the power DFT, K14's tone estimate and
    coarse timing with the latch override and the prev_angle smoothing,
    :func:`acquire_am_fine_rc` (K12 pass 1, its DFT, K12 pass 2, its DFT),
    K14's integer-CFO step on pass 1's spectra, K13 with MA1 combining
    (the reference bits, all the lock logic reads, are the same in both
    modes).

    samples [S, N, 2] float32 rc; per station offset int32 (the window
    start), phase [2], prev_angle float32, cfo int32 bins, coarse_override
    int32 (the consensus latch, -1 for none).  Returns ``ints`` int32 [S,
    36] (the reference bits, then samperr, keep, the CFO step and the
    measured timing: :func:`unpack_probe`), ``phase`` [S, 2] and
    ``prev_angle`` [S] for the next block, and ``mag_sums`` [S, 107] (the
    reference's ``mag_sums`` on the bins the CFO step searches)."""
    tone = AA.am_tone_plain if plain else AA.am_tone
    coarse = AA.am_coarse_plain if plain else AA.am_coarse
    cfo_step = AA.am_cfo_step_plain if plain else AA.am_cfo_step
    sync = sync_am_block_rc_plain if plain else sync_am_block_rc

    f, amp = tone(rc.dft(AA.tone_symbols(samples, offset)), samples, offset)
    measured, samperr, prev_angle, _ = coarse(samples, offset, f, amp,
                                              prev_angle, coarse_override)
    # the cold start demodulates at samperr itself; K12 adds FFTCP_AM // 2;
    # the CFO step reads pass 1's spectra (scratch[1])
    fshape = (samples.shape[0], C.BLKSZ, C.FFT_AM, 2)
    scratch = (torch.empty(fshape, device=samples.device),
               torch.empty(fshape, device=samples.device))
    spectra, phase, prev_angle, keep = acquire_am_fine_rc(
        samples, offset, phase, samperr - C.FFTCP_AM // 2, prev_angle, cfo,
        plain, scratch=scratch)
    step, mags = cfo_step(scratch[1])
    ref_bits = sync(spectra, False)["ref_bits"]
    ints = torch.cat([ref_bits.to(torch.int32),
                      torch.stack([samperr, keep, step, measured], dim=1)],
                     dim=1)
    return {"ints": ints, "phase": phase, "prev_angle": prev_angle,
            "mag_sums": mags}


class _LockState:
    """One station's host state of the reference's lock loop
    (scan_chain_am_rc.py:471-478)."""

    def __init__(self):
        self.pos, self.cfo, self.keep_extra, self.cfo_wait = 0, 0, 0, 0
        self.history = 0
        self.psmi = C.SERVICE_MODE_MA1
        self.coarse_hist: list[int] = []
        self.latch, self.latch_age = -1, 0
        self.done = False

    def step(self, probe: dict, i: int):
        """This station's host steps after a probe block: the consensus
        latch, the integer CFO, the needle realignment and the bc history.
        Returns the lock's (start, psmi) once the history reads 5, 6, 7, 0,
        "none" if the lock falls inside the warm-up guard, else None (and
        the window moves on)."""
        fftcp = C.FFTCP_AM
        self.coarse_hist.append(int(probe["measured"][i]) % fftcp)
        self.coarse_hist = self.coarse_hist[-6:]
        if self.latch < 0:
            cons = SA.timing_consensus(self.coarse_hist, fftcp)
            if cons is not None:
                self.latch, self.latch_age = cons, 0
        else:
            self.latch_age += 1
            if self.latch_age > 16:
                self.latch, self.latch_age = -1, 0
                self.coarse_hist.clear()
        self.cfo += int(probe["cfo_step"][i])

        ref = probe["ref_bits"][i]
        if self.cfo_wait == 0:
            off_sym = SA.find_ref_am(ref)
            if off_sym > 0:
                self.keep_extra = ((C.BLKSZ - off_sym) % C.BLKSZ) * fftcp
                self.cfo_wait = 8
        else:
            self.cfo_wait -= 1

        found = SA.find_block_am(ref)
        if found is None:
            self.history = 0
        else:
            bc, control = found
            if control:
                self.psmi = int(control["psmi"]) or C.SERVICE_MODE_MA1
            self.history = ((self.history << 4) | bc) & 0xFFFFFFFF
        if (self.history & 0xFFFF) == 0x5670:
            # this block is bc 0: the frame starts at its first symbol, and
            # the chain expects that symbol FFTCP_AM // 2 into its buffer
            start = self.pos + int(probe["samperr"][i]) - fftcp // 2
            return "none" if start < 0 else (start, self.psmi)
        self.pos += WINDOW_AM - (int(probe["keep"][i]) + self.keep_extra)
        self.keep_extra = 0
        return None


def _probe_eager(samples, plain: bool):
    """The probe-block loop's step, run eagerly: control ints [3, S]
    (offset, CFO, latch) -> (the probe's ints as numpy [S, 36], the
    prev_angle [S] it leaves)."""
    s, dev = samples.shape[0], samples.device
    carried = {"phase": torch.tensor([[1.0, 0.0]], device=dev).repeat(s, 1),
               "prev_angle": torch.zeros(s, dtype=torch.float32,
                                         device=dev)}

    def step(ctl: np.ndarray):
        offset, cfo, latch = torch.from_numpy(ctl).to(dev)
        out = am_coldstart_block_rc(samples, offset, carried["phase"],
                                    carried["prev_angle"], cfo, latch,
                                    plain=plain)
        carried["phase"], carried["prev_angle"] = (out["phase"],
                                                   out["prev_angle"])
        return out["ints"].cpu().numpy(), out["prev_angle"]
    return step


def _probe_body(samples, ctl, phase, prev_angle):
    """One probe block as the graph captures it: the control ints come
    from the static ``ctl`` [3, S], and the phase and prev_angle it leaves
    are written back into the static inputs for the next replay."""
    out = am_coldstart_block_rc(samples, ctl[0], phase, prev_angle, ctl[1],
                                ctl[2])
    phase.copy_(out["phase"])
    prev_angle.copy_(out["prev_angle"])
    return out["ints"]


def _probe_graph(samples):
    """The probe-block loop's step as a replay of one CUDA graph for the
    capture's shape: the host writes the control ints into one pinned
    buffer, which goes up into the graph's static inputs; the probe's
    ints come back, the one read-back a block the host's lock logic
    needs."""
    s, dev = samples.shape[0], samples.device
    ctl_host = torch.zeros((3, s), dtype=torch.int32, pin_memory=True)
    start = {"samples": samples, "ctl": ctl_host,
             "phase": torch.tensor([[1.0, 0.0]], device=dev).repeat(s, 1),
             "prev_angle": torch.zeros(s, dtype=torch.float32, device=dev)}
    loop = block_graph.captured(("am_probe", str(dev), tuple(samples.shape)),
                                _probe_body, start, dev)
    inputs = start

    def step(ctl: np.ndarray):
        nonlocal inputs
        ctl_host.numpy()[:] = ctl
        ints = loop(**inputs)
        inputs = {"ctl": ctl_host}  # the samples and the phase stay put
        return ints.cpu().numpy(), loop.inputs["prev_angle"]
    return step


def cold_start_am_rc(samples_rc, max_blocks: int = 24, *, device="cuda",
                     plain: bool = False, graph: bool = True):
    """Cold start of every station of an rc capture with unknown timing,
    fractional and integer CFO (MA1 or MA3), on ``device``.

    samples_rc: float32 [S, N, 2] (array or tensor), or [N, 2] for one
    station, at 46511.7 S/s.  One probe block (:func:`am_coldstart_block_rc`)
    a step for the whole fleet, one host read-back of its integers, then
    the reference's host steps per station: the timing-consensus latch,
    the integer CFO from the strongest bin near the carrier, the needle
    realignment, and the lock when the block-count history reads 5, 6, 7,
    0 (so the locking block is a frame boundary).  A station stops when it
    locks, when its next window would pass the end of the capture, or after
    ``max_blocks`` blocks; a stopped station rides along at a clamped
    offset and its results are ignored.  On a card the probe block is the
    replay of one CUDA graph per capture shape (``graph=False``: launched
    eagerly; ``plain=True`` runs the plain versions, eagerly).  Returns one
    lock per station, each ``{"offset", "psmi", "ma3", "cfo", "carry"}`` as
    the reference's ``cold_start_am_rc`` gives it (``offset`` in chain
    samples from the start of the station's stream; ``carry`` without the
    station axis, for :func:`am_chain_scan_rc` on ``samples[offset:]``), or
    None where the station did not lock: a list for [S, N, 2], a lock or
    None for [N, 2]."""
    dev = K.resolve_device(device)
    samples = torch.as_tensor(samples_rc, dtype=torch.float32, device=dev)
    single = samples.ndim == 2
    if single:
        samples = samples[None]
    s, n = samples.shape[0], samples.shape[1]
    states = [_LockState() for _ in range(s)]
    locks = [None] * s
    angles = {}  # station -> prev_angle of every station at its lock
    step = _probe_graph(samples) if dev.type == "cuda" and graph \
        and not plain else _probe_eager(samples, plain)
    for _ in range(max_blocks):
        for st in states:
            if not st.done and st.pos + WINDOW_AM > n:
                st.done = True
        if all(st.done for st in states):
            break
        ctl = np.array([[min(st.pos, n - WINDOW_AM) for st in states],
                        [st.cfo for st in states],
                        [st.latch for st in states]], np.int32)
        ints, prev_angle = step(ctl)
        probe = unpack_probe(ints)
        for i, st in enumerate(states):
            if st.done:
                continue
            got = st.step(probe, i)
            if got is None:
                continue
            st.done = True
            if got == "none":
                continue
            start, psmi = got
            locks[i] = {"offset": start, "psmi": psmi,
                        "ma3": psmi == C.SERVICE_MODE_MA3, "cfo": st.cfo}
            angles[i] = prev_angle[i].clone()
    if angles:
        # fresh carries with each station's CFO, the phase reset to [1, 0],
        # and the prev_angle its lock block left
        fresh = am_chain_rc_init_carry(n_stations=s, device=dev)
        cfo = torch.tensor([st.cfo for st in states], dtype=torch.int32,
                           device=dev)
        for i, pa in angles.items():
            locks[i]["carry"] = AMChainCarryRC(
                offset=fresh.offset[i], phase=fresh.phase[i],
                prev_angle=pa, samperr_fb=fresh.samperr_fb[i],
                cfo=cfo[i], dec=DA.AMDecodeState(*(x[i] for x in fresh.dec)))
    return locks[0] if single else locks
