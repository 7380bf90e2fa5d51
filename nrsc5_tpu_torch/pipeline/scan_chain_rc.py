"""Real-valued fused FM chain: acquire -> sync -> FEC over L1 blocks.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain_rc.py`` (lines
37-436) for service modes without PX channels.  The reference ``vmap``s a
per-station ``lax.scan``; here the station axis is written out and leads
every tensor, and the block scan is a Python loop whose body runs for all
stations at once:

  * K2 (:func:`nrsc5_tpu_torch.ops.acquire_rc.demod_fold`) reads each
    station's window at its own offset and folds it, the DFT is a matmul;
  * :func:`sync_block_rc` tracks the reference subcarriers with the Costas
    PLL, kernel K3 (:func:`costas_track_rc`), then equalizes and soft-demaps
    to int8 in plain PyTorch;
  * after the loop the P1 and PIDS FEC run flat-batched over stations ×
    frames through kernel K7.

Every function takes ``plain=True`` to run the kernels' plain PyTorch
versions instead (on any device); on a CPU tensor the kernel wrappers take
the plain versions anyway.
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
from nrsc5_tpu_torch.ops.acquire_rc import (WINDOW_FM, demod_fold,
                                            demod_fold_plain)
from nrsc5_tpu_torch.ops.bits import pack_out
from nrsc5_tpu_torch.ops.decode_fm import p1_decode, pids_decode
from nrsc5_tpu_torch.pipeline.scan_chain import px_frame_lens

W = C.PARTITION_WIDTH_FM
TWO_PI = 2 * math.pi


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


def check_psmi(psmi: int) -> None:
    """The port decodes P1 and PIDS only: service modes with PX channels
    (MP2/MP3/MP11) are not ported yet."""
    if any(px_frame_lens(psmi)):
        raise NotImplementedError(
            f"psmi {psmi} carries PX channels, which the port does not "
            "decode yet")


def chain_rc_init_carry(offset: int = 0, psmi: int = 1, cfo: int = 0, *,
                        n_stations: int = 1,
                        device="cuda") -> ChainCarryRC:
    """Initial carry for ``n_stations`` stations on ``device``."""
    check_psmi(psmi)
    dev = K.resolve_device(device)
    s = n_stations

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
    )


# ---------------------------------------------------------------------------
# K3: Costas PLL
# ---------------------------------------------------------------------------

def _wrap_pi(x):
    return x - TWO_PI * torch.round(x / TWO_PI)


def _phase_diff(a, b):
    d = a - b
    return d - math.pi * torch.round(d / math.pi)


def _check_costas(refs, phase0, freq0, cfo_freq):
    if refs.ndim != 3 or refs.shape[-1] != 2:
        raise ValueError(f"refs: expected [T, R, 2], got {tuple(refs.shape)}")
    r = refs.shape[1]
    for name, t in (("phase0", phase0), ("freq0", freq0),
                    ("cfo_freq", cfo_freq)):
        if t is not None and tuple(t.shape) != (r,):
            raise ValueError(f"{name}: expected shape ({r},), got "
                             f"{tuple(t.shape)}")


def costas_track_rc_plain(refs, phase0, freq0, cfo_freq=None):
    """Plain version of K3.  refs: [T, R, 2] (T symbols of R independent
    tracks); phase0, freq0 and the optional static per-track frequency
    ``cfo_freq``: [R].  Returns (derot [T, R, 2], phases [T, R],
    ph_out [R], fr_out [R])."""
    _check_costas(refs, phase0, freq0, cfo_freq)
    ph, fr = phase0, freq0
    derots, phases = [], []
    for v in refs:
        v2 = rc.mul(v, v)
        err = 0.5 * _wrap_pi(rc.angle(v2) - 2 * ph)
        derots.append(rc.mul(v, rc.exp_i(-ph)))
        phases.append(ph)
        fr = torch.clamp(fr + SF.BETA * err, -0.5, 0.5)
        step = ph + fr if cfo_freq is None else ph + fr + cfo_freq
        ph = _wrap_pi(step + SF.ALPHA * err)
    return torch.stack(derots), torch.stack(phases), ph, fr


def costas_track_rc(refs, phase0, freq0, cfo_freq=None):
    """K3: the arguments and results of :func:`costas_track_rc_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one thread per track, the recurrence in registers)."""
    if refs.device.type == "cpu":
        return costas_track_rc_plain(refs, phase0, freq0, cfo_freq)
    _check_costas(refs, phase0, freq0, cfo_freq)
    n_steps, n_tracks, _ = refs.shape
    K.check(refs, "refs", torch.float32)
    K.check(phase0, "phase0", torch.float32)
    K.check(freq0, "freq0", torch.float32)
    if cfo_freq is not None:
        K.check(cfo_freq, "cfo_freq", torch.float32)
    dev = refs.device
    derot = torch.empty_like(refs)
    phases = torch.empty(n_steps, n_tracks, dtype=torch.float32, device=dev)
    ph_out = torch.empty(n_tracks, dtype=torch.float32, device=dev)
    fr_out = torch.empty(n_tracks, dtype=torch.float32, device=dev)
    K.launch("costas_track", refs.data_ptr(), phase0.data_ptr(),
             freq0.data_ptr(),
             None if cfo_freq is None else cfo_freq.data_ptr(),
             derot.data_ptr(), phases.data_ptr(), ph_out.data_ptr(),
             fr_out.data_ptr(), n_steps, n_tracks, SF.ALPHA, SF.BETA,
             TWO_PI, device=dev)
    return derot, phases, ph_out, fr_out


# ---------------------------------------------------------------------------
# sync block (MP1-style geometry, any partitions-per-band)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sync_tables(ppb: int, device: str) -> dict:
    r = ppb + 1
    part = np.arange(ppb)
    kk = np.arange(1, W)
    low_bins = C.LB_START + part[:, None] * W + kk[None, :]
    up_bins = C.UB_END - (part[:, None] + 1) * W + kk[None, :]
    vals, known = SF._needles(ppb)
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
    }
    out = {k: torch.from_numpy(v).to(device) for k, v in tables.items()}
    out["k_rel"] = (out["bins"] - C.FFT_FM // 2).float()
    return out


def _demod(z, mult):
    return torch.round(torch.clamp(z, -1, 1) * mult).to(torch.int8)


def sync_block_rc(spectra, costas_phase, costas_freq, psmi: int, timing_adj,
                  plain: bool = False):
    """spectra: [S, 32, 2048, 2]; costas_phase/costas_freq [S, 2048];
    timing_adj int32 [S].  Returns (out dict of per-station tensors,
    new_phase, new_freq): ``pm`` int8 [S, 23040], ``ref_ok`` [S, R],
    ``ref_bc``/``ref_psmi`` [S, R], ``samperr`` int32 [S], ``angle``,
    ``error_lb``, ``error_ub`` float32 [S]."""
    check_psmi(psmi)
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
    costas = costas_track_rc_plain if plain else costas_track_rc
    derot, phases, ph_out, fr_out = costas(
        refs.contiguous(), phase0.reshape(-1), freq0.reshape(-1))
    derot = derot.reshape(C.BLKSZ, s, r2, 2).transpose(0, 1)  # [S, 32, 2R, 2]
    phases = phases.reshape(C.BLKSZ, s, r2).transpose(0, 1)
    ph_out = ph_out.reshape(s, r2)
    fr_out = fr_out.reshape(s, r2)

    score = (derot[..., 0] * t["sync_signs"][:, None]).sum(dim=1)  # [S, 2R]
    flip = score < 0
    derot = torch.where(flip[:, None, :, None], -derot, derot)
    phases = torch.where(flip[:, None, :], phases + math.pi, phases)
    ph_out = torch.where(flip, ph_out + math.pi, ph_out)

    signs = (derot[..., 0] > 0).to(torch.uint8)  # [S, 32, 2R]
    match = torch.where(t["known"], signs == t["vals"], True)
    ref_ok = match.all(dim=1)
    data = signs ^ torch.cat([torch.zeros_like(signs[:, :1]), signs[:, :-1]],
                             dim=1)
    ref_bc = (data[:, 16:20].int() * t["wbc"][:, None]).sum(1)
    ref_psmi = (data[:, 25:31].int() * t["wps"][:, None]).sum(1)

    # equalization
    smag = derot[..., 0].abs().mean(dim=1)  # [S, 2R]
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

    samperr = _phase_diff(phi_lo[:, 0], phi_hi[:, 0]).sum(dim=-1)
    samperr = samperr / (ppb * 2) * C.FFT_FM / W / TWO_PI
    x = k_rel
    y = fr_out
    slope = (x * y).sum(dim=-1) / (x * x).sum()
    samperr = samperr - slope * C.FFT_FM / TWO_PI * C.ACQUIRE_SYMBOLS
    samperr_i = torch.round(samperr).to(torch.int32)
    angle = fr_out.mean(dim=-1)
    fr_out = fr_out - angle[:, None]

    ideal = torch.sign(data_eq)
    err2 = rc.abs2(ideal - data_eq)  # [S, 32, 2ppb, 18]
    error_lb = err2[:, :, :ppb].sum(dim=(1, 2, 3))
    error_ub = err2[:, :, ppb:].sum(dim=(1, 2, 3))
    sig_block = error_lb.new_tensor(2.0 * C.BLKSZ
                                    * (ppb * C.PARTITION_DATA_CARRIERS))
    mult_lb = torch.clamp(sig_block / error_lb * 10, 1, 127)
    mult_ub = torch.clamp(sig_block / error_ub * 10, 1, 127)

    # per-bin channel-power LLR weighting (the reference's default MMSE
    # weighting, ops/sync_fm.py EQ_MMSE): deep fades become near-erasures
    h2 = 1.0 / torch.clamp(rc.abs2(eq), min=1e-12)  # [S, 32, 2ppb, 18]
    h2_lb, h2_ub = h2[:, :, :ppb], h2[:, :, ppb:]
    w_lb = torch.clamp(h2_lb / h2_lb.mean(dim=(2, 3), keepdim=True),
                       0.0, 1.0)[..., None]
    w_ub = torch.clamp(h2_ub / h2_ub.mean(dim=(2, 3), keepdim=True),
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
    new_phase = costas_phase.clone()
    new_phase[:, bins] = _wrap_pi(ph_out)
    new_freq = costas_freq.clone()
    new_freq[:, bins] = fr_out
    return out, new_phase, new_freq


# ---------------------------------------------------------------------------
# fused chain
# ---------------------------------------------------------------------------

def frontend_scan_rc(samples, carry: ChainCarryRC, n_blocks: int,
                     psmi: int = 1, plain: bool = False):
    """The per-block acquire + sync loop.  samples: [S, N, 2] conjugated
    rc.  Returns (pm int8 [S, n_blocks, 23040], diag dict of
    [S, n_blocks] tensors, new carry)."""
    fftcp = C.FFTCP_FM
    fold = demod_fold_plain if plain else demod_fold
    cy = carry
    pms, samperrs, elbs, eubs = [], [], [], []
    for _ in range(n_blocks):
        samperr = fftcp // 2 + cy.samperr_fb
        angle = cy.prev_angle - cy.angle_fb
        folded, phase, keep = fold(samples, cy.offset, cy.phase, samperr,
                                   angle, cy.cfo)
        spectra = rc.dft(folded, shift=True)
        out, cph, cfr = sync_block_rc(spectra, cy.costas_phase,
                                      cy.costas_freq, psmi,
                                      fftcp // 2 - samperr, plain=plain)
        cy = cy._replace(
            offset=cy.offset + (WINDOW_FM - keep), phase=phase,
            prev_angle=angle, costas_phase=cph, costas_freq=cfr,
            samperr_fb=out["samperr"], angle_fb=out["angle"])
        pms.append(out["pm"])
        samperrs.append(out["samperr"])
        elbs.append(out["error_lb"])
        eubs.append(out["error_ub"])
    diag = {"samperr": torch.stack(samperrs, dim=1),
            "error_lb": torch.stack(elbs, dim=1),
            "error_ub": torch.stack(eubs, dim=1)}
    return torch.stack(pms, dim=1), diag, cy


def fm_chain_batch_rc(samples, carries: ChainCarryRC, n_blocks: int,
                      psmi: int = 1, first_bc: int = 0,
                      packed: bool = False, plain: bool = False):
    """Station batch: samples [S, N, 2] conjugated rc at 744187.5 S/s
    (N >= buffer_len(n_blocks) for a full walk).  The P1 FEC is
    flat-batched over stations × frames, as in the reference.

    Returns (out, new carries) with ``out["pids"]`` uint8 [S, n_blocks, 80],
    ``out["p1"]`` uint8 [S, F, 146176], ``out["p1_margin"]`` [S, F],
    ``out["p1_bit_errors"]`` [S, F] (when a whole frame lies in the
    dispatch) and ``out["diag"]``.  ``packed=True`` packs p1 and pids 8
    bits to a byte (:mod:`nrsc5_tpu_torch.ops.bits`)."""
    check_psmi(psmi)
    pm, diag, carry = frontend_scan_rc(samples, carries, n_blocks, psmi,
                                       plain=plain)
    s = pm.shape[0]
    out = {"diag": diag}
    out["pids"] = pids_decode(pm.reshape(s * n_blocks, -1),
                              plain=plain).reshape(s, n_blocks, -1)

    skip = (C.P1_FM_BLOCKS - first_bc) % C.P1_FM_BLOCKS
    n_frames = (n_blocks - skip) // C.P1_FM_BLOCKS
    if n_frames > 0:
        frames = pm[:, skip: skip + n_frames * C.P1_FM_BLOCKS]
        flat = frames.reshape(s * n_frames, -1)
        p1, margin, errors = p1_decode(flat, plain=plain)
        out["p1"] = p1.reshape(s, n_frames, -1)
        out["p1_margin"] = margin.reshape(s, n_frames)
        out["p1_bit_errors"] = errors.reshape(s, n_frames)
    if packed:
        out = pack_out(out)
    return out, carry


def fm_chain_scan_rc(samples, carry: ChainCarryRC, n_blocks: int,
                     psmi: int = 1, first_bc: int = 0, packed: bool = False,
                     plain: bool = False):
    """One station: samples [N, 2] and a carry without the station axis.
    Same outputs as :func:`fm_chain_batch_rc` without the station axis."""
    out, new = fm_chain_batch_rc(
        samples[None], ChainCarryRC(*(x[None] for x in carry)), n_blocks,
        psmi, first_bc, packed, plain)
    out = {k: ({d: v[0] for d, v in val.items()} if k == "diag" else val[0])
           for k, val in out.items()}
    return out, ChainCarryRC(*(x[0] for x in new))
