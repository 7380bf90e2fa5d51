"""FM fine sync: the tables (Costas gains, reference bins, needles, sync
signs) and the complex sync block of the per-block receivers.

PyTorch counterpart of ``nrsc5_tpu/ops/sync_fm.py``: a numpy copy of its
tables (lines 30-100; pinned equal by tests/test_torch_tables.py), and its
complex functions (``SyncState``, ``sync_init_state``, ``_wrap_pi``,
``_phase_diff``, ``costas_track``, ``sync_fm_block``; lines 50-292) as
plain PyTorch on complex64, which the per-block receivers and their fused
chain (:mod:`nrsc5_tpu_torch.pipeline.scan_chain`) run on the card and on
the CPU alike: the per-reference-subcarrier Costas loops advance in
lockstep over the 32 symbols, then the pi-ambiguity fix, the control-word
decode, the partition equalization, the sample-clock regression, the MER
and the int8 soft demap (reference: src/sync.c:339-609).  On a card the
block runs as kernel K18 (:func:`sync_fm_c`, ``csrc/sync_fm_c.cu``, K4's
kernel with this chain's phase detector), batched over stations;
:func:`sync_fm_c_plain` loops :func:`sync_fm_block` over the stations.
The rc chain's sync block is kernel K4
(:mod:`nrsc5_tpu_torch.pipeline.scan_chain_rc`).
The reference's ``NRSC5_EQ_MMSE`` switch is not read: the port always
applies its default, the per-bin channel-power LLR weighting.
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
from nrsc5_tpu_torch.ops.acquire_rc import WINDOW_FM

# Costas loop constants (reference: src/sync.c:832-841)
_LOOP_BW = 0.05
_DAMPING = 0.70710678
_DENOM = 1 + 2 * _DAMPING * _LOOP_BW + _LOOP_BW * _LOOP_BW
ALPHA = 4 * _DAMPING * _LOOP_BW / _DENOM
BETA = 4 * _LOOP_BW * _LOOP_BW / _DENOM

W = C.PARTITION_WIDTH_FM


@functools.lru_cache(maxsize=8)
def _ref_bins(ppb: int) -> np.ndarray:
    """All reference-subcarrier bins: lower refs 0..ppb then upper refs
    0..ppb (int32 [2*(ppb+1)])."""
    i = np.arange(ppb + 1)
    return np.concatenate([C.LB_START + i * W, C.UB_END - i * W]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _needles(ppb: int):
    """Per-ref expected sign sequences with rsid filled in.

    Returns (values uint8 [R, 32], known bool [R, 32]).
    """
    base = np.array(C.REF_SIGNS_FIXED, dtype=np.int64)
    r = ppb + 1
    vals = np.zeros((2 * r, C.BLKSZ), np.uint8)
    known = np.zeros((2 * r, C.BLKSZ), bool)
    for i in range(r):
        s = base.copy()
        rsid = (C.MIDDLE_REF_SC - i) & 0x3
        s[10] = rsid >> 1
        s[11] = (rsid >> 1) ^ (rsid & 1)
        k = s >= 0
        for row in (i, r + i):
            vals[row] = np.where(k, s, 0).astype(np.uint8)
            known[row] = k
    return vals, known


def _bit_masks(bits: np.ndarray) -> np.ndarray:
    """[R, 32] 0/1 rows -> int32 [R] words, bit n = column n."""
    w = (np.asarray(bits, np.uint64) << np.arange(C.BLKSZ, dtype=np.uint64))
    return w.sum(axis=1).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=8)
def needle_masks(ppb: int):
    """The needles of :func:`_needles` as bit masks, as the kernels read
    them: (values int32 [R], known int32 [R]), bit k = symbol k."""
    vals, known = _needles(ppb)
    return _bit_masks(vals), _bit_masks(known)


@functools.lru_cache(maxsize=1)
def _sync_signs() -> np.ndarray:
    """+-1 expected signs with 0 at variable positions (pi-ambiguity check;
    reference: src/sync.c:96-99)."""
    s = np.array(C.REF_SIGNS_FIXED, dtype=np.float32)
    return np.where(s < 0, 0.0, s * 2 - 1).astype(np.float32)


# ---------------------------------------------------------------------------
# the complex sync block (reference: src/sync.c:339-609)
# ---------------------------------------------------------------------------

class SyncState(NamedTuple):
    costas_phase: torch.Tensor  # [FFT_FM] float32
    costas_freq: torch.Tensor  # [FFT_FM] float32


def sync_init_state(*, device="cuda") -> SyncState:
    dev = K.resolve_device(device)
    return SyncState(
        costas_phase=torch.zeros(C.FFT_FM, dtype=torch.float32, device=dev),
        costas_freq=torch.zeros(C.FFT_FM, dtype=torch.float32, device=dev))


def _wrap_pi(x):
    return x - 2 * math.pi * torch.round(rc.fdiv(x, 2 * math.pi))


def _phase_diff(a, b):
    """Wrap a-b into (-pi/2, pi/2] (reference: src/sync.c:284-290)."""
    d = a - b
    return d - math.pi * torch.round(rc.fdiv(d, math.pi))


def costas_track(refs, phase0, freq0, cfo_freq=None):
    """Run the Costas loops over one block: refs [32, R] complex64,
    phase0/freq0 [R] float32, the optional static per-loop frequency
    ``cfo_freq`` [R].  Returns (derot [32, R], phases [32, R], phase_out
    [R], freq_out [R])."""
    ph, fr = phase0, freq0
    derots, phases = [], []
    for v in refs:
        err = 0.5 * torch.angle(v * v * torch.exp(-2j * ph))
        derots.append(v * torch.exp(-1j * ph))
        phases.append(ph)
        fr = torch.clamp(fr + BETA * err, -0.5, 0.5)
        step = ph + fr if cfo_freq is None else ph + fr + cfo_freq
        ph = _wrap_pi(step + ALPHA * err)
    return torch.stack(derots), torch.stack(phases), ph, fr


@functools.lru_cache(maxsize=32)
def _block_tables(ppb: int, device: str) -> dict:
    r = ppb + 1
    part = np.arange(ppb)
    kk = np.arange(1, W)
    low_bins = C.LB_START + part[:, None] * W + kk[None, :]
    up_bins = C.UB_END - (part[:, None] + 1) * W + kk[None, :]
    vals, known = _needles(ppb)
    tables = {
        "bins": _ref_bins(ppb).astype(np.int64),
        "sync_signs": _sync_signs(),
        "vals": np.ascontiguousarray(vals.T),  # [32, 2R]
        "known": np.ascontiguousarray(known.T),
        "lo_idx": np.concatenate([np.arange(ppb), r + np.arange(ppb) + 1]),
        "hi_idx": np.concatenate([np.arange(ppb) + 1, r + np.arange(ppb)]),
        "data_bins": np.concatenate([low_bins, up_bins]).astype(np.int64),
        "k": np.arange(1, W, dtype=np.float32),
        "w_bc": np.array([8, 4, 2, 1], np.int32),
        "w_ps": np.array([32, 16, 8, 4, 2, 1], np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in tables.items()}


def _demod(z, mult):
    """int8 soft bits of z [..., n] at per-value scale ``mult``:
    [..., n, 2] (I, Q)."""
    i8 = torch.round(torch.clamp(z.real, -1, 1) * mult)
    q8 = torch.round(torch.clamp(z.imag, -1, 1) * mult)
    return torch.stack([i8, q8], dim=-1).to(torch.int8)


def sync_fm_block(spectra, state: SyncState, psmi: int, timing_adj):
    """Process one L1 block of 32 symbol spectra.

    spectra: [32, 2048] complex64 (fftshifted).  timing_adj: the int32
    sample adjustment from acquire (fftcp/2 - samperr), applied to the
    carried Costas phases first (reference: src/sync.c:769-777).  psmi:
    the service mode (the partition geometry).

    Returns a dict of tensors (pm [23040] int8, ref_ok, ref_bc, ref_psmi,
    samperr, angle, error_lb, error_ub, and px1/px2 in the extended modes)
    and the new SyncState."""
    ppb = C.partitions_per_band(psmi)
    cm = C.COMPATIBILITY_MODE[psmi]
    dev = spectra.device
    t = _block_tables(ppb, str(dev))
    bins = t["bins"]
    timing_adj = torch.as_tensor(timing_adj, device=dev)

    # sync_adjust: a timing shift rotates each subcarrier's phase
    k_rel = (bins - C.FFT_FM // 2).float()
    adj_phase = timing_adj.float() * k_rel * (2 * math.pi / C.FFT_FM)
    phase0 = state.costas_phase[bins] - adj_phase
    freq0 = state.costas_freq[bins]

    refs = spectra[:, bins]  # [32, 2R]
    derot, phases, ph_out, fr_out = costas_track(refs, phase0, freq0)

    # pi-ambiguity fix against the fixed sync signs
    score = (derot.real * t["sync_signs"][:, None]).sum(0)  # [2R]
    flip = score < 0
    derot = torch.where(flip[None, :], -derot, derot)
    phases = torch.where(flip[None, :], phases + math.pi, phases)
    ph_out = torch.where(flip, ph_out + math.pi, ph_out)

    # --- COARSE: per-ref control-word decode (reference: src/sync.c:169-186)
    signs = (derot.real > 0).to(torch.uint8)  # [32, 2R]
    match = torch.where(t["known"], signs == t["vals"], True)
    ref_ok = match.all(dim=0)  # [2R]
    data = signs ^ torch.cat([torch.zeros_like(signs[:1]), signs[:-1]])
    ref_bc = (data[16:20].to(torch.int32) * t["w_bc"][:, None]).sum(0)
    ref_psmi = (data[25:31].to(torch.int32) * t["w_ps"][:, None]).sum(0)

    # --- FINE: equalization ------------------------------------------------
    smag = derot.real.abs().mean(dim=0)  # [2R]
    lo_idx, hi_idx = t["lo_idx"], t["hi_idx"]
    phi_lo, phi_hi = phases[:, lo_idx], phases[:, hi_idx]  # [32, 2*ppb]
    smag_lo, smag_hi = smag[lo_idx], smag[hi_idx]
    k = t["k"]  # [18]
    denom = (k[None, None, :] * (smag_hi[None, :, None]
             * torch.exp(1j * phi_hi)[:, :, None])
             + (W - k)[None, None, :] * (smag_lo[None, :, None]
             * torch.exp(1j * phi_lo)[:, :, None]))
    eq = (W + W * 1j) / denom  # [32, 2*ppb, 18]
    data_eq = spectra[:, t["data_bins"]] * eq  # [32, 2*ppb, 18]

    # --- sample-clock error + angle (reference: src/sync.c:426-463) -------
    samperr = _phase_diff(phi_lo[0], phi_hi[0]).sum()
    samperr = samperr / (ppb * 2) * C.FFT_FM / W / (2 * math.pi)
    slope = (k_rel * fr_out).sum() / (k_rel * k_rel).sum()
    samperr = samperr - slope * C.FFT_FM / (2 * math.pi) * C.ACQUIRE_SYMBOLS
    samperr_i = torch.round(samperr).to(torch.int32)
    angle = fr_out.mean()
    fr_out = fr_out - angle

    # --- MER + soft demap (reference: src/sync.c:465-607) -----------------
    ideal = torch.complex(torch.sign(data_eq.real), torch.sign(data_eq.imag))
    err2 = (ideal - data_eq).abs() ** 2  # [32, 2*ppb, 18]
    error_lb = err2[:, :ppb].sum()
    error_ub = err2[:, ppb:].sum()
    sig_block = 2.0 * C.BLKSZ * (ppb * C.PARTITION_DATA_CARRIERS)
    mult_lb = torch.clamp(sig_block / error_lb * 10, 1, 127)
    mult_ub = torch.clamp(sig_block / error_ub * 10, 1, 127)

    # the per-bin channel-power LLR weighting (the reference's EQ_MMSE,
    # on by default): weight each bin's soft output by its channel power,
    # normalized per sideband and capped at 1
    h2 = 1.0 / torch.clamp(eq.abs() ** 2, min=1e-12)
    w_lb = torch.clamp(h2[:, :ppb] / h2[:, :ppb].mean(dim=(1, 2),
                                                      keepdim=True), 0, 1)
    w_ub = torch.clamp(h2[:, ppb:] / h2[:, ppb:].mean(dim=(1, 2),
                                                      keepdim=True), 0, 1)
    mlb = mult_lb * w_lb
    mub = mult_ub * w_ub

    pm = C.PM_PARTITIONS
    # PM: lower partitions 0..9 with mult_lb; upper partitions m = 9..0
    pm_low = _demod(data_eq[:, :pm], mlb[:, :pm])  # [32, 10, 18, 2]
    up = data_eq[:, ppb:ppb + pm]  # m = 0..9
    pm_up = _demod(up.flip(1), mub[:, :pm].flip(1))
    pm_block = torch.cat([pm_low, pm_up], dim=1).reshape(C.BLKSZ, -1)

    out = {
        "pm": pm_block.reshape(-1),  # [23040] int8
        "ref_ok": ref_ok, "ref_bc": ref_bc, "ref_psmi": ref_psmi,
        "samperr": samperr_i, "angle": angle,
        "error_lb": error_lb, "error_ub": error_ub,
    }
    if cm == 2:
        px1 = torch.cat([
            _demod(data_eq[:, 10:11], mlb[:, 10:11]),
            _demod(data_eq[:, ppb + 10:ppb + 11], mub[:, 10:11])], dim=1)
        out["px1"] = px1.reshape(-1)  # [2304]
    elif cm in (3, 11):
        px1 = torch.cat([
            _demod(data_eq[:, 10:12], mlb[:, 10:12]),
            _demod(data_eq[:, ppb + 11:ppb + 12], mub[:, 11:12]),
            _demod(data_eq[:, ppb + 10:ppb + 11], mub[:, 10:11])], dim=1)
        out["px1"] = px1.reshape(-1)  # [4608]
    if cm == 11:
        # the reference applies mult_lb to both px2 sidebands
        # (src/sync.c:574-595)
        px2 = torch.cat([
            _demod(data_eq[:, 12:14], mlb[:, 12:14]),
            _demod(data_eq[:, ppb + 13:ppb + 14], mult_lb * w_ub[:, 13:14]),
            _demod(data_eq[:, ppb + 12:ppb + 13], mult_lb * w_ub[:, 12:13])],
            dim=1)
        out["px2"] = px2.reshape(-1)

    new_phase = state.costas_phase.clone()
    new_phase[bins] = _wrap_pi(ph_out)
    new_freq = state.costas_freq.clone()
    new_freq[bins] = fr_out
    return out, SyncState(costas_phase=new_phase, costas_freq=new_freq)


# ---------------------------------------------------------------------------
# K4 and K18: the FM sync block's kernel, its tables, checks and launcher
# ---------------------------------------------------------------------------

# the per-station scalars the FM carry step (K5, and K4 and K18 in the block
# loop) reads and writes
FM_STATE = ("offset", "prev_angle", "samperr_fb", "angle_fb", "samperr",
            "angle", "timing_adj")


def check_psmi(psmi: int) -> None:
    """A service-mode index the chain decodes: any entry of the
    compatibility-mode table."""
    if not 0 <= psmi < len(C.COMPATIBILITY_MODE):
        raise ValueError(f"psmi {psmi} is not a service mode index")


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
def sync_tables(ppb: int, device: str) -> dict:
    """The tables of K4, K18 and K4's plain version for ``ppb`` partitions
    a band on ``device``, cached."""
    r = ppb + 1
    part = np.arange(ppb)
    kk = np.arange(1, W)
    low_bins = C.LB_START + part[:, None] * W + kk[None, :]
    up_bins = C.UB_END - (part[:, None] + 1) * W + kk[None, :]
    vals, known = _needles(ppb)
    vals_mask, known_mask = needle_masks(ppb)
    tables = {
        "bins": _ref_bins(ppb).astype(np.int64),
        "sync_signs": _sync_signs(),
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


def check_sync(spectra, costas_phase, costas_freq, timing_adj):
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


def check_carry(carry: dict, s: int, timing_adj) -> None:
    """The block loop's carry step handed to K4 or K18: every name of
    :data:`FM_STATE` and ``keep``, each an [S] tensor, its ``timing_adj``
    not the one the kernel reads."""
    for name in FM_STATE + ("keep",):
        t = carry[name]
        if tuple(t.shape) != (s,):
            raise ValueError(f"carry {name}: expected shape {(s,)}, got "
                             f"{tuple(t.shape)}")
    if carry["timing_adj"] is timing_adj:
        raise ValueError("carry timing_adj: the next block's, not the one "
                         "K4 reads (ping-pong them)")


def block_carry_plain(keep, k4_samperr, k4_angle, state: dict,
                      first: bool) -> None:
    """Plain version of :func:`~nrsc5_tpu_torch.pipeline.block_graph.
    block_carry`: the same step in torch, in place on ``state``'s
    tensors."""
    if not first:
        state["offset"].add_(WINDOW_FM - keep)
        state["prev_angle"].copy_(state["angle"])
        state["samperr_fb"].copy_(k4_samperr)
        state["angle_fb"].copy_(k4_angle)
    state["samperr"].copy_(C.FFTCP_FM // 2 + state["samperr_fb"])
    state["angle"].copy_(state["prev_angle"] - state["angle_fb"])
    state["timing_adj"].copy_(C.FFTCP_FM // 2 - state["samperr"])


def launch_sync_block(kernel: str, spectra, costas_phase, costas_freq,
                      psmi: int, timing_adj, carry: dict | None, out):
    """Launch K4 (``kernel`` "sync_block") or K18 ("sync_fm_c", the same
    kernel with the complex chain's phase detector) on CUDA tensors:
    spectra [S, 32, 2048, 2] float32 (K18's complex64 spectra through
    ``torch.view_as_real``), the rest as :func:`~nrsc5_tpu_torch.pipeline.
    scan_chain_rc.sync_block_rc` takes them."""
    check_psmi(psmi)
    check_sync(spectra, costas_phase, costas_freq, timing_adj)
    K.check(spectra, "spectra", torch.float32)
    K.check(costas_phase, "costas_phase", torch.float32)
    K.check(costas_freq, "costas_freq", torch.float32)
    K.check(timing_adj, "timing_adj", torch.int32)
    ppb = C.partitions_per_band(psmi)
    dev = spectra.device
    t = sync_tables(ppb, str(dev))
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
        check_carry(carry, s, timing_adj)
        for name in ("keep",) + FM_STATE:
            K.check(carry[name], name, torch.float32 if "angle" in name
                    else torch.int32, (s,))
        step = tuple(carry[name].data_ptr() for name in ("keep",) + FM_STATE)
    px1, px2 = px_columns(psmi)
    K.launch(kernel, spectra.data_ptr(), costas_phase.data_ptr(),
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
             ALPHA, BETA, 2 * math.pi, math.pi, 2 * math.pi / C.FFT_FM,
             *step, WINDOW_FM, C.FFTCP_FM // 2, device=dev)
    return out, new_phase, new_freq


# ---------------------------------------------------------------------------
# K18: the sync block batched over stations
# ---------------------------------------------------------------------------

def sync_fm_c_plain(spectra, costas_phase, costas_freq, psmi: int,
                    timing_adj, carry: dict | None = None):
    """Plain version of K18: :func:`sync_fm_block` for each station.
    spectra [S, 32, 2048] complex64; costas_phase/costas_freq [S, 2048];
    timing_adj int32 [S].  ``carry`` (the block loop's, else None): the
    carry step after this block, in place, as K18 takes it
    (:func:`block_carry_plain`).
    Returns (out dict of per-station tensors with the keys, shapes and
    dtypes of :func:`sync_block_shapes`, new_phase, new_freq)."""
    rows, phases, freqs = [], [], []
    for i in range(spectra.shape[0]):
        out, st = sync_fm_block(spectra[i], SyncState(costas_phase[i],
                                                      costas_freq[i]),
                                psmi, timing_adj[i])
        rows.append(out)
        phases.append(st.costas_phase)
        freqs.append(st.costas_freq)
    shapes = sync_block_shapes(spectra.shape[0], psmi)
    out = {k: torch.stack([r[k] for r in rows]).to(dtype)
           for k, (_, dtype) in shapes.items()}
    if carry is not None:
        block_carry_plain(carry["keep"], out["samperr"], out["angle"], carry,
                          False)
    return out, torch.stack(phases), torch.stack(freqs)


def sync_fm_c(spectra, costas_phase, costas_freq, psmi: int, timing_adj,
              carry: dict | None = None, out=None):
    """K18: the arguments and results of :func:`sync_fm_c_plain`, written
    into ``out`` = (out dict, new_phase, new_freq) where it is given.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (K4's cluster of 8 CTAs a station with the complex chain's
    phase detector; with ``carry``, CTA 0 then takes the block loop's
    carry step: the names of :data:`FM_STATE` and K17's ``keep``)."""
    if spectra.device.type == "cpu":
        res = sync_fm_c_plain(spectra, costas_phase, costas_freq, psmi,
                              timing_adj, carry)
        return res if out is None else K.into(out, res)
    K.check(spectra, "spectra", torch.complex64)
    return launch_sync_block("sync_fm_c", torch.view_as_real(spectra),
                             costas_phase, costas_freq, psmi, timing_adj,
                             carry, out)


def sync_fm_step(spectra, state: SyncState, psmi: int, timing_adj):
    """One station's block as :func:`sync_fm_block` takes and returns it
    (the per-block receivers' call): the plain version on a CPU tensor,
    K18 at one station on a CUDA tensor."""
    if spectra.device.type == "cpu":
        return sync_fm_block(spectra, state, psmi, timing_adj)
    tadj = torch.as_tensor(timing_adj, dtype=torch.int32,
                           device=spectra.device).reshape(1)
    out, phase, freq = sync_fm_c(spectra[None], state.costas_phase[None],
                                 state.costas_freq[None], psmi, tadj)
    return ({k: v[0] for k, v in out.items()},
            SyncState(costas_phase=phase[0], costas_freq=freq[0]))
