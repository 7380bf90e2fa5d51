"""Coarse acquisition + OFDM demodulation of one L1 block, on complex64.

PyTorch counterpart of ``nrsc5_tpu/ops/acquire.py`` (all of it), the
acquire step the per-block receivers run (reference: src/acquire.c:98-263).
Per call it consumes a fixed window of 33 OFDM symbols' samples and gives
the 32 fftshifted symbol spectra of one L1 block:

  * COARSE: the cyclic-prefix autocorrelation over every candidate timing
    of the window, a shaped window sum and an argmax (FM behind the
    reference's band filter, AM behind a coherent subtraction of the
    carrier tone);
  * FINE: timing and angle come from the sync stage's previous-block
    estimates;
  * the derotation ramp in closed form, its integer-CFO part in exact
    modular int32 arithmetic;
  * the cyclic-prefix fold and a batched FFT over the 32 symbols.

The demodulation after the timing (the ramp, the fold, the FFT and the
fftshift; AM's two passes with the pilot regression between them) runs
as kernel K17 (:func:`demod_fm_c`, ``csrc/fm_demod_c.cu``) and K19
(:func:`demod_am_c`, ``csrc/am_demod_c.cu``) on a card, batched over
stations, each reading its window straight from the station's sample
buffer, with an FFT of its own (no cuFFT); their plain versions
(:func:`demod_fm_c_plain`, :func:`demod_am_c_plain`) loop over the
stations through ``_demod`` and ``_am_process``, whose FFT is
``torch.fft.fft`` (pocketfft on the CPU).  The coarse timing stays plain
PyTorch on either device (ROADMAP queue 2, K22-K23).

The reference chooses COARSE or FINE with ``lax.cond`` on a device bool;
its receivers pass ``fine`` from the host, and here it is a host bool.
Everything else stays on the window's device as 0-d tensors.  The variable
sample consumption ``keep`` is returned; the host ring advances by
``WINDOW - keep`` (reference: src/acquire.c:259-262).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops.acquire_am_rc import TONE_GRID
from nrsc5_tpu_torch.ops.acquire_rc import (WINDOW_AM, WINDOW_FM,
                                            _cp_window_idx, _shape_kernel,
                                            dynamic_start)

NSYM = C.ACQUIRE_SYMBOLS


class AcquireState(NamedTuple):
    """Carried acquisition state (0-d tensors)."""
    phase: torch.Tensor  # complex64 sample-clock phasor
    prev_angle: torch.Tensor  # float32 smoothed per-FFT angle estimate


def acquire_init_state(*, device="cuda") -> AcquireState:
    dev = K.resolve_device(device)
    return AcquireState(
        phase=torch.ones((), dtype=torch.complex64, device=dev),
        prev_angle=torch.zeros((), dtype=torch.float32, device=dev))


@functools.lru_cache(maxsize=16)
def _tables(device: str) -> dict:
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {
        "shape_fm": t(C.ofdm_shape(C.FFT_FM, C.CP_FM)),
        "shape_am": t(C.ofdm_shape(C.FFT_AM, C.CP_AM)),
        "kern_fm": t(_shape_kernel(C.FFT_FM, C.CP_FM)),
        "kern_am": t(_shape_kernel(C.FFT_AM, C.CP_AM)),
        "widx_fm": t(_cp_window_idx(C.FFTCP_FM, C.CP_FM).astype(np.int64)),
        "widx_am": t(_cp_window_idx(C.FFTCP_AM, C.CP_AM).astype(np.int64)),
        # the band filter's taps reversed: offset o <-> delay 32 - o
        "acq_taps": t(np.asarray(C.ACQ_TAPS_FM, np.float32)[::-1].copy()),
        "grid": t(TONE_GRID),
    }


def _scalar(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _am_tone_subtract(buf: torch.Tensor) -> torch.Tensor:
    """Estimate and coherently subtract the dominant tone (the AM carrier)
    of the window, as the reference does ahead of the AM coarse timing:
    the integer bin from the symbols' summed DFT power, a grid of 85
    sub-bin projections refined parabolically, two Newton steps on
    |S(f)|² about the centred index, then the least-squares amplitude."""
    fftcp, fft = C.FFTCP_AM, C.FFT_AM
    n = buf.shape[0]
    dev = buf.device
    tb = _tables(str(dev))

    sym = buf[:fftcp * NSYM].reshape(NSYM, fftcp)[:, :fft]
    power = (torch.fft.fft(sym, dim=1).abs() ** 2).sum(0)
    k0 = torch.argmax(power).to(torch.int32)
    k0 = torch.where(k0 >= fft // 2, k0 - fft, k0)

    nint = torch.arange(n, dtype=torch.int32, device=dev)
    nf = nint.float()
    ph_int = ((k0 * nint) % fft).float()
    z = buf * torch.exp(-2j * math.pi / fft * ph_int)
    u = tb["grid"]
    basis = torch.exp(-2j * math.pi / fft * (u[:, None] * nf[None, :]))
    p = (basis @ z).abs() ** 2
    i = torch.argmax(p).clamp(1, 83)
    den = p[i - 1] - 2 * p[i] + p[i + 1]
    d = torch.where(den != 0, 0.5 * (p[i - 1] - p[i + 1]) / den,
                    torch.zeros_like(den))
    ustar = u[i] + d.clamp(-1.0, 1.0) * (u[1] - u[0])
    f = (k0.float() + ustar) / fft  # cycles/sample

    m = nf - (n - 1) / 2.0
    w = -2 * math.pi * m
    for _ in range(2):  # the reference's two-step Newton scan
        e = torch.exp(-2j * math.pi * f * m)
        xe = buf * e
        s = xe.sum()
        ds = 1j * (xe * w).sum()
        d2s = -((w ** 2) * xe).sum()
        g = 2 * (s.conj() * ds).real
        h = 2 * ds.abs() ** 2 + 2 * (s.conj() * d2s).real
        f = torch.where(h < 0, f - g / h, f)
    e = torch.exp(-2j * math.pi * f * m)
    amp = (buf * e).sum() / n
    return buf - amp * e.conj()


def _coarse_timing(buf: torch.Tensor, am: bool = False):
    """Cyclic-prefix correlation over the 33-symbol window.  buf: [WINDOW]
    complex64 (conjugated for FM).  Returns (samperr int32, max_v
    complex64), 0-d.  FM filters with the reference's band filter (group
    delay 16, zero-padded at the window's start); AM subtracts the carrier
    tone instead (the reference's band filter would null MA3's band)."""
    fftcp = C.FFTCP_AM if am else C.FFTCP_FM
    fft = C.FFT_AM if am else C.FFT_FM
    window = WINDOW_AM if am else WINDOW_FM
    tb = _tables(str(buf.device))
    if am:
        f = _am_tone_subtract(buf)
        delay = 0
    else:
        # y[n] = sum_j taps[j] * x[n-1-j]
        x = torch.cat([buf.new_zeros(32), buf])
        f = (x.unfold(0, 32, 1)[:window] * tb["acq_taps"]).sum(-1)
        delay = C.ACQ_FILTER_DELAY
    a = f[:fftcp * NSYM].reshape(NSYM, fftcp)
    b = f[fft:fft + fftcp * NSYM].reshape(NSYM, fftcp)
    sums = (a * b.conj()).sum(0)  # [fftcp]
    key = "am" if am else "fm"
    v = (sums[tb[f"widx_{key}"]] * tb[f"kern_{key}"]).sum(-1)  # [fftcp]
    i_max = torch.argmax(v.abs() ** 2).to(torch.int32)
    samperr = (i_max + fftcp - delay) % fftcp
    return samperr, v[i_max]


def window_at(samples: torch.Tensor, offset: torch.Tensor, n: int):
    """``samples[offset:offset + n]`` as ``lax.dynamic_slice`` cuts it (the
    start clamped into the buffer), by a gather: no host read-back."""
    start = dynamic_start(offset.long(), samples.shape[0], n)
    return samples[start + torch.arange(n, device=samples.device)]


@functools.lru_cache(maxsize=8)
def twiddles(n: int, device: str) -> torch.Tensor:
    """The n/2 twiddles e^{-2 pi i k / n} of K17's and K19's FFT
    (``csrc/fft_c.cuh``), computed in float64 and rounded to complex64."""
    w = np.exp(-2j * np.pi * np.arange(n // 2) / n).astype(np.complex64)
    return torch.from_numpy(w).to(device)


def _symbols(buf: torch.Tensor, samperr: torch.Tensor, fftcp: int):
    """The 32 symbols [32, fftcp] from ``samperr`` on, as
    ``lax.dynamic_slice`` cuts them (the start clamped into the window;
    a gather, so no value is read back to the host)."""
    start = dynamic_start(samperr.long(), buf.shape[0], NSYM * fftcp)
    idx = start + torch.arange(NSYM * fftcp, device=buf.device)
    return buf[idx].reshape(NSYM, fftcp)


def _fold_fft(x: torch.Tensor, shape: torch.Tensor, fft: int, cp: int,
              roll: int = 0) -> torch.Tensor:
    """Shaped cyclic-prefix fold of the symbols x [32, FFTCP], then the
    fftshifted FFT of each: [32, FFT] complex64."""
    head = shape[:cp] * x[:, :cp] + shape[fft:] * x[:, fft:]
    folded = torch.cat([head, x[:, cp:fft]], dim=1)
    if roll:
        folded = torch.roll(folded, roll, dims=-1)
    return torch.fft.fftshift(torch.fft.fft(folded, dim=-1), dim=-1)


def _demod(buf, state: AcquireState, samperr, angle, cfo):
    """The FM acquire step's demodulation tail: derotation ramp, CP fold
    and windowing, batched FFT (reference: src/acquire.c:237-262).
    Returns (spectra, new_state, samperr, angle, keep)."""
    fftcp, fft, cp = C.FFTCP_FM, C.FFT_FM, C.CP_FM
    dev = buf.device
    n = torch.arange(NSYM * fftcp, dtype=torch.int32, device=dev)
    frac = torch.exp(1j * (angle / fft) * n.float())
    cfo_mod = ((cfo * n) % fft).float()
    intc = torch.exp(-2j * math.pi / fft * cfo_mod)
    half = (fftcp // 2 - samperr).to(torch.int32)
    phase0 = state.phase * torch.exp(-1j * half.float() * angle / fft) \
        * torch.exp(2j * math.pi / fft * ((cfo * half) % fft).float())
    phase0 = phase0 / phase0.abs()
    ramp = (phase0 * frac * intc).reshape(NSYM, fftcp)

    spectra = _fold_fft(_symbols(buf, samperr, fftcp) * ramp,
                        _tables(str(dev))["shape_fm"], fft, cp)

    total = NSYM * fftcp
    phase_out = phase0 * torch.exp(1j * (angle / fft) * total) \
        * torch.exp(-2j * math.pi / fft * ((cfo * total) % fft).float())
    phase_out = phase_out / phase_out.abs()
    keep = (fftcp + half).to(torch.int32)
    return (spectra, AcquireState(phase=phase_out, prev_angle=angle),
            samperr, angle, keep)


def _smoothed_angle(prev_angle, max_v):
    angle_diff = torch.angle(max_v * torch.exp(-1j * prev_angle))
    factor = torch.where(prev_angle != 0, 0.25, 1.0)
    return (prev_angle + angle_diff * factor).float()


def acquire_fm(window, state: AcquireState, fine: bool, sync_samperr,
               sync_angle, cfo):
    """One acquire step.

    window: [WINDOW_FM] complex64 raw samples (unconjugated); fine: the
    sync is FINE (use the sync feedback instead of the CP correlation);
    sync_samperr/sync_angle: the previous sync block's feedback; cfo: the
    accumulated integer CFO in bins.  Returns (spectra [32, 2048]
    complex64 fftshifted, new_state, samperr int32, angle float32, keep
    int32).  On a card the demodulation is K17 at one station."""
    fftcp = C.FFTCP_FM
    dev = window.device
    sync_samperr = _scalar(sync_samperr, torch.int32, dev)
    sync_angle = _scalar(sync_angle, torch.float32, dev)
    cfo = _scalar(cfo, torch.int32, dev)
    buf = window.conj()  # FM ingest conjugates (src/acquire.c:126,161)
    if fine:
        samperr = (fftcp // 2 + sync_samperr).to(torch.int32)
        angle = state.prev_angle - sync_angle
    else:
        samperr, max_v = _coarse_timing(buf)
        angle = _smoothed_angle(state.prev_angle, max_v)
    if dev.type == "cpu":
        return _demod(buf, state, samperr, angle, cfo)
    # K17 at one station, the window its whole buffer
    spectra, phase_out, keep = demod_fm_c(
        window[None], torch.zeros(1, dtype=torch.int32, device=dev),
        state.phase.reshape(1), samperr.reshape(1), angle.reshape(1),
        cfo.reshape(1))
    return (spectra[0], AcquireState(phase=phase_out[0], prev_angle=angle),
            samperr, angle, keep[0])


# ---------------------------------------------------------------------------
# AM (reference: src/acquire.c:98-263, mode AM): 256-point FFT, CP 14, no
# ingest conjugation, the CP fold at offset (FFT-CP)/2 of the FFT input,
# and a pilot-phase linear regression that refines phase and frequency
# before the final demodulation pass.
# ---------------------------------------------------------------------------

def _am_fold_fft(buf, samperr, phase0, angle):
    """Fold, window and FFT all 32 AM symbols under a closed-form phase
    ramp.  Returns (spectra [32, 256] fftshifted, carry-out phase)."""
    fftcp, fft, cp = C.FFTCP_AM, C.FFT_AM, C.CP_AM
    n = torch.arange(NSYM * fftcp, dtype=torch.float32, device=buf.device)
    ramp = (phase0 * torch.exp(1j * (angle / fft) * n)).reshape(NSYM, fftcp)
    spectra = _fold_fft(_symbols(buf, samperr, fftcp) * ramp,
                        _tables(str(buf.device))["shape_am"], fft, cp,
                        roll=(fft - cp) // 2)
    phase_out = phase0 * torch.exp(1j * (angle / fft) * (NSYM * fftcp))
    return spectra, phase_out / phase_out.abs()


def acquire_am(window, state: AcquireState, fine: bool, sync_samperr,
               cfo_bins, coarse_override):
    """One AM acquire step over 33 symbols' samples.

    The pilot at CENTER_AM gives the fine CFO by a linear regression of its
    unwrapped phase over the block; the coarse integer CFO ``cfo_bins`` is
    folded into the angle as whole rotations per FFT.  ``coarse_override``
    (>= 0, not FINE): demodulate at that symbol timing instead of the
    block's own CP-correlation argmax (the host's timing consensus); the
    block's own measurement is still returned.

    Returns (spectra [32, 256], new_state, samperr, keep int32, mag_sums
    [256] for the coarse CFO search, coarse_meas int32: this block's raw
    timing measurement, -1 in FINE).  On a card the two demodulation
    passes are K19 at one station."""
    fftcp = C.FFTCP_AM
    dev = window.device
    sync_samperr = _scalar(sync_samperr, torch.int32, dev)
    cfo_bins = _scalar(cfo_bins, torch.int32, dev)
    coarse_override = _scalar(coarse_override, torch.int32, dev)
    if fine:
        # AM sync reports only samperr; prev_angle carries over unchanged
        samperr = (fftcp // 2 + sync_samperr).to(torch.int32)
        prev_angle = state.prev_angle
        meas = torch.full((), -1, dtype=torch.int32, device=dev)
    else:
        meas, max_v = _coarse_timing(window, am=True)
        samperr = torch.where(coarse_override >= 0,
                              coarse_override % fftcp, meas)
        prev_angle = _smoothed_angle(state.prev_angle, max_v)
    if dev.type == "cpu":
        return _am_process(window, state, samperr, prev_angle, cfo_bins) \
            + (meas,)
    # K19 at one station, the window its whole buffer
    spectra, mag_sums, phase_out, angle_out, keep = demod_am_c(
        window[None], torch.zeros(1, dtype=torch.int32, device=dev),
        state.phase.reshape(1), samperr.reshape(1), prev_angle.reshape(1),
        cfo_bins.reshape(1))
    return (spectra[0], AcquireState(phase=phase_out[0],
                                     prev_angle=angle_out[0]),
            samperr, keep[0], mag_sums[0], meas)


def _am_process(window, state, samperr, prev_angle, cfo_bins):
    fftcp, fft = C.FFTCP_AM, C.FFT_AM
    dev = window.device
    angle = prev_angle - 2 * math.pi * cfo_bins.float()
    phase0 = state.phase * torch.exp(
        -1j * (fftcp // 2 - samperr).float() * angle / fft)
    phase0 = phase0 / phase0.abs()

    # pass 1: the pilot-phase regression
    spectra1, _ = _am_fold_fft(window, samperr, phase0, angle)
    pilot = spectra1[:, C.CENTER_AM]  # [32]
    dphi = torch.angle(pilot[1:] * pilot[:-1].conj())
    y = torch.angle(pilot[0]) + torch.cat(
        [torch.zeros(1, device=dev), torch.cumsum(dphi, 0)])
    x = fftcp * (torch.arange(NSYM, dtype=torch.float32, device=dev)
                 - (NSYM - 1) / 2)
    slope = (x * y).sum() / (x * x).sum()
    # (reference: src/acquire.c:236-239, incl. the empirical -0.06 offset)
    angle2 = angle - slope * fft
    phase_corr = torch.exp(
        1j * (-y.mean() + slope * NSYM * fftcp / 2 - 0.06))

    # pass 2: the corrected demodulation
    spectra, phase_out = _am_fold_fft(window, samperr, phase0 * phase_corr,
                                      angle2)
    mag_sums = spectra1.abs().sum(0)
    keep = (fftcp + (fftcp // 2 - samperr)).to(torch.int32)
    # carry the regression-corrected angle with the integer CFO folded
    # back out (reference: src/acquire.c:236-240)
    prev_angle_out = (angle2 + 2 * math.pi * cfo_bins.float()).float()
    return (spectra, AcquireState(phase=phase_out, prev_angle=prev_angle_out),
            samperr, keep, mag_sums)


# ---------------------------------------------------------------------------
# K17 and K19: the complex chain's demodulation, batched over stations
# ---------------------------------------------------------------------------

def _check_demod(samples, window: int, **per_station) -> int:
    s = samples.shape[0]
    if samples.ndim != 2 or samples.shape[1] < window:
        raise ValueError(f"samples: expected [S, >= {window}], got "
                         f"{tuple(samples.shape)}")
    for name, t in per_station.items():
        if tuple(t.shape) != (s,):
            raise ValueError(f"{name}: expected shape ({s},), got "
                             f"{tuple(t.shape)}")
    return s


def demod_fm_c_plain(samples, offset, phase, samperr, angle, cfo):
    """Plain version of K17: for each station, its window at ``offset``
    (:func:`window_at`), conjugated as the FM ingest does, through
    ``_demod``.  samples [S, N] complex64 (unconjugated); offset, samperr,
    cfo int32, angle float32, phase complex64, all [S].  Returns (spectra
    [S, 32, 2048] complex64 fftshifted, phase_out [S] complex64, keep [S]
    int32)."""
    _check_demod(samples, WINDOW_FM, offset=offset, phase=phase,
                 samperr=samperr, angle=angle, cfo=cfo)
    rows = []
    for i in range(samples.shape[0]):
        buf = window_at(samples[i], offset[i], WINDOW_FM).conj()
        spectra, st, _, _, keep = _demod(
            buf, AcquireState(phase=phase[i], prev_angle=angle[i]),
            samperr[i], angle[i], cfo[i])
        rows.append((spectra, st.phase, keep))
    return tuple(torch.stack(col) for col in zip(*rows))


def demod_fm_c(samples, offset, phase, samperr, angle, cfo, out=None):
    """K17: the arguments and results of :func:`demod_fm_c_plain`, written
    into ``out`` = (spectra, phase_out, keep) where it is given.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (a CTA of 256 threads a symbol of a station: its samples read
    at the clamped window and slice starts, conjugated, derotated and
    folded on load, a 2048-point radix-2 FFT in shared memory, the
    fftshift on store)."""
    if samples.device.type == "cpu":
        res = demod_fm_c_plain(samples, offset, phase, samperr, angle, cfo)
        return res if out is None else K.into(out, res)
    s = _check_demod(samples, WINDOW_FM, offset=offset, phase=phase,
                     samperr=samperr, angle=angle, cfo=cfo)
    for name, t, dtype in (("samples", samples, torch.complex64),
                           ("offset", offset, torch.int32),
                           ("phase", phase, torch.complex64),
                           ("samperr", samperr, torch.int32),
                           ("angle", angle, torch.float32),
                           ("cfo", cfo, torch.int32)):
        K.check(t, name, dtype)
    dev = samples.device
    if out is None:
        out = (torch.empty(s, NSYM, C.FFT_FM, dtype=torch.complex64,
                           device=dev),
               torch.empty(s, dtype=torch.complex64, device=dev),
               torch.empty(s, dtype=torch.int32, device=dev))
    spectra, phase_out, keep = out
    K.check(spectra, "spectra", torch.complex64, (s, NSYM, C.FFT_FM))
    K.check(phase_out, "phase_out", torch.complex64, (s,))
    K.check(keep, "keep", torch.int32, (s,))
    K.launch("fm_demod_c", samples.data_ptr(), samples.shape[1],
             offset.data_ptr(), phase.data_ptr(), samperr.data_ptr(),
             angle.data_ptr(), cfo.data_ptr(),
             _tables(str(dev))["shape_fm"].data_ptr(),
             twiddles(C.FFT_FM, str(dev)).data_ptr(),
             2 * math.pi / C.FFT_FM, spectra.data_ptr(),
             phase_out.data_ptr(), keep.data_ptr(), s, device=dev)
    return spectra, phase_out, keep


def demod_am_c_plain(samples, offset, phase, samperr, prev_angle, cfo):
    """Plain version of K19: for each station, its window at ``offset``
    (:func:`window_at`) through ``_am_process``.  samples [S, N]
    complex64; offset, samperr (the symbol timing itself), cfo (integer
    bins) int32, prev_angle float32, phase complex64, all [S].  Returns
    (spectra [S, 32, 256] complex64 fftshifted (pass 2), mag_sums [S, 256]
    float32 (pass 1), phase_out [S] complex64, prev_angle_out [S]
    float32, keep [S] int32)."""
    _check_demod(samples, WINDOW_AM, offset=offset, phase=phase,
                 samperr=samperr, prev_angle=prev_angle, cfo=cfo)
    rows = []
    for i in range(samples.shape[0]):
        spectra, st, _, keep, mag_sums = _am_process(
            window_at(samples[i], offset[i], WINDOW_AM),
            AcquireState(phase=phase[i], prev_angle=prev_angle[i]),
            samperr[i], prev_angle[i], cfo[i])
        rows.append((spectra, mag_sums, st.phase, st.prev_angle, keep))
    return tuple(torch.stack(col) for col in zip(*rows))


def demod_am_c(samples, offset, phase, samperr, prev_angle, cfo, out=None):
    """K19: the arguments and results of :func:`demod_am_c_plain`, written
    into ``out`` = (spectra, mag_sums, phase_out, prev_angle_out, keep)
    where it is given.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (a CTA of 256 threads a station: both passes' 32 x 256 points
    in shared memory, a 256-point radix-2 FFT a symbol, the pilot fit on
    one warp between the passes)."""
    if samples.device.type == "cpu":
        res = demod_am_c_plain(samples, offset, phase, samperr, prev_angle,
                               cfo)
        return res if out is None else K.into(out, res)
    s = _check_demod(samples, WINDOW_AM, offset=offset, phase=phase,
                     samperr=samperr, prev_angle=prev_angle, cfo=cfo)
    for name, t, dtype in (("samples", samples, torch.complex64),
                           ("offset", offset, torch.int32),
                           ("phase", phase, torch.complex64),
                           ("samperr", samperr, torch.int32),
                           ("prev_angle", prev_angle, torch.float32),
                           ("cfo", cfo, torch.int32)):
        K.check(t, name, dtype)
    dev = samples.device
    if out is None:
        out = (torch.empty(s, NSYM, C.FFT_AM, dtype=torch.complex64,
                           device=dev),
               torch.empty(s, C.FFT_AM, dtype=torch.float32, device=dev),
               torch.empty(s, dtype=torch.complex64, device=dev),
               torch.empty(s, dtype=torch.float32, device=dev),
               torch.empty(s, dtype=torch.int32, device=dev))
    spectra, mag_sums, phase_out, angle_out, keep = out
    K.check(spectra, "spectra", torch.complex64, (s, NSYM, C.FFT_AM))
    K.check(mag_sums, "mag_sums", torch.float32, (s, C.FFT_AM))
    K.check(phase_out, "phase_out", torch.complex64, (s,))
    K.check(angle_out, "prev_angle_out", torch.float32, (s,))
    K.check(keep, "keep", torch.int32, (s,))
    K.launch("am_demod_c", samples.data_ptr(), samples.shape[1],
             offset.data_ptr(), phase.data_ptr(), samperr.data_ptr(),
             prev_angle.data_ptr(), cfo.data_ptr(),
             _tables(str(dev))["shape_am"].data_ptr(),
             twiddles(C.FFT_AM, str(dev)).data_ptr(), 2 * math.pi,
             spectra.data_ptr(), mag_sums.data_ptr(), phase_out.data_ptr(),
             angle_out.data_ptr(), keep.data_ptr(), s, device=dev)
    return spectra, mag_sums, phase_out, angle_out, keep
