"""Acquisition in the real-valued (rc) formulation: coarse timing and the
acquire demodulation.

PyTorch counterpart of ``nrsc5_tpu/ops/acquire_rc.py``'s
``coarse_timing_rc`` and ``demod_rc``, and of ``WINDOW_FM``, ``WINDOW_AM``,
``_shape_kernel`` and ``_cp_window_idx`` (``nrsc5_tpu/ops/acquire.py:34,
50-60, 285``; pinned equal by tests/test_torch_tables.py).

:func:`coarse_timing_rc` is kernel K9 (``csrc/coarse_timing.cu``): the
cold start's cyclic-prefix correlation over all 2160 timings of the first
33-symbol window, for all stations at once.  :func:`demod_fold` is kernel
K2 (``csrc/demod_fold.cu``): per L1 block and station, the derotation ramp
(fractional angle plus integer CFO mod 2048), the 32 x 2160-sample slice
at ``samperr``, and the shaped 112-sample cyclic-prefix fold, reading each
station's window straight from its sample buffer.  Each has its plain
PyTorch version beside it.  The DFT stays a matmul
(:func:`nrsc5_tpu_torch.ops.rcplx.dft`), as the reference leaves it to a
plain matmul outside any kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import rcplx as rc

WINDOW_FM = C.FFTCP_FM * (C.ACQUIRE_SYMBOLS + 1)  # 71280
WINDOW_AM = C.FFTCP_AM * (C.ACQUIRE_SYMBOLS + 1)  # 8910
NSAMP = C.ACQUIRE_SYMBOLS * C.FFTCP_FM  # 69120 samples demodulated per block
# 2*pi/FFT_FM as the float32 constant the reference's weak typing makes
TWO_PI_OVER_FFT = 2 * math.pi / C.FFT_FM


@functools.lru_cache(maxsize=4)
def _shape(device: str) -> torch.Tensor:
    return torch.from_numpy(C.ofdm_shape(C.FFT_FM, C.CP_FM)).to(device)


@functools.lru_cache(maxsize=4)
def _shape_kernel(fft: int, cp: int) -> np.ndarray:
    w = C.ofdm_shape(fft, cp)
    return (w[:cp] * w[fft:]).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _cp_window_idx(fftcp: int, cp: int) -> np.ndarray:
    """[fftcp, cp] int32: row i holds the CP window's circular positions
    (i + j) mod fftcp."""
    return ((np.arange(fftcp)[:, None] + np.arange(cp)[None, :]) % fftcp
            ).astype(np.int32)


@functools.lru_cache(maxsize=4)
def _k9_tables(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The band filter's taps and the CP window's shape kernel, as K9
    reads them."""
    taps = np.asarray(C.ACQ_TAPS_FM, np.float32)
    return (torch.from_numpy(taps).to(device),
            torch.from_numpy(_shape_kernel(C.FFT_FM, C.CP_FM)).to(device))


def _check_window(samples):
    if samples.ndim != 3 or samples.shape[-1] != 2 \
            or samples.shape[1] < WINDOW_FM:
        raise ValueError(f"samples: expected [S, >= {WINDOW_FM}, 2], got "
                         f"{tuple(samples.shape)}")


def coarse_timing_rc_plain(samples):
    """Plain version of K9.

    samples [S, N, 2] float32 conjugated rc (N >= WINDOW_FM); each station's
    first WINDOW_FM samples are its window.  Returns (samperr int32 [S],
    max_v float32 [S, 2]): the 32-tap band filter f[n] = Σ_o taps[o]·x[n−1−o]
    (f[0] = 0), the CP product summed over the 32 symbols for each of the
    2160 timings, the shaped circular window sum over the 112-sample CP,
    and the first argmax of |v|², shifted back by the filter's delay.
    Every sum runs in index order, as the kernel's do."""
    _check_window(samples)
    fftcp, fft, cp = C.FFTCP_FM, C.FFT_FM, C.CP_FM
    s = samples.shape[0]
    x = samples[:, :WINDOW_FM]
    f = torch.zeros_like(x)
    for o, tap in enumerate(np.asarray(C.ACQ_TAPS_FM, np.float32)):
        f[:, 1 + o:] += float(tap) * x[:, :WINDOW_FM - 1 - o]
    a = f[:, :NSAMP].reshape(s, C.ACQUIRE_SYMBOLS, fftcp, 2)
    b = f[:, fft:fft + NSAMP].reshape(s, C.ACQUIRE_SYMBOLS, fftcp, 2)
    prod = rc.mul_conj(a, b)
    sums = torch.zeros_like(prod[:, 0])
    for k in range(C.ACQUIRE_SYMBOLS):
        sums = sums + prod[:, k]
    ext = torch.cat([sums, sums[:, :cp - 1]], dim=1)  # circular extension
    v = torch.zeros_like(sums)
    for j, w in enumerate(_shape_kernel(fft, cp)):
        v = v + float(w) * ext[:, j:j + fftcp]
    i_max = torch.argmax(rc.abs2(v), dim=1)
    samperr = ((i_max + fftcp - C.ACQ_FILTER_DELAY) % fftcp).to(torch.int32)
    return samperr, v[torch.arange(s, device=v.device), i_max]


def coarse_timing_rc(samples):
    """K9: the argument and results of :func:`coarse_timing_rc_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one CTA per station, bit-identical to the plain version)."""
    if samples.device.type == "cpu":
        return coarse_timing_rc_plain(samples)
    _check_window(samples)
    K.check(samples, "samples", torch.float32)
    s, dev = samples.shape[0], samples.device
    taps, kern = _k9_tables(str(dev))
    samperr = torch.empty(s, dtype=torch.int32, device=dev)
    max_v = torch.empty(s, 2, dtype=torch.float32, device=dev)
    K.launch("coarse_timing", samples.data_ptr(), samples.shape[1],
             taps.data_ptr(), kern.data_ptr(), C.ACQ_FILTER_DELAY,
             samperr.data_ptr(), max_v.data_ptr(), s, device=dev)
    return samperr, max_v


def dynamic_start(start, dim: int, size: int):
    """Where ``lax.dynamic_slice`` starts a ``size`` slice of a ``dim`` axis
    at ``start``: a negative start counts from the end, then the start is
    clamped so the slice lies inside the axis."""
    start = torch.where(start < 0, start + dim, start)
    return start.clamp(0, dim - size)


def _check_stations(samples, offset, phase, samperr, angle, cfo):
    s = samples.shape[0]
    if samples.ndim != 3 or samples.shape[-1] != 2 \
            or samples.shape[1] < WINDOW_FM:
        raise ValueError(f"samples: expected [S, >= {WINDOW_FM}, 2], got "
                         f"{tuple(samples.shape)}")
    for name, t, shape in (("offset", offset, (s,)), ("phase", phase, (s, 2)),
                           ("samperr", samperr, (s,)), ("angle", angle, (s,)),
                           ("cfo", cfo, (s,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")


def demod_fold_plain(samples, offset, phase, samperr, angle, cfo):
    """Plain version of K2.

    samples [S, N, 2] float32 conjugated rc (N >= WINDOW_FM); per station
    offset int32 (window start in the buffer), phase [2], samperr int32
    (symbol start inside the window), angle float32, cfo int32 bins.  Both
    starts are placed as ``lax.dynamic_slice`` places them
    (:func:`dynamic_start`).  Returns (folded [S, 32, 2048, 2],
    phase_out [S, 2], keep [S] int32)."""
    _check_stations(samples, offset, phase, samperr, angle, cfo)
    fftcp, fft, cp = C.FFTCP_FM, C.FFT_FM, C.CP_FM
    nsym = C.ACQUIRE_SYMBOLS
    dev = samples.device
    angle = angle[:, None]
    cfo = cfo[:, None]

    n = torch.arange(NSAMP, dtype=torch.int32, device=dev)[None, :]
    frac = (angle / fft) * n.float()
    cfo_mod = ((cfo * n) % fft).float()
    ramp_angle = frac - TWO_PI_OVER_FFT * cfo_mod

    adj_i = fftcp // 2 - samperr[:, None]
    adj = adj_i.float()
    adj_cfo = ((cfo * adj_i) % fft).float()
    phase0 = rc.normalize(rc.mul(phase[:, None, :], rc.exp_i(
        -adj * angle / fft + TWO_PI_OVER_FFT * adj_cfo)))  # [S, 1, 2]
    ramp = rc.mul(phase0, rc.exp_i(ramp_angle))  # [S, NSAMP, 2]

    start = dynamic_start(offset, samples.shape[1], WINDOW_FM) \
        + dynamic_start(samperr, WINDOW_FM, NSAMP)
    idx = (start[:, None] + n).long()
    sliced = torch.gather(samples, 1, idx[..., None].expand(-1, -1, 2))
    x = rc.mul(sliced, ramp).reshape(-1, nsym, fftcp, 2)

    w = _shape(str(dev))
    head = w[None, None, :cp, None] * x[:, :, :cp] \
        + w[None, None, fft:, None] * x[:, :, fft:]
    folded = torch.cat([head, x[:, :, cp:fft]], dim=2)

    phase_out = rc.normalize(rc.mul(phase0[:, 0], rc.exp_i(
        (angle[:, 0] / fft) * NSAMP
        - TWO_PI_OVER_FFT * ((cfo[:, 0] * NSAMP) % fft).float())))
    keep = (fftcp + (fftcp // 2 - samperr)).to(torch.int32)
    return folded, phase_out, keep


def demod_fold(samples, offset, phase, samperr, angle, cfo):
    """K2: the arguments and results of :func:`demod_fold_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one thread per folded output sample)."""
    if samples.device.type == "cpu":
        return demod_fold_plain(samples, offset, phase, samperr, angle, cfo)
    _check_stations(samples, offset, phase, samperr, angle, cfo)
    s = samples.shape[0]
    K.check(samples, "samples", torch.float32)
    K.check(offset, "offset", torch.int32)
    K.check(phase, "phase", torch.float32)
    K.check(samperr, "samperr", torch.int32)
    K.check(angle, "angle", torch.float32)
    K.check(cfo, "cfo", torch.int32)
    dev = samples.device
    folded = torch.empty(s, C.ACQUIRE_SYMBOLS, C.FFT_FM, 2,
                         dtype=torch.float32, device=dev)
    phase_out = torch.empty(s, 2, dtype=torch.float32, device=dev)
    keep = torch.empty(s, dtype=torch.int32, device=dev)
    K.launch("demod_fold", samples.data_ptr(), samples.shape[1],
             offset.data_ptr(), phase.data_ptr(), samperr.data_ptr(),
             angle.data_ptr(), cfo.data_ptr(), _shape(str(dev)).data_ptr(),
             TWO_PI_OVER_FFT, folded.data_ptr(), phase_out.data_ptr(),
             keep.data_ptr(), s, device=dev)
    return folded, phase_out, keep
