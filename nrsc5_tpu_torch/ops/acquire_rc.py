"""Acquire demodulation (fine path) in the real-valued (rc) formulation.

PyTorch counterpart of ``nrsc5_tpu/ops/acquire_rc.py:demod_rc`` and of
``WINDOW_FM`` (``nrsc5_tpu/ops/acquire.py:34``).  Per L1 block and station:
the derotation ramp (fractional angle plus integer CFO mod 2048), the
32 x 2160-sample slice at ``samperr``, and the shaped 112-sample
cyclic-prefix fold, then the 2048-point DFT.

:func:`demod_fold` is kernel K2 (``csrc/demod_fold.cu``): everything but
the DFT, for all stations at once, reading each station's window straight
from its sample buffer.  :func:`demod_fold_plain` is its plain PyTorch
version.  The DFT stays a matmul (:func:`nrsc5_tpu_torch.ops.rcplx.dft`),
as the reference leaves it to a plain matmul outside any kernel.
"""

from __future__ import annotations

import functools
import math

import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import rcplx as rc

WINDOW_FM = C.FFTCP_FM * (C.ACQUIRE_SYMBOLS + 1)  # 71280
NSAMP = C.ACQUIRE_SYMBOLS * C.FFTCP_FM  # 69120 samples demodulated per block
# 2*pi/FFT_FM as the float32 constant the reference's weak typing makes
TWO_PI_OVER_FFT = 2 * math.pi / C.FFT_FM


@functools.lru_cache(maxsize=4)
def _shape(device: str) -> torch.Tensor:
    return torch.from_numpy(C.ofdm_shape(C.FFT_FM, C.CP_FM)).to(device)


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
