"""The AM cold start's probe kernels (K14), on rc tensors.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain_am_rc.py``'s
``_am_tone_subtract_rc`` (lines 350-401), ``_am_coarse_timing_rc`` (404-421)
with the two scalar steps of ``am_coldstart_block_rc`` (441-445), and of
the magnitude sums of ``_am_process_rc`` (line 106) with the cold start's
integer-CFO argmax (lines 503-506), for a batch of stations.  Three hand
kernels in ``csrc/am_coldstart.cu``, each with its plain PyTorch version
beside it:

  * :func:`am_tone`: the dominant tone of each station's 8910-sample
    window (the AM carrier, one complex exponential through any static
    multipath channel): the integer bin from the power DFT's spectra, the
    85-point sub-bin grid, the parabola and two Newton steps -> frequency
    ``f`` and amplitude ``amp``;
  * :func:`am_coarse`: the window with the tone subtracted (``amp ·
    conj(e^{-2πi f m})``, computed as it is read), the CP correlation over
    all 270 timings, the shaped 14-tap circular window and its argmax, then
    the consensus latch override and the prev_angle smoothing;
  * :func:`am_cfo_step`: Σ over the 32 symbols of |pass-1 spectra| on the
    107 bins around the carrier, and the integer-CFO step of its argmax.

The 8910-sample sums run in an order the kernels share: thread t of
:data:`SUM_WIDTH` sums elements t, t + 256, ... in turn, and a pairwise
tree halves the partial sums (:func:`fixed_sum`); every other sum runs
from its first term to its last.  So kernel and plain version agree bit
for bit on the card.  Against the reference, which sums in XLA's order,
the results agree to float rounding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops.acquire_rc import (WINDOW_AM, _cp_window_idx,
                                            _shape_kernel, dynamic_start)

# the reference's sub-bin grid jnp.linspace(-0.6, 0.6, 85) in float32,
# value for value (numpy's linspace rounds some points differently; pinned
# equal by tests/test_torch_tables.py)
TONE_GRID = np.array([
    -0.6, -0.58571434, -0.57142854, -0.55714285, -0.54285717, -0.5285715,
    -0.5142857, -0.5, -0.48571432, -0.4714286, -0.45714286, -0.44285715,
    -0.42857146, -0.41428575, -0.4, -0.38571426, -0.3714286, -0.35714287,
    -0.34285712, -0.32857147, -0.31428573, -0.3, -0.28571427, -0.27142856,
    -0.25714287, -0.24285714, -0.22857141, -0.21428575, -0.19999999,
    -0.18571429, -0.17142856, -0.15714283, -0.14285716, -0.1285714,
    -0.11428571, -0.09999998, -0.08571425, -0.071428575, -0.057142846,
    -0.042857118, -0.02857145, -0.01428569, 9.313226e-09, 0.014285739,
    0.028571468, 0.042857137, 0.05714287, 0.0714286, 0.085714325,
    0.10000004, 0.11428572, 0.12857145, 0.14285716, 0.15714289, 0.17142858,
    0.1857143, 0.20000002, 0.21428576, 0.22857144, 0.24285717, 0.2571429,
    0.2714286, 0.2857143, 0.3, 0.31428576, 0.32857147, 0.3428572, 0.3571429,
    0.3714286, 0.38571432, 0.40000007, 0.41428575, 0.42857146, 0.4428572,
    0.45714292, 0.4714286, 0.48571432, 0.50000006, 0.51428574, 0.5285715,
    0.54285717, 0.5571429, 0.57142866, 0.58571434, 0.6], np.float32)
N_GRID = TONE_GRID.size
SUM_WIDTH = 256  # the kernels' threads per ordered 8910-sample sum
NSAMP = C.ACQUIRE_SYMBOLS * C.FFTCP_AM  # 8640
HALF_SPAN = (WINDOW_AM - 1) / 2.0  # 4454.5: Newton's centred index
# float32 constants, as the reference's weakly typed Python floats become
NEG_TWO_PI_OVER_FFT = -2 * math.pi / C.FFT_AM
NEG_TWO_PI = -2 * math.pi
TWO_PI = 2 * math.pi
# the integer-CFO search band: the carrier's bin ± the outer PIDS index
CFO_LO = C.CENTER_AM - C.PIDS_OUTER_INDEX_AM
CFO_BINS = 2 * C.PIDS_OUTER_INDEX_AM + 1  # 107


@functools.lru_cache(maxsize=4)
def _tables(device: str) -> dict:
    """The grid, the CP window's shape kernel and its circular positions
    on ``device``."""
    return {"u": torch.from_numpy(TONE_GRID).to(device),
            "kern": torch.from_numpy(_shape_kernel(C.FFT_AM, C.CP_AM)
                                     ).to(device),
            "widx": torch.from_numpy(_cp_window_idx(C.FFTCP_AM, C.CP_AM)
                                     ).long().to(device),
            "sym": (C.FFTCP_AM * torch.arange(C.ACQUIRE_SYMBOLS)[:, None]
                    + torch.arange(C.FFT_AM)[None, :]).reshape(-1).to(device)}


def fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in the kernels' order: zero-pad to a multiple of
    SUM_WIDTH, sum the rows of SUM_WIDTH from the first to the last, then
    halve the SUM_WIDTH partial sums pairwise (element t plus element t +
    half) down to one."""
    x = x.movedim(dim, -1)
    pad = (-x.shape[-1]) % SUM_WIDTH
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    rows = x.reshape(x.shape[:-1] + (-1, SUM_WIDTH))
    acc = rows[..., 0, :]
    for r in range(1, rows.shape[-2]):
        acc = acc + rows[..., r, :]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def _check_samples(samples, offset):
    if samples.ndim != 3 or samples.shape[-1] != 2 \
            or samples.shape[1] < WINDOW_AM:
        raise ValueError(f"samples: expected [S, >= {WINDOW_AM}, 2], got "
                         f"{tuple(samples.shape)}")
    if tuple(offset.shape) != (samples.shape[0],):
        raise ValueError(f"offset: expected shape ({samples.shape[0]},), got "
                         f"{tuple(offset.shape)}")


def _check_spectra(spectra, s):
    shape = (s, C.ACQUIRE_SYMBOLS, C.FFT_AM, 2)
    if tuple(spectra.shape) != shape:
        raise ValueError(f"spectra: expected {shape}, got "
                         f"{tuple(spectra.shape)}")


def am_window(samples, offset) -> torch.Tensor:
    """Each station's probe window float32 [S, 8910, 2]: samples [S, N, 2]
    from ``offset`` int32 [S], placed as ``lax.dynamic_slice`` places it."""
    _check_samples(samples, offset)
    start = dynamic_start(offset.long(), samples.shape[1], WINDOW_AM)
    idx = start[:, None] + torch.arange(WINDOW_AM, device=samples.device)
    return torch.gather(samples, 1, idx[..., None].expand(-1, -1, 2))


def tone_symbols(samples, offset) -> torch.Tensor:
    """The first 256 samples of each of the window's 32 symbols, float32
    [S, 32, 256, 2]: the power DFT's input."""
    _check_samples(samples, offset)
    start = dynamic_start(offset.long(), samples.shape[1], WINDOW_AM)
    idx = start[:, None] + _tables(str(samples.device))["sym"]
    return torch.gather(samples, 1, idx[..., None].expand(-1, -1, 2)).view(
        -1, C.ACQUIRE_SYMBOLS, C.FFT_AM, 2)


def tone_k0(spectra) -> torch.Tensor:
    """The integer bin of the tone, int64 [S] in [-128, 128): the first
    argmax of the power summed over the 32 symbols of the power DFT's
    spectra [S, 32, 256, 2] (not fftshifted)."""
    k0 = torch.argmax(rc.ordered_sum(rc.abs2(spectra), 1), dim=1)
    return torch.where(k0 >= C.FFT_AM // 2, k0 - C.FFT_AM, k0)


def am_tone_plain(spectra, samples, offset):
    """Plain version of :func:`am_tone`.

    spectra [S, 32, 256, 2]: the DFT (without shift) of
    :func:`tone_symbols`; samples [S, N, 2] float32 rc, offset int32 [S]
    (the probe window's start).  Returns (f float32 [S] in cycles a sample,
    amp float32 [S, 2]): the tone e^{2πi f n'} · amp (n' = n − 4454.5) that
    the reference's ``_am_tone_subtract_rc`` estimates."""
    s = samples.shape[0]
    _check_spectra(spectra, s)
    dev = samples.device
    tb = _tables(str(dev))
    u = tb["u"]
    k0 = tone_k0(spectra)
    buf = am_window(samples, offset)

    # derotate by the integer bin with the exact integer phase, project
    # onto the 85 sub-bin offsets, refine by the parabola
    n = torch.arange(WINDOW_AM, device=dev)
    ph_int = ((k0[:, None] * n) % C.FFT_AM).float() * NEG_TWO_PI_OVER_FFT
    z = rc.mul(buf, rc.exp_i(ph_int))
    ph_g = NEG_TWO_PI_OVER_FFT * (u[:, None] * n.float()[None, :])
    proj = fixed_sum(rc.mul(z[:, None], rc.exp_i(ph_g)[None]), 2)  # [S,85,2]
    p = rc.abs2(proj)
    i = torch.argmax(p, dim=1).clamp(1, N_GRID - 2)
    pm, p0, pp = (p.gather(1, (i + d)[:, None])[:, 0] for d in (-1, 0, 1))
    den = (pm - 2 * p0) + pp
    d = torch.where(den != 0, (0.5 * (pm - pp)) / den, torch.zeros_like(den))
    f = rc.fdiv(k0.float() + (u[i] + d.clamp(-1.0, 1.0) * (u[1] - u[0])),
                C.FFT_AM)

    # two Newton steps on |S(f)|², taken where the curvature is negative
    m = n.float() - HALF_SPAN
    w = TWO_PI * m
    w2 = w * w
    for _ in range(2):
        xe = rc.mul(buf, rc.exp_i((NEG_TWO_PI * f)[:, None] * m))
        sv = fixed_sum(xe, 1)
        t = fixed_sum(w[None, :, None] * xe, 1)
        d2 = -fixed_sum(w2[None, :, None] * xe, 1)
        ds0, ds1 = t[:, 1], -t[:, 0]  # -i t
        g = 2 * (sv[:, 0] * ds0 + sv[:, 1] * ds1)
        h = 2 * (ds0 * ds0 + ds1 * ds1) \
            + 2 * (sv[:, 0] * d2[:, 0] + sv[:, 1] * d2[:, 1])
        f = torch.where(h < 0, f - g / h, f)
    e = rc.exp_i((NEG_TWO_PI * f)[:, None] * m)
    amp = rc.fdiv(fixed_sum(rc.mul(buf, e), 1), WINDOW_AM)
    return f, amp


def am_tone(spectra, samples, offset):
    """K14's tone estimate: the arguments and results of
    :func:`am_tone_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one CTA per station and 5 grid points; the CTA that finishes
    its station last runs the parabola, Newton and the amplitude)."""
    if samples.device.type == "cpu":
        return am_tone_plain(spectra, samples, offset)
    _check_samples(samples, offset)
    s, dev = samples.shape[0], samples.device
    _check_spectra(spectra, s)
    K.check(spectra, "spectra", torch.float32)
    K.check(samples, "samples", torch.float32)
    K.check(offset, "offset", torch.int32)
    proj = torch.empty(s, N_GRID, 2, dtype=torch.float32, device=dev)
    done = torch.zeros(s, dtype=torch.int32, device=dev)
    f = torch.empty(s, dtype=torch.float32, device=dev)
    amp = torch.empty(s, 2, dtype=torch.float32, device=dev)
    K.launch("am_tone", spectra.data_ptr(), samples.data_ptr(),
             samples.shape[1], offset.data_ptr(),
             _tables(str(dev))["u"].data_ptr(), proj.data_ptr(),
             done.data_ptr(), f.data_ptr(), amp.data_ptr(), s, device=dev)
    return f, amp


def tone_subtract(buf, f, amp) -> torch.Tensor:
    """The window [S, 8910, 2] with the tone (f [S], amp [S, 2]) subtracted:
    buf − amp · conj(e^{i ((−2π) f) m}), as the reference subtracts it."""
    e = rc.exp_i((NEG_TWO_PI * f)[:, None] * (
        torch.arange(WINDOW_AM, device=buf.device).float() - HALF_SPAN))
    return buf - rc.mul(amp[:, None], rc.conj(e))


def _check_coarse(samples, offset, f, amp, prev_angle, coarse_override):
    _check_samples(samples, offset)
    s = samples.shape[0]
    for name, t, shape in (("f", f, (s,)), ("amp", amp, (s, 2)),
                           ("prev_angle", prev_angle, (s,)),
                           ("coarse_override", coarse_override, (s,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")


def am_coarse_plain(samples, offset, f, amp, prev_angle, coarse_override):
    """Plain version of :func:`am_coarse`.

    samples [S, N, 2] float32 rc, offset int32 [S]; the tone of
    :func:`am_tone` (f [S], amp [S, 2]); prev_angle float32 [S];
    coarse_override int32 [S] (the host's consensus latch, -1 for none).
    Returns (measured int32 [S], samperr int32 [S], prev_angle float32 [S],
    v float32 [S, 2]): this window's own CP timing and its correlation v,
    the timing to demodulate with (override % 270 where override >= 0),
    and prev_angle moved toward arg(v) by 0.25 of the difference (all of
    it while prev_angle is 0)."""
    _check_coarse(samples, offset, f, amp, prev_angle, coarse_override)
    fftcp, fft, nsym = C.FFTCP_AM, C.FFT_AM, C.ACQUIRE_SYMBOLS
    s = samples.shape[0]
    tb = _tables(str(samples.device))
    x = tone_subtract(am_window(samples, offset), f, amp)
    a = x[:, :NSAMP].reshape(s, nsym, fftcp, 2)
    b = x[:, fft:fft + NSAMP].reshape(s, nsym, fftcp, 2)
    sums = rc.ordered_sum(rc.mul_conj(a, b), 1)  # [S, 270, 2]
    v = None
    for j, w in enumerate(_shape_kernel(fft, C.CP_AM).tolist()):
        t = sums[:, tb["widx"][:, j]] * w
        v = t if v is None else v + t
    measured = torch.argmax(rc.abs2(v), dim=1)
    v_max = v[torch.arange(s, device=v.device), measured]
    ov = coarse_override.long()
    samperr = torch.where(ov >= 0, ov % fftcp, measured).to(torch.int32)
    diff = rc.angle(rc.mul(v_max, rc.exp_i(-prev_angle)))
    prev_angle = prev_angle + diff * torch.where(prev_angle != 0, 0.25, 1.0)
    return measured.to(torch.int32), samperr, prev_angle, v_max


def am_coarse(samples, offset, f, amp, prev_angle, coarse_override):
    """K14's coarse timing: the arguments and results of
    :func:`am_coarse_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one CTA per station, the tone-subtracted window in 71 KB of
    shared memory)."""
    if samples.device.type == "cpu":
        return am_coarse_plain(samples, offset, f, amp, prev_angle,
                               coarse_override)
    _check_coarse(samples, offset, f, amp, prev_angle, coarse_override)
    s, dev = samples.shape[0], samples.device
    for name, t, dtype in (("samples", samples, torch.float32),
                           ("offset", offset, torch.int32),
                           ("f", f, torch.float32), ("amp", amp, torch.float32),
                           ("prev_angle", prev_angle, torch.float32),
                           ("coarse_override", coarse_override, torch.int32)):
        K.check(t, name, dtype)
    measured = torch.empty(s, dtype=torch.int32, device=dev)
    samperr = torch.empty(s, dtype=torch.int32, device=dev)
    prev_out = torch.empty(s, dtype=torch.float32, device=dev)
    v = torch.empty(s, 2, dtype=torch.float32, device=dev)
    K.launch("am_coarse", samples.data_ptr(), samples.shape[1],
             offset.data_ptr(), f.data_ptr(), amp.data_ptr(),
             prev_angle.data_ptr(), coarse_override.data_ptr(),
             _tables(str(dev))["kern"].data_ptr(), measured.data_ptr(),
             samperr.data_ptr(), prev_out.data_ptr(), v.data_ptr(), s,
             device=dev)
    return measured, samperr, prev_out, v


def am_cfo_step_plain(spectra1):
    """Plain version of :func:`am_cfo_step`.

    spectra1 [S, 32, 256, 2]: pass 1's fftshifted spectra.  Returns (step
    int32 [S], mags float32 [S, 107]): Σ over the symbols of |spectra1| on
    bins 75..181 (the reference's ``mag_sums[lo:hi]``) and the integer-CFO
    step, first argmax − 53."""
    _check_spectra(spectra1, spectra1.shape[0])
    band = spectra1[:, :, CFO_LO:CFO_LO + CFO_BINS]
    mags = rc.ordered_sum(torch.sqrt(rc.abs2(band)), 1)
    step = torch.argmax(mags, dim=1) + (CFO_LO - C.CENTER_AM)
    return step.to(torch.int32), mags


def am_cfo_step(spectra1):
    """K14's integer-CFO step: the argument and results of
    :func:`am_cfo_step_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one CTA per station, one thread per bin)."""
    if spectra1.device.type == "cpu":
        return am_cfo_step_plain(spectra1)
    s, dev = spectra1.shape[0], spectra1.device
    _check_spectra(spectra1, s)
    K.check(spectra1, "spectra1", torch.float32)
    mags = torch.empty(s, CFO_BINS, dtype=torch.float32, device=dev)
    step = torch.empty(s, dtype=torch.int32, device=dev)
    K.launch("am_cfo_step", spectra1.data_ptr(), mags.data_ptr(),
             step.data_ptr(), s, device=dev)
    return step, mags
