"""Channel impairments for the truth harness: delay, CFO, AWGN, echo,
clock drift, Rayleigh fading, upsampling, cu8 quantize and back.

A numpy copy of ``nrsc5_tpu/tx/channel.py`` (``impair``, ``multipath``,
``upsample2``, ``upsample_exact`` and ``to_cu8`` pinned equal by
tests/test_torch_tables.py; ``clock_drift``, ``from_cu8`` and ``fading``
by tests/test_torch_copies.py).
"""

from __future__ import annotations

import numpy as np

from nrsc5_tpu_torch import constants as C


def impair(
    sig: np.ndarray,
    sample_offset: int = 0,
    cfo_hz: float = 0.0,
    snr_db: float | None = None,
    sample_rate: float = C.SAMPLE_RATE_CS16_FM,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Apply timing offset (prepend zeros/noise), carrier frequency offset,
    and AWGN to a complex baseband signal."""
    out = np.asarray(sig, dtype=np.complex64)
    if sample_offset:
        out = np.concatenate([np.zeros(sample_offset, np.complex64), out])
    if cfo_hz:
        n = np.arange(len(out), dtype=np.float64)
        out = out * np.exp(2j * np.pi * cfo_hz / sample_rate * n).astype(np.complex64)
    if snr_db is not None:
        rng = rng or np.random.default_rng(0)
        p_sig = np.mean(np.abs(out) ** 2)
        p_noise = p_sig / (10 ** (snr_db / 10))
        noise = (rng.normal(0, np.sqrt(p_noise / 2), (len(out), 2))
                 .astype(np.float32).view(np.complex64)[:, 0])
        out = out + noise
    return out.astype(np.complex64)


def multipath(sig: np.ndarray, delay: int, amp: float,
              phase: float = 0.7) -> np.ndarray:
    """Static 2-ray channel: add an echo at ``delay`` samples with relative
    amplitude ``amp`` and phase ``phase``."""
    if delay < 0:
        raise ValueError(f"echo delay must be >= 0, got {delay}")
    if delay == 0:  # zero-delay echo = a complex gain on the direct ray
        return (sig * (1.0 + amp * np.exp(1j * phase))).astype(np.complex64)
    echo = np.zeros_like(sig)
    echo[delay:] = sig[:-delay] * amp * np.exp(1j * phase)
    return (sig + echo).astype(np.complex64)


def clock_drift(sig: np.ndarray, ppm: float) -> np.ndarray:
    """Resample by a constant sample-clock error of ``ppm`` parts-per-million
    (linear interpolation; exercises the receiver's samperr feedback loop,
    reference: src/sync.c:426-463 -> src/acquire.c:110-119)."""
    if not ppm:
        return sig
    n_out = int(len(sig) / (1.0 + ppm * 1e-6))
    t = np.arange(n_out, dtype=np.float64) * (1.0 + ppm * 1e-6)
    re = np.interp(t, np.arange(len(sig)), sig.real)
    im = np.interp(t, np.arange(len(sig)), sig.imag)
    return (re + 1j * im).astype(np.complex64)


def upsample_exact(sig: np.ndarray, factor: int) -> np.ndarray:
    """Ideal Fourier interpolation by an integer factor, for high-rate
    captures of narrowband signals (46.5 kS/s AM -> 1.488 MS/s cu8)."""
    n = len(sig)
    f = np.fft.fft(sig)
    out = np.zeros(n * factor, np.complex64)
    h = n // 2
    out[:h] = f[:h]
    out[-(n - h):] = f[h:]
    return (np.fft.ifft(out) * factor).astype(np.complex64)


def upsample2(sig: np.ndarray) -> np.ndarray:
    """Naive 2x zero-stuff + lowpass for generating 1.488 MS/s cu8 captures
    from 744 kS/s FM baseband."""
    up = np.zeros(len(sig) * 2, dtype=np.complex64)
    up[::2] = sig
    # simple FFT brickwall lowpass at fs/4
    f = np.fft.fft(up)
    n = len(up)
    cut = n // 4
    f[cut:-cut] = 0
    return (np.fft.ifft(f) * 2).astype(np.complex64)


def to_cu8(sig: np.ndarray) -> np.ndarray:
    """Quantize complex baseband to interleaved cu8 (reference ingest format:
    value 127 = zero; src/defines.h:92-93)."""
    iq = np.empty(len(sig) * 2, dtype=np.float32)
    iq[0::2] = np.real(sig)
    iq[1::2] = np.imag(sig)
    return np.clip(np.round(iq * 128 + 127), 0, 255).astype(np.uint8)


def from_cu8(data: np.ndarray) -> np.ndarray:
    """cu8 -> complex64, matching U8_Q15 scaling up to the 32767 divisor."""
    f = (data.astype(np.float32) - 127.0) * (64.0 / 32767.0)
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def fading(sig: np.ndarray, doppler_hz: float,
           delays=(0,), amps=(1.0,), rng=None,
           sample_rate: float = C.SAMPLE_RATE_CS16_FM,
           n_sines: int = 16) -> np.ndarray:
    """Rayleigh fading channel (Jakes sum-of-sinusoids): each tap at
    ``delays[i]`` samples carries an independent complex Rayleigh gain
    process of RMS ``amps[i]`` with maximum Doppler ``doppler_hz``.
    ``delays=(0,)`` is flat fading; several taps give time-varying
    frequency-selective fading."""
    rng = rng or np.random.default_rng(0)
    t = np.arange(len(sig), dtype=np.float64) / sample_rate
    out = np.zeros(len(sig), np.complex64)
    for delay, amp in zip(delays, amps):
        g = np.zeros(len(sig), np.complex128)
        for _ in range(n_sines):
            # classic Jakes: arrival angles uniform, random phases
            fd = doppler_hz * np.cos(rng.uniform(0, 2 * np.pi))
            g += np.exp(1j * (2 * np.pi * fd * t
                              + rng.uniform(0, 2 * np.pi)))
        g *= amp / np.sqrt(n_sines)
        ray = np.zeros(len(sig), np.complex64)
        if delay:
            ray[delay:] = sig[:-delay]
        else:
            ray[:] = sig
        out += (ray * g).astype(np.complex64)
    return out
