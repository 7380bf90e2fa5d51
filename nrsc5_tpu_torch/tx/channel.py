"""Channel impairments for the truth harness: delay, CFO, AWGN, cu8 quantize.

A numpy copy of ``impair``, ``upsample2`` and ``to_cu8`` from
``nrsc5_tpu/tx/channel.py`` (pinned equal by tests/test_torch_tables.py).
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
