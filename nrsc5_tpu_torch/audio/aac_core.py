"""AAC-LC core DSP shared by the HDC decoder and the truth-harness encoder.

HDC's core layer is MPEG AAC-LC at 22050 Hz with 1024-sample frames
(reference: support/faad2-hdc-support.patch:199-212 — defSampleRate 22050,
frameLength 1024, object type HDC_LC); only the element syntax around it
differs (see hdc_decoder).  This module provides the rate-dependent
scalefactor-band tables, the filterbank (windows + (I)MDCT via 2n-point
FFTs; the dense cosine basis is kept as the spec-form reference),
quantization, and the spectral
codebook packing/unpacking used by both directions.

All spec data tables come from audio/aac_tables.py (generated;
see support/extract_aac_tables.py).
"""

from __future__ import annotations

import functools

import numpy as np

from nrsc5_tpu_torch.audio import aac_tables as T

SF_INDEX_22050 = 7  # sample-rate index of the HDC core rate
FRAME_LEN = 1024
SF_OFFSET = 100
SF_CENTER = 60  # scalefactor huffman symbol for a 0 dpcm step

# window sequences
ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3

# spectral codebooks: id -> (dimension, LAV, signed)
ZERO_HCB = 0
FIRST_PAIR_HCB = 5
ESC_HCB = 11
NOISE_HCB = 13
INTENSITY_HCB2 = 14
INTENSITY_HCB = 15
CB_META = {
    1: (4, 1, True), 2: (4, 1, True),
    3: (4, 2, False), 4: (4, 2, False),
    5: (2, 4, True), 6: (2, 4, True),
    7: (2, 7, False), 8: (2, 7, False),
    9: (2, 12, False), 10: (2, 12, False),
    11: (2, 16, False),
}


# ----------------------------------------------------------------------
# scalefactor bands (22050 Hz)
# ----------------------------------------------------------------------
def swb_offsets(short: bool) -> np.ndarray:
    """Scalefactor-band boundaries incl. the end sentinel."""
    if short:
        offs = T.SWB_OFFSET_128_24
        return np.concatenate([offs, [128]]).astype(np.int32)
    return T.SWB_OFFSET_1024_24.astype(np.int32)


def num_swb(short: bool) -> int:
    tab = T.FF_AAC_NUM_SWB_128 if short else T.FF_AAC_NUM_SWB_1024
    return int(tab[SF_INDEX_22050])


def tns_max_bands(short: bool) -> int:
    tab = T.FF_TNS_MAX_BANDS_128 if short else T.FF_TNS_MAX_BANDS_1024
    return int(tab[SF_INDEX_22050])


# ----------------------------------------------------------------------
# codebook index packing (ISO 13818-7 quad/pair composition)
# ----------------------------------------------------------------------
def pack_index(cb: int, vals) -> int:
    dim, lav, signed = CB_META[cb]
    base = 2 * lav + 1 if signed else lav + 1
    off = lav if signed else 0
    idx = 0
    for v in vals:
        idx = idx * base + (v + off)
    return idx


def unpack_index(cb: int, idx: int) -> list[int]:
    dim, lav, signed = CB_META[cb]
    base = 2 * lav + 1 if signed else lav + 1
    off = lav if signed else 0
    out = [0] * dim
    for i in range(dim - 1, -1, -1):
        out[i] = idx % base - off
        idx //= base
    return out


# ----------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------
def dequant(q: np.ndarray, sf: int) -> np.ndarray:
    """Inverse quantizer: sign(q)·|q|^(4/3)·2^((sf−100)/4)."""
    x = np.sign(q) * np.abs(q).astype(np.float64) ** (4.0 / 3.0)
    return (x * 2.0 ** (0.25 * (sf - SF_OFFSET))).astype(np.float32)


def quant(x: np.ndarray, sf: int) -> np.ndarray:
    """Forward quantizer (encoder): the AAC 3/4-power companding with the
    standard +0.4054 rounding bias."""
    a = np.abs(x).astype(np.float64) * 2.0 ** (-0.25 * (sf - SF_OFFSET))
    q = np.floor(a ** 0.75 + 0.4054).astype(np.int64)
    return (np.sign(x) * q).astype(np.int64)


# ----------------------------------------------------------------------
# windows & filterbank
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def window(shape: int, n: int) -> np.ndarray:
    """Full 2n-sample analysis/synthesis window (first half rising)."""
    if shape == 0:  # sine
        return np.sin(np.pi / (2 * n) * (np.arange(2 * n) + 0.5)) \
            .astype(np.float64)
    # Kaiser-Bessel derived, alpha = 4 (long) / 6 (short)
    alpha = 4.0 if n == FRAME_LEN else 6.0
    t = (np.arange(n + 1) / n - 0.5) * 2.0
    i0 = np.i0(np.pi * alpha * np.sqrt(np.clip(1 - t * t, 0, None)))
    c = np.cumsum(i0)
    half = np.sqrt(c[:n] / c[n])
    return np.concatenate([half, half[::-1]])


@functools.lru_cache(maxsize=None)
def _mdct_basis(n: int) -> np.ndarray:
    """[2n, n] cosine basis; forward = xᵀ·B, inverse = (2/n)·B·X."""
    ns = np.arange(2 * n)[:, None] + 0.5 + n / 2
    ks = np.arange(n)[None, :] + 0.5
    return np.cos(np.pi / n * ns * ks)


@functools.lru_cache(maxsize=None)
def _mdct_twiddles(n: int):
    """Pre/post phases for the O(N log N) FFT (I)MDCT (see mdct/imdct)."""
    pre = np.exp(1j * np.pi * np.arange(2 * n) / (2 * n))
    k = np.arange(n)
    fwd_post = np.exp(1j * (np.pi * k / 2 + np.pi * k / (2 * n)
                            + np.pi / 4 + np.pi / (4 * n)))
    m = np.arange(2 * n)
    inv_post = np.exp(1j * (np.pi * m / (2 * n) + np.pi / (4 * n)))
    return pre, fwd_post, inv_post


def mdct(x: np.ndarray) -> np.ndarray:
    """Forward MDCT of windowed time block x[..., 2n] -> [..., n].

    Evaluated as a 2n-point FFT with pre/post twiddles (cos(π/n·(m+0.5+
    n/2)(k+0.5)) expands into e^{2πimk/2n} times unit phases) — ~40×
    faster than the dense [2n, n] basis matmul it replaces and equal to
    it within ~1e-11 (pinned by test_hdc_codec); `_mdct_basis` remains
    as the spec-form reference."""
    n = x.shape[-1] // 2
    pre, fwd_post, _ = _mdct_twiddles(n)
    F = np.fft.ifft(x * pre, axis=-1) * (2 * n)
    return (fwd_post * F[..., :n]).real


def imdct(X: np.ndarray) -> np.ndarray:
    """Inverse MDCT [..., n] -> time block [..., 2n] (pre-window).

    DCT-IV via a zero-padded 2n-point FFT, then the MDCT output is the
    half-sample-shifted read-out y[i] = (2/n)·c[i + n/2] using the
    DCT-IV extension symmetry c[2n + j] = −c[j]."""
    n = X.shape[-1]
    pre, _, inv_post = _mdct_twiddles(n)
    xt = np.zeros(X.shape[:-1] + (2 * n,), np.complex128)
    xt[..., :n] = X * pre[:n]
    c = (inv_post * np.fft.ifft(xt, axis=-1) * (2 * n)).real
    h = n // 2
    y = np.empty_like(c)
    y[..., :2 * n - h] = c[..., h:]
    y[..., 2 * n - h:] = -c[..., :h]
    return (2.0 / n) * y


SHORT_LEN = 128
# the 8 overlapping 256-sample short windows span 9*128 samples, centered
# in the 2048-sample long block
SHORT_OFF = (2 * FRAME_LEN - 9 * SHORT_LEN) // 2  # = 448


def build_window(seq: int, shape: int, prev_shape: int) -> np.ndarray:
    """The 2048-sample long-block window for non-short sequences.

    The left (rising) slope always uses the *previous* frame's window
    shape; the right slope uses the current one (ISO 14496-3 §4.6.11)."""
    n = FRAME_LEN
    left_long = window(prev_shape, n)[:n]
    right_long = window(shape, n)[n:]
    left_short = window(prev_shape, SHORT_LEN)[:SHORT_LEN]
    right_short = window(shape, SHORT_LEN)[SHORT_LEN:]
    w = np.zeros(2 * n)
    if seq == ONLY_LONG:
        w[:n] = left_long
        w[n:] = right_long
    elif seq == LONG_START:
        w[:n] = left_long
        w[n:n + SHORT_OFF] = 1.0  # 1024..1472
        w[n + SHORT_OFF:n + SHORT_OFF + SHORT_LEN] = right_short
    elif seq == LONG_STOP:
        w[SHORT_OFF:SHORT_OFF + SHORT_LEN] = left_short
        w[SHORT_OFF + SHORT_LEN:n] = 1.0
        w[n:] = right_long
    else:
        raise ValueError(seq)
    return w


def filterbank_synthesis(coefs: np.ndarray, seq: int, shape: int,
                         prev_shape: int, overlap: np.ndarray):
    """coefs[1024] -> (pcm[1024], new_overlap[1024]).

    EIGHT_SHORT runs 8 interleaved-by-group 128-coef IMDCTs laid out from
    offset 448 (ISO 14496-3 §4.6.11.3); coefs must already be in
    per-window order (w0 first)."""
    n = FRAME_LEN
    buf = np.zeros(2 * n)
    if seq == EIGHT_SHORT:
        blocks = imdct(coefs.reshape(8, SHORT_LEN))  # [8, 256]
        wl = window(prev_shape, SHORT_LEN)
        wc = window(shape, SHORT_LEN)
        for w in range(8):
            win = np.concatenate([wl[:SHORT_LEN] if w == 0
                                  else wc[:SHORT_LEN], wc[SHORT_LEN:]])
            start = SHORT_OFF + w * SHORT_LEN
            buf[start:start + 2 * SHORT_LEN] += blocks[w] * win
    else:
        buf = imdct(coefs) * build_window(seq, shape, prev_shape)
    # spec IMDCT scale is 2/N with N = 2n (ISO 14496-3 §4.6.11.3);
    # imdct() returns 2/n, so halve — pinned against libavcodec by
    # test_hdc_external_oracle (without this, PCM is 2x FAAD2's)
    buf *= 0.5
    out = overlap + buf[:n]
    return out.astype(np.float32), buf[n:].astype(np.float32)


def filterbank_analysis(frame2x: np.ndarray, seq: int, shape: int,
                        prev_shape: int) -> np.ndarray:
    """Encoder forward filterbank: 2048 time samples (previous frame +
    current frame) -> 1024 MDCT coefficients (per-window order).

    The x2 mirrors the 0.5 in filterbank_synthesis: together they keep
    decode(encode(x)) at unity while transmitting spectra at the ISO
    scale an independent decoder (FAAD2/libavcodec) expects."""
    n = FRAME_LEN
    if seq == EIGHT_SHORT:
        wl = window(prev_shape, SHORT_LEN)
        wc = window(shape, SHORT_LEN)
        out = np.zeros((8, SHORT_LEN))
        for w in range(8):
            win = np.concatenate([wl[:SHORT_LEN] if w == 0
                                  else wc[:SHORT_LEN], wc[SHORT_LEN:]])
            start = SHORT_OFF + w * SHORT_LEN
            out[w] = mdct(frame2x[start:start + 2 * SHORT_LEN] * win)
        return 2.0 * out.reshape(-1)
    return 2.0 * mdct(frame2x * build_window(seq, shape, prev_shape))
