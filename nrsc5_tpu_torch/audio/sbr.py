"""SBR (spectral band replication) for the HDC codec.

HDC's SBR is the standard MPEG-4 SBR toolchain (ISO/IEC 14496-3 §4.6.18)
carried the DRM way with 32 QMF subsamples per frame (reference:
support/faad2-hdc-support.patch:485 NUM_OF_HDC_SUBSAMPLES=32,
patch:549-608 — no bs_extension_type/CRC prefix, one extra leading bit in
sbr_single_channel_element, extension payload sized by the remaining
packet bits).

Components:
  * 32-band analysis / 64-band synthesis QMF pair (§4.6.18.2-4) as dense
    modulation matmuls over the 640-tap prototype (aac_tables.py);
  * frequency band tables (master/high/low/noise/limiter, §4.6.18.3.2);
  * bitstream decode: header, grid (FIXFIX/FIXVAR/VARFIX/VARVAR), dtdf,
    invf, envelopes/noise floors (huffman tables from aacsbr.o), sinusoid
    flags, extended data;
  * HF generation: patch construction, chirp factors from inverse
    filtering modes, order-2 LPC (covariance method) per low subband
    (§4.6.18.6);
  * HF adjustment: energy estimation, gain/noise/sinusoid calculation
    with the limiter, noise filling from the spec noise table
    (§4.6.18.7).

When a packet carries no SBR fill element the decoder still emits
44100 Hz by running the QMF pair with the high bands zeroed — the
``forceUpSampling`` analog (patch:210).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np

from nrsc5_tpu_torch.audio import aac_tables as T
from nrsc5_tpu_torch.audio.huffman import PrefixCode

NUM_SLOTS = 32       # QMF subsamples per 1024-sample HDC frame
NUM_TIME_SLOTS = 16  # SBR time slots (RATE = 2 subsamples each)
RATE = 2
FS_SBR = 44100       # SBR-rate sample frequency for HDC

FIXFIX, FIXVAR, VARFIX, VARVAR = 0, 1, 2, 3

EPS = 1e-12
LIM_GAINS = (0.70795, 1.0, 1.41254, 1e10)  # -3, 0, +3 dB, boost-only
MAX_BOOST = 1.584893192
# §4.6.18.7.5 h_smooth (j=0 = current slot), bs_smoothing_mode=0 filter
H_SMOOTH = (0.33333333333333, 0.30150283239582, 0.21816949906249,
            0.11516383427084, 0.03183050093751)
NOISE_FLOOR_OFFSET = 6
NOISE_TABLE = T.FF_SBR_NOISE_TABLE[:512, 0] + 1j * T.FF_SBR_NOISE_TABLE[:512, 1]


def _pc(codes, bits):
    return PrefixCode(codes, bits)


# dpcm value offsets ("LAV" centers): 60 for 1.5dB env, 31 for 3.0dB env,
# 12/24 for balance, 31 noise, 12 noise balance (ffmpeg/faad vlc_sbr_lav)
HUFF_ENV15_T = _pc(T.T_HUFFMAN_ENV_1_5DB_CODES, T.T_HUFFMAN_ENV_1_5DB_BITS)
HUFF_ENV15_F = _pc(T.F_HUFFMAN_ENV_1_5DB_CODES, T.F_HUFFMAN_ENV_1_5DB_BITS)
HUFF_ENV30_T = _pc(T.T_HUFFMAN_ENV_3_0DB_CODES, T.T_HUFFMAN_ENV_3_0DB_BITS)
HUFF_ENV30_F = _pc(T.F_HUFFMAN_ENV_3_0DB_CODES, T.F_HUFFMAN_ENV_3_0DB_BITS)
HUFF_BAL15_T = _pc(T.T_HUFFMAN_ENV_BAL_1_5DB_CODES,
                   T.T_HUFFMAN_ENV_BAL_1_5DB_BITS)
HUFF_BAL15_F = _pc(T.F_HUFFMAN_ENV_BAL_1_5DB_CODES,
                   T.F_HUFFMAN_ENV_BAL_1_5DB_BITS)
HUFF_BAL30_T = _pc(T.T_HUFFMAN_ENV_BAL_3_0DB_CODES,
                   T.T_HUFFMAN_ENV_BAL_3_0DB_BITS)
HUFF_BAL30_F = _pc(T.F_HUFFMAN_ENV_BAL_3_0DB_CODES,
                   T.F_HUFFMAN_ENV_BAL_3_0DB_BITS)
HUFF_NOISE_T = _pc(T.T_HUFFMAN_NOISE_3_0DB_CODES,
                   T.T_HUFFMAN_NOISE_3_0DB_BITS)
HUFF_NOISE_BAL_T = _pc(T.T_HUFFMAN_NOISE_BAL_3_0DB_CODES,
                       T.T_HUFFMAN_NOISE_BAL_3_0DB_BITS)
# noise floors reuse the env tables in the frequency direction
HUFF_NOISE_F = HUFF_ENV30_F
HUFF_NOISE_BAL_F = HUFF_BAL30_F


# ----------------------------------------------------------------------
# QMF banks
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _analysis_mod() -> np.ndarray:
    """[64, 32] modulation: X[k] = Σ_n u[n]·exp(iπ/64·(k+0.5)(2n−1))."""
    n = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.exp(1j * np.pi / 64 * (k + 0.5) * (2 * n - 1))


@functools.lru_cache(maxsize=None)
def _synthesis_mod() -> np.ndarray:
    """[64, 128]: v[n] = 1/64·Re Σ_k X[k]·exp(iπ/128·(k+0.5)(2n−255))."""
    k = np.arange(64)[:, None]
    n = np.arange(128)[None, :]
    return np.exp(1j * np.pi / 128 * (k + 0.5) * (2 * n - 255))


class QMFAnalysis:
    """32-band downsampled analysis bank (320-tap prototype = every other
    tap of the 640-tap upsampled window).

    Vectorized: all slots' sliding windows are materialized as one strided
    view and modulated with a single matmul — a per-packet decode-speed
    hot spot as a per-slot np.roll loop."""

    def __init__(self):
        self._hist = np.zeros(288)  # last 9 slots of input
        self.win = T.SBR_QMF_WINDOW_US[::2].astype(np.float64) * 2.0

    def run(self, samples: np.ndarray) -> np.ndarray:
        """[32·nslots] time samples → [nslots, 32] complex subbands."""
        nslots = len(samples) // 32
        if nslots == 0:
            return np.empty((0, 32), np.complex128)
        ext = np.concatenate(
            [self._hist, np.asarray(samples, np.float64)[:nslots * 32]])
        self._hist = ext[-288:].copy()
        wins = np.lib.stride_tricks.sliding_window_view(
            ext, 320)[::32][:nslots]
        z = wins[:, ::-1] * self.win
        u = z.reshape(nslots, 5, 64).sum(axis=1)
        return u @ _analysis_mod()


class QMFSynthesis:
    """64-band synthesis bank (640-tap prototype), vectorized like
    :class:`QMFAnalysis` (one modulation matmul + fancy-indexed gather of
    the per-slot v history)."""

    def __init__(self):
        self._hist = np.zeros((9, 128))  # last 9 slots' v rows, oldest first
        self.win = T.SBR_QMF_WINDOW_US.astype(np.float64)

    def run(self, X: np.ndarray) -> np.ndarray:
        """[nslots, 64] complex subbands → [64·nslots] time samples."""
        nslots = X.shape[0]
        if nslots == 0:
            return np.empty(0)
        V = (X @ _synthesis_mod()).real / 64.0  # [nslots, 128]
        R = np.concatenate([self._hist, V])  # slot t at row t + 9
        self._hist = R[-9:].copy()
        t = np.arange(nslots)[:, None]
        n5 = np.arange(5)[None, :]
        # g[128n:128n+64] = v-row (t-2n)[:64]; g[128n+64:…] = row (t-2n-1)[64:]
        first = R[t + 9 - 2 * n5][:, :, :64]
        second = R[t + 8 - 2 * n5][:, :, 64:]
        g = np.stack([first, second], axis=2).reshape(nslots, 640)
        w = g * self.win
        return w.reshape(nslots, 10, 64).sum(axis=1).reshape(-1)


class QMFAnalysis64:
    """64-band full-rate analysis (encoder side: measures true HF band
    energies of the 44100 Hz input); vectorized like QMFAnalysis."""

    def __init__(self):
        self._hist = np.zeros(576)  # last 9 slots of input
        self.win = T.SBR_QMF_WINDOW_US.astype(np.float64) * 2.0

    def run(self, samples: np.ndarray) -> np.ndarray:
        nslots = len(samples) // 64
        if nslots == 0:
            return np.empty((0, 64), np.complex128)
        ext = np.concatenate(
            [self._hist, np.asarray(samples, np.float64)[:nslots * 64]])
        self._hist = ext[-576:].copy()
        wins = np.lib.stride_tricks.sliding_window_view(
            ext, 640)[::64][:nslots]
        z = wins[:, ::-1] * self.win
        u = z.reshape(nslots, 5, 128).sum(axis=1)
        return u @ _qmf64_mod()


@functools.lru_cache(maxsize=None)
def _qmf64_mod() -> np.ndarray:
    """[128, 64]: X[k] = Σ_n u[n]·exp(iπ/128·(k+0.5)(2n−1))."""
    n = np.arange(128)[:, None]
    k = np.arange(64)[None, :]
    return np.exp(1j * np.pi / 128 * (k + 0.5) * (2 * n - 1))


# ----------------------------------------------------------------------
# frequency band tables (§4.6.18.3.2)
# ----------------------------------------------------------------------
@dataclass
class SbrHeader:
    amp_res: int = 1
    start_freq: int = 5
    stop_freq: int = 3
    xover_band: int = 0
    freq_scale: int = 2
    alter_scale: int = 1
    noise_bands: int = 2
    limiter_bands: int = 2
    limiter_gains: int = 2
    interpol_freq: int = 1
    smoothing_mode: int = 1


def _start_min(fs: int) -> int:
    # round(128*f/fs) at FULL scale (§4.6.18.3.2.1) — rounding the
    # 64-scale value first and doubling gives 30 instead of 29 for
    # stopMin at 44100 and desynchronizes the master table from every
    # conformant decoder (caught by the libavcodec oracle)
    f = 3000 if fs < 32000 else (4000 if fs < 64000 else 5000)
    return (f * 128 + fs // 2) // fs


def _stop_min(fs: int) -> int:
    if fs >= 64000:  # spec pins stopMin at 16 bands for high rates
        return 16
    return min(64, (10000 * 128 + fs // 2) // fs)


def _offset_row(fs: int) -> int:
    rows = {16000: 0, 22050: 1, 24000: 2, 32000: 3, 44100: 4, 48000: 4,
            64000: 4}
    if fs in rows:
        return rows[fs]
    return 5 if fs > 64000 else 4


def make_f_master(hdr: SbrHeader, fs: int = FS_SBR) -> np.ndarray:
    k0 = _start_min(fs) + int(T.SBR_OFFSET[_offset_row(fs)][hdr.start_freq])
    if hdr.stop_freq == 15:
        k2 = 3 * k0
    elif hdr.stop_freq == 14:
        k2 = 2 * k0
    else:
        sm = _stop_min(fs)
        # log-spaced stop candidates between stopMin and 64, ascending
        # increments (§4.6.18.3.2.1 stopDk derivation)
        pts = np.array([int(round(sm * (64.0 / sm) ** (i / 13.0)))
                        for i in range(14)])
        dk = np.sort(np.diff(np.concatenate([[sm], pts[1:]])))
        k2 = sm + int(np.cumsum(np.concatenate([[0], dk]))[hdr.stop_freq])
    k2 = min(k2, 64)

    if hdr.freq_scale == 0:
        dk = 1 if hdr.alter_scale == 0 else 2
        n = 2 * ((k2 - k0) // (2 * dk))
        bands = k0 + dk * np.arange(n + 1)
        master = bands
    else:
        temp = [12, 10, 8][hdr.freq_scale - 1]
        two_regions = (k2 / k0) > 2.2449
        k1 = 2 * k0 if two_regions else k2
        nb0 = 2 * int(round(temp * math.log2(k1 / k0) / 2.0))
        vdk0 = np.diff(np.round(k0 * (k1 / k0) **
                                ((np.arange(nb0) + 1.0) / nb0)).astype(int),
                       prepend=k0)
        vdk0 = np.sort(np.maximum(vdk0, 1))
        vk0 = k0 + np.concatenate([[0], np.cumsum(vdk0)])
        if two_regions:
            warp = 1.3 if hdr.alter_scale else 1.0
            nb1 = 2 * int(round(temp * math.log2(k2 / k1) / (2.0 * warp)))
            vdk1 = np.diff(np.round(k1 * (k2 / k1) **
                                    ((np.arange(nb1) + 1.0) / nb1))
                           .astype(int), prepend=k1)
            vdk1 = np.sort(np.maximum(vdk1, 1))
            if vdk1.size and vdk1[0] < vdk0[-1]:
                # steal from the first region to keep spacing monotonic
                change = min(int(vdk0[-1] - vdk1[0]),
                             int((vdk1[-1] - vdk1[0]) // 2))
                vdk1[0] += change
                vdk1[-1] -= change
                vdk1 = np.sort(vdk1)
            vk1 = k1 + np.concatenate([[0], np.cumsum(vdk1)])
            master = np.concatenate([vk0, vk1[1:]])
        else:
            master = vk0
    return master.astype(np.int32)


@dataclass
class FreqTables:
    k0: int
    k2: int
    kx: int
    m: int
    f_high: np.ndarray
    f_low: np.ndarray
    f_noise: np.ndarray
    f_lim: np.ndarray
    n_high: int
    n_low: int
    n_q: int
    n_lim: int
    patches: list  # (target_band, source_band, length)


def derive_tables(hdr: SbrHeader, fs: int = FS_SBR) -> FreqTables:
    master = make_f_master(hdr, fs)
    f_high = master[hdr.xover_band:]
    n_high = len(f_high) - 1
    if n_high < 1:
        raise ValueError("empty SBR range")
    kx = int(f_high[0])
    k2 = int(f_high[-1])
    m = k2 - kx
    # low-resolution table
    if n_high & 1:
        f_low = np.concatenate([[f_high[0]], f_high[1::2]])
    else:
        f_low = f_high[::2]
    n_low = len(f_low) - 1
    # noise bands
    n_q = max(1, int(round(hdr.noise_bands * math.log2(max(k2 / kx, 1.001)))))
    n_q = min(n_q, 5)
    idx = np.round(np.linspace(0, n_low, n_q + 1)).astype(int)
    f_noise = f_low[idx]
    # limiter table: union of f_low and patch borders, pruned by octave
    patches = _build_patches(master, kx, m, fs)
    borders = sorted(set([0, m] + [p[0] - kx for p in patches[1:]]
                         + [int(b) - kx for b in f_low]))
    borders = [b for b in borders if 0 <= b <= m]
    if hdr.limiter_bands == 0:
        f_lim = np.array([0, m])
    else:
        oct_frac = [1.2, 2.0, 3.0][hdr.limiter_bands - 1]
        lim = [0]
        for b in borders[1:]:
            if b == m or math.log2((b + kx) / (lim[-1] + kx)) * oct_frac \
                    >= 0.49:
                lim.append(b)
        if lim[-1] != m:
            lim.append(m)
        f_lim = np.array(sorted(set(lim)))
    return FreqTables(k0=int(master[0]), k2=k2, kx=kx, m=m, f_high=f_high,
                      f_low=f_low, f_noise=f_noise, f_lim=f_lim,
                      n_high=n_high, n_low=n_low, n_q=n_q,
                      n_lim=len(f_lim) - 1, patches=patches)


def _build_patches(master, kx, m, fs):
    """Patch map (§4.6.18.6.3): [(target_start, source_start, length)].

    Transcription of the spec patch-construction pseudocode: patches copy
    contiguous source regions starting just below k0 up into [kx, kx+m)."""
    k0 = int(master[0])
    n_master = len(master) - 1
    goal = int(round(2.048e6 / fs))
    if goal < kx + m:
        k = next(i for i, f in enumerate(master) if int(f) >= goal)
    else:
        k = n_master
    patches = []
    msb, usb = k0, kx
    sb = 0
    guard = 0
    while sb != kx + m and guard < 12:
        guard += 1
        j = k + 1
        odd = 0
        while True:
            j -= 1
            sb = int(master[j])
            odd = (sb - 2 + k0) % 2
            if sb <= k0 - 1 + msb - odd or j <= 0:
                break
        length = max(sb - usb, 0)
        start = k0 - odd - length
        if length > 0:
            patches.append((usb, start, length))
            usb = sb
            msb = sb
        else:
            msb = kx
        if int(master[k]) - sb < 3:
            k = n_master
    if not patches:
        patches = [(kx, max(k0 - m, 1), m)]
    return patches


# ----------------------------------------------------------------------
# bitstream data
# ----------------------------------------------------------------------
@dataclass
class SbrData:
    """Per-channel decoded SBR data for one frame."""
    frame_class: int = FIXFIX
    n_env: int = 1
    freq_res: list = field(default_factory=lambda: [1])
    t_e: list = field(default_factory=lambda: [0, NUM_TIME_SLOTS])
    t_q: list = field(default_factory=lambda: [0, NUM_TIME_SLOTS])
    la: int = -1
    df_env: list = field(default_factory=list)
    df_noise: list = field(default_factory=list)
    invf_mode: np.ndarray | None = None
    env: list | None = None             # quantized rows (per envelope)
    noise: np.ndarray | None = None     # [n_noise_env, n_q] quantized
    add_harmonic: np.ndarray | None = None
    amp_res: int = 1                    # effective (header + FIXFIX-1 rule)
    env_lin: list | None = None         # dequantized linear energies
    noise_lin: np.ndarray | None = None

    @property
    def n_noise_env(self) -> int:
        return 1 if self.n_env == 1 else 2


def _ceil_log2(x: int) -> int:
    return max(int(math.ceil(math.log2(max(x, 1)))), 0)


def parse_sbr_grid(br, d: SbrData):
    d.frame_class = br.read(2)
    nts = NUM_TIME_SLOTS
    ptr = 0
    if d.frame_class == FIXFIX:
        tmp = br.read(2)
        d.n_env = 1 << tmp
        if d.n_env > 4:
            # reference decoders reject >4 envelopes outright (truncating
            # would desynchronize every following bitstream field)
            raise ValueError("FIXFIX bs_num_env > 4")
        fr = br.read1()
        d.freq_res = [fr] * d.n_env
        d.t_e = [int(round(i * nts / d.n_env)) for i in range(d.n_env + 1)]
        d.la = -1
    elif d.frame_class == FIXVAR:
        var_bord = br.read(2)
        n_rel = br.read(2)
        d.n_env = n_rel + 1
        rel = [2 * br.read(2) + 2 for _ in range(n_rel)]
        ptr = br.read(_ceil_log2(d.n_env + 1))
        borders = [nts + var_bord]
        for r in rel:
            borders.append(borders[-1] - r)
        d.t_e = [0] + borders[::-1]
        d.freq_res = [br.read1() for _ in range(d.n_env)][::-1]
        d.la = d.n_env + 1 - ptr if ptr > 0 else -1
    elif d.frame_class == VARFIX:
        var_bord = br.read(2)
        n_rel = br.read(2)
        d.n_env = n_rel + 1
        rel = [2 * br.read(2) + 2 for _ in range(n_rel)]
        ptr = br.read(_ceil_log2(d.n_env + 1))
        borders = [var_bord]
        for r in rel:
            borders.append(borders[-1] + r)
        d.t_e = borders + [nts]
        d.freq_res = [br.read1() for _ in range(d.n_env)]
        d.la = ptr - 1 if ptr > 1 else -1
    else:  # VARVAR
        bord0 = br.read(2)
        bord1 = br.read(2)
        n_rel0 = br.read(2)
        n_rel1 = br.read(2)
        d.n_env = n_rel0 + n_rel1 + 1
        rel0 = [2 * br.read(2) + 2 for _ in range(n_rel0)]
        rel1 = [2 * br.read(2) + 2 for _ in range(n_rel1)]
        ptr = br.read(_ceil_log2(d.n_env + 1))
        left = [bord0]
        for r in rel0:
            left.append(left[-1] + r)
        right = [nts + bord1]
        for r in rel1:
            right.append(right[-1] - r)
        # spec order, no dedup: freq_res count and the lA pointer mapping
        # both use the bitstream envelope count; a grid with coincident
        # borders is malformed and gets rejected by the validator below
        d.t_e = left + right[::-1]
        d.freq_res = [br.read1() for _ in range(d.n_env)]
        d.la = d.n_env + 1 - ptr if ptr > 0 else -1
    if d.n_env < 1 or len(d.t_e) != d.n_env + 1 or \
            any(b < 0 or b > nts + 3 for b in d.t_e) or \
            any(d.t_e[i] >= d.t_e[i + 1] for i in range(d.n_env)):
        raise ValueError("bad SBR grid")
    # noise borders: start, middle, end — middle per faad middleBorder()
    if d.n_env == 1:
        d.t_q = [d.t_e[0], d.t_e[-1]]
    else:
        if d.frame_class == FIXFIX:
            mid = d.n_env // 2
        elif d.frame_class == VARFIX:
            mid = 1 if ptr == 0 else (d.n_env - 1 if ptr == 1 else ptr - 1)
        else:  # FIXVAR / VARVAR
            mid = d.n_env + 1 - ptr if ptr > 1 else d.n_env - 1
        mid = max(1, min(mid, d.n_env - 1))
        d.t_q = [d.t_e[0], d.t_e[mid], d.t_e[-1]]


def parse_sbr_dtdf(br, d: SbrData):
    d.df_env = [br.read1() for _ in range(d.n_env)]
    d.df_noise = [br.read1() for _ in range(d.n_noise_env)]


def parse_sbr_invf(br, d: SbrData, ft: FreqTables):
    d.invf_mode = np.array([br.read(2) for _ in range(ft.n_q)])


def _env_tables(amp_res: int, balance: bool):
    if balance:
        return (HUFF_BAL15_T, HUFF_BAL15_F, 24) if amp_res == 0 else \
            (HUFF_BAL30_T, HUFF_BAL30_F, 12)
    return (HUFF_ENV15_T, HUFF_ENV15_F, 60) if amp_res == 0 else \
        (HUFF_ENV30_T, HUFF_ENV30_F, 31)


def parse_sbr_envelope(br, d: SbrData, ft: FreqTables, amp_res: int,
                       prev_env: np.ndarray | None, balance: bool = False):
    t_huff, f_huff, center = _env_tables(amp_res, balance)
    start_bits = (7 if amp_res == 0 else 6)
    if balance:
        start_bits = (5 if amp_res == 1 else 6)
    rows = []
    for e in range(d.n_env):
        nb = ft.n_high if d.freq_res[e] else ft.n_low
        row = np.zeros(nb, np.int32)
        if d.df_env[e] == 0:  # delta in frequency
            row[0] = br.read(start_bits)
            if balance:
                row[0] *= 2
            for b in range(1, nb):
                delta = f_huff.decode(br) - center
                row[b] = row[b - 1] + (delta * 2 if balance else delta)
        else:  # delta in time
            prev = rows[e - 1] if e > 0 else prev_env
            if prev is None:
                raise ValueError("df time with no previous envelope")
            prev_m = _map_res(prev, d.freq_res[e], ft)
            for b in range(nb):
                delta = t_huff.decode(br) - center
                row[b] = prev_m[b] + (delta * 2 if balance else delta)
        rows.append(row)
    d.env = rows


def parse_sbr_noise(br, d: SbrData, ft: FreqTables,
                    prev_noise: np.ndarray | None, balance: bool = False):
    t_huff = HUFF_NOISE_BAL_T if balance else HUFF_NOISE_T
    f_huff = HUFF_NOISE_BAL_F if balance else HUFF_NOISE_F
    center = 12 if balance else 31
    rows = []
    for e in range(d.n_noise_env):
        row = np.zeros(ft.n_q, np.int32)
        if d.df_noise[e] == 0:
            row[0] = br.read(5)
            if balance:
                row[0] *= 2
            for b in range(1, ft.n_q):
                delta = f_huff.decode(br) - center
                row[b] = row[b - 1] + (delta * 2 if balance else delta)
        else:
            prev = rows[e - 1] if e > 0 else prev_noise
            if prev is None:
                raise ValueError("noise df time with no previous")
            for b in range(ft.n_q):
                delta = t_huff.decode(br) - center
                row[b] = prev[b] + (delta * 2 if balance else delta)
        rows.append(row)
    d.noise = np.stack(rows)


def _map_res(row: np.ndarray, freq_res: int, ft: FreqTables) -> np.ndarray:
    """Map an envelope row (at whatever resolution it has) to freq_res."""
    if freq_res == 1:
        if len(row) == ft.n_high:
            return row
        # low → high: repeat per containing low band
        out = np.zeros(ft.n_high, row.dtype)
        for b in range(ft.n_high):
            lo = ft.f_high[b]
            j = int(np.searchsorted(ft.f_low, lo, "right") - 1)
            out[b] = row[min(max(j, 0), len(row) - 1)]
        return out
    if len(row) == ft.n_low:
        return row
    out = np.zeros(ft.n_low, row.dtype)
    for b in range(ft.n_low):
        lo = ft.f_low[b]
        j = int(np.searchsorted(ft.f_high, lo, "right") - 1)
        out[b] = row[min(max(j, 0), len(row) - 1)]
    return out


# ----------------------------------------------------------------------
# payload parse + dequantization
# ----------------------------------------------------------------------
def parse_sbr_header(br) -> SbrHeader:
    h = SbrHeader()
    h.amp_res = br.read1()
    h.start_freq = br.read(4)
    h.stop_freq = br.read(4)
    h.xover_band = br.read(3)
    br.read(2)  # bs_reserved
    extra1 = br.read1()
    extra2 = br.read1()
    if extra1:
        h.freq_scale = br.read(2)
        h.alter_scale = br.read1()
        h.noise_bands = br.read(2)
    if extra2:
        h.limiter_bands = br.read(2)
        h.limiter_gains = br.read(2)
        h.interpol_freq = br.read1()
        h.smoothing_mode = br.read1()
    return h


def parse_sbr_payload(br, stereo: bool, decs: list) -> list | None:
    """Parse one HDC SBR payload (runs to the end of the packet; no
    bs_extension_type/CRC prefix — patch:549-571).

    Returns per-channel SbrData with dequantized energies, or None when
    no header has been received yet (caller falls back to upsampling)."""
    if br.read1():  # bs_header_flag
        hdr = parse_sbr_header(br)
        for dec in decs:
            dec.set_header(hdr)
    if decs[0].header is None:
        return None
    hdr = decs[0].header
    ft = decs[0].tables

    if not stereo:
        d = SbrData()
        if br.read1():          # bs_data_extra
            br.read(4)
        br.read1()              # HDC extra bit (patch:577-582)
        parse_sbr_grid(br, d)
        d.amp_res = 0 if (d.frame_class == FIXFIX and d.n_env == 1) \
            else hdr.amp_res
        parse_sbr_dtdf(br, d)
        parse_sbr_invf(br, d, ft)
        parse_sbr_envelope(br, d, ft, d.amp_res, decs[0].prev_env)
        parse_sbr_noise(br, d, ft, decs[0].prev_noise)
        _parse_harmonics(br, d, ft)
        _skip_extended(br)
        _dequant_single(d)
        if br.overrun():
            raise ValueError("SBR payload overrun")
        return [d]

    d0, d1 = SbrData(), SbrData()
    if br.read1():              # bs_data_extra
        br.read(4)
        br.read(4)
    coupled = br.read1()
    if coupled:
        parse_sbr_grid(br, d0)
        for f in ("frame_class", "n_env", "freq_res", "t_e", "t_q", "la"):
            setattr(d1, f, getattr(d0, f))
        for d in (d0, d1):
            d.amp_res = 0 if (d.frame_class == FIXFIX and d.n_env == 1) \
                else hdr.amp_res
        parse_sbr_dtdf(br, d0)
        parse_sbr_dtdf(br, d1)
        parse_sbr_invf(br, d0, ft)
        d1.invf_mode = d0.invf_mode.copy()
        parse_sbr_envelope(br, d0, ft, d0.amp_res, decs[0].prev_env)
        parse_sbr_noise(br, d0, ft, decs[0].prev_noise)
        parse_sbr_envelope(br, d1, ft, d1.amp_res, decs[1].prev_env,
                           balance=True)
        parse_sbr_noise(br, d1, ft, decs[1].prev_noise, balance=True)
        _parse_harmonics(br, d0, ft)
        _parse_harmonics(br, d1, ft)
        _dequant_coupled(d0, d1)
    else:
        parse_sbr_grid(br, d0)
        parse_sbr_grid(br, d1)
        for d in (d0, d1):
            d.amp_res = 0 if (d.frame_class == FIXFIX and d.n_env == 1) \
                else hdr.amp_res
        parse_sbr_dtdf(br, d0)
        parse_sbr_dtdf(br, d1)
        parse_sbr_invf(br, d0, ft)
        parse_sbr_invf(br, d1, ft)
        parse_sbr_envelope(br, d0, ft, d0.amp_res, decs[0].prev_env)
        parse_sbr_envelope(br, d1, ft, d1.amp_res, decs[1].prev_env)
        parse_sbr_noise(br, d0, ft, decs[0].prev_noise)
        parse_sbr_noise(br, d1, ft, decs[1].prev_noise)
        _parse_harmonics(br, d0, ft)
        _parse_harmonics(br, d1, ft)
        _dequant_single(d0)
        _dequant_single(d1)
    _skip_extended(br)
    if br.overrun():
        raise ValueError("SBR payload overrun")
    return [d0, d1]


def _parse_harmonics(br, d: SbrData, ft: FreqTables):
    if br.read1():
        d.add_harmonic = np.array([br.read1() for _ in range(ft.n_high)],
                                  bool)


def _skip_extended(br):
    if br.read1():
        cnt = br.read(4)
        if cnt == 15:
            cnt += br.read(8)
        br.skip(8 * cnt)


def _dequant_single(d: SbrData):
    a = 2.0 if d.amp_res == 0 else 1.0
    d.env_lin = [64.0 * 2.0 ** (row / a) for row in d.env]
    d.noise_lin = 2.0 ** (NOISE_FLOOR_OFFSET - d.noise.astype(np.float64))


def _dequant_coupled(d0: SbrData, d1: SbrData):
    """Coupled-stereo dequantization: channel 0 carries the sum level,
    channel 1 the balance (§4.6.18.3.3; balance values doubled on the
    shared grid at parse time, center 24/48)."""
    a = 2.0 if d0.amp_res == 0 else 1.0
    center = 48.0 if d0.amp_res == 0 else 24.0
    env_l, env_r = [], []
    for e in range(d0.n_env):
        e0 = 64.0 * 2.0 ** (d0.env[e] / a)
        ratio = 2.0 ** ((d1.env[e] - center) / a)
        env_l.append(2.0 * e0 / (1.0 + ratio))
        env_r.append(2.0 * e0 * ratio / (1.0 + ratio))
    q0 = 2.0 ** (NOISE_FLOOR_OFFSET - d0.noise.astype(np.float64))
    qratio = 2.0 ** ((d1.noise.astype(np.float64) - 24.0) / 1.0)
    d0.env_lin, d1.env_lin = env_l, env_r
    d0.noise_lin = 2.0 * q0 / (1.0 + qratio)
    d1.noise_lin = 2.0 * q0 * qratio / (1.0 + qratio)


class SBRDecoder:
    """Per-channel SBR state: QMF banks, header persistence, HF chain."""

    def __init__(self):
        self.analysis = QMFAnalysis()
        self.synthesis = QMFSynthesis()
        self.header: SbrHeader | None = None
        self.tables: FreqTables | None = None
        self.prev_env: np.ndarray | None = None
        self.prev_noise: np.ndarray | None = None
        # high bands whose sinusoid was signaled last frame (§4.6.18.7.5:
        # a flagged harmonic only starts in envelopes >= lA the frame it
        # first appears, then persists from envelope 0)
        self.prev_harmonics: np.ndarray | None = None
        self.bw = np.zeros(5)
        self.x_low_tail = np.zeros((2, 32), np.complex128)  # LPC history
        self.noise_index = 0
        # bs_smoothing_mode=0 gain/noise trajectories (4 slots of carry)
        self._g_hist: np.ndarray | None = None
        self._q_hist: np.ndarray | None = None
        # prev frame ended on a transient (l_A == n_env): envelope 0 of
        # THIS frame counts as transient (ffmpeg e_a[0] carry)
        self._prev_la_end = False

    # ------------------------------------------------------------------
    def upsample_only(self, core: np.ndarray) -> np.ndarray:
        """1024 samples @22050 → 2048 @44100 through the QMF pair with
        the top 32 bands zeroed (faad forceUpSampling behavior)."""
        sub = self.analysis.run(core.astype(np.float64))
        X = np.zeros((sub.shape[0], 64), np.complex128)
        X[:, :32] = sub
        return self.synthesis.run(X).astype(np.float32)

    # ------------------------------------------------------------------
    def set_header(self, hdr: SbrHeader):
        if self.header is None or hdr != self.header:
            self.header = hdr
            self.tables = derive_tables(hdr)
            self.prev_env = None
            self.prev_noise = None
            self.prev_harmonics = None
            self._g_hist = None
            self._q_hist = None
            self._prev_la_end = False

    def process(self, core: np.ndarray, data: SbrData) -> np.ndarray:
        """Full SBR reconstruction for one channel/frame."""
        hdr, ft = self.header, self.tables
        x_low = self.analysis.run(core.astype(np.float64))  # [32, 32]
        X = np.zeros((NUM_SLOTS, 64), np.complex128)
        n_low = min(ft.kx, 32)  # kx can legally exceed the 32 analysis bands
        X[:, :n_low] = x_low[:, :n_low]

        x_hist = np.concatenate([self.x_low_tail, x_low])  # [34, 32]
        self.x_low_tail = x_low[-2:].copy()

        x_high = self._hf_generate(x_hist, data)
        self._hf_adjust(X, x_high, data)
        out = self.synthesis.run(X)

        self.prev_env = data.env[-1]
        self.prev_noise = data.noise[-1]
        self.prev_harmonics = (
            data.add_harmonic if data.add_harmonic is not None
            else np.zeros(ft.n_high, bool))
        return out.astype(np.float32)

    # ------------------------------------------------------------------
    def _hf_generate(self, x_hist: np.ndarray, data: SbrData) -> np.ndarray:
        """Patch + chirped order-2 LPC extension (§4.6.18.6).

        x_hist: [2 + 32, 32] low subbands incl. 2 history slots.
        Returns X_high [32, m] (bands kx..kx+m)."""
        ft = self.tables
        # chirp factors per noise band, smoothed across frames
        new_bw = np.array([(0.0, 0.75, 0.9, 0.98)[m]
                           for m in data.invf_mode])
        prev = self.bw[:len(new_bw)]
        bw = np.where(new_bw < prev, 0.75 * new_bw + 0.25 * prev,
                      0.90625 * new_bw + 0.09375 * prev)
        bw = np.where(bw < 0.015625, 0.0, bw)
        self.bw = np.zeros(5)
        self.bw[:len(bw)] = bw

        # order-2 LPC per source band (covariance method over the frame)
        nsrc = 32
        a0 = np.zeros(nsrc, np.complex128)
        a1 = np.zeros(nsrc, np.complex128)
        x = x_hist  # [34, 32]
        for k in range(1, min(ft.kx + 1, nsrc)):
            v = x[:, k]
            p01 = np.vdot(v[1:-1], v[2:])     # Σ x[n]·conj(x[n-1])
            p11 = np.vdot(v[1:-1], v[1:-1]).real
            p02 = np.vdot(v[:-2], v[2:])
            p12 = np.vdot(v[:-2], v[1:-1])
            p22 = np.vdot(v[:-2], v[:-2]).real
            d = p22 * p11 - (abs(p12) ** 2) / 1.000001
            if abs(d) > EPS:
                alpha1 = (p01 * p12 - p02 * p11) / d
            else:
                alpha1 = 0.0
            alpha0 = -(p01 + alpha1 * np.conj(p12)) / p11 \
                if abs(p11) > EPS else 0.0
            if abs(alpha0) >= 4 or abs(alpha1) >= 4:
                alpha0 = alpha1 = 0.0
            a0[k], a1[k] = alpha0, alpha1

        x_high = np.zeros((NUM_SLOTS, ft.m), np.complex128)
        for (t, src0, length) in ft.patches:
            for q in range(length):
                tgt = t + q - ft.kx
                p = src0 + q
                if not (0 <= tgt < ft.m) or p >= nsrc:
                    continue
                # noise band of the target → chirp
                nb = int(np.searchsorted(ft.f_noise, t + q, "right") - 1)
                b = bw[min(max(nb, 0), len(bw) - 1)]
                v = x[:, p]
                x_high[:, tgt] = (v[2:] + b * a0[p] * v[1:-1]
                                  + b * b * a1[p] * v[:-2])
        return x_high

    # ------------------------------------------------------------------
    def _hf_adjust(self, X: np.ndarray, x_high: np.ndarray, data: SbrData):
        """Envelope/noise/sinusoid/gain application (§4.6.18.7), with the
        limiter and boost per limiter band; bs_smoothing_mode=0 applies
        the 5-tap h_smooth filter over the per-slot gain/noise
        trajectories (§4.6.18.7.5) with 4 slots of cross-frame carry."""
        hdr, ft = self.header, self.tables
        lim_gain = LIM_GAINS[hdr.limiter_gains]
        kx, m = ft.kx, ft.m

        g_slot = np.zeros((NUM_SLOTS, m))
        q_slot = np.zeros((NUM_SLOTS, m))     # raw Q_M (post limit/boost)
        gate_slot = np.zeros((NUM_SLOTS, m))  # delta * (1 - s_mapped)
        s_slot = np.zeros((NUM_SLOTS, m))
        covered = np.zeros(NUM_SLOTS, bool)
        smooth_ok = np.zeros(NUM_SLOTS, bool)  # filter bypass: transients

        for e in range(data.n_env):
            lo, hi = data.t_e[e] * RATE, data.t_e[e + 1] * RATE
            lo, hi = max(lo, 0), min(hi, NUM_SLOTS)
            if hi <= lo:
                continue
            # dequantized target energies mapped per QMF bin
            row = data.env_lin[e]
            bands = ft.f_high if data.freq_res[e] else ft.f_low
            e_orig = np.zeros(m)
            for b in range(len(bands) - 1):
                e_orig[int(bands[b]) - kx:int(bands[b + 1]) - kx] = row[b]
            # noise floor envelope containing this envelope's start
            qe = 0 if data.n_noise_env == 1 or data.t_e[e] < data.t_q[1] \
                else 1
            q_orig = np.zeros(m)
            for b in range(ft.n_q):
                q_orig[int(ft.f_noise[b]) - kx:
                       int(ft.f_noise[b + 1]) - kx] = data.noise_lin[qe][b]

            # sinusoids: S present in a high band when flagged (placed
            # at the band's center bin).  A harmonic signaled for the
            # FIRST time this frame is only active in envelopes >= lA;
            # one carried over from the previous frame is active from
            # envelope 0 (§4.6.18.7.5, faad s_index_mapped logic).
            s_mapped = np.zeros(m, bool)
            s_bins = np.zeros(m, bool)
            if data.add_harmonic is not None:
                prev = self.prev_harmonics
                if prev is None or len(prev) != ft.n_high:
                    prev = np.zeros(ft.n_high, bool)
                for b in range(ft.n_high):
                    if data.add_harmonic[b] and (e >= data.la or prev[b]):
                        blo = int(ft.f_high[b]) - kx
                        bhi = int(ft.f_high[b + 1]) - kx
                        s_mapped[blo:bhi] = True
                        s_bins[(blo + bhi) // 2] = True

            # current energy estimate per bin over the envelope; with
            # bs_interpol_freq off, the estimate is instead averaged over
            # each SBR band of this envelope's resolution (§4.6.18.7.2)
            # so gains are flat per band, matching the encoder's model
            seg = x_high[lo:hi]
            e_curr = (np.abs(seg) ** 2).mean(axis=0)
            if not hdr.interpol_freq:
                for b in range(len(bands) - 1):
                    s = slice(int(bands[b]) - kx, int(bands[b + 1]) - kx)
                    if s.stop > s.start:
                        e_curr[s] = e_curr[s].mean()

            # transient envelopes: this frame's l_A, or envelope 0 when
            # the previous frame's l_A sat at its end (ffmpeg e_a[0] /
            # faad prevEnvIsShort carry) — noise off, smoothing bypassed
            transient = (e == data.la) or (e == 0 and self._prev_la_end)
            delta = 0.0 if transient else 1.0
            q_frac = q_orig / (1.0 + q_orig)
            gain = np.where(
                s_mapped,
                np.sqrt(e_orig * q_frac / (1.0 + e_curr)),
                np.sqrt(e_orig / ((1.0 + e_curr)
                                  * (1.0 + delta * q_orig))))
            q_m = np.sqrt(e_orig * q_frac)
            s_m = np.where(s_bins,
                           np.sqrt(e_orig / (1.0 + q_orig)), 0.0)

            # limiter per limiter band: G_max from average energies
            for lb in range(ft.n_lim):
                s = slice(int(ft.f_lim[lb]), int(ft.f_lim[lb + 1]))
                if s.stop <= s.start:
                    continue
                g_max = min(lim_gain * math.sqrt(
                    (EPS + e_orig[s].sum()) / (EPS + e_curr[s].sum())),
                    1e10)
                clipped = gain[s] > g_max
                q_m[s] = np.where(clipped, q_m[s] * g_max /
                                  np.maximum(gain[s], EPS), q_m[s])
                gain[s] = np.minimum(gain[s], g_max)
                # boost so the limited band still meets its energy target
                got = (gain[s] ** 2 * e_curr[s]).sum() \
                    + delta * (q_m[s] ** 2 * (~s_mapped[s])).sum() \
                    + (s_m[s] ** 2).sum()
                boost = min(math.sqrt((EPS + e_orig[s].sum())
                                      / (EPS + got)), MAX_BOOST)
                gain[s] *= boost
                q_m[s] *= boost
                s_m[s] *= boost

            g_slot[lo:hi] = gain
            q_slot[lo:hi] = q_m
            gate_slot[lo:hi] = delta * (~s_mapped)
            s_slot[lo:hi] = s_m
            covered[lo:hi] = True
            smooth_ok[lo:hi] = not transient

        self._prev_la_end = data.la == data.n_env

        if not hdr.smoothing_mode:
            # temporal smoothing: filter the raw trajectories (history
            # advances with raw values), select raw on transient
            # envelopes, then gate (noise off where a sinusoid sits /
            # on transient envelopes)
            if self._g_hist is None or self._g_hist.shape[1] != m:
                self._g_hist = np.zeros((4, m))
                self._q_hist = np.zeros((4, m))
            gt = np.concatenate([self._g_hist, g_slot])
            qt = np.concatenate([self._q_hist, q_slot])
            g_f = sum(H_SMOOTH[j] * gt[4 - j:4 - j + NUM_SLOTS]
                      for j in range(5))
            q_f = sum(H_SMOOTH[j] * qt[4 - j:4 - j + NUM_SLOTS]
                      for j in range(5))
            self._g_hist, self._q_hist = gt[-4:].copy(), qt[-4:].copy()
            ok = smooth_ok[:, None]
            g_slot = np.where(ok, g_f, g_slot)
            q_slot = np.where(ok, q_f, q_slot)

        # apply: signal gain + noise filling + sinusoids
        for sl in range(NUM_SLOTS):
            if not covered[sl]:
                continue
            X[sl, kx:kx + m] = x_high[sl] * g_slot[sl]
            idx = (self.noise_index + 1 + np.arange(m)) & 511
            self.noise_index = int(idx[-1])
            X[sl, kx:kx + m] += gate_slot[sl] * q_slot[sl] \
                * NOISE_TABLE[idx]
            if s_slot[sl].any():
                phase = 1j ** ((sl + np.arange(m)) & 3)
                X[sl, kx:kx + m] += s_slot[sl] * phase
