"""The device stage of batched HDC -> PCM (kernel K16) on PyTorch.

PyTorch counterpart of ``_make_device_fn`` and its static tables in
``nrsc5_tpu/audio/batch.py`` (:47-512).  Per lane (program x channel) and
packet, with carried state, the stage runs:

1. the IMDCT as two basis products (``torch.matmul``, full float32);
2. K16a :func:`window_qmf_analysis`: window LUT by index, short-window
   placement, overlap-add, then the 32-band QMF analysis straight from
   ``[qa_hist | core]``;
3. K16b :func:`sbr_hf_generate`: covariance LPC per (lane, packet, band),
   the guards, the patch gather with the chirp;
4. K16c :func:`sbr_hf_adjust`: envelope, noise and sinusoid gains, the
   limiter and boost, the optional 5-tap smoothing, noise and sinusoid
   phasors, and the assembled 64-band input X;
5. the synthesis modulation as two products and a subtraction
   (``torch.matmul``), then K16d :func:`qmf_synthesis`: the 10-tap fold and
   the int16 round-half-even clip.

Each kernel wrapper takes its plain PyTorch version (``*_plain``) for a
CPU tensor; on a CUDA tensor it launches the hand-written kernel of
``csrc/`` or raises.  The plain versions sum their short axes (the 320
analysis taps, the 34 LPC slots, the slots of an envelope, the bins of a
band, the five envelopes, the 10 synthesis taps) one term at a time in the
kernels' order, so that kernel and plain version agree bit for bit on the
card.  The band -> bin expansions, which the reference writes as products
with 0/1 indicator matrices, are gathers here: each bin belongs to at most
one band, so the products add exact zeros and the gather gives the same
value.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.audio import aac_core as A
from nrsc5_tpu_torch.audio import aac_tables as T
from nrsc5_tpu_torch.audio import sbr as S
from nrsc5_tpu_torch.ops import rcplx as rc

NSLOT = S.NUM_SLOTS  # 32 QMF subsamples per packet
MAXENV = 5
QA_HIST = 288        # QMF32 analysis history (320 taps - 32)
SYN_HIST = 9         # QMF64 synthesis history (10 taps - 1)


# ----------------------------------------------------------------------
# static tables (copies of nrsc5_tpu/audio/batch.py:49-158)
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _imdct_long() -> np.ndarray:
    # time = (2/n)·B@X, then filterbank 0.5 scale -> (1/n)·B
    return (A._mdct_basis(A.FRAME_LEN) / A.FRAME_LEN).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _imdct_short() -> np.ndarray:
    return (A._mdct_basis(A.SHORT_LEN) / A.SHORT_LEN).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _qmf_analysis_kernel() -> np.ndarray:
    """[320, 64] real kernel: X[s,k] = Σ_τ ext[32s+τ]·KA[τ,k]
    (window fold + modulation combined; KA[:, :32]=re, [:, 32:]=im)."""
    win = T.SBR_QMF_WINDOW_US[::2].astype(np.float64) * 2.0
    mod = S._analysis_mod()  # [64, 32]
    ka = np.zeros((320, 64))
    for tau in range(320):
        j = 319 - tau
        m = mod[j % 64]  # [32]
        ka[tau, :32] = win[j] * m.real
        ka[tau, 32:] = win[j] * m.imag
    return ka.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _synthesis_mod_ri():
    sm = S._synthesis_mod()  # [64, 128]
    return (sm.real.astype(np.float32) / 64.0,
            sm.imag.astype(np.float32) / 64.0)


@functools.lru_cache(maxsize=None)
def _synthesis_taps():
    """cidx [10, 64] int32 / W [10, 64] f32: out_block[s, i] =
    Σ_d V[s-d, cidx[d, i]]·W[d, i] (the v-history gather of
    sbr.QMFSynthesis as a dense tap structure)."""
    win = T.SBR_QMF_WINDOW_US.astype(np.float64)
    cidx = np.zeros((10, 64), np.int32)
    w = np.zeros((10, 64))
    i = np.arange(64)
    for d in range(10):
        if d % 2 == 0:
            n = d // 2
            cidx[d] = i
            w[d] = win[128 * n + i]
        else:
            n = (d - 1) // 2
            cidx[d] = 64 + i
            w[d] = win[128 * n + 64 + i]
    return cidx, w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _long_window(seq: int, shape: int, prev: int) -> np.ndarray:
    return A.build_window(seq, shape, prev).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _short_windows(shape: int, prev: int) -> np.ndarray:
    wl = A.window(prev, A.SHORT_LEN)
    wc = A.window(shape, A.SHORT_LEN)
    out = np.empty((8, 256), np.float32)
    for w in range(8):
        out[w] = np.concatenate([wl[:128] if w == 0 else wc[:128],
                                 wc[128:]])
    return out


# The MDCT windows are pure functions of (window_sequence, shape,
# prev_shape), 2 bits each: they live on the device as small LUTs and the
# host sends one uint8 index per (lane, packet).  Index 0 is the all-zero
# window (inactive or corrupt-packet lanes).

def _long_window_index(seq: int, shape: int, prev: int) -> int:
    li = {A.ONLY_LONG: 0, A.LONG_START: 1, A.LONG_STOP: 2}[seq]
    return 1 + li * 4 + shape * 2 + prev


@functools.lru_cache(maxsize=1)
def _long_window_lut() -> np.ndarray:
    lut = np.zeros((13, 2048), np.float32)
    for seq in (A.ONLY_LONG, A.LONG_START, A.LONG_STOP):
        for shape in (0, 1):
            for prev in (0, 1):
                lut[_long_window_index(seq, shape, prev)] = \
                    _long_window(seq, shape, prev)
    return lut


def _short_window_index(shape: int, prev: int) -> int:
    return 1 + shape * 2 + prev


@functools.lru_cache(maxsize=1)
def _short_window_lut() -> np.ndarray:
    lut = np.zeros((5, 8, 256), np.float32)
    for shape in (0, 1):
        for prev in (0, 1):
            lut[_short_window_index(shape, prev)] = \
                _short_windows(shape, prev)
    return lut


def band_maps(ft: S.FreqTables) -> dict:
    """The per-header maps of the reference's device fn (batch.py:178-210)
    in index form: for each of the m SBR bins its high, low and noise
    band, the high band whose centre bin it is (sinusoid placement) and
    its limiter band (-1 where none); band widths (``w_hi``, ``w_lo``);
    the patch source band and its validity per target bin."""
    kx, m = ft.kx, ft.m

    def band_of(bands, nb):
        idx = np.full(m, -1, np.int32)
        for b in range(nb):
            idx[int(bands[b]) - kx:int(bands[b + 1]) - kx] = b
        return idx

    def width(idx, nb):  # bins of each band, at least 1
        return np.maximum(np.bincount(idx[idx >= 0], minlength=nb),
                          1).astype(np.float32)
    band_hi = band_of(ft.f_high, ft.n_high)
    band_lo = band_of(ft.f_low, ft.n_low)
    src_idx = np.full(m, 0, np.int32)
    src_ok = np.zeros(m, np.float32)
    for (t, src0, length) in ft.patches:
        for q in range(length):
            tgt = t + q - kx
            p = src0 + q
            if 0 <= tgt < m and p < 32:
                src_idx[tgt] = p
                src_ok[tgt] = 1.0
    lim = np.full(m, -1, np.int32)
    for lb in range(ft.n_lim):
        lim[int(ft.f_lim[lb]):int(ft.f_lim[lb + 1])] = lb
    hb_lo = ft.f_high[:-1].astype(int) - kx
    hb_mid = (hb_lo + (ft.f_high[1:].astype(int) - kx)) // 2
    sin_band = np.full(m, -1, np.int32)
    for b in range(ft.n_high):
        sin_band[int(hb_mid[b])] = b
    return {"band_hi": band_hi, "band_lo": band_lo,
            "band_noise": band_of(ft.f_noise, ft.n_q),
            "sin_band": sin_band, "lim_band": lim,
            "w_hi": width(band_hi, ft.n_high),
            "w_lo": width(band_lo, ft.n_low),
            "src_idx": src_idx, "src_ok": src_ok,
            "hi_span": band_spans(band_hi), "lo_span": band_spans(band_lo),
            "lim_span": band_spans(lim)}


def band_spans(idx: np.ndarray) -> np.ndarray:
    """int32 [m, 2]: for each bin, the first bin of its band and one past
    its last (0, 0 where it has none), from its band index map ``idx``
    (-1 for none).  Every band is a run of bins, so a sum over a band's
    bins in bin order is a sum over its span (K16c sums so)."""
    spans = np.zeros((len(idx), 2), np.int32)
    for b in np.unique(idx[idx >= 0]):
        bins = np.flatnonzero(idx == b)
        if bins[-1] - bins[0] + 1 != len(bins):
            raise ValueError(f"band {b} is not a run of bins")
        spans[bins] = (bins[0], bins[-1] + 1)
    return spans


def _f32(x: float) -> float:
    """x rounded to float32, as the reference's weakly typed constants."""
    return float(np.float32(x))


EPS = _f32(S.EPS)
MAX_BOOST = _f32(S.MAX_BOOST)
G_MAX_CAP = _f32(1e10)
LPC_DIV = _f32(1.000001)
H_SMOOTH = tuple(_f32(h) for h in S.H_SMOOTH)


# ----------------------------------------------------------------------
# K16a: window, overlap-add, QMF32 analysis
# ----------------------------------------------------------------------
def analysis_input(long_raw, short_raw, win_long_idx, win_short_idx,
                   short, overlap, qa_hist, lut_long, lut_short):
    """The first half of K16a's plain version: the windowed IMDCT output,
    the short windows placed at 448 + 128 w (added in window order), the
    long/short select and the overlap-add.  Returns (ext [N, 288 + 1024K]
    = [qa_hist | core], new overlap [N, 1024])."""
    n, kp = long_raw.shape[:2]
    long_buf = long_raw * lut_long[win_long_idx.long()]
    sh = short_raw * lut_short[win_short_idx.long()]
    short_buf = torch.zeros_like(long_buf)
    for w in range(8):
        o = A.SHORT_OFF + w * A.SHORT_LEN
        short_buf[..., o:o + 256] = short_buf[..., o:o + 256] + sh[:, :, w]
    buf = torch.where(short[..., None], short_buf, long_buf)
    tails = torch.cat([overlap[:, None], buf[:, :-1, 1024:]], dim=1)
    core = buf[..., :1024] + tails
    ext = torch.cat([qa_hist, core.reshape(n, kp * 1024)], dim=1)
    return ext, buf[:, -1, 1024:].contiguous()


def window_qmf_analysis_plain(long_raw, short_raw, win_long_idx,
                              win_short_idx, short, overlap, qa_hist,
                              lut_long, lut_short, ka):
    """Plain version of K16a (the reference's :221-257).

    long_raw f32 [N, K, 2048] and short_raw [N, K, 8, 256]: the IMDCT
    products; win_long_idx, win_short_idx uint8 [N, K]; short bool [N, K];
    overlap [N, 1024]; qa_hist [N, 288]; the window LUTs [13, 2048] and
    [5, 8, 256]; ka [320, 64].  Returns (xl [N, 32K, 64], new overlap, new
    qa_hist).  Each output sums its 320 taps in tap order."""
    ext, new_overlap = analysis_input(long_raw, short_raw, win_long_idx,
                                      win_short_idx, short, overlap, qa_hist,
                                      lut_long, lut_short)
    s_tot = long_raw.shape[1] * NSLOT
    span = 32 * (s_tot - 1) + 1
    acc = ext[:, 0:span:32, None] * ka[0]
    for tau in range(1, 320):
        acc = acc + ext[:, tau:tau + span:32, None] * ka[tau]
    return acc, new_overlap, ext[:, -QA_HIST:].contiguous()


def window_qmf_analysis(long_raw, short_raw, win_long_idx, win_short_idx,
                        short, overlap, qa_hist, lut_long, lut_short, ka,
                        plain: bool = False):
    """K16a: the arguments and results of
    :func:`window_qmf_analysis_plain`.  A CPU tensor (or ``plain``) takes
    the plain version; a CUDA tensor launches the kernel (a persistent
    grid, 4 (lane, packet) items a CTA at a time, KA in shared memory),
    which takes 16-byte aligned tensors."""
    if plain or long_raw.device.type == "cpu":
        return window_qmf_analysis_plain(
            long_raw, short_raw, win_long_idx, win_short_idx, short,
            overlap, qa_hist, lut_long, lut_short, ka)
    n, kp = long_raw.shape[:2]
    K.check(long_raw, "long_raw", torch.float32, (n, kp, 2048))
    K.check(short_raw, "short_raw", torch.float32, (n, kp, 8, 256))
    K.check(win_long_idx, "win_long_idx", torch.uint8, (n, kp))
    K.check(win_short_idx, "win_short_idx", torch.uint8, (n, kp))
    K.check(short, "short", torch.bool, (n, kp))
    K.check(overlap, "overlap", torch.float32, (n, 1024))
    K.check(qa_hist, "qa_hist", torch.float32, (n, QA_HIST))
    K.check(lut_long, "lut_long", torch.float32, (13, 2048))
    K.check(lut_short, "lut_short", torch.float32, (5, 8, 256))
    K.check(ka, "ka", torch.float32, (320, 64))
    for name, t in (("long_raw", long_raw), ("short_raw", short_raw),
                    ("overlap", overlap), ("qa_hist", qa_hist),
                    ("lut_long", lut_long), ("lut_short", lut_short),
                    ("ka", ka)):
        if t.data_ptr() % 16:  # the kernel loads 16 bytes at a time
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    dev = long_raw.device
    xl = torch.empty(n, kp * NSLOT, 64, device=dev)
    new_overlap = torch.empty(n, 1024, device=dev)
    new_qa = torch.empty(n, QA_HIST, device=dev)
    K.launch("aac_window_qmf_analysis", long_raw.data_ptr(),
             short_raw.data_ptr(), win_long_idx.data_ptr(),
             win_short_idx.data_ptr(), short.data_ptr(), overlap.data_ptr(),
             qa_hist.data_ptr(), lut_long.data_ptr(), lut_short.data_ptr(),
             ka.data_ptr(), xl.data_ptr(), new_overlap.data_ptr(),
             new_qa.data_ptr(), n, kp, device=dev)
    return xl, new_overlap, new_qa


# ----------------------------------------------------------------------
# K16b: HF generator
# ----------------------------------------------------------------------
def _lpc_plain(vr, vi, kx: int):
    """The covariance LPC of the reference's :268-306 on v [N, K, 34, 32]:
    (a0r, a0i, a1r, a1i) [N, K, 32], each covariance summed over the 32
    slots in slot order."""
    v0r, v0i = vr[:, :, 2:], vi[:, :, 2:]      # x[n]
    v1r, v1i = vr[:, :, 1:-1], vi[:, :, 1:-1]  # x[n-1]
    v2r, v2i = vr[:, :, :-2], vi[:, :, :-2]    # x[n-2]

    def cdot(ar, ai, br, bi):  # Σ conj(a)·b over the slot axis
        return (rc.ordered_sum(ar * br + ai * bi, 2),
                rc.ordered_sum(ar * bi - ai * br, 2))

    p01r, p01i = cdot(v1r, v1i, v0r, v0i)
    p11 = rc.ordered_sum(v1r * v1r + v1i * v1i, 2)
    p02r, p02i = cdot(v2r, v2i, v0r, v0i)
    p12r, p12i = cdot(v2r, v2i, v1r, v1i)
    p22 = rc.ordered_sum(v2r * v2r + v2i * v2i, 2)
    d = p22 * p11 - rc.fdiv(p12r * p12r + p12i * p12i, LPC_DIV)
    zero = vr.new_zeros(())
    d_ok = d.abs() > EPS
    dd = torch.where(d_ok, d, 1.0)
    a1r = torch.where(d_ok, (p01r * p12r - p01i * p12i - p02r * p11) / dd,
                      zero)
    a1i = torch.where(d_ok, (p01r * p12i + p01i * p12r - p02i * p11) / dd,
                      zero)
    p_ok = p11.abs() > EPS
    pp = torch.where(p_ok, p11, 1.0)
    # alpha0 = -(p01 + alpha1·conj(p12)) / p11
    t0r = a1r * p12r - a1i * -p12i
    t0i = a1r * -p12i + a1i * p12r
    a0r = torch.where(p_ok, -(p01r + t0r) / pp, zero)
    a0i = torch.where(p_ok, -(p01i + t0i) / pp, zero)
    # the guard is on the complex magnitude (host: abs(alpha) >= 4)
    big = (a0r * a0r + a0i * a0i >= 16.0) | (a1r * a1r + a1i * a1i >= 16.0)
    a0r, a0i, a1r, a1i = (torch.where(big, zero, a)
                          for a in (a0r, a0i, a1r, a1i))
    # band 0 and bands >= kx+1 carry no predictor (host: range(1, kx+1))
    bmask = vr.new_zeros(32)
    bmask[1:min(kx + 1, 32)] = 1.0
    return a0r * bmask, a0i * bmask, a1r * bmask, a1i * bmask


def sbr_hf_generate_plain(xl, tail_r, tail_i, bwj, src_idx, src_ok,
                          kx: int):
    """Plain version of K16b (the reference's :259-324).

    xl f32 [N, 32K, 64] (re in bands 0-31, im in 32-63); tail_r, tail_i
    [N, 2, 32]; bwj [N, K, m] (chirp per target bin); src_idx int32 [m],
    src_ok f32 [m].  Returns (xh f32 [N, K, 32, m, 2], new tail_r, new
    tail_i)."""
    n, kp = bwj.shape[:2]
    xlr = xl[..., :32].reshape(n, kp, NSLOT, 32)
    xli = xl[..., 32:].reshape(n, kp, NSLOT, 32)
    tr = torch.cat([tail_r[:, None], xlr[:, :-1, -2:]], dim=1)
    ti = torch.cat([tail_i[:, None], xli[:, :-1, -2:]], dim=1)
    vr = torch.cat([tr, xlr], dim=2)  # [N, K, 34, 32]
    vi = torch.cat([ti, xli], dim=2)
    a0r, a0i, a1r, a1i = _lpc_plain(vr, vi, kx)
    # patch: x_high[t, j] = v0[src] + b·a0[src]·v1[src] + b²·a1[src]·v2[src]
    si = src_idx.long()
    g0r, g0i, g1r, g1i = (a[..., si] for a in (a0r, a0i, a1r, a1i))
    sv0r, sv0i = vr[:, :, 2:, si], vi[:, :, 2:, si]  # [N, K, 32, m]
    sv1r, sv1i = vr[:, :, 1:-1, si], vi[:, :, 1:-1, si]
    sv2r, sv2i = vr[:, :, :-2, si], vi[:, :, :-2, si]
    c1r, c1i = (bwj * g0r)[:, :, None], (bwj * g0i)[:, :, None]
    bw2 = bwj * bwj
    c2r, c2i = (bw2 * g1r)[:, :, None], (bw2 * g1i)[:, :, None]
    xhr = sv0r + (c1r * sv1r - c1i * sv1i) + (c2r * sv2r - c2i * sv2i)
    xhi = sv0i + (c1r * sv1i + c1i * sv1r) + (c2r * sv2i + c2i * sv2r)
    xh = torch.stack([xhr * src_ok, xhi * src_ok], dim=-1)
    return (xh, xlr[:, -1, -2:].contiguous(),
            xli[:, -1, -2:].contiguous())


def sbr_hf_generate(xl, tail_r, tail_i, bwj, src_idx, src_ok, kx: int,
                    plain: bool = False):
    """K16b: the arguments and results of :func:`sbr_hf_generate_plain`.
    A CPU tensor (or ``plain``) takes the plain version; a CUDA tensor
    launches the kernel (one CTA per (lane, packet), its window of xl in
    by bulk copies), which takes 16-byte aligned xl and tails."""
    if plain or xl.device.type == "cpu":
        return sbr_hf_generate_plain(xl, tail_r, tail_i, bwj, src_idx,
                                     src_ok, kx)
    n, kp, m = bwj.shape
    K.check(xl, "xl", torch.float32, (n, kp * NSLOT, 64))
    K.check(tail_r, "tail_r", torch.float32, (n, 2, 32))
    K.check(tail_i, "tail_i", torch.float32, (n, 2, 32))
    K.check(bwj, "bwj", torch.float32)
    K.check(src_idx, "src_idx", torch.int32, (m,))
    K.check(src_ok, "src_ok", torch.float32, (m,))
    for name, t in (("xl", xl), ("tail_r", tail_r), ("tail_i", tail_i)):
        if t.data_ptr() % 16:  # the kernel's bulk copies
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    dev = xl.device
    xh = torch.empty(n, kp, NSLOT, m, 2, device=dev)
    new_r = torch.empty(n, 2, 32, device=dev)
    new_i = torch.empty(n, 2, 32, device=dev)
    K.launch("sbr_hf_generate", xl.data_ptr(), tail_r.data_ptr(),
             tail_i.data_ptr(), bwj.data_ptr(), src_idx.data_ptr(),
             src_ok.data_ptr(), xh.data_ptr(), new_r.data_ptr(),
             new_i.data_ptr(), n, kp, m, kx, EPS, LPC_DIV, device=dev)
    return xh, new_r, new_i


# ----------------------------------------------------------------------
# K16c: HF adjuster and the assembly of X
# ----------------------------------------------------------------------
def _gather_bins(x, idx):
    """x [..., nb] -> [..., m]: x[..., idx[i]], or 0 where idx[i] < 0."""
    g = x[..., idx.clamp(min=0).long()]
    return torch.where(idx >= 0, g, x.new_zeros(()))


def _band_sums(x, idx, nb: int):
    """x [..., m] -> [..., nb]: the sum over the bins of each band, in bin
    order (idx [m] is each bin's band, -1 for none)."""
    onehot = (idx.long()[:, None] == torch.arange(nb, device=x.device)
              ).to(x.dtype)  # [m, nb]
    return rc.ordered_sum(x[..., :, None] * onehot, -2)


def _env_expand(seg, x):
    """seg [N, K, 32, 5], x [N, K, 5, m] -> [N, K, 32, m]: Σ_e seg·x over
    the envelopes, in envelope order."""
    return rc.ordered_sum(seg[..., :, None] * x[:, :, None], 3)


def sbr_hf_adjust_plain(xh, xl, env_seg, freq_res, e_bands, q_bands,
                        harm_act, delta_e, noise_start, nlow, g_hist,
                        q_hist, maps, noise_tab, kx: int, lim_gain: float,
                        interpol: bool, smooth: bool):
    """Plain version of K16c (the reference's :326-478).

    xh f32 [N, K, 32, m, 2] (K16b's output); xl [N, 32K, 64]; the prepared
    SBR inputs of one batch (env_seg uint8 [N, K, 32, 5], freq_res uint8
    [N, K, 5], e_bands f32 [N, K, 5, n_high], q_bands [N, K, 5, n_q],
    harm_act uint8 [N, K, 5, n_high], delta_e uint8 [N, K, 5], noise_start
    int32 [N, K, 32], nlow f32 [N, K, 32]); the smoothing history g_hist,
    q_hist [N, 4, 64] (None unless ``smooth``); ``maps``, the device
    tensors of :func:`band_maps`; noise_tab [512, 2].  Returns (X f32 [2,
    N, K, 32, 64]: the real and imaginary planes of the synthesis input,
    new g_hist, new q_hist (None unless ``smooth``))."""
    n, kp, _, m, _ = xh.shape
    dev = xh.device
    xhr, xhi = xh[..., 0], xh[..., 1]
    seg = env_seg.to(xh.dtype)
    res = freq_res.to(xh.dtype)[..., None]
    dl = delta_e.to(xh.dtype)
    de = dl[..., None]
    eb = e_bands
    e_orig = res * _gather_bins(eb, maps["band_hi"]) \
        + (1.0 - res) * _gather_bins(eb, maps["band_lo"])
    q_orig = _gather_bins(q_bands, maps["band_noise"])
    act = harm_act.to(xh.dtype)
    s_mapped = _gather_bins(act, maps["band_hi"])
    s_bins = _gather_bins(act, maps["sin_band"])

    e2 = xhr * xhr + xhi * xhi  # [N, K, 32, m]
    cnt = rc.ordered_sum(seg, 2)  # [N, K, 5]
    e_curr = rc.ordered_sum(seg[..., None] * e2[:, :, :, None], 2) \
        / torch.clamp(cnt, min=1.0)[..., None]
    if not interpol:
        # bs_interpol_freq=0: flatten the energy estimate over each band
        # of the envelope's resolution so gains are per-band
        n_hi, n_lo = maps["w_hi"].numel(), maps["w_lo"].numel()
        ebh = _band_sums(e_curr, maps["band_hi"], n_hi) / maps["w_hi"]
        ebl = _band_sums(e_curr, maps["band_lo"], n_lo) / maps["w_lo"]
        e_curr = res * _gather_bins(ebh, maps["band_hi"]) \
            + (1.0 - res) * _gather_bins(ebl, maps["band_lo"])

    zero = xh.new_zeros(())
    q_frac = q_orig / (1.0 + q_orig)
    gain = torch.where(
        s_mapped > 0,
        torch.sqrt(e_orig * q_frac / (1.0 + e_curr)),
        torch.sqrt(e_orig / ((1.0 + e_curr) * (1.0 + de * q_orig))))
    q_m = torch.sqrt(e_orig * q_frac)
    s_m = torch.where(s_bins > 0, torch.sqrt(e_orig / (1.0 + q_orig)), zero)

    lim, n_lim = maps["lim_band"], maps["n_lim"]
    eo_sum = _band_sums(e_orig, lim, n_lim)
    ec_sum = _band_sums(e_curr, lim, n_lim)
    g_max_l = torch.clamp(
        lim_gain * torch.sqrt((EPS + eo_sum) / (EPS + ec_sum)),
        max=G_MAX_CAP)
    g_max = _gather_bins(g_max_l, lim)
    clipped = gain > g_max
    q_m = torch.where(clipped, q_m * g_max / torch.clamp(gain, min=EPS),
                      q_m)
    gain = torch.minimum(gain, g_max)
    got = gain * gain * e_curr + de * (q_m * q_m * (1.0 - s_mapped)) \
        + s_m * s_m
    got_sum = _band_sums(got, lim, n_lim)
    boost_l = torch.clamp(torch.sqrt((EPS + eo_sum) / (EPS + got_sum)),
                          max=MAX_BOOST)
    boost = _gather_bins(boost_l, lim)
    gain, q_m, s_m = gain * boost, q_m * boost, s_m * boost

    # expand per-envelope values to slots
    gain_s = _env_expand(seg, gain)
    sm_s = _env_expand(seg, s_m)
    cover = rc.ordered_sum(seg, 3)  # [N, K, 32]
    new_g = new_q = None
    if smooth:
        # bs_smoothing_mode=0: 5-tap h_smooth over the per-slot raw
        # gain/noise trajectories, 4 slots of carried history; transient
        # envelopes bypass the filter
        q_raw_s = _env_expand(seg, q_m)
        gate_s = _env_expand(seg, de * (1.0 - s_mapped))
        s_tot = kp * NSLOT
        gt = torch.cat([g_hist[:, :, :m], gain_s.reshape(n, s_tot, m)], 1)
        qt = torch.cat([q_hist[:, :, :m], q_raw_s.reshape(n, s_tot, m)], 1)
        g_f = q_f = 0.0
        for j in range(5):
            g_f = g_f + H_SMOOTH[j] * gt[:, 4 - j:4 - j + s_tot]
            q_f = q_f + H_SMOOTH[j] * qt[:, 4 - j:4 - j + s_tot]
        g_f = g_f.reshape(n, kp, NSLOT, m)
        q_f = q_f.reshape(n, kp, NSLOT, m)
        pad = xh.new_zeros(n, 4, 64 - m)
        new_g = torch.cat([gt[:, -4:], pad], dim=2)
        new_q = torch.cat([qt[:, -4:], pad], dim=2)
        ok_s = rc.ordered_sum(seg * dl[:, :, None], 3)[..., None]
        gain_s = ok_s * g_f + (1.0 - ok_s) * gain_s
        qm_s = gate_s * (ok_s * q_f + (1.0 - ok_s) * q_raw_s)
    else:
        qm_s = _env_expand(seg, de * q_m * (1.0 - s_mapped))

    # noise phasors from the running index, sinusoid phase i^((slot+j)&3)
    bins = torch.arange(m, device=dev, dtype=torch.int32)
    nidx = (noise_start[..., None] + 1 + bins) & 511
    nz = noise_tab[nidx.long()]  # [N, K, 32, m, 2]
    pidx = (torch.arange(NSLOT, device=dev)[:, None] + bins[None]) & 3
    ph_r = (pidx == 0).to(xh.dtype) - (pidx == 2).to(xh.dtype)  # 1 0 -1 0
    ph_i = (pidx == 1).to(xh.dtype) - (pidx == 3).to(xh.dtype)  # 0 1 0 -1
    cov = cover[..., None]
    yr = (xhr * gain_s + qm_s * nz[..., 0] + sm_s * ph_r) * cov
    yi = (xhi * gain_s + qm_s * nz[..., 1] + sm_s * ph_i) * cov

    xlr = xl[..., :32].reshape(n, kp, NSLOT, 32)
    xli = xl[..., 32:].reshape(n, kp, NSLOT, 32)
    x = xh.new_zeros(2, n, kp, NSLOT, 64)
    low = nlow[:, :, None, :]
    x[0, ..., :32] = xlr * low
    x[1, ..., :32] = xli * low
    x[0, ..., kx:kx + m] = x[0, ..., kx:kx + m] + yr
    x[1, ..., kx:kx + m] = x[1, ..., kx:kx + m] + yi
    return x, new_g, new_q


def sbr_hf_adjust(xh, xl, env_seg, freq_res, e_bands, q_bands, harm_act,
                  delta_e, noise_start, nlow, g_hist, q_hist, maps,
                  noise_tab, kx: int, lim_gain: float, interpol: bool,
                  smooth: bool, plain: bool = False):
    """K16c: the arguments and results of :func:`sbr_hf_adjust_plain`
    (``maps`` with :func:`band_maps`' spans).  A CPU tensor (or ``plain``)
    takes the plain version; a CUDA tensor launches the kernel, one CTA
    per lane's two packets whatever the header (when it smooths, each CTA
    also runs the envelope phases of the packet before its first, for the
    4 raw slots the filter reaches back to), which takes 16-byte aligned
    xh, xl, env_seg, noise_start and nlow."""
    args = (xh, xl, env_seg, freq_res, e_bands, q_bands, harm_act, delta_e,
            noise_start, nlow, g_hist, q_hist, maps, noise_tab, kx,
            lim_gain, interpol, smooth)
    if plain or xh.device.type == "cpu":
        return sbr_hf_adjust_plain(*args)
    n, kp, _, m, _ = xh.shape
    n_high, n_q = e_bands.shape[-1], q_bands.shape[-1]
    K.check(xh, "xh", torch.float32, (n, kp, NSLOT, m, 2))
    K.check(xl, "xl", torch.float32, (n, kp * NSLOT, 64))
    K.check(env_seg, "env_seg", torch.uint8, (n, kp, NSLOT, MAXENV))
    K.check(freq_res, "freq_res", torch.uint8, (n, kp, MAXENV))
    K.check(e_bands, "e_bands", torch.float32, (n, kp, MAXENV, n_high))
    K.check(q_bands, "q_bands", torch.float32, (n, kp, MAXENV, n_q))
    K.check(harm_act, "harm_act", torch.uint8, (n, kp, MAXENV, n_high))
    K.check(delta_e, "delta_e", torch.uint8, (n, kp, MAXENV))
    K.check(noise_start, "noise_start", torch.int32, (n, kp, NSLOT))
    K.check(nlow, "nlow", torch.float32, (n, kp, 32))
    for name in ("band_hi", "band_lo", "band_noise", "sin_band",
                 "lim_band"):
        K.check(maps[name], name, torch.int32, (m,))
    for name in ("hi_span", "lo_span", "lim_span"):
        K.check(maps[name], name, torch.int32, (m, 2))
    K.check(noise_tab, "noise_tab", torch.float32, (512, 2))
    for name, t in (("xh", xh), ("xl", xl), ("env_seg", env_seg),
                    ("noise_start", noise_start), ("nlow", nlow)):
        if t.data_ptr() % 16:  # the kernel stages them by bulk copies
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    dev = xh.device
    if smooth:
        K.check(g_hist, "g_hist", torch.float32, (n, 4, 64))
        K.check(q_hist, "q_hist", torch.float32, (n, 4, 64))
        new_g = torch.empty(n, 4, 64, device=dev)
        new_q = torch.empty(n, 4, 64, device=dev)
        ptrs = (g_hist.data_ptr(), q_hist.data_ptr(), new_g.data_ptr(),
                new_q.data_ptr())
    else:
        new_g = new_q = None
        ptrs = (None, None, None, None)
    x = torch.empty(2, n, kp, NSLOT, 64, device=dev)
    K.launch("sbr_hf_adjust", xh.data_ptr(), xl.data_ptr(),
             env_seg.data_ptr(), freq_res.data_ptr(), e_bands.data_ptr(),
             q_bands.data_ptr(), harm_act.data_ptr(), delta_e.data_ptr(),
             noise_start.data_ptr(), nlow.data_ptr(),
             maps["band_hi"].data_ptr(), maps["band_lo"].data_ptr(),
             maps["band_noise"].data_ptr(), maps["sin_band"].data_ptr(),
             maps["lim_band"].data_ptr(), maps["hi_span"].data_ptr(),
             maps["lo_span"].data_ptr(), maps["lim_span"].data_ptr(),
             maps["w_hi"].data_ptr(),
             maps["w_lo"].data_ptr(), noise_tab.data_ptr(), *ptrs,
             x.data_ptr(), n, kp, m, kx, n_high, maps["w_lo"].numel(), n_q,
             int(maps["n_lim"]), int(interpol), int(smooth), lim_gain, EPS,
             G_MAX_CAP, MAX_BOOST, *H_SMOOTH, device=dev)
    return x, new_g, new_q


# ----------------------------------------------------------------------
# K16d: QMF64 synthesis fold and the int16 clip
# ----------------------------------------------------------------------
def qmf_synthesis_plain(v, syn_hist, cidx, w10):
    """Plain version of K16d (the reference's :484-503).

    v f32 [N, S, 128] (the modulated synthesis input), syn_hist [N, 9,
    128], cidx int32 [10, 64], w10 f32 [10, 64].  Returns (pcm int16 [N,
    64S], new syn_hist).  Each sample sums its 10 taps in tap order, then
    rounds half to even and clips to int16."""
    n, s_tot, _ = v.shape
    vx = torch.cat([syn_hist, v], dim=1)
    out = v.new_zeros(n, s_tot, 64)
    for d in range(10):
        rows = vx[:, SYN_HIST - d:SYN_HIST - d + s_tot]
        out = out + rows[:, :, cidx[d].long()] * w10[d]
    pcm = torch.clamp(torch.round(out), -32768, 32767).to(torch.int16)
    return pcm.reshape(n, s_tot * 64), vx[:, -SYN_HIST:].contiguous()


def qmf_synthesis(v, syn_hist, cidx, w10, plain: bool = False):
    """K16d: the arguments and results of :func:`qmf_synthesis_plain`.  A
    CPU tensor (or ``plain``) takes the plain version; a CUDA tensor
    launches the kernel, one CTA per (lane, tile of 64 slots) over the
    tile's rows of [syn_hist | v] in shared memory, which takes 16-byte
    aligned v and syn_hist."""
    if plain or v.device.type == "cpu":
        return qmf_synthesis_plain(v, syn_hist, cidx, w10)
    n, s_tot, _ = v.shape
    K.check(v, "v", torch.float32, (n, s_tot, 128))
    K.check(syn_hist, "syn_hist", torch.float32, (n, SYN_HIST, 128))
    K.check(cidx, "cidx", torch.int32, (10, 64))
    K.check(w10, "w10", torch.float32, (10, 64))
    if s_tot < SYN_HIST:
        raise ValueError("qmf_synthesis needs at least 9 slots")
    for name, t in (("v", v), ("syn_hist", syn_hist)):
        if t.data_ptr() % 16:  # the kernel stages them by bulk copies
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    dev = v.device
    pcm = torch.empty(n, s_tot * 64, dtype=torch.int16, device=dev)
    new_hist = torch.empty(n, SYN_HIST, 128, device=dev)
    K.launch("qmf_synthesis", v.data_ptr(), syn_hist.data_ptr(),
             cidx.data_ptr(), w10.data_ptr(), pcm.data_ptr(),
             new_hist.data_ptr(), n, s_tot, device=dev)
    return pcm, new_hist


# ----------------------------------------------------------------------
# the stage
# ----------------------------------------------------------------------
STATE_SHAPES = {"overlap": (1024,), "qa_hist": (QA_HIST,),
                "syn_hist": (SYN_HIST, 128), "tail_r": (2, 32),
                "tail_i": (2, 32), "g_hist": (4, 64), "q_hist": (4, 64)}


def _check_precision(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the audio stage needs full float32 matmuls: "
                           "set torch.backends.cuda.matmul.allow_tf32 = "
                           "False")


class DeviceStage(torch.nn.Module):
    """The device half of one batch decode for one SBR header, batch size
    and spectrum caps: ``stage(state, inp)`` -> (new state, pcm int16 [N,
    K*2048]).  Holds the static tables as device buffers.  ``state`` is a
    dict of float32 tensors (``overlap`` [N, 1024], ``qa_hist`` [N, 288],
    ``syn_hist`` [N, 9, 128], ``tail_r``/``tail_i`` [N, 2, 32], and
    ``g_hist``/``q_hist`` [N, 4, 64] when the header smooths); ``inp`` the
    tensors of ``BatchedAudioDecoder.prepare`` on the same device."""

    def __init__(self, ft: S.FreqTables, lim_gain: float, interpol: bool,
                 smooth: bool = False, cap_long: int = 1024,
                 cap_short: int = 128, device="cuda"):
        super().__init__()
        dev = K.resolve_device(device)
        self.kx, self.m = ft.kx, ft.m
        self.lim_gain = _f32(lim_gain)
        self.interpol, self.smooth = bool(interpol), bool(smooth)
        self.cap_long, self.cap_short = cap_long, cap_short

        def buf(name, a):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(a)).to(dev))
        buf("blt", _imdct_long()[:, :cap_long].T)    # [capL, 2048]
        buf("bst", _imdct_short()[:, :cap_short].T)  # [capS, 256]
        buf("lut_long", _long_window_lut())
        buf("lut_short", _short_window_lut())
        buf("ka", _qmf_analysis_kernel())
        smr, smi = _synthesis_mod_ri()
        buf("smr", smr)
        buf("smi", smi)
        cidx, w10 = _synthesis_taps()
        buf("cidx", cidx)
        buf("w10", w10)
        buf("noise_tab", np.stack([S.NOISE_TABLE.real, S.NOISE_TABLE.imag],
                                  -1).astype(np.float32))
        maps = band_maps(ft)
        for k, v in maps.items():
            buf(k, v)
        self.n_lim = ft.n_lim
        self._map_names = tuple(maps)

    def maps(self) -> dict:
        out = {k: getattr(self, k) for k in self._map_names}
        out["n_lim"] = self.n_lim
        return out

    def forward(self, state: dict, inp: dict, plain: bool = False):
        spec_l, spec_s = inp["spec_long"], inp["spec_short"]
        n, kp = spec_l.shape[:2]
        _check_precision(spec_l)
        long_raw = torch.matmul(spec_l.reshape(-1, self.cap_long),
                                self.blt).reshape(n, kp, 2048)
        short_raw = torch.matmul(spec_s.reshape(-1, self.cap_short),
                                 self.bst).reshape(n, kp, 8, 256)
        xl, overlap, qa = window_qmf_analysis(
            long_raw, short_raw, inp["win_long_idx"], inp["win_short_idx"],
            inp["short"], state["overlap"], state["qa_hist"], self.lut_long,
            self.lut_short, self.ka, plain=plain)
        xh, tail_r, tail_i = sbr_hf_generate(
            xl, state["tail_r"], state["tail_i"], inp["bwj"], self.src_idx,
            self.src_ok, self.kx, plain=plain)
        x, g_hist, q_hist = sbr_hf_adjust(
            xh, xl, inp["env_seg"], inp["freq_res"], inp["e_bands"],
            inp["q_bands"], inp["harm_act"], inp["delta_e"],
            inp["noise_start"], inp["nlow"], state.get("g_hist"),
            state.get("q_hist"), self.maps(), self.noise_tab, self.kx,
            self.lim_gain, self.interpol, self.smooth, plain=plain)
        v = (torch.matmul(x[0].reshape(-1, 64), self.smr)
             - torch.matmul(x[1].reshape(-1, 64), self.smi))
        pcm, syn = qmf_synthesis(v.reshape(n, kp * NSLOT, 128),
                                 state["syn_hist"], self.cidx, self.w10,
                                 plain=plain)
        new_state = {"overlap": overlap, "qa_hist": qa, "syn_hist": syn,
                     "tail_r": tail_r, "tail_i": tail_i}
        if self.smooth:
            new_state["g_hist"] = g_hist
            new_state["q_hist"] = q_hist
        return new_state, pcm.reshape(n, kp * NSLOT * 64)
