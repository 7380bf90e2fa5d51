"""K16c (the SBR HF adjuster and the assembly of X, csrc/sbr_hf_adjust.cu)
and K16d (the QMF synthesis fold and the int16 clip, csrc/qmf_synthesis.cu)
as their kernels split the work, held on the CPU to the port's plain
versions.  The kernels run only on a card (tests/test_torch_kernels.py);
here what each does differently from its plain version is checked:

- K16d runs a CTA a (lane, tile of 64 slots) over the tile's rows of Vx =
  [syn_hist | V] and the 9 before them (the first tile's from syn_hist), a
  thread 4 adjacent columns of 8 consecutive slots, which with paired
  taps reads each of its 17 rows once and adds each row's term to every
  slot that reads it, rows from the last to the first; the tile that
  holds the last slot writes the new history from its staged rows.  A
  torch model of that split, every staged cell it does not fill NaN,
  equals ``qmf_synthesis_plain`` bit for bit and writes every output once:
  9 to 256 slots (partial tiles, a tile shorter than the history), 1, 3
  and 129 lanes, outputs at exact halves and past int16 at both ends, and
  taps that take the kernel's general path.
- K16c runs a CTA a lane's two packets under every header.  With
  smoothing each packet's raw slot trajectories are computed from that
  packet alone, and its 5-tap filter takes the previous packet's last 4
  raw rows: for the CTA's first packet the CTA recomputes them from the
  previous packet's own inputs (packet 0 takes the carried history).  A torch model of that split, with every band and
  limiter sum over the bin's span, equals ``sbr_hf_adjust_plain`` bit for
  bit, X and the new histories: 1, 3, 8, 9 and 16 packets of the
  smoothing streams of tests/test_torch_audio.py (``smooth``, moving
  envelopes; ``tr_smooth``, transients, whose envelopes bypass the
  filter), and the interpol_freq=0 stream.
- The spans that replace K16c's all-bins loops (``band_maps``'
  ``hi_span``, ``lo_span``, ``lim_span``): each band and limiter sum over a
  bin's span equals the masked sum over all bins of the plain version, for
  every header of tests/test_torch_kernels.py.

Inputs are made with numpy from seeds and encoded with the port's ``tx``
copy.  Torch runs on one thread.
"""

import functools

import numpy as np
import pytest
import torch
from numpy.fft import irfft, rfft

from nrsc5_tpu_torch.audio import sbr as S
from nrsc5_tpu_torch.audio import stage as AST
from nrsc5_tpu_torch.audio.batch import BatchedAudioDecoder
from nrsc5_tpu_torch.tx.hdc_encoder import HDCEncoder

FS = 44100
NSLOT = AST.NSLOT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


# ---------------------------------------------------------------------------
# K16d: slot tiles with their halos, columns and slots by thread
# ---------------------------------------------------------------------------

TILE, COLS, SLOTS, HIST = 64, 4, 8, AST.SYN_HIST


def _k16d_model(v, syn_hist, cidx, w10):
    """K16d as the kernel splits it.  CTA (n, y) stages Vx rows [64 y, 64 y
    + 73) clipped to the slots there are (history rows below 9), into a
    buffer of NaN.  Thread (cg, sg) owns columns 4 cg + j and slots 8 sg +
    q, q < 8.  With paired taps (column c on even taps, 64 + c on odd ones)
    it walks its rows 8 sg + r from r = 16 down to 0, reading each row's
    halves once, and adds the row's term to every slot q that reads it (at
    tap d = q + 9 - r); other taps take a load a tap and column.  Returns
    (pcm, new history, the float folds, how often each output was
    written)."""
    lanes, n_slots, _ = v.shape
    nan = float("nan")
    fold = torch.full((lanes, n_slots, 64), nan)
    written = torch.zeros(lanes, n_slots, 64, dtype=torch.int32)
    new_hist = torch.full((lanes, HIST, 128), nan)
    paired = torch.equal(cidx, torch.arange(64)[None] + 64 * (
        torch.arange(10)[:, None] % 2))
    wt = w10.reshape(10, 64 // COLS, COLS)
    for y in range(-(-n_slots // TILE)):
        s0 = y * TILE
        s_end = min(s0 + TILE, n_slots)
        buf = torch.full((lanes, TILE + HIST, 128), nan)
        h_rows = max(0, HIST - s0)
        v_first = max(s0, HIST) - HIST
        v_rows = s_end - v_first
        buf[:, :h_rows] = syn_hist[:, s0:s0 + h_rows]
        buf[:, h_rows:h_rows + v_rows] = v[:, v_first:v_first + v_rows]
        for sg in range(TILE // SLOTS):
            sl0 = sg * SLOTS
            acc = torch.zeros(lanes, 64 // COLS, SLOTS, COLS)
            if paired:
                for r in range(SLOTS + HIST - 1, -1, -1):
                    row = buf[:, sl0 + r]
                    lo = row[:, :64].reshape(lanes, 64 // COLS, COLS)
                    hi = row[:, 64:].reshape(lanes, 64 // COLS, COLS)
                    for q in range(max(0, r - HIST), min(SLOTS - 1, r) + 1):
                        d = q + HIST - r
                        acc[:, :, q] = acc[:, :, q] + (hi if d % 2 else lo) \
                            * wt[d]
            else:
                for q in range(SLOTS):
                    for d in range(10):
                        x = buf[:, sl0 + q + HIST - d, cidx[d]]
                        acc[:, :, q] = acc[:, :, q] + x.reshape(
                            lanes, 64 // COLS, COLS) * wt[d]
            for q in range(SLOTS):
                s = s0 + sl0 + q
                if s >= s_end:
                    break
                fold[:, s] = acc[:, :, q].reshape(lanes, 64)
                written[:, s] += 1
        if s_end == n_slots:
            new_hist = buf[:, n_slots - s0:n_slots - s0 + HIST].clone()
    pcm = torch.clamp(torch.round(fold), -32768, 32767).to(torch.int16)
    return pcm.reshape(lanes, n_slots * 64), new_hist, fold, written


def _k16d_inputs(n_slots, lanes, seed, taps="paired"):
    """Random V and history, and the synthesis taps with columns 0-15
    passing tap 0 alone (their outputs are V's values: exact halves of both
    parities, past int16 at both ends); ``taps="swapped"`` reads column 64
    + c on even taps and c on odd ones (the kernel's general path)."""
    rng = np.random.default_rng(seed)
    cidx, w10 = AST._synthesis_taps()
    w10 = w10.copy()
    w10[:, :16] = 0.0
    w10[0, :16] = 1.0
    if taps == "swapped":
        cidx = (cidx + 64) % 128
    v = rng.normal(0.0, 3e4, (lanes, n_slots, 128)).astype(np.float32)
    v[..., :16] = rng.integers(-40000, 40000, (lanes, n_slots, 16)) + 0.5
    v[..., 64:80] = rng.integers(-40000, 40000, (lanes, n_slots, 16)) + 0.5
    hist = rng.normal(0.0, 3e4, (lanes, HIST, 128)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (v, hist, cidx, w10))


@pytest.mark.parametrize("lanes", [1, 3, 129])
@pytest.mark.parametrize("n_slots", [9, 31, 32, 33, 63, 64, 65, 256])
def test_k16d_model(n_slots, lanes):
    """The model of K16d's tiling equals the plain version bit for bit,
    PCM and new history, reads no staged cell it did not fill, and writes
    each output once; outputs at exact halves and past int16."""
    v, hist, cidx, w10 = _k16d_inputs(n_slots, lanes, 1600 + 7 * n_slots
                                      + lanes)
    want = AST.qmf_synthesis_plain(v, hist, cidx, w10)
    pcm, new_hist, fold, written = _k16d_model(v, hist, cidx, w10)
    assert torch.equal(written, torch.ones_like(written))
    assert not fold.isnan().any()
    assert torch.equal(pcm, want[0])
    assert _bit_equal(new_hist, want[1])
    halves = fold[..., :16]
    assert (halves - halves.floor() == 0.5).all()
    assert {-32768, 32767} <= set(want[0].unique().tolist())


@pytest.mark.parametrize("n_slots", [33, 256])
def test_k16d_model_general_taps(n_slots):
    """Taps that are not paired as _synthesis_taps pairs them take the
    kernel's general path; its model equals the plain version too."""
    v, hist, cidx, w10 = _k16d_inputs(n_slots, 3, 1666 + n_slots,
                                      taps="swapped")
    want = AST.qmf_synthesis_plain(v, hist, cidx, w10)
    pcm, new_hist, fold, written = _k16d_model(v, hist, cidx, w10)
    assert torch.equal(written, torch.ones_like(written))
    assert not fold.isnan().any()
    assert torch.equal(pcm, want[0]) and _bit_equal(new_hist, want[1])


# ---------------------------------------------------------------------------
# K16c: a CTA a (lane, packet); with smoothing, the previous packet's raw
# rows recomputed from its own inputs
# ---------------------------------------------------------------------------

_SMOOTH = S.SbrHeader(start_freq=8, stop_freq=7, amp_res=0, xover_band=2,
                      smoothing_mode=0)
_INTERPOL0 = S.SbrHeader(start_freq=8, stop_freq=7, amp_res=0, xover_band=2,
                         interpol_freq=0)


def _band_noise(n, seed, tone, lo, hi, mod=False):
    """tests/test_torch_audio.py's ``_band_noise``: a tone over band noise,
    with a moving envelope when ``mod`` (the smoothing stream)."""
    rng = np.random.default_rng(seed)
    m = n * 2048
    t = np.arange(m) / FS
    s2 = rfft(rng.standard_normal(m))
    f = np.arange(len(s2)) * FS / m
    band = irfft(np.where((f > lo) & (f < hi), s2, 0), m)
    if mod:
        am = 0.55 + 0.45 * np.sin(2 * np.pi * 13.0 * t)
        sig = 0.3 * np.sin(2 * np.pi * tone * t) + 0.35 * band * am
    else:
        sig = 0.4 * np.sin(2 * np.pi * tone * t) + 0.1 * band
    return np.stack([sig, sig * 0.85], -1) * 0.7


def _transient_pcm(n, seed):
    """tests/test_torch_audio.py's ``_transient_pcm``: a quiet tone with a
    sharp burst every third packet."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * 2048) / FS
    x = 0.04 * np.sin(2 * np.pi * 500 * t) \
        + 0.01 * rng.standard_normal(n * 2048)
    for k in range(2, n - 2, 3):
        pos = k * 2048 + 700
        tt = np.arange(256)
        burst = (np.sin(2 * np.pi * 2400 * tt / FS)
                 + 0.5 * np.sin(2 * np.pi * 3500 * tt / FS + 1.0)) \
            * np.hanning(256)
        x[pos:pos + 256] += 0.7 * burst / np.abs(burst).max()
    np.clip(x, -1, 1, out=x)
    return np.stack([x, x * 0.9], -1)


@functools.lru_cache(maxsize=None)
def _stream(name):
    """16 packets of a stream, prepared on the CPU, K16a and K16b run by
    their plain versions, the smoothing history random: (stage, the K16c
    inputs [2, 16, ...], g_hist, q_hist)."""
    n = 16
    pcm, hdr = {
        "smooth": (lambda: _band_noise(n, 6, 440, 6000, 13000, mod=True),
                   _SMOOTH),
        "tr_smooth": (lambda: _transient_pcm(n, 31), _SMOOTH),
        "interpol0": (lambda: _band_noise(n, 7, 700, 4000, 13000),
                      _INTERPOL0)}[name]
    pcm, enc = pcm(), HDCEncoder(channels=2, sbr=True, pns=False,
                                 sbr_header=hdr)
    pkts = [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048]) for k in range(n)]
    dec = BatchedAudioDecoder(1, device="cpu")
    stage, inp, smooth, key = dec.prepare([pkts])
    dec._reconcile_state(smooth, key)
    inp = {k: torch.from_numpy(v) for k, v in inp.items()}
    st = dec._state
    lanes = inp["spec_long"].shape[0]
    long_raw = torch.matmul(inp["spec_long"].reshape(lanes * n, -1),
                            stage.blt).reshape(lanes, n, 2048)
    short_raw = torch.matmul(inp["spec_short"].reshape(lanes * n * 8, -1),
                             stage.bst).reshape(lanes, n, 8, 256)
    xl = AST.window_qmf_analysis_plain(
        long_raw, short_raw, inp["win_long_idx"], inp["win_short_idx"],
        inp["short"], st["overlap"], st["qa_hist"], stage.lut_long,
        stage.lut_short, stage.ka)[0]
    xh = AST.sbr_hf_generate_plain(xl, st["tail_r"], st["tail_i"],
                                   inp["bwj"], stage.src_idx, stage.src_ok,
                                   stage.kx)[0]
    rng = np.random.default_rng(16016)
    hist = [torch.from_numpy(rng.uniform(0.0, 3.0, (lanes, 4, 64))
                             .astype(np.float32)) for _ in range(2)]
    c = {k: inp[k] for k in ("env_seg", "freq_res", "e_bands", "q_bands",
                             "harm_act", "delta_e", "noise_start", "nlow")}
    c["xh"], c["xl"] = xh, xl.reshape(lanes, n, NSLOT, 64)
    return stage, c, hist[0], hist[1]


def _gather(row, b):
    """row [..., nb] at each bin's band b [m]; 0 where b < 0."""
    return torch.where(b >= 0, row[..., b.clamp(min=0)], 0.0)


def _span_sum(x, span):
    """x [..., m]: each bin's sum of x over its span, in bin order, from 0."""
    out = torch.zeros_like(x)
    for i, (a, b) in enumerate(span.tolist()):
        acc = torch.zeros(x.shape[:-1])
        for r in range(a, b):
            acc = acc + x[..., r]
        out[..., i] = acc
    return out


def _levels(c, maps, lim_gain, interpol):
    """The kernel's envelope phases on packets c ([N, P, ...] inputs), each
    (envelope, bin) pair on its own and each band or limiter sum over the
    bin's span: (gain, qm, sm, smap) [N, P, 5, m] after the limiter and the
    boost."""
    seg = c["env_seg"].float()
    res = c["freq_res"].float()[..., None]
    de = c["delta_e"].float()[..., None]
    hi, lo = maps["band_hi"].long(), maps["band_lo"].long()
    lim = maps["lim_band"].long()
    eo = res * _gather(c["e_bands"], hi) + (1.0 - res) * _gather(
        c["e_bands"], lo)
    qo = _gather(c["q_bands"], maps["band_noise"].long())
    act = c["harm_act"].float()
    smap = _gather(act, hi)
    sbin = _gather(act, maps["sin_band"].long())
    cnt = torch.zeros(seg.shape[:2] + (5, 1))
    acc = torch.zeros_like(eo)
    for t in range(NSLOT):
        h = c["xh"][:, :, t]
        e2 = h[..., 0] * h[..., 0] + h[..., 1] * h[..., 1]
        sg = seg[:, :, t, :, None]
        cnt = cnt + sg
        acc = acc + sg * e2[:, :, None]
    ec = acc / torch.clamp(cnt, min=1.0)
    if not interpol:
        hb = torch.where(hi >= 0, _span_sum(ec, maps["hi_span"])
                         / maps["w_hi"][hi.clamp(min=0)], 0.0)
        lb = torch.where(lo >= 0, _span_sum(ec, maps["lo_span"])
                         / maps["w_lo"][lo.clamp(min=0)], 0.0)
        ec = res * hb + (1.0 - res) * lb
    q_frac = qo / (1.0 + qo)
    gain = torch.where(smap > 0, torch.sqrt(eo * q_frac / (1.0 + ec)),
                       torch.sqrt(eo / ((1.0 + ec) * (1.0 + de * qo))))
    qm = torch.sqrt(eo * q_frac)
    sm = torch.where(sbin > 0, torch.sqrt(eo / (1.0 + qo)), 0.0)
    eol = _span_sum(eo, maps["lim_span"])
    g_max = torch.where(lim >= 0, torch.clamp(
        lim_gain * torch.sqrt((AST.EPS + eol) / (AST.EPS + _span_sum(
            ec, maps["lim_span"]))), max=AST.G_MAX_CAP), 0.0)
    qm = torch.where(gain > g_max, qm * g_max / torch.clamp(gain, min=AST.EPS),
                     qm)
    gain = torch.minimum(gain, g_max)
    got = gain * gain * ec + de * (qm * qm * (1.0 - smap)) + sm * sm
    boost = torch.where(lim >= 0, torch.clamp(torch.sqrt(
        (AST.EPS + eol) / (AST.EPS + _span_sum(got, maps["lim_span"]))),
        max=AST.MAX_BOOST), 0.0)
    return gain * boost, qm * boost, sm * boost, smap


def _expand(seg, x):
    """seg [N, 32, 5], x [N, 5, m] -> [N, 32, m], summed over envelopes
    from 0 in envelope order."""
    acc = torch.zeros(seg.shape[:2] + x.shape[-1:])
    for v in range(5):
        acc = acc + seg[:, :, v, None] * x[:, None, v]
    return acc


OWN = 2  # packets a CTA


def _k16c_model(c, g_hist, q_hist, stage):
    """K16c as the kernel splits it: CTA (n, c) runs the envelope phases
    of packets 2 c and 2 c + 1 of lane n side by side, from their own
    inputs alone; with smoothing also those of packet 2 c - 1 (its own
    inputs again, not its CTA's results), whose last 4 raw rows the
    filter of packet 2 c reads (packet 0 reads the carried history, packet
    2 c + 1 the rows of packet 2 c).  Each CTA writes the groups of 4 bins
    no gain reaches from xl x nlow (or zeros), then the others.  Returns
    (X, new g_hist, new q_hist, how often each X cell was written)."""
    maps, kx, smooth = stage.maps(), stage.kx, stage.smooth
    lanes, kp = c["env_seg"].shape[:2]
    m = maps["band_hi"].numel()
    x = torch.full((2, lanes, kp, NSLOT, 64), float("nan"))
    written = torch.zeros(x.shape, dtype=torch.int32)
    g_lo, g_hi = kx >> 2, (kx + m - 1) >> 2
    bins = torch.arange(m)
    nz_tab = stage.noise_tab
    ph = (torch.arange(NSLOT)[:, None] + bins[None]) & 3
    ph_r = (ph == 0).float() - (ph == 2).float()
    ph_i = (ph == 1).float() - (ph == 3).float()

    new_g = new_q = None
    for k0 in range(0, kp, OWN):
        nown = min(OWN, kp - k0)
        prior = 1 if smooth and k0 > 0 else 0
        staged = range(k0 - prior, k0 + nown)
        lev = _levels({key: val[:, staged.start:staged.stop]
                       for key, val in c.items()}, maps, stage.lim_gain,
                      stage.interpol)                        # [N, ns, 5, m]
        raw = [(_expand(c["env_seg"][:, k].float(), lev[0][:, j]),
                _expand(c["env_seg"][:, k].float(), lev[1][:, j]))
               for j, k in enumerate(staged)]
        for o in range(nown):
            k, j = k0 + o, prior + o
            gain, qm, sm, smap = (a[:, j] for a in lev)      # [N, 5, m]
            seg = c["env_seg"][:, k].float()                 # [N, 32, 5]
            dl = c["delta_e"][:, k].float()                  # [N, 5]
            xl = c["xl"][:, k]
            low = c["nlow"][:, k][:, None]                   # [N, 1, 32]
            # the gain-free groups, as soon as xl lands
            for g in [g for g in range(16) if not g_lo <= g <= g_hi]:
                cols = slice(4 * g, 4 * g + 4)
                if g < 8:
                    x[0, :, k, :, cols] = xl[..., cols] * low[..., cols]
                    x[1, :, k, :, cols] = xl[..., 32 + 4 * g:36 + 4 * g] \
                        * low[..., cols]
                else:
                    x[:, :, k, :, cols] = 0.0
                written[:, :, k, :, cols] += 1
            cov = torch.zeros(lanes, NSLOT)
            ok = torch.zeros(lanes, NSLOT)
            for v in range(5):
                cov = cov + seg[:, :, v]
                ok = ok + seg[:, :, v] * dl[:, v, None]
            cov, ok = cov[..., None], ok[..., None]
            gs, qs = raw[j]
            sms = _expand(seg, sm)
            if smooth:
                gate = _expand(seg, dl[..., None] * (1.0 - smap))
                if j == 0:
                    hg, hq = g_hist[:, :, :m], q_hist[:, :, :m]
                else:
                    hg, hq = (r[:, NSLOT - 4:] for r in raw[j - 1])
                rg = torch.cat([hg, gs], 1)
                rq = torch.cat([hq, qs], 1)
                gf = qf = torch.zeros(lanes, NSLOT, m)
                for d in range(5):
                    gf = gf + AST.H_SMOOTH[d] * rg[:, 4 - d:4 - d + NSLOT]
                    qf = qf + AST.H_SMOOTH[d] * rq[:, 4 - d:4 - d + NSLOT]
                gain_s = ok * gf + (1.0 - ok) * gs
                qm_s = gate * (ok * qf + (1.0 - ok) * qs)
                if k == kp - 1:
                    pad = torch.zeros(lanes, 4, 64 - m)
                    new_g = torch.cat([gs[:, NSLOT - 4:], pad], 2)
                    new_q = torch.cat([qs[:, NSLOT - 4:], pad], 2)
            else:
                gain_s = gs
                qm_s = _expand(seg, dl[..., None] * qm * (1.0 - smap))
            nz = nz_tab[((c["noise_start"][:, k][..., None] + 1 + bins)
                         & 511).long()]
            h = c["xh"][:, k]
            yr = (h[..., 0] * gain_s + qm_s * nz[..., 0] + sms * ph_r) * cov
            yi = (h[..., 1] * gain_s + qm_s * nz[..., 1] + sms * ph_i) * cov
            for g in range(g_lo, g_hi + 1):
                for b in range(4 * g, 4 * g + 4):
                    xr = xi = torch.zeros(lanes, NSLOT)
                    if b < 32:
                        xr = xl[..., b] * low[..., b]
                        xi = xl[..., 32 + b] * low[..., b]
                    if kx <= b < kx + m:
                        xr = xr + yr[..., b - kx]
                        xi = xi + yi[..., b - kx]
                    x[0, :, k, :, b] = xr
                    x[1, :, k, :, b] = xi
                    written[:, :, k, :, b] += 1
    return x, new_g, new_q, written


@pytest.mark.parametrize("kp", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("name", ["smooth", "tr_smooth"])
def test_k16c_smoothing_split(name, kp):
    """The model of K16c's split equals the plain version bit for bit on
    the first ``kp`` packets of a smoothing stream: X, and the new g_hist
    and q_hist; every X cell written once."""
    stage, c, g_hist, q_hist = _stream(name)
    assert stage.smooth
    c = {k: v[:, :kp].contiguous() for k, v in c.items()}
    if name == "tr_smooth" and kp >= 8:
        # transient envelopes (delta 0, packets 3, 6, ...) bypass the filter
        assert (c["delta_e"] == 0).any() and (c["delta_e"] == 1).any()
    got = _k16c_model(c, g_hist, q_hist, stage)
    lanes = c["xh"].shape[0]
    want = AST.sbr_hf_adjust_plain(
        c["xh"], c["xl"].reshape(lanes, kp * NSLOT, 64), c["env_seg"],
        c["freq_res"], c["e_bands"], c["q_bands"], c["harm_act"],
        c["delta_e"], c["noise_start"], c["nlow"], g_hist, q_hist,
        stage.maps(), stage.noise_tab, stage.kx, stage.lim_gain,
        stage.interpol, stage.smooth)
    assert torch.equal(got[3], torch.ones_like(got[3]))
    assert _bit_equal(got[0], want[0])
    assert _bit_equal(got[1], want[1]) and _bit_equal(got[2], want[2])


def test_k16c_interpol0_split():
    """The same model under the interpol_freq=0 header (e_curr flattened
    over each bin's band span) on 8 packets: X equal bit for bit."""
    stage, c, _, _ = _stream("interpol0")
    assert not stage.interpol and not stage.smooth
    c = {k: v[:, :8].contiguous() for k, v in c.items()}
    got = _k16c_model(c, None, None, stage)
    want = AST.sbr_hf_adjust_plain(
        c["xh"], c["xl"].reshape(-1, 8 * NSLOT, 64), c["env_seg"],
        c["freq_res"], c["e_bands"], c["q_bands"], c["harm_act"],
        c["delta_e"], c["noise_start"], c["nlow"], None, None, stage.maps(),
        stage.noise_tab, stage.kx, stage.lim_gain, stage.interpol,
        stage.smooth)
    assert torch.equal(got[3], torch.ones_like(got[3]))
    assert _bit_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# the bin spans that replace K16c's all-bins loops
# ---------------------------------------------------------------------------

_HEADERS = {"default": S.SbrHeader(), "interpol0": _INTERPOL0,
            "smooth": _SMOOTH}


@pytest.mark.parametrize("which", [("band_hi", "hi_span", "n_high"),
                                   ("band_lo", "lo_span", "n_low"),
                                   ("lim_band", "lim_span", "n_lim")],
                         ids=["high", "low", "limiter"])
@pytest.mark.parametrize("header", sorted(_HEADERS))
def test_band_spans(header, which):
    """Each bin's sum over its band's span, in bin order from 0, equals the
    plain version's masked sum over all bins (``_band_sums``) read at the
    bin's band; a bin of no band has the empty span (0, 0)."""
    band, span, count = which
    ft = S.derive_tables(_HEADERS[header])
    maps = AST.band_maps(ft)
    idx = torch.from_numpy(maps[band])
    spans = torch.from_numpy(maps[span])
    m = idx.numel()
    assert spans.shape == (m, 2) and spans.dtype == torch.int32
    assert torch.equal(spans[idx < 0], torch.zeros(int((idx < 0).sum()), 2,
                                                   dtype=torch.int32))
    rng = np.random.default_rng(1666)
    x = torch.from_numpy(rng.uniform(0.0, 1e4, (7, 5, m)).astype(np.float32))
    masked = AST._band_sums(x, idx, getattr(ft, count))
    want = AST._gather_bins(masked, idx)
    assert _bit_equal(_span_sum(x, spans), want)
