"""K10 (the FM cold start's CFO scan, csrc/cfo_scan.cu) and K16b (the SBR
HF generator, csrc/sbr_hf_generate.cu) as their kernels split the work,
held on the CPU to the port's plain versions and, for K10, to the JAX
package's ``detect_cfo_scan_rc``.  The kernels run only on a card
(tests/test_torch_kernels.py); here what each does differently from its
plain version is checked:

- K10 runs a CTA a station and CFO residue r mod 19: the 4 CFOs r + 19 q
  and their 88 tracks read 14 distinct bins a sideband, staged once, with
  each bin's 32 angles taken once; a track's thread runs only the phase
  and frequency recursion from those angles, keeping its phases; each
  group of 8 steps' derotations follows it, one ballot packing the 8
  signs of 4 tracks, a byte a (track, group) of the track's word; the
  count is a funnel shift of each word per offset against the needle
  masks.  A torch model of that split equals the plain scan bit for bit
  and JAX's scan on captures with integer CFOs of both signs and at the
  range's edges (the scan's -38 and +37 bins).  The tables: the two bin
  runs (440-705, 1342-1607) hold every bin the scan reads, and the
  residue split reads each of a station's 532 distinct bins once and
  gives every track the bin of ``_scan_tables``.
- K16b runs a CTA a (lane, packet) over its window of xl (the packet's 32
  slots and the 2 before them, packet 0's from the carried tails), the LPC
  a lane a band with each covariance summed from 0 in slot order and the
  slots' values rolled through registers, each band's predictors, then the
  patch a lane a bin over a warp's run of slots, the bin's coefficients
  from its source band's predictors.  A torch model of that split equals
  ``sbr_hf_generate_plain`` bit for bit on the three audio streams of
  ``chip_smoke.py`` and on random inputs at m's extremes (1 and 64 bins,
  bands whose predictors fall to zero or past the |alpha| >= 4 guard).
- On a tensor that is not on the CPU, the PLL's and the needle count's
  wrappers raise, and K10's and K16b's take no plain path (a ``meta``
  tensor stands in for a card's).

Inputs are made with numpy from seeds.  Torch runs on one thread.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nrsc5_tpu.ops import acquire_rc as JAQ
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.audio import stage as AST
from nrsc5_tpu_torch.audio.batch import BatchedAudioDecoder
from nrsc5_tpu_torch.ops import costas as CO
from nrsc5_tpu_torch.ops import detect_cfo as DC
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops import sync_fm as SF
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
from nrsc5_tpu_torch.tx.modulator import modulate_fm

BIN_HZ = C.SAMPLE_RATE_CS16_FM / C.FFT_FM
WIDTH = C.PARTITION_WIDTH_FM  # CFO residues
NQ = DC.N_CFO // WIDTH  # CFOs of a residue
NB = NQ + DC.N_REFS - 1  # distinct bins a sideband and residue


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K10: a CTA a station and CFO residue
# ---------------------------------------------------------------------------

def _track_bin_index():
    """Each track's (residue r, CFO quotient q, side, staged bin j), in the
    scan's track order (cfo * 22 + ref), as the kernel derives them."""
    out = []
    for c in range(DC.N_CFO):
        r, q = c % WIDTH, c // WIDTH
        for ref in range(2 * DC.N_REFS):
            side, i = divmod(ref, DC.N_REFS)
            out.append((r, q, side, q - i + DC.N_REFS - 1 if side else q + i))
    return out


def _k10_model(spectra):
    """K10 as the kernel splits it: for each station and residue, the 28
    staged bins and their angles once, the 88 tracks' recursions from
    them, then each group of 8 steps' derotation signs as a byte of the
    track's word (the kernel's ballot of 4 tracks x 8 steps, lane 8 ti +
    kk), then each (CFO, offset)'s count by a funnel shift of each
    word."""
    s_n = spectra.shape[0]
    t = DC._scan_tables("cpu")
    vals = t["vals_mask"].numpy().astype(np.uint32)
    known = t["known_mask"].numpy().astype(np.uint32)
    count = np.full((s_n, DC.N_CFO, C.BLKSZ), -1, np.int64)
    q = torch.arange(NQ).repeat_interleave(2 * DC.N_REFS)
    ref = torch.arange(2 * DC.N_REFS).repeat(NQ)
    side, i = ref // DC.N_REFS, ref % DC.N_REFS
    j = torch.where(side == 1, q - i + DC.N_REFS - 1, q + i)
    o = np.arange(C.BLKSZ, dtype=np.uint32)
    for s in range(s_n):
        for r in range(WIDTH):
            first = torch.tensor([DC.LB_FIRST, DC.UB_FIRST])
            bins = first[:, None] + r + WIDTH * torch.arange(NB)  # [2, 14]
            sv = spectra[s][:, bins].permute(1, 2, 0, 3)  # [2, 14, 32, 2]
            ang = rc.angle(rc.mul(sv, sv))  # once a staged value
            a = ang[side, j]  # [88, 32]
            cf = t["cfo_freq"][r + WIDTH * q]
            ph = torch.zeros(len(q))
            fr = torch.zeros(len(q))
            phs = []
            for k in range(C.BLKSZ):
                phs.append(ph)
                err = 0.5 * CO.wrap_pi(a[:, k] - 2 * ph)
                fr = torch.clamp(fr + SF.BETA * err, -0.5, 0.5)
                ph = CO.wrap_pi(ph + fr + cf + SF.ALPHA * err)
            phs = torch.stack(phs, 1)  # [88, 32]
            d = rc.mul(sv[side, j], rc.exp_i(-phs))[..., 0]
            words = np.zeros(len(q), np.uint32)
            for g in range(C.BLKSZ // 8):
                # the ballot of lanes 8 ti + kk over 4 tracks, split by track
                for q4 in range(len(q) // 4):
                    tr = slice(4 * q4, 4 * q4 + 4)
                    signs = (d[tr, 8 * g:8 * g + 8] > 0).numpy()
                    ballot = sum(int(signs[ti, kk]) << (8 * ti + kk)
                                 for ti in range(4) for kk in range(8))
                    for ti in range(4):
                        byte = (ballot >> (8 * ti)) & 0xFF
                        words[4 * q4 + ti] |= np.uint32(byte << (8 * g))
            words = words.reshape(NQ, 2 * DC.N_REFS)
            for qq in range(NQ):
                w = words[qq][:, None]
                rot = (w >> o) | (w << ((32 - o) % 32))  # funnel shift
                rot = np.where(o == 0, w, rot)
                eq = ((rot ^ vals[:, None]) & known[:, None]) == 0
                neq = ((rot ^ ~vals[:, None]) & known[:, None]) == 0
                count[s, r + WIDTH * qq] = (eq | neq).sum(0)
    return torch.from_numpy(count.astype(np.int32))


def _k10_spectra(seed, cfo_bins, frac_hz, sample_offset):
    """One station's probe spectra as the JAX package's cold start makes
    them: 2 blocks of MP1 at 25 dB behind ``sample_offset`` and shifted by
    ``cfo_bins`` bins plus ``frac_hz``, conjugated as the FM ingest does,
    timed by the coarse timing and demodulated at CFO 0."""
    rng = np.random.default_rng(seed)
    matrix = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))[
            :2 * C.BLKSZ]
    sig = ch.impair(modulate_fm(matrix, np.arange(3, 5), 1),
                    sample_offset=sample_offset,
                    cfo_hz=cfo_bins * BIN_HZ + frac_hz, snr_db=25.0, rng=rng)
    win = np.stack([sig.real, -sig.imag], -1).astype(np.float32)[
        :JAQ.WINDOW_FM]
    js, jv = JAQ.coarse_timing_rc(jnp.asarray(win))
    spectra, _, _, _ = JAQ.demod_rc(
        jnp.asarray(win), jnp.asarray(np.array([1.0, 0.0], np.float32)), js,
        jnp.arctan2(jv[1], jv[0]), jnp.int32(0))
    return spectra


@pytest.mark.parametrize("cfo_bins,frac_hz,offset", [
    (-7, -30.0, 1357), (5, 41.0, 2789), (38, 20.0, 611), (-37, -25.0, 1999)],
    ids=["minus7", "plus5", "edge_minus38", "edge_plus37"])
def test_k10_split(cfo_bins, frac_hz, offset):
    """The model of K10's split equals the plain scan bit for bit, and
    JAX's scan, on one station's probe spectra; the peak sits at the
    station's CFO (negated by the FM ingest's conjugation), the scan's
    edges included."""
    spectra = _k10_spectra(100 + cfo_bins, cfo_bins, frac_hz, offset)
    want_jax = np.asarray(JAQ.detect_cfo_scan_rc(spectra))
    x = torch.from_numpy(np.array(spectra))[None]
    plain = DC.detect_cfo_scan_rc(x, plain=True)
    got = _k10_model(x)
    assert got.dtype == plain.dtype == torch.int32
    assert torch.equal(got, plain)
    assert np.array_equal(got[0].numpy(), want_jax)
    ci = int(got[0].flatten().argmax()) // C.BLKSZ
    assert ci - DC.CFO_RANGE == -cfo_bins


def test_k10_runs_cover_scan_bins():
    """The two runs the kernel's bins lie in hold every bin of the scan's
    table, and each run is read: lower 440-705, upper 1342-1607."""
    bins = DC._scan_tables("cpu")["bins"].numpy()
    assert (DC.LB_FIRST, DC.UB_FIRST, DC.RUN) == (440, 1342, 266)
    lo = bins[(bins >= DC.LB_FIRST) & (bins < DC.LB_FIRST + DC.RUN)]
    hi = bins[(bins >= DC.UB_FIRST) & (bins < DC.UB_FIRST + DC.RUN)]
    assert len(lo) + len(hi) == len(bins) == DC.N_TRACKS
    assert set(lo) == set(range(DC.LB_FIRST, DC.LB_FIRST + DC.RUN))
    assert set(hi) == set(range(DC.UB_FIRST, DC.UB_FIRST + DC.RUN))


def test_k10_residue_split_reads_each_bin_once():
    """Every track's staged bin under the residue split is the bin of
    ``_scan_tables``; each (residue, side, j) is a distinct bin, so the
    19 CTAs of a station read its 532 distinct bins once, and a CTA's 88
    tracks read its 28 bins."""
    bins = DC._scan_tables("cpu")["bins"].numpy()
    first = (DC.LB_FIRST, DC.UB_FIRST)
    staged = {}
    for track, (r, q, side, j) in enumerate(_track_bin_index()):
        assert 0 <= j < NB and 0 <= q < NQ
        b = first[side] + r + WIDTH * j
        assert b == bins[track]
        staged.setdefault((r, side, j), b)
    assert len(staged) == WIDTH * 2 * NB == len(set(bins)) == 532
    assert len(set(staged.values())) == len(staged)


# ---------------------------------------------------------------------------
# K16b: a CTA a (lane, packet), the LPC a lane a band, the patch a lane a bin
# ---------------------------------------------------------------------------

# each covariance's (a, b) slots before v0 and whether it is the imaginary
# part of conj(a) b: p01r, p01i, p11, p02r, p02i, p12r, p12i, p22
_COV = [(1, 0, False), (1, 0, True), (1, 1, False), (2, 0, False),
        (2, 0, True), (2, 1, False), (2, 1, True), (2, 2, False)]


def _k16b_model(xl, tail_r, tail_i, bwj, src_idx, src_ok, kx):
    """K16b as the kernel splits it: each packet's window of 34 slot rows
    ([re | im] each), the 8 covariance sums of every band one add a slot
    from 0, every band's predictors, then each bin's coefficients from its
    source band's predictors and the patch over the slots."""
    n, kp, m = bwj.shape
    rows = xl.reshape(n, kp * AST.NSLOT, 64)
    xh = torch.full((n, kp, AST.NSLOT, m, 2), float("nan"))
    b = src_idx.long()
    for k in range(kp):
        if k == 0:
            win = torch.cat([torch.cat([tail_r, tail_i], dim=2),
                             rows[:, :AST.NSLOT]], dim=1)
        else:
            win = rows[:, AST.NSLOT * k - 2:AST.NSLOT * (k + 1)]
        assert win.shape == (n, AST.NSLOT + 2, 64)
        sums = []
        for da, db, im in _COV:
            acc = torch.zeros(n, 32)
            for s in range(AST.NSLOT):
                ar, ai = win[:, s + 2 - da, :32], win[:, s + 2 - da, 32:]
                br, bi = win[:, s + 2 - db, :32], win[:, s + 2 - db, 32:]
                acc = acc + (ar * bi - ai * br if im else ar * br + ai * bi)
            sums.append(acc)  # [n, 32]: a band a lane
        p01r, p01i, p11, p02r, p02i, p12r, p12i, p22 = sums
        d = p22 * p11 - (p12r * p12r + p12i * p12i) / AST.LPC_DIV
        d_ok = d.abs() > AST.EPS
        dd = torch.where(d_ok, d, 1.0)
        b1r = torch.where(d_ok, (p01r * p12r - p01i * p12i - p02r * p11) / dd,
                          0.0)
        b1i = torch.where(d_ok, (p01r * p12i + p01i * p12r - p02i * p11) / dd,
                          0.0)
        p_ok = p11.abs() > AST.EPS
        pp = torch.where(p_ok, p11, 1.0)
        t0r = b1r * p12r - b1i * -p12i
        t0i = b1r * -p12i + b1i * p12r
        b0r = torch.where(p_ok, -(p01r + t0r) / pp, 0.0)
        b0i = torch.where(p_ok, -(p01i + t0i) / pp, 0.0)
        big = (b0r * b0r + b0i * b0i >= 16.0) | (b1r * b1r + b1i * b1i
                                                  >= 16.0)
        band = torch.arange(32)
        mask = (~big & (band >= 1) & (band < min(kx + 1, 32))).float()
        b0r, b0i, b1r, b1i = (torch.where(big, 0.0, x)
                              for x in (b0r, b0i, b1r, b1i))
        a0r, a0i, a1r, a1i = (x * mask for x in (b0r, b0i, b1r, b1i))
        bw = bwj[:, k]
        bw2 = bw * bw
        c1r, c1i = bw * a0r[:, b], bw * a0i[:, b]
        c2r, c2i = bw2 * a1r[:, b], bw2 * a1i[:, b]
        c1r, c1i, c2r, c2i = (c[:, None] for c in (c1r, c1i, c2r, c2i))
        s0r, s0i = win[:, 2:, b], win[:, 2:, 32 + b]  # [n, 32, m]
        s1r, s1i = win[:, 1:-1, b], win[:, 1:-1, 32 + b]
        s2r, s2i = win[:, :-2, b], win[:, :-2, 32 + b]
        hr = s0r + (c1r * s1r - c1i * s1i) + (c2r * s2r - c2i * s2i)
        hi = s0i + (c1r * s1i + c1i * s1r) + (c2r * s2i + c2i * s2r)
        xh[:, k, ..., 0] = hr * src_ok
        xh[:, k, ..., 1] = hi * src_ok
    last = rows[:, -2:]
    return xh, last[..., :32].contiguous(), last[..., 32:].contiguous()


@functools.lru_cache(maxsize=None)
def _audio_inputs(kind):
    """One program of ``chip_smoke.py``'s audio stream ``kind``, its
    packets decoded once and prepared again by a one-program decoder on
    the CPU (so the carried tails are not zero), xl by K16a's plain
    version: the arguments of K16b."""
    pkts = chip_smoke.make_audio_stream(kind)
    dec = BatchedAudioDecoder(1, device="cpu")
    dec.decode([pkts])
    stage, inp, smooth, key = dec.prepare([pkts])
    dec._reconcile_state(smooth, key)
    inp = {k: torch.from_numpy(v) for k, v in inp.items()}
    st = dec._state
    lanes, kp = inp["spec_long"].shape[:2]
    xl = AST.window_qmf_analysis_plain(
        torch.matmul(inp["spec_long"].reshape(lanes * kp, -1),
                     stage.blt).reshape(lanes, kp, 2048),
        torch.matmul(inp["spec_short"].reshape(lanes * kp * 8, -1),
                     stage.bst).reshape(lanes, kp, 8, 256),
        inp["win_long_idx"], inp["win_short_idx"], inp["short"],
        st["overlap"], st["qa_hist"], stage.lut_long, stage.lut_short,
        stage.ka)[0]
    return (xl, st["tail_r"], st["tail_i"], inp["bwj"], stage.src_idx,
            stage.src_ok, stage.kx)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", chip_smoke.AUDIO_STREAMS)
def test_k16b_split_streams(kind):
    """The model of K16b's split equals the plain version bit for bit on
    each audio stream of ``chip_smoke.py`` (stereo steady, stereo with
    transients, mono), 8 packets: x_high and the new tails; the tails it
    read were not zero."""
    args = _audio_inputs(kind)
    assert args[1].abs().max() > 0
    _equal(_k16b_model(*args), AST.sbr_hf_generate_plain(*args))


@pytest.mark.parametrize("m,kp", [(1, 1), (1, 3), (64, 1), (64, 3)])
def test_k16b_split_m_extremes(m, kp):
    """The same on random inputs at m = 1 and 64 bins (sources across all
    32 bands, repeated, some masked off), 1 and 3 packets of 3 lanes; band
    7 is zero everywhere (both predictors fall to zero), band 11 a
    geometric ramp by 4.5 a slot within each packet (packet 0's |alpha0|
    past 4: the guard zeroes it)."""
    rng = np.random.default_rng(1617 + m + kp)
    n = 3

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32))
    xl = f32(n, kp * AST.NSLOT, 64)
    xl[:, :, 7] = 0.0
    xl[:, :, 32 + 7] = 0.0
    # band 11: x[t] = 4.5 x[t - 1] over each packet, the tails continuing
    # packet 0's, so that its alpha0 is -4.5
    ramp = (1e-20 * 4.5 ** np.arange(-2, AST.NSLOT)).astype(np.float32)
    xl[:, :, 11] = torch.from_numpy(np.tile(ramp[2:], kp))
    xl[:, :, 32 + 11] = 0.0
    tail_r, tail_i = f32(n, 2, 32), f32(n, 2, 32)
    tail_r[:, :, 7] = tail_i[:, :, 7] = tail_i[:, :, 11] = 0.0
    tail_r[:, :, 11] = torch.from_numpy(ramp[:2])
    src = rng.integers(0, 32, m).astype(np.int32)
    src[: min(m, 3)] = [11, 7, 0][:min(m, 3)]
    args = (xl, tail_r, tail_i,
            torch.from_numpy(rng.uniform(0.0, 1.0, (n, kp, m)).astype(
                np.float32)),
            torch.from_numpy(src),
            torch.from_numpy(rng.integers(0, 2, m).astype(np.float32)), 21)
    got = _k16b_model(*args)
    _equal(got, AST.sbr_hf_generate_plain(*args))
    assert not torch.isnan(got[0]).any()
    if m == 1:  # bin 0 reads band 11: packet 0 copies it unpredicted
        assert torch.equal(got[0][:, 0, :, 0, 0],
                           xl[:, :AST.NSLOT, 11] * args[5][0])


# ---------------------------------------------------------------------------
# no plain path off the CPU
# ---------------------------------------------------------------------------

def test_off_cpu_tensors_take_no_plain_path():
    """A tensor that is not on the CPU (``meta`` here, a card's on the
    card) never reaches a plain version: the PLL's and the needle count's
    wrappers raise, and K10's and K16b's wrappers refuse it where they
    would launch."""
    meta = torch.device("meta")
    refs = torch.empty(C.BLKSZ, 10, 2, device=meta)
    z = torch.empty(10, device=meta)
    with pytest.raises(ValueError, match="inside K10"):
        CO.costas_track_rc(refs, z, z, z)
    with pytest.raises(ValueError, match="inside K10"):
        DC.needle_count(torch.empty(C.BLKSZ, 1, DC.N_TRACKS, 2, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        DC.detect_cfo_scan_rc(torch.empty(1, C.BLKSZ, C.FFT_FM, 2,
                                          device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        AST.sbr_hf_generate(torch.empty(1, AST.NSLOT, 64, device=meta),
                            torch.empty(1, 2, 32, device=meta),
                            torch.empty(1, 2, 32, device=meta),
                            torch.empty(1, 1, 5, device=meta),
                            torch.zeros(5, dtype=torch.int32, device=meta),
                            torch.empty(5, device=meta), 20)
