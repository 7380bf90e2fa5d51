"""Each hand kernel of the port against its plain PyTorch version, on the
card.  Needs a CUDA card and ``nvcc`` (the kernels build at first use);
without a card every test here skips.  On the card, run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest``: tests/conftest.py imports JAX, which these tests do not
need.)

Tolerances:

- K1 (halfband, and its AM cascade), K6 (FEC gather), K7 (Viterbi, K=7
  and K=9), K8 (FEC epilogue), K9 (coarse timing), the needle count of
  K10, K11 (PX deinterleave) and K15 (AM gather) exact: no FMA contraction
  and the same operation order, integer path metrics, integer counts, and
  gathers of int8 values or bits;
- K14 (the AM cold start's tone estimate, coarse timing and CFO step)
  exact, floats too: every sum runs in the plain version's order (the
  8910-sample sums strided over 256 threads, then a fixed pairwise tree),
  the phases are the same float32 product chains, and kernel and PyTorch
  call the same cosf, sinf, atan2f and sqrtf;
- K12 (AM fold) within 1e-5 of the largest value (at least 1), its keep
  exact; K13 (AM sync block) exact on every code, PIDS code, reference
  bit and samperr: its plain version sums in K13's order, divides as K13
  does and calls the same float32 functions, so an equalized value could
  move across a decision threshold only by a last-bit difference of sin,
  cos or atan2 between the kernel's build and PyTorch's;
- K2 (demod fold), K3 (Costas) and the float outputs of K4 (sync block)
  within 1e-5 of the largest value (at least 1): float32 sin, cos and
  atan2 may differ in the last bit between the kernel's build and
  PyTorch's (K4's plain version sums in K4's order and divides by numbers
  as K4 does, so at chip_smoke.py's inputs the two agree exactly);
- K4's ref_ok, ref_bc, ref_psmi and samperr exact; its int8 soft bits (pm,
  px1, px2) within ±1 on at most 0.1 % of values (a reduction's last bit can move a
  product across a .5 rounding edge).  These hold K4 at states the chain
  produces.  Off that path (timing no lock gives, a random Costas state)
  the MER sums error_lb/ub are ill-conditioned in float32, so there they
  are held to a float64 evaluation instead: the kernel's error within 4×
  the larger of the plain version's own float32 error, the float64 sums'
  spread under a one-ulp change of the inputs, and one ulp.
"""

import json

import numpy as np
import pytest
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import acquire_am_rc as AA
from nrsc5_tpu_torch.ops import acquire_rc as AQ
from nrsc5_tpu_torch.ops import convolutional as CV
from nrsc5_tpu_torch.ops import costas as CO
from nrsc5_tpu_torch.ops import decode_am as DA
from nrsc5_tpu_torch.ops import decode_fm as DF
from nrsc5_tpu_torch.ops import detect_cfo as DC
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.pipeline.scan_chain import px_frame_lens
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx import encoder_am as EAM
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
from nrsc5_tpu_torch.tx.modulator import modulate_fm
from nrsc5_tpu_torch.tx.modulator_am import modulate_am

BIN_HZ = C.SAMPLE_RATE_CS16_FM / C.FFT_FM

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, tol):
    scale = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= tol * scale


def test_halfband_cu8(card):
    g = torch.Generator().manual_seed(1)
    wire = torch.randint(0, 256, (3, 14 + 2 * 100_003, 2), generator=g,
                         dtype=torch.uint8).to(card)
    before = K.COUNTS["halfband_cu8"]
    got = FE.ingest_fm_cu8(wire)
    assert K.COUNTS["halfband_cu8"] == before + 1
    assert torch.equal(got, FE.ingest_fm_cu8_plain(wire))
    with pytest.raises(ValueError):
        FE.ingest_fm_cu8(wire.float())


@pytest.mark.parametrize("cfo", [-7, 0, 5])
def test_demod_fold(card, cfo):
    g = torch.Generator().manual_seed(2)
    s = 3
    samples = torch.randn(s, AQ.WINDOW_FM + 5000, 2, generator=g).to(card)
    offset = torch.tensor([0, 2500, 10_000], dtype=torch.int32, device=card)
    phase = torch.nn.functional.normalize(torch.randn(s, 2, generator=g),
                                          dim=-1).to(card)
    samperr = torch.tensor([1080, -3, 2500], dtype=torch.int32, device=card)
    angle = torch.tensor([0.01, -0.3, 0.2], device=card)
    cfos = torch.full((s,), cfo, dtype=torch.int32, device=card)
    args = (samples, offset, phase, samperr, angle, cfos)
    for got, want in zip(AQ.demod_fold(*args), AQ.demod_fold_plain(*args)):
        if want.dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            _close(got, want, 1e-5)


@pytest.mark.parametrize("with_cfo", [False, True])
def test_costas_track(card, with_cfo):
    g = torch.Generator().manual_seed(3)
    n = 1000
    # refs near the real axis, as locked reference subcarriers sit
    refs = torch.randn(C.BLKSZ, n, 2, generator=g) * torch.tensor([1.0, 0.2])
    refs = refs.to(card)
    ph0 = ((torch.rand(n, generator=g) - 0.5) * 0.2).to(card)
    fr0 = ((torch.rand(n, generator=g) - 0.5) * 0.01).to(card)
    cf = ((torch.rand(n, generator=g) - 0.5) * 0.5).to(card) \
        if with_cfo else None
    got = CO.costas_track_rc(refs, ph0, fr0, cf)
    want = CO.costas_track_rc_plain(refs, ph0, fr0, cf)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("length,sigma", [(144, 0.5), (1343, 0.5),
                                          (1343, 1.2)])
def test_viterbi_k7(card, length, sigma):
    rng = np.random.default_rng(4)
    b = 70
    bits = rng.integers(0, 2, (b, length)).astype(np.uint8)
    coded = CV.conv_encode(bits, 7, C.CONV_K7_GEN).reshape(b, length, 3)
    soft = (coded * 2.0 - 1.0) * 40 + rng.normal(0, sigma * 40, coded.shape)
    ext = torch.from_numpy(np.clip(np.round(soft), -127, 127)
                           .astype(np.float32)).to(card)
    kb, km = CV.acs_traceback(ext, C.CONV_K7_GEN)
    pb, pm = CV.acs_traceback_plain(ext, C.CONV_K7_GEN)
    assert torch.equal(kb, pb)
    assert torch.equal(km, pm)


def _capture(rng, psmi, sample_offset, cfo_hz, n_blocks=2):
    """``n_blocks`` blocks of one station at 25 dB, delayed and shifted in
    frequency, as the conjugated rc chain input [N, 2]; the PX partitions
    of the modes that have them carry random signs."""
    matrix = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))[
            :n_blocks * C.BLKSZ]
    px = {f"{k}_signs": rng.choice([-1, 1], (n_blocks * C.BLKSZ, fl // 32))
          .astype(np.int8) for k, fl in zip(("px1", "px2"),
                                             px_frame_lens(psmi)) if fl}
    sig = ch.impair(modulate_fm(matrix, np.arange(3, 3 + n_blocks), psmi,
                                **px),
                    sample_offset=sample_offset, cfo_hz=cfo_hz, snr_db=25.0,
                    rng=rng)
    return np.stack([sig.real, -sig.imag], -1).astype(np.float32)


def _spectra(card, captures, samperr, angle, cfo):
    x = torch.from_numpy(np.stack(captures)).to(card)
    s = x.shape[0]
    folded = AQ.demod_fold_plain(
        x, torch.zeros(s, dtype=torch.int32, device=card),
        torch.tensor([[1.0, 0.0]], device=card).repeat(s, 1),
        torch.tensor(samperr, dtype=torch.int32, device=card),
        torch.tensor(angle, dtype=torch.float32, device=card),
        torch.tensor(cfo, dtype=torch.int32, device=card))[0]
    return x, rc.dft(folded, shift=True)


def _sync_check(ko, kph, kfr, po, pph, pfr, floats=("angle", "error_lb",
                                                   "error_ub")):
    assert set(ko) == set(po)
    for k in ("ref_ok", "ref_bc", "ref_psmi", "samperr"):
        assert ko[k].dtype == po[k].dtype and torch.equal(ko[k], po[k]), k
    for k in ("pm", "px1", "px2"):
        if k in po:
            assert ko[k].shape == po[k].shape, k
            diff = (ko[k].int() - po[k].int()).abs()
            assert int(diff.max()) <= 1, k
            assert int((diff > 0).sum()) <= 1e-3 * diff.numel(), k
    for k in floats:
        _close(ko[k], po[k], 1e-5)
    _close(kph, pph, 1e-5)
    _close(kfr, pfr, 1e-5)


@pytest.mark.parametrize("psmi", [1, 2, 3, 5, 11])
def test_sync_block(card, psmi):
    """K4 at block 1 of three stations' chains: the nonzero Costas state
    that block 0 left, and timing_adj from a samperr feedback moved by 0,
    +2 and -3 samples (the fold follows it, as in the chain)."""
    rng = np.random.default_rng(5)
    caps = [_capture(rng, psmi, 0, f, n_blocks=3) for f in (0.0, 20.0, -35.0)]
    x = torch.from_numpy(np.stack(caps)).to(card)
    carry = rcc.chain_rc_init_carry(psmi=psmi, n_stations=3, device=card)
    _, _, _, cy = rcc.frontend_scan_rc(x, carry, 1, psmi, plain=True)
    assert cy.costas_phase.abs().max() > 0.01
    samperr = C.FFTCP_FM // 2 + cy.samperr_fb + torch.tensor(
        [0, 2, -3], dtype=torch.int32, device=card)
    spectra = rc.dft(AQ.demod_fold_plain(x, cy.offset, cy.phase, samperr,
                                         cy.prev_angle - cy.angle_fb,
                                         cy.cfo)[0], shift=True)
    args = (spectra, cy.costas_phase, cy.costas_freq, psmi,
            C.FFTCP_FM // 2 - samperr)
    assert args[-1].abs().max() > 0
    before = K.COUNTS["sync_block"]
    got = rcc.sync_block_rc(*args)
    assert K.COUNTS["sync_block"] == before + 1
    _sync_check(*got, *rcc.sync_block_rc_plain(*args))


def test_sync_block_off_path_rounding(card):
    """K4 off the chain's path: folds at timing offsets no lock gives and a
    random Costas state (uniform +-0.1 rad per bin).  There the equalizer's
    two interpolation terms can nearly cancel, so the MER sums error_lb/ub
    are ill-conditioned in float32.  Witness: a float64 evaluation of the
    plain version, and its spread when the spectra and Costas state move
    by one float32 ulp.  The kernel's float32 sums must lie within 4× the
    larger of the plain version's own float32 error and that spread; the
    rest of the outputs keep the tolerances of test_sync_block.  Prints one
    JSON line of the relative errors (shown with ``-rP``)."""
    rng = np.random.default_rng(8)
    s = 16
    cap = torch.from_numpy(_capture(rng, 1, 0, 0.0, n_blocks=3)).to(card)
    x = cap[None].repeat(s, 1, 1).contiguous()
    g = torch.Generator().manual_seed(8)

    def draw(shape, lo, hi, dtype=torch.float32):
        if dtype == torch.int32:
            return torch.randint(lo, hi, shape, generator=g,
                                 dtype=dtype).to(card)
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(card)

    ang = draw((s,), 0.0, 2 * np.pi)
    phase = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    spectra = rc.dft(AQ.demod_fold_plain(
        x, draw((s,), 0, 3 * C.FFTCP_FM, torch.int32), phase,
        draw((s,), 1078, 1083, torch.int32), draw((s,), -0.01, 0.01),
        draw((s,), -3, 4, torch.int32))[0], shift=True)
    cph = draw((s, C.FFT_FM), -0.1, 0.1)
    cfr = draw((s, C.FFT_FM), -0.005, 0.005)
    adj = torch.zeros(s, dtype=torch.int32, device=card)
    ko, kph, kfr = rcc.sync_block_rc(spectra, cph, cfr, 1, adj)
    po, pph, pfr = rcc.sync_block_rc_plain(spectra, cph, cfr, 1, adj)
    _sync_check(ko, kph, kfr, po, pph, pfr, floats=("angle",))

    def sums(out):
        return torch.stack([out["error_lb"], out["error_ub"]]).double()

    def f64(*ins):
        return sums(rcc.sync_block_rc_plain(*ins, 1, adj)[0])

    ins = [a.double() for a in (spectra, cph, cfr)]
    exact = f64(*ins)
    scale = exact.abs().max().item()
    ulp = 2.0 ** -24
    spread = max((f64(*(a * (1 + ulp * (2 * draw(a.shape, 0, 2, torch.int32)
                                        - 1)) for a in ins))
                  - exact).abs().max().item() for _ in range(3)) / scale
    kern = (sums(ko) - exact).abs().max().item() / scale
    plain = (sums(po) - exact).abs().max().item() / scale
    gap = (sums(ko) - sums(po)).abs().max().item() / scale
    print(json.dumps({"kernel_vs_float64": kern, "plain_vs_float64": plain,
                      "kernel_vs_plain": gap, "float64_ulp_spread": spread}))
    assert kern <= 4 * max(plain, spread, ulp)


def test_coarse_timing(card):
    """K9 on three impaired windows: timing offsets, fractional and
    integer CFOs, noise."""
    rng = np.random.default_rng(6)
    caps = [_capture(rng, 1, off, f)[:AQ.WINDOW_FM + 100] for off, f in
            ((1357, 5 * BIN_HZ + 41.0), (2789, -7 * BIN_HZ - 30.0),
             (100, 12.0))]
    x = torch.from_numpy(np.stack(caps)).to(card)
    ks, kv = AQ.coarse_timing_rc(x)
    ps, pv = AQ.coarse_timing_rc_plain(x)
    assert torch.equal(ks, ps)
    assert torch.equal(kv, pv)


def test_needle_count(card):
    """The CFO scan on the probe's spectra of stations with a negative and
    a positive integer CFO: the needle count exact, and its peak at the
    true CFO (negated by the FM ingest's conjugation)."""
    rng = np.random.default_rng(7)
    true = (-7, 5)
    caps = [_capture(rng, 1, 0, c * BIN_HZ + 20.0) for c in true]
    x = torch.from_numpy(np.stack(caps)).to(card)
    samperr, max_v = AQ.coarse_timing_rc(x)
    _, spectra = _spectra(card, caps, samperr.tolist(),
                          rc.angle(max_v).tolist(), [0, 0])
    before = K.COUNTS["needle_count"]
    count = DC.detect_cfo_scan_rc(spectra)
    assert K.COUNTS["needle_count"] == before + 1
    assert torch.equal(count, DC.detect_cfo_scan_rc(spectra, plain=True))
    for s, c in enumerate(true):
        ci = int(count[s].flatten().argmax()) // C.BLKSZ
        assert ci - DC.CFO_RANGE == -c


def _pm(seed, s, n_blocks):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, (s, n_blocks, C.PM_BLOCK_SIZE),
                         generator=g, dtype=torch.int8)


@pytest.mark.parametrize("name,skip", [("p1", 0), ("p1", 2), ("pids", 0)])
def test_fec_gather(card, name, skip):
    """K6 at the path's shapes: 16 stations × 2 P1 frames (read in place
    from a [16, 34, 23040] pm past 2 lead blocks, as the chain slices it)
    and 16 × 32 PIDS blocks."""
    pm = _pm(10, 16, 32 + skip).to(card)
    if name == "p1":
        frames = pm[:, skip:skip + 32].view(16, 2, -1)
    else:
        frames = pm
    before = K.COUNTS["fec_gather"]
    got = DF.fec_gather(frames, name)
    assert K.COUNTS["fec_gather"] == before + 1
    assert torch.equal(got, DF.fec_gather_plain(frames, name))


@pytest.mark.parametrize("name", ["p1", "pids", "px4608", "px2304"])
@pytest.mark.parametrize("packed", [False, True])
def test_fec_epilogue(card, name, packed):
    """K8 on random K7 bits: 32 P1 frames with their pm (re-encode bit
    errors), 512 PIDS words, 256 PX frames."""
    tb = DF.channel_tables(name)
    b = {"p1": 32, "pids": 512}.get(name, 256)
    g = torch.Generator().manual_seed(11)
    bits = torch.randint(0, 2, (b * tb["n_seg"], tb["steps"]), generator=g,
                         dtype=torch.uint8).to(card)
    pm = _pm(12, 16, 32).to(card).view(16, 2, -1) if name == "p1" else None
    before = K.COUNTS["fec_epilogue"]
    got, errors = DF.fec_epilogue(bits, name, pm, packed)
    assert K.COUNTS["fec_epilogue"] == before + 1
    want, want_errors = DF.fec_epilogue_plain(bits, name, pm, packed)
    assert torch.equal(got, want)
    if pm is None:
        assert errors is None and want_errors is None
    else:
        assert torch.equal(errors, want_errors)


@pytest.mark.parametrize("fl,s,pairs", [(4608, 16, 16), (4608, 3, 18),
                                        (2304, 16, 16)])
def test_px_deinterleave(card, fl, s, pairs):
    """K11 at MP3's and MP2's path shapes (16 stations × 16 pairs) and past
    a cycle (18 pairs), from a random state and per-station phases."""
    g = torch.Generator().manual_seed(fl + pairs)
    _, n, calls = DF.IL.p3_iv_tables(fl)
    llr = torch.randint(-127, 128, (s, 2 * pairs, fl), generator=g,
                        dtype=torch.int8).to(card)
    internal = torch.randint(-127, 128, (s, n), generator=g,
                             dtype=torch.int8).to(card)
    phase = torch.randint(0, calls, (s,), generator=g,
                          dtype=torch.int32).to(card)
    before = K.COUNTS["px_deinterleave"]
    got = DF.px_deinterleave(llr, internal, phase)
    assert K.COUNTS["px_deinterleave"] == before + 1
    want = DF.px_deinterleave_plain(llr, internal, phase)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# AM: K12, K13, K15 and K7 at K=9
# ---------------------------------------------------------------------------

def _am_capture(rng, ma3, n_frames, cfo_hz, snr_db=35.0):
    """``n_frames`` frames of one AM station at ``snr_db``, frame-aligned
    (first symbol FFTCP_AM // 2 in), as rc chain input [am_buffer_len, 2]."""
    p3_len = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(rng.integers(0, 2, (8, C.P1_FRAME_LEN_AM))
                          .astype(np.uint8)) for _ in range(n_frames)],
        [EAM.encode_p3_am(rng.integers(0, 2, p3_len).astype(np.uint8), ma3)
         for _ in range(n_frames)], ma3)
    pids = np.stack([EAM.encode_pids_am(rng.integers(0, 2, 80).astype(
        np.uint8)) for _ in range(8 * n_frames)])
    ref = np.stack([EAM.am_ref_bits(b % 8, 2 if ma3 else 1)
                    for b in range(8 * n_frames)])
    sig = ch.impair(modulate_am(mats, pids, ref, ma3), cfo_hz=cfo_hz,
                    snr_db=snr_db, sample_rate=C.SAMPLE_RATE_CS16_AM,
                    rng=rng)
    buf = np.zeros((scar.am_buffer_len(n_frames), 2), np.float32)
    start = C.FFTCP_AM // 2
    buf[start:start + len(sig)] = np.stack([sig.real, sig.imag], -1)
    return buf


def _am_stations(card, ma3=False):
    """Three stations' one-frame AM chain input at 35 dB (CFOs 0, +7 and
    -9 Hz) and a fresh carry for them."""
    rng = np.random.default_rng(20 + ma3)
    x = torch.from_numpy(np.stack([_am_capture(rng, ma3, 1, f)
                                   for f in (0.0, 7.0, -9.0)])).to(card)
    return x, scar.am_chain_rc_init_carry(n_stations=3, device=card)


@pytest.mark.parametrize("case", ["fresh", "moved"])
def test_am_fold(card, case):
    """K12, both passes, on three stations: from a fresh carry, and with the
    state moved (offsets, phasors, samperr feedback -2..+3, CFOs -1..1,
    small angles) so every term of the ramp and the slice is exercised."""
    x, cy = _am_stations(card)
    args = [x, cy.offset, cy.phase, cy.samperr_fb, cy.prev_angle, cy.cfo]
    if case == "moved":
        ang = torch.tensor([0.3, 2.0, -1.2], device=card)
        args[1:] = [torch.tensor([0, 300, 8000], dtype=torch.int32,
                                 device=card),
                    torch.stack([torch.cos(ang), torch.sin(ang)], -1),
                    torch.tensor([3, -2, 0], dtype=torch.int32, device=card),
                    torch.tensor([0.004, -0.01, 0.02], device=card),
                    torch.tensor([1, 0, -1], dtype=torch.int32, device=card)]
    before = K.COUNTS["am_fold"]
    got1 = scar.am_fold(*args)
    want1 = scar.am_fold_plain(*args)
    _close(got1, want1, 1e-5)
    spectra1 = rc.dft(want1, shift=True)
    got2 = scar.am_fold(*args, spectra1)
    want2 = scar.am_fold_plain(*args, spectra1)
    assert K.COUNTS["am_fold"] == before + 2
    for a, b in zip(got2, want2):
        if b.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            _close(a, b, 1e-5)


@pytest.mark.parametrize("ma3", [False, True])
def test_sync_am_block(card, ma3):
    """K13 on the spectra of three stations' first block at 35 dB, the
    fold and DFT through the plain versions."""
    x, carry = _am_stations(card, ma3)
    spectra = scar.acquire_am_fine_rc(x, carry.offset, carry.phase,
                                      carry.samperr_fb, carry.prev_angle,
                                      carry.cfo, plain=True)[0].contiguous()
    before = K.COUNTS["sync_am_block"]
    got = scar.sync_am_block_rc(spectra, ma3)
    assert K.COUNTS["sync_am_block"] == before + 1
    want = scar.sync_am_block_rc_plain(spectra, ma3)
    for k in ("codes", "pids", "ref_bits", "samperr"):
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), (
            k, int((got[k] != want[k]).sum()))


@pytest.mark.parametrize("ma3", [False, True])
@pytest.mark.parametrize("n_frames", [2, 4])
def test_am_gather(card, ma3, n_frames):
    """K15 on random codes and a random handed-on delay line: 2 frames
    (every delayed bit from the line) and 4 (frame 3's from frame 0)."""
    g = torch.Generator().manual_seed(22 + 2 * n_frames + ma3)
    s, nb = 3, 8 * n_frames
    codes = torch.randint(0, 64, (s, nb, 4, 800), generator=g,
                          dtype=torch.uint8).to(card)
    pids = torch.randint(0, 16, (s, nb, 32, 2), generator=g,
                         dtype=torch.uint8).to(card)
    lines = torch.randint(0, 2, (s, 4, DA.DD), generator=g,
                          dtype=torch.uint8).to(card)
    before = K.COUNTS["am_gather"]
    got = DA.am_gather(codes, pids, lines, ma3)
    assert K.COUNTS["am_gather"] == before + 1
    for a, b in zip(got, DA.am_gather_plain(codes, pids, lines, ma3)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("length,gens", [
    (144, C.CONV_E2_E3_GEN), (1258, C.CONV_E1_GEN),
    (1320, C.CONV_E2_E3_GEN)])
@pytest.mark.parametrize("llr", ["am", "soft"])
def test_viterbi_k9(card, length, gens, llr):
    """K7 at K=9 at the AM chain's segment lengths (PIDS, P1, P3): the
    chain's LLRs (+-1 with punctured zeros and some flips) and integer
    soft LLRs with noise."""
    rng = np.random.default_rng(23 + length)
    b = 70
    bits = rng.integers(0, 2, (b, length)).astype(np.uint8)
    coded = CV.conv_encode(bits, 9, gens).reshape(b, length, 3) * 2.0 - 1.0
    if llr == "am":
        coded[rng.random(coded.shape) < 0.05] *= -1
        coded[rng.random(coded.shape) < 0.2] = 0.0
        ext = coded
    else:
        ext = np.clip(np.round(coded * 40 + rng.normal(0, 40, coded.shape)),
                      -127, 127)
    ext = torch.from_numpy(ext.astype(np.float32)).to(card)
    before = K.COUNTS["viterbi_k9"], K.COUNTS["viterbi_k7"]
    kb, km = CV.acs_traceback(ext, gens, 9)
    assert (K.COUNTS["viterbi_k9"], K.COUNTS["viterbi_k7"]) == (
        before[0] + 1, before[1])
    pb, pm = CV.acs_traceback_plain(ext, gens, 9)
    assert torch.equal(kb, pb)
    assert torch.equal(km, pm)


@pytest.mark.parametrize("name", ["am_p1", "am_p3_ma1", "am_p3_ma3",
                                  "am_pids"])
@pytest.mark.parametrize("packed", [False, True])
def test_fec_epilogue_am(card, name, packed):
    """K8 on random K=9 Viterbi bits of the AM channels: 32 P1 frames of 8
    subframes (the keystream restarting at each), 32 P3 frames, 256 PIDS
    words; no re-encode count."""
    tb = DF.channel_tables(name)
    b = 256 if name == "am_pids" else 32
    g = torch.Generator().manual_seed(24)
    bits = torch.randint(0, 2, (b * tb["n_seg"], tb["steps"]), generator=g,
                         dtype=torch.uint8).to(card)
    got, errors = DF.fec_epilogue(bits, name, packed=packed)
    want, _ = DF.fec_epilogue_plain(bits, name, packed=packed)
    assert errors is None and torch.equal(got, want)


# ---------------------------------------------------------------------------
# AM cold start (K14) and K1's AM cascade
# ---------------------------------------------------------------------------

def _probe_inputs(card):
    """Three stations' AM chain input at 35 dB (an MA1 carrier at +2 bins +
    31 Hz, MA3 at -1 bin + 17 Hz, MA1 at 0) and probe windows off the
    symbol grid, with the power DFT of each window's symbols."""
    rng = np.random.default_rng(25)
    bin_hz = C.SAMPLE_RATE_CS16_AM / C.FFT_AM
    x = torch.from_numpy(np.stack([
        _am_capture(rng, ma3, 1, f) for ma3, f in
        ((False, 2 * bin_hz + 31.0), (True, -bin_hz + 17.0),
         (False, 0.0))])).to(card)
    offset = torch.tensor([0, 1111, 30000], dtype=torch.int32, device=card)
    return x, offset, rc.dft(AA.tone_symbols(x, offset))


def test_am_tone(card):
    """K14's tone estimate: f and amp exact (its 8910-sample sums run in
    the plain version's order, the phases in the same float32 product
    chains, with the same cosf/sinf)."""
    x, offset, spectra = _probe_inputs(card)
    before = K.COUNTS["am_tone"]
    got = AA.am_tone(spectra, x, offset)
    assert K.COUNTS["am_tone"] == before + 1
    want = AA.am_tone_plain(spectra, x, offset)
    for a, b in zip(got, want):
        assert torch.equal(a, b), (a, b)


@pytest.mark.parametrize("case", ["fresh", "latched"])
def test_am_coarse(card, case):
    """K14's coarse timing on the plain version's tone: measured, samperr,
    prev_angle and v exact, from a fresh state and with a latch and
    nonzero prev_angles."""
    x, offset, spectra = _probe_inputs(card)
    f, amp = AA.am_tone_plain(spectra, x, offset)
    if case == "fresh":
        pa = torch.zeros(3, device=card)
        ov = torch.full((3,), -1, dtype=torch.int32, device=card)
    else:
        pa = torch.tensor([0.3, -1.2, 0.0], device=card)
        ov = torch.tensor([7, -1, 275], dtype=torch.int32, device=card)
    before = K.COUNTS["am_coarse"]
    got = AA.am_coarse(x, offset, f, amp, pa, ov)
    assert K.COUNTS["am_coarse"] == before + 1
    for a, b in zip(got, AA.am_coarse_plain(x, offset, f, amp, pa, ov)):
        assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


def test_am_cfo_step(card):
    """K14's integer-CFO step on pass 1's spectra: the 107 magnitude sums
    and the step exact."""
    x, offset, _ = _probe_inputs(card)
    z = torch.zeros(3, dtype=torch.int32, device=card)
    unit = torch.tensor([[1.0, 0.0]], device=card).repeat(3, 1)
    spectra1 = rc.dft(scar.am_fold_plain(x, offset, unit, z, torch.zeros(
        3, device=card), z), shift=True)
    before = K.COUNTS["am_cfo_step"]
    step, mags = AA.am_cfo_step(spectra1)
    assert K.COUNTS["am_cfo_step"] == before + 1
    pstep, pmags = AA.am_cfo_step_plain(spectra1)
    assert torch.equal(step, pstep) and torch.equal(mags, pmags)
    assert step.tolist()[:2] == [2, -1]


def test_am_coldstart_block(card):
    """One probe block through the kernels and through the plain versions:
    every integer, the phase, prev_angle and the magnitude sums equal; the
    kernels launched once each (K12 twice)."""
    x, offset, _ = _probe_inputs(card)
    ang = torch.tensor([0.1, 2.0, -0.7], device=card)
    args = (x, offset, torch.stack([torch.cos(ang), torch.sin(ang)], -1),
            torch.tensor([0.0, 0.2, -0.1], device=card),
            torch.tensor([2, -1, 0], dtype=torch.int32, device=card),
            torch.tensor([-1, 3, -1], dtype=torch.int32, device=card))
    K.reset_counts()
    got = scar.am_coldstart_block_rc(*args)
    assert {n: c for n, c in K.COUNTS.items() if c} == {
        "am_tone": 1, "am_coarse": 1, "am_fold": 2, "am_cfo_step": 1,
        "sync_am_block": 1}
    want = scar.am_coldstart_block_rc(*args, plain=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_am_decimate_cu8(card):
    """K1's AM cascade on a random cu8 wire of three stations, its output
    length not a multiple of the kernel's tile: bit-identical to the plain
    version; a wire of the wrong length or dtype is refused."""
    g = torch.Generator().manual_seed(26)
    n = 3 * 128 + 77
    wire = torch.randint(0, 256, (3, FE.rc_overlap(5) + 32 * n, 2),
                         generator=g, dtype=torch.uint8).to(card)
    before = K.COUNTS["am_decimate_cu8"]
    got = FE.ingest_am_cu8(wire)
    assert K.COUNTS["am_decimate_cu8"] == before + 1
    assert got.shape == (3, n, 2)
    assert torch.equal(got, FE.ingest_am_cu8_plain(wire))
    with pytest.raises(ValueError):
        FE.ingest_am_cu8(wire[:, 1:].contiguous())
    with pytest.raises(ValueError):
        FE.ingest_am_cu8(wire.float())
