"""Each hand kernel of the port against its plain PyTorch version, on the
card.  Needs a CUDA card and ``nvcc`` (the kernels build at first use);
without a card every test here skips.  On the card, run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest``: tests/conftest.py imports JAX, which these tests do not
need.)

Tolerances:

- K1 (halfband), K6 (FEC gather), K7 (Viterbi), K8 (FEC epilogue), K9
  (coarse timing), the needle count of K10 and K11 (PX deinterleave)
  exact: no FMA contraction and the same operation order, integer path
  metrics, integer counts, and gathers of int8 values;
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
from nrsc5_tpu_torch.ops import acquire_rc as AQ
from nrsc5_tpu_torch.ops import convolutional as CV
from nrsc5_tpu_torch.ops import costas as CO
from nrsc5_tpu_torch.ops import decode_fm as DF
from nrsc5_tpu_torch.ops import detect_cfo as DC
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.pipeline.scan_chain import px_frame_lens
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
from nrsc5_tpu_torch.tx.modulator import modulate_fm

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
