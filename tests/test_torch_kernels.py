"""Each hand kernel of the port against its plain PyTorch version, on the
card.  Needs a CUDA card and ``nvcc`` (the kernels build at first use);
without a card every test here skips.  On the card, run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest``: tests/conftest.py imports JAX, which these tests do not
need.)

Tolerances:

- K1 (halfband, and its AM cascade), K6 (FEC gather, int8 out), K7
  (Viterbi, K=7 and K=9; int8 input gives the bits and margins of the
  same values in float32), K8 (FEC epilogue), K9 (coarse timing: samperr
  and max_v's bits), K10 (the CFO scan's needle count, the Costas PLL
  fused into it), K11 (PX deinterleave, int8 out) and K15 (AM gather,
  int8 out) exact: no FMA contraction and the same operation order,
  integer path metrics, integer counts, and gathers of int8 values or
  bits;
- K14 (the AM cold start's tone estimate, coarse timing and CFO step)
  exact, floats too: every sum runs in the plain version's order (the
  8910-sample sums strided over 256 lanes, then a fixed pairwise tree),
  the phases are the same float32 product chains (the tone's grid and
  derotation phasors from tables the plain version's own expressions
  made), and kernel and PyTorch call the same cosf, sinf (the tone's tail
  through sincosf, which gives their values), atan2f and sqrtf;
- K12 (AM fold): it writes its fold rounded to bfloat16, the DFT's
  operand, so each entry must be a bfloat16 value that is the rounding of
  some value within 1e-5 of the largest value (at least 1) of the plain
  version's unrounded fold (the tolerance the float32 fold was held to,
  carried through the rounding); phase_out and prev_angle_out within that
  1e-5, keep exact; K13 (AM sync block) exact on every code, PIDS code, reference
  bit and samperr: its plain version sums in K13's order, divides as K13
  does and calls the same float32 functions, so an equalized value could
  move across a decision threshold only by a last-bit difference of sin,
  cos or atan2 between the kernel's build and PyTorch's;
- K2's bf16 fold within one bf16 ulp of its plain version (the float32
  fold rounded by ``.to(torch.bfloat16)``), the share that differs
  printed: float32 sin and cos may differ in the last bit between the
  kernel's build and PyTorch's, and rounding can carry that one bf16 step;
- the DFT kernel (``dft_bf16``) within 1e-5 of each row's largest
  magnitude: it forms the plain version's products (bf16 x bf16, exact in
  float32) and sums them in another order; two launches, and a launch
  inside a CUDA graph, give the same bits (a fixed K order, no atomics);
- K2's phase_out and the float outputs of K4 (sync block)
  within 1e-5 of the largest value (at least 1): float32 sin, cos and
  atan2 may differ in the last bit between the kernel's build and
  PyTorch's (K4's plain version sums in K4's order and divides by numbers
  as K4 does, so at chip_smoke.py's inputs the two agree exactly);
- K16a-d (batched HDC audio: window and QMF analysis, HF generator, HF
  adjuster, QMF synthesis) exact, floats and int16 PCM: the plain versions
  sum every short axis in the kernels' order and round every product
  apart from its sum, as the kernels do with -fmad=false;
- K4's ref_ok, ref_bc, ref_psmi and samperr exact; its int8 soft bits (pm,
  px1, px2) within ±1 on at most 0.1 % of values (a reduction's last bit can move a
  product across a .5 rounding edge).  These hold K4 at states the chain
  produces.  Off that path (timing no lock gives, a random Costas state)
  the MER sums error_lb/ub are ill-conditioned in float32, so there they
  are held to a float64 evaluation instead: the kernel's error within 4×
  the larger of the plain version's own float32 error, the float64 sums'
  spread under a one-ulp change of the inputs, and one ulp.
"""

import functools
import json
import math

import numpy as np
import pytest
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.audio import sbr as SBR
from nrsc5_tpu_torch.audio import stage as AST
from nrsc5_tpu_torch.audio.batch import BatchedAudioDecoder, device_inputs
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
from nrsc5_tpu_torch.tx.hdc_encoder import HDCEncoder
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


def _bf16_steps(a, b):
    """How many bf16 values lie between each pair of entries of two bf16
    tensors (+0 and -0 one value): 1 is one bf16 ulp."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("cfo", [-7, 0, 5])
def test_demod_fold(card, cfo):
    """K2's bf16 fold against its plain version (the float32 fold rounded
    by ``.to(torch.bfloat16)``): within one bf16 ulp everywhere, the share
    of entries that differ printed (shown with ``-rP``); phase_out within
    1e-5, keep exact."""
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
    before = K.COUNTS["demod_fold"]
    folded, ph, keep = AQ.demod_fold_bf16(*args)
    assert K.COUNTS["demod_fold"] == before + 1
    p_folded, p_ph, p_keep = AQ.demod_fold_bf16_plain(*args)
    assert folded.dtype == torch.bfloat16 and folded.shape == p_folded.shape
    steps = _bf16_steps(folded, p_folded)
    print(json.dumps({"demod_fold_cfo": cfo, "bf16_differ_share":
                      (steps > 0).float().mean().item()}))
    assert steps.max().item() <= 1
    _close(ph, p_ph, 1e-5)
    assert torch.equal(keep, p_keep)


@pytest.mark.parametrize("s", [1, 3, 16])
@pytest.mark.parametrize("sign", [-1, 1])
def test_demod_fold_stations(card, s, sign):
    """K2's fold at 1, 3 and 16 stations, CFOs of one sign, offsets
    negative (counted from the buffer's end) and positive, odd and even (so
    both the 16-byte and the 8-byte loads run), samperr moved off its
    trivial value: within one bf16 ulp of the plain version, phase_out
    within 1e-5, keep exact, one launch."""
    rng = np.random.default_rng(100 + 10 * s + sign)
    n = AQ.WINDOW_FM + 7001
    samples = torch.from_numpy(rng.normal(0, 1, (s, n, 2)).astype(
        np.float32)).to(card)
    offset = torch.from_numpy(rng.integers(-7000, 7000, s).astype(
        np.int32)).to(card)
    offset[0] = -(AQ.WINDOW_FM + 3)
    ang = rng.uniform(0, 2 * np.pi, s)
    phase = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1)
                             .astype(np.float32)).to(card)
    samperr = torch.from_numpy(rng.integers(1000, 1160, s).astype(
        np.int32)).to(card)
    angle = torch.from_numpy(rng.uniform(-0.3, 0.3, s).astype(
        np.float32)).to(card)
    cfo = torch.from_numpy((sign * rng.integers(1, 13, s)).astype(
        np.int32)).to(card)
    args = (samples, offset, phase, samperr, angle, cfo)
    before = K.COUNTS["demod_fold"]
    folded, ph, keep = AQ.demod_fold_bf16(*args)
    assert K.COUNTS["demod_fold"] == before + 1
    p_folded, p_ph, p_keep = AQ.demod_fold_bf16_plain(*args)
    assert _bf16_steps(folded, p_folded).max().item() <= 1
    _close(ph, p_ph, 1e-5)
    assert torch.equal(keep, p_keep)


def _dft_operand(card, rows, seed):
    """``rows`` rows of bf16 rc symbols, [rows / 32, 32, 2048, 2], from a
    numpy seed: Gaussian, at the fold's scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.05, (rows // C.BLKSZ, C.BLKSZ, C.FFT_FM, 2))
    return torch.from_numpy(x.astype(np.float32)).to(card).to(torch.bfloat16)


def _rows_close(got, want, tol=1e-5):
    """Every entry within ``tol`` of its row's largest magnitude (a row:
    one symbol's 4096 interleaved outputs)."""
    g, w = got.view(-1, 2 * C.FFT_FM), want.view(-1, 2 * C.FFT_FM)
    scale = w.abs().amax(dim=1, keepdim=True)
    assert ((g - w).abs() <= tol * scale).all()


@pytest.mark.parametrize("rows", [512, 32])
def test_dft_bf16(card, rows):
    """The DFT kernel against its plain version (the float32 matmul on
    the same bf16 operands) at the dispatch's 512 rows and at one
    station's 32 (a ragged tile); two launches give the same bits."""
    a = _dft_operand(card, rows, 80 + rows)
    before = K.COUNTS["dft_bf16"]
    got = rc.dft_bf16(a)
    assert K.COUNTS["dft_bf16"] == before + 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _rows_close(got, rc.dft_bf16_plain(a))
    assert torch.equal(got, rc.dft_bf16(a))
    out = torch.full_like(got, float("nan"))
    assert rc.dft_bf16(a, out=out) is out and torch.equal(out, got)


def test_dft_bf16_fold(card):
    """The DFT kernel on what the chain gives it: K2's bf16 fold of three
    stations' blocks, against the plain version within the stated
    tolerance."""
    rng = np.random.default_rng(81)
    caps = [_capture(rng, 1, 0, f) for f in (0.0, 20.0, -35.0)]
    x = torch.from_numpy(np.stack(caps)).to(card)
    s = x.shape[0]
    folded = AQ.demod_fold_bf16(
        x, torch.zeros(s, dtype=torch.int32, device=card),
        torch.tensor([[1.0, 0.0]], device=card).repeat(s, 1),
        torch.full((s,), C.FFTCP_FM // 2, dtype=torch.int32, device=card),
        torch.zeros(s, device=card),
        torch.zeros(s, dtype=torch.int32, device=card))[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    _rows_close(rc.dft_bf16(folded), rc.dft_bf16_plain(folded))


def test_dft_bf16_graph(card):
    """The DFT kernel captured in a CUDA graph gives the eager bits."""
    a = _dft_operand(card, 512, 82)
    eager = rc.dft_bf16(a)
    out = torch.empty_like(eager)
    rc.dft_bf16(a, out=out)  # warm-up: the table is built outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rc.dft_bf16(a, out=out)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_dft_bf16_refuses(card):
    """The wrapper takes bf16 [..., N, 2] with 2N a multiple of 128."""
    a = _dft_operand(card, 32, 83)
    with pytest.raises(ValueError):
        rc.dft_bf16(a.float())
    with pytest.raises(ValueError):
        rc.dft_bf16(a[..., :100, :].contiguous())
    with pytest.raises(ValueError):
        rc.dft_bf16(a, out=torch.empty(a.shape, device=card,
                                       dtype=torch.bfloat16))


@pytest.mark.parametrize("stations", [1, 17])
def test_costas_track(card, stations):
    """The Costas PLL of the CFO scan, fused into K10 (csrc/cfo_scan.cu:
    the angles, the recursion and the derotations' signs in shared
    memory): K10 on random spectra whose reference bins sit near the real
    axis, as locked reference subcarriers do, at 1 and 17 stations (a
    partial last wave of residue CTAs), one launch; its count equal to the
    plain scan's, the PLL's plain version then the needle count.  The
    PLL's wrapper raises on a card's tensor: it runs only inside K4 and
    K10 there."""
    g = torch.Generator().manual_seed(3)
    spectra = (torch.randn(stations, C.BLKSZ, C.FFT_FM, 2, generator=g)
               * torch.tensor([1.0, 0.2])).to(card)
    before = dict(K.COUNTS)
    got = DC.detect_cfo_scan_rc(spectra)
    assert {k: c - before[k] for k, c in K.COUNTS.items()
            if c != before[k]} == {"cfo_scan": 1}
    want = DC.detect_cfo_scan_rc(spectra, plain=True)
    assert got.dtype == torch.int32 and got.shape == (stations, 76, 32)
    assert torch.equal(got, want)
    assert int(got.max()) > 0
    z = torch.zeros(10, device=card)
    with pytest.raises(ValueError):
        CO.costas_track_rc(torch.zeros(C.BLKSZ, 10, 2, device=card), z, z)


def _viterbi_ext(kind, k, gens, segs, length, seed):
    """[segs, length, 3] integer LLRs on the card: coded bits with noise
    and a third of one column punctured (soft), coded +-1 with 20 % zeros
    and 5 % flips (am), every state tied (zeros), all +-127 (sat)."""
    rng = np.random.default_rng(seed)
    shape = (segs, length, 3)
    if kind == "zeros":
        x = np.zeros(shape)
    elif kind == "sat":
        x = rng.choice([-127.0, 127.0], shape)
    else:
        bits = rng.integers(0, 2, (segs, length)).astype(np.uint8)
        x = CV.conv_encode(bits, k, gens).reshape(shape) * 2.0 - 1.0
        if kind == "am":
            x[rng.random(shape) < 0.05] *= -1
            x[rng.random(shape) < 0.2] = 0.0
        else:
            x = np.clip(np.round(x * 40 + rng.normal(0, 40, shape)), -127,
                        127)
            x[:, :, 2][rng.random((segs, length)) < 0.3] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to("cuda")


def _viterbi_check(ext, gens, k):
    """K7 once (one launch of its own kernel, none of the other's), held
    to the plain version: bits and margins exact."""
    other = f"viterbi_k{16 - k}"
    before = K.COUNTS[f"viterbi_k{k}"], K.COUNTS[other]
    kb, km = CV.acs_traceback(ext, gens, k)
    assert (K.COUNTS[f"viterbi_k{k}"], K.COUNTS[other]) == (
        before[0] + 1, before[1])
    pb, pm = CV.acs_traceback_plain(ext, gens, k)
    assert torch.equal(kb, pb), int((kb != pb).sum())
    assert torch.equal(km, pm), int((km != pm).sum())


@pytest.mark.parametrize("segs,length", [
    (4064, 1343), (512, 144), (256, 4672), (1, 1343), (33, 1343),
    (4065, 1343), (5, 7), (3, 191)])
@pytest.mark.parametrize("kind", ["soft", "zeros", "sat"])
def test_viterbi_k7(card, segs, length, kind):
    """K7 at K=7 at the chain shapes (P1 segments, PIDS blocks, PX1
    frames), ragged segment counts (two segments a warp) and short
    segments, on noisy coded LLRs, all-tie input and saturated input."""
    ext = _viterbi_ext(kind, 7, C.CONV_K7_GEN, segs, length, segs + length)
    _viterbi_check(ext, C.CONV_K7_GEN, 7)


def test_viterbi_k7_chain_inputs(card):
    """K7 at K=7 on the chains' own inputs: K6's P1 segments and PIDS
    blocks and K11's PX1 frames, from random int8 soft bits."""
    pm = _pm(9, 16, 32).to(card)
    _viterbi_check(DF.fec_gather(pm.view(16, 2, -1), "p1"), C.CONV_K7_GEN,
                   7)
    _viterbi_check(DF.fec_gather(pm, "pids"), C.CONV_K7_GEN, 7)
    g = torch.Generator().manual_seed(97)
    fl = C.P3_FRAME_LEN_MP3_MP11
    _, n, calls = DF.IL.p3_iv_tables(fl)
    llr = torch.randint(-127, 128, (16, 32, fl), generator=g,
                        dtype=torch.int8).to(card)
    internal = torch.randint(-127, 128, (16, n), generator=g,
                             dtype=torch.int8).to(card)
    phase = torch.randint(0, calls, (16,), generator=g,
                          dtype=torch.int32).to(card)
    ext = DF.px_deinterleave(llr, internal, phase)[0]
    assert tuple(ext.shape) == (256, 4672, 3)
    _viterbi_check(ext, C.CONV_K7_GEN, 7)


def test_viterbi_refuses(card):
    """K7's wrapper raises on what its kernels do not take: another
    constraint length or generator set, another dtype or shape, a strided
    tensor, no segment, too many steps; and counts no launch."""
    ext = _viterbi_ext("soft", 7, C.CONV_K7_GEN, 4, 40, 1)
    counts = dict(K.COUNTS)
    with pytest.raises(ValueError, match="constraint length"):
        CV.acs_traceback(ext, C.CONV_K7_GEN, 8)
    with pytest.raises(ValueError, match="generators"):
        CV.acs_traceback(ext, C.CONV_E1_GEN, 7)
    with pytest.raises(ValueError, match="generators"):
        CV.acs_traceback(ext, (0o133, 0o171, 0o164), 7)
    with pytest.raises(ValueError, match="generators"):
        CV.acs_traceback(ext, C.CONV_K7_GEN, 9)
    with pytest.raises(ValueError):
        CV.acs_traceback(ext.double(), C.CONV_K7_GEN)
    with pytest.raises(ValueError):
        CV.acs_traceback(ext.to(torch.int16), C.CONV_E1_GEN, 9)
    with pytest.raises(ValueError):
        CV.acs_traceback(ext[..., :2].contiguous(), C.CONV_K7_GEN)
    with pytest.raises(ValueError):
        CV.acs_traceback(ext[:, ::2], C.CONV_K7_GEN)
    with pytest.raises(ValueError):
        CV.acs_traceback(ext[:0], C.CONV_K7_GEN)
    with pytest.raises(ValueError):
        CV.acs_traceback(ext.new_zeros(1, CV.MAX_STEPS + 1, 3),
                         C.CONV_K7_GEN)
    assert K.COUNTS == counts


@pytest.mark.parametrize("n_seg,n_steps", [(3, 10), (4064, 1343),
                                            (255, 4672), (1, 1)])
def test_viterbi_scratch_bytes(card, n_seg, n_steps):
    """The scratch size K7's libraries give the wrapper: a uint32 ballot
    word a state group a step, two segments a warp at K=7 (4 words a
    step) and one at K=9 (8 words); -1 for a generator set a kernel does
    not hold or an empty shape."""
    want = {7: -(-n_seg // 2) * n_steps * 4 * 4, 9: n_seg * n_steps * 8 * 4}
    for k, sets, other in ((7, (C.CONV_K7_GEN,), C.CONV_E1_GEN),
                           (9, (C.CONV_E1_GEN, C.CONV_E2_E3_GEN),
                            C.CONV_K7_GEN)):
        name = f"viterbi_k{k}"
        query = functools.partial(K.query, name, f"{name}_scratch_bytes")
        for gens in sets:
            assert query(n_seg, n_steps, *gens) == want[k]
            assert query(0, n_steps, *gens) == -1
        assert query(n_seg, n_steps, *other) == -1


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


@pytest.mark.parametrize("s", [1, 3, 16])
def test_coarse_timing_stations(card, s):
    """K9 on 1, 3 and 16 stations (impaired windows, a periodic window
    whose largest |v|^2 ties across the cluster's slices, an all-zero
    window, noise; at 3 stations rows of odd length), one call (its two
    kernels): samperr
    and max_v bit-identical to the plain version."""
    rng = np.random.default_rng(60 + s)
    base = rng.normal(0, 1, (270, 2))
    # an odd length at 3 stations: stations past the first start 8 bytes
    # off a 16-byte boundary, where the kernel copies a sample at a time
    n = AQ.WINDOW_FM + (41 if s == 3 else 40)
    wins = [np.tile(base, (AQ.WINDOW_FM // 270 + 1, 1))[:n],
            np.zeros((n, 2)),
            _capture(rng, 1, 1357, 5 * BIN_HZ + 41.0)[:n]]
    while len(wins) < s:
        wins.append(wins[2] + rng.normal(0, 0.01, wins[2].shape))
    x = torch.from_numpy(np.stack(wins[:s]).astype(np.float32)).to(card)
    before = K.COUNTS["coarse_timing"]
    ks, kv = AQ.coarse_timing_rc(x)
    assert K.COUNTS["coarse_timing"] == before + 2  # products, window
    ps, pv = AQ.coarse_timing_rc_plain(x)
    assert torch.equal(ks, ps)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def test_needle_count(card):
    """The CFO scan on the probe's spectra of stations with a negative and
    a positive integer CFO: one K10 launch (``cfo_scan``: the PLL and the
    needle count in one kernel) and nothing else, the count exact against
    the plain scan, and its peak at the true CFO (negated by the FM
    ingest's conjugation).  The standalone needle count raises on a card's
    tensor."""
    rng = np.random.default_rng(7)
    true = (-7, 5)
    caps = [_capture(rng, 1, 0, c * BIN_HZ + 20.0) for c in true]
    x = torch.from_numpy(np.stack(caps)).to(card)
    samperr, max_v = AQ.coarse_timing_rc(x)
    _, spectra = _spectra(card, caps, samperr.tolist(),
                          rc.angle(max_v).tolist(), [0, 0])
    before = dict(K.COUNTS)
    count = DC.detect_cfo_scan_rc(spectra)
    assert {k: c - before[k] for k, c in K.COUNTS.items()
            if c != before[k]} == {"cfo_scan": 1}
    assert torch.equal(count, DC.detect_cfo_scan_rc(spectra, plain=True))
    for s, c in enumerate(true):
        ci = int(count[s].flatten().argmax()) // C.BLKSZ
        assert ci - DC.CFO_RANGE == -c
    with pytest.raises(ValueError):
        DC.needle_count(torch.zeros(C.BLKSZ, 2, DC.N_TRACKS, 2, device=card))


def _pm(seed, s, n_blocks):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, (s, n_blocks, C.PM_BLOCK_SIZE),
                         generator=g, dtype=torch.int8)


@pytest.mark.parametrize("name,skip", [("p1", 0), ("p1", 2), ("pids", 0)])
def test_fec_gather(card, name, skip):
    """K6 at the path's shapes: 16 stations × 2 P1 frames (read in place
    from a [16, 34, 23040] pm past 2 lead blocks, as the chain slices it)
    and 16 × 32 PIDS blocks; int8 out."""
    pm = _pm(10, 16, 32 + skip).to(card)
    if name == "p1":
        frames = pm[:, skip:skip + 32].view(16, 2, -1)
    else:
        frames = pm
    before = K.COUNTS["fec_gather"]
    got = DF.fec_gather(frames, name)
    # P1: the deinterleave, then the segments; PIDS: one kernel
    assert K.COUNTS["fec_gather"] == before + (2 if name == "p1" else 1)
    assert torch.equal(got, DF.fec_gather_plain(frames, name))


@pytest.mark.parametrize("stations,frames", [(1, 1), (7, 1), (16, 2),
                                             (11, 3)])
def test_fec_gather_p1_ragged(card, stations, frames):
    """K6 on P1 at 1, 7, 32 and 33 frames, pm passed as the chain's strided
    [G, F, 368640] view of a [G, 2 + 16 F, 23040] pm past 2 lead blocks:
    int8, exact, one call (its two kernels)."""
    pm = _pm(13 + frames, stations, 2 + 16 * frames).to(card)
    src = pm[:, 2:].reshape(stations, frames, -1)
    before = K.COUNTS["fec_gather"]
    got = DF.fec_gather(src, "p1")
    assert K.COUNTS["fec_gather"] == before + 2
    assert got.dtype == torch.int8
    assert torch.equal(got, DF.fec_gather_plain(src, "p1"))


@pytest.mark.parametrize("name", ["p1", "pids"])
def test_fec_gather_unaligned(card, name):
    """K6 on pm whose storage starts one byte past a 16-byte boundary (the
    kernels' byte-load paths): int8, exact, one call."""
    flat = _pm(21, 1, 32 * 3 + 1).reshape(-1).to(card)
    pm = flat[1:1 + 3 * 32 * C.PM_BLOCK_SIZE].view(3, 32, C.PM_BLOCK_SIZE)
    assert pm.data_ptr() % 16 == 1
    src = pm.view(3, 2, -1) if name == "p1" else pm
    before = K.COUNTS["fec_gather"]
    got = DF.fec_gather(src, name)
    assert K.COUNTS["fec_gather"] == before + (2 if name == "p1" else 1)
    assert torch.equal(got, DF.fec_gather_plain(src, name))


@pytest.mark.parametrize("stations,blocks", [(1, 1), (3, 7), (16, 32)])
def test_fec_gather_pids_ragged(card, stations, blocks):
    """K6 on PIDS at 1, 21 and 512 blocks from a strided [S, blocks,
    23040] view: int8, exact, one launch."""
    pm = _pm(17 + blocks, stations, blocks + 2).to(card)[:, 1:blocks + 1]
    before = K.COUNTS["fec_gather"]
    got = DF.fec_gather(pm, "pids")
    assert K.COUNTS["fec_gather"] == before + 1
    assert got.dtype == torch.int8
    assert torch.equal(got, DF.fec_gather_plain(pm, "pids"))


@pytest.mark.parametrize("name", ["p1", "pids"])
def test_viterbi_k7_int8(card, name):
    """K7 on K6's int8 output at the P1 and PIDS shapes of a dispatch (32
    frames, 512 blocks): the bits and margins of the same values in
    float32, and of the plain version; one launch each."""
    pm = _pm(19, 16, 32).to(card)
    ext = DF.fec_gather(pm.view(16, 2, -1) if name == "p1" else pm, name)
    assert ext.dtype == torch.int8
    _viterbi_check(ext, C.CONV_K7_GEN, 7)
    kb, km = CV.acs_traceback(ext, C.CONV_K7_GEN)
    fb, fm = CV.acs_traceback(ext.float(), C.CONV_K7_GEN)
    assert torch.equal(kb, fb) and torch.equal(km, fm)


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


@pytest.mark.parametrize("stations,frames", [(1, 1), (7, 1), (16, 2),
                                             (11, 3)])
@pytest.mark.parametrize("packed", [False, True])
def test_fec_epilogue_p1_ragged(card, stations, frames, packed):
    """K8 on P1 at 1, 7, 32 and 33 frames, pm passed as the chain's strided
    [G, F, 368640] view of a [G, 2 + 16 F, 23040] pm past 2 lead blocks:
    outputs and re-encode counts exact, one launch; with every hard
    decision flipped, 365,440 less each count."""
    b = stations * frames
    tb = DF.channel_tables("p1")
    g = torch.Generator().manual_seed(b)
    bits = torch.randint(0, 2, (b * tb["n_seg"], tb["steps"]), generator=g,
                         dtype=torch.uint8).to(card)
    pm_blocks = _pm(13 + b, stations, 2 + C.P1_FM_BLOCKS * frames).to(card)
    pm = pm_blocks[:, 2:].view(stations, frames, -1)
    assert not pm.is_contiguous() or stations == 1
    before = K.COUNTS["fec_epilogue"]
    got, errors = DF.fec_epilogue(bits, "p1", pm, packed)
    assert K.COUNTS["fec_epilogue"] == before + 1
    want, want_errors = DF.fec_epilogue_plain(bits, "p1", pm, packed)
    assert torch.equal(got, want)
    assert torch.equal(errors, want_errors)
    # every hard decision flipped: each site's error flips, so the count
    # becomes 365,440 less the count (a strided view again)
    neg = torch.where(pm_blocks == 0, 1, -pm_blocks).to(torch.int8)
    _, flipped = DF.fec_epilogue(bits, "p1",
                                 neg[:, 2:].view(stations, frames, -1),
                                 packed)
    assert torch.equal(flipped, C.P1_FRAME_LEN_ENCODED_FM - want_errors)


@pytest.mark.parametrize("fl,s,pairs", [(4608, 16, 16), (4608, 3, 18),
                                        (2304, 16, 16), (4608, 1, 16),
                                        (4608, 17, 16), (2304, 3, 18),
                                        (2304, 17, 3)])
def test_px_deinterleave(card, fl, s, pairs):
    """K11 at MP3's and MP2's path shapes (16 stations × 16 pairs), at 1, 3
    and 17 stations, and past a cycle (18 pairs) and short of one, from a
    random state and per-station phases: int8 exact, one launch."""
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
    assert got[0].dtype == torch.int8
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


def _bf16_fold_gate(got, unrounded, tol):
    """K12's fold against its plain version's unrounded fold: each entry a
    bfloat16 value, the rounding of some value within ``tol`` of the
    unrounded one (the kernel's float32 fold may differ from the plain
    version's by float rounding, and rounding can carry that across a
    bf16 midpoint).  Returns the count of entries that are not the
    rounding of the unrounded value itself."""
    lo = rc.round_bf16(unrounded - tol)
    hi = rc.round_bf16(unrounded + tol)
    assert torch.equal(got, rc.round_bf16(got))
    assert bool(((got >= lo) & (got <= hi)).all())
    return int((got != rc.round_bf16(unrounded)).sum())


def _check_am_fold(args):
    """K12, both passes (pass 2 on pass 1's spectra through the plain
    version): the fold under the bf16 gate within 1e-5 of the largest value
    (at least 1), phase_out and prev_angle_out within 1e-5, keep exact;
    two launches."""
    before = K.COUNTS["am_fold"]
    got1 = scar.am_fold(*args)
    want1 = scar.am_fold_plain(*args, unrounded=True)
    tol = 1e-5 * max(want1.abs().max().item(), 1.0)
    _bf16_fold_gate(got1, want1, tol)
    spectra1 = rc.dft(want1, shift=True)
    got2 = scar.am_fold(*args, spectra1)
    want2 = scar.am_fold_plain(*args, spectra1, unrounded=True)
    assert K.COUNTS["am_fold"] == before + 2
    _bf16_fold_gate(got2[0], want2[0],
                    1e-5 * max(want2[0].abs().max().item(), 1.0))
    for a, b in zip(got2[1:], want2[1:]):
        if b.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            _close(a, b, 1e-5)


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
    _check_am_fold(args)


@pytest.mark.parametrize("s", [1, 3, 17])
def test_am_fold_stations(card, s):
    """K12 at 1, 3 and 17 stations of noise with random carries (a CTA per
    station and two symbols): the bf16 gate, both passes."""
    g = torch.Generator().manual_seed(120 + s)
    n = scar.WINDOW_AM + 500
    x = (0.05 * torch.randn(s, n, 2, generator=g)).to(card)
    ang = 2 * math.pi * torch.rand(s, generator=g)
    args = [x, torch.randint(-600, 600, (s,), generator=g,
                             dtype=torch.int32).to(card),
            torch.stack([torch.cos(ang), torch.sin(ang)], -1).to(card),
            torch.randint(-4, 5, (s,), generator=g,
                          dtype=torch.int32).to(card),
            (0.02 * torch.randn(s, generator=g)).to(card),
            torch.randint(-2, 3, (s,), generator=g,
                          dtype=torch.int32).to(card)]
    _check_am_fold(args)


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
    _same_sync(got, want)


def _same_sync(got, want):
    for k in ("codes", "pids", "ref_bits", "samperr"):
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), (
            k, int((got[k] != want[k]).sum()))


@pytest.mark.parametrize("ma3", [False, True])
@pytest.mark.parametrize("s", [1, 16, 17])
def test_sync_am_block_stations(card, s, ma3):
    """K13 at 1, 16 and 17 stations of random spectra (four CTAs a
    station, each loading only its plan's bins): every output exact, one
    launch."""
    g = torch.Generator().manual_seed(60 + s + ma3)
    spectra = torch.randn(s, C.BLKSZ, C.FFT_AM, 2, generator=g).to(card)
    before = K.COUNTS["sync_am_block"]
    got = scar.sync_am_block_rc(spectra, ma3)
    assert K.COUNTS["sync_am_block"] == before + 1
    _same_sync(got, scar.sync_am_block_rc_plain(spectra, ma3))


@pytest.mark.parametrize("ma3", [False, True])
def test_sync_am_block_zero_columns(card, ma3):
    """K13 where a column of every partition, both PIDS columns and (MA1)
    their mirrors are all zero: the training sums vanish, the divisions
    give inf and NaN, and the kernel's codes, PIDS codes and samperr are
    the plain version's."""
    g = torch.Generator().manual_seed(70 + ma3)
    spectra = torch.randn(3, C.BLKSZ, C.FFT_AM, 2, generator=g)
    parts, pids = scar.partitions(ma3)
    zero = [first + step * 7 for first, step, _, _ in parts] + list(pids)
    c = C.CENTER_AM
    for b in zero:
        spectra[1, :, b] = 0.0
        if not ma3 and c < b <= c + C.PIDS_OUTER_INDEX_AM:
            spectra[1, :, 2 * c - b] = 0.0  # its mirror
    spectra = spectra.to(card)
    got = scar.sync_am_block_rc(spectra, ma3)
    want = scar.sync_am_block_rc_plain(spectra, ma3)
    _same_sync(got, want)


def _am_gather_inputs(card, seed, s, n_frames):
    """Random codes, PIDS codes and handed-on delay lines on the card."""
    g = torch.Generator().manual_seed(seed)
    nb = 8 * n_frames
    codes = torch.randint(0, 64, (s, nb, 4, 800), generator=g,
                          dtype=torch.uint8).to(card)
    pids = torch.randint(0, 16, (s, nb, 32, 2), generator=g,
                         dtype=torch.uint8).to(card)
    lines = DA.AMDecodeState(*(torch.randint(
        0, 2, (s, DA.DD), generator=g, dtype=torch.uint8).to(card)
        for _ in DA.DELAYED))
    return codes, pids, lines


@pytest.mark.parametrize("ma3", [False, True])
@pytest.mark.parametrize("s,n_frames", [(3, 2), (3, 4), (1, 2), (17, 2)])
def test_am_gather(card, ma3, s, n_frames):
    """K15 on random codes and a random handed-on delay line, int8 exact,
    one launch: 2 frames (every delayed bit from the line) at 1, 3 and 17
    stations, and 4 (frame 3's from frame 0); the lines the mode does not
    delay come back as the same tensors."""
    codes, pids, lines = _am_gather_inputs(
        card, 22 + 2 * n_frames + ma3 + 5 * s, s, n_frames)
    before = K.COUNTS["am_gather"]
    got = DA.am_gather(codes, pids, lines, ma3)
    assert K.COUNTS["am_gather"] == before + 1
    want = DA.am_gather_plain(codes, pids, lines, ma3)
    for a, b in zip(list(got[:3]) + list(got[3]),
                    list(want[:3]) + list(want[3])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(a.dtype == torch.int8 for a in got[:3])
    nd = DA.gather_maps(ma3)["n_delayed"]
    for i, (a, b) in enumerate(zip(lines, got[3])):
        assert (a is b) == (i >= nd)


@pytest.mark.parametrize("disabled", [False, True])
@pytest.mark.parametrize("blocks", [1, 8, 33])
def test_am_gather_pids(card, disabled, blocks):
    """K15's PIDS-only launch on random QAM16 codes, int8 exact against
    its plain version, one launch counted on its own: a block (the
    per-block receiver's call), a frame's 8 and 33, with the lower stream
    zeroed (pids1_disabled) and not; through K7 at K=9 and K8 the bits of
    the plain decode."""
    g = torch.Generator().manual_seed(60 + blocks + disabled)
    pids = torch.randint(0, 16, (blocks, 32, 2), generator=g,
                         dtype=torch.uint8).to(card)
    before = dict(K.COUNTS)
    got = DA.am_gather_pids(pids, disabled)
    assert K.COUNTS["am_gather_pids"] == before["am_gather_pids"] + 1
    assert K.COUNTS["am_gather"] == before["am_gather"]
    want = DA.am_gather_pids_plain(pids, disabled)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(DA.am_pids_decode(pids, disabled),
                       DA.am_pids_decode(pids.cpu(), disabled).to(card))


@pytest.mark.parametrize("ma3", [False, True])
def test_am_frame_decode_on_card(card, ma3):
    """The per-block AM receiver's frame decode on the card (its codes
    packed into K15's [1, 8, 4, 800], K15, K7 at K=9 and K8 on P1 and P3)
    over 4 encoded frames with two flipped codes each, from a carried
    diversity state: P1 and P3 bits, both margins and the delay lines
    exact against the CPU twin; one K15, two K7 and two K8 launches a
    frame, no PIDS-only launch."""
    rng = np.random.default_rng(70 + ma3)
    n = 4
    p1 = rng.integers(0, 2, (n, 8, C.P1_FRAME_LEN_AM)).astype(np.uint8)
    t3 = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    p3 = rng.integers(0, 2, (n, t3)).astype(np.uint8)
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(p1[f]) for f in range(n)],
        [EAM.encode_p3_am(p3[f], ma3) for f in range(n)], ma3)
    cpu = gpu = DA.AMDecodeState(*(torch.zeros(DA.DD, dtype=torch.uint8)
                                   for _ in DA.DELAYED))
    gpu = DA.AMDecodeState(*(x.to(card) for x in gpu))
    for f in range(n):
        m = [mats[f][k].copy() for k in DA.MATRICES]
        m[0][17] ^= 5
        m[3][4000] ^= 1
        m = [torch.from_numpy(x) for x in m]
        before = dict(K.COUNTS)
        wp1, wp3, wm, cpu = DA.am_frame_decode(*m, cpu, ma3)
        gp1, gp3, gm, gpu = DA.am_frame_decode(*(x.to(card) for x in m),
                                               gpu, ma3)
        assert {k: K.COUNTS[k] - before.get(k, 0) for k in K.COUNTS
                if K.COUNTS[k] != before.get(k, 0)} == {
            "am_gather": 1, "viterbi_k9": 2, "fec_epilogue": 2}
        assert torch.equal(gp1.cpu(), wp1) and torch.equal(gp3.cpu(), wp3)
        for k in ("p1", "p3"):
            assert torch.equal(gm[k].cpu(), wm[k])
        for a, b in zip(gpu, cpu):
            assert torch.equal(a.cpu(), b)
    assert np.array_equal(gp1.cpu().numpy(), p1[n - 1])
    assert np.array_equal(gp3.cpu().numpy(), p3[n - 1])


@pytest.mark.parametrize("segs,length,gens", [
    (1024, 1258, C.CONV_E1_GEN), (768, 1320, C.CONV_E2_E3_GEN),
    (960, 1320, C.CONV_E1_GEN), (256, 144, C.CONV_E2_E3_GEN),
    (1, 1258, C.CONV_E1_GEN), (33, 1320, C.CONV_E2_E3_GEN),
    (4065, 144, C.CONV_E1_GEN), (5, 9, C.CONV_E1_GEN),
    (3, 191, C.CONV_E2_E3_GEN)])
@pytest.mark.parametrize("llr", ["am", "soft", "zeros", "sat"])
def test_viterbi_k9(card, segs, length, gens, llr):
    """K7 at K=9 at the AM chain's shapes (P1, P3 of MA1 and MA3, PIDS),
    ragged segment counts and short segments: the chain's LLRs (+-1 with
    punctured zeros and some flips), integer soft LLRs with noise,
    all-tie input and saturated input."""
    ext = _viterbi_ext(llr, 9, gens, segs, length, 23 + segs + length)
    _viterbi_check(ext, gens, 9)


@pytest.mark.parametrize("ma3", [False, True])
def test_viterbi_k9_chain_inputs(card, ma3):
    """K7 at K=9 on K15's own P1, P3 and PIDS segments of random codes and
    delay lines (2 frames of 16 stations)."""
    codes, pids, lines = _am_gather_inputs(card, 41 + ma3, 16, 2)
    p1, p3, pids_ext, _ = DA.am_gather(codes, pids, lines, ma3)
    _viterbi_check(p1, C.CONV_E1_GEN, 9)
    _viterbi_check(p3, C.CONV_E1_GEN if ma3 else C.CONV_E2_E3_GEN, 9)
    _viterbi_check(pids_ext, C.CONV_E2_E3_GEN, 9)


@pytest.mark.parametrize("channel", ["p1", "p3_ma1", "p3_ma3", "pids"])
def test_viterbi_k9_int8(card, channel):
    """K7 at K=9 on K15's int8 segments (2 frames of 16 stations) gives the
    bits and margins of the same values in float32, and of the plain
    version; one launch each."""
    ma3 = channel == "p3_ma3"
    codes, pids, lines = _am_gather_inputs(card, 43 + ma3, 16, 2)
    p1, p3, pids_ext, _ = DA.am_gather(codes, pids, lines, ma3)
    ext = {"p1": p1, "p3_ma1": p3, "p3_ma3": p3, "pids": pids_ext}[channel]
    gens = C.CONV_E1_GEN if channel in ("p1", "p3_ma3") \
        else C.CONV_E2_E3_GEN
    assert ext.dtype == torch.int8
    _viterbi_check(ext, gens, 9)
    kb, km = CV.acs_traceback(ext, gens, 9)
    fb, fm = CV.acs_traceback(ext.float(), gens, 9)
    assert torch.equal(kb, fb) and torch.equal(km, fm)


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
    assert K.COUNTS["am_tone"] == before + 3  # k0 and z, projection, tail
    want = AA.am_tone_plain(spectra, x, offset)
    for a, b in zip(got, want):
        assert torch.equal(a, b), (a, b)


def _tone_windows(s, n, seed):
    """``s`` stations of rc samples [s, n, 2]: a carrier at a random
    frequency in ±100 bins and a random amplitude, in white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    f = rng.uniform(-100, 100, s) / C.FFT_AM
    x = rng.uniform(0.5, 2.0, s)[:, None] * np.exp(
        2j * np.pi * (f[:, None] * t + rng.uniform(0, 1, s)[:, None])) \
        + 0.3 * (rng.standard_normal((s, n)) + 1j * rng.standard_normal((s, n)))
    return np.stack([x.real, x.imag], -1).astype(np.float32)


@pytest.mark.parametrize("s", [1, 16, 17])
def test_am_tone_stations(card, s):
    """K14's tone estimate at 1, 16 and 17 stations (17: a second
    projection chunk of one station): f and amp exact, three launches."""
    x = torch.from_numpy(_tone_windows(s, 20000, 80 + s)).to(card)
    g = torch.Generator().manual_seed(s)
    offset = torch.randint(0, 20000 - AA.WINDOW_AM, (s,), generator=g,
                           dtype=torch.int32).to(card)
    spectra = rc.dft(AA.tone_symbols(x, offset))
    before = K.COUNTS["am_tone"]
    got = AA.am_tone(spectra, x, offset)
    assert K.COUNTS["am_tone"] == before + 3
    for a, b in zip(got, AA.am_tone_plain(spectra, x, offset)):
        assert torch.equal(a, b), (a, b)


def test_am_tone_edges(card):
    """K14's tone estimate on a window clamped at the capture's end (an
    offset past it), an all-zero window (flat: no grid point stands out
    and Newton's curvature h is 0, so no step is taken) and a window
    starting at a negative offset (counted from the end): exact."""
    x = torch.from_numpy(_tone_windows(3, 12000, 90)).to(card)
    x[1] = 0.0
    offset = torch.tensor([11000, 500, -9000], dtype=torch.int32,
                          device=card)
    spectra = rc.dft(AA.tone_symbols(x, offset))
    got = AA.am_tone(spectra, x, offset)
    want = AA.am_tone_plain(spectra, x, offset)
    for a, b in zip(got, want):
        assert torch.equal(a, b), (a, b)
    assert float(want[1][1].abs().max()) == 0.0  # the zero window's amp


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


@pytest.mark.parametrize("s", [1, 3, 17])
def test_am_coarse_stations(card, s):
    """K14's coarse timing at 1, 3 and 17 stations of tones in noise (17:
    a cluster past the card's first 16 stations' worth), each window at an
    odd offset, one clamped at the end and one counted from the end, the
    latch -1, in range and past 270, prev_angle zero and nonzero: every
    output exact, one launch a call."""
    n = 20000
    x = torch.from_numpy(_tone_windows(s, n, 140 + s)).to(card)
    g = torch.Generator().manual_seed(140 + s)
    offs = 2 * torch.randint(0, (n - AA.WINDOW_AM) // 2, (s,), generator=g) + 1
    offs[1::3] = n + 7  # clamped at the end
    offs[2::3] = -(n // 2) - 3  # from the end, odd
    offset = offs.to(torch.int32).to(card)
    spectra = rc.dft(AA.tone_symbols(x, offset))
    f, amp = AA.am_tone_plain(spectra, x, offset)
    pa = (torch.rand(s, generator=g) * 6 - 3).to(card)
    pa[::2] = 0.0
    ov = torch.tensor([-1, 17, 270, 541, -1, 269][:s] * (s // 6 + 1),
                      dtype=torch.int32)[:s].to(card)
    before = K.COUNTS["am_coarse"]
    got = AA.am_coarse(x, offset, f, amp, pa, ov)
    assert K.COUNTS["am_coarse"] == before + 1
    for a, b in zip(got, AA.am_coarse_plain(x, offset, f, amp, pa, ov)):
        assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


@pytest.mark.parametrize("s", [1, 3, 17])
def test_am_cfo_step_stations(card, s):
    """K14's integer-CFO step at 1, 3 and 17 stations of random spectra,
    the last station's two strongest bins equal (the first wins): the 107
    magnitude sums and the steps exact, one launch a call."""
    g = torch.Generator().manual_seed(150 + s)
    spectra1 = torch.randn(s, C.BLKSZ, C.FFT_AM, 2, generator=g)
    lo = AA.CFO_LO
    spectra1[-1, :, lo + 90] = 4 * spectra1[-1, :, lo + 7]
    spectra1[-1, :, lo + 7] = spectra1[-1, :, lo + 90]
    spectra1 = spectra1.to(card)
    before = K.COUNTS["am_cfo_step"]
    step, mags = AA.am_cfo_step(spectra1)
    assert K.COUNTS["am_cfo_step"] == before + 1
    pstep, pmags = AA.am_cfo_step_plain(spectra1)
    assert torch.equal(step, pstep) and torch.equal(mags, pmags)
    assert int(step[-1]) == 7 + lo - C.CENTER_AM


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
        "am_tone": 3, "am_coarse": 1, "am_fold": 2, "am_cfo_step": 1,
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


@pytest.mark.parametrize("stations,n,shift", [
    (1, 300, 0),    # one station, a session push of a few hundred outputs
    (1, 600, 1),    # the same, one pair past a 4-byte boundary
    (2, 257, 0),    # a last tile of one output
    (3, 777, 0),    # rows 868 + 64 N bytes apart: off 16-byte boundaries
    (3, 777, 1),    # and the wire one pair past a 4-byte boundary
    (16, 512, 3),   # whole tiles, three pairs in
])
def test_am_decimate_cu8_edges(card, stations, n, shift):
    """K1's AM cascade on random cu8 wires at its edge shapes, the wire
    placed ``shift`` pairs into its allocation: bit-identical to the plain
    version; a wire at an odd address is refused."""
    g = torch.Generator().manual_seed(27 + n + shift)
    rows = FE.rc_overlap(5) + 32 * n
    flat = torch.randint(0, 256, (2 * (stations * rows + shift) + 1,),
                         generator=g, dtype=torch.uint8).to(card)
    wire = flat[2 * shift:2 * shift + 2 * stations * rows].view(
        stations, rows, 2)
    before = K.COUNTS["am_decimate_cu8"]
    got = FE.ingest_am_cu8(wire)
    assert K.COUNTS["am_decimate_cu8"] == before + 1
    assert torch.equal(got, FE.ingest_am_cu8_plain(wire))
    odd = flat[1:1 + 2 * stations * rows].view(stations, rows, 2)
    with pytest.raises(ValueError):
        FE.ingest_am_cu8(odd)


# --- K16: batched HDC audio ------------------------------------------------

_AUDIO_HEADERS = {
    "default": None,
    "interpol0": SBR.SbrHeader(start_freq=8, stop_freq=7, amp_res=0,
                               xover_band=2, interpol_freq=0),
    "smooth": SBR.SbrHeader(start_freq=8, stop_freq=7, amp_res=0,
                            xover_band=2, smoothing_mode=0),
}


@functools.lru_cache(maxsize=None)
def _audio_batch(header: str):
    """Eight stereo SBR packets of a tone over noise with two sharp bursts
    (so both long and EIGHT_SHORT windows occur) under ``header``, prepared
    by a one-program decoder on the CPU after one batch of the same packets
    (so the carried state is not zero): (stage, numpy inputs, numpy
    state)."""
    fs, n = 44100, 8
    rng = np.random.default_rng(16)
    t = np.arange(n * 2048) / fs
    x = 0.04 * np.sin(2 * np.pi * 500 * t) + 0.01 * rng.standard_normal(
        n * 2048)
    tt = np.arange(256)
    burst = np.sin(2 * np.pi * 2400 * tt / fs) * np.hanning(256)
    for k in (2, 5):
        x[k * 2048 + 700:k * 2048 + 956] += 0.7 * burst / np.abs(burst).max()
    pcm = np.clip(np.stack([x, 0.9 * x], -1), -1, 1)
    hdr = _AUDIO_HEADERS[header]
    enc = HDCEncoder(channels=2, sbr=True, pns=False,
                     **({} if hdr is None else {"sbr_header": hdr}))
    pkts = [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048]) for k in range(n)]
    dec = BatchedAudioDecoder(1, device="cpu")
    dec.decode([pkts])
    stage, inp, smooth, key = dec.prepare([pkts])
    dec._reconcile_state(smooth, key)
    assert inp["short"].any() and not inp["short"].all()
    return stage, inp, {k: v.numpy() for k, v in dec._state.items()}


def _audio_case(header: str, lanes: int, dev):
    stage, inp, state = _audio_batch(header)
    reps = lanes // inp["spec_long"].shape[0]

    def tile(a):
        return np.ascontiguousarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1)))
    return (stage.to(dev), device_inputs({k: tile(v) for k, v in inp.items()},
                                         dev),
            {k: torch.from_numpy(tile(v)).to(dev) for k, v in state.items()})


@pytest.mark.parametrize("kp,lanes,windows", [
    (1, 1, "long"), (1, 3, "short"), (1, 129, "mixed"), (8, 1, "short"),
    (8, 3, "mixed"), (8, 129, "long")])
def test_window_qmf_analysis_shapes(card, kp, lanes, windows):
    """K16a at 1 and 8 packets, 1, 3 and 129 lanes (groups of 4 items
    across lane edges, a partial last group), all-long, all-short and mixed
    windows, on random inputs: every output equal to the plain version,
    one launch."""
    rng = np.random.default_rng(1600 + 10 * kp + lanes)

    def f32(*shape, lo=-1.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape).astype(
            np.float32)).to(card)

    short = {"long": np.zeros((lanes, kp), bool),
             "short": np.ones((lanes, kp), bool),
             "mixed": rng.integers(0, 2, (lanes, kp)).astype(bool)}[windows]
    args = (f32(lanes, kp, 2048), f32(lanes, kp, 8, 256),
            torch.from_numpy(rng.integers(0, 13, (lanes, kp)).astype(
                np.uint8)).to(card),
            torch.from_numpy(rng.integers(0, 5, (lanes, kp)).astype(
                np.uint8)).to(card),
            torch.from_numpy(short).to(card), f32(lanes, 1024),
            f32(lanes, 288), f32(13, 2048, lo=0.0), f32(5, 8, 256, lo=0.0),
            f32(320, 64))
    before = K.COUNTS["aac_window_qmf_analysis"]
    got = AST.window_qmf_analysis(*args)
    assert K.COUNTS["aac_window_qmf_analysis"] == before + 1
    want = AST.window_qmf_analysis(*args, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lanes", [2, 128])
@pytest.mark.parametrize("header", sorted(_AUDIO_HEADERS))
def test_audio_kernels(card, header, lanes):
    """K16a-d one after the other on one batch of 8 packets (2 lanes, and
    the 128 lanes of a 64-program fleet), each against its plain version on
    the same inputs: every output equal.  Then the whole stage through the
    kernels (each launched once, no plain version) equal to it through the
    plain versions, PCM and every carried state tensor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    stage, inp, state = _audio_case(header, lanes, card)
    n, kp = inp["spec_long"].shape[:2]
    long_raw = torch.matmul(inp["spec_long"].reshape(n * kp, -1),
                            stage.blt).reshape(n, kp, 2048)
    short_raw = torch.matmul(inp["spec_short"].reshape(n * kp * 8, -1),
                             stage.bst).reshape(n, kp, 8, 256)
    args = (long_raw, short_raw, inp["win_long_idx"], inp["win_short_idx"],
            inp["short"], state["overlap"], state["qa_hist"],
            stage.lut_long, stage.lut_short, stage.ka)
    got = AST.window_qmf_analysis(*args)
    want = AST.window_qmf_analysis(*args, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    xl = got[0]
    args = (xl, state["tail_r"], state["tail_i"], inp["bwj"], stage.src_idx,
            stage.src_ok, stage.kx)
    got = AST.sbr_hf_generate(*args)
    want = AST.sbr_hf_generate(*args, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    args = (got[0], xl, inp["env_seg"], inp["freq_res"], inp["e_bands"],
            inp["q_bands"], inp["harm_act"], inp["delta_e"],
            inp["noise_start"], inp["nlow"], state.get("g_hist"),
            state.get("q_hist"), stage.maps(), stage.noise_tab, stage.kx,
            stage.lim_gain, stage.interpol, stage.smooth)
    got = AST.sbr_hf_adjust(*args)
    want = AST.sbr_hf_adjust(*args, plain=True)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (not stage.smooth)
    if stage.smooth:
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    x = got[0]
    v = (torch.matmul(x[0].reshape(-1, 64), stage.smr)
         - torch.matmul(x[1].reshape(-1, 64), stage.smi)).reshape(
             n, kp * 32, 128)
    args = (v, state["syn_hist"], stage.cidx, stage.w10)
    got = AST.qmf_synthesis(*args)
    want = AST.qmf_synthesis(*args, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    K.reset_counts()
    new_k, pcm_k = stage(state, inp)
    assert {k: c for k, c in K.COUNTS.items() if c} == {
        "aac_window_qmf_analysis": 1, "sbr_hf_generate": 1,
        "sbr_hf_adjust": 1, "qmf_synthesis": 1}
    new_p, pcm_p = stage(state, inp, plain=True)
    assert pcm_k.dtype == torch.int16 and pcm_k.shape == (n, kp * 2048)
    assert torch.equal(pcm_k, pcm_p)
    assert sorted(new_k) == sorted(new_p) == sorted(state)
    for k in new_k:
        assert torch.equal(new_k[k], new_p[k]), k
    assert pcm_k.abs().max().item() > 1000


def test_audio_kernels_refuse(card):
    """The K16 wrappers refuse a tensor of the wrong type or shape."""
    stage, inp, state = _audio_case("default", 2, card)
    with pytest.raises(ValueError):
        AST.qmf_synthesis(torch.zeros(2, 8, 128, device=card),
                          state["syn_hist"], stage.cidx, stage.w10)
    with pytest.raises(ValueError):
        AST.sbr_hf_generate(torch.zeros(2, 256, 64, device=card,
                                        dtype=torch.float64),
                            state["tail_r"], state["tail_i"], inp["bwj"],
                            stage.src_idx, stage.src_ok, stage.kx)


@functools.lru_cache(maxsize=None)
def _audio_stream(kind: str):
    """``chip_smoke.py``'s audio stream ``kind``, its 8 packets decoded once
    and prepared again by a one-program decoder on the CPU: (stage, numpy
    inputs, numpy state)."""
    import chip_smoke
    pkts = chip_smoke.make_audio_stream(kind)
    dec = BatchedAudioDecoder(1, device="cpu")
    dec.decode([pkts])
    stage, inp, smooth, key = dec.prepare([pkts])
    dec._reconcile_state(smooth, key)
    return stage, inp, {k: v.numpy() for k, v in dec._state.items()}


@pytest.mark.parametrize("kp", [1, 3, 8])
@pytest.mark.parametrize("kind", ["steady", "transient", "mono"])
def test_sbr_hf_generate_streams(card, kind, kp):
    """K16b on each audio stream of ``chip_smoke.py`` (stereo steady,
    stereo with transients, mono), its first ``kp`` packets of xl from
    K16a's plain version, the carried tails not zero, its lanes tiled to
    129: x_high and the new tails equal to the plain version's, one
    launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    stage, inp, state = _audio_stream(kind)
    stage = stage.to(card)
    st = {k: torch.from_numpy(_lanes(v, 129)).to(card)
          for k, v in state.items()}
    inp = device_inputs({k: np.ascontiguousarray(_lanes(v, 129)[:, :kp])
                         for k, v in inp.items()}, card)
    n = inp["spec_long"].shape[0]
    xl = AST.window_qmf_analysis(
        torch.matmul(inp["spec_long"].reshape(n * kp, -1),
                     stage.blt).reshape(n, kp, 2048),
        torch.matmul(inp["spec_short"].reshape(n * kp * 8, -1),
                     stage.bst).reshape(n, kp, 8, 256),
        inp["win_long_idx"], inp["win_short_idx"], inp["short"],
        st["overlap"], st["qa_hist"], stage.lut_long, stage.lut_short,
        stage.ka, plain=True)[0]
    assert st["tail_r"].abs().max() > 0
    args = (xl, st["tail_r"], st["tail_i"], inp["bwj"],
            stage.src_idx, stage.src_ok, stage.kx)
    before = K.COUNTS["sbr_hf_generate"]
    got = AST.sbr_hf_generate(*args)
    assert K.COUNTS["sbr_hf_generate"] == before + 1
    want = AST.sbr_hf_generate(*args, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _audio_batch16(header: str):
    """Sixteen stereo SBR packets of a tone over noise with sharp bursts
    in packets 2, 5, 8, 11 and 14 under ``header``, prepared by a
    one-program decoder on the CPU after one batch of the same packets:
    (stage, numpy inputs, numpy state)."""
    fs, n = 44100, 16
    rng = np.random.default_rng(1616)
    t = np.arange(n * 2048) / fs
    x = 0.04 * np.sin(2 * np.pi * 500 * t) + 0.01 * rng.standard_normal(
        n * 2048)
    tt = np.arange(256)
    burst = np.sin(2 * np.pi * 2400 * tt / fs) * np.hanning(256)
    for k in range(2, n, 3):
        x[k * 2048 + 700:k * 2048 + 956] += 0.7 * burst / np.abs(burst).max()
    pcm = np.clip(np.stack([x, 0.9 * x], -1), -1, 1)
    hdr = _AUDIO_HEADERS[header]
    enc = HDCEncoder(channels=2, sbr=True, pns=False,
                     **({} if hdr is None else {"sbr_header": hdr}))
    pkts = [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048]) for k in range(n)]
    dec = BatchedAudioDecoder(1, device="cpu")
    dec.decode([pkts])
    stage, inp, smooth, key = dec.prepare([pkts])
    dec._reconcile_state(smooth, key)
    return stage, inp, {k: v.numpy() for k, v in dec._state.items()}


def _lanes(a, lanes):
    """``a`` [2, ...] tiled along its lanes and cut to ``lanes``."""
    reps = -(-lanes // a.shape[0])
    return np.ascontiguousarray(
        np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:lanes])


@pytest.mark.parametrize("kp", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("header", sorted(_AUDIO_HEADERS))
def test_sbr_hf_adjust_shapes(card, header, kp):
    """K16c (one CTA a lane's two packets under every header; with
    smoothing each CTA also runs the envelope phases of the packet before
    its first) on the first ``kp`` packets of a 16-packet batch (odd counts
    leave a CTA one packet), at 1, 3 and 129 lanes, on K16a's and K16b's
    outputs: X and the new histories equal to the plain version's, one
    launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    stage, inp, state = _audio_batch16(header)
    stage = stage.to(card)
    for lanes in (1, 3, 129):
        i = device_inputs({k: _lanes(v[:, :kp], lanes)
                           for k, v in inp.items()}, card)
        s = {k: torch.from_numpy(_lanes(v, lanes)).to(card)
             for k, v in state.items()}
        xl = AST.window_qmf_analysis(
            torch.matmul(i["spec_long"].reshape(lanes * kp, -1),
                         stage.blt).reshape(lanes, kp, 2048),
            torch.matmul(i["spec_short"].reshape(lanes * kp * 8, -1),
                         stage.bst).reshape(lanes, kp, 8, 256),
            i["win_long_idx"], i["win_short_idx"], i["short"],
            s["overlap"], s["qa_hist"], stage.lut_long, stage.lut_short,
            stage.ka)[0]
        xh = AST.sbr_hf_generate(xl, s["tail_r"], s["tail_i"], i["bwj"],
                                 stage.src_idx, stage.src_ok, stage.kx)[0]
        args = (xh, xl, i["env_seg"], i["freq_res"], i["e_bands"],
                i["q_bands"], i["harm_act"], i["delta_e"], i["noise_start"],
                i["nlow"], s.get("g_hist"), s.get("q_hist"), stage.maps(),
                stage.noise_tab, stage.kx, stage.lim_gain, stage.interpol,
                stage.smooth)
        before = K.COUNTS["sbr_hf_adjust"]
        got = AST.sbr_hf_adjust(*args)
        assert K.COUNTS["sbr_hf_adjust"] == before + 1
        want = AST.sbr_hf_adjust(*args, plain=True)
        assert torch.equal(got[0], want[0]), lanes
        assert (got[1] is None) == (not stage.smooth)
        if stage.smooth:
            assert torch.equal(got[1], want[1]), lanes
            assert torch.equal(got[2], want[2]), lanes


@pytest.mark.parametrize("taps", ["paired", "swapped"])
@pytest.mark.parametrize("lanes", [1, 3, 129])
@pytest.mark.parametrize("slots", [9, 31, 256, 264])
def test_qmf_synthesis_shapes(card, slots, lanes, taps):
    """K16d (a CTA a (lane, tile of 64 slots), 9 rows of halo, the first
    tile's from the history) at 9, 31, 256 and 264 slots (a partial last
    tile, a tile shorter than the history) and 1, 3 and 129 lanes, on
    values that round at exact halves and clip at both ends, with the
    synthesis taps (each row read once for the slots that share it) and
    with their columns swapped between even and odd taps (the general
    path): PCM and the new history equal to the plain version's, one
    launch a call."""
    rng = np.random.default_rng(1640 + slots + lanes)
    cidx, w10 = AST._synthesis_taps()
    if taps == "swapped":
        cidx = (cidx + 64) % 128
    w10 = w10.copy()
    # columns 0-15 pass tap 0 alone: their outputs are V's values, exact
    # halves of either parity, some past int16 at both ends
    w10[:, :16] = 0.0
    w10[0, :16] = 1.0
    v = rng.normal(0.0, 3e4, (lanes, slots, 128)).astype(np.float32)
    v[..., :16] = rng.integers(-40000, 40000, (lanes, slots, 16)) + 0.5
    cidx, w10, v = (torch.from_numpy(a).to(card) for a in (cidx, w10, v))
    hist = torch.from_numpy(rng.normal(0.0, 3e4, (lanes, AST.SYN_HIST, 128))
                            .astype(np.float32)).to(card)
    before = K.COUNTS["qmf_synthesis"]
    got = AST.qmf_synthesis(v, hist, cidx, w10)
    assert K.COUNTS["qmf_synthesis"] == before + 1
    want = AST.qmf_synthesis(v, hist, cidx, w10, plain=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[0].min().item() == -32768 and want[0].max().item() == 32767


# --- K5: the block loops' carry step and their CUDA graphs ---

def test_block_carry(card):
    """K5's FM carry step against its plain version on random per-station
    state, the prologue (first) and a block's step: every field exact."""
    from nrsc5_tpu_torch.pipeline import block_graph as BG
    g = torch.Generator().manual_seed(5)
    s = 37

    def ints(lo, hi):
        return torch.randint(lo, hi, (s,), generator=g, dtype=torch.int32)

    def floats():
        return torch.randn(s, generator=g)

    for first in (True, False):
        state = {"offset": ints(0, 9000), "prev_angle": floats(),
                 "samperr_fb": ints(-40, 40), "angle_fb": floats(),
                 "samperr": ints(1000, 1200), "angle": floats(),
                 "timing_adj": ints(-50, 50)}
        keep, k4_s, k4_a = ints(2100, 2200), ints(-30, 30), floats()
        got = {k: v.to(card) for k, v in state.items()}
        before = K.COUNTS["block_carry"]
        BG.block_carry(keep.to(card), k4_s.to(card), k4_a.to(card), got,
                       first)
        assert K.COUNTS["block_carry"] == before + 1
        BG.block_carry_plain(keep, k4_s, k4_a, state, first)
        for k in state:
            assert torch.equal(got[k].cpu(), state[k]), (first, k)


def test_block_carry_am(card):
    """K5's AM carry step against its plain version: offset exact."""
    from nrsc5_tpu_torch.pipeline import block_graph as BG
    g = torch.Generator().manual_seed(6)
    offset = torch.randint(0, 9000, (19,), generator=g, dtype=torch.int32)
    keep = torch.randint(250, 300, (19,), generator=g, dtype=torch.int32)
    got = offset.to(card)
    before = K.COUNTS["block_carry_am"]
    BG.block_carry_am(keep.to(card), got)
    assert K.COUNTS["block_carry_am"] == before + 1
    BG.block_carry_am_plain(keep, offset)
    assert torch.equal(got.cpu(), offset)


def _fm_stream(rng, psmi, n_frames, cfo_hz):
    """``n_frames`` frame-aligned frames of one station at 25 dB with the
    PX partitions carrying random signs, as conjugated rc chain input."""
    mats = [build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))
        for _ in range(n_frames)]
    n_blocks = n_frames * C.P1_FM_BLOCKS
    px = {f"{k}_signs": rng.choice([-1, 1], (n_blocks * C.BLKSZ, fl // 32))
          .astype(np.int8) for k, fl in zip(("px1", "px2"),
                                             px_frame_lens(psmi)) if fl}
    sig = modulate_fm(np.concatenate(mats), np.tile(np.arange(16), n_frames),
                      psmi, **px)
    buf = np.zeros(len(sig) + 2 * C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    buf = ch.impair(buf, cfo_hz=cfo_hz, snr_db=25.0, rng=rng)
    return np.stack([buf.real, -buf.imag], -1).astype(np.float32)


def _chained(step, wires, carry, n):
    """Three dispatches of ``step`` on the stations' streams, each queue
    advanced by what its station consumed: the outputs, carries and
    launch counts of each."""
    pos = np.zeros(len(wires), np.int64)
    runs = []
    for _ in range(3):
        w = torch.from_numpy(np.stack([x[p:p + n] for x, p in
                                       zip(wires, pos.tolist())]))
        K.reset_counts()
        out, new = step(w, carry)
        torch.cuda.synchronize()
        runs.append((out, new, {k: c for k, c in K.COUNTS.items() if c}))
        pos += new.offset.cpu().numpy()
        carry = new._replace(offset=torch.zeros_like(new.offset))
    return runs


def _same_runs(a, b):
    def flat(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{prefix}{k}.")
        elif isinstance(x, tuple):
            for k, v in zip(getattr(x, "_fields", range(len(x))), x):
                yield from flat(v, f"{prefix}{k}.")
        else:
            yield prefix, x
    for (ao, ac, al), (bo, bc, bl) in zip(a, b):
        assert al == bl
        for (ka, va), (kb, vb) in zip(flat((ao, ac)), flat((bo, bc)),
                                      strict=True):
            assert ka == kb and torch.equal(va, vb), ka


@pytest.mark.parametrize("psmi", [1, 3])
def test_block_graph_fm(card, psmi):
    """The FM dispatch's ingest and block loop replayed as a CUDA graph
    against the same kernels launched eagerly: every output (bits,
    margins, diagnostics, PX) and every carry field bit-identical over
    three chained dispatches of 32 blocks, from three stations at CFOs of
    0, +40 and -75 Hz; the launch counts equal, K2, the DFT kernel and K4
    once a block, K5 once, before the first (K4 takes the later carry
    steps)."""
    from nrsc5_tpu_torch import serve
    rng = np.random.default_rng(50 + psmi)
    wires = [_fm_stream(rng, psmi, 7, f) for f in (0.0, 40.0, -75.0)]
    n = serve.buffer_len(32)
    carry = rcc.chain_rc_init_carry(psmi=psmi, n_stations=3, device=card)
    runs = {g: _chained(
        lambda w, c, g=g: serve.chain_step(w, c, 32, psmi, device=card,
                                           graph=g), wires, carry, n)
        for g in (False, True)}
    _same_runs(runs[False], runs[True])
    assert runs[True][0][2]["block_carry"] == 1
    for name in ("demod_fold", "dft_bf16", "sync_block"):
        assert runs[True][0][2][name] == 32


@pytest.mark.parametrize("ma3", [False, True])
def test_block_graph_am(card, ma3):
    """The AM dispatch's block loop replayed as a CUDA graph against the
    eager kernel loop: every output and every carry field (delay lines
    included) bit-identical over three chained dispatches of 2 frames,
    from three stations at CFOs of 0, +7 and -9 Hz; the launch counts
    equal, K13 once a block and no K5 (K13 takes the carry step)."""
    from nrsc5_tpu_torch import serve
    rng = np.random.default_rng(60 + ma3)
    wires = [_am_capture(rng, ma3, 7, f) for f in (0.0, 7.0, -9.0)]
    n = scar.am_buffer_len(2)
    carry = scar.am_chain_rc_init_carry(n_stations=3, device=card)
    runs = {g: _chained(
        lambda w, c, g=g: serve.chain_step_am(w, c, 2, ma3, device=card,
                                              graph=g), wires, carry, n)
        for g in (False, True)}
    _same_runs(runs[False], runs[True])
    assert runs[True][0][2]["sync_am_block"] == 16
    assert "block_carry_am" not in runs[True][0][2]


@pytest.mark.parametrize("psmi", [1, 3])
def test_fused_carry_graph_two_dispatches_fm(card, psmi):
    """The FM loop with K5's step fused into K4, replayed as a CUDA graph,
    against the eager kernel loop and against the plain versions over two
    chained dispatches of 32 blocks (one station): the graph the eager
    run's outputs and carries exactly, the plain path the same decoded
    bits and consumed samples; one K5 launch a dispatch."""
    from nrsc5_tpu_torch import serve
    rng = np.random.default_rng(80 + psmi)
    wires = [_fm_stream(rng, psmi, 5, 25.0)]
    n = serve.buffer_len(32)
    carry = rcc.chain_rc_init_carry(psmi=psmi, n_stations=1, device=card)
    runs = {g: _chained(
        lambda w, c, g=g: serve.chain_step(w, c, 32, psmi, device=card,
                                           graph=g), wires, carry, n)[:2]
        for g in (False, True)}
    _same_runs(runs[False], runs[True])
    plain = _chained(lambda w, c: serve.chain_step(
        w, c, 32, psmi, device=card, plain=True), wires, carry, n)[:2]
    for (go, gc, gl), (po, pc, _) in zip(runs[True], plain):
        assert gl["block_carry"] == 1 and gl["sync_block"] == 32
        assert torch.equal(go["pids"], po["pids"])
        if "p1" in po:
            assert torch.equal(go["p1"], po["p1"])
        assert torch.equal(gc.offset, pc.offset)


def test_fused_carry_graph_two_dispatches_am_cu8(card):
    """The AM loop from a cu8 wire (K1's AM cascade in the graph) with
    K5's step fused into K13, replayed as a CUDA graph, against the eager
    kernel loop over two chained dispatches of 2 frames (two stations at a
    tuner's level): every output and carry field exactly; each dispatch
    launches the cascade once, K13 16 times and no K5."""
    from nrsc5_tpu_torch import serve
    rng = np.random.default_rng(90)
    n_out = scar.am_buffer_len(2)
    wires = []
    for cfo in (0.0, 6.0):
        buf = _am_capture(rng, False, 7, cfo)
        sig = buf[:, 0] + 1j * buf[:, 1]
        pad = np.zeros(-(-(len(sig) + 8) // 4096) * 4096, np.complex64)
        pad[:len(sig)] = sig
        up = ch.upsample_exact(pad, 32)
        wires.append(serve.stream_wire(ch.to_cu8(up * (0.4 / np.abs(
            up).max())), FE.AM_STAGES))
    n = FE.rc_overlap(FE.AM_STAGES) + 32 * n_out
    carry = scar.am_chain_rc_init_carry(n_stations=2, device=card)

    def step(g):
        def run(w, c):
            out, new = serve.chain_step_am(w.to(card), c, 2, device=card,
                                           graph=g)
            # the queue advances 32 wire pairs a chain sample
            return out, new._replace(offset=new.offset * 32)
        return run
    runs = {g: _chained(step(g), wires, carry, n)[:2] for g in (False, True)}
    _same_runs(runs[False], runs[True])
    for _, _, launches in runs[True]:
        assert launches["am_decimate_cu8"] == 1
        assert launches["sync_am_block"] == 16
        assert "block_carry_am" not in launches


def test_probe_graph(card):
    """The AM cold start with its probe block replayed as a CUDA graph
    against the probe launched eagerly: the same locks (offset, psmi, ma3,
    CFO) and carries, and the same launches a probe block."""
    rng = np.random.default_rng(70)
    bin_hz = C.SAMPLE_RATE_CS16_AM / C.FFT_AM
    caps = []
    for k, (ma3, cfo) in enumerate(((False, 2 * bin_hz + 23.0),
                                    (True, -bin_hz + 11.0),
                                    (False, 5.0))):
        buf = _am_capture(rng, ma3, 6, 0.0)
        sig = ch.impair(buf.view(np.complex64)[:, 0], sample_offset=300
                        + 700 * k, cfo_hz=cfo, snr_db=30.0,
                        sample_rate=C.SAMPLE_RATE_CS16_AM, rng=rng)
        caps.append(np.stack([sig.real, sig.imag], -1).astype(np.float32))
    n = min(len(c) for c in caps)
    x = torch.from_numpy(np.stack([c[:n] for c in caps])).to(card)
    got = {}
    for g in (False, True):
        K.reset_counts()
        got[g] = (scar.cold_start_am_rc(x, device=card, graph=g),
                  {k: c for k, c in K.COUNTS.items() if c})
    (eager, le), (graph, lg) = got[False], got[True]
    assert le == lg and all(lk is not None for lk in eager)
    for a, b in zip(eager, graph):
        assert {k: a[k] for k in ("offset", "psmi", "ma3", "cfo")} == \
            {k: b[k] for k in ("offset", "psmi", "ma3", "cfo")}
        for u, v in zip(a["carry"][:-1], b["carry"][:-1]):
            assert torch.equal(u, v)


# --- the receiver on the card against the receiver on the CPU ---

def _id3(title: str) -> bytes:
    frame = b"TIT2" + (len(title) + 1).to_bytes(4, "big") + b"\x00\x00" \
        + b"\x00" + title.encode("latin-1")
    n = len(frame)
    return b"ID3\x03\x00\x00" + bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F,
                                        (n >> 7) & 0x7F, n & 0x7F]) + frame


def _serve_fm(rng, title, n_frames):
    """tests/test_serve.py's ``_station_stream`` built with the port's
    transmitter: ``n_frames`` frame-aligned MP1 frames (bc 0) of 32 random
    HDC packets each, the title in the AAS PSD, complex64 baseband."""
    from nrsc5_tpu_torch.tx.transport_encoder import aas_frame, \
        build_p1_fm_frame
    packets = [rng.integers(0, 256, 280).astype(np.uint8).tobytes()
               for _ in range(n_frames * 32)]
    psd = aas_frame(0x5100, 0, _id3(title))
    mats = [build_pm_matrix(
        build_p1_fm_frame(packets[f * 32:(f + 1) * 32], 0, f % 8,
                          (f * 32) % 64, psd=psd),
        np.zeros((16, 80), np.uint8)) for f in range(n_frames)]
    sig = modulate_fm(np.concatenate(mats),
                      np.tile(np.arange(16), n_frames), 1)
    buf = np.zeros(len(sig) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    return buf


def _serve_am(rng, n_frames):
    """tests/test_serve.py's ``_am_stream`` built with the port's
    transmitter: ``n_frames`` MA1 frames, 4 random HDC packets a P1
    subframe, complex64 baseband."""
    from nrsc5_tpu_torch.tx.transport_encoder import build_p1_am_frame
    p1 = []
    for f in range(n_frames):
        p1.append(np.stack([build_p1_am_frame(
            [rng.integers(0, 256, 100).astype(np.uint8).tobytes()
             for _ in range(4)], 0, (f * 8 + b) % 8, ((f * 8 + b) * 4) % 64)
            for b in range(8)]))
    p3 = rng.integers(0, 2, (n_frames, C.P3_FRAME_LEN_MA1)).astype(np.uint8)
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(p1[f]) for f in range(n_frames)],
        [EAM.encode_p3_am(p3[f], False) for f in range(n_frames)], False)
    pids = np.stack([EAM.encode_pids_am(
        rng.integers(0, 2, 80).astype(np.uint8))
        for _ in range(n_frames * 8)])
    ref = np.stack([EAM.am_ref_bits(b % 8, 1) for b in range(n_frames * 8)])
    sig = modulate_am(mats, pids, ref, False)
    buf = np.zeros(len(sig) + C.FFTCP_AM, np.complex64)
    buf[C.FFTCP_AM // 2:C.FFTCP_AM // 2 + len(sig)] = sig
    return buf


@pytest.mark.parametrize("mode", ["fm", "am"])
def test_receiver_events_card_cpu(card, mode):
    """The receiver on the card (every kernel, K5's graphs, packed
    outputs) against the receiver on the CPU (the plain versions, which
    tests/test_torch_serve.py holds to the JAX receiver), on the streams
    and pushes of that file's relock twins: a clean station, and one whose
    gap trips LOST_SYNC and a relock by the cold start; depth 2.  The same
    events station by station, as tests/serve_events.py compares them
    (the MER within MER_DB dB).  Prints, per station and event type, how
    many events differ to the bit and their largest float difference: the
    cuBLAS GEMM sums the DFT in another order than the CPU's matmul."""
    from nrsc5_tpu_torch.serve import MultiStationReceiver

    from .serve_events import same_events
    rng = np.random.default_rng(80)
    if mode == "fm":
        good = _serve_fm(rng, "Clean Station", 12)
        pre, post = _serve_fm(rng, "Before Gap", 3), \
            _serve_fm(rng, "After Gap", 9)
        gappy, chunk = np.concatenate([pre[:len(pre) - 33333], post]), 250000
    else:
        good, pre, post = _serve_am(rng, 16), _serve_am(rng, 4), \
            _serve_am(rng, 12)
        gappy, chunk = np.concatenate([pre[:len(pre) - 7777], post]), 50000
    runs = []
    for dev in ("cpu", card):
        events = {0: [], 1: []}
        rx = MultiStationReceiver(2, lambda st, ev: events[st].append(ev),
                                  frames_per_dispatch=1, mode=mode,
                                  device=dev)
        for lo in range(0, max(len(good), len(gappy)), chunk):
            rx.push(0, good[lo:lo + chunk])
            rx.push(1, gappy[lo:lo + chunk])
        rx.flush()
        runs.append(events)
    # what differs to the bit, printed (``-rP``) before the comparison
    from .serve_events import ev_key
    apart = {}
    for st in runs[0]:
        for a, b in zip(runs[0][st], runs[1][st]):
            if ev_key(a)[1:] != ev_key(b)[1:]:
                d = apart.setdefault(f"{st}.{a.type.name}",
                                     {"events": 0, "max_diff": 0.0})
                d["events"] += 1
                d["max_diff"] = max([d["max_diff"]] + [
                    abs(a.payload[k] - b.payload[k]) for k in a.payload
                    if isinstance(a.payload[k], float)
                    and isinstance(b.payload.get(k), float)])
    print(json.dumps({"receiver_card_cpu": mode, "events": [
        len(runs[0][st]) for st in runs[0]], "apart_to_the_bit": apart}))
    same_events(*runs)
    kinds = [e.type.name for e in runs[1][1]]
    assert "LOST_SYNC" in kinds and "SYNC" in kinds
    assert sum(e.type.name == "HDC" for e in runs[1][0]) >= 128


def test_session_file_worker(card, tmp_path):
    """The session's worker thread drives the card: ``NRSC5.open_file(...)
    .start()`` on the golden capture (``chip_smoke.make_golden_capture``,
    support/make_capture.py's recipe) launches every kernel and captures
    K5's graph in its own thread, then ``flush``.  The same events as the
    same session on the CPU, each equal by tests/serve_events.py's key,
    and the MER floats within its MER_DB (the largest difference printed,
    ``-rP``).  At one station the loop's block-major outputs are copied out
    of K5's graph (``block_graph.station_major``): without that copy the
    MER of a dispatch was read after the next replay had overwritten its
    errors, 0.04-0.22 dB off the CPU's in the first frame
    (probes/session_mer_gap.py).  The golden title, the LOT file and all
    96 HDC packets, and every kernel of the path launched."""
    import chip_smoke
    from nrsc5_tpu_torch.api.session import NRSC5

    from .serve_events import MER_DB, key
    path = tmp_path / "golden.cu8"
    chip_smoke.make_golden_capture().tofile(path)
    runs = []
    for dev in ("cpu", card):
        events = []
        radio = NRSC5.open_file(str(path), events.append,
                                hdc_decoder_factory=None, device=dev)
        K.reset_counts()
        radio.start()
        radio._worker.join(timeout=600)
        assert not radio._worker.is_alive(), "worker thread hung"
        radio.flush()
        radio.close()
        runs.append({0: [e for e in events if e.type.name != "IQ"]})
    launched = {k for k, c in K.COUNTS.items() if c}
    assert launched == set(chip_smoke.SESSION_FM_KERNELS), launched
    want, got = runs[0][0], runs[1][0]
    assert [key(e)[0] for e in got] == [key(e)[0] for e in want]
    apart = [float(np.max(np.abs(np.subtract(key(g)[1], key(w)[1]))))
             for g, w in zip(got, want) if key(w)[1]]
    print(json.dumps({"session_mer_apart_db": apart}))
    assert max(apart) <= MER_DB
    assert sum(e.type.name == "SYNC" for e in got) == 1
    assert chip_smoke.GOLDEN_TITLE in {e.title for e in got
                                       if e.type.name == "ID3"}
    lots = [e for e in got if e.type.name == "LOT"]
    assert lots and bytes(lots[0].data) == chip_smoke.GOLDEN_LOT_DATA
    assert sum(e.type.name == "HDC" and not e.crc_error for e in got) == 96
    assert any(e.type.name == "LOST_DEVICE" for e in got)  # at EOF


# ---------------------------------------------------------------------------
# K17-K20: the complex chain's block step
# ---------------------------------------------------------------------------

def _spectra_close(got, want, tol):
    """Complex spectra [..., rows, n]: every row within ``tol`` of its
    largest magnitude (an FFT of its own against cuFFT: the same sums in
    another order).  Returns the largest such relative error."""
    scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    err = float(((got - want).abs() / scale).max())
    assert err <= tol, err
    return err


def _fm_stations_c(card, psmi=1, n_blocks=2):
    """Three FM stations at 25 dB (CFOs 0, +20, -35 Hz) as the complex
    chain's input [3, N] complex64 (unconjugated)."""
    rng = np.random.default_rng(40 + psmi)
    caps = [_capture(rng, psmi, 0, f, n_blocks=n_blocks)
            for f in (0.0, 20.0, -35.0)]
    x = np.stack([c[..., 0] - 1j * c[..., 1] for c in caps])
    return torch.from_numpy(x.astype(np.complex64)).to(card)


@pytest.mark.parametrize("s", [1, 3, 16])
def test_fm_demod_c(card, s):
    """K17 against its plain version (``_demod`` through ``torch.fft``) at
    1, 3 and 16 stations of noise with moved states: offsets inside, past
    the end (clamped) and negative, samperr feedback -20..+20 (the slice's
    clamp), CFOs -38..+38 bins (negative ones through the floor mod),
    angles and phasors at random.  Spectra within 2e-5 of each row's
    largest magnitude, phase_out within 1e-5, keep exact; one launch.
    Prints the spectra's largest relative error (``-rP``)."""
    from nrsc5_tpu_torch.ops import acquire as TA
    g = torch.Generator().manual_seed(170 + s)
    n = TA.WINDOW_FM + 3000
    x = torch.view_as_complex(torch.randn(s, n, 2, generator=g)).to(card)
    ang = 2 * math.pi * torch.rand(s, generator=g)
    offset = torch.randint(-4000, 4000, (s,), generator=g, dtype=torch.int32)
    offset[0] = 0
    args = (x, offset.to(card), torch.polar(torch.ones(s), ang).to(card),
            (C.FFTCP_FM // 2 + torch.randint(-20, 21, (s,), generator=g,
                                             dtype=torch.int32)).to(card),
            (0.2 * torch.randn(s, generator=g)).to(card),
            torch.randint(-38, 39, (s,), generator=g,
                          dtype=torch.int32).to(card))
    before = K.COUNTS["fm_demod_c"]
    got = TA.demod_fm_c(*args)
    assert K.COUNTS["fm_demod_c"] == before + 1
    want = TA.demod_fm_c_plain(*args)
    err = _spectra_close(got[0], want[0], 2e-5)
    _close(torch.view_as_real(got[1]), torch.view_as_real(want[1]), 1e-5)
    assert torch.equal(got[2], want[2])
    print(json.dumps({"fm_demod_c_rel_err": err, "stations": s}))
    with pytest.raises(ValueError):
        TA.demod_fm_c(torch.view_as_real(x), *args[1:])


def _sync_fm_c_args(card, psmi):
    """Block 1 of three stations' complex chains (block 0 through the
    plain versions), K18's inputs: the spectra K17 makes, the Costas
    state block 0 left, timing_adj moved by 0, +2 and -3 samples."""
    from nrsc5_tpu_torch.ops import acquire as TA
    from nrsc5_tpu_torch.pipeline import scan_chain as sc
    x = _fm_stations_c(card, psmi, n_blocks=3)
    carries = sc.stack_trees([sc.chain_init_carry(device=card)] * 3)
    _, _, _, cy = sc.scan_blocks_c(x, carries, 1, psmi, plain=True)
    samperr = C.FFTCP_FM // 2 + cy.samperr_fb + torch.tensor(
        [0, 2, -3], dtype=torch.int32, device=card)
    spectra = TA.demod_fm_c_plain(
        x, cy.offset, cy.acq.phase, samperr, cy.acq.prev_angle - cy.angle_fb,
        torch.zeros(3, dtype=torch.int32, device=card))[0]
    return (spectra, cy.sync.costas_phase, cy.sync.costas_freq, psmi,
            (C.FFTCP_FM // 2 - samperr).to(torch.int32))


@pytest.mark.parametrize("psmi", [1, 2, 3, 5, 11])
def test_sync_fm_c(card, psmi):
    """K18 against ``sync_fm_block`` for each station, at block 1 of three
    stations' chains: ref_ok, ref_bc, ref_psmi and samperr exact, the int8
    soft bits within ±1 on at most 0.1 % (a product on a .5 edge: PyTorch's
    reductions and complex kernels round apart from the kernel's ordered
    sums), the floats within 1e-5 of their largest value (at least 1); one
    launch."""
    from nrsc5_tpu_torch.ops import sync_fm as TS
    args = _sync_fm_c_args(card, psmi)
    before = K.COUNTS["sync_fm_c"]
    got = TS.sync_fm_c(*args)
    assert K.COUNTS["sync_fm_c"] == before + 1
    _sync_check(*got, *TS.sync_fm_c_plain(*args))


def test_sync_fm_c_carry(card):
    """K18's carry step against the plain version's
    (``block_carry_plain`` after the block): the integer fields and
    prev_angle (a copy of the block's angle) exact, angle_fb and the next
    angle (the block's mean Costas frequency, K18's float32 against
    PyTorch's reduction) within 1e-5."""
    from nrsc5_tpu_torch.ops import sync_fm as TS
    from nrsc5_tpu_torch.pipeline.block_graph import FM_STATE
    args = _sync_fm_c_args(card, 1)
    g = torch.Generator().manual_seed(18)

    def state():
        st = {k: torch.randint(-50, 50, (3,), generator=g,
                               dtype=torch.int32).to(card)
              for k in FM_STATE if "angle" not in k}
        st.update({k: torch.rand(3, generator=g).to(card)
                   for k in FM_STATE if "angle" in k})
        st["keep"] = torch.full((3,), 2160, dtype=torch.int32, device=card)
        return st
    a = state()
    b = {k: v.clone() for k, v in a.items()}
    TS.sync_fm_c(*args, carry=a)
    TS.sync_fm_c_plain(*args, carry=b)
    for k in FM_STATE:
        if k in ("angle_fb", "angle"):
            _close(a[k], b[k], 1e-5)
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("s", [1, 3, 16])
def test_am_demod_c(card, s):
    """K19 against its plain version (``_am_process`` through
    ``torch.fft``, both passes) at 1, 3 and 16 stations: the first three
    real MA1 stations, the rest noise; offsets, samperr -4..+4 around the
    steady 135, CFOs -2..+2 bins, phasors and angles at random.  Spectra
    within 2e-5 of each row's largest magnitude on the MA1 stations; on
    the noise stations within 1e-4 (the complex chain's twins' float
    tolerance): pass 2 runs at the pilot fit's phase and angle, and the fit
    on a pilot of noise (an atan2 a symbol, their running sum) carries the
    two FFTs' float rounding into every pass-2 value.  The magnitude sums
    (pass 1) within 2e-5 of their largest, phase_out and prev_angle_out
    within 1e-5 (1e-4 on noise), keep exact; one launch."""
    from nrsc5_tpu_torch.ops import acquire as TA
    x, _ = _am_stations(card)
    x = torch.view_as_complex(x.contiguous())
    g = torch.Generator().manual_seed(190 + s)
    if s > 3:
        noise = torch.randn(s - 3, x.shape[1], 2, generator=g) * 0.05
        x = torch.cat([x, torch.view_as_complex(noise).to(card)])
    x = x[:s].contiguous()
    ang = 2 * math.pi * torch.rand(s, generator=g)
    args = (x, torch.randint(-300, 300, (s,), generator=g,
                             dtype=torch.int32).to(card),
            torch.polar(torch.ones(s), ang).to(card),
            (C.FFTCP_AM // 2 + torch.randint(-4, 5, (s,), generator=g,
                                             dtype=torch.int32)).to(card),
            (0.02 * torch.randn(s, generator=g)).to(card),
            torch.randint(-2, 3, (s,), generator=g,
                          dtype=torch.int32).to(card))
    before = K.COUNTS["am_demod_c"]
    got = TA.demod_am_c(*args)
    assert K.COUNTS["am_demod_c"] == before + 1
    want = TA.demod_am_c_plain(*args)
    real = slice(0, min(s, 3))
    err = _spectra_close(got[0][real], want[0][real], 2e-5)
    _close(got[1], want[1], 2e-5)
    _close(torch.view_as_real(got[2][real]),
           torch.view_as_real(want[2][real]), 1e-5)
    _close(got[3][real], want[3][real], 1e-5)
    noise_err = None
    if s > 3:
        noise_err = _spectra_close(got[0][3:], want[0][3:], 1e-4)
        _close(torch.view_as_real(got[2][3:]),
               torch.view_as_real(want[2][3:]), 1e-4)
        _close(got[3][3:], want[3][3:], 1e-4)
    assert torch.equal(got[4], want[4])
    print(json.dumps({"am_demod_c_rel_err": err,
                      "noise_rel_err": noise_err, "stations": s}))


@pytest.mark.parametrize("ma3", [False, True])
@pytest.mark.parametrize("s", [1, 3, 17])
def test_sync_am_c(card, s, ma3):
    """K20 against ``sync_am_block`` for each station: on the spectra of
    three stations' first block at 35 dB (K19's plain version), and at 17
    stations those and random spectra.  Every output exact: codes, PIDS
    codes, reference bits and samperr; one launch."""
    from nrsc5_tpu_torch.ops import acquire as TA
    from nrsc5_tpu_torch.ops import sync_am as TSA
    x, cy = _am_stations(card, ma3)
    x = torch.view_as_complex(x.contiguous())
    zero = torch.zeros(3, dtype=torch.int32, device=card)
    spectra = TA.demod_am_c_plain(
        x, cy.offset, torch.ones(3, dtype=torch.complex64, device=card),
        zero + C.FFTCP_AM // 2, cy.prev_angle, zero)[0]
    if s > 3:
        g = torch.Generator().manual_seed(200 + s)
        noise = torch.randn(s - 3, C.BLKSZ, C.FFT_AM, 2, generator=g)
        spectra = torch.cat([spectra, torch.view_as_complex(noise).to(card)])
    spectra = spectra[:s].contiguous()
    before = K.COUNTS["sync_am_c"]
    got = TSA.sync_am_c(spectra, ma3)
    assert K.COUNTS["sync_am_c"] == before + 1
    want = TSA.sync_am_c_plain(spectra, ma3)
    for k in ("codes", "pids", "ref_bits", "samperr"):
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
