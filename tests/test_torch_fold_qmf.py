"""K12 (the AM fold, csrc/am_fold.cu) and K16a (audio's window, overlap-add
and QMF analysis, csrc/aac_window_qmf_analysis.cu) as their kernels
compute them, held on the CPU to the port's plain versions.  The kernels
run only on a card (tests/test_torch_kernels.py); here what each does
differently from before is checked:

- K12 writes its fold already rounded to bfloat16, the DFT's operand, so
  the AM block loop's DFT is the float32 matmul alone
  (``rcplx.dft_rounded_into``).  ``am_fold_plain`` rounds the same way:
  its outputs are bfloat16 values in both passes, the rounding of its
  unrounded fold; the matmul alone on them gives, bit for bit, the
  spectra of ``rcplx.dft`` (round, then matmul) on the unrounded fold; and
  ``scan_blocks_am`` on the plain path gives the codes, PIDS codes and
  carry of the loop before the change (the unrounded fold, then the DFT
  that rounds), MA1 and MA3.
- K16a sums each output over a thread's register tile (4 slots 8 apart x
  4 real and 4 imaginary columns, 64 threads an item, 4 items a CTA) on a
  persistent grid, from ext rows of 36 floats for every 32 samples, read 4
  taps at a time.  A torch model of that split, with every padding cell
  NaN, equals ``window_qmf_analysis_plain`` bit for bit, and writes every
  output once: K = 1 and 8 packets, 1, 3 and 129 lanes, all-long,
  all-short and mixed windows, across packet and lane edges.

Inputs are made with numpy from seeds.  Torch runs on one thread.
"""

import numpy as np
import pytest
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.audio import stage as AST
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx import encoder_am as EAM
from nrsc5_tpu_torch.tx.modulator_am import modulate_am


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _bit_equal(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# K12: the fold rounded to bfloat16
# ---------------------------------------------------------------------------

def _am_buffer(rng, ma3, n_frames, cfo_hz):
    """One AM station's frame-aligned rc chain input at 35 dB."""
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
                    snr_db=35.0, sample_rate=C.SAMPLE_RATE_CS16_AM, rng=rng)
    buf = np.zeros((scar.am_buffer_len(n_frames), 2), np.float32)
    start = C.FFTCP_AM // 2
    buf[start:start + len(sig)] = np.stack([sig.real, sig.imag], -1)
    return buf


@pytest.fixture(scope="module")
def am_inputs():
    """Two MA1 stations (CFOs +7 and -9 Hz), one frame, and MA3 alike."""
    out = {}
    for ma3 in (False, True):
        rng = np.random.default_rng(1300 + ma3)
        out[ma3] = torch.from_numpy(np.stack(
            [_am_buffer(rng, ma3, 1, f) for f in (7.0, -9.0)]))
    return out


def _fold_args(x, case):
    """K12's arguments: a fresh carry, or the state moved (offsets,
    phasors, samperr feedback, CFOs and small angles)."""
    cy = scar.am_chain_rc_init_carry(n_stations=x.shape[0], device="cpu")
    args = [x, cy.offset, cy.phase, cy.samperr_fb, cy.prev_angle, cy.cfo]
    if case == "moved":
        ang = torch.tensor([0.3, -1.2])
        args[1:] = [torch.tensor([300, 20], dtype=torch.int32),
                    torch.stack([torch.cos(ang), torch.sin(ang)], -1),
                    torch.tensor([3, -2], dtype=torch.int32),
                    torch.tensor([0.004, -0.01]),
                    torch.tensor([1, -1], dtype=torch.int32)]
    return args


@pytest.mark.parametrize("n_pass", [1, 2])
@pytest.mark.parametrize("case", ["fresh", "moved"])
def test_fold_plain_is_bf16(am_inputs, case, n_pass):
    """``am_fold_plain``'s fold holds bfloat16 values only, the rounding of
    its unrounded fold; pass 2's other outputs do not depend on it."""
    args = _fold_args(am_inputs[False], case)
    extra = ()
    if n_pass == 2:
        extra = (rc.dft(scar.am_fold_plain(*args), shift=True),)
    got = scar.am_fold_plain(*args, *extra)
    raw = scar.am_fold_plain(*args, *extra, unrounded=True)
    fold, fold_raw = (got, raw) if n_pass == 1 else (got[0], raw[0])
    assert _bit_equal(fold, rc.round_bf16(fold))
    assert _bit_equal(fold, rc.round_bf16(fold_raw))
    assert not torch.equal(fold, fold_raw)  # the rounding did something
    if n_pass == 2:
        for a, b in zip(got[1:], raw[1:]):
            assert _bit_equal(a, b)


@pytest.mark.parametrize("n_pass", [1, 2])
def test_matmul_dft_on_rounded_fold(am_inputs, n_pass):
    """The loop's DFT (the matmul alone) on the rounded fold equals
    ``rcplx.dft`` of the unrounded fold, which rounds first: bit for
    bit."""
    args = _fold_args(am_inputs[False], "moved")
    extra = ()
    if n_pass == 2:
        extra = (rc.dft(scar.am_fold_plain(*args, unrounded=True),
                        shift=True),)
    fold = scar.am_fold_plain(*args, *extra)
    raw = scar.am_fold_plain(*args, *extra, unrounded=True)
    if n_pass == 2:
        fold, raw = fold[0], raw[0]
    got = rc.dft_rounded_into(fold.clone(), torch.empty_like(fold),
                              shift=True)
    assert _bit_equal(got, rc.dft(raw, shift=True))


def _parent_acquire(samples, offset, phase, samperr_fb, prev_angle, cfo,
                    plain=False, out=None, scratch=None):
    """The block loop's acquire before K12 rounded its fold: the unrounded
    fold, then a DFT that rounds its operand through a bf16 scratch."""
    spectra, phase_out, prev_angle_out, keep = out
    args = (samples, offset, phase, samperr_fb, prev_angle, cfo)
    work = torch.empty_like(spectra)
    spectra1 = torch.empty_like(spectra)
    rounded = torch.empty_like(spectra, dtype=torch.bfloat16)
    work.copy_(scar.am_fold_plain(*args, unrounded=True))
    rc.dft_into(work, spectra1, rounded, shift=True)
    res = scar.am_fold_plain(*args, spectra1, unrounded=True)
    work.copy_(res[0])
    for dst, src in zip((phase_out, prev_angle_out, keep), res[1:]):
        dst.copy_(src)
    rc.dft_into(work, spectra, rounded, shift=True)
    return out


@pytest.mark.parametrize("ma3", [False, True], ids=["ma1", "ma3"])
def test_scan_blocks_am_as_parent(am_inputs, ma3, monkeypatch):
    """``scan_blocks_am`` on the plain path over 4 blocks gives the codes,
    PIDS codes and loop carry of the loop before the change."""
    x = am_inputs[ma3]
    carry = scar.am_chain_rc_init_carry(n_stations=x.shape[0], device="cpu")
    got = scar.scan_blocks_am(x, carry, 4, ma3, plain=True)
    monkeypatch.setattr(scar, "acquire_am_fine_rc", _parent_acquire)
    want = scar.scan_blocks_am(x, carry, 4, ma3, plain=True)
    for k in ("codes", "pids"):
        assert torch.equal(got[k], want[k]), k
    for k, v in want["carry"].items():
        assert _bit_equal(got["carry"][k], v), k


# ---------------------------------------------------------------------------
# K16a: a model of the kernel's work split
# ---------------------------------------------------------------------------

TS, TC = 4, 4                 # slots a thread, columns a half
SLOT_GROUPS, COL_GROUPS = 8, 8
ITEM_THREADS = SLOT_GROUPS * COL_GROUPS  # 64
ITEMS = 4                     # items a CTA
EXT = 32 * AST.NSLOT + AST.QA_HIST     # 1312


def _padded(e):
    return e + 4 * (e >> 5)


EXT_ROW = _padded(EXT - 1) + 1  # 1472


def _k16a_inputs(lanes, kp, windows, seed):
    rng = np.random.default_rng(seed)

    def f32(*shape, lo=-1.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape)
                                .astype(np.float32))

    if windows == "long":
        short = np.zeros((lanes, kp), bool)
    elif windows == "short":
        short = np.ones((lanes, kp), bool)
    else:
        short = rng.integers(0, 2, (lanes, kp)).astype(bool)
    return (f32(lanes, kp, 2048), f32(lanes, kp, 8, 256),
            torch.from_numpy(rng.integers(0, 13, (lanes, kp))
                             .astype(np.uint8)),
            torch.from_numpy(rng.integers(0, 5, (lanes, kp))
                             .astype(np.uint8)),
            torch.from_numpy(short), f32(lanes, 1024), f32(lanes, 288),
            f32(13, 2048, lo=0.0), f32(5, 8, 256, lo=0.0), f32(320, 64))


def _windowed(long_raw, short_raw, wl, ws, is_short, lut_long, lut_short,
              n, kk, t):
    """The kernel's ``windowed``: samples t (int64 tensor) of packets
    (n, kk) (tensors of t's shape), long by one product, short as the
    windows covering each sample added in window order onto 0."""
    lng = long_raw[n, kk, t] * lut_long[wl[n, kk].long(), t]
    d = t - 448
    inside = (d >= 0) & (d < 128 * 7 + 256)
    w_hi = torch.clamp(d >> 7, max=7)
    w_lo = torch.where(d >= 256, ((d - 256) >> 7) + 1, 0)
    acc = torch.zeros(t.shape)
    for w in range(8):
        use = inside & (w >= w_lo) & (w <= w_hi)
        u = torch.clamp(d - 128 * w, 0, 255)
        term = short_raw[n, kk, w, u] * lut_short[ws[n, kk].long(), w, u]
        acc = torch.where(use, acc + term, acc)
    return torch.where(is_short[n, kk], acc, lng)


def _k16a_model(args, grid):
    """K16a as the kernel splits it: CTA b of ``grid`` takes groups b, b +
    grid, ...; item q = 4 group + j is (lane q // K, packet q % K); its
    padded ext row (NaN between samples) is built per sample; thread r
    of the item sums slots sg + 8 i and columns 4 cg + c, 32 + 4 cg + c
    over the taps in order, reading x[36 (s + t) + 4 u4 + uu] at tap 32 t
    + 4 u4 + uu (the 16-byte load at 36 (s + t) + 4 u4 holds 4 taps).
    Returns (xl, new_overlap, new_qa) and how often each xl entry was
    written."""
    (long_raw, short_raw, wl, ws, is_short, overlap, qa_hist, lut_long,
     lut_short, ka) = args
    lanes, kp = long_raw.shape[:2]
    n_items = lanes * kp
    n_groups = -(-n_items // ITEMS)
    win = (long_raw, short_raw, wl, ws, is_short, lut_long, lut_short)

    # the items in the order the CTAs take them
    items = [grp * ITEMS + j for b in range(grid)
             for grp in range(b, n_groups, grid) for j in range(ITEMS)
             if grp * ITEMS + j < n_items]
    q = torch.tensor(items)
    n, k = q // kp, q % kp

    # ext rows: sample 1024 k + e of [qa_hist | core], e < 1312
    e = torch.arange(EXT)[None].expand(len(items), -1)
    nn, kk_item = n[:, None].expand_as(e), k[:, None].expand_as(e)
    hist = (kk_item == 0) & (e < AST.QA_HIST)
    c = torch.clamp(1024 * kk_item + e - AST.QA_HIST, min=0)
    kk, i = c >> 10, c & 1023
    head = _windowed(*win, nn, kk, i)
    tail = torch.where(kk == 0, overlap[nn, i],
                       _windowed(*win, nn, torch.clamp(kk - 1, min=0),
                                 1024 + i))
    vals = torch.where(hist, qa_hist[nn, torch.clamp(e, max=287)],
                       head + tail)
    rows = torch.full((len(items), EXT_ROW), float("nan"))
    rows.scatter_(1, _padded(e), vals)

    # every thread's tile: [item, sg, i] x [cg, half, c]
    sg = torch.arange(SLOT_GROUPS)[:, None]
    slot = sg + SLOT_GROUPS * torch.arange(TS)[None]         # [8, 4]
    col = (TC * torch.arange(COL_GROUPS)[:, None, None]
           + 32 * torch.arange(2)[None, :, None]
           + torch.arange(TC)[None, None])                    # [8, 2, 4]
    acc = None
    for tau in range(320):
        t, u = divmod(tau, 32)
        u4, uu = divmod(u, 4)
        x4 = rows[:, (36 * (slot + t) + 4 * u4)[..., None]
                  + torch.arange(4)]                          # [I, 8, 4, 4]
        x = x4[..., uu]
        prod = x[..., None, None, None] * ka[tau, col]
        acc = prod if acc is None else acc + prod

    xl = torch.full((lanes, kp * AST.NSLOT, 64), float("nan"))
    written = torch.zeros(xl.shape, dtype=torch.int32)
    row_idx = (k[:, None, None] * AST.NSLOT + slot[None])    # [I, 8, 4]
    shape = acc.shape                                         # I,8,4,8,2,4
    ni = n[:, None, None, None, None, None].expand(shape)
    ri = row_idx[..., None, None, None].expand(shape)
    ci = col[None, None, None].expand(shape)
    xl[ni, ri, ci] = acc
    written.index_put_((ni.flatten(), ri.flatten(), ci.flatten()),
                       torch.ones(acc.numel(), dtype=torch.int32),
                       accumulate=True)

    last = k == kp - 1
    t_hi = 1024 + torch.arange(1024)[None].expand(int(last.sum()), -1)
    n_last = n[last][:, None].expand_as(t_hi)
    new_overlap = torch.empty(lanes, 1024)
    new_overlap[n[last]] = _windowed(*win, n_last,
                                     torch.full_like(t_hi, kp - 1), t_hi)
    new_qa = torch.empty(lanes, AST.QA_HIST)
    new_qa[n[last]] = rows[last][:, _padded(1024 + torch.arange(288))]
    return (xl, new_overlap, new_qa), written


@pytest.mark.parametrize("kp,lanes,windows", [
    (1, 1, "long"), (1, 3, "short"), (1, 129, "mixed"), (8, 1, "short"),
    (8, 3, "mixed"), (8, 3, "long")])
def test_k16a_model(kp, lanes, windows):
    """The model of K16a's work split (a grid of 3 CTAs, so that CTAs
    loop over groups and the last group is partial where 4 does not
    divide the items) equals the plain version bit for bit, and writes
    each output once."""
    args = _k16a_inputs(lanes, kp, windows, seed=160 + 10 * kp + lanes)
    want = AST.window_qmf_analysis_plain(*args)
    got, written = _k16a_model(args, grid=3)
    assert torch.equal(written, torch.ones_like(written))
    for a, b in zip(got, want):
        assert _bit_equal(a, b)
