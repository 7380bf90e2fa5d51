"""K14's coarse timing (``am_coarse``) and integer-CFO step
(``am_cfo_step``, csrc/am_coldstart.cu) as their kernels split the work,
held on the CPU to the port's plain versions.  The kernels run only on a
card (tests/test_torch_kernels.py); here what each does differently from
its plain version is checked:

- ``am_coarse`` runs a cluster of 8 CTAs a station.  CTA r owns the timing
  lanes [270 r / 8, 270 (r + 1) / 8) and computes the tone-subtracted
  window only at the positions 270 p + lo - 14 + j of its runs (p < 33,
  j < lanes + 14, less the first period's first 14 items and the last
  period's last 14): every position its lanes read lies there, inside the
  window.  Each lane's products are summed in symbol order by one thread
  (real and imaginary parts apart), the leader forms the 14-tap circular
  window, takes the first argmax by its bits (the largest value, then the
  least index that holds it) and the scalar steps.  A torch model of that
  split equals ``am_coarse_plain`` bit for bit in all four outputs, at 1,
  3 and 17 stations, windows at odd, negative and clamped offsets, the
  latch -1, in range and past 270, prev_angle zero and nonzero, and ties.
- ``am_cfo_step`` gives each bin four threads of 8 symbols; the first sums
  its magnitudes, then the other three's from shared memory, in symbol
  order.  A model of that layout (every (symbol, bin) loaded once, threads
  past the 107 bins clamped to the last) equals ``am_cfo_step_plain``,
  ties between bins included.

Inputs are made with numpy from seeds.  Torch runs on one thread.
"""

import numpy as np
import pytest
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import acquire_am_rc as AA
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops.acquire_rc import _shape_kernel

FFTCP, CP, NSYM = C.FFTCP_AM, C.CP_AM, C.ACQUIRE_SYMBOLS
PERIODS = NSYM + 1
CTAS = 8  # am_coarse's cluster a station
W = -(-FFTCP // CTAS) + CP  # 48: a CTA's run of one period
SPLIT, ROWS = 4, NSYM // 4  # am_cfo_step: threads a bin, symbols each
CFO_T = 128  # am_cfo_step's bins a thread row (107 used)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(r):
    lo = r * FFTCP // CTAS
    return lo, (r + 1) * FFTCP // CTAS - lo


def _item_read(p, j, lanes):
    """The kernel's coarse_item_read."""
    return j < lanes + CP and (p > 0 or j >= CP) and (p < NSYM or j < lanes)


def _run_positions(r):
    """{(p, j): window position} of the items CTA r computes."""
    lo, lanes = _lanes(r)
    return {(p, j): FFTCP * p + lo - CP + j
            for p in range(PERIODS) for j in range(W)
            if _item_read(p, j, lanes)}


def first_argmax(values):
    """The kernels' first argmax over [..., n] values >= 0: the largest
    float32 bit pattern, then the least index holding it."""
    bits = values.contiguous().view(torch.int32)
    top = bits.max(dim=-1, keepdim=True).values
    idx = torch.arange(values.shape[-1]).expand_as(bits)
    return torch.where(bits == top, idx, values.shape[-1]).min(dim=-1).values


def coarse_model(samples, offset, f, amp, prev_angle, override):
    """am_coarse as its kernel computes it: the runs of each CTA, each
    lane's ordered sums from them, the leader's window, argmax and steps.
    Items a CTA does not compute hold NaN, so a read outside the runs
    shows in every output."""
    s = samples.shape[0]
    # x at a position depends only on the position: the plain version's own
    # expressions over the whole window give each CTA's values
    x = AA.tone_subtract(AA.am_window(samples, offset), f, amp)
    sums = torch.full((s, FFTCP, 2), float("nan"))
    for r in range(CTAS):
        lo, lanes = _lanes(r)
        run = torch.full((s, PERIODS, W, 2), float("nan"))
        for (p, j), n in _run_positions(r).items():
            run[:, p, j] = x[:, n]
        a = run[:, :NSYM, CP:CP + lanes]
        b = run[:, 1:, :lanes]
        terms = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1],
                 a[..., 1] * b[..., 0] - a[..., 0] * b[..., 1])
        for part, t in enumerate(terms):
            acc = t[:, 0]
            for k in range(1, NSYM):
                acc = acc + t[:, k]
            sums[:, lo:lo + lanes, part] = acc
    kern = _shape_kernel(C.FFT_AM, CP)
    v = None
    for j in range(CP):
        t = torch.roll(sums, -j, dims=1) * float(kern[j])
        v = t if v is None else v + t
    measured = first_argmax(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
    v_max = v[torch.arange(s), measured]
    ov = override.long()
    samperr = torch.where(ov >= 0, ov % FFTCP, measured).to(torch.int32)
    q = rc.mul(v_max, rc.exp_i(-prev_angle))
    diff = torch.atan2(q[:, 1], q[:, 0])
    pa = prev_angle + diff * torch.where(prev_angle != 0, 0.25, 1.0)
    return measured.to(torch.int32), samperr, pa, v_max


def cfo_model(spectra1):
    """am_cfo_step as its kernel computes it: thread (bin b, part h) of
    CFO_T x SPLIT loads symbols h ROWS ... of bin min(b, 106), the first
    part's thread sums its magnitudes and then the others' in symbol
    order; the first argmax by bits."""
    s = spectra1.shape[0]
    loaded = torch.zeros(s, NSYM, AA.CFO_BINS, dtype=torch.int32)
    mags = torch.empty(s, AA.CFO_BINS)
    for b in range(CFO_T):
        col = AA.CFO_LO + min(b, AA.CFO_BINS - 1)
        parts = []
        for h in range(SPLIT):
            rows = spectra1[:, h * ROWS:(h + 1) * ROWS, col]
            parts.append(torch.sqrt(rc.abs2(rows)))
            if b < AA.CFO_BINS:
                loaded[:, h * ROWS:(h + 1) * ROWS, b] += 1
        if b < AA.CFO_BINS:
            m = torch.cat(parts, dim=1)
            acc = m[:, 0]
            for k in range(1, NSYM):
                acc = acc + m[:, k]
            mags[:, b] = acc
    assert bool((loaded == 1).all())  # each (symbol, bin) once
    step = first_argmax(mags) + (AA.CFO_LO - C.CENTER_AM)
    return step.to(torch.int32), mags


def _bits_equal(a, b):
    if a.dtype.is_floating_point:
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


def _tones(rng, s, n):
    """``s`` stations of rc samples [s, n, 2]: a carrier in ±100 bins in
    white noise."""
    t = np.arange(n)
    f = rng.uniform(-100, 100, s) / C.FFT_AM
    x = rng.uniform(0.5, 2.0, s)[:, None] * np.exp(
        2j * np.pi * (f[:, None] * t + rng.uniform(0, 1, s)[:, None])) \
        + 0.3 * (rng.standard_normal((s, n)) + 1j * rng.standard_normal((s, n)))
    return torch.from_numpy(np.stack([x.real, x.imag], -1).astype(np.float32))


# ---------------------------------------------------------------------------
# am_coarse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", range(CTAS))
def test_coarse_runs_hold_every_read(r):
    """CTA r's runs hold every position its lanes' 32-term sums read (the
    symbol's first sample and its cyclic-prefix partner 256 later), lie
    inside the window, and are at most 1.41x its share of the window."""
    lo, lanes = _lanes(r)
    pos = _run_positions(r)
    held = set(pos.values())
    assert 0 <= min(held) and max(held) < AA.WINDOW_AM
    for t in range(lo, lo + lanes):
        for k in range(NSYM):
            assert FFTCP * k + t in held
            assert C.FFT_AM + FFTCP * k + t in held
            # where the lane finds them in the run
            assert pos[(k, t - lo + CP)] == FFTCP * k + t
            assert pos[(k + 1, t - lo)] == C.FFT_AM + FFTCP * k + t
    assert len(held) == len(pos)  # one item a position
    assert len(pos) <= 1.41 * AA.WINDOW_AM / CTAS


def _coarse_case(case):
    rng = np.random.default_rng(140)
    n = 12000
    if case == "one":
        x = _tones(rng, 1, n)
        offset = torch.tensor([1233], dtype=torch.int32)
        pa = torch.tensor([0.0])
        ov = torch.tensor([-1], dtype=torch.int32)
    elif case == "three_edges":
        x = _tones(rng, 3, n)
        # clamped at the end, counted from the end (odd), odd
        offset = torch.tensor([n + 5, -5001, 77], dtype=torch.int32)
        pa = torch.tensor([0.0, 1.3, -2.9])
        ov = torch.tensor([-1, 270, 541], dtype=torch.int32)
    elif case == "seventeen":
        x = _tones(rng, 17, n)
        offset = torch.from_numpy(rng.integers(-n, n + 100, 17).astype(
            np.int32))
        pa = torch.from_numpy(np.where(np.arange(17) % 2 == 0, 0.0,
                                       rng.uniform(-3, 3, 17)).astype(
                                           np.float32))
        ov = torch.from_numpy(rng.choice([-1, 5, 269, 270, 1000],
                                         17).astype(np.int32))
    elif case == "ties":
        # station 0: an all-zero window (every timing ties at 0); station 1:
        # the same products on lanes 100 and 200 only (CTAs 2 and 5), so
        # the window's peaks tie 100 apart and the first wins
        x = torch.zeros(2, n, 2)
        for t in (100, 200):
            for k in range(NSYM):
                x[1, FFTCP * k + t] = torch.tensor([0.5, 0.25])
                x[1, C.FFT_AM + FFTCP * k + t] = torch.tensor([0.75, -0.5])
        offset = torch.zeros(2, dtype=torch.int32)
        pa = torch.tensor([0.0, 0.4])
        ov = torch.tensor([-1, -1], dtype=torch.int32)
        return x, offset, torch.zeros(2), torch.zeros(2, 2), pa, ov
    s = x.shape[0]
    f, amp = AA.am_tone_plain(rc.dft(AA.tone_symbols(x, offset)), x, offset)
    return x, offset, f, amp, pa, ov


@pytest.mark.parametrize("case", ["one", "three_edges", "seventeen", "ties"])
def test_coarse_model_matches_plain(case):
    """The kernel's split of am_coarse equals am_coarse_plain bit for bit:
    measured, samperr, prev_angle and v."""
    args = _coarse_case(case)
    got = coarse_model(*args)
    want = AA.am_coarse_plain(*args)
    for a, b in zip(got, want):
        assert _bits_equal(a, b), (case, a, b)
    if case == "ties":
        m = got[0].tolist()
        assert m[0] == 0
        assert m[1] < 100  # the peak of lane 100's window, not lane 200's


def test_first_argmax_is_torch_argmax():
    """The kernels' argmax by bits is torch's first argmax over values >=
    0: zeros, repeated maxima in one warp and across warps, a lone
    maximum at the last index."""
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.random((6, 270)).astype(np.float32))
    v[0] = 0.0
    v[1, [5, 40, 41, 263]] = 2.0
    v[2, [31, 32]] = 3.0
    v[3, 269] = 9.0
    v[4] = torch.from_numpy(rng.integers(0, 3, 270).astype(np.float32))
    assert torch.equal(first_argmax(v), torch.argmax(v, dim=1))


# ---------------------------------------------------------------------------
# am_cfo_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 3, 17])
def test_cfo_model_matches_plain(s):
    """The kernel's four threads a bin equal am_cfo_step_plain: the 107
    magnitude sums bit for bit and the step."""
    rng = np.random.default_rng(150 + s)
    spectra1 = torch.from_numpy(rng.standard_normal(
        (s, NSYM, C.FFT_AM, 2)).astype(np.float32))
    got, want = cfo_model(spectra1), AA.am_cfo_step_plain(spectra1)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)


def test_cfo_model_tie():
    """Two bins with the same magnitudes, the strongest: the first wins,
    in the model as in the plain version; and a band of zeros steps to
    the first bin."""
    rng = np.random.default_rng(160)
    spectra1 = torch.from_numpy(rng.standard_normal(
        (2, NSYM, C.FFT_AM, 2)).astype(np.float32))
    lo = AA.CFO_LO
    spectra1[0, :, lo + 90] = 4 * spectra1[0, :, lo + 7]
    spectra1[0, :, lo + 7] = spectra1[0, :, lo + 90]
    spectra1[1] = 0.0
    got, want = cfo_model(spectra1), AA.am_cfo_step_plain(spectra1)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    assert got[0].tolist() == [7 + lo - C.CENTER_AM, lo - C.CENTER_AM]
