"""K14's tone estimate (``am_tone``, csrc/am_coldstart.cu) and K13 (the AM
sync block, csrc/sync_am_block.cu) as their kernels compute them, held on
the CPU to the port's plain versions.  The kernels run only on a card
(tests/test_torch_kernels.py); here what each does differently from its
plain version is checked:

- ``am_tone`` reads its phases from two cached tables, the grid's
  twiddles float32 [85, 8910, 2] and the integer derotation's 256
  phasors, indexed by (k0 n) mod 256 as C's remainder gives it (then
  +256 where negative).  Both equal, bit for bit, the phases
  ``am_tone_plain`` computes itself, for k0 across [-128, 127].
- Its 256-lane pairwise tree runs as three levels that cross the
  cluster's CTAs (lane l of CTA j holding lane 32 j + l) and then five
  warp shuffles: bit-equal to ``fixed_sum``'s tree.
- A torch model of the three kernels (z from the table, 35-row lane sums
  in order, the tree, the parabola, two Newton steps and the amplitude
  through the same decomposition) equals ``am_tone_plain`` bit for bit.
- K13's plan (``sync_am_plan``): the bins each of a station's four CTAs
  loads are exactly the bins ``sync_am_block_rc_plain``'s outputs depend
  on, MA1 and MA3 (every partition bin, both PIDS columns, bin C+1 and
  in MA1 the mirrors); each CTA's bins are at most two contiguous runs a
  row; every extra (a PIDS column, the reference bits, samperr) lies on
  one CTA; and the plain version on spectra zeroed outside the plan gives
  the outputs of the full spectra.

Inputs are made with numpy from seeds.  Torch runs on one thread.
"""

import math

import numpy as np
import pytest
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import acquire_am_rc as AA
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops import sync_am as SA
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar

WIN = AA.WINDOW_AM
ROWS = -(-WIN // AA.SUM_WIDTH)  # 35
CTAS, LANES = 8, 32  # the tail's cluster and the lanes a CTA owns


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# am_tone: the tables and the tree
# ---------------------------------------------------------------------------

def test_tone_twiddle_table_is_plain_phases():
    """The cached grid twiddles are am_tone_plain's e^{i (-2π/256)(u n)},
    bit for bit, and shaped [85, 8910, 2]."""
    u = torch.from_numpy(AA.TONE_GRID)
    n = torch.arange(WIN)
    want = rc.exp_i(AA.NEG_TWO_PI_OVER_FFT * (u[:, None] * n.float()[None, :]))
    got = AA._tables("cpu")["twiddle"]
    assert got.shape == (AA.N_GRID, WIN, 2) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k0", [-128, -77, -1, 0, 1, 64, 127])
def test_tone_derot_table_matches_plain(k0):
    """The 256-entry derotation table at the kernel's index, (k0 n) % 256
    with C's truncating remainder and +256 where negative, is the plain
    version's phasor of ((k0 n) mod 256) (-2π/256) for every n of the
    window."""
    n = np.arange(WIN, dtype=np.int64)
    k = np.fmod(k0 * n, C.FFT_AM)
    k[k < 0] += C.FFT_AM
    assert np.array_equal(k, (k0 * n) % C.FFT_AM)
    got = AA._tables("cpu")["derot"][torch.from_numpy(k)]
    want = rc.exp_i(((torch.tensor(k0) * torch.from_numpy(n)) % C.FFT_AM)
                    .float() * AA.NEG_TWO_PI_OVER_FFT)
    assert torch.equal(_bits(got), _bits(want))


def _kernel_tree(lanes):
    """The kernels' tree of 256 lane values (last axis): lane l of a warp
    holds a_j = lanes[32 j + l]; levels 128, 64 and 32 as one expression,
    then levels 16 .. 1 by shuffles down (lane l adds lane l + o)."""
    a = [lanes[..., LANES * j:LANES * (j + 1)] for j in range(CTAS)]
    v = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]))
    for o in (16, 8, 4, 2, 1):
        v = v + torch.cat([v[..., o:], v[..., -o:]], dim=-1)
    return v[..., 0]


def _plain_tree(lanes):
    acc = lanes
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


@pytest.mark.parametrize("scale", ["unit", "wide"])
def test_tone_lane_tree_matches_fixed_sum(scale):
    """The kernels' tree (three cross-CTA levels, five shuffles) gives
    fixed_sum's pairwise tree bit for bit, on values of one scale and on
    values spread over 30 binary orders with signed zeros."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, AA.SUM_WIDTH)).astype(np.float32)
    if scale == "wide":
        x *= np.exp2(rng.integers(-15, 15, x.shape)).astype(np.float32)
        x[:, ::17] = -0.0
    t = torch.from_numpy(x)
    assert torch.equal(_bits(_kernel_tree(t)), _bits(_plain_tree(t)))


def _lane_sums(terms):
    """Per-lane sums of terms [..., 8910] as the kernels take them: rows of
    256 from the first to the last, row 34's lanes past the window adding
    a zero term."""
    pad = ROWS * AA.SUM_WIDTH - terms.shape[-1]
    rows = torch.nn.functional.pad(terms, (0, pad)).reshape(
        terms.shape[:-1] + (ROWS, AA.SUM_WIDTH))
    acc = rows[..., 0, :]
    for r in range(1, ROWS):
        acc = acc + rows[..., r, :]
    return acc


def _tone_model(spectra, samples, offset):
    """am_tone as its three kernels compute it, in torch: k0; z from the
    derotation table; the grid projection's per-lane sums against the
    twiddle table and the kernels' tree; the parabola; two Newton steps
    and the amplitude, each sum as lane sums and the tree."""
    tb = AA._tables("cpu")
    u = tb["u"]
    k0 = AA.tone_k0(spectra)
    buf = AA.am_window(samples, offset)
    n = torch.arange(WIN)
    k = torch.fmod(k0[:, None] * n, C.FFT_AM)
    k = torch.where(k < 0, k + C.FFT_AM, k)
    z = rc.mul(buf, tb["derot"][k])  # [S, 8910, 2]
    prod = rc.mul(z[:, None], tb["twiddle"][None])  # [S, 85, 8910, 2]
    proj = torch.stack([_kernel_tree(_lane_sums(prod[..., q]))
                        for q in range(2)], -1)
    p = rc.abs2(proj)
    i = torch.argmax(p, dim=1).clamp(1, AA.N_GRID - 2)
    pm, p0, pp = (p.gather(1, (i + d)[:, None])[:, 0] for d in (-1, 0, 1))
    den = (pm - 2 * p0) + pp
    d = torch.where(den != 0, (0.5 * (pm - pp)) / den, torch.zeros_like(den))
    f = rc.fdiv(k0.float() + (u[i] + d.clamp(-1.0, 1.0) * (u[1] - u[0])),
                C.FFT_AM)

    def total(t):  # [S, 8910] -> [S]
        return _kernel_tree(_lane_sums(t))

    m = n.float() - AA.HALF_SPAN
    w = AA.TWO_PI * m
    w2 = w * w
    for _ in range(2):
        xe = rc.mul(buf, rc.exp_i((AA.NEG_TWO_PI * f)[:, None] * m))
        s0, s1 = total(xe[..., 0]), total(xe[..., 1])
        t0, t1 = total(w * xe[..., 0]), total(w * xe[..., 1])
        d0, d1 = -total(w2 * xe[..., 0]), -total(w2 * xe[..., 1])
        ds0, ds1 = t1, -t0
        g = 2 * (s0 * ds0 + s1 * ds1)
        h = 2 * (ds0 * ds0 + ds1 * ds1) + 2 * (s0 * d0 + s1 * d1)
        f = torch.where(h < 0, f - g / h, f)
    e = rc.mul(buf, rc.exp_i((AA.NEG_TWO_PI * f)[:, None] * m))
    amp = rc.fdiv(torch.stack([total(e[..., 0]), total(e[..., 1])], -1),
                  WIN)
    return f, amp


def _tone_windows(s, n, seed):
    """``s`` stations: a carrier at a random frequency in ±100 bins and a
    random amplitude in white noise, rc [s, n, 2]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    f = rng.uniform(-100, 100, s) / C.FFT_AM
    x = rng.uniform(0.5, 2.0, s)[:, None] * np.exp(
        2j * np.pi * (f[:, None] * t + rng.uniform(0, 1, s)[:, None])) \
        + 0.3 * (rng.standard_normal((s, n))
                 + 1j * rng.standard_normal((s, n)))
    return np.stack([x.real, x.imag], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["tones", "clamped_and_zero"])
def test_tone_model_matches_plain(case):
    """The three kernels' decomposition gives am_tone_plain's f and amp bit
    for bit: three tone windows; and a window clamped at the capture's end
    beside an all-zero window (no Newton step: h is 0)."""
    x = torch.from_numpy(_tone_windows(2, 12000, 31 if case == "tones"
                                       else 32))
    if case == "tones":
        offset = torch.tensor([0, 2500], dtype=torch.int32)
    else:
        x[1] = 0.0
        offset = torch.tensor([11000, 700], dtype=torch.int32)
    spectra = rc.dft(AA.tone_symbols(x, offset))
    got = _tone_model(spectra, x, offset)
    want = AA.am_tone_plain(spectra, x, offset)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b)), (a, b)


# ---------------------------------------------------------------------------
# K13: the load plan
# ---------------------------------------------------------------------------

def _bin_reads(b, ma3):
    """The bins the value of bin ``b`` is made from, as the kernel's
    ``bin_value`` reads them: ``b``, and in MA1 its mirror where the
    sidebands combine (bins C+1..C+53)."""
    c = SA.CENTER
    combine = not ma3 and c + C.REF_INDEX_AM <= b <= c + C.PIDS_OUTER_INDEX_AM
    return [b, 2 * c - b] if combine else [b]


def _reads(ma3):
    """What each CTA of K13's plan loads: a list a CTA of ``(bins, rows)``,
    ``rows`` None for all 32 symbol rows, else the row of each bin in turn
    (the other primary partition's two training rows of each column, for
    samperr)."""
    out = []
    for row in scar.sync_am_plan(ma3):
        bins = [int(row[0] + row[1] * col) for col in range(scar.W)]
        if row[5] >= 0:
            bins.append(int(row[5]))
        if row[7]:
            bins.append(SA.CENTER + C.REF_INDEX_AM)
        reads = [(sorted({r for b in bins for r in _bin_reads(b, ma3)}),
                  None)]
        if row[8] >= 0:
            other, rows = [], []
            for col in range(scar.W):
                for t in (SA.TRAIN1[col], SA.TRAIN2[col]):
                    for r in _bin_reads(int(row[8] + row[9] * col), ma3):
                        other.append(r)
                        rows.append(int(t))
            reads.append((other, rows))
        out.append(reads)
    return out


def _runs(ma3):
    """Each CTA's bins read at every row as inclusive runs ``(lo, hi)``."""
    runs = []
    for reads in _reads(ma3):
        cta = []
        for b in reads[0][0]:
            if cta and b == cta[-1][1] + 1:
                cta[-1] = (cta[-1][0], b)
            else:
                cta.append((b, b))
        runs.append(cta)
    return runs


def _planned_bins(ma3):
    """Every bin some CTA of the plan loads, at any row."""
    return sorted({b for reads in _reads(ma3) for bins, _ in reads
                   for b in bins})


def _outputs(spectra, ma3):
    return scar.sync_am_block_rc_plain(spectra, ma3)


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("ma3", [False, True])
def test_sync_plan_is_the_plain_reads(ma3):
    """The plan's bins are exactly those the plain version's outputs depend
    on: a bin's column redrawn changes some output where the plan loads
    it, and (as NaN) changes none where it does not."""
    rng = np.random.default_rng(40 + ma3)
    spec = torch.from_numpy(rng.standard_normal(
        (1, C.BLKSZ, C.FFT_AM, 2)).astype(np.float32))
    base = _outputs(spec, ma3)
    planned = set(_planned_bins(ma3))
    for b in range(C.FFT_AM):
        moved = spec.clone()
        if b in planned:
            moved[:, :, b] = torch.from_numpy(rng.standard_normal(
                (1, C.BLKSZ, 2)).astype(np.float32) * 3)
            assert not _same(_outputs(moved, ma3), base), b
        else:
            moved[:, :, b] = float("nan")
            assert _same(_outputs(moved, ma3), base), b


@pytest.mark.parametrize("ma3", [False, True])
def test_sync_plan_zeroed_outside(ma3):
    """The plain version on three stations' spectra zeroed outside the
    plan's bins gives the outputs of the full spectra."""
    rng = np.random.default_rng(50 + ma3)
    spec = torch.from_numpy(rng.standard_normal(
        (3, C.BLKSZ, C.FFT_AM, 2)).astype(np.float32))
    keep = torch.zeros(C.FFT_AM, dtype=torch.bool)
    keep[_planned_bins(ma3)] = True
    cut = torch.where(keep[None, None, :, None], spec, torch.zeros(()))
    assert _same(_outputs(cut, ma3), _outputs(spec, ma3))


@pytest.mark.parametrize("ma3", [False, True])
def test_sync_plan_holds_every_read(ma3):
    """Every partition bin, both PIDS columns and bin C+1 (in MA1 with the
    mirrors of bins C+1..C+53) lie inside the planned runs; the samperr CTA
    also reads the other primary partition's two training rows."""
    c = SA.CENTER
    parts, pids = scar.partitions(ma3)
    ranges = _runs(ma3)
    inside = {b for runs in ranges for lo, hi in runs
              for b in range(lo, hi + 1)}
    need = {first + step * col for first, step, _, _ in parts
            for col in range(scar.W)} | set(pids) | {c + 1}
    if not ma3:
        need |= {2 * c - b for b in need if c + 1 <= b <= c + 53}
    assert need <= inside
    reads = _reads(ma3)
    other = [r for r in reads if len(r) > 1]
    assert len(other) == 1
    bins, rows = other[0][1]
    first, step, _, _ = parts[1]
    assert bins == [first + step * col for col in range(scar.W)
                    for _ in range(2)]
    assert rows == [int(t) for col in range(scar.W)
                    for t in (SA.TRAIN1[col], SA.TRAIN2[col])]


@pytest.mark.parametrize("ma3", [False, True])
def test_sync_plan_runs_and_extras(ma3):
    """Each CTA loads at most two contiguous runs a row, and each extra (PIDS
    column 0 and 1, the reference bits, samperr) falls on exactly one CTA;
    the four partitions in output order (pl, pu, s, t)."""
    plan = scar.sync_am_plan(ma3)
    parts, pids = scar.partitions(ma3)
    assert plan.shape == (4, scar.PLAN_INTS)
    assert [tuple(r[:3]) for r in plan] == [(f, s, lv) for f, s, _, lv
                                            in parts]
    assert all(len(runs) <= 2 for runs in _runs(ma3))
    assert sorted((int(r[5]), int(r[6])) for r in plan if r[5] >= 0) == \
        sorted(zip(pids, (0, 1)), key=lambda t: t)
    assert int(plan[:, 7].sum()) == 1
    assert int((plan[:, 8] >= 0).sum()) == 1
    two = [complex(r[3], r[4]) for r in plan]
    assert two == [2 * nominal for _, _, nominal, _ in parts]
    assert math.isclose(plan[0, 10], 2 * parts[1][2].real)
