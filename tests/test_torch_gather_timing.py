"""K6 (the FM P1/PIDS FEC gather, csrc/fec_gather.cu), K9 (the FM coarse
timing, csrc/coarse_timing.cu) and K7's int8 input, as their kernels
compute them, held on the CPU to the port's plain versions and to JAX.
The kernels run only on a card (tests/test_torch_kernels.py); here a
numpy model of what each does differently from its plain version is
checked:

- K6 for P1: pass 1, a CTA a (frame, row of 32), takes the row of every
  block (16 runs of 720 bytes) and writes each of the row's groups k of
  320 punctured positions, position q from the row's bytes at qoff[q] +
  col(k); pass 2, a lane a 16-byte output group at an aligned address
  in a warp's tile of 512 outputs (a tile may hold the end of one frame
  and the start of the next), reads the deinterleaved stream at
  5 (c // 6) + rank[c % 6] or writes 0, c the mother-code site of output
  m = (segment, step, j), found by division for a lane's first output and
  counted up by one an output after it: from a 512-byte window of the
  stream where the tile lies in one segment with no wrap, else walking
  across segments, the frame bits' wrap and frames.  For PIDS, a warp a block over
  the 200 soft bits the channel reads (the sorted src list and the idx
  map).  Exact, int8, against ``fec_gather_plain`` and against JAX's
  gather and depuncture (and chunk plan or wrap) through ``.float()``;
  the tables against JAX's ``p1_fm_table`` and chunk plan.
- K9: the CP products over 16 parts of 135 timings a station, each
  part's two sample runs a symbol read from an even index with their
  32-sample history (zero before the window's start, where n < 32), the
  filter's sums o = 0..31 in order, the products summed k = 0..31 in
  order into a scratch; then the window over a cluster of 8 slices of 270
  timings, each slice reading its 270 sums and the next 111 from the
  scratch (slice 7 reading slice 0's), and the two-stage argmax (the first
  index a slice, then the 8 slices' best with the lower index winning
  ties).  Bit-equal (samperr and max_v's bits) to
  ``coarse_timing_rc_plain`` on the cold-start windows of
  tests/test_torch_coldstart.py and on windows built to tie.
- K7's plain version on int8 input: the bits and margins of the same
  values in float32.

Inputs are made with numpy from seeds.  Torch runs on one thread.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nrsc5_tpu import constants as JC
from nrsc5_tpu.ops import convolutional as JCV
from nrsc5_tpu.ops import interleavers as JIL
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import acquire_rc as TAQ
from nrsc5_tpu_torch.ops import convolutional as TCV
from nrsc5_tpu_torch.ops import decode_fm as DF

from .test_torch_coldstart import STATIONS, _capture, _conj_rc

K9_PARTS = 16  # CTAs a station of K9's products
PART = C.FFTCP_FM // K9_PARTS  # timings a products CTA
K9_CLUSTER = 8  # CTAs a station of K9's window
SLICE = C.FFTCP_FM // K9_CLUSTER  # timings a window CTA
NTAPS = 32
RUN = 168  # samples a run, from an even index


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pm(seed, *shape):
    return np.random.default_rng(seed).integers(
        -127, 128, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# K6: the numpy model
# ---------------------------------------------------------------------------

def model_p1(frames: np.ndarray) -> np.ndarray:
    """K6's two P1 passes on int8 frames [B, 368640]: the flat int8 output
    [B * map_len]."""
    gt = DF.gather_tables("p1")
    tb = DF.channel_tables("p1")
    n_fr = frames.shape[0]
    # pass 1: CTA (frame, row r)
    d = np.zeros((n_fr, C.P1_FRAME_LEN_ENCODED_FM), np.int8)
    written = np.zeros(d.shape, np.int32)
    for b in range(n_fr):
        rows = frames[b].reshape(C.P1_FM_BLOCKS, DF.K6_ROWS, DF.K6_ROW_BYTES)
        for r in range(DF.K6_ROWS):
            slab = rows[:, r].reshape(-1)  # block b at 720 b
            for kc in gt["row_k"][r]:
                if kc < 0:
                    break
                k, col = kc & 0xFFFF, kc >> 16
                at = DF.K6_GROUP * k + np.arange(DF.K6_GROUP)
                d[b, at] = slab[gt["qoff"] + col]
                written[b, at] += 1
    assert (written == 1).all()
    # pass 2, all outputs at once; model_tile checks the kernel's tiles
    steps, t, length = tb["steps"], tb["t"], tb["k7_map"].size
    m = np.arange(length)
    s_, rem = m // (3 * steps), m % (3 * steps)
    site = (gt["start"][s_] + rem // 3) % t
    c = 3 * site + rem % 3
    rk = gt["rank"][c % 6]
    val = np.where(rk >= 0, d[:, np.maximum(5 * (c // 6) + rk, 0)], 0)
    return val.astype(np.int8).reshape(-1), d


def _locate(p: int):
    """Frame, segment, offset in the segment and site c of output p."""
    gt = DF.gather_tables("p1")
    tb = DF.channel_tables("p1")
    seg = 3 * tb["steps"]
    b, m = divmod(p, tb["k7_map"].size)
    s, off = divmod(m, seg)
    return b, s, off, (3 * gt["start"][s] + off) % (3 * tb["t"])


def model_tile(p0: int, d: np.ndarray, total: int) -> list:
    """The outputs [p0, p0 + 512) of pass 2's warp at tile p0 // 512: in
    one segment of one frame with no wrap, each lane's 16 from the tile's
    run of d (a 512-byte window from the run's first byte rounded down to
    16) by counting c from its first output; else each lane walks its 16
    outputs through d, across segments, frames and the frame bits' wrap."""
    gt = DF.gather_tables("p1")
    tb = DF.channel_tables("p1")
    seg, t, n_seg = 3 * tb["steps"], tb["t"], tb["n_seg"]
    enc = C.P1_FRAME_LEN_ENCODED_FM
    flat = np.concatenate([d.reshape(-1), np.zeros(512, np.int8)])
    b0, s0, _, c0 = _locate(p0)
    b1, s1, _, c1 = _locate(min(p0 + 512, total) - 1)
    got = []
    for lane in range(32):
        pos = p0 + 16 * lane
        if b0 == b1 and s0 == s1 and c1 >= c0:
            base = (b0 * enc + 5 * (c0 // 6)) & ~15
            win = flat[base:base + 512]
            cq, cr = divmod(c0 + 16 * lane, 6)
            at = b0 * enc + 5 * cq - base
            for e in range(16):
                rk = gt["rank"][cr]
                got.append(int(win[at + rk]) if rk >= 0 else 0)
                cr += 1
                if cr == 6:
                    cr, at = 0, at + 5
            continue
        b, s, off, c = _locate(pos) if pos < total else (0, 0, 0, 0)
        left = seg - off
        cq, cr = divmod(c, 6)
        for e in range(16):
            rk = gt["rank"][cr]
            if pos + e < total:
                got.append(int(d[b, 5 * cq + rk]) if rk >= 0 else 0)
            left -= 1
            if left == 0:
                left = seg
                s += 1
                if s == n_seg:
                    s, b = 0, b + 1
                cq, cr = divmod(3 * gt["start"][s], 6)
            else:
                cr += 1
                if cr == 6:
                    cr, cq = 0, cq + 1
                    if cq == 3 * t // 6:
                        cq = 0
    return got[:max(0, min(512, total - p0))]


def model_compact(frames: np.ndarray, name: str) -> np.ndarray:
    """K6's warp-a-frame kernel (PIDS) on int8 frames [B, frame]."""
    gt = DF.gather_tables(name)
    vals = frames[:, gt["src"]]  # the warp's shared memory
    idx = gt["idx"].astype(np.int64)
    got = vals[:, np.minimum(idx, gt["src"].size - 1)]
    return np.where(idx[None, :] == 255, 0, got).astype(np.int8).reshape(-1)


def jax_gather(frames: np.ndarray, name: str) -> np.ndarray:
    """JAX's gather, float cast and depuncture (nrsc5_tpu/ops/decode_fm.py
    :64-66, 98-100), then its chunk segments (P1) or the tail-biting wrap
    (PIDS), flat float32 per frame."""
    if name == "p1":
        t, table = C.P1_FRAME_LEN_FM, JIL.p1_fm_table()
    else:
        t, table = C.PIDS_FRAME_LEN, JIL.pids_fm_table()
    rows = []
    for frame in frames:
        llr = jnp.asarray(frame)[jnp.asarray(table)].astype(jnp.float32)
        full = np.asarray(JCV.depuncture(llr, C.PUNCTURE_P1_PIDS_FM, t * 3)
                          ).reshape(t, 3)
        if name == "p1":
            seg_idx = JCV._chunk_plan(t, 1152, 96)[0]
            rows.append(full[seg_idx].reshape(-1))
        else:
            w = DF.WRAP
            rows.append(np.concatenate([full[t - w:], full, full[:w]])
                        .reshape(-1))
    return np.stack(rows)


def test_p1_tables():
    """P1's tables against JAX's: qoff, row and col rebuild
    ``p1_fm_table``; row_k holds each of the 1142 groups once, in its row;
    start is the chunk plan's first frame bit of each segment; rank is the
    kept positions' rank in the pattern; aux holds the four in the
    kernel's order."""
    gt = DF.gather_tables("p1")
    table = JIL.p1_fm_table().astype(np.int64)
    n = table.size
    k, q = np.arange(n) // 320, np.arange(n) % 320
    row = np.full(n // 320, -1)
    col = np.full(n // 320, -1)
    for r, kcs in enumerate(gt["row_k"]):
        for kc in kcs[kcs >= 0]:
            assert row[kc & 0xFFFF] == -1
            row[kc & 0xFFFF], col[kc & 0xFFFF] = r, kc >> 16
    assert (row >= 0).all()
    qoff = gt["qoff"][q]
    block, within = qoff // 720, qoff % 720
    want = block * 23040 + row[k] * 720 + within + col[k]
    assert np.array_equal(want, table)
    seg_idx = JCV._chunk_plan(JC.P1_FRAME_LEN_FM, 1152, 96)[0]
    assert np.array_equal(gt["start"], seg_idx[:, 0])
    assert gt["rank"].tolist() == [0, 1, 2, 3, 4, -1]
    assert np.array_equal(gt["aux"], np.concatenate(
        [gt["row_k"].reshape(-1), gt["start"], gt["qoff"], gt["rank"]]))


def test_compact_map_decodes():
    """PIDS's src list holds the 200 soft bits the channel reads, sorted,
    and idx decodes back to k7_map (255 where punctured)."""
    gt = DF.gather_tables("pids")
    k7 = DF.channel_tables("pids")["k7_map"]
    assert gt["src"].size == 200 and (np.diff(gt["src"]) > 0).all()
    assert np.array_equal(gt["idx"] == 255, k7 < 0)
    assert np.array_equal(gt["src"][gt["idx"][k7 >= 0]], k7[k7 >= 0])


@pytest.mark.parametrize("n_frames", [1, 2, 3])
def test_k6_p1_model(n_frames):
    """The two P1 passes equal fec_gather_plain (int8) and JAX's segments
    on 1-3 frames; pass 2's tiles, every one that holds a segment's or a
    frame's end or the frame bits' wrap (the lanes' walks), the last and
    random ones (mostly a window of d in shared memory), equal the
    outputs."""
    frames = _pm(10 + n_frames, n_frames, DF.PM_FRAME)
    plain = DF.fec_gather_plain(torch.from_numpy(frames)[None], "p1")
    assert plain.dtype == torch.int8
    got, d = model_p1(frames)
    assert np.array_equal(got, plain.numpy().reshape(-1))
    want = jax_gather(frames, "p1")
    assert np.array_equal(plain.float().numpy().reshape(n_frames, -1), want)
    tb = DF.channel_tables("p1")
    seg = 3 * tb["steps"]
    edges = np.arange(seg, got.size, seg) // 512
    # segment 0 crosses the frame bits' wrap 3 (t - start[0]) outputs in
    wrap = 3 * (tb["t"] - DF.gather_tables("p1")["start"][0])
    wraps = (np.arange(n_frames) * tb["k7_map"].size + wrap) // 512
    rng = np.random.default_rng(n_frames)
    tiles = np.unique(np.concatenate([
        edges, wraps, rng.integers(0, -(-got.size // 512), 48),
        [-(-got.size // 512) - 1]]))
    for tile in tiles:
        p0 = 512 * int(tile)
        assert model_tile(p0, d, got.size) == got[p0:p0 + 512].tolist()


@pytest.mark.parametrize("n_blocks", [1, 5])
def test_k6_pids_model(n_blocks):
    """The PIDS warp-a-block model equals fec_gather_plain (int8) and JAX's
    wrap-extended depunctured block."""
    frames = _pm(40 + n_blocks, n_blocks, C.PM_BLOCK_SIZE)
    plain = DF.fec_gather_plain(torch.from_numpy(frames)[None], "pids")
    assert plain.dtype == torch.int8
    assert np.array_equal(model_compact(frames, "pids"),
                          plain.numpy().reshape(-1))
    want = jax_gather(frames, "pids")
    assert np.array_equal(plain.float().numpy().reshape(n_blocks, -1), want)


# ---------------------------------------------------------------------------
# K9: the numpy model
# ---------------------------------------------------------------------------

def model_k9(x: np.ndarray):
    """K9 on one station's conjugated rc window x [>= 71280, 2] float32:
    (samperr, max_v [2], each slice's largest |v|^2 and its index)."""
    fft, fftcp, cp = C.FFT_FM, C.FFTCP_FM, C.CP_FM
    taps = np.asarray(C.ACQ_TAPS_FM, np.float32)
    w = TAQ._shape_kernel(fft, cp)
    xp = np.concatenate([np.zeros((NTAPS, 2), np.float32),
                         x[:TAQ.WINDOW_FM]])  # zero history before n = 0
    h = np.arange(K9_PARTS)[:, None]
    shift = (PART * h) & 1  # a run starts at an even index
    t = np.arange(PART)[None, :]
    sums = np.zeros((K9_PARTS, PART, 2), np.float32)
    for k in range(C.ACQUIRE_SYMBOLS):  # k ascending, from 0.0
        f = []
        for base in (k * fftcp, fft + k * fftcp):  # the a and b runs
            e0 = base + PART * h - NTAPS - shift  # [16, 1], even
            assert (e0 % 2 == 0).all()
            run = xp[e0 + NTAPS + np.arange(RUN)[None, :]]  # [16, 168, 2]
            acc = np.zeros((K9_PARTS, PART, 2), np.float32)
            for o in range(NTAPS):  # o ascending, from 0.0
                # output t's window sample jj = t + 31 - o, past the shift
                idx = np.broadcast_to(shift + t + NTAPS - 1 - o,
                                      (K9_PARTS, PART))
                acc = acc + taps[o] * np.take_along_axis(
                    run, idx[..., None], axis=1)
            f.append(acc)
        a, b = f
        prod = np.stack([a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1],
                         a[..., 1] * b[..., 0] - a[..., 0] * b[..., 1]], -1)
        sums = sums + prod
    scratch = sums.reshape(fftcp, 2)
    best_p, best_i, best_v = [], [], []
    for r in range(K9_CLUSTER):
        # the slice's sums and the next 111, circularly (7 reads 0's)
        ext = scratch[(SLICE * r + np.arange(SLICE + cp - 1)) % fftcp]
        v = np.zeros((SLICE, 2), np.float32)
        for j in range(cp):  # j ascending, from 0.0
            v = v + w[j] * ext[j:j + SLICE]
        p = v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
        i = int(np.argmax(p))  # the first index of the slice's largest
        best_p.append(p[i])
        best_i.append(SLICE * r + i)
        best_v.append(v[i])
    q = 0
    for r in range(1, K9_CLUSTER):  # lower index on ties
        if best_p[r] > best_p[q] or (best_p[r] == best_p[q]
                                     and best_i[r] < best_i[q]):
            q = r
    return ((best_i[q] + fftcp - C.ACQ_FILTER_DELAY) % fftcp, best_v[q],
            best_p, best_i)


def _hold_k9(win: np.ndarray):
    """The model against coarse_timing_rc_plain: samperr equal, max_v's
    bits equal."""
    ps, pv = TAQ.coarse_timing_rc_plain(torch.from_numpy(win)[None])
    ms, mv, best_p, best_i = model_k9(win)
    assert int(ps[0]) == ms
    assert np.array_equal(pv[0].numpy().view(np.int32),
                          np.asarray(mv, np.float32).view(np.int32))
    return ms, best_p, best_i


@pytest.mark.parametrize("station", range(len(STATIONS)))
def test_k9_model_coldstart_windows(station):
    """The cold-start windows of tests/test_torch_coldstart.py (MP1 behind
    a timing offset and an integer plus fractional CFO, 25 dB)."""
    rng = np.random.default_rng(20 + station)
    sig, _, _ = _capture(rng, *STATIONS[station])
    _hold_k9(_conj_rc(sig[:TAQ.WINDOW_FM]))


def _periodic(seed):
    """A window of period 270, the slice width: every timing's sums equal
    its peers' 270 apart wherever the filter had its whole history, so the
    largest |v|^2 ties across the slices."""
    base = np.random.default_rng(seed).normal(0, 1, (SLICE, 2))
    return np.tile(base, (TAQ.WINDOW_FM // SLICE, 1)).astype(np.float32)


@pytest.mark.parametrize("seed,tied", [(1, 7), (2, 8)])
def test_k9_model_ties_across_slices(seed, tied):
    """On a window of period 270 the largest |v|^2 is reached in 7 or 8
    of the slices (the window's start moves the others), and slice 0's
    index wins, as jnp.argmax's first index does."""
    ms, best_p, best_i = _hold_k9(_periodic(seed))
    top = max(best_p)
    assert sum(p == top for p in best_p) == tied
    assert best_p[0] == top
    assert ms == (best_i[0] + C.FFTCP_FM - C.ACQ_FILTER_DELAY) % C.FFTCP_FM


def test_k9_model_all_zero():
    """An all-zero window: every |v|^2 is 0, so index 0 (rank 0, thread 0)
    wins the tie and max_v is +0.0."""
    win = np.zeros((TAQ.WINDOW_FM, 2), np.float32)
    ms, best_p, _ = _hold_k9(win)
    assert ms == (C.FFTCP_FM - C.ACQ_FILTER_DELAY) % C.FFTCP_FM
    assert all(p == 0 for p in best_p)


@pytest.mark.parametrize("seed", [3, 4])
def test_k9_model_noise(seed):
    """Gaussian noise windows, longer than the 71280 samples K9 reads."""
    win = np.random.default_rng(seed).normal(
        0, 1, (TAQ.WINDOW_FM + 333, 2)).astype(np.float32)
    _hold_k9(win)


# ---------------------------------------------------------------------------
# K7 on int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["p1", "pids"])
def test_acs_traceback_plain_int8(name):
    """acs_traceback_plain on K6's int8 output gives the bits and margins of
    the same values in float32 (a few P1 segments; PIDS blocks)."""
    frame = DF.PM_FRAME if name == "p1" else C.PM_BLOCK_SIZE
    frames = torch.from_numpy(_pm(60, 1, 2, frame))
    ext = DF.fec_gather_plain(frames, name)
    if name == "p1":
        ext = ext[::50].contiguous()
    assert ext.dtype == torch.int8
    bi, mi = TCV.acs_traceback_plain(ext, C.CONV_K7_GEN)
    bf, mf = TCV.acs_traceback_plain(ext.float(), C.CONV_K7_GEN)
    assert torch.equal(bi, bf) and torch.equal(mi, mf)
