"""K8, the FEC epilogue, as its kernel (csrc/fec_epilogue.cu) computes it,
held on the CPU to JAX's ``reencode_bit_errors`` and to the port's plain
version.  The kernel runs only on a card (tests/test_torch_kernels.py);
here a numpy model of what it does differently from the plain version is
checked:

- the kept bits gathered into a bitmap of 32-bit words, little-endian,
  through the run table of ``keep`` (a binary search for the last run that
  starts at or before each bit), slice by slice;
- the keystream packed into words the same way, and the output as bitmap
  word ^ keystream word, packed bytes or one byte a bit;
- the re-encode count walked over pm's 16-byte chunks in the kernel's lane
  order (lane l of a warp-step at chunk k + 9 l, which spreads the lanes'
  bitmap reads over the shared-memory banks) through the inverse site
  table: the register t-6..t as a funnel shift of two words of the bitmap
  behind a prefix word (the frame's last word, which gives the tail-biting
  wrap for t < 6), the count summed per slice over P slices.

Every comparison is exact: the work is integer.  Inputs are made with numpy
from seeds: random K7 bits and int8 soft bits, a frame whose soft bits all
disagree with the re-encode and one whose soft bits all agree.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nrsc5_tpu import constants as JC
from nrsc5_tpu.ops import convolutional as JCV
from nrsc5_tpu.ops import interleavers as JIL
from nrsc5_tpu.ops.scramble import scrambler_keystream as jax_keystream
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import decode_am  # noqa: F401  (the AM channels)
from nrsc5_tpu_torch.ops import decode_fm as DF

CHANNELS = ("p1", "pids", "px4608", "px2304", "am_p1", "am_p3_ma1",
            "am_p3_ma3", "am_pids")
T_P1 = C.P1_FRAME_LEN_FM
LANE_STRIDE = 9  # csrc/fec_epilogue.cu's lane order of the count
OFF = 4  # and the offset of the frame's words in its bitmap
CLUSTER = 8  # the CTAs (slices) of a P1 frame
GROUP = 8  # the words a warp gathers at once


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the numpy model of the kernel
# ---------------------------------------------------------------------------

def _slice(n, c, p):
    """[n * c / p, n * (c + 1) / p): slice c of p, as the kernel cuts."""
    return n * c // p, n * (c + 1) // p


def _word_slice(words, c, p):
    """The frame words of slice c of p: whole quads of words."""
    q0, q1 = _slice(-(-words // 4), c, p)
    return 4 * q0, min(words, 4 * q1)


def model_words(k7_frame, run_t, run_src, t, w0, w1, words):
    """Frame words [w0, w1) of the bitmap (the rest zero): each lane's bit
    through the kernel's binary search of the run table, the words as
    __ballot_sync makes them."""
    bm = np.zeros(words, np.uint32)
    tt = 32 * np.arange(w0, w1)[:, None] + np.arange(32)[None, :]
    lo = np.zeros(tt.shape, np.int64)
    hi = np.full(tt.shape, run_src.size - 1, np.int64)
    while (lo < hi).any():
        mid = (lo + hi + 1) >> 1
        up = run_t[mid] <= tt
        lo = np.where((lo < hi) & up, mid, lo)
        hi = np.where((lo < hi) & ~up, mid - 1, hi)
    valid = tt < t
    src = np.where(valid, run_src[lo] + tt - run_t[lo], 0)
    bits = np.where(valid, k7_frame[src] & 1, 0).astype(np.uint64)
    bm[w0:w1] = (bits << np.arange(32, dtype=np.uint64)).sum(axis=1)
    return bm


def model_bitmap(k7_frame, name, slices):
    """The frame's bitmap words, built slice by slice (as a cluster of
    ``slices`` CTAs builds it and shares it)."""
    tb, kt = DF.channel_tables(name), DF.k8_tables(name)
    words = kt["ks_words"].size
    bm = np.zeros(words, np.uint32)
    for c in range(slices):
        w0, w1 = _word_slice(words, c, slices)
        bm |= model_words(k7_frame, kt["run_t"], kt["run_src"], tb["t"],
                          w0, w1, words)
    return bm


def model_ext(bm):
    """The count's shared-memory layout: frame word w at OFF + w, the
    prefix word (the frame's last word, so T % 32 == 0) at OFF - 1, one
    zero word at OFF + W."""
    return np.concatenate([np.zeros(OFF - 1, np.uint32), bm[-1:], bm,
                           [0]]).astype(np.uint32)


def model_reg(ext, t):
    """The register t-6..t (bit i = frame bit t-6+i): bits t-6+32 OFF ..
    t+32 OFF of the bitmap, a funnel shift of two words; for t < 6 the
    prefix supplies the wrap."""
    u = t - 6 + 32 * OFF
    w = u >> 5
    pair = ext[w].astype(np.uint64) | (ext[w + 1].astype(np.uint64) << 32)
    return ((pair >> (u & 31).astype(np.uint64)) & 0x7f).astype(np.int64)


def lane_chunks(k0, k1, lane_stride=LANE_STRIDE):
    """[steps, 32]: the chunk lane l counts at warp-step i, k0 + 32 S (i /
    S) + i % S + S l, or -1 past the slice."""
    span = 32 * lane_stride
    steps = -(-(k1 - k0) // span) * lane_stride
    i = np.arange(steps)[:, None]
    k = (k0 + span * (i // lane_stride) + i % lane_stride
         + lane_stride * np.arange(32)[None, :])
    return np.where(k < k1, k, -1)


def model_count(bm, pm_frame, inv, gens, slices):
    """The re-encode count: each slice's 16-byte chunks of pm in the
    kernel's lane order through the inverse site table, summed per slice
    and over slices."""
    ext = model_ext(bm)
    chunks = pm_frame.size // 16
    parity = np.array([bin(v).count("1") & 1 for v in range(128)])
    total = 0
    for c in range(slices):
        k = lane_chunks(*_slice(chunks, c, slices)).reshape(-1)
        e = (16 * k[k >= 0][:, None] + np.arange(16)[None, :]).reshape(-1)
        site = inv[e].astype(np.int64)
        s = np.maximum(site, 0)
        t, j = s // 3, s % 3
        gen = np.asarray(gens, np.int64)[j]
        enc = parity[model_reg(ext, t) & gen]
        total += int((((pm_frame[e] > 0) != enc) & (site >= 0)).sum())
    return total


def model_out(bm, name, packed):
    """The frame's output: bitmap word ^ keystream word, as packed bytes
    (little-endian) or one byte a bit."""
    t = DF.channel_tables(name)["t"]
    words = bm ^ DF.k8_tables(name)["ks_words"]
    as_bytes = words.astype("<u4").view(np.uint8)
    if packed:
        return as_bytes[:t // 8]
    return np.unpackbits(as_bytes, bitorder="little")[:t]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _k7_bits(name, seed, frames=1):
    tb = DF.channel_tables(name)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (frames, tb["n_seg"] * tb["steps"]),
                        dtype=np.uint8)


def _jax_llr_full(pm_frame):
    """The depunctured P1 soft bits [T, 3] as JAX's chain makes them: the
    interleaver table's gather, then ``depuncture``."""
    llr = jnp.asarray(pm_frame)[jnp.asarray(JIL.p1_fm_table())]
    full = JCV.depuncture(llr.astype(jnp.float32), JC.PUNCTURE_P1_PIDS_FM,
                          JC.P1_FRAME_LEN_FM * 3)
    return full.reshape(JC.P1_FRAME_LEN_FM, 3)


def _p1_frame(kind, seed):
    """(K7 bits of one P1 frame, its pm): random soft bits, or soft bits
    that all disagree ("all_error") or all agree ("clean") with the
    re-encode at every site."""
    k7 = _k7_bits("p1", seed)[0]
    rng = np.random.default_rng(seed + 1)
    pm = rng.integers(-127, 128, DF.PM_FRAME, dtype=np.int8)
    if kind != "random":
        tb = DF.channel_tables("p1")
        kept = k7[tb["keep"]]
        enc = np.asarray(JCV.conv_encode_dev(jnp.asarray(kept), 7,
                                             JC.CONV_K7_GEN)).reshape(-1)
        want = enc if kind == "clean" else 1 - enc
        sites = np.flatnonzero(tb["code_map"] >= 0)
        pm[tb["code_map"][sites]] = np.where(want[sites] == 1, 127, -127)
    return k7, pm


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_inverse_sites_p1():
    """The inverse site table is the exact inverse of code_map for P1:
    365,440 sites, each once; -1 at the 3,200 entries no site reads."""
    code_map = DF.channel_tables("p1")["code_map"]
    inv = DF.k8_tables("p1")["inv"]
    assert inv.dtype == np.int32 and inv.shape == (DF.PM_FRAME,)
    hit = inv >= 0
    assert hit.sum() == JC.P1_FRAME_LEN_ENCODED_FM == 365440
    assert (~hit).sum() == 3200
    assert np.unique(inv[hit]).size == hit.sum()
    np.testing.assert_array_equal(code_map[inv[hit]], np.flatnonzero(hit))
    sites = np.flatnonzero(code_map >= 0)
    np.testing.assert_array_equal(inv[code_map[sites]], sites)


def test_inverse_sites_refuses_shared_soft_bit():
    with pytest.raises(ValueError):
        DF.inverse_sites(np.array([0, -1, 2, 0], np.int32), 4)
    np.testing.assert_array_equal(
        DF.inverse_sites(np.array([3, -1, 0, 1], np.int32), 5),
        [2, 3, -1, 0, -1])


@pytest.mark.parametrize("name", CHANNELS)
def test_packed_keystream(name):
    """The packed keystream unpacks to the channel's keystream, which for
    the FM channels is ``scrambler_keystream(t)`` (JAX's), and for AM P1
    that of a subframe at each of its 8."""
    tb = DF.channel_tables(name)
    words = DF.k8_tables(name)["ks_words"]
    t = tb["t"]
    assert words.dtype == np.uint32 and words.size == -(-t // 32)
    bits = np.unpackbits(words.astype("<u4").view(np.uint8),
                         bitorder="little")
    np.testing.assert_array_equal(bits[:t], tb["keystream"])
    assert not bits[t:].any()
    if not name.startswith("am"):
        np.testing.assert_array_equal(bits[:t], jax_keystream(t))


@pytest.mark.parametrize("name", CHANNELS)
def test_bitmap_is_kept_bits(name):
    """The bitmap built through the run table of keep equals bits[keep]:
    for P1 in the 8 slices of a cluster, for the other channels group by
    group (a warp's 8 words, as the kernel without pm builds them)."""
    tb = DF.channel_tables(name)
    kt = DF.k8_tables(name)
    run_t, run_src = kt["run_t"], kt["run_src"]
    assert run_t[0] == 0 and run_t[-1] == tb["t"]
    assert run_src.size <= 256  # the kernel's MAX_RUNS
    assert run_src[0] == tb["keep"][0]  # the lone run's src0
    k7 = _k7_bits(name, 5)[0]
    want = k7[tb["keep"]]
    words = kt["ks_words"].size
    if name == "p1":
        bm = model_bitmap(k7, name, CLUSTER)
    else:
        bm = np.zeros(words, np.uint32)
        for w in range(0, words, GROUP):
            bm |= model_words(k7, run_t, run_src, tb["t"], w,
                              min(w + GROUP, words), words)
    got = np.unpackbits(bm.astype("<u4").view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(got[:tb["t"]], want)
    assert not got[tb["t"]:].any()


@pytest.mark.parametrize("slices", [1, 3, 8])
@pytest.mark.parametrize("kind", ["random", "all_error", "clean"])
def test_reencode_count_matches_jax(kind, slices):
    """The model's count, per slice summed over P slices, equals JAX's
    ``reencode_bit_errors`` on the same frame: random soft bits, every
    site an error (365,440), no site an error."""
    k7, pm = _p1_frame(kind, 40 + len(kind))
    tb = DF.channel_tables("p1")
    kept = k7[tb["keep"]]
    want = int(JCV.reencode_bit_errors(
        _jax_llr_full(pm), jnp.asarray(kept), 7, JC.CONV_K7_GEN,
        JC.PUNCTURE_P1_PIDS_FM))
    bm = model_bitmap(k7, "p1", slices)
    got = model_count(bm, pm, DF.k8_tables("p1")["inv"], C.CONV_K7_GEN,
                      slices)
    assert got == want
    if kind != "random":
        assert got == {"all_error": 365440, "clean": 0}[kind]


def test_register_window_and_wrap():
    """The funnel-shift register at the frame's ends: for t < 6 it wraps
    to the frame's last bits through the prefix word, at t = T-1 it holds
    T-7..T-1 (the zero word past the frame unread), everywhere it is the
    bits t-6..t with t at the MSB."""
    rng = np.random.default_rng(9)
    kept = rng.integers(0, 2, T_P1, dtype=np.uint8)
    bm = np.packbits(kept, bitorder="little").view("<u4").astype(np.uint32)
    t = np.concatenate([np.arange(40), rng.integers(0, T_P1, 500),
                        np.arange(T_P1 - 40, T_P1)])
    got = model_reg(model_ext(bm), t)
    want = np.zeros(t.size, np.int64)
    for d in range(7):  # bit 6 - d holds frame bit t - d (mod T)
        want |= kept[(t - d) % T_P1].astype(np.int64) << (6 - d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slices", [1, 3, 8])
def test_lane_chunks_cover_slice(slices):
    """The count's lane order visits every chunk of each slice once."""
    chunks = DF.PM_FRAME // 16
    for c in range(slices):
        k0, k1 = _slice(chunks, c, slices)
        k = lane_chunks(k0, k1)
        np.testing.assert_array_equal(np.sort(k[k >= 0]), np.arange(k0, k1))


def _bank_ways(lane_stride):
    """Mean over a P1 slice's warp-steps of the most distinct bitmap words
    the 32 lanes read from one shared-memory bank (the count's first word;
    the second is the next word, so it is the same)."""
    inv = DF.k8_tables("p1")["inv"].astype(np.int64)
    chunks = DF.PM_FRAME // 16
    k = lane_chunks(0, chunks // CLUSTER, lane_stride)
    ways = []
    for e in (0, 5, 11):
        site = np.maximum(inv[16 * np.maximum(k, 0) + e], 0)
        word = (site // 3 - 6 + 32 * OFF) >> 5
        for row in word[::7]:
            ways.append(np.bincount(np.unique(row) % 32, minlength=32).max())
    return float(np.mean(ways))


def test_lane_stride_spreads_banks():
    """Why LANE_STRIDE is 9: over the P1 interleaver's inverse sites, the
    lanes' bitmap words at a stride of 9 chunks fall in nearly 32 banks
    (at most 1.5 words a bank on average), where neighbouring chunks (a
    stride of 1) put about 8 distinct words in one bank."""
    assert _bank_ways(LANE_STRIDE) <= 1.5
    assert _bank_ways(1) >= 6


@pytest.mark.parametrize("packed", [False, True])
def test_model_matches_plain_p1(packed):
    """Two P1 frames through the model (bitmap in 8 slices, output, count)
    against ``fec_epilogue_plain``: the output bytes and counts equal."""
    k7 = _k7_bits("p1", 21, frames=2)
    rng = np.random.default_rng(22)
    pm = rng.integers(-127, 128, (1, 2, DF.PM_FRAME), dtype=np.int8)
    want, want_errors = DF.fec_epilogue_plain(
        torch.from_numpy(k7).reshape(-1, DF.channel_tables("p1")["steps"]),
        "p1", torch.from_numpy(pm), packed)
    inv = DF.k8_tables("p1")["inv"]
    for f in range(2):
        bm = model_bitmap(k7[f], "p1", CLUSTER)
        np.testing.assert_array_equal(model_out(bm, "p1", packed),
                                      want[f].numpy())
        assert model_count(bm, pm[0, f], inv, C.CONV_K7_GEN,
                           CLUSTER) == int(want_errors[f])


@pytest.mark.parametrize("name", ["pids", "am_p1"])
def test_model_matches_plain_no_pm(name):
    """Channels without pm (one frame of PIDS, one AM P1 frame of 8
    subframes): the model's packed output equals the plain version's."""
    tb = DF.channel_tables(name)
    k7 = _k7_bits(name, 31)
    want, errors = DF.fec_epilogue_plain(
        torch.from_numpy(k7).reshape(-1, tb["steps"]), name, packed=True)
    assert errors is None
    bm = model_bitmap(k7[0], name, 1)
    np.testing.assert_array_equal(model_out(bm, name, True), want[0].numpy())


@pytest.mark.parametrize("name", CHANNELS)
def test_groups_cover_output(name):
    """Each warp's group of 8 words writes output bytes [4w, 4w + 32) of
    its frame below t / 8: over a frame's groups every byte once.  A P1
    slice is a whole number of quads of words, so its 16-byte copy between
    the cluster's CTAs moves whole quads."""
    t = DF.channel_tables(name)["t"]
    words = DF.k8_tables(name)["ks_words"].size
    hits = np.zeros(t // 8, np.int64)
    for w in range(0, words, GROUP):
        q = 4 * w + np.arange(32)
        np.add.at(hits, q[(q < 4 * words) & (q < t // 8)], 1)
    assert (hits == 1).all()
    if name == "p1":
        assert t % 128 == 0
        bounds = [_word_slice(words, c, CLUSTER) for c in range(CLUSTER)]
        assert bounds[0][0] == 0 and bounds[-1][1] == words
        assert all(w0 % 4 == 0 for w0, _ in bounds)
