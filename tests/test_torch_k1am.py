"""A numpy model of K1's AM cascade kernel (``csrc/am_decimate_cu8.cu``)
against its plain version, on the CPU.

The model follows the kernel's work split step by step: a CTA of 256
threads a tile of 256 outputs of a station; its bytes loaded as 16-byte
blocks from the 16-byte boundary below them, out of a byte image of the
allocation whose other bytes are random (what a load past the wire would
see); stage 1 a thread 17 consecutive outputs from its own 17 words, each
byte converted once by arithmetic, the words funnel-shifted by 2 bytes
where the wire starts half a word in, the 10 pairs past its own taken from
the next thread (shuffles: every lane but 31, which reads and converts
them itself); stages 2-5 a thread R = 9, 5, 3, 1 consecutive outputs from
a window of R + 7 (even, odd) pairs; the buffers at the kernel's sizes,
stage 2's over the bytes, entries never written NaN, so that an output
which read one is NaN.  Exact: the model adds in the plain version's
order with float32 roundings apart, as the kernel with -fmad=false does.
"""

import numpy as np
import pytest
import torch

from nrsc5_tpu_torch.ops import frontend as FE

TILE = THREADS = 256
HIST = 14
R1, RS = 17, (9, 5, 3, 1)
N4 = 2 * TILE + HIST
N3 = 2 * N4 + HIST
N2 = 2 * N3 + HIST
N1 = 2 * N2 + HIST
N0 = 2 * N1 + HIST
CHUNKS = (2 * N0 + 15) // 16 + 1
RAW_WORDS = R1 * THREADS + 16


def reach(n, r):
    return 2 * (-(-n // r) * r + 7)


Y1_LEN = max(R1 * THREADS, reach(N2, 9), reach(N4, 3))
Y2_LEN = max(N2, reach(N3, 5), reach(TILE, 1))
F32 = np.float32


def _taps():
    h = FE.halfband_taps()
    return h[0::2].astype(F32), F32(h[7])


def _convert(words, byte, scale16):
    """Byte ``byte`` of each word, as the kernel converts it: the float
    2^23 + u less 2^23 + 127, times scale / 16."""
    u = (words >> np.uint32(8 * byte)) & np.uint32(0xFF)
    f = (np.uint32(0x4B000000) | u).view(F32) - F32(8388735.0)
    return f * scale16


def _pairs(words, scale16):
    """[..., k] words -> [..., 2k, 2] converted pairs."""
    out = np.empty(words.shape[:-1] + (2 * words.shape[-1], 2), F32)
    for b in range(4):
        out[..., b // 2::2, b % 2] = _convert(words, b, scale16)
    return out


def _stage1(rw, half, n1, he, h7, scale16):
    t = np.arange(THREADS)
    w0 = t * R1

    def word(i):
        if half:
            return (rw[i] >> np.uint32(16)) | (rw[i + 1] << np.uint32(16))
        return rw[i]
    own = _pairs(word(w0[:, None] + np.arange(R1)), scale16)  # [256, 34, 2]
    ext = np.full((THREADS, 13, 2), np.nan, F32)
    nxt = np.roll(own, -1, axis=0)  # thread t + 1's pairs
    for e in range(13):
        if e % 2 == 0 or e < 6:
            ext[:, e] = nxt[:, e]
    lane31 = t % 32 == 31
    mine = _pairs(word(w0[lane31, None] + R1 + np.arange(7)), scale16)
    for e in range(13):
        if e % 2 == 0 or e < 6:
            ext[lane31, e] = mine[:, e]
    p = np.concatenate([own, ext], axis=1)  # [256, 47, 2]
    y = np.full((Y1_LEN, 2), np.nan, F32)
    for r in range(R1):
        acc = h7 * p[:, 2 * r + 7]
        for j in range(8):
            acc = acc + he[j] * p[:, 2 * r + 2 * j]
        m = w0 + r
        keep = m < n1
        y[m[keep]] = acc[keep]
    return y


def _stage(x, y, n, r, he, h7):
    x4 = x.reshape(-1, 4)
    items = -(-n // r)
    q0 = np.arange(items) * r
    w = x4[q0[:, None] + np.arange(r + 7)]  # [items, r + 7, 4]
    for k in range(r):
        acc = h7 * w[:, k + 3, 2:4]
        for j in range(8):
            acc = acc + he[j] * w[:, k + j, 0:2]
        q = q0 + k
        keep = q < n
        y[q[keep]] = acc[keep]


def model(mem, addr, n_stations, n_out):
    """The kernel on a wire of ``n_stations`` rows at byte ``addr`` of the
    allocation image ``mem``."""
    he, h7 = _taps()
    scale16 = F32(FE.CU8_SCALE) * F32(0.0625)
    n_in = FE.rc_overlap(FE.AM_STAGES) + 32 * n_out
    out = np.full((n_stations, n_out, 2), np.nan, F32)
    for s in range(n_stations):
        for bx in range(-(-n_out // TILE)):
            o0 = bx * TILE
            tn = min(TILE, n_out - o0)
            n4 = 2 * tn + HIST
            n3 = 2 * n4 + HIST
            n2 = 2 * n3 + HIST
            n1 = 2 * n2 + HIST
            n0 = 2 * n1 + HIST
            g = addr + (s * n_in + 32 * o0) * 2
            base, delta = g & ~15, g & 15
            chunks = (delta + 2 * n0 + 15) >> 4
            assert chunks <= CHUNKS and base + 16 * chunks <= len(mem)
            raw = np.random.default_rng(g).integers(
                0, 256, 4 * RAW_WORDS).astype(np.uint8)
            raw[:16 * chunks] = mem[base:base + 16 * chunks]
            words = raw.view("<u4")
            y1 = _stage1(words[delta >> 2:], delta & 2, n1, he, h7, scale16)
            y2 = np.full((4 * RAW_WORDS // 8, 2), np.nan, F32)
            _stage(y1, y2, n2, RS[0], he, h7)
            y1[:] = np.nan
            _stage(y2, y1, n3, RS[1], he, h7)
            y2[:] = np.nan
            _stage(y1, y2, n4, RS[2], he, h7)
            dst = np.full((TILE, 2), np.nan, F32)
            _stage(y2, dst, tn, RS[3], he, h7)
            out[s, o0:o0 + tn] = dst[:tn]
    return out


def test_sizes():
    """The kernel's static sizes: stage 1 in one pass of the CTA, the
    loads and stage 1's reads inside the byte buffer, stage 2's and 4's
    outputs and reads over it."""
    assert N0 == 32 * TILE + FE.rc_overlap(FE.AM_STAGES)
    assert N1 <= R1 * THREADS
    assert RAW_WORDS * 4 >= CHUNKS * 16 and 3 + R1 * THREADS + 8 <= RAW_WORDS
    assert Y2_LEN * 8 <= RAW_WORDS * 4
    assert Y1_LEN * 8 + RAW_WORDS * 4 == 52288


def test_conversion_is_the_plain_versions():
    """Every byte value converted as the kernel does equals the plain
    version's ((u - 127) * scale) * 1/16, bit for bit."""
    u = np.arange(256, dtype=np.uint8)
    wire = torch.from_numpy(np.stack([u, u[::-1]], -1))
    want = (FE.cu8_to_rc(wire, conj=False) * (1.0 / 16.0)).numpy()
    words = np.stack([u, u[::-1], u, u[::-1]], -1).copy().view("<u4")[:, 0]
    got = _pairs(words[:, None], F32(FE.CU8_SCALE) * F32(0.0625))[:, 0]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("stations,n_out,shift", [
    (1, 300, 0), (1, 300, 1), (2, 257, 0), (3, 777, 1), (2, 512, 3)])
def test_model_equals_plain(stations, n_out, shift):
    """The model of the kernel on random cu8 wires placed ``shift`` pairs
    into their allocation (one station at a session push's size, a last
    tile of one output, rows off 16-byte boundaries, half-word starts)
    equals ``ingest_am_cu8_plain`` bit for bit."""
    rng = np.random.default_rng(100 * stations + n_out + shift)
    n_in = FE.rc_overlap(FE.AM_STAGES) + 32 * n_out
    wire = rng.integers(0, 256, (stations, n_in, 2)).astype(np.uint8)
    addr = 2 * shift
    size = -(-(addr + wire.nbytes) // 512) * 512
    mem = rng.integers(0, 256, size).astype(np.uint8)
    mem[addr:addr + wire.nbytes] = wire.reshape(-1)
    got = model(mem, addr, stations, n_out)
    want = FE.ingest_am_cu8_plain(torch.from_numpy(wire)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
