"""K7, the Viterbi at K=7 and K=9, as its kernels (csrc/viterbi.cuh)
compute it, held on the CPU to JAX's ``_acs_traceback`` and to the port's
plain version.  The kernels run only on a card (tests/test_torch_kernels.py);
here a step-for-step model of what they do differently from the plain
version is checked:

- integer path metrics, and each butterfly's four branches as one metric W
  with signs + - - +, W's signs split into the thread's flips (fixed before
  the loop) and a compile-time part per slot;
- R states a thread, r = log2 R trellis steps between exchanges, the slot
  layout of each level and the exchange that restores it;
- each step's decisions as R ballot words, bit = lane, two segments a warp
  at K=7 (a ragged last warp walks the last segment again);
- top-2 (ties counting) and the first argmax across the lanes, as the
  thread's scan and a xor-shuffle tree;
- the traceback's read order: decision chunks into a ring of three, two
  chunks ahead (a chunk loaded is visible only after the wait that follows
  it), a period's decision words loaded a period ahead, the word of each
  successor chosen by the state's bits, both successors looked up before
  the newest decision, a period's bits kept in a byte, and bits[t] = the
  decision of step t + m.

Every comparison is exact (bits and margins equal): the LLRs are integers in
[-127, 127], so every path metric is an integer below 2^24 in float32 and in
the model's int64 alike.  Inputs, made with numpy from seeds: random int8
soft values, AM-style +-1 with punctured zeros and flips, all zeros (every
state ties), all +-127; the chains' segment lengths (PIDS 144, AM P1 1258,
AM P3 1320, FM P1 1343, one PX1 frame 4672) at a few segments each.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nrsc5_tpu.ops.convolutional import _acs_traceback
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import convolutional as CV

# the kernels' layout (csrc/viterbi.cuh): log2 of the states a thread;
# chunk periods of the traceback ring
RL = {7: 2, 9: 3}
CHUNK_PERIODS = 32
KINDS = ("int8", "am", "zeros", "sat")
CASES = [  # (k, gens, n_steps, segments)
    (7, C.CONV_K7_GEN, 144, 3),
    (7, C.CONV_K7_GEN, 1343, 3),
    (7, C.CONV_K7_GEN, 4672, 1),
    (9, C.CONV_E2_E3_GEN, 144, 2),
    (9, C.CONV_E1_GEN, 1258, 2),
    (9, C.CONV_E2_E3_GEN, 1320, 2),
    (9, C.CONV_E1_GEN, 1320, 1),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parity(x):
    return bin(x).count("1") & 1


def _ext(kind, k, gens, n_steps, segs, seed):
    """[segs, n_steps, 3] integer-valued float32 LLRs."""
    rng = np.random.default_rng(seed)
    shape = (segs, n_steps, 3)
    if kind == "int8":
        x = rng.integers(-127, 128, shape)
    elif kind == "am":
        bits = rng.integers(0, 2, (segs, n_steps)).astype(np.uint8)
        x = CV.conv_encode(bits, k, gens).reshape(shape).astype(np.int64)
        x = x * 2 - 1
        x[rng.random(shape) < 0.05] *= -1
        x[rng.random(shape) < 0.2] = 0
    elif kind == "zeros":
        x = np.zeros(shape, np.int64)
    else:
        x = rng.choice([-127, 127], shape)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, step for step
# ---------------------------------------------------------------------------

class Geometry:
    def __init__(self, k, gens):
        self.k, self.gens = k, tuple(gens)
        self.m = k - 1
        self.ns = 1 << self.m
        self.rl = RL[k]
        self.r = 1 << self.rl
        self.tps = self.ns // self.r
        self.spw = 32 // self.tps
        self.chunk = CHUNK_PERIODS * self.rl
        for g in gens:  # taps at both ends (the butterfly's signs)
            assert g & 1 and (g >> self.m) & 1

    def state_of(self, q, j, i):
        low = self.rl - j
        return ((q >> low) << (self.m - j)) | (i << low) | (q & ((1 << low) - 1))

    def flips(self, j):
        """[tps, 3] the thread's signs of level j."""
        return np.array([[-1 if _parity((i << (self.rl - j)) & g) else 1
                          for g in self.gens] for i in range(self.tps)])

    def branch_signs(self, j, q):
        gb = self.rl - j - 1
        h, g = q >> gb, q & ((1 << gb) - 1)
        full = (h << (self.m - j)) | (g << 1)
        return [1 if _parity(full & gen) else -1 for gen in self.gens]


def model_forward(ext, geo):
    """The forward pass: ext [B, L, 3] -> (ballot words [warps, L, R]
    uint32, final metrics by slot [Bp, tps, R], the final level)."""
    b, n_steps, _ = ext.shape
    warps = -(-b // geo.spw)
    seg = np.minimum(np.arange(warps * geo.spw), b - 1)
    x = ext[seg].astype(np.int64)
    bp = len(seg)
    pm = np.zeros((bp, geo.tps, geo.r), np.int64)
    flips = [geo.flips(j) for j in range(geo.rl)]
    signs = [[geo.branch_signs(j, q) for q in range(geo.r // 2)]
             for j in range(geo.rl)]
    lanes = (np.arange(geo.spw)[:, None] * geo.tps
             + np.arange(geo.tps)[None, :]).astype(np.uint64)
    words = np.zeros((warps, n_steps, geo.r), np.uint64)
    half = geo.r // 2
    for t in range(n_steps):
        j = t % geo.rl
        lam = flips[j][None, :, :] * x[:, t, None, :]  # [bp, tps, 3]
        nw = np.empty_like(pm)
        dec = np.empty(pm.shape, bool)
        for q in range(half):
            s = signs[j][q]
            w = s[0] * lam[..., 0] + s[1] * lam[..., 1] + s[2] * lam[..., 2]
            a, bb = pm[..., 2 * q], pm[..., 2 * q + 1]
            c00, c01, c10, c11 = a + w, bb - w, a - w, bb + w
            dec[..., q] = c01 > c00
            dec[..., q + half] = c11 > c10
            nw[..., q] = np.where(dec[..., q], c01, c00)
            nw[..., q + half] = np.where(dec[..., q + half], c11, c10)
        d = dec.reshape(warps, geo.spw, geo.tps, geo.r).astype(np.uint64)
        words[:, t] = (d << lanes[None, :, :, None]).sum(axis=(1, 2))
        pm = nw
        if j == geo.rl - 1:  # level r (slot h: state h*tps + i) -> level 0
            full = np.empty((bp, geo.ns), np.int64)
            for h in range(geo.r):
                full[:, h * geo.tps + np.arange(geo.tps)] = pm[..., h]
            pm = full.reshape(bp, geo.tps, geo.r)
    return words.astype(np.uint32), pm, n_steps % geo.rl


def model_reduce(pm, jf, geo):
    """Top-2 (ties counting) and first argmax of each group: the thread's
    scan over its slots, then a xor-shuffle tree over the lanes."""
    bp = pm.shape[0]
    top1 = pm[..., 0].copy()
    top2 = np.full(top1.shape, np.iinfo(np.int64).min)
    best = np.full(top1.shape, 0, np.int64)
    for i in range(geo.tps):
        best[:, i] = geo.state_of(0, jf, i)
    for q in range(1, geo.r):
        v = pm[..., q]
        s = np.array([geo.state_of(q, jf, i) for i in range(geo.tps)])[None]
        gt, eq = v > top1, v == top1
        new2 = np.where(gt, top1, np.where(eq, v, np.maximum(top2, v)))
        best = np.where(gt, s, np.where(eq, np.minimum(best, s), best))
        top1 = np.where(gt, v, top1)
        top2 = new2
    off = 1
    while off < geo.tps:
        p = np.arange(geo.tps) ^ off
        o1, o2, ob = top1[:, p], top2[:, p], best[:, p]
        n2 = np.maximum(np.minimum(top1, o1), np.maximum(top2, o2))
        best = np.where(o1 > top1, ob,
                        np.where(top1 > o1, best, np.minimum(best, ob)))
        top1 = np.maximum(top1, o1)
        top2 = n2
        off <<= 1
    assert (top1 == top1[:, :1]).all() and (best == best[:, :1]).all()
    return top1[:, 0], top2[:, 0], best[:, 0]


def model_walk(words, grp, best, n_steps, geo):
    """The traceback of group ``grp`` of a warp (its decision words
    [L, R]), read as the kernel reads them."""
    m, rl, r, ns, chunk = geo.m, geo.rl, geo.r, geo.ns, geo.chunk
    cp = CHUNK_PERIODS
    out = np.zeros(n_steps, np.uint8)
    for k in range(min(m, n_steps)):
        out[n_steps - 1 - k] = (best >> (m - 1 - k)) & 1
    if n_steps <= m:
        return out
    p_top, p_bot = (n_steps - 1) // rl, m // rl
    c_top, c_bot = (n_steps - 1) // chunk, m // chunk
    ring = np.full((3, chunk * r), 0xA5A5A5A5, np.uint32)
    pending = []

    def load_chunk(c):
        first = c * chunk
        cnt = min(chunk, n_steps - first)
        pending.append((c % 3, words[first:first + cnt].reshape(-1)))

    def wait():
        for slot, data in pending:
            ring[slot, :len(data)] = data
        pending.clear()

    def load_period(p):
        """A period's decision words, a period ahead of its walk."""
        at = (p % cp) * rl * r
        return ring[(p // cp) % 3, at:at + rl * r].reshape(rl, r).copy()

    def lookup(j, words, s):
        gb = rl - j - 1
        q = ((s >> (m - j - 1)) << gb) | (s & ((1 << gb) - 1))
        i = (s >> gb) & (geo.tps - 1)
        return (int(words[j, q]) >> (grp * geo.tps + i)) & 1

    obuf = np.zeros(cp, np.uint8)
    s, d = best >> 1, best & 1

    def walk(p, words):
        nonlocal s, d
        ob = 0
        for j in range(rl - 1, -1, -1):
            if p * rl + j <= n_steps - 1:  # steps below m walked, unused
                base = (s << 1) & (ns - 2)
                t0, t1 = lookup(j, words, base), lookup(j, words, base | 1)
                s, d = base | d, (t1 if d else t0)
                ob |= d << j
        obuf[p % cp] = ob

    def flush(c):
        lo, hi = max(c * chunk, m) - m, min((c + 1) * chunk, n_steps) - m
        for pos in range(lo, hi):
            t = pos + m
            out[pos] = (obuf[(t // rl) % cp] >> (t % rl)) & 1

    load_chunk(c_top)
    if c_top - 1 >= c_bot:
        load_chunk(c_top - 1)
    wait()
    if c_top - 2 >= c_bot:
        load_chunk(c_top - 2)
    cur = load_period(p_top - 1)
    walk(p_top, load_period(p_top))
    if p_top % cp == 0:
        flush(c_top)
    for c in range((p_top - 1) // cp, c_bot - 1, -1):
        if c != c_top:
            wait()
            if c - 2 >= c_bot:
                load_chunk(c - 2)
        for p in range(min(p_top - 1, (c + 1) * cp - 1),
                       max(p_bot, c * cp) - 1, -1):
            nxt = load_period(p - 1)
            walk(p, cur)
            cur = nxt
        flush(c)
    return out


def model(ext, k, gens):
    """The kernel's outputs: (bits [B, L] uint8, margin [B] float32)."""
    geo = Geometry(k, gens)
    b, n_steps, _ = ext.shape
    words, pm, jf = model_forward(ext, geo)
    top1, top2, best = model_reduce(pm, jf, geo)
    bits = np.stack([model_walk(words[i // geo.spw], i % geo.spw,
                                int(best[i]), n_steps, geo)
                     for i in range(b)])
    return bits, (top1[:b] - top2[:b]).astype(np.float32)


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fn(k, gens):
    return jax.jit(lambda x: _acs_traceback(x, k, gens))


@functools.lru_cache(maxsize=None)
def _case(k, gens, n_steps, segs):
    """Every input kind of one shape, and JAX's answer for all of them in
    one call."""
    ext = np.concatenate([_ext(kind, k, gens, n_steps, segs, 90 + i)
                          for i, kind in enumerate(KINDS)])
    bits, margin = _jax_fn(k, gens)(jnp.asarray(ext))
    return ext, np.asarray(bits), np.asarray(margin)


def _kind(arrays, kind, segs):
    i = KINDS.index(kind)
    return [a[i * segs:(i + 1) * segs] for a in arrays]


@pytest.mark.parametrize("k,gens,n_steps,segs", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_jax(k, gens, n_steps, segs, kind):
    ext, jb, jm = _kind(_case(k, gens, n_steps, segs), kind, segs)
    bits, margin = model(ext, k, gens)
    np.testing.assert_array_equal(bits, jb)
    np.testing.assert_array_equal(margin, jm)


@pytest.mark.parametrize("k,gens,n_steps,segs", CASES)
def test_plain_matches_jax(k, gens, n_steps, segs):
    ext, jb, jm = _case(k, gens, n_steps, segs)
    bits, margin = CV.acs_traceback_plain(torch.from_numpy(ext), gens, k)
    np.testing.assert_array_equal(bits.numpy(), jb)
    np.testing.assert_array_equal(margin.numpy(), jm)


@pytest.mark.parametrize("k,gens", [(7, C.CONV_K7_GEN),
                                    (9, C.CONV_E1_GEN)])
@pytest.mark.parametrize("n_steps", [1, 5, 9, 40, 191])
def test_model_short_and_ragged(k, gens, n_steps):
    """Segments no longer than the state (no walk), a partial last period,
    a top period above a chunk's end; 5 segments (a ragged last warp)."""
    ext = _ext("int8", k, gens, n_steps, 5, n_steps)
    jb, jm = _jax_fn(k, gens)(jnp.asarray(ext))
    bits, margin = model(ext, k, gens)
    np.testing.assert_array_equal(bits, np.asarray(jb))
    np.testing.assert_array_equal(margin, np.asarray(jm))
