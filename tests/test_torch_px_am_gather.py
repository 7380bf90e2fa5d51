"""K15 (the AM channel gathers, csrc/am_gather.cu), K11 (the PX
interleaver-IV deinterleave, csrc/px_deinterleave.cu) and K7's int8 input
at K=9, as their kernels compute them, held on the CPU to the port's plain
versions and to JAX.  The kernels run only on a card
(tests/test_torch_kernels.py); here a numpy model of each kernel's tiling
is checked:

- K15: a grid of (4 CTAs, S x F frames) of 1024 threads; each CTA stages
  its frame's bytes (the frame's 25600 codes, its 8 blocks' 512 PIDS
  codes, then an 18000-byte slice a delayed line: the carried line's bytes
  [18000 f, 18000 (f + 1)) for frame f < 3, frame f - 3's bits of the
  stream, gathered through the map's line entries, for f >= 3); the
  frame's 16-output chunks (P1, P3, PIDS, then the fresh line bits where
  the frame's bits stay on the line) go in blocks of 1024 chunks to the
  frame's CTAs in turn, each entry of the composed map, read from its
  3-byte packing, a bit address into the staged bytes or -1; frame 0's
  CTAs copy the kept part of each delayed line.  Every output written
  once, int8, equal to ``am_gather_plain``; the lines a mode does not
  delay handed back as the same tensors.
- K11: a CTA a station and two consecutive pairs p0, p0 + 1 stages region
  q of the state as p0 sees it (pair p0 - d's soft bits, d = (ph - q) mod
  calls or calls, else the entry state's region) and the two pairs' own
  soft bits, and gathers each pair's row of K7 input, 8 trellis steps a
  chunk, through its row of ``px_tables`` (read from the 3-byte packing:
  two entries a step, the step's middle input written 0); the new state's
  regions
  are whole copies of staged runs (the newest pair at the phase, else the
  entry state's region, by one of the station's CTAs), the phases one a
  station.  Every output written once, equal to ``px_deinterleave_plain``.
- The int8 plain outputs equal JAX's float32 values, and K7's plain
  version at K=9 on int8 gives the bits and margins of float32.

Inputs are made with numpy from seeds.  Torch runs on one thread.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nrsc5_tpu import constants as JC
from nrsc5_tpu.ops import convolutional as JCV
from nrsc5_tpu.ops import decode_am as JDA
from nrsc5_tpu.pipeline import scan_chain as JSC
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import convolutional as TCV
from nrsc5_tpu_torch.ops import decode_am as DA
from nrsc5_tpu_torch.ops import decode_fm as DF
from nrsc5_tpu_torch.ops import interleavers as IL

K15_TILES = 4  # CTAs a (station, frame)
K15_THREADS = 1024  # a CTA's threads; chunks go to CTAs in blocks of as many
K15_VEC = 16  # outputs a chunk
K11_PAIRS = 2  # pairs a CTA
K11_STEPS = 8  # trellis steps a chunk: 16 table entries, 24 outputs
SEG = 18000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _am_inputs(seed, s, n_frames):
    rng = np.random.default_rng(seed)
    nb = 8 * n_frames
    codes = rng.integers(0, 64, (s, nb, 4, 800)).astype(np.uint8)
    pids = rng.integers(0, 16, (s, nb, 32, 2)).astype(np.uint8)
    lines = rng.integers(0, 2, (4, s, DA.DD)).astype(np.uint8)
    return codes, pids, lines


def unpack3(packed: np.ndarray) -> np.ndarray:
    """The kernels' 3-byte entries -> int32 (e + 1 little-endian)."""
    b = packed.reshape(packed.shape[:-1] + (-1, 3)).astype(np.int64)
    return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16).astype(np.int32) - 1


def _k15_model(codes, pids, lines, ma3):
    """K15's grid as numpy: returns (p1, p3, pids int8 flat, new lines
    [4, S, 54000] with the undelayed ones untouched)."""
    g = DA.gather_maps(ma3)
    s, nb = codes.shape[:2]
    f_n = nb // 8
    m1, m3, mp, nd = g["m1"], g["m3"], g["mp"], g["n_delayed"]
    emap = unpack3(DA.packed_map(ma3))
    assert np.array_equal(emap, g["map"])
    line_map = emap[m1 + m3 + mp:]
    frames = codes.reshape(s * f_n, -1)
    pframes = pids.reshape(s * f_n, -1)
    outs = {k: np.full(s * f_n * n, 7, np.int8)
            for k, n in (("p1", m1), ("p3", m3), ("pids", mp))}
    new = lines.copy()
    written = {k: np.zeros(v.size, np.int32) for k, v in outs.items()}
    line_written = np.zeros((nd, s, DA.DD), np.int32)
    for sf in range(s * f_n):
        st, f = divmod(sf, f_n)
        if f < 3:
            sl = lines[:nd, st, SEG * f:SEG * (f + 1)].reshape(-1)
        else:
            prev = frames[sf - 3]
            sl = (prev[line_map >> 3] >> (line_map & 7)) & 1
        staged = np.concatenate([frames[sf], pframes[sf], sl])
        assert staged.size == DA.LINE_BASE + nd * SEG
        keep = DA.DD - SEG * f_n
        total = m1 + m3 + mp + (nd * SEG if f_n - f <= 3 else 0)
        chunks = total // K15_VEC
        for tile in range(K15_TILES):
            if f == 0 and keep > 0:  # the kept part, 16 bytes a step
                per = keep // 16
                i = np.arange(tile * K15_THREADS, nd * per,
                              K15_TILES * K15_THREADS)
                i = (i[:, None] + np.arange(K15_THREADS)).reshape(-1)
                i = i[i < nd * per]
                d, v = i // per, i % per
                for b in range(16):
                    at = 16 * v + b
                    new[d, st, at] = lines[d, st, at + SEG * f_n]
                    line_written[d, st, at] += 1
            # blocks of K15_THREADS chunks, the frame's CTAs in turn
            c = np.arange(chunks)
            c = c[(c // K15_THREADS) % K15_TILES == tile]
            m = (c[:, None] * K15_VEC + np.arange(K15_VEC)).reshape(-1)
            e = emap[m]
            a = np.maximum(e, 0)
            bit = (staged[a >> 3] >> (a & 7)) & 1
            val = np.where(e < 0, 0, 2 * bit.astype(np.int8) - 1)
            for key, lo, n in (("p1", 0, m1), ("p3", m1, m3),
                               ("pids", m1 + m3, mp)):
                sel = (m >= lo) & (m < lo + n)
                at = sf * n + m[sel] - lo
                outs[key][at] = val[sel]
                written[key][at] += 1
            sel = m >= m1 + m3 + mp
            i = m[sel] - m1 - m3 - mp
            d, idx = i // SEG, i % SEG
            at = DA.DD - SEG * (f_n - f) + idx
            new[d, st, at] = bit[sel]
            line_written[d, st, at] += 1
    for key in outs:
        assert (written[key] == 1).all(), key
    assert (line_written == 1).all()
    return outs["p1"], outs["p3"], outs["pids"], new


@pytest.mark.parametrize("ma3,n_frames,s", [
    (False, 1, 1), (False, 2, 3), (False, 4, 1), (True, 1, 3), (True, 2, 1),
    (True, 4, 3)])
def test_k15_model(ma3, n_frames, s):
    """K15's staged frames, packed composed map and split over 4 CTAs a
    frame equal ``am_gather_plain`` bit for bit: 1 frame (two thirds of
    each line kept), 2 (the main path's), 4 (frame 3 reading frame 0's
    bits)."""
    codes, pids, lines = _am_inputs(100 + 10 * n_frames + s + ma3, s,
                                    n_frames)
    p1, p3, pe, new = _k15_model(codes, pids, lines, ma3)
    state = DA.AMDecodeState(*(torch.from_numpy(x) for x in lines))
    w1, w3, wp, wst = DA.am_gather_plain(torch.from_numpy(codes),
                                         torch.from_numpy(pids), state, ma3)
    for got, want in ((p1, w1), (p3, w3), (pe, wp)):
        assert want.dtype == torch.int8
        assert np.array_equal(got, want.numpy().reshape(-1))
    for d in range(4):
        assert np.array_equal(new[d], wst[d].numpy()), DA.DELAYED[d]


@pytest.mark.parametrize("mode", ["ma1", "ma3"])
def test_am_gather_undelayed_lines_shared(mode):
    """The lines a mode does not delay (eml, emu in MA1) come back as the
    same tensors; the delayed ones are new tensors, the inputs untouched."""
    ma3 = mode == "ma3"
    codes, pids, lines = _am_inputs(7 + ma3, 2, 2)
    state = DA.AMDecodeState(*(torch.from_numpy(x.copy()) for x in lines))
    *_, new = DA.am_gather(torch.from_numpy(codes), torch.from_numpy(pids),
                           state, ma3)
    nd = DA.gather_maps(ma3)["n_delayed"]
    assert nd == (4 if ma3 else 2)
    for d, (a, b) in enumerate(zip(state, new)):
        assert (a is b) == (d >= nd), DA.DELAYED[d]
        assert np.array_equal(a.numpy(), lines[d])


@pytest.mark.parametrize("mode", ["ma1", "ma3"])
def test_am_gather_plain_int8_matches_jax(mode):
    """``am_gather_plain``'s int8 K7 inputs hold JAX's float32 values:
    am_frame_gather over 4 frames of 2 stations, cut into the AM chunk
    plan's segments, and the new lines."""
    ma3 = mode == "ma3"
    s, n_frames = 2, 4
    codes, pids, lines = _am_inputs(31 + ma3, s, n_frames)
    state = DA.AMDecodeState(*(torch.from_numpy(x) for x in lines))
    p1, p3, _, new = DA.am_gather_plain(torch.from_numpy(codes),
                                        torch.from_numpy(pids), state, ma3)
    g = DA.gather_maps(ma3)
    seg1 = JCV._chunk_plan(JC.P1_FRAME_LEN_AM, 1024, 160)[0]
    seg3 = JCV._chunk_plan(g["t3"], 1024, 160)[0]
    p1 = p1.numpy().reshape(s, n_frames, -1)
    p3 = p3.numpy().reshape(s, n_frames, -1)
    for i in range(s):
        st = JDA.AMDecodeState(*(jnp.asarray(x[i]) for x in lines))
        for f in range(n_frames):
            mats = [jnp.asarray(codes[i, 8 * f:8 * f + 8, m].reshape(-1))
                    for m in range(4)]
            j1, j3, st = JDA.am_frame_gather(*mats, st, ma3)
            assert np.array_equal(p1[i, f], np.asarray(j1)[:, seg1]
                                  .reshape(-1)), (i, f)
            assert np.array_equal(p3[i, f], np.asarray(j3)[seg3]
                                  .reshape(-1)), (i, f)
        for a, b in zip(new, st):
            assert np.array_equal(a[i].numpy(), np.asarray(b))


def _px_inputs(fl, phase, pairs, s=2):
    rng = np.random.default_rng(fl + 3 * phase + pairs)
    _, n, calls = IL.p3_iv_tables(fl)
    llr = rng.integers(-127, 128, (s, 2 * pairs, fl)).astype(np.int8)
    internal = rng.integers(-127, 128, (s, n)).astype(np.int8)
    ph = ((phase + np.arange(s) * 5) % calls).astype(np.int32)
    return llr, internal, ph


def _k11_model(llr, internal, phase):
    """K11's grid as numpy: a CTA a station and group of two pairs."""
    s, two_p, fl = llr.shape
    pairs, call_len = two_p // 2, 2 * fl
    _, n, calls = IL.p3_iv_tables(fl)
    table = unpack3(DF.pack3(DF.px_tables(fl)))
    assert np.array_equal(table, DF.px_tables(fl))
    assert table.shape[0] == K11_PAIRS
    steps = table.shape[-1] // 2
    map_len = 3 * steps
    # whole chunks a row: 48 table bytes (three 16-byte loads), 24 outputs
    # (three 8-byte stores)
    assert steps % K11_STEPS == 0 and map_len % 8 == 0
    groups = -(-pairs // K11_PAIRS)
    rows = llr.reshape(s, pairs, call_len)
    ext = np.full((s * pairs, map_len), 7, np.int8)
    new = np.zeros_like(internal)
    region_writes = np.zeros((s, calls), np.int32)
    new_phase = np.full(s, -1, np.int32)
    for st in range(s):
        ph0 = int(phase[st]) % calls
        for grp in range(groups):
            p0 = grp * K11_PAIRS
            kn = min(K11_PAIRS, pairs - p0)
            phf = (ph0 + p0) % calls
            runs = []
            for q in range(calls):
                d = (phf - q) % calls or calls
                pp = p0 - d
                runs.append(rows[st, pp] if pp >= 0
                            else internal[st, q * call_len:(q + 1) * call_len])
            runs += [rows[st, p0 + k] for k in range(kn)]
            staged = np.concatenate(runs)
            for k in range(kn):
                if p0 + k + calls >= pairs:  # the newest at its phase
                    q = (phf + k) % calls
                    new[st, q * call_len:(q + 1) * call_len] = \
                        staged[(calls + k) * call_len:
                               (calls + k + 1) * call_len]
                    region_writes[st, q] += 1
                e = table[k, (phf + k) % calls]
                row = ext[st * pairs + p0 + k].reshape(-1, K11_STEPS, 3)
                for cl, ec in enumerate(e.reshape(-1, K11_STEPS, 2)):
                    row[cl, :, 0] = staged[ec[:, 0]]
                    row[cl, :, 1] = 0
                    row[cl, :, 2] = staged[ec[:, 1]]
            for q in range(calls):
                k = (q - ph0) % calls
                if k >= pairs and (k - pairs) % groups == grp:
                    new[st, q * call_len:(q + 1) * call_len] = \
                        staged[q * call_len:(q + 1) * call_len]
                    region_writes[st, q] += 1
            if grp == 0:
                new_phase[st] = (ph0 + pairs) % calls
    assert (region_writes == 1).all()
    return ext, new, new_phase


@pytest.mark.parametrize("pairs", [3, 18])
@pytest.mark.parametrize("phase", [0, 15])
@pytest.mark.parametrize("fl", [2304, 4608])
def test_k11_model(fl, phase, pairs):
    """K11's staged regions and fresh rows, two pairs a CTA, through
    ``px_tables`` equal ``px_deinterleave_plain``: MP2 and MP3, phase 0
    and 15 (two stations, the second 5 phases on), fewer pairs than a
    cycle and more (an odd count: the last CTA takes one pair)."""
    llr, internal, ph = _px_inputs(fl, phase, pairs)
    ext, new, new_ph = _k11_model(llr, internal, ph)
    w_ext, w_new, w_ph = DF.px_deinterleave_plain(
        torch.from_numpy(llr), torch.from_numpy(internal),
        torch.from_numpy(ph))
    assert w_ext.dtype == torch.int8
    assert np.array_equal(ext, w_ext.numpy().reshape(ext.shape))
    assert np.array_equal(new, w_new.numpy())
    assert np.array_equal(new_ph, w_ph.numpy())


@pytest.mark.parametrize("fl", [2304, 4608])
def test_px_deinterleave_plain_int8_matches_jax(fl):
    """``px_deinterleave_plain``'s int8 K7 input holds JAX's float32
    px_scan_pairs(decode=False) values, wrap and all."""
    pairs, phase = 5, 13
    llr, internal, ph = _px_inputs(fl, phase, pairs, s=1)
    jout, jst = JSC.px_scan_pairs(
        (jnp.asarray(llr[0]),), 2 * pairs, 0, fl, 0,
        {"px1": (jnp.asarray(internal[0]), jnp.int32(ph[0]))}, decode=False)
    ext, new, _ = DF.px_deinterleave_plain(torch.from_numpy(llr),
                                           torch.from_numpy(internal),
                                           torch.from_numpy(ph))
    assert ext.dtype == torch.int8
    w = DF.WRAP
    full = ext.reshape(pairs, fl + 2 * w, 3)
    assert np.array_equal(full[:, w:w + fl].numpy(),
                          np.asarray(jout["px1_full"]))
    assert torch.equal(full[:, :w], full[:, fl:fl + w])
    assert np.array_equal(new.numpy()[0], np.asarray(jst["px1"][0]))


def test_px_tables_hazard_reads():
    """Each table entry lies in the staged runs; a call's fresh reads (its
    own soft bits, at (calls + k) L on) are exactly the hazard positions;
    the second pair of a group reads the first pair's phase region from
    that pair's soft bits."""
    for fl in (2304, 4608):
        read_idx, n, calls = IL.p3_iv_tables(fl)
        hazard = IL.p3_iv_hazard(fl)
        t = DF.px_tables(fl).astype(np.int64)
        call_len = n // calls
        k7 = DF.channel_tables(f"px{fl}")["k7_map"]
        # only each trellis step's middle input is punctured, and the
        # table holds the other two
        assert np.array_equal(k7 < 0, np.arange(k7.size) % 3 == 1)
        k7 = k7[k7 >= 0]
        assert t.shape == (2, calls, k7.size)
        assert t.min() >= 0 and t.max() < (calls + 2) * call_len
        ph, m = np.nonzero(t[0] >= calls * call_len)
        assert hazard[ph * call_len + k7[m]].all()
        assert hazard.sum() > 0
        own = t[1] >= (calls + 1) * call_len
        assert np.array_equal(t[1][own] - call_len, t[0][own])
        moved = (t[1] >= calls * call_len) & ~own
        ph, m = np.nonzero(moved)
        assert (t[0][ph, m] // call_len == (ph - 1) % calls).all()
        assert np.array_equal(t[1][~moved & ~own], t[0][~moved & ~own])


@pytest.mark.parametrize("channel", ["p1", "p3_ma1", "p3_ma3", "pids"])
def test_acs_traceback_plain_int8_k9(channel):
    """K7's plain version at K=9 on K15's int8 segments (two of each
    channel, from random codes) gives the bits and margins of the same
    values in float32."""
    ma3 = channel == "p3_ma3"
    codes, pids, lines = _am_inputs(61 + ma3, 1, 1)
    state = DA.AMDecodeState(*(torch.from_numpy(x) for x in lines))
    p1, p3, pe, _ = DA.am_gather_plain(torch.from_numpy(codes),
                                       torch.from_numpy(pids), state, ma3)
    ext = {"p1": p1, "p3_ma1": p3, "p3_ma3": p3, "pids": pe}[channel][:2]
    gens = C.CONV_E1_GEN if channel in ("p1", "p3_ma3") \
        else C.CONV_E2_E3_GEN
    assert ext.dtype == torch.int8
    kb, km = TCV.acs_traceback_plain(ext, gens, 9)
    fb, fm = TCV.acs_traceback_plain(ext.float(), gens, 9)
    assert torch.equal(kb, fb) and torch.equal(km, fm)
