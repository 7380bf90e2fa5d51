"""The PyTorch port's AM chain against the JAX package, on the CPU.

The same inputs, made by numpy from a seed, go through the JAX function and
its port, per module of the slice (K12's acquire, K13's sync block, K15's
gathers and their composed index maps, K7 at K=9, the PIDS decode, the
cs16 ingest) and for the slice as a whole (two distinct stations, five
frames of MA1 and of MA3, the shapes tests/test_scan_chain.py already
compiles).  JAX runs on the CPU as tests/conftest.py pins it; the port runs
its plain PyTorch versions, which is what a kernel wrapper does with a CPU
tensor.

Tolerances, with their reasons:

=====================================  =================================
output                                 tolerance
=====================================  =================================
decoded P1, P3 and PIDS bits, P1 and   exact (the slice's result)
P3 margins
QAM codes, PIDS codes, reference bits  exact on the inputs here (no code
and samperr of the sync block          lies within float rounding of a
                                       decision threshold)
Viterbi bits and margins               exact on equal LLRs: integer LLRs
                                       make every path metric an integer,
                                       exact in float32 in any order
K15's LLRs and delay lines, the cs16   exact: gathers of bits, and a
ingest                                 scale by a power of two
the carry's offsets, samperr, CFO and  exact
delay lines
acquire spectra                        rtol 1e-4 with an atol of 1e-5 of
                                       the largest value; phase and angle
                                       1e-6: the frameworks sum the DFT
                                       and the pilot fit in other orders
the carry's phase and prev_angle       atol 1e-4 (phase) and 1e-5
after five frames                      (prev_angle): the DFT rounds its
                                       input to bfloat16, so a last-bit
                                       difference can cross a bf16
                                       rounding edge and move a block's
                                       spectra by ~1e-5; the pilot fit
                                       carries that into the next block's
                                       phase (measured here: up to 2.5e-5
                                       and 1e-6)
=====================================  =================================
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nrsc5_tpu import constants as JC
from nrsc5_tpu.ops import convolutional as JCV
from nrsc5_tpu.ops import decode_am as JDA
from nrsc5_tpu.ops import scramble as JSC
from nrsc5_tpu.pipeline import scan_chain_am_rc as JAR
from nrsc5_tpu.tx import channel as JCH
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import serve, state
from nrsc5_tpu_torch.ops import convolutional as TCV
from nrsc5_tpu_torch.ops import decode_am as TDA
from nrsc5_tpu_torch.ops import decode_fm as TDF
from nrsc5_tpu_torch.ops.bits import unpack_bits
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as TAR
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx import encoder_am as EAM
from nrsc5_tpu_torch.tx.modulator_am import modulate_am

N_STATIONS, N_FRAMES = 2, 5
MODES = {"ma1": False, "ma3": True}
LINES = ("ml", "mu", "eml", "emu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(rng, *shape):
    return rng.integers(0, 2, shape).astype(np.uint8)


def _station(rng, ma3, n_frames, snr_db=None, cfo_hz=0.0):
    """One station's frame-aligned rc buffer [am_buffer_len, 2] (first
    symbol FFTCP_AM // 2 in, bc 0 first) and its transmitted bits."""
    p3_len = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    p1 = _bits(rng, n_frames, 8, C.P1_FRAME_LEN_AM)
    p3 = _bits(rng, n_frames, p3_len)
    pids = _bits(rng, 8 * n_frames, C.PIDS_FRAME_LEN)
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(p1[f]) for f in range(n_frames)],
        [EAM.encode_p3_am(p3[f], ma3) for f in range(n_frames)], ma3)
    ref = np.stack([EAM.am_ref_bits(b % 8, 2 if ma3 else 1)
                    for b in range(8 * n_frames)])
    sig = modulate_am(mats, np.stack([EAM.encode_pids_am(p) for p in pids]),
                      ref, ma3)
    if snr_db is not None:
        sig = ch.impair(sig, sample_rate=C.SAMPLE_RATE_CS16_AM,
                        cfo_hz=cfo_hz, snr_db=snr_db, rng=rng)
    buf = np.zeros((TAR.am_buffer_len(n_frames), 2), np.float32)
    start = C.FFTCP_AM // 2
    buf[start:start + len(sig)] = np.stack([sig.real, sig.imag], -1)
    return buf, (p1, p3, pids)


def _jax_carries(n):
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[JAR.am_chain_rc_init_carry() for _ in range(n)])


def _jax_carry_numpy(jc):
    """A JAX AM carry as the port's numpy dict (the delay lines under their
    own names)."""
    d = {k: np.asarray(getattr(jc, k)) for k in ("offset", "phase",
                                                  "prev_angle", "samperr_fb",
                                                  "cfo")}
    d.update({k: np.asarray(getattr(jc.dec, k)) for k in LINES})
    return d


@pytest.fixture(scope="module", params=sorted(MODES))
def chain_run(request):
    """Two distinct noiseless stations, five frames, through JAX's
    ``am_chain_batch_rc`` and the port's, from fresh carries."""
    ma3 = MODES[request.param]
    rng = np.random.default_rng(0xA11 + ma3)
    stations = [_station(rng, ma3, N_FRAMES) for _ in range(N_STATIONS)]
    bufs = np.stack([s[0] for s in stations])
    jo, jc = JAR.am_chain_batch_rc(jnp.asarray(bufs),
                                   _jax_carries(N_STATIONS), N_FRAMES, ma3)
    to, tc = TAR.am_chain_batch_rc(
        _t(bufs), TAR.am_chain_rc_init_carry(n_stations=N_STATIONS,
                                             device="cpu"), N_FRAMES, ma3)
    return {"ma3": ma3, "bufs": bufs, "truth": [s[1] for s in stations],
            "jax": ({k: np.asarray(v) for k, v in jo.items()}, jc),
            "port": (to, tc)}


# ---------------------------------------------------------------------------
# the slice: rc buffers -> P1, P3, PIDS bits at S = 2, MA1 and MA3
# ---------------------------------------------------------------------------

def test_chain_matches_jax(chain_run):
    """The twin of test_am_chain_batch_rc_matches_scan: p1, p3, pids and
    both margins bit for bit against JAX's am_chain_batch_rc."""
    jo, _ = chain_run["jax"]
    to, _ = chain_run["port"]
    assert set(to) == set(jo)
    for k in jo:
        assert to[k].shape == jo[k].shape, k
        assert np.array_equal(to[k].numpy(), jo[k]), k


def test_chain_carry_matches_jax(chain_run):
    _, jc = chain_run["jax"]
    _, tc = chain_run["port"]
    got = state.am_carry_to_numpy(tc)
    want = _jax_carry_numpy(jc)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        if k == "phase":
            np.testing.assert_allclose(got[k], want[k], atol=1e-4)
        elif k == "prev_angle":
            np.testing.assert_allclose(got[k], want[k], atol=1e-5)
        else:
            assert np.array_equal(got[k], want[k]), k


def test_chain_decodes_transmitted_bits(chain_run):
    """Frames 3+ (after the diversity warm-up) and every PIDS word equal
    the transmitted bits."""
    to, _ = chain_run["port"]
    for s, (p1, p3, pids) in enumerate(chain_run["truth"]):
        assert np.array_equal(to["p1"][s, 3:].numpy(), p1[3:])
        assert np.array_equal(to["p3"][s, 3:].numpy(), p3[3:])
        assert np.array_equal(to["pids"][s].numpy(), pids)


def test_carry_handover(chain_run):
    """JAX decodes two frames and hands its carry over as numpy; the port
    decodes the three frames after it from the same buffers: the bits and
    margins equal JAX decoding all five in one go."""
    ma3 = chain_run["ma3"]
    bufs = chain_run["bufs"]
    jo, _ = chain_run["jax"]
    _, jc = JAR.am_chain_batch_rc(jnp.asarray(bufs), _jax_carries(N_STATIONS),
                                  2, ma3)
    carry = state.am_carry_from_numpy(_jax_carry_numpy(jc), device="cpu")
    out, _ = TAR.am_chain_batch_rc(_t(bufs), carry, N_FRAMES - 2, ma3)
    for k in ("p1", "p3", "p1_margin", "p3_margin"):
        assert np.array_equal(out[k].numpy(), jo[k][:, 2:]), k
    assert np.array_equal(out["pids"].numpy(), jo["pids"][:, 16:])


def test_chain_matches_complex_at_35db():
    """The twin of test_am_rc_chain_matches_complex: one MA1 station at 35
    dB with an 8 Hz CFO, six frames, through serve.chain_step_am on the
    cs16 wire.  Frames 3+ equal the transmitted bits, all PIDS too, and
    every output equals JAX's am_chain_scan_rc on the same ingested
    samples."""
    rng = np.random.default_rng(0xC5)
    buf, (p1, p3, pids) = _station(rng, False, 6, snr_db=35.0, cfo_hz=8.0)
    wire = np.clip(np.round(buf * 32768), -32768, 32767).astype(np.int16)
    out, _ = serve.chain_step_am(wire[None], TAR.am_chain_rc_init_carry(
        device="cpu"), 6, device="cpu")
    assert np.array_equal(out["p1"][0, 3:].numpy(), p1[3:])
    assert np.array_equal(out["p3"][0, 3:].numpy(), p3[3:])
    assert np.array_equal(out["pids"][0].numpy(), pids)
    x = jnp.asarray(wire).astype(jnp.float32) * (1.0 / 32768.0)
    jo, _ = JAR.am_chain_scan_rc(x, JAR.am_chain_rc_init_carry(), 6, False)
    # the one-station entry point, on a carry without the station axis
    fresh = TAR.am_chain_rc_init_carry(device="cpu")
    one, _ = TAR.am_chain_scan_rc(
        serve.ingest(wire[None], "am", device="cpu")[0],
        TAR.AMChainCarryRC(*(v[0] for v in fresh[:-1]),
                           TDA.AMDecodeState(*(v[0] for v in fresh.dec))),
        6)
    for k, v in jo.items():
        assert np.array_equal(out[k][0].numpy(), np.asarray(v)), k
        assert torch.equal(one[k], out[k][0]), k


def test_chain_step_am_packed(chain_run):
    """packed=True packs each frame's 8 x 3750 P1 bits flattened, P3 and
    PIDS, 8 to a byte little-endian: unpacked they equal the bits."""
    wire = np.round(chain_run["bufs"] * 32768).astype(np.int16)
    carry = TAR.am_chain_rc_init_carry(n_stations=N_STATIONS, device="cpu")
    ma3 = chain_run["ma3"]
    plain, _ = serve.chain_step_am(wire, carry, N_FRAMES, ma3, device="cpu")
    packed, _ = serve.chain_step_am(wire, carry, N_FRAMES, ma3, packed=True,
                                    device="cpu")
    assert packed["p1"].shape == (N_STATIONS, N_FRAMES, 3750)
    assert np.array_equal(unpack_bits(packed["p1"]),
                          plain["p1"].numpy().reshape(N_STATIONS, N_FRAMES,
                                                      -1))
    for k in ("p3", "pids"):
        assert np.array_equal(unpack_bits(packed[k]), plain[k].numpy()), k
    for k in ("p1_margin", "p3_margin"):
        assert torch.equal(packed[k], plain[k]), k


# ---------------------------------------------------------------------------
# per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def am_window():
    """Two blocks of one MA1 station at 35 dB with a 9 Hz CFO, as rc."""
    rng = np.random.default_rng(3)
    buf, _ = _station(rng, False, 1, snr_db=35.0, cfo_hz=9.0)
    return buf


# (phase, prev_angle, samperr_fb, cfo)
ACQ_CASES = [((1.0, 0.0), 0.0, 0, 0), ((0.6, 0.8), 0.01, 2, 1),
             ((0.8, -0.6), -0.02, -3, -2)]


@pytest.mark.parametrize("phase,prev_angle,samperr_fb,cfo", ACQ_CASES)
def test_acquire_am_fine_matches(am_window, phase, prev_angle, samperr_fb,
                                 cfo):
    """K12's two passes with the DFTs between, against
    acquire_am_fine_rc: spectra, phase, prev_angle and keep."""
    ph = np.array(phase, np.float32)
    win = am_window[:TAR.WINDOW_AM]
    j = JAR.acquire_am_fine_rc(jnp.asarray(win), jnp.asarray(ph),
                               jnp.float32(prev_angle),
                               jnp.int32(samperr_fb), jnp.int32(cfo))
    t = TAR.acquire_am_fine_rc(
        _t(am_window)[None], torch.zeros(1, dtype=torch.int32),
        _t(ph)[None], torch.tensor([samperr_fb], dtype=torch.int32),
        torch.tensor([prev_angle]), torch.tensor([cfo], dtype=torch.int32))
    js = np.asarray(j[0])
    np.testing.assert_allclose(t[0][0].numpy(), js, rtol=1e-4,
                               atol=1e-5 * np.abs(js).max())
    np.testing.assert_allclose(t[1][0].numpy(), np.asarray(j[1]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(t[2][0]), float(j[2]), rtol=1e-4,
                               atol=1e-6)
    assert int(t[3][0]) == int(j[4])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sync_am_block_matches(mode):
    """K13 against sync_am_block_rc on the same spectra (a 35 dB block
    with a 6 Hz CFO, demodulated by JAX's acquire): every code, PIDS code
    and reference bit, and samperr."""
    ma3 = MODES[mode]
    rng = np.random.default_rng(4 + ma3)
    buf, _ = _station(rng, ma3, 1, snr_db=35.0, cfo_hz=6.0)
    spectra, *_ = JAR.acquire_am_fine_rc(
        jnp.asarray(buf[:TAR.WINDOW_AM]), jnp.asarray(np.array(
            [1.0, 0.0], np.float32)), jnp.float32(0.0), jnp.int32(0),
        jnp.int32(0))
    jo = JAR.sync_am_block_rc(spectra, ma3)
    to = TAR.sync_am_block_rc(_t(np.asarray(spectra))[None], ma3)
    for i, k in enumerate(("pl", "pu", "s", "t")):
        assert np.array_equal(to["codes"][0, i].numpy(), np.asarray(jo[k])), k
    for k in ("pids", "ref_bits", "samperr"):
        assert np.array_equal(to[k][0].numpy(), np.asarray(jo[k])), k


@pytest.mark.parametrize("mode", sorted(MODES))
def test_am_frame_gather_matches(mode):
    """The port's am_frame_gather (K15's plain version for one frame)
    against JAX's on random codes and a random delay line."""
    ma3 = MODES[mode]
    rng = np.random.default_rng(5 + ma3)
    codes = rng.integers(0, 64, (8, 4, 800)).astype(np.uint8)
    lines = _bits(rng, 4, TDA.DD)
    mats = [codes[:, i].reshape(-1) for i in range(4)]
    j = JDA.am_frame_gather(*(jnp.asarray(m) for m in mats),
                            JDA.AMDecodeState(*(jnp.asarray(x)
                                                for x in lines)), ma3)
    t = TDA.am_frame_gather(*(_t(m) for m in mats),
                            TDA.AMDecodeState(*(_t(x) for x in lines)), ma3)
    assert np.array_equal(t[0].numpy(), np.asarray(j[0]))
    assert np.array_equal(t[1].numpy(), np.asarray(j[1]))
    for a, b in zip(t[2], j[2]):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _emulate_am_gather(codes, pids, lines, ma3):
    """numpy rendering of csrc/am_gather.cu's index algebra, element for
    element: each frame's staged bytes (its codes, its PIDS codes, a slice
    a delayed line: the carried line's for frame f < 3, frame f - 3's bits
    for f >= 3), the composed map of decode_am.gather_maps read as bit
    addresses into them, the new lines."""
    g = TDA.gather_maps(ma3)
    s, nb = codes.shape[:2]
    f_n = nb // 8
    frames = codes.reshape(s, f_n, -1)
    pframes = pids.reshape(s, f_n, -1)
    m1, m3, mp, nd = g["m1"], g["m3"], g["mp"], g["n_delayed"]
    emap = g["map"]
    line_map = emap[m1 + m3 + mp:]
    e = np.maximum(emap, 0)
    out = np.zeros((s, f_n, m1 + m3 + mp), np.float32)
    new = lines.copy()
    for i in range(s):
        for f in range(f_n):
            if f < 3:
                sl = lines[i, :nd, 18000 * f:18000 * (f + 1)].reshape(-1)
            else:
                sl = (frames[i, f - 3, line_map >> 3] >> (line_map & 7)) & 1
            staged = np.concatenate([frames[i, f], pframes[i, f], sl])
            bit = (staged[e >> 3] >> (e & 7)) & 1
            out[i, f] = np.where(emap < 0, 0.0, bit * 2.0 - 1.0)[:m1 + m3 + mp]
            if f_n - f <= 3:  # this frame's fresh bits stay on the line
                at = TDA.DD - 18000 * (f_n - f)
                new[i, :nd, at:at + 18000] = bit[m1 + m3 + mp:].reshape(
                    nd, 18000)
        keep = TDA.DD - 18000 * f_n
        if keep > 0:
            new[i, :nd, :keep] = lines[i, :nd, 18000 * f_n:]
    p1 = out[..., :m1].reshape(-1, g["l1"], 3)
    p3 = out[..., m1:m1 + m3].reshape(-1, g["l3"], 3)
    pe = out[..., m1 + m3:].reshape(s * nb, -1, 3)
    return p1, p3, pe, new


@pytest.mark.parametrize("n_frames", [2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_am_gather_maps_match_jax(mode, n_frames):
    """K15's composed maps, applied as the kernel applies them, give JAX's
    am_frame_gather looped over frames (cut into the AM chunk plan's
    segments), its PIDS LLRs with the wrap extension and its new state;
    2 frames read every delayed bit from the handed-on line, 4 also from
    frame f - 3."""
    ma3 = MODES[mode]
    rng = np.random.default_rng(6 + n_frames + ma3)
    s = 2
    codes = rng.integers(0, 64, (s, 8 * n_frames, 4, 800)).astype(np.uint8)
    pids = rng.integers(0, 16, (s, 8 * n_frames, 32, 2)).astype(np.uint8)
    lines = rng.integers(0, 2, (s, 4, TDA.DD)).astype(np.uint8)
    p1, p3, pext, new = _emulate_am_gather(codes, pids, lines, ma3)
    g = TDA.gather_maps(ma3)
    seg1 = JCV._chunk_plan(C.P1_FRAME_LEN_AM, 1024, 160)[0]
    seg3 = JCV._chunk_plan(g["t3"], 1024, 160)[0]
    p1, p3 = p1.reshape(s, n_frames, -1), p3.reshape(s, n_frames, -1)
    for i in range(s):
        st = JDA.AMDecodeState(*(jnp.asarray(x) for x in lines[i]))
        for f in range(n_frames):
            mats = [jnp.asarray(codes[i, 8 * f:8 * f + 8, m].reshape(-1))
                    for m in range(4)]
            j1, j3, st = JDA.am_frame_gather(*mats, st, ma3)
            assert np.array_equal(p1[i, f], np.asarray(j1)[:, seg1]
                                  .reshape(-1)), (i, f)
            assert np.array_equal(p3[i, f], np.asarray(j3)[seg3]
                                  .reshape(-1)), (i, f)
        for a, b in zip(new[i], st):
            assert np.array_equal(a, np.asarray(b))
    # PIDS: JAX's scatter into the 240 trellis inputs, wrap-extended
    il_row, il_p, iu_row, iu_p, il_delay, iu_delay = \
        TDA.IL.am_pids_tables()
    k = np.arange(120)
    blocks = pids.reshape(-1, 32, 2)
    llr = np.zeros((len(blocks), 240), np.float32)
    llr[:, (k // 12) * 24 + il_delay[k % 12]] = \
        ((blocks[:, il_row, 0] >> il_p) & 1) * 2.0 - 1
    llr[:, (k // 12) * 24 + iu_delay[k % 12]] = \
        ((blocks[:, iu_row, 1] >> iu_p) & 1) * 2.0 - 1
    llr = llr.reshape(-1, 80, 3)
    want = np.concatenate([llr[:, 48:], llr, llr[:, :32]], axis=1)
    assert np.array_equal(pext, want)


def _noisy_llrs(rng, batch, t, gens, kind):
    """LLRs of random tail-biting K=9 codewords: the AM chain's kind (+-1
    with erasures and flips) or integer soft values through AWGN."""
    bits = _bits(rng, batch, t)
    coded = TCV.conv_encode(bits, 9, gens).reshape(batch, t, 3) * 2.0 - 1.0
    if kind == "am":
        coded[rng.random(coded.shape) < 0.04] *= -1
        coded[rng.random(coded.shape) < 0.3] = 0.0
        return coded.astype(np.float32)
    soft = coded * 40 + rng.normal(0, 40, coded.shape)
    return np.clip(np.round(soft), -127, 127).astype(np.float32)


@pytest.mark.parametrize("kind", ["am", "soft"])
def test_viterbi_k9_decode_matches(kind):
    """K7's plain version at K=9 on PIDS' 80 steps with the 32-step wrap
    each side against viterbi_decode(k=9): bits and margins."""
    llr = _noisy_llrs(np.random.default_rng(7), 24, C.PIDS_FRAME_LEN,
                      C.CONV_E2_E3_GEN, kind)
    jb, jm = JCV.viterbi_decode(jnp.asarray(llr), 9, JC.CONV_E2_E3_GEN)
    t, w = C.PIDS_FRAME_LEN, TCV.TAIL_BITING_EXTRA
    ext = np.concatenate([llr[:, t - w:], llr, llr[:, :w]], axis=1)
    tb, tm = TCV.acs_traceback_plain(_t(ext), C.CONV_E2_E3_GEN, 9)
    assert np.array_equal(tb[:, w:w + t].numpy(), np.asarray(jb))
    assert np.array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("kind", ["am", "soft"])
def test_viterbi_k9_chunked_matches(kind):
    """K7's plain version at K=9 over the AM chunk plan (1024, overlap
    160) on P1's 3750 steps, each segment's middle bits kept, against
    viterbi_decode_chunked(k=9, radix 1): bits and margins."""
    b, t = 3, C.P1_FRAME_LEN_AM
    llr = _noisy_llrs(np.random.default_rng(8), b, t, C.CONV_E1_GEN, kind)
    jb, jm = JCV.viterbi_decode_chunked(jnp.asarray(llr), 9, JC.CONV_E1_GEN,
                                        chunk=1024, overlap=160, radix=1,
                                        fuse=1)
    seg, src_chunk, src_off = TCV._chunk_plan(t, TCV.CHUNK_AM,
                                              TCV.OVERLAP_AM)
    n, length = seg.shape
    bits, margins = TCV.acs_traceback_plain(
        _t(llr[:, seg].reshape(-1, length, 3)), C.CONV_E1_GEN, 9)
    keep = src_chunk.astype(np.int64) * length + src_off
    assert np.array_equal(bits.numpy().reshape(b, -1)[:, keep],
                          np.asarray(jb))
    assert np.array_equal(margins.reshape(b, n).amin(-1).numpy(),
                          np.asarray(jm))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_am_frame_fec_matches(mode):
    """The port's am_frame_fec against JAX's on one frame of the chain's
    kind of LLRs: P1 and P3 bits and margins."""
    ma3 = MODES[mode]
    rng = np.random.default_rng(9 + ma3)
    _, pattern, gens = TDA.p3_spec(ma3)
    t3 = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    p1 = _noisy_llrs(rng, 8, C.P1_FRAME_LEN_AM, C.CONV_E1_GEN, "am")
    p3 = _noisy_llrs(rng, 1, t3, gens, "am")[0]
    jb1, jb3, jm = JDA.am_frame_fec(jnp.asarray(p1), jnp.asarray(p3), ma3)
    tb1, tb3, tm = TDA.am_frame_fec(_t(p1), _t(p3), ma3)
    assert np.array_equal(tb1.numpy(), np.asarray(jb1))
    assert np.array_equal(tb3.numpy(), np.asarray(jb3))
    for k in ("p1", "p3"):
        assert np.array_equal(tm[k].numpy(), np.asarray(jm[k])), k


def test_am_pids_decode_matches():
    """The port's am_pids_decode against JAX's on received codes with
    errors: 16 blocks of a 20 dB station's PIDS codes."""
    rng = np.random.default_rng(10)
    words = _bits(rng, 16, C.PIDS_FRAME_LEN)
    codes = np.stack([EAM.encode_pids_am(w) for w in words])
    flips = rng.random(codes.shape) < 0.03
    codes = np.where(flips, rng.integers(0, 16, codes.shape), codes).astype(
        np.uint8)
    got = TDA.am_pids_decode(_t(codes)).numpy()
    for b in range(16):
        want = np.asarray(JDA.am_pids_decode(jnp.asarray(codes[b]),
                                             jnp.asarray(False)))
        assert np.array_equal(got[b], want)
    assert (got == words).all(axis=-1).sum() >= 12


def test_am_k8_tables_match_fec():
    """K8's AM channel tables (the kept bits of the chunk segments and
    the keystream restarting at each P1 subframe) turn K7's segment bits
    into JAX's chunked K=9 Viterbi bits, descrambled per subframe."""
    rng = np.random.default_rng(11)
    p1 = _noisy_llrs(rng, 8, C.P1_FRAME_LEN_AM, C.CONV_E1_GEN, "am")
    want, _ = JCV.viterbi_decode_chunked(jnp.asarray(p1), 9, JC.CONV_E1_GEN,
                                         chunk=1024, overlap=160, radix=1,
                                         fuse=1)
    want = np.asarray(want) ^ JSC.scrambler_keystream(C.P1_FRAME_LEN_AM)
    seg = TCV._chunk_plan(C.P1_FRAME_LEN_AM, 1024, 160)[0]
    bits, _ = TCV.acs_traceback_plain(_t(p1[:, seg].reshape(-1, seg.shape[1],
                                                          3)),
                                      C.CONV_E1_GEN, 9)
    got, errors = TDF.fec_epilogue_plain(bits, "am_p1")
    assert errors is None
    assert np.array_equal(got.numpy().reshape(8, -1), want)


_TWINS = {
    "am_frame_gather": (lambda x: TDA.am_frame_gather(
        x, x, x, x, TDA.AMDecodeState(x, x, x, x)), "am_gather and am_fec"),
    "am_frame_fec": (lambda x: TDA.am_frame_fec(x, x),
                     "am_gather and am_fec"),
    "am_pids_decode": (lambda x: TDA.am_pids_decode(
        x.new_empty(4, 32, 2, dtype=torch.uint8)), "a CUDA tensor"),
}


@pytest.mark.parametrize("twin", sorted(_TWINS))
def test_per_frame_twins_are_cpu_only(twin):
    """No plain version runs in place of K15, K7 or K8 off the CPU: the
    reference's per-frame gather and FEC are CPU twins, and a tensor on
    any other device (here ``meta``) raises and points at the kernels'
    path; ``am_pids_decode`` takes the kernels' path there (K15's
    PIDS-only launch), which refuses a tensor that is not on a card."""
    fn, match = _TWINS[twin]
    x = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match=match):
        fn(x)


def test_ingest_am_cs16():
    """serve.ingest(mode="am") is the reference receiver's cs16 ingest,
    s * (1/32768) (nrsc5_tpu/serve.py:311-313), exactly."""
    rng = np.random.default_rng(12)
    wire = rng.integers(-32768, 32768, (3, 777, 2)).astype(np.int16)
    got = serve.ingest(wire, "am", device="cpu").numpy()
    want = np.asarray(jnp.asarray(wire).astype(jnp.float32)
                      * (1.0 / 32768.0))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_ingest_am_refuses_cu8():
    """A cu8 AM wire goes through the ÷32 cascade, so one whose length is
    not 434 + 32N pairs is refused with the layout it needs; so is a wire
    of another dtype than cu8, cs16 or cf32, and an unknown mode."""
    wire = np.full((1, 100, 2), 127, np.uint8)
    with pytest.raises(ValueError, match="434 \\+ 32N"):
        serve.ingest(wire, "am", device="cpu")
    with pytest.raises(ValueError, match="int16 \\(cs16\\)"):
        serve.ingest(wire.astype(np.int32), "am", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        serve.ingest(wire, "dab", device="cpu")


def test_am_carry_numpy_roundtrip():
    """A JAX carry with nonzero state crosses into the port and back
    exactly, per station and stacked; wrong fields and lines are
    refused."""
    rng = np.random.default_rng(13)
    jc = JAR.am_chain_rc_init_carry(offset=7, cfo=-2)
    d = _jax_carry_numpy(jc)
    for k in LINES:
        d[k] = _bits(rng, TDA.DD)
    d["phase"] = np.array([0.6, 0.8], np.float32)
    carry = state.am_carry_from_numpy(d, device="cpu")
    assert carry.dec.ml.shape == (1, TDA.DD)
    back = state.am_carry_to_numpy(carry)
    assert list(back) == list(d)
    for k, v in d.items():
        assert back[k][0].dtype == v.dtype and np.array_equal(back[k][0], v)
    stacked = state.am_carry_from_numpy(
        {k: np.stack([v, v]) for k, v in d.items()}, device="cpu")
    assert torch.equal(stacked.dec.emu[1], carry.dec.emu[0])
    d["ml"] = d["ml"][:1000]
    with pytest.raises(ValueError, match="ml holds 1000"):
        state.am_carry_from_numpy(d, device="cpu")
    del d["ml"]
    with pytest.raises(ValueError, match="AM carry fields"):
        state.am_carry_from_numpy(d, device="cpu")


_AM_ENTRY_POINTS = {
    "chain_step_am": lambda: serve.chain_step_am(
        torch.zeros(1, 16, 2, dtype=torch.int16),
        TAR.am_chain_rc_init_carry(device="cpu"), 1),
    "ingest_am": lambda: serve.ingest(
        torch.zeros(1, 16, 2, dtype=torch.int16), "am"),
    "am_chain_rc_init_carry": lambda: TAR.am_chain_rc_init_carry(),
    "am_carry_from_numpy": lambda: state.am_carry_from_numpy(
        state.am_carry_to_numpy(TAR.am_chain_rc_init_carry(device="cpu"))),
}


@pytest.mark.parametrize("entry", sorted(_AM_ENTRY_POINTS))
def test_am_entry_points_default_to_cuda(entry):
    """With no card and no ``device=``, an AM entry point raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _AM_ENTRY_POINTS[entry]()


def test_impair_am_rate_matches():
    """The port's impair at the AM rate, with the AWGN and CFO chip_smoke
    uses, equals the JAX package's from the same noise seed."""
    rng = np.random.default_rng(14)
    sig = (rng.normal(size=5000) + 1j * rng.normal(size=5000)).astype(
        np.complex64)
    kw = {"sample_rate": C.SAMPLE_RATE_CS16_AM, "cfo_hz": 7.25,
          "snr_db": 35.0}
    assert np.array_equal(
        ch.impair(sig, rng=np.random.default_rng(1), **kw),
        JCH.impair(sig, rng=np.random.default_rng(1), **kw))
