"""The PyTorch port's PX channels (MP2, MP3, MP11) against the JAX package,
on the CPU.

The same inputs, made by numpy from a seed, go through the JAX functions
and their ports: the sync block's PX demaps (K4), the interleaver-IV
deinterleave with carried state (K11), the P3/P4 FEC (K7 and K8), the
static index maps the kernels K6, K8 and K11 read, and the chain as a whole
from the cu8 wire through ``serve.chain_step``: two distinct MP3 stations,
one MP11 and one MP2 station, a JAX-to-port carry hand-over between
dispatches, three dispatches of one MP3 station, and an MP3 cold start.
JAX runs on the CPU as tests/conftest.py pins it; the port runs its plain
PyTorch versions, which is what a kernel wrapper does with a CPU tensor.

Tolerances, with their reasons:

=====================================  =================================
output                                 tolerance
=====================================  =================================
decoded P1, PIDS, PX1 and PX2 bits,    exact (the slice's result)
Viterbi margins, re-encode bit
errors, IV phases, the K11 output and
new state on equal inputs, the maps
sync block pm, px1, px2 (int8) on the  exact
same spectra
sync block MER sums; its angle and     rtol 1e-4 (sums of 252 terms in
Costas state                           K4's order, not XLA's); rtol 1e-5,
                                       atol 1e-6
integer carry fields (offset,          exact
samperr_fb, cfo)
IV state after a dispatch (int8 soft   within ±1 on at most 1 % of the
bits of the last 32 blocks)            entries: float32 last-bit
                                       differences between the two
                                       frameworks (atan2, sums) compound
                                       through the Costas feedback and can
                                       move a demapped value across a .5
                                       rounding edge (measured: 0.28 %)
float carry fields                     rtol 1e-4, angles and phases atol
                                       5e-4 rad: as tests/test_torch_chain
                                       .py holds the MP1 slice's (2e-4 over
                                       17 blocks), over 32 blocks of the
                                       Costas feedback (measured: 2.2e-4)
=====================================  =================================
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nrsc5_tpu.ops import acquire_rc as JAQ
from nrsc5_tpu.ops import decode_fm as JDF
from nrsc5_tpu.ops import frontend as JFE
from nrsc5_tpu.pipeline import scan_chain as JSC
from nrsc5_tpu.pipeline import scan_chain_rc as JRC
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import serve, state
from nrsc5_tpu_torch.ops import decode_fm as TDF
from nrsc5_tpu_torch.ops import interleavers as TIL
from nrsc5_tpu_torch.ops.bits import PACKED_KEYS, pack_bits
from nrsc5_tpu_torch.ops.convolutional import conv_encode, conv_encode_dev
from nrsc5_tpu_torch.pipeline import scan_chain as TSC
from nrsc5_tpu_torch.pipeline import scan_chain_rc as TRC
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix, build_px_stream
from nrsc5_tpu_torch.tx.modulator import modulate_fm

BLOCKS = 32  # one dispatch: one IV cycle, two P1 frames
ANGLES = ("phase", "prev_angle", "costas_phase", "costas_freq", "angle_fb")
CHAIN_ANGLE_ATOL = 5e-4
IV_SHARE = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(rng, *shape):
    return rng.integers(0, 2, shape).astype(np.uint8)


def _jax_ingest(wire_row):
    """The reference receiver's cu8 FM ingest (nrsc5_tpu/serve.py:315-319)."""
    f = (jnp.asarray(wire_row).astype(jnp.float32) - 127.0) * (64.0 / 32767.0)
    f = f * jnp.asarray(np.array([1.0, -1.0], np.float32))
    return JFE.decimate_overlap_rc(f, 1)


def _px_signal(rng, psmi, n_cycles, blocks=None):
    """One station of service mode ``psmi``: 32·n_cycles frame-aligned
    blocks (block counts 0..15 repeating) with random P1, PIDS and PX
    frames, modulated clean (the first ``blocks`` of them, default all).
    Returns (baseband, truth dict: p1 [F, 146176], pids [n_blocks, 80],
    px1/px2 [n_cycles, 16, frame_len])."""
    n_blocks = 32 * n_cycles
    n_frames = n_blocks // C.P1_FM_BLOCKS
    truth = {"p1": _bits(rng, n_frames, C.P1_FRAME_LEN_FM),
             "pids": _bits(rng, n_blocks, C.PIDS_FRAME_LEN)}
    matrix = np.concatenate([
        build_pm_matrix(truth["p1"][f], truth["pids"][16 * f:16 * f + 16])
        for f in range(n_frames)])
    signs = {}
    for key, fl in zip(("px1", "px2"), TSC.px_frame_lens(psmi)):
        if fl:
            truth[key] = _bits(rng, n_cycles, 16, fl)
            signs[key + "_signs"] = build_px_stream(truth[key], fl).reshape(
                n_blocks * C.BLKSZ, -1)
    rows = (blocks or n_blocks) * C.BLKSZ
    sig = modulate_fm(matrix[:rows], np.tile(np.arange(16), n_frames)[
        :rows // C.BLKSZ], psmi, **{k: v[:rows] for k, v in signs.items()})
    return sig, truth


def _queue(rng, sig, n_blocks):
    """The impaired baseband (25 dB) as a station's cu8 queue: the first
    symbol FFTCP//2 samples in, 7 history pairs ahead (serve.py's queue),
    room for the offset walk of ``n_blocks`` blocks after."""
    sig = ch.impair(sig, snr_db=25.0, rng=rng)
    buf = np.zeros(TSC.buffer_len(n_blocks) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    return serve.stream_wire(ch.to_cu8(ch.upsample2(buf)))


def _jax_batch(wire, psmi, carries=None, n_blocks=BLOCKS):
    """JAX's batch chain on the stations of a cu8 wire [S, pairs, 2]."""
    x = jnp.stack([_jax_ingest(w) for w in wire])
    if carries is None:
        carries = jax.tree.map(lambda *a: jnp.stack(a), *(
            [JRC.chain_rc_init_carry(psmi=psmi)] * len(wire)))
    return JRC.fm_chain_batch_rc(x, carries, n_blocks, psmi, 0)


def _assert_outputs_equal(out, jo):
    keys = {k for k in jo if k != "diag"}
    assert keys == {k for k in out if k != "diag"}, (keys, set(out))
    for k in sorted(keys):
        assert np.array_equal(out[k].numpy(), np.asarray(jo[k])), k


def _assert_carry_close(carry, jc):
    got = state.carry_to_numpy(carry)
    ref = {k: np.asarray(v) for k, v in jc._asdict().items()}
    assert list(got) == list(ref)  # the reference's fields, in its order
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k in ANGLES:
            np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                       atol=CHAIN_ANGLE_ATOL, err_msg=k)
        elif k.endswith("_internal"):
            diff = np.abs(got[k].astype(int) - v)
            assert diff.max(initial=0) <= 1, k
            assert (diff > 0).mean() <= IV_SHARE if diff.size else True, k
        else:
            assert np.array_equal(got[k], v), k


# ---------------------------------------------------------------------------
# the slice: two distinct MP3 stations, one dispatch from a fresh carry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mp3_run():
    rng = np.random.default_rng(0x3A3)
    stations = [_px_signal(rng, 3, 1) for _ in range(2)]
    wire = np.stack([_queue(rng, sig, BLOCKS)[:serve.wire_pairs(BLOCKS)]
                     for sig, _ in stations])
    carry = TRC.chain_rc_init_carry(psmi=3, n_stations=2, device="cpu")
    out, new = serve.chain_step(wire, carry, BLOCKS, 3, 0, device="cpu")
    return {"out": out, "carry": new, "truth": [t for _, t in stations],
            "jax": _jax_batch(wire, 3), "wire": wire}


def test_mp3_slice_matches_jax(mp3_run):
    jo, _ = mp3_run["jax"]
    out = mp3_run["out"]
    assert out["px1"].shape == (2, BLOCKS // 2, C.P3_FRAME_LEN_MP3_MP11)
    _assert_outputs_equal(out, jo)


def test_mp3_slice_carry_matches_jax(mp3_run):
    _, jc = mp3_run["jax"]
    _assert_carry_close(mp3_run["carry"], jc)
    assert mp3_run["carry"].px1_phase.tolist() == [0, 0]  # a whole cycle


def test_mp3_slice_decodes_transmitted_bits(mp3_run):
    """P1 and PIDS bit-exact; of the first IV cycle, whose reads reach back
    before the capture into a zero state, the PX1 frames of pairs 9..15
    decode (the reference decodes the same ones)."""
    out = mp3_run["out"]
    for s, truth in enumerate(mp3_run["truth"]):
        assert np.array_equal(out["p1"][s].numpy(), truth["p1"])
        assert np.array_equal(out["pids"][s].numpy(), truth["pids"])
        hits = [np.array_equal(out["px1"][s, p].numpy(), truth["px1"][0, p])
                for p in range(16)]
        assert hits == [False] * 9 + [True] * 7, hits


def test_mp3_slice_packed(mp3_run):
    """``packed=True`` packs every decoded channel as ops.bits does."""
    carry = TRC.chain_rc_init_carry(psmi=3, n_stations=2, device="cpu")
    out, _ = serve.chain_step(mp3_run["wire"], carry, BLOCKS, 3, 0,
                              packed=True, device="cpu")
    assert set(PACKED_KEYS) & set(out) == {"p1", "pids", "px1"}
    for k in ("p1", "pids", "px1"):
        assert torch.equal(out[k], pack_bits(mp3_run["out"][k])), k


def test_px_chain_refuses_unaligned_pairs():
    """One interleaver-IV call per block pair: an odd block count or first
    block count is refused before any work, as is IV state of another
    mode's size."""
    carry = TRC.chain_rc_init_carry(psmi=3, device="cpu")
    x = torch.zeros(1, TSC.buffer_len(3), 2)
    for n_blocks, first_bc in ((3, 0), (2, 1)):
        with pytest.raises(ValueError, match="pair-aligned"):
            TRC.fm_chain_batch_rc(x, carry, n_blocks, 3, first_bc)
    with pytest.raises(ValueError, match="px1_internal holds 147456"):
        TRC.fm_chain_batch_rc(x, carry, 2, 2, 0)


@pytest.fixture(scope="module", params=[11, 2], ids=["mp11", "mp2"])
def mode_run(request):
    psmi = request.param
    rng = np.random.default_rng(psmi)
    sig, truth = _px_signal(rng, psmi, 1)
    wire = _queue(rng, sig, BLOCKS)[None, :serve.wire_pairs(BLOCKS)]
    carry = TRC.chain_rc_init_carry(psmi=psmi, device="cpu")
    out, new = serve.chain_step(wire, carry, BLOCKS, psmi, 0, device="cpu")
    return {"psmi": psmi, "out": out, "carry": new, "truth": truth,
            "jax": _jax_batch(wire, psmi)}


def test_px_mode_matches_jax(mode_run):
    """MP11 (PX1 and PX2) and MP2 (a PX1 of 2304 bits) at S = 1."""
    jo, jc = mode_run["jax"]
    out = mode_run["out"]
    keys = ("px1", "px2") if mode_run["psmi"] == 11 else ("px1",)
    assert {k for k in out if k.startswith("px")} == {
        k + m for k in keys for m in ("", "_margin")}
    _assert_outputs_equal(out, jo)
    _assert_carry_close(mode_run["carry"], jc)
    assert np.array_equal(out["p1"][0].numpy(), mode_run["truth"]["p1"])


# ---------------------------------------------------------------------------
# one MP3 station over three dispatches, and the JAX-to-port hand-over
# ---------------------------------------------------------------------------

def _dispatch(queue, pos, carry, plain_jax=None):
    """One dispatch of 32 blocks from queue position ``pos`` (cu8 pairs);
    returns (out, new carry with offset 0, next position), as the
    reference receiver advances its queue."""
    wire = queue[None, pos:pos + serve.wire_pairs(BLOCKS)]
    out, new = serve.chain_step(wire, carry, BLOCKS, 3, 0, device="cpu")
    consumed = int(new.offset[0])
    return out, new._replace(offset=torch.zeros_like(new.offset)), \
        pos + 2 * consumed


@pytest.fixture(scope="module")
def three_dispatches():
    rng = np.random.default_rng(0x3D)
    sig, truth = _px_signal(rng, 3, 3)
    queue = _queue(rng, sig, 3 * BLOCKS)
    carry = TRC.chain_rc_init_carry(psmi=3, device="cpu")
    outs, carries, starts, pos = [], [], [], 0
    for _ in range(3):
        starts.append(pos)
        out, carry, pos = _dispatch(queue, pos, carry)
        outs.append(out)
        carries.append(carry)
    return {"queue": queue, "truth": truth, "outs": outs,
            "carries": carries, "starts": starts}


def test_three_dispatches_decode_every_cycle(three_dispatches):
    """Three dispatches of 32 blocks with the carry, IV state included,
    handed on: every P1 frame and PIDS word, and every PX1 frame of IV
    cycles 1 and 2 at its own pair position."""
    truth, outs = three_dispatches["truth"], three_dispatches["outs"]
    for d, out in enumerate(outs):
        assert np.array_equal(out["p1"][0].numpy(),
                              truth["p1"][2 * d:2 * d + 2])
        assert np.array_equal(out["pids"][0].numpy(),
                              truth["pids"][32 * d:32 * d + 32])
        if d:
            assert np.array_equal(out["px1"][0].numpy(), truth["px1"][d]), d
    assert [int(c.px1_phase) for c in three_dispatches["carries"]] == [0] * 3


def test_carry_handover_with_px_state(three_dispatches):
    """JAX decodes dispatch 1 and hands its carry over as numpy, IV state
    included; the port's dispatch 2 from it equals JAX's dispatch 2."""
    queue, pos = three_dispatches["queue"], three_dispatches["starts"][1]
    wire = queue[None, :serve.wire_pairs(BLOCKS)]
    _, jc1 = _jax_batch(wire, 3)
    jc1 = jc1._replace(offset=jnp.zeros_like(jc1.offset))
    assert np.any(np.asarray(jc1.px1_internal))
    carry = state.carry_from_numpy(
        {k: np.asarray(v) for k, v in jc1._asdict().items()}, psmi=3,
        device="cpu")
    assert np.array_equal(carry.px1_internal.numpy(),
                          np.asarray(jc1.px1_internal))
    wire2 = queue[None, pos:pos + serve.wire_pairs(BLOCKS)]
    out, new = serve.chain_step(wire2, carry, BLOCKS, 3, 0, device="cpu")
    jo2, jc2 = _jax_batch(wire2, 3, carries=jc1)
    _assert_outputs_equal(out, jo2)
    _assert_carry_close(new, jc2)
    assert np.array_equal(out["px1"][0].numpy(),
                          three_dispatches["truth"]["px1"][1])


# ---------------------------------------------------------------------------
# per module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("psmi", [2, 3, 11])
def test_sync_block_px_matches(psmi):
    """K4's plain version against JAX's sync_block_rc on the same spectra
    of a two-block capture of mode ``psmi`` with a 30 Hz CFO and a random
    Costas state: pm, px1 and px2 exact, the floats as
    tests/test_torch_chain.py holds psmi 1's."""
    rng = np.random.default_rng(20 + psmi)
    sig, _ = _px_signal(rng, psmi, 1, blocks=2)
    sig = ch.impair(sig, snr_db=25.0, rng=rng, cfo_hz=30.0)
    win = np.stack([sig.real, -sig.imag], -1)[:JAQ.WINDOW_FM].astype(
        np.float32)
    spectra, _, _, _ = JAQ.demod_rc(
        jnp.asarray(win), jnp.asarray(np.array([1.0, 0.0], np.float32)),
        jnp.int32(1080), jnp.float32(0.0), jnp.int32(0))
    spectra = np.asarray(spectra)
    cp = rng.normal(0, 0.1, C.FFT_FM).astype(np.float32)
    cf = rng.normal(0, 0.01, C.FFT_FM).astype(np.float32)
    jo, jph, jfr = jax.jit(JRC.sync_block_rc, static_argnums=3)(
        jnp.asarray(spectra), jnp.asarray(cp), jnp.asarray(cf), psmi,
        jnp.int32(2))
    to, tph, tfr = TRC.sync_block_rc(_t(spectra)[None], _t(cp)[None],
                                     _t(cf)[None], psmi,
                                     torch.tensor([2], dtype=torch.int32))
    assert set(to) == set(jo)
    fl1, fl2 = TSC.px_frame_lens(psmi)
    assert to["px1"].shape == (1, fl1)
    assert ("px2" in to) == bool(fl2)
    for k in ("pm", "px1", "px2", "ref_ok", "ref_bc", "ref_psmi",
              "samperr"):
        if k in jo:
            assert np.array_equal(to[k][0].numpy(), np.asarray(jo[k])), k
    # the MER sums as tests/test_torch_chain.py holds psmi 1's (the plain
    # version sums 252-term rows in K4's order, not XLA's: 1.05e-5 measured
    # at psmi 11), the angles to 1e-5
    for k in ("error_lb", "error_ub"):
        np.testing.assert_allclose(to[k][0].numpy(), np.asarray(jo[k]),
                                   rtol=1e-4)
    for got, want in ((to["angle"][0], jo["angle"]), (tph[0], jph),
                      (tfr[0], jfr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _k11_emulated(llr, internal, phase):
    """What K11 computes, pair by pair in parallel (its index algebra, in
    numpy): a read of region q sees the newest earlier pair of the
    dispatch at phase q, else the old state; the new state is each
    region's newest write.  Returns (call soft bits [S, P, 2fl], new
    state)."""
    s, two_p, fl = llr.shape
    pairs, call_len = two_p // 2, 2 * fl
    read_idx, n, calls = TIL.p3_iv_tables(fl)
    hazard = TIL.p3_iv_hazard(fl)
    llr = llr.reshape(s, pairs, call_len)
    soft = np.empty((s, pairs, call_len), np.int8)
    i = np.arange(call_len)
    for st in range(s):
        for p in range(pairs):
            ph = (int(phase[st]) + p) % calls
            c = ph * call_len + i
            r = read_idx[c]
            q = r // call_len
            d = (ph - q) % calls
            d[d == 0] = calls
            pp = p - d
            old = np.where(pp >= 0, llr[st, np.maximum(pp, 0),
                                        r - q * call_len],
                           internal[st, r])
            fresh = llr[st, p, np.clip(r - ph * call_len, 0, call_len - 1)]
            soft[st, p] = np.where(hazard[c], fresh, old)
    new = internal.copy()
    r = np.arange(n)
    q = r // call_len
    for st in range(s):
        k = (q - int(phase[st])) % calls
        pp = k + calls * ((pairs - 1 - k) // calls)
        new[st] = np.where(k < pairs,
                           llr[st, np.clip(pp, 0, pairs - 1),
                               r - q * call_len], internal[st])
    return soft, new


@pytest.mark.parametrize("pairs", [3, 18])
@pytest.mark.parametrize("phase", [0, 7])
@pytest.mark.parametrize("fl", [2304, 4608])
def test_px_deinterleave_matches(fl, phase, pairs):
    """K11's plain version against JAX's px_scan_pairs(decode=False) from a
    random int8 state, for fewer and for more pairs than a cycle; and the
    index algebra the kernel runs against both."""
    rng = np.random.default_rng(fl + phase + pairs)
    _, n, calls = TIL.p3_iv_tables(fl)
    llr = rng.integers(-127, 128, (1, 2 * pairs, fl)).astype(np.int8)
    internal = rng.integers(-127, 128, (1, n)).astype(np.int8)
    ph = np.array([phase], np.int32)
    fl1, fl2 = (fl, 0)
    jout, jst = JSC.px_scan_pairs(
        (jnp.asarray(llr[0]),), 2 * pairs, 0, fl1, fl2,
        {"px1": (jnp.asarray(internal[0]), jnp.int32(phase))}, decode=False)
    ext, new, new_ph = TDF.px_deinterleave(_t(llr), _t(internal), _t(ph))
    w = TDF.WRAP
    full = ext.reshape(pairs, fl + 2 * w, 3)
    assert np.array_equal(full[:, w:w + fl].numpy(),
                          np.asarray(jout["px1_full"]))
    assert torch.equal(full[:, :w], full[:, fl:fl + w])
    assert torch.equal(full[:, fl + w:], full[:, w:2 * w])
    assert np.array_equal(new.numpy()[0], np.asarray(jst["px1"][0]))
    assert int(new_ph[0]) == int(jst["px1"][1]) == (phase + pairs) % calls
    soft, emu = _k11_emulated(llr, internal, ph)
    assert np.array_equal(emu, new.numpy())
    k7_map = TDF.channel_tables(f"px{fl}")["k7_map"]
    emu_ext = np.where(k7_map >= 0, soft[0][:, np.maximum(k7_map, 0)], 0)
    assert np.array_equal(emu_ext.astype(np.float32),
                          ext.reshape(pairs, -1).numpy())


@pytest.mark.parametrize("fl", [2304, 4608])
def test_px_fec_matches(fl):
    """K7 + K8 on the PX frames against JAX's px_fec: noisy codewords of
    random frames, bits and margins exact, packing as ops.bits packs."""
    rng = np.random.default_rng(fl)
    bits = _bits(rng, 3, fl)
    coded = conv_encode(bits, 7, C.CONV_K7_GEN).reshape(3, fl, 3)
    soft = (coded * 2.0 - 1.0) * 40 + rng.normal(0, 40, coded.shape)
    full = np.clip(np.round(soft), -127, 127).astype(np.float32)
    full[:, np.resize(np.asarray(C.PUNCTURE_P3_P4_FM, bool), fl * 3)
         .reshape(fl, 3) == 0] = 0.0
    jb, jm = JDF.px_fec(jnp.asarray(full), fl)
    w = TDF.WRAP
    ext = _t(np.concatenate([full[:, -w:], full, full[:, :w]], 1))
    tb, tm = TDF.px_fec(ext, fl)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    tp, _ = TDF.px_fec(ext, fl, packed=True)
    assert torch.equal(tp, pack_bits(tb))


@pytest.mark.parametrize("fl", [2304, 4608])
def test_px_decode_matches(fl):
    """The per-pair entry point against JAX's px_decode: one call at phase 5
    from a random state, on the codeword of a random frame spread over the
    call's soft bits (most of the state read is random, so most bits come
    out wrong alike)."""
    rng = np.random.default_rng(fl + 1)
    _, n, _ = TIL.p3_iv_tables(fl)
    internal = rng.integers(-127, 128, n).astype(np.int8)
    llrs = rng.integers(-127, 128, 2 * fl).astype(np.int8)
    jb, jm, jst = JDF.px_decode(jnp.asarray(internal), jnp.asarray(llrs),
                                jnp.int32(5), fl)
    tb, tm, tst = TDF.px_decode(_t(internal), _t(llrs), 5, fl)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert float(tm) == float(jm)
    assert np.array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("name", ["p1", "pids"])
def test_fec_maps_match_plain(name):
    """The static maps K6 and K8 read, applied with tensor indexing, give
    the plain versions' K7 input, kept bits and re-encode bit errors."""
    rng = np.random.default_rng(9)
    frame = TDF.PM_FRAME if name == "p1" else C.PM_BLOCK_SIZE
    pm = _t(rng.integers(-127, 128, (2, 3, frame)).astype(np.int8))
    tb = TDF.channel_tables(name)
    k7_map = torch.from_numpy(tb["k7_map"]).long()
    flat = pm.reshape(6, frame)
    via_map = torch.where(k7_map >= 0, flat[:, k7_map.clamp(min=0)].float(),
                          0.0)
    plain = TDF.fec_gather_plain(pm, name)
    assert torch.equal(via_map, plain.reshape(6, -1))
    k7_bits = _t(rng.integers(0, 2, (6 * tb["n_seg"], tb["steps"]))
                 .astype(np.uint8))
    out, errors = TDF.fec_epilogue_plain(
        k7_bits, name, pm if name == "p1" else None)
    kept = k7_bits.reshape(6, -1)[:, torch.from_numpy(tb["keep"]).long()]
    assert torch.equal(out, kept ^ _t(tb["keystream"]))
    if name == "p1":
        code = torch.from_numpy(tb["code_map"]).long().reshape(-1, 3)
        hard = flat[:, code.clamp(min=0)] > 0
        enc = conv_encode_dev(kept, C.CONV_K7_GEN).bool()
        via_map = ((hard != enc) & (code >= 0)).sum(dim=(1, 2))
        assert torch.equal(errors, via_map.to(torch.int32))
        assert int(errors.min()) > 0


# ---------------------------------------------------------------------------
# an MP3 cold start
# ---------------------------------------------------------------------------

def test_cold_start_mp3():
    """An MP3 capture behind a timing offset and a CFO of 3 bins + 20 Hz
    locks with psmi 3 in the port as in JAX, and the lock's carry holds
    JAX's PX fields with JAX's shapes and values."""
    rng = np.random.default_rng(0xC3)
    sig, _ = _px_signal(rng, 3, 1, blocks=6)
    n = TSC.buffer_len(5) + 2 * C.FFTCP_FM
    clean = np.zeros(n, np.complex64)
    clean[C.FFTCP_FM // 2:] = sig[:n - C.FFTCP_FM // 2]
    bin_hz = C.SAMPLE_RATE_CS16_FM / C.FFT_FM
    noisy = ch.impair(clean, sample_offset=1789, cfo_hz=3 * bin_hz + 20.0,
                      snr_db=25.0, rng=rng)[:n]
    x = np.stack([noisy.real, -noisy.imag], -1).astype(np.float32)
    lock = TRC.cold_start_rc(x, device="cpu")
    jl = JRC.cold_start_rc(jnp.asarray(x))
    assert lock is not None and jl is not None
    for k in ("offset", "first_bc", "psmi", "cfo"):
        assert lock[k] == jl[k], k
    assert lock["psmi"] == 3
    got = {k: v.numpy() for k, v in lock["carry"]._asdict().items()}
    for k, v in jl["carry"]._asdict().items():
        v = np.asarray(v)
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k == "prev_angle":
            np.testing.assert_allclose(got[k], v, atol=1e-6)
        else:
            assert np.array_equal(got[k], v), k
    assert got["px1_internal"].shape == (TSC.iv_state_len(4608),)
