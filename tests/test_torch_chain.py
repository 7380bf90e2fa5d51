"""The PyTorch port against the JAX package, on the CPU.

The same inputs, made by numpy from a seed, go through the JAX function and
its port, per module of the slice and for the slice as a whole (two
distinct stations, 17 blocks of MP1 from block count 15, the static
arguments test_scan_chain.py already compiles).  JAX runs on the CPU as
tests/conftest.py pins it; the port runs its plain PyTorch versions, which
is what a kernel wrapper does with a CPU tensor.

Tolerances, with their reasons:

=====================================  =================================
output                                 tolerance
=====================================  =================================
decoded P1 and PIDS bits               exact (the slice's result)
Viterbi bits, margins, re-encode       exact on equal LLRs: int8 LLRs make
errors                                 every path metric an integer,
                                       exact in float32 in any order
cu8 ingest and halfband                exact: same taps, same add order,
                                       no FMA on either side
pm soft bits (int8)                    within ±1: a float difference
                                       upstream can cross a .5 rounding
                                       boundary of the demap
diag samperr                           within ±1, as pinned for the
                                       reference's own rc-vs-complex test
float outputs of one module            rtol 1e-4, with an atol for
                                       values near 0 (spectra and
                                       derotated refs: 1e-5 of the largest
                                       value; angles: 1e-6 rad):
                                       the two frameworks sum in other
                                       orders and their float32 atan2,
                                       sin and cos differ in the last bits
float diagnostics and carry of the     rtol 1e-4, angles and phases atol
slice                                  2e-4 rad, the MER error sums rtol
                                       1e-3: each block's Costas state
                                       feeds the next, so the last-bit
                                       differences above compound over 17
                                       blocks (measured here: up to 7.5e-5
                                       rad and 1.8e-4)
=====================================  =================================
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nrsc5_tpu import constants as JC
from nrsc5_tpu.ops import acquire_rc as JAQ
from nrsc5_tpu.ops import convolutional as JCV
from nrsc5_tpu.ops import decode_fm as JDF
from nrsc5_tpu.ops import frontend as JFE
from nrsc5_tpu.pipeline import scan_chain_rc as JRC
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import serve, state
from nrsc5_tpu_torch.ops import acquire_rc as TAQ
from nrsc5_tpu_torch.ops import convolutional as TCV
from nrsc5_tpu_torch.ops import decode_fm as TDF
from nrsc5_tpu_torch.ops import frontend as TFE
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.pipeline import scan_chain as TSC
from nrsc5_tpu_torch.pipeline import scan_chain_rc as TRC
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
from nrsc5_tpu_torch.tx.modulator import modulate_fm

N_STATIONS, N_BLOCKS, FIRST_BC = 2, 17, 15
ANGLE_ATOL = 1e-6
CHAIN_ANGLE_ATOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_ingest(wire_row):
    """The reference receiver's cu8 FM ingest (nrsc5_tpu/serve.py:315-319)."""
    f = (jnp.asarray(wire_row).astype(jnp.float32) - 127.0) * (64.0 / 32767.0)
    f = f * jnp.asarray(np.array([1.0, -1.0], np.float32))
    return JFE.decimate_overlap_rc(f, 1)


def _bits(rng, *shape):
    return rng.integers(0, 2, shape).astype(np.uint8)


def _station(rng):
    """One station's cu8 queue for the slice: a lead block (bc 15), then one
    P1 frame (bc 0..15), AWGN at 25 dB, the first symbol FFTCP//2 samples
    into the chain buffer, 7 history pairs ahead and 7 pairs of lookahead
    after (serve.py's queue)."""
    p1 = _bits(rng, C.P1_FRAME_LEN_FM)
    pids = _bits(rng, 16, C.PIDS_FRAME_LEN)
    lead = build_pm_matrix(_bits(rng, C.P1_FRAME_LEN_FM),
                           _bits(rng, 16, C.PIDS_FRAME_LEN))[15 * 32:]
    matrix = np.concatenate([lead, build_pm_matrix(p1, pids)])
    sig = ch.impair(modulate_fm(matrix, np.r_[15, np.arange(16)], 1),
                    snr_db=25.0, rng=rng)
    buf = np.zeros(TSC.buffer_len(N_BLOCKS) + 8, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    wire = serve.stream_wire(ch.to_cu8(ch.upsample2(buf)))
    return wire[:serve.wire_pairs(N_BLOCKS)], p1, pids


@pytest.fixture(scope="module")
def slice_run():
    rng = np.random.default_rng(0x51CE)
    stations = [_station(rng) for _ in range(N_STATIONS)]
    wire = np.stack([s[0] for s in stations])
    carries = TRC.chain_rc_init_carry(n_stations=N_STATIONS, device="cpu")
    out, carry = serve.chain_step(wire, carries, N_BLOCKS, 1, FIRST_BC,
                                  device="cpu")
    samples, jax_runs = [], []
    for s in range(N_STATIONS):
        x = _jax_ingest(wire[s])
        samples.append(x)
        jax_runs.append(JRC.fm_chain_scan_rc(
            x, JRC.chain_rc_init_carry(), N_BLOCKS, 1, FIRST_BC))
    return {"wire": wire, "truth": [s[1:] for s in stations],
            "out": out, "carry": carry, "samples": samples,
            "jax": jax_runs}


# ---------------------------------------------------------------------------
# per module
# ---------------------------------------------------------------------------

def test_ingest_matches():
    rng = np.random.default_rng(1)
    wire = rng.integers(0, 256, (2, 14 + 2 * 777, 2)).astype(np.uint8)
    got = serve.ingest(wire, device="cpu").numpy()
    for s in range(2):
        assert np.array_equal(got[s], np.asarray(_jax_ingest(wire[s])))


def test_halfband_rc_matches():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 200, 2)).astype(np.float32)
    tail = rng.normal(size=(3, 14, 2)).astype(np.float32)
    jy, jt = JFE.halfband_rc(jnp.asarray(x), jnp.asarray(tail))
    ty, tt = TFE.halfband_rc(_t(x), _t(tail))
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    assert np.array_equal(tt.numpy(), np.asarray(jt))


@pytest.fixture(scope="module")
def block_window():
    """A conjugated rc window of two real blocks at 25 dB with a 30 Hz CFO."""
    rng = np.random.default_rng(3)
    matrix = build_pm_matrix(_bits(rng, C.P1_FRAME_LEN_FM),
                             _bits(rng, 16, C.PIDS_FRAME_LEN))[:64]
    sig = ch.impair(modulate_fm(matrix, np.array([3, 4]), 1), snr_db=25.0,
                    rng=rng, cfo_hz=30.0)
    win = np.zeros((TAQ.WINDOW_FM, 2), np.float32)
    win[:, 0] = sig[:TAQ.WINDOW_FM].real
    win[:, 1] = -sig[:TAQ.WINDOW_FM].imag
    return win


def _demod_both(win, phase, samperr, angle, cfo):
    """The reference's ``demod_rc`` on one window, and its port: K2 on a
    one-station buffer whose window starts at 0, then the DFT matmul."""
    j = JAQ.demod_rc(jnp.asarray(win), jnp.asarray(phase), jnp.int32(samperr),
                     jnp.float32(angle), jnp.int32(cfo))
    folded, phase_out, keep = TAQ.demod_fold(
        _t(win)[None], torch.zeros(1, dtype=torch.int32), _t(phase)[None],
        torch.tensor([samperr], dtype=torch.int32),
        torch.tensor([angle], dtype=torch.float32),
        torch.tensor([cfo], dtype=torch.int32))
    t = (rc.dft(folded[0], shift=True), phase_out[0], keep[0])
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


# (samperr, angle, cfo): on time, early and late with both CFO signs,
# and starts past either end that lax.dynamic_slice wraps or clamps
DEMOD_CASES = [(1080, 0.01, 0), (1083, -0.2, 3), (1075, 0.3, -5),
               (3000, 0.1, -1), (-5, 0.0, 2)]


@pytest.mark.parametrize("samperr,angle,cfo", DEMOD_CASES)
def test_demod_rc_matches(block_window, samperr, angle, cfo):
    phase = np.array([0.6, 0.8], np.float32)
    (js, jp, jse, jk), (ts, tp, tk) = _demod_both(
        block_window, phase, samperr, angle, cfo)
    np.testing.assert_allclose(ts, js, rtol=1e-4,
                               atol=1e-5 * np.abs(js).max())
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=ANGLE_ATOL)
    assert int(jse) == samperr and int(tk) == int(jk)


@pytest.fixture(scope="module")
def spectra(block_window):
    (js, _, _, _), _ = _demod_both(block_window, np.array([1.0, 0.0],
                                                          np.float32),
                                   1080, 0.0, 0)
    return js


@pytest.mark.parametrize("with_cfo", [False, True])
def test_costas_track_matches(spectra, with_cfo):
    rng = np.random.default_rng(4)
    bins = np.r_[478 + 19 * np.arange(11), 1570 - 19 * np.arange(11)]
    refs = np.ascontiguousarray(spectra[:, bins])
    ph0 = rng.uniform(-0.1, 0.1, len(bins)).astype(np.float32)
    fr0 = rng.uniform(-0.005, 0.005, len(bins)).astype(np.float32)
    cf = rng.uniform(-0.3, 0.3, len(bins)).astype(np.float32) \
        if with_cfo else None
    j = JRC.costas_track_rc(jnp.asarray(refs), jnp.asarray(ph0),
                            jnp.asarray(fr0),
                            0.0 if cf is None else jnp.asarray(cf))
    t = TRC.costas_track_rc(_t(refs), _t(ph0), _t(fr0),
                            None if cf is None else _t(cf))
    # derot scales with the spectra (as the DFT's atol does); the phases
    # and frequencies are angles
    atols = (1e-5 * np.abs(refs).max(), ANGLE_ATOL, ANGLE_ATOL, ANGLE_ATOL)
    for a, b, atol in zip(j, t, atols):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=atol)


@pytest.mark.parametrize("timing_adj", [0, 2, -3])
def test_sync_block_matches(spectra, timing_adj):
    rng = np.random.default_rng(5)
    cp = rng.normal(0, 0.1, C.FFT_FM).astype(np.float32)
    cf = rng.normal(0, 0.01, C.FFT_FM).astype(np.float32)
    jo, jph, jfr = JRC.sync_block_rc(jnp.asarray(spectra), jnp.asarray(cp),
                                     jnp.asarray(cf), 1,
                                     jnp.int32(timing_adj))
    to, tph, tfr = TRC.sync_block_rc(
        _t(spectra)[None], _t(cp)[None], _t(cf)[None], 1,
        torch.tensor([timing_adj], dtype=torch.int32))
    for k in ("ref_ok", "ref_bc", "ref_psmi"):
        assert np.array_equal(to[k][0].numpy(), np.asarray(jo[k])), k
    pm_diff = to["pm"][0].numpy().astype(int) - np.asarray(jo["pm"])
    assert np.abs(pm_diff).max() <= 1
    assert abs(int(to["samperr"][0]) - int(jo["samperr"])) <= 1
    for k in ("error_lb", "error_ub"):
        np.testing.assert_allclose(to[k][0].numpy(), np.asarray(jo[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(to["angle"][0].numpy(), np.asarray(jo["angle"]),
                               rtol=1e-4, atol=ANGLE_ATOL)
    np.testing.assert_allclose(tph[0].numpy(), np.asarray(jph), rtol=1e-4,
                               atol=ANGLE_ATOL)
    np.testing.assert_allclose(tfr[0].numpy(), np.asarray(jfr), rtol=1e-4,
                               atol=ANGLE_ATOL)


def _noisy_llrs(rng, batch, t, sigma):
    """int8-valued LLRs of random tail-biting codewords through AWGN."""
    bits = _bits(rng, batch, t)
    coded = TCV.conv_encode(bits, 7, C.CONV_K7_GEN).reshape(batch, t, 3)
    soft = (coded * 2.0 - 1.0) * 40 + rng.normal(0, sigma * 40, coded.shape)
    return np.clip(np.round(soft), -127, 127).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.3, 1.0])
def test_viterbi_decode_matches(sigma):
    llr = _noisy_llrs(np.random.default_rng(6), 24, C.PIDS_FRAME_LEN, sigma)
    jb, jm = JCV.viterbi_decode(jnp.asarray(llr), 7, JC.CONV_K7_GEN)
    tb, tm = TCV.viterbi_decode(_t(llr), C.CONV_K7_GEN)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("sigma", [0.3, 1.0])
def test_viterbi_decode_chunked_matches(sigma):
    llr = _noisy_llrs(np.random.default_rng(7), 2, 5000, sigma)
    jb, jm = JCV.viterbi_decode_chunked(jnp.asarray(llr), 7, JC.CONV_K7_GEN,
                                        chunk=1152, overlap=96, radix=1,
                                        fuse=1)
    tb, tm = TCV.viterbi_decode_chunked(_t(llr), C.CONV_K7_GEN)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tm.numpy(), np.asarray(jm))


def test_p1_pids_decode_match():
    """One P1 frame and its 16 PIDS words from soft bits at a noise level
    that leaves bit errors for the re-encode count."""
    rng = np.random.default_rng(8)
    p1 = _bits(rng, C.P1_FRAME_LEN_FM)
    pids = _bits(rng, 16, C.PIDS_FRAME_LEN)
    signs = build_pm_matrix(p1, pids).astype(np.float32)
    pm = np.clip(np.round(signs * 30 + rng.normal(0, 15, signs.shape)),
                 -127, 127).astype(np.int8).reshape(-1)
    jb, jm, je = JDF.p1_decode(jnp.asarray(pm), chunked=True)
    tb, tm, te = TDF.p1_decode(_t(pm)[None])
    assert np.array_equal(tb[0].numpy(), np.asarray(jb))
    assert np.array_equal(tb[0].numpy(), p1)
    assert float(tm[0]) == float(jm)
    assert int(te[0]) == int(je) > 0
    blocks = pm.reshape(16, -1)
    tp = TDF.pids_decode(_t(blocks)).numpy()
    for b in range(16):
        assert np.array_equal(tp[b], np.asarray(JDF.pids_decode(
            jnp.asarray(blocks[b]))))
    assert np.array_equal(tp, pids)


# ---------------------------------------------------------------------------
# the slice: cu8 wire -> P1/PIDS bits at S = 2
# ---------------------------------------------------------------------------

def test_slice_decodes_transmitted_bits(slice_run):
    out = slice_run["out"]
    assert out["p1"].shape == (N_STATIONS, 1, C.P1_FRAME_LEN_FM)
    for s, (p1, pids) in enumerate(slice_run["truth"]):
        assert np.array_equal(out["p1"][s, 0].numpy(), p1)
        assert np.array_equal(out["pids"][s, 1:].numpy(), pids)
        assert int(out["p1_bit_errors"][s, 0]) == 0


def test_slice_matches_jax(slice_run):
    out = slice_run["out"]
    for s, (jo, _) in enumerate(slice_run["jax"]):
        assert np.array_equal(out["p1"][s].numpy(), np.asarray(jo["p1"]))
        assert np.array_equal(out["pids"][s].numpy(), np.asarray(jo["pids"]))
        d, jd = out["diag"], jo["diag"]
        assert np.abs(d["samperr"][s].numpy()
                      - np.asarray(jd["samperr"])).max() <= 1
        for k in ("error_lb", "error_ub"):
            np.testing.assert_allclose(d[k][s].numpy(), np.asarray(jd[k]),
                                       rtol=1e-3)


# carry fields that are angles or phases (radians, rad/symbol, a unit
# phasor) get an absolute tolerance; the rest compare exactly
_ANGLES = ("phase", "prev_angle", "costas_phase", "costas_freq", "angle_fb")


def test_slice_carry_matches_jax(slice_run):
    got = state.carry_to_numpy(slice_run["carry"])
    for s, (_, jc) in enumerate(slice_run["jax"]):
        ref = jc._asdict()
        # MP1 leaves the reference's PX state empty: the port carries none
        assert set(ref) - set(got) == set(state._PX_FIELDS)
        assert not any(np.any(np.asarray(ref[k])) for k in state._PX_FIELDS)
        for k in got:
            v = np.asarray(ref[k])
            if k in _ANGLES:
                np.testing.assert_allclose(got[k][s], v, rtol=1e-4,
                                           atol=CHAIN_ANGLE_ATOL, err_msg=k)
            else:
                assert np.array_equal(got[k][s], v), k


def test_carry_handover(slice_run):
    """JAX decodes the lead block, hands its carry over as numpy, and the
    port decodes the frame after it: the bits equal JAX decoding all 17
    blocks in one go."""
    for s, (jo, _) in enumerate(slice_run["jax"]):
        x = slice_run["samples"][s]
        _, jc = JRC.fm_chain_scan_rc(x, JRC.chain_rc_init_carry(), 1, 1,
                                     FIRST_BC)
        carry = state.carry_from_numpy(
            {k: np.asarray(v) for k, v in jc._asdict().items()},
            device="cpu")
        out, _ = TRC.fm_chain_scan_rc(_t(x), TRC.ChainCarryRC(
            *(t[0] for t in carry)), N_BLOCKS - 1, 1, 0)
        assert np.array_equal(out["p1"][0].numpy(), np.asarray(jo["p1"][0]))
        assert np.array_equal(out["pids"].numpy(), np.asarray(jo["pids"])[1:])


def test_carry_numpy_roundtrip():
    carry = TRC.chain_rc_init_carry(offset=5, cfo=-3, n_stations=3,
                                    device="cpu")
    back = state.carry_from_numpy(state.carry_to_numpy(carry), device="cpu")
    for a, b in zip(carry, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    single = {k: v[0] for k, v in state.carry_to_numpy(carry).items()}
    assert state.carry_from_numpy(single, device="cpu").offset.shape == (1,)


def test_carry_from_numpy_refuses_px_state():
    d = state.carry_to_numpy(TRC.chain_rc_init_carry(device="cpu"))
    d.update(px1_internal=np.zeros((1, 0), np.int8),
             px1_phase=np.zeros(1, np.int32),
             px2_internal=np.zeros((1, 0), np.int8),
             px2_phase=np.zeros(1, np.int32))
    state.carry_from_numpy(d, device="cpu")
    d["px1_internal"] = np.ones((1, 4), np.int8)
    with pytest.raises(ValueError, match="PX state"):
        state.carry_from_numpy(d, device="cpu")
    del d["offset"]
    with pytest.raises(ValueError, match="carry fields"):
        state.carry_from_numpy(d, device="cpu")
