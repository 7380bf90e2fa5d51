"""The PyTorch port's FM cold start against the JAX package, on the CPU.

The same captures, made by numpy from a seed (MP1 with lead blocks of
block count 14 and 15, a timing offset, an integer plus fractional CFO and
AWGN at 25 dB), go through the JAX functions and their ports: the coarse
timing (K9), the CFO × offset needle search (K3 then the needle count of
K10), both cold-start probes, and the cold start of a two-station fleet
from the cu8 wire through ``serve.cold_start`` and on into
``serve.chain_step``.  JAX runs on the CPU as tests/conftest.py pins it;
the port runs its plain PyTorch versions, which is what a kernel wrapper
does with a CPU tensor.

Tolerances, with their reasons:

=====================================  =================================
output                                 tolerance
=====================================  =================================
samperr of the coarse timing, the      exact: integers; the argmax of
needle count table, ref_ok/bc/psmi,    2160 well-separated correlation
the lock (offset, first_bc, psmi,      peaks, and signs of Costas-tracked
cfo), the decoded P1 and PIDS bits     refs far from zero
max_v of the coarse timing             rtol 1e-4: XLA's convolutions sum
                                       the 32-tap filter and the 112-tap
                                       window in another order than the
                                       port's index-order loops
probe angle, the lock carry's          1e-6 rad: the angle of max_v, so
prev_angle                             its rounding, in float32 atan2
the rest of the lock carry             exact: the fresh carry's constants
=====================================  =================================
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nrsc5_tpu.ops import acquire_rc as JAQ
from nrsc5_tpu.ops import frontend as JFE
from nrsc5_tpu.pipeline import scan_chain_rc as JRC
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import serve, state
from nrsc5_tpu_torch.ops import acquire_rc as TAQ
from nrsc5_tpu_torch.ops import detect_cfo as TDC
from nrsc5_tpu_torch.ops import frontend as TFE
from nrsc5_tpu_torch.pipeline import scan_chain_rc as TRC
from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
from nrsc5_tpu_torch.tx.modulator import modulate_fm

BIN_HZ = C.SAMPLE_RATE_CS16_FM / C.FFT_FM
LEAD = 2  # lead blocks, bc 14 and 15, ahead of one P1 frame
N_BLOCKS = LEAD + C.P1_FM_BLOCKS
# chain samples of a capture: the chain's buffer past the largest offset
N_CHAIN = buffer_len(N_BLOCKS) + 2 * C.FFTCP_FM
ANGLE_ATOL = 1e-6
# (sample offset, CFO in Hz) of the two stations: both signs of the
# integer CFO, each with a fractional part
STATIONS = [(1357, 5 * BIN_HZ + 41.0), (2789, -7 * BIN_HZ - 30.0)]


def _bits(rng, *shape):
    return rng.integers(0, 2, shape).astype(np.uint8)


def _capture(rng, sample_offset, cfo_hz):
    """One station's impaired baseband, N_CHAIN + 8 samples (8 of lookahead
    for the cu8 halfband), and its P1 frame and PIDS words (the lead
    blocks' PIDS words first)."""
    p1 = _bits(rng, C.P1_FRAME_LEN_FM)
    pids = _bits(rng, C.P1_FM_BLOCKS, C.PIDS_FRAME_LEN)
    lead_pids = _bits(rng, C.P1_FM_BLOCKS, C.PIDS_FRAME_LEN)
    lead = build_pm_matrix(_bits(rng, C.P1_FRAME_LEN_FM),
                           lead_pids)[(C.P1_FM_BLOCKS - LEAD) * C.BLKSZ:]
    matrix = np.concatenate([lead, build_pm_matrix(p1, pids)])
    bc = np.r_[np.arange(C.P1_FM_BLOCKS - LEAD, C.P1_FM_BLOCKS),
               np.arange(C.P1_FM_BLOCKS)]
    sig = modulate_fm(matrix, bc, 1)
    clean = np.zeros(N_CHAIN + 8, np.complex64)
    clean[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    noisy = ch.impair(clean, sample_offset=sample_offset, cfo_hz=cfo_hz,
                      snr_db=25.0, rng=rng)[:N_CHAIN + 8]
    return noisy, p1, np.concatenate([lead_pids[-LEAD:], pids])


def _conj_rc(sig):
    return np.stack([sig.real, -sig.imag], -1).astype(np.float32)


def _jax_ingest(wire_row):
    """The reference receiver's cu8 FM ingest (nrsc5_tpu/serve.py:315-319)."""
    f = (jnp.asarray(wire_row).astype(jnp.float32) - 127.0) * (64.0 / 32767.0)
    f = f * jnp.asarray(np.array([1.0, -1.0], np.float32))
    return JFE.decimate_overlap_rc(f, 1)


# ---------------------------------------------------------------------------
# K9 and K10 alone (twin of test_rc_coarse_and_cfo_probe_match_complex)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("station", range(len(STATIONS)))
def test_coarse_timing_and_cfo_scan_match(station):
    """The coarse timing on the first window, then the needle count on the
    same spectra (JAX's demodulation of that window at the timing's angle)
    fed to both."""
    rng = np.random.default_rng(20 + station)
    sig, _, _ = _capture(rng, *STATIONS[station])
    win = _conj_rc(sig[:TAQ.WINDOW_FM])
    js, jv = JAQ.coarse_timing_rc(jnp.asarray(win))
    ts, tv = TAQ.coarse_timing_rc(torch.from_numpy(win)[None])
    assert int(ts[0]) == int(js)
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv), rtol=1e-4)

    spectra, _, _, _ = JAQ.demod_rc(
        jnp.asarray(win), jnp.asarray(np.array([1.0, 0.0], np.float32)), js,
        jnp.arctan2(jv[1], jv[0]), jnp.int32(0))
    jc = np.asarray(JAQ.detect_cfo_scan_rc(spectra))
    tc = TDC.detect_cfo_scan_rc(torch.from_numpy(np.array(spectra))[None])
    assert tc.dtype == torch.int32 and tc.shape == (1, 76, 32)
    assert np.array_equal(tc[0].numpy(), jc)
    # the peak sits at the true integer CFO, with the ingest's sign flip
    ci, _ = np.unravel_index(np.argmax(jc), jc.shape)
    assert abs(ci - TDC.CFO_RANGE) == round(abs(STATIONS[station][1]) / BIN_HZ)


# ---------------------------------------------------------------------------
# the probes and the cold start of a two-station fleet from the cu8 wire
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet():
    rng = np.random.default_rng(0xC01D)
    caps = [_capture(rng, *st) for st in STATIONS]
    wire = np.stack([serve.stream_wire(ch.to_cu8(ch.upsample2(sig)))[
        :TFE.rc_overlap(1) + 2 * N_CHAIN] for sig, _, _ in caps])
    samples = [_jax_ingest(row) for row in wire]
    locks = serve.cold_start(wire, device="cpu")
    return {"wire": wire, "samples": samples, "locks": locks,
            "truth": [(p1, pids) for _, p1, pids in caps],
            "jax_locks": [JRC.cold_start_rc(x) for x in samples]}


def test_coldstart_probe_matches(fleet):
    x = torch.from_numpy(np.stack([np.asarray(s) for s in fleet["samples"]]))
    ts, ta, tc = TRC.coldstart_probe_rc(x)
    for i, xs in enumerate(fleet["samples"]):
        js, ja, jc = JRC.coldstart_probe_rc(xs)
        assert int(ts[i]) == int(js)
        assert np.array_equal(tc[i].numpy(), np.asarray(jc))
        np.testing.assert_allclose(float(ta[i]), float(ja), rtol=0,
                                   atol=ANGLE_ATOL)


def test_bc_probe_matches(fleet):
    """The block-count probe at each station's lock point, on the lock's
    angle and CFO, fed to both."""
    locks = fleet["jax_locks"]
    x = torch.from_numpy(np.stack([np.asarray(s) for s in fleet["samples"]]))
    angle = np.array([float(lk["carry"].prev_angle) for lk in locks],
                     np.float32)
    tok, tbc, tps = TRC.bc_probe_rc(
        x, torch.tensor([lk["offset"] for lk in locks], dtype=torch.int32),
        torch.from_numpy(angle),
        torch.tensor([lk["cfo"] for lk in locks], dtype=torch.int32))
    for i, xs in enumerate(fleet["samples"]):
        jok, jbc, jps = JRC.bc_probe_rc(
            xs, jnp.int32(locks[i]["offset"]), jnp.float32(angle[i]),
            jnp.int32(locks[i]["cfo"]))
        assert np.array_equal(tok[i].numpy(), np.asarray(jok))
        assert np.array_equal(tbc[i].numpy(), np.asarray(jbc))
        assert np.array_equal(tps[i].numpy(), np.asarray(jps))
        assert tok[i].sum() >= 4


def test_cold_start_locks_match(fleet):
    """Each station locks where JAX's cold_start_rc locks it, on the first
    lead block, with the true integer CFO under the ingest's sign flip."""
    for i, (lock, jl) in enumerate(zip(fleet["locks"], fleet["jax_locks"])):
        assert lock is not None and jl is not None
        for key in ("offset", "first_bc", "psmi", "cfo"):
            assert lock[key] == jl[key], key
        assert lock["first_bc"] == C.P1_FM_BLOCKS - LEAD
        assert lock["psmi"] == 1
        assert lock["cfo"] == -round(STATIONS[i][1] / BIN_HZ)
        want = state.carry_from_numpy(
            {k: np.asarray(v) for k, v in jl["carry"]._asdict().items()},
            device="cpu")
        for name, a, b in zip(TRC.ChainCarryRC._fields, lock["carry"],
                              want):
            if name == "prev_angle":
                np.testing.assert_allclose(a.numpy(), b[0].numpy(), rtol=0,
                                           atol=ANGLE_ATOL)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b[0]), name


def test_cold_start_decodes(fleet):
    """serve.chain_step from the stacked locks decodes the transmitted P1
    frame and every PIDS word, as JAX's chain does from JAX's lock."""
    carry, psmi, first_bc = serve.carry_from_locks(fleet["locks"])
    out, _ = serve.chain_step(fleet["wire"], carry, N_BLOCKS, psmi, first_bc,
                              device="cpu")
    n = buffer_len(N_BLOCKS)
    for i, (p1, pids) in enumerate(fleet["truth"]):
        jl = fleet["jax_locks"][i]
        x = fleet["samples"][i][jl["offset"]:jl["offset"] + n]
        jo, _ = JRC.fm_chain_scan_rc(x, jl["carry"], N_BLOCKS, jl["psmi"],
                                     jl["first_bc"])
        assert np.array_equal(out["p1"][i, 0].numpy(), p1)
        assert np.array_equal(out["p1"][i].numpy(), np.asarray(jo["p1"]))
        assert np.array_equal(out["pids"][i].numpy(), pids)
        assert np.array_equal(out["pids"][i].numpy(), np.asarray(jo["pids"]))


def test_cold_start_one_station(fleet):
    """A [N, 2] capture is one station: one lock, not a list."""
    lock = TRC.cold_start_rc(np.array(fleet["samples"][1]), device="cpu")
    assert lock["offset"] == fleet["locks"][1]["offset"]
    assert lock["carry"].costas_phase.shape == (C.FFT_FM,)


def test_cold_start_no_signal():
    """Noise alone does not lock."""
    rng = np.random.default_rng(9)
    noise = rng.normal(0, 0.1, (2, TAQ.WINDOW_FM + C.FFTCP_FM * 40, 2))
    assert TRC.cold_start_rc(noise.astype(np.float32), device="cpu") \
        == [None, None]


def test_carry_from_locks_refuses(fleet):
    locks = fleet["locks"]
    with pytest.raises(ValueError, match="did not lock"):
        serve.carry_from_locks([locks[0], None])
    for key in ("psmi", "first_bc"):
        other = dict(locks[1], **{key: locks[1][key] + 1})
        with pytest.raises(ValueError, match=f"disagree on {key}"):
            serve.carry_from_locks([locks[0], other])
