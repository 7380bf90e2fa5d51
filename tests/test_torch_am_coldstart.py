"""The PyTorch port's AM cold start (K14) and cu8 AM ingest (K1's AM
cascade) against the JAX package, on the CPU.

The same captures, made by numpy from a seed (tests/capture_helpers'
MA1/MA3 captures through the JAX package's channel: timing offsets,
integer and fractional CFOs, AWGN, echoes), go through the JAX functions
and their ports: the host lock logic, the tone estimate and subtraction,
the coarse timing, one probe block, the cold start of one station and of a
station batch, decoding from the locks, and the cu8 ingest.  JAX runs on
the CPU as tests/conftest.py pins it; the port runs its plain PyTorch
versions, which is what a kernel wrapper does with a CPU tensor.

Tolerances, with their reasons:

=====================================  =================================
output                                 tolerance
=====================================  =================================
the host functions, k0, the measured   exact: integers and bits, and
timing, samperr, keep, the reference   argmaxes of well-separated peaks
bits, the CFO step, every lock's
offset, psmi, ma3 and cfo, the
decoded bits, the cu8 ingest
the tone's frequency f                 1e-6 cycles a sample (the issue's
                                       bound); measured ~1e-10: the
                                       8910-sample sums run in another
                                       order than XLA's
the tone-subtracted window             1e-6 of the window's peak: the tone
                                       is e^{-2πi f m} at |2π f m| up to
                                       ~200 rad here, where one float32
                                       ulp of the argument is 1.5e-5 rad
                                       and the sum orders move f by ~1e-10
the coarse timing's v                  rtol 1e-4: sums of 32 symbols and
                                       14 taps in another order, on
                                       windows that differ by the above
the magnitude sums                     1e-4 of the largest: pass 1's DFT
                                       rounds its input to bf16, so a
                                       last-bit difference upstream moves
                                       a bin by ~1e-5 of the peak
prev_angle and phase after a probe     1e-4 rad: the pilot fit reads the
block, the lock's prev_angle           DFT's bf16-rounded input, where a
                                       last-bit difference can cross a
                                       bf16 rounding edge (as in
                                       tests/test_torch_am.py)
the cu8 fidelity correlation           > 0.85, the JAX test's bound
=====================================  =================================
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nrsc5_tpu.ops import frontend as JFE
from nrsc5_tpu.ops import rcplx as JRC
from nrsc5_tpu.ops import sync_am as JSA
from nrsc5_tpu.pipeline import scan_chain_am_rc as JAR
from nrsc5_tpu.tx import channel as JCH
from nrsc5_tpu.tx import encoder_am as JEAM
from nrsc5_tpu.tx.transport_encoder import build_p1_am_frame
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import serve
from nrsc5_tpu_torch.ops import acquire_am_rc as AA
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops import sync_am as SA
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as TAR
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx import encoder_am as EAM
from nrsc5_tpu_torch.tx.modulator_am import modulate_am

from .capture_helpers import build_am_capture

BIN_HZ = C.SAMPLE_RATE_CS16_AM / C.FFT_AM
WIN = TAR.WINDOW_AM
LOCK_KEYS = ("offset", "psmi", "ma3", "cfo")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its plain versions run many
    mid-sized ops, which torch's thread pool makes slower (the cold start
    3× on its own), and beside the suite's other workers oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rc(sig):
    return np.stack([sig.real, sig.imag], -1).astype(np.float32)


def _impaired(rng, ma3, n_frames, off=0, cfo_hz=0.0, snr_db=None,
              echo=None):
    """An MA1/MA3 capture as rc [N, 2] and its audio packets: ``echo``
    (delay, amplitude) through JAX's two-ray channel, then the timing
    offset, the CFO and the AWGN."""
    sig, packets = build_am_capture(rng, n_frames=n_frames, ma3=ma3)
    if echo is not None:
        sig = JCH.multipath(sig, echo[0], echo[1], phase=1.1)
    imp = JCH.impair(sig, sample_offset=off, cfo_hz=cfo_hz, snr_db=snr_db,
                     sample_rate=C.SAMPLE_RATE_CS16_AM, rng=rng)
    return _rc(imp), packets


def _p1_truth(packets):
    return [build_p1_am_frame(pk, 0, pdu_seq=i % 8,
                              seq=((f * 8 + i % 8) * 4) % 64)
            for i, (f, pk) in enumerate(packets)]


def _lock_view(lock):
    return None if lock is None else {k: lock[k] for k in LOCK_KEYS}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the host lock logic
# ---------------------------------------------------------------------------

def test_timing_consensus_matches():
    """The cases of tests/test_am_multipath.py::test_timing_consensus and
    300 random histories of 1-6 timings clustered near the wrap."""
    cases = [[0, 0, 0], [269, 0, 1, 140], [5, 100, 200],
             [14, 14, 14, 0, 0, 13], []]
    rng = np.random.default_rng(1)
    for _ in range(300):
        n = int(rng.integers(1, 7))
        cases.append([int(x) % 270 for x in rng.integers(-4, 5, n)
                      + rng.choice([0, 0, 0, 135], n)])
    for hist in cases:
        assert SA.timing_consensus(hist, 270) == \
            JSA.timing_consensus(hist, 270), hist
    assert SA.timing_consensus([0, 0, 0], 270) == 0
    assert SA.timing_consensus([5, 100, 200], 270) is None


@pytest.mark.parametrize("psmi", [C.SERVICE_MODE_MA1, C.SERVICE_MODE_MA3])
def test_find_ref_block_true_bits(psmi):
    """Every block count's true reference bits, with and without the
    control flags, at every cyclic rotation: the same needle offset, block
    count and control word as JAX's find_ref_am and find_block_am."""
    for bc in range(8):
        for flags in ({}, {"pli": 1, "rdbi": 1}, {"hppi": 1, "aabi": 1}):
            bits = EAM.am_ref_bits(bc, psmi, **flags)
            assert np.array_equal(bits, JEAM.am_ref_bits(bc, psmi, **flags))
            got = SA.find_block_am(bits)
            assert got == JSA.find_block_am(bits)
            assert got[0] == bc
            if bc == 0:
                assert got[1]["psmi"] == psmi
            for r in range(C.BLKSZ):
                rolled = np.roll(bits, r)
                assert SA.find_ref_am(rolled) == JSA.find_ref_am(rolled)
                assert SA.find_block_am(rolled) == \
                    JSA.find_block_am(rolled)


def test_find_ref_block_random():
    """300 random 32-bit vectors and every one-bit flip of the true bits of
    block counts 0 and 5: the same results as JAX's."""
    rng = np.random.default_rng(2)
    vecs = list(rng.integers(0, 2, (300, C.BLKSZ)).astype(np.uint8))
    for bc in (0, 5):
        bits = EAM.am_ref_bits(bc, C.SERVICE_MODE_MA1)
        for k in range(C.BLKSZ):
            flipped = bits.copy()
            flipped[k] ^= 1
            vecs.append(flipped)
    hits = 0
    for v in vecs:
        assert SA.find_ref_am(v) == JSA.find_ref_am(v)
        got = SA.find_block_am(v)
        assert got == JSA.find_block_am(v)
        hits += got is not None
    assert hits < len(vecs)


# ---------------------------------------------------------------------------
# the probe kernels' plain versions, per window
# ---------------------------------------------------------------------------

# name -> (seed, ma3, CFO in Hz, SNR, echo)
WINDOWS = {
    "ma1_clean": (10, False, 0.0, None, None),
    "ma3_clean": (11, True, 0.0, None, None),
    "ma1_echo_0.5": (12, False, 0.0, 30.0, (14, 0.5)),
    "ma1_echo_0.9": (13, False, 0.0, 30.0, (14, 0.9)),
    "ma1_carrier_+2": (14, False, 2 * BIN_HZ, 30.0, None),
    "ma3_carrier_-2": (15, True, -2 * BIN_HZ, 30.0, None),
}
WINDOW_AT = 1111  # a window start off the symbol grid


@pytest.fixture(scope="module")
def windows():
    """Each case's capture (one frame) and its probe window."""
    out = {}
    for name, (seed, ma3, cfo, snr, echo) in WINDOWS.items():
        x, _ = _impaired(np.random.default_rng(seed), ma3, 1, cfo_hz=cfo,
                         snr_db=snr, echo=echo)
        out[name] = x
    return out


def _port_tone(x, at=WINDOW_AT):
    xs, off = _t(x)[None], torch.tensor([at], dtype=torch.int32)
    spectra = rc.dft(AA.tone_symbols(xs, off))
    f, amp = AA.am_tone_plain(spectra, xs, off)
    return xs, off, spectra, f, amp


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_am_tone_matches(windows, name):
    """am_tone_plain against _am_tone_subtract_rc: the same integer bin, f
    within 1e-6 cycles a sample of the tone JAX subtracted (fitted from the
    difference of JAX's window and its input), and the subtracted windows
    within 1e-6 of the window's peak."""
    x = windows[name]
    win = x[WINDOW_AT:WINDOW_AT + WIN]
    jax_out = np.asarray(JAR._am_tone_subtract_rc(jnp.asarray(win)))
    xs, off, spectra, f, amp = _port_tone(x)

    sym = jnp.asarray(win[:C.FFTCP_AM * C.BLKSZ].reshape(
        C.BLKSZ, C.FFTCP_AM, 2)[:, :C.FFT_AM])
    k0 = int(jnp.argmax(JRC.abs2(JRC.dft(sym)).sum(0)))
    k0 = k0 - C.FFT_AM if k0 >= C.FFT_AM // 2 else k0
    assert int(AA.tone_k0(spectra)[0]) == k0
    want_k0 = round(WINDOWS[name][2] / BIN_HZ)
    assert k0 == want_k0

    # JAX's tone, e^{2πi f_jax m} · amp, against the port's frequency: the
    # residual phase slope is f_jax − f
    tone = (win.astype(np.float64) - jax_out).view(np.complex128)[:, 0]
    m = np.arange(WIN) - (WIN - 1) / 2
    resid = np.unwrap(np.angle(tone * np.exp(-2j * np.pi * float(f[0]) * m)))
    slope = np.polyfit(m, resid, 1)[0] / (2 * np.pi)
    assert abs(slope) <= 1e-6, slope

    got = AA.tone_subtract(AA.am_window(xs, off), f, amp)[0].numpy()
    assert np.abs(got - jax_out).max() <= 1e-6 * np.abs(win).max()


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_am_coarse_timing_matches(windows, name):
    """am_tone_plain + am_coarse_plain against _am_coarse_timing_rc: the
    measured timing equal, v within rtol 1e-4; and the latch override and
    the prev_angle smoothing as am_coldstart_block_rc applies them."""
    x = windows[name]
    jm, jv = JAR._am_coarse_timing_rc(jnp.asarray(x[WINDOW_AT:WINDOW_AT
                                                    + WIN]))
    xs, off, _, f, amp = _port_tone(x)
    pa = torch.tensor([0.0])
    m, samperr, pa_out, v = AA.am_coarse_plain(
        xs, off, f, amp, pa, torch.tensor([-1], dtype=torch.int32))
    jv = np.asarray(jv)
    assert int(m[0]) == int(jm) == int(samperr[0])
    np.testing.assert_allclose(v[0].numpy(), jv, rtol=1e-4,
                               atol=1e-4 * np.abs(jv).max())
    assert abs(float(pa_out[0]) - float(np.angle(complex(*jv)))) <= 1e-4
    # a latch overrides the timing, the measurement is kept; a nonzero
    # prev_angle moves a quarter of the way
    m2, samperr2, pa2, _ = AA.am_coarse_plain(
        xs, off, f, amp, torch.tensor([0.3]),
        torch.tensor([275], dtype=torch.int32))
    assert int(m2[0]) == int(jm) and int(samperr2[0]) == 5
    diff = np.angle(complex(*jv) * np.exp(-0.3j))
    assert abs(float(pa2[0]) - (0.3 + 0.25 * diff)) <= 1e-4


# (window start, phase angle, prev_angle, cfo, coarse override) per station
BLOCK_CASES = {
    "fresh": [(0, 0.0, 0.0, 0, -1), (4321, 0.0, 0.0, 0, -1),
              (20000, 0.0, 0.0, 0, -1)],
    "moved": [(537, 0.7, 0.2, 2, 17), (8910, -2.0, -0.05, -1, -1),
              (33333, 2.5, 1.3, 0, 269)],
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_am_coldstart_block_matches(case):
    """One probe block for three stations (a CFO of +2 bins, an MA3 echo,
    clean MA1) against JAX's am_coldstart_block_rc per station: reference
    bits, samperr, keep, measured and the CFO step equal; the magnitude
    sums rtol 1e-4; phase and prev_angle within 1e-4."""
    rng = np.random.default_rng(30)
    caps = [_impaired(rng, False, 1, off=300, cfo_hz=2 * BIN_HZ + 31.0,
                      snr_db=30.0)[0],
            _impaired(rng, True, 1, off=50, snr_db=30.0, echo=(14, 0.5))[0],
            _impaired(rng, False, 1, off=0)[0]]
    n = min(len(c) for c in caps)
    x = np.stack([c[:n] for c in caps])
    cs = BLOCK_CASES[case]
    ang = np.array([c[1] for c in cs], np.float32)
    phase = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ints = {k: torch.tensor([c[i] for c in cs], dtype=torch.int32)
            for i, k in ((0, "offset"), (3, "cfo"), (4, "override"))}
    pa = torch.tensor([c[2] for c in cs], dtype=torch.float32)
    out = TAR.am_coldstart_block_rc(_t(x), ints["offset"], _t(phase), pa,
                                    ints["cfo"], ints["override"])
    probe = TAR.unpack_probe(out["ints"].numpy())
    lo = AA.CFO_LO
    for i, (o, _, p, cfo, ov) in enumerate(cs):
        j = JAR.am_coldstart_block_rc(
            jnp.asarray(x[i]), jnp.int32(o), jnp.asarray(phase[i]),
            jnp.float32(p), jnp.int32(cfo), jnp.int32(ov))
        ref, jph, jpa, jse, jkeep, jmags, jmeas = (np.asarray(v) for v in j)
        assert np.array_equal(probe["ref_bits"][i], ref), i
        assert probe["samperr"][i] == jse and probe["keep"][i] == jkeep
        assert probe["measured"][i] == jmeas
        band = jmags[lo:lo + AA.CFO_BINS]
        assert probe["cfo_step"][i] == int(np.argmax(band)) + lo \
            - C.CENTER_AM
        np.testing.assert_allclose(out["mag_sums"][i].numpy(), band,
                                   rtol=1e-4, atol=1e-4 * band.max())
        np.testing.assert_allclose(out["phase"][i].numpy(), jph, atol=1e-4)
        assert abs(float(out["prev_angle"][i]) - float(jpa)) <= 1e-4


# ---------------------------------------------------------------------------
# the cold start of one station, and decoding from its lock
# ---------------------------------------------------------------------------

def _decode_check(x, tlock, jlock, ma3, packets, n_frames=5, first=0):
    """Decode ``n_frames`` from both locks: the port's P1 of frames
    ``first`` on equals JAX's bit for bit, and every post-warm-up subframe
    is a transmitted one.  Returns both outputs."""
    need = TAR.am_buffer_len(n_frames)
    seg = x[tlock["offset"]:tlock["offset"] + need]
    tout, _ = TAR.am_chain_scan_rc(_t(seg), tlock["carry"], n_frames, ma3)
    jout, _ = JAR.am_chain_scan_rc(jnp.asarray(seg), jlock["carry"],
                                   n_frames, ma3)
    p1 = tout["p1"].numpy()
    assert np.array_equal(p1[first:], np.asarray(jout["p1"])[first:])
    truth = _p1_truth(packets)
    matches = sum(1 for fi in range(n_frames) for sub in range(8)
                  if any(np.array_equal(p1[fi, sub], t) for t in truth))
    assert matches == n_frames * 8 - 24, matches
    return tout, jout


def _lock_check(tlock, jlock):
    assert tlock is not None and jlock is not None
    assert _lock_view(tlock) == _lock_view(jlock)
    assert abs(float(tlock["carry"].prev_angle)
               - float(jlock["carry"].prev_angle)) <= 1e-4
    assert tlock["carry"].phase.tolist() == [1.0, 0.0]
    assert int(tlock["carry"].cfo) == tlock["cfo"]
    assert int(tlock["carry"].offset) == 0 \
        and int(tlock["carry"].samperr_fb) == 0


@pytest.mark.parametrize("ma3", [False, True])
def test_am_cold_start_rc(ma3):
    """The twin of tests/test_scan_chain.py::test_am_cold_start_rc: MA1 at
    +2 bins + 31 Hz behind 777 samples, MA3 at -1 bin + 17 Hz behind 500,
    30 dB.  The port's lock equals JAX's, and 5 frames decoded from it give
    JAX's P1 with every post-warm-up subframe right."""
    cfo_hz, off = ((-1 * BIN_HZ + 17.0, 500) if ma3
                   else (2 * BIN_HZ + 31.0, 777))
    rng = np.random.default_rng(0x5EED + ma3)
    x, packets = _impaired(rng, ma3, 9, off=off, cfo_hz=cfo_hz, snr_db=30.0)
    tlock = TAR.cold_start_am_rc(x, device="cpu")
    jlock = JAR.cold_start_am_rc(x)
    _lock_check(tlock, jlock)
    assert tlock["ma3"] == ma3 and tlock["cfo"] == round(cfo_hz / BIN_HZ)
    _decode_check(x, tlock, jlock, ma3, packets)


@pytest.fixture(scope="module")
def echo():
    """The capture of tests/test_am_multipath.py::
    test_am_ma3_echo_cold_start_rc (MA3 through a 0.5 echo at delay 14, 30
    dB) and both packages' locks on it."""
    rng = np.random.default_rng(0x5EED)
    sig, packets = build_am_capture(rng, n_frames=9, ma3=True)
    imp = JCH.impair(JCH.multipath(sig, 14, 0.5, phase=1.1), snr_db=30.0,
                     sample_rate=C.SAMPLE_RATE_CS16_AM,
                     rng=np.random.default_rng(7))
    x = _rc(imp)
    return {"x": x, "packets": packets,
            "port": TAR.cold_start_am_rc(x, device="cpu"),
            "jax": JAR.cold_start_am_rc(x)}


def test_am_ma3_echo_cold_start_rc(echo):
    """The twin of tests/test_am_multipath.py::
    test_am_ma3_echo_cold_start_rc: the port's lock equals JAX's, and 5
    frames decoded from it give every post-warm-up subframe right and
    JAX's P1 bit for bit on frames 2-4.  Warm-up frame 1 differs by one
    QAM code at a decision threshold (test_am_ma3_echo_warm_up_flip)."""
    _lock_check(echo["port"], echo["jax"])
    assert echo["port"]["ma3"]
    tout, jout = _decode_check(echo["x"], echo["port"], echo["jax"], True,
                               echo["packets"], first=2)
    for k in ("p1_margin", "p3_margin", "pids"):
        assert np.array_equal(tout[k].numpy(), np.asarray(jout[k])), k
    assert np.array_equal(tout["p3"][2:].numpy(), np.asarray(jout["p3"])[2:])


def test_am_ma3_echo_warm_up_flip(echo):
    """Where the echo capture's decode leaves JAX's: from JAX's own lock
    carry, the port's K13 on JAX's spectra gives JAX's codes in every one of
    the first 16 blocks; but the spectra of the port's block loop drift
    from JAX's through the DFT's bf16 input rounding (the pilot fit carries
    a last-bit difference into the next block's phase), and by block 13
    (frame 1) one MA3 QAM64 code of its 3200 sits at a decision threshold
    (equalized value -2.00004 here) and comes out the other side.  Frame 1
    is diversity warm-up with P1 margin 0; nothing after it differs."""
    jl = echo["jax"]
    seg = echo["x"][jl["offset"]:jl["offset"] + TAR.am_buffer_len(2)]
    cy = jl["carry"]
    samples = jnp.asarray(seg)
    off, ph, pa, sfb = cy.offset, cy.phase, cy.prev_angle, cy.samperr_fb
    j_codes, j_spectra = [], []
    for _ in range(16):
        win = samples[int(off):int(off) + WIN]
        sp, ph, pa, _, keep, _ = JAR.acquire_am_fine_rc(win, ph, pa, sfb,
                                                        cy.cfo)
        out = JAR.sync_am_block_rc(sp, True)
        j_codes.append(np.stack([np.asarray(out[k])
                                 for k in ("pl", "pu", "s", "t")]))
        j_spectra.append(np.asarray(sp))
        off, sfb = off + (WIN - keep), out["samperr"]
    ours = TAR.sync_am_block_rc_plain(_t(np.stack(j_spectra)), True)
    assert np.array_equal(ours["codes"].numpy(), np.stack(j_codes))

    carry = TAR.AMChainCarryRC(
        *(torch.tensor(np.asarray(v))[None] for v in cy[:-1]),
        TAR.DA.am_decode_init_state(1, device="cpu"))
    codes, _, _ = TAR.am_frontend_scan_rc(_t(seg)[None], carry, 16, True)
    diff = np.argwhere(codes[0].numpy() != np.stack(j_codes))
    assert diff.tolist() == [[13, 2, 86]]


@pytest.mark.parametrize("ma3", [False, True])
@pytest.mark.parametrize("seed", [0x5EED, 1])
def test_am_coarse_timing_clean_stability(ma3, seed):
    """The twin of tests/test_am_multipath.py::
    test_am_coarse_timing_clean_stability: on a clean capture the port's
    coarse timing (am_tone then am_coarse) is within ±1 sample of the
    symbol grid at each of the first 6 blocks."""
    rng = np.random.default_rng(seed)
    sig, _ = build_am_capture(rng, n_frames=4, ma3=ma3)
    xs = _t(_rc(np.asarray(sig, np.complex64)))[None].repeat(6, 1, 1)
    blk = C.FFTCP_AM * C.BLKSZ
    off = torch.arange(6, dtype=torch.int32) * blk
    spectra = rc.dft(AA.tone_symbols(xs, off))
    f, amp = AA.am_tone_plain(spectra, xs, off)
    m, _, _, _ = AA.am_coarse_plain(xs, off, f, amp, torch.zeros(6),
                                    torch.full((6,), -1, dtype=torch.int32))
    for b, err in enumerate(m.tolist()):
        assert min(err, C.FFTCP_AM - err) <= 1, (ma3, seed, b, err)


# ---------------------------------------------------------------------------
# a station batch through serve, from the cs16 wire
# ---------------------------------------------------------------------------

# (ma3, sample offset, CFO in Hz) of the stations that lock; a fourth
# station carries noise alone
BATCH = [(False, 1234, 2 * BIN_HZ + 20.0), (True, 321, -1 * BIN_HZ - 25.0),
         (False, 2999, -2 * BIN_HZ + 5.0)]
BATCH_FRAMES = 7


@pytest.fixture(scope="module")
def batch():
    """Three stations and a noise-only one, cs16 at 0.1 of full scale, cold
    started in one serve.cold_start call; JAX's cold start of each station
    alone on the same ingested samples."""
    rng = np.random.default_rng(40)
    caps = [_impaired(rng, ma3, BATCH_FRAMES, off=off, cfo_hz=cfo,
                      snr_db=30.0)[0] for ma3, off, cfo in BATCH]
    n = min(len(c) for c in caps)
    noise = rng.normal(0, 0.01, (n, 2)).astype(np.float32)
    x = np.stack([c[:n] for c in caps] + [noise])
    x *= 0.1 / np.sqrt((x ** 2).sum(-1).mean(-1))[:, None, None]
    wire = np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    samples = wire.astype(np.float32) * (1.0 / 32768.0)
    locks = serve.cold_start(wire, "am", device="cpu")
    jax_locks = [JAR.cold_start_am_rc(s) for s in samples]
    return {"wire": wire, "samples": samples, "locks": locks,
            "jax_locks": jax_locks}


def test_batch_locks_match_jax(batch):
    """Each station's lock, from the batched lockstep cold start, equals
    JAX's cold start of that station alone; the noise-only station locks in
    neither."""
    locks, jax_locks = batch["locks"], batch["jax_locks"]
    assert len(locks) == len(BATCH) + 1
    for (ma3, _, cfo), tl, jl in zip(BATCH, locks, jax_locks):
        _lock_check(tl, jl)
        assert tl["ma3"] == ma3 and tl["cfo"] == round(cfo / BIN_HZ)
    assert locks[-1] is None and jax_locks[-1] is None


def test_batch_decodes_from_locks(batch):
    """carry_from_locks on the MA1 stations, then serve.chain_step_am on
    the same cs16 wire from the lock points, decodes what JAX's
    am_chain_batch_rc decodes from the same locks."""
    ma1 = [i for i, (ma3, _, _) in enumerate(BATCH) if not ma3]
    carry, ma3 = serve.carry_from_locks([batch["locks"][i] for i in ma1])
    assert not ma3
    assert carry.offset.tolist() == [batch["locks"][i]["offset"]
                                     for i in ma1]
    n_frames = 4
    out, new = serve.chain_step_am(batch["wire"][ma1], carry, n_frames,
                                   device="cpu")
    jcarry = jax.tree.map(lambda *v: jnp.stack(v), *(
        lk["carry"]._replace(offset=jnp.int32(lk["offset"]))
        for lk in (batch["jax_locks"][i] for i in ma1)))
    jo, _ = JAR.am_chain_batch_rc(jnp.asarray(batch["samples"][ma1]),
                                  jcarry, n_frames, False)
    for k in ("p1", "p3", "pids", "p1_margin", "p3_margin"):
        assert np.array_equal(out[k].numpy(), np.asarray(jo[k])), k
    assert (new.offset > carry.offset).all()


def test_carry_from_locks_refuses_am(batch):
    """Mixed MA1 and MA3 locks, a station without a lock, and FM locks
    among AM ones are refused."""
    locks = batch["locks"]
    with pytest.raises(ValueError, match="disagree on ma3"):
        serve.carry_from_locks(locks[:2])
    with pytest.raises(ValueError, match="did not lock"):
        serve.carry_from_locks([locks[0], locks[-1]])
    fm_like = {"offset": 0, "psmi": 1, "first_bc": 0, "cfo": 0,
               "carry": locks[0]["carry"]}
    with pytest.raises(ValueError, match="mix FM and AM"):
        serve.carry_from_locks([locks[0], fm_like])


def test_cold_start_one_station(batch):
    """A [N, 2] capture is one station: one lock, not a list, equal to the
    batch's."""
    lock = TAR.cold_start_am_rc(batch["samples"][1], device="cpu")
    assert _lock_view(lock) == _lock_view(batch["locks"][1])


def test_cold_start_short_capture():
    """A capture shorter than one probe window gives no lock."""
    x = np.zeros((2, WIN - 1, 2), np.float32)
    assert TAR.cold_start_am_rc(x, device="cpu") == [None, None]


# ---------------------------------------------------------------------------
# the cu8 AM ingest (K1's AM cascade), and cf32
# ---------------------------------------------------------------------------

def test_ingest_am_cu8_matches_jax():
    """The plain cascade, and the wrapper on a CPU tensor, bit for bit
    against JAX's decimate_overlap_rc(((u − 127)·64/32767)·(1/16), 5) on a
    random cu8 wire of two stations."""
    rng = np.random.default_rng(50)
    n = 777
    wire = rng.integers(0, 256, (2, FE.rc_overlap(5) + 32 * n, 2)).astype(
        np.uint8)
    f = (jnp.asarray(wire).astype(jnp.float32) - 127.0) * (64.0 / 32767.0)
    want = np.asarray(JFE.decimate_overlap_rc(f * (1.0 / 16.0), 5))
    got = FE.ingest_am_cu8_plain(_t(wire))
    assert got.shape == (2, n, 2) and np.array_equal(got.numpy(), want)
    assert torch.equal(FE.ingest_am_cu8(_t(wire)), got)
    assert torch.equal(serve.ingest(wire, "am", device="cpu"), got)


def test_am_cu8_decimator_fidelity():
    """The twin of tests/test_l1_am.py::test_am_cu8_decimator_fidelity,
    through serve.ingest on the cu8 wire with its 217 history pairs: two
    frames of MA1 at 0.05 scale, upsampled ×32 by Fourier interpolation;
    the decimated stream's normalized cross-correlation with the baseband
    exceeds 0.85, at lag 0 (the history gives the cascade zero delay)."""
    rng = np.random.default_rng(51)
    n_frames = 2
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(rng.integers(0, 2, (8, C.P1_FRAME_LEN_AM))
                          .astype(np.uint8)) for _ in range(n_frames)],
        [EAM.encode_p3_am(rng.integers(0, 2, C.P3_FRAME_LEN_MA1)
                          .astype(np.uint8), False)
         for _ in range(n_frames)], False)
    pids = np.stack([EAM.encode_pids_am(rng.integers(0, 2, 80).astype(
        np.uint8)) for _ in range(8 * n_frames)])
    ref = np.stack([EAM.am_ref_bits(b % 8, 1) for b in range(8 * n_frames)])
    sig = modulate_am(mats, pids, ref, False, scale=0.05)
    wire = serve.stream_wire(ch.to_cu8(ch.upsample_exact(sig, 32)), 5)
    assert np.all(wire[:217] == 127) and len(wire) == 217 + 32 * len(sig)
    wire = wire[:FE.rc_overlap(5) + 32 * (len(sig) - 8)]
    y = serve.ingest(wire[None], "am", device="cpu")[0].numpy()
    y = y.view(np.complex64)[:, 0]
    assert len(y) == len(sig) - 8
    n = 1 << 16
    ref_seg = sig[:n]
    corr = [abs(np.vdot(y[lag:lag + n], ref_seg))
            / (np.linalg.norm(y[lag:lag + n]) * np.linalg.norm(ref_seg))
            for lag in range(16)]
    assert max(corr) > 0.85, corr
    assert int(np.argmax(corr)) == 0


def test_ingest_cf32_and_cs16():
    """cf32 (float32 rc) passes through unchanged in both modes, as the
    reference receiver's input_format="cf32" does; cs16 is scaled by
    1/32768 in both modes."""
    x = torch.randn(2, 300, 2)
    assert serve.ingest(x, "am", device="cpu") is x
    assert serve.ingest(x, "fm", device="cpu") is x
    w = np.random.default_rng(52).integers(-32768, 32768, (2, 300, 2)
                                           ).astype(np.int16)
    for mode in ("fm", "am"):
        got = serve.ingest(w, mode, device="cpu")
        assert np.array_equal(got.numpy(), w.astype(np.float32) / 32768.0)


_COLD_ENTRY_POINTS = {
    "cold_start_am": lambda: serve.cold_start(
        torch.zeros(1, WIN, 2, dtype=torch.int16), "am"),
    "cold_start_am_rc": lambda: TAR.cold_start_am_rc(
        np.zeros((WIN, 2), np.float32)),
    "ingest_am_cu8": lambda: serve.ingest(
        torch.full((1, FE.rc_overlap(5) + 32, 2), 127, dtype=torch.uint8),
        "am"),
}


@pytest.mark.parametrize("entry", sorted(_COLD_ENTRY_POINTS))
def test_cold_entry_points_default_to_cuda(entry):
    """With no card and no ``device=``, the AM cold start and the cu8 AM
    ingest raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _COLD_ENTRY_POINTS[entry]()


def test_probe_wrappers_check_shapes():
    """The K14 wrappers refuse spectra and state of the wrong shape."""
    xs = torch.zeros(2, WIN, 2)
    off = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="spectra"):
        AA.am_tone(torch.zeros(2, 32, 128, 2), xs, off)
    with pytest.raises(ValueError, match="offset"):
        AA.am_window(xs, off[:1])
    with pytest.raises(ValueError, match="amp"):
        AA.am_coarse(xs, off, torch.zeros(2), torch.zeros(2), torch.zeros(2),
                     off)
    with pytest.raises(ValueError, match="spectra"):
        AA.am_cfo_step(torch.zeros(2, 31, 256, 2))
