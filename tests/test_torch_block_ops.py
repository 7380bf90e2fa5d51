"""The complex-chain ops of the port's per-block receivers against the JAX
package's, on the CPU: the frontend (``fm_decimate``, ``am_decimate``,
``decimate_batch``, ``cu8_to_cf``), ``acquire_fm`` and ``acquire_am``
(coarse and fine), ``costas_track``, ``sync_fm_block`` (psmi 1, 2, 3, 11
and 5), ``sync_am_block`` (MA1, MA3), ``detect_cfo_scan``,
``am_pids_decode`` (``pids1_disabled`` both ways) and ``am_frame_decode``;
and the twins of tests/test_frontend.py:21 and :36.

Tolerances: integer outputs (timings, keep, counts, codes, reference bits,
soft bits, decoded bits) exact at these inputs; the float outputs
(spectra, phases, angles, error sums) within 1e-4 of the largest magnitude
of their array (``_close``): the FFTs and the transcendental functions of
the two libraries round differently, and the sums run in other orders
(measured: under 2e-6); the halfband and the cu8 conversion exact (the
same products in the same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.ops import acquire as JA
from nrsc5_tpu.ops import decode_am as JDA
from nrsc5_tpu.ops import detect_cfo as JD
from nrsc5_tpu.ops import frontend as JFE
from nrsc5_tpu.ops import sync_am as JSA
from nrsc5_tpu.ops import sync_fm as JS
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx import encoder_am as EAM
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu.tx.modulator_am import modulate_am
from nrsc5_tpu_torch.ops import acquire as TA
from nrsc5_tpu_torch.ops import decode_am as TDA
from nrsc5_tpu_torch.ops import detect_cfo as TD
from nrsc5_tpu_torch.ops import frontend as TFE
from nrsc5_tpu_torch.ops import sync_am as TSA
from nrsc5_tpu_torch.ops import sync_fm as TS

from . import block_twins as BT

TOL = 1e-4

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _bits(x):
    """A float or complex array's bit patterns, to hold it exact."""
    return _np(x).view(np.int32)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


@pytest.fixture(scope="module")
def fm_window():
    """One FM window 777 samples late, 400 Hz off, 25 dB."""
    rng = np.random.default_rng(21)
    m = build_pm_matrix(rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(
        np.uint8), rng.integers(0, 2, (16, 80)).astype(np.uint8))
    sig = modulate_fm(m[:3 * 32], np.arange(3), 1)
    sig = ch.impair(sig, sample_offset=777, cfo_hz=400.0, snr_db=25.0,
                    rng=rng)
    return sig[:JA.WINDOW_FM].astype(np.complex64)


@pytest.fixture(scope="module")
def fm_spectra(fm_window):
    out = jax.jit(JA.acquire_fm)(
        jnp.asarray(fm_window), JA.acquire_init_state(), jnp.asarray(False),
        jnp.asarray(0, jnp.int32), jnp.asarray(0.0, jnp.float32),
        jnp.asarray(0, jnp.int32))
    return np.array(out[0])


@pytest.fixture(scope="module")
def am_windows():
    """An MA1 and an MA3 window of 2 frames, 300 samples late, 30 dB."""
    rng = np.random.default_rng(22)
    out = {}
    for ma3 in (False, True):
        p1 = rng.integers(0, 2, (2, 8, C.P1_FRAME_LEN_AM)).astype(np.uint8)
        t3 = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
        p3 = rng.integers(0, 2, (2, t3)).astype(np.uint8)
        mats = EAM.interleave_frames(
            [EAM.encode_p1_am(p1[f]) for f in range(2)],
            [EAM.encode_p3_am(p3[f], ma3) for f in range(2)], ma3)
        pc = np.stack([EAM.encode_pids_am(rng.integers(0, 2, 80).astype(
            np.uint8)) for _ in range(16)])
        ref = np.stack([EAM.am_ref_bits(b % 8, 2 if ma3 else 1)
                        for b in range(16)])
        sig = modulate_am(mats, pc, ref, ma3)
        sig = ch.impair(sig, sample_rate=C.SAMPLE_RATE_CS16_AM,
                        sample_offset=300, snr_db=30.0, rng=rng)
        out[ma3] = sig[:JA.WINDOW_AM].astype(np.complex64)
    return out


def test_halfband_dc_gain():
    """The twin of tests/test_frontend.py:21: steady-state DC gain 1."""
    x = np.ones(1024, np.complex64)
    want, _ = JFE.fm_decimate(jnp.asarray(x), JFE.frontend_init_state(1))
    y, _ = TFE.fm_decimate(torch.from_numpy(x),
                           TFE.frontend_init_state(1, device="cpu"))
    assert y.shape == (512,)
    assert np.allclose(y[32:].numpy(), 1.0, atol=2e-3)
    _same(_bits(y), _bits(want))


def test_halfband_streaming_matches_batch():
    """The twin of tests/test_frontend.py:36: pushes of 512 with the
    carried tail give the one-shot result; each equal to JAX's."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (4096, 2)).astype(np.float32).view(
        np.complex64)[:, 0]
    full, _ = TFE.fm_decimate(torch.from_numpy(x),
                              TFE.frontend_init_state(1, device="cpu"))
    st, parts = TFE.frontend_init_state(1, device="cpu"), []
    for i in range(0, 4096, 512):
        y, st = TFE.fm_decimate(torch.from_numpy(x[i:i + 512]), st)
        parts.append(y.numpy())
    assert np.allclose(np.concatenate(parts), full.numpy(), atol=1e-6)
    want, _ = JFE.fm_decimate(jnp.asarray(x), JFE.frontend_init_state(1))
    _same(_bits(full), _bits(want))


@pytest.mark.parametrize("stages", [1, 3, 5])
def test_decimate_batch_and_am(stages):
    """``decimate_batch`` on 3 stations with carried [3, 14] tails over
    two pushes, and ``am_decimate`` (÷32 after the 1/16) on cu8, against
    JAX's: exact."""
    rng = np.random.default_rng(30 + stages)
    x = rng.normal(0, 1, (3, 2048, 2)).astype(np.float32).view(
        np.complex64)[..., 0]
    jst = JFE.FrontendState(tuple(jnp.zeros((3, 14), jnp.complex64)
                                  for _ in range(stages)))
    tst = TFE.FrontendState(tuple(torch.zeros(3, 14, dtype=torch.complex64)
                                  for _ in range(stages)))
    for half in (x[:, :1024], x[:, 1024:]):
        want, jst = JFE.decimate_batch(jnp.asarray(half), jst, stages)
        got, tst = TFE.decimate_batch(torch.from_numpy(half.copy()), tst,
                                      stages)
        _same(_bits(got), _bits(want))
    u8 = rng.integers(0, 256, 2 * 4096).astype(np.uint8)
    _same(_bits(TFE.cu8_to_cf(torch.from_numpy(u8))),
          _bits(JFE.cu8_to_cf(jnp.asarray(u8))))
    want, _ = JFE.am_decimate(JFE.cu8_to_cf(jnp.asarray(u8)),
                              JFE.frontend_init_state(5))
    got, _ = TFE.am_decimate(TFE.cu8_to_cf(torch.from_numpy(u8)),
                             TFE.frontend_init_state(5, device="cpu"))
    _same(_bits(got), _bits(want))


@pytest.mark.parametrize("fine", [False, True])
def test_acquire_fm(fm_window, fine):
    """acquire_fm, the coarse CP correlation (fine false) and the sync
    feedback (fine true), with an integer CFO of 2 bins: samperr and keep
    exact, the spectra, the carried phase and the angle within TOL."""
    want = jax.jit(JA.acquire_fm)(
        jnp.asarray(fm_window), JA.acquire_init_state(), jnp.asarray(fine),
        jnp.asarray(3, jnp.int32), jnp.asarray(0.01, jnp.float32),
        jnp.asarray(2, jnp.int32))
    got = TA.acquire_fm(torch.from_numpy(fm_window),
                        TA.acquire_init_state(device="cpu"), fine, 3, 0.01, 2)
    _close(got[0], want[0])
    _close(got[1].phase, want[1].phase)
    _close(got[1].prev_angle, want[1].prev_angle)
    _same(got[2], want[2])
    _close(got[3], want[3])
    _same(got[4], want[4])
    if not fine:
        assert int(got[2]) == 777  # the window's own timing


@pytest.mark.parametrize("ma3", [False, True])
@pytest.mark.parametrize("fine", [False, True])
def test_acquire_am(am_windows, ma3, fine):
    """acquire_am on MA1 and MA3, coarse (the carrier tone subtracted
    ahead of the CP correlation) and fine, with an integer CFO of 1 bin:
    samperr, keep and the timing measurement exact, the spectra, the
    magnitude sums, the phase and the angle within TOL."""
    win = am_windows[ma3]
    want = jax.jit(JA.acquire_am)(
        jnp.asarray(win), JA.acquire_init_state(), jnp.asarray(fine),
        jnp.asarray(2, jnp.int32), jnp.asarray(1, jnp.int32),
        jnp.asarray(-1, jnp.int32))
    got = TA.acquire_am(torch.from_numpy(win),
                        TA.acquire_init_state(device="cpu"), fine, 2, 1, -1)
    _close(got[0], want[0])
    _close(got[1].phase, want[1].phase)
    _close(got[1].prev_angle, want[1].prev_angle)
    for i in (2, 3, 5):
        _same(got[i], want[i])
    _close(got[4], want[4])


def test_acquire_am_override(am_windows):
    """The timing consensus's override replaces the measured timing, and
    the measurement still comes back."""
    win = am_windows[False]
    want = jax.jit(JA.acquire_am)(
        jnp.asarray(win), JA.acquire_init_state(), jnp.asarray(False),
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
        jnp.asarray(300, jnp.int32))
    got = TA.acquire_am(torch.from_numpy(win),
                        TA.acquire_init_state(device="cpu"), False, 0, 0,
                        300)
    assert int(got[2]) == 300 % C.FFTCP_AM
    for i in (2, 3, 5):
        _same(got[i], want[i])
    _close(got[0], want[0])


def test_costas_track(fm_spectra):
    """The Costas loops over the reference bins of psmi 1 from a nonzero
    phase and frequency, with a static per-loop frequency: derotated
    symbols, phases and the carried state within TOL."""
    bins = np.asarray(JS._ref_bins(10))
    refs = fm_spectra[:, bins]
    rng = np.random.default_rng(5)
    ph = rng.uniform(-3, 3, len(bins)).astype(np.float32)
    fr = rng.uniform(-0.1, 0.1, len(bins)).astype(np.float32)
    cf = rng.uniform(-0.2, 0.2, len(bins)).astype(np.float32)
    want = JS.costas_track(jnp.asarray(refs), jnp.asarray(ph),
                           jnp.asarray(fr), jnp.asarray(cf))
    got = TS.costas_track(torch.from_numpy(refs), torch.from_numpy(ph),
                          torch.from_numpy(fr), torch.from_numpy(cf))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("psmi", [1, 2, 3, 11, 5])
def test_sync_fm_block(fm_spectra, psmi):
    """sync_fm_block on a block's spectra with a timing adjustment and a
    carried Costas state: pm, px1, px2, the control words and samperr
    exact, the angle, the error sums and the new state within TOL."""
    rng = np.random.default_rng(psmi)
    phase = rng.uniform(-0.5, 0.5, C.FFT_FM).astype(np.float32)
    freq = rng.uniform(-0.01, 0.01, C.FFT_FM).astype(np.float32)
    want, wst = JS.sync_fm_block(jnp.asarray(fm_spectra),
                                 JS.SyncState(jnp.asarray(phase),
                                              jnp.asarray(freq)),
                                 psmi, jnp.asarray(5, jnp.int32))
    got, gst = TS.sync_fm_block(torch.from_numpy(fm_spectra),
                                TS.SyncState(torch.from_numpy(phase),
                                             torch.from_numpy(freq)),
                                psmi, 5)
    assert got.keys() == want.keys()
    for k in want:
        if k in ("angle", "error_lb", "error_ub"):
            _close(got[k], want[k])
        else:
            _same(got[k], want[k])
    _close(gst.costas_phase, wst.costas_phase)
    _close(gst.costas_freq, wst.costas_freq)


def test_detect_cfo_scan(fm_spectra):
    """The per-block receiver's CFO scan on a block demodulated at CFO 0
    (the window is 400 Hz off): the count table exact."""
    want = np.asarray(JD.detect_cfo_scan(jnp.asarray(fm_spectra)))
    got = TD.detect_cfo_scan(torch.from_numpy(fm_spectra))
    assert got.dtype == torch.int32
    _same(got, want)


@pytest.mark.parametrize("ma3", [False, True])
def test_sync_am_block(am_windows, ma3):
    """sync_am_block (MA1, MA3) on spectra acquired at the window's own
    timing: every code, PIDS code, reference bit and samperr exact."""
    out = jax.jit(JA.acquire_am)(
        jnp.asarray(am_windows[ma3]), JA.acquire_init_state(),
        jnp.asarray(False), jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32), jnp.asarray(-1, jnp.int32))
    spectra = np.array(out[0])
    want = JSA.sync_am_block(jnp.asarray(spectra), ma3)
    got = TSA.sync_am_block(torch.from_numpy(spectra), ma3)
    assert got.keys() == want.keys()
    for k in want:
        _same(got[k], want[k])
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype


@pytest.mark.parametrize("disabled", [False, True])
def test_am_pids_decode(disabled):
    """am_pids_decode with pids1_disabled both ways on received-like codes
    (two with flipped bits): the bits exact; disabled, the lower stream
    reads as punctured."""
    rng = np.random.default_rng(40 + disabled)
    codes = np.stack([EAM.encode_pids_am(rng.integers(0, 2, 80).astype(
        np.uint8)) for _ in range(3)])
    codes[1, 3, 0] ^= 1
    codes[2, 7, 1] ^= 4
    got = TDA.am_pids_decode(torch.from_numpy(codes), disabled).numpy()
    for b in range(3):
        want = np.asarray(JDA.am_pids_decode(jnp.asarray(codes[b]),
                                             jnp.asarray(disabled)))
        _same(got[b], want)
    ext = TDA.am_gather_pids_plain(torch.from_numpy(codes), disabled)
    lower = TDA.pids_block_map().reshape(-1, 3) >> 3 & 1
    assert ((ext.reshape(3, -1, 3)[:, lower == 0] == 0).all()
            == disabled)


def _am_frames(ma3, n=4):
    """n frames of random P1 and P3 bits, encoded and interleaved: (p1,
    p3, the frames' pl/pu/s/t codes)."""
    rng = np.random.default_rng(50 + ma3)
    p1 = rng.integers(0, 2, (n, 8, C.P1_FRAME_LEN_AM)).astype(np.uint8)
    t3 = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    p3 = rng.integers(0, 2, (n, t3)).astype(np.uint8)
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(p1[f]) for f in range(n)],
        [EAM.encode_p3_am(p3[f], ma3) for f in range(n)], ma3)
    return p1, p3, mats


@pytest.mark.parametrize("ma3", [False, True])
def test_am_frame_decode(ma3):
    """am_frame_decode over 4 frames of interleaved codes from a carried
    diversity state: P1 and P3 bits and the delay lines exact, frames 3
    on the transmitted bits."""
    n = 4
    p1, p3, mats = _am_frames(ma3, n)
    jst = JDA.am_decode_init_state()
    tst = TDA.AMDecodeState(*(torch.zeros(TDA.DD, dtype=torch.uint8)
                              for _ in range(4)))
    for f in range(n):
        m = [mats[f][k] for k in ("pl", "pu", "s", "t")]
        wp1, wp3, _, jst = JDA.am_frame_decode(
            *(jnp.asarray(x) for x in m), jst, ma3)
        gp1, gp3, margins, tst = TDA.am_frame_decode(
            *(torch.from_numpy(x) for x in m), tst, ma3)
        _same(gp1, wp1)
        _same(gp3, wp3)
        assert margins["p1"].shape == (8,) and margins["p3"].shape == ()
        for a, b in zip(tst, jst):
            _same(a, b)
    np.testing.assert_array_equal(gp1.numpy(), p1[n - 1])
    np.testing.assert_array_equal(gp3.numpy(), p3[n - 1])


@pytest.mark.parametrize("ma3", [False, True])
def test_am_frame_decode_k15_packing(ma3):
    """am_frame_decode's card path (the codes packed into K15's [1, 8, 4,
    800], K15, K7 at K=9, K8) run through the plain versions on the CPU,
    over 4 frames from a carried diversity state: P1 and P3 bits, both
    margins and the delay lines exact against the CPU twin."""
    n = 4
    p1, p3, mats = _am_frames(ma3, n)
    zero = TDA.AMDecodeState(*(torch.zeros(TDA.DD, dtype=torch.uint8)
                               for _ in range(4)))
    twin = k15 = zero
    for f in range(n):
        m = [torch.from_numpy(mats[f][k]) for k in ("pl", "pu", "s", "t")]
        wp1, wp3, wm, twin = TDA.am_frame_decode(*m, twin, ma3)
        gp1, gp3, gm, k15 = TDA.am_frame_decode_k15(*m, k15, ma3,
                                                    plain=True)
        _same(gp1, wp1)
        _same(gp3, wp3)
        for k in ("p1", "p3"):
            assert gm[k].dtype == wm[k].dtype
            np.testing.assert_array_equal(gm[k].numpy(), wm[k].numpy())
        for a, b in zip(k15, twin):
            _same(a, b)
    np.testing.assert_array_equal(gp1.numpy(), p1[n - 1])
    np.testing.assert_array_equal(gp3.numpy(), p3[n - 1])
