"""Every table and constant the PyTorch port copies from the JAX package is
equal to the original, and the port's transmitter copy makes the same
signal from the same seed."""

import numpy as np
import pytest

import jax.numpy as jnp
from nrsc5_tpu import constants as JC
from nrsc5_tpu.ops import acquire as JAQ
from nrsc5_tpu.ops import convolutional as JCV
from nrsc5_tpu.ops import decode_am as JDA
from nrsc5_tpu.ops import detect_cfo as JDC
from nrsc5_tpu.ops import frontend as JFE
from nrsc5_tpu.ops import interleavers as JIL
from nrsc5_tpu.ops import rcplx as JRC
from nrsc5_tpu.ops import scramble as JSC
from nrsc5_tpu.ops import sync_am as JSA
from nrsc5_tpu.ops import sync_fm as JSF
from nrsc5_tpu.pipeline import scan_chain as JSCH
from nrsc5_tpu.pipeline import scan_chain_am as JSAM
from nrsc5_tpu.tx import channel as JCH
from nrsc5_tpu.tx import encoder as JEN
from nrsc5_tpu.tx import encoder_am as JEAM
from nrsc5_tpu.tx import modulator as JMO
from nrsc5_tpu.tx import modulator_am as JMAM
from nrsc5_tpu_torch import constants as TC
from nrsc5_tpu_torch.ops import acquire_am_rc as TAA
from nrsc5_tpu_torch.ops import acquire_rc as TAQ
from nrsc5_tpu_torch.ops import convolutional as TCV
from nrsc5_tpu_torch.ops import decode_am as TDA
from nrsc5_tpu_torch.ops import detect_cfo as TDC
from nrsc5_tpu_torch.ops import frontend as TFE
from nrsc5_tpu_torch.ops import interleavers as TIL
from nrsc5_tpu_torch.ops import rcplx as TRC
from nrsc5_tpu_torch.ops import scramble as TSC
from nrsc5_tpu_torch.ops import sync_am as TSA
from nrsc5_tpu_torch.ops import sync_fm as TSF
from nrsc5_tpu_torch.pipeline import scan_chain as TSCH
from nrsc5_tpu_torch.pipeline import scan_chain_am as TSAM
from nrsc5_tpu_torch.tx import channel as TCH
from nrsc5_tpu_torch.tx import encoder as TEN
from nrsc5_tpu_torch.tx import encoder_am as TEAM
from nrsc5_tpu_torch.tx import modulator as TMO
from nrsc5_tpu_torch.tx import modulator_am as TMAM


def _equal(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def test_constants_equal():
    names = [n for n in dir(JC) if n.isupper()]
    assert len(names) > 80
    for n in names:
        _equal(getattr(JC, n), getattr(TC, n))
    for psmi in range(len(JC.COMPATIBILITY_MODE)):
        assert JC.partitions_per_band(psmi) == TC.partitions_per_band(psmi)
    _equal(JC.ofdm_shape(JC.FFT_FM, JC.CP_FM), TC.ofdm_shape(TC.FFT_FM,
                                                            TC.CP_FM))
    _equal(JC.ofdm_shape(JC.FFT_AM, JC.CP_AM), TC.ofdm_shape(TC.FFT_AM,
                                                            TC.CP_AM))


TABLES = {
    "halfband_taps": (JFE.halfband_taps, TFE.halfband_taps),
    "rc_overlap": (lambda: [JFE.rc_overlap(s) for s in range(6)],
                   lambda: [TFE.rc_overlap(s) for s in range(6)]),
    "window_fm": (lambda: JAQ.WINDOW_FM, lambda: TAQ.WINDOW_FM),
    "shape_kernel": (lambda: JAQ._shape_kernel(JC.FFT_FM, JC.CP_FM),
                     lambda: TAQ._shape_kernel(TC.FFT_FM, TC.CP_FM)),
    "needle_tables": (JDC._needle_tables, TDC._needle_tables),
    "cfo_range": (lambda: (JDC.CFO_RANGE, JDC.N_REFS),
                  lambda: (TDC.CFO_RANGE, TDC.N_REFS)),
    "ref_bins": (lambda: (JSF._ref_bins(10), JSF._ref_bins(14)),
                 lambda: (TSF._ref_bins(10), TSF._ref_bins(14))),
    "needles": (lambda: JSF._needles(10) + JSF._needles(14),
                lambda: TSF._needles(10) + TSF._needles(14)),
    "sync_signs": (JSF._sync_signs, TSF._sync_signs),
    "costas_gains": (lambda: (JSF.ALPHA, JSF.BETA, JSF.W),
                     lambda: (TSF.ALPHA, TSF.BETA, TSF.W)),
    "p1_fm_table": (JIL.p1_fm_table, TIL.p1_fm_table),
    "pids_fm_table": (JIL.pids_fm_table, TIL.pids_fm_table),
    "pm_inverse_table": (JIL.pm_inverse_table, TIL.pm_inverse_table),
    "pm_geometry": (lambda: (JIL.PM_ROW, JIL.PM_ROWS, JIL.PM_MATRIX_SIZE),
                    lambda: (TIL.PM_ROW, TIL.PM_ROWS, TIL.PM_MATRIX_SIZE)),
    "scrambler_keystream": (
        lambda: (JSC.scrambler_keystream(80),
                 JSC.scrambler_keystream(JC.P1_FRAME_LEN_FM)),
        lambda: (TSC.scrambler_keystream(80),
                 TSC.scrambler_keystream(TC.P1_FRAME_LEN_FM))),
    "parity_table": (lambda: JCV._parity_table(7),
                     lambda: TCV._parity_table(7)),
    "trellis_tables": (lambda: JCV.trellis_tables(7, JC.CONV_K7_GEN),
                       lambda: TCV.trellis_tables(7, TC.CONV_K7_GEN)),
    "chunk_plan": (lambda: JCV._chunk_plan(146176, 1152, 96),
                   lambda: TCV._chunk_plan(146176, 1152, 96)),
    "tail_biting_extra": (lambda: JCV.TAIL_BITING_EXTRA,
                          lambda: TCV.TAIL_BITING_EXTRA),
    "dft_tables": (lambda: JRC.dft_tables(2048), lambda: TRC.dft_tables(2048)),
    "geometry": (lambda: (JSCH.SLACK, [JSCH.buffer_len(n) for n in (1, 17)],
                          [JSCH.px_frame_lens(p) for p in range(64)]),
                 lambda: (TSCH.SLACK, [TSCH.buffer_len(n) for n in (1, 17)],
                          [TSCH.px_frame_lens(p) for p in range(64)])),
    "iv_state_len": (lambda: [JSCH.iv_state_len(f) for f in (0, 2304, 4608)],
                     lambda: [TSCH.iv_state_len(f) for f in (0, 2304, 4608)]),
}
TABLES.update({
    "window_am": (lambda: JAQ.WINDOW_AM, lambda: TAQ.WINDOW_AM),
    "am_geometry": (lambda: (JSAM.SLACK_AM,
                             [JSAM.am_buffer_len(n) for n in (1, 2, 5)]),
                    lambda: (TSAM.SLACK_AM,
                             [TSAM.am_buffer_len(n) for n in (1, 2, 5)])),
    "sync_am_tables": (
        lambda: (JSA.GRAY4, JSA.GRAY8, JSA.TRAIN1, JSA.TRAIN2, JSA.W,
                 JSA.CENTER, JSA.AM_EQ_INTERP, JSA.TRAIN_QAM64,
                 JSA.TRAIN_QAM16, JSA.TRAIN_QPSK),
        lambda: (TSA.GRAY4, TSA.GRAY8, TSA.TRAIN1, TSA.TRAIN2, TSA.W,
                 TSA.CENTER, TSA.AM_EQ_INTERP, TSA.TRAIN_QAM64,
                 TSA.TRAIN_QAM16, TSA.TRAIN_QPSK)),
    "am_pids_tables": (JIL.am_pids_tables, TIL.am_pids_tables),
    "cp_window_idx_am": (lambda: JAQ._cp_window_idx(JC.FFTCP_AM, JC.CP_AM),
                         lambda: TAQ._cp_window_idx(TC.FFTCP_AM, TC.CP_AM)),
    "shape_kernel_am": (lambda: JAQ._shape_kernel(JC.FFT_AM, JC.CP_AM),
                        lambda: TAQ._shape_kernel(TC.FFT_AM, TC.CP_AM)),
    "tone_grid": (lambda: np.asarray(jnp.linspace(-0.6, 0.6, 85).astype(
                      jnp.float32)),
                  lambda: TAA.TONE_GRID),
    "am_stages": (lambda: JFE.AM_STAGES, lambda: TFE.AM_STAGES),
    "trellis_tables_k9": (
        lambda: (JCV.trellis_tables(9, JC.CONV_E1_GEN),
                 JCV.trellis_tables(9, JC.CONV_E2_E3_GEN)),
        lambda: (TCV.trellis_tables(9, TC.CONV_E1_GEN),
                 TCV.trellis_tables(9, TC.CONV_E2_E3_GEN))),
    "chunk_plan_am": (
        lambda: tuple(JCV._chunk_plan(t, 1024, 160)
                      for t in (3750, 24000, 30000)),
        lambda: tuple(TCV._chunk_plan(t, TCV.CHUNK_AM, TCV.OVERLAP_AM)
                      for t in (3750, 24000, 30000))),
})
for _ma3 in (False, True):
    TABLES[f"am_ma1_tables_ma3_{_ma3}"] = (
        lambda ma3=_ma3: tuple(
            (k,) + v for k, v in JIL.am_ma1_tables(ma3).items()),
        lambda ma3=_ma3: tuple(
            (k,) + v for k, v in TIL.am_ma1_tables(ma3).items()))
    TABLES[f"am_phase_tables_ma3_{_ma3}"] = (
        lambda ma3=_ma3: JDA._phase_tables(ma3),
        lambda ma3=_ma3: TDA._phase_tables(ma3))
for _fl in (2304, 4608):
    TABLES[f"p3_iv_tables_{_fl}"] = (
        lambda fl=_fl: JIL.p3_iv_tables(fl),
        lambda fl=_fl: TIL.p3_iv_tables(fl))
    TABLES[f"p3_iv_hazard_{_fl}"] = (
        lambda fl=_fl: JIL.p3_iv_hazard(fl),
        lambda fl=_fl: TIL.p3_iv_hazard(fl))
    TABLES[f"p3_iv_inverse_{_fl}"] = (
        lambda fl=_fl: JIL.p3_iv_inverse(fl),
        lambda fl=_fl: TIL.p3_iv_inverse(fl))


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_equal(name):
    jax_fn, port_fn = TABLES[name]
    a, b = jax_fn(), port_fn()
    if isinstance(a, list):
        assert a == b
    else:
        _equal(a, b)


def test_encoder_equal():
    rng = np.random.default_rng(11)
    p1 = rng.integers(0, 2, JC.P1_FRAME_LEN_FM).astype(np.uint8)
    pids = rng.integers(0, 2, (16, JC.PIDS_FRAME_LEN)).astype(np.uint8)
    _equal(JEN.build_pm_matrix(p1, pids), TEN.build_pm_matrix(p1, pids))
    coded = JCV.conv_encode(p1[:999], 7, JC.CONV_K7_GEN)
    _equal(coded, TCV.conv_encode(p1[:999], 7, TC.CONV_K7_GEN))
    _equal(JCV.puncture(coded, JC.PUNCTURE_P1_PIDS_FM),
           TCV.puncture(coded, TC.PUNCTURE_P1_PIDS_FM))


def test_modulator_and_channel_equal():
    """Same bits and the same noise seed give the same cu8 wire."""
    rng = np.random.default_rng(12)
    matrix = JEN.build_pm_matrix(
        rng.integers(0, 2, JC.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, JC.PIDS_FRAME_LEN)).astype(np.uint8))[:64]
    bc = np.array([6, 7])
    for psmi in (1, 5):
        _equal(JMO.modulate_fm(matrix, bc, psmi),
               TMO.modulate_fm(matrix, bc, psmi))
    sig = JMO.modulate_fm(matrix, bc, 1)
    wires = []
    for mod in (JCH, TCH):
        noisy = mod.impair(sig, sample_offset=5, cfo_hz=12.5, snr_db=20.0,
                           rng=np.random.default_rng(13))
        wires.append(mod.to_cu8(mod.upsample2(noisy)))
    _equal(*wires)


@pytest.mark.parametrize("fl", [2304, 4608])
def test_px_encoder_equal(fl):
    """The PX transmit stream of two IV cycles of fixed-seed frames, and
    one frame's punctured code."""
    rng = np.random.default_rng(fl)
    frames = rng.integers(0, 2, (2, 16, fl)).astype(np.uint8)
    _equal(JEN.encode_p3_stream(frames[0, 0], fl),
           TEN.encode_p3_stream(frames[0, 0], fl))
    _equal(JEN.build_px_stream(frames, fl, np.random.default_rng(3)),
           TEN.build_px_stream(frames, fl, np.random.default_rng(3)))
    _equal(JEN.build_px_stream(frames, fl), TEN.build_px_stream(frames, fl))


@pytest.mark.parametrize("psmi", [2, 3, 11])
def test_modulator_px_equal(psmi):
    """The modulator with PX1 (and MP11's PX2) partitions filled."""
    rng = np.random.default_rng(psmi)
    matrix = JEN.build_pm_matrix(
        rng.integers(0, 2, JC.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, JC.PIDS_FRAME_LEN)).astype(np.uint8))[:64]
    fl1, fl2 = JSCH.px_frame_lens(psmi)
    kw = {"px1_signs": rng.choice([-1, 1], (64, fl1 // 32)).astype(np.int8)}
    if fl2:
        kw["px2_signs"] = rng.choice([-1, 1], (64, fl2 // 32)).astype(np.int8)
    _equal(JMO.modulate_fm(matrix, np.array([6, 7]), psmi, **kw),
           TMO.modulate_fm(matrix, np.array([6, 7]), psmi, **kw))


@pytest.mark.parametrize("ma3", [False, True])
def test_encoder_am_equal(ma3):
    """The AM encoder: two frames' P1 and P3 streams, their interleaved
    QAM matrices (delayed halves of the last frames from the filler), the
    PIDS codes and the reference bits."""
    rng = np.random.default_rng(13 + ma3)
    p3_len = JC.P3_FRAME_LEN_MA3 if ma3 else JC.P3_FRAME_LEN_MA1
    p1 = rng.integers(0, 2, (2, 8, JC.P1_FRAME_LEN_AM)).astype(np.uint8)
    p3 = rng.integers(0, 2, (2, p3_len)).astype(np.uint8)
    streams = {}
    for name, mod in (("jax", JEAM), ("port", TEAM)):
        s1 = [mod.encode_p1_am(p1[f]) for f in range(2)]
        s3 = [mod.encode_p3_am(p3[f], ma3) for f in range(2)]
        streams[name] = (s1, s3, mod.interleave_frames(s1, s3, ma3))
    for a, b in zip(streams["jax"][:2], streams["port"][:2]):
        for x, y in zip(a, b):
            _equal(x, y)
    for fj, fp in zip(streams["jax"][2], streams["port"][2]):
        assert list(fj) == list(fp)
        for k in fj:
            _equal(fj[k], fp[k])
    word = rng.integers(0, 2, 80).astype(np.uint8)
    _equal(JEAM.encode_pids_am(word), TEAM.encode_pids_am(word))
    for bc in (0, 5):
        _equal(JEAM.am_ref_bits(bc, 2 if ma3 else 1, pli=1, rdbi=1),
               TEAM.am_ref_bits(bc, 2 if ma3 else 1, pli=1, rdbi=1))


@pytest.mark.parametrize("delay", [0, 1, 14])
def test_multipath_equal(delay):
    """The two-ray channel at delays 0 (a complex gain), 1 and 14 (the AM
    cyclic prefix), amplitudes 0.5 and 0.9, on the same signal."""
    rng = np.random.default_rng(16 + delay)
    sig = (rng.normal(size=3000) + 1j * rng.normal(size=3000)).astype(
        np.complex64)
    for amp, phase in ((0.5, 0.7), (0.9, 1.1)):
        _equal(JCH.multipath(sig, delay, amp, phase=phase),
               TCH.multipath(sig, delay, amp, phase=phase))
    with pytest.raises(ValueError):
        TCH.multipath(sig, -1, 0.5)


@pytest.mark.parametrize("n", [999, 1000])
def test_upsample_exact_equal(n):
    """Fourier interpolation by 32 of odd- and even-length signals."""
    rng = np.random.default_rng(n)
    sig = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    _equal(JCH.upsample_exact(sig, 32), TCH.upsample_exact(sig, 32))


@pytest.mark.parametrize("ma3", [False, True])
def test_modulator_am_equal(ma3):
    """The AM modulator: one frame of the same QAM matrices, PIDS codes and
    reference bits gives the same complex64 signal."""
    rng = np.random.default_rng(15 + ma3)
    mats = [{k: rng.integers(0, 64, 8 * 32 * 25).astype(np.uint8)
             for k in ("pl", "pu", "s", "t")}]
    pids = rng.integers(0, 16, (8, 32, 2)).astype(np.uint8)
    ref = np.stack([JEAM.am_ref_bits(b, 2 if ma3 else 1) for b in range(8)])
    _equal(JMAM.modulate_am(mats, pids, ref, ma3),
           TMAM.modulate_am(mats, pids, ref, ma3))
