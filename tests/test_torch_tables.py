"""Every table and constant the PyTorch port copies from the JAX package is
equal to the original, and the port's transmitter copy makes the same
signal from the same seed."""

import numpy as np
import pytest

from nrsc5_tpu import constants as JC
from nrsc5_tpu.ops import acquire as JAQ
from nrsc5_tpu.ops import convolutional as JCV
from nrsc5_tpu.ops import frontend as JFE
from nrsc5_tpu.ops import interleavers as JIL
from nrsc5_tpu.ops import rcplx as JRC
from nrsc5_tpu.ops import scramble as JSC
from nrsc5_tpu.ops import sync_fm as JSF
from nrsc5_tpu.pipeline import scan_chain as JSCH
from nrsc5_tpu.tx import channel as JCH
from nrsc5_tpu.tx import encoder as JEN
from nrsc5_tpu.tx import modulator as JMO
from nrsc5_tpu_torch import constants as TC
from nrsc5_tpu_torch.ops import acquire_rc as TAQ
from nrsc5_tpu_torch.ops import convolutional as TCV
from nrsc5_tpu_torch.ops import frontend as TFE
from nrsc5_tpu_torch.ops import interleavers as TIL
from nrsc5_tpu_torch.ops import rcplx as TRC
from nrsc5_tpu_torch.ops import scramble as TSC
from nrsc5_tpu_torch.ops import sync_fm as TSF
from nrsc5_tpu_torch.pipeline import scan_chain as TSCH
from nrsc5_tpu_torch.tx import channel as TCH
from nrsc5_tpu_torch.tx import encoder as TEN
from nrsc5_tpu_torch.tx import modulator as TMO


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
}


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
