"""The port's per-block FM receiver (``pipeline/receiver.py``
``FMReceiver``) against the JAX package's on the CPU: the twins of
tests/test_l1_fm.py:62 (five impairments) and :282 (MP5 and MP6, PM
only), each stream held to JAX's frame for frame and event for event
(tests/block_twins.py's tolerances), and the JAX test's own assertions
on the port's output; and the witness of ROADMAP §3.10's P1 margins."""

import functools

import numpy as np
import pytest

from nrsc5_tpu import constants as C
from nrsc5_tpu.ops import decode_fm as JDF
from nrsc5_tpu.pipeline import receiver as JR
from nrsc5_tpu.pipeline.receiver import FMReceiver as JFMReceiver
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu_torch.pipeline.receiver import FMReceiver

from . import block_twins as BT
from .test_l1_fm import _make_signal

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


def _twin(sig):
    return BT.l1_twin(JFMReceiver, FMReceiver, lambda rx: rx.push_cs16(sig),
                      p1_margins=False)


def _pids_decoded(col, pids_frames):
    decoded = {bytes(np.packbits(p)) for p in col.channel(-1)}
    want = {bytes(np.packbits(pids_frames[0][i])) for i in range(16)}
    return want - decoded


@pytest.mark.parametrize("impair_kw", [
    dict(),
    dict(sample_offset=777),
    dict(cfo_hz=400.0),
    dict(snr_db=25.0),
    dict(sample_offset=12345, cfo_hz=-250.0, snr_db=22.0),
])
def test_fm_p1_pids_roundtrip(rng, impair_kw):
    """The twin of tests/test_l1_fm.py:62: lock (through the CFO scan
    where the signal is off), the P1 frame and its 16 PIDS words."""
    sig, p1_frames, pids_frames = _make_signal(rng, n_frames=1, **impair_kw)
    _, col = _twin(sig)
    assert ("sync", {"psmi": 1}) in col.events
    assert col.channel(0), "no P1 frame decoded"
    assert np.array_equal(col.channel(0)[-1], p1_frames[0])
    assert not _pids_decoded(col, pids_frames)


@pytest.mark.parametrize("psmi", [5, 6])
def test_fm_mp5_mp6_pm_roundtrip(rng, psmi):
    """The twin of tests/test_l1_fm.py:282: MP5/MP6 (14 equalized
    partitions a sideband, PM decoded, the extended band carried but not
    decoded), 777 samples late, 250 Hz off, 22 dB."""
    n_frames = 1
    p1_frames = rng.integers(0, 2, (n_frames, C.P1_FRAME_LEN_FM)).astype(
        np.uint8)
    pids_frames = rng.integers(0, 2, (n_frames, 16, C.PIDS_FRAME_LEN)
                               ).astype(np.uint8)
    mats = [build_pm_matrix(p1_frames[f], pids_frames[f])
            for f in range(n_frames)]
    lead_blocks = 2
    dummy = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))
    matrix = np.concatenate([dummy[(16 - lead_blocks) * 32:]] + mats
                            + [dummy[:2 * 32]])
    bc_seq = np.concatenate([np.arange(16 - lead_blocks, 16),
                             np.tile(np.arange(16), n_frames),
                             np.arange(2)])
    n_ext = C.partitions_per_band(psmi) - C.PM_PARTITIONS
    ext = rng.choice(np.array([-1, 1], np.int8),
                     (len(matrix), 2 * n_ext * C.PARTITION_DATA_CARRIERS * 2))
    sig = modulate_fm(matrix, bc_seq, psmi, ext_signs=ext)
    sig = ch.impair(sig, sample_offset=777, cfo_hz=250.0, snr_db=22.0,
                    rng=rng)
    _, col = _twin(sig)
    assert ("sync", {"psmi": psmi}) in col.events
    assert col.channel(0), "no P1 frame decoded"
    assert np.array_equal(col.channel(0)[-1], p1_frames[0])
    assert not _pids_decoded(col, pids_frames)
    assert not col.channel(1), "cm 5/6 must not emit PX frames"


@pytest.mark.parametrize("impair_kw", [
    dict(),
    dict(snr_db=25.0),
    dict(sample_offset=12345, cfo_hz=-250.0, snr_db=22.0),
])
def test_fm_p1_margin_is_the_chunked_decoders(rng, impair_kw, monkeypatch):
    """ROADMAP §3.10's witness: the per-block FM receiver's P1 margins,
    which the twins do not compare (the port decodes P1 through its
    chains' chunked decoder), equal those of the reference's receiver with
    its P1 decoder switched to the chunked one, frame for frame; every
    other frame, margin and event as in the twins."""
    sig, p1_frames, _ = _make_signal(rng, n_frames=1, **impair_kw)
    monkeypatch.setattr(JR, "p1_decode",
                        functools.partial(JDF.p1_decode, chunked=True))
    want, got = BT.l1_twin(JFMReceiver, FMReceiver,
                           lambda rx: rx.push_cs16(sig))
    assert [m for c, m in got.margins if c == 0] \
        == [m for c, m in want.margins if c == 0]
    assert np.array_equal(got.channel(0)[-1], p1_frames[0])
