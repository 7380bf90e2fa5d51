"""The port's per-block FM receiver in the extended service modes against
the JAX package's on the CPU: the twins of tests/test_l1_fm.py:78 (MP3)
and :186 (MP2) (:128 and :228 in tests/test_torch_block_l1_mp11.py and
tests/test_torch_block_l1_midcycle.py, apart for the test workers'
balance), each stream held to JAX's frame for frame and event for event
(tests/block_twins.py's tolerances), and the JAX test's own assertions on
the port's output.  On the CPU each block pair's PX frame runs K11's,
K7's and K8's plain versions through ``px_decode`` (K7's plain version
walks the trellis a step at a time: about 1.2 s a PX frame)."""

import numpy as np
import pytest

from nrsc5_tpu import constants as C
from nrsc5_tpu.pipeline.receiver import FMReceiver as JFMReceiver
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix, build_px_stream
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu_torch.pipeline.receiver import FMReceiver

from . import block_twins as BT

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


def _pm_frames(rng, n):
    return [build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))
        for _ in range(n)]


def _px_capture(rng, psmi, fl, n_cycles, px2=False, filler=0, junk=False):
    """tests/test_l1_fm.py's PX recipe: ``filler`` junk P1 frames, then
    n_cycles interleaver-IV cycles (2 P1 frames each) of random P3 frames
    (and P4 frames for MP11's PX2), 2 lead and 2 trail blocks, 25 dB.
    Returns (signal, p3 frames [cycles, 16, fl], p4 frames or None)."""
    p3 = rng.integers(0, 2, (n_cycles, 16, fl)).astype(np.uint8)
    mats = _pm_frames(rng, filler + 2 * n_cycles)
    px1 = build_px_stream(p3, fl).reshape(n_cycles * 32 * C.BLKSZ, -1)
    p4 = None
    if px2:
        p4 = rng.integers(0, 2, (n_cycles, 16, fl)).astype(np.uint8)
        px2_all = build_px_stream(p4, fl, rng=np.random.default_rng(77)) \
            .reshape(n_cycles * 32 * C.BLKSZ, -1)
    lead = 2
    dummy = _pm_frames(rng, 1)[0]
    matrix = np.concatenate([dummy[(16 - lead) * 32:]] + mats
                            + [dummy[:2 * 32]])
    width = px1.shape[1]
    if junk:
        head = rng.choice(np.array([-1, 1], np.int8),
                          ((lead + 16 * filler) * 32, width))
        tail = rng.choice(np.array([-1, 1], np.int8), (2 * 32, width))
    else:
        head = np.ones((lead * 32, width), np.int8)
        tail = np.ones((2 * 32, width), np.int8)
    bc_seq = np.concatenate([np.arange(16 - lead, 16),
                             np.tile(np.arange(16), filler + 2 * n_cycles),
                             np.arange(2)])
    kw = {"px1_signs": np.concatenate([head, px1, tail])}
    if px2:
        kw["px2_signs"] = np.concatenate([head, px2_all, tail])
    sig = modulate_fm(matrix, bc_seq, psmi, **kw)
    return ch.impair(sig, snr_db=25.0, rng=rng), p3, p4


def _twin(sig):
    return BT.l1_twin(JFMReceiver, FMReceiver,
                      lambda rx: rx.push_cs16(sig), p1_margins=False)[1]


def _missing(col, chan, frames):
    got = {b.tobytes() for b in col.channel(chan)}
    return sum(frames[i].astype(np.uint8).tobytes() not in got
               for i in range(16))


def test_fm_mp3_px1_roundtrip(rng):
    """The twin of tests/test_l1_fm.py:78: MP3's PX1 through the
    interleaver-IV; the ready gate discards cycle 0, cycle 1 decodes."""
    sig, p3, _ = _px_capture(rng, 3, C.P3_FRAME_LEN_MP3_MP11, 2)
    col = _twin(sig)
    assert ("sync", {"psmi": 3}) in col.events
    assert _missing(col, 1, p3[1]) == 0


def test_fm_mp2_px1_roundtrip(rng):
    """The twin of tests/test_l1_fm.py:186: MP2, one extended partition a
    sideband, P3 frames of 2304 bits through the J=2 interleaver-IV."""
    sig, p3, _ = _px_capture(rng, 2, C.P3_FRAME_LEN_MP2, 2)
    col = _twin(sig)
    assert ("sync", {"psmi": 2}) in col.events
    assert _missing(col, 1, p3[1]) == 0
