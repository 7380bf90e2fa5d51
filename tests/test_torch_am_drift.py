"""The port's AM session under sample-clock drift, on the CPU: the twin of
tests/test_am_multipath.py:136 (its capture: 12 MA1 frames, +50 ppm of
clock drift through ``tx.channel.clock_drift``, 30 dB AWGN, complex64
pushes of 16384 samples).

- Through the per-block receivers (``chain="block"``, the path the
  reference's test drives on the CPU): one SYNC, no LOST_SYNC and every
  HDC packet of frames 6-10, that test's gate.
- Through the device chain (``chain="device"``): the JAX package's device
  session's events on the same pushes, event for event
  (tests/serve_events.py's comparison, the MER floats within 0.1 dB).
  That chain does not track the drift as the per-block receiver does: in
  both packages it delivers 144 of those 160 packets.
"""

import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.api.session import NRSC5 as JNRSC5
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu_torch.api.session import MODE_AM, NRSC5

from .capture_helpers import build_am_capture
from .serve_events import same_events

PPM = 50.0
PUSH = 16384


@pytest.fixture(scope="module")
def capture():
    rng = np.random.default_rng(0xD81F)
    sig, packets = build_am_capture(rng, n_frames=12, ma3=False)
    s = ch.clock_drift(np.asarray(sig, np.complex64), PPM)
    s = ch.impair(s, snr_db=30.0, sample_rate=C.SAMPLE_RATE_CS16_AM, rng=rng)
    return s, packets


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(radio, sig):
    for i in range(0, len(sig), PUSH):
        radio.pipe_samples_cs16(sig[i:i + PUSH])
    radio.flush()


def _hdc_of_frames(events, packets):
    hdc = {e.data for e in events if e.type.name == "HDC"
           and not e.crc_error}
    want = {p for f, pk in packets if 6 <= f <= 10 for p in pk}
    return sum(p in hdc for p in want), len(want)


def test_per_block_session_tracks_clock_drift(capture):
    sig, packets = capture
    events = []
    _drive(NRSC5.open_pipe(events.append, MODE_AM, device="cpu",
                           chain="block"), sig)
    kinds = [e.type.name for e in events]
    assert kinds.count("SYNC") == 1 and "LOST_SYNC" not in kinds
    got, want = _hdc_of_frames(events, packets)
    assert got == want, f"{got}/{want} HDC at {PPM:+} ppm"


def test_device_session_under_drift_matches_jax(capture):
    sig, packets = capture
    port, ref = [], []
    _drive(NRSC5.open_pipe(port.append, MODE_AM, device="cpu",
                           chain="device"), sig)
    _drive(JNRSC5.open_pipe(ref.append, MODE_AM, device=True), sig)
    same_events({0: ref}, {0: port})
    assert _hdc_of_frames(port, packets) == (144, 160)
