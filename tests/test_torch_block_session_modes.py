"""The port's session on its per-block receivers against the JAX
package's ``NRSC5(device=False)`` on the CPU: the twins of
tests/test_session.py:217 (MP3: a second audio program in P3 PDUs over
the PX1 interleaver-IV) and :360 (an FM session switched to AM by
``set_mode``, holding frame 5 as the JAX test does), each event stream
held to JAX's event for event (tests/block_twins.py's tolerances), and
the JAX test's own assertions on the port's events."""

import pytest

from nrsc5_tpu.api.session import NRSC5 as JNRSC5
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.api.session import MODE_AM, MODE_FM, NRSC5

from . import block_twins as BT
from .capture_helpers import build_am_capture, build_fm_mp3_capture

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


def test_fm_session_p3_audio(rng):
    """The twin of tests/test_session.py:217: program 1's audio service
    and at least one bit-exact cycle-1 P3 HDC packet."""
    sig, p3_packets = build_fm_mp3_capture(rng, n_cycles=2)
    _, events = BT.session_twin(sig, MODE_FM, 65536)
    assert 1 in {e.program for e in events
                 if e.type == EventType.AUDIO_SERVICE}
    cyc1 = {p for cyc, pkts in p3_packets if cyc == 1 for p in pkts}
    assert any(e.data in cyc1 for e in events
               if e.type == EventType.HDC and e.program == 1)


def test_set_mode_switch_and_version(rng):
    """The twin of tests/test_session.py:360: an FM session switched to AM
    rewires to the per-block AM receiver and decodes the AM capture (frame
    5's packets all there, as the JAX test holds); set_callback swaps the
    sink; the version and a NaN frequency without a tuner."""
    sig, packets = build_am_capture(rng, n_frames=7, ma3=False)
    runs = []
    for open_pipe in (
            lambda cb: JNRSC5.open_pipe(cb, MODE_FM, device=False,
                                        hdc_decoder_factory=None),
            lambda cb: NRSC5.open_pipe(cb, MODE_FM, device="cpu",
                                       hdc_decoder_factory=None)):
        events = []
        radio = open_pipe(events.append)
        radio.set_mode(MODE_AM)
        for i in range(0, len(sig), 32768):
            radio.pipe_samples_cs16(sig[i:i + 32768])
        radio.flush()
        runs.append(events)
    BT.same_events(*runs)
    events = runs[1]
    assert EventType.SYNC in {e.type for e in events}
    hdc = {e.data for e in events if e.type == EventType.HDC
           and not e.crc_error}
    assert {p for f, pk in packets if f == 5 for p in pk} <= hdc
    late = []
    radio.set_callback(late.append)
    radio.flush()
    assert NRSC5.get_version()
    assert radio.get_frequency() != radio.get_frequency()


def test_am_rdbi_capture(monkeypatch):
    """chip_smoke.py's ``receiver_am`` capture (session_am's, rdbi set
    from frame ``BLOCK_AM_RDBI_FROM`` on) through the per-block AM session
    as int16 cs16 pushes, as JAX's: one SYNC, at least session_am's
    ``SESSION_AM_MIN_HDC`` exact HDC packets and none foreign, and once
    rdbi is read every PIDS block decoded with the lower stream zeroed
    (``pids1_disabled``) and no P3 frame after it."""
    import chip_smoke
    from nrsc5_tpu_torch.ops import decode_am as TDA
    wire, packets = chip_smoke.make_session_am_capture(
        chip_smoke.BLOCK_AM_RDBI_FROM)
    calls = []
    gather = TDA.am_gather_pids
    monkeypatch.setattr(TDA, "am_gather_pids", lambda pids, disabled=False,
                        **kw: calls.append(disabled) or gather(
                            pids, disabled, **kw))
    _, events = BT.session_twin(wire.reshape(-1), MODE_AM,
                                2 * chip_smoke.SESSION_AM_PUSH, flush=True)
    assert sum(e.type == EventType.SYNC for e in events) == 1
    hdc = {e.data for e in events if e.type == EventType.HDC
           and not e.crc_error}
    sent = {p for _, pk in packets for p in pk}
    assert len(hdc & sent) >= chip_smoke.SESSION_AM_MIN_HDC
    assert hdc <= sent
    assert True in calls and calls[-1]
    assert calls[calls.index(True):] == [True] * (len(calls)
                                                  - calls.index(True))
