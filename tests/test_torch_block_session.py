"""The port's session on its per-block receivers against the JAX
package's ``NRSC5(device=False)`` on the CPU: the twins of
tests/test_session.py:55 (the golden path), :105 (MA1 and MA3 through the
transport), :134 (signal, a noise gap, signal: the transport's RS-failure
resync, LOST_SYNC and re-acquisition, per-block and turbo) and :177 (the
turbo receiver), each event stream held to JAX's event for event
(tests/block_twins.py's tolerances), and the JAX test's own assertions on
the port's events.  Also the session's routing (``chain``) and the
device receiver's ``resync``."""

import numpy as np
import pytest

from nrsc5_tpu import constants as C
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu.tx.transport_encoder import aas_frame, build_p1_fm_frame
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.api.session import MODE_AM, MODE_FM, NRSC5
from nrsc5_tpu_torch.pipeline.device_receiver import DeviceReceiver
from nrsc5_tpu_torch.pipeline.receiver import FMReceiver
from nrsc5_tpu_torch.pipeline.receiver_am import AMReceiver
from nrsc5_tpu_torch.pipeline.turbo import TurboFMReceiver

from . import block_twins as BT
from .capture_helpers import build_am_capture
from .test_session import TITLE, _id3, _sis_station_name_frame

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


def fm_transport_capture(rng, n_frames, trail, size=300, **impair):
    """test_session.py's FM recipe: n_frames P1 frames of 32 random HDC
    packets of ``size`` bytes (None: 200-399, drawn a packet) with the ID3
    title in the AAS PSD, the SIS station name on PIDS, 2 lead and
    ``trail`` trail blocks, impaired by ``impair``.  Returns (signal,
    packets by frame)."""
    all_packets, p1_frames = [], []
    for f in range(n_frames):
        packets = [rng.integers(0, 256, size or rng.integers(200, 400))
                   .astype(np.uint8).tobytes() for _ in range(32)]
        all_packets.append(packets)
        psd = aas_frame(0x5100, f, _id3(TITLE))
        p1_frames.append(build_p1_fm_frame(packets, 0, f % 8,
                                           (f * 32) % 64, psd=psd))
    pids = np.broadcast_to(_sis_station_name_frame(), (16, 80))
    mats = [build_pm_matrix(fr, pids) for fr in p1_frames]
    dummy = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8), pids)
    matrix = np.concatenate([dummy[14 * 32:]] + mats + [dummy[:trail * 32]])
    bc_seq = np.concatenate([np.arange(14, 16),
                             np.tile(np.arange(16), n_frames),
                             np.arange(trail)])
    sig = modulate_fm(matrix, bc_seq, 1)
    return ch.impair(sig, rng=rng, **impair), all_packets


def _hdc(events, program=None):
    return {e.data for e in events if e.type == EventType.HDC
            and not e.crc_error and (program is None
                                     or e.program == program)}


def test_fm_session_golden_path(rng):
    """The twin of tests/test_session.py:55: 3 frames 4321 samples late,
    150 Hz off, 23 dB: SYNC, the ID3 title, the SIS name, every HDC packet
    of frames 0-1, the audio service."""
    sig, packets = fm_transport_capture(rng, 3, 4, size=None,
                                        sample_offset=4321, cfo_hz=150.0,
                                        snr_db=23.0)
    _, events = BT.session_twin(sig, MODE_FM, 65536)
    kinds = {e.type for e in events}
    assert EventType.SYNC in kinds and EventType.AUDIO_SERVICE in kinds
    assert TITLE in [e.title for e in events if e.type == EventType.ID3]
    assert "KTPU-FM" in [e.name for e in events
                         if e.type == EventType.STATION_NAME]
    assert not {p for f in (0, 1) for p in packets[f]} - _hdc(events)


@pytest.mark.parametrize("ma3", [False, True])
def test_am_session_transport(rng, ma3):
    """The twin of tests/test_session.py:105: MA1/MA3 through the session
    (MA3 switching the service mode from the reference subcarrier), every
    HDC packet of frames 4 and 5 bit-exact."""
    sig, packets = build_am_capture(rng, n_frames=7, ma3=ma3)
    _, events = BT.session_twin(sig, MODE_AM, 32768, flush=True)
    assert EventType.SYNC in {e.type for e in events}
    want = {p for f, pk in packets if f in (4, 5) for p in pk}
    assert want <= _hdc(events)


def _loss_capture(seed, trail_frames=0):
    r = np.random.default_rng(seed)
    packets = [r.integers(0, 256, 300).astype(np.uint8).tobytes()
               for _ in range(32)]
    n = 2 + trail_frames
    frames = [build_p1_fm_frame(packets, 0, f % 8, (f * 32) % 64)
              for f in range(2)]
    pids = np.zeros((16, 80), np.uint8)
    mats = [build_pm_matrix(fr, pids) for fr in frames]
    for _ in range(trail_frames):
        mats.append(build_pm_matrix(
            r.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8), pids))
    dummy = build_pm_matrix(
        r.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8), pids)
    matrix = np.concatenate([dummy[14 * 32:]] + mats + [dummy[:2 * 32]])
    bc = np.concatenate([np.arange(14, 16), np.tile(np.arange(16), n),
                         np.arange(2)])
    return modulate_fm(matrix, bc, 1), packets


@pytest.mark.parametrize("turbo", [False, True])
def test_sync_loss_and_recovery(turbo):
    """The twin of tests/test_session.py:134: signal, 400000 samples of
    noise, signal: the RS-failure resync (the transport asks the radio to
    re-acquire; turbo: its 15 % BER watchdog) gives LOST_SYNC, the radio
    re-acquires and decodes again, event for event as JAX's; the MER of
    the noiseless signal within the gap ROADMAP §3.10 measured."""
    sig1, pk1 = _loss_capture(1)
    sig2, pk2 = _loss_capture(2, trail_frames=2)
    noise = (np.random.default_rng(3).normal(0, 0.1, (400000, 2))
             .astype(np.float32).view(np.complex64)[:, 0])
    stream = np.concatenate([sig1, noise, sig2])
    _, events = BT.session_twin(stream, MODE_FM, 65536, turbo=turbo,
                                noiseless=True)
    kinds = [e.type for e in events]
    assert kinds.count(EventType.SYNC) >= 2, "no re-acquisition"
    assert EventType.LOST_SYNC in kinds
    assert pk1[0] in _hdc(events) and pk2[0] in _hdc(events)


def test_fm_session_turbo_path(rng):
    """The twin of tests/test_session.py:177: the turbo receiver (a fused
    frame a call once locked) gives the title, the SIS name and every HDC
    packet of frames 0-1, event for event as JAX's turbo receiver."""
    sig, packets = fm_transport_capture(rng, 4, 4, sample_offset=2000,
                                        snr_db=25.0)
    _, events = BT.session_twin(sig, MODE_FM, 65536, turbo=True)
    assert TITLE in [e.title for e in events if e.type == EventType.ID3]
    assert "KTPU-FM" in [e.name for e in events
                         if e.type == EventType.STATION_NAME]
    assert not {p for f in range(2) for p in packets[f]} - _hdc(events)


@pytest.mark.parametrize("mode,turbo,chain,radio", [
    (MODE_FM, False, "auto", FMReceiver),
    (MODE_FM, True, "auto", TurboFMReceiver),
    (MODE_AM, True, "block", AMReceiver),
    (MODE_FM, False, "device", DeviceReceiver),
    (MODE_AM, False, "device", DeviceReceiver),
])
def test_session_routing(mode, turbo, chain, radio):
    """The radio a session builds on the CPU: ``chain="auto"`` takes the
    per-block receivers there (the reference's ``device="auto"`` on a CPU
    backend), ``turbo`` the turbo receiver for FM, ``"device"`` the device
    receiver; an unknown chain raises; set_mode rewires alike."""
    s = NRSC5(lambda ev: None, mode, hdc_decoder_factory=None,
              turbo=turbo, device="cpu", chain=chain)
    assert type(s.radio) is radio
    assert s.radio.device.type == "cpu"
    with pytest.raises(ValueError, match="chain"):
        NRSC5(lambda ev: None, mode, device="cpu", chain="fast")
    s.set_mode(1 - mode)
    fm_radio = TurboFMReceiver if turbo else FMReceiver
    assert type(s.radio) is (radio if radio is DeviceReceiver
                             else AMReceiver if mode == MODE_FM
                             else fm_radio)


def test_device_receiver_resync(rng):
    """``DeviceReceiver.resync``, the transport's hard resync on the device
    chain: before a lock it does nothing; after one it emits LOST_SYNC and
    forces the receiver's relock watchdog, which then re-acquires from the
    stream (a second SYNC) and decodes on; while re-acquiring a second
    resync does nothing."""
    sig, packets = fm_transport_capture(rng, 3, 4, snr_db=25.0)
    events = []
    r = DeviceReceiver(events.append, device="cpu")
    r.resync()
    assert events == []
    half = len(sig) // 3
    r.push_cs16(sig[:half])
    kinds = [e.type for e in events]
    assert kinds.count(EventType.SYNC) == 1
    assert EventType.LOST_SYNC not in kinds
    r.resync()
    r.resync()
    assert [e.type for e in events].count(EventType.LOST_SYNC) == 1
    assert r._rx._relocking[0]
    r.push_cs16(sig[half:])
    r.flush()
    kinds = [e.type for e in events]
    assert kinds.count(EventType.SYNC) == 2
    assert kinds.index(EventType.LOST_SYNC) < len(kinds) - 1 - \
        kinds[::-1].index(EventType.SYNC)
    assert _hdc(events) & set(packets[2])


def test_golden_capture_block_and_turbo():
    """The golden capture (support/make_capture.py's recipe, as
    ``chip_smoke.make_golden_capture`` builds it) pushed as cu8 through
    the per-block session, as JAX's: "Synchronized (psmi 1)", the ID3
    title and LOT file counts chip_smoke.py's ``receiver_fm`` phase gates
    the card's run on (``BLOCK_GOLDEN_TITLES``, ``BLOCK_GOLDEN_LOTS``);
    the turbo receiver's HDC packets equal the per-block run's."""
    import chip_smoke
    wire = chip_smoke.make_golden_capture()
    _, events = BT.session_twin(wire, MODE_FM, 32768, flush=True)
    syncs = [e.psmi for e in events if e.type == EventType.SYNC]
    assert syncs == [1]
    titles = [e.title for e in events if e.type == EventType.ID3
              and e.title == chip_smoke.GOLDEN_TITLE]
    assert len(titles) == chip_smoke.BLOCK_GOLDEN_TITLES
    lots = [e for e in events if e.type == EventType.LOT]
    assert len(lots) == chip_smoke.BLOCK_GOLDEN_LOTS
    assert lots[0].name == chip_smoke.GOLDEN_LOT_NAME
    assert bytes(lots[0].data) == chip_smoke.GOLDEN_LOT_DATA
    turbo = []
    radio = NRSC5.open_pipe(turbo.append, MODE_FM, device="cpu", turbo=True,
                            hdc_decoder_factory=None)
    for i in range(0, len(wire), 32768):
        radio.pipe_samples_cu8(wire[i:i + 32768])
    radio.flush()
    assert [e.data for e in turbo if e.type == EventType.HDC] \
        == [e.data for e in events if e.type == EventType.HDC]
