"""The port's multi-station receiver against the reference's, on the CPU:
twins of tests/test_serve.py's receiver cases, on the same streams (the
same seeded helpers) and the same pushes.

Eight twins hold event parity with the JAX receiver, station by station,
as tests/serve_events.py compares two receivers' events: every event
equal by the reference's own key (tests/test_serve.py ``_ev_key``), the
MER floats within ``MER_DB`` dB, and a dead carrier's readings (in the
relock twins' gaps, before the watchdog trips) dead in both packages;
that module says why (measured here: the MER 0.027 dB apart on these
clean ~60 dB streams; at the edge of a gap, 0.6 dB against a negative
reading).  The other twins, which check what their JAX test checks on the
port alone, are in tests/test_torch_serve_modes.py.  The port runs its
plain PyTorch versions (``device="cpu"``), one torch thread, so the
module stays inside the budget beside other workers.
"""

import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.serve import MultiStationReceiver as JaxReceiver
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu.tx.transport_encoder import build_p1_fm_frame
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.serve import MultiStationReceiver

from .serve_events import ev_key, key, same_events
from .test_serve import _am_stream, _ev_key, _station_mats, _station_stream

torch.set_num_threads(1)

def _port(*args, **kw):
    return MultiStationReceiver(*args, device="cpu", **kw)


def _both(n, feed, **kw):
    """Feed the same pushes to the JAX receiver and to the port's; return
    their events (station -> list) and the port's receiver."""
    out = []
    for make in (lambda cb: JaxReceiver(n, cb, **kw),
                 lambda cb: _port(n, cb, **kw)):
        events = {i: [] for i in range(n)}
        rx = make(lambda st, ev: events[st].append(ev))
        feed(rx)
        out.append(events)
    same_events(*out)
    return out[1]


def _interleaved(streams, chunk):
    def feed(rx):
        pos = [0] * len(streams)
        while any(pos[i] < len(streams[i]) for i in range(len(streams))):
            for i in range(len(streams)):
                rx.push(i, streams[i][pos[i]:pos[i] + chunk])
                pos[i] += chunk
        rx.flush()
    return feed


def _hdc(events, want=None):
    got = {e.data for e in events
           if e.type == EventType.HDC and not e.crc_error}
    return got if want is None else got & want


def _titles(events):
    return {e.title for e in events if e.type == EventType.ID3}


def _lock_capture(rng, bc, title, n_frames=3):
    """A capture whose lock lands at block count ``bc`` (the trailing
    blocks of a dummy frame ahead of the frames), conjugated rc, with its
    packets."""
    mats, packets = _station_mats(rng, title, n_frames=n_frames)
    dummy = build_pm_matrix(
        build_p1_fm_frame(
            [rng.integers(0, 256, 280).astype(np.uint8).tobytes()
             for _ in range(32)], 0, 7, 0),
        np.zeros((16, 80), np.uint8))
    matrix = np.concatenate([dummy[bc * 32:]] + mats)
    bc_seq = np.concatenate([np.arange(bc, 16),
                             np.tile(np.arange(16), n_frames)])
    sig = modulate_fm(matrix, bc_seq, 1)
    buf = np.zeros(len(sig) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    return buf, packets


def _rc(buf):
    return np.stack([buf.real, -buf.imag], -1).astype(np.float32)


def test_event_key_copy():
    """tests/serve_events.py's ``ev_key`` (the card's tests cannot import
    tests/test_serve.py, which imports JAX) equals the reference's
    ``_ev_key`` on every kind of payload value an event carries."""
    from nrsc5_tpu_torch.api.events import make
    events = [
        make(EventType.HDC, program=0, data=b"\x01\x02", crc_error=False),
        make(EventType.MER, lower=61.25, upper=60.5),
        make(EventType.BER, cber=0.0125),
        make(EventType.ID3, title="T", artist=None, xhdr=[1, 2]),
        make(EventType.SYNC, psmi=np.int64(1)),
        make(EventType.LOT, data=np.arange(5, dtype=np.uint8),
             mime=EventType.LOT)]
    for ev in events:
        assert ev_key(ev) == _ev_key(ev)


# --- the eight parity twins ---

def test_multistation_serving(rng):
    """Twin of test_serve.py:46: two stations in interleaved odd-sized
    pushes; per-station titles and packets, the JAX receiver's events."""
    titles = ["Station Zero Song", "Station One Song"]
    streams, want = [], []
    for t in titles:
        sig, packets = _station_stream(rng, t)
        streams.append(sig)
        want.append({bytes(p) for p in packets})
    events = _both(2, _interleaved(streams, 48 * 1024 + 17),
                   frames_per_dispatch=1)
    for i, t in enumerate(titles):
        assert _titles(events[i]) == {t}
        assert len(_hdc(events[i], want[i])) >= 64
        assert not (_hdc(events[i]) & want[1 - i] - want[i])
        assert any(e.type == EventType.AUDIO_SERVICE for e in events[i])


def test_multistation_px_channels(rng):
    """Twin of test_serve.py:81: MP3, program-1 audio over PX1 after the
    interleaver warm-up; the JAX receiver's events."""
    from nrsc5_tpu.tx.encoder import build_px_stream
    from nrsc5_tpu.tx.transport_encoder import build_audio_pdu, pack_frame

    psmi, n_cycles = 3, 3
    fl = C.P3_FRAME_LEN_MP3_MP11
    p3_bytes = (fl - 24) // 8
    sps_packets = []
    p3_bits = np.zeros((n_cycles, 16, fl), np.uint8)
    for cyc in range(n_cycles):
        for f in range(16):
            pkts = [rng.integers(0, 256, 150).astype(np.uint8).tobytes()
                    for _ in range(3)]
            sps_packets.extend(pkts)
            g = cyc * 16 + f
            pdu = build_audio_pdu(pkts, program=1, pdu_seq=g % 8,
                                  seq=(g * 3) % 64, total_len=p3_bytes)
            p3_bits[cyc, f] = pack_frame(pdu, fl, C.PCI_AUDIO)
    px = build_px_stream(p3_bits, fl).reshape(n_cycles * 32 * C.BLKSZ, -1)
    mats = []
    for f in range(n_cycles * 2):
        pkts = [rng.integers(0, 256, 300).astype(np.uint8).tobytes()
                for _ in range(32)]
        mats.append(build_pm_matrix(
            build_p1_fm_frame(pkts, 0, f % 8, (f * 32) % 64),
            np.zeros((16, 80), np.uint8)))
    sig = modulate_fm(np.concatenate(mats),
                      np.tile(np.arange(16), n_cycles * 2), psmi,
                      px1_signs=px)
    buf = np.zeros(len(sig) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig

    def feed(rx):
        rx.push(0, buf)
        rx.flush()
    events = _both(1, feed, frames_per_dispatch=2, psmi=psmi)[0]
    got = {e.data for e in events if e.type == EventType.HDC
           and e.program == 1 and not e.crc_error}
    assert len(got & {bytes(p) for p in sps_packets}) >= 32
    assert any(e.type == EventType.AUDIO_SERVICE and e.program == 1
               for e in events)


def test_multistation_am(rng):
    """Twin of test_serve.py:386: two MA1 stations, packets after the
    diversity warm-up; the JAX receiver's events."""
    buf, packets = _am_stream(rng, 7)

    def feed(rx):
        for lo in range(0, len(buf), 100000):
            for i in range(2):
                rx.push(i, buf[lo:lo + 100000])
        rx.flush()
    events = _both(2, feed, frames_per_dispatch=2, mode="am")
    for i in range(2):
        assert len(_hdc(events[i], {bytes(p) for p in packets})) >= 64


def test_multistation_mixed_first_bc(rng):
    """Twin of test_serve.py:483: two stations locked at block counts 14
    and 11, each aligned by its own one-time dispatch (the port's locks
    for the port, the reference's for the reference); the JAX receiver's
    events."""
    from nrsc5_tpu.pipeline import scan_chain_rc as jrcc
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as trcc

    titles = ["Mixed BC Zero", "Mixed BC One"]
    tails, want, jlocks, tlocks = [], [], [], []
    for bc, title in zip((14, 11), titles):
        buf, packets = _lock_capture(rng, bc, title)
        jl = jrcc.cold_start_rc(_rc(buf))
        tl = trcc.cold_start_rc(_rc(buf), device="cpu")
        assert jl["first_bc"] == tl["first_bc"] == bc
        assert jl["offset"] == tl["offset"]
        jlocks.append(jl)
        tlocks.append(tl)
        tails.append(np.concatenate(
            [buf[tl["offset"]:], np.zeros(3 * C.FFTCP_FM, np.complex64)]))
        want.append({bytes(p) for p in packets})
    feed = _interleaved(tails, 300000)
    runs = []
    for cls, locks in ((JaxReceiver, jlocks), (_port, tlocks)):
        events = {0: [], 1: []}
        feed(cls(2, lambda st, ev: events[st].append(ev),
                 frames_per_dispatch=1, locks=locks))
        runs.append(events)
    same_events(*runs)
    for i in range(2):
        assert _titles(runs[1][i]) == {titles[i]}
        assert len(_hdc(runs[1][i], want[i])) >= 64


def test_multistation_checkpoint_resume(rng, tmp_path):
    """Twin of test_serve.py:534: save mid-stream, load into a fresh
    receiver, go on: the post-resume chain bit-exact (BER 0), each half's
    events the JAX receivers' own."""
    sig, packets = _station_stream(rng, "Resume Title", n_frames=4)
    want = {bytes(p) for p in packets}
    split = int(len(sig) * 0.55)
    runs = []
    for cls in (JaxReceiver, _port):
        ev1, ev2 = {0: []}, {0: []}
        rx1 = cls(1, lambda st, ev: ev1[0].append(ev), frames_per_dispatch=1)
        for lo in range(0, split, 200000):
            rx1.push(0, sig[lo:min(lo + 200000, split)])
        path = str(tmp_path / f"{cls.__name__}.npz")
        rx1.save(path)
        rx2 = cls(1, lambda st, ev: ev2[0].append(ev), frames_per_dispatch=1)
        rx2.load(path)
        for lo in range(split, len(sig), 200000):
            rx2.push(0, sig[lo:lo + 200000])
        rx2.flush()
        runs.append((ev1, ev2))
    same_events(runs[0][0], runs[1][0])
    same_events(runs[0][1], runs[1][1])
    ev1, ev2 = runs[1]
    assert len((_hdc(ev1[0]) | _hdc(ev2[0])) & want) >= len(want) - 40
    bers = [e.cber for e in ev2[0] if e.type == EventType.BER]
    assert bers and max(bers) == 0.0
    assert "Resume Title" in _titles(ev2[0])


def test_multistation_auto_relock(rng):
    """Twin of test_serve.py:724: a mid-stream gap on station 1 trips
    LOST_SYNC, the cold start relocks it (SYNC) and decode resumes while
    station 0 decodes throughout; the JAX receiver's events."""
    good, good_packets = _station_stream(rng, "Clean Station", n_frames=12)
    pre, pre_packets = _station_stream(rng, "Before Gap", n_frames=3)
    post, post_packets = _station_stream(rng, "After Gap", n_frames=9)
    gappy = np.concatenate([pre[:len(pre) - 33333], post])

    def feed(rx):
        for lo in range(0, max(len(good), len(gappy)), 250000):
            rx.push(0, good[lo:lo + 250000])
            rx.push(1, gappy[lo:lo + 250000])
        rx.flush()
    events = _both(2, feed, frames_per_dispatch=1)
    assert len(_hdc(events[0], {bytes(p) for p in good_packets})) >= 256
    assert not any(e.type == EventType.LOST_SYNC for e in events[0])
    kinds = [e.type for e in events[1]]
    assert EventType.LOST_SYNC in kinds and EventType.SYNC in kinds
    assert len(_hdc(events[1], {bytes(p) for p in pre_packets})) >= 32
    assert len(_hdc(events[1], {bytes(p) for p in post_packets})) >= 32
    assert "After Gap" in _titles(events[1])


def test_multistation_am_auto_relock(rng):
    """Twin of test_serve.py:838: the AM gap trips the K=9-margin
    watchdog, the AM cold start relocks, the diversity warm-up re-arms;
    the other station decodes throughout; the JAX receiver's events."""
    good, good_packets = _am_stream(rng, 16)
    pre, pre_packets = _am_stream(rng, 4)
    post, post_packets = _am_stream(rng, 12)
    gappy = np.concatenate([pre[:len(pre) - 7777], post])

    def feed(rx):
        for lo in range(0, max(len(good), len(gappy)), 50000):
            rx.push(0, good[lo:lo + 50000])
            rx.push(1, gappy[lo:lo + 50000])
        rx.flush()
    events = _both(2, feed, frames_per_dispatch=1, mode="am")
    assert len(_hdc(events[0], {bytes(p) for p in good_packets})) >= 128
    assert not any(e.type == EventType.LOST_SYNC for e in events[0])
    kinds = [e.type for e in events[1]]
    assert EventType.LOST_SYNC in kinds and EventType.SYNC in kinds
    assert len(_hdc(events[1], {bytes(p) for p in pre_packets})) >= 8
    assert len(_hdc(events[1], {bytes(p) for p in post_packets})) >= 8


def test_multistation_cold_start(rng):
    """Twin of test_serve.py:1218: ``cold_start=True`` acquires each
    station's lock from its stream: one SYNC each, no LOST_SYNC, only
    genuine packets; the JAX receiver's events."""
    want, streams = [], []
    for i, (off, cfo) in enumerate(((12345, 180.0), (77777, -250.0))):
        sig, packets = _station_stream(rng, f"Cold Station {i}", n_frames=8)
        want.append({bytes(p) for p in packets})
        n = np.arange(len(sig) - off)
        rot = np.exp(2j * np.pi * cfo / C.SAMPLE_RATE_CS16_FM * n)
        streams.append((sig[off:] * rot).astype(np.complex64))

    def feed(rx):
        for lo in range(0, max(map(len, streams)), 250000):
            for i in range(2):
                rx.push(i, streams[i][lo:lo + 250000])
        rx.flush()
    events = _both(2, feed, frames_per_dispatch=1, cold_start=True)
    for i in range(2):
        kinds = [e.type for e in events[i]]
        assert kinds.count(EventType.SYNC) == 1
        assert EventType.LOST_SYNC not in kinds
        hdc = [e for e in events[i]
               if e.type == EventType.HDC and not e.crc_error]
        assert {e.data for e in hdc} <= want[i]
        assert len(hdc) >= 5 * 32


# --- the receiver's own properties ---

@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load(rng, tmp_path, saver):
    """One package's receiver saves mid-stream; a fresh receiver of each
    package loads the file and goes on: the two give the same events."""
    sig, _ = _station_stream(rng, "Cross Load", n_frames=4)
    split = int(len(sig) * 0.45)
    rx = (JaxReceiver if saver == "jax" else _port)(
        1, lambda st, ev: None, frames_per_dispatch=1)
    for lo in range(0, split, 200000):
        rx.push(0, sig[lo:min(lo + 200000, split)])
    path = str(tmp_path / f"{saver}.npz")
    rx.save(path)
    runs = []
    for cls in (JaxReceiver, _port):
        events = {0: []}
        rx = cls(1, lambda st, ev: events[0].append(ev),
                 frames_per_dispatch=1)
        rx.load(path)
        for lo in range(split, len(sig), 200000):
            rx.push(0, sig[lo:lo + 200000])
        rx.flush()
        runs.append(events)
    same_events(*runs)
    assert "Cross Load" in _titles(runs[1][0])
    assert max(e.cber for e in runs[1][0] if e.type == EventType.BER) == 0


def test_depth_two_matches_depth_zero(rng):
    """Outputs held in flight (depth 2) give the events of a receiver that
    consumes every dispatch at once (depth 0), over three dispatches."""
    streams = [_station_stream(rng, t, n_frames=4)[0]
               for t in ("Depth A", "Depth B")]
    runs = []
    for depth in (2, 0):
        events = {0: [], 1: []}
        rx = _port(2, lambda st, ev: events[st].append(ev),
                   frames_per_dispatch=1, depth=depth)
        _interleaved(streams, 70001)(rx)
        runs.append(events)
    for i in range(2):
        assert [key(e) for e in runs[0][i]] == [key(e) for e in runs[1][i]]
    assert sum(e.type == EventType.BER for e in runs[0][0]) >= 3


def test_receiver_arguments():
    """The constructor refuses what the reference asserts against:
    cold_start with locks, an unknown wire format or mode; a card is the
    default device."""
    with pytest.raises(ValueError):
        _port(1, lambda st, ev: None, cold_start=True, locks={"psmi": 1})
    with pytest.raises(ValueError):
        _port(1, lambda st, ev: None, input_format="cs8")
    with pytest.raises(ValueError):
        _port(1, lambda st, ev: None, mode="dab")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiStationReceiver(1, lambda st, ev: None)
