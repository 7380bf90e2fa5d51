"""The port's multi-station receiver on the CPU: twins of the rest of
tests/test_serve.py's receiver cases (wire formats, packed outputs,
locks, relock that never locks, the alignment wait, MP5).  Each runs the
same stream and pushes as its JAX test and checks what that test checks
(packets, titles, SYNC and LOST_SYNC, queue bounds) on the port alone;
the twins that also hold the JAX receiver's events are in
tests/test_torch_serve.py.  The locks are the port's own cold starts.
The port runs its plain PyTorch versions (``device="cpu"``), one torch
thread."""

import numpy as np
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.serve import MultiStationReceiver

from .capture_helpers import build_am_capture
from .test_serve import _am_stream, _station_mats, _station_stream
from .test_torch_serve import _hdc, _lock_capture, _rc, _titles

torch.set_num_threads(1)


def _run(n, feed, **kw):
    events = {i: [] for i in range(n)}
    rx = MultiStationReceiver(n, lambda st, ev: events[st].append(ev),
                              device="cpu", **kw)
    feed(rx)
    return events, rx


def _chunks(i, data, size):
    def feed(rx):
        for lo in range(0, len(data), size):
            rx.push(i, data[lo:lo + size])
        rx.flush()
    return feed


def _iq16(sig):
    iq = np.empty(2 * len(sig), np.int16)
    iq[0::2] = np.clip(sig.real * 32767, -32768, 32767).astype(np.int16)
    iq[1::2] = np.clip(sig.imag * 32767, -32768, 32767).astype(np.int16)
    return iq


def test_multistation_cs16_input(rng):
    """Twin of test_serve.py:134: interleaved int16 I/Q, scaled on the
    device: packets and title."""
    sig, packets = _station_stream(rng, "CS16 Title")
    events, _ = _run(1, _chunks(0, _iq16(sig), 262144),
                     frames_per_dispatch=1, input_format="cs16")
    assert len(_hdc(events[0], {bytes(p) for p in packets})) >= 64
    assert "CS16 Title" in _titles(events[0])


def test_multistation_packed_outputs(rng):
    """Twin of test_serve.py:160: packed=True in both modes; the host
    unpack inverts exactly what each chain packed."""
    sig, packets = _station_stream(rng, "Packed Title")
    events, _ = _run(1, _chunks(0, sig, len(sig)), frames_per_dispatch=1,
                     packed=True)
    assert len(_hdc(events[0], {bytes(p) for p in packets})) >= 64
    assert "Packed Title" in _titles(events[0])
    am_buf, am_packets = _am_stream(rng, 7)
    events, _ = _run(1, _chunks(0, am_buf, len(am_buf)),
                     frames_per_dispatch=2, mode="am", packed=True)
    assert len(_hdc(events[0], {bytes(p) for p in am_packets})) >= 64


def test_multistation_coldstart_locks(rng):
    """Twin of test_serve.py:217: unknown timing and integer/fractional
    CFO -> the port's cold start -> locks= seeds the CFO state and the
    one-time alignment dispatch; whole frames after it, BER and MER."""
    capture, packets = _lock_capture(rng, 14, "Cold Start Title")
    bin_hz = C.SAMPLE_RATE_CS16_FM / C.FFT_FM
    capture = ch.impair(capture, sample_offset=1234,
                        cfo_hz=3 * bin_hz + 29.0, snr_db=25.0, rng=rng)
    lock = rcc.cold_start_rc(_rc(capture), device="cpu")
    assert lock is not None and lock["first_bc"] == 14
    tail = np.concatenate(
        [capture[lock["offset"]:], np.zeros(3 * C.FFTCP_FM, np.complex64)])
    events, _ = _run(1, _chunks(0, tail, 200000), frames_per_dispatch=1,
                     locks=lock)
    assert len(_hdc(events[0], {bytes(p) for p in packets})) >= 64
    assert "Cold Start Title" in _titles(events[0])
    bers = [e.cber for e in events[0] if e.type == EventType.BER]
    assert bers and max(bers) < 0.1
    assert any(e.type == EventType.MER and e.lower > 5 for e in events[0])


def test_multistation_bytes_and_buffer_reuse(rng):
    """Twin of test_serve.py:271: raw bytes in prime-sized chunks (partial
    pairs carried), and an rc buffer the caller clobbers after each
    push."""
    sig, packets = _station_stream(rng, "Bytes Title")
    want = {bytes(p) for p in packets}
    events, _ = _run(1, _chunks(0, _iq16(sig).tobytes(), 99991),
                     frames_per_dispatch=1, input_format="cs16")
    assert len(_hdc(events[0], want)) >= 64
    rc = _rc(sig)

    def feed(rx):
        buf = np.empty((150000, 2), np.float32)
        for lo in range(0, len(rc), len(buf)):
            part = rc[lo:lo + len(buf)]
            buf[:len(part)] = part
            rx.push(0, buf[:len(part)])
            buf[:] = -1.0  # clobber: the receiver must have copied
        rx.flush()
    events, _ = _run(1, feed, frames_per_dispatch=1)
    assert len(_hdc(events[0], want)) >= 64


def test_multistation_cu8_fm(rng):
    """Twin of test_serve.py:312: the 1.488 MS/s cu8 wire in odd-sized
    byte chunks, the ÷2 halfband on the device: packets and title."""
    sig, packets = _station_stream(rng, "CU8 Title")
    wire = ch.to_cu8(ch.upsample2(sig)).tobytes()
    events, _ = _run(1, _chunks(0, wire, 99991), frames_per_dispatch=1,
                     input_format="cu8")
    assert len(_hdc(events[0], {bytes(p) for p in packets})) >= 64
    assert "CU8 Title" in _titles(events[0])


def test_multistation_cu8_am(rng):
    """Twin of test_serve.py:339: AM over cu8, the ÷32 cascade on the
    device: packets."""
    buf, packets = _am_stream(rng, 7)
    up = ch.upsample_exact(buf, 32)
    wire = ch.to_cu8(up * (0.4 / np.abs(up).max()))
    events, _ = _run(1, _chunks(0, wire, 500000), frames_per_dispatch=2,
                     mode="am", input_format="cu8")
    assert len(_hdc(events[0], {bytes(p) for p in packets})) >= 64


def test_multistation_am_coldstart_locks(rng):
    """Twin of test_serve.py:586: MA1 and MA3 captures with unknown timing
    and CFO locked by the port's AM cold start, then served from the
    locks: packets."""
    bin_hz = C.SAMPLE_RATE_CS16_AM / C.FFT_AM
    for ma3 in (False, True):
        sig, packets = build_am_capture(rng, n_frames=9, ma3=ma3)
        imp = ch.impair(sig, sample_offset=641, cfo_hz=2 * bin_hz + 23.0,
                        snr_db=30.0, sample_rate=C.SAMPLE_RATE_CS16_AM,
                        rng=rng)
        rcs = np.stack([imp.real, imp.imag], -1).astype(np.float32)
        lock = scar.cold_start_am_rc(rcs, device="cpu")
        assert lock is not None and lock["ma3"] == ma3
        events, _ = _run(1, _chunks(0, imp[lock["offset"]:], 150000),
                         frames_per_dispatch=2, mode="am", ma3=ma3,
                         locks=lock)
        want = {bytes(b) for _, pk in packets for b in pk}
        assert len(_hdc(events[0], want)) >= 48, ma3


def test_multistation_cu8_coldstart_locks(rng):
    """Twin of test_serve.py:623: a cu8 wire served from a lock taken at
    the chain's rate; the alignment dispatch's queue gate counts the raw
    rate and the decimator history."""
    buf, packets = _lock_capture(rng, 14, "CU8 Cold Title")
    lock = rcc.cold_start_rc(_rc(buf), device="cpu")
    assert lock is not None and lock["first_bc"] == 14
    wire = ch.to_cu8(ch.upsample2(np.concatenate(
        [buf, np.zeros(3 * C.FFTCP_FM, np.complex64)])))
    raw = wire.tobytes()[4 * lock["offset"]:]
    events, _ = _run(1, _chunks(0, raw, 400001), frames_per_dispatch=1,
                     locks=lock, input_format="cu8")
    assert len(_hdc(events[0], {bytes(p) for p in packets})) >= 64
    assert "CU8 Cold Title" in _titles(events[0])


def test_multistation_relock_never_locks(rng):
    """Twin of test_serve.py:769: noise after the gap never relocks; the
    probe's backlog stays bounded and the other station decodes to the
    end."""
    good, good_packets = _station_stream(rng, "Survivor", n_frames=9)
    pre, _ = _station_stream(rng, "Doomed", n_frames=3)
    noise = rng.normal(0, 0.05, (len(good), 2)).astype(np.float32)
    bad = np.concatenate([_rc(pre), noise])

    def feed(rx):
        for lo in range(0, len(bad), 250000):
            rx.push(0, good[lo:lo + 250000])
            rx.push(1, bad[lo:lo + 250000])
            assert max(rx._sizes) < rx._needed + 6_000_000
        assert rx._sizes[1] < rx._needed + 800000
        rx.flush()
    events, _ = _run(2, feed, frames_per_dispatch=1)
    assert len(_hdc(events[0], {bytes(p) for p in good_packets})) >= 256
    kinds = [e.type for e in events[1]]
    assert EventType.LOST_SYNC in kinds and EventType.SYNC not in kinds


def test_multistation_am_relock_never_locks(rng):
    """Twin of test_serve.py:877: the AM case of the carrier that never
    returns."""
    good, good_packets = _am_stream(rng, 10)
    pre, _ = _am_stream(rng, 4)
    noise = rng.normal(0, 0.05, (len(good), 2)).astype(np.float32)
    bad = np.concatenate([
        np.stack([pre.real, pre.imag], -1).astype(np.float32), noise])

    def feed(rx):
        for lo in range(0, len(bad), 50000):
            rx.push(0, good[lo:lo + 50000])
            rx.push(1, bad[lo:lo + 50000])
        assert rx._sizes[1] < rx._needed + 600000
        rx.flush()
    events, _ = _run(2, feed, frames_per_dispatch=1, mode="am")
    assert len(_hdc(events[0], {bytes(p) for p in good_packets})) >= 128
    kinds = [e.type for e in events[1]]
    assert EventType.LOST_SYNC in kinds and EventType.SYNC not in kinds


def test_align_wait_does_not_stall_fleet(rng):
    """Twin of test_serve.py:906: a station waiting for its alignment
    window rides the batch with a frozen carry; the fleet decodes, and the
    late station's decode after its samples arrive is whole."""
    good, good_packets = _station_stream(rng, "Fleet Flows", n_frames=6)
    buf, late_packets = _lock_capture(rng, 14, "Late Joiner", n_frames=4)
    lock = rcc.cold_start_rc(_rc(buf), device="cpu")
    assert lock is not None and lock["first_bc"] == 14
    late = np.concatenate(
        [buf[lock["offset"]:], np.zeros(3 * C.FFTCP_FM, np.complex64)])
    locks = [rcc.cold_start_rc(_rc(good), device="cpu"), lock]

    def feed(rx):
        rx.push(1, late[:1000])
        for lo in range(0, len(good), 300000):
            rx.push(0, good[lo:lo + 300000])
        rx.drain()
        assert len(_hdc(events[0], {bytes(p) for p in good_packets})) >= 96
        for lo in range(1000, len(late), 300000):
            rx.push(1, late[lo:lo + 300000])
            rx.push(0, np.zeros(300000, np.complex64))
        rx.flush()
    events = {0: [], 1: []}
    rx = MultiStationReceiver(2, lambda st, ev: events[st].append(ev),
                              frames_per_dispatch=1, locks=locks,
                              device="cpu")
    feed(rx)
    assert len(_hdc(events[1], {bytes(p) for p in late_packets})) >= 64
    assert "Late Joiner" in _titles(events[1])


def test_multistation_mp5(rng):
    """Twin of test_serve.py:1175: MP5 stations (14 partitions a band,
    the extended ones undecoded) through the batched chain: program-0
    packets and titles."""
    titles = ["MP5 Station Zero", "MP5 Station One"]
    streams, want = [], []
    for t in titles:
        mats, packets = _station_mats(rng, t, n_frames=3)
        matrix = np.concatenate(mats)
        n_ext = C.partitions_per_band(5) - C.PM_PARTITIONS
        ext = rng.choice(
            np.array([-1, 1], np.int8),
            (len(matrix), 2 * n_ext * C.PARTITION_DATA_CARRIERS * 2))
        sig = modulate_fm(matrix, np.tile(np.arange(16), 3), 5,
                          ext_signs=ext)
        buf = np.zeros(len(sig) + C.FFTCP_FM, np.complex64)
        buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
        streams.append(buf)
        want.append({bytes(p) for p in packets})

    def feed(rx):
        pos = [0, 0]
        chunk = 48 * 1024 + 17
        while any(pos[i] < len(streams[i]) for i in range(2)):
            for i in range(2):
                rx.push(i, streams[i][pos[i]:pos[i] + chunk])
                pos[i] += chunk
        rx.flush()
    events, _ = _run(2, feed, frames_per_dispatch=1, psmi=5)
    for i in range(2):
        hdc = {e.data for e in events[i] if e.type == EventType.HDC
               and not e.crc_error and e.program == 0}
        assert len(hdc & want[i]) >= 64
        assert titles[i] in {e.title for e in events[i]
                             if e.type == EventType.ID3 and e.program == 0}


def test_admit_grows_the_fleet(rng):
    """A station admitted mid-stream (the reference's ``_admit``, its
    auto-discovery path) joins the fleet in the cold-start state: it locks
    from its own queue (one SYNC) and its packets come out whole, while the
    first station decodes on."""
    first, first_packets = _station_stream(rng, "First Station", n_frames=6)
    late, late_packets = _station_stream(rng, "Admitted Station",
                                         n_frames=5)
    n = np.arange(len(late) - 4321)
    late = (late[4321:] * np.exp(2j * np.pi * 90.0
                                 / C.SAMPLE_RATE_CS16_FM * n)
            ).astype(np.complex64)
    events = {0: [], 1: []}
    rx = MultiStationReceiver(1, lambda st, ev: events[st].append(ev),
                              frames_per_dispatch=1, device="cpu")
    split = len(first) - len(late)
    for lo in range(0, split, 250000):
        rx.push(0, first[lo:min(lo + 250000, split)])
    rx._admit(1)
    assert rx.n_stations == 2 and rx._carries.offset.shape == (2,)
    for lo in range(0, len(late), 250000):
        rx.push(0, first[split + lo:split + lo + 250000])
        rx.push(1, late[lo:lo + 250000])
    rx.flush()
    assert len(_hdc(events[0], {bytes(p) for p in first_packets})) >= 128
    kinds = [e.type for e in events[1]]
    assert kinds.count(EventType.SYNC) == 1
    assert EventType.LOST_SYNC not in kinds
    assert _hdc(events[1]) <= {bytes(p) for p in late_packets}
    assert len(_hdc(events[1], {bytes(p) for p in late_packets})) >= 64
