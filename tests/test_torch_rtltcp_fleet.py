"""The port's ``serve.RtlTcpFleet`` and ``RtlTcpClient.read_some`` on the
CPU, against fake rtl_tcp servers on the loopback (tests/test_rtltcp.py's
``FakeRtlTcp``, which loops its capture): twins of tests/test_serve.py:433
(two FM tuners), :669 (a lost tuner) and :1503 (an FM and an AM tuner with
``modes="auto"``), each checking what its JAX test checks on the port
(``device="cpu"``), and ``close()`` waking a blocked read.  One torch
thread."""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.io.rtltcp import (CMD_SET_FREQUENCY, CMD_SET_GAIN,
                                       CMD_SET_SAMPLE_RATE, RtlTcpClient)
from nrsc5_tpu_torch.serve import (HeterogeneousReceiver,
                                   MultiStationReceiver, RtlTcpFleet)

from .test_rtltcp import FakeRtlTcp
from .test_serve import _am_stream, _station_stream

torch.set_num_threads(1)


def _servers(captures):
    servers = [FakeRtlTcp(c) for c in captures]
    for s in servers:
        s.start()
    return servers


def _run(servers, freqs, until, deadline_s=240, **kw):
    """A fleet over the servers until ``until(events)`` or the deadline;
    stopped (flushed) either way.  Returns the fleet and the events."""
    events = {i: [] for i in range(len(servers))}
    fleet = RtlTcpFleet([("127.0.0.1", s.port) for s in servers], freqs,
                        lambda st, ev: events[st].append(ev),
                        gain_db=30.0, device="cpu", **kw)
    fleet.start()
    try:
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and not until(events, servers):
            time.sleep(0.5)
    finally:
        fleet.stop()
        for s in servers:
            s.stop.set()
    return fleet, events


def _titles(events):
    return {e.title for e in events if e.type == EventType.ID3}


def test_rtltcp_fleet(rng):
    """Twin of test_serve.py:433: two looping FM tuners through one
    homogeneous receiver; each station's title and none of the other's,
    HDC packets, the tuner commands on the wire."""
    titles = ["Fleet Station A", "Fleet Station B"]
    servers = _servers([ch.to_cu8(ch.upsample2(
        _station_stream(rng, t)[0])).tobytes() for t in titles])
    fleet, events = _run(
        servers, [88.5e6, 94.7e6],
        lambda ev, _: all(titles[i] in _titles(ev[i]) for i in range(2)),
        frames_per_dispatch=1)
    assert isinstance(fleet.rx, MultiStationReceiver)
    for i in range(2):
        got = _titles(events[i])
        assert titles[i] in got and titles[1 - i] not in got
        assert any(e.type == EventType.HDC for e in events[i])
        ops = [c[0] for c in servers[i].commands]
        assert CMD_SET_SAMPLE_RATE in ops and CMD_SET_FREQUENCY in ops
        assert CMD_SET_GAIN in ops


def test_rtltcp_fleet_dead_tuner(rng):
    """Twin of test_serve.py:669: tuner 1's server stops after both
    decode; it gets LOST_DEVICE, and the live station decodes 128 more
    HDC packets (the fleet does not stall behind the lost tuner)."""
    servers = _servers([ch.to_cu8(ch.upsample2(
        _station_stream(rng, t)[0])).tobytes()
        for t in ("Live Station", "Doomed Station")])
    state = {"killed": False, "before": 0}

    def until(ev, srv):
        if not state["killed"]:
            if all(any(e.type == EventType.HDC for e in ev[i])
                   for i in range(2)):
                srv[1].stop.set()
                state["killed"] = True
                state["before"] = sum(e.type == EventType.HDC
                                      for e in ev[0])
            return False
        return (any(e.type == EventType.LOST_DEVICE for e in ev[1])
                and sum(e.type == EventType.HDC for e in ev[0])
                >= state["before"] + 128)

    _, events = _run(servers, [88.5e6, 94.7e6], until,
                     frames_per_dispatch=1)
    assert state["killed"]
    assert any(e.type == EventType.LOST_DEVICE for e in events[1])
    assert sum(e.type == EventType.HDC for e in events[0]) \
        >= state["before"] + 128


def test_heterogeneous_rtltcp_fleet_auto(rng):
    """Twin of test_serve.py:1503: an FM and an AM tuner with
    ``modes="auto"`` and no mode argument; each band found from its own
    stream, the FM title, 32 exact AM packets, no leakage."""
    fm_sig, _ = _station_stream(rng, "Auto Fleet FM", n_frames=4)
    am_sig, am_packets = _am_stream(rng, 10)
    up = ch.upsample_exact(am_sig, 32)
    servers = _servers([
        ch.to_cu8(ch.upsample2(fm_sig)).tobytes(),
        ch.to_cu8(up * (0.4 / np.abs(up).max())).tobytes()])
    am_want = {bytes(p) for p in am_packets}

    def am_hdc(ev):
        return {e.data for e in ev[1]
                if e.type == EventType.HDC and not e.crc_error}

    fleet, events = _run(
        servers, [88.5e6, 710e3],
        lambda ev, _: ("Auto Fleet FM" in _titles(ev[0])
                       and len(am_hdc(ev) & am_want) >= 32),
        deadline_s=300, modes="auto", frames_per_dispatch=1)
    assert isinstance(fleet.rx, HeterogeneousReceiver)
    assert fleet.rx.station_modes == [("fm", 1), ("am", False)]
    assert "Auto Fleet FM" in _titles(events[0])
    assert len(am_hdc(events) & am_want) >= 32
    fm_hdc = {e.data for e in events[0]
              if e.type == EventType.HDC and not e.crc_error}
    assert not (fm_hdc & am_want)


def test_rtltcp_fleet_arguments():
    """The fleet refuses a wire format other than cu8, discovery without a
    cold start and a count mismatch, before it connects anywhere."""
    cb = lambda st, ev: None  # noqa: E731
    with pytest.raises(ValueError, match="cu8"):
        RtlTcpFleet([("127.0.0.1", 1)], [88.5e6], cb, input_format="cs16",
                    device="cpu")
    with pytest.raises(ValueError, match="cold_start"):
        RtlTcpFleet([("127.0.0.1", 1)], [88.5e6], cb, modes="auto",
                    cold_start=False, device="cpu")
    with pytest.raises(ValueError):
        RtlTcpFleet([("127.0.0.1", 1)], [], cb, device="cpu")


def test_read_some():
    """``read_some``: one recv of at most n bytes; a socket timeout raises
    TimeoutError and loses nothing (the next read returns the bytes that
    follow); a clean close raises IOError."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    conns = []

    def serve():
        conn, _ = srv.accept()
        conns.append(conn)
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))

    t = threading.Thread(target=serve)
    t.start()
    client = RtlTcpClient("127.0.0.1", port, timeout=0.2)
    t.join()
    conn = conns[0]
    conn.sendall(bytes(range(10)))
    time.sleep(0.1)
    assert client.read_some(4) == bytes(range(4))
    assert client.read_some(100) == bytes(range(4, 10))
    with pytest.raises(TimeoutError):
        client.read_some(100)
    conn.sendall(b"\x0a\x0b")
    assert client.read_some(100) == b"\x0a\x0b"
    conn.close()
    with pytest.raises(IOError, match="closed"):
        client.read_some(100)
    client.close()
    srv.close()


def test_close_wakes_a_blocked_read():
    """``close()`` from another thread ends a ``read_some`` blocked on the
    socket at once (an IOError), not at the socket's timeout: how
    ``RtlTcpFleet.stop`` ends its readers."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    conns = []

    def serve():
        conn, _ = srv.accept()
        conns.append(conn)
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))

    t = threading.Thread(target=serve)
    t.start()
    client = RtlTcpClient("127.0.0.1", srv.getsockname()[1], timeout=30.0)
    t.join()
    errors = []

    def read():
        try:
            client.read_some(100)
        except OSError as e:
            errors.append(e)

    reader = threading.Thread(target=read)
    reader.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    client.close()
    reader.join(timeout=10)
    assert not reader.is_alive() and time.monotonic() - t0 < 5
    assert errors and not isinstance(errors[0], TimeoutError)
    conns[0].close()
    srv.close()
