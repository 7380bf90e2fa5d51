"""The port's rtl_tcp path on the CPU: tests/test_rtltcp.py's fake server
streams a cu8 capture; the port's session worker (``device="cpu"``)
connects, auto-gains, decodes and emits events."""

import threading

import torch

from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.api.session import MODE_FM, NRSC5
from nrsc5_tpu_torch.io import rtltcp as RT

from .test_rtltcp import FakeRtlTcp, _capture


def test_rtltcp_tables_match():
    """The client's command codes and gain tables are the JAX package's."""
    from nrsc5_tpu.io import rtltcp as JRT
    names = [n for n in dir(JRT) if n.startswith(("CMD_", "TUNER_"))]
    assert len(names) == 16
    for n in names:
        assert getattr(RT, n) == getattr(JRT, n), n
    assert RT.GAIN_TABLES == JRT.GAIN_TABLES


def test_rtltcp_session(rng):
    """The twin of test_rtltcp.py:83, on the port's session: SYNC through
    rtl_tcp, with the sample rate, frequency and auto-gain commands sent
    and AGC events emitted."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    server = FakeRtlTcp(_capture(rng))
    server.start()

    events = []
    done = threading.Event()

    def cb(ev):
        events.append(ev)
        if ev.type == EventType.SYNC:
            done.set()

    try:
        radio = NRSC5.open_rtltcp("127.0.0.1", server.port, cb, MODE_FM,
                                  device="cpu")
        radio.set_frequency(88.5e6)
        assert radio.get_frequency() == 88.5e6
        radio.start()
        assert done.wait(timeout=120), \
            f"no sync via rtl_tcp; events={set(e.type for e in events)}"
        radio.close()
    finally:
        server.stop.set()
        torch.set_num_threads(threads)

    ops = [c[0] for c in server.commands]
    assert 0x02 in ops  # sample rate
    assert 0x01 in ops  # frequency
    assert 0x04 in ops  # gain probes from auto-gain
    assert any(e.type == EventType.AGC for e in events)
