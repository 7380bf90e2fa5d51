"""The port's ``serve.HeterogeneousReceiver`` with its fleet declared, on
the CPU: twins of tests/test_serve.py:1026, 1121, 1261, 1428 and 1474 on
the same streams (the same seeded helpers) and pushes.  The mixed-psmi
and mixed-band twins hold the port's events to the JAX wrapper's, station
by station (tests/serve_events.py's comparison); every twin checks what
its JAX test checks.  Files of the explicit wrapper saved by either
package load in the other and resume to the same events.  The port runs
its plain PyTorch versions (``device="cpu"``), one torch thread."""

import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.serve import HeterogeneousReceiver as JaxHet
from nrsc5_tpu.tx.encoder import build_px_stream
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu.tx.transport_encoder import build_audio_pdu, pack_frame
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.serve import HeterogeneousReceiver

from .serve_events import same_events
from .test_serve import _am_stream, _station_mats, _station_stream

torch.set_num_threads(1)

CHUNK = 48 * 1024 + 17


def _port(n, cb, **kw):
    return HeterogeneousReceiver(n, cb, device="cpu", **kw)


def _hdc(events, want=None, program=None):
    got = {e.data for e in events
           if e.type == EventType.HDC and not e.crc_error
           and (program is None or e.program == program)}
    return got if want is None else got & want


def _feed(streams, chunk=CHUNK):
    def feed(rx):
        pos = [0] * len(streams)
        while any(pos[i] < len(streams[i]) for i in range(len(streams))):
            for i in range(len(streams)):
                rx.push(i, streams[i][pos[i]:pos[i] + chunk])
                pos[i] += chunk
        rx.flush()
    return feed


def _both(n, feed, **kw):
    """The same pushes through the JAX wrapper and the port's: their
    events, held equal, and the port's."""
    out = []
    for make in (lambda cb: JaxHet(n, cb, **kw),
                 lambda cb: _port(n, cb, **kw)):
        events = {i: [] for i in range(n)}
        feed(make(lambda st, ev: events[st].append(ev)))
        out.append(events)
    same_events(*out)
    return out[1]


def _mp3_stream(rng, title, n_cycles, sps_want=None):
    """An MP3 station: PM audio and P1 frames, and (with ``sps_want``)
    program-1 packets over PX1, as tests/test_serve.py:1040-1065 builds
    it; else random P3 bits (:1134-1146)."""
    fl = C.P3_FRAME_LEN_MP3_MP11
    if sps_want is None:
        p3_bits = rng.integers(0, 2, (n_cycles, 16, fl)).astype(np.uint8)
    else:
        p3_bytes = (fl - 24) // 8
        p3_bits = np.zeros((n_cycles, 16, fl), np.uint8)
        for cyc in range(n_cycles):
            for f in range(16):
                pkts = [rng.integers(0, 256, 150).astype(np.uint8)
                        .tobytes() for _ in range(3)]
                sps_want.update(pkts)
                g = cyc * 16 + f
                pdu = build_audio_pdu(pkts, program=1, pdu_seq=g % 8,
                                      seq=(g * 3) % 64, total_len=p3_bytes)
                p3_bits[cyc, f] = pack_frame(pdu, fl, C.PCI_AUDIO)
    px = build_px_stream(p3_bits, fl).reshape(n_cycles * 32 * C.BLKSZ, -1)
    mats, packets = _station_mats(rng, title, n_frames=n_cycles * 2)
    sig = modulate_fm(np.concatenate(mats),
                      np.tile(np.arange(16), n_cycles * 2), 3,
                      px1_signs=px)
    buf = np.zeros(len(sig) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    return buf, packets


def test_heterogeneous_psmi_fleet(rng):
    """Twin of test_serve.py:1026: MP1, MP3 (program-1 packets over PX1)
    and MP1 stations through one wrapper with psmis=[1, 3, 1]; the JAX
    wrapper's events, the titles, the PM packets and the PX1 packets."""
    titles = ["Het MP1 Zero", "Het MP3 One", "Het MP1 Two"]
    streams, want, sps_want = [], [], set()
    for st, t in enumerate(titles):
        if st == 1:
            sig, packets = _mp3_stream(rng, t, 3, sps_want)
        else:
            sig, packets = _station_stream(rng, t, n_frames=3)
        streams.append(sig)
        want.append({bytes(p) for p in packets})
    events = _both(3, _feed(streams), psmis=[1, 3, 1],
                   frames_per_dispatch=2)
    for i in range(3):
        assert titles[i] in {e.title for e in events[i]
                             if e.type == EventType.ID3 and e.program == 0}
        assert len(_hdc(events[i], want[i], program=0)) >= 64
    assert len(_hdc(events[1], sps_want, program=1)) >= 32


def test_heterogeneous_mixed_band(rng):
    """Twin of test_serve.py:1261: an FM and an AM station with
    modes=["fm", "am"]; the JAX wrapper's events, each station's packets,
    no leakage across the bands."""
    fm_sig, fm_packets = _station_stream(rng, "Band FM", n_frames=3)
    am_sig, am_packets = _am_stream(rng, 7)
    want = [{bytes(p) for p in fm_packets}, {bytes(p) for p in am_packets}]
    events = _both(2, _feed([fm_sig, am_sig]), modes=["fm", "am"],
                   psmis=[1, None], frames_per_dispatch=2)
    for i in range(2):
        hdc = _hdc(events[i])
        assert len(hdc & want[i]) >= 64, (i, len(hdc & want[i]))
        assert not (hdc & want[1 - i] - want[i])


def test_heterogeneous_fleet_checkpoint(rng, tmp_path):
    """Twin of test_serve.py:1121: an MP1 and an MP3 station saved
    mid-stream, loaded into a fresh wrapper of the same parameters, the
    rest decoded; each station's packets."""
    sig0, packets0 = _station_stream(rng, "Ckpt A", n_frames=4)
    sig1, packets1 = _mp3_stream(rng, "Ckpt B", 2)
    streams = [sig0, sig1]
    want = [{bytes(p) for p in packets0}, {bytes(p) for p in packets1}]

    def mk(cb):
        return _port(2, cb, psmis=[1, 3], frames_per_dispatch=1)

    events = {0: [], 1: []}
    rx = mk(lambda st, ev: events[st].append(ev))
    cut = 3 * len(streams[0]) // 7
    for i in range(2):
        rx.push(i, streams[i][:cut])
    rx.drain()
    path = str(tmp_path / "fleet.npz")
    rx.save(path)
    rx2 = mk(lambda st, ev: events[st].append(ev))
    rx2.load(path)
    for i in range(2):
        rx2.push(i, streams[i][cut:])
    rx2.flush()
    for i in range(2):
        assert len(_hdc(events[i], want[i])) >= 96, i


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load_explicit(rng, tmp_path, saver):
    """One package's explicit wrapper (an MP1 and an MA1 station) saves
    mid-stream; a fresh wrapper of each package loads the file and goes on:
    the same events."""
    fm_sig, fm_packets = _station_stream(rng, "Cross Het", n_frames=3)
    am_sig, _ = _am_stream(rng, 6)
    streams = [fm_sig, am_sig]
    kw = dict(modes=["fm", "am"], psmis=[1, None], frames_per_dispatch=1)
    split = [int(len(s) * 0.45) for s in streams]
    rx = (JaxHet(2, lambda st, ev: None, **kw) if saver == "jax"
          else _port(2, lambda st, ev: None, **kw))
    for i in range(2):
        rx.push(i, streams[i][:split[i]])
    path = str(tmp_path / f"{saver}.npz")
    rx.save(path)
    runs = []
    for make in (lambda cb: JaxHet(2, cb, **kw), lambda cb: _port(2, cb, **kw)):
        events = {0: [], 1: []}
        rx = make(lambda st, ev: events[st].append(ev))
        rx.load(path)
        for i in range(2):
            rx.push(i, streams[i][split[i]:])
        rx.flush()
        runs.append(events)
    same_events(*runs)
    assert "Cross Het" in {e.title for e in runs[1][0]
                           if e.type == EventType.ID3}
    assert len(_hdc(runs[1][0], {bytes(p) for p in fm_packets})) >= 32


def test_heterogeneous_mixed_band_relock(rng):
    """Twin of test_serve.py:1428: an FM station with a timing hole and an
    AM station, both cold started; the FM station loses and regains its
    lock, the AM station decodes throughout with one SYNC."""
    pre, _ = _station_stream(rng, "Het Before Gap", n_frames=3)
    post, post_packets = _station_stream(rng, "Het After Gap", n_frames=9)
    gappy = np.concatenate([pre[:len(pre) - 33333], post])
    am_sig, am_packets = _am_stream(rng, 9)
    events = {0: [], 1: []}
    rx = _port(2, lambda st, ev: events[st].append(ev), modes=["fm", "am"],
               psmis=[1, None], cold_start=True, frames_per_dispatch=1)
    for lo in range(0, len(gappy), 250000):
        rx.push(0, gappy[lo:lo + 250000])
        am_lo = lo // 16
        rx.push(1, am_sig[am_lo:am_lo + 250000 // 16])
    rx.push(1, am_sig[len(gappy) // 16:])
    rx.flush()
    kinds0 = [e.type for e in events[0]]
    assert EventType.LOST_SYNC in kinds0
    assert kinds0.count(EventType.SYNC) >= 2, kinds0
    assert len(_hdc(events[0], {bytes(p) for p in post_packets})) >= 32
    kinds1 = [e.type for e in events[1]]
    assert EventType.LOST_SYNC not in kinds1
    assert kinds1.count(EventType.SYNC) == 1
    assert len(_hdc(events[1], {bytes(p) for p in am_packets})) >= 64


def test_heterogeneous_dict_locks(rng):
    """Twin of test_serve.py:1474: one lock dict (the port's cold start)
    is given to every station."""
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc

    sig, packets = _station_stream(rng, "Dict Lock", n_frames=5)
    shifted = sig[23456:]
    rc = np.stack([shifted.real, -shifted.imag], -1).astype(np.float32)
    lock = rcc.cold_start_rc(rc, device="cpu")
    assert lock is not None and lock["psmi"] == 1
    events = {0: [], 1: []}
    rx = _port(2, lambda st, ev: events[st].append(ev), locks=lock,
               frames_per_dispatch=1)
    assert rx.station_modes == [("fm", 1), ("fm", 1)]
    tail = shifted[lock["offset"]:]
    for lo in range(0, len(tail), 250000):
        for i in range(2):
            rx.push(i, tail[lo:lo + 250000])
    rx.flush()
    want = {bytes(p) for p in packets}
    for i in range(2):
        assert len(_hdc(events[i], want)) >= 64, i


def test_heterogeneous_arguments():
    """The constructor refuses what the reference asserts against; the
    card is the default device."""
    cb = lambda st, ev: None  # noqa: E731
    with pytest.raises(ValueError, match="cold_start"):
        _port(2, cb, input_format="cu8")
    with pytest.raises(ValueError, match="cu8"):
        _port(2, cb, cold_start=True)
    with pytest.raises(ValueError, match="psmis"):
        _port(2, cb, modes=["fm", "am"])
    with pytest.raises(ValueError, match="mode"):
        _port(1, cb, modes=["dab"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HeterogeneousReceiver(1, cb, psmis=[1])
