"""The port's ``serve.HeterogeneousReceiver`` with serve-side mode
discovery, on the CPU: twins of tests/test_serve.py:1316 and :1563 on the
same streams (the same seeded helpers) and pushes, each checking what its
JAX test checks on the port (``device="cpu"``, the plain PyTorch
versions); the repair of the reference's ``restore()`` (into a fresh auto
wrapper it raises), and a station too short for a probe left staged by
``flush()``.  tests/test_torch_hetero_resume.py holds the auto fleet's
other twins.  One torch thread, so the module stays inside the budget
beside other workers."""

import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_px_stream
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.serve import HeterogeneousReceiver

from .capture_helpers import build_am_capture
from .test_serve import _am_stream, _station_mats, _station_stream

torch.set_num_threads(1)

CHUNK = 2 * 1000 * 1000


def _auto(n, cb, **kw):
    return HeterogeneousReceiver(n, cb, cold_start=True, input_format="cu8",
                                 device="cpu", **kw)


def _hdc(events, want=None):
    got = {e.data for e in events
           if e.type == EventType.HDC and not e.crc_error}
    return got if want is None else got & want


def _fm_wire(sig):
    return ch.to_cu8(ch.upsample2(sig)).tobytes()


def _am_wire(sig):
    up = ch.upsample_exact(sig, 32)
    return ch.to_cu8(up * (0.4 / np.abs(up).max())).tobytes()


def _push_all(rx, wires, chunk=CHUNK):
    for lo in range(0, max(len(w) for w in wires), chunk):
        for i, w in enumerate(wires):
            rx.push(i, w[lo:lo + chunk])


def test_heterogeneous_auto_discovery(rng):
    """Twin of test_serve.py:1316: MP1, MP3, MA1 and MP1 stations pushed
    as raw cu8 with no mode argument; each station's mode found from its
    stream, the two MP1 stations in one grown group, one SYNC each, no
    leakage, the titles."""
    titles = ["Auto MP1 A", "Auto MP3 B", None, "Auto MP1 D"]
    wires, want = [], []
    for st, t in enumerate(titles):
        if st == 2:
            am, pkts = _am_stream(rng, 10)
            wires.append(_am_wire(am))
        elif st == 1:
            n_frames = 4
            fl = C.P3_FRAME_LEN_MP3_MP11
            p3_bits = rng.integers(
                0, 2, (n_frames // 2, 16, fl)).astype(np.uint8)
            px = build_px_stream(p3_bits, fl).reshape(
                n_frames * 16 * C.BLKSZ, -1)
            mats, pkts = _station_mats(rng, t, n_frames=n_frames)
            s = modulate_fm(np.concatenate(mats),
                            np.tile(np.arange(16), n_frames), 3,
                            px1_signs=px)
            buf = np.zeros(len(s) + C.FFTCP_FM, np.complex64)
            buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(s)] = s
            wires.append(_fm_wire(buf))
        else:
            sig, pkts = _station_stream(rng, t, n_frames=4)
            wires.append(_fm_wire(sig))
        want.append({bytes(p) for p in pkts})

    events = {i: [] for i in range(4)}
    rx = _auto(4, lambda st, ev: events[st].append(ev),
               frames_per_dispatch=2)
    _push_all(rx, wires)
    rx.flush()

    assert rx.station_modes == [("fm", 1), ("fm", 3), ("am", False),
                                ("fm", 1)]
    assert sorted((k, g.n_stations)
                  for k, g in zip(rx._keys, rx._groups)) == \
        [(("am", False), 1), (("fm", 1), 2), (("fm", 3), 1)]
    for i in range(4):
        kinds = [e.type for e in events[i]]
        assert kinds.count(EventType.SYNC) == 1, (i, kinds)
        assert EventType.LOST_SYNC not in kinds
        hdc = _hdc(events[i])
        assert len(hdc & want[i]) >= 32, (i, len(hdc & want[i]))
        for j in range(4):
            if j != i:
                assert not (hdc & want[j] - want[i]), (i, j)
    for i in (0, 1, 3):
        assert titles[i] in {e.title for e in events[i]
                             if e.type == EventType.ID3}


def test_heterogeneous_auto_discovery_ma3(rng):
    """Twin of test_serve.py:1563: an MA1 and an MA3 station from cu8 with
    no mode argument land in two groups, ("am", False) and ("am", True),
    each decoding its own packets."""
    wires, wants = [], []
    for ma3 in (False, True):
        sig, packets = build_am_capture(rng, n_frames=10, ma3=ma3)
        wires.append(_am_wire(np.concatenate(
            [np.zeros(C.FFTCP_AM // 2, np.complex64), sig])))
        wants.append({bytes(b) for _, pk in packets for b in pk})
    events = {0: [], 1: []}
    rx = _auto(2, lambda st, ev: events[st].append(ev),
               frames_per_dispatch=2)
    _push_all(rx, wires)
    rx.flush()
    assert rx.station_modes == [("am", False), ("am", True)]
    assert len(rx._groups) == 2
    for i in range(2):
        kinds = [e.type for e in events[i]]
        assert kinds.count(EventType.SYNC) == 1, (i, kinds)
        hdc = _hdc(events[i])
        assert len(hdc & wants[i]) >= 32, (i, len(hdc & wants[i]))
        assert not (hdc & wants[1 - i] - wants[i])


def test_restore_into_fresh_auto_wrapper_raises(rng):
    """A checkpoint of a fleet with a group restored into a fresh auto
    wrapper (which has no group yet) raises, where the reference's
    restore() zips over no group and silently restores nothing."""
    from nrsc5_tpu.serve import HeterogeneousReceiver as JaxHet

    sig, _ = _station_stream(rng, "Restore Raise", n_frames=2)
    wire = _fm_wire(sig)
    rx = _auto(1, lambda st, ev: None, frames_per_dispatch=1)
    rx.push(0, wire)
    assert rx.station_modes == [("fm", 1)]
    states = rx.checkpoint()
    assert len(states) == 1
    with pytest.raises(ValueError, match="group"):
        _auto(1, lambda st, ev: None, frames_per_dispatch=1).restore(states)
    # the reference accepts it and restores nothing
    ref = JaxHet(1, lambda st, ev: None, cold_start=True,
                 input_format="cu8", frames_per_dispatch=1)
    ref.restore(states)
    assert ref._groups == [] and ref.station_modes == [None]
    # the same counts restore
    rx2 = HeterogeneousReceiver(1, lambda st, ev: None, psmis=[1],
                                cold_start=True, input_format="cu8",
                                frames_per_dispatch=1, device="cpu")
    rx2.restore(states)
    with pytest.raises(ValueError):
        rx2.restore(states + states)


def test_flush_leaves_a_short_station_staged(rng):
    """A station whose stream is shorter than the FM window is not probed
    by flush(), and its staged samples stay visible in queue_depth."""
    rx = _auto(1, lambda st, ev: None)
    short = np.full((rx._need_fm // 2, 2), 127, np.uint8)
    rx.push(0, short)
    depth = rx.queue_depth(0)
    assert depth == len(short) + 217
    rx.flush()
    assert rx.station_modes == [None]
    assert rx.queue_depth(0) == depth
    assert rx._probe_next[0] == 0.0
