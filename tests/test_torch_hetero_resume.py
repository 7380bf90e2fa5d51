"""The port's auto ``serve.HeterogeneousReceiver`` across a save and a
load, and at the end of its streams, on the CPU: twins of
tests/test_serve.py:1388 (a checkpoint with one station still staged) and
:1607 (a quiesced station never discovered), the repair of the reference's
``flush()`` (a station still undiscovered is probed once more), and files
of either package's auto wrapper loaded by the other's, both resuming to
the same events (tests/serve_events.py's comparison).  ``device="cpu"``,
one torch thread."""

import numpy as np
import pytest
import torch

from nrsc5_tpu.serve import HeterogeneousReceiver as JaxHet
from nrsc5_tpu_torch.api.events import EventType

from .serve_events import same_events
from .test_serve import _am_stream, _station_stream
from .test_torch_hetero_auto import CHUNK, _am_wire, _auto, _fm_wire, \
    _hdc, _push_all

torch.set_num_threads(1)


def test_heterogeneous_auto_quiesce_undiscovered(rng):
    """Twin of test_serve.py:1607: a dead tuner whose mode was never found
    stops probing once quiesced, flush() included, and keeps its staged
    samples visible; the other station discovers and decodes."""
    sig, packets = _station_stream(rng, "Quiesce Live", n_frames=4)
    wire = _fm_wire(sig)
    noise = rng.integers(96, 160, (len(wire) // 2, 2)) \
        .astype(np.uint8).tobytes()
    events = {0: [], 1: []}
    rx = _auto(2, lambda st, ev: events[st].append(ev),
               frames_per_dispatch=1)
    rx.push(0, wire[:CHUNK])
    rx.push(1, noise[:CHUNK])
    rx.quiesce(1)
    assert rx._probe_next[1] == float("inf")
    for lo in range(CHUNK, len(wire), CHUNK):
        rx.push(0, wire[lo:lo + CHUNK])
        rx.push(1, noise[lo:lo + CHUNK])
    rx.flush()
    assert rx.station_modes[0] == ("fm", 1)
    assert rx.station_modes[1] is None
    assert rx._probe_next[1] == float("inf")
    assert rx.queue_depth(1) > 0
    assert len(_hdc(events[0], {bytes(p) for p in packets})) >= 64
    assert all(e.type != EventType.SYNC for e in events[1])



def test_heterogeneous_auto_checkpoint(rng, tmp_path):
    """Twin of test_serve.py:1388: saved with one station grouped and one
    still staged, loaded into a fresh auto wrapper, both decode."""
    fm_sig, fm_packets = _station_stream(rng, "Ckpt Auto FM", n_frames=4)
    am_sig, am_packets = _am_stream(rng, 10)
    wires = [_fm_wire(fm_sig), _am_wire(am_sig)]
    events = {0: [], 1: []}
    rx = _auto(2, lambda st, ev: events[st].append(ev),
               frames_per_dispatch=2)
    cut = 2 * 3_000_000
    for i, w in enumerate(wires):
        rx.push(i, w[:cut])
    rx.drain()
    assert rx.station_modes == [("fm", 1), None]
    path = str(tmp_path / "auto_fleet.npz")
    rx.save(path)
    rx2 = _auto(2, lambda st, ev: events[st].append(ev),
                frames_per_dispatch=2)
    rx2.load(path)
    for i, w in enumerate(wires):
        rx2.push(i, w[cut:])
    rx2.flush()
    assert rx2.station_modes == [("fm", 1), ("am", False)]
    for i, want in enumerate(({bytes(p) for p in fm_packets},
                              {bytes(p) for p in am_packets})):
        assert len(_hdc(events[i], want)) >= 32, i


# --- the repairs of the reference's auto fleet ---


def test_flush_discovers_a_late_carrier(rng):
    """A station whose FM carrier appears after a failed probe, with its
    pushes ending inside the probe wait: flush() probes it once more and
    hands it to its group, which locks on it (one SYNC, no LOST_SYNC,
    nothing foreign); the reference's flush() leaves it undiscovered and
    its stream staged.  The first station decodes throughout."""
    sig0, packets0 = _station_stream(rng, "Flush Live", n_frames=3)
    sig1, packets1 = _station_stream(rng, "Flush Late", n_frames=2)
    live = _fm_wire(sig0)
    late = _fm_wire(sig1)
    probe = _auto(1, lambda st, ev: None)
    need_fm = probe._need_fm
    noise = rng.integers(96, 160, (need_fm + 5000, 2)).astype(np.uint8)
    # the carrier pushed after the failed probe: just inside the wait
    carrier = late[:2 * (need_fm - 4000)]
    runs = []
    for make in (lambda cb: _auto(2, cb, frames_per_dispatch=1),
                 lambda cb: JaxHet(2, cb, cold_start=True,
                                   input_format="cu8",
                                   frames_per_dispatch=1)):
        events = {0: [], 1: []}
        rx = make(lambda st, ev: events[st].append(ev))
        rx.push(1, noise.tobytes())
        assert rx.station_modes[1] is None
        assert rx._probe_next[1] == rx._pushed[1] + need_fm  # it failed
        for lo in range(0, len(carrier), 300001):
            rx.push(1, carrier[lo:lo + 300001])
        assert rx._pushed[1] < rx._probe_next[1]  # inside the wait
        assert rx.station_modes[1] is None
        _push_all(rx, [live], chunk=1_000_001)
        depth = rx.queue_depth(1)
        rx.flush()
        runs.append((rx, events, depth))
    (rx, events, _), (ref, ref_events, ref_depth) = runs
    assert rx.station_modes == [("fm", 1), ("fm", 1)]
    kinds = [e.type for e in events[1]]
    assert kinds.count(EventType.SYNC) == 1, kinds
    assert EventType.LOST_SYNC not in kinds
    assert _hdc(events[1]) <= {bytes(p) for p in packets1}
    assert len(_hdc(events[0], {bytes(p) for p in packets0})) >= 64
    assert not (_hdc(events[0]) - {bytes(p) for p in packets0})
    # the reference: never probed again, its stream left staged
    assert ref.station_modes[1] is None
    assert ref.queue_depth(1) == ref_depth
    assert not ref_events[1]


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load_auto(rng, tmp_path, saver):
    """One package's auto wrapper saves with its FM station grouped and its
    AM station still staged; a fresh auto wrapper of each package loads the
    file and goes on: the same events, the same modes."""
    fm_sig, fm_packets = _station_stream(rng, "Cross Auto FM", n_frames=3)
    am_sig, _ = _am_stream(rng, 8)
    wires = [_fm_wire(fm_sig), _am_wire(am_sig)]
    cut = 2 * 3_000_000

    def jax_auto(cb):
        return JaxHet(2, cb, cold_start=True, input_format="cu8",
                      frames_per_dispatch=2)

    def port_auto(cb):
        return _auto(2, cb, frames_per_dispatch=2)

    rx = (jax_auto if saver == "jax" else port_auto)(lambda st, ev: None)
    for i, w in enumerate(wires):
        rx.push(i, w[:cut])
    rx.drain()
    assert list(rx.station_modes) == [("fm", 1), None]
    path = str(tmp_path / f"{saver}.npz")
    rx.save(path)
    runs = []
    for make in (jax_auto, port_auto):
        events = {0: [], 1: []}
        rx = make(lambda st, ev: events[st].append(ev))
        rx.load(path)
        for i, w in enumerate(wires):
            rx.push(i, w[cut:])
        rx.flush()
        assert list(rx.station_modes) == [("fm", 1), ("am", False)]
        runs.append(events)
    same_events(*runs)
    assert len(_hdc(runs[1][0], {bytes(p) for p in fm_packets})) >= 32
