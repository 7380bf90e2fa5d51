"""The port's receiver sharded over a station mesh (``MultiStationReceiver(
mesh=...)``) on the CPU: the twin of tests/test_serve.py:969.  Two
stations over ``mesh=["cpu", "cpu"]`` give, station by station, the
events of the unsharded receiver and of JAX's receiver over a mesh of 2
virtual devices (tests/serve_events.py's comparison: every event equal by
the reference's key, the MER floats within 0.1 dB), at least 64 clean HDC
packets and the station's title."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nrsc5_tpu.serve import MultiStationReceiver as JaxReceiver
from nrsc5_tpu_torch import serve
from nrsc5_tpu_torch.api.events import EventType

from .serve_events import same_events
from .test_serve import _station_stream


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(make, streams):
    events = {i: [] for i in range(len(streams))}
    rx = make(lambda st, ev: events[st].append(ev))
    pos = [0] * len(streams)
    chunk = 64 * 1024 + 13
    while any(pos[i] < len(streams[i]) for i in range(len(streams))):
        for i in range(len(streams)):
            rx.push(i, streams[i][pos[i]:pos[i] + chunk])
            pos[i] += chunk
    rx.flush()
    return events


def test_multistation_mesh_sharded(rng):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 JAX devices")
    titles = ["Mesh Station A", "Mesh Station B"]
    streams, want = [], []
    for t in titles:
        sig, packets = _station_stream(rng, t)
        streams.append(sig)
        want.append({bytes(p) for p in packets})

    def port(mesh):
        return lambda cb: serve.MultiStationReceiver(
            2, cb, frames_per_dispatch=1, device="cpu", mesh=mesh)
    sharded = _run(port(["cpu", "cpu"]), streams)
    plain = _run(port(None), streams)
    jax_mesh = Mesh(np.array(jax.devices()[:2]), ("station",))
    reference = _run(lambda cb: JaxReceiver(2, cb, frames_per_dispatch=1,
                                            mesh=jax_mesh), streams)
    same_events(plain, sharded)
    same_events(reference, sharded)
    for i, t in enumerate(titles):
        hdc = [e.data for e in sharded[i]
               if e.type == EventType.HDC and not e.crc_error]
        assert len(set(hdc) & want[i]) >= 64
        assert t in {e.title for e in sharded[i] if e.type == EventType.ID3}


def test_mesh_arguments():
    """A mesh must divide the stations, holds at least one device, and a
    sharded fleet cannot grow; the carry and its device are the first
    device's."""
    cb = lambda st, ev: None  # noqa: E731
    with pytest.raises(ValueError, match="3 stations over 2 devices"):
        serve.MultiStationReceiver(3, cb, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="empty mesh"):
        serve.MultiStationReceiver(2, cb, mesh=[])
    rx = serve.MultiStationReceiver(4, cb, mesh=["cpu", "cpu"])
    assert rx.device == torch.device("cpu")
    assert rx._carries.offset.shape == (4,)
    with pytest.raises(ValueError, match="cannot grow"):
        rx._admit(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.MultiStationReceiver(2, cb, mesh=["cuda:0", "cuda:0"])
