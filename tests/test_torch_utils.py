"""The port's checkpoints (``utils/checkpoint.py``), profiling helpers
(``utils/profiling.py``) and ``RtlTcpClient.set_offset_tuning``, on the
CPU.

The checkpoint round trip is the twin of tests/test_scan_chain.py:84 on the
port's complex chain: a carry saved after one block and loaded into a
fresh structure resumes bit-exactly (the P1 frame the transmitted one and
the one-pass run's).  A file saved by either package loads in the other
and resumes there, bit-exact against the transmitted frame."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrsc5_tpu.pipeline import scan_chain as JSC
from nrsc5_tpu.utils import checkpoint as JCK
from nrsc5_tpu_torch import state as ST
from nrsc5_tpu_torch.io import rtltcp as RT
from nrsc5_tpu_torch.pipeline import scan_chain as TSC
from nrsc5_tpu_torch.pipeline import scan_chain_am as TSCA
from nrsc5_tpu_torch.pipeline import scan_chain_rc as TRC
from nrsc5_tpu_torch.utils import checkpoint as TCK
from nrsc5_tpu_torch.utils import profiling as PF

from .test_rtltcp import FakeRtlTcp
from .test_scan_chain import _steady_signal


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_chain(buf, carry, n_blocks, first_bc):
    return TSC.fm_chain_scan(torch.from_numpy(buf), carry, n_blocks, 1,
                             first_bc)


def test_checkpoint_resume(rng, tmp_path):
    buf, p1, _, n_blocks, first_bc = _steady_signal(rng)
    out_full, _ = _port_chain(buf, TSC.chain_init_carry(device="cpu"),
                              n_blocks, first_bc)
    first = TSC.buffer_len(1)
    _, carry1 = _port_chain(buf[:first], TSC.chain_init_carry(device="cpu"),
                            1, first_bc)
    path = str(tmp_path / "carry.npz")
    TCK.save_state(path, carry1)
    carry1b = TCK.load_state(path, TSC.chain_init_carry(device="cpu"))
    for a, b in zip(TSC.tree_leaves(carry1), TSC.tree_leaves(carry1b)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    out2, _ = _port_chain(buf, carry1b, n_blocks - 1, (first_bc + 1) % 16)
    assert np.array_equal(out2["p1"][0].numpy(), p1[0])
    assert np.array_equal(out2["p1"][0].numpy(), out_full["p1"][0].numpy())


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_across_packages(rng, tmp_path, saver):
    """One block through the saving package, the carry through its
    ``save_state``, the other package's ``load_state`` and the remaining 16
    blocks through the loading package: the frame is the transmitted one."""
    buf, p1, _, n_blocks, first_bc = _steady_signal(rng)
    first = TSC.buffer_len(1)
    path = str(tmp_path / "carry.npz")
    if saver == "jax":
        _, carry1 = JSC.fm_chain_scan(jnp.asarray(buf[:first]),
                                      JSC.chain_init_carry(), 1, 1, first_bc)
        JCK.save_state(path, carry1)
        carry = TCK.load_state(path, TSC.chain_init_carry(device="cpu"))
        out, _ = _port_chain(buf, carry, n_blocks - 1, (first_bc + 1) % 16)
    else:
        _, carry1 = _port_chain(buf[:first],
                                TSC.chain_init_carry(device="cpu"), 1,
                                first_bc)
        TCK.save_state(path, carry1)
        carry = JCK.load_state(path, JSC.chain_init_carry())
        out, _ = JSC.fm_chain_scan(jnp.asarray(buf), carry, n_blocks - 1, 1,
                                   (first_bc + 1) % 16)
    assert np.array_equal(np.asarray(out["p1"][0]), p1[0])


@pytest.mark.parametrize("like", ["rc", "am", "am_rc"])
def test_checkpoint_leaves(tmp_path, like):
    """The rc, complex AM and rc AM carries round trip through a file whose
    ``leaf_{i}`` arrays are the reference's pytree order (the AM delay
    lines last), with the reference's ``__treedef__`` entry."""
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as TAMRC
    make = {"rc": lambda: TRC.chain_rc_init_carry(psmi=3, n_stations=2,
                                                  device="cpu"),
            "am": lambda: TSCA.am_chain_init_carry(device="cpu"),
            "am_rc": lambda: TAMRC.am_chain_rc_init_carry(
                n_stations=2, device="cpu")}[like]
    state = make()
    leaves = TSC.tree_leaves(state)
    for i, x in enumerate(leaves):  # distinct contents a leaf
        x.copy_(torch.full_like(x, i + 1))
    path = str(tmp_path / "state.npz")
    TCK.save_state(path, state)
    with np.load(path) as data:
        assert json.loads(bytes(data["__treedef__"]).decode())
        for i, x in enumerate(leaves):
            np.testing.assert_array_equal(data[f"leaf_{i}"], x.numpy())
    back = TCK.load_state(path, make())
    for a, b in zip(leaves, TSC.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ST.carry_leaves(back)[-1].shape == leaves[-1].shape


def test_checkpoint_shape_mismatch(tmp_path):
    path = str(tmp_path / "state.npz")
    TCK.save_state(path, TRC.chain_rc_init_carry(n_stations=2, device="cpu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        TCK.load_state(path, TRC.chain_rc_init_carry(n_stations=3,
                                                     device="cpu"))


def test_measure_cpu():
    x = torch.arange(1000, dtype=torch.float32)
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": (a * 2, a + 1)}
    m = PF.measure(fn, x, reps=4, warmup=2, flops=2000.0,
                   bytes_accessed=8000.0)
    assert len(calls) == 6 and m.reps == 4 and m.wall_s > 0
    assert m.per_call_s == m.wall_s / 4
    assert m.tflops == 2000.0 / m.per_call_s / 1e12
    assert m.gbps == 8000.0 / m.per_call_s / 1e9
    assert m.report("double").startswith("double: ")
    synced = []
    PF.measure(fn, x, reps=3, warmup=0, sync=synced.append)
    assert len(synced) == 3 and isinstance(synced[0], dict)
    assert PF.Measurement(1.0, 2).tflops is None


def test_trace_cpu(tmp_path):
    x = torch.randn(64, 64)
    with PF.trace(str(tmp_path / "prof")) as prof:
        (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(ev.get("name") == "aten::mm" for ev in doc["traceEvents"])


def test_set_offset_tuning():
    """The bytes 0x0A 00000001 (then 0x0A 00000000) reach the server, as the
    JAX client's do."""
    from nrsc5_tpu.io import rtltcp as JRT
    sent = []
    for module in (RT, JRT):
        server = FakeRtlTcp(bytes([127]) * 65536)
        server.start()
        try:
            client = module.RtlTcpClient("127.0.0.1", server.port)
            client.set_offset_tuning(True)
            client.set_offset_tuning(False)
            for _ in range(200):
                if len(server.commands) >= 2:
                    break
                server.stop.wait(0.01)
            client.close()
        finally:
            server.stop.set()
        sent.append(list(server.commands))
    assert sent[0] == [(0x0A, 1), (0x0A, 0)]
    assert sent[0] == sent[1]
