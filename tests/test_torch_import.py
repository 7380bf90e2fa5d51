"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points never fall back to the CPU unasked."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch import serve, state
from nrsc5_tpu_torch.audio import sbr as SBR
from nrsc5_tpu_torch.audio.batch import BatchedAudioDecoder
from nrsc5_tpu_torch.audio.fleet import FleetAudioDecoder
from nrsc5_tpu_torch.audio.stage import DeviceStage
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import nrsc5_tpu_torch
names = ["nrsc5_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    nrsc5_tpu_torch.__path__, "nrsc5_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m.startswith("jax_") or m == "nrsc5_tpu"
             or m.startswith("nrsc5_tpu."))
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter (the test
    process itself has JAX loaded), pulls in no ``jax*`` module and no
    module of ``nrsc5_tpu`` (matched exactly: the port shares the prefix)."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    n, _, bad = res.stdout.strip().partition(" ")
    assert int(n) >= 15, res.stdout
    assert bad == "", bad


_IMPORT_ONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
print(",".join(sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "nrsc5_tpu" or m.startswith("nrsc5_tpu."))))
"""


@pytest.mark.parametrize("module", [
    "nrsc5_tpu_torch.api.events", "nrsc5_tpu_torch.utils.crc",
    "nrsc5_tpu_torch.native", "nrsc5_tpu_torch.transport.output",
    "nrsc5_tpu_torch.transport.pids", "nrsc5_tpu_torch.tx.sis_encoder",
    "nrsc5_tpu_torch.tx.transport_encoder",
    "nrsc5_tpu_torch.pipeline.block_graph", "nrsc5_tpu_torch.audio.fleet",
    "nrsc5_tpu_torch.io.rtltcp", "nrsc5_tpu_torch.ops.acquire",
    "nrsc5_tpu_torch.pipeline.scan_chain",
    "nrsc5_tpu_torch.pipeline.scan_chain_am",
    "nrsc5_tpu_torch.pipeline.receiver",
    "nrsc5_tpu_torch.pipeline.receiver_am",
    "nrsc5_tpu_torch.pipeline.turbo"])
def test_host_copies_import_no_jax(module):
    """Each of the receiver's host copies (events, CRCs, the native host
    ops, the transport, the SIS and transport encoders), K5's graph
    runner, fleet audio, the rtl_tcp client, and the per-block path (the
    complex acquire, the fused complex chains, the per-block and turbo
    receivers), imported alone in a fresh interpreter, pulls in no
    ``jax*`` module and no module of ``nrsc5_tpu``."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert res.stdout.strip() == "", res.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


_ENTRY_POINTS = {
    "chain_step": lambda: serve.chain_step(
        torch.full((1, 16, 2), 127, dtype=torch.uint8),
        rcc.chain_rc_init_carry(device="cpu"), 1),
    "ingest": lambda: serve.ingest(torch.full((1, 16, 2), 127,
                                              dtype=torch.uint8)),
    "chain_rc_init_carry": lambda: rcc.chain_rc_init_carry(),
    "cold_start": lambda: serve.cold_start(torch.full((1, 16, 2), 127,
                                                      dtype=torch.uint8)),
    "cold_start_rc": lambda: rcc.cold_start_rc(torch.zeros(80_000, 2)),
    "carry_from_numpy": lambda: state.carry_from_numpy(state.carry_to_numpy(
        rcc.chain_rc_init_carry(device="cpu"))),
    "BatchedAudioDecoder": lambda: BatchedAudioDecoder(1),
    "MultiStationReceiver": lambda: serve.MultiStationReceiver(
        1, lambda station, event: None),
    "MultiStationReceiver_am": lambda: serve.MultiStationReceiver(
        1, lambda station, event: None, mode="am"),
    "DeviceStage": lambda: DeviceStage(SBR.derive_tables(SBR.SbrHeader()),
                                       1.0, interpol=True),
    "FleetAudioDecoder": lambda: FleetAudioDecoder(
        1, lambda station, event: None),
    "HeterogeneousReceiver": lambda: serve.HeterogeneousReceiver(
        2, lambda station, event: None, psmis=[1, 3]),
    "HeterogeneousReceiver_auto": lambda: serve.HeterogeneousReceiver(
        2, lambda station, event: None, cold_start=True,
        input_format="cu8"),
    "RtlTcpFleet": lambda: serve.RtlTcpFleet(
        [("127.0.0.1", 1)], [88.5e6], lambda station, event: None,
        modes="auto"),
    "FMReceiver": lambda: _block().FMReceiver(lambda *a: None),
    "AMReceiver": lambda: _block("receiver_am").AMReceiver(lambda *a: None),
    "TurboFMReceiver": lambda: _block("turbo").TurboFMReceiver(
        lambda *a: None),
    "chain_init_carry": lambda: _block("scan_chain").chain_init_carry(),
    "am_chain_init_carry": lambda: _block(
        "scan_chain_am").am_chain_init_carry(),
    "px_init_state": lambda: _block("scan_chain").px_init_state(3),
    "NRSC5_block": lambda: _session().NRSC5(lambda ev: None,
                                            chain="block"),
    "block_state_from_numpy": lambda: state.block_state_from_numpy(
        {"phase": 1, "prev_angle": 0}, "acquire"),
}


def _block(name: str = "receiver"):
    import importlib
    return importlib.import_module(f"nrsc5_tpu_torch.pipeline.{name}")


def _session():
    from nrsc5_tpu_torch.api import session
    return session


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_cuda(entry):
    """With no card and no ``device=``, an entry point raises instead of
    running on the CPU."""
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[entry]()


def test_library_path_hashes_headers(tmp_path, monkeypatch):
    """A kernel's library name changes with its source and with every
    header it includes from csrc/, and with nothing else there."""
    csrc = tmp_path / "csrc"
    shutil.copytree(K.CSRC, csrc)
    monkeypatch.setattr(K, "CSRC", csrc)
    names = ("cfo_scan", "sync_block", "demod_fold")
    before = {n: K.library_path(n) for n in names}
    with open(csrc / "costas.cuh", "a") as f:
        f.write("// changed\n")
    after = {n: K.library_path(n) for n in names}
    assert after["cfo_scan"] != before["cfo_scan"]
    assert after["sync_block"] != before["sync_block"]
    assert after["demod_fold"] == before["demod_fold"]
