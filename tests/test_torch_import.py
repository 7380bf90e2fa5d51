"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points never fall back to the CPU unasked."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nrsc5_tpu_torch import serve, state
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
    "carry_from_numpy": lambda: state.carry_from_numpy(state.carry_to_numpy(
        rcc.chain_rc_init_carry(device="cpu"))),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_cuda(entry):
    """With no card and no ``device=``, an entry point raises instead of
    running on the CPU."""
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[entry]()
