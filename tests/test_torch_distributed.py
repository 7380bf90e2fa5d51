"""The port's multi-process (multi-host) runs on the CPU: the twin of
tests/test_distributed.py and the rank spawner's failure paths.

Four real OS processes, each one gloo rank, form two "hosts" of two ranks
(the time axis within a host, the station axis across hosts, as the
reference's two processes of two virtual devices do); each host feeds
only its own station and reads back only its own rows.  The same
captures through JAX's sharded chain in this process give the same bits,
margins and, within 1e-4 relative (the standard of
tests/test_torch_block_chain.py:12 for the chain's error sums, or both
below the noise floor on these noiseless captures, as
tests/test_torch_parallel.py says), quality."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nrsc5_tpu.parallel import receive as JPR
from nrsc5_tpu_torch import serve
from nrsc5_tpu_torch.parallel import distributed as TD
from nrsc5_tpu_torch.parallel import pipeline as TPP
from nrsc5_tpu_torch.parallel import receive as TPR

from . import parallel_ranks as PRK
from .test_torch_parallel import _same_quality

REPO = Path(__file__).resolve().parents[1]


def test_four_rank_dcn_replay():
    """``python -m nrsc5_tpu_torch.parallel.distributed`` in four processes
    (two hosts of two ranks): every rank prints the reference's
    ``DCN_OK`` line, its host's frames bit-exact."""
    port = TD.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nrsc5_tpu_torch.parallel.distributed",
         "--num-processes", "4", "--process-id", str(i),
         "--coordinator", f"localhost:{port}", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(4)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert f"DCN_OK process={i}/4 host={i // 2}/2" in out, out[-3000:]
        assert "devices=4" in out, out[-3000:]


def test_distributed_fm_replay_matches_jax():
    """Each host's rows of ``distributed_fm_replay`` are JAX's rows of the
    same two stations through its 2 x 2 mesh."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 JAX devices")
    n_time, n_blocks = 2, 16
    res = TD.run_ranks(PRK.replay_hosts, 4, n_time, n_blocks, device="cpu",
                       timeout=300)
    caps = [TD.selftest_capture(h, n_time, n_blocks) for h in range(2)]
    samples = np.concatenate([c[0] for c in caps])
    tails = np.concatenate([c[1] for c in caps])
    want = JPR.sharded_fm_chain(JPR.make_mesh(2, n_time), n_blocks, 1)(
        samples, tails)
    p1, margin, pids = (np.asarray(x) for x in want[:3])
    for rank, r in enumerate(res):
        host = rank // n_time
        np.testing.assert_array_equal(r["p1"], p1[host:host + 1])
        np.testing.assert_array_equal(r["margin"], margin[host:host + 1])
        np.testing.assert_array_equal(r["pids"], pids[host:host + 1])
        for f in range(n_time):
            assert np.array_equal(r["p1"][0, f], caps[host][2][f])
    _same_quality([{"quality": [r["quality"]]} for r in res],
                  float(want[3]))


def test_station_mesh_from_device_mesh():
    """A 1-D DeviceMesh serves as a receiver's ``mesh=``: one device a rank
    of it, the carry on the first."""
    res = TD.run_ranks(PRK.station_mesh_devices, 2, device="cpu",
                       timeout=300)
    assert res == [["cpu", "cpu", "cpu"]] * 2


@pytest.mark.parametrize("fn,world,timeout,error,match", [
    (PRK.raises, 2, 120, RuntimeError, "rank 1 failed"),
    (PRK.dies, 1, 120, RuntimeError, "without a result"),
    (PRK.hangs, 2, 10, TimeoutError,
     r"ranks \[0, 1\] did not finish within")])
def test_run_ranks_fails_a_bad_rank(fn, world, timeout, error, match):
    """A rank that raises, dies or hangs fails the call within its limit,
    and every process is ended (rank 0 of the hanging pair waits for rank
    1 in the closing barrier, so neither finishes)."""
    with pytest.raises(error, match=match):
        TD.run_ranks(fn, world, device="cpu", timeout=timeout)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


_ENTRY_POINTS = {
    "make_mesh": lambda: TPR.make_mesh(1, 1),
    "make_stage_mesh": lambda: TPP.make_stage_mesh(),
    "init_distributed": lambda: TD.init_distributed(
        f"127.0.0.1:{TD.free_port()}", 1, 0),
    "global_station_mesh": lambda: TD.global_station_mesh(1),
    "lift_local_stations": lambda: TD.lift_local_stations(
        None, np.zeros((1, 4), np.complex64), np.zeros((1, 2), np.complex64)),
    "MultiStationReceiver_mesh": lambda: serve.MultiStationReceiver(
        2, lambda st, ev: None, mesh=["cuda", "cuda"]),
    "run_ranks": lambda: TD.run_ranks(PRK.raises, 1),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_parallel_entry_points_default_to_cuda(entry):
    """With no card and no ``device=``, the parallel entry points raise
    instead of running on the CPU (tests/test_torch_import.py's rule for
    the rest of the port)."""
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[entry]()
