"""Rank bodies of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py), spawned by
``nrsc5_tpu_torch.parallel.distributed.run_ranks``.  They import only the
port (no JAX), so that a rank starts in a second or two; inputs come in as
``.npz`` files, results go back as numpy."""

from dataclasses import asdict

import numpy as np
import torch

from nrsc5_tpu_torch.parallel import pipeline as PP
from nrsc5_tpu_torch.parallel import receive as PR
from nrsc5_tpu_torch.parallel import replay as RP
from nrsc5_tpu_torch.pipeline import scan_chain as sc

STEPS = {"fm": PR.sharded_fm_chain, "selfsync": PR.sharded_fm_chain_selfsync,
         "am": PR.sharded_am_chain, "px": PR.sharded_fm_chain_px}


def _shard(path, mesh, device):
    """This rank's station block and time chunk of the capture at ``path``
    (``samples`` [S, n_time·chunk(, 2)], ``tails`` [S, halo(, 2)])."""
    s, t = mesh.get_coordinate()
    n_station, n_time = mesh.mesh.shape
    with np.load(path) as d:
        samples, tails = d["samples"], d["tails"]
    rows = samples.shape[0] // n_station
    chunk = samples.shape[1] // n_time
    take = slice(s * rows, (s + 1) * rows)
    return (torch.from_numpy(samples[take, t * chunk:(t + 1) * chunk].copy())
            .to(device), torch.from_numpy(tails[take].copy()).to(device))


def sharded(rank, world, device, kind, shape, path, arg, kw):
    """One shard of ``STEPS[kind](mesh, arg, **kw)`` over a mesh of
    ``shape``.  Returns its coordinate, the step's quality (where it has
    one), the exchange record and, on rank 0, every output gathered into
    the reference's global layout."""
    mesh = PR.make_mesh(*shape, device=device)
    samples, tails = _shard(path, mesh, device)
    step = STEPS[kind](mesh, arg, **kw)
    out = step(samples, tails)
    blocks = [PR.gather_mesh(mesh, o) for o in out if o.ndim >= 2]
    return {"coord": tuple(mesh.get_coordinate()),
            "quality": [float(o) for o in out if o.ndim == 0],
            "exchange": asdict(step.exchange),
            "global": blocks if rank == 0 else None}


def replay(rank, world, device, shape, path, n_blocks):
    """``replay_capture`` on this rank's shard: every station's events, each
    as (type name, payload) (an Event does not pickle)."""
    mesh = PR.make_mesh(*shape, device=device)
    samples, tails = _shard(path, mesh, device)
    sinks, quality = RP.replay_capture(samples, tails, mesh, n_blocks)
    return {"events": [[(e.type.name, e.payload) for e in sink.events]
                       for sink in sinks], "quality": quality}


def pipeline(rank, world, device, path, n_frames):
    """``pipelined_receive`` of the station at ``path`` (``samples``
    [buffer_len(16·n_frames)] complex64) on a two-rank stage mesh."""
    mesh = PP.make_stage_mesh(device=device)
    with np.load(path) as d:
        samples = torch.from_numpy(d["samples"]).to(device)
    out, carry = PP.pipelined_receive(
        samples, sc.chain_init_carry(device=device), n_frames, mesh)
    return {"out": out, "carry": sc.tree_leaves(carry),
            "stage": mesh.get_coordinate()[0]}


def replay_hosts(rank, world, device, n_time, n_blocks):
    """One rank of a world of hosts of ``n_time`` ranks: its host's
    self-test capture through ``distributed_fm_replay``; the host's rows."""
    from nrsc5_tpu_torch.parallel import distributed as TD
    samples, tails, _, _ = TD.selftest_capture(rank // n_time, n_time,
                                               n_blocks)
    mesh = TD.global_station_mesh(n_time, device=device)
    p1, margin, pids, quality = TD.distributed_fm_replay(
        mesh, samples, tails, n_blocks, device=device)
    return {"p1": p1, "margin": margin, "pids": pids, "quality": quality}


def station_mesh_devices(rank, world, device):
    """A 1-D DeviceMesh of the world as a receiver's ``mesh=``."""
    from torch.distributed.device_mesh import init_device_mesh

    from nrsc5_tpu_torch import serve
    mesh = init_device_mesh(device.type, (world,),
                            mesh_dim_names=("station",))
    rx = serve.MultiStationReceiver(2 * world, lambda st, ev: None,
                                    mesh=mesh)
    return [str(d) for d in serve.mesh_devices(mesh)] + [str(rx.device)]


def raises(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def hangs(rank, world, device):
    if rank == 1:
        import time
        time.sleep(600)
    return rank


def dies(rank, world, device):
    if rank == 0:
        import os
        os._exit(3)
    return rank
