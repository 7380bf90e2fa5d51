"""Multi-process (multi-host) execution of the sharded receive chain.

PyTorch counterpart of ``nrsc5_tpu/parallel/distributed.py``, completing
the communication story of :mod:`nrsc5_tpu_torch.parallel.receive`:

  * the ``time`` mesh axis: halo exchange between the time neighbours of a
    station row, within one host (:mod:`.receive`);
  * the ``station`` mesh axis spans hosts: each host ingests and feeds only
    its own stations' I/Q (radio front ends are naturally distributed), and
    only the small mesh-wide reductions (link quality) cross hosts.

Process setup is ``torch.distributed``'s: every process is one rank, one
shard of the mesh, joined by :func:`init_distributed` at the coordinator's
``tcp://`` address (gloo for CPU tensors, NCCL for CUDA ones, unless
``backend=`` says otherwise).  :func:`global_station_mesh` lays the ranks
out host-major, ``n_time`` a host, so the process boundary between hosts
falls on the station axis as in the reference; :func:`lift_local_stations`
gives each rank its time chunk of its host's stations, and
:func:`local_view` assembles a host's output rows.  :func:`run_ranks`
spawns a world of ranks on one machine and collects their results (the
tests' and ``chip_smoke.py``'s launcher).

Self-test, one process a rank (``--n-time`` ranks a host)::

    python -m nrsc5_tpu_torch.parallel.distributed --num-processes 4 \\
        --process-id {0,1,2,3} --coordinator localhost:12377 --device cpu

Every host modulates the same deterministic capture of its own station,
feeds it through the global (station, time) mesh, and asserts its local
P1 and PIDS output bit-exact.
"""

from __future__ import annotations

import argparse
import datetime
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K

GROUP_TIMEOUT = datetime.timedelta(seconds=600)  # a collective's longest wait


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     *, device="cuda",
                     backend: str | None = None) -> torch.device:
    """Join this process to a world of ``num_processes`` ranks as rank
    ``process_id``, at ``coordinator`` (``host:port``, which rank 0 serves)
    by ``init_process_group(init_method="tcp://...")``.  The backend is
    gloo for ``device="cpu"`` and NCCL for a CUDA device unless
    ``backend`` names another.  A CUDA device without an index takes the
    rank's modulo the card count, and is made current.  Returns the
    device."""
    dev = K.resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=GROUP_TIMEOUT)
    return dev


def global_station_mesh(n_time: int, *, device="cuda"):
    """The (station, time) mesh over every rank of the world, host-major:
    ranks ``h·n_time .. h·n_time + n_time − 1`` (host ``h``, which runs
    ``n_time`` ranks) form station row ``h``, so the halo exchange along
    ``time`` stays on a host and only mesh-wide reductions cross hosts."""
    from nrsc5_tpu_torch.parallel import receive as pr
    K.resolve_device(device)
    world = dist.get_world_size()
    if world % n_time:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{n_time}")
    return pr.make_mesh(world // n_time, n_time, device=device)


def lift_local_stations(mesh, local_samples, local_tails, *,
                        device="cuda"):
    """This rank's shard of its host's stations: ``local_samples`` [S_local,
    T] (the host's whole capture of its own stations) -> (its time chunk
    [S_local, T / n_time], the tails [S_local, HALO]) as tensors on
    ``device``."""
    dev = K.resolve_device(device)
    _, t = mesh.get_coordinate()
    n_time = mesh.mesh.shape[1]
    samples = torch.as_tensor(np.asarray(local_samples))
    if samples.shape[1] % n_time:
        raise ValueError(f"{samples.shape[1]} samples do not split into "
                         f"{n_time} time shards")
    chunk = samples.shape[1] // n_time
    return (samples[:, t * chunk:(t + 1) * chunk].contiguous().to(dev),
            torch.as_tensor(np.asarray(local_tails)).to(dev))


def local_view(mesh, local: torch.Tensor) -> np.ndarray:
    """This host's rows of a sharded output: every rank's block gathered
    and this rank's station row concatenated along the time axis (axis 1),
    as numpy."""
    from nrsc5_tpu_torch.parallel import receive as pr
    s, _ = mesh.get_coordinate()
    whole = pr.gather_mesh(mesh, local)
    rows = local.shape[0]
    return whole[s * rows:(s + 1) * rows].cpu().numpy()


def distributed_fm_replay(mesh, local_samples, local_tails, n_blocks: int,
                          psmi: int = 1, *, device="cuda"):
    """Run the sharded FM chain across hosts on ``device``; return this
    host's outputs: (p1 [S_local, n_time·F, 146176], margin, pids,
    quality), quality the mesh-wide mean EVM power (a float, the same on
    every rank)."""
    from nrsc5_tpu_torch.parallel import receive as pr
    samples, tails = lift_local_stations(mesh, local_samples, local_tails,
                                         device=device)
    p1, margin, pids, quality = pr.sharded_fm_chain(mesh, n_blocks, psmi)(
        samples, tails)
    return (local_view(mesh, p1), local_view(mesh, margin),
            local_view(mesh, pids), float(quality))


# ---------------------------------------------------------------------------
# spawning a world of ranks on one machine
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port of the loopback that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy(value):
    """Tensors (nested in dicts, lists and tuples) as numpy arrays: what a
    rank hands back through the results queue."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        items = [_numpy(v) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") \
            else type(value)(items)
    return value


def _rank_main(results, fn, rank: int, world: int, port: int, device,
               backend, args) -> None:
    try:
        torch.set_num_threads(1)
        dev = init_distributed(f"127.0.0.1:{port}", world, rank,
                               device=device, backend=backend)
        value = _numpy(fn(rank, world, dev, *args))
        dist.barrier()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device="cuda", backend=None,
              timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned processes
    joined into one process group on the loopback (:func:`init_distributed`
    on ``device``; with ``device="cuda:0"`` and gloo every rank shares one
    card), each with one torch thread; return each rank's result,
    tensors as numpy, in rank order.  ``fn`` must be importable by name
    (a module's top-level function).  Raises if a rank raises, dies, or
    does not finish within ``timeout`` seconds; every process is ended
    before it returns or raises.  ``"cuda"`` with no card raises before
    any rank starts."""
    K.resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        results, fn, rank, world, port, device, backend, args),
        daemon=True) for rank in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   f" did not finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        # every rank reported: let them leave the process group; else the
        # others wait on the failed one, and are ended after a moment
        grace = 30.0 if len(got) == world else 1.0
        for p in procs:
            p.join(timeout=grace)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited non-zero: {bad}")
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# self-test (one process of the multi-host job)
# ---------------------------------------------------------------------------

def selftest_capture(host: int, n_time: int, n_blocks: int):
    """Host ``host``'s station: ``n_time`` P1 frames of random bits (seed
    1000 + host) and the 32 blocks after them, modulated at the steady
    offset.  Returns (samples [1, n_time·chunk], tails [1, HALO], p1 bits,
    PIDS bits)."""
    from nrsc5_tpu_torch.parallel import receive as pr
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
    from nrsc5_tpu_torch.tx.modulator import modulate_fm

    rng = np.random.default_rng(1000 + host)
    n_frames = n_time * n_blocks // C.P1_FM_BLOCKS
    p1 = rng.integers(0, 2, (n_frames, C.P1_FRAME_LEN_FM)).astype(np.uint8)
    pids = rng.integers(0, 2, (n_frames, 16, C.PIDS_FRAME_LEN)).astype(
        np.uint8)
    mats = [build_pm_matrix(p1[i], pids[i]) for i in range(n_frames)]
    trail = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))[:32]
    matrix = np.concatenate(mats + [trail])
    bc_seq = np.concatenate([np.tile(np.arange(16), n_frames), [0]])
    sig = modulate_fm(matrix, bc_seq, 1)
    total = n_time * pr.shard_chunk_len(n_blocks)
    buf = np.zeros(total + pr.HALO, np.complex64)
    start = C.FFTCP_FM // 2
    buf[start:] = sig[:total + pr.HALO - start]
    return buf[None, :total], buf[None, total:], p1, pids


def selftest(rank: int, world: int, device, n_time: int = 2,
             n_blocks: int = 16) -> str:
    """One rank of the self-test: build host ``rank // n_time``'s capture,
    decode it over :func:`global_station_mesh` with
    :func:`distributed_fm_replay`, assert its P1 and PIDS bit-exact and
    the quality small, time a second step, and return the ``DCN_OK`` line
    (also printed)."""
    host, n_hosts = rank // n_time, world // n_time
    samples, tails, p1, pids = selftest_capture(host, n_time, n_blocks)
    mesh = global_station_mesh(n_time, device=device)
    if mesh.mesh.shape[0] != n_hosts:
        raise AssertionError(f"{mesh.mesh.shape[0]} station rows for "
                             f"{n_hosts} hosts")
    t0 = time.perf_counter()
    p1_out, _, pids_out, quality = distributed_fm_replay(
        mesh, samples, tails, n_blocks, device=device)
    wall = time.perf_counter() - t0
    n_frames = len(p1)
    if p1_out.shape != (1, n_frames, C.P1_FRAME_LEN_FM):
        raise AssertionError(f"p1 shape {p1_out.shape}")
    for f in range(n_frames):
        if not np.array_equal(p1_out[0, f], p1[f]):
            raise AssertionError(f"host {host} frame {f} not bit-exact")
        if not np.array_equal(pids_out[0, f * 16:(f + 1) * 16], pids[f]):
            raise AssertionError(f"host {host} frame {f} PIDS not exact")
    if not quality < 0.05:
        raise AssertionError(f"quality {quality}")
    t0 = time.perf_counter()
    distributed_fm_replay(mesh, samples, tails, n_blocks, device=device)
    steady = time.perf_counter() - t0
    line = (f"DCN_OK process={rank}/{world} host={host}/{n_hosts} "
            f"devices={world} frames={n_frames} quality={quality:.4f} "
            f"first_wall={wall:.1f}s steady_wall={steady:.3f}s")
    print(line, flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:12377")
    ap.add_argument("--n-time", type=int, default=2,
                    help="ranks a host (the time-shard axis)")
    ap.add_argument("--n-blocks", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    dev = init_distributed(args.coordinator, args.num_processes,
                           args.process_id, device=args.device,
                           backend=args.backend)
    try:
        selftest(args.process_id, args.num_processes, dev, args.n_time,
                 args.n_blocks)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
