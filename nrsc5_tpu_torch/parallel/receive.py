"""Multi-GPU scaling: shard the receive chain over a (station, time) mesh.

PyTorch counterpart of ``nrsc5_tpu/parallel/receive.py``.  The reference
runs one SPMD program over a ``jax.sharding.Mesh``; here one
``torch.distributed`` rank is one shard of a ``DeviceMesh`` with dims
``("station", "time")`` (:func:`make_mesh`), and each rank holds its own
station block and time chunk in place of the reference's global sharded
array:

  * **Station data parallelism**: independent stations shard over the
    ``station`` axis; within a shard they run as one batch.
  * **Time-block sequence parallelism**: a long capture shards along time
    over the ``time`` axis.  Each time shard needs the next shard's first
    samples as right-hand context (the acquire window's overlap and the
    clock-drift slack): the reference's ``ppermute`` ``j -> j-1`` along
    ``time`` is a point-to-point send and receive between the time
    neighbours of a station row, the last shard taking the capture's tail.
    Carried DSP state is not streamed between shards: every shard starts
    from the chain's initial carry, as in the reference.
  * **Quality**: the reference's ``psum`` over the whole mesh is an
    ``all_gather`` of every rank's sums, added in rank order, so every
    rank returns the same value.

Each shard runs what the reference ``vmap``s: the complex chains'
:func:`~nrsc5_tpu_torch.pipeline.scan_chain.fm_chain_batch` and
:func:`~nrsc5_tpu_torch.pipeline.scan_chain_am.am_chain_batch` (on a card
the block step K17 and K18, or K19 and K20, for the shard's stations at
once, then the FEC through K6, K7 and K8, K11 and K15), or,
self-synchronizing, the
rc chain's on-device cold start
(:func:`~nrsc5_tpu_torch.pipeline.scan_chain_rc.cold_start_device_rc`: K9,
K2, the DFT kernel, K10 and K4), its block loop and the P1 decode.

The exchanges go straight between the devices where the process group's
backend carries the tensors' device (gloo: CPU tensors; nccl: CUDA
tensors).  gloo carries CUDA tensors only in ``broadcast`` and
``all_reduce``, so with CUDA tensors on a gloo group the exchanged
buffers (the halos, the quality sums, and nothing of the chain) go
through pinned host memory; any other pairing raises
(:func:`exchange_route`).  Each step records its last exchange
(:class:`Exchange`).  :func:`gather_mesh` assembles the reference's
global output layout from every rank's block.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.acquire import WINDOW_FM
from nrsc5_tpu_torch.ops.decode_fm import p1_decode
from nrsc5_tpu_torch.pipeline import scan_chain as sc
from nrsc5_tpu_torch.pipeline import scan_chain_am as sca
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc

HALO = C.FFTCP_FM + sc.SLACK  # right-neighbour context a time shard needs
HALO_AM = C.FFTCP_AM + sca.SLACK_AM


def make_mesh(n_station: int, n_time: int, *, device="cuda"):
    """A ``DeviceMesh`` of dims ``("station", "time")`` over every rank of
    the initialized process group (``n_station · n_time`` of them), row
    ``s`` holding station block ``s``'s time shards in order."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = K.resolve_device(device)
    return init_device_mesh(dev.type, (n_station, n_time),
                            mesh_dim_names=("station", "time"))


def shard_chunk_len(n_blocks: int) -> int:
    """Samples per (station, time) shard, excluding the halo."""
    return n_blocks * C.BLKSZ * C.FFTCP_FM


def shard_chunk_len_am(n_frames: int) -> int:
    """Samples per (station, time) shard of the AM chain."""
    return n_frames * 8 * C.BLKSZ * C.FFTCP_AM


def selfsync_halo() -> int:
    """Right-neighbour context a self-synchronizing time shard needs: the
    worst-case block-boundary skip, the symbol offset, the scan's slack and
    the coarse probe window."""
    return C.BLKSZ * C.FFTCP_FM + 2 * C.FFTCP_FM + sc.SLACK + WINDOW_FM


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

def exchange_route(backend: str, device: torch.device) -> str:
    """How a process group of ``backend`` moves tensors of ``device``:
    ``"direct"`` (gloo and CPU tensors, nccl and CUDA tensors) or
    ``"host"`` (gloo and CUDA tensors: through pinned host memory).  Any
    other pairing raises: the chain never moves to the CPU to suit a
    backend."""
    if (device.type, backend) in (("cpu", "gloo"), ("cuda", "nccl")):
        return "direct"
    if (device.type, backend) == ("cuda", "gloo"):
        return "host"
    raise ValueError(f"process group backend {backend!r} cannot move "
                     f"{device.type} tensors")


@dataclass
class Exchange:
    """One step's exchanges: the process group's backend, the route
    (:func:`exchange_route`), the bytes that went through host memory and
    the host wall of the exchanges (device-to-host copies included)."""
    backend: str
    route: str
    host_bytes: int = 0
    seconds: float = 0.0


class Comm:
    """This rank's place in ``mesh`` and the exchanges of tensors of
    ``device`` over the default process group, which the mesh covers."""

    def __init__(self, mesh, device: torch.device):
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError(f"the mesh holds {mesh.mesh.numel()} ranks, "
                             f"the process group {dist.get_world_size()}")
        self.ranks = mesh.mesh.tolist()
        self.coord = tuple(mesh.get_coordinate())
        self.device = device
        backend = str(dist.get_backend())
        self.stats = Exchange(backend, exchange_route(backend, device))

    @property
    def host(self) -> bool:
        return self.stats.route == "host"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend sends it: real, contiguous, and for the host
        route in pinned host memory."""
        t = torch.view_as_real(t) if t.is_complex() else t
        if not self.host:
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        self.stats.host_bytes += buf.nbytes
        return buf

    def _buffer(self, shape, dtype) -> torch.Tensor:
        if dtype.is_complex:
            shape, dtype = tuple(shape) + (2,), dtype.to_real()
        if self.host:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _unwire(self, buf: torch.Tensor, dtype) -> torch.Tensor:
        if self.host:
            self.stats.host_bytes += buf.nbytes
            buf = buf.to(self.device, non_blocking=True)
        return torch.view_as_complex(buf) if dtype.is_complex else buf

    def p2p(self, sends, recvs) -> list:
        """Send each ``(tensor, rank, tag)`` of ``sends`` and receive each
        ``(shape, dtype, rank, tag)`` of ``recvs`` (global ranks), all in
        one batch; returns the received tensors on ``device``, in order."""
        t0 = time.perf_counter()
        ops, bufs = [], []
        for t, rank, tag in sends:
            ops.append(dist.P2POp(dist.isend, self._wire(t), rank, tag=tag))
        for shape, dtype, rank, tag in recvs:
            bufs.append((self._buffer(shape, dtype), dtype))
            ops.append(dist.P2POp(dist.irecv, bufs[-1][0], rank, tag=tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = [self._unwire(b, dtype) for b, dtype in bufs]
        self.stats.seconds += time.perf_counter() - t0
        return out

    def isend(self, t: torch.Tensor, rank: int, tag: int = 0):
        """Start sending ``t`` to global rank ``rank``; returns the request
        (holding the sent buffer) to ``wait()`` on."""
        t0 = time.perf_counter()
        buf = self._wire(t)
        req = dist.isend(buf, rank, tag=tag)
        self.stats.seconds += time.perf_counter() - t0
        return _Sent(req, buf)

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (one shape on every rank), in rank order, on
        ``device``."""
        t0 = time.perf_counter()
        wire = self._wire(t)
        bufs = [self._buffer(t.shape, t.dtype)
                for _ in range(dist.get_world_size())]
        dist.all_gather(bufs, wire)
        out = [self._unwire(b, t.dtype) for b in bufs]
        self.stats.seconds += time.perf_counter() - t0
        return out

    def mesh_sum(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` summed over every rank of the mesh in rank order: the
        same bits on every rank."""
        parts = self.all_gather(values)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total


class _Sent:
    """A send in flight and the buffer it reads."""

    def __init__(self, req, buf):
        self.req, self.buf = req, buf

    def wait(self):
        self.req.wait()
        self.buf = None


def _mesh_mean(comm: Comm, err: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``psum(err) / psum(denom)`` over the whole mesh."""
    sums = comm.mesh_sum(torch.stack([
        err.to(torch.float32).reshape(()),
        torch.tensor(float(n), dtype=torch.float32, device=err.device)]))
    return sums[0] / sums[1]


def _extend(comm: Comm, samples, tails, right: int, left: int = 0):
    """This shard's extended chunk: the previous time shard's last ``left``
    samples (zeros on shard 0), the chunk, and the next shard's first
    ``right`` samples (the capture's ``tails`` on the last shard)."""
    s, t = comm.coord
    n_time = len(comm.ranks[s])
    rows = samples.shape[:1]
    tail = samples.shape[2:]
    sends, recvs = [], []
    if t > 0:
        sends.append((samples[:, :right], comm.ranks[s][t - 1], 0))
    if t < n_time - 1:
        recvs.append((rows + (right,) + tail, samples.dtype,
                      comm.ranks[s][t + 1], 0))
    if left:
        if t < n_time - 1:
            sends.append((samples[:, -left:], comm.ranks[s][t + 1], 1))
        if t > 0:
            recvs.append((rows + (left,) + tail, samples.dtype,
                          comm.ranks[s][t - 1], 1))
    got = comm.p2p(sends, recvs)
    nxt = got.pop(0) if t < n_time - 1 else tails
    parts = [samples, nxt]
    if left:
        prev = got.pop(0) if t > 0 else torch.zeros(
            rows + (left,) + tail, dtype=samples.dtype, device=samples.device)
        parts.insert(0, prev)
    return torch.cat(parts, dim=1)


def _check_shard(samples, tails, chunk: int, halo: int, rc: bool):
    tail = (2,) if rc else ()
    if samples.ndim != 2 + rc or tuple(samples.shape[1:]) != (chunk,) + tail:
        raise ValueError(f"samples: expected [S, {chunk}{', 2' * rc}], got "
                         f"{tuple(samples.shape)}")
    want = (samples.shape[0], halo) + tail
    if tuple(tails.shape) != want:
        raise ValueError(f"tails: expected {list(want)}, got "
                         f"{tuple(tails.shape)}")


class ShardedStep:
    """A sharded receive step over ``mesh``: ``step(samples, tails)`` on
    this rank's station block and time chunk and the capture's tail (which
    only the last time shard reads), each rank calling it at once.
    ``exchange`` holds the last call's :class:`Exchange`."""

    def __init__(self, mesh, local):
        self.mesh = mesh
        self._local = local
        self.exchange: Exchange | None = None

    def __call__(self, samples, tails):
        comm = Comm(self.mesh, samples.device)
        try:
            return self._local(comm, samples, tails)
        finally:
            self.exchange = comm.stats


def sharded_fm_chain(mesh, n_blocks: int, psmi: int = 1) -> ShardedStep:
    """The sharded FM receive step.  Each rank passes its shard ``samples``
    [S_loc, shard_chunk_len(n_blocks)] complex64, every chunk starting at a
    block boundary with the steady-state symbol offset (FFTCP//2), and
    ``tails`` [S_loc, HALO], the samples after the whole capture.  Returns
    this shard's (p1 [S_loc, F, 146176], p1_margin [S_loc, F], pids [S_loc,
    n_blocks, 80]) and the mesh-wide mean EVM power ``quality`` (the same
    on every rank); :func:`gather_mesh` assembles the reference's p1 [S,
    n_time·F, 146176] and pids [S, n_time·n_blocks, 80]."""
    if n_blocks % C.P1_FM_BLOCKS:
        raise ValueError("time shards must hold whole P1 frames")
    chunk = shard_chunk_len(n_blocks)

    def local(comm, samples, tails):
        _check_shard(samples, tails, chunk, HALO, False)
        ext = _extend(comm, samples, tails, HALO)
        carries = sc.stack_trees([sc.chain_init_carry(device=ext.device)]
                                 * ext.shape[0])
        out, _ = sc.fm_chain_batch(ext, carries, n_blocks, psmi, 0)
        quality = _mesh_mean(comm, out["diag"]["error"].sum(),
                             samples.shape[0] * n_blocks)
        return out["p1"], out["p1_margin"], out["pids"], quality

    return ShardedStep(mesh, local)


def sharded_fm_chain_selfsync(mesh, n_blocks: int,
                              psmi: int = 1) -> ShardedStep:
    """Self-synchronizing sharded receive: every time shard cold-starts on
    its device inside its own chunk (coarse CP timing, the integer-CFO and
    block-offset needle search, the block-count probe:
    :func:`~nrsc5_tpu_torch.pipeline.scan_chain_rc.cold_start_device_rc`),
    so the host aligns nothing.

    ``samples``: [S_loc, shard_chunk_len(n_blocks), 2] float32 rc, already
    conjugated, at arbitrary timing and CFO; ``tails`` [S_loc,
    selfsync_halo(), 2].  Each shard decodes the whole P1 frames whose 16
    aligned blocks lie in its chunk: F = n_blocks // 16 − 1 (one frame of
    headroom pays for the unknown alignment).  Returns this shard's (p1
    [S_loc, F, 146176], margins [S_loc, F], first_bc, cfo, locked [S_loc,
    1]: the per-shard scalars with a trailing time axis) and ``quality``."""
    n_frames = n_blocks // C.P1_FM_BLOCKS - 1
    if n_frames < 1:
        raise ValueError("need at least 32 blocks per time shard")
    chunk, halo = shard_chunk_len(n_blocks), selfsync_halo()

    def local(comm, samples, tails):
        _check_shard(samples, tails, chunk, halo, True)
        out = selfsync_decode(_extend(comm, samples, tails, halo), n_blocks,
                              psmi)
        quality = _mesh_mean(comm, out[-1], samples.shape[0] * n_blocks)
        return out[:-1] + (quality,)

    return ShardedStep(mesh, local)


def selfsync_decode(ext, n_blocks: int, psmi: int = 1):
    """One self-synchronizing shard's work on its extended chunk ``ext``
    [S, chunk + selfsync_halo(), 2]: the on-device cold start, the block
    loop from each station's lock, and the P1 decode of the whole frames
    after each station's partial leading one, with no host read-back.
    Returns (p1 [S, F, 146176], margins [S, F], first_bc, cfo, locked
    [S, 1], the error sum of the shard's blocks)."""
    n_frames = n_blocks // C.P1_FM_BLOCKS - 1
    s, dev = ext.shape[0], ext.device
    start, first_bc, cfo, angle, locked = rcc.cold_start_device_rc(ext)
    carry = rcc.chain_rc_init_carry(psmi=psmi, n_stations=s,
                                    device=dev)._replace(
        offset=start, cfo=cfo, prev_angle=angle)
    pm, diag, _, _ = rcc.frontend_scan_rc(ext, carry, n_blocks, psmi)
    skip = (C.P1_FM_BLOCKS - first_bc) % C.P1_FM_BLOCKS
    rows = skip[:, None].long() + torch.arange(
        n_frames * C.P1_FM_BLOCKS, device=dev)
    frames = torch.gather(pm, 1, rows[..., None].expand(
        -1, -1, pm.shape[-1])).reshape(s, n_frames, -1)
    p1, margin, _ = p1_decode(frames)
    err = (diag["error_lb"] + diag["error_ub"]).sum(dim=1).sum()
    return (p1.reshape(s, n_frames, -1), margin.reshape(s, n_frames),
            first_bc[:, None], cfo[:, None], locked[:, None], err)


def sharded_am_chain(mesh, n_frames: int, ma3: bool = False) -> ShardedStep:
    """AM analog of :func:`sharded_fm_chain`: ``samples`` [S_loc,
    shard_chunk_len_am(n_frames)] complex64, frame-aligned, and ``tails``
    [S_loc, HALO_AM].  Each shard starts its diversity delay lines afresh,
    so its first 3 frames are warm-up.  Returns this shard's (p1 [S_loc,
    F, 8, 3750], p3 [S_loc, F, len], pids [S_loc, F·8, 80])."""
    chunk = shard_chunk_len_am(n_frames)

    def local(comm, samples, tails):
        _check_shard(samples, tails, chunk, HALO_AM, False)
        ext = _extend(comm, samples, tails, HALO_AM)
        carries = sc.stack_trees([sca.am_chain_init_carry(device=ext.device)]
                                 * ext.shape[0])
        out, _ = sca.am_chain_batch(ext, carries, n_frames, ma3)
        return out["p1"], out["p3"], out["pids"]

    return ShardedStep(mesh, local)


def px_left_blocks(psmi: int) -> tuple[int, int, int]:
    """(left halo in blocks, its P1 frames, the PX warm-up frames) of
    :func:`sharded_fm_chain_px`: two whole P1 frames' worth of blocks or
    more, enough to re-prime the interleaver-IV state."""
    fl1, _ = sc.px_frame_lens(psmi)
    if not fl1:
        raise ValueError(f"psmi {psmi} has no PX1 channel")
    warm_px = IL.p3_iv_tables(fl1)[2]
    left_blocks = 2 * warm_px  # one PX frame a block pair
    left_blocks += (-left_blocks) % C.P1_FM_BLOCKS
    return left_blocks, left_blocks // C.P1_FM_BLOCKS, warm_px


def sharded_fm_chain_px(mesh, n_blocks: int, psmi: int = 3) -> ShardedStep:
    """Extended-mode (PX, interleaver-IV) receive across time shards.  The
    IV's two-frame delay keeps a shard from decoding its first IV cycle of
    PX frames from its own samples, so each shard also takes a LEFT halo,
    the previous shard's last :func:`px_left_blocks` blocks (zeros on
    shard 0), to re-prime the IV state, and drops the warm-up outputs.

    ``samples`` [S_loc, shard_chunk_len(n_blocks)] complex64, frame-aligned
    at the steady offset; ``tails`` [S_loc, HALO].  Returns this shard's
    (p1 [S_loc, F, 146176], px1 [S_loc, Fpx, fl1]) and ``quality`` (0, as
    the reference's)."""
    if n_blocks % C.P1_FM_BLOCKS:
        raise ValueError("time shards must hold whole P1 frames")
    left_blocks, warm_p1, warm_px = px_left_blocks(psmi)
    left = left_blocks * C.BLKSZ * C.FFTCP_FM
    chunk = shard_chunk_len(n_blocks)
    if left > chunk:
        raise ValueError(f"the left halo ({left_blocks} blocks) is longer "
                         f"than a shard ({n_blocks})")

    def local(comm, samples, tails):
        _check_shard(samples, tails, chunk, HALO, False)
        ext = _extend(comm, samples, tails, HALO, left)
        n, dev = ext.shape[0], ext.device
        out, _ = sc.fm_chain_batch(
            ext, sc.stack_trees([sc.chain_init_carry(device=dev)] * n),
            n_blocks + left_blocks, psmi, 0,
            px_states=sc.stack_trees([sc.px_init_state(psmi, device=dev)]
                                     * n))
        quality = comm.mesh_sum(torch.zeros(1, device=ext.device))[0]
        return out["p1"][:, warm_p1:], out["px1"][:, warm_px:], quality

    return ShardedStep(mesh, local)


def gather_mesh(mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's block ``local`` [S_loc, T_loc, ...] (one shape on every
    rank) -> the reference's global layout [S, n_time·T_loc, ...]: the
    station rows in order, each concatenating its time shards along axis
    1.  Every rank calls it and gets the whole."""
    if local.ndim < 2:
        raise ValueError("a shard's block has a station and a time axis")
    comm = Comm(mesh, local.device)
    parts = comm.all_gather(local)
    return torch.cat([torch.cat([parts[r] for r in row], dim=1)
                      for row in comm.ranks], dim=0)
