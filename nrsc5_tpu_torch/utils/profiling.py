"""Profiling helpers: a device trace and timed calls.

PyTorch counterpart of ``nrsc5_tpu/utils/profiling.py``.  :func:`trace`
records a ``torch.profiler`` trace of the CPU and, where there is one, the
CUDA device, written as a Chrome trace; :func:`measure` times a callable
with the device synchronized and reports achieved throughput against the
FLOP and byte counts the caller supplies.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` (the CPU, and CUDA where a
    card is present) and write ``trace.json``, a Chrome trace, into
    ``log_dir``.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class Measurement:
    wall_s: float
    reps: int
    flops: float | None = None
    bytes_accessed: float | None = None

    @property
    def per_call_s(self) -> float:
        return self.wall_s / self.reps

    @property
    def tflops(self) -> float | None:
        if self.flops is None:
            return None
        return self.flops / self.per_call_s / 1e12

    @property
    def gbps(self) -> float | None:
        if self.bytes_accessed is None:
            return None
        return self.bytes_accessed / self.per_call_s / 1e9

    def report(self, name: str) -> str:
        parts = [f"{name}: {self.per_call_s * 1e3:.3f} ms/call"]
        if self.tflops is not None:
            parts.append(f"{self.tflops:.3f} TFLOP/s")
        if self.gbps is not None:
            parts.append(f"{self.gbps:.1f} GB/s")
        return "  ".join(parts)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def sync_output(out) -> None:
    """Wait for the devices of every CUDA tensor in ``out`` (a tensor, or
    dicts, lists and tuples of them), or, with none and CUDA in use, for
    the current device; CPU tensors are ready when returned."""
    devices = {t.device for t in _tensors(out) if t.is_cuda}
    if not devices and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for dev in devices:
        torch.cuda.synchronize(dev)


def measure(fn, *args, reps: int = 10, warmup: int = 1,
            flops: float | None = None,
            bytes_accessed: float | None = None,
            sync=None) -> Measurement:
    """Time ``fn(*args)`` over ``reps`` calls after ``warmup`` calls, each
    call's output synchronized: by default the devices of its CUDA tensors
    (:func:`sync_output`), else ``sync(out)``.  No CUDA call is timed
    without a synchronization."""
    sync = sync or sync_output
    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        sync(fn(*args))
    return Measurement(wall_s=time.perf_counter() - t0, reps=reps,
                       flops=flops, bytes_accessed=bytes_accessed)
