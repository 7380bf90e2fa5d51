"""K5: the sequential block loops on the device.

The reference runs its block loops as ``lax.scan`` (FM:
``nrsc5_tpu/pipeline/scan_chain_rc.py:274-303``; AM:
``scan_chain_am_rc.py:259-292``), which XLA compiles into one device
while-loop with no host work between blocks.  The port's counterpart has
two parts:

* the carry step between one block's kernels and the next block's, K5
  (``csrc/block_carry.cu``: :func:`block_carry` for FM,
  :func:`block_carry_am` for AM), beside its plain version.  Inside the
  loops the step is fused into the block's last kernel: K4 takes the FM
  step after each block and K13 the AM one (their ``carry`` argument,
  whose plain versions call :func:`block_carry_plain` and
  :func:`block_carry_am_plain`), so a dispatch launches K5 once, FM's
  first step from the carry, and AM's never.  With it, and with K2/K4
  (K12/K13) writing each block's outputs straight into slot b of
  block-major buffers, the loop body (in
  :func:`nrsc5_tpu_torch.pipeline.scan_chain_rc.scan_blocks` and
  :func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.scan_blocks_am`) holds
  no host work and no allocation;
* :class:`CapturedLoop`: such a loop captured once as a CUDA graph with
  static inputs and outputs, then replayed for each dispatch
  (:func:`captured` keeps one per key: the path, the device and every
  shape and static argument the captured work depends on).

A replay never calls :func:`nrsc5_tpu_torch.kernels.launch`, so each
graph records, at capture, how many times it launches each kernel, and
adds those counts to ``kernels.COUNTS`` once per replay.  The warm-up run
and the capture are set-up: their launches are not counted.

A capture holds :data:`CAPTURE_LOCK`.  A thread that does device work
beside a receiver's thread (the fleet audio decoder's dispatch and stage
builds) holds it too, so that no other thread launches, allocates or
synchronizes while a graph is being captured (a capture in the default
global mode fails on any of these from another thread), and no launch of
another thread is counted into a graph's launches.  :data:`CAPTURES`
records each capture's key and wall.

A graph is captured for CUDA tensors only.  On the CPU, and with
``plain=True``, the loops run eagerly (the CPU has no graphs); a caller
may also ask for the eager kernel loop on the card (``graph=False``), to
hold the graph against it.  Nothing falls back to the eager loop when a
capture or a replay fails: the error is raised.
"""

from __future__ import annotations

import threading
import time

import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops.acquire_rc import WINDOW_AM, WINDOW_FM
# the per-station scalars the FM carry step reads and writes, and its plain
# version (K4 and K18 take the step too)
from nrsc5_tpu_torch.ops.sync_fm import (FM_STATE,  # noqa: F401
                                         block_carry_plain)


def run_into(kernel, plain_fn, plain: bool, args: tuple, out):
    """``kernel(*args, out=out)``, or with ``plain`` the plain version's
    result copied into ``out``: a loop step that writes preallocated
    buffers on either path."""
    if plain:
        return K.into(out, plain_fn(*args))
    return kernel(*args, out=out)


# ---------------------------------------------------------------------------
# K5: the carry step
# ---------------------------------------------------------------------------

def block_carry(keep, k4_samperr, k4_angle, state: dict, first: bool,
                plain: bool = False) -> None:
    """K5's FM carry step, in place on ``state`` ({name: [S] tensor} for
    each name of :data:`FM_STATE`).  The block loop launches it once, with
    ``first``; K4 takes the later steps.  Unless ``first``, it folds block
    b's
    results in: ``offset += WINDOW_FM - keep`` (K2's keep), ``prev_angle =
    angle`` (the angle block b ran with), ``samperr_fb = k4_samperr`` and
    ``angle_fb = k4_angle`` (K4's).  Then it sets block b + 1's inputs
    (block 0's with ``first``): ``samperr = FFTCP_FM // 2 + samperr_fb``
    and ``angle = prev_angle - angle_fb`` for K2, ``timing_adj =
    FFTCP_FM // 2 - samperr`` for K4.

    A CPU tensor (or ``plain``) takes the plain version; a CUDA tensor
    launches the kernel (one thread per station)."""
    offset = state["offset"]
    if plain or offset.device.type == "cpu":
        return block_carry_plain(keep, k4_samperr, k4_angle, state, first)
    s = offset.shape[0]
    for name in FM_STATE:
        K.check(state[name], name, torch.float32 if "angle" in name
                else torch.int32, (s,))
    ins = (None, None, None)
    if not first:
        for name, t, dtype in (("keep", keep, torch.int32),
                               ("k4_samperr", k4_samperr, torch.int32),
                               ("k4_angle", k4_angle, torch.float32)):
            K.check(t, name, dtype, (s,))
        ins = (keep.data_ptr(), k4_samperr.data_ptr(), k4_angle.data_ptr())
    K.launch("block_carry", *ins,
             *(state[name].data_ptr() for name in FM_STATE), s,
             int(first), WINDOW_FM, C.FFTCP_FM // 2, device=offset.device)


def block_carry_am_plain(keep, offset) -> None:
    """Plain version of :func:`block_carry_am`."""
    offset.add_(WINDOW_AM - keep)


def block_carry_am(keep, offset) -> None:
    """K5's AM carry step, in place: ``offset += WINDOW_AM - keep`` (K12
    pass 2's keep).  The block loop has K13 take it instead.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if offset.device.type == "cpu":
        return block_carry_am_plain(keep, offset)
    s = offset.shape[0]
    K.check(offset, "offset", torch.int32, (s,))
    K.check(keep, "keep", torch.int32, (s,))
    K.launch("block_carry_am", keep.data_ptr(), offset.data_ptr(), s,
             WINDOW_AM, device=offset.device)


# ---------------------------------------------------------------------------
# the loops as CUDA graphs
# ---------------------------------------------------------------------------

def station_major(t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of a loop's block-major output ``t``
    [n_blocks, S, ...] as [S, n_blocks, ...], which a graph's next replay
    cannot overwrite.  ``transpose(0, 1).contiguous()`` is no such copy at
    one station: the view is contiguous already, and the result would be
    the graph's own buffer."""
    return t.transpose(0, 1).clone(memory_format=torch.contiguous_format)


class CapturedLoop:
    """``fn(**inputs)`` captured once as a CUDA graph on ``device``.

    ``inputs`` gives the example tensors (or arrays) whose copies become
    the graph's static inputs; ``fn`` must only read them (it may write
    the ones it carries from one replay to the next, as the AM probe's
    phase does) and returns the static outputs (tensors, or dicts and
    tuples of them), which each replay overwrites.  Calling the loop
    copies the inputs given into the static ones (those not given keep
    their values), replays the graph, adds the graph's launches to
    ``kernels.COUNTS`` and returns the static outputs."""

    def __init__(self, fn, inputs: dict, device: torch.device):
        with CAPTURE_LOCK:
            self._capture(fn, inputs, device)

    def _capture(self, fn, inputs: dict, device: torch.device):
        self.inputs = {k: torch.empty_like(torch.as_tensor(v),
                                           device=device)
                       for k, v in inputs.items()}
        self._copy(inputs)
        counts = dict(K.COUNTS)
        # warm-up on a side stream: builds every table, library and
        # cuBLAS handle the work needs before the capture
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn(**self.inputs)
        stream.wait_stream(side)
        self._copy(inputs)
        before = dict(K.COUNTS)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(**self.inputs)
        self.launches = {name: K.COUNTS[name] - before[name]
                         for name in K.COUNTS
                         if K.COUNTS[name] != before[name]}
        K.COUNTS.update(counts)

    def _copy(self, inputs: dict) -> None:
        # a copy from host memory returns once it is done, so the caller may
        # refill its buffer; a copy on the card is ordered on the stream
        for k, v in inputs.items():
            src = torch.as_tensor(v)
            self.inputs[k].copy_(src, non_blocking=src.is_cuda)

    def __call__(self, **inputs):
        self._copy(inputs)
        self.graph.replay()
        for name, n in self.launches.items():
            K.COUNTS[name] += n
        return self.outputs


# key -> CapturedLoop: the graphs of a process, kept for its life, as the
# reference's jit keeps one program per static shape
_GRAPHS: dict = {}
# held by every capture, and by other threads' device work beside it
CAPTURE_LOCK = threading.RLock()
# (key, seconds) of every capture of the process, in order
CAPTURES: list = []


def captured(key: tuple, fn, inputs: dict,
             device: torch.device) -> CapturedLoop:
    """The graph of ``key``, captured from ``fn`` and ``inputs`` on its
    first use."""
    loop = _GRAPHS.get(key)
    if loop is None:
        t0 = time.perf_counter()
        loop = _GRAPHS[key] = CapturedLoop(fn, inputs, device)
        CAPTURES.append((key, time.perf_counter() - t0))
    return loop
