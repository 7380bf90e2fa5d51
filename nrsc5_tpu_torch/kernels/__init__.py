"""Build, load, launch and count the hand-written CUDA kernels.

Each kernel has a plain C entry point (``extern "C" int <name>(...)``
returning ``cudaGetLastError()``) in ``csrc/<name>.cu``, or in the source
:data:`SOURCES` names where one file holds several kernels.  A source is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repo
root (gitignored), at first use, into a library whose file name carries a
hash of the source, of every ``csrc/`` header it includes and of the
flags: a changed source or header builds anew.  The library is loaded
with ctypes; pointers and the stream go in as ``c_void_p``.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no ``nvcc`` and no card.

``COUNTS`` holds one launch counter per kernel.  :func:`launch` adds one
where a kernel is launched and nowhere else, so a run can show that the
main path went through the kernels (``chip_smoke.py`` resets the counts
just before it drives the path and reads them just after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: no FMA contraction, so the kernels round as their plain
# PyTorch versions (separate multiplies and adds) do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# kernel name -> ctypes argument types of its C entry point
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # wire, out, taps, scale, n_in_pairs, n_out, n_stations, stream
    "halfband_cu8": (P, P, P, F, L, I, I, P),
    # samples, n_samples, offset, phase, samperr, angle, cfo, shape,
    # two_pi_over_fft, folded, phase_out, keep, n_stations, stream
    "demod_fold": (P, L, P, P, P, P, P, P, F, P, P, P, I, P),
    # refs, phase0, freq0, cfo_freq, derot, phases, ph_out, fr_out,
    # n_steps, n_tracks, alpha, beta, two_pi, stream
    "costas_track": (P, P, P, P, P, P, P, P, I, I, F, F, F, P),
    # ext, bits, margin, n_seg, n_steps, g0, g1, g2, stream
    "viterbi_k7": (P, P, P, I, I, I, I, I, P),
    # spectra, costas_phase, costas_freq, timing_adj, sync_signs,
    # needle_vals, needle_known, pm, ref_ok, ref_bc, ref_psmi, samperr,
    # angle, error_lb, error_ub, new_phase, new_freq, px1, px2, px_cols,
    # n_px1, n_px2, n_stations, ppb, alpha, beta, two_pi, pi,
    # two_pi_over_fft, stream
    "sync_block": (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                   P, I, I, I, I, F, F, F, F, F, P),
    # pm, k7_map, out, n_groups, frames_per_group, group_stride,
    # frame_stride, map_len, stream
    "fec_gather": (P, P, P, I, I, L, L, I, P),
    # bits, keep, bits_per_frame, pm, code_map, frames_per_group,
    # group_stride, frame_stride, keystream, out, errors, n_frames,
    # frame_len, packed, g0, g1, g2, stream
    "fec_epilogue": (P, P, I, P, P, I, L, L, P, P, P, I, I, I, I, I, I, P),
    # llr, internal, phase, read_idx, hazard, k7_map, ext, new_internal,
    # new_phase, n_stations, pairs, frame_len, state_len, calls, map_len,
    # stream
    "px_deinterleave": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P),
    # samples, n_samples, taps, shape_kernel, filter_delay, samperr, max_v,
    # n_stations, stream
    "coarse_timing": (P, L, P, P, I, P, P, I, P),
    # derot, needle_vals, needle_known, count, n_stations, n_cfo, n_refs,
    # stream
    "needle_count": (P, P, P, P, I, I, I, P),
    # ext, bits, margin, n_seg, n_steps, g0, g1, g2, stream
    "viterbi_k9": (P, P, P, I, I, I, I, I, P),
    # samples, n_samples, offset, phase, samperr_fb, prev_angle, cfo,
    # shape, pilot, folded, phase_out, prev_angle_out, keep, n_stations,
    # stream
    "am_fold": (P, L, P, P, P, P, P, P, P, P, P, P, P, I, P),
    # spectra, codes, pids, ref_bits, samperr, n_stations, ma3, stream
    "sync_am_block": (P, P, P, P, P, I, I, P),
    # codes, pids, lines, p1_src, p1_dly, p3_src, p3_dly, pids_src,
    # line_src, p1_out, p3_out, pids_out, lines_out, n_stations, n_frames,
    # p1_len, p3_len, pids_len, n_delayed, stream
    "am_gather": (P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                  P),
    # spectra, samples, n_samples, offset, grid_u, proj, done, f, amp,
    # n_stations, stream
    "am_tone": (P, P, L, P, P, P, P, P, P, I, P),
    # samples, n_samples, offset, f, amp, prev_angle, coarse_override,
    # shape_kernel, measured, samperr, prev_angle_out, v_max, n_stations,
    # stream
    "am_coarse": (P, L, P, P, P, P, P, P, P, P, P, P, I, P),
    # spectra, mags, step, n_stations, stream
    "am_cfo_step": (P, P, P, I, P),
    # wire, out, taps, scale, n_in_pairs, n_out, n_stations, stream
    "am_decimate_cu8": (P, P, P, F, L, I, I, P),
}
# kernel name -> the csrc/ source (without ".cu") that holds it, where that
# is not a file of the kernel's own name
SOURCES = {"am_tone": "am_coldstart", "am_coarse": "am_coldstart",
           "am_cfo_step": "am_coldstart"}

COUNTS = {name: 0 for name in SIGNATURES}
_FUNCS: dict = {}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` with no card raises:
    the port never moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    """``nvcc`` on PATH, else in the toolkit at ``$CUDA_HOME`` (by default
    the toolkit's standard install prefix)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict | None = None) -> dict:
    """``{path: bytes}`` of ``path`` and of every file it includes with
    ``#include "..."`` from its own directory, transitively."""
    seen = {} if seen is None else seen
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _INCLUDE.findall(seen[path]):
            dep = path.parent / inc.decode()
            if dep.exists():
                _sources(dep, seen)
    return seen


def source_of(name: str) -> str:
    """The csrc/ source (without ".cu") that holds kernel ``name``."""
    return SOURCES.get(name, name)


def library_path(name: str) -> Path:
    """Where the library of kernel (or source) ``name`` lies: the file name
    carries a hash of the source, the headers it includes and the flags."""
    src = source_of(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in sorted(_sources(CSRC / f"{src}.cu").items()):
        h.update(path.name.encode() + b"\0" + text)
    return BUILD / f"{src}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the sources of every kernel in ``names`` (default: all)
    whose library is missing: one ``nvcc`` per source, all started
    together, all waited for.  Returns ``{"seconds": wall, "built":
    [sources], "ptxas": {source: compiler output}}``; raises after every
    process has ended if any build failed."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in dict.fromkeys(source_of(n) for n in names):
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return {"seconds": time.perf_counter() - t0, "built": list(procs),
            "ptxas": logs}


def _func(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        fn = getattr(ctypes.CDLL(str(path)), name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def launch(name: str, *args, device: torch.device) -> None:
    """Launch kernel ``name`` on the current stream of ``device``, with
    ``device`` current (the CUDA runtime launches on, and sets kernel
    attributes for, the current device); raise if the launch was refused,
    else count it."""
    fn = _func(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
    COUNTS[name] += 1


def check(t: torch.Tensor, what: str, dtype: torch.dtype,
          shape: tuple | None = None) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, dense."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
