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

``COUNTS`` holds one launch counter per kernel.  :func:`launch` adds the
number of kernels an entry point launched (one, or two where an entry
point runs its work as two kernels in turn) and nothing anywhere else, so
a run can show that the main path went through the kernels
(``chip_smoke.py`` resets the counts just before it drives the path and
reads them just after).
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
    # two_pi_over_fft, folded (bf16), phase_out, keep, n_stations, stream
    "demod_fold": (P, L, P, P, P, P, P, P, F, P, P, P, I, P),
    # a, table, out, rows, width, stream
    "dft_bf16": (P, P, P, I, I, P),
    # spectra, cfo_freq [76], needle_vals, needle_known, count, n_stations,
    # n_fft, lb0, ub0 (each sideband's first bin), alpha, beta, two_pi,
    # stream
    "cfo_scan": (P, P, P, P, P, I, I, I, I, F, F, F, P),
    # ext, bits, margin, scratch, scratch_bytes, n_seg, n_steps, g0, g1,
    # g2, llr_int8 (ext int8, else float32), stream
    "viterbi_k7": (P, P, P, P, L, I, I, I, I, I, I, P),
    # spectra, costas_phase, costas_freq, timing_adj, sync_signs,
    # needle_vals, needle_known, pm, ref_ok, ref_bc, ref_psmi, samperr,
    # angle, error_lb, error_ub, new_phase, new_freq, px1, px2, px_cols,
    # n_px1, n_px2, n_stations, ppb, alpha, beta, two_pi, pi,
    # two_pi_over_fft, then the loop's carry step (all null: none): keep,
    # offset, prev_angle, samperr_fb, angle_fb, samperr, angle, timing_adj
    # (the next block's), window, half_fftcp; stream
    "sync_block": (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                   P, I, I, I, I, F, F, F, F, F) + (P,) * 8 + (I, I, P),
    # pm, map, aux, out, n_groups, frames_per_group, group_stride,
    # frame_stride, pm_len, map_len, aux_len, scratch (P1's deinterleaved
    # streams; none: a warp a frame), stream
    "fec_gather": (P, P, P, P, I, I, L, L, I, I, I, P, P),
    # bits, run_t, run_src, n_runs, src0, bits_per_frame, pm, inv, pm_len,
    # frames_per_group, group_stride, frame_stride, keystream words, out,
    # errors, n_frames, frame_len, packed, g0, g1, g2, stream
    "fec_epilogue": (P, P, P, I, I, I, P, P, I, I, L, L, P, P, P, I, I, I,
                     I, I, I, P),
    # llr, internal, phase, table (packed, [2, calls, 2 steps x 3 bytes]),
    # ext (int8), new_internal, new_phase, n_stations, pairs, call_len,
    # calls, map_len (3 steps), stream
    "px_deinterleave": (P, P, P, P, P, P, P, I, I, I, I, I, P),
    # samples, n_samples, taps (host), shape_kernel (host), filter_delay,
    # sums (scratch), samperr, max_v, n_stations, stream
    "coarse_timing": (P, L, P, P, I, P, P, P, I, P),
    # ext, bits, margin, scratch, scratch_bytes, n_seg, n_steps, g0, g1,
    # g2, llr_int8 (ext int8, else float32), stream
    "viterbi_k9": (P, P, P, P, L, I, I, I, I, I, I, P),
    # samples, n_samples, offset, phase, samperr_fb, prev_angle, cfo,
    # shape, pilot, folded, phase_out, prev_angle_out, keep, n_stations,
    # stream
    "am_fold": (P, L, P, P, P, P, P, P, P, P, P, P, P, I, P),
    # spectra, plan (host int32 [4, 12]), codes, pids, ref_bits, samperr,
    # n_stations, ma3, then the loop's carry step (both null: none): keep,
    # offset, window; stream
    "sync_am_block": (P, P, P, P, P, P, I, I, P, P, I, P),
    # codes, pids, map (packed, 3 bytes an entry), ml, mu, eml, emu,
    # p1_out, p3_out, pids_out (int8), ml_out, mu_out, eml_out, emu_out,
    # n_stations, n_frames, p1_len, p3_len, pids_len (a frame's),
    # n_delayed, stream
    "am_gather": (P,) * 14 + (I,) * 6 + (P,),
    # pids, map (int16 [432]), out (int8 [B, 144, 3]), n_blocks,
    # pids1_disabled, stream: K15's PIDS-only launch
    "am_gather_pids": (P, P, P, I, I, P),
    # spectra, samples, n_samples, offset, grid_u, derot, twiddle, z
    # (scratch), part (scratch), k0 (scratch), f, amp, n_stations, stream
    "am_tone": (P, P, L, P, P, P, P, P, P, P, P, P, I, P),
    # samples, n_samples, offset, f, amp, prev_angle, coarse_override,
    # shape_kernel, measured, samperr, prev_angle_out, v_max, n_stations,
    # stream
    "am_coarse": (P, L, P, P, P, P, P, P, P, P, P, P, I, P),
    # spectra, mags, step, n_stations, stream
    "am_cfo_step": (P, P, P, I, P),
    # wire, out, taps, scale, n_in_pairs, n_out, n_stations, stream
    "am_decimate_cu8": (P, P, P, F, L, I, I, P),
    # long_raw, short_raw, win_long_idx, win_short_idx, short, overlap,
    # qa_hist, lut_long, lut_short, ka, xl, new_overlap, new_qa_hist,
    # n_lanes, n_packets, stream
    "aac_window_qmf_analysis": (P,) * 13 + (I, I, P),
    # xl, tail_r, tail_i, bwj, src_idx, src_ok, xh, new_tail_r, new_tail_i,
    # n_lanes, n_packets, m, kx, eps, lpc_div, stream
    "sbr_hf_generate": (P,) * 9 + (I, I, I, I, F, F, P),
    # xh, xl, env_seg, freq_res, e_bands, q_bands, harm_act, delta_e,
    # noise_start, nlow, band_hi, band_lo, band_noise, sin_band, lim_band,
    # hi_span, lo_span, lim_span, w_hi, w_lo, noise_tab, g_hist, q_hist,
    # new_g_hist, new_q_hist, x, n_lanes, n_packets, m, kx, n_high, n_low,
    # n_q, n_lim, interpol, smooth, lim_gain, eps, g_max_cap, max_boost,
    # h_smooth[5], stream
    "sbr_hf_adjust": (P,) * 26 + (I,) * 10 + (F,) * 9 + (P,),
    # v, syn_hist, cidx, w, pcm, new_syn_hist, n_lanes, n_slots, stream
    "qmf_synthesis": (P, P, P, P, P, P, I, I, P),
    # keep, k4_samperr, k4_angle, offset, prev_angle, samperr_fb, angle_fb,
    # samperr, angle, timing_adj, n_stations, first, window, half_fftcp,
    # stream
    "block_carry": (P,) * 10 + (I, I, I, I, P),
    # keep, offset, n_stations, window, stream
    "block_carry_am": (P, P, I, I, P),
    # the complex chain's block step, K17-K20:
    # samples (complex64), n_samples, offset, phase (complex64), samperr,
    # angle, cfo, shape, twiddle (complex64 [1024]), two_pi_over_fft,
    # spectra (complex64), phase_out, keep, n_stations, stream
    "fm_demod_c": (P, L, P, P, P, P, P, P, P, F, P, P, P, I, P),
    # samples (complex64), n_samples, offset, phase (complex64), samperr,
    # prev_angle, cfo, shape, twiddle (complex64 [128]), two_pi, spectra
    # (complex64), mag_sums, phase_out, prev_angle_out, keep, n_stations,
    # stream
    "am_demod_c": (P, L, P, P, P, P, P, P, P, F, P, P, P, P, P, I, P),
    # spectra (complex64), plan (host int32 [4, 12], K13's), codes, pids,
    # ref_bits, samperr, n_stations, ma3, then the loop's carry step (all
    # null: none): keep, offset, samperr_next, window, half_fftcp; stream
    "sync_am_c": (P, P, P, P, P, P, I, I, P, P, P, I, I, P),
}
# K18 takes sync_block's arguments: the kernel is K4's with the complex
# chain's phase detector
SIGNATURES["sync_fm_c"] = SIGNATURES["sync_block"]
# kernel name -> the csrc/ source (without ".cu") that holds it, where that
# is not a file of the kernel's own name
SOURCES = {"am_tone": "am_coldstart", "am_coarse": "am_coldstart",
           "am_cfo_step": "am_coldstart", "block_carry_am": "block_carry",
           "am_gather_pids": "am_gather"}

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


def _func(name: str, symbol: str | None = None, argtypes=None,
          restype=ctypes.c_int):
    """Entry point ``symbol`` (default: the kernel's own) of the library
    that holds kernel ``name``, built at first use."""
    symbol = symbol or name
    fn = _FUNCS.get(symbol)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = SIGNATURES[name] if argtypes is None else argtypes
        fn.restype = restype
        _FUNCS[symbol] = fn
    return fn


def query(name: str, symbol: str, *args: int) -> int:
    """Call ``symbol``, a host function in the library of kernel ``name``
    (``extern "C" long long symbol(int, ...)``) that answers what a launch
    needs before the wrapper allocates for it.  Counts nothing."""
    return _func(name, symbol, (I,) * len(args), L)(*args)


def launch(name: str, *args, device: torch.device, kernels: int = 1) -> None:
    """Launch kernel ``name`` on the current stream of ``device``, with
    ``device`` current (the CUDA runtime launches on, and sets kernel
    attributes for, the current device); raise if the launch was refused,
    else count the ``kernels`` the entry point launched for these
    arguments."""
    fn = _func(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
    COUNTS[name] += kernels


def into(out, result):
    """Copy ``result`` (a tensor, or a tuple or dict of tensors) into the
    preallocated ``out`` of the same structure and return ``out``: how a
    wrapper given ``out=`` hands back its plain version's result."""
    if isinstance(out, torch.Tensor):
        out.copy_(result)
    elif isinstance(out, dict):
        for key, dst in out.items():
            into(dst, result[key])
    else:
        for dst, src in zip(out, result, strict=True):
            into(dst, src)
    return out


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
