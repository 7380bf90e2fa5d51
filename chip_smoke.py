#!/usr/bin/env python3
"""Drive the PyTorch port's FM and AM receive chains on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
``nvcc``.  It imports nothing of JAX or of the JAX package ``nrsc5_tpu``.
Phases, each printing one JSON line:

1. device: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. build: the eighteen hand kernels (K1 and its AM cascade, K2, K3, K4,
   K6, K7 at K=7 and at K=9, K8, K9, the needle count of K10, K11, K12,
   K13, K14's tone estimate, coarse timing and CFO step, K15) built from
   the sixteen sources of ``nrsc5_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one process per source, all in parallel;
3. signal: 16 stations of MP1, each modulated once with the port's ``tx``
   copy from random bits of a fixed seed: 2 lead blocks (block counts 14
   and 15), then 2 P1 frames.  From that one baseband come two cu8 wires
   at 1.488 MS/s with AWGN at 25 dB: the steady wire (the 2 frames,
   frame-aligned) and the cold-start capture (all 34 blocks behind a
   timing offset of 1000-3999 samples, with an integer CFO of ±1..±12
   bins, both signs present, plus a fractional part within ±60 Hz).  And
   16 stations of MP3 (psmi 3): 96 frame-aligned blocks of P1, PIDS and 3
   interleaver-IV cycles of PX1 as one cu8 queue each at 25 dB, plus 3
   blocks of MP2 and of MP11 as chain input for K4's lines.  And 16 AM
   stations of MA1: 6 frame-aligned frames of P1, P3 and PIDS each at 35
   dB AWGN with a fractional CFO within ±10 Hz, as one cs16 queue at
   46511.7 S/s, plus 2 frames of MA3 as chain input for the MA3 kernel
   lines.  And the AM cold-start capture: 8 MA1 and 8 MA3 stations of 12
   frames each behind a timing offset of 300-4000 samples, with an integer
   CFO of -2, -1, +1 or +2 bins plus a fractional part within ±40 Hz, two
   stations of each mode through a 0.5 echo at delay 14, 30 dB AWGN, cs16
   at 0.1 of full scale.  And 2 frames of MA1 a station as a 1.488 MS/s cu8
   AM wire (Fourier-upsampled ×32, 217 history pairs ahead);
4. one line per kernel: the kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it, with times (K4 also at
   psmi 2, 3 and 11, K6 and K8 at P1's and PIDS's shapes, K8 at PX's,
   K11 at MP3's and MP2's; the AM kernels K12 in both passes, K13 and K15
   in MA1 and MA3, K7 at K=9 on P1, P3 of MA1 and MA3 and PIDS, and K8
   on the AM P1; K14's three kernels at the AM cold start's first probe
   block, K1's AM cascade on the cu8 AM wire);
5. coldstart: ``serve.cold_start`` on the capture must lock 16/16 stations
   with the true |CFO| under one sign convention, first_bc 14 and psmi 1;
   then ``serve.chain_step`` from the locks over 34 blocks must decode
   every P1 frame and PIDS word bit-exact, and the same path through the
   plain versions the same locks and bits.  Launch counts of the cold start
   and of that dispatch, and the cold start's wall time;
6. slice: ``serve.chain_step`` on the steady wire — launch counts taken
   from that one dispatch, every P1 frame and PIDS word held bit-exact
   against the transmitted bits, wall time per dispatch and real-time
   factor, a stage breakdown, one block's pieces timed alone, the device's
   busy time from the profiler, and the same dispatch through the plain
   versions, which must decode the same bits;
7. mp3: three ``serve.chain_step`` dispatches of 32 blocks on the MP3
   queues, the carry (interleaver-IV state included) handed from one to
   the next and each queue advanced by what its station consumed.  Gate:
   all 96 P1 frames, 1536 PIDS words and the 512 PX1 frames of IV cycles 1
   and 2 bit-exact at their pair positions; the launch counts of the three
   dispatches exactly those of K1, K2, K4, K6, K7, K8 and K11 on that path,
   and no plain version called; the same dispatches through the plain
   versions the same outputs (bits, margins, bit errors) and the same final
   IV state and phases.  Wall per dispatch,
   real-time factor (at least 1), stage split, device busy time;
8. am: three ``serve.chain_step_am`` dispatches of 2 frames on the AM
   queues from a fresh carry, the carry (delay lines included) handed on
   and each queue advanced by what its station consumed.  Gate: every P1
   subframe and P3 frame of frames 3-5 (384 and 48; frames 0-2 are the
   diversity warm-up) and all 768 PIDS words bit-exact; the launch counts
   of each dispatch exactly K12 32, K13 16, K15 1, K7 at K=9 3 and K8 3,
   and no plain version called; the same dispatches through the plain
   versions the same bits, margins and final delay lines.  Wall per
   dispatch, real-time factor, stage split, device busy time;
9. am_coldstart: ``serve.cold_start(mode="am")`` on the cold-start capture
   must lock 16/16 stations at their true integer CFO, mode and psmi, each
   probe block launching exactly K14's tone 1, coarse 1 and CFO step 1,
   K12 2 and K13 1, with no plain version called.  Then per mode,
   ``serve.carry_from_locks`` and three ``serve.chain_step_am`` dispatches
   of 2 frames from the locks, the carry handed on and each queue advanced
   by what its station consumed: every P1 subframe and P3 frame of frames
   3-5 counted from the lock and every PIDS word bit-exact.  The plain
   versions must give the same locks and bits.  The cold start's wall time,
   probe blocks, launches per probe block and device busy time;
10. am_cu8: ``serve.ingest`` of the cu8 AM wire launches K1's AM cascade
   once, and each station's output correlates with its baseband above
   0.85 (the reference's own bound for this cascade).

Then the ``nvidia-smi`` line, a ``{"kernels": [...]}`` line (``launches``:
the sum over the paths driven, itemised under ``launches_by_path``) and,
last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
with no CUDA card it exits 2 before printing anything.
"""

from __future__ import annotations

import cProfile
import json
import multiprocessing
import os
import pstats
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

N_STATIONS = 16
N_FRAMES = 2
MP3_PSMI = 3
MP3_DISPATCHES = 3  # of 32 blocks each: one IV cycle and 2 P1 frames
DISPATCH_BLOCKS = 32
LEAD = 2  # lead blocks (bc 14, 15) ahead of the frames in the capture
SNR_DB = 25.0
SEED = 0x5EED
AM_FRAMES = 2  # frames per AM dispatch (the reference serve's default)
AM_DISPATCHES = 3
AM_SNR_DB = 35.0
AM_CFO_HZ = 10.0  # fractional CFOs within ±AM_CFO_HZ
AM_RMS = 0.1  # the cs16 wire's rms, of full scale
AM_COLD_FRAMES = 12  # frames of each station's cold-start capture
AM_COLD_SNR_DB = 30.0
AM_COLD_CFO_HZ = 40.0  # fractional CFOs within ±AM_COLD_CFO_HZ
AM_COLD_MAX_OFFSET = 4000
AM_COLD_ECHO = (14, 0.5, 2.0)  # delay (the cyclic prefix), amplitude, phase
AM_CU8_SCALE = 0.05  # the cu8 AM signal's modulator scale (no clipping)
# the card's published peaks (NVIDIA H100 SXM data sheet) for bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# kernel name -> (source, the JAX function it replaces)
KERNELS = {
    "halfband_cu8": ("nrsc5_tpu_torch/csrc/halfband_cu8.cu",
                     "nrsc5_tpu/ops/frontend.py:120"),
    "demod_fold": ("nrsc5_tpu_torch/csrc/demod_fold.cu",
                   "nrsc5_tpu/ops/acquire_rc.py:73"),
    "costas_track": ("nrsc5_tpu_torch/csrc/costas_track.cu",
                     "nrsc5_tpu/pipeline/scan_chain_rc.py:107"),
    "viterbi_k7": ("nrsc5_tpu_torch/csrc/viterbi_k7.cu",
                   "nrsc5_tpu/ops/convolutional.py:154"),
    "sync_block": ("nrsc5_tpu_torch/csrc/sync_block.cu",
                   "nrsc5_tpu/pipeline/scan_chain_rc.py:128"),
    "coarse_timing": ("nrsc5_tpu_torch/csrc/coarse_timing.cu",
                      "nrsc5_tpu/ops/acquire_rc.py:43"),
    "needle_count": ("nrsc5_tpu_torch/csrc/needle_count.cu",
                     "nrsc5_tpu/ops/acquire_rc.py:123"),
    "fec_gather": ("nrsc5_tpu_torch/csrc/fec_gather.cu",
                   "nrsc5_tpu/ops/decode_fm.py:64"),
    "fec_epilogue": ("nrsc5_tpu_torch/csrc/fec_epilogue.cu",
                     "nrsc5_tpu/ops/convolutional.py:511"),
    "px_deinterleave": ("nrsc5_tpu_torch/csrc/px_deinterleave.cu",
                        "nrsc5_tpu/ops/decode_fm.py:106"),
    "viterbi_k9": ("nrsc5_tpu_torch/csrc/viterbi_k9.cu",
                   "nrsc5_tpu/ops/convolutional.py:154"),
    "am_fold": ("nrsc5_tpu_torch/csrc/am_fold.cu",
                "nrsc5_tpu/pipeline/scan_chain_am_rc.py:84"),
    "sync_am_block": ("nrsc5_tpu_torch/csrc/sync_am_block.cu",
                      "nrsc5_tpu/pipeline/scan_chain_am_rc.py:143"),
    "am_gather": ("nrsc5_tpu_torch/csrc/am_gather.cu",
                  "nrsc5_tpu/ops/decode_am.py:86"),
    "am_tone": ("nrsc5_tpu_torch/csrc/am_coldstart.cu",
                "nrsc5_tpu/pipeline/scan_chain_am_rc.py:350"),
    "am_coarse": ("nrsc5_tpu_torch/csrc/am_coldstart.cu",
                  "nrsc5_tpu/pipeline/scan_chain_am_rc.py:404"),
    "am_cfo_step": ("nrsc5_tpu_torch/csrc/am_coldstart.cu",
                    "nrsc5_tpu/pipeline/scan_chain_am_rc.py:106"),
    "am_decimate_cu8": ("nrsc5_tpu_torch/csrc/am_decimate_cu8.cu",
                        "nrsc5_tpu/ops/frontend.py:154"),
}
# the kernels each path launches
STEADY = ("halfband_cu8", "demod_fold", "sync_block", "fec_gather",
          "viterbi_k7", "fec_epilogue")
COLD_START = ("halfband_cu8", "demod_fold", "costas_track", "sync_block",
              "coarse_timing", "needle_count")
# launches of one MP3 dispatch of 32 blocks: K1 once, K2 and K4 per block,
# K6 for P1 and PIDS, K7 and K8 for P1, PIDS and PX1, K11 once
MP3_LAUNCHES = {"halfband_cu8": 1, "demod_fold": 32, "sync_block": 32,
                "fec_gather": 2, "viterbi_k7": 3, "fec_epilogue": 3,
                "px_deinterleave": 1}
# launches of one AM dispatch of 2 frames (16 blocks): K12 twice a block,
# K13 once a block, K15 once, K7 at K=9 and K8 for P1, P3 and PIDS
AM_LAUNCHES = {"am_fold": 32, "sync_am_block": 16, "am_gather": 1,
               "viterbi_k9": 3, "fec_epilogue": 3}
# launches of one AM cold-start probe block: K14's three kernels once,
# K12 in both passes, K13 once
AM_PROBE_LAUNCHES = {"am_tone": 1, "am_coarse": 1, "am_fold": 2,
                     "am_cfo_step": 1, "sync_am_block": 1}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int = 7, inner: int = 10,
            graph: bool = False) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events, after two warm calls.  ``graph=True`` captures
    the ``inner`` calls into a CUDA graph and times its replay: the device
    time of the work, without the host's launch cost, which exceeds the
    run time of a small kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def profile_device(torch, fn) -> dict:
    """Device busy time of one call of ``fn``: the sum of the kernel, copy
    and set spans the profiler records on the card (one stream, no
    overlap), against the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in spans) / 1e3
    by_name = {}
    for e in spans:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"spans": len(spans), "busy_ms": busy, "wall_ms": wall,
            "idle_share": 1 - busy / wall if spans else None,
            "top_ms": [[n[:80], t] for n, t in top]}


def count_plain_calls() -> tuple[dict, callable]:
    """Wrap every ``*_plain`` function that a module of the port holds
    with a call counter.  Returns (counts by name, a function that puts
    the originals back).  A run through the kernels must leave the counts
    empty: the wrappers take a plain version only for a CPU tensor."""
    counts, undo = {}, []
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("nrsc5_tpu_torch"):
            continue
        for name, fn in list(vars(mod).items()):
            if not (name.endswith("_plain") and callable(fn)):
                continue

            def counted(*a, _fn=fn, _name=name, **k):
                counts[_name] = counts.get(_name, 0) + 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
            undo.append((mod, name, fn))

    def restore():
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    return counts, restore


def capture_len() -> int:
    """Chain samples of a station's cold-start capture: the chain's buffer
    for all its blocks past the largest timing offset."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len
    return buffer_len(LEAD + N_FRAMES * C.P1_FM_BLOCKS) + 2 * C.FFTCP_FM


def make_station(index: int) -> dict:
    """Station ``index``, from its own seed: one MP1 baseband of LEAD lead
    blocks and N_FRAMES P1 frames, cut into the steady wire (the frames,
    frame-aligned) and impaired into the cold-start capture.  Returns the
    two cu8 queues and the transmitted bits: p1 [F, 146176], pids
    [LEAD + 16F, 80] (the lead blocks' words first), and the capture's
    timing offset and CFO."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
    from nrsc5_tpu_torch.tx.modulator import modulate_fm

    rng = np.random.default_rng([SEED, index])
    blk, fftcp = C.P1_FM_BLOCKS, C.FFTCP_FM
    n_blocks = N_FRAMES * blk
    p1 = rng.integers(0, 2, (N_FRAMES, C.P1_FRAME_LEN_FM), dtype=np.uint8)
    pids = rng.integers(0, 2, (LEAD + n_blocks, C.PIDS_FRAME_LEN),
                        dtype=np.uint8)
    lead_frame = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM, dtype=np.uint8),
        np.concatenate([np.zeros((blk - LEAD, C.PIDS_FRAME_LEN), np.uint8),
                        pids[:LEAD]]))
    matrix = np.concatenate(
        [lead_frame[(blk - LEAD) * C.BLKSZ:]]
        + [build_pm_matrix(p1[f], pids[LEAD + blk * f:LEAD + blk * (f + 1)])
           for f in range(N_FRAMES)])
    bc_seq = np.r_[np.arange(blk - LEAD, blk), np.tile(np.arange(blk),
                                                        N_FRAMES)]
    clean = modulate_fm(matrix, bc_seq, 1)

    # steady: the frames; the stream starts FFTCP//2 samples before the
    # first symbol and runs a few samples past what the dispatch reads
    sig = ch.impair(clean[LEAD * C.BLKSZ * fftcp:], snr_db=SNR_DB, rng=rng)
    buf = np.zeros(buffer_len(n_blocks) + 8, np.complex64)
    buf[fftcp // 2:fftcp // 2 + len(sig)] = sig
    steady = serve.stream_wire(ch.to_cu8(ch.upsample2(buf)))
    steady = steady[:serve.wire_pairs(n_blocks)]

    # cold start: all blocks, behind the offset, shifted by the CFO
    n_cap = capture_len()
    offset = int(rng.integers(1000, 4000))
    cfo_bins = int(rng.integers(1, 13)) * (1 if index % 2 else -1)
    cfo_hz = cfo_bins * C.SAMPLE_RATE_CS16_FM / C.FFT_FM \
        + float(rng.uniform(-60.0, 60.0))
    buf = np.zeros(n_cap + 8, np.complex64)
    buf[fftcp // 2:fftcp // 2 + len(clean)] = clean
    noisy = ch.impair(buf, sample_offset=offset, cfo_hz=cfo_hz,
                      snr_db=SNR_DB, rng=rng)[:n_cap + 8]
    capture = serve.stream_wire(ch.to_cu8(ch.upsample2(noisy)))
    capture = capture[:FE.rc_overlap(1) + 2 * n_cap]
    return {"steady": steady, "capture": capture, "p1": p1, "pids": pids,
            "offset": offset, "cfo_bins": cfo_bins, "cfo_hz": cfo_hz}


def make_mp3_station(index: int) -> dict:
    """MP3 station ``index``, from its own seed: MP3_DISPATCHES × 32
    frame-aligned blocks of random P1 frames, PIDS words and PX1 frames
    (one interleaver-IV cycle of 16 frames per 32 blocks), at 25 dB, as one
    cu8 queue with room for the offset walk; and 3 blocks each of MP2 and
    MP11 (PX partitions filled) as conjugated rc chain input, for K4's
    kernel lines.  Returns the queue, the rc captures and the transmitted
    bits: p1 [6, 146176], pids [96, 80], px1 [3, 16, 4608]."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len, px_frame_lens
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix, build_px_stream
    from nrsc5_tpu_torch.tx.modulator import modulate_fm

    rng = np.random.default_rng([SEED, MP3_PSMI, index])
    n_blocks = MP3_DISPATCHES * DISPATCH_BLOCKS
    n_frames = n_blocks // C.P1_FM_BLOCKS
    fl = C.P3_FRAME_LEN_MP3_MP11
    p1 = rng.integers(0, 2, (n_frames, C.P1_FRAME_LEN_FM), dtype=np.uint8)
    pids = rng.integers(0, 2, (n_blocks, C.PIDS_FRAME_LEN), dtype=np.uint8)
    px1 = rng.integers(0, 2, (MP3_DISPATCHES, 16, fl), dtype=np.uint8)
    matrix = np.concatenate([build_pm_matrix(p1[f], pids[16 * f:16 * f + 16])
                             for f in range(n_frames)])
    bc_seq = np.tile(np.arange(C.P1_FM_BLOCKS), n_frames)
    sig = modulate_fm(matrix, bc_seq, MP3_PSMI, px1_signs=build_px_stream(
        px1, fl).reshape(n_blocks * C.BLKSZ, -1))
    sig = ch.impair(sig, snr_db=SNR_DB, rng=rng)
    buf = np.zeros(buffer_len(n_blocks) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    out = {"queue": serve.stream_wire(ch.to_cu8(ch.upsample2(buf))),
           "p1": p1, "pids": pids, "px1": px1}
    for psmi in (2, 11):
        signs = {f"{k}_signs": rng.choice([-1, 1], (3 * C.BLKSZ, f // 32))
                 .astype(np.int8) for k, f in zip(("px1", "px2"),
                                                  px_frame_lens(psmi)) if f}
        sig = ch.impair(modulate_fm(matrix[:3 * C.BLKSZ], bc_seq[:3], psmi,
                                    **signs), snr_db=SNR_DB, rng=rng)
        rc = np.zeros((buffer_len(2) + 8, 2), np.float32)
        rc[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = np.stack(
            [sig.real, -sig.imag], -1)[:len(rc) - C.FFTCP_FM // 2]
        out[f"rc_psmi{psmi}"] = rc
    return out


def am_queue_len() -> int:
    """cs16 pairs of an AM station's queue: the chain's buffer for all
    dispatches' frames, with room for the offset walk."""
    from nrsc5_tpu_torch.pipeline.scan_chain_am import SLACK_AM, am_buffer_len
    return am_buffer_len(AM_DISPATCHES * AM_FRAMES) + 2 * SLACK_AM


def _am_frames(rng, ma3: bool, n_frames: int, scale: float = 0.02):
    """``n_frames`` frames of random P1, P3 and PIDS of one AM station,
    modulated with the port's ``tx`` copy (bc 0 first).  Returns the
    complex64 baseband and the bits."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import encoder_am as EAM
    from nrsc5_tpu_torch.tx.modulator_am import modulate_am

    p3_len = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    p1 = rng.integers(0, 2, (n_frames, 8, C.P1_FRAME_LEN_AM), dtype=np.uint8)
    p3 = rng.integers(0, 2, (n_frames, p3_len), dtype=np.uint8)
    pids = rng.integers(0, 2, (8 * n_frames, C.PIDS_FRAME_LEN),
                        dtype=np.uint8)
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(p1[f]) for f in range(n_frames)],
        [EAM.encode_p3_am(p3[f], ma3) for f in range(n_frames)], ma3)
    ref = np.stack([EAM.am_ref_bits(b % 8, 2 if ma3 else 1)
                    for b in range(8 * n_frames)])
    sig = modulate_am(mats, np.stack([EAM.encode_pids_am(w) for w in pids]),
                      ref, ma3, scale=scale)
    return sig, p1, p3, pids


def _cs16(buf: np.ndarray) -> np.ndarray:
    """complex64 -> an int16 [n, 2] wire at AM_RMS of full scale."""
    buf = buf * (AM_RMS / np.sqrt(np.mean(np.abs(buf) ** 2)))
    iq = np.stack([buf.real, buf.imag], -1) * 32768
    return np.clip(np.round(iq), -32768, 32767).astype(np.int16)


def _am_signal(rng, ma3: bool, n_frames: int, n_out: int):
    """``n_frames`` frames of random P1, P3 and PIDS of one AM station at
    AM_SNR_DB with a fractional CFO, frame-aligned (the first symbol
    FFTCP_AM // 2 in, bc 0 first) in a buffer of ``n_out`` samples, scaled
    to AM_RMS of full scale and quantized to cs16.  Returns the int16
    [n_out, 2] wire, the bits and the CFO."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch

    sig, p1, p3, pids = _am_frames(rng, ma3, n_frames)
    cfo_hz = float(rng.uniform(-AM_CFO_HZ, AM_CFO_HZ))
    buf = np.zeros(n_out, np.complex64)
    start = C.FFTCP_AM // 2
    buf[start:start + len(sig)] = sig[:n_out - start]
    buf = ch.impair(buf, cfo_hz=cfo_hz, snr_db=AM_SNR_DB,
                    sample_rate=C.SAMPLE_RATE_CS16_AM, rng=rng)
    return _cs16(buf), p1, p3, pids, cfo_hz


def make_am_station(index: int) -> dict:
    """AM station ``index``, from its own seed: the MA1 queue of
    AM_DISPATCHES × AM_FRAMES frames and its bits (p1 [6, 8, 3750], p3
    [6, 24000], pids [48, 80]), and 2 frames of MA3 as cs16 chain input
    for the MA3 kernel lines."""
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len
    rng = np.random.default_rng([SEED, 0xA3, index])
    queue, p1, p3, pids, cfo = _am_signal(
        rng, False, AM_DISPATCHES * AM_FRAMES, am_queue_len())
    ma3, *_ = _am_signal(rng, True, AM_FRAMES, am_buffer_len(AM_FRAMES))
    return {"queue": queue, "p1": p1, "p3": p3, "pids": pids,
            "cfo_hz": cfo, "ma3_wire": ma3}


def am_cold_len() -> int:
    """cs16 pairs of a station's AM cold-start capture: the chain's buffer
    for all its frames past the largest timing offset."""
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len
    return am_buffer_len(AM_COLD_FRAMES) + AM_COLD_MAX_OFFSET


def make_am_cold_station(index: int) -> dict:
    """AM cold-start station ``index``, from its own seed: MA1 for 0-7,
    MA3 for 8-15; AM_COLD_FRAMES frames behind a timing offset of
    300-AM_COLD_MAX_OFFSET samples, an integer CFO of -2, -1, +1 or +2
    bins (by index) plus a fractional part within ±AM_COLD_CFO_HZ, a 0.5
    echo at delay 14 for stations 0, 1, 8 and 9, AWGN at AM_COLD_SNR_DB,
    cs16.  Returns the int16 [am_cold_len(), 2] capture, the bits (p3
    zero-padded to MA3's frame length) and the impairments."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch

    rng = np.random.default_rng([SEED, 0xC0, index])
    ma3 = index >= N_STATIONS // 2
    echo = index % (N_STATIONS // 2) < 2
    sig, p1, p3, pids = _am_frames(rng, ma3, AM_COLD_FRAMES)
    if echo:
        delay, amp, phase = AM_COLD_ECHO
        sig = ch.multipath(sig, delay, amp, phase=phase)
    offset = int(rng.integers(300, AM_COLD_MAX_OFFSET))
    cfo_bins = (-2, -1, 1, 2)[index % 4]
    cfo_hz = cfo_bins * C.SAMPLE_RATE_CS16_AM / C.FFT_AM \
        + float(rng.uniform(-AM_COLD_CFO_HZ, AM_COLD_CFO_HZ))
    buf = np.zeros(am_cold_len(), np.complex64)
    buf[offset:offset + len(sig)] = sig
    buf = ch.impair(buf, cfo_hz=cfo_hz, snr_db=AM_COLD_SNR_DB,
                    sample_rate=C.SAMPLE_RATE_CS16_AM, rng=rng)
    p3_full = np.zeros((AM_COLD_FRAMES, C.P3_FRAME_LEN_MA3), np.uint8)
    p3_full[:, :p3.shape[1]] = p3
    return {"wire": _cs16(buf), "p1": p1, "p3": p3_full,
            "p3_len": p3.shape[1], "pids": pids, "ma3": ma3, "echo": echo,
            "offset": offset, "cfo_bins": cfo_bins, "cfo_hz": cfo_hz}


def make_am_cu8_station(index: int) -> dict:
    """AM cu8 station ``index``, from its own seed: 2 frames of MA1 at
    modulator scale AM_CU8_SCALE in a buffer of am_buffer_len(2) samples,
    Fourier-upsampled ×32 to 1.488 MS/s, quantized to cu8 and queued
    behind the 217 history pairs of the ÷32 cascade.  Returns the wire
    (one 2-frame dispatch, [434 + 32 am_buffer_len(2), 2]) and the
    baseband as rc float32."""
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len
    from nrsc5_tpu_torch.tx import channel as ch

    rng = np.random.default_rng([SEED, 0xC8, index])
    sig, *_ = _am_frames(rng, False, AM_FRAMES, scale=AM_CU8_SCALE)
    n = am_buffer_len(AM_FRAMES)
    # 8 chain samples of lookahead cover the cascade's 217 pairs past n
    buf = np.zeros(n + 8, np.complex64)
    buf[:len(sig)] = sig
    wire = serve.stream_wire(ch.to_cu8(ch.upsample_exact(buf, 32)),
                             FE.AM_STAGES)
    return {"wire": wire[:FE.rc_overlap(FE.AM_STAGES) + 32 * n],
            "baseband": np.stack([buf.real, buf.imag], -1)[:n]}


def make_fleet(station=make_station) -> dict:
    """Every station, built in parallel by spawned worker processes (numpy
    only; the pool ends with the call)."""
    workers = min(N_STATIONS, os.cpu_count() or 1)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        stations = list(pool.map(station, range(N_STATIONS)))
    return {k: np.stack([st[k] for st in stations]) for k in stations[0]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops import acquire_am_rc as AA
    from nrsc5_tpu_torch.ops import acquire_rc as AQ
    from nrsc5_tpu_torch.ops import convolutional as CV
    from nrsc5_tpu_torch.ops import costas as CO
    from nrsc5_tpu_torch.ops import detect_cfo as DC
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.ops import interleavers as IL
    from nrsc5_tpu_torch.ops import rcplx as rc
    from nrsc5_tpu_torch.ops import sync_fm as SF
    from nrsc5_tpu_torch.ops import decode_fm as DF
    from nrsc5_tpu_torch.ops.bits import unpack_bits
    from nrsc5_tpu_torch.ops import decode_am as DA
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
    from nrsc5_tpu_torch.pipeline.scan_chain import iv_state_len
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len

    # full float32 for every float32 matmul and convolution (the DFT and
    # the conv1d yardstick); TF32 would keep ~3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = K.build()
    # registers, shared memory and stack of each kernel and of the
    # subroutines it calls (the slow paths of sinf, cosf, atan2f, division)
    regs = {n: [ln.strip() for ln in log.splitlines()
                if any(w in ln for w in ("registers", "Function properties",
                                         "stack frame"))]
            for n, log in built["ptxas"].items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": list(K.SIGNATURES), "built": built["built"],
          "ptxas": regs})

    n_blocks = N_FRAMES * C.P1_FM_BLOCKS
    t0 = time.perf_counter()
    fleet = make_fleet()
    t1 = time.perf_counter()
    mp3 = make_fleet(make_mp3_station)
    t2 = time.perf_counter()
    am = make_fleet(make_am_station)
    t3 = time.perf_counter()
    am_cold = make_fleet(make_am_cold_station)
    t4 = time.perf_counter()
    am_cu8 = make_fleet(make_am_cu8_station)
    emit({"phase": "signal", "seconds": round(t1 - t0, 3),
          "mp3_seconds": round(t2 - t1, 3),
          "am_seconds": round(t3 - t2, 3),
          "am_cold_seconds": round(t4 - t3, 3),
          "am_cu8_seconds": round(time.perf_counter() - t4, 3),
          "am_cold_bytes": int(am_cold["wire"].nbytes),
          "am_cold_offsets": am_cold["offset"].tolist(),
          "am_cold_cfo_hz": am_cold["cfo_hz"].tolist(),
          "am_cold_ma3": am_cold["ma3"].tolist(),
          "am_cold_echo": am_cold["echo"].tolist(),
          "am_cu8_bytes": int(am_cu8["wire"].nbytes),
          "mp3_queue_bytes": int(mp3["queue"].nbytes),
          "am_queue_bytes": int(am["queue"].nbytes),
          "am_cfo_hz": am["cfo_hz"].tolist(),
          "stations": N_STATIONS, "blocks": n_blocks,
          "capture_blocks": LEAD + n_blocks,
          "wire_bytes": int(fleet["steady"].nbytes),
          "capture_bytes": int(fleet["capture"].nbytes),
          "offsets": fleet["offset"].tolist(),
          "cfo_bins": fleet["cfo_bins"].tolist(),
          "cfo_hz": fleet["cfo_hz"].tolist()})
    wire = torch.from_numpy(fleet["steady"]).to(dev)
    capture = torch.from_numpy(fleet["capture"]).to(dev)
    p1_tx, pids_all = fleet["p1"], fleet["pids"]
    pids_tx = pids_all[:, LEAD:]
    s_n, n_in, _ = wire.shape
    report = {}

    def check(name, err, tol, kernel, plain, bnd, library, shape,
              plain_reps=7, plain_inner=10, ok=None, case=None, **extra):
        """Hold a kernel against its plain version and time both (and the
        library call, if any) as CUDA graphs: device time per call.
        ``launched_ms`` also times the kernel launched from Python.  ``ok``
        overrides ``err <= tol`` where a kernel's outputs carry several
        tolerances (``extra`` records them).  ``case`` names a further
        shape or mode of a kernel already reported: its line goes into the
        kernel's row under ``cases``."""
        ok = err <= tol if ok is None else ok
        row = {"name": name, "route": "cuda", "source": KERNELS[name][0],
               "replaces": KERNELS[name][1], "launches": None,
               "max_abs_err": err, "tolerance": tol, **extra,
               "ms": time_ms(torch, kernel, graph=True),
               "plain_ms": time_ms(torch, plain, reps=plain_reps,
                                   inner=plain_inner, graph=True),
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "library_ms": (None if library is None
                              else time_ms(torch, library, graph=True)),
               "launched_ms": time_ms(torch, kernel), "shape": shape}
        if case is None:
            report[name] = row
        else:
            report[name].setdefault("cases", {})[case] = {
                k: v for k, v in row.items()
                if k not in ("name", "route", "source", "replaces",
                             "launches")}
        emit({"phase": "kernel", **row, "case": case, "pass": ok})
        if not ok:
            raise AssertionError(f"{name} {case or ''}: kernel and plain "
                                 f"version differ beyond their tolerances "
                                 f"({row})")

    # --- K1: cu8 ingest + halfband (bit-identical: no FMA, same order) ---
    got = FE.ingest_fm_cu8(wire)
    want = FE.ingest_fm_cu8_plain(wire)
    n_out = got.shape[1]
    err = (got - want).abs().max().item()
    x = FE.cu8_to_rc(wire, conj=True)  # conv1d's float input, not timed
    xc = x.permute(0, 2, 1).reshape(-1, 1, n_in).contiguous()
    taps = torch.from_numpy(FE.halfband_taps()).to(dev).view(1, 1, -1)
    check("halfband_cu8", err, 1e-6,
          lambda: FE.ingest_fm_cu8(wire),
          lambda: FE.ingest_fm_cu8_plain(wire),
          bound(s_n * n_in * 2 + s_n * n_out * 8,
                s_n * n_out * 2 * 17 + s_n * n_in * 2 * 2),
          lambda: torch.nn.functional.conv1d(xc, taps, stride=2),
          [s_n, n_in, 2])
    samples = got

    # --- K2: demod fold, at block 0 of the chain with per-station state
    # moved off the trivial values (CFO -3..3, samperr 1078..1082) ---
    g = torch.Generator(device="cpu").manual_seed(SEED)
    offset = torch.randint(0, 3 * C.FFTCP_FM, (s_n,), generator=g,
                           dtype=torch.int32).to(dev)
    ang = torch.rand(s_n, generator=g) * 2 * np.pi
    phase = torch.stack([torch.cos(ang), torch.sin(ang)], -1).to(dev)
    samperr = (1078 + torch.randint(0, 5, (s_n,), generator=g,
                                    dtype=torch.int32)).to(dev)
    angle = ((torch.rand(s_n, generator=g) - 0.5) * 0.02).to(dev)
    cfo = torch.randint(-3, 4, (s_n,), generator=g,
                        dtype=torch.int32).to(dev)
    args = (samples, offset, phase, samperr, angle, cfo)
    got = AQ.demod_fold(*args)
    want = AQ.demod_fold_plain(*args)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    n_samp = AQ.NSAMP
    check("demod_fold", err, 1e-5,
          lambda: AQ.demod_fold(*args),
          lambda: AQ.demod_fold_plain(*args),
          bound(s_n * (n_samp * 8 + C.BLKSZ * C.FFT_FM * 8 + 40),
                s_n * (n_samp * 17 + C.BLKSZ * C.CP_FM * 6)),
          None, [s_n, C.BLKSZ, C.FFT_FM, 2])

    # --- K4: the sync block at block 1 of a chain: the spectra, Costas
    # state and timing_adj the main path hands it after block 0; MP1 on the
    # steady wire, then MP2, MP3 (the first MP3 dispatch's wire) and MP11
    # with their PX demaps ---
    def sync_line(x, psmi, case=None):
        _, _, _, cy = rcc.frontend_scan_rc(x, rcc.chain_rc_init_carry(
            psmi=psmi, n_stations=s_n, device=dev), 1, psmi)
        samperr1 = C.FFTCP_FM // 2 + cy.samperr_fb
        spectra1 = rc.dft(AQ.demod_fold(x, cy.offset, cy.phase, samperr1,
                                        cy.prev_angle - cy.angle_fb,
                                        cy.cfo)[0], shift=True)
        sync_args = (spectra1, cy.costas_phase, cy.costas_freq, psmi,
                     C.FFTCP_FM // 2 - samperr1)
        ko, kph, kfr = rcc.sync_block_rc(*sync_args)
        po, pph, pfr = rcc.sync_block_rc_plain(*sync_args)
        exact = set(ko) == set(po) and all(
            torch.equal(ko[k], po[k])
            for k in ("ref_ok", "ref_bc", "ref_psmi", "samperr"))
        soft = {}
        for k in ("pm", "px1", "px2"):
            if k in po:
                diff = (ko[k].int() - po[k].int()).abs()
                soft[k] = (int(diff.max()), float((diff > 0).float().mean()))
        floats = [(ko[k], po[k]) for k in ("angle", "error_lb", "error_ub")]
        floats += [(kph, pph), (kfr, pfr)]
        err = max((a - b).abs().max().item() for a, b in floats)
        rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1)).item()
                  for a, b in floats)
        ppb = C.partitions_per_band(psmi)
        r2, n_data = 2 * (ppb + 1), 2 * ppb * (C.PARTITION_WIDTH_FM - 1)
        soft_bytes = sum(ko[k].shape[1] for k in soft)
        check("sync_block", err, "floats 1e-5 of max(|plain|, 1); ref_ok, "
              "bc, psmi, samperr exact; pm, px1, px2 within 1 on at most "
              "0.1 % of values",
              lambda: rcc.sync_block_rc(*sync_args),
              lambda: rcc.sync_block_rc_plain(*sync_args),
              bound(s_n * (C.BLKSZ * (r2 + n_data) * 8 + 4 * C.FFT_FM * 4
                           + soft_bytes + r2 * 9 + 16),
                    s_n * (r2 * C.BLKSZ * 35 + C.BLKSZ * n_data * 40
                           + soft_bytes * 6)),
              None, [s_n, C.BLKSZ, C.FFT_FM, 2],
              ok=exact and rel <= 1e-5 and all(
                  m <= 1 and share <= 1e-3 for m, share in soft.values()),
              case=case, psmi=psmi, ints_exact=exact, float_rel_err=rel,
              soft_max_diff={k: v[0] for k, v in soft.items()},
              soft_diff_share={k: v[1] for k, v in soft.items()})

    sync_line(samples, 1)
    queue = torch.from_numpy(mp3["queue"]).to(dev)
    n_wire = serve.wire_pairs(DISPATCH_BLOCKS)
    mp3_x = FE.ingest_fm_cu8(queue[:, :n_wire].contiguous())
    for psmi in (2, MP3_PSMI, 11):
        x = mp3_x if psmi == MP3_PSMI else torch.from_numpy(
            mp3[f"rc_psmi{psmi}"]).to(dev)
        sync_line(x, psmi, case=f"psmi{psmi}")

    # --- K9: coarse timing on the cold-start capture (bit-identical) ---
    cap_samples = FE.ingest_fm_cu8(capture)
    ks, kv = AQ.coarse_timing_rc(cap_samples)
    ps, pv = AQ.coarse_timing_rc_plain(cap_samples)
    err = max(float((ks != ps).any()), (kv - pv).abs().max().item())
    win = AQ.WINDOW_FM
    check("coarse_timing", err, 0.0,
          lambda: AQ.coarse_timing_rc(cap_samples),
          lambda: AQ.coarse_timing_rc_plain(cap_samples),
          bound(s_n * (win * 8 + 12),
                s_n * (win * 32 * 2 * 2 + C.FFTCP_FM * C.BLKSZ * 8
                       + C.FFTCP_FM * C.CP_FM * 4)),
          None, [s_n, win, 2], plain_reps=3, plain_inner=2)

    # --- K3 and K10 on the probe's spectra (K9's timing and angle, K2 at
    # CFO 0, the DFT): K3 over 76 CFOs × 22 refs with each CFO's static
    # frequency, the only shape and argument the main path gives K3 (on
    # the steady path it runs inside K4); then the needle count ---
    zero = torch.zeros(s_n, dtype=torch.int32, device=dev)
    unit = torch.tensor([[1.0, 0.0]], device=dev).repeat(s_n, 1)
    probe = rc.dft(AQ.demod_fold(cap_samples, zero, unit, ks, rc.angle(kv),
                                 zero)[0], shift=True)
    t = DC._scan_tables(str(dev))
    refs = probe[:, :, t["bins"]].transpose(0, 1).reshape(
        C.BLKSZ, -1, 2).contiguous()
    cf = t["cfo_freq"].repeat(s_n)
    zf = torch.zeros_like(cf)
    n_tr = refs.shape[1]
    got = CO.costas_track_rc(refs, zf, zf, cf)
    want = CO.costas_track_rc_plain(refs, zf, zf, cf)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check("costas_track", err, 1e-4,
          lambda: CO.costas_track_rc(refs, zf, zf, cf),
          lambda: CO.costas_track_rc_plain(refs, zf, zf, cf),
          bound(n_tr * (C.BLKSZ * 8 * 2 + C.BLKSZ * 4 + 20),
                n_tr * C.BLKSZ * 36),
          None, [C.BLKSZ, n_tr, 2])
    derot = got[0].view(C.BLKSZ, s_n, DC.N_TRACKS, 2)
    kc = DC.needle_count(derot)
    pc = DC.needle_count_plain(derot)
    err = float((kc - pc).abs().max())
    check("needle_count", err, 0.0,
          lambda: DC.needle_count(derot),
          lambda: DC.needle_count_plain(derot),
          bound(derot.numel() // 2 * 4 + kc.numel() * 4,
                kc.numel() * 2 * DC.N_REFS * 8),
          None, list(derot.shape))

    # --- K6: gather + depuncture into K7's input, on the steady chain's
    # own soft bits: 32 P1 frames read in place, 512 PIDS blocks ---
    carries = rcc.chain_rc_init_carry(n_stations=s_n, device=dev)
    pm, _, _, _ = rcc.frontend_scan_rc(samples, carries, n_blocks)
    frames = pm.view(s_n, N_FRAMES, -1)
    f32 = 4
    for name, src, case in (("p1", frames, None), ("pids", pm, "pids")):
        got = DF.fec_gather(src, name)
        err = (got - DF.fec_gather_plain(src, name)).abs().max().item()
        tb = DF.channel_tables(name)
        n_fr = src.shape[0] * src.shape[1]
        read = n_fr * int((tb["code_map"] >= 0).sum())  # soft bits used
        check("fec_gather", err, 0.0,
              lambda src=src, name=name: DF.fec_gather(src, name),
              lambda src=src, name=name: DF.fec_gather_plain(src, name),
              bound(read + tb["k7_map"].size * 4 + got.numel() * f32, 0),
              None, list(got.shape), case=case)
        if name == "p1":
            segs = got
        else:
            pext = got

    # --- K7: Viterbi on those P1 segments and PIDS frames (and, below,
    # the MP3 PX frames) ---
    err = 0.0  # over bits (0/1) and margins, both shapes; must be exact
    for ext in (segs, pext):
        kb, km = CV.acs_traceback(ext, C.CONV_K7_GEN)
        pb, pmg = CV.acs_traceback_plain(ext, C.CONV_K7_GEN)
        err = max(err, (kb.int() - pb.int()).abs().max().item(),
                  (km - pmg).abs().max().item())
    b_seg, n_st = segs.shape[0], segs.shape[1]
    check("viterbi_k7", err, 0.0,
          lambda: CV.acs_traceback(segs, C.CONV_K7_GEN),
          lambda: CV.acs_traceback_plain(segs, C.CONV_K7_GEN),
          bound(b_seg * n_st * (12 + 1) + b_seg * 4,
                b_seg * n_st * (64 * 3 + 16)),
          None, [b_seg, n_st, 3], plain_reps=3, plain_inner=1)
    report["viterbi_k7"]["pids_ms"] = time_ms(
        torch, lambda: CV.acs_traceback(pext, C.CONV_K7_GEN), graph=True)
    report["viterbi_k7"]["pids_shape"] = list(pext.shape)

    # --- K11: the MP3 deinterleave, 16 stations x 16 pairs: the first
    # MP3 dispatch's own PX1 soft bits, from a random IV state and phases;
    # then MP2's shape on random soft bits ---
    g = torch.Generator(device="cpu").manual_seed(SEED + 11)
    _, _, mp3_px, _ = rcc.frontend_scan_rc(mp3_x, rcc.chain_rc_init_carry(
        psmi=MP3_PSMI, n_stations=s_n, device=dev), DISPATCH_BLOCKS,
        MP3_PSMI)
    for fl, case in ((C.P3_FRAME_LEN_MP3_MP11, None),
                     (C.P3_FRAME_LEN_MP2, "mp2")):
        llr = mp3_px["px1"] if case is None else torch.randint(
            -127, 128, (s_n, DISPATCH_BLOCKS, fl), generator=g,
            dtype=torch.int8).to(dev)
        n_iv = iv_state_len(fl)
        state0 = torch.randint(-127, 128, (s_n, n_iv), generator=g,
                               dtype=torch.int8).to(dev)
        phase0 = torch.randint(0, 16, (s_n,), generator=g,
                               dtype=torch.int32).to(dev)
        args = (llr, state0, phase0)
        got = DF.px_deinterleave(*args)
        want = DF.px_deinterleave_plain(*args)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        m = DF.channel_tables(f"px{fl}")["k7_map"].size
        check("px_deinterleave", err, 0.0,
              lambda args=args: DF.px_deinterleave(*args),
              lambda args=args: DF.px_deinterleave_plain(*args),
              bound(llr.numel() + 2 * state0.numel() + n_iv * 5 + m * 4
                    + got[0].numel() * f32 + 8 * s_n, 0),
              None, list(got[0].shape), plain_reps=3, plain_inner=2,
              case=case)
        if case is None:
            px_ext = got[0]

    # --- K7 on the MP3 PX frames: 256 frames of 4672 steps ---
    kb, km = CV.acs_traceback(px_ext, C.CONV_K7_GEN)
    pb, pmg = CV.acs_traceback_plain(px_ext, C.CONV_K7_GEN)
    err = max((kb.int() - pb.int()).abs().max().item(),
              (km - pmg).abs().max().item())
    check("viterbi_k7", err, 0.0,
          lambda: CV.acs_traceback(px_ext, C.CONV_K7_GEN),
          lambda: CV.acs_traceback_plain(px_ext, C.CONV_K7_GEN),
          bound(px_ext.numel() // 3 * (12 + 1) + px_ext.shape[0] * 4,
                px_ext.numel() // 3 * (64 * 3 + 16)),
          None, list(px_ext.shape), plain_reps=1, plain_inner=1, case="px")

    # --- K8: kept bits, re-encode bit errors, descramble, pack, on K7's
    # bits of the P1 segments (with their soft bits), PIDS and PX frames,
    # packed as the path runs it ---
    for name, ext, src, case in (("p1", segs, frames, None),
                                 ("pids", pext, None, "pids"),
                                 ("px4608", px_ext, None, "px")):
        bits_k7, _ = CV.acs_traceback(ext, C.CONV_K7_GEN)
        got, errors = DF.fec_epilogue(bits_k7, name, src, packed=True)
        want, want_errors = DF.fec_epilogue_plain(bits_k7, name, src,
                                                  packed=True)
        err = float((got != want).sum().item())
        if src is not None:
            err += float((errors != want_errors).sum().item())
        tb = DF.channel_tables(name)
        n_fr = got.shape[0]
        tables = tb["keep"].size * 4 + tb["keystream"].size
        pm_read = 0
        if src is not None:
            tables += tb["code_map"].size * 4
            pm_read = n_fr * int((tb["code_map"] >= 0).sum())
        check("fec_epilogue", err, 0.0,
              lambda b=bits_k7, n=name, x=src: DF.fec_epilogue(
                  b, n, x, packed=True),
              lambda b=bits_k7, n=name, x=src: DF.fec_epilogue_plain(
                  b, n, x, packed=True),
              bound(n_fr * tb["t"] + pm_read + tables + got.numel()
                    + (4 * n_fr if src is not None else 0),
                    n_fr * tb["t"] * (3 * 8 if src is not None else 2)),
              None, [n_fr, tb["t"]], plain_reps=3, plain_inner=2, case=case,
              bit_errors=None if errors is None else errors.tolist())

    # --- AM kernels at the AM dispatch's shapes: 16 MA1 stations' first
    # dispatch of 2 frames (cs16 ingested), and 2 frames of 16 MA3
    # stations for the MA3 cases ---
    am_queue = torch.from_numpy(am["queue"]).to(dev)
    n_am = am_buffer_len(AM_FRAMES)
    am_blocks = AM_FRAMES * C.P1_AM_BLOCKS
    am_x = serve.ingest(am_queue[:, :n_am].contiguous(), "am")
    ma3_x = serve.ingest(torch.from_numpy(am["ma3_wire"]).to(dev), "am")
    nsamp_am, fold_out = scar.NSAMP, C.BLKSZ * C.FFT_AM * 8

    def am_block1(x, ma3):
        """K12's arguments at block 1 of the chain (the state block 0
        leaves), and that block's spectra."""
        _, _, cy = scar.am_frontend_scan_rc(x, scar.am_chain_rc_init_carry(
            n_stations=s_n, device=dev), 1, ma3)
        args = (x, cy.offset, cy.phase, cy.samperr_fb, cy.prev_angle,
                cy.cfo)
        return args, scar.acquire_am_fine_rc(*args)[0].contiguous()

    # K12, pass 1 then pass 2 (on pass 1's spectra through the kernel)
    fold_args, am_spectra = am_block1(am_x, False)
    got = scar.am_fold(*fold_args)
    err = (got - scar.am_fold_plain(*fold_args)).abs().max().item()
    check("am_fold", err, 1e-5,
          lambda: scar.am_fold(*fold_args),
          lambda: scar.am_fold_plain(*fold_args),
          bound(s_n * (nsamp_am * 8 + fold_out + 20),
                s_n * (nsamp_am * 17 + C.BLKSZ * C.CP_AM * 6)),
          None, [s_n, C.BLKSZ, C.FFT_AM, 2], case=None, am_pass=1)
    spectra1 = rc.dft(got, shift=True)
    got = scar.am_fold(*fold_args, spectra1)
    want = scar.am_fold_plain(*fold_args, spectra1)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    check("am_fold", err, 1e-5,
          lambda: scar.am_fold(*fold_args, spectra1),
          lambda: scar.am_fold_plain(*fold_args, spectra1),
          bound(s_n * (nsamp_am * 8 + fold_out + C.BLKSZ * 8 + 32),
                s_n * (nsamp_am * 17 + C.BLKSZ * C.CP_AM * 6
                       + C.BLKSZ * 40)),
          None, [s_n, C.BLKSZ, C.FFT_AM, 2], case="pass2", am_pass=2)

    # K13 on block 1's spectra, MA1 and MA3: every output exact
    for ma3, x in ((False, am_x), (True, ma3_x)):
        spec = am_spectra if not ma3 else am_block1(ma3_x, True)[1]
        ko = scar.sync_am_block_rc(spec, ma3)
        po = scar.sync_am_block_rc_plain(spec, ma3)
        diff = {k: int((ko[k] != po[k]).sum()) for k in po}
        # codes, PIDS codes and reference bits are bytes, samperr an int32
        out_bytes = sum(v.numel() * v.element_size() for v in ko.values())
        check("sync_am_block", float(sum(diff.values())), 0.0,
              lambda spec=spec, ma3=ma3: scar.sync_am_block_rc(spec, ma3),
              lambda spec=spec, ma3=ma3: scar.sync_am_block_rc_plain(spec,
                                                                     ma3),
              bound(spec.numel() * 4 + out_bytes,
                    s_n * C.BLKSZ * 4 * C.PARTITION_WIDTH_AM * 60),
              None, list(spec.shape), case="ma3" if ma3 else None,
              differing=diff)

    # K15 on the first dispatch's own codes (through the kernels) and a
    # random handed-on delay line, MA1 and MA3; then K7 at K=9 on its
    # P1, P3 and PIDS segments, and K8 on the P1 bits
    g = torch.Generator(device="cpu").manual_seed(SEED + 15)
    k9 = {}
    for ma3, x in ((False, am_x), (True, ma3_x)):
        codes, pids_c, _ = scar.am_frontend_scan_rc(
            x, scar.am_chain_rc_init_carry(n_stations=s_n, device=dev),
            am_blocks, ma3)
        lines = torch.randint(0, 2, (s_n, 4, DA.DD), generator=g,
                              dtype=torch.uint8).to(dev)
        gargs = (codes, pids_c, lines, ma3)
        got = DA.am_gather(*gargs)
        want = DA.am_gather_plain(*gargs)
        err = float(sum(int((a != b).sum()) for a, b in zip(got, want)))
        # the function reads and rewrites only the mode's delayed lines
        # (ml, mu; also eml, emu in MA3), and of line_src only theirs
        maps = DA.gather_maps(ma3)
        n_dly = maps["n_delayed"]
        map_bytes = sum(v.nbytes for k, v in maps.items()
                        if isinstance(v, np.ndarray) and k != "line_src")
        map_bytes += maps["line_src"][:n_dly].nbytes
        check("am_gather", err, 0.0,
              lambda gargs=gargs: DA.am_gather(*gargs),
              lambda gargs=gargs: DA.am_gather_plain(*gargs),
              bound(codes.numel() + pids_c.numel() + 2 * s_n * n_dly * DA.DD
                    + map_bytes + sum(t.numel() * t.element_size()
                                      for t in got[:3]), 0),
              None, [s_n, am_blocks, 4, 800], plain_reps=3, plain_inner=2,
              case="ma3" if ma3 else None)
        k9["p3_ma3" if ma3 else "p3_ma1"] = got[1]
        if not ma3:
            k9["p1"], k9["pids"] = got[0], got[2]

    for key, gens in (("p1", C.CONV_E1_GEN), ("p3_ma1", C.CONV_E2_E3_GEN),
                      ("p3_ma3", C.CONV_E1_GEN), ("pids", C.CONV_E2_E3_GEN)):
        ext = k9[key]
        kb, km = CV.acs_traceback(ext, gens, 9)
        pb, pmg = CV.acs_traceback_plain(ext, gens, 9)
        err = max((kb.int() - pb.int()).abs().max().item(),
                  (km - pmg).abs().max().item())
        b_seg, n_st = ext.shape[0], ext.shape[1]
        check("viterbi_k9", err, 0.0,
              lambda ext=ext, gens=gens: CV.acs_traceback(ext, gens, 9),
              lambda ext=ext, gens=gens: CV.acs_traceback_plain(ext, gens,
                                                                9),
              bound(b_seg * n_st * (12 + 1) + b_seg * 4,
                    b_seg * n_st * 256 * 8),
              None, [b_seg, n_st, 3], plain_reps=1, plain_inner=1,
              case=None if key == "p1" else key)
        if key == "p1":
            am_p1_bits = kb

    got, _ = DF.fec_epilogue(am_p1_bits, "am_p1", packed=True)
    want, _ = DF.fec_epilogue_plain(am_p1_bits, "am_p1", packed=True)
    tb = DF.channel_tables("am_p1")
    n_fr = got.shape[0]
    check("fec_epilogue", float((got != want).sum().item()), 0.0,
          lambda: DF.fec_epilogue(am_p1_bits, "am_p1", packed=True),
          lambda: DF.fec_epilogue_plain(am_p1_bits, "am_p1", packed=True),
          bound(n_fr * tb["t"] + tb["keep"].size * 4 + tb["keystream"].size
                + got.numel(), n_fr * tb["t"] * 2),
          None, [n_fr, tb["t"]], plain_reps=3, plain_inner=2, case="am_p1")

    # --- K14 at the AM cold start's first probe block (every station's
    # window at 0, fresh state): the power DFT's spectra into the tone
    # estimate, the coarse timing on that tone, and the CFO step on pass
    # 1's spectra demodulated at that timing ---
    cold_wire = torch.from_numpy(am_cold["wire"]).to(dev)
    cold_x = serve.ingest(cold_wire, "am")
    z32 = torch.zeros(s_n, dtype=torch.int32, device=dev)
    zf = torch.zeros(s_n, device=dev)
    no_latch = torch.full((s_n,), -1, dtype=torch.int32, device=dev)
    tone_spectra = rc.dft(AA.tone_symbols(cold_x, z32))
    got = AA.am_tone(tone_spectra, cold_x, z32)
    want = AA.am_tone_plain(tone_spectra, cold_x, z32)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    win_am = AA.WINDOW_AM
    # operations, each cos and sin counted as one: per grid term the phase
    # (2), cos and sin (2), the complex product (6) and its sum (2); the
    # derotation; three 8910-sample passes of Newton and the amplitude; the
    # power sum
    tone_ops = s_n * (AA.N_GRID * win_am * 12 + win_am * 12
                      + 3 * win_am * 20 + C.BLKSZ * C.FFT_AM * 3)
    check("am_tone", err, 0.0,
          lambda: AA.am_tone(tone_spectra, cold_x, z32),
          lambda: AA.am_tone_plain(tone_spectra, cold_x, z32),
          bound(tone_spectra.numel() * 4 + s_n * (win_am * 8 + 4 + 4 + 12),
                tone_ops),
          None, [s_n, win_am, 2], plain_reps=3, plain_inner=2)
    f_t, amp_t = got
    coarse_args = (cold_x, z32, f_t, amp_t, zf, no_latch)
    got = AA.am_coarse(*coarse_args)
    want = AA.am_coarse_plain(*coarse_args)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    nsamp_cp = C.BLKSZ * C.FFTCP_AM
    check("am_coarse", err, 0.0,
          lambda: AA.am_coarse(*coarse_args),
          lambda: AA.am_coarse_plain(*coarse_args),
          bound(s_n * (win_am * 8 + 4 * 6 + 4 * 3 + 8),
                s_n * (win_am * 12 + nsamp_cp * 8
                       + C.FFTCP_AM * C.CP_AM * 4 + C.FFTCP_AM * 3 + 10)),
          None, [s_n, win_am, 2], plain_reps=3, plain_inner=2)
    cold_samperr = got[1]
    spectra1 = rc.dft(scar.am_fold(cold_x, z32, unit, cold_samperr
                                   - C.FFTCP_AM // 2, got[2], z32),
                      shift=True)
    got = AA.am_cfo_step(spectra1)
    want = AA.am_cfo_step_plain(spectra1)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    band = C.BLKSZ * AA.CFO_BINS
    check("am_cfo_step", err, 0.0,
          lambda: AA.am_cfo_step(spectra1),
          lambda: AA.am_cfo_step_plain(spectra1),
          bound(s_n * (band * 8 + AA.CFO_BINS * 4 + 4), s_n * band * 5),
          None, list(spectra1.shape), plain_reps=3, plain_inner=2)

    # --- K1's AM cascade: one 2-frame dispatch of the cu8 AM fleet, u8
    # [16, 434 + 32 x 138780, 2] ---
    cu8_wire = torch.from_numpy(am_cu8["wire"]).to(dev)
    got = FE.ingest_am_cu8(cu8_wire)
    err = (got - FE.ingest_am_cu8_plain(cu8_wire)).abs().max().item()
    n_cu8, n_am_out = cu8_wire.shape[1], got.shape[1]
    # conv1d's float input (the scaled cu8, not timed) and the five stages
    x = (FE.cu8_to_rc(cu8_wire, conj=False) * (1.0 / 16.0)).permute(
        0, 2, 1).reshape(-1, 1, n_cu8).contiguous()

    def conv_cascade():
        y = x
        for _ in range(FE.AM_STAGES):
            y = torch.nn.functional.conv1d(y, taps, stride=2)
        return y

    # operations: per stage output 9 products and 8 sums for I and Q
    # (31 N outputs over the five stages), the conversion's 3 a value
    check("am_decimate_cu8", err, 0.0,
          lambda: FE.ingest_am_cu8(cu8_wire),
          lambda: FE.ingest_am_cu8_plain(cu8_wire),
          bound(s_n * n_cu8 * 2 + s_n * n_am_out * 8,
                s_n * (31 * n_am_out * 34 + n_cu8 * 2 * 3)),
          conv_cascade, [s_n, n_cu8, 2], plain_reps=3, plain_inner=2)
    del x

    # --- coldstart: lock the capture, then decode it from the locks ---
    cap_blocks = LEAD + n_blocks
    torch.cuda.synchronize()
    K.reset_counts()
    locks = serve.cold_start(capture)
    torch.cuda.synchronize()
    counts_cs = dict(K.COUNTS)
    true_cfo = fleet["cfo_bins"]
    n_locked = sum(lock is not None for lock in locks)
    got_cfo = [None if lock is None else lock["cfo"] for lock in locks]
    cfo_ok = n_locked == s_n and (
        all(c == t for c, t in zip(got_cfo, true_cfo))
        or all(c == -t for c, t in zip(got_cfo, true_cfo)))
    lock_ok = cfo_ok and all(lock["first_bc"] == C.P1_FM_BLOCKS - LEAD
                             and lock["psmi"] == 1 for lock in locks)
    if not lock_ok:
        emit({"phase": "coldstart", "locked": n_locked, "cfo": got_cfo,
              "true_cfo": true_cfo.tolist(), "locks": [
                  None if lk is None else {k: lk[k] for k in (
                      "offset", "first_bc", "psmi", "cfo")}
                  for lk in locks], "pass": False})
        raise AssertionError("the cold start did not lock every station "
                             "at the true |CFO|, first_bc 14 and psmi 1")
    carry, psmi, first_bc = serve.carry_from_locks(locks)
    K.reset_counts()
    out, _ = serve.chain_step(capture, carry, cap_blocks, psmi, first_bc,
                              packed=True)
    torch.cuda.synchronize()
    counts_cd = dict(K.COUNTS)
    cs_p1_ok = int((unpack_bits(out["p1"]) == p1_tx).all(axis=-1).sum())
    cs_pids_ok = int((unpack_bits(out["pids"]) == pids_all)
                     .all(axis=-1).sum())

    cs_times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.cold_start(capture)
        torch.cuda.synchronize()
        cs_times.append((time.perf_counter() - t0) * 1e3)
    plain_locks = serve.cold_start(capture, plain=True)
    keys = ("offset", "first_bc", "psmi", "cfo")
    locks_same = all(pl is not None and all(pl[k] == lk[k] for k in keys)
                     for pl, lk in zip(plain_locks, locks))
    plain_carry, _, _ = serve.carry_from_locks(plain_locks) \
        if locks_same else (None, None, None)
    cs_same = locks_same
    if locks_same:
        out_plain, _ = serve.chain_step(capture, plain_carry, cap_blocks,
                                        psmi, first_bc, packed=True,
                                        plain=True)
        cs_same = all(torch.equal(out[k], out_plain[k])
                      for k in ("p1", "pids"))
    launched = {n for n in KERNELS if counts_cs[n] + counts_cd[n] > 0}
    cs_ok = (cs_p1_ok == s_n * N_FRAMES and cs_pids_ok == s_n * cap_blocks
             and cs_same and launched == set(COLD_START) | set(STEADY))
    emit({"phase": "coldstart", "stations": s_n, "locked": n_locked,
          "cfo": got_cfo, "true_cfo": true_cfo.tolist(),
          "cfo_convention": "negated" if got_cfo[0] == -true_cfo[0]
          else "same",
          "offsets": [lk["offset"] for lk in locks],
          "true_offsets": fleet["offset"].tolist(),
          "first_bc": first_bc, "psmi": psmi, "blocks": cap_blocks,
          "p1_frames_ok": cs_p1_ok, "p1_frames": s_n * N_FRAMES,
          "pids_words_ok": cs_pids_ok, "pids_words": s_n * cap_blocks,
          "p1_bit_errors": out["p1_bit_errors"].cpu().tolist(),
          "launches_cold_start": counts_cs, "launches_dispatch": counts_cd,
          "cold_start_wall_ms": statistics.median(cs_times[1:]),
          "cold_start_wall_ms_runs": cs_times,
          "plain_same_locks": locks_same, "plain_same_bits": cs_same,
          "pass": cs_ok})
    if not cs_ok:
        raise AssertionError("the cold-start path did not decode bit-exact "
                             "through every kernel")
    for name in KERNELS:
        report[name]["launches"] = counts_cs[name] + counts_cd[name]
        report[name]["launches_by_path"] = {
            "cold_start": counts_cs[name],
            "dispatch_from_lock": counts_cd[name]}

    # --- the steady slice: one dispatch through the kernels, counted ---
    carries = rcc.chain_rc_init_carry(n_stations=s_n, device=dev)
    torch.cuda.synchronize()
    K.reset_counts()
    out, new = serve.chain_step(wire, carries, n_blocks, packed=True)
    torch.cuda.synchronize()
    counts = dict(K.COUNTS)
    p1 = unpack_bits(out["p1"])
    pids = unpack_bits(out["pids"])
    p1_ok = int((p1 == p1_tx).all(axis=-1).sum())
    pids_ok = int((pids == pids_tx).all(axis=-1).sum())
    for name in KERNELS:
        report[name]["launches_by_path"]["steady"] = counts[name]

    def dispatch():
        return serve.chain_step(wire, carries, n_blocks, packed=True)

    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(times[1:])
    consumed = new.offset.cpu().numpy()
    air_s = float(consumed.sum()) / C.SAMPLE_RATE_CS16_FM

    # stage breakdown of one dispatch, CUDA events around each stage
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    x = serve.ingest(wire)
    ev[1].record()
    pm, _, _, _ = rcc.frontend_scan_rc(x, carries, n_blocks)
    ev[2].record()
    DF.pids_decode(pm, packed=True)
    ev[3].record()
    DF.p1_decode(pm.view(s_n, N_FRAMES, -1), packed=True)
    ev[4].record()
    ev[4].synchronize()
    stages = dict(zip(("ingest_ms", "frontend_scan_ms", "pids_fec_ms",
                       "p1_fec_ms"),
                      (ev[i].elapsed_time(ev[i + 1]) for i in range(4))))

    # one block of the frontend scan, piece by piece: K2, the DFT matmul,
    # and the sync block (K4, and its plain version), each launched from
    # Python
    samperr0 = C.FFTCP_FM // 2 + carries.samperr_fb
    fold_args = (x, carries.offset, carries.phase, samperr0,
                 carries.prev_angle - carries.angle_fb, carries.cfo)
    folded = AQ.demod_fold(*fold_args)[0]
    spec = rc.dft(folded, shift=True)
    block_sync = (spec, carries.costas_phase, carries.costas_freq, 1,
                  C.FFTCP_FM // 2 - samperr0)
    per_block = {
        "demod_fold_ms": time_ms(torch, lambda: AQ.demod_fold(*fold_args)),
        "dft_ms": time_ms(torch, lambda: rc.dft(folded, shift=True)),
        "sync_block_ms": time_ms(
            torch, lambda: rcc.sync_block_rc(*block_sync)),
        "sync_block_plain_ms": time_ms(
            torch, lambda: rcc.sync_block_rc_plain(*block_sync))}

    device_time = profile_device(torch, dispatch)

    def block_loop(n, k4_bound, launches, scan_ms):
        """K5, the block loop, over ``n`` blocks: its launches and its
        bound, the sum of its work's bounds per block: K2, the DFT as the
        code runs it (a float32 GEMM [S*32, 4096] @ [4096, 4096]) and K4."""
        rows, width = s_n * C.BLKSZ, 2 * C.FFT_FM
        dft = bound(2 * rows * width * 4 + width * width * 4,
                    2 * rows * width * width)
        return {"launches": {"demod_fold": launches["demod_fold"],
                             "dft_gemm": n,
                             "sync_block": launches["sync_block"]},
                "bound_ms": n * (report["demod_fold"]["bound_ms"] + dft[0]
                                 + k4_bound),
                "bound_by": dft[1], "dft_bound_ms": dft[0],
                "dft_bound_by": dft[1], "ms": scan_ms}

    out_plain, _ = serve.chain_step(wire, carries, n_blocks, packed=True,
                                    plain=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_plain, _ = serve.chain_step(wire, carries, n_blocks, packed=True,
                                    plain=True)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(out[k], out_plain[k]) for k in ("p1", "pids"))
    slice_ok = (p1_ok == s_n * N_FRAMES and pids_ok == s_n * n_blocks
                and same and all(counts[n] > 0 for n in STEADY))
    emit({"phase": "slice", "stations": s_n, "blocks": n_blocks,
          "p1_frames_ok": p1_ok, "p1_frames": s_n * N_FRAMES,
          "pids_words_ok": pids_ok, "pids_words": s_n * n_blocks,
          "p1_bit_errors": out["p1_bit_errors"].cpu().tolist(),
          "launches": counts, "wall_ms": wall, "wall_ms_runs": times,
          "air_s": air_s, "realtime_factor": air_s / (wall / 1e3),
          "stages": stages, "per_block": per_block,
          "block_loop": block_loop(n_blocks, report["sync_block"]["bound_ms"],
                                   counts, stages["frontend_scan_ms"]),
          "device_time": device_time, "plain_wall_ms": plain_wall,
          "plain_same_bits": same, "pass": slice_ok})
    if not slice_ok:
        raise AssertionError("the slice did not decode bit-exact through "
                             "every kernel")

    # --- mp3: three dispatches of 32 blocks on the MP3 fleet, the carry
    # (interleaver-IV state included) handed from one to the next and each
    # station's queue advanced by twice the chain samples it consumed ---
    fl = C.P3_FRAME_LEN_MP3_MP11

    def mp3_run(plain=False):
        carry = rcc.chain_rc_init_carry(psmi=MP3_PSMI, n_stations=s_n,
                                        device=dev)
        pos = np.zeros(s_n, np.int64)
        run = {"outs": [], "wires": [], "carries": [carry], "launches": [],
               "consumed": []}
        for _ in range(MP3_DISPATCHES):
            w = torch.stack([queue[i, p:p + n_wire]
                             for i, p in enumerate(pos.tolist())])
            torch.cuda.synchronize()
            K.reset_counts()
            out, new = serve.chain_step(w, carry, DISPATCH_BLOCKS, MP3_PSMI,
                                        0, packed=True, plain=plain)
            torch.cuda.synchronize()
            run["launches"].append({n: c for n, c in K.COUNTS.items() if c})
            consumed = new.offset.cpu().numpy()
            pos = pos + 2 * consumed
            carry = new._replace(offset=torch.zeros_like(new.offset))
            for k, v in (("outs", out), ("wires", w), ("carries", carry),
                         ("consumed", consumed)):
                run[k].append(v)
        return run

    plain_calls, restore = count_plain_calls()
    try:
        run = mp3_run()
    finally:
        restore()
    p1_ok = pids_ok = px_ok = 0
    px_cycle0 = 0
    for d, out in enumerate(run["outs"]):
        p1_ok += int((unpack_bits(out["p1"]) == mp3["p1"][:, 2 * d:2 * d + 2])
                     .all(axis=-1).sum())
        pids_ok += int((unpack_bits(out["pids"]) == mp3["pids"][
            :, DISPATCH_BLOCKS * d:DISPATCH_BLOCKS * (d + 1)])
            .all(axis=-1).sum())
        hits = int((unpack_bits(out["px1"]) == mp3["px1"][:, d])
                   .all(axis=-1).sum())
        if d:
            px_ok += hits
        else:
            px_cycle0 = hits
    launches_ok = all(n == MP3_LAUNCHES for n in run["launches"])

    # the plain path must agree exactly: the DFT rounds its input to bf16,
    # so one last-bit difference upstream could move an input across a
    # bf16 rounding edge and spread through the Costas feedback, and the
    # plain versions round as the kernels do
    prun = mp3_run(plain=True)
    same = all(torch.equal(a[k], b[k]) for a, b in zip(
        run["outs"], prun["outs"]) for k in a if k != "diag")
    kc, pc = run["carries"][-1], prun["carries"][-1]
    iv_diff = int((kc.px1_internal.int() - pc.px1_internal.int()).ne(0)
                  .sum())
    iv_same = iv_diff == 0 and torch.equal(kc.px1_phase, pc.px1_phase)

    # dispatch 1 (from dispatch 0's carry) timed, split and profiled
    def dispatch_mp3():
        return serve.chain_step(run["wires"][1], run["carries"][1],
                                DISPATCH_BLOCKS, MP3_PSMI, 0, packed=True)

    mp3_times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch_mp3()
        torch.cuda.synchronize()
        mp3_times.append((time.perf_counter() - t0) * 1e3)
    mp3_wall = statistics.median(mp3_times[1:])
    mp3_air = float(run["consumed"][1].sum()) / C.SAMPLE_RATE_CS16_FM
    cy1 = run["carries"][1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    x = serve.ingest(run["wires"][1])
    ev[1].record()
    pm, _, px, cy = rcc.frontend_scan_rc(x, cy1, DISPATCH_BLOCKS, MP3_PSMI)
    ev[2].record()
    DF.p1_decode(pm.view(s_n, DISPATCH_BLOCKS // C.P1_FM_BLOCKS, -1),
                 packed=True)
    ev[3].record()
    DF.pids_decode(pm, packed=True)
    ev[4].record()
    ext, _, _ = DF.px_deinterleave(px["px1"], cy.px1_internal, cy.px1_phase)
    DF.px_fec(ext, fl, packed=True)
    ev[5].record()
    ev[5].synchronize()
    mp3_stages = dict(zip(("ingest_ms", "frontend_scan_ms", "p1_fec_ms",
                           "pids_fec_ms", "px_fec_ms"),
                          (ev[i].elapsed_time(ev[i + 1]) for i in range(5))))
    mp3_device = profile_device(torch, dispatch_mp3)

    n_disp = MP3_DISPATCHES
    mp3_ok = (p1_ok == s_n * 2 * n_disp
              and pids_ok == s_n * DISPATCH_BLOCKS * n_disp
              and px_ok == s_n * 16 * (n_disp - 1) and launches_ok
              and not plain_calls and same and iv_same
              and mp3_air / (mp3_wall / 1e3) >= 1)
    emit({"phase": "mp3", "stations": s_n, "psmi": MP3_PSMI,
          "dispatches": n_disp, "blocks_per_dispatch": DISPATCH_BLOCKS,
          "p1_frames_ok": p1_ok, "p1_frames": s_n * 2 * n_disp,
          "pids_words_ok": pids_ok,
          "pids_words": s_n * DISPATCH_BLOCKS * n_disp,
          "px1_frames_ok_cycles_1_2": px_ok,
          "px1_frames_cycles_1_2": s_n * 16 * (n_disp - 1),
          "px1_frames_ok_cycle_0": px_cycle0,
          "px1_phase": kc.px1_phase.cpu().tolist(),
          "iv_state_bytes": int(kc.px1_internal.numel()),
          "p1_bit_errors": [o["p1_bit_errors"].cpu().tolist()
                            for o in run["outs"]],
          "launches_per_dispatch": run["launches"],
          "plain_calls_on_kernel_path": plain_calls,
          "plain_same_outputs": same, "plain_iv_state_entries_differing":
          iv_diff, "plain_same_iv_state": iv_same,
          "wall_ms": mp3_wall, "wall_ms_runs": mp3_times, "air_s": mp3_air,
          "realtime_factor": mp3_air / (mp3_wall / 1e3),
          "stages": mp3_stages, "device_time": mp3_device,
          "block_loop": block_loop(
              DISPATCH_BLOCKS,
              report["sync_block"]["cases"]["psmi3"]["bound_ms"],
              run["launches"][1], mp3_stages["frontend_scan_ms"]),
          "pass": mp3_ok})
    if not mp3_ok:
        raise AssertionError("the MP3 path did not decode bit-exact through "
                             "every kernel")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["mp3"] = sum(n.get(name, 0) for n in run["launches"])
        report[name]["launches"] = sum(by_path.values())

    # --- am: three AM dispatches of 2 frames on the AM fleet, the carry
    # (delay lines included) handed from one to the next and each
    # station's queue advanced by the chain samples it consumed ---
    def am_run(plain=False):
        carry = scar.am_chain_rc_init_carry(n_stations=s_n, device=dev)
        pos = np.zeros(s_n, np.int64)
        run = {"outs": [], "wires": [], "carries": [carry], "launches": [],
               "consumed": []}
        for _ in range(AM_DISPATCHES):
            w = torch.stack([am_queue[i, p:p + n_am]
                             for i, p in enumerate(pos.tolist())])
            torch.cuda.synchronize()
            K.reset_counts()
            out, new = serve.chain_step_am(w, carry, AM_FRAMES, packed=True,
                                           plain=plain)
            torch.cuda.synchronize()
            run["launches"].append({n: c for n, c in K.COUNTS.items() if c})
            consumed = new.offset.cpu().numpy()
            pos = pos + consumed
            carry = new._replace(offset=torch.zeros_like(new.offset))
            for k, v in (("outs", out), ("wires", w), ("carries", carry),
                         ("consumed", consumed)):
                run[k].append(v)
        return run

    plain_calls, restore = count_plain_calls()
    try:
        run = am_run()
    finally:
        restore()
    sub = C.P1_FRAME_LEN_AM
    p1_ok = p3_ok = pids_ok = 0
    warm_p1_ok = 0
    for d, out in enumerate(run["outs"]):
        p1 = unpack_bits(out["p1"]).reshape(s_n, AM_FRAMES, 8, sub)
        p3 = unpack_bits(out["p3"])
        for f in range(AM_FRAMES):
            g_f = AM_FRAMES * d + f
            hits = (p1[:, f] == am["p1"][:, g_f]).all(axis=-1)
            if g_f >= 3:
                p1_ok += int(hits.sum())
                p3_ok += int((p3[:, f] == am["p3"][:, g_f]).all(axis=-1)
                             .sum())
            else:
                warm_p1_ok += int(hits.sum())
        pids_ok += int((unpack_bits(out["pids"]) == am["pids"][
            :, am_blocks * d:am_blocks * (d + 1)]).all(axis=-1).sum())
    am_launches_ok = all(n == AM_LAUNCHES for n in run["launches"])

    # the plain path must agree exactly: its K12 and K13 sum and divide as
    # the kernels do and call the same float32 functions, so a difference
    # would be a last-bit difference of sin, cos or atan2 between builds
    # carried across a decision threshold
    prun = am_run(plain=True)
    keys = ("p1", "p3", "pids", "p1_margin", "p3_margin")
    n_entries = sum(out[k].numel() for out in run["outs"] for k in keys)
    n_diff = sum(int((a[k] != b[k]).sum()) for a, b in zip(
        run["outs"], prun["outs"]) for k in keys)
    kc, pc = run["carries"][-1], prun["carries"][-1]
    line_diff = sum(int((a != b).sum()) for a, b in zip(kc.dec, pc.dec))
    state_same = line_diff == 0 and torch.equal(kc.samperr_fb,
                                                pc.samperr_fb)
    code_diff = None
    if n_diff or not state_same:
        # trace: the first dispatch's codes through both block loops
        kcodes = scar.am_frontend_scan_rc(
            serve.ingest(run["wires"][0], "am"), run["carries"][0],
            am_blocks)[0]
        pcodes = scar.am_frontend_scan_rc(
            serve.ingest(run["wires"][0], "am"), run["carries"][0],
            am_blocks, plain=True)[0]
        where = (kcodes != pcodes).nonzero().tolist()
        code_diff = {"count": len(where), "first": where[:20]}
    plain_ok = (n_diff <= 1e-5 * n_entries and line_diff <= 1e-5 * (
        len(kc.dec) * kc.dec.ml.numel()))

    # dispatch 1 (from dispatch 0's carry) timed, split and profiled
    def dispatch_am():
        return serve.chain_step_am(run["wires"][1], run["carries"][1],
                                   AM_FRAMES, packed=True)

    am_times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch_am()
        torch.cuda.synchronize()
        am_times.append((time.perf_counter() - t0) * 1e3)
    am_wall = statistics.median(am_times[1:])
    am_air = float(run["consumed"][1].sum()) / C.SAMPLE_RATE_CS16_AM
    cy1 = run["carries"][1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    x = serve.ingest(run["wires"][1], "am")
    ev[1].record()
    codes, pids_c, _ = scar.am_frontend_scan_rc(x, cy1, am_blocks)
    ev[2].record()
    exts = DA.am_gather(codes, pids_c, torch.stack(list(cy1.dec), dim=1))
    ev[3].record()
    DA.am_fec(*exts[:3], packed=True)
    ev[4].record()
    ev[4].synchronize()
    am_stages = dict(zip(("ingest_ms", "block_loop_ms", "gather_ms",
                          "fec_ms"),
                         (ev[i].elapsed_time(ev[i + 1]) for i in range(4))))
    am_device = profile_device(torch, dispatch_am)
    rows, width = s_n * C.BLKSZ, 2 * C.FFT_AM
    dft = bound(2 * rows * width * 4 + width * width * 4,
                2 * rows * width * width)
    am_loop = {"launches": {"am_fold": run["launches"][1].get("am_fold", 0),
                            "dft_gemm": 2 * am_blocks,
                            "sync_am_block":
                                run["launches"][1].get("sync_am_block", 0)},
               "bound_ms": am_blocks * (
                   report["am_fold"]["bound_ms"]
                   + report["am_fold"]["cases"]["pass2"]["bound_ms"]
                   + 2 * dft[0] + report["sync_am_block"]["bound_ms"]),
               "dft_bound_ms": dft[0], "dft_bound_by": dft[1],
               "ms": am_stages["block_loop_ms"]}

    n_later = AM_DISPATCHES * AM_FRAMES - 3
    am_ok = (p1_ok == s_n * n_later * 8 and p3_ok == s_n * n_later
             and pids_ok == s_n * am_blocks * AM_DISPATCHES
             and am_launches_ok and not plain_calls and plain_ok
             and am_air / (am_wall / 1e3) >= 1)
    emit({"phase": "am", "stations": s_n, "mode": "MA1",
          "dispatches": AM_DISPATCHES, "frames_per_dispatch": AM_FRAMES,
          "p1_subframes_ok_frames_3_5": p1_ok,
          "p1_subframes_frames_3_5": s_n * n_later * 8,
          "p3_frames_ok_frames_3_5": p3_ok,
          "p3_frames_frames_3_5": s_n * n_later,
          "p1_subframes_ok_warm_up": warm_p1_ok,
          "pids_words_ok": pids_ok,
          "pids_words": s_n * am_blocks * AM_DISPATCHES,
          "p1_margin_min": [float(o["p1_margin"].min()) for o in
                            run["outs"]],
          "p3_margin_min": [float(o["p3_margin"].min()) for o in
                            run["outs"]],
          "launches_per_dispatch": run["launches"],
          "plain_calls_on_kernel_path": plain_calls,
          "plain_entries_differing": n_diff, "plain_entries": n_entries,
          "plain_line_entries_differing": line_diff,
          "plain_same_state": state_same, "code_diff": code_diff,
          "wall_ms": am_wall, "wall_ms_runs": am_times, "air_s": am_air,
          "realtime_factor": am_air / (am_wall / 1e3),
          "stages": am_stages, "device_time": am_device,
          "block_loop": am_loop, "pass": am_ok})
    if not am_ok:
        raise AssertionError("the AM path did not decode bit-exact through "
                             "every kernel")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["am"] = sum(n.get(name, 0) for n in run["launches"])
        report[name]["launches"] = sum(by_path.values())

    # --- am_coldstart: lock the 16-station MA1/MA3 capture from cs16, then
    # decode each mode's stations from their locks, three dispatches of 2
    # frames with the carry handed on and each queue advanced by what its
    # station consumed ---
    frame_len = C.P1_AM_BLOCKS * C.BLKSZ * C.FFTCP_AM
    lock_keys = ("offset", "psmi", "ma3", "cfo")

    def am_cold_run(plain=False):
        torch.cuda.synchronize()
        K.reset_counts()
        locks = serve.cold_start(cold_wire, "am", plain=plain)
        torch.cuda.synchronize()
        run = {"locks": locks, "launches": dict(K.COUNTS), "groups": {}}
        if any(lock is None for lock in locks):
            return run
        for ma3 in (False, True):
            idx = [i for i, lock in enumerate(locks) if lock["ma3"] == ma3]
            carry, _ = serve.carry_from_locks([locks[i] for i in idx])
            pos = carry.offset.cpu().numpy().astype(np.int64)
            carry = carry._replace(offset=torch.zeros_like(carry.offset))
            outs, launches = [], []
            for _ in range(AM_DISPATCHES):
                w = torch.stack([cold_wire[i, p:p + n_am]
                                 for i, p in zip(idx, pos.tolist())])
                torch.cuda.synchronize()
                K.reset_counts()
                out, new = serve.chain_step_am(w, carry, AM_FRAMES, ma3,
                                               packed=True, plain=plain)
                torch.cuda.synchronize()
                launches.append({n: c for n, c in K.COUNTS.items() if c})
                pos = pos + new.offset.cpu().numpy()
                carry = new._replace(offset=torch.zeros_like(new.offset))
                outs.append(out)
            run["groups"][ma3] = {"idx": idx, "outs": outs,
                                  "launches": launches}
        return run

    plain_calls, restore = count_plain_calls()
    try:
        crun = am_cold_run()
    finally:
        restore()
    locks = crun["locks"]
    n_locked = sum(lock is not None for lock in locks)
    probes = crun["launches"]["sync_am_block"]
    probe_launches_ok = probes > 0 and {
        n: c for n, c in crun["launches"].items() if c} == {
        n: c * probes for n, c in AM_PROBE_LAUNCHES.items()}
    truth_ok = n_locked == s_n and all(
        lock["cfo"] == int(am_cold["cfo_bins"][i])
        and lock["ma3"] == bool(am_cold["ma3"][i])
        and lock["psmi"] == (C.SERVICE_MODE_MA3 if am_cold["ma3"][i]
                             else C.SERVICE_MODE_MA1)
        for i, lock in enumerate(locks))
    # the frame each lock starts: its first symbol FFTCP_AM // 2 past the
    # lock offset, counted from the station's first transmitted symbol
    lock_frame = [None if lock is None else int(round(
        (lock["offset"] + C.FFTCP_AM // 2 - int(am_cold["offset"][i]))
        / frame_len)) for i, lock in enumerate(locks)]
    n_later = AM_DISPATCHES * AM_FRAMES - 3
    cold_p1_ok = cold_p3_ok = cold_pids_ok = 0
    group_launches_ok = not plain_calls
    if truth_ok:
        for ma3, grp in crun["groups"].items():
            group_launches_ok &= all(n == AM_LAUNCHES
                                     for n in grp["launches"])
            for d, out in enumerate(grp["outs"]):
                p1 = unpack_bits(out["p1"]).reshape(len(grp["idx"]),
                                                    AM_FRAMES, 8, sub)
                p3 = unpack_bits(out["p3"])
                pids = unpack_bits(out["pids"])
                for j, i in enumerate(grp["idx"]):
                    l3 = int(am_cold["p3_len"][i])
                    for f in range(AM_FRAMES):
                        g_f = AM_FRAMES * d + f
                        tx = lock_frame[i] + g_f
                        if g_f >= 3 and tx < AM_COLD_FRAMES:
                            cold_p1_ok += int((p1[j, f] == am_cold["p1"][
                                i, tx]).all(axis=-1).sum())
                            cold_p3_ok += int((p3[j, f] == am_cold["p3"][
                                i, tx, :l3]).all())
                    b0 = (lock_frame[i] + AM_FRAMES * d) * C.P1_AM_BLOCKS
                    want = am_cold["pids"][i, b0:b0 + am_blocks]
                    if len(want) == am_blocks:
                        cold_pids_ok += int((pids[j] == want).all(
                            axis=-1).sum())

    # the plain path: the same locks, and the same outputs from them
    prun = am_cold_run(plain=True)
    plain_locks_same = all(
        (a is None and b is None) or (a is not None and b is not None and all(
            a[k] == b[k] for k in lock_keys))
        for a, b in zip(locks, prun["locks"]))
    plain_bits_same = plain_locks_same and truth_ok and all(
        torch.equal(a[k], b[k])
        for ma3 in (False, True)
        for a, b in zip(crun["groups"][ma3]["outs"],
                        prun["groups"][ma3]["outs"])
        for k in ("p1", "p3", "pids", "p1_margin", "p3_margin"))
    prev_angle_gap = max(
        abs(float(a["carry"].prev_angle) - float(b["carry"].prev_angle))
        for a, b in zip(locks, prun["locks"])) if plain_locks_same \
        and n_locked == s_n else None

    cold_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.cold_start(cold_wire, "am")
        torch.cuda.synchronize()
        cold_times.append((time.perf_counter() - t0) * 1e3)
    cold_device = profile_device(torch, lambda: serve.cold_start(cold_wire,
                                                                 "am"))
    # where the host's time goes: Python functions by own time in one
    # warm cold start (cProfile adds its own cost to every call)
    prof = cProfile.Profile()
    prof.enable()
    serve.cold_start(cold_wire, "am")
    torch.cuda.synchronize()
    prof.disable()
    host_top = [[f"{Path(fn[0]).name}:{fn[1]}:{fn[2]}", calls, own * 1e3]
                for fn, (calls, _, own, _, _) in sorted(
                    pstats.Stats(prof).stats.items(),
                    key=lambda kv: -kv[1][2])[:10]]
    cold_ok = (truth_ok and probe_launches_ok and group_launches_ok
               and cold_p1_ok == s_n * n_later * 8
               and cold_p3_ok == s_n * n_later
               and cold_pids_ok == s_n * am_blocks * AM_DISPATCHES
               and plain_locks_same and plain_bits_same)
    emit({"phase": "am_coldstart", "stations": s_n, "locked": n_locked,
          "locks": [None if lk is None else {k: lk[k] for k in lock_keys}
                    for lk in locks],
          "true_cfo": am_cold["cfo_bins"].tolist(),
          "true_offsets": am_cold["offset"].tolist(),
          "lock_frame": lock_frame, "probe_blocks": probes,
          "launches_cold_start": {n: c for n, c in crun["launches"].items()
                                  if c},
          "launches_per_probe_block": {
              n: c / probes for n, c in crun["launches"].items() if c}
          if probes else None,
          "launches_per_dispatch": {
              str(ma3): grp["launches"] for ma3, grp in
              crun["groups"].items()},
          "plain_calls_on_kernel_path": plain_calls,
          "p1_subframes_ok_frames_3_5": cold_p1_ok,
          "p1_subframes_frames_3_5": s_n * n_later * 8,
          "p3_frames_ok_frames_3_5": cold_p3_ok,
          "p3_frames_frames_3_5": s_n * n_later,
          "pids_words_ok": cold_pids_ok,
          "pids_words": s_n * am_blocks * AM_DISPATCHES,
          "plain_same_locks": plain_locks_same,
          "plain_same_bits": plain_bits_same,
          "plain_prev_angle_max_diff": prev_angle_gap,
          "cold_start_wall_ms": statistics.median(cold_times[1:]),
          "cold_start_wall_ms_runs": cold_times,
          "device_time": cold_device, "host_top_own_ms": host_top,
          "pass": cold_ok})
    if not cold_ok:
        raise AssertionError("the AM cold start did not lock and decode "
                             "every station bit-exact through the kernels")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["am_coldstart"] = crun["launches"].get(name, 0)
        by_path["am_from_lock"] = sum(
            n.get(name, 0) for grp in crun["groups"].values()
            for n in grp["launches"])
        report[name]["launches"] = sum(by_path.values())

    # --- am_cu8: the cu8 AM wire through serve.ingest (K1's AM cascade),
    # each station's output against its baseband ---
    torch.cuda.synchronize()
    K.reset_counts()
    y = serve.ingest(cu8_wire, "am")
    torch.cuda.synchronize()
    cu8_launches = {n: c for n, c in K.COUNTS.items() if c}
    y = y.cpu().numpy().view(np.complex64)[..., 0]
    base = am_cu8["baseband"].view(np.complex64)[..., 0]
    n_c = 1 << 16
    corr = []
    for i in range(s_n):
        r = base[i, :n_c]
        corr.append(max(float(abs(np.vdot(y[i, lag:lag + n_c], r))
                              / (np.linalg.norm(y[i, lag:lag + n_c])
                                 * np.linalg.norm(r))) for lag in range(16)))
    cu8_ok = cu8_launches == {"am_decimate_cu8": 1} and min(corr) > 0.85
    emit({"phase": "am_cu8", "stations": s_n,
          "wire_shape": list(cu8_wire.shape), "launches": cu8_launches,
          "correlation": corr, "min_correlation": min(corr),
          "ms": report["am_decimate_cu8"]["ms"],
          "plain_ms": report["am_decimate_cu8"]["plain_ms"],
          "bound_ms": report["am_decimate_cu8"]["bound_ms"],
          "library_ms": report["am_decimate_cu8"]["library_ms"],
          "pass": cu8_ok})
    if not cu8_ok:
        raise AssertionError("the cu8 AM ingest did not go through K1's AM "
                             "cascade or lost the baseband")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["am_cu8"] = cu8_launches.get(name, 0)
        report[name]["launches"] = sum(by_path.values())

    print(smi, flush=True)
    emit({"kernels": [dict(report[n]) for n in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
