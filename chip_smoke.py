#!/usr/bin/env python3
"""Drive the PyTorch port's FM and AM receive chains, its batched HDC
audio decoder, its receiver, its session and CLI, and its sharded receive
on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
``nvcc``.  It imports nothing of JAX or of the JAX package ``nrsc5_tpu``.
Phases, each printing one JSON line:

1. device: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. build: the twenty-five hand kernels (K1 and its AM cascade, K2, the FM
   DFT kernel ``dft_bf16``, K4, K5's FM and AM carry steps, K6, K7 at
   K=7 and at K=9, K8, K9, K10 (the CFO scan, the Costas PLL of K3 fused
   into it), K11, K12, K13, K14's
   tone estimate, coarse timing and CFO step, K15 and its PIDS-only
   launch, and K16a-d of batched HDC audio) built from the twenty-one
   sources of
   ``nrsc5_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a``, one process per
   source, all in parallel, with ptxas's registers, shared memory and
   stack frames of every kernel;
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
   AM wire (Fourier-upsampled ×32, 217 history pairs ahead).  And the cu8
   AM decode fleet: 4 MA1 stations of 6 frames, 4 HDC packets a P1
   subframe, Fourier-upsampled ×32 with the peak at 0.4 of full scale (a
   tuner's level, tests/test_serve.py:339), cu8, tiled over 16.  And three
   8-packet HDC audio streams (stereo SBR two tones and noise, a stereo
   stream with sharp bursts that carries EIGHT_SHORT windows, a mono
   stream), encoded with the port's ``tx`` copy, each also decoded by the
   port's host decoder fed the sequence three times over.  And the serving
   fleets: 16 MP1 stations of 1-8 lead blocks and 16 frames of transport
   content (32 random HDC packets a frame, the station's ID3 title in the
   AAS PSD, its SIS station ID and short name on PIDS) behind a timing
   offset and a CFO as the cold-start capture's, 25 dB, as 1.488 MS/s cu8;
   16 MA1 stations of 24 frames (4 HDC packets a P1 subframe) behind a
   timing offset of 300-3999 samples, 35 dB, cs16; station 5 of each with
   0.5 s of zeros inserted (after FM frame 3, AM frame 6).  And the golden
   capture, support/make_capture.py's recipe on the port's ``tx`` (seed
   12345, 3 frames of HDC audio of a tone mix, the ID3 title "You're
   Listening to TPU", a SIG table and the LOT file ``tpu.png``, 1.488 MS/s
   cu8), and one MA1 station of 8 frames, tests/capture_helpers.py's
   ``build_am_capture`` on the port's ``tx``, cs16.  And the live fleet's
   16 tuners, 10 frames (14.9 s of air) each as 1.488 MS/s cu8: 8 MP1
   stations carrying HDC audio (16 packets of a two-tone stereo mix, the
   station's own tones, encoded with the port's ``tx`` HDCEncoder and
   repeated) and 2 MP3 stations (random HDC and PX1), each with its ID3
   title, 1000-3999 samples late, a CFO within ±60 Hz, 25 dB; 4 MA1 and 2
   MA3 stations (4 random HDC packets a P1 subframe), 300-3999 samples
   late, a CFO within ±10 Hz, 35 dB, Fourier-upsampled ×32 with the peak
   at 0.4 of full scale;
4. one line per kernel: the kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it, with times (K2's bf16 fold
   within one bf16 ulp of its plain version, the share that differs
   printed; the DFT kernel on that fold, 512 rows, with
   cuBLAS's bf16 GEMM of the same operands as its library call and the
   float32 GEMM it replaced beside it; K4 also at
   psmi 2, 3 and 11, K6 and K8 at P1's and PIDS's shapes, K8 at PX's,
   K11 at MP3's and MP2's (K6 and K11 int8 out, exact, with one
   index_select over each frame's zero-padded pm as K6's library call and
   one torch.take over each station's [state | soft bits | 0] as K11's;
   K7 on their int8 also on the same values in float32, the same bits and
   margins); the AM kernels K12 in both passes (its fold written rounded
   to bf16, the DFT's operand: each entry the bf16 rounding of a value
   within 1e-5 of the plain version's unrounded fold, the entries that
   are not the nearest rounding printed), K13 and K15 in MA1 and MA3 (K15
   int8 out, exact, the lines the mode does not delay handed back as the
   same tensors; its PIDS-only launch at one block, the per-block AM
   receiver's call, with and without ``pids1_disabled``, as cases of its
   line, one launch of its own count each), K7 at K=9 on K15's int8 P1, P3 of MA1 and MA3 and PIDS
   (also on the same values in float32, the same bits and margins), and
   K8
   on the AM P1; K14's three kernels at the AM cold start's first probe
   block (its tone estimate three kernels in turn: k0 and z, the grid
   projection, the tail over a cluster of 8; its coarse timing over a
   cluster of 8 CTAs a station; its CFO step four threads a bin), K1's AM
   cascade on the cu8 AM wire (with its byte bound and its no-FMA issue
   floor at the SM clock nvidia-smi reads; then a ``kernel_edges`` line:
   one station at 300 outputs, a short last tile, rows off a 16-byte
   boundary, a wire one pair past a 4-byte boundary, each exact); K4 and
   K13 also as the block loops launch them, with K5's carry step fused in
   (case ``carry``: the step exact); K16a-d one after the other
   on a batch of the audio fleet, 128 lanes x 8 packets (K16c also on the
   interpol_freq=0 and smoothing headers' batches, one program's 8
   packets tiled to 128 lanes, as cases of its line; K16d beside one
   grouped conv1d of the fold; both lines with their kernel's registers
   and stack frame); K5's two carry
   steps on block 1's state).  K7's lines (K=7: P1, PIDS, PX1; K=9: P1,
   P3 of MA1 and MA3, PIDS) hold bits and margins exact and add the
   kernel on the first segment alone, the chain one segment cannot go
   below, with its cycles a step at the SM clock nvidia-smi reads.  K6,
   K9 and K14's three entry points also gate on the kernels a call
   counted (two for K9 and for K6 on P1, three for the tone, one for the
   coarse timing and the CFO step), and after the last kernel line one
   ``kernel_split`` line each times every kernel of those calls with the
   profiler, beside its bound (the coarse timing's and the CFO step's
   also with ``probe_block_exposed_ms``, what each adds to one profiled
   probe block past the end of the kernel ahead of it).  K13's line
   carries the stack frames ptxas reports for its source, K14's coarse
   timing and CFO step lines and K11's and K15's their kernel's
   (reported, not gated);
5. coldstart: ``serve.cold_start`` on the capture must lock 16/16 stations
   with the true |CFO| under one sign convention, first_bc 14 and psmi 1;
   then ``serve.chain_step`` from the locks over 34 blocks must decode
   every P1 frame and PIDS word bit-exact, and the same path through the
   plain versions the same locks and bits.  Launch counts of the cold start
   and of that dispatch, and the cold start's wall time: six runs, each
   followed by the same cold start replayed step by step (the ingest,
   probe 1 to its read-back, the host argmax, probe 2 and its read-back,
   the votes and carries), each part timed after a synchronize, the
   replay's locks gated equal to the cold start's;
6. slice: ``serve.chain_step`` on the steady wire — launch counts taken
   from that one dispatch, every P1 frame and PIDS word held bit-exact
   against the transmitted bits, wall time per dispatch and real-time
   factor, a stage breakdown, one block's pieces timed alone, the device's
   busy time from the profiler, and the same dispatch through the plain
   versions, which must decode the same bits; an eager dispatch calls no
   plain version, and the profiled dispatches hold no GEMM kernel;
7. mp3: three ``serve.chain_step`` dispatches of 32 blocks on the MP3
   queues, the carry (interleaver-IV state included) handed from one to
   the next and each queue advanced by what its station consumed.  Gate:
   all 96 P1 frames, 1536 PIDS words and the 512 PX1 frames of IV cycles 1
   and 2 bit-exact at their pair positions; the launch counts of the three
   dispatches exactly those of K1, K2, the DFT kernel, K4, K5, K6, K7, K8
   and K11 on that path, and no plain version called; the same dispatches
   through the plain versions on the DFT kernel's spectra the same
   outputs, margins, pm, consumed samples and IV state; through the plain
   versions with the DFT's own, the same decoded bits, consumed samples,
   IV phase and re-encode error counts, and pm and the IV state within 1
   (the share that differs printed, beside the share by which the plain
   path parts from itself when its spectra move by one float32 ulp).
   Wall per dispatch, real-time factor (at least 1), stage split, device
   busy time;
8. am: three ``serve.chain_step_am`` dispatches of 2 frames on the AM
   queues from a fresh carry, the carry (delay lines included) handed on
   and each queue advanced by what its station consumed.  Gate: every P1
   subframe and P3 frame of frames 3-5 (384 and 48; frames 0-2 are the
   diversity warm-up) and all 768 PIDS words bit-exact; the launch counts
   of each dispatch exactly K12 32, K13 16, K15 1, K7 at K=9 3 and K8 3,
   and no plain version called; the same dispatches through the plain
   versions the same bits, margins and final delay lines.  Wall per
   dispatch, real-time factor, stage split, device busy time with the
   number of device spans (kernels and copies) beside it;
9. am_coldstart: ``serve.cold_start(mode="am")`` on the cold-start capture
   must lock 16/16 stations at their true integer CFO, mode and psmi, each
   probe block launching exactly K14's tone 3 (kernels), coarse 1 and
   CFO step 1, K12 2 and K13 1, with no plain version called.  Then per mode,
   ``serve.carry_from_locks`` and three ``serve.chain_step_am`` dispatches
   of 2 frames from the locks, the carry handed on and each queue advanced
   by what its station consumed: every P1 subframe and P3 frame of frames
   3-5 counted from the lock and every PIDS word bit-exact.  The plain
   versions must give the same locks and bits.  The cold start's wall time,
   probe blocks, launches per probe block beside one probe block's device
   time (``probe_block_ms``: the stations' first block as the cold start's
   graph replays it, CUDA events around 10 replays, median of 7) and
   device busy time;
10. am_cu8: ``serve.ingest`` of the cu8 AM wire launches K1's AM cascade
   once, and each station's output correlates with its baseband above
   0.85 (the reference's own bound for this cascade); then
   am_cu8_decode: three ``serve.chain_step_am`` dispatches of 2 frames
   straight from the cu8 AM decode fleet's wire, the carry handed on.
   Gate: every P1 subframe of frames 3-5 bit-exact; each station's host
   transport delivers only sent HDC packets, every one of frames 3-4 and
   at least 64; each dispatch launches K1's AM cascade once and the AM
   dispatch's kernels, no plain version; the plain path the same bits
   and packets; the graph the eager outputs.  The dispatch's wall, device
   time, K1's AM cascade's share of its kernel time, beside the cs16 MA1
   dispatch's;
11. audio: ``BatchedAudioDecoder`` over 64 stereo programs (128 lanes;
   program p plays stream p % 3) and three dispatches of the same 8
   packets, each batch ``prepare``d once on the host, the device state
   carried.  Gate: every dispatch launches K16a-d once each and no plain
   version; the same prepared inputs through the plain versions on the
   card, from a copy of the same device state, give the same int16 PCM
   and the same carried state tensors after every dispatch; every lane
   within 55 dB SNR of the host decoder from packet 2 on (bench.py's
   gate).  The prepare wall, the dispatch wall (device half: inputs up,
   the stage, PCM down), audio seconds a dispatch second, device busy
   time.

Every dispatch of phases 5-9 goes through K5's CUDA graphs (the ingest and
block loop of each dispatch shape, and the AM cold start's probe block);
each of those phases also runs the same inputs with the loop launched
eagerly, gates on the graph's outputs equal to the eager ones, and prints
the eager wall and device time beside the graph's.  Then:

12. serve_fm and 13. serve_am: ``MultiStationReceiver`` over each serving
   fleet, ``cold_start=True``, ``frames_per_dispatch=2``, ``depth=2``,
   every station's raw bytes pushed in turn in odd-sized pieces, then
   ``flush``.  Gate: 16 SYNC events; every clean HDC packet one the
   station transmitted and every frame it delivered whole (the stream's
   end may cut the last); FM: every station's ID3 title and SIS name;
   station 5 LOST_SYNC then SYNC then whole frames again, no other station
   a LOST_SYNC; every steady dispatch, alignment dispatch and relock probe
   launching exactly its path's kernels (graph replays counted), nothing
   launched outside them, no plain version called; the eager loop the same
   events.  Station-seconds of air over the wall of push through flush
   (the first run, which captures any graph it meets first, and a warm
   run), the wall a dispatch, device busy time and idle share, events per
   station; the same for the eager loop;
14. session_fm: the golden drive, the port's CLI ``cli.main(["-r",
   capture, "0", "0", "-o", raw, "--dump-aas-files", dir, "--dump-hdc",
   hdc, "-w", tee])`` on the default device, twice (the first run
   captures the one-station graph), then once under the profiler.  Gate
   (each run): "Synchronized" logged once, "Title: You're Listening to
   TPU" and a "LOT file" line logged, the dumped ``tpu.png`` equal to its
   100 bytes, at least 2·2048·32 int16 samples of raw PCM with a peak
   above 3000, an HDC dump above 5000 bytes, the tee equal to the capture,
   every kernel of the session's FM path launched (K1 a push; the cold
   start's K9, K2, the DFT kernel, K10, K4; the receiver's K2, the DFT
   kernel, K4, K5, K6, K7, K8) and no other, no plain version called.
   The CLI's wall and real-time factor, the cold start's wall, the
   launches by kernel, the device busy time and idle share;
15. session_am: the MA1 station through ``NRSC5.open_pipe(..., MODE_AM)``
   in pushes of 50000 samples, then ``flush``, twice, then once under the
   profiler.  Gate (each run): one SYNC and no LOST_SYNC, at least 48
   clean HDC packets that were sent (those after the diversity warm-up)
   and none that was not, every kernel of the session's AM path launched
   (the cold start's K14, K12, K13; the receiver's K12, K13, K15, K7 at
   K=9, K8) and no other, no plain version called.  Wall, cold start,
   launches, device busy;
16. fleet: the live mixed fleet.  Sixteen fake rtl_tcp servers on
   127.0.0.1 (threads of this script; loopback only), each greeting as an
   R820T, recording the tuner commands, sending its tuner's capture once
   and holding the connection open; ``serve.RtlTcpFleet(...,
   modes="auto", frames_per_dispatch=2, hdc_factory=None, gain_db=30.0)``
   with no mode argument (a reader thread a tuner into one
   ``HeterogeneousReceiver``: each station's band and mode found by a cold
   start on the card, K1's FM halfband or AM cascade first, then one
   receiver a mode, grown as stations join), its callback
   ``FleetAudioDecoder(16, cb, programs=(0,), k=8).wrap`` (K16a-d on the
   card from a dispatch thread).  ``stop()`` once every capture is
   pushed, then the audio decoder's ``flush()``.  Gate: each station's
   mode its truth, in exactly 4 groups; one SYNC each and no LOST_SYNC or
   LOST_DEVICE; FM stations their own ID3 title and no other's and only
   packets they sent; AM stations at least 32 exact HDC packets and none
   foreign; each MP1 station at least 64 AUDIO events and, over its
   longest run of real packets (the decoder pads a lagging row with
   silence), PCM more than 50 dB from the port's host decoder on the same
   packets from packet 8 on; the launches exactly the path's kernels
   (every kernel but K5's AM step), no plain version called; within 180
   s.  The wall from ``start`` to ``stop``, station-seconds of air a
   second of wall, each station's wire seconds and wall to discovery, the
   groups, the graph captures and their wall, fleet audio seconds a
   second of wall with the prepare and dispatch walls, the launches, and
   the phase's own seconds;
17. receiver_fm: the per-block receivers on the card through the session
   (``NRSC5(..., chain="block")``, the complex chain as plain PyTorch,
   the FEC through the kernels): the golden capture pushed as cu8 in
   32768-byte pieces, per-block twice (the first run meets each op's
   first call), then with the FM decoders' plain versions on the card,
   then through the turbo receiver.  Gate: one SYNC at psmi
   1, the ID3 title and LOT file events the CPU twin of this drive gives
   (``BLOCK_GOLDEN_TITLES``, ``BLOCK_GOLDEN_LOTS``;
   tests/test_torch_block_session.py), the LOT file's bytes, the P1 and
   PIDS bits equal to the plain run's, the turbo receiver's HDC packets,
   P1 frames and PIDS words equal to the per-block run's, frame for
   frame, exactly K6, K7 and K8 launched and no
   plain version called; and one MP3 and one MP11 station (2 IV cycles
   behind 2 lead blocks, 25 dB) through ``FMReceiver``: every P1 frame and
   every PX1 and PX2 frame of IV cycle 1 exact against the transmitted
   frames, exactly K6, K7, K8 and K11 launched; the second per-block
   run the same P1 and PIDS bits.  The wall a block of each;
18. receiver_am: session_am's capture with rdbi set from frame
   ``BLOCK_AM_RDBI_FROM`` on, and the same recipe in MA3 without rdbi,
   cs16 pushes of 50000 samples through the per-block AM session, each
   run again with the AM decoders' CPU twins on the codes copied to the
   host.  Gate, in each mode: one SYNC at its psmi, no LOST_SYNC, at
   least session_am's 48 exact HDC packets and none foreign, PIDS words,
   P1 and P3 frames on each channel, every one of them (bits and margin)
   equal to the twin run's, frame for frame, exactly K15, its PIDS-only
   launch, K7 at K=9 and K8 launched, no plain version called; in MA1
   every launch of K15's PIDS-only launch (a block, counted on its own;
   with ``pids1_disabled`` once rdbi is read) exact against its plain
   version on the same codes, and a second run the same frames.  The
   wall a block of the runs.

19. parallel: the on-device FM cold start (``scan_chain_rc.
   cold_start_device_rc``) on the coldstart phase's 16 stations and one of
   noise only (gate: start, first_bc, cfo and locked those of the host
   ``cold_start_rc``, the angle bit-equal, the plain run bit-equal, the
   noise station unlocked, launches exactly K9 2 (kernels), K2 2, the DFT
   kernel 2, K10 1, K4 1, and no device-to-host copy in the profile); then
   ``parallel.receive``'s four sharded steps (FM, self-sync, AM, PX at psmi
   3; 2 stations each, from the port's ``tx``) over a 1 x 1 NCCL mesh in
   this process, and over a 1 x 2 (station, time) gloo mesh of two
   processes on this card (``parallel.distributed.run_ranks``: halos and
   sums staged through pinned host memory), where each rank also runs the
   two-stage ``pipelined_receive`` (3 frames of each station) and the
   two-host ``distributed`` self-test.  Gate: every P1, PIDS, PX1 (the
   second IV cycle) and AM P1/P3 frame past each shard's warm-up (and
   every AM PIDS word) the transmitted bits; each rank's block equal to
   the one-process ``fm_chain_scan``/``am_chain_scan`` (or the self-sync
   shard's work) on the extended chunk built from the whole capture;
   ``quality`` equal on every rank; the self-sync shards locked at |cfo|
   3; the pipeline's outputs and carry equal to the fused chain's; every
   rank's ``DCN_OK``.  Prints each step's wall, the exchange's time, bytes
   through the host and backend, and the pipeline's step time beside the
   fused chain's frame time; 20. serve_mesh: ``MultiStationReceiver(mesh=
   ["cuda:0", "cuda:0"])`` on two serve_fm stations (gate: the unsharded
   receiver's HDC packets and ID3 titles, station by station, one SYNC
   each); 21. am_drift: tests/test_am_multipath.py:136's MA1 capture at
   ±50 ppm of clock drift through the AM session (gate: the per-block
   receivers, the path that test drives, one SYNC, no LOST_SYNC and every
   HDC packet of frames 6-10; the device chain one SYNC, no LOST_SYNC, no
   foreign packet and at least 144 of those 160 packets, the count both
   packages give on the CPU).

Then the ``nvidia-smi`` line, a ``{"kernels": [...]}`` line (``launches``:
the kernels launched, summed over the paths driven and itemised under
``launches_by_path``; a call that runs two kernels in turn, K6 on P1 and
K9, counts two, and its line gives each kernel's time as the profiler
records it) and,
last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
with no CUDA card it exits 2 before printing anything.
"""

from __future__ import annotations

import cProfile
import hashlib
import inspect
import json
import math
import multiprocessing
import os
import pstats
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import threading
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
# the cu8 AM decode fleet: the wire's peak at a tuner's level, of full
# scale (tests/test_serve.py:339), and the distinct stations tiled over 16
AM_CU8_LEVEL = 0.4
AM_CU8_DISTINCT = 4
# batched HDC audio: the JAX package's audio row (bench.py --mode audio at
# its default 64 stereo programs, K = 8 packets a dispatch)
AUDIO_PROGRAMS = 64
AUDIO_PACKETS = 8
AUDIO_DISPATCHES = 3
AUDIO_STREAMS = ("steady", "transient", "mono")
AUDIO_FS = 44100
AUDIO_SNR_DB = 55.0
# the two other SBR headers K16c's line runs (the smoothing header walks no
# packet in turn any more), each one program's 8 packets tiled to 128 lanes
AUDIO_HEADERS = {
    "interpol0": dict(start_freq=8, stop_freq=7, amp_res=0, xover_band=2,
                      interpol_freq=0),
    "smooth": dict(start_freq=8, stop_freq=7, amp_res=0, xover_band=2,
                   smoothing_mode=0)}
# the serving phases: MultiStationReceiver over 16 stations each, one of
# them with a hole of zeros that breaks its lock
SERVE_FRAMES = 16  # FM P1 frames a station
SERVE_LEAD_MAX = 8  # FM lead blocks ahead of frame 0: 1 to this many
SERVE_AM_FRAMES = 24  # AM frames a station
SERVE_HOLE_STATION = 5
SERVE_HOLE_S = 0.5
SERVE_HOLE_AFTER = 4  # FM: the hole follows frame 3
SERVE_AM_HOLE_AFTER = 7  # AM: the hole follows frame 6
SERVE_PUSH = 98765  # odd-sized pushes (wire samples)
# the golden capture (support/make_capture.py's recipe) and the session
# phases
GOLDEN_TITLE = "You're Listening to TPU"
GOLDEN_SEED = 12345
GOLDEN_FRAMES = 3
GOLDEN_LOT_NAME = "tpu.png"
GOLDEN_LOT_DATA = bytes(range(100))
GOLDEN_LOT_ID = 7
GOLDEN_SIG_PORT = 0x1001
SESSION_AM_FRAMES = 8
# the golden capture through the per-block session (receiver_fm): the ID3
# title and LOT file events its CPU twin gives
# (tests/test_torch_block_session.py::test_golden_capture_block_and_turbo)
BLOCK_GOLDEN_TITLES = 2
BLOCK_GOLDEN_LOTS = 1
SESSION_AM_PUSH = 50000  # cs16 samples a push
DRIFT_AM_FRAMES = 12  # frames of the clock-drift AM capture
# HDC packets of the gate frames that the device chain delivers on the
# drifting capture: 144 of 160 in both packages (tests/test_torch_am_drift.py)
DRIFT_AM_MIN_HDC = 144
DRIFT_PPM = (50.0, -50.0)
DRIFT_PUSH = 16384  # samples a push, as tests/test_am_multipath.py:161
DRIFT_FRAMES = range(6, 11)  # frames whose packets must all arrive
SESSION_AM_MIN_HDC = 48  # bit-exact HDC packets after the warm-up
BLOCK_AM_RDBI_FROM = 6  # receiver_am: the frame from which rdbi is set
FLEET_KINDS = ("mp1",) * 8 + ("mp3",) * 2 + ("ma1",) * 4 + ("ma3",) * 2
FLEET_FRAMES = 10  # P1 frames of every fleet station: 14.9 s of air
FLEET_AUDIO_UNIQUE = 16  # distinct HDC audio packets of an MP1 station
FLEET_DEADLINE_S = 180.0
FLEET_MIN_AUDIO = 64  # AUDIO events of each MP1 audio station
FLEET_AUDIO_SNR_DB = 50.0
FLEET_AUDIO_SKIP = 8  # packets of a run before the SNR is taken
FLEET_AM_MIN_HDC = 32  # exact HDC packets of each AM station
# the tuners' socket timeout: a fake server that has sent its whole
# capture waits for the others, which a live tuner never does
FLEET_SOCKET_TIMEOUT_S = 60.0
# the card's published peaks (NVIDIA H100 SXM data sheet) for bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12  # dense, the tensor cores

# kernel name -> (source, the JAX function it replaces)
KERNELS = {
    "halfband_cu8": ("nrsc5_tpu_torch/csrc/halfband_cu8.cu",
                     "nrsc5_tpu/ops/frontend.py:120"),
    "demod_fold": ("nrsc5_tpu_torch/csrc/demod_fold.cu",
                   "nrsc5_tpu/ops/acquire_rc.py:73"),
    "dft_bf16": ("nrsc5_tpu_torch/csrc/dft_bf16.cu",
                 "nrsc5_tpu/ops/acquire_rc.py:104"),
    "viterbi_k7": ("nrsc5_tpu_torch/csrc/viterbi_k7.cu",
                   "nrsc5_tpu/ops/convolutional.py:154"),
    "sync_block": ("nrsc5_tpu_torch/csrc/sync_block.cu",
                   "nrsc5_tpu/pipeline/scan_chain_rc.py:128"),
    "coarse_timing": ("nrsc5_tpu_torch/csrc/coarse_timing.cu",
                      "nrsc5_tpu/ops/acquire_rc.py:43"),
    "cfo_scan": ("nrsc5_tpu_torch/csrc/cfo_scan.cu",
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
    "aac_window_qmf_analysis": (
        "nrsc5_tpu_torch/csrc/aac_window_qmf_analysis.cu",
        "nrsc5_tpu/audio/batch.py:221"),
    "sbr_hf_generate": ("nrsc5_tpu_torch/csrc/sbr_hf_generate.cu",
                        "nrsc5_tpu/audio/batch.py:259"),
    "sbr_hf_adjust": ("nrsc5_tpu_torch/csrc/sbr_hf_adjust.cu",
                      "nrsc5_tpu/audio/batch.py:326"),
    "qmf_synthesis": ("nrsc5_tpu_torch/csrc/qmf_synthesis.cu",
                      "nrsc5_tpu/audio/batch.py:484"),
    "block_carry": ("nrsc5_tpu_torch/csrc/block_carry.cu",
                    "nrsc5_tpu/pipeline/scan_chain_rc.py:274"),
    "block_carry_am": ("nrsc5_tpu_torch/csrc/block_carry.cu",
                       "nrsc5_tpu/pipeline/scan_chain_am_rc.py:259"),
}
AUDIO_KERNELS = ("aac_window_qmf_analysis", "sbr_hf_generate",
                 "sbr_hf_adjust", "qmf_synthesis")
# the kernels each path launches
STEADY = ("halfband_cu8", "demod_fold", "dft_bf16", "sync_block",
          "fec_gather", "viterbi_k7", "fec_epilogue", "block_carry")
COLD_START = ("halfband_cu8", "demod_fold", "dft_bf16", "cfo_scan",
              "sync_block", "coarse_timing")
# launches of one MP3 dispatch of 32 blocks: K1 once, K2, the DFT kernel
# and K4 per block (K4 taking K5's carry step after its block), K5 once
# ahead of block 0, K6 for P1 (two kernels) and PIDS, K7 and K8 for P1,
# PIDS and PX1, K11 once
MP3_LAUNCHES = {"halfband_cu8": 1, "demod_fold": 32, "dft_bf16": 32,
                "sync_block": 32, "block_carry": 1, "fec_gather": 3,
                "viterbi_k7": 3, "fec_epilogue": 3, "px_deinterleave": 1}
# launches of one AM dispatch of 2 frames (16 blocks): K12 twice a block,
# K13 once a block (taking K5's carry step: no K5), K15 once, K7 at K=9
# and K8 for P1, P3 and PIDS
AM_LAUNCHES = {"am_fold": 32, "sync_am_block": 16, "am_gather": 1,
               "viterbi_k9": 3, "fec_epilogue": 3}
# launches of one AM cold-start probe block: K14's tone estimate (three
# kernels in turn), coarse timing and CFO step, K12 in both passes, K13
# once
AM_PROBE_LAUNCHES = {"am_tone": 3, "am_coarse": 1, "am_fold": 2,
                     "am_cfo_step": 1, "sync_am_block": 1}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dft_bound(rows: int, n: int) -> tuple[float, str]:
    """Least time of ``rows`` complex ``n``-point DFTs as a DFT needs them:
    the float32 rc input read once and the spectra written once, and a
    radix-2 FFT's 5 n log2 n operations a row."""
    return bound(2 * rows * n * 2 * 4, rows * 5 * n * math.log2(n))


def gemm_bound(rows: int, n: int) -> tuple[float, str]:
    """Least time of the same DFTs as one dense float32 product [rows, 2n]
    @ [2n, 2n] (the AM DFTs, and the FM DFT before its kernel): its two
    operands read and its result written once, 2 (2n)^2 operations a row
    on the float32 cores."""
    width = 2 * n
    return bound(2 * rows * width * 4 + width * width * 4,
                 2 * rows * width * width)


def bf16_gemm_bound(rows: int, n: int) -> tuple[float, str]:
    """Least time of the same DFTs as the FM DFT kernel computes them, one
    dense product of bf16 operands with float32 accumulation: the bf16
    input [rows, 2n] and table [2n, 2n] read and the float32 spectra
    written once, 2 (2n)^2 operations a row at the tensor cores' dense bf16
    peak."""
    width = 2 * n
    t_bytes = (rows * width * 2 + width * width * 2 + rows * width * 4) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * width * width / BF16_TENSOR_OPS_PER_S * 1e3
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
    and set spans the profiler records on the card (one stream), against
    the call's wall time; beside it the number of spans (and of copy
    spans), the kernels' share of the busy time, and the time at least one
    kernel runs (where kernels launched to start early overlap)."""
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
    # the kernels alone: a pageable copy's span also holds the host's
    # staging of it, which varies from run to run
    kernels = [e for e in spans if not e.name.startswith(("Memcpy", "Memset"))]
    kernel_busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    # the time at least one kernel runs: a kernel launched to start while
    # the one ahead of it ends (programmatic dependent launch) opens its
    # span early, and the sum counts the overlap twice
    kernel_union, reach = 0.0, None
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if reach is None or a > reach:
            kernel_union += b - a
            reach = b
        elif b > reach:
            kernel_union += b - reach
            reach = b
    by_name = {}
    for e in spans:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"spans": len(spans), "busy_ms": busy,
            "kernel_busy_ms": kernel_busy,
            "kernel_union_ms": kernel_union / 1e3, "wall_ms": wall,
            "idle_share": 1 - busy / wall if spans else None,
            "top_ms": [[n[:80], t] for n, t in top],
            "gemm_spans": sum("gemm" in e.name.lower() for e in spans),
            "copy_spans": sum("copy" in e.name.lower() for e in spans)}


def kernel_spans(torch, fn, calls: int = 10, sessions: int = 3) -> dict:
    """The kernels one call of ``fn`` runs on the card, as the profiler
    records them over ``calls`` calls after a warm one: how many a call,
    and each one's mean device ms a call, by its short name.  A profiler
    session that comes back without a whole number of spans a call (the
    first in a process has been seen to return none) is run again, up to
    ``sessions`` in all; ``sessions`` in the result says how many ran.
    What it reads is reported, not gated on: the launch counts are the
    gate."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans and len(spans) % calls == 0:
            break
    ms = {}
    for e in spans:
        name = short_kernel_name(e.name)
        ms[name] = ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return {"kernels_a_call": len(spans) / calls, "ms": ms,
            "sessions": session}


def short_kernel_name(name: str) -> str:
    """A kernel's name as the profiler gives it (``void (anonymous
    namespace)::k<8>(Args)``), without its return type, namespaces,
    template arguments and parameters (``k``)."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    head = head.split("<")[0].split("::")[-1]
    return (head.split() or [name])[-1]


def frames_by_kernel(lines) -> dict:
    """``{kernel's mangled name: stack frame bytes}`` from a source's
    ptxas lines ("Function properties for <name>", then its frame)."""
    out, name = {}, None
    for ln in lines:
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
        elif "stack frame" in ln and name is not None:
            out[name] = int(ln.split()[0])
            name = None
    return out


def frame_of(kernel_frames: dict, source: str, kernel: str):
    """The stack frame bytes of ``kernel`` (a part of its mangled name) in
    ``source``, or why they were not read."""
    frames = kernel_frames.get(source)
    if frames is None:
        return "not read: the library was built before this run"
    hits = [b for n, b in frames.items() if kernel in n]
    return hits[0] if len(hits) == 1 else f"not read: {len(hits)} matches"


def exposed_spans(torch, fn, names, calls: int = 10) -> dict:
    """How long each kernel of ``names`` (short names) holds up the work
    ``fn`` runs on the card: the end of its span less the end of the span
    ahead of it (0 where it ends first), mean ms a call over ``calls``
    calls under the profiler, after a warm one.  A kernel launched to start
    early (programmatic dependent launch) hides what it does before its
    wait; this reads what it does not hide."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA),
                   key=lambda e: e.time_range.start)
    got = {n: [] for n in names}
    for prev, e in zip(spans, spans[1:]):
        name = short_kernel_name(e.name)
        if name in got:
            got[name].append(max(0, e.time_range.end - prev.time_range.end))
    return {n: (sum(v) / 1e3 / calls if v else None) for n, v in got.items()}


def px_take_operands(torch, llr, internal, phase):
    """K11's function as one ``torch.take``: (each station's [state | its
    pairs' soft bits | 0] flattened, the index of every K7 input element
    in it), from the plain version's tables (``read_idx``, ``hazard``,
    ``k7_map``), not from K11's: pair p at call phase ph reads its own soft
    bit at a hazard position, else region q of the state as the newest
    earlier pair at phase q of this dispatch wrote it, else as the dispatch
    began."""
    from nrsc5_tpu_torch.ops import decode_fm as DF
    from nrsc5_tpu_torch.ops import interleavers as IL
    s, two_p, fl = llr.shape
    pairs, call_len = two_p // 2, 2 * fl
    read_idx, n, calls = IL.p3_iv_tables(fl)
    dev = llr.device
    read_idx = torch.from_numpy(read_idx).to(dev).long()
    hazard = torch.from_numpy(IL.p3_iv_hazard(fl)).to(dev)
    k7 = torch.from_numpy(DF.channel_tables(f"px{fl}")["k7_map"]).to(
        dev).long()
    width = n + pairs * call_len + 1
    src = torch.cat([internal, llr.reshape(s, -1),
                     internal.new_zeros(s, 1)], dim=1).reshape(-1)
    p = torch.arange(pairs, device=dev)[None, :, None]
    ph = (phase.long()[:, None, None] + p) % calls  # [S, P, 1]
    c = ph * call_len + k7.clamp(min=0)  # [S, P, map_len]
    r = read_idx[c]
    q = r // call_len
    d = (ph - q) % calls
    d = torch.where(d == 0, calls, d)
    pp = p - d
    local = torch.where(pp >= 0, n + pp * call_len + r - q * call_len, r)
    local = torch.where(hazard[c], n + p * call_len + r - ph * call_len,
                        local)
    local = torch.where(k7 < 0, width - 1, local)
    idx = torch.arange(s, device=dev)[:, None, None] * width + local
    return src, idx.reshape(s * pairs, -1)


def tensors_sha256(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (each made contiguous and
    copied to the host): a fingerprint that two trees' kernels can be held
    to bit for bit in one run."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().view(np.uint8).tobytes())
    return h.hexdigest()


def bf16_fold_gate(torch, got, unrounded, tol: float):
    """K12's gate: ``got`` (the kernel's fold, float32 holding bf16 values)
    against its plain version's unrounded fold.  Each entry must be a bf16
    value, and the rounding of some value within ``tol`` of the unrounded
    one: the float32 fold was held within ``tol``, and rounding can carry
    that across a bf16 midpoint.  Returns (ok, the largest distance from
    the unrounded fold's own rounding, counts: the entries that are not
    that rounding, and the entries whose window holds more than one bf16
    value)."""
    from nrsc5_tpu_torch.ops import rcplx as rc
    nearest = rc.round_bf16(unrounded)
    lo, hi = rc.round_bf16(unrounded - tol), rc.round_bf16(unrounded + tol)
    ok = bool(torch.equal(got, rc.round_bf16(got))
              and ((got >= lo) & (got <= hi)).all())
    return ok, (got - nearest).abs().max().item(), {
        "not_nearest": int((got != nearest).sum()),
        "windows_of_two_or_more": int((lo != hi).sum()),
        "entries": got.numel()}


def bf16_steps(torch, a, b):
    """How many bf16 values lie between each pair of entries of two bf16
    tensors (+0 and -0 one value): 1 is one bf16 ulp."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def cold_start_parts(torch, wire) -> tuple[dict, list]:
    """One FM cold start of the cu8 ``wire``, replayed step by step as
    ``scan_chain_rc.cold_start_rc`` takes them, through the package's own
    functions: the ingest (K1); probe 1 (``coldstart_probe_rc``) to its
    read-back; the host argmax over each station's needle counts; probe 2
    (``bc_probe_rc``) and its read-back; the votes and
    ``chain_rc_init_carry``.  Each part is the ``time.perf_counter`` time
    from the end of the one before, after a synchronize.  Returns (parts
    in ms, the locks as ``{"offset", "first_bc", "psmi", "cfo"}`` or
    None)."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops.detect_cfo import CFO_RANGE
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
    parts = {}
    torch.cuda.synchronize()
    t = [time.perf_counter()]

    def lap(key):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[key] = (now - t[0]) * 1e3
        t[0] = now

    samples = serve.ingest(wire, "fm")
    dev = samples.device
    s = samples.shape[0]
    lap("ingest")
    samperr, angle, count = rcc.coldstart_probe_rc(samples)
    samperr_h = samperr.cpu().numpy()
    count_h = count.cpu().numpy()
    lap("probe1")
    starts = np.zeros(s, np.int32)
    cfos = np.zeros(s, np.int32)
    found = np.zeros(s, bool)
    for i in range(s):
        ci, off = np.unravel_index(np.argmax(count_h[i]), count_h[i].shape)
        if count_h[i, ci, off] < 3:
            continue
        found[i] = True
        cfos[i] = int(ci) - CFO_RANGE
        start = int(samperr_h[i]) - C.FFTCP_FM // 2 + int(off) * C.FFTCP_FM
        while start < 0:
            start += C.BLKSZ * C.FFTCP_FM
        starts[i] = start
    cfo = torch.from_numpy(cfos).to(dev)
    lap("host_argmax")
    ok, bcs, psmis = (x.cpu().numpy() for x in rcc.bc_probe_rc(
        samples, torch.from_numpy(starts).to(dev), angle, cfo))
    lap("probe2")
    locks, carries = [None] * s, {}
    for i in np.flatnonzero(found):
        good = ok[i]
        if good.sum() < 4:
            continue
        first_bc = int(np.bincount(bcs[i][good]).argmax())
        psmi = int(np.bincount(psmis[i][good]).argmax())
        if not 0 <= psmi < len(C.COMPATIBILITY_MODE):
            psmi = 1
        if psmi not in carries:
            carries[psmi] = rcc.chain_rc_init_carry(
                psmi=psmi, n_stations=s, device=dev)._replace(
                    prev_angle=angle, cfo=cfo)
        locks[i] = {"offset": int(starts[i]), "first_bc": first_bc,
                    "psmi": psmi, "cfo": int(cfos[i]),
                    "carry": rcc.ChainCarryRC(*(x[i] for x in
                                                carries[psmi]))}
    lap("votes_carry")
    parts["sum"] = sum(parts.values())
    return parts, locks


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


def sm_clock_mhz() -> float:
    """The SM clock ``nvidia-smi`` reads now, in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return float(out.strip().splitlines()[0])


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


def make_am_cold_station(index: int, seed: int = SEED,
                         echo_phase: float = AM_COLD_ECHO[2]) -> dict:
    """AM cold-start station ``index``, from its own seed (``seed`` and the
    index): MA1 for 0-7, MA3 for 8-15; AM_COLD_FRAMES frames behind a
    timing offset of 300-AM_COLD_MAX_OFFSET samples, an integer CFO of -2,
    -1, +1 or +2 bins (by index) plus a fractional part within
    ±AM_COLD_CFO_HZ, a 0.5 echo at delay 14 and phase ``echo_phase`` for
    stations 0, 1, 8 and 9, AWGN at AM_COLD_SNR_DB, cs16.  Returns the int16
    [am_cold_len(), 2] capture, the bits (p3 zero-padded to MA3's frame
    length) and the impairments."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch

    rng = np.random.default_rng([seed, 0xC0, index])
    ma3 = index >= N_STATIONS // 2
    echo = index % (N_STATIONS // 2) < 2
    sig, p1, p3, pids = _am_frames(rng, ma3, AM_COLD_FRAMES)
    if echo:
        delay, amp, _ = AM_COLD_ECHO
        sig = ch.multipath(sig, delay, amp, phase=echo_phase)
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


def make_am_cu8_decode_station(index: int) -> dict:
    """cu8 AM decode station ``index``, from its own seed: AM_DISPATCHES x
    AM_FRAMES MA1 frames whose P1 subframes carry 4 random HDC packets
    each (random P3 and PIDS), frame-aligned (the first symbol FFTCP_AM //
    2 in, bc 0), Fourier-upsampled x32 to 1.488 MS/s with its peak at
    AM_CU8_LEVEL of full scale, quantized to cu8 and queued behind the 217
    history pairs of the ÷32 cascade.  Returns the wire [434 + 32 n, 2]
    for n = am_queue_len() chain samples, the packets by frame and the P1
    bits [frames, 8, 3750]."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx import encoder_am as EAM
    from nrsc5_tpu_torch.tx.modulator_am import modulate_am
    from nrsc5_tpu_torch.tx.transport_encoder import build_p1_am_frame

    rng = np.random.default_rng([SEED, 0xC9, index])
    n = AM_DISPATCHES * AM_FRAMES
    packets, p1 = [], []
    for f in range(n):
        frame_packets, subs = [], []
        for b in range(8):
            pk = [rng.integers(0, 256, 100).astype(np.uint8).tobytes()
                  for _ in range(4)]
            frame_packets.extend(pk)
            subs.append(build_p1_am_frame(pk, 0, (f * 8 + b) % 8,
                                          ((f * 8 + b) * 4) % 64))
        packets.append(frame_packets)
        p1.append(np.stack(subs))
    p3 = rng.integers(0, 2, (n, C.P3_FRAME_LEN_MA1), dtype=np.uint8)
    mats = EAM.interleave_frames([EAM.encode_p1_am(x) for x in p1],
                                 [EAM.encode_p3_am(x, False) for x in p3],
                                 False)
    pids = np.stack([EAM.encode_pids_am(
        rng.integers(0, 2, C.PIDS_FRAME_LEN, dtype=np.uint8))
        for _ in range(8 * n)])
    ref = np.stack([EAM.am_ref_bits(b % 8, 1) for b in range(8 * n)])
    sig = modulate_am(mats, pids, ref, False)
    n_out = am_queue_len()
    # a length of small prime factors keeps the upsampling FFTs short; the
    # 217 pairs of lookahead past n_out lie in it
    buf = np.zeros(-(-(n_out + 8) // 4096) * 4096, np.complex64)
    start = C.FFTCP_AM // 2
    buf[start:start + len(sig)] = sig[:len(buf) - start]
    up = ch.upsample_exact(buf, 32)
    wire = serve.stream_wire(ch.to_cu8(up * (AM_CU8_LEVEL
                                             / np.abs(up).max())),
                             FE.AM_STAGES)
    return {"wire": wire[:FE.rc_overlap(FE.AM_STAGES) + 32 * n_out],
            "packets": packets, "p1": np.stack(p1)}


def make_am_cu8_decode_fleet() -> dict:
    """The cu8 AM decode fleet: AM_CU8_DISTINCT stations built in parallel
    by spawned worker processes, tiled over N_STATIONS (station i is
    distinct station i % AM_CU8_DISTINCT).  Returns the wire [16, L, 2],
    and the packets and P1 bits of each station."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(AM_CU8_DISTINCT, mp_context=ctx) as pool:
        built = list(pool.map(make_am_cu8_decode_station,
                              range(AM_CU8_DISTINCT)))
    tile = [built[i % AM_CU8_DISTINCT] for i in range(N_STATIONS)]
    return {"wire": np.stack([st["wire"] for st in tile]),
            "packets": [st["packets"] for st in tile],
            "p1": np.stack([st["p1"] for st in tile])}


def am_cu8_decode_run(torch, queue, device, plain: bool = False) -> dict:
    """AM_DISPATCHES ``serve.chain_step_am`` dispatches of AM_FRAMES
    frames straight from the cu8 AM queues ``queue`` [S, L, 2] (on
    ``device``), from a fresh carry, the carry handed on and each queue
    advanced by 32 wire pairs a consumed chain sample.  Returns each
    dispatch's outputs (unpacked bits), wire, carry and launches."""
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len

    s_n, cuda = queue.shape[0], device.type == "cuda"
    n_wire = FE.rc_overlap(FE.AM_STAGES) + 32 * am_buffer_len(AM_FRAMES)
    carry = scar.am_chain_rc_init_carry(n_stations=s_n, device=device)
    pos = np.zeros(s_n, np.int64)
    run = {"outs": [], "wires": [], "carries": [carry], "launches": []}
    for _ in range(AM_DISPATCHES):
        w = torch.stack([queue[i, 32 * p:32 * p + n_wire]
                         for i, p in enumerate(pos.tolist())])
        if cuda:
            torch.cuda.synchronize()
        K.reset_counts()
        out, new = serve.chain_step_am(w, carry, AM_FRAMES, device=device,
                                       plain=plain)
        if cuda:
            torch.cuda.synchronize()
        run["launches"].append({n: c for n, c in K.COUNTS.items() if c})
        pos = pos + new.offset.cpu().numpy()
        carry = new._replace(offset=torch.zeros_like(new.offset))
        for k, v in (("outs", out), ("wires", w), ("carries", carry)):
            run[k].append(v)
    return run


def am_cu8_hdc(run: dict) -> list:
    """The clean HDC packets each station's host transport delivers from a
    run of :func:`am_cu8_decode_run`, fed as the receiver feeds it (frames
    0-2 the diversity warm-up)."""
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.api.events import EventType

    n = run["outs"][0]["p1"].shape[0]
    got = [set() for _ in range(n)]

    def collect(station, ev):
        if ev.type == EventType.HDC and not ev.crc_error:
            got[station].add(bytes(ev.data))

    transports = [serve._StationTransport(i, collect, mode_fm=False)
                  for i in range(n)]
    for d, out in enumerate(run["outs"]):
        p1, p3, pids = (out[k].cpu().numpy() for k in ("p1", "p3", "pids"))
        skip = min(max(0, 3 - AM_FRAMES * d), AM_FRAMES)
        for i, tr in enumerate(transports):
            tr.consume_am(p1[i], p3[i], pids[i], skip)
    return got


def am_cu8_gate(run: dict, fleet: dict) -> dict:
    """A run of :func:`am_cu8_decode_run` against what the fleet sent:
    every P1 subframe of frames 3-5 bit-exact, and each station's clean
    HDC packets all sent (none foreign), every one of frames 3-4 among
    them, and at least 64 in all."""
    s_n = len(fleet["packets"])
    p1_ok = 0
    for d, out in enumerate(run["outs"]):
        p1 = out["p1"].cpu().numpy()
        for f in range(AM_FRAMES):
            g_f = AM_FRAMES * d + f
            if g_f >= 3:
                p1_ok += int((p1[:, f] == fleet["p1"][:, g_f]).all(
                    axis=-1).sum())
    hdc = am_cu8_hdc(run)
    exact, foreign, whole = [], [], []
    for i, got in enumerate(hdc):
        sent = {p for frame in fleet["packets"][i] for p in frame}
        exact.append(len(got & sent))
        foreign.append(len(got - sent))
        whole.append(all(p in got for f in (3, 4)
                         for p in fleet["packets"][i][f]))
    n_later = AM_DISPATCHES * AM_FRAMES - 3
    ok = (p1_ok == s_n * n_later * 8 and all(whole) and not any(foreign)
          and min(exact) >= 64)
    return {"p1_subframes_ok_frames_3_5": p1_ok,
            "p1_subframes_frames_3_5": s_n * n_later * 8,
            "hdc_exact": exact, "hdc_foreign": foreign,
            "frames_3_4_whole": whole, "hdc": hdc, "pass": ok}


def _id3_title(title: str) -> bytes:
    """An ID3v2.3 tag holding one TIT2 frame: the AAS PSD's content."""
    body = b"\x00" + title.encode("latin-1")
    frame = b"TIT2" + len(body).to_bytes(4, "big") + b"\x00\x00" + body
    n = len(frame)
    return b"ID3\x03\x00\x00" + bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F,
                                        (n >> 7) & 0x7F, n & 0x7F]) + frame


def serve_names(index: int) -> tuple[str, str]:
    """Station ``index``'s ID3 title and SIS short name."""
    letters = "".join(chr(65 + (index * k + k) % 26) for k in (1, 7, 11))
    return f"Serve Station {index} Title", f"K{letters}-FM"


def make_serve_fm_station(index: int) -> dict:
    """FM serving station ``index``, from its own seed: SERVE_LEAD_MAX or
    fewer lead blocks of a dummy frame, then SERVE_FRAMES P1 frames of 32
    random HDC packets each with the station's ID3 title in the AAS PSD
    (the port's tx/transport_encoder.py) and, on PIDS, its SIS station ID
    and short name (tx/sis_encoder.py); behind a timing offset of
    1000-3999 samples, an integer CFO of ±1..±12 bins plus a fractional part
    within ±60 Hz, at 25 dB, as the 1.488 MS/s cu8 wire.  Station
    SERVE_HOLE_STATION has SERVE_HOLE_S of zeros inserted after frame
    SERVE_HOLE_AFTER (the content resumes where it stopped).  Returns the
    interleaved uint8 wire, the packets by frame, frame 0's first chain
    sample and the hole's (first chain sample, length)."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx import sis_encoder as SE
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
    from nrsc5_tpu_torch.tx.modulator import modulate_fm
    from nrsc5_tpu_torch.tx.transport_encoder import (aas_frame,
                                                      build_p1_fm_frame)

    rng = np.random.default_rng([SEED, 0x5F, index])
    title, name = serve_names(index)
    blk, fftcp = C.P1_FM_BLOCKS, C.FFTCP_FM
    lead = int(rng.integers(1, SERVE_LEAD_MAX + 1))
    psd = aas_frame(0x5100, 0, _id3_title(title))
    sis = [SE.station_id("US", 1000 + index), SE.short_name(name)]
    pids = np.stack([sis[b % 2] for b in range(blk)])
    packets = [[rng.integers(0, 256, 280).astype(np.uint8).tobytes()
                for _ in range(32)] for _ in range(SERVE_FRAMES)]
    dummy = build_pm_matrix(build_p1_fm_frame(
        [rng.integers(0, 256, 280).astype(np.uint8).tobytes()
         for _ in range(32)], 0, 7, 0), pids)
    mats = [dummy[(blk - lead) * C.BLKSZ:]] + [
        build_pm_matrix(build_p1_fm_frame(packets[f], 0, f % 8,
                                          (f * 32) % 64, psd=psd), pids)
        for f in range(SERVE_FRAMES)]
    bc_seq = np.r_[np.arange(blk - lead, blk),
                   np.tile(np.arange(blk), SERVE_FRAMES)]
    clean = modulate_fm(np.concatenate(mats), bc_seq, 1)
    offset = int(rng.integers(1000, 4000))
    cfo_bins = int(rng.integers(1, 13)) * (1 if index % 2 else -1)
    cfo_hz = cfo_bins * C.SAMPLE_RATE_CS16_FM / C.FFT_FM \
        + float(rng.uniform(-60.0, 60.0))
    buf = np.zeros(offset + len(clean) + 3 * fftcp, np.complex64)
    buf[offset + fftcp // 2:offset + fftcp // 2 + len(clean)] = clean
    frame0 = offset + fftcp // 2 + lead * C.BLKSZ * fftcp
    hole = (0, 0)
    if index == SERVE_HOLE_STATION:
        at = frame0 + SERVE_HOLE_AFTER * blk * C.BLKSZ * fftcp
        hole = (at, int(SERVE_HOLE_S * C.SAMPLE_RATE_CS16_FM))
        buf = np.concatenate([buf[:at], np.zeros(hole[1], np.complex64),
                              buf[at:]])
    # pad to a multiple of 2^20 samples: upsample2's FFTs of a length with
    # a large prime factor take minutes
    buf = np.concatenate([buf, np.zeros(-len(buf) % (1 << 20),
                                        np.complex64)])
    noisy = ch.impair(buf, cfo_hz=cfo_hz, snr_db=SNR_DB, rng=rng)
    return {"wire": ch.to_cu8(ch.upsample2(noisy)), "packets": packets,
            "lead": lead, "offset": offset, "cfo_bins": cfo_bins,
            "frame0": frame0, "hole": hole}


def make_serve_am_station(index: int) -> dict:
    """AM serving station ``index``, from its own seed: SERVE_AM_FRAMES MA1
    frames whose P1 subframes carry 4 random HDC packets each (random P3
    and PIDS), behind a timing offset of 300-3999 samples with a fractional
    CFO within ±AM_CFO_HZ, at AM_SNR_DB, cs16 at AM_RMS of full scale and
    46511.7 S/s.  Station SERVE_HOLE_STATION has SERVE_HOLE_S of zeros
    inserted after frame SERVE_AM_HOLE_AFTER.  Returns the int16 [n, 2]
    wire, the packets by frame, frame 0's first sample and the hole's
    (first sample, length)."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx import encoder_am as EAM
    from nrsc5_tpu_torch.tx.modulator_am import modulate_am
    from nrsc5_tpu_torch.tx.transport_encoder import build_p1_am_frame

    rng = np.random.default_rng([SEED, 0x5A, index])
    n = SERVE_AM_FRAMES
    packets, p1 = [], []
    for f in range(n):
        frame_packets, subs = [], []
        for b in range(8):
            pk = [rng.integers(0, 256, 100).astype(np.uint8).tobytes()
                  for _ in range(4)]
            frame_packets.extend(pk)
            subs.append(build_p1_am_frame(pk, 0, (f * 8 + b) % 8,
                                          ((f * 8 + b) * 4) % 64))
        packets.append(frame_packets)
        p1.append(np.stack(subs))
    p3 = rng.integers(0, 2, (n, C.P3_FRAME_LEN_MA1), dtype=np.uint8)
    mats = EAM.interleave_frames([EAM.encode_p1_am(x) for x in p1],
                                 [EAM.encode_p3_am(x, False) for x in p3],
                                 False)
    pids = np.stack([EAM.encode_pids_am(
        rng.integers(0, 2, C.PIDS_FRAME_LEN, dtype=np.uint8))
        for _ in range(8 * n)])
    ref = np.stack([EAM.am_ref_bits(b % 8, 1) for b in range(8 * n)])
    sig = modulate_am(mats, pids, ref, False)
    offset = int(rng.integers(300, 4000))
    buf = np.zeros(offset + len(sig) + 3 * C.FFTCP_AM, np.complex64)
    buf[offset:offset + len(sig)] = sig
    hole = (0, 0)
    if index == SERVE_HOLE_STATION:
        at = offset + SERVE_AM_HOLE_AFTER * C.P1_AM_BLOCKS * C.BLKSZ \
            * C.FFTCP_AM
        hole = (at, int(SERVE_HOLE_S * C.SAMPLE_RATE_CS16_AM))
        buf = np.concatenate([buf[:at], np.zeros(hole[1], np.complex64),
                              buf[at:]])
    buf = ch.impair(buf, cfo_hz=float(rng.uniform(-AM_CFO_HZ, AM_CFO_HZ)),
                    snr_db=AM_SNR_DB, sample_rate=C.SAMPLE_RATE_CS16_AM,
                    rng=rng)
    return {"wire": _cs16(buf), "packets": packets, "offset": offset,
            "frame0": offset, "hole": hole}


def fleet_title(index: int) -> str:
    return f"Fleet Station {index} Title"


def fleet_mode(kind: str) -> tuple:
    """A fleet station kind's (band, mode), as the receiver keys it."""
    return {"mp1": ("fm", 1), "mp3": ("fm", 3), "ma1": ("am", False),
            "ma3": ("am", True)}[kind]


def make_fleet_station(index: int) -> dict:
    """Fleet station ``index``, from its own seed, as the 1.488 MS/s cu8 a
    tuner delivers, FLEET_FRAMES frames of content behind a timing offset
    and a fractional CFO.  MP1 (stations 0-7): P1 frames of 32 HDC audio
    packets each (FLEET_AUDIO_UNIQUE packets of a two-tone stereo mix,
    the station's own tones, encoded with the port's ``tx`` HDCEncoder and
    repeated, as tests/test_audio_batch.py:127-160 does) with the
    station's ID3 title in the AAS PSD; MP3 (8-9): random HDC packets, the
    title, random PX1 frames; both 1000-3999 samples late, within ±60 Hz,
    at SNR_DB.  MA1 (10-13) and MA3 (14-15): 4 random HDC packets a P1
    subframe, random P3 and PIDS, 300-3999 samples late, within
    ±AM_CFO_HZ, at AM_SNR_DB, Fourier-upsampled ×32 with the peak at
    AM_CU8_LEVEL of full scale.  Returns the interleaved uint8 wire, its
    air seconds, the packets sent (in order), the kind and the
    impairments."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch

    kind = FLEET_KINDS[index]
    rng = np.random.default_rng([SEED, 0xF1, index])
    n = FLEET_FRAMES
    if kind in ("mp1", "mp3"):
        from nrsc5_tpu_torch.tx.encoder import (build_pm_matrix,
                                                build_px_stream)
        from nrsc5_tpu_torch.tx.hdc_encoder import HDCEncoder
        from nrsc5_tpu_torch.tx.modulator import modulate_fm
        from nrsc5_tpu_torch.tx.transport_encoder import (aas_frame,
                                                          build_p1_fm_frame)
        psmi = 1 if kind == "mp1" else 3
        if kind == "mp1":
            t = np.arange(FLEET_AUDIO_UNIQUE * 2048) / AUDIO_FS
            x = 0.3 * np.sin(2 * np.pi * (300 + 40 * index) * t) \
                + 0.15 * np.sin(2 * np.pi * (1100 + 130 * index) * t)
            pcm = np.stack([x, 0.9 * x], -1)
            enc = HDCEncoder(channels=2, sbr=True, pns=False)
            unique = [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048])
                      for k in range(FLEET_AUDIO_UNIQUE)]
            packets = [unique[k % FLEET_AUDIO_UNIQUE]
                       for k in range(32 * n)]
        else:
            packets = [rng.integers(0, 256, 280).astype(np.uint8).tobytes()
                       for _ in range(32 * n)]
        psd = aas_frame(0x5100, 0, _id3_title(fleet_title(index)))
        pids = np.zeros((C.P1_FM_BLOCKS, C.PIDS_FRAME_LEN), np.uint8)
        mats = [build_pm_matrix(build_p1_fm_frame(
            packets[f * 32:(f + 1) * 32], 0, f % 8, (f * 32) % 64, psd=psd),
            pids) for f in range(n)]
        px = {}
        if kind == "mp3":
            fl = C.P3_FRAME_LEN_MP3_MP11
            bits = rng.integers(0, 2, (n // 2, 16, fl), dtype=np.uint8)
            px["px1_signs"] = build_px_stream(bits, fl).reshape(
                n * C.P1_FM_BLOCKS * C.BLKSZ, -1)
        clean = modulate_fm(np.concatenate(mats),
                            np.tile(np.arange(C.P1_FM_BLOCKS), n), psmi,
                            **px)
        offset = int(rng.integers(1000, 4000))
        cfo_hz = float(rng.uniform(-60.0, 60.0))
        fftcp = C.FFTCP_FM
        keep = offset + fftcp // 2 + len(clean) + 3 * fftcp
        # a length of 2^20 samples' multiples keeps upsample2's FFTs short;
        # the wire is cut back to the content and 3 symbols after it
        buf = np.zeros(-(-keep // (1 << 20)) << 20, np.complex64)
        buf[offset + fftcp // 2:offset + fftcp // 2 + len(clean)] = clean
        noisy = ch.impair(buf, cfo_hz=cfo_hz, snr_db=SNR_DB, rng=rng)
        wire = ch.to_cu8(ch.upsample2(noisy))[:4 * keep]
    else:
        from nrsc5_tpu_torch.tx import encoder_am as EAM
        from nrsc5_tpu_torch.tx.modulator_am import modulate_am
        from nrsc5_tpu_torch.tx.transport_encoder import build_p1_am_frame
        ma3 = kind == "ma3"
        packets, p1 = [], []
        for f in range(n):
            subs = []
            for b in range(8):
                pk = [rng.integers(0, 256, 100).astype(np.uint8).tobytes()
                      for _ in range(4)]
                packets.extend(pk)
                subs.append(build_p1_am_frame(pk, 0, (f * 8 + b) % 8,
                                              ((f * 8 + b) * 4) % 64))
            p1.append(np.stack(subs))
        p3_len = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
        p3 = rng.integers(0, 2, (n, p3_len), dtype=np.uint8)
        mats = EAM.interleave_frames([EAM.encode_p1_am(x) for x in p1],
                                     [EAM.encode_p3_am(x, ma3) for x in p3],
                                     ma3)
        pids = np.stack([EAM.encode_pids_am(
            rng.integers(0, 2, C.PIDS_FRAME_LEN, dtype=np.uint8))
            for _ in range(8 * n)])
        ref = np.stack([EAM.am_ref_bits(b % 8, 2 if ma3 else 1)
                        for b in range(8 * n)])
        sig = modulate_am(mats, pids, ref, ma3)
        offset = int(rng.integers(300, 4000))
        cfo_hz = float(rng.uniform(-AM_CFO_HZ, AM_CFO_HZ))
        keep = offset + len(sig) + 3 * C.FFTCP_AM
        buf = np.zeros(-(-keep // 4096) * 4096, np.complex64)
        buf[offset:offset + len(sig)] = sig
        buf = ch.impair(buf, cfo_hz=cfo_hz, snr_db=AM_SNR_DB,
                        sample_rate=C.SAMPLE_RATE_CS16_AM, rng=rng)
        up = ch.upsample_exact(buf, 32)
        wire = ch.to_cu8(up * (AM_CU8_LEVEL / np.abs(up).max()))
    return {"wire": wire, "air_s": len(wire) / 2 / C.SAMPLE_RATE_CU8,
            "packets": packets, "kind": kind, "index": index,
            "offset": offset, "cfo_hz": cfo_hz}


def make_fleet_stations() -> dict:
    """Every fleet station, built in parallel by spawned worker processes
    (numpy only; the pool ends with the call)."""
    n = len(FLEET_KINDS)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(n, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        stations = list(pool.map(make_fleet_station, range(n)))
    return {k: [st[k] for st in stations] for k in stations[0]}


class FakeTuner:
    """A fake rtl_tcp server on 127.0.0.1 (loopback only): it greets as an
    R820T, records the tuner commands, sends its capture once and holds the
    connection open until :meth:`close`.  Two threads: one sends, one reads
    the commands."""

    def __init__(self, capture: bytes):
        self.capture = capture
        self.commands = []
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(1)
        self.port = self._sock.getsockname()[1]
        self._conn = None
        self._threads = [threading.Thread(target=self._send, daemon=True)]

    def start(self):
        for t in self._threads:
            t.start()

    def _send(self):
        conn, _ = self._sock.accept()
        self._conn = conn
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))  # R820T
        reader = threading.Thread(target=self._commands, daemon=True)
        reader.start()
        self._threads.append(reader)
        view = memoryview(self.capture)
        try:
            for lo in range(0, len(view), 1 << 20):
                conn.sendall(view[lo:lo + (1 << 20)])
        except OSError:
            pass

    def _commands(self):
        buf = b""
        while True:
            try:
                data = self._conn.recv(64)
            except OSError:
                return
            if not data:
                return
            buf += data
            while len(buf) >= 5:
                self.commands.append(struct.unpack(">BI", buf[:5]))
                buf = buf[5:]

    def close(self):
        for s in (self._conn, self._sock):
            if s is None:
                continue
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        for t in self._threads:
            t.join(timeout=10)


FLEET_KERNELS = tuple(n for n in KERNELS if n != "block_carry_am")


def fleet_run(torch, st: dict) -> dict:
    """Serve the fleet stations from fake rtl_tcp tuners through
    ``RtlTcpFleet(..., modes="auto", frames_per_dispatch=2,
    hdc_factory=None, gain_db=30.0)`` into
    ``FleetAudioDecoder(n, cb, programs=(0,), k=8).wrap``, on the card,
    until every station's capture is pushed (or FLEET_DEADLINE_S), then
    ``stop()`` and the audio decoder's ``flush()``.  Returns the events,
    the walls, the launches, the plain calls, the packets each audio row
    was fed in order, the captures and the receiver."""
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.audio.fleet import FleetAudioDecoder
    from nrsc5_tpu_torch.pipeline import block_graph as BG

    n = len(st["wire"])
    events = {i: [] for i in range(n)}
    audio = FleetAudioDecoder(n, lambda s, ev: events[s].append(ev),
                              programs=(0,), k=8)
    fed = [[] for _ in range(n)]
    walls = {"prepare": [], "dispatch": []}
    submit, dec = audio._submit_locked, audio._dec
    prepare, dispatch = dec.prepare, dec.dispatch

    def record_submit(item, shed_ok=True):
        batch, lens = item
        for i in range(n):
            fed[i].extend(batch[i][:lens[i]])
        return submit(item, shed_ok)

    def timed(fn, key):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            walls[key].append(time.perf_counter() - t0)
            return out
        return run
    audio._submit_locked = record_submit
    dec.prepare, dec.dispatch = timed(prepare, "prepare"), \
        timed(dispatch, "dispatch")

    servers = [FakeTuner(w.tobytes()) for w in st["wire"]]
    for s in servers:
        s.start()
    freqs = [88.1e6 + 0.4e6 * i if fleet_mode(k)[0] == "fm"
             else 540e3 + 20e3 * i for i, k in enumerate(st["kind"])]
    plain_calls, restore = count_plain_calls()
    captures0 = len(BG.CAPTURES)
    fleet = None
    try:
        fleet = serve.RtlTcpFleet(
            [("127.0.0.1", s.port) for s in servers], freqs, audio.wrap,
            modes="auto", frames_per_dispatch=2, hdc_factory=None,
            gain_db=30.0)
        for c in fleet.clients:
            c.sock.settimeout(FLEET_SOCKET_TIMEOUT_S)
        rx = fleet.rx
        sizes = [len(w) for w in st["wire"]]
        pushed = [0] * n
        found = [None] * n
        push, assign = rx.push, rx._assign

        def counted_push(i, data):
            if isinstance(data, (bytes, bytearray)):
                pushed[i] += len(data)
            return push(i, data)

        def timed_assign(i, key):
            found[i] = time.perf_counter() - t0
            return assign(i, key)
        rx.push, rx._assign = counted_push, timed_assign
        torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        fleet.start()
        deadline = t0 + FLEET_DEADLINE_S
        while time.perf_counter() < deadline \
                and any(p < m for p, m in zip(pushed, sizes)):
            time.sleep(0.02)
        t_pushed = time.perf_counter() - t0
        fleet.stop(flush=True)
        t_stop = time.perf_counter() - t0
        audio.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
        if fleet is not None:
            fleet.stop(flush=False)
        audio.close()
        for s in servers:
            s.close()
    return {"events": events, "wall_s": wall, "stop_s": t_stop,
            "pushed_s": t_pushed, "complete": pushed == sizes,
            "discovered_s": found, "counts": dict(K.COUNTS),
            "plain_calls": plain_calls, "fed": fed, "walls": walls,
            "captures": BG.CAPTURES[captures0:], "rx": rx,
            "commands": [s.commands for s in servers]}


def fleet_gate(run: dict, st: dict) -> dict:
    """The fleet phase's gate: the modes found are the truth, in exactly 4
    groups; each station one SYNC and no LOST_SYNC or LOST_DEVICE; FM
    stations their own title and no other's, every clean HDC packet one
    they sent; AM stations at least FLEET_AM_MIN_HDC exact packets, none
    foreign; each MP1 audio station at least FLEET_MIN_AUDIO AUDIO events
    and, over its longest run of real packets (the decoder pads a lagging
    row with silence packets), more than FLEET_AUDIO_SNR_DB against the
    port's host decoder fed the same run, from its FLEET_AUDIO_SKIP-th
    packet on (tests/test_audio_batch.py:172-183's gate); the launches
    exactly the path's kernels, none plain; every capture pushed before
    the deadline."""
    from nrsc5_tpu_torch.api.events import EventType
    from nrsc5_tpu_torch.audio.hdc_decoder import HDCDecoder

    rx, events = run["rx"], run["events"]
    n = len(st["wire"])
    titles = {fleet_title(j) for j in st["index"]}
    per, ok = {}, True
    for i in range(n):
        ev = events[i]
        kinds = [e.type for e in ev]
        sent = set(st["packets"][i])
        clean = [e.data for e in ev
                 if e.type == EventType.HDC and not e.crc_error]
        got = set(clean)
        rec = {"kind": st["kind"][i], "mode": rx.station_modes[i],
               "syncs": kinds.count(EventType.SYNC),
               "lost_sync": kinds.count(EventType.LOST_SYNC),
               "lost_device": kinds.count(EventType.LOST_DEVICE),
               "hdc_exact": len(got & sent),
               "hdc_foreign": len(got - sent),
               "wire_s": st["air_s"][i],
               "discovered_s": run["discovered_s"][i]}
        good = (rec["mode"] == fleet_mode(st["kind"][i])
                and rec["syncs"] == 1
                and rec["lost_sync"] == 0 and rec["lost_device"] == 0
                and rec["hdc_foreign"] == 0)
        if fleet_mode(st["kind"][i])[0] == "fm":
            title = fleet_title(st["index"][i])
            heard = {e.title for e in ev if e.type == EventType.ID3}
            rec["title"] = title in heard
            rec["other_titles"] = sorted(heard & titles - {title})
            good &= rec["title"] and not rec["other_titles"]
        else:
            good &= rec["hdc_exact"] >= FLEET_AM_MIN_HDC
        audio = [np.asarray(e.samples) for e in ev
                 if e.type == EventType.AUDIO]
        rec["audio_events"] = len(audio)
        if st["kind"][i] == "mp1":
            fed = run["fed"][i]
            # the longest run of real packets, and its AUDIO frames
            best, lo = (0, 0), 0
            for k in range(len(fed) + 1):
                if k == len(fed) or not fed[k]:
                    if k - lo > best[1] - best[0]:
                        best = (lo, k)
                    lo = k + 1
            a, b = best
            rec["audio_run"] = [a, b]
            snr = None
            if b - a > FLEET_AUDIO_SKIP and len(audio) >= b:
                host = HDCDecoder()
                ref = np.concatenate([host.decode(p).reshape(-1)
                                      for p in fed[a:b]])
                got_pcm = np.concatenate(audio[a:b])
                skip = FLEET_AUDIO_SKIP * 4096
                x = ref[skip:].astype(np.float64)
                e = got_pcm[skip:].astype(np.float64) - x
                snr = float(10 * np.log10((x ** 2).sum()
                                          / max((e ** 2).sum(), 1e-30)))
            rec["snr_db"] = snr
            good &= (len(audio) >= FLEET_MIN_AUDIO and b - a
                     >= FLEET_MIN_AUDIO and snr is not None
                     and snr > FLEET_AUDIO_SNR_DB)
        rec["pass"] = bool(good)
        ok &= good
        per[i] = rec
    launched = {k for k, c in run["counts"].items() if c}
    groups = sorted([list(k), g.n_stations]
                    for k, g in zip(rx._keys, rx._groups))
    launches_ok = launched == set(FLEET_KERNELS)
    groups_ok = len(rx._groups) == len(set(st["kind"]))
    return {"stations": per, "groups": groups, "groups_ok": groups_ok,
            "launches_ok": launches_ok,
            "launched_missing": sorted(set(FLEET_KERNELS) - launched),
            "launched_extra": sorted(launched - set(FLEET_KERNELS)),
            "plain_calls_on_kernel_path": run["plain_calls"],
            "complete": run["complete"], "stations_ok": bool(ok),
            "pass": bool(ok and launches_ok and groups_ok and run["complete"]
                         and not run["plain_calls"]
                         and run["wall_s"] <= FLEET_DEADLINE_S)}


def golden_sig_table() -> bytes:
    """The golden capture's SIG table: one data service carrying a LOT
    component on GOLDEN_SIG_PORT (support/make_capture.py's ``sig_table``;
    reference SIG record layout: src/output.c:493-625)."""
    buf = bytearray([0x41, 0x01, 0x00, 0x00])  # data service #1
    name = b"\x00Traffic"
    buf += bytes([0x69, 1 + len(name)]) + name
    comp = bytes([0x00, GOLDEN_SIG_PORT & 0xFF, GOLDEN_SIG_PORT >> 8, 0x00,
                  0x00, 3, 0, 0])  # AASType.LOT
    comp += (0x4F328CA0).to_bytes(4, "little")  # MIMEType.PNG
    buf += bytes([0x67, 1 + len(comp)]) + comp
    return bytes(buf)


def golden_lot_fragment() -> bytes:
    """The golden capture's single complete-file LOT fragment
    (support/make_capture.py's ``lot_fragment``; reference:
    src/output.c:627-760), expiring 2027-06-15 12:30 UTC."""
    meta = bytearray(16)
    meta[0:4] = (1).to_bytes(4, "little")  # LOT header version 1
    year, mon, mday, hour, minute = 2027, 6, 15, 12, 30
    meta[4] = ((hour & 0x3) << 6) | minute
    meta[5] = (mday << 3) | (hour >> 2)
    meta[6] = ((year & 0xF) << 4) | mon
    meta[7] = year >> 4
    meta[8:12] = len(GOLDEN_LOT_DATA).to_bytes(4, "little")
    meta[12:16] = (0x4F328CA0).to_bytes(4, "little")
    meta += GOLDEN_LOT_NAME.encode()
    hdr = bytearray([8 + len(meta), 0, GOLDEN_LOT_ID & 0xFF,
                     GOLDEN_LOT_ID >> 8])
    hdr += (0).to_bytes(4, "little")  # fragment seq 0
    return bytes(hdr) + bytes(meta) + GOLDEN_LOT_DATA


def make_golden_capture(seed: int = GOLDEN_SEED) -> np.ndarray:
    """The golden FM capture, support/make_capture.py's recipe built with
    the port's ``tx`` copy (that script needs JAX): ``seed`` (GOLDEN_SEED
    by default), 2 lead blocks of a dummy frame, GOLDEN_FRAMES P1 frames of
    32 HDC packets of a tone mix each, the ID3 title GOLDEN_TITLE (frames 0
    and 2), the SIG table (frame 0) and the LOT file GOLDEN_LOT_NAME (frame
    1) in the AAS PSD, 4 trailing blocks; amplitude 0.15, a 1000-sample
    offset, 100 Hz CFO, 25 dB, upsampled ×2 to the 1.488 MS/s cu8 wire.
    Returns the wire bytes, uint8 [n]."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
    from nrsc5_tpu_torch.tx.hdc_encoder import HDCEncoder
    from nrsc5_tpu_torch.tx.modulator import modulate_fm
    from nrsc5_tpu_torch.tx.transport_encoder import (aas_frame,
                                                      build_p1_fm_frame)

    rng = np.random.default_rng(seed)
    n_frames = GOLDEN_FRAMES
    t = np.arange(n_frames * 32 * C.AUDIO_FRAME_SAMPLES) \
        / C.SAMPLE_RATE_AUDIO
    land = 0.3 * np.sin(2 * np.pi * 440 * t) \
        + 0.15 * np.sin(2 * np.pi * 1320 * t) \
        + 0.1 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 2 * t)
    pcm = np.stack([land, 0.8 * land], axis=-1)
    enc = HDCEncoder(2)
    hdc = [enc.encode_frame(pcm[i * 2048:(i + 1) * 2048])
           for i in range(n_frames * 32)]
    title = _id3_title(GOLDEN_TITLE)
    psd = [aas_frame(0x5100, 0, title) + aas_frame(0x20, 0,
                                                    golden_sig_table()),
           aas_frame(GOLDEN_SIG_PORT, 1, golden_lot_fragment()),
           aas_frame(0x5100, 2, title)]
    frames = [build_p1_fm_frame(hdc[f * 32:(f + 1) * 32], 0, f % 8,
                                (f * 32) % 64, psd[f])
              for f in range(n_frames)]
    pids = np.zeros((16, 80), np.uint8)
    mats = [build_pm_matrix(fr, pids) for fr in frames]
    dummy = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8), pids)
    matrix = np.concatenate([dummy[14 * 32:]] + mats + [dummy[:4 * 32]])
    bc_seq = np.concatenate([np.arange(14, 16),
                             np.tile(np.arange(16), n_frames),
                             np.arange(4)])
    sig = modulate_fm(matrix, bc_seq, 1, amplitude=0.15)
    sig = ch.impair(sig, sample_offset=1000, cfo_hz=100.0, snr_db=25.0,
                    rng=rng)
    return ch.to_cu8(ch.upsample2(sig))


def am_capture(rng, n_frames: int, ma3: bool = False,
               rdbi_from: int | None = None):
    """tests/capture_helpers.py's ``build_am_capture`` built with the port's
    ``tx`` copy: ``n_frames`` frames of MA1, or of MA3 with ``ma3``, four
    random 90-byte HDC packets a P1 subframe, random P3 and PIDS, at the
    chain's 46511.7 S/s from sample 0, drawn from ``rng``; with
    ``rdbi_from``, the reference subcarrier sets rdbi from that frame on
    (MA1: the receiver zeroes the lower PIDS stream and delivers no P3).
    Returns the complex64 signal and the packets as (frame, [bytes]) a
    subframe."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import encoder_am as EAM
    from nrsc5_tpu_torch.tx.modulator_am import modulate_am
    from nrsc5_tpu_torch.tx.transport_encoder import build_p1_am_frame

    packets = []
    p1_bits = np.zeros((n_frames, 8, C.P1_FRAME_LEN_AM), np.uint8)
    for f in range(n_frames):
        for sub in range(8):
            pk = [rng.integers(0, 256, 90).astype(np.uint8).tobytes()
                  for _ in range(4)]
            packets.append((f, pk))
            p1_bits[f, sub] = build_p1_am_frame(
                pk, 0, pdu_seq=sub, seq=((f * 8 + sub) * 4) % 64)
    t3 = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    p3 = rng.integers(0, 2, (n_frames, t3)).astype(np.uint8)
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(p1_bits[f]) for f in range(n_frames)],
        [EAM.encode_p3_am(p3[f], ma3) for f in range(n_frames)], ma3)
    pids = np.stack([EAM.encode_pids_am(
        rng.integers(0, 2, 80).astype(np.uint8))
        for _ in range(n_frames * 8)])
    ref = np.stack([EAM.am_ref_bits(
        b % 8, C.SERVICE_MODE_MA3 if ma3 else C.SERVICE_MODE_MA1,
        rdbi=int(rdbi_from is not None and b // 8 >= rdbi_from))
        for b in range(n_frames * 8)])
    return modulate_am(mats, pids, ref, ma3), packets


def make_session_am_capture(rdbi_from: int | None = None,
                            ma3: bool = False):
    """:func:`am_capture` of SESSION_AM_FRAMES frames from seed SEED,
    quantized to cs16 at AM_RMS of full scale.  Returns the int16 [n, 2]
    wire and the packets."""
    sig, packets = am_capture(np.random.default_rng(SEED),
                              SESSION_AM_FRAMES, ma3, rdbi_from)
    return _cs16(sig), packets


def make_drift_am_capture(ppm: float):
    """tests/test_am_multipath.py:136-160's capture on the port's ``tx``:
    12 MA1 frames of :func:`am_capture` from seed 0xD81F, resampled by a
    sample clock ``ppm`` parts per million off (``channel.clock_drift``),
    then 30 dB AWGN from the same generator.  Returns the complex64 signal
    and the packets."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch
    rng = np.random.default_rng(0xD81F)
    sig, packets = am_capture(rng, DRIFT_AM_FRAMES)
    sig = ch.clock_drift(np.asarray(sig, np.complex64), ppm)
    return ch.impair(sig, snr_db=30.0, sample_rate=C.SAMPLE_RATE_CS16_AM,
                     rng=rng), packets


def make_audio_stream(kind: str) -> list:
    """AUDIO_PACKETS HDC packets of one program, from the stream's own seed,
    encoded with the port's ``tx`` copy: ``steady`` is stereo SBR content as
    bench.py:675-684 makes it (two tones and noise); ``transient`` a quiet
    stereo tone and band noise with sharp bursts, as
    tests/test_audio_batch.py:21-46 makes it, so that EIGHT_SHORT windows
    and transient SBR grids occur; ``mono`` one channel of a tone and band
    noise."""
    from numpy.fft import irfft, rfft

    from nrsc5_tpu_torch.tx.hdc_encoder import HDCEncoder

    rng = np.random.default_rng([SEED, 0xAD, AUDIO_STREAMS.index(kind)])
    n = AUDIO_PACKETS * 2048
    t = np.arange(n) / AUDIO_FS
    channels = 1 if kind == "mono" else 2
    if kind == "steady":
        sig = (0.35 * np.sin(2 * np.pi * 240 * t)
               + 0.15 * np.sin(2 * np.pi * 2000 * t)
               + 0.05 * rng.standard_normal(n))
        pcm = np.stack([sig, sig * 0.9], -1)
    else:
        s2 = rfft(rng.standard_normal(n))
        f = np.arange(len(s2)) * AUDIO_FS / n
        sig = 0.4 * np.sin(2 * np.pi * (411 if kind == "mono" else 337)
                           * t) \
            + 0.1 * irfft(np.where((f > 4000) & (f < 13000), s2, 0), n)
        pcm = np.stack([sig, sig * 0.85], -1)[:, :channels] * 0.7
        if kind == "transient":
            pcm *= 0.1
            tt = np.arange(256)
            burst = (np.sin(2 * np.pi * 2400 * tt / AUDIO_FS)
                     + 0.5 * np.sin(2 * np.pi * 3500 * tt / AUDIO_FS + 1.0)) \
                * np.hanning(256)
            for hit in range(2, AUDIO_PACKETS, 3):
                pos = hit * 2048 + 700
                pcm[pos:pos + 256] += \
                    (0.7 * burst / np.abs(burst).max())[:, None]
    enc = HDCEncoder(channels=channels, sbr=True, pns=False)
    return [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048])
            for k in range(AUDIO_PACKETS)]


def make_header_batch(header: str):
    """One stereo program's AUDIO_PACKETS packets of a tone over noise with
    two sharp bursts under the SBR header ``AUDIO_HEADERS[header]``,
    encoded with the port's ``tx`` copy and prepared by a one-program
    decoder on the CPU after one batch of the same packets, as
    tests/test_torch_kernels.py's ``_audio_batch`` makes them: (the
    stage's spectrum caps, numpy inputs, numpy state)."""
    from nrsc5_tpu_torch.audio import sbr as SBR
    from nrsc5_tpu_torch.audio.batch import BatchedAudioDecoder
    from nrsc5_tpu_torch.tx.hdc_encoder import HDCEncoder

    n = AUDIO_PACKETS
    rng = np.random.default_rng([SEED, 0x16C, sorted(AUDIO_HEADERS).index(
        header)])
    t = np.arange(n * 2048) / AUDIO_FS
    x = 0.04 * np.sin(2 * np.pi * 500 * t) + 0.01 * rng.standard_normal(
        n * 2048)
    tt = np.arange(256)
    burst = np.sin(2 * np.pi * 2400 * tt / AUDIO_FS) * np.hanning(256)
    for k in (2, 5):
        x[k * 2048 + 700:k * 2048 + 956] += 0.7 * burst / np.abs(burst).max()
    pcm = np.clip(np.stack([x, 0.9 * x], -1), -1, 1)
    enc = HDCEncoder(channels=2, sbr=True, pns=False,
                     sbr_header=SBR.SbrHeader(**AUDIO_HEADERS[header]))
    pkts = [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048]) for k in range(n)]
    dec = BatchedAudioDecoder(1, device="cpu")
    dec.decode([pkts])
    stage, inp, smooth, key = dec.prepare([pkts])
    dec._reconcile_state(smooth, key)
    return ((stage.cap_long, stage.cap_short), inp,
            {k: v.numpy() for k, v in dec._state.items()})


def tile_lanes(torch, header: str, batch, lanes: int, dev):
    """``make_header_batch(header)``'s batch as the header's device stage
    on ``dev``, its inputs and state with the lanes tiled to ``lanes``."""
    from nrsc5_tpu_torch.audio import sbr as SBR
    from nrsc5_tpu_torch.audio.batch import device_inputs
    from nrsc5_tpu_torch.audio.stage import DeviceStage
    (cap_long, cap_short), inp, state = batch
    hdr = SBR.SbrHeader(**AUDIO_HEADERS[header])
    stage = DeviceStage(SBR.derive_tables(hdr), SBR.LIM_GAINS[
        hdr.limiter_gains], interpol=bool(hdr.interpol_freq),
        smooth=not hdr.smoothing_mode, cap_long=cap_long,
        cap_short=cap_short, device=dev)
    reps = lanes // inp["spec_long"].shape[0]

    def tile(a):
        return np.ascontiguousarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1)))
    return (stage,
            device_inputs({k: tile(v) for k, v in inp.items()}, dev),
            {k: torch.from_numpy(tile(v)).to(dev) for k, v in state.items()})


def k16c_bound(n: int, kp: int, m: int, n_hi: int, n_q: int,
               smooth: bool) -> tuple[float, str]:
    """K16c's least time: x_high, xl, the envelope inputs, maps and noise
    table read, X written (and with smoothing the 4-slot histories in and
    out) once; operations ~160 an (envelope, bin), ~60 a (slot, bin)."""
    slots = 32  # a packet's
    return bound(n * kp * slots * m * 8 + n * kp * slots * 64 * 4
                 + n * kp * (slots * (5 + 8) + 10 + 5 * (n_hi * 5 + n_q * 4))
                 + m * 44 + 512 * 8 + 2 * n * kp * slots * 64 * 4
                 + (4 * n * 4 * 64 * 4 if smooth else 0),
                 n * kp * (5 * m * 160 + slots * m * 60))


def registers_of(lines, kernel: str):
    """The registers ptxas gave ``kernel`` (a part of its mangled name)
    in a source's ptxas lines, or why they were not read."""
    if lines is None:
        return "not read: the library was built before this run"
    name, hits = None, []
    for ln in lines:
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
        elif "registers" in ln and name is not None and kernel in name:
            hits.append(int(ln.split("Used")[1].split()[0]))
    return hits[0] if len(hits) == 1 else f"not read: {len(hits)} matches"


def host_audio(packets: list) -> np.ndarray:
    """The port's host decoder fed the packet sequence AUDIO_DISPATCHES
    times over, as every dispatch feeds it: int16 [D * K * 2048, 2]."""
    from nrsc5_tpu_torch.audio.hdc_decoder import HDCDecoder
    dec = HDCDecoder()
    return np.concatenate([dec.decode(p).reshape(-1, 2)
                           for _ in range(AUDIO_DISPATCHES)
                           for p in packets])


def serve_launches(mode: str, blocks: int = 0) -> dict:
    """The launches of one of the receiver's dispatches: FM's steady
    dispatch of 32 blocks (K1, then K2, the DFT kernel and K4 a block, K4
    taking K5's carry step, and K5 once ahead, then K6, K7 and K8 for P1
    and PIDS, K6 for P1 as two kernels) or, with ``blocks``, its PIDS-only
    alignment dispatch; AM's steady dispatch of 2 frames."""
    if mode == "am":
        return AM_LAUNCHES
    n = blocks or DISPATCH_BLOCKS
    fec = 1 if blocks else 2
    return {"halfband_cu8": 1, "demod_fold": n, "dft_bf16": n,
            "sync_block": n, "block_carry": 1,
            "fec_gather": 1 if blocks else 3,
            "viterbi_k7": fec, "fec_epilogue": fec}


def serve_run(torch, fleet: dict, mode: str, device, graph: bool = True):
    """Drive ``MultiStationReceiver`` over the fleet's wires as a live
    fleet would: cold_start=True, frames_per_dispatch=2, depth=2, every
    station's raw bytes pushed in turn in odd-sized pieces, then flush.
    ``graph=False`` runs the steady dispatches' block loops eagerly.
    Returns the events by station, the wall of push through flush, the
    record (the launch counts of each dispatch, alignment and relock
    probe; each relock probe's lock point and, after flush, each
    station's queue head, as chain samples into its stream) and the
    receiver."""
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    n = len(fleet["wire"])
    events = {i: [] for i in range(n)}
    kw = {"input_format": "cu8"} if mode == "fm" \
        else {"input_format": "cs16", "mode": "am"}
    rx = serve.MultiStationReceiver(
        n, lambda st, ev: events[st].append(ev), frames_per_dispatch=2,
        depth=2, cold_start=True, device=device, **kw)
    record = {"dispatch": [], "align": [], "relock": []}

    def head(i):
        # the chain sample at the head of station i's queue
        return (rx._pushed[i] - rx._sizes[i]) // rx._rate

    def counted(kind, fn):
        def run(*args):
            before = dict(K.COUNTS)
            locking = kind == "relock" and rx._relocking[args[0]]
            out = fn(*args)
            locked = locking and not rx._relocking[args[0]]
            record[kind].append((
                {k: c - before[k] for k, c in K.COUNTS.items()
                 if c != before[k]},
                args[1:] if kind == "align"
                else (args[0], head(args[0])) if locked else None))
            return out
        return run
    rx._dispatch = counted("dispatch", rx._dispatch)
    rx._align_station = counted("align", rx._align_station)
    rx._try_relock = counted("relock", rx._try_relock)
    step = serve.chain_step if mode == "fm" else serve.chain_step_am
    if not graph:
        setattr(serve, step.__name__,
                lambda *a, **k: step(*a, **{**k, "graph": False}))
    wires = [w.tobytes() for w in fleet["wire"]]
    piece = 2 * SERVE_PUSH + 1
    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        for lo in range(0, max(map(len, wires)), piece):
            for i, w in enumerate(wires):
                if lo < len(w):
                    rx.push(i, w[lo:lo + piece])
        rx.flush()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(serve, step.__name__, step)
    record["heads"] = [head(i) for i in range(n)]
    return events, wall, dict(K.COUNTS), record, rx


def serve_frames(fleet: dict, i: int, mode: str, record: dict):
    """The frames station ``i``'s stream can release whole, as [first,
    last] runs, and the frame its end cuts (or None), from the lock points
    and the final queue head that ``record`` holds: after each lock, from
    the first frame that starts at or after it (AM: behind the three
    frames of the diversity warm-up) to the last frame before the next
    lock's hole, or (the last lock) to the last frame wholly inside the
    samples the dispatches consumed, at most the stream's last frame.  AM
    pushes 8 subframes a frame with an output advance after each, so
    flush's four advances release only part of that last frame: it is the
    cut frame, and the run ends before it.  A position rounds to the
    nearest block of the stream's content (the hole taken out)."""
    from nrsc5_tpu_torch import constants as C
    fm = mode == "fm"
    blk = C.P1_FM_BLOCKS if fm else C.P1_AM_BLOCKS
    block_len = C.BLKSZ * (C.FFTCP_FM if fm else C.FFTCP_AM)
    n_frames = SERVE_FRAMES if fm else SERVE_AM_FRAMES
    at, length = (int(v) for v in fleet["hole"][i])

    def block(pos):
        if length and pos >= at:
            pos = max(at, pos - length)
        return round((pos - int(fleet["frame0"][i])) / block_len)

    locks = [lk[1] for _, lk in record["relock"]
             if lk is not None and lk[0] == i]
    runs, cut = [], None
    for k, pos in enumerate(locks):
        first = -(-block(pos) // blk) + (0 if fm else 3)
        if k + 1 < len(locks):
            last = block(at) // blk - 1
        else:
            last = min(block(record["heads"][i]) // blk - 1, n_frames - 1)
            if not fm:
                cut, last = last, last - 1
        if last >= first:
            runs.append([first, last])
    return runs, cut


def serve_gate(events: dict, fleet: dict, mode: str, counts: dict,
               record: dict) -> dict:
    """The serving phase's gate, from the events, the transmitted packets
    and the launch record.  Every station: its first SYNC; every clean HDC
    packet one it transmitted; every frame of :func:`serve_frames`' runs
    delivered whole (every packet of it), its cut frame (AM) in part at
    least, and no frame up to the last run's end delivered in part; FM
    its ID3 title and SIS name.  The station with the hole:
    LOST_SYNC, then SYNC, and two runs; no other station a LOST_SYNC.  The
    launch counts: every steady dispatch exactly :func:`serve_launches`,
    every alignment its own, every relock probe a cold start's, and
    nothing launched outside them."""
    from nrsc5_tpu_torch.api.events import EventType
    n = len(fleet["wire"])
    per = {}
    ok = True
    for i in range(n):
        ev = events[i]
        kinds = [e.type for e in ev]
        tx = fleet["packets"][i]
        where = {p: f for f, pk in enumerate(tx) for p in pk}
        rx = {e.data for e in ev if e.type == EventType.HDC
              and not e.crc_error}
        foreign = len(rx - set(where))
        got = {}
        for p in rx & set(where):
            got[where[p]] = got.get(where[p], 0) + 1
        frames = sorted(got)
        whole = {f for f in frames if got[f] == len(tx[f])}
        runs = []
        for f in frames:
            if runs and f == runs[-1][1] + 1:
                runs[-1][1] = f
            else:
                runs.append([f, f])
        want, cut = serve_frames(fleet, i, mode, record)
        missing = [f for lo, hi in want for f in range(lo, hi + 1)
                   if f not in whole] + ([cut] if cut is not None
                                         and cut not in got else [])
        tail = want[-1][1] if want else -1
        hole = i == SERVE_HOLE_STATION
        lost = kinds.count(EventType.LOST_SYNC)
        syncs = kinds.count(EventType.SYNC)
        st = {"syncs": syncs, "lost_sync": lost, "packets": len(rx),
              "foreign_packets": foreign, "frame_runs": runs,
              "releasable_runs": want, "cut_frame": cut,
              "frames_missing": missing,
              "partial_frames": [f for f in frames
                                 if f not in whole and f <= tail]}
        good = (syncs >= 1 and foreign == 0 and not missing
                and not st["partial_frames"])
        if hole:
            good &= (lost >= 1 and syncs >= 2
                     and kinds.index(EventType.LOST_SYNC)
                     < len(kinds) - 1 - kinds[::-1].index(EventType.SYNC)
                     and len(want) == 2)
        else:
            good &= lost == 0 and len(want) == 1
        if mode == "fm":
            title, name = serve_names(i)
            st["title"] = title in {e.title for e in ev
                                    if e.type == EventType.ID3}
            st["name"] = name in {e.name for e in ev
                                  if e.type == EventType.STATION_NAME}
            good &= st["title"] and st["name"]
        st["pass"] = bool(good)
        ok &= good
        per[i] = st
    # launches: each dispatch, alignment and probe as the path has it
    dispatch_ok = all(d == serve_launches(mode)
                      for d, _ in record["dispatch"])
    align_ok = all(d == serve_launches(mode, a[0])
                   for d, a in record["align"])
    probe = AM_PROBE_LAUNCHES if mode == "am" else None
    relock_ok = True
    for d, _ in record["relock"]:
        if not d:
            continue  # no probe: too few samples queued, or a cooldown
        if mode == "am":
            k = d.get("sync_am_block", 0)
            relock_ok &= d == {name: c * k for name, c in probe.items()}
        else:
            k4 = d.get("sync_block", 0)
            relock_ok &= d == {"halfband_cu8": 1, "coarse_timing": 2,
                               "demod_fold": 1 + k4, "dft_bf16": 1 + k4,
                               "cfo_scan": 1,
                               **({"sync_block": 1} if k4 else {})}
    total = {}
    for kind in ("dispatch", "align", "relock"):
        for d, _ in record[kind]:
            for name, c in d.items():
                total[name] = total.get(name, 0) + c
    launches_ok = dispatch_ok and align_ok and relock_ok \
        and total == {k: c for k, c in counts.items() if c}
    return {"stations": per, "first_syncs": sum(
        st["syncs"] >= 1 for st in per.values()),
        "dispatches": len(record["dispatch"]),
        "alignments": [a[0] for _, a in record["align"]],
        "relock_probes": sum(1 for d, _ in record["relock"] if d),
        "launches_total": total, "launches_dispatch_ok": dispatch_ok,
        "launches_align_ok": align_ok, "launches_relock_ok": relock_ok,
        "launches_ok": launches_ok, "stations_ok": bool(ok),
        "pass": bool(ok and launches_ok)}


# the kernels each session phase launches: FM from cu8 (K1 a push; the
# cold start's K9, K2, the DFT kernel, K10 and K4; the receiver's K2, the
# DFT kernel, K4, K5, K6, K7 and K8), AM from cs16 (the cold start's K14,
# K12 and K13; the receiver's K12, K13, K15, K7 at K=9 and K8)
SESSION_FM_KERNELS = ("halfband_cu8", "coarse_timing", "demod_fold",
                      "dft_bf16", "cfo_scan", "sync_block", "block_carry",
                      "fec_gather", "viterbi_k7", "fec_epilogue")
SESSION_AM_KERNELS = ("am_tone", "am_coarse", "am_cfo_step", "am_fold",
                      "sync_am_block", "am_gather",
                      "viterbi_k9", "fec_epilogue")


def timed_cold_starts(torch, module, name: str):
    """Wrap ``module.name`` (a cold start) so that each call's wall, from a
    synchronize before it to one after it, is appended to the returned
    list.  Returns (walls in ms, a function that puts the original
    back)."""
    walls, orig = [], getattr(module, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(module, name, timed)
    return walls, lambda: setattr(module, name, orig)


def session_fm_run(torch, capture: Path, out: Path) -> dict:
    """The golden drive: the port's CLI (``cli.main``, the default device)
    on the golden capture with raw PCM, the AAS files, the HDC dump and the
    tee written under ``out``.  Returns the "nrsc5-tpu" log lines, the wall
    of the call, the cold starts' walls, the kernels launched and the plain
    versions called."""
    import logging
    from nrsc5_tpu_torch import cli
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
    out.mkdir(parents=True, exist_ok=True)
    (out / "aas").mkdir(exist_ok=True)
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    log, keep = logging.getLogger("nrsc5-tpu"), Keep()
    log.addHandler(keep)
    log.setLevel(logging.INFO)
    cold, untime = timed_cold_starts(torch, rcc, "cold_start_rc")
    plain_calls, restore = count_plain_calls()
    try:
        torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        cli.main(["-r", str(capture), "0", "0", "-o", str(out / "raw.pcm"),
                  "--dump-aas-files", str(out / "aas"), "--dump-hdc",
                  str(out / "dump.hdc"), "-w", str(out / "tee.cu8")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: c for k, c in K.COUNTS.items() if c}
    finally:
        restore()
        untime()
        log.removeHandler(keep)
    return {"lines": lines, "wall_s": wall, "cold_start_ms": cold,
            "launches": counts, "plain_calls": plain_calls}


def session_fm_gate(run: dict, capture: Path, out: Path) -> dict:
    """session_fm's gate: "Synchronized" once, the golden title and a LOT
    file logged, the dumped LOT file's bytes, at least 32 packets of raw
    PCM with a peak above 3000, an HDC dump above 5000 bytes, the tee equal
    to the capture, every kernel of the path launched and no other, no
    plain version called."""
    lines = run["lines"]
    lot = out / "aas" / GOLDEN_LOT_NAME
    pcm = np.fromfile(out / "raw.pcm", np.int16)
    checks = {
        "synchronized": sum(ln.startswith("Synchronized") for ln in lines),
        "title": sum(ln == f"Title: {GOLDEN_TITLE}" for ln in lines),
        "lot_logged": any(ln.startswith("LOT file") for ln in lines),
        "lot_bytes_equal": lot.exists()
        and lot.read_bytes() == GOLDEN_LOT_DATA,
        "pcm_samples": int(pcm.size),
        "pcm_peak": int(np.abs(pcm.astype(np.int32)).max()) if pcm.size
        else 0,
        "hdc_dump_bytes": (out / "dump.hdc").stat().st_size,
        "tee_equal": (out / "tee.cu8").read_bytes()
        == capture.read_bytes(),
        "kernels_launched": sorted(run["launches"]),
    }
    ok = (checks["synchronized"] == 1 and checks["title"] >= 1
          and checks["lot_logged"] and checks["lot_bytes_equal"]
          and checks["pcm_samples"] >= 2 * 2048 * 32
          and checks["pcm_peak"] > 3000
          and checks["hdc_dump_bytes"] > 5000 and checks["tee_equal"]
          and set(run["launches"]) == set(SESSION_FM_KERNELS)
          and not run["plain_calls"])
    return {**checks, "pass": ok}


def session_am_run(torch, wire: np.ndarray, packets: list) -> dict:
    """One MA1 station through ``NRSC5.open_pipe(..., MODE_AM)`` on the
    default device: the cs16 wire pushed SESSION_AM_PUSH samples at a time
    as interleaved int16, then ``flush``.  Returns the SYNC count, the
    clean HDC packets that are transmitted ones, the wall, the cold
    starts' walls, the kernels launched and the plain versions called."""
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.api.session import MODE_AM, NRSC5
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
    events = []
    cold, untime = timed_cold_starts(torch, scar, "cold_start_am_rc")
    plain_calls, restore = count_plain_calls()
    try:
        torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        radio = NRSC5.open_pipe(events.append, MODE_AM,
                                hdc_decoder_factory=None)
        for lo in range(0, len(wire), SESSION_AM_PUSH):
            radio.pipe_samples_cs16(wire[lo:lo + SESSION_AM_PUSH]
                                    .reshape(-1))
        radio.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: c for k, c in K.COUNTS.items() if c}
    finally:
        restore()
        untime()
    clean = {e.data for e in events
             if e.type.name == "HDC" and not e.crc_error}
    sent = {bytes(p) for _, pk in packets for p in pk}
    return {"syncs": sum(e.type.name == "SYNC" for e in events),
            "lost_syncs": sum(e.type.name == "LOST_SYNC" for e in events),
            "hdc_exact": len(clean & sent), "hdc_foreign": len(clean - sent),
            "wall_s": wall, "cold_start_ms": cold, "launches": counts,
            "plain_calls": plain_calls}


BLOCK_PX_CYCLES = 2  # interleaver-IV cycles of receiver_fm's PX stations
BLOCK_PX_LEAD = 2  # their lead blocks (block counts 14, 15)
# the kernels of the per-block paths on the card: FM K6, K7, K8 (and K11
# in the PX modes); AM K15 (a frame), K15's PIDS-only launch (a block), K7
# at K=9 and K8
BLOCK_FM_KERNELS = ("fec_gather", "viterbi_k7", "fec_epilogue")
BLOCK_PX_KERNELS = BLOCK_FM_KERNELS + ("px_deinterleave",)
BLOCK_AM_KERNELS = ("am_gather", "am_gather_pids", "viterbi_k9",
                    "fec_epilogue")


def make_block_px_station(psmi: int) -> dict:
    """One station of ``psmi`` (MP3 or MP11) for the per-block receiver:
    BLOCK_PX_LEAD lead blocks, then BLOCK_PX_CYCLES interleaver-IV cycles
    (2 P1 frames each) of random P1 frames, PIDS words and PX1 (and MP11's
    PX2) frames, 2 trail blocks, at SNR_DB, complex64 at the chain rate
    (tests/test_l1_fm.py:78 and :128's recipe on the port's ``tx``).
    Returns the signal and the transmitted bits: p1 [F, 146176], px1 [C,
    16, fl] and px2 (or None)."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.pipeline.scan_chain import px_frame_lens
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix, build_px_stream
    from nrsc5_tpu_torch.tx.modulator import modulate_fm

    rng = np.random.default_rng([SEED, psmi, 21])
    n_frames = 2 * BLOCK_PX_CYCLES
    p1 = rng.integers(0, 2, (n_frames, C.P1_FRAME_LEN_FM), dtype=np.uint8)
    pids = rng.integers(0, 2, (n_frames + 1, 16, C.PIDS_FRAME_LEN),
                        dtype=np.uint8)
    mats = [build_pm_matrix(p1[f], pids[f]) for f in range(n_frames)]
    dummy = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM, dtype=np.uint8), pids[-1])
    lead = BLOCK_PX_LEAD
    matrix = np.concatenate([dummy[(16 - lead) * 32:]] + mats
                            + [dummy[:2 * 32]])
    bc_seq = np.concatenate([np.arange(16 - lead, 16),
                             np.tile(np.arange(16), n_frames),
                             np.arange(2)])
    out = {"p1": p1, "px2": None}
    signs = {}
    for key, fl in zip(("px1", "px2"), px_frame_lens(psmi)):
        if not fl:
            continue
        out[key] = rng.integers(0, 2, (BLOCK_PX_CYCLES, 16, fl),
                                dtype=np.uint8)
        stream = build_px_stream(out[key], fl, rng=rng).reshape(
            BLOCK_PX_CYCLES * 32 * C.BLKSZ, -1)
        pad = np.ones((lead * 32, stream.shape[1]), np.int8)
        tail = np.ones((2 * 32, stream.shape[1]), np.int8)
        signs[f"{key}_signs"] = np.concatenate([pad, stream, tail])
    sig = modulate_fm(matrix, bc_seq, psmi, **signs)
    out["sig"] = ch.impair(sig, snr_db=SNR_DB, rng=rng).astype(np.complex64)
    return out


def block_session_run(torch, wire, mode: int, push: int, turbo=False,
                      plain=False) -> dict:
    """One stream through the port's session on its per-block receivers on
    the card (``chain="block"``, no audio decoder): cu8 (uint8 wire) or
    cs16 (int16 [n, 2] wire) pushes of ``push`` bytes or samples, then
    ``flush``.  ``plain`` runs the decoders' plain versions (the kernels'
    yardstick for the decoded bits): FM's on the card, AM's as the CPU
    twins on the codes copied to the host.  Returns the events, the
    decoded frames (channel, bits, margin) in order, the blocks, the wall,
    the launches and the plain versions called."""
    import functools
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.api.session import NRSC5
    from nrsc5_tpu_torch.ops import decode_am as DA
    from nrsc5_tpu_torch.ops import decode_fm as DF
    from nrsc5_tpu_torch.pipeline import receiver as RX
    from nrsc5_tpu_torch.pipeline import receiver_am as RA
    events, frames, blocks = [], [], [0]
    radio = NRSC5.open_pipe(events.append, mode, chain="block", turbo=turbo,
                            hdc_decoder_factory=None)
    on_frame, on_l1 = radio._on_frame, radio._on_l1_event

    def frame(chan, bits, margin):
        frames.append((chan, np.array(bits), float(margin)))
        return on_frame(chan, bits, margin)

    def l1(kind, info):
        blocks[0] += kind == "block"
        on_l1(kind, info)
    radio._on_frame, radio._on_l1_event = frame, l1
    radio._wire()  # the radio calls the recording callbacks
    def am_pids_twin(syms, disabled=False):
        return DA.am_pids_decode(syms.cpu(), disabled).to(syms.device)

    def am_frame_twin(pl, pu, s, t, state, ma3=False):
        dev = pl.device
        p1, p3, margins, new = DA.am_frame_decode(
            *(x.cpu() for x in (pl, pu, s, t)),
            DA.AMDecodeState(*(x.cpu() for x in state)), ma3)
        return (p1.to(dev), p3.to(dev),
                {k: v.to(dev) for k, v in margins.items()},
                DA.AMDecodeState(*(x.to(dev) for x in new)))
    undo = []
    if plain:
        for name in ("p1_decode", "pids_decode"):
            undo.append((RX, name, getattr(RX, name)))
            setattr(RX, name, functools.partial(getattr(DF, name),
                                                plain=True))
        for name, twin in (("am_pids_decode", am_pids_twin),
                           ("am_frame_decode", am_frame_twin)):
            undo.append((RA, name, getattr(RA, name)))
            setattr(RA, name, twin)
    plain_calls, restore = count_plain_calls()
    try:
        torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        pipe = radio.pipe_samples_cu8 if wire.dtype == np.uint8 \
            else radio.pipe_samples_cs16
        flat = wire.reshape(-1) if wire.dtype == np.uint8 else wire
        for lo in range(0, len(flat), push):
            pipe(flat[lo:lo + push].reshape(-1))
        radio.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: c for k, c in K.COUNTS.items() if c}
    finally:
        restore()
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    return {"events": events, "frames": frames, "blocks": blocks[0],
            "wall_s": wall, "launches": counts, "plain_calls": plain_calls}


def block_px_run(torch, st: dict, psmi: int) -> dict:
    """One PX station through the per-block FM receiver on the card, the
    signal pushed whole.  Gate: SYNC at ``psmi``; every transmitted P1
    frame, and every PX1 (and PX2) frame of IV cycles 1 on, decoded
    bit-exact; exactly the FM PX path's kernels; no plain version."""
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.pipeline.receiver import FMReceiver
    frames, events = [], []
    rx = FMReceiver(lambda c, b, m: frames.append((c, np.array(b))),
                    lambda k, i: events.append((k, i)))
    plain_calls, restore = count_plain_calls()
    try:
        torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        rx.push_cs16(st["sig"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: c for k, c in K.COUNTS.items() if c}
    finally:
        restore()

    def got(chan):
        return {b.tobytes() for c, b in frames if c == chan}
    exact = {"p1": sum(f.tobytes() in got(0) for f in st["p1"])}
    for chan, key in ((1, "px1"), (2, "px2")):
        if st[key] is not None:
            exact[key] = sum(f.tobytes() in got(chan)
                             for f in st[key][1:].reshape(
                                 -1, st[key].shape[-1]))
    want = {"p1": len(st["p1"])}
    want.update({k: (BLOCK_PX_CYCLES - 1) * 16 for k in ("px1", "px2")
                 if st[k] is not None})
    ok = (("sync", {"psmi": psmi}) in events and exact == want
          and set(counts) == set(BLOCK_PX_KERNELS) and not plain_calls)
    return {"psmi": psmi, "sync": [i for k, i in events if k == "sync"],
            "exact": exact, "want": want, "blocks": rx.blocks_processed,
            "wall_s": wall, "wall_ms_per_block": 1e3 * wall
            / max(rx.blocks_processed, 1), "launches": counts,
            "plain_calls_on_kernel_path": plain_calls, "pass": ok}


# ---------------------------------------------------------------------------
# parallel: the sharded receive, its pipeline and replay, station meshes
# ---------------------------------------------------------------------------

PAR_STATIONS = 2  # stations of each sharded capture (a block a station row)
PAR_TIME = 2  # time shards of the two-rank mesh
PAR_FM_BLOCKS = 16  # blocks a time shard: FM
PAR_SYNC_BLOCKS = 33  # self-sync (one whole frame a shard)
PAR_AM_FRAMES = 7  # AM frames a time shard (frames 0-2 its warm-up)
PAR_PX_BLOCKS = 32  # PX (MP3): one interleaver-IV cycle a shard
PAR_PIPE_FRAMES = 3  # P1 frames through the two-stage pipeline
PAR_SNR_DB = 25.0
PAR_SYNC_OFFSET = 947  # the self-sync capture (tests/test_parallel.py:165)
PAR_SYNC_SNR_DB = 28.0
PAR_TIMEOUT_S = 420.0
# kernel launches of one on-device FM cold start: K9 (two kernels), K2 and
# the DFT kernel a probe each, K10, K4
COLD_DEVICE_LAUNCHES = {"coarse_timing": 2, "demod_fold": 2, "dft_bf16": 2,
                        "cfo_scan": 1, "sync_block": 1}


def _par_fm_capture(rng, n_blocks_total: int, psmi: int = 1,
                    snr_db: float | None = PAR_SNR_DB, n_px_cycles: int = 0):
    """One station at the steady offset: ``n_blocks_total // 16`` P1 frames
    of random P1 and PIDS bits (and ``n_px_cycles`` interleaver-IV cycles
    of random PX1 frames for psmi 3), one trailing block, AWGN.  Returns
    (complex64 signal, p1, pids, px1)."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix, build_px_stream
    from nrsc5_tpu_torch.tx.modulator import modulate_fm
    n_frames = n_blocks_total // C.P1_FM_BLOCKS
    p1 = rng.integers(0, 2, (n_frames, C.P1_FRAME_LEN_FM), dtype=np.uint8)
    pids = rng.integers(0, 2, (n_frames, 16, C.PIDS_FRAME_LEN),
                        dtype=np.uint8)
    mats = [build_pm_matrix(p1[f], pids[f]) for f in range(n_frames)]
    matrix = np.concatenate(mats + [mats[0][:C.BLKSZ]])
    bc = np.concatenate([np.tile(np.arange(16), n_frames), [0]])
    kw, px1 = {}, None
    if n_px_cycles:
        fl = C.P3_FRAME_LEN_MP3_MP11
        px1 = rng.integers(0, 2, (n_px_cycles, 16, fl), dtype=np.uint8)
        signs = build_px_stream(px1, fl).reshape(n_blocks_total * C.BLKSZ,
                                                 -1)
        kw["px1_signs"] = np.concatenate([signs, signs[:C.BLKSZ]])
    sig = modulate_fm(matrix, bc, psmi, **kw)
    if snr_db is not None:
        sig = ch.impair(sig, snr_db=snr_db, rng=rng)
    return sig, p1, pids, px1


def _frame_aligned(sig, total: int, halo: int):
    """The signal in a buffer at the steady offset, split at ``total``."""
    from nrsc5_tpu_torch import constants as C
    buf = np.zeros(total + halo, np.complex64)
    start = C.FFTCP_FM // 2
    n = min(len(sig), len(buf) - start)
    buf[start:start + n] = sig[:n]
    return buf[:total], buf[total:]


def make_parallel_captures(out_dir: Path) -> dict:
    """The parallel phase's captures, PAR_STATIONS stations each from their
    own seeds, written as ``.npz`` files the ranks read (``samples`` [S,
    PAR_TIME·chunk(, 2)], ``tails``); returns their paths and the
    transmitted bits.  fm: 2 P1 frames at 25 dB; selfsync: 5 P1 frames at
    offset 947, CFO 3 bins + 25 Hz, 28 dB, conjugated rc (the reference's
    self-sync test); am: 14 MA1 frames, noiseless (the reference's AM
    test); px: 2 IV cycles of MP3 at 25 dB; pipeline: 3 frames at 25 dB in
    a buffer_len(48) buffer; each from the port's ``tx``."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.parallel import receive as PR
    from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx import encoder_am as EAM
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
    from nrsc5_tpu_torch.tx.modulator import modulate_fm
    from nrsc5_tpu_torch.tx.modulator_am import modulate_am
    out_dir.mkdir(parents=True, exist_ok=True)
    caps = {k: {"samples": [], "tails": []} for k in
            ("fm", "selfsync", "am", "px", "pipeline")}
    truth = {k: [] for k in caps}
    for st in range(PAR_STATIONS):
        rng = np.random.default_rng([SEED, 22, st])
        total = PAR_TIME * PR.shard_chunk_len(PAR_FM_BLOCKS)
        sig, p1, pids, _ = _par_fm_capture(rng, PAR_TIME * PAR_FM_BLOCKS)
        a, b = _frame_aligned(sig, total, PR.HALO)
        caps["fm"]["samples"].append(a)
        caps["fm"]["tails"].append(b)
        truth["fm"].append({"p1": p1, "pids": pids})

        n_sync = 5
        p1 = rng.integers(0, 2, (n_sync, C.P1_FRAME_LEN_FM), dtype=np.uint8)
        zeros = np.zeros((16, C.PIDS_FRAME_LEN), np.uint8)
        sig = modulate_fm(np.concatenate([build_pm_matrix(f, zeros)
                                          for f in p1]),
                          np.tile(np.arange(16), n_sync), 1)
        bin_hz = C.SAMPLE_RATE_CS16_FM / C.FFT_FM
        sig = ch.impair(sig, cfo_hz=3 * bin_hz + 25.0,
                        snr_db=PAR_SYNC_SNR_DB, rng=rng)
        total = PAR_TIME * PR.shard_chunk_len(PAR_SYNC_BLOCKS)
        halo = PR.selfsync_halo()
        buf = np.zeros(total + halo, np.complex64)
        n = min(len(sig), len(buf) - PAR_SYNC_OFFSET)
        buf[PAR_SYNC_OFFSET:PAR_SYNC_OFFSET + n] = sig[:n]
        rc = np.stack([buf.real, -buf.imag], -1).astype(np.float32)
        caps["selfsync"]["samples"].append(rc[:total])
        caps["selfsync"]["tails"].append(rc[total:])
        truth["selfsync"].append({"p1": p1})

        n_am = PAR_TIME * PAR_AM_FRAMES
        p1 = rng.integers(0, 2, (n_am, 8, C.P1_FRAME_LEN_AM), dtype=np.uint8)
        p3 = rng.integers(0, 2, (n_am, C.P3_FRAME_LEN_MA1), dtype=np.uint8)
        mats = EAM.interleave_frames(
            [EAM.encode_p1_am(p1[f]) for f in range(n_am)],
            [EAM.encode_p3_am(p3[f], False) for f in range(n_am)], False)
        pids = rng.integers(0, 2, (n_am * 8, 80), dtype=np.uint8)
        codes = np.stack([EAM.encode_pids_am(w) for w in pids])
        ref = np.stack([EAM.am_ref_bits(b % 8, 1) for b in range(n_am * 8)])
        sig = modulate_am(mats, codes, ref, False)
        total = PAR_TIME * PR.shard_chunk_len_am(PAR_AM_FRAMES)
        buf = np.zeros(total + PR.HALO_AM, np.complex64)
        start = C.FFTCP_AM // 2
        n = min(len(sig), len(buf) - start)
        buf[start:start + n] = sig[:n]
        caps["am"]["samples"].append(buf[:total])
        caps["am"]["tails"].append(buf[total:])
        truth["am"].append({"p1": p1, "p3": p3, "pids": pids})

        total = PAR_TIME * PR.shard_chunk_len(PAR_PX_BLOCKS)
        sig, p1, _, px1 = _par_fm_capture(rng, PAR_TIME * PAR_PX_BLOCKS,
                                          psmi=3, n_px_cycles=PAR_TIME)
        a, b = _frame_aligned(sig, total, PR.HALO)
        caps["px"]["samples"].append(a)
        caps["px"]["tails"].append(b)
        truth["px"].append({"p1": p1, "px1": px1})

        n_blocks = 16 * PAR_PIPE_FRAMES
        sig, p1, pids, _ = _par_fm_capture(rng, n_blocks)
        a, _ = _frame_aligned(sig, buffer_len(n_blocks), 0)
        caps["pipeline"]["samples"].append(a)
        caps["pipeline"]["tails"].append(np.zeros(0, np.complex64))
        truth["pipeline"].append({"p1": p1, "pids": pids})
    paths = {}
    for k, v in caps.items():
        paths[k] = str(out_dir / f"{k}.npz")
        np.savez(paths[k], samples=np.stack(v["samples"]),
                 tails=np.stack(v["tails"]))
    return {"paths": paths, "truth": truth}


def _par_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _par_steps():
    from nrsc5_tpu_torch.parallel import receive as PR
    return {"fm": (PR.sharded_fm_chain, PAR_FM_BLOCKS, {}, PR.HALO, 0),
            "selfsync": (PR.sharded_fm_chain_selfsync, PAR_SYNC_BLOCKS, {},
                         PR.selfsync_halo(), 0),
            "am": (PR.sharded_am_chain, PAR_AM_FRAMES, {}, PR.HALO_AM, 0),
            "px": (PR.sharded_fm_chain_px, PAR_PX_BLOCKS, {"psmi": 3},
                   PR.HALO, PR.px_left_blocks(3)[0] * PR.shard_chunk_len(1))}


def _one_process(torch, kind: str, ext, arg: int):
    """The one-process chain on a shard's extended chunk: each station
    through ``fm_chain_scan``/``am_chain_scan`` alone (the PX shard's with
    its IV state, its warm-up dropped), or the self-sync shard's work."""
    from nrsc5_tpu_torch.parallel import receive as PR
    from nrsc5_tpu_torch.pipeline import scan_chain as sc
    from nrsc5_tpu_torch.pipeline import scan_chain_am as sca
    dev = ext.device
    if kind == "selfsync":
        return list(PR.selfsync_decode(ext, arg)[:-1])
    rows = []
    for x in ext:
        if kind == "fm":
            out, _ = sc.fm_chain_scan(x, sc.chain_init_carry(device=dev), arg)
            rows.append((out["p1"], out["p1_margin"], out["pids"]))
        elif kind == "am":
            out, _ = sca.am_chain_scan(x, sca.am_chain_init_carry(device=dev),
                                       arg)
            rows.append((out["p1"], out["p3"], out["pids"]))
        else:
            left, warm_p1, warm_px = PR.px_left_blocks(3)
            out, _ = sc.fm_chain_scan(
                x, sc.chain_init_carry(device=dev), arg + left, 3, 0,
                px_state=sc.px_init_state(3, device=dev))
            rows.append((out["p1"][warm_p1:], out["px1"][warm_px:]))
    return [torch.stack(col) for col in zip(*rows)]


def parallel_sharded(torch, mesh, dev, kind: str, path: str) -> dict:
    """One shard of the ``kind`` sharded step over ``mesh`` (each rank
    calls it): its time chunk of the capture at ``path``, the step timed
    twice (the launches counted on the first), its outputs gathered into
    the reference's layout, and its own outputs against the one-process
    chain on the extended chunk built from the whole capture."""
    from dataclasses import asdict

    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.parallel import receive as PR
    make, arg, kw, halo, left = _par_steps()[kind]
    _, t = mesh.get_coordinate()
    n_time = mesh.mesh.shape[1]
    with np.load(path) as d:
        whole, tails_all = d["samples"], d["tails"]
    chunk = whole.shape[1] // n_time
    samples = torch.from_numpy(whole[:, t * chunk:(t + 1) * chunk].copy()) \
        .to(dev)
    tails = torch.from_numpy(tails_all).to(dev)
    step = make(mesh, arg * (PAR_TIME // n_time), **kw)
    walls = []
    for i in range(2):
        _par_sync(torch, dev)
        K.reset_counts()
        t0 = time.perf_counter()
        out = step(samples, tails)
        _par_sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        if i == 0:
            counts = {k: c for k, c in K.COUNTS.items() if c}
            exchange = asdict(step.exchange)
    blocks = [o for o in out if o.ndim >= 2]
    gathered = [PR.gather_mesh(mesh, o).cpu().numpy() for o in blocks]
    # the extended chunk, from the whole capture
    nxt = whole[:, (t + 1) * chunk:(t + 1) * chunk + halo] \
        if t < n_time - 1 else tails_all
    parts = [whole[:, t * chunk:(t + 1) * chunk], nxt]
    if left:
        prev = whole[:, t * chunk - left:t * chunk] if t else \
            np.zeros_like(whole[:, :left])
        parts.insert(0, prev)
    ext = torch.from_numpy(np.concatenate(parts, axis=1)).to(dev)
    ref = _one_process(torch, kind, ext, arg * (PAR_TIME // n_time))
    same = len(ref) == len(blocks) and all(
        torch.equal(a, b) for a, b in zip(blocks, ref))
    return {"global": gathered, "quality": [float(o) for o in out
                                            if o.ndim == 0],
            "same_as_one_process": same, "wall_s": walls,
            "exchange": exchange, "launches": counts}


def parallel_pipeline(torch, dev, path: str) -> dict:
    """Each station of the pipeline capture through ``pipelined_receive``
    on a two-rank stage mesh (each rank calls it), against the fused chain
    on one rank: outputs and carry equal, and both walls."""
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.parallel import pipeline as PP
    from nrsc5_tpu_torch.pipeline import scan_chain as sc
    mesh = PP.make_stage_mesh(device=dev)
    with np.load(path) as d:
        rows = d["samples"]
    res = []
    for row in rows:
        samples = torch.from_numpy(row).to(dev)
        _par_sync(torch, dev)
        K.reset_counts()
        t0 = time.perf_counter()
        out, carry = PP.pipelined_receive(
            samples, sc.chain_init_carry(device=dev), PAR_PIPE_FRAMES, mesh)
        _par_sync(torch, dev)
        wall = time.perf_counter() - t0
        counts = {k: c for k, c in K.COUNTS.items() if c}
        t0 = time.perf_counter()
        fused, fused_carry = sc.fm_chain_scan(
            samples, sc.chain_init_carry(device=dev), 16 * PAR_PIPE_FRAMES)
        _par_sync(torch, dev)
        fused_wall = time.perf_counter() - t0
        same = (torch.equal(out["p1"], fused["p1"])
                and torch.equal(out["p1_margin"], fused["p1_margin"])
                and torch.equal(out["pids"].reshape(-1, 80), fused["pids"])
                and all(torch.equal(a, b) for a, b in zip(
                    sc.tree_leaves(carry), sc.tree_leaves(fused_carry))))
        res.append({"p1": out["p1"].cpu().numpy(),
                    "pids": out["pids"].cpu().numpy(),
                    "same_as_fused": same, "wall_s": wall,
                    "fused_wall_s": fused_wall, "launches": counts,
                    "stage": mesh.get_coordinate()[0]})
    return res


def parallel_rank(rank: int, world: int, dev, paths: dict) -> dict:
    """One of the two ranks of the parallel phase on one card (gloo): the
    four sharded steps over a 1 x 2 (station, time) mesh, the pipeline,
    and the multi-host self-test with two "hosts" of one rank."""
    import torch

    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.parallel import distributed as TD
    from nrsc5_tpu_torch.parallel import receive as PR
    mesh = PR.make_mesh(1, world, device=dev)
    out = {k: parallel_sharded(torch, mesh, dev, k, paths[k])
           for k in ("fm", "selfsync", "am", "px")}
    out["pipeline"] = parallel_pipeline(torch, dev, paths["pipeline"])
    K.reset_counts()
    t0 = time.perf_counter()
    out["replay"] = TD.selftest(rank, world, dev, n_time=1,
                                n_blocks=PAR_FM_BLOCKS)
    out["replay_wall_s"] = time.perf_counter() - t0
    out["replay_launches"] = {k: c for k, c in K.COUNTS.items() if c}
    return out


def parallel_truth_gate(kind: str, got: list, truth: list) -> dict:
    """The transmitted bits against a sharded step's gathered outputs (the
    reference's layout: [S, PAR_TIME·F, ...])."""
    if kind == "fm":
        p1, _, pids = got
        ok = [np.array_equal(p1[s], tr["p1"]) and np.array_equal(
            pids[s], tr["pids"].reshape(-1, 80)) for s, tr in enumerate(truth)]
    elif kind == "selfsync":
        p1, _, _, cfo, locked = got
        ok = [bool(locked[s].all()) and bool((np.abs(cfo[s]) == 3).all())
              and all(any(np.array_equal(f, t) for t in tr["p1"])
                      for f in p1[s]) for s, tr in enumerate(truth)]
    elif kind == "am":
        p1, p3, pids = got
        ok = []
        for s, tr in enumerate(truth):
            frames = [t * PAR_AM_FRAMES + f for t in range(PAR_TIME)
                      for f in range(3, PAR_AM_FRAMES
                                     - (t == PAR_TIME - 1))]
            ok.append(all(np.array_equal(p1[s, g], tr["p1"][g])
                          and np.array_equal(p3[s, g], tr["p3"][g])
                          for g in frames)
                      and np.array_equal(pids[s], tr["pids"]))
    else:
        p1, px1 = got
        per = px1.shape[1] // PAR_TIME
        ok = [np.array_equal(p1[s], tr["p1"])
              and np.array_equal(px1[s, per:], tr["px1"][1])
              for s, tr in enumerate(truth)]
    return {"stations_exact": sum(ok), "stations": len(truth),
            "pass": all(ok)}


def parallel_phase(torch, smi: str, capture, serve_fm: dict) -> dict:
    """The parallel phase (see the module's docstring): emits its lines and
    returns each path's launches by kernel; raises if a gate fails."""
    import torch.distributed as dist

    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.parallel import distributed as TD
    from nrsc5_tpu_torch.parallel import receive as PR
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()

    # the on-device FM cold start: the coldstart phase's 16 stations and
    # one of noise only, against the host cold start and the plain run
    samples = serve.ingest(torch.from_numpy(capture).to(dev))
    gen = torch.Generator().manual_seed(SEED)
    noise = torch.randn((1,) + tuple(samples.shape[1:]), generator=gen) \
        * float(samples[0].std())
    samples = torch.cat([samples, noise.to(dev)]).contiguous()
    torch.cuda.synchronize()
    K.reset_counts()
    got = rcc.cold_start_device_rc(samples)
    torch.cuda.synchronize()
    cd_counts = {k: c for k, c in K.COUNTS.items() if c}
    cd_dtoh = dtoh_copies(torch, lambda: rcc.cold_start_device_rc(samples))
    cd_ms = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rcc.cold_start_device_rc(samples)
        torch.cuda.synchronize()
        cd_ms.append((time.perf_counter() - t0) * 1e3)
    plain = [x.cpu().numpy() for x in rcc.cold_start_device_rc(samples,
                                                               plain=True)]
    host = rcc.cold_start_rc(samples)
    start, first_bc, cfo, angle, locked = (x.cpu().numpy() for x in got)
    host_same = all(
        (lk is None) == (not locked[i]) and (lk is None or (
            (lk["offset"], lk["first_bc"], lk["cfo"])
            == (start[i], first_bc[i], cfo[i])
            and lk["carry"].prev_angle.cpu().numpy() == angle[i]))
        for i, lk in enumerate(host))
    plain_same = all(np.array_equal(a, b) for a, b in zip(
        plain, (start, first_bc, cfo, angle, locked)))
    cd_ok = (host_same and plain_same and locked[:-1].all()
             and not locked[-1] and cd_counts == COLD_DEVICE_LAUNCHES
             and cd_dtoh == 0)
    emit({"phase": "parallel_cold_start", "card": smi,
          "stations": int(samples.shape[0]), "locked": locked.tolist(),
          "start": start.tolist(), "first_bc": first_bc.tolist(),
          "cfo": cfo.tolist(), "equal_host_cold_start": host_same,
          "equal_plain_bitwise": plain_same, "launches": cd_counts,
          "launches_gate": COLD_DEVICE_LAUNCHES,
          "device_to_host_copies": cd_dtoh,
          "wall_ms": statistics.median(cd_ms), "wall_ms_runs": cd_ms,
          "pass": cd_ok})
    if not cd_ok:
        raise AssertionError("parallel: the on-device cold start did not "
                             "pass its gate")

    # the four sharded steps over a 1 x 1 NCCL mesh in this process
    caps = make_parallel_captures(Path(__file__).resolve().parent / "build"
                                  / "parallel")
    kinds = ("fm", "selfsync", "am", "px")
    TD.init_distributed(f"127.0.0.1:{TD.free_port()}", 1, 0, device=dev)
    try:
        backend_one = str(dist.get_backend())
        mesh = PR.make_mesh(1, 1, device="cuda")
        one = {k: parallel_sharded(torch, mesh, dev, k, caps["paths"][k])
               for k in kinds}
    finally:
        dist.destroy_process_group()
    one_truth = {k: parallel_truth_gate(k, one[k]["global"],
                                        caps["truth"][k]) for k in kinds}

    # two processes on this card, gloo: a 1 x 2 mesh through the four
    # steps, the pipeline, the two-host self-test
    t0 = time.perf_counter()
    ranks = TD.run_ranks(parallel_rank, 2, caps["paths"], device=dev,
                         backend="gloo", timeout=PAR_TIMEOUT_S)
    ranks_wall = time.perf_counter() - t0
    two_truth = {k: parallel_truth_gate(k, ranks[0][k]["global"],
                                        caps["truth"][k]) for k in kinds}
    same_one = {k: [r[k]["same_as_one_process"] for r in ranks]
                for k in kinds}
    quality = {k: [r[k]["quality"] for r in ranks] for k in kinds}
    pipe = [[st for st in r["pipeline"]] for r in ranks]
    pipe_ok = all(
        st["same_as_fused"] and np.array_equal(st["p1"], tr["p1"])
        and np.array_equal(st["pids"], tr["pids"])
        for r in pipe for st, tr in zip(r, caps["truth"]["pipeline"]))
    exchange = {k: [r[k]["exchange"] for r in ranks] for k in kinds}
    par_ok = (all(g["pass"] for g in one_truth.values())
              and all(g["pass"] for g in two_truth.values())
              and all(one[k]["same_as_one_process"] for k in kinds)
              and all(all(v) for v in same_one.values())
              and all(len({q for qs in v for q in qs}) <= 1
                      for v in quality.values())
              and all(e["route"] == "host" and e["backend"] == "gloo"
                      for v in exchange.values() for e in v)
              and pipe_ok and backend_one == "nccl"
              and all(r["replay"].startswith("DCN_OK") for r in ranks))
    steps = PAR_PIPE_FRAMES + 1
    emit({"phase": "parallel", "card": smi,
          "stations": PAR_STATIONS, "time_shards": PAR_TIME,
          "one_process": {"backend": backend_one, "mesh": [1, 1], **{
              k: {"wall_s": one[k]["wall_s"], "quality": one[k]["quality"],
                  "exchange": one[k]["exchange"], **one_truth[k],
                  "same_as_one_process": one[k]["same_as_one_process"]}
              for k in kinds}},
          "two_processes": {
              "backend": "gloo", "mesh": [1, PAR_TIME],
              "wall_s": ranks_wall, **{
                  k: {"wall_s": [r[k]["wall_s"] for r in ranks],
                      "quality": quality[k], "exchange": exchange[k],
                      "same_as_one_process": same_one[k], **two_truth[k]}
                  for k in kinds}},
          "pipeline": [{
              "stage": st["stage"], "same_as_fused": st["same_as_fused"],
              "wall_s": st["wall_s"], "step_ms": 1e3 * st["wall_s"] / steps,
              "fused_wall_s": st["fused_wall_s"],
              "fused_frame_ms": 1e3 * st["fused_wall_s"] / PAR_PIPE_FRAMES}
              for r in pipe for st in r],
          "replay": [r["replay"] for r in ranks],
          "replay_wall_s": [r["replay_wall_s"] for r in ranks],
          "pass": par_ok})
    if not par_ok:
        raise AssertionError("parallel: the sharded receive did not pass "
                             "its gate")
    counts = {}
    for name in K.SIGNATURES:
        counts[name] = cd_counts.get(name, 0) + sum(
            one[k]["launches"].get(name, 0) for k in kinds) + sum(
            r[k]["launches"].get(name, 0) for r in ranks for k in kinds) \
            + sum(st["launches"].get(name, 0) for r in pipe for st in r) \
            + sum(r["replay_launches"].get(name, 0) for r in ranks)

    # the receiver over a station mesh of two devices (one card twice)
    wires = [serve_fm["wire"][i] for i in range(2)]
    sharded = serve_mesh_run(torch, wires, ["cuda:0", "cuda:0"])
    unsharded = serve_mesh_run(torch, wires, None)
    names = [serve_names(i)[0] for i in range(2)]
    sm_ok = (sharded["hdc"] == unsharded["hdc"]
             and sharded["titles"] == unsharded["titles"]
             and sharded["syncs"] == [1, 1]
             and all(len(h) > 0 for h in sharded["hdc"])
             and all(n in t for n, t in zip(names, sharded["titles"])))
    emit({"phase": "serve_mesh", "card": smi, "mesh": ["cuda:0", "cuda:0"],
          "stations": 2, "hdc_packets": [len(h) for h in sharded["hdc"]],
          "titles": [sorted(set(t)) for t in sharded["titles"]],
          "syncs": sharded["syncs"],
          "equal_unsharded": sharded["hdc"] == unsharded["hdc"]
          and sharded["titles"] == unsharded["titles"],
          "wall_s": sharded["wall_s"],
          "unsharded_wall_s": unsharded["wall_s"],
          "launches": sharded["launches"], "pass": sm_ok})
    if not sm_ok:
        raise AssertionError("serve_mesh did not pass its gate")

    # a drifting MA1 station (±50 ppm) through the AM session
    drift = []
    for ppm in DRIFT_PPM:
        sig, packets = make_drift_am_capture(ppm)
        drift.append((ppm, drift_am_run(torch, sig, packets, "block"),
                      drift_am_run(torch, sig, packets, "auto")))
    dr_ok = all(b["syncs"] >= 1 and b["lost_syncs"] == 0
                and b["hdc_exact"] == b["hdc_want"] and b["hdc_foreign"] == 0
                and a["syncs"] >= 1 and a["lost_syncs"] == 0
                and a["hdc_exact"] >= DRIFT_AM_MIN_HDC
                and a["hdc_foreign"] == 0 for _, b, a in drift)
    emit({"phase": "am_drift", "card": smi, "frames": DRIFT_AM_FRAMES,
          "gate_frames": [DRIFT_FRAMES.start, DRIFT_FRAMES.stop - 1],
          "device_chain_min_hdc": DRIFT_AM_MIN_HDC,
          "runs": [{"ppm": ppm, "block": b, "device_chain": a}
                   for ppm, b, a in drift], "pass": dr_ok})
    if not dr_ok:
        raise AssertionError("am_drift did not pass its gate")
    drift_counts = {}
    for _, b, a in drift:
        for d in (b["launches"], a["launches"]):
            for k, c in d.items():
                drift_counts[k] = drift_counts.get(k, 0) + c
    emit({"phase": "parallel_seconds",
          "seconds": time.perf_counter() - t_phase})
    return {"parallel": counts, "serve_mesh": sharded["launches"],
            "am_drift": drift_counts}


def serve_mesh_run(torch, wires: list, mesh) -> dict:
    """``MultiStationReceiver(cold_start=True, input_format="cu8",
    frames_per_dispatch=2, depth=2, mesh=mesh)`` over the stations' cu8
    wires pushed in turn in SERVE_PUSH-pair pieces, then flush: the clean
    HDC packets and ID3 titles by station, the wall and the launches."""
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    events = {i: [] for i in range(len(wires))}
    rx = serve.MultiStationReceiver(
        len(wires), lambda st, ev: events[st].append(ev),
        frames_per_dispatch=2, depth=2, cold_start=True, input_format="cu8",
        mesh=mesh)
    data = [w.tobytes() for w in wires]
    piece = 2 * SERVE_PUSH + 1
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    for lo in range(0, max(map(len, data)), piece):
        for i, w in enumerate(data):
            if lo < len(w):
                rx.push(i, w[lo:lo + piece])
    rx.flush()
    torch.cuda.synchronize()
    return {"hdc": [[e.data for e in events[i] if e.type.name == "HDC"
                     and not e.crc_error] for i in events],
            "titles": [[e.title for e in events[i] if e.type.name == "ID3"]
                       for i in events],
            "syncs": [sum(e.type.name == "SYNC" for e in events[i])
                      for i in events],
            "wall_s": time.perf_counter() - t0,
            "launches": {k: c for k, c in K.COUNTS.items() if c}}


def drift_am_run(torch, sig, packets, chain: str) -> dict:
    """The drifting MA1 capture through the port's AM session on the
    default device (``chain``: ``"block"``, the per-block receiver the
    reference's test drives, or ``"auto"``, the device chain), pushed as
    complex64 in DRIFT_PUSH-sample pieces, then flush."""
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.api.session import MODE_AM, NRSC5
    events = []
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    radio = NRSC5.open_pipe(events.append, MODE_AM, chain=chain)
    for i in range(0, len(sig), DRIFT_PUSH):
        radio.pipe_samples_cs16(sig[i:i + DRIFT_PUSH])
    radio.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hdc = {e.data for e in events if e.type.name == "HDC"
           and not e.crc_error}
    want = {p for f, pk in packets if f in DRIFT_FRAMES for p in pk}
    return {"syncs": sum(e.type.name == "SYNC" for e in events),
            "lost_syncs": sum(e.type.name == "LOST_SYNC" for e in events),
            "hdc_exact": sum(p in hdc for p in want), "hdc_want": len(want),
            "hdc_foreign": len(hdc - {bytes(p) for _, pk in packets
                                      for p in pk}),
            "wall_s": wall,
            "launches": {k: c for k, c in K.COUNTS.items() if c}}


def dtoh_copies(torch, fn) -> int:
    """Device-to-host copies the profiler records in one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum("DtoH" in e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def make_fleet(station=make_station) -> dict:
    """Every station, built in parallel by spawned worker processes (numpy
    only; the pool ends with the call)."""
    workers = min(N_STATIONS, os.cpu_count() or 1)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        stations = list(pool.map(station, range(N_STATIONS)))
    return {k: [st[k] for st in stations] if k in ("packets", "wire")
            and station in (make_serve_fm_station, make_serve_am_station)
            else np.stack([st[k] for st in stations]) for k in stations[0]}


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
    from nrsc5_tpu_torch.ops import detect_cfo as DC
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.ops import interleavers as IL
    from nrsc5_tpu_torch.ops import rcplx as rc
    from nrsc5_tpu_torch.ops import sync_fm as SF
    from nrsc5_tpu_torch.ops import decode_fm as DF
    from nrsc5_tpu_torch.ops.bits import unpack_bits
    from nrsc5_tpu_torch.ops import decode_am as DA
    from nrsc5_tpu_torch.pipeline import block_graph as BG
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
    from nrsc5_tpu_torch.pipeline.scan_chain import iv_state_len
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len
    from nrsc5_tpu_torch.audio import stage as AST
    from nrsc5_tpu_torch.audio.batch import (BatchedAudioDecoder,
                                             device_inputs)

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
    # each source's stack frames, kernel by kernel (K13's must be 0)
    stack_frames = {n: [int(ln.split()[0]) for ln in lines
                        if "stack frame" in ln]
                    for n, lines in regs.items()}
    kernel_frames = {n: frames_by_kernel(lines) for n, lines in regs.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": list(K.SIGNATURES), "built": built["built"],
          "n_kernels": len(K.SIGNATURES),
          "n_sources": len({K.source_of(n) for n in K.SIGNATURES}),
          "ptxas": regs, "stack_frames": stack_frames,
          # the kernels of K10 and K16b: registers and stack frame bytes
          "redesigned": {n: {"registers": registers_of(regs.get(n),
                                                       f"{n}_kernel"),
                             "stack_frame_bytes": frame_of(
                                 kernel_frames, n, f"{n}_kernel")}
                         for n in ("cfo_scan", "sbr_hf_generate")}})

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
    am_cu8_dec = make_am_cu8_decode_fleet()
    t5 = time.perf_counter()
    serve_fm = make_fleet(make_serve_fm_station)
    serve_am = make_fleet(make_serve_am_station)
    t_serve = time.perf_counter() - t5
    t5 = time.perf_counter()
    tuners = make_fleet_stations()
    t_tuners = time.perf_counter() - t5
    t5 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(AUDIO_STREAMS) + 2, mp_context=ctx) as pool:
        golden_job = pool.submit(make_golden_capture)
        session_am_job = pool.submit(make_session_am_capture)
        block_am_job = pool.submit(make_session_am_capture,
                                   BLOCK_AM_RDBI_FROM)
        block_am3_job = pool.submit(make_session_am_capture, None, True)
        block_px_jobs = {psmi: pool.submit(make_block_px_station, psmi)
                         for psmi in (3, 11)}
        audio_streams = list(pool.map(make_audio_stream, AUDIO_STREAMS))
        t6 = time.perf_counter()
        header_jobs = {h: pool.submit(make_header_batch, h)
                       for h in AUDIO_HEADERS}
        audio_host = list(pool.map(host_audio, audio_streams))
        header_batches = {h: j.result() for h, j in header_jobs.items()}
        golden = golden_job.result()
        session_am_capture = session_am_job.result()
        block_am_capture = block_am_job.result()
        block_am3_capture = block_am3_job.result()
        block_px = {p: j.result() for p, j in block_px_jobs.items()}
    emit({"phase": "signal", "seconds": round(t1 - t0, 3),
          "audio_encode_seconds": round(t6 - t5, 3),
          "audio_host_decode_seconds": round(time.perf_counter() - t6, 3),
          "audio_header_batches": sorted(header_batches),
          "audio_packet_bytes": [[len(p) for p in st]
                                 for st in audio_streams],
          "mp3_seconds": round(t2 - t1, 3),
          "am_seconds": round(t3 - t2, 3),
          "am_cold_seconds": round(t4 - t3, 3),
          "am_cu8_seconds": round(t5 - t4, 3),
          "serve_seconds": round(t_serve, 3),
          "fleet_seconds": round(t_tuners, 3),
          "fleet_wire_bytes": sum(w.nbytes for w in tuners["wire"]),
          "fleet_kinds": list(FLEET_KINDS),
          "fleet_offsets": tuners["offset"],
          "fleet_cfo_hz": tuners["cfo_hz"],
          "serve_fm_wire_bytes": sum(w.nbytes for w in serve_fm["wire"]),
          "serve_am_wire_bytes": sum(w.nbytes for w in serve_am["wire"]),
          "serve_fm_lead_blocks": serve_fm["lead"].tolist(),
          "am_cold_bytes": int(am_cold["wire"].nbytes),
          "am_cold_offsets": am_cold["offset"].tolist(),
          "am_cold_cfo_hz": am_cold["cfo_hz"].tolist(),
          "am_cold_ma3": am_cold["ma3"].tolist(),
          "am_cold_echo": am_cold["echo"].tolist(),
          "am_cu8_bytes": int(am_cu8["wire"].nbytes),
          "am_cu8_decode_bytes": int(am_cu8_dec["wire"].nbytes),
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
    # the audio fleet: program p plays stream p % 3; every batch is the same
    # 8-packet sequence (bench.py:690-700), prepared once on the host
    audio_batch = [audio_streams[p % len(AUDIO_STREAMS)]
                   for p in range(AUDIO_PROGRAMS)]
    adec = BatchedAudioDecoder(AUDIO_PROGRAMS)
    prepare_ms, preps = [], []
    for _ in range(AUDIO_DISPATCHES):
        t0 = time.perf_counter()
        preps.append(adec.prepare(audio_batch))
        prepare_ms.append((time.perf_counter() - t0) * 1e3)
    astage = preps[0][0]
    adec._reconcile_state(*preps[0][2:])
    audio_state0 = {k: v.clone() for k, v in adec._state.items()}

    wire = torch.from_numpy(fleet["steady"]).to(dev)
    capture = torch.from_numpy(fleet["capture"]).to(dev)
    p1_tx, pids_all = fleet["p1"], fleet["pids"]
    pids_tx = pids_all[:, LEAD:]
    s_n, n_in, _ = wire.shape
    report = {}

    def wall_ms(fn, runs: int = 4) -> tuple[float, list]:
        """Median host-clock wall of warm calls of ``fn`` (the first call
        is a warm-up), each ended by a synchronize; and every run."""
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:]), times

    def front_ms(front, *args) -> dict:
        """Device time (CUDA events) of a dispatch's ingest and block loop,
        replayed as its graph and launched eagerly (each warmed first)."""
        got = {}
        for name, graph in (("graph_ms", True), ("eager_ms", False)):
            front(*args, graph=graph)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            front(*args, graph=graph)
            ev[1].record()
            ev[1].synchronize()
            got[name] = ev[0].elapsed_time(ev[1])
        return got

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
    folded_bf16 = AQ.demod_fold_bf16(*args)
    want = AQ.demod_fold_bf16_plain(*args)
    err = (folded_bf16[0].float() - want[0].float()).abs().max().item()
    steps = bf16_steps(torch, folded_bf16[0], want[0])
    phase_err = (folded_bf16[1] - want[1]).abs().max().item()
    keep_same = torch.equal(folded_bf16[2], want[2])
    n_samp = AQ.NSAMP
    check("demod_fold", err, "one bf16 ulp; phase_out 1e-5, keep exact",
          lambda: AQ.demod_fold_bf16(*args),
          lambda: AQ.demod_fold_bf16_plain(*args),
          bound(s_n * (n_samp * 8 + C.BLKSZ * C.FFT_FM * 4 + 40),
                s_n * (n_samp * 17 + C.BLKSZ * C.CP_FM * 6)),
          None, [s_n, C.BLKSZ, C.FFT_FM, 2],
          ok=steps.max().item() <= 1 and phase_err <= 1e-5 and keep_same,
          bf16_ulps_max=steps.max().item(),
          bf16_differ_share=(steps > 0).float().mean().item(),
          phase_out_max_abs_err=phase_err,
          folded_sha256=tensors_sha256(
              [folded_bf16[0].view(torch.int16), *folded_bf16[1:]]))

    # --- the DFT kernel on that bf16 fold (512 rows): its spectra against
    # the plain version (the float32 matmul on the same bf16 operands),
    # within 1e-5 of each row's largest magnitude; the library call is
    # cuBLAS's bf16 GEMM of the same operands (bf16 out), beside the float32
    # GEMM the loop ran before this kernel ---
    dft_in = folded_bf16[0]
    rows = dft_in.numel() // (2 * C.FFT_FM)
    got = rc.dft_bf16(dft_in)
    want = rc.dft_bf16_plain(dft_in)
    row_max = want.view(rows, -1).abs().amax(dim=1, keepdim=True)
    err = ((got - want).view(rows, -1).abs() / row_max).max().item()
    same_twice = torch.equal(got, rc.dft_bf16(dft_in))
    a2d = dft_in.view(rows, -1)
    table = rc.dft_bf16_table(C.FFT_FM, str(dft_in.device))
    a_f32 = a2d.float()
    m_f32 = table.float().t().contiguous()
    dft_as_dft = dft_bound(rows, C.FFT_FM)
    check("dft_bf16", err, 1e-5,
          lambda: rc.dft_bf16(dft_in),
          lambda: rc.dft_bf16_plain(dft_in), bf16_gemm_bound(rows, C.FFT_FM),
          lambda: torch.matmul(a2d, table.t()),
          [rows, 2 * C.FFT_FM], ok=err <= 1e-5 and same_twice,
          tolerance_of="the row's largest magnitude",
          two_launches_same_bits=same_twice,
          f32_gemm_ms=time_ms(torch, lambda: torch.matmul(a_f32, m_f32),
                              graph=True),
          f32_gemm_bound_ms=gemm_bound(rows, C.FFT_FM)[0],
          dft_bound_ms=dft_as_dft[0], dft_bound_by=dft_as_dft[1],
          library_call="torch.matmul of the bf16 operands (cuBLAS, bf16 "
          "out)", card=smi)
    del a_f32, m_f32

    # --- K4: the sync block at block 1 of a chain: the spectra, Costas
    # state and timing_adj the main path hands it after block 0; MP1 on the
    # steady wire, then MP2, MP3 (the first MP3 dispatch's wire) and MP11
    # with their PX demaps ---
    def sync_line(x, psmi, case=None):
        _, _, _, cy = rcc.frontend_scan_rc(x, rcc.chain_rc_init_carry(
            psmi=psmi, n_stations=s_n, device=dev), 1, psmi)
        samperr1 = C.FFTCP_FM // 2 + cy.samperr_fb
        spectra1 = rc.dft_bf16(AQ.demod_fold_bf16(
            x, cy.offset, cy.phase, samperr1, cy.prev_angle - cy.angle_fb,
            cy.cfo)[0])
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

    # --- K5: the FM carry step at block 1 of the chain: block 0's state,
    # block 1's keep (K2) and samperr and angle (K4) ---
    _, _, _, cy = rcc.frontend_scan_rc(samples, rcc.chain_rc_init_carry(
        n_stations=s_n, device=dev), 1)
    samperr1 = C.FFTCP_FM // 2 + cy.samperr_fb
    angle1 = cy.prev_angle - cy.angle_fb
    fo = AQ.demod_fold_bf16(samples, cy.offset, cy.phase, samperr1, angle1,
                            cy.cfo)
    ko, _, _ = rcc.sync_block_rc(rc.dft_bf16(fo[0]), cy.costas_phase,
                                 cy.costas_freq, 1, C.FFTCP_FM // 2 - samperr1)
    k5_in = (fo[2], ko["samperr"], ko["angle"])
    k5_state = {"offset": cy.offset, "prev_angle": cy.prev_angle,
                "samperr_fb": cy.samperr_fb, "angle_fb": cy.angle_fb,
                "samperr": samperr1, "angle": angle1,
                "timing_adj": C.FFTCP_FM // 2 - samperr1}
    k5_k = {k: v.clone() for k, v in k5_state.items()}
    k5_p = {k: v.clone() for k, v in k5_state.items()}
    BG.block_carry(*k5_in, k5_k, False)
    BG.block_carry_plain(*k5_in, k5_p, False)
    err = max((k5_k[k].double() - k5_p[k].double()).abs().max().item()
              for k in k5_state)
    # a block's step reads 5 words a station (keep, K4's samperr and
    # angle, offset, angle) and writes 7 (every field of FM_STATE)
    check("block_carry", err, 0.0,
          lambda: BG.block_carry(*k5_in, k5_k, False),
          lambda: BG.block_carry_plain(*k5_in, k5_p, False),
          bound(s_n * 4 * (5 + 7), s_n * 5), None, [s_n])

    # K4 at block 1 as the block loop launches it: with K5's FM step for
    # block 2 (block 1's keep, the carry after block 0, the next
    # timing_adj a buffer of its own).  K4's outputs against the plain
    # version with the same step, as sync_line holds them; the step
    # exactly block_carry_plain's on the kernel's own samperr and angle
    k4_spec = rc.dft_bf16(fo[0])
    k4_tadj = k5_state["timing_adj"]

    def k4_step():
        return {**{k: v.clone() for k, v in k5_state.items()},
                "keep": fo[2]}

    k4_sk, k4_sp, k4_sr = k4_step(), k4_step(), k4_step()
    k4_args = (k4_spec, cy.costas_phase, cy.costas_freq, 1, k4_tadj)
    ko, kph, kfr = rcc.sync_block_rc(*k4_args, k4_sk)
    po, pph, pfr = rcc.sync_block_rc_plain(*k4_args, k4_sp)
    BG.block_carry_plain(fo[2], ko["samperr"], ko["angle"], k4_sr, False)
    step_err = max((k4_sk[k].double() - k4_sr[k].double()).abs().max()
                   .item() for k in BG.FM_STATE)
    exact = all(torch.equal(ko[k], po[k]) for k in (
        "ref_ok", "ref_bc", "ref_psmi", "samperr")) and all(
        torch.equal(k4_sk[k], k4_sp[k]) for k in (
            "offset", "samperr_fb", "samperr", "timing_adj"))
    floats = [(ko[k], po[k]) for k in ("angle", "error_lb", "error_ub")]
    floats += [(kph, pph), (kfr, pfr)] + [
        (k4_sk[k], k4_sp[k]) for k in ("prev_angle", "angle_fb", "angle")]
    rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1)).item()
              for a, b in floats)
    pm_diff = (ko["pm"].int() - po["pm"].int()).abs()
    k4_timing = k4_step()
    check("sync_block", max(step_err, max(
              (a - b).abs().max().item() for a, b in floats)),
          "the step exact against block_carry_plain on the kernel's "
          "samperr and angle; the rest as the psmi 1 line",
          lambda: rcc.sync_block_rc(*k4_args, k4_timing),
          lambda: rcc.sync_block_rc_plain(*k4_args, k4_timing),
          (report["sync_block"]["bound_ms"],
           report["sync_block"]["bound_by"]), None,
          [s_n, C.BLKSZ, C.FFT_FM, 2],
          ok=step_err == 0.0 and exact and rel <= 1e-5
          and int(pm_diff.max()) <= 1
          and float((pm_diff > 0).float().mean()) <= 1e-3,
          case="carry", psmi=1, step_err=step_err, ints_exact=exact,
          float_rel_err=rel)
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
    # its two kernels: their count against the wrapper's, and each one's
    # bound (the window's samples read, filtered and multiplied into the
    # sums scratch; the sums read, the shaped window summed and the
    # argmax), beside which the profiler times each after the last kernel
    # line (splits)
    before = K.COUNTS["coarse_timing"]
    AQ.coarse_timing_rc(cap_samples)
    counted = K.COUNTS["coarse_timing"] - before
    sums_bytes = s_n * C.FFTCP_FM * 8
    pass_bounds = {
        "coarse_timing_sums_kernel": bound(
            s_n * win * 8 + sums_bytes,
            s_n * (win * 32 * 2 * 2 + C.FFTCP_FM * C.BLKSZ * 8))[0],
        "coarse_timing_window_kernel": bound(
            sums_bytes + s_n * 12, s_n * C.FFTCP_FM * C.CP_FM * 4)[0]}
    check("coarse_timing", err, 0.0,
          lambda: AQ.coarse_timing_rc(cap_samples),
          lambda: AQ.coarse_timing_rc_plain(cap_samples),
          bound(s_n * (win * 8 + 12),
                s_n * (win * 32 * 2 * 2 + C.FFTCP_FM * C.BLKSZ * 8
                       + C.FFTCP_FM * C.CP_FM * 4)),
          None, [s_n, win, 2], plain_reps=3, plain_inner=2,
          ok=err == 0.0 and counted == len(pass_bounds),
          kernels_counted_a_call=counted, kernel_bound_ms=pass_bounds)
    splits = [("coarse_timing", None,
               lambda: AQ.coarse_timing_rc(cap_samples))]

    # --- K10 on the probe's spectra (K9's timing and angle, K2's bf16
    # fold at CFO 0, the DFT kernel): the CFO scan, its 76 CFOs × 22 refs'
    # Costas tracks and their needle count in one kernel, the count exact
    # against the plain scan (the PLL's plain version, then the needle
    # count); beside it the scan of one station, the chain's latency floor
    # at one wave of 19 CTAs ---
    zero = torch.zeros(s_n, dtype=torch.int32, device=dev)
    unit = torch.tensor([[1.0, 0.0]], device=dev).repeat(s_n, 1)
    probe = rc.dft_bf16(AQ.demod_fold_bf16(cap_samples, zero, unit, ks,
                                           rc.angle(kv), zero)[0])
    kc = DC.detect_cfo_scan_rc(probe)
    pc = DC.detect_cfo_scan_rc_plain(probe)
    err = float((kc - pc).abs().max())
    one = probe[:1].contiguous()
    one_same = torch.equal(DC.detect_cfo_scan_rc(one), pc[:1])
    distinct = int(DC._scan_tables(str(dev))["bins"].unique().numel())
    # bytes: each distinct bin's 32 values read once, the count written,
    # the tables; operations: 36 a track step (K3's count: the angle, the
    # recursion, the derotation), 8 a (ref, offset) of the needle match
    check("cfo_scan", err, 0.0,
          lambda: DC.detect_cfo_scan_rc(probe),
          lambda: DC.detect_cfo_scan_rc_plain(probe),
          bound(s_n * distinct * C.BLKSZ * 8 + kc.numel() * 4
                + DC.N_CFO * 4 + 2 * 2 * DC.N_REFS * 4,
                s_n * DC.N_TRACKS * C.BLKSZ * 36
                + kc.numel() * 2 * DC.N_REFS * 8),
          None, [s_n, C.BLKSZ, C.FFT_FM, 2], plain_reps=3, plain_inner=2,
          ok=err == 0.0 and one_same, card=smi,
          distinct_bins_a_station=distinct,
          one_station_ms=time_ms(torch, lambda: DC.detect_cfo_scan_rc(one),
                                 graph=True),
          one_station_same=one_same,
          registers=registers_of(regs.get("cfo_scan"), "cfo_scan_kernel"),
          stack_frame_bytes=frame_of(kernel_frames, "cfo_scan",
                                     "cfo_scan_kernel"))

    # --- K6: gather + depuncture into K7's input (int8), on the steady
    # chain's own soft bits: 32 P1 frames read in place, 512 PIDS blocks;
    # exact.  Its library call: one torch.index_select over each frame's
    # pm with a zero column appended (made outside the timed region) at
    # k7_map, the punctured sites pointing at the zero column ---
    carries = rcc.chain_rc_init_carry(n_stations=s_n, device=dev)
    pm, _, _, _ = rcc.frontend_scan_rc(samples, carries, n_blocks)
    frames = pm.view(s_n, N_FRAMES, -1)
    for name, src, case in (("p1", frames, None), ("pids", pm, "pids")):
        got = DF.fec_gather(src, name)
        want = DF.fec_gather_plain(src, name)
        err = (got.float() - want.float()).abs().max().item()
        tb = DF.channel_tables(name)
        n_fr = src.shape[0] * src.shape[1]
        width = src.shape[-1]
        pmz = torch.cat([src.reshape(n_fr, width),
                         src.new_zeros(n_fr, 1)], dim=1)
        k7 = torch.from_numpy(np.where(tb["k7_map"] >= 0, tb["k7_map"],
                                       width)).long().to(dev)
        lib = torch.index_select(pmz, 1, k7)
        read = n_fr * int((tb["code_map"] >= 0).sum())  # soft bits used
        tables = sum(v.nbytes for k, v in DF.gather_tables(name).items()
                     if k in ("aux", "src", "idx"))
        out_bytes = got.numel() * got.element_size()
        # the kernels of one call: their count against the wrapper's, and
        # each one's bound (P1: pm read and each frame's stream written,
        # then the stream read and the segments written), beside which the
        # profiler times each after the last kernel line (splits)
        before = K.COUNTS["fec_gather"]
        DF.fec_gather(src, name)
        counted = K.COUNTS["fec_gather"] - before
        splits.append(("fec_gather", case, lambda src=src, name=name:
                       DF.fec_gather(src, name)))
        stream = n_fr * C.P1_FRAME_LEN_ENCODED_FM
        pass_bounds = {
            "fec_deinterleave_kernel": bound(n_fr * width + stream, 0)[0],
            "fec_segments_kernel": bound(stream + out_bytes, 0)[0],
        } if name == "p1" else {
            "fec_gather_compact_kernel": bound(read + tables + out_bytes,
                                               0)[0]}
        extra = {"dtype": str(got.dtype).replace("torch.", ""),
                 "exact": torch.equal(got, want),
                 "library_same": torch.equal(lib.view(-1), got.view(-1)),
                 "kernels_counted_a_call": counted,
                 "kernel_bound_ms": pass_bounds}
        check("fec_gather", err, 0.0,
              lambda src=src, name=name: DF.fec_gather(src, name),
              lambda src=src, name=name: DF.fec_gather_plain(src, name),
              bound(read + tables + out_bytes, 0),
              lambda pmz=pmz, k7=k7: torch.index_select(pmz, 1, k7),
              list(got.shape), case=case,
              ok=extra["exact"] and extra["library_same"]
              and counted == len(pass_bounds), **extra)
        if name == "p1":
            segs = got
        else:
            pext = got

    # --- K7: Viterbi on those P1 segments and PIDS frames (and, below,
    # the MP3 PX frames); bits and margins exact.  Beside each line: the
    # kernel on the first segment alone, the chain one segment cannot go
    # below, and its cycles a step at the SM clock nvidia-smi reads.  On
    # K6's int8 segments the line also runs the kernel on the same values
    # in float32 (its float32 load path): the same bits and margins, and
    # that path's time ---
    def viterbi_line(name, ext, gens, k, case, plain_reps, plain_inner):
        kb, km = CV.acs_traceback(ext, gens, k)
        pb, pmg = CV.acs_traceback_plain(ext, gens, k)
        err = max((kb.int() - pb.int()).abs().max().item(),
                  (km - pmg).abs().max().item())
        b_seg, n_st = ext.shape[0], ext.shape[1]
        one = ext[:1].contiguous()
        lone_ms = time_ms(torch, lambda: CV.acs_traceback(one, gens, k),
                          graph=True)
        mhz = sm_clock_mhz()
        extra = {"dtype": str(ext.dtype).replace("torch.", "")}
        if ext.dtype == torch.int8:
            ext32 = ext.float()
            fb, fm = CV.acs_traceback(ext32, gens, k)
            extra["same_as_float32"] = torch.equal(kb, fb) \
                and torch.equal(km, fm)
            extra["float32_ms"] = time_ms(
                torch, lambda: CV.acs_traceback(ext32, gens, k), graph=True)
        check(name, err, 0.0,
              lambda: CV.acs_traceback(ext, gens, k),
              lambda: CV.acs_traceback_plain(ext, gens, k),
              bound(b_seg * n_st * (3 * ext.element_size() + 1) + b_seg * 4,
                    b_seg * n_st * ((1 << (k - 1)) * 3 + 16)),
              None, [b_seg, n_st, 3], plain_reps=plain_reps,
              plain_inner=plain_inner, case=case,
              ok=err == 0.0 and extra.get("same_as_float32", True),
              chain_floor_ms=lone_ms, clocks_sm_mhz=mhz,
              chain_cycles_a_step=lone_ms * 1e-3 * mhz * 1e6 / n_st,
              **extra)
        return kb

    viterbi_line("viterbi_k7", segs, C.CONV_K7_GEN, 7, None, 3, 1)
    viterbi_line("viterbi_k7", pext, C.CONV_K7_GEN, 7, "pids", 3, 2)

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
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))
        # the library call: one torch.take over each station's
        # [state | soft bits | 0] through an index built beforehand
        src, idx = px_take_operands(torch, *args)
        library_same = torch.equal(torch.take(src, idx).view(got[0].shape),
                                   got[0])
        # one table: a phase's row for a group's first pair (the second
        # pair's rows exist only because a CTA takes two)
        table_bytes = DF.pack3(DF.px_tables(fl)[0]).nbytes
        moved = llr.numel() + 2 * state0.numel() + table_bytes + 8 * s_n
        check("px_deinterleave", err, 0.0,
              lambda args=args: DF.px_deinterleave(*args),
              lambda args=args: DF.px_deinterleave_plain(*args),
              bound(moved + got[0].numel(), 0),
              lambda src=src, idx=idx: torch.take(src, idx),
              list(got[0].shape), plain_reps=3, plain_inner=2,
              case=case, ok=err == 0.0 and same and library_same,
              dtype="int8",
              float32_out_bound_ms=bound(moved + 4 * got[0].numel(), 0)[0],
              library_call="torch.take of each station's [state | soft "
              "bits | 0] through a prebuilt index",
              library_same=library_same,
              stack_frame_bytes=frame_of(kernel_frames, "px_deinterleave",
                                         "px_deinterleave_kernel"))
        if case is None:
            px_ext = got[0]

    # --- K7 on the MP3 PX frames: 256 frames of 4672 steps ---
    viterbi_line("viterbi_k7", px_ext, C.CONV_K7_GEN, 7, "px", 1, 1)

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

    # K12, pass 1 then pass 2 (on pass 1's spectra through the kernel).
    # The kernel writes its fold rounded to bf16 (the DFT's operand): each
    # entry must be the bf16 rounding of a value within 1e-5 of the plain
    # version's unrounded fold (bf16_fold_gate); phase_out and
    # prev_angle_out within 1e-5, keep exact
    # (a K12 that writes float32, as before it rounded, is held within 1e-5
    # of its plain version, so that the comparison calls of PERF.md §5 run
    # this script on that tree too)
    rounds = "unrounded" in inspect.signature(scar.am_fold_plain).parameters

    def fold_gate(got, spectra1=None):
        """K12's fold ``got`` (pass 2 with ``spectra1``) against its plain
        version: (ok, largest error, bf16_fold_gate's counts or None)."""
        extra = () if spectra1 is None else (spectra1,)
        want = scar.am_fold_plain(*fold_args, *extra,
                                  **({"unrounded": True} if rounds else {}))
        want = want if spectra1 is None else want[0]
        if rounds:
            return bf16_fold_gate(torch, got, want, 1e-5)
        err = (got - want).abs().max().item()
        return err <= 1e-5, err, None

    fold_args, am_spectra = am_block1(am_x, False)
    got = scar.am_fold(*fold_args)
    fold_ok, fold_err, fold_gate_counts = fold_gate(got)
    check("am_fold", fold_err, 1e-5,
          lambda: scar.am_fold(*fold_args),
          lambda: scar.am_fold_plain(*fold_args),
          bound(s_n * (nsamp_am * 8 + fold_out + 20),
                s_n * (nsamp_am * 17 + C.BLKSZ * C.CP_AM * 6)),
          None, [s_n, C.BLKSZ, C.FFT_AM, 2], ok=fold_ok, case=None,
          am_pass=1, bf16_gate=fold_gate_counts)
    spectra1 = rc.dft(got, shift=True)
    got = scar.am_fold(*fold_args, spectra1)
    want = scar.am_fold_plain(*fold_args, spectra1)
    fold_ok, fold_err, fold_gate_counts = fold_gate(got[0], spectra1)
    rest_err = max((a - b).abs().max().item()
                   for a, b in zip(got[1:3], want[1:3]))
    fold_ok = fold_ok and rest_err <= 1e-5 and torch.equal(got[3], want[3])
    check("am_fold", max(fold_err, rest_err), 1e-5,
          lambda: scar.am_fold(*fold_args, spectra1),
          lambda: scar.am_fold_plain(*fold_args, spectra1),
          bound(s_n * (nsamp_am * 8 + fold_out + C.BLKSZ * 8 + 32),
                s_n * (nsamp_am * 17 + C.BLKSZ * C.CP_AM * 6
                       + C.BLKSZ * 40)),
          None, [s_n, C.BLKSZ, C.FFT_AM, 2], ok=fold_ok, case="pass2",
          am_pass=2, bf16_gate=fold_gate_counts)

    # K5's AM carry step on pass 2's keep
    am_keep, am_offset = got[3], fold_args[1]
    k5_k, k5_p = am_offset.clone(), am_offset.clone()
    BG.block_carry_am(am_keep, k5_k)
    BG.block_carry_am_plain(am_keep, k5_p)
    check("block_carry_am", float((k5_k - k5_p).abs().max()), 0.0,
          lambda: BG.block_carry_am(am_keep, k5_k),
          lambda: BG.block_carry_am_plain(am_keep, k5_p),
          bound(s_n * 4 * 3, s_n * 2), None, [s_n])

    # K13 on block 1's spectra, MA1 and MA3: every output exact, and, where
    # this run built its source, every kernel of it with a 0-byte stack
    # frame (its tables once in a stack frame made it fault)
    k13_frames = stack_frames.get("sync_am_block")
    k13_frames_ok = k13_frames is None or all(b == 0 for b in k13_frames)
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
              ok=sum(diff.values()) == 0 and k13_frames_ok, differing=diff,
              stack_frame_bytes=("not read: the library was built before "
                                 "this run" if k13_frames is None
                                 else k13_frames))

    # K13 as the block loop launches it: with K5's AM step (pass 2's keep,
    # block 1's offset); the outputs and the offset exact
    k13_off = {"kernel": am_offset.clone(), "plain": am_offset.clone()}
    ko = scar.sync_am_block_rc(am_spectra, False, (am_keep, k13_off["kernel"]))
    po = scar.sync_am_block_rc_plain(am_spectra, False,
                                     (am_keep, k13_off["plain"]))
    diff = {k: int((ko[k] != po[k]).sum()) for k in po}
    diff["offset"] = int((k13_off["kernel"] != k13_off["plain"]).sum())
    k13_timing = am_offset.clone()
    check("sync_am_block", float(sum(diff.values())), 0.0,
          lambda: scar.sync_am_block_rc(am_spectra, False,
                                        (am_keep, k13_timing)),
          lambda: scar.sync_am_block_rc_plain(am_spectra, False,
                                              (am_keep, k13_timing)),
          (report["sync_am_block"]["bound_ms"],
           report["sync_am_block"]["bound_by"]), None,
          list(am_spectra.shape), case="carry",
          ok=sum(diff.values()) == 0, differing=diff)

    # K15 on the first dispatch's own codes (through the kernels) and a
    # random handed-on delay line, MA1 and MA3; then K7 at K=9 on its
    # P1, P3 and PIDS segments, and K8 on the P1 bits
    g = torch.Generator(device="cpu").manual_seed(SEED + 15)
    k9 = {}
    for ma3, x in ((False, am_x), (True, ma3_x)):
        codes, pids_c, _ = scar.am_frontend_scan_rc(
            x, scar.am_chain_rc_init_carry(n_stations=s_n, device=dev),
            am_blocks, ma3)
        lines = DA.AMDecodeState(*(torch.randint(
            0, 2, (s_n, DA.DD), generator=g, dtype=torch.uint8).to(dev)
            for _ in DA.DELAYED))
        gargs = (codes, pids_c, lines, ma3)
        got = DA.am_gather(*gargs)
        want = DA.am_gather_plain(*gargs)
        outs = list(got[:3]) + list(got[3])
        err = float(sum(int((a != b).sum()) for a, b in
                        zip(outs, list(want[:3]) + list(want[3]))))
        same_dtype = all(a.dtype == torch.int8 for a in got[:3])
        # the function reads and rewrites only the mode's delayed lines
        # (ml, mu; also eml, emu in MA3) and hands the others back as they
        # are; it reads the packed map once
        maps = DA.gather_maps(ma3)
        n_dly = maps["n_delayed"]
        undelayed_same = all((a is b) == (i >= n_dly) for i, (a, b) in
                             enumerate(zip(lines, got[3])))
        moved = codes.numel() + pids_c.numel() + 2 * s_n * n_dly * DA.DD \
            + DA.packed_map(ma3).nbytes
        n_out = sum(t.numel() for t in got[:3])
        check("am_gather", err, 0.0,
              lambda gargs=gargs: DA.am_gather(*gargs),
              lambda gargs=gargs: DA.am_gather_plain(*gargs),
              bound(moved + n_out, 0),
              None, [s_n, am_blocks, 4, 800], plain_reps=3, plain_inner=2,
              case="ma3" if ma3 else None,
              ok=err == 0.0 and same_dtype and undelayed_same, dtype="int8",
              undelayed_lines_same_tensors=undelayed_same,
              float32_out_bound_ms=bound(moved + 4 * n_out, 0)[0],
              library_call="none: no one PyTorch call pulls a bit plane "
              "through a gather",
              stack_frame_bytes=frame_of(kernel_frames, "am_gather",
                                         "am_gather_kernel"))
        k9["p3_ma3" if ma3 else "p3_ma1"] = got[1]
        if not ma3:
            k9["p1"], k9["pids"] = got[0], got[2]
            # K15's PIDS-only launch at the per-block receiver's shape (one
            # block's codes), the lower stream as it comes and zeroed
            # (pids1_disabled): int8 exact, one launch of its own count
            blk = pids_c[:1, :1].reshape(1, C.BLKSZ, 2).contiguous()
            for disabled in (False, True):
                before = dict(K.COUNTS)
                pgot = DA.am_gather_pids(blk, disabled)
                launched = {k: K.COUNTS[k] - before[k] for k in before
                            if K.COUNTS[k] != before[k]}
                pwant = DA.am_gather_pids_plain(blk, disabled)
                perr = float((pgot != pwant).sum())
                check("am_gather", perr, 0.0,
                      lambda blk=blk, d=disabled: DA.am_gather_pids(blk, d),
                      lambda blk=blk, d=disabled: DA.am_gather_pids_plain(
                          blk, d),
                      bound(blk.numel() + pgot.numel()
                            + 2 * DA.pids_block_map().size, 0),
                      None, list(blk.shape),
                      case="pids_only_disabled" if disabled
                      else "pids_only",
                      ok=perr == 0.0 and pgot.dtype == torch.int8
                      and launched == {"am_gather_pids": 1},
                      dtype="int8", launched=launched,
                      library_call="none: no one PyTorch call pulls a bit "
                      "plane through a gather",
                      stack_frame_bytes=frame_of(kernel_frames, "am_gather",
                                                 "am_gather_pids_kernel"))

    for key, gens in (("p1", C.CONV_E1_GEN), ("p3_ma1", C.CONV_E2_E3_GEN),
                      ("p3_ma3", C.CONV_E1_GEN), ("pids", C.CONV_E2_E3_GEN)):
        kb = viterbi_line("viterbi_k9", k9[key], gens, 9,
                          None if key == "p1" else key, 1, 1)
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
    # its three kernels: their count against the wrapper's, and each one's
    # bound (k0 from the spectra and z written; z and the 6.1 MB twiddle
    # table read, 85 x 8910 products a station (8 operations each) and the
    # 256 lane sums of each written; the lane sums and the window read,
    # the trees and the three sincos passes), beside which the profiler
    # times each after the last kernel line (splits)
    before = K.COUNTS["am_tone"]
    AA.am_tone(tone_spectra, cold_x, z32)
    counted = K.COUNTS["am_tone"] - before
    win_bytes, part_bytes = s_n * win_am * 8, s_n * AA.N_GRID * 256 * 8
    twiddle_bytes = AA.N_GRID * win_am * 8
    pass_bounds = {
        "am_tone_z_kernel": bound(
            tone_spectra.numel() * 4 + 2 * win_bytes,
            s_n * (C.BLKSZ * C.FFT_AM * 3 + win_am * 6))[0],
        "am_tone_proj_kernel": bound(
            win_bytes + twiddle_bytes + part_bytes,
            s_n * AA.N_GRID * win_am * 8)[0],
        "am_tone_tail_kernel": bound(
            part_bytes + win_bytes + s_n * 12,
            s_n * (AA.N_GRID * 256 * 2 + 3 * win_am * 20))[0]}
    check("am_tone", err, 0.0,
          lambda: AA.am_tone(tone_spectra, cold_x, z32),
          lambda: AA.am_tone_plain(tone_spectra, cold_x, z32),
          bound(tone_spectra.numel() * 4 + s_n * (win_am * 8 + 4 + 4 + 12),
                tone_ops),
          None, [s_n, win_am, 2], plain_reps=3, plain_inner=2,
          ok=err == 0.0 and counted == len(pass_bounds),
          kernels_counted_a_call=counted, kernel_bound_ms=pass_bounds)
    splits.append(("am_tone", None,
                   lambda: AA.am_tone(tone_spectra, cold_x, z32)))
    f_t, amp_t = got
    coarse_args = (cold_x, z32, f_t, amp_t, zf, no_latch)
    before = K.COUNTS["am_coarse"]
    got = AA.am_coarse(*coarse_args)
    counted = K.COUNTS["am_coarse"] - before
    want = AA.am_coarse_plain(*coarse_args)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    nsamp_cp = C.BLKSZ * C.FFTCP_AM
    coarse_bnd = bound(s_n * (win_am * 8 + 4 * 6 + 4 * 3 + 8),
                       s_n * (win_am * 12 + nsamp_cp * 8
                              + C.FFTCP_AM * C.CP_AM * 4 + C.FFTCP_AM * 3
                              + 10))
    # exact in all four outputs (a cluster of 8 CTAs a station, each
    # computing only its lanes' positions); its stack frame reported (the
    # trigonometric slow path's work array), not gated
    check("am_coarse", err, 0.0,
          lambda: AA.am_coarse(*coarse_args),
          lambda: AA.am_coarse_plain(*coarse_args), coarse_bnd,
          None, [s_n, win_am, 2], plain_reps=3, plain_inner=2,
          ok=err == 0.0 and counted == 1,
          stack_frame_bytes=frame_of(kernel_frames, "am_coldstart",
                                     "am_coarse_kernel"),
          kernels_counted_a_call=counted,
          kernel_bound_ms={"am_coarse_kernel": coarse_bnd[0]})
    splits.append(("am_coarse", None, lambda: AA.am_coarse(*coarse_args)))
    cold_samperr = got[1]
    spectra1 = rc.dft(scar.am_fold(cold_x, z32, unit, cold_samperr
                                   - C.FFTCP_AM // 2, got[2], z32),
                      shift=True)
    before = K.COUNTS["am_cfo_step"]
    got = AA.am_cfo_step(spectra1)
    counted = K.COUNTS["am_cfo_step"] - before
    want = AA.am_cfo_step_plain(spectra1)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    band = C.BLKSZ * AA.CFO_BINS
    cfo_bnd = bound(s_n * (band * 8 + AA.CFO_BINS * 4 + 4), s_n * band * 5)
    check("am_cfo_step", err, 0.0,
          lambda: AA.am_cfo_step(spectra1),
          lambda: AA.am_cfo_step_plain(spectra1), cfo_bnd,
          None, list(spectra1.shape), plain_reps=3, plain_inner=2,
          ok=err == 0.0 and counted == 1,
          stack_frame_bytes=frame_of(kernel_frames, "am_coldstart",
                                     "am_cfo_step_kernel"),
          kernels_counted_a_call=counted,
          kernel_bound_ms={"am_cfo_step_kernel": cfo_bnd[0]})
    splits.append(("am_cfo_step", None, lambda: AA.am_cfo_step(spectra1)))
    # one probe block of the cold start as its graph replays it (the
    # stations' first block: windows at 0, no CFO, no latch), device ms
    # a block; and what am_coarse and am_cfo_step add to it beyond the
    # kernels ahead of them (they start early and hide their loads)
    probe_ctl = torch.stack([z32, z32, no_latch])
    probe_state = (unit.clone(), zf.clone())

    def probe_body():
        scar._probe_body(cold_x, probe_ctl, *probe_state)

    probe_block_ms = time_ms(torch, probe_body, graph=True)
    probe_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(probe_graph):
        probe_body()

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
    # (31 N outputs over the five stages), the conversion's 3 a value.
    # Beside the bound, the no-FMA issue floor: the stages' separate float
    # operations and the conversion's two a byte (2^23 + u less 2^23 + 127,
    # times scale / 16) over every SM's 128 float32 lanes at the SM clock
    # nvidia-smi reads
    clock = sm_clock_mhz()
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    issue_ops = s_n * (31 * n_am_out * 34 + n_cu8 * 2 * 2)
    check("am_decimate_cu8", err, 0.0,
          lambda: FE.ingest_am_cu8(cu8_wire),
          lambda: FE.ingest_am_cu8_plain(cu8_wire),
          bound(s_n * n_cu8 * 2 + s_n * n_am_out * 8,
                s_n * (31 * n_am_out * 34 + n_cu8 * 2 * 3)),
          conv_cascade, [s_n, n_cu8, 2], plain_reps=3, plain_inner=2,
          byte_bound_ms=(s_n * n_cu8 * 2 + s_n * n_am_out * 8)
          / HBM_BYTES_PER_S * 1e3,
          issue_floor_ms=issue_ops / (lanes * clock * 1e6) * 1e3,
          issue_ops=issue_ops, sm_clock_mhz=clock)
    del x

    # edge shapes: one station at a few hundred outputs (the session's
    # pushes), a short last tile, rows not on a 16-byte boundary (station
    # rows lie 868 + 64 N bytes apart), and a wire that starts one pair
    # past a 4-byte boundary
    edges = {}
    for name, (rows, n_o, shift) in {
            "one_station_n300": (1, 300, 0),
            "short_tile_n257": (2, 257, 0),
            "rows_off_16_n777": (3, 777, 0),
            "pair_offset_n777": (3, 777, 1)}.items():
        n_w = FE.rc_overlap(FE.AM_STAGES) + 32 * n_o
        flat = torch.empty(2 * (rows * n_w + shift), dtype=torch.uint8,
                           device=dev)
        w = flat[2 * shift:].view(rows, n_w, 2)
        w.copy_(cu8_wire[1:1 + rows, :n_w])
        edges[name] = (FE.ingest_am_cu8(w)
                       - FE.ingest_am_cu8_plain(w)).abs().max().item()
    emit({"phase": "kernel_edges", "name": "am_decimate_cu8",
          "max_abs_err": edges, "pass": max(edges.values()) == 0.0})
    if max(edges.values()) != 0.0:
        raise AssertionError(f"am_decimate_cu8 differs on edge shapes: "
                             f"{edges}")

    # --- K16a-d: one batch of the audio fleet (128 lanes x 8 packets), at
    # the state the plain path carries after the first batch; each kernel
    # on the previous kernel's output ---
    a_state, _ = astage(audio_state0, device_inputs(preps[0][1], dev),
                        plain=True)
    a_inp = device_inputs(preps[1][1], dev)
    a_n, a_k = a_inp["spec_long"].shape[:2]
    a_s, a_m = a_k * AST.NSLOT, astage.m
    long_raw = torch.matmul(a_inp["spec_long"].reshape(a_n * a_k, -1),
                            astage.blt).reshape(a_n, a_k, 2048)
    short_raw = torch.matmul(a_inp["spec_short"].reshape(a_n * a_k * 8, -1),
                             astage.bst).reshape(a_n, a_k, 8, 256)
    args_a = (long_raw, short_raw, a_inp["win_long_idx"],
              a_inp["win_short_idx"], a_inp["short"], a_state["overlap"],
              a_state["qa_hist"], astage.lut_long, astage.lut_short,
              astage.ka)
    got = AST.window_qmf_analysis(*args_a)
    want = AST.window_qmf_analysis_plain(*args_a)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    # conv1d's input, the overlap-added core behind the history (not timed)
    ext = AST.analysis_input(*args_a[:-1])[0][:, None].contiguous()
    ka_w = astage.ka.t().contiguous()[:, None, :]
    # bytes: the two products, indices, state in and out, tables, xl;
    # operations: 320 multiply-adds an output, ~3 a core sample
    check("aac_window_qmf_analysis", err, 0.0,
          lambda: AST.window_qmf_analysis(*args_a),
          lambda: AST.window_qmf_analysis_plain(*args_a),
          bound(a_n * a_k * (2048 * 4 + 8 * 256 * 4 + 3)
                + a_n * (1024 + AST.QA_HIST) * 8
                + (13 * 2048 + 5 * 8 * 256 + 320 * 64) * 4
                + a_n * a_s * 64 * 4,
                a_n * a_s * 64 * 320 * 2 + a_n * a_k * 2048 * 3),
          lambda: torch.nn.functional.conv1d(ext, ka_w, stride=32),
          [a_n, a_k, 2048], plain_reps=3, plain_inner=2, card=smi)
    a_xl = got[0]
    args_b = (a_xl, a_state["tail_r"], a_state["tail_i"], a_inp["bwj"],
              astage.src_idx, astage.src_ok, astage.kx)
    got = AST.sbr_hf_generate(*args_b)
    want = AST.sbr_hf_generate_plain(*args_b)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    # bytes: xl, tails in and out, chirp, maps, x_high; operations: 8
    # covariance sums of ~3 a (band, slot), ~20 a patch element
    check("sbr_hf_generate", err, 0.0,
          lambda: AST.sbr_hf_generate(*args_b),
          lambda: AST.sbr_hf_generate_plain(*args_b),
          bound(a_n * a_s * 64 * 4 + a_n * 2 * 32 * 4 * 4
                + a_n * a_k * a_m * 4 + a_m * 8
                + a_n * a_k * AST.NSLOT * a_m * 8,
                a_n * a_k * 32 * AST.NSLOT * 24
                + a_n * a_k * AST.NSLOT * a_m * 20),
          None, [a_n, a_k, AST.NSLOT, a_m, 2], plain_reps=3,
          plain_inner=2, card=smi,
          registers=registers_of(regs.get("sbr_hf_generate"),
                                 "sbr_hf_generate_kernel"),
          stack_frame_bytes=frame_of(kernel_frames, "sbr_hf_generate",
                                     "sbr_hf_generate_kernel"))
    a_xh = got[0]
    args_c = (a_xh, a_xl, a_inp["env_seg"], a_inp["freq_res"],
              a_inp["e_bands"], a_inp["q_bands"], a_inp["harm_act"],
              a_inp["delta_e"], a_inp["noise_start"], a_inp["nlow"],
              a_state.get("g_hist"), a_state.get("q_hist"), astage.maps(),
              astage.noise_tab, astage.kx, astage.lim_gain, astage.interpol,
              astage.smooth)
    got = AST.sbr_hf_adjust(*args_c)
    want = AST.sbr_hf_adjust_plain(*args_c)
    err = max((a - b).abs().max().item() for a, b in zip(got, want)
              if a is not None)
    n_hi, n_q = a_inp["e_bands"].shape[-1], a_inp["q_bands"].shape[-1]
    def k16c_build(threads):
        """The registers and stack frame of K16c's instance of ``threads``
        threads a CTA (256, or 512 under the smoothing header)."""
        name = f"sbr_hf_adjust_kernelILi{threads}E"
        return dict(stack_frame_bytes=frame_of(kernel_frames,
                                               "sbr_hf_adjust", name),
                    registers=registers_of(regs.get("sbr_hf_adjust"), name))
    check("sbr_hf_adjust", err, 0.0,
          lambda: AST.sbr_hf_adjust(*args_c),
          lambda: AST.sbr_hf_adjust_plain(*args_c),
          k16c_bound(a_n, a_k, a_m, n_hi, n_q, astage.smooth),
          None, [2, a_n, a_k, AST.NSLOT, 64], plain_reps=3, plain_inner=2,
          card=smi, header="default", sbr_bins=a_m,
          **k16c_build(512 if astage.smooth else 256))
    a_x = got[0]
    # the interpol_freq = 0 and smoothing headers: one program's packets
    # tiled to the fleet's lanes, K16a and K16b on the card ahead
    for header, batch in header_batches.items():
        h_stage, h_inp, h_state = tile_lanes(torch, header, batch, a_n, dev)
        h_n, h_k = h_inp["spec_long"].shape[:2]
        h_xl = AST.window_qmf_analysis(
            torch.matmul(h_inp["spec_long"].reshape(h_n * h_k, -1),
                         h_stage.blt).reshape(h_n, h_k, 2048),
            torch.matmul(h_inp["spec_short"].reshape(h_n * h_k * 8, -1),
                         h_stage.bst).reshape(h_n, h_k, 8, 256),
            h_inp["win_long_idx"], h_inp["win_short_idx"], h_inp["short"],
            h_state["overlap"], h_state["qa_hist"], h_stage.lut_long,
            h_stage.lut_short, h_stage.ka)[0]
        h_xh = AST.sbr_hf_generate(h_xl, h_state["tail_r"], h_state["tail_i"],
                                   h_inp["bwj"], h_stage.src_idx,
                                   h_stage.src_ok, h_stage.kx)[0]
        args_h = (h_xh, h_xl, h_inp["env_seg"], h_inp["freq_res"],
                  h_inp["e_bands"], h_inp["q_bands"], h_inp["harm_act"],
                  h_inp["delta_e"], h_inp["noise_start"], h_inp["nlow"],
                  h_state.get("g_hist"), h_state.get("q_hist"),
                  h_stage.maps(), h_stage.noise_tab, h_stage.kx,
                  h_stage.lim_gain, h_stage.interpol, h_stage.smooth)
        got_h = AST.sbr_hf_adjust(*args_h)
        want_h = AST.sbr_hf_adjust_plain(*args_h)
        err_h = max((a - b).abs().max().item()
                    for a, b in zip(got_h, want_h) if a is not None)
        check("sbr_hf_adjust", err_h, 0.0,
              lambda args_h=args_h: AST.sbr_hf_adjust(*args_h),
              lambda args_h=args_h: AST.sbr_hf_adjust_plain(*args_h),
              k16c_bound(h_n, h_k, h_stage.m, h_inp["e_bands"].shape[-1],
                         h_inp["q_bands"].shape[-1], h_stage.smooth),
              None, [2, h_n, h_k, AST.NSLOT, 64], plain_reps=3,
              plain_inner=2, case=header, card=smi, header=header,
              sbr_bins=h_stage.m, interpol=h_stage.interpol,
              smooth=h_stage.smooth,
              **k16c_build(512 if h_stage.smooth else 256))
        del h_xl, h_xh, args_h, got_h, want_h
    a_v = (torch.matmul(a_x[0].reshape(-1, 64), astage.smr)
           - torch.matmul(a_x[1].reshape(-1, 64), astage.smi)).reshape(
               a_n, a_s, 128)
    args_d = (a_v, a_state["syn_hist"], astage.cidx, astage.w10)
    got = AST.qmf_synthesis(*args_d)
    want = AST.qmf_synthesis_plain(*args_d)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    # the library call: the fold alone as one grouped conv1d over Vx laid
    # out [N, 128, S + 9], channels 2i and 2i + 1 columns i and 64 + i,
    # group i's 10 taps reversed and each tap's unused column zero (the
    # layout and weights made outside the timing)
    cidx_np, w10_np = AST._synthesis_taps()
    conv_w = np.zeros((64, 2, 10), np.float32)
    for d in range(10):
        for i in range(64):
            conv_w[i, int(cidx_np[d, i] >= 64), 9 - d] = w10_np[d, i]
    conv_w = torch.from_numpy(conv_w).to(dev)
    vx_cols = torch.cat([a_state["syn_hist"], a_v], dim=1)  # [N, S + 9, 128]
    conv_in = torch.stack([vx_cols[..., :64], vx_cols[..., 64:]],
                          dim=-1).reshape(a_n, a_s + AST.SYN_HIST, 128)
    conv_in = conv_in.permute(0, 2, 1).contiguous()
    conv_out = torch.nn.functional.conv1d(conv_in, conv_w, groups=64)
    fold = sum(vx_cols[:, AST.SYN_HIST - d:AST.SYN_HIST - d + a_s,
                       astage.cidx[d].long()] * astage.w10[d]
               for d in range(10))
    conv_err = (conv_out.permute(0, 2, 1) - fold).abs().max().item()
    # bytes: V, history in and out, taps, int16 PCM; 20 operations a sample
    check("qmf_synthesis", err, 0.0,
          lambda: AST.qmf_synthesis(*args_d),
          lambda: AST.qmf_synthesis_plain(*args_d),
          bound(a_n * a_s * 128 * 4 + a_n * AST.SYN_HIST * 128 * 8
                + 10 * 64 * 8 + a_n * a_s * 64 * 2, a_n * a_s * 64 * 20),
          lambda: torch.nn.functional.conv1d(conv_in, conv_w, groups=64),
          [a_n, a_s, 128], plain_reps=3, plain_inner=2, card=smi,
          library_call="torch.nn.functional.conv1d(groups=64) of the fold "
          "alone over [N, 128, S + 9], float32 out",
          library_max_abs_diff=conv_err,
          stack_frame_bytes=frame_of(kernel_frames, "qmf_synthesis",
                                     "qmf_synthesis_kernel"),
          registers=registers_of(regs.get("qmf_synthesis"),
                                 "qmf_synthesis_kernel"))
    del conv_in, conv_out, vx_cols, fold
    del long_raw, short_raw, ext, a_xl, a_xh, a_x, a_v, args_a, args_b
    del args_c, args_d

    # --- splits: each kernel of the calls that run two (K9; K6 on P1, and
    # its PIDS line beside them), timed by the profiler.  After every
    # kernel line, because a profiler session leaves its tracing on and
    # adds to the times of the small kernels that follow it ---
    in_probe_block = exposed_spans(torch, probe_graph.replay,
                                   ("am_coarse_kernel", "am_cfo_step_kernel"))
    for name, case, fn in splits:
        spans = kernel_spans(torch, fn)
        row = report[name] if case is None else report[name]["cases"][case]
        row.update(kernels_a_call=spans["kernels_a_call"],
                   kernel_ms=spans["ms"], profiler_sessions=spans["sessions"])
        line = {"phase": "kernel_split", "name": name, "case": case,
                "kernels_a_call": spans["kernels_a_call"],
                "kernels_counted_a_call": row["kernels_counted_a_call"],
                "kernel_ms": spans["ms"],
                "kernel_bound_ms": row["kernel_bound_ms"],
                "profiler_sessions": spans["sessions"]}
        if f"{name}_kernel" in in_probe_block:
            # ms a probe block from the end of the kernel ahead to its own
            line["probe_block_exposed_ms"] = in_probe_block[f"{name}_kernel"]
            row["probe_block_exposed_ms"] = line["probe_block_exposed_ms"]
        emit(line)

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
    out_eager, _ = serve.chain_step(capture, carry, cap_blocks, psmi,
                                    first_bc, packed=True, graph=False)
    cs_graph_same = all(torch.equal(out[k], out_eager[k]) for k in out
                        if k != "diag")
    cs_dispatch = {g: wall_ms(lambda g=g: serve.chain_step(
        capture, carry, cap_blocks, psmi, first_bc, packed=True, graph=g))
        for g in (True, False)}
    cs_p1_ok = int((unpack_bits(out["p1"]) == p1_tx).all(axis=-1).sum())
    cs_pids_ok = int((unpack_bits(out["pids"]) == pids_all)
                     .all(axis=-1).sum())

    # six walls, each followed by the same cold start replayed step by
    # step (its parts, and the locks it gives)
    cs_times, cs_parts, parts_same = [], [], True
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.cold_start(capture)
        torch.cuda.synchronize()
        cs_times.append((time.perf_counter() - t0) * 1e3)
        parts, part_locks = cold_start_parts(torch, capture)
        cs_parts.append(parts)
        parts_same &= all(
            pl is not None and all(pl[k] == lk[k] for k in (
                "offset", "first_bc", "psmi", "cfo"))
            for pl, lk in zip(part_locks, locks))
    cs_device = profile_device(torch, lambda: serve.cold_start(capture))
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
             and cs_same and cs_graph_same and parts_same
             and launched == set(COLD_START) | set(STEADY))
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
          "cold_start_parts_ms_runs": cs_parts,
          "cold_start_parts_same_locks": parts_same,
          "cold_start_device_time": cs_device,
          "plain_same_locks": locks_same, "plain_same_bits": cs_same,
          "graph_same_as_eager": cs_graph_same,
          "dispatch_wall_ms_graph": cs_dispatch[True][0],
          "dispatch_wall_ms_eager": cs_dispatch[False][0],
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

    def dispatch(graph=True):
        return serve.chain_step(wire, carries, n_blocks, packed=True,
                                graph=graph)

    wall, times = wall_ms(dispatch)
    eager_wall, eager_times = wall_ms(lambda: dispatch(False))
    out_eager, _ = dispatch(False)
    graph_same = all(torch.equal(out[k], out_eager[k]) for k in out
                     if k != "diag")
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

    # one block of the frontend scan, piece by piece: K2's bf16 fold, the
    # DFT kernel, and the sync block (K4, and its plain version), each
    # launched from Python
    samperr0 = C.FFTCP_FM // 2 + carries.samperr_fb
    fold_args = (x, carries.offset, carries.phase, samperr0,
                 carries.prev_angle - carries.angle_fb, carries.cfo)
    folded = AQ.demod_fold_bf16(*fold_args)[0]
    spec = rc.dft_bf16(folded)
    block_sync = (spec, carries.costas_phase, carries.costas_freq, 1,
                  C.FFTCP_FM // 2 - samperr0)
    per_block = {
        "demod_fold_ms": time_ms(torch,
                                 lambda: AQ.demod_fold_bf16(*fold_args)),
        "dft_ms": time_ms(torch, lambda: rc.dft_bf16(folded)),
        "sync_block_ms": time_ms(
            torch, lambda: rcc.sync_block_rc(*block_sync)),
        "sync_block_plain_ms": time_ms(
            torch, lambda: rcc.sync_block_rc_plain(*block_sync))}

    device_time = profile_device(torch, dispatch)
    device_time_eager = profile_device(torch, lambda: dispatch(False))

    # the FM kernel path holds no plain version and no GEMM: one eager
    # dispatch with every plain version counted (none may be called), and
    # no GEMM among the device spans of the graph and eager dispatches
    # profiled above
    plain_calls, restore_plain = count_plain_calls()
    try:
        dispatch(False)
        torch.cuda.synchronize()
    finally:
        restore_plain()
    no_plain_no_gemm = (not plain_calls
                        and device_time["gemm_spans"] == 0
                        and device_time_eager["gemm_spans"] == 0)

    def block_loop(n, k4_bound, launches, scan_ms, fronts):
        """K5, the block loop, over ``n`` blocks: its launches and its
        bound, the sum of its work's bounds per block: K2, the 2048-point
        DFT of 512 rows as a DFT needs it (:func:`dft_bound`), K4 and K5;
        the dense bf16 product the DFT kernel runs for it apart
        (:func:`bf16_gemm_bound`, with the kernel's measured time a
        block); and the ingest and loop as the graph and launched
        eagerly."""
        rows = s_n * C.BLKSZ
        dft, gemm = dft_bound(rows, C.FFT_FM), bf16_gemm_bound(rows,
                                                               C.FFT_FM)
        terms = [(report["demod_fold"]["bound_ms"],
                  report["demod_fold"]["bound_by"]), dft,
                 (k4_bound, report["sync_block"]["bound_by"]),
                 (report["block_carry"]["bound_ms"],
                  report["block_carry"]["bound_by"])]
        return {"launches": {"demod_fold": launches["demod_fold"],
                             "dft_bf16": launches["dft_bf16"],
                             "sync_block": launches["sync_block"],
                             "block_carry": launches["block_carry"]},
                "bound_ms": n * sum(t for t, _ in terms),
                "bound_by": max(terms)[1], "dft_bound_ms": dft[0],
                "dft_bound_by": dft[1], "gemm_bound_ms": gemm[0],
                "gemm_bound_by": gemm[1], "gemm_ms": per_block["dft_ms"],
                "ms": scan_ms, "ingest_and_loop": fronts}

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
                and same and graph_same and no_plain_no_gemm
                and all(counts[n] > 0 for n in STEADY))
    emit({"phase": "slice", "stations": s_n, "blocks": n_blocks,
          "p1_frames_ok": p1_ok, "p1_frames": s_n * N_FRAMES,
          "pids_words_ok": pids_ok, "pids_words": s_n * n_blocks,
          "p1_bit_errors": out["p1_bit_errors"].cpu().tolist(),
          "launches": counts, "wall_ms": wall, "wall_ms_runs": times,
          "air_s": air_s, "realtime_factor": air_s / (wall / 1e3),
          "stages": stages, "per_block": per_block,
          "block_loop": block_loop(
              n_blocks, report["sync_block"]["bound_ms"], counts,
              stages["frontend_scan_ms"],
              front_ms(serve.fm_front, wire, carries, n_blocks)),
          "device_time": device_time, "plain_wall_ms": plain_wall,
          "plain_calls_on_kernel_path": plain_calls,
          "gemm_spans_graph": device_time["gemm_spans"],
          "gemm_spans_eager": device_time_eager["gemm_spans"],
          "plain_same_bits": same, "eager_wall_ms": eager_wall,
          "eager_wall_ms_runs": eager_times,
          "eager_realtime_factor": air_s / (eager_wall / 1e3),
          "eager_device_time": device_time_eager,
          "graph_same_as_eager": graph_same, "pass": slice_ok})
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

    # the plain path against the kernel path.  The DFT kernel sums its
    # products in another order than its plain version's float32 matmul,
    # and a last-bit difference of the spectra can cross a bf16 rounding
    # edge or a .5 demap edge and travel through the Costas and timing
    # feedback from block to block.  So the plain versions first run on
    # the DFT kernel's own spectra, as both paths ran one GEMM before the
    # DFT was a kernel: every output, pm, the consumed samples and the IV
    # state must be equal.  Then the fully plain path (the DFT's plain
    # version too): every decoded P1, PIDS and PX1 bit, the consumed
    # samples, px1_phase and the P1 re-encode error counts equal, pm and
    # the IV state within 1; the share of pm and IV entries that differ
    # is printed, beside the share by which the plain path parts from
    # itself when its spectra move by one float32 ulp (each value up or
    # down at random).
    def within_one(pairs):
        """(largest difference, share of entries that differ) over
        ``pairs`` of integer tensors."""
        d = torch.cat([(a.long() - b.long()).abs().flatten()
                       for a, b in pairs])
        return int(d.max()), float((d > 0).float().mean())

    def pms(r, plain):
        """Each dispatch's pm, from the run's own carry and wire."""
        return [rcc.frontend_scan_rc(serve.ingest(r["wires"][d]),
                                     r["carries"][d], DISPATCH_BLOCKS,
                                     MP3_PSMI, plain=plain)[0]
                for d in range(MP3_DISPATCHES)]

    exact_dft = rc.dft_bf16_plain
    ulp_gen = torch.Generator(device=dev).manual_seed(SEED)

    def moved_dft(a):
        out = exact_dft(a)
        up = torch.rand(out.shape, generator=ulp_gen, device=dev) < 0.5
        inf = torch.full_like(out, math.inf)
        return torch.where(up, torch.nextafter(out, inf),
                           torch.nextafter(out, -inf))

    def plain_run(dft):
        """The three dispatches through the plain versions with ``dft`` as
        the DFT's, and each dispatch's pm."""
        rc.dft_bf16_plain = dft
        try:
            r = mp3_run(plain=True)
            return r, pms(r, True)
        finally:
            rc.dft_bf16_plain = exact_dft

    k_pm = pms(run, False)
    srun, s_pm = plain_run(rc.dft_bf16)
    kc, sc = run["carries"][-1], srun["carries"][-1]
    on_kernel_spectra = all(torch.equal(a[k], b[k]) for a, b in zip(
        run["outs"], srun["outs"]) for k in a if k != "diag") and all(
        np.array_equal(a, b) for a, b in zip(run["consumed"],
                                              srun["consumed"])) and all(
        torch.equal(a, b) for a, b in zip(k_pm, s_pm)) and torch.equal(
        kc.px1_internal, sc.px1_internal) and torch.equal(kc.px1_phase,
                                                          sc.px1_phase)
    carry_fields_apart = [f for f in kc._fields
                          if not torch.equal(getattr(kc, f), getattr(sc, f))]
    del srun, s_pm
    prun, p_pm = plain_run(exact_dft)
    wrun, w_pm = plain_run(moved_dft)
    pc, wc = prun["carries"][-1], wrun["carries"][-1]
    bits_same = all(torch.equal(a[k], b[k]) for a, b in zip(
        run["outs"], prun["outs"]) for k in ("p1", "pids", "px1")) and all(
        np.array_equal(a, b) for a, b in zip(run["consumed"],
                                              prun["consumed"])) \
        and torch.equal(kc.px1_phase, pc.px1_phase)
    soft = {"pm": within_one(list(zip(k_pm, p_pm))),
            "iv_state": within_one([(kc.px1_internal, pc.px1_internal)]),
            "p1_bit_errors": within_one([
                (a["p1_bit_errors"], b["p1_bit_errors"])
                for a, b in zip(run["outs"], prun["outs"])])}
    spread = {"pm": within_one(list(zip(w_pm, p_pm))),
              "iv_state": within_one([(wc.px1_internal, pc.px1_internal)])}
    margins = {k: [float((a[k] - b[k]).abs().max()) for a, b in zip(
        run["outs"], prun["outs"])] for k in ("p1_margin", "px1_margin")}
    fully_plain_ok = bits_same and soft["p1_bit_errors"][0] == 0 and all(
        soft[k][0] <= 1 for k in ("pm", "iv_state"))
    del k_pm, p_pm, w_pm, prun, wrun

    # dispatch 1 (from dispatch 0's carry) timed, split and profiled
    def dispatch_mp3(graph=True):
        return serve.chain_step(run["wires"][1], run["carries"][1],
                                DISPATCH_BLOCKS, MP3_PSMI, 0, packed=True,
                                graph=graph)

    mp3_wall, mp3_times = wall_ms(dispatch_mp3)
    mp3_eager_wall, mp3_eager_times = wall_ms(lambda: dispatch_mp3(False))
    out_e, carry_e = dispatch_mp3(False)
    mp3_graph_same = all(torch.equal(run["outs"][1][k], out_e[k])
                         for k in out_e if k != "diag") and all(
        torch.equal(a, b) for a, b in zip(run["carries"][2], carry_e._replace(
            offset=torch.zeros_like(carry_e.offset))))
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
    mp3_device_eager = profile_device(torch, lambda: dispatch_mp3(False))

    n_disp = MP3_DISPATCHES
    mp3_ok = (p1_ok == s_n * 2 * n_disp
              and pids_ok == s_n * DISPATCH_BLOCKS * n_disp
              and px_ok == s_n * 16 * (n_disp - 1) and launches_ok
              and not plain_calls and on_kernel_spectra and fully_plain_ok
              and mp3_graph_same
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
          "plain_on_kernel_spectra_same": on_kernel_spectra,
          "plain_on_kernel_spectra_carry_fields_apart": carry_fields_apart,
          "plain_same_bits_consumed_px1_phase": bits_same,
          "plain_max_diff_and_share": soft,
          "plain_one_ulp_spread_max_diff_and_share": spread,
          "plain_margin_max_diff": margins,
          "wall_ms": mp3_wall, "wall_ms_runs": mp3_times, "air_s": mp3_air,
          "realtime_factor": mp3_air / (mp3_wall / 1e3),
          "stages": mp3_stages, "device_time": mp3_device,
          "block_loop": block_loop(
              DISPATCH_BLOCKS,
              report["sync_block"]["cases"]["psmi3"]["bound_ms"],
              run["launches"][1], mp3_stages["frontend_scan_ms"],
              front_ms(serve.fm_front, run["wires"][1], run["carries"][1],
                       DISPATCH_BLOCKS, MP3_PSMI)),
          "eager_wall_ms": mp3_eager_wall,
          "eager_wall_ms_runs": mp3_eager_times,
          "eager_realtime_factor": mp3_air / (mp3_eager_wall / 1e3),
          "eager_device_time": mp3_device_eager,
          "graph_same_as_eager": mp3_graph_same, "pass": mp3_ok})
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
    def dispatch_am(graph=True):
        return serve.chain_step_am(run["wires"][1], run["carries"][1],
                                   AM_FRAMES, packed=True, graph=graph)

    am_wall, am_times = wall_ms(dispatch_am)
    am_eager_wall, am_eager_times = wall_ms(lambda: dispatch_am(False))
    out_e, carry_e = dispatch_am(False)
    carry_e = carry_e._replace(offset=torch.zeros_like(carry_e.offset))
    am_graph_same = all(torch.equal(run["outs"][1][k], out_e[k])
                        for k in out_e) and all(
        torch.equal(a, b) for a, b in zip(
            list(run["carries"][2][:-1]) + list(run["carries"][2].dec),
            list(carry_e[:-1]) + list(carry_e.dec)))
    am_air = float(run["consumed"][1].sum()) / C.SAMPLE_RATE_CS16_AM
    cy1 = run["carries"][1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    x = serve.ingest(run["wires"][1], "am")
    ev[1].record()
    codes, pids_c, _ = scar.am_frontend_scan_rc(x, cy1, am_blocks)
    ev[2].record()
    exts = DA.am_gather(codes, pids_c, cy1.dec)
    ev[3].record()
    DA.am_fec(*exts[:3], packed=True)
    ev[4].record()
    ev[4].synchronize()
    am_stages = dict(zip(("ingest_ms", "block_loop_ms", "gather_ms",
                          "fec_ms"),
                         (ev[i].elapsed_time(ev[i + 1]) for i in range(4))))
    am_device = profile_device(torch, dispatch_am)
    am_device_eager = profile_device(torch, lambda: dispatch_am(False))
    rows = s_n * C.BLKSZ
    dft, gemm = dft_bound(rows, C.FFT_AM), gemm_bound(rows, C.FFT_AM)
    am_terms = [(report["am_fold"]["bound_ms"],
                 report["am_fold"]["bound_by"]),
                (report["am_fold"]["cases"]["pass2"]["bound_ms"],
                 report["am_fold"]["cases"]["pass2"]["bound_by"]),
                (2 * dft[0], dft[1]),
                (report["sync_am_block"]["bound_ms"],
                 report["sync_am_block"]["bound_by"]),
                (report["block_carry_am"]["bound_ms"],
                 report["block_carry_am"]["bound_by"])]
    am_loop = {"launches": {"am_fold": run["launches"][1].get("am_fold", 0),
                            "dft_gemm": 2 * am_blocks,
                            "sync_am_block":
                                run["launches"][1].get("sync_am_block", 0),
                            "block_carry_am":
                                run["launches"][1].get("block_carry_am", 0)},
               "bound_ms": am_blocks * sum(t for t, _ in am_terms),
               "bound_by": max(am_terms)[1],
               "dft_bound_ms": dft[0], "dft_bound_by": dft[1],
               "gemm_bound_ms": gemm[0], "gemm_bound_by": gemm[1],
               "ms": am_stages["block_loop_ms"],
               "ingest_and_loop": front_ms(serve.am_front, run["wires"][1],
                                           run["carries"][1], am_blocks)}

    n_later = AM_DISPATCHES * AM_FRAMES - 3
    am_ok = (p1_ok == s_n * n_later * 8 and p3_ok == s_n * n_later
             and pids_ok == s_n * am_blocks * AM_DISPATCHES
             and am_launches_ok and not plain_calls and plain_ok
             and am_graph_same and am_air / (am_wall / 1e3) >= 1)
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
          "block_loop": am_loop, "eager_wall_ms": am_eager_wall,
          "eager_wall_ms_runs": am_eager_times,
          "eager_realtime_factor": am_air / (am_eager_wall / 1e3),
          "eager_device_time": am_device_eager,
          "graph_same_as_eager": am_graph_same, "pass": am_ok})
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

    _, cold_times = wall_ms(lambda: serve.cold_start(cold_wire, "am"), 5)
    _, cold_eager_times = wall_ms(
        lambda: serve.cold_start(cold_wire, "am", graph=False), 5)
    eager_locks = serve.cold_start(cold_wire, "am", graph=False)
    cold_graph_same = all(
        (a is None and b is None) or (a is not None and b is not None and all(
            a[k] == b[k] for k in lock_keys) and all(
                torch.equal(u, v) for u, v in zip(a["carry"][:-1],
                                                  b["carry"][:-1])))
        for a, b in zip(locks, eager_locks))
    # the device's busy time beside the wall, which is host-bound and
    # spread: three profiled cold starts, the busiest reported, since a
    # profiler session that drops spans can only read short
    cold_devices = [profile_device(torch, lambda: serve.cold_start(cold_wire,
                                                                   "am"))
                    for _ in range(3)]
    cold_device = max(cold_devices, key=lambda d: d["busy_ms"])
    cold_device_eager = profile_device(
        torch, lambda: serve.cold_start(cold_wire, "am", graph=False))
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
               and plain_locks_same and plain_bits_same and cold_graph_same)
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
          "probe_block_ms": probe_block_ms,
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
          "cold_start_busy_ms_runs": [d["busy_ms"] for d in cold_devices],
          "eager_cold_start_wall_ms": statistics.median(cold_eager_times[1:]),
          "eager_cold_start_wall_ms_runs": cold_eager_times,
          "graph_same_locks_as_eager": cold_graph_same,
          "eager_device_time": cold_device_eager,
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

    # --- am_cu8_decode: the cu8 AM fleet at a tuner's level decoded
    # straight from the wire through serve.chain_step_am (K1's AM cascade
    # in each dispatch's graph), three dispatches of 2 frames; the same
    # dispatches through the plain versions and launched eagerly ---
    dec_q = torch.from_numpy(am_cu8_dec["wire"]).to(dev)
    plain_calls, restore = count_plain_calls()
    try:
        dec_run = am_cu8_decode_run(torch, dec_q, dev)
    finally:
        restore()
    dec_gate = am_cu8_gate(dec_run, am_cu8_dec)
    dec_launches_ok = all(n == {"am_decimate_cu8": 1, **AM_LAUNCHES}
                          for n in dec_run["launches"])
    dec_plain = am_cu8_decode_run(torch, dec_q, dev, plain=True)
    keys = ("p1", "p3", "pids", "p1_margin", "p3_margin")
    n_entries = sum(out[k].numel() for out in dec_run["outs"] for k in keys)
    n_diff = sum(int((a[k] != b[k]).sum()) for a, b in zip(
        dec_run["outs"], dec_plain["outs"]) for k in keys)
    hdc_plain_same = am_cu8_hdc(dec_plain) == dec_gate.pop("hdc")

    def dispatch_cu8(graph=True):
        return serve.chain_step_am(dec_run["wires"][1],
                                   dec_run["carries"][1], AM_FRAMES,
                                   graph=graph)

    cu8_wall, cu8_times = wall_ms(dispatch_cu8)
    out_e, _ = dispatch_cu8(False)
    cu8_graph_same = all(torch.equal(dec_run["outs"][1][k], out_e[k])
                         for k in out_e)
    # the profiler drops spans at times: of three profiles, the one with
    # the most spans
    cu8_device = max((profile_device(torch, dispatch_cu8) for _ in range(3)),
                     key=lambda d: d["spans"])
    # the dispatch's stages by CUDA events, eagerly: K1's AM cascade (the
    # ingest), the block loop, the gathers, the FEC
    cy1 = dec_run["carries"][1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    x = serve.ingest(dec_run["wires"][1], "am")
    ev[1].record()
    codes, pids_c, _ = scar.am_frontend_scan_rc(x, cy1, am_blocks)
    ev[2].record()
    exts = DA.am_gather(codes, pids_c, cy1.dec)
    ev[3].record()
    DA.am_fec(*exts[:3])
    ev[4].record()
    ev[4].synchronize()
    cu8_stages = dict(zip(("ingest_ms", "block_loop_ms", "gather_ms",
                           "fec_ms"),
                          (ev[i].elapsed_time(ev[i + 1]) for i in range(4))))
    del x, codes, pids_c, exts
    cascade_ms = report["am_decimate_cu8"]["ms"]
    dec_ok = (dec_gate["pass"] and dec_launches_ok and not plain_calls
              and n_diff <= 1e-5 * n_entries and hdc_plain_same
              and cu8_graph_same)
    emit({"phase": "am_cu8_decode", "stations": s_n,
          "distinct_stations": AM_CU8_DISTINCT, "level": AM_CU8_LEVEL,
          "dispatches": AM_DISPATCHES, "frames_per_dispatch": AM_FRAMES,
          "wire_shape": list(dec_run["wires"][0].shape), **dec_gate,
          "launches_per_dispatch": dec_run["launches"],
          "plain_calls_on_kernel_path": plain_calls,
          "plain_entries_differing": n_diff, "plain_entries": n_entries,
          "hdc_plain_same": hdc_plain_same,
          "graph_same_as_eager": cu8_graph_same,
          "wall_ms": cu8_wall, "wall_ms_runs": cu8_times,
          "device_time": cu8_device, "stages": cu8_stages,
          "cascade_ms": cascade_ms,
          "cascade_share_of_kernel_busy":
              cascade_ms / cu8_device["kernel_busy_ms"],
          "cascade_share_of_stages":
              cu8_stages["ingest_ms"] / sum(cu8_stages.values()),
          "cs16_dispatch": {"wall_ms": am_wall,
                            "kernel_busy_ms": am_device["kernel_busy_ms"],
                            "busy_ms": am_device["busy_ms"],
                            "spans": am_device["spans"],
                            "stages": am_stages},
          "pass": dec_ok})
    if not dec_ok:
        raise AssertionError("the cu8 AM fleet did not decode through K1's "
                             "AM cascade with its HDC packets exact")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["am_cu8_decode"] = sum(n.get(name, 0)
                                       for n in dec_run["launches"])
        report[name]["launches"] = sum(by_path.values())
    del dec_q, dec_run, dec_plain

    # --- audio: 64 stereo programs (128 lanes) x 8 packets, three
    # dispatches with the state carried; the plain path from a copy of the
    # same device state on the same prepared inputs ---
    audio_launches, audio_pcm, audio_same = [], [], True
    plain_state = {k: v.clone() for k, v in audio_state0.items()}
    for d in range(AUDIO_DISPATCHES):
        torch.cuda.synchronize()
        plain_calls, restore = count_plain_calls()
        K.reset_counts()
        try:
            pcm = adec.dispatch(preps[d])
        finally:
            torch.cuda.synchronize()
            restore()
        audio_launches.append({"launches": {n: c for n, c in
                                            K.COUNTS.items() if c},
                               "plain_calls": plain_calls})
        plain_state, ppcm = astage(plain_state,
                                   device_inputs(preps[d][1], dev),
                                   plain=True)
        ppcm = ppcm.cpu().numpy().reshape(AUDIO_PROGRAMS, 2, -1).transpose(
            0, 2, 1)
        audio_same &= bool(np.array_equal(pcm, ppcm)) and sorted(
            plain_state) == sorted(adec._state) and all(
            torch.equal(adec._state[k], plain_state[k]) for k in plain_state)
        audio_pcm.append(pcm)
    out = np.concatenate(audio_pcm, axis=1).astype(np.float64)
    skip = 2 * 2048  # packets 0-1: the filterbank and QMF ramp-in
    snr = []
    for p in range(AUDIO_PROGRAMS):
        ref = audio_host[p % len(AUDIO_STREAMS)].astype(np.float64)[skip:]
        for c in range(2):
            e = ((ref[:, c] - out[p, skip:, c]) ** 2).sum()
            snr.append(float(10 * np.log10((ref[:, c] ** 2).sum()
                                           / max(e, 1e-30))))
    a_inputs = [preps[d][1] for d in range(AUDIO_DISPATCHES)]
    n_short = int(sum(inp["short"].sum() for inp in a_inputs))
    launches_ok = all(
        rec["launches"] == {n: 1 for n in AUDIO_KERNELS}
        and not rec["plain_calls"] for rec in audio_launches)

    def audio_device_half():
        _, pcm = astage(adec._state, device_inputs(preps[0][1], dev))
        return pcm.cpu()

    audio_device_half()
    torch.cuda.synchronize()
    wall = []
    for _ in range(9):
        t0 = time.perf_counter()
        audio_device_half()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    dispatch_ms = statistics.median(wall[2:])
    audio_s = AUDIO_PROGRAMS * AUDIO_PACKETS * 2048 / AUDIO_FS
    audio_device = profile_device(torch, audio_device_half)
    audio_ok = (audio_same and launches_ok and min(snr) >= AUDIO_SNR_DB
                and n_short > 0)
    emit({"phase": "audio", "card": smi, "programs": AUDIO_PROGRAMS,
          "lanes": 2 * AUDIO_PROGRAMS, "packets": AUDIO_PACKETS,
          "dispatches": AUDIO_DISPATCHES, "streams": list(AUDIO_STREAMS),
          "sbr_bins": astage.m, "kx": astage.kx,
          "caps": [astage.cap_long, astage.cap_short],
          "short_windows": n_short, "launches_per_dispatch": audio_launches,
          "plain_same_pcm_and_state": audio_same,
          "snr_db_min": min(snr), "snr_db_by_stream": {
              k: min(snr[2 * p + c] for p in range(i, AUDIO_PROGRAMS,
                                                   len(AUDIO_STREAMS))
                     for c in range(2))
              for i, k in enumerate(AUDIO_STREAMS)},
          "snr_gate_db": AUDIO_SNR_DB,
          "prepare_wall_ms": statistics.median(prepare_ms),
          "prepare_wall_ms_runs": prepare_ms,
          "dispatch_wall_ms": dispatch_ms, "dispatch_wall_ms_runs": wall,
          "audio_seconds_per_dispatch": audio_s,
          "audio_seconds_per_dispatch_second": audio_s / dispatch_ms * 1e3,
          "kernel_ms": {n: report[n]["ms"] for n in AUDIO_KERNELS},
          "kernel_bound_ms": {n: report[n]["bound_ms"]
                              for n in AUDIO_KERNELS},
          "device_time": audio_device, "pass": audio_ok})
    if not audio_ok:
        raise AssertionError("the audio fleet did not decode through the "
                             "four kernels to the host decoder's PCM")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["audio"] = sum(rec["launches"].get(name, 0)
                               for rec in audio_launches)
        report[name]["launches"] = sum(by_path.values())

    # --- serve_fm, serve_am: the receiver over 16 stations each, cold
    # started from the stream, one station losing its lock in a hole ---
    def event_keys(events):
        return [(e.type.name, sorted(
            (k, v.tobytes() if isinstance(v, np.ndarray) else repr(v))
            for k, v in e.payload.items())) for e in events]

    for mode, fleet_s in (("fm", serve_fm), ("am", serve_am)):
        plain_calls, restore = count_plain_calls()
        try:
            events, wall, counts, record, rx = serve_run(torch, fleet_s,
                                                         mode, dev)
        finally:
            restore()
        gate = serve_gate(events, fleet_s, mode, counts, record)
        e_events, e_wall, e_counts, e_record, _ = serve_run(
            torch, fleet_s, mode, dev, graph=False)
        e_gate = serve_gate(e_events, fleet_s, mode, e_counts, e_record)
        same = all(event_keys(events[i]) == event_keys(e_events[i])
                   for i in events)
        # the first run captured the graphs it had not met before (the
        # one-station AM probe's): a second run times the warm graphs
        w_events, w_wall, *_ = serve_run(torch, fleet_s, mode, dev)
        same &= all(event_keys(events[i]) == event_keys(w_events[i])
                    for i in events)
        busy = profile_device(torch, lambda: serve_run(torch, fleet_s, mode,
                                                       dev))
        busy_eager = profile_device(torch, lambda: serve_run(
            torch, fleet_s, mode, dev, graph=False))
        rate = 2 * C.SAMPLE_RATE_CS16_FM * 2 if mode == "fm" \
            else C.SAMPLE_RATE_CS16_AM * 4  # wire bytes a second
        air = sum(w.nbytes for w in fleet_s["wire"]) / rate
        kinds = ("SYNC", "LOST_SYNC", "HDC", "ID3", "STATION_NAME", "BER",
                 "MER")
        ok = gate["pass"] and not plain_calls and same
        emit({"phase": f"serve_{mode}", "card": smi,
              "stations": len(fleet_s["wire"]),
              "hole_station": SERVE_HOLE_STATION, "hole_s": SERVE_HOLE_S,
              **gate, "plain_calls_on_kernel_path": plain_calls,
              "station_seconds": air, "wall_s": wall,
              "station_seconds_per_second": air / wall,
              "wall_ms_per_dispatch": wall * 1e3 / gate["dispatches"],
              "warm_wall_s": w_wall,
              "warm_station_seconds_per_second": air / w_wall,
              "warm_wall_ms_per_dispatch":
                  w_wall * 1e3 / gate["dispatches"],
              "eager_wall_s": e_wall,
              "eager_station_seconds_per_second": air / e_wall,
              "eager_wall_ms_per_dispatch":
                  e_wall * 1e3 / e_gate["dispatches"],
              "eager_pass": e_gate["pass"], "graph_same_events_as_eager":
                  same, "device_time": busy, "eager_device_time": busy_eager,
              "events_per_station": {
                  k: [sum(e.type.name == k for e in events[i])
                      for i in sorted(events)] for k in kinds},
              "pass": ok})
        if not ok:
            raise AssertionError(f"serve_{mode} did not pass its gate")
        for name in KERNELS:
            by_path = report[name]["launches_by_path"]
            by_path[f"serve_{mode}"] = counts.get(name, 0)
            report[name]["launches"] = sum(by_path.values())

    # --- session_fm: the golden drive through the port's CLI; session_am:
    # one MA1 station through the session from cs16 ---
    root = Path(__file__).resolve().parent / "build" / "session"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    capture = root / "golden.cu8"
    golden.tofile(capture)
    air = golden.size / 2 / C.SAMPLE_RATE_CU8
    fm_runs = [session_fm_run(torch, capture, root / f"fm{i}")
               for i in range(2)]
    fm_gates = [session_fm_gate(r, capture, root / f"fm{i}")
                for i, r in enumerate(fm_runs)]
    fm_busy = profile_device(torch, lambda: session_fm_run(
        torch, capture, root / "fm_profiled"))
    ok = all(g["pass"] for g in fm_gates)
    emit({"phase": "session_fm", "card": smi,
          "capture_bytes": int(golden.size), "air_seconds": air,
          **fm_gates[0], "launches": fm_runs[0]["launches"],
          "plain_calls_on_kernel_path": fm_runs[0]["plain_calls"],
          "runs": [{"wall_s": r["wall_s"], "air_seconds_per_second":
                    air / r["wall_s"], "cold_start_ms": r["cold_start_ms"],
                    "pass": g["pass"]} for r, g in zip(fm_runs, fm_gates)],
          "log": [ln for ln in fm_runs[0]["lines"]
                  if not ln.startswith(("BER", "MER"))],
          "device_time": fm_busy, "pass": ok})
    if not ok:
        raise AssertionError("session_fm: the golden drive through the CLI "
                             "did not pass its gate")
    am_wire, am_packets = session_am_capture
    am_air = len(am_wire) / C.SAMPLE_RATE_CS16_AM
    am_runs = [session_am_run(torch, am_wire, am_packets) for _ in range(2)]
    am_busy = profile_device(torch, lambda: session_am_run(
        torch, am_wire, am_packets))
    am_gates = [r["syncs"] == 1 and r["lost_syncs"] == 0
                and r["hdc_exact"] >= SESSION_AM_MIN_HDC
                and r["hdc_foreign"] == 0 and not r["plain_calls"]
                and set(r["launches"]) == set(SESSION_AM_KERNELS)
                for r in am_runs]
    ok = all(am_gates)
    emit({"phase": "session_am", "card": smi, "mode": "MA1",
          "frames": SESSION_AM_FRAMES, "push_samples": SESSION_AM_PUSH,
          "air_seconds": am_air,
          **{k: am_runs[0][k] for k in ("syncs", "lost_syncs", "hdc_exact",
                                        "hdc_foreign", "launches")},
          "hdc_exact_gate": SESSION_AM_MIN_HDC,
          "hdc_sent": sum(len(pk) for _, pk in am_packets),
          "plain_calls_on_kernel_path": am_runs[0]["plain_calls"],
          "runs": [{"wall_s": r["wall_s"], "air_seconds_per_second":
                    am_air / r["wall_s"], "cold_start_ms": r["cold_start_ms"],
                    "hdc_exact": r["hdc_exact"], "pass": g}
                   for r, g in zip(am_runs, am_gates)],
          "device_time": am_busy, "pass": ok})
    if not ok:
        raise AssertionError("session_am did not pass its gate")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["session_fm"] = fm_runs[0]["launches"].get(name, 0)
        by_path["session_am"] = am_runs[0]["launches"].get(name, 0)
        report[name]["launches"] = sum(by_path.values())

    # --- fleet: 16 fake rtl_tcp tuners (8 MP1 with HDC audio, 2 MP3, 4
    # MA1, 2 MA3) through RtlTcpFleet(modes="auto") and fleet audio ---
    t_phase = time.perf_counter()
    run = fleet_run(torch, tuners)
    gate = fleet_gate(run, tuners)
    air = sum(tuners["air_s"])
    n_audio = sum(e.type.name == "AUDIO" for evs in run["events"].values()
                  for e in evs)
    audio_air = n_audio * 2048 / AUDIO_FS
    caps = run["captures"]
    prep, disp = run["walls"]["prepare"], run["walls"]["dispatch"]
    emit({"phase": "fleet", "card": smi, "stations": len(FLEET_KINDS),
          "kinds": list(FLEET_KINDS), "frames": FLEET_FRAMES, **gate,
          "wall_s": run["stop_s"], "wall_with_audio_flush_s": run["wall_s"],
          "pushed_s": run["pushed_s"], "deadline_s": FLEET_DEADLINE_S,
          "station_seconds": air,
          "station_seconds_per_second": air / run["stop_s"],
          "graph_captures": len(caps),
          "graph_capture_s": sum(c[1] for c in caps),
          "graph_captures_by_key": [[[str(x) for x in c[0]], c[1]]
                                    for c in caps],
          "audio_events": n_audio, "audio_seconds": audio_air,
          "audio_seconds_per_second": audio_air / run["wall_s"],
          "audio_batches": len(disp),
          "prepare_wall_ms": 1e3 * statistics.median(prep) if prep
          else None, "prepare_wall_s_total": sum(prep),
          "dispatch_wall_ms": 1e3 * statistics.median(disp) if disp
          else None, "dispatch_wall_s_total": sum(disp),
          "launches": {k: c for k, c in run["counts"].items() if c},
          "tuner_commands": [sorted({c[0] for c in cmds})
                             for cmds in run["commands"]],
          "phase_seconds": time.perf_counter() - t_phase})
    if not gate["pass"]:
        raise AssertionError("fleet: the live mixed fleet did not pass its "
                             "gate")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["fleet"] = run["counts"].get(name, 0)
        report[name]["launches"] = sum(by_path.values())

    # --- receiver_fm: the per-block FM receiver and the turbo receiver on
    # the card through the session (chain="block"): the golden capture as
    # cu8, per-block, then through the plain versions, then turbo; one MP3
    # and one MP11 station through FMReceiver ---
    from nrsc5_tpu_torch.api.session import MODE_AM, MODE_FM
    t_phase = time.perf_counter()
    push = 32768  # the CLI's file reads
    # twice: the first run meets each op's first call (cuFFT plans)
    fm_runs = [block_session_run(torch, golden, MODE_FM, push)
               for _ in range(2)]
    fm_block = fm_runs[0]
    fm_block_plain = block_session_run(torch, golden, MODE_FM, push,
                                       plain=True)
    fm_turbo = block_session_run(torch, golden, MODE_FM, push, turbo=True)

    def hdc_of(run):
        return [e.data for e in run["events"] if e.type.name == "HDC"]

    def frames_of(run, chans, margins=False):
        return [(c, b.tobytes(), m if margins else None)
                for c, b, m in run["frames"] if c in chans]
    titles = sum(e.type.name == "ID3" and e.title == GOLDEN_TITLE
                 for e in fm_block["events"])
    lots = [e for e in fm_block["events"] if e.type.name == "LOT"]
    px_runs = [block_px_run(torch, block_px[p], p) for p in (3, 11)]
    gate = {
        "syncs": [e.psmi for e in fm_block["events"]
                  if e.type.name == "SYNC"],
        "titles": titles, "titles_cpu_twin": BLOCK_GOLDEN_TITLES,
        "lots": [(e.name, len(e.data)) for e in lots],
        "lots_cpu_twin": BLOCK_GOLDEN_LOTS,
        "p1_pids_equal_plain": frames_of(fm_block, (-1, 0))
        == frames_of(fm_block_plain, (-1, 0)),
        "p1_frames": sum(c == 0 for c, _, _ in fm_block["frames"]),
        "pids_words": sum(c == -1 for c, _, _ in fm_block["frames"]),
        "hdc_packets": len(hdc_of(fm_block)),
        "turbo_hdc_equal": hdc_of(fm_turbo) == hdc_of(fm_block),
        "turbo_p1_pids_equal": frames_of(fm_turbo, (-1, 0))
        == frames_of(fm_block, (-1, 0)),
        "kernels_launched": sorted(fm_block["launches"]),
    }
    gate["warm_run_same_frames"] = frames_of(fm_runs[1], (-1, 0)) \
        == frames_of(fm_block, (-1, 0))
    ok = (gate["syncs"] == [1] and titles == BLOCK_GOLDEN_TITLES
          and gate["warm_run_same_frames"]
          and len(lots) == BLOCK_GOLDEN_LOTS
          and all(e.name == GOLDEN_LOT_NAME
                  and bytes(e.data) == GOLDEN_LOT_DATA for e in lots)
          and gate["p1_pids_equal_plain"] and gate["p1_frames"] > 0
          and gate["turbo_hdc_equal"] and gate["turbo_p1_pids_equal"]
          and gate["hdc_packets"] > 0
          and set(fm_block["launches"]) == set(BLOCK_FM_KERNELS)
          and set(fm_turbo["launches"]) == set(BLOCK_FM_KERNELS)
          and not fm_block["plain_calls"] and not fm_turbo["plain_calls"]
          and all(r["pass"] for r in px_runs))
    emit({"phase": "receiver_fm", "card": smi, **gate,
          "launches": fm_block["launches"],
          "launches_turbo": fm_turbo["launches"],
          "plain_calls_on_kernel_path": fm_block["plain_calls"],
          "blocks": fm_block["blocks"],
          "wall_s": [r["wall_s"] for r in fm_runs],
          "wall_ms_per_block": [1e3 * r["wall_s"] / max(r["blocks"], 1)
                                for r in fm_runs],
          "plain_wall_ms_per_block": 1e3 * fm_block_plain["wall_s"]
          / max(fm_block_plain["blocks"], 1),
          "turbo_blocks": fm_turbo["blocks"],
          "turbo_wall_ms_per_block": 1e3 * fm_turbo["wall_s"]
          / max(fm_turbo["blocks"], 1),
          "px_stations": px_runs,
          "phase_seconds": time.perf_counter() - t_phase, "pass": ok})
    if not ok:
        raise AssertionError("receiver_fm did not pass its gate")

    # --- receiver_am: session_am's capture, rdbi set from frame
    # BLOCK_AM_RDBI_FROM on, and an MA3 capture through the per-block AM
    # receiver on the card; every K15 PIDS-only launch held to its plain
    # version, every PIDS word, P1 and P3 frame and margin to the same run
    # through the CPU twins ---
    t_phase = time.perf_counter()
    am_wire, am_packets = block_am_capture
    pids_calls, gather_pids = [], DA.am_gather_pids

    def recorded(pids, disabled=False, plain=False):
        out = gather_pids(pids, disabled, plain)
        pids_calls.append((pids.clone(), bool(disabled), out.clone()))
        return out
    DA.am_gather_pids = recorded
    try:
        am_block = block_session_run(torch, am_wire, MODE_AM,
                                     SESSION_AM_PUSH)
    finally:
        DA.am_gather_pids = gather_pids
    am_warm = block_session_run(torch, am_wire, MODE_AM, SESSION_AM_PUSH)
    am_plain = block_session_run(torch, am_wire, MODE_AM, SESSION_AM_PUSH,
                                 plain=True)
    am3_wire, am3_packets = block_am3_capture
    am3_block = block_session_run(torch, am3_wire, MODE_AM, SESSION_AM_PUSH)
    am3_plain = block_session_run(torch, am3_wire, MODE_AM, SESSION_AM_PUSH,
                                  plain=True)
    pids_diff = [int((out != DA.am_gather_pids_plain(p, d)).sum())
                 for p, d, out in pids_calls]

    def am_gate(run, plain_run, packets, psmi):
        clean = {e.data for e in run["events"]
                 if e.type.name == "HDC" and not e.crc_error}
        sent = {bytes(p) for _, pk in packets for p in pk}
        chans = (-1, 0, 3)
        return {
            "syncs": [int(e.psmi) for e in run["events"]
                      if e.type.name == "SYNC"], "psmi": int(psmi),
            "lost_syncs": sum(e.type.name == "LOST_SYNC"
                              for e in run["events"]),
            "hdc_exact": len(clean & sent),
            "hdc_foreign": len(clean - sent),
            "frames_by_channel": {c: sum(f[0] == c for f in run["frames"])
                                  for c in chans},
            "frames_equal_plain": frames_of(run, chans, True)
            == frames_of(plain_run, chans, True),
            "kernels_launched": sorted(run["launches"]),
        }

    def am_ok(g, run):
        return (g["syncs"] == [g["psmi"]] and g["lost_syncs"] == 0
                and g["hdc_exact"] >= SESSION_AM_MIN_HDC
                and g["hdc_foreign"] == 0 and g["frames_equal_plain"]
                and all(g["frames_by_channel"].values())
                and not run["plain_calls"])
    gate = am_gate(am_block, am_plain, am_packets, C.SERVICE_MODE_MA1)
    gate3 = am_gate(am3_block, am3_plain, am3_packets, C.SERVICE_MODE_MA3)
    gate.update({
        "hdc_exact_gate": SESSION_AM_MIN_HDC,
        "rdbi_from_frame": BLOCK_AM_RDBI_FROM,
        "pids_only_calls": len(pids_calls),
        "pids_only_disabled_calls": sum(d for _, d, _ in pids_calls),
        "pids_only_differing": sum(pids_diff),
        "warm_run_same_frames": frames_of(am_warm, (-1, 0, 3), True)
        == frames_of(am_block, (-1, 0, 3), True),
    })
    ok = (am_ok(gate, am_block) and am_ok(gate3, am3_block)
          and gate["pids_only_disabled_calls"] > 0
          and gate["pids_only_differing"] == 0
          and am_block["launches"].get("am_gather_pids") == len(pids_calls)
          and set(am_block["launches"]) == set(BLOCK_AM_KERNELS)
          and set(am3_block["launches"]) == set(BLOCK_AM_KERNELS)
          and gate["warm_run_same_frames"])
    emit({"phase": "receiver_am", "card": smi, "mode": "MA1", **gate,
          "launches": am_block["launches"],
          "plain_calls_on_kernel_path": am_block["plain_calls"],
          "blocks": am_block["blocks"],
          "wall_s": [r["wall_s"] for r in (am_block, am_warm)],
          "wall_ms_per_block": [1e3 * r["wall_s"] / max(r["blocks"], 1)
                                for r in (am_block, am_warm)],
          "plain_wall_ms_per_block": 1e3 * am_plain["wall_s"]
          / max(am_plain["blocks"], 1),
          "ma3": {**gate3, "launches": am3_block["launches"],
                  "plain_calls_on_kernel_path": am3_block["plain_calls"],
                  "blocks": am3_block["blocks"],
                  "wall_ms_per_block": 1e3 * am3_block["wall_s"]
                  / max(am3_block["blocks"], 1)},
          "phase_seconds": time.perf_counter() - t_phase, "pass": ok})
    if not ok:
        raise AssertionError("receiver_am did not pass its gate")
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        by_path["receiver_fm"] = fm_block["launches"].get(name, 0) \
            + fm_turbo["launches"].get(name, 0) + sum(
                r["launches"].get(name, 0) for r in px_runs)
        by_path["receiver_am"] = am_block["launches"].get(name, 0) \
            + am3_block["launches"].get(name, 0)
        report[name]["launches"] = sum(by_path.values())
    report["am_gather"]["launches_pids_only"] = \
        am_block["launches"]["am_gather_pids"] \
        + am3_block["launches"]["am_gather_pids"]

    # --- parallel: the sharded receive, its pipeline and replay, the
    # receiver over a station mesh, a drifting AM station ---
    paths = parallel_phase(torch, smi, fleet["capture"], serve_fm)
    for name in KERNELS:
        by_path = report[name]["launches_by_path"]
        for path, counts in paths.items():
            by_path[path] = counts.get(name, 0)
        report[name]["launches"] = sum(by_path.values())

    print(smi, flush=True)
    emit({"kernels": [dict(report[n]) for n in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
