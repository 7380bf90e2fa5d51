#!/usr/bin/env python3
"""Drive the PyTorch port's FM receive chain on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
``nvcc``.  It imports nothing of JAX or of the JAX package ``nrsc5_tpu``.
Phases, each printing one JSON line:

1. device: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. build: the seven hand kernels (K1, K2, K3, K4, K7, K9 and the needle
   count of K10) built from ``nrsc5_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, all in parallel;
3. signal: 16 stations of MP1, each modulated once with the port's ``tx``
   copy from random bits of a fixed seed: 2 lead blocks (block counts 14
   and 15), then 2 P1 frames.  From that one baseband come two cu8 wires
   at 1.488 MS/s with AWGN at 25 dB: the steady wire (the 2 frames,
   frame-aligned) and the cold-start capture (all 34 blocks behind a
   timing offset of 1000-3999 samples, with an integer CFO of ±1..±12
   bins, both signs present, plus a fractional part within ±60 Hz);
4. one line per kernel: the kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it, with times;
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
   versions, which must decode the same bits.

Then the ``nvidia-smi`` line, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
with no CUDA card it exits 2 before printing anything.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

N_STATIONS = 16
N_FRAMES = 2
LEAD = 2  # lead blocks (bc 14, 15) ahead of the frames in the capture
SNR_DB = 25.0
SEED = 0x5EED
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
}
# the kernels each path launches
STEADY = ("halfband_cu8", "demod_fold", "sync_block", "viterbi_k7")


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


def make_fleet() -> dict:
    """Every station, built in parallel by spawned worker processes (numpy
    only; the pool ends with the call)."""
    workers = min(N_STATIONS, os.cpu_count() or 1)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        stations = list(pool.map(make_station, range(N_STATIONS)))
    return {k: np.stack([st[k] for st in stations]) for k in stations[0]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops import acquire_rc as AQ
    from nrsc5_tpu_torch.ops import convolutional as CV
    from nrsc5_tpu_torch.ops import costas as CO
    from nrsc5_tpu_torch.ops import detect_cfo as DC
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.ops import interleavers as IL
    from nrsc5_tpu_torch.ops import rcplx as rc
    from nrsc5_tpu_torch.ops import sync_fm as SF
    from nrsc5_tpu_torch.ops.bits import unpack_bits
    from nrsc5_tpu_torch.ops.decode_fm import p1_decode, pids_decode
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc

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
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in built["ptxas"].items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": built["built"], "ptxas": regs})

    n_blocks = N_FRAMES * C.P1_FM_BLOCKS
    t0 = time.perf_counter()
    fleet = make_fleet()
    emit({"phase": "signal", "seconds": round(time.perf_counter() - t0, 3),
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
              plain_reps=7, plain_inner=10, ok=None, **extra):
        """Hold a kernel against its plain version and time both (and the
        library call, if any) as CUDA graphs: device time per call.
        ``launched_ms`` also times the kernel launched from Python.  ``ok``
        overrides ``err <= tol`` where a kernel's outputs carry several
        tolerances (``extra`` records them)."""
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
        report[name] = row
        emit({"phase": "kernel", **row, "pass": ok})
        if not ok:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"beyond their tolerances ({row})")

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

    ppb = C.partitions_per_band(1)
    bins = torch.from_numpy(SF._ref_bins(ppb).astype(np.int64)).to(dev)

    # --- K4: the sync block at block 1 of the steady chain: the spectra,
    # Costas state and timing_adj the main path hands it after block 0 ---
    _, _, cy = rcc.frontend_scan_rc(
        samples, rcc.chain_rc_init_carry(n_stations=s_n, device=dev), 1)
    samperr1 = C.FFTCP_FM // 2 + cy.samperr_fb
    spectra1 = rc.dft(AQ.demod_fold(samples, cy.offset, cy.phase, samperr1,
                                    cy.prev_angle - cy.angle_fb,
                                    cy.cfo)[0], shift=True)
    sync_args = (spectra1, cy.costas_phase, cy.costas_freq, 1,
                 C.FFTCP_FM // 2 - samperr1)
    ko, kph, kfr = rcc.sync_block_rc(*sync_args)
    po, pph, pfr = rcc.sync_block_rc_plain(*sync_args)
    exact = all(torch.equal(ko[k], po[k])
                for k in ("ref_ok", "ref_bc", "ref_psmi", "samperr"))
    pm_diff = (ko["pm"].int() - po["pm"].int()).abs()
    pm_max, pm_share = int(pm_diff.max()), float((pm_diff > 0).float().mean())
    floats = [(ko[k], po[k]) for k in ("angle", "error_lb", "error_ub")]
    floats += [(kph, pph), (kfr, pfr)]
    err = max((a - b).abs().max().item() for a, b in floats)
    rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1)).item()
              for a, b in floats)
    r2, n_data = bins.numel(), 2 * ppb * (C.PARTITION_WIDTH_FM - 1)
    check("sync_block", err, "floats 1e-5 of max(|plain|, 1); ref_ok, bc, "
          "psmi, samperr exact; pm within 1 on at most 0.1 % of values",
          lambda: rcc.sync_block_rc(*sync_args),
          lambda: rcc.sync_block_rc_plain(*sync_args),
          bound(s_n * (C.BLKSZ * (r2 + n_data) * 8 + 4 * C.FFT_FM * 4
                       + C.PM_BLOCK_SIZE + r2 * 9 + 16),
                s_n * (r2 * C.BLKSZ * 35 + C.BLKSZ * n_data * 40
                       + C.PM_BLOCK_SIZE * 6)),
          None, [s_n, C.BLKSZ, C.FFT_FM, 2],
          ok=exact and pm_max <= 1 and pm_share <= 1e-3 and rel <= 1e-5,
          ints_exact=exact, float_rel_err=rel, pm_max_diff=pm_max,
          pm_diff_share=pm_share)

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

    # --- K7: Viterbi on the steady chain's own LLRs, P1 segments and
    # PIDS ---
    carries = rcc.chain_rc_init_carry(n_stations=s_n, device=dev)
    pm, _, _ = rcc.frontend_scan_rc(samples, carries, n_blocks)
    flat = pm.reshape(s_n * N_FRAMES, -1)
    llr = flat[:, torch.from_numpy(IL.p1_fm_table()).long().to(dev)].float()
    full = CV.depuncture(llr, C.PUNCTURE_P1_PIDS_FM,
                         C.P1_FRAME_LEN_FM * 3).reshape(
        -1, C.P1_FRAME_LEN_FM, 3)
    seg_idx, _ = CV._plan_tensors(C.P1_FRAME_LEN_FM, str(dev))
    segs = full[:, seg_idx].reshape(-1, seg_idx.shape[1], 3).contiguous()
    llr = pm.reshape(s_n * n_blocks, -1)[
        :, torch.from_numpy(IL.pids_fm_table()).long().to(dev)].float()
    pfull = CV.depuncture(llr, C.PUNCTURE_P1_PIDS_FM,
                          C.PIDS_FRAME_LEN * 3).reshape(
        -1, C.PIDS_FRAME_LEN, 3)
    w = CV.TAIL_BITING_EXTRA
    pext = torch.cat([pfull[:, -w:], pfull, pfull[:, :w]], 1).contiguous()
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
             and cs_same and launched == set(KERNELS))
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
    pm, _, _ = rcc.frontend_scan_rc(x, carries, n_blocks)
    ev[2].record()
    pids_decode(pm.reshape(s_n * n_blocks, -1))
    ev[3].record()
    p1_decode(pm.reshape(s_n * N_FRAMES, -1))
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

    # device busy time of one dispatch: the sum of the kernel, copy and
    # set spans the profiler records on the card (one stream, no overlap)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in spans) / 1e3
    by_name = {}
    for e in spans:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    device_time = {"spans": len(spans), "busy_ms": busy,
                   "wall_ms": prof_wall,
                   "idle_share": 1 - busy / prof_wall if spans else None,
                   "top_ms": [[n[:80], t] for n, t in top]}

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
          "device_time": device_time, "plain_wall_ms": plain_wall,
          "plain_same_bits": same, "pass": slice_ok})
    if not slice_ok:
        raise AssertionError("the slice did not decode bit-exact through "
                             "every kernel")

    print(smi, flush=True)
    emit({"kernels": [dict(report[n]) for n in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
