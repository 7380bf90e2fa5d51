#!/usr/bin/env python3
"""Drive the PyTorch port's FM receive chain on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
``nvcc``.  It imports nothing of JAX or of the JAX package ``nrsc5_tpu``.
Phases, each printing one JSON line:

1. device: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. build: the four hand kernels (K1, K2, K3, K7) built from
   ``nrsc5_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a``;
3. signal: 16 stations x 2 P1 frames of MP1 (32 L1 blocks each), random
   P1/PIDS bits from a fixed seed, modulated with the port's ``tx`` copy,
   AWGN at 25 dB, upsampled to the 1.488 MS/s cu8 wire;
4. one line per kernel: the kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it, with times;
5. slice: ``serve.chain_step`` on the wire — launch counts taken from that
   one dispatch, every P1 frame and PIDS word held bit-exact against the
   transmitted bits, wall time per dispatch and real-time factor, a stage
   breakdown, one block's pieces timed alone, the device's busy time from
   the profiler, and the same dispatch through the plain versions, which
   must decode the same bits.

Then the ``nvidia-smi`` line, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
with no CUDA card it exits 2 before printing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_STATIONS = 16
N_FRAMES = 2
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
}


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


def make_wire(n_stations: int, n_frames: int, rng):
    """cu8 wire [S, wire_pairs(n_blocks), 2] of frame-aligned MP1 streams
    and the transmitted bits: p1 [S, F, 146176], pids [S, 16F, 80]."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len
    from nrsc5_tpu_torch.tx import channel as ch
    from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
    from nrsc5_tpu_torch.tx.modulator import modulate_fm

    n_blocks = n_frames * C.P1_FM_BLOCKS
    pairs = serve.wire_pairs(n_blocks)
    p1 = rng.integers(0, 2, (n_stations, n_frames, C.P1_FRAME_LEN_FM),
                      dtype=np.uint8)
    pids = rng.integers(0, 2, (n_stations, n_blocks, C.PIDS_FRAME_LEN),
                        dtype=np.uint8)
    bc_seq = np.tile(np.arange(C.P1_FM_BLOCKS), n_frames)
    wire = np.empty((n_stations, pairs, 2), np.uint8)
    for s in range(n_stations):
        matrix = np.concatenate([
            build_pm_matrix(p1[s, f], pids[s, 16 * f:16 * (f + 1)])
            for f in range(n_frames)])
        sig = ch.impair(modulate_fm(matrix, bc_seq, 1), snr_db=SNR_DB,
                        rng=rng)
        # the stream starts FFTCP//2 samples before the first symbol, and
        # runs a few samples past what the dispatch reads
        buf = np.zeros(buffer_len(n_blocks) + 8, np.complex64)
        buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
        queue = serve.stream_wire(ch.to_cu8(ch.upsample2(buf)))
        wire[s] = queue[:pairs]
    return wire, p1, pids


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
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.ops import interleavers as IL
    from nrsc5_tpu_torch.ops import rcplx as rc
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
    wire_np, p1_tx, pids_tx = make_wire(N_STATIONS, N_FRAMES,
                                        np.random.default_rng(SEED))
    emit({"phase": "signal", "seconds": round(time.perf_counter() - t0, 3),
          "stations": N_STATIONS, "blocks": n_blocks,
          "wire_bytes": int(wire_np.nbytes)})
    wire = torch.from_numpy(wire_np).to(dev)
    s_n, n_in, _ = wire.shape
    report = {}

    def check(name, err, tol, kernel, plain, bnd, library, shape,
              plain_reps=7, plain_inner=10):
        """Hold a kernel against its plain version and time both (and the
        library call, if any) as CUDA graphs: device time per call.
        ``launched_ms`` also times the kernel launched from Python."""
        ok = err <= tol
        row = {"name": name, "route": "cuda", "source": KERNELS[name][0],
               "replaces": KERNELS[name][1], "launches": None,
               "max_abs_err": err, "tolerance": tol,
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
                                 f"by {err} > {tol}")

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

    # --- K3: Costas PLL on the reference subcarriers of real spectra ---
    spectra = rc.dft(got[0], shift=True)
    bins = torch.from_numpy(
        rcc.SF._ref_bins(C.partitions_per_band(1)).astype(np.int64)).to(dev)
    refs = spectra[:, :, bins].transpose(0, 1).reshape(
        C.BLKSZ, -1, 2).contiguous()
    n_tr = refs.shape[1]
    ph0 = ((torch.rand(n_tr, generator=g) - 0.5) * 0.2).to(dev)
    fr0 = ((torch.rand(n_tr, generator=g) - 0.5) * 0.01).to(dev)
    got = rcc.costas_track_rc(refs, ph0, fr0)
    want = rcc.costas_track_rc_plain(refs, ph0, fr0)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check("costas_track", err, 1e-4,
          lambda: rcc.costas_track_rc(refs, ph0, fr0),
          lambda: rcc.costas_track_rc_plain(refs, ph0, fr0),
          bound(n_tr * (C.BLKSZ * 8 * 2 + C.BLKSZ * 4 + 16),
                n_tr * C.BLKSZ * 35),
          None, [C.BLKSZ, n_tr, 2])

    # --- K7: Viterbi on the chain's own LLRs, P1 segments and PIDS ---
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

    # --- the slice: one dispatch through the kernels, counted ---
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
        report[name]["launches"] = counts[name]

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
    # and the sync block (K3 and the plain PyTorch equalize/demap)
    samperr0 = C.FFTCP_FM // 2 + carries.samperr_fb
    fold_args = (x, carries.offset, carries.phase, samperr0,
                 carries.prev_angle - carries.angle_fb, carries.cfo)
    folded = AQ.demod_fold(*fold_args)[0]
    spec = rc.dft(folded, shift=True)
    adj = C.FFTCP_FM // 2 - samperr0
    per_block = {
        "demod_fold_ms": time_ms(torch, lambda: AQ.demod_fold(*fold_args)),
        "dft_ms": time_ms(torch, lambda: rc.dft(folded, shift=True)),
        "sync_block_ms": time_ms(torch, lambda: rcc.sync_block_rc(
            spec, carries.costas_phase, carries.costas_freq, 1, adj))}

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
                and same and all(counts[n] > 0 for n in KERNELS))
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
    emit({"kernels": [{k: v for k, v in report[n].items()}
                      for n in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
