"""Time the designs tried for K1's AM cascade (the cu8 ÷32 ingest) and for
K5 (the block loops' carry step) against the kernels the port runs and
their parents, on one CUDA card, each held against the plain version.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/k1am_k5_variants.py            # both parts
    python3 probes/k1am_k5_variants.py --only=k1am  # K1's AM cascade alone
    python3 probes/k1am_k5_variants.py --only=k12k13  # K12 and K13 alone

Every variant is built here, one ``nvcc`` each, all started together, into
``build/probes/`` (gitignored):

* ``am_decimate_cu8_parent.cu``: K1's AM cascade before its redesign (a
  CTA of 256 threads a tile of 128 outputs, the wire copied into shared
  memory a byte a thread, stage 1 converting each of its 34 bytes an
  output on every read, stages 2-5 one output a thread);
* ``am_decimate_cu8_variants.cu``: the port's design with its choices as
  knobs (listed in its header and in ``VARIANTS`` below): the conversion
  through a shared table, stage 1's extra pairs re-converted by every lane
  instead of shuffled, the CTAs an SM, the outputs a thread of stages 2-4.

Each is timed on the cu8 AM wire of ``chip_smoke.py``'s shape (16
stations x 2 frames, u8 [16, 4441394, 2], random bytes: no path of the
kernel depends on the values) and on a session push (one station, 300
outputs), beside the port's wrapper, every one exact against
``ingest_am_cu8_plain``.

For K5, the block loops of this tree as the port runs them (K4 and K13
taking the carry step) and as they ran before (K4 and K13 without it, a K5
launch after each), on ``chip_smoke.py``'s MP1 steady slice (16 stations,
32 blocks) and its first MA1 dispatch (16 stations, 16 blocks), each
captured as one CUDA graph: the replay's device time, its kernel spans
under the profiler, and the two loops' outputs and carries equal.

``--only=k12k13`` times K12 with its pass-1 loads pinned after the wait
(the port) against K12 before (``am_fold_unpinned.cu``), and K13 with the
carry step (with and without a carry) against K13 before it took the
step (``sync_am_block_unfused.cu``), each alone at the MA1 dispatch's
shapes, and the AM loop of 16 blocks as one graph with each pair, twice
each in turn.

Prints the card's name and power limit, one line a variant's build
(registers, stack frames), one line a timing and a last summary line.
Times: CUDA events around a CUDA graph of 10 calls, median of 7
(``chip_smoke.time_ms``); the loops' graphs one replay a timing.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
OUT = ROOT / "build" / "probes"
sys.path.insert(0, str(ROOT))

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
K1_ARGS = (P, P, P, F, L, I, I, P)
PARENT = HERE / "am_decimate_cu8_parent.cu"
DESIGNS = HERE / "am_decimate_cu8_variants.cu"
FUSED12 = HERE / "am_decimate_cu8_fused12.cu"
# variant name -> (source, extra nvcc flags)
VARIANTS = {
    "parent": (PARENT, []),
    "port_copy": (DESIGNS, []),
    "table": (DESIGNS, ["-DV_TABLE=1"]),
    "reconvert": (DESIGNS, ["-DV_RECONVERT=1"]),
    "minb1": (DESIGNS, ["-DV_MINB=1"]),
    "minb3": (DESIGNS, ["-DV_MINB=3"]),
    "r_small": (DESIGNS, ["-DV_R2=5", "-DV_R3=3", "-DV_R4=1"]),
    "r_large": (DESIGNS, ["-DV_R2=17", "-DV_R3=9", "-DV_R4=5"]),
    "t512": (DESIGNS, ["-DV_TILE=512"]),
    "t512_minb1": (DESIGNS, ["-DV_TILE=512", "-DV_MINB=1"]),
    "clock": (DESIGNS, ["-DV_CLOCK=1"]),
    "pipe": (DESIGNS, ["-DV_PIPE=1"]),
    "pipe_minb3": (DESIGNS, ["-DV_PIPE=1", "-DV_MINB=3"]),
    "pipe_reconvert": (DESIGNS, ["-DV_PIPE=1", "-DV_RECONVERT=1"]),
    "minb4": (DESIGNS, ["-DV_MINB=4"]),
    "minb4_reconvert": (DESIGNS, ["-DV_MINB=4", "-DV_RECONVERT=1"]),
    "minb4_r_small": (DESIGNS, ["-DV_MINB=4", "-DV_R2=5", "-DV_R3=3",
                                "-DV_R4=1"]),
    "minb4_table": (DESIGNS, ["-DV_MINB=4", "-DV_TABLE=1"]),
    "fused12": (FUSED12, []),
    "fused12_minb3": (FUSED12, ["-DV_MINB=3"]),
    "fused12_minb4": (FUSED12, ["-DV_MINB=4"]),
}
# the clock variant's stamps: entry, then the end of each phase, then exit
PHASES = ("load", "stage1", "stage2", "stage3", "stage4", "stage5")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_variants() -> dict:
    """Compile every variant, one ``nvcc`` each, all started together.
    Returns ``{name: (library path or None, ptxas lines)}``."""
    from nrsc5_tpu_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in VARIANTS.items():
        lib = OUT / f"k1am_{name}.so"
        cmd = [K._nvcc(), *K.NVCC_FLAGS, *flags, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        keep = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "stack frame" in ln
                or "error" in ln]
        built[name] = (lib if proc.returncode == 0 else None, keep)
    return built


def unfused_fm(samples, carry, n_blocks, psmi=1):
    """The FM block loop as it ran before K4 took the carry step: the
    port's ``scan_blocks`` with K4 launched without it and K5 after each
    block."""
    import torch
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.ops import rcplx as rc
    from nrsc5_tpu_torch.ops.acquire_rc import demod_fold_bf16
    from nrsc5_tpu_torch.pipeline import block_graph as BG
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc

    s, dev = samples.shape[0], samples.device
    shapes = rcc.sync_block_shapes(s, psmi)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    pm = empty((n_blocks,) + shapes["pm"][0], torch.int8)
    diag = {k: empty((n_blocks, s), shapes[k][1])
            for k in ("samperr", "error_lb", "error_ub")}
    ref = {k: empty(*shapes[k]) for k in ("ref_ok", "ref_bc", "ref_psmi")}
    k4_angle = empty((s,))
    state = {k: getattr(carry, k).clone()
             for k in ("offset", "prev_angle", "samperr_fb", "angle_fb")}
    state.update(samperr=empty((s,), torch.int32), angle=empty((s,)),
                 timing_adj=empty((s,), torch.int32))
    phase = (carry.phase.clone(), empty((s, 2)))
    cph = (carry.costas_phase.clone(), empty((s, C.FFT_FM)))
    cfr = (carry.costas_freq.clone(), empty((s, C.FFT_FM)))
    folded = empty((s, C.BLKSZ, C.FFT_FM, 2), torch.bfloat16)
    spectra = empty((s, C.BLKSZ, C.FFT_FM, 2))
    keep = empty((s,), torch.int32)
    BG.block_carry(None, None, None, state, True)
    for b in range(n_blocks):
        i, j = b % 2, (b + 1) % 2
        demod_fold_bf16(samples, state["offset"], phase[i], state["samperr"],
                        state["angle"], carry.cfo,
                        out=(folded, phase[j], keep))
        rc.dft_bf16(folded, out=spectra)
        out = {"pm": pm[b], "angle": k4_angle, **ref,
               **{k: v[b] for k, v in diag.items()}}
        rcc.sync_block_rc(spectra, cph[i], cfr[i], psmi, state["timing_adj"],
                          out=(out, cph[j], cfr[j]))
        BG.block_carry(keep, diag["samperr"][b], k4_angle, state, False)
    last = n_blocks % 2
    return {"pm": pm, "diag": diag, "carry": {
        "offset": state["offset"], "phase": phase[last],
        "prev_angle": state["prev_angle"], "costas_phase": cph[last],
        "costas_freq": cfr[last], "samperr_fb": state["samperr_fb"],
        "angle_fb": state["angle_fb"]}}


def unfused_am(samples, carry, n_blocks, ma3=False):
    """The AM block loop as it ran before K13 took the carry step: K13
    without it and K5 after each block."""
    import torch
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.pipeline import block_graph as BG
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar

    s, dev = samples.shape[0], samples.device
    shapes = scar.sync_am_block_shapes(s)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    codes = empty((n_blocks,) + shapes["codes"][0], torch.uint8)
    pids = empty((n_blocks,) + shapes["pids"][0], torch.uint8)
    ref_bits = empty(*shapes["ref_bits"])
    offset = carry.offset.clone()
    samperr_fb = carry.samperr_fb.clone()
    phase = (carry.phase.clone(), empty((s, 2)))
    prev_angle = (carry.prev_angle.clone(), empty((s,)))
    fshape = (s, C.BLKSZ, C.FFT_AM, 2)
    spectra = empty(fshape)
    scratch = (empty(fshape), empty(fshape))
    keep = empty((s,), torch.int32)
    for b in range(n_blocks):
        i, j = b % 2, (b + 1) % 2
        scar.acquire_am_fine_rc(samples, offset, phase[i], samperr_fb,
                                prev_angle[i], carry.cfo, False,
                                (spectra, phase[j], prev_angle[j], keep),
                                scratch)
        scar.sync_am_block_rc(spectra, ma3, out={
            "codes": codes[b], "pids": pids[b], "ref_bits": ref_bits,
            "samperr": samperr_fb})
        BG.block_carry_am(keep, offset)
    last = n_blocks % 2
    return {"codes": codes, "pids": pids, "carry": {
        "offset": offset, "phase": phase[last],
        "prev_angle": prev_angle[last], "samperr_fb": samperr_fb}}


def clock_phases(torch, lib, call, s_n: int, n_out: int) -> dict:
    """One launch of the clock variant: each phase's median and 90th
    percentile length over the CTAs (us), a CTA's life, the span from the
    first entry to the last exit, and the CTAs resident on an SM at once
    (the median over SMs of the most whose lives overlap)."""
    n = s_n * -(-n_out // 256)
    call()
    torch.cuda.synchronize()
    buf = torch.zeros(n * 8, dtype=torch.int64)
    fn = getattr(ctypes.CDLL(str(lib)), "k1am_clock_read")
    fn.argtypes, fn.restype = (P, I), ctypes.c_int
    if fn(buf.data_ptr(), n):
        raise RuntimeError("k1am_clock_read failed")
    t = buf.view(n, 8).double()
    out = {}
    for i, name in enumerate(PHASES):
        d = (t[:, i + 1] - t[:, i]) / 1e3
        out[name] = [float(d.median()), float(d.quantile(0.9))]
    life = (t[:, 6] - t[:, 0]) / 1e3
    out["cta_life"] = [float(life.median()), float(life.quantile(0.9))]
    out["first_entry_to_last_exit"] = float((t[:, 6].max()
                                             - t[:, 0].min()) / 1e3)
    resident = []
    for sm in t[:, 7].unique():
        rows = t[t[:, 7] == sm]
        ev = sorted([(float(a), 1) for a in rows[:, 0]]
                    + [(float(b), -1) for b in rows[:, 6]])
        cur = top = 0
        for _, d in ev:
            cur += d
            top = max(top, cur)
        resident.append(top)
    out["resident_ctas_an_sm"] = float(np.median(resident))
    return out


def swapped(K, name: str, fn):
    """Context: kernel ``name``'s entry point replaced by ``fn`` (the
    wrapper then launches it), restored after."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = K._FUNCS.get(name)
        K._FUNCS[name] = fn
        try:
            yield
        finally:
            if saved is None:
                K._FUNCS.pop(name, None)
            else:
                K._FUNCS[name] = saved
    return ctx()


def k12_k13(torch, CS, smi: str, results: dict) -> None:
    """K12 with pass 1's loads pinned after the wait (the port) against
    the plain loads it had before (``am_fold_unpinned.cu``), and K13 with
    the carry step (the port, with and without a carry) against K13 before
    it took the step (``sync_am_block_unfused.cu``), each alone at the MA1
    dispatch's shapes (block 1 of the first dispatch), and the AM block
    loop of 16 blocks as a CUDA graph with each pair: the port's (fused),
    and the one before (unpinned K12, unfused K13, K5 after each block)."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops import rcplx as rc
    from nrsc5_tpu_torch.pipeline import block_graph as BG
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len

    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, src in (("fold_unpinned", HERE / "am_fold_unpinned.cu"),
                      ("k13_unfused", HERE / "sync_am_block_unfused.cu")):
        lib = OUT / f"{name}.so"
        subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", str(lib), str(src)],
                       check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(lib))
    K.build(["am_fold", "sync_am_block", "block_carry"])
    fold_old = libs["fold_unpinned"].am_fold
    fold_old.argtypes, fold_old.restype = K.SIGNATURES["am_fold"], I
    k13_old = libs["k13_unfused"].sync_am_block
    k13_old.argtypes = (P, P, P, P, P, P, I, I, P)
    k13_old.restype = I

    def k13_shim(*a):
        # the port's wrapper passes keep, offset and window before the
        # stream; the kernel before the fusion takes none of them
        return k13_old(*a[:8], a[-1])

    am = CS.make_fleet(CS.make_am_station)
    n_am = am_buffer_len(CS.AM_FRAMES)
    x = serve.ingest(torch.from_numpy(am["queue"][:, :n_am]).to(dev), "am")
    s_n = x.shape[0]
    _, _, cy = scar.am_frontend_scan_rc(x, scar.am_chain_rc_init_carry(
        n_stations=s_n, device=dev), 1)
    args = (x, cy.offset, cy.phase, cy.samperr_fb, cy.prev_angle, cy.cfo)
    spectra1 = rc.dft(scar.am_fold(*args), shift=True)
    spectra = scar.acquire_am_fine_rc(*args)[0].contiguous()
    keep = scar.am_fold(*args, spectra1)[3]
    offset = cy.offset.clone()
    cases = {
        "k12_pass1": lambda: scar.am_fold(*args),
        "k12_pass2": lambda: scar.am_fold(*args, spectra1),
        "k13": lambda: scar.sync_am_block_rc(spectra, False),
        "k13_carry": lambda: scar.sync_am_block_rc(spectra, False,
                                                   (keep, offset)),
    }
    for name, fn in cases.items():
        ms = CS.time_ms(torch, fn, graph=True)
        results[("port", name)] = ms
        emit({"k12k13": name, "kernel": "port", "ms": ms, "card": smi})
    with swapped(K, "am_fold", fold_old):
        for name in ("k12_pass1", "k12_pass2"):
            cases[name]()
            ms = CS.time_ms(torch, cases[name], graph=True)
            results[("before", name)] = ms
            emit({"k12k13": name, "kernel": "before", "ms": ms,
                  "card": smi})
    with swapped(K, "sync_am_block", k13_shim):
        ms = CS.time_ms(torch, cases["k13"], graph=True)
        results[("before", "k13")] = ms
        emit({"k12k13": "k13", "kernel": "before", "ms": ms, "card": smi})

    # the AM block loop, 16 blocks, as one graph: the port's, and the one
    # before the fusion (its K12, its K13, K5 after each block)
    fields = serve._AM_LOOP
    carry = scar.am_chain_rc_init_carry(n_stations=s_n, device=dev)
    inputs = {"x": x, **{k: getattr(carry, k) for k in fields}}
    blocks = CS.AM_FRAMES * C.P1_AM_BLOCKS
    outs = {}
    for name in ("loop_port", "loop_before", "loop_port", "loop_before"):
        if name == "loop_port":
            loop = BG.CapturedLoop(lambda x, **f: scar.scan_blocks_am(
                x, scar.AMChainCarryRC(**f, dec=None), blocks), inputs, dev)
        else:
            with swapped(K, "am_fold", fold_old), \
                    swapped(K, "sync_am_block", k13_shim):
                loop = BG.CapturedLoop(lambda x, **f: unfused_am(
                    x, scar.AMChainCarryRC(**f, dec=None), blocks), inputs,
                    dev)
        got = loop(**inputs)
        torch.cuda.synchronize()
        outs[name] = {"codes": got["codes"].clone(),
                      "pids": got["pids"].clone(),
                      "carry": {k: v.clone() for k, v in
                                got["carry"].items()}}
        ms = CS.time_ms(torch, loop.graph.replay, reps=7, inner=1)
        spans = CS.kernel_spans(torch, loop.graph.replay, calls=3)
        busy = sum(spans["ms"].values())
        results.setdefault(("loop", name), [])
        results[("loop", name)].append(ms)
        emit({"k12k13": name, "ms": ms, "kernel_busy_ms": busy,
              "kernels_a_replay": spans["kernels_a_call"],
              "kernel_ms": spans["ms"], "launches": loop.launches,
              "card": smi})
    emit({"k12k13": "loops_same",
          "port_equals_before": same(outs["loop_port"],
                                     outs["loop_before"])})


def same(a, b) -> bool:
    """Two loops' results (nested dicts of tensors) bit-identical."""
    import torch
    if isinstance(a, dict):
        return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch import serve
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.pipeline import block_graph as BG
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    built = build_variants()
    K.build(["am_decimate_cu8", "halfband_cu8", "demod_fold", "dft_bf16",
             "sync_block", "block_carry", "am_fold", "sync_am_block"])
    for name, (lib, lines) in built.items():
        emit({"build": name, "ok": lib is not None, "ptxas": lines})

    # --- K1's AM cascade ---
    g = torch.Generator(device=dev).manual_seed(CS.SEED)
    head = FE.rc_overlap(FE.AM_STAGES)
    n_dispatch = am_buffer_len(CS.AM_FRAMES)
    shapes = {"dispatch_16x2frames": (16, n_dispatch),
              "session_1x300": (1, 300)}
    taps = FE._k1_taps(str(dev))
    results = {}
    for shape_name, (s_n, n_out) in shapes.items():
        wire = torch.randint(0, 256, (s_n, head + 32 * n_out, 2),
                             generator=g, device=dev, dtype=torch.uint8)
        want = FE.ingest_am_cu8_plain(wire)
        port_ms = CS.time_ms(torch, lambda: FE.ingest_am_cu8(wire),
                             graph=True)
        emit({"k1am": "port_wrapper", "shape": shape_name,
              "exact": torch.equal(FE.ingest_am_cu8(wire), want),
              "ms": port_ms, "card": smi})
        results[(shape_name, "port_wrapper")] = port_ms
        out = torch.empty_like(want)
        for name, (lib, _) in built.items():
            if lib is None:
                continue
            fn = getattr(ctypes.CDLL(str(lib)), "am_decimate_cu8")
            fn.argtypes, fn.restype = K1_ARGS, ctypes.c_int

            def call(fn=fn):
                err = fn(wire.data_ptr(), out.data_ptr(), taps.data_ptr(),
                         FE.CU8_SCALE, wire.shape[1], n_out, s_n,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            out.zero_()
            call()
            torch.cuda.synchronize()
            exact = torch.equal(out, want)
            ms = CS.time_ms(torch, call, graph=True)
            results[(shape_name, name)] = ms
            line = {"k1am": name, "shape": shape_name, "exact": exact,
                    "ms": ms, "card": smi}
            if name == "clock":
                line["clock"] = clock_phases(torch, lib, call, s_n, n_out)
            emit(line)
        del wire, want, out

    if "--only=k1am" in sys.argv:
        emit({"summary": {f"{a}/{b}": v for (a, b), v in results.items()},
              "card": smi})
        return 0
    if "--only=k12k13" in sys.argv:
        k12_k13(torch, CS, smi, results)
        emit({"summary": {f"{a}/{b}": v for (a, b), v in results.items()},
              "card": smi})
        return 0

    # --- K5: the loops with the step fused, and as before ---
    fleet = CS.make_fleet()
    am = CS.make_fleet(CS.make_am_station)
    samples = FE.ingest_fm_cu8(torch.from_numpy(fleet["steady"]).to(dev))
    s_n = samples.shape[0]
    n_blocks = CS.N_FRAMES * C.P1_FM_BLOCKS
    fm_carry = rcc.chain_rc_init_carry(n_stations=s_n, device=dev)
    am_x = serve.ingest(torch.from_numpy(
        am["queue"][:, :n_dispatch]).to(dev), "am")
    am_carry = scar.am_chain_rc_init_carry(n_stations=s_n, device=dev)
    am_blocks = CS.AM_FRAMES * C.P1_AM_BLOCKS
    loops = {
        "fm_fused": (lambda x, **f: rcc.scan_blocks(
            x, rcc.ChainCarryRC(**f, px1_internal=None, px1_phase=None,
                                px2_internal=None, px2_phase=None),
            n_blocks), samples, fm_carry, serve._FM_LOOP),
        "fm_unfused": (lambda x, **f: unfused_fm(
            x, rcc.ChainCarryRC(**f, px1_internal=None, px1_phase=None,
                                px2_internal=None, px2_phase=None),
            n_blocks), samples, fm_carry, serve._FM_LOOP),
        "am_fused": (lambda x, **f: scar.scan_blocks_am(
            x, scar.AMChainCarryRC(**f, dec=None), am_blocks), am_x,
            am_carry, serve._AM_LOOP),
        "am_unfused": (lambda x, **f: unfused_am(
            x, scar.AMChainCarryRC(**f, dec=None), am_blocks), am_x,
            am_carry, serve._AM_LOOP),
    }
    outs = {}
    for name, (fn, x, carry, fields) in loops.items():
        inputs = {"x": x, **{k: getattr(carry, k) for k in fields}}
        loop = BG.CapturedLoop(fn, inputs, dev)
        got = loop(**inputs)
        torch.cuda.synchronize()
        outs[name] = {k: v for k, v in got.items() if k != "px"}
        outs[name] = {k: (v.clone() if isinstance(v, torch.Tensor) else
                          {kk: vv.clone() for kk, vv in v.items()})
                      for k, v in outs[name].items()}
        ms = CS.time_ms(torch, loop.graph.replay, reps=7, inner=1)
        spans = CS.kernel_spans(torch, loop.graph.replay, calls=3)
        results[("loop", name)] = ms
        emit({"loop": name, "ms": ms, "launches": loop.launches,
              "kernels_a_replay": spans["kernels_a_call"],
              "kernel_ms": spans["ms"], "card": smi})
    for kind in ("fm", "am"):
        emit({"loop_same": kind, "fused_equals_unfused":
              same(outs[f"{kind}_fused"], outs[f"{kind}_unfused"])})
    emit({"summary": {f"{a}/{b}": v for (a, b), v in results.items()},
          "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
