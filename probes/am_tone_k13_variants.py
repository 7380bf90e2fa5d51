"""Time the designs tried for K14's tone estimate (``am_tone``) and for K13
(the AM sync block) against the kernels the port runs, on one CUDA card,
each split into its phases and held against the plain version.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/am_tone_k13_variants.py

Every variant is built here, one ``nvcc`` each, all started together, into
``build/probes/`` (gitignored):

* ``am_tone_parent.cu``: ``am_tone`` before its redesign (one CTA per
  station and 5 grid points, a sincos a grid term, the last CTA of a
  station running the tail), whole and with ``-DPROJ_ONLY`` (the
  projection alone; the tail is the difference);
* ``am_tone_variants.cu``: the port's ``am_tone`` with its design choices
  as compile-time knobs, set otherwise: the projection's stations a CTA, grid points a CTA and warps
  a grid point (``-DAM_TONE_SB/PW/SPLIT``), its z tile shared by a
  cluster of 3 CTAs through multicast copies (``-DAM_TONE_PCL=3``), no
  programmatic dependent launch (``-DAM_TONE_PDL=0``), the tail on 1024
  threads a CTA (``-DAM_TONE_TAIL_T=1024``); and cut into its parts: the
  projection's copies alone and its sums alone (``-DAM_TONE_PROJ_MODE``),
  the tail up to the parabola and each Newton step
  (``-DAM_TONE_TAIL_STOP``), the tail's clock64 ticks at its phase ends
  (``-DAM_TONE_TAIL_CLOCK``);
* ``sync_am_block_parent.cu``: K13 before its redesign (one CTA per
  station over the whole 64 KB block in shared memory), whole and with
  ``-DLOAD_ONLY`` (the load alone; the later phases are the difference);
* ``sync_am_block_variants.cu``: the port's K13 on 256 or 512 threads a
  CTA (``-DK13_THREADS``), and cut after its barrier or after its loads
  (``-DK13_STOP=1`` or ``2``);
* ``sync_am_block_cluster.cu``: the four CTAs a station as a cluster of 4,
  pu's mult angles read by distributed shared memory.

The port's kernels are timed as a whole call and, from the profiler,
kernel by kernel.  Inputs, from a fixed seed: 16 stations' 20000-sample
captures of a carrier in white noise with the window at a random offset
and the power DFT of its symbols (``am_tone``); 16 stations' random
spectra of one block, MA1 and MA3 (K13).  Times: device ms a call, CUDA
events around a CUDA graph of 10 calls, median of 7
(``chip_smoke.time_ms``); the parent ``am_tone``'s call includes zeroing
its counters, as its wrapper did.

Prints the card's name and power limit, one line a variant's build (its
registers and stack frames), and one JSON object: for each variant
``[equal to the plain version (None where its outputs are cut short),
ms]``, the profiler's ms of each kernel of the port's and the knob
variants' calls, the tail's ticks and the parents' phase splits.
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

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
TONE_PARENT_ARGS = (P, P, L, P, P, P, P, P, P, I, P)
TONE_ARGS = (P, P, L, P, P, P, P, P, P, P, P, P, I, P)
K13_PARENT_ARGS = (P, P, P, P, P, I, I, P)
K13_ARGS = (P, P, P, P, P, P, I, I, P)
# variant name -> (source, extra nvcc flags, entry point, its argtypes)
TONE_KNOBS = HERE / "am_tone_variants.cu"
K13_KNOBS = HERE / "sync_am_block_variants.cu"
VARIANTS = {
    "tone_parent": (HERE / "am_tone_parent.cu", [], "am_tone_parent",
                    TONE_PARENT_ARGS),
    "tone_parent_proj": (HERE / "am_tone_parent.cu", ["-DPROJ_ONLY"],
                         "am_tone_parent", TONE_PARENT_ARGS),
    **{f"tone_sb{sb}_pw{pw}_split{sp}": (
        TONE_KNOBS, [f"-DAM_TONE_SB={sb}", f"-DAM_TONE_PW={pw}",
                    f"-DAM_TONE_SPLIT={sp}"], "am_tone", TONE_ARGS)
       for sb, pw, sp in ((16, 8, 1), (16, 8, 2), (8, 8, 1), (4, 8, 1))},
    "tone_pcl3": (TONE_KNOBS, ["-DAM_TONE_PCL=3"], "am_tone", TONE_ARGS),
    "tone_copies": (TONE_KNOBS, ["-DAM_TONE_PROJ_MODE=1"], "am_tone",
                    TONE_ARGS),
    "tone_sums": (TONE_KNOBS, ["-DAM_TONE_PROJ_MODE=2"], "am_tone", TONE_ARGS),
    "tone_pdl0": (TONE_KNOBS, ["-DAM_TONE_PDL=0"], "am_tone", TONE_ARGS),
    "tone_tail1024": (TONE_KNOBS, ["-DAM_TONE_TAIL_T=1024"], "am_tone",
                      TONE_ARGS),
    "tone_tail_clock": (TONE_KNOBS, ["-DAM_TONE_TAIL_CLOCK=1"], "am_tone",
                        TONE_ARGS),
    **{f"tone_tail_stop{n}": (TONE_KNOBS, [f"-DAM_TONE_TAIL_STOP={n}"],
                              "am_tone", TONE_ARGS) for n in (0, 1, 2)},
    "k13_parent": (HERE / "sync_am_block_parent.cu", [],
                   "sync_am_block_parent", K13_PARENT_ARGS),
    "k13_parent_load": (HERE / "sync_am_block_parent.cu", ["-DLOAD_ONLY"],
                        "sync_am_block_parent", K13_PARENT_ARGS),
    **{f"k13_threads{n}": (K13_KNOBS, [f"-DK13_THREADS={n}"],
                           "sync_am_block", K13_ARGS) for n in (256, 512)},
    **{f"k13_stop{n}": (K13_KNOBS, [f"-DK13_STOP={n}"], "sync_am_block",
                        K13_ARGS) for n in (1, 2)},
    "k13_cluster": (HERE / "sync_am_block_cluster.cu", [],
                    "sync_am_block_cluster", K13_ARGS),
}
# variants whose outputs are cut short: timed, not held to the plain version
PARTIAL = ("tone_parent_proj", "tone_tail_stop0", "tone_tail_stop1",
           "tone_tail_stop2", "tone_copies", "tone_sums", "tone_tail_clock",
           "k13_parent_load",
           "k13_stop1", "k13_stop2")


def build_variants() -> dict:
    """Compile every variant, one ``nvcc`` each, all started together.
    Returns ``{name: (library path or None, ptxas lines)}``."""
    from nrsc5_tpu_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags, _, _) in VARIANTS.items():
        lib = OUT / f"{name}.so"
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


def _entry(lib: Path, name: str):
    _, _, symbol, argtypes = VARIANTS[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _checked(fn, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"cudaError {err}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import kernel_spans, time_ms
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.ops import acquire_am_rc as AA
    from nrsc5_tpu_torch.ops import rcplx as rc
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    built = build_variants()
    K.build(["am_tone", "sync_am_block"])
    for name, (lib, log) in built.items():
        print(name, "built" if lib else "FAILED", log, flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {}

    # --- am_tone: 16 stations of a carrier in white noise ---
    s, n = 16, 20000
    rng = np.random.default_rng(12)
    t = np.arange(n)
    f0 = rng.uniform(-100, 100, s) / C.FFT_AM
    z = np.exp(2j * np.pi * (f0[:, None] * t + rng.uniform(0, 1, s)[:, None])) \
        + 0.3 * (rng.standard_normal((s, n)) + 1j * rng.standard_normal((s, n)))
    x = torch.from_numpy(np.stack([z.real, z.imag], -1).astype(np.float32)
                         ).to(dev)
    offset = torch.from_numpy(rng.integers(0, n - AA.WINDOW_AM, s).astype(
        np.int32)).to(dev)
    spectra = rc.dft(AA.tone_symbols(x, offset))
    want = AA.am_tone_plain(spectra, x, offset)

    def same_tone(got):
        return all(bool(torch.equal(a, b)) for a, b in zip(got, want))

    res["tone_port"] = [same_tone(AA.am_tone(spectra, x, offset)),
                        time_ms(torch, lambda: AA.am_tone(spectra, x, offset),
                                graph=True)]
    res["tone_port_kernels"] = kernel_spans(
        torch, lambda: AA.am_tone(spectra, x, offset))["ms"]
    tb = AA._tables(str(dev))
    f_k, amp_k = torch.empty(s, device=dev), torch.empty(s, 2, device=dev)
    for name in (n for n in VARIANTS if n.startswith("tone_")):
        lib = built[name][0]
        if lib is None:
            continue
        fn = _entry(lib, name)
        if name.startswith("tone_parent"):
            proj = torch.empty(s, AA.N_GRID, 2, device=dev)
            done = torch.zeros(s, dtype=torch.int32, device=dev)

            def call(fn=fn, proj=proj, done=done):
                done.zero_()
                _checked(fn, spectra.data_ptr(), x.data_ptr(), n,
                         offset.data_ptr(), tb["u"].data_ptr(),
                         proj.data_ptr(), done.data_ptr(), f_k.data_ptr(),
                         amp_k.data_ptr(), s, stream())
        else:
            z_len = getattr(ctypes.CDLL(str(lib)), "am_tone_z_len")
            z_len.argtypes, z_len.restype = (I,), L
            zs = torch.empty(z_len(s), 2, device=dev)
            part = torch.empty(s, AA.N_GRID, AA.SUM_WIDTH, 2, device=dev)
            k0 = torch.empty(s, dtype=torch.int32, device=dev)

            def call(fn=fn, zs=zs, part=part, k0=k0):
                _checked(fn, spectra.data_ptr(), x.data_ptr(), n,
                         offset.data_ptr(), tb["u"].data_ptr(),
                         tb["derot"].data_ptr(), tb["twiddle"].data_ptr(),
                         zs.data_ptr(), part.data_ptr(), k0.data_ptr(),
                         f_k.data_ptr(), amp_k.data_ptr(), s, stream())
        try:
            f_k.zero_()
            amp_k.zero_()
            call()
            torch.cuda.synchronize()
            exact = None if name in PARTIAL else same_tone((f_k, amp_k))
            if name == "tone_tail_clock":
                # clock64 ticks of the tail's phase ends (CTA 0, station 0)
                res[name + "_ticks"] = part.view(torch.int64).flatten()[
                    :19].tolist()
            res[name] = [exact, time_ms(torch, call, graph=True)]
            if not name.startswith("tone_parent"):
                res[name + "_kernels"] = kernel_spans(torch, call)["ms"]
        except RuntimeError as e:
            res[name] = [False, str(e)]
    if "tone_parent" in res and "tone_parent_proj" in res:
        res["tone_parent_split"] = {
            "projection": res["tone_parent_proj"][1],
            "tail": res["tone_parent"][1] - res["tone_parent_proj"][1]}

    # --- K13: 16 stations' random spectra of one block, MA1 and MA3 ---
    g = torch.Generator().manual_seed(13)
    spec = torch.randn(s, C.BLKSZ, C.FFT_AM, 2, generator=g).to(dev)
    shapes = scar.sync_am_block_shapes(s)
    outs = {k: torch.empty(shape, dtype=dtype, device=dev)
            for k, (shape, dtype) in shapes.items()}
    keys = ("codes", "pids", "ref_bits", "samperr")
    for ma3 in (False, True):
        mode = "ma3" if ma3 else "ma1"
        want13 = scar.sync_am_block_rc_plain(spec, ma3)

        def same13(got, want13=want13):
            return all(bool(torch.equal(got[k], want13[k])) for k in keys)

        res[f"k13_port_{mode}"] = [
            same13(scar.sync_am_block_rc(spec, ma3)),
            time_ms(torch, lambda ma3=ma3: scar.sync_am_block_rc(spec, ma3),
                    graph=True)]
        plan = scar.sync_am_plan(ma3)
        for name in (n for n in VARIANTS if n.startswith("k13_")):
            lib = built[name][0]
            if lib is None:
                continue
            fn = _entry(lib, name)
            head = (spec.data_ptr(),) if name.startswith("k13_parent") \
                else (spec.data_ptr(), plan.ctypes.data)

            def call(fn=fn, head=head, ma3=ma3):
                _checked(fn, *head, *(outs[k].data_ptr() for k in keys), s,
                         int(ma3), stream())
            try:
                for v in outs.values():
                    v.zero_()
                call()
                torch.cuda.synchronize()
                exact = None if name in PARTIAL else same13(outs)
                res[f"{name}_{mode}"] = [exact,
                                         time_ms(torch, call, graph=True)]
            except RuntimeError as e:
                res[f"{name}_{mode}"] = [False, str(e)]
        if f"k13_parent_{mode}" in res and f"k13_parent_load_{mode}" in res:
            whole = res[f"k13_parent_{mode}"][1]
            load = res[f"k13_parent_load_{mode}"][1]
            res[f"k13_parent_split_{mode}"] = {"load": load,
                                               "later_phases": whole - load}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
