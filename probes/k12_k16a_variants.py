"""Time the designs tried for K16a (audio's window, overlap-add and QMF
analysis) and for K12 (the AM fold, both passes) against the kernels the
port runs, on one CUDA card, each held against the plain version.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/k12_k16a_variants.py

Every variant is built here, one ``nvcc`` each, all started together, into
``build/probes/`` (gitignored):

* ``aac_window_qmf_analysis_parent.cu``: K16a before its redesign (a CTA a
  (lane, packet), two loads a multiply-add), whole and with
  ``-DEXT_ONLY`` (the ext build alone; the tap loop is the difference);
* ``aac_window_qmf_analysis_variants.cu``: the port's K16a with the
  design it replaced, whose items with a short window went sample by
  sample (``-DK16A_SCALAR_SHORT``), and cut into its parts: the ext build
  alone (``-DK16A_EXT_ONLY``), the tap loop without the build
  (``-DK16A_NO_BUILD``), neither (both flags: the launch, KA's copy and
  the output's write); and each CTA's phases by the global timer
  (``-DK16A_CLOCK``, also with ``-DK16A_SCALAR_SHORT``);
* ``aac_window_qmf_analysis_first.cu``: this redesign's first design
  (ext rows of 33 floats for every 32 samples read a tap at a time, the
  all-long build a sample a thread at a time) with its choices as knobs:
  tiles of 4 slots x 8 columns a half or 8 slots x 4 (``-DK16A_TC=8``,
  ``-DK16A_TS=8``), launch bounds for one CTA an SM (``-DK16A_CTAS=1``),
  KA read through the read-only cache (``-DK16A_KA_GLOBAL``), the two ext
  builds tried before (a branch a sample, ``-DK16A_BUILD_BRANCHED``;
  every load predicated, ``-DK16A_BUILD_PREDICATED``), the ext build
  alone and the tap loop alone;
* ``am_fold_parent.cu``: K12 before its redesign (a CTA a (symbol,
  station), phase0 a thread, the pilot fit on one thread behind two
  barriers, a float32 fold);
* ``am_fold_variants.cu``: the port's K12 with 1 or 4 symbols a CTA
  (``-DK12_SYMS``), without programmatic dependent launch
  (``-DK12_PDL=0``), pass 1's phase0 formed once by warp 0 behind a
  barrier (``-DK12_WARP0=1``, the design tried before the port's), and
  the fold unrounded (``-DK12_ROUND=0``).

Also timed: the parent's two rounding copies of the DFT operand (bf16 and
back) and the float32 DFT GEMM each pass runs, and one AM block's acquire
as the block loop runs it (K5's carry step, K12 pass 1, the GEMM, K12
pass 2, the GEMM), for the parent (with its copies) and the port's
kernels, so that programmatic dependent launch shows in place.

Inputs, from fixed seeds: 128 lanes x 8 packets of random IMDCT products,
one packet in 8 short, random window rows and KA (K16a); 16 stations of
random samples at ``am_buffer_len(2)`` with random carries (K12).  Times:
device ms a call, CUDA events around a CUDA graph of 10 calls, median of 7
(``chip_smoke.time_ms``).  K16a's variants must equal the plain version
bit for bit; K12's pass the fold's bf16 gate (``chip_smoke.
bf16_fold_gate``: each entry the bf16 rounding of a value within 1e-5 of
the plain version's unrounded fold), phase and angle within 1e-5, keep
exact.

Prints the card's name and power limit, one line a variant's build (its
registers and stack frames), and one JSON object: for each variant
``[passes its gate (None where its outputs are cut short), ms]``, the
parent K16a's split and the port's (ext build, tap loop, and the launch
with KA's copy and the output's write), K12's parts, and the block's
acquire with the kernels it runs.
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
K16A_ARGS = (P,) * 13 + (I, I, P)
K12_ARGS = (P, L, P, P, P, P, P, P, P, P, P, P, P, I, P)
K16A_KNOBS = HERE / "aac_window_qmf_analysis_variants.cu"
K16A_FIRST = HERE / "aac_window_qmf_analysis_first.cu"
K12_KNOBS = HERE / "am_fold_variants.cu"
# variant name -> (source, extra nvcc flags, entry point, its argtypes)
VARIANTS = {
    "k16a_parent": (HERE / "aac_window_qmf_analysis_parent.cu", [],
                    "aac_window_qmf_analysis_parent", K16A_ARGS),
    "k16a_parent_ext": (HERE / "aac_window_qmf_analysis_parent.cu",
                        ["-DEXT_ONLY"], "aac_window_qmf_analysis_parent",
                        K16A_ARGS),
    **{f"k16a_{name}": (K16A_KNOBS, flags, "aac_window_qmf_analysis_variant",
                        K16A_ARGS)
       for name, flags in (
           ("knobs_default", []),
           ("scalar_short", ["-DK16A_SCALAR_SHORT"]),
           ("ext_only", ["-DK16A_EXT_ONLY"]),
           ("no_build", ["-DK16A_NO_BUILD"]),
           ("no_build_ext_only", ["-DK16A_NO_BUILD", "-DK16A_EXT_ONLY"]),
           ("clock", ["-DK16A_CLOCK"]),
           ("scalar_short_clock", ["-DK16A_SCALAR_SHORT", "-DK16A_CLOCK"]))},
    **{f"k16a_first{name}": (K16A_FIRST, flags,
                             "aac_window_qmf_analysis_first", K16A_ARGS)
       for name, flags in (
           ("", []),
           ("_build_branched", ["-DK16A_BUILD_BRANCHED"]),
           ("_build_predicated", ["-DK16A_BUILD_PREDICATED"]),
           ("_tc8", ["-DK16A_TC=8"]), ("_ts8", ["-DK16A_TS=8"]),
           ("_ctas1", ["-DK16A_CTAS=1"]),
           ("_ka_global", ["-DK16A_KA_GLOBAL"]),
           ("_ext_only", ["-DK16A_EXT_ONLY"]),
           ("_no_build", ["-DK16A_NO_BUILD"]))},
    "k12_parent": (HERE / "am_fold_parent.cu", [], "am_fold_parent",
                   K12_ARGS),
    **{f"k12_{name}": (K12_KNOBS, flags, "am_fold_variant", K12_ARGS)
       for name, flags in (("knobs_default", []), ("syms1", ["-DK12_SYMS=1"]),
                           ("syms4", ["-DK12_SYMS=4"]),
                           ("pdl0", ["-DK12_PDL=0"]),
                           ("warp0", ["-DK12_WARP0=1"]),
                           ("round0", ["-DK12_ROUND=0"]))},
}
# variants whose outputs are cut short: timed, not held to the plain version
PARTIAL = ("k16a_parent_ext", "k16a_ext_only", "k16a_no_build",
           "k16a_clock", "k16a_scalar_short_clock",
           "k16a_no_build_ext_only", "k16a_first_ext_only",
           "k16a_first_no_build")
# variants that write the float32 fold unrounded, as the parent did
UNROUNDED = ("k12_parent", "k12_round0")


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


def clock_phases(torch, t, n_ctas: int) -> dict:
    """The clock variant's global timer readings (ns, 8 a CTA: entry,
    packets, build, KA's wait, tap loop, exit) as phase lengths in us:
    each phase's median and largest over the CTAs, the spread of the CTAs'
    entries, and the first entry to the last exit."""
    tk = t[:8 * n_ctas].view(n_ctas, 8)[:, :6].double().cpu()
    out = {}
    for p, name in enumerate(("packets", "build", "ka_wait", "tap_loop",
                              "rest")):
        d = (tk[:, p + 1] - tk[:, p]) / 1e3
        out[name] = [float(d.median()), float(d.max())]
    out["entry_spread"] = float((tk[:, 0].max() - tk[:, 0].min()) / 1e3)
    out["first_entry_to_last_exit"] = float(
        (tk[:, 5].max() - tk[:, 0].min()) / 1e3)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import bf16_fold_gate, kernel_spans, time_ms
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.audio import stage as AST
    from nrsc5_tpu_torch.ops import rcplx as rc
    from nrsc5_tpu_torch.pipeline import block_graph as BG
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
    from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    built = build_variants()
    K.build(["aac_window_qmf_analysis", "am_fold", "block_carry_am"])
    for name, (lib, log) in built.items():
        print(name, "built" if lib else "FAILED", log, flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {}

    # --- K16a: 128 lanes x 8 packets, one packet in 8 short ---
    lanes, kp = 128, 8
    rng = np.random.default_rng(16)

    def f32(*shape, lo=-1.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape).astype(
            np.float32)).to(dev)

    def u8(hi):
        return torch.from_numpy(rng.integers(0, hi, (lanes, kp)).astype(
            np.uint8)).to(dev)

    a16 = (f32(lanes, kp, 2048), f32(lanes, kp, 8, 256), u8(13), u8(5),
           torch.from_numpy(rng.random((lanes, kp)) < 0.125).to(dev),
           f32(lanes, 1024), f32(lanes, 288), f32(13, 2048, lo=0.0),
           f32(5, 8, 256, lo=0.0), f32(320, 64))
    want16 = AST.window_qmf_analysis_plain(*a16)
    res["k16a_port"] = [
        all(torch.equal(a, b) for a, b in zip(
            AST.window_qmf_analysis(*a16), want16)),
        time_ms(torch, lambda: AST.window_qmf_analysis(*a16), graph=True)]
    outs = [torch.empty_like(t) for t in want16]
    # new_qa with room for the clock variant's 8 int64 a CTA behind it
    qa_room = torch.empty(lanes * AST.QA_HIST + 16 * 2 * 132 * 4,
                          device=dev)
    for name in (n for n in VARIANTS if n.startswith("k16a_")):
        lib = built[name][0]
        if lib is None:
            continue
        fn = _entry(lib, name)
        clock = name.endswith("_clock")
        qa_ptr = (qa_room if clock else outs[2]).data_ptr()

        def call(fn=fn, qa_ptr=qa_ptr):
            _checked(fn, *(t.data_ptr() for t in a16),
                     outs[0].data_ptr(), outs[1].data_ptr(), qa_ptr, lanes,
                     kp, stream())
        try:
            for t in outs:
                t.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            exact = None if name in PARTIAL else all(
                torch.equal(a, b) for a, b in zip(outs, want16))
            res[name] = [exact, time_ms(torch, call, graph=True)]
            if clock:
                call()
                torch.cuda.synchronize()
                res[name + "_phases_us"] = clock_phases(
                    torch, qa_room[lanes * AST.QA_HIST:].view(torch.int64),
                    -(-lanes * kp // 4))
        except RuntimeError as e:
            res[name] = [False, str(e)]
    parts = ("k16a_ext_only", "k16a_no_build", "k16a_no_build_ext_only")
    if all(n in res for n in parts):
        ext, loop, rest = (res[n][1] for n in parts)
        res["k16a_port_split"] = {"ext_build": ext - rest,
                                  "tap_loop": loop - rest,
                                  "launch_ka_copy_and_write": rest}
    if "k16a_parent" in res and "k16a_parent_ext" in res:
        res["k16a_parent_split"] = {
            "ext_build": res["k16a_parent_ext"][1],
            "tap_loop": res["k16a_parent"][1] - res["k16a_parent_ext"][1]}

    # --- K12: 16 stations of random samples, random carries ---
    s = 16
    g = torch.Generator().manual_seed(12)
    x = (0.05 * torch.randn(s, am_buffer_len(2), 2, generator=g)).to(dev)
    ang = 2 * np.pi * torch.rand(s, generator=g)

    def ints(lo, hi):
        return torch.randint(lo, hi, (s,), generator=g,
                             dtype=torch.int32).to(dev)

    fold_args = (x, ints(0, 300),
                 torch.stack([torch.cos(ang), torch.sin(ang)], -1).to(dev),
                 ints(-3, 4), (0.01 * torch.randn(s, generator=g)).to(dev),
                 ints(-1, 2))
    raw1 = scar.am_fold_plain(*fold_args, unrounded=True)
    spectra1 = rc.dft(raw1, shift=True)
    raw2 = scar.am_fold_plain(*fold_args, spectra1, unrounded=True)
    fshape = (s, C.BLKSZ, C.FFT_AM, 2)
    fold = torch.empty(fshape, device=dev)
    ph, pa = torch.empty(s, 2, device=dev), torch.empty(s, device=dev)
    kp_ = torch.empty(s, dtype=torch.int32, device=dev)
    shape_t = scar._shape(str(dev))

    def gate(got1, got2, unrounded):
        """pass 1 and pass 2 against the plain version's unrounded fold:
        the bf16 gate (or, unrounded, within 1e-5), phase and angle within
        1e-5, keep exact."""
        if unrounded:
            ok = all((a - b).abs().max().item() <= 1e-5
                     for a, b in ((got1, raw1), (got2[0], raw2[0])))
        else:
            ok = (bf16_fold_gate(torch, got1, raw1, 1e-5)[0]
                  and bf16_fold_gate(torch, got2[0], raw2[0], 1e-5)[0])
        return bool(ok and all((a - b).abs().max().item() <= 1e-5
                               for a, b in zip(got2[1:3], raw2[1:3]))
                    and torch.equal(got2[3], raw2[3]))

    port1 = scar.am_fold(*fold_args).clone()
    port2 = [t.clone() for t in scar.am_fold(*fold_args, spectra1)]
    res["k12_port"] = [
        gate(port1, port2, False),
        time_ms(torch, lambda: scar.am_fold(*fold_args, out=fold),
                graph=True),
        time_ms(torch, lambda: scar.am_fold(*fold_args, spectra1,
                                            out=(fold, ph, pa, kp_)),
                graph=True)]
    k12_calls = {}
    for name in (n for n in VARIANTS if n.startswith("k12_")):
        lib = built[name][0]
        if lib is None:
            continue
        fn = _entry(lib, name)

        def call(pilot=None, fn=fn, outs=(fold, ph, pa, kp_)):
            _checked(fn, x.data_ptr(), x.shape[1],
                     *(t.data_ptr() for t in fold_args[1:]),
                     shape_t.data_ptr(),
                     None if pilot is None else pilot.data_ptr(),
                     *(t.data_ptr() for t in outs), s, stream())
        try:
            call()
            torch.cuda.synchronize()
            got1 = fold.clone()
            call(spectra1)
            torch.cuda.synchronize()
            got2 = (fold.clone(), ph.clone(), pa.clone(), kp_.clone())
            res[name] = [gate(got1, got2, name in UNROUNDED),
                         time_ms(torch, call, graph=True),
                         time_ms(torch, lambda: call(spectra1), graph=True)]
            k12_calls[name] = call
        except RuntimeError as e:
            res[name] = [False, str(e)]

    # the parent's rounding copies and the GEMM around each pass
    work = torch.empty(fshape, device=dev)
    spectra = torch.empty(fshape, device=dev)
    rounded = torch.empty(fshape, dtype=torch.bfloat16, device=dev)
    work.copy_(raw1)

    def copies():
        rounded.copy_(work)
        work.copy_(rounded)

    def gemm():
        rc.dft_rounded_into(work, spectra, shift=True)

    res["k12_parts"] = {"rounding_copies": time_ms(torch, copies,
                                                   graph=True),
                        "dft_gemm": time_ms(torch, gemm, graph=True)}

    # one block's acquire as the loop runs it: K5, K12 pass 1, (copies),
    # GEMM, K12 pass 2, (copies), GEMM
    offset = fold_args[1].clone()
    keep = torch.full((s,), 400, dtype=torch.int32, device=dev)
    sp1 = torch.empty(fshape, device=dev)

    def block(call, parent):
        def run():
            BG.block_carry_am(keep, offset)
            call()
            if parent:
                rounded.copy_(fold)
                fold.copy_(rounded)
            rc.dft_rounded_into(fold, sp1, shift=True)
            call(sp1)
            if parent:
                rounded.copy_(fold)
                fold.copy_(rounded)
            rc.dft_rounded_into(fold, spectra, shift=True)
        return run

    def port_call(pilot=None):
        if pilot is None:
            scar.am_fold(x, offset, *fold_args[2:], out=fold)
        else:
            scar.am_fold(x, offset, *fold_args[2:], pilot,
                         out=(fold, ph, pa, kp_))

    blocks = {"port": block(port_call, False)}
    for name in ("k12_parent", "k12_pdl0", "k12_syms1", "k12_syms4"):
        if name in k12_calls:
            fn = _entry(built[name][0], name)

            def call(pilot=None, fn=fn):
                _checked(fn, x.data_ptr(), x.shape[1], offset.data_ptr(),
                         *(t.data_ptr() for t in fold_args[2:]),
                         shape_t.data_ptr(),
                         None if pilot is None else pilot.data_ptr(),
                         fold.data_ptr(), ph.data_ptr(), pa.data_ptr(),
                         kp_.data_ptr(), s, stream())
            blocks[name] = block(call, name == "k12_parent")
    res["k12_block_acquire"] = {name: time_ms(torch, run, graph=True)
                                for name, run in blocks.items()}
    # the kernels one block's acquire runs, by name (the parent's: K5, its
    # two folds and GEMMs, and the four rounding copies)
    res["k12_block_acquire_kernels"] = {
        name: kernel_spans(torch, blocks[name])
        for name in ("port", "k12_parent") if name in blocks}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
