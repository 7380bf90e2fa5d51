"""Time the designs tried for K14's am_coarse (the AM cold start's
tone-subtracted CP timing) and am_cfo_step (its integer-CFO step) against
the kernels the port runs, on one CUDA card, each held against the plain
version, and one probe block of the AM cold start as its graph replays.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/k14_coarse_cfo_variants.py

Every variant is built here, one ``nvcc`` each, all started together, into
``build/probes/`` (gitignored):

* ``am_coldstart_parent.cu``: both kernels before their redesign
  (am_coarse one CTA of 512 threads a station over the whole window in
  shared memory, a cosf and a sinf a sample; am_cfo_step a thread a bin
  summing one strided load after another), whole; am_coarse cut after
  its tone-subtract loop, its lane sums and its window with the argmax
  (``-DCOARSE_STOP=1/2/3``; the scalar tail is the whole less the third
  cut) and with a global-timer clock a CTA (``-DCOARSE_CLOCK``);
  am_cfo_step with its loop unrolled (``-DCFO_UNROLL``);
* ``am_coarse_cfo_variants.cu`` (which includes the port's source): the
  port's am_coarse with each of its choices undone in turn (its header
  lists the ``-DV_*`` knobs: cluster of 4 or 16, one CTA of 1024 threads,
  thread counts, no programmatic dependent launch, f and amp by plain
  loads, cosf and sinf, the sums by a cluster barrier, the products
  behind a barrier of their own, two other argmaxes, the rotation on
  thread 0, the late cluster wait, the tone loop not unrolled, bulk
  copies of the runs, an early trigger for its dependents), this
  redesign's first and second kernels, phase cuts and two clocks (global
  timer; SM cycles at finer points); am_coarse fused into am_tone's tail
  cluster (``am_tone_coarse_fused``, one launch fewer a probe block) and
  that tail alone without its early trigger (``am_tone_variant``);
  am_cfo_step with one or two threads a bin, its first design, bulk
  copies of the aligned band, a cluster of 2 or 4 CTAs, no programmatic
  dependent launch, the block argmax and an early trigger (``-DVC_*``).

Inputs, from fixed seeds: 16 stations of a carrier in white noise, 40000
samples each, probe windows at offsets that include an odd one, a
negative one and one clamped at the end; the tone from the port's
am_tone; prev_angle zero and nonzero; the override -1, in range and past
270; random pass-1 spectra for am_cfo_step.  Times: device ms a call,
CUDA events around a CUDA graph of 10 calls, median of 7
(``chip_smoke.time_ms``).  Every whole variant must equal the plain
version bit for bit (``torch.equal`` on every output).

One probe block (``scan_chain_am_rc._probe_body``, the body the cold
start's graph replays: the power DFT, am_tone, am_coarse, K12, DFT, K12,
DFT, am_cfo_step, K13 and the packing) is run with the port's kernels,
with the parent's two kernels in their place, and with some variants in
place of the port's (see ``plans``): each first eagerly against the plain
path's outputs and as one graph replay against the eager run, then as a
graph of 10 blocks replayed in turns with the other plans' (device ms a
block, median of 7 rounds); last, the profiler lists the kernels of the
port's and the parent's blocks (a profiler session slows what follows
it, so nothing is timed after it).

Prints the card's name and power limit, one line a variant's build (its
registers and stack frames), and one JSON object.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
OUT = ROOT / "build" / "probes"
sys.path.insert(0, str(ROOT))

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# am_coarse's arguments with a clock pointer before n_stations
COARSE_ARGS = (P, L, P, P, P, P, P, P, P, P, P, P, P, I, P)
CFO_ARGS = (P, P, P, I, P)
FUSED_ARGS = (P, P, L) + (P,) * 16 + (I, P)
PARENT = HERE / "am_coldstart_parent.cu"
KNOBS = HERE / "am_coarse_cfo_variants.cu"
# variant name -> (source, extra nvcc flags, entry point, its argtypes)
VARIANTS = {
    **{f"coarse_parent{name}": (PARENT, flags, "am_coarse_parent",
                                COARSE_ARGS)
       for name, flags in (("", []), ("_stop1", ["-DCOARSE_STOP=1"]),
                           ("_stop2", ["-DCOARSE_STOP=2"]),
                           ("_stop3", ["-DCOARSE_STOP=3"]),
                           ("_clock", ["-DCOARSE_CLOCK"]))},
    "cfo_parent": (PARENT, [], "am_cfo_step_parent", CFO_ARGS),
    "cfo_parent_unroll": (PARENT, ["-DCFO_UNROLL"], "am_cfo_step_parent",
                          CFO_ARGS),
    **{f"coarse_{name}": (KNOBS, flags, "am_coarse_variant", COARSE_ARGS)
       for name, flags in (
           ("knobs_default", []),
           ("ctas4", ["-DV_CTAS=4"]), ("ctas16", ["-DV_CTAS=16"]),
           ("ctas1_t1024", ["-DV_CTAS=1", "-DV_T=1024"]),
           ("t256", ["-DV_T=256"]), ("t384", ["-DV_T=384"]),
           ("t512", ["-DV_T=512"]),
           ("pdl0", ["-DV_PDL=0"]), ("plain_loads", ["-DV_PLAIN_LOADS"]),
           ("cosf_sinf", ["-DV_TRIG=1"]), ("fast_trig", ["-DV_TRIG=2"]),
           ("fast_trig_clock64", ["-DV_TRIG=2", "-DV_CLOCK64"]),
           ("sync_send", ["-DV_SYNC_SEND=1"]),
           ("separate_products", ["-DV_SEPARATE_PRODUCTS=1"]),
           ("argmax_shuffle", ["-DV_ARGMAX=1"]),
           ("argmax_block", ["-DV_ARGMAX=2"]),
           ("rot_thread0", ["-DV_ROT=1"]), ("late_wait", ["-DV_LATE_WAIT=1"]),
           ("tone_loop", ["-DV_TONE_UNROLL=1"]),
           ("tone_loop_cosf_sinf", ["-DV_TONE_UNROLL=1", "-DV_TRIG=1"]),
           ("trigger", ["-DV_TRIGGER=1"]), ("bulk", ["-DV_BULK=1"]),
           ("bulk_clock64", ["-DV_BULK=1", "-DV_CLOCK64"]),
           ("bulk_t384", ["-DV_BULK=1", "-DV_T=384"]),
           # this redesign's first kernel, and its second
           ("first_design", ["-DV_SYNC_SEND=1", "-DV_SEPARATE_PRODUCTS=1",
                             "-DV_ARGMAX=2", "-DV_ROT=1",
                             "-DV_LATE_WAIT=1"]),
           ("second_design", ["-DV_TRIG=1", "-DV_ARGMAX=1", "-DV_ROT=1",
                              "-DV_LATE_WAIT=1"]),
           ("stop1", ["-DV_STOP=1"]), ("stop2", ["-DV_STOP=2"]),
           ("stop3", ["-DV_STOP=3"]), ("clock", ["-DV_CLOCK"]),
           ("clock64", ["-DV_CLOCK64"]),
           ("second_design_clock64", ["-DV_TRIG=1", "-DV_ARGMAX=1",
                                      "-DV_ROT=1", "-DV_LATE_WAIT=1",
                                      "-DV_CLOCK64"]))},
    "tone_coarse_fused": (KNOBS, [], "am_tone_coarse_fused", FUSED_ARGS),
    **{f"cfo_{name}": (KNOBS, flags, "am_cfo_step_variant", CFO_ARGS)
       for name, flags in (
           ("knobs_default", []), ("split1", ["-DVC_SPLIT=1"]),
           ("split2", ["-DVC_SPLIT=2"]),
           ("first_design", ["-DVC_SPLIT=1", "-DVC_ARGMAX=2"]),
           ("bulk", ["-DVC_MODE=1", "-DVC_SPLIT=1"]),
           ("ctas2", ["-DVC_CTAS=2", "-DVC_SPLIT=1"]),
           ("ctas4", ["-DVC_CTAS=4", "-DVC_SPLIT=1"]),
           ("pdl0", ["-DVC_PDL=0"]), ("argmax_block", ["-DVC_ARGMAX=2"]),
           ("trigger", ["-DVC_TRIGGER=1"]))},
}
# variants whose outputs are cut short: timed, not held to the plain version
PARTIAL = ("coarse_parent_stop1", "coarse_parent_stop2",
           "coarse_parent_stop3", "coarse_stop1", "coarse_stop2",
           "coarse_stop3", "coarse_fast_trig", "coarse_fast_trig_clock64")
N_STATIONS, N_SAMPLES = 16, 40000


def build_variants() -> dict:
    """Compile every variant, one ``nvcc`` each, all started together.
    Returns ``{name: (library path or None, ptxas lines)}``."""
    from nrsc5_tpu_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags, _, _) in VARIANTS.items():
        lib = OUT / f"k14_{name}.so"
        cmd = [K._nvcc(), *K.NVCC_FLAGS, *flags, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        keep = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "stack frame" in ln
                or "error" in ln or "Function properties" in ln]
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


def clock_phases(t, n_ctas: int, phases: tuple) -> dict:
    """Global-timer readings (ns, 8 a CTA; 0 where a CTA read none) as
    phase lengths in us, each phase ``(name, first reading, last
    reading)``: its median and largest over the CTAs that read both its
    ends, and the first entry to the last reading."""
    tk = t[:8 * n_ctas].view(n_ctas, 8).double().cpu()
    out = {}
    for name, a, b in phases:
        ok = (tk[:, a] > 0) & (tk[:, b] > 0)
        d = ((tk[ok, b] - tk[ok, a]) / 1e3).tolist()
        out[name] = [statistics.median(d), max(d)] if d else None
    last = max(float(tk[i][tk[i] > 0].max()) for i in range(n_ctas))
    out["first_entry_to_last_reading"] = (last - float(tk[:, 0].min())) / 1e3
    return out


# the clock64 variant's readings: (name, first tick, last tick)
CLOCK64_PHASES = (("loads_issued", 0, 1), ("wait", 1, 2),
                  ("f_amp_loads_issued", 2, 3), ("f_amp_arrival", 3, 13),
                  ("tone_loop_after_f_amp", 13, 4), ("tone_loop", 3, 4),
                  ("tone_barrier", 4, 5), ("to_sums", 5, 6),
                  ("products_and_sums", 6, 7), ("leader_after_sums", 7, 8),
                  ("leader_sums_wait", 8, 9), ("window", 9, 10),
                  ("argmax", 10, 11), ("tail", 11, 12),
                  ("entry_to_exit", 0, 12), ("entry_to_sums_sent", 0, 7))


def clock64_phases(t, n_ctas: int) -> dict:
    """SM cycles between the clock64 variant's ticks (16 a CTA), the
    median and largest over the leader CTAs (rank 0) and over the others
    where both ticks were read."""
    tk = t[:16 * n_ctas].view(n_ctas, 16).double().cpu()
    lead = torch_arange_mod(n_ctas)
    out = {}
    for name, a, b in CLOCK64_PHASES:
        row = {}
        for who, sel in (("leader", lead), ("others", ~lead)):
            ok = sel & (tk[:, a] > 0) & (tk[:, b] > 0)
            d = (tk[ok, b] - tk[ok, a]).tolist()
            row[who] = [statistics.median(d), max(d)] if d else None
        out[name] = row
    return out


def torch_arange_mod(n_ctas: int):
    import torch
    return torch.arange(n_ctas) % 8 == 0


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

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    built = build_variants()
    K.build(["am_coldstart", "am_fold", "sync_am_block"])
    for name, (lib, log) in built.items():
        print(name, "built" if lib else "FAILED", log, flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {}
    s, n = N_STATIONS, N_SAMPLES

    # --- inputs: a carrier in noise a station ---
    rng = np.random.default_rng(14)
    t = np.arange(n)
    freq = rng.uniform(-60, 60, s) / C.FFT_AM
    x = rng.uniform(0.5, 2.0, s)[:, None] * np.exp(
        2j * np.pi * (freq[:, None] * t + rng.uniform(0, 1, s)[:, None])) \
        + 0.3 * (rng.standard_normal((s, n))
                 + 1j * rng.standard_normal((s, n)))
    x = torch.from_numpy(np.stack([x.real, x.imag], -1).astype(
        np.float32)).to(dev)
    offs = rng.integers(0, n - AA.WINDOW_AM, s)
    offs[0], offs[1], offs[2], offs[3] = 1, 3, -12000, n  # odd, <0, clamped
    offset = torch.from_numpy(offs.astype(np.int32)).to(dev)
    f, amp = AA.am_tone(rc.dft(AA.tone_symbols(x, offset)), x, offset)
    pa = torch.from_numpy(np.where(np.arange(s) % 3 == 0, 0.0, rng.uniform(
        -3, 3, s)).astype(np.float32)).to(dev)
    ov = torch.from_numpy(np.where(np.arange(s) % 4 == 1, rng.integers(
        0, 600, s), -1).astype(np.int32)).to(dev)
    coarse_args = (x, offset, f, amp, pa, ov)
    want = AA.am_coarse_plain(*coarse_args)
    spectra1 = torch.from_numpy(rng.standard_normal(
        (s, C.BLKSZ, C.FFT_AM, 2)).astype(np.float32)).to(dev)
    want_cfo = AA.am_cfo_step_plain(spectra1)
    kern = AA._tables(str(dev))["kern"]

    def same(got, ref):
        return all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, ref))

    res["coarse_port"] = [same(AA.am_coarse(*coarse_args), want),
                          time_ms(torch, lambda: AA.am_coarse(*coarse_args),
                                  graph=True)]
    res["coarse_plain_ms"] = time_ms(
        torch, lambda: AA.am_coarse_plain(*coarse_args), reps=3, inner=2,
        graph=True)
    res["cfo_port"] = [same(AA.am_cfo_step(spectra1), want_cfo),
                       time_ms(torch, lambda: AA.am_cfo_step(spectra1),
                               graph=True)]

    clock = torch.zeros(8 * 16 * s, dtype=torch.int64, device=dev)

    def coarse_call(fn, clock_ptr=None):
        outs = (torch.empty(s, dtype=torch.int32, device=dev),
                torch.empty(s, dtype=torch.int32, device=dev),
                torch.empty(s, device=dev), torch.empty(s, 2, device=dev))

        def call():
            _checked(fn, x.data_ptr(), n, offset.data_ptr(), f.data_ptr(),
                     amp.data_ptr(), pa.data_ptr(), ov.data_ptr(),
                     kern.data_ptr(), *(o.data_ptr() for o in outs),
                     clock_ptr, s, stream())
        return call, outs

    def cfo_call(fn):
        outs = (torch.empty(s, AA.CFO_BINS, device=dev),
                torch.empty(s, dtype=torch.int32, device=dev))

        def call():
            _checked(fn, spectra1.data_ptr(), outs[0].data_ptr(),
                     outs[1].data_ptr(), s, stream())
        return call, (outs[1], outs[0])

    fns = {}
    for name in VARIANTS:
        lib = built[name][0]
        if lib is None or name == "tone_coarse_fused":
            continue
        fn = fns[name] = _entry(lib, name)
        try:
            if name.startswith("coarse_"):
                clocked = name.endswith(("_clock", "clock64"))
                call, outs = coarse_call(
                    fn, clock.data_ptr() if clocked else None)
                ref = want
            else:
                call, outs = cfo_call(fn)
                ref = want_cfo
            call()
            torch.cuda.synchronize()
            exact = None if name in PARTIAL else same(outs, ref)
            res[name] = [exact, time_ms(torch, call, graph=True)]
            if name == "coarse_parent_clock":
                clock.zero_()
                call()
                torch.cuda.synchronize()
                res[name + "_phases_us"] = clock_phases(
                    clock, s, (("tone_subtract", 0, 1), ("lane_sums", 1, 2),
                               ("window_argmax", 2, 3),
                               ("scalar_tail", 3, 4)))
            elif name.endswith("clock64"):
                clock.zero_()
                call()
                torch.cuda.synchronize()
                res[name + "_cycles"] = clock64_phases(clock, 8 * s)
            elif name == "coarse_clock":
                clock.zero_()
                call()
                torch.cuda.synchronize()
                # the leader's sums phase ends when every CTA's sums have
                # come; the others' when theirs are sent
                res[name + "_phases_us"] = clock_phases(
                    clock, 8 * s, (("loads_and_wait", 0, 1),
                                   ("tone_subtract", 1, 2),
                                   ("products_and_sums", 2, 4),
                                   ("window_argmax", 4, 5),
                                   ("scalar_tail", 5, 6)))
        except RuntimeError as e:
            res[name] = [False, str(e)]
    cuts = [res.get(f"coarse_parent{c}", [None, None])[1]
            for c in ("_stop1", "_stop2", "_stop3", "")]
    if None not in cuts:
        res["coarse_parent_split"] = {
            "tone_subtract": cuts[0], "lane_sums": cuts[1] - cuts[0],
            "window_argmax": cuts[2] - cuts[1],
            "scalar_tail": cuts[3] - cuts[2]}
    cuts = [res.get(f"coarse_{c}", [None, None])[1]
            for c in ("stop1", "stop2", "stop3", "knobs_default")]
    if None not in cuts:
        res["coarse_port_split"] = {
            "loads_and_tone_subtract": cuts[0],
            "products_and_sums_at_leader": cuts[1] - cuts[0],
            "window_argmax": cuts[2] - cuts[1],
            "scalar_tail": cuts[3] - cuts[2]}

    # --- the fused tone and coarse timing, against am_tone then am_coarse
    tb = AA._tables(str(dev))
    spectra_t = rc.dft(AA.tone_symbols(x, offset))
    fused_out = {}

    def fused(spectra, samples, off, prev_angle=pa, override=ov):
        ss = samples.shape[0]
        z = torch.empty(K.query("am_tone", "am_tone_z_len", ss), 2,
                        device=dev)
        part = torch.empty(ss, AA.N_GRID, AA.SUM_WIDTH, 2, device=dev)
        k0 = torch.empty(ss, dtype=torch.int32, device=dev)
        ff, aa = torch.empty(ss, device=dev), torch.empty(ss, 2, device=dev)
        outs = (torch.empty(ss, dtype=torch.int32, device=dev),
                torch.empty(ss, dtype=torch.int32, device=dev),
                torch.empty(ss, device=dev), torch.empty(ss, 2, device=dev))
        _checked(fns["tone_coarse_fused"], spectra.data_ptr(),
                 samples.data_ptr(), samples.shape[1], off.data_ptr(),
                 tb["u"].data_ptr(), tb["derot"].data_ptr(),
                 tb["twiddle"].data_ptr(), z.data_ptr(), part.data_ptr(),
                 k0.data_ptr(), ff.data_ptr(), aa.data_ptr(),
                 prev_angle.data_ptr(), override.data_ptr(),
                 tb["kern"].data_ptr(), *(o.data_ptr() for o in outs), ss,
                 stream())
        fused_out["coarse"] = outs
        return ff, aa

    if built["tone_coarse_fused"][0] is not None:
        fns["tone_coarse_fused"] = _entry(built["tone_coarse_fused"][0],
                                          "tone_coarse_fused")
        try:
            ft = fused(spectra_t, x, offset)
            torch.cuda.synchronize()
            tone_same = same(ft, (f, amp))
            res["tone_coarse_fused"] = [
                tone_same and same(fused_out["coarse"], want),
                time_ms(torch, lambda: fused(spectra_t, x, offset),
                        graph=True)]
            res["tone_port_ms"] = time_ms(
                torch, lambda: AA.am_tone(spectra_t, x, offset), graph=True)
            res["tone_then_coarse_port_ms"] = time_ms(
                torch, lambda: AA.am_coarse(x, offset, *AA.am_tone(
                    spectra_t, x, offset), pa, ov), graph=True)
        except RuntimeError as e:
            res["tone_coarse_fused"] = [False, str(e)]

    # --- one probe block as the cold start's graph replays it ---
    ctl = torch.stack([offset, torch.zeros_like(offset),
                       torch.full_like(offset, -1)])
    phase = torch.tensor([[1.0, 0.0]], device=dev).repeat(s, 1)
    prev = torch.zeros(s, device=dev)

    def body():
        scar._probe_body(x, ctl, phase, prev)

    def coarse_wrapper(fn):
        def run(samples, off, ff, aa, prev_angle, override):
            ss = samples.shape[0]
            outs = (torch.empty(ss, dtype=torch.int32, device=dev),
                    torch.empty(ss, dtype=torch.int32, device=dev),
                    torch.empty(ss, device=dev),
                    torch.empty(ss, 2, device=dev))
            _checked(fn, samples.data_ptr(), samples.shape[1],
                     off.data_ptr(), ff.data_ptr(), aa.data_ptr(),
                     prev_angle.data_ptr(), override.data_ptr(),
                     kern.data_ptr(), *(o.data_ptr() for o in outs), None,
                     ss, stream())
            return outs
        return run

    def cfo_wrapper(fn):
        def run(sp):
            ss = sp.shape[0]
            mags = torch.empty(ss, AA.CFO_BINS, device=dev)
            step = torch.empty(ss, dtype=torch.int32, device=dev)
            _checked(fn, sp.data_ptr(), mags.data_ptr(), step.data_ptr(),
                     ss, stream())
            return step, mags
        return run

    @contextlib.contextmanager
    def patched(**kw):
        old = {k: getattr(AA, k) for k in kw}
        for k, v in kw.items():
            setattr(AA, k, v)
        try:
            yield
        finally:
            for k, v in old.items():
                setattr(AA, k, v)

    plans = {"port": {}}
    if "coarse_parent" in fns and "cfo_parent" in fns:
        plans["parent"] = {"am_coarse": coarse_wrapper(fns["coarse_parent"]),
                           "am_cfo_step": cfo_wrapper(fns["cfo_parent"])}
    for name in ("coarse_pdl0", "coarse_plain_loads", "coarse_ctas4",
                 "coarse_ctas16", "coarse_ctas1_t1024",
                 "coarse_second_design", "coarse_bulk"):
        if name in fns:
            plans[name] = {"am_coarse": coarse_wrapper(fns[name])}
    if "cfo_pdl0" in fns:
        plans["cfo_pdl0"] = {"am_cfo_step": cfo_wrapper(fns["cfo_pdl0"])}
    if "coarse_trigger" in fns and "cfo_trigger" in fns:
        plans["triggers"] = {"am_coarse": coarse_wrapper(fns["coarse_trigger"]),
                             "am_cfo_step": cfo_wrapper(fns["cfo_trigger"])}
    if "tone_coarse_fused" in fns:
        tone_v = getattr(ctypes.CDLL(str(built["tone_coarse_fused"][0])),
                         "am_tone_variant")
        tone_v.argtypes = (P, P, L) + (P,) * 9 + (I, P)
        tone_v.restype = ctypes.c_int

        def tone_no_trigger(spectra, samples, off):
            ss = samples.shape[0]
            z = torch.empty(K.query("am_tone", "am_tone_z_len", ss), 2,
                            device=dev)
            part = torch.empty(ss, AA.N_GRID, AA.SUM_WIDTH, 2, device=dev)
            k0 = torch.empty(ss, dtype=torch.int32, device=dev)
            ff = torch.empty(ss, device=dev)
            aa = torch.empty(ss, 2, device=dev)
            _checked(tone_v, spectra.data_ptr(), samples.data_ptr(),
                     samples.shape[1], off.data_ptr(), tb["u"].data_ptr(),
                     tb["derot"].data_ptr(), tb["twiddle"].data_ptr(),
                     z.data_ptr(), part.data_ptr(), k0.data_ptr(),
                     ff.data_ptr(), aa.data_ptr(), ss, stream())
            return ff, aa

        plans["tail_no_trigger"] = {"am_tone": tone_no_trigger}
    if "tone_coarse_fused" in fns and res["tone_coarse_fused"][0]:
        def tone_fused(spectra, samples, off):
            return fused(spectra, samples, off, prev, ctl[2])

        plans["fused"] = {"am_tone": tone_fused,
                          "am_coarse": lambda *a: fused_out["coarse"]}
    def block_args():
        return x, offset, phase, prev, ctl[1], ctl[2]

    def graph_block():
        """One probe block captured as a CUDA graph and replayed once: its
        outputs (the eager block's are the reference)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            scar.am_coldstart_block_rc(*block_args())
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = scar.am_coldstart_block_rc(*block_args())
        g.replay()
        torch.cuda.synchronize()
        return out

    def capture_body(inner: int = 10):
        """The body, ``inner`` times, captured as one CUDA graph (after
        two warm calls)."""
        for _ in range(2):
            body()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                body()
        return g

    def reset_state():
        phase.copy_(torch.tensor([1.0, 0.0], device=dev))
        prev.zero_()

    # each plan's block, eager, against the plain path's outputs; one graph
    # replay of it against the eager block; its kernels (port and parent);
    # then the body's graph, replayed in turns with the other plans'
    want_block = scar.am_coldstart_block_rc(*block_args(), plain=True)
    block, graphs = {}, {}
    for name, kw in plans.items():
        try:
            with patched(**kw):
                reset_state()
                got = scar.am_coldstart_block_rc(*block_args())
                ok = all(torch.equal(got[k], want_block[k])
                         for k in want_block)
                graphed = graph_block()
                graph_same = all(torch.equal(got[k], graphed[k])
                                 for k in got)
                block[name] = {"eager_same_as_plain": ok,
                               "graph_same_as_eager": graph_same}
                graphs[name] = capture_body()
                graphs[name].replay()  # its first replay uploads it
        except RuntimeError as e:
            block[name] = {"error": str(e)}
    # device ms a block: CUDA events around one replay of a plan's graph
    # (10 blocks), the plans in turns (each round in a rotated order), the
    # median of 7 rounds
    names = list(graphs)
    times = {name: [] for name in names}
    for rnd in range(7):
        for name in names[rnd % len(names):] + names[:rnd % len(names)]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graphs[name].replay()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / 10)
    for name in names:
        block[name]["ms"] = statistics.median(times[name])
        block[name]["ms_rounds"] = times[name]
    # the kernels of the port's and the parent's blocks, last: a profiler
    # session leaves its tracing on and slows what runs after it
    for name in ("port", "parent"):
        if name in plans:
            with patched(**plans[name]):
                reset_state()
                block[name + "_kernels"] = kernel_spans(torch, body)
    res["probe_block"] = block
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
