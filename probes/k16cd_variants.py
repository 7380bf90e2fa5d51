"""Time the designs tried for K16c (the SBR HF adjuster and the assembly of
X) and K16d (the QMF synthesis fold and the int16 clip) against the kernels
the port runs and their parents, on one CUDA card, each held against the
plain version.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/k16cd_variants.py

Every variant is built here, one ``nvcc`` each, all started together, into
``build/probes/`` (gitignored):

* ``sbr_hf_adjust_parent.cu``: K16c before its redesign (a CTA a (lane,
  packet), or a lane walking its packets under the smoothing header; ~11
  barrier-separated phases; 45 KB of static shared memory sized for 64
  bins), whole, with its shared memory sized to 32 bins
  (``-DMAXM=32``: residency alone), cut before its X pass (``-DCUT=1``),
  its X pass without the envelope phases (``-DCUT=2``), and with a
  global-timer clock a CTA (``-DCLOCK``: inputs, e_curr, limiter, slot
  expansion, X pass, history shift);
* ``qmf_synthesis_parent.cu``: K16d before its redesign (a thread an
  output, grid-stride, 64-bit division), whole, stores alone (``-DCUT=1``),
  loads alone (``-DCUT=2``), and with a clock a CTA (``-DCLOCK``);
* ``k16cd_variants.cu``: the designs with their knobs (``C_*`` for K16c,
  ``D_*`` for K16d; listed in its header and in ``VARIANTS`` below, in the
  order they were tried), some with a global-timer clock a CTA
  (``*_clock``: each phase's length).  The port's kernels are timed
  through their wrappers beside them (``k16c_port``, ``k16d_port``: fresh
  outputs a call, as the stage allocates them, where the variants write
  one buffer again and again, which stays in L2, so the variants read
  faster than the same design in the port).

K16c runs on three batches of 128 lanes x 8 packets: the audio fleet's of
``chip_smoke.py`` (its default SBR header; the state the plain path
carries after its first batch) and one program's packets under the
``interpol_freq=0`` and ``smoothing_mode=0`` headers tiled to 128 lanes
(``chip_smoke.make_header_batch``), x_high and xl from K16a and K16b on
the card.  K16d runs on the fleet batch's V.  Times: device ms a call,
CUDA events around a CUDA graph of 10 calls, median of 7
(``chip_smoke.time_ms``).  Every whole variant must equal the plain
version bit for bit (X and the new histories; PCM and the new history).

Prints the card's name and power limit, one line a variant's build (its
registers, shared memory and stack frames) and one JSON object: for each
(variant, batch) ``[equal to the plain version (None where its outputs
are cut short), ms]``, the parents' splits, and each clock's phases.
"""

from __future__ import annotations

import ctypes
import json
import multiprocessing
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
OUT = ROOT / "build" / "probes"
sys.path.insert(0, str(ROOT))

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
C_PARENT_ARGS = (P,) * 23 + (I,) * 10 + (F,) * 9 + (P,)
C_ARGS = (P,) * 26 + (I,) * 10 + (F,) * 9 + (P,)
D_ARGS = (P, P, P, P, P, P, I, I, P)
C_PARENT = HERE / "sbr_hf_adjust_parent.cu"
D_PARENT = HERE / "qmf_synthesis_parent.cu"
DESIGNS = HERE / "k16cd_variants.cu"
# variant name -> (source, extra nvcc flags, entry point, its argtypes)
VARIANTS = {
    **{f"c_parent{n}": (C_PARENT, f, "sbr_hf_adjust_parent", C_PARENT_ARGS)
       for n, f in (("", []), ("_m32", ["-DMAXM=32"]), ("_cut1", ["-DCUT=1"]),
                    ("_cut2", ["-DCUT=2"]), ("_clock", ["-DCLOCK"]))},
    **{f"d_parent{n}": (D_PARENT, f, "qmf_synthesis_parent", D_ARGS)
       for n, f in (("", []), ("_cut1", ["-DCUT=1"]), ("_cut2", ["-DCUT=2"]),
                    ("_clock", ["-DCLOCK"]))},
    **{f"c_{n}": (DESIGNS, f, "sbr_hf_adjust_variant", C_ARGS)
       for n, f in (("t256", []), ("t128", ["-DC_THREADS=128"]),
                    ("t512", ["-DC_THREADS=512"]), ("own2", ["-DC_OWN=2"]),
                    ("cluster", ["-DC_CLUSTER=1"]),
                    ("pack", ["-DC_PACK=1"]), ("carve", ["-DC_CARVE=1"]),
                    ("pack_carve", ["-DC_PACK=1", "-DC_CARVE=1"]),
                    ("pack_carve_t128", ["-DC_PACK=1", "-DC_CARVE=1",
                                         "-DC_THREADS=128"]),
                    ("pack_carve_own2", ["-DC_PACK=1", "-DC_CARVE=1",
                                         "-DC_OWN=2"]),
                    ("t256_clock", ["-DCLOCK"]),
                    ("v2", ["-DC_V2=1"]),
                    ("v2_t128", ["-DC_V2=1", "-DC_THREADS=128"]),
                    ("v2_t512", ["-DC_V2=1", "-DC_THREADS=512"]),
                    ("v2_own2", ["-DC_V2=1", "-DC_OWN=2"]),
                    ("v2_own2_t512", ["-DC_V2=1", "-DC_OWN=2",
                                      "-DC_THREADS=512"]),
                    ("v2_clock", ["-DC_V2=1", "-DCLOCK"]),
                    ("early", ["-DC_EARLY=1"]),
                    ("early_own2", ["-DC_EARLY=1", "-DC_OWN=2"]),
                    ("early_own2_t512", ["-DC_EARLY=1", "-DC_OWN=2",
                                         "-DC_THREADS=512"]),
                    ("early_own4_t512", ["-DC_EARLY=1", "-DC_OWN=4",
                                         "-DC_THREADS=512"]),
                    ("early_clock", ["-DC_EARLY=1", "-DCLOCK"]),
                    ("early_own2_clock", ["-DC_EARLY=1", "-DC_OWN=2",
                                          "-DCLOCK"]),
                    ("xl4", ["-DC_EARLY=1", "-DC_XL4=1"]),
                    ("xl4_own2", ["-DC_EARLY=1", "-DC_XL4=1", "-DC_OWN=2"]),
                    ("xl4_own2_t512", ["-DC_EARLY=1", "-DC_XL4=1",
                                       "-DC_OWN=2", "-DC_THREADS=512"]),
                    ("pack_xl4_own2_minb4", ["-DC_EARLY=1", "-DC_XL4=1",
                                             "-DC_OWN=2", "-DC_PACK=1",
                                             "-DC_MINB=4"]),
                    ("pack_xl4_minb4", ["-DC_EARLY=1", "-DC_XL4=1",
                                        "-DC_PACK=1", "-DC_MINB=4"]),
                    ("pack_xl4_own2_t512_minb2", [
                        "-DC_EARLY=1", "-DC_XL4=1", "-DC_OWN=2",
                        "-DC_PACK=1", "-DC_THREADS=512", "-DC_MINB=2"]),
                    ("conv", ["-DC_EARLY=1", "-DC_CONV=1"]),
                    ("conv_own2", ["-DC_EARLY=1", "-DC_CONV=1",
                                   "-DC_OWN=2"]),
                    ("conv_own2_t512", ["-DC_EARLY=1", "-DC_CONV=1",
                                        "-DC_OWN=2", "-DC_THREADS=512"]),
                    ("v3", ["-DC_V3=1"]),
                    ("v3_minb4", ["-DC_V3=1", "-DC_MINB=4"]),
                    ("v3_t128", ["-DC_V3=1", "-DC_THREADS=128"]),
                    ("v3_t128_minb8", ["-DC_V3=1", "-DC_THREADS=128",
                                       "-DC_MINB=8"]),
                    ("v3_t512", ["-DC_V3=1", "-DC_THREADS=512"]),
                    ("v3_clock", ["-DC_V3=1", "-DCLOCK"]))},
    **{f"d_{n}": (DESIGNS, f, "qmf_synthesis_variant", D_ARGS)
       for n, f in (("t32", []), ("t16", ["-DD_T=16"]), ("t64", ["-DD_T=64"]),
                    ("cols2", ["-DD_COLS=2"]), ("loads", ["-DD_BULK=0"]),
                    ("r2", ["-DD_R=2"]), ("r8", ["-DD_R=8"]),
                    ("split", ["-DD_SPLIT=1"]),
                    ("cols2_split", ["-DD_COLS=2", "-DD_SPLIT=1"]),
                    ("t64_cols2", ["-DD_T=64", "-DD_COLS=2"]),
                    ("carve", ["-DD_CARVE=1"]),
                    ("cols2_carve", ["-DD_COLS=2", "-DD_CARVE=1"]),
                    ("slide_r8", ["-DD_SLIDE=1", "-DD_R=8"]),
                    ("slide_r8_cols2", ["-DD_SLIDE=1", "-DD_R=8",
                                        "-DD_COLS=2"]),
                    ("slide_r4_cols2", ["-DD_SLIDE=1", "-DD_COLS=2"]),
                    ("slide_r8_t64", ["-DD_SLIDE=1", "-DD_R=8", "-DD_T=64"]),
                    ("slide_r8_cols2_carve", ["-DD_SLIDE=1", "-DD_R=8",
                                              "-DD_COLS=2", "-DD_CARVE=1"]),
                    ("slide_r16_cols2", ["-DD_SLIDE=1", "-DD_R=16",
                                         "-DD_COLS=2"]),
                    ("t32_clock", ["-DCLOCK"]),
                    ("slide_r8_cols2_clock", ["-DD_SLIDE=1", "-DD_R=8",
                                              "-DD_COLS=2", "-DCLOCK"]))},
}
# variants whose outputs are cut short: timed, not held to the plain version
PARTIAL = ("c_parent_cut1", "c_parent_cut2", "d_parent_cut1",
           "d_parent_cut2")
# (variant, batch) pairs a design does not take: two packets a CTA only
# without smoothing, the cluster only with it (its default is the t256's)
SKIP = {("c_v2_own2", "smooth"), ("c_v2_own2_t512", "smooth"),
        ("c_cluster", "default"), ("c_cluster", "interpol0")}


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


def phases(t, n_ctas: int, names) -> dict:
    """A clock variant's global timer readings (ns; entry, the phase
    lengths, exit a CTA) as microseconds: each phase's median and largest
    over the CTAs, the spread of the entries, and the first entry to the
    last exit."""
    w = len(names) + 2
    tk = t[:w * n_ctas].view(n_ctas, w).double().cpu()
    out = {}
    for p, name in enumerate(names):
        d = tk[:, p + 1] / 1e3
        out[name] = [float(d.median()), float(d.max())]
    out["entry_spread"] = float((tk[:, 0].max() - tk[:, 0].min()) / 1e3)
    out["first_entry_to_last_exit"] = float(
        (tk[:, -1].max() - tk[:, 0].min()) / 1e3)
    out["cta_life"] = [float((tk[:, -1] - tk[:, 0]).median() / 1e3),
                       float((tk[:, -1] - tk[:, 0]).max() / 1e3)]
    return out


def stamps(t, n_ctas: int, width: int, names) -> dict:
    """A design's clock (``width`` int64 a CTA: the global timer at entry,
    at each phase's end, at exit) as microseconds: each phase's median and
    largest over the CTAs, the spread of the entries, the first entry to
    the last exit, and a CTA's life."""
    tk = t[:width * n_ctas].view(n_ctas, width)[:, :len(names) + 1]
    tk = tk[tk[:, 0] != 0].double().cpu()
    out = {}
    for p, name in enumerate(names):
        d = (tk[:, p + 1] - tk[:, p]) / 1e3
        out[name] = [float(d.median()), float(d.max())]
    out["entry_spread"] = float((tk[:, 0].max() - tk[:, 0].min()) / 1e3)
    out["first_entry_to_last_exit"] = float(
        (tk[:, -1].max() - tk[:, 0].min()) / 1e3)
    out["cta_life"] = [float((tk[:, -1] - tk[:, 0]).median() / 1e3),
                       float((tk[:, -1] - tk[:, 0]).max() / 1e3)]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.audio import stage as AST
    from nrsc5_tpu_torch.audio.batch import (BatchedAudioDecoder,
                                             device_inputs)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(CS.AUDIO_STREAMS), mp_context=ctx) as pool:
        jobs = {h: pool.submit(CS.make_header_batch, h)
                for h in CS.AUDIO_HEADERS}
        built = build_variants()
        K.build(["aac_window_qmf_analysis", "sbr_hf_generate",
                 "sbr_hf_adjust", "qmf_synthesis"])
        streams = list(pool.map(CS.make_audio_stream, CS.AUDIO_STREAMS))
        header_batches = {h: j.result() for h, j in jobs.items()}
    for name, (lib, log) in built.items():
        print(name, "built" if lib else "FAILED", log, flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    # the batches: the fleet's (default header) at the state after its
    # first batch, and the other headers' tiled to the fleet's lanes
    adec = BatchedAudioDecoder(CS.AUDIO_PROGRAMS)
    programs = [streams[p % len(streams)] for p in range(CS.AUDIO_PROGRAMS)]
    preps = [adec.prepare(programs) for _ in range(2)]
    stage = preps[0][0]
    adec._reconcile_state(*preps[0][2:])
    state, _ = stage(adec._state, device_inputs(preps[0][1], dev),
                     plain=True)
    batches = {"default": (stage, device_inputs(preps[1][1], dev), state)}
    lanes = 2 * CS.AUDIO_PROGRAMS
    for h, b in header_batches.items():
        batches[h] = CS.tile_lanes(torch, h, b, lanes, dev)

    res = {"batches": {}}
    d_args = None
    for bname, (st, inp, sta) in batches.items():
        n, kp = inp["spec_long"].shape[:2]
        xl = AST.window_qmf_analysis(
            torch.matmul(inp["spec_long"].reshape(n * kp, -1),
                         st.blt).reshape(n, kp, 2048),
            torch.matmul(inp["spec_short"].reshape(n * kp * 8, -1),
                         st.bst).reshape(n, kp, 8, 256),
            inp["win_long_idx"], inp["win_short_idx"], inp["short"],
            sta["overlap"], sta["qa_hist"], st.lut_long, st.lut_short,
            st.ka)[0]
        xh = AST.sbr_hf_generate(xl, sta["tail_r"], sta["tail_i"],
                                 inp["bwj"], st.src_idx, st.src_ok, st.kx)[0]
        maps = st.maps()
        args = (xh, xl, inp["env_seg"], inp["freq_res"], inp["e_bands"],
                inp["q_bands"], inp["harm_act"], inp["delta_e"],
                inp["noise_start"], inp["nlow"], sta.get("g_hist"),
                sta.get("q_hist"), maps, st.noise_tab, st.kx, st.lim_gain,
                st.interpol, st.smooth)
        want = AST.sbr_hf_adjust_plain(*args)
        res["batches"][bname] = {"lanes": n, "packets": kp, "m": st.m,
                                 "kx": st.kx, "interpol": st.interpol,
                                 "smooth": st.smooth}
        res[f"k16c_port/{bname}"] = [
            all(a is None or torch.equal(a, b) for a, b in
                zip(AST.sbr_hf_adjust(*args), want)),
            CS.time_ms(torch, lambda: AST.sbr_hf_adjust(*args), graph=True)]
        res[f"k16c_plain/{bname}"] = [True, CS.time_ms(
            torch, lambda: AST.sbr_hf_adjust_plain(*args), reps=3, inner=2,
            graph=True)]
        # outputs, with room behind X for a clock's 16 int64 a CTA
        plane = n * kp * AST.NSLOT * 64
        x_room = torch.empty(2 * plane + 2 * 16 * n * kp, device=dev)
        g_out = torch.empty(n, 4, 64, device=dev)
        q_out = torch.empty(n, 4, 64, device=dev)
        nh, nq = inp["e_bands"].shape[-1], inp["q_bands"].shape[-1]
        head = [t.data_ptr() for t in (
            xh, xl, inp["env_seg"], inp["freq_res"], inp["e_bands"],
            inp["q_bands"], inp["harm_act"], inp["delta_e"],
            inp["noise_start"], inp["nlow"], maps["band_hi"],
            maps["band_lo"], maps["band_noise"], maps["sin_band"],
            maps["lim_band"])]
        spans = [maps[k].data_ptr() for k in ("hi_span", "lo_span",
                                              "lim_span")]
        tail = [maps["w_hi"].data_ptr(), maps["w_lo"].data_ptr(),
                st.noise_tab.data_ptr(),
                *((sta["g_hist"].data_ptr(), sta["q_hist"].data_ptr(),
                   g_out.data_ptr(), q_out.data_ptr()) if st.smooth
                  else (None,) * 4), x_room.data_ptr()]
        ints = [n, kp, st.m, st.kx, nh, maps["w_lo"].numel(), nq,
                int(maps["n_lim"]), int(st.interpol), int(st.smooth)]
        floats = [st.lim_gain, AST.EPS, AST.G_MAX_CAP, AST.MAX_BOOST,
                  *AST.H_SMOOTH]
        for name in (v for v in VARIANTS if v.startswith("c_")):
            lib = built[name][0]
            if lib is None or (name, bname) in SKIP:
                continue
            fn = _entry(lib, name)
            ptrs = head + (spans if VARIANTS[name][3] is C_ARGS else []) \
                + tail

            def call(fn=fn, ptrs=ptrs):
                _checked(fn, *ptrs, *ints, *floats, stream())
            try:
                x_room.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                got_x = x_room[:2 * plane].view(want[0].shape)
                exact = None if name in PARTIAL else (
                    torch.equal(got_x, want[0]) and (not st.smooth or (
                        torch.equal(g_out, want[1])
                        and torch.equal(q_out, want[2]))))
                res[f"{name}/{bname}"] = [exact, CS.time_ms(torch, call,
                                                            graph=True)]
                if name == "c_parent_clock":
                    call()
                    torch.cuda.synchronize()
                    ctas = n if st.smooth else n * kp
                    res[f"{name}/{bname}_phases_us"] = phases(
                        x_room[2 * plane:].view(torch.int64), ctas,
                        ("inputs", "e_curr", "limiter", "slot_expansion",
                         "x_pass", "history_shift"))
                elif name.endswith("_clock"):
                    x_room[2 * plane:].zero_()  # a persistent grid stamps
                    call()                      # fewer CTAs than items
                    torch.cuda.synchronize()
                    own = max([int(f.split("=")[1]) for f in VARIANTS[name][1]
                               if f.startswith("-DC_OWN=")] or [1])
                    res[f"{name}/{bname}_phases_us"] = stamps(
                        x_room[2 * plane:].view(torch.int64),
                        n * -(-kp // own), 16,
                        ("pair_loads", "xl_wait", "low_band", "xh_wait",
                         "e_curr", "interpol0_means", "levels_limiter",
                         "boost", "smooth_rows", "x_pass", "history"))
            except RuntimeError as e:
                res[f"{name}/{bname}"] = [False, str(e)]
        whole, cut1, cut2 = (res.get(f"c_parent{c}/{bname}", [0, None])[1]
                             for c in ("", "_cut1", "_cut2"))
        if None not in (whole, cut1, cut2) and all(
                isinstance(t, float) for t in (whole, cut1, cut2)):
            res[f"c_parent_split/{bname}"] = {
                "before_x_pass": cut1, "x_pass_alone": cut2,
                "x_pass": whole - cut1}
        if bname == "default":
            x = want[0]
            v = (torch.matmul(x[0].reshape(-1, 64), st.smr)
                 - torch.matmul(x[1].reshape(-1, 64), st.smi)).reshape(
                     n, kp * AST.NSLOT, 128)
            d_args = (v, sta["syn_hist"], st.cidx, st.w10)

    # --- K16d on the fleet batch's V ---
    v, syn, cidx, w10 = d_args
    n, s_tot = v.shape[:2]
    want = AST.qmf_synthesis_plain(*d_args)
    res["k16d_port"] = [
        all(torch.equal(a, b) for a, b in zip(AST.qmf_synthesis(*d_args),
                                               want)),
        CS.time_ms(torch, lambda: AST.qmf_synthesis(*d_args), graph=True)]
    pcm = torch.empty_like(want[0])
    # the new history, with room behind it for a clock's 2 int64 a CTA
    hist_room = torch.empty(n * AST.SYN_HIST * 128 + 4 * 132 * 32,
                            device=dev)
    for name in (v_ for v_ in VARIANTS if v_.startswith("d_")):
        lib = built[name][0]
        if lib is None:
            continue
        fn = _entry(lib, name)

        def call(fn=fn):
            _checked(fn, v.data_ptr(), syn.data_ptr(), cidx.data_ptr(),
                     w10.data_ptr(), pcm.data_ptr(), hist_room.data_ptr(),
                     n, s_tot, stream())
        try:
            pcm.fill_(0x5555)
            hist_room.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            exact = None if name in PARTIAL else (
                torch.equal(pcm, want[0]) and torch.equal(
                    hist_room[:n * AST.SYN_HIST * 128].view(want[1].shape),
                    want[1]))
            res[name] = [exact, CS.time_ms(torch, call, graph=True)]
            if name == "d_parent_clock":
                call()
                torch.cuda.synchronize()
                total = n * s_tot * 64 + n * AST.SYN_HIST * 128
                ctas = min(-(-total // 256), 132 * 32)
                res[name + "_phases_us"] = phases(
                    hist_room[n * AST.SYN_HIST * 128:].view(torch.int64),
                    ctas, ())
            elif name.endswith("_clock"):
                call()
                torch.cuda.synchronize()
                res[name + "_phases_us"] = stamps(
                    hist_room[n * AST.SYN_HIST * 128:].view(torch.int64),
                    n * -(-s_tot // 32), 4, ("staged", "fold", "history"))
        except RuntimeError as e:
            res[name] = [False, str(e)]
    if all(k in res for k in ("d_parent", "d_parent_cut1", "d_parent_cut2")):
        res["d_parent_split"] = {
            "stores_alone": res["d_parent_cut1"][1],
            "loads_alone": res["d_parent_cut2"][1],
            "loads_and_sums": res["d_parent"][1] - res["d_parent_cut1"][1]}
    print(json.dumps(res), flush=True)
    bad = [k for k, r in res.items() if isinstance(r, list) and r[0] is False]
    if bad:
        print("NOT EXACT:", bad, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
