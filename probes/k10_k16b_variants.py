"""Time the designs tried for K10 (the FM cold start's CFO scan) and K16b
(the SBR HF generator) against the kernels the port runs and their
parents, on one CUDA card, each held against the plain version.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/k10_k16b_variants.py [--only=k10|k16b]

Every variant is built here, one ``nvcc`` each, all started together, into
``build/probes/`` (gitignored):

* ``costas_track_parent.cu`` and ``needle_count_parent.cu``: K10 before its
  redesign, K3 (a thread a track, each step's load on its chain, derot and
  phases written) then the needle count (a warp a (station, CFO), reading
  derot back); K3 whole, with its loads up front (``-DCUT=1``), without
  its derot and phases stores (``-DCUT=2``), and with a global-timer clock
  a CTA (``-DCLOCK``); the torch gather, copy, ``repeat`` and fill ahead
  of them timed alone; the parent's whole scan (those six launches)
  captured as one graph;
* ``cfo_scan_variants.cu``: the port's K10 (``csrc/cfo_scan.cu``) with its
  choices as knobs (``-DV_*``, listed in its header) and a clock a CTA;
* ``sbr_hf_generate_parent.cu``: K16b before its redesign (a CTA a (lane,
  packet) staging by 4-byte loads, the LPC on warp 0 alone), whole, without
  its LPC (``-DCUT=1``), without its patch (``-DCUT=2``) and with a clock a
  CTA (``-DCLOCK``: staging, LPC, patch);
* ``sbr_hf_generate_variants.cu``: the designs with their knobs (``-DB_*``,
  listed in its header: packets a CTA, the parent's LPC, plain loads,
  direct stores, launch bounds) and a clock a CTA.

The port's kernels are timed through their wrappers beside them
(``k10_port``, ``k16b_port``; fresh outputs a call, as the path allocates
them).  K10 runs on the cold start's probe spectra of ``chip_smoke.py``'s
16 MP1 stations (K9's timing, K2's bf16 fold at CFO 0, ``dft_bf16``), and
on one station of them, the chain's latency floor.  K16b runs on three
batches of 128 lanes x 8 packets: the audio fleet's (the state the plain
path carries after its first batch) and one program's packets under the
``interpol_freq=0`` and ``smoothing_mode=0`` headers tiled to 128 lanes,
xl from K16a on the card.  Times: device ms a call, CUDA events around a
CUDA graph of 10 calls, median of 7 (``chip_smoke.time_ms``).  Every whole
variant must equal the plain version bit for bit (the count; x_high and
the new tails).

Prints the card's name and power limit, one line a variant's build (its
registers, shared memory and stack frames) and one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import multiprocessing
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
OUT = ROOT / "build" / "probes"
sys.path.insert(0, str(ROOT))

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K3_ARGS = (P, P, P, P, P, P, P, P, I, I, F, F, F, P)
NC_ARGS = (P, P, P, P, I, I, I, P)
K10_ARGS = (P, P, P, P, P, I, I, I, I, F, F, F, P)
B_ARGS = (P,) * 9 + (I, I, I, I, F, F, P)
K3_PARENT = HERE / "costas_track_parent.cu"
NC_PARENT = HERE / "needle_count_parent.cu"
K10_DESIGNS = HERE / "cfo_scan_variants.cu"
B_PARENT = HERE / "sbr_hf_generate_parent.cu"
B_DESIGNS = HERE / "sbr_hf_generate_variants.cu"
# variant name -> (source, extra nvcc flags, entry point, its argtypes)
VARIANTS = {
    **{f"k3_parent{n}": (K3_PARENT, f, "costas_track_parent", K3_ARGS)
       for n, f in (("", []), ("_cut1", ["-DCUT=1"]), ("_cut2", ["-DCUT=2"]),
                    ("_clock", ["-DCLOCK"]))},
    "nc_parent": (NC_PARENT, [], "needle_count_parent", NC_ARGS),
    **{f"k10_{n}": (K10_DESIGNS, f, "cfo_scan_variant", K10_ARGS)
       for n, f in (("t256", []), ("t128", ["-DV_THREADS=128"]),
                    ("t512", ["-DV_THREADS=512"]),
                    ("track_angles", ["-DV_TRACK_ANGLES"]),
                    ("chain_derot", ["-DV_CHAIN_DEROT"]),
                    ("chain_derot_t128", ["-DV_CHAIN_DEROT",
                                          "-DV_THREADS=128"]),
                    ("t256_clock", ["-DCLOCK"]),
                    ("chain_derot_clock", ["-DV_CHAIN_DEROT", "-DCLOCK"]),
                    ("fast", ["-DV_FAST_WRAP"]),
                    ("overlap", ["-DV_OVERLAP"]),
                    ("overlap_fast", ["-DV_OVERLAP", "-DV_FAST_WRAP"]),
                    ("overlap_fast_t512", ["-DV_OVERLAP", "-DV_FAST_WRAP",
                                           "-DV_THREADS=512"]),
                    ("overlap_clock", ["-DV_OVERLAP", "-DCLOCK"]),
                    ("overlap_fast_clock", ["-DV_OVERLAP", "-DV_FAST_WRAP",
                                            "-DCLOCK"]),
                    ("sincos", ["-DV_SINCOS"]),
                    ("overlap_sincos", ["-DV_OVERLAP", "-DV_SINCOS"]),
                    ("overlap_sincos_t512", ["-DV_OVERLAP", "-DV_SINCOS",
                                             "-DV_THREADS=512"]),
                    ("sincos_clock", ["-DV_SINCOS", "-DCLOCK"]),
                    ("overlap_sincos_clock", ["-DV_OVERLAP", "-DV_SINCOS",
                                              "-DCLOCK"]))},
    **{f"b_parent{n}": (B_PARENT, f, "sbr_hf_generate_parent", B_ARGS)
       for n, f in (("", []), ("_cut1", ["-DCUT=1"]), ("_cut2", ["-DCUT=2"]),
                    ("_clock", ["-DCLOCK"]))},
    **{f"b_{n}": (B_DESIGNS, f, "sbr_hf_generate_variant", B_ARGS)
       for n, f in (("pk1", []), ("pk2", ["-DB_PK=2"]), ("pk4", ["-DB_PK=4"]),
                    ("pk1_warp0", ["-DB_LPC_WARP0"]),
                    ("pk1_loads", ["-DB_LOADS"]),
                    ("pk1_direct", ["-DB_DIRECT"]),
                    ("pk1_minb8", ["-DB_MINB=8"]),
                    ("pk2_minb4", ["-DB_PK=2", "-DB_MINB=4"]),
                    ("pk2_direct", ["-DB_PK=2", "-DB_DIRECT"]),
                    ("pk1_clock", ["-DCLOCK"]),
                    ("pk2_clock", ["-DB_PK=2", "-DCLOCK"]),
                    ("v2", ["-DB_V2"]),
                    ("v2_t256", ["-DB_V2", "-DB_THREADS=256"]),
                    ("v2_minb8", ["-DB_V2", "-DB_MINB=8"]),
                    ("v2_t256_minb4", ["-DB_V2", "-DB_THREADS=256",
                                       "-DB_MINB=4"]),
                    ("v2_clock", ["-DB_V2", "-DCLOCK"]))},
}
# variants whose outputs are cut short: timed, not held to the plain version
PARTIAL = ("k3_parent_cut2", "b_parent_cut1", "b_parent_cut2")


def build_variants(names) -> dict:
    """Compile the variants ``names``, one ``nvcc`` each, all started
    together.  Returns ``{name: (library path or None, ptxas lines)}``."""
    from nrsc5_tpu_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, flags, _, _ = VARIANTS[name]
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


def stamps(t, n_ctas: int, width: int, names) -> dict:
    """A clock (``width`` int64 a CTA: the global timer at entry, at each
    phase's end, the last at exit) as microseconds: each phase's median and
    largest over the CTAs, the spread of the entries, the first entry to
    the last exit, and a CTA's life."""
    tk = t[:width * n_ctas].view(n_ctas, width)[:, :len(names) + 1]
    tk = tk.double().cpu()
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


def k10(torch, CS, built, res, stream) -> None:
    """K10's parents, variants and port on the probe's spectra."""
    from nrsc5_tpu_torch import constants as C
    from nrsc5_tpu_torch.ops import acquire_rc as AQ
    from nrsc5_tpu_torch.ops import costas as CO
    from nrsc5_tpu_torch.ops import detect_cfo as DC
    from nrsc5_tpu_torch.ops import frontend as FE
    from nrsc5_tpu_torch.ops import rcplx as rc
    from nrsc5_tpu_torch.ops import sync_fm as SF

    dev = torch.device("cuda")
    fleet = CS.make_fleet()
    capture = torch.from_numpy(fleet["capture"]).to(dev)
    samples = FE.ingest_fm_cu8(capture)
    s_n = samples.shape[0]
    ks, kv = AQ.coarse_timing_rc(samples)
    zero = torch.zeros(s_n, dtype=torch.int32, device=dev)
    unit = torch.tensor([[1.0, 0.0]], device=dev).repeat(s_n, 1)
    spectra = rc.dft_bf16(AQ.demod_fold_bf16(samples, zero, unit, ks,
                                             rc.angle(kv), zero)[0])
    del capture, samples
    one = spectra[:1].contiguous()
    want = DC.detect_cfo_scan_rc(spectra, plain=True)
    want1 = want[:1]
    res["k10_true_cfo_bins"] = fleet["cfo_bins"].tolist()
    res["k10_argmax_cfo"] = [int(want[s].flatten().argmax()) // C.BLKSZ
                             - DC.CFO_RANGE for s in range(s_n)]
    t = DC._scan_tables(str(dev))
    a = (SF.ALPHA, SF.BETA, CO.TWO_PI)

    # the port, through its wrapper
    res["k10_port"] = [torch.equal(DC.detect_cfo_scan_rc(spectra), want),
                       CS.time_ms(torch, lambda: DC.detect_cfo_scan_rc(
                           spectra), graph=True)]
    res["k10_port_one_station"] = [
        torch.equal(DC.detect_cfo_scan_rc(one), want1),
        CS.time_ms(torch, lambda: DC.detect_cfo_scan_rc(one), graph=True)]
    res["k10_plain"] = [True, CS.time_ms(
        torch, lambda: DC.detect_cfo_scan_rc(spectra, plain=True), reps=3,
        inner=2, graph=True)]

    # the parent: glue, K3, the needle count
    n_tr = s_n * DC.N_TRACKS
    cf = t["cfo_freq"].repeat_interleave(2 * DC.N_REFS).repeat(s_n)
    zf = torch.zeros_like(cf)

    def glue_gather():
        return spectra[:, :, t["bins"]].transpose(0, 1).reshape(
            C.BLKSZ, n_tr, 2).contiguous()

    def glue_tables():
        c = t["cfo_freq"].repeat_interleave(2 * DC.N_REFS).repeat(s_n)
        return c, torch.zeros_like(c)
    refs = glue_gather()
    res["glue_gather"] = [True, CS.time_ms(torch, glue_gather, graph=True)]
    res["glue_tables"] = [True, CS.time_ms(torch, glue_tables, graph=True)]
    derot = torch.empty_like(refs)
    phases = torch.empty(C.BLKSZ, n_tr, device=dev)
    ph_out = torch.empty(max(n_tr, 4 * 1024), device=dev)
    fr_out = torch.empty(n_tr, device=dev)
    count = torch.empty(s_n, DC.N_CFO, C.BLKSZ, dtype=torch.int32,
                        device=dev)
    plain_derot = CO.costas_track_rc_plain(refs, zf, zf, cf)[0]
    nc = None
    if built.get("nc_parent", (None,))[0] is not None:
        nc = _entry(built["nc_parent"][0], "nc_parent")

    def needle(d):
        _checked(nc, d.data_ptr(), t["vals_mask"].data_ptr(),
                 t["known_mask"].data_ptr(), count.data_ptr(), s_n,
                 DC.N_CFO, 2 * DC.N_REFS, stream())
    for name in (v for v in VARIANTS if v.startswith("k3_parent")):
        lib = built[name][0]
        if lib is None:
            continue
        fn = _entry(lib, name)

        def call(fn=fn):
            _checked(fn, refs.data_ptr(), zf.data_ptr(), zf.data_ptr(),
                     cf.data_ptr(), derot.data_ptr(), phases.data_ptr(),
                     ph_out.data_ptr(), fr_out.data_ptr(), C.BLKSZ, n_tr,
                     *a, stream())
        try:
            derot.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            exact = None
            if name not in PARTIAL and nc is not None:
                needle(derot)
                torch.cuda.synchronize()
                exact = bool(torch.equal(count, want))
                res[f"{name}_derot_max_abs_diff"] = float(
                    (derot - plain_derot).abs().max())
            res[name] = [exact, CS.time_ms(torch, call, graph=True)]
            if name == "k3_parent_clock":
                call()
                torch.cuda.synchronize()
                res[name + "_phases_us"] = stamps(
                    ph_out.view(torch.int64), -(-n_tr // 128), 2,
                    ("cta",))
        except RuntimeError as e:
            res[name] = [False, str(e)]
    if nc is not None and "k3_parent" in res:
        derot.zero_()
        res["nc_parent"] = [None, CS.time_ms(torch, lambda: needle(derot),
                                             graph=True)]
        k3 = _entry(built["k3_parent"][0], "k3_parent")

        def parent_scan():
            r = glue_gather()
            c, z = glue_tables()
            d = torch.empty_like(r)
            ph = torch.empty(C.BLKSZ, n_tr, device=dev)
            po = torch.empty(n_tr, device=dev)
            fo = torch.empty(n_tr, device=dev)
            _checked(k3, r.data_ptr(), z.data_ptr(), z.data_ptr(),
                     c.data_ptr(), d.data_ptr(), ph.data_ptr(),
                     po.data_ptr(), fo.data_ptr(), C.BLKSZ, n_tr, *a,
                     stream())
            needle(d)
        parent_scan()
        torch.cuda.synchronize()
        res["k10_parent_scan"] = [bool(torch.equal(count, want)),
                                  CS.time_ms(torch, parent_scan, graph=True)]

    # the designs
    room = torch.empty(s_n * DC.N_CFO * C.BLKSZ + 16 * s_n * 19,
                       dtype=torch.int32, device=dev)
    for name in (v for v in VARIANTS if v.startswith("k10_")):
        lib = built[name][0]
        if lib is None:
            continue
        fn = _entry(lib, name)
        for case, sp, w in (("", spectra, want), ("_one_station", one,
                                                  want1)):
            n_s = sp.shape[0]

            def call(fn=fn, sp=sp, n_s=n_s):
                _checked(fn, sp.data_ptr(), t["cfo_freq"].data_ptr(),
                         t["vals_mask"].data_ptr(),
                         t["known_mask"].data_ptr(), room.data_ptr(), n_s,
                         C.FFT_FM, DC.LB_FIRST, DC.UB_FIRST, *a, stream())
            try:
                room.fill_(-1)
                call()
                torch.cuda.synchronize()
                got = room[:w.numel()].view(w.shape)
                res[name + case] = [bool(torch.equal(got, w)),
                                    CS.time_ms(torch, call, graph=True)]
                if name.endswith("_clock"):
                    call()
                    torch.cuda.synchronize()
                    res[f"{name}{case}_phases_us"] = stamps(
                        room[w.numel():].view(torch.int64), n_s * 19, 8,
                        ("loads_angles", "recursion", "derotations",
                         "counts"))
            except RuntimeError as e:
                res[name + case] = [False, str(e)]


def k16b(torch, CS, built, res, stream, header_batches, streams) -> None:
    """K16b's parent, variants and port on the three audio batches."""
    from nrsc5_tpu_torch.audio import stage as AST
    from nrsc5_tpu_torch.audio.batch import (BatchedAudioDecoder,
                                             device_inputs)
    dev = torch.device("cuda")
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
    res["k16b_batches"] = {}
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
        args = (xl, sta["tail_r"], sta["tail_i"], inp["bwj"], st.src_idx,
                st.src_ok, st.kx)
        want = AST.sbr_hf_generate_plain(*args)
        m = st.m
        res["k16b_batches"][bname] = {"lanes": n, "packets": kp, "m": m,
                                      "kx": st.kx}
        res[f"k16b_port/{bname}"] = [
            all(torch.equal(x, y) for x, y in
                zip(AST.sbr_hf_generate(*args), want)),
            CS.time_ms(torch, lambda: AST.sbr_hf_generate(*args),
                       graph=True)]
        res[f"k16b_plain/{bname}"] = [True, CS.time_ms(
            torch, lambda: AST.sbr_hf_generate_plain(*args), reps=3,
            inner=2, graph=True)]
        plane = n * kp * AST.NSLOT * m * 2
        xh_room = torch.empty(plane + 2 * 8 * n * kp, device=dev)
        new_r = torch.empty(n, 2, 32, device=dev)
        new_i = torch.empty(n, 2, 32, device=dev)
        for name in (v for v in VARIANTS if v.startswith("b_")):
            lib = built[name][0]
            if lib is None:
                continue
            fn = _entry(lib, name)

            def call(fn=fn):
                _checked(fn, xl.data_ptr(), sta["tail_r"].data_ptr(),
                         sta["tail_i"].data_ptr(), inp["bwj"].data_ptr(),
                         st.src_idx.data_ptr(), st.src_ok.data_ptr(),
                         xh_room.data_ptr(), new_r.data_ptr(),
                         new_i.data_ptr(), n, kp, m, st.kx, AST.EPS,
                         AST.LPC_DIV, stream())
            try:
                xh_room.fill_(float("nan"))
                new_r.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                exact = None if name in PARTIAL else bool(
                    torch.equal(xh_room[:plane].view(want[0].shape), want[0])
                    and torch.equal(new_r, want[1])
                    and torch.equal(new_i, want[2]))
                res[f"{name}/{bname}"] = [exact, CS.time_ms(torch, call,
                                                            graph=True)]
                if name == "b_parent_clock":
                    call()
                    torch.cuda.synchronize()
                    res[f"{name}/{bname}_phases_us"] = stamps(
                        xh_room[plane:].view(torch.int64), n * kp, 4,
                        ("staging", "lpc", "patch"))
                elif name.endswith("_clock"):
                    call()
                    torch.cuda.synchronize()
                    pk = 2 if "pk2" in name else 1  # v2: one a CTA
                    res[f"{name}/{bname}_phases_us"] = stamps(
                        xh_room[plane:].view(torch.int64),
                        n * -(-kp // pk), 8,
                        ("first_bytes", "sums", "coefficients", "patches",
                         "exit"))
            except RuntimeError as e:
                res[f"{name}/{bname}"] = [False, str(e)]
        whole, cut1, cut2 = (res.get(f"b_parent{c}/{bname}", [0, None])[1]
                             for c in ("", "_cut1", "_cut2"))
        if all(isinstance(x, float) for x in (whole, cut1, cut2)):
            res[f"b_parent_split/{bname}"] = {
                "no_lpc": cut1, "no_patch": cut2, "lpc": whole - cut1,
                "patch": whole - cut2}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    only = next((a.split("=", 1)[1] for a in sys.argv[1:]
                 if a.startswith("--only=")), None)
    import chip_smoke as CS
    from nrsc5_tpu_torch import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = [v for v in VARIANTS
             if only is None or (only == "k10") == (not v.startswith("b_"))]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(CS.AUDIO_STREAMS), mp_context=ctx) as pool:
        jobs = {h: pool.submit(CS.make_header_batch, h)
                for h in CS.AUDIO_HEADERS} if only != "k10" else {}
        streams = pool.map(CS.make_audio_stream, CS.AUDIO_STREAMS) \
            if only != "k10" else []
        built = build_variants(names)
        K.build(["cfo_scan", "halfband_cu8", "coarse_timing", "demod_fold",
                 "dft_bf16", "aac_window_qmf_analysis", "sbr_hf_generate"])
        streams = list(streams)
        header_batches = {h: j.result() for h, j in jobs.items()}
    for name, (lib, log) in built.items():
        print(name, "built" if lib else "FAILED", log, flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {}
    if only != "k16b":
        k10(torch, CS, built, res, stream)
    if only != "k10":
        k16b(torch, CS, built, res, stream, header_batches, streams)
    print(json.dumps(res), flush=True)
    bad = [k for k, r in res.items() if isinstance(r, list) and r[0] is False]
    if bad:
        print("NOT EXACT:", bad, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
