"""Time the designs tried for K15 (the AM channel gathers) and K11 (the PX
interleaver-IV deinterleave) against the kernels the port runs and their
parents, on one CUDA card, each held against the plain version.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/k11_k15_variants.py [--only=k15,k11,stage]

(``--only`` runs the parts it names; all three by default.)

Every variant is built here, one ``nvcc`` each, all started together, into
``build/probes/`` (gitignored):

* ``am_gather_parent.cu`` and ``px_deinterleave_parent.cu``: both kernels
  before their redesign (a thread a float32 output, grid-stride, 64-bit
  index arithmetic, the maps in their old form), whole, cut to their
  stores (``-DCUT=1``), to their map loads and stores (``-DCUT=2``) and to
  all but the line or state rewrite (``-DCUT=3``), and with a global-timer
  clock a CTA (``-DCLOCK``).  Their split: stores, map loads (cut 2 less
  cut 1), data gathers (cut 3 less cut 2), line or state rewrite (whole
  less cut 3);
* ``k11_k15_variants.cu``: the designs, their knobs as template
  parameters (``K15_DESIGNS``, ``K11_DESIGNS`` below, in the order they
  were tried): K15 staging a frame in shared memory with 1-16 CTAs a
  frame, 4-16 outputs a thread step, 256-1024 threads, float32 out, the
  map read once for two frames, clusters staging once by multicast,
  cp.async or piecewise staging, no load for a punctured entry, word
  loads, the frame unpacked to K7 values, two barriers, chunks
  block-cyclic over the CTAs, 3-byte map entries, and cuts (no
  shared-memory load, no map load, neither, no line copy); gathers from
  L2 and map-stationary; K11 a CTA a pair or a group of 2-8 pairs staging
  the group's runs once, the same over clusters by multicast, cp.async or
  piecewise or rotated staging, the runs merged into the fewest copies,
  the new state by bulk stores, 3-byte table entries, the gathers of each
  copy's runs as it lands, the copy plan without a modulo, gathers from
  L2, and cuts of the state copies.  Designs whose CTAs read the global
  timer (``*_CLOCKED``) also report, by CTA, staging (entry to the bytes
  landed) and gathers (to the end);
* a staging bench (``stage_bench``): 73-166 KB a CTA by bulk copies,
  1-64 copies, 33-264 CTAs, from one source block a CTA or shared ones.

Prints the card's name and power limit, one line a variant's build (its
registers, shared memory and stack frames) and one JSON object.
"""

from __future__ import annotations

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

P, I = ctypes.c_void_p, ctypes.c_int
K15_PARENT_ARGS = (P,) * 13 + (I,) * 6 + (P, P)
K11_PARENT_ARGS = (P,) * 9 + (I,) * 6 + (P, P)
K15_ARGS = (I,) + (P,) * 14 + (I,) * 6 + (P, P)
K15_V3_ARGS = (I,) + (P,) * 15 + (I,) * 6 + (P, P)
K11_ARGS = (I,) + (P,) * 7 + (I,) * 5 + (P, P)
CUTS = (("", []), ("_cut1", ["-DCUT=1"]), ("_cut2", ["-DCUT=2"]),
        ("_cut3", ["-DCUT=3"]), ("_clock", ["-DCLOCK"]))
# variant name -> (source, extra nvcc flags)
VARIANTS = {
    **{f"k15_parent{n}": (HERE / "am_gather_parent.cu", f) for n, f in CUTS},
    **{f"k11_parent{n}": (HERE / "px_deinterleave_parent.cu", f)
       for n, f in CUTS},
    "designs": (HERE / "k11_k15_variants.cu", []),
}
# design number -> (what it is, float32 output)
K15_DESIGNS = {
    0: ("smem: 8 CTAs a frame x 256 threads, 16 outputs a step (the port)",
        False),
    1: ("smem: 4 CTAs a frame x 256 threads", False),
    2: ("smem: 1 CTA a frame x 1024 threads", False),
    3: ("smem: 8 CTAs a frame, 4 outputs a step", False),
    4: ("smem: 8 CTAs a frame x 512 threads", False),
    5: ("smem: 16 CTAs a frame x 256 threads", False),
    6: ("smem: the port's, float32 out", True),
    7: ("smem: 8 CTAs a pair of frames, the map read once for both",
        False),
    8: ("L2: a thread per 4 outputs (the parent's shape, composed map)",
        False),
    9: ("L2: a thread per 16 outputs", False),
    10: ("L2: a thread per 4 outputs, float32 out", True),
    11: ("map-stationary: a thread's 4 map entries over the S x F frames, "
         "from L2", False),
    12: ("smem: 4 CTAs a frame x 512 threads", False),
    13: ("smem: 4 CTAs a pair of frames x 512 threads, 8 outputs a step",
         False),
    14: ("smem: 8 CTAs a frame, 8 outputs a step", False),
    15: ("cluster of 4 a frame x 512 threads, staged once by multicast",
         False),
    16: ("cluster of 8 a frame x 256 threads, multicast", False),
    17: ("cluster of 4 a frame x 1024 threads, multicast", False),
    18: ("smem: 4 CTAs a frame x 1024 threads", False),
    19: ("cluster of 8 a frame x 512 threads, multicast", False),
    20: ("smem: 2 CTAs a frame x 1024 threads", False),
    21: ("cluster of 2 a frame x 1024 threads, multicast", False),
    22: ("cluster of 4 a frame x 1024 threads, multicast, 8 outputs a step",
         False),
    23: ("v2: 4 CTAs a frame x 512, bulk copies, no load for a punctured "
         "entry", False),
    24: ("v2: 4 x 512, cp.async staging, no punctured load", False),
    25: ("v2: 8 x 256, cp.async staging, no punctured load", False),
    26: ("v2: 4 x 512, bulk copies, no punctured load, word loads", False),
    27: ("v2: 4 x 1024, cp.async staging, no punctured load", False),
    28: ("v2: 8 x 512, cp.async staging, no punctured load", False),
    29: ("v2: 4 x 512, bulk copies of 1152-byte pieces by warp 0, no "
         "punctured load", False),
    30: ("v2: 4 x 512, cp.async staging, punctured loads", False),
    31: ("v2: 8 x 256, cp.async staging, no punctured load, word loads",
         False),
    32: ("v2: 4 x 512, cp.async staging, no punctured load, word loads",
         False),
    33: ("v2 cut: 4 x 512, no shared-memory load", False),
    34: ("v2 cut: 4 x 512, no map load (entries hashed)", False),
    35: ("v2 cut: 4 x 512, neither", False),
    36: ("v3: 4 CTAs a frame x 512, the frame unpacked to K7 values in "
         "shared memory, a byte load an output", False),
    37: ("v3: 4 x 1024", False),
    38: ("v3: 2 x 1024", False),
    39: ("v3: 4 x 768", False),
    40: ("v3: 8 x 512", False),
    41: ("v3: 3 x 1024", False),
    42: ("v5: 4 x 512, codes and lines on two barriers, chunks block-cyclic",
         False),
    43: ("v5: 4 x 512, two barriers, the chunks that read no delayed bit "
         "before the lines land", False),
    44: ("v5: 4 x 1024, two passes", False),
    45: ("v5: 8 x 256, two passes", False),
    46: ("v5: 8 x 512, two passes", False),
    47: ("v6: 4 x 512, block-cyclic (v5's first)", False),
    48: ("v6: 4 x 512, block-cyclic, 3-byte map entries", False),
    49: ("v6 cut: 4 x 512, block-cyclic, no copy of the kept line part",
         None),
    50: ("v6: 4 x 1024, 3-byte map", False),
    51: ("v6: 8 x 512, 3-byte map", False),
}
K15_V6 = range(47, 52)
# the designs cut short (timed, not held to the plain version)
K15_PARTIAL = (33, 34, 35, 49)
# the value-table designs (entry point k15_v3_variant)
K15_V3 = range(36, 47)
# the designs whose CTAs read the global timer (entry, staged, end)
K15_CLOCKED = (0, 1, 4, 7, 12, 15, 16, 17, 18, 19, 20, 21, 22,
               *range(23, 52))
K11_DESIGNS = {
    0: ("smem: a CTA a (station, pair) x 512 threads, 16 outputs a step "
        "(the port)", False),
    1: ("smem: 4 outputs a step", False),
    2: ("smem: 256 threads", False),
    3: ("smem: 1024 threads", False),
    4: ("smem: the port's, float32 out", True),
    5: ("L2: a CTA a (station, pair) x 256 threads, 4 outputs a step",
        False),
    6: ("L2: 16 outputs a step", False),
    7: ("L2: 4 outputs a step, float32 out", True),
    8: ("L2: 1024 threads, 4 outputs a step", False),
    9: ("smem: 8 outputs a step", False),
    10: ("group: a CTA a (station, 2 pairs) x 512 threads, 18 runs staged",
         False),
    11: ("group: 2 pairs x 1024 threads", False),
    12: ("group: 4 pairs, 2 CTAs (tiles) x 512 threads", False),
    13: ("group: 4 pairs, a cluster of 2 x 512, multicast", False),
    14: ("group: 8 pairs, a cluster of 4 x 512, multicast", False),
    15: ("group: 4 pairs, one CTA x 1024 threads", False),
    16: ("group: 8 pairs, 4 CTAs x 512 threads", False),
    17: ("group: 2 pairs, a cluster of 2 x 512, multicast", False),
    18: ("v2: a CTA a pair x 512, cp.async staging", False),
    19: ("v2: a CTA a pair x 512, bulk copies of 1152-byte pieces by warp 0",
         False),
    20: ("v2: 2 pairs x 512, cp.async staging", False),
    21: ("v2: 2 pairs x 1024, cp.async staging", False),
    22: ("v2: 4 pairs, 2 CTAs x 512, cp.async staging", False),
    23: ("v2: a CTA a pair x 256, cp.async staging", False),
    24: ("v2: 2 pairs x 512, bulk copies of 1152-byte pieces", False),
    25: ("v2: 4 pairs x 1024, cp.async staging", False),
    26: ("v2: 8 pairs, 4 CTAs x 512, cp.async staging", False),
    27: ("v2: a CTA a pair x 512, bulk copies, each CTA starting at another "
         "run", False),
    28: ("v2: 2 pairs x 512, bulk copies, rotated", False),
    29: ("v2: a CTA a pair x 256, bulk copies, rotated", False),
    30: ("v2: 2 pairs x 1024, bulk copies, rotated", False),
    31: ("v2: 4 pairs, 2 CTAs x 512, bulk copies, rotated", False),
    32: ("v4: a CTA a pair x 512, the runs merged into the fewest bulk "
         "copies", False),
    33: ("v4: 2 pairs x 512, merged copies", False),
    34: ("v4: 2 pairs x 1024, merged copies", False),
    35: ("v4: a CTA a pair x 256, merged copies", False),
    36: ("v4: 4 pairs, 2 CTAs x 512, merged copies", False),
    37: ("v4: a CTA a pair x 1024, merged copies", False),
    38: ("v4: 2 pairs, 2 CTAs x 512, merged copies", False),
    39: ("v4 cut: 2 pairs x 512, no state copies", None),
    40: ("v4: 2 pairs x 512, state copies after the gathers", False),
    41: ("v4 cut: a pair x 512, no state copies", None),
    42: ("v4: a pair x 512, state copies after the gathers", False),
    43: ("v6: 2 pairs x 512, merged copies, the state by bulk stores", False),
    44: ("v6: 2 pairs x 512, bulk stores, 3-byte table", False),
    45: ("v6: a pair x 512, bulk stores", False),
    46: ("v6: a pair x 512, bulk stores, 3-byte table", False),
    47: ("v6: 2 pairs x 1024, bulk stores, 3-byte table", False),
    48: ("v6: 4 pairs, 2 CTAs x 512, bulk stores, 3-byte table", False),
    49: ("v6: 2 pairs, 2 CTAs x 512, bulk stores, 3-byte table", False),
    50: ("v6: a pair x 256, bulk stores, 3-byte table", False),
    51: ("v7: 4 pairs, a cluster of 2 x 512 staging once by multicast", False),
    52: ("v7: 4 pairs, a cluster of 2 x 1024, multicast", False),
    53: ("v7: 8 pairs, a cluster of 4 x 512, multicast", False),
    54: ("v7: 8 pairs, a cluster of 4 x 1024, multicast", False),
    55: ("v7: 2 pairs, a cluster of 2 x 1024, multicast", False),
    56: ("v6: 2 pairs x 1024, bulk stores, 3-byte table (repeat of 47)",
         False),
    57: ("v8: a pair x 512, the gathers of each copy's runs as it lands, "
         "into a row buffer bulk-stored", False),
    58: ("v8: a pair x 1024", False),
    59: ("v8: 2 pairs x 512", False),
    60: ("v8: 2 pairs x 1024", False),
    61: ("v8: a pair x 256", False),
    62: ("v9: v6's 2 pairs x 1024, the copy plan without a modulo a region",
         False),
    63: ("v9: a pair x 512", False),
    64: ("v9: 2 pairs x 512", False),
    65: ("v9: a pair x 256", False),
    66: ("v10: 2 pairs x 1024, the table without punctured entries, 8 "
         "steps a thread step", False),
    67: ("v10: 2 pairs x 1024, 16 steps", False),
    68: ("v10: 2 pairs x 512, 8 steps (the port)", False),
    69: ("v10: a pair x 512, 8 steps", False),
    70: ("v10: 4 pairs x 1024, 8 steps", False),
    71: ("v10 cut: 2 pairs x 1024, no shared-memory loads", None),
    72: ("v10 cut: 2 pairs x 1024, no table loads", None),
    73: ("v10 cut: 2 pairs x 1024, neither", None),
    74: ("v10: a pair x 1024, 8 steps", False),
    75: ("v10: 4 pairs x 1024, 16 steps", False),
    76: ("v10: 2 pairs x 768, 8 steps", False),
    77: ("v10: 2 pairs x 512, 16 steps", False),
    78: ("v10: 2 pairs x 256, 8 steps", False),
    79: ("v10: 2 pairs x 512, 8 steps (repeat of 68)", False),
    80: ("v10 cut: 2 pairs x 512, neither load", None),
    81: ("v10 cut: 2 pairs x 512, no table loads", None),
}
K11_V10 = range(66, 82)
K11_V8 = range(57, 62)
K11_CLOCKED = (0, 3, *range(10, 82))
K11_V6 = (*range(43, 57), *range(62, 66))
# a group design's pairs a group
K11_GROUP = {10: 2, 11: 2, 12: 4, 13: 4, 14: 8, 15: 4, 16: 8, 17: 2,
             18: 1, 19: 1, 20: 2, 21: 2, 22: 4, 23: 1, 24: 2, 25: 4, 26: 8,
             27: 1, 28: 2, 29: 1, 30: 2, 31: 4, 32: 1, 33: 2, 34: 2, 35: 1,
             36: 4, 37: 1, 38: 2, 39: 2, 40: 2, 41: 1, 42: 1, 43: 2,
             44: 2, 45: 1, 46: 1, 47: 2, 48: 4, 49: 2, 50: 1, 51: 4,
             52: 4, 53: 8, 54: 8, 55: 2, 56: 2, 57: 1, 58: 1, 59: 2, 60: 2,
             61: 1, 62: 2, 63: 1, 64: 2, 65: 1, 66: 2, 67: 2, 68: 2,
             69: 1, 70: 4, 71: 2, 72: 2, 73: 2, 74: 1, 75: 4, 76: 2,
             77: 2, 78: 2, 79: 2, 80: 2, 81: 2}
N_STATIONS, N_FRAMES, N_PAIRS = 16, 2, 16
MP3_FL, MP2_FL = 4608, 2304  # PX1 frame bits


def build_variants() -> dict:
    """Compile every variant, one ``nvcc`` each, all started together.
    Returns ``{name: (library path or None, ptxas lines)}``."""
    from nrsc5_tpu_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in VARIANTS.items():
        lib = OUT / f"k11_k15_{name}.so"
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


def _entry(lib: Path, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _checked(fn, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"cudaError {err}")


def clock_summary(t, n_ctas: int) -> dict:
    """Global-timer readings (ns, entry and exit a CTA) -> the CTAs'
    lengths in us (median, largest) and the span from the first entry to
    the last exit."""
    tk = t[:2 * n_ctas].view(n_ctas, 2).double().cpu()
    ok = (tk[:, 0] > 0) & (tk[:, 1] > 0)
    d = ((tk[ok, 1] - tk[ok, 0]) / 1e3).tolist()
    span = float(tk[ok, 1].max() - tk[ok, 0].min()) / 1e3 if d else None
    return {"ctas": n_ctas, "read": len(d),
            "cta_us": [statistics.median(d), max(d)] if d else None,
            "span_us": span}


def stage_summary(t, n_ctas: int) -> dict:
    """A design's global-timer readings (entry, staged, end a CTA, ns) ->
    medians and largest values in us of staging (entry to staged) and of
    the gathers (staged to end), and the span from the first entry to the
    last end."""
    tk = t[:3 * n_ctas].view(n_ctas, 3).double().cpu()
    ok = (tk > 0).all(dim=1)
    tk = tk[ok]
    if not len(tk):
        return {"read": 0}
    stage = ((tk[:, 1] - tk[:, 0]) / 1e3).tolist()
    work = ((tk[:, 2] - tk[:, 1]) / 1e3).tolist()
    start = ((tk[:, 0] - tk[:, 0].min()) / 1e3).tolist()
    return {"ctas": n_ctas, "read": int(ok.sum()),
            "staging_us": [statistics.median(stage), max(stage)],
            "gathers_us": [statistics.median(work), max(work)],
            "entry_after_first_us": [statistics.median(start), max(start)],
            "span_us": float(tk[:, 2].max() - tk[:, 0].min()) / 1e3}


def full_table(fl: int) -> np.ndarray:
    """px_tables' first table in K7's whole layout, int32 [calls, map_len]:
    -1 at each trellis step's punctured middle input (the form the designs
    before v10 read)."""
    from nrsc5_tpu_torch.ops import decode_fm as DF
    t = DF.px_tables(fl)[0]
    out = np.full((t.shape[0], t.shape[1] // 2 * 3), -1, np.int32)
    out[:, np.arange(out.shape[1]) % 3 != 1] = t
    return out


def group_tables(fl: int, k_max: int) -> np.ndarray:
    """The group designs' tables, int32 [K, calls, map_len]: px_tables'
    entries for the pair k of a group at its own phase, remapped to the
    group's staged runs (region ph0 + j, j < k, read from pair j's soft
    bits at (calls + j) L; its own soft bits at (calls + k) L)."""
    from nrsc5_tpu_torch.ops import decode_fm as DF
    from nrsc5_tpu_torch.ops import interleavers as IL
    _, n, calls = IL.p3_iv_tables(fl)
    call_len = n // calls
    t = full_table(fl).astype(np.int64)
    ph = np.arange(calls)[:, None]
    out = []
    for k in range(k_max):
        own = t >= calls * call_len
        q = np.maximum(t, 0) // call_len
        j = (q - (ph - k)) % calls
        moved = (t >= 0) & ~own & (j < k)
        e = np.where(own, t + k * call_len, t)
        e = np.where(moved, (calls + j) * call_len + t - q * call_len, e)
        out.append(e)
    return np.stack(out).astype(np.int32)


def step_tables(fl: int, k_max: int) -> np.ndarray:
    """The v10 designs' tables, int32 [K, calls, 2 steps]: group_tables'
    entries without K7's punctured inputs (the middle one of each trellis
    step's three), which must be the only punctured ones."""
    t = group_tables(fl, k_max)
    keep = np.arange(t.shape[-1]) % 3 != 1
    if (t[..., ~keep] != -1).any() or (t[..., keep] < 0).any():
        raise ValueError("the punctured inputs are not each step's middle")
    return np.ascontiguousarray(t[..., keep])


def sorted_tables(fl: int, k_max: int):
    """The v8 designs' tables: for each pair k of a group and phase, its
    non-punctured outputs m sorted by the staged run of their entry e
    (m | e << 14, uint32 [K, calls, n_valid]) and each run's first index
    (int32 [K, calls, calls + K + 1])."""
    from nrsc5_tpu_torch.ops import interleavers as IL
    _, n, calls = IL.p3_iv_tables(fl)
    call_len = n // calls
    t = group_tables(fl, k_max).astype(np.int64)
    kk, cc, ml = t.shape
    valid = t[0, 0] >= 0
    nv = int(valid.sum())
    sorted_ = np.empty((kk, cc, nv), np.uint32)
    starts = np.empty((kk, cc, calls + k_max + 1), np.int32)
    m = np.arange(ml)[valid]
    for k in range(kk):
        for ph in range(cc):
            e = t[k, ph][valid]
            assert (e >= 0).all()
            run = e // call_len
            order = np.lexsort((m, run))
            sorted_[k, ph] = (m[order] | (e[order] << 14)).astype(np.uint32)
            starts[k, ph] = np.searchsorted(run[order],
                                            np.arange(calls + k_max + 1))
    return sorted_, starts


def value_map(ma3: bool) -> np.ndarray:
    """The v3 designs' map: decode_am's composed map with each bit address
    (byte * 8 + plane) remapped to its byte in the unpacked table ([6
    planes][25600] codes, [4][512] PIDS codes, the line slices), -1 to the
    zero byte after them."""
    from nrsc5_tpu_torch.ops import decode_am as DA
    g = DA.gather_maps(ma3)
    e = g["map"].astype(np.int64)
    byte, plane = np.maximum(e, 0) >> 3, np.maximum(e, 0) & 7
    fc, pb = DA.FRAME_CODES, DA.PIDS_BYTES
    vt_pids, vt_lines = 6 * fc, 6 * fc + 4 * pb
    out = np.where(byte < fc, plane * fc + byte,
                   np.where(byte < DA.LINE_BASE,
                            vt_pids + plane * pb + byte - fc,
                            vt_lines + byte - DA.LINE_BASE))
    pids_planes = plane[(byte >= fc) & (byte < DA.LINE_BASE) & (e >= 0)]
    code_planes = plane[(byte < fc) & (e >= 0)]
    assert pids_planes.max() < 4 and code_planes.max() < 6
    zero = vt_lines + g["n_delayed"] * DA.SEG
    return np.where(e < 0, zero, out).astype(np.int32)


def parent_k15_maps(ma3: bool) -> dict:
    """The parent's maps (p1_src/p1_dly, p3_src/p3_dly, pids_src,
    line_src [4, 18000]) recovered from the port's composed map."""
    from nrsc5_tpu_torch.ops import decode_am as DA
    g = DA.gather_maps(ma3)
    m1, m3, mp, nd = g["m1"], g["m3"], g["mp"], g["n_delayed"]
    emap = g["map"].astype(np.int64)
    line_map = emap[m1 + m3 + mp:]

    def split(e):
        dly = np.where(e >= DA.LINE_BASE * 8, e // 8 - DA.LINE_BASE, -1)
        src = np.where(dly >= 0, line_map[np.maximum(dly, 0)], e)
        return src.astype(np.int32), dly.astype(np.int32)

    out = {}
    out["p1_src"], out["p1_dly"] = split(emap[:m1])
    out["p3_src"], out["p3_dly"] = split(emap[m1:m1 + m3])
    out["pids_src"] = (emap[m1 + m3:m1 + m3 + mp // 8]
                       - DA.FRAME_CODES * 8).astype(np.int32)
    out["line_src"] = np.concatenate(
        [line_map, np.zeros((4 - nd) * DA.SEG, np.int64)]).astype(np.int32)
    return out


def main() -> int:
    import torch
    parts = {"k15", "k11", "stage"}
    for a in sys.argv[1:]:
        if a.startswith("--only="):
            parts = set(a[len("--only="):].split(","))
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import px_take_operands, time_ms
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.ops import decode_am as DA
    from nrsc5_tpu_torch.ops import decode_fm as DF
    from nrsc5_tpu_torch.ops import interleavers as IL

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    built = build_variants()
    port = K.build(["am_gather", "px_deinterleave"])
    for name, (lib, log) in built.items():
        print(name, "built" if lib else "FAILED", log, flush=True)
    for name, log in port["ptxas"].items():
        print("port", name, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "stack frame" in ln],
              flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    clock = torch.zeros(2 * 132 * 64, dtype=torch.int64, device=dev)
    res = {}
    s, nf = N_STATIONS, N_FRAMES
    g = torch.Generator().manual_seed(1115)

    # --- K15 ---
    for ma3 in (False, True) if "k15" in parts else ():
        mode = "ma3" if ma3 else "ma1"
        out = res[f"k15_{mode}"] = {}
        codes = torch.randint(0, 64, (s, 8 * nf, 4, 800), generator=g,
                              dtype=torch.uint8).to(dev)
        pids = torch.randint(0, 16, (s, 8 * nf, 32, 2), generator=g,
                             dtype=torch.uint8).to(dev)
        state = DA.AMDecodeState(*(torch.randint(
            0, 2, (s, DA.DD), generator=g, dtype=torch.uint8).to(dev)
            for _ in DA.DELAYED))
        want = DA.am_gather_plain(codes, pids, state, ma3)
        want_flat = list(want[:3]) + list(want[3])
        gm = DA.gather_maps(ma3)
        nd = gm["n_delayed"]

        def same(got, f32=False):
            ref = [w.float() if f32 and i < 3 else w
                   for i, w in enumerate(want_flat)]
            return all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(got, ref))

        got = DA.am_gather(codes, pids, state, ma3)
        out["port"] = [same(list(got[:3]) + list(got[3])),
                       time_ms(torch, lambda: DA.am_gather(codes, pids,
                                                           state, ma3),
                               graph=True)]
        out["plain_ms"] = time_ms(torch, lambda: DA.am_gather_plain(
            codes, pids, state, ma3), reps=3, inner=2, graph=True)

        # the parent, on its own maps and the stacked lines
        pm = {k: torch.from_numpy(v).to(dev)
              for k, v in parent_k15_maps(ma3).items()}
        lines = torch.stack(list(state), dim=1).contiguous()
        p_out = [torch.empty(w.shape, dtype=torch.float32, device=dev)
                 for w in want[:3]]
        p_lines = torch.empty_like(lines)

        def parent_call(fn, clock_ptr=None):
            def call():
                _checked(fn, codes.data_ptr(), pids.data_ptr(),
                         lines.data_ptr(), pm["p1_src"].data_ptr(),
                         pm["p1_dly"].data_ptr(), pm["p3_src"].data_ptr(),
                         pm["p3_dly"].data_ptr(), pm["pids_src"].data_ptr(),
                         pm["line_src"].data_ptr(),
                         *(o.data_ptr() for o in p_out), p_lines.data_ptr(),
                         s, nf, pm["p1_src"].numel(), pm["p3_src"].numel(),
                         pm["pids_src"].numel(), nd, clock_ptr, stream())
            return call

        for name, _ in CUTS:
            lib = built[f"k15_parent{name}"][0]
            if lib is None:
                continue
            fn = _entry(lib, "am_gather_parent", K15_PARENT_ARGS)
            try:
                call = parent_call(fn, clock.data_ptr() if name else None)
                call()
                torch.cuda.synchronize()
                exact = None
                if name == "":
                    exact = same(p_out + list(p_lines.unbind(1)), f32=True)
                out[f"parent{name}"] = [exact,
                                        time_ms(torch, call, graph=True)]
                if name == "_clock":
                    clock.zero_()
                    call()
                    torch.cuda.synchronize()
                    out["parent_clock_summary"] = clock_summary(
                        clock, 132 * 32)
            except RuntimeError as e:
                out[f"parent{name}"] = [False, str(e)]
        t = {n: out.get(f"parent{n}", [None, None])[1] for n, _ in CUTS}
        if None not in (t[""], t["_cut1"], t["_cut2"], t["_cut3"]):
            out["parent_split"] = {
                "stores": t["_cut1"], "map_loads": t["_cut2"] - t["_cut1"],
                "data_gathers": t["_cut3"] - t["_cut2"],
                "line_rewrite": t[""] - t["_cut3"]}

        lib = built["designs"][0]
        if lib is not None:
            fn = _entry(lib, "k15_variant", K15_ARGS)
            fn3 = _entry(lib, "k15_v3_variant", K15_V3_ARGS)
            fn6 = _entry(lib, "k15_v6_variant", K15_V3_ARGS)
            dmap3 = torch.from_numpy(DA.packed_map(ma3)).to(dev)
            dmap = torch.from_numpy(gm["map"]).to(dev)
            vmap = torch.from_numpy(value_map(ma3)).to(dev)
            for design, (what, f32) in K15_DESIGNS.items():
                outs = [torch.empty(w.shape, dtype=torch.float32 if f32
                                    else torch.int8, device=dev)
                        for w in want[:3]]
                new = [torch.empty_like(x) if i < nd else x
                       for i, x in enumerate(state)]

                def call(design=design, outs=outs, new=new, ck=None):
                    if design in K15_V6:
                        head = (fn6, design, codes.data_ptr(),
                                pids.data_ptr(), dmap.data_ptr(),
                                dmap3.data_ptr())
                    elif design in K15_V3:
                        head = (fn3, design, codes.data_ptr(),
                                pids.data_ptr(), vmap.data_ptr(),
                                dmap.data_ptr())
                    else:
                        head = (fn, design, codes.data_ptr(),
                                pids.data_ptr(), dmap.data_ptr())
                    _checked(*head,
                             *(x.data_ptr() for x in state),
                             *(o.data_ptr() for o in outs),
                             *(x.data_ptr() if i < nd else None
                               for i, x in enumerate(new)),
                             s, nf, gm["m1"], gm["m3"], gm["mp"], nd, ck,
                             stream())
                try:
                    call()
                    torch.cuda.synchronize()
                    out[f"design{design}"] = [
                        what, None if design in K15_PARTIAL
                        else same(outs + new, f32),
                        time_ms(torch, call, graph=True)]
                    if design in K15_CLOCKED:
                        clock.zero_()
                        call(ck=clock.data_ptr())
                        torch.cuda.synchronize()
                        out[f"design{design}_clock"] = stage_summary(
                            clock, clock.numel() // 3)
                except RuntimeError as e:
                    out[f"design{design}"] = [what, False, str(e)]

    # --- K11 ---
    for fl in (MP3_FL, MP2_FL) if "k11" in parts else ():
        mode = "mp3" if fl == MP3_FL else "mp2"
        out = res[f"k11_{mode}"] = {}
        read_idx, n, calls = IL.p3_iv_tables(fl)
        llr = torch.randint(-127, 128, (s, 2 * N_PAIRS, fl), generator=g,
                            dtype=torch.int8).to(dev)
        internal = torch.randint(-127, 128, (s, n), generator=g,
                                 dtype=torch.int8).to(dev)
        phase = torch.randint(0, calls, (s,), generator=g,
                              dtype=torch.int32).to(dev)
        args = (llr, internal, phase)
        want = DF.px_deinterleave_plain(*args)

        def same(got, f32=False):
            ref = [want[0].float() if f32 else want[0], *want[1:]]
            return all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(got, ref))

        out["port"] = [same(DF.px_deinterleave(*args)),
                       time_ms(torch, lambda: DF.px_deinterleave(*args),
                               graph=True)]
        out["plain_ms"] = time_ms(torch, lambda: DF.px_deinterleave_plain(
            *args), reps=3, inner=2, graph=True)
        src, idx = px_take_operands(torch, *args)
        out["library_take"] = [
            torch.equal(torch.take(src, idx).view(want[0].shape), want[0]),
            time_ms(torch, lambda: torch.take(src, idx), graph=True)]

        ri = torch.from_numpy(read_idx).to(dev)
        hz = torch.from_numpy(IL.p3_iv_hazard(fl).astype(np.uint8)).to(dev)
        k7 = torch.from_numpy(DF.channel_tables(f"px{fl}")["k7_map"]).to(dev)
        p_ext = torch.empty(want[0].shape, dtype=torch.float32, device=dev)
        p_int = torch.empty_like(internal)
        p_ph = torch.empty_like(phase)

        def parent_call(fn, clock_ptr=None):
            def call():
                _checked(fn, llr.data_ptr(), internal.data_ptr(),
                         phase.data_ptr(), ri.data_ptr(), hz.data_ptr(),
                         k7.data_ptr(), p_ext.data_ptr(), p_int.data_ptr(),
                         p_ph.data_ptr(), s, N_PAIRS, fl, n, calls,
                         k7.numel(), clock_ptr, stream())
            return call

        for name, _ in CUTS:
            lib = built[f"k11_parent{name}"][0]
            if lib is None:
                continue
            fn = _entry(lib, "px_deinterleave_parent", K11_PARENT_ARGS)
            try:
                call = parent_call(fn, clock.data_ptr() if name else None)
                call()
                torch.cuda.synchronize()
                exact = same((p_ext, p_int, p_ph), True) if name == "" \
                    else None
                out[f"parent{name}"] = [exact,
                                        time_ms(torch, call, graph=True)]
                if name == "_clock":
                    clock.zero_()
                    call()
                    torch.cuda.synchronize()
                    out["parent_clock_summary"] = clock_summary(
                        clock, 132 * 32)
            except RuntimeError as e:
                out[f"parent{name}"] = [False, str(e)]
        t = {nm: out.get(f"parent{nm}", [None, None])[1] for nm, _ in CUTS}
        if None not in (t[""], t["_cut1"], t["_cut2"], t["_cut3"]):
            out["parent_split"] = {
                "stores": t["_cut1"], "map_loads": t["_cut2"] - t["_cut1"],
                "data_gathers": t["_cut3"] - t["_cut2"],
                "state_rewrite": t[""] - t["_cut3"]}

        lib = built["designs"][0]
        if lib is not None:
            fn = _entry(lib, "k11_variant", K11_ARGS)
            fn6 = _entry(lib, "k11_v6_variant", (I,) + (P,) * 8 + (I,) * 5
                         + (P, P))
            table1 = torch.from_numpy(full_table(fl)).to(dev)
            gtables = {k: torch.from_numpy(group_tables(fl, k)).to(dev)
                       for k in set(K11_GROUP.values())}
            gtables3 = {k: torch.from_numpy(DF.pack3(t.cpu().numpy())).to(dev)
                        for k, t in gtables.items()}
            fn10 = _entry(lib, "k11_v10_variant", K11_ARGS)
            stables3 = {k: torch.from_numpy(DF.pack3(step_tables(fl, k)))
                        .to(dev) for k in set(K11_GROUP.values())}
            fn8 = _entry(lib, "k11_v8_variant", (I,) + (P,) * 5 + (I,)
                         + (P,) * 3 + (I,) * 5 + (P, P))
            stabs = {}
            for k in (1, 2):
                srt, sts = sorted_tables(fl, k)
                stabs[k] = (torch.from_numpy(srt.view(np.int32)).to(dev),
                            torch.from_numpy(sts).to(dev), srt.shape[-1])
            for design, (what, f32) in K11_DESIGNS.items():
                table = gtables[K11_GROUP[design]] if design in K11_GROUP \
                    else table1
                ext = torch.empty(want[0].shape, dtype=torch.float32 if f32
                                  else torch.int8, device=dev)
                f32 = bool(f32) if f32 is not None else None
                new_int = torch.empty_like(internal)
                new_ph = torch.empty_like(phase)

                table3 = gtables3[K11_GROUP[design]] \
                    if design in K11_GROUP else None

                def call(design=design, ext=ext, new_int=new_int,
                         new_ph=new_ph, table=table, table3=table3, ck=None):
                    if design in K11_V8:
                        srt, sts, nv = stabs[K11_GROUP[design]]
                        head = (fn8, design, llr.data_ptr(),
                                internal.data_ptr(), phase.data_ptr(),
                                srt.data_ptr(), sts.data_ptr(), nv)
                    elif design in K11_V10:
                        head = (fn10, design, llr.data_ptr(),
                                internal.data_ptr(), phase.data_ptr(),
                                stables3[K11_GROUP[design]].data_ptr())
                    elif design in K11_V6:
                        head = (fn6, design, llr.data_ptr(),
                                internal.data_ptr(), phase.data_ptr(),
                                table.data_ptr(), table3.data_ptr())
                    else:
                        head = (fn, design, llr.data_ptr(),
                                internal.data_ptr(), phase.data_ptr(),
                                table.data_ptr())
                    _checked(*head,
                             ext.data_ptr(), new_int.data_ptr(),
                             new_ph.data_ptr(), s, N_PAIRS, 2 * fl, calls,
                             table.shape[-1], ck, stream())
                try:
                    call()
                    torch.cuda.synchronize()
                    out[f"design{design}"] = [
                        what, None if f32 is None
                        else same((ext, new_int, new_ph), f32),
                        time_ms(torch, call, graph=True)]
                    if design in K11_CLOCKED:
                        clock.zero_()
                        call(ck=clock.data_ptr())
                        torch.cuda.synchronize()
                        out[f"design{design}_clock"] = stage_summary(
                            clock, clock.numel() // 3)
                except RuntimeError as e:
                    out[f"design{design}"] = [what, False, str(e)]
    # --- staging alone: 147456 bytes a CTA in 1-64 bulk copies, from 16
    # source blocks (an MP3 state's size each) ---
    lib = built["designs"][0]
    if lib is not None and "stage" in parts:
        bench = _entry(lib, "stage_bench", (P, I, I, I, I, P, P))
        src = torch.randint(0, 255, (132 * 147456,), generator=g,
                            dtype=torch.uint8).to(dev)
        out = res["stage_bench"] = {}
        for bytes_, copies, ctas, blocks in (
                (147456, 16, 132, 16), (147456, 16, 132, 132),
                (147456, 16, 66, 66), (147456, 1, 132, 132),
                (73728, 8, 264, 264), (165888, 4, 128, 117),
                (165888, -4, 128, 117), (82944, -4, 128, 128),
                (82944, 4, 256, 128)):
            def call(ck=None, bytes_=bytes_, copies=copies, ctas=ctas,
                     blocks=blocks):
                _checked(bench, src.data_ptr(), bytes_, copies, blocks,
                         ctas, ck, stream())
            try:
                call()
                torch.cuda.synchronize()
                ms = time_ms(torch, call, graph=True)
                clock.zero_()
                call(ck=clock.data_ptr())
                torch.cuda.synchronize()
                out[f"{bytes_}B_{copies}copies_{ctas}ctas_{blocks}src"] = [
                    ms, stage_summary(clock, ctas)]
            except RuntimeError as e:
                out[f"{bytes_}B_{copies}copies_{ctas}ctas_{blocks}src"] = \
                    str(e)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
