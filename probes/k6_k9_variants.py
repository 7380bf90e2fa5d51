"""Time the designs tried for K6's P1 gather and for K9 against the kernels
the port runs, on one CUDA card, and hold each against the plain version.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/k6_k9_variants.py

The variants' sources lie beside this script and are built here, one
``nvcc`` each, all started together, into ``build/probes/`` (gitignored):

* ``fec_gather_cluster.cu`` at clusters of 2, 4 and 8 CTAs a frame: each
  output byte read from the owning CTA's shared memory by distributed
  shared memory;
* ``fec_gather_exchange.cu`` at clusters of 8 and 16: the CTAs exchange
  the soft bits each one's outputs read in 16-byte packets, then write
  from what they received (its tables: :func:`exchange_tables`);
* ``coarse_timing_cluster.cu``: K9 in one launch, a cluster of 8 CTAs a
  station.

The port's kernels (``csrc/fec_gather.cu``, ``csrc/coarse_timing.cu``) are
timed on the same inputs as a whole call and, from the profiler, kernel by
kernel; K6's line also times its library yardstick, one
``torch.index_select`` over each frame's zero-padded pm.  Inputs: 16
stations' strided pm of 34 blocks (2 lead blocks, then 2 P1 frames) of
random soft bits, and 16 stations' random 80000-sample windows, from a
fixed seed.  Times: device ms a call, CUDA events around a CUDA graph of 10
calls, median of 7 (``chip_smoke.time_ms``).

Prints the card's name and power limit, one line a variant's build, and
one JSON object: for each variant and kernel ``[equal to the plain
version, ms]``.
"""

from __future__ import annotations

import ctypes
import functools
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
# variant name -> (source, extra nvcc flags, entry point, its argtypes)
K6_CLUSTER_ARGS = (P, P, P, I, I, L, L, I, P)
K6_EXCHANGE_ARGS = (P, P, P, P, I, I, L, L, I, I, I, I, P)
K9_CLUSTER_ARGS = (P, L, P, P, I, P, P, I, P)
VARIANTS = {
    **{f"k6_cluster{n}": ("fec_gather_cluster", [f"-DCLUSTER={n}"],
                          "fec_gather_cluster", K6_CLUSTER_ARGS)
       for n in (2, 4, 8)},
    **{f"k6_exchange{n}": ("fec_gather_exchange", [f"-DK6_CLUSTER={n}"],
                           "fec_gather_exchange", K6_EXCHANGE_ARGS)
       for n in (8, 16)},
    "k9_cluster": ("coarse_timing_cluster", [], "coarse_timing_cluster",
                   K9_CLUSTER_ARGS),
}
TILE = 512       # soft bits a warp sends at once: 16 a lane
META = 40        # int32 words of a CTA's row of the exchange plan
META_PREFIX = 2  # its part's start in the send map, its tile count
PERM_LEAD = 16   # zero-slot entries ahead of perm


def _pad(n: int, unit: int) -> int:
    return -(-n // unit) * unit


@functools.lru_cache(maxsize=4)
def exchange_tables(cl: int) -> dict:
    """The exchange variant's tables at a cluster of ``cl`` CTAs a frame.

    CTA c holds soft bits [c S, (c + 1) S) of the frame (S = 368640 / cl)
    and writes outputs [bounds[c], bounds[c + 1]) (multiples of 16).
    ``lists[c][d]``: the sorted offsets in slice c of the soft bits CTA d's
    outputs read, each once, padded with 0 to whole tiles of 512; ``send``
    (uint16) holds the lists in turn, each tile's entries l + 32 e (e < 16)
    at 16 l + e; list [c][d] lands in d's receive buffer at ``recv_base[c,
    d]``; ``perm`` (uint16) is each output's byte in its CTA's receive
    buffer, the largest buffer's size (a zero byte) where punctured;
    ``meta`` [cl, META] a CTA's row: its part's start in ``send``, its tile
    count, where each destination's tiles start (cl + 1), ``recv_base[c]``
    (cl) and its two bounds.  Returns ``map`` (perm as the kernel reads it),
    ``aux`` (meta, then send, as int32 words) and ``recv_bytes``."""
    from nrsc5_tpu_torch.ops import decode_fm as DF
    k7 = DF.channel_tables("p1")["k7_map"].astype(np.int64)
    slice_len, n = DF.PM_FRAME // cl, k7.size
    meta_recv = META_PREFIX + cl + 1
    meta_bounds = meta_recv + cl
    bounds = np.minimum(16 * (_pad(n, 16) // 16 * np.arange(cl + 1) // cl),
                        n)
    perm = np.full(n, -1, np.int64)
    lists = [[None] * cl for _ in range(cl)]
    recv_base = np.zeros((cl, cl), np.int64)
    recv = np.zeros(cl, np.int64)
    for d in range(cl):
        m = np.arange(bounds[d], bounds[d + 1])
        src = k7[m]
        for c in range(cl):
            sel = (src >= 0) & (src // slice_len == c)
            u, k = np.unique(src[sel] % slice_len, return_inverse=True)
            lists[c][d] = np.pad(u, (0, _pad(u.size, TILE) - u.size))
            recv_base[c, d] = recv[d]
            # entry k: tile k // 512, lane k % 32, byte k % 512 // 32
            perm[m[sel]] = recv[d] + k // TILE * TILE + k % 32 * 16 \
                + k % TILE // 32
            recv[d] += lists[c][d].size
    if recv.max() >= 0xFFFF:
        raise ValueError("a receive buffer outgrows uint16 positions")
    zero = int(recv.max())
    perm[perm < 0] = zero
    meta = np.zeros((cl, META), np.int64)
    start = 0
    for c in range(cl):
        tiles = np.cumsum([0] + [lists[c][d].size // TILE
                                 for d in range(cl)])
        meta[c, :2] = start, tiles[-1]
        meta[c, META_PREFIX:META_PREFIX + cl + 1] = tiles
        meta[c, meta_recv:meta_recv + cl] = recv_base[c]
        meta[c, meta_bounds:meta_bounds + 2] = bounds[c], bounds[c + 1]
        start += tiles[-1] * TILE
    send = np.concatenate([x for row in lists for x in row])
    send = send.reshape(-1, 16, 32).transpose(0, 2, 1).reshape(-1)
    send = send.astype(np.uint16)
    if send.size % 2:
        send = np.append(send, np.uint16(0))
    aux = np.concatenate([meta.astype(np.int32).reshape(-1),
                          send.view(np.int32)])
    perm = np.concatenate([np.full(PERM_LEAD, zero), perm,
                           np.full(_pad(n, 16) - n + 2 * TILE, zero)])
    return {"map": perm.astype(np.uint16), "aux": aux,
            "recv_bytes": zero}


def build_variants() -> dict:
    """Compile every variant, one ``nvcc`` each, all started together.
    Returns ``{name: (library path or None, ptxas lines)}``."""
    from nrsc5_tpu_torch import kernels as K
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags, _, _) in VARIANTS.items():
        lib = OUT / f"{name}.so"
        cmd = [K._nvcc(), *K.NVCC_FLAGS, *flags, "-o", str(lib),
               str(HERE / f"{src}.cu")]
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import kernel_spans, time_ms
    from nrsc5_tpu_torch import kernels as K
    from nrsc5_tpu_torch.ops import acquire_rc as AQ
    from nrsc5_tpu_torch.ops import decode_fm as DF

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    built = build_variants()
    K.build(["fec_gather", "coarse_timing"])
    for name, (lib, log) in built.items():
        print(name, "built" if lib else "FAILED", log, flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    res = {}

    # --- K6, P1: 16 stations x 2 frames read in place from the chain's
    # strided pm (2 lead blocks, then the frames) ---
    gen = torch.Generator().manual_seed(1)
    pm = torch.randint(-127, 128, (16, 34, DF.PM_FRAME // 16),
                       generator=gen, dtype=torch.int8).to(dev)
    frames = pm[:, 2:].reshape(16, 2, -1)
    g, f = frames.shape[:2]
    want = DF.fec_gather_plain(frames, "p1")
    tb = DF.channel_tables("p1")
    map_len = tb["k7_map"].size
    res["k6_port"] = [bool(torch.equal(DF.fec_gather(frames, "p1"), want)),
                      time_ms(torch, lambda: DF.fec_gather(frames, "p1"),
                              graph=True)]
    res["k6_port_kernels"] = kernel_spans(
        torch, lambda: DF.fec_gather(frames, "p1"))
    n_fr = g * f
    pmz = torch.cat([frames.reshape(n_fr, -1), frames.new_zeros(n_fr, 1)],
                    dim=1)
    k7 = torch.from_numpy(np.where(tb["k7_map"] >= 0, tb["k7_map"],
                                   DF.PM_FRAME)).long().to(dev)
    res["k6_index_select"] = [
        bool(torch.equal(torch.index_select(pmz, 1, k7).view(-1),
                         want.view(-1))),
        time_ms(torch, lambda: torch.index_select(pmz, 1, k7), graph=True)]
    k7_map = torch.from_numpy(tb["k7_map"]).to(dev)
    for name, (lib, _) in built.items():
        if lib is None or not name.startswith("k6_"):
            continue
        fn = _entry(lib, name)
        out = torch.empty_like(want)
        if name.startswith("k6_cluster"):
            def call(fn=fn, out=out):
                err = fn(frames.data_ptr(), k7_map.data_ptr(),
                         out.data_ptr(), g, f, frames.stride(0),
                         frames.stride(1), map_len, stream())
                if err:
                    raise RuntimeError(f"cudaError {err}")
        else:
            et = exchange_tables(int(name.removeprefix("k6_exchange")))
            emap = torch.from_numpy(et["map"].view(np.int16)).to(dev)
            aux = torch.from_numpy(et["aux"]).to(dev)

            def call(fn=fn, out=out, emap=emap, aux=aux, et=et):
                err = fn(frames.data_ptr(), emap.data_ptr(), aux.data_ptr(),
                         out.data_ptr(), g, f, frames.stride(0),
                         frames.stride(1), DF.PM_FRAME, map_len,
                         aux.numel(), et["recv_bytes"], stream())
                if err:
                    raise RuntimeError(f"cudaError {err}")
        try:
            out.zero_()
            call()
            torch.cuda.synchronize()
            res[name] = [bool(torch.equal(out, want)),
                         time_ms(torch, call, graph=True)]
        except RuntimeError as e:
            res[name] = [False, str(e)]

    # --- K9: 16 stations' windows ---
    x = torch.randn(16, 80000, 2, generator=gen).to(dev)
    ps, pv = AQ.coarse_timing_rc_plain(x)

    def same(se, mv):
        return bool(torch.equal(se, ps) and torch.equal(
            mv.view(torch.int32), pv.view(torch.int32)))

    res["k9_port"] = [same(*AQ.coarse_timing_rc(x)),
                      time_ms(torch, lambda: AQ.coarse_timing_rc(x),
                              graph=True)]
    res["k9_port_kernels"] = kernel_spans(
        torch, lambda: AQ.coarse_timing_rc(x))
    lib = built["k9_cluster"][0]
    if lib is not None:
        fn = _entry(lib, "k9_cluster")
        taps, kern = AQ._k9_tables()
        se = torch.empty(16, dtype=torch.int32, device=dev)
        mv = torch.empty(16, 2, device=dev)

        def call_k9():
            err = fn(x.data_ptr(), x.shape[1], taps.ctypes.data,
                     kern.ctypes.data, AQ.C.ACQ_FILTER_DELAY, se.data_ptr(),
                     mv.data_ptr(), 16, stream())
            if err:
                raise RuntimeError(f"cudaError {err}")
        try:
            call_k9()
            torch.cuda.synchronize()
            res["k9_cluster"] = [same(se, mv),
                                 time_ms(torch, call_k9, graph=True)]
        except RuntimeError as e:
            res["k9_cluster"] = [False, str(e)]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
