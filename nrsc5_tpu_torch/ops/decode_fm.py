"""FM logical-channel decode: deinterleave -> depuncture -> Viterbi ->
re-encode, descramble, pack (reference: src/decode.c:344-472).

PyTorch counterpart of ``nrsc5_tpu/ops/decode_fm.py``: ``p1_decode``
(chunked), ``pids_decode``, ``px_iv_call`` + ``nrsc5_tpu/pipeline/
scan_chain.py:px_scan_pairs`` (:func:`px_deinterleave`), ``px_fec`` and
``px_decode``, batched over leading axes.  Each channel decodes in three
kernels:

  * K6 (:func:`fec_gather`, ``csrc/fec_gather.cu``) for P1 and PIDS: the
    int8 gather through the interleaver table, the depuncture, and the P1
    chunk-segment plan or the PIDS wrap extension, composed into one
    static index map per channel, written straight into K7's input as
    int8 (K7's int8 load path reads it);
  * K11 (:func:`px_deinterleave`, ``csrc/px_deinterleave.cu``) for PX: the
    interleaver-IV deinterleave through the carried state, for every block
    pair of a dispatch at once, the P3/P4 depuncture and the wrap
    extension;
  * K7 (:func:`nrsc5_tpu_torch.ops.convolutional.acs_traceback`), then K8
    (:func:`fec_epilogue`, ``csrc/fec_epilogue.cu``): the kept bits, the
    re-encode bit errors (P1), the descramble and the pack.

Each kernel has a plain PyTorch version here, the literal sequence of
gathers and loops it replaces; a CPU tensor takes it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.bits import pack_bits
from nrsc5_tpu_torch.ops.convolutional import (CHUNK, OVERLAP,
                                               TAIL_BITING_EXTRA, _acs,
                                               _chunk_plan, depuncture,
                                               reencode_bit_errors)
from nrsc5_tpu_torch.ops.scramble import scrambler_keystream

WRAP = TAIL_BITING_EXTRA
PM_FRAME = C.P1_FM_BLOCKS * C.PM_BLOCK_SIZE  # soft bits of one P1 frame
# channel name -> builder of the K8 tables (``t``, ``steps``, ``n_seg``,
# ``keep``, ``keystream``) of a channel another module decodes through K8;
# :mod:`nrsc5_tpu_torch.ops.decode_am` registers the AM channels
CHANNELS: dict = {}


# ---------------------------------------------------------------------------
# static tables of each channel
# ---------------------------------------------------------------------------

def _depunctured_index(t: int, pattern: tuple[int, ...]) -> np.ndarray:
    """int64 [t*3]: for each mother-code position (bit, output) of a frame,
    its index in the punctured stream, or -1 where it is punctured (what
    :func:`depuncture` fills with 0)."""
    period, kept = len(pattern), int(sum(pattern))
    c = np.arange(t * 3, dtype=np.int64)
    col = c % period
    rank = np.cumsum(pattern) - 1
    pat = np.asarray(pattern, bool)
    return np.where(pat[col], (c // period) * kept + rank[col], -1)


@functools.lru_cache(maxsize=16)
def channel_tables(name: str) -> dict:
    """The static tables of channel ``name`` ("p1", "pids", "px2304",
    "px4608", or one of :data:`CHANNELS`, which hold K8's keys only),
    numpy:

    * ``t``: frame bits; ``steps``, ``n_seg``: K7's segments per frame and
      steps per segment;
    * ``keep`` int32 [t]: frame bit -> index in the frame's K7 bits
      (``n_seg * steps`` of them);
    * ``code_map`` int32 [t*3]: mother-code position -> source soft bit
      (in the frame's PM rows for P1/PIDS, in the call's 2t LLRs for PX),
      -1 where punctured;
    * ``k7_map`` int32 [n_seg*steps*3]: K7 input element -> source soft
      bit or -1 (K6's and K11's index map);
    * ``keystream`` uint8 [t]."""
    if name in CHANNELS:
        return CHANNELS[name]()
    if name == "p1":
        t, table = C.P1_FRAME_LEN_FM, IL.p1_fm_table()
        pattern = C.PUNCTURE_P1_PIDS_FM
    elif name == "pids":
        t, table = C.PIDS_FRAME_LEN, IL.pids_fm_table()
        pattern = C.PUNCTURE_P1_PIDS_FM
    elif name.startswith("px"):
        t, table = int(name[2:]), None
        pattern = C.PUNCTURE_P3_P4_FM
    else:
        raise ValueError(f"unknown channel {name}")
    code = _depunctured_index(t, pattern)
    if table is not None:
        code = np.where(code >= 0, table[np.maximum(code, 0)], -1)
    code = code.reshape(t, 3)
    if name == "p1":
        seg_idx, src_chunk, src_off = _chunk_plan(t, CHUNK, OVERLAP)
        n_seg, steps = seg_idx.shape
        k7 = code[seg_idx]  # [n_seg, steps, 3]
        keep = src_chunk.astype(np.int64) * steps + src_off
    else:
        n_seg, steps = 1, t + 2 * WRAP
        k7 = code[(np.arange(steps) - WRAP) % t]
        keep = np.arange(t) + WRAP
    return {"t": t, "steps": steps, "n_seg": n_seg, "pattern": pattern,
            "keep": keep.astype(np.int32),
            "code_map": code.reshape(-1).astype(np.int32),
            "k7_map": k7.reshape(-1).astype(np.int32),
            "keystream": scrambler_keystream(t).copy()}


# K6's P1 tables (csrc/fec_gather.cu): rows of a block, soft bits a row,
# punctured positions a group of the P1 interleaver, groups a row at most
K6_ROWS, K6_ROW_BYTES, K6_GROUP, K6_MAX_K = 32, 720, 320, 36
K6_SCRATCH_PAD = 512  # bytes past the scratch's frames a tile may read


@functools.lru_cache(maxsize=4)
def gather_tables(name: str) -> dict:
    """K6's tables of channel ``name``, numpy.

    P1: the interleaver table's structure and the segments' arithmetic,
    checked here to reproduce ``p1_fm_table`` and ``k7_map`` exactly.
    Punctured position i = 320 k + q of a frame reads soft bit
    ``(beta(q) * 32 + row(k)) * 720 + V[q % 20] * 36 + col(k)`` (interleaver
    I of the 1012s, section 10.3.3), so pass 1 of the kernel (a CTA a row)
    writes the frame's deinterleaved stream d[i] from the row of every
    block, and pass 2 writes output m = (segment s, step, j) as 0 or d at
    ``5 * (c // 6) + rank[c % 6]``, c = 3 ((start[s] + step) mod t) + j:

    * ``row_k`` int32 [32, 36]: the groups k of row r as ``k | col(k) <<
      16``, then -1;
    * ``qoff`` int32 [320]: ``beta(q) * 720 + V[q % 20] * 36``, q's soft
      bit in a row's 16 runs of 720 bytes (block b at 720 b), less col(k);
    * ``start`` int32 [n_seg]: each segment's first frame bit;
    * ``rank`` int32 [6]: a pattern position's rank among the kept ones,
      -1 where punctured;
    * ``aux``: the four, in that order, as the kernel reads them.

    PIDS (a warp a block): ``src`` int32 [n_src], the sorted soft bits the
    channel reads (at most 255), and ``idx`` uint8 [map_len], the position
    of ``k7_map[e]`` in ``src``, 255 at a punctured site."""
    tb = channel_tables(name)
    k7 = tb["k7_map"].astype(np.int64)
    if name != "p1":
        src = np.unique(k7[k7 >= 0])
        if src.size > 255:
            raise ValueError(f"{name} reads {src.size} soft bits a frame; "
                             "a warp a frame takes at most 255")
        idx = np.where(k7 >= 0, np.searchsorted(src, k7), 255)
        return {"src": src.astype(np.int32), "idx": idx.astype(np.uint8)}
    n = C.P1_FRAME_LEN_ENCODED_FM
    i = np.arange(n)
    k, q = i // K6_GROUP, i % K6_GROUP
    v = np.asarray(C.PM_V, np.int64)
    beta = (q // 20 + 7 * v[q % 20]) % C.P1_FM_BLOCKS
    row, col = (11 * k) % K6_ROWS, (11 * k + k // 288) % 36
    qoff = beta * K6_ROW_BYTES + v[q % 20] * 36  # in the row's slab
    if not np.array_equal(beta * C.PM_BLOCK_SIZE + row * K6_ROW_BYTES
                          + v[q % 20] * 36 + col, IL.p1_fm_table()):
        raise ValueError("the P1 table has not the structure K6 takes")
    n_k = n // K6_GROUP
    row_k = np.full((K6_ROWS, K6_MAX_K), -1, np.int64)
    for r in range(K6_ROWS):
        ks = np.flatnonzero(row[::K6_GROUP] == r)
        if ks.size > K6_MAX_K:
            raise ValueError(f"row {r} holds {ks.size} groups")
        row_k[r, :ks.size] = ks | col[ks * K6_GROUP] << 16
    assert n_k * K6_GROUP == n
    t, steps, pattern = tb["t"], tb["steps"], tb["pattern"]
    seg_idx = _chunk_plan(t, CHUNK, OVERLAP)[0]
    start = seg_idx[:, 0].astype(np.int64)
    rank = np.where(np.asarray(pattern, bool), np.cumsum(pattern) - 1, -1)
    # the segments' arithmetic against k7_map
    site = (start[:, None] + np.arange(steps)[None, :]) % t
    c = (3 * site[..., None] + np.arange(3)).reshape(-1)
    pos = (c // len(pattern)) * int(sum(pattern)) + rank[c % len(pattern)]
    via = np.where(rank[c % len(pattern)] >= 0,
                   IL.p1_fm_table()[np.maximum(pos, 0)], -1)
    if not np.array_equal(via, k7):
        raise ValueError("the P1 segments have not the arithmetic K6 takes")
    out = {"row_k": row_k, "qoff": qoff[:K6_GROUP], "start": start,
           "rank": rank}
    out["aux"] = np.concatenate([out[key].reshape(-1) for key in
                                 ("row_k", "start", "qoff", "rank")]
                                ).astype(np.int32)
    return out


@functools.lru_cache(maxsize=8)
def _gather_device_tables(name: str, device: str) -> dict:
    """K6's tables on ``device``: P1 ``aux``; PIDS ``map`` (idx) and
    ``aux`` (src)."""
    gt = gather_tables(name)
    if name == "p1":
        return {"aux": torch.from_numpy(gt["aux"]).to(device)}
    return {"map": torch.from_numpy(gt["idx"]).to(device),
            "aux": torch.from_numpy(gt["src"]).to(device)}


@functools.lru_cache(maxsize=16)
def _device_tables(name: str, device: str) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in channel_tables(name).items()
            if isinstance(v, np.ndarray)}


@functools.lru_cache(maxsize=8)
def _plain_indices(name: str, device: str) -> tuple:
    """The plain versions' gathers of P1 or PIDS on ``device``: the
    interleaver table and, for P1, the chunk segments' frame positions.
    Cached, so that a plain version makes no host copy (and can run inside
    a CUDA graph)."""
    if name == "p1":
        table = IL.p1_fm_table()
        seg_idx = _chunk_plan(C.P1_FRAME_LEN_FM, CHUNK, OVERLAP)[0]
    else:
        table, seg_idx = IL.pids_fm_table(), np.zeros(0)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (table, seg_idx))


def _frames3(pm: torch.Tensor, frame: int) -> torch.Tensor:
    """[B, frame] or [G, F, frame] int8 soft bits (last axis dense) ->
    [G, F, frame]."""
    if pm.ndim == 2:
        pm = pm[None]
    if pm.ndim != 3 or pm.shape[-1] != frame or pm.stride(-1) != 1:
        raise ValueError(f"pm: expected [B, {frame}] or [G, F, {frame}] "
                         f"with a dense last axis, got {tuple(pm.shape)} "
                         f"strides {pm.stride()}")
    return pm


# ---------------------------------------------------------------------------
# K6: gather + depuncture into K7's input (P1, PIDS)
# ---------------------------------------------------------------------------

def fec_gather_plain(pm: torch.Tensor, name: str) -> torch.Tensor:
    """Plain version of K6: the int8 gather through the interleaver table,
    the depuncture, then the P1 chunk segments or the PIDS wrap extension.
    pm: [G, F, frame] int8 (one frame of soft bits per row).  Returns K7's
    input int8 [G*F*n_seg, steps, 3]: soft bits, 0 at punctured sites."""
    tb = channel_tables(name)
    t = tb["t"]
    table, seg_idx = _plain_indices(name, str(pm.device))
    llr = pm.reshape(-1, pm.shape[-1])[:, table]
    full = depuncture(llr, tb["pattern"], t * 3).reshape(-1, t, 3)
    if name == "p1":
        return full[:, seg_idx].reshape(-1, tb["steps"], 3).contiguous()
    return torch.cat([full[:, t - WRAP:], full, full[:, :WRAP]],
                     dim=1).contiguous()


def fec_gather(pm: torch.Tensor, name: str) -> torch.Tensor:
    """K6: the arguments and result of :func:`fec_gather_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, which writes ``pm[k7_map[e]]`` or 0 for every element of K7's
    input: for P1 in two passes (two kernels, two counts) through a
    scratch of each frame's deinterleaved soft bits
    (:func:`gather_tables`), for PIDS a warp a block over the soft bits it
    reads."""
    if pm.device.type == "cpu":
        return fec_gather_plain(pm, name)
    if pm.device.type != "cuda" or pm.dtype != torch.int8:
        raise ValueError(f"pm: expected a CUDA int8 tensor, got {pm.dtype} "
                         f"on {pm.device}")
    frame = PM_FRAME if name == "p1" else C.PM_BLOCK_SIZE
    pm = _frames3(pm, frame)
    g, f, _ = pm.shape
    tb = channel_tables(name)
    dt = _gather_device_tables(name, str(pm.device))
    out = torch.empty(g * f * tb["n_seg"], tb["steps"], 3,
                      dtype=torch.int8, device=pm.device)
    # P1: each frame's deinterleaved soft bits, and K6_SCRATCH_PAD more
    scratch = torch.empty(g * f * C.P1_FRAME_LEN_ENCODED_FM + K6_SCRATCH_PAD,
                          dtype=torch.int8, device=pm.device) \
        if name == "p1" else None
    K.launch("fec_gather", pm.data_ptr(),
             dt["map"].data_ptr() if "map" in dt else None,
             dt["aux"].data_ptr(), out.data_ptr(), g, f, pm.stride(0),
             pm.stride(1), frame, tb["k7_map"].size, dt["aux"].numel(),
             None if scratch is None else scratch.data_ptr(),
             device=pm.device, kernels=1 if scratch is None else 2)
    return out


# ---------------------------------------------------------------------------
# K8: kept bits, re-encode bit errors, descramble, pack
# ---------------------------------------------------------------------------

def k8_runs(keep: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``keep`` as runs of consecutive K7 bits: (run_t int32 [n + 1], the
    first frame bit of each run and then t; run_src int32 [n], the K7 bit
    of each run's first bit), so that keep[i] = run_src[r] + i - run_t[r]
    for run_t[r] <= i < run_t[r + 1]."""
    starts = np.flatnonzero(np.diff(keep) != 1) + 1
    run_t = np.concatenate([[0], starts, [keep.size]]).astype(np.int32)
    return run_t, keep[run_t[:-1]].astype(np.int32)


def packed_keystream(keystream: np.ndarray) -> np.ndarray:
    """uint32 [ceil(t / 32)]: bit k of word w = keystream[32 w + k], the
    last word padded with zeros."""
    bits = np.zeros(-(-keystream.size // 32) * 32, np.uint8)
    bits[:keystream.size] = keystream
    return np.packbits(bits, bitorder="little").view("<u4").astype(np.uint32)


def inverse_sites(code_map: np.ndarray, pm_len: int) -> np.ndarray:
    """int32 [pm_len]: the mother-code site 3t + j whose soft bit is pm
    entry e (code_map[3t + j] = e), or -1 for an entry no site reads.
    Raises if a soft bit feeds two sites."""
    sites = np.flatnonzero(code_map >= 0)
    src = code_map[sites]
    if np.unique(src).size != src.size:
        raise ValueError("code_map: a soft bit feeds more than one site")
    inv = np.full(pm_len, -1, np.int32)
    inv[src] = sites
    return inv


@functools.lru_cache(maxsize=16)
def k8_tables(name: str) -> dict:
    """The kernel's tables of channel ``name``, numpy: ``run_t`` and
    ``run_src`` (:func:`k8_runs` of keep), ``ks_words``
    (:func:`packed_keystream`) and, for P1, ``inv`` (:func:`inverse_sites`
    over a frame's soft bits)."""
    tb = channel_tables(name)
    run_t, run_src = k8_runs(tb["keep"])
    out = {"run_t": run_t, "run_src": run_src,
           "ks_words": packed_keystream(tb["keystream"])}
    if name == "p1":
        out["inv"] = inverse_sites(tb["code_map"], PM_FRAME)
    return out


@functools.lru_cache(maxsize=16)
def _k8_device_tables(name: str, device: str) -> dict:
    return {k: torch.from_numpy(v.view(np.int32)).to(device)
            for k, v in k8_tables(name).items()}


def fec_epilogue_plain(bits: torch.Tensor, name: str, pm=None,
                       packed: bool = False):
    """Plain version of K8.  bits: K7's bits uint8 [B*n_seg, steps];
    ``pm`` [G, F, frame] int8 with G*F = B, for P1 only: the soft bits the
    re-encode is held against.  Returns (frame bits uint8 [B, t], or
    [B, t/8] packed little-endian; re-encode bit errors int32 [B], or None
    without ``pm``)."""
    tb = channel_tables(name)
    dt = _device_tables(name, str(bits.device))
    kept = bits.reshape(-1, tb["n_seg"] * tb["steps"])[:, dt["keep"].long()]
    errors = None
    if pm is not None:
        table, _ = _plain_indices(name, str(pm.device))
        llr = pm.reshape(-1, pm.shape[-1])[:, table].float()
        full = depuncture(llr, tb["pattern"], tb["t"] * 3).reshape(
            -1, tb["t"], 3)
        errors = reencode_bit_errors(full, kept, C.CONV_K7_GEN,
                                     tb["pattern"])
    out = kept ^ dt["keystream"]
    return (pack_bits(out) if packed else out), errors


def fec_epilogue(bits: torch.Tensor, name: str, pm=None,
                 packed: bool = False):
    """K8: the arguments and results of :func:`fec_epilogue_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel: without ``pm``, a warp for each 256 output bits; with ``pm``
    (P1), a thread-block cluster of 8 CTAs a frame, which gather the kept
    bits into a shared-memory bitmap and count the re-encode errors over
    the inverse site table (:func:`k8_tables`)."""
    if bits.device.type == "cpu":
        return fec_epilogue_plain(bits, name, pm, packed)
    tb = channel_tables(name)
    t, per = tb["t"], tb["n_seg"] * tb["steps"]
    K.check(bits, "bits", torch.uint8)
    if bits.numel() % per or t % 8:
        raise ValueError(f"bits: {tuple(bits.shape)} does not hold whole "
                         f"frames of {per} K7 bits")
    b = bits.numel() // per
    dev = bits.device
    kt = _k8_device_tables(name, str(dev))
    out = torch.empty(b, t // 8 if packed else t, dtype=torch.uint8,
                      device=dev)
    errors = None
    pm_args = (None, None, 0, 1, 0, 0)
    if pm is not None:
        pm = _frames3(pm, PM_FRAME)
        if pm.dtype != torch.int8 or pm.device != dev \
                or pm.shape[0] * pm.shape[1] != b or "inv" not in kt:
            raise ValueError("pm: expected int8 P1 frames on the bits' "
                             f"device, {b} of them")
        errors = torch.empty(b, dtype=torch.int32, device=dev)
        pm_args = (pm.data_ptr(), kt["inv"].data_ptr(), PM_FRAME,
                   pm.shape[1], pm.stride(0), pm.stride(1))
    K.launch("fec_epilogue", bits.data_ptr(), kt["run_t"].data_ptr(),
             kt["run_src"].data_ptr(), kt["run_src"].numel(),
             int(tb["keep"][0]), per, *pm_args, kt["ks_words"].data_ptr(),
             out.data_ptr(), None if errors is None else errors.data_ptr(),
             b, t, int(packed), *C.CONV_K7_GEN, device=dev)
    return out, errors


# ---------------------------------------------------------------------------
# P1 and PIDS
# ---------------------------------------------------------------------------

def p1_decode(pm_frames: torch.Tensor, packed: bool = False,
              plain: bool = False):
    """pm_frames: [B, 368640] or [G, F, 368640] int8 (one P1 frame of soft
    bits per row; a strided view of the chain's pm serves).  Returns (bits
    [B, 146176] uint8, or [B, 18272] packed; the minimum Viterbi margin
    over the frame's chunk segments [B] float32; re-encode bit errors [B]
    int32), B = G*F, through K6 -> K7 -> K8 (``plain``: their plain
    versions)."""
    pm = _frames3(pm_frames, PM_FRAME)
    segs = (fec_gather_plain if plain else fec_gather)(pm, "p1")
    bits, margins = _acs(segs, C.CONV_K7_GEN, plain)
    out, errors = (fec_epilogue_plain if plain else fec_epilogue)(
        bits, "p1", pm, packed)
    n_seg = channel_tables("p1")["n_seg"]
    return out, margins.reshape(-1, n_seg).amin(dim=-1), errors


def pids_decode(pm_blocks: torch.Tensor, packed: bool = False,
                plain: bool = False):
    """pm_blocks: [B, 23040] or [G, F, 23040] int8 (one L1 block per row).
    Returns bits [B, 80] uint8 (or [B, 10] packed), B = G*F, through K6 ->
    K7 -> K8."""
    pm = _frames3(pm_blocks, C.PM_BLOCK_SIZE)
    ext = (fec_gather_plain if plain else fec_gather)(pm, "pids")
    bits, _ = _acs(ext, C.CONV_K7_GEN, plain)
    out, _ = (fec_epilogue_plain if plain else fec_epilogue)(
        bits, "pids", packed=packed)
    return out


# ---------------------------------------------------------------------------
# K11: PX interleaver-IV deinterleave with carried state
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _iv_tables(frame_len: int, device: str):
    read_idx, n, calls = IL.p3_iv_tables(frame_len)
    return (torch.from_numpy(read_idx).to(device),
            torch.from_numpy(IL.p3_iv_hazard(frame_len).astype(np.uint8))
            .to(device), n, calls)


@functools.lru_cache(maxsize=4)
def px_tables(frame_len: int) -> np.ndarray:
    """K11's table: int32 [2, calls, 2 * steps], steps = frame_len + 2 *
    WRAP, the trellis steps of a pair's K7 input.  A CTA of the kernel
    (csrc/px_deinterleave.cu) takes pairs p0 and p0 + 1 of a station and
    stages runs of L = 2 * frame_len bytes: region q of the state as pair
    p0 sees it at q * L, then pair p0 + k's own soft bits at (calls + k) *
    L.  Of a step's three K7 inputs the middle one is punctured (0) at
    every step, so the table holds the other two: T[k][ph][2 t + j] is the
    staged byte K7 input 3 t + 2 j of pair p0 + k reads when that pair's
    call phase is ph:

    * T[0] composes the depuncture, the wrap, read_idx and hazard: the
      state index r = read_idx[ph * L + i] of the call position i =
      k7_map[m], or calls * L + r - ph * L where the call reads its own
      fresh soft bit (hazard);
    * T[1] is T[0] with pair p0 + 1's own soft bits at (calls + 1) * L,
      and its region ph - 1 (which pair p0, at that phase, has just
      written) read from pair p0's soft bits at calls * L."""
    read_idx, n, calls = IL.p3_iv_tables(frame_len)
    hazard = IL.p3_iv_hazard(frame_len)
    call_len = n // calls
    k7 = channel_tables(f"px{frame_len}")["k7_map"].astype(np.int64)
    kept = np.arange(k7.size) % 3 != 1
    if not np.array_equal(k7 >= 0, kept):
        raise ValueError("K11 expects each step's middle input punctured, "
                         "and only that one")
    k7 = k7[kept]
    ph = np.arange(calls)[:, None]
    c = ph * call_len + k7[None]
    r = read_idx[c].astype(np.int64)
    fresh = hazard[c]
    if not np.array_equal(r[fresh] // call_len,
                          np.broadcast_to(ph, r.shape)[fresh]):
        raise ValueError("a hazard read must lie in its call's own region")
    t0 = np.where(fresh, calls * call_len + r - ph * call_len, r)
    # pair p0 + 1: region q = ph - 1 is pair p0's soft bits
    q = t0 // call_len
    t1 = np.where(fresh, t0 + call_len,
                  np.where(q == (ph - 1) % calls,
                           calls * call_len + t0 - q * call_len, t0))
    return np.stack([t0, t1]).astype(np.int32)


def pack3(entries: np.ndarray) -> np.ndarray:
    """int32 entries (-1 where punctured) -> the form K11 and K15 read:
    e + 1 in 3 bytes, little-endian (0 where punctured), one after the
    other along the last axis."""
    v = entries.astype(np.int64) + 1
    if v.min() < 0 or v.max() >= 1 << 24:
        raise ValueError("an entry does not fit in 3 bytes")
    out = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], axis=-1)
    return out.astype(np.uint8).reshape(entries.shape[:-1]
                                        + (3 * entries.shape[-1],))


@functools.lru_cache(maxsize=8)
def _px_device_table(frame_len: int, device: str) -> torch.Tensor:
    return torch.from_numpy(pack3(px_tables(frame_len))).to(device)


def _check_px(llr, internal, phase):
    if llr.ndim != 3 or llr.shape[1] % 2:
        raise ValueError(f"llr: expected [S, 2P, frame_len], got "
                         f"{tuple(llr.shape)}")
    s, _, fl = llr.shape
    _, n, _ = IL.p3_iv_tables(fl)
    if tuple(internal.shape) != (s, n) or tuple(phase.shape) != (s,):
        raise ValueError(f"IV state: expected [{s}, {n}] and [{s}], got "
                         f"{tuple(internal.shape)} and {tuple(phase.shape)}")
    return s, llr.shape[1] // 2, fl


def px_deinterleave_plain(llr, internal, phase):
    """Plain version of K11: the reference's sequential pair scan
    (``px_scan_pairs(decode=False)`` over ``px_iv_call``), batched over
    stations.  llr: int8 [S, 2P, frame_len], each station's PX soft bits of
    2P blocks (block pair p = one IV call); internal int8 [S, N], phase
    int32 [S] the carried state.  Returns (K7's input int8
    [S*P, frame_len + 64, 3] of each pair's depunctured, wrap-extended
    soft bits, 0 where punctured; new internal; new phase)."""
    s, pairs, fl = _check_px(llr, internal, phase)
    read_idx, hazard, n, calls = _iv_tables(fl, str(llr.device))
    call_len = 2 * fl
    llr = llr.reshape(s, pairs, call_len)
    internal = internal.clone()
    ph = phase.long()
    pos = torch.arange(call_len, device=llr.device)
    fulls = []
    for p in range(pairs):
        offset = ph * call_len  # [S]
        idx = offset[:, None] + pos
        r = read_idx[idx].long()
        vals = internal.gather(1, r)
        fresh = llr[:, p].gather(1, (r - offset[:, None]).clamp(
            0, call_len - 1))
        soft = torch.where(hazard[idx].bool(), fresh, vals)
        full = depuncture(soft, C.PUNCTURE_P3_P4_FM, fl * 3).reshape(
            s, fl, 3)
        fulls.append(torch.cat([full[:, fl - WRAP:], full, full[:, :WRAP]],
                               dim=1))
        internal.scatter_(1, idx, llr[:, p])
        ph = (ph + 1) % calls
    ext = torch.stack(fulls, dim=1).reshape(s * pairs, fl + 2 * WRAP, 3)
    return ext.contiguous(), internal, ph.to(torch.int32)


def px_deinterleave(llr, internal, phase, plain: bool = False):
    """K11: the arguments and results of :func:`px_deinterleave_plain`.

    A CPU tensor (or ``plain``) takes the plain version; a CUDA tensor
    launches the kernel, which does every pair of the dispatch at once, a
    CTA two pairs of a station: a pair's read of region q of the state
    sees the newest earlier pair of this dispatch that wrote region q,
    else the state the dispatch began with, and the new state is each
    region's newest write.  The CTA stages those regions and the pairs'
    own soft bits in shared memory and gathers their K7 input through
    :func:`px_tables`, writing 0 for each trellis step's punctured middle
    input.  Every tensor must be dense and 16-byte aligned."""
    if plain or llr.device.type == "cpu":
        return px_deinterleave_plain(llr, internal, phase)
    s, pairs, fl = _check_px(llr, internal, phase)
    K.check(llr, "llr", torch.int8)
    K.check(internal, "internal", torch.int8)
    K.check(phase, "phase", torch.int32)
    for name, t in (("llr", llr), ("internal", internal)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K11 needs a 16-byte aligned tensor")
    dev = llr.device
    _, n, calls = IL.p3_iv_tables(fl)
    table = _px_device_table(fl, str(dev))
    ext = torch.empty(s * pairs, fl + 2 * WRAP, 3, dtype=torch.int8,
                      device=dev)
    new_internal = torch.empty_like(internal)
    new_phase = torch.empty_like(phase)
    K.launch("px_deinterleave", llr.data_ptr(), internal.data_ptr(),
             phase.data_ptr(), table.data_ptr(), ext.data_ptr(),
             new_internal.data_ptr(), new_phase.data_ptr(), s, pairs,
             2 * fl, calls, ext.shape[1] * 3, device=dev)
    return ext, new_internal, new_phase


def px_fec(ext: torch.Tensor, frame_len: int, packed: bool = False,
           plain: bool = False):
    """P3/P4 K=7 decode of K11's output: ext int8 [B, frame_len + 64, 3] ->
    (bits [B, frame_len] uint8, or packed; margin [B] float32), the
    unchunked tail-biting Viterbi (K7) then the descramble and pack
    (K8)."""
    bits, margin = _acs(ext, C.CONV_K7_GEN, plain)
    out, _ = (fec_epilogue_plain if plain else fec_epilogue)(
        bits, f"px{frame_len}", packed=packed)
    return out, margin


def px_decode(internal, new_llrs, call_phase, frame_len: int):
    """One interleaver-IV call + P3/P4 decode for one station (the
    reference's per-pair streaming entry point): internal int8 [N], new_llrs
    int8 [2*frame_len] (two L1 blocks' soft bits), call_phase int32 scalar.
    Returns (bits [frame_len] uint8, margin, new_internal [N])."""
    ext, new_internal, _ = px_deinterleave(
        new_llrs.reshape(1, 2, frame_len), internal[None],
        torch.as_tensor(call_phase, dtype=torch.int32,
                        device=internal.device).reshape(1))
    bits, margin = px_fec(ext, frame_len)
    return bits[0], margin[0], new_internal[0]
