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
    static index map per channel, written straight into K7's input;
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
    input float32 [G*F*n_seg, steps, 3]."""
    tb = channel_tables(name)
    t = tb["t"]
    table, seg_idx = _plain_indices(name, str(pm.device))
    llr = pm.reshape(-1, pm.shape[-1])[:, table].float()
    full = depuncture(llr, tb["pattern"], t * 3).reshape(-1, t, 3)
    if name == "p1":
        return full[:, seg_idx].reshape(-1, tb["steps"], 3).contiguous()
    return torch.cat([full[:, t - WRAP:], full, full[:, :WRAP]],
                     dim=1).contiguous()


def fec_gather(pm: torch.Tensor, name: str) -> torch.Tensor:
    """K6: the arguments and result of :func:`fec_gather_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, which writes ``float(pm[k7_map[e]])`` or 0.0 for every element
    of K7's input (one thread per element)."""
    if pm.device.type == "cpu":
        return fec_gather_plain(pm, name)
    if pm.device.type != "cuda" or pm.dtype != torch.int8:
        raise ValueError(f"pm: expected a CUDA int8 tensor, got {pm.dtype} "
                         f"on {pm.device}")
    pm = _frames3(pm, PM_FRAME if name == "p1" else C.PM_BLOCK_SIZE)
    g, f, _ = pm.shape
    tb = channel_tables(name)
    dt = _device_tables(name, str(pm.device))
    out = torch.empty(g * f * tb["n_seg"], tb["steps"], 3,
                      dtype=torch.float32, device=pm.device)
    K.launch("fec_gather", pm.data_ptr(), dt["k7_map"].data_ptr(),
             out.data_ptr(), g, f, pm.stride(0), pm.stride(1),
             dt["k7_map"].numel(), device=pm.device)
    return out


# ---------------------------------------------------------------------------
# K8: kept bits, re-encode bit errors, descramble, pack
# ---------------------------------------------------------------------------

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
    kernel (one CTA per frame, one thread per output byte)."""
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
    dt = _device_tables(name, str(dev))
    out = torch.empty(b, t // 8 if packed else t, dtype=torch.uint8,
                      device=dev)
    errors = None
    pm_args = (None, None, 1, 0, 0)
    if pm is not None:
        pm = _frames3(pm, PM_FRAME)
        if pm.dtype != torch.int8 or pm.device != dev \
                or pm.shape[0] * pm.shape[1] != b:
            raise ValueError("pm: expected int8 P1 frames on the bits' "
                             f"device, {b} of them")
        errors = torch.empty(b, dtype=torch.int32, device=dev)
        pm_args = (pm.data_ptr(), dt["code_map"].data_ptr(), pm.shape[1],
                   pm.stride(0), pm.stride(1))
    K.launch("fec_epilogue", bits.data_ptr(), dt["keep"].data_ptr(), per,
             *pm_args, dt["keystream"].data_ptr(), out.data_ptr(),
             None if errors is None else errors.data_ptr(), b, t,
             int(packed), *C.CONV_K7_GEN, device=dev)
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
    int32 [S] the carried state.  Returns (K7's input float32
    [S*P, frame_len + 64, 3] of each pair's depunctured, wrap-extended
    LLRs; new internal; new phase)."""
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
        soft = torch.where(hazard[idx].bool(), fresh, vals).float()
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
    launches the kernel, which does every pair of the dispatch at once: a
    pair's read of region q of the state sees the newest earlier pair of
    this dispatch that wrote region q, else the state the dispatch began
    with, and the new state is each region's newest write."""
    if plain or llr.device.type == "cpu":
        return px_deinterleave_plain(llr, internal, phase)
    s, pairs, fl = _check_px(llr, internal, phase)
    K.check(llr, "llr", torch.int8)
    K.check(internal, "internal", torch.int8)
    K.check(phase, "phase", torch.int32)
    dev = llr.device
    read_idx, hazard, n, calls = _iv_tables(fl, str(dev))
    k7_map = _device_tables(f"px{fl}", str(dev))["k7_map"]
    ext = torch.empty(s * pairs, fl + 2 * WRAP, 3, dtype=torch.float32,
                      device=dev)
    new_internal = torch.empty_like(internal)
    new_phase = torch.empty_like(phase)
    K.launch("px_deinterleave", llr.data_ptr(), internal.data_ptr(),
             phase.data_ptr(), read_idx.data_ptr(), hazard.data_ptr(),
             k7_map.data_ptr(), ext.data_ptr(), new_internal.data_ptr(),
             new_phase.data_ptr(), s, pairs, fl, n, calls, k7_map.numel(),
             device=dev)
    return ext, new_internal, new_phase


def px_fec(ext: torch.Tensor, frame_len: int, packed: bool = False,
           plain: bool = False):
    """P3/P4 K=7 decode of K11's output: ext [B, frame_len + 64, 3] ->
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
