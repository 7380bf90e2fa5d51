"""Convolutional FEC: numpy encoder + the K=7 and K=9 Viterbi decoders.

PyTorch counterpart of ``nrsc5_tpu/ops/convolutional.py``: the numpy tables
and encoder (``_parity_table``, ``trellis_tables``, ``conv_encode``,
``puncture``, ``_chunk_plan``; pinned equal by
tests/test_torch_tables.py) and the decoder side at K=7 (FM P1, PIDS and
PX; reference: src/conv_dec.c:402-427, src/decode.c:234-277) and K=9 (AM
P1, P3 and PIDS; src/decode.c:183-231).

Encoder convention: the shift register holds the most recent K input bits
with the newest at the MSB, output j is ``parity(r & G[j])``; tail-biting
pre-loads the register with the frame's last K-1 bits.

:func:`acs_traceback` is kernel K7: ACS forward recursion and traceback
over free-start segments, ``csrc/viterbi_k7.cu`` at K=7 and
``csrc/viterbi_k9.cu`` at K=9.  :func:`acs_traceback_plain` is its plain
PyTorch version at either K.  :func:`viterbi_decode` (tail-biting wrap
extension) and :func:`viterbi_decode_chunked` (overlapping segments, the
keep-middle gather, FM's chunk plan) decode any K=7 LLRs around it, as
the reference's functions of those names do; the chains' channels reach K7
through the static index maps of :mod:`nrsc5_tpu_torch.ops.decode_fm` and
:mod:`nrsc5_tpu_torch.ops.decode_am` (kernels K6, K11 and K15, then K8),
which compose the same wrap and segment plan.  The chunk plans are the
reference's CPU defaults, one trellis step per ACS step (radix 1), which
set which bits come out: chunk 1152 with overlap 96 at K=7 (FM), chunk
1024 with overlap 160 at K=9 (AM).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nrsc5_tpu_torch import kernels as K

TAIL_BITING_EXTRA = 32  # wrap steps on each side (reference: src/conv_dec.c:43)
CHUNK = 1152  # FM's chunk plan (K=7)
OVERLAP = 96
CHUNK_AM = 1024  # AM's chunk plan (K=9; reference decode_am.py:160, 165)
OVERLAP_AM = 160
# K7's segment length: path metrics stay below 2^24 (381 a step at most),
# exact in the plain version's float32 and in the kernel's int32
MAX_STEPS = 32768


# ---------------------------------------------------------------------------
# Shared trellis tables and the numpy encoder
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _parity_table(nbits: int) -> np.ndarray:
    v = np.arange(1 << nbits, dtype=np.uint32)
    p = v & 1
    while nbits > 1:
        v >>= 1
        p ^= v & 1
        nbits -= 1
    return p.astype(np.uint8)


@functools.lru_cache(maxsize=8)
def trellis_tables(k: int, gens: tuple[int, int, int]):
    """ACS tables for a rate-1/3 code: for each next-state s' (k-1 bits,
    MSB = newest input bit), input bit b = s' >> (k-2), predecessors
    pred_p = ((s' << 1) & (ns-1)) | p and branch outputs
    out[s', p, j] = 2*parity((pred_p | b<<(k-1)) & G_j) - 1.
    Returns (pred0, pred1, out_nrz [ns, 2, 3] float32)."""
    ns = 1 << (k - 1)
    par = _parity_table(k)
    sp = np.arange(ns, dtype=np.int32)
    b = sp >> (k - 2)
    pred0 = (sp << 1) & (ns - 1)
    pred1 = pred0 | 1
    out = np.empty((ns, 2, 3), dtype=np.float32)
    for p, pred in ((0, pred0), (1, pred1)):
        full = pred | (b << (k - 1))
        for j, g in enumerate(gens):
            out[:, p, j] = par[full & g].astype(np.float32) * 2.0 - 1.0
    return pred0, pred1, out


def conv_encode(bits: np.ndarray, k: int, gens: tuple[int, int, int]) -> np.ndarray:
    """Tail-biting rate-1/3 encode.  bits: [..., T] in {0,1} ->
    [..., T*3] mother-code bits (output order G0,G1,G2 per input bit)."""
    bits = np.asarray(bits, dtype=np.uint32)
    t = bits.shape[-1]
    par = _parity_table(k)
    reg = np.zeros(bits.shape, dtype=np.uint32)
    for d in range(k):
        reg |= np.roll(bits, d, axis=-1) << (k - 1 - d)
    out = np.empty(bits.shape[:-1] + (t, 3), dtype=np.uint8)
    for j, g in enumerate(gens):
        out[..., j] = par[reg & g]
    return out.reshape(bits.shape[:-1] + (t * 3,))


def puncture(coded: np.ndarray, pattern: tuple[int, ...]) -> np.ndarray:
    """Drop mother-code bits where the repeating pattern is 0."""
    t = coded.shape[-1]
    mask = np.resize(np.asarray(pattern, dtype=bool), t)
    return coded[..., mask]


@functools.lru_cache(maxsize=8)
def _kept_columns(pattern: tuple[int, ...], device: str) -> torch.Tensor:
    return torch.tensor([i for i, bit in enumerate(pattern) if bit],
                        dtype=torch.int64, device=device)


def depuncture(llr: torch.Tensor, pattern: tuple[int, ...],
               coded_len: int) -> torch.Tensor:
    """Insert zero LLRs at punctured positions: [..., kept] -> [..., coded_len].
    ``coded_len`` must tile the pattern (every FM channel's does).  Once
    the pattern's columns are cached on the device it makes no host copy,
    so it can run inside a CUDA graph."""
    period, kept = len(pattern), int(sum(pattern))
    assert coded_len % period == 0, (coded_len, period)
    cols = llr.reshape(llr.shape[:-1] + (coded_len // period, kept))
    out = cols.new_zeros(cols.shape[:-1] + (period,))
    out[..., _kept_columns(pattern, str(llr.device))] = cols
    return out.reshape(llr.shape[:-1] + (coded_len,))


@functools.lru_cache(maxsize=32)
def _chunk_plan(t: int, chunk: int, overlap: int):
    """Static plan for the overlapping-chunk Viterbi: the circular frame is
    cut into ``n`` near-equal segments; segment i covers frame positions
    [b_i - overlap, b_{i+1} + overlap) mod t and only its middle survivor
    bits are kept.  Returns (seg_idx [n, L], src_chunk [t], src_off [t])."""
    n = max(1, -(-t // chunk))
    bounds = np.floor(np.linspace(0, t, n + 1)).astype(np.int64)
    keep = np.diff(bounds)
    length = int(keep.max() + 2 * overlap)
    seg_idx = ((bounds[:-1, None] - overlap + np.arange(length)[None, :]) % t
               ).astype(np.int32)
    pos = np.arange(t)
    src_chunk = (np.searchsorted(bounds, pos, side="right") - 1).astype(np.int32)
    src_off = (overlap + pos - bounds[src_chunk]).astype(np.int32)
    return seg_idx, src_chunk, src_off


@functools.lru_cache(maxsize=8)
def _plan_tensors(t: int, device: str):
    seg_idx, src_chunk, src_off = _chunk_plan(t, CHUNK, OVERLAP)
    n, length = seg_idx.shape
    keep_flat = src_chunk.astype(np.int64) * length + src_off
    return (torch.from_numpy(seg_idx.astype(np.int64)).to(device),
            torch.from_numpy(keep_flat).to(device))


# ---------------------------------------------------------------------------
# K7: ACS + traceback
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sign_rows(k: int, gens: tuple[int, int, int], device: str):
    """Branch sign matrices [3, 2^(k-1)] for predecessor 0 and 1."""
    _, _, out = trellis_tables(k, gens)
    return (torch.from_numpy(np.ascontiguousarray(out[:, 0, :].T)).to(device),
            torch.from_numpy(np.ascontiguousarray(out[:, 1, :].T)).to(device))


def acs_traceback_plain(ext: torch.Tensor, gens: tuple[int, int, int],
                        k: int = 7):
    """Plain version of K7 (the reference's ``_acs_traceback``, radix 1),
    at constraint length ``k`` (7 or 9).  ext [B, L, 3] float32, or int8
    (taken as the same values in float32) -> (bits [B, L] uint8, margin [B]
    float32).  Uniform start metrics, traceback from the first argmax."""
    ext = ext.float()
    b, length, _ = ext.shape
    dev = ext.device
    ns = 1 << (k - 1)
    nw = ns // 32
    sgn0, sgn1 = _sign_rows(k, gens, str(dev))
    pm = torch.zeros(b, ns, dtype=torch.float32, device=dev)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = torch.empty(length, b, nw, dtype=torch.int64, device=dev)
    for t in range(length):
        llr = ext[:, t]
        bm0 = llr[:, 0:1] * sgn0[0] + llr[:, 1:2] * sgn0[1] \
            + llr[:, 2:3] * sgn0[2]
        bm1 = llr[:, 0:1] * sgn1[0] + llr[:, 1:2] * sgn1[1] \
            + llr[:, 2:3] * sgn1[2]
        pairs = pm.reshape(b, ns // 2, 2)
        c0 = pairs[:, :, 0].repeat(1, 2) + bm0
        c1 = pairs[:, :, 1].repeat(1, 2) + bm1
        dec = c1 > c0
        pm = torch.where(dec, c1, c0)
        # decisions of states 32w..32w+31 as the bits of word w
        words[t] = (dec.to(torch.int64).reshape(b, nw, 32) << shifts).sum(-1)
    top2 = torch.topk(pm, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    state = torch.argmax(pm, dim=-1)
    bits = torch.empty(length, b, dtype=torch.uint8, device=dev)
    for t in range(length - 1, -1, -1):
        word = words[t].gather(1, (state >> 5)[:, None])[:, 0]
        p = (word >> (state & 31)) & 1
        bits[t] = (state >> (k - 2)).to(torch.uint8)
        state = ((state << 1) & (ns - 1)) | p
    return bits.T.contiguous(), margin


def acs_traceback(ext: torch.Tensor, gens: tuple[int, int, int],
                  k: int = 7):
    """K7: the arguments and results of :func:`acs_traceback_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel of constraint length ``k`` (``viterbi_k7``: two segments a
    warp; ``viterbi_k9``: one), which writes its survivor decisions to a
    scratch tensor allocated here at the size the kernel's library gives
    (``viterbi_k<k>_scratch_bytes``).  The kernel takes integer LLRs in
    [-127, 127] (what K6, K11 and K15 produce) and keeps integer path
    metrics; its bits and margins then equal the plain version's exactly.
    At either constraint length it takes ext int8 (K6's P1 and PIDS
    segments, K11's PX frames and K15's AM segments, read by the kernel's
    int8 load path) or float32, with the same bits and margins for the
    same values.  It raises on a constraint length, generator set, dtype
    or shape the kernel does not take."""
    if ext.device.type == "cpu":
        return acs_traceback_plain(ext, gens, k)
    if k not in (7, 9):
        raise ValueError(f"K7 takes constraint length 7 or 9, not {k}")
    if ext.ndim != 3 or ext.shape[-1] != 3:
        raise ValueError(f"ext: expected [B, L, 3], got {tuple(ext.shape)}")
    b, length, _ = ext.shape
    if not 0 < length <= MAX_STEPS or b == 0:
        raise ValueError(f"ext: {b} segments of {length} steps (K7 takes "
                         f"1..{MAX_STEPS} steps)")
    int8 = ext.dtype == torch.int8
    K.check(ext, "ext", torch.int8 if int8 else torch.float32)
    name = f"viterbi_k{k}"
    nbytes = K.query(name, f"{name}_scratch_bytes", b, length, *gens)
    if nbytes < 0:
        raise ValueError(f"K7 at K={k} does not hold the generators "
                         f"{tuple(gens)}")
    bits = torch.empty(b, length, dtype=torch.uint8, device=ext.device)
    margin = torch.empty(b, dtype=torch.float32, device=ext.device)
    scratch = torch.empty(nbytes // 4, dtype=torch.int32, device=ext.device)
    K.launch(name, ext.data_ptr(), bits.data_ptr(), margin.data_ptr(),
             scratch.data_ptr(), nbytes, b, length, *gens, int(int8),
             device=ext.device)
    return bits, margin


def _acs(ext, gens, plain: bool, k: int = 7):
    return (acs_traceback_plain if plain else acs_traceback)(ext, gens, k)


# ---------------------------------------------------------------------------
# Decoders around K7
# ---------------------------------------------------------------------------

def viterbi_decode(llr: torch.Tensor, gens: tuple[int, int, int],
                   plain: bool = False):
    """Tail-biting K=7 Viterbi.  llr: [..., T, 3] (positive = bit 1).
    Returns (bits [..., T] uint8, margin [...] float32).  The trellis is
    extended by 32 wrap steps on each side and their decisions dropped
    (reference: src/conv_dec.c:407-412).  ``plain`` runs K7's plain
    version.  On a CUDA tensor the LLRs must be integers in [-127, 127]
    (K7's input contract, :func:`acs_traceback`): the kernel rounds any
    other value, so only integer LLRs give the plain version's bits."""
    llr = llr.float()
    t = llr.shape[-2]
    batch = llr.shape[:-2]
    flat = llr.reshape(-1, t, 3)
    wrap = min(TAIL_BITING_EXTRA, t)
    ext = torch.cat([flat[:, t - wrap:], flat, flat[:, :wrap]], dim=1)
    bits, margin = _acs(ext.contiguous(), gens, plain)
    return (bits[:, wrap:wrap + t].reshape(batch + (t,)),
            margin.reshape(batch))


def viterbi_decode_chunked(llr: torch.Tensor, gens: tuple[int, int, int],
                           plain: bool = False):
    """Chunk-parallel tail-biting K=7 Viterbi: the circular frame is cut
    into segments of CHUNK bits overlapping by OVERLAP on each side,
    decoded in parallel with free boundary metrics, and only each
    segment's middle bits are kept.  A frame no longer than one segment
    takes :func:`viterbi_decode`.

    llr: [..., T, 3], integers in [-127, 127] on a CUDA tensor, as for
    :func:`viterbi_decode`.  Returns (bits [..., T] uint8, margin [...]
    float32 — the minimum per-segment metric margin)."""
    llr = llr.float()
    t = llr.shape[-2]
    if CHUNK + 2 * OVERLAP >= t:
        return viterbi_decode(llr, gens, plain=plain)
    batch = llr.shape[:-2]
    seg_idx, keep_flat = _plan_tensors(t, str(llr.device))
    n, length = seg_idx.shape
    flat = llr.reshape(-1, t, 3)
    segs = flat[:, seg_idx]  # [B, n, L, 3]
    bits_seg, margins = _acs(segs.reshape(-1, length, 3), gens, plain)
    bits = bits_seg.reshape(-1, n * length)[:, keep_flat]
    return (bits.reshape(batch + (t,)),
            margins.reshape(batch + (n,)).amin(dim=-1))


def conv_encode_dev(bits: torch.Tensor, gens: tuple[int, int, int],
                    k: int = 7) -> torch.Tensor:
    """Tail-biting re-encode on tensors: bits [..., T] uint8 ->
    [..., T, 3] uint8 (reference: src/decode.c:234-259)."""
    reg = torch.zeros(bits.shape, dtype=torch.int32, device=bits.device)
    for d in range(k):
        reg = reg | (torch.roll(bits, d, dims=-1).to(torch.int32)
                     << (k - 1 - d))

    def parity(v):
        v = v ^ (v >> 8)
        v = v ^ (v >> 4)
        v = v ^ (v >> 2)
        v = v ^ (v >> 1)
        return (v & 1).to(torch.uint8)

    return torch.stack([parity(reg & g) for g in gens], dim=-1)


@functools.lru_cache(maxsize=8)
def _pattern_mask(pattern: tuple[int, ...], t: int, device: str):
    return torch.from_numpy(np.resize(np.asarray(pattern, bool), t * 3)
                            .reshape(t, 3)).to(device)


def reencode_bit_errors(llr_full: torch.Tensor, bits_scrambled: torch.Tensor,
                        gens: tuple[int, int, int],
                        pattern: tuple[int, ...]) -> torch.Tensor:
    """Count demod-vs-reencode disagreements at unpunctured positions
    (reference: src/decode.c:234-277).  llr_full: [..., T, 3] depunctured
    soft bits; bits_scrambled: [..., T] Viterbi output before
    descrambling.  Returns int32 [...]."""
    enc = conv_encode_dev(bits_scrambled, gens)
    mask = _pattern_mask(pattern, bits_scrambled.shape[-1],
                         str(llr_full.device))
    hard = llr_full > 0
    return (mask & (hard != (enc > 0))).sum(dim=(-2, -1)).to(torch.int32)
