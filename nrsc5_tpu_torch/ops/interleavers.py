"""NRSC-5 channel interleavers as static gather tables: FM I, II and IV,
and the AM MA1/MA3 bit maps and PIDS tables.

A numpy copy of ``nrsc5_tpu/ops/interleavers.py``
(the port imports nothing of the JAX package; tests/test_torch_tables.py
pins each table equal).  Every formula depends only on the stream position,
so each (de)interleaver is a constant int32 index table computed once.

Matrix conventions (identical to the reference demod ordering,
src/sync.c:514-535): the FM PM soft-bit matrix is a flat array of
``16 blocks x 32 symbols x 720`` int8 entries, where the 720 entries per
OFDM symbol are [lower sideband partitions 0..9, then upper sideband
partitions 10..19] x [data carriers 1..18] x [I, Q].
"""

from __future__ import annotations

import functools

import numpy as np

from nrsc5_tpu_torch import constants as C

PM_ROW = 720  # soft bits per OFDM symbol in the PM matrix (20 * 36)
PM_ROWS = C.P1_FM_BLOCKS * C.BLKSZ  # 512
PM_MATRIX_SIZE = PM_ROWS * PM_ROW  # 368640 = P1 (365440) + 16 x PIDS (200)


@functools.lru_cache(maxsize=1)
def p1_fm_table() -> np.ndarray:
    """int32 [365440]: position i of the punctured P1 stream -> index into
    the flat PM matrix (interleaver I: J=20, B=16, C=36, M=1; 1012s
    section 10.3.3; reference: src/decode.c:296-322,451-455)."""
    n = C.P1_FRAME_LEN_ENCODED_FM
    i = np.arange(n, dtype=np.int64)
    j, b, cc, m = 20, 16, 36, 1
    v = np.asarray(C.PM_V, dtype=np.int64)
    partition = v[((i + 2 * (m // 4)) // m) % len(v)]
    block = ((i // j) + partition * 7) % b
    k = i // (j * b)
    row = (k * 11) % 32
    col = (k * 11 + k // (32 * 9)) % cc
    idx = (block * 32 + row) * PM_ROW + partition * cc + col
    return idx.astype(np.int32)


@functools.lru_cache(maxsize=1)
def pids_fm_table() -> np.ndarray:
    """int32 [200]: punctured PIDS stream position -> index into one block's
    [32 x 720] soft-bit slice (interleaver II; reference:
    src/decode.c:324-342,463-467).  The table is the same for every block."""
    b_len = C.PIDS_FRAME_LEN_ENCODED_FM  # 200
    j, b, cc = 20, 16, 36
    i0 = C.P1_FRAME_LEN_ENCODED_FM
    m = np.arange(b_len, dtype=np.int64)
    v = np.asarray(C.PM_V, dtype=np.int64)
    partition = v[m % len(v)]
    k = (m // j) % (b_len // j) + i0 // (j * b)
    row = (k * 11) % 32
    col = (k * 11 + k // (32 * 9)) % cc
    idx = row * PM_ROW + partition * cc + col
    return idx.astype(np.int32)


@functools.lru_cache(maxsize=1)
def pm_inverse_table() -> np.ndarray:
    """TX-side scatter map for the full PM matrix.

    int32 [PM_MATRIX_SIZE]: flat matrix cell -> position in the concatenated
    stream [P1 punctured (365440) | block0 PIDS (200) | ... | block15 PIDS].
    Verifies that P1 + 16xPIDS tile the matrix exactly.
    """
    inv = np.full(PM_MATRIX_SIZE, -1, dtype=np.int64)
    p1 = p1_fm_table().astype(np.int64)
    assert len(np.unique(p1)) == len(p1)
    inv[p1] = np.arange(len(p1))
    pids = pids_fm_table().astype(np.int64)
    base = C.P1_FRAME_LEN_ENCODED_FM
    for bc in range(C.P1_FM_BLOCKS):
        cells = bc * C.BLKSZ * PM_ROW + pids
        assert np.all(inv[cells] == -1)
        inv[cells] = base + bc * len(pids) + np.arange(len(pids))
    assert not np.any(inv == -1), "P1 + PIDS must tile the PM matrix"
    return inv.astype(np.int32)


# ---------------------------------------------------------------------------
# Interleaver IV — FM P3/P4 with internal two-frame delay (1012s 10.3.6;
# reference: src/decode.c:344-376).
#
# The per-partition counters are deterministic in the cycle position, so one
# interleaver *cycle* (N bits = 16 frames) has a constant read-index table.
# The carried state is the N-entry internal buffer, written linearly; reads
# within the already-written region of the current call take the fresh value
# (the reference interleaves read/write per position).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def p3_iv_tables(frame_len: int):
    """Returns (read_idx [N] int32, n, calls_per_cycle).

    read_idx[i]: index into the internal buffer read at cycle position i.
    N = 147456 (MP3/MP11, J=4) or 73728 (MP2, J=2); one call consumes
    2*frame_len positions (two L1 blocks)."""
    j = 4 if frame_len == C.P3_FRAME_LEN_MP3_MP11 else 2
    b = 32
    cc = 36
    m = 2 if frame_len == C.P3_FRAME_LEN_MP3_MP11 else 4
    n = 147456 if frame_len == C.P3_FRAME_LEN_MP3_MP11 else 73728
    bk_bits = 32 * cc
    bk_adj = bk_bits - 1

    i = np.arange(n, dtype=np.int64)
    partition = ((i + 2 * (m // 4)) // m) % j
    # pti = running count of positions with this partition value before i
    pti = np.empty(n, dtype=np.int64)
    for p in range(j):
        sel = partition == p
        pti[sel] = np.arange(np.count_nonzero(sel))
        assert np.count_nonzero(sel) == n // j
    block = (pti + partition * 7 - bk_adj * (pti // bk_bits)) % b
    row = ((11 * pti) % bk_bits) // cc
    col = (pti * 11) % cc
    idx = (block * 32 + row) * (j * cc) + partition * cc + col
    assert len(np.unique(idx)) == n, "interleaver IV must be a permutation"
    calls_per_cycle = n // (2 * frame_len)
    return idx.astype(np.int32), n, calls_per_cycle


@functools.lru_cache(maxsize=4)
def p3_iv_hazard(frame_len: int):
    """Boolean [N]: True where read index falls inside the current call's
    already-written region (intra-call read-after-write)."""
    idx, n, calls = p3_iv_tables(frame_len)
    call_len = n // calls
    i = np.arange(n, dtype=np.int64)
    call_start = (i // call_len) * call_len
    return (idx >= call_start) & (idx < i)


@functools.lru_cache(maxsize=4)
def p3_iv_inverse(frame_len: int) -> np.ndarray:
    """TX scatter: internal-buffer position -> cycle stream position."""
    idx, n, _ = p3_iv_tables(frame_len)
    inv = np.empty(n, dtype=np.int32)
    inv[idx] = np.arange(n, dtype=np.int32)
    return inv


# ---------------------------------------------------------------------------
# AM interleavers (1012s section 10.4; reference: src/decode.c:67-231).
# bit_map gathers bit-plane p of the QAM symbol matrix.
# ---------------------------------------------------------------------------

def _bit_map_indices(b, k, p):
    """Vectorized bit_map (reference: src/decode.c:67-72): returns
    (symbol_index, bit_plane) into a [8*32 x 25] uint8 matrix."""
    col = (9 * k) % 25
    row = (11 * col + 16 * (k // 25) + 11 * (k // 50)) % 32
    return C.PARTITION_WIDTH_AM * (b * C.BLKSZ + row) + col, p


@functools.lru_cache(maxsize=2)
def am_ma1_tables(ma3: bool):
    """All AM frame interleaver gather tables for one service mode.

    Returns a dict of (matrix_selector, symbol_idx, bit_plane) per stream:
    streams 'bl','ml','bu','mu' gather from the pl/pu matrices; 'el'/'eu'
    (MA1) or 'ebl','eml','ebu','emu' (MA3) gather from the t/s matrices.
    matrix layout: [8 blocks * 32 symbols * 25 carriers] uint8 QAM symbols.
    """
    n18 = np.arange(18000, dtype=np.int64)
    out = {}
    out["bl"] = ("pl",) + _bit_map_indices(n18 // 2250, (n18 + n18 // 750 + 1) % 750, n18 % 3)
    out["ml"] = ("pl",) + _bit_map_indices((3 * n18 + 3) % 8, (n18 + n18 // 3000 + 3) % 750, 3 + (n18 % 3))
    out["bu"] = ("pu",) + _bit_map_indices(n18 // 2250, (n18 + n18 // 750) % 750, n18 % 3)
    out["mu"] = ("pu",) + _bit_map_indices((3 * n18) % 8, (n18 + n18 // 3000 + 2) % 750, 3 + (n18 % 3))
    if not ma3:
        n12 = np.arange(12000, dtype=np.int64)
        n24 = np.arange(24000, dtype=np.int64)
        out["el"] = ("t",) + _bit_map_indices((3 * n12 + n12 // 3000) % 8, (n12 + n12 // 6000) % 750, n12 % 2)
        out["eu"] = ("s",) + _bit_map_indices((3 * n24 + n24 // 3000 + 2 * (n24 // 12000)) % 8, (n24 + n24 // 6000) % 750, n24 % 4)
    else:
        out["ebl"] = ("t",) + _bit_map_indices((3 * n18 + 3) % 8, (n18 + n18 // 3000 + 3) % 750, n18 % 3)
        out["eml"] = ("t",) + _bit_map_indices((3 * n18 + 3) % 8, (n18 + n18 // 3000 + 3) % 750, 3 + (n18 % 3))
        out["ebu"] = ("s",) + _bit_map_indices((3 * n18) % 8, (n18 + n18 // 3000 + 2) % 750, n18 % 3)
        out["emu"] = ("s",) + _bit_map_indices((3 * n18) % 8, (n18 + n18 // 3000 + 2) % 750, 3 + (n18 % 3))
    return out


@functools.lru_cache(maxsize=2)
def am_pids_tables():
    """AM PIDS deinterleave (reference: src/decode.c:474-500).

    Returns (il_row, il_plane, iu_row, iu_plane, delay_il, delay_iu): the
    120-bit lower/upper gathers from the [32 x 2] QAM16 PIDS symbol pair and
    the figure 10-5 delay scatter into the 240-entry viterbi stream.
    """
    n = np.arange(120, dtype=np.int64)
    p = n % 4
    k = (n + n // 60 + 11) % 30
    il_row = (11 * (k + k // 15) + 3) % 32
    k = (n + n // 60) % 30
    iu_row = (11 * (k + k // 15) + 3) % 32
    return (il_row.astype(np.int32), p.astype(np.int32),
            iu_row.astype(np.int32), p.astype(np.int32),
            np.asarray(C.PIDS_IL_DELAY, np.int32),
            np.asarray(C.PIDS_IU_DELAY, np.int32))
