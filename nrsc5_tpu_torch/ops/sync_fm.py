"""FM fine-sync tables: Costas gains, reference bins, needles, sync signs.

A numpy copy of the tables of ``nrsc5_tpu/ops/sync_fm.py`` (lines 30-100;
pinned equal by tests/test_torch_tables.py).  The sync arithmetic itself
lives in :mod:`nrsc5_tpu_torch.pipeline.scan_chain_rc`, as in the
reference's fused chain.  The reference's ``NRSC5_EQ_MMSE`` switch is not
read: the port always applies its default, the per-bin channel-power LLR
weighting.
"""

from __future__ import annotations

import functools

import numpy as np

from nrsc5_tpu_torch import constants as C

# Costas loop constants (reference: src/sync.c:832-841)
_LOOP_BW = 0.05
_DAMPING = 0.70710678
_DENOM = 1 + 2 * _DAMPING * _LOOP_BW + _LOOP_BW * _LOOP_BW
ALPHA = 4 * _DAMPING * _LOOP_BW / _DENOM
BETA = 4 * _LOOP_BW * _LOOP_BW / _DENOM

W = C.PARTITION_WIDTH_FM


@functools.lru_cache(maxsize=8)
def _ref_bins(ppb: int) -> np.ndarray:
    """All reference-subcarrier bins: lower refs 0..ppb then upper refs
    0..ppb (int32 [2*(ppb+1)])."""
    i = np.arange(ppb + 1)
    return np.concatenate([C.LB_START + i * W, C.UB_END - i * W]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _needles(ppb: int):
    """Per-ref expected sign sequences with rsid filled in.

    Returns (values uint8 [R, 32], known bool [R, 32]).
    """
    base = np.array(C.REF_SIGNS_FIXED, dtype=np.int64)
    r = ppb + 1
    vals = np.zeros((2 * r, C.BLKSZ), np.uint8)
    known = np.zeros((2 * r, C.BLKSZ), bool)
    for i in range(r):
        s = base.copy()
        rsid = (C.MIDDLE_REF_SC - i) & 0x3
        s[10] = rsid >> 1
        s[11] = (rsid >> 1) ^ (rsid & 1)
        k = s >= 0
        for row in (i, r + i):
            vals[row] = np.where(k, s, 0).astype(np.uint8)
            known[row] = k
    return vals, known


def _bit_masks(bits: np.ndarray) -> np.ndarray:
    """[R, 32] 0/1 rows -> int32 [R] words, bit n = column n."""
    w = (np.asarray(bits, np.uint64) << np.arange(C.BLKSZ, dtype=np.uint64))
    return w.sum(axis=1).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=8)
def needle_masks(ppb: int):
    """The needles of :func:`_needles` as bit masks, as the kernels read
    them: (values int32 [R], known int32 [R]), bit k = symbol k."""
    vals, known = _needles(ppb)
    return _bit_masks(vals), _bit_masks(known)


@functools.lru_cache(maxsize=1)
def _sync_signs() -> np.ndarray:
    """+-1 expected signs with 0 at variable positions (pi-ambiguity check;
    reference: src/sync.c:96-99)."""
    s = np.array(C.REF_SIGNS_FIXED, dtype=np.float32)
    return np.where(s < 0, 0.0, s * 2 - 1).astype(np.float32)
