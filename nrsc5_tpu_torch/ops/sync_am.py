"""AM fine-sync tables, the elementwise pieces of the AM sync block, and
the host lock logic of the AM cold start.

PyTorch counterpart of the tables and helpers of
``nrsc5_tpu/ops/sync_am.py`` (lines 37-80; pinned equal by
tests/test_torch_tables.py): the Gray level tables, the training points
and rows, the Gray demaps and the phase wraps.  The sync block itself is
kernel K13 (:func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.
sync_am_block_rc`).  And a numpy copy of the reference's host functions
of lines 215-269, which the cold start runs on each probe block's
reference bits: :func:`timing_consensus`, :func:`find_ref_am` and
:func:`find_block_am` (pinned equal by tests/test_torch_am_coldstart.py).

The reference equalizes with the interpolated training equalizer by
default (``NRSC5_AM_EQ_INTERP``, on unless set to 0); the port reads no
``NRSC5_*`` switch and always interpolates, so :data:`AM_EQ_INTERP` is a
fixed True.

AM constellation facts (reference: src/sync.c:37-88): QPSK/QAM16/QAM64
with Gray-coded levels at odd half-integers; training rows (5+11c)%32 and
(21+11c)%32 carry fixed points used for one-shot equalization per block.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import rcplx as rc

AM_EQ_INTERP = True

W = C.PARTITION_WIDTH_AM  # 25
CENTER = C.CENTER_AM

# gray-coded level tables (level index = floor(x) + span/2, clipped)
GRAY4 = np.array([0, 2, 3, 1], np.uint8)
GRAY8 = np.array([0, 4, 6, 2, 3, 7, 5, 1], np.uint8)

TRAIN_QAM64 = 2.5 - 2.5j
TRAIN_QAM16 = 1.5 - 0.5j
TRAIN_QPSK = -0.5 + 0.5j

TRAIN1 = (5 + 11 * np.arange(W)) % 32
TRAIN2 = (21 + 11 * np.arange(W)) % 32


@functools.lru_cache(maxsize=8)
def _gray(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(GRAY4 if n == 4 else GRAY8).to(device)


def gray4_map(x: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp(torch.floor(x).to(torch.int32) + 2, 0, 3)
    return _gray(4, str(x.device))[idx.long()]


def gray8_map(x: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp(torch.floor(x).to(torch.int32) + 4, 0, 7)
    return _gray(8, str(x.device))[idx.long()]


def _wrap_half_pi(d: torch.Tensor) -> torch.Tensor:
    return d - math.pi * torch.round(rc.fdiv(d, math.pi))


def _wrap_pi(d: torch.Tensor) -> torch.Tensor:
    return d - 2 * math.pi * torch.round(rc.fdiv(d, 2 * math.pi))


# ---------------------------------------------------------------------------
# host-side reference-subcarrier lock logic (reference: src/sync.c:209-258)
# ---------------------------------------------------------------------------

def timing_consensus(hist, modulo: int, tol: int = 2, need: int = 3):
    """Circular mode of recent coarse-timing measurements: the member of
    ``hist`` supported by >= ``need`` measurements within ±``tol``
    (circularly, modulo ``modulo``), or None.  The cold start latches it as
    the symbol timing under strong multipath, where single CP-correlation
    blocks throw outliers."""
    best, best_count = None, 0
    for cand in hist:
        count = sum(1 for h in hist
                    if min((h - cand) % modulo, (cand - h) % modulo) <= tol)
        if count > best_count:
            best, best_count = cand, count
    return best if best_count >= need else None


_NEEDLE23 = np.asarray(C.AM_REF_SIGNS_FIXED[:23], np.int64)
# row n: the positions of the needle's known signs at cyclic offset n
_ROTATED23 = (np.arange(C.BLKSZ)[:, None]
              + np.flatnonzero(_NEEDLE23 >= 0)[None, :]) % C.BLKSZ


def find_ref_am(bits: np.ndarray) -> int:
    """Fuzzy cyclic match of the AM sync needle (its first 23 positions):
    the first offset where it matches, or -1.  All 32 offsets are tried at
    once (the reference tries them one by one, with the same result)."""
    hits = np.flatnonzero((np.asarray(bits)[_ROTATED23]
                           == _NEEDLE23[_NEEDLE23 >= 0]).all(axis=1))
    return int(hits[0]) if hits.size else -1


def find_block_am(bits: np.ndarray):
    """Exact needle and parity check of one block's 32 reference bits:
    (bc, control) or None.  ``control`` holds psmi, pli, hppi, aabi and
    rdbi at bc 0 and is empty otherwise."""
    d = np.asarray(bits, np.int64)
    needle = np.asarray(C.AM_REF_SIGNS_FIXED, np.int64)
    known = needle >= 0
    if not np.all(d[known] == needle[known]):
        return None
    if d[7] ^ d[8]:
        return None
    if d[10] ^ d[11] ^ d[12] ^ d[13]:
        return None
    if d[15] ^ d[16] ^ d[17] ^ d[18] ^ d[19] ^ d[20]:
        return None
    if np.bitwise_xor.reduce(d[23:32]):
        return None
    bc = (d[17] << 2) | (d[18] << 1) | d[19]
    control = {}
    if bc == 0:
        control = {
            "psmi": (d[26] << 4) | (d[27] << 3) | (d[28] << 2)
                    | (d[29] << 1) | d[30],
            "pli": int(d[7]), "hppi": int(d[11]), "aabi": int(d[12]),
            "rdbi": int(d[15]),
        }
    return int(bc), control
