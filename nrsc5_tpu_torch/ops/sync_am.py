"""AM fine-sync tables and the elementwise pieces of the AM sync block.

PyTorch counterpart of the tables and helpers of
``nrsc5_tpu/ops/sync_am.py`` (lines 37-80; pinned equal by
tests/test_torch_tables.py): the Gray level tables, the training points
and rows, the Gray demaps and the phase wraps.  The sync block itself is
kernel K13 (:func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.
sync_am_block_rc`).

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
