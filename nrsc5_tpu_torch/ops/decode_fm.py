"""FM logical-channel decode: deinterleave -> depuncture -> Viterbi ->
descramble (reference: src/decode.c:378-472).

PyTorch counterpart of ``nrsc5_tpu/ops/decode_fm.py:p1_decode``,
``pids_decode`` and ``_descramble_dev``, batched over a leading axis.  The
deinterleave is the int8 gather through the interleaver tables (the
reference's default), the Viterbi is kernel K7 through
:mod:`nrsc5_tpu_torch.ops.convolutional`.
"""

from __future__ import annotations

import functools

import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.convolutional import (depuncture,
                                               reencode_bit_errors,
                                               viterbi_decode,
                                               viterbi_decode_chunked)
from nrsc5_tpu_torch.ops.scramble import scrambler_keystream


@functools.lru_cache(maxsize=8)
def _gather_table(name: str, device: str) -> torch.Tensor:
    t = IL.p1_fm_table() if name == "p1" else IL.pids_fm_table()
    return torch.from_numpy(t).long().to(device)


@functools.lru_cache(maxsize=8)
def _keystream(length: int, device: str) -> torch.Tensor:
    return torch.from_numpy(scrambler_keystream(length).copy()).to(device)


def _descramble_dev(bits: torch.Tensor, length: int) -> torch.Tensor:
    return bits ^ _keystream(length, str(bits.device))


def p1_decode(pm_matrix: torch.Tensor, plain: bool = False):
    """pm_matrix: [B, 16*32*720] int8 (one P1 frame of soft bits per row).
    Returns (bits [B, 146176] uint8, Viterbi margin [B] float32, re-encode
    bit errors [B] int32) from the chunk-parallel Viterbi; ``plain`` runs
    K7's plain version."""
    llr = pm_matrix[:, _gather_table("p1", str(pm_matrix.device))].float()
    full = depuncture(llr, C.PUNCTURE_P1_PIDS_FM, C.P1_FRAME_LEN_FM * 3)
    full = full.reshape(-1, C.P1_FRAME_LEN_FM, 3)
    bits, margin = viterbi_decode_chunked(full, C.CONV_K7_GEN, plain=plain)
    errors = reencode_bit_errors(full, bits, C.CONV_K7_GEN,
                                 C.PUNCTURE_P1_PIDS_FM)
    return _descramble_dev(bits, C.P1_FRAME_LEN_FM), margin, errors


def pids_decode(pm_block: torch.Tensor, plain: bool = False):
    """pm_block: [B, 32*720] int8 (one L1 block per row).  Returns bits
    [B, 80] uint8."""
    llr = pm_block[:, _gather_table("pids", str(pm_block.device))].float()
    full = depuncture(llr, C.PUNCTURE_P1_PIDS_FM, C.PIDS_FRAME_LEN * 3)
    full = full.reshape(-1, C.PIDS_FRAME_LEN, 3)
    bits, _ = viterbi_decode(full, C.CONV_K7_GEN, plain=plain)
    return _descramble_dev(bits, C.PIDS_FRAME_LEN)
