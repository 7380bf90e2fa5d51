"""NRSC-5 FM L1/L2 encoder: bits -> PM soft-bit matrix (truth harness).

A numpy copy of the P1/PIDS part of ``nrsc5_tpu/tx/encoder.py`` (pinned
equal by tests/test_torch_tables.py).  Inverse of the receive chain's
decode path (reference: src/decode.c:451-472): scramble -> tail-biting
conv encode -> puncture -> interleave into the PM matrix.
"""

from __future__ import annotations

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.convolutional import conv_encode, puncture
from nrsc5_tpu_torch.ops.scramble import scramble


def encode_p1_stream(p1_bits: np.ndarray) -> np.ndarray:
    """146176 P1 bits -> 365440-bit punctured stream."""
    assert p1_bits.shape[-1] == C.P1_FRAME_LEN_FM
    scr = scramble(p1_bits.astype(np.uint8))
    coded = conv_encode(scr, 7, C.CONV_K7_GEN)
    return puncture(coded, C.PUNCTURE_P1_PIDS_FM)


def encode_pids_stream(pids_bits: np.ndarray) -> np.ndarray:
    """[..., 80] PIDS bits -> [..., 200] punctured stream."""
    assert pids_bits.shape[-1] == C.PIDS_FRAME_LEN
    scr = scramble(pids_bits.astype(np.uint8))
    coded = conv_encode(scr, 7, C.CONV_K7_GEN)
    return puncture(coded, C.PUNCTURE_P1_PIDS_FM)


def build_pm_matrix(p1_bits: np.ndarray, pids_bits: np.ndarray) -> np.ndarray:
    """Assemble one P1 frame's PM matrix of TX signs.

    p1_bits: [146176]; pids_bits: [16, 80].
    Returns int8 [512, 720] in {-1,+1} (demod order).
    """
    p1 = encode_p1_stream(p1_bits)
    pids = encode_pids_stream(pids_bits).reshape(-1)
    stream = np.concatenate([p1, pids]).astype(np.int8)
    matrix = stream[IL.pm_inverse_table()]
    return (matrix.astype(np.int8) * 2 - 1).reshape(IL.PM_ROWS, IL.PM_ROW)
