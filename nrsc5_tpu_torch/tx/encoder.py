"""NRSC-5 FM L1/L2 encoder: bits -> PM soft-bit matrix (truth harness).

A numpy copy of ``nrsc5_tpu/tx/encoder.py`` (pinned equal by
tests/test_torch_tables.py).  Inverse of the receive chain's decode path
(reference: src/decode.c:451-472): scramble -> tail-biting conv encode ->
puncture -> interleave into the PM matrix, plus interleaver-IV cycles for
P3/P4.
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


def encode_p3_stream(p3_bits: np.ndarray, frame_len: int) -> np.ndarray:
    """One P3/P4 frame -> punctured rate-1/2 stream of 2*frame_len bits."""
    assert p3_bits.shape[-1] == frame_len
    scr = scramble(p3_bits.astype(np.uint8))
    coded = conv_encode(scr, 7, C.CONV_K7_GEN)
    return puncture(coded, C.PUNCTURE_P3_P4_FM)


def build_px_stream(frames: np.ndarray, frame_len: int,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Interleaver-IV transmit stream for consecutive cycles.

    frames: [n_cycles, 16, frame_len] bits.  Returns int8
    [n_cycles * N] in {-1,+1}: the sideband soft-bit stream in demod order.

    The deinterleaver's read at cycle position i takes the internal buffer
    value written *this* cycle when read_idx[i] < i and *last* cycle
    otherwise (reference: src/decode.c:344-376 reads before writing), so
    the transmit stream at internal position j must carry cycle K's
    codeword when j < inv[j] and cycle K+1's when j >= inv[j].  The last
    cycle's future half is random filler (read only beyond the capture), so
    cycles 1..n-1 decode.
    """
    frames = np.asarray(frames)
    assert frames.ndim == 3 and frames.shape[1] == 16
    n_cycles = frames.shape[0]
    coded = np.stack([
        np.concatenate([encode_p3_stream(f, frame_len) for f in cyc])
        for cyc in frames]).astype(np.int8)  # [n_cycles, N]
    inv = IL.p3_iv_inverse(frame_len)
    n = len(inv)
    future = np.arange(n) >= inv
    rng = rng or np.random.default_rng(0xB5)
    filler = rng.integers(0, 2, n).astype(np.int8)
    out = np.empty((n_cycles, n), np.int8)
    for k in range(n_cycles):
        nxt = coded[k + 1] if k + 1 < n_cycles else filler
        out[k] = np.where(future, nxt[inv], coded[k][inv])
    return (out.reshape(-1) * 2 - 1).astype(np.int8)
