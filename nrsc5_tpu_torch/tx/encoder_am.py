"""AM MA1/MA3 L1 encoder (truth harness): service bits → QAM symbol
matrices.

A numpy copy of ``nrsc5_tpu/tx/encoder_am.py`` (pinned equal by
tests/test_torch_tables.py).  Exact inverse of ops/decode_am.py and the AM
sync block's demap (reference inverse: src/decode.c:74-231)."""

from __future__ import annotations

import functools

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.convolutional import conv_encode, puncture
from nrsc5_tpu_torch.ops.decode_am import _phase_tables
from nrsc5_tpu_torch.ops.scramble import scramble


def encode_p1_am(p1_frames: np.ndarray) -> np.ndarray:
    """[8, 3750] bits -> [72000] punctured stream (E1, rate 5/12)."""
    scr = scramble(p1_frames.astype(np.uint8))
    coded = conv_encode(scr, 9, C.CONV_E1_GEN)
    return puncture(coded, C.PUNCTURE_E1).reshape(-1)


def encode_p3_am(p3_bits: np.ndarray, ma3: bool) -> np.ndarray:
    scr = scramble(p3_bits.astype(np.uint8))
    if ma3:
        coded = conv_encode(scr, 9, C.CONV_E1_GEN)
        return puncture(coded, C.PUNCTURE_E1)
    coded = conv_encode(scr, 9, C.CONV_E2_E3_GEN)
    return puncture(coded, C.PUNCTURE_E2)


@functools.lru_cache(maxsize=4)
def _inverse_phase(ma3: bool):
    """For each stream: positions in p1_am/p3_am supplying its bits in
    order (inverse of the 12/6-phase delay scatter)."""
    (p1_sel, p1_idx, p1_names), (p3_sel, p3_idx, p3_names) = _phase_tables(ma3)

    def inv(sel, idx, names):
        out = {}
        for s, name in enumerate(names):
            pos = np.nonzero(sel == s)[0]
            order = np.argsort(idx[pos])
            out[name] = pos[order]
        return out

    return inv(p1_sel, p1_idx, p1_names), inv(p3_sel, p3_idx, p3_names)


def interleave_frames(p1_streams: list[np.ndarray],
                      p3_streams: list[np.ndarray], ma3: bool):
    """Spread N frames' punctured streams into per-frame QAM matrices.

    The delayed streams (ml/mu, and eml/emu in MA3) of frame F are placed in
    the matrices of frame F-3 — the TX side of the 54000-bit diversity delay
    (reference: src/decode.c:87,97,177-181).  Frames whose delayed halves
    would come from beyond the end get zeros there (the receiver's
    ``am_diversity_wait`` covers the symmetric start-up).

    Returns per-frame dict of matrices pl/pu/s/t [8*32*25] uint8.
    """
    n = len(p1_streams)
    p1_inv, p3_inv = _inverse_phase(ma3)
    tabs = IL.am_ma1_tables(ma3)

    # per frame: stream name -> bit array
    frame_streams = []
    for f in range(n):
        st = {name: p1_streams[f][pos] for name, pos in p1_inv.items()}
        for name, pos in p3_inv.items():
            st[name] = p3_streams[f][pos]
        frame_streams.append(st)

    delayed = {"ml", "mu", "eml", "emu"}
    filler = np.random.default_rng(0xA3)
    mats = []
    for f in range(n):
        m = {k: np.zeros(8 * C.BLKSZ * C.PARTITION_WIDTH_AM, np.uint8)
             for k in ("pl", "pu", "s", "t")}
        for name, tab in tabs.items():
            src_f = f + 3 if name in delayed else f
            if src_f >= n:
                # the delayed half of a frame beyond the capture: random
                # filler (all-zero planes would make every QAM symbol's
                # delayed component a DC constant and wreck the coarse CP
                # correlation; real broadcasts always carry content here)
                bits = filler.integers(
                    0, 2, len(frame_streams[f][name])).astype(np.uint8)
            else:
                bits = frame_streams[src_f][name]
            matrix, sym_idx, plane = tab
            np.bitwise_or.at(m[matrix], sym_idx,
                             (bits.astype(np.uint8) << plane))
        mats.append(m)
    return mats


def encode_pids_am(pids_bits: np.ndarray) -> np.ndarray:
    """[80] bits -> [32, 2] QAM16 data codes for one block (rows 8/24 are
    training and left 0; the modulator overwrites them)."""
    scr = scramble(pids_bits.astype(np.uint8))
    # AM PIDS is the unpunctured rate-1/3 mother code: all 240 bits are
    # transmitted (reference: src/decode.c:496-503 fills viterbi_pids fully)
    stream = conv_encode(scr, 9, C.CONV_E2_E3_GEN)  # [240]
    il_row, il_p, iu_row, iu_p, il_delay, iu_delay = IL.am_pids_tables()
    i = np.arange(120)
    il = stream[(i // 12) * 24 + np.asarray(il_delay)[i % 12]]
    iu = stream[(i // 12) * 24 + np.asarray(iu_delay)[i % 12]]
    codes = np.zeros((C.BLKSZ, 2), np.uint8)
    np.bitwise_or.at(codes[:, 0], il_row, (il << il_p).astype(np.uint8))
    np.bitwise_or.at(codes[:, 1], iu_row, (iu << iu_p).astype(np.uint8))
    return codes


def am_ref_bits(bc: int, psmi: int, pli=0, hppi=0, aabi=0, rdbi=0) -> np.ndarray:
    """The 32 reference-subcarrier sign bits for one block, satisfying the
    sync needle and parity constraints (reference: src/sync.c:209-241)."""
    d = np.array([v if v >= 0 else 0 for v in C.AM_REF_SIGNS_FIXED], np.int64)
    d[7] = d[8] = pli
    d[10] = 0
    d[11] = hppi
    d[12] = aabi
    d[13] = d[10] ^ d[11] ^ d[12]
    d[15] = rdbi
    d[16] = 0
    d[17] = (bc >> 2) & 1
    d[18] = (bc >> 1) & 1
    d[19] = bc & 1
    d[20] = d[15] ^ d[16] ^ d[17] ^ d[18] ^ d[19]
    d[23] = d[24] = d[25] = 0
    for j in range(5):
        d[26 + j] = (psmi >> (4 - j)) & 1
    d[31] = np.bitwise_xor.reduce(d[23:31])
    return d.astype(np.uint8)
