"""AM NRSC-5 OFDM modulator (truth harness).

A numpy copy of ``nrsc5_tpu/tx/modulator_am.py`` (pinned equal by
tests/test_torch_tables.py), the exact inverse of the AM receive path
(the AM acquire fold and the AM sync block):

  * 256-bin spectrum, pilot carrier at the center bin
  * lower sideband pre-compensated for the receiver's ``-conj`` transform;
    carriers the receiver complementary-combines (MA1, |i| <= 53) are split
    half/half between sidebands
  * training rows carry the fixed constellation points the one-shot
    equalizers expect
  * time symbol: IFFT, circular shift by -(FFT-CP)/2 (inverse of the
    receiver's offset fold), cyclic extension to 270 samples, raised-cosine
    shaping; NOT conjugated (AM ingest doesn't conjugate)
"""

from __future__ import annotations

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops.sync_am import (GRAY4, GRAY8, TRAIN1, TRAIN2, TRAIN_QAM16,
                                   TRAIN_QAM64, TRAIN_QPSK)

W = C.PARTITION_WIDTH_AM
CENTER = C.CENTER_AM

# inverse gray maps: code -> level
_INV4 = np.empty(4, np.float32)
_INV4[GRAY4] = np.arange(4) - 1.5
_INV8 = np.empty(8, np.float32)
_INV8[GRAY8] = np.arange(8) - 3.5


def qam64_point(code: np.ndarray) -> np.ndarray:
    return _INV8[code & 7] + 1j * _INV8[(code >> 3) & 7]


def qam16_point(code: np.ndarray) -> np.ndarray:
    return _INV4[code & 3] + 1j * _INV4[(code >> 2) & 3]


def qpsk_point(code: np.ndarray) -> np.ndarray:
    re = np.where(code & 1, 0.5, -0.5)
    im = np.where(code & 2, 0.5, -0.5)
    return re + 1j * im


def modulate_am(mats: list[dict], pids_codes: np.ndarray,
                ref_bits: np.ndarray, ma3: bool = False,
                scale: float = 0.02) -> np.ndarray:
    """Modulate N AM frames.

    mats: per-frame dicts of pl/pu/s/t [8*32*25] uint8 symbol matrices
      (from tx.encoder_am.interleave_frames).
    pids_codes: [n_blocks, 32, 2] uint8 QAM16 data codes (training rows
      ignored).
    ref_bits: [n_blocks, 32] uint8 reference sign bits.
    Returns complex64 [n_blocks*32*270] at 46511.7 S/s.
    """
    n_frames = len(mats)
    n_blocks = n_frames * 8
    assert pids_codes.shape[0] == n_blocks and ref_bits.shape[0] == n_blocks
    n_sym = n_blocks * C.BLKSZ
    spec = np.zeros((n_sym, C.FFT_AM), np.complex64)
    c = CENTER

    # pilot (the analog carrier slot): strong real tone
    spec[:, c] = 10.0

    combine = not ma3

    def place(bins_lower: np.ndarray | None, bins_upper: np.ndarray | None,
              rows: slice, vals: np.ndarray, combined: bool):
        """vals [32, W] target post-combine symbols for one block."""
        if combined:
            spec[rows, bins_upper] += vals / 2
            spec[rows, bins_lower] += -np.conj(vals) / 2
        elif bins_upper is not None:
            spec[rows, bins_upper] += vals
        else:
            spec[rows, bins_lower] += -np.conj(vals)

    primary = C.OUTER_PARTITION_START_AM if not ma3 else C.INNER_PARTITION_START_AM
    secondary = C.MIDDLE_PARTITION_START_AM
    tertiary = C.INNER_PARTITION_START_AM if not ma3 else C.MIDDLE_PARTITION_START_AM
    col = np.arange(W)

    for blk in range(n_blocks):
        frame, b = blk // 8, blk % 8
        m = mats[frame]
        rows = slice(blk * C.BLKSZ, (blk + 1) * C.BLKSZ)
        sl = slice(b * C.BLKSZ * W, (b + 1) * C.BLKSZ * W)

        def block_syms(codes, mapper, train):
            v = mapper(codes[sl].reshape(C.BLKSZ, W))
            v[TRAIN1, col] = train
            v[TRAIN2, col] = train
            return v

        pl_v = block_syms(m["pl"], qam64_point, TRAIN_QAM64)
        pu_v = block_syms(m["pu"], qam64_point, TRAIN_QAM64)
        if not ma3:
            s_v = block_syms(m["s"], qam16_point, TRAIN_QAM16)
            t_v = block_syms(m["t"], qpsk_point, TRAIN_QPSK)
        else:
            s_v = block_syms(m["s"], qam64_point, TRAIN_QAM64)
            t_v = block_syms(m["t"], qam64_point, TRAIN_QAM64)

        # primary partitions: pl on the lower sideband, pu on the upper
        place(c - primary - col, None, rows, pl_v, combined=False)
        place(None, c + primary + col, rows, pu_v, combined=False)
        if not ma3:
            place(c - secondary - col, c + secondary + col, rows, s_v,
                  combined=True)
            place(c - tertiary - col, c + tertiary + col, rows, t_v,
                  combined=True)
        else:
            place(None, c + secondary + col, rows, s_v, combined=False)
            place(c - tertiary - col, None, rows, t_v, combined=False)

        # PIDS
        p_v = qam16_point(pids_codes[blk])  # [32, 2]
        p_v[np.array([8, 24])] = TRAIN_QAM16
        if not ma3:
            for k, idx in enumerate((C.PIDS_INNER_INDEX_AM,
                                     C.PIDS_OUTER_INDEX_AM)):
                place(np.array([c - idx]), np.array([c + idx]), rows,
                      p_v[:, k:k + 1], combined=True)
        else:
            # MA3: pids1 on the lower sideband, pids2 on the upper
            place(np.array([c - C.PIDS_INNER_INDEX_AM]), None, rows,
                  p_v[:, 0:1], combined=False)
            place(None, np.array([c + C.PIDS_INNER_INDEX_AM]), rows,
                  p_v[:, 1:2], combined=False)

        # reference subcarriers at c±1 (imag-axis BPSK)
        v = (ref_bits[blk].astype(np.float32) * 2 - 1) * 1j  # [32]
        v = v[:, None]
        if combine:
            place(np.array([c - 1]), np.array([c + 1]), rows, v, combined=True)
        else:
            place(None, np.array([c + 1]), rows, v, combined=False)
            place(np.array([c - 1]), None, rows, v, combined=False)

    # spectrum -> time
    offset = (C.FFT_AM - C.CP_AM) // 2
    z = np.fft.ifft(np.fft.ifftshift(spec, axes=-1), axis=-1)
    core = np.roll(z, -offset, axis=-1)
    ext = np.concatenate([core, core[:, : C.CP_AM]], axis=-1)
    shape = C.ofdm_shape(C.FFT_AM, C.CP_AM)
    sig = (ext * shape[None, :]).reshape(-1)
    return (sig * scale).astype(np.complex64)
