"""NRSC-5 FM OFDM modulator (truth harness).

A numpy copy of ``nrsc5_tpu/tx/modulator.py`` (the port imports nothing of
the JAX package; tests/test_torch_tables.py pins its output equal), so a
test signal can be made without the reference package.

The reference ships no transmitter; we need one because the CI capture
(support/sample.xz) is unavailable and every decoder stage is tested against
its exact inverse.  The modulator follows the 1011s waveform that the
receiver inverts (reference: src/acquire.c:237-256 fold/window,
src/sync.c:90-130 reference-subcarrier tracking, 504-607 data demap):

  * per OFDM symbol, a 2048-bin spectrum (fftshifted indexing, bin 1024=DC)
  * reference subcarriers: BPSK on the real axis, carrying the 32-bit
    system-control sign sequence per L1 block (DBPSK fields bc/psmi)
  * data subcarriers: QPSK at 45 deg to the refs, so that the receiver's
    partition equalizer maps them onto +-1 +-1j
  * time symbol: 2048-point IFFT, cyclically extended to 2160 samples,
    shaped with the root-raised-cosine window, symbols concatenated at
    2160-sample spacing
  * the emitted FM baseband is conjugated (the receiver conjugates on
    ingest, src/acquire.c:126)
"""

from __future__ import annotations

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops.interleavers import PM_ROW


def ref_control_signs(bc: int, psmi: int, rsid: int) -> np.ndarray:
    """The 32 transmitted BPSK signs for one reference subcarrier and block.

    Fixed sync positions from constants.REF_SIGNS_FIXED; rsid gray-coded into
    positions 10/11; bc DBPSK-encoded into data positions 16..19 and psmi
    into 25..30 (d[n] = s[n] ^ s[n-1]).
    """
    s = np.array(C.REF_SIGNS_FIXED, dtype=np.int64)
    s[s < 0] = 0
    s[10] = rsid >> 1
    s[11] = (rsid >> 1) ^ (rsid & 1)
    prev = s[15]
    for j in range(4):
        prev ^= (bc >> (3 - j)) & 1
        s[16 + j] = prev
    prev = s[24]
    for j in range(6):
        prev ^= (psmi >> (5 - j)) & 1
        s[25 + j] = prev
    return s.astype(np.int8)


def fm_ref_indices(ppb: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lower_refs, upper_refs, rsids) for ppb partitions per sideband."""
    i = np.arange(ppb + 1)
    lower = C.LB_START + i * C.PARTITION_WIDTH_FM
    upper = C.UB_END - i * C.PARTITION_WIDTH_FM
    rsid = (C.MIDDLE_REF_SC - i) & 0x3
    return lower, upper, rsid


def _qpsk_from_signs(si: np.ndarray, sq: np.ndarray) -> np.ndarray:
    """Map (I, Q) sign pairs in {-1,+1} to TX constellation points such that
    the receiver's equalizer (which normalizes by the interpolated reference
    phasor times (1+1j)/W) lands them on si + 1j*sq."""
    x = si.astype(np.float32)
    y = sq.astype(np.float32)
    return ((x + y) + 1j * (y - x)) / 2.0


def modulate_fm(
    pm_signs: np.ndarray,
    bc_seq: np.ndarray,
    psmi: int,
    px1_signs: np.ndarray | None = None,
    px2_signs: np.ndarray | None = None,
    ext_signs: np.ndarray | None = None,
    amplitude: float = 0.25,
) -> np.ndarray:
    """Modulate L1 blocks into FM baseband at 744187.5 S/s.

    pm_signs: [n_blocks*32, 720] int8 in {-1,+1}, the PM soft-bit matrix in
      demod order (lower partitions 0..9 | upper partitions 10..19, each
      18 carriers x (I,Q)).
    bc_seq: [n_blocks] block-count values transmitted on the refs.
    px1_signs/px2_signs: optional [n_blocks*32, px_row] extended-partition
      sign matrices in the demod order of src/sync.c:537-595.
    ext_signs: optional [n_blocks*32, 2*(ppb-10)*18*2] filler signs for ALL
      extended data partitions (lower band first, partitions inside-out),
      for service modes whose extended content is not decoded (cm 5/6 — the
      reference equalizes the full band but only decodes PM there,
      src/sync.c:343-357); occupancy only, never demodulated.
    Returns complex64 [n_blocks*32*2160].
    """
    n_sym, row = pm_signs.shape
    assert row == PM_ROW
    n_blocks = n_sym // C.BLKSZ
    assert pm_signs.shape[0] == n_blocks * C.BLKSZ
    ppb = C.partitions_per_band(psmi)
    cm = C.COMPATIBILITY_MODE[psmi]
    w = C.PARTITION_WIDTH_FM

    lower_refs, upper_refs, rsids = fm_ref_indices(ppb)

    spec = np.zeros((n_sym, C.FFT_FM), dtype=np.complex64)

    # reference subcarriers
    for blk in range(n_blocks):
        rows = slice(blk * C.BLKSZ, (blk + 1) * C.BLKSZ)
        for ridx in range(ppb + 1):
            signs = ref_control_signs(int(bc_seq[blk]), psmi, int(rsids[ridx]))
            bpsk = signs.astype(np.float32) * 2 - 1
            spec[rows, lower_refs[ridx]] = bpsk
            spec[rows, upper_refs[ridx]] = bpsk

    # PM data partitions (demod order: src/sync.c:514-535)
    pm = pm_signs.reshape(n_sym, 2, C.PM_PARTITIONS, C.PARTITION_DATA_CARRIERS, 2)
    for p in range(C.PM_PARTITIONS):
        for j in range(1, w):
            lo_bin = C.LB_START + p * w + j
            up_bin = C.UB_END - (C.PM_PARTITIONS - p) * w + j
            spec[:, lo_bin] = _qpsk_from_signs(pm[:, 0, p, j - 1, 0], pm[:, 0, p, j - 1, 1])
            spec[:, up_bin] = _qpsk_from_signs(pm[:, 1, p, j - 1, 0], pm[:, 1, p, j - 1, 1])

    # extended partitions (PX1/PX2; reference: src/sync.c:537-595)
    def fill_px(signs_mat, bins):
        mat = signs_mat.reshape(n_sym, len(bins), C.PARTITION_DATA_CARRIERS, 2)
        for col, base in enumerate(bins):
            for j in range(1, w):
                spec[:, base + j] = _qpsk_from_signs(
                    mat[:, col, j - 1, 0], mat[:, col, j - 1, 1])

    if px1_signs is not None:
        if cm == 2:
            bins = [C.LB_START + C.PM_PARTITIONS * w,
                    C.UB_END - (C.PM_PARTITIONS + 1) * w]
        elif cm in (3, 11):
            bins = [C.LB_START + C.PM_PARTITIONS * w,
                    C.LB_START + (C.PM_PARTITIONS + 1) * w,
                    C.UB_END - (C.PM_PARTITIONS + 2) * w,
                    C.UB_END - (C.PM_PARTITIONS + 1) * w]
        else:
            raise ValueError(f"psmi {psmi} has no PX1")
        fill_px(px1_signs, bins)
    if px2_signs is not None:
        assert cm == 11
        bins = [C.LB_START + (C.PM_PARTITIONS + 2) * w,
                C.LB_START + (C.PM_PARTITIONS + 3) * w,
                C.UB_END - (C.PM_PARTITIONS + 4) * w,
                C.UB_END - (C.PM_PARTITIONS + 3) * w]
        fill_px(px2_signs, bins)
    if ext_signs is not None:
        n_ext = ppb - C.PM_PARTITIONS
        assert n_ext > 0, f"psmi {psmi} has no extended partitions"
        bins = ([C.LB_START + (C.PM_PARTITIONS + k) * w for k in range(n_ext)]
                + [C.UB_END - (C.PM_PARTITIONS + 1 + k) * w
                   for k in range(n_ext)])
        fill_px(ext_signs, bins)

    # spectrum -> time: IFFT of the ifftshifted bins, cyclic extension,
    # raised-cosine shaping, 2160-sample symbol spacing
    time_core = np.fft.ifft(np.fft.ifftshift(spec, axes=-1), axis=-1)
    ext = np.concatenate([time_core, time_core[:, : C.CP_FM]], axis=-1)
    shape = C.ofdm_shape(C.FFT_FM, C.CP_FM)
    sig = (ext * shape[None, :]).reshape(-1)

    # normalize and conjugate (FM receive path conjugates on ingest)
    rms = np.sqrt(np.mean(np.abs(sig) ** 2))
    sig = sig * (amplitude / rms)
    return np.conj(sig).astype(np.complex64)
