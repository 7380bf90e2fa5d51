"""Integer-CFO + block-offset search of the FM cold start, kernel K10, and
the per-block receiver's complex scan.

PyTorch counterpart of ``nrsc5_tpu/ops/acquire_rc.py:detect_cfo_scan_rc``
(lines 114-157) and of ``nrsc5_tpu/ops/detect_cfo.py`` (the tables
``CFO_RANGE``, ``N_REFS``, ``_needle_tables``, lines 21-41, pinned equal
by tests/test_torch_tables.py; and :func:`detect_cfo_scan`, line 45, the
per-block receiver's scan on one block's complex spectra, plain PyTorch
through :func:`nrsc5_tpu_torch.ops.sync_fm.costas_track`).  For every
station, all 76 candidate CFOs × 22 reference subcarriers run as
lockstep Costas tracks (the PLL of
:mod:`nrsc5_tpu_torch.ops.costas`, with the static per-track frequency of
each CFO), and the needle count matches each track's 32 signs, cyclically
shifted by each of the 32 block offsets, against the reference control
needles.  On the card both run in one kernel, ``csrc/cfo_scan.cu``, from
the spectra to the count; the plain path runs the PLL's plain version and
:func:`needle_count_plain`.  The host then takes the argmax of the count
table (:func:`nrsc5_tpu_torch.pipeline.scan_chain_rc.cold_start_rc`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import sync_fm as SF
from nrsc5_tpu_torch.ops.costas import TWO_PI, costas_track_rc_plain

CFO_RANGE = 2 * C.PARTITION_WIDTH_FM  # +-38 bins
N_REFS = C.PM_PARTITIONS + 1  # 11 refs per sideband
N_CFO = 2 * CFO_RANGE
N_TRACKS = N_CFO * 2 * N_REFS  # 1672 tracks per station
# the first bin of each sideband's run: every bin the scan reads lies in
# [LB_FIRST, LB_FIRST + RUN) or [UB_FIRST, UB_FIRST + RUN)
LB_FIRST = C.LB_START - CFO_RANGE  # 440
UB_FIRST = C.UB_END - CFO_RANGE - C.PARTITION_WIDTH_FM * (N_REFS - 1)  # 1342
RUN = N_CFO + C.PARTITION_WIDTH_FM * (N_REFS - 1)  # 266


def _needle_tables():
    """(vals uint8 [22, 32], known bool [22, 32]) for refs i=0..10 on both
    sidebands (rsid = (30-i) & 3): the sync block's needles at the PM
    partition count."""
    return SF._needles(C.PM_PARTITIONS)


@functools.lru_cache(maxsize=4)
def _scan_tables(device: str) -> dict:
    cfos = np.arange(-CFO_RANGE, CFO_RANGE, dtype=np.int32)
    i = np.arange(N_REFS, dtype=np.int32)
    bins_l = C.LB_START + cfos[:, None] + C.PARTITION_WIDTH_FM * i[None, :]
    bins_u = C.UB_END + cfos[:, None] - C.PARTITION_WIDTH_FM * i[None, :]
    bins = np.concatenate([bins_l, bins_u], axis=1)  # [76, 22]
    # 2*pi*cfo*CP/FFT in float32, in the reference's operation order, one
    # a CFO (the plain scan repeats it over the CFO's 22 refs, jnp.repeat)
    cfo_freq = (np.float32(2 * np.pi) * cfos.astype(np.float32)
                * np.float32(C.CP_FM) / np.float32(C.FFT_FM))
    vals, known = _needle_tables()
    vals_mask, known_mask = SF.needle_masks(C.PM_PARTITIONS)
    tables = {
        "bins": bins.reshape(-1).astype(np.int64),
        "cfo_freq": cfo_freq,
        "vals": np.ascontiguousarray(vals.T.astype(bool)),  # [32, 22]
        "known": np.ascontiguousarray(known.T),
        "vals_mask": vals_mask,
        "known_mask": known_mask,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in tables.items()}


def _check_derot(derot):
    if derot.ndim != 4 or derot.shape[0] != C.BLKSZ \
            or derot.shape[2] != N_TRACKS or derot.shape[3] != 2:
        raise ValueError(f"derot: expected [{C.BLKSZ}, S, {N_TRACKS}, 2], "
                         f"got {tuple(derot.shape)}")


def needle_count_plain(derot):
    """Plain version of the needle count.  derot: float32
    [32, S, 1672, 2], K3's step-major output (track = cfo·22 + ref).
    Returns count int32 [S, 76, 32]: count[s, c, o] = the refs whose signs,
    shifted cyclically by o, match their needle (or its complement) at
    every known position, under CFO c − 38 bins."""
    _check_derot(derot)
    s = derot.shape[1]
    t = _scan_tables(str(derot.device))
    signs = (derot[..., 0] > 0).reshape(C.BLKSZ, s, N_CFO, 2 * N_REFS)
    n = torch.arange(C.BLKSZ, device=derot.device)
    sh = signs[(n[None, :] + n[:, None]) % C.BLKSZ]  # [o, n, S, 76, 22]
    vals = t["vals"][None, :, None, None, :]
    known = t["known"][None, :, None, None, :]
    match = torch.where(known, sh == vals, True).all(dim=1) \
        | torch.where(known, sh != vals, True).all(dim=1)
    count = match.sum(dim=-1, dtype=torch.int32)  # [o, S, 76]
    return count.permute(1, 2, 0).contiguous()


def needle_count(derot):
    """The needle count: the argument and result of
    :func:`needle_count_plain`, which a CPU tensor takes.  On the card the
    count runs inside K10 (:func:`detect_cfo_scan_rc`), from the spectra:
    a CUDA tensor raises."""
    if derot.device.type == "cpu":
        return needle_count_plain(derot)
    raise ValueError("needle_count: on the card the needle count runs "
                     "inside K10 (detect_cfo_scan_rc, csrc/cfo_scan.cu); "
                     "it takes no derot from device memory")


def _check_spectra(spectra):
    if spectra.ndim != 4 or spectra.shape[1:] != (C.BLKSZ, C.FFT_FM, 2):
        raise ValueError(f"spectra: expected [S, {C.BLKSZ}, {C.FFT_FM}, 2],"
                         f" got {tuple(spectra.shape)}")


def detect_cfo_scan_rc_plain(spectra):
    """Plain version of K10: the arguments and result of
    :func:`detect_cfo_scan_rc`, through the PLL's plain version
    (step-major tracks, track = cfo·22 + ref) and
    :func:`needle_count_plain`."""
    _check_spectra(spectra)
    s = spectra.shape[0]
    t = _scan_tables(str(spectra.device))
    # stations × CFOs × refs as independent tracks, step-major
    refs = spectra[:, :, t["bins"]].transpose(0, 1).reshape(
        C.BLKSZ, s * N_TRACKS, 2).contiguous()
    cfo_freq = t["cfo_freq"].repeat_interleave(2 * N_REFS).repeat(s)
    zeros = torch.zeros_like(cfo_freq)
    derot = costas_track_rc_plain(refs, zeros, zeros, cfo_freq)[0]
    return needle_count_plain(derot.view(C.BLKSZ, s, N_TRACKS, 2))


def detect_cfo_scan_rc(spectra, plain: bool = False):
    """K10.  spectra: float32 [S, 32, 2048, 2] (one block of each station,
    demodulated with CFO 0).  Returns count int32 [S, 76, 32], each
    station's table as the reference's ``detect_cfo_scan_rc`` gives it.

    A CPU tensor (or ``plain``) takes :func:`detect_cfo_scan_rc_plain`; a
    CUDA tensor launches ``csrc/cfo_scan.cu`` once (a CTA a station and
    CFO residue mod 19, the tracks' PLL and the needle count in shared
    memory), reading the spectra in place."""
    if plain or spectra.device.type == "cpu":
        return detect_cfo_scan_rc_plain(spectra)
    _check_spectra(spectra)
    K.check(spectra, "spectra", torch.float32)
    s = spectra.shape[0]
    t = _scan_tables(str(spectra.device))
    count = torch.empty(s, N_CFO, C.BLKSZ, dtype=torch.int32,
                        device=spectra.device)
    K.launch("cfo_scan", spectra.data_ptr(), t["cfo_freq"].data_ptr(),
             t["vals_mask"].data_ptr(), t["known_mask"].data_ptr(),
             count.data_ptr(), s, C.FFT_FM, LB_FIRST, UB_FIRST, SF.ALPHA,
             SF.BETA, TWO_PI, device=spectra.device)
    return count


def detect_cfo_scan(spectra):
    """The per-block receiver's scan.  spectra: [32, 2048] complex64 (one
    block, demodulated at the receiver's current CFO).  Returns count
    int32 [76, 32]: count[c, o] = the reference subcarriers whose sign
    sequence, shifted cyclically by block offset o, matches the control
    needle (or its complement) under CFO (c - 38) bins."""
    t = _scan_tables(str(spectra.device))
    refs = spectra[:, t["bins"]]  # [32, 76 * 22]
    cfo_flat = t["cfo_freq"].repeat_interleave(2 * N_REFS)
    zeros = torch.zeros_like(cfo_flat)
    derot = SF.costas_track(refs, zeros, zeros, cfo_flat)[0]
    signs = (derot.real > 0).reshape(C.BLKSZ, N_CFO, 2 * N_REFS)
    n = torch.arange(C.BLKSZ, device=spectra.device)
    sh = signs[(n[None, :] + n[:, None]) % C.BLKSZ]  # [o, n, 76, 22]
    vals = t["vals"][None, :, None, :]
    known = t["known"][None, :, None, :]
    match = torch.where(known, sh == vals, True).all(dim=1) \
        | torch.where(known, sh != vals, True).all(dim=1)
    return match.sum(dim=-1, dtype=torch.int32).T.contiguous()  # [76, 32]
