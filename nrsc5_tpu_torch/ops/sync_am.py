"""AM fine sync: the tables, the complex sync block of the per-block
receivers, and the host lock logic of the AM receivers.

PyTorch counterpart of ``nrsc5_tpu/ops/sync_am.py``: its tables and
helpers (lines 37-80; pinned equal by tests/test_torch_tables.py): the
Gray level tables, the training points and rows, the Gray demaps and the
phase wraps; the QAM demaps ``qam64_map``, ``qam16_map``, ``qpsk_map`` and
the complex sync block ``sync_am_block`` with its ``train_mult`` (lines
52-213), plain PyTorch on complex64, which the per-block AM receiver and
the complex AM chain run on the CPU; on a card the block runs as kernel
K20 (:func:`sync_am_c`, ``csrc/sync_am_c.cu``: K13's kernel body with
this chain's arithmetic), batched over stations, and
:func:`sync_am_c_plain` loops :func:`sync_am_block` over the stations.
The rc chain's sync block is kernel K13 (:func:`nrsc5_tpu_torch.pipeline.
scan_chain_am_rc.sync_am_block_rc`); both kernels read the plan
:func:`sync_am_plan`.  And a numpy copy of the reference's host functions
of lines 215-269, which the cold start and the per-block receiver run on
each block's reference bits: :func:`timing_consensus`, :func:`find_ref_am` and
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
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops.acquire_rc import WINDOW_AM

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


def qam64_map(z: torch.Tensor) -> torch.Tensor:
    return gray8_map(z.real) | (gray8_map(z.imag) << 3)


def qam16_map(z: torch.Tensor) -> torch.Tensor:
    return gray4_map(z.real) | (gray4_map(z.imag) << 2)


def qpsk_map(z: torch.Tensor) -> torch.Tensor:
    return ((z.real >= 0).to(torch.uint8)
            | ((z.imag >= 0).to(torch.uint8) << 1))


@functools.lru_cache(maxsize=8)
def _am_bins(ma3: bool, device: str) -> dict:
    c = CENTER
    primary = C.OUTER_PARTITION_START_AM if not ma3 \
        else C.INNER_PARTITION_START_AM
    secondary = C.MIDDLE_PARTITION_START_AM
    tertiary = C.INNER_PARTITION_START_AM if not ma3 \
        else C.MIDDLE_PARTITION_START_AM
    col = np.arange(W)
    a_lo = np.minimum(TRAIN1, TRAIN2)  # the anchors are 16 rows apart
    tables = {
        "low": c - np.arange(C.REF_INDEX_AM, C.MAX_INDEX_AM + 1),
        "comb": np.arange(C.REF_INDEX_AM, C.PIDS_OUTER_INDEX_AM + 1),
        "pl": c - primary - col, "pu": c + primary + col,
        "s": c + secondary + col,
        "t": (c + tertiary + col) if not ma3 else (c - tertiary - col),
        "t1": TRAIN1, "t2": TRAIN2, "col": col, "a_lo": a_lo,
    }
    out = {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
           for k, v in tables.items()}
    out["u"] = ((torch.arange(32)[:, None] - out["a_lo"][None, :].cpu()
                 - 8) / 16.0).to(device)  # [32, W]
    out["colf"] = torch.arange(W, dtype=torch.float32, device=device)
    return out


def sync_am_block(spectra: torch.Tensor, ma3: bool = False) -> dict:
    """Process one AM L1 block (reference: src/sync.c:612-768).

    spectra: [32, 256] complex64 fftshifted (bin CENTER = the carrier);
    ma3: service mode MA3 (True) or MA1/hybrid (False).

    Returns a dict: ref_bits [32] uint8 (the reference subcarrier's sign
    bits, imaginary axis), pids [32, 2] uint8 (QAM16 codes, inner and
    outer), pl/pu/s/t [800] uint8 (partition codes in (symbol, column)
    order), samperr int32."""
    c = CENTER
    t = _am_bins(ma3, str(spectra.device))
    buf = spectra.clone()
    # conjugate the lower sideband (reference: src/sync.c:616-623)
    buf[:, t["low"]] = -buf[:, t["low"]].conj()
    if not ma3:
        # complementary combine into the upper sideband (src/sync.c:625-633)
        buf[:, c + t["comb"]] += buf[:, c - t["comb"]]

    ref_bits = (buf[:, c + C.REF_INDEX_AM].imag > 0).to(torch.uint8)

    # PIDS (QAM16)
    pids1_bin = c + (C.PIDS_INNER_INDEX_AM if not ma3
                     else -C.PIDS_INNER_INDEX_AM)
    pids2_bin = c + (C.PIDS_OUTER_INDEX_AM if not ma3
                     else C.PIDS_INNER_INDEX_AM)
    p1col, p2col = buf[:, pids1_bin], buf[:, pids2_bin]
    p1m = 2 * TRAIN_QAM16 / (p1col[8] + p1col[24])
    p2m = 2 * TRAIN_QAM16 / (p2col[8] + p2col[24])
    pids = torch.stack([qam16_map(p1col * p1m), qam16_map(p2col * p2m)],
                       dim=1)

    col = t["col"]

    def train_mult(bins, nominal):
        cols = buf[:, bins]  # [32, W]
        tr = cols[t["t1"], col] + cols[t["t2"], col]
        return 2 * nominal / tr  # [W]

    pl_mult = train_mult(t["pl"], TRAIN_QAM64)
    pu_mult = train_mult(t["pu"], TRAIN_QAM64)
    s_mult = train_mult(t["s"], TRAIN_QAM64 if ma3 else TRAIN_QAM16)
    t_mult = train_mult(t["t"], TRAIN_QAM64 if ma3 else TRAIN_QPSK)

    # sample clock error from the phase slope across the primary columns
    # (reference: src/sync.c:717-723)
    dp = _wrap_half_pi(torch.angle(pl_mult[1:])
                       - torch.angle(pl_mult[:-1])).sum()
    du = _wrap_half_pi(torch.angle(pu_mult[1:])
                       - torch.angle(pu_mult[:-1])).sum()
    samperr = (dp + du) / (2 * (W - 1)) * C.FFT_AM / (2 * math.pi)
    samperr = torch.round(samperr).to(torch.int32)

    # the interpolated training equalizer (the reference's AM_EQ_INTERP
    # default): a per-row mult anchored at the training midpoint, the
    # anchor-to-anchor phase delta fitted linearly across the partition's
    # columns (weights: the anchors' magnitudes) and spread across rows
    a_lo, u, colf = t["a_lo"], t["u"], t["colf"]

    def rows_mult(bins, base):
        cols = buf[:, bins]
        lo, hi = cols[a_lo, col], cols[a_lo + 16, col]
        dphi = _wrap_pi(torch.angle(lo) - torch.angle(hi))  # [W]
        w = lo.abs() * hi.abs() + 1e-12
        wsum = w.sum()
        cbar = (w * colf).sum() / wsum
        dbar = (w * dphi).sum() / wsum
        b = (w * (colf - cbar) * (dphi - dbar)).sum() \
            / ((w * (colf - cbar) ** 2).sum() + 1e-12)
        fit = dbar + b * (colf - cbar)  # [W]
        return base[None, :] * torch.exp(1j * u * fit[None, :])

    pl_eq = buf[:, t["pl"]] * rows_mult(t["pl"], pl_mult)
    pu_eq = buf[:, t["pu"]] * rows_mult(t["pu"], pu_mult)
    s_eq = buf[:, t["s"]] * rows_mult(t["s"], s_mult)
    t_eq = buf[:, t["t"]] * rows_mult(t["t"], t_mult)

    pl_c, pu_c = qam64_map(pl_eq), qam64_map(pu_eq)
    if not ma3:
        s_c, t_c = qam16_map(s_eq), qpsk_map(t_eq)
    else:
        s_c, t_c = qam64_map(s_eq), qam64_map(t_eq)
    return {"ref_bits": ref_bits, "pids": pids, "pl": pl_c.reshape(-1),
            "pu": pu_c.reshape(-1), "s": s_c.reshape(-1),
            "t": t_c.reshape(-1), "samperr": samperr}


# ---------------------------------------------------------------------------
# K13 and K20: the plan of a station's four CTAs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def partitions(ma3: bool) -> tuple:
    """The four data partitions in output order (pl, pu, s, t): one
    ``(first bin, bin step, training point, levels)`` each, levels 8
    (QAM64), 4 (QAM16) or 2 (QPSK); and the two PIDS bins."""
    c = CENTER
    primary = C.OUTER_PARTITION_START_AM if not ma3 \
        else C.INNER_PARTITION_START_AM
    secondary = C.MIDDLE_PARTITION_START_AM
    tertiary = C.INNER_PARTITION_START_AM if not ma3 \
        else C.MIDDLE_PARTITION_START_AM
    if ma3:
        parts = ((c - primary, -1, TRAIN_QAM64, 8),
                 (c + primary, 1, TRAIN_QAM64, 8),
                 (c + secondary, 1, TRAIN_QAM64, 8),
                 (c - tertiary, -1, TRAIN_QAM64, 8))
        pids = (c - C.PIDS_INNER_INDEX_AM, c + C.PIDS_INNER_INDEX_AM)
    else:
        parts = ((c - primary, -1, TRAIN_QAM64, 8),
                 (c + primary, 1, TRAIN_QAM64, 8),
                 (c + secondary, 1, TRAIN_QAM16, 4),
                 (c + tertiary, 1, TRAIN_QPSK, 2))
        pids = (c + C.PIDS_INNER_INDEX_AM, c + C.PIDS_OUTER_INDEX_AM)
    return parts, pids


# K13's and K20's plan: ints a CTA (csrc/sync_am_block.cuh's Plan)
PLAN_INTS = 12
# the extras of a station's four CTAs (pl, pu, s, t): the CTA that demaps
# PIDS column k (either mode), the one that writes the reference bits
# (MA1, MA3), each beside its partition's bins so that its reads stay two
# contiguous runs a row; pl forms samperr from its own mults and pu's,
# which it forms again from pu's training rows
_PIDS_CTA = (3, 2)
_REF_CTA = {False: 3, True: 1}


@functools.lru_cache(maxsize=2)
def sync_am_plan(ma3: bool) -> np.ndarray:
    """K13's and K20's plan, int32 [4, PLAN_INTS]: for each CTA of a station (one a
    partition, pl, pu, s, t) its partition's first bin, bin step, levels
    and twice its training point (re, im); the PIDS bin it demaps (-1:
    none) and that column's index; 1 where it writes the reference bits;
    and, for the CTA that forms samperr, the other primary partition's
    first bin, step and twice its training point (-1: none).  The kernel
    reads it by value, so it is the only statement of which CTA reads
    what."""
    parts, pids = partitions(ma3)
    plan = np.full((4, PLAN_INTS), -1, np.int32)
    for p, (first, step, nominal, levels) in enumerate(parts):
        plan[p, :5] = (first, step, levels, round(2 * nominal.real),
                       round(2 * nominal.imag))
        plan[p, 7] = int(p == _REF_CTA[ma3])
    for k, (p, b) in enumerate(zip(_PIDS_CTA, pids)):
        plan[p, 5:7] = b, k
    first, step, nominal, _ = parts[1]
    plan[0, 8:] = (first, step, round(2 * nominal.real),
                   round(2 * nominal.imag))
    return plan



# ---------------------------------------------------------------------------
# K20: the sync block batched over stations
# ---------------------------------------------------------------------------

_PARTS = ("pl", "pu", "s", "t")


def sync_am_c_shapes(s: int) -> dict:
    """{key: (shape, dtype)} of K20's outputs for ``s`` stations."""
    return {"codes": ((s, 4, C.BLKSZ * W), torch.uint8),
            "pids": ((s, C.BLKSZ, 2), torch.uint8),
            "ref_bits": ((s, C.BLKSZ), torch.uint8),
            "samperr": ((s,), torch.int32)}


def sync_am_c_plain(spectra: torch.Tensor, ma3: bool = False, carry=None):
    """Plain version of K20: :func:`sync_am_block` for each station.
    spectra [S, 32, 256] complex64.  ``carry`` (the block loop's (keep,
    offset, samperr_next) int32 [S], else None): the loop's carry step, in
    place, ``offset += WINDOW_AM - keep`` and ``samperr_next =
    FFTCP_AM // 2 + samperr``.  Returns ``codes`` uint8 [S, 4, 800] (pl,
    pu, s, t), ``pids`` uint8 [S, 32, 2], ``ref_bits`` uint8 [S, 32] and
    ``samperr`` int32 [S]."""
    rows = [sync_am_block(x, ma3) for x in spectra]
    out = {"codes": torch.stack([torch.stack([r[k] for k in _PARTS])
                                 for r in rows]),
           **{k: torch.stack([r[k] for r in rows])
              for k in ("pids", "ref_bits", "samperr")}}
    if carry is not None:
        keep, offset, samperr_next = carry
        offset.add_(WINDOW_AM - keep)
        samperr_next.copy_(C.FFTCP_AM // 2 + out["samperr"])
    return out


def sync_am_c(spectra: torch.Tensor, ma3: bool = False, carry=None,
              out=None) -> dict:
    """K20: the arguments and results of :func:`sync_am_c_plain`, written
    into ``out`` (a dict of every key it returns) where it is given.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (K13's four CTAs a station, one a partition, on the bins
    :func:`sync_am_plan` gives each, with the complex chain's division and
    fit weights; with ``carry``, thread 0 of a station's first CTA adds to
    its offset and the lane that forms samperr sets the next block's)."""
    if spectra.device.type == "cpu":
        res = sync_am_c_plain(spectra, ma3, carry)
        return res if out is None else K.into(out, res)
    if spectra.ndim != 3 or spectra.shape[1:] != (C.BLKSZ, C.FFT_AM):
        raise ValueError(f"spectra: expected [S, {C.BLKSZ}, {C.FFT_AM}], "
                         f"got {tuple(spectra.shape)}")
    K.check(spectra, "spectra", torch.complex64)
    s, dev = spectra.shape[0], spectra.device
    shapes = sync_am_c_shapes(s)
    if out is None:
        out = {k: torch.empty(shape, dtype=dtype, device=dev)
               for k, (shape, dtype) in shapes.items()}
    if set(out) != set(shapes):
        raise ValueError(f"out: expected keys {sorted(shapes)}, got "
                         f"{sorted(out)}")
    for k, (shape, dtype) in shapes.items():
        K.check(out[k], k, dtype, shape)
    step = (None, None, None)
    if carry is not None:
        for name, t in zip(("keep", "offset", "samperr_next"), carry):
            K.check(t, name, torch.int32, (s,))
        step = tuple(t.data_ptr() for t in carry)
    K.launch("sync_am_c", spectra.data_ptr(),
             sync_am_plan(bool(ma3)).ctypes.data,
             *(out[k].data_ptr() for k in ("codes", "pids", "ref_bits",
                                           "samperr")),
             s, int(ma3), *step, WINDOW_AM, C.FFTCP_AM // 2, device=dev)
    return out


def sync_am_step(spectra: torch.Tensor, ma3: bool = False) -> dict:
    """One station's block as :func:`sync_am_block` takes and returns it
    (the per-block receiver's call): the plain version on a CPU tensor,
    K20 at one station on a CUDA tensor."""
    if spectra.device.type == "cpu":
        return sync_am_block(spectra, ma3)
    out = sync_am_c(spectra[None], ma3)
    return {"ref_bits": out["ref_bits"][0], "pids": out["pids"][0],
            **{k: out["codes"][0, i] for i, k in enumerate(_PARTS)},
            "samperr": out["samperr"][0]}


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
