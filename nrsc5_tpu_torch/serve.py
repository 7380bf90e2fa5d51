"""Multi-station serving, device half: the FM cold start and the
steady-state FM and AM dispatches.

Counterpart of the device side of ``nrsc5_tpu/serve.py``'s
``MultiStationReceiver``: its ingest (lines 308-324: cu8 for FM, cs16 for
AM), the device half of its cold start ``_try_relock`` (lines 820-861)
for a station batch, and its steady dispatch ``_chain`` (lines 401-404
FM, 420-421 AM), which runs the batched chain on the ingested wire.  The
receiver class around it (sample queues, transports, events, the
per-station frame alignment after a lock, the AM diversity warm-up skip)
is not ported yet.

The FM wire is the reference's native 1.488 MS/s cu8 format.  Each
station's row holds ``rc_overlap(1) // 2 = 7`` pairs of history ahead of
its logical stream position (127-valued at stream start), so the
stateless ÷2 halfband has zero net group delay, and ``2 ·
buffer_len(n_blocks)`` pairs after it.  The AM wire is cs16 at the chain's
own 46511.7 S/s, ``am_buffer_len(n_frames)`` pairs a station: the ÷32
cascade from a 1.488 MS/s cu8 AM capture spans the whole 14-sample AM
cyclic prefix and does not reach sync (tests/test_l1_am.py:92-100), so
the port ingests AM from cs16 only.
"""

from __future__ import annotations

import numpy as np
import torch

from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len


def wire_pairs(n_blocks: int) -> int:
    """cu8 pairs per station that one dispatch of ``n_blocks`` reads."""
    return FE.rc_overlap(1) + 2 * buffer_len(n_blocks)


def ingest(wire, mode: str = "fm", *, device="cuda",
           plain: bool = False) -> torch.Tensor:
    """Wire -> chain input float32 [S, N, 2] on ``device``.

    ``mode="fm"``: cu8 wire [S, 14 + 2N, 2] (uint8 array or tensor),
    (u − 127)·64/32767, Q negated, ÷2 halfband — kernel K1, or its plain
    version with ``plain=True``.  ``mode="am"``: cs16 wire [S, N, 2]
    (int16) scaled by 1/32768, exact (a power of two)."""
    if mode not in ("fm", "am"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = K.resolve_device(device)
    wire = torch.as_tensor(wire, device=dev)
    if mode == "am":
        if wire.dtype != torch.int16:
            raise NotImplementedError(
                "the port ingests AM from cs16 only: a 1.488 MS/s cu8 AM "
                "capture does not reach sync through the ÷32 halfband "
                "cascade, whose response spans the whole 14-sample cyclic "
                "prefix")
        if wire.ndim != 3 or wire.shape[-1] != 2:
            raise ValueError(f"cs16 wire: expected [S, N, 2], got "
                             f"{tuple(wire.shape)}")
        return wire.float() * (1.0 / 32768.0)
    return (FE.ingest_fm_cu8_plain if plain else FE.ingest_fm_cu8)(wire)


def chain_step(wire_u8, carries: rcc.ChainCarryRC, n_blocks: int,
               psmi: int = 1, first_bc: int = 0, packed: bool = False, *,
               device="cuda", plain: bool = False):
    """One dispatch for all stations: cu8 wire [S, wire_pairs(n_blocks), 2]
    -> (out, new carries), with ``out`` as
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_rc.fm_chain_batch_rc` gives
    it.  The carries must lie on ``device``; ``new.offset`` holds the chain
    samples each station consumed (the caller advances its queue by twice
    that many wire pairs and rebases the offset to 0, as the reference
    receiver does).  ``plain=True`` runs every kernel's plain version."""
    samples = ingest(wire_u8, device=device, plain=plain)
    return rcc.fm_chain_batch_rc(samples, carries, n_blocks, psmi, first_bc,
                                 packed, plain=plain)


def chain_step_am(wire_i16, carries: scar.AMChainCarryRC, n_frames: int,
                  ma3: bool = False, packed: bool = False, *,
                  device="cuda", plain: bool = False):
    """One AM dispatch for all stations: cs16 wire [S, am_buffer_len(
    n_frames), 2] -> (out, new carries), with ``out`` as
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.am_chain_batch_rc`
    gives it.  The carries must lie on ``device``; ``new.offset`` holds the
    chain samples each station consumed (the caller advances its queue by
    that many pairs and rebases the offset to 0, as the reference receiver
    does).  ``plain=True`` runs every kernel's plain version."""
    samples = ingest(wire_i16, "am", device=device, plain=plain)
    return scar.am_chain_batch_rc(samples, carries, n_frames, ma3, packed,
                                  plain=plain)


def cold_start(wire_u8, *, device="cuda", plain: bool = False) -> list:
    """Cold start of every station of a cu8 capture with unknown timing
    and CFO: wire [S, 14 + 2N, 2] in :func:`chain_step`'s layout -> one
    lock per station (:func:`nrsc5_tpu_torch.pipeline.scan_chain_rc.
    cold_start_rc`), or None where a station did not lock.  Each lock's
    ``offset`` counts chain samples from the start of the station's wire.
    ``plain=True`` runs every kernel's plain version."""
    samples = ingest(wire_u8, device=device, plain=plain)
    return rcc.cold_start_rc(samples, device=device, plain=plain)


def carry_from_locks(locks: list) -> tuple[rcc.ChainCarryRC, int, int]:
    """Stack the locks of :func:`cold_start` into one carry whose offsets
    are the lock points, so that :func:`chain_step` on the same wire
    decodes every station from its lock.  Returns (carry, psmi, first_bc).

    One dispatch serves one service mode and one block count, and the
    per-station frame alignment is not ported yet, so this raises if a
    station did not lock or if the locks disagree on psmi or first_bc."""
    missing = [i for i, lock in enumerate(locks) if lock is None]
    if not locks or missing:
        raise ValueError(f"stations {missing} did not lock")
    for key in ("psmi", "first_bc"):
        values = sorted({lock[key] for lock in locks})
        if len(values) > 1:
            raise ValueError(f"the locks disagree on {key}: {values}")
    carry = rcc.ChainCarryRC(*(torch.stack(leaves) for leaves in zip(
        *(lock["carry"] for lock in locks))))
    offset = torch.tensor([lock["offset"] for lock in locks],
                          dtype=torch.int32, device=carry.offset.device)
    return (carry._replace(offset=offset), locks[0]["psmi"],
            locks[0]["first_bc"])


def stream_wire(station_cu8: np.ndarray) -> np.ndarray:
    """One station's interleaved cu8 stream -> its [7 + n, 2] queue with
    the 127-valued history pairs ahead of it (the reference receiver's
    initial queue, serve.py:301-303)."""
    pairs = np.asarray(station_cu8, np.uint8).reshape(-1, 2)
    head = np.full((FE.rc_overlap(1) // 2, 2), 127, np.uint8)
    return np.concatenate([head, pairs])
