"""Multi-station serving, device half: the FM and AM cold starts and the
steady-state FM and AM dispatches.

Counterpart of the device side of ``nrsc5_tpu/serve.py``'s
``MultiStationReceiver``: its ingest (lines 308-324: cu8, cs16 or cf32 in
either mode), the device half of its cold starts ``_try_relock`` (lines
820-861, FM) and ``_try_relock_am`` (lines 789-817) for a station batch,
and its steady dispatch ``_chain`` (lines 401-404 FM, 420-421 AM), which
runs the batched chain on the ingested wire.  The receiver class around it
(sample queues, transports, events, the per-station frame alignment after
an FM lock, the AM diversity warm-up skip and relock watchdog) is not
ported yet.

The native wire is the reference's 1.488 MS/s cu8 format.  Each station's
row holds ``rc_overlap(stages) // 2`` pairs of history ahead of its logical
stream position (127-valued at stream start, :func:`stream_wire`), so the
stateless halfband cascade has zero net group delay: 7 pairs for FM's ÷2
(then ``2 · buffer_len(n_blocks)`` pairs), 217 for AM's ÷32 (then ``32 ·
am_buffer_len(n_frames)``).  A 1.488 MS/s cu8 AM capture does not reach
sync through the ÷32 cascade, whose response spans the whole 14-sample
cyclic prefix (tests/test_l1_am.py:92-100), a property the reference
shares; AM captures are normally cs16 at the chain's own 46511.7 S/s.
cs16 is scaled by 1/32768 and cf32, rc float32, passes through, in either
mode, at the chain's own rate.
"""

from __future__ import annotations

import numpy as np
import torch

from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import decode_am as DA
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len


def wire_pairs(n_blocks: int) -> int:
    """cu8 pairs per station that one FM dispatch of ``n_blocks`` reads."""
    return FE.rc_overlap(1) + 2 * buffer_len(n_blocks)


def ingest(wire, mode: str = "fm", *, device="cuda",
           plain: bool = False) -> torch.Tensor:
    """Wire [S, L, 2] (array or tensor) -> chain input float32 [S, N, 2] on
    ``device``, by the wire's dtype:

    - uint8, cu8 at 1.488 MS/s: (u − 127)·64/32767, then for
      ``mode="fm"`` Q negated and the ÷2 halfband (K1; L = 14 + 2N), for
      ``mode="am"`` × 1/16 and the five-stage ÷32 cascade (K1's AM
      cascade; L = 434 + 32N); ``plain=True`` runs the plain versions;
    - int16, cs16 at the chain's rate: × 1/32768, exact (a power of two);
    - float32, cf32 rc at the chain's rate: passes through unchanged."""
    if mode not in ("fm", "am"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = K.resolve_device(device)
    wire = torch.as_tensor(wire, device=dev)
    if wire.ndim != 3 or wire.shape[-1] != 2:
        raise ValueError(f"wire: expected [S, L, 2], got "
                         f"{tuple(wire.shape)}")
    if wire.dtype == torch.float32:
        return wire
    if wire.dtype == torch.int16:
        return wire.float() * (1.0 / 32768.0)
    if wire.dtype != torch.uint8:
        raise ValueError(f"wire dtype {wire.dtype}: expected uint8 (cu8), "
                         f"int16 (cs16) or float32 (cf32)")
    if mode == "am":
        return (FE.ingest_am_cu8_plain if plain else FE.ingest_am_cu8)(wire)
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


def chain_step_am(wire, carries: scar.AMChainCarryRC, n_frames: int,
                  ma3: bool = False, packed: bool = False, *,
                  device="cuda", plain: bool = False):
    """One AM dispatch for all stations: a wire of :func:`ingest`'s with at
    least am_buffer_len(n_frames) chain samples a station (cs16 [S,
    am_buffer_len(n_frames), 2] as the reference serves it) -> (out, new
    carries), with ``out`` as
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.am_chain_batch_rc`
    gives it.  The carries must lie on ``device``; ``new.offset`` holds the
    chain samples each station consumed (the caller advances its queue by
    that many chain samples and rebases the offset to 0, as the reference
    receiver does).  ``plain=True`` runs every kernel's plain version."""
    samples = ingest(wire, "am", device=device, plain=plain)
    return scar.am_chain_batch_rc(samples, carries, n_frames, ma3, packed,
                                  plain=plain)


def cold_start(wire, mode: str = "fm", *, device="cuda",
               plain: bool = False) -> list:
    """Cold start of every station of a capture with unknown timing and
    CFO: a wire of :func:`ingest`'s (FM: cu8 [S, 14 + 2N, 2] in
    :func:`chain_step`'s layout; AM: cs16 [S, N, 2], or cu8 [S, 434 + 32N,
    2]) -> one lock per station, or None where a station did not lock
    (FM: :func:`nrsc5_tpu_torch.pipeline.scan_chain_rc.cold_start_rc`; AM:
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.cold_start_am_rc`).
    Each lock's ``offset`` counts chain samples from the start of the
    station's stream.  ``plain=True`` runs every kernel's plain version."""
    samples = ingest(wire, mode, device=device, plain=plain)
    if mode == "am":
        return scar.cold_start_am_rc(samples, device=device, plain=plain)
    return rcc.cold_start_rc(samples, device=device, plain=plain)


def carry_from_locks(locks: list) -> tuple:
    """Stack the locks of :func:`cold_start` into one carry whose offsets
    are the lock points, so that :func:`chain_step` (FM) or
    :func:`chain_step_am` (AM) on the same wire decodes every station from
    its lock.  Returns (carry, psmi, first_bc) for FM locks and (carry,
    ma3) for AM locks (those with an ``"ma3"`` key).

    One dispatch serves one service mode (and, for FM, one block count:
    the per-station frame alignment is not ported yet), so this raises if a
    station did not lock, if the locks mix FM and AM, or if they disagree
    on psmi and first_bc (FM) or ma3 (AM, as the reference receiver
    asserts)."""
    missing = [i for i, lock in enumerate(locks) if lock is None]
    if not locks or missing:
        raise ValueError(f"stations {missing} did not lock")
    kinds = {"ma3" in lock for lock in locks}
    if len(kinds) > 1:
        raise ValueError("the locks mix FM and AM")
    am = kinds.pop()
    for key in ("ma3",) if am else ("psmi", "first_bc"):
        values = sorted({lock[key] for lock in locks})
        if len(values) > 1:
            raise ValueError(f"the locks disagree on {key}: {values}")
    carries = [lock["carry"] for lock in locks]
    offset = torch.tensor([lock["offset"] for lock in locks],
                          dtype=torch.int32, device=carries[0].offset.device)
    if am:
        carry = scar.AMChainCarryRC(
            *(torch.stack(leaves) for leaves in zip(*(c[:-1]
                                                      for c in carries))),
            dec=DA.AMDecodeState(*(torch.stack(lines) for lines in zip(
                *(c.dec for c in carries)))))
        return carry._replace(offset=offset), locks[0]["ma3"]
    carry = rcc.ChainCarryRC(*(torch.stack(leaves)
                               for leaves in zip(*carries)))
    return (carry._replace(offset=offset), locks[0]["psmi"],
            locks[0]["first_bc"])


def stream_wire(station_cu8: np.ndarray, stages: int = 1) -> np.ndarray:
    """One station's interleaved cu8 stream -> its [rc_overlap(stages) // 2
    + n, 2] queue with the 127-valued history pairs ahead of it (the
    reference receiver's initial queue, serve.py:301-303): 7 pairs for
    FM's one stage, 217 for AM's five."""
    pairs = np.asarray(station_cu8, np.uint8).reshape(-1, 2)
    head = np.full((FE.rc_overlap(stages) // 2, 2), 127, np.uint8)
    return np.concatenate([head, pairs])
