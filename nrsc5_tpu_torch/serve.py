"""Multi-station serving, device half: the steady-state FM dispatch.

Counterpart of the device side of ``nrsc5_tpu/serve.py``'s
``MultiStationReceiver``: its cu8 ingest (lines 308-324) and its steady
dispatch ``_chain`` (lines 401-404), which runs the batched chain on the
ingested wire.  The receiver class around it (sample queues, transports,
events, cold start) is not ported yet.

The wire is the reference's native 1.488 MS/s cu8 format.  Each station's
row holds ``rc_overlap(1) // 2 = 7`` pairs of history ahead of its logical
stream position (127-valued at stream start), so the stateless ÷2 halfband
has zero net group delay, and ``2 · buffer_len(n_blocks)`` pairs after it.
"""

from __future__ import annotations

import numpy as np
import torch

from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len


def wire_pairs(n_blocks: int) -> int:
    """cu8 pairs per station that one dispatch of ``n_blocks`` reads."""
    return FE.rc_overlap(1) + 2 * buffer_len(n_blocks)


def ingest(wire_u8, mode: str = "fm", *, device="cuda",
           plain: bool = False) -> torch.Tensor:
    """cu8 wire [S, 14 + 2N, 2] (uint8 array or tensor) -> FM chain input
    float32 [S, N, 2] on ``device``: (u − 127)·64/32767, Q negated, ÷2
    halfband — kernel K1, or its plain version with ``plain=True``."""
    if mode != "fm":
        raise NotImplementedError("the port ingests FM only (AM comes later)")
    dev = K.resolve_device(device)
    wire = torch.as_tensor(wire_u8, device=dev)
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


def stream_wire(station_cu8: np.ndarray) -> np.ndarray:
    """One station's interleaved cu8 stream -> its [7 + n, 2] queue with
    the 127-valued history pairs ahead of it (the reference receiver's
    initial queue, serve.py:301-303)."""
    pairs = np.asarray(station_cu8, np.uint8).reshape(-1, 2)
    head = np.full((FE.rc_overlap(1) // 2, 2), 127, np.uint8)
    return np.concatenate([head, pairs])
