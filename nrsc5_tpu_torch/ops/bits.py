"""Bit packing for decoded-frame outputs.

PyTorch counterpart of ``nrsc5_tpu/ops/bits.py``: decoded frames are
bits-as-bytes, so packing them 8-to-a-byte on the device before they are
copied to the host moves an eighth of the bytes.  Little-endian bit order
within each byte, matching ``np.unpackbits(..., bitorder="little")``.
"""

from __future__ import annotations

import numpy as np
import torch

PACKED_KEYS = ("p1", "pids")


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., T] uint8 bits (T % 8 == 0) -> [..., T//8] uint8 bytes."""
    t = bits.shape[-1]
    assert t % 8 == 0, t
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (bits.reshape(bits.shape[:-1] + (t // 8, 8))
            << shifts).sum(-1).to(torch.uint8)


def unpack_bits(packed) -> np.ndarray:
    """Host inverse: [..., T//8] uint8 bytes -> [..., T] uint8 bits."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    return np.unpackbits(np.asarray(packed), axis=-1, bitorder="little")


def pack_out(out: dict) -> dict:
    """Pack the decoded-bit entries of a chain output dict."""
    for k in PACKED_KEYS:
        if k in out:
            out[k] = pack_bits(out[k])
    return out
