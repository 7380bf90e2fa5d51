"""Bit packing for decoded-frame outputs.

PyTorch counterpart of ``nrsc5_tpu/ops/bits.py`` (``pack_bits``,
``unpack_bits``, ``pack_out``, ``unpack_out``): decoded frames are
bits-as-bytes, so packing them 8-to-a-byte on the device before they are
copied to the host moves an eighth of the bytes.  Little-endian bit order
within each byte, matching ``np.unpackbits(..., bitorder="little")``.  On
the chain's path kernel K8 packs as it descrambles
(:func:`nrsc5_tpu_torch.ops.decode_fm.fec_epilogue`); :func:`pack_bits` is
its plain version's pack.
"""

from __future__ import annotations

import numpy as np
import torch

# the chain outputs that ``packed=True`` packs (the reference's list; the
# FM chains have no p3)
PACKED_KEYS = ("p1", "px1", "px2", "p3", "pids")


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
    """Pack the :data:`PACKED_KEYS` entries of a chain output dict of
    tensors, in place (the fused complex chain's ``packed=True``)."""
    for k in PACKED_KEYS:
        if k in out:
            out[k] = pack_bits(out[k])
    return out


def unpack_out(out: dict) -> dict:
    """Host inverse of ``packed=True`` on a chain output dict of numpy
    arrays: unpacks the :data:`PACKED_KEYS` entries in place."""
    for k in PACKED_KEYS:
        if k in out:
            out[k] = unpack_bits(out[k])
    return out
