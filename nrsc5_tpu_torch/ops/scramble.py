"""NRSC-5 scrambler / descrambler.

A numpy copy of ``nrsc5_tpu/ops/scramble.py`` (pinned equal by
tests/test_torch_tables.py).  The standard scrambles every logical channel
with an 11-bit LFSR seeded with 0x3ff (feedback ``((v >> 9) ^ v) & 1``;
reference: src/decode.c:279-294).  The seed is fixed, so the keystream is a
constant bit sequence and (de)scrambling is one XOR against it.
"""

from __future__ import annotations

import functools

import numpy as np

from nrsc5_tpu_torch.constants import SCRAMBLER_SEED


@functools.lru_cache(maxsize=8)
def scrambler_keystream(length: int) -> np.ndarray:
    """First ``length`` bits of the NRSC-5 scrambler keystream (uint8)."""
    out = np.empty(length, dtype=np.uint8)
    val = SCRAMBLER_SEED
    for i in range(length):
        bit = ((val >> 9) ^ val) & 1
        val |= bit << 11
        val >>= 1
        out[i] = bit
    out.setflags(write=False)
    return out


def descramble(bits: np.ndarray, length: int | None = None) -> np.ndarray:
    """XOR a numpy bit array (last dim = frame bits) with the keystream."""
    n = bits.shape[-1] if length is None else length
    return bits ^ scrambler_keystream(n)


# scrambling is its own inverse
scramble = descramble
