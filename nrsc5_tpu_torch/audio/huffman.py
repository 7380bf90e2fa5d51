"""Prefix-code decode/encode over (codeword, length) spec tables.

The AAC and SBR codebooks (audio/aac_tables.py) are given as
per-symbol (code, bits) pairs; decoding walks a flat lookup built once per
table.  A two-level LUT (direct-indexed 10-bit first stage) keeps decode
O(1) per symbol without materializing 2^max_len entries for the long
codebooks (max length 19 in the AAC spectral books).
"""

from __future__ import annotations

import numpy as np

_FIRST = 10  # first-stage LUT width


class PrefixCode:
    def __init__(self, codes, bits):
        codes = np.asarray(codes, np.uint32)
        bits = np.asarray(bits, np.uint8)
        assert codes.shape == bits.shape
        self.codes = codes
        self.bits = bits
        self.max_len = int(bits.max())
        # first stage: every code of length <= _FIRST fills its subtree
        n1 = 1 << min(_FIRST, self.max_len)
        self.shift1 = min(_FIRST, self.max_len)
        sym1 = np.full(n1, -1, np.int32)
        len1 = np.zeros(n1, np.uint8)
        self.long_codes: dict[tuple[int, int], int] = {}
        for sym, (c, ln) in enumerate(zip(codes.tolist(), bits.tolist())):
            if ln == 0:
                continue
            if ln <= self.shift1:
                base = c << (self.shift1 - ln)
                sym1[base: base + (1 << (self.shift1 - ln))] = sym
                len1[base: base + (1 << (self.shift1 - ln))] = ln
            else:
                self.long_codes[(ln, c)] = sym
        self.sym1 = sym1
        self.len1 = len1

    def decode(self, br) -> int:
        """Decode one symbol from a BitReader; returns the symbol index."""
        probe = br.peek(self.shift1)
        sym = int(self.sym1[probe])
        if sym >= 0:
            br.skip(int(self.len1[probe]))
            return sym
        # long path: extend bit by bit
        code = probe
        n = self.shift1
        while n < self.max_len:
            code = (code << 1) | ((br.peek(n + 1)) & 1)
            n += 1
            sym = self.long_codes.get((n, code), -1)
            if sym >= 0:
                br.skip(n)
                return sym
        raise ValueError("invalid huffman codeword")

    def encode(self, bw, sym: int):
        ln = int(self.bits[sym])
        assert ln > 0, f"symbol {sym} has no codeword"
        bw.write(int(self.codes[sym]), ln)
