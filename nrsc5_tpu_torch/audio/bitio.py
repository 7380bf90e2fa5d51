"""MSB-first bitstream reader/writer for the HDC (AAC-variant) codec.

HDC packets are raw bitstreams without ADTS framing (reference:
support/faad2-hdc-support.patch:199 — NeAACDecInitHDC configures raw
packets; src/output.c:126-163 feeds whole packets).
"""

from __future__ import annotations


class BitReader:
    """MSB-first reader over a bytes object."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        """Read n bits (0 <= n <= 32). Reading past the end returns zero
        bits (matches faad's zero-padded tail behavior) but marks overrun
        via ``overrun()``."""
        pos = self.pos
        self.pos = pos + n
        if n == 0:
            return 0
        end = min((self.pos + 7) // 8, len(self.data))
        chunk = self.data[pos // 8: end]
        val = int.from_bytes(chunk, "big")
        have = 8 * len(chunk)
        shift = have - (pos % 8) - n
        if shift >= 0:
            return (val >> shift) & ((1 << n) - 1)
        return (val << -shift) & ((1 << n) - 1)

    def read1(self) -> int:
        return self.read(1)

    def peek(self, n: int) -> int:
        pos = self.pos
        v = self.read(n)
        self.pos = pos
        return v

    def skip(self, n: int):
        self.pos += n

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def overrun(self) -> bool:
        return self.pos > self.nbits

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7


class BitWriter:
    """MSB-first writer."""

    __slots__ = ("_buf", "_acc", "_accn")

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._accn = 0

    def write(self, value: int, n: int):
        assert 0 <= value < (1 << n), (value, n)
        self._acc = (self._acc << n) | value
        self._accn += n
        while self._accn >= 8:
            self._accn -= 8
            self._buf.append((self._acc >> self._accn) & 0xFF)
        self._acc &= (1 << self._accn) - 1

    def bit_length(self) -> int:
        return 8 * len(self._buf) + self._accn

    def getvalue(self, pad_bit: int = 0) -> bytes:
        """Byte-aligned contents; partial byte padded with ``pad_bit``s."""
        out = bytearray(self._buf)
        if self._accn:
            pad = 8 - self._accn
            fill = (1 << pad) - 1 if pad_bit else 0
            out.append(((self._acc << pad) | fill) & 0xFF)
        return bytes(out)
