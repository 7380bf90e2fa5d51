"""CRC primitives used by the NRSC-5 transport layers.

All tables are generated from the polynomial definitions; values are
cross-checked against the reference's hardcoded tables in tests
(reference: src/frame.c:60-136, src/pids.c).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def crc8_table() -> np.ndarray:
    """MSB-first CRC-8, poly 0x31 (x^8+x^5+x^4+1)."""
    tab = np.zeros(256, dtype=np.uint8)
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x31 if c & 0x80 else c << 1) & 0xFF
        tab[i] = c
    return tab


def crc8(data: bytes | np.ndarray, init: int = 0xFF) -> int:
    """Audio-packet CRC-8 (reference: src/frame.c:130-136).
    crc8(pkt || checksum) == 0 for a valid packet."""
    tab = crc8_table()
    c = init
    for byte in np.asarray(bytearray(data) if isinstance(data, (bytes, bytearray)) else data, dtype=np.uint8):
        c = tab[c ^ int(byte)]
    return int(c)


@functools.lru_cache(maxsize=1)
def fcs16_table() -> np.ndarray:
    """Reflected CRC-16/X.25 (HDLC FCS), poly 0x8408."""
    tab = np.zeros(256, dtype=np.uint16)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x8408 if c & 1 else c >> 1
        tab[i] = c
    return tab


VALIDFCS16 = 0xF0B8


def fcs16(data: bytes | np.ndarray, init: int = 0xFFFF) -> int:
    """HDLC frame check sequence (reference: src/frame.c:138-144)."""
    tab = fcs16_table()
    c = init
    for byte in bytearray(data) if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8):
        c = ((c >> 8) ^ tab[(c ^ int(byte)) & 0xFF]) & 0xFFFF
    return int(c)


def fcs16_append(data: bytes) -> bytes:
    """Append a valid FCS to an HDLC payload (TX harness)."""
    c = fcs16(data) ^ 0xFFFF
    return data + bytes([c & 0xFF, c >> 8])


def crc12(bits: np.ndarray) -> int:
    """PIDS CRC-12 over the first 68 frame bits (reference:
    src/pids.c:52-73): reflected poly 0xD010 into a 16-bit register fed from
    bit 67 down to bit 0, 16 flush steps, final XOR 0x955, low 12 bits.

    bits: the 80 PIDS frame bits in *frame order* (after per-byte bit
    reversal of the descrambled stream); the CRC field is bits[68:80]
    MSB first.
    """
    poly = 0xD010
    reg = 0
    for i in range(67, -1, -1):
        lowbit = reg & 1
        reg >>= 1
        reg ^= int(bits[i]) << 15
        if lowbit:
            reg ^= poly
    for _ in range(16):
        lowbit = reg & 1
        reg >>= 1
        if lowbit:
            reg ^= poly
    return (reg ^ 0x955) & 0xFFF


def crc12_embed(bits68: np.ndarray) -> np.ndarray:
    """Return an 80-bit PIDS frame with the valid CRC appended (TX)."""
    frame = np.zeros(80, dtype=np.uint8)
    frame[:68] = bits68
    crc = crc12(frame)
    for i in range(12):
        frame[68 + i] = (crc >> (11 - i)) & 1
    return frame


def alert_cnt_crc(control_data: bytes) -> int:
    """Emergency-alert CNT (control data) CRC-12 (reference:
    src/pids.c:119-153): reflected poly 0xD010, init 0x7E1B, bytes processed
    last-to-first LSB-first with the embedded CRC field (byte 1 and low
    nibble of byte 2) zeroed, 16 flush steps, low 12 bits."""
    poly = 0xD010
    reg = 0x7E1B
    for byte_index in range(len(control_data) - 1, 0, -1):
        for bit_index in range(8):
            bit = (control_data[byte_index] >> bit_index) & 1
            if byte_index == 1 or (byte_index == 2 and bit_index < 4):
                bit = 0  # skip embedded CRC bits
            lowbit = reg & 1
            reg >>= 1
            reg ^= bit << 15
            if lowbit:
                reg ^= poly
    for _ in range(16):
        lowbit = reg & 1
        reg >>= 1
        if lowbit:
            reg ^= poly
    return reg & 0xFFF


def alert_crc7(payload: bytes) -> int:
    """Emergency-alert CRC-7 (reference: src/pids.c:88-110): poly 0x09,
    init 0x42, bytes processed last-to-first, 7 data bits per byte with the
    MSB of the preceding byte folded into bit 0, then 7 flush steps."""
    reg = 0x42
    for byte_index in range(len(payload) - 1, -1, -1):
        for bit_index in range(6, -1, -1):
            bit = (payload[byte_index] >> bit_index) & 1
            if bit_index == 0 and byte_index > 0:
                bit ^= payload[byte_index - 1] >> 7
            reg = (reg << 1) ^ bit
            if reg & 0x80:
                reg ^= 0x80 | 0x09
    for _ in range(7):
        reg <<= 1
        if reg & 0x80:
            reg ^= 0x80 | 0x09
    return reg & 0x7F
