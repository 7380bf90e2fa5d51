"""SIS / PIDS frame encoder for the truth harness.

Builds 80-bit PIDS frames (device bit order, CRC-12 embedded) carrying
the station-information messages the receiver decodes
(transport/pids.py; reference decoder: src/pids.c:394-754).  The
reference has no encoder — frame layouts are the exact inverses of the
decode paths and are cross-validated against the reference binary in
tests/test_reference_crosscheck.py.
"""

from __future__ import annotations

import numpy as np

from nrsc5_tpu_torch.transport.pids import (CHAR5, MSG_EMERGENCY_ALERTS,
                                      MSG_PARAMETER_MESSAGE, MSG_STATION_ID,
                                      MSG_STATION_LOCATION,
                                      MSG_STATION_MESSAGE,
                                      MSG_STATION_NAME_LONG,
                                      MSG_STATION_NAME_SHORT,
                                      MSG_SERVICE_INFORMATION)
from nrsc5_tpu_torch.utils.crc import crc12


class BitWriter:
    def __init__(self, n: int = 80):
        self.bits = np.zeros(n, np.uint8)
        self.off = 0

    def u(self, value: int, n: int):
        assert 0 <= value < (1 << n), \
            f"value {value} does not fit in {n} bits"
        for i in range(n - 1, -1, -1):
            self.bits[self.off] = (value >> i) & 1
            self.off += 1

    def s(self, value: int, n: int):
        self.u(value & ((1 << n) - 1), n)

    def char5(self, ch: str):
        self.u(CHAR5.index(ch), 5)


def _finish(w: BitWriter) -> np.ndarray:
    """Embed CRC-12 (bits 68..79 MSB-first over bits 0..67) and convert
    frame order -> device order (per-byte bit reversal,
    reference: src/pids.c:1032-1040)."""
    crc = crc12(w.bits)
    for i in range(12):
        w.bits[68 + i] = (crc >> (11 - i)) & 1
    return w.bits.reshape(10, 8)[:, ::-1].reshape(-1)


def _frame(msg_id: int) -> BitWriter:
    w = BitWriter()
    w.u(0, 1)  # PIDS_TYPE_SIS
    w.u(0, 1)  # one payload
    w.u(msg_id, 4)
    return w


def station_id(country: str = "US", fcc_facility_id: int = 0) -> np.ndarray:
    w = _frame(MSG_STATION_ID)
    w.char5(country[0])
    w.char5(country[1])
    w.u(0, 3)
    w.u(fcc_facility_id, 19)
    return _finish(w)


def short_name(name: str) -> np.ndarray:
    """4-char station name; a '-FM' suffix is signalled, not spelled."""
    suffix_fm = name.endswith("-FM")
    base = (name[:-3] if suffix_fm else name).ljust(4)
    w = _frame(MSG_STATION_NAME_SHORT)
    for ch in base[:4]:
        w.char5(ch)
    w.u(0b01 if suffix_fm else 0b00, 2)
    return _finish(w)


def long_name(text: str) -> list[np.ndarray]:
    """Multi-frame slogan/long-name (7 x 7-bit chars per frame)."""
    data = text.encode("latin-1") + b"\0"
    n_frames = (len(data) + 6) // 7
    frames = []
    for f in range(n_frames):
        chunk = data[f * 7:(f + 1) * 7].ljust(7, b"\0")
        w = _frame(MSG_STATION_NAME_LONG)
        w.u(n_frames - 1, 3)
        w.u(f, 3)
        for b in chunk:
            w.u(b, 7)
        w.u(0, 3)  # sequence
        frames.append(_finish(w))
    return frames


def location(latitude: float, longitude: float,
             altitude_m: int = 0) -> list[np.ndarray]:
    """Two frames: latitude + high altitude nibble, longitude + mid nibble
    (altitude is encoded in 16-m units split across the pair)."""
    alt = int(altitude_m) // 16
    out = []
    for is_lat, val, nib in ((1, latitude, (alt >> 4) & 0xF),
                             (0, longitude, alt & 0xF)):
        w = _frame(MSG_STATION_LOCATION)
        w.u(is_lat, 1)
        w.s(int(round(val * 8192.0)), 22)
        w.u(nib, 4)
        out.append(_finish(w))
    return out


def message(text: str, priority: int = 0, encoding: int = 0) -> list[np.ndarray]:
    data = text.encode("latin-1")
    checksum = sum(data)
    checksum = (((checksum >> 8) & 0x7F) + (checksum & 0xFF)) & 0x7F
    frames = []
    w = _frame(MSG_STATION_MESSAGE)
    w.u(0, 5)  # current frame
    w.u(0, 2)  # sequence
    w.u(priority, 1)
    w.u(encoding, 3)
    w.u(len(data), 8)
    w.u(checksum, 7)
    for b in data[:4].ljust(4, b"\0"):
        w.u(b, 8)
    frames.append(_finish(w))
    pos = 4
    current = 1
    while pos < len(data):
        w = _frame(MSG_STATION_MESSAGE)
        w.u(current, 5)
        w.u(0, 2)
        w.u(0, 3)
        for b in data[pos:pos + 6].ljust(6, b"\0"):
            w.u(b, 8)
        frames.append(_finish(w))
        pos += 6
        current += 1
    return frames


def audio_service(program: int, access: int = 0, type_: int = 0,
                  sound_exp: int = 0) -> np.ndarray:
    w = _frame(MSG_SERVICE_INFORMATION)
    w.u(0, 2)  # category: audio
    w.u(access, 1)
    w.u(program, 6)
    w.u(type_, 8)
    w.u(0, 5)
    w.u(sound_exp, 5)
    return _finish(w)


def parameter(index: int, value: int) -> np.ndarray:
    w = _frame(MSG_PARAMETER_MESSAGE)
    w.u(index, 6)
    w.u(value, 16)
    return _finish(w)


def local_time(utc_offset_min: int, dst_sched: int = 0, dst_local: bool = False,
               dst_regional: bool = False) -> np.ndarray:
    value = ((utc_offset_min & 0x7FF) << 5) | ((dst_sched & 0x7) << 2) \
        | (int(dst_local) << 1) | int(dst_regional)
    return parameter(3, value)


def _alert_cnt(category1: int, category2: int, location_format: int,
               locations: list[int]) -> bytes:
    """Control-data (CNT) block: categories + location list with the
    embedded CNT CRC-12 (decoder: transport/pids.py decode_control_data;
    reference: src/pids.c:119-153,247-267).  Locations are encoded in
    full form (no delta compression)."""
    from nrsc5_tpu_torch.utils.crc import alert_cnt_crc

    full_len = 20 if location_format == 0 else 17  # SAME : FIPS/ZIP
    bits = []

    def put_rev(value, n):
        bits.extend((value >> i) & 1 for i in range(n))

    put_rev(0, 8)        # unknown
    put_rev(0, 12)       # CNT CRC placeholder
    put_rev(0, 8)        # unknown
    put_rev(category1, 5)
    put_rev(category2, 5)
    put_rev(0, 9)
    put_rev(location_format, 3)
    put_rev(len(locations), 5)
    put_rev(0, 1)
    for i, loc in enumerate(locations):
        if i > 0:
            put_rev(1, 1)  # full form
        put_rev(loc, full_len)
    # pad to an odd byte count >= 7 (cnt_len = 1 + 2*k)
    nbytes = (len(bits) + 7) // 8
    if nbytes < 7:
        nbytes = 7
    if nbytes % 2 == 0:
        nbytes += 1
    bits.extend([0] * (nbytes * 8 - len(bits)))
    cnt = bytearray(np.packbits(np.array(bits, np.uint8),
                                bitorder="little").tobytes())
    crc = alert_cnt_crc(bytes(cnt))
    cnt[1] = crc & 0xFF
    cnt[2] |= (crc >> 8) & 0x0F
    return bytes(cnt)


def emergency_alert(message: str, category1: int = 1, category2: int = 0,
                    location_format: int = 0,
                    locations: list[int] | None = None,
                    seq: int = 1) -> list[np.ndarray]:
    """Multi-frame emergency alert (decoder: transport/pids.py _alerts;
    reference: src/pids.c:853-933)."""
    from nrsc5_tpu_torch.utils.crc import alert_crc7

    cnt = _alert_cnt(category1, category2, location_format, locations or [])
    payload = cnt + message.encode("latin-1")
    crc7 = alert_crc7(payload)
    frames = []
    w = _frame(MSG_EMERGENCY_ALERTS)
    w.u(0, 6)   # frame 0
    w.u(seq, 2)
    w.u(0, 2)
    w.u(0, 3)   # encoding: ISO-8859-1
    w.u(len(payload), 9)
    w.u(crc7, 7)
    w.u((len(cnt) - 1) // 2, 5)
    for b in payload[:3].ljust(3, b"\0"):
        w.u(b, 8)
    frames.append(_finish(w))
    pos, current = 3, 1
    while pos < len(payload):
        w = _frame(MSG_EMERGENCY_ALERTS)
        w.u(current, 6)
        w.u(seq, 2)
        w.u(0, 2)
        for b in payload[pos:pos + 6].ljust(6, b"\0"):
            w.u(b, 8)
        frames.append(_finish(w))
        pos += 6
        current += 1
    return frames
