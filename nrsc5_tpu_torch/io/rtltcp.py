"""rtl_tcp client — pure-Python port of the wire protocol (the port's copy
of the reference package's ``io/rtltcp.py``).

Protocol facts (reference: src/rtltcp.c): commands are 5 bytes — one
opcode + a big-endian uint32 argument; the server greets with a 12-byte
dongle info block: magic "RTL0", uint32 tuner type, uint32 gain count.
Gains are specified in tenths of dB; each tuner model has a fixed gain
table (reference: src/rtltcp.c:100-154).
"""

from __future__ import annotations

import socket
import struct

CMD_SET_FREQUENCY = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_AGC_MODE = 0x08
CMD_SET_DIRECT_SAMPLING = 0x09
CMD_SET_OFFSET_TUNING = 0x0A
CMD_SET_BIAS_TEE = 0x0E

TUNER_UNKNOWN, TUNER_E4000, TUNER_FC0012, TUNER_FC0013, TUNER_FC2580, \
    TUNER_R820T, TUNER_R828D = range(7)

# gain tables in tenths of dB (reference: src/rtltcp.c:100-154)
GAIN_TABLES = {
    TUNER_E4000: [-10, 15, 40, 65, 90, 115, 140, 165, 190, 215, 240, 290,
                  340, 420],
    TUNER_FC0012: [-99, -40, 71, 179, 192],
    TUNER_FC0013: [-99, -73, -65, -63, -60, -58, -54, 58, 61, 63, 65, 67,
                   68, 70, 71, 179, 181, 182, 184, 186, 188, 191, 197],
    TUNER_FC2580: [0],
    TUNER_R820T: [0, 9, 14, 27, 37, 77, 87, 125, 144, 157, 166, 197, 207,
                  229, 254, 280, 297, 328, 338, 364, 372, 386, 402, 421,
                  434, 439, 445, 480, 496],
    TUNER_R828D: [0, 9, 14, 27, 37, 77, 87, 125, 144, 157, 166, 197, 207,
                  229, 254, 280, 297, 328, 338, 364, 372, 386, 402, 421,
                  434, 439, 445, 480, 496],
}


class RtlTcpClient:
    """Blocking rtl_tcp source usable by the session worker."""

    format = "cu8"

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        magic = self._read_exact(4)
        if magic != b"RTL0":
            raise IOError(f"not an rtl_tcp server (magic {magic!r})")
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", self._read_exact(8))
        self.gains = GAIN_TABLES.get(self.tuner_type, [0])
        self.frequency = None
        self.gain = None

    # ------------------------------------------------------------------
    def _cmd(self, op: int, arg: int):
        self.sock.sendall(struct.pack(">BI", op, arg & 0xFFFFFFFF))

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise IOError("rtl_tcp connection closed")
            buf.extend(chunk)
        return bytes(buf)

    # ------------------------------------------------------------------
    def set_frequency(self, freq_hz: int):
        self.frequency = freq_hz
        self._cmd(CMD_SET_FREQUENCY, freq_hz)

    def set_sample_rate(self, rate: int):
        self._cmd(CMD_SET_SAMPLE_RATE, rate)

    def set_gain_mode(self, manual: bool):
        self._cmd(CMD_SET_GAIN_MODE, 1 if manual else 0)

    def set_gain(self, gain_db: float):
        tenths = int(round(gain_db * 10))
        best = min(self.gains, key=lambda g: abs(g - tenths))
        self.gain = best / 10.0
        self.set_gain_mode(True)
        self._cmd(CMD_SET_GAIN, best)

    def set_freq_correction(self, ppm: int):
        self._cmd(CMD_SET_FREQ_CORRECTION, ppm)

    def set_bias_tee(self, on: bool):
        self._cmd(CMD_SET_BIAS_TEE, 1 if on else 0)

    def set_direct_sampling(self, mode: int):
        self._cmd(CMD_SET_DIRECT_SAMPLING, mode)

    def set_offset_tuning(self, on: bool):
        self._cmd(CMD_SET_OFFSET_TUNING, 1 if on else 0)

    def read(self, n: int) -> bytes:
        return self._read_exact(n)

    def read_some(self, n: int) -> bytes:
        """One ``recv`` of at most ``n`` bytes (never empty: a clean close
        raises).  Unlike :meth:`read`, a socket timeout loses no partly
        read bytes (there is no partial buffer), so a caller may take
        ``TimeoutError`` as a stall and retry; the receiver's byte
        leftovers keep the I/Q pairs aligned across reads."""
        chunk = self.sock.recv(n)
        if not chunk:
            raise IOError("rtl_tcp connection closed")
        return chunk

    def close(self):
        """Shut the connection down, then close it: the shutdown wakes a
        thread blocked in ``read_some`` on this socket at once (a close
        alone leaves it waiting for its timeout)."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
