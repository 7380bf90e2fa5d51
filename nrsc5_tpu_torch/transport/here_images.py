"""HERE traffic/weather image stream reassembly (reference: src/here_images.c)."""

from __future__ import annotations

from nrsc5_tpu_torch.api.events import EventType, make

# wire values of the type nibble (reference: include/nrsc5.h:270-274)
HERE_IMAGE_TRAFFIC = 8
HERE_IMAGE_WEATHER = 13
HERE_TRAFFIC_TILES = 9


class HereImages:
    def __init__(self, emit):
        self.emit = emit
        self.reset()

    def reset(self):
        self.expected_seq = -1
        self.last_timestamp = {}
        self.sync_state = 0
        self.payload_len = -1
        self.buffer = bytearray()

    def push(self, seq: int, buf: bytes):
        if seq != self.expected_seq:
            self.buffer.clear()
            self.payload_len = -1
            self.sync_state = 0
        for byte in buf:
            self.sync_state = ((self.sync_state << 8) | byte) & 0xFFFFFFFFFFFF
            if self.payload_len == -1:
                if (self.sync_state >> 16) & 0xFFFFFFFF == 0xFFF7FFF7:
                    self.payload_len = self.sync_state & 0xFFFF
                    self.buffer.clear()
            else:
                self.buffer.append(byte)
                if len(self.buffer) == self.payload_len + 2:
                    self._process()
                    self.payload_len = -1
        self.expected_seq = (seq + 1) & 0xFFFF

    def _process(self):
        b = self.buffer
        if len(b) < 28:
            return
        image_type = b[0] >> 4
        seq = b[0] & 0x0F
        if image_type not in (HERE_IMAGE_TRAFFIC, HERE_IMAGE_WEATHER):
            return
        n1 = (b[2] << 8) | b[3]
        n2 = (b[4] << 8) | b[5]
        timestamp = int.from_bytes(b[9:13], "big")

        lat1 = ((b[14] & 0x7F) << 18) | (b[15] << 10) | (b[16] << 2) | (b[17] >> 6)
        if b[14] & 0x80:
            lat1 = -lat1
        lon1 = ((b[17] & 0x1F) << 20) | (b[18] << 12) | (b[19] << 4) | (b[20] >> 4)
        if b[17] & 0x20:
            lon1 = -lon1
        lat2 = ((b[20] & 0x07) << 22) | (b[21] << 14) | (b[22] << 6) | (b[23] >> 2)
        if b[20] & 0x08:
            lat2 = -lat2
        lon2 = ((b[23] & 0x01) << 24) | (b[24] << 16) | (b[25] << 8) | b[26]
        if b[23] & 0x02:
            lon2 = -lon2

        filename_len = b[27]
        if len(b) < 34 + filename_len:
            return
        file_len = (b[32 + filename_len] << 8) | b[33 + filename_len]
        if len(b) < 34 + filename_len + file_len:
            return

        tidx = 0
        if image_type == HERE_IMAGE_TRAFFIC:
            if 1 <= n1 <= HERE_TRAFFIC_TILES:
                tidx = n1
            else:
                return
        if self.last_timestamp.get((image_type, tidx)) != timestamp:
            self.emit(make(
                EventType.HERE_IMAGE, image_type=image_type, seq=seq,
                n1=n1, n2=n2, timestamp=timestamp,
                latitude1=lat1 / 100000.0, longitude1=lon1 / 100000.0,
                latitude2=lat2 / 100000.0, longitude2=lon2 / 100000.0,
                name=bytes(b[28:28 + filename_len]).decode("latin-1", "replace"),
                data=bytes(b[34 + filename_len:34 + filename_len + file_len])))
            self.last_timestamp[(image_type, tidx)] = timestamp
