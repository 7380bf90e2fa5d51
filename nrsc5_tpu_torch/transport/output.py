"""Output layer: elastic packet buffers, AAS port routing, SIG, LOT files.

Host-side mirror of the reference output stage (src/output.c), emitting
:class:`nrsc5_tpu_torch.api.events.Event` objects through a callback.  HDC->PCM
decoding is pluggable (see transport/hdc.py); the primary correctness target
is bit-exact HDC packets, with PCM secondary (the reference links a patched
FAAD2 for this; SURVEY.md "external dependencies").
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.api.events import AASType, EventType, MIMEType, make
from nrsc5_tpu_torch.transport.frame import (PACKET_FULL, PACKET_HALF_BACK,
                                       PACKET_HALF_FRONT, PacketRef)
from nrsc5_tpu_torch.transport.here_images import HereImages
from nrsc5_tpu_torch.transport.id3 import parse_id3

MAX_SIG_SERVICES = 16
MAX_SIG_COMPONENTS = 8
MAX_LOT_FILES = 12
MAX_LOT_FRAGMENTS = 4096
LOT_FRAGMENT_SIZE = 256

PACKET_NONE = -1


@dataclass
class _Packet:
    data: bytearray = field(default_factory=bytearray)
    crc_error: bool = False
    shape: int = PACKET_NONE


@dataclass
class _Elastic:
    packets: list = field(default_factory=lambda: [_Packet() for _ in range(C.ELASTIC_BUFFER_LEN)])
    audio_offset: int = -1


@dataclass
class LotFile:
    lot: int = -1
    timestamp: int = 0
    name: str | None = None
    size: int = 0
    mime: int = 0
    expiry: tuple = ()
    fragments: dict = field(default_factory=dict)
    bytes_so_far: int = 0


@dataclass
class SigComponent:
    type: str = "none"  # "audio" | "data"
    id: int = 0
    port: int = 0
    service_data_type: int = 0
    content_type: int = 0
    mime: int = 0
    lot_files: list = field(default_factory=list)
    service: "SigService" = None


@dataclass
class SigService:
    type: str = "none"  # "audio" | "data"
    number: int = 0
    name: str | None = None
    components: list = field(default_factory=list)


class Output:
    """Per-station output stage."""

    def __init__(self, emit, mode_fm: bool = True, hdc_decoder_factory=None):
        self.emit = emit
        self.mode_fm = mode_fm
        self._hdc_factory = hdc_decoder_factory
        self.here_images = HereImages(emit)
        self.reset()

    def reset(self):
        self.elastic = [[_Elastic() for _ in range(C.MAX_STREAMS)]
                        for _ in range(C.MAX_PROGRAMS)]
        self.services: list[SigService] = []
        self.lot_lru = 1
        self.aacdec = [None] * C.MAX_PROGRAMS
        self.here_images.reset()

    # ------------------------------------------------------------------
    # elastic buffer (reference: src/output.c:31-98)
    # ------------------------------------------------------------------
    def align(self, program: int, stream_id: int, offset: int):
        self.elastic[program][stream_id].audio_offset = offset

    def push_packet(self, ref: PacketRef):
        if ref.stream_id != 0:
            return  # enhanced stream not processed (parity w/ reference)
        pkt = self.elastic[ref.program][ref.stream_id].packets[ref.seq]
        if ref.shape == PACKET_HALF_BACK and pkt.shape == PACKET_HALF_FRONT:
            pkt.crc_error = pkt.crc_error or ref.crc_error
            pkt.shape = PACKET_FULL
            if not pkt.crc_error:
                pkt.data.extend(ref.data)
            else:
                pkt.data.clear()
        else:
            if ref.shape == PACKET_HALF_BACK:
                return
            pkt.crc_error = ref.crc_error
            pkt.shape = ref.shape
            pkt.data.clear()
            if not pkt.crc_error:
                pkt.data.extend(ref.data)

    def advance(self):
        """Block clock: pop packets, emit HDC + PCM (reference:
        src/output.c:100-168)."""
        audio_frames = 2 if self.mode_fm else 4
        for program in range(C.MAX_PROGRAMS):
            elastic = self.elastic[program][0]
            if elastic.audio_offset == -1:
                continue
            for _ in range(audio_frames):
                pkt = elastic.packets[elastic.audio_offset]
                produced = False
                if pkt.shape == PACKET_FULL:
                    self.emit(make(EventType.HDC, program=program,
                                   data=bytes(pkt.data),
                                   crc_error=pkt.crc_error))
                if pkt.shape == PACKET_FULL and not pkt.crc_error:
                    if self._hdc_factory is not None:
                        if self.aacdec[program] is None:
                            self.aacdec[program] = self._hdc_factory()
                        pcm = self.aacdec[program].decode(bytes(pkt.data))
                        if pcm is not None and len(pcm):
                            self.emit(make(EventType.AUDIO, program=program,
                                           samples=pcm))
                            produced = True
                else:
                    self.aacdec[program] = None
                if self._hdc_factory is not None and not produced:
                    self.emit(make(EventType.AUDIO, program=program,
                                   samples=np.zeros(
                                       C.AUDIO_FRAME_SAMPLES * 2, np.int16)))
                pkt.data.clear()
                pkt.crc_error = False
                pkt.shape = PACKET_NONE
                elastic.audio_offset = (elastic.audio_offset + 1) % C.ELASTIC_BUFFER_LEN

    # ------------------------------------------------------------------
    # AAS port router (reference: src/output.c:874-896)
    # ------------------------------------------------------------------
    def aas_push(self, buf: bytes):
        if len(buf) < 4:
            return
        port = buf[0] | (buf[1] << 8)
        seq = buf[2] | (buf[3] << 8)
        payload = buf[4:]
        if port == 0x5100 or 0x5201 <= port <= 0x5207:
            info = parse_id3(payload)
            if info is not None:
                self.emit(make(EventType.ID3, program=port & 0x7, **info))
        elif port == 0x20:
            self._parse_sig(payload)
        elif 0x401 <= port <= 0x50FF:
            self._process_port(port, seq, payload)

    # ------------------------------------------------------------------
    # SIG (reference: src/output.c:512-625)
    # ------------------------------------------------------------------
    def _parse_sig(self, buf: bytes):
        if self.services:
            return  # SIG assumed static; process once
        services: list[SigService] = []
        service = None
        p = 0
        try:
            while p < len(buf):
                t = buf[p]
                p += 1
                if (t & 0xF0) == 0x40:
                    number = buf[p] | (buf[p + 1] << 8)
                    service = SigService(
                        type="audio" if t == 0x40 else "data", number=number)
                    services.append(service)
                    p += 3
                elif (t & 0xF0) == 0x60:
                    length = buf[p]
                    p += 1
                    if service is None:
                        break
                    if t == 0x69:
                        service.name = buf[p + 1:p + length - 1].decode(
                            "latin-1", "replace")
                    elif t == 0x67:
                        comp = SigComponent(
                            type="data", id=buf[p],
                            port=buf[p + 1] | (buf[p + 2] << 8),
                            service_data_type=buf[p + 3] | (buf[p + 4] << 8),
                            content_type=buf[p + 5],
                            mime=int.from_bytes(buf[p + 8:p + 12], "little"),
                            service=service)
                        service.components.append(comp)
                    elif t == 0x66:
                        comp = SigComponent(
                            type="audio", id=buf[p], port=buf[p + 1],
                            content_type=buf[p + 2],
                            mime=int.from_bytes(buf[p + 7:p + 11], "little"),
                            service=service)
                        service.components.append(comp)
                    p += length - 1
                else:
                    break
        except IndexError:
            pass
        self.services = services
        self.emit(make(EventType.SIG, services=services))

    def _find_port(self, port: int) -> SigComponent | None:
        for svc in self.services:
            for comp in svc.components:
                if comp.type == "data" and comp.port == port:
                    return comp
        return None

    # ------------------------------------------------------------------
    # data ports / LOT reassembly (reference: src/output.c:684-872)
    # ------------------------------------------------------------------
    def _process_port(self, port: int, seq: int, buf: bytes):
        if not self.services:
            return
        comp = self._find_port(port)
        if comp is None:
            return
        if comp.content_type == AASType.STREAM:
            self.emit(make(EventType.STREAM, port=port, seq=seq, data=buf,
                           mime=comp.mime, service=comp.service, component=comp))
            if comp.mime == MIMEType.HERE_IMAGE:
                self.here_images.push(seq, buf)
        elif comp.content_type == AASType.PACKET:
            self.emit(make(EventType.PACKET, port=port, seq=seq, data=buf,
                           mime=comp.mime, service=comp.service, component=comp))
        elif comp.content_type == AASType.LOT:
            self._process_lot(comp, buf)

    def _process_lot(self, comp: SigComponent, buf: bytes):
        if len(buf) < 8:
            return
        hdrlen = buf[0]
        repeat = buf[1]
        lot = buf[2] | (buf[3] << 8)
        seq = int.from_bytes(buf[4:8], "little")
        if hdrlen < 8 or hdrlen > len(buf):
            return
        buf = buf[8:]
        hdrlen -= 8
        if seq >= MAX_LOT_FRAGMENTS:
            return

        file = next((f for f in comp.lot_files
                     if f.timestamp and f.lot == lot), None)
        if file is None:
            if len(comp.lot_files) >= MAX_LOT_FILES:
                comp.lot_files.sort(key=lambda f: f.timestamp)
                comp.lot_files.pop(0)
            file = LotFile(lot=lot)
            comp.lot_files.append(file)
        file.timestamp = self.lot_lru
        self.lot_lru += 1

        new_data = False
        if hdrlen > 0:
            if hdrlen < 16:
                return
            size = int.from_bytes(buf[8:12], "little")
            mime = int.from_bytes(buf[12:16], "little")
            year = ((buf[7] << 4) | (buf[6] >> 4))
            mon = buf[6] & 0xF
            mday = buf[5] >> 3
            hour = ((buf[5] & 0x7) << 2) | (buf[4] >> 6)
            minute = buf[4] & 0x3F
            expiry = (year, mon, mday, hour, minute)
            name = buf[16:hdrlen].decode("latin-1", "replace")
            meta = (name, size, mime, expiry)
            if file.name is not None:
                if (file.name, file.size, file.mime, file.expiry) != meta:
                    lot_id = file.lot
                    file.__init__(lot=lot_id)
                    file.timestamp = self.lot_lru
                    new_data = True
            else:
                new_data = True
            file.name, file.size, file.mime, file.expiry = meta
            buf = buf[hdrlen:]
            if new_data:
                self.emit(make(EventType.LOT_HEADER, lot=file.lot,
                               size=file.size, mime=file.mime, name=file.name,
                               expiry=file.expiry, service=comp.service,
                               component=comp))

        is_duplicate = True
        if seq not in file.fragments:
            if len(buf) > LOT_FRAGMENT_SIZE:
                return
            new_data = True
            is_duplicate = False
            frag = bytes(buf) + bytes(LOT_FRAGMENT_SIZE - len(buf))
            file.fragments[seq] = frag
            file.bytes_so_far += len(buf)
        self.emit(make(EventType.LOT_FRAGMENT, lot=file.lot, seq=seq,
                       repeat=repeat, is_duplicate=is_duplicate,
                       data=bytes(buf), bytes_so_far=file.bytes_so_far,
                       service=comp.service, component=comp))

        if new_data and file.size:
            n_frag = (file.size + LOT_FRAGMENT_SIZE - 1) // LOT_FRAGMENT_SIZE
            if all(i in file.fragments for i in range(n_frag)):
                data = b"".join(file.fragments[i] for i in range(n_frag))
                self.emit(make(EventType.LOT, lot=file.lot, size=file.size,
                               mime=file.mime, name=file.name,
                               data=data[:file.size], expiry=file.expiry,
                               service=comp.service, component=comp))
