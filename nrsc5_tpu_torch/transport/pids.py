"""PIDS / SIS (Station Information Service) decoder.

Host-side byte/bit-level parsing of the 80-bit PIDS frames produced by the
device FEC chain.  Functional parity with the reference decoder
(reference: src/pids.c:283-1102) with an idiomatic design: a ``BitReader``
instead of manual offsets, per-message dataclass state, and events emitted
through the framework callback (api/events.py).

Layout facts (NRSC-5 1020s, cross-checked against src/pids.c):
  * frame = 1 type bit-reversal-corrected stream; CRC-12 over bits 0..67,
    CRC field in bits 68..79 (src/pids.c:52-86)
  * SIS PDU: 1 bit payload count (+1), then 1-2 payloads of
    (4-bit msg id, fixed-size body) (src/pids.c:935-1030)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from nrsc5_tpu_torch.api.events import EventType, make
from nrsc5_tpu_torch.utils.crc import alert_cnt_crc, alert_crc7, crc12

ALERT_TIMEOUT_LIMIT = 16
PIDS_TYPE_SIS = 0
PIDS_TYPE_LLDS = 1

MSG_STATION_ID = 0
MSG_STATION_NAME_SHORT = 1
MSG_STATION_NAME_LONG = 2
MSG_STATION_LOCATION = 4
MSG_STATION_MESSAGE = 5
MSG_SERVICE_INFORMATION = 6
MSG_PARAMETER_MESSAGE = 7
MSG_UNIVERSAL_SHORT_STATION_NAME = 8
MSG_EMERGENCY_ALERTS = 9
MSG_ADV_SERVICE_INFORMATION = 10

# payload body size in bits per msg id (src/pids.c:48-51)
PAYLOAD_SIZES = {0: 32, 1: 22, 2: 58, 3: 32, 4: 27, 5: 58, 6: 27, 7: 22,
                 8: 58, 9: 58, 10: 27}

CHAR5 = "ABCDEFGHIJKLMNOPQRSTUVWXYZ ?-*$ "

ENCODING_ISO_8859_1 = 0
ENCODING_UCS_2 = 4

LOCATION_FORMAT_SAME = 0
LOCATION_FORMAT_FIPS = 1
LOCATION_FORMAT_ZIP = 2

MAX_AUDIO_SERVICES = 32
MAX_DATA_SERVICES = 32
NUM_PARAMETERS = 16


def decode_text(encoding: int, data: bytes) -> str | None:
    """ISO-8859-1 or UCS-2 (BOM-aware) to str (reference: src/unicode.c)."""
    if encoding == ENCODING_ISO_8859_1:
        return data.decode("latin-1")
    if encoding == ENCODING_UCS_2:
        if len(data) >= 2 and data[0] == 0xFF and data[1] == 0xFE:
            return data[2:].decode("utf-16-le", errors="replace")
        if len(data) >= 2 and data[0] == 0xFE and data[1] == 0xFF:
            return data[2:].decode("utf-16-be", errors="replace")
        return data.decode("utf-16-be", errors="replace")
    return None


class BitReader:
    """MSB-first (and LSB-first helper) reader over a bit array."""

    def __init__(self, bits: np.ndarray, off: int = 0):
        self.bits = bits
        self.off = off

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | int(self.bits[self.off])
            self.off += 1
        return v

    def u_rev(self, n: int) -> int:
        v = 0
        for i in range(n):
            v |= int(self.bits[self.off]) << i
            self.off += 1
        return v

    def s(self, n: int) -> int:
        v = self.u(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def skip(self, n: int):
        self.off += n

    def char5(self) -> str:
        return CHAR5[self.u(5)]


@dataclass
class _Assembler:
    """Multi-frame string reassembly used by long name / message / slogan /
    universal name / alerts."""
    data: bytearray = field(default_factory=lambda: bytearray(256))
    have: set = field(default_factory=set)
    seq: int = -1
    displayed: bool = False

    def restart(self, seq: int):
        self.data = bytearray(256)
        self.have = set()
        self.seq = seq
        self.displayed = False

    def put(self, pos: int, chunk: bytes, frame: int):
        self.data[pos:pos + len(chunk)] = chunk
        self.have.add(frame)

    def complete(self, n_frames: int) -> bool:
        return all(f in self.have for f in range(n_frames))


@dataclass
class _AudioService:
    access: int = -1
    type: int = -1
    sound_exp: int = -1


@dataclass
class _DataService:
    access: int = -1
    type: int = -1
    mime_type: int = -1


def decode_locations(bits: np.ndarray, location_format: int,
                     num_locations: int) -> list[int] | None:
    """SAME/FIPS/ZIP location list with delta compression
    (reference: src/pids.c:189-245)."""
    if location_format == LOCATION_FORMAT_SAME:
        full_len, compressed_len = 20, 14
    elif location_format in (LOCATION_FORMAT_FIPS, LOCATION_FORMAT_ZIP):
        full_len, compressed_len = 17, 10
    else:
        return None
    r = BitReader(bits)
    n = len(bits)
    out: list[int] = []
    prev = 0
    for i in range(num_locations):
        if r.off + 1 > n:
            return None
        if i == 0 or r.u(1):
            if r.off + full_len > n:
                return None
            loc = r.u_rev(full_len)
        else:
            if r.off + compressed_len > n:
                return None
            new_digits = r.u_rev(compressed_len)
            old_digits = (prev % 100000) - (prev % 1000)
            loc = (new_digits // 1000) * 100000 + new_digits % 1000 + old_digits
        out.append(loc)
        prev = loc
    return out


def decode_control_data(cnt: bytes):
    """Alert CNT header: categories + location list
    (reference: src/pids.c:247-267).  Returns (category1, category2,
    location_format, locations)."""
    bits = np.unpackbits(np.frombuffer(cnt, np.uint8), bitorder="little")
    r = BitReader(bits)
    r.skip(8 + 12 + 8)  # unknown, CNT CRC, unknown
    category1 = r.u_rev(5)
    category2 = r.u_rev(5)
    r.skip(9)
    location_format = r.u_rev(3)
    num_locations = r.u_rev(5)
    r.skip(1)
    locations = decode_locations(bits[r.off:], location_format, num_locations)
    return category1, category2, location_format, locations or []


class PIDSDecoder:
    """Stateful SIS decoder; one instance per session.

    ``emit`` receives individual station-info events plus the aggregate
    ``SIS`` event after any update (reference: src/pids.c:283-383).
    """

    def __init__(self, emit):
        self.emit = emit
        self.reset()

    def reset(self):
        self.country_code: str | None = None
        self.fcc_facility_id: int | None = None
        self.short_name: str | None = None
        self.long_name = _Assembler()
        self.long_name_last_frame = 0
        self.latitude = math.nan
        self.longitude = math.nan
        self.altitude = 0
        self.message = _Assembler()
        self.message_meta = {"priority": 0, "encoding": 0, "len": -1,
                             "checksum": 0}
        self.audio_services = [_AudioService() for _ in range(MAX_AUDIO_SERVICES)]
        self.data_services = [_DataService() for _ in range(MAX_DATA_SERVICES)]
        self.parameters = [-1] * NUM_PARAMETERS
        self.usn = _Assembler()
        self.usn_meta = {"encoding": 0, "append": -1, "len": -1}
        self.slogan = _Assembler()
        self.slogan_meta = {"encoding": 0, "len": -1}
        self.alert = _Assembler()
        self.alert_meta = {"encoding": 0, "len": -1, "crc": 0, "cnt_len": 0}
        self.alert_timeout = 0

    # ------------------------------------------------------------------
    def frame_push(self, bits: np.ndarray):
        """Push one descrambled 80-bit PIDS frame (device bit order).

        The stream is MSB-first within bytes; frame order reverses bits
        within each byte (reference: src/pids.c:1032-1040).
        """
        bits = np.asarray(bits, np.uint8).reshape(10, 8)[:, ::-1].reshape(-1)
        if crc12(bits) != self._crc_field(bits):
            return
        # one type BIT, then the SIS PDU (reference: src/pids.c:1042-1049)
        if bits[0] == PIDS_TYPE_SIS:
            self._sis_decode(bits[1:])
        # LLDS frames ignored (reference: src/pids.c:1048-1049)

    @staticmethod
    def _crc_field(bits: np.ndarray) -> int:
        v = 0
        for i in range(68, 80):
            v = (v << 1) | int(bits[i])
        return v

    # ------------------------------------------------------------------
    def _sis_decode(self, bits: np.ndarray):
        r = BitReader(bits)
        payloads = r.u(1) + 1
        updated = False

        if self.alert.displayed:
            self.alert_timeout += 1

        for _ in range(payloads):
            if r.off > 59:
                break
            msg_id = r.u(4)
            size = PAYLOAD_SIZES.get(msg_id)
            if size is None or r.off > 64 - size:
                break
            body = BitReader(bits, r.off)
            r.skip(size)
            handler = {
                MSG_STATION_ID: self._station_id,
                MSG_STATION_NAME_SHORT: self._short_name,
                MSG_STATION_NAME_LONG: self._long_name,
                MSG_STATION_LOCATION: self._location,
                MSG_STATION_MESSAGE: self._message,
                MSG_SERVICE_INFORMATION: self._service_info,
                MSG_ADV_SERVICE_INFORMATION: self._service_info,
                MSG_PARAMETER_MESSAGE: self._parameter,
                MSG_UNIVERSAL_SHORT_STATION_NAME: self._universal_name,
                MSG_EMERGENCY_ALERTS: self._alerts,
            }.get(msg_id)
            if handler is not None:
                updated |= bool(handler(body))

        if self.alert.displayed and self.alert_timeout >= ALERT_TIMEOUT_LIMIT:
            self.alert = _Assembler()
            self.alert_meta = {"encoding": 0, "len": -1, "crc": 0, "cnt_len": 0}
            self.alert_timeout = 0
            self.emit(make(EventType.EMERGENCY_ALERT, message=None,
                           control_data=None, category1=None, category2=None,
                           location_format=None, locations=None))
            updated = True

        if updated:
            self._report()

    # ------------------------------------------------------------------
    def _station_id(self, r: BitReader) -> bool:
        country = r.char5() + r.char5()
        r.skip(3)
        fcc_id = r.u(19)
        if (country, fcc_id) != (self.country_code, self.fcc_facility_id):
            self.country_code = country
            self.fcc_facility_id = fcc_id
            self.emit(make(EventType.STATION_ID, country_code=country,
                           fcc_facility_id=fcc_id))
            return True
        return False

    def _short_name(self, r: BitReader) -> bool:
        name = "".join(r.char5() for _ in range(4))
        if r.u(2) == 0b01:
            name += "-FM"
        if name != self.short_name:
            self.short_name = name
            self.emit(make(EventType.STATION_NAME, name=name))
            return True
        return False

    def _long_name(self, r: BitReader) -> bool:
        last_frame = r.u(3)
        current = r.u(3)
        seq = BitReader(r.bits, r.off + 49).u(3)
        if current == 0 and seq != self.long_name.seq:
            self.long_name.restart(seq)
        chunk = bytes(r.u(7) for _ in range(7))
        self.long_name.put(current * 7, chunk, current)
        self.long_name_last_frame = max(self.long_name_last_frame, last_frame)
        if (self.long_name.seq >= 0 and not self.long_name.displayed
                and self.long_name.complete(last_frame + 1)):
            self.long_name.displayed = True
            if not self.slogan.displayed:
                text = self._long_name_text()
                self.emit(make(EventType.STATION_SLOGAN, slogan=text))
            return True
        return False

    def _long_name_text(self) -> str:
        raw = bytes(self.long_name.data).split(b"\0")[0]
        return raw.decode("latin-1")

    def _location(self, r: BitReader) -> bool:
        is_lat = r.u(1)
        val = r.s(22) / 8192.0
        nib = r.u(4)
        if is_lat:
            changed = (val != self.latitude
                       or (nib << 8) != (self.altitude & 0xF00))
            self.latitude = val
            self.altitude = (self.altitude & 0x0F0) | (nib << 8)
            ready = not math.isnan(self.longitude)
        else:
            changed = (val != self.longitude
                       or (nib << 4) != (self.altitude & 0x0F0))
            self.longitude = val
            self.altitude = (self.altitude & 0xF00) | (nib << 4)
            ready = not math.isnan(self.latitude)
        if changed and ready:
            self.emit(make(EventType.STATION_LOCATION, latitude=self.latitude,
                           longitude=self.longitude, altitude=self.altitude))
            return True
        return False

    def _message(self, r: BitReader) -> bool:
        current = r.u(5)
        seq = r.u(2)
        if current == 0:
            if seq != self.message.seq:
                self.message.restart(seq)
            self.message_meta = {
                "priority": r.u(1), "encoding": r.u(3),
                "len": r.u(8), "checksum": r.u(7)}
            self.message.put(0, bytes(r.u(8) for _ in range(4)), 0)
        else:
            r.skip(3)
            self.message.put(current * 6 - 2,
                             bytes(r.u(8) for _ in range(6)), current)
        m = self.message_meta
        if (self.message.seq >= 0 and not self.message.displayed
                and m["len"] >= 0
                and self.message.complete((m["len"] + 7) // 6)):
            data = bytes(self.message.data[:m["len"]])
            checksum = sum(data)
            checksum = (((checksum >> 8) & 0x7F) + (checksum & 0xFF)) & 0x7F
            if checksum == m["checksum"]:
                self.message.displayed = True
                self.emit(make(EventType.STATION_MESSAGE,
                               message=decode_text(m["encoding"], data)))
                return True
        return False

    def _service_info(self, r: BitReader) -> bool:
        category = r.u(2)
        if category == 0:  # audio
            access = r.u(1)
            prog = r.u(6)
            type_ = r.u(8)
            r.skip(5)
            sound_exp = r.u(5)
            if prog >= MAX_AUDIO_SERVICES:
                return False
            svc = self.audio_services[prog]
            if (svc.access, svc.type, svc.sound_exp) != (access, type_, sound_exp):
                self.audio_services[prog] = _AudioService(access, type_, sound_exp)
                self.emit(make(EventType.AUDIO_SERVICE_DESCRIPTOR,
                               program=prog, access=access, type=type_,
                               sound_exp=sound_exp))
                return True
        elif category == 1:  # data
            access = r.u(1)
            type_ = r.u(9)
            r.skip(3)
            mime = r.u(12)
            for svc in self.data_services:
                if (svc.access, svc.type, svc.mime_type) == (access, type_, mime):
                    break
                if svc.type == -1:
                    svc.access, svc.type, svc.mime_type = access, type_, mime
                    self.emit(make(EventType.DATA_SERVICE_DESCRIPTOR,
                                   access=access, type=type_, mime_type=mime))
                    return True
        return False

    def _parameter(self, r: BitReader) -> bool:
        index = r.u(6)
        value = r.u(16)
        if index >= NUM_PARAMETERS or self.parameters[index] == value:
            return False
        self.parameters[index] = value
        p = self.parameters
        if index in (0, 1, 2) and p[0] >= 0 and p[1] >= 0 and p[2] >= 0:
            self.emit(make(EventType.LEAP_SECOND_OFFSET,
                           pending_offset=p[0] >> 8,
                           current_offset=p[0] & 0xFF,
                           pending_alfn=(p[2] << 16) | p[1]))
        elif index == 3:
            tzo = (p[3] >> 5) & 0x7FF
            if tzo >= 1024:
                tzo -= 2048
            self.emit(make(EventType.LOCAL_TIME, utc_offset=tzo,
                           dst_sched=(p[3] >> 2) & 0x7,
                           dst_local=(p[3] >> 1) & 0x1,
                           dst_regional=p[3] & 0x1))
        elif index in (4, 5, 6, 7) and all(p[i] >= 0 for i in (4, 5, 6, 7)):
            self.emit(make(
                EventType.EXCITER_INFO,
                manufacturer_id=chr((p[4] >> 8) & 0x7F) + chr(p[4] & 0x7F),
                core_version=((p[5] >> 11) & 0x1F, (p[5] >> 6) & 0x1F,
                              (p[5] >> 1) & 0x1F, (p[7] >> 11) & 0x1F),
                manufacturer_version=((p[6] >> 11) & 0x1F, (p[6] >> 6) & 0x1F,
                                      (p[6] >> 1) & 0x1F, (p[7] >> 6) & 0x1F),
                core_status=(p[7] >> 3) & 0x7,
                manufacturer_status=p[7] & 0x7,
                importer_connected=(p[4] >> 7) & 0x1))
        elif index in (8, 9, 10, 11) and all(p[i] >= 0 for i in (8, 9, 10, 11)):
            self.emit(make(
                EventType.IMPORTER_INFO,
                manufacturer_id=chr((p[8] >> 8) & 0x7F) + chr(p[8] & 0x7F),
                core_version=((p[9] >> 11) & 0x1F, (p[9] >> 6) & 0x1F,
                              (p[9] >> 1) & 0x1F, (p[11] >> 11) & 0x1F),
                manufacturer_version=((p[10] >> 11) & 0x1F, (p[10] >> 6) & 0x1F,
                                      (p[10] >> 1) & 0x1F, (p[11] >> 6) & 0x1F),
                core_status=(p[11] >> 3) & 0x7,
                manufacturer_status=p[11] & 0x7))
        return False  # parameters never trigger the aggregate SIS report

    def _universal_name(self, r: BitReader) -> bool:
        current = r.u(4)
        is_slogan = r.u(1)
        if not is_slogan:
            if current >= 8:
                return False
            if current == 0:
                self.usn_meta = {"encoding": r.u(3), "append": r.u(1),
                                 "len": r.u(1) + 1}
                self.usn.put(0, bytes(r.u(8) for _ in range(6)), 0)
            else:
                r.skip(5)
                self.usn.put(current * 6, bytes(r.u(8) for _ in range(6)),
                             current)
            m = self.usn_meta
            if (m["len"] >= 0 and not self.usn.displayed
                    and self.usn.complete(m["len"])):
                self.usn.displayed = True
                raw = bytes(self.usn.data).split(b"\0")[0]
                name = decode_text(m["encoding"], raw)
                if name is not None and m["append"]:
                    name += "-FM"
                self.emit(make(EventType.STATION_NAME, name=name))
                return True
        else:
            if current == 0:
                self.slogan_meta = {"encoding": r.u(3)}
                r.skip(3)
                self.slogan_meta["len"] = r.u(7)
                self.slogan.put(0, bytes(r.u(8) for _ in range(5)), 0)
            else:
                r.skip(5)
                self.slogan.put(current * 6 - 1,
                                bytes(r.u(8) for _ in range(6)), current)
            m = self.slogan_meta
            if (m.get("len", -1) >= 0 and not self.slogan.displayed
                    and self.slogan.complete((m["len"] + 6) // 6)):
                self.slogan.displayed = True
                if not self.long_name.displayed:
                    text = decode_text(m["encoding"],
                                       bytes(self.slogan.data[:m["len"]]))
                    self.emit(make(EventType.STATION_SLOGAN, slogan=text))
                return True
        return False

    def _alerts(self, r: BitReader) -> bool:
        current = r.u(6)
        seq = r.u(2)
        r.skip(2)
        self.alert_timeout = 0
        if current == 0:
            if seq != self.alert.seq:
                self.alert.restart(seq)
            self.alert_meta = {"encoding": r.u(3), "len": r.u(9),
                               "crc": r.u(7), "cnt_len": 1 + 2 * r.u(5)}
            self.alert.put(0, bytes(r.u(8) for _ in range(3)), 0)
        else:
            self.alert.put(current * 6 - 3,
                           bytes(r.u(8) for _ in range(6)), current)
        m = self.alert_meta
        if (m["len"] >= 0 and not self.alert.displayed
                and self.alert.complete((m["len"] + 8) // 6)):
            payload = bytes(self.alert.data[:m["len"]])
            if m["crc"] != alert_crc7(payload):
                return False
            cnt_len = m["cnt_len"]
            if cnt_len < 7 or m["len"] < cnt_len:
                return False
            actual_cnt_crc = ((payload[2] & 0x0F) << 8) | payload[1]
            if actual_cnt_crc != alert_cnt_crc(payload[:cnt_len]):
                return False
            self.alert.displayed = True
            cat1, cat2, loc_fmt, locations = decode_control_data(
                payload[:cnt_len])
            message = decode_text(m["encoding"], payload[cnt_len:])
            self.emit(make(EventType.EMERGENCY_ALERT, message=message,
                           control_data=payload[:cnt_len], category1=cat1,
                           category2=cat2, location_format=loc_fmt,
                           locations=locations))
            return True
        return False

    # ------------------------------------------------------------------
    def _report(self):
        """Aggregate SIS snapshot event (reference: src/pids.c:283-383)."""
        name = None
        if self.usn.displayed:
            m = self.usn_meta
            raw = bytes(self.usn.data).split(b"\0")[0]
            name = decode_text(m["encoding"], raw)
            if name is not None and m["append"]:
                name += "-FM"
        elif self.short_name:
            name = self.short_name

        slogan = None
        if self.slogan.displayed:
            m = self.slogan_meta
            slogan = decode_text(m["encoding"],
                                 bytes(self.slogan.data[:m["len"]]))
        elif self.long_name.displayed:
            slogan = self._long_name_text()

        message = None
        if self.message.displayed:
            m = self.message_meta
            message = decode_text(m["encoding"],
                                  bytes(self.message.data[:m["len"]]))

        alert = None
        alert_info = {}
        if self.alert.displayed:
            m = self.alert_meta
            payload = bytes(self.alert.data[:m["len"]])
            alert = decode_text(m["encoding"], payload[m["cnt_len"]:])
            cat1, cat2, loc_fmt, locations = decode_control_data(
                payload[:m["cnt_len"]])
            alert_info = dict(alert_cnt=payload[:m["cnt_len"]],
                              alert_category1=cat1, alert_category2=cat2,
                              alert_location_format=loc_fmt,
                              alert_locations=locations)

        lat = lon = alt = None
        if not math.isnan(self.latitude) and not math.isnan(self.longitude):
            lat, lon, alt = self.latitude, self.longitude, self.altitude

        audio_services = [
            dict(program=i, access=s.access, type=s.type, sound_exp=s.sound_exp)
            for i, s in enumerate(self.audio_services) if s.type != -1]
        data_services = [
            dict(access=s.access, type=s.type, mime_type=s.mime_type)
            for s in self.data_services if s.type != -1]

        self.emit(make(
            EventType.SIS, country_code=self.country_code,
            fcc_facility_id=self.fcc_facility_id, name=name, slogan=slogan,
            message=message, alert=alert, latitude=lat, longitude=lon,
            altitude=alt, audio_services=audio_services,
            data_services=data_services, **alert_info))
