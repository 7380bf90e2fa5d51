"""L2 transport: PDU framing, RS header fix, HDLC, audio packet extraction.

Host-side parsing of decoded logical-channel bit frames (reference:
src/frame.c).  The bit-order swap + PCI extraction are static index tables
applied with numpy; everything downstream is byte-level control flow.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import native
from nrsc5_tpu_torch.ops.rs import rs_decode_pdu
from nrsc5_tpu_torch.utils.crc import VALIDFCS16, fcs16


def _crc8(data) -> int:
    """Per-packet CRC through the native kernel when available (one call
    per audio packet on the transport hot path)."""
    return native.crc8(bytes(data))

# logical channels
P1, P3, P4 = 0, 1, 2

MAX_AAS_LEN = 8212

# packet shapes (reference: src/output.h)
PACKET_FULL, PACKET_HALF_FRONT, PACKET_HALF_BACK = 0, 1, 2


@functools.lru_cache(maxsize=8)
def _frame_tables(length: int):
    """(swap_idx, pci_positions, data_positions) for frame_push's bit
    reorder + PCI extraction (reference: src/frame.c:645-711)."""
    if length == C.P1_FRAME_LEN_FM:
        start, offset, pci_len = length - 30000, 1248, 24
    elif length == C.P3_FRAME_LEN_MP3_MP11:
        start, offset, pci_len = 120, 184, 24
    elif length == C.P3_FRAME_LEN_MP2:
        start, offset, pci_len = 120, 88, 24
    elif length == C.P1_FRAME_LEN_AM:
        start, offset, pci_len = 120, 160, 22
    elif length == C.P3_FRAME_LEN_MA1:
        start, offset, pci_len = 120, 992, 24
    elif length == C.P3_FRAME_LEN_MA3:
        start, offset, pci_len = 120, 1240, 24
    else:
        raise ValueError(f"unknown frame length {length}")

    i = np.arange(length, dtype=np.int64)
    byte_start = (i >> 3) << 3
    byte_len = np.minimum(length - byte_start, 8)
    swap_idx = byte_start + byte_len - 1 - (i & 7)

    is_pci = (i >= start) & (((i - start) % offset) == 0)
    # only the first pci_len such positions
    pci_pos = np.nonzero(is_pci)[0][:pci_len]
    mask = np.zeros(length, dtype=bool)
    mask[pci_pos] = True
    data_pos = np.nonzero(~mask)[0]
    return swap_idx.astype(np.int32), pci_pos.astype(np.int32), data_pos.astype(np.int32)


@functools.lru_cache(maxsize=8)
def _frame_tables_fused(length: int):
    """Source index in the ORIGINAL bit array for each pci/payload output
    position, so frame_unpack's swap + split are one gather each."""
    swap_idx, pci_pos, data_pos = _frame_tables(length)
    return (swap_idx[pci_pos].astype(np.int32),
            swap_idx[data_pos].astype(np.int32))


def frame_unpack(bits: np.ndarray):
    """bits: [L] uint8 decoded frame -> (pci int, payload bytes ndarray)."""
    fused_pci, fused_data = _frame_tables_fused(len(bits))
    pci = 0
    for b in bits[fused_pci]:
        pci = (pci << 1) | int(b)
    pci <<= 24 - len(fused_pci)
    data = native.gather_pack(bits, fused_data)
    if data is None:
        data = np.packbits(bits[fused_data])
    return pci, data


@dataclass
class PacketRef:
    program: int
    stream_id: int
    data: bytes
    seq: int
    crc_error: bool
    shape: int  # PACKET_FULL / HALF_FRONT / HALF_BACK


@dataclass
class _HdlcBuf:
    buf: bytearray = field(default_factory=bytearray)
    active: bool = False  # C's bufidx >= 0


def parse_hdlc(state: _HdlcBuf, data: bytes, process: Callable[[bytes], None],
               bufsz: int = MAX_AAS_LEN):
    """0x7E-delimited HDLC framing (reference: src/frame.c:369-391).
    Unescaping happens in the consumer."""
    for byte in data:
        if byte == 0x7E:
            if state.active:
                process(bytes(state.buf))
            state.buf.clear()
            state.active = True
        elif state.active:
            if len(state.buf) >= bufsz:
                state.active = False
                state.buf.clear()
                continue
            state.buf.append(byte)


def unescape_hdlc(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        if data[i] == 0x7D and i + 1 < len(data):
            out.append(data[i + 1] | 0x20)
            i += 2
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def _parse_header(buf: np.ndarray) -> dict:
    """14-byte audio PDU header (reference: src/frame.c:181-196)."""
    return dict(
        codec_mode=int(buf[8]) & 0xF,
        stream_id=(int(buf[8]) >> 4) & 0x3,
        pdu_seq=(int(buf[8]) >> 6) | ((int(buf[9]) & 1) << 2),
        blend_control=(int(buf[9]) >> 1) & 0x3,
        per_stream_delay=int(buf[9]) >> 3,
        common_delay=int(buf[10]) & 0x3F,
        latency=(int(buf[10]) >> 6) | ((int(buf[11]) & 1) << 2),
        pfirst=(int(buf[11]) >> 1) & 1,
        plast=(int(buf[11]) >> 2) & 1,
        seq=(int(buf[11]) >> 3) | ((int(buf[12]) & 1) << 5),
        nop=(int(buf[12]) >> 1) & 0x3F,
        hef=int(buf[12]) >> 7,
        la_location=int(buf[13]),
    )


def _parse_hef(buf: np.ndarray, hef: dict) -> int:
    """Header expansion fields (reference: src/frame.c:198-265).
    Returns consumed length."""
    i, end = 0, len(buf)
    while True:
        if i >= end:
            return end
        byte = int(buf[i])
        tag = (byte >> 4) & 0x7
        if tag == 0:
            hef["class_ind"] = byte & 0xF
        elif tag == 1:
            hef["prog_num"] = (byte >> 1) & 0x7
            if byte & 0x1:
                if i + 2 >= end:
                    return end
                hef["pdu_len"] = ((int(buf[i + 1]) & 0x7F) << 7) | (int(buf[i + 2]) & 0x7F)
                i += 2
                byte = int(buf[i])
        elif tag == 2:
            if i + 1 >= end:
                return end
            hef["access"] = (byte >> 3) & 0x1
            hef["prog_type"] = ((byte & 0x1) << 7) | (int(buf[i + 1]) & 0x7F)
            i += 1
            byte = int(buf[i])
        elif tag == 3:
            step = 4 if byte & 0x8 else 3
            if i + step >= end:
                return end
            i += step
            byte = int(buf[i])
        elif tag == 4:
            if byte & 0x8:
                if i + 3 >= end:
                    return end
                hef["applied_services"] = byte & 0x7
                hef["pdu_marker"] = ((int(buf[i + 1]) & 0x7F) << 14) \
                    | ((int(buf[i + 2]) & 0x7F) << 7) | (int(buf[i + 3]) & 0x7F)
                i += 3
                byte = int(buf[i])
            else:
                if i + 1 >= end:
                    return end
                i += 1
                byte = int(buf[i])
        i += 1
        if not (byte & 0x80):
            return i


def _calc_lc_bits(codec_mode: int, stream_id: int) -> int:
    if codec_mode == 0:
        return 16
    if codec_mode in (1, 2, 3):
        return 12 if stream_id == 0 else 16
    if codec_mode in (10, 13):
        return 12
    return 16


def _calc_avg_packets(codec_mode: int, stream_id: int) -> int:
    if codec_mode == 0:
        return 32
    if codec_mode in (1, 2, 3):
        return 4 if stream_id == 0 else 32
    if codec_mode == 10:
        return 32 if stream_id == 0 else 4
    if codec_mode == 13:
        return 4
    return 32


def _parse_location(buf: np.ndarray, lc_bits: int, i: int) -> int:
    if lc_bits == 16:
        return (int(buf[2 * i + 1]) << 8) | int(buf[2 * i])
    if i % 2 == 0:
        return ((int(buf[i // 2 * 3 + 1]) & 0xF) << 8) | int(buf[i // 2 * 3])
    return (int(buf[i // 2 * 3 + 2]) << 4) | (int(buf[i // 2 * 3 + 1]) >> 4)


class FrameDecoder:
    """Transport decoder for one station.

    Callbacks:
      * output.push_packet(PacketRef)
      * output.align(program, stream_id, offset)
      * output.aas_push(payload_bytes)
      * on_audio_service(info dict)
      * on_resync() — hard L1 resync request
    """

    def __init__(self, output, on_audio_service=None, on_resync=None):
        self.output = output
        self.on_audio_service = on_audio_service or (lambda info: None)
        self.on_resync = on_resync or (lambda: None)
        self.reset()

    def reset(self):
        self.services = {}
        self.psd_hdlc = [_HdlcBuf() for _ in range(C.MAX_PROGRAMS)]
        self.ccc = {lc: _FixedChannelState() for lc in (P1, P3, P4)}

    # ------------------------------------------------------------------
    def push_frame(self, bits: np.ndarray, lc: int) -> bool:
        """Returns False when the frame's first audio PDU header failed RS —
        the signal the receiver uses to resolve the interleaver-IV cycle
        ambiguity (no reference analog; frame.c:535-540 only hard-resyncs)."""
        pci, data = frame_unpack(bits)
        return self._process(pci, data, len(bits), lc)

    # ------------------------------------------------------------------
    def _process(self, pci: int, buf: np.ndarray, frame_bits: int, lc: int):
        masked = pci & 0xFFFFFC
        has_audio = masked != (C.PCI_FIXED & 0xFFFFFC)
        has_fixed = masked in (C.PCI_AUDIO_FIXED & 0xFFFFFC,
                               C.PCI_AUDIO_FIXED_OPP & 0xFFFFFC,
                               C.PCI_FIXED & 0xFFFFFC)
        audio_end = len(buf)
        if has_fixed:
            audio_end = _process_fixed_data(self, buf, lc)
        if not has_audio:
            return True

        offset = 0
        while offset < audio_end - C.RS_CODEWORD_LEN:
            start = offset
            cw, ok, _ = rs_decode_pdu(buf[offset:offset + 96])
            if not ok:
                # hard resync if the first PDU of a full frame fails
                # (reference: src/frame.c:535-540)
                if frame_bits in (C.P1_FRAME_LEN_FM, C.P1_FRAME_LEN_AM) \
                        and offset == 0 and len(buf) in (C.MAX_PDU_LEN, C.P1_PDU_LEN_AM):
                    self.on_resync()
                return offset != 0
            buf = buf.copy()
            buf[offset:offset + 96] = cw

            hdr = _parse_header(buf[offset:])
            offset += 14
            lc_bits = _calc_lc_bits(hdr["codec_mode"], hdr["stream_id"])
            loc_bytes = ((lc_bits * hdr["nop"]) + 4) // 8
            if (start + hdr["la_location"] + 1 < offset + loc_bytes
                    or start + hdr["la_location"] >= audio_end):
                return True

            locations = []
            for j in range(hdr["nop"]):
                loc = _parse_location(buf[offset:], lc_bits, j)
                if j == 0 and loc <= hdr["la_location"]:
                    return True
                if j > 0 and loc <= locations[-1]:
                    return True
                if start + loc >= audio_end:
                    return True
                locations.append(loc)
            offset += loc_bytes

            if hdr["stream_id"] >= C.MAX_STREAMS:
                offset = start + locations[-1] + 1 if locations else audio_end
                continue

            hef = {"class_ind": 0, "prog_num": 0, "pdu_len": 0,
                   "prog_type": 0, "access": 0, "applied_services": 0,
                   "pdu_marker": 0}
            if hdr["hef"]:
                offset += _parse_hef(buf[offset:audio_end], hef)
            prog = hef["prog_num"]

            svc_key = prog
            svc = (hef["access"], hef["prog_type"], hdr["codec_mode"],
                   hdr["blend_control"], hdr["per_stream_delay"],
                   hdr["common_delay"], hdr["latency"])
            if hdr["stream_id"] == 0 and self.services.get(svc_key) != svc:
                self.services[svc_key] = svc
                gain = hdr["per_stream_delay"]
                self.on_audio_service(dict(
                    program=prog, access=hef["access"], type=hef["prog_type"],
                    codec_mode=hdr["codec_mode"],
                    blend_control=hdr["blend_control"],
                    digital_audio_gain=gain if gain < 16 else gain - 32,
                    common_delay=hdr["common_delay"] * 4,
                    latency=hdr["latency"] * 2))

            avg = _calc_avg_packets(hdr["codec_mode"], hdr["stream_id"])
            eb = C.ELASTIC_BUFFER_LEN
            seq = (eb + hdr["seq"] - hdr["pfirst"]) % eb
            output_offset = (eb + (hdr["pdu_seq"] * avg) - (hdr["latency"] * 2)) % eb
            if ((eb + seq - output_offset) % eb) >= (eb // 2):
                output_offset = (output_offset + eb // 2) % eb
            self.output.align(prog, hdr["stream_id"], output_offset)

            # PSD bytes between header and first packet
            psd_end = start + hdr["la_location"] + 1
            parse_hdlc(self.psd_hdlc[prog], bytes(buf[offset:psd_end]),
                       self._make_aas_handler())
            offset = psd_end

            for j in range(hdr["nop"]):
                cnt = start + locations[j] - offset
                pkt = bytes(buf[offset:offset + cnt])
                crc_err = _crc8(buf[offset:offset + cnt + 1]) != 0
                if j == 0 and hdr["pfirst"]:
                    shape = PACKET_HALF_BACK
                elif j == hdr["nop"] - 1 and hdr["plast"]:
                    shape = PACKET_HALF_FRONT
                else:
                    shape = PACKET_FULL
                self.output.push_packet(PacketRef(
                    program=prog, stream_id=hdr["stream_id"], data=pkt,
                    seq=seq, crc_error=crc_err, shape=shape))
                offset += cnt + 1
                seq = (seq + 1) % eb
        return True

    # ------------------------------------------------------------------
    def _make_aas_handler(self):
        from nrsc5_tpu_torch import native

        def handler(raw: bytes):
            if len(raw) == 0:
                return  # padding
            payload = native.aas_frame(raw)
            if payload is not None:
                self.output.aas_push(payload)
        return handler


# ---------------------------------------------------------------------------
# Fixed data subchannels (reference: src/frame.c:393-514)
# ---------------------------------------------------------------------------

BBM_MAGIC = b"\x7d\x3a\xe2\x42"


@dataclass
class _FixedSubchannel:
    mode: int = -1
    length: int = 0
    blocks: bytearray = field(default_factory=bytearray)
    hdlc: _HdlcBuf = field(default_factory=_HdlcBuf)


@dataclass
class _FixedChannelState:
    ready: bool = False
    sync_width: int = 0
    sync_count: int = 0
    ccc_hdlc: _HdlcBuf = field(default_factory=_HdlcBuf)
    subchannels: list = field(default_factory=lambda: [
        _FixedSubchannel() for _ in range(4)])


def _sync_width(byte: int) -> int:
    if byte == 0x00:
        return 1
    if (byte >> 4) == (byte & 0xF):
        return (byte & 0xF) * 2
    return 0


def _process_fixed_data(dec: FrameDecoder, buf: np.ndarray, lc: int) -> int:
    st = dec.ccc[lc]
    p = len(buf) - 1

    if st.sync_count < 2:
        width = _sync_width(int(buf[p]))
        if width > 0 and st.sync_width == width:
            st.sync_count += 1
        else:
            st.sync_count = 0
        st.sync_width = width
        if st.sync_count < 2:
            return p

    p -= st.sync_width
    parse_hdlc(st.ccc_hdlc, bytes(buf[p:p + st.sync_width]),
               lambda raw: _process_ccc(dec, st, raw))

    if not st.ready:
        return p

    for i in range(3, -1, -1):
        sub = st.subchannels[i]
        if sub.length == 0:
            continue
        p -= sub.length
        for j in range(sub.length):
            sub.blocks.append(int(buf[p + j]))
            if len(sub.blocks) == 4 and bytes(sub.blocks) != BBM_MAGIC:
                del sub.blocks[0]
            if len(sub.blocks) == 255 + 4:
                parse_hdlc(sub.hdlc, bytes(sub.blocks[4:]),
                           dec._make_aas_handler())
                sub.blocks.clear()
    return p


def _process_ccc(dec: FrameDecoder, st: _FixedChannelState, raw: bytes):
    payload = unescape_hdlc(raw)
    if len(payload) == 0 or st.ready:
        return
    if fcs16(payload) != VALIDFCS16:
        return
    for i in range(4):
        sub = st.subchannels[i]
        sub.mode = -1
        sub.length = 0
        if 5 + i * 4 <= len(payload):
            mode = payload[1 + i * 4] | (payload[2 + i * 4] << 8)
            length = payload[3 + i * 4] | (payload[4 + i * 4] << 8)
            if mode == 0:
                sub.mode = mode
                sub.length = length
                sub.blocks.clear()
    st.ready = True
