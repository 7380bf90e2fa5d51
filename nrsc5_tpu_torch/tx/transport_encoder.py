"""L2 transport encoder (truth harness): audio packets + PSD → P1 frame
bits.  Exact inverse of transport/frame.py's decoder (reference inverse:
src/frame.c:181-343,516-643)."""

from __future__ import annotations

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops.rs import rs_encode_pdu
from nrsc5_tpu_torch.transport.frame import _frame_tables
from nrsc5_tpu_torch.utils.crc import crc8, fcs16_append

AAS_PROTO = 0x21


def hdlc_escape(data: bytes) -> bytes:
    out = bytearray()
    for b in data:
        if b in (0x7E, 0x7D):
            out += bytes([0x7D, b & ~0x20])
        else:
            out.append(b)
    return bytes(out)


def aas_frame(port: int, seq: int, payload: bytes) -> bytes:
    """Build one HDLC-framed AAS packet (protocol 0x21)."""
    inner = bytes([AAS_PROTO, port & 0xFF, port >> 8, seq & 0xFF, seq >> 8])
    inner += payload
    return b"\x7e" + hdlc_escape(fcs16_append(inner)) + b"\x7e"


def build_audio_pdu(packets: list[bytes], program: int = 0,
                    pdu_seq: int = 0, seq: int = 0, psd: bytes = b"",
                    codec_mode: int = 0, latency: int = 0,
                    pfirst: bool = False, plast: bool = False,
                    total_len: int | None = None) -> np.ndarray:
    """One audio PDU as a byte array.

    packets: HDC packet payloads (each gets a CRC-8 byte appended).
    psd: pre-framed HDLC bytes (from :func:`aas_frame`) carried between the
      header and the first packet.
    Layout: [8 RS parity | 6 control | HEF(1) | locations | PSD | packets].
    """
    nop = len(packets)
    assert nop <= C.MAX_AUDIO_PACKETS
    # location width per codec mode (reference: src/frame.c:267-313)
    lc_bits = 16 if codec_mode == 0 else 12
    assert codec_mode in (0, 13), "harness supports codec modes 0 and 13"
    loc_bytes = (lc_bits * nop + 4) // 8

    hef = bytes([(1 << 4) | ((program & 7) << 1)])
    header_len = 14 + loc_bytes + len(hef)
    la_location = header_len + len(psd) - 1

    body = bytearray()
    b8 = (codec_mode & 0xF) | ((pdu_seq & 0x3) << 6)  # stream_id = 0
    b9 = (pdu_seq >> 2) & 1  # blend/delay 0
    b10 = (latency & 0x3) << 6  # common_delay 0
    b11 = ((latency >> 2) & 1) | (int(pfirst) << 1) | (int(plast) << 2) \
        | ((seq & 0x1F) << 3)
    b12 = ((seq >> 5) & 1) | ((nop & 0x3F) << 1) | 0x80  # hef present
    b13 = la_location & 0xFF
    assert la_location < 256
    body += bytes([b8, b9, b10, b11, b12, b13])

    # packet end locations, relative to PDU start
    locs = []
    pos = la_location + 1
    for pkt in packets:
        pos += len(pkt)
        locs.append(pos)  # index of the CRC byte
        pos += 1
    loc_field = bytearray(loc_bytes)
    for j, loc in enumerate(locs):
        if lc_bits == 16:
            loc_field[2 * j] = loc & 0xFF
            loc_field[2 * j + 1] = loc >> 8
        elif j % 2 == 0:  # 12-bit packing (reference: src/frame.c:315-326)
            loc_field[j // 2 * 3] = loc & 0xFF
            loc_field[j // 2 * 3 + 1] |= (loc >> 8) & 0xF
        else:
            loc_field[j // 2 * 3 + 1] |= (loc & 0xF) << 4
            loc_field[j // 2 * 3 + 2] = loc >> 4
    body += loc_field
    body += hef
    body += psd

    payload = bytearray(body)
    for pkt in packets:
        payload += pkt
        payload.append(crc8(np.frombuffer(pkt, np.uint8)))
    assert len(payload) >= 88, "PDU too short for the RS codeword"
    # RS parity covers the first 88 payload bytes as transmitted
    cw = rs_encode_pdu(np.frombuffer(bytes(payload[:88]), np.uint8))
    pdu = bytearray(np.asarray(cw, np.uint8)[:8].tobytes())
    pdu += payload

    if total_len is not None:
        assert len(pdu) <= total_len, f"PDU {len(pdu)} > {total_len}"
        pdu = pdu.ljust(total_len, b"\x00")
    return np.frombuffer(bytes(pdu), np.uint8)


def pack_frame(pdu_bytes: np.ndarray, frame_len: int = C.P1_FRAME_LEN_FM,
               pci: int = C.PCI_AUDIO) -> np.ndarray:
    """PDU bytes + PCI -> frame bits (inverse of frame_unpack)."""
    swap_idx, pci_pos, data_pos = _frame_tables(frame_len)
    n_data = len(data_pos)
    data_bits = np.unpackbits(np.asarray(pdu_bytes, np.uint8))[:n_data]
    assert len(data_bits) == n_data, \
        f"PDU must fill the frame: {len(data_bits)} != {n_data}"
    swapped = np.zeros(frame_len, np.uint8)
    swapped[data_pos] = data_bits
    pci_len = len(pci_pos)
    for k in range(pci_len):
        swapped[pci_pos[k]] = (pci >> (23 - k)) & 1
    bits = np.zeros(frame_len, np.uint8)
    bits[swap_idx] = swapped
    return bits


def build_p1_fm_frame(packets: list[bytes], program: int = 0,
                      pdu_seq: int = 0, seq: int = 0,
                      psd: bytes = b"") -> np.ndarray:
    """Convenience: one-program MP1 P1 FM frame bits [146176]."""
    pdu = build_audio_pdu(packets, program=program, pdu_seq=pdu_seq,
                          seq=seq, psd=psd, total_len=C.MAX_PDU_LEN)
    return pack_frame(pdu, C.P1_FRAME_LEN_FM, C.PCI_AUDIO)


def build_p1_am_frame(packets: list[bytes], program: int = 0,
                      pdu_seq: int = 0, seq: int = 0,
                      psd: bytes = b"") -> np.ndarray:
    """One AM P1 frame (466-byte PDU, codec mode 13) bits [3750]."""
    pdu = build_audio_pdu(packets, program=program, pdu_seq=pdu_seq,
                          seq=seq, psd=psd, codec_mode=13,
                          total_len=C.P1_PDU_LEN_AM)
    return pack_frame(pdu, C.P1_FRAME_LEN_AM, C.PCI_AUDIO)
