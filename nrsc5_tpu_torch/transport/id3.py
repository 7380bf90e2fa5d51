"""ID3v2.3 PSD parsing (reference: src/output.c:248-491)."""

from __future__ import annotations


def _id3_length(buf: bytes) -> int:
    return ((buf[0] & 0x7F) << 21) | ((buf[1] & 0x7F) << 14) \
        | ((buf[2] & 0x7F) << 7) | (buf[3] & 0x7F)


def _decode_text(enc: int, data: bytes) -> str:
    if enc == 0:
        return data.decode("latin-1", errors="replace").rstrip("\x00")
    if enc == 1:
        # BOM-aware UCS-2
        if data[:2] == b"\xff\xfe":
            return data[2:].decode("utf-16-le", errors="replace").rstrip("\x00")
        if data[:2] == b"\xfe\xff":
            return data[2:].decode("utf-16-be", errors="replace").rstrip("\x00")
        return data.decode("utf-16-le", errors="replace").rstrip("\x00")
    return ""


def _id3_text(data: bytes) -> str:
    if len(data) > 0:
        return _decode_text(data[0], data[1:])
    return ""


def parse_id3(buf: bytes) -> dict | None:
    """Parse an ID3v2.3 blob into a dict of known fields.

    Returns None if the blob is not a valid ID3 container.
    """
    if len(buf) < 10 or buf[:5] != b"ID3\x03\x00" or buf[5]:
        return None
    id3_len = _id3_length(buf[6:10]) + 10
    if id3_len > len(buf):
        return None

    out = {
        "title": None, "artist": None, "album": None, "genre": None,
        "ufid_owner": None, "ufid_id": None,
        "xhdr_mime": 0, "xhdr_param": -1, "xhdr_lot": -1,
        "comments": [], "commercial": None,
    }
    off = 10
    while off + 10 <= id3_len:
        tag = buf[off:off + 4]
        frame_len = int.from_bytes(buf[off + 4:off + 8], "big")
        data = buf[off + 10:off + 10 + frame_len]
        if off + 10 + frame_len > id3_len:
            break

        if tag == b"TIT2":
            out["title"] = _id3_text(data)
        elif tag == b"TPE1":
            out["artist"] = _id3_text(data)
        elif tag == b"TALB":
            out["album"] = _id3_text(data)
        elif tag == b"TCON":
            out["genre"] = _id3_text(data)
        elif tag == b"UFID":
            delim = data.find(b"\x00")
            if delim >= 0:
                out["ufid_owner"] = data[:delim].decode("latin-1", "replace")
                out["ufid_id"] = data[delim + 1:].split(b"\x00")[0].decode("latin-1", "replace")
        elif tag == b"COMM" and frame_len >= 5:
            enc = data[0]
            lang = data[1:4].decode("latin-1", "replace")
            body = data[4:]
            if enc == 0:
                delim = body.find(b"\x00")
                if delim >= 0:
                    out["comments"].append(dict(
                        lang=lang,
                        short_content_desc=_decode_text(0, body[:delim]),
                        full_text=_decode_text(0, body[delim + 1:])))
            elif enc == 1:
                for i in range(0, len(body) - 1, 2):
                    if body[i] == 0 and body[i + 1] == 0:
                        out["comments"].append(dict(
                            lang=lang,
                            short_content_desc=_decode_text(1, body[:i]),
                            full_text=_decode_text(1, body[i + 2:])))
                        break
        elif tag == b"COMR" and frame_len >= 1:
            # commercial frame (reference: src/output.c:337-372): encoding,
            # price\0, valid-until YYYYMMDD, url\0, received_as,
            # seller\0, description\0
            body = data[1:]
            delim = []
            pos = 0
            for i in range(4):
                d = body.find(b"\x00", pos)
                if d < 0:
                    break
                delim.append(d)
                pos = d + 1 + (8 if i == 0 else 1 if i == 1 else 0)
            if len(delim) == 4 and delim[0] + 9 <= len(body) \
                    and delim[1] + 2 <= len(body):
                until = body[delim[0] + 1:delim[0] + 9].decode(
                    "latin-1", "replace")
                out["commercial"] = dict(
                    price=body[:delim[0]].decode("latin-1", "replace"),
                    until=f"{until[0:4]}-{until[4:6]}-{until[6:8]}",
                    url=body[delim[0] + 9:delim[1]].decode(
                        "latin-1", "replace"),
                    received_as=body[delim[1] + 1],
                    seller=body[delim[1] + 2:delim[2]].decode(
                        "latin-1", "replace"),
                    desc=body[delim[2] + 1:delim[3]].decode(
                        "latin-1", "replace"))
        elif tag == b"XHDR" and frame_len >= 6:
            out["xhdr_mime"] = int.from_bytes(data[0:4], "little")
            out["xhdr_param"] = data[4]
            extlen = data[5]
            if 6 + extlen == frame_len:
                if out["xhdr_param"] == 0 and extlen == 2:
                    out["xhdr_lot"] = data[6] | (data[7] << 8)
                elif out["xhdr_param"] == 1 and extlen == 0:
                    out["xhdr_lot"] = -1

        off += 10 + frame_len
    return out
