"""Native host-transport ops: a lazy ``c++`` build and a ctypes binding.

The port's copy of ``nrsc5_tpu/native/__init__.py``: the transport's ops
(CRC-8, FCS-16, HDLC unescape and split, the AAS frame filter, the bit
gather-pack and the PDU Reed-Solomon decode) and the HDC audio parse
(``nrsc5_hdc_spectral``, ``nrsc5_hdc_ics``: one codebook section, or one
channel's whole individual stream, in one call, with the codebook tables
registered once; the host half of every batched audio decode).
``host_ops.cpp`` is the reference's source as it is.

``get_lib()`` returns the loaded library, or None where no host compiler
builds it: each op then returns None or takes the pure-Python path, as in
the reference.  The library is built once into ``build/native/`` at the
repo root (gitignored), under a file name that carries a hash of the
source, so a changed source builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib = False  # False = not probed


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD / f"libnrsc5host-{digest}.so"


def build() -> Path | None:
    """Compile host_ops.cpp; returns the library's path, or None where no
    host compiler builds it."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    for cc in ("c++", "g++", "cc"):
        try:
            subprocess.run([cc, "-O2", "-shared", "-fPIC", str(SOURCE),
                            "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, out)
        return out
    return None


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib
    if _lib is not False:  # write-once: lock-free fast path for hot calls
        return _lib
    with _lock:
        if _lib is not False:
            return _lib
        path = build()
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
                _bind(lib)
            except (OSError, AttributeError):
                lib = None
        _lib = lib
        return lib


def _bind(lib):
    lib.nrsc5_crc8.restype = ctypes.c_uint8
    lib.nrsc5_crc8.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.nrsc5_fcs16.restype = ctypes.c_uint16
    lib.nrsc5_fcs16.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.nrsc5_hdlc_unescape.restype = ctypes.c_size_t
    lib.nrsc5_hdlc_unescape.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.nrsc5_aas_frame.restype = ctypes.c_size_t
    lib.nrsc5_aas_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.nrsc5_hdlc_split.restype = ctypes.c_int
    lib.nrsc5_hdlc_split.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.nrsc5_gather_pack.restype = None
    lib.nrsc5_gather_pack.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.nrsc5_rs_decode_pdu.restype = None
    lib.nrsc5_rs_decode_pdu.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)]
    lib.nrsc5_hdc_spectral.restype = ctypes.c_long
    lib.nrsc5_hdc_spectral.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_void_p]
    lib.nrsc5_hdc_register_book.restype = None
    lib.nrsc5_hdc_register_book.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.nrsc5_hdc_ics.restype = ctypes.c_long
    lib.nrsc5_hdc_ics.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def crc8(data: bytes) -> int:
    lib = get_lib()
    if lib is None:
        from nrsc5_tpu_torch.utils import crc as pycrc
        return pycrc.crc8(data)
    return lib.nrsc5_crc8(bytes(data), len(data))


def gather_pack(bits, idx):
    """np.packbits(bits[idx]) through the native op; returns None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    n = idx.shape[0]
    out = np.empty((n + 7) // 8, np.uint8)
    lib.nrsc5_gather_pack(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def rs_decode_pdu(buf96):
    """Native shortened-RS(255,247) decode of [..., 96] uint8 codewords;
    returns (corrected, ok, n_corrected) like ops.rs.rs_decode_pdu, or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    arr = np.ascontiguousarray(np.asarray(buf96, dtype=np.uint8))
    shape = arr.shape
    flat = arr.reshape(-1, 96).copy()
    n = flat.shape[0]
    ok = np.zeros(n, np.uint8)
    ncorr = np.zeros(n, np.int32)
    lib.nrsc5_rs_decode_pdu(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ncorr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return (flat.reshape(shape), ok.astype(bool).reshape(shape[:-1]),
            ncorr.astype(np.int64).reshape(shape[:-1]))


def _prefix_lut(codes, bits):
    """A prefix code's decode table: for every ``width``-bit window, the
    symbol whose codeword starts it (-1: none) and that codeword's length;
    returns (sym int16, length uint8, width)."""
    import numpy as np

    codes = np.asarray(codes, np.uint32)
    bits = np.asarray(bits, np.uint8)
    width = int(bits.max())
    sym = np.full(1 << width, -1, np.int16)
    ln = np.zeros(1 << width, np.uint8)
    for s, (c, b) in enumerate(zip(codes.tolist(), bits.tolist())):
        if b == 0:
            continue
        base = c << (width - b)
        sym[base: base + (1 << (width - b))] = s
        ln[base: base + (1 << (width - b))] = b
    return np.ascontiguousarray(sym), np.ascontiguousarray(ln), width


_hdc_luts = None


def _build_hdc_luts():
    import numpy as np

    from nrsc5_tpu_torch.audio import aac_core as A
    from nrsc5_tpu_torch.audio import aac_tables as T

    luts = {}
    for cb in range(1, 12):
        sym, ln, width = _prefix_lut(getattr(T, f"CODES{cb}"),
                                     getattr(T, f"BITS{cb}"))
        dim, _lav, signed_ = A.CB_META[cb]
        tuples = np.ascontiguousarray(np.asarray(
            [A.unpack_index(cb, i)
             for i in range(len(getattr(T, f"CODES{cb}")))], np.int16))
        # keep the arrays alive beside their raw pointers (data_as per call
        # would dominate a band's dispatch)
        luts[cb] = ((sym, ln, tuples), sym.ctypes.data, ln.ctypes.data,
                    width, tuples.ctypes.data, dim,
                    int(signed_), int(cb == A.ESC_HCB))
    return luts


_hdc_sf_lut = None
_hdc_books_lib = None


def _ensure_books(lib):
    """Register every spectral codebook and the scalefactor book with the
    native library once (slot 12, the reserved spectral id, holds the
    scalefactor book)."""
    global _hdc_luts, _hdc_sf_lut, _hdc_books_lib
    if _hdc_books_lib is lib:
        return
    with _lock:
        if _hdc_books_lib is lib:
            return
        if _hdc_luts is None:
            _hdc_luts = _build_hdc_luts()
        for cb, (_keep, sym_p, ln_p, width, tup_p, dim, signed_, esc) \
                in _hdc_luts.items():
            lib.nrsc5_hdc_register_book(cb, sym_p, ln_p, width, tup_p, dim,
                                        signed_, esc)
        if _hdc_sf_lut is None:
            from nrsc5_tpu_torch.audio import aac_tables as T
            _hdc_sf_lut = _prefix_lut(T.FF_AAC_SCALEFACTOR_CODE,
                                      T.FF_AAC_SCALEFACTOR_BITS)
        sym, ln, width = _hdc_sf_lut
        lib.nrsc5_hdc_register_book(12, sym.ctypes.data, ln.ctypes.data,
                                    width, None, 1, 0, 0)
        _hdc_books_lib = lib


def hdc_ics(data: bytes, pos: int, short: bool, max_sfb: int,
            group_len, swb_offset):
    """Parse one channel's whole individual stream natively: the global
    gain (8 bits), the section data, the scale factors and the spectral
    huffman, in one call.  Returns (sfb_cb [G, max_sfb] int32,
    scale_factors [G, max_sfb] int32, quant [1024] int32, the new bit
    position), or None when the native library is unavailable.  Raises
    ValueError exactly where the pure-Python parse raises."""
    lib = get_lib()
    if lib is None:
        return None
    _ensure_books(lib)
    import numpy as np

    num_groups = len(group_len)
    gl = np.ascontiguousarray(group_len, dtype=np.int32)
    offs = np.ascontiguousarray(np.asarray(swb_offset)[:max_sfb + 1],
                                dtype=np.int16)
    sfb_cb = np.zeros((num_groups, max_sfb), np.int32)
    sf = np.zeros((num_groups, max_sfb), np.int32)
    quant = np.zeros(1024, np.int32)
    new_pos = lib.nrsc5_hdc_ics(
        data, len(data), pos, int(bool(short)), max_sfb, num_groups,
        gl.ctypes.data, offs.ctypes.data,
        sfb_cb.ctypes.data, sf.ctypes.data, quant.ctypes.data)
    if new_pos < 0:
        raise ValueError("invalid ICS bitstream")
    return sfb_cb, sf, quant, int(new_pos)


def hdc_spectral(data: bytes, pos: int, cb: int, n: int):
    """Decode ``n`` spectral values of codebook ``cb`` from bit ``pos`` of
    ``data``; returns (int32 values, the new bit position), or None when
    the native library is unavailable.  Raises ValueError on a corrupt
    codeword or escape, as the pure-Python parse does."""
    lib = get_lib()
    if lib is None:
        return None
    global _hdc_luts
    if _hdc_luts is None:
        with _lock:
            if _hdc_luts is None:
                _hdc_luts = _build_hdc_luts()
    import numpy as np

    _keep, sym_p, ln_p, width, tup_p, dim, signed_, esc = _hdc_luts[cb]
    out = np.empty(n, np.int32)
    new_pos = lib.nrsc5_hdc_spectral(
        data, len(data), pos, sym_p, ln_p, width, tup_p, dim,
        signed_, esc, n, out.ctypes.data)
    if new_pos < 0:
        raise ValueError("invalid huffman codeword")
    return out, int(new_pos)


def aas_frame(data: bytes) -> bytes | None:
    """Unescape + FCS16 + protocol filter; returns the 0x21 payload
    (without protocol byte and FCS) or None."""
    lib = get_lib()
    if lib is None:
        from nrsc5_tpu_torch.transport.frame import unescape_hdlc
        from nrsc5_tpu_torch.utils.crc import VALIDFCS16, fcs16
        payload = unescape_hdlc(data)
        if len(payload) < 4 or fcs16(payload) != VALIDFCS16 \
                or payload[0] != 0x21:
            return None
        return payload[1:-2]
    out = ctypes.create_string_buffer(max(len(data), 1))
    n = lib.nrsc5_aas_frame(bytes(data), len(data), out)
    if n == 0:
        return None
    return out.raw[1:n]
