"""Native host-transport ops: a lazy ``c++`` build and a ctypes binding.

The port's copy of ``nrsc5_tpu/native/__init__.py`` for the transport's
ops: CRC-8, FCS-16, HDLC unescape and split, the AAS frame filter, the
bit gather-pack and the PDU Reed-Solomon decode.  ``host_ops.cpp`` is the
reference's source as it is; its HDC audio-parse entry points
(``nrsc5_hdc_spectral``, ``nrsc5_hdc_ics``) are not bound here.

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
