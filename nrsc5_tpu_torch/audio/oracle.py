"""External AAC decode oracle: a ctypes binding to a libavcodec shim.

The port's copy of ``nrsc5_tpu/audio/oracle.py``.  It decodes the standard
AAC-LC / HE-AAC ADTS stream of
``tx/hdc_encoder.HDCEncoder.encode_frame_dual()`` with ffmpeg's
independent decoder, a PCM oracle for the HDC codec that is not this
repository's own code (reference analog: patched FAAD2,
src/output.c:126-163).  ``native/aac_oracle.cpp`` is the reference's
source as it is.

The library is built at first use with the host ``c++`` into
``build/native/`` at the repo root (gitignored), under a file name that
carries a hash of the source, as :mod:`nrsc5_tpu_torch.native` builds its
own.  ``available()`` is False where libavcodec or a compiler is missing,
and the tests that need it skip.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "aac_oracle.cpp"
BUILD = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib = False  # False = not probed
_build_error: str | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD / f"libaac_oracle-{digest}.so"


def _build() -> Path | None:
    global _build_error
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    for cc in ("c++", "g++"):
        try:
            r = subprocess.run([cc, "-O2", "-shared", "-fPIC", str(SOURCE),
                                "-lavcodec", "-lavutil", "-o", str(tmp)],
                               capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return out
        _build_error = r.stderr.decode(errors="replace")[-500:]
    return None


def _get():
    global _lib
    if _lib is not False:
        return _lib
    with _lock:
        if _lib is not False:
            return _lib
        path = _build()
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
        if lib is not None:
            lib.aac_oracle_decode.restype = ctypes.c_longlong
            lib.aac_oracle_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return lib


def available() -> bool:
    return _get() is not None


def decode_adts(stream: bytes) -> tuple[np.ndarray, int]:
    """Decode a whole ADTS stream -> (pcm [n, nch] float32, sample_rate),
    the PCM in libavcodec's float scale [-1, 1]."""
    lib = _get()
    if lib is None:
        raise RuntimeError(f"aac oracle unavailable: {_build_error}")
    # HE-AAC doubles the core rate (2048 a frame); an ADTS frame is at
    # least 9 bytes, so a stream holds at most len/9 frames
    max_frames = len(stream) // 9 + 16
    cap = max_frames * 2048 * 2 + 4096
    out = np.empty(cap, np.float32)
    nch = ctypes.c_int(0)
    rate = ctypes.c_int(0)
    n = lib.aac_oracle_decode(
        stream, len(stream),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        ctypes.byref(nch), ctypes.byref(rate))
    if n < 0:
        raise RuntimeError(f"aac oracle decode failed: {n}")
    if nch.value == 0:
        return np.zeros((0, 1), np.float32), 0
    return out[:n * nch.value].reshape(-1, nch.value).copy(), rate.value
