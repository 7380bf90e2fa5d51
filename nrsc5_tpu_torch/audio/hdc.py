"""HDC (HDC-AAC) → PCM decode backend selection: the port's copy of the
reference package's ``audio/hdc.py``.

HDC is a nonstandard AAC variant: an AAC-LC core with a modified SBR
(32 subsamples), fed as raw packets without ADTS framing.  The reference
uses a patched FAAD2 (`NeAACDecInitHDC`; reference:
support/faad2-hdc-support.patch, src/output.c:126-163).

Backends, in order:

  * the built-in clean-room decoder (the port's copy,
    nrsc5_tpu_torch/audio/hdc_decoder.py) — always available, the default;
  * ``libfaad_hdc.so`` (a FAAD2 build with the HDC patch), selected by
    setting NRSC5_TPU_FAAD_HDC to its path — bound with ctypes, for
    cross-checking against the reference codec where one exists.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np


class _NeAACDecFrameInfo(ctypes.Structure):
    """Full NeAACDecFrameInfo layout (faad2 include/neaacdec.h struct
    NeAACDecFrameInfo) — the library memsets/writes the whole struct, so
    the binding must declare every field."""
    _fields_ = [("bytesconsumed", ctypes.c_ulong),
                ("samples", ctypes.c_ulong),
                ("channels", ctypes.c_ubyte),
                ("error", ctypes.c_ubyte),
                ("samplerate", ctypes.c_ulong),
                ("sbr", ctypes.c_ubyte),
                ("object_type", ctypes.c_ubyte),
                ("header_type", ctypes.c_ubyte),
                ("num_front_channels", ctypes.c_ubyte),
                ("num_side_channels", ctypes.c_ubyte),
                ("num_back_channels", ctypes.c_ubyte),
                ("num_lfe_channels", ctypes.c_ubyte),
                ("channel_position", ctypes.c_ubyte * 64),
                ("ps", ctypes.c_ubyte)]


class _FaadHDC:
    """ctypes binding of the patched FAAD2 HDC entry points
    (reference: support/faad2-hdc-support.patch:186-214 —
    ``NeAACDecInitHDC(NeAACDecHandle*)`` takes only the handle)."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        lib.NeAACDecOpen.restype = ctypes.c_void_p
        lib.NeAACDecInitHDC.restype = ctypes.c_char
        lib.NeAACDecInitHDC.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.NeAACDecDecode.restype = ctypes.c_void_p
        lib.NeAACDecDecode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_NeAACDecFrameInfo),
            ctypes.c_char_p, ctypes.c_ulong]
        self.lib = lib
        # InitHDC closes+reopens the handle internally; seed it with one.
        self.handle = ctypes.c_void_p(lib.NeAACDecOpen())
        lib.NeAACDecInitHDC(ctypes.byref(self.handle))

    def decode(self, packet: bytes) -> np.ndarray | None:
        info = _NeAACDecFrameInfo()
        ptr = self.lib.NeAACDecDecode(self.handle, ctypes.byref(info),
                                      packet, len(packet))
        if not ptr or info.error or info.samples == 0:
            return None
        buf = ctypes.cast(ptr, ctypes.POINTER(
            ctypes.c_int16 * info.samples))
        return np.ctypeslib.as_array(buf.contents).copy()


_lib_path_cache: str | None | bool = False  # False = not probed yet


def _find_library() -> str | None:
    global _lib_path_cache
    if _lib_path_cache is not False:
        return _lib_path_cache
    candidates = []
    env = os.environ.get("NRSC5_TPU_FAAD_HDC")
    if env:
        candidates.append(env)
    found = ctypes.util.find_library("faad_hdc")
    if found:
        candidates.append(found)
    for cand in candidates:
        if os.path.exists(cand) or "/" not in cand:
            _lib_path_cache = cand
            return cand
    _lib_path_cache = None
    return None


class HDCDecoder:
    """Per-program HDC decoder (factory signature used by Output).

    Dispatches to the faad backend when NRSC5_TPU_FAAD_HDC points at a
    patched libfaad, the built-in decoder otherwise."""

    @staticmethod
    def check():
        pass  # the built-in backend is always available

    def __init__(self):
        path = _find_library()
        if path is not None:
            self._dec = _FaadHDC(path)
        else:
            from nrsc5_tpu_torch.audio.hdc_decoder import HDCDecoder as _Builtin
            self._dec = _Builtin()

    def decode(self, packet: bytes):
        return self._dec.decode(packet)
