"""Live audio playback backends for the CLI (the port's copy of the
reference package's ``audio/playback.py``).

The reference CLI plays decoded PCM through a dedicated libao thread
(reference: src/main.c:96-104 open_ao_live, 644-681 audio_main); the
Python reference CLI uses pyaudio (reference: support/cli.py:162-186).
This module provides the same capability with runtime backend discovery,
because accelerator hosts are usually headless: it tries, in order,

  1. ``pyaudio``            (PortAudio, the reference Python CLI's choice)
  2. ``sounddevice``        (PortAudio via cffi)
  3. ALSA via ctypes        (``libasound.so.2`` — no Python package needed)
  4. an ``aplay`` subprocess (raw S16_LE pipe)

Every backend implements the same two-method surface consumed by the
CLI's playback thread:

    write(samples)  # 1-D int16 ndarray, interleaved stereo; blocking
    close()

``open_player()`` returns None when no backend is usable (e.g. this CI
container), in which case the CLI logs a warning and drops live audio —
identical to the reference behaviour when libao has no driver.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import shutil
import subprocess

import numpy as np

log = logging.getLogger("nrsc5-tpu")


class _PyAudioPlayer:
    def __init__(self, rate: int, channels: int):
        import pyaudio  # noqa: F401

        self._pa = pyaudio.PyAudio()
        self._stream = self._pa.open(
            format=pyaudio.paInt16, channels=channels, rate=rate,
            output=True)

    def write(self, samples: np.ndarray):
        self._stream.write(np.ascontiguousarray(samples, np.int16).tobytes())

    def close(self):
        self._stream.stop_stream()
        self._stream.close()
        self._pa.terminate()


class _SoundDevicePlayer:
    def __init__(self, rate: int, channels: int):
        import sounddevice

        self._channels = channels
        self._stream = sounddevice.RawOutputStream(
            samplerate=rate, channels=channels, dtype="int16")
        self._stream.start()

    def write(self, samples: np.ndarray):
        self._stream.write(
            np.ascontiguousarray(samples, np.int16).tobytes())

    def close(self):
        self._stream.stop()
        self._stream.close()


class _AlsaPlayer:
    """Direct ALSA binding — the closest analog of the reference's libao
    path, with the same stream parameters (S16_LE interleaved)."""

    _SND_PCM_STREAM_PLAYBACK = 0
    _SND_PCM_FORMAT_S16_LE = 2
    _SND_PCM_ACCESS_RW_INTERLEAVED = 3

    def __init__(self, rate: int, channels: int,
                 device: str = "default", latency_us: int = 200_000):
        name = ctypes.util.find_library("asound")
        if not name:
            raise OSError("libasound not found")
        self._lib = ctypes.CDLL(name)
        self._lib.snd_pcm_writei.restype = ctypes.c_long
        self._channels = channels
        self._pcm = ctypes.c_void_p()
        rc = self._lib.snd_pcm_open(
            ctypes.byref(self._pcm), device.encode(),
            self._SND_PCM_STREAM_PLAYBACK, 0)
        if rc < 0:
            raise OSError(f"snd_pcm_open: {rc}")
        rc = self._lib.snd_pcm_set_params(
            self._pcm, self._SND_PCM_FORMAT_S16_LE,
            self._SND_PCM_ACCESS_RW_INTERLEAVED, channels, rate,
            1, latency_us)
        if rc < 0:
            self._lib.snd_pcm_close(self._pcm)
            raise OSError(f"snd_pcm_set_params: {rc}")

    def write(self, samples: np.ndarray):
        buf = np.ascontiguousarray(samples, np.int16)
        frames = buf.size // self._channels
        done = 0
        recovered = False
        while done < frames:
            ptr = ctypes.c_void_p(
                buf.ctypes.data + done * self._channels * 2)
            n = self._lib.snd_pcm_writei(self._pcm, ptr, frames - done)
            if n <= 0:  # underrun (-EPIPE) → recover and retry once
                if recovered:
                    return  # second failure: drop the rest of the buffer
                recovered = True
                self._lib.snd_pcm_prepare(self._pcm)
                continue
            done += n  # short writes resume at the unwritten frame

    def close(self):
        self._lib.snd_pcm_drain(self._pcm)
        self._lib.snd_pcm_close(self._pcm)


class _AplayPlayer:
    def __init__(self, rate: int, channels: int):
        exe = shutil.which("aplay")
        if not exe:
            raise OSError("aplay not found")
        self._proc = subprocess.Popen(
            [exe, "-q", "-t", "raw", "-f", "S16_LE",
             "-r", str(rate), "-c", str(channels)],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    def write(self, samples: np.ndarray):
        self._proc.stdin.write(
            np.ascontiguousarray(samples, np.int16).tobytes())

    def close(self):
        self._proc.stdin.close()
        self._proc.wait(timeout=10)


_BACKENDS = (
    ("pyaudio", _PyAudioPlayer),
    ("sounddevice", _SoundDevicePlayer),
    ("alsa", _AlsaPlayer),
    ("aplay", _AplayPlayer),
)


def open_player(rate: int = 44100, channels: int = 2):
    """Open the first usable live-audio backend, or return None."""
    for name, cls in _BACKENDS:
        try:
            player = cls(rate, channels)
        except Exception as e:  # noqa: BLE001 — probe failure = skip
            log.debug("audio backend %s unavailable: %s", name, e)
            continue
        log.info("live audio via %s", name)
        return player
    return None
