"""Public session API — the framework's equivalent of the reference C ABI,
on the port's device chain: the reference's ``nrsc5_tpu/api/session.py``.

Mirrors the reference surface (include/nrsc5.h:642-871, support/nrsc5.py
class NRSC5): session open for pipe / file / rtl_tcp input, start/stop
worker, sample push (cu8 and cs16), a single event callback, and mode
selection.

Composition (reference analog: nrsc5_init, src/nrsc5.c:209-230): the
radio (device compute) -> FrameDecoder / PIDSDecoder (host transport) ->
Output (elastic buffer, AAS/SIG/LOT/ID3) -> the user callback.  The radio
is chosen as the reference's ``device`` argument chooses it, here by
``chain``:

  * ``"block"``: the per-block receivers (:class:`~nrsc5_tpu_torch.
    pipeline.receiver.FMReceiver`, :class:`~nrsc5_tpu_torch.pipeline.
    turbo.TurboFMReceiver` with ``turbo=True``, :class:`~nrsc5_tpu_torch.
    pipeline.receiver_am.AMReceiver`), which feed the session's own
    transport and take its hard resync (a transport RS failure asks the
    radio to re-acquire);
  * ``"device"``: :class:`~nrsc5_tpu_torch.pipeline.device_receiver.
    DeviceReceiver`, a cold start, then a one-station
    ``serve.MultiStationReceiver`` whose own station transport emits the
    events (the session's transport objects stay idle; its resync forces
    the receiver's relock watchdog);
  * ``"auto"`` (the default): the per-block receivers on ``device="cpu"``
    and ``DeviceReceiver`` on a card, as the reference's ``device="auto"``
    picks its host receivers on a CPU backend and the serving chain on an
    accelerator.

``device`` is where the radio runs (``"cuda"`` by default, which raises
with no card).
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.api.events import Event, EventType, make
from nrsc5_tpu_torch.pipeline.device_receiver import DeviceReceiver
from nrsc5_tpu_torch.pipeline.receiver import FMReceiver
from nrsc5_tpu_torch.pipeline.receiver_am import AMReceiver
from nrsc5_tpu_torch.pipeline.turbo import TurboFMReceiver
from nrsc5_tpu_torch.transport import frame as TF
from nrsc5_tpu_torch.transport.output import Output
from nrsc5_tpu_torch.transport.pids import PIDSDecoder

MODE_FM = 0
MODE_AM = 1

SAMPLE_RATE_CU8 = C.SAMPLE_RATE_CU8
SAMPLE_RATE_CS16_FM = C.SAMPLE_RATE_CS16_FM
SAMPLE_RATE_CS16_AM = C.SAMPLE_RATE_CS16_AM
SAMPLE_RATE_AUDIO = C.SAMPLE_RATE_AUDIO
CHAINS = ("auto", "device", "block")


class NRSC5:
    """One receive session.

    callback: receives :class:`nrsc5_tpu_torch.api.events.Event`.
    hdc_decoder_factory: () -> decoder with .decode(bytes) -> pcm.  The
      default "auto" selects nrsc5_tpu_torch.audio.hdc.HDCDecoder (built-in
      codec, or a patched libfaad via NRSC5_TPU_FAAD_HDC); pass None to
      disable audio decode (HDC packet events still flow).
    turbo: on the per-block path, FM through the turbo receiver (a fused
      frame a call once locked); the device chain is always fused.
    device: where the radio runs, ``"cuda"`` by default (raises with no
      card); ``"cpu"`` runs the kernels' plain versions.
    chain: ``"auto"``, ``"device"`` or ``"block"``, the radio (see the
      module's docstring).
    """

    def __init__(self, callback: Callable[[Event], None],
                 mode: int = MODE_FM, hdc_decoder_factory="auto",
                 turbo: bool = False, device="cuda", chain: str = "auto"):
        if chain not in CHAINS:
            raise ValueError(f"chain: expected one of {CHAINS}, got "
                             f"{chain!r}")
        self.callback = callback
        self.mode = mode
        self.turbo = turbo
        self.device = K.resolve_device(device)
        self.chain = chain
        if hdc_decoder_factory == "auto":
            from nrsc5_tpu_torch.audio.hdc import HDCDecoder
            hdc_decoder_factory = HDCDecoder
        self._hdc_factory = hdc_decoder_factory
        self._source = None
        self._worker = None
        self._stop = threading.Event()
        # RLock: decode events are emitted while the lock is held, and a
        # user callback may legally call back into set_mode/set_callback
        # (the reference allows nrsc5_set_callback at any time)
        self._lock = threading.RLock()
        self._iq_dump = None
        self._cs16_leftover = b""
        self._wire()

    # ------------------------------------------------------------------
    def _emit(self, event: Event):
        self.callback(event)

    def _wire(self):
        self.output = Output(self._emit, mode_fm=self.mode == MODE_FM,
                             hdc_decoder_factory=self._hdc_factory)
        self.pids = PIDSDecoder(self._emit)
        self.frame = TF.FrameDecoder(
            self.output,
            on_audio_service=lambda info: self._emit(
                make(EventType.AUDIO_SERVICE, **info)),
            on_resync=self._resync)
        block = self.chain == "block" or (self.chain == "auto"
                                          and self.device.type == "cpu")
        if not block:
            self.radio = DeviceReceiver(self._emit,
                                        mode_fm=self.mode == MODE_FM,
                                        hdc_factory=self._hdc_factory,
                                        device=self.device)
        elif self.mode == MODE_FM:
            rx = TurboFMReceiver if self.turbo else FMReceiver
            self.radio = rx(self._on_frame, self._on_l1_event,
                            device=self.device)
        else:
            self.radio = AMReceiver(self._on_frame, self._on_l1_event,
                                    device=self.device)

    def _resync(self):
        """The transport's hard resync request (reference:
        src/frame.c:535-540): the radio re-acquires."""
        self.radio.resync()

    def _on_l1_event(self, kind: str, info: dict):
        if kind == "sync":
            self._emit(make(EventType.SYNC, psmi=info.get("psmi")))
        elif kind == "lost_sync":
            self._emit(make(EventType.LOST_SYNC))
        elif kind == "block":
            self.output.advance()
        elif kind == "mer":
            self._emit(make(EventType.MER, **info))
        elif kind == "ber":
            self._emit(make(EventType.BER, **info))

    def _on_frame(self, chan: int, bits: np.ndarray, margin: float):
        """A decoded frame into the transport: -1 PIDS, 0 P1, 1 and 3 P3,
        2 P4.  Returns the transport's accept status."""
        if chan == -1:
            self.pids.frame_push(bits)
            return True
        if chan == 0:
            return self.frame.push_frame(bits, TF.P1)
        if chan in (1, 3):
            return self.frame.push_frame(bits, TF.P3)
        if chan == 2:
            return self.frame.push_frame(bits, TF.P4)
        return True

    # ------------------------------------------------------------------
    # session opening (reference: nrsc5_open_file/open_pipe/open_rtltcp)
    # ------------------------------------------------------------------
    @classmethod
    def open_pipe(cls, callback, mode: int = MODE_FM, **kw) -> "NRSC5":
        return cls(callback, mode, **kw)

    @classmethod
    def open_file(cls, path_or_obj, callback, mode: int = MODE_FM,
                  input_format: str = "cu8", **kw) -> "NRSC5":
        self = cls(callback, mode, **kw)
        fobj = open(path_or_obj, "rb") if isinstance(path_or_obj, str) \
            else path_or_obj
        self._source = _FileSource(fobj, input_format)
        return self

    @classmethod
    def open_rtltcp(cls, host: str, port: int, callback,
                    mode: int = MODE_FM, **kw) -> "NRSC5":
        from nrsc5_tpu_torch.io.rtltcp import RtlTcpClient
        self = cls(callback, mode, **kw)
        self._source = RtlTcpClient(host, port)
        self._source.set_sample_rate(int(C.SAMPLE_RATE_CU8))
        self._want_auto_gain = True  # cleared by an explicit set_gain
        return self

    # ------------------------------------------------------------------
    # tuner control (rtl_tcp only; reference: nrsc5.c:475-583)
    # ------------------------------------------------------------------
    def set_frequency(self, freq_hz: float):
        if self._source is None or not hasattr(self._source, "set_frequency"):
            raise RuntimeError("no tunable source")
        self._source.set_frequency(int(freq_hz))
        self.radio.reset()
        self.output.reset()

    def get_frequency(self) -> float:
        """Tuned frequency in Hz, or NaN without a tunable source
        (reference: nrsc5_get_frequency, src/nrsc5.c:521-532)."""
        f = getattr(self._source, "frequency", None)
        return float("nan") if f is None else float(f)

    def set_gain(self, gain_db: float):
        self._want_auto_gain = False
        if hasattr(self._source, "set_gain"):
            self._source.set_gain(gain_db)

    def get_gain(self) -> float:
        """Last tuner gain in dB, or NaN (reference: nrsc5_get_gain,
        src/nrsc5.c:550-563)."""
        g = getattr(self._source, "gain", None)
        return float("nan") if g is None else float(g)

    def set_auto_gain(self, enabled: bool):
        self._want_auto_gain = enabled

    def set_freq_correction(self, ppm: int):
        if hasattr(self._source, "set_freq_correction"):
            self._source.set_freq_correction(ppm)

    def set_bias_tee(self, on: bool):
        if hasattr(self._source, "set_bias_tee"):
            self._source.set_bias_tee(on)

    def set_direct_sampling(self, mode: int):
        if hasattr(self._source, "set_direct_sampling"):
            self._source.set_direct_sampling(mode)

    def set_mode(self, mode: int):
        """Switch FM/AM after open (reference: nrsc5_set_mode,
        src/nrsc5.c:464-473 — resets the whole receive chain)."""
        if mode == self.mode:
            return
        with self._lock:
            self.mode = mode
            self._cs16_leftover = b""
            self._wire()

    def set_callback(self, callback: Callable[[Event], None]):
        """Replace the event callback (reference: nrsc5_set_callback,
        src/nrsc5.c:585-593 — takes the worker lock)."""
        with self._lock:
            self.callback = callback

    @staticmethod
    def get_version() -> str:
        """Library version string (reference: nrsc5_get_version)."""
        from nrsc5_tpu_torch import __version__

        return __version__

    # ------------------------------------------------------------------
    # worker (reference: nrsc5_start/stop, src/nrsc5.c:434-462)
    # ------------------------------------------------------------------
    def start(self):
        """Start the worker thread that reads the source and decodes (file
        and rtl_tcp sessions; a pipe session's caller pushes samples).  It
        launches every kernel of the session, so no other thread may use
        the card while it runs: a CUDA graph is captured in its thread."""
        if self._source is None:
            return  # pipe mode: caller pushes samples
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def flush(self):
        """Drain pending frames/packets at the end of a finite capture."""
        with self._lock:
            if hasattr(self.radio, "flush"):
                self.radio.flush()
            for _ in range(4):
                self.output.advance()

    def close(self):
        self.stop()
        if self._source is not None and hasattr(self._source, "close"):
            self._source.close()

    def _auto_gain(self):
        """Binary-search the tuner gain for peak < -6 dBFS (reference:
        src/nrsc5.c:24-113)."""
        src = self._source
        gains = getattr(src, "gains", None)
        if not gains or not hasattr(src, "set_gain"):
            return
        lo, hi = 0, len(gains) - 1
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            src.set_gain_mode(True)
            src._cmd(4, gains[mid])  # CMD_SET_GAIN, tenths of dB
            src.read(65536)  # flush settling samples
            buf = np.frombuffer(src.read(65536), np.uint8)
            peak = np.abs(buf.astype(np.int32) - 127).max() / 128.0
            peak_db = 20 * np.log10(max(peak, 1e-6))
            self._emit(make(EventType.AGC, gain_db=gains[mid] / 10.0,
                            peak_dbfs=peak_db))
            if peak_db < -6.0:
                best = mid
                lo = mid + 1
            else:
                hi = mid - 1
        if best is not None:
            src._cmd(4, gains[best])
            # record the chosen gain so get_gain reports it (reference:
            # do_auto_gain stores the result, src/nrsc5.c:106)
            src.gain = gains[best] / 10.0

    def _run(self):
        if getattr(self, "_want_auto_gain", False):
            self._auto_gain()
        while not self._stop.is_set():
            data = self._source.read(32768)
            if data is None or len(data) == 0:
                self._emit(make(EventType.LOST_DEVICE))
                return
            if self._iq_dump is not None:
                self._iq_dump.write(data)
            if getattr(self._source, "format", "cu8") == "cu8":
                self.pipe_samples_cu8(np.frombuffer(data, np.uint8))
            else:
                self.pipe_samples_cs16(data)

    def set_iq_dump(self, fobj):
        """Tee raw device reads into a file object (CLI -w flag;
        reference: src/main.c IQ output)."""
        self._iq_dump = fobj

    # ------------------------------------------------------------------
    # sample push (reference: nrsc5_pipe_samples_cu8/cs16)
    # ------------------------------------------------------------------
    def pipe_samples_cu8(self, data: np.ndarray):
        """Interleaved uint8 I/Q at 1,488,375 S/s (FM and AM)."""
        data = np.asarray(data, np.uint8)
        self._emit(make(EventType.IQ, data=data))
        with self._lock:
            self.radio.push_cu8(data)

    def pipe_samples_cs16(self, data):
        """Complex baseband at the internal rate (744,187.5 FM /
        46,511.7 AM), as complex64, interleaved int16, or raw bytes.

        Raw bytes (as handed over by the worker thread's source reads) may
        end mid-I/Q-pair; the trailing partial 4-byte pair is carried to the
        next call (reference: src/nrsc5.c:627-650 leftover handling).
        """
        with self._lock:
            # leftover carry under the lock: set_mode clears it and must
            # not race a concurrent push
            if isinstance(data, (bytes, bytearray, memoryview)):
                buf = self._cs16_leftover + bytes(data)
                n = len(buf) - (len(buf) % 4)
                self._cs16_leftover = buf[n:]
                arr = np.frombuffer(buf[:n], np.int16)
            else:
                arr = np.asarray(data)
            if arr.dtype == np.int16:
                arr = (arr[0::2].astype(np.float32)
                       + 1j * arr[1::2].astype(np.float32)) / 32768.0
            self.radio.push_cs16(arr.astype(np.complex64))


class _FileSource:
    format = "cu8"

    def __init__(self, fobj, input_format: str):
        self.fobj = fobj
        self.format = input_format

    def read(self, n: int):
        return self.fobj.read(n)

    def close(self):
        self.fobj.close()
