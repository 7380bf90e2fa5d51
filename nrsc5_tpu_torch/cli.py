"""nrsc5-tpu command line receiver on the port: the reference's
``nrsc5_tpu/cli.py``.

Feature parity with the reference CLI (reference: src/main.c:798-970 flag
set, support/cli.py): file / pipe / rtl_tcp input, program selection, WAV
or raw audio output, HDC / AAS-file dumps, event logging.  Two flags more:
``--device`` (default ``cuda``, which raises with no card; ``cpu`` runs the
kernels' plain versions) and ``--chain`` (the session's radio: ``auto``,
the default, is the device chain on a card and the per-block receivers on
the CPU, as the reference picks them by backend; ``device``; ``block``).

Usage examples:
    python -m nrsc5_tpu_torch.cli -r capture.cu8 0
    python -m nrsc5_tpu_torch.cli --am -r capture.cs16 --iq-input-format cs16 0
    python -m nrsc5_tpu_torch.cli -H 127.0.0.1:1234 88.5 0
    python -m nrsc5_tpu_torch.cli -r capture.cu8 0 0 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
import queue
import sys
import threading
import wave

import numpy as np

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.api.session import MODE_AM, MODE_FM, NRSC5

log = logging.getLogger("nrsc5-tpu")


def _version() -> str:
    try:
        from importlib.metadata import version
        return version("nrsc5-tpu")
    except Exception:
        from nrsc5_tpu_torch import __version__
        return __version__


def build_adts(packet: bytes) -> bytes:
    """ADTS header for an HDC packet dump (reference: src/main.c:182-205)."""
    length = len(packet) + 7
    hdr = bytearray(7)
    hdr[0] = 0xFF
    hdr[1] = 0xF0 | 0x08 | 0x01  # MPEG-2, no CRC
    hdr[2] = (1 << 6) | (7 << 2)  # profile 2(-1), 22050 Hz
    hdr[3] = (2 << 6) | ((length >> 11) & 0x3)  # stereo
    hdr[4] = (length >> 3) & 0xFF
    hdr[5] = ((length & 0x7) << 5) | 0x1F
    hdr[6] = 0xFC
    return bytes(hdr) + packet


class CLI:
    def __init__(self, args):
        self.args = args
        # 16-slot queue with blocking push = the reference CLI's audio ring
        # backpressure in file mode (reference: src/main.c:44-47,132-136)
        self.audio_queue: queue.Queue = queue.Queue(maxsize=16)
        self.wav = None
        self.hdc_file = None
        self.audio_stream = None
        self.player = None
        self._player_thread = None

    # ------------------------------------------------------------------
    def run(self):
        a = self.args
        mode = MODE_AM if a.am else MODE_FM
        is_wav = (a.audio_type == "wav" if a.audio_type
                  else bool(a.output) and a.output.endswith(".wav"))
        if a.output and is_wav:
            self.wav = wave.open(sys.stdout.buffer if a.output == "-"
                                 else a.output, "wb")
            self.wav.setnchannels(2)
            self.wav.setsampwidth(2)
            self.wav.setframerate(C.SAMPLE_RATE_AUDIO)
            if a.output == "-":
                # unseekable stream: pre-declare a frame count so the
                # header never needs patching (reference: support/cli.py:112)
                self.wav.setnframes((1 << 30) - 64)
        elif a.output:
            # raw interleaved int16 stereo (reference: src/main.c open_ao_file)
            self.audio_stream = (sys.stdout.buffer if a.output == "-"
                                 else open(a.output, "wb"))
        elif not a.no_audio:
            # no -o: play live, like the reference CLI's libao thread
            # (reference: src/main.c:96-104,644-681)
            from nrsc5_tpu_torch.audio import playback
            self.player = playback.open_player(C.SAMPLE_RATE_AUDIO, 2)
            if self.player is None:
                log.warning("no audio playback backend "
                            "(pyaudio/sounddevice/ALSA/aplay); live audio "
                            "disabled")
            else:
                self._player_thread = threading.Thread(
                    target=self._playback_main, daemon=True)
                self._player_thread.start()
        if a.dump_hdc:
            self.hdc_file = open(a.dump_hdc, "wb")

        hdc_factory = None
        if self.wav is not None or self.audio_stream is not None \
                or self.player is not None:
            hdc_factory = _try_hdc_factory()
            if hdc_factory is None:
                log.warning("no HDC decoder available; audio output disabled"
                            " (HDC dumps still work)")

        if not a.quiet and sys.stdin.isatty() and (a.rtltcp or a.iq_input):
            self._start_keyboard_thread()

        if a.rtltcp:
            host, _, port = a.rtltcp.partition(":")
            radio = NRSC5.open_rtltcp(host, int(port or 1234), self.on_event,
                                      mode, hdc_decoder_factory=hdc_factory,
                                      device=a.device, chain=a.chain)
            if a.iq_output:
                radio.set_iq_dump(open(a.iq_output, "wb"))
            if a.ppm:
                radio.set_freq_correction(a.ppm)
            if a.bias_tee:
                radio.set_bias_tee(True)
            if a.direct_sampling:
                radio.set_direct_sampling(a.direct_sampling)
            radio.set_frequency(a.frequency * 1e6
                                if a.frequency < 10000 else a.frequency)
            if a.gain is not None:
                radio.set_gain(a.gain)
            radio.start()
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                pass
            finally:
                radio.close()
        else:
            fobj = sys.stdin.buffer if a.iq_input in (None, "-") \
                else open(a.iq_input, "rb")
            radio = NRSC5.open_pipe(self.on_event, mode,
                                    hdc_decoder_factory=hdc_factory,
                                    device=a.device, chain=a.chain)
            # -w tees the raw input in any mode (reference: src/main.c:336)
            iq_dump = open(a.iq_output, "wb") if a.iq_output else None
            fmt = a.iq_input_format
            chunk = 32768
            try:
                while True:
                    data = fobj.read(chunk)
                    if not data:
                        # the receiver holds dispatches in flight: drain
                        # them at the end of the input
                        radio.flush()
                        break
                    if iq_dump is not None:
                        iq_dump.write(data)
                    if fmt == "cu8":
                        radio.pipe_samples_cu8(np.frombuffer(data, np.uint8))
                    else:
                        radio.pipe_samples_cs16(data)
            finally:
                if iq_dump is not None:
                    iq_dump.close()
        if self.wav is not None:
            try:
                self.wav.close()
            except OSError:
                pass  # unseekable stdout: header was pre-declared
        if self.audio_stream is not None and self.audio_stream is not \
                sys.stdout.buffer:
            self.audio_stream.close()
        if self.hdc_file:
            self.hdc_file.close()
        if self.player is not None:
            self.audio_queue.put(None)  # sentinel: drain and stop
            self._player_thread.join(timeout=30)
            self.player.close()

    def _playback_main(self):
        """Playback thread: pop PCM buffers and write them to the audio
        backend (reference: src/main.c:644-681 audio_main).  If the
        backend dies mid-play, keep draining the bounded queue (a
        producer may be blocked in put()) and discard frames."""
        dead = False
        while True:
            samples = self.audio_queue.get()
            if samples is None:
                return
            if dead:
                continue
            try:
                self.player.write(samples)
            except Exception as e:  # noqa: BLE001 — device died mid-play
                log.error("audio playback failed: %s", e)
                dead = True

    def _start_keyboard_thread(self):
        """Program switching from the terminal: keys 0-7 select the audio
        program, q quits (reference: src/main.c:705-791)."""
        def reader():
            for line in sys.stdin:
                key = line.strip()[:1]
                if key == "q":
                    os._exit(0)
                if key.isdigit() and 0 <= int(key) <= 7:
                    self.args.program = int(key)
                    log.info("Switched to program %d", self.args.program)
        threading.Thread(target=reader, daemon=True).start()

    # ------------------------------------------------------------------
    def on_event(self, ev):
        a = self.args
        t = ev.type
        if t == EventType.SYNC:
            log.info("Synchronized (psmi %s)", ev.payload.get("psmi"))
        elif t == EventType.LOST_SYNC:
            log.info("Lost synchronization")
        elif t == EventType.ID3 and ev.program == a.program:
            if ev.title:
                log.info("Title: %s", ev.title)
            if ev.artist:
                log.info("Artist: %s", ev.artist)
            if ev.album:
                log.info("Album: %s", ev.album)
        elif t == EventType.HDC and ev.program == a.program:
            if self.hdc_file is not None:
                self.hdc_file.write(build_adts(ev.data))
        elif t == EventType.AUDIO and ev.program == a.program:
            if self.wav is not None:
                self.wav.writeframes(np.asarray(ev.samples, np.int16)
                                     .tobytes())
            if self.audio_stream is not None:
                self.audio_stream.write(np.asarray(ev.samples, np.int16)
                                        .tobytes())
            if self.player is not None:
                # blocking put = file-mode backpressure (main.c:132-136)
                self.audio_queue.put(np.asarray(ev.samples, np.int16))
        elif t == EventType.STATION_NAME:
            log.info("Station name: %s", ev.name)
        elif t == EventType.STATION_SLOGAN:
            log.info("Slogan: %s", ev.slogan)
        elif t == EventType.STATION_MESSAGE:
            log.info("Message: %s", ev.message)
        elif t == EventType.STATION_LOCATION:
            log.info("Station location: %.4f, %.4f, %dm",
                     ev.latitude, ev.longitude, ev.altitude)
        elif t == EventType.AUDIO_SERVICE:
            from nrsc5_tpu_torch.api.names import program_type_name
            log.info("Audio program %d: %s, type %s, codec %d",
                     ev.program, "public" if not ev.access else "restricted",
                     program_type_name(ev.payload["type"]), ev.codec_mode)
        elif t == EventType.LOT:
            if a.dump_aas_files:
                path = os.path.join(a.dump_aas_files, ev.name)
                with open(path, "wb") as f:
                    f.write(ev.data)
            log.info("LOT file: port=%04X lot=%d name=%s size=%d",
                     ev.component.port, ev.lot, ev.name, len(ev.data))
        elif t == EventType.EMERGENCY_ALERT:
            if ev.message:
                log.warning("Emergency alert: %s", ev.message)
        elif t == EventType.BER:
            log.debug("BER: %.6f", ev.cber)
        elif t == EventType.LOST_DEVICE:
            log.error("Lost device")


def _try_hdc_factory():
    """HDC→PCM decoder factory (see nrsc5_tpu_torch/audio/hdc.py — the
    built-in codec is always available; NRSC5_TPU_FAAD_HDC selects a faad
    build)."""
    try:
        from nrsc5_tpu_torch.audio.hdc import HDCDecoder
        HDCDecoder.check()
        return HDCDecoder
    except Exception:
        return None


def main(argv=None):
    p = argparse.ArgumentParser(prog="nrsc5-tpu-torch", description=__doc__)
    p.add_argument("frequency", type=float, nargs="?", default=0.0,
                   help="center frequency (MHz or Hz; rtl_tcp mode)")
    p.add_argument("program", type=int, nargs="?", default=0)
    p.add_argument("-r", dest="iq_input", help="IQ input file ('-' = stdin)")
    p.add_argument("--iq-input-format", choices=("cu8", "cs16"),
                   default="cu8")
    p.add_argument("-w", dest="iq_output", help="IQ output file (rtl_tcp)")
    p.add_argument("-o", dest="output", help="audio output (.wav or raw)")
    p.add_argument("-t", dest="audio_type", choices=("wav", "raw"),
                   help="audio output type (default: from -o extension; "
                        "reference: src/main.c:858-865)")
    p.add_argument("-v", "--version", action="version",
                   version=f"nrsc5-tpu-torch {_version()}")
    p.add_argument("-H", dest="rtltcp", help="rtl_tcp host[:port]")
    p.add_argument("-g", dest="gain", type=float, help="tuner gain dB")
    p.add_argument("-p", dest="ppm", type=int, default=0, help="ppm error")
    p.add_argument("-q", dest="quiet", action="store_true")
    p.add_argument("-l", dest="log_level", type=int, default=2)
    p.add_argument("--am", action="store_true", help="AM mode")
    p.add_argument("-T", dest="bias_tee", action="store_true",
                   help="enable bias-T power")
    p.add_argument("-D", dest="direct_sampling", type=int, default=0,
                   help="direct sampling mode")
    p.add_argument("--no-audio", action="store_true",
                   help="disable live playback (no -o given)")
    p.add_argument("--dump-hdc", help="dump HDC packets (ADTS)")
    p.add_argument("--dump-aas-files", help="directory for AAS LOT files")
    p.add_argument("--device", default="cuda",
                   help="where the receive chain runs: cuda (default; "
                        "raises with no card) or cpu")
    p.add_argument("--chain", choices=("auto", "device", "block"),
                   default="auto",
                   help="the session's radio: auto (default: the device "
                        "chain on a card, the per-block receivers on the "
                        "cpu), device or block")
    args = p.parse_args(argv)
    K.resolve_device(args.device)  # no card: raise before any output opens

    level = logging.WARNING if args.quiet else (
        logging.DEBUG if args.log_level <= 1 else logging.INFO)
    logging.basicConfig(level=level,
                        format="%(asctime)s %(levelname)s %(message)s")
    CLI(args).run()


if __name__ == "__main__":
    main()
