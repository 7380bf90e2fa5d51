"""The port's CLI end to end on the CPU (``--device cpu``): the golden
capture that support/make_capture.py writes, through
``nrsc5_tpu_torch.cli.main``, with the side effects the JAX package's
tests/test_cli.py asserts (raw and WAV audio, the LOT file dump, the HDC
ADTS dump, the IQ tee, live playback, the log lines the reference CI greps
for).  Each output mode decodes the capture once, in a module fixture;
and ``chip_smoke.py``'s copy of the capture recipe, built with the port's
``tx``, gives the same bytes."""

import importlib
import io
import logging
import sys
import wave

import numpy as np
import pytest
import torch

from nrsc5_tpu_torch import cli

TITLE = "You're Listening to TPU"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("cap") / "sample.cu8"
    mod = importlib.import_module("support.make_capture")
    argv = sys.argv
    sys.argv = ["make_capture.py", str(path)]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return path


class _Log(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _main(args):
    """cli.main on the CPU with the "nrsc5-tpu" log kept."""
    log, keep = logging.getLogger("nrsc5-tpu"), _Log()
    level = log.level
    log.addHandler(keep)
    log.setLevel(logging.INFO)
    try:
        cli.main(args + ["--device", "cpu"])
    finally:
        log.removeHandler(keep)
        log.setLevel(level)
    return keep.lines


@pytest.fixture(scope="module")
def raw_run(capture, tmp_path_factory):
    """One decode with raw audio, the AAS files, the HDC dump and the IQ
    tee (test_cli.py:27 and :139's outputs)."""
    out = tmp_path_factory.mktemp("raw")
    (out / "aas").mkdir()
    lines = _main(["-r", str(capture), "0", "0", "-o", str(out / "a.pcm"),
                   "--dump-aas-files", str(out / "aas"), "--dump-hdc",
                   str(out / "dump.hdc"), "-w", str(out / "tee.cu8")])
    return out, lines


def test_cli_golden_capture(raw_run):
    """The twin of test_cli.py:27: the reference CI's log lines, the LOT
    file reassembled and dumped, real raw PCM, a non-trivial HDC dump."""
    from support.make_capture import LOT_DATA, LOT_NAME
    out, lines = raw_run
    assert f"Title: {TITLE}" in lines
    assert sum(ln.startswith("Synchronized") for ln in lines) == 1
    assert any(ln.startswith("LOT file") for ln in lines)
    assert (out / "aas" / LOT_NAME).read_bytes() == LOT_DATA
    pcm = np.frombuffer((out / "a.pcm").read_bytes(), np.int16)
    assert pcm.size >= 2 * 2048 * 32, f"only {pcm.size} raw samples"
    assert np.abs(pcm).max() > 3000, "raw audio is silent"
    assert (out / "dump.hdc").stat().st_size > 5000


def test_cli_iq_dump_file_mode(raw_run, capture):
    """The twin of test_cli.py:139: -w tees the raw IQ input in file
    mode."""
    out, _ = raw_run
    assert (out / "tee.cu8").read_bytes() == capture.read_bytes()


def test_cli_wav_output(capture, tmp_path):
    """The twin of test_cli.py:58: -o file.wav writes a 44.1 kHz stereo
    WAV of real audio."""
    wav_path = tmp_path / "audio.wav"
    _main(["-r", str(capture), "0", "0", "-o", str(wav_path), "-q"])
    with wave.open(str(wav_path)) as w:
        assert w.getnchannels() == 2
        assert w.getframerate() == 44100
        frames = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    assert frames.size > 0 and np.abs(frames).max() > 3000


def test_cli_wav_to_stdout(capture, monkeypatch):
    """The twin of test_cli.py:72: -o - -t wav streams a RIFF/WAVE file to
    stdout with a pre-declared frame count."""
    sink = io.BytesIO()
    sink.seekable = lambda: False

    class FakeStdout:
        buffer = sink

    monkeypatch.setattr(sys, "stdout", FakeStdout())
    _main(["-r", str(capture), "0", "0", "-o", "-", "-t", "wav", "-q"])
    data = sink.getvalue()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    pcm = np.frombuffer(data[44:len(data) - (len(data) - 44) % 2], np.int16)
    assert pcm.size >= 2 * 2048 * 32, f"only {pcm.size} streamed samples"
    assert np.abs(pcm).max() > 3000, "streamed audio is silent"


def test_cli_live_playback(capture, monkeypatch):
    """The twin of test_cli.py:95: no -o opens a playback backend and
    streams PCM to it through the playback thread."""
    from nrsc5_tpu_torch.audio import playback

    class FakePlayer:
        def __init__(self):
            self.frames = []
            self.closed = False

        def write(self, samples):
            self.frames.append(np.asarray(samples, np.int16))

        def close(self):
            self.closed = True

    player = FakePlayer()
    opened = {}

    def fake_open(rate, channels):
        opened["rate"], opened["channels"] = rate, channels
        return player

    monkeypatch.setattr(playback, "open_player", fake_open)
    _main(["-r", str(capture), "0", "0", "-q"])
    assert opened == {"rate": 44100, "channels": 2}
    assert player.closed
    pcm = np.concatenate(player.frames)
    assert pcm.size >= 2 * 2048 * 32, f"only {pcm.size} live samples"
    assert np.abs(pcm).max() > 3000, "live audio is silent"


def test_playback_backend_probe():
    """The twin of test_cli.py:129: open_player degrades cleanly, None in
    a backend-less container instead of raising."""
    from nrsc5_tpu_torch.audio import playback
    player = playback.open_player(44100, 2)
    if player is not None:  # a real audio device exists here
        player.close()


def test_chip_smoke_capture_is_make_capture(capture):
    """``chip_smoke.make_golden_capture`` (the recipe on the port's ``tx``,
    for the card's machine, which has no JAX) writes the same bytes as
    support/make_capture.py."""
    import chip_smoke
    from support import make_capture as MC
    assert chip_smoke.GOLDEN_TITLE == TITLE
    assert (chip_smoke.GOLDEN_LOT_NAME, chip_smoke.GOLDEN_LOT_DATA,
            chip_smoke.GOLDEN_LOT_ID, chip_smoke.GOLDEN_SIG_PORT) == (
        MC.LOT_NAME, MC.LOT_DATA, MC.LOT_ID, MC.SIG_PORT)
    assert chip_smoke.golden_sig_table() == MC.sig_table()
    assert chip_smoke.golden_lot_fragment() == MC.lot_fragment()
    got = chip_smoke.make_golden_capture()
    assert got.dtype == np.uint8
    assert got.tobytes() == capture.read_bytes()


def test_chip_smoke_am_capture_is_build_am_capture():
    """``chip_smoke.make_session_am_capture`` is
    tests/capture_helpers.py's ``build_am_capture`` (seed 0x5EED, 8 MA1
    frames) on the port's ``tx``, quantized to cs16: the same packets and
    the same int16 wire as the JAX builder's signal quantized alike."""
    import chip_smoke

    from .capture_helpers import build_am_capture
    wire, packets = chip_smoke.make_session_am_capture()
    sig, want = build_am_capture(np.random.default_rng(0x5EED), n_frames=8)
    assert chip_smoke.SEED == 0x5EED
    assert packets == want
    np.testing.assert_array_equal(wire, chip_smoke._cs16(sig))
