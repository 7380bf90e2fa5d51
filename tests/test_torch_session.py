"""The port's session (``nrsc5_tpu_torch.api.session.NRSC5``) on its
device chain (``chain="device"``) and its ``DeviceReceiver`` against the
JAX package's, on the CPU: the port runs its kernels' plain versions
(``device="cpu"``), JAX its device receiver (``device=True``) on the CPU
backend.

Tolerances: the event streams are compared by tests/serve_events.py's
``same_events`` — every event equal (decoded bits, HDC packets, ID3, SIS,
SYNC exact), the MER floats within ``MER_DB`` (0.1 dB); the cu8 ingest's
buffered chain input equal to JAX's within 1e-6 (the halfband sums in the
same order; the stated bound covers float32 rounding of the scale)."""

import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as JC
from nrsc5_tpu.api.session import NRSC5 as JNRSC5
from nrsc5_tpu.pipeline.device_receiver import \
    DeviceReceiver as JDeviceReceiver
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu.tx.transport_encoder import aas_frame, build_p1_fm_frame
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.api.session import MODE_AM, MODE_FM, NRSC5
from nrsc5_tpu_torch.pipeline.device_receiver import DeviceReceiver

from .capture_helpers import build_am_capture
from .serve_events import same_events
from .test_session import TITLE, _id3, _sis_station_name_frame

INGEST_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the session drives many small ops, and beside the
    other xdist workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fm_signal(rng):
    """tests/test_session.py:489's FM recipe: 3 frames of random HDC
    packets with the ID3 title, SIS station name on PIDS, offset 4321,
    150 Hz CFO, 23 dB.  Returns (complex64 signal, packets by frame)."""
    all_packets, p1_frames = [], []
    for f in range(3):
        packets = [rng.integers(0, 256, 300).astype(np.uint8).tobytes()
                   for _ in range(32)]
        all_packets.append(packets)
        psd = aas_frame(0x5100, f, _id3(TITLE))
        p1_frames.append(build_p1_fm_frame(
            packets, program=0, pdu_seq=f % 8, seq=(f * 32) % 64, psd=psd))
    pids = np.broadcast_to(_sis_station_name_frame(), (16, 80))
    mats = [build_pm_matrix(p1_frames[f], pids) for f in range(3)]
    dummy = build_pm_matrix(
        rng.integers(0, 2, JC.P1_FRAME_LEN_FM).astype(np.uint8), pids)
    matrix = np.concatenate([dummy[14 * 32:]] + mats + [dummy[:4 * 32]])
    bc_seq = np.concatenate([np.arange(14, 16), np.tile(np.arange(16), 3),
                             np.arange(4)])
    sig = modulate_fm(matrix, bc_seq, 1)
    sig = ch.impair(sig, sample_offset=4321, cfo_hz=150.0, snr_db=23.0,
                    rng=rng)
    return sig, all_packets


def _both_sessions(mode_jax, mode_port, sig, chunk):
    """The same complex64 stream pushed through JAX's device session and
    the port's CPU session, in pieces of ``chunk``, then flush.  Returns
    (JAX events, port events)."""
    runs = []
    for radio_of in (
            lambda cb: JNRSC5.open_pipe(cb, mode_jax, device=True,
                                        hdc_decoder_factory=None),
            lambda cb: NRSC5.open_pipe(cb, mode_port, device="cpu",
                                       chain="device",
                                       hdc_decoder_factory=None)):
        events = []
        radio = radio_of(events.append)
        for i in range(0, len(sig), chunk):
            radio.pipe_samples_cs16(sig[i:i + chunk])
        radio.flush()
        runs.append(events)
    return runs


def test_fm_session_matches_jax(rng):
    """The twin of test_session.py:489 (the device backend): cold start
    from unknown offset and CFO, then the golden-path assertions, on the
    port's session; and JAX's device session's event stream, event for
    event."""
    sig, all_packets = _fm_signal(rng)
    want, got = _both_sessions(0, MODE_FM, sig, 65536)
    same_events({0: want}, {0: got})
    kinds = {e.type for e in got}
    assert EventType.SYNC in kinds
    assert sum(e.type == EventType.SYNC for e in got) == 1
    assert TITLE in [e.title for e in got if e.type == EventType.ID3]
    assert "KTPU-FM" in [e.name for e in got
                         if e.type == EventType.STATION_NAME]
    hdc = {e.data for e in got if e.type == EventType.HDC
           and not e.crc_error}
    missing = {p for f in (0, 1) for p in all_packets[f]} - hdc
    assert not missing, f"{len(missing)} HDC packets missing"
    assert EventType.AUDIO_SERVICE in kinds


def test_am_session_matches_jax(rng):
    """The twin of test_session.py:539: MA1 cold start from a complex
    stream pushed 50000 samples at a time, at least 48 bit-exact HDC
    packets after the warm-up; and JAX's device session's events."""
    sig, packets = build_am_capture(rng, n_frames=8)
    want, got = _both_sessions(1, MODE_AM, sig, 50000)
    same_events({0: want}, {0: got})
    assert sum(e.type == EventType.SYNC for e in got) == 1
    hdc = {e.data for e in got if e.type == EventType.HDC
           and not e.crc_error}
    sent = {bytes(p) for _, pk in packets for p in pk}
    assert len(hdc & sent) >= 48, len(hdc & sent)
    assert hdc <= sent


# pieces of a cu8 stream: shorter than one output sample, odd (mid-pair),
# and long
_SPLITS = (1, 2, 3, 27, 33333, 4096, 1, 50001, 7)


@pytest.mark.parametrize("fm", [True, False])
def test_cu8_ingest_matches_jax(fm):
    """``push_cu8`` on the same cu8 pushes split at odd sizes (a push too
    short for one output sample waits in the tail): the port's buffered
    chain input equals JAX's within INGEST_TOL, and both equal one push of
    the whole stream."""
    data = np.random.default_rng(17).integers(0, 256, sum(_SPLITS) + 64
                                              ).astype(np.uint8)
    bufs = []
    for make in (lambda: JDeviceReceiver(lambda ev: None, mode_fm=fm),
                 lambda: DeviceReceiver(lambda ev: None, mode_fm=fm,
                                        device="cpu")):
        r = make()
        lo = 0
        for n in _SPLITS:
            r.push_cu8(data[lo:lo + n])
            lo += n
        r.push_cu8(data[lo:])
        bufs.append(np.concatenate(r._buf))
    one = DeviceReceiver(lambda ev: None, mode_fm=fm, device="cpu")
    one.push_cu8(data)
    want, got = bufs
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=INGEST_TOL)
    np.testing.assert_array_equal(got, np.concatenate(one._buf))


def test_short_cu8_push_launches_nothing(monkeypatch):
    """A cu8 push too short for one output sample of K1 waits in the tail:
    the ingest is not called and nothing is buffered."""
    calls = []
    from nrsc5_tpu_torch.ops import frontend as FE
    monkeypatch.setattr(FE, "ingest_fm_cu8",
                        lambda w: calls.append(w.shape) or FE.
                        ingest_fm_cu8_plain(w))
    r = DeviceReceiver(lambda ev: None, device="cpu")
    for n in (1, 2):
        r.push_cu8(np.full(n, 130, np.uint8))
    assert calls == [] and r._buf == []
    r.push_cu8(np.full(1, 130, np.uint8))  # two whole pairs: one sample
    assert calls == [(1, 16, 2)] and len(r._buf[0]) == 1


def test_device_receiver_odd_cu8(rng):
    """The twin of test_session.py:559: push_cu8 carries partial I/Q pair
    bytes across pushes; odd chunk splits land mid-pair and must not crash
    or desync."""
    data = rng.integers(0, 256, 100001).astype(np.uint8)  # odd total
    r1 = DeviceReceiver(lambda ev: None, device="cpu")
    r1.push_cu8(data[:100000])  # one even-length push
    even = np.concatenate(r1._buf)
    r2 = DeviceReceiver(lambda ev: None, device="cpu")
    for lo in range(0, len(data), 33333):  # odd chunks split mid-pair
        r2.push_cu8(data[lo:lo + 33333])
    odd = np.concatenate(r2._buf)
    assert len(odd) >= len(even)
    np.testing.assert_array_equal(odd[:len(even)], even)


def test_cs16_bytes_push_and_partial_pairs():
    """The twin of test_session.py:241: pipe_samples_cs16 accepts raw
    bytes and carries a trailing partial I/Q pair to the next call
    (reference: src/nrsc5.c:627-650 leftover handling)."""
    radio = NRSC5.open_pipe(lambda ev: None, MODE_FM, device="cpu")
    got = []
    radio.radio.push_cs16 = lambda arr: got.append(np.asarray(arr))

    rng = np.random.default_rng(5)
    iq = rng.integers(-3000, 3000, 4 * 100, dtype=np.int16)
    raw = iq.tobytes()
    for lo, hi in ((0, 7), (7, 130), (130, 133), (133, len(raw))):
        radio.pipe_samples_cs16(raw[lo:hi])
    stream = np.concatenate(got)

    radio2 = NRSC5.open_pipe(lambda ev: None, MODE_FM, device="cpu")
    got2 = []
    radio2.radio.push_cs16 = lambda arr: got2.append(np.asarray(arr))
    radio2.pipe_samples_cs16(iq)
    assert np.array_equal(stream, np.concatenate(got2))


def test_cs16_file_worker(tmp_path):
    """The twin of test_session.py:264: open_file(input_format='cs16') +
    start(): the worker thread survives raw byte reads (odd tails
    included) and emits LOST_DEVICE at EOF."""
    rng = np.random.default_rng(6)
    path = tmp_path / "capture.cs16"
    path.write_bytes(rng.integers(-100, 100, 3 * 16384 + 1,
                                  dtype=np.int16).tobytes())

    events = []
    radio = NRSC5.open_file(str(path), events.append, MODE_FM,
                            input_format="cs16", device="cpu")
    pushed = []
    radio.radio.push_cs16 = lambda arr: pushed.append(np.asarray(arr))
    radio.start()
    radio._worker.join(timeout=30)
    assert not radio._worker.is_alive(), "worker thread hung"
    radio.close()
    assert any(e.type == EventType.LOST_DEVICE for e in events)
    assert sum(len(p) for p in pushed) == (3 * 16384 + 1) // 2


def test_set_mode_switch_and_version(rng):
    """The twin of test_session.py:360: an FM session switched to AM
    rewires the chain and decodes an AM capture; set_callback swaps the
    sink; the version string and a NaN frequency without a tuner.  The
    JAX test runs its host receiver, which releases frames 4 and 5 of the
    7; the device receiver (JAX's too, measured on this capture) releases
    frame 4 whole and cuts frame 5, the last, short of the dispatch's
    lookahead, so frame 4 is the one held whole here."""
    events = []
    radio = NRSC5.open_pipe(events.append, MODE_FM, device="cpu",
                            chain="device", hdc_decoder_factory=None)
    radio.set_mode(MODE_AM)
    assert not radio.radio._fm
    sig, packets = build_am_capture(rng, n_frames=7, ma3=False)
    for i in range(0, len(sig), 32768):
        radio.pipe_samples_cs16(sig[i:i + 32768])
    radio.flush()
    assert EventType.SYNC in {e.type for e in events}
    hdc = {e.data for e in events if e.type == EventType.HDC
           and not e.crc_error}
    want = {p for f, pk in packets if f == 4 for p in pk}
    assert want <= hdc
    assert hdc <= {p for _, pk in packets for p in pk}

    late = []
    radio.set_callback(late.append)
    radio.flush()
    assert NRSC5.get_version() == "0.1.0"
    assert radio.get_frequency() != radio.get_frequency()  # NaN: no tuner


def test_set_mode_reentrant_from_callback(rng):
    """The twin of test_session.py:389: set_callback from inside the event
    callback (events are emitted under the session lock) must not
    deadlock."""
    done = []

    def cb(ev):
        if ev.type == EventType.SYNC and not done:
            done.append(True)
            radio.set_callback(lambda e: None)

    radio = NRSC5.open_pipe(cb, MODE_AM, device="cpu", chain="device",
                            hdc_decoder_factory=None)
    sig, _ = build_am_capture(rng, n_frames=5, ma3=False)
    for i in range(0, len(sig), 32768):
        radio.pipe_samples_cs16(sig[i:i + 32768])
    assert done, "never synced"


def test_session_needs_a_card_unless_cpu(tmp_path):
    """The session, its receiver and the CLI run on the card by default
    and raise without one; ``"cpu"`` is asked for explicitly."""
    from nrsc5_tpu_torch import cli
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NRSC5(lambda ev: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NRSC5.open_pipe(lambda ev: None, MODE_AM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceReceiver(lambda ev: None)
    path = tmp_path / "empty.cu8"
    path.write_bytes(b"")
    out = tmp_path / "audio.pcm"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-r", str(path), "0", "0", "-o", str(out)])
    assert not out.exists()  # refused before any output opened
    assert K.resolve_device("cpu").type == "cpu"
    cli.main(["-r", str(path), "0", "0", "-o", str(out), "-q",
              "--device", "cpu"])
    assert out.exists() and out.stat().st_size == 0


@pytest.mark.parametrize("stations", [1, 2])
def test_loop_outputs_are_fresh(stations):
    """The FM and AM block loops' results leave ``finish_scan`` and
    ``finish_scan_am`` as copies, at one station too, where the
    station-major view of a block-major buffer is contiguous already: a
    CUDA graph's next replay rewrites those buffers, and the receiver
    reads a dispatch's MER errors on the host only after it has queued the
    next dispatch."""
    from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
    from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc

    def block_major(*shape, dtype=torch.float32):
        return torch.arange(int(np.prod(shape))).reshape(shape).to(dtype)

    n = 4
    fm = {"pm": block_major(n, stations, 8, dtype=torch.int8),
          "diag": {"error_lb": block_major(n, stations)},
          "px": {"px1": block_major(n, stations, 6, dtype=torch.int8)},
          "carry": {"offset": block_major(stations)}}
    pm, diag, px, _ = rcc.finish_scan(
        fm, rcc.ChainCarryRC(*[None] * len(rcc.ChainCarryRC._fields)))
    am = {"codes": block_major(n, stations, 4, 5, dtype=torch.uint8),
          "pids": block_major(n, stations, 3, 2, dtype=torch.uint8),
          "carry": {"offset": block_major(stations)}}
    codes, pids, _ = scar.finish_scan_am(
        am, scar.AMChainCarryRC(*[None] * len(scar.AMChainCarryRC._fields)))
    for got, src in ((pm, fm["pm"]), (diag["error_lb"],
                                      fm["diag"]["error_lb"]),
                     (px["px1"], fm["px"]["px1"]), (codes, am["codes"]),
                     (pids, am["pids"])):
        assert got.is_contiguous()
        assert torch.equal(got, src.transpose(0, 1))
        assert got.untyped_storage().data_ptr() \
            != src.untyped_storage().data_ptr()
