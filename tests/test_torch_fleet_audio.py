"""The port's ``audio/fleet.FleetAudioDecoder`` on the CPU: twins of
tests/test_audio_batch.py:127, 189, 268, 390, 483 and 563 on the same
streams and events, each checking what its JAX test checks on the port
(``device="cpu"``: the receiver's and the audio stage's plain PyTorch
versions); the repair of the reference's error hand-off (the first error
of two failing threads is the one raised); and fleet-audio files of
either package loaded by the other's, both resuming to the same PCM.
One torch thread."""

import threading
import time

import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.hdc_encoder import HDCEncoder
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu.tx.transport_encoder import build_p1_fm_frame
from nrsc5_tpu_torch.api.events import EventType, make
from nrsc5_tpu_torch.audio.batch import BatchedAudioDecoder
from nrsc5_tpu_torch.audio.fleet import FleetAudioDecoder
from nrsc5_tpu_torch.audio.hdc_decoder import HDCDecoder
from nrsc5_tpu_torch.serve import MultiStationReceiver

from .test_audio_batch import FS, _packets

torch.set_num_threads(1)


def _fleet(n, cb, **kw):
    return FleetAudioDecoder(n, cb, device="cpu", **kw)


def _hdc_event(p, program=0):
    return make(EventType.HDC, program=program, data=p, crc_error=False)


def _audio(events, program=None):
    return [e for e in events if e.type == EventType.AUDIO
            and (program is None or e.program == program)]


def _snr_to_host(events, audio, skip, program=None):
    """SNR of the fleet's PCM against the port's host decoder on the same
    clean packets, from packet ``skip`` on."""
    pcm = np.concatenate([np.asarray(e.samples) for e in audio])
    host = HDCDecoder()
    hdcs = [e.data for e in events if e.type == EventType.HDC
            and not e.crc_error and (program is None or e.program == program)]
    ref = np.concatenate([host.decode(p).reshape(-1)
                          for p in hdcs[:len(audio)]])
    m = min(len(pcm), len(ref))
    a = pcm[skip * 4096:m].astype(np.float64)
    b = ref[skip * 4096:m].astype(np.float64)
    return 10 * np.log10((b ** 2).sum() / max(((a - b) ** 2).sum(), 1e-30))


def test_fleet_audio_through_serving(rng):
    """Twin of test_audio_batch.py:127: two FM stations carrying a 440 Hz
    tone's HDC packets through the port's receiver and fleet audio; at
    least 48 AUDIO events a station, audible, > 50 dB against the host
    decoder on the same packets."""
    t = np.arange(12 * 2048) / FS
    tone = np.stack([0.4 * np.sin(2 * np.pi * 440 * t)] * 2, -1)
    enc = HDCEncoder(channels=2, sbr=True, pns=False)
    hdc_pkts = [enc.encode_frame(tone[k * 2048:(k + 1) * 2048])
                for k in range(12)]
    n_frames = 3
    pool = hdc_pkts * ((n_frames * 32) // len(hdc_pkts) + 1)
    mats = []
    for f in range(n_frames):
        p1 = build_p1_fm_frame(pool[f * 32:(f + 1) * 32], program=0,
                               pdu_seq=f % 8, seq=(f * 32) % 64)
        mats.append(build_pm_matrix(p1, np.zeros((16, 80), np.uint8)))
    sig = modulate_fm(np.concatenate(mats),
                      np.tile(np.arange(16), n_frames), 1)
    buf = np.zeros(len(sig) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig

    events = {0: [], 1: []}
    fleet = _fleet(2, lambda st, ev: events[st].append(ev), k=4)
    rx = MultiStationReceiver(2, fleet.wrap, frames_per_dispatch=1,
                              hdc_factory=None, device="cpu")
    for lo in range(0, len(buf), 300000):
        for i in range(2):
            rx.push(i, buf[lo:lo + 300000])
    rx.flush()
    fleet.flush()
    fleet.close()
    for i in range(2):
        audio = _audio(events[i])
        assert len(audio) >= 48, len(audio)
        pcm = np.concatenate([np.asarray(e.samples) for e in audio])
        assert np.abs(pcm).max() > 1000
        assert _snr_to_host(events[i], audio, 8) > 50.0


def test_fleet_starving_station_padded():
    """Twin of test_audio_batch.py:189: a station that never produces a
    packet is padded with silence once its lag passes max_lag; the other
    decodes every packet; no queue is left."""
    events = {0: [], 1: []}
    fleet = _fleet(2, lambda st, ev: events[st].append(ev), k=4, max_lag=8)
    for p in _packets(12, seed=21):
        fleet.wrap(0, _hdc_event(p))
    fleet.flush()
    a0, a1 = _audio(events[0]), _audio(events[1])
    assert len(a0) == 12 and len(a1) == 4
    assert max(len(q) for q in fleet._queues) == 0
    pcm0 = np.concatenate([np.asarray(e.samples) for e in a0])
    pcm1 = np.concatenate([np.asarray(e.samples) for e in a1])
    assert np.abs(pcm0[4 * 4096:]).max() > 1000
    assert np.abs(pcm1).max() == 0
    fleet.close()


def test_fleet_audio_checkpoint_resume(tmp_path):
    """Twin of test_audio_batch.py:268: half the packets through fleet A,
    saved with 2 packets queued, loaded into a fresh fleet B, the rest
    decoded: the PCM of one uninterrupted decode, within 1 int16 step."""
    pkts = _packets(12, seed=17)
    path = str(tmp_path / "fleet_audio.npz")
    ev_a, ev_b = [], []
    fa = _fleet(1, lambda st, ev: ev_a.append(ev), k=4)
    for p in pkts[:6]:
        fa.wrap(0, _hdc_event(p))
    fa.save(path)
    fa.close()
    fb = _fleet(1, lambda st, ev: ev_b.append(ev), k=4)
    fb.load(path)
    for p in pkts[6:]:
        fb.wrap(0, _hdc_event(p))
    fb.flush()
    fb.close()
    audio = _audio(ev_a + ev_b)
    assert len(audio) == 12
    pcm = np.concatenate([np.asarray(e.samples) for e in audio]) \
        .astype(np.int64)
    one = BatchedAudioDecoder(1, device="cpu").decode([pkts])[0] \
        .reshape(-1).astype(np.int64)
    assert np.abs(pcm - one).max() <= 1


def test_fleet_shed_under_overload():
    """Twin of test_audio_batch.py:390: with max_pending 0 every batch of
    wrap() is shed as silence in order; flush's batch decodes."""
    events = []
    fleet = _fleet(1, lambda st, ev: events.append(ev), k=4, max_pending=0)
    for p in _packets(10, seed=23):
        fleet.wrap(0, _hdc_event(p))
    fleet.flush()
    audio = _audio(events)
    assert len(audio) == 10
    assert np.abs(np.concatenate(
        [np.asarray(e.samples) for e in audio[:8]])).max() == 0
    assert np.abs(np.concatenate(
        [np.asarray(e.samples) for e in audio[8:]])).max() > 0
    fleet.close()


def test_fleet_audio_am_serving(rng):
    """Twin of test_audio_batch.py:483: two MA1 stations carrying mono HDC
    audio through the port's AM receiver and fleet audio; at least 16
    AUDIO events a station, audible, > 50 dB against the host decoder."""
    from numpy.fft import irfft, rfft

    from nrsc5_tpu.tx import encoder_am as EAM
    from nrsc5_tpu.tx.modulator_am import modulate_am
    from nrsc5_tpu.tx.transport_encoder import build_p1_am_frame

    n_src = 20
    t = np.arange(n_src * 2048) / FS
    s2 = rfft(rng.standard_normal(n_src * 2048))
    f = np.arange(len(s2)) * FS / (n_src * 2048)
    lp = irfft(np.where(f < 2500, s2, 0), n_src * 2048)
    sig = (0.3 * np.sin(2 * np.pi * 330 * t) + 0.1 * lp).reshape(-1, 1)
    enc = HDCEncoder(channels=1, sbr=False, pns=False,
                     target_maxq=6, floor_db=-35.0)
    hdc_pkts = [enc.encode_frame(sig[k * 2048:(k + 1) * 2048])
                for k in range(n_src)]
    hdc_pkts = [p for p in hdc_pkts if 40 <= len(p) <= 100]
    assert len(hdc_pkts) >= 4
    n = 7
    pool = hdc_pkts * (n * 32 // len(hdc_pkts) + 1)
    p1_frames, gi = [], 0
    for fr in range(n):
        sub = []
        for b in range(8):
            sub.append(build_p1_am_frame(pool[gi:gi + 4], 0,
                                         (fr * 8 + b) % 8,
                                         ((fr * 8 + b) * 4) % 64))
            gi += 4
        p1_frames.append(np.stack(sub))
    p3 = rng.integers(0, 2, (n, C.P3_FRAME_LEN_MA1)).astype(np.uint8)
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(p1_frames[fr]) for fr in range(n)],
        [EAM.encode_p3_am(p3[fr], False) for fr in range(n)], False)
    pids_codes = np.stack([EAM.encode_pids_am(
        rng.integers(0, 2, 80).astype(np.uint8)) for _ in range(n * 8)])
    ref = np.stack([EAM.am_ref_bits(b % 8, 1) for b in range(n * 8)])
    sig = modulate_am(mats, pids_codes, ref, False)
    buf = np.zeros(len(sig) + C.FFTCP_AM, np.complex64)
    buf[C.FFTCP_AM // 2:C.FFTCP_AM // 2 + len(sig)] = sig

    events = {0: [], 1: []}
    fleet = _fleet(2, lambda st, ev: events[st].append(ev), k=4)
    rx = MultiStationReceiver(2, fleet.wrap, frames_per_dispatch=2,
                              mode="am", hdc_factory=None, device="cpu")
    for lo in range(0, len(buf), 100000):
        for i in range(2):
            rx.push(i, buf[lo:lo + 100000])
    rx.flush()
    fleet.flush()
    fleet.close()
    for i in range(2):
        audio = _audio(events[i])
        assert len(audio) >= 16, len(audio)
        pcm = np.concatenate([np.asarray(e.samples) for e in audio])
        assert np.abs(pcm).max() > 500
        assert _snr_to_host(events[i], audio, 4) > 50.0


@pytest.mark.parametrize("subscribe", ["explicit", "auto"])
def test_fleet_audio_two_programs(subscribe):
    """Twin of test_audio_batch.py:563: a two-program P1 frame through the
    port's receiver; both programs' PCM, each > 50 dB against the host
    decoder on its own packets, subscribed explicitly and discovered."""
    from nrsc5_tpu.tx.transport_encoder import build_audio_pdu, pack_frame

    n_frames = 3
    t = np.arange(n_frames * 32 * 2048) / FS
    pk = []
    for f0 in (440.0, 660.0):
        enc = HDCEncoder(channels=2, sbr=True, pns=False)
        x = 0.3 * np.sin(2 * np.pi * f0 * t)
        stereo = np.stack([x, x], axis=-1)
        pk.append([enc.encode_frame(stereo[i * 2048:(i + 1) * 2048])
                   for i in range(n_frames * 32)])
    mats, pids = [], np.zeros((16, 80), np.uint8)
    for f in range(n_frames):
        pdus = [build_audio_pdu(pk[p][f * 32:(f + 1) * 32], program=p,
                                pdu_seq=f % 8, seq=(f * 32) % 64)
                for p in (0, 1)]
        both = np.concatenate(pdus)
        both = np.concatenate(
            [both, np.zeros(C.MAX_PDU_LEN - len(both), np.uint8)])
        mats.append(build_pm_matrix(
            pack_frame(both, C.P1_FRAME_LEN_FM, C.PCI_AUDIO), pids))
    sig = modulate_fm(np.concatenate(mats),
                      np.tile(np.arange(16), n_frames), 1)
    buf = np.zeros(len(sig) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig

    events = []
    kw = dict(programs=(0, 1)) if subscribe == "explicit" \
        else dict(programs="auto", max_programs=2)
    fleet = _fleet(1, lambda st, ev: events.append(ev), k=4, **kw)
    rx = MultiStationReceiver(1, fleet.wrap, frames_per_dispatch=1,
                              hdc_factory=None, device="cpu")
    for lo in range(0, len(buf), 300000):
        rx.push(0, buf[lo:lo + 300000])
    rx.flush()
    fleet.flush()
    fleet.close()
    for p in (0, 1):
        audio = _audio(events, program=p)
        assert len(audio) >= 24, (p, len(audio))
        pcm = np.concatenate([np.asarray(e.samples) for e in audio])
        assert np.abs(pcm).max() > 1000
        assert _snr_to_host(events, audio, 8, program=p) > 50.0, p


def test_fleet_first_error_wins():
    """Two worker threads failing: the prepare thread on batch 2, then the
    dispatch thread on batch 1.  Each records its error under the fleet's
    lock (while the test holds it, nothing is recorded, where the
    reference's workers check and set the error without it); the first
    error, the prepare thread's, is the one flush() raises, once."""
    fleet = _fleet(1, lambda st, ev: None, k=1)
    prepared = threading.Event()
    prep, disp = fleet._dec.prepare, fleet._dec.dispatch
    calls = {"prepare": 0}

    def prepare(batch):
        calls["prepare"] += 1
        if calls["prepare"] == 2:
            prepared.set()
            raise RuntimeError("prepare failed first")
        return prep(batch)

    def dispatch(item):
        # fail once the prepare thread's error is recorded
        deadline = time.monotonic() + 30
        while fleet._err is None and time.monotonic() < deadline:
            time.sleep(0.01)
        raise RuntimeError("dispatch failed second")

    fleet._dec.prepare, fleet._dec.dispatch = prepare, dispatch
    pkts = _packets(2, seed=5)
    with fleet._lock:
        # the workers start under the lock (submit holds it); wrap would
        # take it itself, so queue the two batches as wrap does
        fleet._queues[0] += pkts
        fleet._submit_locked(([pkts[:1]], [1]))
        fleet._submit_locked(([pkts[1:]], [1]))
        prepared.wait(30)
        time.sleep(0.5)
        assert fleet._err is None  # recorded only under the lock
    fleet._work.join()
    fleet._disp.join()
    with pytest.raises(RuntimeError, match="prepare failed first"):
        fleet.flush()
    fleet._queues[0].clear()
    fleet.flush()  # raised once
    fleet.close()


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load(tmp_path, saver):
    """One package's fleet audio decodes 6 packets and saves (2 packets
    queued); a fresh decoder of each package loads the file and decodes the
    rest: the same number of AUDIO events, the PCM within 2 int16 steps
    (tests/test_torch_audio.py's tolerance on default-header streams)."""
    from nrsc5_tpu.api.events import EventType as JaxType
    from nrsc5_tpu.api.events import make as jax_make
    from nrsc5_tpu.audio.fleet import FleetAudioDecoder as JaxFleet

    pkts = _packets(12, seed=17)
    path = str(tmp_path / f"{saver}.npz")
    fa = (JaxFleet(1, lambda st, ev: None, k=4) if saver == "jax"
          else _fleet(1, lambda st, ev: None, k=4))
    for p in pkts[:6]:
        fa.wrap(0, jax_make(JaxType.HDC, program=0, data=p, crc_error=False))
    fa.save(path)
    fa.close()
    runs = []
    for make_fleet in (lambda cb: JaxFleet(1, cb, k=4),
                       lambda cb: _fleet(1, cb, k=4)):
        events = []
        fb = make_fleet(lambda st, ev: events.append(ev))
        fb.load(path)
        for p in pkts[6:]:
            fb.wrap(0, _hdc_event(p))
        fb.flush()
        fb.close()
        runs.append(np.concatenate([np.asarray(e.samples) for e in events
                                    if int(e.type) == int(EventType.AUDIO)]))
    assert len(runs[0]) == len(runs[1]) == 8 * 4096
    assert np.abs(runs[0].astype(np.int64)
                  - runs[1].astype(np.int64)).max() <= 2
