"""The port's session on its per-block receivers against the JAX
package's ``NRSC5(device=False)`` on the CPU, with audio: the twins of
tests/test_session.py:288 (real audio through the HDC codec), :410 (two
audio programs in one P1 frame), :577 (MP5 through the turbo receiver)
and :622 (four programs, SIS and an AAS LOT file in one capture), each
event stream held to JAX's event for event (tests/block_twins.py's
tolerances; the AUDIO events' PCM exact: each package's host HDC decoder
gives the same int16, tests/test_torch_audio_host.py), and the JAX test's
own assertions on the port's events."""

import numpy as np
import pytest

from nrsc5_tpu import constants as C
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.hdc_encoder import HDCEncoder
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu.tx.transport_encoder import (aas_frame, build_audio_pdu,
                                            build_p1_fm_frame, pack_frame)
from nrsc5_tpu_torch.api.events import EventType
from nrsc5_tpu_torch.api.session import MODE_FM

from . import block_twins as BT
from .test_session import TITLE, _id3, _sis_station_name_frame
from .test_transport import lot_fragment, sig_table

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)

SR = C.SAMPLE_RATE_AUDIO
AFS = C.AUDIO_FRAME_SAMPLES


def _capture(rng, frames, pids, psmi=1, **impair):
    """2 lead blocks, the P1 frames, 4 trail blocks, on ``pids``."""
    mats = [build_pm_matrix(fr, pids) for fr in frames]
    dummy = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8), pids)
    matrix = np.concatenate([dummy[14 * 32:]] + mats + [dummy[:4 * 32]])
    bc_seq = np.concatenate([np.arange(14, 16),
                             np.tile(np.arange(16), len(frames)),
                             np.arange(4)])
    kw = {}
    if psmi != 1:
        n_ext = C.partitions_per_band(psmi) - C.PM_PARTITIONS
        kw["ext_signs"] = rng.choice(
            np.array([-1, 1], np.int8),
            (len(matrix), 2 * n_ext * C.PARTITION_DATA_CARRIERS * 2))
    return ch.impair(modulate_fm(matrix, bc_seq, psmi, **kw), rng=rng,
                     **impair)


def _packets(tones, n, per_frame=32):
    pk = []
    t = np.arange(n * per_frame * AFS) / SR
    for f0 in tones:
        x = 0.3 * np.sin(2 * np.pi * f0 * t)
        enc, stereo = HDCEncoder(2), np.stack([x, x], axis=-1)
        pk.append([enc.encode_frame(stereo[i * AFS:(i + 1) * AFS])
                   for i in range(n * per_frame)])
    return pk


def _audio(events, program):
    return [e.samples for e in events
            if e.type == EventType.AUDIO and e.program == program]


def _peak_hz(y, start=4096):
    seg = y[start:start + 16384]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return np.fft.rfftfreq(len(seg), 1 / SR)[int(np.argmax(spec))]


def test_fm_session_real_audio(rng):
    """The twin of tests/test_session.py:288: HDC packets of a tone mix
    ride the chain and come back as AUDIO events of the source's PCM
    (above 25 dB against it after alignment)."""
    n_frames = 3
    t = np.arange(n_frames * 32 * AFS) / SR
    land = 0.3 * np.sin(2 * np.pi * 440 * t) \
        + 0.15 * np.sin(2 * np.pi * 1320 * t + 0.5) \
        + 0.1 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    pcm = np.stack([land, 0.8 * land], axis=-1)
    enc = HDCEncoder(2)
    pk = [enc.encode_frame(pcm[i * AFS:(i + 1) * AFS])
          for i in range(n_frames * 32)]
    frames = [build_p1_fm_frame(pk[f * 32:(f + 1) * 32], program=0,
                                pdu_seq=f % 8, seq=(f * 32) % 64)
              for f in range(n_frames)]
    sig = _capture(rng, frames, np.zeros((16, 80), np.uint8),
                   sample_offset=777, cfo_hz=80.0, snr_db=25.0)
    _, events = BT.session_twin(sig, MODE_FM, 65536, flush=True,
                                hdc="auto")
    audio = _audio(events, 0)
    assert len(audio) >= 48, f"only {len(audio)} AUDIO events"
    y = np.concatenate(audio).reshape(-1, 2)[:, 0].astype(np.float64) \
        / 32768.0
    x, start = pcm[:, 0], 8 * AFS
    corr = []
    for lag in range(0, start + 1):
        r, seg = x[start - lag:start - lag + 4096], y[start:start + 4096]
        corr.append(np.dot(seg, r) / (np.linalg.norm(seg)
                                      * np.linalg.norm(r) + 1e-12))
    lag = int(np.argmax(corr))
    r, seg = x[start - lag:start - lag + 16384], y[start:start + 16384]
    err = seg - r
    assert 10 * np.log10(np.dot(r, r) / max(np.dot(err, err), 1e-12)) > 25


def test_fm_session_two_audio_programs(rng):
    """The twin of tests/test_session.py:410: two programs as two PDUs in
    one P1 frame, both announced, each its own bit-exact packets, each its
    own tone."""
    n_frames, tones = 3, (440.0, 660.0)
    pk = _packets(tones, n_frames)
    frames = []
    for f in range(n_frames):
        both = np.concatenate([build_audio_pdu(
            pk[p][f * 32:(f + 1) * 32], program=p, pdu_seq=f % 8,
            seq=(f * 32) % 64) for p in (0, 1)])
        both = np.concatenate(
            [both, np.zeros(C.MAX_PDU_LEN - len(both), np.uint8)])
        frames.append(pack_frame(both, C.P1_FRAME_LEN_FM, C.PCI_AUDIO))
    sig = _capture(rng, frames, np.zeros((16, 80), np.uint8),
                   sample_offset=555, snr_db=25.0)
    _, events = BT.session_twin(sig, MODE_FM, 65536, flush=True,
                                hdc="auto")
    assert {0, 1} <= {e.program for e in events
                      if e.type == EventType.AUDIO_SERVICE}
    for p, f0 in enumerate(tones):
        got = [e.data for e in events if e.type == EventType.HDC
               and e.program == p and not e.crc_error]
        assert len(got) >= 32 and set(got) <= {bytes(q) for q in pk[p]}
        y = np.concatenate(_audio(events, p)).reshape(-1, 2)[:, 0]
        assert abs(_peak_hz(y.astype(np.float64)) - f0) < 20


def test_fm_session_turbo_mp5(rng):
    """The twin of tests/test_session.py:577: MP5 through the turbo
    receiver, which promotes on cm 5 and decodes PM (the extended band
    carried, undecoded): SYNC psmi 5, the title, every HDC packet of
    frames 0-1."""
    n_frames, all_packets, frames = 4, [], []
    for f in range(n_frames):
        packets = [rng.integers(0, 256, 300).astype(np.uint8).tobytes()
                   for _ in range(32)]
        all_packets.append(packets)
        frames.append(build_p1_fm_frame(
            packets, 0, f % 8, (f * 32) % 64,
            psd=aas_frame(0x5100, f, _id3(TITLE))))
    pids = np.broadcast_to(_sis_station_name_frame(), (16, 80))
    sig = _capture(rng, frames, pids, psmi=5, sample_offset=2000,
                   snr_db=25.0)
    _, events = BT.session_twin(sig, MODE_FM, 65536, turbo=True)
    assert 5 in {e.psmi for e in events if e.type == EventType.SYNC}
    assert TITLE in [e.title for e in events if e.type == EventType.ID3]
    hdc = {e.data for e in events if e.type == EventType.HDC
           and not e.crc_error}
    assert not {p for f in range(2) for p in all_packets[f]} - hdc


def test_fm_session_four_programs_sis_aas(rng):
    """The twin of tests/test_session.py:622: four programs as four PDUs a
    frame, SIS on PIDS, ID3 on program 0 and an AAS SIG table and LOT
    file on program 1: four bit-exact streams without leakage, four
    tones, the station name, the title and the LOT file."""
    n_frames, per = 4, 8
    tones = (440.0, 660.0, 880.0, 1320.0)
    pk = _packets(tones, n_frames, per)
    lot = ((np.arange(100) * 7) % 256).astype(np.uint8).tobytes()
    frames = []
    for f in range(n_frames):
        pdus = []
        for p in range(4):
            psd = b""
            if p == 0:
                psd = aas_frame(0x5100, 2 * f, _id3(TITLE))
            elif p == 1 and f == 0:
                psd = aas_frame(0x20, 1, sig_table())
            elif p == 1 and f == 1:
                psd = aas_frame(0x1001, 2, lot_fragment(
                    42, 0, lot, name="four.png", size=len(lot)))
            pdus.append(build_audio_pdu(
                pk[p][f * per:(f + 1) * per], program=p, pdu_seq=f % 8,
                seq=(f * per) % 64, psd=psd))
        both = np.concatenate(pdus)
        both = np.concatenate(
            [both, np.zeros(C.MAX_PDU_LEN - len(both), np.uint8)])
        frames.append(pack_frame(both, C.P1_FRAME_LEN_FM, C.PCI_AUDIO))
    pids = np.broadcast_to(_sis_station_name_frame(), (16, 80))
    sig = _capture(rng, frames, pids, sample_offset=777, snr_db=25.0)
    _, events = BT.session_twin(sig, MODE_FM, 65536, flush=True,
                                hdc="auto")
    assert {0, 1, 2, 3} <= {e.program for e in events
                            if e.type == EventType.AUDIO_SERVICE}
    allpk = [{bytes(q) for q in pk[p]} for p in range(4)]
    for p, f0 in enumerate(tones):
        got = [e.data for e in events if e.type == EventType.HDC
               and e.program == p and not e.crc_error]
        assert len(got) >= 2 * per and set(got) <= allpk[p]
        y = np.concatenate(_audio(events, p)).reshape(-1, 2)[:, 0]
        assert abs(_peak_hz(y.astype(np.float64)) - f0) < 20
    assert "KTPU-FM" in {e.name for e in events
                         if e.type == EventType.STATION_NAME}
    assert TITLE in {e.title for e in events if e.type == EventType.ID3}
    lots = [e for e in events if e.type == EventType.LOT]
    assert lots and lots[0].name == "four.png"
    assert bytes(lots[0].data) == lot
