"""The port's live-fleet path end to end against the JAX package's, on the
CPU: one MP1 station carrying HDC audio (the default SBR header's tone
and band-noise stream of tests/test_audio_batch.py:21, encoded coarser so
that 32 packets fit a P1 frame) with its ID3 title,
and one MA1 station, pushed as raw cu8 in odd-sized pieces through
``HeterogeneousReceiver`` with mode discovery and ``FleetAudioDecoder``
in each package.  The same modes, each station's same sequence of SYNC,
ID3 titles, HDC packets and their CRC flags, the same number of AUDIO
events, and PCM within the 2 int16 steps that tests/test_torch_audio.py
pins for default-header streams.  The port runs its plain PyTorch
versions (``device="cpu"``), one torch thread."""

import numpy as np
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.audio.fleet import FleetAudioDecoder as JaxFleet
from nrsc5_tpu.serve import HeterogeneousReceiver as JaxHet
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu.tx.transport_encoder import aas_frame, build_p1_fm_frame
from nrsc5_tpu_torch.audio.fleet import FleetAudioDecoder
from nrsc5_tpu_torch.serve import HeterogeneousReceiver

from .test_audio_batch import FS
from .test_serve import _am_stream, _id3

torch.set_num_threads(1)

TITLE = "Parity Fleet Audio"
FM_FRAMES = 4
LSB = 2


def _audio_packets(n, seed=3):
    """tests/test_audio_batch.py:21's content, at target_maxq 8."""
    from numpy.fft import irfft, rfft

    from nrsc5_tpu.tx.hdc_encoder import HDCEncoder

    rng = np.random.default_rng(seed)
    m = n * 2048
    t = np.arange(m) / FS
    s2 = rfft(rng.standard_normal(m))
    f = np.arange(len(s2)) * FS / m
    sig = 0.4 * np.sin(2 * np.pi * (300 + 37 * seed) * t) + \
        0.1 * irfft(np.where((f > 4000) & (f < 13000), s2, 0), m)
    pcm = np.stack([sig, sig * 0.85], -1) * 0.7
    enc = HDCEncoder(channels=2, sbr=True, pns=False, target_maxq=8)
    return [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048])
            for k in range(n)]


def _fm_audio_wire():
    """FM_FRAMES P1 frames of 32 HDC audio packets each, the title in the
    AAS PSD, frame-aligned, as 1.488 MS/s cu8."""
    pkts = _audio_packets(FM_FRAMES * 32)
    psd = aas_frame(0x5100, 0, _id3(TITLE))
    mats = [build_pm_matrix(
        build_p1_fm_frame(pkts[f * 32:(f + 1) * 32], 0, f % 8,
                          (f * 32) % 64, psd=psd),
        np.zeros((16, 80), np.uint8)) for f in range(FM_FRAMES)]
    sig = modulate_fm(np.concatenate(mats),
                      np.tile(np.arange(16), FM_FRAMES), 1)
    buf = np.zeros(len(sig) + C.FFTCP_FM, np.complex64)
    buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
    return ch.to_cu8(ch.upsample2(buf)).tobytes(), pkts


def _run(rx_cls, fleet_cls, wires, **kw):
    events = {0: [], 1: []}
    fleet = fleet_cls(2, lambda st, ev: events[st].append(ev),
                      programs=(0,), k=8, **kw)
    rx = rx_cls(2, fleet.wrap, cold_start=True, input_format="cu8",
                frames_per_dispatch=2, hdc_factory=None, **kw)
    piece = 2 * 98765 + 1
    for lo in range(0, max(map(len, wires)), piece):
        for i, w in enumerate(wires):
            if lo < len(w):
                rx.push(i, w[lo:lo + piece])
    rx.flush()
    fleet.flush()
    fleet.close()
    return rx, events


def _stream(events):
    """SYNC, ID3 titles, HDC packets with their CRC flags, in order; the
    AUDIO events (from the dispatch thread) apart, as PCM."""
    seq = []
    for e in events:
        name = e.type.name
        if name == "SYNC":
            seq.append(("SYNC", int(e.psmi)))
        elif name == "LOST_SYNC":
            seq.append(("LOST_SYNC",))
        elif name == "ID3":
            seq.append(("ID3", e.title))
        elif name == "HDC":
            seq.append(("HDC", int(e.program), bytes(e.data),
                        bool(e.crc_error)))
    audio = [np.asarray(e.samples) for e in events
             if e.type.name == "AUDIO"]
    return seq, audio


def test_auto_fleet_with_fleet_audio_matches_jax(rng):
    fm_wire, fm_packets = _fm_audio_wire()
    am_sig, am_packets = _am_stream(rng, 10)
    up = ch.upsample_exact(am_sig, 32)
    am_wire = ch.to_cu8(up * (0.4 / np.abs(up).max())).tobytes()
    wires = [fm_wire, am_wire]

    jrx, jev = _run(JaxHet, JaxFleet, wires)
    prx, pev = _run(HeterogeneousReceiver, FleetAudioDecoder, wires,
                    device="cpu")
    assert list(prx.station_modes) == list(jrx.station_modes) \
        == [("fm", 1), ("am", False)]
    for st in (0, 1):
        jseq, jaudio = _stream(jev[st])
        pseq, paudio = _stream(pev[st])
        assert pseq == jseq, st
        assert len(paudio) == len(jaudio), st
        diff = np.abs(np.concatenate(paudio).astype(np.int64)
                      - np.concatenate(jaudio).astype(np.int64))
        assert diff.max() <= LSB, (st, int(diff.max()))
    # what the fleet is for: the FM station's title, its clean audio
    # packets decoded, the AM station's packets exact
    seq0, audio0 = _stream(pev[0])
    assert ("ID3", TITLE) in seq0
    clean = [s[2] for s in seq0 if s[0] == "HDC" and not s[3]]
    assert len(clean) >= 64 and set(clean) <= set(fm_packets)
    assert len(audio0) >= 64
    assert np.abs(np.concatenate(audio0)).max() > 1000
    seq1, _ = _stream(pev[1])
    exact = {s[2] for s in seq1 if s[0] == "HDC" and not s[3]}
    assert len(exact & {bytes(p) for p in am_packets}) >= 32
    assert [s[0] for s in seq0 + seq1].count("SYNC") == 2
