"""The PyTorch port's host audio copies against the JAX package's modules:
the codec tables, the static tables of the batched device stage, the SBR
band maps, ``HDCDecoder.parse`` (the pure-Python path of the port against
the JAX package's, which runs its native C++ ops where they build), the
host ``decode`` and the ``HDCEncoder``."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from numpy.fft import irfft, rfft

from nrsc5_tpu.audio import aac_core as JA
from nrsc5_tpu.audio import aac_tables as JT
from nrsc5_tpu.audio import batch as JB
from nrsc5_tpu.audio import hdc_decoder as JH
from nrsc5_tpu.audio import huffman as JHU
from nrsc5_tpu.audio import sbr as JS
from nrsc5_tpu.tx import hdc_encoder as JE
from nrsc5_tpu_torch.audio import aac_core as TA
from nrsc5_tpu_torch.audio import aac_tables as TT
from nrsc5_tpu_torch.audio import batch as TB
from nrsc5_tpu_torch.audio import hdc_decoder as TH
from nrsc5_tpu_torch.audio import huffman as THU
from nrsc5_tpu_torch.audio import sbr as TS
from nrsc5_tpu_torch.audio import stage as TST
from nrsc5_tpu_torch.tx import hdc_encoder as TE

torch.set_num_threads(1)

FS = 44100


def _same(a, b, path="") -> None:
    """Deep equality of parse results: numpy arrays by dtype and value,
    dataclasses field by field, sequences element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _public_values(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_")
            and isinstance(v, (np.ndarray, int, float, str, tuple))}


@pytest.mark.parametrize("pair", [(JT, TT), (JA, TA), (JS, TS), (JH, TH),
                                  (JE, TE)],
                         ids=["aac_tables", "aac_core", "sbr", "hdc_decoder",
                              "hdc_encoder"])
def test_module_tables_equal(pair):
    """Every public array and constant of each copied module equals the
    original's (the AAC/SBR codebooks, windows, band tables, constants)."""
    jm, tm = pair
    want, got = _public_values(jm), _public_values(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k], k)
    assert len(want) > 0


def test_prefix_codes_equal():
    """The Huffman prefix codes built from the tables are the same."""
    assert JHU.PrefixCode.__name__ == THU.PrefixCode.__name__
    for i in range(1, 12):
        j, t = JH.SPEC_HUFF[i], TH.SPEC_HUFF[i]
        assert vars(j).keys() == vars(t).keys()
        for k in vars(j):
            _same(vars(t)[k], vars(j)[k], f"SPEC_HUFF[{i}].{k}")


def test_stage_static_tables_equal():
    """The batched stage's static tables (IMDCT bases, QMF analysis kernel,
    synthesis modulation and taps, window LUTs and their indices) equal
    the reference's."""
    for name in ("_imdct_long", "_imdct_short", "_qmf_analysis_kernel",
                 "_synthesis_mod_ri", "_synthesis_taps", "_long_window_lut",
                 "_short_window_lut"):
        _same(getattr(TST, name)(), getattr(JB, name)(), name)
    for seq in (JA.ONLY_LONG, JA.LONG_START, JA.LONG_STOP):
        for shape in (0, 1):
            for prev in (0, 1):
                assert TST._long_window_index(seq, shape, prev) == \
                    JB._long_window_index(seq, shape, prev)
                assert TST._short_window_index(shape, prev) == \
                    JB._short_window_index(shape, prev)


_HEADERS = {
    "default": {},
    "hdr8_7": dict(start_freq=8, stop_freq=7, amp_res=0, xover_band=2),
    "hdr7_6": dict(start_freq=7, stop_freq=6, amp_res=0, xover_band=2),
    "interpol0": dict(start_freq=8, stop_freq=7, amp_res=0, xover_band=2,
                      interpol_freq=0),
    "limiter": dict(limiter_bands=3, limiter_gains=0, noise_bands=3),
}


def _onehot(idx, nb):
    out = np.zeros((nb, len(idx)), np.float32)
    for i, b in enumerate(idx):
        if b >= 0:
            out[b, i] = 1.0
    return out


@pytest.mark.parametrize("name", sorted(_HEADERS))
def test_band_maps_match_reference(name):
    """derive_tables equals the reference's, and the stage's bin -> band
    index maps are the reference device fn's 0/1 indicator matrices
    (seg_hi, seg_lo, seg_noise, lim_seg, hb_onehot), band widths, patch
    sources and noise table; the decoder's chirp noise-band map equals
    the reference decoder's."""
    kw = _HEADERS[name]
    ft = TS.derive_tables(TS.SbrHeader(**kw))
    jft = JS.derive_tables(JS.SbrHeader(**kw))
    _same(ft, jft)
    jdec = JB.BatchedAudioDecoder(1)
    jdec._ensure(jft, JS.SbrHeader(**kw), 4)
    fn = jdec._fn.__wrapped__
    cl = dict(zip(fn.__code__.co_freevars,
                  (c.cell_contents for c in fn.__closure__)))
    maps = TST.band_maps(ft)
    assert np.array_equal(_onehot(maps["band_hi"], ft.n_high), cl["seg_hi"])
    assert np.array_equal(_onehot(maps["band_lo"], ft.n_low), cl["seg_lo"])
    assert np.array_equal(_onehot(maps["band_noise"], ft.n_q),
                          cl["seg_noise"])
    assert np.array_equal(_onehot(maps["lim_band"], ft.n_lim),
                          cl["lim_seg"])
    assert np.array_equal(_onehot(maps["sin_band"], ft.n_high),
                          cl["hb_onehot"])
    for k in ("w_hi", "w_lo", "src_idx", "src_ok"):
        _same(maps[k], cl[k], k)
    stage = TST.DeviceStage(ft, 1.0, interpol=True, device="cpu")
    assert np.array_equal(stage.noise_tab.numpy(), cl["noise_tab"])
    tdec = TB.BatchedAudioDecoder(1, device="cpu")
    tdec._ensure(ft, TS.SbrHeader(**kw), 4)
    assert np.array_equal(tdec._nb_of_tgt, jdec._nb_of_tgt)


def _encode(n, seed=3, sbr=True, channels=2, transients=False, pns=False):
    """The reference test's content (tests/test_audio_batch.py:21-46)."""
    rng = np.random.default_rng(seed)
    m = n * 2048
    t = np.arange(m) / FS
    s2 = rfft(rng.standard_normal(m))
    f = np.arange(len(s2)) * FS / m
    sig = 0.4 * np.sin(2 * np.pi * (300 + 37 * seed) * t) + \
        0.1 * irfft(np.where((f > 4000) & (f < 13000), s2, 0), m)
    pcm = np.stack([sig, sig * 0.85], -1)[:, :channels] * 0.7
    if transients:
        pcm *= 0.1
        for hit in range(2, n, 3):
            pos = hit * 2048 + 700
            tt = np.arange(256)
            burst = (np.sin(2 * np.pi * 2400 * tt / FS)
                     + 0.5 * np.sin(2 * np.pi * 3500 * tt / FS + 1.0)) \
                * np.hanning(256)
            pcm[pos:pos + 256] += \
                (0.7 * burst / np.abs(burst).max())[:, None]
    enc = JE.HDCEncoder(channels=channels, sbr=sbr, pns=pns)
    return [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048]) for k in range(n)]


def _pns_stream(n):
    """A mono tone over noise, coded with perceptual noise substitution for
    the bands 30 dB under the frame's peak."""
    rng = np.random.default_rng(2)
    t = np.arange(n * 2048) / FS
    x = 0.4 * np.sin(2 * np.pi * 500 * t) + 0.01 * rng.standard_normal(
        n * 2048)
    enc = JE.HDCEncoder(channels=1, sbr=True, pns=True, floor_db=-30.0)
    return [enc.encode_frame(x[k * 2048:(k + 1) * 2048, None])
            for k in range(n)]


@pytest.fixture(scope="module")
def streams():
    return {"steady": _encode(4, seed=3),
            "transient": _encode(6, seed=5, channels=1, transients=True),
            "mono": _encode(4, seed=8, channels=1),
            "pns": _pns_stream(4)}


def _parse_all(dec, pkts):
    """Parse a stream packet by packet, advancing the SBR delta-time carry
    as BatchedAudioDecoder.prepare does."""
    out = []
    for p in pkts:
        specs, ics, sd = dec.parse(p)
        if sd is not None:
            for ch, d in enumerate(sd):
                dec._sbr[ch].prev_env = d.env[-1]
                dec._sbr[ch].prev_noise = d.noise[-1]
        out.append((specs, ics, sd))
    return out


@pytest.mark.parametrize("name", ["steady", "transient", "mono", "pns"])
def test_parse_matches_reference(streams, name):
    """HDCDecoder.parse gives exactly the reference's spectra, ICS fields
    and SBR data, packet by packet (the PNS generator's draws included).
    The reference's native C++ section parse leaves ``global_gain`` at its
    default (nothing downstream reads it; its pure-Python path sets it), so
    that one field is held only where both parse in Python."""
    pkts = streams[name]
    want = _parse_all(JH.HDCDecoder(), pkts)
    got = _parse_all(TH.HDCDecoder(), pkts)
    native = JH._native is not None
    seen_short = False
    for k, ((gs, gi, gd), (ws, wi, wd)) in enumerate(zip(got, want)):
        _same(gs, ws, f"{name}[{k}].specs")
        if native:
            gi = dataclasses.replace(gi, global_gain=wi.global_gain)
        _same(gi, wi, f"{name}[{k}].ics")
        _same(gd, wd, f"{name}[{k}].sbr")
        seen_short |= gi.window_sequence == TA.EIGHT_SHORT
    assert seen_short == (name == "transient")
    if name == "pns":
        assert any((np.asarray(i.sfb_cb) == TA.NOISE_HCB).any()
                   for _, i, _ in got)


@pytest.mark.parametrize("name", ["steady", "transient", "mono", "pns"])
def test_host_decode_matches_reference(streams, name):
    """The host decoder's int16 PCM equals the reference's, packet by
    packet; a corrupt packet decodes to None in both."""
    jd, td = JH.HDCDecoder(), TH.HDCDecoder()
    for p in streams[name]:
        a, b = jd.decode(p), td.decode(p)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jd.decode(b"\xff\x00") is None and td.decode(b"\xff\x00") is None


@pytest.mark.parametrize("kw", [dict(channels=2, sbr=True),
                                dict(channels=1, sbr=False)],
                         ids=["stereo_sbr", "mono_core"])
def test_encoder_matches_reference(kw):
    """The port's HDCEncoder writes byte-identical packets for two frames."""
    rng = np.random.default_rng(12)
    n = 2 * 2048
    t = np.arange(n) / FS
    sig = 0.3 * np.sin(2 * np.pi * 660 * t) + 0.05 * rng.standard_normal(n)
    pcm = np.stack([sig, 0.8 * sig], -1)[:, :kw["channels"]]
    je, te = JE.HDCEncoder(pns=False, **kw), TE.HDCEncoder(pns=False, **kw)
    for k in range(2):
        frame = pcm[k * 2048:(k + 1) * 2048]
        assert te.encode_frame(frame) == je.encode_frame(frame)
