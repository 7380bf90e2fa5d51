"""The port's batched HDC -> PCM decoder against the JAX package's.

The port's device stage (``nrsc5_tpu_torch/audio/stage.py``, the plain
PyTorch versions of K16a-d on the CPU) is held to the reference's
``_make_device_fn`` on the reference's own prepared inputs, and the port's
``BatchedAudioDecoder`` to the reference's on the cases of
tests/test_audio_batch.py (each twin also holds that test's own bound
against the host decoder).  A JAX decoder's ``checkpoint()`` restores into
the port's, which continues the stream.

Tolerance: int16 PCM within 2 LSB of the reference on every sample, and
the carried state within 1e-5 of its largest magnitude.  Where a stream
parts by more, the case is a witness that pins the measured difference
(``PARTS``, ``STATE_PARTS``; ROADMAP.md §3): the SBR HF generator's
covariance LPC runs in float32, and for tonal content its determinant
cancels most of its digits, so a last-bit difference in the QMF samples
(the IMDCT products are matmuls whose summation order is the BLAS's, in
both frameworks) moves the predictor, and with it the HF band, by far more
than a rounding step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from numpy.fft import irfft, rfft

import jax
import jax.numpy as jnp
from nrsc5_tpu.audio import batch as JB
from nrsc5_tpu.audio import sbr as JS
from nrsc5_tpu.tx.hdc_encoder import HDCEncoder
from nrsc5_tpu_torch.audio import sbr as TS
from nrsc5_tpu_torch.audio import stage as TST
from nrsc5_tpu_torch.audio.batch import BatchedAudioDecoder, device_inputs
from nrsc5_tpu_torch.audio.hdc_decoder import HDCDecoder

torch.set_num_threads(1)

FS = 44100
LSB = 2          # PCM tolerance against the reference, int16 steps
STATE_RTOL = 1e-5

# case -> the measured max |port - reference| PCM difference, int16 steps,
# where it exceeds LSB (witnesses; ROADMAP.md §3): the smoothing and
# interpol_freq=0 headers' streams (a 440 or 700 Hz tone over band noise)
# part by 4-7 steps, the tonal seeds 31 and 41 by 56-172 (there the
# reference itself is 45-50 dB from the float64 host decoder)
PARTS = {"stage_interpol0": 4, "stage_smooth": 5, "interpol0": 4,
         "mixed": 172, "smooth": 5, "smooth_split": 5, "smooth14": 7,
         "sticky41": 56, "restore_smooth": 5}
# (case, state key) -> the measured max |port - reference| of a carried
# state tensor over its largest magnitude, where it exceeds STATE_RTOL:
# the states that carry the HF band (the synthesis history and the
# smoothing trajectories); the core's (overlap, qa_hist, LPC tails) stay
# within 3e-7
STATE_PARTS = {("sbr3", "syn_hist"): 0.00011340381752233952,
               ("interpol0", "syn_hist"): 0.00026695182896219194,
               ("smooth", "g_hist"): 9.486063208896667e-05,
               ("smooth", "q_hist"): 0.0001574268244439736,
               ("smooth", "syn_hist"): 0.000352834933437407}

_SMOOTH = dict(start_freq=8, stop_freq=7, amp_res=0, xover_band=2,
               smoothing_mode=0)
_INTERPOL0 = dict(start_freq=8, stop_freq=7, amp_res=0, xover_band=2,
                  interpol_freq=0)
_MIXED1 = dict(start_freq=7, stop_freq=6, amp_res=0, xover_band=2)


# ---------------------------------------------------------------------------
# streams: the contents of tests/test_audio_batch.py, with fewer packets
# ---------------------------------------------------------------------------

def _encode(pcm, n, channels=2, sbr=True, pns=False, hdr=None, **kw):
    enc = HDCEncoder(channels=channels, sbr=sbr, pns=pns,
                     **({} if hdr is None else
                        {"sbr_header": JS.SbrHeader(**hdr)}), **kw)
    return [enc.encode_frame(pcm[k * 2048:(k + 1) * 2048]) for k in range(n)]


def _packets(n, seed=3, sbr=True, channels=2, transients=False):
    """tests/test_audio_batch.py:21-46."""
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
    return _encode(pcm, n, channels=channels, sbr=sbr)


def _band_noise(n, seed, tone, lo, hi, mod=False):
    """tests/test_audio_batch.py:225-232 (interpol_freq=0) and :316-324
    (smoothing: moving envelopes when ``mod``)."""
    rng = np.random.default_rng(seed)
    m = n * 2048
    t = np.arange(m) / FS
    s2 = rfft(rng.standard_normal(m))
    f = np.arange(len(s2)) * FS / m
    band = irfft(np.where((f > lo) & (f < hi), s2, 0), m)
    if mod:
        am = 0.55 + 0.45 * np.sin(2 * np.pi * 13.0 * t)
        sig = 0.3 * np.sin(2 * np.pi * tone * t) + 0.35 * band * am
    else:
        sig = 0.4 * np.sin(2 * np.pi * tone * t) + 0.1 * band
    return np.stack([sig, sig * 0.85], -1) * 0.7


def _transient_pcm(n, seed=77, late=False):
    """tests/test_audio_batch.py:414-433."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * 2048) / FS
    x = 0.04 * np.sin(2 * np.pi * 500 * t) \
        + 0.01 * rng.standard_normal(n * 2048)
    pos0 = 1500 if late else 700
    for k in range(2, n - 2, 3):
        pos = k * 2048 + pos0
        tt = np.arange(256)
        burst = (np.sin(2 * np.pi * 2400 * tt / FS)
                 + 0.5 * np.sin(2 * np.pi * 3500 * tt / FS + 1.0)) \
            * np.hanning(256)
        x[pos:pos + 256] += 0.7 * burst / np.abs(burst).max()
    np.clip(x, -1, 1, out=x)
    return np.stack([x, x * 0.9], -1)


def _pns(n):
    """tests/test_audio_batch.py:113-121."""
    rng = np.random.default_rng(2)
    t = np.arange(n * 2048) / FS
    pcm = (0.4 * np.sin(2 * np.pi * 500 * t)
           + 0.002 * rng.standard_normal(n * 2048)).reshape(-1, 1)
    return _encode(np.repeat(pcm, 2, axis=1), n, pns=True, floor_db=-40.0)


def _mixed1(n):
    """tests/test_audio_batch.py:248-257."""
    rng = np.random.default_rng(8)
    t = np.arange(n * 2048) / FS
    sig = 0.4 * np.sin(2 * np.pi * 520 * t) \
        + 0.05 * rng.standard_normal(n * 2048)
    return _encode(np.stack([sig, sig * 0.85], -1) * 0.7, n, hdr=_MIXED1)


@pytest.fixture(scope="module")
def streams():
    """Every stream of the module, encoded once."""
    return {
        "sbr3": _packets(6, seed=3), "sbr4": _packets(6, seed=4),
        "core": _packets(6, sbr=False),
        "short_mono": _packets(6, seed=5, channels=1, transients=True),
        "carry9": _packets(8, seed=9),
        "corrupt11": _packets(6, seed=11), "corrupt12": _packets(6, seed=12),
        "pns": _pns(6),
        "interpol0": _encode(_band_noise(6, 7, 700, 4000, 13000), 6,
                             hdr=_INTERPOL0),
        "mixed0": _packets(6, seed=31), "mixed1": _mixed1(6),
        "smooth": _encode(_band_noise(6, 6, 440, 6000, 13000, mod=True), 6,
                          hdr=_SMOOTH),
        "smooth14": _encode(_band_noise(6, 14, 440, 6000, 13000, mod=True),
                            6, hdr=_SMOOTH),
        "sticky41": _packets(6, seed=41),
        "tr_early": _encode(_transient_pcm(6), 6),
        "tr_late": _encode(_transient_pcm(6, late=True), 6),
        "tr_smooth": _encode(_transient_pcm(6, seed=31), 6, hdr=_SMOOTH),
    }


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _host(pkts):
    dec = HDCDecoder()
    return np.concatenate(
        [dec.decode(p).reshape(-1, 2) for p in pkts]).astype(np.float64)


def _snr(a, b):
    e = ((a - b) ** 2).sum()
    return 10 * np.log10((a ** 2).sum() / max(e, 1e-30))


def _hold(case, port, ref):
    """Port PCM against the reference's: within LSB, or exactly the
    witnessed difference."""
    d = int(np.abs(np.asarray(port, np.int64)
                   - np.asarray(ref, np.int64)).max())
    if case in PARTS:
        assert d == PARTS[case], (case, d)
    else:
        assert d <= LSB, (case, d)


def _both(n_programs):
    return (BatchedAudioDecoder(n_programs, device="cpu"),
            JB.BatchedAudioDecoder(n_programs))


def _decode(batches, n_programs, case):
    """Decode ``batches`` (each a list of per-program packet lists) with a
    port and a reference decoder; hold each batch's PCM; return the port's
    PCM of the batches concatenated along time."""
    port, ref = _both(n_programs)
    outs, refs = [], []
    for b in batches:
        got, want = port.decode(b), ref.decode(b)
        assert got.dtype == np.int16 and got.shape == want.shape
        outs.append(got)
        refs.append(want)
    out = np.concatenate(outs, axis=1)
    _hold(case, out, np.concatenate(refs, axis=1))
    return out


# ---------------------------------------------------------------------------
# the stage alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sbr3", "interpol0", "smooth"])
def test_stage_matches_reference(streams, case):
    """The port's plain device stage against the reference's
    ``_make_device_fn(...)(state, inp)`` on the reference decoder's own
    prepared inputs, from the state the reference carries after one batch:
    PCM and every carried state tensor (default header, interpol_freq=0,
    smoothing_mode=0).  The reference function runs jitted, as its decoder
    runs it."""
    pkts = streams[case]
    ref = JB.BatchedAudioDecoder(1)
    ref.decode([pkts[:3]])
    fn, inp, smooth, key = ref.prepare([pkts[3:]])
    ref._reconcile_state(smooth, key)
    state = {k: np.asarray(v) for k, v in ref._state.items()}
    hdr = ref._hdr
    assert smooth == (case == "smooth")
    assert bool(hdr.interpol_freq) == (case != "interpol0")
    dev_fn = JB._make_device_fn(
        ref._ft, JS.LIM_GAINS[hdr.limiter_gains],
        interpol=bool(hdr.interpol_freq), smooth=smooth,
        cap_long=ref._cap_long, cap_short=ref._cap_short)
    want_state, want = jax.jit(dev_fn)(
        {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in inp.items()})
    ft = TS.derive_tables(TS.SbrHeader(**{
        f: getattr(hdr, f) for f in BatchedAudioDecoder._HDR_FIELDS}))
    stage = TST.DeviceStage(ft, TS.LIM_GAINS[hdr.limiter_gains],
                            interpol=bool(hdr.interpol_freq), smooth=smooth,
                            cap_long=ref._cap_long, cap_short=ref._cap_short,
                            device="cpu")
    got_state, got = stage({k: torch.from_numpy(v.copy())
                            for k, v in state.items()},
                           device_inputs(inp, "cpu"))
    _hold(f"stage_{case}", got.numpy(),
          np.asarray(want).reshape(got.shape))
    assert sorted(got_state) == sorted(want_state)
    for k, w in want_state.items():
        w = np.asarray(w)
        rel = float(np.abs(got_state[k].numpy() - w).max()
                    / max(np.abs(w).max(), 1.0))
        if (case, k) in STATE_PARTS:
            assert rel == pytest.approx(STATE_PARTS[case, k], rel=1e-6), \
                (k, rel)
        else:
            assert rel <= STATE_RTOL, (k, rel)


# ---------------------------------------------------------------------------
# twins of tests/test_audio_batch.py's BatchedAudioDecoder cases
# ---------------------------------------------------------------------------

def test_batch_matches_host_sbr(streams):
    """:60 — two SBR programs in one batch; each > 60 dB against the host
    decoder from packet 2 on."""
    pk = [streams["sbr3"], streams["sbr4"]]
    out = _decode([pk], 2, "sbr_pair").astype(np.float64)
    for p in range(2):
        assert _snr(_host(pk[p])[2 * 2048:], out[p, 2 * 2048:]) > 60.0


def test_batch_matches_host_core_only(streams):
    """:71 — no SBR payload (upsample-only); > 60 dB."""
    pk = streams["core"]
    out = _decode([[pk]], 1, "core").astype(np.float64)[0]
    assert _snr(_host(pk)[2 * 2048:], out[2 * 2048:]) > 60.0


def test_batch_short_windows_and_mono(streams):
    """:79 — EIGHT_SHORT windows and a mono program mirrored into both
    lanes; > 55 dB."""
    pk = streams["short_mono"]
    out = _decode([[pk]], 1, "short_mono").astype(np.float64)[0]
    assert _snr(_host(pk)[2 * 2048:], out[2 * 2048:]) > 55.0


def test_batch_streaming_state_carry(streams):
    """:87 — two K=4 calls equal one K=8 call within 1 LSB (the
    reference's bound: int16 rounding of float32 ties)."""
    pk = streams["carry9"]
    one = _decode([[pk]], 1, "carry9").astype(np.int64)[0]
    two = _decode([[pk[:4]], [pk[4:]]], 1, "carry9_split").astype(
        np.int64)[0]
    assert np.abs(one - two).max() <= 1


def test_batch_corrupt_packet_isolated(streams):
    """:97 — a corrupted packet of program 0 leaves program 1 > 60 dB."""
    good = [streams["corrupt11"], streams["corrupt12"]]
    bad = [list(g) for g in good]
    pkt = bytearray(bad[0][3])
    pkt[len(pkt) // 2] ^= 0xFF
    bad[0][3] = bytes(pkt)
    out = _decode([bad], 2, "corrupt")
    assert _snr(_host(good[1])[2 * 2048:],
                out[1, 2 * 2048:].astype(np.float64)) > 60.0


def test_batch_pns_no_crash(streams):
    """:112 — the PNS stream decodes, non-silent."""
    out = _decode([[streams["pns"]]], 1, "pns")
    assert out.shape == (1, 6 * 2048, 2)
    assert np.abs(out[0, 4096:]).max() > 100


def test_batch_interpol_freq_off(streams):
    """:218 — bs_interpol_freq=0 runs the per-band averaged gains; > 55
    dB."""
    pk = streams["interpol0"]
    out = _decode([[pk]], 1, "interpol0").astype(np.float64)[0]
    assert _snr(_host(pk)[2 * 2048:], out[2 * 2048:]) > 55.0


def test_batch_mixed_headers_fallback(streams):
    """:241 — two SBR headers in one batch: the batch header's program
    decodes > 45 dB (the reference's bound for this seed), the other falls
    back to zeroed HF and stays audible."""
    pk = [streams["mixed0"], streams["mixed1"]]
    out = _decode([pk], 2, "mixed").astype(np.float64)
    assert np.isfinite(out).all()
    assert _snr(_host(pk[0])[2 * 2048:], out[0, 2 * 2048:]) > 45.0
    assert np.abs(out[1, 4 * 2048:]).max() > 1000


def test_batch_smoothing_mode(streams):
    """:306 — bs_smoothing_mode=0: > 55 dB against the host, and a 3 + 3
    split within 8 LSB of one call (the reference's bound: its K=5 and
    K=10 stages sum the 5-tap filter in other tilings)."""
    pk = streams["smooth"]
    one = _decode([[pk]], 1, "smooth")[0]
    assert _snr(_host(pk)[2 * 2048:],
                one[2 * 2048:].astype(np.float64)) > 55.0
    two = _decode([[pk[:3]], [pk[3:]]], 1, "smooth_split")[0]
    assert np.abs(one.astype(np.int64) - two.astype(np.int64)).max() <= 8


def test_batch_smoothing_checkpoint_resume(streams, tmp_path):
    """:341 — the smoothing trajectories survive checkpoint/restore through
    an npz file: the split decode within 8 LSB of an uninterrupted one."""
    pk = streams["smooth14"]
    one = _decode([[pk]], 1, "smooth14").astype(np.int64)[0]
    a = BatchedAudioDecoder(1, device="cpu")
    first = a.decode([pk[:3]])[0]
    path = str(tmp_path / "smooth.npz")
    np.savez(path, **a.checkpoint())
    b = BatchedAudioDecoder(1, device="cpu")
    b.restore(np.load(path))
    second = b.decode([pk[3:]])[0]
    two = np.concatenate([first, second]).astype(np.int64)
    assert np.abs(one - two).max() <= 8
    assert "dev_g_hist" in a.checkpoint()


def test_batch_all_corrupt_keeps_sticky_header(streams):
    """:374 — an all-corrupt batch keeps the sticky header and stage; only
    the ring-out of the last good packet remains."""
    pk = streams["sticky41"]
    port, ref = _both(1)
    outs, refs = [], []
    for batch in ([pk[:3]], [[b""] * 3], [pk[3:]]):
        outs.append(port.decode(batch))
        refs.append(ref.decode(batch))
        if batch[0][0] == b"":
            assert np.abs(outs[-1][0, 2 * 2048:]).max() == 0
            assert port._hdr == hdr and port._fn is fn, "header/stage flapped"
        hdr, fn = port._hdr, port._fn
    assert port._fn is fn
    _hold("sticky41", np.concatenate(outs, 1), np.concatenate(refs, 1))


@pytest.mark.parametrize("late", [False, True])
def test_batch_transient_sbr_grids(streams, late):
    """:437 — transient frames carry 2-envelope variable SBR grids (VARFIX
    early, FIXVAR late) with l_A; > 55 dB."""
    pk = streams["tr_late" if late else "tr_early"]
    dec = HDCDecoder()
    classes = set()
    for p in pk:
        _, _, sd = dec.parse(p)
        if sd:
            for ch, d in enumerate(sd):
                dec._sbr[ch].prev_env = d.env[-1]
                dec._sbr[ch].prev_noise = d.noise[-1]
            classes.add((sd[0].frame_class, sd[0].n_env, sd[0].la))
    assert ((1, 2, 1) if late else (2, 2, 1)) in classes, classes
    case = "tr_late" if late else "tr_early"
    out = _decode([[pk]], 1, case).astype(np.float64)[0]
    assert _snr(_host(pk)[2 * 2048:], out[2 * 2048:]) > 55.0


def test_batch_smoothing_transient_bypass(streams):
    """:465 — smoothing with transient grids: the filter bypasses the l_A
    envelope as on the host; > 55 dB."""
    pk = streams["tr_smooth"]
    out = _decode([[pk]], 1, "tr_smooth").astype(np.float64)[0]
    assert _snr(_host(pk)[2 * 2048:], out[2 * 2048:]) > 55.0


# ---------------------------------------------------------------------------
# state carried across from JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sbr3", "smooth"])
def test_restore_jax_checkpoint(streams, case):
    """A JAX decoder decodes packets 0-2 and checkpoints (numpy arrays and
    JSON bytes); a fresh port decoder restores that and decodes 3-5: equal
    to the JAX decoder's uninterrupted 3-5.  The port's own checkpoint
    restores into a JAX decoder too."""
    pk = streams[case]
    ref = JB.BatchedAudioDecoder(1)
    ref.decode([pk[:3]])
    snap = {k: np.array(v) for k, v in ref.checkpoint().items()}
    want = ref.decode([pk[3:]])
    port = BatchedAudioDecoder(1, device="cpu")
    port.restore(snap)
    got = port.decode([pk[3:]])
    _hold(f"restore_{case}", got, want)
    back = JB.BatchedAudioDecoder(1)
    back.restore(port.checkpoint())
    assert back._state["overlap"].shape == (2, 1024)
    assert sorted(port.checkpoint()) == sorted(ref.checkpoint())


def test_decoder_inputs_match_reference(streams):
    """prepare() builds exactly the reference's device inputs, batch after
    batch (host bookkeeping: chirp, noise index, window shapes, harmonics,
    transient carry)."""
    pk = [streams["tr_smooth"], streams["short_mono"]]
    port, ref = _both(2)
    for lo in (0, 3):
        batch = [p[lo:lo + 3] for p in pk]
        got, want = port.prepare(batch), ref.prepare(batch)
        assert got[2:] == want[2:]
        assert sorted(got[1]) == sorted(want[1])
        for k, v in want[1].items():
            assert got[1][k].dtype == v.dtype, k
            assert np.array_equal(got[1][k], v), k
        port.dispatch(got)
        ref.dispatch(want)
