"""The port's native HDC parse (``nrsc5_hdc_spectral``, ``nrsc5_hdc_ics``
bound in ``nrsc5_tpu_torch/native``) against its pure-Python parse: twins
of tests/test_hdc_codec.py:529 and :570 on the port's own encoder and
decoder, and the parse equal to the JAX package's on the same packets."""

import numpy as np
import pytest

import nrsc5_tpu_torch.audio.hdc_decoder as hd
from nrsc5_tpu_torch import native
from nrsc5_tpu_torch.audio.hdc_decoder import HDCDecoder
from nrsc5_tpu_torch.tx.hdc_encoder import HDCEncoder

from .test_hdc_codec import _music_like

N = 2048


@pytest.fixture(autouse=True)
def _library():
    if native.get_lib() is None:
        pytest.skip("no host compiler built the native library")


def _flip(packets, rng, flips, lo):
    out = []
    for p in packets:
        b = bytearray(p)
        for _ in range(flips):
            i = int(rng.integers(lo, len(b)))
            b[i] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    return out


def _with_native(use, fn):
    saved = hd._native
    hd._native = native if use else None
    try:
        return fn()
    finally:
        hd._native = saved


def test_native_spectral_parser_matches_python(rng):
    """Twin of test_hdc_codec.py:529: clean packets and packets with bit
    flips decode to the same PCM (or to the same rejection) with the
    native parse as with the Python one."""
    x = _music_like(10 * N, rng)
    stereo = np.stack([x, 0.6 * x], axis=-1)
    enc = HDCEncoder(2)
    pkts = [enc.encode_frame(stereo[f * N:(f + 1) * N]) for f in range(10)]
    cases = pkts + _flip(pkts, rng, 3, 8)

    def run():
        dec = HDCDecoder()
        out = []
        for p in cases:
            r = dec.decode(p)
            out.append(None if r is None else r.tobytes())
        return out

    a, b = _with_native(True, run), _with_native(False, run)
    assert a == b, [i for i, (u, v) in enumerate(zip(a, b)) if u != v]


def _ics_cases(rng):
    x = _music_like(16 * N, rng)
    for k in (3, 9):  # transient bursts force EIGHT_SHORT frames
        x[k * N + 500:k * N + 900] += 0.5 * np.hanning(400) * rng.normal(
            size=400)
    d = 0.1 * _music_like(16 * N, rng, lp_hz=800.0)
    stereo = np.stack([x + d, x - d], axis=-1)
    enc = HDCEncoder(2, pns=True, intensity=True, ms=True)
    cases = [enc.encode_frame(stereo[f * N:(f + 1) * N]) for f in range(16)]
    encm = HDCEncoder(1, pns=True)
    cases += [encm.encode_frame(x[f * N:(f + 1) * N, None])
              for f in range(8)]
    return cases + _flip(cases[:12], rng, 4, 4)


def _parse_all(decoder_cls, cases):
    dec = decoder_cls()
    out = []
    for p in cases:
        try:
            specs, ics1, _ = dec.parse(p)
            out.append(([s.tobytes() for s in specs],
                        None if ics1.sfb_cb is None
                        else np.asarray(ics1.sfb_cb, np.int64).tobytes(),
                        None if ics1.scale_factors is None
                        else np.asarray(ics1.scale_factors,
                                        np.int64).tobytes()))
        except Exception as e:  # noqa: BLE001
            out.append(("raised", type(e).__name__,
                        isinstance(e, ValueError)))
    return out


def test_native_ics_matches_python(rng):
    """Twin of test_hdc_codec.py:570: the one-call ICS parse gives the
    Python parse's spectra, codebooks and scale factors on every codebook
    family (PNS, intensity, M/S, short windows, mono), and on corrupt
    packets the same rejection, an ``HDCError`` (a ValueError; the native
    parse's message is a generic one, as in the reference)."""
    cases = _ics_cases(rng)
    a = _with_native(True, lambda: _parse_all(HDCDecoder, cases))
    b = _with_native(False, lambda: _parse_all(HDCDecoder, cases))
    bad = [i for i, (u, v) in enumerate(zip(a, b)) if u != v]
    assert not bad, bad
    assert any(r[0] == "raised" for r in a)
    assert all(r[2] for r in a if r[0] == "raised")


def test_native_parse_matches_jax_package(rng):
    """The port's native parse gives the JAX package's parse (its own
    native path) on the same packets, the corrupt ones included."""
    from nrsc5_tpu.audio.hdc_decoder import HDCDecoder as JaxDecoder
    cases = _ics_cases(rng)
    got = _with_native(True, lambda: _parse_all(HDCDecoder, cases))
    want = _parse_all(JaxDecoder, cases)
    assert got == want


def test_native_errors_are_value_errors():
    """A corrupt codeword raises ValueError from both bindings, as the
    pure-Python parse's callers expect."""
    from nrsc5_tpu_torch.audio import aac_core as A
    with pytest.raises(ValueError):
        native.hdc_spectral(b"\xff" * 4, 0, A.ESC_HCB, 64)
    with pytest.raises(ValueError):
        native.hdc_ics(b"\xff" * 8, 0, False, A.num_swb(False), [1],
                       A.swb_offsets(False))
