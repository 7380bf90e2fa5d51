"""The port's copies of the JAX package's channel impairments
(``tx/channel.py``: ``clock_drift``, ``from_cu8``, ``fading``) and of its
libavcodec oracle (``audio/oracle.py``, ``native/aac_oracle.cpp``) equal
their originals: the same arrays from the same seeded inputs, the same
source byte for byte.  The oracle's decode needs libavcodec, which the
test machines lack; its test skips there, as the reference's do
(tests/test_hdc_external_oracle.py:33)."""

from pathlib import Path

import numpy as np
import pytest

from nrsc5_tpu.audio import oracle as JOR
from nrsc5_tpu.tx import channel as JCH
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.audio import oracle as TOR
from nrsc5_tpu_torch.tx import channel as TCH

REPO = Path(__file__).resolve().parents[1]


def _sig(seed: int, n: int = 20000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64) * 0.3


@pytest.mark.parametrize("ppm", [0.0, 50.0, -50.0, 333.3])
def test_clock_drift_equal(ppm):
    sig = _sig(1)
    got, want = TCH.clock_drift(sig, ppm), JCH.clock_drift(sig, ppm)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_from_cu8_equal():
    data = np.random.default_rng(2).integers(0, 256, 4096).astype(np.uint8)
    got, want = TCH.from_cu8(data), JCH.from_cu8(data)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    # the round trip through the cu8 wire of both copies
    np.testing.assert_array_equal(TCH.to_cu8(got), JCH.to_cu8(want))


@pytest.mark.parametrize("doppler,delays,amps,rate", [
    (5.0, (0,), (1.0,), C.SAMPLE_RATE_CS16_FM),
    (40.0, (0, 7, 31), (1.0, 0.5, 0.25), C.SAMPLE_RATE_CS16_FM),
    (2.0, (0, 3), (0.8, 0.6), C.SAMPLE_RATE_CS16_AM)])
def test_fading_equal(doppler, delays, amps, rate):
    """Flat and multi-tap fading from the same seed, at the FM and AM
    rates."""
    sig = _sig(3)
    got = TCH.fading(sig, doppler, delays, amps,
                     np.random.default_rng(4), rate)
    want = JCH.fading(sig, doppler, delays, amps,
                      np.random.default_rng(4), rate)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_fading_default_rng_equal():
    sig = _sig(5, 4000)
    np.testing.assert_array_equal(TCH.fading(sig, 10.0),
                                  JCH.fading(sig, 10.0))


def test_aac_oracle_source_equal():
    assert (REPO / "nrsc5_tpu_torch/native/aac_oracle.cpp").read_bytes() \
        == (REPO / "nrsc5_tpu/native/aac_oracle.cpp").read_bytes()


def test_aac_oracle_builds_outside_the_tree():
    """The library builds into the gitignored build/native/ at the root,
    under a name that carries the source's hash."""
    path = TOR.library_path()
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libaac_oracle-")
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_aac_oracle_decode_matches():
    """Where libavcodec is present: the port's oracle decodes an HE-AAC
    ADTS stream of the port's encoder to the reference oracle's PCM."""
    if TOR.available() != JOR.available():
        pytest.fail("the two oracles disagree on libavcodec")
    if not TOR.available():
        pytest.skip("libavcodec oracle unavailable")
    from nrsc5_tpu_torch.tx.hdc_encoder import HDCEncoder
    t = np.arange(4 * 2048) / 44100.0
    pcm = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                    0.2 * np.sin(2 * np.pi * 660 * t)], -1)
    enc = HDCEncoder(channels=2, sbr=True)
    adts = b"".join(enc.encode_frame_dual(pcm[k * 2048:(k + 1) * 2048])[1]
                    for k in range(4))
    got, rate = TOR.decode_adts(adts)
    want, want_rate = JOR.decode_adts(adts)
    assert rate == want_rate
    np.testing.assert_array_equal(got, want)
