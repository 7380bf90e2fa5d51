"""The port's per-block FM receiver against the JAX package's when it
locks mid-cycle of the interleaver-IV: the twin of
tests/test_l1_fm.py:228, held to JAX's frame for frame and event for
event (tests/block_twins.py's tolerances), with the JAX test's own
assertions on the port's output (the recipe:
tests/test_torch_block_l1_px.py)."""

import pytest

from nrsc5_tpu import constants as C

from . import block_twins as BT
from .test_torch_block_l1_px import _missing, _px_capture, _twin

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


def test_fm_mp3_iv_midcycle_lock(rng):
    """One junk P1 frame ahead of the PX cycles puts the bc == 0 anchor
    half an IV cycle off the transmitter; every P3 frame of cycles 1 and 2
    still decodes, only relabelled."""
    sig, p3, _ = _px_capture(rng, 3, C.P3_FRAME_LEN_MP3_MP11, 3, filler=1,
                             junk=True)
    col = _twin(sig)
    assert ("sync", {"psmi": 3}) in col.events
    for cyc in (1, 2):
        assert _missing(col, 1, p3[cyc]) == 0, cyc
