"""The port's per-block FM receiver against the JAX package's in MP11,
the widest FM mode: the twin of tests/test_l1_fm.py:128 (P1 with PX1 and
PX2), held to JAX's frame for frame and event for event
(tests/block_twins.py's tolerances), with the JAX test's own assertions
on the port's output (the recipe: tests/test_torch_block_l1_px.py)."""

import pytest

from nrsc5_tpu import constants as C

from . import block_twins as BT
from .test_torch_block_l1_px import _missing, _px_capture, _twin

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


def test_fm_mp11_px1_px2_roundtrip(rng):
    """The twin of tests/test_l1_fm.py:128: every P3 and P4 frame of IV
    cycle 1 decodes."""
    sig, p3, p4 = _px_capture(rng, 11, C.P3_FRAME_LEN_MP3_MP11, 2,
                              px2=True)
    col = _twin(sig)
    assert ("sync", {"psmi": 11}) in col.events
    assert _missing(col, 1, p3[1]) == 0
    assert _missing(col, 2, p4[1]) == 0
