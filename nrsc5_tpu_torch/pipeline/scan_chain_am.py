"""Geometry helpers of the fused AM chain.

Counterpart of ``SLACK_AM`` and ``am_buffer_len`` of
``nrsc5_tpu/pipeline/scan_chain_am.py`` (lines 25, 44; pinned equal by
tests/test_torch_tables.py): a block consumes ``32·FFTCP_AM + samperr``
samples, so the caller provides ``SLACK_AM`` extra samples of headroom
for the offset walk.
"""

from __future__ import annotations

from nrsc5_tpu_torch import constants as C

SLACK_AM = C.FFTCP_AM


def am_buffer_len(n_frames: int) -> int:
    """Sample-buffer length the AM chain expects for ``n_frames`` frames."""
    return n_frames * 8 * C.BLKSZ * C.FFTCP_AM + C.FFTCP_AM + SLACK_AM
