"""Geometry helpers of the fused FM chain.

Counterpart of the helpers of ``nrsc5_tpu/pipeline/scan_chain.py``
(``SLACK``, ``buffer_len``, ``px_frame_lens``).  The chain reads blocks at a
bounded offset walk inside a fixed-size buffer: in FINE state a block
consumes ``32·FFTCP + samperr_fb`` samples, so the caller provides ``SLACK``
extra samples of headroom (reference: src/acquire.c:259-262).
"""

from __future__ import annotations

from nrsc5_tpu_torch import constants as C

SLACK = C.FFTCP_FM  # offset headroom for clock drift over a scan


def px_frame_lens(psmi: int) -> tuple[int, int]:
    """(px1 frame_len, px2 frame_len) in bits; 0 = channel absent
    (reference service-mode map: src/sync.c:30-35,339-357)."""
    cm = C.COMPATIBILITY_MODE[psmi]
    px1 = {2: C.P3_FRAME_LEN_MP2, 3: C.P3_FRAME_LEN_MP3_MP11,
           11: C.P3_FRAME_LEN_MP3_MP11}.get(cm, 0)
    px2 = C.P3_FRAME_LEN_MP3_MP11 if cm == 11 else 0
    return px1, px2


def buffer_len(n_blocks: int) -> int:
    """Sample-buffer length the scan expects for ``n_blocks`` blocks."""
    return n_blocks * C.BLKSZ * C.FFTCP_FM + C.FFTCP_FM + SLACK
