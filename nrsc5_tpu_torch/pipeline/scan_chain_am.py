"""The fused steady-state AM receive chain on complex64, and the geometry
helpers of the AM chains.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain_am.py``: once
block-synced, the AM per-frame control flow is fixed, so 8 blocks of
acquire, sync and demap plus the frame's deinterleave, diversity delay,
Viterbi and descramble become one step with the (offset, acquire phase,
clock feedback, diversity delay lines) carry.  The reference's
``lax.scan`` steps are Python loops of the complex ops
(:mod:`nrsc5_tpu_torch.ops.acquire`, :mod:`nrsc5_tpu_torch.ops.sync_am`);
the frame decodes through :func:`~nrsc5_tpu_torch.ops.decode_am.
am_frame_decode` (K15, K7 at K=9 and K8 on a card) and PIDS through
:func:`~nrsc5_tpu_torch.ops.decode_am.am_pids_decode` (K15's PIDS-only
launch, K7 at K=9 and K8); its ``vmap`` over stations is a loop.  A block
consumes ``32·FFTCP_AM + samperr`` samples, so the caller provides
``SLACK_AM`` extra samples of headroom (``SLACK_AM`` and
:func:`am_buffer_len` pinned equal to the reference's by
tests/test_torch_tables.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops.acquire import (WINDOW_AM, AcquireState,
                                         acquire_am_fine, acquire_init_state)
from nrsc5_tpu_torch.ops.decode_am import (DD, AMDecodeState,
                                           am_frame_decode, am_pids_decode)
from nrsc5_tpu_torch.ops.sync_am import sync_am_block
from nrsc5_tpu_torch.pipeline.scan_chain import (_stack_outputs, _window,
                                                 index_tree, stack_trees)

SLACK_AM = C.FFTCP_AM


def am_buffer_len(n_frames: int) -> int:
    """Sample-buffer length the AM chain expects for ``n_frames`` frames."""
    return n_frames * 8 * C.BLKSZ * C.FFTCP_AM + C.FFTCP_AM + SLACK_AM


class AMChainCarry(NamedTuple):
    offset: torch.Tensor  # int32 read position
    acq: AcquireState
    samperr_fb: torch.Tensor  # int32
    dec: AMDecodeState  # delay lines of [54000] uint8


def am_chain_init_carry(offset: int = 0, *, device="cuda") -> AMChainCarry:
    dev = K.resolve_device(device)
    return AMChainCarry(
        offset=torch.tensor(offset, dtype=torch.int32, device=dev),
        acq=acquire_init_state(device=dev),
        samperr_fb=torch.zeros((), dtype=torch.int32, device=dev),
        dec=AMDecodeState(*(torch.zeros(DD, dtype=torch.uint8, device=dev)
                            for _ in AMDecodeState._fields)))


def am_chain_scan(samples: torch.Tensor, carry: AMChainCarry,
                  n_frames: int, ma3: bool = False):
    """Decode ``n_frames`` AM frames in steady state.

    samples: [am_buffer_len(n_frames)] complex64 at 46511.7 S/s, the first
    symbol FFTCP_AM//2 in, the first block bc 0.  Returns (dict with p1
    [F, 8, 3750], p3 [F, p3_len], pids [F*8, 80], p1_margin [F, 8],
    p3_margin [F]; new carry).  P1 and P3 of the first min(3, F) frames are
    the diversity warm-up and not valid."""
    zero = torch.zeros((), dtype=torch.int32, device=samples.device)
    cy = carry
    frames = []
    for _ in range(n_frames):
        offset, acq, samperr_fb = cy.offset, cy.acq, cy.samperr_fb
        outs = []
        for _ in range(8):
            window = _window(samples, offset, WINDOW_AM)
            spectra, acq, _, keep, _ = acquire_am_fine(window, acq,
                                                       samperr_fb, zero)
            out = sync_am_block(spectra, ma3)
            offset = (offset + WINDOW_AM - keep).to(torch.int32)
            samperr_fb = out["samperr"]
            outs.append(out)
        mats = [torch.cat([o[k] for o in outs]) for k in ("pl", "pu", "s",
                                                          "t")]
        p1, p3, margins, dec = am_frame_decode(*mats, cy.dec, ma3)
        pids = am_pids_decode(torch.stack([o["pids"] for o in outs]))
        cy = AMChainCarry(offset=offset, acq=acq, samperr_fb=samperr_fb,
                          dec=dec)
        frames.append({"p1": p1, "p3": p3, "pids": pids,
                       "p1_margin": margins["p1"],
                       "p3_margin": margins["p3"]})
    out = _stack_outputs(frames)
    out["pids"] = out["pids"].reshape(-1, C.PIDS_FRAME_LEN)
    return out, cy


def am_chain_batch(samples: torch.Tensor, carries: AMChainCarry,
                   n_frames: int, ma3: bool = False):
    """Several stations: :func:`am_chain_scan` for each (the reference's
    ``vmap``), carries stacked along a leading station axis."""
    results = [am_chain_scan(samples[i], index_tree(carries, i), n_frames,
                             ma3) for i in range(samples.shape[0])]
    return (_stack_outputs([r[0] for r in results]),
            stack_trees([r[1] for r in results]))
