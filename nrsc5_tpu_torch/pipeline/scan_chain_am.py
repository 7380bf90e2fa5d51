"""The fused steady-state AM receive chain on complex64, and the geometry
helpers of the AM chains.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain_am.py``: once
block-synced, the AM per-frame control flow is fixed, so 8 blocks of
acquire, sync and demap plus the frame's deinterleave, diversity delay,
Viterbi and descramble become one step with the (offset, acquire phase,
clock feedback, diversity delay lines) carry.

The reference's ``vmap`` over stations is the batch dimension and its
``lax.scan`` a loop (:func:`scan_blocks_am_c`) of two kernels a block for
all stations at once, K19 (:func:`~nrsc5_tpu_torch.ops.acquire.
demod_am_c`, both demodulation passes with their FFTs) and K20
(:func:`~nrsc5_tpu_torch.ops.sync_am.sync_am_c`, which also takes the
loop's carry step); the frames then decode flat-batched over stations ×
frames through :func:`~nrsc5_tpu_torch.pipeline.scan_chain_am_rc.
am_decode` (K15, K7 at K=9 and K8).  One station is the same path at
S = 1.  On the CPU every kernel wrapper takes its plain version (the
complex ops of :mod:`nrsc5_tpu_torch.ops.acquire` and
:mod:`nrsc5_tpu_torch.ops.sync_am`, looped over the stations);
``plain=True`` takes the block step's plain versions on a card too.  A block
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
from nrsc5_tpu_torch.ops.acquire import (AcquireState, acquire_init_state,
                                         demod_am_c, demod_am_c_plain)
from nrsc5_tpu_torch.ops.decode_am import DD, AMDecodeState
from nrsc5_tpu_torch.ops.sync_am import (sync_am_c, sync_am_c_plain,
                                         sync_am_c_shapes)
from nrsc5_tpu_torch.pipeline.block_graph import run_into, station_major
from nrsc5_tpu_torch.pipeline.scan_chain import _first, _one

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


def scan_blocks_am_c(samples: torch.Tensor, carries: AMChainCarry,
                     n_blocks: int, ma3: bool = False, plain: bool = False):
    """The AM block loop for every station at once: samples [S,
    N] complex64, carries stacked along a leading station axis.  Each block
    runs K19 (its spectra, phase, angle and keep into reused buffers) and
    K20 (its codes and PIDS codes straight into slot b of block-major
    buffers, then the carry step: the offset, and the next K19's symbol
    timing from this block's samperr).  ``plain`` runs the kernels' plain
    versions instead.  Returns (codes uint8 [S, n_blocks, 4, 800], pids
    codes uint8 [S, n_blocks, 32, 2], new carries with the delay lines
    untouched)."""
    s, dev = samples.shape[0], samples.device
    shapes = sync_am_c_shapes(s)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    codes = empty((n_blocks,) + shapes["codes"][0], torch.uint8)
    pids = empty((n_blocks,) + shapes["pids"][0], torch.uint8)
    ref_bits = empty(*shapes["ref_bits"])
    offset = carries.offset.clone()
    samperr_fb = carries.samperr_fb.clone()
    samperr = (C.FFTCP_AM // 2 + carries.samperr_fb).to(torch.int32)
    # ping-pong pairs: block b reads [b % 2] and writes [(b + 1) % 2]
    phase = (carries.acq.phase.clone(), empty((s,), torch.complex64))
    prev_angle = (carries.acq.prev_angle.clone(), empty((s,)))
    spectra = empty((s, C.BLKSZ, C.FFT_AM), torch.complex64)
    mag_sums = empty((s, C.FFT_AM))
    keep = empty((s,), torch.int32)
    cfo = torch.zeros(s, dtype=torch.int32, device=dev)
    for b in range(n_blocks):
        i, j = b % 2, (b + 1) % 2
        run_into(demod_am_c, demod_am_c_plain, plain,
                 (samples, offset, phase[i], samperr, prev_angle[i], cfo),
                 (spectra, mag_sums, phase[j], prev_angle[j], keep))
        run_into(sync_am_c, sync_am_c_plain, plain,
                 (spectra, ma3, (keep, offset, samperr)),
                 {"codes": codes[b], "pids": pids[b], "ref_bits": ref_bits,
                  "samperr": samperr_fb})
    last = n_blocks % 2
    return (station_major(codes), station_major(pids), carries._replace(
        offset=offset, samperr_fb=samperr_fb,
        acq=AcquireState(phase=phase[last], prev_angle=prev_angle[last])))


def am_chain_scan(samples: torch.Tensor, carry: AMChainCarry,
                  n_frames: int, ma3: bool = False, plain: bool = False):
    """Decode ``n_frames`` AM frames in steady state: :func:`am_chain_batch`
    at one station.

    samples: [am_buffer_len(n_frames)] complex64 at 46511.7 S/s, the first
    symbol FFTCP_AM//2 in, the first block bc 0.  Returns (dict with p1
    [F, 8, 3750], p3 [F, p3_len], pids [F*8, 80], p1_margin [F, 8],
    p3_margin [F]; new carry).  P1 and P3 of the first min(3, F) frames are
    the diversity warm-up and not valid."""
    out, cy = am_chain_batch(samples[None], _one(carry), n_frames, ma3, plain)
    return _first(out), _first(cy)


def am_chain_batch(samples: torch.Tensor, carries: AMChainCarry,
                   n_frames: int, ma3: bool = False, plain: bool = False):
    """Several stations (the reference's ``vmap``), carries stacked along a
    leading station axis: every station at once, :func:`scan_blocks_am_c`
    then the flat-batched decode.  ``plain`` runs the block step's plain
    versions (the decode as always)."""
    # (scan_chain_am_rc imports this module)
    from nrsc5_tpu_torch.pipeline.scan_chain_am_rc import am_decode
    codes, pids, cy = scan_blocks_am_c(samples, carries,
                                       n_frames * C.P1_AM_BLOCKS, ma3, plain)
    return am_decode(codes, pids, cy, carries, n_frames, ma3)
