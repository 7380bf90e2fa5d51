"""Input front end: cu8 ingest + FM ÷2 and AM ÷32 halfband cascades.

PyTorch counterpart of ``nrsc5_tpu/ops/frontend.py``: its complex half
(``FrontendState``, ``frontend_init_state``, ``cu8_to_cf``,
``_halfband``, ``fm_decimate``, ``am_decimate``, ``decimate_batch``;
lines 40-117), which the per-block receivers run as plain PyTorch on
complex64 tensors with carried overlap-save tails, and its rc half
(``halfband_rc``, ``rc_overlap``, ``decimate_overlap_rc``, ``AM_STAGES``)
with the cu8 ingest in ``nrsc5_tpu/serve.py`` (``ingest``, lines
308-324).  The halfband impulse response is built from the 4 designed
taps (reference: src/input.c:26-39): h = [t3 0 t2 0 t1 0 t0 1 t0 0 t1 0
t2 0 t3] / 2.

:func:`ingest_fm_cu8` is kernel K1 (``csrc/halfband_cu8.cu``): cu8 bytes to
the decimated FM chain input in one pass.  :func:`ingest_am_cu8` is K1's AM
cascade (``csrc/am_decimate_cu8.cu``): cu8 bytes, the reference's extra
1/16, then five ÷2 stages to the 46511.7 S/s AM chain input, fused.  Their
plain PyTorch versions, :func:`ingest_fm_cu8_plain` and
:func:`ingest_am_cu8_plain`, are built from :func:`cu8_to_rc` and
:func:`decimate_overlap_rc`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K

HB_NTAPS = 15
AM_STAGES = 5  # the AM cascade: 1.488 MS/s -> 46511.7 S/s
# cu8 LSB in float units (reference: src/defines.h:92-93); a float32
# constant, as the reference's weakly typed Python float becomes
CU8_SCALE = 64.0 / 32767.0


@functools.lru_cache(maxsize=1)
def halfband_taps() -> np.ndarray:
    t = np.asarray(C.DECIM_TAPS, np.float32)
    h = np.zeros(HB_NTAPS, np.float32)
    h[0:7:2] = t[::-1]  # t3 t2 t1 t0 at 0,2,4,6
    h[7] = 1.0
    h[8:15:2] = t  # t0 t1 t2 t3 at 8,10,12,14
    return h / 2.0


class FrontendState(NamedTuple):
    """Carried overlap-save tails, one per halfband stage."""
    tails: tuple  # of [..., HB_NTAPS-1] complex64


def frontend_init_state(stages: int = 1, *, device="cuda") -> FrontendState:
    """Zero tails for a ``stages``-deep cascade on ``device``."""
    dev = K.resolve_device(device)
    return FrontendState(tails=tuple(
        torch.zeros(HB_NTAPS - 1, dtype=torch.complex64, device=dev)
        for _ in range(stages)))


def cu8_to_cf(data: torch.Tensor) -> torch.Tensor:
    """Interleaved cu8 -> complex64, the reference's U8_Q15 scaling (value
    127 = zero, LSB = 64/32767; reference: src/defines.h:92-93)."""
    f = (data.float() - 127.0) * CU8_SCALE
    return torch.complex(f[0::2], f[1::2])


def _halfband(x: torch.Tensor, tail: torch.Tensor):
    """One ÷2 halfband stage with overlap-save on complex samples.
    x: [..., N] (N even), tail [..., 14] -> (y [..., N//2], new tail).
    The same polyphase sum as :func:`halfband_rc`, in the same order."""
    h = halfband_taps()
    xx = torch.cat([tail, x], dim=-1)
    n_out = x.shape[-1] // 2
    xe, xo = xx[..., 0::2], xx[..., 1::2]
    y = float(h[7]) * xo[..., 3:3 + n_out]
    for j in range(8):
        y = y + float(h[2 * j]) * xe[..., j:j + n_out]
    return y, xx[..., -(HB_NTAPS - 1):]


def decimate_batch(x: torch.Tensor, state: FrontendState, stages: int):
    """A ``stages``-deep cascade of :func:`_halfband`: x [..., N] ->
    ([..., N >> stages], new state); the tails carry x's leading dims."""
    y, tails = x, []
    for s in range(stages):
        y, tail = _halfband(y, state.tails[s])
        tails.append(tail)
    return y, FrontendState(tails=tuple(tails))


def fm_decimate(x: torch.Tensor, state: FrontendState):
    """FM path: one halfband, 1.488 MS/s complex in, 744.2 kS/s out
    (reference: src/input.c:52-60)."""
    return decimate_batch(x, state, 1)


def am_decimate(x: torch.Tensor, state: FrontendState):
    """AM path: ÷32 through 5 cascaded halfbands, after the reference's
    extra 1/16 input scaling (reference: src/input.c:62-90)."""
    return decimate_batch(x * (1.0 / 16.0), state, AM_STAGES)


def halfband_rc(x: torch.Tensor, tail: torch.Tensor):
    """One ÷2 halfband stage on rc data: x [..., N, 2] (N even),
    tail [..., 14, 2] -> (y [..., N//2, 2], new_tail).

    Polyphase split: the odd taps are zero except the centre, so
    y[m] = 0.5*xx[2m+7] + sum_j he[j]*xx[2(m+j)], added in that order
    (the reference's order, frontend.py:138-141)."""
    h = halfband_taps()
    xx = torch.cat([tail, x], dim=-2)  # [..., N+14, 2]
    n_out = x.shape[-2] // 2
    p = xx.reshape(xx.shape[:-2] + (xx.shape[-2] // 2, 2, 2))
    xe, xo = p[..., 0, :], p[..., 1, :]
    y = float(h[7]) * xo[..., 3:3 + n_out, :]
    for j in range(8):
        y = y + float(h[2 * j]) * xe[..., j:j + n_out, :]
    return y, xx[..., -(HB_NTAPS - 1):, :]


def rc_overlap(stages: int) -> int:
    """Input samples of overlap a stateless ``stages``-deep halfband
    cascade consumes: 14·(2^stages − 1)."""
    return (HB_NTAPS - 1) * ((1 << stages) - 1)


def decimate_overlap_rc(x: torch.Tensor, stages: int) -> torch.Tensor:
    """Stateless overlap-save cascade: x [..., L, 2] rc with
    L = rc_overlap(stages) + 2^stages · n_out -> [..., n_out, 2]."""
    y = x
    for _ in range(stages):
        y, _ = halfband_rc(y[..., HB_NTAPS - 1:, :],
                           y[..., :HB_NTAPS - 1, :])
    return y


def cu8_to_rc(wire: torch.Tensor, conj: bool) -> torch.Tensor:
    """uint8 [..., 2] wire pairs -> float32 rc, (u - 127) * 64/32767, with
    Q negated for the FM ingest convention when ``conj``."""
    f = (wire.float() - 127.0) * CU8_SCALE
    if conj:
        f[..., 1].neg_()
    return f


def ingest_fm_cu8_plain(wire: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: wire uint8 [S, 14 + 2N, 2] -> float32
    [S, N, 2], the FM chain input at 744187.5 S/s."""
    return decimate_overlap_rc(cu8_to_rc(wire, conj=True), 1)


@functools.lru_cache(maxsize=4)
def _k1_taps(device: str) -> torch.Tensor:
    """The 8 even-phase taps, then the centre tap, as K1 reads them."""
    h = halfband_taps()
    return torch.from_numpy(np.append(h[0::2], h[7])).to(device)


def ingest_fm_cu8(wire: torch.Tensor) -> torch.Tensor:
    """K1: wire uint8 [S, 14 + 2N, 2] -> float32 [S, N, 2].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (bit-identical to the plain version: no FMA contraction, same
    taps, same add order)."""
    if wire.ndim != 3 or wire.shape[-1] != 2:
        raise ValueError(f"wire: expected [S, L, 2], got {tuple(wire.shape)}")
    n_st, n_in, _ = wire.shape
    if n_in < HB_NTAPS + 1 or (n_in - (HB_NTAPS - 1)) % 2:
        raise ValueError(f"wire: {n_in} pairs is not 14 + 2N with N > 0")
    if wire.device.type == "cpu":
        return ingest_fm_cu8_plain(wire)
    K.check(wire, "wire", torch.uint8)
    n_out = (n_in - (HB_NTAPS - 1)) // 2
    out = torch.empty(n_st, n_out, 2, dtype=torch.float32, device=wire.device)
    K.launch("halfband_cu8", wire.data_ptr(), out.data_ptr(),
             _k1_taps(str(wire.device)).data_ptr(), CU8_SCALE, n_in, n_out,
             n_st, device=wire.device)
    return out


def _check_am_wire(wire: torch.Tensor) -> int:
    """The cu8 AM wire's chain samples N: [S, 434 + 32 N, 2] with N > 0."""
    if wire.ndim != 3 or wire.shape[-1] != 2:
        raise ValueError(f"wire: expected [S, L, 2], got {tuple(wire.shape)}")
    head, rate = rc_overlap(AM_STAGES), 1 << AM_STAGES
    n_in = wire.shape[1]
    if n_in <= head or (n_in - head) % rate:
        raise ValueError(f"wire: {n_in} pairs is not {head} + {rate}N with "
                         f"N > 0")
    return (n_in - head) // rate


def ingest_am_cu8_plain(wire: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's AM cascade: wire uint8 [S, 434 + 32N, 2] ->
    float32 [S, N, 2], the AM chain input at 46511.7 S/s: (u − 127)·64/32767
    with Q as it comes, times the reference's 1/16 (src/input.c:62-66),
    then five ÷2 halfband stages."""
    _check_am_wire(wire)
    return decimate_overlap_rc(cu8_to_rc(wire, conj=False) * (1.0 / 16.0),
                               AM_STAGES)


def ingest_am_cu8(wire: torch.Tensor) -> torch.Tensor:
    """K1's AM cascade: the argument and result of
    :func:`ingest_am_cu8_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one CTA per 256 outputs of a station: its bytes by 16-byte
    loads, stage 1 from registers, each byte converted once, stages 2-5 in
    shared memory; bit-identical to the plain version: no FMA contraction,
    same taps, same add order).  The wire's rows must start on whole pairs
    (an even address)."""
    if wire.device.type == "cpu":
        return ingest_am_cu8_plain(wire)
    n_out = _check_am_wire(wire)
    K.check(wire, "wire", torch.uint8)
    if wire.data_ptr() % 2:
        raise ValueError("wire: expected an even address (whole pairs)")
    n_st, n_in, _ = wire.shape
    out = torch.empty(n_st, n_out, 2, dtype=torch.float32, device=wire.device)
    K.launch("am_decimate_cu8", wire.data_ptr(), out.data_ptr(),
             _k1_taps(str(wire.device)).data_ptr(), CU8_SCALE, n_in, n_out,
             n_st, device=wire.device)
    return out
