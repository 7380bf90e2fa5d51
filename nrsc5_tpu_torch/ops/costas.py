"""The reference-subcarrier Costas PLL, kernel K3.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain_rc.py``'s
``costas_track_rc`` (lines 107-125): a 32-step PLL over independent
tracks, used by the sync block (inside K4 on the card) and, lockstep over
76 integer CFOs × 22 refs with a static per-track frequency, by the cold
start's CFO scan (:mod:`nrsc5_tpu_torch.ops.detect_cfo`).
:func:`costas_track_rc` launches ``csrc/costas_track.cu`` on a CUDA tensor;
:func:`costas_track_rc_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import math

import torch

from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.ops import sync_fm as SF

TWO_PI = 2 * math.pi


def wrap_pi(x):
    return x - TWO_PI * torch.round(rc.fdiv(x, TWO_PI))


def _check_costas(refs, phase0, freq0, cfo_freq):
    if refs.ndim != 3 or refs.shape[-1] != 2:
        raise ValueError(f"refs: expected [T, R, 2], got {tuple(refs.shape)}")
    r = refs.shape[1]
    for name, t in (("phase0", phase0), ("freq0", freq0),
                    ("cfo_freq", cfo_freq)):
        if t is not None and tuple(t.shape) != (r,):
            raise ValueError(f"{name}: expected shape ({r},), got "
                             f"{tuple(t.shape)}")


def costas_track_rc_plain(refs, phase0, freq0, cfo_freq=None):
    """Plain version of K3.  refs: [T, R, 2] (T symbols of R independent
    tracks); phase0, freq0 and the optional static per-track frequency
    ``cfo_freq``: [R].  Returns (derot [T, R, 2], phases [T, R],
    ph_out [R], fr_out [R])."""
    _check_costas(refs, phase0, freq0, cfo_freq)
    ph, fr = phase0, freq0
    derots, phases = [], []
    for v in refs:
        v2 = rc.mul(v, v)
        err = 0.5 * wrap_pi(rc.angle(v2) - 2 * ph)
        derots.append(rc.mul(v, rc.exp_i(-ph)))
        phases.append(ph)
        fr = torch.clamp(fr + SF.BETA * err, -0.5, 0.5)
        step = ph + fr if cfo_freq is None else ph + fr + cfo_freq
        ph = wrap_pi(step + SF.ALPHA * err)
    return torch.stack(derots), torch.stack(phases), ph, fr


def costas_track_rc(refs, phase0, freq0, cfo_freq=None):
    """K3: the arguments and results of :func:`costas_track_rc_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one thread per track, the recurrence in registers)."""
    if refs.device.type == "cpu":
        return costas_track_rc_plain(refs, phase0, freq0, cfo_freq)
    _check_costas(refs, phase0, freq0, cfo_freq)
    n_steps, n_tracks, _ = refs.shape
    K.check(refs, "refs", torch.float32)
    K.check(phase0, "phase0", torch.float32)
    K.check(freq0, "freq0", torch.float32)
    if cfo_freq is not None:
        K.check(cfo_freq, "cfo_freq", torch.float32)
    dev = refs.device
    derot = torch.empty_like(refs)
    phases = torch.empty(n_steps, n_tracks, dtype=torch.float32, device=dev)
    ph_out = torch.empty(n_tracks, dtype=torch.float32, device=dev)
    fr_out = torch.empty(n_tracks, dtype=torch.float32, device=dev)
    K.launch("costas_track", refs.data_ptr(), phase0.data_ptr(),
             freq0.data_ptr(),
             None if cfo_freq is None else cfo_freq.data_ptr(),
             derot.data_ptr(), phases.data_ptr(), ph_out.data_ptr(),
             fr_out.data_ptr(), n_steps, n_tracks, SF.ALPHA, SF.BETA,
             TWO_PI, device=dev)
    return derot, phases, ph_out, fr_out
