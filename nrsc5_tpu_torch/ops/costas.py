"""The reference-subcarrier Costas PLL, kernel K3.

PyTorch counterpart of ``nrsc5_tpu/pipeline/scan_chain_rc.py``'s
``costas_track_rc`` (lines 107-125): a 32-step PLL over independent
tracks, used by the sync block (inside K4 on the card) and, lockstep over
76 integer CFOs × 22 refs with a static per-track frequency, by the cold
start's CFO scan (:mod:`nrsc5_tpu_torch.ops.detect_cfo`).  On the card
the PLL runs inside those two kernels, K4 (``csrc/sync_block.cu``) and K10
(``csrc/cfo_scan.cu``), both through ``csrc/costas.cuh``;
:func:`costas_track_rc_plain` is its plain PyTorch version, which the CPU
paths and both kernels' plain versions run.
"""

from __future__ import annotations

import math

import torch

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
    """The arguments and results of :func:`costas_track_rc_plain`, which a
    CPU tensor takes.  On the card the PLL runs inside K4 and K10, from
    their spectra: a CUDA tensor raises."""
    if refs.device.type == "cpu":
        return costas_track_rc_plain(refs, phase0, freq0, cfo_freq)
    raise ValueError("costas_track_rc: on the card the Costas PLL runs "
                     "inside K10 (detect_cfo_scan_rc, csrc/cfo_scan.cu) and "
                     "K4 (sync_block_rc, csrc/sync_block.cu)")
