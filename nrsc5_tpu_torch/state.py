"""Carried chain state to and from numpy.

The receiver has no weights: its parameters are its tables and the carried
state of the chain.  These functions hand that state across packages and
processes as plain numpy arrays keyed by the field names of
``ChainCarryRC`` (the same names and order as the reference package's
carry, the PX channels' interleaver-IV state included) or, for AM, of
``AMChainCarryRC`` with its ``dec`` delay lines flattened to their own
names (``ml``, ``mu``, ``eml``, ``emu``), so a stream decoded so far by one
receiver continues bit-exactly in the other.

The per-block receivers' and the complex chains' state (``AcquireState``,
``SyncState``, ``FrontendState``, ``ChainCarry``, ``PxState``,
``AMChainCarry``) goes the same way through :func:`block_state_to_numpy`
and :func:`block_state_from_numpy`: one array a leaf under the leaf's
field name in the reference (nested states flattened, a frontend's tails
stacked under ``tails``), so either package's state, flattened alike,
continues in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops.acquire import AcquireState
from nrsc5_tpu_torch.ops.decode_am import DD, AMDecodeState
from nrsc5_tpu_torch.ops.frontend import FrontendState
from nrsc5_tpu_torch.ops.sync_fm import SyncState
from nrsc5_tpu_torch.pipeline.scan_chain import (ChainCarry, PxState,
                                                 iv_state_len, px_frame_lens,
                                                 tree_leaves, tree_rebuild)
from nrsc5_tpu_torch.pipeline.scan_chain_am import AMChainCarry
from nrsc5_tpu_torch.pipeline.scan_chain_am_rc import AMChainCarryRC
from nrsc5_tpu_torch.pipeline.scan_chain_rc import ChainCarryRC

_DTYPES = {
    "offset": torch.int32, "phase": torch.float32,
    "prev_angle": torch.float32, "costas_phase": torch.float32,
    "costas_freq": torch.float32, "samperr_fb": torch.int32,
    "angle_fb": torch.float32, "cfo": torch.int32,
    "px1_internal": torch.int8, "px1_phase": torch.int32,
    "px2_internal": torch.int8, "px2_phase": torch.int32,
}


def _iv_lens(psmi: int | None) -> list[set]:
    """The interleaver-IV state lengths px1 and px2 may hold: those of
    ``psmi``, or without it those of any service mode (0: no channel)."""
    modes = range(len(C.COMPATIBILITY_MODE)) if psmi is None else (psmi,)
    return [{iv_state_len(px_frame_lens(p)[i]) for p in modes}
            for i in range(2)]


def carry_from_numpy(d: dict, *, psmi: int | None = None,
                     device="cuda") -> ChainCarryRC:
    """{field: array} -> the port's carry on ``device``.  Arrays without a
    leading station axis (one station's carry) get one; ``d`` must hold
    exactly the carry's fields.  The interleaver-IV state must have the
    length of ``psmi``'s PX channels, or, without ``psmi``, the length of
    some service mode's."""
    if set(d) != set(ChainCarryRC._fields):
        raise ValueError(f"carry fields {sorted(d)} != "
                         f"{sorted(ChainCarryRC._fields)}")
    single = np.ndim(d["offset"]) == 0
    for name, allowed in zip(("px1_internal", "px2_internal"),
                             _iv_lens(psmi)):
        n = np.shape(d[name])[-1]
        if n not in allowed:
            raise ValueError(f"{name} holds {n} entries, not the "
                             "interleaver-IV state of " + (
                                 "a service mode" if psmi is None
                                 else f"psmi {psmi}"))
    dev = K.resolve_device(device)
    leaves = {}
    for name, dtype in _DTYPES.items():
        a = np.asarray(d[name])
        if single:
            a = a[None]
        leaves[name] = torch.tensor(a, dtype=dtype, device=dev)
    return ChainCarryRC(**leaves)


def carry_to_numpy(carry: ChainCarryRC) -> dict:
    """The port's carry -> {field: numpy array} (station axis kept)."""
    return {name: getattr(carry, name).cpu().numpy()
            for name in ChainCarryRC._fields}


_AM_DTYPES = {
    "offset": torch.int32, "phase": torch.float32,
    "prev_angle": torch.float32, "samperr_fb": torch.int32,
    "cfo": torch.int32, "ml": torch.uint8, "mu": torch.uint8,
    "eml": torch.uint8, "emu": torch.uint8,
}


def am_carry_from_numpy(d: dict, *, device="cuda") -> AMChainCarryRC:
    """{field: array} -> the port's AM carry on ``device``.  ``d`` holds
    exactly the top fields of ``AMChainCarryRC`` but ``dec``, and the four
    delay lines (``ml``, ``mu``, ``eml``, ``emu``, 54000 entries each).
    Arrays without a leading station axis (one station's carry) get
    one."""
    if set(d) != set(_AM_DTYPES):
        raise ValueError(f"AM carry fields {sorted(d)} != "
                         f"{sorted(_AM_DTYPES)}")
    for name in AMDecodeState._fields:
        if np.shape(d[name])[-1] != DD:
            raise ValueError(f"{name} holds {np.shape(d[name])[-1]} "
                             f"entries, not a {DD}-bit delay line")
    single = np.ndim(d["offset"]) == 0
    dev = K.resolve_device(device)
    leaves = {}
    for name, dtype in _AM_DTYPES.items():
        a = np.asarray(d[name])
        leaves[name] = torch.tensor(a[None] if single else a, dtype=dtype,
                                    device=dev)
    dec = AMDecodeState(*(leaves.pop(n) for n in AMDecodeState._fields))
    return AMChainCarryRC(**leaves, dec=dec)


def am_carry_to_numpy(carry: AMChainCarryRC) -> dict:
    """The port's AM carry -> {field: numpy array} (station axis kept), the
    delay lines under their own names."""
    out = {name: getattr(carry, name).cpu().numpy()
           for name in AMChainCarryRC._fields if name != "dec"}
    out.update({name: line.cpu().numpy()
                for name, line in carry.dec._asdict().items()})
    return out


def carry_leaves(carry) -> list:
    """A carry or any state of NamedTuples of tensors (station axis kept)
    -> its leaves as numpy arrays in the reference's pytree order
    (``jax.tree.flatten``: the fields in order, nested states in place, so
    an AM carry's delay lines last): the ``carry_{i}`` arrays of a
    receiver's saved state."""
    return [t.cpu().numpy() for t in tree_leaves(carry)]


def carry_from_leaves(leaves: list, like):
    """Inverse of :func:`carry_leaves`: numpy leaves in the reference's
    pytree order -> a state of ``like``'s structure, dtypes and device."""
    ref = tree_leaves(like)
    if len(leaves) != len(ref):
        raise ValueError(f"{len(leaves)} carry leaves, expected {len(ref)}")
    return tree_rebuild(like, iter([
        torch.as_tensor(np.asarray(a), device=r.device).to(r.dtype)
        for a, r in zip(leaves, ref)]))


# the complex chains' states: the nested fields of each
BLOCK_STATES = {"acquire": AcquireState, "sync": SyncState,
                "frontend": FrontendState, "chain": ChainCarry,
                "px": PxState, "am_chain": AMChainCarry}
_NESTED = {"acq": AcquireState, "sync": SyncState, "dec": AMDecodeState}


def block_state_to_numpy(state) -> dict:
    """A complex-chain state (of this package or, with the same field
    names, of the reference) -> {leaf field: numpy array}: nested states
    flattened into their fields, a frontend's ``tails`` stacked [stages,
    14]."""
    out = {}
    for name, value in zip(state._fields, state):
        if name in _NESTED:
            out.update(block_state_to_numpy(value))
        elif name == "tails":
            out[name] = np.stack([np.asarray(
                t.cpu() if isinstance(t, torch.Tensor) else t)
                for t in value])
        else:
            out[name] = np.asarray(value.cpu() if isinstance(
                value, torch.Tensor) else value)
    return out


def block_state_from_numpy(d: dict, kind: str, *, device="cuda"):
    """Inverse of :func:`block_state_to_numpy`: ``kind`` names the state
    (a key of :data:`BLOCK_STATES`), ``d`` holds exactly its leaf fields;
    each array keeps its dtype."""
    dev = K.resolve_device(device)

    def build(cls):
        vals = []
        for name in cls._fields:
            if name in _NESTED:
                vals.append(build(_NESTED[name]))
            elif name == "tails":
                vals.append(tuple(torch.from_numpy(np.array(t)).to(dev)
                                  for t in d[name]))
            else:
                vals.append(torch.from_numpy(np.array(d[name])).to(dev))
        return cls(*vals)

    cls = BLOCK_STATES[kind]
    want = set(_leaf_names(cls))
    if set(d) != want:
        raise ValueError(f"{kind} state fields {sorted(d)} != "
                         f"{sorted(want)}")
    return build(cls)


def _leaf_names(cls) -> list:
    return [leaf for n in cls._fields for leaf in (
        _leaf_names(_NESTED[n]) if n in _NESTED else [n])]
