"""Checkpoint and resume of a receiver's carried state.

PyTorch counterpart of ``nrsc5_tpu/utils/checkpoint.py``.  Every chain's
carried state is an explicit tree of NamedTuples of tensors (``ChainCarry``,
``AMChainCarry``, ``FrontendState``, the rc carries, the decoders' delay
lines), so serialization is generic: the leaves in the reference's pytree
order (:func:`nrsc5_tpu_torch.state.carry_leaves`) as ``leaf_{i}`` arrays of
an ``.npz``.  The reference's ``load_state`` reads a file this module
saves, and :func:`load_state` reads the reference's.  A checkpoint taken
at a block boundary resumes bit-exactly.
"""

from __future__ import annotations

import json

import numpy as np

from nrsc5_tpu_torch import state as ST


def save_state(path: str, state) -> None:
    """Save a tree of NamedTuples of tensors to ``path`` (.npz): its
    leaves, and a description of the tree (the reference's
    ``__treedef__`` entry, which neither package reads back)."""
    leaves = ST.carry_leaves(state)
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(_describe(state)).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Load a state saved by :func:`save_state` (or by the reference's);
    ``like`` gives the structure, dtypes and device (e.g.
    ``chain_init_carry(device=...)``).  Each leaf's shape must be
    ``like``'s."""
    with np.load(path) as data:
        ref = ST.carry_leaves(like)
        loaded = [data[f"leaf_{i}"] for i in range(len(ref))]
    for arr, r in zip(loaded, ref):
        if arr.shape != r.shape:
            raise ValueError(f"shape mismatch {arr.shape} != {r.shape}")
    return ST.carry_from_leaves(loaded, like)


def _describe(state) -> str:
    if isinstance(state, tuple):
        return f"{type(state).__name__}(" + ", ".join(
            _describe(x) for x in state) + ")"
    return "*"
