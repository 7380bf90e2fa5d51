"""Carried chain state to and from numpy.

The receiver has no weights: its parameters are its tables and the carried
state of the chain.  These two functions hand that state across packages
and processes as plain numpy arrays keyed by the field names of
``ChainCarryRC`` (the same names as the reference package's carry), so a
stream decoded so far by one receiver continues bit-exactly in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.pipeline.scan_chain_rc import ChainCarryRC

_DTYPES = {
    "offset": torch.int32, "phase": torch.float32,
    "prev_angle": torch.float32, "costas_phase": torch.float32,
    "costas_freq": torch.float32, "samperr_fb": torch.int32,
    "angle_fb": torch.float32, "cfo": torch.int32,
}
# the reference carry's PX interleaver state; the port decodes no PX
# channel yet, so it takes these only while they hold nothing
_PX_FIELDS = ("px1_internal", "px1_phase", "px2_internal", "px2_phase")


def carry_from_numpy(d: dict, *, device="cuda") -> ChainCarryRC:
    """{field: array} -> the port's carry on ``device``.  Arrays without a
    leading station axis (one station's carry) get one; ``d`` must hold
    exactly the carry's fields, plus the reference's PX fields if they are
    all zero (no PX state, as in a service mode without PX channels)."""
    px = set(d) & set(_PX_FIELDS)
    if set(d) - px != set(ChainCarryRC._fields):
        raise ValueError(f"carry fields {sorted(d)} != "
                         f"{sorted(ChainCarryRC._fields)}")
    for name in px:
        if np.any(np.asarray(d[name])):
            raise ValueError(f"{name} holds PX state, which the port does "
                             "not decode yet")
    dev = K.resolve_device(device)
    single = np.ndim(d["offset"]) == 0
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
