"""How far the session's MER events on the card stand from the same
session's on the CPU, and which part of the path moves them.

Run from the root of the repository on a machine with a CUDA card and
``nvcc``:

    python3 probes/session_mer_gap.py [--seeds=12345,1,2,3,4,5,6,7]

For each seed, ``chip_smoke.make_golden_capture(seed)`` (the golden
capture's recipe, 25 dB) goes through ``NRSC5.open_pipe`` in pushes of
32768 bytes, as the CLI reads a file, then ``flush``: once on the CPU
(every kernel's plain version, the tests' reference), then on the card
once for each of these variants:

* ``card``: every kernel on the card, as the session runs;
* ``plain_dft``: ``dft_bf16`` replaced by its plain version on the card
  (a float32 cuBLAS product, inside K5's graph too);
* ``plain_cold_start``: the cold start (``cold_start_rc``) run with
  ``plain=True`` on the card;
* ``plain_receiver``: every dispatch of the receiver (``serve.chain_step``)
  run with ``plain=True`` on the card, eagerly;
* ``all_plain``: both of the last two (K1 still runs; it is exact);
* ``card_eager``: every kernel on the card, the receiver's dispatches
  launched eagerly (``graph=False``) rather than through K5's graph;
* ``plain_fold``, ``plain_sync``, ``plain_carry``: as ``card_eager``, with
  one kernel of the block loop on its plain version on the card (in the
  cold start too): K2 (``demod_fold_bf16``), K4 (``sync_block_rc``, with
  the carry step it takes after each block) or K5 (``block_carry``, the
  loop's first step).

Each card run's events must equal the CPU run's by
``tests/serve_events.key``.  A seed a line, the script prints each
variant's MER differences from the CPU run (dB, an event's larger of
lower and upper, in order) and, for ``card``, how far its lock stands
from the CPU's (offset, integer CFO and the carry's largest float
difference).  It exits non-zero if an event differs.  No audio is decoded
(``hdc_decoder_factory=None``).
"""

import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nrsc5_tpu_torch import constants as C  # noqa: E402
from nrsc5_tpu_torch import kernels as K  # noqa: E402
from nrsc5_tpu_torch import serve  # noqa: E402
from nrsc5_tpu_torch.api.session import NRSC5  # noqa: E402
from nrsc5_tpu_torch.ops import rcplx  # noqa: E402
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc  # noqa: E402
from tests.serve_events import key  # noqa: E402

KERNEL_DFT = rcplx.dft_bf16
COLD_START = rcc.cold_start_rc
CHAIN_STEP = serve.chain_step
FOLD, SYNC, CARRY = rcc.demod_fold_bf16, rcc.sync_block_rc, rcc.block_carry
LOCKS = []


def _plain_fold(*args, out=None):
    res = rcc.demod_fold_bf16_plain(*args)
    return res if out is None else K.into(out, res)


def _plain_sync(*args, out=None):
    res = rcc.sync_block_rc_plain(*args)
    return res if out is None else K.into(out, res)


def _plain_carry(keep, samperr, angle, state, first, plain=False):
    return CARRY(keep, samperr, angle, state, first, True)


def _plain_dft_on_card(a, out=None):
    res = rcplx.dft_bf16_plain(a)
    return res if out is None else out.copy_(res)


def _recording_cold_start(samples, **kw):
    lock = COLD_START(samples, **kw)
    LOCKS.append(lock)
    return lock


VARIANTS = {
    "card": {},
    "plain_dft": {"dft": _plain_dft_on_card},
    "plain_cold_start": {"cold": True},
    "plain_receiver": {"step": True},
    "all_plain": {"cold": True, "step": True},
    "card_eager": {"eager": True},
    "plain_fold": {"eager": True, "fold": _plain_fold},
    "plain_sync": {"eager": True, "sync": _plain_sync},
    "plain_carry": {"eager": True, "carry": _plain_carry},
}


def _patch(dft=KERNEL_DFT, cold=False, step=False, eager=False, fold=FOLD,
           sync=SYNC, carry=CARRY):
    rcplx.dft_bf16 = dft
    rcc.cold_start_rc = functools.partial(_recording_cold_start,
                                          plain=True) if cold \
        else _recording_cold_start
    serve.chain_step = functools.partial(CHAIN_STEP, plain=True) if step \
        else functools.partial(CHAIN_STEP, graph=False) if eager \
        else CHAIN_STEP
    rcc.demod_fold_bf16, rcc.sync_block_rc, rcc.block_carry = \
        fold, sync, carry


def decode(wire: np.ndarray, device: str) -> list:
    events = []
    radio = NRSC5.open_pipe(events.append, hdc_decoder_factory=None,
                            device=device)
    for i in range(0, len(wire), 32768):
        radio.pipe_samples_cu8(wire[i:i + 32768])
    radio.flush()
    return [e for e in events if e.type.name != "IQ"]


def mer_apart(want: list, got: list) -> list:
    if [key(e)[0] for e in got] != [key(e)[0] for e in want]:
        raise AssertionError("the events differ from the CPU run's")
    return [float(np.max(np.abs(np.subtract(key(g)[1], key(w)[1]))))
            for g, w in zip(got, want) if key(w)[1]]


def lock_apart(want: dict, got: dict) -> dict:
    floats = [float((getattr(got["carry"], f).cpu()
                     - getattr(want["carry"], f).cpu()).abs().max())
              for f in ("phase", "prev_angle", "costas_phase",
                        "costas_freq", "angle_fb")]
    return {"offset": int(got["offset"]) - int(want["offset"]),
            "cfo": int(got["cfo"]) - int(want["cfo"]),
            "carry_float_max": max(floats)}


def main(argv) -> int:
    seeds = [chip_smoke.GOLDEN_SEED, *range(1, 8)]
    for a in argv:
        if a.startswith("--seeds="):
            seeds = [int(s) for s in a.split("=", 1)[1].split(",")]
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    K.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    # the plain DFT's table, made before K5's graph is captured
    rcplx._dft_matrix(C.FFT_FM, True, "cuda:0")
    bad = 0
    for seed in seeds:
        wire = chip_smoke.make_golden_capture(seed)
        _patch()
        LOCKS.clear()
        want = decode(wire, "cpu")
        want_lock = [lk for lk in LOCKS if lk][-1]
        line = {"seed": seed}
        for name, patch in VARIANTS.items():
            _patch(**patch)
            LOCKS.clear()
            try:
                line[name] = mer_apart(want, decode(wire, "cuda"))
            except AssertionError as e:
                line[name] = str(e)
                bad += 1
            finally:
                _patch()
            if name == "card":
                line["card_lock"] = lock_apart(want_lock,
                                               [lk for lk in LOCKS if lk][-1])
        print(json.dumps(line), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
