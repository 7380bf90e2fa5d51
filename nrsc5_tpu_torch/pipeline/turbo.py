"""The streaming FM receiver with a fused steady-state path.

PyTorch counterpart of ``nrsc5_tpu/pipeline/turbo.py``.
:class:`TurboFMReceiver` has the interface of
:class:`~nrsc5_tpu_torch.pipeline.receiver.FMReceiver` (``push_cs16`` /
``push_cu8`` and the frame and event callbacks), but once the per-block
receiver is FINE-synced at a frame boundary (bc 0) it decodes a whole P1
frame a call with :func:`~nrsc5_tpu_torch.pipeline.scan_chain.
fm_chain_scan`.  Acquisition and loss recovery are the per-block
receiver's.  The extended modes promote too: the PX1/PX2 interleaver-IV
state passes from the per-block receiver into the fused chain
(:class:`~nrsc5_tpu_torch.pipeline.scan_chain.PxState`), so MP2, MP3 and
MP11 decode their P3 frames in the same call as PM.  A link whose P1 bit
error rate passes 15 % drops back to re-acquisition.  On a card the fused
chain runs K17 and K18 a block (after K5's step ahead of block 0), and
its outputs are bit-packed by K8 before they are read back, as the
reference packs them on an accelerator.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.bits import unpack_out
from nrsc5_tpu_torch.pipeline import scan_chain as sc
from nrsc5_tpu_torch.pipeline.receiver import SYNC_FINE, FMReceiver, mer_db

# the compatibility modes the fused chain takes over (PM, with PX in the
# extended ones)
FAST_MODES = (1, 2, 3, 5, 6, 11)


class TurboFMReceiver:
    """Streaming FM receiver with a fused steady-state fast path, on
    ``device`` (default ``"cuda"``, which raises with no card)."""

    def __init__(self, on_frame: Callable[[int, np.ndarray, float], None],
                 on_event: Callable[[str, dict], None] | None = None,
                 frames_per_dispatch: int = 1, *, device="cuda"):
        self.on_frame = on_frame
        self.on_event = on_event or (lambda kind, info: None)
        self.n_blocks = frames_per_dispatch * C.P1_FM_BLOCKS
        self._slow = FMReceiver(on_frame, self.on_event, device=device)
        self.device = self._slow.device
        self.reset()

    def _clear_fast(self):
        self._fast = False
        self._carry: sc.ChainCarry | None = None
        self._px_state: sc.PxState | None = None
        self._psmi = 1
        # host mirrors of the IV call phase for the warm-up gate (frames
        # decoded before a full interleaver cycle are discarded, like the
        # reference's `ready` flag, src/decode.c:355-359)
        self._px_ready = {1: False, 2: False}
        self._px_phase = {1: 0, 2: 0}
        self._mer_acc, self._mer_cnt = [0.0, 0.0], 0

    def resync(self):
        self._clear_fast()
        self._slow.resync()

    def reset(self):
        self._clear_fast()
        self._slow.reset()

    # ------------------------------------------------------------------
    def push_cu8(self, data: np.ndarray):
        if self._fast:
            self.push_cs16(self._slow.decimate_cu8(data))
        else:
            self._slow.push_cu8(data)

    def push_cs16(self, samples: np.ndarray):
        r = self._slow
        if not self._fast:
            r.push_cs16(samples)
            # promote once FINE-locked at a frame boundary (bc == 0 also
            # pair-aligns the PX interleaver-IV calls in extended modes)
            if (r.sync_state == SYNC_FINE and r.bc == 0
                    and C.COMPATIBILITY_MODE[r.psmi] in FAST_MODES
                    and r.ring.size != 0):
                self._enter_fast()
            return
        r.ring = np.concatenate([r.ring, np.asarray(samples, np.complex64)])
        needed = sc.buffer_len(self.n_blocks)
        while len(r.ring) >= needed:
            self._fast_dispatch()
            if not self._fast:
                # resync: the remaining samples re-enter the slow path
                r.push_cs16(np.zeros(0, np.complex64))
                return

    # ------------------------------------------------------------------
    def _enter_fast(self):
        r = self._slow
        dev = self.device
        self._carry = sc.ChainCarry(
            offset=torch.zeros((), dtype=torch.int32, device=dev),
            acq=r.acq_state, sync=r.sync_arrays,
            samperr_fb=torch.tensor(r.samperr_fb, dtype=torch.int32,
                                    device=dev),
            angle_fb=torch.tensor(r.angle_fb, dtype=torch.float32,
                                  device=dev))
        r.samperr_fb = 0
        r.angle_fb = 0.0
        self._psmi = r.psmi
        fl1, fl2 = sc.px_frame_lens(self._psmi)
        if fl1 or fl2:
            # hand the per-block receiver's interleaver-IV state over;
            # bc == 0 guarantees pair alignment and no pending half pair
            def phase(p):
                return torch.tensor(p, dtype=torch.int32, device=dev)
            self._px_state = sc.PxState(
                px1_internal=r.px1.internal, px1_phase=phase(
                    r.px1.call_phase),
                px2_internal=(r.px2.internal if fl2 else torch.zeros(
                    0, dtype=torch.int8, device=dev)),
                px2_phase=phase(r.px2.call_phase if fl2 else 0))
            self._px_ready = {1: r.px1.ready, 2: bool(fl2) and r.px2.ready}
            self._px_phase = {1: r.px1.call_phase,
                              2: r.px2.call_phase if fl2 else 0}
        else:
            self._px_state = None
        self._fast = True

    def _fast_dispatch(self):
        r = self._slow
        packed = self.device.type != "cpu"
        samples = torch.from_numpy(
            r.ring[:sc.buffer_len(self.n_blocks)]).to(self.device)
        out, carry = sc.fm_chain_scan(samples, self._carry, self.n_blocks,
                                      self._psmi, 0, self._px_state, packed)
        consumed = int(carry.offset)
        self._carry = sc.rebase_carry(carry, consumed)
        r.ring = r.ring[consumed:]

        host = {k: v.cpu().numpy() for k, v in out.items()
                if isinstance(v, torch.Tensor)}
        if packed:
            unpack_out(host)
        errors = host["p1_bit_errors"]
        error_lb = out["diag"]["error_lb"].cpu().numpy()
        error_ub = out["diag"]["error_ub"].cpu().numpy()
        for b in range(self.n_blocks):
            self.on_event("block", {})
            self.on_frame(-1, host["pids"][b], 0.0)
            # MER every 16 blocks, as the per-block path aggregates it
            # (reference: src/sync.c:486-501)
            self._mer_acc[0] += float(error_lb[b])
            self._mer_acc[1] += float(error_ub[b])
            self._mer_cnt += 1
            if self._mer_cnt == 16:
                ppb = C.partitions_per_band(self._psmi)
                signal = 2 * C.BLKSZ * ppb * C.PARTITION_DATA_CARRIERS * 16
                self.on_event("mer", {
                    "lower": mer_db(signal, self._mer_acc[0]),
                    "upper": mer_db(signal, self._mer_acc[1])})
                self._mer_acc, self._mer_cnt = [0.0, 0.0], 0
        for f in range(host["p1"].shape[0]):
            self.on_event("ber", {
                "cber": float(errors[f]) / C.P1_FRAME_LEN_ENCODED_FM})
            self.on_frame(0, host["p1"][f], float(host["p1_margin"][f]))
        if self._px_state is not None:
            self._px_state = out["px_state"]
            fls = sc.px_frame_lens(self._psmi)
            for chan, key in ((1, "px1"), (2, "px2")):
                if key not in host:
                    continue
                bits, margins = host[key], host[key + "_margin"]
                _, _, calls = IL.p3_iv_tables(fls[chan - 1])
                phase0 = self._px_phase[chan]
                for j in range(bits.shape[0]):
                    # discard the warm-up frames (src/decode.c:355-359)
                    if self._px_ready[chan] or phase0 + j >= calls:
                        self.on_frame(chan, bits[j], float(margins[j]))
                self._px_ready[chan] = (self._px_ready[chan]
                                        or phase0 + bits.shape[0] >= calls)
                self._px_phase[chan] = (phase0 + bits.shape[0]) % calls
        # link-quality watchdog: the soft rate-2/5 K=7 code fails far below
        # a 15 % channel BER, so above it the carrier is gone: drop to
        # re-acquisition at once (a transport RS resync also lands here)
        if errors.size and errors.max() / C.P1_FRAME_LEN_ENCODED_FM > 0.15:
            self.on_event("lost_sync", {})
            self.resync()
