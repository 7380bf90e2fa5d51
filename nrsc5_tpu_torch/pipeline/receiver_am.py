"""The per-block AM receiver: ring buffer + block-sync state machine.

PyTorch counterpart of ``nrsc5_tpu/pipeline/receiver_am.py``, the AM
(MA1/MA3) twin of :class:`~nrsc5_tpu_torch.pipeline.receiver.FMReceiver`:
the device side is the complex acquire and sync functions of
:mod:`nrsc5_tpu_torch.ops` (on a card the demodulation K19 and the sync
block K20 at one station, after the coarse timing on a COARSE block) and
the AM decode (K15, K7 at K=9 and K8 on a card); this receiver owns the NONE/COARSE/FINE state machine driven by the
reference subcarrier's block counts (history 0x5670; reference:
src/sync.c:635-666), the coarse-timing consensus latch, the integer-CFO
latch, the per-frame code matrices, the diversity-delay warm-up and the
subframe queue.

Decoded outputs go to ``on_frame(channel, bits, margin)`` as numpy arrays:
-1 PIDS (every block, through K15's PIDS-only launch on a card), 0 P1 (one
subframe a block), 3 P3.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.ops.acquire import (WINDOW_AM, AcquireState, acquire_am,
                                         acquire_init_state)
from nrsc5_tpu_torch.ops.decode_am import (DD, AMDecodeState,
                                           am_frame_decode, am_pids_decode)
from nrsc5_tpu_torch.ops.sync_am import (find_block_am, find_ref_am,
                                         sync_am_step, timing_consensus)

SYNC_NONE, SYNC_COARSE, SYNC_FINE = 0, 1, 2

_MATRICES = ("pl", "pu", "s", "t")


class AMReceiver:
    """Streaming AM NRSC-5 layer-1 receiver (46511.7 S/s complex input) on
    ``device`` (default ``"cuda"``, which raises with no card; ``"cpu"``
    runs the plain versions)."""

    def __init__(self, on_frame: Callable[[int, np.ndarray, float], None],
                 on_event: Callable[[str, dict], None] | None = None, *,
                 device="cuda"):
        self.on_frame = on_frame
        self.on_event = on_event or (lambda kind, info: None)
        self.device = K.resolve_device(device)
        self.ring = np.zeros(0, np.complex64)
        self.reset()

    def _empty_dec(self) -> AMDecodeState:
        return AMDecodeState(*(torch.zeros(DD, dtype=torch.uint8,
                                           device=self.device)
                               for _ in AMDecodeState._fields))

    def reset(self):
        self._fe_state = FE.frontend_init_state(FE.AM_STAGES,
                                                device=self.device)
        self._cu8_leftover = np.zeros(0, np.uint8)
        self.acq_state: AcquireState = acquire_init_state(device=self.device)
        self.dec_state: AMDecodeState = self._empty_dec()
        self.sync_state = SYNC_NONE
        self.psmi = C.SERVICE_MODE_MA1
        self.control: dict = {}
        self.bc = 0
        self.cfo = 0
        self.cfo_wait = 0
        self.keep_extra = 0
        self.samperr_fb = 0
        self.offset_history = 0
        # coarse-timing consensus latch (multipath outlier rejection)
        self._coarse_hist: list[int] = []
        self._coarse_latch = -1
        self._latch_age = 0
        self.diversity_wait = 4
        self._mats: list = [None] * 8
        self._p1_queue = []

    def resync(self):
        """Hard resync (reference: src/frame.c:535-540)."""
        if self.sync_state == SYNC_FINE:
            self.on_event("lost_sync", {})
        fe, leftover = self._fe_state, self._cu8_leftover
        self.reset()
        self._fe_state, self._cu8_leftover = fe, leftover

    # ------------------------------------------------------------------
    def push_cs16(self, samples: np.ndarray):
        self.ring = np.concatenate([self.ring,
                                    np.asarray(samples, np.complex64)])
        while len(self.ring) >= WINDOW_AM:
            self._process_block()

    def push_cu8(self, data: np.ndarray):
        """Interleaved cu8 at 1488375 S/s: the ÷32 five-stage halfband
        cascade on the device (reference: src/input.c:62-90)."""
        data = np.concatenate([self._cu8_leftover,
                               np.asarray(data, np.uint8)])
        usable = len(data) & ~63  # 64 bytes -> 32 complex in -> 1 out
        self._cu8_leftover = data[usable:]
        if usable == 0:
            return
        x = FE.cu8_to_cf(torch.from_numpy(data[:usable]).to(self.device))
        y, self._fe_state = FE.am_decimate(x, self._fe_state)
        self.push_cs16(y.cpu().numpy())

    def _process_block(self):
        self._drain_p1()
        self.on_event("block", {})
        window = torch.from_numpy(self.ring[:WINDOW_AM]).to(self.device)
        fine = self.sync_state == SYNC_FINE
        spectra, self.acq_state, _, keep, mag_sums, meas = acquire_am(
            window, self.acq_state, fine, self.samperr_fb, self.cfo,
            self._coarse_latch)
        self.samperr_fb = 0
        if self.sync_state == SYNC_NONE:
            self.sync_state = SYNC_COARSE

        if not fine:
            # timing-consensus latch: once recent measurements agree, pin
            # the coarse timing so multipath outlier blocks cannot scramble
            # block alignment; drop a latch that never yields lock
            self._coarse_hist.append(int(meas) % C.FFTCP_AM)
            self._coarse_hist = self._coarse_hist[-6:]
            if self._coarse_latch < 0:
                cons = timing_consensus(self._coarse_hist, C.FFTCP_AM)
                if cons is not None:
                    self._coarse_latch = cons
                    self._latch_age = 0
            else:
                self._latch_age += 1
                if self._latch_age > 16:
                    self._coarse_latch = -1
                    self._coarse_hist.clear()
                    self._latch_age = 0

            # integer CFO: the strongest bin near the carrier
            # (reference: src/acquire.c:209-235)
            lo = C.CENTER_AM - C.PIDS_OUTER_INDEX_AM
            hi = C.CENTER_AM + C.PIDS_OUTER_INDEX_AM + 1
            mags = mag_sums[lo:hi].cpu().numpy()
            self.cfo += int(np.argmax(mags)) + lo - C.CENTER_AM

        consumed = WINDOW_AM - (int(keep) + self.keep_extra)
        self.keep_extra = 0
        self.ring = self.ring[consumed:]

        ma3 = self.psmi == C.SERVICE_MODE_MA3
        out = sync_am_step(spectra, ma3)
        ref_bits = out["ref_bits"].cpu().numpy()

        if self.sync_state == SYNC_COARSE:
            if self.cfo_wait == 0:
                offset = find_ref_am(ref_bits)
                if offset > 0:
                    self.keep_extra = ((C.BLKSZ - offset) % C.BLKSZ) \
                        * C.FFTCP_AM
                    self.cfo_wait = 8
            else:
                self.cfo_wait -= 1

            found = find_block_am(ref_bits)
            if found is None:
                self.offset_history = 0
            else:
                bc, control = found
                if control:
                    self.psmi = control["psmi"] or C.SERVICE_MODE_MA1
                    self.control = control
                self.offset_history = ((self.offset_history << 4) | bc) \
                    & 0xFFFFFFFF
            if (self.offset_history & 0xFFFF) != 0x5670:
                return
            # lock: this very block is bc=0; it is processed as FINE in the
            # same call (reference: sync.c:653-666)
            self.bc = 0
            self.sync_state = SYNC_FINE
            self.offset_history = 0
            self.dec_state = self._empty_dec()
            self.diversity_wait = 4
            self._mats = [None] * 8
            self.on_event("sync", {"psmi": self.psmi})
            if (self.psmi == C.SERVICE_MODE_MA3) != ma3:
                ma3 = self.psmi == C.SERVICE_MODE_MA3
                out = sync_am_step(spectra, ma3)

        # FINE ---------------------------------------------------------
        found = find_block_am(ref_bits)
        if found is not None and found[1]:
            self.control.update(found[1])
        self.samperr_fb = int(out["samperr"])

        rdbi = bool(self.control.get("rdbi", 0))
        pids1_disabled = (self.psmi == C.SERVICE_MODE_MA1) and rdbi
        pids_bits = am_pids_decode(out["pids"], pids1_disabled)
        self.on_frame(-1, pids_bits.cpu().numpy(), 0.0)

        bc = self.bc
        self._mats[bc] = [out[k] for k in _MATRICES]
        if bc == 7:
            # blocks 0-7 of the frame (the lock is at bc 0, so all are in)
            mats = [torch.cat([b[i] for b in self._mats]) for i in range(4)]
            p1, p3, margins, self.dec_state = am_frame_decode(
                *mats, self.dec_state, ma3)
            if self.diversity_wait > 0:
                self.diversity_wait -= 1
            if self.diversity_wait == 0:
                # deliver one subframe per later block: the reference
                # decodes subframe bc during block bc of the next frame
                # (src/decode.c:507-517), which paces the elastic buffer
                p1 = p1.cpu().numpy()
                pm = margins["p1"].cpu().numpy()
                self._p1_queue = [(p1[i], float(pm[i])) for i in range(8)]
                if not rdbi:
                    self.on_frame(3, p3.cpu().numpy(),
                                  float(margins["p3"]))
        self.bc = (self.bc + 1) % 8

    def _drain_p1(self):
        if self._p1_queue:
            bits, margin = self._p1_queue.pop(0)
            self.on_frame(0, bits, margin)

    def flush(self):
        """Deliver any queued subframes (end of a finite capture)."""
        while self._p1_queue:
            self._drain_p1()
            self.on_event("block", {})
