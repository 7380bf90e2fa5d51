"""The per-block FM receiver: ring buffer + sync state machine.

PyTorch counterpart of ``nrsc5_tpu/pipeline/receiver.py``.  The device
side is the complex acquire, sync and decode functions of
:mod:`nrsc5_tpu_torch.ops`; this receiver owns the variable-rate sample
ring, the NONE/COARSE/FINE state machine (reference: src/input.c:172-188),
the CFO wait, block-count tracking, the MER aggregation and the P1, PIDS
and PX frame assembly (reference: src/decode.c:378-437).  Decoded frame
bits go to ``on_frame(channel, bits, margin)`` as numpy arrays (-1 PIDS,
0 P1, 1 PX1, 2 PX2); the byte-level transport lives in
:mod:`nrsc5_tpu_torch.transport`.

This is the correctness path, one block a call and a read-back each: on a
card each block runs K17 (``acquire_fm``'s demodulation, after the coarse
timing on a COARSE block) and K18 (``sync_fm_step``) at one station, then
``pids_decode`` on [1, 23040] (K6, K7, K8), each P1 frame ``p1_decode`` on
[1, 368640] (K6, K7, K8) and each PX block pair ``px_decode`` (K11, K7,
K8).  The fused paths are :mod:`nrsc5_tpu_torch.pipeline.turbo` (a frame a
call) and the serving receiver (:mod:`nrsc5_tpu_torch.serve`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.acquire import (WINDOW_FM, AcquireState, acquire_fm,
                                         acquire_init_state)
from nrsc5_tpu_torch.ops.decode_fm import p1_decode, pids_decode, px_decode
from nrsc5_tpu_torch.ops.detect_cfo import CFO_RANGE, detect_cfo_scan
from nrsc5_tpu_torch.ops.sync_fm import (SyncState, sync_fm_step,
                                         sync_init_state)

SYNC_NONE, SYNC_COARSE, SYNC_FINE = 0, 1, 2


def mer_db(signal: float, error: float) -> float:
    """10·log10(signal / error), 0 for no error (src/sync.c:486-501)."""
    return 10 * np.log10(signal / error) if error > 0 else 0.0


@dataclass
class _PxChannel:
    frame_len: int
    device: torch.device
    internal: torch.Tensor = None
    call_phase: int = 0
    started: bool = False
    ready: bool = False
    pending: list = field(default_factory=list)

    def reset(self):
        _, n, _ = IL.p3_iv_tables(self.frame_len)
        self.internal = torch.zeros(n, dtype=torch.int8, device=self.device)
        self.call_phase = 0
        self.started = False
        self.ready = False
        self.pending = []


class FMReceiver:
    """Streaming FM NRSC-5 layer-1 receiver on ``device`` (default
    ``"cuda"``, which raises with no card; ``"cpu"`` runs the plain
    versions)."""

    def __init__(self, on_frame: Callable[[int, np.ndarray, float], None],
                 on_event: Callable[[str, dict], None] | None = None, *,
                 device="cuda"):
        self.on_frame = on_frame
        self.on_event = on_event or (lambda kind, info: None)
        self.device = K.resolve_device(device)
        self.ring = np.zeros(0, np.complex64)
        self._fe_state = FE.frontend_init_state(1, device=self.device)
        self._cu8_leftover = np.zeros(0, np.uint8)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        self.acq_state: AcquireState = acquire_init_state(device=self.device)
        self.sync_arrays: SyncState = sync_init_state(device=self.device)
        self.sync_state = SYNC_NONE
        self.psmi = 1
        self.bc = 0
        self.cfo = 0
        self.cfo_wait = 0
        self.keep_extra = 0
        self.samperr_fb = 0
        self.angle_fb = 0.0
        self.started_pm = False
        self.pm_blocks: list = [None] * C.P1_FM_BLOCKS
        self.px1 = _PxChannel(C.P3_FRAME_LEN_MP3_MP11, self.device)
        self.px2 = _PxChannel(C.P3_FRAME_LEN_MP3_MP11, self.device)
        self.blocks_processed = 0
        self.mer_acc = [0.0, 0.0]
        self.mer_cnt = 0

    def _reset_decode(self):
        self.started_pm = False
        self.pm_blocks = [None] * C.P1_FM_BLOCKS
        cm = C.COMPATIBILITY_MODE[self.psmi]
        px_len = C.P3_FRAME_LEN_MP2 if cm == 2 else C.P3_FRAME_LEN_MP3_MP11
        self.px1 = _PxChannel(px_len, self.device)
        self.px2 = _PxChannel(C.P3_FRAME_LEN_MP3_MP11, self.device)
        self.px1.reset()
        self.px2.reset()

    def resync(self):
        """Hard resync (reference: src/frame.c:535-540)."""
        if self.sync_state == SYNC_FINE:
            self.on_event("lost_sync", {})
        self.sync_state = SYNC_NONE
        self.acq_state = acquire_init_state(device=self.device)
        self.sync_arrays = sync_init_state(device=self.device)
        self.cfo = 0
        self.cfo_wait = 0
        self.samperr_fb = 0
        self.angle_fb = 0.0
        self._reset_decode()

    # ------------------------------------------------------------------
    def push_cs16(self, samples: np.ndarray):
        """Feed complex baseband at 744187.5 S/s."""
        self.ring = np.concatenate([self.ring,
                                    np.asarray(samples, np.complex64)])
        while len(self.ring) >= WINDOW_FM:
            self._process_block()

    def decimate_cu8(self, data: np.ndarray) -> np.ndarray:
        """Interleaved cu8 at 1488375 S/s (the SDR ingest rate; reference:
        src/input.c:96-117) -> complex64 at the chain rate on the host:
        the conversion and the ÷2 halfband on the device, over the carried
        leftover bytes and filter tail."""
        data = np.concatenate([self._cu8_leftover,
                               np.asarray(data, np.uint8)])
        usable = len(data) & ~3  # 4 bytes -> 2 complex in -> 1 out
        self._cu8_leftover = data[usable:]
        if usable == 0:
            return np.zeros(0, np.complex64)
        x = FE.cu8_to_cf(torch.from_numpy(data[:usable]).to(self.device))
        y, self._fe_state = FE.fm_decimate(x, self._fe_state)
        return y.cpu().numpy()

    def push_cu8(self, data: np.ndarray):
        self.push_cs16(self.decimate_cu8(data))

    def _process_block(self):
        self.on_event("block", {})  # output clock (reference: acquire.c:108)
        window = torch.from_numpy(self.ring[:WINDOW_FM]).to(self.device)
        fine = self.sync_state == SYNC_FINE
        spectra, self.acq_state, samperr, _, keep = acquire_fm(
            window, self.acq_state, fine, self.samperr_fb, self.angle_fb,
            self.cfo)
        self.samperr_fb = 0
        self.angle_fb = 0.0
        if self.sync_state == SYNC_NONE:
            self.sync_state = SYNC_COARSE

        timing_adj = C.FFTCP_FM // 2 - samperr
        prev_sync = self.sync_arrays
        psmi_used = self.psmi
        out, self.sync_arrays = sync_fm_step(spectra, prev_sync, psmi_used,
                                             timing_adj)

        consumed = WINDOW_FM - (int(keep) + self.keep_extra)
        self.keep_extra = 0
        self.ring = self.ring[consumed:]
        self.blocks_processed += 1

        if self.sync_state == SYNC_COARSE:
            self._coarse_step(out, spectra)
            if self.sync_state == SYNC_FINE and self.psmi != psmi_used:
                # the lock block itself is demodulated with the latched
                # service mode (it is bc=0 of the PX cycle)
                out, self.sync_arrays = sync_fm_step(
                    spectra, prev_sync, self.psmi, timing_adj)
        if self.sync_state == SYNC_FINE:
            self._fine_step(out)

    # ------------------------------------------------------------------
    def _coarse_step(self, out, spectra):
        ok = out["ref_ok"].cpu().numpy()
        good = int(ok.sum())
        if good >= 4:
            bcs = out["ref_bc"].cpu().numpy()[ok]
            psmis = out["ref_psmi"].cpu().numpy()[ok]
            bc_vals, bc_counts = np.unique(bcs, return_counts=True)
            ps_vals, ps_counts = np.unique(psmis, return_counts=True)
            maj_bc = bc_vals[np.argmax(bc_counts)] \
                if bc_counts.max() > good // 2 else -1
            maj_ps = ps_vals[np.argmax(ps_counts)] \
                if ps_counts.max() > good // 2 else -1
            if maj_bc >= 0 and maj_ps >= 0:
                self.bc = int(maj_bc)
                self.psmi = int(maj_ps)
                self.sync_state = SYNC_FINE
                self._reset_decode()
                self.on_event("sync", {"psmi": self.psmi})
                return
        if self.cfo_wait == 0:
            count = detect_cfo_scan(spectra).cpu().numpy()  # [76, 32]
            for ci in range(count.shape[0]):
                best = int(np.argmax(count[ci]))
                if count[ci, best] >= 3:
                    self.keep_extra = ((C.BLKSZ - best) % C.BLKSZ) \
                        * C.FFTCP_FM
                    self.cfo += ci - CFO_RANGE
                    self.cfo_wait = 8
                    break
        else:
            self.cfo_wait -= 1

    # ------------------------------------------------------------------
    def _fine_step(self, out):
        self.samperr_fb = int(out["samperr"])
        self.angle_fb = float(out["angle"])

        # MER aggregation (reference: src/sync.c:486-501)
        self.mer_acc[0] += float(out["error_lb"])
        self.mer_acc[1] += float(out["error_ub"])
        self.mer_cnt += 1
        if self.mer_cnt == 16:
            ppb = C.partitions_per_band(self.psmi)
            signal = 2 * C.BLKSZ * ppb * C.PARTITION_DATA_CARRIERS * 16
            self.on_event("mer", {"lower": mer_db(signal, self.mer_acc[0]),
                                  "upper": mer_db(signal, self.mer_acc[1])})
            self.mer_acc = [0.0, 0.0]
            self.mer_cnt = 0

        bc = self.bc
        pm_block = out["pm"]

        # PIDS: every block (reference: src/decode.c:463-472)
        self.on_frame(-1, pids_decode(pm_block[None])[0].cpu().numpy(), 0.0)

        # P1 accumulation (reference: src/decode.c:378-391)
        self.pm_blocks[bc] = pm_block
        if bc == 0:
            self.started_pm = True
        if self.started_pm and bc == 15 and all(
                b is not None for b in self.pm_blocks):
            bits, margin, errors = p1_decode(torch.cat(self.pm_blocks)[None])
            self.on_event("ber", {
                "cber": float(errors[0]) / C.P1_FRAME_LEN_ENCODED_FM})
            self.on_frame(0, bits[0].cpu().numpy(), float(margin[0]))

        # PX1/PX2 (reference: src/decode.c:393-437).  As the reference
        # receiver does, the interleaver-IV cycle is anchored at bc == 0
        # (the C reference starts it at the first even bc after lock),
        # leaving only the standard's own two-frame cycle ambiguity.
        for px, key in ((self.px1, "px1"), (self.px2, "px2")):
            if key not in out:
                continue
            if bc == 0:
                px.started = True
            if bc % 2 == 0:
                if px.started:
                    px.pending = [out[key]]
            elif px.started and px.pending:
                px.pending.append(out[key])
                llrs = torch.cat(px.pending)
                px.pending = []
                # the reference marks the interleaver ready at the start
                # of the call after a full cycle (src/decode.c:355-359)
                ready_now = px.ready
                bits, margin, px.internal = px_decode(
                    px.internal, llrs, px.call_phase, px.frame_len)
                _, _, calls = IL.p3_iv_tables(px.frame_len)
                px.call_phase += 1
                if px.call_phase == calls:
                    px.call_phase = 0
                    px.ready = True
                if ready_now:
                    chan = 1 if key == "px1" else 2
                    self.on_frame(chan, bits.cpu().numpy(), float(margin))

        self.bc = (self.bc + 1) % 16
