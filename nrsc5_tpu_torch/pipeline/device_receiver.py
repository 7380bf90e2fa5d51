"""The session's radio on the port's device chain: the reference's
``nrsc5_tpu/pipeline/device_receiver.py``.

:class:`DeviceReceiver` buffers one station's input on the host until a
cold start locks from unknown timing and CFO, discovering the service mode
(:func:`~nrsc5_tpu_torch.pipeline.scan_chain_rc.cold_start_rc` for FM,
:func:`~nrsc5_tpu_torch.pipeline.scan_chain_am_rc.cold_start_am_rc` for
AM), then hands the stream to a one-station
:class:`~nrsc5_tpu_torch.serve.MultiStationReceiver` built from the lock.
Signal loss afterwards is the receiver's own relock watchdog's (the
serving analog of the reference session's NONE→COARSE→FINE machine,
reference src/input.c:172-188).

cu8 runs through K1 on the device (the FM ÷2 halfband, or the AM ÷32
cascade) a push at a time, over a carried tail of raw pairs; the chain
input comes back to the host, as in the reference, and is queued there.

Transport events flow from the receiver's station transport.  A hard
resync the session's transport asks for (:meth:`DeviceReceiver.resync`)
forces the receiver's relock watchdog, as the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.api.events import EventType, make
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len
from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len
from nrsc5_tpu_torch.serve import MultiStationReceiver


class DeviceReceiver:
    """The session's ``radio`` (reset / push_cs16 / push_cu8 / flush),
    decoding on ``device`` (default ``"cuda"``, which raises with no card;
    ``"cpu"`` runs the plain versions), one frame a dispatch."""

    def __init__(self, emit, mode_fm: bool = True, hdc_factory=None,
                 device="cuda"):
        self._emit = emit
        self._fm = mode_fm
        self._hdc = hdc_factory
        self.device = K.resolve_device(device)
        self._stages = 1 if mode_fm else FE.AM_STAGES
        self._overlap = FE.rc_overlap(self._stages)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        self._rx = None
        self._buf: list[np.ndarray] = []  # internal-rate rc, conjugated
        self._nbuf = 0
        self._pushed = 0
        self._probe_after = 0
        # the cascade's history of raw pairs, 127-filled at stream start
        self._cu8_tail = np.full((self._overlap, 2), 127, np.uint8)
        self._cu8_lo = None  # partial wire I/Q pair byte

    # ------------------------------------------------------------------
    def _probe_need(self) -> int:
        return buffer_len(6) if self._fm else am_buffer_len(3)

    def _try_lock(self):
        need = self._probe_need()
        if self._nbuf < need or self._pushed < self._probe_after:
            return
        whole = np.concatenate(self._buf) if len(self._buf) > 1 \
            else self._buf[0]
        if self._fm:
            lock = rcc.cold_start_rc(whole[:need], device=self.device)
        else:
            lock = scar.cold_start_am_rc(whole[:need], device=self.device)
        if lock is None:
            # retry once fresh samples arrive; cap the garbage backlog
            self._probe_after = self._pushed + need
            self._buf = [whole[-need:]]
            self._nbuf = len(self._buf[0])
            return
        whole = whole[int(lock["offset"]):]
        self._buf, self._nbuf = [], 0

        def cb(_station, ev):
            self._emit(ev)

        if self._fm:
            self._rx = MultiStationReceiver(
                1, cb, frames_per_dispatch=1, psmi=int(lock["psmi"]),
                locks=[lock], hdc_factory=self._hdc, device=self.device)
        else:
            self._rx = MultiStationReceiver(
                1, cb, frames_per_dispatch=1, mode="am",
                ma3=bool(lock["ma3"]), locks=[lock],
                hdc_factory=self._hdc, device=self.device)
        self._emit(make(EventType.SYNC, psmi=int(lock["psmi"])))
        if len(whole):
            self._rx.push(0, whole)

    def _push_rc(self, rc: np.ndarray):
        self._pushed += len(rc)
        if self._rx is not None:
            self._rx.push(0, rc)
            return
        self._buf.append(np.ascontiguousarray(rc, np.float32))
        self._nbuf += len(rc)
        self._try_lock()

    # ------------------------------------------------------------------
    # the session's radio interface
    # ------------------------------------------------------------------
    def push_cs16(self, samples: np.ndarray):
        """complex64 at the internal rate (the session converts cs16)."""
        s = np.asarray(samples, np.complex64)
        rc = np.empty((len(s), 2), np.float32)
        rc[:, 0] = s.real
        rc[:, 1] = -s.imag if self._fm else s.imag
        self._push_rc(rc)

    def push_cu8(self, data: np.ndarray):
        """Raw interleaved cu8 at 1.488 MS/s: the ÷2 (FM) / ÷32 (AM)
        halfband cascade runs on the device (K1, overlap-save, zero net
        group delay — the serve ingest convention).  K1 gets a whole
        number of output samples (FM [1, 14 + 2N, 2], AM [1, 434 + 32N,
        2]); a push too short for one waits in the tail and launches
        nothing."""
        flat = np.asarray(data, np.uint8).reshape(-1)
        if self._cu8_lo is not None:  # carry partial I/Q pairs
            flat = np.concatenate([self._cu8_lo, flat])
        if len(flat) % 2:
            self._cu8_lo = flat[-1:].copy()
            flat = flat[:-1]
        else:
            self._cu8_lo = None
        buf = np.concatenate([self._cu8_tail, flat.reshape(-1, 2)])
        rate = 1 << self._stages
        n = (len(buf) - self._overlap) // rate * rate + self._overlap
        self._cu8_tail = buf[n - self._overlap:]
        if n <= self._overlap:
            return
        wire = torch.from_numpy(buf[None, :n]).to(self.device)
        ingest = FE.ingest_fm_cu8 if self._fm else FE.ingest_am_cu8
        self._push_rc(ingest(wire)[0].cpu().numpy())

    def flush(self):
        if self._rx is not None:
            self._rx.flush()

    def resync(self):
        """Transport-triggered hard resync (reference: src/frame.c:535-540):
        force the receiver's watchdog into re-acquisition and emit
        LOST_SYNC; before the first lock, and while already re-acquiring,
        there is nothing to force."""
        rx = self._rx
        if rx is not None and not rx._relocking[0]:
            rx._bad_frames[0] = 0
            rx._relocking[0] = True
            rx._relock_next[0] = 0
            self._emit(make(EventType.LOST_SYNC))

