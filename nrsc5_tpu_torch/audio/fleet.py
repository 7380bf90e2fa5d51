"""Fleet audio: batched device PCM for a served multi-station receiver.

The port's copy of the reference package's ``audio/fleet.py``.  The
reference decodes audio with one FAAD2 instance per subscribed program on
the host (src/output.c:100-168, MAX_PROGRAMS=8).  :class:`FleetAudioDecoder`
sits on a :class:`~nrsc5_tpu_torch.serve.MultiStationReceiver`'s (or
:class:`~nrsc5_tpu_torch.serve.HeterogeneousReceiver`'s) event stream,
collects each station's program HDC packets, and decodes them in batches
through :class:`~nrsc5_tpu_torch.audio.batch.BatchedAudioDecoder`: the
host half (``prepare``: the parse, native where the host library is
built, and the input arrays) on one worker thread, the device half
(``dispatch``: K16a-d and the PCM read-back) on a second, so that neither
blocks the receiver's sample-ingest callback.  It emits AUDIO events
tagged with their station and program.

Multi-program: the batch has one lane row per (station, program slot).
Subscribe explicitly (``programs=(0, 1)``: every station decodes those
program numbers) or with ``programs="auto"``: each station gets
``max_programs`` slots, assigned to program numbers in order of first HDC
appearance (the reference's per-program codec made on first audio,
src/output.c:126-163).  Slots not yet assigned ride each dispatch as
silence lanes and emit nothing.

A (station, program) that stops producing packets (a dead carrier, a
relock, a program signed off) does not stall the fleet: once the deepest
queue is ``max_lag`` packets ahead of the shallowest, lagging rows are
padded with silence packets, each of which emits a real silence AUDIO
frame (the reference's per-missing-packet silence, src/output.c:148-162),
so every row's timeline stays aligned and no queue grows without bound.

Usage::

    fleet_audio = FleetAudioDecoder(n_stations, callback, programs=(0,))
    rx = MultiStationReceiver(n_stations, fleet_audio.wrap,
                              hdc_factory=None, ...)
    ...push samples...
    rx.flush(); fleet_audio.flush()

``hdc_factory=None`` turns the per-station host codec off (the HDC packet
events still flow: this class consumes them).

The decoder's device state belongs to the dispatch thread.  Its device
work holds :data:`nrsc5_tpu_torch.pipeline.block_graph.CAPTURE_LOCK`, which
every CUDA graph capture holds too, so that no capture by the receiver's
thread is open while this thread launches, allocates or copies.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from nrsc5_tpu_torch.api.events import Event, EventType, make
from nrsc5_tpu_torch.audio.batch import BatchedAudioDecoder


class FleetAudioDecoder:
    """Batch-decode the subscribed programs' HDC streams per station.

    callback(station, event) receives every event forwarded from the
    receiver plus the AUDIO events this class makes (those arrive from the
    dispatch thread, tagged ``program``; per (station, program) in order).
    ``k`` packets per row per device dispatch (~k · 46.4 ms of audio
    latency).  Corrupt packets decode to silence, as in the reference
    (src/output.c:148-162).  ``max_lag`` bounds how far the deepest
    assigned queue may run ahead of the shallowest before lagging rows
    are silence-padded; it must exceed one L1 frame's packets (32), which a
    healthy receiver emits station by station, and the default 64 (~3 s of
    audio) fires only for a stalled row.  ``max_pending`` bounds the decode
    backlog: past it a batch is shed, emitted as silence frames in order
    without a dispatch.

    ``programs``: a tuple of program numbers every station subscribes to,
    or ``"auto"`` to discover up to ``max_programs`` a station from the HDC
    stream; ``program=`` is ``programs=(program,)``.  ``device`` (default
    ``"cuda"``, which raises with no card) is where the batches decode.
    """

    def __init__(self, n_stations: int, callback, program: int = 0,
                 k: int = 8, device="cuda", max_lag: int | None = None,
                 max_pending: int = 256,
                 programs: tuple | str | None = None,
                 max_programs: int = 2):
        self.n = n_stations
        self._cb = callback
        self._auto = programs == "auto"
        if self._auto:
            self.slots = max_programs
        else:
            self._programs = tuple(programs) if programs is not None \
                else (program,)
            self.slots = len(self._programs)
        self.rows = n_stations * self.slots
        self._k = k
        self._max_lag = 64 if max_lag is None else max_lag
        # the default absorbs a first dispatch's set-up (kernel builds and
        # loads) without shedding: 256 batches of k=8 ≈ 95 s of audio
        self._max_pending = max_pending
        self._dec = BatchedAudioDecoder(self.rows, device=device)
        self._queues: list[list[bytes]] = [[] for _ in range(self.rows)]
        # per-row program number; -1 = auto slot not yet assigned.
        # Explicit subscriptions are assigned (and blocking) from the start
        if self._auto:
            self._row_prog = np.full(self.rows, -1, np.int64)
        else:
            self._row_prog = np.asarray(
                list(self._programs) * n_stations, np.int64)
        # a packet that always parses to silence (the batch decoder's
        # corrupt-packet lane)
        self._silence = b""
        self._lock = threading.Lock()
        self._work: queue.Queue = queue.Queue()
        # the prepared stage of the two-thread pipeline: the host half of
        # the next batch overlaps the device half of this one; bounded so
        # that prepare cannot run far ahead (each item holds ~2 MB)
        self._disp: queue.Queue = queue.Queue(maxsize=2)
        self._worker: threading.Thread | None = None
        self._dispatcher: threading.Thread | None = None
        self._err: BaseException | None = None

    # ------------------------------------------------------------------
    def _row_of(self, station: int, program: int) -> int | None:
        """(station, program) -> batch row, assigning an auto slot on first
        appearance.  Caller holds self._lock."""
        base = station * self.slots
        for s in range(self.slots):
            if self._row_prog[base + s] == program:
                return base + s
        if not self._auto:
            return None
        for s in range(self.slots):
            if self._row_prog[base + s] < 0:
                self._row_prog[base + s] = program
                return base + s
        return None  # the station already has max_programs

    def _fail(self, err: BaseException) -> None:
        """Record a worker's error for the next wrap or flush.  Under the
        lock, so that of two threads failing together the first keeps its
        error (the root cause); the reference checks and sets it from both
        threads without one."""
        with self._lock:
            if self._err is None:
                self._err = err

    def _raise_err(self):
        """Raise (once) an error a worker hit, before any queue changes, so
        that no batch is popped and lost to a stale error."""
        with self._lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def wrap(self, station: int, event: Event):
        """The receiver's callback: take the HDC packets, forward every
        event.  Only queue bookkeeping happens here; popping and submitting
        both happen under the lock, so that the workers decode in pop
        order."""
        self._raise_err()
        if event.type == EventType.HDC:
            # the transport always sets ``program``; without it, the first
            # subscribed program
            default = self._programs[0] if not self._auto else 0
            prog = int(getattr(event, "program", default))
            data = bytes(event.data) if not event.crc_error \
                else self._silence
            with self._lock:
                row = self._row_of(station, prog)
                if row is not None:
                    self._queues[row].append(data)
                    batch = self._take_ready_locked()
                    if batch is not None:
                        self._submit_locked(batch)
        self._cb(station, event)

    # ------------------------------------------------------------------
    def _take_ready_locked(self):
        """Pop and return a k-deep batch if one is ready (padding lagging
        assigned rows once the spread exceeds max_lag; unassigned auto
        slots never block and ride as silence), else None.  Caller holds
        self._lock."""
        lens = [len(q) for q in self._queues]
        live = [i for i in range(self.rows) if self._row_prog[i] >= 0]
        if not live:
            return None
        depth = min(lens[i] for i in live)
        k = self._k
        if depth < k and max(lens[i] for i in live) - depth > self._max_lag:
            # a starving row holds the fleet back: pad it with silence up to
            # a dispatchable depth (a real gap gives silence frames)
            target = min(k, max(lens[i] for i in live))
            for i in live:
                if lens[i] < target:
                    self._queues[i] += \
                        [self._silence] * (target - lens[i])
            depth = target
        if depth < k:
            return None
        batch, emit = [], []
        for i in range(self.rows):
            if self._row_prog[i] >= 0:
                batch.append(self._queues[i][:k])
                del self._queues[i][:k]
                emit.append(k)
            else:  # unassigned auto slot: a silence lane, no output
                batch.append([self._silence] * k)
                emit.append(0)
        return (batch, emit)

    def _submit_locked(self, item, shed_ok: bool = True):
        """Queue a popped batch for the workers.  Caller holds self._lock.
        Over the pending bound the batch is shed: a marker rides the same
        queue so that its silence frames come out in order."""
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, name="fleet-audio-prep", daemon=True)
            self._worker.start()
            self._dispatcher = threading.Thread(
                target=self._run_dispatch, name="fleet-audio-dispatch",
                daemon=True)
            self._dispatcher.start()
        batch, lens = item
        # both stages count against the bound
        if shed_ok and (self._work.qsize() + self._disp.qsize()
                        >= self._max_pending):
            self._work.put((None, (lens, self._row_prog.copy())))
        else:
            self._work.put((batch, (lens, self._row_prog.copy())))

    def _run(self):
        """The prepare stage: the parse and the input arrays (host half)."""
        while True:
            item = self._work.get()
            try:
                if item is None:
                    self._disp.put(None)
                    return
                batch, meta = item
                prepared = None if batch is None \
                    else self._dec.prepare(batch)
                self._disp.put((prepared, batch is not None, meta))
            except BaseException as e:  # surfaced by the next flush/wrap
                self._fail(e)
            finally:
                self._work.task_done()

    def _run_dispatch(self):
        """The dispatch stage: the device run, the PCM read-back and the
        AUDIO events, strictly in preparation order (the decoder's carried
        state is sequential)."""
        while True:
            item = self._disp.get()
            try:
                if item is None:
                    return
                prepared, real, (lens, progs) = item
                if not real:  # shed under overload: silence frames
                    z = np.zeros(4096, np.int16)
                    for i in range(self.rows):
                        for _ in range(lens[i]):
                            self._cb(i // self.slots, make(
                                EventType.AUDIO, program=int(progs[i]),
                                samples=z))
                else:
                    self._emit(self._dec.dispatch(prepared), lens, progs)
            except BaseException as e:  # surfaced by the next flush/wrap
                self._fail(e)
            finally:
                self._disp.task_done()

    def _emit(self, pcm, emit_lens, progs):
        for i in range(self.rows):
            for j in range(emit_lens[i]):
                self._cb(i // self.slots, make(
                    EventType.AUDIO, program=int(progs[i]),
                    samples=pcm[i, j * 2048:(j + 1) * 2048].reshape(-1)))

    def flush(self):
        """Decode whatever is queued (rows short of the common depth are
        padded with silence packets whose output is dropped) and wait until
        the workers have drained: after flush() every queued packet's AUDIO
        event has been delivered.  The final batch is never shed."""
        with self._lock:
            depth = max((len(q) for q in self._queues), default=0)
            if depth > 0:
                lens = [len(q) for q in self._queues]
                for i in range(self.rows):
                    self._queues[i] += [self._silence] * (depth - lens[i])
                batch = [self._queues[i][:depth] for i in range(self.rows)]
                self._queues = [[] for _ in range(self.rows)]
                self._submit_locked((batch, lens), shed_ok=False)
        if self._worker is not None:
            self._work.join()
            self._disp.join()
        self._raise_err()

    def close(self):
        """Stop the worker threads (flush first if the output matters)."""
        if self._worker is not None:
            self._work.put(None)
            self._worker.join()
            self._dispatcher.join()
            self._worker = None
            self._dispatcher = None

    # ------------------------------------------------------------------
    # checkpoint / resume, under the reference's key names
    # ------------------------------------------------------------------
    def checkpoint(self) -> dict:
        """Drain the in-flight decodes, then snapshot the decoder's state
        (``BatchedAudioDecoder.checkpoint``), the undecoded per-row packet
        queues and the auto program-slot map as named numpy arrays.  Both
        queues are drained and found empty under the lock before the
        device state is read, so no dispatch runs during the snapshot (a
        wrap() racing between the join and the lock retries the drain)."""
        while True:
            if self._worker is not None:
                self._work.join()
                self._disp.join()
            with self._lock:
                if self._worker is None \
                        or (self._work.unfinished_tasks == 0
                            and self._disp.unfinished_tasks == 0):
                    out = self._dec.checkpoint()
                    out["row_prog"] = self._row_prog.copy()
                    for i, q in enumerate(self._queues):
                        out[f"q_{i}"] = \
                            np.frombuffer(b"".join(q), np.uint8) \
                            if q else np.zeros(0, np.uint8)
                        out[f"qlen_{i}"] = np.asarray(
                            [len(pk) for pk in q], np.int64)
                    return out

    def restore(self, state):
        """Install a :meth:`checkpoint` snapshot (dict or NpzFile, of this
        package or the reference's) into this fresh decoder of the same
        parameters."""
        self._dec.restore(state)
        queues = []
        for i in range(self.rows):
            flat = np.asarray(state[f"q_{i}"], np.uint8).tobytes()
            q, pos = [], 0
            for ln in np.asarray(state[f"qlen_{i}"]):
                q.append(flat[pos:pos + int(ln)])
                pos += int(ln)
            queues.append(q)
        with self._lock:
            self._queues = queues
            if "row_prog" in state:  # absent in single-program saves
                self._row_prog = np.asarray(
                    state["row_prog"], np.int64).copy()

    def save(self, path: str):
        """Persist to an ``.npz`` that a fresh decoder of either package
        restores with ``load``."""
        np.savez(path, **self.checkpoint())

    def load(self, path: str):
        with np.load(path) as data:
            self.restore(data)
