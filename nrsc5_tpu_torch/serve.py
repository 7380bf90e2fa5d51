"""Multi-station serving: the reference's ``nrsc5_tpu/serve.py``
``MultiStationReceiver`` (lines 211-981) and its device half, FM and AM.

The device half: the ingest (cu8, cs16 or cf32 in either mode), the
steady dispatches :func:`chain_step` (FM) and :func:`chain_step_am` (AM),
whose ingest and block loop replay one CUDA graph per dispatch shape on a
card (K5, :mod:`nrsc5_tpu_torch.pipeline.block_graph`) before the FEC, and
the cold starts :func:`cold_start` (the AM probe block a graph too).

The receiver, :class:`MultiStationReceiver`: per-station sample queues
with the cu8 history and the partial byte pairs (``push``, ``drain``,
``flush``), dispatches with their outputs held ``depth`` deep, the host
transport of every station (``_StationTransport``: the frame, PIDS and
output layers, copies of the reference's, emitting its events), the
per-station FM frame alignment after a lock, the watchdogs (FM: channel BER
and the K=7 margin; AM: the K=9 margin, outside the diversity warm-up),
relock by a cold start on the station's queue, ``cold_start=True``, and
``checkpoint``/``restore``/``save``/``load`` under the reference's names
and carry order, so that either package resumes the other's file, and
``mesh`` (the station axis sharded over several devices, each running its
share of every dispatch).

The fleets (the reference's lines 984-1520): :class:`HeterogeneousReceiver`
groups stations by (band, service mode), one :class:`MultiStationReceiver`
a group, declared or discovered on the card from each station's cu8
stream; :class:`RtlTcpFleet` feeds either receiver from rtl_tcp tuners,
one reader thread a tuner.

The native wire is the reference's 1.488 MS/s cu8 format.  Each station's
row holds ``rc_overlap(stages) // 2`` pairs of history ahead of its logical
stream position (127-valued at stream start, :func:`stream_wire`), so the
stateless halfband cascade has zero net group delay: 7 pairs for FM's ÷2
(then ``2 · buffer_len(n_blocks)`` pairs), 217 for AM's ÷32 (then ``32 ·
am_buffer_len(n_frames)``).  A 1.488 MS/s cu8 AM wire at a tuner's level
decodes through the ÷32 cascade (K1's AM cascade, inside each dispatch's
graph): tests/test_torch_serve_modes.py:131, the twin of
tests/test_serve.py:339, gets at least 64 exact HDC packets from one, and
tests/test_serve.py:1563 cold-starts MA1 and MA3 stations from cu8 and
decodes both.  (tests/test_l1_am.py:92-100, which says cu8 AM cannot
reach sync, concerns the per-block complex ``AMReceiver`` only, not this
chain.)  cs16 is scaled by 1/32768 and cf32, rc float32, passes through,
in either mode, at the chain's own rate.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch import state as ST
from nrsc5_tpu_torch.api.events import Event, EventType, make
from nrsc5_tpu_torch.ops import decode_am as DA
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.bits import unpack_out
from nrsc5_tpu_torch.pipeline import block_graph
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.pipeline.scan_chain import (buffer_len, px_frame_lens,
                                                 tree_leaves, tree_rebuild)
from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len
from nrsc5_tpu_torch.transport import frame as TF
from nrsc5_tpu_torch.transport.output import Output
from nrsc5_tpu_torch.transport.pids import PIDSDecoder


def wire_pairs(n_blocks: int) -> int:
    """cu8 pairs per station that one FM dispatch of ``n_blocks`` reads."""
    return FE.rc_overlap(1) + 2 * buffer_len(n_blocks)


def ingest(wire, mode: str = "fm", *, device="cuda",
           plain: bool = False) -> torch.Tensor:
    """Wire [S, L, 2] (array or tensor) -> chain input float32 [S, N, 2] on
    ``device``, by the wire's dtype:

    - uint8, cu8 at 1.488 MS/s: (u − 127)·64/32767, then for
      ``mode="fm"`` Q negated and the ÷2 halfband (K1; L = 14 + 2N), for
      ``mode="am"`` × 1/16 and the five-stage ÷32 cascade (K1's AM
      cascade; L = 434 + 32N); ``plain=True`` runs the plain versions;
    - int16, cs16 at the chain's rate: × 1/32768, exact (a power of two);
    - float32, cf32 rc at the chain's rate: passes through unchanged."""
    if mode not in ("fm", "am"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = K.resolve_device(device)
    wire = torch.as_tensor(wire, device=dev)
    if wire.ndim != 3 or wire.shape[-1] != 2:
        raise ValueError(f"wire: expected [S, L, 2], got "
                         f"{tuple(wire.shape)}")
    if wire.dtype == torch.float32:
        return wire
    if wire.dtype == torch.int16:
        return wire.float() * (1.0 / 32768.0)
    if wire.dtype != torch.uint8:
        raise ValueError(f"wire dtype {wire.dtype}: expected uint8 (cu8), "
                         f"int16 (cs16) or float32 (cf32)")
    if mode == "am":
        return (FE.ingest_am_cu8_plain if plain else FE.ingest_am_cu8)(wire)
    return (FE.ingest_fm_cu8_plain if plain else FE.ingest_fm_cu8)(wire)


# the carry fields a block loop reads; the graph's static inputs
_FM_LOOP = ("offset", "phase", "prev_angle", "costas_phase", "costas_freq",
            "samperr_fb", "angle_fb", "cfo")
_AM_LOOP = ("offset", "phase", "prev_angle", "samperr_fb", "cfo")


def _fm_loop(n_blocks: int, psmi: int, dev: torch.device):
    def body(wire, **fields):
        carry = rcc.ChainCarryRC(**fields, px1_internal=None, px1_phase=None,
                                 px2_internal=None, px2_phase=None)
        return rcc.scan_blocks(ingest(wire, device=dev), carry, n_blocks,
                               psmi)
    return body


def _am_loop(n_blocks: int, ma3: bool, dev: torch.device):
    def body(wire, **fields):
        carry = scar.AMChainCarryRC(**fields, dec=None)
        return scar.scan_blocks_am(ingest(wire, "am", device=dev), carry,
                                   n_blocks, ma3)
    return body


def _replay(kind: str, body, wire, carries, names, dev, *static) -> dict:
    """The ingest and block loop of one dispatch as the replay of its CUDA
    graph (captured on the first dispatch of its shapes)."""
    wire = torch.as_tensor(wire)
    inputs = {"wire": wire, **{k: getattr(carries, k) for k in names}}
    key = (kind, str(dev), tuple(wire.shape), wire.dtype) + static
    return block_graph.captured(key, body, inputs, dev)(**inputs)


def fm_front(wire, carries: rcc.ChainCarryRC, n_blocks: int,
             psmi: int = 1, *, device="cuda", plain: bool = False,
             graph: bool = True):
    """The ingest and the block loop of an FM dispatch (K1, then K2, the
    DFT, K4 and K5 a block) -> (pm, diag, px, new carry) as
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_rc.frontend_scan_rc` gives
    them.  On a card they are the replay of one CUDA graph for the
    dispatch's shapes, captured on its first use (``graph=False``: launched
    eagerly); ``plain=True`` runs every kernel's plain version, eagerly."""
    dev = K.resolve_device(device)
    if dev.type == "cuda" and graph and not plain:
        scanned = _replay("fm", _fm_loop(n_blocks, psmi, dev), wire,
                          carries, _FM_LOOP, dev, n_blocks, psmi)
        return rcc.finish_scan(scanned, carries)
    return rcc.frontend_scan_rc(ingest(wire, device=dev, plain=plain),
                                carries, n_blocks, psmi, plain)


def am_front(wire, carries: scar.AMChainCarryRC, n_blocks: int,
             ma3: bool = False, *, device="cuda", plain: bool = False,
             graph: bool = True):
    """The ingest and the block loop of an AM dispatch (K12, the DFT, K12,
    the DFT, K13 and K5 a block) -> (codes, pids codes, new carry) as
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.am_frontend_scan_rc`
    gives them; on a card the replay of one CUDA graph (``graph=False``:
    launched eagerly), and ``plain=True`` as for :func:`fm_front`."""
    dev = K.resolve_device(device)
    if dev.type == "cuda" and graph and not plain:
        scanned = _replay("am", _am_loop(n_blocks, ma3, dev), wire, carries,
                          _AM_LOOP, dev, n_blocks, bool(ma3))
        return scar.finish_scan_am(scanned, carries)
    return scar.am_frontend_scan_rc(
        ingest(wire, "am", device=dev, plain=plain), carries, n_blocks, ma3,
        plain)


def chain_step(wire_u8, carries: rcc.ChainCarryRC, n_blocks: int,
               psmi: int = 1, first_bc: int = 0, packed: bool = False, *,
               device="cuda", plain: bool = False, graph: bool = True,
               px: bool = True):
    """One dispatch for all stations: a wire of :func:`ingest`'s (cu8 [S,
    wire_pairs(n_blocks), 2] as the reference serves it) -> (out, new
    carries), with ``out`` as
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_rc.fm_chain_batch_rc` gives
    it.  The carries must lie on ``device``; ``new.offset`` holds the chain
    samples each station consumed (the caller advances its queue by twice
    that many wire pairs and rebases the offset to 0, as the reference
    receiver does).  On a card the ingest and the block loop are the
    replay of one CUDA graph for the dispatch's shapes (K5;
    ``graph=False`` launches them eagerly), then the FEC.  ``plain=True``
    runs every kernel's plain version, eagerly.  ``px=False`` skips the PX
    channels (the reference's frame-alignment dispatches)."""
    rcc.check_chain(carries, n_blocks, psmi, first_bc, px)
    front = fm_front(wire_u8, carries, n_blocks, psmi, device=device,
                     plain=plain, graph=graph)
    return rcc.fm_decode(*front, n_blocks, psmi, first_bc, packed, plain,
                         px)


def chain_step_am(wire, carries: scar.AMChainCarryRC, n_frames: int,
                  ma3: bool = False, packed: bool = False, *,
                  device="cuda", plain: bool = False, graph: bool = True):
    """One AM dispatch for all stations: a wire of :func:`ingest`'s with at
    least am_buffer_len(n_frames) chain samples a station (cs16 [S,
    am_buffer_len(n_frames), 2] as the reference serves it) -> (out, new
    carries), with ``out`` as
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.am_chain_batch_rc`
    gives it.  The carries must lie on ``device``; ``new.offset`` holds the
    chain samples each station consumed (the caller advances its queue by
    that many chain samples and rebases the offset to 0, as the reference
    receiver does).  On a card the ingest and the block loop are the
    replay of one CUDA graph for the dispatch's shapes (K5;
    ``graph=False`` launches them eagerly), then the gathers and FEC.
    ``plain=True`` runs every kernel's plain version, eagerly."""
    front = am_front(wire, carries, n_frames * C.P1_AM_BLOCKS, ma3,
                     device=device, plain=plain, graph=graph)
    return scar.am_decode(*front, carries, n_frames, ma3, packed, plain)


def cold_start(wire, mode: str = "fm", *, device="cuda",
               plain: bool = False, graph: bool = True) -> list:
    """Cold start of every station of a capture with unknown timing and
    CFO: a wire of :func:`ingest`'s (FM: cu8 [S, 14 + 2N, 2] in
    :func:`chain_step`'s layout; AM: cs16 [S, N, 2], or cu8 [S, 434 + 32N,
    2]) -> one lock per station, or None where a station did not lock
    (FM: :func:`nrsc5_tpu_torch.pipeline.scan_chain_rc.cold_start_rc`; AM:
    :func:`nrsc5_tpu_torch.pipeline.scan_chain_am_rc.cold_start_am_rc`,
    whose probe block replays a CUDA graph on a card unless ``graph`` is
    False).  Each lock's ``offset`` counts chain samples from the start of
    the station's stream.  ``plain=True`` runs every kernel's plain
    version."""
    samples = ingest(wire, mode, device=device, plain=plain)
    if mode == "am":
        return scar.cold_start_am_rc(samples, device=device, plain=plain,
                                     graph=graph)
    return rcc.cold_start_rc(samples, device=device, plain=plain)


def carry_from_locks(locks: list) -> tuple:
    """Stack the locks of :func:`cold_start` into one carry whose offsets
    are the lock points, so that :func:`chain_step` (FM) or
    :func:`chain_step_am` (AM) on the same wire decodes every station from
    its lock.  Returns (carry, psmi, first_bc) for FM locks and (carry,
    ma3) for AM locks (those with an ``"ma3"`` key).

    One dispatch serves one service mode and, through :func:`chain_step`,
    one block count (:class:`MultiStationReceiver` aligns each station
    itself instead), so this raises if a station did not lock, if the locks
    mix FM and AM, or if they disagree on psmi and first_bc (FM) or ma3
    (AM, as the reference receiver asserts)."""
    missing = [i for i, lock in enumerate(locks) if lock is None]
    if not locks or missing:
        raise ValueError(f"stations {missing} did not lock")
    kinds = {"ma3" in lock for lock in locks}
    if len(kinds) > 1:
        raise ValueError("the locks mix FM and AM")
    am = kinds.pop()
    for key in ("ma3",) if am else ("psmi", "first_bc"):
        values = sorted({lock[key] for lock in locks})
        if len(values) > 1:
            raise ValueError(f"the locks disagree on {key}: {values}")
    carries = [lock["carry"] for lock in locks]
    offset = torch.tensor([lock["offset"] for lock in locks],
                          dtype=torch.int32, device=carries[0].offset.device)
    if am:
        carry = scar.AMChainCarryRC(
            *(torch.stack(leaves) for leaves in zip(*(c[:-1]
                                                      for c in carries))),
            dec=DA.AMDecodeState(*(torch.stack(lines) for lines in zip(
                *(c.dec for c in carries)))))
        return carry._replace(offset=offset), locks[0]["ma3"]
    carry = rcc.ChainCarryRC(*(torch.stack(leaves)
                               for leaves in zip(*carries)))
    return (carry._replace(offset=offset), locks[0]["psmi"],
            locks[0]["first_bc"])


def stream_wire(station_cu8: np.ndarray, stages: int = 1) -> np.ndarray:
    """One station's interleaved cu8 stream -> its [rc_overlap(stages) // 2
    + n, 2] queue with the 127-valued history pairs ahead of it (the
    reference receiver's initial queue, serve.py:301-303): 7 pairs for
    FM's one stage, 217 for AM's five."""
    pairs = np.asarray(station_cu8, np.uint8).reshape(-1, 2)
    head = np.full((FE.rc_overlap(stages) // 2, 2), 127, np.uint8)
    return np.concatenate([head, pairs])


# ---------------------------------------------------------------------------
# the receiver: queues, host transport, events, alignment, watchdogs
# ---------------------------------------------------------------------------

def _wire_convert(samples, leftover: bytes, cu8: bool, cs16: bool,
                  dtype, conj: bool):
    """Normalize one push's payload to a fresh rc ``[n, 2]`` array at the
    wire dtype (the format contract documented on
    :meth:`MultiStationReceiver.push`): raw bytes (partial trailing I/Q
    pairs carried via ``leftover``), complex64, a 1-D interleaved wire
    array, or an rc ``[..., 2]`` array.  Returns ``(array | None,
    leftover)``.  The reference's ``serve._wire_convert``."""
    if isinstance(samples, (bytes, bytearray, memoryview)):
        buf = leftover + bytes(samples)
        # bytes per I/Q pair on the wire
        pair = 2 if cu8 else 4 if cs16 else 8
        n = len(buf) - (len(buf) % pair)
        leftover = buf[n:]
        if n == 0:
            return None, leftover
        samples = np.frombuffer(
            buf[:n], np.uint8 if cu8 else
            np.int16 if cs16 else np.complex64)
    s = np.asarray(samples)
    if s.dtype.kind == "c":
        if cu8:
            # quantize to the cu8 wire scale (tx.channel.to_cu8);
            # conjugation happens on device in the ingest stage
            s = s.astype(np.complex64, copy=False) \
                .view(np.float32).reshape(-1, 2)
            s = np.clip(np.round(s * 128.0 + 127.0),
                        0, 255).astype(np.uint8)
        else:
            # complex64 memory IS [re, im] float32 pairs: conjugate once
            # and reinterpret.  Both branches materialize a fresh array:
            # the queued chunk must never alias the caller's (reusable)
            # read buffer.
            if conj:
                s = np.conj(s.astype(np.complex64, copy=False))
            else:
                s = s.astype(np.complex64, copy=True)
            s = s.view(np.float32).reshape(-1, 2)
            if cs16:
                s = np.clip(s * 32767.0, -32768,
                            32767).astype(np.int16)
    elif s.ndim == 1:  # interleaved I/Q at the wire dtype
        if cu8:
            s = s.reshape(-1, 2).astype(np.uint8)  # conj on device
        elif s.dtype == np.int16 and not cs16:
            # int16 wire samples into a float chain: restore unit scale
            s = s.reshape(-1, 2).astype(np.float32) * (1.0 / 32768.0)
            if conj:
                s[:, 1] = -s[:, 1]
        else:
            s = s.reshape(-1, 2).astype(dtype)  # fresh copy
            if conj:
                q = s[:, 1]
                # negate without the int16 -32768 overflow
                s[:, 1] = np.where(q == -32768, 32767, -q) \
                    if cs16 else -q
    else:
        # rc [..., 2]: snapshot — callers may reuse their read buffer
        # while this chunk is still queued for a future dispatch
        s = np.array(s, dtype=dtype)
    s = np.ascontiguousarray(s, dtype)
    if s.ndim != 2 or s.shape[1] != 2:
        raise ValueError(f"samples: expected rc [n, 2], got {s.shape}")
    return s, leftover


class _StationTransport:
    """The host transport stack of one station (the reference's
    ``serve._StationTransport``: the session's wiring minus the device
    receiver)."""

    def __init__(self, station: int, callback, hdc_factory=None,
                 mode_fm: bool = True):
        self.station = station
        self._cb = callback
        self.output = Output(self._emit, mode_fm=mode_fm,
                             hdc_decoder_factory=hdc_factory)
        self.pids = PIDSDecoder(self._emit)
        self.frame = TF.FrameDecoder(
            self.output,
            on_audio_service=lambda info: self._emit(
                make(EventType.AUDIO_SERVICE, **info)))
        self._mer_acc = [0.0, 0.0]
        self._mer_cnt = 0

    def _emit(self, event: Event):
        self._cb(self.station, event)

    def mer_push(self, error_lb, error_ub, psmi: int):
        """Per-block sideband error powers -> MER event every 16 blocks
        (reference src/sync.c:486-501)."""
        for elb, eub in zip(np.atleast_1d(error_lb), np.atleast_1d(error_ub)):
            self._mer_acc[0] += float(elb)
            self._mer_acc[1] += float(eub)
            self._mer_cnt += 1
            if self._mer_cnt == 16:
                ppb = C.partitions_per_band(psmi)
                signal = 2 * C.BLKSZ * ppb * C.PARTITION_DATA_CARRIERS * 16
                self._emit(make(
                    EventType.MER,
                    lower=10 * np.log10(signal / self._mer_acc[0])
                    if self._mer_acc[0] > 0 else 0.0,
                    upper=10 * np.log10(signal / self._mer_acc[1])
                    if self._mer_acc[1] > 0 else 0.0))
                self._mer_acc = [0.0, 0.0]
                self._mer_cnt = 0

    def consume_am(self, p1, p3, pids, skip: int):
        """p1 [F, 8, 3750], p3 [F, p3_len], pids [F*8, 80]; ``skip``
        leading frames are diversity-delay warm-up (reference
        am_diversity_wait, src/decode.c:507-554) and carry no payload."""
        n_frames = p1.shape[0]
        for f in range(n_frames):
            if f >= skip:
                for b in range(8):
                    self.frame.push_frame(p1[f, b], TF.P1)
                if p3 is not None:
                    self.frame.push_frame(p3[f], TF.P3)
            for b in range(8):
                blk = f * 8 + b
                if blk < pids.shape[0]:
                    self.pids.frame_push(pids[blk])
                self.output.advance()

    def consume(self, p1, bit_errors, pids, px1=None, px2=None):
        n_frames = p1.shape[0]

        def px_rows(bits, f):
            # spread this dispatch's PX frames across its P1 frames so
            # packets land before the advances that pop them
            if bits is None or bits.shape[0] == 0:
                return ()
            per = max(1, bits.shape[0] // n_frames)
            if f == n_frames - 1:
                return bits[f * per:]
            return bits[f * per:(f + 1) * per]

        for f in range(n_frames):
            # channel BER from the device re-encode comparison (reference
            # src/decode.c:234-277)
            self._emit(make(EventType.BER, cber=float(bit_errors[f])
                            / C.P1_FRAME_LEN_ENCODED_FM))
            self.frame.push_frame(p1[f], TF.P1)
            for bits, lc in ((px1, TF.P3), (px2, TF.P4)):
                for row in px_rows(bits, f):
                    self.frame.push_frame(row, lc)
            for b in range(C.P1_FM_BLOCKS):
                blk = f * C.P1_FM_BLOCKS + b
                if blk < pids.shape[0]:
                    self.pids.frame_push(pids[blk])
                self.output.advance()


def _row(carry, i: int):
    """Station ``i``'s carry (no station axis), copied."""
    if isinstance(carry, scar.AMChainCarryRC):
        return scar.AMChainCarryRC(
            *(x[i].clone() for x in carry[:-1]),
            dec=DA.AMDecodeState(*(x[i].clone() for x in carry.dec)))
    return rcc.ChainCarryRC(*(x[i].clone() for x in carry))


def _set_row(carry, i: int, row) -> None:
    """Write one station's carry (no station axis) into row ``i``, in
    place."""
    if isinstance(carry, scar.AMChainCarryRC):
        pairs = list(zip(carry[:-1], row[:-1])) + list(zip(carry.dec,
                                                           row.dec))
    else:
        pairs = zip(carry, row)
    for x, v in pairs:
        x[i] = v


def _stack(rows: list):
    """Carries without the station axis -> one carry with it."""
    if isinstance(rows[0], scar.AMChainCarryRC):
        return scar.AMChainCarryRC(
            *(torch.stack(leaves) for leaves in zip(*(r[:-1]
                                                      for r in rows))),
            dec=DA.AMDecodeState(*(torch.stack(lines) for lines in zip(
                *(r.dec for r in rows)))))
    return rcc.ChainCarryRC(*(torch.stack(leaves) for leaves in zip(*rows)))


def _to_host(v):
    """A dispatch's outputs as numpy; a mesh's list of outputs a device
    joined along the station axis."""
    if isinstance(v, list):
        return _join_host([_to_host(x) for x in v])
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    return v.cpu().numpy()


def _join_host(parts: list):
    if isinstance(parts[0], dict):
        return {k: _join_host([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def _tree_map(tree, fn):
    return tree_rebuild(tree, iter([fn(x) for x in tree_leaves(tree)]))


def mesh_devices(mesh) -> list:
    """The devices of a ``mesh=`` argument: a sequence of devices, or a 1-D
    ``DeviceMesh`` (rank ``r`` is device ``r`` of its type, modulo the
    cards)."""
    if hasattr(mesh, "device_type"):
        if mesh.mesh.ndim != 1:
            raise ValueError("a station mesh has one dimension")
        kind = K.resolve_device(mesh.device_type)
        if kind.type == "cpu":
            return [kind] * mesh.mesh.numel()
        n = torch.cuda.device_count()
        return [torch.device("cuda", r % n) for r in mesh.mesh.tolist()]
    devices = [K.resolve_device(d) for d in mesh]
    if not devices:
        raise ValueError("an empty mesh")
    return devices


class MultiStationReceiver:
    """Serve ``n_stations`` stations from one card (``mode="fm"`` or
    ``"am"``): the reference's ``serve.MultiStationReceiver``, with its
    names, defaults and events, on the port's device half.

    callback(station: int, event: Event) receives every transport event
    (HDC, AUDIO, ID3, SIS, LOT, ...) tagged with its station index.

    ``push(station, samples)`` takes complex64 baseband at the internal
    rate (744,187.5 S/s FM / 46,511.7 AM), an rc float32 [..., 2] array
    (already ingest-conjugated for FM), raw ``bytes``/``bytearray``
    (partial trailing pairs are carried to the next push), or a 1-D
    interleaved array at the wire dtype; a device dispatch
    (:func:`chain_step` or :func:`chain_step_am`, through K5's graphs on a
    card) fires whenever every station has a dispatch's worth of samples
    buffered.  ``input_format``: ``"cf32"`` (complex64 at the internal
    rate), ``"cs16"`` (interleaved int16 I/Q at the internal rate, scaled
    to float on the device) or ``"cu8"`` (the 1,488,375 S/s unsigned-8
    wire, with the ÷2 FM / ÷32 AM cascade on the device).  Call
    :meth:`flush` at the end of a stream to drain the in-flight pipeline;
    up to ``depth`` dispatches' outputs wait on the device before the host
    transport consumes them.

    A hole in a station's stream breaks its lock.  With ``relock=True`` a
    per-station watchdog (FM: channel BER > 15 % or a vanished K=7 margin
    for 2 frames; AM: the P3 K=9 margin, outside the 3-frame diversity
    warm-up) emits LOST_SYNC and re-acquires that station by a cold start
    on its queued samples (SYNC on success) while the other stations go on
    decoding.  ``locks=`` (one lock of :func:`cold_start` a station, or
    one shared) seeds the carries; an FM lock's ``first_bc`` is consumed by
    a one-time per-station alignment dispatch (PIDS only, run eagerly),
    after which every dispatch is frame-aligned.  ``cold_start=True``
    acquires every station's lock from its pushed stream instead.

    ``device`` (default ``"cuda"``, which raises with no card) is where the
    dispatches run; ``packed`` (default: on a card) packs decoded bits on
    the device before they are copied to the host.

    ``mesh`` (a sequence of devices, or a 1-D ``DeviceMesh`` whose rank
    ``r`` is device ``r`` of its type) shards the station axis as the
    reference's ``jax.sharding.Mesh`` does, with no collectives:
    ``n_stations`` must divide among its devices, each device runs its
    block of stations through every dispatch with its own graphs, and the
    host joins the outputs in station order.  The carries live on the
    mesh's first device between dispatches (where the relock cold starts
    and alignment dispatches run, and ``device`` is not read); a sharded
    fleet cannot grow.
    """

    def __init__(self, n_stations: int, callback: Callable[[int, Event],
                                                           None],
                 frames_per_dispatch: int = 2, psmi: int = 1,
                 depth: int = 2, hdc_factory=None, first_bc: int = 0,
                 input_format: str = "cf32", mode: str = "fm",
                 ma3: bool = False, locks=None,
                 packed: bool | None = None, relock: bool = True,
                 cold_start: bool = False, device="cuda", mesh=None):
        if input_format not in ("cf32", "cs16", "cu8"):
            raise ValueError(f"unknown input_format {input_format!r}")
        if mode not in ("fm", "am"):
            raise ValueError(f"unknown mode {mode!r}")
        if cold_start and locks is not None:
            raise ValueError("cold_start acquires its own locks")
        self._mesh = None if mesh is None else mesh_devices(mesh)
        if self._mesh is not None and n_stations % len(self._mesh):
            raise ValueError(f"{n_stations} stations over "
                             f"{len(self._mesh)} devices")
        self.device = dev = K.resolve_device(device) if mesh is None \
            else self._mesh[0]
        self.mode = mode
        self.n_stations = n_stations
        self.depth = max(depth, 1)
        self._cs16 = input_format == "cs16"
        self._cu8 = input_format == "cu8"
        self._dtype = np.int16 if self._cs16 \
            else np.uint8 if self._cu8 else np.float32
        # cu8: the queue holds raw-rate samples, ``_rate`` raw per chain
        # sample, behind a carried ``_overlap`` history window
        stages = (1 if mode == "fm" else FE.AM_STAGES) if self._cu8 else 0
        self._rate = 1 << stages
        self._overlap = FE.rc_overlap(stages)
        self._chunks: list[list] = [
            [np.full((self._overlap // 2, 2), 127, np.uint8)]
            if self._cu8 else [] for _ in range(n_stations)]
        self._sizes = [self._overlap // 2 if self._cu8 else 0] * n_stations
        self._leftover = [b""] * n_stations  # partial I/Q pair byte tails
        self._packed = dev.type == "cuda" if packed is None else packed
        self._pending: list = []
        self._relock = relock
        self._bad_frames = [0] * n_stations
        self._relocking = [cold_start] * n_stations
        self._pushed = [0] * n_stations  # lifetime samples pushed
        # probe cooldown: pushed-samples watermark before the next probe
        self._relock_next = [0] * n_stations
        self._seq = 0  # dispatch sequence number (tags pending outputs)
        # watch only outputs issued at/after this seq: those already in
        # the pipeline when a station relocks are pre-lock garbage
        self._watch_after = [0] * n_stations

        init_carries = None
        first_bcs = [first_bc] * n_stations
        if locks is not None:
            if isinstance(locks, dict):
                locks = [locks] * n_stations
            if len(locks) != n_stations:
                raise ValueError(f"{len(locks)} locks for {n_stations} "
                                 "stations")
            if mode == "fm":
                psmis = {int(lk["psmi"]) for lk in locks}
                if len(psmis) != 1:
                    raise ValueError("all stations must share one service "
                                     f"mode, got {psmis}")
                psmi = psmis.pop()
                first_bcs = [int(lk["first_bc"]) for lk in locks]
            else:
                ma3s = {bool(lk["ma3"]) for lk in locks}
                if len(ma3s) != 1:
                    raise ValueError("all stations must share one AM mode "
                                     "(MA1 vs MA3)")
                ma3 = ma3s.pop()
            init_carries = _stack([lk["carry"] for lk in locks])
        self.psmi = psmi
        # blocks of the partial leading frame each station must consume
        # (PIDS-only alignment dispatch) before frame-aligned steady state
        self._align = [(C.P1_FM_BLOCKS - bc) % C.P1_FM_BLOCKS
                       for bc in first_bcs] if mode == "fm" \
            else [0] * n_stations
        if mode == "fm":
            self.n_blocks = frames_per_dispatch * C.P1_FM_BLOCKS
            self._needed = self._overlap \
                + self._rate * buffer_len(self.n_blocks)
            self._carries = rcc.chain_rc_init_carry(
                psmi=psmi, n_stations=n_stations, device=dev) \
                if init_carries is None else init_carries
        else:
            self.n_frames = frames_per_dispatch
            self._needed = self._overlap \
                + self._rate * am_buffer_len(self.n_frames)
            self._carries = scar.am_chain_rc_init_carry(
                n_stations=n_stations, device=dev) \
                if init_carries is None else init_carries
            # diversity-delay warm-up frames carry no payload, per station
            # so that a relock re-arms only its own
            self._am_skip = [3] * n_stations
            self._ma3 = ma3
        self._batch = None  # the dispatch's host buffer (pinned on a card)
        self._cb, self._hdc_factory = callback, hdc_factory
        self.transports = [_StationTransport(i, callback, hdc_factory,
                                             mode_fm=mode == "fm")
                           for i in range(n_stations)]
        # PX warm-up: frames decoded before one full interleaver-IV cycle
        # are garbage (reference `ready` flag, src/decode.c:355-359)
        fl1, fl2 = px_frame_lens(psmi) if mode == "fm" else (0, 0)
        self._px_warmup = {
            "px1": IL.p3_iv_tables(fl1)[2] if fl1 else 0,
            "px2": IL.p3_iv_tables(fl2)[2] if fl2 else 0}
        self._px_seen = {"px1": 0, "px2": 0}

    # ------------------------------------------------------------------
    def push(self, station: int, samples):
        """Append samples for one station: complex64 baseband, an rc
        [..., 2] array of the configured dtype, a 1-D interleaved array at
        the wire dtype, or raw bytes at the wire format; trailing partial
        pairs are carried to the next push.  Complex input to a cu8
        receiver is quantized to the cu8 wire scale."""
        s, self._leftover[station] = _wire_convert(
            samples, self._leftover[station], self._cu8, self._cs16,
            self._dtype, self.mode == "fm")
        if s is None:
            return
        self._chunks[station].append(s)
        self._sizes[station] += len(s)
        self._pushed[station] += len(s)
        self._pump()

    def drain(self):
        """Consume every in-flight dispatch through the transports without
        the end-of-stream elastic-tail advances (:meth:`flush` adds them):
        the pipeline-empty point :meth:`checkpoint` needs."""
        while self._pending:
            self._consume(*self._pending.pop(0))

    def flush(self):
        """Drain every in-flight dispatch through the transports, then the
        elastic-buffer tails (the end of a finite capture)."""
        self.drain()
        for tr in self.transports:
            for _ in range(4):
                tr.output.advance()

    # ------------------------------------------------------------------
    def checkpoint(self) -> dict:
        """Snapshot the decode state as numpy: the carried chain state
        (its leaves in the reference's order), the host sample queues (the
        cu8 history and partial byte pairs included) and the alignment,
        warm-up and watchdog counters, under the reference's keys.
        In-flight dispatches are drained first.  The host transport's
        state is not captured: it relocks on the first PDU after
        :meth:`restore`."""
        self.drain()
        state = {
            "carries": ST.carry_leaves(self._carries),
            "chunks": [[np.array(c) for c in ch] for ch in self._chunks],
            "leftover": [np.frombuffer(b, np.uint8)
                         for b in self._leftover],
            "align": np.asarray(self._align, np.int64),
            "px_seen": {k: np.asarray(v) for k, v in
                        self._px_seen.items()},
            "relocking": np.asarray(self._relocking),
            "bad_frames": np.asarray(self._bad_frames, np.int64),
        }
        if self.mode == "am":
            state["am_skip"] = np.asarray(self._am_skip)
        return state

    def restore(self, state: dict):
        """Install a :meth:`checkpoint` snapshot (taken from a receiver of
        the same parameters, in either package).  Call before any
        :meth:`push`."""
        if self._pending:
            raise RuntimeError("restore() before pushing samples")
        self._carries = ST.carry_from_leaves(list(state["carries"]),
                                             self._carries)
        self._chunks = [[np.array(c) for c in ch]
                        for ch in state["chunks"]]
        self._sizes = [sum(len(c) for c in ch) for ch in self._chunks]
        self._leftover = [bytes(np.asarray(b).tobytes())
                          for b in state["leftover"]]
        self._align = [int(a) for a in np.asarray(state["align"])]
        self._px_seen = {k: int(np.asarray(v))
                         for k, v in state["px_seen"].items()}
        if "relocking" in state:
            self._relocking = [bool(r)
                               for r in np.asarray(state["relocking"])]
            self._bad_frames = [int(b)
                                for b in np.asarray(state["bad_frames"])]
        if self.mode == "am":
            sk = np.atleast_1d(np.asarray(state["am_skip"]))
            if sk.size == 1:  # scalar snapshots of the reference's
                sk = np.full(self.n_stations, int(sk[0]))
            self._am_skip = [int(v) for v in sk]

    def save(self, path: str):
        """Persist :meth:`checkpoint` to an ``.npz`` that a fresh receiver
        of the same parameters, of this package or the reference's,
        restores with ``load``."""
        np.savez(path, **self.save_arrays())

    def save_arrays(self) -> dict:
        """:meth:`save`'s flat named-array dict (the ``.npz`` payload), with
        the reference's names: ``carry_{i}``, ``queue_{i}``,
        ``leftover_{i}``, ``align``, ``px_seen``, ``relocking``,
        ``bad_frames`` and, for AM, ``am_skip``."""
        st = self.checkpoint()
        out = {f"carry_{i}": leaf for i, leaf in enumerate(st["carries"])}
        for i in range(self.n_stations):
            ch = st["chunks"][i]
            out[f"queue_{i}"] = np.concatenate(ch, axis=0) if ch \
                else np.zeros((0, 2), self._dtype)
            out[f"leftover_{i}"] = st["leftover"][i]
        out["align"] = st["align"]
        out["px_seen"] = np.asarray([st["px_seen"]["px1"],
                                     st["px_seen"]["px2"]])
        out["relocking"] = st["relocking"]
        out["bad_frames"] = st["bad_frames"]
        if "am_skip" in st:
            out["am_skip"] = st["am_skip"]
        return out

    def load(self, path: str):
        """Install a :meth:`save` snapshot into this freshly constructed
        receiver of the same parameters."""
        with np.load(path) as data:
            self.load_arrays(data)

    def load_arrays(self, data):
        """Install a :meth:`save_arrays` dict (or NpzFile view)."""
        n_leaves = len(ST.carry_leaves(self._carries))
        state = {
            "carries": [data[f"carry_{i}"] for i in range(n_leaves)],
            "chunks": [[data[f"queue_{i}"]]
                       for i in range(self.n_stations)],
            "leftover": [data[f"leftover_{i}"]
                         for i in range(self.n_stations)],
            "align": data["align"],
            "px_seen": {"px1": data["px_seen"][0],
                        "px2": data["px_seen"][1]},
            "relocking": data["relocking"],
            "bad_frames": data["bad_frames"],
        }
        if "am_skip" in data:
            state["am_skip"] = data["am_skip"]
        self.restore(state)

    # ------------------------------------------------------------------
    def queue_depth(self, station: int) -> int:
        """Buffered (not yet dispatched) wire samples for one station."""
        return self._sizes[station]

    def quiesce(self, station: int):
        """Stop the watchdog and any relock probing for one station whose
        input is known dead (a lost tuner padded with silence)."""
        self._relocking[station] = False
        self._watch_after[station] = float("inf")

    def _admit(self, k: int, chunks=None, leftovers=None, pushed=None):
        """Grow the fleet by ``k`` stations mid-stream (the reference's
        path for a station whose service mode was just identified).  New
        stations start in the cold-start/relock state: the receiver
        acquires their locks from their queues (``chunks``, their byte
        ``leftovers`` and ``pushed`` counts, or empty ones).  In-flight
        dispatches are drained first (their outputs are shaped for the old
        fleet); the next dispatch runs at the new size.  A sharded fleet
        cannot grow: its stations divide among the mesh's devices."""
        if self._mesh is not None:
            raise ValueError("cannot grow a mesh-sharded fleet")
        self.drain()
        base = self.n_stations
        self.n_stations = base + k
        grown = rcc.chain_rc_init_carry(
            psmi=self.psmi, n_stations=k, device=self.device) \
            if self.mode == "fm" else scar.am_chain_rc_init_carry(
                n_stations=k, device=self.device)
        rows = [_row(self._carries, i) for i in range(base)] \
            + [_row(grown, j) for j in range(k)]
        self._carries = _stack(rows)
        for j in range(k):
            ch = [np.asarray(c) for c in chunks[j]] if chunks else (
                [np.full((self._overlap // 2, 2), 127, np.uint8)]
                if self._cu8 else [])
            self._chunks.append(ch)
            self._sizes.append(sum(len(c) for c in ch))
            self._leftover.append(leftovers[j] if leftovers else b"")
            self._pushed.append(int(pushed[j]) if pushed
                                else self._sizes[-1])
            self._relocking.append(True)
            self._bad_frames.append(0)
            self._relock_next.append(0)
            self._watch_after.append(self._seq)
            self._align.append(0)
            self.transports.append(_StationTransport(
                base + j, self._cb, self._hdc_factory,
                mode_fm=self.mode == "fm"))
        if self.mode == "am":
            self._am_skip.extend([3] * k)
        self._pump()

    # ------------------------------------------------------------------
    def _fill_padded(self, station: int, out: np.ndarray):
        """Copy whatever the queue holds (without consuming) and pad the
        tail with neutral samples: input for a station riding the batch
        with a frozen carry (its outputs are discarded)."""
        have = min(self._sizes[station], len(out))
        if have:
            self._fill(station, out[:have])
        out[have:] = 127 if self._cu8 else 0

    def _fill(self, station: int, out: np.ndarray):
        """Copy the first len(out) queued samples into ``out``."""
        n, pos = len(out), 0
        for chunk in self._chunks[station]:
            take = min(len(chunk), n - pos)
            out[pos:pos + take] = chunk[:take]
            pos += take
            if pos == n:
                return
        raise RuntimeError(f"station {station}'s queue underflowed")

    def _drop(self, station: int, n: int):
        chunks = self._chunks[station]
        self._sizes[station] -= n
        while n > 0:
            if len(chunks[0]) <= n:
                n -= len(chunks.pop(0))
            else:
                chunks[0] = chunks[0][n:]
                n = 0

    def _window(self, i: int, n: int) -> np.ndarray:
        """Station ``i``'s first ``n`` queued samples as a one-station wire
        [1, n, 2]."""
        buf = np.empty((1, n, 2), self._dtype)
        self._fill(i, buf[0])
        return buf

    def _align_station(self, i: int, blocks: int):
        """One-time PIDS-only dispatch over station ``i``'s partial leading
        frame (``first_bc != 0``): advances its carry to the next P1 frame
        boundary so that every steady dispatch decodes whole frames.  Its
        block count is 1-15, a shape per lock point, so it runs eagerly."""
        wire = self._window(i, self._overlap
                            + self._rate * buffer_len(blocks))
        out, carry = chain_step(
            wire, _stack([_row(self._carries, i)]), blocks, self.psmi,
            (C.P1_FM_BLOCKS - blocks) % C.P1_FM_BLOCKS, self._packed,
            device=self.device, graph=False, px=False)
        self._drop(i, self._rate * int(carry.offset[0]))
        carry = carry._replace(offset=torch.zeros_like(carry.offset))
        _set_row(self._carries, i, _row(carry, 0))
        self._align[i] = 0
        out = _to_host(out)
        if self._packed:
            unpack_out(out)
        tr = self.transports[i]
        for b in range(blocks):
            tr.pids.frame_push(out["pids"][0, b])
            tr.output.advance()
        tr.mer_push(out["diag"]["error_lb"][0], out["diag"]["error_ub"][0],
                    self.psmi)

    def _watch(self, i: int, bit_errors, margins):
        """FM link watchdog: channel BER above 15 % (a dead carrier) or a
        vanished K=7 margin (a silent one, which re-encodes with no
        errors) for 2 frames trips a cold-start re-acquisition."""
        if self._relocking[i]:
            return
        for e, m in zip(np.atleast_1d(bit_errors),
                        np.atleast_1d(margins)):
            dead = (float(e) / C.P1_FRAME_LEN_ENCODED_FM > 0.15
                    or float(m) < 1e-3)
            self._bad_frames[i] = self._bad_frames[i] + 1 if dead else 0
        self._trip(i)

    def _watch_am(self, i: int, margins, skip: int):
        """AM link watchdog on the per-frame P3 K=9 margin (2 on a clean
        carrier, 0 on a gap or noise), the diversity warm-up frames after a
        (re)lock excluded."""
        if self._relocking[i]:
            return
        for f in range(skip, margins.shape[0]):
            dead = float(margins[f]) < 0.5
            self._bad_frames[i] = self._bad_frames[i] + 1 if dead else 0
        self._trip(i)

    def _trip(self, i: int):
        if self._bad_frames[i] >= 2:
            self._bad_frames[i] = 0
            self._relocking[i] = True
            self._relock_next[i] = 0  # probe as soon as samples allow
            self.transports[i]._emit(make(EventType.LOST_SYNC))

    def _try_relock(self, i: int):
        """Cold-start re-acquisition of one station from its queued
        samples.  On a lock: install the locked carry, drop to the locked
        offset and (FM) arm the frame-alignment dispatch or (AM) re-arm the
        diversity warm-up.  Without one the station keeps flowing through
        the dispatches (garbage, CRC-flagged), the probe waits for a
        dispatch's worth of fresh samples, and the backlog is trimmed to a
        dispatch and a probe window."""
        if self._pushed[i] < self._relock_next[i]:
            return  # cooldown: wait for fresh stream before re-probing
        am = self.mode == "am"
        need = self._overlap + self._rate * (
            am_buffer_len(3) if am else buffer_len(6))
        if self._sizes[i] < need:
            return  # buffer more samples first
        lock = cold_start(self._window(i, need), self.mode,
                          device=self.device)[0]
        if lock is None or (bool(lock["ma3"]) != self._ma3 if am
                            else int(lock["psmi"]) != self.psmi):
            self._relock_next[i] = self._pushed[i] + self._needed
            excess = self._sizes[i] - (self._needed + need)
            excess -= excess % self._rate  # keep cu8 pair/phase parity
            if excess > 0:
                self._drop(i, excess)
            return
        _set_row(self._carries, i, lock["carry"])
        self._drop(i, self._rate * int(lock["offset"]))
        if am:
            self._am_skip[i] = 3  # the diversity delay re-primes
        else:
            self._align[i] = (C.P1_FM_BLOCKS - int(lock["first_bc"])) \
                % C.P1_FM_BLOCKS
        self._relocking[i] = False
        self._watch_after[i] = self._seq
        self.transports[i]._emit(make(
            EventType.SYNC, psmi=lock["psmi"] if am else self.psmi))

    def _step(self, batch, carries, dev: torch.device):
        if self.mode == "am":
            return chain_step_am(batch, carries, self.n_frames, self._ma3,
                                 self._packed, device=dev)
        return chain_step(batch, carries, self.n_blocks, self.psmi, 0,
                          self._packed, device=dev)

    def _dispatch(self, batch):
        """One dispatch of every station: on a mesh, each device its block
        of stations (its rows of the batch and of the carries); the outputs
        stay a list a device, joined on the host when consumed, and the new
        carries are joined on the first device."""
        if self._mesh is None:
            return self._step(batch, self._carries, self.device)
        n = self.n_stations // len(self._mesh)
        outs, carries = [], []
        for k, dev in enumerate(self._mesh):
            rows = slice(k * n, (k + 1) * n)
            out, carry = self._step(batch[rows], _tree_map(
                self._carries, lambda x: x[rows].to(dev)), dev)
            outs.append(out)
            carries.append(carry)
        return outs, tree_rebuild(carries[0], iter([
            torch.cat([x.to(self.device) for x in col])
            for col in zip(*(tree_leaves(c) for c in carries))]))

    def _batch_buffer(self) -> torch.Tensor:
        """The dispatch's host buffer, reused: pinned on a card, so that
        its copy up runs at the bus's rate (the copy returns before the
        buffer is refilled)."""
        shape = (self.n_stations, self._needed, 2)
        if self._batch is None or self._batch.shape != shape:
            batch = torch.from_numpy(np.empty(shape, self._dtype))
            self._batch = batch.pin_memory() if self.device.type == "cuda" \
                else batch
        return self._batch

    def _pump(self):
        for i, r in enumerate(self._relocking):
            if r:
                self._try_relock(i)
        for i, a in enumerate(self._align):
            if a and self._sizes[i] >= self._overlap \
                    + self._rate * buffer_len(a):
                self._align_station(i, a)
        while True:
            # a station buffering its one-time alignment dispatch must not
            # pause the fleet: it rides the batch with padded samples and a
            # frozen carry, and its outputs are discarded
            waiting = frozenset(i for i, a in enumerate(self._align) if a)
            ready = [self._sizes[i] for i in range(self.n_stations)
                     if i not in waiting]
            if not ready or min(ready) < self._needed:
                break
            batch = self._batch_buffer()
            rows = batch.numpy()
            for i in range(self.n_stations):
                if i in waiting:
                    self._fill_padded(i, rows[i])
                else:
                    self._fill(i, rows[i])
            saved = {i: _row(self._carries, i) for i in waiting}
            out, carries = self._dispatch(batch)
            # the one host read of a dispatch: the consumed-sample counts;
            # the carry feeds the next dispatch on the device
            consumed = carries.offset.cpu().numpy()
            carries = carries._replace(
                offset=torch.zeros_like(carries.offset))
            for i in waiting:
                _set_row(carries, i, saved[i])
            self._carries = carries
            shrank = False
            for i in range(self.n_stations):
                if i in waiting:
                    continue  # queue preserved for the alignment dispatch
                if self.mode == "am" and self._relocking[i]:
                    # the AM cold start needs a probe window wider than one
                    # dispatch: keep the queue so that it can accumulate
                    continue
                drop = self._rate * int(consumed[i])
                shrank = shrank or drop > 0
                self._drop(i, drop)
            self._pending.append((self._seq, out, waiting))
            self._seq += 1
            if len(self._pending) > self.depth:
                self._consume(*self._pending.pop(0))
            if not shrank:
                # nothing consumed (every station waiting on alignment or
                # an AM station probing): one redecode of the stale head a
                # push is enough
                break

    def _consume(self, seq, out, skip_stations=frozenset()):
        out = _to_host(out)
        if self._packed:
            unpack_out(out)
        if self.mode == "am":
            p1 = out["p1"].reshape(self.n_stations, self.n_frames, 8,
                                   C.P1_FRAME_LEN_AM)
            margins = out["p3_margin"].reshape(self.n_stations,
                                               self.n_frames)
            for i, tr in enumerate(self.transports):
                if i in skip_stations:
                    continue  # rode the batch with a frozen carry
                # outputs issued before a relock are pre-lock garbage; they
                # must not consume the warm-up skip armed for the post-lock
                # frames
                gated = seq >= self._watch_after[i]
                skip = min(self._am_skip[i], self.n_frames) if gated \
                    else self.n_frames
                if gated:
                    self._am_skip[i] -= skip
                tr.consume_am(p1[i], out["p3"][i], out["pids"][i], skip)
                if self._relock and gated:
                    self._watch_am(i, margins[i], skip)
            return
        for key in ("px1", "px2"):
            if key in out:
                self._px_seen[key] += out[key].shape[1]
        elb, eub = out["diag"]["error_lb"], out["diag"]["error_ub"]
        for i, tr in enumerate(self.transports):
            if i in skip_stations:
                continue  # rode the batch with a frozen carry
            px = {}
            for key in ("px1", "px2"):
                if key not in out:
                    px[key] = None
                    continue
                bits = out[key][i]
                # drop warm-up frames from before a full IV cycle
                done_before = self._px_seen[key] - bits.shape[0]
                skip = max(0, self._px_warmup[key] - done_before)
                px[key] = bits[skip:] if skip < bits.shape[0] else None
            tr.mer_push(elb[i], eub[i], self.psmi)
            tr.consume(out["p1"][i], out["p1_bit_errors"][i],
                       out["pids"][i], px["px1"], px["px2"])
            if self._relock and seq >= self._watch_after[i]:
                self._watch(i, out["p1_bit_errors"][i],
                            out["p1_margin"][i])


# ---------------------------------------------------------------------------
# fleets: the live rtl_tcp fleet and the heterogeneous receiver
# ---------------------------------------------------------------------------

class RtlTcpFleet:
    """Serve a fleet of rtl_tcp tuners on one card (the reference's
    ``serve.RtlTcpFleet``).

    The reference binds one session, one whole decode chain, per dongle
    (src/nrsc5.c:331-403); here N tuners share one batched receiver: a
    reader thread a tuner streams the native 1.488 MS/s cu8 wire into it
    (``input_format="cu8"``, the decimation on the device), and each
    station's events come back tagged with the tuner's index.

    ``addrs``: ``[(host, port), ...]``, one rtl_tcp server a station;
    ``frequencies``: Hz a station.  ``gain_db=None`` leaves the dongle's
    hardware AGC on; a dB value selects manual gain (snapped to the
    tuner's gain table, reference src/rtltcp.c:100-154).  Other keyword
    arguments go to the receiver (``device`` among them, default
    ``"cuda"``).

    ``modes`` selects the fleet's shape: ``None`` (default), one
    homogeneous :class:`MultiStationReceiver` (every tuner as the ``mode``
    and ``psmi`` keywords say); a list a tuner such as ``["fm", "am"]``
    (with ``psmis``/``ma3s`` as needed), a :class:`HeterogeneousReceiver`;
    or ``"auto"``, serve-side mode discovery: each tuner's band and
    service mode are found from its own stream, so the fleet takes no mode
    argument at all, as the reference's one session a dongle never
    declares its mode (src/nrsc5.c:325-358).

    Pushes, and the dispatches they start, run under one lock, so one
    reader at a time drives the receiver; TCP backpressure holds the other
    tuners meanwhile.  A tuner that stalls (``stall_timeouts`` socket
    timeouts in a row count as lost) is padded with cu8 silence to the
    deepest live queue, so that the dispatches, which wait for every
    station's samples, go on for the live ones; a lost tuner is quiesced
    and reported with LOST_DEVICE, and padded from then on.
    """

    def __init__(self, addrs, frequencies, callback, gain_db=None,
                 stall_timeouts: int = 3, modes=None, **rx_kwargs):
        import threading

        from nrsc5_tpu_torch.io.rtltcp import RtlTcpClient

        if len(addrs) != len(frequencies):
            raise ValueError(f"{len(addrs)} addresses for "
                             f"{len(frequencies)} frequencies")
        self._stall_timeouts = max(int(stall_timeouts), 1)
        rx_kwargs.setdefault("input_format", "cu8")
        if rx_kwargs["input_format"] != "cu8":
            raise ValueError("rtl_tcp delivers cu8; another wire format "
                             "cannot be served from it")
        # a live tuner's stream is never aligned beforehand: acquire each
        # lock (timing and CFO) from the stream before decoding anything
        rx_kwargs.setdefault("cold_start", "locks" not in rx_kwargs)
        if modes == "auto":
            if not rx_kwargs["cold_start"]:
                raise ValueError("mode discovery needs cold_start=True "
                                 "(no locks)")
            self.rx = HeterogeneousReceiver(len(addrs), callback,
                                            **rx_kwargs)
        elif modes is not None:
            self.rx = HeterogeneousReceiver(len(addrs), callback,
                                            modes=modes, **rx_kwargs)
        else:
            self.rx = MultiStationReceiver(len(addrs), callback,
                                           **rx_kwargs)
        self.clients = []
        try:
            for (host, port), freq in zip(addrs, frequencies):
                c = RtlTcpClient(host, port)
                self.clients.append(c)
                c.set_sample_rate(int(C.SAMPLE_RATE_CU8))
                if gain_db is None:
                    c.set_gain_mode(False)  # the dongle's hardware AGC
                else:
                    c.set_gain(gain_db)
                c.set_frequency(int(freq))
        except BaseException:
            for c in self.clients:
                c.close()
            raise
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._dead = [False] * len(addrs)
        self._cb = callback
        self._threads = [
            threading.Thread(target=self._reader, args=(i,), daemon=True,
                             name=f"rtltcp-fleet-{i}")
            for i in range(len(addrs))]

    def start(self):
        for t in self._threads:
            t.start()

    def _reader(self, i: int):
        client = self.clients[i]
        stalls = 0
        while not self._stopped.is_set():
            try:
                data = client.read_some(65536)
                stalls = 0
            except TimeoutError:
                # a stall (a server hiccup, a network pause): retry, and pad
                # this tuner meanwhile so that the live stations' dispatches
                # go on (the silence breaks its lock when samples resume,
                # and the watchdog relocks it).  read_some loses no partial
                # bytes, so the retry keeps the I/Q pairs aligned.
                stalls += 1
                if stalls < self._stall_timeouts:
                    with self._lock:
                        self._pad_station(i)
                    continue
                self._mark_dead(i)
                break
            except OSError:
                self._mark_dead(i)
                break
            with self._lock:
                self.rx.push(i, data)
                self._pad_dead()

    def _mark_dead(self, i: int):
        """A lost tuner: report it and keep the fleet running, its queue
        padded with silence from then on (the reference's one-dongle
        analog: LOST_DEVICE and the worker stops, src/nrsc5.c:197-201)."""
        if self._stopped.is_set() or self._dead[i]:
            return
        self._dead[i] = True
        with self._lock:
            # its silence would trip the watchdog and burn a futile relock
            # probe every dispatch
            self.rx.quiesce(i)
        self._cb(i, make(EventType.LOST_DEVICE))

    def _pad_station(self, k: int):
        """Level one tuner's queue with the deepest live queue (cu8 silence,
        127), so that the dispatches go on.  Called under the lock."""
        live = [self.rx.queue_depth(j) for j in range(len(self._dead))
                if not self._dead[j] and j != k]
        if not live:
            return
        short = max(live) - self.rx.queue_depth(k)
        if short > 0:
            self.rx.push(k, np.full((short, 2), 127, np.uint8))

    def _pad_dead(self):
        """Keep the lost tuners' queues level with the deepest live queue.
        Called under the lock."""
        if not any(self._dead):
            return
        for k, dead in enumerate(self._dead):
            if dead:
                self._pad_station(k)

    def stop(self, flush: bool = True):
        """Disconnect every tuner, join the readers and (by default) drain
        the receiver's in-flight dispatches through the transports."""
        self._stopped.set()
        for c in self.clients:
            c.close()
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=10)
        if flush:
            with self._lock:
                self.rx.flush()


class HeterogeneousReceiver:
    """Serve a fleet whose stations run different service modes, or
    different bands, through one surface (the reference's
    ``serve.HeterogeneousReceiver``).

    One dispatch bakes one L1 geometry (FM psmi, AM MA1 or MA3) into its
    shapes, so :class:`MultiStationReceiver` serves one mode.  The
    reference runs one session a station, each in its own mode
    (src/nrsc5.c:325-358).  Here stations are grouped by ``(band, service
    mode)`` and each group is one :class:`MultiStationReceiver`: a fleet
    mixing MP1, MP3, MP11, MA1 and MA3 carriers runs one set of graphs a
    distinct mode, and every event keeps its station's global index.

    Three ways to declare the fleet:

    * ``psmis=[...]`` / ``ma3s=[...]`` (with ``modes=["fm", "am", ...]``,
      default all ``mode``): explicit;
    * ``locks=[...]``: one cold-start lock a station; each lock's band
      follows from its fields (AM locks carry ``"ma3"``).  A single dict
      is given to every station, as :class:`MultiStationReceiver` does;
    * no mode argument at all, with ``cold_start=True`` and
      ``input_format="cu8"``: serve-side mode discovery.  Each station's
      stream is staged (behind 217 pairs of cu8 silence, the AM cascade's
      history) until a probe on the card finds its mode: the FM cold start
      on the freshest ``need_fm`` pairs of the stage, its start rounded
      down to a multiple of 32 (K1's ÷2 halfband on a [1, 14 + 2N, 2]
      wire, N = ``buffer_len(6)``), then the AM cold start on the first
      ``need_am`` pairs (K1's ÷32 cascade on [1, 434 + 32N, 2], N =
      ``am_buffer_len(3)``).  On a lock the station joins its mode's group,
      made on the mode's first appearance or grown
      (:meth:`MultiStationReceiver._admit`), and the group acquires the
      station's alignment from the staged stream itself.  Both probes
      failing trims the stage and waits ``need_fm`` pushed pairs before the
      next probe.  Discovery needs the rate-unambiguous cu8 wire (the
      tuner's format); any other wire's rate already gives the band.

    Other keyword arguments go to every group (``device``, default
    ``"cuda"``, which raises with no card, among them).
    push/drain/flush/checkpoint/restore/save/load compose over the groups;
    a file saved by either package loads in the other.

    Two departures from the reference: :meth:`restore` raises when the
    snapshot's groups do not match this wrapper's (the reference zips over
    the groups and, on a fresh auto wrapper, silently restores nothing),
    and :meth:`flush` probes every station still undiscovered once more,
    cooldown or not, before it drains (the reference drains the groups
    only, and such a station's stream is lost).
    """

    def __init__(self, n_stations: int, callback, psmis=None,
                 ma3s=None, locks=None, mode: str = "fm", modes=None,
                 device="cuda", **kw):
        self.device = K.resolve_device(device)
        self.n_stations = n_stations
        self.mode = mode
        self._cb = callback
        self._kw = dict(kw, device=self.device)
        self._groups: list[MultiStationReceiver] = []
        self._remaps: list[list[int]] = []
        self._keys: list[tuple] = []
        self._gindex: dict = {}
        self._slot: list = [None] * n_stations
        self.station_modes: list = [None] * n_stations

        if isinstance(locks, dict):
            locks = [locks] * n_stations
        self._auto = (locks is None and psmis is None and ma3s is None
                      and modes is None)
        if self._auto:
            if not kw.get("cold_start"):
                raise ValueError(
                    "without modes a station's band and service mode are "
                    "discovered from its stream: pass cold_start=True")
            if kw.get("input_format") != "cu8":
                raise ValueError(
                    "mode discovery needs the rate-unambiguous cu8 wire "
                    "(a cf32 or cs16 rate already gives the band)")
            # the staging queues, seeded with the AM cascade's history of
            # cu8 silence (leading DC ahead of an FM signal is nothing to
            # its timing search)
            pad = FE.rc_overlap(FE.AM_STAGES) // 2
            self._staging = [[np.full((pad, 2), 127, np.uint8)]
                             for _ in range(n_stations)]
            self._staged = [pad] * n_stations
            self._sleft = [b""] * n_stations
            self._pushed = [0] * n_stations
            self._probe_next = [0.0] * n_stations
            # the probe windows of the receiver's own relock probes
            self._need_fm = FE.rc_overlap(1) + 2 * buffer_len(6)
            self._need_am = FE.rc_overlap(FE.AM_STAGES) \
                + (1 << FE.AM_STAGES) * am_buffer_len(3)
            return

        # an explicit fleet: one (band, mode) key a station
        if locks is not None:
            if len(locks) != n_stations:
                raise ValueError(f"{len(locks)} locks for {n_stations} "
                                 "stations")
            sm = modes or ["am" if "ma3" in lk else "fm" for lk in locks]
            keys = [("am", bool(lk["ma3"])) if m == "am"
                    else ("fm", int(lk["psmi"]))
                    for m, lk in zip(sm, locks)]
        else:
            sm = list(modes) if modes is not None \
                else [mode] * n_stations
            if len(sm) != n_stations:
                raise ValueError(f"{len(sm)} modes for {n_stations} "
                                 "stations")
            keys = []
            for st, m in enumerate(sm):
                if m not in ("fm", "am"):
                    raise ValueError(f"unknown mode {m!r}")
                if m == "fm":
                    if psmis is None or psmis[st] is None:
                        raise ValueError(f"station {st} is FM: its psmis "
                                         "entry is required")
                    keys.append(("fm", int(psmis[st])))
                else:
                    keys.append(("am", bool(ma3s[st])
                                 if ma3s is not None else False))
        # stable grouping: stations in ascending order within a group,
        # groups in order of first appearance
        order: dict = {}
        for st, key in enumerate(keys):
            order.setdefault(key, []).append(st)
        for key, members in order.items():
            self._spawn_group(
                key, members,
                locks=[locks[st] for st in members]
                if locks is not None else None)

    # ------------------------------------------------------------------
    def _spawn_group(self, key, members, locks=None):
        """Make the receiver of one (band, mode) group and register its
        station map; returns the receiver."""
        gi = len(self._groups)
        remap = list(members)

        def cb(slot_st, ev, _remap=remap):
            self._cb(_remap[slot_st], ev)

        gkw = dict(self._kw)
        band, param = key
        if locks is not None:
            gkw["locks"] = locks
            gkw.pop("cold_start", None)
        if band == "fm":
            gkw["psmi"] = param
        else:
            gkw["ma3"] = param
        rx = MultiStationReceiver(len(members), cb, mode=band, **gkw)
        self._groups.append(rx)
        self._remaps.append(remap)
        self._keys.append(key)
        self._gindex[key] = gi
        for slot, st in enumerate(members):
            self._slot[st] = (gi, slot)
            self.station_modes[st] = key
        return rx

    # ---- serve-side mode discovery (auto fleets) ---------------------
    def _tail_start(self, st: int, n: int) -> int:
        """The start of the freshest ``n`` staged pairs, rounded down to a
        multiple of 32 to keep the cascade's phase."""
        start = self._staged[st] - n
        return start - start % 32

    def _peek(self, st: int, n: int, start: int = 0) -> np.ndarray:
        """A copy of ``n`` staged pairs from ``start``, not consumed: the
        head window (the AM probe, which needs the backlog) or the freshest
        tail window (the FM probe, which must see new samples on each
        retry)."""
        out = np.empty((n, 2), np.uint8)
        filled, pos = 0, 0
        for chunk in self._staging[st]:
            end = pos + len(chunk)
            if end > start:
                lo = max(0, start - pos)
                take = min(len(chunk) - lo, n - filled)
                out[filled:filled + take] = chunk[lo:lo + take]
                filled += take
                if filled == n:
                    return out
            pos = end
        raise RuntimeError(f"station {st}'s staging underflowed")

    def _drop_staged(self, st: int, n: int):
        chunks = self._staging[st]
        self._staged[st] -= n
        while n > 0:
            if len(chunks[0]) <= n:
                n -= len(chunks.pop(0))
            else:
                chunks[0] = chunks[0][n:]
                n = 0

    def _try_discover(self, st: int, final: bool = False):
        """Find one undiscovered station's band and service mode from its
        staged stream: the FM cold start first (the smaller window), then
        the AM one.  On a lock the station joins its mode's group, which
        acquires the station's alignment itself from the staged stream.
        Both probes failing trims the backlog and waits ``need_fm`` pushed
        pairs, as the receiver's relock probe does on a carrier that never
        locks.  ``final`` (flush's last pass) ignores that wait, and an FM
        lock there hands the group the stream from the window that locked:
        no push follows, so the group's own probe of the stream's head
        (where the last probe found no carrier) would be the last."""
        if not final and self._pushed[st] < self._probe_next[st]:
            return
        ran = False
        if self._staged[st] >= self._need_fm:
            # the freshest window: an FM carrier emerging after noise must
            # not hide behind a stale head kept for the AM probe
            start = self._tail_start(st, self._need_fm)
            lock = cold_start(self._peek(st, self._need_fm, start)[None],
                              "fm", device=self.device)[0]
            if lock is not None:
                if final:
                    self._drop_staged(st, start)
                return self._assign(st, ("fm", int(lock["psmi"])))
            ran = True
        if self._staged[st] >= self._need_am:
            lock = cold_start(self._peek(st, self._need_am)[None], "am",
                              device=self.device)[0]
            if lock is not None:
                return self._assign(st, ("am", bool(lock["ma3"])))
            # neither band locked on a full backlog: bound it (keep a fresh
            # AM window's worth) before the next probe
            excess = self._staged[st] - (self._need_am + self._need_fm)
            excess -= excess % 32  # keep the ÷32 cascade's phase
            if excess > 0:
                self._drop_staged(st, excess)
            ran = True
        if ran:
            self._probe_next[st] = self._pushed[st] + self._need_fm

    def _assign(self, st: int, key):
        """Move a station whose mode was just found from its staging queue
        into its (band, mode) group: a new group on the mode's first
        appearance, else the existing group grown by one
        (:meth:`MultiStationReceiver._admit`, which drains the group's
        in-flight dispatches first: their outputs are the old size's)."""
        chunks = self._staging[st]
        left, pushed = self._sleft[st], self._pushed[st]
        self._staging[st] = None
        gi = self._gindex.get(key)
        if gi is None:
            rx = self._spawn_group(key, [st])
            # the staged stream goes over whole: the cold-started group
            # acquires its lock from it (one SYNC, no LOST_SYNC)
            rx._chunks[0] = chunks
            rx._sizes[0] = sum(len(c) for c in chunks)
            rx._leftover[0] = left
            rx._pushed[0] = pushed
            rx._pump()
        else:
            rx = self._groups[gi]
            slot = rx.n_stations
            self._remaps[gi].append(st)
            self._slot[st] = (gi, slot)
            self.station_modes[st] = key
            rx._admit(1, chunks=[chunks], leftovers=[left],
                      pushed=[pushed])

    # ------------------------------------------------------------------
    def push(self, station: int, samples):
        """Append samples for one station: to its group, or, while its mode
        is undiscovered, to its staging queue (raw bytes' partial pairs
        carried), followed by a discovery probe when the wait allows."""
        if self._slot[station] is None:
            s, self._sleft[station] = _wire_convert(
                samples, self._sleft[station], True, False, np.uint8,
                False)
            if s is not None:
                self._staging[station].append(s)
                self._staged[station] += len(s)
                self._pushed[station] += len(s)
            return self._try_discover(station)
        gi, slot = self._slot[station]
        self._groups[gi].push(slot, samples)

    def drain(self):
        for g in self._groups:
            g.drain()

    def flush(self):
        """The end of the streams: one last discovery probe of every
        station still undiscovered and not quiesced, the wait between
        probes ignored (a station too short for the FM window is not
        probed, and its samples stay staged, in :meth:`queue_depth`); then
        every group flushed."""
        if self._auto:
            for st in range(self.n_stations):
                if self._slot[st] is None \
                        and self._probe_next[st] != float("inf"):
                    self._try_discover(st, final=True)
        for g in self._groups:
            g.flush()

    def queue_depth(self, station: int) -> int:
        """A station's buffered wire samples (its staged samples while its
        mode is undiscovered): the fleet's backpressure and padding
        signal (:class:`RtlTcpFleet`)."""
        if self._slot[station] is None:
            return self._staged[station]
        gi, slot = self._slot[station]
        return self._groups[gi].queue_depth(slot)

    def quiesce(self, station: int):
        """Stop watching or probing a station whose input is known dead
        (:class:`RtlTcpFleet`'s lost tuner): an undiscovered station stops
        probing its silence, a grouped one is quiesced in its group."""
        if self._slot[station] is None:
            self._probe_next[station] = float("inf")
            return
        gi, slot = self._slot[station]
        self._groups[gi].quiesce(slot)

    @property
    def transports(self):
        """The groups' transports in global station order (None for a
        station whose mode is undiscovered)."""
        return [None if s is None else self._groups[s[0]].transports[s[1]]
                for s in self._slot]

    # checkpoint / resume: the groups composed
    def checkpoint(self) -> list:
        return [g.checkpoint() for g in self._groups]

    def restore(self, states: list):
        """Install a :meth:`checkpoint` (one snapshot a group) into a
        wrapper with the same groups.  Raises ValueError when the counts
        differ (a fresh auto wrapper has no group yet: :meth:`load` a
        :meth:`save` file into it instead)."""
        if len(states) != len(self._groups):
            raise ValueError(
                f"{len(states)} group snapshots for {len(self._groups)} "
                "groups" + (" (an auto wrapper makes its groups on "
                            "discovery: use save/load)" if self._auto
                            else ""))
        for g, st in zip(self._groups, states):
            g.restore(st)

    def save(self, path: str):
        """One ``.npz`` for the whole fleet, under the reference's names:
        each group's arrays under ``g{i}_``, its members, the group header
        (band and mode a group) and every undiscovered station's staging
        queue, byte leftover and pushed count; a fresh wrapper of the same
        parameters (an auto one included, whose groups the header rebuilds)
        of either package loads it."""
        out = {}
        meta = []
        for gi, g in enumerate(self._groups):
            for k, v in g.save_arrays().items():
                out[f"g{gi}_{k}"] = v
            band, param = self._keys[gi]
            meta.append([1 if band == "am" else 0, int(param)])
            out[f"g{gi}_members"] = np.asarray(self._remaps[gi], np.int64)
        out["groups"] = np.asarray(meta, np.int64).reshape(-1, 2)
        if self._auto:
            for st in range(self.n_stations):
                if self._slot[st] is None:
                    ch = self._staging[st]
                    out[f"stage_{st}"] = np.concatenate(ch) if ch \
                        else np.zeros((0, 2), np.uint8)
                    out[f"sleft_{st}"] = np.frombuffer(self._sleft[st],
                                                       np.uint8)
                    out[f"spushed_{st}"] = np.asarray(self._pushed[st])
        np.savez(path, **out)

    def load(self, path: str):
        """Install a :meth:`save` file into this fresh wrapper."""
        with np.load(path) as data:
            if self._auto:
                if self._groups:
                    raise ValueError("load() into a fresh auto wrapper")
                meta = np.asarray(data["groups"]).reshape(-1, 2)
                for gi in range(meta.shape[0]):
                    band = "am" if meta[gi, 0] else "fm"
                    param = bool(meta[gi, 1]) if band == "am" \
                        else int(meta[gi, 1])
                    members = [int(m) for m in data[f"g{gi}_members"]]
                    for st in members:
                        self._staging[st] = None
                    self._spawn_group((band, param), members)
                for st in range(self.n_stations):
                    if f"stage_{st}" in data.files:
                        self._staging[st] = [np.array(data[f"stage_{st}"])]
                        self._staged[st] = len(self._staging[st][0])
                        self._sleft[st] = bytes(
                            np.asarray(data[f"sleft_{st}"]).tobytes())
                        self._pushed[st] = int(data[f"spushed_{st}"])
            for gi, g in enumerate(self._groups):
                pre = f"g{gi}_"
                g.load_arrays({k[len(pre):]: data[k]
                               for k in data.files
                               if k.startswith(pre)
                               and k != f"{pre}members"})
