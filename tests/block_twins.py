"""Run the JAX package's per-block receivers and the port's on the same
input, for the twins of the per-block tests (tests/test_torch_block_*.py).

Tolerances (the standard of tests/test_scan_chain.py:148-168):

- decoded bits (P1, PIDS, PX, AM P1 and P3 frames), the order of the
  frames and of the layer-1 events, every SYNC's psmi and every BER (a
  re-encode count over a constant) exact; so HDC packets, ID3, SIS and
  audio through the session's transport exact (tests/serve_events.py's
  ``same_events``);
- the MER floats within ``serve_events.MER_DB`` (0.1 dB): 10·log10 of the
  sideband error sums, which the packages add in other orders.  On a
  noiseless stream the error sums are the float32 rounding of the
  equalized symbols themselves (MER 130-140 dB), which the two
  libraries' FFTs and sums round up to 10 dB apart (ROADMAP §3.10): the one
  twin with noiseless stretches (tests/test_torch_block_session.py::
  test_sync_loss_and_recovery) passes ``noiseless=True``, which holds a
  MER above ``NOISELESS_MER_DB`` on both sides within
  ``NOISELESS_GAP_DB``, the gap measured there, and every other MER
  within 0.1 dB;
- the frame margins exact, but the per-block FM receiver's P1 margins
  (``p1_margins=False``): the port decodes a P1 frame through its
  chains' chunked decoder, the reference's per-block receiver through the
  unchunked one; tests/test_torch_block_l1_fm.py::
  test_fm_p1_margin_is_the_chunked_decoders holds them equal to the
  reference's chunked decoder's (ROADMAP §3.10).
"""

import numpy as np
import torch

from nrsc5_tpu.api.session import NRSC5 as JNRSC5
from nrsc5_tpu_torch.api.session import NRSC5

from . import serve_events as SE
from .serve_events import MER_DB

NOISELESS_MER_DB = 120.0  # rounding only: no noise reaches the symbols
NOISELESS_GAP_DB = 10.0  # the largest gap measured there: 9.87 dB


def _mer_close(got, want, noiseless: bool) -> bool:
    """Two MERs (dB) within MER_DB; with ``noiseless``, two above
    NOISELESS_MER_DB within NOISELESS_GAP_DB."""
    gap = abs(got - want)
    if noiseless and min(got, want) > NOISELESS_MER_DB:
        return gap <= NOISELESS_GAP_DB
    return gap <= MER_DB


def same_events(want, got, noiseless: bool = False) -> None:
    """serve_events.same_events on one stream of session events; with
    ``noiseless``, a MER of a noiseless stretch within NOISELESS_GAP_DB
    (:func:`_mer_close`)."""
    w, g = [SE.key(e) for e in want], [SE.key(e) for e in got]
    for n, ((gk, _), (wk, _)) in enumerate(zip(g, w)):
        assert gk == wk, (n, str(gk)[:300], str(wk)[:300])
    assert len(g) == len(w), (len(g), len(w))
    for (_, a), (_, b) in zip(g, w):
        assert len(a) == len(b)
        assert all(_mer_close(x, y, noiseless) for x, y in zip(a, b)), \
            (a, b)


class L1Collector:
    """A receiver's ``on_frame`` and ``on_event`` streams, in order."""

    def __init__(self):
        self.frames = []  # (channel, bits)
        self.margins = []  # (channel, margin)
        self.events = []  # (kind, info)

    def on_frame(self, chan, bits, margin):
        self.frames.append((chan, np.array(bits, np.uint8)))
        self.margins.append((chan, float(margin)))

    def on_event(self, kind, info):
        self.events.append((kind, dict(info)))

    def channel(self, chan):
        return [b for c, b in self.frames if c == chan]


def same_l1(want: L1Collector, got: L1Collector,
            p1_margins: bool = True) -> None:
    """The same frames (channel and bits) and layer-1 events in the same
    order, the margins exact (P1's, channel 0, only with ``p1_margins``),
    the MER floats within MER_DB."""
    assert len(got.frames) == len(want.frames), (len(got.frames),
                                                 len(want.frames))
    for n, ((gc, gb), (wc, wb)) in enumerate(zip(got.frames, want.frames)):
        assert gc == wc and np.array_equal(gb, wb), (n, gc, wc)
    for n, ((chan, gm), (_, wm)) in enumerate(zip(got.margins,
                                                  want.margins)):
        assert gm == wm or (chan == 0 and not p1_margins), (n, chan, gm, wm)
    assert [k for k, _ in got.events] == [k for k, _ in want.events]
    for (kind, gi), (_, wi) in zip(got.events, want.events):
        assert gi.keys() == wi.keys(), (kind, gi, wi)
        if kind == "mer":
            assert all(abs(gi[k] - wi[k]) <= MER_DB for k in gi), (gi, wi)
        else:
            assert gi == wi, (kind, gi, wi)


def l1_twin(jax_cls, port_cls, feed, p1_margins: bool = True, **port_kw):
    """``feed(rx)`` on a JAX receiver and on the port's (``device="cpu"``)
    of the same class; returns (JAX's streams, the port's), held equal by
    :func:`same_l1` (``p1_margins=False`` for the per-block FM
    receiver)."""
    runs = []
    for make in (lambda c: jax_cls(c.on_frame, c.on_event),
                 lambda c: port_cls(c.on_frame, c.on_event, device="cpu",
                                    **port_kw)):
        col = L1Collector()
        feed(make(col))
        runs.append(col)
    same_l1(*runs, p1_margins=p1_margins)
    return runs


def session_twin(sig, mode: int, chunk: int, flush: bool = False,
                 hdc="none", noiseless: bool = False, **kw):
    """The same stream (complex64, or a cu8 byte array pushed with
    ``pipe_samples_cu8``) pushed in pieces of ``chunk`` through JAX's
    session with its host receivers (``device=False``) and the port's on
    the CPU (``device="cpu"``, the per-block receivers of
    ``chain="auto"``), then ``flush`` where asked; ``hdc`` "none" decodes
    no audio, "auto" each package's HDC decoder.  Returns (JAX's events,
    the port's), held equal by :func:`same_events` (``noiseless``: the
    stream has noiseless stretches)."""
    factory = None if hdc == "none" else "auto"
    runs = []
    for open_pipe in (
            lambda cb: JNRSC5.open_pipe(cb, mode, device=False,
                                        hdc_decoder_factory=factory, **kw),
            lambda cb: NRSC5.open_pipe(cb, mode, device="cpu",
                                       hdc_decoder_factory=factory, **kw)):
        events = []
        radio = open_pipe(events.append)
        push = radio.pipe_samples_cu8 if sig.dtype == np.uint8 \
            else radio.pipe_samples_cs16
        for i in range(0, len(sig), chunk):
            push(sig[i:i + chunk])
        if flush:
            radio.flush()
        runs.append(events)
    same_events(*runs, noiseless=noiseless)
    return runs


def one_thread():
    """Pin torch to one thread for a module (a generator for a fixture):
    the per-block path drives many small ops, and beside the other xdist
    workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
