"""How the port's receiver tests compare the events of two receivers, with
no JAX (the card's tests use it too).

Two receivers' events are the same when, station by station, every event
is equal by the reference's own key (:func:`ev_key`, a copy of
tests/test_serve.py ``_ev_key``), but for the floats of the MER events,
held within ``MER_DB`` dB: the MER is 10·log10 of the sideband error sums,
which the packages (and the card's kernels against the plain versions)
add in other orders, and on clean streams (~60 dB) the error they sum is
the float32 rounding of the equalized symbols itself, which those orders
and transcendental functions move by up to ~1 % (measured between the
JAX and port receivers: 0.027 dB).  A frame of a dead carrier (in a
relock's gap, before the watchdog trips) must read dead in both, its
channel BER above the watchdog's 15 % and its MER below ``DEAD_MER_DB``,
but its values are not compared: the chain then tracks noise, where the
same float32 differences steer it (measured: BER 0.234-0.242 against
0.234-0.240, MER -15.5 against -14.4 dB).
"""

import numpy as np

MER_DB = 0.1
DEAD_MER_DB = 10.0


def ev_key(ev):
    """Normalize an event to a comparable tuple (arrays -> bytes): the
    reference's ``_ev_key``."""
    def norm(v):
        if isinstance(v, np.ndarray):
            return (v.dtype.str, v.shape, v.tobytes())
        if isinstance(v, (bytes, str, int, float, bool, type(None))):
            return v
        return repr(v)
    return (ev.type,) + tuple(
        (k, norm(v)) for k, v in sorted(ev.payload.items()))


def key(ev):
    """:func:`ev_key` with the type by name (the packages' enums are
    distinct classes of the same members) and numpy integers as ints; a
    dead carrier's BER and MER as "dead", and the MER floats apart: (key,
    floats held within MER_DB)."""
    if ev.type.name == "MER":
        if min(ev.lower, ev.upper) < DEAD_MER_DB:
            return ("MER", "dead"), ()
        return ("MER",), (ev.lower, ev.upper)
    if ev.type.name == "BER" and ev.cber > 0.15:
        return ("BER", "dead"), ()
    k = ev_key(ev)
    return (k[0].name,) + tuple(
        (f, int(ev.payload[f]) if isinstance(ev.payload[f], np.integer)
         else v) for f, v in k[1:]), ()


def same_events(want_events, got_events):
    """Station by station: the same events in the same order, the MER
    floats within MER_DB.  The message names the first event that
    differs."""
    for st in want_events:
        want = [key(e) for e in want_events[st]]
        got = [key(e) for e in got_events[st]]
        for n, ((g, _), (w, _)) in enumerate(zip(got, want)):
            assert g == w, (st, n, str(g)[:300], str(w)[:300])
        assert len(got) == len(want), (st, len(got), len(want))
        for (_, a), (_, b) in zip(got, want):
            assert np.allclose(a, b, rtol=0, atol=MER_DB), (st, a, b)
