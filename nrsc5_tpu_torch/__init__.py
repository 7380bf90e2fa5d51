"""PyTorch + CUDA port of the nrsc5_tpu FM and AM receive chains.

The JAX package ``nrsc5_tpu`` is the reference and stays untouched; this
package imports nothing of it and nothing of JAX.  Its layout mirrors the
reference (``ops/``, ``pipeline/``, ``serve.py``, ``tx/``) so each function
has an obvious counterpart.  The FM chain runs from the cu8 wire to
decoded P1/PIDS/PX bits (:func:`nrsc5_tpu_torch.serve.chain_step`, after
:func:`nrsc5_tpu_torch.serve.cold_start`), the AM chain from the cs16 wire
to P1/P3/PIDS bits (:func:`nrsc5_tpu_torch.serve.chain_step_am`); their
device functions are hand-written CUDA kernels for Hopper (``csrc/``),
each beside a plain PyTorch version of the same function.

Entry points take ``device=`` and default to ``"cuda"``: with no card
they raise unless the caller asks for ``device="cpu"``.

Public surface, as the reference's:

    from nrsc5_tpu_torch import NRSC5, MODE_FM, MODE_AM, EventType

    radio = NRSC5.open_pipe(callback)
    radio.pipe_samples_cu8(iq_bytes)

and the command line receiver ``python -m nrsc5_tpu_torch.cli``.  A fleet
of stations on one card: :class:`nrsc5_tpu_torch.serve.MultiStationReceiver`
(one service mode), :class:`~nrsc5_tpu_torch.serve.HeterogeneousReceiver`
(mixed modes, declared or discovered from each station's cu8 stream),
:class:`~nrsc5_tpu_torch.serve.RtlTcpFleet` (rtl_tcp tuners) and, on their
events, :class:`nrsc5_tpu_torch.audio.fleet.FleetAudioDecoder` (batched
HDC audio to PCM).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package imports no kernel module and builds
    # nothing
    if name in ("NRSC5", "MODE_FM", "MODE_AM"):
        from nrsc5_tpu_torch.api import session
        return getattr(session, name)
    if name in ("Event", "EventType"):
        from nrsc5_tpu_torch.api import events
        return getattr(events, name)
    raise AttributeError(name)
