"""Offline multi-station capture replay over a mesh of ranks.

PyTorch counterpart of ``nrsc5_tpu/parallel/replay.py``: a long
multi-station capture is sharded over a (station, time) mesh, each shard
decodes its chunk independently (:mod:`nrsc5_tpu_torch.parallel.receive`),
and the host merges each station's frames back into the transport layer
(frame -> elastic buffer -> HDC/ID3/SIS events) in time order, on the
port's own copies of the transport (``transport/frame.py``, ``output.py``,
``pids.py``).  Across hosts the same code runs through
:mod:`.distributed`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.parallel import receive as pr
from nrsc5_tpu_torch.transport import frame as TF
from nrsc5_tpu_torch.transport.output import Output
from nrsc5_tpu_torch.transport.pids import PIDSDecoder


@dataclass
class StationSink:
    """Per-station transport pipeline and event collection."""
    events: list = field(default_factory=list)

    def __post_init__(self):
        self.output = Output(self.events.append)
        self.pids = PIDSDecoder(self.events.append)
        self.frame = TF.FrameDecoder(self.output)


def replay_capture(samples, tails, mesh, n_blocks_per_shard: int,
                   psmi: int = 1, margin_floor: float = 10.0):
    """Decode a multi-station FM capture over ``mesh`` and run the host
    transport of every station.  Each rank passes its shard: ``samples``
    [S_loc, shard_chunk_len] complex64 (its station block and time chunk,
    laid out per :mod:`~nrsc5_tpu_torch.parallel.receive`'s framing) and
    ``tails`` [S_loc, HALO] (None: zeros).  Returns (one StationSink per
    station of the whole mesh, with its events, and the mesh-wide quality)
    on every rank."""
    if tails is None:
        tails = torch.zeros(samples.shape[0], pr.HALO, dtype=samples.dtype,
                            device=samples.device)
    step = pr.sharded_fm_chain(mesh, n_blocks_per_shard, psmi)
    p1, margin, pids, quality = step(samples, tails)
    p1 = pr.gather_mesh(mesh, p1).cpu().numpy()  # [S, n_time*F, 146176]
    margin = pr.gather_mesh(mesh, margin).cpu().numpy()
    pids = pr.gather_mesh(mesh, pids).cpu().numpy()  # [S, n_time*B, 80]
    sinks = []
    for s in range(p1.shape[0]):
        sink = StationSink()
        for f in range(p1.shape[1]):
            # blocks tick the output clock: 16 a frame
            if margin[s, f] >= margin_floor:
                sink.frame.push_frame(p1[s, f], TF.P1)
            for b in range(C.P1_FM_BLOCKS):
                sink.pids.frame_push(pids[s, f * C.P1_FM_BLOCKS + b])
                sink.output.advance()
        sinks.append(sink)
    return sinks, float(quality)
