"""AM logical-channel decode: MA1/MA3 deinterleave -> diversity delay ->
depuncture -> K=9 Viterbi -> descramble (reference: src/decode.c:74-231,
439-554).

PyTorch counterpart of ``nrsc5_tpu/ops/decode_am.py``: ``AMDecodeState``,
``_phase_tables`` (pinned equal by tests/test_torch_tables.py), the
reference's per-frame functions ``am_frame_gather`` and ``am_frame_fec``
as CPU twins (plain PyTorch; a tensor on another device raises), and
the per-block AM receiver's ``am_frame_decode`` and ``am_pids_decode``
(``pids1_disabled`` too), which run the plain versions on the CPU and, on
a card, K15 (one frame's codes; for PIDS its PIDS-only launch,
:func:`am_gather_pids`, a block at a time), K7 at K=9 and K8.  On the
chain a dispatch decodes in three kernels:

  * K15 (:func:`am_gather`, ``csrc/am_gather.cu``): for every station and
    frame of the dispatch at once, the bit-plane gathers from the QAM
    codes, the 54000-bit diversity delay (the only carried state), the
    12/6-phase reassembly, the depuncture and the AM chunk plan's segment
    layout, plus the PIDS gather and delay scatter with the wrap
    extension, composed on the host into one static map over a frame's
    outputs (:func:`gather_maps`), and the new delay lines; K7's inputs
    come out int8;
  * K7 at K=9 (:func:`nrsc5_tpu_torch.ops.convolutional.acs_traceback`),
    reading K15's int8;
  * K8 (:func:`nrsc5_tpu_torch.ops.decode_fm.fec_epilogue`, without the
    re-encode count, on the AM channels this module registers in
    ``decode_fm.CHANNELS``): the kept bits, the descramble (the keystream
    restarts at each 3750-bit P1 subframe) and the pack.

:func:`am_gather_plain` is K15's plain version, the reference's per-frame
sequence of gathers looped over frames.

Like the reference, this decodes a frame as soon as its interleave
completes, one frame earlier than src/decode.c:507-554 does; the bit
sequence is identical.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import decode_fm as DF
from nrsc5_tpu_torch.ops import interleavers as IL
from nrsc5_tpu_torch.ops.convolutional import (CHUNK_AM, OVERLAP_AM,
                                               TAIL_BITING_EXTRA, _acs,
                                               _chunk_plan, depuncture)
from nrsc5_tpu_torch.ops.scramble import scrambler_keystream

DD = C.DIVERSITY_DELAY_AM  # 54000
SEG = DD // 3  # 18000 bits of a delayed stream per frame
WRAP = TAIL_BITING_EXTRA
MATRICES = ("pl", "pu", "s", "t")
SYMS = C.BLKSZ * C.PARTITION_WIDTH_AM  # 800 codes of a partition a block
FRAME_CODES = C.P1_AM_BLOCKS * len(MATRICES) * SYMS  # 25600 bytes a frame
DELAYED = ("ml", "mu", "eml", "emu")  # the order of the carried lines


class AMDecodeState(NamedTuple):
    ml: torch.Tensor  # [..., 54000] uint8
    mu: torch.Tensor
    eml: torch.Tensor  # used in MA3 only
    emu: torch.Tensor


def am_decode_init_state(n_stations: int, *,
                         device="cuda") -> AMDecodeState:
    """Empty delay lines, [n_stations, 54000] each."""
    dev = K.resolve_device(device)
    return AMDecodeState(*(torch.zeros(n_stations, DD, dtype=torch.uint8,
                                       device=dev) for _ in DELAYED))


# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _phase_tables(ma3: bool):
    """Static select tables for the 12/6-phase delay recombination
    (reference: src/decode.c:143-181): for each position of p1_am / p3_am,
    which stream and which stream index supplies the bit."""
    def build(delay_map, total):
        period = sum(len(d) for d in delay_map.values())
        n_groups = total // period
        sel = np.empty(total, np.int32)
        idx = np.empty(total, np.int32)
        for s, (name, delays) in enumerate(delay_map.items()):
            k = len(delays)
            for j, d in enumerate(delays):
                pos = np.arange(n_groups) * period + d
                sel[pos] = s
                idx[pos] = np.arange(n_groups) * k + j
        return sel, idx, list(delay_map.keys())

    p1 = build({"bl": C.BL_DELAY, "ml": C.ML_DELAY,
                "bu": C.BU_DELAY, "mu": C.MU_DELAY}, 72000)
    if not ma3:
        p3 = build({"el": C.EL_DELAY, "eu": C.EU_DELAY}, 36000)
    else:
        p3 = build({"ebl": C.BL_DELAY, "eml": C.ML_DELAY,
                    "ebu": C.BU_DELAY, "emu": C.MU_DELAY}, 72000)
    return p1, p3


def p3_spec(ma3: bool) -> tuple[int, tuple[int, ...], tuple[int, int, int]]:
    """(frame bits, puncture pattern, generators) of the P3 channel."""
    if ma3:
        return C.P3_FRAME_LEN_MA3, C.PUNCTURE_E1, C.CONV_E1_GEN
    return C.P3_FRAME_LEN_MA1, C.PUNCTURE_E2, C.CONV_E2_E3_GEN


def _k8_tables(sub_bits: int, subs: int = 1) -> dict:
    """K8's tables of an AM channel whose frame is ``subs`` subframes of
    ``sub_bits`` bits, each decoded alone over the AM chunk plan.  A P1
    frame is its 8 subframes of 3750 bits flattened (30000 bits, as the
    reference packs it), so its keystream restarts at every subframe."""
    seg_idx, src_chunk, src_off = _chunk_plan(sub_bits, CHUNK_AM, OVERLAP_AM)
    n_seg, steps = seg_idx.shape
    keep = src_chunk.astype(np.int64) * steps + src_off
    keep = (np.arange(subs)[:, None] * (n_seg * steps) + keep).reshape(-1)
    return {"t": keep.size, "steps": steps, "n_seg": n_seg * subs,
            "keep": keep.astype(np.int32),
            "keystream": np.tile(scrambler_keystream(sub_bits), subs)}


def _pids_k8_tables() -> dict:
    """K8's tables of the AM PIDS: one 80-bit frame, wrap-extended."""
    t = C.PIDS_FRAME_LEN
    return {"t": t, "steps": t + 2 * WRAP, "n_seg": 1,
            "keep": (np.arange(t) + WRAP).astype(np.int32),
            "keystream": scrambler_keystream(t).copy()}


P3_CHANNEL = {False: "am_p3_ma1", True: "am_p3_ma3"}
DF.CHANNELS.update({
    "am_p1": functools.partial(_k8_tables, C.P1_FRAME_LEN_AM, 8),
    P3_CHANNEL[False]: functools.partial(_k8_tables, C.P3_FRAME_LEN_MA1),
    P3_CHANNEL[True]: functools.partial(_k8_tables, C.P3_FRAME_LEN_MA3),
    "am_pids": _pids_k8_tables,
})


def _stream_codes(ma3: bool) -> dict:
    """stream name -> int64 [n]: (byte offset of the stream bit's code in
    one frame's [8 blocks, 4 partitions, 800] codes) * 8 + bit plane."""
    out = {}
    for name, (matrix, sym, plane) in IL.am_ma1_tables(ma3).items():
        m = MATRICES.index(matrix)
        off = ((sym // SYMS) * len(MATRICES) + m) * SYMS + sym % SYMS
        out[name] = off * 8 + plane
    return out


def _channel_map(stream_pos, names, streams, ma3):
    """stream_pos: (sel, idx) of each punctured-stream position, -1 where
    a K7 input element is punctured -> (src, dly) int32 maps."""
    sel, idx, valid = stream_pos
    src = np.full(sel.shape, -1, np.int64)
    dly = np.full(sel.shape, -1, np.int64)
    for s, name in enumerate(names):
        hit = valid & (sel == s)
        src[hit] = streams[name][idx[hit]]
        if name in DELAYED:
            dly[hit] = DELAYED.index(name) * SEG + idx[hit]
    return src.astype(np.int32), dly.astype(np.int32)


# K15's staged bytes of a frame (csrc/am_gather.cu): the frame's codes, its
# 8 blocks' PIDS codes, then an 18000-byte slice a delayed line
PIDS_BYTES = C.P1_AM_BLOCKS * C.BLKSZ * 2  # 512
LINE_BASE = FRAME_CODES + PIDS_BYTES  # 26112


def _compose_map(src, dly):
    """A channel's (src, dly) -> K15's composed entries, flat: -1 where
    punctured, else the bit address (byte * 8 + plane) in a frame's staged
    bytes: ``src`` for a stream read from the frame's codes, plane 0 of
    byte ``LINE_BASE + dly`` (line dly // 18000's slice) for a delayed
    one."""
    src = np.asarray(src, np.int64).reshape(-1)
    dly = np.asarray(dly, np.int64).reshape(-1)
    out = np.where(dly >= 0, (LINE_BASE + dly) * 8, src)
    return np.where(src < 0, -1, out).astype(np.int32)


@functools.lru_cache(maxsize=1)
def pids_block_map() -> np.ndarray:
    """int32 [(80 + 64) * 3]: for each K7 input of one block's
    wrap-extended PIDS trellis, the bit address (byte * 8 + plane) of its
    bit in the block's QAM16 codes [32, 2] (byte = row * 2 + stream): the
    reference's il/iu gather and delay scatter into the 240-entry stream,
    inverted (every entry is filled).  The lower (il) stream's bits lie in
    the even bytes, the upper's (iu) in the odd."""
    il_row, il_p, iu_row, iu_p, il_delay, iu_delay = IL.am_pids_tables()
    i = np.arange(120)
    where = np.full(240, -1, np.int64)
    where[(i // 12) * 24 + il_delay[i % 12]] = (il_row * 2 + 0) * 8 + il_p
    where[(i // 12) * 24 + iu_delay[i % 12]] = (iu_row * 2 + 1) * 8 + iu_p
    assert (where >= 0).all(), "the PIDS scatter must fill all 240 bits"
    t = C.PIDS_FRAME_LEN
    steps = (np.arange(t + 2 * WRAP) - WRAP) % t
    return where.reshape(t, 3)[steps].reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=4)
def gather_maps(ma3: bool) -> dict:
    """K15's static map for one service mode, numpy:

    * ``map`` int32 [m1 + m3 + mp + n_delayed * 18000]: the composed map
      over one frame's outputs, in order: P1's K7 input elements (8
      subframes x n1 chunk segments x L1 steps x 3 = m1), P3's (n3 x L3 x 3
      = m3), the 8 PIDS blocks' wrap-extended trellises (8 x 144 x 3 = mp),
      then the fresh 18000 bits of each delayed line (ml, mu; eml, emu in
      MA3).  Entry e is the bit address (byte * 8 + plane) of the bit the
      output takes in the frame's staged bytes, or -1 where punctured:
      bytes [0, 25600) the frame's codes ([8 blocks, 4 partitions, 800]),
      [25600, 26112) its blocks' PIDS codes ([8, 32, 2]), then 18000 bytes
      a delayed line: the carried line's bytes [18000 f, 18000 (f + 1))
      for frame f < 3 of the dispatch, frame f - 3's bits of that stream
      for f >= 3 (plane 0 of a 0/1 byte).  A line's fresh entries address
      the frame's codes;
    * ``m1``, ``m3``, ``mp``: the lengths of the three K7 inputs in a
      frame;
    * ``n1``, ``l1``, ``n3``, ``l3``, ``t3``: the segment shapes and P3's
      frame bits; ``n_delayed``: the lines this mode delays (2 or 4)."""
    (p1_sel, p1_idx, p1_names), (p3_sel, p3_idx, p3_names) = \
        _phase_tables(ma3)
    streams = _stream_codes(ma3)
    out = {}

    # P1: subframe sub, segment position -> mother code -> p1_am position
    t1 = C.P1_FRAME_LEN_AM
    seg1 = _chunk_plan(t1, CHUNK_AM, OVERLAP_AM)[0]
    d1 = DF._depunctured_index(t1, C.PUNCTURE_E1).reshape(t1, 3)
    per_sub = d1.max() + 1  # 9000 punctured bits a subframe
    code = d1[seg1]  # [n1, L1, 3]
    pos = np.where(code >= 0, np.arange(8)[:, None, None, None] * per_sub
                   + code[None], -1)  # [8, n1, L1, 3]
    valid = pos >= 0
    p = np.maximum(pos, 0)
    p1_map = _compose_map(*_channel_map((p1_sel[p], p1_idx[p], valid),
                                       p1_names, streams, ma3))
    out["n1"], out["l1"] = seg1.shape

    t3, pattern3, _ = p3_spec(ma3)
    seg3 = _chunk_plan(t3, CHUNK_AM, OVERLAP_AM)[0]
    d3 = DF._depunctured_index(t3, pattern3).reshape(t3, 3)
    pos = d3[seg3]  # [n3, L3, 3]
    valid = pos >= 0
    p = np.maximum(pos, 0)
    p3_map = _compose_map(*_channel_map((p3_sel[p], p3_idx[p], valid),
                                       p3_names, streams, ma3))
    out["n3"], out["l3"] = seg3.shape
    out["t3"] = t3

    # PIDS: each of the frame's 8 blocks through the one-block map
    pids_map = (FRAME_CODES * 8 + np.arange(C.P1_AM_BLOCKS)[:, None]
                * (C.BLKSZ * 2 * 8) + pids_block_map()[None]).reshape(-1)

    names = [n for n in DELAYED if n in streams]
    line_map = np.concatenate([streams[n] for n in names])
    out["map"] = np.concatenate([p1_map, p3_map, pids_map, line_map]
                                ).astype(np.int32)
    out["m1"], out["m3"], out["mp"] = p1_map.size, p3_map.size, \
        pids_map.size
    out["n_delayed"] = len(names)
    return out


@functools.lru_cache(maxsize=4)
def packed_map(ma3: bool) -> np.ndarray:
    """K15's map as the kernel reads it: :func:`gather_maps`' ``map``
    through :func:`nrsc5_tpu_torch.ops.decode_fm.pack3`."""
    return DF.pack3(gather_maps(ma3)["map"])


@functools.lru_cache(maxsize=8)
def _device_map(ma3: bool, device: str) -> torch.Tensor:
    return torch.from_numpy(packed_map(ma3)).to(device)


# ---------------------------------------------------------------------------
# K15: gathers, diversity delay, reassembly, depuncture, segments
# ---------------------------------------------------------------------------

def _check_gather(codes, pids, state: AMDecodeState):
    if codes.ndim != 4 or codes.shape[2:] != (len(MATRICES), SYMS) \
            or codes.shape[1] % C.P1_AM_BLOCKS:
        raise ValueError(f"codes: expected [S, 8F, 4, {SYMS}], got "
                         f"{tuple(codes.shape)}")
    s, nb = codes.shape[:2]
    for name, t, shape in (("pids", pids, (s, nb, C.BLKSZ, 2)),
                           *((n, line, (s, DD)) for n, line
                             in zip(DELAYED, state))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    return s, nb // C.P1_AM_BLOCKS, nb


@functools.lru_cache(maxsize=8)
def _plain_tables(ma3: bool, device: str) -> dict:
    """K15's plain version's gathers on ``device``: each stream's (matrix,
    symbol index, bit plane), the phase tables, the chunk plans' segment
    positions and the PIDS gather and scatter.  Cached, so that the plain
    version makes no host copy (and can run inside a CUDA graph)."""
    def t(a, dtype=torch.int64):
        return torch.from_numpy(np.asarray(a)).to(dtype).to(device)

    (p1_sel, p1_idx, p1_names), (p3_sel, p3_idx, p3_names) = \
        _phase_tables(ma3)
    t3, _, _ = p3_spec(ma3)
    il_row, il_p, iu_row, iu_p, il_delay, iu_delay = IL.am_pids_tables()
    i = np.arange(120)
    return {
        "streams": {name: (matrix, t(sym), t(plane, torch.uint8))
                    for name, (matrix, sym, plane)
                    in IL.am_ma1_tables(ma3).items()},
        "p1": (t(p1_sel), t(p1_idx), p1_names),
        "p3": (t(p3_sel), t(p3_idx), p3_names),
        "seg1": t(_chunk_plan(C.P1_FRAME_LEN_AM, CHUNK_AM, OVERLAP_AM)[0]),
        "seg3": t(_chunk_plan(t3, CHUNK_AM, OVERLAP_AM)[0]),
        "pids": (t(il_row), t(il_p, torch.uint8), t(iu_row),
                 t(iu_p, torch.uint8), t((i // 12) * 24 + il_delay[i % 12]),
                 t((i // 12) * 24 + iu_delay[i % 12])),
    }


def _frame_gather_plain(mats: dict, lines: dict, ma3: bool):
    """The reference's ``am_frame_gather`` body for a station batch: mats
    {pl, pu, s, t} uint8 [S, 6400]; lines {ml, mu, eml, emu} uint8
    [S, 54000].  Returns (p1_full float32 [S, 8, 3750, 3], p3_full
    [S, t3, 3], new lines)."""
    tb = _plain_tables(ma3, str(mats["pl"].device))
    streams = {name: (mats[matrix][:, sym] >> plane) & 1
               for name, (matrix, sym, plane) in tb["streams"].items()}

    # diversity delay: read the head of the line, append this frame's
    # gather (reference: src/decode.c:87,97 write at DD+n; 177-181 shift
    # by 18000)
    use, new = dict(streams), dict(lines)
    for name in ("ml", "mu") + (("eml", "emu") if ma3 else ()):
        use[name] = lines[name][:, :SEG]
        new[name] = torch.cat([lines[name][:, SEG:], streams[name]], dim=1)

    def reassemble(sel, idx, names):
        maxlen = max(use[n].shape[1] for n in names)
        stack = torch.stack([torch.nn.functional.pad(
            use[n], (0, maxlen - use[n].shape[1])) for n in names], dim=1)
        return stack[:, sel, idx].float() * 2 - 1

    s = mats["pl"].shape[0]
    p1_llr = reassemble(*tb["p1"])  # [S, 72000]
    t1 = C.P1_FRAME_LEN_AM
    p1_full = depuncture(p1_llr.reshape(s, 8, -1), C.PUNCTURE_E1,
                         t1 * 3).reshape(s, 8, t1, 3)
    t3, pattern3, _ = p3_spec(ma3)
    p3_llr = reassemble(*tb["p3"])
    p3_full = depuncture(p3_llr, pattern3, t3 * 3).reshape(s, t3, 3)
    return p1_full, p3_full, new


def _cpu_only(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(
                f"{name} is the reference's per-frame function, a CPU twin "
                f"for the tests; a dispatch on {t.device} decodes through "
                "am_gather and am_fec (K15, K7 at K=9, K8)")


def am_frame_gather(pl, pu, s, t, state: AMDecodeState, ma3: bool = False):
    """Phase 1 of one station's AM frame decode (the reference's function
    of that name): the bit-plane gathers, the 3-frame diversity delay, the
    12-phase reassembly and the depuncture.  pl/pu/s/t: [8*32*25] uint8
    codes (block-major); state: lines of [54000].  Returns (p1_full
    [8, 3750, 3] float32 LLRs, p3_full [t3, 3], new state).  CPU only."""
    _cpu_only("am_frame_gather", pl, pu, s, t, *state)
    mats = {"pl": pl[None], "pu": pu[None], "s": s[None], "t": t[None]}
    lines = {k: v[None] for k, v in state._asdict().items()}
    p1_full, p3_full, new = _frame_gather_plain(mats, lines, ma3)
    return p1_full[0], p3_full[0], AMDecodeState(
        **{k: new[k][0] for k in DELAYED})


def _pids_ext_plain(pids: torch.Tensor,
                    pids1_disabled: bool = False) -> torch.Tensor:
    """The reference's ``am_pids_decode`` up to its Viterbi, and the
    Viterbi's wrap: [B, 32, 2] uint8 QAM16 codes -> [B, 80 + 64, 3]
    float32 LLRs.  ``pids1_disabled`` (MA1 with rdbi set) zeroes the lower
    stream's LLRs (reference: src/decode.c:474-505); the chain passes it
    false."""
    il_row, il_p, iu_row, iu_p, pos_il, pos_iu = _plain_tables(
        False, str(pids.device))["pids"]
    il = (pids[:, il_row, 0] >> il_p) & 1
    iu = (pids[:, iu_row, 1] >> iu_p) & 1
    llr = pids.new_zeros(pids.shape[0], 240, dtype=torch.float32)
    il_llr = il.float() * 2 - 1
    # a device-side fill, so that the plain version runs in a CUDA graph
    llr[:, pos_il] = torch.zeros_like(il_llr) if pids1_disabled else il_llr
    llr[:, pos_iu] = iu.float() * 2 - 1
    llr = llr.reshape(-1, C.PIDS_FRAME_LEN, 3)
    t = C.PIDS_FRAME_LEN
    return torch.cat([llr[:, t - WRAP:], llr, llr[:, :WRAP]], dim=1)


def am_gather_plain(codes, pids, state: AMDecodeState, ma3: bool = False):
    """Plain version of K15: the reference's per-frame ``am_frame_gather``
    looped over the dispatch's frames, the AM chunk plan's segments, and
    the PIDS gather with the wrap extension.

    codes: uint8 [S, 8F, 4, 800] (each block's pl, pu, s, t codes);
    pids: uint8 [S, 8F, 32, 2]; state: the delay lines, uint8 [S, 54000]
    each.  Returns (p1 int8 [S*F*8*n1, L1, 3], p3 [S*F*n3, L3, 3], pids
    [S*8F, 144, 3] K7 inputs, each -1, 0 or +1; the new state, whose lines
    this mode does not delay (eml, emu in MA1) are the same tensors)."""
    s, n_frames, nb = _check_gather(codes, pids, state)
    tb = _plain_tables(ma3, str(codes.device))
    line = state._asdict()
    p1s, p3s = [], []
    for f in range(n_frames):
        blk = codes[:, 8 * f:8 * f + 8]  # [S, 8, 4, 800]
        mats = {m: blk[:, :, i].reshape(s, -1)
                for i, m in enumerate(MATRICES)}
        p1_full, p3_full, line = _frame_gather_plain(mats, line, ma3)
        p1s.append(p1_full[:, :, tb["seg1"]])  # [S, 8, n1, L1, 3]
        p3s.append(p3_full[:, tb["seg3"]])  # [S, n3, L3, 3]
    p1 = torch.stack(p1s, dim=1).reshape(-1, tb["seg1"].shape[1], 3)
    p3 = torch.stack(p3s, dim=1).reshape(-1, tb["seg3"].shape[1], 3)
    pext = _pids_ext_plain(pids.reshape(-1, C.BLKSZ, 2))
    return (p1.to(torch.int8), p3.to(torch.int8), pext.to(torch.int8),
            AMDecodeState(**line))


def am_gather(codes, pids, state: AMDecodeState, ma3: bool = False,
              plain: bool = False):
    """K15: the arguments and results of :func:`am_gather_plain`.

    A CPU tensor (or ``plain``) takes the plain version; a CUDA tensor
    launches the kernel: one launch for every station and frame of the
    dispatch, four CTAs a frame each staging the frame's codes and
    delayed-line slices in shared memory and gathering through the
    composed map of :func:`gather_maps` (read packed, :func:`packed_map`).
    It writes new tensors for the delayed lines only; every tensor must be
    dense and 16-byte aligned."""
    if plain or codes.device.type == "cpu":
        return am_gather_plain(codes, pids, state, ma3)
    s, n_frames, nb = _check_gather(codes, pids, state)
    K.check(codes, "codes", torch.uint8)
    K.check(pids, "pids", torch.uint8)
    for name, line in zip(DELAYED, state):
        K.check(line, name, torch.uint8)
    for name, t in (("codes", codes), ("pids", pids),
                    *zip(DELAYED, state)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K15 needs a 16-byte aligned tensor")
    dev = codes.device
    g = gather_maps(ma3)
    nd = g["n_delayed"]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int8, device=dev)

    p1 = empty(s * n_frames * 8 * g["n1"], g["l1"], 3)
    p3 = empty(s * n_frames * g["n3"], g["l3"], 3)
    pext = empty(s * nb, C.PIDS_FRAME_LEN + 2 * WRAP, 3)
    new = [torch.empty_like(line) if i < nd else line
           for i, line in enumerate(state)]
    K.launch("am_gather", codes.data_ptr(), pids.data_ptr(),
             _device_map(ma3, str(dev)).data_ptr(),
             *(line.data_ptr() for line in state), p1.data_ptr(),
             p3.data_ptr(), pext.data_ptr(),
             *(line.data_ptr() if i < nd else None
               for i, line in enumerate(new)),
             s, n_frames, g["m1"], g["m3"], g["mp"], nd, device=dev)
    return p1, p3, pext, AMDecodeState(*new)


# ---------------------------------------------------------------------------
# FEC: K7 at K=9, then K8
# ---------------------------------------------------------------------------

def _fec(ext, gens, channel: str, plain: bool, packed: bool = False):
    """K7 at K=9, then K8 on ``channel`` (or their plain versions): K7's
    inputs -> (frame bits, K7's margin per segment)."""
    bits, margin = _acs(ext, gens, plain, 9)
    out, _ = (DF.fec_epilogue_plain if plain else DF.fec_epilogue)(
        bits, channel, packed=packed)
    return out, margin


def am_fec(p1_ext, p3_ext, pids_ext, ma3: bool = False,
           packed: bool = False, plain: bool = False):
    """The Viterbis and epilogues of one dispatch, flat over stations x
    frames: K15's three K7 inputs -> (p1 uint8 [B1, 30000] (a frame's 8
    subframes flattened; [B1, 3750] packed), p1 margin [B1, 8] (the
    minimum over each subframe's segments), p3 [B1, t3] (or packed), p3
    margin [B1], pids [B2, 80] (or [B2, 10])), B1 = stations x frames, B2
    = stations x blocks."""
    _, _, gen3 = p3_spec(ma3)
    g = gather_maps(ma3)
    p1, m1 = _fec(p1_ext, C.CONV_E1_GEN, "am_p1", plain, packed)
    p3, m3 = _fec(p3_ext, gen3, P3_CHANNEL[ma3], plain, packed)
    pids, _ = _fec(pids_ext, C.CONV_E2_E3_GEN, "am_pids", plain, packed)
    return (p1, m1.reshape(-1, 8, g["n1"]).amin(-1), p3,
            m3.reshape(-1, g["n3"]).amin(-1), pids)


def am_frame_fec(p1_full, p3_full, ma3: bool = False):
    """Phase 2 (the reference's function of that name): the two chunked
    K=9 tail-biting Viterbis (chunk 1024, overlap 160) + descramble, as
    :func:`am_fec` runs them on K15's segments, through K7's and K8's
    plain versions.  p1_full [..., 8, 3750, 3] / p3_full [..., t3, 3] with
    equal leading dims.  Returns (p1_bits [..., 8, 3750], p3_bits
    [..., t3], margins {"p1": [..., 8], "p3": [...]}).  CPU only."""
    _cpu_only("am_frame_fec", p1_full, p3_full)
    batch = p3_full.shape[:-2]
    t1, t3 = C.P1_FRAME_LEN_AM, p3_full.shape[-2]
    _, _, gen3 = p3_spec(ma3)
    tb = _plain_tables(ma3, "cpu")
    seg1, seg3 = tb["seg1"], tb["seg3"]
    p1, m1 = _fec(p1_full.float().reshape(-1, t1, 3)[:, seg1].reshape(
        -1, seg1.shape[1], 3), C.CONV_E1_GEN, "am_p1", True)
    p3, m3 = _fec(p3_full.float().reshape(-1, t3, 3)[:, seg3].reshape(
        -1, seg3.shape[1], 3), gen3, P3_CHANNEL[ma3], True)
    return (p1.reshape(batch + (8, t1)), p3.reshape(batch + (t3,)),
            {"p1": m1.reshape(batch + (8, seg1.shape[0])).amin(-1),
             "p3": m3.reshape(batch + (seg3.shape[0],)).amin(-1)})


def _check_pids(pids):
    if pids.ndim < 2 or tuple(pids.shape[-2:]) != (C.BLKSZ, 2):
        raise ValueError(f"pids: expected [..., {C.BLKSZ}, 2], got "
                         f"{tuple(pids.shape)}")


def am_gather_pids_plain(pids, pids1_disabled: bool = False):
    """Plain version of K15's PIDS-only launch: blocks of QAM16 codes
    uint8 [B, 32, 2] -> K7's input int8 [B, 80 + 64, 3], each block's
    wrap-extended PIDS trellis (-1, 0 or +1), the lower stream's entries 0
    where ``pids1_disabled``."""
    _check_pids(pids)
    return _pids_ext_plain(pids.reshape(-1, C.BLKSZ, 2),
                           pids1_disabled).to(torch.int8)


@functools.lru_cache(maxsize=8)
def _pids_device_map(device: str) -> torch.Tensor:
    return torch.from_numpy(pids_block_map().astype(np.int16)).to(device)


def am_gather_pids(pids, pids1_disabled: bool = False, plain: bool = False):
    """K15's PIDS-only launch: the arguments and result of
    :func:`am_gather_pids_plain`, for blocks decoded before their frame is
    complete (the per-block AM receiver decodes PIDS every block).

    A CPU tensor (or ``plain``) takes the plain version; a CUDA tensor
    launches the kernel (``csrc/am_gather.cu``: a CTA a block, its 64
    codes staged in shared memory, a thread an output through
    :func:`pids_block_map`)."""
    if plain or pids.device.type == "cpu":
        return am_gather_pids_plain(pids, pids1_disabled)
    _check_pids(pids)
    K.check(pids, "pids", torch.uint8)
    b = pids.numel() // (C.BLKSZ * 2)
    ext = torch.empty(b, C.PIDS_FRAME_LEN + 2 * WRAP, 3, dtype=torch.int8,
                      device=pids.device)
    K.launch("am_gather_pids", pids.data_ptr(),
             _pids_device_map(str(pids.device)).data_ptr(), ext.data_ptr(),
             b, int(bool(pids1_disabled)), device=pids.device)
    return ext


def am_pids_decode(pids_syms, pids1_disabled: bool = False):
    """AM PIDS decode of blocks [..., 32, 2] uint8 QAM16 codes (inner,
    outer) -> bits [..., 80] uint8 (the reference's function of that name;
    ``pids1_disabled``: MA1 with rdbi set zeroes the lower stream).  A CPU
    tensor runs the plain versions; a CUDA tensor runs K15's PIDS-only
    launch, K7 at K=9 and K8."""
    _check_pids(pids_syms)
    batch = pids_syms.shape[:-2]
    bits, _ = _fec(am_gather_pids(pids_syms, pids1_disabled),
                   C.CONV_E2_E3_GEN, "am_pids",
                   pids_syms.device.type == "cpu")
    return bits.reshape(batch + (C.PIDS_FRAME_LEN,))


def am_frame_decode(pl, pu, s, t, state: AMDecodeState, ma3: bool = False):
    """Decode one full AM frame of one station (the reference's function of
    that name): pl/pu/s/t [8*32*25] uint8 QAM codes (block-major), state:
    delay lines of [54000].  Returns (p1_bits [8, 3750] uint8, p3_bits
    [t3] uint8, margins {"p1": [8], "p3": []}, new state).

    A CPU tensor runs :func:`am_frame_gather` and :func:`am_frame_fec`
    (the plain versions); a CUDA tensor packs the codes into K15's
    ``codes [1, 8, 4, 800]`` and runs K15, K7 at K=9 and K8."""
    if pl.device.type == "cpu":
        p1_full, p3_full, new = am_frame_gather(pl, pu, s, t, state, ma3)
        p1, p3, margins = am_frame_fec(p1_full, p3_full, ma3)
        return p1, p3, margins, new
    return am_frame_decode_k15(pl, pu, s, t, state, ma3)


def am_frame_decode_k15(pl, pu, s, t, state: AMDecodeState,
                        ma3: bool = False, plain: bool = False):
    """:func:`am_frame_decode`'s card path: the codes packed into K15's
    ``codes [1, 8, 4, 800]`` (no PIDS), K15, then K7 at K=9 and K8 on P1
    and P3; ``plain`` runs their plain versions on any device (the tests
    hold the packing to the CPU twin with it)."""
    codes = torch.stack([pl, pu, s, t]).reshape(
        len(MATRICES), C.P1_AM_BLOCKS, SYMS).transpose(0, 1).contiguous()
    pids = torch.zeros(1, C.P1_AM_BLOCKS, C.BLKSZ, 2, dtype=torch.uint8,
                       device=pl.device)
    p1e, p3e, _, new = am_gather(codes[None], pids,
                                 AMDecodeState(*(x[None] for x in state)),
                                 ma3, plain)
    t3, _, gen3 = p3_spec(ma3)
    g = gather_maps(ma3)
    p1, m1 = _fec(p1e, C.CONV_E1_GEN, "am_p1", plain)
    p3, m3 = _fec(p3e, gen3, P3_CHANNEL[ma3], plain)
    return (p1.reshape(8, C.P1_FRAME_LEN_AM), p3.reshape(t3),
            {"p1": m1.reshape(8, g["n1"]).amin(-1), "p3": m3.amin()},
            AMDecodeState(*(x[0] for x in new)))
