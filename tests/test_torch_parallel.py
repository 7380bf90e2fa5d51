"""The port's sharded receive (``nrsc5_tpu_torch/parallel``) against the JAX
package's, on the CPU: the twins of the five tests of tests/test_parallel.py
(the PX shards, which no JAX test drives, are in
tests/test_torch_parallel_px.py).

JAX runs in this process over the virtual CPU devices tests/conftest.py
sets up; the port runs as gloo ranks spawned by
``parallel.distributed.run_ranks`` (one torch thread each, a 300 s limit
that fails the test): a 2 x 2 (station, time) mesh for the sharded
functions, a 1 x 2 mesh for PX, two ranks for the pipeline.  Every rank
reads the same capture, made by numpy from the seed, from an ``.npz``.

Tolerances:

- decoded bits (P1, PIDS, PX1, AM P1/P3/PIDS), margins, the self-sync
  shards' lock fields (first_bc, cfo, locked) and the replay's events:
  exact against JAX, and the bits against the transmitted bits where the
  reference's test holds them so;
- ``quality``, the mesh-wide mean error power of a station's block: equal
  on every rank, and within ``QUALITY_RTOL`` (1e-4) relative of JAX's, the
  standard tests/test_torch_block_chain.py:12 sets for the chain's error
  sums, or, on a noiseless capture, both below ``NOISE_FLOOR`` (1e-6 of a
  block's signal power: the error is then the float32 rounding of the
  equalized symbols, which the two libraries' FFTs round apart);
- the pipeline's carry: bit-exact against the port's fused chain on one
  rank, and against JAX's the offset and samperr feedback exact, the float
  state within 1e-4 of its largest magnitude or of 1 radian (the standard
  of tests/test_torch_block_chain.py).
"""

import jax
import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.parallel import pipeline as JPP
from nrsc5_tpu.parallel import receive as JPR
from nrsc5_tpu.parallel import replay as JRP
from nrsc5_tpu.pipeline import scan_chain as JSC
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu_torch import state as ST
from nrsc5_tpu_torch.api.events import EventType, make
from nrsc5_tpu_torch.parallel import distributed as TD
from nrsc5_tpu_torch.parallel import receive as TPR
from nrsc5_tpu_torch.pipeline import scan_chain as TSC

from . import parallel_ranks as PRK
from . import serve_events as SE

QUALITY_RTOL = 1e-4
NOISE_FLOOR = 1e-6 * 2 * C.BLKSZ * C.PM_PARTITIONS * 18
CARRY_RTOL = 1e-4
TIMEOUT_S = 300.0


def _devices(n: int):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")


def _ranks(fn, world: int, *args):
    return TD.run_ranks(fn, world, *args, device="cpu", timeout=TIMEOUT_S)


def _save(tmp_path, **arrays) -> str:
    path = str(tmp_path / "capture.npz")
    np.savez(path, **arrays)
    return path


def _same_quality(results, want: float):
    got = {q for r in results for q in r["quality"]}
    assert len(got) == 1, f"quality differs between ranks: {got}"
    got = got.pop()
    if max(abs(got), abs(want)) > NOISE_FLOOR:
        assert abs(got - want) <= QUALITY_RTOL * abs(want), (got, want)


def _distinct_rows(bits):
    """Each station row carries bits of its own, so a halo or an output
    row taken from the other station row shows."""
    assert not np.array_equal(bits[0], bits[1])


def _fm_capture(rng, n_time: int, n_station: int, n_blocks: int,
                snr_db=None):
    """tests/test_parallel.py:13's capture, a station row each from its own
    draws of ``rng``: (samples [S, T], tails [S, HALO], p1 bits [S, ...],
    PIDS bits [S, ...])."""
    rows = [_fm_station(rng, n_time, n_blocks, snr_db)
            for _ in range(n_station)]
    return tuple(np.stack(x) for x in zip(*rows))


def _fm_station(rng, n_time: int, n_blocks: int, snr_db=None):
    """One station of tests/test_parallel.py:13's capture: one P1 frame of
    random P1 and PIDS bits a time shard and 32 trailing blocks, at the
    steady offset."""
    n_frames = n_time * n_blocks // 16
    p1 = rng.integers(0, 2, (n_frames, C.P1_FRAME_LEN_FM)).astype(np.uint8)
    pids = rng.integers(0, 2,
                        (n_frames, 16, C.PIDS_FRAME_LEN)).astype(np.uint8)
    mats = [build_pm_matrix(p1[i], pids[i]) for i in range(n_frames)]
    trail = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))[:32]
    matrix = np.concatenate(mats + [trail])
    bc_seq = np.concatenate([np.tile(np.arange(16), n_frames), [0]])
    sig = modulate_fm(matrix, bc_seq, 1)
    if snr_db is not None:
        sig = ch.impair(sig, snr_db=snr_db, rng=rng)
    total = n_time * JPR.shard_chunk_len(n_blocks)
    buf = np.zeros(total + JPR.HALO, np.complex64)
    start = C.FFTCP_FM // 2
    buf[start:] = sig[:total + JPR.HALO - start]
    return buf[:total], buf[total:], p1, pids


@pytest.mark.parametrize("snr_db", [None, 22.0])
def test_sharded_fm_chain(rng, tmp_path, snr_db):
    """The twin of tests/test_parallel.py:13 (noiseless, as there, and at
    22 dB, where ``quality`` measures noise): a 2 x 2 mesh of two distinct
    stations decodes every frame and PIDS word bit-exact, row by row, as
    JAX's mesh does, over a real halo exchange."""
    _devices(4)
    n_time, n_station, n_blocks = 2, 2, 16
    samples, tails, p1, pids = _fm_capture(rng, n_time, n_station, n_blocks,
                                           snr_db)
    _distinct_rows(p1)
    want = JPR.sharded_fm_chain(JPR.make_mesh(n_station, n_time), n_blocks,
                                psmi=1)(samples, tails)
    want = [np.asarray(x) for x in want]
    res = _ranks(PRK.sharded, 4, "fm", (n_station, n_time),
                 _save(tmp_path, samples=samples, tails=tails), n_blocks, {})
    p1_out, margin, pids_out = res[0]["global"]
    assert p1_out.shape == (n_station, n_time, C.P1_FRAME_LEN_FM)
    for s in range(n_station):
        for got, w, name in zip((p1_out, margin, pids_out), want,
                                ("p1", "margin", "pids")):
            np.testing.assert_array_equal(got[s], w[s],
                                          err_msg=f"{name} row {s}")
        for f in range(n_time):
            assert np.array_equal(p1_out[s, f], p1[s, f]), (s, f)
            assert np.array_equal(pids_out[s, 16 * f:16 * f + 16],
                                  pids[s, f])
    _same_quality(res, float(want[3]))
    assert sorted(r["coord"] for r in res) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    assert all(r["exchange"]["route"] == "direct" for r in res)
    if snr_db is None:
        assert res[0]["quality"][0] < 0.05  # clean link: tiny EVM power


def test_replay_capture_transport(rng, tmp_path):
    """The twin of tests/test_parallel.py:57: the mesh-decoded capture
    through the port's host transport gives JAX's events, station by
    station: every HDC packet of frame 0 and the ID3 title."""
    from nrsc5_tpu.tx.transport_encoder import aas_frame, build_p1_fm_frame
    _devices(4)

    def id3(title):
        fr = b"TIT2" + (len(title) + 1).to_bytes(4, "big") + b"\x00\x00" \
            + b"\x00" + title.encode()
        size = len(fr)
        ss = bytes([(size >> 21) & 0x7F, (size >> 14) & 0x7F,
                    (size >> 7) & 0x7F, size & 0x7F])
        return b"ID3\x03\x00\x00" + ss + fr

    n_time, n_station, n_blocks = 2, 2, 16
    packets, p1_frames = [], []
    for f in range(n_time):
        pk = [rng.integers(0, 256, 300).astype(np.uint8).tobytes()
              for _ in range(32)]
        packets.append(pk)
        p1_frames.append(build_p1_fm_frame(
            pk, 0, f % 8, (f * 32) % 64, aas_frame(0x5100, f, id3("MeshFM"))))
    pids = np.zeros((16, 80), np.uint8)
    mats = [build_pm_matrix(p1_frames[f], pids) for f in range(n_time)]
    trail = build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8), pids)[:32]
    matrix = np.concatenate(mats + [trail])
    bc_seq = np.concatenate([np.tile(np.arange(16), n_time), [0]])
    sig = modulate_fm(matrix, bc_seq, 1)
    total = n_time * JPR.shard_chunk_len(n_blocks)
    buf = np.zeros(total + JPR.HALO, np.complex64)
    start = C.FFTCP_FM // 2
    buf[start:] = sig[:total + JPR.HALO - start]
    samples = np.stack([buf[:total]] * n_station)
    tails = np.stack([buf[total:]] * n_station)

    want, want_q = JRP.replay_capture(
        samples, tails, JPR.make_mesh(n_station, n_time), n_blocks)
    res = _ranks(PRK.replay, 4, (n_station, n_time),
                 _save(tmp_path, samples=samples, tails=tails), n_blocks)
    got = {s: [make(EventType[name], **payload) for name, payload in evs]
           for s, evs in enumerate(res[0]["events"])}
    for r in res[1:]:
        assert [[e[0] for e in evs] for evs in r["events"]] \
            == [[e[0] for e in evs] for evs in res[0]["events"]]
    SE.same_events({s: sink.events for s, sink in enumerate(want)}, got)
    for s in range(n_station):
        hdc = {e.data for e in got[s] if e.type == EventType.HDC
               and not e.crc_error}
        assert sum(p in hdc for p in packets[0]) == 32
        assert "MeshFM" in [e.title for e in got[s]
                            if e.type == EventType.ID3]
    _same_quality([{"quality": [r["quality"]]} for r in res], want_q)


def test_sharded_am_chain(rng, tmp_path):
    """The twin of tests/test_parallel.py:110: the AM chain over a 2 x 2
    mesh of two distinct stations, each shard's frames 3.. past its
    diversity warm-up bit-exact, and every P1, P3 and PIDS output row as
    JAX's."""
    from nrsc5_tpu.tx import encoder_am as EAM
    from nrsc5_tpu.tx.modulator_am import modulate_am
    _devices(4)
    n_station, n_time, n_frames = 2, 2, 7
    total_frames = n_time * n_frames
    total = n_time * JPR.shard_chunk_len_am(n_frames)
    ref = np.stack([EAM.am_ref_bits(b % 8, 1)
                    for b in range(total_frames * 8)])

    def station():
        p1 = rng.integers(0, 2, (total_frames, 8, C.P1_FRAME_LEN_AM)) \
            .astype(np.uint8)
        p3 = rng.integers(0, 2, (total_frames, C.P3_FRAME_LEN_MA1)) \
            .astype(np.uint8)
        mats = EAM.interleave_frames(
            [EAM.encode_p1_am(p1[f]) for f in range(total_frames)],
            [EAM.encode_p3_am(p3[f], False) for f in range(total_frames)],
            False)
        pids = np.stack([EAM.encode_pids_am(
            rng.integers(0, 2, 80).astype(np.uint8))
            for _ in range(total_frames * 8)])
        sig = modulate_am(mats, pids, ref, False)
        buf = np.zeros(total + JPR.HALO_AM, np.complex64)
        start = C.FFTCP_AM // 2
        n = min(len(sig), total + JPR.HALO_AM - start)
        buf[start:start + n] = sig[:n]
        return buf[:total], buf[total:], p1

    samples, tails, p1 = (np.stack(x) for x in zip(
        *[station() for _ in range(n_station)]))
    _distinct_rows(p1)

    want = JPR.sharded_am_chain(JPR.make_mesh(n_station, n_time), n_frames,
                                False)(samples, tails)
    res = _ranks(PRK.sharded, 4, "am", (n_station, n_time),
                 _save(tmp_path, samples=samples, tails=tails), n_frames, {})
    p1_out = res[0]["global"][0]
    for s in range(n_station):
        for i, (got, w) in enumerate(zip(res[0]["global"], want)):
            np.testing.assert_array_equal(got[s], np.asarray(w)[s],
                                          err_msg=f"output {i} row {s}")
        for t in range(n_time):
            for f in range(3, n_frames - (1 if t == n_time - 1 else 0)):
                g = t * n_frames + f
                assert np.array_equal(p1_out[s, g], p1[s, g]), (s, t, f)


def test_sharded_fm_chain_selfsync(rng, tmp_path):
    """The twin of tests/test_parallel.py:161: every time shard of a 2 x 2
    mesh of two distinct stations cold-starts on its own (unknown offset
    947, CFO 3 bins + 25 Hz, 28 dB), locks at |cfo| 3 and decodes its
    frame bit-exact; every output row as JAX's."""
    _devices(4)
    n_time, n_station, n_blocks = 2, 2, 33
    total_frames = 5
    pids = np.zeros((16, C.PIDS_FRAME_LEN), np.uint8)
    bin_hz = C.SAMPLE_RATE_CS16_FM / C.FFT_FM
    total = n_time * JPR.shard_chunk_len(n_blocks)
    halo = JPR.selfsync_halo()
    assert halo == TPR.selfsync_halo()
    off0 = 947

    def station():
        p1 = rng.integers(0, 2,
                          (total_frames, C.P1_FRAME_LEN_FM)).astype(np.uint8)
        matrix = np.concatenate([build_pm_matrix(p1[i], pids)
                                 for i in range(total_frames)])
        sig = modulate_fm(matrix, np.tile(np.arange(16), total_frames), 1)
        sig = ch.impair(sig, cfo_hz=3 * bin_hz + 25.0, snr_db=28.0, rng=rng)
        buf = np.zeros(total + halo, np.complex64)
        buf[off0:off0 + min(len(sig), total + halo - off0)] = \
            sig[:total + halo - off0]
        rcbuf = np.stack([buf.real, -buf.imag], -1).astype(np.float32)
        return rcbuf[:total], rcbuf[total:total + halo], p1

    samples, tails, p1 = (np.stack(x) for x in zip(
        *[station() for _ in range(n_station)]))
    _distinct_rows(p1)

    want = JPR.sharded_fm_chain_selfsync(JPR.make_mesh(n_station, n_time),
                                         n_blocks, psmi=1)(samples, tails)
    res = _ranks(PRK.sharded, 4, "selfsync", (n_station, n_time),
                 _save(tmp_path, samples=samples, tails=tails), n_blocks, {})
    got = res[0]["global"]
    for s in range(n_station):
        for g, w, name in zip(got, want, ("p1", "margin", "first_bc", "cfo",
                                          "locked")):
            np.testing.assert_array_equal(g[s], np.asarray(w)[s],
                                          err_msg=f"{name} row {s}")
    p1_out, _, _, cfo, locked = got
    assert locked.all(), locked
    assert (np.abs(cfo) == 3).all(), cfo
    for s in range(n_station):
        sent = {p1[s, i].tobytes() for i in range(total_frames)}
        assert all(p1_out[s, i].tobytes() in sent
                   for i in range(p1_out.shape[1])), s
    _same_quality(res, float(want[5]))


def test_pipelined_receive_bit_exact(rng, tmp_path):
    """The twin of tests/test_parallel.py:207: the frontend | FEC pipeline
    over two ranks gives the transmitted frames, JAX's pipeline outputs,
    and the port's fused one-rank chain's outputs and carry."""
    _devices(2)
    n_frames = 3
    p1 = rng.integers(0, 2, (n_frames, C.P1_FRAME_LEN_FM)).astype(np.uint8)
    pids = rng.integers(0, 2,
                        (n_frames, 16, C.PIDS_FRAME_LEN)).astype(np.uint8)
    matrix = np.concatenate([build_pm_matrix(p1[i], pids[i])
                             for i in range(n_frames)])
    sig = modulate_fm(matrix, np.tile(np.arange(16), n_frames), 1)
    buf = np.zeros(JSC.buffer_len(16 * n_frames), np.complex64)
    start = C.FFTCP_FM // 2
    buf[start:start + len(sig)] = sig

    want, want_carry = JPP.pipelined_receive(
        jax.numpy.asarray(buf), JSC.chain_init_carry(), n_frames,
        JPP.make_stage_mesh())
    res = _ranks(PRK.pipeline, 2, _save(tmp_path, samples=buf), n_frames)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fused, fused_carry = TSC.fm_chain_scan(
            torch.from_numpy(buf), TSC.chain_init_carry(device="cpu"),
            16 * n_frames, 1, 0)
    finally:
        torch.set_num_threads(threads)
    assert sorted(r["stage"] for r in res) == [0, 1]
    like = TSC.chain_init_carry(device="cpu")
    for r in res:
        for k in ("p1", "p1_margin", "pids"):
            np.testing.assert_array_equal(r["out"][k], np.asarray(want[k]))
        np.testing.assert_array_equal(r["out"]["p1"], fused["p1"].numpy())
        np.testing.assert_array_equal(r["out"]["p1_margin"],
                                      fused["p1_margin"].numpy())
        np.testing.assert_array_equal(
            r["out"]["pids"], fused["pids"].numpy().reshape(n_frames, 16, -1))
        for f in range(n_frames):
            assert np.array_equal(r["out"]["p1"][f], p1[f]), f
            assert np.array_equal(r["out"]["pids"][f], pids[f]), f
        carry = TSC.tree_rebuild(like, iter(
            torch.from_numpy(x) for x in r["carry"]))
        got = ST.block_state_to_numpy(carry)
        for k, v in ST.block_state_to_numpy(fused_carry).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        for k, v in ST.block_state_to_numpy(want_carry).items():
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                scale = max(np.abs(v).max(), 1.0)
                assert np.abs(got[k] - v).max() <= CARRY_RTOL * scale, k
