"""The complex chain batched over stations: the port's ``fm_chain_batch``
(MP1 and MP3) and ``am_chain_batch`` against the JAX package's (its
``vmap``) on the CPU, two stations from distinct seeds.  The chain has
one path (``scan_blocks_c`` + ``fm_decode_c``, ``scan_blocks_am_c`` + the
AM decode), whose kernels K17-K20 take their plain versions on CPU
tensors; each station of a batch is held to that station run alone.  And
the rule of the kernel wrappers: the plain version on a CPU tensor only,
a raise on any other tensor with no card.

Tolerances (tests/test_torch_block_chain.py's): decoded bits, re-encode
counts, the per-block samperr and the carried offset exact against JAX;
the MER error sums within 1e-4 of the largest (or both under the noise
floor of a noiseless stream), the PX margins and the carried floats
within 1e-4 of their largest magnitude or of 1 radian, the carried PX
interleaver-IV state (int8 soft bits, rounded floats: a value on a .5
edge rounds apart) within 1 on at most 0.1 % of its entries.  A station
alone and in a batch runs the same plain functions on the same values:
every output and carry bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.pipeline import scan_chain as JSC
from nrsc5_tpu.pipeline import scan_chain_am as JSCA
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx.encoder import build_pm_matrix, build_px_stream
from nrsc5_tpu.tx.modulator import modulate_fm
from nrsc5_tpu_torch.ops import acquire as TA
from nrsc5_tpu_torch.ops.bits import pack_out
from nrsc5_tpu_torch.ops.decode_fm import pids_decode
from nrsc5_tpu_torch.ops import sync_am as TSA
from nrsc5_tpu_torch.ops import sync_fm as TS
from nrsc5_tpu_torch.pipeline import scan_chain as TSC
from nrsc5_tpu_torch.pipeline import scan_chain_am as TSCA

from . import block_twins as BT
from .test_torch_block_chain import NOISE_FLOOR, _am_signal, _close, _np

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)

S = 2  # stations, each from its own seed


def _fm_station(seed: int, psmi: int):
    """One FM station at the steady offset.  MP1: one lead block (bc 15)
    and a P1 frame, 17 blocks; MP3: 8 blocks from bc 0 with PX1 soft bits
    (the IV cycle's first pairs).  25 dB."""
    rng = np.random.default_rng([23, seed])
    p1 = rng.integers(0, 2, (1, C.P1_FRAME_LEN_FM)).astype(np.uint8)
    pids = rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8)
    matrix = build_pm_matrix(p1[0], pids)
    if psmi == 1:
        n_blocks, first_bc = 17, 15
        lead = build_pm_matrix(p1[0][::-1].copy(), pids)[15 * 32:]
        sig = modulate_fm(np.concatenate([lead, matrix]),
                          np.concatenate([[15], np.arange(16)]), 1)
    else:
        n_blocks, first_bc = 8, 0
        fl = C.P3_FRAME_LEN_MP3_MP11
        px1 = rng.integers(0, 2, (1, 16, fl)).astype(np.uint8)
        signs = build_px_stream(px1, fl).reshape(32 * C.BLKSZ, -1)
        sig = modulate_fm(matrix[:n_blocks * 32], np.arange(n_blocks), psmi,
                          px1_signs=signs[:n_blocks * 32])
    sig = ch.impair(sig, snr_db=25.0, rng=rng)
    buf = np.zeros(JSC.buffer_len(n_blocks), np.complex64)
    start = C.FFTCP_FM // 2
    n = min(len(sig), len(buf) - start)
    buf[start:start + n] = sig[:n]
    return buf, p1, pids, n_blocks, first_bc


def _same_tree(a, b):
    """Two trees (dicts, NamedTuples, tuples) of tensors equal bit for
    bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.fixture(scope="module", params=[1, 3])
def fm_batch(request):
    psmi = request.param
    st = [_fm_station(i, psmi) for i in range(S)]
    bufs = np.stack([b[0] for b in st])
    n_blocks, first_bc = st[0][3], st[0][4]
    carries = TSC.stack_trees([TSC.chain_init_carry(device="cpu")] * S)
    px = None if psmi == 1 else TSC.stack_trees(
        [TSC.px_init_state(psmi, device="cpu")] * S)
    got = TSC.fm_chain_batch(torch.from_numpy(bufs), carries, n_blocks, psmi,
                             first_bc, px)
    jcar = jax.tree.map(lambda x: jnp.stack([x] * S), JSC.chain_init_carry())
    jpx = None if psmi == 1 else jax.tree.map(
        lambda x: jnp.stack([x] * S), JSC.px_init_state(psmi))
    want = JSC.fm_chain_batch(jnp.asarray(bufs), jcar, n_blocks, psmi,
                              first_bc, px_states=jpx)
    return {"psmi": psmi, "stations": st, "bufs": bufs, "carries": carries,
            "px": px, "got": got, "want": want}


def test_fm_chain_batch_twin(fm_batch):
    """The port's fm_chain_batch (a loop over stations on the CPU) against
    JAX's vmap: PIDS, P1 (MP1) and PX1 (MP3) bits and the re-encode
    counts exact, samperr and the offsets exact, the MER sums, the PX
    margins and the IV state as stated; MP1's P1 frames and PIDS words on
    the transmitted bits."""
    (got, gc), (want, wc) = fm_batch["got"], fm_batch["want"]
    for k in ("pids", "p1", "p1_bit_errors", "px1"):
        if k in want:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=k)
    np.testing.assert_array_equal(_np(got["diag"]["samperr"]),
                                  np.asarray(want["diag"]["samperr"]))
    for k in ("error_lb", "error_ub"):
        g, w = _np(got["diag"][k]), np.asarray(want["diag"][k])
        if max(np.abs(g).max(), np.abs(w).max()) > NOISE_FLOOR:
            _close(g, w)
    np.testing.assert_array_equal(_np(gc.offset), np.asarray(wc.offset))
    _close(gc.acq.prev_angle, wc.acq.prev_angle, floor=1.0)
    _close(gc.sync.costas_phase, wc.sync.costas_phase, floor=1.0)
    if fm_batch["psmi"] == 1:
        for i, (_, p1, pids, _, _) in enumerate(fm_batch["stations"]):
            np.testing.assert_array_equal(got["p1"][i, 0].numpy(), p1[0])
            np.testing.assert_array_equal(got["pids"][i, 1:].numpy(), pids)
    else:
        _close(got["px1_margin"], want["px1_margin"])
        state, wstate = got["px_state"], want["px_state"]
        np.testing.assert_array_equal(_np(state.px1_phase),
                                      np.asarray(wstate.px1_phase))
        diff = np.abs(_np(state.px1_internal).astype(int)
                      - np.asarray(wstate.px1_internal).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _station(tree, i: int):
    """Station ``i`` of a tree (dicts, NamedTuples, tuples) of stacked
    tensors."""
    if isinstance(tree, dict):
        return {k: _station(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_station(x, i) for x in tree))
    return tree[i]


def test_fm_card_path_on_cpu(fm_batch):
    """The chain's one path (K17 and K18 in the block loop, the carry step
    taken by K18, the FEC flat over stations), whose kernel wrappers take
    their plain versions on the CPU: each station of the batch bit-exact
    against that station run alone (``fm_chain_scan``, the same path at
    one station, as turbo and the stage pipeline call it), outputs and
    carries; alone with ``plain=True`` and ``packed=True``, the batch's
    bits packed; and ``fm_frontend_scan``'s pm and diag the batch's."""
    psmi = fm_batch["psmi"]
    n_blocks, first_bc = fm_batch["stations"][0][3:]
    samples = torch.from_numpy(fm_batch["bufs"])
    got, gc = fm_batch["got"]

    def alone(i, **kw):
        px = None if fm_batch["px"] is None else TSC.index_tree(
            fm_batch["px"], i)
        return TSC.fm_chain_scan(samples[i], TSC.index_tree(
            fm_batch["carries"], i), n_blocks, psmi, first_bc, px, **kw)
    out, cy = alone(0)
    _same_tree(out, _station(got, 0))
    _same_tree(cy, TSC.index_tree(gc, 0))
    packed, cy = alone(1, packed=True, plain=True)
    _same_tree(packed, pack_out(_station(got, 1)))
    _same_tree(cy, TSC.index_tree(gc, 1))
    one = TSC.fm_frontend_scan(samples[1], TSC.index_tree(
        fm_batch["carries"], 1), n_blocks, psmi)
    assert torch.equal(pids_decode(one[0]), got["pids"][1])
    for k in one[1]:
        assert torch.equal(one[1][k], got["diag"][k][1]), k
    _same_tree(one[3], TSC.index_tree(gc, 1))


def test_am_chain_batch_twin():
    """Two MA1 stations of 2 frames: the port's am_chain_batch (K19 and
    K20 in the block loop, with the carry step, the decode flat over
    stations; each kernel wrapper's plain version on the CPU) against
    JAX's vmap, P1, P3, PIDS and the margins exact, the offsets and delay
    lines exact; station 1 run alone (``am_chain_scan``, the same path at
    one station) with ``plain=True`` bit-exact against the batch's,
    outputs and carries."""
    n = 2
    bufs = np.stack([_am_signal(np.random.default_rng([29, i]), n)[0]
                     for i in range(S)])
    carries = TSC.stack_trees([TSCA.am_chain_init_carry(device="cpu")] * S)
    got, gc = TSCA.am_chain_batch(torch.from_numpy(bufs), carries, n)
    jcar = jax.tree.map(lambda x: jnp.stack([x] * S),
                        JSCA.am_chain_init_carry())
    want, wc = JSCA.am_chain_batch(jnp.asarray(bufs), jcar, n, False)
    for k in ("p1", "p3", "pids", "p1_margin", "p3_margin"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(_np(gc.offset), np.asarray(wc.offset))
    for a, b in zip(gc.dec, wc.dec):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    out, cy = TSCA.am_chain_scan(torch.from_numpy(bufs[1]),
                                 TSC.index_tree(carries, 1), n, plain=True)
    _same_tree(out, _station(got, 1))
    _same_tree(cy, TSC.index_tree(gc, 1))


def _fm_inputs(s: int):
    g = torch.Generator().manual_seed(7)
    n = TSC.buffer_len(1)
    samples = torch.randn(s, n, 2, generator=g).contiguous()
    samples = torch.view_as_complex(samples)
    return (samples, torch.tensor([0, 300, -5][:s], dtype=torch.int32),
            torch.polar(torch.ones(s), torch.rand(s, generator=g)),
            torch.tensor([1080, 1075, 1090][:s], dtype=torch.int32),
            torch.rand(s, generator=g) * 0.1,
            torch.tensor([0, -3, 2][:s], dtype=torch.int32))


def test_wrappers_plain_on_cpu_and_no_fallback():
    """Each new wrapper (K17-K20) takes its plain version on CPU tensors,
    and the per-station forms the receivers call give the complex ops'
    own results; a tensor that is not on the CPU (here ``meta``) goes to
    the kernel's checks and raises, never to the plain version; an entry
    point asked for ``device="cuda"`` with no card raises."""
    fm = _fm_inputs(3)
    spectra, phase_out, keep = TA.demod_fm_c(*fm)
    for got, want in zip((spectra, phase_out, keep),
                         TA.demod_fm_c_plain(*fm)):
        assert torch.equal(got, want)
    # station 1 as acquire_fm demodulates its window
    window = TA.window_at(fm[0][1], fm[1][1], TA.WINDOW_FM)
    one = TA._demod(window.conj(), TA.AcquireState(fm[2][1], fm[4][1]),
                    fm[3][1], fm[4][1], fm[5][1])
    assert torch.equal(one[0], spectra[1]) and int(one[4]) == int(keep[1])

    cph = torch.rand(3, C.FFT_FM) - 0.5
    cfr = (torch.rand(3, C.FFT_FM) - 0.5) * 0.01
    tadj = torch.tensor([0, 2, -3], dtype=torch.int32)
    out, nph, nfr = TS.sync_fm_c(spectra, cph, cfr, 3, tadj)
    plain = TS.sync_fm_c_plain(spectra, cph, cfr, 3, tadj)
    _same_tree((out, nph, nfr), plain)
    blk, st = TS.sync_fm_step(spectra[2], TS.SyncState(cph[2], cfr[2]), 3,
                              tadj[2])
    want, wst = TS.sync_fm_block(spectra[2], TS.SyncState(cph[2], cfr[2]), 3,
                                 tadj[2])
    for k in want:
        assert torch.equal(blk[k], want[k]), k
    assert torch.equal(st.costas_phase, wst.costas_phase)
    assert torch.equal(out["pm"][2], want["pm"])

    g = torch.Generator().manual_seed(8)
    am = (torch.view_as_complex(torch.randn(2, TSCA.am_buffer_len(1), 2,
                                            generator=g).contiguous()),
          torch.tensor([0, 77], dtype=torch.int32),
          torch.polar(torch.ones(2), torch.rand(2, generator=g)),
          torch.tensor([135, 131], dtype=torch.int32),
          torch.rand(2, generator=g), torch.tensor([0, 1], dtype=torch.int32))
    res = TA.demod_am_c(*am)
    for got, want in zip(res, TA.demod_am_c_plain(*am)):
        assert torch.equal(got, want)
    for ma3 in (False, True):
        codes = TSA.sync_am_c(res[0], ma3)
        _same_tree(codes, TSA.sync_am_c_plain(res[0], ma3))
        blk = TSA.sync_am_step(res[0][1], ma3)
        want = TSA.sync_am_block(res[0][1], ma3)
        for k in want:
            assert torch.equal(blk[k], want[k]), k

    meta = [t.to("meta") for t in fm]
    with pytest.raises(ValueError, match="CUDA"):
        TA.demod_fm_c(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        TA.demod_am_c(*(t.to("meta") for t in am))
    with pytest.raises(ValueError, match="CUDA"):
        TS.sync_fm_c(spectra.to("meta"), cph.to("meta"), cfr.to("meta"), 3,
                     tadj.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        TSA.sync_am_c(res[0].to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSC.chain_init_carry(device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSCA.am_chain_init_carry(device="cuda")
