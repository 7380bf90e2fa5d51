"""The port's fused complex chains (``pipeline/scan_chain.py``
``fm_chain_scan``/``fm_chain_batch``, ``pipeline/scan_chain_am.py``
``am_chain_scan``/``am_chain_batch``) against the JAX package's on the
CPU, the twins of tests/test_scan_chain.py:39, :51, :64 and :120; and
the complex-chain states handed from JAX to the port mid-stream through
``state.block_state_to_numpy``/``block_state_from_numpy``, continuing
bit-exactly.

Tolerances (tests/test_scan_chain.py:148-168's standard): decoded bits,
re-encode counts, the per-block samperr and the carried offset exact at
these inputs (samperr may move by 1 in general: it is a rounded float);
the MER error sums within 1e-4 of the largest, or both below 1e-6 of the
block's signal power (``NOISE_FLOOR``: on a noiseless stream each sum is
the float32 rounding of the equalized symbols themselves, about 1e-10,
which the two libraries' FFTs and sums round apart), the carried float
state (phases and angles in radians) within 1e-4 of its largest magnitude
or of 1 radian, whichever is larger."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.pipeline import scan_chain as JSC
from nrsc5_tpu.pipeline import scan_chain_am as JSCA
from nrsc5_tpu.tx import encoder_am as EAM
from nrsc5_tpu.tx.modulator_am import modulate_am
from nrsc5_tpu_torch import state as ST
from nrsc5_tpu_torch.pipeline import scan_chain as TSC
from nrsc5_tpu_torch.pipeline import scan_chain_am as TSCA

from . import block_twins as BT
from .test_scan_chain import _steady_signal

# 1e-6 of one block's signal power (2 x 32 symbols x 10 partitions x 18
# carriers a sideband)
NOISE_FLOOR = 1e-6 * 2 * C.BLKSZ * C.PM_PARTITIONS * 18

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_out(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


def _close(got, want, tol=1e-4, floor=1e-30):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), floor)


def _fm(buf, carry, n_blocks, first_bc, port=True, **kw):
    if port:
        return TSC.fm_chain_scan(torch.from_numpy(buf), carry, n_blocks, 1,
                                 first_bc, **kw)
    return JSC.fm_chain_scan(jnp.asarray(buf), carry, n_blocks, 1, first_bc,
                             **kw)


def _same_fm(got, want):
    _same_out(got, want, ("p1", "p1_bit_errors", "pids"))
    _same_out(got["diag"], want["diag"], ("samperr",))
    for k in ("error_lb", "error_ub"):
        g, w = _np(got["diag"][k]), _np(want["diag"][k])
        if max(np.abs(g).max(), np.abs(w).max()) > NOISE_FLOOR:
            _close(g, w)


@pytest.mark.parametrize("snr_db", [None, 22.0])
def test_fm_chain_scan_roundtrip(rng, snr_db):
    """The twin of tests/test_scan_chain.py:39: one lead block and a P1
    frame through the fused chain: the frame and its 16 PIDS words on the
    transmitted bits, the clock locked, everything as JAX's chain."""
    buf, p1, pids, n_blocks, first_bc = _steady_signal(rng, snr_db=snr_db)
    want, wc = _fm(buf, JSC.chain_init_carry(), n_blocks, first_bc, False)
    got, gc = _fm(buf, TSC.chain_init_carry(device="cpu"), n_blocks,
                  first_bc)
    assert got["p1"].shape == (1, C.P1_FRAME_LEN_FM)
    np.testing.assert_array_equal(got["p1"][0].numpy(), p1[0])
    np.testing.assert_array_equal(got["pids"][1:].numpy(), pids[0])
    assert got["diag"]["samperr"].abs().max() <= 2
    _same_fm(got, want)
    assert int(gc.offset) == int(wc.offset)


def test_fm_chain_batch(rng):
    """The twin of tests/test_scan_chain.py:51: 3 stations (the
    reference's vmap, a loop here), each its P1 frame, as JAX's batch;
    packed outputs unpack to the same bits."""
    buf, p1, pids, n_blocks, first_bc = _steady_signal(rng)
    s = 3
    carries = TSC.stack_trees([TSC.chain_init_carry(device="cpu")] * s)
    got, gc = TSC.fm_chain_batch(torch.from_numpy(np.stack([buf] * s)),
                                 carries, n_blocks, 1, first_bc)
    jcar = jax.tree.map(lambda x: jnp.stack([x] * s), JSC.chain_init_carry())
    want, _ = JSC.fm_chain_batch(jnp.asarray(np.stack([buf] * s)), jcar,
                                 n_blocks, 1, first_bc)
    for i in range(s):
        np.testing.assert_array_equal(got["p1"][i, 0].numpy(), p1[0])
    _same_out(got, want, ("p1", "pids", "p1_bit_errors"))
    assert gc.offset.shape == (s,)
    packed, _ = TSC.fm_chain_scan(torch.from_numpy(buf),
                                  TSC.chain_init_carry(device="cpu"),
                                  n_blocks, 1, first_bc, packed=True)
    from nrsc5_tpu_torch.ops.bits import unpack_bits
    np.testing.assert_array_equal(unpack_bits(packed["p1"]),
                                  got["p1"][0].numpy())
    np.testing.assert_array_equal(unpack_bits(packed["pids"]),
                                  got["pids"][0].numpy())


def test_streaming_buffers(rng):
    """The twin of tests/test_scan_chain.py:120: two consecutive buffers
    with the carry rebased between them decode as one buffer does, and as
    JAX's do."""
    buf, p1, pids, n_blocks, first_bc = _steady_signal(rng, n_frames=2,
                                                       lead_blocks=1)
    n1 = 17
    n2 = n_blocks - n1
    out1, carry = TSC.fm_chain_scan(
        torch.from_numpy(buf[:TSC.buffer_len(n1)]),
        TSC.chain_init_carry(device="cpu"), n1, 1, first_bc)
    consumed = int(carry.offset)
    b2 = buf[consumed:consumed + TSC.buffer_len(n2)].copy()
    out2, _ = TSC.fm_chain_scan(torch.from_numpy(b2),
                                TSC.rebase_carry(carry, consumed), n2, 1,
                                (first_bc + n1) % 16)
    np.testing.assert_array_equal(out1["p1"][0].numpy(), p1[0])
    np.testing.assert_array_equal(out2["p1"][0].numpy(), p1[1])
    jout1, jcarry = JSC.fm_chain_scan(jnp.asarray(buf[:JSC.buffer_len(n1)]),
                                      JSC.chain_init_carry(), n1, 1,
                                      first_bc)
    assert int(jcarry.offset) == consumed
    jout2, _ = JSC.fm_chain_scan(jnp.asarray(b2),
                                 JSC.rebase_carry(jcarry, consumed), n2, 1,
                                 (first_bc + n1) % 16)
    _same_fm(out1, jout1)
    _same_fm(out2, jout2)


def _am_signal(rng, n, ma3=False):
    p1 = rng.integers(0, 2, (n, 8, C.P1_FRAME_LEN_AM)).astype(np.uint8)
    t3 = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    p3 = rng.integers(0, 2, (n, t3)).astype(np.uint8)
    mats = EAM.interleave_frames(
        [EAM.encode_p1_am(p1[f]) for f in range(n)],
        [EAM.encode_p3_am(p3[f], ma3) for f in range(n)], ma3)
    pids = rng.integers(0, 2, (n * 8, C.PIDS_FRAME_LEN)).astype(np.uint8)
    codes = np.stack([EAM.encode_pids_am(p) for p in pids])
    ref = np.stack([EAM.am_ref_bits(b % 8, 2 if ma3 else 1)
                    for b in range(n * 8)])
    sig = modulate_am(mats, codes, ref, ma3)
    buf = np.zeros(TSCA.am_buffer_len(n), np.complex64)
    start = C.FFTCP_AM // 2
    buf[start:start + len(sig)] = sig
    return buf, p1, p3, pids


def test_am_chain_scan(rng):
    """The twin of tests/test_scan_chain.py:64: 6 MA1 frames through the
    fused AM chain, frames 3-5 on the transmitted P1 and P3 and every PIDS
    word, and every output as JAX's chain."""
    n = 6
    buf, p1, p3, pids = _am_signal(rng, n)
    got, gc = TSCA.am_chain_scan(torch.from_numpy(buf),
                                 TSCA.am_chain_init_carry(device="cpu"), n)
    for f in range(3, n):
        np.testing.assert_array_equal(got["p1"][f].numpy(), p1[f])
        np.testing.assert_array_equal(got["p3"][f].numpy(), p3[f])
    np.testing.assert_array_equal(got["pids"].numpy(), pids)
    want, wc = JSCA.am_chain_scan(jnp.asarray(buf),
                                  JSCA.am_chain_init_carry(), n, False)
    _same_out(got, want, ("p1", "p3", "pids"))
    assert int(gc.offset) == int(wc.offset)
    for a, b in zip(gc.dec, wc.dec):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fm_handover_from_jax(rng):
    """JAX's chain decodes 9 blocks; its carry, through numpy under the
    reference's field names, continues in the port's chain over the other
    24, which hold frame 1: that frame on the transmitted bits, and the
    same P1 frame, PIDS words and carried state as JAX's own
    continuation."""
    buf, p1, pids, n_blocks, first_bc = _steady_signal(rng, n_frames=2)
    n1 = 9
    _, jc = JSC.fm_chain_scan(jnp.asarray(buf), JSC.chain_init_carry(), n1,
                              1, first_bc)
    d = ST.block_state_to_numpy(jc)
    assert set(d) == {"offset", "phase", "prev_angle", "costas_phase",
                      "costas_freq", "samperr_fb", "angle_fb"}
    tc = ST.block_state_from_numpy(d, "chain", device="cpu")
    assert tc.acq.phase.dtype == torch.complex64
    bc2 = (first_bc + n1) % 16
    got, gc2 = _fm(buf, tc, n_blocks - n1, bc2)
    want, jc2 = _fm(buf, jc, n_blocks - n1, bc2, False)
    np.testing.assert_array_equal(got["p1"][0].numpy(), p1[1])
    _same_fm(got, want)
    assert int(gc2.offset) == int(jc2.offset)
    back = ST.block_state_to_numpy(gc2)
    for k, v in ST.block_state_to_numpy(jc2).items():
        _close(back[k], v, floor=1.0)  # radians: a 1-radian floor


def test_am_handover_from_jax(rng):
    """JAX's AM chain decodes frames 0-2; its carry (acquire state, clock
    feedback, the three frames' diversity delay lines) continues in the
    port's chain over frames 3-4, which decode on the transmitted bits and
    as JAX's own continuation."""
    n = 5
    buf, p1, p3, pids = _am_signal(rng, n)
    _, jc = JSCA.am_chain_scan(jnp.asarray(buf), JSCA.am_chain_init_carry(),
                               3, False)
    tc = ST.block_state_from_numpy(ST.block_state_to_numpy(jc), "am_chain",
                                   device="cpu")
    got, gc = TSCA.am_chain_scan(torch.from_numpy(buf), tc, 2)
    want, wc = JSCA.am_chain_scan(jnp.asarray(buf), jc, 2, False)
    for f in range(2):
        np.testing.assert_array_equal(got["p1"][f].numpy(), p1[3 + f])
        np.testing.assert_array_equal(got["p3"][f].numpy(), p3[3 + f])
    _same_out(got, want, ("p1", "p3", "pids"))
    assert int(gc.offset) == int(wc.offset)


@pytest.mark.parametrize("kind", ["acquire", "sync", "frontend", "px"])
def test_block_states_round_trip(kind):
    """Each complex-chain state of JAX's, through numpy, is the port's of
    the same fields, dtypes and values, and back."""
    from nrsc5_tpu.ops import acquire as JA
    from nrsc5_tpu.ops import frontend as JFE
    from nrsc5_tpu.ops import sync_fm as JS
    rng = np.random.default_rng(3)
    want = {"acquire": JA.acquire_init_state(),
            "sync": JS.sync_init_state(),
            "frontend": JFE.frontend_init_state(5),
            "px": JSC.px_init_state(11)}[kind]
    d = ST.block_state_to_numpy(want)
    d = {k: (v + rng.integers(0, 3, v.shape).astype(v.dtype))
         for k, v in d.items()}
    got = ST.block_state_from_numpy(d, kind, device="cpu")
    back = ST.block_state_to_numpy(got)
    assert back.keys() == d.keys()
    for k in d:
        assert back[k].dtype == d[k].dtype
        np.testing.assert_array_equal(back[k], d[k])
    with pytest.raises(ValueError):
        ST.block_state_from_numpy({**d, "extra": np.zeros(1)}, kind,
                                  device="cpu")


def test_carry_real_round_trip(rng):
    """``carry_to_real`` splits each complex leaf into stacked (re, im)
    float32 as JAX's does, and ``carry_from_real`` undoes it; a carry
    after a block of decoding, as the host would read it."""
    buf, _, _, _, first_bc = _steady_signal(rng)
    _, carry = TSC.fm_chain_scan(torch.from_numpy(buf),
                                 TSC.chain_init_carry(device="cpu"), 1, 1,
                                 first_bc)
    real = TSC.carry_to_real(carry)
    assert real.acq.phase.shape == (2,) and not real.acq.phase.is_complex()
    jreal = JSC.carry_to_real(JSC.chain_init_carry())
    assert [np.shape(x) for x in jax.tree.leaves(jreal)] \
        == [tuple(x.shape) for x in TSC.tree_leaves(real)]
    back = TSC.carry_from_real(real)
    for a, b in zip(TSC.tree_leaves(back), TSC.tree_leaves(carry)):
        assert a.dtype == b.dtype and torch.equal(a, b)
