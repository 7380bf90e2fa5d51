"""The AM echo edge: who loses the bits at 30 dB through a 0.5 echo at
delay 14 (the cyclic prefix), the port or the channel.

Two captures of ``chip_smoke.py``'s AM cold-start fleet, rebuilt from
their seeds: MA1 station 0 of seed 1 at echo phase 2.0 rad (11 P3 bits
of frames 3-5 come out wrong) and MA3 station 9 of the default seed at
1.1 rad (one P3 bit).  JAX's ``cold_start_am_rc`` locks each; JAX's
``am_chain_batch_rc`` and the port's decode 6 frames from that one lock.
Both lose the same bits: every P1, P3 and PIDS bit and every margin of
frames 3-5 (after the diversity warm-up) agree, and the wrong P3 bits
are wrong in JAX's decode too.  The channel loses them, not the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nrsc5_tpu.pipeline import scan_chain_am_rc as JAR
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import state
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as TAR
from nrsc5_tpu_torch.pipeline.scan_chain_am import am_buffer_len

import chip_smoke

N_FRAMES = 6
FRAME_LEN = C.P1_AM_BLOCKS * C.BLKSZ * C.FFTCP_AM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,index,phase,lost", [
    (1, 0, 2.0, 11), (chip_smoke.SEED, 9, 1.1, 1)],
    ids=["ma1_phase2.0", "ma3_phase1.1"])
def test_am_echo_edge_is_the_channel(seed, index, phase, lost):
    st = chip_smoke.make_am_cold_station(index, seed=seed, echo_phase=phase)
    assert st["echo"] and st["ma3"] == (index >= 8)
    x = st["wire"].astype(np.float32) * np.float32(1 / 32768)
    lock = JAR.cold_start_am_rc(x)
    assert lock is not None and lock["ma3"] == st["ma3"]
    assert lock["cfo"] == st["cfo_bins"]
    ma3 = st["ma3"]
    seg = x[lock["offset"]:lock["offset"] + am_buffer_len(N_FRAMES)]
    jcarry = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None],
                                    lock["carry"])
    jout, _ = JAR.am_chain_batch_rc(jnp.asarray(seg)[None], jcarry,
                                    N_FRAMES, ma3)
    cy = lock["carry"]
    d = {k: np.asarray(getattr(cy, k))
         for k in ("offset", "phase", "prev_angle", "samperr_fb", "cfo")}
    d.update({k: np.asarray(v) for k, v in cy.dec._asdict().items()})
    tout, _ = TAR.am_chain_batch_rc(torch.from_numpy(seg)[None],
                                    state.am_carry_from_numpy(d,
                                                              device="cpu"),
                                    N_FRAMES, ma3)
    got = {k: tout[k].numpy().reshape(N_FRAMES, -1) for k in
           ("p1", "p3", "pids", "p1_margin", "p3_margin")}
    want = {k: np.asarray(jout[k]).reshape(N_FRAMES, -1) for k in got}
    for k in got:  # frames 3-5, after the diversity warm-up
        assert np.array_equal(got[k][3:], want[k][3:]), k
    tp3, jp3 = got["p3"], want["p3"]
    # the lock's first frame, counted from the first transmitted symbol
    lf = int(round((lock["offset"] + C.FFTCP_AM // 2 - st["offset"])
                   / FRAME_LEN))
    l3 = st["p3_len"]
    truth = st["p3"][lf + 3:lf + N_FRAMES, :l3]
    assert int((jp3[3:, :l3] != truth).sum()) == lost
    assert int((tp3[3:, :l3] != truth).sum()) == lost
