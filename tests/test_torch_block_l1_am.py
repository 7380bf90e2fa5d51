"""The port's per-block AM receiver (``pipeline/receiver_am.py``
``AMReceiver``) against the JAX package's on the CPU: the twins of
tests/test_l1_am.py:54 (MA1 clean, 101 samples late, a continuous 12 Hz
CFO at 30 dB; MA3) and :92 (the cu8 ÷32 cascade), each stream held to
JAX's frame for frame and event for event (tests/block_twins.py's
tolerances), and the JAX test's own assertions on the port's output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrsc5_tpu import constants as C
from nrsc5_tpu.ops import frontend as JFE
from nrsc5_tpu.pipeline.receiver_am import AMReceiver as JAMReceiver
from nrsc5_tpu.tx import channel as ch
from nrsc5_tpu.tx import encoder_am as EAM
from nrsc5_tpu.tx.modulator_am import modulate_am
from nrsc5_tpu_torch.ops import frontend as TFE
from nrsc5_tpu_torch.pipeline.receiver_am import AMReceiver

from . import block_twins as BT
from .test_l1_am import N_FRAMES, _frames

_one_thread = pytest.fixture(scope="module", autouse=True)(BT.one_thread)


@pytest.mark.parametrize("ma3,impair", [
    (False, dict()),
    (False, dict(sample_offset=101)),
    (False, dict(cfo_hz=12.0, snr_db=30.0)),
    (True, dict()),
])
def test_am_end_to_end(rng, ma3, impair):
    """The twin of tests/test_l1_am.py:54: the 0x5670 block lock, the
    diversity warm-up, P1 subframes of frames 5-6, a P3 frame and the PIDS
    of the locked region, MA1 and MA3."""
    p1, p3, mats = _frames(rng, ma3)
    pids = rng.integers(0, 2,
                        (N_FRAMES * 8, C.PIDS_FRAME_LEN)).astype(np.uint8)
    pids_codes = np.stack([EAM.encode_pids_am(p) for p in pids])
    psmi = C.SERVICE_MODE_MA3 if ma3 else C.SERVICE_MODE_MA1
    ref = np.stack([EAM.am_ref_bits(b % 8, psmi)
                    for b in range(N_FRAMES * 8)])
    sig = modulate_am(mats, pids_codes, ref, ma3)
    sig = ch.impair(sig, sample_rate=C.SAMPLE_RATE_CS16_AM, rng=rng,
                    **impair)

    def feed(rx):
        rx.push_cs16(sig)
        rx.flush()
    _, col = BT.l1_twin(JAMReceiver, AMReceiver, feed)
    assert ("sync", {"psmi": psmi}) in col.events
    assert col.channel(0), "no P1 frames decoded"
    want = {p1[f, i].tobytes() for f in (5, 6) for i in range(8)}
    assert len(want & {b.tobytes() for b in col.channel(0)}) >= 8
    assert any(np.array_equal(b, p3[f]) for b in col.channel(3)
               for f in (5, 6)), "no P3 frame matched"
    have_pids = {b.tobytes() for b in col.channel(-1)}
    assert {pids[i].tobytes() for i in range(32, 56)} & have_pids


def test_am_cu8_decimator_fidelity(rng):
    """The twin of tests/test_l1_am.py:92: the cu8 capture through the ÷32
    cascade tracks the baseband (correlation above 0.85 at the cascade's
    delay), and the port's cascade gives JAX's samples exactly; the AM
    receiver's push_cu8 ingests through the same cascade."""
    p1, p3, mats = _frames(rng, False)
    pids = np.stack([EAM.encode_pids_am(
        rng.integers(0, 2, 80).astype(np.uint8))
        for _ in range(N_FRAMES * 8)])
    ref = np.stack([EAM.am_ref_bits(b % 8, 1) for b in range(N_FRAMES * 8)])
    sig = modulate_am(mats, pids, ref, False, scale=0.05)
    cu8 = ch.to_cu8(ch.upsample_exact(sig, 32))
    y, _ = TFE.am_decimate(TFE.cu8_to_cf(torch.from_numpy(cu8)),
                           TFE.frontend_init_state(TFE.AM_STAGES,
                                                   device="cpu"))
    y = y.numpy()
    assert len(y) == len(sig)
    want, _ = JFE.am_decimate(JFE.cu8_to_cf(jnp.asarray(cu8)),
                              JFE.frontend_init_state(JFE.AM_STAGES))
    np.testing.assert_array_equal(y.view(np.int32),
                                  np.asarray(want).view(np.int32))
    n = 1 << 16
    ref_seg = sig[:n]
    best = max(abs(np.vdot(y[lag:lag + n], ref_seg))
               / (np.linalg.norm(y[lag:lag + n]) * np.linalg.norm(ref_seg))
               for lag in range(16))
    assert best > 0.85, f"decimated stream decorrelated: {best:.3f}"
    rx = AMReceiver(lambda *a: None, device="cpu")
    rx.push_cu8(cu8[:64 * 1000 + 17])
    rx.push_cu8(cu8[64 * 1000 + 17:64 * 3000])
    np.testing.assert_array_equal(rx.ring.view(np.int32),
                                  y[:3000].view(np.int32))
