"""The port's on-device FM cold start and fine acquire
(``scan_chain_rc.cold_start_device_rc``, ``acquire_fine_rc``) against the
JAX package's, and against the port's host cold start, on the CPU.

Tolerances (those of tests/test_torch_coldstart.py and
tests/test_torch_chain.py):

- the lock fields (start, first_bc, cfo, locked), samperr and keep:
  exact, against JAX and against the host cold start ``cold_start_rc``;
- the lock's angle: within 1e-6 rad of JAX's (the angle of the coarse
  timing's peak, whose sums XLA orders otherwise) and bit-equal to the
  host cold start's (the same probe);
- the acquire's spectra within 1e-5 of their largest magnitude (the same
  bf16 products summed in other orders) plus one bf16 step of the window's
  largest sample (``BF16_STEP``, 2^-8 of it): XLA's and torch's float32
  sine and cosine part by an ulp on ~6 % of the fold's entries, and where
  that ulp straddles a bf16 rounding boundary (measured: one entry in
  ~10^5) the bf16 fold differs by one bf16 step, which moves every bin of
  that symbol by up to that step; its phasor within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrsc5_tpu.pipeline import scan_chain_rc as JRC
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops.acquire_rc import WINDOW_FM
from nrsc5_tpu_torch.pipeline import scan_chain_rc as TRC
from nrsc5_tpu_torch.pipeline.scan_chain import buffer_len
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
from nrsc5_tpu_torch.tx.modulator import modulate_fm

ANGLE_ATOL = 1e-6
BF16_STEP = 2.0 ** -8
BIN_HZ = C.SAMPLE_RATE_CS16_FM / C.FFT_FM
N = WINDOW_FM + buffer_len(33)
# (timing offset, CFO in Hz, SNR) of each station with a signal: the
# self-synchronizing shards' capture (tests/test_parallel.py:165-179) and
# both signs of the integer CFO
STATIONS = [(947, 3 * BIN_HZ + 25.0, 28.0), (1357, 5 * BIN_HZ + 41.0, 25.0),
            (2789, -7 * BIN_HZ - 30.0, 25.0)]


def _station(seed: int, offset: int, cfo_hz: float, snr_db: float):
    rng = np.random.default_rng(seed)
    frames = 3
    matrix = np.concatenate([build_pm_matrix(
        rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
        rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))
        for _ in range(frames)])
    sig = modulate_fm(matrix, np.tile(np.arange(16), frames), 1)
    sig = ch.impair(sig, sample_offset=offset, cfo_hz=cfo_hz, snr_db=snr_db,
                    rng=rng)[:N]
    return np.stack([sig.real, -sig.imag], -1).astype(np.float32)


@pytest.fixture(scope="module")
def captures():
    """Three stations with a signal and one of noise only, [4, N, 2]."""
    rows = [_station(40 + i, *st) for i, st in enumerate(STATIONS)]
    noise = np.random.default_rng(7).normal(0, 0.2, (N, 2))
    return np.stack(rows + [noise.astype(np.float32)])


def test_cold_start_device_rc(captures):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = TRC.cold_start_device_rc(torch.from_numpy(captures))
        host = TRC.cold_start_rc(captures, device="cpu")
    finally:
        torch.set_num_threads(n)
    start, first_bc, cfo, angle, locked = (x.numpy() for x in got)
    assert [x.dtype for x in (start, first_bc, cfo, angle, locked)] == [
        np.int32, np.int32, np.int32, np.float32, np.bool_]
    assert locked.tolist() == [True, True, True, False]
    for i, row in enumerate(captures):
        js, jbc, jcfo, jangle, jlocked = (np.asarray(x) for x in
                                          JRC.cold_start_device_rc(
                                              jnp.asarray(row)))
        assert (start[i], first_bc[i], cfo[i], locked[i]) \
            == (js, jbc, jcfo, jlocked), i
        assert abs(float(angle[i]) - float(jangle)) <= ANGLE_ATOL, i
        lock = host[i]
        if not locked[i]:
            assert lock is None, i
            continue
        assert (lock["offset"], lock["first_bc"], lock["cfo"]) \
            == (start[i], first_bc[i], cfo[i]), i
        assert lock["carry"].prev_angle.numpy() == angle[i], i
    # the integer CFO found under the ingest's sign flip
    assert [abs(int(c)) for c in cfo[:3]] == [3, 5, 7]


@pytest.mark.parametrize("sync_samperr,sync_angle,cfo", [
    (0, 0.0, 0), (3, -0.02, 3), (-4, 0.05, -2)])
def test_acquire_fine_rc(captures, sync_samperr, sync_angle, cfo):
    """One station's window at offset 500 through JAX's ``acquire_fine_rc``
    (a window, a station) and the port's (the buffer, every station)."""
    offset, prev_angle = 500, 0.25
    phase = np.array([0.6, 0.8], np.float32)
    row = captures[0]
    want = JRC.acquire_fine_rc(
        jnp.asarray(row[offset:offset + WINDOW_FM]), jnp.asarray(phase),
        jnp.float32(prev_angle), jnp.int32(sync_samperr),
        jnp.float32(sync_angle), jnp.int32(cfo))
    js, jp, ja, jse, jk = (np.asarray(x) for x in want)

    def col(v, dtype):
        return torch.tensor([v], dtype=dtype)
    got = TRC.acquire_fine_rc(
        torch.from_numpy(row)[None], col(offset, torch.int32),
        torch.from_numpy(phase)[None], col(prev_angle, torch.float32),
        col(sync_samperr, torch.int32), col(sync_angle, torch.float32),
        col(cfo, torch.int32))
    ts, tp, ta, tse, tk = (x[0].numpy() for x in got)
    window = row[offset:offset + WINDOW_FM]
    np.testing.assert_allclose(
        ts, js, rtol=1e-4, atol=1e-5 * np.abs(js).max()
        + BF16_STEP * np.hypot(window[:, 0], window[:, 1]).max())
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=ANGLE_ATOL)
    assert ta == ja and tse == jse and tk == jk
