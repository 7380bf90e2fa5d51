"""The FM block loop's DFT as the port computes it on a card — K2's bf16
fold, then the bf16 tensor-core DFT kernel (``csrc/dft_bf16.cu``) — held on
the CPU to its plain versions, to a Python walk of the kernel's tiling and
to the JAX package.  The kernel itself runs only on a card
(tests/test_torch_kernels.py); here the table it loads, the order it sums
in and the split of the loop into fold and DFT are checked.

Tolerances, with their reasons:

- the kernel's table equal to the JAX package's ``dft_tables`` rounded to
  bf16, fftshift included: the same table;
- the bf16 fold equal to the float32 fold rounded, and torch's rounding
  equal to JAX's: both round to nearest, ties to even;
- the walk of the kernel's tiling within 1e-5 of each row's largest
  magnitude of the plain version and of JAX's ``rc.dft(..., shift=True)``:
  the same bf16 x bf16 products, exact in float32, summed in three orders
  (the kernel's k tiles of 64 added in order, one float32 matmul, JAX's
  four [n, n] products and their two sums);
- ``scan_blocks``, the cold start's probes: bit for bit the outputs of the
  loop as it stood before the split (float32 fold, the DFT rounding its
  input in place), since the plain versions round the same values the same
  way and multiply with the same matmul.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nrsc5_tpu.ops import acquire_rc as JAQ
from nrsc5_tpu.ops import rcplx as jrc
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import acquire_rc as TAQ
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.pipeline import block_graph as BG
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
from nrsc5_tpu_torch.tx.modulator import modulate_fm

# the kernel's tiling (csrc/dft_bf16.cu): 128 x 128 output tiles, k tiles
# of 64 in order, each the sum of 4 k steps of 16 (a wgmma's depth)
TILE_ROWS = 128
K_TILE = 64
K_STEP = 16
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, beside the suite's other
    workers: its matmuls are large enough to oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operand(rows, seed, n=C.FFT_FM):
    """bf16 rc symbols [rows / 32, 32, n, 2] from a numpy seed, at the
    fold's scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.05, (rows // C.BLKSZ, C.BLKSZ, n, 2))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _walk(a, table):
    """The kernel's arithmetic in Python: rows padded with zeros to whole
    128-row tiles (the masked ragged rows); for each k tile of 64 in order,
    its part summed over k steps of 16 (part = A[:, k:k+16] @ T[:, k:k+16]^T,
    then part += the next step's, as the tensor cores chain them), then
    acc += part in float32 (every output tile of a row block walks the same
    k order, so the tiles are taken at once); the padded rows dropped."""
    n = a.shape[-2]
    x = a.float().reshape(-1, 2 * n)
    rows = x.shape[0]
    padded = -(-rows // TILE_ROWS) * TILE_ROWS
    x = torch.cat([x, x.new_zeros(padded - rows, 2 * n)])
    t = table.float()
    acc = torch.zeros(padded, 2 * n)
    for k0 in range(0, 2 * n, K_TILE):
        part = torch.zeros(padded, 2 * n)
        for k in range(k0, k0 + K_TILE, K_STEP):
            part = part + x[:, k:k + K_STEP] @ t[:, k:k + K_STEP].T
        acc = acc + part
    assert not acc[rows:].any()
    return acc[:rows].reshape(a.shape)


def _rows_close(got, want, tol=TOL):
    g = np.asarray(got, np.float32).reshape(-1, want.shape[-2] * 2)
    w = np.asarray(want, np.float32).reshape(-1, want.shape[-2] * 2)
    scale = np.abs(w).max(axis=1, keepdims=True)
    err = np.abs(g - w)
    assert (err <= tol * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("n", [256, 2048])
def test_table_layout(n):
    """The table the kernel loads, row c = output column c (re and im of
    the fftshifted bins interleaved), column 2j / 2j + 1 = Re / Im of input
    sample j: the JAX package's cos/sin tables rounded to bf16."""
    c, s = (torch.from_numpy(t).to(torch.bfloat16)
            for t in jrc.dft_tables(n))
    table = rc.dft_bf16_table(n, "cpu")
    assert table.dtype == torch.bfloat16 and table.shape == (2 * n, 2 * n)
    assert table.is_contiguous()
    t = table.view(n, 2, n, 2)  # [output bin, re/im out, sample, re/im in]
    bins = (torch.arange(n) - n // 2) % n  # fftshift: position -> bin
    assert torch.equal(t[:, 0, :, 0], c.T[bins])  # xr -> Re
    assert torch.equal(t[:, 0, :, 1], s.T[bins])  # xi -> Re
    assert torch.equal(t[:, 1, :, 0], -s.T[bins])  # xr -> Im
    assert torch.equal(t[:, 1, :, 1], c.T[bins])  # xi -> Im


@pytest.mark.parametrize("rows", [32, 512])
def test_walk_matches_plain(rows):
    """The walk of the kernel's tiling against the plain version, at one
    station's 32 rows (one ragged tile) and the dispatch's 512; the CPU
    wrapper is the plain version."""
    a = _operand(rows, 10 + rows)
    plain = rc.dft_bf16_plain(a)
    assert plain.dtype == torch.float32 and plain.shape == a.shape
    _rows_close(_walk(a, rc.dft_bf16_table(C.FFT_FM, "cpu")), plain)
    out = torch.empty_like(plain)
    assert rc.dft_bf16(a, out=out) is out and torch.equal(out, plain)


@pytest.mark.parametrize("rows", [32, 512])
def test_walk_matches_jax(rows):
    """The walk of the kernel's tiling against JAX's DFT of the same
    values (exact in bf16, so JAX's own cast keeps them)."""
    a = _operand(rows, 20 + rows)
    want = jrc.dft(jnp.asarray(a.float().numpy()), shift=True)
    _rows_close(_walk(a, rc.dft_bf16_table(C.FFT_FM, "cpu")),
                np.asarray(want))


def _capture(rng, n_stations, n_blocks, psmi=1):
    """``n_stations`` stations of ``n_blocks`` MP1 (or PX) blocks at 25 dB
    with CFOs of a few bins and Hz, as conjugated rc [S, N, 2]."""
    from nrsc5_tpu_torch.pipeline.scan_chain import px_frame_lens
    caps = []
    for i in range(n_stations):
        matrix = build_pm_matrix(
            rng.integers(0, 2, C.P1_FRAME_LEN_FM).astype(np.uint8),
            rng.integers(0, 2, (16, C.PIDS_FRAME_LEN)).astype(np.uint8))[
                :n_blocks * C.BLKSZ]
        px = {f"{k}_signs": rng.choice([-1, 1], (n_blocks * C.BLKSZ,
                                                 fl // 32)).astype(np.int8)
              for k, fl in zip(("px1", "px2"), px_frame_lens(psmi)) if fl}
        sig = modulate_fm(matrix, np.arange(n_blocks) % 16, psmi, **px)
        buf = np.zeros(len(sig) + 2 * C.FFTCP_FM, np.complex64)
        buf[C.FFTCP_FM // 2:C.FFTCP_FM // 2 + len(sig)] = sig
        buf = ch.impair(buf, cfo_hz=25.0 * (i - 1), snr_db=25.0, rng=rng)
        caps.append(np.stack([buf.real, -buf.imag], -1).astype(np.float32))
    n = min(len(c) for c in caps)
    return torch.from_numpy(np.stack([c[:n] for c in caps]))


@pytest.mark.parametrize("cfo", [-3, 0, 2])
def test_bf16_fold(cfo):
    """The bf16 fold's plain version: the float32 plain fold rounded, with
    the float32 fold's phase_out and keep; torch's rounding of the fold is
    JAX's."""
    x = _capture(np.random.default_rng(30), 2, 2)
    s = x.shape[0]
    args = (x, torch.tensor([0, 300], dtype=torch.int32),
            torch.tensor([[1.0, 0.0], [0.6, 0.8]]),
            torch.tensor([1080, 1077], dtype=torch.int32),
            torch.tensor([0.01, -0.02]), torch.full((s,), cfo,
                                                    dtype=torch.int32))
    fb, pb, kb = TAQ.demod_fold_bf16_plain(*args)
    ff, pf, kf = TAQ.demod_fold_plain(*args)
    assert fb.dtype == torch.bfloat16
    assert torch.equal(fb, ff.to(torch.bfloat16))
    assert torch.equal(pb, pf) and torch.equal(kb, kf)
    out = (torch.empty_like(fb), torch.empty_like(pb), torch.empty_like(kb))
    got = TAQ.demod_fold_bf16(*args, out=out)
    assert all(g is o for g, o in zip(got, out))
    assert torch.equal(out[0], fb)
    jb = np.asarray(jnp.asarray(ff.numpy()).astype(jnp.bfloat16)
                    .astype(jnp.float32))
    assert np.array_equal(jb, fb.float().numpy())


def test_demod_split_matches_jax():
    """K2's bf16 fold then the DFT (the walk of the kernel, and the plain
    version) against JAX's ``demod_rc`` on one window: its spectra within
    the tolerance above."""
    x = _capture(np.random.default_rng(31), 1, 2)
    win = x[0, :TAQ.WINDOW_FM].numpy()
    phase = np.array([0.6, 0.8], np.float32)
    js = JAQ.demod_rc(jnp.asarray(win), jnp.asarray(phase), jnp.int32(1079),
                      jnp.float32(0.02), jnp.int32(-2))[0]
    folded = TAQ.demod_fold_bf16(
        x, torch.zeros(1, dtype=torch.int32), torch.from_numpy(phase)[None],
        torch.tensor([1079], dtype=torch.int32), torch.tensor([0.02]),
        torch.tensor([-2], dtype=torch.int32))[0]
    want = np.asarray(js)[None]
    _rows_close(rc.dft_bf16(folded), want)
    _rows_close(_walk(folded, rc.dft_bf16_table(C.FFT_FM, "cpu")), want)


def _scan_before_split(samples, carry, n_blocks, psmi):
    """The block loop as it stood before the split, on the plain versions:
    the float32 fold, then the DFT rounding its input to bf16 in place
    (:func:`rcplx.dft_into`), K4 and K5."""
    s = samples.shape[0]
    shapes = rcc.sync_block_shapes(s, psmi)
    pm = torch.empty((n_blocks,) + shapes["pm"][0], dtype=torch.int8)
    diag = {k: torch.empty((n_blocks, s), dtype=shapes[k][1])
            for k in ("samperr", "error_lb", "error_ub")}
    px = {k: torch.empty((n_blocks,) + shapes[k][0], dtype=torch.int8)
          for k in ("px1", "px2") if k in shapes}
    state = {k: getattr(carry, k).clone()
             for k in ("offset", "prev_angle", "samperr_fb", "angle_fb")}
    state.update(samperr=torch.empty(s, dtype=torch.int32),
                 angle=torch.empty(s), timing_adj=torch.empty(
                     s, dtype=torch.int32))
    phase, cph, cfr = carry.phase, carry.costas_phase, carry.costas_freq
    BG.block_carry_plain(None, None, None, state, True)
    for b in range(n_blocks):
        folded, phase, keep = TAQ.demod_fold_plain(
            samples, state["offset"], phase, state["samperr"],
            state["angle"], carry.cfo)
        spectra = torch.empty_like(folded)
        rc.dft_into(folded, spectra, torch.empty_like(
            folded, dtype=torch.bfloat16), shift=True)
        out, cph, cfr = rcc.sync_block_rc_plain(spectra, cph, cfr, psmi,
                                                state["timing_adj"])
        pm[b] = out["pm"]
        for k in diag:
            diag[k][b] = out[k]
        for k in px:
            px[k][b] = out[k]
        BG.block_carry_plain(keep, out["samperr"], out["angle"], state,
                             False)
    loop = {"offset": state["offset"], "phase": phase,
            "prev_angle": state["prev_angle"], "costas_phase": cph,
            "costas_freq": cfr, "samperr_fb": state["samperr_fb"],
            "angle_fb": state["angle_fb"]}
    return {"pm": pm, "diag": diag, "px": px, "carry": loop}


@pytest.mark.parametrize("psmi", [1, 3])
def test_scan_blocks_bit_for_bit(psmi):
    """``scan_blocks`` on the CPU with the fold and DFT split (bf16 fold,
    ``dft_bf16``) gives the loop before the split its pm, PX soft bits,
    diagnostics and carry bit for bit, over 4 blocks of 2 stations."""
    x = _capture(np.random.default_rng(32 + psmi), 2, 5, psmi)
    carry = rcc.chain_rc_init_carry(psmi=psmi, n_stations=2, device="cpu")
    got = rcc.scan_blocks(x, carry, 4, psmi)
    want = _scan_before_split(x, carry, 4, psmi)
    assert torch.equal(got["pm"], want["pm"])
    assert set(got["px"]) == set(want["px"])
    for part in ("diag", "px", "carry"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


def test_probes_bit_for_bit():
    """The FM cold start's two probes through the split give the outputs
    of the float32 fold and the in-place-rounding DFT bit for bit."""
    x = _capture(np.random.default_rng(34), 2, 3)
    s = x.shape[0]
    samperr, angle, count = rcc.coldstart_probe_rc(x)
    zero = torch.zeros(s, dtype=torch.int32)
    unit = torch.tensor([[1.0, 0.0]]).repeat(s, 1)
    ks, kv = TAQ.coarse_timing_rc_plain(x)
    folded = TAQ.demod_fold_plain(x, zero, unit, ks, rc.angle(kv), zero)[0]
    from nrsc5_tpu_torch.ops.detect_cfo import detect_cfo_scan_rc
    assert torch.equal(samperr, ks) and torch.equal(angle, rc.angle(kv))
    assert torch.equal(count, detect_cfo_scan_rc(rc.dft(folded, shift=True)))

    offset = torch.tensor([100, 2000], dtype=torch.int32)
    cfo = torch.tensor([0, 1], dtype=torch.int32)
    got = rcc.bc_probe_rc(x, offset, angle, cfo)
    folded = TAQ.demod_fold_plain(
        x, offset, unit, torch.full((s,), C.FFTCP_FM // 2,
                                    dtype=torch.int32), angle, cfo)[0]
    zeros = torch.zeros(s, C.FFT_FM)
    out = rcc.sync_block_rc_plain(rc.dft(folded, shift=True), zeros, zeros,
                                  1, torch.zeros(s, dtype=torch.int32))[0]
    for g, k in zip(got, ("ref_ok", "ref_bc", "ref_psmi")):
        assert torch.equal(g, out[k])
