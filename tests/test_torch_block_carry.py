"""K5's carry step fused into K4 (FM) and K13 (AM), on the CPU.

The block loops (``scan_chain_rc.scan_blocks``,
``scan_chain_am_rc.scan_blocks_am``) hand K4 and K13 the loop's carry, and
their plain versions take K5's step after the block
(``block_graph.block_carry_plain``, ``block_carry_am_plain``), as the
kernels do on the card.  Here the fused loops, on the plain versions,
against:

- the loop of the structure before the fusion: K4 or K13 without the
  carry, then K5's step as a launch of its own: every output and every
  carry field bit for bit (the same operations in the same order);
- the JAX package's scans, station by station (FM:
  ``frontend_scan_rc``; AM: ``_am_frontend_gather_scan``'s block step,
  run block by block): the consumed samples (offset) and samperr_fb
  exactly; FM's pm within ±1 on at most 1 % of the soft bits, diag
  samperr within ±1, the MER sums within rtol 1e-3 and the angles and
  phases within 2e-4 rad (the port's FM fold and DFT round to bf16,
  JAX's run float32, and each block's Costas state feeds the next: the
  tolerances of tests/test_torch_chain.py); AM's codes, PIDS codes and
  phases as JAX's (noiseless stations, the port's fold and DFT round as
  JAX's do), phases within 2e-4 rad;
- the off-switch: K4 and K13 without a carry (the cold starts' probes)
  give the same outputs as with one, and touch no carry tensor.

Shapes are small (2 stations, 6 FM blocks, 8 AM blocks); the module runs
with one torch thread.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nrsc5_tpu.pipeline import scan_chain_am_rc as JAR
from nrsc5_tpu.pipeline import scan_chain_rc as JRC
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch.ops import acquire_rc as TAQ
from nrsc5_tpu_torch.ops import rcplx as rc
from nrsc5_tpu_torch.pipeline import block_graph as BG
from nrsc5_tpu_torch.pipeline import scan_chain_am_rc as scar
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc
from nrsc5_tpu_torch.pipeline.scan_chain import px_frame_lens
from nrsc5_tpu_torch.tx import channel as ch
from nrsc5_tpu_torch.tx import encoder_am as EAM
from nrsc5_tpu_torch.tx.encoder import build_pm_matrix
from nrsc5_tpu_torch.tx.modulator import modulate_fm
from nrsc5_tpu_torch.tx.modulator_am import modulate_am

N_STATIONS, FM_BLOCKS, AM_BLOCKS = 2, 6, 8
ANGLE_ATOL = 2e-4
_FM_ANGLES = ("phase", "prev_angle", "costas_phase", "costas_freq",
              "angle_fb")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fm_capture(rng, psmi):
    """N_STATIONS stations of FM_BLOCKS + 1 blocks at 25 dB with CFOs of
    -25, 0 Hz, frame-aligned, as conjugated rc [S, N, 2]."""
    n_blocks = FM_BLOCKS + 1
    caps = []
    for i in range(N_STATIONS):
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
    return torch.from_numpy(np.stack(caps))


def _am_capture(rng, ma3):
    """N_STATIONS noiseless AM stations of AM_BLOCKS // 8 + 1 frames,
    frame-aligned, as rc [S, N, 2]."""
    n_frames = AM_BLOCKS // 8 + 1
    p3_len = C.P3_FRAME_LEN_MA3 if ma3 else C.P3_FRAME_LEN_MA1
    caps = []
    for _ in range(N_STATIONS):
        mats = EAM.interleave_frames(
            [EAM.encode_p1_am(rng.integers(0, 2, (8, C.P1_FRAME_LEN_AM))
                              .astype(np.uint8)) for _ in range(n_frames)],
            [EAM.encode_p3_am(rng.integers(0, 2, p3_len).astype(np.uint8),
                              ma3) for _ in range(n_frames)], ma3)
        pids = np.stack([EAM.encode_pids_am(rng.integers(
            0, 2, C.PIDS_FRAME_LEN).astype(np.uint8))
            for _ in range(8 * n_frames)])
        ref = np.stack([EAM.am_ref_bits(b % 8, 2 if ma3 else 1)
                        for b in range(8 * n_frames)])
        sig = modulate_am(mats, pids, ref, ma3)
        buf = np.zeros((scar.am_buffer_len(n_frames), 2), np.float32)
        start = C.FFTCP_AM // 2
        buf[start:start + len(sig)] = np.stack([sig.real, sig.imag], -1)
        caps.append(buf)
    return torch.from_numpy(np.stack(caps))


def _fm_stepwise(samples, carry, n_blocks, psmi):
    """The FM loop of the structure before the fusion, on the plain
    versions: K4 without the carry, then K5's step after each block."""
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
                 angle=torch.empty(s),
                 timing_adj=torch.empty(s, dtype=torch.int32))
    phase, cph, cfr = carry.phase, carry.costas_phase, carry.costas_freq
    BG.block_carry_plain(None, None, None, state, True)
    for b in range(n_blocks):
        folded, phase, keep = TAQ.demod_fold_bf16_plain(
            samples, state["offset"], phase, state["samperr"],
            state["angle"], carry.cfo)
        out, cph, cfr = rcc.sync_block_rc_plain(
            rc.dft_bf16_plain(folded), cph, cfr, psmi, state["timing_adj"])
        pm[b] = out["pm"]
        for k in diag:
            diag[k][b] = out[k]
        for k in px:
            px[k][b] = out[k]
        BG.block_carry_plain(keep, out["samperr"], out["angle"], state,
                             False)
    return {"pm": pm, "diag": diag, "px": px, "carry": {
        "offset": state["offset"], "phase": phase,
        "prev_angle": state["prev_angle"], "costas_phase": cph,
        "costas_freq": cfr, "samperr_fb": state["samperr_fb"],
        "angle_fb": state["angle_fb"]}}


def _am_stepwise(samples, carry, n_blocks, ma3):
    """The AM loop of the structure before the fusion, on the plain
    versions: K13 without the carry, then K5's step after each block."""
    s = samples.shape[0]
    shapes = scar.sync_am_block_shapes(s)
    codes = torch.empty((n_blocks,) + shapes["codes"][0], dtype=torch.uint8)
    pids = torch.empty((n_blocks,) + shapes["pids"][0], dtype=torch.uint8)
    offset, samperr_fb = carry.offset.clone(), carry.samperr_fb.clone()
    phase, prev_angle = carry.phase.clone(), carry.prev_angle.clone()
    fshape = (s, C.BLKSZ, C.FFT_AM, 2)
    for b in range(n_blocks):
        spectra, keep = torch.empty(fshape), torch.empty(s, dtype=torch.int32)
        nphase, nprev = torch.empty(s, 2), torch.empty(s)
        scar.acquire_am_fine_rc(samples, offset, phase, samperr_fb,
                                prev_angle, carry.cfo, True,
                                (spectra, nphase, nprev, keep),
                                (torch.empty(fshape), torch.empty(fshape)))
        out = scar.sync_am_block_rc_plain(spectra, ma3)
        codes[b], pids[b] = out["codes"], out["pids"]
        samperr_fb = out["samperr"]
        phase, prev_angle = nphase, nprev
        BG.block_carry_am_plain(keep, offset)
    return {"codes": codes, "pids": pids, "carry": {
        "offset": offset, "phase": phase, "prev_angle": prev_angle,
        "samperr_fb": samperr_fb}}


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    else:
        assert torch.equal(got, want), path


@pytest.fixture(scope="module", params=[1, 3], ids=["mp1", "mp3"])
def fm_run(request):
    psmi = request.param
    x = _fm_capture(np.random.default_rng(0xB10C + psmi), psmi)
    carry = rcc.chain_rc_init_carry(psmi=psmi, n_stations=N_STATIONS,
                                    device="cpu")
    return {"psmi": psmi, "x": x, "carry": carry,
            "fused": rcc.scan_blocks(x, carry, FM_BLOCKS, psmi)}


@pytest.fixture(scope="module", params=[False, True], ids=["ma1", "ma3"])
def am_run(request):
    ma3 = request.param
    x = _am_capture(np.random.default_rng(0xB11C + ma3), ma3)
    carry = scar.am_chain_rc_init_carry(n_stations=N_STATIONS, device="cpu")
    return {"ma3": ma3, "x": x, "carry": carry,
            "fused": scar.scan_blocks_am(x, carry, AM_BLOCKS, ma3)}


def test_fm_fused_equals_stepwise(fm_run):
    """The FM loop with K5's step inside K4's plain version gives the
    step-by-step loop's pm, PX soft bits, diagnostics and carry bit for
    bit."""
    want = _fm_stepwise(fm_run["x"], fm_run["carry"], FM_BLOCKS,
                        fm_run["psmi"])
    _assert_same(fm_run["fused"], want)


def test_fm_fused_matches_jax(fm_run):
    """The fused FM loop against JAX's ``frontend_scan_rc``, station by
    station, within the tolerances above."""
    psmi, fused = fm_run["psmi"], fm_run["fused"]
    scan = jax.jit(JRC.frontend_scan_rc, static_argnums=(2, 3))
    for s in range(N_STATIONS):
        pm, diag, _, jc = scan(jnp.asarray(fm_run["x"][s].numpy()),
                               JRC.chain_rc_init_carry(psmi=psmi),
                               FM_BLOCKS, psmi)
        d = (fused["pm"][:, s].int() - torch.from_numpy(
            np.array(pm)).int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.01
        assert np.abs(fused["diag"]["samperr"][:, s].numpy()
                      - np.asarray(diag["samperr"])).max() <= 1
        for k in ("error_lb", "error_ub"):
            np.testing.assert_allclose(fused["diag"][k][:, s].numpy(),
                                       np.asarray(diag[k]), rtol=1e-3)
        for k, v in fused["carry"].items():
            ref = np.asarray(getattr(jc, k))
            if k in _FM_ANGLES:
                np.testing.assert_allclose(v[s].numpy(), ref, rtol=1e-4,
                                           atol=ANGLE_ATOL, err_msg=k)
            else:
                assert np.array_equal(v[s].numpy(), ref), k


def test_am_fused_equals_stepwise(am_run):
    """The AM loop with K5's step inside K13's plain version gives the
    step-by-step loop's codes, PIDS codes and carry bit for bit."""
    want = _am_stepwise(am_run["x"], am_run["carry"], AM_BLOCKS,
                        am_run["ma3"])
    _assert_same(am_run["fused"], want)


def test_am_fused_matches_jax(am_run):
    """The fused AM loop against the JAX scan's block step, run block by
    block for each station: the codes, PIDS codes, offset and samperr_fb
    exactly, the phases within 2e-4 rad."""
    ma3, fused = am_run["ma3"], am_run["fused"]
    acquire = jax.jit(JAR.acquire_am_fine_rc)
    sync = jax.jit(JAR.sync_am_block_rc, static_argnums=1)
    for s in range(N_STATIONS):
        x = jnp.asarray(am_run["x"][s].numpy())
        cy = JAR.am_chain_rc_init_carry()
        offset, phase, prev_angle = int(cy.offset), cy.phase, cy.prev_angle
        samperr_fb, cfo = cy.samperr_fb, cy.cfo
        for b in range(AM_BLOCKS):
            window = x[offset:offset + scar.WINDOW_AM]
            spectra, phase, prev_angle, _, keep, _ = acquire(
                window, phase, prev_angle, samperr_fb, cfo)
            out = sync(spectra, ma3)
            for i, k in enumerate(("pl", "pu", "s", "t")):
                assert np.array_equal(fused["codes"][b, s, i].numpy(),
                                      np.asarray(out[k])), (b, k)
            assert np.array_equal(fused["pids"][b, s].numpy(),
                                  np.asarray(out["pids"])), b
            offset += scar.WINDOW_AM - int(keep)
            samperr_fb = out["samperr"]
        got = fused["carry"]
        assert int(got["offset"][s]) == offset
        assert int(got["samperr_fb"][s]) == int(samperr_fb)
        np.testing.assert_allclose(got["phase"][s].numpy(),
                                   np.asarray(phase), atol=ANGLE_ATOL)
        np.testing.assert_allclose(got["prev_angle"][s].numpy(),
                                   np.asarray(prev_angle), atol=ANGLE_ATOL)


def _fm_block(psmi):
    """One block's spectra, Costas rows and timing_adj for K4, and a carry
    for its step (random per-station state)."""
    x = _fm_capture(np.random.default_rng(40 + psmi), psmi)
    s = x.shape[0]
    carry = rcc.chain_rc_init_carry(psmi=psmi, n_stations=s, device="cpu")
    folded, _, keep = TAQ.demod_fold_bf16_plain(
        x, carry.offset, carry.phase,
        torch.full((s,), C.FFTCP_FM // 2, dtype=torch.int32),
        torch.zeros(s), carry.cfo)
    args = (rc.dft_bf16_plain(folded), carry.costas_phase,
            carry.costas_freq, psmi, torch.zeros(s, dtype=torch.int32))
    g = torch.Generator().manual_seed(psmi)
    step = {"offset": torch.randint(0, 9000, (s,), generator=g,
                                    dtype=torch.int32),
            "prev_angle": torch.randn(s, generator=g),
            "samperr_fb": torch.randint(-9, 9, (s,), generator=g,
                                        dtype=torch.int32),
            "angle_fb": torch.randn(s, generator=g),
            "samperr": torch.randint(1070, 1090, (s,), generator=g,
                                     dtype=torch.int32),
            "angle": torch.randn(s, generator=g),
            "timing_adj": torch.zeros(s, dtype=torch.int32), "keep": keep}
    return args, step


@pytest.mark.parametrize("psmi", [1, 11])
def test_k4_carry_off_switch(psmi):
    """K4's plain version with a carry gives the outputs it gives without
    one (the FM cold start's probe 2 passes none), and its step is
    ``block_carry_plain``'s on its own samperr and angle; without a carry
    no carry tensor moves."""
    args, step = _fm_block(psmi)
    before = {k: v.clone() for k, v in step.items()}
    plain = rcc.sync_block_rc_plain(*args)
    _assert_same({k: v for k, v in step.items()}, before)
    fused = rcc.sync_block_rc(*args, step)
    _assert_same(fused[0], plain[0])
    assert torch.equal(fused[1], plain[1]) and torch.equal(fused[2],
                                                           plain[2])
    want = {k: v.clone() for k, v in before.items()}
    BG.block_carry_plain(want["keep"], plain[0]["samperr"],
                         plain[0]["angle"], want, False)
    _assert_same(step, want)


@pytest.mark.parametrize("ma3", [False, True], ids=["ma1", "ma3"])
def test_k13_carry_off_switch(ma3):
    """K13's plain version with a carry gives the outputs it gives without
    one (the AM cold start's probe block passes none) and adds WINDOW_AM -
    keep to offset; without one offset stays."""
    x = _am_capture(np.random.default_rng(50 + ma3), ma3)
    carry = scar.am_chain_rc_init_carry(n_stations=N_STATIONS, device="cpu")
    spectra, _, _, keep = scar.acquire_am_fine_rc(
        x, carry.offset, carry.phase, carry.samperr_fb, carry.prev_angle,
        carry.cfo, True)
    offset = torch.tensor([123, 4567], dtype=torch.int32)
    plain = scar.sync_am_block_rc(spectra, ma3)
    fused = scar.sync_am_block_rc(spectra, ma3, (keep, offset))
    _assert_same(fused, plain)
    assert torch.equal(offset, torch.tensor([123, 4567], dtype=torch.int32)
                       + scar.WINDOW_AM - keep)


def test_carry_checks():
    """A carry whose next timing_adj is the one K4 reads, or of the wrong
    shape, is refused; so is a K13 carry of the wrong shape."""
    args, step = _fm_block(1)
    with pytest.raises(ValueError, match="ping-pong"):
        rcc.sync_block_rc(*args[:4], step["timing_adj"], step)
    bad = {**step, "angle": torch.zeros(3)}
    with pytest.raises(ValueError, match="angle"):
        rcc.sync_block_rc(*args, bad)
    spectra = torch.zeros(N_STATIONS, C.BLKSZ, C.FFT_AM, 2)
    with pytest.raises(ValueError, match="offset"):
        scar.sync_am_block_rc(spectra, False, (
            torch.zeros(N_STATIONS, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32)))


def test_loops_launch_k5_once_am_never(monkeypatch):
    """The FM loop calls K5's wrapper once (block 0's step from the carry)
    and the AM loop never: the later steps ride in K4 and K13."""
    calls = {"fm": 0, "am": 0}

    def count(kind, fn):
        def run(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(rcc, "block_carry", count("fm", BG.block_carry))
    monkeypatch.setattr(BG, "block_carry_am", count("am",
                                                    BG.block_carry_am))
    x = _fm_capture(np.random.default_rng(60), 1)
    rcc.scan_blocks(x, rcc.chain_rc_init_carry(n_stations=N_STATIONS,
                                               device="cpu"), 3)
    xa = _am_capture(np.random.default_rng(61), False)
    scar.scan_blocks_am(xa, scar.am_chain_rc_init_carry(
        n_stations=N_STATIONS, device="cpu"), 2)
    assert calls == {"fm": 1, "am": 0}
