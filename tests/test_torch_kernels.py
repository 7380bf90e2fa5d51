"""Each hand kernel of the port against its plain PyTorch version, on the
card.  Needs a CUDA card and ``nvcc`` (the kernels build at first use);
without a card every test here skips.  On the card, run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest``: tests/conftest.py imports JAX, which these tests do not
need.)

Tolerances: K1 (halfband) and K7 (Viterbi) exact — no FMA contraction and
the same operation order, and integer path metrics; K2 (demod fold) and K3
(Costas) 1e-5 of the largest value — float32 sin, cos and atan2 may differ
in the last bit between the kernel's build and PyTorch's.
"""

import numpy as np
import pytest
import torch

from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import kernels as K
from nrsc5_tpu_torch.ops import acquire_rc as AQ
from nrsc5_tpu_torch.ops import convolutional as CV
from nrsc5_tpu_torch.ops import frontend as FE
from nrsc5_tpu_torch.pipeline import scan_chain_rc as rcc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, tol):
    scale = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= tol * scale


def test_halfband_cu8(card):
    g = torch.Generator().manual_seed(1)
    wire = torch.randint(0, 256, (3, 14 + 2 * 100_003, 2), generator=g,
                         dtype=torch.uint8).to(card)
    before = K.COUNTS["halfband_cu8"]
    got = FE.ingest_fm_cu8(wire)
    assert K.COUNTS["halfband_cu8"] == before + 1
    assert torch.equal(got, FE.ingest_fm_cu8_plain(wire))
    with pytest.raises(ValueError):
        FE.ingest_fm_cu8(wire.float())


@pytest.mark.parametrize("cfo", [-7, 0, 5])
def test_demod_fold(card, cfo):
    g = torch.Generator().manual_seed(2)
    s = 3
    samples = torch.randn(s, AQ.WINDOW_FM + 5000, 2, generator=g).to(card)
    offset = torch.tensor([0, 2500, 10_000], dtype=torch.int32, device=card)
    phase = torch.nn.functional.normalize(torch.randn(s, 2, generator=g),
                                          dim=-1).to(card)
    samperr = torch.tensor([1080, -3, 2500], dtype=torch.int32, device=card)
    angle = torch.tensor([0.01, -0.3, 0.2], device=card)
    cfos = torch.full((s,), cfo, dtype=torch.int32, device=card)
    args = (samples, offset, phase, samperr, angle, cfos)
    for got, want in zip(AQ.demod_fold(*args), AQ.demod_fold_plain(*args)):
        if want.dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            _close(got, want, 1e-5)


@pytest.mark.parametrize("with_cfo", [False, True])
def test_costas_track(card, with_cfo):
    g = torch.Generator().manual_seed(3)
    n = 1000
    # refs near the real axis, as locked reference subcarriers sit
    refs = torch.randn(C.BLKSZ, n, 2, generator=g) * torch.tensor([1.0, 0.2])
    refs = refs.to(card)
    ph0 = ((torch.rand(n, generator=g) - 0.5) * 0.2).to(card)
    fr0 = ((torch.rand(n, generator=g) - 0.5) * 0.01).to(card)
    cf = ((torch.rand(n, generator=g) - 0.5) * 0.5).to(card) \
        if with_cfo else None
    got = rcc.costas_track_rc(refs, ph0, fr0, cf)
    want = rcc.costas_track_rc_plain(refs, ph0, fr0, cf)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("length,sigma", [(144, 0.5), (1343, 0.5),
                                          (1343, 1.2)])
def test_viterbi_k7(card, length, sigma):
    rng = np.random.default_rng(4)
    b = 70
    bits = rng.integers(0, 2, (b, length)).astype(np.uint8)
    coded = CV.conv_encode(bits, 7, C.CONV_K7_GEN).reshape(b, length, 3)
    soft = (coded * 2.0 - 1.0) * 40 + rng.normal(0, sigma * 40, coded.shape)
    ext = torch.from_numpy(np.clip(np.round(soft), -127, 127)
                           .astype(np.float32)).to(card)
    kb, km = CV.acs_traceback(ext, C.CONV_K7_GEN)
    pb, pm = CV.acs_traceback_plain(ext, C.CONV_K7_GEN)
    assert torch.equal(kb, pb)
    assert torch.equal(km, pm)
