"""Real-valued complex arithmetic: I/Q as a trailing [..., 2] dimension.

PyTorch counterpart of ``nrsc5_tpu/ops/rcplx.py``.  The representation is
float32 [..., 2] with [..., 0] = Re and [..., 1] = Im, as in the reference,
so every function here takes and returns the reference's layout.  The
arithmetic is written in the reference's operation order (``ar*br - ai*bi``
and so on) so that the CPU results agree with JAX's to float rounding.

The DFT is a dense matmul against cos/sin tables with inputs rounded to
bfloat16 and float32 accumulation, as the reference evaluates it.  The two
real products of the reference are folded into one: the interleaved input
[..., 2N] times a [2N, 2N] table gives the interleaved output, and the
fftshift is a permutation of the table's columns.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def mul(a, b):
    """(a0+ia1)(b0+ib1)"""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def mul_conj(a, b):
    """a * conj(b)"""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br + ai * bi, ai * br - ar * bi], dim=-1)


def conj(a):
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def exp_i(theta):
    """e^{i theta} for real theta -> [..., 2]."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def abs2(a):
    return a[..., 0] ** 2 + a[..., 1] ** 2


def angle(a):
    return torch.atan2(a[..., 1], a[..., 0])


def ordered_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` from the first element to the last, one add at a
    time: the order the kernels sum their short sums in, so that a plain
    version rounds as its kernel does."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for v in x[1:]:
        acc = acc + v
    return acc


def fdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, a float division by the number d, as the kernels and the
    reference divide.  On a CUDA tensor PyTorch divides by a Python number
    as a product with its reciprocal, which can round one ulp apart; a
    divisor held on the tensor's device keeps the true division (on the
    CPU the two agree already)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def div(a, b):
    """a / b elementwise."""
    return mul_conj(a, b) / abs2(b)[..., None]


def scale(a, s):
    """real scalar/array multiply."""
    return a * s[..., None]


def normalize(a, eps: float = 1e-20):
    return a / torch.sqrt(abs2(a) + eps)[..., None]


@functools.lru_cache(maxsize=4)
def dft_tables(n: int):
    """Forward-DFT cos/sin matrices: X[k] = sum_n x[n] e^{-2pi i nk/N}.

    Returns (C, S) float32 [n, n] with C[j,k]=cos(2pi jk/n),
    S[j,k]=sin(2pi jk/n):  Re X = xr@C + xi@S;  Im X = xi@C - xr@S.
    """
    j = np.arange(n, dtype=np.float64)
    ang = 2 * np.pi * (j[:, None] * j[None, :] % n) / n
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=4)
def _dft_matrix(n: int, shift: bool, device: str) -> torch.Tensor:
    """[2n, 2n] float32 table M, bf16-rounded, with interleaved rows and
    columns: row 2j / 2j+1 takes Re / Im of input sample j, column 2k /
    2k+1 gives Re / Im of output bin k (fftshifted when ``shift``)."""
    c, s = (torch.from_numpy(t).to(torch.bfloat16).float()
            for t in dft_tables(n))
    m = torch.empty(n, 2, n, 2)
    m[:, 0, :, 0] = c   # xr -> Re
    m[:, 1, :, 0] = s   # xi -> Re
    m[:, 0, :, 1] = -s  # xr -> Im
    m[:, 1, :, 1] = c   # xi -> Im
    if shift:
        m = torch.roll(m, n // 2, dims=2)
    return m.reshape(2 * n, 2 * n).to(device)


def dft(x, shift: bool = False):
    """Batched forward DFT of rc tensors: x [..., N, 2] -> [..., N, 2].

    Inputs are rounded to bfloat16 and accumulated in float32, as in the
    reference (whose products are exact in float32, so only the summation
    order differs).  The product must run in full float32, so on a CUDA
    tensor this raises while TF32 float32 matmuls are allowed
    (``torch.backends.cuda.matmul.allow_tf32``, False by default).
    """
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dft needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n = x.shape[-2]
    m = _dft_matrix(n, shift, str(x.device))
    flat = x.to(torch.bfloat16).float().reshape(-1, 2 * n)
    return (flat @ m).reshape(x.shape)
