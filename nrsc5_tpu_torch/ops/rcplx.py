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
fftshift is a permutation of the table's columns.  The FM paths' 2048-point
DFT runs as a bf16 tensor-core kernel (:func:`dft_bf16`,
``csrc/dft_bf16.cu``) on K2's bf16 fold; the AM block loop's DFTs are the
float32 matmul alone (:func:`dft_rounded_into`) on K12's fold, which K12
writes already rounded; :func:`dft` rounds its input itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nrsc5_tpu_torch import kernels as K


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
    order differs).  :func:`dft_into` on a copy of ``x`` and buffers of
    its own."""
    work = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    work.copy_(x)
    return dft_into(work, torch.empty_like(work),
                    torch.empty_like(work, dtype=torch.bfloat16), shift)


def dft_into(x, out, scratch, shift: bool = False):
    """:func:`dft` of ``x`` [..., N, 2] (float32, contiguous) into ``out``
    with no allocation, for a loop that runs inside a CUDA graph: ``x`` is
    rounded to bfloat16 in place through ``scratch`` (a bfloat16 tensor
    of x's shape), then :func:`dft_rounded_into`."""
    scratch.copy_(x)
    x.copy_(scratch)
    return dft_rounded_into(x, out, shift)


def dft_rounded_into(x, out, shift: bool = False):
    """:func:`dft_into` of an ``x`` whose entries are bfloat16 values
    already (the AM fold writes them so, :func:`round_bf16`): the
    float32 matmul alone, into ``out``.  The product must run in full
    float32, so on a CUDA tensor this raises while TF32 float32 matmuls
    are allowed (``torch.backends.cuda.matmul.allow_tf32``, False by
    default)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dft needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n = x.shape[-2]
    m = _dft_matrix(n, shift, str(x.device))
    torch.matmul(x.view(-1, 2 * n), m, out=out.view(-1, 2 * n))
    return out


def round_bf16(x):
    """``x`` rounded to bfloat16 (to nearest, ties to even) and widened
    back to float32: the DFT's rounding of its input."""
    return x.to(torch.bfloat16).to(torch.float32)


@functools.lru_cache(maxsize=4)
def dft_bf16_table(n: int, device: str) -> torch.Tensor:
    """The DFT kernel's table: :func:`_dft_matrix` ``(n, shift=True)``
    transposed, in bfloat16 (exact: its entries are bf16-rounded already),
    [2n, 2n] with row c holding output column c's weights over the 2n
    interleaved inputs, so that the kernel reads both operands K-major."""
    m = _dft_matrix(n, True, "cpu")
    return m.t().contiguous().to(torch.bfloat16).to(device)


def _check_dft_bf16(a):
    if a.ndim < 2 or a.shape[-1] != 2 or (2 * a.shape[-2]) % 128:
        raise ValueError(f"a: expected [..., N, 2] with 2N a multiple of "
                         f"128, got {tuple(a.shape)}")


def dft_bf16_plain(a):
    """Plain version of :func:`dft_bf16`: the fftshifted forward DFT of
    bfloat16 rc symbols a [..., N, 2] as a float32 matmul of the widened
    input with the bf16-rounded table, the arithmetic :func:`dft_into`
    runs (float32 [..., N, 2]).  On a CUDA tensor it refuses TF32."""
    _check_dft_bf16(a)
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dft needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n = a.shape[-2]
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    torch.matmul(a.float().view(-1, 2 * n),
                 _dft_matrix(n, True, str(a.device)),
                 out=out.view(-1, 2 * n))
    return out


def dft_bf16(a, out=None):
    """The fftshifted forward DFT of bf16 rc symbols: a [..., N, 2]
    bfloat16 (K2's bf16 fold) -> float32 [..., N, 2], written into ``out``
    where it is given.  Each product of a bf16 input and a bf16 table entry
    is exact in float32, so the kernel and the plain version form the same
    products and differ only in the order of their float32 sums.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (``csrc/dft_bf16.cu``: wgmma on 128 x 128 output tiles, a fixed
    K order, any number of rows)."""
    if a.device.type == "cpu":
        res = dft_bf16_plain(a)
        return res if out is None else K.into(out, res)
    _check_dft_bf16(a)
    K.check(a, "a", torch.bfloat16)
    if out is None:
        out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    K.check(out, "out", torch.float32, a.shape)
    n = a.shape[-2]
    table = dft_bf16_table(n, str(a.device))
    K.launch("dft_bf16", a.data_ptr(), table.data_ptr(), out.data_ptr(),
             a.numel() // (2 * n), 2 * n, device=a.device)
    return out
