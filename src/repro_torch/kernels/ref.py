"""Plain PyTorch versions of the four tile kernels (twins of repro.kernels.ref).

Each function computes what its CUDA kernel computes: f32 arithmetic on
f32, bf16 or fp8 operands (widened first; PyTorch has no fp8 matmul on
the CPU), with the result in the output operand's type.  An f64 input
stays in f64, which is how :mod:`repro_torch.kernels.ops` uses them as the
stock path for f64 tiles.  The CPU tests hold these against the JAX
package, and the smoke script holds each kernel against its twin on the
card.
"""
from __future__ import annotations

import torch


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the matrix is not positive
    definite, as jnp.linalg.cholesky returns (no error, no host sync)."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info > 0, torch.full_like(l, float("nan")), l)


def potrf_ref(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrised tile, in a's type."""
    x = _wide(a)
    return cholesky_nan(0.5 * (x + x.T)).to(a.dtype)


def trsm_ref(l: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """X with X @ L^T = C, in C's type."""
    x = torch.linalg.solve_triangular(_wide(l).T, _wide(c), upper=True,
                                      left=False)
    return x.to(c.dtype)


def syrk_update_ref(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """C - A @ A^T on the lower triangle, mirrored into the upper one."""
    aw = _wide(a)
    r = (_wide(c) - aw @ aw.T).to(c.dtype)
    return torch.tril(r) + torch.tril(r, -1).T


def gemm_update_ref(c: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """C - A @ B^T with a wide accumulator, in C's type."""
    return (_wide(c) - _wide(a) @ _wide(b).T).to(c.dtype)
