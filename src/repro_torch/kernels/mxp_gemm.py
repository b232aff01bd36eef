"""Mixed-precision GEMM update ``C - A @ B^T`` (port of repro.kernels.mxp_gemm).

The hot kernel of the factorization: every GEMM op of the schedule, about
n^3/3 of its flops.  On a CUDA tensor :func:`mxp_gemm_update` launches the
hand-written kernel of ``csrc/mxp_gemm.cu`` (f32 FFMA accumulator seeded
with C; A and B in f32, bf16 or fp8 e4m3); on CPU tensors it runs the plain
version, :func:`repro_torch.kernels.ref.gemm_update_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import gemm_update_ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_AB_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)
_C_DTYPES = (torch.float32, torch.bfloat16)

launches = 0    # kernel launches since the last ops.reset_counts()


def mxp_gemm_update(c: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """C - A @ B^T with f32 accumulation.  a: [M,K], b: [N,K], c: [M,N]."""
    global launches
    m, k = a.shape
    n, kb = b.shape
    if kb != k or tuple(c.shape) != (m, n):
        raise ValueError(f"mxp_gemm_update: shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)}")
    if not _build.on_cuda("mxp_gemm_update", c, a, b):
        return gemm_update_ref(c, a, b)
    if a.dtype != b.dtype or a.dtype not in _AB_DTYPES \
            or c.dtype not in _C_DTYPES:
        raise TypeError(f"mxp_gemm_update: no kernel for a {a.dtype}, "
                        f"b {b.dtype}, c {c.dtype}")
    out = torch.empty_like(c)
    fn = _build.function("mxp_gemm", "mxp_gemm_update", _ARGS)
    with torch.cuda.device(c.device):
        err = fn(c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 m, n, k, _build.DTYPE_CODES[a.dtype],
                 _build.DTYPE_CODES[c.dtype],
                 torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(err, "mxp_gemm_update")
    launches += 1
    return out
