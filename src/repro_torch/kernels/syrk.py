"""Symmetric rank-k update ``C - A @ A^T`` (port of repro.kernels.syrk).

Every SYRK op of the schedule.  On a CUDA tensor :func:`syrk_update`
launches ``csrc/syrk.cu``, which computes only the blocks on or below the
diagonal and writes the mirrored upper triangle in the same pass (the
reference mirrors in its ops wrapper); on CPU tensors it runs the plain
version, :func:`repro_torch.kernels.ref.syrk_update_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import syrk_update_ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0    # kernel launches since the last ops.reset_counts()


def syrk_update(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Symmetric C - A @ A^T from its lower triangle.  c: [M,M], a: [M,K]."""
    global launches
    m, k = a.shape
    if tuple(c.shape) != (m, m):
        raise ValueError(f"syrk_update: shapes a{tuple(a.shape)} "
                         f"c{tuple(c.shape)}")
    if not _build.on_cuda("syrk_update", c, a):
        return syrk_update_ref(c, a)
    if a.dtype not in _DTYPES or c.dtype not in _DTYPES:
        raise TypeError(f"syrk_update: no kernel for a {a.dtype}, "
                        f"c {c.dtype}")
    out = torch.empty_like(c)
    fn = _build.function("syrk", "syrk_update", _ARGS)
    with torch.cuda.device(c.device):
        err = fn(c.data_ptr(), a.data_ptr(), out.data_ptr(), m, k,
                 _build.DTYPE_CODES[a.dtype], _build.DTYPE_CODES[c.dtype],
                 torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(err, "syrk_update")
    launches += 1
    return out
