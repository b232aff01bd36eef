"""Triangular solve ``X @ L^T = C`` (port of repro.kernels.trsm).

Every TRSM op of the schedule.  On a CUDA tensor :func:`trsm` launches
``csrc/trsm.cu`` (one warp per row of C, forward substitution over the
columns in f32); on CPU tensors it runs the plain version,
:func:`repro_torch.kernels.ref.trsm_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import trsm_ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)
MAX_N = 4096    # eight rows of n f32 in shared memory (128 KiB)

launches = 0    # kernel launches since the last ops.reset_counts()


def trsm(l: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Solve X L^T = C.  l: [n, n] lower-triangular; c: [m, n]."""
    global launches
    m, n = c.shape
    if tuple(l.shape) != (n, n):
        raise ValueError(f"trsm: shapes l{tuple(l.shape)} c{tuple(c.shape)}")
    if not _build.on_cuda("trsm", l, c):
        return trsm_ref(l, c)
    if l.dtype not in _DTYPES or c.dtype not in _DTYPES:
        raise TypeError(f"trsm: no kernel for l {l.dtype}, c {c.dtype}")
    if n > MAX_N:
        raise ValueError(f"trsm: n={n} exceeds the kernel's {MAX_N}")
    out = torch.empty_like(c)
    fn = _build.function("trsm", "trsm", _ARGS)
    with torch.cuda.device(c.device):
        err = fn(l.data_ptr(), c.data_ptr(), out.data_ptr(), m, n,
                 _build.DTYPE_CODES[l.dtype], _build.DTYPE_CODES[c.dtype],
                 torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(err, "trsm")
    launches += 1
    return out
