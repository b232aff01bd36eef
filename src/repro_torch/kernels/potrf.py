"""Single-tile Cholesky factorization (port of repro.kernels.potrf).

Every POTRF op of the schedule.  On a CUDA tensor :func:`potrf` launches
``csrc/potrf.cu`` (one block per tile, column by column in f32 over a
global workspace); on CPU tensors it runs the plain version,
:func:`repro_torch.kernels.ref.potrf_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import potrf_ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)
MAX_N = 6144    # row j of L and column j in 48 KiB of shared memory

launches = 0    # kernel launches since the last ops.reset_counts()


def potrf(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrised tile, in a's type."""
    global launches
    n = a.shape[0]
    if a.ndim != 2 or a.shape[1] != n:
        raise ValueError(f"potrf: tile must be square, got {tuple(a.shape)}")
    if not _build.on_cuda("potrf", a):
        return potrf_ref(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"potrf: no kernel for {a.dtype}")
    if n > MAX_N:
        raise ValueError(f"potrf: n={n} exceeds the kernel's {MAX_N}")
    out = torch.empty_like(a)
    work = out if a.dtype == torch.float32 else torch.empty(
        (n, n), dtype=torch.float32, device=a.device)
    fn = _build.function("potrf", "potrf", _ARGS)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), work.data_ptr(), out.data_ptr(), n,
                 _build.DTYPE_CODES[a.dtype],
                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "potrf")
    launches += 1
    return out
