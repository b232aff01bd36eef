"""Triangular solve ``X @ L^T = C`` (port of repro.kernels.trsm).

Every TRSM op of the schedule.  On a CUDA tensor :func:`trsm` launches
``csrc/trsm.cu``: a blocked forward substitution in f32, one block per
panel of ROWS rows of C, walking L's 64-column blocks (a register-tiled
FFMA update from the solved columns, then a solve against the diagonal
block in shared memory).  On CPU tensors it runs the plain version,
:func:`repro_torch.kernels.ref.trsm_ref`.

The launch geometry is computed here, as plain functions the CPU tests
check, and the kernel refuses any other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import trsm_ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)
MAX_N = 4096    # a block's ROWS rows of X, n f32 each, in shared memory
NB = 64         # column block edge (csrc/tri_block.cuh)
KC = 64         # columns of L's panel staged at a time (csrc/trsm.cu)
ROWS = 4        # rows of C a block, a warp each in the solve (csrc/trsm.cu)

launches = 0    # kernel launches since the last ops.reset_counts()


def blocks(m: int) -> int:
    """Blocks of a launch: one per ROWS rows of C."""
    return -(-m // ROWS)


def smem_bytes(n: int) -> int:
    """Shared memory a block: its rows of X, one staged chunk of L's panel
    and the diagonal block (NB + 1 floats a row), its diagonal and the
    diagonal's reciprocals."""
    return 4 * (ROWS * n + KC * (NB + 1) + NB * (NB + 1) + 2 * NB)


def block_rows(m: int, block: int) -> range:
    """Rows of C that ``block`` solves (warps past m idle)."""
    return range(block * ROWS, min(m, (block + 1) * ROWS))


def column_blocks(n: int) -> list[tuple[int, int]]:
    """(first column, width) of each column block of the walk."""
    return [(j0, min(NB, n - j0)) for j0 in range(0, n, NB)]


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
    _build.require_current("trsm", c)
    out = torch.empty_like(c)
    fn = _build.function("trsm", "trsm", _ARGS)
    err = fn(l.data_ptr(), c.data_ptr(), out.data_ptr(), m, n,
             _build.DTYPE_CODES[l.dtype], _build.DTYPE_CODES[c.dtype],
             ROWS, blocks(m), smem_bytes(n),
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "trsm")
    with _build.COUNT_LOCK:
        launches += 1
    return out
