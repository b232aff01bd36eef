"""Symmetric rank-k update ``C - A @ A^T`` (port of repro.kernels.syrk).

Every SYRK op of the schedule.  On a CUDA tensor :func:`syrk_update`
launches ``csrc/syrk.cu``, which computes only the blocks on or below the
diagonal and writes the mirrored upper triangle in the same pass (the
reference mirrors in its ops wrapper); on CPU tensors it runs the plain
version, :func:`repro_torch.kernels.ref.syrk_update_ref`.

Each lower TILE x TILE block is a thread block cluster of ``split`` CTAs,
CTA rank r summing K columns [r chunk, (r + 1) chunk); the partial sums
meet through distributed shared memory in rank order, rank r writing rows
:func:`share_rows` of the block.  The launch geometry is computed here, as
plain functions the CPU tests check, and the kernel refuses any other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import syrk_update_ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)
TILE = 64          # output block edge (csrc/syrk.cu)
KS = 32            # K columns a pipeline stage; chunks are whole stages
K_PER_CTA = 128    # K columns a CTA takes before the split grows
MAX_SPLIT = 4      # CTAs a cluster (the kernel takes up to 8)

launches = 0    # kernel launches since the last ops.reset_counts()


def blocks(m: int) -> int:
    """Lower TILE x TILE blocks of an m x m output, the diagonal included."""
    nb = -(-m // TILE)
    return nb * (nb + 1) // 2


def block_of(t: int) -> tuple[int, int]:
    """(block row, block column) of lower block ``t``, row by row."""
    bi = 0
    while (bi + 1) * (bi + 2) // 2 <= t:
        bi += 1
    return bi, t - bi * (bi + 1) // 2


def split_for(k: int) -> tuple[int, int]:
    """(split, chunk): CTAs a block and K columns a CTA.  One CTA per
    K_PER_CTA columns of K, at most MAX_SPLIT (4 at K = 512); chunks are
    whole KS-column stages and the last CTA's is not empty."""
    split = max(1, min(MAX_SPLIT, -(-k // K_PER_CTA)))
    while True:
        chunk = -(-(-(-k // split)) // KS) * KS
        if split == 1 or (split - 1) * chunk < k:
            return split, chunk
        split -= 1


def chunk_bounds(k: int, split: int, chunk: int) -> list[tuple[int, int]]:
    """[lo, hi) of K that each rank sums."""
    return [(r * chunk, min(k, (r + 1) * chunk)) for r in range(split)]


def share_rows(rank: int, split: int) -> range:
    """Rows of a block whose sums (and their mirror) rank ``rank`` writes."""
    return range(rank * TILE // split, (rank + 1) * TILE // split)


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
    _build.require_current("syrk_update", c)
    out = torch.empty_like(c)
    split, chunk = split_for(k)
    fn = _build.function("syrk", "syrk_update", _ARGS)
    err = fn(c.data_ptr(), a.data_ptr(), out.data_ptr(), m, k,
             _build.DTYPE_CODES[a.dtype], _build.DTYPE_CODES[c.dtype],
             blocks(m), split, chunk,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "syrk_update")
    with _build.COUNT_LOCK:
        launches += 1
    return out
