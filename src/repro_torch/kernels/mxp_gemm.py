"""Mixed-precision GEMM update ``C - A @ B^T`` (port of repro.kernels.mxp_gemm).

The hot kernel of the factorization: every GEMM op of the schedule, about
n^3/3 of its flops.  On a CUDA tensor :func:`mxp_gemm_update` launches the
hand-written kernel of ``csrc/mxp_gemm.cu`` (f32 FFMA accumulator seeded
with C; A and B in f32, bf16 or fp8 e4m3); on CPU tensors it runs the plain
version, :func:`repro_torch.kernels.ref.gemm_update_ref`.

Each BM x BN output tile is a thread block cluster of ``split`` CTAs, CTA
rank r summing K columns [r chunk, (r + 1) chunk) through the shared FFMA
main loop (``csrc/ffma_tile.cuh``); the partial sums meet through
distributed shared memory in rank order, rank r writing rows
:func:`share_rows` of the tile.  The launch geometry is computed here, as
plain functions the CPU tests check, and the kernel refuses any other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import gemm_update_ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_AB_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)
_C_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256           # 16 x 16 threads a CTA (csrc/ffma_tile.cuh)
SIDE = 16
MICRO = (8, 4)          # values a thread (csrc/mxp_gemm.cu TM, TN)
BM, BN = SIDE * MICRO[0], SIDE * MICRO[1]      # a tile: 128 x 64
KS = 32                 # K columns a pipeline stage; chunks are whole stages
STAGES = 2              # cp.async stages in shared memory
TARGET_CTAS = 256       # CTAs the split aims for (132 SMs, two CTAs each)
MIN_CHUNK = 2 * KS      # K columns a CTA takes before the split grows
MAX_SPLIT = 8           # CTAs a cluster (portable)

launches = 0    # kernel launches since the last ops.reset_counts()


def tiles(m: int, n: int) -> tuple[int, int]:
    """Output tiles down and across an m x n output."""
    return -(-m // BM), -(-n // BN)


def tile_origin(t: int, m: int, n: int) -> tuple[int, int]:
    """(first row, first column) of tile ``t``, row by row (the kernel's
    blockIdx.x / split)."""
    tn = tiles(m, n)[1]
    return (t // tn) * BM, (t % tn) * BN


def split_for(m: int, n: int, k: int,
              split: int | None = None) -> tuple[int, int]:
    """(split, chunk): CTAs a tile and K columns a CTA.  Unless ``split``
    is given, enough CTAs for TARGET_CTAS over all tiles, but no chunk
    below MIN_CHUNK and at most MAX_SPLIT; chunks are whole KS-column
    stages and the last CTA's is not empty."""
    if split is None:
        tm, tn = tiles(m, n)
        split = max(1, min(MAX_SPLIT, -(-TARGET_CTAS // (tm * tn)),
                           -(-k // MIN_CHUNK)))
    while True:
        chunk = -(-(-(-k // split)) // KS) * KS
        if split == 1 or (split - 1) * chunk < k:
            return split, chunk
        split -= 1


def chunk_bounds(k: int, split: int, chunk: int) -> list[tuple[int, int]]:
    """[lo, hi) of K that each rank sums."""
    return [(r * chunk, min(k, (r + 1) * chunk)) for r in range(split)]


def share_rows(rank: int, split: int) -> range:
    """Rows of a tile whose sums rank ``rank`` writes."""
    return range(rank * BM // split, (rank + 1) * BM // split)


def geometry(m: int, n: int, k: int) -> dict:
    """The launch: micro-tile, split, chunk, CTAs and shared memory a CTA
    (the stages, or the partial sums after them if larger)."""
    split, chunk = split_for(m, n, k)
    tm, tn = tiles(m, n)
    return {"micro": MICRO, "split": split, "chunk": chunk,
            "ctas": tm * tn * split, "smem": smem_bytes(4)}


def smem_bytes(itemsize: int = 4) -> int:
    """Shared memory a CTA for operands of ``itemsize`` bytes: STAGES
    stages of BM + BN rows of KS + one 16-byte vector, or the BM x (BN +
    16) f32 partial sums, whichever is larger."""
    stages = STAGES * (BM + BN) * (KS + 16 // itemsize) * itemsize
    return max(stages, BM * (BN + 16) * 4)


def mxp_gemm_update(c: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """C - A @ B^T with f32 accumulation.  a: [M,K], b: [N,K], c: [M,N]."""
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
    return _launch(c, a, b, *split_for(m, n, k))


def _launch(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, split: int,
            chunk: int) -> torch.Tensor:
    """The kernel at ``split`` CTAs a tile and ``chunk`` K columns a CTA
    (:func:`split_for`); besides the wrapper's own, only the geometry
    benchmark (benchmarks/torch_gemm_geometry.py) passes another split."""
    global launches
    (m, k), n = a.shape, b.shape[0]
    _build.require_current("mxp_gemm_update", c)
    out = torch.empty_like(c)
    fn = _build.function("mxp_gemm", "mxp_gemm_update", _ARGS)
    err = fn(c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
             m, n, k, _build.DTYPE_CODES[a.dtype],
             _build.DTYPE_CODES[c.dtype], split, chunk,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mxp_gemm_update")
    with _build.COUNT_LOCK:
        launches += 1
    return out
