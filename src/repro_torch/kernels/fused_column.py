"""One fused column step in one launch (port of repro.kernels.fused_column).

The whole compute group of one column step of the factorization: for every
row r of ``c_stack`` the update wave ``C_r - sum_k H[r, k] @ B[k]^T``; with
``with_diag``, row 0 is then factored (POTRF) and rounded through its class,
and every later row solves ``X L^T = C_r`` against that stored, rounded
factor; without it every row solves against ``l_kk``.  Each row is then
rounded through its storage class (``cls_ids``, -1 leaves a row unrounded).

On CUDA tensors :func:`fused_column_step` launches ``csrc/fused_column.cu``
once (a cooperative grid whose phases are separated by grid-wide barriers);
on CPU tensors it runs the plain version, :func:`fused_column_step_ref`.
The arithmetic runs in the accumulator type: f64 for f64 tiles, else f32.

Each phase walks a work list grid-stride, block b taking items b, b +
grid, ...: the wave's output blocks (:func:`wave_items`, on the shared FFMA
main loop of ``csrc/ffma_tile.cuh``), the blocked factor's steps (the
standalone POTRF's, ``csrc/potrf_blocked.cuh``, whose work lists are
``potrf.steps``, ``potrf.panel_rows`` and ``potrf.trailing_tiles``) and the
row solves' items (:func:`solve_items`).  The wave's and the solves' lists
and the shared memory a block (:func:`smem_bytes`) are plain functions the
CPU tests check; the wrapper passes the two lists' lengths and the shared
memory to the kernel, which refuses any other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, potrf
from .ref import _round, cholesky_nan

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
         + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_GRID_ARGS = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
_DTYPES = (torch.float64, torch.float32)
#: class codes of csrc/fused_column.cu (enum Cls); -1 leaves a row unrounded
CLASS_CODES = {"f64": 0, "f32": 1, "f16": 2, "bf16": 3, "f8e4m3": 4,
               "f8e4m3s": 5}
MAX_ROWS = 256      # the class codes ride in the kernel's parameters
MAX_TB = 1024       # eight rows of the solve in shared memory (64 KiB f64)
THREADS = 256       # every phase (csrc/fused_column.cu)
WARPS = THREADS // 32
NB = 64             # diagonal and column blocks (csrc/tri_block.cuh)
NB_LD = NB + 1
SOLVE_ROWS = 8      # rows of one tile a solve item, one a warp
KC = NB             # columns of L's panel a solve chunk
#: the wave's geometry by tile type: (values a thread down, across, K
#: columns a stage); a block of 16 x 16 threads, two cp.async stages
WAVE = {torch.float32: (8, 4, 32), torch.float64: (4, 4, 16)}
WAVE_STAGES = 2

launches = 0    # kernel launches since the last ops.reset_counts()


def wave_tile(dtype) -> tuple[int, int]:
    """(rows, columns) of the wave's output block."""
    tm, tn, _ = WAVE[dtype]
    return 16 * tm, 16 * tn


def wave_items(r_tiles: int, tb: int, dtype) -> list[tuple[int, int, int]]:
    """(row tile, first row, first column) of each output block of the
    wave, in the kernel's order; blocks past tb are masked."""
    bm, bn = wave_tile(dtype)
    return [(r, m0, n0) for r in range(r_tiles) for m0 in range(0, tb, bm)
            for n0 in range(0, tb, bn)]


def solve_items(r_tiles: int, tb: int,
                with_diag: bool) -> list[tuple[int, int]]:
    """(row tile, first row) of each solve item: SOLVE_ROWS rows of every
    tile after the diagonal (every tile without it), tile by tile."""
    first = 1 if with_diag else 0
    return [(r, g) for r in range(first, r_tiles)
            for g in range(0, tb, SOLVE_ROWS)]


def smem_bytes(tb: int, dtype) -> int:
    """Shared memory a block: the largest phase's.  The wave's stages; the
    factor's diagonal block, its factor and two pivot vectors (or phase B's
    two NB x PAD slices); the solve's rows of X, a chunk of L's panel, the
    diagonal block and its diagonal and reciprocals; the epilogue's warp
    maxima."""
    item = torch.empty((), dtype=dtype).element_size()
    tm, tn, ks = WAVE[dtype]
    wave = WAVE_STAGES * 16 * (tm + tn) * (ks + 16 // item) * item
    factor = item * max(2 * NB * NB_LD + 2 * NB, 2 * NB * potrf.PAD)
    solve = item * (SOLVE_ROWS * tb + KC * NB_LD + NB * NB_LD + 2 * NB)
    return max(wave, factor, solve, item * (WARPS + 1))


def grid(tb: int, dtype) -> dict:
    """The cooperative grid the kernel launches at tile size ``tb`` on the
    current card: blocks a SM from the occupancy query at
    :func:`smem_bytes`, the SMs, and their product."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    fn = _build.function("fused_column", "fused_column_grid", _GRID_ARGS)
    _build.check(fn(tb, int(dtype == torch.float64), ctypes.byref(per_sm),
                    ctypes.byref(sms)), "fused_column_grid")
    return {"tb": tb, "dtype": str(dtype).replace("torch.", ""),
            "smem": smem_bytes(tb, dtype), "per_sm": per_sm.value,
            "sms": sms.value, "grid": per_sm.value * sms.value}


def _epilogue(x: torch.Tensor, cls_id: int, ladder) -> torch.Tensor:
    return x if cls_id < 0 else _round(x, ladder[cls_id])


def fused_column_step_ref(c_stack, hist, bhist, l_kk, cls_ids, *, ladder,
                          with_diag: bool) -> torch.Tensor:
    """Plain version: the wave in the accumulator type, one history step at
    a time as the reference's grid runs it; the diagonal factored as
    ``cholesky_nan(0.5 (c + c^T))``; rows solved against the
    epilogue-rounded factor; each row rounded through its class."""
    acc_dt = torch.float64 if c_stack.dtype == torch.float64 \
        else torch.float32
    acc = c_stack.to(acc_dt)
    h, b = hist.to(acc_dt), bhist.to(acc_dt)
    for kk in range(hist.shape[1]):
        acc = acc - h[:, kk] @ b[kk].T
    ids = [int(i) for i in cls_ids]
    out = []
    if with_diag:
        c = acc[0]
        l = _epilogue(cholesky_nan(0.5 * (c + c.T)), ids[0], ladder)
        out.append(l)
    else:
        l = l_kk.to(acc_dt)
    for r in range(len(out), acc.shape[0]):
        x = torch.linalg.solve_triangular(l.T, acc[r], upper=True,
                                          left=False)
        out.append(_epilogue(x, ids[r], ladder))
    return torch.stack(out).to(c_stack.dtype)


def fused_column_step(c_stack, hist, bhist, l_kk, cls_ids, *, ladder,
                      with_diag: bool) -> torch.Tensor:
    """One fused column step (the reference's signature minus ``interpret``).

    ``c_stack`` [R, tb, tb], ``hist`` [R, K, tb, tb] (K may be 0),
    ``bhist`` [K, tb, tb], ``l_kk`` [tb, tb] (ignored with ``with_diag``),
    all of one dtype; ``cls_ids`` R ints indexing ``ladder`` (-1: none).
    Returns [R, tb, tb] in c_stack's dtype."""
    global launches
    r_tiles, tb, tb2 = c_stack.shape
    k_hist = hist.shape[1] if hist.ndim == 4 else -1
    if (tb2 != tb or tuple(hist.shape) != (r_tiles, k_hist, tb, tb)
            or tuple(bhist.shape) != (k_hist, tb, tb)
            or tuple(l_kk.shape) != (tb, tb) or len(cls_ids) != r_tiles):
        raise ValueError(
            f"fused_column_step: shapes c{tuple(c_stack.shape)} "
            f"hist{tuple(hist.shape)} bhist{tuple(bhist.shape)} "
            f"l_kk{tuple(l_kk.shape)} cls_ids[{len(cls_ids)}]")
    if not _build.on_cuda("fused_column_step", c_stack, hist, bhist, l_kk):
        return fused_column_step_ref(c_stack, hist, bhist, l_kk, cls_ids,
                                     ladder=ladder, with_diag=with_diag)
    dt = c_stack.dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in (hist, bhist, l_kk)):
        raise TypeError(f"fused_column_step: no kernel for c {dt}, hist "
                        f"{hist.dtype}, bhist {bhist.dtype}, l_kk "
                        f"{l_kk.dtype}")
    if tb % 64 or tb > MAX_TB or r_tiles > MAX_ROWS:
        raise ValueError(f"fused_column_step: the kernel takes tb a multiple "
                         f"of 64 up to {MAX_TB} and up to {MAX_ROWS} rows, "
                         f"got tb={tb}, R={r_tiles}")
    if any(t.data_ptr() % 16 for t in (c_stack, hist, bhist, l_kk)):
        raise ValueError("fused_column_step: the kernel stages 16-byte "
                         "vectors; every operand must start on a 16-byte "
                         "boundary")
    _build.require_current("fused_column_step", c_stack)
    codes = (ctypes.c_int * r_tiles)(
        *[-1 if int(i) < 0 else CLASS_CODES[ladder[int(i)]]
          for i in cls_ids])
    out = torch.empty_like(c_stack)
    fn = _build.function("fused_column", "fused_column_step", _ARGS)
    err = fn(c_stack.data_ptr(), hist.data_ptr(), bhist.data_ptr(),
             l_kk.data_ptr(), out.data_ptr(), r_tiles, k_hist, tb,
             int(with_diag), ctypes.addressof(codes),
             int(dt == torch.float64), smem_bytes(tb, dt),
             len(wave_items(r_tiles, tb, dt)),
             len(solve_items(r_tiles, tb, with_diag)),
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_column_step")
    with _build.COUNT_LOCK:
        launches += 1
    return out
