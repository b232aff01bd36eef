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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import _round, cholesky_nan

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
         + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_DTYPES = (torch.float64, torch.float32)
#: class codes of csrc/fused_column.cu (enum Cls); -1 leaves a row unrounded
CLASS_CODES = {"f64": 0, "f32": 1, "f16": 2, "bf16": 3, "f8e4m3": 4,
               "f8e4m3s": 5}
MAX_ROWS = 256      # the class codes ride in the kernel's parameters
MAX_TB = 1024       # eight rows of the solve in shared memory (64 KiB f64)

launches = 0    # kernel launches since the last ops.reset_counts()


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
    codes = (ctypes.c_int * r_tiles)(
        *[-1 if int(i) < 0 else CLASS_CODES[ladder[int(i)]]
          for i in cls_ids])
    out = torch.empty_like(c_stack)
    fn = _build.function("fused_column", "fused_column_step", _ARGS)
    with torch.cuda.device(c_stack.device):
        err = fn(c_stack.data_ptr(), hist.data_ptr(), bhist.data_ptr(),
                 l_kk.data_ptr(), out.data_ptr(), r_tiles, k_hist, tb,
                 int(with_diag), ctypes.addressof(codes),
                 int(dt == torch.float64),
                 torch.cuda.current_stream(c_stack.device).cuda_stream)
    _build.check(err, "fused_column_step")
    launches += 1
    return out
