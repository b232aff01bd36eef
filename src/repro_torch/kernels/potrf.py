"""Single-tile Cholesky factorization (port of repro.kernels.potrf).

Every POTRF op of the schedule.  On a CUDA tensor :func:`potrf` launches
``csrc/potrf.cu``: a blocked right-looking factor in f32, one cooperative
launch of a persistent grid, with the diagonal blocks factored in
registers and the trailing updates register-tiled over the SMs.  On CPU
tensors it runs the plain version, :func:`repro_torch.kernels.ref.potrf_ref`.

The launch geometry is computed here, as plain functions the CPU tests
check, and the kernel refuses any other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import potrf_ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)
MAX_N = 6144    # the first kernel's limit (2 n f32 in 48 KiB), kept
NB = 64         # diagonal block edge (csrc/tri_block.cuh)
THREADS = 256   # threads a block (csrc/potrf.cu, POTRF_THREADS)
WARPS = THREADS // 32
TT = 32         # trailing tile edge (csrc/potrf.cu)
PAD = TT + 4    # row stride of phase B's panel slices (csrc/potrf.cu)

launches = 0    # kernel launches since the last ops.reset_counts()


def smem_bytes() -> int:
    """Shared memory a block: one buffer for phase A's diagonal block and
    its factor (NB rows of NB + 1 floats each) with the pivots and their
    reciprocals, or phase B's two NB x PAD panel slices."""
    return 4 * max(2 * NB * (NB + 1) + 2 * NB, 2 * NB * PAD)


def steps(n: int) -> list[tuple[int, int]]:
    """(first column, width) of each diagonal block."""
    return [(kb, min(NB, n - kb)) for kb in range(0, n, NB)]


def panel_rows(n: int, kb: int, width: int, block: int,
               grid: int) -> list[int]:
    """Rows below the diagonal block at ``kb`` that ``block`` of ``grid``
    solves: warp w of the block takes rows kb + width + block * WARPS + w,
    then every grid * WARPS rows."""
    first = kb + width + block * WARPS
    return sorted(i for w in range(WARPS)
                  for i in range(first + w, n, grid * WARPS))


def trailing_tiles(n: int, kb: int) -> list[tuple[int, int]]:
    """(first row, first column) of the lower TT x TT tiles of the trailing
    matrix after the step at ``kb``, in the kernel's order, row by row:
    tile t goes to block t % grid."""
    p0 = kb + min(NB, n - kb)
    starts = range(p0, n, TT)
    return [(i, j) for i in starts for j in starts if j <= i]


def blocks_needed(n: int) -> int:
    """Blocks of the cooperative grid: enough for the widest phase, the
    panel's rows (WARPS a block) or the trailing TT x TT tiles (one a
    block).  The kernel launches at most what the card holds at once and
    walks each phase grid-stride."""
    rows = n - min(NB, n)               # the first panel is the tallest
    mt = -(-rows // TT)                 # the first trailing matrix the widest
    return max(1, -(-rows // WARPS), mt * (mt + 1) // 2)


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
    _build.require_current("potrf", a)
    out = torch.empty_like(a)
    work = out if a.dtype == torch.float32 else torch.empty(
        (n, n), dtype=torch.float32, device=a.device)
    fn = _build.function("potrf", "potrf", _ARGS)
    err = fn(a.data_ptr(), work.data_ptr(), out.data_ptr(), n,
             _build.DTYPE_CODES[a.dtype], blocks_needed(n), smem_bytes(),
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "potrf")
    with _build.COUNT_LOCK:
        launches += 1
    return out
