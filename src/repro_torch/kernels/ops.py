"""Tile-op dispatch over the hand-written kernels (port of repro.kernels.ops).

Dispatch rule, as in the reference: f64 tiles take the stock path (here
PyTorch's own ``cholesky``/``solve_triangular``/``@``, as the reference
leaves them to XLA); every other tile goes to its kernel's wrapper, which
launches the CUDA kernel on a CUDA tensor and runs the plain version on a
CPU tensor.  The fused column step takes its kernel in f64 too, as the
reference's does.

Two counters: :func:`call_counts` counts every tile-op dispatch here,
whatever the device (the reference's ``tile_op`` count for the four tile ops
and its ``fused_column`` count for ``fused_column_step``);
:func:`launch_counts` counts CUDA kernel launches only, one per launch, kept
by each kernel's wrapper, for the tile kernels and the flash attention
kernel of the LM path (``models.attention`` calls its wrapper directly).
Both are exact under threads: every count moves under
``_build.COUNT_LOCK``.
"""
from __future__ import annotations

import torch

from . import _build
from . import flash_attention as _flash
from . import fused_column as _fused
from . import mxp_gemm as _gemm
from . import potrf as _potrf
from . import syrk as _syrk
from . import trsm as _trsm
from .ref import cholesky_nan

TILE_OPS = {"mxp_gemm_update": _gemm, "syrk_update": _syrk, "trsm": _trsm,
            "potrf": _potrf, "fused_column_step": _fused}
KERNELS = {**TILE_OPS, "flash_attention": _flash}

#: the stock f64 path: the same functions the reference's XLA path runs
STOCK = {
    "potrf": lambda c: cholesky_nan(0.5 * (c + c.T)),
    "trsm": lambda l, c: torch.linalg.solve_triangular(l.T, c, upper=True,
                                                       left=False),
    "syrk": lambda c, a: c - a @ a.T,
    "gemm": lambda c, a, b: c - a @ b.T,
}

_CALLS = {name: 0 for name in TILE_OPS}


def launch_counts() -> dict:
    """CUDA kernel launches per kernel since the last reset."""
    with _build.COUNT_LOCK:
        return {name: mod.launches for name, mod in KERNELS.items()}


def call_counts() -> dict:
    """Tile ops dispatched per kernel since the last reset (any device)."""
    with _build.COUNT_LOCK:
        return dict(_CALLS)


def flash_variant_counts() -> dict:
    """Flash attention launches per kernel (``tensor_core``, ``ffma``)
    since the last reset; they sum to ``launch_counts()["flash_attention"]``."""
    with _build.COUNT_LOCK:
        return dict(_flash.variant_launches)


def reset_counts() -> None:
    with _build.COUNT_LOCK:
        for mod in KERNELS.values():
            mod.launches = 0
        for name in _flash.variant_launches:
            _flash.variant_launches[name] = 0
        for name in _CALLS:
            _CALLS[name] = 0


def _count(name: str) -> None:
    with _build.COUNT_LOCK:
        _CALLS[name] += 1


def _is_f64(*xs) -> bool:
    return any(x.dtype == torch.float64 for x in xs)


def potrf(a):
    _count("potrf")
    if _is_f64(a):
        return STOCK["potrf"](a)
    return _potrf.potrf(a)


def trsm(l, c):
    _count("trsm")
    if _is_f64(l, c):
        return STOCK["trsm"](l, c)
    return _trsm.trsm(l, c)


def syrk_update(c, a):
    _count("syrk_update")
    if _is_f64(c, a):
        return STOCK["syrk"](c, a)
    return _syrk.syrk_update(c, a)


def gemm_update(c, a, b):
    _count("mxp_gemm_update")
    if _is_f64(c, a, b):
        return STOCK["gemm"](c, a, b)
    return _gemm.mxp_gemm_update(c, a, b)


def fused_column_step(c_stack, hist, bhist, l_kk, cls_ids, *, ladder,
                      with_diag):
    _count("fused_column_step")
    return _fused.fused_column_step(c_stack, hist, bhist, l_kk, cls_ids,
                                    ladder=ladder, with_diag=with_diag)
