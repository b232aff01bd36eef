"""Blocked triangular substitution against the factored tile store.

Port of ``repro/core/solve.py``.  The reference runs the sweeps with scipy
on the host; here they run in f64 on the solver's device with PyTorch ops,
streaming each tile of L from the host store once per sweep:

    forward:   L z = b      z_i = L_ii^-1 (b_i - sum_{j<i} L_ij z_j)
    backward:  L^T x = z    x_i = L_ii^-T (z_i - sum_{j>i} L_ji^T x_j)

``tiles`` is the ``[nt, nt, tb, tb]`` store (CPU, in the compute dtype);
``b`` is ``(n,)`` or ``k`` stacked columns ``(n, k)``; results come back as
f64 tensors on ``device``.  The logdet sums the diagonals on the host, as
the reference does.  No tile op here is a hand-written kernel: the
reference's solve reaches none either.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _blocks(tiles: torch.Tensor, b, device):
    """Validate shapes and view b as [nt, tb, k] f64 blocks on device."""
    nt, nt2, tb, tb2 = tiles.shape
    if nt != nt2 or tb != tb2:
        raise ValueError(f"malformed tile store {tuple(tiles.shape)}")
    n = nt * tb
    b = torch.as_tensor(b).to(device=device, dtype=torch.float64)
    if b.ndim not in (1, 2):
        raise ValueError(f"rhs must be (n,) or stacked (n, k), "
                         f"got shape {tuple(b.shape)}")
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if b.shape[1] == 0:
        raise ValueError("rhs has 0 columns; nothing to solve")
    if b.shape[0] != n:
        raise ValueError(f"rhs has {b.shape[0]} rows, factor is {n}x{n}")
    return b.reshape(nt, tb, b.shape[1]), squeeze


def _panels(k: int, rhs_block: Optional[int]):
    """Column-panel slices tiling ``k`` RHS columns (one slice if unset)."""
    if rhs_block is not None and rhs_block < 1:
        raise ValueError(f"rhs_block must be >= 1, got {rhs_block}")
    step = k if rhs_block is None else min(rhs_block, k)
    return [slice(c, min(c + step, k)) for c in range(0, k, step)]


def _tile(tiles: torch.Tensor, i: int, j: int, device) -> torch.Tensor:
    return tiles[i, j].to(device, non_blocking=True).to(torch.float64)


def solve_lower_tiles(tiles: torch.Tensor, b, device="cuda",
                      rhs_block: Optional[int] = None) -> torch.Tensor:
    """Solve ``L z = b`` with L in the [nt, nt, tb, tb] tile store."""
    blocks, squeeze = _blocks(tiles, b, device)
    nt = tiles.shape[0]
    z = torch.empty_like(blocks)
    for cols in _panels(blocks.shape[2], rhs_block):
        for i in range(nt):
            rhs = blocks[i, :, cols].clone()
            for j in range(i):
                rhs -= _tile(tiles, i, j, device) @ z[j, :, cols]
            z[i, :, cols] = torch.linalg.solve_triangular(
                _tile(tiles, i, i, device), rhs, upper=False)
    out = z.reshape(-1, blocks.shape[2])
    return out[:, 0] if squeeze else out


def solve_lower_t_tiles(tiles: torch.Tensor, b, device="cuda",
                        rhs_block: Optional[int] = None) -> torch.Tensor:
    """Solve ``L^T x = b`` with L in the [nt, nt, tb, tb] tile store."""
    blocks, squeeze = _blocks(tiles, b, device)
    nt = tiles.shape[0]
    x = torch.empty_like(blocks)
    for cols in _panels(blocks.shape[2], rhs_block):
        for i in range(nt - 1, -1, -1):
            rhs = blocks[i, :, cols].clone()
            for j in range(i + 1, nt):
                rhs -= _tile(tiles, j, i, device).T @ x[j, :, cols]
            x[i, :, cols] = torch.linalg.solve_triangular(
                _tile(tiles, i, i, device).T, rhs, upper=True)
    out = x.reshape(-1, blocks.shape[2])
    return out[:, 0] if squeeze else out


def cho_solve_tiles(tiles: torch.Tensor, b, device="cuda",
                    rhs_block: Optional[int] = None) -> torch.Tensor:
    """Solve ``A x = b`` given ``A = L L^T`` in the tile store."""
    return solve_lower_t_tiles(
        tiles, solve_lower_tiles(tiles, b, device, rhs_block), device,
        rhs_block)


def logdet_tiles(tiles: torch.Tensor) -> float:
    """``log|A| = 2 sum_i log L_ii`` from the diagonal tiles.

    The host store's diagonals are summed in NumPy, tile by tile, as the
    reference sums them, so a store equal to the reference's gives its
    logdet bitwise.  A non-positive diagonal entry means the factorization
    lost positive definiteness upstream; it raises instead of returning
    NaN or -inf.
    """
    nt = tiles.shape[0]
    acc = 0.0
    for i in range(nt):
        d = np.diag(tiles[i, i].cpu().to(torch.float64).numpy())
        if not np.all(d > 0.0):
            bad = np.flatnonzero(~(d > 0.0))
            raise ValueError(
                f"logdet: diagonal tile ({i}, {i}) has non-positive "
                f"diagonal entries at local indices {bad.tolist()} "
                f"(min value {d.min()!r}); the factor is not a valid "
                "Cholesky factor — the factorization lost positive "
                "definiteness (e.g. precision ladder too aggressive)")
        acc += float(np.sum(np.log(d)))
    return 2.0 * acc
