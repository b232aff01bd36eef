# A copy of repro/core/tiling.py, kept line for line so that the port builds
# the same plans and op streams (and digests) without importing repro.
"""Tile layout utilities for the tile-based Cholesky factorization.

The matrix A (n x n, SPD) is partitioned into Nt x Nt square tiles of size
tb.  Only the lower triangle is stored/computed (the paper copies only the
triangular part back to the host — Fig. 8 discussion).

Tile indexing follows the paper: A[i, j] with i >= j for the lower triangle.
The *host store* is a dense [Nt, Nt, tb, tb] array (upper tiles unused) so
that loads/stores are single dynamic slices — on TPU this buffer can live in
``pinned_host`` memory (out-of-core), see core/cholesky.py.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def grid_owner(i: int, j: int, p: int, q: int) -> int:
    """Device id of tile ``(i, j)`` on a ``p x q`` block-cyclic grid —
    the single ownership rule shared by the schedule builder, both
    replay orders, and the multi-device executor::

        grid_owner(i, j, p, q) == (i % p) * q + (j % q)

    Devices are numbered row-major over the grid (device ``d`` sits at
    grid position ``(d // q, d % q)``); ``q = 1`` degenerates to the 1D
    tile-row rule ``i % p``.
    """
    return (i % p) * q + (j % q)


@dataclasses.dataclass(frozen=True)
class TileLayout:
    n: int          # matrix dimension
    tb: int         # tile size
    ordering: str = "left_looking"

    def __post_init__(self):
        if self.n % self.tb != 0:
            raise ValueError(f"n={self.n} must be a multiple of tb={self.tb}")

    @property
    def nt(self) -> int:
        return self.n // self.tb

    def lower_tiles(self) -> Iterator[tuple[int, int]]:
        for j in range(self.nt):
            for i in range(j, self.nt):
                yield (i, j)

    def num_lower_tiles(self) -> int:
        return self.nt * (self.nt + 1) // 2

    def owner(self, i: int, num_workers: int) -> int:
        """1D block-cyclic owner of tile-row i (paper Fig. 1b / Fig. 5a)."""
        return i % num_workers

    def panel_slots(self, lookahead: int = 0) -> int:
        """Device slots the multi-device panel region occupies above the
        cache: one ``nt``-slot bank per in-flight panel column.  The
        pipelined emitter rotates ``lookahead + 1`` banks (column ``kc``
        lands in bank ``kc % (lookahead + 1)``), so ``lookahead=0`` is
        the classic single ``nt``-slot region.  Used by the tuner's
        memory feasibility math (``reserve = panel_slots(L)``)."""
        return (lookahead + 1) * self.nt

    def owner_grid(self, i: int, j: int, grid: tuple) -> int:
        """2D block-cyclic owner of tile (i, j) on a ``p x q`` device grid.

        Devices are numbered row-major over the grid: device ``d`` sits at
        grid position ``(d // q, d % q)`` and owns every tile whose row is
        congruent to its grid row (mod p) and whose column is congruent to
        its grid column (mod q)::

            owner_grid(i, j, (p, q)) == (i % p) * q + (j % q)

        ``grid=(P, 1)`` degenerates to the 1D tile-row ownership of
        :meth:`owner` (each device owns whole rows), which is the paper's
        multi-GPU layout; a genuinely 2D grid cuts the per-device panel
        broadcast volume from O(P) to O(p + q) receivers per tile (see
        docs/multidevice.md).
        """
        p, q = grid
        return grid_owner(i, j, p, q)


def to_tiles(a: np.ndarray, tb: int) -> np.ndarray:
    """[n, n] -> [Nt, Nt, tb, tb] host tile store."""
    n = a.shape[0]
    nt = n // tb
    return (
        a.reshape(nt, tb, nt, tb).transpose(0, 2, 1, 3).copy()
    )


def from_tiles(t: np.ndarray) -> np.ndarray:
    """[Nt, Nt, tb, tb] -> [n, n]."""
    nt, _, tb, _ = t.shape
    return t.transpose(0, 2, 1, 3).reshape(nt * tb, nt * tb)


def random_spd(n: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    """Random well-conditioned SPD matrix (unit diagonal dominance bump)."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n)).astype(dtype) / np.sqrt(n)
    a = b @ b.T + np.eye(n, dtype=dtype) * 2.0
    return 0.5 * (a + a.T)
