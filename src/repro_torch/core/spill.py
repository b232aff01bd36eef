"""Third memory tier: a disk-backed tile store behind the host-store API.

Port of ``repro/core/spill.py`` (NumPy only, the same file layout: a store
written by either package opens in the other).  The paper's OOC design bounds *device* residency and streams tiles over
the host<->device link; this module applies the same static-schedule
treatment one tier down.  The full ``[Nt, Nt, tb, tb]`` fp64 tile store
lives on disk (:class:`DiskTileStore`, one memory-mapped ``.npy`` file),
and the host holds only ``host_slots`` tile slabs
(:class:`SpilledHostStore`).  Which slab holds which tile at every point
of the stream is decided ahead of time by
:func:`repro_torch.core.schedule.with_host_cache`, which interleaves explicit
``FETCH`` (disk -> slab) and ``SPILL`` (slab -> disk) ops; executors
just replay them, exactly as they replay LOAD/STORE on the device edge.

Because residency is static, it is also *reconstructible*:
:func:`host_residency_at` replays only the FETCH records of a stream
prefix and returns the slab map at any op index — the piece that makes
mid-stream restart (:mod:`repro_torch.checkpoint.restart`) cheap: a checkpoint
never persists the host slabs, it flushes them to disk and re-fetches on
resume.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .schedule import Op, OpKind


class DiskTileStore:
    """``[Nt, Nt, tb, tb]`` fp64 tile store memory-mapped from one file.

    The on-disk layout is exactly the in-memory host-store layout the
    executors already speak (``core/tiling.py``), so a tile read/write
    is one contiguous ``tb*tb*8``-byte strided slice of the map.  A
    ``meta.json`` sidecar records ``(nt, tb)`` for :meth:`open`.
    """

    def __init__(self, path: str, mmap: np.memmap):
        self.path = path
        self._map = mmap
        self.nt = int(mmap.shape[0])
        self.tb = int(mmap.shape[2])

    # ---- construction ----
    @classmethod
    def create(cls, path: str, nt: int, tb: int) -> "DiskTileStore":
        """Allocate a zero-filled store at ``path`` (a ``.npy`` file)."""
        mm = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float64, shape=(nt, nt, tb, tb))
        store = cls(path, mm)
        store._write_meta()
        return store

    @classmethod
    def from_tiles(cls, path: str, tiles: np.ndarray) -> "DiskTileStore":
        """Create a store initialized from an in-memory tile array."""
        tiles = np.asarray(tiles, dtype=np.float64)
        if tiles.ndim != 4 or tiles.shape[0] != tiles.shape[1] \
                or tiles.shape[2] != tiles.shape[3]:
            raise ValueError(
                f"expected a [Nt, Nt, tb, tb] tile array, got {tiles.shape}")
        store = cls.create(path, tiles.shape[0], tiles.shape[2])
        store._map[...] = tiles
        store.flush()
        return store

    @classmethod
    def from_matrix(cls, path: str, a: np.ndarray, tb: int) -> "DiskTileStore":
        """Create a store from a dense ``[n, n]`` matrix tiled at ``tb``."""
        from .tiling import to_tiles
        return cls.from_tiles(path, to_tiles(np.asarray(a), tb))

    @classmethod
    def open(cls, path: str, mode: str = "r+") -> "DiskTileStore":
        """Reopen an existing store (shape/dtype from the .npy header)."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"no tile store at {path!r}")
        mm = np.lib.format.open_memmap(path, mode=mode)
        if mm.ndim != 4 or mm.dtype != np.float64:
            raise ValueError(
                f"{path!r} is not a [Nt, Nt, tb, tb] fp64 tile store "
                f"(shape {mm.shape}, dtype {mm.dtype})")
        return cls(path, mm)

    def _write_meta(self):
        with open(self.path + ".meta.json", "w") as f:
            json.dump({"nt": self.nt, "tb": self.tb}, f)

    # ---- tile I/O ----
    def read_tile(self, i: int, j: int) -> np.ndarray:
        return np.array(self._map[i, j])

    def write_tile(self, i: int, j: int, value: np.ndarray):
        self._map[i, j] = value

    def flush(self):
        self._map.flush()

    # ---- whole-store views (small problems / tests) ----
    def to_tiles(self) -> np.ndarray:
        return np.array(self._map)

    def to_array(self) -> np.ndarray:
        from .tiling import from_tiles
        return from_tiles(self.to_tiles())


class ArrayTileStore:
    """In-memory tile store with the :class:`DiskTileStore` interface.

    The backing tier for equivalence tests and the
    ``run_schedule_numpy`` convenience path: same protocol, no file.
    """

    def __init__(self, tiles: np.ndarray):
        tiles = np.asarray(tiles, dtype=np.float64)
        if tiles.ndim != 4 or tiles.shape[0] != tiles.shape[1] \
                or tiles.shape[2] != tiles.shape[3]:
            raise ValueError(
                f"expected a [Nt, Nt, tb, tb] tile array, got {tiles.shape}")
        self._tiles = tiles.copy()
        self.nt = int(tiles.shape[0])
        self.tb = int(tiles.shape[2])

    def read_tile(self, i: int, j: int) -> np.ndarray:
        return np.array(self._tiles[i, j])

    def write_tile(self, i: int, j: int, value: np.ndarray):
        self._tiles[i, j] = value

    def flush(self):
        pass

    def to_tiles(self) -> np.ndarray:
        return np.array(self._tiles)

    def to_array(self) -> np.ndarray:
        from .tiling import from_tiles
        return from_tiles(self.to_tiles())


class SpilledHostStore:
    """The bounded host tier: ``host_slots`` fp64 slabs over a disk store.

    Duck-types the two accesses the op interpreters make against the
    host store — ``host[i, j]`` read and ``host[i, j] = value`` — plus
    the two tier ops, :meth:`fetch` and :meth:`spill`.  Residency is
    never decided here: the schedule's FETCH ops *tell* the store which
    slab holds which tile, and an access to a tile the schedule never
    made resident is a scheduling bug surfaced as ``KeyError``.
    """

    def __init__(self, disk: DiskTileStore, host_slots: int):
        if host_slots < 1:
            raise ValueError(f"host_slots must be >= 1, got {host_slots}")
        self.disk = disk
        self.host_slots = host_slots
        self.slabs = np.zeros((host_slots, disk.tb, disk.tb),
                              dtype=np.float64)
        self.where: dict[tuple[int, int], int] = {}   # tile -> slab
        self.tile_of: list[Optional[tuple[int, int]]] = [None] * host_slots
        self.fetched_bytes = 0
        self.spilled_bytes = 0
        self.fetch_ops = 0       # every FETCH, binding (0-byte) included
        self.spill_ops = 0

    def _slab(self, i: int, j: int) -> int:
        try:
            return self.where[(i, j)]
        except KeyError:
            raise KeyError(
                f"tile ({i}, {j}) is not host-resident: the schedule "
                "accessed it without a preceding FETCH (spill post-pass "
                "bug, or ops replayed out of order)") from None

    def fetch(self, op: Op):
        s = op.slot_c
        old = self.tile_of[s]
        if old is not None:
            del self.where[old]
        self.fetch_ops += 1
        if op.bytes:
            self.slabs[s] = self.disk.read_tile(op.i, op.j)
            self.fetched_bytes += op.bytes
        # bytes == 0: binding fetch — the very next op overwrites the slab
        self.tile_of[s] = (op.i, op.j)
        self.where[(op.i, op.j)] = s

    def spill(self, op: Op):
        if self.tile_of[op.slot_c] != (op.i, op.j):
            raise RuntimeError(
                f"SPILL of tile ({op.i}, {op.j}) from slab {op.slot_c}, "
                f"but the slab holds {self.tile_of[op.slot_c]}")
        self.disk.write_tile(op.i, op.j, self.slabs[op.slot_c])
        self.spill_ops += 1
        self.spilled_bytes += op.bytes

    def apply(self, op: Op) -> bool:
        """Apply ``op`` if it is a host-tier op; return whether it was."""
        if op.kind is OpKind.FETCH:
            self.fetch(op)
            return True
        if op.kind is OpKind.SPILL:
            self.spill(op)
            return True
        return False

    def flush_residents(self):
        """Write every resident slab back to disk (checkpoint flush).

        Clean slabs rewrite the bytes they were fetched with — harmless —
        so no runtime dirty tracking is needed; after this the disk store
        alone determines every resident slab's contents.
        """
        for s, tile in enumerate(self.tile_of):
            if tile is not None:
                self.disk.write_tile(tile[0], tile[1], self.slabs[s])
        self.disk.flush()

    def refetch_residents(self):
        """Reload every resident slab from disk (restart path, after the
        residency map has been rebuilt by :func:`host_residency_at`)."""
        for s, tile in enumerate(self.tile_of):
            if tile is not None:
                self.slabs[s] = self.disk.read_tile(tile[0], tile[1])

    # the two accesses `_np_interpret_op` makes against a host store
    def __getitem__(self, ij: tuple[int, int]) -> np.ndarray:
        return self.slabs[self._slab(*ij)]

    def __setitem__(self, ij: tuple[int, int], value: np.ndarray):
        self.slabs[self._slab(*ij)] = value


def host_residency_at(ops: list[Op], upto: int) -> dict[tuple[int, int], int]:
    """Slab map ``{tile: slab}`` after replaying ``ops[:upto]``.

    Residency changes only at FETCH ops (a SPILL writes disk but leaves
    the slab bound), so replaying the FETCH records of the prefix is the
    whole reconstruction — this is what lets a restart rebuild the host
    tier from the schedule alone, with slab *contents* re-read from disk.
    """
    tile_of: dict[int, tuple[int, int]] = {}
    for op in ops[:upto]:
        if op.kind is OpKind.FETCH:
            tile_of[op.slot_c] = (op.i, op.j)
    return {tile: s for s, tile in tile_of.items()}
