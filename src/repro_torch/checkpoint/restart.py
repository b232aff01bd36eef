"""Restartable disk-tier factorization over the checkpoint manager.

Port of ``repro/checkpoint/restart.py``, over the port's own interpreter
(``core/cholesky.py``) and disk tier (``core/spill.py``).  A disk-scale
factorization runs for hours; this module makes the NumPy replay of a
spill schedule resumable from the latest checkpoint with a
**bit-identical** final factor.  Three pieces compose:

* the static spill schedule (``host_slots > 0``): every host-tier
  residency decision is in the op stream, so the bounded host cache is
  *reconstructible* at any op index from the schedule alone
  (:func:`repro_torch.core.spill.host_residency_at`) — a checkpoint never
  saves the host slabs, it flushes them to disk and re-fetches on
  resume;
* the :class:`~repro_torch.checkpoint.manager.CheckpointManager`:
  at column boundaries the runner saves the device slot buffer plus
  ``{digest, op_index, column}`` — the digest keys the checkpoint to
  the exact schedule, so resuming under a different schedule fails loudly
  instead of silently corrupting the factor;
* a :class:`TileJournal` undo log: the replay *keeps mutating the disk
  store between checkpoints* (SPILLs of partial accumulators), and tile
  updates are not idempotent — resuming from checkpoint ``C`` after a
  mid-column kill must first roll the store back to its state at ``C``.
  Every first overwrite of a tile since the last checkpoint journals the
  old bytes; on resume the journal of the restored checkpoint's epoch is
  rolled back before replay continues.

Crash-window audit (kill at any point):

* during post-checkpoint replay — restore ``C``, roll back epoch-``C``
  journal entries, continue from ``C``'s op index;
* during the next checkpoint's flush — the flush writes are journaled
  under epoch ``C``, so the same rollback undoes the partial flush;
* between the checkpoint's atomic rename and its first journaled write —
  the new epoch's journal is empty; rollback is a no-op.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

from ..core.cholesky import _device_nslots, _np_interpret_op
from ..core.schedule import MultiDeviceSchedule, Schedule
from ..core.spill import SpilledHostStore, host_residency_at

from .manager import CheckpointManager


class TileJournal:
    """Per-epoch undo log of disk-tile overwrites.

    ``journal(i, j, old)`` records a tile's pre-overwrite bytes the first
    time it is written in the current epoch (one ``.npy`` per tile, under
    ``<dir>/epoch_<e>/``); :meth:`rollback` restores every journaled tile
    of an epoch to the store.  An epoch corresponds to the interval
    after one checkpoint and up to (and including) the flush writes of
    the next — exactly the writes a resume from that checkpoint must
    undo.
    """

    def __init__(self, directory: str, epoch: int = -1):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.epoch = epoch
        os.makedirs(self._epoch_dir(epoch), exist_ok=True)
        self._seen: set = set()

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch_{epoch + 1:08d}")

    def _tile_path(self, epoch: int, i: int, j: int) -> str:
        return os.path.join(self._epoch_dir(epoch), f"t_{i}_{j}.npy")

    def journal(self, i: int, j: int, old: np.ndarray):
        if (i, j) in self._seen:
            return
        path = self._tile_path(self.epoch, i, j)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, np.asarray(old, dtype=np.float64))
        os.replace(tmp, path)
        self._seen.add((i, j))

    def begin_epoch(self, epoch: int):
        """Start journaling under ``epoch`` (called right after the
        checkpoint for step ``epoch`` has been atomically committed);
        older epochs' entries are no longer needed and are dropped."""
        for name in os.listdir(self.dir):
            if name.startswith("epoch_") and name != \
                    os.path.basename(self._epoch_dir(epoch)):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
        self.epoch = epoch
        os.makedirs(self._epoch_dir(epoch), exist_ok=True)
        self._seen = set()

    def rollback(self, store, epoch: int) -> int:
        """Restore every tile journaled under ``epoch``; returns count."""
        d = self._epoch_dir(epoch)
        count = 0
        if not os.path.isdir(d):
            return 0
        for name in os.listdir(d):
            if not name.endswith(".npy") or name.endswith(".tmp"):
                continue
            _, i, j = name[:-4].split("_")
            store.write_tile(int(i), int(j), np.load(os.path.join(d, name)))
            count += 1
        store.flush()
        return count


class JournaledTileStore:
    """Tile-store wrapper that journals the first overwrite per epoch."""

    def __init__(self, store, journal: TileJournal):
        self.store = store
        self.journal = journal
        self.nt = store.nt
        self.tb = store.tb

    def read_tile(self, i: int, j: int) -> np.ndarray:
        return self.store.read_tile(i, j)

    def write_tile(self, i: int, j: int, value: np.ndarray):
        if (i, j) not in self.journal._seen:
            self.journal.journal(i, j, self.store.read_tile(i, j))
        self.store.write_tile(i, j, value)

    def flush(self):
        self.store.flush()


class RestartableFactorization:
    """Drive a spill schedule over a disk store with resumable progress.

    ``run()`` replays the op stream with the NumPy interpreter (the
    bit-deterministic executor) against the disk-backed store, saving a
    checkpoint every ``checkpoint_every`` completed columns (and at a
    pending ``manager.should_save_now`` signal request).  A fresh
    ``run()`` on the same (manager dir, store, schedule) after a kill —
    at *any* point, mid-column included — resumes from the latest
    checkpoint and produces a factor bit-identical to an uninterrupted
    run.  A checkpoint from a different schedule digest raises.

    The per-checkpoint state is tiny: the device slot buffer (the only
    state not reconstructible from schedule + disk) plus
    ``{digest, op_index, column}``; host-tier residency is rebuilt
    statically and slab contents re-fetched from the (flushed,
    rolled-back) disk store.
    """

    def __init__(self, sched: Schedule | MultiDeviceSchedule,
                 store, manager: CheckpointManager,
                 checkpoint_every: int = 1):
        if isinstance(sched, MultiDeviceSchedule):
            sched = sched.to_single()
        if sched.host_slots < 1:
            raise ValueError(
                "RestartableFactorization needs a spill schedule "
                "(host_slots > 0): only then is the host tier "
                "reconstructible from the schedule + disk store")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        self.sched = sched
        self.digest = sched.digest()
        self.manager = manager
        self.checkpoint_every = checkpoint_every
        self.journal = TileJournal(os.path.join(manager.dir, "journal"))
        self.store = JournaledTileStore(store, self.journal)
        self._nslots = max(_device_nslots(sched.ops), 1)

    # ---- checkpoint plumbing ----
    def _save(self, host: SpilledHostStore, slots: np.ndarray,
              op_index: int, column: int):
        # flush journals under the *previous* epoch (a resume from the
        # previous checkpoint must be able to undo a partial flush),
        # then commit atomically, then open the new epoch
        host.flush_residents()
        self.manager.save(column, {"slots": slots},
                          extra={"digest": self.digest,
                                 "op_index": op_index,
                                 "column": column,
                                 "complete": op_index >= len(self.sched.ops)})
        self.journal.begin_epoch(column)

    def _restore(self):
        """Return ``(start_index, slots, host)`` — fresh or resumed."""
        step = self.manager.latest_step()
        if step is None:
            self.journal.rollback(self.store.store, -1)
            self.journal.begin_epoch(-1)
            return 0, np.zeros((self._nslots, self.sched.tb, self.sched.tb),
                               dtype=np.float64), self._fresh_host()
        tree, extra = self.manager.restore(
            {"slots": np.zeros((self._nslots, self.sched.tb, self.sched.tb),
                               dtype=np.float64)}, step=step)
        if extra is None or extra.get("digest") != self.digest:
            raise ValueError(
                f"checkpoint step {step} in {self.manager.dir!r} was saved "
                f"for schedule digest {extra.get('digest') if extra else None!r}, "
                f"but this factorization runs digest {self.digest!r}; "
                "refusing to resume mid-stream under a different schedule")
        # undo disk writes made after this checkpoint, then rebuild the
        # host tier: residency from the schedule prefix, contents from disk
        self.journal.rollback(self.store.store, extra["column"])
        self.journal.epoch = extra["column"]
        self.journal._seen = set()
        host = self._fresh_host()
        for tile, slab in host_residency_at(self.sched.ops,
                                            extra["op_index"]).items():
            host.tile_of[slab] = tile
            host.where[tile] = slab
        host.refetch_residents()
        return int(extra["op_index"]), tree["slots"], host

    def _fresh_host(self) -> SpilledHostStore:
        return SpilledHostStore(self.store, self.sched.host_slots)

    # ---- driving loop ----
    def run(self, stop_after_column: Optional[int] = None,
            stop_after_ops: Optional[int] = None) -> bool:
        """Replay until done (True) or until a simulated kill point
        (False).  Both stops abort *without* saving — a hard kill:
        ``stop_after_column=k`` aborts once column ``k`` has completed,
        ``stop_after_ops=m`` aborts after interpreting ``m`` more ops
        (mid-column kills exercise the journal rollback).
        """
        ops = self.sched.ops
        lad = self.sched.plan.ladder
        idx, slots, host = self._restore()
        if idx >= len(ops):
            return True
        column = ops[idx].k
        done = 0
        for i in range(idx, len(ops)):
            op = ops[i]
            if op.k > column:
                # column boundary: ops[:i] completed columns <= `column`
                if stop_after_column is not None \
                        and column >= stop_after_column:
                    return False
                if (column % self.checkpoint_every
                        == self.checkpoint_every - 1) \
                        or self.manager.should_save_now:
                    self._save(host, slots, i, column)
                column = op.k
            if stop_after_ops is not None and done >= stop_after_ops:
                return False
            _np_interpret_op(host, slots, op, lad)
            done += 1
        host.flush_residents()   # scheduled SPILLs already flushed dirty
        #                          slabs; this settles clean residents too
        #                          (no-op values) and syncs the mmap
        self._save(host, slots, len(ops), self.sched.nt - 1)
        return True

    def result_tiles(self) -> np.ndarray:
        return self.store.store.to_tiles()
