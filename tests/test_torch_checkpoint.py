"""The port's checkpoint manager and restartable factorization, after
``tests/test_checkpoint.py``, and against the reference's.

The manager keeps the reference's files (``host_<p>.npz`` under the
reference's leaf keys, ``meta.json``, ``extra.json``), so a checkpoint
saved by either package restores in the other.  A
:class:`repro_torch.RestartableFactorization` killed at a column, mid
column or twice resumes to a factor bitwise the uninterrupted run's and
the reference's.
"""
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import RestartableFactorization as RefRestartable
from repro.core import cholesky as ref_chol
from repro.core import schedule as ref_schedule
from repro.core import spill as ref_spill
from repro.core.tiling import random_spd, to_tiles

from repro_torch.checkpoint import (CheckpointManager,
                                    RestartableFactorization, TileJournal)
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.core.cholesky import run_schedule_numpy
from repro_torch.core.schedule import build_schedule
from repro_torch.core.spill import DiskTileStore


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "slots": rng.standard_normal((3, 4, 4)),            # float64
        "scales": rng.standard_normal(5).astype(np.float32),
        "counts": np.arange(7, dtype=np.int32),
        "nested": {"bias": rng.standard_normal((2, 2)),
                   "pair": [np.float64(rng.standard_normal()),
                            (np.arange(3, dtype=np.int64), None)]},
    }


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [] if t is None else [t]


def _zeros_like_tree(t):
    if isinstance(t, dict):
        return {k: _zeros_like_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_zeros_like_tree(v) for v in t)
    return None if t is None else np.zeros_like(t)


def _assert_tree_equal(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# Manager: round-trip, re-save, retention, multi-process, errors

def test_roundtrip_preserves_values_and_dtypes(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree(1)
    m.save(4, tree, extra={"column": 4, "digest": "abc"})
    got, extra = m.restore(_zeros_like_tree(tree))
    _assert_tree_equal(got, tree)
    assert isinstance(got["nested"]["pair"], list)
    assert isinstance(got["nested"]["pair"][1], tuple)
    assert got["nested"]["pair"][1][1] is None
    assert extra == {"column": 4, "digest": "abc"}
    assert m.latest_step() == 4


def test_tensor_leaves_round_trip(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=1)
    tree = {"slots": torch.arange(12, dtype=torch.float32).view(3, 4),
            "step": torch.tensor(7)}
    m.save(0, tree)
    got, _ = m.restore({"slots": torch.zeros(3, 4), "step": torch.tensor(0)})
    assert torch.equal(got["slots"], tree["slots"])
    assert got["step"].dtype == torch.int64 and int(got["step"]) == 7


def test_leaf_keys_are_the_references(tmp_path):
    """The same tree saved by both packages: the same file names, npz keys
    and meta.json."""
    tree = _tree(2)
    CheckpointManager(str(tmp_path / "port")).save(1, tree, extra={"a": 1})
    RefManager(str(tmp_path / "ref")).save(1, tree, extra={"a": 1})
    for side in ("port", "ref"):
        d = tmp_path / side / "step_00000001"
        assert {p.name for p in d.iterdir()} == \
            {"host_0.npz", "meta.json", "extra.json"}
    port = tmp_path / "port" / "step_00000001"
    ref = tmp_path / "ref" / "step_00000001"
    assert json.loads((port / "meta.json").read_text()) == \
        json.loads((ref / "meta.json").read_text())
    with np.load(port / "host_0.npz") as a, np.load(ref / "host_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(writer, tmp_path):
    slots = np.random.default_rng(3).standard_normal((5, 8, 8))
    save_m, load_m = ((CheckpointManager, RefManager) if writer == "port"
                      else (RefManager, CheckpointManager))
    save_m(str(tmp_path), keep=2).save(3, {"slots": slots},
                                       extra={"column": 3})
    got, extra = load_m(str(tmp_path), keep=2).restore(
        {"slots": np.zeros_like(slots)})
    assert np.array_equal(got["slots"], slots)
    assert extra == {"column": 3}


def test_resave_of_existing_step_overwrites(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(2, _tree(1))
    m.save(2, _tree(9))                     # resume path re-saves step 2
    got, _ = m.restore(_zeros_like_tree(_tree()), step=2)
    _assert_tree_equal(got, _tree(9))


@pytest.mark.parametrize("keep", [1, 3])
def test_retention_keeps_newest(tmp_path, keep):
    m = CheckpointManager(str(tmp_path), keep=keep)
    for step in range(5):
        m.save(step, _tree(step))
    kept = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                  if n.startswith("step_") and not n.endswith(".tmp"))
    assert kept == list(range(5 - keep, 5))
    assert m.latest_step() == 4


def test_keep_zero_rejected(tmp_path):
    with pytest.raises(ValueError, match="keep must be >= 1"):
        CheckpointManager(str(tmp_path), keep=0)


def test_latest_step_ignores_tmp_leftovers(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(1, _tree())
    os.makedirs(tmp_path / "step_00000007.tmp")   # crashed mid-save
    assert m.latest_step() == 1


def test_restore_missing_step_raises(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(1, _tree())
    with pytest.raises(FileNotFoundError, match="no checkpoint for step 5"):
        m.restore(_zeros_like_tree(_tree()), step=5)


def test_restore_empty_directory_returns_none(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    assert m.restore(_zeros_like_tree(_tree())) == (None, None)
    assert m.latest_step() is None


def test_multiprocess_save_protocol(tmp_path, monkeypatch):
    """Each process writes its own host_<p>.npz; process 0 alone writes the
    shared metadata and commits the rename."""
    m = CheckpointManager(str(tmp_path), keep=3)
    t0, t1 = _tree(0), _tree(1)

    monkeypatch.setattr(manager_mod, "_process_index", lambda: 1)
    m.save(3, t1, extra={"x": 1})           # non-zero proc saves FIRST
    tmp = tmp_path / "step_00000003.tmp"
    assert (tmp / "host_1.npz").exists()
    assert not (tmp / "meta.json").exists()             # proc 0's job
    assert m.latest_step() is None                      # not committed

    monkeypatch.setattr(manager_mod, "_process_index", lambda: 0)
    m.save(3, t0, extra={"x": 1})           # proc 0 commits atomically
    final = tmp_path / "step_00000003"
    assert not tmp.exists() and final.is_dir()
    assert {p.name for p in final.iterdir()} == \
        {"host_0.npz", "host_1.npz", "meta.json", "extra.json"}

    got0, _ = m.restore(_zeros_like_tree(t0), step=3)
    _assert_tree_equal(got0, t0)
    monkeypatch.setattr(manager_mod, "_process_index", lambda: 1)
    got1, _ = m.restore(_zeros_like_tree(t1), step=3)
    _assert_tree_equal(got1, t1)            # each proc reads its own file


def test_process_index_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert manager_mod._process_index() == 0


def test_save_on_signal_requests_save(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    old = signal.getsignal(signal.SIGTERM)
    try:
        m.save_on_signal()
        assert not m.should_save_now
        signal.raise_signal(signal.SIGTERM)
        assert m.should_save_now
        m.save(0, _tree())                  # save clears the request
        assert not m.should_save_now
    finally:
        signal.signal(signal.SIGTERM, old)


# ---------------------------------------------------------------------------
# Tile journal

def test_journal_rollback_restores_first_write(tmp_path):
    store = DiskTileStore.create(str(tmp_path / "t.npy"), nt=2, tb=4)
    store.write_tile(0, 0, np.full((4, 4), 7.0))
    j = TileJournal(str(tmp_path / "j"))
    j.begin_epoch(0)
    j.journal(0, 0, store.read_tile(0, 0))
    store.write_tile(0, 0, np.full((4, 4), 1.0))
    j.journal(0, 0, store.read_tile(0, 0))  # second journal: ignored
    store.write_tile(0, 0, np.full((4, 4), 2.0))
    assert j.rollback(store, 0) == 1
    assert np.array_equal(store.read_tile(0, 0), np.full((4, 4), 7.0))


def test_journal_begin_epoch_drops_older(tmp_path):
    j = TileJournal(str(tmp_path / "j"))
    j.begin_epoch(0)
    j.journal(0, 1, np.zeros((4, 4)))
    j.begin_epoch(1)
    store = DiskTileStore.create(str(tmp_path / "t.npy"), nt=2, tb=4)
    assert j.rollback(store, 0) == 0        # epoch 0 entries dropped
    assert j.rollback(store, 1) == 0        # new epoch starts empty


# ---------------------------------------------------------------------------
# Restartable factorization: kill-and-resume is bit-identical

_N, _TB, _HSLOTS = 96, 16, 4


def _setup(tmp_path, host_slots=_HSLOTS, policy="v3"):
    a = random_spd(_N, seed=7)
    sched = build_schedule(_N // _TB, _TB, policy, host_slots=host_slots)
    store = DiskTileStore.from_matrix(str(tmp_path / "store.npy"), a, _TB)
    ref = run_schedule_numpy(to_tiles(a, _TB), sched)   # uninterrupted
    return a, sched, store, ref


def _resume(tmp_path, sched):
    """Fresh objects, as a new process after a kill would build them."""
    store = DiskTileStore.open(str(tmp_path / "store.npy"))
    manager = CheckpointManager(str(tmp_path / "ckpt"), keep=3)
    return RestartableFactorization(sched, store, manager)


def _fresh(tmp_path, sched, store):
    return RestartableFactorization(
        sched, store, CheckpointManager(str(tmp_path / "ckpt"), keep=3))


def test_uninterrupted_run_matches_plain_replay(tmp_path):
    _, sched, store, ref = _setup(tmp_path)
    rf = _fresh(tmp_path, sched, store)
    assert rf.run() is True
    assert np.array_equal(rf.result_tiles(), ref)       # bit-identical
    assert rf.run() is True                             # idempotent


def test_kill_at_column_boundary_resumes_bit_identical(tmp_path):
    _, sched, store, ref = _setup(tmp_path)
    rf = _fresh(tmp_path, sched, store)
    assert rf.run(stop_after_column=2) is False         # killed
    del rf, store
    rf2 = _resume(tmp_path, sched)
    assert rf2.run() is True
    assert np.array_equal(rf2.result_tiles(), ref)


def test_mid_column_kill_exercises_journal_rollback(tmp_path):
    _, sched, store, ref = _setup(tmp_path)
    rf = _fresh(tmp_path, sched, store)
    stop = int(0.9 * len(sched.ops))        # deep mid-stream, mid-column
    assert rf.run(stop_after_ops=stop) is False
    del rf, store
    rf2 = _resume(tmp_path, sched)
    assert rf2.run() is True
    assert np.array_equal(rf2.result_tiles(), ref)


def test_double_kill_resumes_bit_identical(tmp_path):
    _, sched, store, ref = _setup(tmp_path)
    rf = _fresh(tmp_path, sched, store)
    assert rf.run(stop_after_ops=len(sched.ops) // 2) is False
    del rf, store
    rf2 = _resume(tmp_path, sched)
    assert rf2.run(stop_after_ops=20) is False          # killed again
    del rf2
    rf3 = _resume(tmp_path, sched)
    assert rf3.run() is True
    assert np.array_equal(rf3.result_tiles(), ref)


@pytest.mark.parametrize("kill", ["none", "column", "mid", "double"])
def test_equals_reference_restartable(kill, tmp_path):
    """The port's resumed factor is bitwise the reference's
    ``RestartableFactorization`` on the same schedule, killed the same
    way (a schedule digest both packages compute alike)."""
    a = random_spd(_N, seed=12)
    nt = _N // _TB
    sched = build_schedule(nt, _TB, "v2", host_slots=5)
    rsched = ref_schedule.build_schedule(nt, _TB, "v2", host_slots=5)
    assert sched.digest() == rsched.digest()
    results = []
    for side, Store, Manager, Restartable, s in (
            ("port", DiskTileStore, CheckpointManager,
             RestartableFactorization, sched),
            ("ref", ref_spill.DiskTileStore, RefManager, RefRestartable,
             rsched)):
        root = tmp_path / side
        root.mkdir()
        Store.from_matrix(str(root / "store.npy"), a, _TB)

        def fresh():
            return Restartable(s, Store.open(str(root / "store.npy")),
                               Manager(str(root / "ckpt"), keep=2))

        if kill == "column":
            assert fresh().run(stop_after_column=1) is False
        elif kill == "mid":
            assert fresh().run(stop_after_ops=len(s.ops) * 2 // 3) is False
        elif kill == "double":
            assert fresh().run(stop_after_ops=len(s.ops) // 3) is False
            assert fresh().run(stop_after_ops=15) is False
        rf = fresh()
        assert rf.run() is True
        results.append(rf.result_tiles())
    assert np.array_equal(results[0], results[1])
    assert np.array_equal(results[0], ref_chol.run_schedule_numpy(
        to_tiles(a, _TB), rsched))


def test_resume_under_different_schedule_refused(tmp_path):
    _, sched, store, _ = _setup(tmp_path, host_slots=4)
    rf = _fresh(tmp_path, sched, store)
    assert rf.run(stop_after_column=1) is False
    other = build_schedule(_N // _TB, _TB, "v3", host_slots=5)
    store2 = DiskTileStore.open(str(tmp_path / "store.npy"))
    rf2 = RestartableFactorization(
        other, store2, CheckpointManager(str(tmp_path / "ckpt"), keep=3))
    with pytest.raises(ValueError, match="digest"):
        rf2.run()


def test_restartable_requires_spill_schedule(tmp_path):
    sched = build_schedule(4, 8, "v3")      # host_slots=0
    store = DiskTileStore.create(str(tmp_path / "t.npy"), nt=4, tb=8)
    with pytest.raises(ValueError, match="host_slots"):
        RestartableFactorization(
            sched, store, CheckpointManager(str(tmp_path / "c"), keep=1))
    spilled = build_schedule(4, 8, "v3", host_slots=2)
    with pytest.raises(ValueError, match="checkpoint_every"):
        RestartableFactorization(
            spilled, store, CheckpointManager(str(tmp_path / "c"), keep=1),
            checkpoint_every=0)


def test_jax_process_index_is_not_consulted(tmp_path, monkeypatch):
    """The port's manager takes its process index from torch.distributed,
    never from the JAX runtime."""
    monkeypatch.setattr(jax, "process_index", lambda: 5)
    m = CheckpointManager(str(tmp_path), keep=1)
    m.save(0, {"slots": np.ones(3)})
    assert (tmp_path / "step_00000000" / "host_0.npz").exists()
