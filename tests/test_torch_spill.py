"""The port's disk tier against the reference's (``tests/test_spill.py``).

* the spill replays (``run_schedule_numpy``/``run_multidevice_numpy`` on a
  spill schedule, ``run_schedule_spill``, ``run_multidevice_spill``) are
  bitwise the reference's, for f64 and mixed-precision plans, one device
  and several;
* ``DiskTileStore`` keeps the reference's file layout: a store written by
  either package opens in the other;
* ``SpillTorchExecutor`` on CPU handles is bitwise the port's in-core
  executor (unfused and fused), within 1e-12 of the NumPy replay and of
  the reference's ``SpillJaxExecutor`` (1e-8 for MxP plans), with as many
  fused launches as the reference's, and executed FETCH/SPILL counters
  equal to the schedule's;
* ``stats()["transfers"]`` carries the reference's keys and values.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import cholesky as ref_chol
from repro.core import precision as ref_precision
from repro.core import schedule as ref_schedule
from repro.core import spill as ref_spill
from repro.core.tiling import from_tiles, random_spd, to_tiles
from repro.kernels import fused_column as jfused

import repro_torch
from repro_torch import DiskTileStore
from repro_torch.core import cholesky as chol
from repro_torch.core import precision, schedule
from repro_torch.core.spill import (ArrayTileStore, SpilledHostStore,
                                    host_residency_at)
from repro_torch.kernels import ops

_NT, _TB = 6, 16
_N = _NT * _TB
POLICIES = ("sync", "async", "v1", "v2", "v3", "v4")


def _tiles(n=_N, seed=3):
    return to_tiles(random_spd(n, seed=seed), _TB)


def _kms(n, rho=0.9):
    idx = np.arange(n)
    return rho ** np.abs(idx[:, None] - idx[None, :])


def _plans(ladder, a, tb=_TB):
    """The reference's plan of ``a`` and the port's copy (None: f64)."""
    nt = a.shape[0] // tb
    if ladder is None:
        return (ref_precision.uniform_plan(nt, "f64"),
                precision.uniform_plan(nt, "f64"))
    rp = ref_chol.plan_for_matrix(to_tiles(a, tb), 1e-6, ladder)
    assert sum(v > 0 for v in rp.histogram().values()) >= 3, rp.histogram()
    return rp, precision.PrecisionPlan(rp.classes.copy(), rp.ladder,
                                       rp.eps_target)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


# ---------------------------------------------------------------------------
# the spill replays, bitwise the reference's

@pytest.mark.parametrize("ladder", [None, "gpu", "gpu-scaled"],
                         ids=["f64", "gpu", "gpu-scaled"])
@pytest.mark.parametrize("policy", POLICIES)
def test_spill_replay_bitwise_equals_reference(policy, ladder):
    a = _kms(_N)
    rp, pp = _plans(ladder, a)
    kw = dict(block=(2, 2)) if policy == "v4" else {}
    rs = ref_schedule.build_schedule(_NT, _TB, policy, plan=rp,
                                     host_slots=4, **kw)
    ps = schedule.build_schedule(_NT, _TB, policy, plan=pp, host_slots=4,
                                 **kw)
    assert ps.digest() == rs.digest()
    tiles = to_tiles(a, _TB)
    got = chol.run_schedule_numpy(tiles, ps)
    _same(got, ref_chol.run_schedule_numpy(tiles, rs))
    # the post-pass is bookkeeping: the host-resident replay, bitwise
    _same(got, chol.run_schedule_numpy(
        tiles, schedule.build_schedule(_NT, _TB, policy, plan=pp, **kw)))


@pytest.mark.parametrize("ladder", [None, "gpu-scaled"],
                         ids=["f64", "gpu-scaled"])
@pytest.mark.parametrize("ndev,grid", [(2, None), (4, None), (4, (2, 2))],
                         ids=["ndev2", "ndev4", "grid22"])
def test_multidevice_spill_bitwise_equals_reference(ndev, grid, ladder):
    a = _kms(_N)
    rp, pp = _plans(ladder, a)
    rs = ref_schedule.build_multidevice_schedule(_NT, _TB, ndev, "v3",
                                                 plan=rp, grid=grid,
                                                 host_slots=5)
    ps = schedule.build_multidevice_schedule(_NT, _TB, ndev, "v3", plan=pp,
                                             grid=grid, host_slots=5)
    tiles = to_tiles(a, _TB)
    got = chol.run_multidevice_numpy(tiles, ps)
    _same(got, ref_chol.run_multidevice_numpy(tiles, rs))
    # and the functions themselves, with their per-device counters
    store, ref_store = ArrayTileStore(tiles), ref_spill.ArrayTileStore(tiles)
    hosts = chol.run_multidevice_spill(store, ps)
    ref_hosts = ref_chol.run_multidevice_spill(ref_store, rs)
    _same(store.to_tiles(), ref_store.to_tiles())
    for h, r in zip(hosts, ref_hosts):
        assert (h.fetch_ops, h.spill_ops, h.fetched_bytes, h.spilled_bytes,
                h.where) == (r.fetch_ops, r.spill_ops, r.fetched_bytes,
                             r.spilled_bytes, r.where)
    assert sum(h.fetched_bytes for h in hosts) == ps.fetch_bytes()


@pytest.mark.parametrize("host_slots", [2, 4, 9])
def test_run_schedule_spill_counters_and_residency(host_slots):
    tiles = _tiles()
    ps = schedule.build_schedule(_NT, _TB, "v3", host_slots=host_slots)
    rs = ref_schedule.build_schedule(_NT, _TB, "v3", host_slots=host_slots)
    host = chol.run_schedule_spill(ArrayTileStore(tiles), ps)
    ref_host = ref_chol.run_schedule_spill(ref_spill.ArrayTileStore(tiles),
                                           rs)
    assert (host.fetch_ops, host.spill_ops, host.fetched_bytes,
            host.spilled_bytes) == (ref_host.fetch_ops, ref_host.spill_ops,
                                    ref_host.fetched_bytes,
                                    ref_host.spilled_bytes)
    assert host.fetched_bytes == ps.fetch_bytes()
    assert host.spilled_bytes == ps.spill_bytes()
    for upto in (0, len(ps.ops) // 3, len(ps.ops) // 2, len(ps.ops)):
        res = host_residency_at(ps.ops, upto)
        assert res == ref_spill.host_residency_at(rs.ops, upto)
        assert len(set(res.values())) == len(res)
    assert host_residency_at(ps.ops, len(ps.ops)) == host.where
    with pytest.raises(ValueError, match="spill schedule"):
        chol.run_schedule_spill(ArrayTileStore(tiles),
                                schedule.build_schedule(_NT, _TB, "v3"))


# ---------------------------------------------------------------------------
# DiskTileStore

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_disk_store_opens_across_packages(writer, tmp_path):
    tiles = _tiles()
    path = str(tmp_path / "t.npy")
    make, reopen = ((DiskTileStore, ref_spill.DiskTileStore)
                    if writer == "port"
                    else (ref_spill.DiskTileStore, DiskTileStore))
    store = make.from_tiles(path, tiles)
    store.write_tile(1, 2, np.full((_TB, _TB), 5.0))
    store.flush()
    del store
    back = reopen.open(path)
    assert (back.nt, back.tb) == (_NT, _TB)
    want = tiles.copy()
    want[1, 2] = 5.0
    assert np.array_equal(back.to_tiles(), want)
    assert json.loads((tmp_path / "t.npy.meta.json").read_text()) == \
        {"nt": _NT, "tb": _TB}


def test_disk_store_roundtrip_and_errors(tmp_path):
    tiles = _tiles()
    store = DiskTileStore.from_matrix(str(tmp_path / "t.npy"),
                                      from_tiles(tiles), _TB)
    assert np.array_equal(store.to_tiles(), tiles)
    assert np.array_equal(store.to_array(), from_tiles(tiles))
    with pytest.raises(FileNotFoundError):
        DiskTileStore.open(str(tmp_path / "missing.npy"))
    np.save(str(tmp_path / "bad.npy"), np.zeros((4, 4)))
    with pytest.raises(ValueError, match="tile store"):
        DiskTileStore.open(str(tmp_path / "bad.npy"))
    with pytest.raises(ValueError, match="tile array"):
        DiskTileStore.from_tiles(str(tmp_path / "x.npy"), np.zeros((2, 3)))
    with pytest.raises(ValueError, match="host_slots"):
        SpilledHostStore(store, 0)
    host = SpilledHostStore(store, 2)
    with pytest.raises(KeyError, match=r"tile \(1, 1\) is not host-resident"):
        host[1, 1]


def test_over_budget_factorization_through_disk(tmp_path):
    """144 tiles through an 8-slab host tier on disk: the factor matches
    LAPACK and the reference's replay bitwise, and the executed disk
    traffic equals the scheduled volumes."""
    n, tb, host_slots = 192, 16, 8
    nt = n // tb
    a = random_spd(n, seed=11)
    sched = schedule.build_schedule(nt, tb, "v3", host_slots=host_slots)
    store = DiskTileStore.from_matrix(str(tmp_path / "a.npy"), a, tb)
    host = chol.run_schedule_spill(store, sched)
    got = DiskTileStore.open(str(tmp_path / "a.npy")).to_tiles()
    ref = np.linalg.cholesky(a)
    assert np.allclose(np.tril(from_tiles(got)), ref, rtol=0,
                       atol=1e-10 * np.abs(ref).max())
    _same(got, ref_chol.run_schedule_numpy(
        to_tiles(a, tb), ref_schedule.build_schedule(
            nt, tb, "v3", host_slots=host_slots)))
    assert host.fetched_bytes == sched.fetch_bytes() > 0
    assert host.spilled_bytes == sched.spill_bytes() > 0


# ---------------------------------------------------------------------------
# SpillTorchExecutor on CPU handles

def _incore(sched_plain, tiles, dtype, fuse, use_pallas):
    host = torch.from_numpy(tiles.copy()).to(dtype)
    chol.make_torch_executor(sched_plain, dtype, use_pallas=use_pallas,
                             device="cpu", fuse_columns=fuse)(host)
    return host.to(torch.float64).numpy()


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("ladder,dtype", [
    (None, torch.float64), ("gpu", torch.float64),
    ("gpu-scaled", torch.float64), ("gpu", torch.float32)],
    ids=["f64", "gpu", "gpu-scaled", "gpu-f32"])
@pytest.mark.parametrize("policy", ["v1", "v3", "v4"])
def test_spill_executor_matches_incore_and_reference(policy, ladder, dtype,
                                                     fuse):
    a = _kms(_N)
    rp, pp = _plans(ladder, a)
    kw = dict(block=(2, 2)) if policy == "v4" else {}
    ps = schedule.build_schedule(_NT, _TB, policy, plan=pp, host_slots=4,
                                 **kw)
    plain = schedule.build_schedule(_NT, _TB, policy, plan=pp, **kw)
    tiles = to_tiles(a, _TB)
    ex = chol.SpillTorchExecutor(ps, dtype, use_pallas=fuse, device="cpu",
                                 fuse_columns=fuse)
    got = ex(tiles)
    lower = np.tril(np.ones((_NT, _NT), bool))
    incore = _incore(plain, tiles, dtype, fuse, fuse)
    _same(got[lower], incore[lower])
    # the upper tiles are never fetched: they keep the input
    _same(got[~lower], tiles[~lower])
    assert ex.last_io_stats == {
        "fetch_ops": ps.count(schedule.OpKind.FETCH),
        "spill_ops": ps.count(schedule.OpKind.SPILL),
        "fetched_bytes": ps.fetch_bytes(), "spilled_bytes": ps.spill_bytes()}
    tol = 1e-12 if ladder is None else 1e-8
    if dtype is torch.float32:
        tol = 1e-4
    replay = chol.run_schedule_numpy(tiles, ps)
    assert np.abs(got - replay).max() < tol
    if policy == "v3":
        # the reference's executor jits every segment: one policy here
        rs = ref_schedule.build_schedule(_NT, _TB, policy, plan=rp,
                                         host_slots=4, **kw)
        jdt = jnp.float64 if dtype is torch.float64 else jnp.float32
        ref = ref_chol.SpillJaxExecutor(rs, jdt, fuse_columns=fuse)(tiles)
        assert np.abs(got - ref).max() < tol
    # a second run on the same executor is bitwise the first
    _same(ex(tiles), got)


@pytest.mark.parametrize("policy,host_slots", [
    ("sync", 4), ("v1", 3), ("v2", 8), ("v3", 3), ("v3", 8)])
def test_spill_executor_fused_launches_equal_reference(policy, host_slots):
    """The fused groups never span a FETCH/SPILL, as the reference's
    segments end there: as many fused launches and per-op calls as the
    reference's ``SpillJaxExecutor(fuse_columns=True)``."""
    tiles = _tiles()
    ps = schedule.build_schedule(_NT, _TB, policy, host_slots=host_slots)
    rs = ref_schedule.build_schedule(_NT, _TB, policy, host_slots=host_slots)
    jfused.reset_launch_counts()
    want_out = ref_chol.SpillJaxExecutor(rs, fuse_columns=True)(tiles)
    want = jfused.launch_counts()
    ops.reset_counts()
    got = chol.SpillTorchExecutor(ps, use_pallas=True, device="cpu",
                                  fuse_columns=True)(tiles)
    calls = ops.call_counts()
    assert calls.pop("fused_column_step") == want["fused_column"] > 0
    assert sum(calls.values()) == want["tile_op"]
    assert np.abs(got - want_out).max() < 1e-12


def test_spill_executor_on_a_disk_store(tmp_path):
    """``run_store`` factors a DiskTileStore in place; a second run on the
    same input is bitwise the first; skipping one scheduled SPILL (the
    chip run's control) changes the factor."""
    a = random_spd(_N, seed=4)
    ps = schedule.build_schedule(_NT, _TB, "v3", host_slots=4)
    ex = chol.SpillTorchExecutor(ps, device="cpu")
    outs = []
    for r in range(2):
        store = DiskTileStore.from_matrix(str(tmp_path / f"{r}.npy"), a, _TB)
        io = ex.run_store(store)
        outs.append(DiskTileStore.open(str(tmp_path / f"{r}.npy")).to_tiles())
        assert io["h2d_ops"] == ps.count(schedule.OpKind.LOAD)
        assert io["d2h_ops"] == ps.count(schedule.OpKind.STORE)
        assert ex.last_io_stats["fetched_bytes"] == ps.fetch_bytes()
        assert ex.last_io_stats["spilled_bytes"] == ps.spill_bytes()
    _same(outs[0], outs[1])
    assert np.abs(np.tril(from_tiles(outs[0]))
                  - np.linalg.cholesky(a)).max() < 1e-10
    # the control: one SPILL of a finished L tile dropped
    bad = chol.SpillTorchExecutor(ps, device="cpu")
    spills = [k for k, seg in enumerate(bad._segments)
              if seg[0] == "io" and seg[1].kind is schedule.OpKind.SPILL]
    del bad._segments[spills[len(spills) // 2]]
    store = DiskTileStore.from_matrix(str(tmp_path / "bad.npy"), a, _TB)
    bad.run_store(store)
    assert not np.array_equal(np.tril(from_tiles(store.to_tiles())),
                              np.tril(from_tiles(outs[0])))


def test_spill_executor_traced_equals_untraced():
    tiles = _tiles()
    ps = schedule.build_schedule(_NT, _TB, "v3", host_slots=4)
    ex = chol.SpillTorchExecutor(ps, device="cpu")
    rec = repro_torch.TraceRecorder()
    got = ex(tiles, trace=rec)
    assert len(rec) == len(ps.ops)
    assert [s.kind for s in rec.spans] == [op.kind.value for op in ps.ops]
    traced_io = dict(ex.last_io_stats)
    _same(got, ex(tiles))
    assert traced_io == ex.last_io_stats


def test_executors_refuse_spill_schedules():
    ps = schedule.build_schedule(_NT, _TB, "v3", host_slots=4)
    with pytest.raises(ValueError, match="spill"):
        chol.make_torch_executor(ps, device="cpu")
    with pytest.raises(ValueError, match="SpillTorchExecutor"):
        chol.run_traced_torch(ps, torch.zeros(_NT, _NT, _TB, _TB),
                              repro_torch.TraceRecorder(), device="cpu")
    with pytest.raises(ValueError, match="host_slots > 0"):
        chol.SpillTorchExecutor(schedule.build_schedule(_NT, _TB, "v3"),
                                device="cpu")


# ---------------------------------------------------------------------------
# the planner API

@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_plan_factor_through_spill(backend):
    a = random_spd(_N, seed=5)
    solver = repro_torch.plan(_N, repro_torch.CholeskyConfig(
        tb=_TB, policy="v3", host_slots=4, backend=backend)).compile(
        device="cpu")
    l = solver.factor(a)
    assert np.allclose(np.tril(l), np.linalg.cholesky(a), atol=1e-10)
    v = solver.volume()
    assert v["fetch_bytes"] > 0 and v["spill_bytes"] > 0
    assert solver.simulate(repro_torch.HW["gh200"]).fetch_bytes == \
        v["fetch_bytes"]
    b = np.arange(_N, dtype=np.float64)
    assert np.abs(a @ solver.solve(b) - b).max() < 1e-9
    assert abs(solver.logdet() - np.linalg.slogdet(a)[1]) < 1e-9


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_stats_transfers_have_the_reference_keys(backend):
    """The reference's transfer keys and values (its numpy backend, or its
    jax spill executor for the torch backend), beside the port's executed
    H2D/D2H copies."""
    a = random_spd(_N, seed=5)
    ref_backend = "numpy" if backend == "numpy" else "jax"
    ref = repro.plan(_N, repro.CholeskyConfig(
        tb=_TB, host_slots=4, backend=ref_backend)).compile()
    ref.factor(a)
    solver = repro_torch.plan(_N, repro_torch.CholeskyConfig(
        tb=_TB, host_slots=4, backend=backend)).compile(device="cpu")
    assert "fetch_ops" not in solver.stats["transfers"]   # before a factor
    solver.factor(a)
    t, want = solver.stats["transfers"], ref.stats["transfers"]
    assert {k: t[k] for k in want} == want
    extra = set(t) - set(want)
    assert all(k.startswith("executed_") for k in extra)
    assert (backend == "torch") == bool(extra)
    if backend == "torch":
        assert t["executed_h2d_ops"] == t["loads"]


@pytest.mark.parametrize("backend", ["auto", "torch", "numpy"])
def test_multidevice_spill_needs_the_numpy_backend(backend):
    kw = dict(tb=_TB, ndev=2, host_slots=5, backend=backend)
    if backend != "numpy":
        with pytest.raises(ValueError, match="backend='numpy'"):
            repro_torch.CholeskyConfig(**kw)
        return
    a = random_spd(_N, seed=6)
    solver = repro_torch.plan(_N, repro_torch.CholeskyConfig(**kw)).compile()
    l = solver.factor(a)
    ref = repro.plan(_N, repro.CholeskyConfig(**kw)).compile().factor(a)
    _same(l, ref)


def test_config_validation():
    with pytest.raises(ValueError, match="host_slots must be >= 0"):
        repro_torch.CholeskyConfig(tb=_TB, host_slots=-1)
    with pytest.raises(ValueError, match="lookahead"):
        repro_torch.CholeskyConfig(tb=_TB, ndev=2, host_slots=4,
                                   lookahead=1, backend="numpy")
    cfg = repro_torch.CholeskyConfig(tb=_TB, host_slots=4)
    assert cfg.resolved_backend() == "torch"
    assert dataclasses.replace(cfg, backend="numpy").host_slots == 4
