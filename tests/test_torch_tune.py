"""The port's autotuner (``repro_torch.tune``) against the reference's.

Searches, resolutions and plans are held with ``==``: the same candidate
table (each config through ``config_to_dict``, each row with its simulated
makespan and volumes) on every hardware preset, at several n, for one, two
and four devices and with pinned dimensions; the same resolved config and
schedule digest from ``plan(n, auto)``; the same mixed-precision plans from
a sample matrix.  Where the port's kernel route has tile limits the Pallas
kernels lack (``use_pallas``: TRSM and POTRF; ``fuse_columns``: the fused
step), the table is the reference's without those tile sizes.  Db files
read across packages both ways; a trace refits the same model in both; the
CPU calibration has the reference's keys.  Everything runs with
``device="cpu"``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
from repro import tune as rt
from repro.core import api as ref_api
from repro.core.analytics import HW as REF_HW

import repro_torch
from repro_torch import obs, tune
from repro_torch.core import api
from repro_torch.core.analytics import GB, HW
from repro_torch.kernels import fused_column, potrf, trsm

PRESETS = tuple(REF_HW)
PER_OP_MAX = min(trsm.MAX_N, potrf.MAX_N)


@pytest.fixture(autouse=True)
def _fresh_tuning_state():
    for mod in (tune, rt):
        mod.clear_tuning_cache()
        mod.set_default_hardware(None)
    api.clear_plan_cache()
    ref_api.clear_plan_cache()
    yield
    for mod in (tune, rt):
        mod.clear_tuning_cache()
        mod.set_default_hardware(None)
    api.clear_plan_cache()
    ref_api.clear_plan_cache()


def _rows(result, to_dict):
    """A ranked table as plain values: each candidate's config and row."""
    return [(to_dict(c.config), c.row(), c.makespan)
            for c in result.candidates]


def _ref_cfg(**kw):
    return repro.CholeskyConfig(**kw)


def _port_cfg(**kw):
    if "compute_dtype" in kw:
        kw["compute_dtype"] = {np.float32: torch.float32,
                               np.float64: torch.float64}[kw["compute_dtype"]]
    return repro_torch.CholeskyConfig(**kw)


def _ooc_n(hw) -> int:
    """Smallest power of two whose f64 matrix is ~2x device memory."""
    n = 1 << 12
    while 8 * n * n < 2 * hw.mem_bytes:
        n <<= 1
    return n


# ---------------------------------------------------------------------------
# the candidate table, == the reference's

SEARCHES = (
    [(p, 2048, {}) for p in PRESETS]
    + [("gh200", 6144, {}), ("a100-pcie", _ooc_n(REF_HW["a100-pcie"]), {})]
    + [("gh200", 2048, dict(tb=256)), ("tpu-v5e", 2048, dict(policy="v3")),
       ("h100-pcie", 2048, dict(cache_slots=24)),
       ("gh200", 2048, dict(policy="v4", block=(2, 3))),
       ("a100-pcie", 2048, dict(ndev=2, lookahead=1, cache_slots=24)),
       ("h100-pcie", 2048, dict(ndev=4, grid=(2, 2), lookahead=1,
                                cache_slots=24)),
       ("gh200", 2048, dict(ndev=4, grid=(4, 1), cache_slots=24))])


@pytest.mark.parametrize(
    "preset,n,kw", SEARCHES,
    ids=[f"{p}-n{n}-" + ("-".join(f"{k}{v}" for k, v in kw.items())
                         or "open") for p, n, kw in SEARCHES])
def test_search_table_equals_reference(preset, n, kw):
    kw = {"tb": 0, "policy": "auto", **kw}
    want = rt.search(n, REF_HW[preset], _ref_cfg(**kw))
    got = tune.search(n, HW[preset], _port_cfg(**kw))
    assert len(got.candidates) > 1
    assert _rows(got, tune.config_to_dict) == _rows(want, rt.config_to_dict)
    for cand in got.candidates:
        assert tune.is_feasible(n, cand.config, HW[preset])


@pytest.mark.parametrize("n", [16384, 32768])
@pytest.mark.parametrize("route", ["use_pallas", "fuse_columns", "both"])
def test_route_limits_cut_the_reference_table(route, n):
    """A config routed to the hand-written kernels is offered only the tile
    sizes they run; the rest of the table is the reference's, in order."""
    kw = dict(tb=0, policy="auto", compute_dtype=np.float32,
              use_pallas=route != "fuse_columns",
              fuse_columns=route != "use_pallas")
    hw = "h100-pcie"
    want = rt.search(n, REF_HW[hw], _ref_cfg(**kw))
    got = tune.search(n, HW[hw], _port_cfg(**kw))

    def runs(tb):
        ok = tb <= PER_OP_MAX if kw["use_pallas"] else True
        if kw["fuse_columns"]:
            ok = ok and tb % fused_column.NB == 0 and tb <= fused_column.MAX_TB
        return ok

    kept = [r for r in _rows(want, rt.config_to_dict) if runs(r[0]["tb"])]
    assert kept and len(kept) < len(want.candidates)
    assert _rows(got, tune.config_to_dict) == kept
    assert all(runs(c.config.tb) for c in got.candidates)
    assert tune.feasible_tbs(n, HW[hw], config=got.config) == [
        tb for tb in rt.feasible_tbs(n, REF_HW[hw]) if runs(tb)]


def test_route_limits_off_the_kernel_route_keep_every_tile():
    """``use_pallas=False``, ``backend='numpy'`` and ``use_pallas`` in f64
    (whose tiles take the stock ops) keep the reference's tile sizes and
    table (the per-op limits bind only where the kernels run); on the
    kernel route in f32, a size whose every tile is too large has no
    feasible tile."""
    n = 262144          # gh200: every feasible tile is past 4096
    hw = HW["gh200"]
    for kw in (dict(), dict(backend="numpy"), dict(use_pallas=True),
               dict(use_pallas=True, compute_dtype=np.float64)):
        cfg = _port_cfg(tb=0, policy="v3", **kw)
        assert tune.feasible_tbs(n, hw, config=cfg) == \
            rt.feasible_tbs(n, REF_HW["gh200"])
        got = tune.search(n, hw, cfg)
        assert got.config.tb > PER_OP_MAX
        if kw.get("use_pallas"):
            want = rt.search(n, REF_HW["gh200"],
                             _ref_cfg(tb=0, policy="v3", **kw))
            assert _rows(got, tune.config_to_dict) == \
                _rows(want, rt.config_to_dict)
    with pytest.raises(ValueError, match="no feasible tile size"):
        tune.search(n, hw, repro_torch.CholeskyConfig(
            tb=0, policy="v3", use_pallas=True, compute_dtype=torch.float32))


def test_pinned_tile_past_the_route_raises():
    """A tile past TRSM's and POTRF's edge is refused where they run (f32)
    and scored as the reference scores it where they do not (f64)."""
    cfg = repro_torch.CholeskyConfig(tb=8192, policy="auto", use_pallas=True,
                                     compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="tile limits"):
        tune.search(32768, HW["h100-pcie"], cfg)
    assert not tune.is_feasible(32768, dataclasses.replace(
        cfg, policy="v3", cache_slots=4), HW["h100-pcie"])
    f64 = dataclasses.replace(cfg, compute_dtype=None)
    assert tune.is_feasible(32768, dataclasses.replace(
        f64, policy="v3", cache_slots=4), HW["h100-pcie"])
    got = tune.search(32768, HW["h100-pcie"], f64)
    want = rt.search(32768, REF_HW["h100-pcie"],
                     _ref_cfg(tb=8192, policy="auto", use_pallas=True))
    assert _rows(got, tune.config_to_dict) == _rows(want, rt.config_to_dict)


@pytest.mark.parametrize("n", [16384, 32768])
@pytest.mark.parametrize("fuse", [False, True])
def test_route_limits_f64_kernel_route(fuse, n):
    """``use_pallas`` in f64: the per-op limits do not bind (f64 tiles take
    the stock ops), so the table is the reference's, cut only by the fused
    step's limit under ``fuse_columns``; the same config in f32 is cut by
    TRSM's and POTRF's edge too."""
    hw = "h100-pcie"
    kw = dict(tb=0, policy="auto", use_pallas=True, fuse_columns=fuse)
    want = _rows(rt.search(n, REF_HW[hw], _ref_cfg(**kw)), rt.config_to_dict)
    got = tune.search(n, HW[hw], _port_cfg(**kw))

    def fused_runs(tb):
        return not fuse or (tb % fused_column.NB == 0
                            and tb <= fused_column.MAX_TB)

    kept = [r for r in want if fused_runs(r[0]["tb"])]
    assert _rows(got, tune.config_to_dict) == kept
    if not fuse:
        assert kept == want and max(r[0]["tb"] for r in want) > PER_OP_MAX
    f32 = tune.search(n, HW[hw], _port_cfg(**kw, compute_dtype=np.float32))
    assert {c.config.tb for c in f32.candidates} == {
        r[0]["tb"] for r in kept if r[0]["tb"] <= PER_OP_MAX}


def test_db_hit_past_the_route_limits_is_not_returned(tmp_path):
    """The db key names no route: a winner with a tile the route cannot run
    (a file the reference wrote, here) is searched again."""
    n, hw = 32768, "h100-pcie"
    path = str(tmp_path / "db.json")
    ref_db = rt.TuningDB(path)
    big = _ref_cfg(tb=8192, policy="v2", cache_slots=10, use_pallas=True,
                   compute_dtype=np.float32)
    ref_db.put(f"preset:{hw}", n, 1, None, big, 1.0)
    db = tune.TuningDB(path)
    auto = repro_torch.CholeskyConfig(tb=0, policy="auto", use_pallas=True,
                                      compute_dtype=torch.float32, hw=hw)
    hit = db.get(f"preset:{hw}", n, 1, None)
    assert hit.tb == 8192 and hit.use_pallas     # read across packages
    got = tune.resolve_config(n, auto, db=db)
    assert got.tb <= PER_OP_MAX and got.use_pallas
    assert db.get(f"preset:{hw}", n, 1, None) == got
    # a hit the route runs is served as it is
    assert tune.resolve_config(n, auto, db=db) == got
    # and one of another route (fused) is not returned for this one
    fused = dataclasses.replace(auto, fuse_columns=True)
    got_f = tune.resolve_config(n, fused, db=db)
    assert got_f.fuse_columns and got_f.tb <= fused_column.MAX_TB
    # in f64 the route runs tb 8192 (stock ops), so such a hit is served
    big64 = _ref_cfg(tb=8192, policy="v2", cache_slots=10, use_pallas=True)
    ref_db.put(f"preset:{hw}", n, 1, None, big64, 1.0)
    auto64 = dataclasses.replace(auto, compute_dtype=None)
    assert tune.resolve_config(n, auto64, db=tune.TuningDB(path)).tb == 8192


# ---------------------------------------------------------------------------
# resolution, default config, the MxP dimension

RESOLVE = [dict(tb=0, policy="auto"), dict(tb=0, policy="v1"),
           dict(tb=128, policy="auto"), dict(tb=0, policy="auto", hw="gh200"),
           dict(tb=0, policy="auto", hw="a100-pcie", cache_slots=10),
           dict(tb=0, policy="auto", ndev=2, grid=(2, 1), lookahead=0,
                cache_slots=24)]


@pytest.mark.parametrize("kw", RESOLVE, ids=range(len(RESOLVE)))
def test_resolve_config_equals_reference(kw):
    n = 1024
    want = rt.resolve_config(n, _ref_cfg(**kw))
    got = tune.resolve_config(n, _port_cfg(**kw))
    assert tune.config_to_dict(got) == rt.config_to_dict(want)
    assert not got.needs_tuning


@pytest.mark.parametrize("n,ndev", [(1000, 1), (4096, 1), (4096, 2),
                                    (6144, 4), (97, 1)])
def test_default_config_equals_reference(n, ndev):
    assert tune.config_to_dict(tune.default_config(n, ndev)) == \
        rt.config_to_dict(rt.default_config(n, ndev))


def _mxp_sample(n, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n)) / np.sqrt(n)
    return b @ b.T * 1e-7 + np.diag(1.0 + np.abs(rng.standard_normal(n)))


@pytest.mark.parametrize("tb", [128, 0])
def test_mxp_dimension_equals_reference(tb):
    """eps_target + sample: the per-tb Higham-Mary plans, and so the table,
    equal the reference's; a tensor sample (tile norms on its device) gives
    the same plans."""
    n = 1024
    a = _mxp_sample(n)
    want = rt.tune(n, _ref_cfg(tb=tb, policy="auto"), hw=REF_HW["gh200"],
                   sample=a, eps_target=1e-5, use_db=False)
    got = tune.tune(n, repro_torch.CholeskyConfig(tb=tb, policy="auto"),
                    hw=HW["gh200"], sample=a, eps_target=1e-5, use_db=False)
    assert got.best.config.plan is not None
    assert _rows(got, tune.config_to_dict) == _rows(want, rt.config_to_dict)
    from_tensor = tune.tune(n, repro_torch.CholeskyConfig(
        tb=tb, policy="auto"), hw=HW["gh200"], sample=torch.from_numpy(a),
        eps_target=1e-5, use_db=False)
    assert _rows(from_tensor, tune.config_to_dict) == \
        _rows(got, tune.config_to_dict)
    # the tuned MxP config plans and factors
    l = repro_torch.plan(n, got.config).compile(device="cpu").factor(a)
    assert np.abs(l @ l.T - a).max() / np.abs(a).max() < 1e-4


# ---------------------------------------------------------------------------
# planner integration

@pytest.mark.parametrize("n,kw", [
    (512, {}), (2048, dict(hw="a100-pcie")), (1024, dict(policy="v1")),
    (1024, dict(hw="tpu-v5e", ndev=2, cache_slots=24, lookahead=0))],
    ids=["default", "a100", "v1", "ndev2"])
def test_plan_auto_equals_reference(n, kw):
    kw = {"tb": 0, "policy": "auto", **kw}
    backend = dict(backend="numpy") if kw.get("ndev", 1) > 1 else {}
    want = repro.plan(n, _ref_cfg(**kw, **backend))
    before = api.schedule_build_count()
    pl = repro_torch.plan(n, _port_cfg(**kw, **backend))
    assert api.schedule_build_count() - before == 1
    assert tune.config_to_dict(pl.config) == rt.config_to_dict(want.config)
    assert pl.schedule.digest() == want.schedule.digest()
    # repeat plan() with the auto config, and with the resolved one: the
    # same cached plan, no new build
    assert repro_torch.plan(n, _port_cfg(**kw, **backend)) is pl
    assert repro_torch.plan(n, pl.config) is pl
    assert api.schedule_build_count() - before == 1
    a = repro_torch.random_spd(n, seed=3)
    l = pl.compile(device="cpu").factor(a)
    assert np.abs(l - np.linalg.cholesky(a)).max() < 1e-10


def test_plan_auto_cache_tracks_default_hardware():
    """The auto key carries the resolving model: installing another
    default model re-resolves instead of serving the previous plan."""
    n = 2048
    auto = repro_torch.CholeskyConfig(tb=0, policy="auto")
    p1 = repro_torch.plan(n, auto)
    tiny = dataclasses.replace(HW["gh200"], mem_bytes=8e6, name="tiny-mem")
    tune.set_default_hardware(tiny)
    p2 = repro_torch.plan(n, auto)
    assert p2 is not p1 and p2.config != p1.config
    assert p2.config == tune.resolve_config(n, auto)
    assert p2.config.tb ** 2 * 8 * p2.config.cache_slots <= 8e6
    rt.set_default_hardware(dataclasses.replace(
        REF_HW["gh200"], mem_bytes=8e6, name="tiny-mem"))
    assert tune.config_to_dict(p2.config) == rt.config_to_dict(
        repro.plan(n, _ref_cfg(tb=0, policy="auto")).config)
    pinned = repro_torch.CholeskyConfig(tb=0, policy="auto", hw="a100-pcie")
    p3 = repro_torch.plan(n, pinned)
    tune.set_default_hardware(None)
    assert repro_torch.plan(n, pinned) is p3


def test_open_dimensions_validate_as_the_reference():
    # a pinned slot budget with policy="auto" is the search's to check
    repro_torch.CholeskyConfig(tb=0, policy="auto", cache_slots=2)
    with pytest.raises(ValueError, match="cache slots"):
        repro_torch.CholeskyConfig(tb=64, policy="v3", cache_slots=3)
    cfg = repro_torch.CholeskyConfig(tb=0, policy="auto", eps_target=1e-6)
    assert cfg.needs_tuning
    with pytest.raises(ValueError, match="tb"):
        cfg.specialize(repro_torch.random_spd(256, seed=0))
    with pytest.raises(ValueError, match="eps_target"):
        repro_torch.plan(256, cfg)


# ---------------------------------------------------------------------------
# the db

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_db_files_read_across_packages(writer, tmp_path):
    path = str(tmp_path / "tune.json")
    a = _mxp_sample(256)
    ref_cfg = _ref_cfg(tb=64, policy="v2", cache_slots=7, ladder="gpu",
                       eps_target=1e-6, use_pallas=True,
                       compute_dtype=np.float32, hw="gh200").specialize(a)
    port_cfg = repro_torch.config_from_reference(dataclasses.asdict(ref_cfg))
    others = [(_ref_cfg(tb=128, policy="v3", ndev=2, grid=(1, 2),
                        lookahead=1, cache_slots=9),
               repro_torch.CholeskyConfig(tb=128, policy="v3", ndev=2,
                                          grid=(1, 2), lookahead=1,
                                          cache_slots=9)),
              (_ref_cfg(tb=32, policy="v4", block=(2, 3), backend="numpy",
                        host_slots=5),
               repro_torch.CholeskyConfig(tb=32, policy="v4", block=(2, 3),
                                          backend="numpy", host_slots=5))]
    pairs = [(ref_cfg, port_cfg)] + others
    if writer == "reference":
        db = rt.TuningDB(path)
        for k, (rc, _) in enumerate(pairs):
            db.put("fp", 256 * (k + 1), 1, 1e-6, rc, 0.5 + k, "gh200",
                   "datasheet")
        back = tune.TuningDB(path)
        for k, (rc, pc) in enumerate(pairs):
            assert back.get("fp", 256 * (k + 1), 1, 1e-6) == pc
            assert back.get_record("fp", 256 * (k + 1), 1, 1e-6) == \
                db.get_record("fp", 256 * (k + 1), 1, 1e-6)
    else:
        db = tune.TuningDB(path)
        for k, (_, pc) in enumerate(pairs):
            db.put("fp", 256 * (k + 1), 1, 1e-6, pc, 0.5 + k, "gh200",
                   "datasheet")
        back = rt.TuningDB(path)
        for k, (rc, pc) in enumerate(pairs):
            assert back.get("fp", 256 * (k + 1), 1, 1e-6) == rc
            assert tune.config_to_dict(pc) == rt.config_to_dict(rc)
    blob = json.loads(open(path).read())
    assert blob["schema"] == 1 and len(blob["records"]) == len(pairs)
    assert tune.default_db_path() is None or isinstance(
        tune.default_db_path(), str)


def test_db_round_trip_and_modes(tmp_path):
    path = str(tmp_path / "tune.json")
    db = tune.TuningDB(path)
    pplan = repro_torch.uniform_plan(8, "f32")
    cfg = repro_torch.CholeskyConfig(tb=128, policy="v4", cache_slots=30,
                                     plan=pplan, hw="gh200")
    db.put("fp123", 1024, 1, 1e-6, cfg, predicted_makespan=1.25)
    got = tune.TuningDB(path).get("fp123", 1024, 1, 1e-6)
    assert got == cfg and got.plan == pplan
    assert tune.TuningDB(path).get("fp123", 1024, 2, 1e-6) is None
    mem = tune.TuningDB(None)
    mem.put("fp", 512, 1, None, cfg, 0.5)
    assert mem.get("fp", 512, 1, None) == cfg and mem.path is None
    with open(path, "w") as f:
        f.write("{not json")
    assert len(tune.TuningDB(path)) == 0


def test_resolve_config_uses_db_and_pins(tmp_path):
    db = tune.TuningDB(str(tmp_path / "db.json"))
    auto = repro_torch.CholeskyConfig(tb=0, policy="auto", hw="gh200")
    c1 = tune.resolve_config(1024, auto, db=db)
    assert len(db) == 1 and tune.resolve_config(1024, auto, db=db) == c1
    c2 = tune.resolve_config(1024, dataclasses.replace(auto, policy="sync"),
                             db=db)
    assert c2.policy == "sync"


# ---------------------------------------------------------------------------
# calibration and the trace refit

def _port_trace(backend):
    n, tb = 192, 48
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    kw = dict(backend="numpy") if backend == "numpy" else \
        dict(compute_dtype=torch.float32, use_pallas=True)
    rec = obs.TraceRecorder()
    repro_torch.plan(n, tb=tb, policy="v3", **kw).compile(
        device="cpu").factor(a, trace=rec)
    return rec


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("base", [None, "gh200"])
def test_refine_from_trace_equals_reference(backend, base):
    rec = _port_trace(backend)
    got = tune.calibrate(refine_from=rec, device="cpu",
                         base=None if base is None else HW[base])
    want = rt.calibrate(refine_from=rec,
                        base=None if base is None else REF_HW[base])
    g, w = tune.model_to_dict(got), rt.model_to_dict(want)
    assert g.pop("fingerprint") == tune.hardware_fingerprint("cpu")
    w.pop("fingerprint")
    assert g == w
    assert tune.model_from_dict(tune.model_to_dict(got)) == got
    with pytest.raises(ValueError, match="empty"):
        tune.refine_from_trace(obs.TraceRecorder(), device="cpu")


def test_model_to_dict_equals_reference():
    for name in PRESETS:
        assert tune.model_to_dict(HW[name]) == rt.model_to_dict(REF_HW[name])


def test_calibrate_cpu_has_the_reference_keys():
    got = tune.calibrate(tb=32, repeats=1, transfer_sizes_mb=(1,),
                         device="cpu")
    want = rt.calibrate(tb=32, repeats=1, transfer_sizes_mb=(1,))
    g, w = tune.model_to_dict(got), rt.model_to_dict(want)
    assert set(g) == set(w)
    assert set(got.flops) == set(want.flops)
    assert {t: set(c) for t, c in got.kernel_flops.items()} == \
        {t: set(c) for t, c in want.kernel_flops.items()}
    rates = [r for per in got.kernel_flops.values() for r in per.values()]
    rates += [got.h2d_bw, got.d2h_bw, got.launch_overhead,
              got.alloc_overhead, got.disk_read_bw, got.disk_write_bw]
    assert all(r > 0 and np.isfinite(r) for r in rates)
    assert got.link_bw == 0.0 and got.mem_bytes == 8 * GB
    assert got.source == "measured"
    assert got.fingerprint == tune.hardware_fingerprint("cpu")
    # the measured model drives the same search path as the presets
    res = tune.tune(4096, hw=got, use_db=False)
    assert tune.is_feasible(4096, res.config, got)


def test_calibrate_f32_route_times_the_kernel_table(monkeypatch):
    """``compute_dtype``/``use_pallas`` pick what is timed: with f32 and the
    kernel route every tile op goes through ``kernels.ops`` (the wrappers,
    here their plain versions), the fused step included."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    tune.calibrate(tb=64, repeats=1, transfer_sizes_mb=(1,), device="cpu",
                   compute_dtype=torch.float32, classes=("f32", "bf16"))
    calls = ops.call_counts()
    # per class and task: the timed calls; the overhead probe's GEMMs
    assert calls["potrf"] == calls["trsm"] == calls["syrk_update"] == 2
    assert calls["mxp_gemm_update"] == 2 + 1 + 50
    assert calls["fused_column_step"] == 2
    # the stock route: only the fused step, which the fused executor runs
    # on either route, goes through ops
    ops.reset_counts()
    tune.calibrate(tb=64, repeats=1, transfer_sizes_mb=(1,), device="cpu",
                   use_pallas=False, classes=("f32",))
    assert ops.call_counts() == {**dict.fromkeys(ops.TILE_OPS, 0),
                                 "fused_column_step": 1}


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.calibrate(tb=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.hardware_fingerprint()
    assert tune.hardware_fingerprint("cpu") == tune.hardware_fingerprint(
        torch.device("cpu"))


def test_tune_and_serve_import_neither_jax_nor_repro():
    """With jax and repro blocked from import, the tuner searches, resolves
    a plan and factors, and the service serves a factor, on the CPU."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
        "'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "from repro_torch import tune, serve\n"
        "from repro_torch.tune import autotune, calibrate, db, search\n"
        "from repro_torch.serve import admission, batching, metrics, "
        "service\n"
        "r = tune.search(1024, repro_torch.HW['gh200'])\n"
        "pl = repro_torch.plan(256, repro_torch.CholeskyConfig(tb=0, "
        "policy='auto'))\n"
        "a = repro_torch.random_spd(256, seed=1)\n"
        "with serve.SolverService(workers=1, device='cpu') as svc:\n"
        "    s = svc.session('t', 256, pl.config)\n"
        "    l = s.factor(a, materialize=True)\n"
        "assert np.abs(l - np.linalg.cholesky(a)).max() < 1e-10\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro')))\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_device_time_holds_the_stream_until_the_batch_is_queued(
        monkeypatch):
    """On a card a rate is the device time a call: CUDA events around a
    batch queued behind a spin kernel.  A batch the device reached before
    the host had queued it is timed again behind a longer hold; one that no
    hold covers raises instead of taking another rate."""
    import importlib

    # the module, which the package's calibrate() function shadows
    cal = importlib.import_module("repro_torch.tune.calibrate")
    holds, drained = [], []

    class FakeEvent:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def query(self):
            return drained.pop(0)

        def elapsed_time(self, other):
            return 0.3                      # ms

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "_sleep", holds.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    dev = torch.device("cuda")
    drained[:] = [True, True, False]
    assert cal.call_seconds(lambda: calls.append(1), 3, dev) == \
        pytest.approx(1e-4)
    assert holds == [cal._HOLD_CYCLES * 4 ** k for k in range(3)]
    assert len(calls) == 1 + 3 * 3          # the warm call, three batches
    drained[:] = [True] * cal._MAX_HOLDS
    with pytest.raises(RuntimeError, match="longest hold"):
        cal.call_seconds(lambda: None, 3, dev)
