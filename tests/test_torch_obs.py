"""The port's measured traces (``repro_torch.obs``) against the reference's.

After ``tests/test_obs.py``: a traced ``factor()`` records exactly one span
per schedule op, in dispatch order, on every executor the port has (the
NumPy replays, single- and multi-device, spilled or not; the torch executor
on CPU handles, single-device, fused config, multi-device and spill), and
the spans carry the reference's op identity (kind, device, bytes, class,
tile, phase).  A traced torch factor is bitwise the untraced unfused one.
The drift report, the exports and the metrics registry, given the same
spans or the same counter calls, equal the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro
from repro import obs as ref_obs
from repro.core import api as ref_api

import repro_torch
from repro_torch import obs
from repro_torch.core import api, cholesky as chol
from repro_torch.obs import (NULL, MODELED_KINDS, MetricsRegistry,
                             NullRecorder, TraceRecorder,
                             chrome_trace_measured, drift_report,
                             total_abs_error, trace_view, write_jsonl)

_N, _TB = 192, 48


def _spd(n=_N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _ops(plan):
    """The plan's ops in the order the traced executors run them."""
    if plan.config.ndev == 1:
        return plan.single_schedule().ops
    return [op for _, op in plan.schedule.iter_dispatch_order()]


def _identity(spans):
    """Everything of the spans but their clocks."""
    return [(s.op_index, s.kind, s.device, s.bytes, s.cls, s.i, s.j,
             s.phase) for s in spans]


def _ref_numpy_trace(kw, a):
    """The reference's numpy-backend trace of the same layout."""
    cfg = ref_api.CholeskyConfig(tb=_TB, policy="v3", backend="numpy", **kw)
    rec = ref_obs.TraceRecorder()
    l = ref_api.plan(_N, cfg).compile().factor(a, trace=rec)
    return rec, l


def _port_traced(cfg, a):
    plan = api.plan(a.shape[0], cfg)
    rec = TraceRecorder()
    solver = plan.compile(device="cpu")
    l = solver.factor(a, trace=rec)
    return plan, solver, rec, l


def _check_spans(rec, plan):
    ops = _ops(plan)
    assert len(rec) == len(ops) and rec.dropped == 0
    assert [s.op_index for s in rec.spans] == list(range(len(ops)))
    assert [s.kind for s in rec.spans] == [op.kind.value for op in ops]
    assert all(s.t_end >= s.t_start for s in rec.spans)


# ---------------------------------------------------------------------------
# one span per op, every executor
# ---------------------------------------------------------------------------

_NUMPY_VARIANTS = [
    ("numpy-single", {}),
    ("numpy-spill", dict(host_slots=8)),
    ("numpy-ndev2", dict(ndev=2)),
    ("numpy-ndev2-spill", dict(ndev=2, host_slots=8)),
    ("numpy-ndev2-L1", dict(ndev=2, lookahead=1)),
    ("numpy-ndev2-L2", dict(ndev=2, lookahead=2)),
]


@pytest.mark.parametrize("label,kw", _NUMPY_VARIANTS,
                         ids=[v[0] for v in _NUMPY_VARIANTS])
def test_numpy_executors_one_span_per_op(label, kw):
    """The NumPy replays, traced: one span per op with the reference's
    identity, and the factor bitwise the reference's."""
    a = _spd()
    plan, _, rec, l = _port_traced(
        repro_torch.CholeskyConfig(tb=_TB, policy="v3", backend="numpy",
                                   **kw), a)
    _check_spans(rec, plan)
    want_rec, want = _ref_numpy_trace(kw, a)
    assert _identity(rec.spans) == _identity(want_rec.spans)
    assert np.array_equal(l, want)
    assert np.abs(l - np.linalg.cholesky(a)).max() < 1e-10


_TORCH_VARIANTS = [
    ("torch-single", {}, {}),
    ("torch-fused", dict(fuse_columns=True, use_pallas=True), {}),
    ("torch-spill", dict(host_slots=8), dict(host_slots=8)),
    ("torch-spill-fused", dict(host_slots=8, fuse_columns=True,
                               use_pallas=True), dict(host_slots=8)),
] + [
    (f"torch-ndev{nd}-L{la}", dict(ndev=nd, lookahead=la or None),
     dict(ndev=nd, lookahead=la or None))
    for nd in (2, 4) for la in (0, 1, 2)
] + [
    ("torch-grid22-L1", dict(ndev=4, grid=(2, 2), lookahead=1),
     dict(ndev=4, grid=(2, 2), lookahead=1)),
]


@pytest.mark.parametrize("label,kw,ref_kw", _TORCH_VARIANTS,
                         ids=[v[0] for v in _TORCH_VARIANTS])
def test_torch_executors_one_span_per_op(label, kw, ref_kw):
    """The torch executors on CPU handles, traced: one span per op in the
    reference's dispatch order and identity (its numpy-backend trace of
    the same layout), the factor bitwise the untraced unfused one, and
    the transfer counters those of the untraced run."""
    a = _spd()
    cfg = repro_torch.CholeskyConfig(tb=_TB, policy="v3", **kw)
    plan, solver, rec, l = _port_traced(cfg, a)
    _check_spans(rec, plan)
    want_rec, _ = _ref_numpy_trace(ref_kw, a)
    assert _identity(rec.spans) == _identity(want_rec.spans)
    traced_stats = solver.stats["transfers"]
    traced_wires = solver.transfer_stats()
    unfused = api.plan(_N, dataclasses.replace(
        cfg, fuse_columns=False)).compile(device="cpu")
    assert np.array_equal(l, unfused.factor(a))
    assert traced_wires == unfused.transfer_stats()
    assert traced_stats == unfused.stats["transfers"]
    assert np.abs(l - np.linalg.cholesky(a)).max() < 1e-10
    if cfg.ndev > 1:
        assert {s.device for s in rec.spans} == set(range(cfg.ndev))
        assert rec.meta["lookahead"] == (cfg.lookahead or 0)


def test_traced_path_runs_the_unfused_interpreter():
    """A traced fused-config factor launches no fused step: it runs the
    per-op kernels, as many as the schedule has compute ops."""
    from repro_torch.kernels import ops
    a = _spd()
    cfg = repro_torch.CholeskyConfig(tb=_TB, fuse_columns=True,
                                     use_pallas=True)
    solver = api.plan(_N, cfg).compile(device="cpu")
    ops.reset_counts()
    solver.factor(a, trace=TraceRecorder())
    calls = ops.call_counts()
    sched = solver.schedule
    assert calls["fused_column_step"] == 0
    assert calls["potrf"] == sched.count(chol.OpKind.POTRF)
    assert calls["mxp_gemm_update"] == sched.count(chol.OpKind.GEMM)


def test_trace_meta_keys_equal_reference():
    a = _spd()
    ref_rec = ref_obs.TraceRecorder()
    ref_api.plan(_N, ref_api.CholeskyConfig(
        tb=_TB, backend="numpy", ndev=2)).compile().factor(a, trace=ref_rec)
    for kw in (dict(backend="numpy", ndev=2), dict(ndev=2), {},
               dict(host_slots=8)):
        _, _, rec, _ = _port_traced(repro_torch.CholeskyConfig(tb=_TB, **kw),
                                    a)
        assert set(rec.meta) == set(ref_rec.meta)
    assert rec.meta["n"] == _N and rec.meta["tb"] == _TB
    assert rec.meta["backend"] == "torch" and rec.makespan_s() > 0


def test_compile_pins_a_default_recorder():
    a = _spd()
    rec = TraceRecorder()
    plan = api.plan(_N, repro_torch.CholeskyConfig(tb=_TB))
    solver = plan.compile(device="cpu", trace=rec)
    solver.factor(a)
    assert len(rec) == len(plan.single_schedule().ops)
    other = TraceRecorder()
    solver.factor(a, trace=other)           # a per-call trace overrides
    assert len(rec) == len(other) == len(plan.single_schedule().ops)


def test_null_recorder_is_free_and_bit_identical(monkeypatch):
    """``NULL`` and an inactive recorder take the untraced path: the same
    factor bitwise, no executor rebuilt, no span, and never the measured
    path (which is patched here to fail)."""
    a = _spd()
    solver = api.plan(_N, repro_torch.CholeskyConfig(tb=_TB)).compile(
        device="cpu")
    base = solver.factor(a)
    builds = solver.stats["executor_builds"]

    def boom(*_a, **_k):
        raise AssertionError("measured path taken")

    monkeypatch.setattr(chol, "run_traced_torch", boom)
    null = NullRecorder()
    assert np.array_equal(solver.factor(a, trace=null), base)
    assert np.array_equal(solver.factor(a, trace=NULL), base)
    assert solver.stats["executor_builds"] == builds
    assert len(null.spans) == 0 and not null.active
    assert obs.resolve(None) is NULL and not obs.is_active(NULL)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_ring_buffer_overflow_counts_drops(backend):
    a = _spd()
    rec = TraceRecorder(capacity=4)
    plan = api.plan(_N, repro_torch.CholeskyConfig(tb=_TB, backend=backend))
    plan.compile(device="cpu").factor(a, trace=rec)
    assert len(rec.spans) == 4
    assert rec.dropped == len(plan.single_schedule().ops) - 4
    assert [s.op_index for s in rec.spans] == list(
        range(len(plan.single_schedule().ops) - 4,
              len(plan.single_schedule().ops)))
    with pytest.raises(ValueError, match="dropped"):
        drift_report(rec, plan.simulate(repro_torch.HW["a100-pcie"],
                                        record_timeline=True))


# ---------------------------------------------------------------------------
# drift and export: equal to the reference's on the same spans
# ---------------------------------------------------------------------------

_LAYOUTS = [("single", {}), ("spill", dict(host_slots=8)),
            ("ndev2-L1", dict(ndev=2, lookahead=1))]


def _twin(rec):
    """A reference recorder holding the same spans and meta."""
    twin = ref_obs.TraceRecorder()
    for s in rec.spans:
        twin.record(*s)
    twin.meta = dict(rec.meta)
    return twin


def _pair(kw):
    """The port's traced torch run of ``kw``, the reference's twin of its
    trace, and both packages' simulations of the same schedule."""
    a = _spd()
    plan, _, rec, _ = _port_traced(
        repro_torch.CholeskyConfig(tb=_TB, policy="v3", **kw), a)
    ref_plan = ref_api.plan(_N, ref_api.CholeskyConfig(
        tb=_TB, policy="v3", backend="numpy", **kw))
    assert ref_plan.schedule.digest() == plan.schedule.digest()
    hw = "h100-pcie"
    return (rec, _twin(rec),
            plan.simulate(repro_torch.HW[hw], record_timeline=True),
            ref_plan.simulate(repro.HW[hw], record_timeline=True))


@pytest.mark.parametrize("label,kw", _LAYOUTS, ids=[v[0] for v in _LAYOUTS])
def test_drift_report_equals_reference(label, kw):
    rec, twin, sim, ref_sim = _pair(kw)
    rep = drift_report(rec, sim, top_n=5)
    want = ref_obs.drift_report(twin, ref_sim, top_n=5)
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)
    assert rep.summary() == want.summary()
    assert set(rep.per_kind) <= MODELED_KINDS
    assert total_abs_error(rec, sim) == ref_obs.total_abs_error(twin,
                                                                ref_sim)
    if kw.get("host_slots"):
        assert {"fetch", "spill"} <= set(rep.per_kind)


def test_drift_refuses_misaligned_schedule():
    rec, _, sim, _ = _pair({})
    other = api.plan(_N, repro_torch.CholeskyConfig(tb=_TB, policy="sync",
                                                    backend="numpy"))
    with pytest.raises(ValueError):
        drift_report(rec, other.simulate(repro_torch.HW["a100-pcie"],
                                         record_timeline=True))
    # the same schedule's timeline with one op dropped
    short = dataclasses.replace(sim, timeline=sim.timeline[:-1])
    with pytest.raises(ValueError, match="cannot align"):
        drift_report(rec, short)
    with pytest.raises(ValueError, match="record_timeline"):
        drift_report(rec, dataclasses.replace(sim, timeline=[]))


@pytest.mark.parametrize("label,kw", _LAYOUTS, ids=[v[0] for v in _LAYOUTS])
def test_exports_equal_reference(label, kw, tmp_path):
    rec, twin, _, _ = _pair(kw)
    view, want = trace_view(rec), ref_obs.trace_view(twin)
    assert view.timeline == want.timeline
    assert (view.makespan, view.tflops) == (want.makespan, want.tflops)
    got = chrome_trace_measured(rec, tmp_path / "port.json")
    assert got == ref_obs.chrome_trace_measured(twin)
    assert json.loads((tmp_path / "port.json").read_text()) == got
    xs = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert len(xs) >= len(rec.spans)
    n = write_jsonl(rec, tmp_path / "port.jsonl")
    ref_obs.write_jsonl(twin, tmp_path / "ref.jsonl")
    assert n == len(rec.spans)
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    lanes = {e["args"]["name"] for e in got["traceEvents"] if e["ph"] == "M"}
    if kw.get("host_slots"):
        assert {"h2d", "cmp", "d2h", "dsk"} <= lanes
    with pytest.raises(ValueError, match="empty"):
        chrome_trace_measured(TraceRecorder())


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _drive(reg):
    reg.inc("x.calls")
    reg.inc("x.calls", 2)
    reg.set_gauge("x.depth", 7)
    reg.set_gauge("x.ratio", 0.25)
    reg.register_source("good", lambda: {"a": 1, "b": {"c": 2.5},
                                         "flag": True, "name": "skip"})
    reg.register_source("bad", lambda: 1 / 0)


def test_metrics_registry_equals_reference():
    port, ref = MetricsRegistry(), ref_obs.MetricsRegistry()
    _drive(port)
    _drive(ref)
    assert port.snapshot() == ref.snapshot()
    assert port.render_text() == ref.render_text()
    assert "x.calls 3" in port.render_text()
    port.unregister_source("good", fn=lambda: None)
    assert "good" in port.snapshot()["sources"]
    port.unregister_source("good")
    port.unregister_source("bad")
    assert port.snapshot()["sources"] == {}
    port.clear()
    assert port.render_text() == ""


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_global_registry_absorbs_solver_counters(backend):
    before = obs.snapshot()["counters"]
    solver = api.plan(_N, repro_torch.CholeskyConfig(
        tb=_TB, backend=backend, host_slots=8)).compile(device="cpu")
    solver.factor(_spd())
    solver.solve(np.ones(_N))
    snap = obs.snapshot()
    sched = solver.schedule
    c = snap["counters"]
    assert c["repro.factor.calls"] == before.get("repro.factor.calls", 0) + 1
    assert c["repro.factor.h2d_bytes"] - before.get(
        "repro.factor.h2d_bytes", 0) == sched.loads_bytes()
    assert c["repro.factor.fetch_bytes"] - before.get(
        "repro.factor.fetch_bytes", 0) == sched.fetch_bytes()
    assert c["repro.solve.calls"] == before.get("repro.solve.calls", 0) + 1
    assert snap["gauges"]["repro.factor.executor_builds"] == \
        solver.stats["executor_builds"]
    assert snap["sources"]["plan_cache"] == repro_torch.plan_cache_stats()
    assert "repro.factor.calls" in obs.render_text()


# ---------------------------------------------------------------------------
# stats unification (the reference's tests/test_obs.py::test_stats_*)
# ---------------------------------------------------------------------------

def test_stats_transfers_single_device():
    plan = api.plan(_N, repro_torch.CholeskyConfig(tb=_TB, policy="v3"))
    solver = plan.compile(device="cpu")
    solver.factor(_spd())
    t = solver.stats["transfers"]
    sched = plan.single_schedule()
    assert t["h2d_bytes"] == sched.loads_bytes()
    assert t["d2h_bytes"] == sched.stores_bytes()
    assert t["loads"] > 0 and t["stores"] > 0
    assert "scheduled_fetch_bytes" not in t


def test_stats_transfers_multidevice_numpy_spill():
    cfg = repro_torch.CholeskyConfig(tb=_TB, policy="v3", backend="numpy",
                                     ndev=2, host_slots=8)
    plan = api.plan(_N, cfg)
    solver = plan.compile()
    solver.factor(_spd())
    t = solver.stats["transfers"]
    assert t["fetched_bytes"] == plan.schedule.fetch_bytes()
    assert t["spilled_bytes"] == plan.schedule.spill_bytes()
    assert t["bcast_bytes"] == plan.schedule.bcast_bytes()
    ref = ref_api.plan(_N, ref_api.CholeskyConfig(
        tb=_TB, policy="v3", backend="numpy", ndev=2,
        host_slots=8)).compile()
    ref.factor(_spd())
    assert ref.stats["transfers"] == t


def test_torch_tensor_input_traced_equals_numpy_input():
    a = _spd()
    solver = api.plan(_N, repro_torch.CholeskyConfig(tb=_TB)).compile(
        device="cpu")
    got = solver.factor(torch.from_numpy(a), trace=TraceRecorder())
    assert np.array_equal(got, solver.factor(a))
