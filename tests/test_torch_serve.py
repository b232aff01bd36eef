"""The port's solver service (``repro_torch.serve``) against the reference's.

The cases of ``tests/test_serve.py`` and ``tests/test_concurrent_plan.py``,
on the port with ``device="cpu"``: mixed traffic bitwise the serial solver,
solve coalescing, stacked and fused requests, front-door validation, shared
plans, admission (the reference's decisions: ``plan_device_bytes`` at the
f64 ceiling), round-robin fairness, metrics and the timeline, the
likelihood through a session, fault isolation, the plan cache under thread
pressure and one executor per plan.  Across packages on
``backend="numpy"``: served factors bitwise the reference service's,
solves within 1e-10.  Batching is held by occupancy counts, not by wall
clock.  The kernel counters stay exact under eight threads.
"""
import sys
import threading
import time

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import repro
from repro.serve import SolverService as RefService
from repro.serve import plan_device_bytes as ref_plan_device_bytes

import repro_torch
from repro_torch.core import api
from repro_torch.core.analytics import HardwareModel
from repro_torch.geo.likelihood import gaussian_loglik
from repro_torch.kernels import ops
from repro_torch.serve import (AdmissionController, AdmissionError,
                               SolverService, coalesce_head,
                               plan_device_bytes, plan_device_slots,
                               split_solutions, stack_rhs)

N, TB = 64, 16
CFG = repro_torch.CholeskyConfig(tb=TB, policy="v3", backend="numpy")
REF_CFG = repro.CholeskyConfig(tb=TB, policy="v3", backend="numpy")
TORCH_CFG = repro_torch.CholeskyConfig(tb=TB, policy="v3")


def _service(**kw):
    return SolverService(device="cpu", **kw)


@pytest.fixture
def spd():
    return repro_torch.random_spd(N, seed=11)


@pytest.fixture
def serial(spd):
    """Serial solver, factored."""
    s = repro_torch.plan(N, CFG).compile(device="cpu")
    s.factor(spd, materialize=False)
    return s


# ---------------------------------------------------------------------------
# against the reference's service

@pytest.mark.parametrize("workers", [1, 3])
def test_served_factors_bitwise_the_reference_service(spd, workers):
    """Three tenants on the numpy backend, each through both services: the
    factors and logdets are the reference service's bit for bit, and the
    solves within 1e-10."""
    mats = [repro_torch.random_spd(N, seed=s) for s in (11, 12, 13)]
    rng = np.random.default_rng(0)
    bs = [rng.standard_normal((N, 3)) for _ in mats]
    out = {}
    for name, svc_cls, cfg in (("port", _service, CFG),
                               ("ref", RefService, REF_CFG)):
        with svc_cls(workers=workers, batch_window=0.0) as svc:
            sess = [svc.session(f"t{i}", N, cfg) for i in range(len(mats))]
            fl = [s.factor_async(a, materialize=True)
                  for s, a in zip(sess, mats)]
            ls = [f.result(timeout=60) for f in fl]
            xs = [s.solve(b) for s, b in zip(sess, bs)]
            lds = [s.logdet() for s in sess]
        out[name] = (ls, xs, lds)
    for lp, lr in zip(out["port"][0], out["ref"][0]):
        assert np.array_equal(lp, lr)
    assert out["port"][2] == out["ref"][2]
    for xp, xr in zip(out["port"][1], out["ref"][1]):
        np.testing.assert_allclose(xp, xr, rtol=0, atol=1e-10)


def test_admission_decisions_equal_the_reference():
    """``plan_device_bytes``/``slots`` are the reference's for the same
    schedules, so both packages admit and refuse the same plans."""
    for kw in (dict(tb=16, policy="v3"), dict(tb=32, policy="v2",
                                              cache_slots=9),
               dict(tb=16, policy="v3", ndev=2, lookahead=1),
               dict(tb=16, policy="v1", ndev=4, grid=(2, 2))):
        pp = repro_torch.plan(128, backend="numpy", **kw)
        rp = repro.plan(128, backend="numpy", **kw)
        assert plan_device_bytes(pp) == ref_plan_device_bytes(rp)
        assert plan_device_slots(pp) == max(
            rp.schedule.stream_nslots(d) for d in range(rp.schedule.ndev))


# ---------------------------------------------------------------------------
# the reference's service cases, on the port

def test_mixed_traffic_bit_identical_to_serial(spd, serial):
    rng = np.random.default_rng(0)
    bs = [rng.standard_normal(N) for _ in range(12)]
    refs = [serial.solve(b) for b in bs]
    ref_lower = [serial.solve_lower(b) for b in bs]
    ld = serial.logdet()
    with _service(workers=3, batch_window=0.0) as svc:
        sessions = [svc.session(f"t{i}", N, CFG) for i in range(3)]
        for s in sessions:
            assert s.factor(spd) is None          # materialize=False
        futs, lfuts, dfuts = [], [], []
        for i, b in enumerate(bs):
            s = sessions[i % 3]
            futs.append(s.solve_async(b))
            lfuts.append(s.solve_lower_async(b))
            dfuts.append(s.logdet_async())
        for f, ref in zip(futs, refs):
            assert np.array_equal(f.result(timeout=60), ref)
        for f, ref in zip(lfuts, ref_lower):
            assert np.array_equal(f.result(timeout=60), ref)
        for f in dfuts:
            assert f.result(timeout=60) == ld


def test_torch_backend_tenants_bitwise_solo(spd):
    """Two tenants on the torch backend (the card's executor, here on CPU
    handles) factored at once: each factor bitwise its solo one, the tile
    ops counted exactly twice the schedule's."""
    mats = [spd, repro_torch.random_spd(N, seed=12)]
    solo = []
    for a in mats:
        s = repro_torch.plan(N, TORCH_CFG).compile(device="cpu")
        solo.append((s.factor(a), s.logdet()))
    sched = repro_torch.plan(N, TORCH_CFG).single_schedule()
    from repro_torch.core.schedule import OpKind
    with _service(workers=2) as svc:
        sess = [svc.session(f"t{i}", N, TORCH_CFG) for i in range(2)]
        ops.reset_counts()
        futs = [s.factor_async(torch.from_numpy(a), materialize=True)
                for s, a in zip(sess, mats)]
        ls = [f.result(timeout=60) for f in futs]
        calls = ops.call_counts()
        for s, l, (l0, ld0) in zip(sess, ls, solo):
            assert np.array_equal(l, l0) and s.logdet() == ld0
    # f64 on the stock route: nothing goes through the kernel table
    assert calls == {"mxp_gemm_update": 0, "syrk_update": 0, "trsm": 0,
                     "potrf": 0, "fused_column_step": 0}
    f32 = repro_torch.CholeskyConfig(tb=TB, policy="v3", use_pallas=True,
                                     compute_dtype=torch.float32)
    with _service(workers=2) as svc:
        sess = [svc.session(f"t{i}", N, f32) for i in range(2)]
        ops.reset_counts()
        for f in [s.factor_async(a) for s, a in zip(sess, mats)]:
            f.result(timeout=60)
        calls = ops.call_counts()
    assert calls == {"mxp_gemm_update": 2 * sched.count(OpKind.GEMM),
                     "syrk_update": 2 * sched.count(OpKind.SYRK),
                     "trsm": 2 * sched.count(OpKind.TRSM),
                     "potrf": 2 * sched.count(OpKind.POTRF),
                     "fused_column_step": 0}


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_one_device_runs_one_work_item_at_a_time(spd, backend, monkeypatch):
    """Two tenants' factors and solves on the torch backend never run at
    once on one device (the process-wide device lock); the numpy backend's
    replays, on the host, still do."""
    from repro_torch.serve import service
    cfg = TORCH_CFG if backend == "torch" else CFG
    active, peak = [0], {"factor": 0, "solve": 0}
    guard = threading.Lock()

    def counted(kind, fn):
        def wrapped(self, *args, **kw):
            with guard:
                active[0] += 1
                peak[kind] = max(peak[kind], active[0])
            try:
                time.sleep(0.2)
                return fn(self, *args, **kw)
            finally:
                with guard:
                    active[0] -= 1
        return wrapped

    for kind in peak:
        monkeypatch.setattr(api.OOCSolver, kind,
                            counted(kind, getattr(api.OOCSolver, kind)))
    mats = [spd, repro_torch.random_spd(N, seed=12)]
    with _service(workers=2, batch_window=0.0) as svc:
        sess = [svc.session(f"t{i}", N, cfg) for i in range(2)]
        for f in [s.factor_async(a) for s, a in zip(sess, mats)]:
            f.result(timeout=60)
        for f in [s.solve_async(np.ones(N)) for s in sess]:
            f.result(timeout=60)
        locks = [service.device_locks(s._solver) for s in sess]
    if backend == "torch":
        assert peak == {"factor": 1, "solve": 1}
        assert len(locks[0]) == 1 and locks[0][0] is locks[1][0]
    else:
        assert peak == {"factor": 2, "solve": 2}
        assert locks == [[], []]


def test_batched_solves_coalesce_and_match(spd, serial):
    rng = np.random.default_rng(1)
    bs = [rng.standard_normal(N) for _ in range(8)]
    refs = [serial.solve(b) for b in bs]
    with _service(workers=1, batch_window=0.02, max_batch=32) as svc:
        s = svc.session("t", N, CFG)
        s.factor(spd)
        futs = [s.solve_async(b) for b in bs]
        for f, ref in zip(futs, refs):
            np.testing.assert_allclose(f.result(timeout=60), ref,
                                       rtol=0, atol=1e-10)
        snap = svc.metrics.snapshot()
    assert snap["batch"]["max_occupancy"] >= 2
    assert snap["batch"]["batched_solves"] >= 1


def test_batching_by_occupancy_counts(spd):
    """The reference's open-loop burst, held by counts: one RHS a work item
    without batching, coalesced items with it, the same solutions."""
    rng = np.random.default_rng(5)
    bs = [rng.standard_normal(N) for _ in range(64)]

    def drain(batch_window, max_batch):
        with _service(workers=1, batch_window=batch_window,
                      max_batch=max_batch) as svc:
            s = svc.session("t", N, CFG)
            s.factor(spd)
            futs = [s.solve_async(b) for b in bs]
            xs = [f.result(timeout=120) for f in futs]
            snap = svc.metrics.snapshot()
        return xs, snap

    xs_base, base = drain(0.0, 1)
    xs_batch, batch = drain(0.005, 32)
    for a, b in zip(xs_base, xs_batch):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    assert base["batch"]["max_occupancy"] == 1
    assert base["batch"]["batches"] == 1 + 64
    assert batch["batch"]["max_occupancy"] >= 2
    assert batch["batch"]["batches"] < 1 + 64
    assert batch["batch"]["max_occupancy"] <= 32
    assert batch["kinds"] == base["kinds"] == {"factor": 1, "solve": 64}


def test_solve_batch_stacked_request(spd):
    rng = np.random.default_rng(2)
    B = rng.standard_normal((N, 5))
    with _service(workers=1) as svc:
        s = svc.session("t", N, CFG)
        s.factor(spd)
        X = s.solve_batch(B)
    c = sla.cho_factor(np.asarray(spd), lower=True)
    np.testing.assert_allclose(X, sla.cho_solve(c, B), rtol=0, atol=1e-10)


def test_factor_solve_fused(spd, serial):
    b = np.arange(N, dtype=float)
    with _service(workers=1) as svc:
        s = svc.session("t", N, CFG)
        x = s.factor_solve(spd, b)
        assert np.array_equal(x, serial.solve(b))
        l, x2 = s.factor_solve(spd, b, materialize=True)
        assert np.array_equal(x2, x)
        assert np.allclose(l @ l.T, np.asarray(spd), atol=1e-8)


def test_solve_before_factor_fails(spd):
    with _service(workers=1) as svc:
        s = svc.session("t", N, CFG)
        with pytest.raises(RuntimeError, match="no factor"):
            s.solve(np.ones(N))
        s.factor(spd)
        assert s.solve(np.ones(N)).shape == (N,)


def test_rhs_validation_front_door(spd):
    with _service(workers=1) as svc:
        s = svc.session("t", N, CFG)
        with pytest.raises(ValueError, match="does not match"):
            s.solve_async(np.ones(N + 1))
        with pytest.raises(TypeError, match="real-valued"):
            s.solve_async(np.ones(N, dtype=complex))
        with pytest.raises(ValueError, match="does not match"):
            s.factor_async(np.ones((N, N + 1)))
        with pytest.raises(ValueError, match="does not match"):
            s.factor_async(torch.ones((N + 1, N + 1)))
        with pytest.raises(ValueError, match="stacked"):
            s.solve_batch_async(np.ones(N))


def test_sessions_share_plan_not_solver(spd):
    api.clear_plan_cache()
    before = api.schedule_build_count()
    with _service(workers=2) as svc:
        s1 = svc.session("a", N, CFG)
        s2 = svc.session("b", N, CFG)
        assert s1._plan is s2._plan
        s1.factor(spd)
        s2.factor(spd)
        assert s1._solver is not s2._solver
    assert api.schedule_build_count() - before == 1


def test_session_idempotent_and_mismatch():
    with _service(workers=1) as svc:
        s1 = svc.session("a", N, CFG)
        assert svc.session("a", N, CFG) is s1
        with pytest.raises(ValueError, match="different config"):
            svc.session("a", N, repro_torch.CholeskyConfig(
                tb=TB, policy="v2", backend="numpy"))


def test_session_requires_resolved_config():
    with _service(workers=1) as svc:
        with pytest.raises(ValueError, match="fully resolved"):
            svc.session("t", N, repro_torch.CholeskyConfig(tb=0,
                                                           policy="auto"))


def test_closed_session_and_service_reject_submits(spd):
    svc = _service(workers=1)
    s = svc.session("t", N, CFG)
    s.factor(spd)
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.solve_async(np.ones(N))
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.session("u", N, CFG)


def test_service_needs_cuda_unless_cpu(spd, monkeypatch):
    """The default device is the card: without one, a factor fails in its
    future, as ``compile()`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with SolverService(workers=1) as svc:
        s = svc.session("t", N, TORCH_CFG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.factor(spd)


def _hw(mem_bytes: float) -> HardwareModel:
    return HardwareModel("test-hw", {"f64": 1e12}, 1e9, 1e9, 0.0,
                         mem_bytes=mem_bytes)


def test_admission_rejects_never_fits(spd):
    plan = repro_torch.plan(N, CFG)
    tiny = _hw(plan_device_bytes(plan) - 1)
    assert plan_device_slots(plan) > tiny.max_cache_slots(TB)
    with _service(workers=1, hw=tiny) as svc:
        s = svc.session("t", N, CFG)
        ops.reset_counts()
        fut = s.factor_async(spd)
        with pytest.raises(AdmissionError, match="device slots"):
            fut.result(timeout=60)
        snap = svc.metrics.snapshot()
        assert snap["rejected"] == 1 and snap["completed"] == 0
        assert s._solver is None                  # nothing compiled or ran


def test_admission_queues_until_release(spd):
    plan = repro_torch.plan(N, CFG)
    one = _hw(int(plan_device_bytes(plan) * 1.5))
    with _service(workers=2, hw=one) as svc:
        s1 = svc.session("a", N, CFG)
        s2 = svc.session("b", N, CFG)
        assert s1.factor(spd) is None
        fut = s2.factor_async(spd)
        time.sleep(0.05)
        assert not fut.done()
        assert svc.admission.reserved_bytes() == plan_device_bytes(plan)
        s1.close()
        assert fut.result(timeout=60) is None
        s2.close()
    assert svc.admission.reserved_bytes() == 0


def test_admission_reads_a_plan_once(spd, monkeypatch):
    """Admission reads a plan's slot count off its schedule once, not at
    every submit and dispatch: a read walks every op of the schedule."""
    from repro_torch.core.schedule import MultiDeviceSchedule
    reads = []
    walk = MultiDeviceSchedule.stream_nslots
    monkeypatch.setattr(MultiDeviceSchedule, "stream_nslots",
                        lambda self, d: reads.append(d) or walk(self, d))
    cfg = repro_torch.CholeskyConfig(tb=32, policy="v2", backend="numpy")
    api.clear_plan_cache()
    plan = repro_torch.plan(N, cfg)
    with _service(workers=2, hw=_hw(4 * plan_device_bytes(plan)),
                  batch_window=0.0) as svc:
        s = svc.session("t", N, cfg)
        s.factor(spd)
        for f in [s.solve_async(np.ones(N)) for _ in range(16)]:
            f.result(timeout=60)
        assert svc.metrics.snapshot()["completed"] == 17
    assert reads == [0]


def test_admission_controller_unbounded():
    ctl = AdmissionController(None)
    assert ctl.unbounded
    plan = repro_torch.plan(N, CFG)
    ctl.check_feasible(plan)
    assert ctl.try_reserve("k", plan)
    assert ctl.reserved_bytes() == 0


def test_round_robin_fairness(spd):
    n_gate = 320
    gate_cfg = repro_torch.CholeskyConfig(tb=16, policy="v3",
                                          backend="numpy")
    with _service(workers=1, batch_window=0.0) as svc:
        s1 = svc.session("a", N, CFG)
        s2 = svc.session("b", N, CFG)
        s1.factor(spd)
        s2.factor(spd)
        gate = svc.session("gate", n_gate, gate_cfg)
        blocker = gate.factor_async(repro_torch.random_spd(n_gate, seed=12))
        futs = []
        for i in range(3):
            futs.append(s1.solve_async(np.ones(N)))
            futs.append(s2.solve_async(np.ones(N)))
        blocker.result(timeout=60)
        for f in futs:
            f.result(timeout=60)
    order = [r.session for r in svc.metrics._records if r.kind == "solve"]
    assert sorted(order) == ["a"] * 3 + ["b"] * 3
    assert order == ["a", "b", "a", "b", "a", "b"] or \
        order == ["b", "a", "b", "a", "b", "a"]


def test_metrics_snapshot_and_chrome_trace(spd):
    from repro_torch.obs import snapshot
    with _service(workers=2) as svc:
        s = svc.session("t", N, CFG)
        s.factor(spd)
        for _ in range(4):
            s.solve(np.ones(N))
        _ = s.logdet()
        snap = svc.metrics.snapshot()
        assert snapshot()["sources"]["serve"]["completed"] == 6
    assert "serve" not in snapshot()["sources"]
    assert snap["completed"] == 6 and snap["rejected"] == 0
    assert snap["kinds"] == {"factor": 1, "solve": 4, "logdet": 1}
    assert snap["latency_s"]["p99"] >= snap["latency_s"]["p50"] > 0
    assert snap["solver"] == {"compiles": 1, "reuse": 5}
    assert snap["solves_per_s"] > 0
    trace = repro_torch.chrome_trace(svc.metrics.timeline())
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(names) == 6
    assert any(n.startswith("solve:t") for n in names)


def test_gaussian_loglik_through_session(spd, serial):
    rng = np.random.default_rng(3)
    y1 = rng.standard_normal(N)
    Y = rng.standard_normal((N, 6))
    with _service(workers=2) as svc:
        s = svc.session("geo", N, CFG)
        s.factor(spd)
        assert gaussian_loglik(s, y1) == gaussian_loglik(serial, y1)
        lls = gaussian_loglik(s, Y)
    ref = np.array([gaussian_loglik(serial, Y[:, j])
                    for j in range(Y.shape[1])])
    assert lls.shape == (6,)
    np.testing.assert_allclose(lls, ref, rtol=0, atol=1e-10)


def test_worker_fault_isolation(spd):
    with _service(workers=1) as svc:
        s1 = svc.session("bad", N, CFG)
        s2 = svc.session("good", N, CFG)
        fut = s1.factor_async(-np.eye(N))          # not SPD: POTRF fails
        with pytest.raises(Exception):
            fut.result(timeout=60)
        s2.factor(spd)
        assert s2.solve(np.ones(N)).shape == (N,)


def test_stack_roundtrip_and_coalesce_rules():
    rng = np.random.default_rng(4)
    parts = [rng.standard_normal(8), rng.standard_normal((8, 3)),
             rng.standard_normal(8)]
    stacked, splits = stack_rhs(parts)
    assert stacked.shape == (8, 5)
    back = split_solutions(stacked, splits)
    for p, b in zip(parts, back):
        assert p.shape == b.shape and np.array_equal(p, b)

    class R:
        def __init__(self, kind, k=1, t_deadline=10.0):
            self.kind, self.k, self.t_deadline = kind, k, t_deadline

    assert coalesce_head([R("factor"), R("solve")], 0.0, 32, 0.01) == \
        (1, None)
    assert coalesce_head([R("solve"), R("solve")], 0.0, 1, 0.01) == (1, None)
    assert coalesce_head([R("solve"), R("solve")], 0.0, 32, 0.0) == (1, None)
    assert coalesce_head([R("solve"), R("solve")], 0.0, 32, 0.01) == \
        (0, 10.0)
    assert coalesce_head([R("solve"), R("solve")], 11.0, 32, 0.01) == \
        (2, None)
    assert coalesce_head([R("solve"), R("solve"), R("factor")],
                         0.0, 32, 0.01) == (2, None)
    assert coalesce_head([R("solve", k=3), R("solve", k=3), R("solve", k=3)],
                         11.0, 4, 0.01) == (1, None)


# ---------------------------------------------------------------------------
# the plan cache and the executor under threads (test_concurrent_plan.py)

SHAPES = [(32, "v3"), (48, "v2"), (64, "v3"), (48, "v3"), (32, "v2")]


def _cfg(policy, **kw):
    return repro_torch.CholeskyConfig(tb=TB, policy=policy, backend="numpy",
                                      **kw)


def _hammer(nthreads, fn):
    """Run fn(thread_index) on nthreads threads, re-raising any failure."""
    errs = []

    def wrap(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=wrap, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errs:
        raise errs[0]


def test_stress_mixed_shapes_bounded_and_bit_identical():
    api.clear_plan_cache()
    before = api.schedule_build_count()
    mats = {n: repro_torch.random_spd(n, seed=n) for n, _ in SHAPES}
    serial = {}
    for n, policy in SHAPES:
        s = repro_torch.plan(n, _cfg(policy)).compile(device="cpu")
        serial[(n, policy)] = s.factor(mats[n])
    after_serial = api.schedule_build_count()
    results = {}
    lock = threading.Lock()

    def worker(i):
        for rep in range(6):
            n, policy = SHAPES[(i + rep) % len(SHAPES)]
            solver = repro_torch.plan(n, _cfg(policy)).compile(device="cpu")
            l = solver.factor(mats[n])
            with lock:
                results.setdefault((n, policy), []).append(l)

    _hammer(8, worker)
    for key, ls in results.items():
        for l in ls:
            assert np.array_equal(l, serial[key])
    assert after_serial - before == len(set(SHAPES))
    assert api.schedule_build_count() == after_serial
    stats = api.plan_cache_stats()
    assert stats["size"] <= stats["max"]


def test_concurrent_misses_collapse_to_one_build():
    api.clear_plan_cache()
    n = 80
    before = api.schedule_build_count()
    plans = []
    lock = threading.Lock()

    def worker(i):
        p = repro_torch.plan(n, _cfg("v3"))
        with lock:
            plans.append(p)

    _hammer(12, worker)
    assert api.schedule_build_count() - before == 1
    assert all(p is plans[0] for p in plans)


def test_concurrent_compile_single_executor_build():
    """compile() raced from many threads builds one executor; concurrent
    factors through it equal the first, and ``executor_builds`` (the
    port's ``jit_traces``) stays at one."""
    api.clear_plan_cache()
    n = 48
    cfg = repro_torch.CholeskyConfig(tb=TB, policy="v3")
    a = repro_torch.random_spd(n, seed=5)
    solvers = []
    lock = threading.Lock()

    def worker(i):
        s = repro_torch.plan(n, cfg).compile(device="cpu")
        with lock:
            solvers.append(s)

    _hammer(8, worker)
    assert len({id(s._executor) for s in solvers}) == 1
    ref = solvers[0].factor(a)

    def factor_worker(i):
        assert np.array_equal(solvers[i % len(solvers)].factor(a), ref)

    _hammer(8, factor_worker)
    assert solvers[0].stats["executor_builds"] == 1


def test_clear_plan_cache_concurrent_with_plan():
    api.clear_plan_cache()
    stop = threading.Event()

    def clearer(i):
        while not stop.is_set():
            api.clear_plan_cache()

    def planner(i):
        try:
            for rep in range(30):
                n, policy = SHAPES[rep % len(SHAPES)]
                p = repro_torch.plan(n, _cfg(policy))
                assert p.n == n
        finally:
            stop.set()

    t = threading.Thread(target=clearer, args=(0,))
    t.start()
    try:
        _hammer(4, planner)
    finally:
        stop.set()
        t.join(timeout=60)
    stats = api.plan_cache_stats()
    assert 0 <= stats["size"] <= stats["max"]


def test_cache_stats_counters_move():
    api.clear_plan_cache()
    s0 = api.plan_cache_stats()
    repro_torch.plan(32, _cfg("v3"))
    repro_torch.plan(32, _cfg("v3"))
    s1 = api.plan_cache_stats()
    assert s1["misses"] == s0["misses"] + 1
    assert s1["hits"] == s0["hits"] + 1


# ---------------------------------------------------------------------------
# the kernel counters under threads

def test_call_counts_exact_under_threads():
    """Eight threads dispatch known numbers of tile ops with a short switch
    interval: every call is counted, none lost."""
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.standard_normal((8, 8))).float()
    spd = c @ c.T + 8 * torch.eye(8)
    l = torch.linalg.cholesky(spd)
    reps = 300
    ops.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for _ in range(reps):
                ops.gemm_update(c, c, c)
                ops.syrk_update(c, c)
                if i % 2:
                    ops.trsm(l, c)
                    ops.potrf(spd)

        _hammer(8, worker)
    finally:
        sys.setswitchinterval(old)
    assert ops.call_counts() == {
        "mxp_gemm_update": 8 * reps, "syrk_update": 8 * reps,
        "trsm": 4 * reps, "potrf": 4 * reps, "fused_column_step": 0}
    assert not any(ops.launch_counts().values())     # the CPU launches none
    ops.reset_counts()
    assert not any(ops.call_counts().values())
