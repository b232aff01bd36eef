"""The port's single-device slice as a whole, on the CPU, against the
reference: the NumPy oracle, the JAX executor, scipy, and the API's
plan-cache and validation behaviour."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import repro
from repro.core import api as ref_api
from repro.core.cholesky import run_schedule_numpy
from repro.core.schedule import build_schedule as ref_build_schedule
from repro.core.tiling import from_tiles, random_spd, to_tiles

import repro_torch
from repro_torch.core import api
from repro_torch.core.schedule import OpKind

POLICIES = ("sync", "async", "v1", "v2", "v3", "v4")


def _kms(n, rho=0.9):
    """Kac-Murdock-Szego matrix rho^|i-j| (SPD): off-diagonal tiles decay
    with distance, so an eps_target plan mixes the ladder's classes."""
    idx = np.arange(n)
    return rho ** np.abs(idx[:, None] - idx[None, :])


def _oracle(a, ref_cfg):
    """The reference NumPy oracle over the reference's own schedule."""
    p = ref_api.plan(a.shape[0], ref_cfg)
    out = run_schedule_numpy(to_tiles(a, ref_cfg.tb), p.single_schedule())
    return np.tril(from_tiles(out))


def _port(a, ref_cfg):
    cfg = repro_torch.config_from_reference(dataclasses.asdict(ref_cfg))
    solver = repro_torch.plan(a.shape[0], cfg).compile(device="cpu")
    return solver, solver.factor(a)


@pytest.mark.parametrize("policy", POLICIES)
def test_f64_stock_path_matches_oracle(policy):
    a = random_spd(192, seed=3)
    kw = dict(block=(2, 2)) if policy == "v4" else {}
    cfg = repro.CholeskyConfig(tb=32, policy=policy, **kw)
    _, l = _port(a, cfg)
    assert np.abs(l - _oracle(a, cfg)).max() < 1e-13


@pytest.mark.parametrize("ladder", ["tpu", "gpu", "tpu-scaled", "gpu-scaled"])
def test_mxp_plan_f64_compute_matches_oracle(ladder):
    a = _kms(192)
    cfg = repro.CholeskyConfig(tb=32, policy="v3", eps_target=1e-6,
                               ladder=ladder).specialize(a)
    assert sum(v > 0 for v in cfg.plan.histogram().values()) >= 3
    solver, l = _port(a, cfg)
    assert np.array_equal(solver.config.plan.classes, cfg.plan.classes)
    assert np.abs(l - _oracle(a, cfg)).max() < 1e-8


def test_kernel_path_f32_matches_jax_pallas_executor():
    """use_pallas=True in f32 on both sides (the port's plain versions on
    the CPU, the reference's Pallas kernels in interpret mode).  Every
    tile op rounds in f32 on both sides and only the summation order
    differs, so entries agree to a few f32 ulps of max|A| per chained
    tile update: bound 8 * nt * 2^-24 * max|A|."""
    n, tb = 128, 32
    a = random_spd(n, seed=9)
    ref_cfg = repro.CholeskyConfig(
        tb=tb, backend="jax", compute_dtype=np.float32, use_pallas=True,
        plan=repro.uniform_plan(n // tb, "f32"))
    want = ref_api.plan(n, ref_cfg).compile().factor(a)
    _, got = _port(a, ref_cfg)
    bound = 8 * (n // tb) * 2.0 ** -24 * np.abs(a).max()
    assert np.abs(got - want).max() < bound
    assert np.abs(got - np.linalg.cholesky(a)).max() < 5e-3


@pytest.mark.parametrize("nrhs", [None, 3])
def test_solve_solve_lower_logdet_match_scipy(nrhs):
    n = 128
    a = random_spd(n, seed=5)
    solver = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=16, policy="v3")).compile(device="cpu")
    assert solver.factor(a, materialize=False) is None
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n if nrhs is None else (n, nrhs))
    ref = np.linalg.cholesky(a)
    assert np.abs(solver.solve(b) - sla.cho_solve((ref, True), b)).max() \
        < 1e-10
    assert np.abs(solver.solve_lower(b)
                  - sla.solve_triangular(ref, b, lower=True)).max() < 1e-10
    assert abs(solver.logdet() - 2 * np.log(np.diag(ref)).sum()) < 1e-9
    assert solver.stats["solve_calls"] == 2


def test_logdet_rejects_a_broken_factor():
    n = 64
    solver = repro_torch.plan(n, tb=32).compile(device="cpu")
    a = random_spd(n, seed=1)
    a[40, 40] = -5.0       # not SPD: the factor's pivot turns NaN
    solver.factor(a, materialize=False)
    with pytest.raises(ValueError, match="non-positive"):
        solver.logdet()


def test_solve_before_factor_raises():
    solver = repro_torch.plan(64, tb=32).compile(device="cpu")
    with pytest.raises(RuntimeError, match="no factor"):
        solver.solve(np.ones(64))


def test_factor_takes_a_tensor():
    n = 96
    a = random_spd(n, seed=2)
    s = repro_torch.plan(n, tb=32).compile(device="cpu")
    assert np.array_equal(s.factor(torch.from_numpy(a)), s.factor(a))


def test_plan_cache_returns_same_object():
    api.clear_plan_cache()
    p1 = repro_torch.plan(96, tb=32, policy="v2")
    p2 = repro_torch.plan(96, repro_torch.CholeskyConfig(tb=32, policy="v2"))
    assert p1 is p2
    s1, s2 = p1.compile(device="cpu"), p2.compile(device="cpu")
    assert s1 is not s2
    assert s1._executor is s2._executor
    assert p1.executor_builds == 1
    assert repro_torch.plan_cache_stats()["hits"] >= 1
    api.clear_plan_cache()
    assert repro_torch.plan(96, tb=32, policy="v2") is not p1


def test_solvers_of_one_plan_keep_their_own_factor():
    n = 64
    s_a = repro_torch.plan(n, tb=32).compile(device="cpu")
    s_b = repro_torch.plan(n, tb=32).compile(device="cpu")
    a1, a2 = random_spd(n, seed=1), random_spd(n, seed=2)
    s_a.factor(a1)
    s_b.factor(a2)
    b = np.ones(n)
    assert np.allclose(a1 @ s_a.solve(b), b, atol=1e-10)
    assert np.allclose(a2 @ s_b.solve(b), b, atol=1e-10)


def test_call_counts_equal_schedule_op_counts():
    n, tb = 160, 32
    a = random_spd(n, seed=4)
    solver = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=tb, use_pallas=True, compute_dtype=torch.float32)).compile(
            device="cpu")
    repro_torch.reset_counts()
    solver.factor(a, materialize=False)
    sched = solver.schedule
    assert repro_torch.call_counts() == {
        "mxp_gemm_update": sched.count(OpKind.GEMM),
        "syrk_update": sched.count(OpKind.SYRK),
        "trsm": sched.count(OpKind.TRSM),
        "potrf": sched.count(OpKind.POTRF), "fused_column_step": 0}
    # on the CPU the wrappers run the plain versions: no kernel launches
    assert set(repro_torch.launch_counts().values()) == {0}
    t = solver.stats["transfers"]
    assert t["executed_h2d_ops"] == sched.count(OpKind.LOAD)
    assert t["executed_d2h_ops"] == sched.count(OpKind.STORE)
    assert t["executed_h2d_bytes"] == t["executed_h2d_ops"] * tb * tb * 4


def test_port_schedule_equals_reference_schedule():
    a = _kms(128)
    cfg = repro.CholeskyConfig(tb=32, eps_target=1e-6).specialize(a)
    p = repro_torch.plan(128, repro_torch.config_from_reference(
        dataclasses.asdict(cfg)))
    want = ref_build_schedule(4, 32, "v3", plan=cfg.plan)
    assert p.single_schedule().digest() == want.digest()


def test_compile_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = repro_torch.plan(64, tb=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.compile()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.compile(device="cuda")
    assert p.compile(device="cpu").device.type == "cpu"


_TUNER = "tuned"
_MULTI_SPILL = (ValueError, "backend='numpy'")


@pytest.mark.parametrize("kw,raises", [
    # the disk tier is ported: one device runs it on either backend;
    # several devices run it on the NumPy replay only, which the config
    # names instead of resolving to it quietly
    (dict(ndev=2, host_slots=4), _MULTI_SPILL),
    (dict(host_slots=4), None),
    (dict(fuse_columns=True, ndev=2, host_slots=4), _MULTI_SPILL),
    # the tuner is ported: open dimensions resolve as the reference's do,
    # also the tb=0 search a config's hw preset drives
    (dict(tb=0), _TUNER), (dict(policy="auto"), _TUNER),
    (dict(backend="numpy", host_slots=4), None),
    (dict(hw="h100-pcie", tb=0), _TUNER),
], ids=["ndev", "host_slots", "fuse_columns", "tb", "policy", "backend",
        "hw"])
def test_unported_options_raise(kw, raises):
    """Options of the slices ported since this test was written: the disk
    tier's cases plan and factor (one device) or name the backend they need
    (several); the tuner's resolve to the reference's config, plan and
    factor."""
    from repro import tune as ref_tune
    from repro_torch import tune
    kw = {"tb": 32, **kw}
    if isinstance(raises, tuple):
        with pytest.raises(raises[0], match=raises[1]):
            repro_torch.CholeskyConfig(**kw)
        return
    cfg = repro_torch.CholeskyConfig(**kw)
    a = random_spd(128, seed=2)
    p = repro_torch.plan(128, cfg)
    solver = p.compile(device="cpu")
    assert np.abs(solver.factor(a) - np.linalg.cholesky(a)).max() < 1e-10
    if raises == _TUNER:
        assert cfg.needs_tuning and not p.config.needs_tuning
        want = repro.plan(128, repro.CholeskyConfig(**kw)).config
        assert tune.config_to_dict(p.config) == ref_tune.config_to_dict(want)
        return
    t = solver.stats["transfers"]
    assert t["fetched_bytes"] == t["scheduled_fetch_bytes"] > 0


def test_config_from_reference_mirrors_fields():
    a = _kms(128)
    ref_cfg = repro.CholeskyConfig(
        tb=32, policy="v2", ladder="gpu", eps_target=1e-6, cache_slots=5,
        backend="jax", compute_dtype=np.float32).specialize(a)
    cfg = repro_torch.config_from_reference(dataclasses.asdict(ref_cfg))
    assert {f.name for f in dataclasses.fields(cfg)} == \
        {f.name for f in dataclasses.fields(ref_cfg)}
    assert cfg.backend == "torch" and cfg.compute_dtype == torch.float32
    assert (cfg.tb, cfg.policy, cfg.ladder, cfg.cache_slots) == (32, "v2",
                                                                 "gpu", 5)
    assert np.array_equal(cfg.plan.classes, ref_cfg.plan.classes)
    assert cfg.plan.ladder == ref_cfg.plan.ladder
    assert hash(cfg) == hash(repro_torch.config_from_reference(
        dataclasses.asdict(ref_cfg)))


def test_import_leaves_jax_and_repro_out():
    """Every module of the port, imported in a fresh process (walked from
    the package, so a new module is covered), leaves jax, jaxlib,
    ml_dtypes and repro out of ``sys.modules``."""
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "names = sorted(m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.'))\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
            "print(bad)\n"
            "print(names)\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    bad, names = out.stdout.strip().splitlines()
    assert bad == "[]"
    # control: the walk reached the LM half and the sharded path
    for mod in ("repro_torch.models.transformer", "repro_torch.launch.dryrun",
                "repro_torch.launch.cost", "repro_torch.launch.specs",
                "repro_torch.launch.mesh", "repro_torch.launch.train",
                "repro_torch.optim.compress", "repro_torch.data.pipeline",
                "repro_torch.distributed.sharding", "repro_torch.core.api",
                "repro_torch.serve", "repro_torch.tune"):
        assert repr(mod) in names, mod
