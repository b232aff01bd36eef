"""The port's NumPy replays and ``backend="numpy"`` against the reference's.

The replays are the reference's NumPy oracles with the port's class round
(``kernels/ref.py::_round``, bitwise the reference's ``_np_round``), so
every factor here is compared bitwise: for f64 and MxP plans, one device
and several, through the functions and through ``plan().compile()``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
from repro.core import cholesky as ref_chol
from repro.core import precision as ref_precision
from repro.core import schedule as ref_schedule
from repro.core.tiling import from_tiles, to_tiles
from repro.geo.matern import BETA_WEAK, generate_locations, matern_covariance

import repro_torch
from repro_torch.core import cholesky as chol
from repro_torch.core import precision, schedule

POLICIES = ("sync", "async", "v1", "v2", "v3", "v4")
LADDERS = ("tpu", "gpu", "gpu-scaled", "tpu-scaled")
N, TB = 256, 32
# (ndev, grid, lookahead) of the multi-device cases
MULTI = [(2, None, 0), (2, None, 1), (2, None, 2), (4, None, 0),
         (4, None, 1), (4, None, 2), (4, (2, 2), 0), (4, (2, 2), 1),
         (4, (2, 2), 2)]


def _matern():
    """A weakly correlated Matérn covariance: an eps_target plan on it
    mixes three or more classes, unscaled e4m3 among them on ``gpu``."""
    return matern_covariance(generate_locations(N, seed=0), beta=BETA_WEAK)


def _plans(ladder):
    """The reference's plan of the Matérn matrix, and the port's copy."""
    a = _matern()
    if ladder is None:
        return a, ref_precision.uniform_plan(N // TB, "f64"), \
            precision.uniform_plan(N // TB, "f64")
    rp = ref_chol.plan_for_matrix(to_tiles(a, TB), 1e-6, ladder)
    assert sum(v > 0 for v in rp.histogram().values()) >= 3, rp.histogram()
    return a, rp, precision.PrecisionPlan(rp.classes.copy(), rp.ladder,
                                          rp.eps_target)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("ladder", (None,) + LADDERS,
                         ids=("f64",) + LADDERS)
@pytest.mark.parametrize("policy", POLICIES)
def test_run_schedule_numpy_bitwise(policy, ladder):
    a, rp, pp = _plans(ladder)
    kw = dict(block=(2, 2)) if policy == "v4" else {}
    nt = N // TB
    want = ref_chol.run_schedule_numpy(
        to_tiles(a, TB), ref_schedule.build_schedule(nt, TB, policy, plan=rp,
                                                     **kw))
    got = chol.run_schedule_numpy(
        to_tiles(a, TB), schedule.build_schedule(nt, TB, policy, plan=pp,
                                                 **kw))
    _same(got, want)


@pytest.mark.parametrize("ladder", [None, "gpu"], ids=["f64", "gpu"])
@pytest.mark.parametrize("ndev,grid,lookahead", MULTI)
def test_run_multidevice_numpy_bitwise(ndev, grid, lookahead, ladder):
    a, rp, pp = _plans(ladder)
    nt = N // TB
    kw = dict(grid=grid, lookahead=lookahead)
    want = ref_chol.run_multidevice_numpy(
        to_tiles(a, TB), ref_schedule.build_multidevice_schedule(
            nt, TB, ndev, "v3", plan=rp, **kw))
    got = chol.run_multidevice_numpy(
        to_tiles(a, TB), schedule.build_multidevice_schedule(
            nt, TB, ndev, "v3", plan=pp, **kw))
    _same(got, want)


class _Recorder:
    """A duck-typed trace recorder: a counter for a clock, spans kept."""

    active = True

    def __init__(self):
        self.t, self.spans = 0, []

    def now(self):
        self.t += 1
        return self.t

    def record(self, *span):
        self.spans.append(span)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_traced_replay_records_one_span_per_op(multi):
    a, rp, pp = _plans("gpu")
    nt = N // TB
    if multi:
        rs = ref_schedule.build_multidevice_schedule(nt, TB, 4, "v3", plan=rp,
                                                     grid=(2, 2), lookahead=1)
        ps = schedule.build_multidevice_schedule(nt, TB, 4, "v3", plan=pp,
                                                 grid=(2, 2), lookahead=1)
        ref_run, run = (ref_chol.run_multidevice_numpy,
                        chol.run_multidevice_numpy)
        nops = sum(len(s) for s in ps.streams)
    else:
        rs = ref_schedule.build_schedule(nt, TB, "v3", plan=rp)
        ps = schedule.build_schedule(nt, TB, "v3", plan=pp)
        ref_run, run = ref_chol.run_schedule_numpy, chol.run_schedule_numpy
        nops = len(ps.ops)
    rrec, prec = _Recorder(), _Recorder()
    want = ref_run(to_tiles(a, TB), rs, trace=rrec)
    got = run(to_tiles(a, TB), ps, trace=prec)
    _same(got, want)
    assert len(prec.spans) == nops
    assert prec.spans == rrec.spans
    _same(run(to_tiles(a, TB), ps, trace=None), want)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_spill_schedules_raise_item_7(multi):
    """Item 7, the disk tier, is ported: the replays take spill schedules
    through a bounded host tier, bitwise the reference's replays and the
    port's own host-resident replay, and ``backend="numpy"`` plans them."""
    nt = N // TB
    tiles = to_tiles(_matern(), TB)
    if multi:
        s = schedule.build_multidevice_schedule(nt, TB, 2, "v3", host_slots=6)
        rs = ref_schedule.build_multidevice_schedule(nt, TB, 2, "v3",
                                                     host_slots=6)
        plain = schedule.build_multidevice_schedule(nt, TB, 2, "v3")
        run, ref_run = chol.run_multidevice_numpy, \
            ref_chol.run_multidevice_numpy
    else:
        s = schedule.build_schedule(nt, TB, "v3", host_slots=6)
        rs = ref_schedule.build_schedule(nt, TB, "v3", host_slots=6)
        plain = schedule.build_schedule(nt, TB, "v3")
        run, ref_run = chol.run_schedule_numpy, ref_chol.run_schedule_numpy
    got = run(tiles, s)
    _same(got, ref_run(tiles, rs))
    _same(got, run(tiles, plain))
    cfg = repro_torch.CholeskyConfig(tb=TB, backend="numpy", host_slots=6,
                                     ndev=2 if multi else 1)
    _same(np.tril(from_tiles(got)),
          repro_torch.plan(N, cfg).compile().factor(_matern()))


def _api_pair(a, **kw):
    """The reference's numpy-backend solver and the port's, factored."""
    ref_cfg = repro.CholeskyConfig(tb=TB, backend="numpy", **kw)
    cfg = repro_torch.config_from_reference(dataclasses.asdict(ref_cfg))
    if ref_cfg.plan is None and "eps_target" in kw:
        ref_cfg = ref_cfg.specialize(a)
        cfg = cfg.specialize(a)
    ref = repro.plan(N, ref_cfg).compile()
    port = repro_torch.plan(N, cfg).compile()
    return ref, ref.factor(a), port, port.factor(a)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(eps_target=1e-6, ladder="gpu"),
    dict(policy="v4", block=(2, 2), eps_target=1e-6, ladder="gpu-scaled"),
    dict(ndev=2),
    dict(ndev=2, lookahead=2, eps_target=1e-6, ladder="gpu"),
    dict(ndev=4, grid=(2, 2), lookahead=1, eps_target=1e-6, ladder="tpu"),
    dict(ndev=4, grid=(4, 1), lookahead=0, policy="sync"),
], ids=["f64", "mxp", "v4", "ndev2", "ndev2,L2", "grid2x2,L1", "grid4x1"])
def test_numpy_backend_through_the_api(kw):
    a = _matern()
    ref, lr, port, lp = _api_pair(a, **kw)
    _same(lp, lr)
    assert port.config.resolved_backend() == "numpy"
    assert port.device.type == "cpu"
    assert port.stats["executor_builds"] == 0
    assert port.stats["transfers"] == ref.stats["transfers"]
    assert port.schedule.digest() == ref.schedule.digest()
    rng = np.random.default_rng(1)
    for b in (rng.standard_normal(N), rng.standard_normal((N, 3))):
        for f in ("solve", "solve_lower"):
            x, xr = getattr(port, f)(b), getattr(ref, f)(b)
            assert np.abs(x - xr).max() <= 1e-13 * np.abs(xr).max()
    assert abs(port.logdet() - ref.logdet()) <= 1e-13 * abs(ref.logdet())
    assert port.factor(torch.from_numpy(a), materialize=False) is None
    _same(np.tril(from_tiles(port.tiles.numpy())), lr)


def test_numpy_backend_needs_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = repro_torch.plan(N, tb=TB, backend="numpy")
    assert p.compile().device.type == "cpu"
    with pytest.raises(ValueError, match="numpy"):
        p.compile(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.plan(N, tb=TB).compile()


@pytest.mark.parametrize("field,ref_value,value", [
    ("use_pallas", True, True),
    ("fuse_columns", True, True),
    ("compute_dtype", np.float32, torch.float32),
])
def test_torch_only_options_on_numpy_raise_as_reference(field, ref_value,
                                                        value):
    with pytest.raises(ValueError) as want:
        repro.CholeskyConfig(tb=TB, backend="numpy", **{field: ref_value})
    with pytest.raises(ValueError, match="'torch'") as got:
        repro_torch.CholeskyConfig(tb=TB, backend="numpy", **{field: value})
    assert type(got.value) is type(want.value)


@pytest.mark.parametrize("kw", [
    dict(hw="h100-pcie"), dict(hw="tpu-v5e", cache_slots=8),
    dict(hw="gh200", ndev=2, backend="numpy"),
])
def test_hw_presets_accepted(kw):
    cfg = repro_torch.CholeskyConfig(tb=TB, **kw)
    assert cfg.hw == repro.CholeskyConfig(tb=TB, **kw).hw


@pytest.mark.parametrize("kw", [
    dict(hw="no-such-card"),
    # 4096 slots of 4096^2 8-byte tiles: 550 GB against the preset's 16 GB
    dict(hw="tpu-v5e", tb=4096, cache_slots=4096),
    dict(hw="h100-pcie", tb=4096, cache_slots=1000),
], ids=["unknown", "tpu-v5e memory", "h100-pcie memory"])
def test_hw_errors_match_reference(kw):
    kw = {"tb": TB, **kw}
    with pytest.raises(ValueError) as want:
        repro.CholeskyConfig(**kw)
    with pytest.raises(ValueError) as got:
        repro_torch.CholeskyConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("kw", [
    dict(ndev=2), dict(ndev=4, grid=(2, 2)), dict(ndev=2, lookahead=1),
], ids=["ndev", "grid", "lookahead"])
def test_multidevice_on_torch_raises_item_6(kw, backend):
    """Item 6, the multi-device executor, is ported: these layouts plan on
    the torch backend.  With the disk tier (item 7, ported) they run on the
    NumPy replay only, and ``auto`` names that backend instead of resolving
    to it quietly; with lookahead the disk tier is refused, as the
    reference refuses it."""
    assert repro_torch.CholeskyConfig(
        tb=TB, backend=backend, **kw).resolved_backend() == "torch"
    match = "lookahead" if "lookahead" in kw else "backend='numpy'"
    with pytest.raises(ValueError, match=match):
        repro_torch.CholeskyConfig(tb=TB, backend=backend, host_slots=4,
                                   **kw)


@pytest.mark.parametrize("kw", [
    dict(ndev=3, grid=(2, 2)), dict(ndev=2, grid=(2,)),
    dict(lookahead=1), dict(ndev=2, lookahead=-1),
    dict(ndev=2, policy="v4", block=(2, 2)), dict(ndev=2, policy="async"),
], ids=["grid product", "grid shape", "lookahead ndev1", "lookahead < 0",
        "v4", "async"])
def test_multidevice_config_errors_match_reference(kw):
    kw = {"tb": TB, "backend": "numpy", **kw}
    with pytest.raises(ValueError) as want:
        repro.CholeskyConfig(**kw)
    with pytest.raises(ValueError) as got:
        repro_torch.CholeskyConfig(**kw)
    assert type(got.value) is type(want.value)


def test_resolved_backend():
    assert repro_torch.CholeskyConfig(tb=TB).resolved_backend() == "torch"
    assert repro_torch.CholeskyConfig(
        tb=TB, backend="torch").resolved_backend() == "torch"
    assert repro_torch.CholeskyConfig(
        tb=TB, backend="numpy", ndev=2).resolved_backend() == "numpy"


def test_canonical_grid_and_lookahead_share_one_plan():
    base = repro_torch.plan(N, tb=TB, ndev=2, backend="numpy")
    assert repro_torch.plan(N, tb=TB, ndev=2, backend="numpy",
                            grid=(2, 1)) is base
    assert repro_torch.plan(N, tb=TB, ndev=2, backend="numpy",
                            lookahead=0) is base
    ref = repro.plan(N, tb=TB, ndev=2, backend="numpy")
    assert base.schedule.digest() == ref.schedule.digest()
