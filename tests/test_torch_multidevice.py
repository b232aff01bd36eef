"""The port's multi-device executor on the CPU, against the reference.

``MultiDeviceTorchExecutor`` runs each logical device's stream on its own
slot buffer and host slab; here every logical device is a CPU handle and
the kernels take their plain versions.  It is held against the port's
NumPy replay (bitwise the reference's ``run_multidevice_numpy``) within the
reference's cross-backend tolerances (``tests/test_backend_equivalence.py``:
< 1e-13 for f64 plans, < 1e-8 for MxP plans), against LAPACK (< 1e-10),
and against the reference's ``MultiDeviceJaxExecutor`` itself on forced
host-platform devices in a subprocess, transfer counters dict for dict.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import repro
from repro.core import cholesky as ref_chol
from repro.core.tiling import from_tiles, random_spd, to_tiles

import repro_torch
from repro_torch.core import api
from repro_torch.core import cholesky as chol
from repro_torch.core.schedule import OpKind
from repro_torch.kernels import _build, ops

N, TB = 128, 16                     # nt = 8
LADDERS = ("tpu", "gpu", "gpu-scaled", "tpu-scaled")
# (ndev, grid, lookahead)
LAYOUTS = [(2, None, 0), (2, None, 1), (4, None, 0), (4, None, 2),
           (4, (2, 2), 0), (4, (2, 2), 1), (4, (2, 2), 2)]
F64_TOL, MXP_TOL, LAPACK_TOL, FUSED_TOL = 1e-13, 1e-8, 1e-10, 1e-12


def _layout_id(layout):
    ndev, grid, look = layout
    return f"ndev{ndev}-{'x'.join(map(str, grid or (ndev, 1)))}-L{look}"


def _kms(n, rho=0.7):
    """Kac-Murdock-Szego matrix rho^|i-j|: an eps_target plan on it mixes
    the ladder's classes (at n = 128, tb = 16 on ``gpu-scaled``: 8 f64, 7
    f32, 6 f16 and 15 scaled-FP8 tiles)."""
    idx = np.arange(n)
    return rho ** np.abs(idx[:, None] - idx[None, :])


def _solver(a, **kw):
    cfg = repro_torch.CholeskyConfig(tb=TB, **kw)
    if cfg.eps_target is not None:
        cfg = cfg.specialize(a)
    return repro_torch.plan(a.shape[0], cfg).compile(device="cpu")


def _replay(a, solver):
    return np.tril(from_tiles(chol.run_multidevice_numpy(
        to_tiles(a, TB), solver.schedule)))


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_id)
@pytest.mark.parametrize("policy", ["sync", "v1", "v2", "v3"])
def test_f64_matches_numpy_replay_and_lapack(policy, layout, fuse):
    ndev, grid, look = layout
    a = random_spd(N, seed=11)
    s = _solver(a, policy=policy, ndev=ndev, grid=grid, lookahead=look,
                fuse_columns=fuse)
    l = s.factor(a)
    assert np.abs(l - _replay(a, s)).max() < F64_TOL
    assert np.abs(l - np.linalg.cholesky(a)).max() < LAPACK_TOL
    cc = repro_torch.crosscheck_executed_volume(
        s.schedule, s.transfer_stats(), hw=repro_torch.HW["gh200"])
    assert cc["match"], cc["mismatches"]


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("layout", [(2, None, 0), (4, None, 1),
                                    (4, (2, 2), 2)], ids=_layout_id)
@pytest.mark.parametrize("ladder", LADDERS)
def test_mxp_matches_numpy_replay(ladder, layout, fuse):
    ndev, grid, look = layout
    a = _kms(N)
    s = _solver(a, policy="v3", ndev=ndev, grid=grid, lookahead=look,
                ladder=ladder, eps_target=1e-6, fuse_columns=fuse)
    assert sum(v > 0 for v in s.config.plan.histogram().values()) >= 3
    l = s.factor(a)
    assert np.abs(l - _replay(a, s)).max() < MXP_TOL
    cc = repro_torch.crosscheck_executed_volume(s.schedule,
                                                s.transfer_stats())
    assert cc["match"], cc["mismatches"]
    # class-precision wires: MxP moves fewer bytes than uniform f64
    f64 = repro_torch.build_multidevice_schedule(
        N // TB, TB, ndev, "v3", grid=grid, lookahead=look)
    assert s.transfer_stats()["recv_bytes"] < f64.bcast_bytes()


def _chip_smoke():
    """``chip_smoke.py`` at the root of the checkout, as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_tile_ops(monkeypatch):
    """The stock f64 tile ops computed by NumPy/SciPy, as the replay
    computes them: the executor then differs from the replay only in what
    it moves (slabs, slots, wires), not in the BLAS's summation order."""
    t = torch.from_numpy
    monkeypatch.setitem(ops.STOCK, "gemm", lambda c, x, y: t(
        c.numpy() - x.numpy() @ y.numpy().T))
    monkeypatch.setitem(ops.STOCK, "syrk", lambda c, x: t(
        c.numpy() - x.numpy() @ x.numpy().T))
    monkeypatch.setitem(ops.STOCK, "potrf", lambda c: t(np.linalg.cholesky(
        0.5 * (c.numpy() + c.numpy().T))))
    monkeypatch.setitem(ops.STOCK, "trsm", lambda l, c: t(
        sla.solve_triangular(l.numpy(), c.numpy().T, lower=True).T.copy()))


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_id)
@pytest.mark.parametrize("policy", ["sync", "v3"])
def test_bitwise_the_replay_with_its_tile_ops(monkeypatch, policy, layout):
    """With the replay's own tile arithmetic, the executor's factor of an
    MxP plan (scaled FP8 wires) is the replay's, bitwise."""
    _numpy_tile_ops(monkeypatch)
    ndev, grid, look = layout
    a = _kms(N)
    s = _solver(a, policy=policy, ndev=ndev, grid=grid, lookahead=look,
                ladder="gpu-scaled", eps_target=1e-6)
    assert s.config.plan.histogram()["f8e4m3s"] > 0
    s.factor(a, materialize=False)
    want = chol.run_multidevice_numpy(to_tiles(a, TB), s.schedule)
    assert np.array_equal(np.tril(from_tiles(s.tiles.numpy())),
                          np.tril(from_tiles(want)))


def test_lookahead_rounding_flip_is_the_blas_order(monkeypatch):
    """At n = 2560, tb = 128, lookahead 1, a partial accumulator's f32
    STORE rounds the other way from the replay's where PyTorch's and
    NumPy's f64 GEMMs differ in the last bit: max|L - L_replay| reaches
    ~2e-7, above the reference's 1e-8 cross-backend tolerance (which the
    card's check requires: the card has shown no such flip).  With the
    replay's own tile ops the factor is the replay's, bitwise."""
    n, tb = 2560, 128
    a = _kms(n, rho=0.99)
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu-scaled", eps_target=1e-6, ndev=4,
        lookahead=1).specialize(a)
    s = repro_torch.plan(n, cfg).compile(device="cpu")
    want = np.tril(from_tiles(chol.run_multidevice_numpy(to_tiles(a, tb),
                                                         s.schedule)))
    l_torch = s.factor(a)
    assert np.abs(l_torch - want).max() > 1e-8      # the f32 flip
    _numpy_tile_ops(monkeypatch)
    assert np.array_equal(s.factor(a), want)


# wires below their class, swapped in as chip_smoke.py's controls swap
# them: (KMS rho, the swapped wire); at rho = 0.7 the plan mixes every
# class, at 0.99 it is f64 and f32 only
WIRE_CONTROLS = {
    "e4m3": (0.7, lambda make, tile, cls: make(tile, "f8e4m3")),
    "f64-as-f32": (0.99, lambda make, tile, cls: make(
        tile, "f32" if cls == "f64" else cls)),
}


@pytest.mark.parametrize("control", list(WIRE_CONTROLS))
def test_replay_check_rejects_wires_below_their_class(monkeypatch, control):
    """The 1e-8 check against the NumPy replay, chip_smoke.py's for config
    B (a (2, 2) grid at lookahead 1 on ``gpu-scaled``), passes the port
    and rejects each control."""
    rho, swap = WIRE_CONTROLS[control]
    a = _kms(N, rho)
    s = _solver(a, policy="v3", ndev=4, grid=(2, 2), lookahead=1,
                ladder="gpu-scaled", eps_target=1e-6)
    want = _replay(a, s)
    assert np.abs(s.factor(a) - want).max() < MXP_TOL
    make = chol._make_wire
    monkeypatch.setattr(chol, "_make_wire",
                        lambda tile, cls: swap(make, tile, cls))
    assert not np.abs(s.factor(a) - want).max() < MXP_TOL


# --------------------------------------------------------------------------
# against the reference's MultiDeviceJaxExecutor, on forced host devices
# --------------------------------------------------------------------------

# name -> (matrix, config fields): one 1D, one (2, 2) at L = 1, one MxP
# (scaled FP8 wires on a 2D grid at L = 2) and two fused cases
REF_CASES = {
    "1d": ("spd", dict(policy="v3", ndev=4)),
    "2x2-L1": ("spd", dict(policy="v3", ndev=4, grid=(2, 2), lookahead=1)),
    "mxp": ("kms", dict(policy="v2", ndev=4, grid=(2, 2), lookahead=2,
                        ladder="gpu-scaled", eps_target=1e-6)),
    "fused": ("spd", dict(policy="v3", ndev=4, lookahead=1,
                          fuse_columns=True)),
    "fused-mxp-2x2": ("kms", dict(policy="v3", ndev=4, grid=(2, 2),
                                  lookahead=1, ladder="gpu-scaled",
                                  eps_target=1e-6, fuse_columns=True)),
}
REF_TOL = {"1d": F64_TOL, "2x2-L1": F64_TOL, "mxp": MXP_TOL,
           "fused": FUSED_TOL, "fused-mxp-2x2": MXP_TOL}

_REF_SCRIPT = """
    import dataclasses, json, sys
    import numpy as np, jax
    jax.config.update('jax_enable_x64', True)
    import repro
    from repro.kernels import fused_column as jfused
    cases, out = json.loads(sys.argv[1]), sys.argv[2]
    res = {}
    for name, (path, kw) in cases.items():
        a = np.load(path)
        if kw.get('grid'):
            kw['grid'] = tuple(kw['grid'])
        cfg = repro.CholeskyConfig(tb=%d, backend='jax', **kw)
        cfg = cfg.specialize(a)
        solver = repro.plan(a.shape[0], cfg).compile()
        jfused.reset_launch_counts()
        l = solver.factor(a)
        launches = jfused.launch_counts()
        np.save(f'{out}/{name}.npy', l)
        res[name] = {'transfers': solver.transfer_stats(),
                     'launches': launches,
                     'plan': dataclasses.asdict(cfg)['plan']}
    print(json.dumps(res, default=lambda o: o.tolist()))
""" % TB


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Each REF_CASES case through the reference's multi-device executor
    in one subprocess with four forced host-platform devices."""
    tmp = tmp_path_factory.mktemp("ref_multidevice")
    mats = {"spd": random_spd(N, seed=23), "kms": _kms(N)}
    cases = {}
    for name, (mat, kw) in REF_CASES.items():
        path = str(tmp / f"{mat}.npy")
        np.save(path, mats[mat])
        cases[name] = (path, kw)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    env.update({k: v for k, v in os.environ.items()
                if k not in env and k != "XLA_FLAGS"})
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF_SCRIPT),
         json.dumps(cases), str(tmp)], capture_output=True, text=True,
        timeout=900, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in res:
        res[name]["factor"] = np.load(tmp / f"{name}.npy")
        res[name]["a"] = mats[REF_CASES[name][0]]
    return res


@pytest.mark.parametrize("name", list(REF_CASES))
def test_matches_reference_multidevice_executor(reference_runs, name):
    ref = reference_runs[name]
    kw = dict(REF_CASES[name][1], tb=TB, backend="jax",
              plan=ref["plan"], eps_target=None)
    cfg = repro_torch.config_from_reference(kw)
    a = ref["a"]
    s = repro_torch.plan(N, cfg).compile(device="cpu")
    ops.reset_counts()
    l = s.factor(a)
    calls = ops.call_counts()
    if REF_CASES[name][0] == "kms":
        assert cfg.plan.histogram()["f8e4m3s"] > 0
    assert np.abs(l - ref["factor"]).max() < REF_TOL[name]
    assert s.transfer_stats() == ref["transfers"]
    if cfg.fuse_columns:
        # the port's grouping never launches more than the reference's
        fused = calls["fused_column_step"]
        assert 0 < fused <= ref["launches"]["fused_column"]
        per_op = sum(v for k, v in calls.items() if k != "fused_column_step")
        assert per_op <= ref["launches"]["tile_op"]
        # chip_smoke.py's model of the reference's grouping, which the card
        # holds the fused launches to, gives the reference's own counts
        model = _chip_smoke().reference_fused_groups(
            s._executor.multidevice._segments)
        assert model == ref["launches"]


# --------------------------------------------------------------------------
# wires
# --------------------------------------------------------------------------

def _wires(x, cls, dtype):
    """(payload as f64, scale, unwired tile) of the port's wire and of
    the reference's, for the numpy tile ``x``."""
    rp, rs = ref_chol._make_wire(jnp.asarray(x), cls, jnp.dtype(dtype))
    rback = np.asarray(ref_chol._unwire((rp, rs), jnp.dtype(dtype)))
    payload, scale = chol._make_wire(torch.from_numpy(x), cls)
    back = chol._unwire((payload, scale), getattr(torch, dtype))
    assert payload.dtype == chol._wire_dtype(cls)
    assert payload.element_size() == np.asarray(rp).dtype.itemsize
    assert (scale is None) == (rs is None)
    return ((payload.to(torch.float64).numpy(),
             None if scale is None else float(scale), back.numpy()),
            (np.asarray(rp).astype(np.float64),
             None if rs is None else float(rs), rback))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cls", ["f64", "f32", "f16", "bf16", "f8e4m3"])
def test_wire_round_trip_matches_reference(cls, dtype):
    """The payload and the unwired tile, bitwise the reference's, for a
    tile whose values span the classes' ranges: e4m3 overflow (> 464)
    gives NaN, as the reference's cast does."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((TB, TB)) * np.exp2(rng.integers(-30, 12,
                                                             (TB, TB)))
    x[0, :4] = [500.0, -470.0, 464.0, 448.5]
    got, want = _wires(x.astype(dtype), cls, dtype)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if cls == "f8e4m3":
        assert np.isnan(got[2][0, :2]).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scaled_fp8_wire_matches_reference(dtype):
    """Bitwise wherever the reference's scale is the exact power of two;
    where its ``exp2`` is off (ROADMAP queue 3 item 3: an ulp in f64, a
    few in f32) the scales agree within 16 ulps of the compute dtype and
    the tiles within one e4m3 quantum, 32 at the top of e4m3's band, over
    the scale."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal((TB, TB))
    exact = 0
    for e in range(-12, 13):
        x = (base / np.abs(base).max() * 1.3 * 2.0 ** e).astype(dtype)
        (p, s, back), (rp, rs, rback) = _wires(x, "f8e4m3s", dtype)
        if s == rs:
            exact += 1
            np.testing.assert_array_equal(p, rp)
            np.testing.assert_array_equal(back, rback)
        else:
            assert abs(rs / s - 1) < 16 * np.finfo(dtype).eps
            assert np.abs(back - rback).max() <= 32 / s * (1 + 1e-6)
    assert exact > 0


def test_wire_is_a_copy():
    """A wire must not alias the tile it was cut from."""
    tile = torch.ones(TB, TB, dtype=torch.float64)
    for cls in ("f64", "f32", "f8e4m3s"):
        payload, _ = chol._make_wire(tile, cls)
        tile.add_(1.0)
        assert float(payload.double().max()) != float(tile.max())


# --------------------------------------------------------------------------
# executor properties
# --------------------------------------------------------------------------

# nt = 8, tb = 16: BCASTs and host-landing RECVs
PROBE = [("v3", 4, (4, 1), 0, 36, 0), ("v3", 4, (2, 2), 1, 64, 28),
         ("v2", 4, (2, 2), 2, 64, 28), ("sync", 2, (2, 1), 0, 36, 0)]


@pytest.mark.parametrize("policy,ndev,grid,look,bcasts,landing", PROBE,
                         ids=lambda v: str(v))
def test_wire_sources_and_executed_transfers(policy, ndev, grid, look,
                                             bcasts, landing):
    """Every wire is cut from the sender's slab, as the reference cuts it:
    one H2D a BCAST, counted apart from the LOADs."""
    a = random_spd(N, seed=2)
    s = _solver(a, policy=policy, ndev=ndev, grid=grid, lookahead=look)
    sched = s.schedule
    assert sched.count(OpKind.BCAST) == bcasts
    assert sum(1 for st in sched.streams for o in st
               if o.kind is OpKind.RECV and o.slot_c < 0) == landing
    s.factor(a)
    io = s.stats["transfers"]
    tile = TB * TB * 8
    # LOAD/STORE copies summed over the devices equal the schedule's; the
    # wires cut from a slab and the host-landing RECVs count apart
    assert io["executed_h2d_ops"] == sched.count(OpKind.LOAD)
    assert io["executed_d2h_ops"] == sched.count(OpKind.STORE)
    assert io["executed_h2d_bytes"] == io["executed_h2d_ops"] * tile
    assert io["executed_d2h_bytes"] == io["executed_d2h_ops"] * tile
    assert io["executed_wire_h2d_ops"] == bcasts
    assert io["executed_wire_h2d_bytes"] == bcasts * tile
    assert io["executed_recv_d2h_ops"] == landing
    assert io["executed_recv_d2h_bytes"] == landing * tile
    for k, v in s.transfer_stats().items():
        assert io["executed_" + k] == v


def test_2d_grid_replica_slabs_are_kept_across_factors():
    """A (2, 2) grid's second grid-row peers get their slab replicas at the
    first factor and reuse them; a second factor of another matrix is
    right."""
    s = _solver(random_spd(N, seed=3), ndev=4, grid=(2, 2), lookahead=1)
    ex = s._executor.multidevice
    s.factor(random_spd(N, seed=3))
    kept = dict(ex._replicas)
    assert sorted(kept) == [1, 3]
    a = random_spd(N, seed=4)
    l = s.factor(a)
    assert all(ex._replicas[d] is kept[d] for d in kept)
    assert np.abs(l - np.linalg.cholesky(a)).max() < LAPACK_TOL


def test_fused_launches_at_most_one_per_segment_group():
    """Each segment's column groups launch the fused step at most once."""
    a = random_spd(N, seed=4)
    s = _solver(a, policy="v3", ndev=4, lookahead=1, fuse_columns=True)
    groups = {(i, o.k) for i, (_d, _r, body, _b)
              in enumerate(s._executor.multidevice._segments)
              for o in body if o.kind in chol._FUSABLE}
    ops.reset_counts()
    s.factor(a)
    assert 0 < ops.call_counts()["fused_column_step"] <= len(groups)


def test_solve_logdet_on_a_multidevice_factor():
    a = random_spd(N, seed=5)
    s = _solver(a, policy="v3", ndev=4, grid=(2, 2), lookahead=1)
    assert s.factor(a, materialize=False) is None
    b = np.linspace(0, 1, N)
    ref = np.linalg.cholesky(a)
    assert np.abs(s.solve(b) - sla.cho_solve((ref, True), b)).max() < 1e-10
    assert np.abs(s.solve_lower(b)
                  - sla.solve_triangular(ref, b, lower=True)).max() < 1e-10
    assert abs(s.logdet() - 2 * np.log(np.diag(ref)).sum()) < 1e-9


def test_repeated_factor_is_bitwise_and_builds_once():
    a = _kms(N)
    s = _solver(a, policy="v3", ndev=4, grid=(2, 2), lookahead=1,
                ladder="gpu-scaled", eps_target=1e-6)
    l1 = s.factor(a)
    t1 = s.transfer_stats()
    l2 = s.factor(a)
    assert np.array_equal(l1, l2)
    assert s.transfer_stats() == t1
    assert s.stats["executor_builds"] == 1
    assert s._executor.devices == (torch.device("cpu"),) * 4


def test_transfer_stats_none_off_the_multidevice_executor():
    a = random_spd(N, seed=6)
    one = _solver(a, policy="v3")
    one.factor(a)
    assert one.transfer_stats() is None
    replay = repro_torch.plan(N, repro_torch.CholeskyConfig(
        tb=TB, ndev=4, backend="numpy")).compile()
    replay.factor(a)
    assert replay.transfer_stats() is None
    multi = _solver(a, policy="v3", ndev=2)
    assert multi.transfer_stats() is None           # before a factor


def test_devices_resolve(monkeypatch):
    p = repro_torch.plan(N, repro_torch.CholeskyConfig(tb=TB, ndev=4))
    assert p.compile(device=["cpu"] * 4)._executor.devices == \
        (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        p.compile(device=["cpu"] * 3)
    with pytest.raises(ValueError, match="sequence of 4"):
        p.compile(device="cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.compile()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices, found 1"):
        api.logical_devices("cuda", 4)
    with pytest.raises(ValueError, match="all be CUDA or all CPU"):
        api.logical_devices(["cpu", "cuda:0"], 2)
    # 'auto' stays the torch backend: no quiet fall-back to the replay
    assert p.config.resolved_backend() == "torch"


def test_multidevice_disk_tier_still_raises():
    """Multi-device spill schedules run on the NumPy replay only (as the
    reference's), and the torch backend names it rather than resolving to
    it quietly; the executor itself refuses a spill schedule."""
    with pytest.raises(ValueError, match="backend='numpy'"):
        repro_torch.CholeskyConfig(tb=TB, ndev=4, host_slots=4)
    assert repro_torch.CholeskyConfig(
        tb=TB, ndev=4, host_slots=4, backend="numpy").host_slots == 4
    msched = repro_torch.build_multidevice_schedule(4, TB, 4, "v3",
                                                    host_slots=4)
    with pytest.raises(ValueError, match="NumPy replay"):
        chol.MultiDeviceTorchExecutor(msched, devices="cpu")


def test_config_from_reference_carries_the_layout():
    ref_cfg = repro.CholeskyConfig(tb=TB, ndev=4, grid=(2, 2), lookahead=2,
                                   policy="v2")
    cfg = repro_torch.config_from_reference(dataclasses.asdict(ref_cfg))
    assert (cfg.ndev, cfg.grid, cfg.lookahead) == (4, (2, 2), 2)
    assert repro_torch.plan(N, cfg).schedule.digest() == \
        repro.plan(N, ref_cfg).schedule.digest()


class _CudaStandIn:
    """What ``_build.require_current`` reads of a tensor, for a card that is not
    here: its device and its contiguity."""

    def __init__(self, index):
        self.device = torch.device("cuda", index)

    def is_contiguous(self):
        return True


def test_kernels_refuse_operands_off_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    _build.require_current("potrf", _CudaStandIn(1))
    with pytest.raises(ValueError, match="current CUDA device is cuda:1"):
        _build.require_current("potrf", _CudaStandIn(0))
