"""The port's fused column step against the reference's, on the CPU.

On CPU tensors ``fused_column_step`` runs its plain version; it is held
against the reference's Pallas kernel in interpret mode (as
``tests/test_kernel_numerics.py`` runs it), and the port's fused executor
against the reference's ``make_jax_executor(sched, fuse_columns=True)``,
on inputs made with numpy from a seed.  The CUDA kernel is held against
the plain version on the card in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro
from repro.core import api as ref_api
from repro.core.cholesky import make_jax_executor
from repro.core.precision import EPS, LADDERS
from repro.core.schedule import build_schedule as ref_build_schedule
from repro.core.tiling import from_tiles, random_spd, to_tiles
from repro.kernels import fused_column as jfused

import repro_torch
from repro_torch.core.cholesky import (_device_nslots, _make_kernel_fns,
                                       _run_ops_fused, make_torch_executor)
from repro_torch.core.schedule import OpKind, build_schedule, min_cache_slots
from repro_torch.kernels import fused_column as tfused
from repro_torch.kernels import ops

CLASSES = ("f64", "f32", "bf16", "f8e4m3", "f8e4m3s")
ALL_CLASSES = sorted({c for lad in LADDERS.values() for c in lad})
POLICIES = ("sync", "async", "v1", "v2", "v3", "v4")


def _ladder_for(cls_name):
    return next(lad for lad in LADDERS.values() if cls_name in lad)


def _tol(cls_name):
    # the reference's own bound (tests/test_kernel_numerics.py::_tol): one
    # accumulation-order ulp may move a value across a class quantum
    return max(1e-12, 4.0 * EPS[cls_name])


def _column_inputs(rng, r_tiles, k_hist, tb, with_diag):
    """Column-step operands shaped like the executor's group (the
    reference harness's ``_column_inputs``), as numpy f64."""
    spd = np.eye(tb) * (2.0 * tb)
    g = rng.standard_normal((tb, tb))
    spd += g @ g.T / tb
    rows = [spd if with_diag else rng.standard_normal((tb, tb))]
    rows += [rng.standard_normal((tb, tb)) for _ in range(r_tiles - 1)]
    c_stack = np.stack(rows)
    hist = rng.standard_normal((r_tiles, k_hist, tb, tb)) / tb
    bhist = hist[0].copy() if with_diag else \
        rng.standard_normal((k_hist, tb, tb)) / tb
    return c_stack, hist, bhist, np.linalg.cholesky(spd)


def _both(cls_name, tb, r_tiles, k_hist, with_diag, seed, dtype=np.float64):
    """The reference kernel's and the port's plain version's result on the
    same inputs, as numpy f64."""
    ladder = _ladder_for(cls_name)
    args = [x.astype(dtype) for x in _column_inputs(
        np.random.default_rng(seed), r_tiles, k_hist, tb, with_diag)]
    cls_ids = [ladder.index(cls_name)] * r_tiles
    want = jfused.fused_column_step(
        *[jnp.asarray(x) for x in args], jnp.asarray(cls_ids, jnp.int32),
        ladder=ladder, with_diag=with_diag)
    got = tfused.fused_column_step(
        *[torch.from_numpy(x.copy()) for x in args], cls_ids, ladder=ladder,
        with_diag=with_diag)
    assert got.dtype == {np.float64: torch.float64,
                         np.float32: torch.float32}[dtype]
    return got.double().numpy(), np.asarray(want, np.float64)


def _row_ratio(got, want, tol):
    """The worst row's max error over ``tol`` times that row's own
    max|want|: each row is held at its own scale."""
    err = np.abs(got - want).max(axis=(1, 2))
    scale = np.maximum(np.abs(want).max(axis=(1, 2)), np.finfo(float).tiny)
    return float((err / (tol * scale)).max())


def _check(cls_name, tb, r_tiles, k_hist, with_diag, seed):
    got, want = _both(cls_name, tb, r_tiles, k_hist, with_diag, seed)
    assert _row_ratio(got, want, _tol(cls_name)) <= 1.0


@pytest.mark.parametrize("with_diag", [True, False])
@pytest.mark.parametrize("cls_name", CLASSES)
@pytest.mark.parametrize("tb", [32, 64, 128])
def test_plain_matches_reference_kernel(tb, cls_name, with_diag):
    _check(cls_name, tb, 3 if with_diag else 2, 2, with_diag,
           seed=7 if with_diag else 8)


@settings(max_examples=10, deadline=None)
@given(r_tiles=st.integers(min_value=1, max_value=4),
       k_hist=st.integers(min_value=0, max_value=3),
       cls_name=st.sampled_from(CLASSES),
       with_diag=st.booleans(),
       seed=st.integers(min_value=0, max_value=2**16))
def test_plain_matches_reference_kernel_property(r_tiles, k_hist, cls_name,
                                                 with_diag, seed):
    _check(cls_name, 32, r_tiles, k_hist, with_diag, seed)


@pytest.mark.parametrize("with_diag", [True, False])
def test_plain_matches_reference_kernel_f32(with_diag):
    """f32 tiles accumulate in f32 on both sides; only the summation order
    differs.  The diagonal (|a| ~ 2 tb) is factored and every row solved
    against it, so an entry carries a few tb * 2^-24 of its row's scale:
    the bound is 4 tb 2^-24 max|out[r]| for each row r."""
    tb = 64
    got, want = _both("f32", tb, 3, 2, with_diag, seed=11, dtype=np.float32)
    assert _row_ratio(got, want, 4 * tb * 2.0 ** -24) <= 1.0


def test_k0_is_a_pure_solve():
    """Column 0: no history; without the diagonal the step is a solve
    against l_kk, and with l_kk = I and no class it returns C exactly."""
    rng = np.random.default_rng(2)
    c = torch.from_numpy(rng.standard_normal((2, 32, 32)))
    out = tfused.fused_column_step(
        c, c.new_empty((2, 0, 32, 32)), c.new_empty((0, 32, 32)),
        torch.eye(32, dtype=torch.float64), [-1, -1], ladder=LADDERS["tpu"],
        with_diag=False)
    assert torch.equal(out, c)


def _same(got, want):
    """Bitwise, with any NaN equal to any NaN (payloads differ)."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    ints = {8: np.uint64, 4: np.uint32}[got.dtype.itemsize]
    assert np.array_equal(got[~nan].view(ints), want[~nan].view(ints))


def _log_uniform_tiles(dtype, n_tiles=40, tb=32, seed=0):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-12, 6, (n_tiles, tb, tb))
    x = np.where(rng.random(mag.shape) < 0.5, -mag, mag)
    # tiles of one magnitude too, so the scaled class sees many scales
    x[: n_tiles // 2] *= 10.0 ** rng.uniform(-8, 4, (n_tiles // 2, 1, 1)) \
        / np.abs(x[: n_tiles // 2]).max(axis=(1, 2), keepdims=True)
    return x.astype(dtype)


def _ref_scale_exact(tile):
    s = float(jfused._fp8_scale_of(jnp.max(jnp.abs(jnp.asarray(tile))),
                                   jnp.asarray(tile).dtype))
    return s == 2.0 ** np.round(np.log2(s))


@pytest.mark.parametrize("cls_name", ALL_CLASSES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_epilogue_matches_round_class(cls_name, dtype):
    """The port's epilogue against the reference kernel's ``_round_class``,
    tile by tile, bitwise.  One exception, in the scaled class: the
    reference takes its scale as ``jnp.exp2`` of the exponent, which on
    the CPU is often not exactly a power of two (ROADMAP queue 3), while
    the port keeps the exact power of two of ``precision.fp8_scale``.  On
    those tiles the two agree to within one e4m3 quantum (2^-3 of a
    value); on the tiles where the reference's scale is exact, bitwise."""
    ladder = _ladder_for(cls_name)
    kinds = set()
    for tile in _log_uniform_tiles(dtype):
        got = tfused._epilogue(torch.from_numpy(tile.copy()),
                               ladder.index(cls_name), ladder).numpy()
        want = np.asarray(jfused._round_class(jnp.asarray(tile), cls_name))
        if cls_name == "f8e4m3s" and not _ref_scale_exact(tile):
            kinds.add("inexact")
            assert np.array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, rtol=2.0 ** -3, atol=0)
        else:
            kinds.add("exact")
            _same(got, want)
    assert "exact" in kinds


def test_reference_fp8_scale_is_not_always_exact():
    """What the exception above rests on: the reference's scale is
    ``2^e`` to within rounding, and on this CPU not exactly for some e."""
    amax = jnp.asarray(2.0 ** np.arange(-20.0, 21.0) * 1.5, jnp.float64)
    s = np.asarray(jfused._fp8_scale_of(amax, jnp.float64))
    exact = 2.0 ** np.round(np.log2(s))
    assert np.all(np.abs(s / exact - 1) < 2.0 ** -48)
    assert np.any(s != exact)


# --------------------------------------------------------------------------
# the fused executor
# --------------------------------------------------------------------------

def _kms(n, rho=0.9):
    idx = np.arange(n)
    return rho ** np.abs(idx[:, None] - idx[None, :])


def _ref_fused(sched_ref, tiles, dtype=jnp.float64, use_pallas=False):
    out = make_jax_executor(sched_ref, compute_dtype=dtype,
                            use_pallas=use_pallas, fuse_columns=True)(
        jnp.asarray(tiles, dtype))
    return np.tril(from_tiles(np.asarray(out, np.float64)))


def _port_run(sched, tiles, dtype=torch.float64, use_pallas=False,
              fuse_columns=True):
    host = torch.from_numpy(tiles.copy()).to(dtype)
    io = make_torch_executor(sched, dtype, use_pallas=use_pallas,
                             device="cpu", fuse_columns=fuse_columns)(host)
    return np.tril(from_tiles(host.double().numpy())), io


@pytest.mark.parametrize("policy", POLICIES)
def test_launch_counts_equal_reference(policy):
    nt, tb = 6, 16
    kw = dict(block=(2, 2)) if policy == "v4" else {}
    tiles = to_tiles(random_spd(nt * tb, seed=5), tb)
    jfused.reset_launch_counts()
    _ref_fused(ref_build_schedule(nt, tb, policy, **kw), tiles)
    want = jfused.launch_counts()
    ops.reset_counts()
    _port_run(build_schedule(nt, tb, policy, **kw), tiles, use_pallas=True)
    got = ops.call_counts()
    assert got["fused_column_step"] == want["fused_column"]
    assert sum(got.values()) - got["fused_column_step"] == want["tile_op"]
    if policy in ("v2", "v3"):
        assert got["fused_column_step"] == nt and want["tile_op"] == 0
    assert set(ops.launch_counts().values()) == {0}     # CPU: no kernels


@pytest.mark.parametrize("policy", POLICIES)
def test_executor_f64_matches_reference_unfused_and_lapack(policy):
    nt, tb = 6, 16
    kw = dict(block=(2, 2)) if policy == "v4" else {}
    a = random_spd(nt * tb, seed=3)
    tiles = to_tiles(a, tb)
    want = _ref_fused(ref_build_schedule(nt, tb, policy, **kw), tiles)
    sched = build_schedule(nt, tb, policy, **kw)
    got, _ = _port_run(sched, tiles)
    unfused, _ = _port_run(sched, tiles, fuse_columns=False)
    assert np.abs(got - want).max() < 1e-12
    assert np.abs(got - unfused).max() < 1e-12
    assert np.abs(got - np.linalg.cholesky(a)).max() < 1e-10


@pytest.mark.parametrize("ladder", ["tpu-scaled", "gpu-scaled"])
@pytest.mark.parametrize("policy", ["v2", "v3"])
def test_executor_mxp_matches_reference(policy, ladder):
    nt, tb = 6, 32
    a = _kms(nt * tb)
    cfg = repro.CholeskyConfig(tb=tb, policy=policy, eps_target=1e-6,
                               ladder=ladder).specialize(a)
    hist = cfg.plan.histogram()
    assert sum(v > 0 for v in hist.values()) >= 3, hist
    tiles = to_tiles(a, tb)
    want = _ref_fused(ref_api.plan(nt * tb, cfg).single_schedule(), tiles)
    tcfg = repro_torch.config_from_reference(dataclasses.asdict(cfg))
    got, _ = _port_run(repro_torch.plan(nt * tb, tcfg).single_schedule(),
                       tiles)
    assert np.abs(got - want).max() < 1e-8


def test_executor_f32_kernels_match_reference():
    """use_pallas in f32 on both sides; every tile op rounds in f32 and
    only the summation order differs: bound 8 nt 2^-24 max|A| (the
    unfused slice's bound, tests/test_torch_executor.py)."""
    nt, tb = 4, 32
    a = random_spd(nt * tb, seed=9)
    tiles = to_tiles(a, tb)
    plan = repro.uniform_plan(nt, "f32")
    want = _ref_fused(ref_build_schedule(nt, tb, "v3", plan=plan), tiles,
                      dtype=jnp.float32, use_pallas=True)
    got, _ = _port_run(build_schedule(nt, tb, "v3", plan=plan), tiles,
                       dtype=torch.float32, use_pallas=True)
    assert np.abs(got - want).max() < 8 * nt * 2.0 ** -24 * np.abs(a).max()


@pytest.mark.parametrize("policy", ["v3", "v4"])
def test_executed_transfers_equal_schedule(policy):
    nt, tb = 5, 16
    kw = dict(block=(2, 2)) if policy == "v4" else {}
    sched = build_schedule(nt, tb, policy, **kw)
    _, io = _port_run(sched, to_tiles(random_spd(nt * tb, seed=1), tb),
                      dtype=torch.float32)
    assert io["h2d_ops"] == sched.count(OpKind.LOAD)
    assert io["d2h_ops"] == sched.count(OpKind.STORE)
    assert io["h2d_bytes"] == io["h2d_ops"] * tb * tb * 4
    assert io["d2h_bytes"] == io["d2h_ops"] * tb * tb * 4


def _reloaded_slots(sched, role):
    """LOADs into a slot that an op of the same column step has read as an
    operand (``role="operand"``) or written (``role="output"``) before the
    column's group has launched.  An operand's snapshot must survive such a
    LOAD; an output's slot is where the reference flushes."""
    seen, k, n = set(), None, 0
    for op in sched.ops:
        if op.kind in (OpKind.SYRK, OpKind.GEMM, OpKind.TRSM, OpKind.POTRF):
            if op.k != k:
                seen, k = set(), op.k
            seen.update([op.slot_c] if role == "output" else
                        [s for s in (op.slot_a, op.slot_b) if s >= 0])
        elif op.kind is OpKind.LOAD and op.slot_c in seen:
            n += 1
    return n


def _run_fused(sched, tiles):
    """The fused executor's loop over ``sched`` with the counted per-op
    kernels; returns L and the dispatch counts."""
    tb = sched.tb
    host = torch.from_numpy(tiles.copy())
    slots = torch.zeros((_device_nslots(sched.ops), tb, tb),
                        dtype=torch.float64)
    io = dict.fromkeys(("h2d_ops", "h2d_bytes", "d2h_ops", "d2h_bytes"), 0)
    ops.reset_counts()
    _run_ops_fused(sched.ops, host, slots, sched.plan.ladder,
                   _make_kernel_fns(True), io)
    return np.tril(from_tiles(host.numpy())), ops.call_counts()


@pytest.mark.parametrize("policy", ["v2", "v3"])
def test_slot_reuse_before_flush(policy):
    """At the policy's minimum cache, LOADs re-use operand slots that the
    pending group has snapshotted before the group launches.  The
    snapshots must still hold the tiles as the op read them (a port that
    kept views of the slots would read the later tiles)."""
    nt, tb = 6, 16
    a = _kms(nt * tb, rho=0.7) + np.eye(nt * tb)
    tiles = to_tiles(a, tb)
    sched = build_schedule(nt, tb, policy, min_cache_slots(policy, (4, 4)))
    assert _reloaded_slots(sched, "operand") > 0
    got, calls = _run_fused(sched, tiles)
    assert calls["fused_column_step"] > 0, calls
    unfused, _ = _port_run(sched, tiles, fuse_columns=False)
    assert np.abs(got - unfused).max() < 1e-12
    assert np.abs(got - np.linalg.cholesky(a)).max() < 1e-10


def test_one_launch_per_column_out_of_core():
    """The main path's schedule (v3, nt = 64, the default 130 slots) with
    2 x 2 tiles: LOADs re-use the slots of finished rows whose STOREs are
    still deferred, where the reference flushes and splits most columns.
    The executor retires those rows; each column matches the kernel whole
    and launches once, with no per-op dispatch, and the same factor."""
    nt, tb = 64, 2
    sched = build_schedule(nt, tb, "v3")
    assert _reloaded_slots(sched, "output") > 0
    a = random_spd(nt * tb, seed=4)
    tiles = to_tiles(a, tb)
    ops.reset_counts()
    got, io = _port_run(sched, tiles, use_pallas=True)
    calls = ops.call_counts()
    assert calls.pop("fused_column_step") == nt
    assert set(calls.values()) == {0}
    assert io["h2d_ops"] == sched.count(OpKind.LOAD)
    assert np.abs(got - np.linalg.cholesky(a)).max() < 1e-10
    unfused, _ = _port_run(sched, tiles, fuse_columns=False)
    assert np.abs(unfused - got).max() < 1e-12


@pytest.mark.parametrize("policy", ["v1", "v2", "v3"])
def test_split_columns_run_as_reference_groups(policy):
    """At the minimum cache a column that does not match the kernel whole
    (it re-loads a tile it stored, or re-reads operands) runs as the
    reference's groups, split where the reference flushes: never more
    launches or per-op dispatches than the reference rule, which is what
    the reference executor runs (v1 fuses every tile of it)."""
    nt, tb = 8, 4
    a = _kms(nt * tb, rho=0.7) + np.eye(nt * tb)
    tiles = to_tiles(a, tb)
    sched = build_schedule(nt, tb, policy, min_cache_slots(policy, (4, 4)))
    assert _reloaded_slots(sched, "output") > 0
    jfused.reset_launch_counts()
    _ref_fused(ref_build_schedule(nt, tb, policy,
                                  min_cache_slots(policy, (4, 4))), tiles)
    want = jfused.launch_counts()
    got, calls = _run_fused(sched, tiles)
    fused = calls.pop("fused_column_step")
    assert fused <= want["fused_column"]
    assert sum(calls.values()) <= want["tile_op"]
    if policy == "v1":
        assert fused == want["fused_column"] and want["tile_op"] == 0
    assert np.abs(got - np.linalg.cholesky(a)).max() < 1e-10


def test_config_fused_end_to_end():
    """The flag threads from CholeskyConfig through plan/compile to the
    fused executor: one fused call per column, and solve and logdet on
    its factor."""
    n, tb = 96, 16
    a = random_spd(n, seed=17)
    base = repro_torch.plan(n, repro_torch.CholeskyConfig(tb=tb)).compile(
        device="cpu")
    solver = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=tb, fuse_columns=True, use_pallas=True)).compile(device="cpu")
    ops.reset_counts()
    l_fused = solver.factor(a)
    assert ops.call_counts()["fused_column_step"] == n // tb
    assert np.abs(l_fused - base.factor(a)).max() < 1e-12
    b = np.arange(n, dtype=np.float64)
    assert np.abs(a @ solver.solve(b) - b).max() < 1e-9
    assert abs(solver.logdet() - np.linalg.slogdet(a)[1]) < 1e-9


@pytest.mark.parametrize("kw", [
    dict(ndev=2, host_slots=4), dict(host_slots=4),
], ids=["ndev", "host_slots"])
def test_fuse_columns_with_unported_options_raises(kw):
    """The disk tier is ported: fused columns with ``host_slots`` on one
    device run through the spill executor, bitwise the in-core fused
    factor; across devices the disk tier needs the NumPy replay, which
    takes no fused columns, and the config says which backend."""
    if kw.get("ndev", 1) > 1:
        with pytest.raises(ValueError, match="backend='numpy'"):
            repro_torch.CholeskyConfig(tb=32, fuse_columns=True, **kw)
        return
    n = 128
    a = random_spd(n, seed=8)
    spill = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=32, fuse_columns=True, use_pallas=True, **kw)).compile(
        device="cpu")
    incore = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=32, fuse_columns=True, use_pallas=True)).compile(device="cpu")
    ops.reset_counts()
    got = spill.factor(a)
    assert ops.call_counts()["fused_column_step"] > 0
    assert np.array_equal(got, incore.factor(a))
