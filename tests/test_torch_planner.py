"""The port's planner core against the reference: digests, op streams,
precision plans.  All of it is pure Python/NumPy, so equality is exact."""
import numpy as np
import pytest

import test_golden_schedule as golden
from repro.core import precision as ref_precision
from repro.core import schedule as ref_schedule

from repro_torch.core import precision, schedule, tiling

POLICIES = ("sync", "async", "v1", "v2", "v3", "v4")


def _fixed_plan(nt=golden.NT):
    """The golden test's MxP plan, built with the port's assign_precision."""
    norms = np.fromfunction(
        lambda i, j: 0.25 + ((3 * i + 5 * j) % 7) / 7.0, (nt, nt))
    dist = np.fromfunction(
        lambda i, j: np.minimum(abs(i - j), 4.0), (nt, nt))
    norms = norms * (1e-2 ** dist)
    norms[np.diag_indices(nt)] = 10.0
    return precision.assign_precision(
        norms, float(np.sqrt((norms ** 2).sum())), golden.EPS)


def _port_digests():
    nt, tb, slots, nt4 = golden.NT, golden.TB, golden.SLOTS, golden.NT4
    plan, plan4 = _fixed_plan(), _fixed_plan(nt4)
    out = {}
    for p in ("sync", "async", "v1", "v2", "v3"):
        out[p] = schedule.build_schedule(nt, tb, p, cache_slots=slots,
                                         plan=plan).digest()
    out["v4"] = schedule.build_schedule(nt, tb, "v4", cache_slots=10,
                                        plan=plan, block=(2, 2)).digest()
    for p in ("sync", "v1", "v2", "v3"):
        out[p + "@ndev2"] = schedule.build_multidevice_schedule(
            nt, tb, 2, p, cache_slots=slots, plan=plan).digest()
        out[p + "@ndev4"] = schedule.build_multidevice_schedule(
            nt4, tb, 4, p, cache_slots=slots, plan=plan4).digest()
        out[p + "@grid2x2"] = schedule.build_multidevice_schedule(
            nt4, tb, 4, p, cache_slots=slots, plan=plan4,
            grid=(2, 2)).digest()
    return out


def test_golden_digests():
    assert _port_digests() == golden.GOLDEN


def _op_tuples(ops):
    return [(o.kind.value, o.i, o.j, o.slot_c, o.slot_a, o.slot_b, o.cls,
             o.bytes, o.k, o.src) for o in ops]


def _spd_tiles(nt, tb, seed):
    """Tiles of an SPD matrix whose off-diagonal tiles decay with distance,
    so an eps_target plan mixes every class of the ladder."""
    a = tiling.random_spd(nt * tb, seed=seed)
    idx = np.arange(nt * tb) // tb
    a = a * (1e-3 ** np.abs(idx[:, None] - idx[None, :]))
    return tiling.to_tiles(a, tb)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mxp", [False, True], ids=["f64", "mxp"])
def test_ops_equal_reference(policy, mxp):
    nt, tb = 6, 8
    if mxp:
        tiles = _spd_tiles(nt, tb, seed=4)
        norms, total = precision.tile_norms(tiles)
        plan = precision.assign_precision(norms, total, 1e-6, "gpu",
                                          tile_amax=precision.tile_amax(tiles))
        rplan = ref_precision.PrecisionPlan(plan.classes, plan.ladder,
                                            plan.eps_target)
    else:
        plan = precision.uniform_plan(nt)
        rplan = ref_precision.uniform_plan(nt)
    kw = dict(block=(2, 2), cache_slots=10) if policy == "v4" else {}
    got = schedule.build_schedule(nt, tb, policy, plan=plan, **kw)
    want = ref_schedule.build_schedule(nt, tb, policy, plan=rplan, **kw)
    assert _op_tuples(got.ops) == _op_tuples(want.ops)
    assert (got.hits, got.misses, got.evictions, got.cache_slots) == \
        (want.hits, want.misses, want.evictions, want.cache_slots)
    assert got.digest() == want.digest()
    m = schedule.MultiDeviceSchedule.from_single(got)
    assert m.digest() == ref_schedule.MultiDeviceSchedule.from_single(
        want).digest()
    assert _op_tuples(m.to_single().ops) == _op_tuples(got.ops)


@pytest.mark.parametrize("ladder", sorted(precision.LADDERS))
@pytest.mark.parametrize("eps", [1e-4, 1e-6, 1e-8])
def test_assign_precision_bitwise(ladder, eps):
    tiles = _spd_tiles(6, 16, seed=7)
    norms, total = precision.tile_norms(tiles)
    rnorms, rtotal = ref_precision.tile_norms(tiles)
    assert np.array_equal(norms, rnorms) and total == rtotal
    amax = precision.tile_amax(tiles)
    assert np.array_equal(amax, ref_precision.tile_amax(tiles))
    got = precision.assign_precision(norms, total, eps, ladder,
                                     tile_amax=amax)
    want = ref_precision.assign_precision(rnorms, rtotal, eps, ladder,
                                          tile_amax=amax)
    assert np.array_equal(got.classes, want.classes)
    assert got.classes.dtype == want.classes.dtype
    assert (got.ladder, got.eps_target) == (want.ladder, want.eps_target)
    np.testing.assert_array_equal(precision.scale_table(tiles, got),
                                  ref_precision.scale_table(tiles, want))


def test_fp8_scale_bitwise():
    amax = np.concatenate([10.0 ** np.random.default_rng(0).uniform(
        -20, 20, 5000), [0.0, -1.0, 448.0, 392.0, 224.0, np.inf, np.nan]])
    got = [precision.fp8_scale(float(a)) for a in amax]
    want = [ref_precision.fp8_scale(float(a)) for a in amax]
    assert got == want


def test_plan_for_matrix_tensor_path_matches_numpy():
    """A tensor's tile statistics, taken in torch, give the numpy plan."""
    import torch
    from repro.core.cholesky import plan_for_matrix as ref_plan_for_matrix
    from repro_torch.core.cholesky import plan_for_matrix
    tiles = _spd_tiles(5, 16, seed=11)
    a = tiling.from_tiles(tiles)
    want = ref_plan_for_matrix(tiles, 1e-6, "gpu-scaled")
    for got in (plan_for_matrix(tiles, 1e-6, "gpu-scaled"),
                plan_for_matrix(torch.from_numpy(a), 1e-6, "gpu-scaled",
                                tb=16)):
        assert np.array_equal(got.classes, want.classes)
        assert (got.ladder, got.eps_target) == (want.ladder, want.eps_target)
    assert len(set(want.classes[np.tril_indices(5)].tolist())) >= 3
