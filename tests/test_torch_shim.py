"""The port's one-shot ``ooc_cholesky`` against the reference's.

Held as ``tests/test_api.py`` and ``tests/test_multidevice.py`` hold the
reference's shim: a ``DeprecationWarning``, the unified
``MultiDeviceSchedule`` (``ndev == 1`` degenerate on one device), the
planner path's factor bitwise, the multi-device layouts against LAPACK,
and the reference's raises.  Against the reference's own shim: the same
schedule digest, and L within 1e-13 on f64 plans and 1e-8 on MxP plans
(``tests/test_backend_equivalence.py``'s tolerances).
"""
import numpy as np
import pytest
import torch

import repro
from repro.core.tiling import random_spd

import repro_torch
from repro_torch.core.schedule import MultiDeviceSchedule

F64_TOL, MXP_TOL = 1e-13, 1e-8


def _shim(*args, **kw):
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.plan"):
        return repro_torch.ooc_cholesky(*args, **kw)


def test_shim_returns_unified_schedule_and_matches_solver():
    a = random_spd(96, seed=4)
    l, sched = _shim(a, 32, policy="v3", device="cpu")
    assert isinstance(sched, MultiDeviceSchedule) and sched.ndev == 1
    solver = repro_torch.plan(96, tb=32, policy="v3").compile(device="cpu")
    assert np.array_equal(l, solver.factor(a))
    assert sched is solver.schedule
    # degenerate schedule feeds the single-device analytics directly
    rep = repro_torch.volume_report(sched)
    assert rep["c2g_bytes"] == sched.loads_bytes()
    r = repro_torch.simulate(sched, repro_torch.HW["gh200"])
    assert r.h2d_bytes == sched.loads_bytes()


@pytest.mark.parametrize("kw", [
    dict(policy="v3"),
    dict(policy="sync"),
    dict(policy="v4", block=(2, 2)),
    dict(policy="v3", eps_target=1e-6, ladder="gpu"),
    dict(policy="v3", compute_dtype=torch.float32, use_pallas=True),
], ids=["v3", "sync", "v4", "mxp-gpu", "f32-kernels"])
def test_shim_is_bitwise_the_planner_path(kw):
    a = random_spd(128, seed=6)
    l, sched = _shim(a, 16, device="cpu", **kw)
    cfg = repro_torch.CholeskyConfig(tb=16, **kw).specialize(a)
    solver = repro_torch.plan(128, cfg).compile(device="cpu")
    assert np.array_equal(l, solver.factor(a))
    assert sched.digest() == solver.schedule.digest()


def test_shim_takes_a_tensor():
    a = random_spd(128, seed=7)
    l, _ = _shim(torch.from_numpy(a), 16, eps_target=1e-6, device="cpu")
    l2, _ = _shim(a, 16, eps_target=1e-6, device="cpu")
    assert np.array_equal(l, l2)


# (reference kwargs, port kwargs, tolerance): the reference's "auto"
# resolves to its jitted executor on one device and to its NumPy replay
# for ndev > 1 on one JAX device; the port's "auto" is the torch backend
_REF_CASES = {
    "f64-v3": (dict(policy="v3"), {}, F64_TOL),
    "f64-v2": (dict(policy="v2", cache_slots=12), {}, F64_TOL),
    "mxp-tpu": (dict(policy="v3", eps_target=1e-6), {}, MXP_TOL),
    "mxp-gpu-scaled": (dict(policy="v3", eps_target=1e-6,
                            ladder="gpu-scaled"), {}, MXP_TOL),
    "f64-ndev2": (dict(policy="v3", ndev=2), {}, F64_TOL),
    "mxp-ndev4": (dict(policy="v3", eps_target=1e-6, ndev=4), {}, MXP_TOL),
    "numpy": (dict(policy="v3", backend="numpy"),
              dict(backend="numpy"), F64_TOL),
    "jax-name": (dict(policy="v3", backend="jax"),
                 dict(backend="jax"), F64_TOL),
}


@pytest.mark.parametrize("name", list(_REF_CASES))
def test_shim_matches_the_references(name):
    ref_kw, port_kw, tol = _REF_CASES[name]
    a = random_spd(128, seed=5)
    with pytest.warns(DeprecationWarning):
        l_ref, s_ref = repro.ooc_cholesky(a, 16, **ref_kw)
    l, s = _shim(a, 16, device="cpu", **{**ref_kw, **port_kw})
    assert s.digest() == s_ref.digest()
    assert s.ndev == s_ref.ndev
    assert np.abs(l - l_ref).max() < tol


def test_ooc_cholesky_ndev():
    """``tests/test_multidevice.py::test_ooc_cholesky_ndev`` on CPU
    handles."""
    a = random_spd(128, seed=5)
    l, msched = _shim(a, 16, policy="v3", ndev=2, device="cpu")
    np.testing.assert_allclose(l, np.linalg.cholesky(a), atol=1e-10)
    assert msched.ndev == 2
    # mixed precision still converges to the requested accuracy class
    l2, m4 = _shim(a, 16, policy="v3", eps_target=1e-6, ndev=4,
                   device="cpu")
    assert m4.ndev == 4
    assert np.abs(l2 - np.linalg.cholesky(a)).max() < 1e-3


@pytest.mark.parametrize("backend", ["torch", "jax"])
def test_multidevice_torch_backend_requires_cards(monkeypatch, backend):
    """``tests/test_api.py``'s raise: ndev=2 on the torch backend (the
    reference's "jax") with one card fails at compile, through the shim
    too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    a = random_spd(64, seed=0)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
            repro_torch.ooc_cholesky(a, 16, ndev=2, backend=backend)


def test_shim_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.ooc_cholesky(random_spd(64), 16)


@pytest.mark.parametrize("kw,match", [
    (dict(policy="async", ndev=2), "sync/v1/v2/v3"),
    (dict(policy="v4", ndev=2), "sync/v1/v2/v3"),
    (dict(use_pallas=True, backend="numpy"), "requires the 'torch'"),
    (dict(compute_dtype=torch.float32, backend="numpy"),
     "requires the 'torch'"),
    (dict(block=(2, 2)), "only meaningful for policy='v4'"),
    (dict(backend="tpu"), "unknown backend"),
])
def test_invalid_combinations_raise_eagerly(kw, match):
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match=match):
            repro_torch.ooc_cholesky(random_spd(64), 16, device="cpu", **kw)
