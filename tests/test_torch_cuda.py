"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode.  The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Inputs are made with numpy from a seed; tolerances are those of
``tests/test_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

DTYPES = ["float32", "bfloat16"]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    return (x @ x.T + 2.0 * np.eye(n)).astype(np.float32)


def _mat(n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)).astype(np.float32)


def _tol(dtype):
    return {"float32": 2e-4, "bfloat16": 6e-2}[dtype]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_cases():
    return [(n, d) for n in (64, 96, 512) for d in DTYPES]


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", _cuda_cases())
def test_cuda_kernels_match_plain(cuda, n, dtype):
    dt, tol = _TORCH[dtype], _tol(dtype)
    spd = torch.from_numpy(_spd(n)).to(cuda, dt)
    m1 = torch.from_numpy(_mat(n)).to(cuda, dt)
    m2 = torch.from_numpy(_mat(n, seed=7)).to(cuda, dt)
    l = torch.linalg.cholesky(spd.double()).to(dt).contiguous()
    ops.reset_counts()
    cases = [
        ("potrf", ops.potrf(spd), ref.potrf_ref(spd), tol, tol),
        ("trsm", ops.trsm(l, m1), ref.trsm_ref(l, m1), 20 * tol, 20 * tol),
        ("syrk", ops.syrk_update(spd, m1), ref.syrk_update_ref(spd, m1),
         n * tol / 16, tol),
        ("gemm", ops.gemm_update(spd, m1, m2),
         ref.gemm_update_ref(spd, m1, m2), n * tol / 16, tol),
    ]
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 1)
    for name, got, want, atol, rtol in cases:
        assert got.dtype == want.dtype, name
        torch.testing.assert_close(got.double(), want.double(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.cuda
def test_cuda_gemm_fp8_operands(cuda):
    n = 512
    a = torch.from_numpy(_mat(n)).to(cuda, torch.float8_e4m3fn)
    b = torch.from_numpy(_mat(n, seed=5)).to(cuda, torch.float8_e4m3fn)
    c = torch.from_numpy(_spd(n)).to(cuda)
    got = ops.gemm_update(c, a, b)
    tol = _tol("float32")
    torch.testing.assert_close(got, ref.gemm_update_ref(c, a, b),
                               atol=n * tol / 16, rtol=tol)


@pytest.mark.cuda
def test_cuda_executor_runs_the_kernels(cuda):
    """The slice end to end on the card: f32 compute through the kernels,
    one launch per compute op of the schedule, against LAPACK in f64
    (the bound of tests/test_cholesky.py::test_pallas_kernel_executor)."""
    import repro_torch
    from repro_torch.core.schedule import OpKind
    n, tb = 512, 128
    a = repro_torch.random_spd(n, seed=9)
    solver = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=tb, use_pallas=True, compute_dtype=torch.float32)).compile()
    ops.reset_counts()
    l = solver.factor(a)
    sched = solver.schedule
    assert ops.launch_counts() == {
        "mxp_gemm_update": sched.count(OpKind.GEMM),
        "syrk_update": sched.count(OpKind.SYRK),
        "trsm": sched.count(OpKind.TRSM), "potrf": sched.count(OpKind.POTRF)}
    assert np.abs(l - np.linalg.cholesky(a)).max() < 5e-3
