"""The port's tile kernels against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the reference's ``repro.kernels.ops`` wrapper (Pallas in interpret mode) at
the shapes, dtypes and tolerances of ``tests/test_kernels.py``, on inputs
made with numpy from a seed.  The CUDA kernels are held against their plain
versions on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import fused_column, ops, ref

SHAPES = [64, 128, 256, 384]
DTYPES = ["float32", "bfloat16"]
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
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


def _both(x, dtype):
    """One numpy f32 array as a jnp array and a torch tensor of ``dtype``
    (both round f32 -> bf16 to nearest even, so the inputs are identical)."""
    return jnp.asarray(x, dtype=_JNP[dtype]), torch.from_numpy(x).to(
        _TORCH[dtype])


def _np64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf(n, dtype):
    ja, ta = _both(_spd(n), dtype)
    want = _np64(jops.potrf(ja, interpret=True))
    got = _np64(ops.potrf(ta))
    np.testing.assert_allclose(np.tril(got), np.tril(want),
                               atol=_tol(dtype), rtol=_tol(dtype))
    assert not np.triu(got, 1).any()


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_trsm(n, dtype):
    l32 = np.linalg.cholesky(_spd(n).astype(np.float64)).astype(np.float32)
    jl, tl = _both(l32, dtype)
    jc, tc = _both(_mat(n), dtype)
    want = _np64(jops.trsm(jl, jc, interpret=True))
    got = _np64(ops.trsm(tl, tc))
    np.testing.assert_allclose(got, want, atol=20 * _tol(dtype),
                               rtol=20 * _tol(dtype))


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_syrk(n, dtype):
    jc, tc = _both(_spd(n), dtype)
    ja, ta = _both(_mat(n), dtype)
    want = _np64(jops.syrk_update(jc, ja, interpret=True))
    got = _np64(ops.syrk_update(tc, ta))
    np.testing.assert_allclose(got, want, atol=n * _tol(dtype) / 16,
                               rtol=_tol(dtype))
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm(n, dtype):
    jc, tc = _both(_spd(n), dtype)
    ja, ta = _both(_mat(n), dtype)
    jb, tb = _both(_mat(n, seed=7), dtype)
    want = _np64(jops.gemm_update(jc, ja, jb, interpret=True))
    got = _np64(ops.gemm_update(tc, ta, tb))
    np.testing.assert_allclose(got, want, atol=n * _tol(dtype) / 16,
                               rtol=_tol(dtype))


def test_gemm_fp8_inputs():
    """fp8-e4m3 operands accumulate in f32 (MxP tile contract)."""
    n = 128
    a, b, c = _mat(n), _mat(n, seed=5), _spd(n)
    ja = jnp.asarray(a, jnp.float8_e4m3fn).astype(jnp.float32)
    jb = jnp.asarray(b, jnp.float8_e4m3fn).astype(jnp.float32)
    want = _np64(jops.gemm_update(jnp.asarray(c), ja, jb, interpret=True))
    ta = torch.from_numpy(a).to(torch.float8_e4m3fn)
    tb = torch.from_numpy(b).to(torch.float8_e4m3fn)
    np.testing.assert_array_equal(_np64(ta), _np64(ja))
    got = _np64(ops.gemm_update(torch.from_numpy(c), ta, tb))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_f64_takes_the_stock_path():
    """f64 tiles go to stock PyTorch and never count as a launch."""
    ops.reset_counts()
    a = torch.from_numpy(_spd(128).astype(np.float64))
    got = ops.potrf(a)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(a.numpy()),
                               atol=1e-12)
    assert ops.call_counts()["potrf"] == 1
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cpu_wrappers_run_the_plain_versions():
    ops.reset_counts()
    c, a = torch.from_numpy(_spd(64)), torch.from_numpy(_mat(64))
    assert torch.equal(ops.syrk_update(c, a), ref.syrk_update_ref(c, a))
    assert torch.equal(ops.gemm_update(c, a, a), ref.gemm_update_ref(c, a, a))
    assert torch.equal(ops.potrf(c), ref.potrf_ref(c))
    assert torch.equal(ops.trsm(c, a), ref.trsm_ref(c, a))
    args = (c[None], a[None, None], a[None], c, [-1])
    kw = dict(ladder=("f64", "f32"), with_diag=False)
    assert torch.equal(ops.fused_column_step(*args, **kw),
                       fused_column.fused_column_step_ref(*args, **kw))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert ops.call_counts() == dict.fromkeys(ops.TILE_OPS, 1)


def test_non_spd_pivot_gives_nan():
    a = torch.from_numpy(-_spd(32))
    assert torch.isnan(ops.potrf(a)).all()


def test_wrappers_reject_other_devices():
    """A tensor that is neither on the CPU nor on CUDA has no kernel and
    no fallback."""
    a = torch.empty((64, 64), device="meta")
    for call in (lambda: ops.potrf(a), lambda: ops.trsm(a, a),
                 lambda: ops.syrk_update(a, a),
                 lambda: ops.gemm_update(a, a, a),
                 lambda: ops.fused_column_step(
                     a[None], a[None, None], a[None], a, [-1],
                     ladder=("f32",), with_diag=False)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
