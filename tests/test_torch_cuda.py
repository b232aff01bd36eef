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
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 1),
                                   "fused_column_step": 0,
                                   "flash_attention": 0}
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
        "trsm": sched.count(OpKind.TRSM), "potrf": sched.count(OpKind.POTRF),
        "fused_column_step": 0, "flash_attention": 0}
    assert np.abs(l - np.linalg.cholesky(a)).max() < 5e-3


# --------------------------------------------------------------------------
# the fused column step
# --------------------------------------------------------------------------

_FUSED_CLASSES = ("f64", "f32", "f16", "bf16", "f8e4m3", "f8e4m3s")
_LADDER = ("f64", "f32", "f16", "bf16", "f8e4m3", "f8e4m3s")
# unit roundoff of each class (repro_torch.core.precision.EPS)
_EPS = {"f64": 2.0 ** -53, "f32": 2.0 ** -24, "f16": 2.0 ** -11,
        "bf16": 2.0 ** -8, "f8e4m3": 2.0 ** -4, "f8e4m3s": 2.0 ** -4}


def _fused_inputs(r_tiles, k_hist, tb, with_diag, dt, dev, seed=0):
    """Column-step operands shaped like the executor's group; history
    entries N(0, 1/tb), so the wave moves every entry by O(sqrt(K/tb))."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((tb, tb))
    spd = np.eye(tb) * (2.0 * tb) + g @ g.T / tb
    rows = [spd if with_diag else rng.standard_normal((tb, tb))]
    rows += [rng.standard_normal((tb, tb)) for _ in range(r_tiles - 1)]
    hist = rng.standard_normal((r_tiles, k_hist, tb, tb)) / np.sqrt(tb)
    bhist = hist[0].copy() if with_diag else \
        rng.standard_normal((k_hist, tb, tb)) / np.sqrt(tb)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)
            for x in (np.stack(rows), hist, bhist, np.linalg.cholesky(spd))]


def _fused_tol(cls, tb, dt):
    """An accumulation-order ulp may move a value across a class quantum
    (tests/test_kernel_numerics.py::_tol); in f32 the factor and the solve
    also carry a few tb * 2^-24 of a row's scale."""
    work = 1e-12 if dt == torch.float64 else 4 * tb * 2.0 ** -24
    return max(work, 4 * _EPS[cls])


@pytest.mark.cuda
@pytest.mark.parametrize("with_diag", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tb", [64, 128, 512])
def test_cuda_fused_matches_plain(cuda, tb, dtype, with_diag):
    from repro_torch.kernels import fused_column
    dt = torch.float32 if dtype == "float32" else torch.float64
    args = _fused_inputs(3, 2, tb, with_diag, dt, cuda, seed=tb)
    for cls in _FUSED_CLASSES:
        ids = [_LADDER.index(cls)] * 3
        ops.reset_counts()
        got = fused_column.fused_column_step(*args, ids, ladder=_LADDER,
                                             with_diag=with_diag)
        want = fused_column.fused_column_step_ref(
            *args, ids, ladder=_LADDER, with_diag=with_diag)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_column_step"] == 1
        assert got.dtype == dt
        # each row at its own scale, max|want[r]|
        err = (got.double() - want.double()).abs().amax(dim=(1, 2))
        scale = want.double().abs().amax(dim=(1, 2)).clamp_min(1e-300)
        ratio = float((err / (_fused_tol(cls, tb, dt) * scale)).max())
        assert ratio <= 1.0, (cls, ratio)


def _edge_tile(tb, dt, dev, seed):
    """Log-uniform magnitudes with f16 ties and values past e4m3's band."""
    rng = np.random.default_rng(seed)
    x = 10.0 ** rng.uniform(-12, 6, (tb, tb))
    x = np.where(rng.random((tb, tb)) < 0.5, -x, x)
    edges = np.array([448.0, 455.0, 464.0, 464.5, 470.0, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -11 + 2.0 ** -40, 2.0 ** -10, 0.0, -0.0])
    x.flat[: edges.size] = edges
    return torch.from_numpy(x).to(dev, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_fused_epilogue_bitwise(cuda, dtype):
    """K = 0, no diagonal, l_kk = I: the solve returns C exactly, so the
    output is the epilogue alone, held bitwise against the port's class
    round on the card (NaN against NaN)."""
    from repro_torch.kernels import fused_column
    dt = torch.float32 if dtype == "float32" else torch.float64
    tb = 128
    ids = list(range(-1, len(_LADDER)))
    c = torch.stack([_edge_tile(tb, dt, cuda, seed=i) for i in range(len(ids))])
    # one tile of one magnitude, so the scaled class's scale is not 1
    c[-1] = c[-1].clamp(-1e-3, 1e-3)
    got = fused_column.fused_column_step(
        c, c.new_empty((len(ids), 0, tb, tb)), c.new_empty((0, tb, tb)),
        torch.eye(tb, dtype=dt, device=cuda), ids, ladder=_LADDER,
        with_diag=False)
    torch.cuda.synchronize()
    for r, cls_id in enumerate(ids):
        want = fused_column._epilogue(c[r], cls_id, _LADDER)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got[r]), nan), cls_id
        bits = torch.int32 if dt == torch.float32 else torch.int64
        assert torch.equal(got[r][~nan].view(bits),
                           want[~nan].view(bits)), cls_id


@pytest.mark.cuda
def test_cuda_fused_executor_one_launch_per_column(cuda):
    """v3 end to end through the fused kernel: exactly nt launches, no
    per-op launch, the factor within the unfused slice's f32 bound."""
    import repro_torch
    n, tb = 1024, 128
    a = repro_torch.random_spd(n, seed=9)
    solver = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=tb, use_pallas=True, compute_dtype=torch.float32,
        fuse_columns=True)).compile()
    ops.reset_counts()
    l = solver.factor(a)
    counts = ops.launch_counts()
    assert counts.pop("fused_column_step") == n // tb
    assert set(counts.values()) == {0}
    assert np.abs(l - np.linalg.cholesky(a)).max() < 5e-3


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

_FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}    # tests/test_flash_attention.py
# each output row at its own scale (chip_smoke.py's FLASH_ROW_TOL and
# FLASH_ACC): one ulp of the row's largest value, plus _FLASH_ACC f32 quanta
# of max|v| for the two summation orders
_FLASH_ROW_TOL = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
_FLASH_ACC = 8


def _flash_row_ratio(got, want, v, tol):
    """The worst row's max|got - want| over its allowance."""
    err = (got.double() - want.double()).abs().amax(dim=-1)
    allow = (tol * want.double().abs().amax(dim=-1)
             + _FLASH_ACC * 2.0 ** -24 * float(v.abs().max()))
    return float((err / allow).max())


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 5, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_cuda_flash_matches_plain(cuda, hd, causal, dtype, group):
    """The kernel against flash_gqa_ref in model layout: causal at S = T =
    256, full at S = 100, T = 200 (ragged query and KV tiles).  Each row is
    held at its own scale, and that check must reject the plain version
    without the last 64 keys (a dropped KV tile) and a zeroed output."""
    from repro_torch.kernels import flash_attention as fa
    dt = _TORCH[dtype]
    b, kv = 2, 2
    s, t = (256, 256) if causal else (100, 200)
    rng = np.random.default_rng(hd + group)

    def rand(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(cuda, dt)

    q, k, v = rand(b, s, kv * group, hd), rand(b, t, kv, hd), rand(b, t, kv, hd)
    ops.reset_counts()
    got = fa.flash_gqa(q, k, v, causal=causal)
    want = fa.flash_gqa_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == dt and got.shape == q.shape
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.double(), want.double(), atol=tol, rtol=tol)
    row_tol = _FLASH_ROW_TOL[dtype]
    assert _flash_row_ratio(got, want, v, row_tol) <= 1.0
    dropped = fa.flash_gqa_ref(q, k[:, :-64], v[:, :-64], causal=causal,
                               bq=s, bk=t - 64)
    assert _flash_row_ratio(got, dropped, v, row_tol) > 1.0
    assert _flash_row_ratio(torch.zeros_like(got), want, v, row_tol) > 1.0
    # the [BH, S, hd] layout of flash_attention gives the same values
    flat = fa.flash_attention(q.transpose(1, 2).reshape(-1, s, hd).contiguous(),
                              k.transpose(1, 2).reshape(-1, t, hd).contiguous(),
                              v.transpose(1, 2).reshape(-1, t, hd).contiguous(),
                              causal=causal)
    assert torch.equal(flat.reshape(b, -1, s, hd).transpose(1, 2), got)


@pytest.mark.cuda
def test_cuda_flash_rejects_other_head_dims(cuda):
    from repro_torch.kernels import flash_attention as fa
    x = torch.zeros(1, 128, 2, 96, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_gqa(x, x, x)


@pytest.mark.cuda
def test_cuda_flash_rejects_non_contiguous_operands(cuda):
    """No quiet copy on the card: a strided q raises, as the tile kernels'
    operands do."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(1, 4, 128, 64, device=cuda).transpose(1, 2)
    k = torch.zeros(1, 128, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_gqa(q, k, k)


@pytest.mark.cuda
def test_cuda_prefill_step_launches_flash_per_layer(cuda):
    """One prefill step of a two-layer dense model in bf16 at S = 128: one
    flash launch per layer, and the last-position logits of the plain
    attention within bf16's reach (2^-8 relative, of logits below 4)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_gqa_ref
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("qwen3-14b", smoke=True),
                              head_dim=64, dtype="bfloat16",
                              use_flash_attention=True)
    params = T.init_model(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 128))).to(cuda)
    ops.reset_counts()
    got = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    want = make_prefill_step(cfg, flash=flash_gqa_ref)(params,
                                                       {"tokens": tokens})
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    v = cfg.vocab
    assert torch.isfinite(got[:, :v]).all()
    assert (got[:, v:] <= -1e29).all()
    torch.testing.assert_close(got[:, :v].float(), want[:, :v].float(),
                               atol=4 * 2.0 ** -8 * 4, rtol=0)
