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


# --------------------------------------------------------------------------
# backward error of the blocked POTRF and TRSM, each at its own scale
# --------------------------------------------------------------------------

# chip_smoke.py's BACKWARD_C: the residual of a blocked kernel is held to
# BACKWARD_C units of the output type's roundoff at the residual's own scale
# (_EPS_OUT); POTRF's per 64-column block, so that the bound does not grow
# with n.  A backward-stable factor or solve reaches at most about (n + 1)
# units there (POTRF: the block's last column + 1); the card's readings stay
# below 1.6 (n = 1: sqrt, the division and the square each round once) and a
# dropped block update reads 50 or more (benchmarks/torch_tile_bounds.py).
BACKWARD_C = 5
_EPS_OUT = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}
_NB = 64            # the kernels' block edge (repro_torch.kernels.potrf.NB)


def _trsm_backward(x, l, c):
    """max over rows of |X L^T - C|_row / (max|X_row| max|L| n), in units
    of X's roundoff."""
    xd, ld, cd = x.double(), l.double(), c.double()
    res = (xd @ ld.T - cd).abs().amax(dim=1)
    scale = xd.abs().amax(dim=1).clamp_min(1e-300) * ld.abs().max() * ld.shape[0]
    return float((res / scale).max()) / _EPS_OUT[x.dtype]


def _potrf_backward(lf, a, nb=_NB):
    """max over 64-column blocks J of max|(L L^T - sym(A))[:, J]| / (max|A|
    min(n, (J + 1) nb)), in units of L's roundoff: an entry of column j
    sums j + 1 products."""
    ld, ad = lf.double(), a.double()
    n = ad.shape[0]
    res = (ld @ ld.T - 0.5 * (ad + ad.T)).abs().amax(dim=0)
    terms = (torch.arange(n, device=ad.device) // nb + 1) * nb
    scale = ad.abs().max() * terms.clamp(max=n)
    return float((res / scale).max()) / _EPS_OUT[lf.dtype]


def _potrf_dropped_update(a, nb=_NB):
    """The blocked right-looking factor in f64 with one trailing update
    left out: tile (last, 1) at the first step (tile (1, 1) for two block
    columns). A kernel that drops one update computes this."""
    ad = 0.5 * (a.double() + a.double().T)
    n = ad.shape[0]
    nt = -(-n // nb)
    drop = (nt - 1, 1)
    w = ad.clone()
    for kt in range(nt):
        k0, k1 = kt * nb, min(n, (kt + 1) * nb)
        w[k0:k1, k0:k1] = torch.linalg.cholesky(w[k0:k1, k0:k1])
        if k1 == n:
            break
        w[k1:, k0:k1] = torch.linalg.solve_triangular(
            w[k0:k1, k0:k1].T, w[k1:, k0:k1], upper=True, left=False)
        for i in range(kt + 1, nt):
            for j in range(kt + 1, i + 1):
                if kt == 0 and (i, j) == drop:
                    continue
                i0, i1, j0, j1 = i * nb, min(n, (i + 1) * nb), j * nb, min(
                    n, (j + 1) * nb)
                w[i0:i1, j0:j1] -= w[i0:i1, k0:k1] @ w[j0:j1, k0:k1].T
    return torch.tril(w)


def _trsm_dropped_block(l, c, nb=_NB):
    """X solved against L with its block (J, J - 1) zeroed, J the last
    block row: a kernel that drops one block of its update computes this."""
    lz = l.double().clone()
    j0 = (l.shape[0] - 1) // nb * nb
    lz[j0:, j0 - nb:j0] = 0.0
    return torch.linalg.solve_triangular(lz.T, c.double(), upper=True,
                                         left=False).to(c.dtype)


def _check_blocked(name, got, args):
    """The blocked kernel's residual within BACKWARD_C units; for an f32
    output past one block, the control with one block update dropped must
    fail.  (A bf16 output's own rounding, 2^-8 of an entry, is larger than
    what one dropped block moves at this scale, so there the residual check
    holds the kernel to its rounding and the controls are f32's.)"""
    n = args[0].shape[0]
    controlled = n > _NB and got.dtype == torch.float32
    if name == "potrf":
        (a,) = args
        ratio = _potrf_backward(got, a)
        ctrl = (_potrf_backward(_potrf_dropped_update(a).to(got.dtype), a)
                if controlled else None)
    else:
        l, c = args
        ratio = _trsm_backward(got, l, c)
        ctrl = (_trsm_backward(_trsm_dropped_block(l, c), l, c)
                if controlled else None)
    assert ratio <= BACKWARD_C, (name, n, ratio)
    if ctrl is not None:
        assert not ctrl <= BACKWARD_C, (name, n, "control passes", ctrl)


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
    _check_blocked("potrf", cases[0][1], (spd,))
    _check_blocked("trsm", cases[1][1], (l, m1))


_RAGGED = [1, 31, 33, 100, 257, 513, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", _RAGGED)
def test_cuda_blocked_ragged(cuda, n, dtype):
    """Sizes that are not a multiple of the 64-wide blocks: the old
    tolerances against the plain version, the residual at its own scale,
    and the dropped-update controls."""
    dt, tol = _TORCH[dtype], _tol(dtype)
    spd = torch.from_numpy(_spd(n, seed=n)).to(cuda, dt)
    c = torch.from_numpy(_mat(n, seed=n + 1)).to(cuda, dt)
    l = torch.linalg.cholesky(spd.double()).to(dt).contiguous()
    ops.reset_counts()
    got_p, got_t = ops.potrf(spd), ops.trsm(l, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["potrf"] == 1
    assert ops.launch_counts()["trsm"] == 1
    torch.testing.assert_close(got_p.double(), ref.potrf_ref(spd).double(),
                               atol=tol, rtol=tol)
    assert not torch.triu(got_p, 1).any()
    torch.testing.assert_close(got_t.double(), ref.trsm_ref(l, c).double(),
                               atol=20 * tol, rtol=20 * tol)
    _check_blocked("potrf", got_p, (spd,))
    _check_blocked("trsm", got_t, (l, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_blocked_largest_sizes(cuda, dtype):
    """The largest tiles the wrappers take: POTRF at n = 6144, whose grid
    (18,145 blocks needed) is capped at what the card holds, so each phase
    walks its work grid-stride; TRSM at n = 4096 (99 KiB of shared memory a
    block).  Both dropped-update controls must fail here too: POTRF's
    residual is held per 64-column block, so its bound does not grow with n
    (scaled by n, one dropped 64 x 64 update read 1.37 units at n = 6144,
    inside the bound)."""
    from repro_torch.kernels import potrf, trsm
    dt, tol = _TORCH[dtype], _tol(dtype)
    n = potrf.MAX_N
    spd = torch.from_numpy(_spd(n, seed=11)).to(cuda, dt)
    got = ops.potrf(spd)
    torch.testing.assert_close(got.double(), ref.potrf_ref(spd).double(),
                               atol=tol, rtol=tol)
    _check_blocked("potrf", got, (spd,))
    n = trsm.MAX_N
    l = torch.linalg.cholesky(torch.from_numpy(_spd(n, seed=12)).to(
        cuda).double()).to(dt).contiguous()
    c = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (512, n)).astype(np.float32)).to(cuda, dt)
    got = ops.trsm(l, c)
    torch.testing.assert_close(got.double(), ref.trsm_ref(l, c).double(),
                               atol=20 * tol, rtol=20 * tol)
    _check_blocked("trsm", got, (l, c))


_PAIRS = [(a, b) for a in DTYPES for b in DTYPES]


@pytest.mark.cuda
@pytest.mark.parametrize("l_dtype,c_dtype", _PAIRS)
@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("m", [1, 7, 700])
def test_cuda_trsm_rows_and_type_pairs(cuda, m, n, l_dtype, c_dtype):
    """Row counts that leave a block's last warps idle (m = 1, 7) or need
    more than one block per SM (m = 700), against both L sizes, for every
    (L, C) type pair the kernel takes."""
    tol = max(_tol(l_dtype), _tol(c_dtype))
    rng = np.random.default_rng(m + n)
    l = torch.linalg.cholesky(torch.from_numpy(_spd(n, seed=m)).double())
    l = l.to(cuda, _TORCH[l_dtype]).contiguous()
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    c = c.to(cuda, _TORCH[c_dtype])
    ops.reset_counts()
    got = ops.trsm(l, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["trsm"] == 1
    assert got.dtype == c.dtype and got.shape == c.shape
    torch.testing.assert_close(got.double(), ref.trsm_ref(l, c).double(),
                               atol=20 * tol, rtol=20 * tol)
    _check_blocked("trsm", got, (l, c))


# SYRK entry by entry at each entry's own scale, W = |C| + |A||A|^T
# (chip_smoke.py's syrk_ratio): two f32 sums of K products differ by at
# most 2 (K + 2) 2^-24 W, and a bf16 output's rounding adds 2^-8 W.  The
# control, the plain version without the last rank's K chunk of the
# cluster split, must fail wherever it moves a diagonal entry by more
# than 4 allowances (always in f32; not at M = K = 1 in bf16).
_SYRK_SIZES = [1, 31, 33, 100, 257, 513]


def _syrk_tol(dtype, k):
    return (2.0 ** -8 if dtype == torch.bfloat16 else 0.0) + \
        2 * (k + 2) * 2.0 ** -24


def _syrk_ratio(got, c, a):
    want = ref.syrk_update_ref(c, a)
    ad = a.double()
    w = c.double().abs() + ad.abs() @ ad.abs().T
    return float(((got.double() - want.double()).abs()
                  / (_syrk_tol(got.dtype, a.shape[1]) * w).clamp_min(1e-300))
                 .max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", _SYRK_SIZES)
@pytest.mark.parametrize("m", _SYRK_SIZES)
def test_cuda_syrk_split_k_ragged(cuda, m, k, dtype):
    from repro_torch.kernels import syrk
    dt, tol = _TORCH[dtype], _tol(dtype)
    rng = np.random.default_rng([m, k])
    x = rng.standard_normal((m, m)) / np.sqrt(m)
    c = torch.from_numpy(x @ x.T + 2.0 * np.eye(m)).to(cuda, dt)
    a = torch.from_numpy(rng.standard_normal((m, k))).to(cuda, dt)
    ops.reset_counts()
    got = ops.syrk_update(c, a)
    torch.cuda.synchronize()
    assert ops.launch_counts()["syrk_update"] == 1
    assert got.dtype == dt
    torch.testing.assert_close(got.double(), ref.syrk_update_ref(c, a).double(),
                               atol=max(m, k) * tol / 16, rtol=tol)
    assert torch.equal(got, got.T)
    assert _syrk_ratio(got, c, a) <= 1.0
    split, chunk = syrk.split_for(k)
    lo = syrk.chunk_bounds(k, split, chunk)[-1][0]
    control = ref.syrk_update_ref(c, a[:, :lo].contiguous())
    ad = a.double()
    moved = (ad[:, lo:] ** 2).sum(dim=1)
    w = c.double().diagonal().abs() + (ad ** 2).sum(dim=1)
    if bool((moved / w > 4 * _syrk_tol(dt, k)).any()):
        assert _syrk_ratio(control, c, a) > 1.0
    else:
        assert dt == torch.bfloat16 and m == k == 1


_GEMM_AB = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float8_e4m3fn": torch.float8_e4m3fn}


def _gemm_tol(dtype, k):
    """chip_smoke.py's: two f32 sums of k products in different orders, and
    for a bf16 output the kernel's and the plain version's roundings, half
    an ulp each (a whole ulp, 2^-7 of W, where the sums straddle a rounding
    boundary)."""
    return (2.0 ** -7 if dtype == torch.bfloat16 else 0.0) + \
        2 * (k + 2) * 2.0 ** -24


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", DTYPES)
@pytest.mark.parametrize("ab_dtype", list(_GEMM_AB))
@pytest.mark.parametrize("k", _SYRK_SIZES)
@pytest.mark.parametrize("m", _SYRK_SIZES)
def test_cuda_gemm_split_k_ragged(cuda, m, k, ab_dtype, c_dtype):
    """The cluster split-K GEMM at ragged M, N (every size) and K, each
    entry at its own scale W = |C| + |A| |B|^T (_gemm_tol); the plain version
    without the last rank's K chunk must fail that check wherever the chunk
    moves some entry by more than four allowances."""
    from repro_torch.kernels import mxp_gemm
    ab, cdt = _GEMM_AB[ab_dtype], _TORCH[c_dtype]
    tol = _tol(c_dtype)
    for n in _SYRK_SIZES:
        rng = np.random.default_rng([m, n, k])
        c = torch.from_numpy(rng.standard_normal((m, n))).to(cuda, cdt)
        a = torch.from_numpy(rng.standard_normal((m, k))).to(cuda, ab)
        b = torch.from_numpy(rng.standard_normal((n, k))).to(cuda, ab)
        ops.reset_counts()
        got = ops.gemm_update(c, a, b)
        torch.cuda.synchronize()
        assert ops.launch_counts()["mxp_gemm_update"] == 1
        assert got.dtype == cdt
        want = ref.gemm_update_ref(c, a, b)
        torch.testing.assert_close(got.double(), want.double(),
                                   atol=max(m, n, k) * tol / 16, rtol=tol)
        w = c.double().abs() + a.double().abs() @ b.double().abs().T
        allow = _gemm_tol(cdt, k) * w

        def ratio(x):
            return float(((x.double() - want.double()).abs()
                          / allow.clamp_min(1e-300)).max())
        assert ratio(got) <= 1.0, (n, ratio(got))
        split, chunk = mxp_gemm.split_for(m, n, k)
        lo = mxp_gemm.chunk_bounds(k, split, chunk)[-1][0]
        control = ref.gemm_update_ref(c, a[:, :lo].contiguous(),
                                      b[:, :lo].contiguous())
        moved = (a.double()[:, lo:] @ b.double()[:, lo:].T).abs()
        if bool((moved > 4 * allow).any()):
            assert ratio(control) > 1.0, (n, split, ratio(control))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4])
def test_cuda_gemm_every_geometry_agrees(cuda, split):
    """The splits the geometry benchmark times beside the wrapper's (8 at
    512^3) compute the same update within the f32 sum-order allowance."""
    from repro_torch.kernels import mxp_gemm
    n = 512
    c = torch.from_numpy(_spd(n)).to(cuda)
    a = torch.from_numpy(_mat(n)).to(cuda)
    b = torch.from_numpy(_mat(n, seed=5)).to(cuda)
    got = mxp_gemm._launch(c, a, b, *mxp_gemm.split_for(n, n, n, split))
    want = ref.gemm_update_ref(c, a, b)
    w = c.double().abs() + a.double().abs() @ b.double().abs().T
    err = (got.double() - want.double()).abs() / (_gemm_tol(c.dtype, n) * w)
    assert float(err.max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_potrf_nan_from_a_pivot_inside_a_block(cuda, dtype):
    """The leading minor first fails at j = 100, inside the second 64-wide
    block: columns < j are the factor of the leading j x j part, and every
    lower entry of columns >= j is NaN, as the reference's column loop
    (repro/kernels/potrf.py) gives through its sqrt."""
    j, n = 100, 256
    a = _spd(n, seed=3).astype(np.float64)
    a[j, j] = -5.0                      # the pivot at j is below zero
    assert np.all(np.linalg.eigvalsh(a[:j, :j]) > 0)
    dt = _TORCH[dtype]
    t = torch.from_numpy(a).to(cuda, dt)
    got = ops.potrf(t).double()
    torch.cuda.synchronize()
    td = t.double()
    lead = torch.linalg.cholesky(td[:j, :j])
    below = torch.linalg.solve_triangular(lead.T, td[j:, :j], upper=True,
                                          left=False)
    torch.testing.assert_close(got[:, :j], torch.cat([lead, below]),
                               atol=_tol(dtype), rtol=_tol(dtype))
    lower = torch.tril(torch.ones(n - j, n - j, dtype=torch.bool,
                                  device=cuda))
    assert torch.isnan(got[j:, j:][lower]).all()
    assert not torch.isnan(got[:, :j]).any()


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


@pytest.mark.cuda
def test_cuda_geo_fused_mxp_factor(cuda):
    """The geospatial path at n = 2048: a weakly correlated Matérn
    covariance built on the card and planned on the ``gpu`` ladder, whose
    plan holds unscaled e4m3 tiles, factored in f64 through the fused
    kernel (nt launches, no per-op launch) and unfused.  The two agree
    tile by tile within max(1e-12, 4 EPS[class]) max|L| plus four f32
    quanta of the largest f32 tile (chip_smoke.py's check); the same plan
    with its least f32 tile stored as e4m3 does not, though its own fused
    and unfused factors agree.  The fused factor keeps the plan's backward
    error."""
    import dataclasses

    import repro_torch
    from repro_torch.core.precision import PrecisionPlan
    from repro_torch.geo import generate_locations, matern_covariance
    from repro_torch.geo.matern import BETA_WEAK
    n, tb, eps = 2048, 128, 1e-6
    nt = n // tb
    cov = matern_covariance(generate_locations(n, 0), beta=BETA_WEAK,
                            device=cuda)
    cfg = repro_torch.CholeskyConfig(
        tb=tb, ladder="gpu", eps_target=eps, use_pallas=True,
        fuse_columns=True).specialize(cov)
    plan = cfg.plan
    hist = plan.histogram()
    assert hist["f8e4m3"] > 0 and sum(v > 0 for v in hist.values()) >= 3

    def factor(c):
        solver = repro_torch.plan(n, c).compile(device=cuda)
        ops.reset_counts()
        solver.factor(cov, materialize=False)
        tiles = solver.tiles.to(cuda)
        return (torch.tril(tiles.permute(0, 2, 1, 3).reshape(n, n)),
                ops.launch_counts())

    def blk(x, i, j):
        return x[i * tb:(i + 1) * tb, j * tb:(j + 1) * tb]

    lf, counts = factor(cfg)
    assert counts.pop("fused_column_step") == nt
    assert set(counts.values()) == {0}
    lu, _ = factor(dataclasses.replace(cfg, fuse_columns=False))
    # the control: the f32 tile with the smallest entries stored as e4m3,
    # which puts values inside e4m3's range through the e4m3 epilogue
    f32, e4m3 = plan.ladder.index("f32"), plan.ladder.index("f8e4m3")
    ci, cj = min(((i, j) for i in range(nt) for j in range(i)
                  if plan.classes[i, j] == f32),
                 key=lambda t: float(blk(cov, *t).abs().max()))
    classes = plan.classes.copy()
    classes[ci, cj] = classes[cj, ci] = e4m3
    ctrl = dataclasses.replace(cfg, plan=PrecisionPlan(classes, plan.ladder,
                                                       eps))
    lc, _ = factor(ctrl)
    lcu, _ = factor(dataclasses.replace(ctrl, fuse_columns=False))
    assert int(blk(lcu, ci, cj).count_nonzero()) > 0

    def ratio(l, lu, plan):
        scale = float(lu.abs().max())
        flip = max(4 * _EPS["f32"] * float(blk(lu, i, j).abs().max())
                   for i in range(nt) for j in range(i + 1)
                   if plan.name(i, j) == "f32")
        return max(float((blk(l, i, j) - blk(lu, i, j)).abs().max())
                   / (max(1e-12, 4 * _EPS[plan.name(i, j)]) * scale
                      + 4 * flip)
                   for i in range(nt) for j in range(i + 1))

    assert ratio(lf, lu, plan) <= 1.0
    assert ratio(lc, lcu, ctrl.plan) <= 1.0
    assert not ratio(lc, lu, plan) <= 1.0
    backward = torch.linalg.norm(lf @ lf.T - cov) / torch.linalg.norm(cov)
    assert float(backward) <= eps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tb", [512, 1024])
def test_cuda_fused_nan_from_a_pivot_inside_a_block(cuda, tb, dtype):
    """The diagonal tile's leading minor first fails at j = 100, inside the
    second 64-wide block: row 0 is the leading factor left of j and NaN in
    every lower entry from j on, as the plain column loop gives through its
    sqrt; a later row's solve is finite left of j and NaN from j on."""
    from repro_torch.kernels import fused_column
    dt = torch.float32 if dtype == "float32" else torch.float64
    j = 100
    a = _spd(tb, seed=3).astype(np.float64)
    a[j, j] = -5.0
    assert np.all(np.linalg.eigvalsh(a[:j, :j]) > 0)
    row = np.random.default_rng(4).standard_normal((tb, tb))
    c = torch.from_numpy(np.stack([a, row])).to(cuda, dt)
    got = fused_column.fused_column_step(
        c, c.new_empty((2, 0, tb, tb)), c.new_empty((0, tb, tb)), c[0],
        [-1, -1], ladder=_LADDER, with_diag=True).double()
    torch.cuda.synchronize()
    cd = c.double()
    lead = torch.linalg.cholesky(cd[0, :j, :j])
    below = torch.linalg.solve_triangular(lead.T, cd[0, j:, :j], upper=True,
                                          left=False)
    tol = 1e-12 if dt == torch.float64 else _tol("float32")
    torch.testing.assert_close(got[0, :, :j], torch.cat([lead, below]),
                               atol=tol, rtol=tol)
    lower = torch.tril(torch.ones(tb - j, tb - j, dtype=torch.bool,
                                  device=cuda))
    assert torch.isnan(got[0, j:, j:][lower]).all()
    assert not torch.isnan(got[0, :, :j]).any()
    assert torch.isfinite(got[1, :, :j]).all()
    assert torch.isnan(got[1, :, j:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_fused_phase_controls(cuda, dtype):
    """The in-launch factor and the row solves alone (R = 1, K = 0) each
    pass the row check, and a version that leaves one 64 x 64 block update
    out of each (the trailing tile (last, 1) of the factor's first step;
    the block (J, J - 1) of the solve) fails it; the f32 factor is also
    held to POTRF's per-block residual, which the control fails too."""
    from repro_torch.kernels import fused_column
    dt = torch.float32 if dtype == "float32" else torch.float64
    tb = 512
    cls = "f64" if dt == torch.float64 else "f32"
    tol = _fused_tol(cls, tb, dt)
    spd = _spd(tb, seed=7).astype(np.float64)   # off-diagonal 1/sqrt(tb)
    l_kk = torch.from_numpy(np.linalg.cholesky(spd)).to(cuda, dt)
    hist = torch.empty((1, 0, tb, tb), dtype=dt, device=cuda)
    bhist = torch.empty((0, tb, tb), dtype=dt, device=cuda)
    for with_diag in (True, False):
        tile = spd if with_diag else _mat(tb, seed=8)
        c = torch.from_numpy(tile[None].copy()).to(cuda, dt)
        kw = dict(ladder=_LADDER, with_diag=with_diag)
        got = fused_column.fused_column_step(c, hist, bhist, l_kk, [-1], **kw)
        want = fused_column.fused_column_step_ref(c, hist, bhist, l_kk, [-1],
                                                  **kw)
        if with_diag:
            control = _potrf_dropped_update(c[0]).to(dt)
        else:
            control = _trsm_dropped_block(l_kk, c[0])
        scale = want.double().abs().max()
        err = float((got.double() - want.double()).abs().max() / scale)
        ctrl = float((control.double() - want[0].double()).abs().max() / scale)
        assert err <= tol and ctrl > tol, (with_diag, err, ctrl)
        if with_diag and dt == torch.float32:
            assert _potrf_backward(got[0], c[0]) <= BACKWARD_C
            assert _potrf_backward(control, c[0]) > BACKWARD_C


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

_FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}    # tests/test_flash_attention.py
# each output row at its own scale (chip_smoke.py's FLASH_ROW_TOL and
# FLASH_ACC): one ulp of the row's largest value, plus _FLASH_ACC f32 quanta
# of max|v| for the two summation orders
_FLASH_ROW_TOL = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
_FLASH_ACC = 8


# chip_smoke.py's FLASH_MISMATCH_BOUND: the share of bf16 outputs that may
# differ from the plain version's (the card reads at most 0.0172, at long
# KV); the plain version with P rounded to bf16 must read above it (0.381
# or more)
_MISMATCH_BOUND = 0.05


def _flash_row_ratio(got, want, v, tol):
    """The worst row's max|got - want| over its allowance."""
    err = (got.double() - want.double()).abs().amax(dim=-1)
    allow = (tol * want.double().abs().amax(dim=-1)
             + _FLASH_ACC * 2.0 ** -24 * float(v.abs().max()))
    return float((err / allow).max())


def _check_flash(fa, q, k, v, causal, dtype):
    """One launch of the kernel that the dtype and head dim pick, against
    the plain version: the tolerance, the row check and its two controls,
    and for bf16 the mismatch share and its bf16-P control."""
    hd = q.shape[-1]
    s, t = q.shape[1], k.shape[1]
    blk = {"bq": s, "bk": t}        # any S and T (the kernels tile alone)
    ops.reset_counts()
    got = fa.flash_gqa(q, k, v, causal=causal, **blk)
    want = fa.flash_gqa_ref(q, k, v, causal=causal, **blk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    kind = "tensor_core" if dtype == "bfloat16" else "ffma"
    assert ops.flash_variant_counts() == {
        "tensor_core": int(kind == "tensor_core"), "ffma": int(kind == "ffma")}
    assert got.dtype == _TORCH[dtype] and got.shape == q.shape
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.double(), want.double(), atol=tol, rtol=tol)
    row_tol = _FLASH_ROW_TOL[dtype]
    assert _flash_row_ratio(got, want, v, row_tol) <= 1.0
    dropped = fa.flash_gqa_ref(q, k[:, :-64], v[:, :-64], causal=causal,
                               bq=s, bk=t - 64)
    assert _flash_row_ratio(got, dropped, v, row_tol) > 1.0
    assert _flash_row_ratio(torch.zeros_like(got), want, v, row_tol) > 1.0
    if dtype == "bfloat16":
        share = float((got != want).float().mean())
        ctrl = float((fa.flash_gqa_ref(q, k, v, causal=causal, p_mode="bf16",
                                       **blk) != want).float().mean())
        assert share <= _MISMATCH_BOUND, (hd, share)
        assert ctrl > _MISMATCH_BOUND, (hd, ctrl)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 5, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_cuda_flash_matches_plain(cuda, hd, causal, dtype, group):
    """The kernel against flash_gqa_ref in model layout: causal at S = T =
    256, full at S = 100, T = 200 (ragged query and KV tiles).  bf16 takes
    the tensor-core kernel, f32 the FFMA one (the variant counts say
    which).  Each row is held at its own scale, and that check must reject
    the plain version without the last 64 keys (a dropped KV tile) and a
    zeroed output; a bf16 output is also held by its mismatch share, which
    the plain version with P rounded to bf16 must fail."""
    from repro_torch.kernels import flash_attention as fa
    dt = _TORCH[dtype]
    b, kv = 2, 2
    s, t = (256, 256) if causal else (100, 200)
    rng = np.random.default_rng(hd + group)

    def rand(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(cuda, dt)

    q, k, v = rand(b, s, kv * group, hd), rand(b, t, kv, hd), rand(b, t, kv, hd)
    got = _check_flash(fa, q, k, v, causal, dtype)
    # the [BH, S, hd] layout of flash_attention gives the same values
    flat = fa.flash_attention(q.transpose(1, 2).reshape(-1, s, hd).contiguous(),
                              k.transpose(1, 2).reshape(-1, t, hd).contiguous(),
                              v.transpose(1, 2).reshape(-1, t, hd).contiguous(),
                              causal=causal)
    assert torch.equal(flat.reshape(b, -1, s, hd).transpose(1, 2), got)


_TC_SHAPES = {             # (B, S, T, causal)
    "S=200 causal": (2, 200, 200, True),     # S not a multiple of 128
    "T!=S full": (1, 256, 1000, False),
    "long KV": (1, 128, 16384, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 5, 8])
@pytest.mark.parametrize("hd", [64, 128, 192, 256])
@pytest.mark.parametrize("shape", list(_TC_SHAPES))
def test_cuda_flash_tensor_cores(cuda, shape, hd, group):
    """The tensor-core kernel at every head dim over ragged query rows, a
    cross-length full mask and a long KV stream (256 tiles through the
    ring), with 1, 5 and 8 query heads a KV head."""
    from repro_torch.kernels import flash_attention as fa
    b, s, t, causal = _TC_SHAPES[shape]
    kv = 2
    rng = np.random.default_rng([hd, group, s, t])

    def rand(*shp):
        x = rng.standard_normal(shp).astype(np.float32)
        return torch.from_numpy(x).to(cuda, torch.bfloat16)

    q, k, v = rand(b, s, kv * group, hd), rand(b, t, kv, hd), rand(b, t, kv, hd)
    _check_flash(fa, q, k, v, causal, "bfloat16")


@pytest.mark.cuda
def test_cuda_flash_ffma_kernel_on_bf16(cuda):
    """``kernel="ffma"`` runs the FFMA kernel on bf16 inputs (chip_smoke.py
    times it beside the tensor-core kernel): it counts as ffma and agrees
    with the tensor-core output within one bf16 ulp of each value plus the
    split's 2^-17 of each p, which moves a weighted mean of v by up to
    2^-17 max|v| (2^-15 max|v| allowed: both kernels' f32 sums too)."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shp).astype(
        np.float32)).to(cuda, torch.bfloat16)
        for shp in ((1, 256, 8, 128), (1, 256, 2, 128), (1, 256, 2, 128)))
    ops.reset_counts()
    ffma = fa.flash_gqa(q, k, v, kernel="ffma")
    tc = fa.flash_gqa(q, k, v)
    torch.cuda.synchronize()
    assert ops.flash_variant_counts() == {"tensor_core": 1, "ffma": 1}
    assert ops.launch_counts()["flash_attention"] == 2
    torch.testing.assert_close(ffma.float(), tc.float(),
                               atol=2.0 ** -15 * float(v.abs().max()),
                               rtol=2.0 ** -7)


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
    assert ops.flash_variant_counts() == {"tensor_core": cfg.num_layers,
                                          "ffma": 0}
    want = make_prefill_step(cfg, flash=flash_gqa_ref)(params,
                                                       {"tokens": tokens})
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    v = cfg.vocab
    assert torch.isfinite(got[:, :v]).all()
    assert (got[:, v:] <= -1e29).all()
    torch.testing.assert_close(got[:, :v].float(), want[:, :v].float(),
                               atol=4 * 2.0 ** -8 * 4, rtol=0)


# --------------------------------------------------------------------------
# MoE and MLA serving: plain products on the card, no kernel of the port
# --------------------------------------------------------------------------

# f32 products on the card and on the CPU in other orders (TF32 stays off,
# PyTorch's default), over values of order 1
_MOE_TOL = 1e-5


def _moe_module(cfg, device):
    from repro_torch.models import moe as M
    return M.MoE(cfg, torch.Generator(device=device).manual_seed(0), device)


@pytest.mark.cuda
def test_cuda_moe_bitwise_run_to_run_and_against_cpu(cuda):
    """deepseek's smoke MoE layer (shared and routed experts) at capacity
    factor 1, which drops assignments: two calls on the card bitwise
    equal (the combine adds in one fixed order, no atomics), and the same
    call on the CPU with the same weights within f32's reach."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                              moe_capacity=1.0)
    p = _moe_module(cfg, cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32) * 0.5).to(cuda)
    ops.reset_counts()
    a = M.apply_moe(p, cfg, x)
    b = M.apply_moe(p, cfg, x)
    assert set(ops.launch_counts().values()) == {0}
    assert torch.equal(a, b)
    t = x.shape[0] * x.shape[1]
    cap = M.capacity(t, cfg.top_k, cfg.n_experts, cfg.moe_capacity)
    _, idx = M.route(p, cfg, x.reshape(t, -1))
    keep = M._dispatch(x.reshape(t, -1), idx, 1, cfg.n_experts, cap)[2]
    assert 0 < int(keep.sum()) < keep.numel()
    p_cpu = M.MoE(cfg, None, "meta")
    p_cpu.load_state_dict({k: v.cpu() for k, v in p.state_dict().items()},
                          assign=True)
    want = M.apply_moe(p_cpu, cfg, x.cpu())
    torch.testing.assert_close(a.cpu(), want, atol=_MOE_TOL, rtol=_MOE_TOL)


@pytest.mark.cuda
def test_cuda_moe_decode_dispatch_needs_no_host_sync(cuda):
    """A decode step's MoE call, 4 tokens at capacity 8, under
    ``set_sync_debug_mode("error")``: routing, dispatch, experts and
    combine queue without one host synchronisation."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                              moe_capacity=1.25, dtype="bfloat16")
    assert M.capacity(4, cfg.top_k, cfg.n_experts, 1.25) == 8
    p = _moe_module(cfg, cuda)
    x = torch.randn(4, 1, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5),
                    dtype=torch.bfloat16)
    M.apply_moe(p, cfg, x)                  # first calls may sync to load
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = M.apply_moe(p, cfg, x)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_cuda_decode_mla_against_cpu(cuda):
    """deepseek's smoke MLA decoded step by step on the card and on the
    CPU with the same weights: outputs and caches within f32's reach."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    p = A.MLA(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    p_cpu = A.MLA(cfg, None, "meta")
    p_cpu.load_state_dict({k: v.cpu() for k, v in p.state_dict().items()},
                          assign=True)
    b, n = 2, 12
    xs = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32) * 0.5)
    cache = A.init_mla_cache(cfg, b, n + 4, torch.float32, device=cuda)
    cache_cpu = A.init_mla_cache(cfg, b, n + 4, torch.float32, device="cpu")
    for pos in range(n):
        got, cache = A.decode_mla(p, cfg, xs[:, pos:pos + 1].to(cuda), cache,
                                  pos)
        want, cache_cpu = A.decode_mla(p_cpu, cfg, xs[:, pos:pos + 1],
                                       cache_cpu, pos)
        torch.testing.assert_close(got.cpu(), want, atol=_MOE_TOL,
                                   rtol=_MOE_TOL)
    for key in cache:
        torch.testing.assert_close(cache[key].cpu(), cache_cpu[key],
                                   atol=_MOE_TOL, rtol=_MOE_TOL)


@pytest.mark.cuda
def test_cuda_dbrx_prefill_launches_flash_per_layer(cuda):
    """dbrx's smoke model (GQA ahead of routed experts) in bf16 at S = 128,
    head_dim 64: one tensor-core flash launch per layer, and no other
    kernel of the port."""
    import dataclasses

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("dbrx-132b", smoke=True),
                              head_dim=64, dtype="bfloat16",
                              use_flash_attention=True)
    params = T.init_model(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 128))).to(cuda)
    repro_torch.reset_counts()
    got = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert repro_torch.launch_counts() == {
        **dict.fromkeys(repro_torch.launch_counts(), 0),
        "flash_attention": cfg.num_layers}
    assert ops.flash_variant_counts() == {"tensor_core": cfg.num_layers,
                                          "ffma": 0}
    assert torch.isfinite(got[:, :cfg.vocab]).all()


# --------------------------------------------------------------------------
# SSM, hybrid, frontend and encoder-decoder models: the smoke configs on the
# card against the same weights on the CPU (f32, plain products: no kernel
# of the port but flash)
# --------------------------------------------------------------------------

_MODEL_TOL = 1e-4      # f32 products over a few layers, in other orders


def _card_and_cpu(cfg, cuda):
    """A seeded model on the card and a CPU copy of its weights."""
    from repro_torch.models import transformer as T
    params = T.init_model(cfg, seed=0, device=cuda)
    cpu = T.Model(cfg, None, "meta")
    cpu.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()},
                        assign=True)
    return params, cpu


def _model_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    kw = {}
    if cfg.frontend:
        kw["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32) * 0.5)
    if cfg.is_encdec:
        kw["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32) * 0.5)
    return tokens, kw


def _prefill_and_decode_against_cpu(cfg, cuda):
    """The prefill's logits at every position, then ten decode steps
    (cross-attending to the encoder's output where the model has one), each
    step's logits and every layer's cache after it, on the card against
    the CPU."""
    import repro_torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T
    params, cpu = _card_and_cpu(cfg, cuda)
    b = 2
    tokens, kw = _model_inputs(cfg, b, 2 * cfg.ssm_chunk, 8)
    repro_torch.reset_counts()
    h = T.forward(params, cfg, tokens.to(cuda),
                  **{k: v.to(cuda) for k, v in kw.items()})
    got = T.logits_from_hidden(params, cfg, h)
    assert set(repro_torch.launch_counts().values()) == {0}
    want = T.logits_from_hidden(cpu, cfg, T.forward(cpu, cfg, tokens, **kw))
    torch.testing.assert_close(got.cpu(), want, atol=_MODEL_TOL,
                               rtol=_MODEL_TOL)
    enc = enc_cpu = None
    if cfg.is_encdec:
        enc_cpu = T.apply_encoder(cpu, cfg, kw["enc_embeds"])
        enc = T.apply_encoder(params, cfg, kw["enc_embeds"].to(cuda))
        torch.testing.assert_close(enc.cpu(), enc_cpu, atol=_MODEL_TOL,
                                   rtol=_MODEL_TOL)
    n_steps = 10
    cache = T.init_cache(cfg, b, n_steps, torch.float32, device=cuda)
    cache_cpu = T.init_cache(cfg, b, n_steps, torch.float32, device="cpu")
    step = make_serve_step(cfg)
    for pos in range(n_steps):
        tok = tokens[:, pos:pos + 1]
        got, cache = step(params, cache, tok.to(cuda), pos, enc)
        want, cache_cpu = step(cpu, cache_cpu, tok, pos, enc_cpu)
        torch.testing.assert_close(got.cpu(), want, atol=_MODEL_TOL,
                                   rtol=_MODEL_TOL)
        for c, cc in zip(cache, cache_cpu):
            for key in c:
                torch.testing.assert_close(c[key].cpu(), cc[key],
                                           atol=_MODEL_TOL, rtol=_MODEL_TOL)


@pytest.mark.cuda
def test_cuda_mamba2_smoke_against_cpu(cuda):
    """mamba2's smoke model (SSM layers, tied embeddings): the chunked scan
    over two chunks and the recurrent decode with its window and state."""
    from repro_torch.configs import get_config
    _prefill_and_decode_against_cpu(get_config("mamba2-130m", smoke=True),
                                    cuda)


@pytest.mark.cuda
def test_cuda_jamba_smoke_whole_interleave_against_cpu(cuda):
    """jamba's smoke model whole: two scanned groups of 4 (SSM layers,
    attention at j = 3, the MoE FFN at odd j), prefill and decode."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("jamba-1-5-large-398b", smoke=True)
    kinds = [(cfg.layer_kind(i), cfg.layer_is_moe(i))
             for i in T.layer_indices(cfg)]
    assert kinds == [("ssm", False), ("ssm", True), ("ssm", False),
                     ("attn", True)] * 2
    _prefill_and_decode_against_cpu(cfg, cuda)


@pytest.mark.cuda
def test_cuda_seamless_smoke_decode_with_enc_out_against_cpu(cuda):
    """seamless's smoke model: the encoder, the prefill with frontend and
    encoder inputs, and decode steps cross-attending to ``enc_out``."""
    from repro_torch.configs import get_config
    _prefill_and_decode_against_cpu(
        get_config("seamless-m4t-large-v2", smoke=True), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-large-v2"])
def test_cuda_frontend_and_encdec_prefill_launch_flash_per_layer(cuda, arch):
    """llava's and seamless's smoke models in bf16 at S = 128, head_dim 64,
    with their frontend embeddings and encoder frames: one tensor-core
    flash launch per decoder layer (seamless's encoder and cross-attention
    take the chunked path), no other kernel of the port."""
    import dataclasses

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch, smoke=True), head_dim=64,
                              dtype="bfloat16", use_flash_attention=True)
    params = T.init_model(cfg, seed=0, device=cuda)
    tokens, kw = _model_inputs(cfg, 2, 128, 9)
    repro_torch.reset_counts()
    got = make_prefill_step(cfg)(params, {
        "tokens": tokens.to(cuda), **{k: v.to(cuda) for k, v in kw.items()}})
    torch.cuda.synchronize()
    assert repro_torch.launch_counts() == {
        **dict.fromkeys(repro_torch.launch_counts(), 0),
        "flash_attention": cfg.num_layers}
    assert ops.flash_variant_counts() == {"tensor_core": cfg.num_layers,
                                          "ffma": 0}
    assert torch.isfinite(got[:, :cfg.vocab]).all()


# --------------------------------------------------------------------------
# the multi-device executor, four logical devices on one card
# --------------------------------------------------------------------------

def _md_factor(cfg, n, a, devices):
    """Factor ``a`` twice under ``cfg`` on ``devices``: (the solver, the
    first factor's tiles, its launches); the second factor must equal the
    first bitwise (a missing event wait would show as a difference)."""
    import repro_torch
    solver = repro_torch.plan(n, cfg).compile(device=devices)
    ops.reset_counts()
    solver.factor(a, materialize=False)
    launches = ops.launch_counts()
    first = solver.tiles.clone()
    solver.factor(a, materialize=False)
    assert torch.equal(first, solver.tiles)
    return solver, first, launches


@pytest.mark.cuda
def test_cuda_multidevice_mxp_2d_grid_on_one_card(cuda):
    """chip_smoke.py's config B at n = 2048, tb = 128 on ``[cuda:0] * 4``:
    a KMS matrix on ``gpu-scaled`` (scaled FP8 wires), f64, grid (2, 2),
    lookahead 1, unfused and fused, each held against the NumPy replay of
    the same schedule within the reference's MxP cross-backend tolerance,
    1e-8 (tests/test_backend_equivalence.py), and fused against unfused
    within the same; executed transfers against the schedule through
    ``crosscheck_executed_volume``."""
    import dataclasses

    import repro_torch
    from repro_torch.core.cholesky import run_multidevice_numpy
    from repro_torch.core.tiling import from_tiles, to_tiles
    n, tb = 2048, 128
    idx = np.arange(n)
    a = 0.99 ** np.abs(idx[:, None] - idx[None, :])
    devices = [cuda] * 4
    cfg = repro_torch.CholeskyConfig(
        tb=tb, ladder="gpu-scaled", eps_target=1e-6, use_pallas=True,
        ndev=4, grid=(2, 2), lookahead=1).specialize(a)
    assert cfg.plan.histogram()["f8e4m3s"] > 0
    want = run_multidevice_numpy(to_tiles(a, tb),
                                 repro_torch.plan(n, cfg).schedule)
    lw = np.tril(from_tiles(want))
    factors = {}
    for fuse in (False, True):
        solver, tiles, launches = _md_factor(
            dataclasses.replace(cfg, fuse_columns=fuse), n, a, devices)
        if fuse:
            assert launches["fused_column_step"] > 0
        factors[fuse] = np.tril(from_tiles(tiles.numpy()))
        assert np.abs(factors[fuse] - lw).max() < 1e-8, fuse
        cc = repro_torch.crosscheck_executed_volume(solver.schedule,
                                                    solver.transfer_stats())
        assert cc["match"], cc["mismatches"]
    assert np.abs(factors[True] - factors[False]).max() < 1e-8


@pytest.mark.cuda
def test_cuda_multidevice_f32_kernels_on_one_card(cuda):
    """chip_smoke.py's config A at n = 2048, tb = 256 on ``[cuda:0] * 4``:
    the per-op kernels, launched as often as the schedule has their ops,
    then the fused step; both within the f32 factor's reach of LAPACK and
    bitwise equal run to run."""
    import dataclasses

    import repro_torch
    from repro_torch.core.schedule import OpKind
    n, tb = 2048, 256
    a = _spd(n).astype(np.float64)
    cfg = repro_torch.CholeskyConfig(
        tb=tb, ladder="gpu", eps_target=1e-6, use_pallas=True,
        compute_dtype=torch.float32, ndev=4).specialize(a)
    want = np.linalg.cholesky(a)
    names = {"mxp_gemm_update": OpKind.GEMM, "syrk_update": OpKind.SYRK,
             "trsm": OpKind.TRSM, "potrf": OpKind.POTRF}
    for fuse in (False, True):
        solver, tiles, launches = _md_factor(
            dataclasses.replace(cfg, fuse_columns=fuse), n, a, [cuda] * 4)
        sched = solver.schedule
        if fuse:
            assert launches["fused_column_step"] > 0
        else:
            assert launches == {**dict.fromkeys(launches, 0), **{
                k: sched.count(op) for k, op in names.items()}}
        got = np.tril(tiles.permute(0, 2, 1, 3).reshape(n, n).double()
                      .numpy())
        assert np.abs(got - want).max() < 1e-4


@pytest.mark.cuda
def test_cuda_single_device_factor_on_the_last_card(cuda):
    """One device that is not the current one: the single-device executor
    issues its ops under that card, so its kernels launch there (they
    refuse operands of another card than the current one).  Unfused and
    fused, per-op and fused launches counted, against LAPACK."""
    import repro_torch
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA devices")
    card = torch.device("cuda", count - 1)
    n, tb = 1024, 256
    a = _spd(n).astype(np.float64)
    want = np.linalg.cholesky(a)
    for fuse in (False, True):
        cfg = repro_torch.CholeskyConfig(
            tb=tb, ladder="gpu", eps_target=1e-6, use_pallas=True,
            compute_dtype=torch.float32, fuse_columns=fuse).specialize(a)
        solver = repro_torch.plan(n, cfg).compile(device=card)
        ops.reset_counts()
        got = solver.factor(a)
        launches = ops.launch_counts()
        assert torch.cuda.current_device() != card.index
        if fuse:
            assert launches["fused_column_step"] > 0
        else:
            assert launches["potrf"] == n // tb
        assert np.abs(got - want).max() < 1e-4


# --------------------------------------------------------------------------
# the measured trace and the disk tier on the card
# --------------------------------------------------------------------------

def _traced_pair(cfg, n, a, devices):
    """The traced and the untraced unfused factor of ``cfg`` on
    ``devices``, with the trace: (traced tiles, untraced tiles, recorder,
    solver)."""
    import dataclasses

    import repro_torch
    unfused = dataclasses.replace(cfg, fuse_columns=False)
    solver = repro_torch.plan(n, cfg).compile(device=devices)
    rec = repro_torch.TraceRecorder()
    solver.factor(a, materialize=False, trace=rec)
    traced = solver.tiles.clone()
    base = repro_torch.plan(n, unfused).compile(device=devices)
    base.factor(a, materialize=False)
    return traced, base.tiles.clone(), rec, solver


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["single", "two-on-one-card"])
def test_cuda_traced_factor_one_span_per_op(cuda, layout):
    """A traced factor on the card: one fenced span per op (ALLOC/FREE
    included), in dispatch order, bitwise the untraced unfused factor,
    with the per-op kernels and no fused launch (the config asks for
    fused columns, which a traced run leaves out)."""
    import repro_torch
    n, tb = 1024, 256
    a = _spd(n).astype(np.float64)
    ndev = 1 if layout == "single" else 2
    cfg = repro_torch.CholeskyConfig(
        tb=tb, ladder="gpu", eps_target=1e-6, use_pallas=True,
        compute_dtype=torch.float32, fuse_columns=True,
        ndev=ndev).specialize(a)
    devices = cuda if ndev == 1 else [cuda] * 2
    ops.reset_counts()
    traced, base, rec, solver = _traced_pair(cfg, n, a, devices)
    sched = solver.schedule
    want = [op for _, op in sched.iter_dispatch_order()]
    assert len(rec) == len(want) and rec.dropped == 0
    assert [s.kind for s in rec.spans] == [op.kind.value for op in want]
    assert {s.device for s in rec.spans} == set(range(ndev))
    assert torch.equal(traced, base)
    assert all(s.t_end > s.t_start for s in rec.spans)


def _spill_groups_in_core(ex, tiles, device):
    """The spill executor's ops, grouped as it groups them, run against a
    full in-core store instead of the disk tier; the f64 factored store."""
    from repro_torch.core.cholesky import (_interpret_op, _new_io,
                                           _run_ops_fused)
    host = torch.from_numpy(tiles).to(ex.dtype)
    if device.type == "cuda":
        host = host.pin_memory()
    tb = ex.sched.tb
    slots = torch.zeros((ex._nslots, tb, tb), dtype=ex.dtype, device=device)
    lad, io = ex.sched.plan.ladder, _new_io()
    for seg in ex._segments:
        if seg[0] != "run":
            continue
        if ex._fuse:
            _run_ops_fused(seg[1], host, slots, lad, ex._kf, io)
        else:
            for op in seg[1]:
                _interpret_op(host, slots, op, lad, ex._kf, io)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return host.double().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_cuda_spill_executor_bitwise_incore(cuda, fuse, tmp_path):
    """``SpillTorchExecutor`` over a DiskTileStore on the card, twice, with
    the executed FETCH/SPILL counters and the H2D/D2H copies the
    schedule's.  The f64 store narrows to f32 on FETCH and widens on
    SPILL, both exact here, so the disk tier is pure bookkeeping: the
    factor is bitwise its own op groups run against an in-core store, and
    unfused bitwise the in-core executor's.  Fused, its groups end at each
    FETCH/SPILL, as the reference's do, where the in-core executor
    launches one a column: their f32 sums run in other orders, and the two
    agree to the f32 factor's accuracy, 1e-4 of LAPACK's."""
    import dataclasses

    import repro_torch
    from repro_torch.core.cholesky import SpillTorchExecutor
    from repro_torch.core.schedule import OpKind
    from repro_torch.core.tiling import to_tiles
    n, tb = 1024, 128
    a = _spd(n).astype(np.float64)
    cfg = repro_torch.CholeskyConfig(
        tb=tb, ladder="gpu", eps_target=1e-6, use_pallas=True,
        compute_dtype=torch.float32, fuse_columns=fuse).specialize(a)
    incore = repro_torch.plan(n, cfg).compile(device=cuda)
    incore.factor(a, materialize=False)
    want = incore.tiles.double().numpy()
    sched = repro_torch.plan(
        n, dataclasses.replace(cfg, host_slots=10)).single_schedule()
    ex = SpillTorchExecutor(sched, torch.float32, use_pallas=True,
                            device=cuda, fuse_columns=fuse)
    lower = np.tril(np.ones((n // tb, n // tb), bool))
    groups = _spill_groups_in_core(ex, to_tiles(a, tb), cuda)
    for run in range(2):
        store = repro_torch.DiskTileStore.from_tiles(
            str(tmp_path / f"{run}.npy"), to_tiles(a, tb))
        ops.reset_counts()
        io = ex.run_store(store)
        launches = ops.launch_counts()
        got = store.to_tiles()
        assert np.array_equal(got[lower], groups[lower]), run
        if fuse:
            assert np.abs(got[lower] - want[lower]).max() < 1e-4
        else:
            assert np.array_equal(got[lower], want[lower]), run
        assert ex.last_io_stats == {
            "fetch_ops": sched.count(OpKind.FETCH),
            "spill_ops": sched.count(OpKind.SPILL),
            "fetched_bytes": sched.fetch_bytes(),
            "spilled_bytes": sched.spill_bytes()}
        assert io["h2d_ops"] == sched.count(OpKind.LOAD)
        assert io["d2h_ops"] == sched.count(OpKind.STORE)
        if fuse:
            assert launches["fused_column_step"] > 0
        else:
            assert launches["potrf"] == n // tb


# --------------------------------------------------------------------------
# the tuner and the solver service on the card
# --------------------------------------------------------------------------

_CHOLESKY_KERNELS = ("mxp_gemm_update", "syrk_update", "trsm", "potrf",
                     "fused_column_step")


@pytest.mark.cuda
def test_cuda_calibrate_launches_every_kernel(cuda):
    """Calibration in f32 on the card times the hand-written kernels: each
    of the five Cholesky kernels launches, every rate is positive and
    finite, and ``mem_bytes`` is the card's total memory."""
    from repro_torch import tune
    ops.reset_counts()
    model = tune.calibrate(tb=128, repeats=2, transfer_sizes_mb=(1, 8),
                           compute_dtype=torch.float32, device=cuda)
    launches = ops.launch_counts()
    assert all(launches[k] > 0 for k in _CHOLESKY_KERNELS), launches
    assert model.mem_bytes == torch.cuda.mem_get_info(cuda)[1]
    rates = [r for per in model.kernel_flops.values() for r in per.values()]
    assert set(model.kernel_flops) == {"gemm", "syrk", "trsm", "potrf",
                                       "fused_column"}
    assert all(np.isfinite(r) and r > 0 for r in rates)
    assert model.h2d_bw > 0 and model.d2h_bw > 0
    assert model.launch_overhead > 0
    assert model.fingerprint == tune.hardware_fingerprint(cuda)


@pytest.mark.cuda
def test_cuda_tuned_plan_within_kernel_limits(cuda):
    """At n = 32768 the search offers the kernel route no tile past
    TRSM's, POTRF's or the fused step's limit; a tuned plan at a small n
    factors on the card with the schedule's launches."""
    import dataclasses

    import repro_torch
    from repro_torch import tune
    from repro_torch.core.schedule import OpKind
    from repro_torch.kernels import fused_column, potrf, trsm
    hw = repro_torch.HW["h100-pcie"]
    base = repro_torch.CholeskyConfig(tb=0, policy="auto", use_pallas=True,
                                      compute_dtype=torch.float32)
    for cfg, limit in ((base, min(trsm.MAX_N, potrf.MAX_N)),
                       (dataclasses.replace(base, fuse_columns=True),
                        fused_column.MAX_TB)):
        res = tune.search(32768, hw, cfg)
        assert all(c.config.tb <= limit for c in res.candidates)
    n = 2048
    a = _spd(n).astype(np.float64)
    res = tune.tune(n, dataclasses.replace(base, ladder="gpu"), hw=hw,
                    sample=a, eps_target=1e-6, use_db=False)
    solver = repro_torch.plan(n, res.config).compile(device=cuda)
    ops.reset_counts()
    l = solver.factor(a)
    launches = ops.launch_counts()
    sched = solver.schedule
    assert launches["potrf"] == sched.count(OpKind.POTRF)
    assert launches["mxp_gemm_update"] == sched.count(OpKind.GEMM)
    assert np.abs(l - np.linalg.cholesky(a)).max() < 1e-3


@pytest.mark.cuda
def test_cuda_serve_two_tenants_bitwise(cuda):
    """Two tenants served at once on the card: each factor and logdet
    bitwise its solo one, launches exactly twice the schedule's, solves
    within 1e-10 of the solo solver's."""
    import repro_torch
    from repro_torch.core.schedule import OpKind
    from repro_torch.serve import SolverService
    n, tb = 1024, 256
    cfg = repro_torch.CholeskyConfig(tb=tb, use_pallas=True,
                                     compute_dtype=torch.float32)
    mats = [_spd(n, seed).astype(np.float64) for seed in (3, 4)]
    b = np.random.default_rng(0).standard_normal((n, 3))
    solo = []
    for a in mats:
        s = repro_torch.plan(n, cfg).compile(device=cuda)
        s.factor(a, materialize=False)
        solo.append((s.tiles.clone(), s.logdet(), s.solve(b)))
    sched = repro_torch.plan(n, cfg).single_schedule()
    with SolverService(workers=2, device=cuda, batch_window=0.0) as svc:
        sess = [svc.session(f"t{i}", n, cfg) for i in range(2)]
        ops.reset_counts()
        for f in [s.factor_async(a) for s, a in zip(sess, mats)]:
            f.result(timeout=120)
        launches = ops.launch_counts()
        for s, (tiles, ld, x) in zip(sess, solo):
            assert torch.equal(s._solver.tiles, tiles)
            assert s.logdet() == ld
            np.testing.assert_allclose(s.solve(b), x, rtol=1e-10, atol=0)
    for kind, name in ((OpKind.GEMM, "mxp_gemm_update"),
                       (OpKind.SYRK, "syrk_update"), (OpKind.TRSM, "trsm"),
                       (OpKind.POTRF, "potrf")):
        assert launches[name] == 2 * sched.count(kind)
    assert launches["fused_column_step"] == 0


@pytest.mark.cuda
def test_cuda_distributed_baseline_on_one_card(cuda):
    """The baseline (``core/distributed.py``) on four logical devices of
    one card, each on a stream of its own, against cuSOLVER's f64 factor
    of the same matrix; the rows sent are the formula's bytes, and a
    second run is bitwise the first."""
    from repro_torch.core import distributed as dist
    n, tb, p = 4096, 256, 4
    nt = n // tb
    a = _spd(n).astype(np.float64)
    at = torch.from_numpy(a).to(cuda)
    lref = torch.linalg.cholesky(at).cpu().numpy()
    l, stats = dist.distributed_cholesky_with_stats(at, tb, p, [cuda] * p)
    assert np.abs(l - lref).max() / np.abs(a).max() < 1e-10
    assert stats.pop("factor_s") > 0
    assert stats == {"steps": nt, "bcast_copies": nt * (p - 1),
                     "bcast_bytes": dist.panel_broadcast_bytes(nt, tb, p)}
    assert np.array_equal(l, dist.distributed_cholesky(a, tb, p, [cuda] * p))


@pytest.mark.cuda
def test_cuda_shim_is_bitwise_the_planner_path(cuda):
    """``ooc_cholesky`` with the hand-written kernels: the planner path's
    factor bitwise, with the schedule's launches."""
    import warnings

    import repro_torch
    from repro_torch.core.schedule import OpKind
    n, tb = 1024, 256
    a = _spd(n).astype(np.float64)
    kw = dict(policy="v3", ladder="gpu", eps_target=1e-6, use_pallas=True,
              compute_dtype=torch.float32)
    ops.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        l, sched = repro_torch.ooc_cholesky(a, tb, device=cuda, **kw)
    launches = ops.launch_counts()
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    cfg = repro_torch.CholeskyConfig(tb=tb, **kw).specialize(a)
    solver = repro_torch.plan(n, cfg).compile(device=cuda)
    assert np.array_equal(l, solver.factor(a))
    for kind, name in ((OpKind.GEMM, "mxp_gemm_update"),
                       (OpKind.SYRK, "syrk_update"), (OpKind.TRSM, "trsm"),
                       (OpKind.POTRF, "potrf")):
        assert launches[name] == sched.count(kind)


# --------------------------------------------------------------------------
# training: a train step on the card against the CPU, flash under grad,
# resume
# --------------------------------------------------------------------------

# chip_smoke.py's phase 10e bounds: each gradient at its own scale within
# 1e-3 of the CPU's (f32, TF32 off), the loss and grad_norm within 1e-4,
# the parameters after a step within 0.2 lr where the gradient is not near
# 0; a zeroed mixer gradient reads 1.
_TRAIN_GRAD_TOL = 1e-3
_TRAIN_LOSS_TOL = 1e-4


@pytest.mark.cuda
def test_cuda_gemma3_smoke_train_step_against_cpu(cuda):
    """gemma3's smoke model (a scanned group of 6 under remat, 2 more
    layers, tied embeddings), two train steps of 2 microbatches on the card
    and on the CPU from the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma3-1b", smoke=True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    host = T.init_model(cfg, seed=0, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        model = T.Model(cfg, None, "meta")
        model.load_state_dict({k: v.clone().to(dev) for k, v in
                               host.state_dict().items()}, assign=True)
        model.requires_grad_(True)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(model, cfg, b)
        step = make_train_step(cfg, lr=1e-3, accum_steps=2)
        opt = adamw_init(model)
        metrics = []
        for _ in range(2):
            model, opt, m = step(model, opt, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[str(dev)] = (float(loss), grads, metrics)
    (l0, g0, m0), (l1, g1, m1) = out["cpu"], out[str(cuda)]
    assert abs(l1 - l0) <= _TRAIN_LOSS_TOL * abs(l0)
    for a, b in zip(m0, m1):
        for k in a:
            assert abs(a[k] - b[k]) <= _TRAIN_LOSS_TOL * abs(a[k]), (k, a, b)
    for k, g in g0.items():
        scale = float(g.abs().max())
        d = float((g1[k].cpu() - g).abs().max())
        assert d <= _TRAIN_GRAD_TOL * max(scale, 1e-30), k
        if k.endswith(("attn.wq", "attn.wk", "attn.wv")):
            # a zeroed gradient (a kernel that cuts it) fails the bound
            assert float(g1[k].abs().max()) > _TRAIN_GRAD_TOL * scale > 0, k


@pytest.mark.cuda
def test_cuda_flash_raises_under_grad(cuda):
    """Neither flash kernel has a backward: with an input that requires
    grad both wrappers raise on the card; under no_grad they launch."""
    from repro_torch.kernels import flash_attention as F
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 128, 2, 64, generator=g, device=cuda,
                    dtype=torch.bfloat16).requires_grad_(True)
    k = torch.randn(1, 128, 1, 64, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    ops.reset_counts()
    with pytest.raises(NotImplementedError, match="_flash_kernel"):
        F.flash_gqa(q, k, k)
    with pytest.raises(NotImplementedError, match="_flash_kernel"):
        F.flash_attention(q[0].transpose(0, 1), k[0].transpose(0, 1),
                          k[0].transpose(0, 1))
    assert F.launches == 0
    with torch.no_grad():
        out = F.flash_gqa(q, k, k)
    assert F.launches == 1 and out.grad_fn is None


@pytest.mark.cuda
def test_cuda_mamba2_smoke_resume_is_bitwise(cuda, tmp_path):
    """mamba2's smoke model through ``launch.train.train`` on the card: four
    steps straight against two, a checkpoint and a resume to four, with Q8
    moments: the parameters bitwise."""
    import signal

    from repro_torch.launch.train import train
    old = signal.getsignal(signal.SIGTERM)
    kw = dict(arch="mamba2-130m", smoke=True, batch=4, seq=32,
              quantized_opt=True, save_every=2, device=cuda)
    try:
        want, losses = train(**kw, steps=4, ckpt_dir=str(tmp_path / "a"))
        train(**kw, steps=2, ckpt_dir=str(tmp_path / "b"))
        got, resumed = train(**kw, steps=4, ckpt_dir=str(tmp_path / "b"))
    finally:
        signal.signal(signal.SIGTERM, old)
    assert resumed == losses[2:]
    for (k, a), b in zip(want.state_dict().items(),
                         got.state_dict().values()):
        assert torch.equal(a, b), k


# --------------------------------------------------------------------------
# The sharded path on one card: a (1, 1) mesh over a one-rank NCCL group
# --------------------------------------------------------------------------

@pytest.fixture
def card_mesh(cuda):
    """A (1, 1) ("data", "model") mesh over a world of one, closed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    mesh = make_smoke_mesh((1, 1), ("data", "model"))
    yield mesh
    dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_sharded_prefill_is_bitwise_with_flash_launches(cuda, card_mesh):
    """A two-layer dense model in bf16 at S = 256 with the flash flag on:
    its prefill through the DTensor path (parameters made DTensors in
    place) launches the tensor-core flash kernel once a layer on each
    rank's head block, and its logits are bitwise the unsharded step's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (P, activation_sharding,
                                                  distribute,
                                                  distribute_model, full)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("qwen3-14b", smoke=True),
                              head_dim=64, dtype="bfloat16",
                              use_flash_attention=True)
    params = T.init_model(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 256))).to(cuda)
    want = make_prefill_step(cfg)(params, {"tokens": tokens})
    distribute_model(params, card_mesh)
    ops.reset_counts()
    with activation_sharding(card_mesh):
        got = full(make_prefill_step(cfg)(params, {
            "tokens": distribute(tokens, P("data", None), card_mesh)}))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    assert ops.flash_variant_counts() == {"tensor_core": cfg.num_layers,
                                          "ffma": 0}
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma3-1b"])
def test_cuda_train_mesh_against_train(cuda, card_mesh, arch):
    """Three steps of two microbatches of a smoke model through
    ``train(mesh=)`` on the (1, 1) mesh and through ``train()``: the
    losses bitwise (gemma3's one kv head included: its key's gradient
    keeps the plain path's layout through ``sharding.contiguous_grad``)."""
    from repro_torch.launch.train import train
    kw = dict(arch=arch, steps=3, batch=4, seq=32, accum_steps=2,
              device=cuda, log_every=100)
    _, want = train(**kw)
    _, got = train(**kw, mesh=card_mesh)
    assert got == want


@pytest.mark.cuda
def test_cuda_compression_is_bitwise_the_cpu(cuda):
    """``compress_pod_gradients`` (local path) on the card and on the CPU,
    outputs and residuals bitwise, a ragged length included."""
    from repro_torch.optim.compress import compress_pod_gradients, ef_init
    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((3, 300)).astype(np.float32),
             "b": (rng.standard_normal(1152) * 1e-3).astype(np.float32)}
    out = {}
    for dev in ("cpu", cuda):
        g = {k: torch.from_numpy(v).to(dev) for k, v in grads.items()}
        ef = {k: v * 1e-3 for k, v in ef_init(g).items()}
        o, e = compress_pod_gradients(g, ef)
        o2, e2 = compress_pod_gradients(g, e)
        out[str(dev)] = [t.cpu() for d in (o, e, o2, e2) for t in d.values()]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(a, b)
