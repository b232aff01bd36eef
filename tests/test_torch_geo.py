"""The port's geospatial workload (``repro_torch.geo``) against the
reference's ``repro.geo``, on the CPU: locations, Matérn covariances, the
Gaussian log-likelihood and the MxP KL divergence."""
import numpy as np
import pytest
import torch

from repro.geo import kl as ref_kl
from repro.geo import likelihood as ref_lik
from repro.geo import matern as ref_matern

import repro_torch
from repro_torch.geo import (generate_locations, gaussian_loglik,
                             kl_divergence_mxp, loglik_terms_from_factor,
                             matern, matern_covariance)

N, TB = 256, 32


@pytest.mark.parametrize("n,seed", [(64, 0), (250, 3), (512, 7)])
def test_locations_bitwise(n, seed):
    got = generate_locations(n, seed)
    want = ref_matern.generate_locations(n, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    pts = np.random.default_rng(seed).uniform(size=(n, 2))
    assert np.array_equal(matern._morton_key(pts),
                          ref_matern._morton_key(pts))


def test_beta_constants():
    assert (matern.BETA_WEAK, matern.BETA_MEDIUM, matern.BETA_STRONG) == \
        (ref_matern.BETA_WEAK, ref_matern.BETA_MEDIUM, ref_matern.BETA_STRONG)


def _ref_kernel(h, sigma2, nu, nugget):
    """The reference's covariance (repro/geo/matern.py) from given
    distances h = d / beta, in its order of operations."""
    if nu == 0.5:
        c = np.exp(-h)
    elif nu == 1.5:
        s = np.sqrt(3.0) * h
        c = (1.0 + s) * np.exp(-s)
    elif nu == 2.5:
        s = np.sqrt(5.0) * h
        c = (1.0 + s + s * s / 3.0) * np.exp(-s)
    else:
        from scipy.special import gamma, kv
        hp = np.where(h == 0.0, 1.0, h)
        c = (2.0 ** (1.0 - nu) / gamma(nu)) * (hp ** nu) * kv(nu, hp)
        c = np.where(h == 0.0, 1.0, c)
    cov = sigma2 * c
    cov[np.diag_indices_from(cov)] += nugget * sigma2
    return cov


@pytest.mark.parametrize("beta", [matern.BETA_WEAK, matern.BETA_STRONG])
def test_distances_within_2_ulp(beta):
    """PyTorch's f64 sqrt on the CPU (AVX512) is not correctly rounded:
    about one value in 200 is one ulp off NumPy's (CUDA's is exact), so
    h = d / beta may sit two ulp from the reference's."""
    locs = ref_matern.generate_locations(300, seed=1)
    want = np.sqrt(((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1)) \
        / beta
    got = matern._scaled_distances(torch.from_numpy(locs), beta).numpy()
    assert (np.abs(got - want) <= 2 * np.spacing(want)).all()


@pytest.mark.parametrize("beta", [matern.BETA_WEAK, matern.BETA_STRONG])
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 0.8])
def test_covariance_within_4_ulp(nu, beta):
    """Within 4 ulp of the reference's formula, relative, at the port's
    own distances (the closed forms run in PyTorch, whose exp is not
    NumPy's; a general nu goes through SciPy as in the reference)."""
    locs = ref_matern.generate_locations(300, seed=1)
    kw = dict(sigma2=1.7, nu=nu, nugget=1e-5)
    got = matern_covariance(locs, beta=beta, device="cpu", **kw)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    h = matern._scaled_distances(torch.from_numpy(locs), beta).numpy()
    want = _ref_kernel(h, **kw)
    ulps = np.abs(got.numpy() - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 4, ulps.max()


def test_covariance_defaults_to_cuda(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        matern_covariance(generate_locations(16))


def _problem(k):
    """A Matérn covariance, its f64 factor and k seeded observations drawn
    from the field (y = L z), or one when k is None."""
    locs = ref_matern.generate_locations(N, seed=2)
    cov = ref_matern.matern_covariance(locs, beta=0.1)
    l = np.linalg.cholesky(cov)
    rng = np.random.default_rng(5)
    z = rng.standard_normal(N if k is None else (N, k))
    return cov, l, l @ z


def _solver(cov, backend):
    cfg = repro_torch.CholeskyConfig(tb=TB, backend=backend)
    solver = repro_torch.plan(N, cfg).compile(device="cpu")
    solver.factor(cov, materialize=False)
    return solver


@pytest.mark.parametrize("k", [None, 1, 4], ids=["vector", "k1", "k4"])
@pytest.mark.parametrize("factor", ["ndarray", "tensor", "solver-torch",
                                    "solver-numpy"])
def test_loglik_matches_reference(factor, k):
    cov, l, y = _problem(k)
    want = ref_lik.gaussian_loglik(l, y)
    if factor == "ndarray":
        f = l
    elif factor == "tensor":
        f = torch.from_numpy(l)
        y = torch.from_numpy(y)
    else:
        f = _solver(cov, factor.split("-")[1])
    got = gaussian_loglik(f, y)
    if k is None:
        assert isinstance(got, float)
    else:
        assert isinstance(got, np.ndarray) and got.shape == (k,)
    assert np.all(np.abs(got - want) <= 1e-10 * np.abs(want))


@pytest.mark.parametrize("factor", ["ndarray", "solver-numpy"])
def test_loglik_terms_without_observations(factor):
    cov, l, _ = _problem(None)
    f = l if factor == "ndarray" else _solver(cov, "numpy")
    logdet, quad = loglik_terms_from_factor(f)
    ref_logdet, ref_quad = ref_lik.loglik_terms_from_factor(l)
    assert quad == ref_quad == 0.0
    assert abs(logdet - ref_logdet) <= 1e-10 * abs(ref_logdet)


def _weak_cov():
    locs = ref_matern.generate_locations(N, seed=0)
    return ref_matern.matern_covariance(locs, beta=ref_matern.BETA_WEAK)


@pytest.mark.parametrize("ladder", ["tpu", "gpu", "gpu-scaled"])
@pytest.mark.parametrize("eps", [1e-4, 1e-6])
def test_kl_numpy_backend_equals_reference(eps, ladder):
    cov = _weak_cov()
    want = ref_kl.kl_divergence_mxp(cov, TB, eps, ladder=ladder,
                                    backend="numpy")
    got = kl_divergence_mxp(cov, TB, eps, ladder=ladder, backend="numpy")
    assert got == want
    # a tensor covariance takes the same host replay
    assert kl_divergence_mxp(torch.from_numpy(cov), TB, eps, ladder=ladder,
                             backend="numpy") == want


@pytest.mark.parametrize("cov_kind", ["ndarray", "tensor"])
@pytest.mark.parametrize("eps", [1e-4, 1e-6])
def test_kl_torch_backend_on_cpu_within_1e_8(eps, cov_kind):
    cov = _weak_cov()
    want = ref_kl.kl_divergence_mxp(cov, TB, eps, ladder="gpu",
                                    backend="numpy")
    arg = torch.from_numpy(cov) if cov_kind == "tensor" else cov
    got = kl_divergence_mxp(arg, TB, eps, ladder="gpu", device="cpu")
    assert got["precision_histogram"] == want["precision_histogram"]
    assert got["loads_bytes"] == want["loads_bytes"]
    assert got["eps_target"] == want["eps_target"]
    for key in ("kl", "abs_kl"):
        assert abs(got[key] - want[key]) <= 1e-8
    for key in ("loglik_fp64", "loglik_mxp"):
        assert abs(got[key] - want[key]) <= 1e-8 * abs(want[key])


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_kl_divergence_decreases_with_accuracy(backend):
    """Fig. 10 (the reference's test_substrate ordering): a tighter
    eps_target gives a smaller KL divergence."""
    locs = generate_locations(192, seed=3)
    cov = matern_covariance(locs, beta=matern.BETA_MEDIUM, device="cpu")
    kw = dict(backend=backend, device="cpu" if backend == "auto" else None)
    kl = {eps: kl_divergence_mxp(cov, 48, eps, **kw)["abs_kl"]
          for eps in (1e-4, 1e-8)}
    assert kl[1e-8] <= kl[1e-4]
    assert kl[1e-8] < 1e-2
