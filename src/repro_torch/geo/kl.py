"""KL-divergence accuracy assessment of the MxP factorization (Eq. 3).

D_KL(N₀ ‖ N_a) = ℓ₀(θ; 0) − ℓ_a(θ; 0)

ℓ₀ is the FP64 log-likelihood at y = 0, ℓ_a the MxP one: the divergence
reduces to ½(log|Σ|_a − log|Σ|₀), the metric of Fig. 10.  Port of
``repro/geo/kl.py`` over the port's planner/executor API: the FP64 plan is
matrix-independent, so sweeping ``eps_target`` over one covariance reuses
one cached FP64 plan and executor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import CholeskyConfig, plan


def kl_divergence_mxp(cov, tb: int, eps_target: float, policy: str = "v3",
                      ladder: str = "tpu", backend: str = "auto",
                      device=None) -> dict:
    """The KL divergence between the FP64 and the MxP likelihoods, with
    the details the reference returns.

    Both factorizations run on the card by default (``backend="auto"``,
    ``device=None`` is CUDA), where the reference defaults to its NumPy
    replay; ``backend="numpy"`` runs the port's replay of it on the host.
    ``cov`` is an ``[n, n]`` ndarray or tensor."""
    from .likelihood import gaussian_loglik

    if backend == "numpy" and isinstance(cov, torch.Tensor):
        cov = cov.cpu().numpy()
    if not isinstance(cov, torch.Tensor):
        cov = np.asarray(cov, dtype=np.float64)
    n = cov.shape[0]
    base = CholeskyConfig(tb=tb, policy=policy, ladder=ladder,
                          backend=backend)
    ref = plan(n, base).compile(device=device)
    ref.factor(cov, materialize=False)    # logdet reads the tile store
    mxp_cfg = CholeskyConfig(tb=tb, policy=policy, ladder=ladder,
                             backend=backend,
                             eps_target=eps_target).specialize(cov)
    mxp = plan(n, mxp_cfg).compile(device=device)
    mxp.factor(cov, materialize=False)
    sched = mxp.schedule
    l0 = gaussian_loglik(ref)
    la = gaussian_loglik(mxp)
    return {
        "kl": l0 - la,
        "abs_kl": abs(l0 - la),
        "loglik_fp64": l0,
        "loglik_mxp": la,
        "precision_histogram": sched.plan.histogram(),
        "loads_bytes": sched.loads_bytes(),
        "eps_target": eps_target,
    }
