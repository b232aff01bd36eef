"""Gaussian log-likelihood through the (MxP OOC) Cholesky factor (Eq. 1).

ℓ(θ; y) = −n/2 log 2π − ½ log|Σ| − ½ yᵀ Σ⁻¹ y

log|Σ| = 2 Σ_i log L_ii and yᵀΣ⁻¹y = ‖L⁻¹y‖² via one triangular solve.
Port of ``repro/geo/likelihood.py``.  Both entry points accept a factored
:class:`~repro_torch.core.api.OOCSolver` (anything with ``solve_lower``,
``logdet`` and ``n``), whose factor stays in its tile store, or a dense
lower factor as an ndarray or a tensor, solved with
``torch.linalg.solve_triangular`` on the tensor's device.

``y`` may be ``k`` stacked observation vectors as an ``(n, k)`` matrix:
one forward substitution sweeps the factor for all ``k`` quad forms, and
the entry points return length-``k`` arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_solver(obj) -> bool:
    return hasattr(obj, "solve_lower") and hasattr(obj, "logdet")


def _quad(z: np.ndarray):
    """‖z‖² per column: float for one rhs, length-k array for a stack."""
    if z.ndim == 1:
        return float(z @ z)
    return np.einsum("ij,ij->j", z, z)


def loglik_terms_from_factor(l, y=None):
    """(logdet, quad) from a lower Cholesky factor or a factored solver.

    ``y`` of shape ``(n,)`` gives a scalar quad form; ``(n, k)`` stacked
    observations give a length-``k`` array of quad forms from a single
    substitution sweep.
    """
    if _is_solver(l):
        logdet = l.logdet()
        if y is None:
            return logdet, 0.0
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        z = l.solve_lower(np.asarray(y, dtype=np.float64))
        return logdet, _quad(z)
    l = torch.as_tensor(l)
    logdet = 2.0 * float(torch.log(torch.diagonal(l)).sum())
    if y is None:
        return logdet, 0.0
    yt = torch.as_tensor(y).to(device=l.device, dtype=l.dtype)
    z = torch.linalg.solve_triangular(l, yt.reshape(yt.shape[0], -1),
                                      upper=False)
    q = (z * z).sum(dim=0).cpu().numpy()
    return logdet, float(q[0]) if yt.ndim == 1 else q


def gaussian_loglik(l, y=None):
    """ℓ(θ; y): a float for one observation vector, a length-``k`` array
    for ``(n, k)`` stacked observations."""
    n = l.n if _is_solver(l) else l.shape[0]
    logdet, quad = loglik_terms_from_factor(l, y)
    out = -0.5 * n * np.log(2.0 * np.pi) - 0.5 * logdet - 0.5 * quad
    return out if isinstance(quad, np.ndarray) else float(out)
