"""Matérn covariance construction (paper §III-D, Eq. 2).

C(h; θ) = σ²/(2^{ν−1}Γ(ν)) (h/a)^ν K_ν(h/a),   θ = (σ², a, ν)

Port of ``repro/geo/matern.py``.  The paper's experiments use ν = 0.5 (the
exponential kernel) with spatial range β ∈ {0.02627, 0.078809, 0.210158}
for weak/medium/strong correlation.  The locations are NumPy, bitwise the
reference's.  The covariance is an f64 tensor built on the device that
will factor it: the closed forms for ν ∈ {1/2, 3/2, 5/2} in PyTorch there,
a general ν through SciPy's Bessel K_ν on the host (PyTorch has none).
"""
from __future__ import annotations

import math

import numpy as np
import torch

# paper's three correlation regimes (β = spatial range a)
BETA_WEAK = 0.02627
BETA_MEDIUM = 0.078809
BETA_STRONG = 0.210158


def _morton_key(pts: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-order (Morton) key per point: ExaGeoStat orders locations this way
    so that covariance tiles correspond to spatial blocks and off-diagonal
    tile norms decay (that decay is what the MxP criterion harvests)."""
    q = np.clip((pts * (2**bits - 1)).astype(np.uint64), 0, 2**bits - 1)

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))


def generate_locations(n: int, seed: int = 0) -> np.ndarray:
    """Irregular locations on the unit square, Morton-ordered
    (ExaGeoStat-style jittered grid + space-filling-curve ordering)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    pts += rng.uniform(-0.4, 0.4, size=pts.shape)
    pts = (pts - pts.min(0)) / (pts.max(0) - pts.min(0))
    idx = rng.permutation(pts.shape[0])[:n]
    pts = pts[idx]
    order = np.argsort(_morton_key(pts))
    return pts[order]


def _scaled_distances(x: torch.Tensor, beta: float) -> torch.Tensor:
    """h = |x_i - x_j| / beta for every pair of rows of ``x``, in the
    reference's order of operations."""
    return ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1).sqrt_().div_(beta)


def matern_covariance(locs, sigma2: float = 1.0, beta: float = BETA_MEDIUM,
                      nu: float = 0.5, nugget: float = 1e-6,
                      device=None) -> torch.Tensor:
    """Dense Matérn covariance matrix Σ_θ over ``locs`` (``[n, 2]``), an
    f64 tensor on ``device`` (CUDA unless the caller asks for the CPU)."""
    device = torch.device("cuda" if device is None else device)
    x = torch.as_tensor(np.asarray(locs, dtype=np.float64), device=device)
    h = _scaled_distances(x, beta)
    if nu == 0.5:
        c = torch.exp(-h)
    elif nu == 1.5:
        s = math.sqrt(3.0) * h
        c = (1.0 + s) * torch.exp(-s)
    elif nu == 2.5:
        s = math.sqrt(5.0) * h
        c = (1.0 + s + s * s / 3.0) * torch.exp(-s)
    else:
        from scipy.special import gamma, kv
        hh = h.cpu().numpy()
        hp = np.where(hh == 0.0, 1.0, hh)
        cn = (2.0 ** (1.0 - nu) / gamma(nu)) * (hp ** nu) * kv(nu, hp)
        c = torch.from_numpy(np.where(hh == 0.0, 1.0, cn)).to(device)
    cov = sigma2 * c
    cov.diagonal().add_(nugget * sigma2)
    return cov
