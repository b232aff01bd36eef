"""End to end on the PyTorch/CUDA port: the paper's geospatial
statistics application.

The counterpart of ``examples/geospatial_mle.py`` on ``repro_torch``.

Pipeline (paper §III-D / §V-C):
  1. generate Morton-ordered spatial locations + Matern covariance
     at three correlation regimes (weak / medium / strong), built on
     ``--device`` (the card unless ``cpu``),
  2. factor Sigma with the OOC MxP V3 Cholesky at several accuracy
     targets (the Fig. 10/11 sweep),
  3. evaluate the Gaussian log-likelihood through the factor and the
     KL divergence against the FP64 reference,
  4. report precision histograms, byte volumes, and modeled GH200
     makespans (model readings of a datasheet preset).

This is the amortize-once/replay-many scenario of the planner API: the
MLE sweep factors same-shape covariances over and over, so ONE compiled
FP64 solver is reused across all three regimes (schedule + executor built
exactly once — see the stats line), and the likelihood is evaluated
out-of-core through the solver's blocked substitution, never forming the
dense factor.

    PYTHONPATH=src python examples/torch_geospatial_mle.py [--device cpu]
"""
import argparse

import numpy as np

import repro_torch
from repro_torch.geo.kl import kl_divergence_mxp
from repro_torch.geo.likelihood import gaussian_loglik
from repro_torch.geo.matern import (BETA_MEDIUM, BETA_STRONG, BETA_WEAK,
                                    generate_locations, matern_covariance)

N = 1024
TB = 128
REGIMES = [("weak", BETA_WEAK), ("medium", BETA_MEDIUM),
           ("strong", BETA_STRONG)]
ACCURACIES = [1e-5, 1e-6, 1e-8]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    locs = generate_locations(N, seed=0)
    rng = np.random.default_rng(0)

    # one FP64 plan/executor for every regime (same shape -> same schedule)
    solver64 = repro_torch.plan(N, tb=TB, policy="v3").compile(device=dev)

    for name, beta in REGIMES:
        cov = matern_covariance(locs, sigma2=1.0, beta=beta, nu=0.5,
                                device=dev)
        # synthetic observations y ~ N(0, Sigma)
        l_true = np.linalg.cholesky(cov.cpu().numpy())
        y = l_true @ rng.standard_normal(N)

        solver64.factor(cov, materialize=False)   # factor stays tiled
        ll64 = gaussian_loglik(solver64, y)       # logdet + quad via tiles
        print(f"\n=== correlation {name} (beta={beta}) ===")
        print(f"FP64 log-likelihood: {ll64:.4f}")

        for eps in ACCURACIES:
            res = kl_divergence_mxp(cov, TB, eps, policy="v3", device=dev)
            cfg = repro_torch.CholeskyConfig(tb=TB, policy="v3",
                                             eps_target=eps).specialize(cov)
            mxp = repro_torch.plan(N, cfg).compile(device=dev)
            mxp.factor(cov, materialize=False)
            llmx = gaussian_loglik(mxp, y)
            t = mxp.simulate(repro_torch.HW["gh200"]).makespan
            hist = {k: v for k, v in res["precision_histogram"].items()
                    if v}
            print(f"  eps={eps:7.0e}  KL={res['abs_kl']:9.3e}  "
                  f"ll={llmx:12.4f}  bytes={res['loads_bytes']/1e6:7.1f}MB  "
                  f"gh200-model={t*1e3:6.2f}ms  {hist}")

    print(f"\nFP64 solver reuse across {len(REGIMES)} regimes: "
          f"{solver64.stats}")
    assert solver64.stats["executor_builds"] == 1   # built once, replayed
    assert solver64.stats["factor_calls"] == len(REGIMES)
    # the plan cache hands back the same schedule for the same (n, config)
    assert repro_torch.plan(N, tb=TB, policy="v3").schedule \
        is solver64.schedule


if __name__ == "__main__":
    main()
