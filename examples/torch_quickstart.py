"""Quickstart on the PyTorch/CUDA port: plan once, factor and solve many
times.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``.  The
paper's schedule is *static*: built ahead of time, replayed per matrix.
The public API mirrors that in two phases:

  1. ``repro_torch.plan(n, config)`` — build the op stream + cache tables
     once for a frozen ``CholeskyConfig`` (tiling, policy, precision,
     memory, backend); plans are cached by ``(n, config)``.
  2. ``.compile(device=...)``         — build the executor once on the
     card (or ``--device cpu``); the returned ``OOCSolver`` then amortizes
     both across every ``factor()`` / ``solve()`` of that shape.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

import repro_torch
from repro_torch.core.tiling import random_spd


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    n, tb = 1024, 128
    rng = np.random.default_rng(0)

    # -- phase 1+2: FP64 V3 plan, compiled once ---------------------------
    cfg64 = repro_torch.CholeskyConfig(tb=tb, policy="v3")
    solver = repro_torch.plan(n, cfg64).compile(device=dev)

    # -- replay across matrices: schedule + executor are built once -------
    for seed in range(3):
        l64 = solver.factor(random_spd(n, seed=seed))
    print(f"matrix {n}x{n}, tiles {tb}x{tb}, device {dev}")
    print(f"3 factorizations through one solver: stats={solver.stats}")

    a = random_spd(n, seed=0)
    l64 = solver.factor(a)
    err64 = np.abs(l64 - np.linalg.cholesky(a)).max()
    print(f"FP64 V3   : max|L - chol(A)| = {err64:.2e}")

    # -- the factorization is a solver: blocked triangular substitution --
    b = rng.standard_normal(n)
    x = solver.solve(b)
    print(f"solve(b)  : max|Ax - b|      = {np.abs(a @ x - b).max():.2e}")

    # -- four-precision MxP at eps_target = 1e-8 --------------------------
    # eps_target plans depend on the matrix's tile norms; specialize(a)
    # freezes the Higham-Mary plan so the MxP solver is reusable too.
    cfgmx = repro_torch.CholeskyConfig(tb=tb, policy="v3",
                                       eps_target=1e-8).specialize(a)
    mxp = repro_torch.plan(n, cfgmx).compile(device=dev)
    lmx = mxp.factor(a)
    errmx = np.abs(lmx @ lmx.T - a).max() / np.abs(a).max()
    print(f"MxP  V3   : rel residual     = {errmx:.2e}")
    print(f"precision histogram: {cfgmx.plan.histogram()}")

    # -- exact data movement + modeled platform speedups ------------------
    v64, vmx = solver.volume(), mxp.volume()
    print(f"bytes moved  FP64: {v64['total_bytes']/1e6:8.1f} MB"
          f"   MxP: {vmx['total_bytes']/1e6:8.1f} MB"
          f"   ({v64['total_bytes']/max(vmx['total_bytes'],1):.2f}x less)")
    for hw in ("a100-pcie", "gh200", "tpu-v5e"):
        t64 = solver.simulate(repro_torch.HW[hw]).makespan
        tmx = mxp.simulate(repro_torch.HW[hw]).makespan
        print(f"{hw:10s} modeled speedup MxP vs FP64: {t64/tmx:5.2f}x")

    assert solver.stats["executor_builds"] == 1      # built once, replayed
    assert err64 < 1e-10 and errmx < 1e-6


if __name__ == "__main__":
    main()
