"""Reproduce the paper's policy ladder (sync/async/V1/V2/V3) on one GPU,
on the PyTorch/CUDA port.

The counterpart of ``examples/ooc_policy_comparison.py`` on
``repro_torch``.  For the paper's 8192^2 matrix, prints the exact
data-movement volume of every policy (Fig. 8) and the modeled
makespan/TFlop/s on the paper's three platforms plus the TPU v5e target
(Fig. 6), including the cudaMalloc-overhead effect that makes naive
async lose to V1.  Closes with the multi-device extension (Fig. 5/9):
per-device op streams with the panel-row broadcast on a shared
interconnect.  Every number up to there is a model reading of a datasheet
preset, not a measurement.

Then each policy's plan is factored once on ``--device`` (the card unless
``cpu``), and its executed copies are held against the schedule's exact
volume.

Everything runs off cached ``repro_torch.plan`` objects — one frozen
``CholeskyConfig`` per (policy, ndev), schedules built once each.

    PYTHONPATH=src python examples/torch_ooc_policy_comparison.py \\
        [--device cpu] [--n 2048]
"""
import argparse

import numpy as np

import repro_torch
from repro_torch.core.analytics import HW, ascii_trace
from repro_torch.core.tiling import random_spd

POLICIES = ["sync", "async", "v1", "v2", "v3"]
NT = 16          # 16x16 tiles
TB = 512         # of 512x512 -> 8192^2 matrix
N = NT * TB


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N,
                    help="matrix size of the executed section (a multiple "
                         "of 512; the modeled sections keep 8192)")
    args = ap.parse_args()
    print(f"matrix {N}x{N}, tile {TB}, policies {POLICIES}\n")
    plans = {p: repro_torch.plan(N, tb=TB, policy=p) for p in POLICIES}

    print(f"{'policy':8s} {'loads':>8s} {'C2G GB':>9s} {'G2C GB':>9s} "
          f"{'hits':>6s} {'evict':>6s}")
    for p, pl in plans.items():
        rep = pl.volume()
        print(f"{p:8s} {rep['loads']:8d} {rep['c2g_bytes']/1e9:9.2f} "
              f"{rep['g2c_bytes']/1e9:9.2f} {rep['cache_hits']:6d} "
              f"{rep['evictions']:6d}")

    for hw_name in ("a100-pcie", "h100-pcie", "gh200", "tpu-v5e"):
        hw = HW[hw_name]
        print(f"\n--- {hw_name} (modeled) ---")
        for p, pl in plans.items():
            r = pl.simulate(hw)
            print(f"{p:8s} makespan {r.makespan*1e3:8.1f} ms   "
                  f"{r.tflops:6.1f} TFlop/s   "
                  f"copy-busy {100*r.h2d_busy/r.makespan:5.1f}%")

    print("\nFig.7-style trace, GH200, V3 (o=C2G # = compute g=G2C):")
    print(ascii_trace(plans["v3"].simulate(HW["gh200"],
                                           record_timeline=True)))
    print("\nFig.7-style trace, GH200, sync:")
    print(ascii_trace(plans["sync"].simulate(HW["gh200"],
                                             record_timeline=True)))

    print("\n--- multi-device V3 (block-cyclic, Fig. 5/9; docs/multidevice.md) ---")
    print(f"{'ndev':>4s} {'grid':>6s} {'per-dev C2G GB':>15s} {'bcast GB':>9s} "
          f"{'gh200 eff':>10s} {'a100 eff':>9s}")
    def efficiency(pl, hw_name):
        r = pl.simulate(HW[hw_name])
        # MultiSimResult exposes the Fig. 9 metric directly; for one
        # device it reduces to compute-busy fraction of the makespan
        if hasattr(r, "compute_efficiency"):
            return r.compute_efficiency
        return r.compute_busy / r.makespan

    # 2D block-cyclic grids shrink the broadcast itself: the (2, 2) grid
    # at 4 devices moves ~sqrt(P) less than the 1D tile-row layout
    for ndev, grid in ((1, None), (2, None), (4, None), (4, (2, 2))):
        pl = repro_torch.plan(N, tb=TB, policy="v3", ndev=ndev, grid=grid)
        rep = pl.volume()
        if ndev > 1:
            per_dev, bcast = rep["per_device"][0]["c2g_bytes"], rep["bcast_bytes"]
        else:
            per_dev, bcast = rep["c2g_bytes"], 0
        effs = {hw: efficiency(pl, hw) for hw in ("gh200", "a100-pcie")}
        glabel = "x".join(map(str, grid)) if grid else f"{ndev}x1"
        print(f"{ndev:4d} {glabel:>6s} {per_dev/1e9:15.2f} "
              f"{bcast/1e9:9.2f} {effs['gh200']*100:9.1f}% "
              f"{effs['a100-pcie']*100:8.1f}%")

    # -- executed: each policy's f64 plan factored on the device; its
    # copies carry f64 bytes, so they equal the schedule's volume ---------
    n = args.n
    a = random_spd(n, seed=0)
    lref = np.linalg.cholesky(a)
    print(f"\n--- executed on {args.device}: n={n}, tile {TB} ---")
    for p in POLICIES:
        solver = repro_torch.plan(n, tb=TB, policy=p).compile(
            device=args.device)
        err = np.abs(solver.factor(a) - lref).max()
        io, vol = solver.stats["transfers"], solver.volume()
        print(f"{p:8s} H2D {io['executed_h2d_bytes']/1e9:7.3f} GB  "
              f"D2H {io['executed_d2h_bytes']/1e9:7.3f} GB  "
              f"max|L - chol(A)| = {err:.2e}")
        assert io["executed_h2d_bytes"] == vol["c2g_bytes"]
        assert io["executed_d2h_bytes"] == vol["g2c_bytes"]
        assert err < 1e-10


if __name__ == "__main__":
    main()
