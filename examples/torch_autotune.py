"""Autotune on the PyTorch/CUDA port: let the cost model pick tb / policy /
cache_slots for you.

The counterpart of ``examples/autotune.py`` on ``repro_torch``.  Three
levels of engagement, lowest-effort first:

  1. open config   — ``CholeskyConfig(tb=0, policy="auto")``: plan()
     resolves the open axes by exact-simulation search before building
     the schedule (datasheet preset model; deterministic, no device work).
  2. explicit campaign — ``tune.tune(n, hw=...)`` returns the full ranked
     candidate table, not just the winner.
  3. calibrated    — ``tune.calibrate(device=...)`` micro-benchmarks the
     card (``--device``, the card unless ``cpu``): kernel rates per
     precision class from their device time, host-link bandwidth,
     overheads, device memory; the same search runs on measured numbers.

Simulated makespans are model readings, of a preset or of the measured
model, not measurements.  Winners are memoized by hardware fingerprint;
set the ``REPRO_TUNE_DB`` environment variable to persist them across
processes.

    PYTHONPATH=src python examples/torch_autotune.py [--device cpu]
"""
import argparse

import numpy as np

import repro_torch
from repro_torch import tune

HW_A100 = repro_torch.HW["a100-pcie"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    n = 2048

    # -- 1) fully automatic: open dimensions resolve inside plan() --------
    cfg = repro_torch.CholeskyConfig(tb=0, policy="auto", hw="gh200")
    solver = repro_torch.plan(n, cfg).compile(device=dev)
    c = solver.config
    print(f"auto-resolved for gh200:  tb={c.tb}  policy={c.policy}  "
          f"cache_slots={c.cache_slots}")
    a = repro_torch.random_spd(n, seed=0)
    l = solver.factor(a)
    err = np.abs(l - np.linalg.cholesky(a)).max()
    print(f"factor through tuned plan: max|L-chol(A)| = {err:.2e} "
          f"(on {dev})")
    assert err < 1e-10

    # -- 2) explicit campaign: the ranked candidate table ------------------
    result = tune.tune(n, hw="a100-pcie", use_db=False)
    print(f"\ntop candidates on a100-pcie (of {len(result.candidates)}):")
    print(f"  {'tb':>6s} {'policy':>7s} {'slots':>6s} {'makespan':>10s} "
          f"{'TF/s':>6s} {'moved GB':>9s}")
    for cand in result.candidates[:5]:
        r = cand.row()
        print(f"  {r['tb']:6d} {r['policy']:>7s} {r['cache_slots']:6d} "
              f"{r['makespan_s']:9.4f}s {r['tflops']:6.1f} "
              f"{(r['loads_bytes'] + r['stores_bytes'])/1e9:9.2f}")
    dflt = tune.score_config(n, tune.default_config(n), HW_A100)
    print(f"  hand-picked default: tb={tune.default_config(n).tb} v3 "
          f"-> {dflt.makespan:.4f}s "
          f"({dflt.makespan / result.best.makespan:.2f}x the winner)")

    # -- 3) calibrate the card and tune against the measurement ------------
    model = tune.calibrate(tb=128, repeats=1, transfer_sizes_mb=(1, 4),
                           device=dev)
    print(f"\nmeasured model: {model.name}  (fingerprint {model.fingerprint})")
    print(f"  f64 GEMM  {model.kernel_flops['gemm']['f64']/1e9:8.1f} GFlop/s"
          f"   bf16 GEMM {model.kernel_flops['gemm']['bf16']/1e9:8.1f}")
    print(f"  h2d {model.h2d_bw/1e9:.1f} GB/s   d2h {model.d2h_bw/1e9:.1f}"
          f" GB/s   mem {model.mem_bytes/1e9:.1f} GB   "
          f"launch {model.launch_overhead*1e6:.1f} us")
    measured = tune.tune(n, hw=model, use_db=False)
    mc = measured.config
    print(f"tuned for THIS machine:   tb={mc.tb}  policy={mc.policy}  "
          f"cache_slots={mc.cache_slots}  "
          f"(predicted {measured.best.makespan:.3f}s)")

    # install the measurement as the process default: every auto config
    # from here on resolves against the measured card
    tune.set_default_hardware(model)
    resolved = tune.resolve_config(n, repro_torch.CholeskyConfig(
        tb=0, policy="auto"))
    assert resolved == mc


if __name__ == "__main__":
    main()
