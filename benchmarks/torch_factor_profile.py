#!/usr/bin/env python3
"""Where one factorization's time goes on the card (the PyTorch/CUDA port).

    python3 benchmarks/torch_factor_profile.py [--n 32768] [--tb 512] [--fuse]

Runs the configuration of ``chip_smoke.py``'s main path (seeded SPD matrix
x x^T / n + 2 I on the card, policy v3, ladder ``gpu``, ``eps_target=1e-6``
specialised, ``use_pallas=True``, f32 compute; ``--fuse`` adds
``fuse_columns=True``) and reports:

* ``factor_s``: wall seconds of ``OOCSolver.factor`` (unprofiled, after one
  warm-up factorization);
* ``enqueue_s``: host seconds to issue the whole op stream (the executor
  returns before the device finishes), and ``enqueue_us_per_op``;
* device time by kernel and copy from ``torch.profiler`` (CUDA activity
  only) over one more factorization, its sum, and the device's idle share
  ``1 - busy / wall`` of that profiled factorization (one stream, so the
  device intervals do not overlap and their sum is their union);
* the achieved H2D rate of the LOAD copies.

Needs a CUDA device; writes ``chiprun_out/torch_factor_profile.json``
(``torch_factor_profile_fused.json`` with ``--fuse``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--tb", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fuse", action="store_true",
                    help="one fused launch per column step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_factor_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    n, tb = args.n, args.tb
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn(n, n, generator=g, device=dev, dtype=torch.float64)
    a = x @ x.T / n + 2.0 * torch.eye(n, device=dev, dtype=torch.float64)
    del x
    a = 0.5 * (a + a.T)
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu", eps_target=1e-6, use_pallas=True,
        compute_dtype=torch.float32, fuse_columns=args.fuse).specialize(a)
    solver = repro_torch.plan(n, cfg).compile(device=dev)
    nops = sum(len(s) for s in solver.schedule.streams)

    solver.factor(a, materialize=False)           # warm-up
    t0 = time.perf_counter()
    solver.factor(a, materialize=False)
    factor_s = time.perf_counter() - t0

    # host enqueue alone: the executor returns once every op is issued
    host = solver.tiles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver._executor.run(host)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.factor(a, materialize=False)
        prof_wall_s = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if dt > 0:
            rows.append({"name": ev.key[:90], "count": ev.count,
                         "device_ms": dt / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    h2d_ms = sum(r["device_ms"] for r in rows
                 if "HtoD" in r["name"] or "Host to Device" in r["name"])
    io = solver.stats["transfers"]
    out = {
        "card": card, "n": n, "tb": tb, "ops": nops, "fuse_columns": args.fuse,
        "factor_s": factor_s, "enqueue_s": enqueue_s, "run_s": run_s,
        "enqueue_us_per_op": enqueue_s / nops * 1e6,
        "profiled_wall_s": prof_wall_s, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (prof_wall_s * 1e3),
        "h2d_bytes": io["executed_h2d_bytes"], "h2d_ms": h2d_ms,
        "h2d_GBps": (io["executed_h2d_bytes"] / (h2d_ms / 1e3) / 1e9
                     if h2d_ms else None),
        "by_name": rows[:25],
    }
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    name = "torch_factor_profile" + ("_fused" if args.fuse else "")
    (outdir / f"{name}.json").write_text(json.dumps(out, indent=1))
    print(card)
    for r in rows[:15]:
        print(f"{r['device_ms']:12.3f} ms {r['count']:8d}  {r['name']}")
    print(json.dumps({k: v for k, v in out.items() if k != "by_name"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
