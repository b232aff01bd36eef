#!/usr/bin/env python3
"""Where a multi-device factorization's time goes on the card.

    python3 benchmarks/torch_multidevice_profile.py [--n 32768] [--tb 512] [--fuse]

Runs ``chip_smoke.py``'s config A (its seeded SPD matrix x x^T / n + 2 I on
the card, policy v3, ladder ``gpu``, ``eps_target=1e-6`` specialised,
``use_pallas=True``, f32 compute, ``ndev=4`` on the 1D grid (4, 1),
lookahead 0; ``--fuse`` adds ``fuse_columns=True``) over four logical
devices: four cards where the machine has them, else four CUDA streams on
this one card.  Reports:

* ``factor_s``: wall seconds of ``OOCSolver.factor`` (unprofiled, after a
  warm-up factorization), and the single-device factor of the same
  configuration in the same process (``single_factor_s``);
* device time by kind (GEMM, SYRK, TRSM, POTRF, the fused step, H2D, D2H,
  device copies, other kernels) from ``torch.profiler`` (CUDA activity)
  over one more factorization: ``sum_ms`` adds the intervals,
  ``busy_ms`` is their union, so ``sum_ms / busy_ms`` is how many run at
  once on average and ``1 - busy / wall`` the idle share;
* the cooperative launches (POTRF and the fused step, each a grid sized to
  every SM): the most that ran at once and the time two or more did.

Needs a CUDA device; writes ``chiprun_out/torch_multidevice_profile.json``
(``..._fused.json`` with ``--fuse``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
KINDS = (("mxp_gemm", "GEMM"), ("syrk", "SYRK"), ("trsm", "TRSM"),
         ("potrf", "POTRF"), ("fused_column", "fused step"),
         ("HtoD", "H2D"), ("DtoH", "D2H"), ("DtoD", "device copies"))
COOPERATIVE = ("potrf", "fused_column")


def kind_of(name: str) -> str:
    for key, kind in KINDS:
        if key in name:
            return kind
    return "other kernels"


def union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def overlap(spans) -> tuple[int, float]:
    """(most spans at once, microseconds with two or more at once)."""
    edges = sorted([(s, 1) for s, _ in spans] + [(e, -1) for _, e in spans])
    depth = most = 0
    both, last = 0.0, None
    for t, step in edges:
        if depth >= 2 and last is not None:
            both += t - last
        depth += step
        most = max(most, depth)
        last = t
    return most, both


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--tb", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fuse", action="store_true",
                    help="one fused launch per column step and segment")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_multidevice_profile: needs a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import repro_torch
    from chip_smoke import MD_NDEV, card_line, make_spd, md_devices
    from torch.profiler import ProfilerActivity, profile

    card = card_line()
    dev = torch.device("cuda")
    n, tb = args.n, args.tb
    a = make_spd(n, dev, args.seed)
    devices, shared = md_devices(dev, MD_NDEV)
    base = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu", eps_target=1e-6, use_pallas=True,
        compute_dtype=torch.float32, fuse_columns=args.fuse).specialize(a)
    single = repro_torch.plan(n, base).compile(device=dev)
    solver = repro_torch.plan(n, dataclasses.replace(
        base, ndev=MD_NDEV, grid=(MD_NDEV, 1), lookahead=0)).compile(
            device=devices)
    nops = sum(len(s) for s in solver.schedule.streams)

    secs = {}
    for name, s in (("single", single), ("multi", solver)):
        s.factor(a, materialize=False)                 # warm-up
        t0 = time.perf_counter()
        s.factor(a, materialize=False)
        secs[name] = time.perf_counter() - t0
    del single

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.factor(a, materialize=False)
        wall_s = time.perf_counter() - t0
    spans, by_kind, coop = [], {}, []
    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        if e <= s:
            continue
        spans.append((s, e))
        k = by_kind.setdefault(kind_of(ev.name), {"count": 0, "ms": 0.0})
        k["count"] += 1
        k["ms"] += (e - s) / 1e3
        if any(c in ev.name for c in COOPERATIVE):
            coop.append((s, e))
    sum_ms = sum(k["ms"] for k in by_kind.values())
    busy_ms = union_us(spans) / 1e3
    most, both_us = overlap(coop)
    io = solver.stats["transfers"]
    out = {
        "card": card, "n": n, "tb": tb, "ndev": MD_NDEV,
        "shared_card": shared, "ops": nops, "fuse_columns": args.fuse,
        "factor_s": secs["multi"], "single_factor_s": secs["single"],
        "profiled_wall_s": wall_s, "sum_ms": sum_ms, "busy_ms": busy_ms,
        "mean_concurrency": sum_ms / busy_ms if busy_ms else None,
        "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "cooperative_launches": len(coop), "cooperative_most_at_once": most,
        "cooperative_overlap_ms": both_us / 1e3,
        "by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]["ms"])),
        "transfers": io,
    }
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    name = "torch_multidevice_profile" + ("_fused" if args.fuse else "")
    (outdir / f"{name}.json").write_text(json.dumps(out, indent=1))
    print(card)
    for kind, k in out["by_kind"].items():
        print(f"{k['ms']:12.3f} ms {k['count']:8d}  {kind}")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("by_kind", "transfers")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
