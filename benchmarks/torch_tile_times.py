#!/usr/bin/env python3
"""Device time of the kernels that share the blocked solve and factor
routines (``csrc/tri_block.cuh``, ``csrc/potrf_blocked.cuh``).

    python3 benchmarks/torch_tile_times.py [--root DIR] [--n 512] [--reps 200]

POTRF of an n x n f32 SPD tile and TRSM X L^T = C with n x n f32 operands,
each with its largest error against the f64 result; the fused column
step's factor and solve phases alone (R = 1, K = 0) in f32 and f64, and its
mid-factorization step (R = K = 32, f32).  Each by the profiler's device
time a call (``chip_smoke.device_ms``); where this process built a kernel,
ptxas's registers and spills.  ``--root`` times the package of another
checkout (for example a parent commit unpacked under ``build/``) with this
script's timer and inputs, so two trees compare in one call on one card.
Needs a CUDA device; prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tile_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.root.resolve() / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build, fused_column, potrf, trsm
    built = _build.build(["potrf", "trsm", "fused_column"], ptxas_info=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.n
    a = cs._spd(n, g, dev)
    l = torch.linalg.cholesky(a.double()).float().contiguous()
    c = torch.randn(n, n, generator=g, device=dev) / math.sqrt(n)
    want_l = torch.linalg.cholesky(a.double())
    want_x = torch.linalg.solve_triangular(l.double().T, c.double(),
                                           upper=True, left=False)
    row = {"root": str(args.root), "card": cs.card_line(), "n": n,
           "potrf_ms": cs.device_ms(lambda: potrf.potrf(a), args.reps),
           "trsm_ms": cs.device_ms(lambda: trsm.trsm(l, c), args.reps),
           "potrf_err": float((potrf.potrf(a).double() - want_l).abs().max()),
           "trsm_err": float((trsm.trsm(l, c).double() - want_x).abs().max())}
    for dt in (torch.float32, torch.float64):
        for with_diag in (True, False):
            ops = cs._column(1, 0, n, with_diag, dt, dev, g)
            phase = "factor" if with_diag else "solve"
            row[f"fused_{phase}_{str(dt)[6:]}_ms"] = cs.device_ms(
                lambda: fused_column.fused_column_step(
                    *ops, [-1], ladder=cs.LADDER, with_diag=with_diag),
                args.reps)
    ops = cs._column(32, 32, n, True, torch.float32, dev, g)
    row["fused_step_r32_k32_ms"] = cs.device_ms(
        lambda: fused_column.fused_column_step(
            *ops, [1] * 32, ladder=cs.LADDER, with_diag=True),
        max(3, args.reps // 10))
    for name, text in built.items():
        row[f"{name}_ptxas"] = [s.strip() for s in text.splitlines()
                                if "registers" in s or "spill" in s]
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
