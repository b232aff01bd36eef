#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s residual bound for the blocked POTRF
and TRSM kernels, over seeds.

    python3 benchmarks/torch_tile_bounds.py [--seeds 0 1 2] [--tb 512]

Runs ``chip_smoke.py``'s blocked checks (both kernels at its ragged sizes
and at ``--tb``, f32 and bf16: each residual at its own scale in units of
the output type's roundoff, POTRF's per 64-column block, and the
dropped-block controls that must fail) and POTRF at the largest tile the
wrapper takes (n = 6144, f32, with its control) once per seed.  A failed requirement is logged, not raised, so every seed's
reading is kept.  Needs a CUDA device; writes
``chiprun_out/torch_tile_bounds.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def largest_potrf(cs, dev, g) -> dict:
    """POTRF at the largest tile the wrapper takes (f32): its residual and
    its dropped-update control, which the per-block bound must separate."""
    from repro_torch.kernels import potrf
    n = potrf.MAX_N
    a = cs._spd(n, g, dev)
    got = potrf.potrf(a)
    torch.cuda.synchronize()
    row = {"residual_units": cs.potrf_backward(got, a),
           "control_units": cs.potrf_backward(cs.potrf_dropped_update(a), a)}
    cs.log(f"blocked potrf[float32,n={n}]: " + json.dumps(row))
    return {f"potrf[float32,n={n}]": row}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--tb", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tile_bounds: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    cs.require = lambda ok, what: ok or cs.log(f"FAILS: {what}")
    _build.build(["potrf", "trsm"])
    dev = torch.device("cuda")
    out = {"card": cs.card_line(), "backward_c": cs.BACKWARD_C}
    summary = {}
    for seed in args.seeds:
        g = torch.Generator(device=dev).manual_seed(seed)
        run = cs.blocked_checks(args.tb, dev, g)
        run.update(largest_potrf(cs, dev, g))
        out[f"seed {seed}"] = run
        for tag, row in run.items():
            if "residual_units" not in row:
                continue
            key = tag.split(",n=")[0] + "]"
            s = summary.setdefault(key, {"residual_max": 0.0,
                                         "control_min": None})
            s["residual_max"] = max(s["residual_max"], row["residual_units"])
            if row["control_units"] is not None:
                c = row["control_units"]
                s["control_min"] = (c if s["control_min"] is None
                                    else min(s["control_min"], c))
    out["summary"] = summary
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "torch_tile_bounds.json").write_text(json.dumps(out, indent=1))
    print(out["card"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
