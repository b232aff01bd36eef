#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s geospatial checks, over seeds.

    python3 benchmarks/torch_geo_bounds.py [--seeds 0 1 2] [--n 16384]

Runs ``chip_smoke.py``'s geospatial phase once per seed (the seed makes
the Matérn locations and the observations): the fused f64 factor against
the unfused one tile by tile and its control, both against the f64 factor,
the log-likelihood through the fused MxP solver against the f64 factor's
with the control's solver as its fault, and the KL divergences.  A failed
requirement is logged, not raised, so every seed's reading is kept.  Needs
a CUDA device; writes ``chiprun_out/torch_geo_bounds.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--tb", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_geo_bounds: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    cs.require = lambda ok, what: ok or cs.log(f"FAILS: {what}")
    _build.build()
    dev = torch.device("cuda")
    card = cs.card_line()
    out = {"card": card}
    for seed in args.seeds:
        out[f"seed {seed}"] = cs.geo(args.n, args.tb, dev, seed, card)
        torch.cuda.empty_cache()
    rows = {}
    for seed in args.seeds:
        r = out[f"seed {seed}"]
        rows[seed] = {
            "histogram": r["precision_histogram"],
            "tile_ratio": r["fused_vs_unfused_tile_ratio"],
            "control_tile_ratio": r["control_tile_ratio"],
            "control_fused_vs_unfused": r["control_fused_vs_unfused_tile_ratio"],
            "e4m3_as_f16_tile_ratio": r["e4m3_as_f16_tile_ratio"],
            "backward": max(a["backward_err"] for a in r["accuracy"].values()),
            "loglik_rel": r["loglik_rel"],
            "loglik_control_rel": r["loglik_control_rel"],
            "abs_kl": {e: k["abs_kl"] for e, k in r["kl"].items()},
            "fused_factor_s": r["fused_factor_s"],
            "unfused_factor_s": r["unfused_factor_s"]}
        cs.log(f"seed {seed} [{card}]: " + json.dumps(rows[seed]))
    out["summary"] = rows
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "torch_geo_bounds.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
