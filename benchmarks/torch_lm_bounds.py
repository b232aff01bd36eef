#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s flash and logit bounds, over seeds.

    python3 benchmarks/torch_lm_bounds.py [--seeds 0 1 2]

Runs ``chip_smoke.py``'s flash checks (every case, each output row against
its allowance, the dropped-KV-tile and zeroed-output controls, and each
bf16 case's mismatch share with its bf16-P control) and its LM
phase (qwen3-14b at published widths and depth: prefill against the plain
attention, against the decode replay, and the two faults each check must
reject) once per seed.  A failed requirement is logged, not raised, so
every seed's reading is kept.  Needs a CUDA device; writes
``chiprun_out/torch_lm_bounds.json``.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lm_bounds: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    cs.require = lambda ok, what: ok or cs.log(f"FAILS: {what}")
    _build.build()
    dev = torch.device("cuda")
    out = {"card": cs.card_line()}
    for seed in args.seeds:
        g = torch.Generator(device=dev).manual_seed(seed)
        out[f"seed {seed}"] = {"flash": cs.flash_checks(dev, g),
                               "lm": cs.lm_serving(dev, seed)}
        torch.cuda.empty_cache()
    rows = {}
    for seed in args.seeds:
        run = out[f"seed {seed}"]
        lm = run["lm"]
        rows[seed] = {
            "flash_row_ratio": max(r["row_ratio"]
                                   for r in run["flash"].values()),
            "flash_f32_quanta": max(
                r["err_in_f32_quanta_of_max_v"] for r in run["flash"].values()
                if r["dtype"] == "float32"),
            "flash_control_min": min(
                min(r["control_dropped_tile_ratio"], r["control_zeroed_ratio"])
                for r in run["flash"].values()),
            "flash_mismatch_share_max": max(
                r["mismatch_share"] for r in run["flash"].values()
                if "mismatch_share" in r),
            "flash_mismatch_control_min": min(
                r["control_bf16_p_mismatch_share"]
                for r in run["flash"].values() if "mismatch_share" in r),
            "flash_ffma_mismatch_share_max": max(
                r["ffma_mismatch_share"] for r in run["flash"].values()
                if "mismatch_share" in r),
            # [tensor-core kernel, FFMA kernel (P in f32), bf16-P control]
            "flash_mismatch_by_case": {
                tag: [r["mismatch_share"], r["ffma_mismatch_share"],
                      r["control_bf16_p_mismatch_share"]]
                for tag, r in run["flash"].items() if "mismatch_share" in r},
            "prefill_vs_plain": lm["prefill_vs_plain_max_diff"]
            / lm["prefill_max_logit"],
            "prefill_control_min": min(c["rel_diff"] for c in
                                       lm["prefill_controls"].values()),
            "replay": lm["prefill128_vs_replay_max_diff"]
            / lm["prefill128_max_logit"],
            "replay_control_min": min(c["rel_diff"] for c in
                                      lm["replay_controls"].values()),
            "decode_windows": lm["decode_window_tokens_per_s"]}
        cs.log(f"seed {seed}: " + json.dumps(rows[seed]))
    out["summary"] = rows
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "torch_lm_bounds.json").write_text(json.dumps(out, indent=1))
    cs.log(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
