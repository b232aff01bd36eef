#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s flash and logit bounds, over seeds.

    python3 benchmarks/torch_lm_bounds.py [--seeds 0 1 2] [--moe]

Runs ``chip_smoke.py``'s flash checks (every case, each output row against
its allowance, the dropped-KV-tile and zeroed-output controls, and each
bf16 case's mismatch share with its bf16-P control) and its LM
phase (qwen3-14b at published widths and depth: prefill against the plain
attention, against the decode replay, and the two faults each check must
reject) once per seed; with ``--moe`` its MoE and MLA phase instead
(deepseek-v2-lite-16b whole and dbrx-132b cut to two layers: the prefill
against the decode replay at a dropless capacity with the controls each
must reject, dbrx's flash prefill against the plain attention with its two
faults, and deepseek's first MoE layer against the plain mix with its
capacity control).  A failed requirement is logged, not raised, so
every seed's reading is kept.  Needs a CUDA device; writes
``chiprun_out/torch_lm_bounds.json`` (``torch_moe_bounds.json`` with
``--moe``).
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
    ap.add_argument("--moe", action="store_true",
                    help="read the MoE and MLA phase instead")
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
    if args.moe:
        return moe_bounds(cs, dev, args.seeds, out)
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


def moe_bounds(cs, dev, seeds, out) -> int:
    rows = {}
    for seed in seeds:
        run = cs.moe_mla_serving(dev, seed, out["card"])
        out[f"seed {seed}"] = run
        torch.cuda.empty_cache()
        ds, db = run["deepseek"], run["dbrx"]
        rows[seed] = {
            "deepseek_replay_f32": ds["replay"]["rel_diff"],
            "deepseek_replay_bf16": ds["replay_served_dtype"]["rel_diff"],
            "deepseek_replay_bf16_argmax_agree": ds["replay_served_dtype"][
                "argmax_agree"],
            "deepseek_replay_controls": {
                k: c["rel_diff"] for k, c in ds["replay"]["controls"].items()},
            "deepseek_mix_rel_err": ds["moe_layer_vs_plain_mix"]["rel_err"],
            "deepseek_mix_control": ds["moe_layer_vs_plain_mix"][
                "control_rel_err"],
            "dbrx_prefill_vs_plain": db["prefill_vs_plain_rel"],
            "dbrx_prefill_controls": db["prefill_controls"],
            "dbrx_replay": db["replay"]["rel_diff"],
            "dbrx_replay_controls": {
                k: c["rel_diff"] for k, c in db["replay"]["controls"].items()},
            "decode_tokens_per_s": [ds["decode_tokens_per_s"],
                                    db["decode_tokens_per_s"]]}
        cs.log(f"seed {seed}: " + json.dumps(rows[seed]))
    out["summary"] = rows
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "torch_moe_bounds.json").write_text(json.dumps(out, indent=1))
    cs.log(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
