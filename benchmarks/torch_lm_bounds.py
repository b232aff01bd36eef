#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s flash and logit bounds, over seeds.

    python3 benchmarks/torch_lm_bounds.py [--seeds 0 1 2] [--moe | --ssm
                                           --encdec | --train]

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
capacity control); with ``--ssm`` its SSM and hybrid phase (mamba2-130m
whole, jamba-1.5-large-398b cut to two layers) and with ``--encdec`` its
encoder-decoder and frontend phase (seamless-m4t-large-v2 whole,
llava-next-34b cut to 16 layers): each model's replay at every position of
its prompt with its controls (the SSM models' in f32, as the script
holds them, the others in bf16), and the same replay logged in the other
type;
seamless's and llava's flash prefill against the plain attention with its
faults; with ``--train`` the training phase's card-against-CPU check (a
train step in f32 on gemma3-1b at one scan group, mamba2-130m whole and
deepseek-v2-lite-16b at two layers: loss, grad_norm, every gradient, the
moments and parameters after, and the zeroed-mixer control).  A failed
requirement is logged, not raised, so
every seed's reading is kept.  Needs a CUDA device; writes
``chiprun_out/torch_lm_bounds.json`` (``torch_moe_bounds.json`` with
``--moe``, ``torch_ssm_encdec_bounds.json`` with ``--ssm``/``--encdec``,
``torch_train_bounds.json`` with ``--train``).
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
    ap.add_argument("--ssm", action="store_true",
                    help="read the SSM and hybrid phase instead")
    ap.add_argument("--encdec", action="store_true",
                    help="read the encoder-decoder and frontend phase "
                    "instead")
    ap.add_argument("--train", action="store_true",
                    help="read the training phase's card-against-CPU "
                    "check instead")
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
    if args.train:
        return train_bounds(cs, dev, args.seeds, out)
    if args.ssm or args.encdec:
        return family_bounds(cs, dev, args.seeds, out, args.ssm, args.encdec)
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


def train_bounds(cs, dev, seeds, out) -> int:
    keys = ("loss_rel", "grad_norm_rel", "grad_ratio", "moment_ratio",
            "step_lr_units", "control_grad_ratio")
    rows = {}
    for seed in seeds:
        run = cs.train_card_vs_cpu(dev, seed)
        out[f"seed {seed}"] = run
        torch.cuda.empty_cache()
        rows[seed] = {tag: {k: r[k] for k in keys} for tag, r in run.items()}
        cs.log(f"seed {seed}: " + json.dumps(rows[seed]))
    out["summary"] = rows
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "torch_train_bounds.json").write_text(json.dumps(out, indent=1))
    cs.log(out["card"])
    return 0


def family_bounds(cs, dev, seeds, out, ssm: bool, encdec: bool) -> int:
    rows = {}
    for seed in seeds:
        run = {}
        if ssm:
            run.update(cs.ssm_hybrid_serving(dev, seed, out["card"],
                                             logged_dtype="float32"))
            torch.cuda.empty_cache()
        if encdec:
            run.update(cs.encdec_frontend_serving(dev, seed, out["card"],
                                                  logged_dtype="float32"))
            torch.cuda.empty_cache()
        run.pop("seconds")
        run.pop("card")
        out[f"seed {seed}"] = run
        rows[seed] = {}
        for name, m in run.items():
            row = {
                "replay_dtype": m["replay"]["dtype"],
                "replay": m["replay"]["rel_diff"],
                "replay_argmax_agree": [m["replay"]["argmax_agree"],
                                        m["replay"]["rows"]],
                "replay_controls": {k: c["rel_diff"] for k, c in
                                    m["replay"]["controls"].items()},
                "replay_logged": {dt: [r["rel_diff"], r["argmax_agree"]]
                                  for dt, r in m["replay_logged"].items()},
                "prefill_s": m["prefill_s"],
                "prefill_peak_gb": m["prefill_peak_gb"],
                "decode_tokens_per_s": m["decode_tokens_per_s"],
                "peak_gb": m["peak_gb"]}
            if "prefill_vs_plain_rel" in m:
                row["prefill_vs_plain"] = m["prefill_vs_plain_rel"]
                row["prefill_controls"] = m["prefill_controls"]
            rows[seed][name] = row
        cs.log(f"seed {seed}: " + json.dumps(rows[seed]))
    out["summary"] = rows
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "torch_ssm_encdec_bounds.json").write_text(
        json.dumps(out, indent=1))
    cs.log(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
