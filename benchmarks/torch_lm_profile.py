#!/usr/bin/env python3
"""Where a serving step's time goes on the card (the PyTorch/CUDA port's
dense LM path).

    python3 benchmarks/torch_lm_profile.py [--seed 0]

Runs ``chip_smoke.py``'s model phase: qwen3-14b at published widths and
depth with the flash flag on, f32 parameters from ``--seed``, bf16
activations.  For the prefill step (4 x 2048 tokens) and for a decode step
(the same batch, after a replayed 128-token prompt) it reports:

* ``*_s``: wall seconds of one step (host clock around work that ends in
  ``torch.cuda.synchronize()``), after a warm-up step;
* device time by kernel from ``torch.profiler`` (CUDA activity only) over
  one more step, the sums by kind (the flash kernel, matrix products,
  copies and casts, the rest), and the device's idle share
  ``1 - busy / wall`` of that step (one stream, so the device intervals
  do not overlap and their sum is their union).

Needs a CUDA device; writes ``chiprun_out/torch_lm_profile.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

KINDS = (("flash", ("flash_kernel", "flash_wgmma_kernel")),
         ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "splitk")),
         ("copy/cast", ("copy", "Memcpy", "Memset")))


def _kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def profiled(fn) -> dict:
    """Wall seconds of ``fn`` (synchronized) and its device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if dt > 0:
            rows.append({"name": ev.key[:90], "count": ev.count,
                         "device_ms": dt / 1e3, "kind": _kind(ev.key)})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    by_kind = {}
    for r in rows:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["device_ms"]
    return {"wall_s": wall_s, "profiled_wall_s": prof_wall_s,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (prof_wall_s * 1e3),
            "by_kind_ms": by_kind, "by_name": rows[:20]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lm_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import dtype_of

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3-14b"), use_flash_attention=True)
    batch, seq = 4, 2048
    params = T.init_model(cfg, args.seed, dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                           device=dev)
    prefill = make_prefill_step(cfg)
    repro_torch.reset_counts()
    pre = profiled(lambda: prefill(params, {"tokens": tokens}))
    pre["flash_launches_per_step"] = repro_torch.launch_counts()[
        "flash_attention"] // 3
    pre["tokens_per_s"] = batch * seq / pre["wall_s"]

    prompt_len = 128
    cache = T.init_cache(cfg, batch, prompt_len + 8, dtype_of(cfg.dtype),
                         dev)
    serve = make_serve_step(cfg)
    for pos in range(prompt_len):
        serve(params, cache, tokens[:, pos:pos + 1], pos)
    tok = tokens[:, -1:]
    dec = profiled(lambda: serve(params, cache, tok, prompt_len))
    dec["tokens_per_s"] = batch / dec["wall_s"]

    out = {"card": card, "model": cfg.name, "layers": cfg.num_layers,
           "batch": batch, "seq": seq, "prefill": pre,
           "decode": dec, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "torch_lm_profile.json").write_text(json.dumps(out, indent=1))
    print(card)
    for tag, res in (("prefill", pre), ("decode", dec)):
        print(f"{tag}: {res['wall_s']:.4f} s, busy {res['device_busy_ms']:.1f} "
              f"ms, idle share {res['device_idle_share']:.3f}, by kind "
              + json.dumps({k: round(v, 3) for k, v in res['by_kind_ms'].items()}))
        for r in res["by_name"][:10]:
            print(f"  {r['device_ms']:10.3f} ms {r['count']:6d}  {r['name']}")
    print(json.dumps({"prefill_s": pre["wall_s"], "decode_s": dec["wall_s"],
                      "peak_gb": out["peak_gb"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
