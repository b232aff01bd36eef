#!/usr/bin/env python3
"""Device time of the GEMM update kernel at each launch geometry.

    python3 benchmarks/torch_gemm_geometry.py [--sizes 512 2048] [--reps 100]

For each square size n (C - A B^T with n x n f32 operands, TF32 off) and
each split 1, 2, 4 and 8 of the kernel's 128 x 64 tiles (split 1 is one CTA
a tile walking all of K: the FFMA main loop alone, no cluster reduction),
the device time a call (``chip_smoke.device_ms``) beside the
wrapper's own geometry, ``c - a @ b.T`` and ``a @ b.T`` alone, and the rate
2 n^3 / time.  Needs a CUDA device; writes
``chiprun_out/torch_gemm_geometry.json``.
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
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 2048])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gemm_geometry: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, mxp_gemm
    _build.build(["mxp_gemm"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"card": cs.card_line(), "sizes": {}}
    for n in args.sizes:
        c = cs._spd(n, g, dev)
        a = torch.randn(n, n, generator=g, device=dev)
        b = torch.randn(n, n, generator=g, device=dev)
        reps = max(5, args.reps * 512 ** 3 // n ** 3)
        row = {"geometry": mxp_gemm.geometry(n, n, n)}
        row["wrapper_ms"] = cs.device_ms(
            lambda: mxp_gemm.mxp_gemm_update(c, a, b), reps)
        for split in (1, 2, 4, 8):
            geo = mxp_gemm.split_for(n, n, n, split)
            row[f"split={geo[0]}"] = cs.device_ms(
                lambda: mxp_gemm._launch(c, a, b, *geo), reps)
        row["library_ms"] = cs.device_ms(lambda: c - a @ b.T, reps)
        row["library_matmul_only_ms"] = cs.device_ms(lambda: a @ b.T, reps)
        flops = 2.0 * n ** 3
        row["tflops"] = {k: flops / (v * 1e-3) / 1e12
                         for k, v in row.items() if k.endswith("ms")
                         or "split=" in k}
        out["sizes"][str(n)] = row
        print(f"n={n}: " + json.dumps(row), flush=True)
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "torch_gemm_geometry.json").write_text(json.dumps(out, indent=1))
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
