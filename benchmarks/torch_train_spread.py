#!/usr/bin/env python3
"""The card's run-to-run spread of a train step's card-against-CPU check.

    python3 benchmarks/torch_train_spread.py [--root DIR] [--seed 0]

Runs ``chip_smoke.card_vs_cpu`` on deepseek-v2-lite-16b at
``DEEPSEEK_TRAIN_LAYERS`` layers (phase 10e's check: one f32 train step on
the card and on the CPU from the same weights and batch) four times, each
in a process of its own, in turns on two trees: ``--root``'s (another
checkout, for example a parent commit unpacked under ``build/``), this
one's, this one's, ``--root``'s.  Readings that move between two runs of
one tree are the card's spread, not a change's.  Needs a CUDA device;
prints one JSON line a run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r'''
import dataclasses, json, sys
import torch
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import chip_smoke as C
import repro_torch
from repro_torch.configs import get_config
assert repro_torch.__file__.startswith(root), repro_torch.__file__
cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                          num_layers=C.DEEPSEEK_TRAIN_LAYERS)
r = C.card_vs_cpu("deepseek-v2-lite-16b", cfg, torch.device("cuda"),
                  int(sys.argv[2]))
print("RESULT " + json.dumps({k: r[k] for k in (
    "grad_ratio", "moment_ratio", "loss_rel", "grad_norm_rel",
    "step_lr_units")}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT / "build" / "parent")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_spread: needs a CUDA device", file=sys.stderr)
        return 2
    other = str(args.root.resolve())
    rc = 0
    for tree in (other, str(ROOT), str(ROOT), other):
        p = subprocess.run([sys.executable, "-c", RUN, tree, str(args.seed)],
                           capture_output=True, text=True)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        rec = {"tree": tree, "rc": p.returncode}
        rec.update(json.loads(line[0][7:]) if line
                   else {"error": p.stderr[-1500:]})
        rc = rc or p.returncode
        print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
