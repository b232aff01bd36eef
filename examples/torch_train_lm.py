"""Train a ~100M-param LM for a few hundred steps with checkpoints, on the
PyTorch/CUDA port.

The counterpart of ``examples/train_lm.py`` on ``repro_torch``: the qwen3
family at a ~100M reduced width, the deterministic data pipeline, the
train step, AdamW (optionally int8-quantized moments) and atomic
checkpoints, through ``repro_torch.launch.train.train`` on ``--device``
(the card unless ``cpu``).  Checkpoints go to ``--ckpt-dir``, by default a
temporary directory removed at the end.  The loss that must fall is the
first batch's, computed again after training: the steps' own losses are
of different batches, so over a few steps they need not fall.

  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""
import argparse
import tempfile

import torch

import repro_torch.launch.train as TR
from repro_torch.data import DataPipeline
from repro_torch.launch.steps import loss_fn
from repro_torch.models.config import ModelConfig

# ~100M params: 12L x 512d x 8H, vocab 32768
CFG_100M = ModelConfig(
    name="lm-100m", family="dense",
    num_layers=12, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
    d_ff=2048, vocab=32768,
    qk_norm=True, mlp_act="silu", scan_group=1, dtype="float32",
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--quantized-opt", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # register the custom config under a name train() can resolve
    orig = TR.get_config

    def patched(name, smoke=False):
        return CFG_100M if name == "lm-100m" else orig(name, smoke)

    TR.get_config = patched

    total, _ = CFG_100M.param_count()
    print(f"[example] lm-100m: {total/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq} "
          f"on {args.device}")
    first = TR.device_batch(next(DataPipeline(
        CFG_100M.vocab, args.seq, args.batch, seed=0)), args.device)
    with torch.no_grad():
        before = float(loss_fn(TR.T.init_model(CFG_100M, 0, args.device),
                               CFG_100M, first))
    with tempfile.TemporaryDirectory() as tmp:
        model, losses = TR.train(
            arch="lm-100m", smoke=False, steps=args.steps, batch=args.batch,
            seq=args.seq, lr=3e-4, ckpt_dir=args.ckpt_dir or tmp,
            save_every=100, quantized_opt=args.quantized_opt,
            device=args.device)
    with torch.no_grad():
        after = float(loss_fn(model, CFG_100M, first))
    print(f"[example] loss {losses[0]:.3f} -> {losses[-1]:.3f}; on the "
          f"first batch {before:.3f} -> {after:.3f} "
          f"({'improved' if after < before else 'NO IMPROVEMENT'})")
    assert after < before, "training must reduce the loss"


if __name__ == "__main__":
    main()
