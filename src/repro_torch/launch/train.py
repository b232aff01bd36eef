"""Training driver: data pipeline -> train step -> checkpoints (port of
``repro.launch.train``, on one device).

Fault tolerance: atomic checkpoints every ``save_every`` steps, SIGTERM
installs a checkpoint-now request, restart resumes the parameters, the
optimizer state and the data stream's position.  A checkpoint holds the
model's ``state_dict``, the ``OptState`` and, in its extra, the step and the
pipeline's state.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
      --steps 200 --batch 8 --seq 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptState, adamw_init


def device_batch(batch: dict, device) -> dict:
    """A pipeline batch of numpy tokens and labels as int64 tensors on
    ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def _opt_to(opt: OptState, device) -> OptState:
    def to(x):
        if isinstance(x, tuple):
            return type(x)(*(t.to(device) for t in x))
        return x.to(device)
    return OptState(step=opt.step.to(device),
                    m={k: to(x) for k, x in opt.m.items()},
                    v={k: to(x) for k, x in opt.v.items()})


def train(arch: str = "qwen3-14b", smoke: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 64, lr: float = 1e-3,
          ckpt_dir: str | None = None, save_every: int = 50,
          quantized_opt: bool = False, accum_steps: int = 1,
          log_every: int = 10, seed: int = 0, device="cuda"):
    """Train ``arch`` (its smoke config unless ``smoke`` is False) from
    seeded weights on ``device``; returns (the model, the losses of the
    steps run here)."""
    cfg = get_config(arch, smoke=smoke)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                        seed=seed)
    params = T.init_model(cfg, seed, device).requires_grad_(True)
    opt = adamw_init(params, quantize=quantized_opt)

    mgr = None
    start_step = 0
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        mgr.save_on_signal()
        latest = mgr.latest_step()
        if latest is not None:
            (state, opt), extra = mgr.restore((params.state_dict(), opt))
            params.load_state_dict(state)
            opt = _opt_to(opt, device)
            start_step = int(extra["step"]) if extra else latest
            pipe.seek(start_step)
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, lr=lr, accum_steps=accum_steps,
                              quantized_opt=quantized_opt)
    losses = []
    t0 = time.time()
    for i in range(start_step, steps):
        params, opt, metrics = step_fn(params, opt,
                                       device_batch(next(pipe), device))
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            dt = time.time() - t0
            print(f"[train] step {i:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{dt:.1f}s", flush=True)
        if mgr and (i % save_every == save_every - 1
                    or mgr.should_save_now):
            mgr.save(i + 1, (params.state_dict(), opt),
                     extra={"step": i + 1,
                            "pipeline": pipe.state.to_dict()})
    return params, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--quantized-opt", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _, losses = train(arch=args.arch, smoke=not args.full, steps=args.steps,
                      batch=args.batch, seq=args.seq, lr=args.lr,
                      ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                      accum_steps=args.accum_steps,
                      quantized_opt=args.quantized_opt, device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} -> "
          f"last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
