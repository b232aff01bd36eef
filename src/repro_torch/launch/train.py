"""Training driver: data pipeline -> train step -> checkpoints (port of
``repro.launch.train``), on one device or, with ``mesh``, on DTensors over
a mesh.

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
import contextlib
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.distributed.sharding import (P, activation_sharding,
                                              distribute, distribute_model,
                                              dp_entry)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptState, adamw_init


def device_batch(batch: dict, device) -> dict:
    """A pipeline batch of numpy tokens and labels as int64 tensors on
    ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def _local(x):
    """A DTensor's own block (a Q8 of DTensors field by field); anything
    else as it is."""
    if isinstance(x, tuple):
        return type(x)(*(_local(t) for t in x))
    return x.to_local() if isinstance(x, DTensor) else x


def _local_state(params, opt: OptState):
    """(the model's state_dict, the OptState), each DTensor as its own
    block: what this process checkpoints."""
    return ({k: _local(v) for k, v in params.state_dict().items()},
            OptState(step=opt.step, m={k: _local(x) for k, x in opt.m.items()},
                     v={k: _local(x) for k, x in opt.v.items()}))


def _restore_like(like, restored, device):
    """``restored`` (CPU blocks) in ``like``'s place on ``device``: a
    DTensor rebuilt from its block in ``like``'s layout."""
    if isinstance(like, tuple):
        return type(like)(*(_restore_like(a, b, device)
                            for a, b in zip(like, restored)))
    if isinstance(like, DTensor):
        return DTensor.from_local(restored.to(device), like.device_mesh,
                                  like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())
    return restored.to(device)


def train(arch: str = "qwen3-14b", smoke: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 64, lr: float = 1e-3,
          ckpt_dir: str | None = None, save_every: int = 50,
          mesh=None, quantized_opt: bool = False, accum_steps: int = 1,
          log_every: int = 10, seed: int = 0, device="cuda"):
    """Train ``arch`` (its smoke config unless ``smoke`` is False) from
    seeded weights on ``device``; returns (the model, the losses of the
    steps run here).

    ``mesh`` (a ``DeviceMesh`` on ("data", "model"), or the two-pod
    ("pod", "data", "model"), e.g. ``launch.mesh.make_smoke_mesh``): the
    parameters become DTensors laid out by ``params_shardings``, the f32
    moments follow them (Q8 moments are whole on every rank, the
    reference's replicated ones), each batch is split over the DP axes
    ("data", or "pod" and "data"; whole where they do not divide its
    rows), and the step runs under
    ``activation_sharding(mesh)``.  Every rank draws the same weights and
    batches from the seed.  A checkpoint then holds each process's own
    blocks (``host_<rank>.npz``) and restores into a run on the same
    mesh.  With more than one rank, the ranks agree on a SIGTERM's save at
    every step boundary (``CheckpointManager.agree_to_save``), so all of
    them save the same step."""
    cfg = get_config(arch, smoke=smoke)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                        seed=seed)
    params = T.init_model(cfg, seed, device)
    if mesh is not None:
        distribute_model(params, mesh)
    params.requires_grad_(True)
    opt = adamw_init(params, quantize=quantized_opt)

    def to_device(b):
        b = device_batch(b, device)
        if mesh is None:
            return b
        return {k: distribute(x, P(dp_entry(mesh, x.shape[0]), None), mesh)
                for k, x in b.items()}

    mgr = None
    start_step = 0
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        mgr.save_on_signal()
        latest = mgr.latest_step()
        if latest is not None:
            (state, opt_l), extra = mgr.restore(_local_state(params, opt))
            with torch.no_grad():
                for k, p in params.state_dict().items():
                    _local(p).copy_(state[k])
            opt = OptState(step=opt_l.step.to(device),
                           m={k: _restore_like(opt.m[k], x, device)
                              for k, x in opt_l.m.items()},
                           v={k: _restore_like(opt.v[k], x, device)
                              for k, x in opt_l.v.items()})
            start_step = int(extra["step"]) if extra else latest
            pipe.seek(start_step)
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, lr=lr, accum_steps=accum_steps,
                              quantized_opt=quantized_opt)
    agree = mesh is not None and mesh.size() > 1
    losses = []
    t0 = time.time()
    ctx = (activation_sharding(mesh) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        for i in range(start_step, steps):
            params, opt, metrics = step_fn(params, opt,
                                           to_device(next(pipe)))
            loss = float(metrics["loss"])
            losses.append(loss)
            if i % log_every == 0 or i == steps - 1:
                dt = time.time() - t0
                print(f"[train] step {i:5d}  loss {loss:.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"{dt:.1f}s", flush=True)
            if mgr:
                # every rank joins the agreement at every boundary
                now = (mgr.agree_to_save(mesh.device_type) if agree
                       else mgr.should_save_now)
                if i % save_every == save_every - 1 or now:
                    mgr.save(i + 1, _local_state(params, opt),
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
