"""AdamW with optionally int8-quantized moments (port of
``repro.optim.adamw``).

The moments are dicts keyed by the parameters' names (a model's
``named_parameters()``, which for the port's models are its
``state_dict`` names), each an f32 tensor or, with ``quantize=True``, a
:class:`~repro_torch.optim.quantized.Q8` (``v`` coded by its fourth root).
The update runs in f32 with the reference's formula in its order of
operations, ``(m / bc1) / (sqrt(v / bc2) + eps) + wd * p``, then
``p - lr * update``; ``torch.optim.AdamW`` rounds in another order and has
no Q8 state.  Parameters are updated in place; the moments are new tensors.
On DTensor parameters (a mesh) the f32 moments are DTensors in their
parameters' layouts; Q8 moments are whole tensors on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import like_param, local_block

from .quantized import (Q8, dequantize_q8, dequantize_q8_root4, quantize_q8,
                        quantize_q8_root4)


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: dict              # name -> f32 tensor or Q8
    v: dict


def named_params(params) -> dict:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _zeros_like_maybe_q8(p: torch.Tensor, quantize: bool):
    if quantize:      # Q8 moments are whole tensors on every rank
        return quantize_q8(torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device))
    return torch.zeros_like(p, dtype=torch.float32)


def adamw_init(params, quantize: bool = False) -> OptState:
    flat = named_params(params)
    dev = next(iter(flat.values())).device if flat else "cpu"
    m = {k: _zeros_like_maybe_q8(p, quantize) for k, p in flat.items()}
    v = {k: _zeros_like_maybe_q8(p, quantize) for k, p in flat.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=m, v=v)


def _step(p, g, m, v, b1, b2, bc1, bc2, eps, lr, weight_decay):
    """(new m, new v, new p) in f32, the parameter back in its type."""
    mf = dequantize_q8(m) if isinstance(m, Q8) else m
    vf = dequantize_q8_root4(v) if isinstance(v, Q8) else v
    mf = b1 * mf + (1.0 - b1) * g
    vf = b2 * vf + (1.0 - b2) * g * g
    update = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
    update = update + weight_decay * p.float()
    return mf, vf, (p.float() - lr * update).to(p.dtype)


@torch.no_grad()
def adamw_update(params, grads: dict, state: OptState, lr: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, quantize: bool = False):
    """One AdamW step on ``params`` (a module or a dict of tensors, written
    in place) with ``grads`` keyed by the same names.  Returns (params,
    the new OptState)."""
    step = state.step + 1
    t = step.float()
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), t)
    new_m, new_v = {}, {}
    for name, p in named_params(params).items():
        g = grads[name].float()
        m, v = state.m[name], state.v[name]
        if quantize and isinstance(p, DTensor):
            # Q8 moments are replicated (the reference's trainer): the
            # update runs on the whole tensors, each rank keeps its block
            g, whole = g.full_tensor(), p.full_tensor()
            mf, vf, new = _step(whole, g, m, v, b1, b2, bc1, bc2, eps, lr,
                                weight_decay)
            p.to_local().copy_(local_block(new, p))
            new_m[name], new_v[name] = quantize_q8(mf), quantize_q8_root4(vf)
            continue
        if isinstance(p, DTensor):
            # elementwise: each rank updates its own blocks, with the
            # gradient and the moments in the parameter's layout
            g, m, v = (like_param(x, p).to_local() for x in (g, m, v))
            mf, vf, new = _step(p.to_local(), g, m, v, b1, b2, bc1, bc2,
                                eps, lr, weight_decay)
            p.to_local().copy_(new)
            new_m[name], new_v[name] = (
                DTensor.from_local(x, p.device_mesh, p.placements,
                                   run_check=False, shape=p.shape,
                                   stride=p.stride()) for x in (mf, vf))
            continue
        mf, vf, new = _step(p, g, m, v, b1, b2, bc1, bc2, eps, lr,
                            weight_decay)
        p.copy_(new)
        if quantize:
            new_m[name], new_v[name] = quantize_q8(mf), quantize_q8_root4(vf)
        else:
            new_m[name], new_v[name] = mf, vf
    return params, OptState(step=step, m=new_m, v=new_v)
