"""Error-feedback int8 gradient compression for the cross-pod all-reduce
(port of ``repro.optim.compress``).

Gradients crossing the "pod" axis are quantized to int8 with one scale a
128-element block; the quantization residual is fed back into the next
step's gradient (error feedback).  Per block: (1) agree on a common scale
(an all-reduce MAX of the scales, 1/128 of the payload), (2) sum the int8
payloads, (3) dequantize with the common scale.

The payloads are summed without an int8 ``all_reduce``: that would wrap
past 127 (two ranks' 100s sum to -112).  Each rank all-gathers the int8
payloads and sums them in int32.  The reference sums its payloads as f32
values (``jnp.round`` keeps f32); both sums are exact integers, so the
results are the reference's bit for bit.  What goes over the wire for a
tensor of N elements on a group of n ranks: each rank receives the other
ranks' int8 payloads, (n - 1) N bytes, and the scales' MAX all-reduce
moves 4 N / 128 bytes a rank in and out; an f32 ring all-reduce of the
gradient would move 2 (n - 1) / n x 4 N.

With ``group=None`` the collectives are skipped: the reference's path
outside a bound axis, quantize/dequantize and the residual only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .quantized import BLOCK


def ef_init(grads_like: dict) -> dict:
    """Zero error-feedback residuals, one a gradient."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}


def _blockify(x: torch.Tensor):
    last = x.shape[-1]
    pad = (-last) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, BLOCK), last


def _deblockify(b: torch.Tensor, last: int) -> torch.Tensor:
    return b.reshape(*b.shape[:-2], -1)[..., :last]


def _sum_int8(q: torch.Tensor, group) -> torch.Tensor:
    """The exact sum over ``group`` of the int8 payloads ``q``, in int32."""
    parts = [torch.empty_like(q) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, q.contiguous(), group=group)
    return torch.stack(parts).to(torch.int32).sum(0)


def compress_pod_gradients(grads: dict, ef_state: dict, group=None,
                           mean: bool = True):
    """(grads, ef_state) -> (reduced grads, new ef_state), both dicts keyed
    like ``grads``.  ``group``: the process group of the "pod" axis
    (``dist.group.WORLD`` for the whole world); None reduces nothing, as
    the reference outside a bound axis."""
    distributed = group is not None
    n = dist.get_world_size(group) if distributed else 1
    out, new_ef = {}, {}
    for k, g in grads.items():
        target = g.float() + ef_state[k]
        blocks, last = _blockify(target)
        # a tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, which is not the correctly rounded quotient
        scale = blocks.abs().amax(dim=-1) / torch.full_like(blocks[..., 0],
                                                            127.0)
        if distributed:
            scale = scale.contiguous()
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        safe = torch.where(scale == 0, 1.0, scale)
        q = torch.clamp(torch.round(blocks / safe[..., None]), -127, 127)
        local_hat = q * safe[..., None]           # what the wire carries
        new_ef[k] = target - _deblockify(local_hat, last)
        summed = q
        if n != 1:
            summed = _sum_int8(q.to(torch.int8), group).float()
        r = summed * safe[..., None]
        if mean and n != 1:
            r = r / torch.full_like(r, n)
        out[k] = _deblockify(r, last).to(g.dtype)
    return out, new_ef
