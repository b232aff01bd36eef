"""Block-quantized (int8 + f32 scale) tensor storage (port of
``repro.optim.quantized``).

Adam moments are stored as int8 with one f32 scale per 128-element block of
the trailing dimension (symmetric absmax scaling), about a quarter of f32's
bytes.  The values are the reference's bit for bit: the last axis padded
with zeros up to a block, ``torch.round`` rounding half to even as
``jnp.round`` does, a block of zeros taking the scale 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

BLOCK = 128


class Q8(NamedTuple):
    q: torch.Tensor        # int8 payload, original shape
    scale: torch.Tensor    # f32, shape [..., ceil(last / BLOCK)]


def _pad_to_block(x: torch.Tensor):
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x, pad


def quantize_q8(x: torch.Tensor) -> Q8:
    orig_last = x.shape[-1]
    xp, _ = _pad_to_block(x.float())
    blocks = xp.reshape(*xp.shape[:-1], -1, BLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / safe[..., None]), -127, 127)
    q = q.to(torch.int8).reshape(*xp.shape[:-1], -1)[..., :orig_last]
    return Q8(q.contiguous(), scale)


def dequantize_q8(t: Q8, dtype=torch.float32) -> torch.Tensor:
    q = t.q.float()
    orig_last = q.shape[-1]
    qp, _ = _pad_to_block(q)
    blocks = qp.reshape(*qp.shape[:-1], -1, BLOCK)
    out = blocks * t.scale[..., None]
    return out.reshape(*qp.shape[:-1], -1)[..., :orig_last].to(dtype)


# ---------------------------------------------------------------------------
# Fourth-root coding for non-negative second moments.
#
# Linear int8 flushes small v entries in a block to 0, which explodes the
# Adam update m/(sqrt(v)+eps).  Quantizing u = v^(1/4) compresses the
# dynamic range (a 1e8 spread in v becomes 1e2 in u), bounding the
# relative error of sqrt(v) at ~2/127 per block.

def quantize_q8_root4(v: torch.Tensor) -> Q8:
    return quantize_q8(torch.sqrt(torch.sqrt(torch.clamp_min(v, 0.0))))


def dequantize_q8_root4(t: Q8, dtype=torch.float32) -> torch.Tensor:
    u = dequantize_q8(t, torch.float32)
    return torch.square(torch.square(u)).to(dtype)
