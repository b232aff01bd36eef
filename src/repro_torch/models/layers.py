"""Shared building blocks: parameter init, norms, MLPs, rope, embeddings
(port of ``repro.models.layers``).

Parameters live in ``nn.Module``s with the reference's names and shapes
(``wi`` [d, f], ``wo`` [f, d], ``tok`` [vocab, d], ...), so carrying the
reference's weights across is a plain copy (:mod:`repro_torch.convert`).
Initialisation takes an explicit ``torch.Generator``: dense weights are
normal x 1/sqrt(fan_in), with the fan-in of the reference's ``dense`` calls,
and constants are zeros.  The two packages draw different numbers from one
seed.  Parameters are built with ``requires_grad=False``, so serving never
builds an autograd graph; the trainer (``repro_torch.launch.train``) turns
gradients on with ``model.requires_grad_(True)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``cfg.dtype``,
    ``cfg.param_dtype``: "float32", "bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


def dense(shape, gen: torch.Generator, dtype, device,
          fan_in: int | None = None) -> nn.Parameter:
    """normal(shape) / sqrt(fan_in), fan_in defaulting to ``shape[0]``."""
    fan_in = fan_in or shape[0]
    w = torch.empty(shape, dtype=dtype, device=device)
    w.normal_(generator=gen).mul_(1.0 / math.sqrt(max(fan_in, 1)))
    return nn.Parameter(w, requires_grad=False)


def const(shape, dtype, device, value: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * (1 + weight) in f32, back in x's type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + weight.float())).to(dt)


# ---------------------------------------------------------------------------
# MLP

class MLP(nn.Module):
    """Gated (silu, gelu: ``wi``, ``wg``, ``wo``) or plain (squared_relu:
    ``wi``, ``wo``) feed-forward block."""

    def __init__(self, d: int, f: int, act: str, gen, dtype, device):
        super().__init__()
        self.wi = dense((d, f), gen, dtype, device)
        if act in ("silu", "gelu"):
            self.wg = dense((d, f), gen, dtype, device)
        self.wo = dense((f, d), gen, dtype, device, fan_in=f)


def apply_mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p.wi.to(x.dtype)
    if act == "silu":
        g = x @ p.wg.to(x.dtype)
        h = F.silu(g) * h
    elif act == "gelu":
        g = x @ p.wg.to(x.dtype)
        h = F.gelu(g, approximate="tanh") * h     # jax.nn.gelu's default
    elif act == "squared_relu":
        r = F.relu(h)
        h = r * r
    else:
        raise ValueError(act)
    return h @ p.wo.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S].  Rotates the two halves of
    hd, with the angles in f32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # [hd/2]
    ang = positions[..., :, None].float() * freqs             # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding

class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, gen, dtype, device):
        super().__init__()
        self.tok = dense((vocab, d), gen, dtype, device, fan_in=d)


class Unembed(nn.Module):
    def __init__(self, d: int, vocab: int, gen, dtype, device):
        super().__init__()
        self.out = dense((d, vocab), gen, dtype, device)


def embed_tokens(p: Embedding, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    # the rows first, then the cast: the values of the reference's
    # cast-then-gather without a cast copy of the whole table
    return p.tok[tokens].to(dtype)


def unembed(p_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ p_out.to(x.dtype)
