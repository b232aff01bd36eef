"""Model assembly for the dense family: prefill and decode paths (port of
``repro.models.transformer``).

The reference splits the decoder into ``prefix`` layers, a region of
identical groups of ``cfg.scan_group`` layers run by ``lax.scan`` over
stacked parameters, and ``remainder`` layers (``_regions``).  Here every
layer is a module of its own, in layer order, and the scan is a Python loop;
remat has no meaning at inference.  Inside a scanned group the reference
passes layer index ``base + j`` (j the position in the group) to every
group, not the layer's absolute index, so ``layer_kind`` and
``layer_window`` of scanned layers follow ``base + j``: :func:`layer_indices`
gives that index for each layer, and the port uses it the same way.

Families the port does not cover yet raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_gqa

from . import attention as attn
from .config import ModelConfig
from .layers import (MLP, Embedding, Unembed, apply_mlp, const, dtype_of,
                     embed_tokens, rms_norm, unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family or feature the port does not run yet."""
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP queue 1 "
            f"item 13.2)")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue 1 "
            f"item 13.1)")
    if cfg.family in ("ssm", "hybrid") or cfg.ssm_state:
        raise NotImplementedError(
            f"{cfg.name}: SSM and hybrid layers are not ported yet (ROADMAP "
            f"queue 1 item 13.3)")
    if cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models and modality frontends are "
            f"not ported yet (ROADMAP queue 1 item 13.4)")


# ---------------------------------------------------------------------------
# Single layer

class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.ln1 = const((cfg.d_model,), dt, device)
        self.attn = attn.init_gqa(cfg, gen, device)
        if cfg.d_ff > 0:
            self.ln2 = const((cfg.d_model,), dt, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, gen, dt, device)


def init_layer(cfg: ModelConfig, idx: int, gen, device) -> Layer:
    """Layer ``idx``'s parameters (every dense layer has the same shapes)."""
    return Layer(cfg, gen, device)


def apply_layer(p: Layer, cfg: ModelConfig, idx: int, x, positions,
                flash=flash_gqa):
    # shard_act(x, "hidden") and residual_barrier are the identity outside
    # an activation_sharding context, and a single-device run is outside one
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    h = attn.apply_gqa(p.attn, cfg, h, positions,
                       window=cfg.layer_window(idx), flash=flash)
    x = x + h
    if hasattr(p, "mlp"):
        h = rms_norm(x, p.ln2, cfg.norm_eps)
        x = x + apply_mlp(p.mlp, h, cfg.mlp_act)
    return x


def init_layer_cache(cfg: ModelConfig, idx: int, batch, max_len, dtype,
                     device="cuda"):
    return attn.init_gqa_cache(cfg, batch, max_len, dtype,
                               window=cfg.layer_window(idx), device=device)


def decode_layer(p: Layer, cfg: ModelConfig, idx: int, x, cache, pos):
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    h, cache = attn.decode_gqa(p.attn, cfg, h, cache, pos,
                               window=cfg.layer_window(idx))
    x = x + h
    if hasattr(p, "mlp"):
        h = rms_norm(x, p.ln2, cfg.norm_eps)
        x = x + apply_mlp(p.mlp, h, cfg.mlp_act)
    return x, cache


# ---------------------------------------------------------------------------
# Model

def _regions(cfg: ModelConfig):
    """(prefix_idxs, n_groups, remainder_idxs)."""
    pre = list(range(cfg.first_dense))
    rest = cfg.num_layers - cfg.first_dense
    g = cfg.scan_group
    n_groups = rest // g
    rem_start = cfg.first_dense + n_groups * g
    rem = list(range(rem_start, cfg.num_layers))
    return pre, n_groups, rem


def layer_indices(cfg: ModelConfig) -> list:
    """The index the reference passes to each layer, in layer order: the
    prefix's own, ``first_dense + j`` for the j-th layer of every scanned
    group, the remainder's own."""
    pre, n_groups, rem = _regions(cfg)
    base = cfg.first_dense
    return pre + [base + j for _ in range(n_groups)
                  for j in range(cfg.scan_group)] + rem


class Model(nn.Module):
    """``embed.tok``, ``layers`` (in layer order, with ``layer_idx`` their
    reference indices), ``final_norm`` and, unless embeddings are tied,
    ``unembed.out``."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        check_supported(cfg)
        dt = dtype_of(cfg.param_dtype)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, gen, dt, device)
        self.layer_idx = layer_indices(cfg)
        self.layers = nn.ModuleList(init_layer(cfg, i, gen, device)
                                    for i in self.layer_idx)
        self.final_norm = const((cfg.d_model,), dt, device)
        if not cfg.tie_embeddings:
            self.unembed = Unembed(cfg.d_model, cfg.padded_vocab, gen, dt,
                                   device)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Weights from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, gen, device)


@torch.no_grad()
def forward(params: Model, cfg: ModelConfig, tokens, flash=flash_gqa):
    """Prefill forward pass -> final hidden states [B, S, d].  ``flash`` is
    the attention of the flash path (see ``attention.apply_gqa``)."""
    x = embed_tokens(params.embed, tokens, dtype_of(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i, lp in zip(params.layer_idx, params.layers):
        x = apply_layer(lp, cfg, i, x, positions, flash=flash)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def logits_from_hidden(params: Model, cfg: ModelConfig, hidden):
    out = (params.embed.tok.T if cfg.tie_embeddings
           else params.unembed.out)
    logits = unembed(out, hidden)
    if cfg.padded_vocab != cfg.vocab:
        # mask the padding columns (never predicted, zero softmax mass)
        logits[..., cfg.vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Decode

def init_cache(cfg: ModelConfig, batch, max_len, dtype,
               device="cuda") -> list:
    """One ``{"k", "v"}`` ring buffer per layer, in layer order (the
    reference stacks the scanned groups' caches on a leading axis)."""
    check_supported(cfg)
    return [init_layer_cache(cfg, i, batch, max_len, dtype, device)
            for i in layer_indices(cfg)]


@torch.no_grad()
def decode_step(params: Model, cfg: ModelConfig, token, cache, pos):
    """token: [B, 1] int; pos: the position (an int). Returns (logits,
    cache), the cache written in place."""
    x = embed_tokens(params.embed, token, dtype_of(cfg.dtype))
    for i, lp, c in zip(params.layer_idx, params.layers, cache):
        x, _ = decode_layer(lp, cfg, i, x, c, pos)
    h = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, h), cache
