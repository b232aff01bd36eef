"""Model assembly for every family (dense, MoE, MLA, SSM, hybrid,
encoder-decoder, frontends): prefill and decode paths (port of
``repro.models.transformer``).

The reference splits the decoder into ``prefix`` layers, a region of
identical groups of ``cfg.scan_group`` layers run by ``lax.scan`` over
stacked parameters, and ``remainder`` layers (``_regions``).  Here every
layer is a module of its own, in layer order, and the scan is a Python loop.
Under grad with ``cfg.remat``, each scanned group runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body): its activations are recomputed in the backward pass; prefix and
remainder layers keep theirs.  ``forward`` and ``apply_encoder`` build a
graph when grad is on; ``decode_step`` never does, and the serving steps
run under ``torch.no_grad()``.  Inside a scanned group the reference
passes layer index ``base + j`` (j the position in the group) to every
group, not the layer's absolute index, so ``layer_kind``,
``layer_is_moe`` and ``layer_window`` of scanned layers follow ``base + j``:
:func:`layer_indices` gives that index for each layer, and the port uses it
the same way (jamba's attention layer is the last of each group of 8, its
MoE layers the odd ones).  A layer mixes with the SSM where ``layer_kind``
is ``"ssm"``, else attends with MLA where ``cfg.mla``, else with GQA; it
runs the MoE FFN where ``cfg.layer_is_moe`` of its index, else the dense
MLP.  Encoder-decoder models add an encoder (bidirectional GQA and an MLP a
layer) and a cross-attention block in each decoder layer; a frontend's
embeddings overwrite the leading token positions.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (in_layout, recompute_context,
                                              residual_barrier,
                                              sequence_whole, shard_act)
from repro_torch.kernels.flash_attention import flash_gqa

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (MLP, Embedding, Unembed, apply_mlp, const, dtype_of,
                     embed_tokens, rms_norm, unembed)

EMBED = ("embed",)


# ---------------------------------------------------------------------------
# Single layer

class Layer(nn.Module):
    """``ln1`` with ``ssm``, or ``attn`` (MLA or GQA); for encoder-decoder
    models ``cross_ln`` and ``cross``; where the layer has an FFN, ``ln2``
    with ``moe`` or ``mlp``."""

    def __init__(self, cfg: ModelConfig, idx: int, gen, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.ln1 = const((cfg.d_model,), dt, device, axes=EMBED)
        if cfg.layer_kind(idx) == "ssm":
            self.ssm = ssm_mod.init_ssm(cfg, gen, device)
        else:
            self.attn = (attn.init_mla(cfg, gen, device) if cfg.mla
                         else attn.init_gqa(cfg, gen, device))
        if cfg.is_encdec:
            self.cross_ln = const((cfg.d_model,), dt, device, axes=EMBED)
            self.cross = attn.init_cross(cfg, gen, device)
        if cfg.layer_is_moe(idx):
            self.ln2 = const((cfg.d_model,), dt, device, axes=EMBED)
            self.moe = moe_mod.init_moe(cfg, gen, device)
        elif cfg.d_ff > 0:
            self.ln2 = const((cfg.d_model,), dt, device, axes=EMBED)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, gen, dt, device)


def init_layer(cfg: ModelConfig, idx: int, gen, device) -> Layer:
    """Layer ``idx``'s parameters (``idx`` as :func:`layer_indices` gives
    it)."""
    return Layer(cfg, idx, gen, device)


def _block_out(h):
    """A block's output in the residual stream's layout.  Under a mesh a
    tensor-parallel block ends in partial sums over "model"; this is where
    they are reduced (Megatron's TP all-reduce, which XLA places at the
    same residual add).  The identity outside a context."""
    return shard_act(h, "hidden")


def _block_in(x, norm, eps: float):
    """A block's input: the residual stream ``x`` normed, its sequence
    whole where a layout splits it (``sequence_whole``: Megatron's gather
    before the column-parallel products; :func:`_block_out` splits it
    again).  The norm alone outside a mesh."""
    return sequence_whole(rms_norm(x, norm, eps))


def _cross_and_ffn(p: Layer, cfg: ModelConfig, x, enc_out):
    if cfg.is_encdec and enc_out is not None:
        h = _block_in(x, p.cross_ln, cfg.norm_eps)
        x = x + _block_out(attn.apply_cross(
            p.cross, cfg, h, attn.cross_kv(p.cross, enc_out)))
    if hasattr(p, "moe"):
        h = _block_in(x, p.ln2, cfg.norm_eps)
        return x + _block_out(moe_mod.apply_moe(p.moe, cfg, h))
    if hasattr(p, "mlp"):
        h = _block_in(x, p.ln2, cfg.norm_eps)
        return x + _block_out(apply_mlp(p.mlp, h, cfg.mlp_act))
    return x


def apply_layer(p: Layer, cfg: ModelConfig, idx: int, x, positions,
                enc_out=None, flash=flash_gqa):
    x = shard_act(x, "hidden")
    h = _block_in(x, p.ln1, cfg.norm_eps)
    if cfg.layer_kind(idx) == "ssm":
        h = ssm_mod.apply_ssm(p.ssm, cfg, h)
    elif cfg.mla:
        h = attn.apply_mla(p.attn, cfg, h, positions)
    else:
        h = attn.apply_gqa(p.attn, cfg, h, positions,
                           window=cfg.layer_window(idx), flash=flash)
    return residual_barrier(_cross_and_ffn(p, cfg, x + _block_out(h),
                                           enc_out))


def init_layer_cache(cfg: ModelConfig, idx: int, batch, max_len, dtype,
                     device="cuda"):
    if cfg.layer_kind(idx) == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device=device)
    if cfg.mla:
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device=device)
    return attn.init_gqa_cache(cfg, batch, max_len, dtype,
                               window=cfg.layer_window(idx), device=device)


def decode_layer(p: Layer, cfg: ModelConfig, idx: int, x, cache, pos,
                 enc_out=None):
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if cfg.layer_kind(idx) == "ssm":
        h, cache = ssm_mod.decode_ssm(p.ssm, cfg, h, cache)
    elif cfg.mla:
        h, cache = attn.decode_mla(p.attn, cfg, h, cache, pos)
    else:
        h, cache = attn.decode_gqa(p.attn, cfg, h, cache, pos,
                                   window=cfg.layer_window(idx))
    return _cross_and_ffn(p, cfg, x + _block_out(h), enc_out), cache


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


class EncoderLayer(nn.Module):
    """``ln1``, ``attn`` (GQA, run bidirectionally), ``ln2`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.ln1 = const((cfg.d_model,), dt, device, axes=EMBED)
        self.attn = attn.init_gqa(cfg, gen, device)
        self.ln2 = const((cfg.d_model,), dt, device, axes=EMBED)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, gen, dt, device)


class Model(nn.Module):
    """``embed.tok``, ``layers`` (in layer order, with ``layer_idx`` their
    reference indices), ``final_norm``, unless embeddings are tied
    ``unembed.out``, and for encoder-decoder models ``encoder`` (a list of
    :class:`EncoderLayer`) and ``enc_final_norm``."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, gen, dt, device)
        self.layer_idx = layer_indices(cfg)
        self.layers = nn.ModuleList(init_layer(cfg, i, gen, device)
                                    for i in self.layer_idx)
        self.final_norm = const((cfg.d_model,), dt, device, axes=EMBED)
        if not cfg.tie_embeddings:
            self.unembed = Unembed(cfg.d_model, cfg.padded_vocab, gen, dt,
                                   device)
        if cfg.is_encdec:
            self.encoder = nn.ModuleList(EncoderLayer(cfg, gen, device)
                                         for _ in range(cfg.enc_layers))
            self.enc_final_norm = const((cfg.d_model,), dt, device, axes=EMBED)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Weights from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, gen, device)


def apply_encoder(params: Model, cfg: ModelConfig, enc_embeds):
    """The encoder's output [B, T, d] for ``enc_embeds`` [B, T, d] (the
    reference's ``_apply_encoder``): what ``decode_step`` takes as
    ``enc_out``."""
    x = enc_embeds
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params.encoder:
        h = _block_in(x, lp.ln1, cfg.norm_eps)
        x = x + _block_out(attn.apply_bidir(lp.attn, cfg, h, positions))
        h = _block_in(x, lp.ln2, cfg.norm_eps)
        x = x + _block_out(apply_mlp(lp.mlp, h, cfg.mlp_act))
    return sequence_whole(rms_norm(x, params.enc_final_norm, cfg.norm_eps))


def _apply_layers(layers, cfg: ModelConfig, x, positions, enc_out, flash):
    for i, lp in layers:
        x = apply_layer(lp, cfg, i, x, positions, enc_out, flash=flash)
    return x


def forward(params: Model, cfg: ModelConfig, tokens, frontend_embeds=None,
            enc_embeds=None, flash=flash_gqa):
    """Train/prefill forward pass -> final hidden states [B, S, d].

    ``frontend_embeds`` [B, n, d] take the place of the first n positions'
    token embeddings; an encoder-decoder model needs ``enc_embeds`` [B, T,
    d], which its encoder reads.  ``flash`` is the attention of the flash
    path (see ``attention.apply_gqa``).  Under grad with ``cfg.remat`` each
    scanned group is rematerialised."""
    dtype = dtype_of(cfg.dtype)
    x = embed_tokens(params.embed, tokens, dtype)
    if frontend_embeds is not None:
        # modality stub: frontend embeddings overwrite the leading positions
        # (before the layout, which may split the sequence)
        n = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(dtype), x[:, n:]], dim=1)
    x = shard_act(x, "hidden")
    enc_out = None
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"enc_embeds")
        enc_out = apply_encoder(params, cfg, enc_embeds.to(dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layers = list(zip(params.layer_idx, params.layers))
    pre, n_groups, _ = _regions(cfg)
    g, stop = cfg.scan_group, len(pre) + n_groups * cfg.scan_group
    remat = cfg.remat and torch.is_grad_enabled()
    x = _apply_layers(layers[:len(pre)], cfg, x, positions, enc_out, flash)
    for start in range(len(pre), stop, g):
        group = layers[start:start + g]
        if remat:
            x = checkpoint(_apply_layers, group, cfg, x, positions, enc_out,
                           flash, use_reentrant=False,
                           context_fn=recompute_context)
        else:
            x = _apply_layers(group, cfg, x, positions, enc_out, flash)
    x = _apply_layers(layers[stop:], cfg, x, positions, enc_out, flash)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def logits_from_hidden(params: Model, cfg: ModelConfig, hidden):
    out = (in_layout(params.embed.tok).T if cfg.tie_embeddings
           else params.unembed.out)
    logits = unembed(out, sequence_whole(hidden))
    if cfg.padded_vocab != cfg.vocab:
        # mask the padding columns (never predicted, zero softmax mass); a
        # DTensor's vocab may be sharded, so it takes the out-of-place mask
        if isinstance(logits, DTensor):
            cols = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = logits.masked_fill(cols >= cfg.vocab, -1e30)
        else:
            logits[..., cfg.vocab:] = -1e30
    return shard_act(logits, "logits")


# ---------------------------------------------------------------------------
# Decode

def init_cache(cfg: ModelConfig, batch, max_len, dtype,
               device="cuda") -> list:
    """One cache per layer, in layer order: a ``{"k", "v"}`` ring buffer,
    MLA's linear ``{"c_kv", "k_rope"}``, or an SSM layer's ``{"conv",
    "state"}`` (the reference stacks the scanned groups' caches on a
    leading axis)."""
    return [init_layer_cache(cfg, i, batch, max_len, dtype, device)
            for i in layer_indices(cfg)]


@torch.no_grad()
def decode_step(params: Model, cfg: ModelConfig, token, cache, pos,
                enc_out=None):
    """token: [B, 1] int; pos: the position (an int); ``enc_out``: the
    encoder's output, whose keys and values each step recomputes, as the
    reference does (without it an encoder-decoder model skips its
    cross-attention).  Returns (logits, cache), the cache written in
    place."""
    x = embed_tokens(params.embed, token, dtype_of(cfg.dtype))
    for i, lp, c in zip(params.layer_idx, params.layers, cache):
        x, _ = decode_layer(lp, cfg, i, x, c, pos, enc_out)
    h = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, h), cache
