"""Abstract inputs and sharding assignment for every (arch x shape) cell
(port of ``repro.launch.specs``).

``input_specs(cfg, shape)`` returns ``meta`` tensors standing in for every
model input (no allocation); ``abstract_params`` builds the model on the
``meta`` device with no RNG.  The ``*_shardings`` helpers map parameters,
optimizer state, inputs and caches onto a mesh through the logical-axis
rules, as :class:`~repro_torch.distributed.sharding.P` specs, keyed by
parameter name (the model's ``state_dict`` names) or, for a cache, one
dict a layer in layer order.  The reference stacks its scanned groups'
leaves on a leading ``"stack"`` axis that its rules never shard; the
port's parameters and caches are per layer, so that rule has nothing to
apply to.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.distributed.sharding import (P, axis_sizes, dp_entry,
                                              params_shardings)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim.adamw import OptState
from repro_torch.optim.quantized import BLOCK, Q8

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Abstract state (no allocation)

def abstract_params(cfg: ModelConfig) -> T.Model:
    """The model on the ``meta`` device: shapes, dtypes and logical axes,
    no storage."""
    return T.Model(cfg, None, META)


def abstract_opt_state(params_abs, quantized: bool = False) -> OptState:
    """``adamw_init``'s state on the ``meta`` device, built from shapes
    (a Q8 moment: an int8 payload of its parameter's shape and one f32
    scale a block of the last dim)."""
    def moment(p):
        if not quantized:
            return _empty(p.shape, torch.float32)
        blocks = -(-p.shape[-1] // BLOCK)
        return Q8(_empty(p.shape, torch.int8),
                  _empty(tuple(p.shape[:-1]) + (blocks,), torch.float32))

    flat = dict(params_abs.named_parameters())
    return OptState(step=_empty((), torch.int32),
                    m={k: moment(p) for k, p in flat.items()},
                    v={k: moment(p) for k, p in flat.items()})


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> list:
    return T.init_cache(cfg, batch, max_len, dtype, device=META)


def enc_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Encoder memory length for enc-dec archs (audio frames, stub)."""
    return min(shape.seq_len, 4096)


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors for the step function's data arguments (int32
    tokens, as the reference's)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = dtype_of(cfg.dtype)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _empty((b, s), i32)}
        if shape.kind == "train":
            out["labels"] = _empty((b, s), i32)
        if cfg.frontend:
            out["frontend_embeds"] = _empty(
                (b, cfg.frontend_tokens, cfg.d_model), act)
        if cfg.is_encdec:
            out["enc_embeds"] = _empty((b, enc_len(cfg, shape), cfg.d_model),
                                       act)
        return out
    # decode: one new token against a seq_len KV cache
    out = {"token": _empty((b, 1), i32), "pos": _empty((), i32)}
    if cfg.is_encdec:
        out["enc_out"] = _empty((b, enc_len(cfg, shape), cfg.d_model), act)
    return out


# ---------------------------------------------------------------------------
# Shardings

def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """A spec per ``input_specs`` entry (batch dim over DP)."""
    out = {}
    for name, t in input_specs(cfg, shape).items():
        out[name] = (P() if t.ndim == 0 else
                     P(dp_entry(mesh, t.shape[0]), *([None] * (t.ndim - 1))))
    return out


def q8_scale_spec(p_spec, scale_ndim: int, scale_last: int, mesh) -> P:
    """A Q8 moment's scale [..., blocks] follows its parameter's spec on
    all but the last dim, and on the last while the block count still
    divides (replicated scales at 340B cost 21 GB a chip)."""
    spec = list(p_spec)
    spec += [None] * (scale_ndim - len(spec))
    spec = spec[:scale_ndim]
    ax = spec[-1] if spec else None
    if ax is not None:
        sizes = axis_sizes(mesh)
        size = math.prod(sizes[a] for a in
                         (ax if isinstance(ax, tuple) else (ax,)))
        if scale_last % size != 0:
            spec[-1] = None
    return P(*spec)


def train_state_shardings(cfg: ModelConfig, mesh,
                          quantized_opt: bool = False):
    """(abstract model, {name: spec}, abstract OptState, OptState of
    specs): the moments follow their parameters; a Q8 moment is a ``Q8``
    of (payload spec, scale spec)."""
    params_abs = abstract_params(cfg)
    p_sh = params_shardings(params_abs, mesh)
    opt_abs = abstract_opt_state(params_abs, quantized=quantized_opt)

    def mom(moments):
        out = {}
        for k, leaf in moments.items():
            if isinstance(leaf, Q8):
                out[k] = Q8(q=p_sh[k], scale=q8_scale_spec(
                    p_sh[k], leaf.scale.ndim, leaf.scale.shape[-1], mesh))
            else:
                out[k] = p_sh[k]
        return out

    opt_sh = OptState(step=P(), m=mom(opt_abs.m), v=mom(opt_abs.v))
    return params_abs, p_sh, opt_abs, opt_sh


def _model_div(mesh, dim: int):
    return "model" if dim % axis_sizes(mesh)["model"] == 0 else None


def cache_leaf_spec(name: str, shape, mesh, seq_sharded: bool = False) -> P:
    """The spec of one cache leaf, by its name.

    KV caches [B,T,kv,hd]: batch over DP, kv heads over "model" (if they
    do not divide it, the sequence over "model"); for long context (B =
    1) the sequence over "data".  MLA's [B,T,r]: the sequence over
    "model".  SSM conv [B,K-1,ch] and state [B,nh,hd,n]: batch over DP,
    channels or heads over "model"."""
    model = axis_sizes(mesh)["model"]
    if name in ("k", "v"):
        kv_ax = _model_div(mesh, shape[2])
        seq_ax = ("data" if seq_sharded else
                  ("model" if kv_ax is None and shape[1] % model == 0
                   else None))
        spec = [dp_entry(mesh, shape[0]), seq_ax, kv_ax, None]
    elif name in ("c_kv", "k_rope"):
        seq_ax = ("data" if seq_sharded else
                  ("model" if shape[1] % model == 0 else None))
        spec = [dp_entry(mesh, shape[0]), seq_ax, None]
    elif name == "conv":
        spec = [dp_entry(mesh, shape[0]), None, _model_div(mesh, shape[2])]
    elif name == "state":
        spec = [dp_entry(mesh, shape[0]), _model_div(mesh, shape[1]),
                None, None]
    else:
        spec = [None] * len(shape)
    if seq_sharded and spec[0] is not None and "data" in spec[1:]:
        spec[0] = None if "pod" not in mesh.mesh_dim_names else "pod"
    return P(*spec)


def cache_shardings(cfg: ModelConfig, cache_abs: list, mesh,
                    seq_sharded: bool = False) -> list:
    """One ``{name: spec}`` a layer of a decode cache."""
    return [{name: cache_leaf_spec(name, tuple(t.shape), mesh, seq_sharded)
             for name, t in layer.items()} for layer in cache_abs]


def logits_sharding(cfg: ModelConfig, batch: int, mesh) -> P:
    return P(dp_entry(mesh, batch), None, _model_div(mesh, cfg.padded_vocab))


def sharded_bytes(tensors: dict, specs: dict, mesh) -> int:
    """Per-device bytes of ``{name: tensor}`` laid out by ``{name: spec}``
    (the reference's ``_sharded_bytes`` arithmetic: each leaf's bytes over
    the product of the mesh axes its spec names)."""
    sizes = axis_sizes(mesh)
    total = 0
    for name, t in tensors.items():
        n = t.element_size() * math.prod(t.shape)
        div = 1
        for entry in specs[name]:
            for a in (() if entry is None else
                      entry if isinstance(entry, tuple) else (entry,)):
                div *= sizes[a]
        total += n // div
    return total
