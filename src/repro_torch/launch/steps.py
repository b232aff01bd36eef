"""Step functions: train (CE loss + AdamW), prefill, decode (port of
``repro.launch.steps``).

Factories close over the static config and return plain functions of
(params, ...) -> tensors.  The train step differentiates ``loss_fn`` with
``torch.autograd.grad`` (the parameters must require grad:
``model.requires_grad_(True)``) and updates the parameters in place; the
prefill and decode steps build no graph.

Gradient accumulation: ``accum_steps > 1`` splits the batch into
contiguous microbatches and sums their f32 gradients, each divided by
``accum_steps``, as the reference's scan does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_gqa
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import adamw_update, named_params


def _model_kwargs(batch: dict) -> dict:
    """The batch's frontend and encoder inputs, as ``T.forward`` takes
    them."""
    return {k: batch[k] for k in ("frontend_embeds", "enc_embeds")
            if k in batch}


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """Mean next-token cross-entropy (f32 log-softmax over the vocab)."""
    h = T.forward(params, cfg, batch["tokens"], **_model_kwargs(batch))
    logits = T.logits_from_hidden(params, cfg, h).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["labels"].long()[..., None])
    return -torch.mean(ll)


def loss_and_grads(params, cfg: ModelConfig, batch: dict):
    """(the loss, {name: its gradient}) of ``loss_fn`` at ``params``, whose
    parameters must require grad; a parameter the loss does not reach gets
    zeros, as ``jax.grad`` gives it."""
    names, leaves = zip(*named_params(params).items())
    if not all(p.requires_grad for p in leaves):
        raise ValueError("make_train_step: the parameters must require "
                         "grad (model.requires_grad_(True))")
    with torch.enable_grad():
        loss = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def grad_norm(grads: dict) -> torch.Tensor:
    """The f32 norm over every gradient."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    weight_decay: float = 0.01, accum_steps: int = 1,
                    quantized_opt: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    ``metrics`` {"loss", "grad_norm"} as f32 scalars on the device."""

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = loss_and_grads(params, cfg, batch)
        else:
            micro = {k: x.reshape(accum_steps, x.shape[0] // accum_steps,
                                  *x.shape[1:]) for k, x in batch.items()}
            grads, losses = None, []
            for i in range(accum_steps):
                l, g = loss_and_grads(params, cfg,
                                      {k: x[i] for k, x in micro.items()})
                if grads is None:
                    grads = {k: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device)
                             for k, x in g.items()}
                for k, x in g.items():
                    grads[k] += x.float() / accum_steps
                losses.append(l)
                del g
            loss = torch.mean(torch.stack(losses))
        gnorm = grad_norm(grads)
        params, opt_state = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay,
            quantize=quantized_opt)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, flash=flash_gqa):
    """(params, batch) -> last-position logits [B, padded_vocab], with no
    graph.

    ``flash`` is the attention of the flash path: the kernel's wrapper, or
    its plain version for a check."""

    @torch.no_grad()
    def prefill_step(params, batch):
        h = T.forward(params, cfg, batch["tokens"], flash=flash,
                      **_model_kwargs(batch))
        return T.logits_from_hidden(params, cfg, h[:, -1:, :])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, cache, token, pos[, enc_out]) -> (logits, cache).

    One decode step: writes the token's KV (or SSM state) at ``pos`` and
    attends over the cache; an encoder-decoder model's cross-attention
    reads ``enc_out``."""

    def serve_step(params, cache, token, pos, enc_out=None):
        return T.decode_step(params, cfg, token, cache, pos, enc_out=enc_out)

    return serve_step
