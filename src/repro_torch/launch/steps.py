"""Step functions of the serving path: prefill and decode (port of the
serving half of ``repro.launch.steps``).  ``loss_fn`` and the train step
come with training (ROADMAP queue 1 item 13.5) and raise until then.

Factories close over the static config and return plain functions of
(params, ...) -> tensors.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_gqa
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

_TRAINING = "training is not ported yet (ROADMAP queue 1 item 13.5)"


def _model_kwargs(batch: dict) -> dict:
    """The batch's frontend and encoder inputs, as ``T.forward`` takes
    them."""
    return {k: batch[k] for k in ("frontend_embeds", "enc_embeds")
            if k in batch}


def loss_fn(params, cfg: ModelConfig, batch: dict):
    raise NotImplementedError(f"loss_fn: {_TRAINING}")


def make_train_step(cfg: ModelConfig, **optimizer):
    raise NotImplementedError(f"make_train_step: {_TRAINING}")


def make_prefill_step(cfg: ModelConfig, flash=flash_gqa):
    """(params, batch) -> last-position logits [B, padded_vocab].

    ``flash`` is the attention of the flash path: the kernel's wrapper, or
    its plain version for a check."""

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
