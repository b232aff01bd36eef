"""Step functions of the serving path: prefill and decode (port of the
serving half of ``repro.launch.steps``; ``loss_fn`` and the train step come
with training, ROADMAP queue 1 item 13.5).

Factories close over the static config and return plain functions of
(params, ...) -> tensors.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_gqa
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _model_kwargs(batch: dict) -> None:
    if "frontend_embeds" in batch or "enc_embeds" in batch:
        raise NotImplementedError(
            "frontend and encoder inputs are not ported yet (ROADMAP queue 1 "
            "item 13.4)")


def make_prefill_step(cfg: ModelConfig, flash=flash_gqa):
    """(params, batch) -> last-position logits [B, padded_vocab].

    ``flash`` is the attention of the flash path: the kernel's wrapper, or
    its plain version for a check."""

    def prefill_step(params, batch):
        _model_kwargs(batch)
        h = T.forward(params, cfg, batch["tokens"], flash=flash)
        return T.logits_from_hidden(params, cfg, h[:, -1:, :])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, cache, token, pos) -> (logits, cache).

    One decode step: writes the token's KV at ``pos`` and attends over the
    cache."""

    def serve_step(params, cache, token, pos):
        return T.decode_step(params, cfg, token, cache, pos)

    return serve_step
