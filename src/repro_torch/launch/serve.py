"""Serving driver: batched decode with a KV cache (port of
``repro.launch.serve``).

As in the reference, the prompt is replayed into the decode cache token by
token, and greedy tokens follow, with no autograd graph.  :func:`generate`
makes the parameters and prompts from a seed on the device;
:func:`decode_tokens` takes them, so a caller can hand it other weights and
prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of


@torch.no_grad()
def decode_tokens(params, cfg, prompts: torch.Tensor, gen_len: int,
                  enc_out=None):
    """Replay ``prompts`` [B, P] through decode, then take ``gen_len`` greedy
    tokens; every step of an encoder-decoder model cross-attends to
    ``enc_out`` where it is given.  Returns (tokens [B, gen_len] as numpy,
    decode tokens/s of the generation loop, the logits after the prompt
    [B, 1, padded_vocab])."""
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen_len
    dev = prompts.device
    cache = T.init_cache(cfg, batch, max_len, dtype_of(cfg.dtype), dev)
    serve = make_serve_step(cfg)

    logits = None
    for pos in range(prompt_len):
        logits, cache = serve(params, cache, prompts[:, pos:pos + 1], pos,
                              enc_out)
    prompt_logits = logits
    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1)

    out = [tok]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for pos in range(prompt_len, max_len - 1):
        logits, cache = serve(params, cache, tok, pos, enc_out)
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1)
        out.append(tok)
    tokens = torch.cat(out, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    tput = batch * (gen_len - 1) / max(dt, 1e-9)
    return tokens, tput, prompt_logits


@torch.no_grad()
def generate(arch: str = "gemma3-1b", smoke: bool = True, batch: int = 4,
             prompt_len: int = 16, gen_len: int = 16, seed: int = 0,
             device="cuda"):
    """Seeded parameters and prompts on ``device``; returns (tokens, tok/s)."""
    cfg = get_config(arch, smoke=smoke)
    params = T.init_model(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=device)
    tokens, tput, _ = decode_tokens(params, cfg, prompts, gen_len)
    return tokens, tput


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    toks, tput = generate(args.arch, batch=args.batch,
                          prompt_len=args.prompt_len, gen_len=args.gen_len,
                          device=args.device)
    print(f"[serve] generated {toks.shape} tokens, {tput:.1f} tok/s "
          f"(batched, smoke config, {args.device})")
    print(np.asarray(toks)[:2, :12])


if __name__ == "__main__":
    main()
