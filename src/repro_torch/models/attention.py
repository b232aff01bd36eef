"""GQA attention (+ sliding window, qk-norm, logit softcap), the part of
``repro.models.attention`` that the dense family runs.

Prefill path: full-sequence causal attention, through the flash kernel
where the reference takes its Pallas kernel, else exact chunked attention in
plain torch ops.  Decode path: one query token against a ring-buffer KV
cache, updated in place (the reference returns a new cache; here the same
dict comes back with its slot written).  MLA, cross-attention and
bidirectional attention are not ported yet (ROADMAP queue 1 items 13.2 and
13.4).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_gqa

from .layers import apply_rope, const, dense, dtype_of, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# GQA

class GQA(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = dtype_of(cfg.param_dtype)
        self.wq = dense((d, h, hd), gen, dt, device)
        self.wk = dense((d, kvh, hd), gen, dt, device)
        self.wv = dense((d, kvh, hd), gen, dt, device)
        self.wo = dense((h, hd, d), gen, dt, device, fan_in=h * hd)
        if cfg.qk_norm:
            self.q_norm = const((hd,), dt, device)
            self.k_norm = const((hd,), dt, device)


def init_gqa(cfg, gen, device) -> GQA:
    return GQA(cfg, gen, device)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(p: GQA, cfg, x, positions):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: GQA, out: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = p.wo.shape
    return out.flatten(-2) @ p.wo.to(dtype).reshape(h * k, d)


def _sdpa(q, k, v, mask, softcap=None):
    """q: [B,S,H,hd], k/v: [B,T,KV,hd]; grouped-query broadcast."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, s, kvh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def causal_mask(s: int, window=None, device=None):
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= (i - j) < window
    return m[None, None, None]  # [1,1,1,S,T]


# Query-block size for the memory-bounded attention path: scores are
# materialized per block ([B,H,Qc,T] instead of [B,H,S,T]); exact softmax.
QCHUNK = 2048


def _block_mask(i_idx, j_idx, causal, window):
    m = torch.ones((i_idx.shape[0], j_idx.shape[0]), dtype=torch.bool,
                   device=i_idx.device)
    if causal:
        m &= j_idx[None, :] <= i_idx[:, None]
    if window is not None:
        m &= (i_idx[:, None] - j_idx[None, :]) < window
    return m[None, None, None]  # [1,1,1,Qc,T]


def _sdpa_chunked(q, k, v, *, causal=True, window=None, softcap=None,
                  qchunk: int = QCHUNK):
    """Exact attention over query blocks of ``qchunk`` rows (one block when
    S <= qchunk or S % qchunk); live scores are [B,KV,G,Qc,T]."""
    b, s, h, hd = q.shape
    j_idx = torch.arange(k.shape[1], device=q.device)
    if s <= qchunk or s % qchunk != 0:
        mask = _block_mask(torch.arange(s, device=q.device), j_idx, causal,
                           window)
        return _sdpa(q, k, v, mask, softcap)
    outs = []
    for start in range(0, s, qchunk):
        i_idx = start + torch.arange(qchunk, device=q.device)
        mask = _block_mask(i_idx, j_idx, causal, window)
        outs.append(_sdpa(q[:, start:start + qchunk], k, v, mask, softcap))
    return torch.cat(outs, dim=1)


def apply_gqa(p: GQA, cfg, x, positions, window=None, flash=flash_gqa):
    """``flash`` is the attention of the flash path (the kernel's wrapper;
    a check may pass its plain version, ``flash_gqa_ref``)."""
    q, k, v = _qkv(p, cfg, x, positions)
    # the reference's shard_act(q/out, "attn_q") is the identity outside an
    # activation_sharding context, and a single-device run is outside one
    if (cfg.use_flash_attention and window is None
            and cfg.attn_logit_softcap is None
            and x.shape[1] % 128 == 0):
        out = flash(q, k, v, causal=True, bq=min(512, x.shape[1]),
                    bk=min(512, x.shape[1]))
    else:
        out = _sdpa_chunked(q, k, v, causal=True, window=window,
                            softcap=cfg.attn_logit_softcap)
    return _out(p, out, x.dtype)


def gqa_cache_len(max_len: int, window=None) -> int:
    """Ring-buffer length: sliding-window layers cache only ~window
    positions (128-aligned)."""
    if window is None:
        return max_len
    return min(max_len, max((window + 127) // 128 * 128, 128))


def init_gqa_cache(cfg, batch, max_len, dtype, window=None, device="cuda"):
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    t_buf = gqa_cache_len(max_len, window)
    shape = (batch, t_buf, kvh, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_gqa(p: GQA, cfg, x, cache, pos: int, window=None):
    """x: [B,1,d]; pos: the current position (an int). Returns
    (out, cache), the cache's slot ``pos % t_buf`` written in place.

    Slot j's global position is ``pos - ((pos - j) mod t_buf)``; with
    t_buf == max_len this is the plain linear cache."""
    pos = int(pos)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    t_buf = cache["k"].shape[1]
    slot = pos % t_buf
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    j = torch.arange(t_buf, device=x.device)[None, :]
    gpos = pos - torch.remainder(pos - j, t_buf)
    mask = gpos >= 0
    if window is not None:
        mask &= (pos - gpos) < window
    mask = mask[None, None, None]                       # [1,1,1,1,Tb]
    out = _sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask,
                cfg.attn_logit_softcap)
    return _out(p, out, x.dtype), cache
