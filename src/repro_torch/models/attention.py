"""Attention variants: GQA (+ sliding window, qk-norm, logit softcap), MLA,
cross-attention and the encoder's bidirectional attention (port of
``repro.models.attention``).

Prefill path: full-sequence causal attention, through the flash kernel
where the reference takes its Pallas kernel, else exact chunked attention in
plain torch ops.  Decode path: one query token against a ring-buffer KV
cache, updated in place (the reference returns a new cache; here the same
dict comes back with its slot written).  MLA caches the compressed KV and
the rope key in a linear cache.  Cross-attention (decoder queries over the
encoder's output) and bidirectional attention take the chunked path with no
mask, as in the reference: neither reaches its Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (P, axis_sizes, block_range,
                                              contiguous_grad, divisible,
                                              dp_entry, on_local_blocks,
                                              placements,
                                              seq_split, shard_act, spec_of,
                                              write_position)
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
        self.wq = dense((d, h, hd), gen, dt, device,
                        axes=("embed", "heads", None))
        self.wk = dense((d, kvh, hd), gen, dt, device,
                        axes=("embed", "kv", None))
        self.wv = dense((d, kvh, hd), gen, dt, device,
                        axes=("embed", "kv", None))
        self.wo = dense((h, hd, d), gen, dt, device, fan_in=h * hd,
                        axes=("heads", None, "embed"))
        if cfg.qk_norm:
            self.q_norm = const((hd,), dt, device, axes=(None,))
            self.k_norm = const((hd,), dt, device, axes=(None,))


def init_gqa(cfg, gen, device) -> GQA:
    return GQA(cfg, gen, device)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    y = x @ divisible(w.to(x.dtype).reshape(d, h * k), -1, h)
    return divisible(y, -1, h).unflatten(-1, (h, k))


def _qkv(p: GQA, cfg, x, positions):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: GQA, out: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd").  Where ``out``'s sequence is split (the
    context-parallel queries), on each rank's own rows against the whole
    weight: DTensor's product would flatten the split sequence."""
    h, k, d = p.wo.shape
    if seq_split(out):
        spec = spec_of(out)
        return on_local_blocks(_rows_out, (out, p.wo.to(dtype)), (spec, P()),
                               P(*spec[:2]), out.device_mesh)
    return (divisible(out.flatten(-2), -1, h)
            @ divisible(p.wo.to(dtype).reshape(h * k, d), 0, h))


def _rows_out(out, wo):
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _scores(q, k, softcap=None):
    """The scores [B,KV,G,S,T] in f32 of q [B,S,H,hd] against k [B,T,KV,hd]
    (grouped-query broadcast), scaled and softcapped, before the mask."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    q = divisible(q, 2, kvh).reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    return scores


def _weighted(w, v):
    """The heads' outputs [B,S,H,hd] of softmax weights w [B,KV,G,S,T] over
    v [B,T,KV,hd]."""
    b, kvh, g, s, _ = w.shape
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    # the gradient coming back may split the heads where kvh cannot
    return divisible(out.reshape(b, s, kvh * g, v.shape[-1]), 2, kvh)


def _sdpa(q, k, v, mask, softcap=None):
    """q: [B,S,H,hd], k/v: [B,T,KV,hd]; grouped-query broadcast."""
    scores = torch.where(mask, _scores(q, k, softcap), NEG_INF)
    return _weighted(torch.softmax(scores, dim=-1).to(q.dtype), v)


def _sdpa_split_cache(q, k, v, mask, softcap=None):
    """``_sdpa`` for decode over a cache k, v whose sequence is split: the
    scores and the weighted sum on each rank's own blocks (q's heads split
    as the cache's kv heads), the masked softmax on the DTensor scores
    (their [B,KV,G,1,T] gathered over the split, never the cache), and the
    output's partial sums over the split reduced."""
    mesh = k.device_mesh
    spec = tuple(spec_of(k)) + (None,) * 3
    b, t, kv = spec[:3]
    q_spec, s_spec = P(b, None, kv), P(b, kv, None, None, t)
    scores = on_local_blocks(_scores, (q, k), (q_spec, P(*spec)), s_spec,
                             mesh, softcap=softcap)
    w = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1).to(q.dtype)
    out = on_local_blocks(_weighted, (w, v), (s_spec, P(*spec)), q_spec,
                          mesh, partial=t)
    return out.redistribute(mesh, placements(q_spec, mesh))


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
                  qchunk: int = QCHUNK, q_offset: int = 0):
    """Exact attention over query blocks of ``qchunk`` rows (one block when
    S <= qchunk or S % qchunk); live scores are [B,KV,G,Qc,T].  Query row
    i sits at position ``q_offset + i`` (a block of a split sequence)."""
    b, s, h, hd = q.shape
    j_idx = torch.arange(k.shape[1], device=q.device)
    if s <= qchunk or s % qchunk != 0:
        mask = _block_mask(q_offset + torch.arange(s, device=q.device),
                           j_idx, causal, window)
        return _sdpa(q, k, v, mask, softcap)
    outs = []
    for start in range(0, s, qchunk):
        i_idx = q_offset + start + torch.arange(qchunk, device=q.device)
        mask = _block_mask(i_idx, j_idx, causal, window)
        outs.append(_sdpa(q[:, start:start + qchunk], k, v, mask, softcap))
    return torch.cat(outs, dim=1)


def _heads_entry(mesh, *counts):
    """The spec entry of a head dimension: "model" where it divides every
    head count in ``counts``, else None (whole)."""
    model = axis_sizes(mesh).get("model")
    return ("model" if model and all(c % model == 0 for c in counts)
            else None)


def _kv_run(mesh, h: int, kvh: int):
    """The kv heads [lo, hi) that this rank's block of query heads reads,
    where "model" splits the h query heads but not the kvh kv heads, and
    each rank's query heads lie within whole kv heads (one kv head shared
    by several ranks, or several kv heads a rank); else None."""
    m = axis_sizes(mesh).get("model", 1)
    if m == 1 or h % m or not kvh % m:
        return None
    hl, g = h // m, h // kvh
    if g % hl and hl % g:
        return None
    c = mesh.get_local_rank("model")
    return c * hl // g, ((c + 1) * hl - 1) // g + 1


def _on_kv_run(q, k, v, *, attend, run, **kw):
    """``attend`` on q and the kv heads [lo, hi) of ``run``, copied out
    contiguous: the flash wrapper launches on contiguous operands only."""
    lo, hi = run
    return attend(q, k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous(),
                  **kw)


def on_head_shards(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)``; on DTensors, on each rank's own block.

    The flash kernel takes plain tensors, and DTensor cannot flatten the
    batch and head dimensions of a decode step's products when both are
    split, so q, k and v go to one layout
    (batch over the DP axes, heads over "model" where both the query and
    the kv head counts divide it, the sequence whole: a causal block
    needs every key before it) and ``attend`` runs on the local blocks.
    Head h of a block still reads kv head h // (H // KV) of the same
    block, as in the whole tensors.  Where "model" divides the query heads
    but not the kv heads, the kv heads stay whole and each rank reads the
    run of them its query heads use (:func:`_kv_run`); their gradients
    come back as partial sums over "model".  Decode's attention over the
    cache and the chunked attention (:func:`_attend`) run here too."""
    if not isinstance(q, DTensor):
        return attend(q, k, v, **kw)
    mesh = q.device_mesh
    dp = dp_entry(mesh, q.shape[0])
    heads = _heads_entry(mesh, q.shape[2], k.shape[2])
    run = None if heads else _kv_run(mesh, q.shape[2], k.shape[2])
    if run is None:
        spec = P(dp, None, heads)
        return on_local_blocks(attend, (q, k, v), (spec,) * 3, spec, mesh,
                               **kw)
    q_spec, kv_spec = P(dp, None, "model"), P(dp)
    return on_local_blocks(_on_kv_run, (q, k, v), (q_spec, kv_spec, kv_spec),
                           q_spec, mesh, attend=attend, run=run, **kw)


def on_query_blocks(attend, q, k, v, **kw):
    """``attend(q, k, v, q_offset=, **kw)`` on each rank's own block of
    query rows, for queries whose sequence is split (context parallelism):
    q in its own layout, k and v with the same batch split and their
    sequence and heads whole, and ``q_offset`` the global position of the
    block's first row.  k's and v's gradients come back as partial sums
    over the axes that split the queries' sequence."""
    q_spec = spec_of(q)
    kv_spec = P(q_spec[0] if q_spec else None)
    return on_local_blocks(attend, (q, k, v), (q_spec, kv_spec, kv_spec),
                           q_spec, q.device_mesh,
                           q_offset=block_range(q, 1)[0], **kw)


def _attend(q, k, v, **kw):
    """``_sdpa_chunked(q, k, v, **kw)``; on DTensors, on each rank's own
    head block (:func:`on_head_shards`), or for queries whose sequence is
    split (context parallelism) on its own block of query rows
    (:func:`on_query_blocks`).  DTensor's view rules in some PyTorch
    versions refuse the einsum's flatten of a batch split over the DP axes
    with kv heads split over "model", or with a split sequence."""
    if seq_split(q):
        return on_query_blocks(_sdpa_chunked, q, k, v, **kw)
    # a block's gradients keep the einsums' strides, which DTensor's views
    # further back cannot take (the rope's input makes q's and k's
    # contiguous)
    v = contiguous_grad(v)
    return on_head_shards(_sdpa_chunked, q, k, v, **kw)


def apply_gqa(p: GQA, cfg, x, positions, window=None, flash=flash_gqa):
    """``flash`` is the attention of the flash path (the kernel's wrapper;
    a check may pass its plain version, ``flash_gqa_ref``)."""
    q, k, v = _qkv(p, cfg, x, positions)
    # optional context parallelism: queries over "model", K/V whole
    q = shard_act(q, "attn_q")
    if (cfg.use_flash_attention and window is None
            and cfg.attn_logit_softcap is None
            and x.shape[1] % 128 == 0):
        out = on_head_shards(flash, q, k, v, causal=True,
                             bq=min(512, x.shape[1]),
                             bk=min(512, x.shape[1]))
    else:
        out = _attend(q, k, v, causal=True, window=window,
                      softcap=cfg.attn_logit_softcap)
    out = shard_act(out, "attn_q")
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
    write_position(cache["k"], slot, k)
    write_position(cache["v"], slot, v)
    j = torch.arange(t_buf, device=x.device)[None, :]
    gpos = pos - torch.remainder(pos - j, t_buf)
    mask = gpos >= 0
    if window is not None:
        mask &= (pos - gpos) < window
    mask = mask[None, None, None]                       # [1,1,1,1,Tb]
    ck, cv = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    if seq_split(ck):
        out = _sdpa_split_cache(q, ck, cv, mask, cfg.attn_logit_softcap)
    else:
        out = on_head_shards(_sdpa, q, ck, cv, mask=mask,
                             softcap=cfg.attn_logit_softcap)
    return _out(p, out, x.dtype), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV, rope/nope split

class MLA(nn.Module):
    """``wq`` [d, H, qn + qr], ``wkv_down`` [d, r + qr], ``wk_up`` [r, H,
    qn], ``wv_up`` [r, H, vd], ``wo`` [H, vd, d] and ``kv_norm`` [r]."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        r, qr = cfg.kv_lora_rank, cfg.qk_rope_dim
        qn, vd = cfg.qk_nope_dim, cfg.v_head_dim
        dt = dtype_of(cfg.param_dtype)
        self.wq = dense((d, h, qn + qr), gen, dt, device,
                        axes=("embed", "heads", None))
        self.wkv_down = dense((d, r + qr), gen, dt, device,
                              axes=("embed", "lora"))
        self.wk_up = dense((r, h, qn), gen, dt, device,
                           axes=("lora", "heads", None))
        self.wv_up = dense((r, h, vd), gen, dt, device,
                           axes=("lora", "heads", None))
        self.wo = dense((h, vd, d), gen, dt, device, fan_in=h * vd,
                        axes=("heads", None, "embed"))
        self.kv_norm = const((r,), dt, device, axes=(None,))


def init_mla(cfg, gen, device) -> MLA:
    return MLA(cfg, gen, device)


def _mla_qc(p: MLA, cfg, x, positions):
    """The queries' nope and rope parts [B,S,H,qn], [B,S,H,qr], and the
    compressed KV [B,S,r] and shared rope key [B,S,qr] of ``x``."""
    r, qn = cfg.kv_lora_rank, cfg.qk_nope_dim
    q = _proj(x, p.wq)
    q_nope, q_rope = q[..., :qn], q[..., qn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    down = x @ p.wkv_down.to(x.dtype)                     # [B,S,r+qr]
    c_kv = rms_norm(down[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(down[..., None, r:], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p: MLA, cfg, q_nope, q_rope, c_kv, k_rope, mask):
    """Absorbed-weight MLA attention: scores in the compressed space, the
    softmax in f32 and its weights back in the activations' type; the
    heads' outputs [B,S,H,vd], before ``wo``.  ``p`` gives ``wk_up`` and
    ``wv_up``."""
    dt = q_nope.dtype
    # absorb wk_up into the query: q_c [B,S,H,r]
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p.wk_up.to(dt))
    scores = (torch.einsum("bshr,btr->bhst", q_c, c_kv)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope)).float()
    scores = scores / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bhst,btr->bshr", w, c_kv)          # compressed context
    return torch.einsum("bshr,rhv->bshv", ctx, p.wv_up.to(dt))


def _mla_causal(p, cfg, q_nope, q_rope, c_kv, k_rope, qchunk: int):
    """Causal ``_mla_attend`` over query blocks of ``qchunk`` rows (one
    block when S <= qchunk or S % qchunk)."""
    s = q_nope.shape[1]
    j_idx = torch.arange(s, device=q_nope.device)
    if s <= qchunk or s % qchunk != 0:
        mask = (j_idx[None, :] <= j_idx[:, None])[None, None]
        return _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, mask)
    outs = []
    for start in range(0, s, qchunk):
        i_idx = start + torch.arange(qchunk, device=q_nope.device)
        mask = (j_idx[None, :] <= i_idx[:, None])[None, None]
        blk = slice(start, start + qchunk)
        outs.append(_mla_attend(p, cfg, q_nope[:, blk], q_rope[:, blk], c_kv,
                                k_rope, mask))
    return torch.cat(outs, dim=1)


def apply_mla(p: MLA, cfg, x, positions, qchunk: int = QCHUNK):
    """Causal MLA over the whole sequence, over query blocks of ``qchunk``
    rows (one block when S <= qchunk or S % qchunk).

    On DTensors the attention core (scores, softmax, compressed context
    and the ``wv_up`` product) runs on each rank's own blocks: DTensor's
    search for its backward's strategies on a 3D mesh takes hours.  The
    queries and ``wk_up``/``wv_up`` go to heads over "model" where the
    head count divides it, the queries' batch over the DP axes, and the
    compressed KV and rope key, which have no head dimension, are whole
    on "model"; ``wo`` then contracts the heads on the DTensors."""
    q_nope, q_rope, c_kv, k_rope = _mla_qc(p, cfg, x, positions)
    if not isinstance(q_nope, DTensor):
        out = _mla_causal(p, cfg, q_nope, q_rope, c_kv, k_rope, qchunk)
        return _out(p, out, x.dtype)
    mesh = q_nope.device_mesh
    dp = dp_entry(mesh, q_nope.shape[0])
    heads = _heads_entry(mesh, q_nope.shape[2])
    q_spec, kv_spec, w_spec = P(dp, None, heads), P(dp), P(None, heads)

    def core(qn, qr, c, k, wk_up, wv_up):
        w = SimpleNamespace(wk_up=wk_up, wv_up=wv_up)
        return _mla_causal(w, cfg, qn, qr, c, k, qchunk)
    out = on_local_blocks(core, (q_nope, q_rope, c_kv, k_rope, p.wk_up,
                                 p.wv_up),
                          (q_spec, q_spec, kv_spec, kv_spec, w_spec, w_spec),
                          q_spec, mesh)
    return _out(p, out, x.dtype)


def init_mla_cache(cfg, batch, max_len, dtype, device="cuda"):
    """A linear cache of the compressed KV and the rope key."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def decode_mla(p: MLA, cfg, x, cache, pos: int):
    """x: [B,1,d]; pos: the current position (an int). Returns (out, cache),
    the cache's position ``pos`` written in place."""
    pos = int(pos)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qc(p, cfg, x, positions)
    write_position(cache["c_kv"], pos, c_kv)
    write_position(cache["k_rope"], pos, k_rope)
    t = cache["c_kv"].shape[1]
    mask = (torch.arange(t, device=x.device) <= pos)[None, None, None]
    y = _mla_attend(p, cfg, q_nope, q_rope, cache["c_kv"].to(x.dtype),
                    cache["k_rope"].to(x.dtype), mask)
    return _out(p, y, x.dtype), cache


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec)

def init_cross(cfg, gen, device) -> GQA:
    """``wq``, ``wk``, ``wv`` and ``wo`` of GQA's shapes, without qk-norm
    (cross-attention takes no rope either)."""
    return GQA(dataclasses.replace(cfg, qk_norm=False), gen, device)


def cross_kv(p: GQA, enc_out):
    """The keys and values [B, T, KV, hd] of the encoder's output."""
    return _proj(enc_out, p.wk), _proj(enc_out, p.wv)


def apply_cross(p: GQA, cfg, x, enc_kv):
    """Every query of ``x`` over every encoder position (no mask)."""
    k, v = enc_kv
    # no rope here to make q's and k's gradients contiguous (see _attend)
    out = _attend(contiguous_grad(_proj(x, p.wq)), contiguous_grad(k), v,
                  causal=False)
    return _out(p, out, x.dtype)


# ---------------------------------------------------------------------------
# Bidirectional self-attention (encoder)

def apply_bidir(p: GQA, cfg, x, positions):
    q, k, v = _qkv(p, cfg, x, positions)
    out = _attend(q, k, v, causal=False, softcap=cfg.attn_logit_softcap)
    return _out(p, out, x.dtype)
