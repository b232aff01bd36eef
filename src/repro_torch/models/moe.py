"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``).

Assignments are sorted by expert id and placed into a capacity-bounded
[E, C, d] buffer with gather and scatter (no [T, E, C] one-hot); an
expert's assignments past its capacity are dropped.  Shared experts
(DeepSeek) run densely on every token.

Two departures from the reference's form, with the same values:

- The reference scatters dropped assignments one row past its buffer
  (``mode="drop"``) and gathers them back as zeros (``mode="fill"``).  Here
  the buffer has one spare row that takes them, and the expert outputs get
  a zero row in its place, so no boolean mask is read on the host: the
  dispatch runs with no host synchronisation.
- The reference combines with a scatter-add (``.at[st].add``), which on a
  card is an atomic add in no fixed order.  Here each assignment's slot is
  put back in token order and each token sums its ``top_k`` contributions
  in one fixed order, so the output is bitwise equal run to run.

The reference groups tokens by data-parallel rank (``moe_group_count``); on
one device that is one group.  ``groups`` takes the count as an argument.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from .layers import apply_mlp, dense, dtype_of

GATED = ("silu", "gelu")


class MoE(nn.Module):
    """``router`` [d, E]; ``wi``, ``wg`` [E, d, f] and ``wo`` [E, f, d];
    with shared experts ``shared_wi``, ``shared_wg`` [d, f n_shared] and
    ``shared_wo`` [f n_shared, d].  The ``wg`` weights only for gated
    activations."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
        dt = dtype_of(cfg.param_dtype)
        gated = cfg.mlp_act in GATED
        self.router = dense((d, e), gen, dt, device)
        self.wi = dense((e, d, f), gen, dt, device, fan_in=d)
        if gated:
            self.wg = dense((e, d, f), gen, dt, device, fan_in=d)
        self.wo = dense((e, f, d), gen, dt, device, fan_in=f)
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            self.shared_wi = dense((d, fs), gen, dt, device)
            if gated:
                self.shared_wg = dense((d, fs), gen, dt, device)
            self.shared_wo = dense((fs, d), gen, dt, device, fan_in=fs)


def init_moe(cfg, gen, device) -> MoE:
    return MoE(cfg, gen, device)


def _expert_ffn(p: MoE, h: torch.Tensor, act: str) -> torch.Tensor:
    """h: [E, C, d] -> [E, C, d], one batched product per weight."""
    dt = h.dtype
    up = torch.bmm(h, p.wi.to(dt))
    if act in GATED:
        gate = torch.bmm(h, p.wg.to(dt))
        up = (F.silu(gate) if act == "silu"
              else F.gelu(gate, approximate="tanh")) * up
    else:
        r = F.relu(up)
        up = r * r
    return torch.bmm(up, p.wo.to(dt))


def capacity(tokens_per_group: int, k: int, e: int,
             capacity_factor: float) -> int:
    """Slots an expert holds in a group: the reference's Python ``round``
    (to even), at least 1, padded up to a multiple of 8."""
    cap = int(max(1, round(tokens_per_group * k * capacity_factor / e)))
    return (cap + 7) // 8 * 8


def route(p: MoE, cfg, xt: torch.Tensor):
    """The router on tokens ``xt`` [T, d]: top-k gates renormalised to sum
    to 1 (f32) and expert ids, each [T, k].  The logits are f32 products."""
    logits = xt.float() @ p.router.float()
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k, dim=-1)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx


def _dispatch(xt, idx, groups: int, e: int, cap: int):
    """Sort the assignments of each group by expert, stably, and place the
    first ``cap`` of each (group, expert) into a [G E cap + 1, d] buffer;
    the last row takes the dropped ones.  Returns (buffer, slot, keep), the
    slot and keep flag of every assignment in token order (t-major)."""
    t, d = xt.shape
    k = idx.shape[-1]
    a = t * k
    dev = xt.device
    # one sort over (group, expert) keys, group-major, orders each group's
    # assignments as the reference's per-group stable sort does
    group_of = torch.arange(a, device=dev) // (a // groups)
    key = group_of * e + idx.reshape(a)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    start = torch.searchsorted(skey, torch.arange(groups * e, device=dev,
                                                  dtype=skey.dtype))
    pos = torch.arange(a, device=dev) - start[skey]
    keep_s = pos < cap
    spare = groups * e * cap
    slot_s = torch.where(keep_s, skey * cap + pos, spare)
    buf = xt.new_zeros((spare + 1, d))
    buf.index_copy_(0, slot_s, xt[order // k])
    # back to token order: ``order`` is a permutation, so each index once
    slot = torch.empty_like(slot_s).index_copy_(0, order, slot_s)
    keep = torch.empty_like(keep_s).index_copy_(0, order, keep_s)
    return buf, slot, keep


def _combine(hidden, slot, keep, gates):
    """Inverse of :func:`_dispatch`: expert outputs [G E cap, d] -> [T, d],
    each token's ``k`` gated contributions summed in top-k order (a dropped
    one reads the zero row after the last slot)."""
    t, k = gates.shape
    flat = F.pad(hidden, (0, 0, 0, 1))
    w = (gates.reshape(t * k) * keep).to(hidden.dtype)
    return (flat[slot] * w[:, None]).reshape(t, k, -1).sum(1)


def apply_moe(p: MoE, cfg, x: torch.Tensor,
              capacity_factor: float | None = None,
              groups: int = 1) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  ``groups`` splits the tokens into that
    many dispatch groups, each with its own sort and capacity (the
    reference's ``moe_group_count``; 1 on one device, and when it does not
    divide the tokens)."""
    bsz, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = bsz * s
    xt = x.reshape(t, d)
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity
    if t % groups:
        groups = 1
    gates, idx = route(p, cfg, xt)
    cap = capacity(t // groups, k, e, capacity_factor)

    buf, slot, keep = _dispatch(xt, idx, groups, e, cap)
    # [G E cap, d] -> [E, G cap, d] for the batched products, and back
    hidden_in = buf[:-1].reshape(groups, e, cap, d).transpose(0, 1)
    hidden = _expert_ffn(p, hidden_in.reshape(e, groups * cap, d),
                         cfg.mlp_act)
    hidden = hidden.reshape(e, groups, cap, d).transpose(0, 1)
    out = _combine(hidden.reshape(groups * e * cap, d), slot, keep, gates)

    if cfg.n_shared_experts:
        shared = SimpleNamespace(wi=p.shared_wi, wo=p.shared_wo,
                                 wg=getattr(p, "shared_wg", None))
        out = out + apply_mlp(shared, xt, cfg.mlp_act)
    return out.reshape(bsz, s, d)
