"""Mamba-2 block via the SSD (state-space duality) chunked algorithm (port
of ``repro.models.ssm``).

Prefill path: chunked SSD, an intra-chunk quadratic attention-like term plus
an inter-chunk recurrence over chunk states (a Python loop over the chunks
where the reference runs ``lax.scan``).  Decode path: an O(1) recurrent
state update per token, the cache written in place.

Single B/C group (mamba2's default), a causal depthwise conv over the xBC
stream, gated RMSNorm before the output projection.  As in the reference,
B, C, x and dt are f32 inside the scan; the projections and the conv run in
the activations' type.

The reference's four-operand einsums are written here as products of two
operands each, ordered so that no intermediate is larger than the
[B, C, H, Q, Q] decay matrix (at jamba's widths, 256 heads, one
2048-token row holds 0.54 GB of it in f32).  With no graph to record it is
built in place; under autograd its product with C.B is taken out of place
(exp's backward reads exp's output), so two are alive at once there.  The decay
quantities use a [B, C, H, Q] layout (the reference's [B, H, C, Q] with C
and H swapped), so the chunked products batch over (B, C, H) without a copy
of the decay matrix.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import batch_placements, on_batch_shards

from .layers import const, dense, dtype_of, rms_norm


class SSM(nn.Module):
    """``in_proj`` [d, 2 d_in + 2 N + H] (it emits [z | x | B | C | dt]),
    ``conv_w`` [K, d_in + 2 N], ``conv_b``, ``a_log`` (zeros), ``d_skip``
    (ones), ``dt_bias`` [H], ``out_norm`` [d_in] and ``out_proj`` [d_in,
    d]."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        nh = d_in // cfg.ssm_head_dim
        ck = cfg.ssm_conv_kernel
        dt = dtype_of(cfg.param_dtype)
        self.in_proj = dense((d, 2 * d_in + 2 * n + nh), gen, dt, device,
                             axes=("embed", "inner"))
        self.conv_w = dense((ck, d_in + 2 * n), gen, dt, device, fan_in=ck,
                            axes=(None, "inner"))
        self.conv_b = const((d_in + 2 * n,), dt, device, axes=("inner",))
        self.a_log = const((nh,), dt, device, value=0.0, axes=(None,))
        self.d_skip = const((nh,), dt, device, value=1.0, axes=(None,))
        self.dt_bias = const((nh,), dt, device, axes=(None,))
        self.out_norm = const((d_in,), dt, device, axes=("inner",))
        self.out_proj = dense((d_in, d), gen, dt, device, fan_in=d_in,
                              axes=("inner", "embed"))


def init_ssm(cfg, gen, device) -> SSM:
    return SSM(cfg, gen, device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``); ``F.softplus`` returns x itself above its threshold of 20."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg, proj):
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    z = proj[..., :d_in]
    xbc = proj[..., d_in:2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    return z, xbc, dt, d_in, n, nh


def _causal_conv(xbc, w, b):
    """xbc: [B, S, ch]; w: [K, ch] depthwise; left-padded causal."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def _segsum(x):
    """x: [..., q] -> [..., q, q] lower-tri pairwise cumulative sums, -inf
    above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return d.masked_fill_(upper, float("-inf"))


def _intra_chunk(ac, bc, cc, xc):
    """The diagonal term: y[q] = sum_{s<=q} C_q.B_s exp(A_q - A_s) x_s in
    each chunk.  ac [B,C,H,Q]; bc, cc [B,C,Q,N]; xc [B,C,H,Q,P]."""
    l = _segsum(ac).exp_()                                  # [B,C,H,Q,Q]
    cb = (cc @ bc.transpose(-1, -2)).unsqueeze(2)           # C_q . B_s
    if l.requires_grad or cb.requires_grad:
        l = l * cb      # exp's backward reads exp's output: out of place
    else:
        l.mul_(cb)      # no graph: one decay matrix, built in place
    return l @ xc                                           # [B,C,H,Q,P]


def _chunk_states(acum, bc, xc):
    """Each chunk's final state: sum_q exp(A_last - A_q) x_q B_q^T,
    [B,C,H,P,N]."""
    bsz, c, h, q, p = xc.shape
    decay = torch.exp(acum[..., -1:] - acum)                # [B,C,H,Q]
    xw = (xc * decay[..., None]).permute(0, 1, 2, 4, 3)     # [B,C,H,P,Q]
    return (xw.reshape(bsz, c, h * p, q) @ bc).view(bsz, c, h, p, -1)


def _inter_chunk(acum, cc, prev):
    """The off-diagonal term: C_q . (the state before the chunk) decayed to
    q.  prev [B,C,H,P,N] -> [B,C,Q,H,P]."""
    bsz, c, h, p, n = prev.shape
    st = prev.permute(0, 1, 4, 2, 3).reshape(bsz, c, n, h * p)
    return (cc @ st).view(bsz, c, -1, h, p) \
        * torch.exp(acum).transpose(2, 3)[..., None]


def ssd_chunked(xh, dt, a, bmat, cmat, chunk: int):
    """Minimal SSD.

    xh:   [B, S, H, P]  head inputs
    dt:   [B, S, H]     positive step sizes
    a:    [H]           negative state decay rates
    bmat: [B, S, N], cmat: [B, S, N]  (single group)
    returns y: [B, S, H, P]
    """
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a multiple "
                         f"of the chunk {chunk}")
    c, q = s // chunk, chunk

    xd = xh * dt[..., None]                                 # fold dt into x
    abar = dt * a[None, None, :]                            # [B,S,H]
    xc = xd.reshape(bsz, c, q, h, p).transpose(2, 3)        # [B,C,H,Q,P]
    ac = abar.reshape(bsz, c, q, h).transpose(2, 3)         # [B,C,H,Q]
    bc = bmat.reshape(bsz, c, q, n)
    cc = cmat.reshape(bsz, c, q, n)
    acum = torch.cumsum(ac, dim=-1)

    y = _intra_chunk(ac, bc, cc, xc)                        # 1) diagonal
    states = _chunk_states(acum, bc, xc)                    # 2) chunk states
    chunk_decay = torch.exp(acum[..., -1])                  # [B,C,H]
    prev = torch.empty_like(states)                         # 3) recurrence
    carry = torch.zeros_like(states[:, 0])
    for i in range(c):                      # each state *before* its chunk
        prev[:, i] = carry
        carry = states[:, i] + chunk_decay[:, i, :, None, None] * carry
    y = y + _inter_chunk(acum, cc, prev).transpose(2, 3)    # 4) off-diagonal
    return y.transpose(2, 3).reshape(bsz, s, h, p)


def apply_ssm(p: SSM, cfg, x):
    if isinstance(x, DTensor):
        return on_batch_shards(lambda q, xl: apply_ssm(q, cfg, xl), p, x)
    return _apply_ssm(p, cfg, x)


def _apply_ssm(p: SSM, cfg, x):
    """Prefill path. x: [B, S, d] -> [B, S, d]; S a multiple of
    ``cfg.ssm_chunk``."""
    dtp = x.dtype
    proj = x @ p.in_proj.to(dtp)
    z, xbc, dt_raw, d_in, n, nh = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, p.conv_w.to(dtp), p.conv_b.to(dtp))
    xs = xbc[..., :d_in]
    bmat = xbc[..., d_in:d_in + n].float()
    cmat = xbc[..., d_in + n:].float()
    xh = xs.reshape(*xs.shape[:2], nh, cfg.ssm_head_dim).float()
    dt = softplus(dt_raw.float() + p.dt_bias.float())
    a = -torch.exp(p.a_log.float())
    y = ssd_chunked(xh, dt, a, bmat, cmat, cfg.ssm_chunk)
    y = y + p.d_skip.float()[None, None, :, None] * xh
    y = y.reshape(*xs.shape[:2], d_in).to(dtp)
    y = y * F.silu(z)
    y = rms_norm(y, p.out_norm, cfg.norm_eps)
    return y @ p.out_proj.to(dtp)


# ---------------------------------------------------------------------------
# Decode (recurrent) path

def init_ssm_cache(cfg, batch, dtype, device="cuda"):
    """The conv window's last K - 1 inputs (activation type) and the state
    [B, H, P, N] in f32."""
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    return {"conv": torch.zeros((batch, cfg.ssm_conv_kernel - 1, d_in + 2 * n),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, nh, cfg.ssm_head_dim, n),
                                 dtype=torch.float32, device=device)}


def decode_ssm(p: SSM, cfg, x, cache):
    """x: [B, 1, d]. O(1) recurrent update; returns (out, cache), the
    cache's window shifted and its state replaced in place (the reference
    returns a new cache).  On DTensors each rank steps its own batch block
    with the weights gathered (``on_batch_shards``), its cache blocks
    gathered over the other axes and written back."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = batch_placements(mesh, x.shape[0])
        whole = {k: c.redistribute(mesh, pl) for k, c in cache.items()}
        local = {k: c.to_local() for k, c in whole.items()}
        out = on_batch_shards(
            lambda q, xl: _decode_ssm(q, cfg, xl, local)[0], p, x)
        for k, c in cache.items():
            new = DTensor.from_local(local[k], mesh, pl, run_check=False)
            c.to_local().copy_(new.redistribute(mesh, c.placements)
                               .to_local())
        return out, cache
    return _decode_ssm(p, cfg, x, cache)


def _decode_ssm(p: SSM, cfg, x, cache):
    dtp = x.dtype
    proj = x[:, 0] @ p.in_proj.to(dtp)                      # [B, ...]
    z, xbc, dt_raw, d_in, n, nh = _split_proj(cfg, proj)
    # conv over the cached window
    win = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # [B,K,ch]
    w = p.conv_w.to(dtp)
    conv = F.silu((win * w[None]).sum(1) + p.conv_b.to(dtp))
    xs = conv[..., :d_in]
    bvec = conv[..., d_in:d_in + n].float()
    cvec = conv[..., d_in + n:].float()
    xh = xs.reshape(-1, nh, cfg.ssm_head_dim).float()
    dt = softplus(dt_raw.float() + p.dt_bias.float())
    a = -torch.exp(p.a_log.float())
    decay = torch.exp(dt * a[None, :])                      # [B,H]
    # state: [B,H,P,N]
    upd = (dt[..., None] * xh)[..., None] * bvec[:, None, None, :]
    state = cache["state"] * decay[..., None, None] + upd
    y = (state @ cvec[:, None, :, None])[..., 0]            # [B,H,P]
    y = y + p.d_skip.float()[None, :, None] * xh
    y = y.reshape(-1, d_in).to(dtp)
    y = y * F.silu(z)
    y = rms_norm(y, p.out_norm, cfg.norm_eps)
    out = (y @ p.out_proj.to(dtp))[:, None, :]
    cache["conv"].copy_(win[:, 1:])
    cache["state"].copy_(state)
    return out, cache
