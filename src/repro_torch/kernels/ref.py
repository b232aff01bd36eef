"""Plain PyTorch versions of the four tile kernels (twins of repro.kernels.ref),
the class round that the executor and the fused kernel's epilogue share, and
straightforward f32 attention, the plain version of the flash kernel.

Each function computes what its CUDA kernel computes: f32 arithmetic on
f32, bf16 or fp8 operands (widened first; PyTorch has no fp8 matmul on
the CPU), with the result in the output operand's type.  An f64 input
stays in f64, which is how :mod:`repro_torch.kernels.ops` uses them as the
stock path for f64 tiles.  The CPU tests hold these against the JAX
package, and the smoke script holds each kernel against its twin on the
card.
"""
from __future__ import annotations

import math

import torch


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


_CLASS_DTYPES = {
    "f64": torch.float64,
    "f32": torch.float32,
    "f16": torch.float16,
    "bf16": torch.bfloat16,
    "f8e4m3": torch.float8_e4m3fn,
    # the scaled FP8 class stores the same e4m3 payload; the per-tile
    # power-of-two scale applied around the cast is what differs
    "f8e4m3s": torch.float8_e4m3fn,
}

# e4m3 rounds |x| <= 464 to at most 448 (464 is the tie with the missing
# 480, which rounds to even); past that the reference's cast gives NaN,
# where PyTorch's saturates to 448.
_FP8_NAN_ABOVE = 464.0


def _f32_round_to_odd(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounding to odd: a later f32 -> f16 round then equals
    the one-step f64 -> f16 round (f32 keeps more than two extra bits).
    PyTorch's own f64 -> f16 cast goes through a round-to-nearest f32 and
    can round twice."""
    y = x.to(torch.float32)
    yd = y.to(torch.float64)
    # truncate toward zero, then set the last bit where the round was inexact
    t = torch.where(yd.abs() > x.abs(),
                    torch.nextafter(y, torch.zeros_like(y)), y)
    bits = t.view(torch.int32)
    inexact = (t.to(torch.float64) != x) & torch.isfinite(y)
    return torch.where(inexact, bits | 1, bits).view(torch.float32)


def _fp8_scale(amax: torch.Tensor) -> torch.Tensor:
    """Store-time power-of-two scale of a scaled-FP8 tile (twin of
    ``_jx_fp8_scale``; frexp keeps every backend bitwise-identical)."""
    m, e = torch.frexp(amax)
    exp = (8 - e) + (m <= 0.875).to(e.dtype)
    s = torch.ldexp(torch.ones_like(amax), exp)
    ok = torch.isfinite(amax) & (amax > 0)
    return torch.where(ok, s, torch.ones_like(s))


def _round(x: torch.Tensor, cls_name: str) -> torch.Tensor:
    """Round a tile through its precision class, back in x's dtype.

    Twin of the reference's ``_np_round``/``_jx_round``, bitwise: the f16
    class rounds f64 in one step, and the unscaled FP8 class gives NaN
    past the top of e4m3's band.  Returns ``x`` itself when the class
    does not narrow x's dtype."""
    cdt = _CLASS_DTYPES[cls_name]
    if cls_name == "f64" or cdt == x.dtype:
        return x
    if cls_name == "f16" and x.dtype == torch.float64:
        return _f32_round_to_odd(x).to(cdt).to(x.dtype)
    if cdt == torch.float8_e4m3fn:
        # the scaled class puts a finite tile's amax in (224, 448]; the
        # mask matters there only for a tile holding inf or NaN
        s = _fp8_scale(x.abs().amax()) if cls_name == "f8e4m3s" else None
        y = (x if s is None else x * s).to(torch.float32)
        q = y.to(cdt).to(x.dtype)
        q = torch.where(y.abs() > _FP8_NAN_ABOVE,
                        torch.full_like(q, float("nan")), q)
        return q if s is None else q / s
    return x.to(cdt).to(x.dtype)


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the matrix is not positive
    definite, as jnp.linalg.cholesky returns (no error, no host sync)."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info > 0, torch.full_like(l, float("nan")), l)


def potrf_ref(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrised tile, in a's type."""
    x = _wide(a)
    return cholesky_nan(0.5 * (x + x.T)).to(a.dtype)


def trsm_ref(l: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """X with X @ L^T = C, in C's type."""
    x = torch.linalg.solve_triangular(_wide(l).T, _wide(c), upper=True,
                                      left=False)
    return x.to(c.dtype)


def syrk_update_ref(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """C - A @ A^T on the lower triangle, mirrored into the upper one."""
    aw = _wide(a)
    r = (_wide(c) - aw @ aw.T).to(c.dtype)
    return torch.tril(r) + torch.tril(r, -1).T


def gemm_update_ref(c: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """C - A @ B^T with a wide accumulator, in C's type."""
    return (_wide(c) - _wide(a) @ _wide(b).T).to(c.dtype)


#: the flash kernel's finite mask value (repro.kernels.flash_attention)
NEG_INF = -1e30


def split_bf16(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core flash kernel's split of f32 ``p`` into bf16 halves:
    hi = bf16(p), lo = bf16(p - hi) (p - hi is exact in f32), so hi + lo
    is p within 2^-17 of |p|."""
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    return hi, lo


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        p_mode: str = "f32") -> torch.Tensor:
    """softmax((q k^T) / sqrt(hd)) v in f32, in q's type.

    q: [BH, S, hd]; k/v: [BKV, T, hd]; query row bh reads KV row bh // g
    (g = BH / BKV).  The causal mask keeps kj <= qi from position 0 and
    writes -1e30 elsewhere; the output is (p v) / max(l, 1e-30), with the
    flash kernel's constants.

    ``p_mode`` is how p enters p v: ``"f32"`` (the function), ``"split"``
    (hi + lo of :func:`split_bf16`, a plain model of the tensor-core
    kernel) or ``"bf16"`` (p rounded to bf16, a control that is not the
    function); l sums p in f32 in every mode."""
    bh, s, hd = q.shape
    g = bh // k.shape[0]
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    sc = torch.matmul(q.float(), kf.transpose(1, 2)).mul_(1.0 / math.sqrt(hd))
    if causal:
        t = k.shape[1]
        above = (torch.arange(t, device=q.device)[None, :]
                 > torch.arange(s, device=q.device)[:, None])
        sc.masked_fill_(above, NEG_INF)
    p = sc.sub_(sc.amax(dim=-1, keepdim=True)).exp_()
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if p_mode == "f32":
        pv = torch.matmul(p, vf)
    elif p_mode == "split":
        hi, lo = split_bf16(p)
        pv = torch.matmul(hi.float(), vf) + torch.matmul(lo.float(), vf)
    elif p_mode == "bf16":
        pv = torch.matmul(p.to(torch.bfloat16).float(), vf)
    else:
        raise ValueError(f"flash_attention_ref: p_mode {p_mode!r}")
    return (pv / l).to(q.dtype)
