"""Flash attention (port of repro.kernels.flash_attention).

The prefill path of the dense LMs: ``models.attention.apply_gqa`` calls
:func:`flash_gqa` when ``cfg.use_flash_attention`` is set, the layer has no
window and no logit softcap, and S % 128 == 0.  On CUDA tensors both
wrappers launch a kernel (online softmax over KV tiles in f32, GQA by
index: query head h reads KV head h // (H / KV)), which reads the model's
[B, S, H, hd] layout as it is; on CPU tensors they run the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`.  ``bq`` and
``bk`` are checked as the reference checks them and do not change the
result: the kernel picks its own tiles.  Neither kernel has a backward (nor
has the reference's), so under grad, with an input that requires grad,
both wrappers raise ``NotImplementedError`` on every device: training
takes the chunked attention.

Two kernels, chosen by dtype (:func:`variant`): bf16 inputs
go to ``csrc/flash_wgmma.cu`` on the tensor cores (TMA-fed K/V tiles, Q K^T
on wgmma, P split into bf16 hi + lo for two wgmmas of P V, so P keeps about
16 bits); f32 inputs stay on ``csrc/flash_attention.cu``'s FFMA, since f32
on the tensor cores would be TF32.  ``launches`` counts both;
``variant_launches`` counts each.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                      ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128, 192, 256)

launches = 0    # kernel launches since the last ops.reset_counts()
#: launches of each kernel since the last ops.reset_counts()
variant_launches = {"tensor_core": 0, "ffma": 0}
_TC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                          ctypes.c_void_p]
# The tensor-core kernel's geometry (csrc/flash_wgmma.cu refuses any
# other): a block of TC_BQ query rows, two warpgroups of 64; KV tiles of
# TC_BK[hd] keys (128 up to hd 128; 64 above, where the output accumulator
# takes the registers) through a ring of TC_STAGES[hd] stages of K and V.
TC_BQ = 128
TC_WG_ROWS = 64
TC_BK = {64: 128, 128: 128, 192: 64, 256: 64}
TC_STAGES = {64: 4, 128: 3, 192: 3, 256: 2}


def tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of a block: 1024 bytes of alignment slack, Q
    (TC_BQ rows), the stages of K and V (TC_BK[hd] rows each), the
    barriers."""
    st = TC_STAGES[hd]
    return (1024 + 2 * hd * (TC_BQ + 2 * TC_BK[hd] * st)
            + 8 * (2 * st + 1))


def tc_row_blocks(s: int) -> int:
    """Blocks of query rows a (batch x query head) takes: the launch's
    grid is (B x H, tc_row_blocks(S))."""
    return -(-s // TC_BQ)


def tc_block_q0(y: int, s: int) -> int:
    """First query row of grid row ``y``: the last block first, so the
    longest causal rows start first."""
    return (tc_row_blocks(s) - 1 - y) * TC_BQ


def tc_kv_tiles(q0: int, rows: int, t: int, causal: bool, hd: int) -> int:
    """KV tiles that query rows q0 .. q0 + rows - 1 read: all ceil(T /
    TC_BK[hd]), or under the causal mask those up to the last row's
    diagonal.  A block reads ``tc_kv_tiles(q0, TC_BQ, ...)`` (rows past S
    included), its lower warpgroup ``tc_kv_tiles(q0, TC_WG_ROWS, ...)``."""
    bk = TC_BK[hd]
    n = -(-t // bk)
    if causal:
        n = min(n, (q0 + rows - 1) // bk + 1)
    return n


def _refuse_grad(name: str, *tensors) -> None:
    """The kernels have no backward, as the reference's ``_flash_kernel``
    has none (no ``custom_vjp``; ``jax.grad`` through it fails): under
    grad, with an input that requires grad, both wrappers raise on every
    device rather than cut the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: no backward; the reference's _flash_kernel has none "
            f"either. Train with use_flash_attention off (the chunked "
            f"attention), or call under torch.no_grad()")


def _check_blocks(s: int, t: int, bq: int, bk: int) -> None:
    bq, bk = min(bq, s), min(bk, t)
    if s % bq or t % bk:
        raise ValueError(f"flash attention: S={s} and T={t} must be multiples "
                         f"of bq={bq} and bk={bk} (pad upstream)")


def variant(dtype: torch.dtype) -> str:
    """The kernel a launch takes: ``"tensor_core"`` for bf16 (every head
    dim of HEAD_DIMS), ``"ffma"`` for f32."""
    return "tensor_core" if dtype == torch.bfloat16 else "ffma"


def _launch(q, k, v, *, bh: int, s: int, t: int, nh: int, nkv: int,
            group: int, causal: bool, kernel: str | None = None
            ) -> torch.Tensor:
    global launches
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: no kernel for head_dim {hd} "
                         f"(takes {HEAD_DIMS})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention: no kernel for q {q.dtype}, "
                        f"k {k.dtype}, v {v.dtype}")
    out = torch.empty_like(q)
    kind = variant(q.dtype) if kernel is None else kernel
    if kind not in variant_launches or (
            kind == "tensor_core" and variant(q.dtype) != kind):
        raise ValueError(f"flash attention: no {kind!r} kernel for "
                         f"{q.dtype} at head_dim {hd}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if kind == "tensor_core":
            fn = _build.function("flash_wgmma", "flash_wgmma", _TC_ARGS)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), bh, s, t, nh, nkv, group, hd,
                     int(causal), TC_BQ, TC_BK[hd], TC_STAGES[hd],
                     1.0 / math.sqrt(hd), stream)
        else:
            fn = _build.function("flash_attention", "flash_attention", _ARGS)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), bh, s, t, nh, nkv, group, hd,
                     int(causal), _build.DTYPE_CODES[q.dtype],
                     1.0 / math.sqrt(hd), stream)
    _build.check(err, f"flash_attention ({kind})")
    with _build.COUNT_LOCK:
        launches += 1
        variant_launches[kind] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """q: [BH, S, hd]; k/v: [BKV, T, hd] with BH = BKV * group.

    Returns [BH, S, hd] in q's type.  S % bq == 0 and T % bk == 0."""
    bh, s, hd = q.shape
    bkv, t, _ = k.shape
    if bh % bkv or tuple(v.shape) != tuple(k.shape) or k.shape[2] != hd:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    _check_blocks(s, t, bq, bk)
    _refuse_grad("flash_attention", q, k, v)
    if not _build.on_cuda("flash_attention", q, k, v):
        return flash_attention_ref(q, k, v, causal=causal)
    return _launch(q, k, v, bh=bh, s=s, t=t, nh=1, nkv=1, group=bh // bkv,
                   causal=causal)


def _check_gqa(q, k, v, bq: int, bk: int) -> None:
    b, s, h, hd = q.shape
    if (h % k.shape[2] or tuple(v.shape) != tuple(k.shape)
            or k.shape[0] != b or k.shape[3] != hd):
        raise ValueError(f"flash_gqa: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    _check_blocks(s, k.shape[1], bq, bk)


def flash_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, bq: int = 512, bk: int = 512,
                  p_mode: str = "f32") -> torch.Tensor:
    """The plain version of :func:`flash_gqa` on any device, with its
    checks: q [B, S, H, hd], k/v [B, T, KV, hd] -> [B, S, H, hd].
    ``p_mode`` as in :func:`repro_torch.kernels.ref.flash_attention_ref`."""
    _check_gqa(q, k, v, bq, bk)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, hd)
    kf = k.transpose(1, 2).reshape(b * kv, t, hd)
    vf = v.transpose(1, 2).reshape(b * kv, t, hd)
    out = flash_attention_ref(qf, kf, vf, causal=causal, p_mode=p_mode)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, bq: int = 512, bk: int = 512,
              kernel: str | None = None) -> torch.Tensor:
    """Model-layout attention: q [B, S, H, hd]; k/v [B, T, KV, hd] ->
    [B, S, H, hd].  Heads are grouped kv-major (head h uses kv head
    h // (H // KV)), matching ``repro_torch.models.attention._sdpa``.
    ``kernel`` None takes :func:`variant`'s choice; ``"ffma"`` runs the FFMA
    kernel on bf16 too (to time it beside the tensor-core one).  Under
    grad it raises, as :func:`flash_attention` does."""
    _refuse_grad("flash_gqa", q, k, v)
    if not _build.on_cuda("flash_gqa", q, k, v):
        return flash_gqa_ref(q, k, v, causal=causal, bq=bq, bk=bk)
    _check_gqa(q, k, v, bq, bk)
    b, s, h, _ = q.shape
    t, kv = k.shape[1], k.shape[2]
    return _launch(q, k, v, bh=b * h, s=s, t=t, nh=h, nkv=kv, group=h // kv,
                   causal=causal, kernel=kernel)
