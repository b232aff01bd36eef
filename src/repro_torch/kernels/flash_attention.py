"""Flash attention (port of repro.kernels.flash_attention).

The prefill path of the dense LMs: ``models.attention.apply_gqa`` calls
:func:`flash_gqa` when ``cfg.use_flash_attention`` is set, the layer has no
window and no logit softcap, and S % 128 == 0.  On CUDA tensors both
wrappers launch ``csrc/flash_attention.cu`` (online softmax over KV tiles in
f32, GQA by index: query head h reads KV head h // (H / KV)), which reads
the model's [B, S, H, hd] layout as it is; on CPU tensors they run the plain
version, :func:`repro_torch.kernels.ref.flash_attention_ref`.  ``bq`` and
``bk`` are checked as the reference checks them and do not change the
result: the kernel picks its own tiles.
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


def _check_blocks(s: int, t: int, bq: int, bk: int) -> None:
    bq, bk = min(bq, s), min(bk, t)
    if s % bq or t % bk:
        raise ValueError(f"flash attention: S={s} and T={t} must be multiples "
                         f"of bq={bq} and bk={bk} (pad upstream)")


def _launch(q, k, v, *, bh: int, s: int, t: int, nh: int, nkv: int,
            group: int, causal: bool) -> torch.Tensor:
    global launches
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: no kernel for head_dim {hd} "
                         f"(takes {HEAD_DIMS})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention: no kernel for q {q.dtype}, "
                        f"k {k.dtype}, v {v.dtype}")
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, t, nh, nkv, group, hd, int(causal),
                 _build.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
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
                  causal: bool = True, bq: int = 512,
                  bk: int = 512) -> torch.Tensor:
    """The plain version of :func:`flash_gqa` on any device, with its
    checks: q [B, S, H, hd], k/v [B, T, KV, hd] -> [B, S, H, hd]."""
    _check_gqa(q, k, v, bq, bk)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, hd)
    kf = k.transpose(1, 2).reshape(b * kv, t, hd)
    vf = v.transpose(1, 2).reshape(b * kv, t, hd)
    out = flash_attention_ref(qf, kf, vf, causal=causal)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, bq: int = 512,
              bk: int = 512) -> torch.Tensor:
    """Model-layout attention: q [B, S, H, hd]; k/v [B, T, KV, hd] ->
    [B, S, H, hd].  Heads are grouped kv-major (head h uses kv head
    h // (H // KV)), matching ``repro_torch.models.attention._sdpa``."""
    if not _build.on_cuda("flash_gqa", q, k, v):
        return flash_gqa_ref(q, k, v, causal=causal, bq=bq, bk=bk)
    _check_gqa(q, k, v, bq, bk)
    b, s, h, _ = q.shape
    t, kv = k.shape[1], k.shape[2]
    return _launch(q, k, v, bh=b * h, s=s, t=t, nh=h, nkv=kv, group=h // kv,
                   causal=causal)
