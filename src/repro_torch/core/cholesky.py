"""Single-device executor of the static op stream, in PyTorch.

Port of the reference's ``make_jax_executor`` (``repro/core/cholesky.py``)
with its class round (``_jx_round``/``_jx_fp8_scale``), kernel table
(``_make_kernel_fns``) and op interpreter (``_jx_interpret_op``).  Where the
reference unrolls the op stream into one jit, PyTorch runs it eagerly, op
by op, on one stream:

* the host tile store is a ``[nt, nt, tb, tb]`` CPU tensor in the compute
  dtype, pinned when the slots live on a CUDA device;
* the slot buffer ``[nslots, tb, tb]`` lives on the device;
* LOAD is a non-blocking host-to-device copy into the slot followed by the
  class round on the device; STORE rounds on the device, writes the rounded
  tile back into the slot and copies it to the host, non-blocking.  One
  stream orders a later LOAD of a tile after its earlier STORE.

Transfers carry compute-dtype bytes, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from .precision import (PrecisionPlan, assign_precision, tile_amax,
                        tile_norms, uniform_plan)
from .schedule import HOST_IO, Op, OpKind, Schedule

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


def _make_kernel_fns(use_pallas: bool) -> dict:
    """Stock PyTorch ops in the compute dtype, or (``use_pallas``, the
    reference's name for it) the hand-written tile kernels via ops."""
    if not use_pallas:
        return kops.STOCK
    return {"potrf": kops.potrf, "trsm": kops.trsm,
            "syrk": kops.syrk_update, "gemm": kops.gemm_update}


def _device_nslots(ops) -> int:
    return max((max(o.slot_c, o.slot_a, o.slot_b)
                for o in ops if o.kind not in HOST_IO), default=-1) + 1


def _interpret_op(host: torch.Tensor, slots: torch.Tensor, op: Op, lad,
                  kf: dict, io: dict) -> None:
    """Run one op against the host store and the slot buffer, in place."""
    kind = op.kind
    if kind is OpKind.LOAD:
        s = slots[op.slot_c]
        s.copy_(host[op.i, op.j], non_blocking=True)
        r = _round(s, lad[op.cls])
        if r is not s:
            s.copy_(r)
        io["h2d_ops"] += 1
        io["h2d_bytes"] += s.numel() * s.element_size()
    elif kind is OpKind.STORE:
        s = slots[op.slot_c]
        r = _round(s, lad[op.cls])
        if r is not s:
            s.copy_(r)
        host[op.i, op.j].copy_(s, non_blocking=True)
        io["d2h_ops"] += 1
        io["d2h_bytes"] += s.numel() * s.element_size()
    elif kind is OpKind.SYRK:
        slots[op.slot_c] = kf["syrk"](slots[op.slot_c], slots[op.slot_a])
    elif kind is OpKind.GEMM:
        slots[op.slot_c] = kf["gemm"](slots[op.slot_c], slots[op.slot_a],
                                      slots[op.slot_b])
    elif kind is OpKind.POTRF:
        slots[op.slot_c] = kf["potrf"](slots[op.slot_c])
    elif kind is OpKind.TRSM:
        slots[op.slot_c] = kf["trsm"](slots[op.slot_a], slots[op.slot_c])


def make_torch_executor(sched: Schedule, compute_dtype=torch.float64,
                        use_pallas: bool = False, device="cuda"):
    """Build a function that replays ``sched`` on a host tile store.

    The store is the ``[nt, nt, tb, tb]`` CPU tensor in ``compute_dtype``
    (pinned for a CUDA ``device``); the function factors it in place and
    returns the executed transfer counters (copies and bytes each way)
    once every op is queued.  The caller synchronises the device before it
    reads the store.
    """
    if sched.host_slots > 0:
        raise NotImplementedError(
            "spill schedules (host_slots > 0) are not ported yet "
            "(ROADMAP queue 1, item 7)")
    device = torch.device(device)
    tb = sched.tb
    lad = sched.plan.ladder
    nslots = max(_device_nslots(sched.ops), 1)
    kf = _make_kernel_fns(use_pallas)

    def run(host: torch.Tensor) -> dict:
        if host.dtype != compute_dtype or host.device.type != "cpu":
            raise ValueError(f"host store must be a CPU {compute_dtype} "
                             f"tensor, got {host.dtype} on {host.device}")
        io = {"h2d_ops": 0, "h2d_bytes": 0, "d2h_ops": 0, "d2h_bytes": 0}
        slots = torch.zeros((nslots, tb, tb), dtype=compute_dtype,
                            device=device)
        for op in sched.ops:
            _interpret_op(host, slots, op, lad, kf, io)
        return io

    return run


def _tile_stats(a: torch.Tensor, tb: int):
    """Per-tile Frobenius norms and absolute maxima of an [n, n] tensor,
    on its own device, one tile row at a time."""
    nt = a.shape[0] // tb
    norms = torch.empty((nt, nt), dtype=torch.float64)
    amax = torch.empty((nt, nt), dtype=torch.float64)
    for i in range(nt):
        rows = a[i * tb:(i + 1) * tb].to(torch.float64).reshape(tb, nt, tb)
        norms[i] = rows.square().sum(dim=(0, 2)).sqrt().cpu()
        amax[i] = rows.abs().amax(dim=(0, 2)).cpu()
    return norms.numpy(), amax.numpy()


def plan_for_matrix(a, eps_target: float | None, ladder: str = "tpu",
                    tb: int | None = None) -> PrecisionPlan:
    """Higham-Mary precision plan of a matrix (port of the reference's
    ``plan_for_matrix``).

    ``a`` is a numpy ``[nt, nt, tb, tb]`` tile store, as in the reference,
    or an ``[n, n]`` tensor on any device together with ``tb``; the tile
    norms and maxima of a tensor are taken on its device.
    """
    if isinstance(a, torch.Tensor):
        if tb is None:
            raise ValueError("plan_for_matrix: pass tb with an [n, n] tensor")
        nt = a.shape[0] // tb
        if eps_target is None:
            return uniform_plan(nt, "f64", ladder)
        norms, amax = _tile_stats(a, tb)
        # ||A||_F from the lower tiles, summed as precision.tile_norms does
        total = 0.0
        for j in range(nt):
            for i in range(j, nt):
                total += (1.0 if i == j else 2.0) * norms[i, j] ** 2
        total = float(np.sqrt(total))
    else:
        if eps_target is None:
            return uniform_plan(a.shape[0], "f64", ladder)
        norms, total = tile_norms(a)
        amax = tile_amax(a)
    return assign_precision(norms, total, eps_target, ladder, tile_amax=amax)
