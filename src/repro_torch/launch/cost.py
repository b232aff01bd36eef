"""Per-device FLOP, HBM-byte and collective accounting of one eager step
(the port's counterpart of ``repro.launch.hlo``).

The reference parses the partitioned HLO text of a compiled step and
multiplies each loop body by its trip count.  The port runs eagerly: every
layer's ops are dispatched, so there are no loops to multiply, and no HLO.
:func:`analyze_step` runs the step once under a ``TorchDispatchMode`` that
sees the ops each rank runs on its own blocks (the local aten ops below
DTensor, not the DTensor-level ops, whose shapes are global):

  * flops       - ``torch.utils.flop_counter``'s formula for each op;
  * hbm bytes   - in eager every aten op is a kernel boundary: its tensor
                  operands read plus its results written, views free;
  * collectives - the functional collectives DTensor issues, by kind, with
                  their result-buffer bytes (the reference's measure), and
                  ``CommDebugMode``'s counts beside them.

The step may run on fake tensors (the dry-run) or real ones.
:func:`roofline_terms` turns the per-device counts into three time terms
with the H100 SXM datasheet's constants; those are model readings, not
measurements.

Debug view (the counterpart of ``tools/hlo_debug.py``): the breakdown by
module, and by op and local shapes, of one dry-run cell,
  PYTHONPATH=src python -m repro_torch.launch.cost <arch> <shape> [multi]
"""
from __future__ import annotations

import collections
import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 80GB datasheet figures (not measured here):
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
NVLINK_BW = 450e9         # NVLink 4 bytes/s per direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (torch.ops._c10d_functional) -> the reference's kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that move no bytes of their own
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "_unsafe_view", "detach", "alias",
         "lift_fresh", "_local_scalar_dense", "wait_tensor", "device",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "_to_copy_noop"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.element_size() * t.numel() for t in _tensors(tree))


class _Meter(TorchDispatchMode):
    """Counts the local ops: returns NotImplemented on DTensor-level ops,
    so DTensor runs them and its local ops come back here."""

    def __init__(self, by_module: bool = False):
        super().__init__()
        self.flops = 0
        self.hbm = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.quiet = 0
        self.tracker = None
        self.per_module = collections.defaultdict(
            lambda: {"flops": 0, "hbm_bytes": 0, "collective_bytes": 0})
        self.per_op = collections.defaultdict(
            lambda: {"flops": 0, "count": 0})
        if by_module:
            from torch.utils.module_tracker import ModuleTracker
            self.tracker = ModuleTracker()

    def _where(self) -> str:
        names = self.tracker.parents if self.tracker else ()
        return max(names, key=len) if names else "Global"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.quiet:
            return out
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        rec = self.per_module[self._where()] if self.tracker else None
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _KINDS.get(name)
            if kind is not None:
                b = _nbytes(out)
                self.coll_bytes[kind] += b
                self.coll_counts[kind] += 1
                if rec is not None:
                    rec["collective_bytes"] += b
            return out
        if ns == "prim" or func.is_view or name in _FREE:
            return out
        f = 0
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            f = int(fn(*args, **kwargs, out_val=out))
        b = _nbytes((args, kwargs)) + _nbytes(out)
        if name.endswith("_") or name in ("copy_", "index_put_"):
            b -= _nbytes(out)          # in place: the result is an operand
        self.flops += f
        self.hbm += b
        if rec is not None:
            rec["flops"] += f
            rec["hbm_bytes"] += b
            if f:
                op = self.per_op[f"{name} " + " x ".join(
                    str(tuple(t.shape)) for t in _tensors(args))]
                op["flops"] += f
                op["count"] += 1
        return out


@contextlib.contextmanager
def _quiet_sharding_propagation(meter: _Meter):
    """DTensor derives each op's global output shape by running the op on
    fake global tensors; those runs are not the device's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    orig = getattr(ShardingPropagator, name)

    def quiet(self, *a, **k):
        meter.quiet += 1
        try:
            return orig(self, *a, **k)
        finally:
            meter.quiet -= 1

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def analyze_step(fn, *args, by_module: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count, per device: {"flops",
    "hbm_bytes", "collectives": {"bytes", "counts", "total_bytes",
    "total_count", "comm_debug_counts"}, "result"} (and "by_module" and
    "by_op" when asked: the counts of the innermost module each op ran in,
    and the flops and calls of each op at its local operand shapes)."""
    from torch.distributed.tensor.debug import CommDebugMode
    meter = _Meter(by_module)
    comm = CommDebugMode()
    with _quiet_sharding_propagation(meter), comm, \
            (meter.tracker or contextlib.nullcontext()), meter:
        result = fn(*args, **kwargs)
    out = {
        "flops": meter.flops,
        "hbm_bytes": meter.hbm,
        "collectives": {
            "bytes": dict(meter.coll_bytes),
            "counts": dict(meter.coll_counts),
            "total_bytes": sum(meter.coll_bytes.values()),
            "total_count": sum(meter.coll_counts.values()),
            "comm_debug_counts": {str(k): v for k, v in
                                  comm.get_comm_counts().items()},
        },
        "result": result,
    }
    if by_module:
        out["by_module"] = {k: dict(v) for k, v in meter.per_module.items()}
        out["by_op"] = {k: dict(v) for k, v in meter.per_op.items()}
    return out


# ring-algorithm wire multipliers (bytes crossing a device's links as a
# multiple of the per-device result buffer; (P-1)/P ~ 1 at P >= 16)
_WIRE_MULT = {
    "all-gather": 1.0,        # receives the full gathered buffer
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def wire_bytes(coll: dict) -> float:
    return sum(_WIRE_MULT[k] * v for k, v in coll["bytes"].items())


def roofline_terms(flops: float, hbm_bytes: float, coll: dict,
                   chips: int = 1, model_flops: float | None = None) -> dict:
    """Three per-device time terms in seconds on the H100 SXM datasheet's
    peak rates, and the dominant one (model readings)."""
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = wire_bytes(coll) / NVLINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)),
        key=lambda kv: kv[1])[0]
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
    if model_flops is not None:
        out["model_flops"] = model_flops
        out["useful_fraction"] = (
            model_flops / (flops * chips) if flops else 0.0)
    return out


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: python -m repro_torch.launch.cost <arch> "
                         "<shape> [multi]")
    from repro_torch.launch import dryrun
    rec = dryrun.lower_cell(argv[0], argv[1], multi_pod="multi" in argv[2:],
                            by_module=True)
    if rec["status"] != "ok":
        print(rec)
        return
    rows = sorted(rec["by_module"].items(), key=lambda kv: -kv[1]["flops"])
    print(f"{'module':60s} {'GFLOP':>12s} {'HBM GB':>10s} {'coll GB':>9s}")
    for name, r in rows[:60]:
        print(f"{name[:60]:60s} {r['flops'] / 1e9:12.1f} "
              f"{r['hbm_bytes'] / 1e9:10.2f} "
              f"{r['collective_bytes'] / 1e9:9.3f}")
    ops = sorted(rec["by_op"].items(), key=lambda kv: -kv[1]["flops"])
    print(f"{'op at local shapes':60s} {'GFLOP':>12s} {'calls':>10s}")
    for name, r in ops[:30]:
        print(f"{name[:60]:60s} {r['flops'] / 1e9:12.1f} {r['count']:10d}")
    print("total flops %.4e  hbm %.4e  collective bytes %.4e" % (
        rec["hlo_flops"], rec["hlo_hbm_bytes"],
        rec["collectives"]["total_bytes"]))
    print("collective counts:", rec["collectives"]["counts"])
    print("roofline (model reading, H100 SXM datasheet):", rec["roofline"])


if __name__ == "__main__":
    main()
