"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell on
a fake process group (port of ``repro.launch.dryrun``).

Proves the distribution config is coherent without hardware: a fake
process group of 256 or 512 ranks backs the production meshes in one
process, the abstract state is distributed as DTensors under
``FakeTensorMode`` (no storage), and one train, prefill or decode step runs
on the cell's shape.  :func:`repro_torch.launch.cost.analyze_step` counts
what one rank runs: flops, HBM bytes and collectives, per device.  The
roofline terms are model readings on the H100 SXM datasheet's rates.

The reference lowers and compiles each cell with XLA and reports
``lower_s``/``compile_s``, ``cost_analysis()`` and ``memory_analysis()``;
the port traces eagerly (``trace_s``) and has neither analysis (null, with
the reason).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all          # every cell, a subprocess each
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.distributed.sharding import (activation_sharding,
                                              axis_sizes, distribute,
                                              distribute_model,
                                              index_arithmetic_unfaked)
from repro_torch.launch import cost
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.optim.adamw import adamw_init

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_torch")
NO_ANALYSIS = ("no XLA executable: the port runs eagerly; see hlo_flops, "
               "hlo_hbm_bytes and collectives (repro_torch.launch.cost)")


def open_fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks in this process (rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is "
                               f"open; the cell needs {size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _flat_cache(cache: list) -> dict:
    return {f"{i}.{k}": t for i, layer in enumerate(cache)
            for k, t in layer.items()}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               accum_steps: int = 1, opts: dict | None = None,
               by_module: bool = False):
    """Distribute + trace one cell; return the result record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    opts = opts or {}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_kind = "multi" if multi_pod else "single"
    if shape_name == "long_500k" and not cfg.sub_quadratic():
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "full-attention arch; long_500k needs sub-quadratic"}

    open_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh.size()
    t0 = time.time()

    quantized_opt = bool(opts.get("q8opt", False))
    batch_abs = S.input_specs(cfg, shape)
    batch_sh = S.batch_shardings(cfg, shape, mesh)

    seq_sharded_acts = bool(opts.get("seq_sharded",
                                     shape.name == "long_500k"))
    # context-parallel attention by default when the head count does not
    # divide the TP degree (otherwise attention replicates TP-fold)
    auto_attn_sp = (cfg.num_heads % axis_sizes(mesh)["model"] != 0
                    and shape.kind != "decode")
    with FakeTensorMode(allow_non_fake_inputs=True), \
            index_arithmetic_unfaked():
        model = distribute_model(T.Model(cfg, None, "cpu"), mesh)
        batch = {k: distribute(torch.zeros(t.shape, dtype=t.dtype), batch_sh[k],
                               mesh)
                 for k, t in batch_abs.items() if t.ndim}
        with activation_sharding(
                mesh, seq_sharded=seq_sharded_acts,
                attn_seq_parallel=bool(opts.get("attn_sp", auto_attn_sp)),
                residual_seq_parallel=bool(opts.get("sp", False)),
                bf16_all_reduce=bool(opts.get("bf16_ar", False))):
            if shape.kind == "train":
                model.requires_grad_(True)
                opt = adamw_init(model, quantize=quantized_opt)
                step = make_train_step(cfg, accum_steps=accum_steps,
                                       quantized_opt=quantized_opt)
                stats = cost.analyze_step(step, model, opt, batch,
                                          by_module=by_module)
            elif shape.kind == "prefill":
                stats = cost.analyze_step(make_prefill_step(cfg), model,
                                          batch, by_module=by_module)
            else:  # decode
                cache_abs, cache_sh = _cache(cfg, shape, mesh)
                cache = [{k: distribute(torch.zeros(t.shape, dtype=t.dtype),
                                        sh[k], mesh) for k, t in c.items()}
                         for c, sh in zip(cache_abs, cache_sh)]
                stats = cost.analyze_step(
                    make_serve_step(cfg), model, cache, batch["token"],
                    shape.seq_len - 1, enc_out=batch.get("enc_out"),
                    by_module=by_module)
    t_trace = time.time() - t0
    state_bytes = state_bytes_per_device(cfg, shape, mesh, quantized_opt)

    coll = stats["collectives"]
    total, active = cfg.param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        model_flops = 6 * active * tokens
    elif shape.kind == "prefill":
        model_flops = 2 * active * tokens
    else:
        model_flops = 2 * active * shape.global_batch
    roof = cost.roofline_terms(flops=stats["flops"],
                               hbm_bytes=stats["hbm_bytes"], coll=coll,
                               chips=chips, model_flops=model_flops)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok",
        "chips": chips,
        "trace_s": round(t_trace, 1),
        "hlo_flops": stats["flops"],
        "hlo_hbm_bytes": stats["hbm_bytes"],
        "cost_analysis": None,
        "memory_analysis": None,
        "analysis_note": NO_ANALYSIS,
        "collectives": coll,
        "roofline": roof,
        "roofline_note": "model reading: H100 SXM datasheet rates",
        "state_bytes_per_device": state_bytes,
        "params_total": total, "params_active": active,
        "accum_steps": accum_steps,
        "opts": opts,
    }
    if by_module:
        rec["by_module"] = stats["by_module"]
        rec["by_op"] = stats["by_op"]
    return rec


def _cache(cfg, shape, mesh):
    """(the abstract decode cache of ``shape``, its specs)."""
    cache_abs = S.abstract_cache(cfg, shape.global_batch, shape.seq_len,
                                 dtype_of(cfg.dtype))
    return cache_abs, S.cache_shardings(
        cfg, cache_abs, mesh, seq_sharded=shape.name == "long_500k")


def state_bytes_per_device(cfg, shape, mesh,
                           quantized_opt: bool = False) -> int:
    """A cell's resident state on one device, from the specs alone (the
    reference's ``_sharded_bytes`` arithmetic): the parameters, for a
    train cell their two AdamW moments too, for a decode cell its cache."""
    params_abs, p_sh, opt_abs, opt_sh = S.train_state_shardings(
        cfg, mesh, quantized_opt=quantized_opt)
    total = S.sharded_bytes(dict(params_abs.named_parameters()), p_sh, mesh)
    if shape.kind == "train":
        total += (_moment_bytes(opt_abs.m, opt_sh.m, mesh)
                  + _moment_bytes(opt_abs.v, opt_sh.v, mesh))
    elif shape.kind == "decode":
        cache_abs, cache_sh = _cache(cfg, shape, mesh)
        total += S.sharded_bytes(_flat_cache(cache_abs),
                                 _flat_cache(cache_sh), mesh)
    return total


def _moment_bytes(moments: dict, specs: dict, mesh) -> int:
    """Per-device bytes of AdamW moments (a Q8 moment's payload and
    scale each by its own spec)."""
    flat, flat_sh = {}, {}
    for k, m in moments.items():
        if isinstance(m, tuple):
            for f in m._fields:
                flat[f"{k}.{f}"] = getattr(m, f)
                flat_sh[f"{k}.{f}"] = getattr(specs[k], f)
        else:
            flat[k], flat_sh[k] = m, specs[k]
    return S.sharded_bytes(flat, flat_sh, mesh)


def run_cell(arch, shape_name, mesh_kind, out_dir, accum_steps=1,
             opts=None, tag=""):
    rec = lower_cell(arch, shape_name, mesh_kind == "multi",
                     accum_steps=accum_steps, opts=opts)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def run_all(out_dir, meshes=("single", "multi"), timeout=3600,
            only_missing=False, jobs: int = 1):
    """Every cell, a subprocess each, ``jobs`` at a time."""
    cells = [(arch, shape_name, mesh_kind) for arch in ARCHS
             for shape_name in SHAPES for mesh_kind in meshes]
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    results, running = {}, []

    def path_of(cell):
        return os.path.join(out_dir, "%s__%s__%s.json" % cell)

    def finish(cell, proc, t0):
        try:
            _, err = proc.communicate(
                timeout=max(1, timeout - (time.time() - t0)))
            ok = proc.returncode == 0
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            ok, err = False, "timeout"
        path = path_of(cell)
        if ok and os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
        else:
            rec = {"arch": cell[0], "shape": cell[1], "mesh": cell[2],
                   "status": "failed", "error": (err or "")[-2000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        results[cell] = rec
        print(f"[{time.time() - t0:6.1f}s] {' '.join(cell)}: {rec['status']}",
              flush=True)

    os.makedirs(out_dir, exist_ok=True)
    for cell in cells:
        if only_missing and os.path.exists(path_of(cell)):
            with open(path_of(cell)) as f:
                rec = json.load(f)
            if rec["status"] != "failed":
                results[cell] = rec
                print(f"[cached] {' '.join(cell)}: {rec['status']}")
                continue
        while len(running) >= jobs:
            done = [r for r in running if r[1].poll() is not None
                    or time.time() - r[2] > timeout]
            if not done:
                time.sleep(0.5)
            for r in done:
                running.remove(r)
                finish(*r)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
               "--out", out_dir]
        running.append((cell, subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True, env=env), time.time()))
    while running:
        finish(*running.pop(0))
    out = [results[c] for c in cells]
    n_ok = sum(r["status"] == "ok" for r in out)
    n_skip = sum(r["status"] == "skipped" for r in out)
    n_fail = sum(r["status"] == "failed" for r in out)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed, "
          f"of {len(out)} cells ==")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once with --all")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--attn-sp", action="store_true",
                    help="context-parallel attention (queries over 'model')")
    ap.add_argument("--sp", action="store_true",
                    help="Megatron-style sequence-parallel residual stream")
    ap.add_argument("--bf16-ar", action="store_true",
                    help="the reference's bf16 residual pin (the identity "
                         "here: see sharding.residual_barrier)")
    ap.add_argument("--q8opt", action="store_true",
                    help="int8 (block-scaled) optimizer moments")
    ap.add_argument("--tag", default="",
                    help="suffix for the output JSON (perf iterations)")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args()
    if args.all:
        results = run_all(args.out, only_missing=args.only_missing,
                          jobs=args.jobs)
        sys.exit(1 if any(r["status"] == "failed" for r in results) else 0)
    opts = {}
    if args.attn_sp:
        opts["attn_sp"] = True
    if args.sp:
        opts["sp"] = True
    if args.bf16_ar:
        opts["bf16_ar"] = True
    if args.q8opt:
        opts["q8opt"] = True
    rec = run_cell(args.arch, args.shape, args.mesh, args.out,
                   accum_steps=args.accum_steps, opts=opts, tag=args.tag)
    print(json.dumps(rec, indent=1)[:4000])
    sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
