#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # the full run: n = 32768, tb = 512

Phases, in order; any failure raises and the script exits non-zero:

1. card: ``nvidia-smi`` name and power limit;
2. build: the four tile kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source, all at once;
3. kernel check: each kernel against its plain PyTorch version on the card
   at the main path's tile size (f32) and at bf16 (fp8 operands for the
   GEMM), with the tolerances of ``tests/test_kernels.py``, and its time
   beside the plain version's, one PyTorch library call's and its bound;
4. main path: a seeded SPD matrix built on the card, planned with an
   ``eps_target`` precision plan and factored through ``plan(...).compile()``
   with the hand-written kernels (``use_pallas=True``) in f32; then solve,
   logdet, and the checks of the launch counts, the transfers and the
   accuracy against ``torch.linalg.cholesky`` in f64;
5. the kernels line (JSON) and the last line,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.  It writes the results to
``chiprun_out/chip_smoke.json`` as well.  ``--n`` and ``--tb`` cut the
size for a quick run.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit:
# f32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

KERNEL_META = {
    "mxp_gemm_update": ("src/repro_torch/kernels/csrc/mxp_gemm.cu",
                        "src/repro/kernels/mxp_gemm.py:43"),
    "syrk_update": ("src/repro_torch/kernels/csrc/syrk.cu",
                    "src/repro/kernels/syrk.py:40"),
    "trsm": ("src/repro_torch/kernels/csrc/trsm.cu",
             "src/repro/kernels/trsm.py:34"),
    "potrf": ("src/repro_torch/kernels/csrc/potrf.cu",
              "src/repro/kernels/potrf.py:41"),
}
_OP_OF = {"mxp_gemm_update": "GEMM", "syrk_update": "SYRK", "trsm": "TRSM",
          "potrf": "POTRF"}


def log(*args):
    print(*args, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _spd(n, g, dev, dtype=torch.float32):
    x = torch.randn(n, n, generator=g, device=dev) / math.sqrt(n)
    return (x @ x.T + 2.0 * torch.eye(n, device=dev)).to(dtype)


def kernel_checks(tb: int, dev, g) -> dict:
    """Each kernel against its plain version at tile size ``tb``; f32 is
    the main path's dtype and the one timed."""
    from repro_torch.kernels import mxp_gemm, potrf, ref, syrk, trsm
    tol = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
    results = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # library calls in f32
    try:
        for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            cdt = torch.float32 if dt == torch.float8_e4m3fn else dt
            t = tol[cdt]
            c = _spd(tb, g, dev, cdt)
            a = torch.randn(tb, tb, generator=g, device=dev).to(dt)
            b = torch.randn(tb, tb, generator=g, device=dev).to(dt)
            cases = {"mxp_gemm_update": (
                mxp_gemm.mxp_gemm_update, ref.gemm_update_ref, (c, a, b),
                tb * t / 16, t, lambda: c - a @ b.T,
                2.0 * tb ** 3, 4 * tb * tb * 4)}
            if dt != torch.float8_e4m3fn:
                l = torch.linalg.cholesky(c.double()).to(dt).contiguous()
                cases.update({
                    "syrk_update": (       # the lower triangle's flops
                        syrk.syrk_update, ref.syrk_update_ref, (c, a),
                        tb * t / 16, t, lambda: c - a @ a.T,
                        1.0 * tb * tb * (tb + 1), 3 * tb * tb * 4),
                    "trsm": (
                        trsm.trsm, ref.trsm_ref, (l, a), 20 * t, 20 * t,
                        lambda: torch.linalg.solve_triangular(
                            l.T, a, upper=True, left=False),
                        1.0 * tb ** 3, 3 * tb * tb * 4),
                    "potrf": (
                        potrf.potrf, ref.potrf_ref, (c,), t, t,
                        lambda: torch.linalg.cholesky(c),
                        tb ** 3 / 3.0, 2 * tb * tb * 4),
                })
            for name, (kern, plain, args, atol, rtol, library, flops,
                       nbytes) in cases.items():
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                torch.testing.assert_close(
                    got.double(), want.double(), atol=atol, rtol=rtol,
                    msg=lambda m, name=name, dt=dt: f"{name} {dt}: {m}")
                tag = f"{name}[{str(dt).replace('torch.', '')}]"
                row = {"dtype": str(dt).replace("torch.", ""),
                       "max_abs_err": err, "atol": atol, "rtol": rtol}
                if dt == torch.float32:     # the main path's dtype: timed
                    reps = 50 if name != "potrf" else 10
                    bound_f = flops / PEAK_F32_FLOPS * 1e3
                    bound_b = nbytes / PEAK_HBM_BYTES * 1e3
                    row.update({
                        "ms": time_ms(lambda: kern(*args), reps),
                        "plain_ms": time_ms(lambda: plain(*args), reps),
                        "library_ms": time_ms(library, reps),
                        "bound_ms": max(bound_f, bound_b),
                        "bound_by": ("operations" if bound_f >= bound_b
                                     else "bytes"),
                        "flops": flops, "bytes": nbytes})
                results[tag] = row
                log(f"kernel {tag}: " + json.dumps(row))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return results


def main_path(n: int, tb: int, dev, seed: int) -> dict:
    import repro_torch
    from repro_torch.core.schedule import OpKind
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, n, generator=g, device=dev, dtype=torch.float64)
    a = x @ x.T / n + 2.0 * torch.eye(n, device=dev, dtype=torch.float64)
    del x
    a = 0.5 * (a + a.T)
    eps_target = 1e-6
    t0 = time.perf_counter()
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu", eps_target=eps_target,
        use_pallas=True, compute_dtype=torch.float32).specialize(a)
    solver = repro_torch.plan(n, cfg).compile(device=dev)
    sched = solver.schedule
    plan_s = time.perf_counter() - t0
    hist = cfg.plan.histogram()
    nops = sum(len(s) for s in sched.streams)
    log(f"main: n={n} tb={tb} nt={n // tb} ops={nops} "
        f"plan+compile {plan_s:.2f}s precision histogram {hist}")

    repro_torch.reset_counts()       # the main path's launches only
    t0 = time.perf_counter()
    solver.factor(a, materialize=False)
    factor_s = time.perf_counter() - t0
    launches = repro_torch.launch_counts()
    want = {name: sched.count(OpKind[_OP_OF[name]]) for name in launches}
    log(f"main: factor {factor_s:.3f}s, {n ** 3 / 3 / factor_s / 1e12:.3f} "
        f"TFLOP/s (n^3/3); launches {launches}; schedule {want}")
    require(launches == want, f"launches {launches} != schedule {want}")

    io = solver.stats["transfers"]
    itemsize = torch.finfo(torch.float32).bits // 8
    tile_bytes = tb * tb * itemsize
    require(io["executed_h2d_ops"] == sched.count(OpKind.LOAD)
            and io["executed_d2h_ops"] == sched.count(OpKind.STORE)
            and io["executed_h2d_bytes"] == io["executed_h2d_ops"] * tile_bytes
            and io["executed_d2h_bytes"] == io["executed_d2h_ops"] * tile_bytes,
            f"executed transfers {io} do not match the schedule")
    log(f"main: executed H2D {io['executed_h2d_bytes']} B / D2H "
        f"{io['executed_d2h_bytes']} B (f32 tiles); schedule (class "
        f"precision) loads_bytes {sched.loads_bytes()} stores_bytes "
        f"{sched.stores_bytes()}")

    # accuracy against the f64 factor on the card. Every tile op runs in
    # f32 (f64-class tiles are held in the f32 compute dtype), and the plan
    # demotes a tile only where its class's roundoff keeps the error near
    # eps_target. So L carries about max(eps_target, 2^-24 sqrt(n)) of
    # max|A| for a well-conditioned A (kappa ~ 2 here); the bound allows
    # 64 times that (6.9e-4 at n = 32768).
    lref = torch.linalg.cholesky(a)
    nt = n // tb
    err = 0.0
    for i in range(nt):
        got = solver.tiles[i, :i + 1].to(dev).to(torch.float64)
        want_rows = lref[i * tb:(i + 1) * tb, :(i + 1) * tb].reshape(
            tb, i + 1, tb).permute(1, 0, 2)
        got[i] = torch.tril(got[i])
        err = max(err, float((got - want_rows).abs().max()))
    amax = float(a.abs().max())
    rel_l = err / amax
    bound_l = 64 * max(eps_target, 2.0 ** -24 * math.sqrt(n))
    log(f"main: max|L - chol64(A)|/max|A| = {rel_l:.3e} (bound {bound_l:.1e})")
    require(math.isfinite(rel_l) and rel_l < bound_l, f"factor error {rel_l}")

    # solve: relative residual ||A x - b|| / (||A|| ||x||) of the f64
    # substitution over the f32 factor; a backward-stable solve with this
    # factor gives about the factor's error, same bound.
    b = torch.randn(n, 4, generator=g, device=dev, dtype=torch.float64)
    t0 = time.perf_counter()
    xs = torch.from_numpy(solver.solve(b.cpu().numpy())).to(dev)
    solve_s = time.perf_counter() - t0
    res = float(torch.linalg.norm(a @ xs - b) /
                (torch.linalg.norm(a) * torch.linalg.norm(xs)))
    log(f"main: solve (4 rhs) {solve_s:.3f}s relative residual {res:.3e} "
        f"(bound {bound_l:.1e})")
    require(math.isfinite(res) and res < bound_l, f"solve residual {res}")

    # logdet: the sum of 2 log L_ii; each L_ii carries the factor's
    # relative error, so |delta logdet| / n is held to the same bound
    ld = solver.logdet()
    ld_ref = 2.0 * float(torch.log(torch.diagonal(lref)).sum())
    ld_err = abs(ld - ld_ref) / n
    log(f"main: logdet {ld:.6f} vs {ld_ref:.6f}, error/n {ld_err:.3e}")
    require(ld_err < bound_l, f"logdet error {ld_err}")
    return {"n": n, "tb": tb, "nt": nt, "ops": nops,
            "precision_histogram": hist, "factor_s": factor_s,
            "tflops_n3_over_3": n ** 3 / 3 / factor_s / 1e12,
            "launches": launches, "schedule_counts": want,
            "transfers": io, "rel_factor_err": rel_l, "bound": bound_l,
            "solve_s": solve_s, "solve_residual": res,
            "logdet_err_per_n": ld_err, "plan_compile_s": plan_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--tb", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda")

    card = card_line()
    log(card)                                   # 1. card
    t0 = time.perf_counter()                    # 2. build
    out = _build.build(ptxas_info=True)
    build_s = time.perf_counter() - t0
    for name, text in out.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {len(out)} sources in {build_s:.1f}s")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    checks = kernel_checks(args.tb, dev, g)     # 3. kernel check
    main = main_path(args.n, args.tb, dev, args.seed)   # 4. main path

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row = checks[f"{name}[float32]"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "checks": checks, "main": main,
         "kernels": kernels}, indent=1))
    log(card)
    print(json.dumps({"kernels": kernels}))     # 5. kernels line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
