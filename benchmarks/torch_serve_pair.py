#!/usr/bin/env python3
"""Two tenants' factors on one card: where the served pair's time goes.

    python3 benchmarks/torch_serve_pair.py [--n 32768] [--tb 512] [--seed 0]

Runs the two tenants of ``chip_smoke.py``'s phase 11 (the main path's
configuration, each tenant its own seeded SPD matrix on the card; the
configuration's precision plan specialised to each) and reports:

* ``solo``: each factor alone, twice, in a thread of its own: wall
  seconds, the thread's CPU seconds, and its voluntary and involuntary
  context switches per schedule op (``getrusage(RUSAGE_THREAD)``);
* ``threads``: the two factors at once from two threads with no lock (what
  ``SolverService`` did before its device lock), twice: the same readings
  per thread and the pair's wall;
* ``traced``: each factor through a ``TraceRecorder`` (one span per op,
  the stream fenced after each), alone and the two at once: the median
  span by kind and the summed spans;
* ``served``: ``SolverService(workers=2)`` with its device lock patched out
  (the earlier service) and as it is, with no memory model; then with
  admission on the card's memory, first re-reading each plan's slot count
  off its schedule at every submit and dispatch (the earlier admission)
  and then as it is (read once a plan): the pair's wall, each factor
  bitwise its solo one, then a burst of 64 single-RHS solves a tenant
  (window 5 ms, ``max_batch`` 32): wall, work items, solves/s, latency
  p50/p99; one 32-column solve alone, and one read of the slot count.

Needs a CUDA device; writes ``chiprun_out/torch_serve_pair.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import resource
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BURST, WINDOW_S, MAX_BATCH = 64, 0.005, 32


def _timed(fn, out: dict, barrier=None):
    """A thread that runs ``fn`` and fills ``out`` with its wall and CPU
    seconds and context switches."""
    def body():
        if barrier is not None:
            barrier.wait()
        r0 = resource.getrusage(resource.RUSAGE_THREAD)
        c0, t0 = time.thread_time(), time.perf_counter()
        fn()
        t1, c1 = time.perf_counter(), time.thread_time()
        r1 = resource.getrusage(resource.RUSAGE_THREAD)
        out.update(wall_s=t1 - t0, cpu_s=c1 - c0,
                   nvcsw=r1.ru_nvcsw - r0.ru_nvcsw,
                   nivcsw=r1.ru_nivcsw - r0.ru_nivcsw)
    return threading.Thread(target=body)


def _run(fns) -> tuple[float, list]:
    """Run ``fns`` at once, each in its own thread; (wall, per-thread)."""
    outs = [{} for _ in fns]
    barrier = threading.Barrier(len(fns) + 1)
    ths = [_timed(f, o, barrier) for f, o in zip(fns, outs)]
    for th in ths:
        th.start()
    barrier.wait()
    t0 = time.perf_counter()
    for th in ths:
        th.join()
    return time.perf_counter() - t0, outs


def _per_op(outs, nops: int) -> list:
    return [{**o, "nvcsw_per_op": o["nvcsw"] / nops,
             "nivcsw_per_op": o["nivcsw"] / nops,
             "cpu_us_per_op": o["cpu_s"] / nops * 1e6} for o in outs]


def _spans(rec) -> dict:
    by = {}
    for s in rec.spans:
        by.setdefault(s.kind, []).append((s.t_end - s.t_start) / 1e3)
    return {k: {"count": len(v), "median_us": statistics.median(v),
                "sum_s": sum(v) / 1e6} for k, v in sorted(by.items())}


def _burst(svc, sess, rhs) -> dict:
    t0 = time.perf_counter()
    futs = [[s.solve_async(b) for b in bs] for s, bs in zip(sess, rhs)]
    xs = [np.stack([f.result() for f in fs], axis=1) for fs in futs]
    wall = time.perf_counter() - t0
    snap = svc.metrics.snapshot()
    lat = [r.latency for r in svc.metrics._records
           if r.ok and r.kind == "solve"]
    items = {(r.t_start, r.t_end) for r in svc.metrics._records
             if r.kind == "solve"}
    return {"wall_s": wall, "items": len(items),
            "max_occupancy": snap["batch"]["max_occupancy"],
            "solves_per_s": 2 * BURST / wall,
            "p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99))}, xs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--tb", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_pair: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    from repro_torch import obs
    from repro_torch.serve import SolverService
    from repro_torch.serve import admission as admission_mod
    from repro_torch.serve import service as service_mod

    card = cs.card_line()
    dev = torch.device("cuda")
    n, tb = args.n, args.tb
    mats = [cs.make_spd(n, dev, args.seed + 11 + i) for i in range(2)]
    cfgs = [cs.main_config(tb).specialize(m) for m in mats]
    plans = [repro_torch.plan(n, c) for c in cfgs]
    nops = [len(p.single_schedule().ops) for p in plans]
    out = {"card": card, "n": n, "tb": tb, "ops": nops,
           "switch_interval_s": sys.getswitchinterval()}

    solvers = [p.compile(device=dev) for p in plans]
    solvers[0].factor(mats[0], materialize=False)        # build, warm

    def factor(i, trace=None):
        return lambda: solvers[i].factor(mats[i], materialize=False,
                                         trace=trace)

    out["solo"] = []
    for _ in range(2):
        for i in range(2):
            _, o = _run([factor(i)])
            out["solo"].append({"tenant": i, **_per_op(o, nops[i])[0]})
    tiles = [s.tiles.clone() for s in solvers]
    t0 = time.perf_counter()
    x_solo = solvers[0].solve(np.random.default_rng(0).standard_normal(
        (n, MAX_BATCH)))
    out["solve_32_cols_s"] = time.perf_counter() - t0
    del x_solo

    out["threads"] = []
    for _ in range(2):
        wall, o = _run([factor(0), factor(1)])
        out["threads"].append({"wall_s": wall, "per_thread": [
            _per_op([x], k)[0] for x, k in zip(o, nops)]})

    recs = [obs.TraceRecorder() for _ in range(2)]
    _run([factor(0, recs[0])])
    out["traced_solo"] = {"wall_s": recs[0].makespan_s(),
                          "spans": _spans(recs[0])}
    for r in recs:
        r.clear()
    wall, _ = _run([factor(0, recs[0]), factor(1, recs[1])])
    out["traced_pair"] = {"wall_s": wall,
                          "spans": [_spans(r) for r in recs]}
    del solvers, recs
    gc.collect()

    t0 = time.perf_counter()
    plans[0].schedule.stream_nslots(0)
    out["slot_walk_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 11)
    rhs = [[rng.standard_normal(n) for _ in range(BURST)] for _ in mats]
    real_locks = service_mod.device_locks
    real_slots = admission_mod.plan_device_slots
    card_hw = dataclasses.replace(repro_torch.HW["h100-pcie"],
                                  mem_bytes=torch.cuda.mem_get_info(dev)[1])

    def walk(plan):
        return max(plan.schedule.stream_nslots(d)
                   for d in range(plan.schedule.ndev))

    out["served"] = {}
    for name, locks, hw, slots in (
            ("lock_off", lambda solver: [], None, real_slots),
            ("lock_on", real_locks, None, real_slots),
            ("admission_walks", real_locks, card_hw, walk),
            ("admission", real_locks, card_hw, real_slots)):
        service_mod.device_locks = locks
        admission_mod.plan_device_slots = slots
        try:
            with SolverService(workers=2, hw=hw, device=dev,
                               batch_window=WINDOW_S,
                               max_batch=MAX_BATCH) as svc:
                sess = [svc.session(f"t{i}", n, c)
                        for i, c in enumerate(cfgs)]
                t0 = time.perf_counter()
                for f in [s.factor_async(m) for s, m in zip(sess, mats)]:
                    f.result()
                pair_s = time.perf_counter() - t0
                bitwise = [torch.equal(s._solver.tiles, t)
                           for s, t in zip(sess, tiles)]
                burst, _ = _burst(svc, sess, rhs)
        finally:
            service_mod.device_locks = real_locks
            admission_mod.plan_device_slots = real_slots
        out["served"][name] = {"pair_s": pair_s, "bitwise_solo": bitwise,
                               "burst": burst}
        del svc, sess
        gc.collect()

    solo_best = [min(r["wall_s"] for r in out["solo"] if r["tenant"] == i)
                 for i in range(2)]
    print(f"torch_serve_pair [{card}]: n={n} tb={tb}, {nops} ops")
    for r in out["solo"]:
        print(f"solo t{r['tenant']}: {r['wall_s']:.3f} s wall, cpu "
              f"{r['cpu_s']:.3f} s ({r['cpu_us_per_op']:.1f} us/op), "
              f"voluntary switches {r['nvcsw_per_op']:.3f}/op, "
              f"involuntary {r['nivcsw_per_op']:.3f}/op")
    for r in out["threads"]:
        print(f"two threads, no lock: {r['wall_s']:.3f} s (solo best sum "
              f"{sum(solo_best):.3f}); " + "; ".join(
                  f"t{i} wall {x['wall_s']:.3f} cpu {x['cpu_s']:.3f} s, "
                  f"vol {x['nvcsw_per_op']:.3f}/op, invol "
                  f"{x['nivcsw_per_op']:.3f}/op"
                  for i, x in enumerate(r["per_thread"])))
    for kind in ("gemm", "load", "trsm", "potrf"):
        solo = out["traced_solo"]["spans"].get(kind)
        pair = [s.get(kind) for s in out["traced_pair"]["spans"]]
        if solo and all(pair):
            print(f"traced {kind}: median span solo {solo['median_us']:.2f} "
                  f"us, pair " + ", ".join(f"{p['median_us']:.2f}"
                                           for p in pair) + " us")
    print(f"traced: solo {out['traced_solo']['wall_s']:.3f} s, pair "
          f"{out['traced_pair']['wall_s']:.3f} s")
    print(f"one 32-column solve alone: {out['solve_32_cols_s']:.3f} s; one "
          f"read of a plan's slot count off its schedule: "
          f"{out['slot_walk_s'] * 1e3:.2f} ms")
    for name, r in out["served"].items():
        b = r["burst"]
        print(f"served {name}: pair {r['pair_s']:.3f} s, bitwise "
              f"{r['bitwise_solo']}; burst {b['wall_s']:.3f} s, {b['items']} "
              f"items (max occupancy {b['max_occupancy']}), "
              f"{b['solves_per_s']:.2f} solves/s, p50 {b['p50_s']:.3f} s "
              f"p99 {b['p99_s']:.3f} s")
    dest = Path.cwd() / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_serve_pair.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
