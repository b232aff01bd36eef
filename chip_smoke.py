#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # the full run: n = 32768, tb = 512

Phases, in order; any failure raises and the script exits non-zero:

1. card: ``nvidia-smi`` name and power limit;
2. build: the seven sources from ``src/repro_torch/kernels/csrc`` (the six
   kernels; flash attention has two, tensor-core bf16 and FFMA f32), one
   ``nvcc`` per source, all at once;
3. kernel check: each per-op kernel against its plain PyTorch version on
   the card at the main path's tile size (f32) and at bf16 (fp8 operands
   for the GEMM), with the tolerances of ``tests/test_kernels.py``, and its
   time beside the plain version's, one PyTorch library call's and its
   bound (CUDA events around back-to-back calls, and the device time a
   call, from events around calls queued behind a spin kernel, which
   leaves out the device's waits on the host); the
   cluster split-K GEMM at every geometry tried, and at ragged M, N and K
   with every operand and output type, and the cluster split-K SYRK at
   ragged M and K, each entry at its own scale (the plain version without
   the last rank's K chunk must fail that check); the blocked POTRF and
   TRSM also at ragged sizes, each held to its residual at its own scale
   (POTRF's per 64-column block; a dropped block update must fail that
   check), and a pivot failing inside a block; then the fused column step
   against its plain version: every storage class in f32 and f64, the
   epilogue bitwise, its factor and solve phases alone (device time; a
   dropped block update must fail each), a pivot failing inside a block of
   the diagonal tile, f32 at the main path's mid-factorization shape (R = K
   = 32) and f64 at R = K = 8, timed beside its plain version, its bound and
   the four per-op kernels doing the same column step, with the grid and
   the blocks a SM;
4. main path: a seeded SPD matrix built on the card, planned with an
   ``eps_target`` precision plan and factored through ``plan(...).compile()``
   with the hand-written kernels (``use_pallas=True``) in f32; then solve,
   logdet, and the checks of the launch counts, the transfers and the
   accuracy against ``torch.linalg.cholesky`` in f64; ``volume()`` must
   equal the schedule's bytes and op counts, and
   ``simulate(HW["h100-pcie"])``'s makespan is logged beside the factor's
   seconds as a model reading of a PCIe datasheet preset, not a
   measurement.  The same matrix is then factored with
   ``fuse_columns=True``: one fused launch per column step and no per-op
   launch, under the same checks;
5. mixed precision: a Kac-Murdock-Szego matrix factored in f64 through the
   fused path on the ``gpu-scaled`` ladder (at least three classes, the
   scaled FP8 one among them), held against ``torch.linalg.cholesky`` and,
   tile by tile, against the unfused port; the same plan computed in f32
   must fail that tile check;
6. geospatial (``--geo-n``, 16384): the paper's workload, a Matérn
   covariance (nu = 0.5, weak correlation, Morton-ordered seeded
   locations) built on the card, planned on the ``gpu`` ladder at
   eps_target 1e-6 (unscaled ``f8e4m3`` tiles and at least three classes
   required), factored in f64 through the fused kernel (``nt`` launches,
   no per-op launch) and unfused, held tile by tile against each other (a
   plan with its least f32 tile stored as e4m3 must fail that check, and
   its own fused and unfused factors must pass it)
   and both against ``torch.linalg.cholesky``; the log-likelihood of four
   seeded observations through the fused solver against the f64 factor's
   (the control's solver must fail that check); the
   KL divergence at eps_target 1e-4, 1e-6 and 1e-8, whose order must be
   the reference's; the fused f64 step at R = K = nt / 2, timed;
7. multi-device: the executor over four logical devices, on four cards
   where the machine has them, else sharing this one card (it says which),
   each on a CUDA stream of its own.  Config A is phase 4's matrix and
   configuration on a 1D grid (4, 1), unfused then fused: launches by
   kernel (per-op: the schedule's counts; fused: at most one a segment's
   column and no more than the reference's grouping gives), the executed
   LOAD/STORE copies summed over the devices against the schedule, the
   BCAST/RECV counters through ``crosscheck_executed_volume``, accuracy,
   solve and logdet as phase 4.  Config B is phase 5's KMS matrix at
   n = 4096 (``MD_MXP_N``) on a (2, 2) grid with lookahead 1
   (``gpu-scaled`` wires, host-landing RECVs),
   unfused and fused, each against ``run_multidevice_numpy`` on the same
   schedule within the reference's 1e-8, the two against each other
   within the same, and against the f64 factor as phase 5; two controls
   swapped in here, every wire rounded through e4m3 and the f64 class's
   wires sent as f32, must fail the replay check.  Every factor runs
   twice, bitwise equal, under
   a watchdog that ends the process if one hangs;
8. measured trace: config A, the main path's configuration, factored once
   with an active ``TraceRecorder``: one span per op, none dropped, bitwise
   the untraced unfused factor of the same solver and within the f32
   factor's bound of the fused one; the fence floor (a synchronize of an
   idle stream, and the ALLOC/FREE spans) beside the per-kind sums; the
   drift report against ``simulate(HW["h100-pcie"])`` (a model reading);
   the chrome trace's events against the spans; a timeline with one op
   dropped, which the drift report must refuse.  Config B (phase 7's
   layout) traced once: one span per op of every stream, the same
   ``transfer_stats()``, within 1e-8 of the untraced factor (bitwise
   logged);
9. disk tier (``--spill-n``, 16384): the main path's configuration through
   a ``DiskTileStore`` in a temporary directory (f64) and
   ``SpillTorchExecutor``'s pinned host tier, whose size is chosen so that
   the schedule fetches at least twice the store; unfused and fused, each
   twice, bitwise run to run and bitwise its own fused groups run against
   an in-core store; unfused bitwise the in-core executor's factor, fused
   within the f32 factor's bound of it (its groups end at each FETCH/SPILL,
   as the reference's, where the in-core path launches one a column);
   executed FETCH/SPILL against the schedule, disk-tier and in-core
   seconds side by side; a run with one scheduled SPILL skipped must
   differ;
10. LM serving, qwen3-14b at published widths and depth (bf16 activations,
   f32 parameters from ``--seed``, the flash flag on): the flash kernels
   against their plain version at the prefill shape, dbrx-132b's and nine
   others, each
   output row at its own scale (a zeroed output and a dropped KV tile must
   fail that check), each bf16 case also by the share of outputs that
   differ (P rounded to bf16 must fail that check), timed at the two
   prefill shapes beside the FFMA kernel on the same bf16 inputs, the plain version,
   PyTorch's SDPA and the bound; a prefill step on 4 x 2048 tokens (40
   tensor-core flash launches, none on FFMA, logits finite, padding
   masked), the same step with the
   plain attention passed in, and the decode server on a 128-token prompt,
   whose replay logits are held against a flash prefill of the same
   prompt; both logit checks must reject two faults (the flash kernel
   without its causal mask, the attention output dropped); decode tokens/s
   is the median of six windows;
10b. MoE and MLA serving: deepseek-v2-lite-16b at published widths and
   depth (15,706,484,224 f32 parameters from ``--seed``, the reference's
   count; MLA, a dense first layer, 2 shared and 64 routed experts top-6):
   a 4 x 2048 prefill twice, timed, launching none of the port's kernels,
   the share of the first MoE layer's assignments that capacity 1.25 drops
   (counted here from its router, against the dispatch's own count); on a
   128-token prompt the logits at capacity 1.25 beside the dropless ones,
   its first MoE layer in f32 on those 512 tokens against the per-token
   plain mix (twice, bitwise; a capacity that drops must fail), and the
   dropless prefill against its decode replay in f32 activations with three
   controls that must fail (the routed experts' output zeroed, MLA's rope
   term dropped, MLA's causal mask dropped, each a port function swapped
   here for its run), and in bf16, logged; decode tokens/s over six
   windows, peak memory.  Then dbrx-132b at
   published widths cut to 2 of its 40 layers (31.0 GB of f32 weights; 40
   would be 526 GB): the same, with 2 tensor-core flash launches a prefill
   step, the flash prefill against the plain attention's (two faults must
   fail), and the replay in bf16 with the controls the routed experts
   zeroed and the flash kernel without its causal mask; the phase's
   seconds;
10c. SSM and hybrid serving, each model with seeded f32 parameters whose
   count must be the reference's, a timed 4 x 2048 prefill (no kernel of
   the port launched) with its peak memory, the logits at every position
   of a 512-token prompt's prefill (two SSD chunks) against its decode
   replay in f32 activations under a bound (the bf16 replay logged: it
   parts too far, see the replay bounds), controls that must fail it,
   greedy tokens through ``decode_tokens`` and six decode windows:
   mamba2-130m whole
   (129,690,048 parameters; controls: the inter-chunk term zeroed,
   ``d_skip`` dropped, the decode conv window left unshifted), then
   jamba-1.5-large-398b at published widths cut to 2 of 72 layers (SSM
   with the dense MLP, SSM with the 16-expert top-2 MoE; 12,155,465,728
   parameters, 48.6 GB; 8 layers, the least that reach its attention
   layer, would hold 180.6 GB), its replay dropless (control: the routed
   experts zeroed); the phase's seconds;
10d. encoder-decoder and frontend serving, with the flash flag on: the
   same steps, where the prefill is also held against the plain attention
   with the flash faults, the replay in bf16 on 128-token prompts:
   seamless-m4t-large-v2
   whole (24 encoder and 24 decoder layers; 2,038,556,672 parameters) with
   4 x 1024 seeded encoder frames, a 4 x 1024 prefill with 24 tensor-core
   flash launches (the encoder and cross-attention take the chunked
   path), decode cross-attending to ``enc_out`` (controls: the
   cross-attention dropped at decode, the encoder's attention made
   causal); llava-next-34b at published widths cut to 16 of 60 layers
   (9,865,239,552 parameters, 39.5 GB; 60 hold 137.6 GB) with 576 seeded
   frontend embeddings over a 4 x 2048 prefill, 16 tensor-core flash
   launches at 56/8 heads (controls: the frontend embeddings ignored,
   the flash kernel without its causal mask); the phase's seconds;
   phases 10-10d run under ``torch.no_grad()``: serving keeps no graph;
10e. training on the card (``repro_torch.launch.steps.make_train_step``:
   the loss, autograd, AdamW; f32 weights from ``--seed``, bf16
   activations, ``DataPipeline`` batches of 2048-token rows, remat over
   each scanned group), each step's loss and grad_norm finite and
   grad_norm above 0, no kernel of the port launched, the first batch's
   loss after the steps below its first reading, step seconds, tokens/s,
   the model-flops share 6 N tokens / (s x 989 TFLOP/s) as a reading and
   the peak memory beside its reckoning: gemma3-1b whole (999,826,048
   parameters, the reference's count; 8 x 2048 tokens a step as 2
   microbatches of 4 x 2048) for 6 steps with f32 moments, then 6 with Q8
   moments from the same start; with its flash flag on, its loss under
   grad must raise ``NotImplementedError`` and its prefill under no_grad
   launch the tensor-core kernel once a global layer; mamba2-130m whole,
   4 x 2048, 6 steps (the SSD scan under autograd); deepseek-v2-lite-16b
   cut to 2 of 27 layers (MLA, then 2 shared and 64 routed experts top-6;
   1,085,287,424 parameters), 4 x 2048, 3 steps.  Then the card's step
   against the port's CPU step on the same weights and a 1 x 512 batch in
   f32 with TF32 off (gemma3 at one scan group of 6 layers, mamba2 whole,
   deepseek's 2 layers): loss and grad_norm, every gradient and
   moment at its own scale, the parameters after the step, each within its
   bound, and the mixer-input gradients zeroed (the shape of a kernel that
   cuts its gradient) must fail the gradient bound; mamba2 trained through
   ``launch.train.train`` to step 6 straight and with a checkpoint at step
   3 resumed in a fresh trainer: the parameters bitwise, or within the
   spread of two straight runs (it says which); the phase's seconds;
11. tuner and service: ``repro_torch.tune.calibrate`` on the card at the
   main path's tile size in f32 (every one of the five Cholesky kernels
   launched; ``mem_bytes`` the card's total memory; each per-class rate
   logged, the f32 GEMM's beside phase 3's device time); ``tune`` at n
   against that measured model for the main path's configuration with
   ``tb=0, policy="auto"`` and the matrix as the precision sample (search
   seconds and the top candidates' simulated makespans logged as model
   readings; no candidate past TRSM's, POTRF's or the fused step's tile
   limit); the winner's per-op kernels against their plain versions at its
   tile size (phase 3's f32 tolerances), then its factor through
   ``plan(...).compile()`` under phase 4's checks; a model refitted from
   phase 8's trace (``calibrate(refine_from=)``), the trace's drift against
   it, the measured model and the ``h100-pcie`` preset (logged); then a
   ``SolverService`` with two workers on the measured model, two tenants on
   the main path's configuration, each with its own seeded matrix, factored
   at once: each factor and logdet bitwise its solo one, launches exactly
   the two schedules', both admitted on the card's memory; a burst of 64
   single-RHS solves a tenant (window 5 ms, ``max_batch`` 32) coalesced to
   an occupancy of at least 2, each within 1e-10 relative of the solo
   solve; and the plan under the model with one byte less than its
   ``plan_device_bytes`` refused with ``AdmissionError``, no kernel
   launched;
12. the baseline, the shim and the examples: ``core.distributed.
   distributed_cholesky`` (f64, no hand-written kernel) on phase 4's matrix
   over phase 7's four logical devices, within 1e-10 of max|A| of the f64
   factor on the card, twice bitwise under phase 7's watchdog, its bytes
   sent equal to ``panel_broadcast_bytes`` and to the static schedule's
   ``bcast_bytes()``, its seconds and peak device memory logged beside
   config A's, and a broadcast of zeros swapped in that must fail the
   1e-10 check; the deprecated ``ooc_cholesky`` on the main path's
   configuration at ``--mxp-n``: its ``DeprecationWarning``, bitwise the
   ``plan(...).compile()`` factor with the schedule's launches, and the
   ``RuntimeError`` of ``ndev=2`` on ``"cuda"`` with one card (logged as
   skipped on two or more); then every ``examples/torch_*.py`` at its
   defaults on the card, all at once, each of which must exit 0 (their
   output in ``chiprun_out/examples/``);
13. the kernels line (JSON; each kernel also with its launches in config
   A, in the disk tier, in calibration, in the tuned factor, in the
   served pair, through the shim and in phase 10e's training steps, all
   0 there; flash attention also with dbrx's, seamless's and llava's
   prefill's), each phase's seconds, the script's
   wall time, and the last line,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.  It writes the results to
``chiprun_out/chip_smoke.json`` as well.  ``--n``, ``--mxp-n``, ``--geo-n``,
``--spill-n`` and ``--tb`` cut the Cholesky sizes for a quick run; the
models run at full width, and at full depth but for dbrx's, jamba's,
llava's and the trained deepseek's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit:
# f32 outside the tensor cores (the kernels keep f32's 2^-24, so no TF32),
# f64 on the FP64 tensor cores (DMMA, IEEE f64; 34 TFLOP/s outside them),
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12     # dense, on the tensor cores
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
    "fused_column_step": ("src/repro_torch/kernels/csrc/fused_column.cu",
                          "src/repro/kernels/fused_column.py:173"),
    # bf16 (the model's) on the tensor cores; f32 stays on FFMA
    # (csrc/flash_attention.cu), which the kernel checks also run
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_wgmma.cu",
                        "src/repro/kernels/flash_attention.py:26"),
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


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call in ms: CUDA events around ``reps`` calls
    that the host queued behind a spin kernel, so that the device runs them
    back to back (``repro_torch.tune.calibrate.call_seconds``, which
    calibration times with too). Unlike :func:`time_ms` it leaves out the
    gaps where the device waits on the host's launches, which a call of
    tens of microseconds can have. It raises when the host could not queue
    the calls before the device reached them; it never reads 0."""
    from repro_torch.tune.calibrate import call_seconds
    dev = torch.device("cuda", torch.cuda.current_device())
    return call_seconds(fn, reps, dev) * 1e3


def _spd(n, g, dev, dtype=torch.float32):
    x = torch.randn(n, n, generator=g, device=dev) / math.sqrt(n)
    return (x @ x.T + 2.0 * torch.eye(n, device=dev)).to(dtype)


def kernel_checks(tb: int, dev, g, dtypes=(torch.float32, torch.bfloat16,
                                            torch.float8_e4m3fn),
                  timed: bool = True) -> dict:
    """Each kernel against its plain version at tile size ``tb``; f32 is
    the main path's dtype and the one timed (``timed``)."""
    from repro_torch.kernels import mxp_gemm, potrf, ref, syrk, trsm
    tol = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
    results = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # library calls in f32
    try:
        for dt in dtypes:
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
                        lambda: torch.linalg.cholesky_ex(c),
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
                if name == "mxp_gemm_update":
                    row["geometry"] = mxp_gemm.geometry(tb, tb, tb)
                if name == "syrk_update":
                    split, chunk = syrk.split_for(tb)
                    ratio, ctrl = syrk_ratio(got, c, a), syrk_ratio(
                        syrk_dropped_chunk(c, a), c, a)
                    row.update({"split": split, "chunk": chunk,
                                "entry_ratio": ratio,
                                "control_dropped_chunk_ratio": ctrl})
                    require(ratio <= 1.0 and (
                        ctrl > 1.0 or not syrk_control_resolvable(c, a)),
                            f"{tag}: entry ratio {ratio}, dropped-chunk "
                            f"control {ctrl} (must exceed 1)")
                if timed and dt == torch.float32:   # the main path's
                    reps = 50
                    bound_f = flops / PEAK_F32_FLOPS * 1e3
                    bound_b = nbytes / PEAK_HBM_BYTES * 1e3
                    row.update({
                        "ms": time_ms(lambda: kern(*args), reps),
                        "plain_ms": time_ms(lambda: plain(*args), reps),
                        "library_ms": time_ms(library, reps),
                        "device_ms": device_ms(lambda: kern(*args)),
                        "library_device_ms": device_ms(library),
                        "bound_ms": max(bound_f, bound_b),
                        "bound_by": ("operations" if bound_f >= bound_b
                                     else "bytes"),
                        "flops": flops, "bytes": nbytes})
                    if name == "potrf":
                        # cholesky checks its info on the host after each
                        # call (a sync); cholesky_ex does not. The faster
                        # of the two is the yardstick
                        row["library_cholesky_ms"] = time_ms(
                            lambda: torch.linalg.cholesky(c), reps)
                        row["library_cholesky_ex_ms"] = row["library_ms"]
                        row["library"] = "torch.linalg.cholesky_ex"
                        if row["library_cholesky_ms"] < row["library_ms"]:
                            row["library_ms"] = row["library_cholesky_ms"]
                            row["library"] = "torch.linalg.cholesky"
                results[tag] = row
                log(f"kernel {tag}: " + json.dumps(row))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return results


# The GEMM is held entry by entry at each entry's own scale W = |C| + |A|
# |B|^T, over ragged M, N, K (SYRK_SIZES) with A and B in f32, bf16 and fp8
# (exact in f32, as are their products) and C in f32 and bf16. Two f32
# sums of K products in different orders differ by at most 2 (K + 2) 2^-24
# W; a bf16 output is then rounded by the kernel and by the plain version,
# each by at most half an ulp, 2^-8 of the value, so they may differ by a
# whole ulp, 2^-7 W, where the two sums straddle a rounding boundary
# (seen at K = 1, where C is most of W). The control is the plain version
# without the last rank's K chunk of the cluster split; it must fail
# wherever that chunk moves some entry by more than 4 allowances.
GEMM_AB = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)


def _gemm_tol(dtype, k: int) -> float:
    return (2.0 ** -7 if dtype == torch.bfloat16 else 0.0) + \
        2 * (k + 2) * 2.0 ** -24


def gemm_ratio(got, c, a, b) -> float:
    """max over entries of |got - plain| / (allowance x W)."""
    from repro_torch.kernels import ref
    want = ref.gemm_update_ref(c, a, b)
    w = c.double().abs() + a.double().abs() @ b.double().abs().T
    tol = _gemm_tol(got.dtype, a.shape[1])
    return float(((got.double() - want.double()).abs() / (tol * w)
                  .clamp_min(1e-300)).max())


def _gemm_last_chunk(m: int, n: int, k: int) -> int:
    from repro_torch.kernels import mxp_gemm
    split, chunk = mxp_gemm.split_for(m, n, k)
    return mxp_gemm.chunk_bounds(k, split, chunk)[-1][0]


def gemm_dropped_chunk(c, a, b):
    """The plain version without the last rank's K chunk."""
    from repro_torch.kernels import ref
    lo = _gemm_last_chunk(a.shape[0], b.shape[0], a.shape[1])
    return ref.gemm_update_ref(c, a[:, :lo].contiguous(),
                               b[:, :lo].contiguous())


def gemm_control_resolvable(c, a, b) -> bool:
    """Whether the last chunk moves some entry by more than 4 allowances of
    its W."""
    lo = _gemm_last_chunk(a.shape[0], b.shape[0], a.shape[1])
    ad, bd = a.double(), b.double()
    moved = (ad[:, lo:] @ bd[:, lo:].T).abs()
    w = c.double().abs() + ad.abs() @ bd.abs().T
    tol = _gemm_tol(c.dtype, a.shape[1])
    return bool((moved / w.clamp_min(1e-300) > 4 * tol).any())


def gemm_checks(dev, seed: int) -> dict:
    """The GEMM at ragged M, N and K, every operand and output type,
    against its plain version: the old tolerance, each entry at its own
    scale, the dropped-chunk control.  Inputs from numpy."""
    import numpy as np

    from repro_torch.kernels import mxp_gemm, ref
    tol = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
    results = {}
    for ab in GEMM_AB:
        for cdt in (torch.float32, torch.bfloat16):
            for m in SYRK_SIZES:
                for n in SYRK_SIZES:
                    for k in SYRK_SIZES:
                        rng = np.random.default_rng([seed, m, n, k])
                        c = torch.from_numpy(rng.standard_normal((m, n))).to(
                            dev, cdt)
                        a = torch.from_numpy(rng.standard_normal((m, k))).to(
                            dev, ab)
                        b = torch.from_numpy(rng.standard_normal((n, k))).to(
                            dev, ab)
                        got = mxp_gemm.mxp_gemm_update(c, a, b)
                        want = ref.gemm_update_ref(c, a, b)
                        torch.cuda.synchronize()
                        tag = (f"mxp_gemm_update[{str(ab)[6:]},{str(cdt)[6:]},"
                               f"m={m},n={n},k={k}]")
                        t = tol[cdt]
                        torch.testing.assert_close(
                            got.double(), want.double(),
                            atol=max(m, n, k) * t / 16, rtol=t,
                            msg=lambda msg, tag=tag: f"{tag}: {msg}")
                        ratio = gemm_ratio(got, c, a, b)
                        ctrl = gemm_ratio(gemm_dropped_chunk(c, a, b), c, a, b)
                        held = gemm_control_resolvable(c, a, b)
                        require(ratio <= 1.0, f"{tag}: entry ratio {ratio}")
                        require(not held or ctrl > 1.0, f"{tag}: the dropped-"
                                f"chunk control passes ({ctrl})")
                        results[tag] = {
                            "split": mxp_gemm.split_for(m, n, k)[0],
                            "entry_ratio": ratio,
                            "control_dropped_chunk_ratio": ctrl,
                            "control_held": held}
    worst = max(r["entry_ratio"] for r in results.values())
    least = min(r["control_dropped_chunk_ratio"] for r in results.values()
                if r["control_held"])
    unheld = sum(not r["control_held"] for r in results.values())
    log(f"gemm at M, N, K in {SYRK_SIZES}, A/B in f32, bf16, fp8 and C in "
        f"f32, bf16 ({len(results)} cases): worst entry ratio {worst:.3e} "
        f"(bound 1), least dropped-chunk control {least:.3e} (must exceed "
        f"1), {unheld} cases whose chunk the output's rounding hides")
    return results


# SYRK is also held entry by entry at each entry's own scale, W = |C| +
# |A| |A|^T: two f32 sums of K products in different orders differ by at
# most 2 (K + 2) 2^-24 W, and a bf16 output's rounding adds 2^-8 W (half
# an ulp each side). The bound holds for any correct order, so the card's
# readings need no margin. The control is the plain version without the
# K columns of the last CTA of the cluster split (all of K when split is
# 1): a kernel that drops one rank's partial sum computes it, and its
# diagonal moves by that chunk's share of W. It must fail wherever that
# share exceeds 4 allowances on some diagonal entry: always in f32 here; a
# bf16 output's rounding can hide a small chunk (M = K = 1).
SYRK_SIZES = (1, 31, 33, 100, 257, 513)


def _syrk_tol(dtype, k: int) -> float:
    return (2.0 ** -8 if dtype == torch.bfloat16 else 0.0) + \
        2 * (k + 2) * 2.0 ** -24


def syrk_ratio(got, c, a) -> float:
    """max over entries of |got - plain| / (allowance x W)."""
    from repro_torch.kernels import ref
    want = ref.syrk_update_ref(c, a)
    ad = a.double()
    w = c.double().abs() + ad.abs() @ ad.abs().T
    tol = _syrk_tol(got.dtype, a.shape[1])
    return float(((got.double() - want.double()).abs() / (tol * w)
                  .clamp_min(1e-300)).max())


def _last_chunk(k: int) -> int:
    from repro_torch.kernels import syrk
    split, chunk = syrk.split_for(k)
    return syrk.chunk_bounds(k, split, chunk)[-1][0]


def syrk_dropped_chunk(c, a):
    """The plain version without the last rank's K chunk."""
    from repro_torch.kernels import ref
    return ref.syrk_update_ref(c, a[:, :_last_chunk(a.shape[1])].contiguous())


def syrk_control_resolvable(c, a) -> bool:
    """Whether the last chunk moves some diagonal entry by more than 4
    allowances of its W."""
    ad = a.double()
    moved = (ad[:, _last_chunk(a.shape[1]):] ** 2).sum(dim=1)
    w = c.double().diagonal().abs() + (ad ** 2).sum(dim=1)
    tol = _syrk_tol(c.dtype, a.shape[1])
    return bool((moved / w.clamp_min(1e-300) > 4 * tol).any())


def syrk_checks(dev, seed: int) -> dict:
    """SYRK at ragged M and K, both types, against its plain version: the
    old tolerance, each entry at its own scale, the dropped-chunk control.
    Inputs from numpy, so the CPU tests can hold the same data."""
    import numpy as np

    from repro_torch.kernels import ref, syrk
    tol = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        for m in SYRK_SIZES:
            for k in SYRK_SIZES:
                rng = np.random.default_rng([seed, m, k])
                x = rng.standard_normal((m, m)) / math.sqrt(m)
                c = torch.from_numpy(x @ x.T + 2.0 * np.eye(m)).to(dev, dt)
                a = torch.from_numpy(rng.standard_normal((m, k))).to(dev, dt)
                got = syrk.syrk_update(c, a)
                want = ref.syrk_update_ref(c, a)
                torch.cuda.synchronize()
                tag = f"syrk_update[{str(dt)[6:]},m={m},k={k}]"
                t = tol[dt]
                torch.testing.assert_close(
                    got.double(), want.double(), atol=max(m, k) * t / 16,
                    rtol=t, msg=lambda msg, tag=tag: f"{tag}: {msg}")
                ratio = syrk_ratio(got, c, a)
                ctrl = syrk_ratio(syrk_dropped_chunk(c, a), c, a)
                held = syrk_control_resolvable(c, a)
                require(ratio <= 1.0, f"{tag}: entry ratio {ratio}")
                require(not held or ctrl > 1.0, f"{tag}: the dropped-chunk "
                        f"control passes ({ctrl})")
                results[tag] = {"split": syrk.split_for(k)[0],
                                "entry_ratio": ratio,
                                "control_dropped_chunk_ratio": ctrl,
                                "control_held": held}
    worst = max(r["entry_ratio"] for r in results.values())
    least = min(r["control_dropped_chunk_ratio"] for r in results.values()
                if r["control_held"])
    log(f"syrk at M, K in {SYRK_SIZES}, f32 and bf16: worst entry ratio "
        f"{worst:.3e} (bound 1), least dropped-chunk control {least:.3e} "
        f"(must exceed 1)")
    return results


# The blocked POTRF and TRSM are also held to their residuals, each at its
# own scale, in units of the output type's roundoff (EPS_OUT): TRSM's max
# over rows of |X L^T - C|_row / (max|X_row| max|L| n); POTRF's per 64-column
# block J, max over the block's columns of |L L^T - sym(A)| / (max|A|
# min(n, (J + 1) 64)): an entry of column j sums j + 1 products, so the
# bound does not grow with n (scaled by n, one dropped 64 x 64 update read
# 1.37 units at n = 6144, inside the bound). A backward-stable factor or
# solve reaches at most about (n + 1) units there (POTRF: j + 1). The card's
# readings over seeds 0-2 (benchmarks/torch_tile_bounds.py, NVIDIA H100
# 80GB HBM3, 700 W) are at most 1.48 units (POTRF at n = 1, where sqrt, the
# division and the square each round once; 0.41 for TRSM at n = 1; at most
# 0.17 past n = 1 with POTRF's residual scaled by n), and the bound is a
# little over three times that. For f32 outputs past one 64-wide block, two
# controls must fail the same check: the plain solve against an L whose
# block (J, J - 1) is zeroed (1,438 units or more), and the blocked factor
# with one trailing update left out. A bf16 output's own rounding is larger
# than what one dropped block moves, so the controls are f32's.
BACKWARD_C = 5
EPS_OUT = {torch.float64: 2.0 ** -53, torch.float32: 2.0 ** -24,
           torch.bfloat16: 2.0 ** -8}
BLOCK = 64          # the kernels' block edge (repro_torch.kernels.potrf.NB)
RAGGED = (1, 31, 33, 100, 257, 513, 1000)
NAN_PIVOT = 100     # the failing pivot of the NaN check, inside a block


def trsm_backward(x, l, c) -> float:
    xd, ld, cd = x.double(), l.double(), c.double()
    res = (xd @ ld.T - cd).abs().amax(dim=1)
    scale = xd.abs().amax(dim=1).clamp_min(1e-300) * ld.abs().max() * ld.shape[0]
    return float((res / scale).max()) / EPS_OUT[x.dtype]


def potrf_backward(lf, a, nb=BLOCK) -> float:
    """max over 64-column blocks J of max|(L L^T - sym(A))[:, J]| / (max|A|
    min(n, (J + 1) nb)), in units of L's roundoff."""
    ld, ad = lf.double(), a.double()
    n = ad.shape[0]
    res = (ld @ ld.T - 0.5 * (ad + ad.T)).abs().amax(dim=0)
    terms = (torch.arange(n, device=ad.device) // nb + 1) * nb
    scale = ad.abs().max() * terms.clamp(max=n)
    return float((res / scale).max()) / EPS_OUT[lf.dtype]


def potrf_dropped_update(a, nb=BLOCK):
    """The blocked right-looking factor in f64 with the update of tile
    (last, 1) left out at the first step ((1, 1) for two block columns)."""
    w = 0.5 * (a.double() + a.double().T)
    n = w.shape[0]
    nt = -(-n // nb)
    for kt in range(nt):
        k0, k1 = kt * nb, min(n, (kt + 1) * nb)
        w[k0:k1, k0:k1] = torch.linalg.cholesky(w[k0:k1, k0:k1])
        if k1 == n:
            break
        w[k1:, k0:k1] = torch.linalg.solve_triangular(
            w[k0:k1, k0:k1].T, w[k1:, k0:k1], upper=True, left=False)
        for i in range(kt + 1, nt):
            for j in range(kt + 1, i + 1):
                if kt == 0 and (i, j) == (nt - 1, 1):
                    continue
                i0, i1 = i * nb, min(n, (i + 1) * nb)
                j0, j1 = j * nb, min(n, (j + 1) * nb)
                w[i0:i1, j0:j1] -= w[i0:i1, k0:k1] @ w[j0:j1, k0:k1].T
    return torch.tril(w).to(a.dtype)


def trsm_dropped_block(l, c, nb=BLOCK):
    """X solved against L with its block (J, J - 1) zeroed, J the last."""
    lz = l.double().clone()
    j0 = (l.shape[0] - 1) // nb * nb
    lz[j0:, j0 - nb:j0] = 0.0
    return torch.linalg.solve_triangular(lz.T, c.double(), upper=True,
                                         left=False).to(c.dtype)


def blocked_checks(tb: int, dev, g) -> dict:
    """POTRF and TRSM at the ragged sizes and at ``tb``, both types: the
    old tolerances against the plain version, each residual at its own
    scale, the controls; then a pivot failing inside a block."""
    from repro_torch.kernels import potrf, ref, trsm
    tol = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        for n in RAGGED + (tb,):
            a = _spd(n, g, dev, dt)
            l = torch.linalg.cholesky(a.double()).to(dt).contiguous()
            c = torch.randn(n, n, generator=g, device=dev).to(dt)
            for name, kern, plain, args, resid, control, t in (
                    ("potrf", potrf.potrf, ref.potrf_ref, (a,),
                     potrf_backward, potrf_dropped_update, tol[dt]),
                    ("trsm", trsm.trsm, ref.trsm_ref, (l, c), trsm_backward,
                     trsm_dropped_block, 20 * tol[dt])):
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                tag = f"{name}[{str(dt)[6:]},n={n}]"
                torch.testing.assert_close(
                    got.double(), want.double(), atol=t, rtol=t,
                    msg=lambda m, tag=tag: f"{tag}: {m}")
                ratio = resid(got, *args)
                ctrl = (resid(control(*args), *args)
                        if n > BLOCK and dt == torch.float32 else None)
                row = {"max_abs_err": float((got.double() - want.double())
                                            .abs().max()),
                       "residual_units": ratio, "control_units": ctrl}
                log(f"blocked {tag}: " + json.dumps(row))
                require(ratio <= BACKWARD_C,
                        f"{tag}: residual {ratio} units > {BACKWARD_C}")
                require(ctrl is None or not ctrl <= BACKWARD_C,
                        f"{tag}: the dropped-block control passes ({ctrl})")
                results[tag] = row
    # a pivot failing inside a block: columns < j are the factor of the
    # leading j x j part, every lower entry of columns >= j is NaN
    j, n = NAN_PIVOT, 2 * tb if tb > NAN_PIVOT else 2 * NAN_PIVOT
    a = _spd(n, g, dev, torch.float64)
    a[j, j] = -5.0
    got = potrf.potrf(a.float()).double()
    lead = torch.linalg.cholesky(a[:j, :j])
    below = torch.linalg.solve_triangular(lead.T, a[j:, :j], upper=True,
                                          left=False)
    err = float((got[:, :j] - torch.cat([lead, below])).abs().max())
    lower = torch.tril(torch.ones(n - j, n - j, dtype=torch.bool, device=dev))
    all_nan = bool(torch.isnan(got[j:, j:][lower]).all())
    log(f"blocked potrf, pivot {j} of {n} below zero: columns < {j} within "
        f"{err:.3e} of the leading factor; every lower entry of columns >= "
        f"{j} NaN: {all_nan}")
    require(err <= tol[torch.float32] and all_nan,
            f"potrf NaN pivot: err {err}, all NaN {all_nan}")
    results["potrf[nan pivot]"] = {"pivot": j, "n": n, "max_abs_err": err,
                                   "lower_nan": all_nan}
    return results


# storage classes of the fused epilogue, and their unit roundoff
# (repro_torch.core.precision.EPS)
LADDER = ("f64", "f32", "f16", "bf16", "f8e4m3", "f8e4m3s")
EPS = {"f64": 2.0 ** -53, "f32": 2.0 ** -24, "f16": 2.0 ** -11,
       "bf16": 2.0 ** -8, "f8e4m3": 2.0 ** -4, "f8e4m3s": 2.0 ** -4}
# f32 rounding flips a later tile of the mixed-precision run may inherit
FLIPS = 4


def _column(r_tiles, k_hist, tb, with_diag, dt, dev, g):
    """Column-step operands shaped like the executor's group: the diagonal
    SPD (2 tb I + G G^T / tb), history entries N(0, 1/tb), so that the
    wave moves every entry by O(sqrt(K / tb))."""
    spd = _spd(tb, g, dev, torch.float64) * tb
    c = torch.randn(r_tiles, tb, tb, generator=g, device=dev,
                    dtype=torch.float64)
    if with_diag:
        c[0] = spd
    hist = torch.randn(r_tiles, k_hist, tb, tb, generator=g, device=dev,
                       dtype=torch.float64) / math.sqrt(tb)
    bhist = hist[0].clone() if with_diag else torch.randn(
        k_hist, tb, tb, generator=g, device=dev,
        dtype=torch.float64) / math.sqrt(tb)
    l_kk = torch.linalg.cholesky(spd)
    return [x.to(dt).contiguous() for x in (c, hist, bhist, l_kk)]


def _fused_tol(cls, tb, dt):
    """One accumulation-order ulp may move a value across a class quantum
    (tests/test_kernel_numerics.py::_tol): 4 EPS[class] of a row's scale;
    in f32 the factor and the solve carry a few tb 2^-24 too."""
    work = 1e-12 if dt == torch.float64 else 4 * tb * 2.0 ** -24
    return max(work, 4 * EPS[cls])


def _row_ratio(got, want, tol):
    """The worst row's max|got - want| over ``tol`` times that row's own
    max|want|: each row is held at its own scale."""
    err = (got.double() - want.double()).abs().amax(dim=(1, 2))
    scale = want.double().abs().amax(dim=(1, 2)).clamp_min(1e-300)
    return float((err / (tol * scale)).max())


def _fused_cost(r_tiles, k_hist, tb, with_diag, itemsize, peak):
    """The least time for one step: flops of the wave (the diagonal row's
    only its lower triangle, a SYRK), the row solves and the factor; bytes
    of each input read once and the output written once."""
    flops = ((2.0 * r_tiles - with_diag) * k_hist * tb ** 3
             + (r_tiles - with_diag) * tb ** 3 + with_diag * tb ** 3 / 3.0)
    tiles = 2 * r_tiles + r_tiles * k_hist + k_hist + (not with_diag)
    nbytes = tiles * tb * tb * itemsize
    bound_f = flops / peak * 1e3
    bound_b = nbytes / PEAK_HBM_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes"}


def fused_nan_pivot(n: int, dt, dev, g) -> dict:
    """The fused step (R = 2, K = 0, no rounding) on a diagonal tile whose
    leading minor first fails at NAN_PIVOT, inside the second 64-wide
    block, and a second row solved against that factor."""
    from repro_torch.kernels import fused_column as fc
    j = NAN_PIVOT
    spd = _spd(n, g, dev, torch.float64)
    spd[j, j] = -5.0
    c = torch.stack([spd, torch.randn(n, n, generator=g, device=dev,
                                      dtype=torch.float64)]).to(dt)
    got = fc.fused_column_step(
        c, c.new_empty((2, 0, n, n)), c.new_empty((0, n, n)), c[0], [-1, -1],
        ladder=LADDER, with_diag=True).double()
    cd = c.double()
    lead = torch.linalg.cholesky(cd[0, :j, :j])
    below = torch.linalg.solve_triangular(lead.T, cd[0, j:, :j], upper=True,
                                          left=False)
    lower = torch.tril(torch.ones(n - j, n - j, dtype=torch.bool, device=dev))
    return {"pivot": j, "tb": n, "dtype": str(dt)[6:],
            "leading_err": float((got[0, :, :j] - torch.cat([lead, below]))
                                 .abs().max()),
            "lower_nan": bool(torch.isnan(got[0, j:, j:][lower]).all()),
            "row_left_finite": bool(torch.isfinite(got[1, :, :j]).all()),
            "row_right_nan": bool(torch.isnan(got[1, :, j:]).all())}


def fused_checks(tb: int, dev, g) -> dict:
    """The fused column step against its plain version: every class in f32
    and f64, the epilogue bitwise, and the main path's shapes, timed."""
    from repro_torch.kernels import fused_column as fc
    from repro_torch.kernels import mxp_gemm, potrf, syrk, trsm
    results = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # plain version in f32
    try:
        # every class through the epilogue, both variants, both types
        for dt in (torch.float32, torch.float64):
            for with_diag in (True, False):
                args = _column(4, 2, tb, with_diag, dt, dev, g)
                for cls in LADDER:
                    ids = [LADDER.index(cls)] * 4
                    kw = dict(ladder=LADDER, with_diag=with_diag)
                    got = fc.fused_column_step(*args, ids, **kw)
                    want = fc.fused_column_step_ref(*args, ids, **kw)
                    torch.cuda.synchronize()
                    err = float((got.double() - want.double()).abs().max())
                    tol = _fused_tol(cls, tb, dt)
                    ratio = _row_ratio(got, want, tol)
                    tag = (f"fused_column_step[{str(dt)[6:]},{cls},"
                           f"diag={int(with_diag)}]")
                    log(f"kernel {tag}: max_abs_err {err:.3e}, worst row's "
                        f"error / ({tol:.1e} max|row|) {ratio:.3e}")
                    require(ratio <= 1.0, f"{tag}: row error ratio {ratio}")
                    results[tag] = {"max_abs_err": err, "tol_per_row": tol,
                                    "row_ratio": ratio}
            # the epilogue bitwise: K = 0, no diagonal, l_kk = I, so the
            # solve returns C exactly and the output is the class round
            ids = list(range(-1, len(LADDER)))
            mag = 10.0 ** (torch.rand(len(ids), tb, tb, generator=g,
                                      device=dev, dtype=torch.float64)
                           * 18 - 12)
            sign = torch.randint(0, 2, mag.shape, generator=g, device=dev)
            c = (mag * (2 * sign - 1)).to(dt)
            c.view(len(ids), -1)[:, :6] = torch.tensor(
                [448.0, 455.0, 464.0, 470.0, 1.0 + 2.0 ** -11, -0.0],
                dtype=dt, device=dev)
            got = fc.fused_column_step(
                c, c.new_empty((len(ids), 0, tb, tb)), c.new_empty((0, tb, tb)),
                torch.eye(tb, dtype=dt, device=dev), ids, ladder=LADDER,
                with_diag=False)
            torch.cuda.synchronize()
            bits = torch.int32 if dt == torch.float32 else torch.int64
            for r, cls_id in enumerate(ids):
                want = fc._epilogue(c[r], cls_id, LADDER)
                nan = torch.isnan(want)
                same = (torch.equal(torch.isnan(got[r]), nan) and torch.equal(
                    got[r][~nan].view(bits), want[~nan].view(bits)))
                name = "none" if cls_id < 0 else LADDER[cls_id]
                require(same, f"fused epilogue {dt} {name} is not bitwise "
                        f"the plain class round")
            log(f"kernel fused_column_step epilogue [{str(dt)[6:]}]: bitwise "
                f"equal to the class round for none + {len(LADDER)} classes")

        # two phases alone, at the main path's tile: the in-launch factor
        # (R = 1, K = 0) and one tile's row solves (R = 1, K = 0, l_kk),
        # each with a control that leaves one block update out and must
        # fail the row check; the factor is also held to POTRF's residual
        # per 64-column block (f32: f64 factors are held at 1e-12 a row)
        for dt in (torch.float32, torch.float64):
            for with_diag in (True, False):
                args = _column(1, 0, tb, with_diag, dt, dev, g)
                kw = dict(ladder=LADDER, with_diag=with_diag)
                got = fc.fused_column_step(*args, [-1], **kw)
                want = fc.fused_column_step_ref(*args, [-1], **kw)
                torch.cuda.synchronize()
                tol = _fused_tol("f64" if dt == torch.float64 else "f32",
                                 tb, dt)
                c0 = args[0][0]
                if with_diag:
                    ctrl = potrf_dropped_update(c0)[None]
                else:
                    ctrl = trsm_dropped_block(args[3], c0)[None]
                ratio = _row_ratio(got, want, tol)
                ctrl_ratio = _row_ratio(ctrl, want, tol)
                phase = "factor" if with_diag else "solve"
                tag = f"fused_column_step[{str(dt)[6:]},{phase} phase]"
                row = {"row_ratio": ratio, "tol_per_row": tol,
                       "control_dropped_block_row_ratio": ctrl_ratio,
                       "ms": time_ms(lambda: fc.fused_column_step(
                           *args, [-1], **kw), 5, 1),
                       "device_ms": device_ms(lambda: fc.fused_column_step(
                           *args, [-1], **kw), 5)}
                require(ratio <= 1.0, f"{tag}: row error ratio {ratio}")
                require(ctrl_ratio > 1.0, f"{tag}: the dropped-block control "
                        f"passes the row check ({ctrl_ratio})")
                if with_diag and dt == torch.float32:
                    row["residual_units"] = potrf_backward(got[0], c0)
                    row["control_residual_units"] = potrf_backward(
                        ctrl[0], c0)
                    require(row["residual_units"] <= BACKWARD_C,
                            f"{tag}: residual {row['residual_units']} units")
                    require(not row["control_residual_units"] <= BACKWARD_C,
                            f"{tag}: the dropped-update control passes the "
                            f"residual check")
                results[tag] = row
                log(f"kernel {tag}: " + json.dumps(row))

        # a pivot failing inside a block of the diagonal tile: row 0 is the
        # leading factor left of it and NaN from it on (lower entries), and
        # a later row's solve is finite left of it and NaN from it on
        for dt in (torch.float32, torch.float64):
            for n in sorted({tb, fc.MAX_TB}):
                res = fused_nan_pivot(n, dt, dev, g)
                # left of the pivot: POTRF's f32 tolerance, f64's 1e-12
                tol = 1e-12 if dt == torch.float64 else 2e-4
                require(res["leading_err"] <= tol and res["lower_nan"]
                        and res["row_left_finite"] and res["row_right_nan"],
                        f"fused NaN pivot {dt} tb={n}: {res}")
                results[f"fused_column_step[{str(dt)[6:]},tb={n},nan pivot]"] \
                    = res
        log("kernel fused_column_step, pivot failing inside a block at tb "
            f"{sorted({tb, fc.MAX_TB})}, f32 and f64: NaN from its column on, "
            "as the plain column loop gives")

        # the cooperative grid: blocks a SM at the largest phase's shared
        # memory, at the main path's tile and the largest the kernel takes
        grids = [fc.grid(n, dt) for dt in (torch.float32, torch.float64)
                 for n in sorted({tb, fc.MAX_TB})]
        results["fused_column_step[grid]"] = {"grids": grids}
        log("kernel fused_column_step grid: " + json.dumps(grids))

        # the main path's shapes: f32 mid-factorization, f64 smaller
        for dt, r_tiles, k_hist, peak in ((torch.float32, 32, 32,
                                           PEAK_F32_FLOPS),
                                          (torch.float64, 8, 8,
                                           PEAK_F64_FLOPS)):
            for with_diag in (True, False):
                args = _column(r_tiles, k_hist, tb, with_diag, dt, dev, g)
                ids = [LADDER.index("f32")] * r_tiles
                kw = dict(ladder=LADDER, with_diag=with_diag)
                got = fc.fused_column_step(*args, ids, **kw)
                want = fc.fused_column_step_ref(*args, ids, **kw)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                tol = _fused_tol("f32", tb, dt)
                ratio = _row_ratio(got, want, tol)
                tag = (f"fused_column_step[{str(dt)[6:]},R={r_tiles},"
                       f"K={k_hist},diag={int(with_diag)}]")
                require(ratio <= 1.0, f"{tag}: row error ratio {ratio}")
                row = {"dtype": str(dt)[6:], "max_abs_err": err,
                       "tol_per_row": tol, "row_ratio": ratio,
                       **_fused_cost(r_tiles, k_hist, tb, with_diag,
                                     args[0].element_size(), peak)}
                if with_diag:       # timed: the diagonal's step
                    row["ms"] = time_ms(
                        lambda: fc.fused_column_step(*args, ids, **kw), 3, 1)
                    row["device_ms"] = device_ms(
                        lambda: fc.fused_column_step(*args, ids, **kw), 3)
                    row["grid"] = fc.grid(tb, dt)
                    row["plain_ms"] = time_ms(
                        lambda: fc.fused_column_step_ref(*args, ids, **kw), 3,
                        1)
                if with_diag and dt == torch.float32:
                    c, hist, bhist, _ = args

                    def unfused():
                        d = c[0]
                        for kk in range(k_hist):
                            d = syrk.syrk_update(d, hist[0, kk])
                        lf = potrf.potrf(d)
                        for r in range(1, r_tiles):
                            x = c[r]
                            for kk in range(k_hist):
                                x = mxp_gemm.mxp_gemm_update(x, hist[r, kk],
                                                             bhist[kk])
                            trsm.trsm(lf, x)
                    row["unfused_ms"] = time_ms(unfused, 2, 1)
                results[tag] = row
                log(f"kernel {tag}: " + json.dumps(row))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return results


def make_spd(n: int, dev, seed: int) -> torch.Tensor:
    """The main path's seeded SPD matrix, x x^T / n + 2 I, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, n, generator=g, device=dev, dtype=torch.float64)
    a = x @ x.T / n + 2.0 * torch.eye(n, device=dev, dtype=torch.float64)
    del x
    return 0.5 * (a + a.T)


MAIN_EPS = 1e-6      # the main path's eps_target


def main_config(tb: int, fuse: bool = False):
    """The main path's configuration, its precision plan still open."""
    import repro_torch
    return repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu", eps_target=MAIN_EPS,
        use_pallas=True, compute_dtype=torch.float32, fuse_columns=fuse)


def main_path(a: torch.Tensor, lref: torch.Tensor, tb: int, dev, seed: int,
              fuse: bool) -> dict:
    t0 = time.perf_counter()
    cfg = main_config(tb, fuse).specialize(a)
    return checked_factor("fused" if fuse else "main", cfg, a, lref, dev,
                          seed, t0)


def schedule_launches(sched) -> dict:
    """Kernel launches an unfused factor of ``sched`` makes: one per op of
    each per-op kernel's kind."""
    from repro_torch.core.schedule import OpKind
    return {name: sched.count(OpKind[_OP_OF[name]]) if name in _OP_OF else 0
            for name in KERNEL_META}


def checked_factor(tag: str, cfg, a: torch.Tensor, lref: torch.Tensor, dev,
                   seed: int, t0: float) -> dict:
    """Plan and compile ``cfg`` (``t0``: when the caller began), factor
    ``a`` once, and hold the launches, the transfers, ``volume()`` and the
    accuracy against ``lref`` as the main path does."""
    import repro_torch
    from repro_torch.core.schedule import OpKind
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n, tb, fuse = a.shape[0], cfg.tb, cfg.fuse_columns
    eps_target = MAIN_EPS
    solver = repro_torch.plan(n, cfg).compile(device=dev)
    sched = solver.schedule
    plan_s = time.perf_counter() - t0
    hist = cfg.plan.histogram()
    nops = sum(len(s) for s in sched.streams)
    log(f"{tag}: n={n} tb={tb} nt={n // tb} ops={nops} fuse_columns={fuse} "
        f"plan+compile {plan_s:.2f}s precision histogram {hist}")

    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    repro_torch.reset_counts()       # this run's launches only
    t0 = time.perf_counter()
    solver.factor(a, materialize=False)
    factor_s = time.perf_counter() - t0
    launches = repro_torch.launch_counts()
    peak_mib = (torch.cuda.max_memory_allocated(dev) - base_mem) / 2 ** 20
    if fuse:      # one launch per column step, no per-op launch
        want = {**dict.fromkeys(launches, 0), "fused_column_step": n // tb}
    else:
        want = schedule_launches(sched)
    log(f"{tag}: factor {factor_s:.3f}s, {n ** 3 / 3 / factor_s / 1e12:.3f} "
        f"TFLOP/s (n^3/3); launches {launches}; want {want}; device memory "
        f"beyond the input {peak_mib:.0f} MiB at peak")
    require(launches == want, f"launches {launches} != {want}")

    io = solver.stats["transfers"]
    itemsize = torch.finfo(torch.float32).bits // 8
    tile_bytes = tb * tb * itemsize
    require(io["executed_h2d_ops"] == sched.count(OpKind.LOAD)
            and io["executed_d2h_ops"] == sched.count(OpKind.STORE)
            and io["executed_h2d_bytes"] == io["executed_h2d_ops"] * tile_bytes
            and io["executed_d2h_bytes"] == io["executed_d2h_ops"] * tile_bytes,
            f"executed transfers {io} do not match the schedule")
    log(f"{tag}: executed H2D {io['executed_h2d_bytes']} B / D2H "
        f"{io['executed_d2h_bytes']} B (f32 tiles); schedule (class "
        f"precision) loads_bytes {sched.loads_bytes()} stores_bytes "
        f"{sched.stores_bytes()}")
    # the analytics' exact volume report is the schedule's own accounting
    vol = solver.volume()
    want_vol = {"c2g_bytes": sched.loads_bytes(),
                "g2c_bytes": sched.stores_bytes(),
                "total_bytes": sched.loads_bytes() + sched.stores_bytes(),
                "loads": sched.count(OpKind.LOAD),
                "stores": sched.count(OpKind.STORE),
                "allocs": sched.count(OpKind.ALLOC),
                "nt": n // tb, "tb": tb}
    require({k: vol[k] for k in want_vol} == want_vol,
            f"volume() {vol} does not match the schedule {want_vol}")
    sim = solver.simulate(repro_torch.HW["h100-pcie"])
    log(f"{tag}: volume() equals the schedule's bytes and op counts; model "
        f"reading, not a measurement: simulate(HW['h100-pcie']) makespan "
        f"{sim.makespan:.3f}s on that PCIe datasheet preset (this card is "
        f"SXM) beside the measured factor {factor_s:.3f}s")

    acc = _accuracy(tag, solver, a, lref, eps_target, g)
    return {"n": n, "tb": tb, "nt": n // tb, "ops": nops,
            "fuse_columns": fuse, "precision_histogram": hist,
            "factor_s": factor_s, "peak_mib_beyond_input": peak_mib,
            "tflops_n3_over_3": n ** 3 / 3 / factor_s / 1e12,
            "launches": launches, "schedule_counts": want,
            "transfers": io, "volume": vol,
            "model_makespan_h100_pcie_preset_s": sim.makespan,
            **acc, "plan_compile_s": plan_s}


def _accuracy(tag: str, solver, a, lref, eps_target: float, g) -> dict:
    """The main path's factor, solve and logdet against the f64 factor on
    the card."""
    n, tb, dev = a.shape[0], solver.config.tb, a.device
    # accuracy against the f64 factor on the card. Every tile op runs in
    # f32 (f64-class tiles are held in the f32 compute dtype), and the plan
    # demotes a tile only where its class's roundoff keeps the error near
    # eps_target. So L carries about max(eps_target, 2^-24 sqrt(n)) of
    # max|A| for a well-conditioned A (kappa ~ 2 here); the bound allows
    # 64 times that (6.9e-4 at n = 32768).
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
    log(f"{tag}: max|L - chol64(A)|/max|A| = {rel_l:.3e} (bound {bound_l:.1e})")
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
    log(f"{tag}: solve (4 rhs) {solve_s:.3f}s relative residual {res:.3e} "
        f"(bound {bound_l:.1e})")
    require(math.isfinite(res) and res < bound_l, f"solve residual {res}")

    # logdet: the sum of 2 log L_ii; each L_ii carries the factor's
    # relative error, so |delta logdet| / n is held to the same bound
    ld = solver.logdet()
    ld_ref = 2.0 * float(torch.log(torch.diagonal(lref)).sum())
    ld_err = abs(ld - ld_ref) / n
    log(f"{tag}: logdet {ld:.6f} vs {ld_ref:.6f}, error/n {ld_err:.3e}")
    require(ld_err < bound_l, f"logdet error {ld_err}")
    return {"rel_factor_err": rel_l, "bound": bound_l, "solve_s": solve_s,
            "solve_residual": res, "logdet_err_per_n": ld_err}


def _dense_factor(solver, n: int) -> torch.Tensor:
    """tril L of a factored solver's host store, dense on the card."""
    tiles = solver.tiles.to(solver.device)
    return torch.tril(tiles.permute(0, 2, 1, 3).reshape(n, n))


def _factor_on_card(cfg, n: int, a: torch.Tensor, dev):
    """Plan, compile and factor ``a`` under ``cfg``: (solver, dense L,
    seconds of the factor, this factor's launches)."""
    import repro_torch
    solver = repro_torch.plan(n, cfg).compile(device=dev)
    repro_torch.reset_counts()
    t0 = time.perf_counter()
    solver.factor(a, materialize=False)
    secs = time.perf_counter() - t0
    return solver, _dense_factor(solver, n), secs, repro_torch.launch_counts()


def _tile_check(l, lu, plan, tb: int):
    """Tile by tile against the unfused port: the same ops and the same
    roundings in another accumulation order (the fused kernel against
    cuBLAS/cuSOLVER in f64).  A tile of class c differs by that order, or
    by one quantum of c where the order moved a value across a rounding
    boundary: max(1e-12, 4 EPS[c]) max|L|, the reference's _tol
    (tests/test_kernel_numerics.py).  A flip also reaches the tiles that
    read the flipped one.  The order differences are ~1e-14 of a value, so
    a flip is likely only in f32 tiles (about one in 10^7 f32 values
    against one in 10^10 f16 values), and each later tile is allowed FLIPS
    f32 quanta of the largest f32 tile: FLIPS 4 EPS[f32] max|L_f32 tile|.
    Returns the worst tile's error over its allowance (at most 1 passes),
    the max tile error / max|L| by class, and that f32 quantum."""
    nt = plan.nt
    scale = float(lu.abs().max())

    def blk(x, i, j):
        return x[i * tb:(i + 1) * tb, j * tb:(j + 1) * tb]

    flip = max([4 * EPS["f32"] * float(blk(lu, i, j).abs().max())
                for i in range(nt) for j in range(i + 1)
                if plan.name(i, j) == "f32"], default=0.0)
    worst, by_class = 0.0, {}
    for i in range(nt):
        for j in range(i + 1):
            cls = plan.name(i, j)
            d = float((blk(l, i, j) - blk(lu, i, j)).abs().max())
            by_class[cls] = max(by_class.get(cls, 0.0), d / scale)
            allow = max(1e-12, 4 * EPS[cls]) * scale + FLIPS * flip
            worst = max(worst, d / allow)
    return worst, by_class, flip


def mxp_fused(n: int, tb: int, dev) -> dict:
    """A mixed-precision plan end to end on the card: a Kac-Murdock-Szego
    matrix rho^|i-j| in f64 through the fused path on the ``gpu-scaled``
    ladder, against the f64 factor and, tile by tile, the unfused port."""
    import dataclasses

    import repro_torch
    rho, eps_target = 0.99, 1e-6
    nt = n // tb
    idx = torch.arange(n, device=dev, dtype=torch.float64)
    a = rho ** (idx[:, None] - idx[None, :]).abs()
    del idx
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu-scaled", eps_target=eps_target,
        use_pallas=True, fuse_columns=True).specialize(a)
    hist = cfg.plan.histogram()
    log(f"mxp: n={n} tb={tb} KMS rho={rho} eps_target={eps_target} "
        f"precision histogram {hist}")
    require(sum(v > 0 for v in hist.values()) >= 3
            and hist.get("f8e4m3s", 0) > 0,
            f"the plan {hist} needs three classes, f8e4m3s among them")

    _, lf, fused_s, launches = _factor_on_card(cfg, n, a, dev)
    want = {**dict.fromkeys(launches, 0), "fused_column_step": nt}
    require(launches == want, f"mxp launches {launches} != {want}")
    _, lu, unfused_s, _ = _factor_on_card(
        dataclasses.replace(cfg, fuse_columns=False), n, a, dev)
    # the control: the same plan with every tile op in f32, so the f64
    # tiles carry f32 roundoff; the tile check below must reject it
    _, lc, _, _ = _factor_on_card(
        dataclasses.replace(cfg, compute_dtype=torch.float32), n, a, dev)
    lref = torch.linalg.cholesky(a)

    # the plan's own guarantee, held as the reference's tests hold it
    # (tests/test_scaled_fp8.py): ||A - L L^T||_F / ||A||_F <= eps_target
    backward = float(torch.linalg.norm(lf @ lf.T - a) / torch.linalg.norm(a))
    # against the f64 factor: to first order a factor's relative error is at
    # most kappa_2(A) times the backward error, and a KMS matrix's
    # eigenvalues lie in ((1-rho)/(1+rho), (1+rho)/(1-rho))
    kappa = ((1 + rho) / (1 - rho)) ** 2
    forward = float((lf - lref).abs().max() / lref.abs().max())

    # tile by tile against the unfused port (_tile_check); the f32 control
    # must fail this check
    worst, by_class, flip = _tile_check(lf, lu, cfg.plan, tb)
    ctrl, ctrl_by_class, _ = _tile_check(lc, lu, cfg.plan, tb)
    log(f"mxp: fused factor {fused_s:.3f}s ({launches['fused_column_step']} "
        f"launches), unfused {unfused_s:.3f}s; ||A - LL^T||/||A|| = "
        f"{backward:.3e} (bound {eps_target:.0e}); max|L - chol64(A)|/max|L| "
        f"= {forward:.3e} (bound {kappa * eps_target:.1e})")
    log(f"mxp: fused vs unfused, worst tile error / (max(1e-12, 4 EPS[class]) "
        f"max|L| + {FLIPS} x {flip:.3e}) = {worst:.3e} (bound 1); max tile "
        f"error / max|L| by class {by_class}")
    log(f"mxp: f32-compute control vs unfused, the same ratio = {ctrl:.3e} "
        f"(must exceed 1); by class {ctrl_by_class}")
    require(math.isfinite(backward) and backward <= eps_target,
            f"mxp backward error {backward}")
    require(math.isfinite(forward) and forward <= kappa * eps_target,
            f"mxp forward error {forward}")
    require(worst <= 1.0, f"mxp fused vs unfused {worst}")
    require(ctrl > 1.0, f"mxp tile check passes the f32 control ({ctrl})")
    return {"n": n, "tb": tb, "rho": rho, "eps_target": eps_target,
            "precision_histogram": hist, "fused_factor_s": fused_s,
            "unfused_factor_s": unfused_s, "launches": launches,
            "backward_err": backward, "forward_err": forward,
            "forward_bound": kappa * eps_target,
            "f32_flip": flip, "flips_allowed": FLIPS,
            "fused_vs_unfused_tile_ratio": worst,
            "fused_vs_unfused_by_class": by_class,
            "f32_control_tile_ratio": ctrl,
            "f32_control_by_class": ctrl_by_class}


# The geospatial phase's bound on the log-likelihood of four observations
# through the fused MxP solver, the largest relative difference to the f64
# factor's, set between the sound readings and the fault's: the control's
# solver (its least f32 tile stored as e4m3).  Over seeds 0-2 at n = 16384
# (benchmarks/torch_geo_bounds.py, NVIDIA H100 80GB HBM3, 700 W) the sound
# readings were 1.52e-8 to 3.27e-8 and the fault's 1.34e-5 to 2.75e-5: the
# bound is 31 times the worst sound reading and 13 times below the least
# fault.
LOGLIK_BOUND = 1e-6
GEO_EPS = (1e-4, 1e-6, 1e-8)


def geo(n: int, tb: int, dev, seed: int, card: str) -> dict:
    """The paper's workload end to end on the card: a weakly correlated
    Matérn covariance (nu = 0.5, beta = 0.02627, Morton-ordered locations)
    on the ``gpu`` ladder at eps_target 1e-6, whose plan places unscaled
    e4m3 tiles; its fused f64 factor (the fused kernel's f64 variant and
    its unscaled-e4m3 epilogue) against the unfused one tile by tile, with
    a control that must fail; both against the f64 factor; the KL
    divergence of Fig. 10 and the log-likelihood of seeded observations."""
    import dataclasses

    import repro_torch
    from repro_torch.core.precision import PrecisionPlan
    from repro_torch.geo import (gaussian_loglik, generate_locations,
                                 kl_divergence_mxp, matern_covariance)
    from repro_torch.geo.matern import BETA_WEAK
    from repro_torch.kernels import fused_column as fc
    eps_target = 1e-6
    nt = n // tb
    t0 = time.perf_counter()
    cov = matern_covariance(generate_locations(n, seed), sigma2=1.0,
                            beta=BETA_WEAK, nu=0.5, nugget=1e-6, device=dev)
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu", eps_target=eps_target,
        use_pallas=True, fuse_columns=True).specialize(cov)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    plan = cfg.plan
    hist = plan.histogram()
    log(f"geo [{card}]: n={n} tb={tb} nt={nt} Matern nu=0.5 beta="
        f"{BETA_WEAK} eps_target={eps_target} ladder gpu: precision "
        f"histogram {hist} (covariance and plan {setup_s:.2f}s)")
    require(hist.get("f8e4m3", 0) > 0 and sum(v > 0 for v in hist.values())
            >= 3, f"the plan {hist} needs three classes, f8e4m3 among them")

    fused_solver, lf, fused_s, launches = _factor_on_card(cfg, n, cov, dev)
    want = {**dict.fromkeys(launches, 0), "fused_column_step": nt}
    require(launches == want, f"geo launches {launches} != {want}")
    _, lu, unfused_s, unfused_launches = _factor_on_card(
        dataclasses.replace(cfg, fuse_columns=False), n, cov, dev)
    e4m3 = plan.ladder.index("f8e4m3")

    def blk(x, t):
        return x[t[0] * tb:(t[0] + 1) * tb, t[1] * tb:(t[1] + 1) * tb]

    def pick(pick_by, cls):
        """The off-diagonal tile of class ``cls`` with the largest (max)
        or least (min) max|A|."""
        return pick_by(((i, j) for i in range(nt) for j in range(i)
                        if plan.name(i, j) == cls),
                       key=lambda t: float(blk(cov, t).abs().max()))

    def reclassified(t, cls):
        classes = plan.classes.copy()
        classes[t] = classes[t[::-1]] = cls
        return dataclasses.replace(cfg, plan=PrecisionPlan(
            classes, plan.ladder, plan.eps_target))

    # what the e4m3 tiles hold: their entries against e4m3's smallest
    # subnormal, 2^-9 (half of it rounds to zero)
    e4m3_tiles = [(i, j) for i in range(nt) for j in range(i)
                  if plan.classes[i, j] == e4m3]
    e4m3_amax = max(float(blk(cov, t).abs().max()) for t in e4m3_tiles)
    e4m3_nonzero = sum(int(blk(lf, t).count_nonzero()) for t in e4m3_tiles)
    # the control that must fail the tile check: the f32 tile with the
    # least entries stored as unscaled e4m3, whose values then lie inside
    # e4m3's range; its own fused and unfused factors must agree.  One
    # e4m3 tile stored as f16 (the other direction) is logged: its entries
    # lie below e4m3's quantum at zero, and it moves the other tiles by
    # ~1e-14 of max|L|, which no sound check of this order can see
    ca, cb = pick(min, "f32"), pick(max, "f8e4m3")
    ctrl_cfg = reclassified(ca, e4m3)
    ctrl_solver, lc, _, _ = _factor_on_card(ctrl_cfg, n, cov, dev)
    _, lcu, _, _ = _factor_on_card(
        dataclasses.replace(ctrl_cfg, fuse_columns=False), n, cov, dev)
    up_solver, lup, _, _ = _factor_on_card(
        reclassified(cb, plan.ladder.index("f16")), n, cov, dev)
    worst, by_class, flip = _tile_check(lf, lu, plan, tb)
    ctrl, ctrl_by_class, _ = _tile_check(lc, lu, plan, tb)
    ctrl_self, _, _ = _tile_check(lc, lcu, ctrl_cfg.plan, tb)
    ctrl_nonzero = int(blk(lc, ca).count_nonzero())
    up, up_by_class, _ = _tile_check(lup, lu, plan, tb)
    log(f"geo [{card}]: fused factor {fused_s:.3f}s ({nt} fused f64 "
        f"launches, no per-op launch), unfused {unfused_s:.3f}s (launches "
        f"{unfused_launches})")
    log(f"geo: the {len(e4m3_tiles)} f8e4m3 tiles: max|A| {e4m3_amax:.3e} "
        f"(e4m3's smallest subnormal {2.0 ** -9:.3e}); nonzero values of "
        f"the fused factor there: {e4m3_nonzero}")
    log(f"geo: fused vs unfused, worst tile error / (max(1e-12, 4 EPS[class]) "
        f"max|L| + {FLIPS} x {flip:.3e}) = {worst:.3e} (bound 1); by class "
        f"{by_class}")
    log(f"geo: control, f32 tile {ca} (max|A| "
        f"{float(blk(cov, ca).abs().max()):.3e}) stored as f8e4m3, the same "
        f"ratio = {ctrl:.3e} (must exceed 1); by class {ctrl_by_class}; its "
        f"fused vs its unfused factor {ctrl_self:.3e} (bound 1), "
        f"{ctrl_nonzero} nonzero e4m3 values in that tile")
    log(f"geo: f8e4m3 tile {cb} stored as f16, the same ratio = {up:.3e}; "
        f"by class {up_by_class}")
    require(worst <= 1.0, f"geo fused vs unfused {worst}")
    require(not ctrl <= 1.0, f"geo tile check passes the control ({ctrl})")
    require(ctrl_self <= 1.0 and ctrl_nonzero > 0,
            f"geo control fused vs unfused {ctrl_self}, {ctrl_nonzero} "
            f"nonzero e4m3 values")

    # both factors against the f64 factor: the plan's own guarantee,
    # ||A - L L^T||_F / ||A||_F <= eps_target, and the forward error to
    # first order within kappa_2(A) eps_target, kappa_2 bounded above by
    # ||A||_inf ||A^-1||_inf (A symmetric)
    lref = torch.linalg.cholesky(cov)
    kappa = float(cov.abs().sum(1).max()
                  * torch.cholesky_inverse(lref).abs().sum(1).max())
    acc = {}
    for name, l in (("fused", lf), ("unfused", lu)):
        backward = float(torch.linalg.norm(l @ l.T - cov)
                         / torch.linalg.norm(cov))
        forward = float((l - lref).abs().max() / lref.abs().max())
        acc[name] = {"backward_err": backward, "forward_err": forward}
        log(f"geo: {name} ||A - LL^T||/||A|| = {backward:.3e} (bound "
            f"{eps_target:.0e}); max|L - chol64(A)|/max|L| = {forward:.3e} "
            f"(bound kappa eps = {kappa * eps_target:.2e})")
        require(math.isfinite(backward) and backward <= eps_target,
                f"geo {name} backward error {backward}")
        require(math.isfinite(forward) and forward <= kappa * eps_target,
                f"geo {name} forward error {forward}")
    del lu, lc, lcu, lup

    # the log-likelihood of k = 4 seeded observations of the field
    # (y = L64 z) through the fused MxP solver, against the f64 factor's;
    # the control's solver must read above the bound
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    y = lref @ torch.randn(n, 4, generator=g, device=dev,
                           dtype=torch.float64)
    ll64 = gaussian_loglik(lref, y)

    def rel(solver):
        ll = gaussian_loglik(solver, y)
        return float(np.max(np.abs(ll - ll64) / np.abs(ll64)))

    ll_rel, ctrl_rel, up_rel = (rel(fused_solver), rel(ctrl_solver),
                                rel(up_solver))
    log(f"geo: log-likelihood (k=4) through the fused MxP solver, max "
        f"relative difference to the f64 factor's {ll_rel:.3e} (bound "
        f"{LOGLIK_BOUND:.0e}); the control's solver (f32 tile as e4m3) "
        f"{ctrl_rel:.3e} (must exceed); e4m3 tile as f16 {up_rel:.3e}")
    require(math.isfinite(ll_rel) and ll_rel <= LOGLIK_BOUND,
            f"geo log-likelihood {ll_rel}")
    require(not ctrl_rel <= LOGLIK_BOUND,
            f"geo log-likelihood check passes the control ({ctrl_rel})")
    del lf, lref, y, fused_solver, ctrl_solver, up_solver

    # the KL divergence of Fig. 10, on the card, and the reference's order
    kl = {}
    for eps in GEO_EPS:
        t0 = time.perf_counter()
        res = kl_divergence_mxp(cov, tb, eps, ladder="gpu", device=dev)
        res["seconds"] = time.perf_counter() - t0
        kl[eps] = res
        log(f"geo [{card}]: KL(eps_target={eps:.0e}) = {res['kl']:.6e} "
            f"(|KL| {res['abs_kl']:.3e}), histogram "
            f"{res['precision_histogram']}, two factors {res['seconds']:.2f}s")
    require(kl[1e-8]["abs_kl"] <= kl[1e-4]["abs_kl"],
            f"geo KL order: |KL(1e-8)| {kl[1e-8]['abs_kl']} > |KL(1e-4)| "
            f"{kl[1e-4]['abs_kl']}")
    del cov

    # the fused step's f64 launch site at this path's middle column,
    # R = K = nt / 2, against its plain version, timed beside its bound
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    r = nt // 2
    args = _column(r, r, tb, True, torch.float64, dev, g)
    ids = [LADDER.index("f32")] * r
    kw = dict(ladder=LADDER, with_diag=True)
    got = fc.fused_column_step(*args, ids, **kw)
    ratio = _row_ratio(got, fc.fused_column_step_ref(*args, ids, **kw),
                       _fused_tol("f32", tb, torch.float64))
    require(ratio <= 1.0, f"geo fused step R=K={r}: row error ratio {ratio}")
    # a launch of some 6 ms, which CUDA events time as the device does
    step = {"R": r, "K": r, "row_ratio": ratio,
            "ms": time_ms(lambda: fc.fused_column_step(*args, ids, **kw), 3,
                          1),
            "device_ms": device_ms(lambda: fc.fused_column_step(
                *args, ids, **kw), 3),
            "plain_ms": time_ms(lambda: fc.fused_column_step_ref(
                *args, ids, **kw), 3, 1),
            **_fused_cost(r, r, tb, True, 8, PEAK_F64_FLOPS)}
    log(f"geo [{card}]: fused step f64 R=K={r}: " + json.dumps(step))
    return {"n": n, "tb": tb, "nt": nt, "eps_target": eps_target,
            "beta": BETA_WEAK, "nu": 0.5, "precision_histogram": hist,
            "setup_s": setup_s, "fused_factor_s": fused_s,
            "unfused_factor_s": unfused_s, "launches": launches,
            "unfused_launches": unfused_launches,
            "fused_vs_unfused_tile_ratio": worst,
            "fused_vs_unfused_by_class": by_class, "f32_flip": flip,
            "f8e4m3_tiles": len(e4m3_tiles), "f8e4m3_max_abs_a": e4m3_amax,
            "f8e4m3_nonzero_values": e4m3_nonzero,
            "control_f32_tile_as_e4m3": list(ca), "control_tile_ratio": ctrl,
            "control_by_class": ctrl_by_class,
            "control_fused_vs_unfused_tile_ratio": ctrl_self,
            "control_e4m3_nonzero_values": ctrl_nonzero,
            "e4m3_tile_as_f16": list(cb), "e4m3_as_f16_tile_ratio": up,
            "e4m3_as_f16_by_class": up_by_class, "kappa_bound": kappa,
            "accuracy": acc, "loglik_rel": ll_rel,
            "loglik_control_rel": ctrl_rel, "loglik_e4m3_as_f16_rel": up_rel,
            "loglik_bound": LOGLIK_BOUND,
            "kl": {str(e): v for e, v in kl.items()},
            "fused_step_f64_mid": step}


MD_NDEV = 4
# config B's n: its NumPy replay runs on the host, 62 s at phase 5's 8192 on
# the card's host, so it is cut to 4096, which still places scaled-FP8
# wires and host-landing RECVs
MD_MXP_N = 4096
# seconds two multi-device factors may take before the watchdog ends the
# process (a cooperative launch that never got its whole grid resident
# would spin): over ten times the slowest pair seen (8.1 s)
MD_WATCHDOG_S = 120
# the reference's MxP cross-backend tolerance
# (tests/test_backend_equivalence.py), max|L - L'| of factors of size ~1:
# config B against the NumPy replay and fused against unfused.  The card
# read 1.2e-14 to 2.3e-13 (NVIDIA H100 80GB HBM3, 700 W).  A lookahead
# partial accumulator's f32 STORE can round the other way where two f64
# GEMMs differ in their last bit (2.1e-7, seen on the CPU only, PyTorch's
# GEMM against NumPy's: tests/test_torch_multidevice.py::test_lookahead_
# rounding_flip_is_the_blas_order); the card has shown none.  The controls
# that must fail it: every wire through e4m3, and the f64 class's wires
# sent as f32 (1.4e-8 on the CPU at config B's n, in its seven lower
# diagonal tiles).
MD_MXP_TOL = 1e-8


def md_devices(dev, ndev: int):
    """``ndev`` logical devices: the first ``ndev`` cards where the machine
    has them, else ``ndev`` on ``dev``'s card, each on a stream of its own.
    Returns (the devices for ``compile``, whether they share one card)."""
    if torch.cuda.device_count() >= ndev:
        return "cuda", False
    return [dev] * ndev, True


def reference_fused_groups(segments) -> dict:
    """The launches the reference's grouping gives on the multi-device
    executor's segments (its ``_run_ops_fused``, ROADMAP queue 3 item 4):
    it flushes the pending group where a LOAD targets a slot the group
    writes or a host tile with a deferred STORE, and at a new column; a
    flushed group that matches the kernel's pattern on slot numbers is one
    fused launch, any other runs per op.  Returns ``{"fused_column":
    launches, "tile_op": per-op calls}``, the reference's counters."""
    from repro_torch.core.cholesky import _FUSABLE, _parse_column_group
    from repro_torch.core.schedule import OpKind
    counts = {"fused_column": 0, "tile_op": 0}

    def flush(group):
        if not group:
            return
        # slot numbers as names and operands: the reference parses slots
        parsed = _parse_column_group(group)
        if parsed is not None:
            counts["fused_column"] += 1
        else:
            counts["tile_op"] += sum(e[0].kind in _FUSABLE for e in group)
        group.clear()

    for _d, _recvs, body, _bcasts in segments:
        group, gwrite, dtiles = [], set(), set()
        for op in body:
            if op.kind is OpKind.LOAD:
                if op.slot_c in gwrite or (op.i, op.j) in dtiles:
                    flush(group)
                    gwrite.clear()
                    dtiles.clear()
            elif op.kind is OpKind.STORE and group:
                gwrite.add(op.slot_c)
                dtiles.add((op.i, op.j))
                group.append((op, None, op.slot_c))
            elif op.kind in _FUSABLE:
                if group and op.k != group[0][0].k:
                    flush(group)
                    gwrite.clear()
                    dtiles.clear()
                snap = {"a": ("slot", op.slot_a), "b": ("slot", op.slot_b),
                        "l": ("slot", op.slot_a)}
                group.append((op, snap, op.slot_c))
                gwrite.add(op.slot_c)
        flush(group)
    return counts


def _md_twice(solver, a, what: str):
    """Two factors of ``a`` under the watchdog, which must be bitwise
    equal (a missing event wait would show as a difference): (seconds of
    each, the launches of the first).  The counts are set to 0 just before
    the first and read just after it."""
    import faulthandler

    import repro_torch
    secs = []
    faulthandler.dump_traceback_later(MD_WATCHDOG_S, exit=True)
    try:
        repro_torch.reset_counts()
        t0 = time.perf_counter()
        solver.factor(a, materialize=False)
        secs.append(time.perf_counter() - t0)
        launches = repro_torch.launch_counts()
        first = solver.tiles.clone()
        t0 = time.perf_counter()
        solver.factor(a, materialize=False)
        secs.append(time.perf_counter() - t0)
    finally:
        faulthandler.cancel_dump_traceback_later()
    same = torch.equal(first, solver.tiles)
    log(f"{what}: factor {secs[0]:.3f}s then {secs[1]:.3f}s; the two "
        f"factors bitwise equal: {same}; launches {launches}")
    require(same, f"{what}: two runs differ")
    return secs, launches


def _md_transfers(what: str, solver, itemsize: int) -> dict:
    """The executed copies against the schedule: LOAD/STORE counts and
    bytes summed over the devices, and the BCAST/RECV counters through the
    analytics' crosscheck."""
    import repro_torch
    from repro_torch.core.schedule import OpKind
    sched, tb = solver.schedule, solver.config.tb
    io = solver.stats["transfers"]
    tile = tb * tb * itemsize
    require(io["executed_h2d_ops"] == sched.count(OpKind.LOAD)
            and io["executed_d2h_ops"] == sched.count(OpKind.STORE)
            and io["executed_h2d_bytes"] == io["executed_h2d_ops"] * tile
            and io["executed_d2h_bytes"] == io["executed_d2h_ops"] * tile
            and io["executed_wire_h2d_ops"] == sched.count(OpKind.BCAST),
            f"{what}: executed transfers {io} do not match the schedule")
    cc = repro_torch.crosscheck_executed_volume(sched,
                                                solver.transfer_stats())
    require(cc["match"], f"{what}: crosscheck {cc['mismatches']}")
    log(f"{what}: executed bytes: H2D {io['executed_h2d_bytes']} "
        f"({io['executed_h2d_ops']} LOADs), D2H {io['executed_d2h_bytes']} "
        f"({io['executed_d2h_ops']} STOREs), wire H2D "
        f"{io['executed_wire_h2d_bytes']} ({io['executed_wire_h2d_ops']} "
        f"wires cut from a slab), "
        f"RECV {io['executed_recv_bytes']} ({io['executed_recv_ops']} RECVs, "
        f"{io['executed_recv_d2h_ops']} landing in a slab: "
        f"{io['executed_recv_d2h_bytes']} D2H); BCAST "
        f"{io['executed_bcast_bytes']}; crosscheck_executed_volume matches")
    return io


def multidevice(n: int, mxp_n: int, tb: int, dev, seed: int, card: str,
                single: dict) -> dict:
    """The multi-device executor on the card (four logical devices, on
    four cards where the machine has them, else sharing this one): config
    A, the main path's configuration on a 1D grid, unfused and fused; and
    config B, the mixed-precision KMS plan on a (2, 2) grid with lookahead
    1, unfused and fused, against the NumPy replay, with a control that
    must fail that check.  Each factor runs twice, bitwise equal.
    ``single`` holds phase 4's results (``main``, ``fused``), whose factor
    times config A's are logged beside."""
    import dataclasses

    import repro_torch
    from repro_torch.core import cholesky as chol
    from repro_torch.core.schedule import OpKind
    from repro_torch.core.tiling import from_tiles, to_tiles
    devices, shared = md_devices(dev, MD_NDEV)
    log(f"md [{card}]: {MD_NDEV} logical devices "
        + ("share this one card, each on a CUDA stream of its own (the "
           "machine has one card)" if shared else f"on {MD_NDEV} cards"))
    out = {"ndev": MD_NDEV, "shared_card": shared, "card": card}

    # config A: the main path's configuration as four devices on a 1D grid
    eps_target = 1e-6
    a = make_spd(n, dev, seed)
    lref = torch.linalg.cholesky(a)
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    for fuse in (False, True):
        tag = "md A " + ("fused" if fuse else "unfused")
        cfg = repro_torch.CholeskyConfig(
            tb=tb, policy="v3", ladder="gpu", eps_target=eps_target,
            use_pallas=True, compute_dtype=torch.float32, ndev=MD_NDEV,
            grid=(MD_NDEV, 1), lookahead=0, fuse_columns=fuse).specialize(a)
        solver = repro_torch.plan(n, cfg).compile(device=devices)
        sched = solver.schedule
        log(f"{tag}: n={n} tb={tb} grid {sched.grid} lookahead "
            f"{sched.lookahead} ops {sum(len(st) for st in sched.streams)} "
            f"(BCAST {sched.count(OpKind.BCAST)}, RECV "
            f"{sched.count(OpKind.RECV)})")
        secs, launches = _md_twice(solver, a, tag)
        segs = solver._executor.multidevice._segments
        if fuse:
            groups = len({(i, o.k) for i, (_d, _r, body, _b) in
                          enumerate(segs) for o in body
                          if o.kind in chol._FUSABLE})
            ref = reference_fused_groups(segs)
            per_op = sum(v for k, v in launches.items() if k in _OP_OF)
            total = launches["fused_column_step"] + per_op
            log(f"{tag}: {launches['fused_column_step']} fused launches "
                f"over {groups} segment groups; the reference's grouping "
                f"{ref}; per-op launches {per_op}")
            # the reference splits out-of-core columns where a LOAD reuses
            # a finished row's slot, and runs most parts per op; the port
            # retires that row and launches the column whole (ROADMAP
            # queue 3 item 4): no more launches in all, nor per-op ones
            require(0 < launches["fused_column_step"] <= groups
                    and total <= ref["fused_column"] + ref["tile_op"]
                    and per_op <= ref["tile_op"]
                    and launches["flash_attention"] == 0,
                    f"{tag}: launches {launches}")
        else:
            want = {name: sched.count(OpKind[_OP_OF[name]])
                    if name in _OP_OF else 0 for name in launches}
            require(launches == want, f"{tag}: launches {launches} != {want}")
        io = _md_transfers(tag, solver, 4)
        acc = _accuracy(tag, solver, a, lref, eps_target, g)
        single_s = single["fused" if fuse else "main"]["factor_s"]
        log(f"{tag} [{card}]: factor {secs[0]:.3f}s, {secs[1]:.3f}s across "
            f"{MD_NDEV} logical devices; phase 4 on one device "
            f"{single_s:.3f}s")
        out["A_fused" if fuse else "A_unfused"] = {
            "n": n, "tb": tb, "factor_s": secs, "launches": launches,
            "single_device_factor_s": single_s, "transfers": io, **acc}
        del solver
    del a, lref

    # config B: mixed precision on a (2, 2) grid with lookahead 1
    rho = 0.99
    idx = torch.arange(mxp_n, device=dev, dtype=torch.float64)
    a = rho ** (idx[:, None] - idx[None, :]).abs()
    del idx
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu-scaled", eps_target=eps_target,
        use_pallas=True, ndev=MD_NDEV, grid=(2, 2),
        lookahead=1).specialize(a)
    hist = cfg.plan.histogram()
    require(hist.get("f8e4m3s", 0) > 0, f"md B plan {hist} has no f8e4m3s")
    sched = repro_torch.plan(mxp_n, cfg).schedule
    landing = sum(1 for st in sched.streams for o in st
                  if o.kind is OpKind.RECV and o.slot_c < 0)
    t0 = time.perf_counter()
    lnp = torch.from_numpy(np.tril(from_tiles(chol.run_multidevice_numpy(
        to_tiles(a.cpu().numpy(), tb), sched)))).to(dev)
    replay_s = time.perf_counter() - t0
    log(f"md B: KMS rho={rho} n={mxp_n} tb={tb} grid (2, 2) lookahead 1 "
        f"gpu-scaled histogram {hist}; {landing} host-landing RECVs; the "
        f"NumPy replay {replay_s:.2f}s on the host")
    lref = torch.linalg.cholesky(a)
    kappa = ((1 + rho) / (1 - rho)) ** 2
    factors = {}
    for fuse in (False, True):
        tag = "md B " + ("fused" if fuse else "unfused")
        solver = repro_torch.plan(mxp_n, dataclasses.replace(
            cfg, fuse_columns=fuse)).compile(device=devices)
        secs, launches = _md_twice(solver, a, tag)
        if fuse:
            # f64 tiles take the stock ops, so only the fused step launches
            ref = reference_fused_groups(
                solver._executor.multidevice._segments)
            require(0 < launches["fused_column_step"]
                    <= ref["fused_column"] + ref["tile_op"],
                    f"{tag}: launches {launches}, reference {ref}")
        io = _md_transfers(tag, solver, 8)
        require(io["executed_recv_d2h_ops"] == landing,
                f"{tag}: host-landing RECVs {io['executed_recv_d2h_ops']}")
        lf = _dense_factor(solver, mxp_n)
        factors[fuse] = lf
        d_np = float((lf - lnp).abs().max())
        _, by_class, _ = _tile_check(lf, lnp, cfg.plan, tb)
        backward = float(torch.linalg.norm(lf @ lf.T - a)
                         / torch.linalg.norm(a))
        forward = float((lf - lref).abs().max() / lref.abs().max())
        # the same plan on one device, for its time beside these
        one = repro_torch.plan(mxp_n, dataclasses.replace(
            cfg, ndev=1, grid=None, lookahead=None,
            fuse_columns=fuse)).compile(device=dev)
        single_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            one.factor(a, materialize=False)
            single_s.append(time.perf_counter() - t0)
        del one
        log(f"{tag} [{card}]: max|L - L_replay| = {d_np:.3e} (bound "
            f"{MD_MXP_TOL:.0e}), max tile error / max|L| by class "
            f"{by_class}; ||A - LL^T||/||A|| = {backward:.3e} (bound "
            f"{eps_target:.0e}); max|L - chol64(A)|/max|L| = {forward:.3e} "
            f"(bound {kappa * eps_target:.1e}); factor {secs[0]:.3f}s, "
            f"{secs[1]:.3f}s; the same plan on one device {single_s[0]:.3f}s, "
            f"{single_s[1]:.3f}s")
        require(d_np < MD_MXP_TOL, f"{tag}: vs the NumPy replay {d_np}")
        require(math.isfinite(backward) and backward <= eps_target,
                f"{tag}: backward error {backward}")
        require(math.isfinite(forward) and forward <= kappa * eps_target,
                f"{tag}: forward error {forward}")
        out["B_fused" if fuse else "B_unfused"] = {
            "n": mxp_n, "tb": tb, "precision_histogram": hist,
            "factor_s": secs, "launches": launches, "transfers": io,
            "vs_numpy_replay_max": d_np,
            "vs_numpy_replay_by_class": by_class, "backward_err": backward,
            "forward_err": forward, "single_device_factor_s": single_s}
        del solver
    d_fu = float((factors[True] - factors[False]).abs().max())
    log(f"md B: max|L_fused - L_unfused| = {d_fu:.3e} (bound "
        f"{MD_MXP_TOL:.0e})")
    require(d_fu < MD_MXP_TOL, f"md B fused vs unfused {d_fu}")

    # the controls, each swapped in here and not through an option of the
    # package; the check against the NumPy replay must reject both
    make_wire = chol._make_wire
    controls = {
        "every wire through e4m3":
            lambda tile, cls: make_wire(tile, "f8e4m3"),
        "f64 wires as f32":
            lambda tile, cls: make_wire(tile, "f32" if cls == "f64" else cls)}
    out["B_control_max"] = {}
    for what, swap in controls.items():
        chol._make_wire = swap
        try:
            solver = repro_torch.plan(mxp_n, cfg).compile(device=devices)
            solver.factor(a, materialize=False)
            lc = _dense_factor(solver, mxp_n)
        finally:
            chol._make_wire = make_wire
        ctrl = float((lc - lnp).abs().max())
        log(f"md B: control, {what}: max|L - L_replay| = {ctrl:.3e} (must "
            f"reach {MD_MXP_TOL:.0e})")
        require(not ctrl < MD_MXP_TOL,
                f"md B check passes the control '{what}' ({ctrl})")
        out["B_control_max"][what] = ctrl
        del solver
    out.update({"B_fused_vs_unfused_max": d_fu, "B_replay_s": replay_s,
                "mxp_tol": MD_MXP_TOL})
    return out


def _lower_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Two [nt, nt, tb, tb] CPU stores bitwise equal on their lower tiles
    (the factor; the strictly upper tiles keep the input, which the f32
    in-core store holds in f32 and an f64 disk store in f64)."""
    nt = x.shape[0]
    return all(torch.equal(x[i, :i + 1].to(y.dtype), y[i, :i + 1])
               for i in range(nt))


def fence_floor_us(dev, reps: int = 2000) -> float:
    """Median host time of ``synchronize()`` on an idle CUDA stream, the
    width of a fenced op that does no work."""
    s = torch.cuda.current_stream(dev)
    s.synchronize()
    widths = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        s.synchronize()
        widths.append(time.perf_counter_ns() - t0)
    return statistics.median(widths) / 1e3


def trace_phase(n: int, mxp_n: int, tb: int, dev, seed: int,
                card: str) -> dict:
    """The measured trace on the card.  Config A, the main path's
    configuration: one traced factor, one span per op, bitwise the
    untraced unfused factor of the same solver; per-kind sums beside the
    fence floor, the drift report against the simulator (a model
    reading), the chrome trace's events against the spans, and a
    misaligned timeline the report must refuse.  Config B, phase 7's
    mixed-precision layout on four logical devices: one span per op of
    every stream, the same transfer counters, the untraced factor.
    Returns the results and config A's (recorder, plan)."""
    import dataclasses
    import tempfile

    import repro_torch
    from repro_torch import obs
    out = {"card": card}
    floor_us = fence_floor_us(dev)
    log(f"trace [{card}]: a fenced no-op (synchronize of an idle stream) "
        f"takes {floor_us:.2f} us, median of 2000")
    out["fence_noop_us"] = floor_us

    a = make_spd(n, dev, seed)
    eps_target = 1e-6
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu", eps_target=eps_target,
        use_pallas=True, compute_dtype=torch.float32).specialize(a)
    plan = repro_torch.plan(n, cfg)
    solver = plan.compile(device=dev)
    sched = plan.single_schedule()
    t0 = time.perf_counter()
    solver.factor(a, materialize=False)
    untraced_s = time.perf_counter() - t0
    untraced = solver.tiles.clone()
    rec = obs.TraceRecorder()
    repro_torch.reset_counts()
    t0 = time.perf_counter()
    solver.factor(a, materialize=False, trace=rec)
    traced_s = time.perf_counter() - t0
    launches = repro_torch.launch_counts()
    same = torch.equal(untraced, solver.tiles)
    log(f"trace A: n={n} tb={tb}: {len(rec)} spans for {len(sched.ops)} "
        f"ops, {rec.dropped} dropped; traced factor {traced_s:.3f}s, "
        f"untraced {untraced_s:.3f}s; traced bitwise the untraced unfused "
        f"factor: {same}; launches {launches}")
    require(len(rec) == len(sched.ops) and rec.dropped == 0,
            f"trace A: {len(rec)} spans for {len(sched.ops)} ops")
    require([s.kind for s in rec.spans]
            == [op.kind.value for op in sched.ops],
            "trace A: span kinds do not follow the schedule")
    require(same, "trace A: traced factor differs from the untraced one")
    # phase 4's fused factor, again on this matrix: fused and unfused f32
    # factors sum in other orders, so they agree to the f32 factor's own
    # accuracy bound (phase 4's), not bitwise
    fused = repro_torch.plan(n, dataclasses.replace(
        cfg, fuse_columns=True)).compile(device=dev)
    fused.factor(a, materialize=False)
    amax = float(a.abs().max())
    d_fused = max(float((solver.tiles[i, :i + 1].to(torch.float64)
                         - fused.tiles[i, :i + 1].to(torch.float64))
                        .abs().max()) for i in range(n // tb)) / amax
    bound = 64 * max(eps_target, 2.0 ** -24 * math.sqrt(n))
    log(f"trace A: max|L_traced - L_fused|/max|A| = {d_fused:.3e} (the f32 "
        f"factor's bound {bound:.1e})")
    require(d_fused < bound, f"trace A vs fused {d_fused}")
    del fused

    by_kind = rec.by_kind()
    books = [s.duration_s * 1e6 for s in rec.spans
             if s.kind in ("alloc", "free")]
    book_us = statistics.median(books) if books else None
    log(f"trace A [{card}]: ALLOC/FREE spans (no work: the fence floor in "
        f"the loop): " + (f"median {book_us:.2f} us over {len(books)}"
                          if books else "none in this schedule"))
    for kind, (count, secs, nbytes) in sorted(by_kind.items()):
        log(f"trace A [{card}]: {kind:>6s} n={count:<6d} sum {secs:.4f}s, "
            f"{secs / count * 1e6:.2f} us a span, beside the fenced no-op "
            f"{floor_us:.2f} us ({count * floor_us / 1e6:.4f}s in all); "
            f"{nbytes} B")
    sim = solver.simulate(repro_torch.HW["h100-pcie"], record_timeline=True)
    rep = obs.drift_report(rec, sim)
    log("trace A: model reading, not a measurement: drift against "
        "simulate(HW['h100-pcie']), a PCIe datasheet preset (this card is "
        "SXM)\n" + rep.summary())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace_a.json"
        ct = obs.chrome_trace_measured(rec, path)
        disk = json.loads(path.read_text())
    xs = [e for e in disk["traceEvents"] if e["ph"] == "X"]
    t_first = min(s.t_start for s in rec.spans)
    want = [((s.t_start - t_first) / 1e3, (s.t_end - s.t_start) / 1e3)
            for s in rec.spans]
    got = [(e["ts"], e["dur"]) for e in xs]
    same_events = (disk == ct and len(xs) == len(rec.spans)
                   and all(abs(g[0] - w[0]) < 1e-3 and abs(g[1] - w[1]) < 1e-3
                           for g, w in zip(got, want)))
    log(f"trace A: chrome trace {len(xs)} events, their starts the spans': "
        f"{same_events}")
    require(same_events, "trace A: chrome trace events differ from the spans")
    # the control: the same timeline with one op dropped must be refused
    k = len(sim.timeline) // 2
    short = dataclasses.replace(
        sim, timeline=sim.timeline[:k] + sim.timeline[k + 1:])
    try:
        obs.drift_report(rec, short)
    except ValueError as exc:
        log(f"trace A: control, a timeline with one op dropped: refused "
            f"({exc})")
    else:
        require(False, "trace A: drift_report aligned a short timeline")
    out["A"] = {
        "n": n, "tb": tb, "spans": len(rec), "ops": len(sched.ops),
        "traced_s": traced_s, "untraced_s": untraced_s,
        "bitwise_untraced": same, "vs_fused_rel": d_fused,
        "launches": launches, "bookkeeping_span_us": book_us,
        "by_kind": {k: {"count": c, "seconds": t, "bytes": b}
                    for k, (c, t, b) in by_kind.items()},
        "drift_h100_pcie_model": {
            "makespan_ratio": rep.makespan_ratio,
            "per_kind_ratio": {k: v["ratio"]
                               for k, v in rep.per_kind.items()}}}
    trace_a = (rec, plan)           # phase 11 refits a model from it
    del solver, a, untraced

    # config B: phase 7's mixed-precision layout, traced once
    rho = 0.99
    idx = torch.arange(mxp_n, device=dev, dtype=torch.float64)
    a = rho ** (idx[:, None] - idx[None, :]).abs()
    del idx
    devices, shared = md_devices(dev, MD_NDEV)
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu-scaled", eps_target=eps_target,
        use_pallas=True, ndev=MD_NDEV, grid=(2, 2),
        lookahead=1).specialize(a)
    solver = repro_torch.plan(mxp_n, cfg).compile(device=devices)
    solver.factor(a, materialize=False)
    untraced = solver.tiles.clone()
    wires = solver.transfer_stats()
    rec = obs.TraceRecorder()
    t0 = time.perf_counter()
    solver.factor(a, materialize=False, trace=rec)
    traced_s = time.perf_counter() - t0
    order = [(d, op) for d, op in solver.schedule.iter_dispatch_order()]
    bitwise = torch.equal(untraced, solver.tiles)
    diff = float((untraced - solver.tiles).abs().max())
    same_wires = solver.transfer_stats() == wires
    per_dev = {d: sum(1 for s in rec.spans if s.device == d)
               for d in range(MD_NDEV)}
    log(f"trace B: n={mxp_n} grid (2, 2) lookahead 1 on {MD_NDEV} logical "
        f"devices ({'one card' if shared else 'four cards'}): {len(rec)} "
        f"spans for {len(order)} ops, by device {per_dev} against "
        f"{[len(st) for st in solver.schedule.streams]}; traced "
        f"{traced_s:.3f}s; transfer_stats equal: {same_wires}; max|traced "
        f"- untraced| = {diff:.3e}, bitwise: {bitwise}")
    require(len(rec) == len(order) and rec.dropped == 0
            and [(s.device, s.kind) for s in rec.spans]
            == [(d, op.kind.value) for d, op in order]
            and all(per_dev[d] == len(st)
                    for d, st in enumerate(solver.schedule.streams)),
            "trace B: not one span per op of every stream")
    require(same_wires, "trace B: transfer_stats differ from the untraced")
    require(diff < MD_MXP_TOL, f"trace B: traced vs untraced {diff}")
    out["B"] = {"n": mxp_n, "spans": len(rec), "ops": len(order),
                "traced_s": traced_s, "bitwise_untraced": bitwise,
                "max_diff": diff, "transfer_stats_equal": same_wires}
    return out, trace_a


def pick_host_slots(n: int, tb: int, plan) -> int:
    """The largest power-of-two host tier whose schedule fetches at least
    twice the store from disk."""
    from repro_torch.core.schedule import build_schedule
    nt = n // tb
    store_bytes = nt * nt * tb * tb * 8
    h = 1 << (nt * nt).bit_length()
    while h > 1:
        h //= 2
        sched = build_schedule(nt, tb, "v3", plan=plan, host_slots=h)
        if sched.fetch_bytes() >= 2 * store_bytes:
            return h
    raise RuntimeError("no host tier fetches twice the store")


def spill_groups_in_core(ex, a: torch.Tensor, dev) -> torch.Tensor:
    """The spill executor's ops, segment by segment as it groups them,
    run against a full in-core store of ``a`` (pinned, f32) instead of the
    disk tier: the same kernels on the same operands in the same order,
    with no FETCH/SPILL.  Returns the factored store."""
    from repro_torch.core.cholesky import (_interpret_op, _new_io,
                                           _run_ops_fused)
    n, tb = a.shape[0], ex.sched.tb
    nt = n // tb
    host = torch.empty((nt, nt, tb, tb), dtype=ex.dtype, pin_memory=True)
    for i in range(nt):
        host[i].copy_(a[i * tb:(i + 1) * tb].to(ex.dtype)
                      .reshape(tb, nt, tb).permute(1, 0, 2))
    slots = torch.zeros((ex._nslots, tb, tb), dtype=ex.dtype, device=dev)
    io = _new_io()
    with torch.cuda.device(dev):
        for seg in ex._segments:
            if seg[0] != "run":
                continue
            if ex._fuse:
                _run_ops_fused(seg[1], host, slots, ex.sched.plan.ladder,
                               ex._kf, io)
            else:
                for op in seg[1]:
                    _interpret_op(host, slots, op, ex.sched.plan.ladder,
                                  ex._kf, io)
    torch.cuda.synchronize(dev)
    return host


def disk_tier(n: int, tb: int, dev, seed: int, card: str) -> dict:
    """The disk tier on the card: the main path's configuration at ``n``
    through a DiskTileStore (f64, in a temporary directory) and a host tier
    of pinned slabs, unfused and fused, each twice; executed FETCH/SPILL
    against the schedule; a run with one scheduled SPILL skipped must
    differ.  Unfused, the factor is bitwise the in-core executor's.  Fused,
    the groups end at every FETCH/SPILL, as the reference's do (528 fused
    launches and per-op ones against the in-core path's one a column), so
    the factor is bitwise the same groups run against an in-core store
    (:func:`spill_groups_in_core`) and within the f32 factor's bound of
    the in-core fused factor, whose sums run in another order."""
    import dataclasses
    import tempfile

    import repro_torch
    from repro_torch.core.cholesky import SpillTorchExecutor
    from repro_torch.core.schedule import OpKind
    a = make_spd(n, dev, seed)
    cfg = repro_torch.CholeskyConfig(
        tb=tb, policy="v3", ladder="gpu", eps_target=1e-6, use_pallas=True,
        compute_dtype=torch.float32).specialize(a)
    host_slots = pick_host_slots(n, tb, cfg.plan)
    nt = n // tb
    store_bytes = nt * nt * tb * tb * 8
    sched = repro_torch.plan(n, dataclasses.replace(
        cfg, host_slots=host_slots)).single_schedule()
    want_io = {"fetch_ops": sched.count(OpKind.FETCH),
               "spill_ops": sched.count(OpKind.SPILL),
               "fetched_bytes": sched.fetch_bytes(),
               "spilled_bytes": sched.spill_bytes()}
    log(f"disk [{card}]: n={n} tb={tb} host_slots={host_slots} (the largest "
        f"power of two whose schedule fetches twice the store): store "
        f"{store_bytes / 1e9:.2f} GB f64, schedule {want_io}, fetch / store "
        f"{sched.fetch_bytes() / store_bytes:.2f}; slab events before each "
        f"FETCH/SPILL")
    host_a = a.cpu().numpy()
    amax = float(a.abs().max())
    bound = 64 * max(1e-6, 2.0 ** -24 * math.sqrt(n))
    out = {"n": n, "tb": tb, "host_slots": host_slots,
           "store_bytes": store_bytes, "schedule_io": want_io, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "store.npy")

        def spill_run(ex):
            store = repro_torch.DiskTileStore.from_matrix(path, host_a, tb)
            repro_torch.reset_counts()
            t0 = time.perf_counter()
            io = ex.run_store(store)
            secs = time.perf_counter() - t0
            launches = repro_torch.launch_counts()
            got = torch.from_numpy(store.to_tiles())
            del store
            return got, secs, io, launches

        for fuse in (False, True):
            tag = "disk " + ("fused" if fuse else "unfused")
            incore = repro_torch.plan(n, dataclasses.replace(
                cfg, fuse_columns=fuse)).compile(device=dev)
            incore_s = []
            for _ in range(2):
                t0 = time.perf_counter()
                incore.factor(a, materialize=False)
                incore_s.append(time.perf_counter() - t0)
            ex = SpillTorchExecutor(sched, torch.float32, use_pallas=True,
                                    device=dev, fuse_columns=fuse)
            first, s1, io, launches = spill_run(ex)
            second, s2, _io, _l = spill_run(ex)
            same_groups = spill_groups_in_core(ex, a, dev)
            ok_groups = _lower_equal(same_groups, first)
            ok_incore = _lower_equal(incore.tiles, first)
            d_incore = max(float((incore.tiles[i, :i + 1].double()
                                  - first[i, :i + 1]).abs().max())
                           for i in range(nt)) / amax
            ok_twice = torch.equal(first, second)
            log(f"{tag} [{card}]: disk tier {s1:.3f}s, {s2:.3f}s; in-core "
                f"{incore_s[0]:.3f}s, {incore_s[1]:.3f}s; bitwise the "
                f"in-core executor's factor: {ok_incore} (max|diff|/max|A| "
                f"{d_incore:.3e}, bound {bound:.1e}); bitwise its own groups "
                f"run in core: {ok_groups}; second run bitwise the first: "
                f"{ok_twice}; executed {ex.last_io_stats}; H2D "
                f"{io['h2d_ops']} D2H {io['d2h_ops']}; launches {launches}")
            require(ok_groups, f"{tag}: differs from its groups in core")
            require(ok_incore or fuse,
                    f"{tag}: differs from the in-core factor")
            require(d_incore < bound, f"{tag}: vs in-core {d_incore}")
            require(ok_twice, f"{tag}: two runs differ")
            del same_groups
            require(ex.last_io_stats == want_io,
                    f"{tag}: executed {ex.last_io_stats} != {want_io}")
            require(io["h2d_ops"] == sched.count(OpKind.LOAD)
                    and io["d2h_ops"] == sched.count(OpKind.STORE),
                    f"{tag}: copies {io}")
            out["fused" if fuse else "unfused"] = {
                "disk_s": [s1, s2], "incore_s": incore_s,
                "bitwise_incore": ok_incore, "vs_incore_rel": d_incore,
                "executed": dict(ex.last_io_stats), "copies": io,
                "launches": launches}
            if not fuse:
                # the control: one scheduled SPILL skipped
                spills = [k for k, seg in enumerate(ex._segments)
                          if seg[0] == "io"
                          and seg[1].kind is OpKind.SPILL]
                del ex._segments[spills[len(spills) // 2]]
                bad, _s, _io, _l = spill_run(ex)
                differs = not _lower_equal(incore.tiles, bad)
                log(f"{tag}: control, one SPILL skipped: differs from the "
                    f"in-core factor: {differs}")
                require(differs, f"{tag}: a skipped SPILL went unseen")
                del bad
            del incore, ex, first, second
    del a
    return out


# flash cases: (tag, B, S, T, H, KV, hd, dtype, causal); the first is
# qwen3-14b's prefill shape, the one reported in the kernels line, the
# second dbrx-132b's; both are timed
FLASH_CASES = (
    ("prefill", 4, 2048, 2048, 40, 8, 128, torch.bfloat16, True),
    ("dbrx prefill", 4, 2048, 2048, 48, 8, 128, torch.bfloat16, True),
    ("f32,hd64", 1, 512, 512, 8, 2, 64, torch.float32, True),
    ("f32,hd128", 1, 512, 512, 40, 8, 128, torch.float32, True),
    ("bf16,hd64", 1, 512, 512, 8, 2, 64, torch.bfloat16, True),
    ("bf16,hd192", 1, 512, 512, 96, 8, 192, torch.bfloat16, True),
    ("bf16,hd256", 1, 512, 512, 4, 1, 256, torch.bfloat16, True),
    ("bf16,S=1000", 1, 1000, 1000, 40, 8, 128, torch.bfloat16, True),
    ("f32,full,T!=S", 2, 256, 1024, 40, 8, 128, torch.float32, False),
    ("bf16,full,T!=S", 2, 256, 1024, 40, 8, 128, torch.bfloat16, False),
    ("bf16,long KV", 1, 128, 16384, 40, 8, 128, torch.bfloat16, False),
)
# tests/test_flash_attention.py's tolerances
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# Each output row (hd values) is also held at its own scale: the output's
# rounding, one ulp of the row's largest value (2^-7 in bf16, 2^-23 in
# f32), plus the two summation orders of a weighted mean of v in f32,
# FLASH_ACC x 2^-24 x max|v|.  The card's worst f32 error, 4.6e-7 at
# T != S (NVIDIA H100 80GB HBM3, 700 W, benchmarks/torch_lm_bounds.py),
# is below 2 x 2^-24 max|v|; a dropped KV tile reads 32 or more times the
# allowance.
FLASH_ROW_TOL = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}
FLASH_ACC = 8
FLASH_DROP = 64     # keys the dropped-tile control leaves out
# A bf16 output is also held by the share of its values that differ from
# the plain version's (both rounded to bf16 from f32): a sound kernel moves
# a value across a rounding boundary only where its f32 sum lies within its
# own error of one. The row check passes a kernel whose P is rounded to
# bf16 before P V (2^-9 of each p); this check does not. The card's
# readings over seeds 0-2 (benchmarks/torch_lm_bounds.py, NVIDIA H100 80GB
# HBM3, 700 W): the tensor-core kernel 0.0021-0.0027, and 0.0170-0.0172 at
# long KV (T = 16384, whose outputs are small beside the errors of their
# sums); the FFMA kernel on the same bf16 inputs (P in f32, another order)
# 0.0001-0.0004, and 0.0012-0.0013 at long KV; the control, the plain
# version with P rounded to bf16, 0.381-0.424. The bound is 2.9 times the
# worst sound reading and 7.6 times below the least control, which must
# read above it in every bf16 case.
FLASH_MISMATCH_BOUND = 0.05


def _flash_pairs(s, t, causal):
    """(qi, kj) pairs the mask keeps: rows qi see min(qi + 1, T) keys."""
    if not causal:
        return s * t
    return t * (t + 1) // 2 + (s - t) * t if s >= t else s * (s + 1) // 2


def _flash_cost(b, s, t, h, kv, hd, dt, causal):
    """Least time of one call over the (qi, kj) pairs the mask keeps. bf16:
    three products on the tensor cores at the bf16 peak (Q K^T, P_hi V,
    P_lo V); ``bound_ffma_pv_ms`` is the bound of the FFMA kernel's design
    (Q K^T at the bf16 peak, P V in f32 FFMA). f32: two products at the f32
    peak. Bytes: q, k, v and o once each."""
    per = 2.0 * b * h * _flash_pairs(s, t, causal) * hd
    itemsize = torch.finfo(dt).bits // 8
    nbytes = (2 * b * s * h + 2 * b * t * kv) * hd * itemsize
    bound_b = nbytes / PEAK_HBM_BYTES * 1e3
    if dt == torch.bfloat16:
        flops = 3 * per
        bound_f = flops / PEAK_BF16_FLOPS * 1e3
        ffma_pv = max(bound_b, (per / PEAK_BF16_FLOPS + per / PEAK_F32_FLOPS)
                      * 1e3)
    else:
        flops = 2 * per
        bound_f = flops / PEAK_F32_FLOPS * 1e3
        ffma_pv = max(bound_f, bound_b)
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes",
            "bound_ffma_pv_ms": ffma_pv}


def _mismatch_share(got, want) -> float:
    """Share of the outputs whose values differ (NaN counts as differing)."""
    return float((got != want).float().mean())


def _flash_row_ratio(got, want, v, tol):
    """The worst output row's max|got - want| over its allowance: ``tol``
    times that row's max|want|, plus FLASH_ACC f32 quanta of max|v|."""
    err = (got.double() - want.double()).abs().amax(dim=-1)
    allow = (tol * want.double().abs().amax(dim=-1)
             + FLASH_ACC * 2.0 ** -24 * float(v.abs().max()))
    return float((err / allow).max())


def flash_checks(dev, g) -> dict:
    """The flash kernel against its plain version at every case, each row
    at its own scale, with two controls that must fail that check: a zeroed
    output, and the plain version without the last FLASH_DROP keys (a
    kernel that drops its last KV tile).  A bf16 case is also held by its
    mismatch share, which the plain version with P rounded to bf16 must
    fail.  q and k are unit normals, so the scores spread by about 1 and
    each row is a weighted mean of v that a dropped tile moves.  The
    prefill shape is timed beside the FFMA kernel, the plain version and
    PyTorch's SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    results = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # plain version in f32
    try:
        for tag, b, s, t, h, kv, hd, dt, causal in FLASH_CASES:
            q, k, v = (torch.randn(*shape, generator=g, device=dev).to(dt)
                       for shape in ((b, s, h, hd), (b, t, kv, hd),
                                     (b, t, kv, hd)))
            blk = {"bq": s, "bk": t}     # any S and T (the kernels tile alone)
            ops.reset_counts()
            got = fa.flash_gqa(q, k, v, causal=causal, **blk)
            want = fa.flash_gqa_ref(q, k, v, causal=causal, **blk)
            torch.cuda.synchronize()
            kind = fa.variant(dt)
            require(ops.flash_variant_counts() == {
                **dict.fromkeys(fa.variant_launches, 0), kind: 1},
                f"flash_attention[{tag}] variants "
                f"{ops.flash_variant_counts()}, want one {kind}")
            err = float((got.double() - want.double()).abs().max())
            tol, row_tol = FLASH_TOL[dt], FLASH_ROW_TOL[dt]
            torch.testing.assert_close(
                got.double(), want.double(), atol=tol, rtol=tol,
                msg=lambda m, tag=tag: f"flash_attention[{tag}]: {m}")
            ratio = _flash_row_ratio(got, want, v, row_tol)
            dropped = fa.flash_gqa_ref(q, k[:, :-FLASH_DROP],
                                       v[:, :-FLASH_DROP], causal=causal,
                                       bq=s, bk=t - FLASH_DROP)
            ctrl_drop = _flash_row_ratio(got, dropped, v, row_tol)
            ctrl_zero = _flash_row_ratio(torch.zeros_like(got), want, v,
                                         row_tol)
            del dropped
            require(ratio <= 1.0, f"flash_attention[{tag}] row ratio {ratio}")
            require(ctrl_drop > 1.0 and ctrl_zero > 1.0,
                    f"flash_attention[{tag}] row check passes a control "
                    f"(dropped tile {ctrl_drop}, zeroed {ctrl_zero})")
            row = {"shape": [b, s, t, h, kv, hd], "dtype": str(dt)[6:],
                   "causal": causal, "variant": kind, "max_abs_err": err,
                   "atol": tol, "rtol": tol, "tol_per_row": row_tol,
                   "row_ratio": ratio,
                   "err_in_f32_quanta_of_max_v":
                       err / (2.0 ** -24 * float(v.abs().max())),
                   "control_dropped_tile_ratio": ctrl_drop,
                   "control_zeroed_ratio": ctrl_zero,
                   **_flash_cost(b, s, t, h, kv, hd, dt, causal)}
            if dt == torch.bfloat16:
                share = _mismatch_share(got, want)
                ctrl_p = _mismatch_share(fa.flash_gqa_ref(
                    q, k, v, causal=causal, p_mode="bf16", **blk), want)
                # a sound reading beside it: the FFMA kernel keeps P in f32
                # and differs from the plain version only in its order
                ffma_share = _mismatch_share(fa.flash_gqa(
                    q, k, v, causal=causal, kernel="ffma", **blk), want)
                require(share <= FLASH_MISMATCH_BOUND,
                        f"flash_attention[{tag}] mismatch share {share} > "
                        f"{FLASH_MISMATCH_BOUND}")
                require(ctrl_p > FLASH_MISMATCH_BOUND,
                        f"flash_attention[{tag}] mismatch check passes the "
                        f"bf16-P control ({ctrl_p})")
                row.update({"mismatch_share": share,
                            "mismatch_bound": FLASH_MISMATCH_BOUND,
                            "ffma_mismatch_share": ffma_share,
                            "control_bf16_p_mismatch_share": ctrl_p})
            if tag in ("prefill", "dbrx prefill"):
                del got, want
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                row.update({
                    "ms": time_ms(lambda: fa.flash_gqa(q, k, v), 20),
                    "ffma_ms": time_ms(
                        lambda: fa.flash_gqa(q, k, v, kernel="ffma"), 5),
                    "device_ms": device_ms(lambda: fa.flash_gqa(q, k, v)),
                    "plain_ms": time_ms(lambda: fa.flash_gqa_ref(q, k, v),
                                        3, 1),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True), 20),
                    "library": "F.scaled_dot_product_attention(is_causal, "
                               "enable_gqa), bf16 P"})
                row["library_device_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True))
                row["tflops"] = row["flops"] / row["ms"] / 1e9
            results[f"flash_attention[{tag}]"] = row
            log(f"kernel flash_attention[{tag}]: " + json.dumps(row))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return results


# Bounds on max|logit difference| / max|logit| at the last position, set
# between the sound readings and the faults that must fail them (seeds 0-2,
# NVIDIA H100 80GB HBM3, 700 W, benchmarks/torch_lm_bounds.py): flash
# against its plain version reads 0.0166-0.0175 (the attention output's
# bf16 rounding in each layer); the flash prefill against the decode replay
# 0.0190-0.0232 (also the MLP's matmul shapes and the replay's bf16 softmax
# weights); the faults read 1.19 or more.  Each bound is 3 times the worst
# sound reading.
PREFILL_REL_BOUND = 0.05
REPLAY_REL_BOUND = 0.07
DECODE_WINDOWS = 5      # timed decode windows beside generate's own


def _logit_diff(got, want, vocab):
    """max|got - want| over the real vocabulary, max|want|, and the rows
    whose top-1 token agrees."""
    got, want = got[:, :vocab].float(), want[:, :vocab].float()
    diff = float((got - want).abs().max())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    return diff, float(want.abs().max()), same


def flash_faults() -> dict:
    """Faults the logit checks must catch, each passed as a prefill's
    attention: the flash kernel without its causal mask, and the
    attention's output dropped."""
    from repro_torch.kernels.flash_attention import flash_gqa
    return {
        "no causal mask": lambda q, k, v, **kw: flash_gqa(
            q, k, v, **{**kw, "causal": False}),
        "attention dropped": lambda q, k, v, **kw: torch.zeros_like(q)}


def timed_prefill(cfg, params, tokens, want_launches: dict,
                  want_variants: dict, tag: str, extra: dict | None = None):
    """Two prefill steps of ``tokens`` (and the batch's ``extra`` inputs:
    frontend embeddings, encoder frames), each timed and its launches held
    to ``want_launches`` (every kernel of the port) and its flash variants
    to ``want_variants``.  Returns (logits, seconds, launches, variants)."""
    import repro_torch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    prefill = make_prefill_step(cfg)
    seconds, launches, variants = [], None, None
    for _ in range(2):
        repro_torch.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens, **(extra or {})})
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = repro_torch.launch_counts()
        variants = ops.flash_variant_counts()
        require(launches == want_launches,
                f"{tag} prefill launches {launches} != {want_launches}")
        require(variants == want_variants,
                f"{tag} prefill flash variants {variants} != {want_variants}")
    v = cfg.vocab
    require(tuple(logits.shape) == (tokens.shape[0], cfg.padded_vocab),
            f"{tag} prefill logits {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits[:, :v]).all()),
            f"{tag} prefill logits finite")
    require(bool((logits[:, v:] <= -1e29).all()),
            f"{tag} padding columns masked")
    return logits, seconds, launches, variants


def decode_windows(params, cfg, batch: int, prompt_len: int, gen_len: int,
                   tok, windows: int, enc_out=None) -> list:
    """Decode tokens/s of ``windows`` windows of ``gen_len - 1`` greedy
    steps from ``tok`` at positions ``prompt_len`` on, through the serve
    step on a fresh cache (cross-attending to ``enc_out`` if given)."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import dtype_of
    serve = make_serve_step(cfg)
    cache = T.init_cache(cfg, batch, prompt_len + gen_len,
                         dtype_of(cfg.dtype), tok.device)
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(prompt_len, prompt_len + gen_len - 1):
            step_logits, cache = serve(params, cache, tok, pos, enc_out)
            tok = torch.argmax(step_logits[..., :cfg.vocab], dim=-1)
        torch.cuda.synchronize()
        out.append(batch * (gen_len - 1) / (time.perf_counter() - t0))
    return out


def lm_serving(dev, seed: int) -> dict:
    """qwen3-14b's serving path: prefill through the flash kernel, the same
    step with the plain attention, and the decode server."""
    import dataclasses

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_gqa_ref
    from repro_torch.launch.serve import decode_tokens
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("qwen3-14b"), use_flash_attention=True)
    n_layers = cfg.num_layers
    faults = flash_faults()
    only_flash = {**dict.fromkeys(repro_torch.launch_counts(), 0),
                  "flash_attention": n_layers}
    # every layer on the tensor cores: bf16 at hd 128
    only_tc = {"tensor_core": n_layers, "ffma": 0}

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = torch.cuda.memory_allocated(dev) / 1e9
    log(f"lm: {cfg.name} {n_layers} layers d_model {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.head_dim}, "
        f"{sum(p.numel() for p in params.parameters()):,} parameters "
        f"({param_gb:.2f} GB f32) made in {init_s:.2f}s")
    g = torch.Generator(device=dev).manual_seed(seed + 2)

    # prefill: 4 x 2048 tokens, flash at bq = bk = 512
    batch, seq = 4, 2048
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev)
    logits, prefill_s, launches, variants = timed_prefill(
        cfg, params, tokens, only_flash, only_tc, cfg.name)
    v = cfg.vocab
    tok_s = batch * seq / prefill_s[-1]
    log(f"lm: prefill {batch}x{seq} in {prefill_s[0]:.3f}s then "
        f"{prefill_s[1]:.3f}s ({tok_s:.0f} tokens/s); launches per step "
        f"{launches}")

    # the same step with the plain attention passed in
    t0 = time.perf_counter()
    plain = make_prefill_step(cfg, flash=flash_gqa_ref)(params,
                                                         {"tokens": tokens})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff, scale, same = _logit_diff(logits, plain, v)
    log(f"lm: prefill with flash_gqa_ref {plain_s:.3f}s; last-position "
        f"logits max|flash - plain| = {diff:.4e} = {diff / scale:.4f} x "
        f"max|logit| {scale:.3f} (bound {PREFILL_REL_BOUND:.4f}); top-1 "
        f"agrees in {same}/{batch} rows")
    require(diff <= PREFILL_REL_BOUND * scale, f"prefill vs plain {diff}")
    del logits
    controls = {}
    for name, attn in faults.items():
        bad = make_prefill_step(cfg, flash=attn)(params, {"tokens": tokens})
        cd, _, csame = _logit_diff(bad, plain, v)
        controls[name] = {"rel_diff": cd / scale, "top1_agree": csame}
        log(f"lm: control {name}: max|control - plain| = {cd / scale:.4f} x "
            f"max|logit| (must exceed {PREFILL_REL_BOUND:.4f}); top-1 agrees "
            f"in {csame}/{batch} rows")
        require(cd > PREFILL_REL_BOUND * scale,
                f"prefill check passes the {name} control ({cd})")
        del bad
    del plain

    # serve: replay a 128-token prompt through decode, 16 greedy tokens
    prompt_len, gen_len = 128, 16
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                            device=dev)
    repro_torch.reset_counts()
    t0 = time.perf_counter()
    out_tokens, decode_tok_s, replay_logits = decode_tokens(
        params, cfg, prompts, gen_len)
    serve_s = time.perf_counter() - t0
    decode_launches = repro_torch.launch_counts()
    require(set(decode_launches.values()) == {0},
            f"decode launched kernels {decode_launches}")
    require(out_tokens.shape == (batch, gen_len)
            and int(out_tokens.min()) >= 0 and int(out_tokens.max()) < v,
            f"generated tokens {out_tokens.shape}")
    # more windows of the same gen_len - 1 steps, through the serve step
    tok = torch.as_tensor(out_tokens[:, -1:], device=dev)
    windows = [decode_tok_s] + decode_windows(
        params, cfg, batch, prompt_len, gen_len, tok, DECODE_WINDOWS)
    decode_median = statistics.median(windows)
    step_ms = batch / decode_median * 1e3
    log(f"lm: serve {batch} x ({prompt_len} prompt + {gen_len} generated) in "
        f"{serve_s:.2f}s; decode over {len(windows)} windows of "
        f"{gen_len - 1} steps: median {decode_median:.1f} tokens/s "
        f"({step_ms:.1f} ms a step), min {min(windows):.1f}, max "
        f"{max(windows):.1f}")

    repro_torch.reset_counts()
    short = make_prefill_step(cfg)(params, {"tokens": prompts})
    torch.cuda.synchronize()
    short_launches = repro_torch.launch_counts()
    require(short_launches == only_flash,
            f"prefill-128 launches {short_launches} != {only_flash}")
    require(ops.flash_variant_counts() == only_tc,
            f"prefill-128 flash variants {ops.flash_variant_counts()}")
    replay = replay_logits[:, 0]
    diff128, scale128, same128 = _logit_diff(short, replay, v)
    log(f"lm: flash prefill of the prompt vs the decode replay at position "
        f"{prompt_len - 1}: max|diff| = {diff128:.4e} = "
        f"{diff128 / scale128:.4f} x max|logit| {scale128:.3f} (bound "
        f"{REPLAY_REL_BOUND:.4f}); argmax agrees in {same128}/{batch}")
    require(diff128 <= REPLAY_REL_BOUND * scale128,
            f"prefill vs replay {diff128}")
    controls128 = {}
    for name, attn in faults.items():
        bad = make_prefill_step(cfg, flash=attn)(params, {"tokens": prompts})
        cd, _, csame = _logit_diff(bad, replay, v)
        controls128[name] = {"rel_diff": cd / scale128, "top1_agree": csame}
        log(f"lm: control {name} vs the replay: {cd / scale128:.4f} x "
            f"max|logit| (must exceed {REPLAY_REL_BOUND:.4f}); argmax agrees "
            f"in {csame}/{batch}")
        require(cd > REPLAY_REL_BOUND * scale128,
                f"replay check passes the {name} control ({cd})")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"lm: peak device memory {peak_gb:.2f} GB")
    del params
    return {"model": cfg.name, "layers": n_layers, "init_s": init_s,
            "param_gb": param_gb, "prefill_batch": batch, "prefill_seq": seq,
            "prefill_s": prefill_s, "prefill_tokens_per_s": tok_s,
            "prefill_launches": launches,
            "prefill_flash_variants": variants, "plain_prefill_s": plain_s,
            "logit_rel_bound": PREFILL_REL_BOUND,
            "replay_logit_rel_bound": REPLAY_REL_BOUND,
            "prefill_controls": controls, "replay_controls": controls128,
            "prefill_vs_plain_max_diff": diff, "prefill_max_logit": scale,
            "prefill_vs_plain_top1_agree": same,
            "serve_prompt_len": prompt_len, "serve_gen_len": gen_len,
            "serve_s": serve_s, "decode_tokens_per_s": decode_median,
            "decode_window_tokens_per_s": windows,
            "decode_step_ms": step_ms, "decode_launches": decode_launches,
            "prefill128_launches": short_launches,
            "prefill128_vs_replay_max_diff": diff128,
            "prefill128_max_logit": scale128,
            "prefill128_vs_replay_argmax_agree": same128,
            "peak_gb": peak_gb}


# Phase 10b, MoE and MLA serving.  deepseek-v2-lite-16b at its published
# widths and depth (MLA in every layer, a dense first layer, 2 shared and 64
# routed experts top-6 after it), and dbrx-132b at its published widths with
# DBRX_LAYERS of its 40 layers (GQA through the flash kernel, 16 routed
# experts top-4): its 40 layers hold 526 GB of f32 weights, 2 hold 31.0 GB.
MOE_PREFILL = (4, 2048)          # the timed prefill's batch and sequence
DBRX_LAYERS = 2
DEEPSEEK_PARAMS = 15_706_484_224  # the reference's abstract init's count
# Bounds on max|logit difference| / max|logit| between a 128-token prompt's
# prefill and its decode replay, both at a dropless capacity (the config's
# 1.25 may drop assignments in a prefill that one-token decode steps never
# drop), each 3 times the worst sound reading over seeds 0-2
# (benchmarks/torch_lm_bounds.py --moe, NVIDIA H100 80GB HBM3, 700 W).
# dbrx in bf16, its served type: 0.0163-0.0398; its controls 0.72 or more.
# deepseek in bf16 read 0.066-0.140 (one row's argmax differing), its
# controls 0.47 or more, which leaves no room for a bound.  The suspect (not
# counted): bf16 roundings that differ between the two paths flip top-6
# choices among 64 experts in 26 routed layers, and a flipped token's
# output moves by a whole expert's share.  In f32 a flip needs a top-k
# margin within f32's roundoff, and the same check read 3.35e-6 to 4.00e-6
# with the same controls, so deepseek's replay is held with f32
# activations and its bf16 reading is logged.
MOE_REPLAY_REL_BOUND = 0.12
DEEPSEEK_REPLAY_F32_REL_BOUND = 1.2e-5
# One MoE layer in f32 against the per-token plain mix written out expert by
# expert: f32 products over d = 2048 and f = 1408 and sums of 8 gated terms
# in other orders, about 2^-24 sqrt(2048) of the output's scale; the bound
# is max|diff| <= MIX_REL_TOL max|plain|.  The card read 7.3e-7 to 1.06e-6
# over seeds 0-2.  The same layer at capacity MIX_CONTROL_CF, where an
# expert holds its mean load and the busier ones drop assignments, must fail
# it (it read 0.40 or more).
MIX_REL_TOL = 1e-5
MIX_TOKENS = 512
MIX_CONTROL_CF = 1.0


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn`` for the block's duration (a
    control's fault; the package has no option for it)."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def moe_drop_share(p, cfg, x, cf: float) -> tuple:
    """The share of ``x``'s assignments that a capacity factor ``cf`` drops
    in the MoE layer ``p``, counted here from its router (each expert keeps
    at most its capacity), and the port's dispatch's own kept count."""
    from repro_torch.models import moe as M
    xt = x.reshape(-1, x.shape[-1])
    t, k, e = xt.shape[0], cfg.top_k, cfg.n_experts
    probs = torch.softmax(xt.float() @ p.router.float(), dim=-1)
    idx = torch.topk(probs, k, dim=-1).indices
    cap = M.capacity(t, k, e, cf)
    counts = torch.bincount(idx.reshape(-1), minlength=e)
    kept = int(counts.clamp(max=cap).sum())
    _, port_idx = M.route(p, cfg, xt)
    port_kept = int(M._dispatch(xt, port_idx, 1, e, cap)[2].sum())
    return 1.0 - kept / (t * k), kept, port_kept, cap


def first_moe_call(run):
    """``run()`` with the port's ``apply_moe`` wrapped to keep its first
    call's layer and input; returns (run's result, (layer, input))."""
    from repro_torch.models import moe as M
    seen = []
    orig = M.apply_moe

    def keep(p, cfg, x, *args, **kw):
        if not seen:
            seen.append((p, x.clone()))
        return orig(p, cfg, x, *args, **kw)
    with swapped(M, "apply_moe", keep):
        out = run()
    return out, seen[0]


def moe_layer_vs_plain_mix(p, cfg, x) -> dict:
    """One MoE layer at full width in f32 on ``x``'s tokens at ample
    capacity (every expert holds all its assignments) against the per-token
    plain mix, expert by expert plus the shared experts; twice, bitwise; the
    same layer at capacity MIX_CONTROL_CF must fail the check."""
    from types import SimpleNamespace

    from repro_torch.models import moe as M
    from repro_torch.models.layers import apply_mlp
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 off for f32")
    xt = x.reshape(-1, x.shape[-1]).float()
    e, k = cfg.n_experts, cfg.top_k
    ample = e / k                      # cap = the tokens: nothing dropped
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = M.apply_moe(p, cfg, xt[None], capacity_factor=ample)[0]
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    again = M.apply_moe(p, cfg, xt[None], capacity_factor=ample)[0]
    share, _, _, _ = moe_drop_share(p, cfg, xt, ample)
    require(share == 0.0, f"ample capacity drops {share}")
    gates, idx = M.route(p, cfg, xt)
    want = torch.zeros_like(xt)
    for j in range(e):
        pe = SimpleNamespace(wi=p.wi[j], wo=p.wo[j], wg=p.wg[j])
        w = ((idx == j) * gates).sum(-1)[:, None]
        want = want + w * apply_mlp(pe, xt, cfg.mlp_act)
    if cfg.n_shared_experts:
        want = want + apply_mlp(SimpleNamespace(
            wi=p.shared_wi, wo=p.shared_wo, wg=p.shared_wg), xt, cfg.mlp_act)
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    dropped = M.apply_moe(p, cfg, xt[None], capacity_factor=MIX_CONTROL_CF)[0]
    cdiff = float((dropped - want).abs().max())
    cshare = moe_drop_share(p, cfg, xt, MIX_CONTROL_CF)[0]
    out = {"tokens": xt.shape[0], "max_abs_err": diff, "max_abs": scale,
           "rel_err": diff / scale, "rel_tol": MIX_REL_TOL,
           "bitwise_run_to_run": bool(torch.equal(got, again)),
           "port_s": port_s, "control_capacity": MIX_CONTROL_CF,
           "control_drop_share": cshare, "control_rel_err": cdiff / scale}
    log(f"moe: one {cfg.name} MoE layer in f32 on {xt.shape[0]} tokens at "
        f"ample capacity vs the plain mix: max|diff| {diff:.3e} = "
        f"{diff / scale:.3e} x max|out| {scale:.3f} (bound {MIX_REL_TOL:.0e}); "
        f"run to run bitwise {out['bitwise_run_to_run']}; control at "
        f"capacity {MIX_CONTROL_CF} (drops {cshare:.4f}): "
        f"{cdiff / scale:.3e} (must exceed the bound)")
    require(diff <= MIX_REL_TOL * scale, f"MoE layer vs plain mix {diff}")
    require(out["bitwise_run_to_run"], "MoE layer run to run")
    require(cdiff > MIX_REL_TOL * scale,
            f"the plain-mix check passes the capacity control ({cdiff})")
    return out


def moe_replay(cfg, params, prompts, gen_len: int, controls: dict,
               flash, bound) -> dict:
    """The last-position logits of ``prompts``' prefill against their
    decode replay (``decode_tokens``), both at a dropless capacity, within
    ``bound`` (None: logged only); each control, (flash, context) for the
    prefill, must exceed it.  Returns the reading and the replay's
    generated tokens."""
    import dataclasses

    from repro_torch.launch.serve import decode_tokens
    from repro_torch.launch.steps import make_prefill_step
    dropless = dataclasses.replace(cfg, moe_capacity=float(cfg.n_experts))
    v = cfg.vocab
    short = make_prefill_step(dropless, flash=flash)(params,
                                                     {"tokens": prompts})
    t0 = time.perf_counter()
    tokens, tok_s, replay_logits = decode_tokens(params, dropless, prompts,
                                                 gen_len)
    serve_s = time.perf_counter() - t0
    replay = replay_logits[:, 0]
    diff, scale, same = _logit_diff(short, replay, v)
    log(f"moe: {cfg.name} prefill of a {prompts.shape[1]}-token prompt vs "
        f"its decode replay, dropless, {cfg.dtype}: max|diff| {diff:.4e} = "
        f"{diff / scale:.4e} x max|logit| {scale:.3f} (bound {bound}); "
        f"argmax agrees in {same}/{prompts.shape[0]}")
    require(bound is None or diff <= bound * scale,
            f"{cfg.name} prefill vs replay {diff}")
    out = {"dtype": cfg.dtype, "rel_diff": diff / scale, "max_logit": scale,
           "argmax_agree": same, "bound": bound, "serve_s": serve_s,
           "replay_tokens_per_s": tok_s, "controls": {}}
    for name, (cflash, ctx) in controls.items():
        with ctx():
            bad = make_prefill_step(dropless, flash=cflash)(
                params, {"tokens": prompts})
        cd, _, csame = _logit_diff(bad, replay, v)
        out["controls"][name] = {"rel_diff": cd / scale, "argmax_agree": csame}
        log(f"moe: {cfg.name} control {name} vs the replay: "
            f"{cd / scale:.4f} x max|logit| (must exceed {bound}); argmax "
            f"agrees in {csame}/{prompts.shape[0]}")
        require(cd > bound * scale,
                f"{cfg.name} replay check passes the {name} control ({cd})")
        del bad
    return out, tokens


def prefill_vs_plain(cfg, params, batch: dict, logits, tag: str,
                     controls: dict | None = None) -> dict:
    """A flash prefill step's ``logits`` on ``batch`` against the same step
    with the plain attention, within PREFILL_REL_BOUND; the flash faults
    and ``controls`` (name -> (params, batch) -> logits) must fail that
    check."""
    from repro_torch.kernels.flash_attention import flash_gqa_ref
    from repro_torch.launch.steps import make_prefill_step
    plain = make_prefill_step(cfg, flash=flash_gqa_ref)(params, batch)
    diff, scale, same = _logit_diff(logits, plain, cfg.vocab)
    log(f"{tag}: {cfg.name} prefill with flash_gqa_ref: max|flash - plain| "
        f"= {diff / scale:.4f} x max|logit| {scale:.3f} (bound "
        f"{PREFILL_REL_BOUND:.4f}); top-1 agrees in {same}/{logits.shape[0]}")
    require(diff <= PREFILL_REL_BOUND * scale,
            f"{cfg.name} prefill vs plain {diff}")
    out = {"prefill_vs_plain_rel": diff / scale, "prefill_controls": {}}
    faults = {name: (lambda p, b, f=attn: make_prefill_step(cfg, flash=f)(
        p, b)) for name, attn in flash_faults().items()}
    for name, run in {**faults, **(controls or {})}.items():
        bad = run(params, batch)
        cd = _logit_diff(bad, plain, cfg.vocab)[0]
        out["prefill_controls"][name] = cd / scale
        log(f"{tag}: {cfg.name} control {name} vs plain: {cd / scale:.4f} x "
            f"max|logit| (must exceed {PREFILL_REL_BOUND:.4f})")
        require(cd > PREFILL_REL_BOUND * scale,
                f"{cfg.name} prefill check passes the {name} control")
        del bad
    return out


def serve_moe_model(cfg, dev, seed: int, controls: dict,
                    replay_bound: float, replay_dtype: str | None = None,
                    mix_check: bool = False) -> dict:
    """One MoE model on the card: parameters from ``seed``, the timed
    prefill, the capacity's drops, the replay check and its controls
    (with ``replay_dtype`` activations, the bf16 replay then logged), and
    decode windows; with ``mix_check`` its first MoE layer against the
    plain mix."""
    import dataclasses

    import repro_torch
    from repro_torch.kernels.flash_attention import flash_gqa
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    n_flash = cfg.num_layers if cfg.use_flash_attention and not cfg.mla else 0
    want_launches = {**dict.fromkeys(repro_torch.launch_counts(), 0),
                     "flash_attention": n_flash}
    want_variants = {"tensor_core": n_flash, "ffma": 0}

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_gb = torch.cuda.memory_allocated(dev) / 1e9
    log(f"moe: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model}, "
        f"{'MLA' if cfg.mla else 'GQA'}, {cfg.n_experts} experts top-"
        f"{cfg.top_k} (+{cfg.n_shared_experts} shared), {n_params:,} "
        f"parameters ({param_gb:.2f} GB f32) made in {init_s:.2f}s")
    out = {"model": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "param_gb": param_gb, "init_s": init_s}
    g = torch.Generator(device=dev).manual_seed(seed + 2)

    # the timed prefill at the config's capacity, and what it drops in the
    # first MoE layer
    batch, seq = MOE_PREFILL
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev)
    (logits, prefill_s, launches, variants), (moe_p, moe_x) = first_moe_call(
        lambda: timed_prefill(cfg, params, tokens, want_launches,
                              want_variants, cfg.name))
    share, kept, port_kept, cap = moe_drop_share(moe_p, cfg, moe_x,
                                                 cfg.moe_capacity)
    require(kept == port_kept, f"dispatch keeps {port_kept}, count {kept}")
    log(f"moe: {cfg.name} prefill {batch}x{seq} in {prefill_s[0]:.3f}s then "
        f"{prefill_s[1]:.3f}s ({batch * seq / prefill_s[1]:.0f} tokens/s); "
        f"launches {launches}; capacity {cfg.moe_capacity} ({cap} slots) "
        f"drops {share:.4f} of the first MoE layer's assignments")
    out.update({"prefill_batch": batch, "prefill_seq": seq,
                "prefill_s": prefill_s,
                "prefill_tokens_per_s": batch * seq / prefill_s[1],
                "prefill_launches": launches,
                "prefill_flash_variants": variants,
                "prefill_drop_share": share, "prefill_capacity_slots": cap})
    if n_flash:
        out.update(prefill_vs_plain(cfg, params, {"tokens": tokens}, logits,
                                    "moe"))
    del logits

    # a 128-token prompt: the config's capacity beside the dropless one,
    # then the replay check
    prompt_len, gen_len = 128, 16
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                            device=dev)
    at_cfg, (moe_p, moe_x) = first_moe_call(lambda: make_prefill_step(cfg)(
        params, {"tokens": prompts}))
    dropless = make_prefill_step(dataclasses.replace(
        cfg, moe_capacity=float(cfg.n_experts)))(params, {"tokens": prompts})
    cdiff, cscale, csame = _logit_diff(at_cfg, dropless, cfg.vocab)
    share128 = moe_drop_share(moe_p, cfg, moe_x, cfg.moe_capacity)[0]
    log(f"moe: {cfg.name} {batch}x{prompt_len} prefill at capacity "
        f"{cfg.moe_capacity} (drops {share128:.4f} in the first MoE layer) vs "
        f"dropless: max|diff| {cdiff / cscale:.4f} x max|logit|; argmax "
        f"agrees in {csame}/{batch}")
    out["prompt_capacity"] = {"drop_share": share128,
                              "rel_diff_vs_dropless": cdiff / cscale,
                              "argmax_agree": csame}
    if mix_check:
        out["moe_layer_vs_plain_mix"] = moe_layer_vs_plain_mix(
            moe_p, cfg, moe_x.reshape(-1, cfg.d_model)[:MIX_TOKENS])
    del at_cfg, dropless, moe_x
    checked = (cfg if replay_dtype is None
               else dataclasses.replace(cfg, dtype=replay_dtype))
    out["replay"], gen_tokens = moe_replay(checked, params, prompts, gen_len,
                                           controls, flash_gqa, replay_bound)
    if replay_dtype is not None:
        out["replay_served_dtype"], gen_tokens = moe_replay(
            cfg, params, prompts, gen_len, {}, flash_gqa, None)
    require(gen_tokens.shape == (batch, gen_len)
            and int(gen_tokens.min()) >= 0
            and int(gen_tokens.max()) < cfg.vocab,
            f"{cfg.name} generated tokens {gen_tokens.shape}")

    # decode at the config's capacity
    tok = torch.as_tensor(gen_tokens[:, -1:], device=dev)
    repro_torch.reset_counts()
    windows = decode_windows(params, cfg, batch, prompt_len, gen_len, tok,
                             DECODE_WINDOWS + 1)
    decode_launches = repro_torch.launch_counts()
    require(set(decode_launches.values()) == {0},
            f"{cfg.name} decode launched {decode_launches}")
    median = statistics.median(windows)
    log(f"moe: {cfg.name} decode {batch} x ({prompt_len} + {gen_len}) over "
        f"{len(windows)} windows of {gen_len - 1} steps: median "
        f"{median:.1f} tokens/s ({batch / median * 1e3:.1f} ms a step), min "
        f"{min(windows):.1f}, max {max(windows):.1f}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"moe: {cfg.name} peak device memory {peak_gb:.2f} GB")
    out.update({"serve_prompt_len": prompt_len, "serve_gen_len": gen_len,
                "decode_tokens_per_s": median,
                "decode_window_tokens_per_s": windows,
                "decode_step_ms": batch / median * 1e3, "peak_gb": peak_gb})
    del params
    return out


def moe_mla_serving(dev, seed: int, card: str) -> dict:
    """Phase 10b: deepseek-v2-lite-16b whole, then dbrx-132b cut to
    DBRX_LAYERS layers, each served on the card with its checks."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_gqa
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    t_phase = time.perf_counter()

    def no_routed():
        return swapped(M, "_expert_ffn", lambda p, h, act: torch.zeros_like(h))

    orig_qc, orig_attend = A._mla_qc, A._mla_attend

    def no_rope():
        def qc(*args):
            q_nope, q_rope, c_kv, k_rope = orig_qc(*args)
            return q_nope, torch.zeros_like(q_rope), c_kv, k_rope
        return swapped(A, "_mla_qc", qc)

    def no_mask():
        return swapped(A, "_mla_attend", lambda p, cfg, qn, qr, c, k, mask:
                       orig_attend(p, cfg, qn, qr, c, k,
                                   torch.ones_like(mask)))

    deepseek = get_config("deepseek-v2-lite-16b")
    out = {"card": card, "deepseek": serve_moe_model(
        deepseek, dev, seed, {
            "routed experts zeroed": (flash_gqa, no_routed),
            "MLA rope term dropped": (flash_gqa, no_rope),
            "MLA causal mask dropped": (flash_gqa, no_mask)},
        DEEPSEEK_REPLAY_F32_REL_BOUND, replay_dtype="float32",
        mix_check=True)}
    require(out["deepseek"]["params"] == DEEPSEEK_PARAMS,
            f"deepseek parameters {out['deepseek']['params']:,}")
    torch.cuda.empty_cache()
    dbrx = dataclasses.replace(get_config("dbrx-132b"),
                               num_layers=DBRX_LAYERS,
                               use_flash_attention=True)
    out["dbrx"] = serve_moe_model(dbrx, dev, seed, {
        "routed experts zeroed": (flash_gqa, no_routed),
        "no causal mask": (flash_faults()["no causal mask"],
                           contextlib.nullcontext)},
        MOE_REPLAY_REL_BOUND)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"moe: phase 10b [{card}] took {out['seconds']:.1f}s")
    return out


# Phases 10c and 10d, SSM, hybrid, frontend and encoder-decoder serving.
# mamba2-130m and seamless-m4t-large-v2 at their published widths and
# depths; jamba-1.5-large-398b at its published widths with JAMBA_LAYERS of
# its 72 layers (layer 0 SSM with the dense MLP, layer 1 SSM with the
# 16-expert top-2 MoE): its attention layer is the 8th of each group of 8,
# and the smallest cut that reaches it, 8 layers, holds 180.6 GB of f32
# weights (2 hold 48.6 GB); the whole interleave is held at smoke size on
# the card against the CPU (tests/test_torch_cuda.py).  llava-next-34b at
# its published widths with LLAVA_LAYERS of its 60 layers (39.5 GB of f32
# weights; 60 hold 137.6 GB).  The parameter counts are the reference's
# abstract init's at these depths.
MAMBA2_PARAMS = 129_690_048
JAMBA_LAYERS = 2
JAMBA_PARAMS = 12_155_465_728
SEAMLESS_PARAMS = 2_038_556_672
LLAVA_LAYERS = 16
LLAVA_PARAMS = 9_865_239_552
SEAMLESS_PREFILL = (4, 1024)     # and 4 x 1024 encoder frames; the
                                 # others take phase 10b's MOE_PREFILL
# The replay compares the logits at every position of a prompt's prefill
# with the decode replay's, step by step.  The SSM prompts are two chunks
# (512 tokens): with one chunk (256) the inter-chunk term carries no state
# and its control would have nothing to break.  The attention models'
# prompts are 128 tokens, as phase 10's.
SSM_REPLAY_LEN = 512
ATTN_REPLAY_LEN = 128
# Bounds on max|logit difference| / max|logit| of the replay, each 3 times
# the worst sound reading over seeds 0-2 (benchmarks/torch_lm_bounds.py
# --ssm --encdec, NVIDIA H100 80GB HBM3, 700 W).  seamless and llava in
# bf16, their served type: 0.0149-0.0167 and 0.0166-0.0195, every control
# 1.26 or more.  The SSM models in bf16 read 0.238-0.298 (mamba2) and
# 0.210-0.215 (jamba) against controls from 0.29 (jamba's experts zeroed),
# which leaves no room for a bound: the SSD scan and the recurrence round
# bf16 projections of dt, B, C and x in other places, and the state
# carries each difference on.  The reference does the same: in bf16 its
# own prefill and replay differ by more than the port's
# (tests/test_torch_ssm.py::test_bf16_replay_divergence_is_the_references).
# So the SSM replays are held with f32 activations, where they read
# 1.10e-4-1.82e-4 (mamba2; controls 0.90 or more) and 2.88e-5-4.34e-5
# (jamba; its control 0.289 or more), and their bf16 replays are logged.
MAMBA2_REPLAY_F32_REL_BOUND = 5.5e-4
JAMBA_REPLAY_F32_REL_BOUND = 1.3e-4
SEAMLESS_REPLAY_REL_BOUND = 0.050
LLAVA_REPLAY_REL_BOUND = 0.058


def model_inputs(cfg, g, batch: int, dev) -> dict:
    """Seeded model inputs at the token table's scale (1/sqrt(d)): an
    encoder-decoder model's ``frontend_tokens`` encoder frames, or a
    frontend's ``frontend_tokens`` embeddings over the leading positions."""
    from repro_torch.models.layers import dtype_of
    if not (cfg.is_encdec or cfg.frontend):
        return {}
    x = torch.randn(batch, cfg.frontend_tokens, cfg.d_model, generator=g,
                    device=dev) * cfg.d_model ** -0.5
    x = x.to(dtype_of(cfg.dtype))
    return {"enc_embeds" if cfg.is_encdec else "frontend_embeds": x}


def prefill_logits(cfg, params, tokens, extra: dict, flash=None):
    """Logits at every position of the prefill of ``tokens``."""
    from repro_torch.kernels.flash_attention import flash_gqa
    from repro_torch.models import transformer as T
    h = T.forward(params, cfg, tokens, flash=flash or flash_gqa, **extra)
    return T.logits_from_hidden(params, cfg, h)


def replay_logits(cfg, params, tokens, enc_out=None):
    """Logits at every position of ``tokens`` replayed through the serve
    step one token at a time, as ``decode_tokens`` replays a prompt."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import dtype_of
    b, s = tokens.shape
    cache = T.init_cache(cfg, b, s, dtype_of(cfg.dtype), tokens.device)
    serve = make_serve_step(cfg)
    out = []
    for pos in range(s):
        logits, cache = serve(params, cache, tokens[:, pos:pos + 1], pos,
                              enc_out)
        out.append(logits)
    return torch.cat(out, dim=1)


def replay_check(cfg, params, prompts, enc_embeds, controls: dict,
                 bound) -> dict:
    """The logits at every position of ``prompts``' prefill against the
    decode replay's (an encoder-decoder model's replay cross-attends to the
    encoder's output of ``enc_embeds``), within ``bound`` (None: logged
    only).  Each control, (side, context, flash, enc_out), breaks the
    prefill (side "prefill": under ``context(params)``, with ``flash`` as
    its attention if not None) or the replay (side "decode": under the
    context, cross-attending to ``enc_out`` unless it is "same") and must
    exceed the bound."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import dtype_of
    extra, enc_out = {}, None
    if enc_embeds is not None:
        extra = {"enc_embeds": enc_embeds}
        enc_out = T.apply_encoder(params, cfg,
                                  enc_embeds.to(dtype_of(cfg.dtype)))
    v = cfg.vocab
    t0 = time.perf_counter()
    want = replay_logits(cfg, params, prompts, enc_out)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    got = prefill_logits(cfg, params, prompts, extra)
    diff, scale, same = _logit_diff(got.flatten(0, 1), want.flatten(0, 1), v)
    rows = got.shape[0] * got.shape[1]
    log(f"serve: {cfg.name} prefill of a {prompts.shape[1]}-token prompt vs "
        f"its decode replay at every position, {cfg.dtype}: max|diff| "
        f"{diff:.4e} = {diff / scale:.4e} x max|logit| {scale:.3f} (bound "
        f"{bound}); argmax agrees in {same}/{rows} ({replay_s:.2f}s replay)")
    require(bound is None or diff <= bound * scale,
            f"{cfg.name} prefill vs replay {diff}")
    out = {"dtype": cfg.dtype, "rel_diff": diff / scale, "max_logit": scale,
           "argmax_agree": same, "rows": rows, "bound": bound,
           "replay_s": replay_s, "controls": {}}
    for name, (side, ctx, flash, bad_enc) in controls.items():
        with ctx(params):
            if side == "prefill":
                bad = prefill_logits(cfg, params, prompts, extra, flash)
                cd = _logit_diff(bad.flatten(0, 1), want.flatten(0, 1), v)
            else:
                bad = replay_logits(cfg, params, prompts,
                                    enc_out if bad_enc == "same" else bad_enc)
                cd = _logit_diff(got.flatten(0, 1), bad.flatten(0, 1), v)
        out["controls"][name] = {"side": side, "rel_diff": cd[0] / scale,
                                 "argmax_agree": cd[2]}
        log(f"serve: {cfg.name} control {name} ({side}): {cd[0] / scale:.4f}"
            f" x max|logit| (must exceed {bound}); argmax agrees in "
            f"{cd[2]}/{rows}")
        require(bound is not None and cd[0] > bound * scale,
                f"{cfg.name} replay check passes the {name} control")
        del bad
    return out


def serve_model(cfg, dev, seed: int, want_params: int, prefill: tuple,
                replay_len: int, controls: dict, replay_bound: float,
                plain_controls: dict | None = None,
                replay_dtype: str | None = None,
                logged_dtype: str | None = None) -> dict:
    """One model on the card: parameters from ``seed`` (their count held
    to ``want_params``), the timed prefill (its inputs from
    ``model_inputs``; where the model attends through the flash kernel,
    against the same step with the plain attention, with the flash faults
    and ``plain_controls``, name -> (params, step's batch) -> logits, which
    must fail that check), the replay check with ``controls`` at a dropless
    capacity, with ``replay_dtype`` activations if given (the served type's
    replay, and ``logged_dtype``'s if given, then logged), greedy
    tokens through ``decode_tokens`` and decode windows."""
    import dataclasses

    import repro_torch
    from repro_torch.launch.serve import decode_tokens
    from repro_torch.models import transformer as T
    n_flash = cfg.num_layers if cfg.use_flash_attention else 0
    want_launches = {**dict.fromkeys(repro_torch.launch_counts(), 0),
                     "flash_attention": n_flash}
    want_variants = {"tensor_core": n_flash, "ffma": 0}
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_gb = torch.cuda.memory_allocated(dev) / 1e9
    kinds = [cfg.layer_kind(i) + ("+moe" if cfg.layer_is_moe(i) else "")
             for i in params.layer_idx]
    log(f"serve: {cfg.name} {cfg.num_layers} decoder layers "
        f"({', '.join(sorted(set(kinds)))}), {cfg.enc_layers} encoder layers, "
        f"d_model {cfg.d_model}, {n_params:,} parameters ({param_gb:.2f} GB "
        f"f32) made in {init_s:.2f}s")
    require(n_params == want_params,
            f"{cfg.name} parameters {n_params:,} != {want_params:,}")
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "enc_layers": cfg.enc_layers, "params": n_params,
           "param_gb": param_gb, "init_s": init_s, "layer_kinds": kinds}
    g = torch.Generator(device=dev).manual_seed(seed + 2)

    batch, seq = prefill
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev)
    extra = model_inputs(cfg, g, batch, dev)
    logits, prefill_s, launches, variants = timed_prefill(
        cfg, params, tokens, want_launches, want_variants, cfg.name, extra)
    prefill_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"serve: {cfg.name} prefill {batch}x{seq}"
        f"{''.join(f' + {k} {tuple(x.shape)}' for k, x in extra.items())} in "
        f"{prefill_s[0]:.3f}s then {prefill_s[1]:.3f}s "
        f"({batch * seq / prefill_s[1]:.0f} tokens/s); launches {launches}; "
        f"peak device memory {prefill_peak:.2f} GB")
    out.update({"prefill_batch": batch, "prefill_seq": seq,
                "prefill_inputs": {k: list(x.shape) for k, x in extra.items()},
                "prefill_s": prefill_s,
                "prefill_tokens_per_s": batch * seq / prefill_s[1],
                "prefill_launches": launches,
                "prefill_flash_variants": variants,
                "prefill_peak_gb": prefill_peak})
    if n_flash:
        out.update(prefill_vs_plain(cfg, params, {"tokens": tokens, **extra},
                                    logits, "serve", plain_controls))
    del logits

    # the replay: every position of a prompt, at a dropless capacity
    prompts = torch.randint(0, cfg.vocab, (batch, replay_len), generator=g,
                            device=dev)
    frames = model_inputs(cfg, g, batch, dev).get("enc_embeds")
    # (capacity factor E / k: an expert's slots equal the tokens)
    dropless = (dataclasses.replace(cfg, moe_capacity=cfg.n_experts
                                    / cfg.top_k) if cfg.is_moe else cfg)
    checked = replay_dtype or cfg.dtype
    out["replay"] = replay_check(
        dataclasses.replace(dropless, dtype=checked), params, prompts, frames,
        controls, replay_bound)
    out["replay_logged"] = {
        dt: replay_check(dataclasses.replace(dropless, dtype=dt), params,
                         prompts, frames, {}, None)
        for dt in dict.fromkeys((cfg.dtype, logged_dtype))
        if dt is not None and dt != checked}

    # greedy tokens and decode windows at the config's capacity
    enc_out = (None if frames is None
               else T.apply_encoder(params, cfg, frames))
    prompt_len, gen_len = ATTN_REPLAY_LEN, 16
    repro_torch.reset_counts()
    gen_tokens, first_tok_s, _ = decode_tokens(
        params, cfg, prompts[:, :prompt_len], gen_len, enc_out)
    require(gen_tokens.shape == (batch, gen_len)
            and int(gen_tokens.min()) >= 0
            and int(gen_tokens.max()) < cfg.vocab,
            f"{cfg.name} generated tokens {gen_tokens.shape}")
    tok = torch.as_tensor(gen_tokens[:, -1:], device=dev)
    windows = [first_tok_s] + decode_windows(
        params, cfg, batch, prompt_len, gen_len, tok, DECODE_WINDOWS, enc_out)
    decode_launches = repro_torch.launch_counts()
    require(set(decode_launches.values()) == {0},
            f"{cfg.name} decode launched {decode_launches}")
    median = statistics.median(windows)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"serve: {cfg.name} decode {batch} x ({prompt_len} + {gen_len})"
        f"{' with enc_out' if enc_out is not None else ''} over "
        f"{len(windows)} windows of {gen_len - 1} steps: median "
        f"{median:.1f} tokens/s ({batch / median * 1e3:.1f} ms a step), min "
        f"{min(windows):.1f}, max {max(windows):.1f}; peak device memory "
        f"{peak_gb:.2f} GB")
    out.update({"serve_prompt_len": prompt_len, "serve_gen_len": gen_len,
                "decode_tokens_per_s": median,
                "decode_window_tokens_per_s": windows,
                "decode_step_ms": batch / median * 1e3, "peak_gb": peak_gb,
                "seconds": time.perf_counter() - t_model})
    del params
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def zeroed(tensors):
    """``tensors`` zeroed for the block's duration (a control's fault)."""
    saved = [t.clone() for t in tensors]
    for t in tensors:
        t.zero_()
    try:
        yield
    finally:
        for t, s in zip(tensors, saved):
            t.copy_(s)


def _no_fault(params):
    return contextlib.nullcontext()


def ssm_hybrid_serving(dev, seed: int, card: str,
                       logged_dtype: str | None = None) -> dict:
    """Phase 10c: mamba2-130m whole, then jamba-1.5-large-398b cut to
    JAMBA_LAYERS layers, each served on the card with its checks (and its
    replay logged in ``logged_dtype`` too, if given)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import ssm as S
    t_phase = time.perf_counter()
    orig_decode = S.decode_ssm

    def no_inter_chunk(params):
        return swapped(S, "_inter_chunk", lambda acum, cc, prev: cc.new_zeros(
            cc.shape[:3] + prev.shape[2:4]))

    def no_d_skip(params):
        return zeroed([lp.ssm.d_skip for lp in params.layers])

    def unshifted_window(params):
        def decode(p, cfg, x, cache):
            conv = cache["conv"].clone()
            y, cache = orig_decode(p, cfg, x, cache)
            cache["conv"].copy_(conv)
            return y, cache
        return swapped(S, "decode_ssm", decode)

    def no_routed(params):
        return swapped(M, "_expert_ffn", lambda p, h, act: torch.zeros_like(h))

    out = {"card": card, "mamba2": serve_model(
        get_config("mamba2-130m"), dev, seed, MAMBA2_PARAMS, MOE_PREFILL,
        SSM_REPLAY_LEN, {
            "inter-chunk term zeroed": ("prefill", no_inter_chunk, None,
                                        "same"),
            "d_skip dropped": ("prefill", no_d_skip, None, "same"),
            "decode conv window unshifted": ("decode", unshifted_window,
                                             None, "same")},
        MAMBA2_REPLAY_F32_REL_BOUND, replay_dtype="float32",
        logged_dtype=logged_dtype)}
    jamba = dataclasses.replace(get_config("jamba-1-5-large-398b"),
                                num_layers=JAMBA_LAYERS)
    out["jamba"] = serve_model(
        jamba, dev, seed, JAMBA_PARAMS, MOE_PREFILL, SSM_REPLAY_LEN, {
            "routed experts zeroed": ("prefill", no_routed, None, "same")},
        JAMBA_REPLAY_F32_REL_BOUND, replay_dtype="float32",
        logged_dtype=logged_dtype)
    require(out["jamba"]["layer_kinds"] == ["ssm", "ssm+moe"],
            f"jamba's layers {out['jamba']['layer_kinds']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serve: phase 10c [{card}] took {out['seconds']:.1f}s")
    return out


def encdec_frontend_serving(dev, seed: int, card: str,
                            logged_dtype: str | None = None) -> dict:
    """Phase 10d: seamless-m4t-large-v2 whole, then llava-next-34b cut to
    LLAVA_LAYERS layers, both with the flash kernel on their decoders'
    self-attention, each served on the card with its checks (and its
    replay logged in ``logged_dtype`` too, if given)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as A
    t_phase = time.perf_counter()

    def causal_encoder(params):
        def bidir(p, cfg, x, positions):
            q, k, v = A._qkv(p, cfg, x, positions)
            return A._out(p, A._sdpa_chunked(
                q, k, v, causal=True, softcap=cfg.attn_logit_softcap),
                x.dtype)
        return swapped(A, "apply_bidir", bidir)

    seamless = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                                   use_flash_attention=True)
    out = {"card": card, "seamless": serve_model(
        seamless, dev, seed, SEAMLESS_PARAMS, SEAMLESS_PREFILL,
        ATTN_REPLAY_LEN, {
            "cross-attention dropped at decode": ("decode", _no_fault, None,
                                                  None),
            "encoder attention causal": ("prefill", causal_encoder, None,
                                         "same")},
        SEAMLESS_REPLAY_REL_BOUND, logged_dtype=logged_dtype)}
    llava = dataclasses.replace(get_config("llava-next-34b"),
                                num_layers=LLAVA_LAYERS,
                                use_flash_attention=True)
    out["llava"] = serve_model(
        llava, dev, seed, LLAVA_PARAMS, MOE_PREFILL, ATTN_REPLAY_LEN, {
            "no causal mask": ("prefill", _no_fault,
                               flash_faults()["no causal mask"], "same")},
        LLAVA_REPLAY_REL_BOUND, plain_controls={
            "frontend embeddings ignored": lambda p, b: make_prefill_step(
                llava)(p, {"tokens": b["tokens"]})},
        logged_dtype=logged_dtype)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serve: phase 10d [{card}] took {out['seconds']:.1f}s")
    return out


# Phase 10e, training on one card.  Models take f32 weights from --seed,
# bf16 activations (their configs' type) and DataPipeline batches of
# TRAIN_SEQ tokens a row, through repro_torch.launch.steps.make_train_step
# (AdamW at TRAIN_LR, remat over each scanned group).  gemma3-1b whole
# (26 layers: 4 scanned groups of 6 and 2 more; tied 262,144-word
# embeddings): 8 x 2048 tokens a step as 2 microbatches of 4 x 2048, 6
# steps with f32 moments, then 6 with Q8 moments from the same start.
# mamba2-130m whole, 4 x 2048, 6 steps.  deepseek-v2-lite-16b cut to
# DEEPSEEK_TRAIN_LAYERS of its 27 layers (the dense layer 0 with MLA, then
# one layer of 2 shared and 64 routed experts top-6): 27 layers with Adam
# state would need ~250 GB.  The parameter counts are the reference's
# abstract init's at these depths.
TRAIN_SEQ = 2048
TRAIN_LR = 3e-4
TRAIN_STEPS = 6
GEMMA3_PARAMS = 999_826_048
GEMMA3_TRAIN = (8, 2)            # rows a step, microbatches
MAMBA2_TRAIN = (4, 1)
DEEPSEEK_TRAIN_LAYERS = 2
DEEPSEEK2_PARAMS = 1_085_287_424
DEEPSEEK_TRAIN = (4, 1)
DEEPSEEK_TRAIN_STEPS = 3
MAMBA2_RESUME_AT = 3
H100_BF16_PEAK = 989e12          # dense bf16 FLOP/s, the MFU reading's
# The card's train step against the port's CPU step on the same weights and
# batch (1 x CHECK_TOKENS), in f32 activations with TF32 off: gemma3 at one
# scan group (6 layers, one global), mamba2 whole, deepseek's 2 layers.
# The step's parts are compared: the loss and grad_norm relative
# (TRAIN_LOSS_BOUND); each parameter's gradient and each moment after one
# AdamW step at its own scale, max|card - cpu| <= TRAIN_GRAD_BOUND[model]
# max|cpu|; the parameters after the step in units of TRAIN_LR where the
# CPU gradient is at least STEP_G_FLOOR of its parameter's largest
# (elsewhere one step moves an entry by LR g / (|g| + eps), which the two
# roundings of g can flip).  The control zeroes the gradients of the token
# mixers' input projections (attention's wq/wk/wv, MLA's wq and wkv_down,
# the SSM's in_proj: the shape of a flash kernel that cuts its gradient)
# and must fail the gradient bound: it reads 1.  Each bound is about 3
# times the worst reading over seeds 0-2 (benchmarks/torch_lm_bounds.py
# --train, NVIDIA H100 80GB HBM3, 700 W): loss and grad_norm to 9.9e-6
# (mamba2's grad_norm); gradients and moments to 1.2e-5 (gemma3), 2.0e-5
# (deepseek) and 1.28e-3 (mamba2: the SSD's segsum, differences
# of cumulative sums near 200 in f32, as its f32 replay's 1.1e-4-1.8e-4
# in phase 10c); the parameters after a step to 5.5e-4 lr.
CHECK_TOKENS = 512
TRAIN_GRAD_BOUND = {"gemma3-1b": 4e-5, "mamba2-130m": 4e-3,
                    "deepseek-v2-lite-16b": 6e-5}
TRAIN_LOSS_BOUND = 3e-5
TRAIN_STEP_BOUND = 2e-3
STEP_G_FLOOR = 1e-3
MIXER_IN = ("attn.wq", "attn.wk", "attn.wv", "attn.wkv_down", "ssm.in_proj")


def reckon_train_peak_gb(n: int, mb_tokens: int, vocab: int, accum: int,
                         quantized: bool) -> float:
    """Device memory a train step should peak at: f32 weights and one
    microbatch's gradients (4 bytes a parameter each), the f32 accumulator
    with more than one microbatch (4), the moments (8, or Q8's int8 payloads
    and a scale a 128: 2.06), and the loss's backward over the vocab: the
    saved f32 log-probabilities, their gradient and the logits' f32
    gradient alive at once (12 bytes an entry of a microbatch's logits).
    Activations (remat keeps each group's input) are left out."""
    per = 4 + 4 + (4 if accum > 1 else 0) + (2 + 8 / 128 if quantized
                                               else 8)
    return (per * n + 12 * mb_tokens * vocab) / 1e9


def eval_loss(params, cfg, batch: dict, accum: int) -> float:
    """The train step's loss on ``batch`` (the mean of its microbatches'),
    with no graph."""
    from repro_torch.launch.steps import loss_fn
    with torch.no_grad():
        parts = [float(loss_fn(params, cfg, {k: x.chunk(accum)[i]
                                             for k, x in batch.items()}))
                 for i in range(accum)]
    return sum(parts) / accum


def train_model(tag: str, cfg, dev, seed: int, want_params: int,
                rows: int, accum: int, steps: int, quantized: bool,
                card: str):
    """``steps`` train steps of ``cfg`` from ``seed``'s weights on
    DataPipeline batches of rows x TRAIN_SEQ: each step's loss and grad_norm
    finite and grad_norm above 0, no kernel of the port launched, the loss
    of the first batch again after the steps below its first reading, step
    seconds, tokens/s, the model-flops share and the peak beside its
    reckoning.  Returns (the readings, the trained model)."""
    import repro_torch
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_model = time.perf_counter()
    params = T.init_model(cfg, seed, dev).requires_grad_(True)
    n = sum(p.numel() for p in params.parameters())
    require(n == want_params, f"{tag} parameters {n:,} != {want_params:,}")
    opt = adamw_init(params, quantize=quantized)
    step = make_train_step(cfg, lr=TRAIN_LR, accum_steps=accum,
                           quantized_opt=quantized)
    pipe = DataPipeline(cfg.vocab, TRAIN_SEQ, rows, seed=seed)
    first = device_batch(next(DataPipeline(cfg.vocab, TRAIN_SEQ, rows,
                                           seed=seed)), dev)
    tokens = rows * TRAIN_SEQ
    reckoned = reckon_train_peak_gb(n, tokens // accum, cfg.padded_vocab,
                                    accum, quantized)
    log(f"train: {tag} [{card}] {cfg.num_layers} layers, {n:,} parameters, "
        f"{rows} x {TRAIN_SEQ} tokens a step as {accum} microbatch(es), "
        f"{'Q8' if quantized else 'f32'} moments, remat {cfg.remat}; "
        f"reckoned peak {reckoned:.1f} GB")
    repro_torch.reset_counts()
    times, losses, gnorms = [], [], []
    for i in range(steps):
        batch = device_batch(next(pipe), dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        log(f"train: {tag} step {i} loss {loss:.4f} grad_norm {gnorm:.4f} "
            f"{times[-1]:.3f}s")
        require(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
                f"{tag} step {i}: loss {loss}, grad_norm {gnorm}")
    launches = repro_torch.launch_counts()
    require(set(launches.values()) == {0},
            f"{tag} training launched {launches}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    again = eval_loss(params, cfg, first, accum)
    log(f"train: {tag} the first batch's loss {losses[0]:.4f} -> {again:.4f} "
        f"after {steps} steps (fell by {losses[0] - again:.4f})")
    require(again < losses[0], f"{tag} loss on a repeated batch "
            f"{losses[0]} -> {again}")
    step_s = statistics.median(times[1:])
    mfu = 6 * n * tokens / (step_s * H100_BF16_PEAK)
    log(f"train: {tag} [{card}] step {step_s:.3f}s (median of steps 1-"
        f"{steps - 1}; step 0 {times[0]:.3f}s), {tokens / step_s:.0f} "
        f"tokens/s, model-flops share 6 N tokens / (s x 989 TFLOP/s) "
        f"{mfu:.4f} (a reading), peak {peak:.2f} GB (reckoned {reckoned:.1f})")
    out = {"model": cfg.name, "layers": cfg.num_layers, "params": n,
           "rows": rows, "seq": TRAIN_SEQ, "accum_steps": accum,
           "quantized_opt": quantized, "lr": TRAIN_LR, "losses": losses,
           "grad_norms": gnorms, "step_s": times, "step_s_median": step_s,
           "tokens_per_s": tokens / step_s, "mfu": mfu, "peak_gb": peak,
           "reckoned_peak_gb": reckoned, "first_batch_loss_after": again,
           "launches": launches, "card": card,
           "seconds": time.perf_counter() - t_model}
    return out, params


def _state_on(model, cfg, device):
    """A second model holding ``model``'s values on ``device``."""
    from repro_torch.models.transformer import Model
    twin = Model(cfg, None, "meta")
    twin.load_state_dict({k: v.detach().to(device, copy=True) for k, v in
                          model.state_dict().items()}, assign=True)
    return twin


def _ratios(got: dict, want: dict, dev) -> dict:
    """max|got - want| / max|want| for each name of ``want``, in f64 on
    ``dev`` (the difference itself where ``want`` is all zero)."""
    out = {}
    for k, w in want.items():
        w = w.detach().to(dev).double()
        d = (got[k].detach().to(dev).double() - w).abs().max()
        s = w.abs().max()
        out[k] = float(d / s) if s > 0 else float(d)
    return out


def card_vs_cpu(tag: str, cfg, dev, seed: int) -> dict:
    """One train step of ``cfg`` (``make_train_step``'s parts:
    ``loss_and_grads``, ``grad_norm``, ``adamw_update``) in f32 activations
    on the card and on the CPU from the same weights and batch: loss,
    grad_norm, every gradient, the parameters and moments after, each
    against its bound, and the mixer-input control against the gradient
    bound."""
    import dataclasses

    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import grad_norm, loss_and_grads
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init, adamw_update
    bound = TRAIN_GRAD_BOUND[cfg.name]
    cfg = dataclasses.replace(cfg, dtype="float32")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        card = T.init_model(cfg, seed, dev).requires_grad_(True)
        host = _state_on(card, cfg, "cpu").requires_grad_(True)
        batch = next(DataPipeline(cfg.vocab, CHECK_TOKENS, 1, seed=seed))
        res = {}
        for name, model, device in (("card", card, dev), ("cpu", host,
                                                          "cpu")):
            # make_train_step's parts, so that the gradients can be read
            loss, grads = loss_and_grads(model, cfg,
                                         device_batch(batch, device))
            gnorm = grad_norm(grads)
            model, opt = adamw_update(model, grads, adamw_init(model),
                                      lr=TRAIN_LR)
            res[name] = (loss, grads, gnorm, model.state_dict(), opt)
        (cl, cg, cm, cp, co), (hl, hg, hm, hp, ho) = res["card"], res["cpu"]
        grads = _ratios(cg, hg, dev)
        grad = max(grads.values())
        mixer = {k: g for k, g in hg.items() if k.endswith(MIXER_IN)}
        control = max([*_ratios({k: torch.zeros_like(g) for k, g in
                                 mixer.items()}, mixer, dev).values(),
                       *(r for k, r in grads.items() if k not in mixer)])
        moments = max(*_ratios(co.m, ho.m, dev).values(),
                      *_ratios(co.v, ho.v, dev).values())
        worst_step = 0.0
        for k, g in hg.items():
            g = g.to(dev).abs()
            ok = g >= STEP_G_FLOOR * g.max()
            d = torch.where(ok, (cp[k] - hp[k].to(dev)).abs(), 0.0).max()
            worst_step = max(worst_step, float(d) / TRAIN_LR)
        loss_rel = abs(float(cl) - float(hl)) / abs(float(hl))
        gnorm_rel = abs(float(cm) - float(hm)) / float(hm)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    out = {"tokens": CHECK_TOKENS, "layers": cfg.num_layers,
           "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
           "grad_ratio": grad, "moment_ratio": moments,
           "step_lr_units": worst_step, "control_grad_ratio": control,
           "seconds": time.perf_counter() - t0}
    log(f"train: {tag} card vs CPU, 1 x {CHECK_TOKENS} tokens in f32, TF32 "
        f"off: loss {loss_rel:.3e}, grad_norm {gnorm_rel:.3e} (bound "
        f"{TRAIN_LOSS_BOUND}), gradients {grad:.3e}, moments {moments:.3e} of "
        f"their own scale (bound {bound}), parameters after a step "
        f"{worst_step:.2e} x lr (bound {TRAIN_STEP_BOUND}); control (mixer "
        f"input gradients zeroed) {control:.3f} (must exceed {bound}); "
        f"{out['seconds']:.1f}s")
    require(loss_rel <= TRAIN_LOSS_BOUND and gnorm_rel <= TRAIN_LOSS_BOUND,
            f"{tag} card vs CPU loss {loss_rel}, grad_norm {gnorm_rel}")
    require(grad <= bound and moments <= bound,
            f"{tag} card vs CPU gradients {grad}, moments {moments}")
    require(worst_step <= TRAIN_STEP_BOUND,
            f"{tag} card vs CPU parameters after a step {worst_step} x lr")
    require(control > bound,
            f"{tag} the gradient check passes the zeroed-mixer control")
    return out


def check_configs():
    """The three card-against-CPU configurations, by tag."""
    import dataclasses

    from repro_torch.configs import get_config
    return {
        "gemma3-1b (6 layers)": dataclasses.replace(
            get_config("gemma3-1b"), num_layers=6),
        "mamba2-130m": get_config("mamba2-130m"),
        f"deepseek-v2-lite-16b ({DEEPSEEK_TRAIN_LAYERS} layers)":
            dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                                num_layers=DEEPSEEK_TRAIN_LAYERS)}


def train_card_vs_cpu(dev, seed: int) -> dict:
    return {tag: card_vs_cpu(tag, cfg, dev, seed)
            for tag, cfg in check_configs().items()}


def mamba2_resume(dev, seed: int, card: str) -> dict:
    """mamba2-130m through ``repro_torch.launch.train.train`` on the card:
    TRAIN_STEPS steps straight through against MAMBA2_RESUME_AT steps, a
    checkpoint, and a fresh ``train`` resuming to TRAIN_STEPS; the
    parameters bitwise, or else within the spread of two straight runs."""
    import signal
    import tempfile

    from repro_torch.launch.train import train
    rows = MAMBA2_TRAIN[0]
    kw = dict(arch="mamba2-130m", smoke=False, batch=rows, seq=TRAIN_SEQ,
              lr=TRAIN_LR, save_every=MAMBA2_RESUME_AT, log_every=1,
              seed=seed, device=dev)
    old = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()

    def state(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    try:
        with tempfile.TemporaryDirectory() as a, \
                tempfile.TemporaryDirectory() as b:
            model, straight = train(**kw, steps=TRAIN_STEPS, ckpt_dir=a)
            want = state(model)
            del model
            train(**kw, steps=MAMBA2_RESUME_AT, ckpt_dir=b)
            model, resumed = train(**kw, steps=TRAIN_STEPS, ckpt_dir=b)
            got = state(model)
            del model
        diff = max(float((got[k] - v).abs().max()) for k, v in want.items())
        out = {"straight_losses": straight, "resumed_losses": resumed,
               "max_abs_diff": diff, "bitwise": diff == 0.0}
        if diff:
            model, _ = train(**kw, steps=TRAIN_STEPS)
            spread = max(float((v - want[k]).abs().max())
                         for k, v in state(model).items())
            del model
            out["straight_spread"] = spread
            require(diff <= spread, f"mamba2 resume differs by {diff}, two "
                    f"straight runs by {spread}")
    finally:
        signal.signal(signal.SIGTERM, old)
    out["seconds"] = time.perf_counter() - t0
    log(f"train: mamba2-130m [{card}] resumed at step {MAMBA2_RESUME_AT} of "
        f"{TRAIN_STEPS}: parameters "
        + ("bitwise the straight run's" if out["bitwise"] else
           f"differ by {diff:.3e}, within two straight runs' "
           f"{out['straight_spread']:.3e}")
        + f"; resumed losses {resumed} ({out['seconds']:.1f}s)")
    require(resumed == straight[MAMBA2_RESUME_AT:] or not out["bitwise"],
            f"mamba2 resumed losses {resumed} vs {straight}")
    return out


def flash_in_training(params, cfg, dev) -> dict:
    """gemma3 with the flash flag on: its loss under grad raises (the
    kernels have no backward); its prefill under no_grad still launches
    the tensor-core kernel, once a global layer."""
    import dataclasses

    import repro_torch
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch.steps import loss_fn, make_prefill_step
    flash = dataclasses.replace(cfg, use_flash_attention=True)
    tokens = torch.zeros((1, 256), dtype=torch.int64, device=dev)
    batch = {"tokens": tokens, "labels": tokens}
    raised = None
    try:
        loss_fn(params, flash, batch)
    except NotImplementedError as e:
        raised = str(e)
    require(raised is not None and "_flash_kernel" in raised,
            "gemma3 with flash under grad did not raise")
    n_global = sum(cfg.layer_window(i) is None for i in params.layer_idx)
    repro_torch.reset_counts()
    logits = make_prefill_step(flash)(params, {"tokens": tokens})
    torch.cuda.synchronize(dev)
    launches = dict(F.variant_launches)
    require(logits.grad_fn is None and bool(torch.isfinite(logits).all()),
            "gemma3 flash prefill under no_grad")
    require(launches == {"tensor_core": n_global, "ffma": 0},
            f"gemma3 flash prefill launched {launches}, want {n_global} "
            f"tensor-core")
    log(f"train: gemma3-1b with the flash flag: under grad raises "
        f"NotImplementedError ({raised[:60]}...); prefill 1 x 256 under "
        f"no_grad launched {launches}")
    return {"raised": raised, "prefill_launches": launches}


def training(dev, seed: int, card: str) -> dict:
    """Phase 10e: gemma3-1b whole with f32 then Q8 moments, mamba2-130m
    whole, deepseek-v2-lite-16b cut to DEEPSEEK_TRAIN_LAYERS layers, each
    trained on the card with its checks; the card against the CPU; mamba2's
    resume; gemma3's flash flag under grad and under no_grad."""
    import dataclasses

    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    out = {"card": card}
    gemma = get_config("gemma3-1b")
    rows, accum = GEMMA3_TRAIN
    out["gemma3_f32"], params = train_model(
        "gemma3-1b", gemma, dev, seed, GEMMA3_PARAMS, rows, accum,
        TRAIN_STEPS, False, card)
    out["flash"] = flash_in_training(params, gemma, dev)
    del params
    out["gemma3_q8"] = train_model(
        "gemma3-1b", gemma, dev, seed, GEMMA3_PARAMS, rows, accum,
        TRAIN_STEPS, True, card)[0]
    f32, q8 = out["gemma3_f32"]["losses"], out["gemma3_q8"]["losses"]
    log(f"train: gemma3-1b step 0 loss with f32 moments {f32[0]!r}, with Q8 "
        f"{q8[0]!r} (the same start); after {TRAIN_STEPS} steps "
        f"{f32[-1]:.4f} and {q8[-1]:.4f}")
    rows, accum = MAMBA2_TRAIN
    out["mamba2"] = train_model(
        "mamba2-130m", get_config("mamba2-130m"), dev, seed, MAMBA2_PARAMS,
        rows, accum, TRAIN_STEPS, False, card)[0]
    ds = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                             num_layers=DEEPSEEK_TRAIN_LAYERS)
    rows, accum = DEEPSEEK_TRAIN
    out["deepseek"] = train_model(
        "deepseek-v2-lite-16b", ds, dev, seed, DEEPSEEK2_PARAMS, rows, accum,
        DEEPSEEK_TRAIN_STEPS, False, card)[0]
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = train_card_vs_cpu(dev, seed)
    torch.cuda.empty_cache()
    out["mamba2_resume"] = mamba2_resume(dev, seed, card)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"train: phase 10e [{card}] took {out['seconds']:.1f}s")
    return out


# Phase 11, the tuner and the solver service.  The burst: SERVE_BURST
# single-RHS solves a tenant, coalesced within SERVE_WINDOW_S up to
# SERVE_MAX_BATCH columns; each served solution is held within
# SOLVE_REL_TOL (relative, in f64) of the solo solver's stacked solve.
CHOLESKY_KERNELS = ("mxp_gemm_update", "syrk_update", "trsm", "potrf",
                    "fused_column_step")
SERVE_BURST = 64
SERVE_WINDOW_S = 0.005
SERVE_MAX_BATCH = 32
SOLVE_REL_TOL = 1e-10


def _over_limits(cfg) -> bool:
    """Whether ``cfg``'s tile size exceeds a limit of the kernels its route
    runs: TRSM's and POTRF's edge (use_pallas below f64; f64 tiles take the
    stock ops), the fused step's."""
    from repro_torch.kernels import fused_column, potrf, trsm
    if (cfg.use_pallas and cfg.resolved_compute_dtype != torch.float64
            and cfg.tb > min(trsm.MAX_N, potrf.MAX_N)):
        return True
    return cfg.fuse_columns and (cfg.tb % fused_column.NB
                                 or cfg.tb > fused_column.MAX_TB)


def tuner_service(n: int, tb: int, dev, seed: int, card: str, main: dict,
                  checks: dict, trace_a) -> dict:
    """Phase 11.  Calibration on the card (all five Cholesky kernels
    launched, the card's memory), the search at ``n`` against the measured
    model for the main path's configuration with ``tb`` and the policy open
    (no candidate past a kernel's tile limit), the winner's kernels against
    their plain versions at its tile size and its factor under the main
    path's checks, a model refitted from phase 8's trace, and two tenants
    served at once: bitwise their solo factors and logdets, exact launch
    totals, a coalesced solve burst, and a plan one byte too large for the
    model's memory refused before anything runs."""
    import dataclasses

    import repro_torch
    from repro_torch import obs, tune
    from repro_torch.serve import (AdmissionError, SolverService,
                                   plan_device_bytes)
    out = {"card": card}

    # calibration: the executor's own kernels, timed by device time
    repro_torch.reset_counts()
    t0 = time.perf_counter()
    model = tune.calibrate(tb=tb, compute_dtype=torch.float32, device=dev)
    cal_s = time.perf_counter() - t0
    launches = repro_torch.launch_counts()
    total_mem = torch.cuda.mem_get_info(dev)[1]
    log(f"calibrate [{card}]: tb={tb} f32 in {cal_s:.2f}s; launches "
        f"{launches}; mem_bytes {model.mem_bytes:.0f} (the card's "
        f"{total_mem})")
    require(all(launches[k] > 0 for k in CHOLESKY_KERNELS),
            f"calibrate: a Cholesky kernel was not launched: {launches}")
    require(model.mem_bytes == total_mem,
            f"calibrate: mem_bytes {model.mem_bytes} != {total_mem}")
    for task, per in sorted(model.kernel_flops.items()):
        log(f"calibrate [{card}]: {task} TFLOP/s by class " + ", ".join(
            f"{c} {r / 1e12:.3f}" for c, r in per.items()))
    gemm_ms = checks["mxp_gemm_update[float32]"]["device_ms"]
    phase3_rate = 2.0 * tb ** 3 / (gemm_ms / 1e3)
    preset = repro_torch.HW["h100-pcie"]
    log(f"calibrate [{card}]: f32 GEMM {model.kernel_flops['gemm']['f32'] / 1e12:.3f} "
        f"TFLOP/s beside 2 tb^3 / phase 3's device time "
        f"{phase3_rate / 1e12:.3f}; h2d {model.h2d_bw / 1e9:.2f} GB/s, d2h "
        f"{model.d2h_bw / 1e9:.2f}, link {model.link_bw / 1e9:.2f}, "
        f"launch_overhead {model.launch_overhead * 1e6:.2f} us, alloc "
        f"{model.alloc_overhead * 1e6:.2f} us; the h100-pcie preset's "
        f"(datasheet): f32 {preset.flops['f32'] / 1e12:.1f} TFLOP/s, h2d "
        f"{preset.h2d_bw / 1e9:.1f} GB/s, d2h {preset.d2h_bw / 1e9:.1f}, "
        f"launch {preset.launch_overhead * 1e6:.1f} us")
    out["calibration"] = {
        "seconds": cal_s, "launches": launches, "card_mem_bytes": total_mem,
        "model": tune.model_to_dict(model),
        "gemm_f32_phase3_rate": phase3_rate}

    # the search: the main path's configuration with tb and policy open
    a = make_spd(n, dev, seed)
    base = dataclasses.replace(main_config(0), policy="auto",
                               eps_target=None)
    t0 = time.perf_counter()
    result = tune.tune(n, base, hw=model, sample=a, eps_target=MAIN_EPS)
    search_s = time.perf_counter() - t0
    table = result.table()
    unlimited = tune.feasible_tbs(n, model)
    offered = sorted({c.config.tb for c in result.candidates})
    log(f"tune [{card}]: n={n} in {search_s:.2f}s, {len(table)} "
        f"candidates at tb {offered} (without the kernels' limits: "
        f"{unlimited}); model readings, simulated makespans:")
    for row in table[:5]:
        log(f"tune:   tb={row['tb']} {row['policy']} slots="
            f"{row['cache_slots']} makespan {row['makespan_s']:.4f}s "
            f"loads {row['loads_bytes']} stores {row['stores_bytes']}")
    over = [c.config.tb for c in result.candidates if _over_limits(c.config)]
    require(not over, f"tune: candidates past the kernels' limits: {over}")
    cfg = result.config
    require(cfg.plan is not None and cfg.use_pallas
            and cfg.compute_dtype == torch.float32,
            f"tune: the winner lost the path's route or plan: {cfg}")
    out["tune"] = {"seconds": search_s, "candidates": len(table),
                   "offered_tbs": offered, "unlimited_tbs": unlimited,
                   "top": table[:5]}

    # the winner: its kernels at its tile size, then its factor
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    out["tuned_kernel_checks"] = kernel_checks(
        cfg.tb, dev, g, dtypes=(torch.float32,), timed=False)
    lref = torch.linalg.cholesky(a)
    tuned = checked_factor("tuned", cfg, a, lref, dev, seed,
                           time.perf_counter())
    log(f"tuned [{card}]: tb={cfg.tb} {cfg.policy} slots={cfg.cache_slots}: "
        f"factor {tuned['factor_s']:.3f}s beside phase 4's "
        f"{main['factor_s']:.3f}s at tb={tb} v3; predicted "
        f"{result.best.makespan:.4f}s (model reading)")
    out["tuned"] = tuned
    del a, lref

    # a model refitted from phase 8's trace; drift of the same trace
    # against three models (readings, not requirements)
    rec, plan_a = trace_a
    refined = tune.calibrate(refine_from=rec, device=dev)
    drift = {}
    for name, hw in (("refined", refined), ("measured", model),
                     ("h100-pcie", preset)):
        sim = plan_a.simulate(hw, record_timeline=True)
        drift[name] = obs.drift_report(rec, sim).makespan_ratio
    log(f"refine [{card}]: drift of phase 8's trace, makespan ratio against "
        + ", ".join(f"{k} x{v:.3f}" for k, v in drift.items()))
    out["refine"] = {"drift_makespan_ratio": drift,
                     "model": tune.model_to_dict(refined)}

    # two tenants, each with its own seeded matrix, factored solo first
    mats = [make_spd(n, dev, seed + 11 + i) for i in range(2)]
    cfgs = [main_config(tb).specialize(m) for m in mats]
    rng = np.random.default_rng(seed + 11)
    rhs = [[rng.standard_normal(n) for _ in range(SERVE_BURST)]
           for _ in mats]
    solo, solo_s, want = [], [], dict.fromkeys(KERNEL_META, 0)
    for m, c, bs in zip(mats, cfgs, rhs):
        p = repro_torch.plan(n, c)
        s = p.compile(device=dev)
        t0 = time.perf_counter()
        s.factor(m, materialize=False)
        solo_s.append(time.perf_counter() - t0)
        solo.append((s.tiles.clone(), s.logdet(),
                     s.solve(np.stack(bs, axis=1))))
        for k, v in schedule_launches(p.schedule).items():
            want[k] += v
        del s
    shared = repro_torch.plan(n, cfgs[0]) is repro_torch.plan(n, cfgs[1])
    with SolverService(workers=2, hw=model, device=dev,
                       batch_window=SERVE_WINDOW_S,
                       max_batch=SERVE_MAX_BATCH) as svc:
        sess = [svc.session(f"tenant{i}", n, c) for i, c in enumerate(cfgs)]
        repro_torch.reset_counts()
        t0 = time.perf_counter()
        futs = [s.factor_async(m) for s, m in zip(sess, mats)]
        for f in futs:
            f.result()
        served_s = time.perf_counter() - t0
        launches = repro_torch.launch_counts()
        reserved = svc.admission.reserved_bytes()
        need = [plan_device_bytes(s._plan) for s in sess]
        bitwise = [torch.equal(s._solver.tiles, t) and s.logdet() == ld
                   for s, (t, ld, _) in zip(sess, solo)]
        log(f"serve [{card}]: two tenants factored at once in "
            f"{served_s:.3f}s beside solo {solo_s[0]:.3f}s + "
            f"{solo_s[1]:.3f}s, x{served_s / sum(solo_s):.3f} their sum "
            f"(one card runs one factor at a time; one plan shared: "
            f"{shared}); launches "
            f"{launches}, want {want}; bitwise solo factor and logdet "
            f"{bitwise}; admitted {reserved} B reserved of the card's "
            f"{model.mem_bytes:.0f}")
        require(launches == want, f"serve: launches {launches} != {want}")
        require(all(bitwise), "serve: a served factor or logdet differs "
                "from its solo one")
        require(reserved == sum(need), f"serve: reserved {reserved} B, the "
                f"two plans need {need}")
        # one work item's worth of solves outside the service, for scale
        t0 = time.perf_counter()
        sess[0]._solver.solve(np.stack(rhs[0][:SERVE_MAX_BATCH], axis=1))
        direct_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        burst = [[s.solve_async(b) for b in bs] for s, bs in zip(sess, rhs)]
        xs = [np.stack([f.result() for f in fs], axis=1) for fs in burst]
        burst_s = time.perf_counter() - t0
        snap = svc.metrics.snapshot()
        lat = [r.latency for r in svc.metrics._records
               if r.ok and r.kind == "solve"]
        items = sorted({(r.t_start, r.t_end, r.batch_k)
                        for r in svc.metrics._records if r.kind == "solve"})
    rel = max(float(np.max(np.linalg.norm(x - want_x, axis=0)
                           / np.linalg.norm(want_x, axis=0)))
              for x, (_, _, want_x) in zip(xs, solo))
    occ = snap["batch"]["max_occupancy"]
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    log(f"serve [{card}]: burst of {SERVE_BURST} single-RHS solves a tenant "
        f"in {burst_s:.3f}s: {len(items)} solve work items, max "
        f"occupancy {occ}, mean {snap['batch']['mean_occupancy']:.2f}; "
        f"solves_per_s {snap['solves_per_s']:.1f} (the service's window); "
        f"solve latency p50 {p50 * 1e3:.2f} ms p99 {p99 * 1e3:.2f} ms; max "
        f"relative distance from the solo solves {rel:.3e} (bound "
        f"{SOLVE_REL_TOL:.0e})")
    log(f"serve [{card}]: one {SERVE_MAX_BATCH}-column solve outside the "
        f"service {direct_s:.3f}s; the burst's work items (columns, "
        f"seconds from pick-up to end): " + ", ".join(
            f"{k}:{t1 - t0:.3f}" for t0, t1, k in items))
    require(occ >= 2, f"serve: burst max occupancy {occ}")
    require(rel < SOLVE_REL_TOL, f"serve: solves {rel} from the solo ones")

    # the same plan under the model with one byte too few is refused
    tight = dataclasses.replace(model, mem_bytes=need[0] - 1)
    with SolverService(workers=1, hw=tight, device=dev) as svc2:
        s = svc2.session("tight", n, cfgs[0])
        repro_torch.reset_counts()
        fut = s.factor_async(mats[0])
        try:
            fut.result()
            refused = None
        except AdmissionError as exc:
            refused = str(exc)
        ran = repro_torch.launch_counts()
        snap2 = svc2.metrics.snapshot()
    log(f"serve: mem_bytes one byte below the plan's {need[0]} B: refused "
        f"({refused}); launches {ran}; rejected {snap2['rejected']}")
    require(refused is not None and not any(ran.values())
            and snap2["rejected"] == 1 and snap2["completed"] == 0,
            "serve: the plan one byte too large was not refused before "
            "anything ran")
    out["serve"] = {
        "served_s": served_s, "solo_s": solo_s, "one_plan": shared,
        "launches": launches, "schedule_launches": want,
        "reserved_bytes": reserved, "burst_s": burst_s,
        "direct_solve_s": direct_s,
        "items": [[t1 - t0, k] for t0, t1, k in items],
        "max_occupancy": occ, "solves_per_s": snap["solves_per_s"],
        "solve_latency_p50_s": p50, "solve_latency_p99_s": p99,
        "max_rel_solve": rel, "snapshot": snap, "refused": refused}
    return out


# the baseline's bound on max|L - chol64(A)| / max|A|: the ROADMAP's LAPACK
# tolerance (tests/test_backend_equivalence.py), in f64 throughout
BASELINE_TOL = 1e-10


def _rel_err_host(l: np.ndarray, lref: torch.Tensor, amax: float,
                  rows: int = 2048) -> float:
    """max|L - lref| / max|A| of a host factor against one on the card, a
    block of rows at a time; NaN where L holds one."""
    err = torch.zeros((), dtype=torch.float64, device=lref.device)
    for i in range(0, l.shape[0], rows):
        got = torch.from_numpy(l[i:i + rows]).to(lref.device)
        err = torch.maximum(err, (got - lref[i:i + rows]).abs().max())
    return float(err) / amax


def _card_indices(devices, dev) -> list:
    """The cards ``md_devices`` gives: the first MD_NDEV, or ``dev``'s."""
    if devices == "cuda":
        return list(range(MD_NDEV))
    return [torch.device(dev).index or 0]


def baseline(n: int, tb: int, dev, seed: int, card: str, md: dict) -> dict:
    """Phase 12, the baseline: ``distributed_cholesky`` (f64, four logical
    devices as phase 7's) on phase 4's matrix, against the f64 factor on
    the card, twice bitwise under the watchdog, its bytes against the
    formula and the schedule, and a broadcast of zeros that must fail."""
    import faulthandler

    from repro_torch.core import distributed as dist
    from repro_torch.core.schedule import build_multidevice_schedule
    devices, shared = md_devices(dev, MD_NDEV)
    cards = _card_indices(devices, dev)
    nt = n // tb
    a = make_spd(n, dev, seed)
    lref = torch.linalg.cholesky(a)
    amax = float(a.abs().max())
    log(f"baseline [{card}]: distributed_cholesky n={n} tb={tb} f64 on "
        f"{MD_NDEV} logical devices, "
        + ("sharing this one card, each on a CUDA stream of its own"
           if shared else f"on {MD_NDEV} cards"))

    def run():
        torch.cuda.synchronize()
        base = {c: torch.cuda.memory_allocated(c) for c in cards}
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        t0 = time.perf_counter()
        l, stats = dist.distributed_cholesky_with_stats(a, tb, MD_NDEV,
                                                        devices)
        secs = time.perf_counter() - t0
        peak = sum(torch.cuda.max_memory_allocated(c) - base[c]
                   for c in cards)
        return l, stats, secs, peak

    runs = []
    faulthandler.dump_traceback_later(MD_WATCHDOG_S, exit=True)
    try:
        for _ in range(2):
            runs.append(run())
    finally:
        faulthandler.cancel_dump_traceback_later()
    (l, stats, secs, peak), (l2, _, secs2, _) = runs
    same = torch.equal(torch.from_numpy(l), torch.from_numpy(l2))
    del l2, runs
    rel = _rel_err_host(l, lref, amax)
    del l
    want = dist.panel_broadcast_bytes(nt, tb, MD_NDEV)
    sched_bytes = build_multidevice_schedule(nt, tb, MD_NDEV).bcast_bytes()
    a_s = md["A_unfused"]["factor_s"]
    log(f"baseline [{card}]: {secs:.3f}s then {secs2:.3f}s (column steps "
        f"{stats['factor_s']:.3f}s, the rest set-up and L to the host); "
        f"device memory beyond the input and its f64 factor "
        f"{peak / 2 ** 20:.0f} MiB at peak; phase 7's config A (f32, "
        f"kernels) {a_s[0]:.3f}s, {a_s[1]:.3f}s; max|L - chol64(A)|/max|A| "
        f"= {rel:.3e} (bound {BASELINE_TOL:.0e}); the two runs bitwise "
        f"equal: {same}; bytes sent {stats['bcast_bytes']} in "
        f"{stats['bcast_copies']} rows, panel_broadcast_bytes {want}, the "
        f"schedule's bcast_bytes() {sched_bytes}")
    require(math.isfinite(rel) and rel < BASELINE_TOL,
            f"baseline error {rel}")
    require(same, "baseline: two runs differ")
    require(stats["bcast_bytes"] == want == sched_bytes
            and stats["steps"] == nt
            and stats["bcast_copies"] == nt * (MD_NDEV - 1),
            f"baseline: counters {stats}, formula {want}, schedule "
            f"{sched_bytes}")

    # the control, swapped in here and not through an option of the
    # package: every row sent arrives as zeros
    send = dist._send
    dist._send = lambda panel, device: torch.zeros(
        panel.shape, dtype=panel.dtype, device=device)
    try:
        lc = dist.distributed_cholesky(a, tb, MD_NDEV, devices)
    finally:
        dist._send = send
    ctrl = _rel_err_host(lc, lref, amax)
    del lc
    log(f"baseline: control, a broadcast of zeros: max|L - chol64(A)|/"
        f"max|A| = {ctrl:.3e} (must reach {BASELINE_TOL:.0e})")
    require(not ctrl < BASELINE_TOL,
            f"baseline check passes the zeros control ({ctrl})")
    return {"n": n, "tb": tb, "ndev": MD_NDEV, "shared_card": shared,
            "seconds": [secs, secs2], "factor_s": stats["factor_s"],
            "peak_bytes_beyond_input": peak, "rel_err": rel,
            "tol": BASELINE_TOL, "bitwise": same, "stats": stats,
            "panel_broadcast_bytes": want, "schedule_bcast_bytes": sched_bytes,
            "control_rel_err": ctrl, "config_a_factor_s": a_s}


def shim(n: int, tb: int, dev, seed: int, card: str) -> dict:
    """Phase 12, the shim: ``ooc_cholesky`` on the main path's
    configuration at ``n``: the deprecation, bitwise the planner path's
    factor with the schedule's launches, its accuracy as the main path's,
    and the raise for two devices where one card is visible."""
    import warnings

    import repro_torch
    a = make_spd(n, dev, seed)
    kw = dict(policy="v3", ladder="gpu", eps_target=MAIN_EPS,
              use_pallas=True, compute_dtype=torch.float32)
    repro_torch.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        l, sched = repro_torch.ooc_cholesky(a, tb, device=dev, **kw)
        secs = time.perf_counter() - t0
    launches = repro_torch.launch_counts()
    warned = [str(w.message) for w in caught
              if issubclass(w.category, DeprecationWarning)]
    want = schedule_launches(sched)
    solver = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=tb, **kw).specialize(a)).compile(device=dev)
    same = np.array_equal(l, solver.factor(a))
    lref = torch.linalg.cholesky(a)
    amax = float(a.abs().max())
    rel = _rel_err_host(l, lref, amax)
    bound = 64 * max(MAIN_EPS, 2.0 ** -24 * math.sqrt(n))   # phase 4's
    log(f"shim [{card}]: ooc_cholesky n={n} tb={tb} {secs:.3f}s (plan, "
        f"compile and factor); DeprecationWarning {warned}; bitwise the "
        f"plan(...).compile() factor: {same}; launches {launches}, the "
        f"schedule's {want}; max|L - chol64(A)|/max|A| = {rel:.3e} (bound "
        f"{bound:.1e})")
    require(any("repro_torch.plan" in w for w in warned),
            f"shim: no DeprecationWarning naming repro_torch.plan "
            f"({warned})")
    require(same, "shim: factor differs from the planner path's")
    require(sched.digest() == solver.schedule.digest(),
            "shim: schedule differs from the planner path's")
    require(launches == want, f"shim: launches {launches} != {want}")
    require(math.isfinite(rel) and rel < bound, f"shim: error {rel}")
    raised = None
    if torch.cuda.device_count() < 2:
        small = repro_torch.random_spd(64, seed=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            try:
                repro_torch.ooc_cholesky(small, 16, ndev=2, device="cuda")
            except RuntimeError as e:
                raised = str(e)
        log(f"shim: ndev=2 on device='cuda' with one card visible raised "
            f"RuntimeError: {raised}")
        require(raised is not None and "needs 2 CUDA devices" in raised,
                "shim: ndev=2 with one card did not raise RuntimeError")
    else:
        log(f"shim: the ndev=2 raise needs one visible card; this machine "
            f"has {torch.cuda.device_count()}: skipped")
    return {"n": n, "tb": tb, "seconds": secs, "warned": warned,
            "bitwise_planner": same, "launches": launches,
            "schedule_launches": want, "rel_err": rel, "bound": bound,
            "ndev2_raise": raised}


EXAMPLES_TIMEOUT_S = 300


def examples(card: str) -> dict:
    """Phase 12, the examples: each ``examples/torch_*.py`` at its
    defaults on the card, all at once in their own processes; each must
    exit 0.  Their output goes to ``chiprun_out/examples/``."""
    import os
    outdir = ROOT / "chiprun_out" / "examples"
    outdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    t0 = time.perf_counter()
    try:
        for path in sorted((ROOT / "examples").glob("torch_*.py")):
            with open(outdir / f"{path.name}.log", "w") as f:
                procs[path.name] = subprocess.Popen(
                    [sys.executable, str(path)], cwd=ROOT, env=env,
                    stdout=f, stderr=subprocess.STDOUT)
        require(len(procs) == 6, f"examples: found {sorted(procs)}")
        out = {}
        for name, proc in procs.items():
            proc.wait(timeout=EXAMPLES_TIMEOUT_S)
            out[name] = {"rc": proc.returncode,
                         "seconds": time.perf_counter() - t0}
            tail = ((outdir / f"{name}.log").read_text().strip()
                    .splitlines()[-1:] or [""])
            log(f"example {name} [{card}]: exit {proc.returncode} after "
                f"{out[name]['seconds']:.1f}s; last line: {tail[0][:160]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = {k: v["rc"] for k, v in out.items() if v["rc"] != 0}
    require(not bad, f"examples failed: {bad} (chiprun_out/examples/)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--tb", type=int, default=512)
    ap.add_argument("--mxp-n", type=int, default=8192)
    ap.add_argument("--geo-n", type=int, default=16384)
    ap.add_argument("--spill-n", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a card", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    phase_s = {}
    last = [t_script]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

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
    lap("1-2 card and build")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    checks = kernel_checks(args.tb, dev, g)     # 3. kernel check
    checks.update(gemm_checks(dev, args.seed))
    checks.update(syrk_checks(dev, args.seed))
    checks.update(blocked_checks(args.tb, dev, g))
    checks.update(fused_checks(args.tb, dev, g))
    lap("3 kernel checks")
    a = make_spd(args.n, dev, args.seed)        # 4. main path
    lref = torch.linalg.cholesky(a)
    main = main_path(a, lref, args.tb, dev, args.seed, fuse=False)
    fused = main_path(a, lref, args.tb, dev, args.seed, fuse=True)
    log(f"factor n={args.n}: unfused {main['factor_s']:.3f}s, fused "
        f"{fused['factor_s']:.3f}s")
    del a, lref
    lap("4 main path")
    mxp = mxp_fused(args.mxp_n, args.tb, dev)   # 5. mixed precision
    lap("5 mixed precision")
    geo_res = geo(args.geo_n, args.tb, dev, args.seed, card)   # 6. geo
    lap("6 geospatial")
    torch.cuda.empty_cache()                    # 7. multi-device
    md = multidevice(args.n, MD_MXP_N, args.tb, dev, args.seed, card,
                     {"main": main, "fused": fused})
    lap("7 multi-device")
    torch.cuda.empty_cache()                    # 8. measured trace
    traced, trace_a = trace_phase(args.n, MD_MXP_N, args.tb, dev, args.seed,
                                  card)
    lap("8 trace")
    torch.cuda.empty_cache()                    # 9. disk tier
    disk = disk_tier(args.spill_n, args.tb, dev, args.seed, card)
    lap("9 disk tier")
    torch.cuda.empty_cache()                    # 10. LM serving
    log(f"lm: device memory in use before the model "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 20:.0f} MiB")
    with torch.no_grad():                       # serving keeps no graph
        checks.update(flash_checks(dev, g))
        lm = lm_serving(dev, args.seed)
        lap("10 LM serving")
        torch.cuda.empty_cache()                # 10b. MoE and MLA serving
        moe = moe_mla_serving(dev, args.seed, card)
        lap("10b MoE and MLA")
        torch.cuda.empty_cache()                # 10c. SSM and hybrid
        ssm = ssm_hybrid_serving(dev, args.seed, card)
        lap("10c SSM and hybrid")
        torch.cuda.empty_cache()                # 10d. enc-dec, frontends
        encdec = encdec_frontend_serving(dev, args.seed, card)
        lap("10d encoder-decoder and frontend")
    torch.cuda.empty_cache()                    # 10e. training
    trained = training(dev, args.seed, card)
    lap("10e training")
    torch.cuda.empty_cache()                    # 11. tuner and service
    ts = tuner_service(args.n, args.tb, dev, args.seed, card, main, checks,
                       trace_a)
    lap("11 tuner and service")
    torch.cuda.empty_cache()          # 12. the baseline, shim and examples
    base = baseline(args.n, args.tb, dev, args.seed, card, md)
    torch.cuda.empty_cache()
    shim_res = shim(args.mxp_n, args.tb, dev, args.seed, card)
    ex = examples(card)
    lap("12 baseline, shim, examples")

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        md_run = md["A_fused" if name == "fused_column_step"
                    else "A_unfused"]
        if name == "fused_column_step":
            row = checks[f"{name}[float32,R=32,K=32,diag=1]"]
            launches = fused["launches"][name]
            row = {**row, "geo_f64_launches": geo_res["launches"][name],
                   "geo_f64_mid_ms": geo_res["fused_step_f64_mid"]["ms"]}
        elif name == "flash_attention":
            row = {**checks[f"{name}[prefill]"], "dbrx_prefill_launches":
                   moe["dbrx"]["prefill_launches"][name],
                   "seamless_prefill_launches":
                   encdec["seamless"]["prefill_launches"][name],
                   "llava_prefill_launches":
                   encdec["llava"]["prefill_launches"][name]}
            launches = lm["prefill_launches"][name]
        else:
            row = checks[f"{name}[float32]"]
            launches = main["launches"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "multidevice_launches": md_run["launches"][name],
            "disk_tier_launches": disk["fused" if name == "fused_column_step"
                                       else "unfused"]["launches"][name],
            "calibration_launches": ts["calibration"]["launches"][name],
            "tuned_launches": ts["tuned"]["launches"][name],
            "served_launches": ts["serve"]["launches"][name],
            "shim_launches": shim_res["launches"][name],
            "training_launches": sum(
                trained[run]["launches"][name] for run in
                ("gemma3_f32", "gemma3_q8", "mamba2", "deepseek"))})
        for key in ("unfused_ms", "variant", "bound_ffma_pv_ms", "ffma_ms",
                    "split", "device_ms", "library_device_ms", "geometry",
                    "grid", "geo_f64_launches", "geo_f64_mid_ms",
                    "dbrx_prefill_launches", "seamless_prefill_launches",
                    "llava_prefill_launches"):
            if key in row:
                kernels[-1][key] = row[key]
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "checks": checks, "main": main,
         "fused": fused, "mxp": mxp, "geo": geo_res, "multidevice": md,
         "trace": traced, "disk_tier": disk, "lm": lm, "moe": moe,
         "ssm": ssm, "encdec": encdec, "training": trained,
         "tuner_service": ts,
         "baseline": base, "shim": shim_res, "examples": ex,
         "kernels": kernels, "phase_seconds": phase_s,
         "wall_s": time.perf_counter() - t_script}, indent=1))
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    log(f"chip_smoke: wall time {time.perf_counter() - t_script:.1f}s")
    log(card)
    print(json.dumps({"kernels": kernels}))     # 13. kernels line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
