"""PyTorch/CUDA port of the mixed-precision out-of-core tile Cholesky.

A second package beside the JAX reference ``repro``, with its layout and
names: the same ``CholeskyConfig -> plan(n, cfg) -> compile() -> OOCSolver``
surface, the same static op streams and precision plans, and hand-written
Hopper kernels for the tile ops.  It imports ``torch``, numpy and scipy,
never ``jax`` or ``repro``.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.

The port covers the Cholesky path: tiling, precision plans, schedules, the
op-stream executor (op by op, or one fused launch per column step with
``fuse_columns``) on one device or, with ``ndev > 1``, on one CUDA stream
per logical device with class-precision broadcast wires (1D and 2D grids,
lookahead), blocked solves, the four per-op kernels (GEMM,
SYRK, TRSM, POTRF) and the fused column-step kernel.  Beside it: the
reference's NumPy replays (``backend="numpy"``, single- and multi-device
schedules, on the host), the analytics (byte volumes, the event simulators
over the ``HW`` datasheet presets, the traces), and the geospatial
workload in :mod:`repro_torch.geo` (Matérn covariances, the Gaussian
log-likelihood and the MxP KL divergence, on the card by default).  It
also covers the LM scaffold's serving path for the dense family
(``configs``, ``models``, ``launch``: prefill through the hand-written
flash attention kernel, and the decode server), with
``convert.params_from_reference`` to carry the reference's weights across.  Every TPU kernel of the reference has its
Hopper counterpart.

The disk tier: ``CholeskyConfig(host_slots=H)`` bounds host residency to
``H`` tile slabs over a :class:`DiskTileStore` (the schedule's FETCH/SPILL
ops), on the card through :class:`SpillTorchExecutor`, whose slabs are
pinned host memory; :class:`RestartableFactorization` resumes a killed
disk-tier replay bit-identically from :mod:`repro_torch.checkpoint`.
Observability: ``factor(a, trace=TraceRecorder())`` records one fenced
span per op on every executor, and :mod:`repro_torch.obs` exports it and
aligns it against the simulator (``drift_report``).

The autotuner: :mod:`repro_torch.tune` calibrates a measured hardware
model on the card and searches ``tb``, the policy, the slot budget and the
precision plan by exact simulation; ``plan(n, CholeskyConfig(tb=0,
policy="auto"))`` resolves through it.  The solver service:
:mod:`repro_torch.serve` (:class:`SolverService`) puts tenants' sessions,
multi-RHS batching and device-memory admission in front of the planner.
See ROADMAP.md for what follows.
"""
from repro_torch.convert import config_from_reference, params_from_reference
from repro_torch.core.analytics import (HW, HardwareModel, ascii_trace,
                                        chrome_trace,
                                        crosscheck_executed_volume, simulate,
                                        simulate_multi, volume_report,
                                        volume_report_multi)
from repro_torch.core.api import (CholeskyConfig, CholeskyPlan, OOCSolver,
                                  clear_plan_cache, plan, plan_cache_stats)
from repro_torch.core.cholesky import (MultiDeviceTorchExecutor,
                                       SpillTorchExecutor,
                                       make_multidevice_torch_executor,
                                       make_torch_executor, plan_for_matrix,
                                       run_multidevice_spill,
                                       run_schedule_spill, run_traced_torch)
from repro_torch.core.spill import (ArrayTileStore, DiskTileStore,
                                    SpilledHostStore, host_residency_at)
from repro_torch.checkpoint import (CheckpointManager,
                                    RestartableFactorization, TileJournal)
from repro_torch.core.precision import (LADDERS, PrecisionPlan,
                                        assign_precision, uniform_plan)
from repro_torch.core.schedule import (MultiDeviceSchedule, Op, OpKind,
                                       Schedule, build_multidevice_schedule,
                                       build_schedule)
from repro_torch.core.taskgraph import build_task_dag, verify_dispatch
from repro_torch.core.tiling import TileLayout, from_tiles, random_spd, to_tiles
from repro_torch.kernels.ops import call_counts, launch_counts, reset_counts
from repro_torch import obs, serve, tune
from repro_torch.obs import NullRecorder, TraceRecorder, drift_report
from repro_torch.serve import SolverService

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "CholeskyConfig", "CholeskyPlan", "OOCSolver", "plan", "clear_plan_cache",
    "plan_cache_stats", "config_from_reference", "params_from_reference",
    "make_torch_executor", "plan_for_matrix", "MultiDeviceTorchExecutor",
    "make_multidevice_torch_executor", "SpillTorchExecutor",
    "run_schedule_spill", "run_multidevice_spill", "run_traced_torch",
    "DiskTileStore", "ArrayTileStore", "SpilledHostStore",
    "host_residency_at", "CheckpointManager", "RestartableFactorization",
    "TileJournal",
    "obs", "TraceRecorder", "NullRecorder", "drift_report",
    "tune", "serve", "SolverService",
    "LADDERS", "PrecisionPlan", "assign_precision", "uniform_plan",
    "MultiDeviceSchedule", "Op", "OpKind", "Schedule",
    "build_multidevice_schedule", "build_schedule",
    "build_task_dag", "verify_dispatch",
    "TileLayout", "from_tiles", "random_spd", "to_tiles",
    "call_counts", "launch_counts", "reset_counts",
    "HardwareModel", "HW", "simulate", "simulate_multi",
    "volume_report", "volume_report_multi", "ascii_trace", "chrome_trace",
    "crosscheck_executed_volume",
]
