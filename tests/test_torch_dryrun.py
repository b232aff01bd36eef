"""The port's step accounting and dry-run (``repro_torch.launch.cost``,
``repro_torch.launch.dryrun``; queue 1 item 13.6), the counterparts of the
reference's ``tests/test_distributed.py`` HLO-analyzer cases.

The reference counts the partitioned HLO of a compiled step and multiplies
loop bodies by their trip counts; the port counts the local ops one rank
runs in an eager step, where every trip of a loop is dispatched."""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo

from repro_torch.launch import cost, dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flops_plain_matmul():
    """2 n^3 for one n x n product, and its operands read and result
    written once."""
    a = torch.randn(256, 256)
    r = cost.analyze_step(lambda x, y: x @ y, a, a)
    assert r["flops"] == 2 * 256 ** 3
    assert r["hbm_bytes"] == 3 * 256 * 256 * 4
    assert r["collectives"]["total_count"] == 0


def test_flops_loop_counts_every_trip():
    """The counterpart of the reference's scan case: six products in a
    Python loop count six times; views are free."""
    c, xs = torch.randn(128, 128), torch.randn(6, 128, 128)

    def body(c, xs):
        for i in range(6):
            c = c @ xs[i]
        return c
    r = cost.analyze_step(body, c, xs)
    assert r["flops"] == 6 * 2 * 128 ** 3
    assert r["hbm_bytes"] == 6 * 3 * 128 * 128 * 4


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_collectives_every_trip(fake_world):
    """The counterpart of ``test_hlo_collectives_trip_multiplied``: a
    product of column-sharded operands over an 8-way axis, run five
    times, gathers its left operand five times; the flops are one rank's
    column block.  ``CommDebugMode`` counts the same."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("x",))
    c = distribute_tensor(torch.randn(64, 64), mesh, [Shard(1)],
                          src_data_rank=None)
    xs = distribute_tensor(torch.randn(5, 64, 64), mesh, [Shard(2)],
                           src_data_rank=None)

    def body(c, xs):
        for i in range(5):
            c = (c @ xs[i]).redistribute(mesh, [Shard(1)])
        return c
    r = cost.analyze_step(body, c, xs)
    counts = r["collectives"]["counts"]
    assert counts["all-gather"] == 5, counts
    assert r["collectives"]["comm_debug_counts"] == {
        "c10d_functional.all_gather_into_tensor": 5}
    # each gather's result is the whole 64 x 64 f32 operand
    assert r["collectives"]["bytes"]["all-gather"] == 5 * 64 * 64 * 4
    assert r["flops"] == 5 * 2 * 64 * 64 * 8


def test_roofline_terms_h100():
    """The reference's inputs: the same keys and the same rule; the
    terms on the H100 SXM datasheet's rates, where the collective term
    dominates as it does on the TPU's."""
    coll = {"bytes": {k: 0.0 for k in cost.COLLECTIVES}}
    coll["bytes"]["all-reduce"] = 1e9
    r = cost.roofline_terms(flops=1e12, hbm_bytes=1e9, coll=coll,
                            chips=256, model_flops=2e14)
    want = hlo.roofline_terms(flops=1e12, hbm_bytes=1e9, coll=coll,
                              chips=256, model_flops=2e14)
    assert set(r) == set(want)
    assert r["dominant"] == want["dominant"] == "collective"
    assert r["t_compute_s"] == 1e12 / 989e12
    assert r["t_memory_s"] == 1e9 / 3.35e12
    assert r["t_collective_s"] == 2e9 / 450e9
    assert r["useful_fraction"] == want["useful_fraction"]
    assert cost.wire_bytes(coll) == hlo.wire_bytes(coll)


def test_long_context_skipped_for_full_attention():
    rec = dryrun.lower_cell("qwen3_14b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert "sub-quadratic" in rec["reason"]


def test_full_width_cell_runs(tmp_path):
    """qwen3-14b train_4k on the single-pod mesh: a fake process group of
    256 ranks, the full config's abstract state as DTensors under
    FakeTensorMode, one train step traced.  Per device: flops at least the
    model's share, the collectives CommDebugMode counts, the reference's
    state bytes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "qwen3-14b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(tmp_path)],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(tmp_path / "qwen3-14b__train_4k__single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["chips"] == 256
    roof = rec["roofline"]
    assert rec["hlo_flops"] * 256 >= roof["model_flops"]
    assert 0 < roof["useful_fraction"] <= 1
    coll = rec["collectives"]
    assert coll["counts"]["all-gather"] > 0 and coll["counts"]["all-reduce"] > 0
    assert sum(coll["comm_debug_counts"].values()) == coll["total_count"]
    # the reference's _sharded_bytes of this cell (tests/test_torch_specs.py)
    assert rec["state_bytes_per_device"] == 2462949120
    assert rec["cost_analysis"] is None and rec["memory_analysis"] is None
