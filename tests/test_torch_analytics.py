"""The port's analytics against the reference's: byte volumes, the event
simulators over every hardware preset, the executed-volume crosscheck and
the traces.  Each schedule is built twice from the same arguments, once
through each package (``OpKind`` is a different enum in each), and every
output is compared with ``==``: the port keeps the reference's arithmetic
order."""
import dataclasses
import json

import numpy as np
import pytest

from repro import plan as ref_plan, CholeskyConfig as RefConfig
from repro.core import analytics as ref_an
from repro.core import precision as ref_precision
from repro.core import schedule as ref_schedule

import repro_torch
from repro_torch.core import analytics as an
from repro_torch.core import precision, schedule

POLICIES = ("sync", "async", "v1", "v2", "v3", "v4")
NT, TB = 8, 64
PRESETS = tuple(ref_an.HW)
# (ndev, grid, lookahead) of the multi-device cases
MULTI = [(2, None, 0), (2, None, 1), (2, None, 2), (4, None, 0),
         (4, None, 1), (4, None, 2), (4, (2, 2), 0), (4, (2, 2), 1),
         (4, (2, 2), 2)]


def _classes(nt, seed=0):
    """An MxP class table with every class of the tpu ladder."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 4, size=(nt, nt)).astype(np.int8)
    cls = np.tril(cls) + np.tril(cls, -1).T
    cls[np.diag_indices(nt)] = 0
    return cls


def _plans(kind, nt=NT):
    """The same precision plan in each package: uniform f64, or MxP."""
    if kind == "f64":
        return (ref_precision.uniform_plan(nt, "f64"),
                precision.uniform_plan(nt, "f64"))
    cls = _classes(nt)
    lad = ref_precision.LADDERS["tpu"]
    return (ref_precision.PrecisionPlan(cls.copy(), lad, 1e-6),
            precision.PrecisionPlan(cls.copy(), lad, 1e-6))


def _single(policy, kind, host_slots=0):
    kw = dict(block=(2, 2)) if policy == "v4" else {}
    rp, pp = _plans(kind)
    return (ref_schedule.build_schedule(NT, TB, policy, plan=rp,
                                        host_slots=host_slots, **kw),
            schedule.build_schedule(NT, TB, policy, plan=pp,
                                    host_slots=host_slots, **kw))


def _multi(ndev, grid, lookahead, kind, policy="v3", host_slots=0):
    rp, pp = _plans(kind)
    kw = dict(grid=grid, lookahead=lookahead, host_slots=host_slots)
    return (ref_schedule.build_multidevice_schedule(NT, TB, ndev, policy,
                                                    plan=rp, **kw),
            schedule.build_multidevice_schedule(NT, TB, ndev, policy,
                                                plan=pp, **kw))


def test_presets_carry_the_reference_values():
    assert tuple(an.HW) == PRESETS
    for name in PRESETS:
        assert dataclasses.asdict(an.HW[name]) == \
            dataclasses.asdict(ref_an.HW[name])
        for task in ("gemm", "syrk"):
            for cls in ("f64", "f32", "f16", "bf16", "f8e4m3", "f8e4m3s"):
                assert an.HW[name].task_rate(task, cls) == \
                    ref_an.HW[name].task_rate(task, cls)
        assert an.HW[name].max_cache_slots(512, 3) == \
            ref_an.HW[name].max_cache_slots(512, 3)
        assert an.HW[name].max_host_slots(512) == \
            ref_an.HW[name].max_host_slots(512)


@pytest.mark.parametrize("timeline", [False, True], ids=["no_tl", "tl"])
@pytest.mark.parametrize("kind", ["f64", "mxp"])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_and_volume_equal_reference(policy, kind, timeline):
    ref, port = _single(policy, kind)
    assert an.volume_report(port) == ref_an.volume_report(ref)
    for name in PRESETS:
        want = ref_an.simulate(ref, ref_an.HW[name], record_timeline=timeline)
        got = an.simulate(port, an.HW[name], record_timeline=timeline)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert (got.tflops, got.total_bytes) == (want.tflops,
                                                 want.total_bytes)


def test_simulate_accepts_the_single_device_multischedule():
    ref, port = _single("v3", "mxp")
    hw, rhw = an.HW["gh200"], ref_an.HW["gh200"]
    got = an.simulate(schedule.MultiDeviceSchedule.from_single(port), hw)
    want = ref_an.simulate(ref_schedule.MultiDeviceSchedule.from_single(ref),
                           rhw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("timeline", [False, True], ids=["no_tl", "tl"])
@pytest.mark.parametrize("kind", ["f64", "mxp"])
@pytest.mark.parametrize("ndev,grid,lookahead", MULTI)
def test_simulate_multi_and_volume_equal_reference(ndev, grid, lookahead,
                                                   kind, timeline):
    ref, port = _multi(ndev, grid, lookahead, kind)
    assert an.volume_report_multi(port) == ref_an.volume_report_multi(ref)
    for name in PRESETS:
        for link_bw in (None, 7e9):
            want = ref_an.simulate_multi(ref, ref_an.HW[name],
                                         link_bw=link_bw,
                                         record_timeline=timeline)
            got = an.simulate_multi(port, an.HW[name], link_bw=link_bw,
                                    record_timeline=timeline)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
            assert (got.tflops, got.compute_efficiency) == \
                (want.tflops, want.compute_efficiency)


@pytest.mark.parametrize("policy", ["sync", "v1", "v2"])
def test_simulate_multi_other_policies(policy):
    ref, port = _multi(4, (2, 2), 1, "mxp", policy=policy)
    want = ref_an.simulate_multi(ref, ref_an.HW["a100-pcie"],
                                 record_timeline=True)
    got = an.simulate_multi(port, an.HW["a100-pcie"], record_timeline=True)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("hw", [None, "h100-pcie"])
@pytest.mark.parametrize("off", [0, 1], ids=["equal", "off_by_one"])
def test_crosscheck_executed_volume_equal_reference(off, hw):
    ref, port = _multi(4, (2, 2), 1, "mxp")
    bc = [o for s in port.streams for o in s
          if o.kind is schedule.OpKind.BCAST]
    executed = {"bcast_ops": len(bc) + off,
                "recv_ops": port.count(schedule.OpKind.RECV),
                "bcast_bytes": sum(o.bytes for o in bc),
                "recv_bytes": port.bcast_bytes() - off}
    got = an.crosscheck_executed_volume(
        port, dict(executed), hw=an.HW[hw] if hw else None)
    want = ref_an.crosscheck_executed_volume(
        ref, dict(executed), hw=ref_an.HW[hw] if hw else None)
    assert got == want
    assert got["match"] is (off == 0)
    with pytest.raises(ValueError):
        an.crosscheck_executed_volume(port, None)


def _traces_equal(got, want, tmp_path, ascii=True):
    """chrome_trace's dict and file; ascii_trace (single-device lanes)."""
    assert an.chrome_trace(got) == ref_an.chrome_trace(want)
    if ascii:
        for width in (40, 100):
            assert an.ascii_trace(got, width) == ref_an.ascii_trace(want,
                                                                    width)
    an.chrome_trace(got, tmp_path / "port.json")
    ref_an.chrome_trace(want, tmp_path / "ref.json")
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())


@pytest.mark.parametrize("host_slots", [0, 6], ids=["resident", "spill"])
@pytest.mark.parametrize("policy", ["sync", "v3"])
def test_traces_equal_reference(policy, host_slots, tmp_path):
    """The spill schedule's disk lane included: the port builds spill
    schedules, though its executors do not run them."""
    ref, port = _single(policy, "mxp", host_slots=host_slots)
    want = ref_an.simulate(ref, ref_an.HW["h100-pcie"], record_timeline=True)
    got = an.simulate(port, an.HW["h100-pcie"], record_timeline=True)
    _traces_equal(got, want, tmp_path)
    if host_slots:
        assert "Disk" in an.ascii_trace(got)
        assert got.fetch_bytes == want.fetch_bytes > 0


@pytest.mark.parametrize("host_slots", [0, 6], ids=["resident", "spill"])
def test_multi_traces_equal_reference(host_slots, tmp_path):
    lookahead = 0 if host_slots else 2      # spill excludes lookahead
    ref, port = _multi(4, (2, 2), lookahead, "mxp", host_slots=host_slots)
    want = ref_an.simulate_multi(ref, ref_an.HW["gh200"],
                                 record_timeline=True)
    got = an.simulate_multi(port, an.HW["gh200"], record_timeline=True)
    _traces_equal(got, want, tmp_path, ascii=False)


def test_traces_without_timeline():
    ref, port = _single("v3", "f64")
    got = an.simulate(port, an.HW["gh200"])
    want = ref_an.simulate(ref, ref_an.HW["gh200"])
    assert an.ascii_trace(got) == ref_an.ascii_trace(want)
    with pytest.raises(ValueError, match="record_timeline"):
        an.chrome_trace(got)


@pytest.mark.parametrize("ndev,grid,lookahead",
                         [(1, None, None), (2, None, 1), (4, (2, 2), 2)])
def test_plan_simulate_and_volume_through_the_api(ndev, grid, lookahead):
    """CholeskyPlan/OOCSolver.simulate and volume: single-device on the
    torch backend, multi-device on the numpy one, each against the
    reference's plan of the same config."""
    n = NT * TB
    backend = "numpy" if ndev > 1 else "auto"
    kw = dict(tb=TB, policy="v3", ndev=ndev, grid=grid, lookahead=lookahead,
              backend=backend)
    p = repro_torch.plan(n, repro_torch.CholeskyConfig(**kw))
    rp = ref_plan(n, RefConfig(**kw))
    solver = p.compile(device="cpu")
    assert solver.volume() == p.volume() == rp.volume()
    for name in ("h100-pcie", "tpu-v5e"):
        got = solver.simulate(an.HW[name], record_timeline=True)
        want = rp.simulate(ref_an.HW[name], record_timeline=True)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
