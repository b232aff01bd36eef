"""The port's baseline (``repro_torch.core.distributed``) against the
reference's ``repro/core/distributed.py``.

The byte and scaling formulas are arithmetic and equal the reference's
with ``==``, and the port's static schedules reproduce them.
``distributed_cholesky`` runs on ``P`` CPU handles and is held against
LAPACK (the reference test's 1e-11, ``tests/test_distributed.py``) and
against the reference's own factor, which runs in one subprocess on eight
forced host-platform devices.  The reference calls ``shard_map`` with
``check_rep=``, which this JAX no longer takes; in that subprocess only,
the module's ``shard_map`` name is rebound to a wrapper that drops it and
passes ``check_vma=False`` (what ``check_rep=False`` asked for).  The
reference's files are not touched.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import distributed as ref_dist

from repro_torch.core import distributed as dist
from repro_torch.core.schedule import build_multidevice_schedule

N, TB = 256, 16                       # nt = 16
NDEVS = (1, 2, 4, 8)
LAPACK_TOL, REF_TOL = 1e-11, 1e-13


def _spd(n=N, seed=0):
    """The reference test's matrix: x x^T + n I."""
    x = np.random.default_rng(seed).standard_normal((n, n))
    return x @ x.T + n * np.eye(n)


@pytest.mark.parametrize("word", [8, 4, 1])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("nt,tb", [(1, 16), (9, 16), (16, 512), (64, 512)])
def test_panel_broadcast_bytes_equal_the_reference(nt, tb, p, word):
    assert dist.panel_broadcast_bytes(nt, tb, p, word) \
        == ref_dist.panel_broadcast_bytes(nt, tb, p, word)


@pytest.mark.parametrize("word", [8, 2])
@pytest.mark.parametrize("grid", [(1, 1), (4, 1), (1, 4), (2, 2), (2, 3),
                                  (4, 2)])
@pytest.mark.parametrize("nt,tb", [(9, 16), (64, 512)])
def test_grid_broadcast_bytes_equal_the_reference(nt, tb, grid, word):
    assert dist.grid_broadcast_bytes(nt, tb, grid, word) \
        == ref_dist.grid_broadcast_bytes(nt, tb, grid, word)


@pytest.mark.parametrize("nt,tb,ndevs,policy,hw_name,link_bw,grid_of", [
    (8, 512, (1, 2, 4), "v3", "gh200", None, None),
    (12, 1024, (1, 2, 4), "v2", "a100-pcie", 5e9, None),
    (8, 256, (1, 4), "sync", "h100-pcie", None, {4: (2, 2)}),
    (16, 512, (1, 2, 4), "v1", "tpu-v5e", 1e11, {4: (2, 2)}),
])
def test_modeled_scaling_equals_the_reference(nt, tb, ndevs, policy,
                                              hw_name, link_bw, grid_of):
    kw = dict(ndevs=ndevs, policy=policy, hw_name=hw_name, link_bw=link_bw,
              grid_of=grid_of)
    got = dist.modeled_scaling(nt, tb, **kw)
    assert got == ref_dist.modeled_scaling(nt, tb, **kw)
    assert [r["ndev"] for r in got] == list(ndevs)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("nt,tb", [(8, 16), (9, 32), (16, 512)])
def test_panel_bytes_are_the_schedules_broadcast(nt, tb, p):
    """Uniform-f64 plans: the port's static schedule sums the formula's
    tiles op by op."""
    assert build_multidevice_schedule(nt, tb, p).bcast_bytes() \
        == dist.panel_broadcast_bytes(nt, tb, p)


@pytest.mark.parametrize("grid", [(2, 2), (2, 3), (4, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("nt", [8, 12])
def test_grid_bytes_are_the_schedules_broadcast(nt, grid):
    p, q = grid
    assert build_multidevice_schedule(nt, 16, p * q,
                                      grid=grid).bcast_bytes() \
        == dist.grid_broadcast_bytes(nt, 16, grid)


def test_cyclic_permute_is_the_references():
    for nt, p in ((16, 1), (16, 4), (12, 3), (64, 8)):
        assert np.array_equal(dist._cyclic_permute(nt, p),
                              ref_dist._cyclic_permute(nt, p))


_REF_SCRIPT = """
import sys
import numpy as np
import jax
jax.config.update('jax_enable_x64', True)
from jax.sharding import Mesh
import repro.core.distributed as rd

# repro.core.distributed calls shard_map(..., check_rep=False), which this
# JAX no longer takes: rebind the module's name, here only
_shard_map = rd.shard_map


def _without_check_rep(f, *, check_rep=None, **kw):
    return _shard_map(f, check_vma=False, **kw)


rd.shard_map = _without_check_rep
a = np.load(sys.argv[1])
out = sys.argv[2]
for p in %s:
    mesh = Mesh(np.array(jax.devices()[:p]), ('model',))
    np.save(f'{out}/ref_{p}.npy', rd.distributed_cholesky(a, %d, mesh))
print('OK')
""" % (repr(NDEVS), TB)


@pytest.fixture(scope="module")
def reference_factors(tmp_path_factory):
    """The reference's ``distributed_cholesky`` at every ``P`` of
    ``NDEVS``, in one subprocess with eight forced host-platform
    devices."""
    tmp = tmp_path_factory.mktemp("ref_distributed")
    np.save(tmp / "a.npy", _spd())
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    env.update({k: v for k, v in os.environ.items()
                if k not in env and k != "XLA_FLAGS"})
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF_SCRIPT),
         str(tmp / "a.npy"), str(tmp)], capture_output=True, text=True,
        timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"
    return {p: np.load(tmp / f"ref_{p}.npy") for p in NDEVS}


@pytest.mark.parametrize("p", NDEVS)
def test_distributed_cholesky_against_lapack_and_the_reference(
        reference_factors, p):
    a = _spd()
    nt = N // TB
    l, stats = dist.distributed_cholesky_with_stats(a, TB, p, device="cpu")
    assert l.dtype == np.float64 and l.shape == (N, N)
    assert np.array_equal(l, np.tril(l))
    assert np.abs(l - np.linalg.cholesky(a)).max() < LAPACK_TOL
    ref = reference_factors[p]
    assert np.abs(l - ref).max() < REF_TOL * np.abs(a).max()
    # one row sent a step to each of the other P - 1 devices: the formula's
    # bytes, which the static schedule's BCAST/RECV edges also carry
    assert stats.pop("factor_s") > 0
    assert stats == {"steps": nt, "bcast_copies": nt * (p - 1),
                     "bcast_bytes": dist.panel_broadcast_bytes(nt, TB, p)}
    assert stats["bcast_bytes"] \
        == build_multidevice_schedule(nt, TB, p).bcast_bytes()


def test_distributed_cholesky_takes_tensors_and_leaves_the_input():
    a = _spd(seed=3)
    t = torch.from_numpy(a.copy())
    l = dist.distributed_cholesky(t, TB, 4, device=["cpu"] * 4)
    assert torch.equal(t, torch.from_numpy(a))
    assert np.array_equal(l, dist.distributed_cholesky(a, TB, 4,
                                                       device="cpu"))
    # f32 words: the bytes sent follow the dtype
    l32, st = dist.distributed_cholesky_with_stats(a, TB, 4, device="cpu",
                                                   dtype=torch.float32)
    assert st["bcast_bytes"] == dist.panel_broadcast_bytes(N // TB, TB, 4,
                                                           word=4)
    assert np.abs(l32 - np.linalg.cholesky(a)).max() \
        < 1e-4 * np.abs(l32).max()


@pytest.mark.parametrize("p", [3, 5, 32])
def test_tile_rows_must_divide_among_the_devices(p):
    with pytest.raises(ValueError, match="divisible by device count"):
        dist.distributed_cholesky(_spd(), TB, p, device="cpu")


def test_distributed_cholesky_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.distributed_cholesky(_spd(), TB, 2)


@pytest.mark.parametrize("p", [2, 4])
def test_zeros_broadcast_fails_the_lapack_check(monkeypatch, p):
    """The control ``chip_smoke.py`` swaps in: a broadcast that delivers
    zeros must fail the check the real one passes."""
    monkeypatch.setattr(dist, "_send",
                        lambda panel, device: torch.zeros(
                            panel.shape, dtype=panel.dtype, device=device))
    a = _spd()
    l = dist.distributed_cholesky(a, TB, p, device="cpu")
    err = np.abs(l - np.linalg.cholesky(a)).max()
    assert not err < LAPACK_TOL
