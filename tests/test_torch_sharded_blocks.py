"""Two helpers of the sharded path that the card needs where the CPU
does not show why, each with a control.

- ``sharding.contiguous_grad``: a gradient whose own block keeps odd
  strides under contiguous global ones (as a block's gradient from
  ``on_local_blocks`` does) comes back with its block contiguous, and a
  view further back takes it; on a one-rank (1, 1) mesh and a fake 2 x 2
  world (layouts only: its collectives move no data).  Control: without
  it that view raises.
- ``sharding.recompute_context``: a rematerialised block's recompute in
  a backward run on another thread (as the autograd engine runs a card's)
  sees the forward's ``activation_sharding`` context.  Control: without
  it the recompute sees none, and the checkpoint refuses its shapes.
  On a card the same with the backward on the autograd engine's own
  device thread.
- ``launch.cost.analyze_step``'s breakdown by op: a matmul of a DTensor
  split over "data" by a weight split over "model" reads at the local
  shapes each rank runs, on a (1, 1) and a fake 2 x 2 mesh.
- ``attention.on_head_shards`` on a kv run (``attention._kv_run``: "model"
  splits the query heads but not the kv heads, so each rank reads only
  the kv heads its query heads use): four gloo processes on a (1, 4)
  mesh, 8 query heads over 2 kv heads, so each rank reads one of the two.
  The chunked attention's output and the gradients of q, k and v, and
  the flash wrapper's output (its plain version here), against the same
  attention on the whole tensors, within 1e-5 of the largest value;
  every block handed to the attention is contiguous (a kernel reads
  dense operands from their pointers).  Controls: the kv heads swapped
  miss that bound, and the raw slice of a one-head run is not
  contiguous.  On a card: the flash kernel on a kv run against its plain
  version on the same heads, within the flash tests' bf16 tolerance
  (control: the other kv head misses it), and the wrapper refusing the
  raw slice.
"""
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as S
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.mesh import abstract_mesh, make_smoke_mesh
from repro_torch.models import attention as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=[(1, 1), (2, 2)], ids=["1x1", "2x2"])
def mesh(request):
    """A one-rank gloo world, or a fake world of four ranks (layouts only:
    its collectives move no data), closed after."""
    if request.param == (1, 1):
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
    yield make_smoke_mesh(request.param, ("data", "model"),
                          device_type="cpu")
    dist.destroy_process_group()


class _OddBlockGrad(torch.autograd.Function):
    """The identity, whose backward hands back a DTensor gradient with the
    same values but its own block's last two dimensions column-major."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        odd = g.to_local().transpose(-1, -2).contiguous().transpose(-1, -2)
        return DTensor.from_local(odd, g.device_mesh, g.placements,
                                  run_check=False, shape=g.shape,
                                  stride=g.stride())


def _grad_through(wrap, mesh):
    """The gradient of a [16, 6] DTensor split over "data" through an
    unflatten (whose backward is a view), ``wrap`` and ``_OddBlockGrad``."""
    x = S.distribute(torch.arange(96.0).reshape(16, 6), S.P("data"), mesh)
    x.requires_grad_(True)
    w = S.distribute(torch.arange(96.0).reshape(4, 4, 6), S.P("data"), mesh)
    y = _OddBlockGrad.apply(wrap(x.unflatten(0, (4, 4))))
    (g,) = torch.autograd.grad((y * w).sum(), [x])
    return g


def test_contiguous_grad_makes_the_block_contiguous(mesh):
    g = _grad_through(S.contiguous_grad, mesh)
    assert g.to_local().is_contiguous()
    assert tuple(g.placements) == S.placements(S.P("data"), mesh)
    if mesh.size() == 1:
        assert torch.equal(S.full(g), torch.arange(96.0).reshape(16, 6))
    with pytest.raises(RuntimeError, match="view size is not compatible"):
        _grad_through(lambda t: t, mesh)


def test_cost_by_op_reads_local_shapes(mesh):
    from repro_torch.launch import cost
    x = S.distribute(torch.ones(8, 6), S.P("data"), mesh)
    w = S.distribute(torch.ones(6, 4), S.P(None, "model"), mesh)
    stats = cost.analyze_step(lambda a, b: a @ b, x, w, by_module=True)
    d, m = mesh.shape
    rows, cols = 8 // d, 4 // m
    assert stats["by_op"] == {f"mm ({rows}, 6) x (6, {cols})": {
        "flops": 2 * rows * 6 * cols, "count": 1}}


def _recompute_in_a_thread(context_fn, device=None) -> tuple:
    """(the dispatch groups the forward and the recompute read, the
    gradient or the exception): a rematerialised block whose shapes
    follow ``moe_group_count``, its forward under a 2 x 2 mesh's
    activation sharding and its backward on another thread: a Python
    thread, or on a card (``device``) the autograd engine's own."""
    seen = []

    def block(x):
        groups = S.moe_group_count(x.shape[0])
        seen.append(groups)
        return (x.reshape(groups, -1) ** 2).sum(-1)

    x = torch.arange(8.0, device=device, requires_grad=True)
    with S.activation_sharding(abstract_mesh((2, 2), ("data", "model"))):
        y = checkpoint(block, x, use_reentrant=False, context_fn=context_fn)
    out = {}

    def backward():
        try:
            out["grad"] = torch.autograd.grad(y.sum(), [x])[0].cpu()
        except Exception as e:          # noqa: BLE001  (the control's)
            out["error"] = e
    if device is not None:
        backward()
        return seen, out
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    return seen, out


def test_recompute_sees_the_forwards_activation_sharding():
    seen, out = _recompute_in_a_thread(S.recompute_context)
    assert seen == [2, 2]
    assert torch.equal(out["grad"], 2 * torch.arange(8.0))
    from torch.utils.checkpoint import noop_context_fn
    seen, out = _recompute_in_a_thread(noop_context_fn)
    assert seen == [2, 1] and "error" in out


@pytest.mark.cuda
def test_cuda_recompute_sees_the_forwards_activation_sharding():
    """As above, with the backward on the card: the autograd engine runs
    it on its own thread for the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the engine's device thread)")
    cuda = torch.device("cuda")
    seen, out = _recompute_in_a_thread(S.recompute_context, cuda)
    assert seen == [2, 2]
    assert torch.equal(out["grad"], 2 * torch.arange(8.0))
    from torch.utils.checkpoint import noop_context_fn
    seen, out = _recompute_in_a_thread(noop_context_fn, cuda)
    assert seen == [2, 1] and "error" in out


# ---------------------------------------------------------------------------
# kv runs: "model" splits the query heads but not the kv heads
# ---------------------------------------------------------------------------

KV_B, KV_S, KV_H, KV_KV, KV_HD = 2, 16, 8, 2, 8
KV_TOL = 1e-5                   # of the largest value; f32, sums reordered
KV_RUNS = [(0, 1), (0, 1), (1, 2), (1, 2)]      # rank r of a (1, 4) mesh

KV_PORT = """
import pickle, sys
import torch, torch.distributed as dist
from repro_torch.distributed.sharding import P, distribute, full
from repro_torch.kernels.flash_attention import flash_gqa
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import attention as A

rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + d + "/store",
                        rank=rank, world_size=4)
mesh = make_smoke_mesh((1, 4), ("data", "model"), device_type="cpu")
inp = pickle.load(open(d + "/inputs.pkl", "rb"))
heads, whole = P("data", None, "model"), P("data")
q, k, v, w = (distribute(torch.from_numpy(inp[n]), spec, mesh)
              for n, spec in (("q", heads), ("k", whole), ("v", whole),
                              ("w", heads)))
seen = []
chunked = A._sdpa_chunked

def recorded(q, k, v, **kw):
    seen.append((tuple(k.shape), k.is_contiguous() and v.is_contiguous()))
    return chunked(q, k, v, **kw)

A._sdpa_chunked = recorded
for t in (q, k, v):
    t.requires_grad_(True)
out = A._attend(q, k, v, causal=True)
(out * w).sum().backward()
with torch.no_grad():
    flash = A.on_head_shards(flash_gqa, q, k, v, causal=True)
res = {"run": A._kv_run(mesh, q.shape[2], k.shape[2]), "seen": seen,
       "out": full(out).detach(), "flash": full(flash),
       **{"d" + n: full(t.grad) for n, t in (("q", q), ("k", k), ("v", v))}}
pickle.dump(res, open(d + "/port%d.pkl" % rank, "wb"))
dist.destroy_process_group()
"""


def _kv_inputs() -> dict:
    rng = np.random.default_rng(11)
    shapes = {"q": (KV_B, KV_S, KV_H, KV_HD), "k": (KV_B, KV_S, KV_KV, KV_HD),
              "v": (KV_B, KV_S, KV_KV, KV_HD), "w": (KV_B, KV_S, KV_H, KV_HD)}
    return {n: rng.standard_normal(sh).astype(np.float32)
            for n, sh in shapes.items()}


def _whole(inp: dict, flip: bool = False) -> dict:
    """The attention on whole tensors: output, flash's plain version and
    the gradients; with ``flip``, the kv heads swapped."""
    q, k, v, w = (torch.from_numpy(inp[n]) for n in "qkvw")
    if flip:
        k, v = k.flip(2), v.flip(2)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = A._sdpa_chunked(q, k, v, causal=True)
    (out * w).sum().backward()
    with torch.no_grad():
        flash = fa.flash_gqa(q, k, v, causal=True)
    return {"out": out.detach(), "flash": flash, "dq": q.grad,
            "dk": k.grad.flip(2) if flip else k.grad,
            "dv": v.grad.flip(2) if flip else v.grad}


def _within(got, want) -> bool:
    return float((got - want).abs().max()) <= KV_TOL * float(
        want.abs().max())


@pytest.fixture(scope="module")
def kv_runs(tmp_path_factory):
    """(inputs, each rank's results) of the four gloo processes."""
    d = str(tmp_path_factory.mktemp("kv_run"))
    inp = _kv_inputs()
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", KV_PORT, str(r), d],
                              env=env, cwd=ROOT, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return inp, [pickle.load(open(os.path.join(d, f"port{r}.pkl"), "rb"))
                 for r in range(4)]


@pytest.mark.parametrize("name", ["out", "flash", "dq", "dk", "dv"])
def test_kv_run_against_whole_heads(kv_runs, name):
    inp, ranks = kv_runs
    want, swapped = _whole(inp), _whole(inp, flip=True)
    for r, res in enumerate(ranks):
        assert res["run"] == KV_RUNS[r]
        assert _within(res[name], want[name]), (r, name)
    assert not _within(swapped[name], want[name])


def test_kv_run_blocks_are_contiguous(kv_runs):
    _, ranks = kv_runs
    for res in ranks:
        # the forward, and the recompute of none (no remat here)
        assert res["seen"] == [((KV_B, KV_S, 1, KV_HD), True)]
    whole = torch.zeros(KV_B, KV_S, KV_KV, KV_HD)
    assert not whole[:, :, 0:1].is_contiguous()


def _flash_kv_run_case(device, run):
    """The flash wrapper through ``_on_kv_run`` on a kv run of two kv
    heads against its plain version on the same head, in bf16, hd 128,
    S = T = 256.  The raw slice, not contiguous, goes to the plain version
    on the CPU and is refused on a card.  Returns the launches counted."""
    rng = np.random.default_rng(5 + run[0])

    def rand(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(device, torch.bfloat16)

    b, s, hd = 2, 256, 128
    q, k, v = rand(b, s, 2, hd), rand(b, s, 2, hd), rand(b, s, 2, hd)
    lo, hi = run
    blk = {"causal": True, "bq": s, "bk": s}
    ops.reset_counts()
    got = A._on_kv_run(q, k, v, attend=fa.flash_gqa, run=run, **blk)
    if device.type == "cuda":
        torch.cuda.synchronize()
        with pytest.raises(ValueError, match="contiguous"):
            fa.flash_gqa(q, k[:, :, lo:hi], v[:, :, lo:hi], **blk)
    launched = ops.launch_counts()["flash_attention"]
    want = fa.flash_gqa_ref(q, k[:, :, lo:hi].contiguous(),
                            v[:, :, lo:hi].contiguous(), **blk)
    other = fa.flash_gqa_ref(q, k[:, :, 1 - lo:2 - lo].contiguous(),
                             v[:, :, 1 - lo:2 - lo].contiguous(), **blk)
    tol = 3e-2                  # the flash card tests' bf16 tolerance
    torch.testing.assert_close(got.double(), want.double(), atol=tol,
                               rtol=tol)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(other.double(), want.double(), atol=tol,
                                   rtol=tol)
    return launched


@pytest.mark.parametrize("run", [(0, 1), (1, 2)])
def test_flash_kv_run_plain(run):
    assert _flash_kv_run_case(torch.device("cpu"), run) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("run", [(0, 1), (1, 2)])
def test_cuda_flash_kv_run(run):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    assert _flash_kv_run_case(torch.device("cuda"), run) == 1
