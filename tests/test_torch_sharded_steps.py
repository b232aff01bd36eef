"""The port's sharded path (queue 1 item 13.6) on a 2 x 2 ("data",
"model") mesh of four gloo processes, against the reference's steps on
four forced host devices and against the port's own unsharded steps, at
smoke size in f32.

The reference runs in a subprocess on a mesh with Auto axes built here
(``jax.sharding.Mesh`` over ``jax.devices()[:4]``): the installed JAX's
``jax.make_mesh`` builds Explicit axes, which the reference's
``with_sharding_constraint`` refuses, so its own 2x2 tests fail; its
package is untouched.  Both packages start from the reference's seeded
parameters and one batch made with numpy from a seed.

Bounds are the unsharded ones of ``test_torch_train.py`` (loss and
grad_norm within LOSS_TOL relative, parameters after a step within
STEP_TOL x LR where the gradient is above STEP_G_FLOOR of its largest and
STEP_ANY x LR everywhere) and ``test_torch_models.py`` (MODEL_TOL for a
whole model's logits), each with a control that must fail it.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
LOSS_TOL = 1e-5
STEP_TOL = 0.2
STEP_ANY = 2.5
STEP_G_FLOOR = 1e-3
MODEL_TOL = 1e-4
# the sharded port against its own unsharded steps: the same f32 products
# with partial sums over "model" added in another order (readings ~1e-7)
SELF_TOL = 1e-5
B, S = 4, 16
# deepseek's expert capacity in the grouped-dispatch case: tight enough that
# assignments drop, so one group and two give different logits
CAPACITY = 0.5


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("XLA_FLAGS", None)
    return env


REFERENCE = """
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed.sharding import activation_sharding, params_shardings
from repro.launch import specs as S
from repro.launch.steps import (make_prefill_step, make_serve_step,
                                make_train_step)
from repro.models import transformer as T
from repro.optim.adamw import adamw_init

d = sys.argv[1]
inp = pickle.load(open(d + "/inputs.pkl", "rb"))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
assert mesh.shape["data"] == 2
out = {}

def shardings(cfg, params):
    return params_shardings(T.init_model_abstract(cfg)[1], params, mesh)

cfg = get_config("qwen3_14b", smoke=True)
params = jax.tree.map(jnp.asarray, inp["qwen3"])
p_sh = shardings(cfg, params)
opt = adamw_init(params)
rep = NamedSharding(mesh, P())
opt_sh = type(opt)(step=rep, m=p_sh, v=p_sh)
batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
b_sh = {k: NamedSharding(mesh, P("data", None)) for k in batch}
with mesh, activation_sharding(mesh):
    step = jax.jit(make_train_step(cfg, lr=%(lr)r),
                   in_shardings=(p_sh, opt_sh, b_sh))
    p1, _, m = step(params, opt, batch)
out["train"] = {"params": jax.tree.map(np.asarray, p1),
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}

cache = T.init_cache(cfg, %(b)d, 32, jnp.float32)
cache_sh = S.cache_shardings(cfg, cache, mesh)
tok = jnp.asarray(inp["batch"]["tokens"][:, :1])
with mesh, activation_sharding(mesh):
    serve = jax.jit(make_serve_step(cfg),
                    in_shardings=(p_sh, cache_sh,
                                  NamedSharding(mesh, P("data", None)),
                                  NamedSharding(mesh, P())))
    logits, cache = serve(params, cache, tok, jnp.int32(0))
    logits2, _ = serve(params, cache, tok + 1, jnp.int32(1))
out["serve"] = [np.asarray(logits), np.asarray(logits2)]

cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b", smoke=True),
                          moe_capacity=%(cap)r)
params = jax.tree.map(jnp.asarray, inp["deepseek"])
p_sh = shardings(cfg, params)
with mesh, activation_sharding(mesh):
    from repro.distributed.sharding import moe_group_count
    out["groups"] = moe_group_count(%(b)d * %(s)d)
    pre = jax.jit(make_prefill_step(cfg), in_shardings=(p_sh, b_sh["tokens"]))
    out["deepseek"] = np.asarray(pre(params, {"tokens": batch["tokens"]}))
opt = adamw_init(params)
opt_sh = type(opt)(step=rep, m=p_sh, v=p_sh)
with mesh, activation_sharding(mesh):
    step = jax.jit(make_train_step(cfg, lr=%(lr)r),
                   in_shardings=(p_sh, opt_sh, b_sh))
    p1, _, m = step(params, opt, batch)
out["deepseek_train"] = {"params": jax.tree.map(np.asarray, p1),
                         "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"])}
pickle.dump(out, open(d + "/reference.pkl", "wb"))
""" % {"lr": LR, "b": B, "s": S, "cap": CAPACITY}

PORT = """
import dataclasses, pickle, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.distributed.sharding import (P, activation_sharding,
    distribute, distribute_model, full, moe_group_count)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + d + "/store",
                        rank=rank, world_size=4)
mesh = make_smoke_mesh((2, 2), ("data", "model"), device_type="cpu")
inp = pickle.load(open(d + "/inputs.pkl", "rb"))
batch = {k: distribute(torch.from_numpy(v).long(), P("data", None), mesh)
         for k, v in inp["batch"].items()}
out = {}

def model_of(arch, key, **changes):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    return cfg, distribute_model(params_from_reference(inp[key], cfg,
                                                       device="cpu"), mesh)

cfg, model = model_of("qwen3_14b", "qwen3")
with activation_sharding(mesh):
    model.requires_grad_(True)
    model, _, m = make_train_step(cfg, lr=%(lr)r)(model, adamw_init(model),
                                                  batch)
    out["train"] = {"params": {k: full(v).detach().numpy()
                               for k, v in model.state_dict().items()},
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
    out["placements"] = {k: str(v.placements)
                         for k, v in model.state_dict().items()}

cfg, model = model_of("qwen3_14b", "qwen3")
cache = T.init_cache(cfg, %(b)d, 32, torch.float32, device="cpu")
cache = [{k: distribute(t, sh[k], mesh) for k, t in c.items()}
         for c, sh in zip(cache, S.cache_shardings(cfg, cache, mesh))]
tok = distribute(torch.from_numpy(inp["batch"]["tokens"][:, :1]).long(),
                 P("data", None), mesh)
serve = make_serve_step(cfg)
with activation_sharding(mesh):
    l1, cache = serve(model, cache, tok, 0)
    l2, cache = serve(model, cache, tok + 1, 1)
    out["serve"] = [full(l1).numpy(), full(l2).numpy()]
    out["cache_placements"] = str(cache[0]["k"].placements)

cfg, model = model_of("deepseek_v2_lite_16b", "deepseek",
                      moe_capacity=%(cap)r)
with activation_sharding(mesh):
    out["groups"] = moe_group_count(%(b)d * %(s)d)
    out["deepseek"] = full(make_prefill_step(cfg)(
        model, {"tokens": batch["tokens"]})).numpy()
# deepseek's train step, MLA's attention core counted by its operand type
from repro_torch.models import attention as A
attend, out["mla_attend_types"] = A._mla_attend, []


def counted(p, cfg, q_nope, *rest):
    out["mla_attend_types"].append(type(q_nope).__name__)
    return attend(p, cfg, q_nope, *rest)


A._mla_attend = counted
cfg, model = model_of("deepseek_v2_lite_16b", "deepseek",
                      moe_capacity=%(cap)r)
with activation_sharding(mesh):
    model.requires_grad_(True)
    model, _, m = make_train_step(cfg, lr=%(lr)r)(model, adamw_init(model),
                                                  batch)
    out["deepseek_train"] = {"params": {k: full(v).detach().numpy()
                                        for k, v in model.state_dict().items()},
                             "loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"])}
A._mla_attend = attend
# train(mesh=): four steps straight, and two then two more resumed from
# each process's checkpoint (Q8 moments: whole on every rank)
from repro_torch.launch.train import train
kw = dict(arch="qwen3-14b", steps=4, batch=%(b)d, seq=%(s)d, save_every=2,
          log_every=100, device="cpu", mesh=mesh, quantized_opt=True)
m1, l1 = train(**kw, ckpt_dir=d + "/ck_a")
train(**dict(kw, steps=2), ckpt_dir=d + "/ck_b")
m2, l2 = train(**kw, ckpt_dir=d + "/ck_b")
out["resume"] = {"straight": l1, "resumed": l2, "params_bitwise": all(
    torch.equal(full(a), full(b)) for a, b in
    zip(m1.state_dict().values(), m2.state_dict().values()))}
if rank == 0:
    pickle.dump(out, open(d + "/port.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
""" % {"lr": LR, "b": B, "s": S, "cap": CAPACITY}


def _ref_params(arch):
    cfg = jconfigs.get_config(arch, smoke=True)
    return jax.tree.map(np.asarray, JT.init_model(cfg, jax.random.PRNGKey(0))[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' 2 x 2 runs, side by side: (inputs, reference,
    port)."""
    d = str(tmp_path_factory.mktemp("sharded"))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 128, (B, S)).astype(np.int32)
    inputs = {"qwen3": _ref_params("qwen3_14b"),
              "deepseek": _ref_params("deepseek_v2_lite_16b"),
              "batch": {"tokens": toks, "labels": np.roll(toks, -1, 1)}}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = _env()
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(
        REFERENCE), d], env=ref_env, cwd=ROOT, stderr=subprocess.PIPE,
        text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", PORT, str(r), d],
                               env=dict(env, OMP_NUM_THREADS="1"), cwd=ROOT,
                               stderr=subprocess.PIPE, text=True)
              for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    load = lambda n: pickle.load(open(os.path.join(d, n), "rb"))  # noqa: E731
    return inputs, load("reference.pkl"), load("port.pkl")


def _port_model(arch, inputs, key):
    return params_from_reference(inputs[key], configs.get_config(
        arch, smoke=True), device="cpu")


def _state(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _unsharded_train(inputs, arch="qwen3_14b", key="qwen3", **changes):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              **changes)
    model = _port_model(arch, inputs, key).requires_grad_(True)
    batch = {k: torch.from_numpy(v).long() for k, v in inputs["batch"].items()}
    _, grads = steps.loss_and_grads(model, cfg, batch)
    model, _, m = steps.make_train_step(cfg, lr=LR)(model, adamw_init(model),
                                                    batch)
    return (_state(model), {k: float(v) for k, v in m.items()},
            {k: g.numpy() for k, g in grads.items()})


def _hold_train_step(got, want, unsharded, cfg, inputs, key):
    """A sharded train step's loss, grad_norm and parameters after it
    (``got``) against the reference's sharded step (``want``; None where
    the reference did not run it) and the port's unsharded one, at the
    bounds above.  Control: the parameters before the step."""
    after, metrics, grads = unsharded
    want_p = (None if want is None else
              _state(params_from_reference(want["params"], cfg,
                                           device="cpu")))
    for k in ("loss", "grad_norm"):
        if want is not None:
            assert abs(got[k] - want[k]) <= LOSS_TOL * abs(want[k])
        assert abs(got[k] - metrics[k]) <= SELF_TOL * abs(metrics[k])
    for target in (want_p, after):
        if target is not None:
            assert _excess(got["params"], target, grads, True) <= STEP_TOL
            assert _excess(got["params"], target, grads, False) <= STEP_ANY
    before = _state(params_from_reference(inputs[key], cfg, device="cpu"))
    assert _excess(before, after if want_p is None else want_p, grads,
                   True) > STEP_TOL


def _excess(got: dict, want: dict, grads: dict, floor: bool) -> float:
    worst = 0.0
    for k, w in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - w)
        if floor:
            g = np.abs(grads[k])
            ok = g >= STEP_G_FLOOR * g.max()
            d = d[ok] if ok.any() else np.zeros(1)
        worst = max(worst, d.max())
    return worst / LR


def test_train_step_2x2_against_reference_and_unsharded(runs):
    """The qwen3 smoke train step on 2 x 2: loss, grad_norm and the
    parameters after the step against the reference's 2x2 step and the
    port's unsharded one.  Control: the parameters before the step."""
    inputs, ref, port = runs
    cfg = configs.get_config("qwen3_14b", smoke=True)
    _hold_train_step(port["train"], ref["train"], _unsharded_train(inputs),
                     cfg, inputs, "qwen3")
    # the parameters really were sharded: heads over "model", embed over "data"
    assert "Shard(dim=1)" in port["placements"]["layers.0.attn.wq"]
    assert "Shard(dim=0)" in port["placements"]["layers.0.attn.wq"]


def test_deepseek_train_step_2x2_on_local_mla_blocks(runs):
    """deepseek's smoke train step on 2 x 2, MLA's attention core on each
    rank's own blocks: held as qwen3's step is, against the reference's
    2x2 step and the port's unsharded step at two dispatch groups (the
    mesh's, at a capacity factor of CAPACITY).  Every ``_mla_attend``
    call under the mesh took plain tensors."""
    inputs, ref, port = runs
    cfg = dataclasses.replace(configs.get_config("deepseek_v2_lite_16b",
                                                 smoke=True),
                              moe_capacity=CAPACITY)
    from repro_torch.models import moe
    orig = moe.apply_moe
    moe.apply_moe = lambda *a, **k: orig(*a, **dict(k, groups=2))
    try:
        unsharded = _unsharded_train(inputs, "deepseek_v2_lite_16b",
                                     "deepseek", moe_capacity=CAPACITY)
    finally:
        moe.apply_moe = orig
    _hold_train_step(port["deepseek_train"], ref["deepseek_train"],
                     unsharded, cfg, inputs, "deepseek")
    # each layer's forward, and again where remat recomputes it
    assert len(port["mla_attend_types"]) >= cfg.num_layers
    assert set(port["mla_attend_types"]) == {"Tensor"}


def test_serve_step_sharded_cache_2x2(runs):
    """Two decode steps on caches laid out by ``cache_shardings``: the
    logits against the reference's 4-device serve step and the port's
    unsharded decode within MODEL_TOL.  Control: the second step's logits
    against the first's."""
    inputs, ref, port = runs
    cfg = configs.get_config("qwen3_14b", smoke=True)
    model = _port_model("qwen3_14b", inputs, "qwen3")
    cache = T.init_cache(cfg, B, 32, torch.float32, device="cpu")
    tok = torch.from_numpy(inputs["batch"]["tokens"][:, :1]).long()
    serve = steps.make_serve_step(cfg)
    l1, cache = serve(model, cache, tok, 0)
    l2, _ = serve(model, cache, tok + 1, 1)
    for got, want, own in zip(port["serve"], ref["serve"], (l1, l2)):
        np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)
        np.testing.assert_allclose(got, own.numpy(), atol=MODEL_TOL,
                                   rtol=MODEL_TOL)
    assert np.abs(port["serve"][1] - port["serve"][0]).max() > 100 * MODEL_TOL
    assert port["cache_placements"] == "(Shard(dim=0), Shard(dim=2))"


def test_deepseek_grouped_dispatch_2x2(runs):
    """deepseek's smoke prefill on 2 x 2 dispatches in two groups (one a
    "data" rank), as the reference's does there: logits against the
    reference's within MODEL_TOL, and against the port's unsharded prefill
    at groups = 2, both packages at a capacity factor of CAPACITY.
    Control: the unsharded prefill at one group, whose capacities differ."""
    inputs, ref, port = runs
    assert port["groups"] == ref["groups"] == 2
    np.testing.assert_allclose(port["deepseek"], ref["deepseek"],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    cfg = dataclasses.replace(configs.get_config("deepseek_v2_lite_16b",
                                                 smoke=True),
                              moe_capacity=CAPACITY)
    model = _port_model("deepseek_v2_lite_16b", inputs, "deepseek")
    toks = torch.from_numpy(inputs["batch"]["tokens"]).long()
    from repro_torch.models import moe
    orig = moe.apply_moe

    def at(groups):
        moe.apply_moe = lambda *a, **k: orig(*a, **dict(k, groups=groups))
        try:
            return steps.make_prefill_step(cfg)(model, {"tokens": toks}).numpy()
        finally:
            moe.apply_moe = orig
    np.testing.assert_allclose(port["deepseek"], at(2), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    assert np.abs(port["deepseek"] - at(1)).max() > MODEL_TOL


def test_sharded_trainer_resumes_bitwise(runs):
    """``train(mesh=)`` on 2 x 2 with Q8 moments: four steps straight
    against two steps, a checkpoint of each process's blocks, and two
    more resumed from it; the last two losses and the parameters after
    bitwise.  Control: the straight run's losses move."""
    _, _, port = runs
    r = port["resume"]
    assert len(r["resumed"]) == 2 and r["resumed"] == r["straight"][2:]
    assert r["params_bitwise"]
    assert r["straight"][0] != r["straight"][3]
