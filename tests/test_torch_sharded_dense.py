"""The sharded path of the attention families on a 2 x 2 ("data",
"model") mesh of four gloo processes, against the reference's steps on
four forced host devices and against the port's own unsharded steps, at
smoke size in f32: gemma3 (local:global windows, a tied embedding, one kv
head), dbrx (experts over "model"), llava (frontend embeddings over the
leading positions), nemotron (the squared-ReLU MLP) and command-r.

For each: the prefill's last-position logits, one train step (loss,
grad_norm and the parameters after it, through
``test_torch_sharded_steps._hold_train_step``'s bounds and its control,
the parameters before the step) and a weight of the family split over
"model".  The machinery (the reference's script, the port's script, the
unsharded steps) is shared with ``test_torch_sharded_recurrent.py``.

The reference runs in one subprocess on a mesh with Auto axes built here,
as in ``test_torch_sharded_steps.py``; both packages start from the
reference's seeded parameters and batches made with numpy from a seed.
The reference's own 2 x 2 steps run for every family here
(``test_reference_steps_ran``).
"""
import os
import pickle
import subprocess
import sys

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
from test_torch_sharded_steps import (LR, MODEL_TOL, _env, _hold_train_step,
                                      _state)

B, S = 4, 16
ENC_FRAMES = 8
CACHE_LEN = 32
ARCHS = ("gemma3_1b", "dbrx_132b", "llava_next_34b", "nemotron_4_340b",
         "command_r_35b")
# a weight of each family whose layout must split it over "model"
SPLIT = {"gemma3_1b": "layers.0.attn.wq", "dbrx_132b": "layers.0.moe.wi",
         "llava_next_34b": "layers.0.mlp.wi",
         "nemotron_4_340b": "layers.0.mlp.wi",
         "command_r_35b": "layers.0.mlp.wi",
         "mamba2_130m": "layers.0.ssm.in_proj",
         "jamba_1_5_large_398b": "layers.0.ssm.in_proj",
         "seamless_m4t_large_v2": "layers.0.cross.wq"}


REFERENCE = """
import pickle, sys, traceback
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
lay = inp["layout"]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(inp["mesh"]),
            ("data", "model"))
rep = NamedSharding(mesh, P())
out = {}

def split(x):
    if x.shape[0] %% mesh.shape["data"]:
        return rep
    return NamedSharding(mesh, P("data", *(None,) * (x.ndim - 1)))

for arch in inp["ref_archs"]:
    res = out[arch] = {}
    try:
        cfg = get_config(arch, smoke=True)
        params = jax.tree.map(jnp.asarray, inp["params"][arch])
        p_sh = params_shardings(T.init_model_abstract(cfg)[1], params, mesh)
        batch = {k: jnp.asarray(v) for k, v in inp["batches"][arch].items()}
        b_sh = {k: split(v) for k, v in batch.items()}
        feed = {k: v for k, v in batch.items() if k != "labels"}
        opt = adamw_init(params)
        opt_sh = type(opt)(step=rep, m=p_sh, v=p_sh)
        with mesh, activation_sharding(
                mesh, seq_sharded=lay["seq"], attn_seq_parallel=lay["attn_sp"],
                residual_seq_parallel=lay["sp"]):
            if "prefill" in inp["steps"]:
                pre = jax.jit(make_prefill_step(cfg),
                              in_shardings=(p_sh, {k: b_sh[k] for k in feed}))
                res["prefill"] = np.asarray(pre(params, feed))
            if "train" in inp["steps"]:
                step = jax.jit(make_train_step(cfg, lr=%(lr)r),
                               in_shardings=(p_sh, opt_sh, b_sh))
                p1, _, m = step(params, opt, batch)
                res["train"] = {"params": jax.tree.map(np.asarray, p1),
                                "loss": float(m["loss"]),
                                "grad_norm": float(m["grad_norm"])}
            if arch in inp["decode"]:
                b = inp["decode_batch"]
                cache = T.init_cache(cfg, b, %(cache)d, jnp.float32)
                cache_sh = S.cache_shardings(cfg, cache, mesh,
                                             seq_sharded=lay["cache_seq"])
                tok = batch["tokens"][:b, :1]
                args, arg_sh = (), ()
                if cfg.is_encdec:
                    enc_in = batch["enc_embeds"][:b]
                    enc = jax.jit(lambda p, e: T._apply_encoder(p, cfg, e),
                                  in_shardings=(p_sh, split(enc_in)))
                    args = (enc(params, enc_in),)
                    arg_sh = (split(enc_in),)
                serve = jax.jit(make_serve_step(cfg),
                                in_shardings=(p_sh, cache_sh, split(tok),
                                              rep) + arg_sh)
                res["serve"] = []
                for i, pos in enumerate(inp["positions"]):
                    lg, cache = serve(params, cache, tok + i, jnp.int32(pos),
                                      *args)
                    res["serve"].append(np.asarray(lg))
    except Exception:
        res["error"] = traceback.format_exc()[-3000:]
pickle.dump(out, open(d + "/reference.pkl", "wb"))
""" % {"lr": LR, "cache": CACHE_LEN}

PORT = """
import pickle, sys, traceback
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.distributed.sharding import (P, activation_sharding,
    distribute, distribute_model, dp_entry, full)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + d + "/store",
                        rank=rank, world_size=4)
inp = pickle.load(open(d + "/inputs.pkl", "rb"))
lay = inp["layout"]
mesh = make_smoke_mesh(inp["mesh"], ("data", "model"), device_type="cpu")
out = {}

def put(v):
    t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    t = t.long() if t.dtype == torch.int32 else t
    return distribute(t, P(dp_entry(mesh, t.shape[0])), mesh)

for arch in inp["archs"]:
    res = out[arch] = {}
    try:
        cfg = get_config(arch, smoke=True)
        batch = {k: put(v) for k, v in inp["batches"][arch].items()}
        feed = {k: v for k, v in batch.items() if k != "labels"}

        def model():
            return distribute_model(params_from_reference(
                inp["params"][arch], cfg, device="cpu"), mesh)

        with activation_sharding(mesh, seq_sharded=lay["seq"],
                                 attn_seq_parallel=lay["attn_sp"],
                                 residual_seq_parallel=lay["sp"]):
            if "prefill" in inp["steps"]:
                res["prefill"] = full(make_prefill_step(cfg)(model(),
                                                             feed)).numpy()
            if "train" in inp["steps"]:
                m = model().requires_grad_(True)
                res["placements"] = {k: [repr(q) for q in v.placements]
                                     for k, v in m.named_parameters()}
                m, _, metrics = make_train_step(cfg, lr=%(lr)r)(
                    m, adamw_init(m), batch)
                res["train"] = {"params": {
                    k: full(v).detach().numpy()
                    for k, v in m.state_dict().items()},
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"])}
            if arch in inp["decode"]:
                m, b = model(), inp["decode_batch"]
                cache = T.init_cache(cfg, b, %(cache)d, torch.float32,
                                     device="cpu")
                cache = [{k: distribute(t, sh[k], mesh) for k, t in c.items()}
                         for c, sh in zip(cache, S.cache_shardings(
                             cfg, cache, mesh, seq_sharded=lay["cache_seq"]))]
                tok = put(inp["batches"][arch]["tokens"][:b, :1])
                res["serve"] = []
                with torch.no_grad():
                    enc_out = (T.apply_encoder(m, cfg, put(
                        inp["batches"][arch]["enc_embeds"][:b]))
                        if cfg.is_encdec else None)
                    serve = make_serve_step(cfg)
                    for i, pos in enumerate(inp["positions"]):
                        lg, cache = serve(m, cache, tok + i, pos, enc_out)
                        res["serve"].append(full(lg).numpy())
                res["cache_placements"] = [
                    {k: [repr(q) for q in t.placements] for k, t in c.items()}
                    for c in cache]
    except Exception:
        # the ranks raise alike (a sharding rule), and go on to the next
        res["error"] = traceback.format_exc()[-3000:]
if rank == 0:
    pickle.dump(out, open(d + "/port.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
""" % {"lr": LR, "cache": CACHE_LEN}


def family_batch(cfg, seed: int) -> dict:
    """Tokens, next-token labels, and a frontend's embeddings (llava) or an
    encoder's frames (seamless), numpy from a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        b["enc_embeds"] = (rng.standard_normal((B, ENC_FRAMES, cfg.d_model))
                           * 0.5).astype(np.float32)
    elif cfg.frontend:
        b["frontend_embeds"] = (rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.5).astype(np.float32)
    return b


# The default layout: ``activation_sharding(mesh)``'s, and the caches by
# ``cache_shardings``.  ``seq``, ``attn_sp`` and ``sp`` are its
# ``seq_sharded``, ``attn_seq_parallel`` and ``residual_seq_parallel``;
# ``cache_seq`` is ``cache_shardings``' ``seq_sharded`` (the reference's
# dry-run sets both ``seq``s for its long_500k cells).
DEFAULT_LAYOUT = {"seq": False, "attn_sp": False, "sp": False,
                  "cache_seq": False}


def run_families(d: str, archs, decode=(), *, layout=None, ref_archs=None,
                 steps=("prefill", "train"), decode_batch=B,
                 positions=(0, 1), mesh=(2, 2)) -> tuple:
    """Both packages' runs of ``archs`` side by side on a ``mesh`` of four
    ranks under ``layout`` (DEFAULT_LAYOUT's keys; those it leaves out
    take their defaults): ``steps`` of each arch (the prefill, one train
    step) and, for the archs in ``decode``, serve steps at ``positions``
    on ``decode_batch`` rows (token ``tokens[:, 0] + i`` at the i-th).
    The reference runs only ``ref_archs`` (None: all of ``archs``).
    Returns (inputs, reference, port)."""
    inputs = {"archs": list(archs), "decode": list(decode),
              "ref_archs": list(archs if ref_archs is None else ref_archs),
              "layout": {**DEFAULT_LAYOUT, **(layout or {})},
              "steps": list(steps), "decode_batch": decode_batch,
              "positions": list(positions), "mesh": tuple(mesh),
              "params": {}, "batches": {}}
    for i, arch in enumerate(archs):
        cfg = jconfigs.get_config(arch, smoke=True)
        inputs["params"][arch] = jax.tree.map(
            np.asarray, JT.init_model(cfg, jax.random.PRNGKey(0))[0])
        inputs["batches"][arch] = family_batch(cfg, 11 + i)
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = _env()
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, d],
                              env=ref_env, stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", PORT, str(r), d],
                               env=dict(env, OMP_NUM_THREADS="1"),
                               stderr=subprocess.PIPE, text=True)
              for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    load = lambda n: pickle.load(open(os.path.join(d, n), "rb"))  # noqa: E731
    return inputs, load("reference.pkl"), load("port.pkl")


def ran(port, arch) -> dict:
    """The port's readings of ``arch``, which must not have raised."""
    assert "error" not in port[arch], port[arch]["error"]
    return port[arch]


def port_inputs(inputs, arch):
    """(config, unsharded port model, torch batch) of ``arch``."""
    cfg = configs.get_config(arch, smoke=True)
    model = params_from_reference(inputs["params"][arch], cfg, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                 else v)
             for k, v in inputs["batches"][arch].items()}
    return cfg, model, batch


def unsharded_prefill(inputs, arch, **change) -> np.ndarray:
    """The port's unsharded prefill logits; ``change`` replaces batch
    entries (a control)."""
    cfg, model, batch = port_inputs(inputs, arch)
    feed = {k: v for k, v in {**batch, **change}.items() if k != "labels"}
    return steps.make_prefill_step(cfg)(model, feed).numpy()


def unsharded_train(inputs, arch) -> tuple:
    """(parameters after, metrics, gradients) of the port's unsharded
    train step, as ``_hold_train_step`` takes them."""
    cfg, model, batch = port_inputs(inputs, arch)
    model.requires_grad_(True)
    _, grads = steps.loss_and_grads(model, cfg, batch)
    model, _, m = steps.make_train_step(cfg, lr=LR)(model, adamw_init(model),
                                                    batch)
    return (_state(model), {k: float(v) for k, v in m.items()},
            {k: g.numpy() for k, g in grads.items()})


def unsharded_decode(inputs, arch, lose_writes: bool = False) -> list:
    """The port's unsharded serve steps' logits, at ``run_families``'
    ``decode_batch`` and ``positions``.  ``lose_writes``: every cache
    zeroed after each step, so that no step sees an earlier one's entries
    (a control: a sharded cache whose writes land nowhere)."""
    cfg, model, batch = port_inputs(inputs, arch)
    b = inputs["decode_batch"]
    cache = T.init_cache(cfg, b, CACHE_LEN, torch.float32, device="cpu")
    tok = batch["tokens"][:b, :1]
    out = []
    with torch.no_grad():
        enc_out = (T.apply_encoder(model, cfg, batch["enc_embeds"][:b])
                   if cfg.is_encdec else None)
        serve = steps.make_serve_step(cfg)
        for i, pos in enumerate(inputs["positions"]):
            lg, cache = serve(model, cache, tok + i, pos, enc_out)
            out.append(lg.numpy())
            if lose_writes:
                for c in cache:
                    for t in c.values():
                        t.zero_()
    return out


def hold_decode(runs, arch):
    """The sharded serve steps' logits against the reference's (where it
    ran ``arch``) and the port's unsharded ones within MODEL_TOL.
    Control: the unsharded steps with every write lost
    (``unsharded_decode(lose_writes=True)``) must fail the check."""
    inputs, ref, port = runs
    got = ran(port, arch)["serve"]
    assert len(got) == len(inputs["positions"]) > 1
    if arch in ref:
        for g, want in zip(got, ref[arch]["serve"], strict=True):
            np.testing.assert_allclose(g, want, atol=MODEL_TOL,
                                       rtol=MODEL_TOL)
    for g, own in zip(got, unsharded_decode(inputs, arch), strict=True):
        np.testing.assert_allclose(g, own, atol=MODEL_TOL, rtol=MODEL_TOL)
    lost = unsharded_decode(inputs, arch, lose_writes=True)
    assert not np.allclose(got[-1], lost[-1], atol=MODEL_TOL, rtol=MODEL_TOL)


def hold_prefill(runs, arch):
    """The sharded prefill's logits against the reference's prefill (where
    it ran ``arch``) and the port's unsharded one within MODEL_TOL.
    Control: the unsharded prefill with the last token changed."""
    inputs, ref, port = runs
    got = ran(port, arch)["prefill"]
    own = unsharded_prefill(inputs, arch)
    if arch in ref and "error" not in ref[arch]:
        np.testing.assert_allclose(got, ref[arch]["prefill"], atol=MODEL_TOL,
                                   rtol=MODEL_TOL)
    np.testing.assert_allclose(got, own, atol=MODEL_TOL, rtol=MODEL_TOL)
    toks = torch.from_numpy(inputs["batches"][arch]["tokens"]).long()
    toks[:, -1] = (toks[:, -1] + 1) % configs.get_config(arch,
                                                         smoke=True).vocab
    other = unsharded_prefill(inputs, arch, tokens=toks)
    assert not np.allclose(got, other, atol=MODEL_TOL, rtol=MODEL_TOL)


def hold_train(runs, arch):
    """One sharded train step against the reference's step (where it ran
    ``arch``) and the port's unsharded one (``_hold_train_step``, with its
    control)."""
    inputs, ref, port = runs
    _hold_train_step(ran(port, arch)["train"],
                     ref.get(arch, {}).get("train"),
                     unsharded_train(inputs, arch),
                     configs.get_config(arch, smoke=True), inputs["params"],
                     arch)


def hold_split(runs, arch):
    """The family's weight ``SPLIT[arch]`` is split over "model" (the
    mesh's second axis) in the sharded train step's model."""
    _, _, port = runs
    pl = ran(port, arch)["placements"]
    assert pl[SPLIT[arch]][1].startswith("Shard"), pl[SPLIT[arch]]
    assert any(q[0].startswith("Shard") for q in pl.values())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_families(str(tmp_path_factory.mktemp("dense")), ARCHS)


def test_reference_steps_ran(runs):
    """The reference's 2 x 2 prefill and train step ran for every family
    here (none raised)."""
    _, ref, _ = runs
    assert {a: ref[a].get("error") for a in ARCHS} == dict.fromkeys(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_2x2(runs, arch):
    hold_prefill(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_2x2(runs, arch):
    hold_train(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_split_over_model(runs, arch):
    hold_split(runs, arch)


def test_llava_frontend_reaches_the_sharded_prefill(runs):
    """Control for llava's frontend: its unsharded prefill with the
    frontend embeddings zeroed must fail the prefill check."""
    inputs, _, port = runs
    fe = torch.from_numpy(inputs["batches"]["llava_next_34b"]
                          ["frontend_embeds"])
    other = unsharded_prefill(inputs, "llava_next_34b",
                              frontend_embeds=torch.zeros_like(fe))
    assert not np.allclose(port["llava_next_34b"]["prefill"], other,
                           atol=MODEL_TOL, rtol=MODEL_TOL)
