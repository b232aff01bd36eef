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
unsharded steps) is shared with the other sharded files; this file's
2 x 2 runs, ``test_torch_sharded_recurrent.py``'s and five layout files'
run in one launch a test session (``SESSION_RUNS``).

The reference runs in one subprocess a run, on a mesh with Auto axes
built here, as in ``test_torch_sharded_steps.py``; both packages start
from the reference's seeded parameters and batches made with numpy from a
seed.
The reference's own 2 x 2 steps run for every family here
(``test_reference_steps_ran``).
"""
import fcntl
import hashlib
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
         "seamless_m4t_large_v2": "layers.0.cross.wq",
         "deepseek_v2_lite_16b": "layers.1.moe.wi",
         "qwen3_14b": "layers.0.mlp.wi"}


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

d, only = sys.argv[1], int(sys.argv[2])
inp = pickle.load(open(d + "/inputs.pkl", "rb"))
n = int(np.prod(inp["mesh"]))
mesh = Mesh(np.array(jax.devices()[:n]).reshape(inp["mesh"]),
            tuple(inp["axes"]))
rep = NamedSharding(mesh, P())
# the DP entry: "data", or ("pod", "data") where the mesh has "pod"
dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
n_dp = int(np.prod([mesh.shape[a] for a in dp]))
dp = dp[0] if len(dp) == 1 else dp
out = {}

def split(x):
    if x.shape[0] %% n_dp:
        return rep
    return NamedSharding(mesh, P(dp, *(None,) * (x.ndim - 1)))

run = inp["runs"][only]
for arch in run["ref_archs"]:
    lay = run["layout"]
    res = out[arch] = {}
    try:
        cfg = get_config(arch, smoke=True)
        params = jax.tree.map(jnp.asarray, inp["params"][arch])
        p_sh = params_shardings(T.init_model_abstract(cfg)[1], params, mesh)
        batch = {k: jnp.asarray(v) for k, v in run["batches"][arch].items()}
        b_sh = {k: split(v) for k, v in batch.items()}
        feed = {k: v for k, v in batch.items() if k != "labels"}
        opt = adamw_init(params)
        opt_sh = type(opt)(step=rep, m=p_sh, v=p_sh)
        with mesh, activation_sharding(
                mesh, seq_sharded=lay["seq"], attn_seq_parallel=lay["attn_sp"],
                residual_seq_parallel=lay["sp"]):
            if "prefill" in run["steps"]:
                pre = jax.jit(make_prefill_step(cfg),
                              in_shardings=(p_sh, {k: b_sh[k] for k in feed}))
                res["prefill"] = np.asarray(pre(params, feed))
            if "train" in run["steps"]:
                step = jax.jit(make_train_step(cfg, lr=%(lr)r),
                               in_shardings=(p_sh, opt_sh, b_sh))
                p1, _, m = step(params, opt, batch)
                res["train"] = {"params": jax.tree.map(np.asarray, p1),
                                "loss": float(m["loss"]),
                                "grad_norm": float(m["grad_norm"])}
            if arch in run["decode"]:
                b = run["decode_batch"]
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
                for j, pos in enumerate(run["positions"]):
                    lg, cache = serve(params, cache, tok + j, jnp.int32(pos),
                                      *args)
                    res["serve"].append(np.asarray(lg))
    except Exception:
        res["error"] = traceback.format_exc()[-3000:]
pickle.dump(out, open(f"{d}/reference_{only}.pkl", "wb"))
""" % {"lr": LR, "cache": CACHE_LEN}

PORT = """
import hashlib, math, pickle, sys, traceback
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
inp = pickle.load(open(d + "/inputs.pkl", "rb"))
dist.init_process_group("gloo", init_method="file://" + d + "/store",
                        rank=rank, world_size=math.prod(inp["mesh"]))
mesh = make_smoke_mesh(inp["mesh"], inp["axes"], device_type="cpu")
out = {}

def put(v):
    t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    t = t.long() if t.dtype == torch.int32 else t
    return distribute(t, P(dp_entry(mesh, t.shape[0])), mesh)

# every rank's {name: (its coordinates on the axes that split the tensor, a
# digest of its own block's bytes)}, gathered from all
def replicas(tensors):
    mine = {}
    for k, t in tensors.items():
        pl = getattr(t, "placements", (None,) * mesh.ndim)
        local = t.to_local() if hasattr(t, "to_local") else t
        mine[k] = (tuple(c if q is not None and q.is_shard() else None
                         for c, q in zip(mesh.get_coordinate(), pl)),
                   hashlib.sha256(local.detach().contiguous().numpy()
                                  .tobytes()).hexdigest())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every

for i, run, arch in [(i, run, arch) for i, run in enumerate(inp["runs"])
                     for arch in run["archs"]]:
    lay = run["layout"]
    res = out.setdefault(i, {})[arch] = {}
    try:
        cfg = get_config(arch, smoke=True)
        batch = {k: put(v) for k, v in run["batches"][arch].items()}
        feed = {k: v for k, v in batch.items() if k != "labels"}

        def model():
            return distribute_model(params_from_reference(
                inp["params"][arch], cfg, device="cpu"), mesh)

        with activation_sharding(mesh, seq_sharded=lay["seq"],
                                 attn_seq_parallel=lay["attn_sp"],
                                 residual_seq_parallel=lay["sp"]):
            if "prefill" in run["steps"]:
                res["prefill"] = full(make_prefill_step(cfg)(model(),
                                                             feed)).numpy()
            if "train" in run["steps"]:
                m = model().requires_grad_(True)
                res["placements"] = {k: [repr(q) for q in v.placements]
                                     for k, v in m.named_parameters()}
                m, opt, metrics = make_train_step(cfg, lr=%(lr)r)(
                    m, adamw_init(m), batch)
                res["train"] = {"params": {
                    k: full(v).detach().numpy()
                    for k, v in m.state_dict().items()},
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"])}
                if run["replicas"]:
                    res["replicas"] = replicas({
                        **dict(m.named_parameters()), "opt.step": opt.step,
                        **{f"opt.m.{k}": v for k, v in opt.m.items()},
                        **{f"opt.v.{k}": v for k, v in opt.v.items()}})
            if arch in run["decode"]:
                m, b = model(), run["decode_batch"]
                cache = T.init_cache(cfg, b, %(cache)d, torch.float32,
                                     device="cpu")
                cache = [{k: distribute(t, sh[k], mesh) for k, t in c.items()}
                         for c, sh in zip(cache, S.cache_shardings(
                             cfg, cache, mesh, seq_sharded=lay["cache_seq"]))]
                tok = put(run["batches"][arch]["tokens"][:b, :1])
                res["serve"] = []
                with torch.no_grad():
                    enc_out = (T.apply_encoder(m, cfg, put(
                        run["batches"][arch]["enc_embeds"][:b]))
                        if cfg.is_encdec else None)
                    serve = make_serve_step(cfg)
                    for j, pos in enumerate(run["positions"]):
                        lg, cache = serve(m, cache, tok + j, pos, enc_out)
                        res["serve"].append(full(lg).numpy())
                res["cache_placements"] = [
                    {k: [repr(q) for q in t.placements] for k, t in c.items()}
                    for c in cache]
    except Exception:
        # the ranks raise alike (a sharding rule), and go on to the next
        res["error"] = traceback.format_exc()[-3000:]
# a caller's own steps, with this script's names in scope
exec(inp["extra"])
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


def session_dir(d: str) -> str:
    """The test session's temporary directory, of which ``d`` is one
    directory (under xdist, a worker's)."""
    parent = os.path.dirname(d)
    if os.path.basename(parent).startswith("popen-gw"):
        parent = os.path.dirname(parent)
    return parent


def shared(session: str, what: str, key, compute):
    """``compute()``, run once a test session for ``key`` (any picklable
    value, hashed) and kept in ``session``'s directory ``what`` for every
    file that needs it next; a file lock makes another worker wait for
    the first one's result rather than compute it again."""
    path = os.path.join(session, what,
                        hashlib.sha256(pickle.dumps(key)).hexdigest() + ".pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        # written whole, then renamed
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)
        return value


def reference_params(arch: str, d: str) -> dict:
    """The reference's seeded smoke parameters of ``arch`` (numpy arrays),
    made once a test session: every sharded test file starts from the same
    ones (``d``: one of the session's temporary directories)."""
    def make():
        cfg = jconfigs.get_config(arch, smoke=True)
        return jax.tree.map(np.asarray,
                            JT.init_model(cfg, jax.random.PRNGKey(0))[0])
    return shared(session_dir(d), "reference_params", arch, make)


def run_families(d: str, archs, decode=(), *, layout=None, ref_archs=None,
                 steps=("prefill", "train"), decode_batch=B,
                 positions=(0, 1), mesh=(2, 2), axes=("data", "model"),
                 **launch) -> tuple:
    """Both packages' runs of ``archs`` side by side on a ``mesh`` of
    ``axes`` under ``layout`` (DEFAULT_LAYOUT's keys; those it leaves out
    take their defaults): ``steps`` of each arch (the prefill, one train
    step) and, for the archs in ``decode``, serve steps at ``positions``
    on ``decode_batch`` rows (token ``tokens[:, 0] + i`` at the i-th).
    The reference runs only ``ref_archs`` (None: all of ``archs``).
    ``launch`` goes to :func:`run_many`.  Returns (inputs, reference,
    port)."""
    return run_many(d, [dict(archs=archs, decode=decode, layout=layout,
                             ref_archs=ref_archs, steps=steps,
                             decode_batch=decode_batch, positions=positions)],
                    mesh=mesh, axes=axes, **launch)[0]


def run_many(d: str, runs, *, mesh=(2, 2), axes=("data", "model"),
             extra: str = "") -> list:
    """Several of :func:`run_families`' runs in one launch of both
    packages: the port as one gloo process a rank of ``mesh`` on ``axes``,
    the reference as one subprocess a run that runs it, on that many
    forced host devices.  ``runs``: dicts of ``run_families``' keyword
    arguments (``archs`` and those after it up to ``positions``), and
    ``replicas``: if true, every port train step of the run also reads, on
    each rank, a digest of its own block of every parameter, AdamW moment
    and the step count (``"replicas"``, a list a rank); ``seeds``: the
    order of archs whose positions seed the batches (``family_batch``'s
    seed 11 + i; default the run's ``archs``).  ``extra``: a script run by
    every port rank after the runs, with the port script's names in scope
    (``mesh``, ``rank``, ``inp``, ``out``, ``put``, ``replicas``), whose
    keys in ``out`` every run's port readings also get.  Returns a list of
    (inputs, reference, port), one a run; a run's inputs are the launch's
    with its own keys."""
    runs = [{"archs": list(r["archs"]), "decode": list(r.get("decode", ())),
             "ref_archs": list(r["archs"] if r.get("ref_archs") is None
                               else r["ref_archs"]),
             "layout": {**DEFAULT_LAYOUT, **(r.get("layout") or {})},
             "steps": list(r.get("steps", ("prefill", "train"))),
             "decode_batch": r.get("decode_batch", B),
             "positions": list(r.get("positions", (0, 1))),
             "replicas": bool(r.get("replicas", False)),
             "batches": {a: family_batch(
                 jconfigs.get_config(a, smoke=True),
                 11 + list(r.get("seeds") or r["archs"]).index(a))
                 for a in r["archs"]}} for r in runs]
    archs = list(dict.fromkeys(a for r in runs for a in r["archs"]))
    inputs = {"runs": runs, "mesh": tuple(mesh), "axes": tuple(axes),
              "extra": extra, "session": session_dir(d),
              "params": {a: reference_params(a, d) for a in archs}}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    n = int(np.prod(mesh))
    env = _env()
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    with_ref = [i for i, r in enumerate(runs) if r["ref_archs"]]
    # each process's stderr to a file, so that none waits on a full pipe
    procs = [(subprocess.Popen([sys.executable, "-c", REFERENCE, d, str(i)],
                               env=ref_env, stderr=f), f)
             for i in with_ref
             for f in [open(os.path.join(d, f"reference_{i}.err"), "w+")]]
    procs += [(subprocess.Popen([sys.executable, "-c", PORT, str(r), d],
                                env=dict(env, OMP_NUM_THREADS="1"),
                                stderr=f), f)
              for r in range(n)
              for f in [open(os.path.join(d, f"port_{r}.err"), "w+")]]
    for p, f in procs:
        p.wait(timeout=1200)
        f.seek(0)
        err = f.read()
        f.close()
        assert p.returncode == 0, err[-3000:]
    load = lambda n: pickle.load(open(os.path.join(d, n), "rb"))  # noqa: E731
    port = load("port.pkl")
    base = {k: v for k, v in inputs.items() if k != "runs"}
    extra_out = {k: v for k, v in port.items() if not isinstance(k, int)}
    return [({**base, **run},
             load(f"reference_{i}.pkl") if i in with_ref else {},
             {**extra_out, **port.get(i, {})})
            for i, run in enumerate(runs)]


# the first two positions, either side of the boundary of a cache split in
# two over its sequence (16-slot blocks), and the cache's last slot
POSITIONS = (0, 1, 15, 16, 31)
RECURRENT = ("mamba2_130m", "jamba_1_5_large_398b", "seamless_m4t_large_v2")
DECODE_REF_ARCHS = ("gemma3_1b", "deepseek_v2_lite_16b")
# The 2 x 2 runs of this file, test_torch_sharded_recurrent.py and the
# layout files (test_torch_sharded_layouts_{seq,sp,attn_sp,decode,long}),
# in one launch a test session (``session_runs``): the sharding strategies
# that one run searches in a process serve the next.  The default layout
# first.
SESSION_RUNS = {
    "dense": dict(archs=ARCHS),
    "recurrent": dict(archs=RECURRENT, decode=RECURRENT),
    "decode_32k": dict(archs=configs.ARCHS, decode=configs.ARCHS,
                       ref_archs=DECODE_REF_ARCHS, steps=(),
                       positions=POSITIONS),
    "seq_sharded": dict(archs=configs.ARCHS, layout={"seq": True},
                        ref_archs=("dbrx_132b", "jamba_1_5_large_398b")),
    "residual_sp": dict(archs=configs.ARCHS, layout={"sp": True},
                        ref_archs=("dbrx_132b",)),
    "attn_sp": dict(archs=configs.ARCHS, layout={"attn_sp": True},
                    ref_archs=("gemma3_1b",)),
    "long_500k": dict(archs=configs.ARCHS, decode=configs.ARCHS,
                      layout={"seq": True, "cache_seq": True},
                      ref_archs=DECODE_REF_ARCHS, steps=(), decode_batch=1,
                      positions=POSITIONS)}


def session_runs(tmp_path_factory, name: str) -> tuple:
    """(inputs, reference, port) of SESSION_RUNS' run ``name``: the first
    file to ask runs them all in one launch (``run_many``), the others
    wait for it and read them (``shared``)."""
    d = str(tmp_path_factory.mktemp("session_runs"))
    return shared(session_dir(d), "launches", SESSION_RUNS,
                  lambda: dict(zip(SESSION_RUNS, run_many(
                      d, list(SESSION_RUNS.values())))))[name]


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


def unsharded(inputs, arch, what: str, compute, *key):
    """``compute()``, an unsharded step of ``arch`` on ``inputs``' seeded
    parameters and batch, run once a test session (``shared``): several
    runs and files hold their sharded steps against the same one.  ``key``:
    whatever else it depends on."""
    return shared(inputs["session"], "unsharded",
                  (what, arch, inputs["params"][arch],
                   inputs["batches"][arch], LR, CACHE_LEN) + key, compute)


def unsharded_prefill(inputs, arch, **change) -> np.ndarray:
    """The port's unsharded prefill logits; ``change`` replaces batch
    entries (a control)."""
    def compute():
        cfg, model, batch = port_inputs(inputs, arch)
        feed = {k: v for k, v in {**batch, **change}.items()
                if k != "labels"}
        return steps.make_prefill_step(cfg)(model, feed).numpy()
    return unsharded(inputs, arch, "prefill", compute,
                     {k: v.numpy() for k, v in change.items()})


def unsharded_train(inputs, arch) -> tuple:
    """(parameters after, metrics, gradients) of the port's unsharded
    train step, as ``_hold_train_step`` takes them."""
    def compute():
        cfg, model, batch = port_inputs(inputs, arch)
        model.requires_grad_(True)
        _, grads = steps.loss_and_grads(model, cfg, batch)
        model, _, m = steps.make_train_step(cfg, lr=LR)(
            model, adamw_init(model), batch)
        return (_state(model), {k: float(v) for k, v in m.items()},
                {k: g.numpy() for k, g in grads.items()})
    return unsharded(inputs, arch, "train", compute)


def unsharded_decode(inputs, arch, lose_writes: bool = False) -> list:
    """The port's unsharded serve steps' logits, at ``run_families``'
    ``decode_batch`` and ``positions``.  ``lose_writes``: every cache
    zeroed after each step, so that no step sees an earlier one's entries
    (a control: a sharded cache whose writes land nowhere)."""
    def compute():
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
    return unsharded(inputs, arch, "decode", compute, inputs["decode_batch"],
                     tuple(inputs["positions"]), lose_writes)


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
    """The family's weight ``SPLIT[arch]`` is split over "model" in the
    sharded train step's model, and some weight over "data"."""
    inputs, _, port = runs
    model, data = (inputs["axes"].index(a) for a in ("model", "data"))
    pl = ran(port, arch)["placements"]
    assert pl[SPLIT[arch]][model].startswith("Shard"), pl[SPLIT[arch]]
    assert any(q[data].startswith("Shard") for q in pl.values())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return session_runs(tmp_path_factory, "dense")


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
