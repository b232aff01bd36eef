"""The sharded path under two of PyTorch 2.11's DTensor rules, which the
card machine runs and PyTorch 2.13 relaxed, emulated on 2.13: every
family's train step in the default layout and under ``seq_sharded``,
``residual_seq_parallel`` and ``attn_seq_parallel``, its prefill under
``seq_sharded``, and its decode in decode_32k's and long_500k's layouts,
on a 2 x 2 mesh of four gloo processes, must run to the end.

- A flatten of a split dimension that is not the first of the flattened
  ones: 2.13 makes it a ``_StridedShard``, 2.11 raises ("Attempted to
  flatten multiple dimensions, with dimension 1 being sharded").  The
  emulation patches 2.13's view rule to raise where it would make one.
- ``index_put``: 2.11's rule maps a gradient split over its batch onto
  the indexed table as an unnormalised ``Shard(-1)`` and raises (the
  embedding's backward).  The emulation refuses every DTensor
  ``index_put``; the port runs that backward on whole tensors
  (``sharding.rows``).

The emulation is test code: it patches ``torch.distributed.tensor``'s
private modules in the worker processes only.  The numbers of the same
steps are held against the unsharded ones in the other
``test_torch_sharded_layouts_*.py`` files; ``chip_smoke.py`` phase 13e
runs them under the real 2.11.  Controls, each a port function put back
to its form before these repairs for one run: the block input without
``sequence_whole`` (the train step under ``seq_sharded`` raises), the
plain ``table[tokens]`` (the train step raises in the embedding's
backward), and decode's read of a split cache on the DTensors (qwen3's
long_500k decode raises).
"""
import os
import pickle
import subprocess
import sys

import pytest

from repro_torch.configs import ARCHS
from test_torch_sharded_steps import _env

# (kind, layout): the steps each family runs
CASES = (("train", "default"), ("train", "seq"), ("train", "sp"),
         ("train", "attn_sp"), ("prefill", "seq"), ("decode", "decode_32k"),
         ("decode", "long_500k"))
# control: a port function put back to its form before these repairs ->
# (arch, the case that must then raise under the emulated rules)
CONTROLS = {"no_sequence_whole": ("qwen3_14b", ("train", "seq")),
            "plain_rows": ("qwen3_14b", ("train", "default")),
            "dtensor_decode_read": ("qwen3_14b", ("decode", "long_500k"))}

WORKER = """
import pickle, sys, traceback
import torch, torch.distributed as dist
import torch.distributed.tensor._ops._view_ops as V
import torch.distributed.tensor._sharding_prop as SP
from torch.distributed.tensor.placement_types import _StridedShard
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (P, activation_sharding,
    distribute, distribute_model, dp_entry)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

view_rule = V.propagate_shape_and_sharding


def flatten_rule(src, shape, rule, mesh_sizes, *a, **k):
    tgt, out = view_rule(src, shape, rule, mesh_sizes, *a, **k)
    for q_in, q_out in zip(tgt, out):
        if (isinstance(q_out, _StridedShard)
                and not isinstance(q_in, _StridedShard)):
            raise RuntimeError("2.11 rule: Attempted to flatten multiple "
                               "dimensions, with dimension %d being "
                               "sharded" % q_in.dim)
    return tgt, out


propagate = SP.ShardingPropagator.propagate_op_sharding_non_cached


def index_put_rule(self, op_schema):
    if "index_put" in str(op_schema.op):
        raise RuntimeError("2.11 rule: index_put of a split gradient")
    return propagate(self, op_schema)


V.propagate_shape_and_sharding = flatten_rule
SP.ShardingPropagator.propagate_op_sharding_non_cached = index_put_rule

rank, d, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + d + "/store",
                        rank=rank, world_size=4)
mesh = make_smoke_mesh((2, 2), ("data", "model"), device_type="cpu")
LAYOUTS = {"default": {}, "seq": {"seq_sharded": True},
           "sp": {"residual_seq_parallel": True},
           "attn_sp": {"attn_seq_parallel": True},
           "decode_32k": {}, "long_500k": {"seq_sharded": True}}
PORT = (T.sequence_whole, L.rows, A._sdpa_split_cache)
CONTROLS = {
    "no_sequence_whole": lambda: setattr(T, "sequence_whole",
                                         lambda x: x),
    "plain_rows": lambda: setattr(L, "rows", lambda t, i: t[i]),
    "dtensor_decode_read": lambda: setattr(A, "_sdpa_split_cache",
                                           A._sdpa)}


def run(arch, kind, layout):
    cfg = get_config(arch, smoke=True)
    b = 1 if layout == "long_500k" else 4
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (b, 17), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.randn(b, 8, cfg.d_model, generator=g)
    elif cfg.frontend:
        batch["frontend_embeds"] = torch.randn(b, cfg.frontend_tokens,
                                               cfg.d_model, generator=g)
    batch = {k: distribute(v, P(dp_entry(mesh, b)), mesh)
             for k, v in batch.items()}
    model = distribute_model(T.init_model(cfg, 0, "cpu"), mesh)
    with activation_sharding(mesh, **LAYOUTS[layout]):
        if kind == "train":
            model.requires_grad_(True)
            make_train_step(cfg)(model, adamw_init(model), batch)
        elif kind == "prefill":
            make_prefill_step(cfg)(model, {k: v for k, v in batch.items()
                                           if k != "labels"})
        else:
            cache = T.init_cache(cfg, b, 32, torch.float32, device="cpu")
            cache = [{k: distribute(t, sh[k], mesh) for k, t in c.items()}
                     for c, sh in zip(cache, S.cache_shardings(
                         cfg, cache, mesh,
                         seq_sharded=layout == "long_500k"))]
            with torch.no_grad():
                enc = (T.apply_encoder(model, cfg, batch["enc_embeds"])
                       if cfg.is_encdec else None)
                serve = make_serve_step(cfg)
                for pos in (0, 16):
                    serve(model, cache, batch["tokens"][:, :1], pos, enc)


out = {}
for case in cases.split(","):
    arch, mode, kind, layout = case.split(":")
    if mode != "port":
        CONTROLS[mode]()
    try:
        run(arch, kind, layout)
        out[case] = "ok"
    except Exception:
        out[case] = traceback.format_exc()[-1500:]
    T.sequence_whole, L.rows, A._sdpa_split_cache = PORT
    dist.barrier()
if rank == 0:
    pickle.dump(out, open(d + "/out.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"arch:mode:kind:layout": "ok" or the traceback}: every family's
    CASES as the port runs them ("port") and each of CONTROLS."""
    d = str(tmp_path_factory.mktemp("rules"))
    cases = [f"{a}:port:{k}:{lay}" for a in ARCHS for k, lay in CASES]
    cases += [f"{a}:{mode}:{k}:{lay}"
              for mode, (a, (k, lay)) in CONTROLS.items()]
    env = dict(_env(), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), d,
                               ",".join(cases)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
    with open(os.path.join(d, "out.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_run_under_2_11_rules(runs, arch):
    got = {c: err for c, err in runs.items()
           if c.startswith(f"{arch}:port:")}
    assert len(got) == len(CASES)
    assert all(err == "ok" for err in got.values()), got


@pytest.mark.parametrize("mode", sorted(CONTROLS))
def test_rules_control_raises(runs, mode):
    """The step each control names raises under the emulated rules once
    its port function is put back to its form before these repairs."""
    arch, (kind, layout) = CONTROLS[mode]
    err = runs[f"{arch}:{mode}:{kind}:{layout}"]
    assert "2.11 rule" in err, err
