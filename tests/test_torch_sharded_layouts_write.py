"""Decode's write into a cache whose sequence is split, and qwen3's decode
on a (1, 4) mesh, where its 2 kv heads do not divide "model" (the case of
the reference's (16, 16) mesh with 8 kv heads, in small).

The write: four gloo processes run ``attention.decode_gqa`` (gemma3's one
kv head, the sequence over "model"; and at one row with the sequence over
"data", the long_500k layout) and ``attention.decode_mla`` (deepseek, the
sequence over "model") at every global position of an 8-slot cache laid
out by ``cache_leaf_spec``.  After each step the whole cache, gathered,
differs from the step before at that position only, and holds there the
unsharded decode's entry.  Control: the same steps with DTensor's own
``cache[:, pos] = entry`` in place of the decode's write must fail that
check.  The same processes serve gemma3 through
``launch.serve.decode_tokens(mesh=)``, which lays its caches out so,
against the unsharded server.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from test_torch_sharded_dense import POSITIONS, hold_decode, run_families
from test_torch_sharded_steps import MODEL_TOL, _env

T_CACHE = 8
# the server's greedy tokens after a 12-token prompt: a 20-slot cache, split
# in two at slot 10
GEN = 8

WRITER = """
import pickle, sys
import torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (activation_sharding,
    distribute, distribute_model, dp_entry, full, P)
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.specs import cache_leaf_spec
from repro_torch.models import attention as A

rank, d, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + d + "/store",
                        rank=rank, world_size=4)
mesh = make_smoke_mesh((2, 2), ("data", "model"), device_type="cpu")
if mode == "control":
    # DTensor's own write of the new entry, in the decode's place
    def own_write(buf, pos, value):
        buf[:, pos] = value[:, 0].to(buf.dtype)
    A.write_position = own_write
out = {}
CASES = (("gqa_model", "gemma3_1b", 4, False),
         ("gqa_data", "gemma3_1b", 1, True),
         ("mla_model", "deepseek_v2_lite_16b", 4, False))
for name, arch, b, seq in CASES:
    cfg = get_config(arch, smoke=True)
    init, init_cache, step = ((A.init_mla, A.init_mla_cache, A.decode_mla)
                              if cfg.mla else
                              (A.init_gqa, A.init_gqa_cache, A.decode_gqa))
    module = init(cfg, torch.Generator().manual_seed(7), "cpu")
    sharded = distribute_model(init(cfg, torch.Generator().manual_seed(7),
                                    "cpu"), mesh)
    cache = init_cache(cfg, b, %(t)d, torch.float32, device="cpu")
    xs = torch.randn(%(t)d, b, 1, cfg.d_model,
                     generator=torch.Generator().manual_seed(8))
    plain = {k: v.clone() for k, v in cache.items()}
    specs = {k: cache_leaf_spec(k, tuple(v.shape), mesh, seq)
             for k, v in cache.items()}
    cache = {k: distribute(v, specs[k], mesh) for k, v in cache.items()}
    res = out[name] = {"specs": {k: tuple(v) for k, v in specs.items()},
                       "caches": [], "plain": []}
    with torch.no_grad():
        for pos in range(%(t)d):
            step(module, cfg, xs[pos], plain, pos)
            with activation_sharding(mesh, seq_sharded=seq):
                x = distribute(xs[pos], P(dp_entry(mesh, b)), mesh)
                step(sharded, cfg, x, cache, pos)
            res["caches"].append({k: full(v).numpy() for k, v in
                                  cache.items()})
            res["plain"].append({k: v.numpy().copy() for k, v in
                                 plain.items()})
# the server: gemma3's prompt replayed through decode and greedy tokens,
# the caches by cache_shardings (the sequence over "model")
from repro_torch.launch.serve import decode_tokens
from repro_torch.models import transformer as T
cfg = get_config("gemma3_1b", smoke=True)
prompts = torch.randint(0, cfg.vocab, (4, 12),
                        generator=torch.Generator().manual_seed(9))
for name, m in (("served", mesh), ("served_plain", None)):
    model = T.init_model(cfg, 0, "cpu")
    if m is not None:
        model = distribute_model(model, m)
    toks, _, logits = decode_tokens(model, cfg, prompts, %(gen)d, mesh=m)
    out[name] = (toks, logits.numpy())
if rank == 0:
    pickle.dump(out, open(d + "/" + mode + ".pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
""" % {"t": T_CACHE, "gen": GEN}


def _writes(d: str, mode: str) -> dict:
    env = dict(_env(), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WRITER, str(r), d, mode],
                              env=env, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    with open(os.path.join(d, mode + ".pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def writes(tmp_path_factory):
    return {mode: _writes(str(tmp_path_factory.mktemp(mode)), mode)
            for mode in ("decode", "control")}


def _hold_writes(case: dict):
    """After the step at each position the gathered cache differs from the
    cache before it at that position only (of the sequence), and there
    holds the unsharded decode's entry within 1e-6."""
    before = {k: np.zeros_like(v) for k, v in case["caches"][0].items()}
    for pos, (got, plain) in enumerate(zip(case["caches"], case["plain"])):
        for k, v in got.items():
            changed = np.flatnonzero(np.any(v != before[k], axis=tuple(
                i for i in range(v.ndim) if i != 1)))
            assert changed.tolist() == [pos], (k, pos, changed)
            np.testing.assert_allclose(v, plain[k], atol=1e-6, rtol=1e-6)
        before = got


CASES = ("gqa_model", "gqa_data", "mla_model")


@pytest.mark.parametrize("case", CASES)
def test_decode_writes_each_position_of_a_split_sequence(writes, case):
    """The cache's sequence is split (over "model", or over "data" at one
    row), and each step's write lands at its global position only."""
    res = writes["decode"][case]
    axis = "data" if case == "gqa_data" else "model"
    assert all(spec[1] == axis for spec in res["specs"].values()), res
    _hold_writes(res)


@pytest.mark.parametrize("case", CASES)
def test_write_control_dtensor_setitem_fails(writes, case):
    """Control: DTensor's own ``cache[:, pos] = entry`` on the same split
    caches must fail ``_hold_writes``."""
    with pytest.raises(AssertionError):
        _hold_writes(writes["control"][case])


def test_decode_tokens_on_a_split_cache(writes):
    """``launch.serve.decode_tokens(mesh=)`` with gemma3 on 2 x 2 (its one
    kv head's caches split over "model"): the logits after the prompt
    within MODEL_TOL of the unsharded server's and the same greedy
    tokens.  Control: with DTensor's own write the logits miss that."""
    toks, logits = writes["decode"]["served"]
    want_toks, want = writes["decode"]["served_plain"]
    np.testing.assert_allclose(logits, want, atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_array_equal(toks, want_toks)
    _, bad = writes["control"]["served"]
    assert not np.allclose(bad, want, atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.fixture(scope="module")
def runs_1x4(tmp_path_factory):
    return run_families(str(tmp_path_factory.mktemp("qwen3_1x4")),
                        ("qwen3_14b",), decode=("qwen3_14b",), steps=(),
                        positions=POSITIONS, mesh=(1, 4))


def test_qwen3_decode_on_1x4(runs_1x4):
    """qwen3's serve steps on a (1, 4) mesh, its caches' sequence over
    "model" in four blocks, against the reference's steps on the same mesh
    and the port's unsharded ones (``hold_decode``, with its control)."""
    _, ref, port = runs_1x4
    assert ref["qwen3_14b"].get("error") is None
    assert {pl[1] for layer in port["qwen3_14b"]["cache_placements"]
            for pl in layer.values()} == {"Shard(dim=1)"}
    hold_decode(runs_1x4, "qwen3_14b")
