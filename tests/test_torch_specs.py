"""The port's launch specs (``repro_torch.launch.specs``) and the dry-run's
state bytes against the reference's ``repro.launch.specs`` and
``repro.launch.dryrun._sharded_bytes``, for every config, on both
production meshes (queue 1 item 13.6).

The reference's shardings are ``NamedSharding``s over a real mesh, so they
are computed in one subprocess on 512 forced host devices (nothing is
lowered) and carried back as spec tuples by the port's parameter names and
layer order; the port's run on ``launch.mesh.abstract_mesh``.
"""
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.optim import Q8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = configs.ARCHS
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

REFERENCE = r'''
import pickle, sys
import numpy as np, jax
from jax.sharding import NamedSharding
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import specs as S
from repro.launch.dryrun import _sharded_bytes
from repro.launch.mesh import make_production_mesh
from repro.models.transformer import _regions
from repro.optim.quantized import Q8
from repro_torch.configs import get_config as port_config
from repro_torch.convert import _flat_state


class Spec:
    """A spec tuple; a scan group's drops the leading "stack" entry."""
    def __init__(self, t):
        self.t = tuple(t)

    def __getitem__(self, g):
        assert self.t == () or self.t[0] is None
        return Spec(self.t[1:])


def specs(tree):
    return jax.tree.map(lambda sh: Spec(sh.spec), tree,
                        is_leaf=lambda x: isinstance(x, NamedSharding))


def plain(x):
    if isinstance(x, tuple) and not isinstance(x, Spec) and hasattr(x, "_fields"):
        return ("Q8", plain(x.q), plain(x.scale))
    return x.t


def flat(tree, cfg):
    return {k: plain(v) for k, v in _flat_state(specs(tree), cfg).items()}


def layers(tree, cfg):
    """A cache tree -> one dict a layer, in layer order."""
    pre, n_groups, rem = _regions(cfg)
    out = [{k: plain(v) for k, v in c.items()} for c in tree["prefix"]]
    if tree["stack"] is not None:
        for g in range(n_groups):
            out += [{k: plain(v[g]) for k, v in c.items()} for c in tree["stack"]]
    return out + [{k: plain(v) for k, v in c.items()} for c in tree["remainder"]]


out = {}
for kind, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCHS:
        cfg, pcfg = get_config(arch), port_config(arch)
        rec = {}
        for q in (False, True):
            params_abs, p_sh, opt_abs, opt_sh = S.train_state_shardings(
                cfg, mesh, quantized_opt=q)
            rec[("params", q)] = flat(p_sh, pcfg)
            rec[("m", q)] = flat(opt_sh.m, pcfg)
            rec[("v", q)] = flat(opt_sh.v, pcfg)
            rec[("step", q)] = tuple(opt_sh.step.spec)
        params_abs, p_sh, opt_abs, opt_sh = S.train_state_shardings(cfg, mesh)
        for name, shape in SHAPES.items():
            rec[("batch", name)] = {k: tuple(v.spec) for k, v in
                                    S.batch_shardings(cfg, shape, mesh).items()}
            rec[("inputs", name)] = {
                k: (tuple(v.shape), str(v.dtype))
                for k, v in S.input_specs(cfg, shape).items()}
            rec[("logits", name)] = tuple(
                S.logits_sharding(cfg, shape.global_batch, mesh).spec)
            if name == "long_500k" and not cfg.sub_quadratic():
                continue
            state = _sharded_bytes(params_abs, p_sh)
            if shape.kind == "train":
                state += (_sharded_bytes(opt_abs.m, p_sh)
                          + _sharded_bytes(opt_abs.v, p_sh))
            if shape.kind == "decode":
                seq = name == "long_500k"
                cache = S.abstract_cache(cfg, shape.global_batch,
                                         shape.seq_len, np.dtype(cfg.dtype))
                cache_sh = S.cache_shardings(cfg, cache, mesh,
                                             seq_sharded=seq)
                rec[("cache", name)] = layers(specs(cache_sh), cfg)
                state += _sharded_bytes(cache, cache_sh)
            rec[("state", name)] = state
        out[(kind, arch)] = rec
pickle.dump(out, open(sys.argv[1], "wb"))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("specs") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", REFERENCE, path], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _mesh(kind):
    return abstract_mesh(*MESHES[kind])


def _plain(x):
    if isinstance(x, Q8):
        return ("Q8", tuple(x.q), tuple(x.scale))
    return tuple(x)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shardings_equal_reference(ref, arch, kind):
    """Parameters and the two moments, f32 and Q8 (payload as its
    parameter, the scale by the reference's block rule), entry by entry."""
    cfg = configs.get_config(arch)
    want = ref[(kind, arch)]
    for q in (False, True):
        _, p_sh, opt_abs, opt_sh = S.train_state_shardings(cfg, _mesh(kind),
                                                           quantized_opt=q)
        assert {k: tuple(v) for k, v in p_sh.items()} == want[("params", q)]
        assert {k: _plain(v) for k, v in opt_sh.m.items()} == want[("m", q)]
        assert {k: _plain(v) for k, v in opt_sh.v.items()} == want[("v", q)]
        assert tuple(opt_sh.step) == want[("step", q)]
    # a Q8 scale whose block count the axis does not divide is replicated
    # there (the reference's rule), so the two kinds of moment differ
    assert want[("m", True)] != {k: ("Q8", v, v) for k, v in
                                 want[("params", True)].items()}


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_batch_logits_and_cache_specs_equal_reference(ref, arch, kind):
    cfg = configs.get_config(arch)
    mesh = _mesh(kind)
    want = ref[(kind, arch)]
    for name, shape in configs.SHAPES.items():
        got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for k, t in S.input_specs(cfg, shape).items()}
        assert got == want[("inputs", name)], name
        assert {k: tuple(v) for k, v in
                S.batch_shardings(cfg, shape, mesh).items()} == \
            want[("batch", name)]
        assert tuple(S.logits_sharding(cfg, shape.global_batch, mesh)) == \
            want[("logits", name)]
        if ("cache", name) in want:
            cache = S.abstract_cache(cfg, shape.global_batch, shape.seq_len)
            got = [{k: tuple(v) for k, v in c.items()} for c in
                   S.cache_shardings(cfg, cache, mesh,
                                     seq_sharded=name == "long_500k")]
            assert got == want[("cache", name)], name


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_equal_reference_every_cell(ref, arch, kind):
    """The dry-run's ``state_bytes_per_device`` of every cell it traces
    (long_500k of a full-attention arch is skipped, as in the reference)
    equals the reference's ``_sharded_bytes`` arithmetic."""
    cfg = configs.get_config(arch)
    want = ref[(kind, arch)]
    cells = [n for n in configs.SHAPES if ("state", n) in want]
    assert ("long_500k" in cells) == cfg.sub_quadratic()
    for name in cells:
        got = dryrun.state_bytes_per_device(cfg, configs.SHAPES[name],
                                            _mesh(kind))
        assert got == want[("state", name)], name


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_allocates_nothing(arch):
    """Parameters, moments, caches and inputs on the meta device; the
    parameter count is the config's (plus the vocab padding)."""
    cfg = configs.get_config(arch)
    model = S.abstract_params(cfg)
    leaves = list(model.parameters())
    assert all(p.device.type == "meta" for p in leaves)
    opt = S.abstract_opt_state(model, quantized=True)
    assert all(x.q.device.type == "meta" for x in opt.m.values())
    # the shapes and dtypes adamw_init gives, on one small parameter
    from repro_torch.optim import adamw_init
    name, p = next((k, p) for k, p in model.named_parameters()
                   if p.ndim == 2)
    small = {name: torch.zeros((3, 300))}
    want = adamw_init(small, quantize=True).m[name]
    got = S.abstract_opt_state(types.SimpleNamespace(
        named_parameters=lambda: small.items()), quantized=True).m[name]
    assert (got.q.shape, got.q.dtype, got.scale.shape, got.scale.dtype) == \
        (want.q.shape, want.q.dtype, want.scale.shape, want.scale.dtype)
    assert S.abstract_opt_state(model).m[name].dtype == torch.float32
    shape = configs.SHAPES["decode_32k"]
    cache = S.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    assert all(t.device.type == "meta" for c in cache for t in c.values())
    assert all(t.device.type == "meta" for t in
               S.input_specs(cfg, configs.SHAPES["train_4k"]).values())
    n = sum(int(np.prod(p.shape)) for p in leaves)
    total, _ = cfg.param_count()
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    assert abs(n - total - pad) / total < 0.02
    assert torch.empty(0).device.type == "cpu"
