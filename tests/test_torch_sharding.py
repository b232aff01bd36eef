"""The port's logical axes and sharding rules (queue 1 item 13.6,
``repro_torch.distributed.sharding``) against the reference's.

The reference's ``partition_spec``, ``batch_spec`` and ``cache_spec`` read
only a mesh's axis names and sizes, so they run here on a stand-in of the
production meshes' shape; the port's take a ``DeviceMesh`` with no process
group behind it (``launch.mesh.abstract_mesh``).  Specs compare entry by
entry (the port's ``P`` against the reference's ``PartitionSpec``).
"""
import types

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as JS
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.convert import _flat_state
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import transformer as T
from repro_torch.models.layers import param_axes

ARCHS = configs.ARCHS
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _ref_mesh(shape, axes):
    """The reference's mesh as its spec functions read it."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, np.int8),
                                 shape=dict(zip(axes, shape)))


class _Ax:
    """A reference axes leaf, indexable by scan group as ``_flat_state``
    indexes a stacked leaf: the group's axes drop the leading "stack"."""

    def __init__(self, axes):
        self.axes = tuple(axes)

    def __getitem__(self, g):
        assert self.axes[0] == "stack"
        return _Ax(self.axes[1:])


def _wrap(tree):
    if isinstance(tree, dict):
        return {k: _wrap(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_wrap(v) for v in tree]
    return None if tree is None else _Ax(tree)


def _ref_axes(arch, smoke=False) -> dict:
    """{port parameter name: the reference's axes}."""
    cfg = configs.get_config(arch, smoke=smoke)
    _, axes = JT.init_model_abstract(jconfigs.get_config(arch, smoke=smoke))
    return {k: v.axes for k, v in _flat_state(_wrap(axes), cfg).items()}


def _entries(spec):
    return tuple(spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_reference(arch):
    """Every parameter's logical axes, full config on the meta device,
    equal the reference's (its scanned groups' "stack" dropped).
    (The reference keeps "stack" on its scanned leaves.)"""
    cfg = configs.get_config(arch)
    got = param_axes(T.Model(cfg, None, "meta"))
    want = _ref_axes(arch)
    assert got == want
    assert all("stack" not in a for a in got.values())
    _, axes = JT.init_model_abstract(jconfigs.get_config(arch))
    if axes["stack"] is not None:
        assert axes["stack"][0]["ln1"] == ("stack", "embed")


def test_axes_survive_the_reference_load():
    """``params_from_reference`` replaces the parameters; their axes are
    tagged again."""
    import jax
    from repro_torch.convert import params_from_reference
    jcfg = jconfigs.get_config("qwen3_14b", smoke=True)
    tree = jax.tree.map(np.asarray,
                        JT.init_model(jcfg, jax.random.PRNGKey(0))[0])
    model = params_from_reference(tree, configs.get_config(
        "qwen3_14b", smoke=True), device="cpu")
    assert param_axes(model) == _ref_axes("qwen3_14b", smoke=True)


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_equal_reference(arch, shape, axes):
    """``params_shardings`` equals the reference's ``partition_spec`` of
    every parameter, entry by entry, on both production meshes."""
    model = T.Model(configs.get_config(arch), None, "meta")
    got = S.params_shardings(model, abstract_mesh(shape, axes))
    ref_mesh = _ref_mesh(shape, axes)
    want_axes = _ref_axes(arch)
    for name, p in model.named_parameters():
        want = JS.partition_spec(want_axes[name], tuple(p.shape), ref_mesh)
        assert _entries(got[name]) == _entries(want), name
    # the specs shard something on every axis of the mesh
    used = {a for spec in got.values() for e in spec if e
            for a in (e if isinstance(e, tuple) else (e,))}
    assert used >= {"data", "model"}


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("seq", [False, True])
def test_batch_and_cache_spec_equal_reference(shape, axes, seq):
    mesh, ref = abstract_mesh(shape, axes), _ref_mesh(shape, axes)
    assert _entries(S.batch_spec(mesh, seq)) == \
        _entries(JS.batch_spec(ref, seq))
    for batch in (1, 128):
        assert _entries(S.cache_spec(mesh, batch, seq)) == \
            _entries(JS.cache_spec(ref, batch, seq))


def test_partition_spec_divisibility():
    """The reference's case: an indivisible dimension is replicated,
    never an error."""
    mesh = abstract_mesh((8,), ("model",))
    assert S.partition_spec(("heads", None), (7, 16), mesh) == S.P()
    assert S.partition_spec(("heads", None), (16, 16), mesh) == S.P("model")


def test_partition_spec_no_axis_reuse():
    mesh = abstract_mesh((1, 1), ("data", "model"))
    # the second occurrence of an already-used mesh axis is dropped
    assert S.partition_spec(("mlp", "mlp"), (16, 16), mesh) == S.P("model")


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert S.placements(S.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.placements(S.P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert S.placements(S.P(), mesh) == (Replicate(),) * 3


def test_shard_act_identity_outside_context():
    x = torch.ones((4, 8, 16))
    for kind in ("hidden", "logits", "moe", "moe_tokens", "moe_buf",
                 "attn_q"):
        assert S.shard_act(x, kind) is x
    # a plain tensor inside a context is left as it is too
    with S.activation_sharding(abstract_mesh((2, 2), ("data", "model"))):
        assert S.shard_act(x, "hidden") is x
    assert S.residual_barrier(x) is x


@pytest.mark.parametrize("shape,axes", MESHES + [((4, 2), ("data", "model"))])
@pytest.mark.parametrize("tokens", [1, 64, 4096, 6])
def test_moe_group_count_equals_reference(shape, axes, tokens, monkeypatch):
    """One group a "data" rank where it divides the tokens, else 1; 1
    outside a context.  The reference's environment override is left
    unset (the port reads none)."""
    monkeypatch.delenv("REPRO_MOE_GROUPS", raising=False)
    assert S.moe_group_count(tokens) == JS.moe_group_count(tokens) == 1
    with S.activation_sharding(abstract_mesh(shape, axes)), \
            JS.activation_sharding(_ref_mesh(shape, axes)):
        got = S.moe_group_count(tokens)
        assert got == JS.moe_group_count(tokens)
    data = dict(zip(axes, shape))["data"]
    assert got == (data if tokens % data == 0 else 1)


@pytest.mark.parametrize("kind,shape", [
    ("hidden", (32, 4096, 5120)), ("hidden", (3, 4096, 5120)),
    ("logits", (32, 4096, 151552)), ("logits", (32, 1, 100)),
    ("moe", (64, 160, 2048)), ("moe_tokens", (16, 512, 2048)),
    ("moe_buf", (16, 64, 40, 2048)), ("moe_buf", (3, 60, 40, 2048)),
    ("attn_q", (32, 4096, 40, 128))])
@pytest.mark.parametrize("opts", [{}, {"seq_sharded": True},
                                  {"residual_seq_parallel": True},
                                  {"attn_seq_parallel": True}])
@pytest.mark.parametrize("mesh_shape,axes", MESHES)
def test_activation_specs_equal_reference(kind, shape, opts, mesh_shape,
                                          axes, monkeypatch):
    """``act_spec`` (the layout ``shard_act`` redistributes to) equals the
    spec the reference's ``shard_act`` constrains to, captured at its
    ``with_sharding_constraint``."""
    seen = []
    monkeypatch.setattr(JS.jax.lax, "with_sharding_constraint",
                        lambda x, sh: seen.append(sh.spec) or x)
    monkeypatch.setattr(JS, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))
    ref_mesh = _ref_mesh(mesh_shape, axes)
    with JS.activation_sharding(ref_mesh, **opts):
        JS.shard_act(np.empty(shape, np.int8), kind)
    with S.activation_sharding(abstract_mesh(mesh_shape, axes), **opts):
        got = S.act_spec(shape, kind, S._ACT_CTX.get())
    want = seen[0] if seen else None
    assert (got is None) == (want is None)
    if want is not None:
        assert _entries(got) == _entries(want)


@pytest.fixture
def fake_world():
    """A fake process group of four ranks in this process, closed after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def test_block_tp_reduction_carries_bf16(fake_world):
    """With ``bf16_all_reduce`` off, a qwen3 layer's tensor-parallel
    reductions (attention's and the MLP's row-parallel outputs) carry the
    bf16 activations: ``residual_barrier`` has nothing to pin.  Counted
    with ``CommDebugMode`` on a fake 2 x 2 mesh under ``FakeTensorMode``;
    control: the same layer on f32 activations reduces f32."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import make_smoke_mesh

    class Reduces(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.dtypes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if "all_reduce" in func.__name__:
                self.dtypes.append(args[0].dtype)
            return func(*args, **(kwargs or {}))

    mesh = make_smoke_mesh((2, 2), ("data", "model"), device_type="cpu")
    seen = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(configs.get_config("qwen3_14b", smoke=True),
                                  dtype=dtype)
        with FakeTensorMode(allow_non_fake_inputs=True), \
                S.index_arithmetic_unfaked():
            model = S.distribute_model(T.Model(cfg, None, "cpu"), mesh)
            x = S.distribute(torch.zeros(4, 16, cfg.d_model,
                                         dtype=getattr(torch, dtype)),
                             S.P("data"), mesh)
            rec = Reduces()
            with CommDebugMode() as comm, rec, S.activation_sharding(
                    mesh, bf16_all_reduce=False):
                T.apply_layer(model.layers[0], cfg, 0, x,
                              torch.arange(16)[None])
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        assert counts["c10d_functional.all_reduce"] == len(rec.dtypes) >= 2
        seen[dtype] = set(rec.dtypes)
    assert seen == {"bfloat16": {torch.bfloat16}, "float32": {torch.float32}}


@pytest.fixture
def one_rank_world():
    """A gloo world of one rank in this process, closed after."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_one_kv_head_gradients_bitwise_on_a_mesh(one_rank_world,
                                                 monkeypatch):
    """gemma3's smoke config (one kv head) on a (1, 1) mesh: the loss and
    every gradient bitwise the plain model's (ROADMAP fault 27).  The
    key's gradient came back through DTensor's backward of the rope's
    split with another stride on the size-1 head dimension, and
    ``rms_norm``'s backward summed over it in another order.  Control:
    with ``contiguous_grad`` the identity, some gradient differs."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import layers

    mesh = make_smoke_mesh((1, 1), ("data", "model"), device_type="cpu")
    cfg = configs.get_config("gemma3-1b", smoke=True)
    assert cfg.num_kv_heads == 1
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).long()
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    loss, want = loss_and_grads(
        T.init_model(cfg, 0, "cpu").requires_grad_(True), cfg, batch)

    def on_mesh():
        model = S.distribute_model(T.init_model(cfg, 0, "cpu"), mesh)
        b = {k: S.distribute(v, S.P("data", None), mesh)
             for k, v in batch.items()}
        with S.activation_sharding(mesh):
            got_loss, got = loss_and_grads(model.requires_grad_(True), cfg, b)
        return S.full(got_loss), {k: S.full(g) for k, g in got.items()}

    got_loss, got = on_mesh()
    assert torch.equal(got_loss, loss)
    for k, g in want.items():
        assert torch.equal(got[k], g), k
    monkeypatch.setattr(layers, "contiguous_grad", lambda x: x)
    _, faulty = on_mesh()
    assert any(not torch.equal(faulty[k], g) for k, g in want.items())
