"""The sharded path on the reference's two-pod mesh: a (2, 2, 2) ("pod",
"data", "model") mesh of eight gloo processes, whose DP entry is ("pod",
"data") (``repro/launch/mesh.py``, ``repro/distributed/sharding.py``), at
smoke size in f32, against the port's own unsharded steps and, for the MoE
families, the reference's steps on eight forced host devices.

- Every family in the default layout: the prefill (llava with its frontend
  embeddings, seamless with its encoder frames), one train step, a weight
  split over "model", and serve steps at POSITIONS on four rows (one a
  (pod, data) rank) on caches laid out by ``cache_shardings``.
- dbrx, deepseek, jamba, qwen3 and gemma3 under the reference dry-run's
  other layouts (``seq_sharded``, ``residual_seq_parallel``,
  ``attn_seq_parallel``): the prefill and one train step, and under
  ``seq_sharded`` one-row serve steps at POSITIONS on long_500k's caches
  (every attention cache's sequence over "data", the row whole on "pod").
- Fault 38: the MoE families' (dbrx, deepseek, jamba) train step raised on
  this mesh in every layout ("shape '[1, 16, 64]' is invalid for input of
  size 512", the backward of ``apply_moe``'s flatten): ``divisible``
  gathers "pod" out of the dispatch's gates, and its backward left their
  gradient gathered, which the router's backward turned into a token
  gradient split over "model" too.
- ``train(mesh=)`` of deepseek and qwen3, two steps of eight rows as two
  microbatches, against the unsharded ``train``.
- After every train step each block of a parameter, AdamW moment and the
  step count is bitwise equal on the ranks that hold it (DTensor warns
  that nested splits reduce in sequence and "may give inconsistent results
  between ranks").
- ``compress_pod_gradients`` over the mesh's own "pod" group
  (``chip_smoke.pod_compression``, phase 13f's check).
- Fault 39: the embedding's gather under PyTorch 2.11's rule, emulated.

All of it runs in one launch (``test_torch_sharded_dense.run_many``), the
held steps through ``test_torch_sharded_dense``'s ``hold_*`` with their
bounds and controls.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.launch.train import train
from test_torch_sharded_dense import (MODEL_TOL, POSITIONS, hold_decode,
                                      hold_prefill, hold_split, hold_train,
                                      ran, run_many, shared,
                                      unsharded_prefill)
from test_torch_sharded_steps import ROOT, SELF_TOL

MESH = (2, 2, 2)
AXES = ("pod", "data", "model")
MOE = ("dbrx_132b", "deepseek_v2_lite_16b", "jamba_1_5_large_398b")
# the families run under every layout
FIVE = MOE + ("qwen3_14b", "gemma3_1b")
# the reference dry-run's other layouts: activation_sharding's options
LAYOUTS = {"seq_sharded": {"seq": True, "cache_seq": True},
           "residual_seq_parallel": {"sp": True},
           "attn_seq_parallel": {"attn_sp": True}}
LAYOUT_CASES = [(name, arch) for name in LAYOUTS for arch in FIVE]
# train(mesh=): two steps of eight rows as two microbatches, so that each
# microbatch's four rows split over pod x data
TRAINER = ("deepseek_v2_lite_16b", "qwen3_14b")
TRAIN_KW = dict(steps=2, batch=8, seq=16, accum_steps=2, log_every=100,
                device="cpu")

EXTRA = """
from repro_torch.launch.train import train

# phase 13f's compression over the mesh's "pod" group
sys.path.insert(0, %(root)r)
from chip_smoke import pod_compression
out["compress"] = pod_compression(mesh, torch.device("cpu"), 0)

out["trainer"] = {}
for arch in %(trainer)r:
    try:
        m, losses = train(arch, mesh=mesh, **%(train_kw)r)
        out["trainer"][arch] = {"losses": losses, "params": {
            k: full(v).detach().numpy() for k, v in m.state_dict().items()}}
    except Exception:
        out["trainer"][arch] = {"error": traceback.format_exc()[-3000:]}

# PyTorch 2.11's rule for the gather, emulated on this PyTorch (which
# relaxed it): it refuses an index with a dimension split over two mesh
# axes.  Fresh shapes, so that no cached propagation answers first.
import torch.distributed.tensor._sharding_prop as SP
from torch.utils._pytree import tree_leaves
from repro_torch.distributed.sharding import rows

propagate = SP.ShardingPropagator.propagate_op_sharding_non_cached


def gather_rule(self, op_schema):
    if op_schema.op == torch.ops.aten.index.Tensor:
        for spec in tree_leaves(op_schema.args_schema):
            dims = [q.dim for q in getattr(spec, "placements", ())
                    if q.is_shard()]
            if len(dims) != len(set(dims)):
                raise RuntimeError("2.11 rule: an index split twice")
    return propagate(self, op_schema)


SP.ShardingPropagator.propagate_op_sharding_non_cached = gather_rule
whole = torch.arange(96.).reshape(24, 4)
ids = torch.arange(16).reshape(8, 2) * 5 %% 24
table = distribute(whole, P("model", "data"), mesh).requires_grad_(True)
tokens = distribute(ids, P(("pod", "data")), mesh)
weight = distribute(torch.arange(64.).reshape(8, 2, 4), P(("pod", "data")),
                    mesh)
out["gather_rule"] = {}
try:
    got = rows(table, tokens)
    (got * weight).sum().backward()
    plain = whole.clone().requires_grad_(True)
    (plain[ids] * full(weight)).sum().backward()
    out["gather_rule"]["port"] = bool(
        torch.equal(full(got), whole[ids])
        and torch.equal(full(table.grad), plain.grad))
except Exception:
    out["gather_rule"]["port"] = traceback.format_exc()[-1500:]
try:
    table.detach()[tokens]
    out["gather_rule"]["plain"] = "ran"
except Exception:
    out["gather_rule"]["plain"] = traceback.format_exc()[-1500:]
SP.ShardingPropagator.propagate_op_sharding_non_cached = propagate
""" % {"root": ROOT, "trainer": TRAINER, "train_kw": TRAIN_KW}


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The default layout's prefill and train step (the reference's too for
    the MoE families), its serve steps on four rows, then each of
    LAYOUTS'."""
    return run_many(str(tmp_path_factory.mktemp("pod")), [
        dict(archs=ARCHS, ref_archs=MOE, replicas=True),
        dict(archs=ARCHS, steps=(), ref_archs=(), decode=ARCHS,
             positions=POSITIONS)] + [
        dict(archs=FIVE, layout=layout, ref_archs=(), replicas=True,
             decode=FIVE if layout.get("cache_seq") else (), decode_batch=1,
             positions=POSITIONS, seeds=ARCHS)
        for layout in LAYOUTS.values()], mesh=MESH, axes=AXES, extra=EXTRA)


@pytest.fixture(scope="module")
def runs(launch):
    return launch[0]


@pytest.fixture(scope="module")
def serve(launch):
    return launch[1]


@pytest.fixture(scope="module")
def layouts(launch):
    return dict(zip(LAYOUTS, launch[2:]))


def test_reference_steps_ran(runs):
    """The reference's 2 x 2 x 2 prefill and train step ran for the MoE
    families (none raised)."""
    _, ref, _ = runs
    assert {a: ref[a].get("error") for a in MOE} == dict.fromkeys(MOE)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_pod(runs, arch):
    hold_prefill(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_pod(runs, arch):
    """One train step, against the unsharded one and, for the MoE families,
    the reference's 2 x 2 x 2 step (fault 38: theirs raised here)."""
    hold_train(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_split_over_model(runs, arch):
    hold_split(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_pod(serve, arch):
    """Serve steps at POSITIONS on four rows, one a (pod, data) rank, on
    caches laid out by ``cache_shardings``, against the unsharded steps
    (``hold_decode``, with its control: every write lost)."""
    hold_decode(serve, arch)


def test_decode_rows_one_a_pod_data_rank(serve):
    """The serve steps' four rows lie one on each (pod, data) rank: the
    attention caches of gemma3 and the latent cache of deepseek have their
    rows split over ("pod", "data") and their heads or features over
    "model".  Control: no cache is whole on "pod"."""
    _, _, port = serve
    for arch in ("gemma3_1b", "deepseek_v2_lite_16b"):
        pls = [pl for layer in ran(port, arch)["cache_placements"]
               for pl in layer.values()]
        assert pls and all(pl[0] == pl[1] == "Shard(dim=0)" for pl in pls), (
            arch, pls)
        assert any(pl[2].startswith("Shard") for pl in pls), (arch, pls)


def test_llava_frontend_reaches_the_sharded_prefill(runs):
    """Control for llava's frontend on this mesh: its unsharded prefill with
    the frontend embeddings zeroed must fail the prefill check."""
    inputs, _, port = runs
    fe = torch.from_numpy(inputs["batches"]["llava_next_34b"]
                          ["frontend_embeds"])
    other = unsharded_prefill(inputs, "llava_next_34b",
                              frontend_embeds=torch.zeros_like(fe))
    assert not np.allclose(ran(port, "llava_next_34b")["prefill"], other,
                           atol=MODEL_TOL, rtol=MODEL_TOL)


def whole_on_every_rank(every: list) -> list:
    """Readings of ``replicas`` (a {name: (coordinates, digest)} a rank):
    every block is bitwise equal on the ranks with its coordinates.
    Returns the names whole on every rank; a name split over an axis must
    differ in some block (the digests see the bytes)."""
    whole = []
    for k in every[0]:
        blocks = {}
        for rank in every:
            blocks.setdefault(rank[k][0], set()).add(rank[k][1])
        assert all(len(d) == 1 for d in blocks.values()), (k, blocks)
        if len(blocks) == 1:
            whole.append(k)
    split = [k for k in every[0] if k not in whole]
    assert any(len({r[k][1] for r in every}) > 1 for k in split)
    return whole


def hold_replicas(runs, arch):
    """The train step's ``replicas`` readings of ``arch``: every block
    bitwise equal on the ranks that hold it, each held by both pods ("pod"
    splits nothing), and the step count on all eight ranks."""
    _, _, port = runs
    every = ran(port, arch)["replicas"]
    assert len(every) == np.prod(MESH)
    assert "opt.step" in whole_on_every_rank(every)
    assert all(r[k][0][0] is None for r in every for k in r)


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_blocks_bitwise_after_the_train_step(runs, arch):
    """After the train step every block of a parameter and of its AdamW
    moments is bitwise equal on the ranks that hold it, each held by both
    pods ("pod" splits nothing), and the step count on all eight."""
    hold_replicas(runs, arch)


def unsharded_trainer(runs, arch) -> list:
    """The losses of ``train`` unsharded with TRAIN_KW, once a session."""
    inputs, _, _ = runs
    return shared(inputs["session"], "unsharded", ("trainer", arch, TRAIN_KW),
                  lambda: train(arch, **TRAIN_KW)[1])


@pytest.mark.parametrize("arch", TRAINER)
def test_trainer_pod(runs, arch):
    """``train(mesh=)``, two steps of eight rows as two microbatches (a
    microbatch's four rows over pod x data): each step's loss within
    SELF_TOL relative of the unsharded ``train``'s.  Control: the loss
    moved between the steps."""
    _, _, port = runs
    got = port["trainer"][arch]
    assert "error" not in got, got["error"]
    want = unsharded_trainer(runs, arch)
    assert len(got["losses"]) == len(want) == TRAIN_KW["steps"]
    for g, w in zip(got["losses"], want):
        assert abs(g - w) <= SELF_TOL * abs(w), (got["losses"], want)
    assert abs(want[1] - want[0]) > SELF_TOL * abs(want[0])


def test_pod_compression_on_the_mesh_group(runs):
    """``compress_pod_gradients`` over ``mesh.get_group("pod")``, each
    rank's gradients of its own row (``chip_smoke.pod_compression``):
    bitwise the int8 sum of the two pods' payloads computed locally, on
    every rank, its group the rank four ahead or behind.  Control: the
    same over the "data" group differs."""
    _, _, port = runs
    every = port["compress"]
    assert len(every) == np.prod(MESH)
    for rank, c in enumerate(every):
        assert c["peers"] == [rank % 4, rank % 4 + 4]
        assert c["bitwise"] and c["pods_differ"] and c["control_differs"]


def test_gather_under_2_11_rule(runs):
    """The embedding's gather (``sharding.rows``) with the tokens split over
    ("pod", "data") under PyTorch 2.11's rule, emulated: its values and the
    table's gradient those of the plain gather (fault 39: 2.11 refused
    every family's first step on this mesh).  Control: DTensor's own
    gather of the same tokens raises under the emulated rule."""
    _, _, port = runs
    assert port["gather_rule"]["port"] is True, port["gather_rule"]["port"]
    assert "2.11 rule" in port["gather_rule"]["plain"]


@pytest.mark.parametrize("layout, arch", LAYOUT_CASES)
def test_prefill_pod_layout(layouts, layout, arch):
    hold_prefill(layouts[layout], arch)


@pytest.mark.parametrize("layout, arch", LAYOUT_CASES)
def test_train_step_pod_layout(layouts, layout, arch):
    """Fault 38: the MoE families raised here in every layout."""
    hold_train(layouts[layout], arch)


@pytest.mark.parametrize("layout, arch", LAYOUT_CASES)
def test_replicated_blocks_bitwise_under_layout(layouts, layout, arch):
    hold_replicas(layouts[layout], arch)


@pytest.mark.parametrize("arch", FIVE)
def test_decode_pod_long_500k_layout(layouts, arch):
    """One-row serve steps at POSITIONS under ``seq_sharded`` on long_500k's
    caches (``cache_shardings(seq_sharded=True)``), against the unsharded
    steps (``hold_decode``, with its control: every write lost)."""
    hold_decode(layouts["seq_sharded"], arch)


def test_long_500k_caches_split_over_data(layouts):
    """Under ``seq_sharded`` at one row every attention cache has its
    sequence split over "data" and its row whole on "pod" (one row does
    not divide it); the SSM caches have no sequence.  Control: no attention
    cache is split over "pod"."""
    _, _, port = layouts["seq_sharded"]
    for arch in FIVE:
        attn = [pl for layer in ran(port, arch)["cache_placements"]
                for name, pl in layer.items() if name not in ("conv",
                                                              "state")]
        assert attn and all(pl[1] == "Shard(dim=1)" for pl in attn), arch
        assert not any(pl[0].startswith("Shard") for pl in attn), arch
