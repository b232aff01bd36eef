"""The port's MoE FFN against the JAX package's (``repro.models.moe``).

Both packages get the same values: the reference's parameters
(``init_moe``) carried across as numpy arrays, and inputs made with numpy
from a seed, on the dbrx smoke config (no shared experts) and the deepseek
one (one shared expert), in f32.  The tolerance is 1e-5 (``FN_TOL``): f32
products and sums taken in other orders.  Before the outputs, the routing is
held exactly: the same experts for every token, the same capacity, the same
assignments kept and dropped.  The reference's grouped dispatch runs under
``REPRO_MOE_GROUPS``, the port's with ``groups``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JM
from repro.models.layers import ABSTRACT_INIT

from repro_torch import configs
from repro_torch.models import moe as M
from repro_torch.models.layers import apply_mlp

MOE = ["dbrx_132b", "deepseek_v2_lite_16b"]
FN_TOL = 1e-5


def _moe(arch, seed=0, **changes):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               **changes)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **changes)
    p, _ = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    port = M.MoE(cfg, None, "meta")
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in p.items()}, strict=True, assign=True)
    return jcfg, cfg, p, port


def _x(cfg, seed, shape=(2, 16)):
    return (np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)) * 0.5).astype(np.float32)


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


def _reference_routing(p, cfg, xt, groups, cap):
    """The reference's top-k experts [T, k], and its kept flags and slots in
    token order (its ``_dispatch_group`` returns them sorted by expert)."""
    logits = (xt @ p["router"].astype(jnp.float32)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    t, k = idx.shape
    tl = t // groups
    keep = np.zeros((groups, tl * k), bool)
    slot = np.zeros((groups, tl * k), np.int64)
    for g in range(groups):
        ig = idx[g * tl:(g + 1) * tl]
        _, _, _, kg, sg = JM._dispatch_group(
            xt[g * tl:(g + 1) * tl], ig, jnp.ones(ig.shape, jnp.float32),
            cfg.n_experts, cap)
        order = np.argsort(np.asarray(ig).reshape(-1), kind="stable")
        keep[g, order] = np.asarray(kg)
        slot[g, order] = np.asarray(sg) + g * cfg.n_experts * cap
    return np.asarray(idx), np.asarray(probs), keep.reshape(-1), \
        slot.reshape(-1)


def _routing_diff(idx, ref_idx, probs, k):
    """A token whose experts differ, with the reference's margin between its
    k-th and (k+1)-th probabilities (a near-tie is the cause to look for)."""
    bad = np.nonzero((idx != ref_idx).any(-1))[0]
    if not len(bad):
        return None
    t = int(bad[0])
    top = np.sort(probs[t])[::-1]
    return (f"token {t}: port {idx[t].tolist()}, reference "
            f"{ref_idx[t].tolist()}, reference top-k margin "
            f"{top[k - 1] - top[k]:.3e}")


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25, "n_experts"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(arch, cf, groups, monkeypatch):
    """Routing, kept and dropped assignments, then the output, at capacity
    factors that drop many, some and none."""
    jcfg, cfg, p, port = _moe(arch)
    cf = float(cfg.n_experts) if cf == "n_experts" else cf
    monkeypatch.setenv("REPRO_MOE_GROUPS", str(groups))
    x = _x(cfg, 1)
    t = x.shape[0] * x.shape[1]
    xt = torch.from_numpy(x.reshape(t, -1))
    cap = M.capacity(t // groups, cfg.top_k, cfg.n_experts, cf)
    ref_idx, probs, ref_keep, ref_slot = _reference_routing(
        p, jcfg, jnp.asarray(x.reshape(t, -1)), groups, cap)
    gates, idx = M.route(port, cfg, xt)
    diff = _routing_diff(idx.numpy(), ref_idx, probs, cfg.top_k)
    assert diff is None, diff
    _, slot, keep = M._dispatch(xt, idx, groups, cfg.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    np.testing.assert_array_equal(slot.numpy()[ref_keep], ref_slot[ref_keep])
    assert (slot.numpy()[~ref_keep] == groups * cfg.n_experts * cap).all()
    if cf == 0.5:
        assert 0 < ref_keep.sum() < ref_keep.size
    if cf == cfg.n_experts:
        assert ref_keep.all()

    want = JM.apply_moe(p, jcfg, jnp.asarray(x), capacity_factor=cf)
    got = M.apply_moe(port, cfg, torch.from_numpy(x), capacity_factor=cf,
                      groups=groups)
    assert got.shape == x.shape
    _close(got, want)


@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_the_plain_mix(arch):
    """At ample capacity the port's dispatch equals the per-token mix
    written out expert by expert (the reference's
    ``test_moe_matches_dense_reference``), plus the shared experts."""
    _, cfg, _, port = _moe(arch, seed=2)
    xt = torch.from_numpy(_x(cfg, 3).reshape(-1, cfg.d_model))
    gates, idx = M.route(port, cfg, xt)
    want = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        pe = SimpleNamespace(wi=port.wi[e], wo=port.wo[e], wg=port.wg[e])
        w = ((idx == e) * gates).sum(-1)[:, None]
        want = want + w * apply_mlp(pe, xt, cfg.mlp_act)
    if cfg.n_shared_experts:
        pe = SimpleNamespace(wi=port.shared_wi, wo=port.shared_wo,
                             wg=port.shared_wg)
        want = want + apply_mlp(pe, xt, cfg.mlp_act)
    got = M.apply_moe(port, cfg, xt[None], capacity_factor=cfg.n_experts)
    _close(got[0], want)


@pytest.mark.parametrize("act", ["silu", "gelu", "squared_relu"])
def test_expert_ffn_per_activation(act):
    """The batched expert products for gated and plain activations against
    the reference's ``_expert_ffn``, and the shapes ``init_moe`` gives."""
    jcfg, cfg, p, port = _moe("deepseek_v2_lite_16b", mlp_act=act)
    assert hasattr(port, "wg") == (act != "squared_relu")
    assert hasattr(port, "shared_wg") == (act != "squared_relu")
    h = _x(cfg, 4, (cfg.n_experts, 8))
    _close(M._expert_ffn(port, torch.from_numpy(h), act),
           JM._expert_ffn(p, jnp.asarray(h), act))
    x = _x(cfg, 5)
    _close(M.apply_moe(port, cfg, torch.from_numpy(x)),
           JM.apply_moe(p, jcfg, jnp.asarray(x)))


def test_parameter_shapes_and_scales():
    """The reference's names and shapes; dense weights at 1/sqrt(fan_in)."""
    cfg = configs.get_config("deepseek_v2_lite_16b")
    port = M.MoE(cfg, None, "meta")
    tok = ABSTRACT_INIT.set(True)
    try:
        p, _ = JM.init_moe(None, jconfigs.get_config("deepseek_v2_lite_16b"))
    finally:
        ABSTRACT_INIT.reset(tok)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    small = dataclasses.replace(configs.get_config("dbrx_132b", smoke=True),
                                n_experts=8, moe_d_ff=256)
    m = M.MoE(small, torch.Generator().manual_seed(0), "cpu")
    assert abs(float(m.wi.std()) - 1 / np.sqrt(small.d_model)) < 0.01
    assert abs(float(m.wo.std()) - 1 / np.sqrt(256)) < 0.01


@pytest.mark.parametrize("tl,k,e,cf,cap", [
    (4, 6, 64, 1.25, 8),          # deepseek decode, 4 tokens: round to 0
    (8192, 4, 16, 1.25, 2560),    # dbrx prefill, 4 x 2048
    (33, 1, 2, 1.0, 16),          # 16.5 rounds to even, then pads to 16
    (35, 1, 2, 1.0, 24),          # 17.5 rounds to even, 18 -> 24
    (32, 2, 4, 8.0, 128)])
def test_capacity_rounds_as_the_reference(tl, k, e, cf, cap, monkeypatch):
    assert M.capacity(tl, k, e, cf) == cap
    # the reference's: its dispatch buffer holds cap slots an expert
    cfg = dataclasses.replace(jconfigs.get_config("dbrx_132b", smoke=True),
                              n_experts=e, top_k=k, moe_d_ff=8, d_model=8)
    p, _ = JM.init_moe(jax.random.PRNGKey(0), cfg)
    captured = {}
    orig = JM._dispatch_group

    def spy(xg, idx, gates, e_, cap_):
        captured["cap"] = cap_
        return orig(xg, idx, gates, e_, cap_)
    monkeypatch.setattr(JM, "_dispatch_group", spy)
    JM.apply_moe(p, cfg, jnp.zeros((1, tl, 8), jnp.float32),
                 capacity_factor=cf)
    assert captured["cap"] == cap


def test_router_promotes_bf16_activations():
    """bf16 activations meet an f32 router: the reference promotes the
    product to f32, the port casts both operands to f32 itself."""
    jcfg, cfg, p, port = _moe("deepseek_v2_lite_16b")
    x = _x(cfg, 6).reshape(-1, cfg.d_model)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gates, idx = M.route(port, cfg, xb)
    assert gates.dtype == torch.float32
    logits = jnp.asarray(xb.float().numpy(), jnp.bfloat16) @ p["router"]
    assert logits.dtype == jnp.float32
    want_g, want_i = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    _close(gates, want_g / want_g.sum(-1, keepdims=True))
    out = M.apply_moe(port, cfg, xb[None])
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


def test_dispatch_is_deterministic_and_conserves_tokens():
    """Run to run bitwise; every kept assignment holds its token's row in
    its own slot, and the spare row alone takes the dropped ones."""
    _, cfg, _, port = _moe("dbrx_132b")
    xt = torch.from_numpy(_x(cfg, 7).reshape(-1, cfg.d_model))
    _, idx = M.route(port, cfg, xt)
    cap = M.capacity(xt.shape[0], cfg.top_k, cfg.n_experts, 0.5)
    buf, slot, keep = M._dispatch(xt, idx, 1, cfg.n_experts, cap)
    assert buf.shape == (cfg.n_experts * cap + 1, cfg.d_model)
    tok = torch.arange(slot.numel()) // cfg.top_k
    assert torch.equal(buf[slot[keep]], xt[tok[keep]])
    assert len(set(slot[keep].tolist())) == int(keep.sum())
    assert torch.equal(slot // cap < cfg.n_experts, keep)
    assert torch.equal(slot[keep] // cap, idx.reshape(-1)[keep])
    a = M.apply_moe(port, cfg, xt[None], capacity_factor=0.5)
    b = M.apply_moe(port, cfg, xt[None], capacity_factor=0.5)
    assert torch.equal(a, b)
