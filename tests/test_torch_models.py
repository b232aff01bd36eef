"""The port's LM serving path (every family: dense, MoE, MLA, SSM, hybrid,
vision frontend, encoder-decoder) against the JAX package's LM scaffold.

Every comparison feeds both packages the same values: the reference's
parameters (``repro.models.*.init_*``) carried across as numpy arrays, and
inputs made with numpy from a seed.  The smoke configs compute in f32; the
tolerance is 1e-5 for single functions and 1e-4 for whole models (f32
matmuls accumulated in different orders by XLA and by PyTorch, over a few
layers).  The reference runs its Pallas flash kernel in interpret mode, the
port its plain version, as on any CPU tensor.
"""
import dataclasses
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT

import repro_torch
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DENSE = ["qwen3_14b", "gemma3_1b", "command_r_35b", "nemotron_4_340b"]
# MoE and MLA: dbrx (GQA, routed experts), deepseek (MLA, a dense first
# layer, shared and routed experts)
MOE = ["dbrx_132b", "deepseek_v2_lite_16b"]
# SSM and hybrid: mamba2 (SSM layers only, tied embeddings), jamba (SSM, MoE
# and attention interleaved in scanned groups); frontends and enc-dec: llava
# (vision embeddings over the leading positions), seamless (an encoder,
# cross-attention in every decoder layer)
SSM = ["mamba2_130m", "jamba_1_5_large_398b"]
ENCDEC = ["llava_next_34b", "seamless_m4t_large_v2"]
FN_TOL = 1e-5
MODEL_TOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _module(module, tree):
    """``module`` (built on the meta device) holding the numpy ``tree``."""
    flat = {}

    def walk(t, prefix):
        for key, sub in t.items():
            if isinstance(sub, dict):
                walk(sub, f"{prefix}{key}.")
            else:
                flat[prefix + key] = torch.from_numpy(np.array(sub))
    walk(tree, "")
    module.load_state_dict(flat, strict=True, assign=True)
    return module


def _inputs(cfg, b=2, seed=20):
    """The reference's ``tests/test_models.py`` model inputs by shape, from
    a seed: frontend embeddings over the first 8 positions, 16 encoder
    frames.  Returns (kwargs for the reference, kwargs for the port)."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.frontend:
        kw["frontend_embeds"] = rng.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32) * 0.5
    if cfg.is_encdec:
        kw["enc_embeds"] = rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32) * 0.5
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.from_numpy(v) for k, v in kw.items()})


def _ref_model(arch, seed=0):
    cfg = jconfigs.get_config(arch, smoke=True)
    params, _ = JT.init_model(cfg, jax.random.PRNGKey(seed))
    port = params_from_reference(jax.tree.map(np.asarray, params),
                                 configs.get_config(arch, smoke=True),
                                 device="cpu")
    return cfg, params, port


# ---------------------------------------------------------------------------
# configs

@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    want = jconfigs.get_config(arch, smoke=smoke)
    got = configs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab == want.padded_vocab
    assert got.param_count() == want.param_count()
    assert [got.layer_kind(i) for i in range(got.num_layers)] == \
        [want.layer_kind(i) for i in range(want.num_layers)]
    assert [got.layer_window(i) for i in range(got.num_layers)] == \
        [want.layer_window(i) for i in range(want.num_layers)]


def test_registry_equals_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_qwen3_14b_parameters():
    """The slice's model: 14.78 B parameters, every layer on the flash path."""
    cfg = configs.get_config("qwen3-14b")
    total, _ = cfg.param_count()
    assert 14.7e9 < total < 14.8e9
    assert T.layer_indices(cfg) == [0] * 40
    assert all(cfg.layer_window(i) is None for i in T.layer_indices(cfg))


def test_gemma3_scanned_layers_take_the_group_index():
    """The reference passes base + j inside every scanned group, so gemma3's
    global layers are 5, 11, 17 and 23 of 26, and the remainder's own
    indices 24 and 25 are local."""
    cfg = configs.get_config("gemma3-1b")
    idx = T.layer_indices(cfg)
    assert idx == [0, 1, 2, 3, 4, 5] * 4 + [24, 25]
    windows = [cfg.layer_window(i) for i in idx]
    assert [n for n, w in enumerate(windows) if w is None] == [5, 11, 17, 23]


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_kinds_and_full_parameter_count(arch):
    """MLA or GQA in every layer, the MoE FFN where ``layer_is_moe`` of the
    layer's index (deepseek's layer 0 dense, at d_ff 10944), and at full
    size the reference's abstract init's parameter count."""
    cfg = configs.get_config(arch)
    m = T.Model(cfg, None, "meta")
    idx = T.layer_indices(cfg)
    assert [hasattr(lp, "moe") for lp in m.layers] == \
        [cfg.layer_is_moe(i) for i in idx]
    assert all(isinstance(lp.attn, A.MLA if cfg.mla else A.GQA)
               for lp in m.layers)
    if cfg.first_dense:
        assert idx[:2] == [0, 1]
        assert tuple(m.layers[0].mlp.wi.shape) == (cfg.d_model, 10944)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        JT.init_model_abstract(jconfigs.get_config(arch))[0]))
    assert sum(p.numel() for p in m.parameters()) == want
    if arch == "deepseek_v2_lite_16b":
        assert want == 15_706_484_224
        norms = cfg.d_model * (2 * cfg.num_layers + 1) \
            + cfg.kv_lora_rank * cfg.num_layers
        assert want - cfg.param_count()[0] == norms == 126_464


# ---------------------------------------------------------------------------
# layer functions

def test_rms_norm():
    x, w = _rand((2, 5, 64), 0), _rand((64,), 1, 0.1)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("act", ["silu", "gelu", "squared_relu"])
def test_apply_mlp(act):
    p, _ = JL.init_mlp(jax.random.PRNGKey(0), 64, 96, act, jnp.float32)
    port = _module(L.MLP(64, 96, act, None, torch.float32, "meta"),
                   jax.tree.map(np.asarray, p))
    x = _rand((2, 7, 64), 2)
    _close(L.apply_mlp(port, torch.from_numpy(x), act),
           JL.apply_mlp(p, jnp.asarray(x), act))
    with pytest.raises(ValueError):
        L.apply_mlp(port, torch.from_numpy(x), "tanh")


@pytest.mark.parametrize("hd,theta", [(16, 10000.0), (128, 1e6)])
def test_rope(hd, theta):
    # theta ** x in f32 may differ by an ulp between the two libraries
    np.testing.assert_allclose(L.rope_frequencies(hd, theta).numpy(),
                               np.asarray(JL.rope_frequencies(hd, theta)),
                               rtol=2.0 ** -22, atol=0)
    x = _rand((2, 9, 3, hd), 3)
    pos = np.arange(100, 109)[None, :]
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_embed_and_unembed():
    tok = _rand((128, 32), 4)
    out = _rand((32, 128), 5)
    tokens = np.random.default_rng(6).integers(0, 128, (2, 7))
    emb = _module(L.Embedding(128, 32, None, torch.float32, "meta"),
                  {"tok": tok})
    x = L.embed_tokens(emb, torch.from_numpy(tokens), torch.float32)
    _close(x, JL.embed_tokens({"tok": jnp.asarray(tok)}, jnp.asarray(tokens),
                              jnp.float32), 0)
    _close(L.unembed(torch.from_numpy(out), x),
           JL.unembed(jnp.asarray(out), jnp.asarray(x.numpy())))
    assert L.embed_tokens(emb, torch.from_numpy(tokens),
                          torch.bfloat16).dtype == torch.bfloat16


def test_init_shapes_and_scales():
    """Parameters have the reference's shapes, dense weights its 1/sqrt(fan_in)
    scale, constants are zeros; nothing carries a gradient."""
    cfg = configs.get_config("qwen3-14b", smoke=True)
    carried = _ref_model("qwen3_14b")[2]
    m = T.init_model(cfg, seed=0, device="cpu")
    assert {k: v.shape for k, v in m.state_dict().items()} == \
        {k: v.shape for k, v in carried.state_dict().items()}
    assert not any(p.requires_grad for p in m.parameters())
    wo = m.layers[0].attn.wo
    assert tuple(wo.shape) == (4, 16, 64)
    assert abs(float(wo.std()) - 1 / np.sqrt(4 * 16)) < 0.02
    assert not m.layers[0].attn.q_norm.any() and not m.final_norm.any()


# ---------------------------------------------------------------------------
# attention

def _gqa(cfg, seed=0):
    p, _ = JA.init_gqa(jax.random.PRNGKey(seed), cfg)
    port = _module(A.GQA(cfg, None, "meta"), jax.tree.map(np.asarray, p))
    return p, port


@pytest.mark.parametrize("flag", [False, True])
def test_apply_gqa_with_and_without_flash(flag):
    """The routing of apply_gqa (attention.py:119-121): the flash path at
    S % 128 == 0 with the flag on, the chunked path otherwise."""
    cfg = dataclasses.replace(configs.get_config("qwen3-14b", smoke=True),
                              use_flash_attention=flag)
    jcfg = dataclasses.replace(jconfigs.get_config("qwen3-14b", smoke=True),
                               use_flash_attention=flag)
    p, port = _gqa(cfg)
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return A.flash_gqa(*args, **kw)

    for s in (128, 96):
        x = _rand((2, s, cfg.d_model), 7, 0.5)
        pos = np.arange(s)[None, :]
        want = JA.apply_gqa(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
        got = A.apply_gqa(port, cfg, torch.from_numpy(x),
                          torch.from_numpy(pos), flash=spy)
        _close(got, want)
    assert calls == ([{"causal": True, "bq": 128, "bk": 128}] if flag else [])
    # a window or a softcap keeps the chunked path
    x = torch.from_numpy(_rand((1, 128, cfg.d_model), 8))
    A.apply_gqa(port, cfg, x, torch.arange(128)[None], window=8, flash=spy)
    A.apply_gqa(port, dataclasses.replace(cfg, attn_logit_softcap=30.0), x,
                torch.arange(128)[None], flash=spy)
    assert len(calls) == int(flag)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 5, None), (True, None, 20.0), (False, None, 2.0)])
def test_sdpa_chunked(causal, window, softcap):
    b, s, h, kv, hd = 2, 64, 4, 2, 16
    q, k, v = _rand((b, s, h, hd), 9), _rand((b, s, kv, hd), 10), \
        _rand((b, s, kv, hd), 11)
    for qchunk in (16, 2048):     # scanned blocks, and one block
        want = JA._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, softcap=softcap,
                                qchunk=qchunk)
        got = A._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, softcap=softcap, qchunk=qchunk)
        _close(got, want)
    _close(A.causal_mask(9, 3), JA.causal_mask(9, 3), 0)


def test_gqa_cache_len():
    for max_len in (16, 128, 600):
        for window in (None, 8, 512, 1000):
            assert A.gqa_cache_len(max_len, window) == \
                JA.gqa_cache_len(max_len, window)


def test_decode_gqa_past_the_ring_length():
    """gemma3-smoke's window of 8 keeps a 128-slot ring: 150 steps wrap it,
    and every step's output equals the reference's."""
    cfg = configs.get_config("gemma3-1b", smoke=True)
    jcfg = jconfigs.get_config("gemma3-1b", smoke=True)
    p, port = _gqa(cfg, seed=1)
    steps_n, b = 150, 2
    jcache = JA.init_gqa_cache(jcfg, b, steps_n + 10, jnp.float32, window=8)
    cache = A.init_gqa_cache(cfg, b, steps_n + 10, torch.float32, window=8,
                             device="cpu")
    assert cache["k"].shape == jcache["k"].shape == (b, 128, 1, 32)
    jdecode = jax.jit(JA.decode_gqa, static_argnums=(1,),
                      static_argnames=("window",))
    xs = _rand((steps_n, b, 1, cfg.d_model), 12)
    for pos in range(steps_n):
        want, jcache = jdecode(p, jcfg, jnp.asarray(xs[pos]), jcache,
                               jnp.int32(pos), window=8)
        got, cache = A.decode_gqa(port, cfg, torch.from_numpy(xs[pos]), cache,
                                  pos, window=8)
        _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


# ---------------------------------------------------------------------------
# the model

@pytest.mark.parametrize("arch", SSM + ENCDEC)
def test_new_families_layer_kinds_and_full_parameter_count(arch):
    """SSM, attention and MoE where the reference's layer index puts them
    (jamba's scanned groups: attention at j = 7, MoE at odd j), an encoder
    and cross-attention for seamless, and at full size the reference's
    abstract init's parameter count."""
    cfg = configs.get_config(arch)
    m = T.Model(cfg, None, "meta")
    idx = T.layer_indices(cfg)
    assert [hasattr(lp, "ssm") for lp in m.layers] == \
        [cfg.layer_kind(i) == "ssm" for i in idx]
    assert [hasattr(lp, "attn") for lp in m.layers] == \
        [cfg.layer_kind(i) == "attn" for i in idx]
    assert [hasattr(lp, "moe") for lp in m.layers] == \
        [cfg.layer_is_moe(i) for i in idx]
    assert all(hasattr(lp, "cross") == cfg.is_encdec for lp in m.layers)
    assert len(getattr(m, "encoder", [])) == cfg.enc_layers
    if arch == "jamba_1_5_large_398b":
        assert idx == list(range(8)) * 9
        assert [n for n, lp in enumerate(m.layers[:8]) if hasattr(lp, "attn")] \
            == [7]
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        JT.init_model_abstract(jconfigs.get_config(arch))[0]))
    assert sum(p.numel() for p in m.parameters()) == want
    if arch == "mamba2_130m":
        assert want == 129_690_048
    if arch == "seamless_m4t_large_v2":
        assert want == 2_038_556_672


@pytest.mark.parametrize("arch", DENSE + MOE + SSM + ENCDEC)
def test_forward_and_logits(arch):
    jcfg, jp, port = _ref_model(arch)
    cfg = configs.get_config(arch, smoke=True)
    tokens = np.random.default_rng(13).integers(0, cfg.vocab, (2, 32))
    jkw, kw = _inputs(cfg)
    jh = JT.forward(jp, jcfg, jnp.asarray(tokens), **jkw)
    h = T.forward(port, cfg, torch.from_numpy(tokens), **kw)
    _close(h, jh, MODEL_TOL)
    want = np.asarray(JT.logits_from_hidden(jp, jcfg, jh))
    got = T.logits_from_hidden(port, cfg, h)
    assert got.shape == (2, 32, cfg.padded_vocab)
    _close(got[..., :cfg.vocab], want[..., :cfg.vocab], MODEL_TOL)
    assert (got[..., cfg.vocab:] == -1e30).all()
    assert (want[..., cfg.vocab:] == -1e30).all()


@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma3_1b", "dbrx_132b"])
def test_prefill_step_with_flash(arch):
    """make_prefill_step at S = 128 with the flash flag on: the last
    position's logits, the port's plain flash against the Pallas kernel
    (gemma3's global layers take it, its local ones the chunked path; dbrx's
    layers take it ahead of their routed experts)."""
    jcfg, jp, port = _ref_model(arch)
    jcfg = dataclasses.replace(jcfg, use_flash_attention=True)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              use_flash_attention=True)
    tokens = np.random.default_rng(14).integers(0, cfg.vocab, (1, 128))
    want = jsteps.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(tokens)})
    got = steps.make_prefill_step(cfg)(port, {"tokens": torch.from_numpy(
        tokens)})
    assert got.shape == (1, cfg.padded_vocab)
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], MODEL_TOL)
    # the batch's encoder input reaches the model, which (decoder-only, as
    # in the reference) leaves it unread
    seen = []
    orig = T.forward

    def spy(*args, **kw):
        seen.append(kw)
        return orig(*args, **kw)
    enc = torch.ones(1, 16, cfg.d_model)
    try:
        T.forward = spy
        again = steps.make_prefill_step(cfg)(port, {
            "tokens": torch.from_numpy(tokens), "enc_embeds": enc})
    finally:
        T.forward = orig
    assert seen[0]["enc_embeds"] is enc and "frontend_embeds" not in seen[0]
    assert torch.equal(again, got)


@pytest.mark.parametrize("arch", ENCDEC)
def test_prefill_step_with_model_inputs_and_flash(arch):
    """make_prefill_step at S = 128 with the flash flag on and the batch's
    frontend embeddings (llava) or encoder frames (seamless): the last
    position's logits against the reference's step on the same batch."""
    jcfg, jp, port = _ref_model(arch)
    jcfg = dataclasses.replace(jcfg, use_flash_attention=True)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              use_flash_attention=True)
    tokens = np.random.default_rng(21).integers(0, cfg.vocab, (2, 128))
    jkw, kw = _inputs(cfg, seed=22)
    want = jsteps.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(tokens),
                                               **jkw})
    calls = []
    got = steps.make_prefill_step(cfg, flash=lambda *a, **k: calls.append(k)
                                  or A.flash_gqa(*a, **k))(
        port, {"tokens": torch.from_numpy(tokens), **kw})
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], MODEL_TOL)
    assert len(calls) == cfg.num_layers        # the decoder's self-attention
    without = steps.make_prefill_step(cfg)(port, {
        "tokens": torch.from_numpy(tokens),
        **{k: v for k, v in kw.items() if k != "frontend_embeds"}})
    if cfg.frontend == "vision":
        assert float((without - got)[:, :cfg.vocab].abs().max()) > 1e-3
    if cfg.is_encdec:
        with pytest.raises(ValueError, match="enc_embeds"):
            steps.make_prefill_step(cfg)(port, {"tokens": torch.from_numpy(
                tokens)})


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_prefill_step_equals_reference(arch):
    """make_prefill_step on every smoke config, with its model inputs: the
    last position's logits against the reference's step."""
    jcfg, jp, port = _ref_model(arch)
    cfg = configs.get_config(arch, smoke=True)
    tokens = np.random.default_rng(23).integers(0, cfg.vocab, (2, 32))
    jkw, kw = _inputs(cfg, seed=24)
    want = jsteps.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(tokens),
                                               **jkw})
    got = steps.make_prefill_step(cfg)(port, {
        "tokens": torch.from_numpy(tokens), **kw})
    assert got.shape == (2, cfg.padded_vocab)
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], MODEL_TOL)


def _unstack_cache(cfg, cache):
    """The reference's cache as one dict per layer, in layer order."""
    _, n_groups, _ = JT._regions(cfg)
    out = list(cache["prefix"])
    if cache["stack"] is not None:
        out += [{k: v[g] for k, v in c.items()} for g in range(n_groups)
                for c in cache["stack"]]
    return out + list(cache["remainder"])


@pytest.mark.parametrize("arch", DENSE + MOE + SSM + ENCDEC)
def test_init_cache_and_decode_step(arch):
    """Each step's logits and every layer's cache after it (an SSM layer's
    window and state are rewritten each step) against the reference's;
    seamless's steps cross-attend to the same encoder output."""
    jcfg, jp, port = _ref_model(arch)
    cfg = configs.get_config(arch, smoke=True)
    b, max_len, n = 2, 12, 10
    jcache = JT.init_cache(jcfg, b, max_len, jnp.float32)
    cache = T.init_cache(cfg, b, max_len, torch.float32, device="cpu")
    ref_layers = _unstack_cache(jcfg, jcache)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in cache] == \
        [{k: v.shape for k, v in c.items()} for c in ref_layers]
    assert all(not v.any() for c in cache for v in c.values())
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    step = steps.make_serve_step(cfg)
    tokens = np.random.default_rng(15).integers(0, cfg.vocab, (b, n))
    enc = (_rand((b, 16, cfg.d_model), 16, 0.5) if cfg.is_encdec else None)
    jenc = None if enc is None else jnp.asarray(enc)
    tenc = None if enc is None else torch.from_numpy(enc)
    for pos in range(n):
        want, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, pos:pos + 1]),
                             jnp.int32(pos), jenc)
        got, cache = step(port, cache, torch.from_numpy(
            tokens[:, pos:pos + 1]), pos, tenc)
        assert got.shape == (b, 1, cfg.padded_vocab)
        _close(got[..., :cfg.vocab], np.asarray(want)[..., :cfg.vocab],
               MODEL_TOL)
        for c, rc in zip(cache, _unstack_cache(jcfg, jcache)):
            for key in c:
                _close(c[key], rc[key], MODEL_TOL)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_greedy_tokens_equal_reference_generate(arch):
    """The reference's generate and the port's decode loop, given the same
    parameters and prompts, pick the same greedy tokens."""
    seed, batch, prompt_len, gen_len = 0, 2, 8, 8
    want, _ = jserve.generate(arch, smoke=True, batch=batch,
                              prompt_len=prompt_len, gen_len=gen_len,
                              seed=seed)
    jcfg, _, port = _ref_model(arch, seed)
    prompts = jax.random.randint(jax.random.PRNGKey(seed + 1),
                                 (batch, prompt_len), 0, jcfg.vocab)
    got, tput, prompt_logits = serve.decode_tokens(
        port, configs.get_config(arch, smoke=True),
        torch.from_numpy(np.array(prompts)), gen_len)
    assert got.shape == (batch, gen_len) and tput > 0
    np.testing.assert_array_equal(got, np.asarray(want))
    assert prompt_logits.shape == (batch, 1, jcfg.padded_vocab)


def test_generate_from_a_seed():
    tokens, tput = serve.generate("gemma3-1b", batch=2, prompt_len=4,
                                  gen_len=3, device="cpu")
    assert tokens.shape == (2, 3) and tput > 0
    again, _ = serve.generate("gemma3-1b", batch=2, prompt_len=4, gen_len=3,
                              device="cpu")
    np.testing.assert_array_equal(tokens, again)


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2"])
def test_decode_tokens_with_enc_out(arch):
    """decode_tokens with the encoder's output: the greedy tokens of the
    reference's serve step fed the same ``enc_out`` each step, and other
    tokens than without it."""
    jcfg, jp, port = _ref_model(arch)
    cfg = configs.get_config(arch, smoke=True)
    b, prompt_len, gen_len = 2, 6, 6
    prompts = np.random.default_rng(17).integers(0, cfg.vocab,
                                                 (b, prompt_len))
    frames = _rand((b, 16, cfg.d_model), 18, 0.5)
    jenc = JT._apply_encoder(jp, jcfg, jnp.asarray(frames))
    enc = T.apply_encoder(port, cfg, torch.from_numpy(frames))
    _close(enc, jenc, MODEL_TOL)
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    jcache = JT.init_cache(jcfg, b, prompt_len + gen_len, jnp.float32)
    for pos in range(prompt_len):
        logits, jcache = jstep(jp, jcache, jnp.asarray(prompts[:, pos:pos + 1]),
                               jnp.int32(pos), jenc)
    tok = jnp.argmax(logits[..., :cfg.vocab], axis=-1).astype(jnp.int32)
    want = [tok]
    for pos in range(prompt_len, prompt_len + gen_len - 1):
        logits, jcache = jstep(jp, jcache, tok, jnp.int32(pos), jenc)
        tok = jnp.argmax(logits[..., :cfg.vocab], axis=-1).astype(jnp.int32)
        want.append(tok)
    got, _, _ = serve.decode_tokens(port, cfg, torch.from_numpy(prompts),
                                    gen_len, enc_out=enc)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
    plain, _, _ = serve.decode_tokens(port, cfg, torch.from_numpy(prompts),
                                      gen_len)
    assert (plain != got).any()


@pytest.mark.parametrize("entry", ["loss_fn", "make_train_step"])
def test_training_entry_points(entry):
    """Training is ported (``tests/test_torch_train.py`` holds it against
    the reference): ``loss_fn`` equals the reference's and builds a graph;
    a train step moves every parameter and returns finite metrics."""
    cfg, jparams, port = _ref_model("qwen3_14b")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    port.requires_grad_(True)
    if entry == "loss_fn":
        got = steps.loss_fn(port, cfg, tb)
        want = jsteps.loss_fn(jparams, cfg, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        assert got.grad_fn is not None
        _close(got, want)
    else:
        from repro_torch.optim import adamw_init
        before = {k: v.detach().clone() for k, v in port.state_dict().items()}
        _, opt, metrics = steps.make_train_step(cfg, lr=1e-3)(
            port, adamw_init(port), tb)
        assert int(opt.step) == 1
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert float(metrics["grad_norm"]) > 0
        assert all(not torch.equal(v, before[k])
                   for k, v in port.state_dict().items())


def test_cpu_path_launches_no_kernel():
    cfg = dataclasses.replace(configs.get_config("qwen3-14b", smoke=True),
                              use_flash_attention=True)
    m = T.init_model(cfg, device="cpu")
    ops.reset_counts()
    logits = steps.make_prefill_step(cfg)(m, {"tokens": torch.zeros(
        1, 128, dtype=torch.int64)})
    assert torch.isfinite(logits[:, :cfg.vocab]).all()
    assert set(ops.launch_counts().values()) == {0}


def test_import_leaves_jax_and_repro_out():
    """Every module of the port imports with jax and repro made unimportable
    (``sys.modules[name] = None`` makes an import of them fail)."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert {"repro_torch.models.transformer", "repro_torch.models.ssm",
            "repro_torch.launch.serve",
            "repro_torch.kernels.flash_attention"} <= set(names)
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= len(names)
