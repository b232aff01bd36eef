"""The port's encoder-decoder and frontend paths against the JAX package's:
cross-attention, the encoder's bidirectional attention, the encoder,
``forward`` with frontend embeddings and encoder frames, and decode steps
that cross-attend to the encoder's output.

Both packages get the same values: the reference's parameters carried
across as numpy arrays, and inputs made with numpy from a seed, on the
seamless and llava smoke configs in f32.  Model inputs have the shapes of
the reference's ``tests/test_models.py`` (8 frontend positions, 16 encoder
frames).  Tolerances: 1e-5 for single functions, 1e-4 for whole models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.layers import ABSTRACT_INIT

from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.launch import steps
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

SEAMLESS = "seamless_m4t_large_v2"
LLAVA = "llava_next_34b"
FN_TOL = 1e-5
MODEL_TOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


def _load(module, tree):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in tree.items()}, strict=True,
                           assign=True)
    return module


def _cfgs(arch=SEAMLESS, **changes):
    return (dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                                **changes),
            dataclasses.replace(configs.get_config(arch, smoke=True),
                                **changes))


def _ref_model(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    params, _ = JT.init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, params, params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def test_cross_parameter_shapes():
    tok = ABSTRACT_INIT.set(True)
    try:
        p, _ = JA.init_cross(None, jconfigs.get_config(SEAMLESS))
    finally:
        ABSTRACT_INIT.reset(tok)
    port = A.init_cross(configs.get_config(SEAMLESS), None, "meta")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_cross_kv_and_apply_cross(kv_heads):
    """Decoder queries over every encoder position, at the config's heads
    and with grouped KV heads; a decode-sized query row too."""
    jcfg, cfg = _cfgs(num_kv_heads=kv_heads)
    p, _ = JA.init_cross(jax.random.PRNGKey(1), jcfg)
    port = _load(A.init_cross(cfg, None, "meta"), p)
    enc = _rand((2, 16, cfg.d_model), 2, 0.5)
    jkv = JA.cross_kv(p, jnp.asarray(enc))
    kv = A.cross_kv(port, torch.from_numpy(enc))
    assert kv[0].shape == (2, 16, kv_heads, cfg.head_dim)
    _close(kv[0], jkv[0])
    _close(kv[1], jkv[1])
    for s in (24, 1):
        x = _rand((2, s, cfg.d_model), 3 + s, 0.5)
        want = JA.apply_cross(p, jcfg, jnp.asarray(x), jkv)
        got = A.apply_cross(port, cfg, torch.from_numpy(x), kv)
        assert got.shape == x.shape
        _close(got, want)


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_apply_bidir(softcap):
    """The encoder's attention: every position sees every other (a later
    key changes an earlier query's output), with and without a softcap."""
    jcfg, cfg = _cfgs(attn_logit_softcap=softcap)
    p, _ = JA.init_gqa(jax.random.PRNGKey(4), jcfg)
    port = _load(A.GQA(cfg, None, "meta"), p)
    x = _rand((2, 20, cfg.d_model), 5, 0.5)
    pos = np.arange(20)[None, :]
    want = JA.apply_bidir(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = A.apply_bidir(port, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want)
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = A.apply_bidir(port, cfg, torch.from_numpy(x2),
                          torch.from_numpy(pos))
    assert float((moved - got)[:, 0].abs().max()) > 1e-4


def test_encoder():
    jcfg, cfg, jp, port = _ref_model(SEAMLESS)
    assert len(port.encoder) == cfg.enc_layers
    frames = _rand((2, 16, cfg.d_model), 6, 0.5)
    want = JT._apply_encoder(jp, jcfg, jnp.asarray(frames))
    got = T.apply_encoder(port, cfg, torch.from_numpy(frames))
    assert got.shape == frames.shape
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_forward_with_model_inputs(arch):
    """``forward`` with the frontend's 8 embeddings over the leading token
    positions and, for seamless, 16 encoder frames; the frontend positions'
    tokens are not read."""
    jcfg, cfg, jp, port = _ref_model(arch)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 32))
    front = _rand((2, 8, cfg.d_model), 8, 0.5)
    kw = {"frontend_embeds": front}
    if cfg.is_encdec:
        kw["enc_embeds"] = _rand((2, 16, cfg.d_model), 9, 0.5)
    want = JT.forward(jp, jcfg, jnp.asarray(tokens),
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = T.forward(port, cfg, torch.from_numpy(tokens), **tkw)
    _close(got, want, MODEL_TOL)
    other = tokens.copy()
    other[:, :8] = (other[:, :8] + 1) % cfg.vocab
    assert torch.equal(T.forward(port, cfg, torch.from_numpy(other), **tkw),
                       got)


def test_decode_step_with_enc_out():
    """Decode steps that cross-attend to the encoder's output: logits and
    caches against the reference's serve step with the same ``enc_out``;
    without it the logits differ (the cross-attention is skipped, as in the
    reference)."""
    jcfg, cfg, jp, port = _ref_model(SEAMLESS, seed=1)
    b, n = 2, 8
    frames = _rand((b, 16, cfg.d_model), 10, 0.5)
    jenc = JT._apply_encoder(jp, jcfg, jnp.asarray(frames))
    enc = T.apply_encoder(port, cfg, torch.from_numpy(frames))
    jcache = JT.init_cache(jcfg, b, n, jnp.float32)
    cache = T.init_cache(cfg, b, n, torch.float32, device="cpu")
    bare = T.init_cache(cfg, b, n, torch.float32, device="cpu")
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    step = steps.make_serve_step(cfg)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (b, n))
    for pos in range(n):
        tok = tokens[:, pos:pos + 1]
        want, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.int32(pos),
                             jenc)
        got, cache = step(port, cache, torch.from_numpy(tok), pos, enc)
        _close(got[..., :cfg.vocab], np.asarray(want)[..., :cfg.vocab],
               MODEL_TOL)
        plain, bare = step(port, bare, torch.from_numpy(tok), pos)
        assert float((plain - got)[..., :cfg.vocab].abs().max()) > 1e-3
    # scan_group 1: the reference stacks every layer's cache on one axis
    for key in ("k", "v"):
        _close(torch.stack([c[key] for c in cache]),
               jcache["stack"][0][key], MODEL_TOL)
