"""The port's MLA attention against the JAX package's
(``repro.models.attention``, DeepSeek-V2's multi-head latent attention).

Both packages get the same values: the reference's parameters
(``init_mla``) carried across as numpy arrays, and inputs made with numpy
from a seed, on the deepseek smoke config in f32.  The tolerance is 1e-5
(``FN_TOL``): f32 products taken in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models.layers import ABSTRACT_INIT

from repro_torch import configs
from repro_torch.models import attention as A

ARCH = "deepseek_v2_lite_16b"
FN_TOL = 1e-5


def _mla(seed=0, **changes):
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                               **changes)
    cfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), **changes)
    p, _ = JA.init_mla(jax.random.PRNGKey(seed), jcfg)
    port = A.MLA(cfg, None, "meta")
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in p.items()}, strict=True, assign=True)
    return jcfg, cfg, p, port


def _x(cfg, seed, b=2, s=64):
    return (np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
            * 0.5).astype(np.float32)


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


def test_parameter_shapes_and_scales():
    cfg = configs.get_config(ARCH)
    tok = ABSTRACT_INIT.set(True)
    try:
        p, _ = JA.init_mla(None, jconfigs.get_config(ARCH))
    finally:
        ABSTRACT_INIT.reset(tok)
    port = A.MLA(cfg, None, "meta")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    small = configs.get_config(ARCH, smoke=True)
    m = A.MLA(small, torch.Generator().manual_seed(0), "cpu")
    h, vd = small.num_heads, small.v_head_dim
    assert abs(float(m.wo.std()) - 1 / np.sqrt(h * vd)) < 0.01
    assert abs(float(m.wk_up.std()) - 1 / np.sqrt(small.kv_lora_rank)) < 0.02
    assert not m.kv_norm.any()


def test_mla_qc():
    jcfg, cfg, p, port = _mla(seed=1)
    x = _x(cfg, 2)
    pos = np.arange(100, 164)[None, :]
    want = JA._mla_qc(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = A._mla_qc(port, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("qchunk", [16, 1 << 30])
@pytest.mark.parametrize("s", [64, 40])
def test_apply_mla_matches_reference(s, qchunk):
    """Over query blocks of 16 rows and in one block (S = 40 is not a
    multiple of 16, so it takes one block either way)."""
    jcfg, cfg, p, port = _mla()
    x = _x(cfg, 3, s=s)
    pos = np.arange(s)[None, :]
    want = JA.apply_mla(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                        qchunk=qchunk)
    got = A.apply_mla(port, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                      qchunk=qchunk)
    assert got.shape == (2, s, cfg.d_model)
    _close(got, want)


def test_apply_mla_chunked_equals_whole():
    """The query-block loop changes no value beyond f32 reordering."""
    _, cfg, _, port = _mla(seed=4)
    x = torch.from_numpy(_x(cfg, 5))
    pos = torch.arange(64)[None, :]
    _close(A.apply_mla(port, cfg, x, pos, qchunk=16),
           A.apply_mla(port, cfg, x, pos, qchunk=1 << 30))


def test_apply_mla_is_causal():
    """A change to the last token moves no earlier output."""
    _, cfg, _, port = _mla(seed=6)
    x = _x(cfg, 7, b=1, s=32)
    y = x.copy()
    y[:, -1] += 1.0
    pos = torch.arange(32)[None, :]
    a = A.apply_mla(port, cfg, torch.from_numpy(x), pos, qchunk=8)
    b = A.apply_mla(port, cfg, torch.from_numpy(y), pos, qchunk=8)
    assert torch.equal(a[:, :-1], b[:, :-1])
    assert not torch.equal(a[:, -1], b[:, -1])


def test_decode_mla_matches_reference_and_prefill():
    """Step by step against the reference's decode, the caches equal after
    every step, and the last step's output against the whole sequence's
    last position."""
    jcfg, cfg, p, port = _mla(seed=8)
    b, n, max_len = 2, 12, 16
    jcache = JA.init_mla_cache(jcfg, b, max_len, jnp.float32)
    cache = A.init_mla_cache(cfg, b, max_len, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()} == \
        {"c_kv": (b, max_len, cfg.kv_lora_rank),
         "k_rope": (b, max_len, cfg.qk_rope_dim)}
    assert not any(v.any() for v in cache.values())
    jdecode = jax.jit(JA.decode_mla, static_argnums=(1,))
    xs = _x(cfg, 9, s=n)
    for pos in range(n):
        xp = xs[:, pos:pos + 1]
        want, jcache = jdecode(p, jcfg, jnp.asarray(xp), jcache,
                               jnp.int32(pos))
        got, cache = A.decode_mla(port, cfg, torch.from_numpy(xp), cache, pos)
        _close(got, want)
        for key in cache:
            _close(cache[key], jcache[key])
    assert not cache["c_kv"][:, n:].any()
    whole = A.apply_mla(port, cfg, torch.from_numpy(xs),
                        torch.arange(n)[None, :])
    _close(got[:, 0], whole[:, -1])
