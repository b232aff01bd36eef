"""The port's Mamba-2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``).

Both packages get the same values: the reference's parameters
(``init_ssm``) carried across as numpy arrays, and inputs made with numpy
from a seed, on the mamba2 and jamba smoke configs in f32.  The tolerance
is 1e-5 (``FN_TOL``): f32 products taken in other orders (the port splits
the reference's four-operand einsums into products of two).  The chunked
scan is also held against the port's own step-by-step recurrence, as the
reference's ``test_ssd_chunked_equals_recurrence`` holds its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import ssm as JS
from repro.models.layers import ABSTRACT_INIT

from repro_torch import configs
from repro_torch.models import ssm as S

ARCHS = ["mamba2_130m", "jamba_1_5_large_398b"]
FN_TOL = 1e-5


def _ssm(arch="mamba2_130m", seed=0, **changes):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               **changes)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **changes)
    p, _ = JS.init_ssm(jax.random.PRNGKey(seed), jcfg)
    port = S.SSM(cfg, None, "meta")
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in p.items()}, strict=True, assign=True)
    return jcfg, cfg, p, port


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_shapes_and_init(arch):
    """The reference's shapes at published widths; dense weights at the
    reference's 1/sqrt(fan_in), ``a_log`` 0 and ``d_skip`` 1."""
    tok = ABSTRACT_INIT.set(True)
    try:
        p, _ = JS.init_ssm(None, jconfigs.get_config(arch))
    finally:
        ABSTRACT_INIT.reset(tok)
    port = S.SSM(configs.get_config(arch), None, "meta")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    cfg = configs.get_config(arch, smoke=True)
    m = S.init_ssm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(v.requires_grad for v in m.parameters())
    assert (m.a_log == 0).all() and (m.d_skip == 1).all()
    assert not m.dt_bias.any() and not m.conv_b.any() and not m.out_norm.any()
    assert abs(float(m.in_proj.std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(m.conv_w.std()) - cfg.ssm_conv_kernel ** -0.5) < 0.05


def test_softplus_equals_jax():
    """``jax.nn.softplus`` is logaddexp(x, 0); the port computes the same
    terms, past torch's threshold of 20 and far below zero too (down to
    -80, where e^x is still a normal f32)."""
    x = np.concatenate([np.linspace(-80, 120, 4001, dtype=np.float32),
                        _rand((2000,), 0, 8.0),
                        np.float32([0.0, 19.99, 20.0, 20.01, 88.0, -80.0])])
    got = S.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=0)
    assert (got > 0).all() and np.isfinite(got).all()


@pytest.mark.parametrize("k", [2, 4])
def test_causal_conv(k):
    xbc, w, b = _rand((2, 19, 24), 1), _rand((k, 24), 2, 0.5), \
        _rand((24,), 3, 0.1)
    want = JS._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    got = S._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                         torch.from_numpy(b))
    _close(got, want)
    # causal: the first output row sees only the first input row
    first = S._causal_conv(torch.from_numpy(xbc[:, :1]), torch.from_numpy(w),
                           torch.from_numpy(b))
    _close(got[:, :1], first)


def test_segsum():
    x = _rand((2, 3, 9), 4)
    want = np.asarray(JS._segsum(jnp.asarray(x)))
    got = S._segsum(torch.from_numpy(x)).numpy()
    upper = np.triu(np.ones((9, 9), bool), 1)
    assert np.isneginf(got[..., upper]).all()
    assert np.isneginf(want[..., upper]).all()
    _close(got[..., ~upper], want[..., ~upper])


def _ssd_inputs(bsz, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bmat = rng.standard_normal((bsz, s, n)).astype(np.float32) * 0.5
    cmat = rng.standard_normal((bsz, s, n)).astype(np.float32) * 0.5
    return xh, dt, a, bmat, cmat


def _recurrence(xh, dt, a, bmat, cmat):
    """h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, one step
    at a time in f64."""
    xh, dt, a, bmat, cmat = (torch.from_numpy(v).double()
                             for v in (xh, dt, a, bmat, cmat))
    bsz, s, h, p = xh.shape
    state = torch.zeros(bsz, h, p, bmat.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                     # [B,H]
        state = state * decay[..., None, None] + (
            dt[:, t, :, None, None] * xh[:, t, :, :, None]
            * bmat[:, t, None, None, :])
        ys.append(state @ cmat[:, t, None, :, None])
    return torch.stack(ys, 1)[..., 0]


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_ssd_chunked(chunks):
    """C = 1, 2 and 4 chunks of 8: the reference's scan, and the
    recurrence (the inter-chunk term carries the state across chunks)."""
    q = 8
    xh, dt, a, bmat, cmat = _ssd_inputs(2, chunks * q, 3, 4, 5, 5 + chunks)
    want = JS.ssd_chunked(*(jnp.asarray(v) for v in (xh, dt, a, bmat, cmat)),
                          q)
    got = S.ssd_chunked(*(torch.from_numpy(v) for v in (xh, dt, a, bmat,
                                                         cmat)), q)
    assert got.shape == (2, chunks * q, 3, 4) and got.dtype == torch.float32
    _close(got, want)
    _close(got, _recurrence(xh, dt, a, bmat, cmat))


class _Sizes(TorchDispatchMode):
    """Records every tensor an op returns: its element count and storage."""

    def __init__(self):
        super().__init__()
        self.out = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = func(*args, **(kwargs or {}))
        for t in (res if isinstance(res, (tuple, list)) else (res,)):
            if isinstance(t, torch.Tensor):
                self.out.append((t.numel(), t.untyped_storage().data_ptr()))
        return res


def test_ssd_chunked_intermediates_within_the_decay_matrix():
    """At jamba's proportions (N = Q / 2, P = Q / 4, many heads) no tensor
    the scan makes holds more than the [B, C, H, Q, Q] decay matrix, and one
    storage of that size is allocated (built in place).  The reference's
    four-operand einsum taken left to right would hold [B, C, Q, Q, H, P]."""
    bsz, c, h, q, p, n = 2, 2, 16, 16, 4, 8
    args = [torch.from_numpy(v) for v in _ssd_inputs(bsz, c * q, h, p, n, 9)]
    with _Sizes() as rec:
        S.ssd_chunked(*args, q)
    decay = bsz * c * h * q * q
    assert max(size for size, _ in rec.out) <= decay
    assert len({ptr for size, ptr in rec.out if size == decay}) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_ssm(arch):
    jcfg, cfg, p, port = _ssm(arch)
    x = _rand((2, 2 * cfg.ssm_chunk, cfg.d_model), 10, 0.5)
    want = JS.apply_ssm(p, jcfg, jnp.asarray(x))
    got = S.apply_ssm(port, cfg, torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got, want)


def test_apply_ssm_in_bf16():
    """Activations in bf16: the projections and the conv in bf16, the scan
    in f32, as the reference casts them; outputs within bf16's reach."""
    jcfg, cfg, p, port = _ssm()
    x = _rand((1, 2 * cfg.ssm_chunk, cfg.d_model), 11, 0.5)
    want = JS.apply_ssm(p, jcfg, jnp.asarray(x, jnp.bfloat16))
    got = S.apply_ssm(port, cfg, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 0.05)


def test_ragged_length_raises():
    """A prefill whose length is not a multiple of the chunk (the reference
    asserts)."""
    _, cfg, _, port = _ssm()
    x = torch.from_numpy(_rand((1, cfg.ssm_chunk + 3, cfg.d_model), 12))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        S.apply_ssm(port, cfg, x)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        S.ssd_chunked(*(torch.from_numpy(v)
                        for v in _ssd_inputs(1, 12, 2, 4, 4, 13)), 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_ssm_step_by_step(arch):
    """Each step's output and the whole cache after it, against the
    reference's; the steps together against the port's own prefill."""
    jcfg, cfg, p, port = _ssm(arch, seed=1)
    b, n = 2, 2 * cfg.ssm_chunk
    jcache = JS.init_ssm_cache(jcfg, b, jnp.float32)
    cache = S.init_ssm_cache(cfg, b, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    assert cache["state"].dtype == torch.float32
    xs = _rand((b, n, cfg.d_model), 14, 0.5)
    outs = []
    for t in range(n):
        want, jcache = JS.decode_ssm(p, jcfg, jnp.asarray(xs[:, t:t + 1]),
                                     jcache)
        got, again = S.decode_ssm(port, cfg, torch.from_numpy(xs[:, t:t + 1]),
                                  cache)
        assert again is cache          # written in place
        _close(got, want)
        _close(cache["conv"], jcache["conv"])
        _close(cache["state"], jcache["state"])
        outs.append(got)
    prefill = S.apply_ssm(port, cfg, torch.from_numpy(xs))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), prefill.numpy(),
                               atol=2e-4, rtol=1e-3)


def test_bf16_replay_divergence_is_the_references():
    """In bf16 a prompt's prefill and its decode replay part (the chunked
    scan and the recurrence round dt, B, C and x in other places, and the
    state carries each difference on), in the reference as in the port:
    at mamba2's widths, two layers and four chunks of 64, the port's
    prefill-vs-replay difference is within 1.5 times the reference's own
    (read: 0.021 against 0.026), and both are f32 roundoff with f32
    activations.  (On the card, at 24 layers, this is why chip_smoke.py
    holds the SSM replays in f32.)"""
    from repro.launch import steps as jsteps
    from repro.models import transformer as JT

    from repro_torch.convert import params_from_reference
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    s = 256
    tokens = np.random.default_rng(15).integers(0, 4096, (1, s))
    got = {}
    for dtype in ("bfloat16", "float32"):
        small = dict(num_layers=2, vocab=4096, ssm_chunk=64, dtype=dtype)
        jcfg = dataclasses.replace(jconfigs.get_config("mamba2_130m"),
                                   **small)
        cfg = dataclasses.replace(configs.get_config("mamba2_130m"), **small)
        jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
        port = params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
        jstep = jax.jit(jsteps.make_serve_step(jcfg))
        jcache = JT.init_cache(jcfg, 1, s, jnp.dtype(dtype))
        step = steps.make_serve_step(cfg)
        cache = T.init_cache(cfg, 1, s, getattr(torch, dtype), device="cpu")
        jrep, rep = [], []
        for pos in range(s):
            tok = tokens[:, pos:pos + 1]
            lg, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
            jrep.append(np.asarray(lg, np.float32))
            lg, cache = step(port, cache, torch.from_numpy(tok), pos)
            rep.append(lg.float().numpy())
        jpre = np.asarray(JT.logits_from_hidden(jp, jcfg, JT.forward(
            jp, jcfg, jnp.asarray(tokens))), np.float32)
        pre = T.logits_from_hidden(port, cfg, T.forward(
            port, cfg, torch.from_numpy(tokens))).float().numpy()

        def rel(a, b):
            return float(np.abs(a - b).max() / np.abs(b).max())
        got[dtype] = (rel(pre, np.concatenate(rep, 1)),
                      rel(jpre, np.concatenate(jrep, 1)))
    port_bf16, ref_bf16 = got["bfloat16"]
    print(f"prefill vs replay, max|diff| / max|logit| (port, reference): "
          f"{got}")
    assert 0 < port_bf16 <= 1.5 * ref_bf16, got
    assert max(got["float32"]) < 1e-4, got
