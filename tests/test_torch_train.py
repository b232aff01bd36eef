"""The port's training path (``launch/steps.py``'s ``loss_fn`` and
``make_train_step``, remat, the serving steps' lack of a graph, flash under
grad) against the JAX package's, for every arch at smoke size in f32.

Both packages get the same values: the reference's parameters carried
across (``convert.params_from_reference``) and a batch made with numpy
from a seed.  Each tolerance is stated beside its check, and each check is
held against a control that must fail it.
"""
import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import flash_attention as JF
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim.adamw import adamw_init as j_adamw_init

from repro_torch import configs
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.kernels import flash_attention as F
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as T
from repro_torch.optim import Q8, adamw_init

ARCHS = configs.ARCHS
# The loss, relative: two f32 log-softmaxes over the vocab and means over
# the tokens in other orders (readings ~1e-7).
LOSS_TOL = 1e-5
# Each parameter's gradient at its own scale, max|got - want| <= GRAD_TOL
# max|want|: the two packages' f32 products and sums in other orders, over
# a few layers (readings up to 2.2e-5, jamba's conv weight).  A parameter
# the port gives no gradient reads 1 where the reference's is nonzero.
GRAD_TOL = 1e-4
# After two AdamW steps at LR, the parameters within STEP_TOL x LR of each
# other where the first gradient is at least STEP_G_FLOOR of its
# parameter's largest, and within STEP_ANY x LR everywhere.  The first step
# moves each entry by LR g / (|g| + eps), about LR where |g| >> eps: the
# two packages' roundings of g move it by little (readings to 0.051 LR,
# deepseek, where a MoE layer's second-step routing can part), but where
# |g| is within the gradient bound of 0 they can part by up to 2 LR over
# two steps.  With Q8 moments one int8 step of a small moment moves its
# update by a large share (readings to 0.18 LR, dbrx's experts), hence
# STEP_Q8_TOL.  The control, the parameters before the steps, reads about
# 2 LR (two steps of about LR each).
# The moments after two steps, each within MOMENT_TOL of its own largest
# entry (readings to 1.03e-4, deepseek's router, whose second-step gradient
# follows the routing after the first step).
MOMENT_TOL = 1e-3
LR = 1e-3
STEP_TOL = 0.2
STEP_Q8_TOL = 0.6
STEP_G_FLOOR = 1e-3
STEP_ANY = 2.5
BATCH, SEQ = 2, 16


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _batch(cfg, seed=7):
    """Tokens, next-token labels, and a frontend's embeddings or an
    encoder's frames where the arch takes them (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend:
        b["frontend_embeds"] = (rng.standard_normal(
            (BATCH, 8, cfg.d_model)) * 0.5).astype(np.float32)
    if cfg.is_encdec:
        b["enc_embeds"] = (rng.standard_normal(
            (BATCH, 16, cfg.d_model)) * 0.5).astype(np.float32)
    return b


def _port_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


class Ref(NamedTuple):
    cfg: object          # the reference's config
    params: dict         # its initial parameters
    batch: dict          # numpy
    loss: float          # loss_fn at the initial parameters
    grads: dict          # jax.grad's there, by the port's names
    metrics: list        # the train step's {"loss", "grad_norm"}, 2 steps
    after: tuple         # (parameters, OptState) after the 2 steps


def _ref_steps(jcfg, params, b, *, accum_steps=1, quantized=False,
               with_grad=False):
    """Two of the reference's jitted train steps from ``params`` (and with
    ``with_grad``, ``jax.value_and_grad(loss_fn)`` at ``params`` from the
    same compiled function)."""
    step = jsteps.make_train_step(jcfg, lr=LR, accum_steps=accum_steps,
                                  quantized_opt=quantized)

    def run(p, o, bb):
        vg = (jax.value_and_grad(lambda q: jsteps.loss_fn(q, jcfg, bb))(p)
              if with_grad else None)
        return vg, step(p, o, bb)

    run = jax.jit(run)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    vg, (p, o, m1) = run(params, j_adamw_init(params, quantize=quantized), jb)
    _, (p, o, m2) = run(p, o, jb)
    metrics = [{k: float(v) for k, v in m.items()} for m in (m1, m2)]
    return vg, metrics, jax.tree.map(np.asarray, (p, o))


@functools.lru_cache(maxsize=None)
def _reference(arch) -> Ref:
    """The reference's values on ``arch``'s smoke config, from one
    compiled function: the loss and ``jax.grad`` at the initial parameters,
    and two train steps with f32 moments."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    params, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    b = _batch(jcfg)
    (loss, grads), metrics, after = _ref_steps(jcfg, params, b,
                                               with_grad=True)
    want = params_from_reference(jax.tree.map(np.asarray, grads),
                                 configs.get_config(arch, smoke=True),
                                 device="cpu").state_dict()
    return Ref(jcfg, params, b, float(loss), want, metrics, after)


def _port(arch, params):
    cfg = configs.get_config(arch, smoke=True)
    return cfg, params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                      device="cpu").requires_grad_(True)


def _port_grads(model, cfg, batch):
    loss = steps.loss_fn(model, cfg, batch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, dict(zip(names, grads))


def _grad_ratios(got: dict, want: dict) -> dict:
    """max|got - want| / max|want| per parameter (the difference itself
    where the reference's gradient is all zero)."""
    out = {}
    for name, w in want.items():
        w = _np(w)
        scale = np.abs(w).max()
        d = np.abs(_np(got[name]) - w).max()
        out[name] = d / scale if scale > 0 else d
    return out


def _mixer(name: str) -> bool:
    """A parameter of layer 0's token mixer (attention or SSM)."""
    return name.startswith(("layers.0.attn.", "layers.0.ssm."))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    ref = _reference(arch)
    b, want = ref.batch, ref.loss
    cfg, model = _port(arch, ref.params)
    got = steps.loss_fn(model, cfg, _port_batch(b)).item()
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
    # control: the labels one position off must fail
    bad = dict(_port_batch(b), labels=torch.roll(
        torch.from_numpy(b["labels"]).long(), 1, dims=1))
    assert abs(steps.loss_fn(model, cfg, bad).item() - want) \
        > LOSS_TOL * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """Every parameter's gradient against ``jax.grad``'s at its own scale;
    a parameter with no gradient (an encoder under ``no_grad``, a backward
    that cannot run) fails where the reference's is nonzero.  Control:
    layer 0's token-mixer gradients zeroed must fail."""
    ref = _reference(arch)
    want = ref.grads
    cfg, model = _port(arch, ref.params)
    _, got = _port_grads(model, cfg, _port_batch(ref.batch))
    assert set(got) == set(want)
    ratios = _grad_ratios(got, want)
    bad = {k: r for k, r in ratios.items() if r > GRAD_TOL}
    assert not bad, bad
    control = {k: torch.zeros_like(g) if _mixer(k) else g
               for k, g in got.items()}
    failed = [k for k, r in _grad_ratios(control, want).items()
              if r > GRAD_TOL]
    assert failed and all(_mixer(k) for k in failed)


def test_encoder_gets_gradients():
    """seamless's encoder and its final norm get gradients (they got none
    when ``forward`` and ``apply_encoder`` ran under ``no_grad``)."""
    ref = _reference("seamless_m4t_large_v2")
    want = ref.grads
    cfg, model = _port("seamless_m4t_large_v2", ref.params)
    _, got = _port_grads(model, cfg, _port_batch(ref.batch))
    enc = [k for k in got if k.startswith(("encoder.", "enc_final_norm"))]
    assert len(enc) == 19      # two layers of 9, and the final norm
    for k in enc:
        assert np.abs(_np(want[k])).max() > 0, k
        assert _np(got[k]).any(), k


def _step_readings(arch, accum_steps, quantized):
    """Two train steps in each package from the same parameters: the
    reference's and the port's metrics of each step, and the parameters
    and OptState after, by the port's names."""
    ref = _reference(arch)
    if accum_steps == 1 and not quantized:
        metrics, after = ref.metrics, ref.after
    else:
        _, metrics, after = _ref_steps(ref.cfg, ref.params, ref.batch,
                                       accum_steps=accum_steps,
                                       quantized=quantized)
    cfg, model = _port(arch, ref.params)
    step = steps.make_train_step(cfg, lr=LR, accum_steps=accum_steps,
                                 quantized_opt=quantized)
    opt = adamw_init(model, quantize=quantized)
    got = []
    for _ in range(2):
        model, opt, m = step(model, opt, _port_batch(ref.batch))
        got.append({k: float(v) for k, v in m.items()})
    want = params_from_reference(after[0], cfg, device="cpu").state_dict()
    want_opt = opt_state_from_reference(after[1], cfg, device="cpu")
    return metrics, got, model.state_dict(), want, opt, want_opt


def _step_excess(got: dict, want: dict, grads: dict) -> float:
    """The largest |got - want| over the parameters' entries whose first
    gradient is at least STEP_G_FLOOR of their parameter's largest, in units
    of LR."""
    worst = 0.0
    for k, w in want.items():
        g = np.abs(_np(grads[k]))
        ok = g >= STEP_G_FLOOR * g.max()
        if ok.any():
            worst = max(worst, np.abs(_np(got[k]) - _np(w))[ok].max())
    return worst / LR


def _any_excess(got: dict, want: dict) -> float:
    """The largest |got - want| over every entry, in units of LR."""
    return max(np.abs(_np(got[k]) - _np(w)).max()
               for k, w in want.items()) / LR


def _check_steps(arch, metrics, got_m, got, want, cfg_params, tol):
    ref = _reference(arch)
    for jm, pm in zip(metrics, got_m):
        for key in ("loss", "grad_norm"):
            assert abs(pm[key] - jm[key]) <= LOSS_TOL * abs(jm[key]), \
                (key, pm, jm)
    assert _step_excess(got, want, ref.grads) <= tol
    assert _any_excess(got, want) <= STEP_ANY
    # control: the parameters before the steps
    before = params_from_reference(jax.tree.map(np.asarray, ref.params),
                                   cfg_params, device="cpu").state_dict()
    assert _step_excess(before, want, ref.grads) > STEP_Q8_TOL


ACCUM_ARCHS = ["qwen3_14b", "dbrx_132b", "mamba2_130m",
               "seamless_m4t_large_v2"]


@pytest.mark.parametrize("arch,accum_steps",
                         [(a, 1) for a in ARCHS]
                         + [(a, 2) for a in ACCUM_ARCHS])
def test_train_steps_match_reference(arch, accum_steps):
    """Two steps of ``make_train_step`` (f32 moments) in each package: the
    loss and grad_norm of each within LOSS_TOL, the parameters after within
    STEP_TOL x LR (STEP_ANY x LR where the gradient is near 0), the moments
    within MOMENT_TOL of their own scale.  Controls: the parameters before the
    steps must fail; so must grad_norm summed over microbatches without the
    1 / accum_steps."""
    metrics, got_m, got, want, opt, want_opt = _step_readings(
        arch, accum_steps, False)
    _check_steps(arch, metrics, got_m, got, want,
                 configs.get_config(arch, smoke=True), STEP_TOL)
    assert int(opt.step) == int(want_opt.step) == 2
    for tree, ref in ((opt.m, want_opt.m), (opt.v, want_opt.v)):
        for k, x in tree.items():
            w = _np(ref[k])
            assert np.abs(_np(x) - w).max() <= MOMENT_TOL * np.abs(w).max(), k
        # control: the moments as adamw_init leaves them
        assert any(np.abs(_np(w)).max() > 0 for w in ref.values())
    jm = metrics[0]
    assert abs(got_m[0]["grad_norm"] * accum_steps * 2 - jm["grad_norm"]) \
        > LOSS_TOL * jm["grad_norm"]


@pytest.mark.parametrize("arch", ["qwen3_14b", "dbrx_132b"])
def test_quantized_train_steps_match_reference(arch):
    """Two steps with Q8 moments (a dense arch and a MoE arch): loss and
    grad_norm as with f32 moments, the parameters within STEP_Q8_TOL x LR;
    each moment's int8
    payloads within one step of the reference's, its scales within 1e-4
    relative (the f32 inputs differ in their last bits)."""
    metrics, got_m, got, want, opt, want_opt = _step_readings(arch, 1, True)
    _check_steps(arch, metrics, got_m, got, want,
                 configs.get_config(arch, smoke=True), STEP_Q8_TOL)
    for tree, ref in ((opt.m, want_opt.m), (opt.v, want_opt.v)):
        for k, q in tree.items():
            assert isinstance(q, Q8) and isinstance(ref[k], Q8)
            assert q.q.dtype == torch.int8
            assert np.abs(_np(q.q) - _np(ref[k].q)).max() <= 1, k
            np.testing.assert_allclose(_np(q.scale), _np(ref[k].scale),
                                       rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise(arch):
    """The loss and every gradient with remat on equal remat off bitwise
    (the recompute runs the same operations on the same values)."""
    cfg = configs.get_config(arch, smoke=True)
    b = _port_batch(_batch(cfg))
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = T.init_model(c, seed=0, device="cpu").requires_grad_(True)
        out[remat] = _port_grads(model, c, b)
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[True][1].items():
        assert torch.equal(g, out[False][1][k]), k


def test_remat_checkpoints_each_scanned_group(monkeypatch):
    """gemma3's smoke config (8 layers: 1 scanned group of 6 and 2
    remainder layers) runs one checkpointed group under grad, none under
    ``no_grad`` or with remat off."""
    calls = []
    real = T.checkpoint

    def counting(fn, *args, **kw):
        calls.append(len(args[0]))
        return real(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counting)
    cfg = configs.get_config("gemma3_1b", smoke=True)
    model = T.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    T.forward(model, cfg, tokens)
    assert calls == [6]
    with torch.no_grad():
        T.forward(model, cfg, tokens)
    T.forward(model, dataclasses.replace(cfg, remat=False), tokens)
    assert calls == [6]


def test_flash_raises_under_grad():
    """Neither flash wrapper has a backward: under grad, with an input that
    requires grad, both raise on the CPU too; under ``no_grad`` both run."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 128, 2, 64, generator=g, requires_grad=True)
    k = torch.randn(1, 128, 1, 64, generator=g)
    with pytest.raises(NotImplementedError, match="_flash_kernel"):
        F.flash_gqa(q, k, k, bq=64, bk=64)
    qf = q.detach().transpose(1, 2).reshape(2, 128, 64).requires_grad_(True)
    kf = k.transpose(1, 2).reshape(1, 128, 64)
    with pytest.raises(NotImplementedError, match="_flash_kernel"):
        F.flash_attention(qf, kf, kf, bq=64, bk=64)
    with torch.no_grad():
        out = F.flash_gqa(q, k, k, bq=64, bk=64)
        assert F.flash_attention(qf, kf, kf, bq=64, bk=64).shape == qf.shape
    assert out.grad_fn is None
    # an input that needs no grad runs with grad on
    assert F.flash_gqa(q.detach(), k, k, bq=64, bk=64).grad_fn is None


def test_flash_model_raises_in_training():
    cfg = dataclasses.replace(configs.get_config("qwen3_14b", smoke=True),
                              use_flash_attention=True)
    model = T.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
    b = _port_batch(dict(_batch(cfg), tokens=np.zeros((2, 128), np.int32),
                         labels=np.zeros((2, 128), np.int32)))
    step = steps.make_train_step(cfg)
    with pytest.raises(NotImplementedError, match="_flash_kernel"):
        step(model, adamw_init(model), b)


def test_reference_flash_has_no_gradient():
    """Pinned: ``jax.grad`` through the reference's Pallas flash kernel (in
    interpret mode, as its tests run it) fails, so the reference trains
    through its chunked attention and the port raises."""
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((1, 128, 2, 64)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, 128, 1, 64)), jnp.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda x: JF.flash_gqa(x, k, k, causal=True, bq=64, bk=64,
                                        interpret=True).sum())(q)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_builds_no_graph(arch):
    """With the parameters requiring grad and grad on, the prefill step's
    logits, ``decode_tokens``' prompt logits and ``decode_step``'s logits
    carry no ``grad_fn``; ``forward`` itself does build one."""
    cfg = configs.get_config(arch, smoke=True)
    model = T.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
    b = _port_batch(_batch(cfg))
    extra = {k: v for k, v in b.items() if k.endswith("_embeds")}
    logits = steps.make_prefill_step(cfg)(model, b)
    assert logits.grad_fn is None and not logits.requires_grad
    enc_out = None
    if cfg.is_encdec:
        with torch.no_grad():
            enc_out = T.apply_encoder(model, cfg, extra["enc_embeds"])
    _, _, prompt_logits = serve.decode_tokens(model, cfg, b["tokens"][:, :4],
                                              2, enc_out=enc_out)
    assert prompt_logits.grad_fn is None
    assert T.forward(model, cfg, b["tokens"], **extra).grad_fn is not None


def test_train_step_needs_parameters_that_require_grad():
    cfg = configs.get_config("qwen3_14b", smoke=True)
    model = T.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="requires_grad_"):
        steps.make_train_step(cfg)(model, adamw_init(model),
                                   _port_batch(_batch(cfg)))
