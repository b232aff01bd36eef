"""The port's optimizer (``repro_torch.optim``: Q8 and fourth-root coding,
AdamW with f32 or Q8 moments) against the JAX package's, fed the same
numpy values; and the reference's optimizer cases of
``tests/test_substrate.py``, ported."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import quantized as JQ

from repro_torch.optim import (OptState, Q8, adamw_init, adamw_update,
                               dequantize_q8, quantize_q8)
from repro_torch.optim import quantized as Q

LAST = (1, 127, 128, 129, 300)
# AdamW on the same gradients: the parameters, f32 moments and Q8 scales
# within ADAM_ULPS f32 ulps of each tensor's largest entry (the bias
# corrections' f32 powers and square roots may round differently).
# Readings: parameters 0.016 (an ulp of a smaller entry), f32 moments and
# Q8 payloads bitwise, one Q8 scale 1; the control, the parameters before
# the steps, reads over 1e4.
ADAM_ULPS = 4


def _values(shape, seed):
    """Normal values with, from 256 entries on, a block of zeros and then a
    block of exact half-quantum ties (its largest is 127, so its scale is
    1.0 and the x.5 entries sit on a rounding tie); from 3 entries, two
    ties in the first block."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    last = shape[-1]
    if last >= 2 * Q.BLOCK:
        x[..., :Q.BLOCK] = 0.0                         # a zero block
        ties = np.arange(Q.BLOCK, 2 * Q.BLOCK) % 7 - 3 + 0.5
        ties[0] = 127.0
        x[..., Q.BLOCK:2 * Q.BLOCK] = ties
    elif last >= 3:
        x[..., 0] = 127.0
        x[..., 1:3] = (2.5, -3.5)                      # ties to even
    return x


@pytest.mark.parametrize("last", LAST)
def test_q8_coding_is_bitwise(last):
    x = _values((3, last), seed=last)
    got, want = quantize_q8(torch.from_numpy(x)), JQ.quantize_q8(
        jnp.asarray(x))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(dequantize_q8(got).numpy(),
                                  np.asarray(JQ.dequantize_q8(want)))
    # control: rounding half away from zero differs on the ties
    ties = (slice(Q.BLOCK + 1, 2 * Q.BLOCK) if last >= 2 * Q.BLOCK
            else slice(1, 3) if last >= 3 else None)
    if ties is not None:
        t = x[0, ties]
        away = np.trunc(t + np.sign(t) * 0.5)
        assert (away != np.asarray(want.q)[0, ties]).any()


@pytest.mark.parametrize("last", LAST)
def test_root4_coding_is_bitwise(last):
    v = np.abs(_values((2, last), seed=10 + last)) ** 2 * 1e-6
    got = Q.quantize_q8_root4(torch.from_numpy(v))
    want = JQ.quantize_q8_root4(jnp.asarray(v))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        Q.dequantize_q8_root4(got).numpy(),
        np.asarray(JQ.dequantize_q8_root4(want)))
    # negative entries code as zero, as the reference's maximum(v, 0)
    neg = Q.quantize_q8_root4(-torch.from_numpy(v))
    assert not neg.q.any()


def _adam_pair(quantize, steps=3, seed=0, wd=0.01):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 300), "b": (129,), "c": (2, 3, 128)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1, s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jo = JA.adamw_init(jp, quantize=quantize)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    to = adamw_init(tp, quantize=quantize)
    for g in grads:
        jp, jo = JA.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jo, lr=1e-2,
            weight_decay=wd, quantize=quantize)
        tp, to = adamw_update(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()}, to, lr=1e-2,
                              weight_decay=wd, quantize=quantize)
    return p0, jp, jo, tp, to


def _ulps(got, want):
    w = np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(w).max())
    return np.abs(got.numpy().astype(np.float64) - w).max() / ulp


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_update_matches_reference(quantize):
    """Three steps fed the same gradients (six decades of magnitude): the
    parameters within ADAM_ULPS ulps; f32 moments likewise, Q8 moments'
    payloads within one int8 step (bitwise in these readings) and scales
    within ADAM_ULPS ulps.  Control: the parameters as they were."""
    p0, jp, jo, tp, to = _adam_pair(quantize)
    assert int(to.step) == int(jo.step) == 3
    for k in p0:
        assert _ulps(tp[k], jp[k]) <= ADAM_ULPS, k
        assert _ulps(torch.from_numpy(p0[k]), jp[k]) > 1e4 * ADAM_ULPS
        for got, want in ((to.m[k], jo.m[k]), (to.v[k], jo.v[k])):
            if quantize:
                assert isinstance(got, Q8)
                assert np.abs(got.q.numpy().astype(int)
                              - np.asarray(want.q).astype(int)).max() <= 1
                assert _ulps(got.scale, want.scale) <= ADAM_ULPS
            else:
                assert _ulps(got, want) <= ADAM_ULPS


def test_adamw_keys_follow_the_model():
    """The moments are keyed by the model's parameter names."""
    from torch import nn
    m = nn.Linear(3, 2)
    st = adamw_init(m, quantize=True)
    assert set(st.m) == set(st.v) == {"weight", "bias"}
    assert isinstance(st, OptState) and st.step.dtype == torch.int32
    assert st.m["weight"].q.shape == (2, 3)
    assert st.m["weight"].scale.shape == (2, 1)


# ---------------------------------------------------------------------------
# tests/test_substrate.py's optimizer cases, on the port

def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(300):
        grads = {"w": 2.0 * params["w"]}
        params, opt = adamw_update(params, grads, opt, lr=5e-2,
                                   weight_decay=0.0)
    assert float(params["w"].abs().max()) < 1e-2


def test_q8_roundtrip_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((7, 300)).astype(np.float32))
    q = quantize_q8(x)
    assert q.q.dtype == torch.int8
    y = dequantize_q8(q)
    assert y.shape == x.shape
    err = float((x - y).abs().max())
    assert err <= float(x.abs().max()) / 127.0 + 1e-7


def test_q8_zero_block():
    x = torch.zeros((4, 256))
    np.testing.assert_array_equal(dequantize_q8(quantize_q8(x)).numpy(),
                                  np.zeros((4, 256)))


def test_quantized_adamw_tracks_fp32():
    rng = np.random.default_rng(1)
    w0 = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    pf = {"w": w0.clone()}
    pq = {"w": w0.clone()}
    of = adamw_init(pf)
    oq = adamw_init(pq, quantize=True)
    assert isinstance(oq.m["w"], Q8)
    for _ in range(20):
        pf, of = adamw_update(pf, {"w": pf["w"] * 0.5 + 0.1}, of, lr=1e-2,
                              weight_decay=0.0)
        pq, oq = adamw_update(pq, {"w": pq["w"] * 0.5 + 0.1}, oq, lr=1e-2,
                              weight_decay=0.0, quantize=True)
    # 8-bit moments drift slowly from the fp32 trajectory (no stochastic
    # rounding); what matters is staying in lockstep, not bit-equality.
    diff = float((pf["w"] - pq["w"]).abs().max())
    assert diff < 0.15, diff


def test_quantized_v_no_blowup():
    """Linear-int8 v flushed small entries to zero and exploded the
    update; root4 coding must keep every update bounded."""
    rng = np.random.default_rng(0)
    g0 = torch.from_numpy(np.concatenate(
        [rng.standard_normal(64) * 1e-4,
         rng.standard_normal(64)]).astype(np.float32))
    p = {"w": torch.zeros(128)}
    opt = adamw_init(p, quantize=True)
    for _ in range(10):
        p, opt = adamw_update(p, {"w": g0}, opt, lr=1e-2, weight_decay=0.0,
                              quantize=True)
    assert float(p["w"].abs().max()) < 10 * 1e-2 * 1.5
