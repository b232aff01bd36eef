"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU ``flash_attention``/``flash_gqa`` run their plain version
(``repro_torch.kernels.ref.flash_attention_ref``); each case is held against
the reference's ``flash_attention(..., interpret=True)`` on the same inputs,
made with numpy from a seed.  Tolerances are those of
``tests/test_flash_attention.py``: 2e-5 in f32 (two f32 softmax-attention
evaluations in different orders) and 3e-2 in bf16 (one bf16 rounding of
outputs of magnitude below 1).  Each output row is also held at its own
scale: the output's rounding, at most one ulp of the row's largest value
(2^-7 in bf16, 2^-23 in f32), plus the two summation orders of a weighted
mean of v in f32, ACC x 2^-24 x max|v| (the worst reading is 0.75 of
2^-24 max|v|).  The CUDA kernel is held against the plain version
on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
ROW_TOL = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
ACC = 8
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _both(x, dtype):
    """One numpy f32 array as jnp and torch arrays of ``dtype`` (both round
    f32 -> bf16 to nearest even, so the inputs are identical)."""
    return jnp.asarray(x, _JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


def _close(got, want, v, dtype):
    got = got.to(torch.float64).numpy()
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    # each row at its own scale
    err = np.abs(got - want).max(axis=-1)
    allow = (ROW_TOL[dtype] * np.abs(want).max(axis=-1)
             + ACC * 2.0 ** -24 * float(v.abs().max()))
    assert (err <= allow).all(), float((err / allow).max())


@pytest.mark.parametrize("s,t,hd,bq,bk", [
    (128, 128, 64, 64, 64),
    (256, 256, 128, 64, 128),
    (128, 256, 64, 128, 64),     # cross-length (prefill against memory)
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(s, t, hd, bq, bk, causal):
    """The cases of test_flash_attention.py::test_flash_matches_oracle; the
    causal cross-length case too (both align the mask at position 0)."""
    bh = 4
    q, k, v = _rand((bh, s, hd), 0), _rand((bh, t, hd), 1), _rand((bh, t, hd), 2)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "float32") for x in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                               interpret=True)
    got = fa.flash_attention(tq, tk, tv, causal=causal, bq=bq, bk=bk)
    assert got.shape == (bh, s, hd) and got.dtype == torch.float32
    _close(got, want, tv, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv", [(8, 2), (4, 4), (8, 1), (10, 2)])
def test_flash_gqa_matches_reference(dtype, h, kv):
    """Model layout, groups of 4 (test_flash_gqa_grouping), 1, 8 and 5
    (qwen3's 40/8), f32 and bf16."""
    b, s, hd = 2, 128, 64
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_rand(shape, seed), dtype) for shape, seed in
        (((b, s, h, hd), 3), ((b, s, kv, hd), 4), ((b, s, kv, hd), 5)))
    want = jfa.flash_gqa(jq, jk, jv, causal=True, bq=64, bk=64,
                         interpret=True)
    got = fa.flash_gqa(tq, tk, tv, causal=True, bq=64, bk=64)
    assert got.shape == (b, s, h, hd) and got.dtype == _TORCH[dtype]
    _close(got, want, tv, dtype)


def test_flash_long_kv_streaming():
    """Many KV blocks: the reference carries (m, l, acc) across 16 of them."""
    bh, s, t, hd = 1, 64, 1024, 64
    q, k, v = _rand((bh, s, hd), 6), _rand((bh, t, hd), 7), _rand((bh, t, hd), 8)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "float32") for x in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=False, bq=64, bk=64,
                               interpret=True)
    got = fa.flash_attention(tq, tk, tv, causal=False, bq=64, bk=64)
    _close(got, want, tv, "float32")


@pytest.mark.parametrize("hd", [192, 256])
def test_flash_wide_heads_match_reference(hd):
    """nemotron's head_dim 192 and gemma3's 256, causal, bf16."""
    b, s, h, kv = 1, 128, 4, 1
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_rand(shape, seed), "bfloat16") for shape, seed in
        (((b, s, h, hd), 9), ((b, s, kv, hd), 10), ((b, s, kv, hd), 11)))
    want = jfa.flash_gqa(jq, jk, jv, causal=True, bq=128, bk=64,
                         interpret=True)
    got = fa.flash_gqa(tq, tk, tv, causal=True, bq=128, bk=64)
    _close(got, want, tv, "bfloat16")


def test_block_sizes_do_not_change_the_result():
    q, k, v = (torch.from_numpy(_rand((2, 256, 64), seed)) for seed in (12, 13, 14))
    base = fa.flash_attention(q, k, v, causal=True)
    for bq, bk in ((64, 64), (128, 32), (256, 256)):
        assert torch.equal(fa.flash_attention(q, k, v, causal=True, bq=bq,
                                              bk=bk), base)


@pytest.mark.parametrize("qshape,kshape,bq,bk", [
    ((6, 128, 64), (4, 128, 64), 64, 64),      # BH % BKV != 0
    ((4, 96, 64), (4, 128, 64), 64, 64),       # S % bq != 0
    ((4, 128, 64), (4, 96, 64), 64, 64),       # T % bk != 0
])
def test_wrapper_checks_match_reference(qshape, kshape, bq, bk):
    """The reference's asserts (flash_attention.py:71-76) raise here too."""
    q, k = np.zeros(qshape, np.float32), np.zeros(kshape, np.float32)
    with pytest.raises(AssertionError):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                            bq=bq, bk=bk, interpret=True)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(k), bq=bq, bk=bk)


def test_gqa_heads_must_divide():
    q = torch.zeros(1, 128, 6, 64)
    k = torch.zeros(1, 128, 4, 64)
    with pytest.raises(ValueError):
        fa.flash_gqa(q, k, k)


def test_cpu_takes_the_plain_version():
    """On CPU tensors the wrappers run flash_attention_ref and launch
    nothing; the plain version's constants are the reference's."""
    ops.reset_counts()
    q, k, v = (torch.from_numpy(_rand((2, 128, 64), seed)) for seed in (15, 16, 17))
    assert torch.equal(fa.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))
    assert ops.launch_counts()["flash_attention"] == 0
    assert ref.NEG_INF == jfa.NEG_INF
