"""The tensor-core flash kernel's arithmetic and geometry, on the CPU.

``csrc/flash_wgmma.cu`` runs only on a card.  What can be held here:

- the split of P into bf16 halves (``ref.split_bf16``): hi is bf16(p) and
  hi + lo is p within 2^-17 of |p|;
- a plain model of the kernel's function (``flash_attention_ref`` with
  ``p_mode="split"``) against the JAX package's Pallas kernel in interpret
  mode, on the same inputs made with numpy from a seed: the share of bf16
  outputs that differ stays under ``chip_smoke.py``'s FLASH_MISMATCH_BOUND,
  and the model with P rounded to bf16 (the control) reads above it;
- the launch geometry the wrapper passes and the kernel checks: blocks of
  128 query rows, the KV tiles a block and each warpgroup read under the
  causal mask, the longest-first order, and the shared memory a block.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# chip_smoke.py's FLASH_MISMATCH_BOUND (its comment gives the card's
# readings over seeds 0-2; the split model reads 0.0020-0.0025 here)
MISMATCH_BOUND = 0.05
SMEM_LIMIT = 232_448        # bytes of shared memory a block can have (H100)


def _p_values(seed):
    """p = exp(s - m) as the softmax makes it: values in (0, 1] over many
    binades, with exact 1s, powers of two and zeros."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-60.0, 0.0, 4096).astype(np.float32)
    p = torch.from_numpy(s).exp()
    extra = torch.tensor([1.0, 0.5, 2.0 ** -20, 0.0, 1.0 - 2.0 ** -24,
                          2.0 ** -9 + 2.0 ** -20])
    return torch.cat([p, extra])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_hi_is_bf16_and_hi_plus_lo_within_2_17(seed):
    p = _p_values(seed)
    hi, lo = ref.split_bf16(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, p.to(torch.bfloat16))
    rest = (p.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2.0 ** -17 * p.double()).all()
    # the split keeps more than bf16 alone: its worst relative error is
    # below bf16's by a factor of 2^8 or more
    bf16_err = ((p.double() - hi.double()).abs() / p.double().clamp_min(
        1e-300)).max()
    assert float(bf16_err) > 2.0 ** -10
    assert float((rest / p.double().clamp_min(1e-300)).max()) <= \
        float(bf16_err) * 2.0 ** -8


def test_split_of_p_that_is_bf16_has_no_lo():
    p = torch.tensor([1.0, 0.75, 2.0 ** -30, 0.0])
    hi, lo = ref.split_bf16(p)
    assert torch.equal(hi.float(), p)
    assert not lo.float().any()


def _both(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _share(got, want):
    return float((got.float().numpy() != np.asarray(want, np.float32)).mean())


@pytest.mark.parametrize("s,t,hd,h,kv,causal", [
    (256, 256, 64, 8, 2, True),
    (512, 512, 128, 4, 1, True),
    (256, 512, 64, 10, 2, False),
])
def test_split_model_against_reference(s, t, hd, h, kv, causal):
    """The split-P model against the Pallas kernel (interpret mode, P in
    f32): its mismatch share is under the bound; the bf16-P control's is
    above it.  The f32-P plain version (the port's CPU path) is under it
    too."""
    b = 2
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(shape, seed) for shape, seed in
        (((b, s, h, hd), s + hd), ((b, t, kv, hd), t + 1),
         ((b, t, kv, hd), t + 2)))
    want = jfa.flash_gqa(jq, jk, jv, causal=causal, bq=128, bk=128,
                         interpret=True)
    shares = {mode: _share(fa.flash_gqa_ref(tq, tk, tv, causal=causal,
                                            p_mode=mode), want)
              for mode in ("f32", "split", "bf16")}
    assert shares["f32"] <= MISMATCH_BOUND, shares
    assert shares["split"] <= MISMATCH_BOUND, shares
    assert shares["bf16"] > MISMATCH_BOUND, shares
    # the bound sits well clear of both: ten times the split's share here,
    # a quarter of the control's
    assert shares["bf16"] > 4 * MISMATCH_BOUND > 40 * shares["split"], shares


def test_p_modes_share_l_and_f32_is_the_function():
    """``p_mode="f32"`` is the plain version bitwise; the split and bf16
    models change only P . V, not l."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, 64)).astype(
        np.float32)) for _ in range(3))
    base = ref.flash_attention_ref(q, k, v)
    assert torch.equal(ref.flash_attention_ref(q, k, v, p_mode="f32"), base)
    split = ref.flash_attention_ref(q, k, v, p_mode="split")
    assert float((split - base).abs().max()) < 2.0 ** -16
    with pytest.raises(ValueError):
        ref.flash_attention_ref(q, k, v, p_mode="f16")


# --------------------------------------------------------------------------
# launch geometry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_tc_shared_memory_fits(hd):
    assert fa.tc_smem_bytes(hd) <= SMEM_LIMIT
    assert fa.TC_STAGES[hd] >= 2
    assert fa.TC_BK[hd] in (64, 128) and fa.TC_BK[hd] % 64 == 0
    # one more stage would not fit, except where the ring is at its 4
    more = fa.tc_smem_bytes(hd) + 4 * hd * fa.TC_BK[hd] + 16
    assert fa.TC_STAGES[hd] == 4 or more > SMEM_LIMIT


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 100, 127, 128, 129, 200, 1000, 2048])
def test_tc_blocks_cover_rows_once_longest_first(s, hd):
    ny = fa.tc_row_blocks(s)
    rows = np.zeros(ny * fa.TC_BQ, int)
    q0s = [fa.tc_block_q0(y, s) for y in range(ny)]
    for q0 in q0s:
        assert q0 % fa.TC_BQ == 0
        rows[q0:q0 + fa.TC_BQ] += 1
    assert (rows == 1).all() and q0s[0] + fa.TC_BQ >= s > q0s[0]
    # the first block launched holds the last rows: the most causal tiles
    tiles = [fa.tc_kv_tiles(q0, fa.TC_BQ, s, True, hd) for q0 in q0s]
    assert tiles == sorted(tiles, reverse=True)


@pytest.mark.parametrize("hd", [64, 256])      # tiles of 128 and 64 keys
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t", [(128, 128), (200, 200), (2048, 2048),
                                 (100, 1000), (1000, 100), (128, 16384)])
def test_tc_kv_tiles_cover_the_mask(s, t, causal, hd):
    """Every key a row of the block (or of a warpgroup) needs lies in a
    tile it reads; no tile it reads lies wholly above the diagonal of its
    rows; the lower warpgroup reads the block's tiles but at most the last
    one (so it only drops the tail of the ring)."""
    bk = fa.TC_BK[hd]
    for y in range(fa.tc_row_blocks(s)):
        q0 = fa.tc_block_q0(y, s)
        n_block = fa.tc_kv_tiles(q0, fa.TC_BQ, t, causal, hd)
        for w in range(fa.TC_BQ // fa.TC_WG_ROWS):
            qw = q0 + w * fa.TC_WG_ROWS
            n = fa.tc_kv_tiles(qw, fa.TC_WG_ROWS, t, causal, hd)
            last_row = qw + fa.TC_WG_ROWS - 1
            need = min(t, last_row + 1) if causal else t
            assert n * bk >= need and (n - 1) * bk < need
            assert n <= n_block
        assert fa.tc_kv_tiles(q0, fa.TC_WG_ROWS, t, causal, hd) >= n_block - 1
        assert fa.tc_kv_tiles(q0 + fa.TC_WG_ROWS, fa.TC_WG_ROWS, t,
                              causal, hd) == n_block


def test_tc_variant_by_dtype():
    assert fa.variant(torch.bfloat16) == "tensor_core"
    assert fa.variant(torch.float32) == "ffma"


def test_tensor_core_kernel_refuses_f32(monkeypatch):
    """Asked for the tensor-core kernel on f32 (which would be TF32) the
    wrapper raises before it builds or launches anything."""
    monkeypatch.setattr(_build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(_build, "function", lambda *a: pytest.fail("built"))
    x = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="tensor_core"):
        fa.flash_gqa(x, x, x, kernel="tensor_core")
    with pytest.raises(ValueError, match="no 'wgmma'"):
        fa.flash_gqa(x.bfloat16(), x.bfloat16(), x.bfloat16(),
                     kernel="wgmma")
