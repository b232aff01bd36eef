"""The port's class round against the reference's NumPy round, bitwise.

Every class of every ladder, on seeded log-uniform samples in f64 (the
reference's x64 compute dtype) and f32 (the kernels' compute dtype).  The
samples include values past e4m3's band, which must give NaN as the
reference's cast does (PyTorch's own cast saturates), and f64 values at
f16 rounding ties, where PyTorch's own f64 -> f16 cast rounds twice.
"""
import numpy as np
import pytest
import torch

from repro.core.cholesky import _np_round
from repro.core.precision import LADDERS as REF_LADDERS

from repro_torch.kernels.ref import _fp8_scale, _round
from repro_torch.core.precision import LADDERS, fp8_scale

CLASSES = sorted({c for lad in REF_LADDERS.values() for c in lad})


def _log_uniform(n, lo=-12.0, hi=6.0, seed=0):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(lo, hi, n)
    return np.where(rng.random(n) < 0.5, -mag, mag)


def _edge_values():
    near448 = [440.0, 448.0, 455.0, 463.99, 464.0, 464.0001, 470.0, 479.0,
               480.0, 500.0, 1e4, 1e30, np.inf, -np.inf, np.nan]
    vals = near448 + [-v for v in near448] + [0.0, -0.0, 2.0 ** -10,
                                              2.0 ** -20, -(2.0 ** -30)]
    return np.array(vals, dtype=np.float64)


def _f16_ties(n=4000, seed=1):
    """f64 midpoints between neighbouring f16 values, and points a hair
    off them (below f32 resolution, so an f32 intermediate lands on the
    tie and a second round breaks it the wrong way)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(1, 0x7BFF, n, dtype=np.uint16).view(np.float16)
    lo = h.astype(np.float64)
    hi = np.nextafter(h, np.float16(np.inf)).astype(np.float64)
    mid = 0.5 * (lo + hi)
    off = np.abs(mid) * 2.0 ** -40
    out = np.concatenate([mid, mid + off, mid - off])
    return np.concatenate([out, -out])


def _same(got: np.ndarray, want: np.ndarray) -> None:
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    assert np.array_equal(nan_g, nan_w), (got[nan_g != nan_w],
                                          want[nan_g != nan_w])
    ints = {8: np.uint64, 4: np.uint32}[got.dtype.itemsize]
    diff = got[~nan_g].view(ints) != want[~nan_w].view(ints)
    assert not diff.any(), (got[~nan_g][diff][:8], want[~nan_w][diff][:8])


def test_ladders_are_the_reference_ladders():
    assert LADDERS == REF_LADDERS


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_round_matches_reference_bitwise(cls, dtype):
    x = np.concatenate([_log_uniform(20000), _edge_values(),
                        _f16_ties()]).astype(dtype)
    # one call per 256-value "tile", so the scaled class sees many scales
    for chunk in np.array_split(x, max(1, x.size // 256)):
        got = _round(torch.from_numpy(chunk.copy()), cls).numpy()
        _same(got, _np_round(chunk, cls))


def test_f8_overflow_is_nan():
    x = torch.tensor([448.0, 464.0, 465.0, 1e4, -1e4, float("inf")],
                     dtype=torch.float64)
    got = _round(x, "f8e4m3")
    assert got[:2].tolist() == [448.0, 448.0]
    assert torch.isnan(got[2:]).all()


def test_f16_round_is_one_step():
    """PyTorch's own cast rounds twice here; the port must not."""
    x = np.float64(1.0) + 2.0 ** -11 + 2.0 ** -30
    got = _round(torch.tensor([x], dtype=torch.float64), "f16").item()
    assert got == float(np.float16(x)) == 1.0 + 2.0 ** -10


@pytest.mark.parametrize("seed", range(3))
def test_fp8_scale_matches_precision_fp8_scale(seed):
    amax = np.concatenate([10.0 ** np.random.default_rng(seed).uniform(
        -30, 30, 2000), [0.0, 448.0, 449.0, 0.875, 1.0, np.inf, np.nan]])
    got = _fp8_scale(torch.from_numpy(amax)).numpy()
    want = np.array([fp8_scale(float(a)) for a in amax])
    np.testing.assert_array_equal(got, want)
