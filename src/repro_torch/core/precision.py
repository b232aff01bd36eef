# A copy of repro/core/precision.py, kept line for line so that the port builds
# the same plans and op streams (and digests) without importing repro.
"""Per-tile precision assignment (paper §IV-C, following Higham & Mary).

A tile ``A[i, j]`` may be demoted to a lower precision with unit roundoff
``eps_low`` when

    n_col_tiles * ||A_ij||_F / ||A||_F  <=  eps_target / eps_low

where ``eps_target`` is the requested accuracy level (the paper sweeps
1e-5 .. 1e-8 in Fig. 10/11) and ``n_col_tiles`` the number of tiles in the
column block.  Each tile gets the *lowest* precision in the ladder that
satisfies the inequality; diagonal tiles are pinned to the highest class
(POTRF stability — they always classify high in practice anyway).

TPU adaptation: the four-precision ladder is FP64/FP32/BF16/FP8-e4m3
(bf16 replaces fp16 — native on the MXU; see DESIGN.md §2).  The original
GPU ladder (fp16) is available via ``ladder="gpu"`` for paper-faithful
accuracy experiments.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Unit roundoffs u = 2^-(t) for each format (t = mantissa bits + 1).
# "f8e4m3s" is the *scaled* FP8 class: the same e4m3 storage format, but
# every tile is multiplied by a per-tile power-of-two scale chosen from its
# amax before the down-cast (and divided back on promotion), so the whole
# tile lands in the format's representable band and the roundoff really is
# the format's relative eps.  The unscaled class only achieves 2^-4 when
# the tile's values happen to fit e4m3's narrow range — see
# :func:`fp8_unscaled_eps`.
EPS = {
    "f64": 2.0 ** -53,
    "f32": 2.0 ** -24,
    "f16": 2.0 ** -11,
    "bf16": 2.0 ** -8,
    "f8e4m3": 2.0 ** -4,
    "f8e4m3s": 2.0 ** -4,
}

LADDERS = {
    # index 0 is highest precision; assignment picks the largest index
    # (lowest precision) whose eps satisfies the criterion.
    "tpu": ("f64", "f32", "bf16", "f8e4m3"),
    "gpu": ("f64", "f32", "f16", "f8e4m3"),
    # the paper's fourth precision as a scaled-FP8 tile class: per-tile
    # amax tracked at store time, scale applied in the kernel epilogue
    # and inverted on promotion (docs/kernels.md)
    "tpu-scaled": ("f64", "f32", "bf16", "f8e4m3s"),
    "gpu-scaled": ("f64", "f32", "f16", "f8e4m3s"),
}

BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e4m3s": 1}

# float8_e4m3fn representable band: max finite 448, smallest normal 2^-6.
FP8_MAX = 448.0
FP8_MIN_NORMAL = 2.0 ** -6


def fp8_scale(amax: float) -> float:
    """Per-tile power-of-two scale for the scaled-FP8 class.

    Chosen so ``amax * scale`` lands just inside e4m3's max finite value
    (the ``max_L`` rule of fp8_chol.cuh): the largest 2^e with
    ``amax * 2^e <= FP8_MAX``.  A power of two keeps the scale
    application/inversion exact in binary floating point, so the only
    rounding is the e4m3 mantissa truncation itself.  ``amax <= 0``
    (zero tile) returns 1.0 — nothing to scale.

    Computed via frexp (``amax = m * 2^e`` with ``m in [0.5, 1)``,
    ``448 = 0.875 * 2^9``) rather than ``floor(log2(448 / amax))``: the
    executors' numpy and jax implementations must agree *bitwise* on the
    scale, and a log2 that lands one ulp across an integer boundary would
    shift the scale a whole octave.
    """
    if not amax > 0.0 or not np.isfinite(amax):
        return 1.0
    m, e = np.frexp(amax)
    return float(2.0 ** int((8 - e) + (1 if m <= 0.875 else 0)))


def fp8_unscaled_eps(amax: float) -> float:
    """Effective roundoff of the *unscaled* FP8 class for a tile with the
    given amax.

    Inside the representable band the unit roundoff is the format's
    2^-4.  Outside it the cast is no longer a rounding: values above
    ``FP8_MAX`` saturate (relative error up to ``1 - FP8_MAX/amax``) and
    tiles living entirely below the subnormal floor flush toward zero
    (relative error approaching 1).  Classification against the plain
    ``EPS["f8e4m3"]`` silently assumed the in-band case; this is the
    honest per-tile figure the criterion must use when the amax is known.
    """
    u = EPS["f8e4m3"]
    if not amax > 0.0 or not np.isfinite(amax):
        return u
    if amax > FP8_MAX:            # saturation: amax clips to FP8_MAX
        return max(u, 1.0 - FP8_MAX / amax)
    if amax < FP8_MIN_NORMAL:     # gradual underflow: 3 mantissa bits of
        # headroom below the normal floor, then flush to zero
        return min(1.0, u * FP8_MIN_NORMAL / amax)
    return u


def class_eps(name: str, amax: float | None = None) -> float:
    """Unit roundoff of one precision class, amax-aware for FP8.

    The scaled class always achieves the format eps (the per-tile scale
    recentres the tile into the representable band); the unscaled class
    degrades outside the band per :func:`fp8_unscaled_eps`.  ``amax=None``
    keeps the historical format-eps behaviour for every class.
    """
    if amax is None or name != "f8e4m3":
        return EPS[name]
    return fp8_unscaled_eps(amax)


@dataclasses.dataclass(frozen=True, eq=False)
class PrecisionPlan:
    """Per-tile precision classes for one factorization.

    Value-hashable (classes compared/hashed by content) so that a plan can
    key the ``(n, config)`` solver cache of :mod:`repro.core.api`.
    """

    classes: np.ndarray        # [Nt, Nt] int8, class index into `ladder`
    ladder: tuple[str, ...]    # precision names, high -> low
    eps_target: float

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PrecisionPlan)
            and self.ladder == other.ladder
            and self.eps_target == other.eps_target
            and self.classes.shape == other.classes.shape
            and np.array_equal(self.classes, other.classes)
        )

    def __hash__(self) -> int:
        return hash((self.ladder, self.eps_target, self.classes.shape,
                     self.classes.tobytes()))

    @property
    def nt(self) -> int:
        return self.classes.shape[0]

    def name(self, i: int, j: int) -> str:
        return self.ladder[int(self.classes[i, j])]

    def bytes_of(self, i: int, j: int, tb: int) -> int:
        return BYTES[self.name(i, j)] * tb * tb

    def histogram(self) -> dict[str, int]:
        out = {name: 0 for name in self.ladder}
        nt = self.nt
        for j in range(nt):
            for i in range(j, nt):
                out[self.name(i, j)] += 1
        return out


def uniform_plan(nt: int, name: str = "f64", ladder: str = "tpu") -> PrecisionPlan:
    lad = LADDERS[ladder]
    cls = np.full((nt, nt), lad.index(name), dtype=np.int8)
    return PrecisionPlan(cls, lad, eps_target=EPS[name])


def assign_precision(
    tile_norms: np.ndarray,      # [Nt, Nt] Frobenius norms of the tiles
    matrix_norm: float,          # ||A||_F
    eps_target: float,
    ladder: str = "tpu",
    max_classes: int = 4,
    tile_amax: np.ndarray | None = None,   # [Nt, Nt] per-tile max |entry|
) -> PrecisionPlan:
    """Paper Fig. 4: pick per-tile precision from the threshold criterion.

    ``tile_amax``: per-tile absolute maxima.  When given, the criterion
    classifies FP8 tiles against their *effective* roundoff
    (:func:`class_eps`): a tile whose values saturate or underflow e4m3's
    band no longer qualifies for the unscaled ``f8e4m3`` class, while the
    scaled ``f8e4m3s`` class keeps the format eps regardless of amax (the
    per-tile scale recentres it).  ``None`` preserves the historical
    format-eps classification for every class.
    """
    lad = LADDERS[ladder][:max_classes]
    nt = tile_norms.shape[0]
    classes = np.zeros((nt, nt), dtype=np.int8)
    for j in range(nt):
        n_col = nt - j  # tiles in this column block
        for i in range(j, nt):
            if i == j:
                classes[i, j] = 0  # diagonal pinned high
                continue
            ratio = n_col * tile_norms[i, j] / max(matrix_norm, np.finfo(np.float64).tiny)
            amax = None if tile_amax is None else float(tile_amax[i, j])
            chosen = 0
            for c in range(len(lad) - 1, 0, -1):
                if ratio <= eps_target / class_eps(lad[c], amax):
                    chosen = c
                    break
            classes[i, j] = chosen
    return PrecisionPlan(classes, LADDERS[ladder][:max_classes], eps_target)


def tile_norms(tiles: np.ndarray) -> tuple[np.ndarray, float]:
    """Frobenius norms per tile + whole-matrix norm from a [Nt,Nt,tb,tb] store."""
    norms = np.sqrt((tiles.astype(np.float64) ** 2).sum(axis=(2, 3)))
    nt = norms.shape[0]
    total = 0.0
    for j in range(nt):
        for i in range(j, nt):
            w = 1.0 if i == j else 2.0  # symmetric: off-diag tiles count twice
            total += w * norms[i, j] ** 2
    return norms, float(np.sqrt(total))


def tile_amax(tiles: np.ndarray) -> np.ndarray:
    """Per-tile absolute maxima [Nt, Nt] from a [Nt,Nt,tb,tb] store —
    the store-time amax record the scaled-FP8 class keys its scales on."""
    return np.abs(tiles.astype(np.float64)).max(axis=(2, 3))


def scale_table(tiles: np.ndarray, plan: PrecisionPlan) -> np.ndarray:
    """The ``[Nt, Nt]`` float32 scale table that rides alongside a tile
    store holding scaled-FP8 tiles (docs/kernels.md).

    Entry ``(i, j)`` is the power-of-two factor a scaled-FP8 tile is
    multiplied by before the e4m3 down-cast (:func:`fp8_scale` of its
    amax) and divided by on promotion; tiles of every other class carry
    the neutral 1.0.  Executors recompute the entry whenever they round a
    tile through the scaled class (amax is tracked *at store time*, so
    the table follows the factorization), which keeps the table a pure
    function of ``(tiles, plan)`` — convenient for checkpoints and tests.
    """
    amax = tile_amax(tiles)
    nt = plan.nt
    out = np.ones((nt, nt), dtype=np.float32)
    for j in range(nt):
        for i in range(nt):
            if plan.name(i, j) == "f8e4m3s":
                out[i, j] = fp8_scale(float(amax[i, j]))
    return out
