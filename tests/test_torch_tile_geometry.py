"""Launch geometry of the blocked POTRF and TRSM kernels, of the cluster
split-K SYRK and GEMM, and of the fused column step's phases, on the CPU.

The wrappers ``repro_torch.kernels.potrf``, ``trsm``, ``syrk``,
``mxp_gemm`` and ``fused_column`` compute each launch's geometry as plain
functions (rows a block, blocks, shared memory a block, the cooperative
grid, the split of K over a cluster, each phase's work list) and the CUDA
sources refuse any other (for the fused step: its shared memory and the
lengths of its wave's and its solves' work lists, whose order the kernel
decodes as these functions list it), so these checks hold what the card
runs: the shared memory stays within a block's 232,448 bytes
(hopper-kernels guide, section 1) at every size the wrappers accept, and
each row, column and tile of the work is covered exactly once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, fused_column, mxp_gemm, potrf, syrk, trsm

SMEM_LIMIT = 232_448        # bytes of shared memory a block can have (H100)
RAGGED = [1, 31, 33, 63, 64, 65, 100, 257, 511, 512, 513, 1000]


def test_potrf_shared_memory_fits_every_n():
    # one buffer whatever n: phase A's block and factor, or phase B's slices
    assert potrf.smem_bytes() <= SMEM_LIMIT
    phase_a = 4 * (2 * potrf.NB * (potrf.NB + 1) + 2 * potrf.NB)
    assert potrf.smem_bytes() == max(phase_a, 4 * 2 * potrf.NB * potrf.PAD)


def test_trsm_shared_memory_fits_every_n():
    sizes = np.array([trsm.smem_bytes(n) for n in range(1, trsm.MAX_N + 1)])
    assert sizes.max() == trsm.smem_bytes(trsm.MAX_N) <= SMEM_LIMIT
    assert (np.diff(sizes) == 4 * trsm.ROWS).all()


def test_potrf_blocks_needed_every_n():
    """The grid holds the widest phase of every step: the panel's rows at
    WARPS a block, or the trailing TT x TT tiles at one a block."""
    for n in range(1, potrf.MAX_N + 1):
        widest = 1
        for kb, width in potrf.steps(n):
            rows = n - kb - width
            mt = -(-rows // potrf.TT)
            widest = max(widest, -(-rows // potrf.WARPS), mt * (mt + 1) // 2)
        assert potrf.blocks_needed(n) == widest, n
    assert potrf.blocks_needed(512) == 105


@pytest.mark.parametrize("n", list(range(1, potrf.MAX_N + 1, 97)) + [potrf.MAX_N])
def test_potrf_steps_cover_columns_once(n):
    cols = np.zeros(n, int)
    for kb, width in potrf.steps(n):
        assert 1 <= width <= potrf.NB and kb % potrf.NB == 0
        cols[kb:kb + width] += 1
    assert (cols == 1).all()


def _potrf_final_writes(n, grid):
    """How often each entry of the factor gets its final value: in phase A
    of the step that owns its column, from the diagonal block (block 0) or
    a panel row (the warp of the block that owns the row)."""
    count = np.zeros((n, n), int)
    for kb, width in potrf.steps(n):
        count[kb:kb + width, kb:kb + width][np.tril_indices(width)] += 1
        for b in range(grid):
            for i in potrf.panel_rows(n, kb, width, b, grid):
                count[i, kb:kb + width] += 1
    return count


@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("grid", ["needed", 1, 7, 132])
def test_potrf_every_lower_entry_once(n, grid):
    grid = potrf.blocks_needed(n) if grid == "needed" else grid
    count = _potrf_final_writes(n, grid)
    assert (np.tril(count) == np.tril(np.ones((n, n), int))).all()
    assert not np.triu(count, 1).any()


@pytest.mark.parametrize("n", RAGGED + [1024, 2048])
@pytest.mark.parametrize("grid", ["needed", 1, 132, 264])
def test_potrf_trailing_tiles_once(n, grid):
    """Each step's trailing update writes every lower entry of the trailing
    matrix once (TT x TT tiles, block t % grid taking tile t, only entries
    on or below the diagonal stored), and the panel's rows are solved once
    each (a warp a row). The fused column step runs the same steps on its
    diagonal tile (tb up to 1024) over its cooperative grid (264 blocks at
    tb = 512 on 132 SMs)."""
    grid = potrf.blocks_needed(n) if grid == "needed" else grid
    tt = potrf.TT
    for kb, width in potrf.steps(n):
        p0 = kb + width
        tiles = potrf.trailing_tiles(n, kb)
        count = np.zeros((n, n), int)
        for b in range(grid):
            for r0, c0 in tiles[b::grid]:
                assert c0 <= r0 and (r0 - p0) % tt == 0 and (c0 - p0) % tt == 0
                count[r0:r0 + tt, c0:c0 + tt] += 1
        count = np.tril(count)
        want = np.zeros((n, n), int)
        want[p0:, p0:] = np.tril(np.ones((n - p0, n - p0), int))
        assert (count == want).all()
        rows = np.zeros(n, int)
        for b in range(grid):
            for i in potrf.panel_rows(n, kb, width, b, grid):
                rows[i] += 1
        assert (rows[p0:] == 1).all() and not rows[:p0].any()


@pytest.mark.parametrize("m", [1, 3, 4, 5, 7, 512, 700, 4097])
def test_trsm_rows_once(m):
    rows = np.zeros(m, int)
    for b in range(trsm.blocks(m)):
        r = trsm.block_rows(m, b)
        assert 1 <= len(r) <= trsm.ROWS
        rows[r.start:r.stop] += 1
    assert (rows == 1).all()
    assert trsm.blocks(512) == 128


def test_trsm_columns_once_every_n():
    for n in range(1, trsm.MAX_N + 1):
        blocks = trsm.column_blocks(n)
        assert [j0 for j0, _ in blocks] == list(range(0, n, trsm.NB))
        assert sum(w for _, w in blocks) == n
        assert all(1 <= w <= trsm.NB for _, w in blocks)
        # every column of the panel left of a block lies in whole chunks
        assert all(j0 % trsm.KC == 0 for j0, _ in blocks)


@pytest.mark.parametrize("kernel,args", [
    ("potrf", lambda n: (torch.eye(n),)),
    ("trsm", lambda n: (torch.eye(n), torch.ones(2, n))),
])
def test_limits_hold(monkeypatch, kernel, args):
    """Past MAX_N the wrapper refuses a CUDA tensor before any launch;
    the limits stay those of the first kernels."""
    mod = {"potrf": potrf, "trsm": trsm}[kernel]
    assert mod.MAX_N == {"potrf": 6144, "trsm": 4096}[kernel]
    monkeypatch.setattr(_build, "on_cuda", lambda *a: True)
    fn = getattr(mod, kernel)
    with pytest.raises(ValueError, match="exceeds"):
        fn(*args(mod.MAX_N + 1))


# --------------------------------------------------------------------------
# SYRK: lower blocks, K chunks of a cluster, rows each rank writes
# --------------------------------------------------------------------------

SYRK_SIZES = [1, 31, 33, 63, 64, 65, 100, 257, 511, 512, 513, 1000, 4096]


@pytest.mark.parametrize("m", SYRK_SIZES)
def test_syrk_every_lower_block_once(m):
    nb = -(-m // syrk.TILE)
    count = np.zeros((nb, nb), int)
    for t in range(syrk.blocks(m)):
        bi, bj = syrk.block_of(t)
        assert 0 <= bj <= bi < nb
        count[bi, bj] += 1
    assert (count == np.tril(np.ones((nb, nb), int))).all()
    # every entry of the output: a lower block's own, or its mirror
    cover = np.zeros((nb * syrk.TILE,) * 2, int)
    for t in range(syrk.blocks(m)):
        bi, bj = syrk.block_of(t)
        r, c = bi * syrk.TILE, bj * syrk.TILE
        cover[r:r + syrk.TILE, c:c + syrk.TILE] += 1
        if bi > bj:
            cover[c:c + syrk.TILE, r:r + syrk.TILE] += 1
    assert (cover[:m, :m] == 1).all()


@pytest.mark.parametrize("k", SYRK_SIZES + [128, 129, 384, 385])
def test_syrk_every_k_chunk_once(k):
    split, chunk = syrk.split_for(k)
    assert 1 <= split <= syrk.MAX_SPLIT and chunk % syrk.KS == 0
    cols = np.zeros(k, int)
    for lo, hi in syrk.chunk_bounds(k, split, chunk):
        assert lo < hi and lo % syrk.KS == 0     # no rank is idle
        cols[lo:hi] += 1
    assert (cols == 1).all()
    # the conditions csrc/syrk.cu checks before it launches
    assert split * chunk >= k > (split - 1) * chunk


def test_syrk_split_at_the_main_path_tile():
    """tb = 512: 36 lower blocks of four CTAs each, 144 CTAs, all resident
    on the 132 SMs at two a SM; small K keeps one CTA a block."""
    assert syrk.blocks(512) == 36
    assert syrk.split_for(512) == (4, 128)
    assert syrk.blocks(512) * syrk.split_for(512)[0] == 144
    assert [syrk.split_for(k)[0] for k in (1, 31, 33, 100, 128)] == [1] * 5


@pytest.mark.parametrize("split", range(1, 9))
def test_syrk_share_rows_partition_the_block(split):
    rows = np.zeros(syrk.TILE, int)
    for rank in range(split):
        r = syrk.share_rows(rank, split)
        assert len(r) >= syrk.TILE // split
        rows[r.start:r.stop] += 1
    assert (rows == 1).all()


# --------------------------------------------------------------------------
# GEMM: output tiles, K chunks of a cluster, rows each rank writes, memory
# --------------------------------------------------------------------------

GEMM_SIZES = [1, 31, 33, 63, 64, 65, 100, 128, 129, 257, 512, 513, 1000]


@pytest.mark.parametrize("m", GEMM_SIZES)
@pytest.mark.parametrize("n", GEMM_SIZES)
def test_gemm_every_output_tile_once(m, n):
    """The kernel's tile t = blockIdx.x / split covers rows and columns
    from tile_origin; every entry of the output lies in exactly one tile."""
    bm, bn = mxp_gemm.BM, mxp_gemm.BN
    tm, tn = mxp_gemm.tiles(m, n)
    cover = np.zeros((tm * bm, tn * bn), int)
    for t in range(tm * tn):
        r0, c0 = mxp_gemm.tile_origin(t, m, n)
        assert r0 < m and c0 < n
        cover[r0:r0 + bm, c0:c0 + bn] += 1
    assert (cover[:m, :n] == 1).all()


@pytest.mark.parametrize("k", GEMM_SIZES + [4096])
def test_gemm_every_k_column_in_one_chunk(k):
    """Every K column lies in exactly one rank's chunk, and no chunk is
    empty, at the wrapper's split for several output shapes and at every
    forced split 1-8; the conditions csrc/mxp_gemm.cu checks hold."""
    splits = {mxp_gemm.split_for(m, m, k) for m in (1, 100, 512, 1000)}
    splits |= {mxp_gemm.split_for(512, 512, k, s) for s in range(1, 9)}
    for split, chunk in splits:
        assert 1 <= split <= mxp_gemm.MAX_SPLIT and chunk % mxp_gemm.KS == 0
        cols = np.zeros(k, int)
        for lo, hi in mxp_gemm.chunk_bounds(k, split, chunk):
            assert lo < hi                         # no rank is idle
            cols[lo:hi] += 1
        assert (cols == 1).all()
        assert split * chunk >= k > (split - 1) * chunk


def test_gemm_geometry_at_the_main_path_tile():
    """512^3: 128 x 64 tiles (8 x 4 values a thread), split 8, 256 CTAs,
    two resident a SM (132 SMs); small K keeps one CTA a tile."""
    geo = mxp_gemm.geometry(512, 512, 512)
    assert geo["micro"] == (8, 4) and geo["split"] == 8
    assert geo["chunk"] == 64 and geo["ctas"] == 256 <= 2 * 132
    assert [mxp_gemm.split_for(512, 512, k)[0] for k in (1, 31, 64)] == [1] * 3


@pytest.mark.parametrize("split", range(1, 9))
def test_gemm_share_rows_partition_the_tile(split):
    bm = mxp_gemm.BM
    rows = np.zeros(bm, int)
    for rank in range(split):
        r = mxp_gemm.share_rows(rank, split)
        assert len(r) >= bm // split
        rows[r.start:r.stop] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_gemm_shared_memory_fits(itemsize):
    """The stages of every operand type, or the f32 partial sums, within a
    block's limit at every size (the geometry does not depend on M, N, K),
    two CTAs within the SM's 228 KiB."""
    smem = mxp_gemm.smem_bytes(itemsize)
    assert smem >= mxp_gemm.BM * (mxp_gemm.BN + 16) * 4
    assert smem <= SMEM_LIMIT
    assert 2 * (smem + 1024) <= 228 * 1024


# --------------------------------------------------------------------------
# the fused column step: the phases' work lists and the shared memory
# --------------------------------------------------------------------------

FUSED_TB = [64, 128, 192, 512, 1024]
_FUSED_DT = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", _FUSED_DT)
@pytest.mark.parametrize("tb", FUSED_TB)
def test_fused_wave_covers_every_entry_once(tb, dtype):
    r_tiles = 3
    bm, bn = fused_column.wave_tile(dtype)
    cover = np.zeros((r_tiles, tb + bm, tb + bn), int)
    for r, m0, n0 in fused_column.wave_items(r_tiles, tb, dtype):
        assert m0 < tb and n0 < tb
        cover[r, m0:m0 + bm, n0:n0 + bn] += 1
    assert (cover[:, :tb, :tb] == 1).all()


@pytest.mark.parametrize("with_diag", [True, False])
@pytest.mark.parametrize("tb", FUSED_TB)
def test_fused_solves_cover_every_row_once(tb, with_diag):
    r_tiles = 5
    rows = np.zeros((r_tiles, tb), int)
    for r, g in fused_column.solve_items(r_tiles, tb, with_diag):
        rows[r, g:g + fused_column.SOLVE_ROWS] += 1
    first = 1 if with_diag else 0
    assert (rows[first:] == 1).all() and not rows[:first].any()
    assert len(fused_column.solve_items(32, 512, True)) == 31 * 64


@pytest.mark.parametrize("dtype", _FUSED_DT)
def test_fused_shared_memory_fits_every_tb(dtype):
    """The largest phase's shared memory at every tile size the wrapper
    takes, within a block's limit; at the main path's tb = 512 two blocks
    fit a SM in f32 and in f64."""
    item = 4 if dtype == torch.float32 else 8
    for tb in range(64, fused_column.MAX_TB + 1, 64):
        smem = fused_column.smem_bytes(tb, dtype)
        solve = item * (8 * tb + 2 * 64 * 65 + 128)
        assert smem >= solve and smem <= SMEM_LIMIT, (tb, smem)
    assert 2 * (fused_column.smem_bytes(512, dtype) + 1024) <= 228 * 1024
    assert fused_column.smem_bytes(512, torch.float32) == 55296
