// The blocked right-looking Cholesky factor of one n x n tile, run by a whole
// cooperative grid: the standalone POTRF kernel (potrf.cu) and the fused
// column step's factor phase (fused_column.cu) both call potrf_blocked.
//
// For each diagonal block K of NB = 64 columns, two phases split by
// grid.sync():
//   A. every block that has rows of the panel below K (and block 0) loads
//      the diagonal block into shared memory and factors it there
//      (chol_block: two 32-column halves, each by one warp in registers with
//      no barrier on its chain); then each warp solves one panel row at a
//      time against L_KK (solve_row_block). Factoring the 16 KiB block again
//      in each block costs less than a third grid barrier a step would.
//      Block 0 writes L_KK after the barrier, once no block reads it.
//   B. the trailing update in lower 32 x 32 tiles (I, J), J <= I, one tile
//      a block at a time, W_IJ -= L_IK L_JK^T: the tile's loads all issued
//      at once, the two panel slices in shared memory, a 2 x 2 register
//      micro-tile of FMAs a thread over the depth NB. Tiles of 32 rather
//      than 64 give the first step 105 tiles at n = 512 instead of 28, so
//      more SMs share the update and each tile's chain is shorter.
// The chain is n column steps in registers and shuffles (no global round
// trip a column) plus 2 n / NB - 2 grid barriers; the O(n^3) rest is
// register-tiled and spread over the SMs.
//
// Types: TA is the stored tile's type, TW the compute and workspace type
// (f32 for f32 and bf16 tiles in potrf.cu; f32 or f64 in the fused step).
// L is built in the workspace W. The first step reads the symmetrised tile
// 0.5 (A + A^T) from A (both triangles, as the reference does), later steps
// read W; only lower entries of W are computed or read into a result. The
// workspace may be A itself (the fused step factors its accumulator in
// place): the first step reads A's strictly upper triangle, which nothing
// writes, and each lower entry before it is overwritten. Where `out` is not
// the workspace (bf16 tiles) each finished value is also written there in
// TA. The blocked order sums each entry's terms in another order than the
// column loop, and divides the panel rows by sqrt(v_j) as the reference
// does.
#pragma once

#include <cooperative_groups.h>
#include <stddef.h>

#include "common.cuh"
#include "tri_block.cuh"

constexpr int PF_THREADS = 256;                     // mirrored by potrf.py
constexpr int PF_WARPS = PF_THREADS / 32;
constexpr int PF_PER = NB * NB / PF_THREADS;        // phase A's loads a thread
constexpr int PF_TT = 32;                           // trailing tile edge
constexpr int PF_TM = 2, PF_TN = 2;                 // a thread's micro-tile
constexpr int PF_TX = PF_TT / PF_TN;                // 16 threads across a tile
constexpr int PF_PAD = PF_TT + 4;                   // keeps the pair reads aligned
constexpr int PF_TPER = PF_TT * NB / PF_THREADS;    // a slice's loads a thread
static_assert(PF_TX * (PF_TT / PF_TM) == PF_THREADS, "one 32 x 32 tile a block");

// Phase A's diagonal block, its factor and pivots, or phase B's two panel
// slices: the phases share one buffer.
template <typename TW>
struct PanelSmem {
  __align__(16) TW p[2][NB][PF_PAD];    // L_IK^T and L_JK^T, k-major
};
template <typename TW>
constexpr size_t potrf_smem_bytes() {   // mirrored by potrf.py, fused_column.py
  return sizeof(TW) * (2 * NB * NB_LD + 2 * NB) > sizeof(PanelSmem<TW>)
             ? sizeof(TW) * (2 * NB * NB_LD + 2 * NB)
             : sizeof(PanelSmem<TW>);
}

__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void load2(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}

// Element (i, k) of the matrix being factored: the symmetrised input at the
// first step, the workspace after it.
template <typename TW, typename TA>
__device__ __forceinline__ TW pf_src(const TA* a, const TW* w, int n, int i,
                                     int k, bool first) {
  return first ? TW(0.5) * (widen<TW>(a[(size_t)i * n + k]) +
                            widen<TW>(a[(size_t)k * n + i]))
               : w[(size_t)i * n + k];
}

// (I', J') of the t-th lower tile, row by row: t = I'(I'+1)/2 + J'.
__device__ __forceinline__ void tri_index(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

// W_IJ -= L_IK L_JK^T for the lower 32 x 32 tile (I, J) at rows r0, columns
// c0, the panel at column kb: every load of the tile is issued at once (the
// seed and both panel slices), the slices go to shared memory k-major, and
// each thread runs a 2 x 2 register micro-tile over the depth NB. Only lower
// entries are stored.
template <typename TW, typename TA>
__device__ void pf_trailing_tile(const TA* a, TW* work, int n, int r0, int c0,
                                 int kb, bool first, PanelSmem<TW>& ps) {
  const int tid = threadIdx.x, tx = tid % PF_TX, ty = tid / PF_TX;
  TW acc[PF_TM][PF_TN], pi[PF_TPER], pj[PF_TPER];
#pragma unroll
  for (int q = 0; q < PF_TPER; ++q) {
    const int e = tid + q * PF_THREADS, r = e / NB, k = e % NB;
    pi[q] = work[(size_t)min(r0 + r, n - 1) * n + kb + k];
    pj[q] = work[(size_t)min(c0 + r, n - 1) * n + kb + k];
  }
#pragma unroll
  for (int i = 0; i < PF_TM; ++i)
#pragma unroll
    for (int j = 0; j < PF_TN; ++j) {
      const int r = r0 + ty * PF_TM + i, col = c0 + tx * PF_TN + j;
      acc[i][j] = pf_src(a, work, n, min(r, n - 1), min(col, n - 1), first);
    }
  __syncthreads();                      // the buffer's last readers are done
#pragma unroll
  for (int q = 0; q < PF_TPER; ++q) {
    const int e = tid + q * PF_THREADS, r = e / NB, k = e % NB;
    ps.p[0][k][r] = pi[q];
    ps.p[1][k][r] = pj[q];
  }
  __syncthreads();
#pragma unroll 8
  for (int k = 0; k < NB; ++k) {
    TW ar[PF_TM], br[PF_TN];
    load2(&ps.p[0][k][ty * PF_TM], ar);
    load2(&ps.p[1][k][tx * PF_TN], br);
#pragma unroll
    for (int i = 0; i < PF_TM; ++i)
#pragma unroll
      for (int j = 0; j < PF_TN; ++j) acc[i][j] = fma(-ar[i], br[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < PF_TM; ++i)
#pragma unroll
    for (int j = 0; j < PF_TN; ++j) {
      const int r = r0 + ty * PF_TM + i, col = c0 + tx * PF_TN + j;
      if (r < n && col <= r) work[(size_t)r * n + col] = acc[i][j];
    }
}

// L_KK, the factored diagonal block in shared memory, into the workspace and
// (where out is not the workspace) the output.
template <typename TW, typename TA>
__device__ void pf_store_block(const TW* sd, TW* work, TA* out, int n, int kb,
                               int wd, bool own) {
  for (int e = threadIdx.x; e < NB * NB; e += PF_THREADS) {
    const int i = e / NB, k = e % NB;
    if (i < wd && k <= i) {
      const TW v = sd[i * NB_LD + k];
      const size_t at = (size_t)(kb + i) * n + kb + k;
      work[at] = v;
      if (own) out[at] = narrow<TA>(v);
    }
  }
}

// Phase A of the step at column kb (width wd): factor the diagonal block into
// sd (pivots in piv), then the panel rows below it, warp by warp, grid-stride.
template <typename TW, typename TA>
__device__ __forceinline__ void pf_panel(const TA* a, TW* work, TA* out, int n, int kb, int wd,
                         bool first, bool own, TW* sa, TW* sd, TW* piv,
                         TW* rpiv) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nblk = gridDim.x, b = blockIdx.x;
  const int p0 = kb + wd;                       // first panel row
  TW v[PF_PER];                       // every load at once, then the stores
#pragma unroll
  for (int q = 0; q < PF_PER; ++q) {
    const int e = tid + q * PF_THREADS, i = e / NB, k = e % NB;
    v[q] = pf_src(a, work, n, min(kb + i, n - 1), min(kb + k, n - 1), first);
  }
  __syncthreads();                    // the buffer's last readers are done
#pragma unroll
  for (int q = 0; q < PF_PER; ++q) {
    const int e = tid + q * PF_THREADS, i = e / NB, k = e % NB;
    if (i < wd && k <= i) sa[i * NB_LD + k] = v[q];
  }
  chol_block(sa, sd, piv, wd);
  for (int c = tid; c < wd; c += PF_THREADS) rpiv[c] = TW(1) / piv[c];
  __syncthreads();
  for (int i = p0 + b * PF_WARPS + warp; i < n; i += nblk * PF_WARPS) {
    TW v0 = pf_src(a, work, n, i, min(kb + lane, n - 1), first);
    TW v1 = pf_src(a, work, n, i, min(kb + lane + 32, n - 1), first);
    solve_row_block(v0, v1, sd, piv, rpiv, wd);
    const size_t at = (size_t)i * n + kb + lane;
    if (lane < wd) {
      work[at] = v0;
      if (own) out[at] = narrow<TA>(v0);
    }
    if (lane + 32 < wd) {
      work[at + 32] = v1;
      if (own) out[at + 32] = narrow<TA>(v1);
    }
  }
}

// The factor of the symmetrised n x n tile at a into work (and out, where
// it is not work), by every block of the cooperative grid; smem holds
// potrf_smem_bytes<TW>(). It returns without a final grid barrier: block 0
// wrote the last diagonal block, and every other entry was written before
// the last barrier. The strict upper triangle of out is not touched.
template <typename TW, typename TA>
__device__ __forceinline__ void potrf_blocked(const TA* a, TW* work, TA* out, int n,
                              unsigned char* smem) {
  namespace cg = cooperative_groups;
  PanelSmem<TW>& ps = *reinterpret_cast<PanelSmem<TW>*>(smem);     // phase B
  TW* sa = reinterpret_cast<TW*>(smem);     // phase A: NB x NB_LD block
  TW* sd = sa + NB * NB_LD;                 // its factor L_KK
  TW* piv = sd + NB * NB_LD;                // NB pivots
  TW* rpiv = piv + NB;                      // and their reciprocals
  cg::grid_group grid = cg::this_grid();
  const int nblk = gridDim.x, b = blockIdx.x;
  const bool own = static_cast<const void*>(out) != static_cast<const void*>(work);

  const int nt = (n + NB - 1) / NB;
  for (int kt = 0; kt < nt; ++kt) {
    const int kb = kt * NB, wd = min(NB, n - kb);
    const bool first = kt == 0;
    // A. the diagonal block, then the panel rows below it
    const int p0 = kb + wd;                     // first panel row
    if (b == 0 || p0 + b * PF_WARPS < n)
      pf_panel(a, work, out, n, kb, wd, first, own, sa, sd, piv, rpiv);
    // block 0 writes L_KK once no block reads the diagonal block any more
    if (p0 >= n) {                              // no trailing matrix left
      if (b == 0) pf_store_block(sd, work, out, n, kb, wd, own);
      break;
    }
    grid.sync();
    if (b == 0) pf_store_block(sd, work, out, n, kb, wd, own);
    // B. the trailing lower 32 x 32 tiles (I, J), J <= I, below row p0
    const int mt = (n - p0 + PF_TT - 1) / PF_TT, tiles = mt * (mt + 1) / 2;
    for (int t = b; t < tiles; t += nblk) {
      int ii, jj;
      tri_index(t, ii, jj);
      pf_trailing_tile(a, work, n, p0 + ii * PF_TT, p0 + jj * PF_TT, kb, first,
                       ps);
    }
    grid.sync();
  }
}
