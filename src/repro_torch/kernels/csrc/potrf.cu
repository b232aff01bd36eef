// Single-tile Cholesky factorization (POTRF) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/potrf.py, _potrf_kernel. The tile (f32 or
// bf16) is symmetrised, 0.5 * (A + A^T), and factored in f32: for column j,
// v = A[:, j] - L[:, :j] @ L[j, :j]^T and L[i, j] = v_i / sqrt(v_j) for
// i >= j. The strictly upper triangle of the result is zero and the result
// is cast to the input's type. A pivot that is not positive gives NaN from
// that column on, as the reference's sqrt does; nothing is clamped.
//
// What bounds it here: the column chain. The 512 x 512 factor is 45 MFLOP (a
// bound of 0.7 us), but column j needs columns 0..j-1. The first port ran the
// whole tile on one block, on one SM of 132, as n matrix-vector steps between
// block-wide barriers, reading L back from L2 at each step (3.9 ms at
// n = 512).
//
// What the design does about it: a right-looking blocked factor spread over
// the SMs, in one cooperative launch of a persistent grid (as fused_column.cu
// does), with grid.sync() between two phases for each diagonal block K of
// NB = 64 columns:
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
//      micro-tile of FFMAs a thread over the depth NB. Tiles of 32 rather
//      than 64 give the first step 105 tiles at n = 512 instead of 28, so
//      more SMs share the update and each tile's chain is shorter.
// The chain is n column steps in registers and shuffles (no global round
// trip a column) plus 2 n / NB - 2 grid barriers; the O(n^3) rest is
// register-tiled and spread over the SMs. The grid is as many blocks as the
// widest phase needs (kernels/potrf.py computes it; 105 at n = 512), capped
// at what the card holds at once. One block running the same blocked
// algorithm would need no grid barrier but would be bounded by one SM's
// FFMA rate (45 MFLOP at about 0.5 TFLOP/s is at least 90 us) and would run
// the panel solves one after another; the grid form is chosen for that.
//
// Storage: L is built in a global f32 workspace W (the output itself for f32
// tiles; kernels/potrf.py allocates it for bf16 tiles, which also receive
// each finished value in bf16). The first step reads the symmetrised tile
// from A (both triangles, as the reference does), later steps read W. Only
// lower entries are computed or read; the upper triangle of the output is
// zeroed once at the start. Every product is f32 FFMA (no TF32). The blocked
// order sums each entry's terms in another order than the column loop, and
// divides the panel rows by sqrt(v_j) as the reference does.
#include <cooperative_groups.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"
#include "tri_block.cuh"

namespace cg = cooperative_groups;

constexpr int POTRF_THREADS = 256;                    // mirrored by potrf.py
constexpr int POTRF_WARPS = POTRF_THREADS / 32;
constexpr int PER = NB * NB / POTRF_THREADS;          // phase A's loads a thread
constexpr int TT = 32;                                // trailing tile edge
constexpr int TM = 2, TN = 2;                         // a thread's micro-tile
constexpr int TX = TT / TN;                           // 16 threads across a tile
constexpr int PAD = TT + 4;                           // keeps float2 rows aligned
constexpr int TPER = TT * NB / POTRF_THREADS;         // a slice's loads a thread
static_assert(TX * (TT / TM) == POTRF_THREADS, "one 32 x 32 tile a block");

// Phase A's diagonal block, its factor and pivots, or phase B's two panel
// slices: the phases share one buffer.
struct PanelSmem {
  __align__(16) float p[2][NB][PAD];    // L_IK^T and L_JK^T, k-major
};
static size_t smem_bytes() {                          // mirrored by potrf.py
  const size_t a = sizeof(float) * (2 * NB * NB_LD + 2 * NB);
  return a > sizeof(PanelSmem) ? a : sizeof(PanelSmem);
}

// Element (i, k) of the matrix being factored: the symmetrised input at the
// first step, the workspace after it.
template <typename T>
__device__ __forceinline__ float src(const T* __restrict__ a, const float* w,
                                     int n, int i, int k, bool first) {
  return first ? 0.5f * (to_f32(a[(size_t)i * n + k]) +
                         to_f32(a[(size_t)k * n + i]))
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
template <typename T>
__device__ void trailing_tile(const T* __restrict__ a, float* work, int n,
                              int r0, int c0, int kb, bool first,
                              PanelSmem& ps) {
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  float acc[TM][TN], pi[TPER], pj[TPER];
#pragma unroll
  for (int q = 0; q < TPER; ++q) {
    const int e = tid + q * POTRF_THREADS, r = e / NB, k = e % NB;
    pi[q] = work[(size_t)min(r0 + r, n - 1) * n + kb + k];
    pj[q] = work[(size_t)min(c0 + r, n - 1) * n + kb + k];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = r0 + ty * TM + i, col = c0 + tx * TN + j;
      acc[i][j] = src(a, work, n, min(r, n - 1), min(col, n - 1), first);
    }
  __syncthreads();                      // the buffer's last readers are done
#pragma unroll
  for (int q = 0; q < TPER; ++q) {
    const int e = tid + q * POTRF_THREADS, r = e / NB, k = e % NB;
    ps.p[0][k][r] = pi[q];
    ps.p[1][k][r] = pj[q];
  }
  __syncthreads();
#pragma unroll 8
  for (int k = 0; k < NB; ++k) {
    const float2 av = *reinterpret_cast<const float2*>(&ps.p[0][k][ty * TM]);
    const float2 bv = *reinterpret_cast<const float2*>(&ps.p[1][k][tx * TN]);
    const float ar[TM] = {av.x, av.y};
    const float br[TN] = {bv.x, bv.y};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(-ar[i], br[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = r0 + ty * TM + i, col = c0 + tx * TN + j;
      if (r < n && col <= r) work[(size_t)r * n + col] = acc[i][j];
    }
}

// L_KK, the factored diagonal block in shared memory, into the workspace and
// (for bf16 tiles) the output.
template <typename T>
__device__ void store_block(const float* sd, float* work, T* out, int n,
                            int kb, int wd, bool own) {
  for (int e = threadIdx.x; e < NB * NB; e += POTRF_THREADS) {
    const int i = e / NB, k = e % NB;
    if (i < wd && k <= i) {
      const float v = sd[i * NB_LD + k];
      const size_t at = (size_t)(kb + i) * n + kb + k;
      work[at] = v;
      if (own) out[at] = from_f32<T>(v);
    }
  }
}

// `work` is an f32 [n, n] buffer; it is `out` itself when T is float.
template <typename T>
__global__ void __launch_bounds__(POTRF_THREADS)
    potrf_kernel(const T* __restrict__ a, float* work, T* out, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  PanelSmem& ps = *reinterpret_cast<PanelSmem*>(smem);            // phase B
  float* sa = reinterpret_cast<float*>(smem);     // phase A: NB x NB_LD block
  float* sd = sa + NB * NB_LD;                    // its factor L_KK
  float* piv = sd + NB * NB_LD;                   // NB pivots
  float* rpiv = piv + NB;                         // and their reciprocals
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nblk = gridDim.x, b = blockIdx.x;
  const bool own = static_cast<void*>(out) != static_cast<void*>(work);

  for (int i = b; i < n; i += nblk)               // zeros above the diagonal
    for (int k = i + 1 + tid; k < n; k += POTRF_THREADS)
      out[(size_t)i * n + k] = from_f32<T>(0.f);

  const int nt = (n + NB - 1) / NB;
  for (int kt = 0; kt < nt; ++kt) {
    const int kb = kt * NB, wd = min(NB, n - kb);
    const bool first = kt == 0;
    // A. the diagonal block, then the panel rows below it
    const int p0 = kb + wd;                       // first panel row
    if (b == 0 || p0 + b * POTRF_WARPS < n) {
      float v[PER];                     // every load at once, then the stores
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + q * POTRF_THREADS, i = e / NB, k = e % NB;
        v[q] = src(a, work, n, min(kb + i, n - 1), min(kb + k, n - 1), first);
      }
      __syncthreads();                  // the buffer's last readers are done
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + q * POTRF_THREADS, i = e / NB, k = e % NB;
        if (i < wd && k <= i) sa[i * NB_LD + k] = v[q];
      }
      chol_block(sa, sd, piv, wd);
      for (int c = tid; c < wd; c += POTRF_THREADS) rpiv[c] = 1.f / piv[c];
      __syncthreads();
      for (int i = p0 + b * POTRF_WARPS + warp; i < n; i += nblk * POTRF_WARPS) {
        float v0 = src(a, work, n, i, min(kb + lane, n - 1), first);
        float v1 = src(a, work, n, i, min(kb + lane + 32, n - 1), first);
        solve_row_block(v0, v1, sd, piv, rpiv, wd);
        const size_t at = (size_t)i * n + kb + lane;
        if (lane < wd) {
          work[at] = v0;
          if (own) out[at] = from_f32<T>(v0);
        }
        if (lane + 32 < wd) {
          work[at + 32] = v1;
          if (own) out[at + 32] = from_f32<T>(v1);
        }
      }
    }
    // block 0 writes L_KK once no block reads the diagonal block any more
    if (p0 >= n) {                                // no trailing matrix left
      if (b == 0) store_block(sd, work, out, n, kb, wd, own);
      break;
    }
    grid.sync();
    if (b == 0) store_block(sd, work, out, n, kb, wd, own);
    // B. the trailing lower 32 x 32 tiles (I, J), J <= I, below row p0
    const int mt = (n - p0 + TT - 1) / TT, tiles = mt * (mt + 1) / 2;
    for (int t = b; t < tiles; t += nblk) {
      int ii, jj;
      tri_index(t, ii, jj);
      trailing_tile(a, work, n, p0 + ii * TT, p0 + jj * TT, kb, first, ps);
    }
    grid.sync();
  }
}

template <typename T>
static int launch(const void* a, float* work, void* out, int n, int blocks,
                  size_t smem, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&potrf_kernel<T>);
  cudaError_t e;
  int dev, sms, coop, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, potrf_kernel<T>,
                                                         POTRF_THREADS, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // every block must be resident at once for grid.sync(): the grid is the
  // blocks the widest phase needs, at most what the card holds; each phase
  // walks its work grid-stride, so a smaller grid covers the same work
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  const T* pa = static_cast<const T*>(a);
  T* pout = static_cast<T*>(out);
  void* args[] = {&pa, &work, &pout, &n};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(POTRF_THREADS), args,
                                  smem, stream);
  return static_cast<int>(e);
}

// Lower Cholesky factor of the symmetrised tile. `work` is an f32 [n, n]
// buffer (pass `out` for f32 tiles); `blocks` and `smem` are the geometry
// kernels/potrf.py computed, and any other shared-memory size is refused.
// Returns the launch's cudaError_t.
extern "C" int potrf(const void* a, void* work, void* out, int n, int dtype,
                     int blocks, int smem, void* stream) {
  if (n <= 0 || blocks <= 0 || static_cast<size_t>(smem) != smem_bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case DT_F32:
      err = launch<float>(a, static_cast<float*>(work), out, n, blocks, smem, s);
      break;
    case DT_BF16:
      err = launch<__nv_bfloat16>(a, static_cast<float*>(work), out, n, blocks,
                                  smem, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
