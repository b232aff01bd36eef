// One fused column step of the tile Cholesky in one launch, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_column.py, _fused_kernel (with _chol_tile,
// _trsm_tile, _epilogue, _round_class and _fp8_scale_of). For R output tiles
// of one column step:
//   1. the update wave, acc_r = C_r - sum_k H[r, k] @ B[k]^T, for every row r;
//   2. with_diag: row 0 is factored (POTRF of 0.5 (acc + acc^T)) and rounded
//      through its storage class; that rounded factor is what the rows solve
//      against, as the unfused executor reads it back after its STORE;
//   3. the rows solve X L^T = acc_r against it (or against l_kk);
//   4. each row is rounded through its storage class (the epilogue).
// Everything runs in T, the tiles' own type: f32 (FFMA) or f64 (FP64 FMA).
//
// What bounds it here: operations. At the main path's 512 x 512 tiles, a
// mid-factorization step (R = K = 32) is 2.7e11 flops of the wave against
// 1.1 GB of f32 history, 240 flops a byte, far above the card's f32 ridge of
// 20 (67 TFLOP/s over 3.35 TB/s; f64 has the same peak on its tensor cores,
// which this kernel's FP64 FMA loop does not use). After the wave, the factor
// and the row solves are dependence chains (column by column), bound by
// latency, not by a rate.
//
// The race: the Pallas grid runs in order on one core, so the diagonal row's
// factor sits in VMEM scratch before any row solve reads it. CUDA blocks run
// concurrently. This kernel is one cooperative launch of a persistent grid
// (as many blocks as fit on the card at once, from the occupancy query at the
// largest phase's shared memory), and cooperative_groups' grid.sync()
// separates the phases. Within a phase each block takes work items
// grid-stride. A 512 x 512 f64 accumulator is 2 MiB, far beyond a block's
// 227 KB of shared memory, so the accumulators are the output tiles in device
// memory (L2-resident at this size): the wave writes acc into out, and the
// factor, the solves and the epilogue then work on out in place.
//
// What the design does about it, phase by phase (the work lists are
// kernels/fused_column.py's wave_items and solve_items, whose lengths the C
// entry checks, and for the factor potrf.py's steps, panel_rows and
// trailing_tiles):
//   1. the wave runs the port's one FFMA main loop (ffma_tile.cuh) in T: a
//      block owns a 128 x 64 output block in f32 (8 x 4 values a thread) or
//      64 x 64 in f64 (4 x 4), and streams H[r, kk] and B[kk] through two
//      cp.async stages, history tile after history tile, the accumulator in
//      registers across the whole history;
//   2. the factor is potrf.cu's blocked right-looking factor
//      (potrf_blocked.cuh) run by the whole grid on out[0] in place, in T:
//      for each 64-column diagonal block, every block with panel rows factors
//      the diagonal block in registers (chol_block) and solves its panel rows
//      (solve_row_block), then the trailing 32 x 32 lower tiles spread over
//      the grid, 2 tb / 64 - 2 grid barriers in all; block 0 then zeroes the
//      strict upper triangle and rounds the factor through row 0's class;
//   3. the row solves are trsm.cu's blocked walk: an item is SOLVE_ROWS = 8
//      rows of one tile (one a warp in the solve), grid-stride over (tile,
//      row group) for every later tile; the item's rows of X live k-major in
//      shared memory, L is read as one sequence of 64 x 64 chunks (a register
//      double buffer), the update from the solved columns is register-tiled
//      (each lane holds the eight rows at two columns, the warps split each
//      chunk's k) and each 64-column block ends in solve_row_block against
//      L_JJ;
//   4. the epilogue, one block a tile, as before.
//
// Rounding follows the port's class round (repro_torch/kernels/ref.py,
// _round), bitwise: f16 from f64 rounds once (through an f32 rounded to
// odd); bf16 and fp8 from f64 go through a round-to-nearest f32 as PyTorch's
// casts do; unscaled e4m3 gives NaN past 464 and rounds to nearest even up to
// it; the scaled class multiplies by the power-of-two scale of the tile's
// amax (frexp form) before the cast and divides after.
#include <cooperative_groups.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <cuda_fp16.h>

#include "common.cuh"
#include "ffma_tile.cuh"
#include "potrf_blocked.cuh"
#include "tri_block.cuh"

namespace cg = cooperative_groups;

constexpr int THREADS = 256;            // every phase: 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_ROWS = 256;           // mirrored by fused_column.py
constexpr int MAX_TB = 1024;            // mirrored by fused_column.py
constexpr int SOLVE_ROWS = NWARPS;      // rows a solve item, one a warp
constexpr int KC = NB;                  // the solve's chunk of L's panel
constexpr int SPER = NB * KC / THREADS; // a chunk's values a thread
static_assert(FFMA_THREADS == THREADS && PF_THREADS == THREADS, "one block shape");
static_assert(SOLVE_ROWS == 8, "the update reads x_k of the rows as two fours");

// the wave's tile: f32 8 x 4 values a thread (128 x 64), f64 4 x 4 (64 x 64);
// mirrored by fused_column.py (WAVE)
template <typename T> struct Wave;
template <> struct Wave<float> { using G = FfmaTile<float, 8, 4, 32>; };
template <> struct Wave<double> { using G = FfmaTile<double, 4, 4, 16>; };

// shared memory a block: the largest phase's (mirrored by fused_column.py)
template <typename T>
static size_t fused_smem_bytes(int tb) {
  size_t s = Wave<T>::G::SMEM_BYTES;
  const size_t factor = potrf_smem_bytes<T>();
  const size_t solve = sizeof(T) * ((size_t)SOLVE_ROWS * tb + KC * NB_LD +
                                    NB * NB_LD + 2 * NB);
  const size_t red = (NWARPS + 1) * sizeof(T);
  if (factor > s) s = factor;
  if (solve > s) s = solve;
  if (red > s) s = red;
  return s;
}

// the lengths of the wave's and the solves' work lists (mirrored by
// fused_column.py's wave_items and solve_items): output blocks of every row,
// and SOLVE_ROWS rows of every tile after the diagonal (every tile without it)
template <typename T>
__host__ __device__ inline int n_wave_items(int r_tiles, int tb) {
  using G = typename Wave<T>::G;
  return r_tiles * ((tb + G::BM - 1) / G::BM) * ((tb + G::BN - 1) / G::BN);
}
__host__ __device__ inline int n_solve_items(int r_tiles, int tb, int with_diag) {
  return (r_tiles - (with_diag ? 1 : 0)) * (tb / SOLVE_ROWS);
}

// storage classes, mirrored by fused_column.py (CLASS_CODES); -1 = none
enum Cls : int { C_F64 = 0, C_F32 = 1, C_F16 = 2, C_BF16 = 3, C_E4M3 = 4,
                 C_E4M3S = 5 };

template <typename T>
struct Params {
  const T* c;       // [R, tb, tb]
  const T* hist;    // [R, K, tb, tb]
  const T* bhist;   // [K, tb, tb]
  const T* lkk;     // [tb, tb]
  T* out;           // [R, tb, tb]: the accumulators, then the result
  int R, K, tb, with_diag;
  int cls[MAX_ROWS];
};

// NaN-propagating max, as torch.amax and jnp.max reduce
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// ---------------------------------------------------------------- phase 1
// One output block of one row: out = C - sum_kk H[r, kk] @ B[kk]^T on the
// shared FFMA main loop in T; the history is K tiles of tb columns each,
// walked stage by stage.
template <typename T>
__device__ void wave_block(const Params<T>& p, int r, int m0, int n0, T* smem) {
  using G = typename Wave<T>::G;
  const int tb = p.tb;
  const size_t tile = (size_t)tb * tb;
  T acc[G::TM][G::TN];
  ffma_seed<G>(acc, p.c + r * tile, tb, tb, tb, m0, n0);
  const int per_tile = tb / G::KS;
  const T* a0 = p.hist + (size_t)r * p.K * tile + (size_t)m0 * tb;
  const T* b0 = p.bhist + (size_t)n0 * tb;
  ffma_mainloop<G>(acc, p.K * per_tile, smem, [&](int s, T* st) {
    const int kk = s / per_tile, k0 = (s - kk * per_tile) * G::KS;
    ffma_stage_rows<G, true, G::BM>(st, a0 + kk * tile, tb, tb - m0, k0, tb);
    ffma_stage_rows<G, true, G::BN>(st + G::A_ELEMS, b0 + kk * tile, tb,
                                    tb - n0, k0, tb);
  });
  T* o = p.out + r * tile;
  const int tx = ffma_tx(), ty = ffma_ty();
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < G::TN; ++j) {
      const int row = m0 + ty + FFMA_SIDE * i, col = n0 + tx + FFMA_SIDE * j;
      if (row < tb && col < tb) o[(size_t)row * tb + col] = acc[i][j];
    }
  __syncthreads();                      // the next block's loads reuse smem
}

// ---------------------------------------------------------------- rounding
// f64 -> f32 rounded to odd: a later f32 -> f16 round then equals the
// one-step f64 -> f16 round (repro_torch/kernels/ref.py, _f32_round_to_odd)
__device__ __forceinline__ float f32_round_to_odd(double x) {
  const float t = __double2float_rz(x);
  if ((double)t != x && isfinite(__double2float_rn(x)))
    return __int_as_float(__float_as_int(t) | 1);
  return t;
}

__device__ __forceinline__ float to_f16(float x) {
  return __half2float(__float2half_rn(x));
}
__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// e4m3 round to nearest even with NaN past 464 (the reference's cast);
// inside the band a saturating hardware cast of the clamped value is exact
__device__ __forceinline__ float to_e4m3(float y) {
  if (!(fabsf(y) <= 464.f)) return __int_as_float(0x7fc00000);
  const __nv_fp8_e4m3 q(fminf(fmaxf(y, -448.f), 448.f));
  return static_cast<float>(q);
}

__device__ __forceinline__ float round_class(float x, int cls, float s) {
  switch (cls) {
    case C_F16: return to_f16(x);
    case C_BF16: return to_bf16(x);
    case C_E4M3: return to_e4m3(x);
    case C_E4M3S: return to_e4m3(x * s) / s;
    default: return x;               // f64 and f32 leave f32 unchanged
  }
}
__device__ __forceinline__ double round_class(double x, int cls, double s) {
  switch (cls) {
    case C_F32: return (double)__double2float_rn(x);
    case C_F16: return (double)__half2float(__float2half_rn(f32_round_to_odd(x)));
    case C_BF16: return (double)to_bf16(__double2float_rn(x));
    case C_E4M3: return (double)to_e4m3(__double2float_rn(x));
    case C_E4M3S: return (double)to_e4m3(__double2float_rn(x * s)) / s;
    default: return x;
  }
}

// the scaled class's power-of-two scale (repro.core.precision.fp8_scale)
template <typename T>
__device__ __forceinline__ T fp8_scale(T amax) {
  if (!(amax > T(0)) || !isfinite(amax)) return T(1);
  int e;
  const T m = frexp(amax, &e);
  return ldexp(T(1), (8 - e) + (m <= T(0.875) ? 1 : 0));
}

// Round one [tb, tb] tile through its class in place; the whole block calls
// it (the scaled class reduces the tile's amax across the block).
template <typename T>
__device__ void epilogue_tile(T* x, int n, int cls, T* red) {
  if (cls < 0 || cls == C_F64 || (cls == C_F32 && sizeof(T) == 4)) return;
  const size_t total = (size_t)n * n;
  T s = T(1);
  if (cls == C_E4M3S) {
    T m = T(0);
    for (size_t e = threadIdx.x; e < total; e += THREADS) m = nan_max(m, T(fabs(x[e])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      T mm = red[0];
      for (int w = 1; w < NWARPS; ++w) mm = nan_max(mm, red[w]);
      red[NWARPS] = mm;
    }
    __syncthreads();
    s = fp8_scale(red[NWARPS]);
    __syncthreads();
  }
  for (size_t e = threadIdx.x; e < total; e += THREADS) x[e] = round_class(x[e], cls, s);
  __syncthreads();
}

// ---------------------------------------------------------------- phase 2
// Block 0 after the factor: the strict upper triangle of the factor to zero
// (the blocked factor never writes it; its first step read the accumulator's
// upper half), then the class round of the whole tile.
template <typename T>
__device__ void finish_factor(T* l, int n, int cls, T* red) {
  __syncthreads();                      // block 0's last diagonal block
  for (int i = 0; i < n; ++i)
    for (int k = i + 1 + threadIdx.x; k < n; k += THREADS) l[(size_t)i * n + k] = T(0);
  __syncthreads();
  epilogue_tile(l, n, cls, red);
}

// ---------------------------------------------------------------- phase 3
// pre[4 q + i] = L[j0 + jj][kc + kk + i] of a 64 x 64 chunk, (jj, kk) the
// q-th four-element slot of this thread; tb is a multiple of 64, so every
// slot lies inside L.
template <typename T>
__device__ __forceinline__ void load_chunk(T (&pre)[SPER], const T* __restrict__ l,
                                           int n, int j0, int kc) {
#pragma unroll
  for (int q = 0; q < SPER / 4; ++q) {
    const int e = threadIdx.x + q * THREADS, jj = e / (KC / 4);
    const int kk = e % (KC / 4) * 4;
    T v[4];
    load4(l + (size_t)(j0 + jj) * n + kc + kk, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) pre[4 * q + i] = v[i];
  }
}

// SOLVE_ROWS rows x of one tile (row stride n) solve x L^T = x in place, by
// the block: trsm.cu's blocked walk in T, with eight rows an item.
template <typename T>
__device__ void solve_rows(const T* __restrict__ l, T* x, int n, T* sm) {
  T* sx = sm;                           // n x SOLVE_ROWS: X, k-major
  T* sl = sx + SOLVE_ROWS * n;          // KC x NB_LD: L[j0+jj][kc+kk] at (kk, jj)
  T* red = sl;                          // the warps' partial sums, after a walk
  T* sd = sl + KC * NB_LD;              // NB x NB_LD: L_JJ, lower triangle
  T* dg = sd + NB * NB_LD;              // NB: L_JJ's diagonal
  T* rg = dg + NB;                      // NB: its reciprocals
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  T pre[SPER];
  load_chunk(pre, l, n, 0, 0);
  for (int e = tid; e < SOLVE_ROWS * n; e += THREADS) {
    const int r = e / n, k = e % n;
    sx[k * SOLVE_ROWS + r] = x[(size_t)r * n + k];
  }
  for (int j0 = 0; j0 < n; j0 += NB) {
    T acc[SOLVE_ROWS][2];
#pragma unroll
    for (int r = 0; r < SOLVE_ROWS; ++r) acc[r][0] = acc[r][1] = T(0);
    for (int kc = 0; kc <= j0; kc += KC) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < SPER; ++q) {  // element (i, kc + k) of the chunk
        const int e = tid + q / 4 * THREADS, i = e / (KC / 4);
        const int k = e % (KC / 4) * 4 + q % 4;
        if (kc < j0) {                  // a chunk of the panel, transposed
          sl[k * NB_LD + i] = pre[q];
        } else if (k <= i) {            // L_JJ: its lower triangle
          sd[i * NB_LD + k] = pre[q];
          if (k == i) {
            dg[i] = pre[q];
            rg[i] = T(1) / pre[q];
          }
        }
      }
      if (kc < j0) load_chunk(pre, l, n, j0, kc + KC);
      else if (j0 + NB < n) load_chunk(pre, l, n, j0 + NB, 0);
      __syncthreads();
      if (kc == j0) break;
      // the update from the solved columns < j0: each lane accumulates the
      // item's eight rows at its two columns over every eighth k
#pragma unroll 4
      for (int kk = warp; kk < KC; kk += NWARPS) {
        T xr[SOLVE_ROWS / 4][4];        // x_k of the eight rows
        load4(&sx[(kc + kk) * SOLVE_ROWS], xr[0]);
        load4(&sx[(kc + kk) * SOLVE_ROWS + 4], xr[1]);
        const T l0 = sl[kk * NB_LD + lane], l1 = sl[kk * NB_LD + lane + 32];
#pragma unroll
        for (int r = 0; r < SOLVE_ROWS; ++r) {
          acc[r][0] = fma(xr[r / 4][r % 4], l0, acc[r][0]);
          acc[r][1] = fma(xr[r / 4][r % 4], l1, acc[r][1]);
        }
      }
    }
    if (j0 > 0) {
#pragma unroll
      for (int r = 0; r < SOLVE_ROWS; ++r) {
        red[(warp * SOLVE_ROWS + r) * NB + lane] = acc[r][0];
        red[(warp * SOLVE_ROWS + r) * NB + lane + 32] = acc[r][1];
      }
      __syncthreads();
    }
    // each warp solves its row against L_JJ
    T s0 = T(0), s1 = T(0);
    if (j0 > 0)
      for (int v = 0; v < NWARPS; ++v) {
        s0 += red[(v * SOLVE_ROWS + warp) * NB + lane];
        s1 += red[(v * SOLVE_ROWS + warp) * NB + lane + 32];
      }
    T* xc = sx + (size_t)j0 * SOLVE_ROWS + warp;
    T v0 = xc[lane * SOLVE_ROWS] - s0;
    T v1 = xc[(lane + 32) * SOLVE_ROWS] - s1;
    solve_row_block(v0, v1, sd, dg, rg, NB);
    xc[lane * SOLVE_ROWS] = v0;
    xc[(lane + 32) * SOLVE_ROWS] = v1;
  }
  __syncthreads();
  for (int e = tid; e < SOLVE_ROWS * n; e += THREADS) {
    const int r = e / n, k = e % n;
    x[(size_t)r * n + k] = sx[k * SOLVE_ROWS + r];
  }
  __syncthreads();                      // the next item reuses smem
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    fused_column_kernel(const Params<T> p) {
  using G = typename Wave<T>::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tb = p.tb;
  const size_t tile = (size_t)tb * tb;

  // 1. the update wave over every row's output blocks
  const int nt = (tb + G::BN - 1) / G::BN, mt = (tb + G::BM - 1) / G::BM;
  const int items = n_wave_items<T>(p.R, tb);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int r = it / (mt * nt), b = it % (mt * nt);
    wave_block(p, r, (b / nt) * G::BM, (b % nt) * G::BN, smem);
  }
  grid.sync();

  // 2. the diagonal: the blocked factor over the grid, in place in out[0];
  //    block 0 zeroes its upper triangle and rounds it for the solves
  const int first = p.with_diag ? 1 : 0;
  if (p.with_diag) {
    potrf_blocked<T>(p.out, p.out, p.out, tb, smem_raw);
    if (blockIdx.x == 0) finish_factor(p.out, tb, p.cls[0], smem);
    grid.sync();
  }

  // 3. the row solves, eight rows of a later tile an item
  const T* l = p.with_diag ? p.out : p.lkk;
  const int groups = tb / SOLVE_ROWS;
  const int solves = n_solve_items(p.R, tb, p.with_diag);
  for (int it = blockIdx.x; it < solves; it += gridDim.x)
    solve_rows(l, p.out + (first + it / groups) * tile +
                      (size_t)(it % groups) * SOLVE_ROWS * tb, tb, smem);
  grid.sync();

  // 4. the epilogue, one block per tile
  for (int r = first + blockIdx.x; r < p.R; r += gridDim.x)
    epilogue_tile(p.out + r * tile, tb, p.cls[r], smem);
}

// The occupancy of the launch: blocks a SM at `smem` bytes, and the SMs.
template <typename T>
static int occupancy(size_t smem, int* per_sm, int* sms) {
  const void* fn = reinterpret_cast<const void*>(&fused_column_kernel<T>);
  cudaError_t e;
  int dev, coop;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  // a function attribute holds for the card it was set on: once a card
  static bool opted_in[MAX_DEVICES] = {};
  if (!opted_in[dev] && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(fused_smem_bytes<T>(MAX_TB)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev] = true;
  }
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_column_kernel<T>,
                                                         THREADS, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (*per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

template <typename T>
static int launch(const void* c, const void* hist, const void* bhist,
                  const void* lkk, void* out, int r_tiles, int k_hist, int tb,
                  int with_diag, const int* cls, cudaStream_t stream) {
  Params<T> p;
  p.c = static_cast<const T*>(c);
  p.hist = static_cast<const T*>(hist);
  p.bhist = static_cast<const T*>(bhist);
  p.lkk = static_cast<const T*>(lkk);
  p.out = static_cast<T*>(out);
  p.R = r_tiles; p.K = k_hist; p.tb = tb; p.with_diag = with_diag;
  for (int i = 0; i < MAX_ROWS; ++i) p.cls[i] = i < r_tiles ? cls[i] : -1;
  const size_t smem = fused_smem_bytes<T>(tb);
  int per_sm, sms;
  const int err = occupancy<T>(smem, &per_sm, &sms);
  if (err) return err;
  // every block must be resident at once for grid.sync(); a refused launch
  // is reported, never retried with a smaller grid
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&fused_column_kernel<T>), dim3(per_sm * sms),
      dim3(THREADS), args, smem, stream));
}

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One fused column step. cls holds r_tiles class codes on the host; f64
// selects the double variant; smem, wave_items and solve_items must be the
// shared memory a block and the lengths of the wave's and the solves' work
// lists that kernels/fused_column.py computed (any other is refused), and
// every tile must start on a 16-byte boundary. Returns the launch's
// cudaError_t.
extern "C" int fused_column_step(const void* c, const void* hist,
                                 const void* bhist, const void* lkk, void* out,
                                 int r_tiles, int k_hist, int tb, int with_diag,
                                 const int* cls, int f64, int smem,
                                 int wave_items, int solve_items,
                                 void* stream) {
  if (r_tiles <= 0 || r_tiles > MAX_ROWS || k_hist < 0 || tb <= 0 || tb % NB ||
      tb > MAX_TB ||
      static_cast<size_t>(smem) != (f64 ? fused_smem_bytes<double>(tb)
                                        : fused_smem_bytes<float>(tb)) ||
      wave_items != (f64 ? n_wave_items<double>(r_tiles, tb)
                         : n_wave_items<float>(r_tiles, tb)) ||
      solve_items != n_solve_items(r_tiles, tb, with_diag) ||
      !aligned16(c) || !aligned16(hist) || !aligned16(bhist) ||
      !aligned16(lkk) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = f64 ? launch<double>(c, hist, bhist, lkk, out, r_tiles, k_hist,
                                       tb, with_diag, cls, s)
                      : launch<float>(c, hist, bhist, lkk, out, r_tiles, k_hist,
                                      tb, with_diag, cls, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The grid of a launch at tile size tb: blocks a SM and SMs (the grid is
// their product), for the report; 0 or the query's cudaError_t.
extern "C" int fused_column_grid(int tb, int f64, int* per_sm, int* sms) {
  if (tb <= 0 || tb % NB || tb > MAX_TB)
    return static_cast<int>(cudaErrorInvalidValue);
  return f64 ? occupancy<double>(fused_smem_bytes<double>(tb), per_sm, sms)
             : occupancy<float>(fused_smem_bytes<float>(tb), per_sm, sms);
}
