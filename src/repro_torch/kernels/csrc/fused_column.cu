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
// which this kernel's FP64 FMA loop does not use). After the wave, POTRF and the row solves are dependence chains (column
// by column), so those phases are bound by latency, not by a rate.
//
// The race: the Pallas grid runs in order on one core, so the diagonal row's
// factor sits in VMEM scratch before any row solve reads it. CUDA blocks run
// concurrently. This kernel is one cooperative launch of a persistent grid
// (as many blocks as fit on the card at once, from the occupancy query), and
// cooperative_groups' grid.sync() separates the phases: the wave, the
// factor, the solves and the epilogue. Within a phase each block takes work
// items grid-stride. A 512 x 512 f64 accumulator is 2 MiB, far beyond a
// block's 227 KB of shared memory, so the accumulators are the output tiles
// in device memory (L2-resident at this size): the wave writes acc into out,
// and the factor, the solves and the epilogue then work on out in place.
// Only a 64 x 16 stage of each operand, the factor's current row and column,
// and the rows being solved live in shared memory.
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

#include <cuda_fp16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int FT = 64;                  // output block edge of the wave
constexpr int FBK = 16;                 // history depth staged per step
constexpr int FTM = 4, FTN = 4;         // register micro-tile per thread
constexpr int THREADS = (FT / FTM) * (FT / FTN);   // 256
constexpr int NWARPS = THREADS / 32;
constexpr int FPAD = 4;
constexpr int MAX_ROWS = 256;           // mirrored by fused_column.py
constexpr int POTRF_ROWS = 2;           // rows a warp of the factor forms at once

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

template <typename T>
struct WaveSmem {
  __align__(16) T as[FBK][FT + FPAD];
  __align__(16) T bs[FBK][FT + FPAD];
};

__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double (&r)[4]) {
  const double2 v0 = reinterpret_cast<const double2*>(p)[0];
  const double2 v1 = reinterpret_cast<const double2*>(p)[1];
  r[0] = v0.x; r[1] = v0.y; r[2] = v1.x; r[3] = v1.y;
}

template <typename T>
__device__ __forceinline__ T warp_sum_t(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NaN-propagating max, as torch.amax and jnp.max reduce
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// ---------------------------------------------------------------- phase 1
// One 64 x 64 block of one row: out = C - sum_kk A_kk @ B_kk^T, the
// accumulator in registers across the whole history (ffma_tile.cuh's loop,
// in T).
template <typename T>
__device__ void wave_block(const Params<T>& p, int r, int m0, int n0,
                           WaveSmem<T>& sm) {
  const int tb = p.tb, tid = threadIdx.x;
  const int tx = tid % (FT / FTN), ty = tid / (FT / FTN);
  const size_t tile = (size_t)tb * tb;
  const T* c = p.c + r * tile;
  T acc[FTM][FTN];
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j)
      acc[i][j] = c[(size_t)(m0 + ty * FTM + i) * tb + n0 + tx * FTN + j];
  for (int kk = 0; kk < p.K; ++kk) {
    const T* a = p.hist + ((size_t)r * p.K + kk) * tile;
    const T* b = p.bhist + (size_t)kk * tile;
    for (int k0 = 0; k0 < tb; k0 += FBK) {
      for (int e = tid; e < FT * FBK; e += THREADS) {
        const int row = e / FBK, k = e % FBK;
        sm.as[k][row] = a[(size_t)(m0 + row) * tb + k0 + k];
        sm.bs[k][row] = b[(size_t)(n0 + row) * tb + k0 + k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FBK; ++k) {
        T ar[FTM], br[FTN];
        load4(&sm.as[k][ty * FTM], ar);
        load4(&sm.bs[k][tx * FTN], br);
#pragma unroll
        for (int i = 0; i < FTM; ++i)
#pragma unroll
          for (int j = 0; j < FTN; ++j) acc[i][j] = fma(-ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  T* o = p.out + r * tile;
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j)
      o[(size_t)(m0 + ty * FTM + i) * tb + n0 + tx * FTN + j] = acc[i][j];
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
// Cholesky of the symmetrised tile in place, column by column (potrf.cu's
// loop in T): v = A[:, j] - L[:, :j] @ L[j, :j]^T, L[i, j] = v_i / sqrt(v_j).
// Column j reads only A's column j (lower, not yet overwritten) and row j
// (strictly upper, never overwritten); the strict upper triangle is zeroed at
// the end. A pivot that is not positive gives NaN, unclamped.
template <typename T>
__device__ void potrf_tile(T* w, int n, T* sm) {
  T* lrow = sm;          // row j of L, columns < j
  T* v = sm + n;         // column j before the division
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int j = 0; j < n; ++j) {
    for (int k = tid; k < j; k += THREADS) lrow[k] = w[(size_t)j * n + k];
    __syncthreads();
    // a warp forms POTRF_ROWS rows at once (rows i0 + q NWARPS), so that
    // their loads and reductions overlap: one block has only 8 warps, and
    // the column is a chain of L2 round trips otherwise. Two rows were the
    // fastest of 1, 2, 4 and 8 on the card in f32 and close to it in f64.
    for (int i0 = j + warp; i0 < n; i0 += POTRF_ROWS * NWARPS) {
      T s[POTRF_ROWS], aij[POTRF_ROWS];
#pragma unroll
      for (int q = 0; q < POTRF_ROWS; ++q) {
        const int i = i0 + q * NWARPS;
        s[q] = T(0);
        aij[q] = i < n ? T(0.5) * (w[(size_t)i * n + j] + w[(size_t)j * n + i]) : T(0);
      }
      // rows past the tile read the last row and are dropped below, so
      // that every load is unconditional and the unrolled loop batches them
      const T* li[POTRF_ROWS];
#pragma unroll
      for (int q = 0; q < POTRF_ROWS; ++q)
        li[q] = w + (size_t)min(i0 + q * NWARPS, n - 1) * n;
#pragma unroll 4
      for (int k = lane; k < j; k += 32) {
        const T lk = lrow[k];
#pragma unroll
        for (int q = 0; q < POTRF_ROWS; ++q) s[q] = fma(li[q][k], lk, s[q]);
      }
#pragma unroll
      for (int q = 0; q < POTRF_ROWS; ++q) {
        s[q] = warp_sum_t(s[q]);
        const int i = i0 + q * NWARPS;
        if (lane == 0 && i < n) v[i] = aij[q] - s[q];
      }
    }
    __syncthreads();
    const T d = sqrt(v[j]);
    for (int i = j + tid; i < n; i += THREADS) w[(size_t)i * n + j] = v[i] / d;
    __syncthreads();
  }
  for (size_t e = tid; e < (size_t)n * n; e += THREADS)
    if (e % n > e / n) w[e] = T(0);
  __syncthreads();
}

// ---------------------------------------------------------------- phase 3
// One row of X L^T = C by forward substitution (trsm.cu's loop in T), in
// place; x is this warp's row in shared memory.
template <typename T>
__device__ void trsm_row(const T* l, T* row, int n, T* x) {
  const int lane = threadIdx.x % 32;
  for (int k = lane; k < n; k += 32) x[k] = row[k];
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const T* lj = l + (size_t)j * n;
    T s = T(0);
#pragma unroll 4
    for (int k = lane; k < j; k += 32) s = fma(x[k], lj[k], s);
    s = warp_sum_t(s);
    if (lane == 0) x[j] = (x[j] - s) / lj[j];
    __syncwarp();
  }
  for (int k = lane; k < n; k += 32) row[k] = x[k];
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_column_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tb = p.tb, nb = tb / FT;
  const size_t tile = (size_t)tb * tb;

  // 1. the update wave over every row's 64 x 64 blocks
  const int items = p.R * nb * nb;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int r = it / (nb * nb), b = it % (nb * nb);
    wave_block(p, r, (b / nb) * FT, (b % nb) * FT,
               *reinterpret_cast<WaveSmem<T>*>(smem_raw));
  }
  grid.sync();

  // 2. the diagonal: factor, round, keep in out[0] for the solves
  const int first = p.with_diag ? 1 : 0;
  if (p.with_diag) {
    if (blockIdx.x == 0) {
      potrf_tile(p.out, tb, smem);
      epilogue_tile(p.out, tb, p.cls[0], smem);
    }
    grid.sync();
  }

  // 3. the row solves, one warp per row of every later tile
  const T* l = p.with_diag ? p.out : p.lkk;
  const int warp = threadIdx.x / 32;
  T* x = smem + (size_t)warp * tb;
  const long rows = (long)(p.R - first) * tb;
  for (long g = (long)blockIdx.x * NWARPS + warp; g < rows;
       g += (long)gridDim.x * NWARPS)
    trsm_row(l, p.out + (first + g / tb) * tile + (g % tb) * tb, tb, x);
  grid.sync();

  // 4. the epilogue, one block per tile
  for (int r = first + blockIdx.x; r < p.R; r += gridDim.x)
    epilogue_tile(p.out + r * tile, tb, p.cls[r], smem);
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

  size_t smem = sizeof(WaveSmem<T>);
  const size_t potrf_b = 2 * (size_t)tb * sizeof(T);
  const size_t trsm_b = (size_t)NWARPS * tb * sizeof(T);
  const size_t red_b = (NWARPS + 1) * sizeof(T);
  if (potrf_b > smem) smem = potrf_b;
  if (trsm_b > smem) smem = trsm_b;
  if (red_b > smem) smem = red_b;
  const void* fn = reinterpret_cast<const void*>(&fused_column_kernel<T>);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev, sms, coop, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_column_kernel<T>,
                                                         THREADS, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // every block must be resident at once for grid.sync(); a refused launch
  // is reported, never retried with a smaller grid
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(fn, dim3(per_sm * sms), dim3(THREADS), args,
                                  smem, stream);
  return static_cast<int>(e);
}

// One fused column step. cls holds r_tiles class codes on the host; f64
// selects the double variant. Returns the launch's cudaError_t.
extern "C" int fused_column_step(const void* c, const void* hist,
                                 const void* bhist, const void* lkk, void* out,
                                 int r_tiles, int k_hist, int tb, int with_diag,
                                 const int* cls, int f64, void* stream) {
  if (r_tiles <= 0 || r_tiles > MAX_ROWS || k_hist < 0 || tb <= 0 || tb % FT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = f64 ? launch<double>(c, hist, bhist, lkk, out, r_tiles, k_hist,
                                       tb, with_diag, cls, s)
                      : launch<float>(c, hist, bhist, lkk, out, r_tiles, k_hist,
                                      tb, with_diag, cls, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
