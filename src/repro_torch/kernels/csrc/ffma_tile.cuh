// The one FFMA main loop of the port: the GEMM update kernel (mxp_gemm.cu)
// and the fused column step's wave (fused_column.cu) both run it.
//
// A 256-thread block (16 x 16 threads) owns a BM x BN output tile,
// BM = 16 TM and BN = 16 TN, and each thread a TM x TN register micro-tile:
// rows ty + 16 i and columns tx + 16 j (i < TM, j < TN). The operands stream
// through STAGES shared-memory stages of KS columns of K each, row-major as
// they lie in device memory ([BM][LD] of A, then [BN][LD] of B), filled with
// 16-byte cp.async while an earlier stage feeds the FFMAs. Rows whose byte
// length or address is not a multiple of 16 take plain loads. The operands
// stay in their storage type in shared memory (f32, bf16, fp8 e4m3, f64) and
// are widened at the shared -> register read, four K values at a time (one
// 16-byte read of f32, 8 bytes of bf16, 4 of fp8, two 16-byte reads of f64).
// The row stride LD = KS + one vector keeps every row 16-byte aligned and
// puts the eight rows that a quarter warp reads at once in different banks,
// so the reads of B (tx + 16 j: eight rows of one quarter warp) are free of
// bank conflicts and the reads of A (ty + 16 i: one row for sixteen threads)
// are broadcasts.
//
// A thread does 4 TM TN FFMAs for every TM + TN reads of four values: at
// 8 x 4, 128 FFMAs for 12 reads (the first GEMM kernel's 4 x 4 did 16 for
// 2 float4 reads). The accumulator type TA is f32 for f32, bf16 and fp8
// operands (no TF32: the f32 class rounds at 2^-24) and f64 for f64 ones; it
// is seeded by the caller and carried in registers across the whole loop.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

constexpr int FFMA_THREADS = 256;          // 16 x 16 threads a block
constexpr int FFMA_SIDE = 16;

// This thread's place (ty, tx) in the 16 x 16 grid: rows ty + 16 i and
// columns tx + 16 j of the tile are its.
__device__ __forceinline__ int ffma_tx() { return threadIdx.x % FFMA_SIDE; }
__device__ __forceinline__ int ffma_ty() { return threadIdx.x / FFMA_SIDE; }

template <typename TS, int TM_, int TN_, int KS_, int STAGES_ = 2>
struct FfmaTile {
  static constexpr int TM = TM_, TN = TN_, KS = KS_, STAGES = STAGES_;
  static constexpr int BM = FFMA_SIDE * TM, BN = FFMA_SIDE * TN;
  static constexpr int VEC = 16 / sizeof(TS);       // elements a cp.async
  static constexpr int LD = KS + VEC;               // row stride, elements
  static constexpr int A_ELEMS = BM * LD;
  static constexpr int STAGE_ELEMS = (BM + BN) * LD;
  static constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_ELEMS * sizeof(TS);
  static_assert(KS % VEC == 0 && KS % 4 == 0, "whole vectors a stage row");
  static_assert(STAGES >= 2, "a stage in flight while one is used");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Four consecutive staged values, widened to the accumulator type.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}
__device__ __forceinline__ void load4(const __nv_fp8_e4m3* p, float (&v)[4]) {
  const __nv_fp8x4_e4m3 t = *reinterpret_cast<const __nv_fp8x4_e4m3*>(p);
  const float4 f = static_cast<float4>(t);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 t0 = reinterpret_cast<const double2*>(p)[0];
  const double2 t1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = t0.x; v[1] = t0.y; v[2] = t1.x; v[3] = t1.y;
}

// Stage ROWS rows and the KS columns k0 .. k0 + KS - 1 of a row-major
// matrix (row stride ld elements, `src` at the tile's first row) into
// dst[ROWS][LD]. Rows at or past `rows` and columns at or past k_hi read as
// zero. VEC: every row is a whole number of 16-byte vectors on a 16-byte
// boundary, and k0, k_hi are multiples of the vector, so a vector is all in
// or all out and one cp.async moves it; otherwise plain loads.
template <typename G, bool VEC, int ROWS, typename TS>
__device__ __forceinline__ void ffma_stage_rows(TS* dst,
                                                const TS* __restrict__ src,
                                                size_t ld, int rows, int k0,
                                                int k_hi) {
  if constexpr (VEC) {
    constexpr int PER_ROW = G::KS / G::VEC;
    for (int e = threadIdx.x; e < ROWS * PER_ROW; e += FFMA_THREADS) {
      const int r = e / PER_ROW, kv = (e % PER_ROW) * G::VEC;
      const bool in = r < rows && k0 + kv < k_hi;
      const TS* p = in ? src + (size_t)r * ld + k0 + kv : src;
      cp_async16(dst + r * G::LD + kv, p, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * G::KS; e += FFMA_THREADS) {
      const int r = e / G::KS, kk = e % G::KS;
      dst[r * G::LD + kk] = (r < rows && k0 + kk < k_hi)
                                ? src[(size_t)r * ld + k0 + kk]
                                : static_cast<TS>(0.f);
    }
  }
}

// acc -= A_s B_s^T over one stage: as [BM][LD], bs [BN][LD].
template <typename G, typename TA, typename TS>
__device__ __forceinline__ void ffma_stage(TA (&acc)[G::TM][G::TN],
                                           const TS* as, const TS* bs) {
  const int tx = ffma_tx(), ty = ffma_ty();
#pragma unroll
  for (int kk = 0; kk < G::KS; kk += 4) {
    TA av[G::TM][4], bv[G::TN][4];
#pragma unroll
    for (int i = 0; i < G::TM; ++i) load4(as + (ty + FFMA_SIDE * i) * G::LD + kk, av[i]);
#pragma unroll
    for (int j = 0; j < G::TN; ++j) load4(bs + (tx + FFMA_SIDE * j) * G::LD + kk, bv[j]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < G::TM; ++i)
#pragma unroll
        for (int j = 0; j < G::TN; ++j)
          acc[i][j] = fma(-av[i][q], bv[j][q], acc[i][j]);
  }
}

// The main loop: acc -= sum over the stages s < n_steps of A_s B_s^T.
// load(s, stage) issues stage s's loads (A's BM rows at stage, B's BN rows
// at stage + G::A_ELEMS, by ffma_stage_rows); smem holds G::STAGES stages.
// STAGES - 1 stages are in flight while one is used, with one block barrier
// a stage. Every thread of the block calls it with the same n_steps; it
// ends with the last stage's FFMAs, so a caller that reuses smem after it
// needs a barrier first. ffma_prologue issues the first stages' loads and
// ffma_steps runs the loop, so that a caller can seed acc from device
// memory while those loads are in flight; ffma_mainloop does both.
template <typename G, typename TS, typename Load>
__device__ __forceinline__ void ffma_prologue(int n_steps, TS* smem,
                                              Load&& load) {
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < n_steps) load(s, smem + s * G::STAGE_ELEMS);
    cp_async_commit();
  }
}

template <typename G, typename TA, typename TS, typename Load>
__device__ __forceinline__ void ffma_steps(TA (&acc)[G::TM][G::TN],
                                           int n_steps, TS* smem,
                                           Load&& load) {
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<G::STAGES - 2>();     // stage s has landed
    __syncthreads();                    // for every thread; stage s - 1 is free
    const int nxt = s + G::STAGES - 1;
    if (nxt < n_steps) load(nxt, smem + (nxt % G::STAGES) * G::STAGE_ELEMS);
    cp_async_commit();
    const TS* as = smem + (s % G::STAGES) * G::STAGE_ELEMS;
    ffma_stage<G>(acc, as, as + G::A_ELEMS);
  }
}

template <typename G, typename TA, typename TS, typename Load>
__device__ __forceinline__ void ffma_mainloop(TA (&acc)[G::TM][G::TN],
                                              int n_steps, TS* smem,
                                              Load&& load) {
  ffma_prologue<G>(n_steps, smem, load);
  ffma_steps<G>(acc, n_steps, smem, load);
}

// acc[i][j] = C[m0 + ty + 16 i][n0 + tx + 16 j] (C row-major, row stride
// ldc) where that lies inside M x N, else zero.
template <typename G, typename TA, typename TC>
__device__ __forceinline__ void ffma_seed(TA (&acc)[G::TM][G::TN],
                                          const TC* __restrict__ c, size_t ldc,
                                          int M, int N, int m0, int n0) {
  const int tx = ffma_tx(), ty = ffma_ty();
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < G::TN; ++j) {
      const int r = m0 + ty + FFMA_SIDE * i, col = n0 + tx + FFMA_SIDE * j;
      acc[i][j] = (r < M && col < N) ? widen<TA>(c[(size_t)r * ldc + col]) : TA(0);
    }
}
