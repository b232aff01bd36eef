// The FFMA main loop of the GEMM update kernel and the fused column step.
//
// A 256-thread block owns a 64 x 64 output tile and walks K in steps of 16:
// each step stages A[m0:m0+64, k0:k0+16] and B[n0:n0+64, k0:k0+16] in shared
// memory, K-major (transposed), widened to f32 on the way in, and every thread
// then runs a 4 x 4 register micro-tile of FFMAs over the step. The f32
// accumulator is seeded by the caller (with C) and carried in registers across
// the whole K loop: the analogue of the Pallas kernels' VMEM scratch
// accumulator carried across the sequential K grid axis.
#pragma once

#include <stddef.h>

#include "common.cuh"

constexpr int TILE = 64;                 // output rows and columns per block
constexpr int BK = 16;                   // K step staged in shared memory
constexpr int TM = 4, TN = 4;            // register micro-tile per thread
constexpr int TILE_THREADS = (TILE / TM) * (TILE / TN);   // 256
constexpr int SPAD = 4;                  // keeps float4 rows 16-byte aligned

struct TileSmem {
  __align__(16) float as[BK][TILE + SPAD];
  __align__(16) float bs[BK][TILE + SPAD];
};

// acc -= A[m0:m0+64, :] @ B[n0:n0+64, :]^T for this thread's micro-tile,
// with A [M, K] and B [N, K] row-major; rows past M or N read as zero.
template <typename TA, typename TB>
__device__ __forceinline__ void ffma_tile_update(
    float (&acc)[TM][TN], const TA* __restrict__ a, const TB* __restrict__ b,
    int M, int N, int K, int m0, int n0, TileSmem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % (TILE / TN), ty = tid / (TILE / TN);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < TILE * BK; e += TILE_THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gk = k0 + kk;
      const int ga = m0 + r, gb = n0 + r;
      sm.as[kk][r] = (ga < M && gk < K) ? to_f32(a[(size_t)ga * K + gk]) : 0.f;
      sm.bs[kk][r] = (gb < N && gk < K) ? to_f32(b[(size_t)gb * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.as[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.bs[kk][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(-ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Seed the accumulator with C[m0:m0+64, n0:n0+64] (C is [M, N] row-major).
template <typename TC>
__device__ __forceinline__ void seed_tile(float (&acc)[TM][TN],
                                          const TC* __restrict__ c, int M,
                                          int N, int m0, int n0) {
  const int tx = threadIdx.x % (TILE / TN), ty = threadIdx.x / (TILE / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = m0 + ty * TM + i, col = n0 + tx * TN + j;
      acc[i][j] = (r < M && col < N) ? to_f32(c[(size_t)r * N + col]) : 0.f;
    }
}
