// Single-tile Cholesky factorization (POTRF) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/potrf.py, _potrf_kernel. The tile (f32 or
// bf16) is symmetrised, 0.5 * (A + A^T), and factored column by column in
// f32: v = A[:, j] - L[:, :j] @ L[j, :j]^T, L[i, j] = v_i / sqrt(v_j) for
// i >= j. The strictly upper triangle of the result is zero and the result
// is cast to the input's type. A pivot that is not positive gives NaN, as
// the reference's sqrt does; nothing is clamped.
//
// What bounds it here: the column chain. The 512 x 512 factor is 45 MFLOP,
// but column j needs all of columns 0..j-1, so the work is n steps of a
// matrix-vector product separated by block-wide barriers. A 512 x 512 f32
// tile (1 MiB) is four times the 227 KB of shared memory a block can have.
//
// What the design does about it: one block of 1024 threads per tile, as the
// Pallas kernel runs one grid cell. L is built in a global f32 workspace
// (the output itself for f32 tiles), which stays in L2; only row j of L and
// the column being formed sit in shared memory. Each warp forms whole rows
// of v with a lane-strided dot product over contiguous memory and a shuffle
// reduction. POTRF is one launch per column step of the factorization, a
// small share of its flops.
#include <stddef.h>

#include "common.cuh"

constexpr int POTRF_THREADS = 1024;

// `work` is an f32 [n, n] buffer; it may be `out` itself when T is float.
template <typename T>
__global__ void __launch_bounds__(POTRF_THREADS)
    potrf_kernel(const T* __restrict__ a, float* work, T* out, int n) {
  extern __shared__ float sm[];
  float* lrow = sm;      // row j of L, columns < j
  float* v = sm + n;     // column j before the division
  constexpr int NW = POTRF_THREADS / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int j = 0; j < n; ++j) {
    for (int k = tid; k < j; k += POTRF_THREADS) lrow[k] = work[(size_t)j * n + k];
    __syncthreads();
    for (int i = j + warp; i < n; i += NW) {
      const float* li = work + (size_t)i * n;
      float s = 0.f;
      for (int k = lane; k < j; k += 32) s = fmaf(li[k], lrow[k], s);
      s = warp_sum(s);
      if (lane == 0) {
        const float aij = 0.5f * (to_f32(a[(size_t)i * n + j]) +
                                  to_f32(a[(size_t)j * n + i]));
        v[i] = aij - s;
      }
    }
    __syncthreads();
    const float d = sqrtf(v[j]);
    for (int i = j + tid; i < n; i += POTRF_THREADS)
      work[(size_t)i * n + j] = v[i] / d;
    __syncthreads();
  }
  const size_t total = (size_t)n * n;
  for (size_t e = tid; e < total; e += POTRF_THREADS) {
    const size_t i = e / n, k = e % n;
    out[e] = from_f32<T>(k <= i ? work[e] : 0.f);
  }
}

template <typename T>
static void launch(const void* a, float* work, void* out, int n,
                   cudaStream_t stream) {
  potrf_kernel<T><<<1, POTRF_THREADS, 2 * n * sizeof(float), stream>>>(
      static_cast<const T*>(a), work, static_cast<T*>(out), n);
}

// Lower Cholesky factor of the symmetrised tile. `work` is an f32 [n, n]
// buffer (pass `out` for f32 tiles). Returns cudaGetLastError().
extern "C" int potrf(const void* a, void* work, void* out, int n, int dtype,
                     void* stream) {
  if (n <= 0 || 2 * n * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: launch<float>(a, static_cast<float*>(work), out, n, s); break;
    case DT_BF16: launch<__nv_bfloat16>(a, static_cast<float*>(work), out, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
