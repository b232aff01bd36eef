// Triangular solve  X @ L^T = C  (right side, L lower) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/trsm.py, _trsm_kernel. L [n, n] and C [m, n]
// are f32 or bf16; the solve runs in f32 by forward substitution over the
// columns, x_j = (c_j - sum_{k<j} x_k L[j, k]) / L[j, j], and the result is
// cast to C's type.
//
// What bounds it here: the dependence chain, not the card's rates. The
// 512 x 512 solve is 134 MFLOP over 3 MiB, but column j of every row waits
// for columns 0..j-1 of the same row, so each row is a chain of n dot
// products with a reduction at each link.
//
// What the design does about it: rows are independent, so one warp owns one
// row of C and eight warps share a block (64 blocks at m = 512). The row's
// partial solution lives in shared memory; each link is a lane-strided dot
// product against row j of L, which is contiguous in memory, and a warp
// shuffle reduction. L (1 MiB at n = 512) does not fit in shared memory next
// to the rows, so it is read from global memory, where the eight warps of a
// block walking the same rows of L keep it in L1 and L2. The blocked form
// (diagonal sub-solves plus GEMM updates on the tensor cores) is later work.
#include <stddef.h>

#include "common.cuh"

constexpr int TRSM_WARPS = 8;

template <typename TL, typename TC>
__global__ void __launch_bounds__(TRSM_WARPS * 32)
    trsm_kernel(const TL* __restrict__ l, const TC* __restrict__ c,
                TC* __restrict__ out, int m, int n) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * TRSM_WARPS + warp;
  if (row >= m) return;
  float* x = rows + (size_t)warp * n;
  const TC* crow = c + (size_t)row * n;
  for (int k = lane; k < n; k += 32) x[k] = to_f32(crow[k]);
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const TL* lrow = l + (size_t)j * n;
    float s = 0.f;
    for (int k = lane; k < j; k += 32) s = fmaf(x[k], to_f32(lrow[k]), s);
    s = warp_sum(s);
    if (lane == 0) x[j] = (x[j] - s) / to_f32(lrow[j]);
    __syncwarp();
  }
  TC* orow = out + (size_t)row * n;
  for (int k = lane; k < n; k += 32) orow[k] = from_f32<TC>(x[k]);
}

template <typename TL, typename TC>
static int launch(const void* l, const void* c, void* out, int m, int n,
                  cudaStream_t stream) {
  const size_t smem = (size_t)TRSM_WARPS * n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trsm_kernel<TL, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trsm_kernel<TL, TC><<<(m + TRSM_WARPS - 1) / TRSM_WARPS, TRSM_WARPS * 32,
                        smem, stream>>>(static_cast<const TL*>(l),
                                        static_cast<const TC*>(c),
                                        static_cast<TC*>(out), m, n);
  return 0;
}

// Solve X @ L^T = C. Returns cudaGetLastError() after the launch.
extern "C" int trsm(const void* l, const void* c, void* out, int m, int n,
                    int l_dtype, int c_dtype, void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (l_dtype == DT_F32 && c_dtype == DT_F32)
    err = launch<float, float>(l, c, out, m, n, s);
  else if (l_dtype == DT_F32 && c_dtype == DT_BF16)
    err = launch<float, __nv_bfloat16>(l, c, out, m, n, s);
  else if (l_dtype == DT_BF16 && c_dtype == DT_F32)
    err = launch<__nv_bfloat16, float>(l, c, out, m, n, s);
  else if (l_dtype == DT_BF16 && c_dtype == DT_BF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(l, c, out, m, n, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
