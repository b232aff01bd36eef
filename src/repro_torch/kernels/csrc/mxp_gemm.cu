// Mixed-precision GEMM update  out = C - A @ B^T  for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mxp_gemm.py, _mxp_gemm_kernel (the Pallas TPU
// kernel behind mxp_gemm_update). A [M, K] and B [N, K] keep their storage
// type (f32, bf16 or fp8 e4m3) and are widened to f32 as they are staged;
// the f32 accumulator starts from C and the result is cast to C's type.
//
// What bounds it here: operations. At the executor's 512 x 512 x 512 tile the
// update is 268 MFLOP against 4 MiB of f32 operands, 64 flops a byte, far
// above the 20 flops a byte where the card's 67 TFLOP/s f32 (non-tensor) rate
// and 3.35 TB/s meet. The tensor cores cannot take f32 operands without TF32,
// which would move the f32 class off the 2^-24 roundoff the precision plan
// assumes, so the kernel runs FFMA.
//
// What the design does about it: shared-memory tiling (ffma_tile.cuh) keeps
// each staged element in use for 64 FFMAs, and a 4 x 4 register micro-tile
// per thread reads two float4s of shared memory per 16 FFMAs. It makes no
// use of wgmma or TMA yet; at 512 x 512 the grid is 64 blocks, about half
// the card's 132 SMs.
#include "ffma_tile.cuh"

template <typename TAB, typename TC>
__global__ void __launch_bounds__(TILE_THREADS)
    mxp_gemm_kernel(const TC* __restrict__ c, const TAB* __restrict__ a,
                    const TAB* __restrict__ b, TC* __restrict__ out, int M,
                    int N, int K) {
  __shared__ TileSmem sm;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc[TM][TN];
  seed_tile(acc, c, M, N, m0, n0);
  ffma_tile_update(acc, a, b, M, N, K, m0, n0, sm);
  const int tx = threadIdx.x % (TILE / TN), ty = threadIdx.x / (TILE / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = m0 + ty * TM + i, col = n0 + tx * TN + j;
      if (r < M && col < N) out[(size_t)r * N + col] = from_f32<TC>(acc[i][j]);
    }
}

template <typename TAB, typename TC>
static void launch(const void* c, const void* a, const void* b, void* out,
                   int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  mxp_gemm_kernel<TAB, TC><<<grid, TILE_THREADS, 0, stream>>>(
      static_cast<const TC*>(c), static_cast<const TAB*>(a),
      static_cast<const TAB*>(b), static_cast<TC*>(out), m, n, k);
}

template <typename TC>
static int dispatch_ab(const void* c, const void* a, const void* b, void* out,
                       int m, int n, int k, int ab_dtype,
                       cudaStream_t stream) {
  switch (ab_dtype) {
    case DT_F32: launch<float, TC>(c, a, b, out, m, n, k, stream); break;
    case DT_BF16: launch<__nv_bfloat16, TC>(c, a, b, out, m, n, k, stream); break;
    case DT_F8E4M3: launch<__nv_fp8_e4m3, TC>(c, a, b, out, m, n, k, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// out = C - A @ B^T. Returns cudaGetLastError() after the launch.
extern "C" int mxp_gemm_update(const void* c, const void* a, const void* b,
                               void* out, int m, int n, int k, int ab_dtype,
                               int c_dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (c_dtype) {
    case DT_F32: err = dispatch_ab<float>(c, a, b, out, m, n, k, ab_dtype, s); break;
    case DT_BF16: err = dispatch_ab<__nv_bfloat16>(c, a, b, out, m, n, k, ab_dtype, s); break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
