// Symmetric rank-k update  out = C - A @ A^T  for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/syrk.py, _syrk_kernel, together with the
// mirror that its wrapper (src/repro/kernels/ops.py, syrk_update) applies
// afterwards: the lower triangle of C - A @ A^T is computed in f32 from
// f32 or bf16 operands, and the strictly upper triangle of the result is
// the transpose of the lower one, in C's type.
//
// What bounds it here: operations. At the executor's 512 x 512 tile, the
// 36 lower 64 x 64 blocks take 151 MFLOP against 3 MiB of f32 traffic, well
// above the card's f32 ridge of 20 flops a byte.
//
// What the design does about it: the grid launches only the blocks on or
// below the diagonal (no work is spent on the upper blocks that the Pallas
// grid visits and skips), runs the FFMA main loop of ffma_tile.cuh, and
// writes each off-diagonal block and its mirrored transpose in the same
// pass, staged through shared memory so that both stores are coalesced.
#include "ffma_tile.cuh"

template <typename TA, typename TC>
__global__ void __launch_bounds__(TILE_THREADS)
    syrk_kernel(const TC* __restrict__ c, const TA* __restrict__ a,
                TC* __restrict__ out, int M, int K) {
  __shared__ TileSmem sm;
  __shared__ float stage[TILE][TILE + 1];
  // blockIdx.x enumerates the lower blocks row by row: t = bi*(bi+1)/2 + bj
  const int t = blockIdx.x;
  int bi = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  while (bi * (bi + 1) / 2 > t) --bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int m0 = bi * TILE, n0 = bj * TILE;

  float acc[TM][TN];
  seed_tile(acc, c, M, M, m0, n0);
  ffma_tile_update(acc, a, a, M, M, K, m0, n0, sm);

  const int tx = threadIdx.x % (TILE / TN), ty = threadIdx.x / (TILE / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) stage[ty * TM + i][tx * TN + j] = acc[i][j];
  __syncthreads();

  for (int e = threadIdx.x; e < TILE * TILE; e += TILE_THREADS) {
    const int r = e / TILE, cc = e % TILE;
    const int gr = m0 + r, gc = n0 + cc;
    if (gr < M && gc < M) {
      // a diagonal block takes its upper half from the mirrored lower half
      const float v = (bi > bj || r >= cc) ? stage[r][cc] : stage[cc][r];
      out[(size_t)gr * M + gc] = from_f32<TC>(v);
    }
    const int mr = n0 + r, mc = m0 + cc;   // block (bj, bi), transposed
    if (bi > bj && mr < M && mc < M)
      out[(size_t)mr * M + mc] = from_f32<TC>(stage[cc][r]);
  }
}

template <typename TA, typename TC>
static void launch(const void* c, const void* a, void* out, int m, int k,
                   cudaStream_t stream) {
  const int nb = (m + TILE - 1) / TILE;
  syrk_kernel<TA, TC><<<nb * (nb + 1) / 2, TILE_THREADS, 0, stream>>>(
      static_cast<const TC*>(c), static_cast<const TA*>(a),
      static_cast<TC*>(out), m, k);
}

// out = C - A @ A^T on the lower triangle, mirrored into the upper one.
// Returns cudaGetLastError() after the launch.
extern "C" int syrk_update(const void* c, const void* a, void* out, int m,
                           int k, int a_dtype, int c_dtype, void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == DT_F32 && c_dtype == DT_F32)
    launch<float, float>(c, a, out, m, k, s);
  else if (a_dtype == DT_F32 && c_dtype == DT_BF16)
    launch<float, __nv_bfloat16>(c, a, out, m, k, s);
  else if (a_dtype == DT_BF16 && c_dtype == DT_F32)
    launch<__nv_bfloat16, float>(c, a, out, m, k, s);
  else if (a_dtype == DT_BF16 && c_dtype == DT_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(c, a, out, m, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
