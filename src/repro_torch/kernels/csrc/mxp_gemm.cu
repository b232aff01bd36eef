// Mixed-precision GEMM update  out = C - A @ B^T  for Hopper (sm_90a), as a
// pipelined cluster split-K.
//
// Replaces: src/repro/kernels/mxp_gemm.py, _mxp_gemm_kernel (the Pallas TPU
// kernel behind mxp_gemm_update). A [M, K] and B [N, K] keep their storage
// type (f32, bf16 or fp8 e4m3) and are widened to f32 at the shared ->
// register read; the f32 accumulator starts from C once and the result is
// cast once to C's type (f32 or bf16).
//
// What bounds it here: operations. At the executor's 512 x 512 x 512 tile the
// update is 268 MFLOP against 4 MiB of f32 operands, 64 flops a byte, far
// above the 20 flops a byte where the card's 67 TFLOP/s f32 (non-tensor) rate
// and 3.35 TB/s meet. The tensor cores cannot take f32 operands without TF32,
// which would move the f32 class off the 2^-24 roundoff the precision plan
// assumes, so the kernel runs FFMA. The first kernel ran 64 blocks of 64 x 64
// at 512 x 512 (half the 132 SMs idle), one stage with no load/compute
// overlap, and 16 FFMAs per two float4 reads of shared memory.
//
// What the design does about it: the output is cut in 128 x 64 tiles
// (ffma_tile.cuh at 8 x 4 values a thread), and each tile is a thread block
// cluster of `split` CTAs that split K: CTA rank r sums K columns
// [r chunk, (r + 1) chunk) through the shared FFMA main loop (two cp.async
// stages of 32 columns; at 512^3, split 8: 256 CTAs, two a SM). Rank 0
// alone seeds its accumulator with C.
// The partial sums then meet through distributed shared memory: rank r sums
// the `split` partials of rows [r BM / split, (r + 1) BM / split) of the tile
// in rank order (deterministic, no atomics) and writes them, rounded once to
// C's type. The geometry (split, chunk) comes from the wrapper
// (repro_torch/kernels/mxp_gemm.py), which the C entry checks.
#include <cooperative_groups.h>
#include <stdint.h>

#include "ffma_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KS = 32;              // K columns a stage
constexpr int TM = 8, TN = 4;       // values a thread (mirrored in mxp_gemm.py)
constexpr int MAX_SPLIT = 8;        // a portable cluster

template <typename TAB>
using Geom = FfmaTile<TAB, TM, TN, KS>;

// the partial sums, [BM][BN + 16] f32, reuse the stages after the main
// loop; the row stride keeps float4 reads aligned and puts the two rows a
// warp writes at once in different banks
constexpr int RED_LD = FFMA_SIDE * TN + 16;
template <typename TAB>
constexpr size_t smem_bytes() {
  using G = Geom<TAB>;
  const size_t red = (size_t)G::BM * RED_LD * sizeof(float);
  return G::SMEM_BYTES > red ? G::SMEM_BYTES : red;
}

// two CTAs a SM (128 registers a thread)
template <typename TAB, typename TC, bool VEC>
__global__ void __launch_bounds__(FFMA_THREADS, 2)
    mxp_gemm_kernel(const TC* __restrict__ c, const TAB* __restrict__ a,
                    const TAB* __restrict__ b, TC* __restrict__ out, int M,
                    int N, int K, int tiles_n, int split, int chunk) {
  using G = Geom<TAB>;
  extern __shared__ __align__(16) uint8_t smem[];
  TAB* stages = reinterpret_cast<TAB*>(smem);
  float* red = reinterpret_cast<float*>(smem);     // [BM][RED_LD], after

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / split;
  const int m0 = (tile / tiles_n) * G::BM, n0 = (tile % tiles_n) * G::BN;
  const int k_lo = rank * chunk, k_hi = min(K, k_lo + chunk);

  const int n_steps = k_hi > k_lo ? (k_hi - k_lo + KS - 1) / KS : 0;
  const TAB* a0 = a + (size_t)m0 * K;
  const TAB* b0 = b + (size_t)n0 * K;
  const int rows_a = M - m0, rows_b = N - n0;
  auto load = [&](int s, TAB* st) {
    const int k0 = k_lo + s * KS;
    ffma_stage_rows<G, VEC, G::BM>(st, a0, K, rows_a, k0, k_hi);
    ffma_stage_rows<G, VEC, G::BN>(st + G::A_ELEMS, b0, K, rows_b, k0, k_hi);
  };
  ffma_prologue<G>(n_steps, stages, load);
  // C's loads overlap the first stages'
  float acc[TM][TN];
  if (rank == 0) {
    ffma_seed<G>(acc, c, N, M, N, m0, n0);
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  ffma_steps<G>(acc, n_steps, stages, load);

  // this rank's partial sums, then the cluster's: rank r sums rows
  // [r BM / split, (r + 1) BM / split) of every partial in rank order, four
  // columns at a time, every rank's four loaded before the sum
  constexpr int RLD = RED_LD;
  constexpr int BN4 = G::BN / 4;
  const int tx = ffma_tx(), ty = ffma_ty();
  __syncthreads();                      // the last stage's readers are done
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      red[(ty + FFMA_SIDE * i) * RLD + tx + FFMA_SIDE * j] = acc[i][j];
  cluster.sync();
  const float* parts[MAX_SPLIT];
#pragma unroll
  for (int q = 0; q < MAX_SPLIT; ++q)
    parts[q] = cluster.map_shared_rank(red, q < split ? q : 0);
  const int r_lo = rank * G::BM / split, r_hi = (rank + 1) * G::BM / split;
  for (int e = threadIdx.x; e < (r_hi - r_lo) * BN4; e += FFMA_THREADS) {
    const int r = r_lo + e / BN4, cc = (e % BN4) * 4;
    float4 part[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < split) part[q] = *reinterpret_cast<const float4*>(parts[q] + r * RLD + cc);
    float v[4] = {part[0].x, part[0].y, part[0].z, part[0].w};
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q)
      if (q < split) {
        v[0] += part[q].x; v[1] += part[q].y;
        v[2] += part[q].z; v[3] += part[q].w;
      }
    if (m0 + r < M) {
      TC* o = out + (size_t)(m0 + r) * N + n0 + cc;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n0 + cc + i < N) o[i] = from_f32<TC>(v[i]);
    }
  }
  cluster.sync();   // no rank leaves while another reads its partials
}

template <typename TAB, typename TC>
int launch(const void* c, const void* a, const void* b, void* out, int m,
           int n, int k, int split, int chunk, cudaStream_t stream) {
  using G = Geom<TAB>;
  const bool vec = (k % G::VEC == 0) &&
                   (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const int tiles_m = (m + G::BM - 1) / G::BM, tiles_n = (n + G::BN - 1) / G::BN;
  constexpr size_t smem = smem_bytes<TAB>();
  auto kern = vec ? mxp_gemm_kernel<TAB, TC, true>
                  : mxp_gemm_kernel<TAB, TC, false>;
  // a function attribute holds for the card it was set on: once a kernel
  // and card, not a call
  static bool opted_in[MAX_DEVICES][2] = {};
  cudaError_t e;
  int dev;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev][vec]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev][vec] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_m * tiles_n * split);
  cfg.blockDim = dim3(FFMA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const TC*>(c),
                         static_cast<const TAB*>(a), static_cast<const TAB*>(b),
                         static_cast<TC*>(out), m, n, k, tiles_n, split, chunk);
  return static_cast<int>(e);
}

template <typename TC>
int dispatch_ab(const void* c, const void* a, const void* b, void* out, int m,
                int n, int k, int ab_dtype, int split, int chunk,
                cudaStream_t s) {
  switch (ab_dtype) {
    case DT_F32:
      return launch<float, TC>(c, a, b, out, m, n, k, split, chunk, s);
    case DT_BF16:
      return launch<__nv_bfloat16, TC>(c, a, b, out, m, n, k, split, chunk, s);
    case DT_F8E4M3:
      return launch<__nv_fp8_e4m3, TC>(c, a, b, out, m, n, k, split, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out = C - A @ B^T with the wrapper's geometry: split CTAs a 128 x 64 tile
// (1 to 8) and chunk K columns a CTA (a multiple of 32, split chunks
// covering k and the last one not empty); any other is refused. Returns
// cudaGetLastError() after the launch.
extern "C" int mxp_gemm_update(const void* c, const void* a, const void* b,
                               void* out, int m, int n, int k, int ab_dtype,
                               int c_dtype, int split, int chunk,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || split < 1 || split > MAX_SPLIT ||
      chunk <= 0 || chunk % KS || (long long)split * chunk < k ||
      (long long)(split - 1) * chunk >= k)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (c_dtype) {
    case DT_F32:
      err = dispatch_ab<float>(c, a, b, out, m, n, k, ab_dtype, split, chunk, s);
      break;
    case DT_BF16:
      err = dispatch_ab<__nv_bfloat16>(c, a, b, out, m, n, k, ab_dtype, split,
                                       chunk, s);
      break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
