// Symmetric rank-k update  out = C - A @ A^T  for Hopper (sm_90a), as a
// cluster split-K.
//
// Replaces: src/repro/kernels/syrk.py, _syrk_kernel, together with the
// mirror that its wrapper (src/repro/kernels/ops.py, syrk_update) applies
// afterwards: the lower triangle of C - A @ A^T is computed in f32 from
// f32 or bf16 operands with f32 FFMA (no TF32: the f32 class rounds at
// 2^-24), and the strictly upper triangle of the result is the transpose of
// the lower one, in C's type.
//
// What bounds it here: operations. At the executor's 512 x 512 tile, the
// 36 lower 64 x 64 blocks take 151 MFLOP against 3 MiB of f32 traffic, well
// above the card's f32 ridge of 20 flops a byte. One block per output tile
// leaves 96 of the 132 SMs idle at that size.
//
// What the design does about it: each lower 64 x 64 block gets a thread
// block cluster of `split` CTAs (4 at K = 512: 144 CTAs, all resident at
// once), and CTA rank r takes the K chunk [r chunk, (r + 1) chunk). Its
// operands stream through two shared-memory stages of 32 K columns, filled
// with 16-byte cp.async while the other stage feeds the FFMAs (rows whose
// length or address is not a multiple of 16 bytes take plain loads). Each
// thread owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of the block,
// which keeps the float4 reads of shared memory free of bank conflicts.
// Rank 0 seeds its accumulator with C; the partial sums then meet through
// distributed shared memory: every rank sums the `split` partials of its
// share of the block's rows in rank order (deterministic, no atomics) and
// writes them and their mirror. The launch geometry (blocks, split, chunk)
// comes from the wrapper (repro_torch/kernels/syrk.py), which the kernel
// checks.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 64;            // output rows and columns of a block
constexpr int KS = 32;              // K columns a stage
constexpr int THREADS = 256;        // 16 x 16 threads, 4 x 4 values each
constexpr int MAX_SPLIT = 8;        // a portable cluster

template <typename TA> struct Stage {
  static constexpr int PAD = 16 / sizeof(TA);   // rows stay 16-byte aligned
  static constexpr int LD = KS + PAD;                // row stride, elements
  static constexpr int ELEMS = TILE * LD;            // one operand
  static constexpr int VEC = 16 / sizeof(TA);        // elements a cp.async
};

constexpr int RED_LD = TILE + 1;    // partial sums, [TILE][RED_LD] f32
constexpr int SMEM_BYTES = 2 * 2 * TILE * (KS + 4) * 4;   // f32 stages, largest
static_assert(SMEM_BYTES >= TILE * RED_LD * 4, "partials fit the stages");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// stage rows m0 .. m0 + 63 and K columns k0 .. k0 + KS - 1 (< k_hi) of A
// into dst [TILE][LD]; out-of-range entries read as zero
template <typename TA, bool VEC>
__device__ __forceinline__ void load_stage(TA* dst, const TA* __restrict__ a,
                                           int M, int K, int m0, int k0,
                                           int k_hi) {
  using S = Stage<TA>;
  if constexpr (VEC) {
    constexpr int PER_ROW = KS / S::VEC;
    for (int e = threadIdx.x; e < TILE * PER_ROW; e += THREADS) {
      const int r = e / PER_ROW, kv = (e % PER_ROW) * S::VEC;
      const int gr = m0 + r, gk = k0 + kv;
      // K and the chunk hold whole vectors: a vector is all in or all out
      const bool in = gr < M && gk < k_hi;
      const TA* src = in ? a + (size_t)gr * K + gk : a;
      cp_async16(dst + r * S::LD + kv, src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < TILE * KS; e += THREADS) {
      const int r = e / KS, kk = e % KS;
      const int gr = m0 + r, gk = k0 + kk;
      dst[r * S::LD + kk] = (gr < M && gk < k_hi) ? a[(size_t)gr * K + gk]
                                                  : from_f32<TA>(0.f);
    }
  }
}

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

template <typename TA, typename TC, bool VEC>
__global__ void __launch_bounds__(THREADS)
    syrk_kernel(const TC* __restrict__ c, const TA* __restrict__ a,
                TC* __restrict__ out, int M, int K, int split, int chunk) {
  using S = Stage<TA>;
  __shared__ __align__(16) uint8_t smem[SMEM_BYTES];
  TA* stages = reinterpret_cast<TA*>(smem);      // [2][A, B][TILE][LD]
  float* red = reinterpret_cast<float*>(smem);   // [TILE][RED_LD], after

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // blockIdx.x / split enumerates the lower blocks row by row:
  // t = bi (bi + 1) / 2 + bj
  const int t = blockIdx.x / split;
  int bi = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  while (bi * (bi + 1) / 2 > t) --bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int m0 = bi * TILE, n0 = bj * TILE;
  const int k_lo = rank * chunk, k_hi = min(K, k_lo + chunk);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      acc[i][j] = (rank == 0 && r < M && col < M)
                      ? to_f32(c[(size_t)r * M + col]) : 0.f;
    }

  const int n_steps = k_hi > k_lo ? (k_hi - k_lo + KS - 1) / KS : 0;
  auto stage_a = [&](int s) { return stages + s * 2 * S::ELEMS; };
  if (n_steps > 0) {
    load_stage<TA, VEC>(stage_a(0), a, M, K, m0, k_lo, k_hi);
    load_stage<TA, VEC>(stage_a(0) + S::ELEMS, a, M, K, n0, k_lo, k_hi);
  }
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      TA* nxt = stage_a((step + 1) & 1);
      const int k0 = k_lo + (step + 1) * KS;
      load_stage<TA, VEC>(nxt, a, M, K, m0, k0, k_hi);
      load_stage<TA, VEC>(nxt + S::ELEMS, a, M, K, n0, k0, k_hi);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const TA* as = stage_a(step & 1);
    const TA* bs = as + S::ELEMS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 4) {
      float av[4][4], bv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(as + (ty + 16 * i) * S::LD + kk, av[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(bs + (tx + 16 * j) * S::LD + kk, bv[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(-av[i][q], bv[j][q], acc[i][j]);
    }
    __syncthreads();
  }

  // this rank's partial sums, then the cluster's: rank r sums rows
  // [r TILE / split, (r + 1) TILE / split) of every partial in rank order
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(ty + 16 * i) * RED_LD + tx + 16 * j] =
        acc[i][j];
  cluster.sync();
  const float* parts[MAX_SPLIT];
  for (int r = 0; r < split; ++r) parts[r] = cluster.map_shared_rank(red, r);
  const int r_lo = rank * TILE / split, r_hi = (rank + 1) * TILE / split;
  for (int e = threadIdx.x; e < (r_hi - r_lo) * TILE; e += THREADS) {
    const int r = r_lo + e / TILE, cc = e % TILE;
    const int gr = m0 + r, gc = n0 + cc;
    // a diagonal block takes its upper half from the mirrored lower half
    const int src = (bi > bj || r >= cc) ? r * RED_LD + cc : cc * RED_LD + r;
    float v = parts[0][src];
    for (int q = 1; q < split; ++q) v += parts[q][src];
    if (gr < M && gc < M) {
      out[(size_t)gr * M + gc] = from_f32<TC>(v);
      if (bi > bj) out[(size_t)gc * M + gr] = from_f32<TC>(v);
    }
  }
  cluster.sync();   // no rank leaves while another reads its partials
}

template <typename TA, typename TC>
int launch(const void* c, const void* a, void* out, int m, int k, int blocks,
           int split, int chunk, cudaStream_t stream) {
  const bool vec = (k % Stage<TA>::VEC == 0) &&
                   (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const TC* cp = static_cast<const TC*>(c);
  const TA* ap = static_cast<const TA*>(a);
  TC* op = static_cast<TC*>(out);
  const cudaError_t e =
      vec ? cudaLaunchKernelEx(&cfg, syrk_kernel<TA, TC, true>, cp, ap, op, m,
                               k, split, chunk)
          : cudaLaunchKernelEx(&cfg, syrk_kernel<TA, TC, false>, cp, ap, op, m,
                               k, split, chunk);
  return static_cast<int>(e);
}

}  // namespace

// out = C - A @ A^T on the lower triangle, mirrored into the upper one;
// blocks, split and chunk are the wrapper's geometry: blocks = nb (nb + 1)
// / 2 lower blocks (nb = ceil(m / 64)), split CTAs a block (1 to 8),
// chunk K columns a CTA (a multiple of 32, split chunks covering k and the
// last one not empty). Returns cudaGetLastError() after the launch.
extern "C" int syrk_update(const void* c, const void* a, void* out, int m,
                           int k, int a_dtype, int c_dtype, int blocks,
                           int split, int chunk, void* stream) {
  const int nb = (m + TILE - 1) / TILE;
  if (m <= 0 || k <= 0 || blocks != nb * (nb + 1) / 2 || split < 1 ||
      split > MAX_SPLIT || chunk <= 0 || chunk % KS ||
      (long long)split * chunk < k || (long long)(split - 1) * chunk >= k)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (a_dtype == DT_F32 && c_dtype == DT_F32)
    err = launch<float, float>(c, a, out, m, k, blocks, split, chunk, s);
  else if (a_dtype == DT_F32 && c_dtype == DT_BF16)
    err = launch<float, __nv_bfloat16>(c, a, out, m, k, blocks, split, chunk,
                                       s);
  else if (a_dtype == DT_BF16 && c_dtype == DT_F32)
    err = launch<__nv_bfloat16, float>(c, a, out, m, k, blocks, split, chunk,
                                       s);
  else if (a_dtype == DT_BF16 && c_dtype == DT_BF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(c, a, out, m, k, blocks, split,
                                               chunk, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
