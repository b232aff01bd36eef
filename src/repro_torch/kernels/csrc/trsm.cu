// Triangular solve  X @ L^T = C  (right side, L lower) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/trsm.py, _trsm_kernel. L [n, n] and C [m, n]
// are f32 or bf16; the solve runs in f32, x_j = (c_j - sum_{k<j} x_k L[j, k])
// / L[j, j], and the result is cast to C's type. Only L's lower triangle is
// read.
//
// What bounds it here: the dependence chain, not the card's rates. The
// 512 x 512 solve is 134 MFLOP over 3 MiB (a bound of 2 us), but column j of
// a row waits for its columns 0..j-1. The first port ran each row as a chain
// of n dot products, one warp a row, with a shuffle reduction at every link
// (0.45 ms at n = 512).
//
// What the design does about it: a blocked forward substitution over row
// panels. Rows are independent, so one block of four warps owns
// TRSM_ROWS = 4 rows of C (128 blocks at m = 512, about one per SM) and
// nothing crosses blocks. The block keeps its rows of X in shared memory for
// the whole walk (4 x n f32, 64 KiB at n = 4096), stored k-major so that one
// 16-byte load gives x_k of all four rows, and walks the column blocks J of
// width NB = 64:
//   1. the update X_J -= X_{<J} L_{J,<J}^T: L's panel is staged a 64 x 64
//      chunk at a time, transposed into shared memory; each lane holds eight
//      f32 accumulators (the four rows at its columns j0 + lane and
//      j0 + lane + 32), so one chunk value read feeds four FFMAs, and the
//      four warps split each chunk's k (every fourth k), their partial sums
//      added in a fixed order afterwards.
//   The walk reads L as one sequence of 64 x 64 chunks (J's panel chunks,
//   then L_JJ), and each chunk's global loads (16-byte vectors where n is a
//   multiple of four) are issued into registers before the chunk ahead of
//   it is used: a register double buffer (cp.async cannot widen bf16), so
//   the L2 latency of a chunk overlaps the FFMAs or the row solve before it.
//   2. the solve against the diagonal block L_JJ in shared memory, one warp
//      a row (solve_row_block): one link per column, a shuffle that
//      broadcasts x_c, the quotient by L[c][c] (Markstein's correction of a
//      product with the rounded reciprocal: the correctly rounded quotient
//      in three FMAs) and one FFMA a lane, with no reduction.
// The chain is thus n short links, and the O(m n^2) rest is spread over the
// SMs. Every product is f32 FFMA (no TF32: core/precision.py's f32 class
// rounds at 2^-24); the sums run in another order than the column loop's,
// which is why the card checks hold each row's residual at its own scale.
// The launch geometry (rows a block, blocks, shared memory) comes from
// kernels/trsm.py, and trsm() refuses any other.
#include <stddef.h>

#include "common.cuh"
#include "tri_block.cuh"

constexpr int TRSM_ROWS = 4;                          // mirrored by trsm.py
constexpr int TRSM_WARPS = 4;
constexpr int TRSM_THREADS = 32 * TRSM_WARPS;
constexpr int KC = NB;                                // update chunk width
constexpr int PER = NB * KC / TRSM_THREADS;           // chunk loads a thread

static size_t smem_bytes(int n) {                     // mirrored by trsm.py
  return sizeof(float) *
         ((size_t)TRSM_ROWS * n + KC * NB_LD + NB * NB_LD + 2 * NB);
}

// Four consecutive elements of a row, widened to f32, in one 16-byte (f32)
// or 8-byte (bf16) load; p must be aligned to four elements.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// pre[4 q + i] = L[j0 + jj][kc + kk + i] of a 64 x 64 chunk, with
// (jj, kk) = the q-th four-element slot of this thread; rows past w and
// columns past n read as zero. With n a multiple of four every slot is one
// vector load; otherwise four clamped scalar loads and a select (no branch
// around a load).
template <typename TL>
__device__ __forceinline__ void load_chunk(float (&pre)[PER],
                                           const TL* __restrict__ l, int n,
                                           int j0, int kc, bool vec) {
  const int w = min(NB, n - j0);
#pragma unroll
  for (int q = 0; q < PER / 4; ++q) {
    const int e = threadIdx.x + q * TRSM_THREADS, jj = e / (KC / 4);
    const int kk = e % (KC / 4) * 4;
    const TL* row = l + (size_t)(j0 + min(jj, w - 1)) * n;
    float v[4];
    if (vec) {
      load4(row + min(kc + kk, n - 4), v);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = to_f32(row[min(kc + kk + i, n - 1)]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pre[4 * q + i] = jj < w && kc + kk + i < n ? v[i] : 0.f;
  }
}

template <typename TL, typename TC>
__global__ void __launch_bounds__(TRSM_THREADS)
    trsm_kernel(const TL* __restrict__ l, const TC* __restrict__ c,
                TC* __restrict__ out, int m, int n) {
  extern __shared__ __align__(16) float sm[];
  float* sx = sm;                       // n x TRSM_ROWS: X, column-major by row
  float* sl = sx + TRSM_ROWS * n;       // KC x NB_LD: L[j0+jj][kc+kk] at (kk, jj)
  float* red = sl;                      // the warps' partial sums, after a walk
  float* sd = sl + KC * NB_LD;          // NB x NB_LD: L_JJ, lower triangle
  float* dg = sd + NB * NB_LD;          // NB: L_JJ's diagonal
  float* rg = dg + NB;                  // NB: its reciprocals
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * TRSM_ROWS;
  const int rows = min(TRSM_ROWS, m - row0);
  // The walk reads L as one sequence of 64 x 64 chunks: for each J, the
  // chunks of its panel left of the diagonal, then L_JJ. Each chunk's loads
  // are in flight while the one before it is used.
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<size_t>(l) % (4 * sizeof(TL)) == 0;
  float pre[PER];
  load_chunk(pre, l, n, 0, 0, vec);
  for (int e = tid; e < TRSM_ROWS * n; e += TRSM_THREADS) {
    const int r = e / n, k = e % n;
    const float v = to_f32(c[(size_t)(row0 + min(r, rows - 1)) * n + k]);
    sx[k * TRSM_ROWS + r] = r < rows ? v : 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += NB) {
    const int w = min(NB, n - j0);
    float acc[TRSM_ROWS][2] = {};
    for (int kc = 0; kc <= j0; kc += KC) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < PER; ++q) {   // element (i, kc + k) of the chunk
        const int e = tid + q / 4 * TRSM_THREADS, i = e / (KC / 4);
        const int k = e % (KC / 4) * 4 + q % 4;
        if (kc < j0) {                  // a chunk of the panel, transposed
          sl[k * NB_LD + i] = pre[q];
        } else if (i < w && k <= i) {   // L_JJ: its lower triangle
          sd[i * NB_LD + k] = pre[q];
          if (k == i) {
            dg[i] = pre[q];
            rg[i] = 1.f / pre[q];
          }
        }
      }
      if (kc < j0) load_chunk(pre, l, n, j0, kc + KC, vec);
      else if (j0 + NB < n) load_chunk(pre, l, n, j0 + NB, 0, vec);
      __syncthreads();
      if (kc == j0) break;
      // 1. the update from the solved columns < j0: each lane accumulates
      //    the block's four rows at its two columns over every fourth k
#pragma unroll 4
      for (int kk = warp; kk < KC; kk += TRSM_WARPS) {
        const float4 xv = *reinterpret_cast<const float4*>(&sx[(kc + kk) * TRSM_ROWS]);
        const float xr[TRSM_ROWS] = {xv.x, xv.y, xv.z, xv.w};
        const float l0 = sl[kk * NB_LD + lane], l1 = sl[kk * NB_LD + lane + 32];
#pragma unroll
        for (int r = 0; r < TRSM_ROWS; ++r) {
          acc[r][0] = fmaf(xr[r], l0, acc[r][0]);
          acc[r][1] = fmaf(xr[r], l1, acc[r][1]);
        }
      }
    }
    if (j0 > 0) {
#pragma unroll
      for (int r = 0; r < TRSM_ROWS; ++r) {
        red[(warp * TRSM_ROWS + r) * NB + lane] = acc[r][0];
        red[(warp * TRSM_ROWS + r) * NB + lane + 32] = acc[r][1];
      }
      __syncthreads();
    }
    // 2. each warp solves its row against L_JJ
    if (warp < rows) {
      float s0 = 0.f, s1 = 0.f;
      if (j0 > 0)
        for (int v = 0; v < TRSM_WARPS; ++v) {
          s0 += red[(v * TRSM_ROWS + warp) * NB + lane];
          s1 += red[(v * TRSM_ROWS + warp) * NB + lane + 32];
        }
      float* xc = sx + (size_t)j0 * TRSM_ROWS + warp;
      float v0 = lane < w ? xc[lane * TRSM_ROWS] - s0 : 0.f;
      float v1 = lane + 32 < w ? xc[(lane + 32) * TRSM_ROWS] - s1 : 0.f;
      solve_row_block(v0, v1, sd, dg, rg, w);
      if (lane < w) xc[lane * TRSM_ROWS] = v0;
      if (lane + 32 < w) xc[(lane + 32) * TRSM_ROWS] = v1;
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * n; e += TRSM_THREADS) {
    const int r = e / n, k = e % n;
    out[(size_t)(row0 + r) * n + k] = from_f32<TC>(sx[k * TRSM_ROWS + r]);
  }
}

template <typename TL, typename TC>
static int launch(const void* l, const void* c, void* out, int m, int n,
                  int blocks, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trsm_kernel<TL, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trsm_kernel<TL, TC><<<blocks, TRSM_THREADS, smem, stream>>>(
      static_cast<const TL*>(l), static_cast<const TC*>(c),
      static_cast<TC*>(out), m, n);
  return 0;
}

// Solve X @ L^T = C with the geometry kernels/trsm.py computed: `rows` rows
// a block, `blocks` blocks and `smem` bytes of shared memory a block; any
// other geometry is refused. Returns cudaGetLastError() after the launch.
extern "C" int trsm(const void* l, const void* c, void* out, int m, int n,
                    int l_dtype, int c_dtype, int rows, int blocks, int smem,
                    void* stream) {
  if (m <= 0 || n <= 0 || rows != TRSM_ROWS ||
      blocks != (m + TRSM_ROWS - 1) / TRSM_ROWS ||
      static_cast<size_t>(smem) != smem_bytes(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (l_dtype == DT_F32 && c_dtype == DT_F32)
    err = launch<float, float>(l, c, out, m, n, blocks, smem, s);
  else if (l_dtype == DT_F32 && c_dtype == DT_BF16)
    err = launch<float, __nv_bfloat16>(l, c, out, m, n, blocks, smem, s);
  else if (l_dtype == DT_BF16 && c_dtype == DT_F32)
    err = launch<__nv_bfloat16, float>(l, c, out, m, n, blocks, smem, s);
  else if (l_dtype == DT_BF16 && c_dtype == DT_BF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(l, c, out, m, n, blocks, smem, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
