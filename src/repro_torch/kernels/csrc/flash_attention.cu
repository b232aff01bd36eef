// Causal or full attention with an online softmax, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel, and the
// layout work of its wrappers flash_attention and flash_gqa. For each
// (batch x query head, block of query rows) it streams the K/V rows of the
// head's KV head (kv = bh / group) and carries the running row max m, row
// sum l and output accumulator acc in f32:
//   s = (q . k) * scale, masked to -1e30 where kj > qi when causal
//   m' = max(m, max_j s), p = exp(s - m'), l = l e^(m - m') + sum_j p,
//   acc = acc e^(m - m') + p . v, and at the end o = acc / max(l, 1e-30)
// in q's type. Both products are f32 FFMA (no TF32): bf16 inputs are widened
// as they are staged, and P stays in f32 for P . V, as in the reference.
//
// Layout: q and o are [B, S, nh, HD] and k, v are [B, T, nkv, HD], contiguous;
// [BH, S, HD] is the case nh = nkv = 1. The kernel reads the model's layout
// through these strides, so no transpose is made and K/V are never
// replicated per query head.
//
// It serves f32 inputs, whose products on the tensor cores would be TF32;
// bf16 inputs go to flash_wgmma.cu on the tensor cores (the wrapper,
// repro_torch/kernels/flash_attention.py, chooses by dtype and head dim,
// and runs this kernel on bf16 only when asked, to time it).
//
// What bounds it here: operations. At the prefill shape of qwen3-14b
// (B 4, 40 heads over 8, S = T = 2048, HD 128) the causal half is 1.7e11
// flops against 0.2 GB of q, k, v and o. The FFMA rate (67 TFLOP/s), not
// memory, is the limit this design can reach.
//
// What the design does about it: one 256-thread block per 64 query rows;
// each thread owns 4 rows and a 4 x 4 (HD <= 128) or 4 x 2 block of the
// 64 x BK scores, and 4 rows x HD/4 columns of acc in registers. Q (d-major),
// K (d-major) and V (row-major) are staged in f32 in shared memory, padded so
// that the inner loops read float4/float2 without bank conflicts; P reuses
// K's buffer. Row max and sum are reduced over the 16 threads of a row with
// shuffles. KV tiles wholly above the diagonal are skipped (their p is
// exactly 0), and blocks are issued longest-first to even out the causal
// triangle. BK is 64 rows for HD <= 128 and 32 above, so HD = 256 stays at
// 136 KiB of shared memory.
#include <stddef.h>

#include "common.cuh"

constexpr int FA_BQ = 64;          // query rows per block
constexpr int FA_THREADS = 256;    // 16 row groups x 16 column groups
constexpr float FA_NEG_INF = -1e30f;

template <int HD> struct FaTile {
  static constexpr int BK = HD <= 128 ? 64 : 32;   // KV rows per tile
  static constexpr int QS = FA_BQ + 4;              // row stride of Q (d-major)
  static constexpr int KS = BK + 4;                 // row stride of K and P
  static constexpr size_t floats = (size_t)HD * QS + (size_t)HD * KS
                                   + (size_t)BK * HD;
};

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// n consecutive floats from 16-byte (n = 4) or 8-byte (n = 2) aligned smem
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    static_assert(N == 2, "4 or 2 columns per thread");
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s_len,
                 int t_len, int nh, int nkv, int group, int causal,
                 float scale) {
  using Tile = FaTile<HD>;
  constexpr int BK = Tile::BK, QS = Tile::QS, KS = Tile::KS;
  constexpr int CN = BK / 16;        // score columns per thread
  constexpr int DC = HD / 64;        // groups of 4 output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [HD][QS]
  float* ks = qs + HD * QS;                       // [HD][KS]
  float* ps = ks;                                 // [FA_BQ][KS], after s
  float* vs = ks + HD * KS;                       // [BK][HD]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;
  const int b = bh / nh, h = bh % nh;
  const int kvi = bh / group, bk = kvi / nkv, hk = kvi % nkv;
  const size_t q_row = (size_t)nh * HD, kv_row = (size_t)nkv * HD;
  const T* qb = q + ((size_t)b * s_len * nh + h) * HD;
  const T* kb = k + ((size_t)bk * t_len * nkv + hk) * HD;
  const T* vb = v + ((size_t)bk * t_len * nkv + hk) * HD;
  T* ob = o + ((size_t)b * s_len * nh + h) * HD;

  for (int e = tid; e < FA_BQ * HD; e += FA_THREADS) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    qs[d * QS + r] = qi < s_len ? to_f32(qb[(size_t)qi * q_row + d]) : 0.f;
  }

  float acc[4][DC][4], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = FA_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;
  }

  int n_tiles = (t_len + BK - 1) / BK;
  if (causal) {   // tiles wholly above the block's last row add p = 0
    const int q_last = min(q0 + FA_BQ, s_len) - 1;
    n_tiles = min(n_tiles, q_last / BK + 1);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();   // the last tile's P and V are read; Q is written
    for (int e = tid; e < BK * HD; e += FA_THREADS) {
      const int j = e / HD, d = e % HD, kj = k0 + j;
      const bool in = kj < t_len;
      ks[d * KS + j] = in ? to_f32(kb[(size_t)kj * kv_row + d]) : 0.f;
      vs[j * HD + d] = in ? to_f32(vb[(size_t)kj * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][CN];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[CN];
      load_vec<4>(qs + d * QS + ty * 4, qv);
      load_vec<CN>(ks + d * KS + tx * CN, kv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int kj = k0 + tx * CN + c;
        float x = s[r][c] * scale;
        if (kj >= t_len || (causal && kj > qi)) x = FA_NEG_INF;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      l[r] = l[r] * alpha + row_sum16(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] *= alpha;
    }

    __syncthreads();   // every thread has read K: P takes its place
#pragma unroll
    for (int r = 0; r < 4; ++r)
      store_vec<CN>(ps + (ty * 4 + r) * KS + tx * CN, s[r]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = ps[(ty * 4 + r) * KS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float vv[4];
        load_vec<4>(vs + j * HD + c * 64 + tx * 4, vv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][c][e] = fmaf(p[r], vv[e], acc[r][c][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= s_len) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + (size_t)qi * q_row;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[c * 64 + tx * 4 + e] = from_f32<T>(acc[r][c][e] / denom);
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int bh, int s_len, int t_len, int nh, int nkv, int group,
                  int causal, float scale, cudaStream_t stream) {
  const size_t smem = FaTile<HD>::floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(bh, (s_len + FA_BQ - 1) / FA_BQ);
  flash_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, t_len, nh, nkv,
      group, causal, scale);
  return 0;
}

template <typename T>
static int launch_hd(int hd, const void* q, const void* k, const void* v,
                     void* o, int bh, int s_len, int t_len, int nh, int nkv,
                     int group, int causal, float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, bh, s_len, t_len, nh, nkv,
                                  group, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, bh, s_len, t_len, nh, nkv,
                                    group, causal, scale, s);
    case 192: return launch<T, 192>(q, k, v, o, bh, s_len, t_len, nh, nkv,
                                    group, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, bh, s_len, t_len, nh, nkv,
                                    group, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// o = attention(q, k, v) over bh = B * nh (batch x query head) rows of
// blocks; q/o [B, S, nh, hd], k/v [B, T, nkv, hd] with kv head bh / group.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bh, int s_len, int t_len, int nh,
                               int nkv, int group, int hd, int causal,
                               int dtype, float scale, void* stream) {
  if (bh <= 0 || s_len <= 0 || t_len <= 0 || nh <= 0 || nkv <= 0 ||
      group <= 0 || (s_len + FA_BQ - 1) / FA_BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == DT_F32)
    err = launch_hd<float>(hd, q, k, v, o, bh, s_len, t_len, nh, nkv, group,
                           causal, scale, s);
  else if (dtype == DT_BF16)
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, o, bh, s_len, t_len, nh,
                                   nkv, group, causal, scale, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
