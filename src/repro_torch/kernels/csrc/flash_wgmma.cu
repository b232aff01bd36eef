// Causal or full attention with an online softmax on Hopper's tensor cores
// (sm_90a: TMA, mbarrier, wgmma, setmaxnreg), for bf16 q, k and v.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel, and the
// layout work of its wrappers flash_attention and flash_gqa, for bf16
// inputs at head dims 64, 128, 192 and 256 (f32 inputs keep the FFMA
// kernel of flash_attention.cu: f32 on the tensor cores would be TF32). The
// function is that kernel's:
//   s = (q . k) * scale, masked to -1e30 where kj > qi (causal) or kj >= T,
//   m' = max(m, max_j s), p = exp(s - m'), l = l e^(m - m') + sum_j p,
//   acc = acc e^(m - m') + p . v, and at the end o = acc / max(l, 1e-30)
// in bf16. m, l and acc are f32. The exponentials are exp2f (ex2.approx)
// with log2(e) folded into the scale: p = exp2(s c - m c) with c = scale
// log2(e), one FFMA and one ex2, is exp((s - m) scale) within a few ulp.
//
// The two products:
// - S = Q K^T: wgmma f32.bf16.bf16 with both operands in shared memory,
//   K-major (hd contiguous), 128-byte swizzle. The products of two bf16
//   values are exact in f32.
// - P V: P is split in registers, hi = bf16(p) and lo = bf16(p - hi), and
//   both halves go through wgmma with A from registers (the accumulator
//   fragment of S is already the A fragment) and V from shared memory,
//   MN-major (the transpose bit), into one f32 acc. hi + lo keeps about 16
//   bits of p (2^-17 relative), where P rounded to bf16 alone (2^-9) would
//   not be the reference's function.
//
// What bounds it here: operations. At qwen3-14b's prefill shape (B 4, 40
// heads over 8, S = T = 2048, hd 128, causal) the three products are 2.6e11
// flops against 0.17 GB of q, k, v and o: 0.26 ms at 989 TFLOP/s, 0.05 ms
// at 3.35 TB/s.
//
// What the design does about it: one block per (batch x query head, 128
// query rows), 384 threads: two consumer warpgroups of 64 rows each and a
// producer warpgroup whose first thread issues the TMA loads (setmaxnreg
// moves registers from the producer to the consumers). Q is loaded once;
// K and V tiles of 128 keys (64 above hd 128, where acc takes the
// registers) stream through a ring of 2-4 stages (by head dim, to fit
// 227 KB), each with a full barrier (TMA bytes) and an empty barrier (one
// arrival per consumer warp). In each warpgroup the softmax of tile j + 1
// runs while P_j V is on the tensor cores, and the rescale of acc is
// skipped where no row's max moved. The tensor maps span the
// model's own [B, S, H, hd] and [B, T, KV, hd] layouts, so there is no
// transpose and no replication of K or V: GQA is by index, kv = bh /
// group. TMA fills rows past S or T with zeros; only rows qi < S are
// written. Causal blocks stop at the diagonal (with 64-key tiles the
// lower warpgroup one tile earlier), mask by index on the tiles that cross
// it, and run longest-first. S is one wgmma as wide as the tile; P V one
// as wide as hd up to hd 128, and one per 64-wide column block of V above.
#include <stddef.h>
#include <stdint.h>

#include <cuda.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BQ = 128;           // query rows a block
constexpr int CB = 64;            // bf16 columns of one 128-byte swizzle row
constexpr int THREADS = 384;      // two consumer warpgroups + the producer
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD> struct Cfg {
  static constexpr int NC = HD / CB;                       // column blocks
  // keys a tile: 128 up to hd 128; 64 above, where acc takes the registers
  static constexpr int BKV = HD <= 128 ? 128 : 64;
  static constexpr int SN = BKV / 2;                       // S values a thread
  static constexpr int STAGES = HD == 64 ? 4 : (HD == 256 ? 2 : 3);
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;            // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// a [CB cols, 1, rows, 1] box of a 4-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile whose rows are 128 bytes,
// consecutive 8-row groups 1024 bytes apart: the start address, LBO and
// SBO (in 16-byte units) and the 128-byte swizzle mode. For the K-major
// operands (Q, K) SBO is the stride between 8-row groups and LBO is
// unused. For the MN-major V, LBO is the stride between 64-column blocks
// along N and SBO the stride between 8-row groups along K (the swapped
// reading gives wrong products on the card).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo = 1024,
                                               uint32_t sbo = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to the accumulators across the
// asynchronous wgmma region
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WG_DREGS                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

#define WG_D64(d)                                                            \
  WG_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WG_DREGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N f32) (+)= A (64 x 16, K-major, smem) . B (N x 16, K-major,
// smem)^T for N = 2 x the length of d; d is overwritten when accumulate == 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_DREGS
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_DREGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : WG_D64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N f32) += A (64 x 16 bf16, registers) . B (16 x N, MN-major,
// smem) for N = 2 x the length of d
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_DREGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_DREGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : WG_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// s = Q K^T for this warpgroup's 64 rows and one tile of keys, over hd in
// steps of 16 (32 bytes within a 128-byte row)
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[Cfg<HD>::SN],
                                        uint32_t qbase, uint32_t kbase) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss(s, desc_sw128(qbase + c * BQ * CB * 2 + off),
             desc_sw128(kbase + c * Cfg<HD>::BKV * CB * 2 + off), kk > 0);
  }
}

// acc += P_hi V + P_lo V over one tile of V (MN-major); V's 16-key steps
// are 16 rows of 128 bytes. Up to hd 128 one wgmma spans all of hd (its
// 64-column blocks BKV x 128 bytes apart, LBO); above, one wgmma per
// 64-column block.
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&acc)[HD / CB][32], const uint32_t (&ph)[Cfg<HD>::BKV / 16][4],
    const uint32_t (&pl)[Cfg<HD>::BKV / 16][4], uint32_t vbase) {
  constexpr uint32_t BLOCK = Cfg<HD>::BKV * CB * 2;   // one column block
  if constexpr (HD <= 128) {
    float (&d)[HD / 2] = reinterpret_cast<float (&)[HD / 2]>(acc);
#pragma unroll
    for (int kk = 0; kk < Cfg<HD>::BKV / 16; ++kk) {
      const uint64_t dv = desc_sw128(vbase + kk * 16 * CB * 2, BLOCK);
      wgmma_rs(d, ph[kk], dv);
      wgmma_rs(d, pl[kk], dv);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < Cfg<HD>::BKV / 16; ++kk)
#pragma unroll
      for (int c = 0; c < HD / CB; ++c) {
        const uint64_t dv =
            desc_sw128(vbase + c * BLOCK + kk * 16 * CB * 2, BLOCK);
        wgmma_rs(acc[c], ph[kk], dv);
        wgmma_rs(acc[c], pl[kk], dv);
      }
  }
}

// The online softmax of one tile on the fragment: s[4j + 2i + e] is row
// r0 + 8i, key k0 + 8j + cpair + e. m is in the units of s; p =
// exp2(s sl2 - m sl2) with sl2 = scale log2(e), one FFMA and one ex2. On
// return s holds p, m and l are updated, and alpha is the factor for acc.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int t_len, int r0,
                                             int cpair, int qw, int causal,
                                             float sl2) {
  constexpr int BK = 2 * N;
  const bool edge = (k0 + BK > t_len) || (causal && k0 + BK - 1 > qw);
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + cpair + e, qi = r0 + 8 * i;
          if (kj >= t_len || (causal && kj > qi))
            s[4 * j + 2 * i + e] = NEG_INF;
        }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], s[4 * j + 2 * i]);
      mx[i] = fmaxf(mx[i], s[4 * j + 2 * i + 1]);
    }
  float neg_ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = exp2f((m[i] - m_new) * sl2);
    m[i] = m_new;
    neg_ms[i] = -m_new * sl2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(s[4 * j + 2 * i + e], sl2, neg_ms[i]));
        s[4 * j + 2 * i + e] = p;
        sum[i] += p;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l[i] = l[i] * alpha[i] + sum[i];
  }
}

// P = hi + lo in bf16, as A fragments: for keys 16 kk .. 16 kk + 15,
// a0 = (r0, cpair), a1 = (r0 + 8, cpair), a2 = (r0, 8 + cpair), a3 =
// (r0 + 8, 8 + cpair), i.e. p[8 kk + 0..7] in pairs
template <int N>
__device__ __forceinline__ void split_p(const float (&p)[N],
                                        uint32_t (&ph)[N / 8][4],
                                        uint32_t (&pl)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = p[8 * kk + 2 * r], x1 = p[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          x0 - __low2float(hi), x1 - __high2float(hi));
      ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int s_len, int t_len,
                       int nh, int nkv, int group, int causal, float scale) {
  using C = Cfg<HD>;
  constexpr int NC = C::NC, ST = C::STAGES, BKV = C::BKV, SN = C::SN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                          // [NC][BQ][CB]
  uint8_t* kvs = smem + C::Q_BYTES;            // [ST][K, V][NC][BKV][CB]
  const uint32_t bars = smem_u32(smem + C::BAR_OFF);
  const uint32_t qbar = bars;                  // then full[ST], empty[ST]
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + ST + st); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int b = bh / nh, h = bh % nh;
  const int kvi = bh / group, bkv = kvi / nkv, hk = kvi % nkv;
  int n_tiles = (t_len + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);          // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 256) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        tma_load(smem_u32(qs + c * BQ * CB * 2), &qmap, qbar, c * CB, h, q0,
                 b);
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int st = jt % ST;
        if (jt >= ST) mbar_wait(empty(st), ((jt / ST) - 1) & 1);
        uint8_t* ks = kvs + st * C::STAGE_BYTES;
        uint8_t* vs = ks + C::KV_BYTES;
        mbar_expect_tx(full(st), C::STAGE_BYTES);
        for (int c = 0; c < NC; ++c) {
          tma_load(smem_u32(ks + c * BKV * CB * 2), &kmap, full(st), c * CB,
                   hk, jt * BKV, bkv);
          tma_load(smem_u32(vs + c * BKV * CB * 2), &vmap, full(st), c * CB,
                   hk, jt * BKV, bkv);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int qw = q0 + wg * 64;
    // this thread's two rows of every fragment, and its column pair
    const int r0 = qw + warp * 16 + lane / 4;
    const int cpair = 2 * (lane % 4);
    int n_mine = n_tiles;
    if (causal) n_mine = min(n_mine, (qw + 63) / BKV + 1);
    const float sl2 = scale * LOG2E;

    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    const uint32_t qbase = smem_u32(qs) + wg * 64 * CB * 2;
    auto kbase = [&](int jt) {
      return smem_u32(kvs + (jt % ST) * C::STAGE_BYTES);
    };

    // The loop overlaps each tile's softmax with the tensor cores: while
    // P_j V runs, S_{j+1} = Q K_{j+1}^T has finished and its softmax
    // proceeds in registers. s holds S, then P, of the next tile. Every
    // warpgroup reads at least one tile; the last tile is peeled, so no
    // wgmma sits on a branch (ptxas would serialize them).
    float s[SN], alpha[2];
    uint32_t ph[SN / 8][4], pl[SN / 8][4];
    mbar_wait(full(0), 0);
    fence_regs(s);
    wgmma_fence();
    issue_s<HD>(s, qbase, kbase(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, alpha, 0, t_len, r0, cpair, qw, causal, sl2);
    for (int jt = 0; jt + 1 < n_mine; ++jt) {
      split_p(s, ph, pl);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      fence_regs(s);
      mbar_wait(full((jt + 1) % ST), ((jt + 1) / ST) & 1);
      wgmma_fence();
      issue_s<HD>(s, qbase, kbase(jt + 1));
      wgmma_commit();
      issue_pv<HD>(acc, ph, pl, kbase(jt) + C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<1>();              // S_{j+1}; P_j V may still run
      fence_regs(s);
      softmax_tile(s, m, l, alpha, (jt + 1) * BKV, t_len, r0, cpair, qw,
                   causal, sl2);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(jt % ST));
      // rows whose max did not move keep alpha = 1: skip the multiplies
      // when no row of the warp moved
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                acc[c][4 * j + 2 * i + e] *= alpha[i];
      }
    }
    {   // the last tile: P V alone
      split_p(s, ph, pl);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      wgmma_fence();
      issue_pv<HD>(acc, ph, pl, kbase(n_mine - 1) + C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    }

    // o = acc / max(l, 1e-30), rows qi < S only
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = r0 + 8 * i;
      if (qi >= s_len) continue;
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = o + ((size_t)(b * (size_t)s_len + qi) * nh + h)
                                    * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * i] / den, acc[c][4 * j + 2 * i + 1] / den);
          *reinterpret_cast<__nv_bfloat162*>(orow + c * CB + 8 * j + cpair) =
              v;
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [batch, rows, heads, hd] bf16 tensor as a 4-D map, boxes of 64
// columns x 1 head x box_rows rows x 1 batch, 128-byte swizzle; rows past
// the end read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows,
              int heads, int hd, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CB, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s_len, int t_len, int nh, int nkv, int group, int causal,
           float scale, cudaStream_t stream) {
  const int batch = bh / nh, kv_batch = bh / group / nkv;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, batch, s_len, nh, HD, BQ) ||
      !make_map(&km, k, kv_batch, t_len, nkv, HD, Cfg<HD>::BKV) ||
      !make_map(&vm, v, kv_batch, t_len, nkv, HD, Cfg<HD>::BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<HD>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (s_len + BQ - 1) / BQ);
  flash_wgmma_kernel<HD><<<grid, THREADS, Cfg<HD>::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), s_len, t_len, nh, nkv,
      group, causal, scale);
  return 0;
}

}  // namespace

// o = attention(q, k, v) in bf16 over bh = B * nh rows of blocks; q/o
// [B, S, nh, hd], k/v [B, T, nkv, hd] with kv head bh / group; hd 64, 128,
// 192 or 256. Returns cudaGetLastError() after the launch.
// bq, bk and stages are the geometry the wrapper computed
// (repro_torch/kernels/flash_attention.py: TC_BQ, TC_BK, TC_STAGES); the
// kernel refuses any other.
extern "C" int flash_wgmma(const void* q, const void* k, const void* v,
                           void* o, int bh, int s_len, int t_len, int nh,
                           int nkv, int group, int hd, int causal, int bq,
                           int bk, int stages, float scale, void* stream) {
  if (bh <= 0 || s_len <= 0 || t_len <= 0 || nh <= 0 || nkv <= 0 ||
      group <= 0 || bh % nh || (bh / group) % nkv ||
      (s_len + BQ - 1) / BQ > 65535 || bq != BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int want_bk = hd == 64    ? Cfg<64>::BKV
                      : hd == 128 ? Cfg<128>::BKV
                      : hd == 192 ? Cfg<192>::BKV
                                  : Cfg<256>::BKV;
  const int want_stages = hd == 64    ? Cfg<64>::STAGES
                          : hd == 128 ? Cfg<128>::STAGES
                          : hd == 192 ? Cfg<192>::STAGES
                                      : Cfg<256>::STAGES;
  if (bk != want_bk || stages != want_stages)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (hd) {
    case 64: err = launch<64>(q, k, v, o, bh, s_len, t_len, nh, nkv, group,
                              causal, scale, s); break;
    case 128: err = launch<128>(q, k, v, o, bh, s_len, t_len, nh, nkv, group,
                                causal, scale, s); break;
    case 192: err = launch<192>(q, k, v, o, bh, s_len, t_len, nh, nkv, group,
                                causal, scale, s); break;
    case 256: err = launch<256>(q, k, v, o, bh, s_len, t_len, nh, nkv, group,
                                causal, scale, s); break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
