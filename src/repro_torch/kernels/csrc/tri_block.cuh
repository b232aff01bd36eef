// Device routines on one diagonal block held in shared memory, shared by the
// blocked POTRF and TRSM kernels.
//
// A diagonal block is at most NB x NB, stored row-major with row stride
// NB_LD = NB + 1, so that the 32 lanes of a warp reading one column (lane i
// reads row i) hit 32 different banks. Only the lower triangle, diagonal
// included, is ever read: the upper triangle may hold anything, NaN
// included, and is never multiplied into a result.
//
// chol_block is the diagonal-block factor of the blocked POTRF. It is written
// for any element type T (float or double) and a block of any number of
// warps, so that the fused column kernel's one-block factor can run it on
// each diagonal block of its tile.
#pragma once

#include <math.h>

constexpr int NB = 64;            // diagonal block edge (mirrored in potrf.py, trsm.py)
constexpr int NB_LD = NB + 1;     // row stride of a block in shared memory

// 1 / sqrt(x) in one MUFU instruction (about 2^-23 relative error; a
// subnormal x reads as zero), and its f64 counterpart.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double rsqrt_approx(double x) { return rsqrt(x); }

constexpr int HB = NB / 2;        // the half block one warp factors in registers

// One link of solve_row_block: column c's quotient, by Markstein's
// correction (fast) or by the division itself, then each later column's
// update v_j -= x L[j][c] in place. Signed zeros come out as the division
// and the reference BLAS trsm give them: the quotient's residual is taken
// as q0 d - v and subtracted (q0 + (v - q0 d) r would turn x = -0 into +0),
// and an update is skipped where L[j][c] is zero, as that trsm skips it (a
// zero product would turn v_j = -0 into +0). Neither adds an operation to
// the chain from one link's shuffle to the next.
template <bool FAST, typename T>
__device__ __forceinline__ void solve_link(T& v0, T& v1, const T* s,
                                           const T* dv, const T* rv, int c,
                                           int lane) {
  const T d = dv[c];
  const T l0 = s[lane * NB_LD + c], l1 = s[(lane + 32) * NB_LD + c];
  const T vc = __shfl_sync(0xffffffffu, c < 32 ? v0 : v1, c & 31);
  T x;
  if (FAST) {
    const T r = rv[c], q0 = vc * r;
    x = fma(-fma(q0, d, -vc), r, q0);
  } else {
    x = vc / d;
  }
  const T u0 = fma(-x, l0, v0), u1 = fma(-x, l1, v1);
  v0 = lane == c ? x : (lane > c && l0 != T(0) ? u0 : v0);
  v1 = lane + 32 == c ? x : (lane + 32 > c && l1 != T(0) ? u1 : v1);
}

// One warp: forward substitution of one row against the w x w (w <= NB)
// lower block s, x_c = (v_c - sum_{k<c} x_k L[c][k]) / dv[c]. Lane l holds
// column l in v0 and column l + 32 in v1; on return they hold x. Lanes past
// w hold junk. Column c is formed from terms with k < c only; a lane whose
// row lies above the diagonal selects its old value instead of the product,
// so nothing above the diagonal (or past w) reaches a result, and a NaN in
// column c reaches columns >= c only.
//
// rv[c] must be 1 / dv[c] rounded to nearest. The quotient on the chain is
// then q0 = v r, e = v - q0 d (exact in an FMA), x = q0 + e r: Markstein's
// correction, which gives the correctly rounded v / d for operands in the
// normal range in three dependent FMAs instead of a division. If any result
// of the row is not finite (a zero, infinite or NaN divisor or operand), the
// row is solved again with the division itself, so special values come out
// as the reference's v / d gives them. A full block or half block is
// unrolled, so each link's lane and register are known at compile time.
// Signed zeros come out as the division gives them (solve_link), which the
// fused column step's epilogue, held bitwise on a solve against I, needs.
template <typename T>
__device__ __forceinline__ void solve_row_block(T& v0, T& v1, const T* s,
                                                const T* dv, const T* rv,
                                                int w) {
  const int lane = threadIdx.x % 32;
  const T in0 = v0, in1 = v1;
  if (w == NB) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      solve_link<true>(v0, v1, s, dv, rv, c, lane);
  } else if (w == HB) {
#pragma unroll
    for (int c = 0; c < HB; ++c)
      solve_link<true>(v0, v1, s, dv, rv, c, lane);
  } else {
    for (int c = 0; c < w; ++c)
      solve_link<true>(v0, v1, s, dv, rv, c, lane);
  }
  const bool bad = (lane < w && !isfinite(v0)) || (lane + 32 < w && !isfinite(v1));
  if (__any_sync(0xffffffffu, bad)) {
    v0 = in0;
    v1 = in1;
    for (int c = 0; c < w; ++c)
      solve_link<false>(v0, v1, s, dv, rv, c, lane);
  }
}

// One warp factors the HB x HB lower block at a into l (both with row
// stride NB_LD; they may be the same), w <= HB rows and columns of it valid:
// lane i holds row i in registers, the loop over the columns is unrolled,
// and a column is one shuffle of its pivot p, r ~ 1 / sqrt(p) in one
// instruction, d = sqrt(p) from it by a Newton step, the quotient v / d by
// Markstein's correction (q0 = v r, x = q0 + (v - q0 d) r: within an ulp of
// the reference's sqrt and division, with neither a division nor a branch
// on the chain), then shuffles of L[k][c] to the later columns' updates,
// which run in the shadow of the next pivot's chain. The lane that owns the
// next pivot forms it first (fma(-l, l, a), the same value its update gives).
// Returns true in every lane if a stored entry is not finite. A call of its
// own, small enough to stay in the instruction cache between calls.
template <typename T>
__device__ __noinline__ bool chol_half(const T* a, T* l, T* piv, int w) {
  const int lane = threadIdx.x % 32;
  T r_[HB];                             // row lane
#pragma unroll
  for (int k = 0; k < HB; ++k) r_[k] = a[lane * NB_LD + k];
  T pn = r_[0];                         // the next pivot, in its row's lane
  bool bad = false;
#pragma unroll
  for (int c = 0; c < HB; ++c) {
    const T p = __shfl_sync(0xffffffffu, pn, c);
    const T r = rsqrt_approx(p), d0 = p * r;
    const T d = fma(T(0.5) * r, fma(-d0, d0, p), d0);
    const T q0 = r_[c] * r;
    const T lc = fma(fma(-q0, d, r_[c]), r, q0);
    if (lane >= c && lane < w) {
      l[lane * NB_LD + c] = lc;
      bad |= !isfinite(lc);
    }
    if (lane == 0) piv[c] = d;
    if (c + 1 < HB) pn = fma(-lc, lc, r_[c + 1 < HB ? c + 1 : 0]);
#pragma unroll
    for (int k = c + 1; k < HB; ++k)
      r_[k] = fma(-lc, __shfl_sync(0xffffffffu, lc, k), r_[k]);
  }
  return __any_sync(0xffffffffu, bad);
}

// The same factor of the w x w block with sqrt and the division themselves,
// by one warp in shared memory (a is overwritten): the path for blocks whose
// fast factor met a value that is not finite, where speed does not matter.
template <typename T>
__device__ __noinline__ void chol_exact(T* a, T* l, T* piv, int w) {
  const int lane = threadIdx.x % 32;
  for (int c = 0; c < w; ++c) {
    const T d = sqrt(a[c * NB_LD + c]);
    for (int i = c + lane; i < w; i += 32) l[i * NB_LD + c] = a[i * NB_LD + c] / d;
    if (lane == 0) piv[c] = d;
    __syncwarp();
    for (int i = c + 1 + lane; i < w; i += 32)
      for (int k = c + 1; k <= i; ++k)
        a[i * NB_LD + k] = fma(-l[i * NB_LD + c], l[k * NB_LD + c], a[i * NB_LD + k]);
    __syncwarp();
  }
}

// Factor the w x w (w <= NB) lower triangle of a (row stride NB_LD) into l
// (the same layout), column by column in T: for column c, d = sqrt(v_c) and
// L[i][c] = v_i / d for i >= c (the reference's v / d, diagonal included),
// and every later column k loses L[i][c] L[k][c] for i >= k. piv[c] = d of
// each column. A pivot that is not positive gives NaN in its column and in
// every later one (through sqrt and the updates). Only lower entries below w
// are read into a stored entry.
//
// The block splits in halves of HB = 32: one warp factors the leading half in
// registers (chol_half), every warp solves the rows below it against that
// factor (solve_row_block, one row a warp), all threads update the trailing
// half, and one warp factors it. The column chain thus runs in registers and
// shuffles, with a block barrier only between the four steps, and the code
// of one half stays small. If any stored entry is not finite (a pivot that
// is not positive, or a non-finite input), the block is factored again with
// sqrt and the division themselves (chol_exact, a is then overwritten), so
// special values come out as the reference's v / sqrt(v_j) gives them.
// Every thread of the block calls it; it begins and ends with a barrier.
template <typename T>
__device__ void chol_block(T* a, T* l, T* piv, int w) {
  __shared__ T rp[HB];                  // 1 / piv of the leading half
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  bool bad = false;
  __syncthreads();
  if (warp == 0) {
    bad = chol_half(a, l, piv, min(w, HB));
    __syncwarp();
    rp[lane] = T(1) / piv[lane];
  }
  __syncthreads();
  if (w > HB) {
    for (int i = HB + warp; i < NB; i += nwarps) {   // rows below the half
      T v0 = a[i * NB_LD + lane], v1 = T(0);
      solve_row_block(v0, v1, l, piv, rp, HB);
      l[i * NB_LD + lane] = v0;
      bad |= i < w && !isfinite(v0);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < HB * HB; e += blockDim.x) {
      const int i = HB + e / HB, k = HB + e % HB;      // the trailing half
      if (k <= i) {
        T v = a[i * NB_LD + k];
#pragma unroll 8
        for (int c = 0; c < HB; ++c) v = fma(-l[i * NB_LD + c], l[k * NB_LD + c], v);
        l[i * NB_LD + k] = v;
      }
    }
    __syncthreads();
    if (warp == 0)
      bad |= chol_half(l + HB * NB_LD + HB, l + HB * NB_LD + HB, piv + HB, w - HB);
  }
  if (__syncthreads_or(bad)) {
    if (warp == 0) chol_exact(a, l, piv, w);
    __syncthreads();
  }
}
