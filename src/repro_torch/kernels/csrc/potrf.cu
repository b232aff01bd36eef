// Single-tile Cholesky factorization (POTRF) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/potrf.py, _potrf_kernel. The tile (f32 or
// bf16) is symmetrised, 0.5 * (A + A^T), and factored in f32: for column j,
// v = A[:, j] - L[:, :j] @ L[j, :j]^T and L[i, j] = v_i / sqrt(v_j) for
// i >= j. The strictly upper triangle of the result is zero and the result
// is cast to the input's type. A pivot that is not positive gives NaN from
// that column on, as the reference's sqrt does; nothing is clamped.
//
// What bounds it here: the column chain. The 512 x 512 factor is 45 MFLOP (a
// bound of 0.7 us), but column j needs columns 0..j-1. The first port ran the
// whole tile on one block, on one SM of 132, as n matrix-vector steps between
// block-wide barriers, reading L back from L2 at each step (3.9 ms at
// n = 512).
//
// What the design does about it: a right-looking blocked factor spread over
// the SMs, in one cooperative launch of a persistent grid, with grid.sync()
// between two phases for each diagonal block of NB = 64 columns
// (potrf_blocked.cuh, whose phases the fused column step runs too): the
// diagonal block factored in registers and the panel rows solved against it,
// then the trailing update in register-tiled 32 x 32 tiles over the SMs.
// The grid is as many blocks as the widest phase needs (kernels/potrf.py
// computes it; 105 at n = 512), capped at what the card holds at once. One
// block running the same blocked algorithm would need no grid barrier but
// would be bounded by one SM's FFMA rate (45 MFLOP at about 0.5 TFLOP/s is
// at least 90 us) and would run the panel solves one after another; the grid
// form is chosen for that.
//
// Storage: L is built in a global f32 workspace W (the output itself for f32
// tiles; kernels/potrf.py allocates it for bf16 tiles, which also receive
// each finished value in bf16). The first step reads the symmetrised tile
// from A (both triangles, as the reference does), later steps read W. Only
// lower entries are computed or read; the upper triangle of the output is
// zeroed once at the start. Every product is f32 FFMA (no TF32). The blocked
// order sums each entry's terms in another order than the column loop, and
// divides the panel rows by sqrt(v_j) as the reference does.
#include <stddef.h>

#include "common.cuh"
#include "potrf_blocked.cuh"

static size_t smem_bytes() { return potrf_smem_bytes<float>(); }   // potrf.py

// `work` is an f32 [n, n] buffer; it is `out` itself when T is float. One
// block a SM is what the launch bounds promise: without that promise ptxas
// keeps the blocked factor to 128 registers and spills (0.17 ms at n = 512,
// against 0.13 ms at 255 registers, on an H100 SXM at 700 W).
template <typename T>
__global__ void __launch_bounds__(PF_THREADS, 1)
    potrf_kernel(const T* __restrict__ a, float* work, T* out, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = blockIdx.x; i < n; i += gridDim.x)  // zeros above the diagonal
    for (int k = i + 1 + threadIdx.x; k < n; k += PF_THREADS)
      out[(size_t)i * n + k] = from_f32<T>(0.f);
  potrf_blocked<float>(a, work, out, n, smem);
}

template <typename T>
static int launch(const void* a, float* work, void* out, int n, int blocks,
                  size_t smem, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&potrf_kernel<T>);
  cudaError_t e;
  int dev, sms, coop, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, potrf_kernel<T>,
                                                         PF_THREADS, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // every block must be resident at once for grid.sync(): the grid is the
  // blocks the widest phase needs, at most what the card holds; each phase
  // walks its work grid-stride, so a smaller grid covers the same work
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  const T* pa = static_cast<const T*>(a);
  T* pout = static_cast<T*>(out);
  void* args[] = {&pa, &work, &pout, &n};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(PF_THREADS), args,
                                  smem, stream);
  return static_cast<int>(e);
}

// Lower Cholesky factor of the symmetrised tile. `work` is an f32 [n, n]
// buffer (pass `out` for f32 tiles); `blocks` and `smem` are the geometry
// kernels/potrf.py computed, and any other shared-memory size is refused.
// Returns the launch's cudaError_t.
extern "C" int potrf(const void* a, void* work, void* out, int n, int dtype,
                     int blocks, int smem, void* stream) {
  if (n <= 0 || blocks <= 0 || static_cast<size_t>(smem) != smem_bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case DT_F32:
      err = launch<float>(a, static_cast<float*>(work), out, n, blocks, smem, s);
      break;
    case DT_BF16:
      err = launch<__nv_bfloat16>(a, static_cast<float*>(work), out, n, blocks,
                                  smem, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
