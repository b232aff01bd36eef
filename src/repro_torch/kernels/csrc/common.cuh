// Shared helpers of the port's tile kernels: element loads that widen the
// storage types to f32, and the f32 -> storage narrowing.
//
// Every kernel computes in f32 with FFMA only (no tensor cores, so no TF32):
// the precision classifier assumes the f32 class rounds at 2^-24
// (core/precision.py, EPS["f32"]). The blocked POTRF and TRSM
// (tri_block.cuh) take their quotients by Markstein's correction and their
// square roots by a Newton step from rsqrt, within an ulp of IEEE division
// and sqrt, and redo a diagonal block or a row with the IEEE operations
// wherever a value is not finite.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>

// dtype codes, mirrored by repro_torch/kernels/_build.py (DTYPE_CODES)
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_F8E4M3 = 2 };

// cards a process may launch on: the host code keeps per-card state (the
// shared-memory opt-in, a function attribute of one card) in arrays this long
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A stored value in the compute type TW (f32 from f32, bf16 or fp8; f64 from
// f64), and back: the kernels that run in f32 or f64 (the fused column step,
// the blocked factor's phases) take their element type through these.
template <typename TW, typename T>
__device__ __forceinline__ TW widen(T v) { return to_f32(v); }
template <>
__device__ __forceinline__ double widen<double, double>(double v) { return v; }
template <typename T, typename TW>
__device__ __forceinline__ T narrow(TW v) { return from_f32<T>(v); }
template <>
__device__ __forceinline__ double narrow<double, double>(double v) { return v; }
