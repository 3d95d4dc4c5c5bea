// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel here reads and writes NHWC activations in one element type T
// (float for the fp32 parity path, __nv_bfloat16 for the throughput path),
// accumulates in fp32 and rounds to T exactly once per stage output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace esr {

// dtype codes shared with the Python wrappers (kernels/build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float lrelu(float v, float slope) { return v >= 0.f ? v : v * slope; }

// Round-trip through T: the value a T-typed intermediate would hold.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

}  // namespace esr
