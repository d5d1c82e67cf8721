// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its tensors in float32 or bfloat16 and does all of
// its arithmetic in float32; these helpers convert at the load and the
// store. The C entry points return cudaGetLastError() right after the
// launch so that the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace acar {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// round to nearest even, as torch's and jax's casts do
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace acar
