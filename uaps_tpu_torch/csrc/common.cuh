// Shared helpers of the port's CUDA kernels: dtype codes and conversions.
//
// Every C entry point of a kernel library returns cudaGetLastError() (0 on
// success) so that the Python wrapper can raise on a refused launch, which
// torch.cuda.synchronize() would not report.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uaps {

// dtype codes shared with the Python wrappers (kernels/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace uaps

// Human-readable text for an error code returned by an entry point. Each
// kernel library is one translation unit, so each defines this once.
extern "C" const char* uaps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
