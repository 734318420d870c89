// 2x2 stride-2 max-pool over NCHW activations, forward, for Hopper (sm_90a).
//
// Replaces uaps_tpu/pallas/pool_nchw.py::max_pool_2x2_nchw (body
// _fwd_kernel): x [B, C, H, W] -> [B, C, H/2, W/2] in f32 or bf16. The max
// propagates NaN as jnp.maximum and torch's max_pool2d do; fmaxf would drop
// it, so the comparison is written out.
//
// What bounds it: one compare per input element, so device-memory bandwidth
// (every input element is read once, a quarter as many are written). Each
// thread reads one 16-byte
// vector from each of the two window rows (4 f32 or 8 bf16 columns) and
// writes one 8-byte vector of pooled values; neighbouring threads take
// neighbouring vectors, so every warp load is fully coalesced. The TPU
// version's row pairing, masked lane roll and selection matmuls existed to
// work around Mosaic's lane layout and are not carried over. The backward
// (first-max tie routing, _bwd_kernel) comes with the training slice.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// N values moved as one aligned vector load or store
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// max that returns NaN if either input is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    max_pool_2x2_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                            long long n_vec, int ho, int wd) {
  constexpr int kIn = 16 / sizeof(T);  // input columns per 16-byte vector
  constexpr int kOut = kIn / 2;        // pooled columns per thread
  const int vec_per_row = wd / kIn;
  const int wo = wd / 2;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n_vec; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int q = static_cast<int>(i % vec_per_row);
    const long long row = i / vec_per_row;  // pooled row over all planes
    const int oy = static_cast<int>(row % ho);
    const long long plane = row / ho;
    const T* r0 = x + (plane * 2 * ho + 2 * oy) * wd + q * kIn;
    const Vec<T, kIn> top = *reinterpret_cast<const Vec<T, kIn>*>(r0);
    const Vec<T, kIn> bot = *reinterpret_cast<const Vec<T, kIn>*>(r0 + wd);
    Vec<T, kOut> out;
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const float m = nan_max(
          nan_max(uaps::to_f32(top.v[2 * k]), uaps::to_f32(top.v[2 * k + 1])),
          nan_max(uaps::to_f32(bot.v[2 * k]),
                  uaps::to_f32(bot.v[2 * k + 1])));
      out.v[k] = uaps::from_f32<T>(m);
    }
    *reinterpret_cast<Vec<T, kOut>*>(y + row * wo + q * kOut) = out;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long planes, int h, int wd,
                   cudaStream_t stream) {
  constexpr int kIn = 16 / sizeof(T);
  const long long n_vec = planes * (h / 2) * (wd / kIn);
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  max_pool_2x2_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n_vec, h / 2, wd);
  return cudaGetLastError();
}

}  // namespace

// x [planes, H, W] contiguous, 16-byte aligned; y [planes, H/2, W/2]. H must
// be even and W a multiple of 4 (f32) or 8 (bf16). Returns a cudaError_t.
extern "C" int uaps_max_pool_2x2_nchw_fwd(const void* x, void* y,
                                          long long planes, int h, int wd,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes < 1 || h < 2 || h % 2 != 0 || wd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == uaps::kF32 && wd % 4 == 0)
    return static_cast<int>(launch<float>(x, y, planes, h, wd, s));
  if (dtype == uaps::kBF16 && wd % 8 == 0)
    return static_cast<int>(launch<__nv_bfloat16>(x, y, planes, h, wd, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
