// 2x2 stride-2 max-pool over NCHW activations, forward and backward, for
// Hopper (sm_90a).
//
// Forward: replaces uaps_tpu/pallas/pool_nchw.py::max_pool_2x2_nchw (body
// _fwd_kernel): x [B, C, H, W] -> [B, C, H/2, W/2] in f32 or bf16. The max
// propagates NaN as jnp.maximum and torch's max_pool2d do; fmaxf would drop
// it, so the comparison is written out.
//
// Backward: replaces pool_nchw.py::_pool_bwd (body _bwd_kernel): dx gets
// each window's cotangent at the FIRST position, in row-major order
// (2i,2j), (2i,2j+1), (2i+1,2j), (2i+1,2j+1), whose value equals the
// window's max, and zeros at the other three. A window whose max is NaN
// routes nothing (no value compares equal to NaN), as the JAX kernel's
// `z == pm` does. dx is written in full, zeros included, in x's dtype.
//
// What bounds both: a few compares per input element, so device-memory
// bandwidth (forward: read x, write a quarter of it; backward: read x and
// g, write dx). Each thread reads one 16-byte vector from each of the two
// window rows (4 f32 or 8 bf16 columns) and, in the backward, the matching
// vector of g, and writes whole vectors; neighbouring threads take
// neighbouring vectors, so every warp load and store is fully coalesced.
// The TPU version's row pairing, masked lane rolls and selection matmuls
// existed to work around Mosaic's lane layout and are not carried over.

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
__global__ void __launch_bounds__(kThreads)
    max_pool_2x2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            T* __restrict__ dx, long long n_vec, int ho,
                            int wd) {
  constexpr int kIn = 16 / sizeof(T);
  constexpr int kOut = kIn / 2;
  const int vec_per_row = wd / kIn;
  const int wo = wd / 2;
  const T zero = uaps::from_f32<T>(0.f);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n_vec; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int q = static_cast<int>(i % vec_per_row);
    const long long row = i / vec_per_row;
    const int oy = static_cast<int>(row % ho);
    const long long plane = row / ho;
    const long long off = (plane * 2 * ho + 2 * oy) * wd + q * kIn;
    const Vec<T, kIn> top = *reinterpret_cast<const Vec<T, kIn>*>(x + off);
    const Vec<T, kIn> bot =
        *reinterpret_cast<const Vec<T, kIn>*>(x + off + wd);
    const Vec<T, kOut> gv =
        *reinterpret_cast<const Vec<T, kOut>*>(g + row * wo + q * kOut);
    Vec<T, kIn> dtop, dbot;
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const float a = uaps::to_f32(top.v[2 * k]);
      const float b = uaps::to_f32(top.v[2 * k + 1]);
      const float c = uaps::to_f32(bot.v[2 * k]);
      const float d = uaps::to_f32(bot.v[2 * k + 1]);
      const float m = nan_max(nan_max(a, b), nan_max(c, d));
      const bool sa = a == m;
      const bool sb = !sa && b == m;
      const bool sc = !sa && !sb && c == m;
      const bool sd = !sa && !sb && !sc && d == m;
      dtop.v[2 * k] = sa ? gv.v[k] : zero;
      dtop.v[2 * k + 1] = sb ? gv.v[k] : zero;
      dbot.v[2 * k] = sc ? gv.v[k] : zero;
      dbot.v[2 * k + 1] = sd ? gv.v[k] : zero;
    }
    *reinterpret_cast<Vec<T, kIn>*>(dx + off) = dtop;
    *reinterpret_cast<Vec<T, kIn>*>(dx + off + wd) = dbot;
  }
}

int grid_for(long long n_vec) {
  const long long want = (n_vec + kThreads - 1) / kThreads;
  return static_cast<int>(want < 65535 ? want : 65535);
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, long long planes, int h,
                       int wd, cudaStream_t stream) {
  constexpr int kIn = 16 / sizeof(T);
  const long long n_vec = planes * (h / 2) * (wd / kIn);
  max_pool_2x2_fwd_kernel<T><<<grid_for(n_vec), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n_vec, h / 2, wd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, void* dx,
                       long long planes, int h, int wd, cudaStream_t stream) {
  constexpr int kIn = 16 / sizeof(T);
  const long long n_vec = planes * (h / 2) * (wd / kIn);
  max_pool_2x2_bwd_kernel<T><<<grid_for(n_vec), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      n_vec, h / 2, wd);
  return cudaGetLastError();
}

bool shape_ok(long long planes, int h, int wd, int dtype) {
  if (planes < 1 || h < 2 || h % 2 != 0 || wd < 1) return false;
  if (dtype == uaps::kF32) return wd % 4 == 0;
  if (dtype == uaps::kBF16) return wd % 8 == 0;
  return false;
}

}  // namespace

// x [planes, H, W] contiguous, 16-byte aligned; y [planes, H/2, W/2]. H must
// be even and W a multiple of 4 (f32) or 8 (bf16). Returns a cudaError_t.
extern "C" int uaps_max_pool_2x2_nchw_fwd(const void* x, void* y,
                                          long long planes, int h, int wd,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(planes, h, wd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == uaps::kF32)
    return static_cast<int>(launch_fwd<float>(x, y, planes, h, wd, s));
  return static_cast<int>(launch_fwd<__nv_bfloat16>(x, y, planes, h, wd, s));
}

// x and dx [planes, H, W], g [planes, H/2, W/2], all of one dtype,
// contiguous and 16-byte aligned; the same shape rules as the forward.
extern "C" int uaps_max_pool_2x2_nchw_bwd(const void* x, const void* g,
                                          void* dx, long long planes, int h,
                                          int wd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(planes, h, wd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == uaps::kF32)
    return static_cast<int>(launch_bwd<float>(x, g, dx, planes, h, wd, s));
  return static_cast<int>(
      launch_bwd<__nv_bfloat16>(x, g, dx, planes, h, wd, s));
}
