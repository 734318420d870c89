// Perturbation kernels of the UAPS auxiliary decoders (and the encoder's
// dropout), for Hopper (sm_90a), with a counter-based generator.
//
// Replaces uaps_tpu/pallas/perturb.py: fused_dropout (_dropout_kernel and
// _dropout_kernel_lanes through _elemwise_call / _batched_call),
// fused_feature_noise (_noise_kernel, _noise_kernel_lanes) and
// fused_feature_dropout (_fdrop_kernel, and its backward _fdrop_bwd). The TPU
// seeds its in-core generator per grid step; here the random value at an
// element is a pure function of (seed, index), so a backward regenerates its
// forward's draw from the same seed and nothing is stored:
//
//   bits(seed, i) = mix32(mix32(i ^ key) + seed), key = mix32(seed ^ salt),
//   mix32 = the "lowbias32" integer hash; uniform24 = (bits >> 8) * 2^-24.
//
//   dropout          i = flat index (masks differ per example); keep when
//                    bits < threshold; kept values x * scale in f32.
//   feature noise    i = index within one example (noise shared across the
//                    batch); out = x * (1 + (u * span - r)) in f32.
//   feature dropout  one draw at i = 0: scale = u * 0.2 + 0.7; attention =
//                    channel mean in f32 (channels summed in order); keep a
//                    pixel where attention < (its example's max) * scale.
//                    Two passes: feature_dropout_max_kernel takes each
//                    example's max attention with atomicMax on an
//                    order-preserving integer key (max is order-independent,
//                    so the result is deterministic);
//                    feature_dropout_apply_kernel recomputes each pixel's
//                    attention and writes src * mask. The backward is the
//                    apply kernel with src = g: the mask comes again from x,
//                    the forward's maxima and the seed.
//
// The seed is read through a device pointer, so the host never waits for it.
// Every float operation that decides or forms a value is an explicit
// round-to-nearest intrinsic (no fused multiply-add), so the plain PyTorch
// versions in kernels/perturb.py give the same bits.
//
// What bounds them: a few integer and float operations per element against
// 2 (bf16) or 4 (f32) bytes read and written, so device-memory bandwidth.
// Consecutive threads take consecutive elements (dropout, noise) or pixels
// (feature dropout, whose threads walk the channels with stride H*W), so
// every load and store is coalesced. The feature-dropout forward reads x
// twice (once per pass; the second pass mostly from the 50 MB L2).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kKeySalt = 0x9e3779b9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

struct Stream {
  uint32_t seed, key;
  __device__ __forceinline__ explicit Stream(const long long* seed_ptr)
      : seed(static_cast<uint32_t>(*seed_ptr)), key(mix32(seed ^ kKeySalt)) {}
  __device__ __forceinline__ uint32_t bits(uint32_t i) const {
    return mix32(mix32(i ^ key) + seed);
  }
  __device__ __forceinline__ float uniform(uint32_t i) const {
    return __fmul_rn(__uint2float_rn(bits(i) >> 8), 5.9604644775390625e-08f);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const long long* __restrict__ seed, long long n,
                   unsigned long long threshold, float scale) {
  const Stream rng(seed);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const bool keep = rng.bits(static_cast<uint32_t>(i)) < threshold;
    out[i] = uaps::from_f32<T>(keep ? __fmul_rn(uaps::to_f32(x[i]), scale)
                                    : 0.f);
  }
}

// grid (blocks over one example, batch)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    noise_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const long long* __restrict__ seed, long long inner,
                 float span, float r) {
  const Stream rng(seed);
  const long long base = static_cast<long long>(blockIdx.y) * inner;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       j < inner; j += static_cast<long long>(gridDim.x) * kThreads) {
    const float u = __fsub_rn(__fmul_rn(rng.uniform(static_cast<uint32_t>(j)),
                                        span), r);
    out[base + j] = uaps::from_f32<T>(
        __fmul_rn(uaps::to_f32(x[base + j]), __fadd_rn(1.f, u)));
  }
}

// float -> unsigned key with the same order (NaN-free input)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <typename T>
__device__ __forceinline__ float channel_mean(const T* __restrict__ xb, int c,
                                              long long hw, long long p,
                                              float inv_c) {
  float s = 0.f;
  // unrolled so that several loads are in flight; the adds stay in order
#pragma unroll 8
  for (int k = 0; k < c; ++k) s = __fadd_rn(s, uaps::to_f32(xb[k * hw + p]));
  return __fmul_rn(s, inv_c);
}

// grid (pixel blocks, batch); mx[b] starts at 0 (below every key)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    feature_dropout_max_kernel(const T* __restrict__ x,
                               unsigned* __restrict__ mx, int c, long long hw,
                               float inv_c) {
  __shared__ unsigned sm[kThreads / 32];
  const long long p = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  const T* xb = x + static_cast<long long>(blockIdx.y) * c * hw;
  unsigned k = p < hw ? order_key(channel_mean(xb, c, hw, p, inv_c)) : 0u;
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    k = max(k, __shfl_down_sync(0xffffffffu, k, off));
  if (threadIdx.x % 32 == 0) sm[threadIdx.x / 32] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned m = sm[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, sm[w]);
    atomicMax(mx + blockIdx.y, m);
  }
}

// out = src * mask(x); grid (pixel blocks, batch)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    feature_dropout_apply_kernel(const T* __restrict__ src,
                                 const T* __restrict__ x, T* __restrict__ out,
                                 const unsigned* __restrict__ mx,
                                 const long long* __restrict__ seed, int c,
                                 long long hw, float inv_c) {
  const long long p = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (p >= hw) return;
  const Stream rng(seed);
  const float scale = __fadd_rn(__fmul_rn(rng.uniform(0u), 0.2f), 0.7f);
  const float thr = __fmul_rn(from_order_key(mx[blockIdx.y]), scale);
  const long long off = static_cast<long long>(blockIdx.y) * c * hw;
  const float keep = channel_mean(x + off, c, hw, p, inv_c) < thr ? 1.f : 0.f;
  for (int k = 0; k < c; ++k) {
    const long long i = off + k * hw + p;
    out[i] = uaps::from_f32<T>(__fmul_rn(uaps::to_f32(src[i]), keep));
  }
}

unsigned blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < (1 << 30) ? want : (1 << 30));
}

template <typename T>
cudaError_t dropout(const void* x, void* out, const long long* seed,
                    long long n, unsigned long long threshold, float scale,
                    cudaStream_t s) {
  dropout_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), seed, n, threshold,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t noise(const void* x, void* out, const long long* seed, int batch,
                  long long inner, float span, float r, cudaStream_t s) {
  const dim3 grid(blocks_for(inner), batch);
  noise_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                           static_cast<T*>(out), seed, inner,
                                           span, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fdrop_max(const void* x, unsigned* mx, int batch, int c,
                      long long hw, float inv_c, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(mx, 0, sizeof(unsigned) * batch, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks_for(hw), batch);
  feature_dropout_max_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), mx, c, hw, inv_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fdrop_apply(const void* src, const void* x, void* out,
                        const unsigned* mx, const long long* seed, int batch,
                        int c, long long hw, float inv_c, cudaStream_t s) {
  const dim3 grid(blocks_for(hw), batch);
  feature_dropout_apply_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(src), static_cast<const T*>(x),
      static_cast<T*>(out), mx, seed, c, hw, inv_c);
  return cudaGetLastError();
}

bool bad_dtype(int dtype) { return dtype != uaps::kF32 && dtype != uaps::kBF16; }

}  // namespace

// x, out: n contiguous elements of `dtype`; seed: one int64 on the device.
// An element is kept when bits(seed, i) < threshold (threshold <= 2^32).
extern "C" int uaps_dropout(const void* x, void* out, const void* seed,
                            long long n, unsigned long long threshold,
                            float scale, int dtype, void* stream) {
  if (n < 1 || n > 0xffffffffLL || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == uaps::kF32
          ? dropout<float>(x, out, sd, n, threshold, scale, s)
          : dropout<__nv_bfloat16>(x, out, sd, n, threshold, scale, s));
}

// x, out: [batch, inner] contiguous; the noise depends on the inner index.
extern "C" int uaps_feature_noise(const void* x, void* out, const void* seed,
                                  int batch, long long inner, float span,
                                  float r, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || inner < 1 || inner > 0xffffffffLL ||
      bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == uaps::kF32
          ? noise<float>(x, out, sd, batch, inner, span, r, s)
          : noise<__nv_bfloat16>(x, out, sd, batch, inner, span, r, s));
}

// x: [batch, c, hw] contiguous; mx: [batch] keys of the max attention.
extern "C" int uaps_feature_dropout_max(const void* x, void* mx, int batch,
                                        int c, long long hw, float inv_c,
                                        int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || c < 1 || hw < 1 || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned* m = static_cast<unsigned*>(mx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == uaps::kF32
          ? fdrop_max<float>(x, m, batch, c, hw, inv_c, s)
          : fdrop_max<__nv_bfloat16>(x, m, batch, c, hw, inv_c, s));
}

// out = src * mask(x); src, x, out: [batch, c, hw] contiguous, one dtype.
extern "C" int uaps_feature_dropout_apply(const void* src, const void* x,
                                          void* out, const void* mx,
                                          const void* seed, int batch, int c,
                                          long long hw, float inv_c,
                                          int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || c < 1 || hw < 1 || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned* m = static_cast<const unsigned*>(mx);
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == uaps::kF32
          ? fdrop_apply<float>(src, x, out, m, sd, batch, c, hw, inv_c, s)
          : fdrop_apply<__nv_bfloat16>(src, x, out, m, sd, batch, c, hw,
                                       inv_c, s));
}
