// The D decoders' logits as the per-pixel kernels read them (uncertainty.cu,
// pseudo_label.cu), for Hopper (sm_90a).
//
// Each decoder's logits are [B, H, W, C] in JAX's public layout, read through
// their own element strides: the port's heads write NCHW and the model hands
// over permuted views, so nothing is stacked, transposed or copied. One
// thread takes one pixel; C <= kMaxClasses is a template parameter and
// D <= kMaxDec a guarded unrolled loop, so a pixel's logits stay in
// registers. Consecutive threads take consecutive pixels, so each (decoder,
// class) load is coalesced in the NCHW storage the strides describe.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace uaps {
namespace logits {

constexpr int kThreads = 256;
constexpr int kMaxDec = 8;
constexpr int kMaxClasses = 8;

template <typename T>
struct Decoders {
  const T* x[kMaxDec];
  long long sb[kMaxDec], sh[kMaxDec], sw[kMaxDec], sc[kMaxDec];

  __device__ __forceinline__ long long offset(int d, long long b, int y,
                                              int x) const {
    return b * sb[d] + y * sh[d] + x * sw[d];
  }
};

// logits: n_dec pointers; strides[4 d .. 4 d + 3] = (sb, sh, sw, sc) of
// decoder d, in elements.
template <typename T>
Decoders<T> decoders(const void* const* logits, const long long* strides,
                     int n_dec) {
  Decoders<T> dec{};
  for (int d = 0; d < n_dec; ++d) {
    dec.x[d] = static_cast<const T*>(logits[d]);
    dec.sb[d] = strides[4 * d];
    dec.sh[d] = strides[4 * d + 1];
    dec.sw[d] = strides[4 * d + 2];
    dec.sc[d] = strides[4 * d + 3];
  }
  return dec;
}

// Pixel i of the flattened [B, H, W] grid.
struct Pixel {
  long long b;
  int y, x;
};

__device__ __forceinline__ Pixel pixel_of(long long i, int h, int wd) {
  const long long r = i / wd;
  return Pixel{r / h, static_cast<int>(r % h), static_cast<int>(i % wd)};
}

// softmax s and log-softmax ls of decoder d at the pixel at `off`, in f32
template <int C, typename T>
__device__ __forceinline__ void softmax_pixel(const Decoders<T>& dec, int d,
                                              long long off, float (&ls)[C],
                                              float (&s)[C]) {
  const T* p = dec.x[d] + off;
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = to_f32(p[c * dec.sc[d]]);
  float m = v[0];
#pragma unroll
  for (int c = 1; c < C; ++c) m = fmaxf(m, v[c]);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) sum += expf(v[c] - m);
  const float inv = 1.f / sum;
  const float lsum = logf(sum);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    s[c] = expf(v[c] - m) * inv;
    ls[c] = v[c] - m - lsum;
  }
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// true for a shape the kernels refuse
inline bool bad_shape(int n_dec, int batch, int h, int w, int c) {
  const long long n = static_cast<long long>(batch) * h * w;
  return n_dec < 1 || n_dec > kMaxDec || batch < 1 || h < 1 || w < 1 ||
         c < 1 || c > kMaxClasses ||
         (n + kThreads - 1) / kThreads > 0x7fffffffLL;
}

// f(std::integral_constant<int, c>{}) for c in 1..kMaxClasses
template <typename F>
cudaError_t with_classes(int c, F&& f) {
  switch (c) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

}  // namespace logits
}  // namespace uaps
