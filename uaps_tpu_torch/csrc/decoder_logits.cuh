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
//
// Views, view_of, load_vec, store_vec, grid_for and with_decoders serve the
// kernels that template D and split a pixel into (example, 32-bit index
// inside it): the batch strided over blockIdx.y, a planar view (sw == 1,
// sh == W: pixel i of an example at c sc + i) read with no division,
// anything else with a 32-bit divmod by W, and, where every plane is
// 16-byte aligned, V pixels a thread with one vector load a plane.
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

// The D decoders' f32 logits with the example stride in 64 bits and the
// in-example strides in 32 (view_of checks that every offset inside an
// example fits), and the path the kernels take.
struct Views {
  const float* x[kMaxDec];
  long long sb[kMaxDec];
  int sh[kMaxDec], sw[kMaxDec], sc[kMaxDec];
  int w, hw, batch;
  int planar;   // every decoder's sw == 1 and sh == W
  int vec;      // planar, and every plane 16-byte aligned with H W % 4 == 0
};

// Views of n_dec logits (pointers and strides as `decoders` takes them);
// false where an offset inside an example would not fit in 32 bits.
inline bool view_of(const void* const* logits, const long long* strides,
                    int n_dec, int batch, int h, int w, int c, Views* out) {
  const long long lim = 0x7fffffffLL;
  if (static_cast<long long>(h) * w > lim) return false;
  Views v{};
  v.w = w;
  v.hw = h * w;
  v.batch = batch;
  v.planar = 1;
  v.vec = v.hw % 4 == 0;
  for (int d = 0; d < n_dec; ++d) {
    const long long sb = strides[4 * d], sh = strides[4 * d + 1],
                    sw = strides[4 * d + 2], sc = strides[4 * d + 3];
    if (sb < 0 || sh < 0 || sw < 0 || sc < 0 || sh > lim || sw > lim ||
        sc > lim || (h - 1) * sh + (w - 1) * sw + (c - 1) * sc > lim)
      return false;
    v.x[d] = static_cast<const float*>(logits[d]);
    v.sb[d] = sb;
    v.sh[d] = static_cast<int>(sh);
    v.sw[d] = static_cast<int>(sw);
    v.sc[d] = static_cast<int>(sc);
    v.planar = v.planar && sw == 1 && sh == w;
    v.vec = v.vec && sb % 4 == 0 && sc % 4 == 0 &&
            reinterpret_cast<uintptr_t>(logits[d]) % 16 == 0;
  }
  v.vec = v.vec && v.planar;
  *out = v;
  return true;
}

// V consecutive f32 values from 16-byte (V = 4) or 8-byte (V = 2) aligned p
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  using W4 = std::conditional_t<std::is_same_v<T, int>, int4, float4>;
  using W2 = std::conditional_t<std::is_same_v<T, int>, int2, float2>;
  if constexpr (V == 4) {
    *reinterpret_cast<W4*>(p) = W4{v[0], v[1], v[2], v[3]};
  } else if constexpr (V == 2) {
    *reinterpret_cast<W2*>(p) = W2{v[0], v[1]};
  } else {
    *p = v[0];
  }
}

// (blocks over an example's `units`, blocks over the batch)
inline dim3 grid_for(int units, int batch) {
  return dim3(static_cast<unsigned>((units + kThreads - 1) / kThreads),
              static_cast<unsigned>(batch < 65535 ? batch : 65535));
}

// f(std::integral_constant<int, d>{}) for d in 1..kMaxDec
template <typename F>
cudaError_t with_decoders(int d, F&& f) {
  switch (d) {
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
