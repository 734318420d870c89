// Fused multi-decoder uncertainty + pseudo-label, and its analytic gradient,
// for Hopper (sm_90a).
//
// Replaces uaps_tpu/pallas/uncertainty.py: the forward _pallas_fwd
// (_fwd_kernel) and the backward _fused_bwd (_bwd_kernel). The D decoders'
// logits are f32 in JAX's public layout [B, H, W, C], each read through its
// own element strides (the port's heads write NCHW and the model hands over
// permuted views, so nothing is stacked, transposed or copied). One thread
// takes one pixel and keeps every decoder's logits in registers (C <= 8 is a
// template, D <= 8 a guarded unrolled loop). In f32:
//
//   forward  s_d = softmax(x_d), p = mean_d s_d,
//            var_d = sum_c p_c (log max(p_c, 1e-30) - log s_{d,c})
//            -> var [D, B, H, W];
//            pseudo = argmax_c sum_d w_d s_{d,c}, the first maximum winning
//            -> int32 [B, H, W]. w [D] is read from the device.
//   backward with g_d the cotangent of var_d and G = sum_d g_d,
//            q_c = G (1 + log p_c) - sum_e g_e log s_{e,c},
//            dx_{d,c} = g_d (s_{d,c} - p_c) + (1/D) s_{d,c} (q_c - <s_d, q>),
//            written through the strides of the logits (the wrapper
//            allocates each dx like its logits).
//
// What bounds it: ~10 flops and two transcendentals per logit against 4 D C
// bytes read and 4 D + 4 bytes written per pixel (forward), or 4 D (2 C + 1)
// bytes moved (backward), so device-memory bandwidth. Consecutive threads
// take consecutive pixels, so each (decoder, class) load and store is
// coalesced in the NCHW storage the strides describe.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDec = 8;

struct Decoders {
  const float* x[kMaxDec];
  float* dx[kMaxDec];   // the backward's outputs, with the logits' strides
  long long sb[kMaxDec], sh[kMaxDec], sw[kMaxDec], sc[kMaxDec];
};

__device__ __forceinline__ long long pixel_offset(const Decoders& dec, int d,
                                                  long long b, int y, int x) {
  return b * dec.sb[d] + y * dec.sh[d] + x * dec.sw[d];
}

// log-softmax and softmax of decoder d at one pixel
template <int C>
__device__ __forceinline__ void softmax_pixel(const Decoders& dec, int d,
                                              long long off, float (&ls)[C],
                                              float (&s)[C]) {
  const float* p = dec.x[d] + off;
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = p[c * dec.sc[d]];
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

template <int C>
__global__ void __launch_bounds__(kThreads)
    uncertainty_fwd_kernel(Decoders dec, int n_dec,
                           const float* __restrict__ w,
                           float* __restrict__ var, int* __restrict__ pseudo,
                           long long n, int h, int wd) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const int x = static_cast<int>(i % wd);
  const long long r = i / wd;
  const int y = static_cast<int>(r % h);
  const long long b = r / h;
  float ls[kMaxDec][C], s[kMaxDec][C];
  float p[C], mix[C];
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = mix[c] = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxDec; ++d) {
    if (d < n_dec) {
      softmax_pixel<C>(dec, d, pixel_offset(dec, d, b, y, x), ls[d], s[d]);
      const float wdec = w[d];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[c] += s[d][c];
        mix[c] += wdec * s[d][c];
      }
    }
  }
  const float inv_d = 1.f / n_dec;
  float lp[C];
  float best = mix[0];
  int arg = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p[c] *= inv_d;
    lp[c] = logf(fmaxf(p[c], 1e-30f));
    if (c > 0 && mix[c] > best) {
      best = mix[c];
      arg = c;
    }
  }
  pseudo[i] = arg;
#pragma unroll
  for (int d = 0; d < kMaxDec; ++d) {
    if (d < n_dec) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) v += p[c] * (lp[c] - ls[d][c]);
      var[d * n + i] = v;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    uncertainty_bwd_kernel(Decoders dec, int n_dec,
                           const float* __restrict__ g_var, long long n, int h,
                           int wd) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const int x = static_cast<int>(i % wd);
  const long long r = i / wd;
  const int y = static_cast<int>(r % h);
  const long long b = r / h;
  float ls[kMaxDec][C], s[kMaxDec][C], g[kMaxDec];
  float p[C], lsg[C];   // sum_d s_{d,c}, then p; sum_d g_d log s_{d,c}
  float g_tot = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = lsg[c] = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxDec; ++d) {
    if (d < n_dec) {
      softmax_pixel<C>(dec, d, pixel_offset(dec, d, b, y, x), ls[d], s[d]);
      g[d] = g_var[d * n + i];
      g_tot += g[d];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[c] += s[d][c];
        lsg[c] += g[d] * ls[d][c];
      }
    }
  }
  const float inv_d = 1.f / n_dec;
  float q[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p[c] *= inv_d;
    q[c] = g_tot * (1.f + logf(fmaxf(p[c], 1e-30f))) - lsg[c];
  }
#pragma unroll
  for (int d = 0; d < kMaxDec; ++d) {
    if (d < n_dec) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) t += s[d][c] * q[c];
      float* o = dec.dx[d] + pixel_offset(dec, d, b, y, x);
#pragma unroll
      for (int c = 0; c < C; ++c)
        o[c * dec.sc[d]] =
            g[d] * (s[d][c] - p[c]) + inv_d * s[d][c] * (q[c] - t);
    }
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <int C>
cudaError_t fwd(const Decoders& dec, int n_dec, const float* w, float* var,
                int* pseudo, long long n, int h, int wd, cudaStream_t s) {
  uncertainty_fwd_kernel<C><<<blocks_for(n), kThreads, 0, s>>>(
      dec, n_dec, w, var, pseudo, n, h, wd);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd(const Decoders& dec, int n_dec, const float* g, long long n,
                int h, int wd, cudaStream_t s) {
  uncertainty_bwd_kernel<C><<<blocks_for(n), kThreads, 0, s>>>(dec, n_dec, g,
                                                              n, h, wd);
  return cudaGetLastError();
}

void fill(Decoders& dec, const void* const* logits, void* const* dx,
          const long long* strides, int n_dec) {
  for (int d = 0; d < n_dec; ++d) {
    dec.x[d] = static_cast<const float*>(logits[d]);
    dec.dx[d] = dx ? static_cast<float*>(dx[d]) : nullptr;
    dec.sb[d] = strides[4 * d];
    dec.sh[d] = strides[4 * d + 1];
    dec.sw[d] = strides[4 * d + 2];
    dec.sc[d] = strides[4 * d + 3];
  }
}

bool bad_shape(int n_dec, int batch, int h, int w, int c) {
  const long long n = static_cast<long long>(batch) * h * w;
  return n_dec < 1 || n_dec > kMaxDec || batch < 1 || h < 1 || w < 1 ||
         c < 1 || c > 8 || (n + kThreads - 1) / kThreads > 0x7fffffffLL;
}

}  // namespace

extern "C" int uaps_uncertainty_max_decoders() { return kMaxDec; }

// logits: n_dec pointers to f32 [B, H, W, C] with element strides
// strides[4 d .. 4 d + 3] = (sb, sh, sw, sc); w: f32 [n_dec] on the device;
// var: f32 [n_dec, B, H, W] and pseudo: int32 [B, H, W], both contiguous.
extern "C" int uaps_uncertainty_fwd(const void* const* logits,
                                    const long long* strides, int n_dec,
                                    const void* w, void* var, void* pseudo,
                                    int batch, int h, int wd, int c,
                                    void* stream) {
  if (bad_shape(n_dec, batch, h, wd, c))
    return static_cast<int>(cudaErrorInvalidValue);
  Decoders dec{};
  fill(dec, logits, nullptr, strides, n_dec);
  const float* ww = static_cast<const float*>(w);
  float* v = static_cast<float*>(var);
  int* ps = static_cast<int*>(pseudo);
  const long long n = static_cast<long long>(batch) * h * wd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 1: err = fwd<1>(dec, n_dec, ww, v, ps, n, h, wd, s); break;
    case 2: err = fwd<2>(dec, n_dec, ww, v, ps, n, h, wd, s); break;
    case 3: err = fwd<3>(dec, n_dec, ww, v, ps, n, h, wd, s); break;
    case 4: err = fwd<4>(dec, n_dec, ww, v, ps, n, h, wd, s); break;
    case 5: err = fwd<5>(dec, n_dec, ww, v, ps, n, h, wd, s); break;
    case 6: err = fwd<6>(dec, n_dec, ww, v, ps, n, h, wd, s); break;
    case 7: err = fwd<7>(dec, n_dec, ww, v, ps, n, h, wd, s); break;
    default: err = fwd<8>(dec, n_dec, ww, v, ps, n, h, wd, s); break;
  }
  return static_cast<int>(err);
}

// dx: n_dec pointers to f32 tensors with the logits' strides; g_var: f32
// [n_dec, B, H, W] contiguous.
extern "C" int uaps_uncertainty_bwd(const void* const* logits,
                                    const long long* strides, int n_dec,
                                    const void* g_var, void* const* dx,
                                    int batch, int h, int wd, int c,
                                    void* stream) {
  if (bad_shape(n_dec, batch, h, wd, c))
    return static_cast<int>(cudaErrorInvalidValue);
  Decoders dec{};
  fill(dec, logits, dx, strides, n_dec);
  const float* g = static_cast<const float*>(g_var);
  const long long n = static_cast<long long>(batch) * h * wd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 1: err = bwd<1>(dec, n_dec, g, n, h, wd, s); break;
    case 2: err = bwd<2>(dec, n_dec, g, n, h, wd, s); break;
    case 3: err = bwd<3>(dec, n_dec, g, n, h, wd, s); break;
    case 4: err = bwd<4>(dec, n_dec, g, n, h, wd, s); break;
    case 5: err = bwd<5>(dec, n_dec, g, n, h, wd, s); break;
    case 6: err = bwd<6>(dec, n_dec, g, n, h, wd, s); break;
    case 7: err = bwd<7>(dec, n_dec, g, n, h, wd, s); break;
    default: err = bwd<8>(dec, n_dec, g, n, h, wd, s); break;
  }
  return static_cast<int>(err);
}
