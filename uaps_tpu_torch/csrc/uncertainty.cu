// Fused multi-decoder uncertainty + pseudo-label, and its analytic gradient,
// for Hopper (sm_90a).
//
// Replaces uaps_tpu/pallas/uncertainty.py: the forward _pallas_fwd
// (_fwd_kernel) and the backward _fused_bwd (_bwd_kernel). The D decoders'
// logits are f32 [B, H, W, C] views, read as decoder_logits.cuh describes
// (one thread a pixel, every decoder's logits in registers, nothing stacked
// or copied). In f32:
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

#include "decoder_logits.cuh"

namespace {

using uaps::logits::kMaxDec;
using uaps::logits::kThreads;
using Decoders = uaps::logits::Decoders<float>;

// the backward's outputs, one per decoder, with its logits' strides
struct Grads {
  float* dx[kMaxDec];
};

template <int C>
__global__ void __launch_bounds__(kThreads)
    uncertainty_fwd_kernel(Decoders dec, int n_dec,
                           const float* __restrict__ w,
                           float* __restrict__ var, int* __restrict__ pseudo,
                           long long n, int h, int wd) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const uaps::logits::Pixel px = uaps::logits::pixel_of(i, h, wd);
  float ls[kMaxDec][C], s[kMaxDec][C];
  float p[C], mix[C];
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = mix[c] = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxDec; ++d) {
    if (d < n_dec) {
      uaps::logits::softmax_pixel<C>(dec, d, dec.offset(d, px.b, px.y, px.x),
                                     ls[d], s[d]);
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
    uncertainty_bwd_kernel(Decoders dec, Grads out, int n_dec,
                           const float* __restrict__ g_var, long long n, int h,
                           int wd) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const uaps::logits::Pixel px = uaps::logits::pixel_of(i, h, wd);
  float ls[kMaxDec][C], s[kMaxDec][C], g[kMaxDec];
  float p[C], lsg[C];   // sum_d s_{d,c}, then p; sum_d g_d log s_{d,c}
  float g_tot = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = lsg[c] = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxDec; ++d) {
    if (d < n_dec) {
      uaps::logits::softmax_pixel<C>(dec, d, dec.offset(d, px.b, px.y, px.x),
                                     ls[d], s[d]);
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
      float* o = out.dx[d] + dec.offset(d, px.b, px.y, px.x);
#pragma unroll
      for (int c = 0; c < C; ++c)
        o[c * dec.sc[d]] =
            g[d] * (s[d][c] - p[c]) + inv_d * s[d][c] * (q[c] - t);
    }
  }
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
  if (uaps::logits::bad_shape(n_dec, batch, h, wd, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const Decoders dec =
      uaps::logits::decoders<float>(logits, strides, n_dec);
  const float* ww = static_cast<const float*>(w);
  float* v = static_cast<float*>(var);
  int* ps = static_cast<int*>(pseudo);
  const long long n = static_cast<long long>(batch) * h * wd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = uaps::logits::with_classes(c, [&](auto k) {
    uncertainty_fwd_kernel<decltype(k)::value>
        <<<uaps::logits::blocks_for(n), kThreads, 0, s>>>(dec, n_dec, ww, v,
                                                          ps, n, h, wd);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// dx: n_dec pointers to f32 tensors with the logits' strides; g_var: f32
// [n_dec, B, H, W] contiguous.
extern "C" int uaps_uncertainty_bwd(const void* const* logits,
                                    const long long* strides, int n_dec,
                                    const void* g_var, void* const* dx,
                                    int batch, int h, int wd, int c,
                                    void* stream) {
  if (uaps::logits::bad_shape(n_dec, batch, h, wd, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const Decoders dec =
      uaps::logits::decoders<float>(logits, strides, n_dec);
  Grads out{};
  for (int d = 0; d < n_dec; ++d) out.dx[d] = static_cast<float*>(dx[d]);
  const float* g = static_cast<const float*>(g_var);
  const long long n = static_cast<long long>(batch) * h * wd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = uaps::logits::with_classes(c, [&](auto k) {
    uncertainty_bwd_kernel<decltype(k)::value>
        <<<uaps::logits::blocks_for(n), kThreads, 0, s>>>(dec, out, n_dec, g,
                                                          n, h, wd);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}
