// Fused multi-decoder uncertainty + pseudo-label, and its analytic gradient,
// for Hopper (sm_90a).
//
// Replaces uaps_tpu/pallas/uncertainty.py: the forward _pallas_fwd
// (_fwd_kernel) and the backward _fused_bwd (_bwd_kernel). The D decoders'
// logits are f32 [B, H, W, C] views, read as decoder_logits.cuh describes
// (every decoder's logits of a thread's pixels in registers, nothing
// stacked or copied). In f32:
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
// What bounds it: ~10 flops and one exp per logit (and a log per decoder
// and class of the mean) against 4 D C bytes read and 4 D + 4 bytes written
// per pixel (forward: 88.1 MB at 4 x [16, 256, 256, 4], 0.0263 ms at 3.35
// TB/s), or 4 D (2 C + 1) bytes moved (backward), so device-memory
// bandwidth. The forward's design: D and C are template parameters, so a
// thread issues every decoder's loads for its pixels together before the
// first softmax (decoder_logits.cuh `Views`: the batch strided over
// blockIdx.y, a 32-bit index inside the example, a planar view read with
// no division); on a planar view with 16-byte aligned planes a thread
// takes kFwdVec<D, C> consecutive pixels, one vector load a (decoder,
// class) plane and one vector store of var a decoder and of pseudo; each
// exp is computed once, and the log-softmax is formed from the logits, the
// max and log(sum) where var needs it. Any other view takes one pixel a
// thread in the same kernel (a 32-bit divmod by W where not planar). The
// backward reads one pixel a thread over the flat index
// (decoder_logits.cuh `Decoders`), the forward's former design.
// Consecutive threads take consecutive pixels (or vectors), so each
// (decoder, class) load and store is coalesced in the NCHW storage the
// strides describe.

#include "decoder_logits.cuh"

namespace {

using uaps::logits::kMaxDec;
using uaps::logits::kThreads;
using Decoders = uaps::logits::Decoders<float>;
using uaps::logits::Views;

// the backward's outputs, one per decoder, with its logits' strides
struct Grads {
  float* dx[kMaxDec];
};

// pixels a thread takes on the forward's vector path: at most 64 logits in
// registers
template <int D, int C>
constexpr int kFwdVec = D * C <= 16 ? 4 : D * C <= 32 ? 2 : 1;

// var [D] and the pseudo-label of one pixel from its D x C logits x, in
// the order of operations of the plain version
template <int D, int C>
__device__ __forceinline__ void uncertainty_pixel(const float (&x)[D][C],
                                                  const float (&wd)[D],
                                                  float (&var)[D], int& arg) {
  float m[D], lsum[D], p[C], mix[C];
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = mix[c] = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    m[d] = x[d][0];
#pragma unroll
    for (int c = 1; c < C; ++c) m[d] = fmaxf(m[d], x[d][c]);
    float e[C], sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      e[c] = expf(x[d][c] - m[d]);
      sum += e[c];
    }
    const float inv = 1.f / sum;
    lsum[d] = logf(sum);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float s = e[c] * inv;
      p[c] += s;
      mix[c] += wd[d] * s;
    }
  }
  const float inv_d = 1.f / D;
  float lp[C];
  float best = mix[0];
  arg = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p[c] *= inv_d;
    lp[c] = logf(fmaxf(p[c], 1e-30f));
    if (c > 0 && mix[c] > best) {
      best = mix[c];
      arg = c;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float ls = x[d][c] - m[d] - lsum[d];
      v += p[c] * (lp[c] - ls);
    }
    var[d] = v;
  }
}

// Grid (blocks over an example's units, blocks over the batch): a unit is
// V pixels on the vector path, else one pixel. The bound asks for one block
// an SM only, so that ptxas gives a thread the registers its logits need
// (at the default, <4, 3> spilled).
template <int D, int C>
__global__ void __launch_bounds__(kThreads, 1)
    uncertainty_fwd_kernel(Views dec, const float* __restrict__ w,
                           float* __restrict__ var, int* __restrict__ pseudo) {
  constexpr int V = kFwdVec<D, C>;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= (dec.vec ? dec.hw / V : dec.hw)) return;
  float wd[D];
#pragma unroll
  for (int d = 0; d < D; ++d) wd[d] = w[d];
  for (int b = blockIdx.y; b < dec.batch; b += gridDim.y) {
    const long long row = static_cast<long long>(b) * dec.hw;
    if (dec.vec) {
      float v[D][C][V];
#pragma unroll
      for (int d = 0; d < D; ++d)
#pragma unroll
        for (int c = 0; c < C; ++c)
          uaps::logits::load_vec<V>(
              dec.x[d] + b * dec.sb[d] + c * dec.sc[d] + i * V, v[d][c]);
      float vr[D][V];
      int pr[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float x[D][C], vk[D];
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
          for (int c = 0; c < C; ++c) x[d][c] = v[d][c][k];
        uncertainty_pixel<D, C>(x, wd, vk, pr[k]);
#pragma unroll
        for (int d = 0; d < D; ++d) vr[d][k] = vk[d];
      }
#pragma unroll
      for (int d = 0; d < D; ++d)
        uaps::logits::store_vec<V>(
            var + (static_cast<long long>(d) * dec.batch * dec.hw + row +
                   i * V),
            vr[d]);
      uaps::logits::store_vec<V>(pseudo + row + i * V, pr);
    } else {
      int r = 0, col = i;
      if (!dec.planar) {
        r = i / dec.w;
        col = i - r * dec.w;
      }
      float x[D][C], vk[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float* px = dec.x[d] + b * dec.sb[d] +
                          (dec.planar ? i : r * dec.sh[d] + col * dec.sw[d]);
#pragma unroll
        for (int c = 0; c < C; ++c) x[d][c] = px[c * dec.sc[d]];
      }
      int arg;
      uncertainty_pixel<D, C>(x, wd, vk, arg);
#pragma unroll
      for (int d = 0; d < D; ++d)
        var[static_cast<long long>(d) * dec.batch * dec.hw + row + i] = vk[d];
      pseudo[row + i] = arg;
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
// strides[4 d .. 4 d + 3] = (sb, sh, sw, sc), every offset inside an
// example below 2^31; w: f32 [n_dec] on the device; var: f32 [n_dec, B, H,
// W] and pseudo: int32 [B, H, W], both contiguous and 16-byte aligned.
extern "C" int uaps_uncertainty_fwd(const void* const* logits,
                                    const long long* strides, int n_dec,
                                    const void* w, void* var, void* pseudo,
                                    int batch, int h, int wd, int c,
                                    void* stream) {
  Views dec;
  if (uaps::logits::bad_shape(n_dec, batch, h, wd, c) ||
      !uaps::logits::view_of(logits, strides, n_dec, batch, h, wd, c, &dec) ||
      reinterpret_cast<uintptr_t>(var) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pseudo) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ww = static_cast<const float*>(w);
  float* v = static_cast<float*>(var);
  int* ps = static_cast<int*>(pseudo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = uaps::logits::with_decoders(n_dec, [&](auto dk) {
    return uaps::logits::with_classes(c, [&](auto ck) {
      constexpr int D = decltype(dk)::value;
      constexpr int C = decltype(ck)::value;
      constexpr int V = kFwdVec<D, C>;
      uncertainty_fwd_kernel<D, C>
          <<<uaps::logits::grid_for(dec.vec ? dec.hw / V : dec.hw, batch),
             kThreads, 0, s>>>(dec, ww, v, ps);
      return cudaGetLastError();
    });
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
