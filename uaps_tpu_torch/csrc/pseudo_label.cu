// Fused Dirichlet-mixed pseudo-label for Hopper (sm_90a).
//
// Replaces uaps_tpu/pallas/pseudo_label.py::fused_pseudo_label (body
// _kernel): pseudo = argmax_c sum_d w_d softmax_c(x_d) over the D decoders'
// logits, f32 or bf16 [B, H, W, C] views read as decoder_logits.cuh describes
// (one thread a pixel). In f32 after the load, as the TPU kernel computes it:
// per decoder the max-subtracted softmax exp(x - m) * (1 / sum), the mix in
// decoder order, then a running argmax from -1 with a strict `>`, so a tie
// goes to the lowest class. w [D] f32 is read from the device. The result is
// int32 [B, H, W], contiguous. No gradient: the label is a constant.
//
// What bounds it: ~4 flops and one exp per logit against D C (4 or 2) bytes
// read and 4 bytes written per pixel, so device-memory bandwidth. The TPU
// kernel's transpose to [B, D, C, H, W] existed for Mosaic's (sublane, lane)
// tiling; here the strided NHWC views of NCHW storage already put
// consecutive pixels at consecutive addresses for each (decoder, class), so
// every warp load is coalesced and nothing is stacked or transposed.

#include "decoder_logits.cuh"

namespace {

using uaps::logits::kMaxDec;
using uaps::logits::kThreads;

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
    pseudo_label_kernel(uaps::logits::Decoders<T> dec, int n_dec,
                        const float* __restrict__ w, int* __restrict__ pseudo,
                        long long n, int h, int wd) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const uaps::logits::Pixel px = uaps::logits::pixel_of(i, h, wd);
  float mix[C];
#pragma unroll
  for (int c = 0; c < C; ++c) mix[c] = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxDec; ++d) {
    if (d < n_dec) {
      float ls[C], s[C];   // the log-softmax is dead code here
      uaps::logits::softmax_pixel<C>(dec, d, dec.offset(d, px.b, px.y, px.x),
                                     ls, s);
      const float wdec = w[d];
#pragma unroll
      for (int c = 0; c < C; ++c) mix[c] += wdec * s[c];
    }
  }
  float best = -1.f;
  int arg = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (mix[c] > best) {
      best = mix[c];
      arg = c;
    }
  }
  pseudo[i] = arg;
}

template <typename T>
cudaError_t launch(const void* const* logits, const long long* strides,
                   int n_dec, const float* w, int* pseudo, int batch, int h,
                   int wd, int c, cudaStream_t s) {
  const uaps::logits::Decoders<T> dec =
      uaps::logits::decoders<T>(logits, strides, n_dec);
  const long long n = static_cast<long long>(batch) * h * wd;
  return uaps::logits::with_classes(c, [&](auto k) {
    pseudo_label_kernel<decltype(k)::value, T>
        <<<uaps::logits::blocks_for(n), kThreads, 0, s>>>(dec, n_dec, w,
                                                          pseudo, n, h, wd);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" int uaps_pseudo_label_max_decoders() { return kMaxDec; }

// logits: n_dec pointers to [B, H, W, C] tensors of one dtype (dtype: a
// uaps::DType code) with element strides strides[4 d .. 4 d + 3] = (sb, sh,
// sw, sc); w: f32 [n_dec] on the device; pseudo: int32 [B, H, W],
// contiguous.
extern "C" int uaps_pseudo_label(const void* const* logits,
                                 const long long* strides, int n_dec,
                                 const void* w, void* pseudo, int batch,
                                 int h, int wd, int c, int dtype,
                                 void* stream) {
  if (uaps::logits::bad_shape(n_dec, batch, h, wd, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ww = static_cast<const float*>(w);
  int* ps = static_cast<int*>(pseudo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case uaps::kF32:
      err = launch<float>(logits, strides, n_dec, ww, ps, batch, h, wd, c, s);
      break;
    case uaps::kBF16:
      err = launch<__nv_bfloat16>(logits, strides, n_dec, ww, ps, batch, h,
                                  wd, c, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
