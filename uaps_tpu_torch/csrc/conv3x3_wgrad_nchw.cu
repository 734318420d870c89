// Weight gradient of the 3x3 SAME stride-1 convolution over NCHW
// activations, for Hopper (sm_90a):
//
//   dW[kh, kw, ci, co] = sum_{b, y, x} x[b, ci, y + kh - 1, x + kw - 1]
//                                      * g[b, co, y, x]        (zero halo)
//
// Replaces uaps_tpu/pallas/conv3x3_nchw.py::conv3x3_nchw_wgrad (the body
// _wgrad_kernel_dwnp1f that the JAX VJPs of conv3x3_fast_flat and
// conv3x3_fast_nchw use). Same contract: x [B, Cin, H, W] and the
// cotangent g [B, Cout, H, W] in the same dtype (f32 or bf16, contiguous,
// unpadded), dW [3, 3, Cin, Cout] in f32; the caller casts it to the
// weight's dtype.
//
// The TPU kernel accumulates dW in one VMEM block across its sequential
// grid. Blocks on Hopper run in no order, so the reduction over the ~1 M
// pixels of a neu batch takes two passes, both in a fixed order so that the
// result is deterministic, as the TPU's is:
//   1. wgrad_partial_kernel: block (strip, ci chunk, co chunk) sums the
//      pixels of kStripRows rows of one image for kCK input channels and up
//      to 32 output channels, and writes its 9 x kCK x CC sums to its own
//      slot of a scratch buffer [strips, 3, 3, Cin, Cout] that the wrapper
//      allocates with torch.empty;
//   2. reduce_kernel: dW[i] = the sum over strips of scratch[., i], each
//      thread a fixed stride of strips, then a fixed-order sum of the 8
//      thread rows.
// Both live in conv3x3_tile.cuh, which block_conv.cu shares: there pass 1
// reads its input through the BN prologue and its cotangent through the
// moment fold.
//
// Routing: the entry point takes the bf16 pass to the tensor cores
// (conv3x3_mma.cuh wgrad_mma_kernel, with its note on what bounds it and
// how) and the f32 pass to the CUDA-core kernel described below; the strip
// height comes from the caller (the Python wrappers' wgrad_strips), which
// sizes the scratch buffer with it.
//
// The f32 pass, and what bounds it: 2 * B*H*W * Cin*Cout*9 flops against
// reading x and g once: ~72 flop per byte at Cin = Cout = 16, so like the
// forward it is bound by CUDA-core FMA throughput (f32 accumulation; tensor
// cores would give TF32 only). In pass 1 a thread owns one input channel
// and COG (8, or 4 for the Cout = 4 head) output channels for all 9 taps:
// 72 f32 accumulators that take 9 x-values and COG g-values from shared
// memory per pixel, 72 FMAs for 17 loads. The block stages a zero-padded
// kCK x (kTH+2) x (kTW+3) input tile (the odd channel stride of 210 floats
// keeps the 8-16 channels a warp reads in different banks) and the kTH x
// kTW x CC cotangent tile, and walks its strip tile by tile; the S = 256 /
// (kCK * CC / COG) threads that share an (input, output-channel) pair take
// every S-th pixel of a tile and are summed in shared memory, in order, at
// the end. The scratch traffic is 9 * Cin * Cout f32 per strip: 4.7 MB for
// up3.0 (64 -> 32 at 128 px, 128 strips), small beside the pass-1 work.

#include <stdint.h>

#include "conv3x3_mma.cuh"
#include "conv3x3_tile.cuh"

namespace {

template <typename T>
cudaError_t launch(const void* x, const void* g, float* part, float* dw,
                   int batch, int cin, int cout, int h, int wd,
                   int strip_rows, cudaStream_t stream) {
  const uaps::conv::PlainLoad<T> in{static_cast<const T*>(x), cin, h, wd};
  const uaps::conv::PlainLoad<T> gl{static_cast<const T*>(g), cout, h, wd};
  return uaps::conv::launch_wgrad_dtype<T>(in, gl, part, dw, batch, cin,
                                           cout, h, wd, strip_rows, stream);
}

}  // namespace

// x [B, Cin, H, W], g [B, Cout, H, W] (dtype, contiguous); part: f32
// scratch of B * ceil(H / strip_rows) * 9 * Cin * Cout elements; dw [3, 3,
// Cin, Cout] f32. strip_rows: 16 for f32 (wgrad::kStripRows), a multiple of
// tc::wg::kTH for bf16. Returns a cudaError_t code.
extern "C" int uaps_conv3x3_wgrad_nchw(const void* x, const void* g,
                                       void* part, void* dw, int batch,
                                       int cin, int cout, int h, int wd,
                                       int strip_rows, int dtype,
                                       void* stream) {
  if (!uaps::conv::wgrad_shape_ok(batch, cin, cout, h, wd, strip_rows, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* d = static_cast<float*>(dw);
  if (dtype == uaps::kF32)
    return static_cast<int>(
        launch<float>(x, g, p, d, batch, cin, cout, h, wd, strip_rows, s));
  if (dtype == uaps::kBF16)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, g, p, d, batch, cin, cout, h, wd,
                              strip_rows, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
