// 3x3 SAME stride-1 convolution over NCHW activations, for Hopper (sm_90a):
// the forward and, with flipped weights, the input gradient (dgrad).
//
// Replaces uaps_tpu/pallas/conv3x3_nchw.py::conv3x3_nchw with its default
// body _fwd_kernel_dwkf, which the JAX model reaches through
// conv3x3_fast_flat (the ConvBlock flat island at 256 and 128 px) and
// conv3x3_fast_nchw (the logits head), and which the JAX VJPs of both
// entries call again for dgrad (_vjp_bwd_flat / _vjp_bwd_nchw: the same conv
// of the cotangent with w flipped in (kh, kw) and its in/out channels
// swapped). Same contract: x [B, Cin, H, W] in f32 or bf16, zero halo, f32
// accumulation, output f32 or bf16, no bias (the caller adds it). The
// weights are HWIO [3, 3, Cin, Cout] in the input's dtype, read through
// signed element strides from a base pointer, so the model's permuted view
// of its OIHW weight needs no copy, and dgrad passes the address of
// w[2, 2, 0, 0] with negated kh/kw strides and the ci/co strides swapped
// instead of materialising the flipped weight. Any Cin, H, W and Cout.
//
// What bounds it: at Cin = Cout = 16 in bf16 the conv does ~72 flop per byte
// of device memory, above the CUDA-core f32 balance of an H100 (~20
// flop/byte) and below the tensor-core one (~295), so this first version is
// bound by CUDA-core FMA throughput. The design keeps the FMA units fed:
//   * one block computes a kTH x kTW output tile of one image for up to 32
//     output channels; a Cout above 32 (dgrad of up3.0 writes 64) is split
//     into groups of 32 along grid.z, each group re-reading the input tile,
//     because 4 pixels x 64 f32 accumulators would not fit the 255
//     registers a thread may hold;
//   * Cin is walked in chunks of kCK channels: the zero-padded
//     kCK x (kTH+2) x (kTW+2) input tile and the matching weight chunk sit
//     in static shared memory (~30 KB; a whole 64 x 32 x 9 f32 weight block
//     alone would be 73.7 KB and need opt-in dynamic shared memory);
//   * each thread keeps kPX neighbouring output pixels x up to 32 Cout as
//     f32 accumulators in registers, so every input value it reads from
//     shared memory serves 3 horizontal taps and every weight (a broadcast
//     float4 read) serves kPX pixels.
// The TPU's layout tricks (dh-in-K / dw-in-M weight packing, masked lane
// rolls, zero-padding the head's Cout to 8) existed for the MXU's (8, 128)
// tiling and are not carried over. Moving the inner product onto the tensor
// cores (mma / wgmma) is later work.

#include <stdint.h>

#include "conv3x3_tile.cuh"

namespace {

using uaps::conv::kPX;
using uaps::conv::kThreads;

// element strides of the HWIO weight view
struct WStrides {
  int kh, kw, ci, co;
};

// COP: the block's output channels, Cout rounded up to 4, 8, 16 or 32 (the
// accumulator count per pixel); blockIdx.z = image * groups + group, and
// group g computes channels [g * COP, g * COP + COP). Channels >= cout carry
// zero weights and are not stored.
template <typename Tin, typename Tout, int COP>
__global__ void __launch_bounds__(kThreads, uaps::conv::min_blocks(COP))
    conv3x3_fwd_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                       WStrides wst, Tout* __restrict__ y, int cin, int cout,
                       int h, int wd, int groups) {
  __shared__ uaps::conv::TileSmem<COP> sm;
  const uaps::conv::Tile t = uaps::conv::tile_of_block(groups, COP);
  const uaps::conv::PlainLoad<Tin> in{x, cin, h, wd};
  auto wt = [&](int c, int tap, int co) {
    return uaps::to_f32(w[(tap / 3) * wst.kh + (tap % 3) * wst.kw +
                          c * wst.ci + co * wst.co]);
  };
  float acc[kPX][COP];
  uaps::conv::conv_tile(acc, sm, t, in, wt, cin, cout, h, wd);
  uaps::conv::store_tile<Tout, COP>(y, acc, t, cout, h, wd);
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const void* w, WStrides wst, void* y,
                   int batch, int cin, int cout, int h, int wd,
                   cudaStream_t stream) {
  const int groups = uaps::conv::tile_groups(cout);
  const dim3 grid = uaps::conv::tile_grid(batch, cout, h, wd);
  const Tin* xi = static_cast<const Tin*>(x);
  const Tin* wi = static_cast<const Tin*>(w);
  Tout* yo = static_cast<Tout*>(y);
  if (cout <= 4)
    conv3x3_fwd_kernel<Tin, Tout, 4><<<grid, kThreads, 0, stream>>>(
        xi, wi, wst, yo, cin, cout, h, wd, groups);
  else if (cout <= 8)
    conv3x3_fwd_kernel<Tin, Tout, 8><<<grid, kThreads, 0, stream>>>(
        xi, wi, wst, yo, cin, cout, h, wd, groups);
  else if (cout <= 16)
    conv3x3_fwd_kernel<Tin, Tout, 16><<<grid, kThreads, 0, stream>>>(
        xi, wi, wst, yo, cin, cout, h, wd, groups);
  else
    conv3x3_fwd_kernel<Tin, Tout, 32><<<grid, kThreads, 0, stream>>>(
        xi, wi, wst, yo, cin, cout, h, wd, groups);
  return cudaGetLastError();
}

}  // namespace

// x [B, Cin, H, W] (in_dtype, contiguous), w: the address of tap (0, 0),
// channel (0, 0) of an HWIO [3, 3, Cin, Cout] weight in in_dtype with
// signed element strides w_kh, w_kw, w_ci, w_co; y [B, Cout, H, W]
// (out_dtype, contiguous). Supported dtype pairs: f32->f32, bf16->bf16,
// bf16->f32. B * ceil(Cout / 32) <= 65535. Returns a cudaError_t code.
extern "C" int uaps_conv3x3_nchw_fwd(const void* x, const void* w, void* y,
                                     int batch, int cin, int cout, int h,
                                     int wd, int w_kh, int w_kw, int w_ci,
                                     int w_co, int in_dtype, int out_dtype,
                                     void* stream) {
  if (batch < 1 || cin < 1 || cout < 1 || h < 1 || wd < 1 ||
      !uaps::conv::index_fits(batch, cin > cout ? cin : cout, h, wd) ||
      static_cast<long long>(batch) * ((cout + 31) / 32) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const WStrides wst{w_kh, w_kw, w_ci, w_co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using uaps::kBF16;
  using uaps::kF32;
  cudaError_t err;
  if (in_dtype == kF32 && out_dtype == kF32)
    err = launch<float, float>(x, w, wst, y, batch, cin, cout, h, wd, s);
  else if (in_dtype == kBF16 && out_dtype == kBF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, wst, y, batch, cin, cout,
                                               h, wd, s);
  else if (in_dtype == kBF16 && out_dtype == kF32)
    err = launch<__nv_bfloat16, float>(x, w, wst, y, batch, cin, cout, h, wd,
                                       s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
