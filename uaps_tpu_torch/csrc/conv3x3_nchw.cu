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

#include "common.cuh"

namespace {

constexpr int kTH = 8;                      // output rows per block
constexpr int kTW = 64;                     // output columns per block
constexpr int kPX = 4;                      // neighbouring columns per thread
constexpr int kThreads = kTH * kTW / kPX;   // 128
constexpr int kCK = 8;                      // input channels per chunk
constexpr int kSH = kTH + 2;                // tile rows with halo
constexpr int kSW = kTW + 2;                // tile columns with halo

// element strides of the HWIO weight view
struct WStrides {
  int kh, kw, ci, co;
};

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  union {
    __nv_bfloat162 h[2];
    uint2 u;
  } v;
  v.h[0] = __floats2bfloat162_rn(a, b);  // .x lands at the lower address
  v.h[1] = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = v.u;
}

// COP: the block's output channels, Cout rounded up to 4, 8, 16 or 32 (the
// accumulator count per pixel); blockIdx.z = image * groups + group, and
// group g computes channels [g * COP, g * COP + COP). Channels >= cout carry
// zero weights and are not stored.
template <typename Tin, typename Tout, int COP>
__global__ void __launch_bounds__(kThreads)
    conv3x3_fwd_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                       WStrides wst, Tout* __restrict__ y, int cin, int cout,
                       int h, int wd, int groups) {
  __shared__ float xs[kCK][kSH][kSW];
  __shared__ __align__(16) float ws[kCK][9][COP];

  const int b = blockIdx.z / groups;
  const int co0 = (blockIdx.z % groups) * COP;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int ty = tid / (kTW / kPX);          // output row inside the tile
  const int tx = (tid % (kTW / kPX)) * kPX;  // first output column inside

  float acc[kPX][COP];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int co = 0; co < COP; ++co) acc[p][co] = 0.f;

  const size_t plane = static_cast<size_t>(h) * wd;
  const Tin* xb = x + static_cast<size_t>(b) * cin * plane;

  for (int c0 = 0; c0 < cin; c0 += kCK) {
    const int nc = min(kCK, cin - c0);
    __syncthreads();  // the previous chunk is consumed by every thread
    for (int i = tid; i < kCK * kSH * kSW; i += kThreads) {
      const int c = i / (kSH * kSW);
      const int r = (i / kSW) % kSH;
      const int col = i % kSW;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + col;
      float v = 0.f;
      if (c < nc && gy >= 0 && gy < h && gx >= 0 && gx < wd)
        v = uaps::to_f32(xb[(c0 + c) * plane + static_cast<size_t>(gy) * wd +
                            gx]);
      xs[c][r][col] = v;
    }
    for (int i = tid; i < kCK * 9 * COP; i += kThreads) {
      const int c = i / (9 * COP);
      const int t = (i / COP) % 9;
      const int co = i % COP;
      ws[c][t][co] = (c < nc && co0 + co < cout)
                         ? uaps::to_f32(w[(t / 3) * wst.kh + (t % 3) * wst.kw +
                                          (c0 + c) * wst.ci +
                                          (co0 + co) * wst.co])
                         : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        float xv[kPX + 2];
#pragma unroll
        for (int j = 0; j < kPX + 2; ++j) xv[j] = xs[c][ty + dh][tx + j];
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float4* wv =
              reinterpret_cast<const float4*>(&ws[c][dh * 3 + dw][0]);
#pragma unroll
          for (int q = 0; q < COP / 4; ++q) {
            const float4 w4 = wv[q];
#pragma unroll
            for (int p = 0; p < kPX; ++p) {
              const float xp = xv[p + dw];
              acc[p][4 * q + 0] = fmaf(xp, w4.x, acc[p][4 * q + 0]);
              acc[p][4 * q + 1] = fmaf(xp, w4.y, acc[p][4 * q + 1]);
              acc[p][4 * q + 2] = fmaf(xp, w4.z, acc[p][4 * q + 2]);
              acc[p][4 * q + 3] = fmaf(xp, w4.w, acc[p][4 * q + 3]);
            }
          }
        }
      }
    }
  }

  const int oy = y0 + ty;
  const int ox = x0 + tx;
  if (oy >= h || ox >= wd) return;
  Tout* yr = y + (static_cast<size_t>(b) * cout + co0) * plane +
             static_cast<size_t>(oy) * wd + ox;
  // wd % 4 == 0 makes every row start and every ox 4-aligned (the output is
  // a fresh allocation), so the kPX = 4 pixels go out as one vector store.
  const bool vec = (wd % 4) == 0;
#pragma unroll
  for (int co = 0; co < COP; ++co) {
    if (co0 + co >= cout) break;
    Tout* p = yr + co * plane;
    if (vec) {
      store4(p, acc[0][co], acc[1][co], acc[2][co], acc[3][co]);
    } else {
#pragma unroll
      for (int q = 0; q < kPX; ++q)
        if (ox + q < wd) p[q] = uaps::from_f32<Tout>(acc[q][co]);
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const void* w, WStrides wst, void* y,
                   int batch, int cin, int cout, int h, int wd,
                   cudaStream_t stream) {
  const int groups = (cout + 31) / 32;
  const dim3 grid((wd + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch * groups);
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
