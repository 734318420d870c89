// 3x3 SAME stride-1 convolution over NHWC activations, for Hopper (sm_90a):
// the forward, the input gradient (the forward with flipped weights) and the
// weight gradient.
//
// Replaces uaps_tpu/pallas/conv3x3.py::conv3x3_forward (_fwd_kernel: one
// [slab*W, 9*Cin] x [9*Cin, Cout] MXU product of im2col patches built in
// VMEM per row slab) and ::conv3x3_wgrad (_wgrad_kernel: patches^T x g,
// accumulated in one VMEM block over the sequential grid), the two kernels
// behind the custom VJP conv3x3_small. Same contract: x [B, H, W, Cin] in
// f32 or bf16, w [3, 3, Cin, Cout] HWIO in x's dtype, zero halo, f32
// accumulation, y [B, H, W, Cout] in x's dtype; dW [3, 3, Cin, Cout] f32
// from x and the cotangent g [B, H, W, Cout] in x's dtype. The weights are
// read through signed element strides, so the dgrad passes the address of
// w[2, 2, 0, 0] with negated kh/kw strides and the ci/co strides swapped
// (as conv3x3_nchw.cu does) instead of a flipped copy.
//
// Design: the NCHW conv's tiles (conv3x3_tile.cuh: conv_tile, the
// two-pass deterministic launch_wgrad) with an NHWC loader, NhwcLoad, that
// reads x[b, gy, gx, c0 + ch] through the pixel stride, and an NHWC store.
// No transposed copy of x or g is made. The TPU kernel's in-VMEM im2col
// existed to give the MXU a full-depth K = 9 * Cin; the CUDA tile already
// reads every shared-memory value into 3 taps and kPX pixels without it.
// A Cout above 32 runs in groups of 32 along grid.z, as the NCHW forward.
//
// What bounds it: as the NCHW conv, CUDA-core FMA throughput (~72 flop per
// byte at Cin = Cout = 16 in bf16; the forward and dgrad have no tensor
// cores yet). The bf16 weight gradient runs conv3x3_mma.cuh's tensor-core
// pass through NhwcLoad (bound by bytes, as its note says); the f32 one the
// CUDA-core pass. The tiles load in
// pixel-major order, so a warp's load reads one channel of 32 neighbouring
// pixels, Cin elements apart: each 32-byte sector it touches also holds
// the pixel's other channels, which the tile's next channel iterations find
// in L1. The store writes each pixel's channels as 16- or 8-byte vectors
// where Cout % 4 == 0.

#include <stdint.h>

#include "conv3x3_mma.cuh"
#include "conv3x3_tile.cuh"

namespace {

using uaps::from_f32;
using uaps::to_f32;
using uaps::conv::kPX;
using uaps::conv::kThreads;

// element strides of the HWIO weight view
struct WStrides {
  int kh, kw, ci, co;
};

// A contiguous NHWC tensor read as f32: channel c0 + ch of pixel (gy, gx)
// of image b. The per-pixel index is 32-bit (the entry points refuse
// H * W > INT_MAX), the channel stride multiply 64-bit.
template <typename T>
struct NhwcLoad {
  const T* x;
  int c;   // channels of x (the innermost dimension)
  int h, wd;
  struct At {
    const T* p;   // channel c0 of pixel (0, 0) of image b
    int wd, c;
    __device__ __forceinline__ float operator()(int ch, int gy,
                                                int gx) const {
      return to_f32(__ldg(p + static_cast<size_t>(gy * wd + gx) * c + ch));
    }
  };
  __device__ __forceinline__ At at(int b, int c0) const {
    return At{x + static_cast<size_t>(b) * h * wd * c + c0, wd, c};
  }
};

// y[b, oy, ox + p, co0 + co] = acc[p][co] for the thread's in-image pixels
// and the channels below cout (y contiguous [B, H, W, cout]). With cout %
// 4 == 0 every group of 4 channels starts 4-aligned (co0 is a multiple of
// 32 and y a fresh allocation) and goes out as one vector store.
template <typename T, int COP>
__device__ __forceinline__ void store_nhwc(T* __restrict__ y,
                                           const float (&acc)[kPX][COP],
                                           const uaps::conv::Tile& t,
                                           int cout, int h, int wd) {
  const int oy = t.y0 + t.ty;
  if (oy >= h) return;
  const bool vec = (cout % 4) == 0;
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int ox = t.x0 + t.tx + p;
    if (ox < wd) {
      T* yp = y + ((static_cast<size_t>(t.b) * h + oy) * wd + ox) * cout +
              t.co0;
#pragma unroll
      for (int q = 0; q < COP / 4; ++q) {
        const int co = 4 * q;
        if (vec) {
          if (t.co0 + co < cout)
            uaps::conv::store4(yp + co, acc[p][co], acc[p][co + 1],
                               acc[p][co + 2], acc[p][co + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (t.co0 + co + k < cout)
              yp[co + k] = from_f32<T>(acc[p][co + k]);
        }
      }
    }
  }
}

// COP: the block's output channels, Cout rounded up to 4, 8, 16 or 32;
// blockIdx.z = image * groups + group (conv3x3_tile.cuh tile_of_block).
template <typename T, int COP>
__global__ void __launch_bounds__(kThreads, uaps::conv::min_blocks(COP))
    conv3x3_nhwc_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            WStrides wst, T* __restrict__ y, int cin,
                            int cout, int h, int wd, int groups) {
  __shared__ uaps::conv::TileSmem<COP> sm;
  const uaps::conv::Tile t = uaps::conv::tile_of_block(groups, COP);
  const NhwcLoad<T> in{x, cin, h, wd};
  auto wt = [&](int c, int tap, int co) {
    return to_f32(w[(tap / 3) * wst.kh + (tap % 3) * wst.kw + c * wst.ci +
                    co * wst.co]);
  };
  float acc[kPX][COP];
  uaps::conv::conv_tile(acc, sm, t, in, wt, cin, cout, h, wd);
  store_nhwc<T, COP>(y, acc, t, cout, h, wd);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, WStrides wst, void* y,
                       int batch, int cin, int cout, int h, int wd,
                       cudaStream_t stream) {
  const int groups = uaps::conv::tile_groups(cout);
  const dim3 grid = uaps::conv::tile_grid(batch, cout, h, wd);
  const T* xi = static_cast<const T*>(x);
  const T* wi = static_cast<const T*>(w);
  T* yo = static_cast<T*>(y);
  if (cout <= 4)
    conv3x3_nhwc_fwd_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
        xi, wi, wst, yo, cin, cout, h, wd, groups);
  else if (cout <= 8)
    conv3x3_nhwc_fwd_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
        xi, wi, wst, yo, cin, cout, h, wd, groups);
  else if (cout <= 16)
    conv3x3_nhwc_fwd_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
        xi, wi, wst, yo, cin, cout, h, wd, groups);
  else
    conv3x3_nhwc_fwd_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
        xi, wi, wst, yo, cin, cout, h, wd, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* g, float* part,
                         float* dw, int batch, int cin, int cout, int h,
                         int wd, int strip_rows, cudaStream_t stream) {
  const NhwcLoad<T> in{static_cast<const T*>(x), cin, h, wd};
  const NhwcLoad<T> gl{static_cast<const T*>(g), cout, h, wd};
  return uaps::conv::launch_wgrad_dtype<T>(in, gl, part, dw, batch, cin,
                                           cout, h, wd, strip_rows, stream);
}

bool bad_shape(int batch, int cin, int cout, int h, int wd) {
  return batch < 1 || cin < 1 || cout < 1 || h < 1 || wd < 1 ||
         !uaps::conv::index_fits(batch, cin > cout ? cin : cout, h, wd);
}

}  // namespace

// x [B, H, W, Cin] (dtype, contiguous), w: the address of tap (0, 0),
// channel (0, 0) of an HWIO [3, 3, Cin, Cout] weight in dtype with signed
// element strides w_kh, w_kw, w_ci, w_co; y [B, H, W, Cout] (dtype,
// contiguous). B * ceil(Cout / 32) <= 65535. Returns a cudaError_t code.
extern "C" int uaps_conv3x3_nhwc_fwd(const void* x, const void* w, void* y,
                                     int batch, int cin, int cout, int h,
                                     int wd, int w_kh, int w_kw, int w_ci,
                                     int w_co, int dtype, void* stream) {
  if (bad_shape(batch, cin, cout, h, wd) ||
      static_cast<long long>(batch) * uaps::conv::tile_groups(cout) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const WStrides wst{w_kh, w_kw, w_ci, w_co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == uaps::kF32)
    return static_cast<int>(
        launch_fwd<float>(x, w, wst, y, batch, cin, cout, h, wd, s));
  if (dtype == uaps::kBF16)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(x, w, wst, y, batch,
                                                      cin, cout, h, wd, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [B, H, W, Cin], g [B, H, W, Cout] (dtype, contiguous); part: f32
// scratch of B * ceil(H / strip_rows) * 9 * Cin * Cout elements (strip_rows
// as uaps_conv3x3_wgrad_nchw takes it); dw [3, 3, Cin, Cout] f32. Two
// launches (a partial pass and the fixed-order reduce). Returns a
// cudaError_t code.
extern "C" int uaps_conv3x3_nhwc_wgrad(const void* x, const void* g,
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
        launch_wgrad<float>(x, g, p, d, batch, cin, cout, h, wd,
                            strip_rows, s));
  if (dtype == uaps::kBF16)
    return static_cast<int>(launch_wgrad<__nv_bfloat16>(
        x, g, p, d, batch, cin, cout, h, wd, strip_rows, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
