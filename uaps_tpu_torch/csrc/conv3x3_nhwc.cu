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
// Design, routed by dtype as every conv source of the port. bf16, the
// forward and the dgrad: nhwc_fwd_mma_kernel, conv3x3_mma.cuh's
// tensor-core tile (conv_mma_tile: an 8 x 32 pixel tile, mma.sync m16n8k16
// bf16 -> f32, up to 64 output channels a block, in groups of 64 above) with
// the NHWC loader NhwcLoad. NHWC is the layout that tile stages: one
// 16-byte unit is 8 channels of one pixel, 16 contiguous bytes of x, so
// where Cin % 8 == 0 and x is 16-byte aligned each unit is one cp.async
// into its swizzled slot (stage_tile_nhwc; the halo and the channels past
// Cin zero-filled by the copy), and any other Cin reads one value a load
// (the tile's generic stage). The weights are staged k-major
// (KMajorWeights): 16-byte loads where the output channels have unit
// stride (the forward's HWIO), one value a load through the dgrad's
// flipped, ci/co-swapped strides. The output goes through shared memory,
// rounded once to bf16, and out as one 16-byte store per pixel and
// 8-channel group where Cout % 8 == 0 (scalar stores otherwise). The bf16
// weight gradient runs conv3x3_mma.cuh's wgrad_mma_kernel through the same
// loader. f32 keeps the CUDA-core tiles (conv3x3_tile.cuh: conv_tile, the
// two-pass deterministic launch_wgrad; TF32 would fail the port's 1e-4
// gates) with NhwcLoad and an NHWC store, in groups of 32 output channels
// along grid.z. No transposed copy of x or g is made. The TPU kernel's
// in-VMEM im2col existed to give the MXU a full-depth K = 9 * Cin; the
// tiles read every staged value into 9 taps without it.
//
// What bounds it: in bf16, bytes (at [16, 256, 256, 16] -> 16 the forward's
// 4.8 GFLOP take 0.005 ms at the bf16 peak, reading x and writing y 0.04
// ms), and in practice the staging, as for the NCHW forward (conv3x3_mma.cuh
// says how the tile answers it). In f32, CUDA-core FMA throughput (~72 flop
// per byte at Cin = Cout = 16): the tiles load in pixel-major order, so a
// warp's load reads one channel of 32 neighbouring pixels, Cin elements
// apart: each 32-byte sector it touches also holds the pixel's other
// channels, which the tile's next channel iterations find in L1. The f32
// store writes each pixel's channels as 16-byte vectors where Cout % 4 ==
// 0.

#include <stdint.h>

#include "conv3x3_mma.cuh"
#include "conv3x3_tile.cuh"

namespace {

using uaps::from_f32;
using uaps::to_f32;
using uaps::conv::kPX;
using uaps::conv::kThreads;
using uaps::conv::NhwcLoad;
using uaps::conv::WStrides;

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

namespace tc = uaps::conv::tc;

// y[b, gy, gx, n0 + ch] = acc rounded once to bf16 (as store_mma_tile) for
// the tile's in-image pixels and the channels below nout (y contiguous [B,
// H, W, nout]): through a [kTH * kTW pixels][8 NB channels] bf16 plane in
// shared memory (a pixel's row padded by 8 channels, so that the 8 rows of
// one fragment store fall in different banks), then one 16-byte store per
// pixel and 8-channel group where nout % 8 == 0 and y is 16-byte aligned,
// scalar stores otherwise.
__host__ __device__ constexpr int nhwc_row(int nb) {   // elements a pixel
  return 8 * nb + 8;
}

template <int NB>
__device__ __forceinline__ void store_nhwc_mma_tile(
    __nv_bfloat16* __restrict__ y, const float (&acc)[2][NB][4],
    unsigned char* smem, const tc::MmaTile& t, int nout, int h, int wd) {
  namespace dg = tc::dg;
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the operand tiles are consumed
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2)   // e, e + 1: channels ch, ch + 1
        *reinterpret_cast<__nv_bfloat162*>(
            os + (warp * dg::kTW + tc::mma_px(hh, e, lane)) * nhwc_row(NB) +
            tc::mma_ch(n, e, lane)) =
            __floats2bfloat162_rn(acc[hh][n][e], acc[hh][n][e + 1]);
  __syncthreads();
  const bool vec =
      (nout % 8) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  for (int i = threadIdx.x; i < dg::kTH * dg::kTW * NB; i += dg::kThreads) {
    const int ch = 8 * (i % NB);
    const int px = i / NB;
    const int gy = t.y0 + px / dg::kTW;
    const int gx = t.x0 + px % dg::kTW;
    if (gy >= h || gx >= wd || t.n0 + ch >= nout) continue;
    __nv_bfloat16* dst =
        y + ((static_cast<size_t>(t.b) * h + gy) * wd + gx) * nout + t.n0 +
        ch;
    const __nv_bfloat16* src = os + px * nhwc_row(NB) + ch;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && t.n0 + ch + j < nout; ++j) dst[j] = src[j];
    }
  }
}

// y = conv3x3(x, W) in bf16 over NHWC tensors on the tensor cores (the bf16
// forward and, through the flipped weight view, the dgrad): conv_mma_tile
// with the NHWC loader (16-byte cp.async staging where Cin % 8 == 0) and
// k-major weights. The name is its own: the profiler's route proofs tell
// the kernels apart by name.
template <int NB>
__global__ void __launch_bounds__(tc::dg::kThreads, 2)
    nhwc_fwd_mma_kernel(NhwcLoad<__nv_bfloat16> in,
                        const __nv_bfloat16* __restrict__ w, WStrides ws,
                        __nv_bfloat16* __restrict__ y, int cin, int cout,
                        int h, int wd, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const tc::MmaTile t = tc::mma_tile_of_block<NB>(groups);
  float acc[2][NB][4];
  tc::conv_mma_tile<NB>(acc, smem, t, in,
                        tc::KMajorWeights<NB>{w, ws, cout, t.n0}, cin, h, wd);
  store_nhwc_mma_tile<NB>(y, acc, smem, t, cout, h, wd);
}

template <int NB>
cudaError_t nhwc_fwd_mma_launch(const __nv_bfloat16* x,
                                const __nv_bfloat16* w, WStrides ws,
                                __nv_bfloat16* y, int batch, int cin,
                                int cout, int h, int wd,
                                cudaStream_t stream) {
  // conv_mma_tile's operand tiles, reused for the output plane
  constexpr int kSmem = tc::mma_tile_smem(NB);
  static_assert(tc::dg::kTH * tc::dg::kTW * nhwc_row(NB) * 2 <= kSmem,
                "the output plane fits the operand tiles' shared memory");
  // above 48 KB only after opting in, once per kernel
  static const cudaError_t opt = cudaFuncSetAttribute(
      nhwc_fwd_mma_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (opt != cudaSuccess) return opt;
  const dim3 grid = tc::mma_grid<NB>(batch, cout, h, wd);
  nhwc_fwd_mma_kernel<NB><<<grid, tc::dg::kThreads, kSmem, stream>>>(
      NhwcLoad<__nv_bfloat16>{x, cin, h, wd}, w, ws, y, cin, cout, h, wd,
      static_cast<int>(grid.z) / batch);
  return cudaGetLastError();
}

// Routed by dtype: bf16 on the tensor cores (NB n8 tiles of output
// channels a block: 16, 32, or groups of 64, as launch_conv_fwd_mma), f32
// on the CUDA-core tile (TF32 would fail the port's 1e-4 gates).
template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, WStrides wst, void* y,
                       int batch, int cin, int cout, int h, int wd,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (cout <= 16)
      return nhwc_fwd_mma_launch<2>(xb, wb, wst, yb, batch, cin, cout, h, wd,
                                    stream);
    if (cout <= 32)
      return nhwc_fwd_mma_launch<4>(xb, wb, wst, yb, batch, cin, cout, h, wd,
                                    stream);
    return nhwc_fwd_mma_launch<8>(xb, wb, wst, yb, batch, cin, cout, h, wd,
                                  stream);
  } else {
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
// contiguous). B times the channel groups of the dtype's grid <= 65535:
// ceil(Cout / 32) for f32 (the CUDA-core tile), 1 up to 32 channels and
// ceil(Cout / 64) above for bf16 (the tensor cores). Returns a cudaError_t
// code.
extern "C" int uaps_conv3x3_nhwc_fwd(const void* x, const void* w, void* y,
                                     int batch, int cin, int cout, int h,
                                     int wd, int w_kh, int w_kw, int w_ci,
                                     int w_co, int dtype, void* stream) {
  const int groups = dtype == uaps::kBF16 ? tc::mma_fwd_groups(cout)
                                          : uaps::conv::tile_groups(cout);
  if (bad_shape(batch, cin, cout, h, wd) ||
      static_cast<long long>(batch) * groups > 65535)
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
