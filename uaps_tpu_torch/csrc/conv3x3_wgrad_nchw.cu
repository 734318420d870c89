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
//   2. wgrad_reduce_kernel: dW[i] = the sum over strips of scratch[., i],
//      each thread a fixed stride of strips, then a fixed-order sum of the
//      8 thread rows.
//
// What bounds it: 2 * B*H*W * Cin*Cout*9 flops against reading x and g
// once: ~72 flop per byte at Cin = Cout = 16 in bf16, so like the forward it
// is bound by CUDA-core FMA throughput (f32 accumulation, no tensor cores
// yet). In pass 1 a thread owns one input channel and COG (8, or 4 for the
// Cout = 4 head) output channels for all 9 taps: 72 f32 accumulators that
// take 9 x-values and COG g-values from shared memory per pixel, 72 FMAs
// for 17 loads. The block stages a zero-padded kCK x (kTH+2) x (kTW+3) input
// tile (the odd channel stride of 210 floats keeps the 8-16 channels a warp
// reads in different banks) and the kTH x kTW x CC cotangent tile, and walks
// its strip tile by tile; the S = 256 / (kCK * CC / COG) threads that share
// an (input, output-channel) pair take every S-th pixel of a tile and are
// summed in shared memory, in order, at the end. The scratch traffic is
// 9 * Cin * Cout f32 per strip: 4.7 MB for up3.0 (64 -> 32 at 128 px, 128
// strips), small beside the pass-1 work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 4;               // tile rows
constexpr int kTW = 32;              // tile columns
constexpr int kPix = kTH * kTW;      // 128 pixels per tile
constexpr int kCK = 16;              // input channels per block
constexpr int kSH = kTH + 2;         // tile rows with halo
constexpr int kSW = kTW + 3;         // 34 columns with halo + 1 of padding
constexpr int kStripRows = 16;       // image rows per block (keep in step
                                     // with STRIP_ROWS in the wrapper)
constexpr int kRedRows = 8;          // thread rows of the reduce pass

// CC = COG * NG output channels per block; a thread owns one input channel
// and one group of COG output channels.
template <typename T, int COG, int NG>
__global__ void __launch_bounds__(kThreads)
    wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         float* __restrict__ part, int cin, int cout, int h,
                         int wd, int strips_per_image) {
  constexpr int CC = COG * NG;
  constexpr int kItems = kCK * NG;        // (ci, co group) pairs
  constexpr int S = kThreads / kItems;    // threads per pair
  static_assert(kThreads % kItems == 0, "pairs must divide the block");
  __shared__ float xs[kCK][kSH][kSW];
  __shared__ float gs[kPix][CC + 1];      // odd row: conflict-free stores
  __shared__ float red[kThreads * COG];

  const int strip = blockIdx.x;
  const int b = strip / strips_per_image;
  const int r0 = (strip % strips_per_image) * kStripRows;
  const int r_end = min(h, r0 + kStripRows);
  const int c0 = blockIdx.y * kCK;
  const int co0 = blockIdx.z * CC;
  const int nc = min(kCK, cin - c0);
  const int nco = min(CC, cout - co0);
  const int tid = threadIdx.x;
  const int item = tid % kItems;
  const int s = tid / kItems;
  const int ci = item / NG;
  const int cg = item % NG;

  float acc[9][COG];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < COG; ++j) acc[t][j] = 0.f;

  const size_t plane = static_cast<size_t>(h) * wd;
  const T* xb = x + (static_cast<size_t>(b) * cin + c0) * plane;
  const T* gb = g + (static_cast<size_t>(b) * cout + co0) * plane;

  for (int ty0 = r0; ty0 < r_end; ty0 += kTH) {
    for (int tx0 = 0; tx0 < wd; tx0 += kTW) {
      __syncthreads();  // the previous tile is consumed by every thread
      for (int i = tid; i < kCK * kSH * (kTW + 2); i += kThreads) {
        const int c = i / (kSH * (kTW + 2));
        const int r = (i / (kTW + 2)) % kSH;
        const int col = i % (kTW + 2);
        const int gy = ty0 - 1 + r;
        const int gx = tx0 - 1 + col;
        float v = 0.f;
        if (c < nc && gy >= 0 && gy < h && gx >= 0 && gx < wd)
          v = uaps::to_f32(xb[c * plane + static_cast<size_t>(gy) * wd + gx]);
        xs[c][r][col] = v;
      }
      // consecutive threads read consecutive pixels of one channel
      for (int i = tid; i < kPix * CC; i += kThreads) {
        const int co = i / kPix;
        const int p = i % kPix;
        const int gy = ty0 + p / kTW;
        const int gx = tx0 + p % kTW;
        float v = 0.f;  // rows past the strip belong to the next block
        if (co < nco && gy < r_end && gx < wd)
          v = uaps::to_f32(gb[co * plane + static_cast<size_t>(gy) * wd + gx]);
        gs[p][co] = v;
      }
      __syncthreads();

      for (int p = s; p < kPix; p += S) {
        const int py = p / kTW;
        const int px = p % kTW;
        float xv[9];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            xv[kh * 3 + kw] = xs[ci][py + kh][px + kw];
        float gv[COG];
#pragma unroll
        for (int j = 0; j < COG; ++j) gv[j] = gs[p][cg * COG + j];
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int j = 0; j < COG; ++j)
            acc[t][j] = fmaf(xv[t], gv[j], acc[t][j]);
      }
    }
  }

  // sum the S threads of each pair, in order, one tap at a time, and write
  // the block's slot of the scratch buffer
  float* out = part + static_cast<size_t>(strip) * 9 * cin * cout;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < COG; ++j) red[tid * COG + j] = acc[t][j];
    __syncthreads();
    for (int o = tid; o < kItems * COG; o += kThreads) {
      float v = 0.f;
      for (int q = 0; q < S; ++q) v += red[q * kItems * COG + o];
      const int it = o / COG;
      const int oc = it / NG;                  // input channel in the chunk
      const int oo = (it % NG) * COG + o % COG;  // output channel in chunk
      if (oc < nc && oo < nco)
        out[(static_cast<size_t>(t) * cin + c0 + oc) * cout + co0 + oo] = v;
    }
  }
}

// dw[i] = sum over k < n_part of part[k * total + i], in a fixed order
__global__ void __launch_bounds__(32 * kRedRows)
    wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                        int n_part, int total) {
  __shared__ float sm[kRedRows][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (i < total)
    for (int k = threadIdx.y; k < n_part; k += kRedRows)
      v += part[static_cast<size_t>(k) * total + i];
  sm[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && i < total) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kRedRows; ++r) sum += sm[r][threadIdx.x];
    dw[i] = sum;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, float* part, float* dw,
                   int batch, int cin, int cout, int h, int wd,
                   cudaStream_t stream) {
  const int strips_per_image = (h + kStripRows - 1) / kStripRows;
  const int strips = batch * strips_per_image;
  const T* xi = static_cast<const T*>(x);
  const T* gi = static_cast<const T*>(g);
  const int cchunks = (cin + kCK - 1) / kCK;
  if (cout <= 4) {
    wgrad_partial_kernel<T, 4, 1><<<dim3(strips, cchunks, 1), kThreads, 0,
                                     stream>>>(xi, gi, part, cin, cout, h, wd,
                                               strips_per_image);
  } else if (cout <= 8) {
    wgrad_partial_kernel<T, 8, 1><<<dim3(strips, cchunks, 1), kThreads, 0,
                                     stream>>>(xi, gi, part, cin, cout, h, wd,
                                               strips_per_image);
  } else if (cout <= 16) {
    wgrad_partial_kernel<T, 8, 2><<<dim3(strips, cchunks, 1), kThreads, 0,
                                     stream>>>(xi, gi, part, cin, cout, h, wd,
                                               strips_per_image);
  } else {
    wgrad_partial_kernel<T, 8, 4>
        <<<dim3(strips, cchunks, (cout + 31) / 32), kThreads, 0, stream>>>(
            xi, gi, part, cin, cout, h, wd, strips_per_image);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = 9 * cin * cout;
  wgrad_reduce_kernel<<<(total + 31) / 32, dim3(32, kRedRows), 0, stream>>>(
      part, dw, strips, total);
  return cudaGetLastError();
}

}  // namespace

// x [B, Cin, H, W], g [B, Cout, H, W] (dtype, contiguous); part: f32
// scratch of B * ceil(H / 16) * 9 * Cin * Cout elements; dw [3, 3, Cin,
// Cout] f32. Returns a cudaError_t code.
extern "C" int uaps_conv3x3_wgrad_nchw(const void* x, const void* g,
                                       void* part, void* dw, int batch,
                                       int cin, int cout, int h, int wd,
                                       int dtype, void* stream) {
  if (batch < 1 || cin < 1 || cout < 1 || h < 1 || wd < 1 ||
      (cin + kCK - 1) / kCK > 65535 || (cout + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* d = static_cast<float*>(dw);
  if (dtype == uaps::kF32)
    return static_cast<int>(
        launch<float>(x, g, p, d, batch, cin, cout, h, wd, s));
  if (dtype == uaps::kBF16)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, g, p, d, batch, cin, cout, h, wd, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
