// Building blocks shared by the port's 3x3 SAME stride-1 NCHW convolutions
// (conv3x3_nchw.cu, conv3x3_wgrad_nchw.cu, block_conv.cu), for Hopper
// (sm_90a). Each source supplies how an input element is read through a
// loader L: `L.at(b, c0)`, called once per block and channel chunk, returns
// a reader whose `float operator()(int ch, int gy, int gx) const` gives
// channel c0 + ch of image b at an in-image position (the halo outside the
// image is zero and is never read). A loader may transform what it reads
// (block_conv.cu applies BN-normalise, LeakyReLU and dropout there, or folds
// the BN-moment cotangents into a gradient), so the transformed tensor is
// never written to device memory.
//
//   conv_tile / store_tile   the forward tile: one block computes a kTH x kTW
//                            output tile of one image for up to 32 output
//                            channels (notes in conv3x3_nchw.cu);
//   wgrad_partial_kernel     the weight gradient's first pass, per-strip
//                            partial sums, for f32 (notes in
//                            conv3x3_wgrad_nchw.cu; bf16 takes the
//                            tensor-core pass of conv3x3_mma.cuh);
//   reduce_kernel            a fixed-order sum of per-block partials, so that
//                            every cross-block reduction is deterministic and
//                            needs no atomics.
#pragma once

#include <stdint.h>

#include <climits>

#include "common.cuh"

namespace uaps {
namespace conv {

// ------------------------------------------------------------- forward tile
constexpr int kTH = 8;                      // output rows per block
constexpr int kTW = 64;                     // output columns per block
constexpr int kPX = 4;                      // neighbouring columns per thread
constexpr int kThreads = kTH * kTW / kPX;   // 128
constexpr int kWarps = kThreads / 32;
constexpr int kCK = 8;                      // input channels per chunk
constexpr int kSH = kTH + 2;                // tile rows with halo
constexpr int kSW = kTW + 2;                // tile columns with halo
constexpr int kMaxCop = 32;                 // output channels per block

template <int COP>
struct TileSmem {
  float xs[kCK][kSH][kSW];
  __align__(16) float ws[kCK][9][COP];
};

// Where a block and a thread sit: image b, output channels [co0, co0 + COP),
// output rows [y0, y0 + kTH) and columns [x0, x0 + kTW); the thread owns row
// y0 + ty, columns x0 + tx .. x0 + tx + kPX - 1. blockIdx.z = image * groups
// + channel group.
struct Tile {
  int b, co0, y0, x0, ty, tx;
};

__device__ __forceinline__ Tile tile_of_block(int groups, int cop) {
  Tile t;
  t.b = blockIdx.z / groups;
  t.co0 = (blockIdx.z % groups) * cop;
  t.y0 = blockIdx.y * kTH;
  t.x0 = blockIdx.x * kTW;
  t.ty = threadIdx.x / (kTW / kPX);
  t.tx = (threadIdx.x % (kTW / kPX)) * kPX;
  return t;
}

// Blocks per SM that a forward tile kernel asks the compiler to fit: 4 (at
// most 128 registers a thread) up to 16 output channels, where the tile
// otherwise takes 131-168 registers and 3 blocks an SM, which ran slower
// (PERF.md, the shared conv tile).
__host__ __device__ constexpr int min_blocks(int cop) {
  return cop <= 16 ? 4 : 1;
}

inline int tile_groups(int cout) { return (cout + kMaxCop - 1) / kMaxCop; }

inline dim3 tile_grid(int batch, int cout, int h, int wd) {
  return dim3((wd + kTW - 1) / kTW, (h + kTH - 1) / kTH,
              batch * tile_groups(cout));
}

// acc[p][co] = the sum over input channels ci < cin and the 9 taps (dh, dw)
// of in[b, ci, y + dh - 1, x + p + dw - 1] * wt(ci, 3 * dh + dw, co0 + co) for
// the thread's pixels. wt(ci, tap, co) is read for ci < cin, co < cout only;
// other weights are zero. Cin is walked in chunks of kCK channels: the
// zero-padded kCK x (kTH+2) x (kTW+2) input tile and the weight chunk sit in
// shared memory; every input value a thread reads there serves 3 horizontal
// taps and every weight (a broadcast float4 read) serves kPX pixels.
template <int COP, typename In, typename Wt>
__device__ __forceinline__ void conv_tile(float (&acc)[kPX][COP],
                                          TileSmem<COP>& sm, const Tile& t,
                                          const In& in, const Wt& wt, int cin,
                                          int cout, int h, int wd) {
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int co = 0; co < COP; ++co) acc[p][co] = 0.f;
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < cin; c0 += kCK) {
    const int nc = min(kCK, cin - c0);
    const auto ld = in.at(t.b, c0);
    __syncthreads();  // the previous chunk is consumed by every thread
    for (int i = tid; i < kCK * kSH * kSW; i += kThreads) {
      const int c = i / (kSH * kSW);
      const int r = (i / kSW) % kSH;
      const int col = i % kSW;
      const int gy = t.y0 - 1 + r;
      const int gx = t.x0 - 1 + col;
      float v = 0.f;
      if (c < nc && gy >= 0 && gy < h && gx >= 0 && gx < wd)
        v = ld(c, gy, gx);
      sm.xs[c][r][col] = v;
    }
    for (int i = tid; i < kCK * 9 * COP; i += kThreads) {
      const int c = i / (9 * COP);
      const int tap = (i / COP) % 9;
      const int co = i % COP;
      sm.ws[c][tap][co] =
          (c < nc && t.co0 + co < cout) ? wt(c0 + c, tap, t.co0 + co) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        float xv[kPX + 2];
#pragma unroll
        for (int j = 0; j < kPX + 2; ++j) xv[j] = sm.xs[c][t.ty + dh][t.tx + j];
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float4* wv =
              reinterpret_cast<const float4*>(&sm.ws[c][dh * 3 + dw][0]);
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
}

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

// y[b, co0 + co, oy, ox + p] = acc[p][co] for the in-image pixels and the
// channels below cout (y contiguous [B, cout, H, W]). wd % 4 == 0 makes every
// row start and every ox 4-aligned (y is a fresh allocation), so the kPX = 4
// pixels go out as one vector store.
template <typename Tout, int COP>
__device__ __forceinline__ void store_tile(Tout* __restrict__ y,
                                           const float (&acc)[kPX][COP],
                                           const Tile& t, int cout, int h,
                                           int wd) {
  const int oy = t.y0 + t.ty;
  const int ox = t.x0 + t.tx;
  if (oy >= h || ox >= wd) return;
  const size_t plane = static_cast<size_t>(h) * wd;
  Tout* yr = y + (static_cast<size_t>(t.b) * cout + t.co0) * plane +
             static_cast<size_t>(oy) * wd + ox;
  const bool vec = (wd % 4) == 0;
#pragma unroll
  for (int co = 0; co < COP; ++co) {
    if (t.co0 + co >= cout) break;
    Tout* p = yr + co * plane;
    if (vec) {
      store4(p, acc[0][co], acc[1][co], acc[2][co], acc[3][co]);
    } else {
#pragma unroll
      for (int q = 0; q < kPX; ++q)
        if (ox + q < wd) p[q] = from_f32<Tout>(acc[q][co]);
    }
  }
}

// The sum of v over the block's threads, in a fixed order (a butterfly over
// each warp, then the warps in order); every thread of the block must call
// it. red: shared scratch of kWarps floats; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k];
  return s;
}

// ---------------------------------------------------- weight-gradient pass 1
namespace wgrad {
constexpr int kThreads = 256;
constexpr int kTH = 4;               // tile rows
constexpr int kTW = 32;              // tile columns
constexpr int kPix = kTH * kTW;      // 128 pixels per tile
constexpr int kCK = 16;              // input channels per block
constexpr int kSH = kTH + 2;         // tile rows with halo
constexpr int kSW = kTW + 3;         // 34 columns with halo + 1 of padding
constexpr int kStripRows = 16;       // image rows per block (STRIP_ROWS
                                     // in kernels/conv3x3_nchw.py)
}  // namespace wgrad

// part[strip, kh, kw, ci, co] = the sum over the strip's pixels of
// in[b, ci, y + kh - 1, x + kw - 1] * g[b, co, y, x]: block (strip, ci chunk,
// co chunk); CC = COG * NG output channels per block, a thread owns one
// input channel and one group of COG output channels (notes in
// conv3x3_wgrad_nchw.cu). Two blocks per SM: at most 128 registers a thread
// (without the bound it took 164-170 and one block an SM, which ran slower).
template <int COG, int NG, typename In, typename G>
__global__ void __launch_bounds__(wgrad::kThreads, 2)
    wgrad_partial_kernel(In in, G gl, float* __restrict__ part, int cin,
                         int cout, int h, int wd, int strips_per_image) {
  // block-scope declarations hide the forward tile's names of the same kind
  using wgrad::kCK;
  using wgrad::kPix;
  using wgrad::kSH;
  using wgrad::kStripRows;
  using wgrad::kSW;
  using wgrad::kTH;
  using wgrad::kThreads;
  using wgrad::kTW;
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
  const auto xin = in.at(b, c0);
  const auto gin = gl.at(b, co0);
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
          v = xin(c, gy, gx);
        xs[c][r][col] = v;
      }
      // consecutive threads read consecutive pixels of one channel
      for (int i = tid; i < kPix * CC; i += kThreads) {
        const int co = i / kPix;
        const int p = i % kPix;
        const int gy = ty0 + p / kTW;
        const int gx = tx0 + p % kTW;
        float v = 0.f;  // rows past the strip belong to the next block
        if (co < nco && gy < r_end && gx < wd) v = gin(co, gy, gx);
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

// ------------------------------------------------------------ fixed reduce
constexpr int kRedRows = 8;  // thread rows of the reduce pass

// out[i] = the sum over k < n_part of part[k * total + i], in a fixed order:
// each thread row takes every kRedRows-th k, then the rows are added in
// order.
__global__ void __launch_bounds__(32 * kRedRows)
    reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
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
    out[i] = sum;
  }
}

inline cudaError_t reduce_partials(const float* part, float* out, int n_part,
                                   int total, cudaStream_t stream) {
  reduce_kernel<<<(total + 31) / 32, dim3(32, kRedRows), 0, stream>>>(
      part, out, n_part, total);
  return cudaGetLastError();
}

// The weight gradient of a 3x3 SAME conv: pass 1 into `part` (f32, B *
// ceil(H / kStripRows) * 9 * Cin * Cout), then the fixed-order reduce into dw
// [3, 3, Cin, Cout] f32. Two launches.
template <typename In, typename G>
cudaError_t launch_wgrad(const In& in, const G& gl, float* part, float* dw,
                         int batch, int cin, int cout, int h, int wd,
                         cudaStream_t stream) {
  using wgrad::kCK;
  using wgrad::kStripRows;
  using wgrad::kThreads;
  const int strips_per_image = (h + kStripRows - 1) / kStripRows;
  const int strips = batch * strips_per_image;
  const int cchunks = (cin + kCK - 1) / kCK;
  if (cout <= 4) {
    wgrad_partial_kernel<4, 1><<<dim3(strips, cchunks, 1), kThreads, 0,
                                 stream>>>(in, gl, part, cin, cout, h, wd,
                                           strips_per_image);
  } else if (cout <= 8) {
    wgrad_partial_kernel<8, 1><<<dim3(strips, cchunks, 1), kThreads, 0,
                                 stream>>>(in, gl, part, cin, cout, h, wd,
                                           strips_per_image);
  } else if (cout <= 16) {
    wgrad_partial_kernel<8, 2><<<dim3(strips, cchunks, 1), kThreads, 0,
                                 stream>>>(in, gl, part, cin, cout, h, wd,
                                           strips_per_image);
  } else {
    wgrad_partial_kernel<8, 4>
        <<<dim3(strips, cchunks, (cout + 31) / 32), kThreads, 0, stream>>>(
            in, gl, part, cin, cout, h, wd, strips_per_image);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(part, dw, strips, 9 * cin * cout, stream);
}

// The loaders index a contiguous [B, C, H, W] tensor from a base pointer
// that `at` computes once, at plane b * C + c0 (32-bit), then per element
// ch * H * W + (gy * W + gx): the full 64-bit index of every element,
// computed in each tile load, made the tiles markedly slower (PERF.md,
// the shared conv tile). The entry points refuse shapes for which B * C or
// H * W exceeds INT_MAX.
inline bool index_fits(int batch, int c, int h, int wd) {
  return static_cast<long long>(batch) * c <= INT_MAX &&
         static_cast<long long>(h) * wd <= INT_MAX;
}

// A contiguous NCHW tensor read as f32 (through the read-only data cache,
// as a __restrict__ kernel argument would be).
template <typename T>
struct PlainLoad {
  const T* x;
  int c;   // channels of x
  int h, wd;
  struct At {
    const T* p;   // channel c0 of image b
    size_t plane;
    int wd;
    __device__ __forceinline__ float operator()(int ch, int gy,
                                                int gx) const {
      return to_f32(__ldg(p + ch * plane + (gy * wd + gx)));
    }
  };
  __device__ __forceinline__ At at(int b, int c0) const {
    const size_t plane = static_cast<size_t>(h) * wd;
    return At{x + static_cast<size_t>(b * c + c0) * plane, plane, wd};
  }
};

}  // namespace conv
}  // namespace uaps
