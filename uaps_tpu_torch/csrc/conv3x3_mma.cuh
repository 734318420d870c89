// Tensor-core (mma.sync bf16 -> f32) building blocks of the port's bf16 3x3
// SAME stride-1 convolutions, for Hopper (sm_90a):
//
//   wgrad_mma_kernel   the weight gradient's first pass, per-strip partial
//                      sums of dW (launch_wgrad_mma, then conv3x3_tile.cuh's
//                      fixed-order reduce_kernel);
//   conv_mma_tile      an 8 x 32 output tile of a 3x3 conv for up to 64
//                      output channels; dgrad_mma_kernel runs it as the
//                      input gradient (the conv of the cotangent with the
//                      rotated weight).
//
// Replaces, for bf16 inputs, uaps_tpu/pallas/conv3x3_nchw.py:601
// conv3x3_nchw_wgrad (its pallas_call at :692) and the dgrad of
// uaps_tpu/pallas/block_conv.py:345 _chain_bwd_call (its pallas_call at
// :368) without the prologue. The TPU kernels compute every tap as a
// dot_general on the MXU; these compute every tap as m16n8k16 products on
// the tensor cores. f32 inputs keep the CUDA-core kernels of
// conv3x3_tile.cuh (conv_tile, wgrad_partial_kernel): tensor cores would
// only give TF32 there. The entry points route by dtype alone.
//
// Operands are read through the same loaders as the CUDA-core kernels
// (L.at(b, c0)(ch, gy, gx) -> float; conv3x3_tile.cuh). For bf16 every
// loader returns a bf16 value (PlainLoad, NhwcLoad), or rounds to bf16
// (block_conv.cu's ProLoad and FoldLoad), so the value staged here is
// exactly what the CUDA-core kernel multiplies; a bf16 x bf16 product is
// exact in f32, and only the summation order differs.
//
// Staging. A tile of activations sits in shared memory channel-minor: one
// 16-byte unit holds 8 channels of one pixel, a pixel has CH units (CH = 1,
// 2, 4, 8), and unit c of pixel p lives at p * CH + (c ^ swz(p)) with swz(p)
// = (p / (8 / CH)) % CH. Any 8 consecutive pixels at one chunk then fall
// in 8 different 16-byte bank groups, so every ldmatrix row set, which is
// 8 consecutive pixels of a tap's shifted window, is conflict-free, and a
// tap's window is only another set of the per-lane row addresses that
// ldmatrix takes. The halo outside the image, channels past the last and
// pixels past the tile's edge are zeros written at staging. The staging
// pass reads NCHW through the loader, coalesced along x (consecutive
// threads take consecutive pixels of one 8-channel chunk), and writes one
// 16-byte unit a thread.
//
// What bounds them now: once the products are on the tensor cores, bytes.
// At up3.0 (64 -> 32 channels, 128 x 128, B = 16) the weight gradient's
// 9.66 GFLOP take ~0.01 ms at the bf16 peak, against 0.015 ms to read z and
// ge once (50 MB); the chain dgrad's likewise (0.01 ms of products, 0.015 ms
// for ge and dz). What the design does about it: each block reads its
// operand tiles once into shared memory (the 1-pixel halo is the only
// re-read: (4+2)/4 x (64+2)/64 = 1.55x for the wgrad's z, (8+2)/8 x
// (32+2)/32 = 1.33x for the dgrad's ge), every staged value feeds 3 taps x
// up to 32 output channels (wgrad) or 9 taps x up to 64 (dgrad) from
// shared memory, and the staging loads of many warps and blocks are in
// flight at once (two blocks an SM). The wgrad's strip height (chosen by
// the Python wrappers' wgrad_strips: the tallest of 16, 8, 4 rows that
// still gives 256 blocks, two an SM) trades blocks in flight against the
// partials' traffic (9 * Cin * Cout f32 a strip) and each block's fixed
// cost (its K-group sum and its partial's store).
//
// Wasted products by padding, at the main-path shapes: the wgrad pads Cin
// to 16 a warp chunk (in_conv.0's Cin = 3: 13/16 = 81% of its products;
// none at Cin 16, 32, 64) and Cout to an n8 tile (out_conv's Cout = 4: 50%;
// none at 16 and 32); a W that is no multiple of 16 pads the last K step
// (none on the main path). The dgrad pads its K (Cout) to 16 (none at 16
// and 32) and its N (Cin) to the block's 16, 32 or 64 channels (none at
// 16, 32, 64); in_conv.0 takes no dgrad.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "conv3x3_tile.cuh"

namespace uaps {
namespace conv {
namespace tc {

// ------------------------------------------------------------ PTX wrappers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ----------------------------------------------------------------- staging
// the 16-byte unit of chunk c of row p in a tile of CH chunks a row
template <int CH>
__device__ __forceinline__ int unit(int p, int c) {
  return p * CH + (c ^ ((p / (8 / CH)) & (CH - 1)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// Write units [0, NPIX) x [0, nchunk) of a tile of CH chunks a row
// (nchunk <= CH): unit (p, c) holds channels 8c .. 8c + 7 of tile pixel p,
// rd(ch, gy, gx) where pos(p, gy, gx) places p inside the image, zeros where
// it does not and for channels >= nch. Consecutive threads take consecutive
// pixels of a chunk. The loop is not unrolled: unrolling it (by 2, 4 or
// fully) took more registers, fewer blocks an SM and more time at every
// main-path shape on an H100; the loads in flight come from two blocks
// an SM instead.
template <int CH, int NPIX, int NTHREADS, typename Rd, typename Pos>
__device__ __forceinline__ void stage(uint4* s, const Rd& rd, int nchunk,
                                      int nch, const Pos& pos) {
#pragma unroll 1
  for (int i = threadIdx.x; i < NPIX * nchunk; i += NTHREADS) {
    const int c = i / NPIX;
    const int p = i - c * NPIX;
    int gy = 0, gx = 0;
    const bool in = pos(p, gy, gx);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = in && 8 * c + j < nch ? rd(8 * c + j, gy, gx) : 0.f;
    s[unit<CH>(p, c)] =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// --------------------------------------------------- weight-gradient pass 1
namespace wg {
constexpr int kTH = 4;                // tile rows (strips are multiples)
constexpr int kTW = 64;               // tile columns: 4 K steps of 16 a row
constexpr int kZW = kTW + 2;          // z tile columns with halo
constexpr int kZPix = (kTH + 2) * kZW;  // 396
constexpr int kGPix = kTH * kTW;        // 256
constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;
}  // namespace wg

// part[strip, kh, kw, ci, co] = the sum over the strip's pixels of
// z[b, ci, y + kh - 1, x + kw - 1] * ge[b, co, y, x]: a GEMM with M = (tap,
// ci), N = co, K = the strip's pixels. Block (strip, ci chunk of 16 MC,
// co chunk of 8 NT; MC = 1, 2, 4); its 12 warps are KG = 4 / MC groups of
// 3 MC, warp
// (group, m, kh) owning input channels [16 m, 16 m + 16) of the chunk, the
// 3 taps of kernel row kh and every output channel: 3 x NT m16n8
// accumulators. Per K step (16 pixels of one tile row) a warp loads NT / 2
// (or one x2) B fragments of ge and 3 A fragments of z, all with
// ldmatrix.trans (the tiles are pixel-major, K along the rows), for 3 NT
// products. The groups split the tile's rows and are summed in a fixed
// order in shared memory at the end; group 0 writes the block's slot. Two
// blocks an SM (at most 80 registers a thread; a few bytes spill at NT = 4):
// with one block an SM (113-168 registers) every main-path shape ran
// slower on an H100, since the staging loads of 12 warps an SM could not
// cover the memory latency.
template <int MC, int NT, typename In, typename G>
__global__ void __launch_bounds__(wg::kThreads, 2)
    wgrad_mma_kernel(In in, G gl, float* __restrict__ part, int cin,
                     int cout, int h, int wd, int strip_rows,
                     int strips_per_image) {
  constexpr int KG = 4 / MC;           // K groups
  constexpr int RPG = wg::kTH / KG;    // tile rows per group
  constexpr int CHZ = 2 * MC;          // z chunks (of 8 channels) a pixel
  constexpr int CHG = NT;              // ge chunks a pixel
  constexpr int kGW = 3 * MC;          // warps a group
  static_assert(NT == 1 || NT == 2 || NT == 4, "NT: 1, 2 or 4 n8 tiles");
  extern __shared__ __align__(16) unsigned char smem[];  // wgrad_mma_smem
  uint4* zs = reinterpret_cast<uint4*>(smem);
  uint4* gs = zs + wg::kZPix * CHZ;

  const int strip = blockIdx.x;
  const int b = strip / strips_per_image;
  const int r0 = (strip % strips_per_image) * strip_rows;
  const int r_end = min(h, r0 + strip_rows);
  const int c0 = blockIdx.y * 16 * MC;
  const int co0 = blockIdx.z * 8 * NT;
  const int nc = min(16 * MC, cin - c0);
  const int nco = min(8 * NT, cout - co0);
  const auto xin = in.at(b, c0);
  const auto gin = gl.at(b, co0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = warp / kGW;
  const int m = (warp % kGW) / 3;
  const int kh = warp % 3;
  const int mi = lane >> 3;   // the ldmatrix matrix this lane addresses

  float acc[3][NT][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kw][n][e] = 0.f;

  for (int ty0 = r0; ty0 < r_end; ty0 += wg::kTH) {
    for (int tx0 = 0; tx0 < wd; tx0 += wg::kTW) {
      __syncthreads();  // the previous tile is consumed by every warp
      stage<CHZ, wg::kZPix, wg::kThreads>(
          zs, xin, CHZ, nc, [&](int p, int& gy, int& gx) {
            gy = ty0 - 1 + p / wg::kZW;
            gx = tx0 - 1 + p % wg::kZW;
            return gy >= 0 && gy < h && gx >= 0 && gx < wd;
          });
      // rows past the strip belong to the next block
      stage<CHG, wg::kGPix, wg::kThreads>(
          gs, gin, CHG, nco, [&](int p, int& gy, int& gx) {
            gy = ty0 + p / wg::kTW;
            gx = tx0 + p % wg::kTW;
            return gy < r_end && gx < wd;
          });
      __syncthreads();

      const int rows = min(wg::kTH, r_end - ty0);
      const int nk = (min(wg::kTW, wd - tx0) + 15) / 16;
#pragma unroll
      for (int rr = 0; rr < RPG; ++rr) {
        const int r = grp * RPG + rr;
        if (r >= rows) break;
        for (int j = 0; j < nk; ++j) {
          uint32_t bf[NT][2];
          if constexpr (NT == 1) {
            uint32_t t2[2];
            const int p = r * wg::kTW + 16 * j + (mi & 1) * 8 + (lane & 7);
            ldsm_x2_t(t2, smem_addr(gs + unit<CHG>(p, 0)));
            bf[0][0] = t2[0];
            bf[0][1] = t2[1];
          } else {
#pragma unroll
            for (int q = 0; q < NT / 2; ++q) {
              uint32_t t4[4];
              const int p = r * wg::kTW + 16 * j + (mi & 1) * 8 + (lane & 7);
              ldsm_x4_t(t4, smem_addr(gs + unit<CHG>(p, 2 * q + (mi >> 1))));
              bf[2 * q][0] = t4[0];
              bf[2 * q][1] = t4[1];
              bf[2 * q + 1][0] = t4[2];
              bf[2 * q + 1][1] = t4[3];
            }
          }
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            uint32_t a[4];
            const int p = (r + kh) * wg::kZW + 16 * j + kw + (mi >> 1) * 8 +
                          (lane & 7);
            ldsm_x4_t(a, smem_addr(zs + unit<CHZ>(p, 2 * m + (mi & 1))));
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma16816(acc[kw][n], a, bf[n][0], bf[n][1]);
          }
        }
      }
    }
  }

  // group 0 += group 1, then += group 2, ...: a fixed order
  if constexpr (KG > 1) {
    float* red = reinterpret_cast<float*>(smem);
    const int slot = (warp % kGW) * 32 + lane;
#pragma unroll 1
    for (int g = 1; g < KG; ++g) {
      __syncthreads();
      if (grp == g) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((kw * NT + n) * 4 + e) * kGW * 32 + slot] = acc[kw][n][e];
      }
      __syncthreads();
      if (grp == 0) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[kw][n][e] += red[((kw * NT + n) * 4 + e) * kGW * 32 + slot];
      }
    }
  }
  if (grp != 0) return;
  // accumulator e of n8 tile n: ci row lane / 4 (+8 for e >= 2), co column
  // 2 (lane % 4) (+1 for odd e)
  float* out = part + static_cast<size_t>(strip) * 9 * cin * cout;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 16 * m + (lane >> 2) + (e >= 2 ? 8 : 0);
        const int co = 8 * n + 2 * (lane & 3) + (e & 1);
        if (ci < nc && co < nco)
          out[(static_cast<size_t>(kh * 3 + kw) * cin + c0 + ci) * cout +
              co0 + co] = acc[kw][n][e];
      }
}

// The bf16 weight gradient: pass 1 into `part` (f32, B * ceil(H /
// strip_rows) * 9 * Cin * Cout; strip_rows a multiple of wg::kTH), then the
// fixed-order reduce into dw [3, 3, Cin, Cout] f32. Two launches.
// Shared memory of wgrad_mma_kernel<MC, NT>: the z and ge tiles, reused
// for the K groups' sum after the K loop.
__host__ __device__ constexpr int wgrad_mma_smem(int mc, int nt) {
  return (wg::kZPix * 2 * mc + wg::kGPix * nt) * 16 >
                 3 * nt * 4 * 3 * mc * 32 * 4
             ? (wg::kZPix * 2 * mc + wg::kGPix * nt) * 16
             : 3 * nt * 4 * 3 * mc * 32 * 4;
}

template <int MC, int NT, typename In, typename G>
cudaError_t wgrad_mma_launch(const In& in, const G& gl, float* part,
                             int cin, int cout, int h, int wd,
                             int strip_rows, int strips,
                             int strips_per_image, cudaStream_t stream) {
  constexpr int kSmem = wgrad_mma_smem(MC, NT);
  // above 48 KB only after opting in, once per kernel
  static const cudaError_t opt = cudaFuncSetAttribute(
      wgrad_mma_kernel<MC, NT, In, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt != cudaSuccess) return opt;
  const dim3 grid(strips, (cin + 16 * MC - 1) / (16 * MC),
                  (cout + 8 * NT - 1) / (8 * NT));
  wgrad_mma_kernel<MC, NT, In, G><<<grid, wg::kThreads, kSmem, stream>>>(
      in, gl, part, cin, cout, h, wd, strip_rows, strips_per_image);
  return cudaGetLastError();
}

// NT n8 tiles of output channels a block: 8, 16 or 32 channels
template <int MC, typename In, typename G>
cudaError_t wgrad_mma_nt(const In& in, const G& gl, float* part, int cin,
                         int cout, int h, int wd, int strip_rows, int strips,
                         int spi, cudaStream_t stream) {
  if (cout <= 8)
    return wgrad_mma_launch<MC, 1>(in, gl, part, cin, cout, h, wd,
                                   strip_rows, strips, spi, stream);
  if (cout <= 16)
    return wgrad_mma_launch<MC, 2>(in, gl, part, cin, cout, h, wd,
                                   strip_rows, strips, spi, stream);
  return wgrad_mma_launch<MC, 4>(in, gl, part, cin, cout, h, wd, strip_rows,
                                 strips, spi, stream);
}

template <typename In, typename G>
cudaError_t launch_wgrad_mma(const In& in, const G& gl, float* part,
                             float* dw, int batch, int cin, int cout, int h,
                             int wd, int strip_rows, cudaStream_t stream) {
  const int spi = (h + strip_rows - 1) / strip_rows;
  const int strips = batch * spi;
  // MC 16-channel input chunks a block: more input channels a block stage
  // ge fewer times and need fewer K groups (on an H100 up3.0's chain
  // backward, whose fold loads g and y for every ge value, ran faster with
  // MC = 4 than with MC = 2)
  cudaError_t err;
  if (cin <= 16)
    err = wgrad_mma_nt<1>(in, gl, part, cin, cout, h, wd, strip_rows, strips,
                          spi, stream);
  else if (cin <= 32)
    err = wgrad_mma_nt<2>(in, gl, part, cin, cout, h, wd, strip_rows, strips,
                          spi, stream);
  else
    err = wgrad_mma_nt<4>(in, gl, part, cin, cout, h, wd, strip_rows, strips,
                          spi, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, dw, strips, 9 * cin * cout, stream);
}

// A strip height the bf16 pass takes: a positive multiple of its tile rows.
inline bool mma_strip_ok(int strip_rows) {
  return strip_rows >= wg::kTH && strip_rows % wg::kTH == 0;
}

// ------------------------------------------------------- the conv MMA tile
namespace dg {
constexpr int kTH = 8;                 // output rows: one a warp
constexpr int kTW = 32;                // output columns: two m16 tiles
constexpr int kSW = kTW + 2;           // input tile columns with halo
constexpr int kSPix = (kTH + 2) * kSW;   // 340
constexpr int kKC = 32;                // input channels (K) staged at once
constexpr int kCH = kKC / 8;           // chunks a staged pixel
constexpr int kThreads = 32 * kTH;
constexpr int kOutStride = kTH * kTW + 8;  // epilogue plane, elements
}  // namespace dg

// Shared memory of conv_mma_tile for NB n8 tiles (and of its epilogue).
__host__ __device__ constexpr int mma_tile_smem(int nb) {
  return (dg::kSPix + 9 * 8 * nb) * dg::kCH * 16 >
                 8 * nb * dg::kOutStride * 2
             ? (dg::kSPix + 9 * 8 * nb) * dg::kCH * 16
             : 8 * nb * dg::kOutStride * 2;
}

// Where a block of conv_mma_tile sits: image b, output channels [n0, n0 +
// 8 NB), rows [y0, y0 + kTH) and columns [x0, x0 + kTW); blockIdx.z = image
// * groups + channel group.
struct MmaTile {
  int b, n0, y0, x0;
};

template <int NB>
__device__ __forceinline__ MmaTile mma_tile_of_block(int groups) {
  return MmaTile{static_cast<int>(blockIdx.z) / groups,
                 static_cast<int>(blockIdx.z % groups) * 8 * NB,
                 static_cast<int>(blockIdx.y) * dg::kTH,
                 static_cast<int>(blockIdx.x) * dg::kTW};
}

// acc[hh][n][e] = the sum over input channels k < kin and the 9 taps (kh,
// kw) of in[b, k, y + kh - 1, x + kw - 1] * W(tap, k, n0 + n'), for the
// warp's output row y = y0 + warp and its two m16 tiles (columns x0 + 16 hh
// + 0..15): a GEMM with M = pixels, N = output channels (NB n8 tiles), K =
// (tap, input channel). The input tile (kKC channels and the 1-pixel halo)
// and the weights sit in shared memory, staged per kKC input channels;
// `stage_w(ws, k0, nk)` writes the weights of input channels [k0, k0 + nk)
// as units [9 * 8 NB][kCH] (row tap * 8 NB + n, chunk c: the 8 weights of
// input channels k0 + 8c .. 8c + 7, swizzled with unit<kCH>). Per (tap,
// k16) step a warp loads 2 A fragments (ldmatrix of the pixel-major input
// tile) and NB / 2 x4 B fragments, for 2 NB products.
template <int NB, typename In, typename StageW>
__device__ __forceinline__ void conv_mma_tile(float (&acc)[2][NB][4],
                                              unsigned char* smem,
                                              const MmaTile& t, const In& in,
                                              const StageW& stage_w, int kin,
                                              int h, int wd) {
  static_assert(NB % 2 == 0, "NB: n8 tiles in pairs");
  uint4* xs = reinterpret_cast<uint4*>(smem);
  uint4* ws = xs + dg::kSPix * dg::kCH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][n][e] = 0.f;
  for (int k0 = 0; k0 < kin; k0 += dg::kKC) {
    const int nk = min(dg::kKC, kin - k0);
    const int kc = (nk + 15) / 16;   // k16 steps a tap
    const auto rd = in.at(t.b, k0);
    __syncthreads();  // the previous chunk is consumed by every warp
    stage<dg::kCH, dg::kSPix, dg::kThreads>(
        xs, rd, 2 * kc, nk, [&](int p, int& gy, int& gx) {
          gy = t.y0 - 1 + p / dg::kSW;
          gx = t.x0 - 1 + p % dg::kSW;
          return gy >= 0 && gy < h && gx >= 0 && gx < wd;
        });
    stage_w(ws, k0, nk);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      for (int kk = 0; kk < kc; ++kk) {
        uint32_t bf[NB][2];
#pragma unroll
        for (int q = 0; q < NB / 2; ++q) {
          uint32_t t4[4];
          const int row = tap * 8 * NB + 8 * (2 * q + (mi >> 1)) + (lane & 7);
          ldsm_x4(t4, smem_addr(ws + unit<dg::kCH>(row, 2 * kk + (mi & 1))));
          bf[2 * q][0] = t4[0];
          bf[2 * q][1] = t4[1];
          bf[2 * q + 1][0] = t4[2];
          bf[2 * q + 1][1] = t4[3];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t a[4];
          const int p = (warp + kh) * dg::kSW + 16 * hh + kw + (mi & 1) * 8 +
                        (lane & 7);
          ldsm_x4(a, smem_addr(xs + unit<dg::kCH>(p, 2 * kk + (mi >> 1))));
#pragma unroll
          for (int n = 0; n < NB; ++n)
            mma16816(acc[hh][n], a, bf[n][0], bf[n][1]);
        }
      }
    }
  }
}

// y[b, n0 + n, y, x] = acc rounded to bf16 (round to nearest even, as
// store_tile) for the tile's in-image pixels and the channels below nout (y
// contiguous [B, nout, H, W]): through a [8 NB][kTH][kTW] bf16 tile in
// shared memory, then 16-byte stores of 8 pixels where W % 8 == 0.
template <int NB>
__device__ __forceinline__ void store_mma_tile(__nv_bfloat16* __restrict__ y,
                                               const float (&acc)[2][NB][4],
                                               unsigned char* smem,
                                               const MmaTile& t, int nout,
                                               int h, int wd) {
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the operand tiles are consumed
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int px = 16 * hh + (lane >> 2) + (e >= 2 ? 8 : 0);
        const int ch = 8 * n + 2 * (lane & 3) + (e & 1);
        os[ch * dg::kOutStride + warp * dg::kTW + px] =
            __float2bfloat16(acc[hh][n][e]);
      }
  __syncthreads();
  const size_t plane = static_cast<size_t>(h) * wd;
  const bool vec = (wd % 8) == 0;
  for (int i = threadIdx.x; i < 8 * NB * dg::kTH * (dg::kTW / 8);
       i += dg::kThreads) {
    const int ch = i / (dg::kTH * (dg::kTW / 8));
    const int r = (i / (dg::kTW / 8)) % dg::kTH;
    const int c8 = 8 * (i % (dg::kTW / 8));
    const int gy = t.y0 + r;
    const int gx = t.x0 + c8;
    if (t.n0 + ch >= nout || gy >= h || gx >= wd) continue;
    __nv_bfloat16* dst = y + (static_cast<size_t>(t.b) * nout + t.n0 + ch) *
                                 plane +
                         static_cast<size_t>(gy) * wd + gx;
    const __nv_bfloat16* src = os + ch * dg::kOutStride + r * dg::kTW + c8;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && gx + j < wd; ++j) dst[j] = src[j];
    }
  }
}

// The rotated weight of the input gradient as conv_mma_tile stages it: W(tap,
// k = co, n = ci) = w9[8 - tap, ci, co] (w9 the forward's [9, cin, cout]),
// whose rows [ci][co] are already the B fragment's [n][k]; 16-byte loads
// where cout % 8 == 0.
template <int NB>
struct RotWeights {
  const __nv_bfloat16* w9;
  int cin, cout, n0;
  __device__ __forceinline__ void operator()(uint4* ws, int k0,
                                             int nk) const {
    const int nchunk = 2 * ((nk + 15) / 16);
    const bool vec =
        (cout % 8) == 0 && (reinterpret_cast<uintptr_t>(w9) & 15) == 0;
    for (int i = threadIdx.x; i < 9 * 8 * NB * nchunk; i += dg::kThreads) {
      const int c = i / (9 * 8 * NB);
      const int row = i % (9 * 8 * NB);
      const int tap = row / (8 * NB);
      const int ci = n0 + row % (8 * NB);
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (ci < cin) {
        const __nv_bfloat16* src =
            w9 + (static_cast<size_t>(8 - tap) * cin + ci) * cout + k0 + 8 * c;
        if (vec && 8 * c + 8 <= nk) {
          u = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          for (int j = 0; j < 8 && 8 * c + j < nk; ++j)
            v[j / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(src[j]))
                        << (16 * (j & 1));
          u = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      ws[unit<dg::kCH>(row, c)] = u;
    }
  }
};

// dz = conv3x3(ge, w rotated) in bf16 (block_conv.cu's dgrad without the
// prologue): ge's cout channels are the tile's K, the forward's cin its N.
template <int NB, typename G>
__global__ void __launch_bounds__(dg::kThreads, 2)
    dgrad_mma_kernel(G ge, const __nv_bfloat16* __restrict__ w9,
                     __nv_bfloat16* __restrict__ dx, int cin, int cout, int h,
                     int wd, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaTile t = mma_tile_of_block<NB>(groups);
  float acc[2][NB][4];
  conv_mma_tile<NB>(acc, smem, t, ge, RotWeights<NB>{w9, cin, cout, t.n0},
                    cout, h, wd);
  store_mma_tile<NB>(dx, acc, smem, t, cin, h, wd);
}

template <int NB, typename G>
cudaError_t dgrad_mma_launch(const G& ge, const __nv_bfloat16* w9,
                             __nv_bfloat16* dx, int batch, int cin, int cout,
                             int h, int wd, cudaStream_t stream) {
  constexpr int kSmem = mma_tile_smem(NB);
  // above 48 KB only after opting in, once per kernel
  static const cudaError_t opt = cudaFuncSetAttribute(
      dgrad_mma_kernel<NB, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (opt != cudaSuccess) return opt;
  const int groups = (cin + 8 * NB - 1) / (8 * NB);
  const dim3 grid((wd + dg::kTW - 1) / dg::kTW, (h + dg::kTH - 1) / dg::kTH,
                  batch * groups);
  dgrad_mma_kernel<NB, G><<<grid, dg::kThreads, kSmem, stream>>>(
      ge, w9, dx, cin, cout, h, wd, groups);
  return cudaGetLastError();
}

// NB n8 tiles of the forward's input channels a block: 16, 32 or 64 (at
// up3.0 one block of 64 channels ran faster on an H100 than two of 32,
// each of which re-stages ge)
template <typename G>
cudaError_t launch_dgrad_mma(const G& ge, const __nv_bfloat16* w9,
                             __nv_bfloat16* dx, int batch, int cin, int cout,
                             int h, int wd, cudaStream_t stream) {
  if (cin <= 16)
    return dgrad_mma_launch<2>(ge, w9, dx, batch, cin, cout, h, wd, stream);
  if (cin <= 32)
    return dgrad_mma_launch<4>(ge, w9, dx, batch, cin, cout, h, wd, stream);
  return dgrad_mma_launch<8>(ge, w9, dx, batch, cin, cout, h, wd, stream);
}

}  // namespace tc

// The weight gradient of element type T through the loaders in and gl,
// routed by dtype: bf16 on the tensor cores, f32 on the CUDA cores (every
// source's wgrad entry comes here).
template <typename T, typename In, typename G>
cudaError_t launch_wgrad_dtype(const In& in, const G& gl, float* part,
                               float* dw, int batch, int cin, int cout,
                               int h, int wd, int strip_rows,
                               cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return tc::launch_wgrad_mma(in, gl, part, dw, batch, cin, cout, h, wd,
                                strip_rows, stream);
  else
    return ::uaps::conv::launch_wgrad(in, gl, part, dw, batch, cin, cout, h,
                                      wd, stream);
}

// The weight gradient's shape limits on both routes, and its strip height:
// wgrad::kStripRows for f32, a positive multiple of tc::wg::kTH for bf16.
inline bool wgrad_shape_ok(int batch, int cin, int cout, int h, int wd,
                           int strip_rows, int dtype) {
  if (batch < 1 || cin < 1 || cout < 1 || h < 1 || wd < 1 ||
      !index_fits(batch, cin > cout ? cin : cout, h, wd) ||
      (cin + wgrad::kCK - 1) / wgrad::kCK > 65535 || (cout + 31) / 32 > 65535)
    return false;
  if (dtype == kF32) return strip_rows == wgrad::kStripRows;
  return dtype == kBF16 && tc::mma_strip_ok(strip_rows);
}

}  // namespace conv
}  // namespace uaps
