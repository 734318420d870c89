// Tensor-core (mma.sync bf16 -> f32) building blocks of the port's bf16 3x3
// SAME stride-1 convolutions, for Hopper (sm_90a):
//
//   wgrad_mma_kernel     the weight gradient's first pass, per-strip partial
//                        sums of dW (launch_wgrad_mma, then
//                        conv3x3_tile.cuh's fixed-order reduce_kernel);
//   conv_mma_tile        an 8 x 32 output tile of a 3x3 conv for up to 64
//                        output channels, which runs as
//     dgrad_mma_kernel     the chain plain conv's input gradient (the conv
//                          of the folded cotangent with the rotated weight),
//     conv_fwd_mma_kernel  conv3x3_nchw.cu's forward (bf16 -> bf16 or f32)
//                          and, through a rotated weight view, its dgrad,
//     block_conv.cu's block_fwd_mma_kernel, the fused-block forward (BN
//                          prologue and output moments on or off), and
//                          bnl_bwd_mma_kernel, the fused-block dgrad with
//                          the BN prologue's backward as its epilogue,
//     conv3x3_nhwc.cu's nhwc_fwd_mma_kernel, the NHWC forward and, through
//                          a flipped weight view, its dgrad (NhwcLoad,
//                          staged 16 bytes a cp.async by stage_tile_nhwc).
//
// Replaces, for bf16 inputs, uaps_tpu/pallas/conv3x3_nchw.py:601
// conv3x3_nchw_wgrad (its pallas_call at :692), the dgrad of
// uaps_tpu/pallas/block_conv.py:345 _chain_bwd_call (its pallas_call at
// :368; with the prologue through block_conv.cu), conv3x3_nchw.py:289 conv3x3_nchw (:425;
// :752 -> :763 for fullh, and the VJPs' dgrads :932, :987) and
// uaps_tpu/pallas/conv3x3.py:73 conv3x3_forward (:90; the dgrad of the VJP
// conv3x3_small :174). The TPU kernels
// compute every tap as a dot_general on the MXU; these compute every tap as
// m16n8k16 products on the tensor cores. f32 inputs keep the CUDA-core
// kernels of conv3x3_tile.cuh (conv_tile, wgrad_partial_kernel): tensor
// cores would only give TF32 there. The entry points (NCHW and NHWC) route
// by dtype alone.
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
// for ge and dz), and the forward's (0.01 ms, 0.0125 ms for x and y). What
// the design does about it: each block reads its operand tiles once into
// shared memory (the 1-pixel halo is the only re-read: (4+2)/4 x (64+2)/64
// = 1.55x for the wgrad's z, (8+2)/8 x (32+2)/32 = 1.33x for the conv
// tile's input), every staged value feeds 3 taps x up to 32 output
// channels (wgrad) or 9 taps x up to 64 (the conv tile) from shared
// memory, and the staging loads of many warps and blocks are in flight at
// once (two blocks an SM). A bf16 PlainLoad or FoldLoad input (block_conv.cu:
// the folded cotangent of the fused-block dgrads) whose W is a multiple of
// 4 is staged 8 bytes (4 pixels of one channel) a load, g's and y's for the
// fold, and transposed in registers (stage_tile_vec); a bf16 NhwcLoad
// input whose C is a multiple of 8 is already channel-minor, and each
// 16-byte unit is one cp.async (stage_tile_nhwc); the prologue's ProLoad
// transforms and hashes each value and is read one value a load, as are
// the wgrad's operands. The wgrad's strip height (chosen by
// the Python wrappers' wgrad_strips: the tallest of 16, 8, 4 rows that
// still gives 256 blocks, two an SM) trades blocks in flight against the
// partials' traffic (9 * Cin * Cout f32 a strip) and each block's fixed
// cost (its K-group sum and its partial's store). The conv tile stages its
// weights per block and 32-channel K chunk: 16 bytes a load where the
// output channels have unit stride (block_conv.cu's [9, cin, cout]), else
// one value a load (the model's permuted OIHW view and its rotation, which
// conv3x3_nchw.cu reads in place).
//
// Wasted products by padding, at the main-path shapes: the wgrad pads Cin
// to 16 a warp chunk (in_conv.0's Cin = 3: 13/16 = 81% of its products;
// none at Cin 16, 32, 64) and Cout to an n8 tile (out_conv's Cout = 4: 50%;
// none at 16 and 32); a W that is no multiple of 16 pads the last K step
// (none on the main path). The conv tile pads its K to 16 (the forward's
// in_conv.0, Cin 3: 81%; none at 16, 32, 64) and its N to the block's 16,
// 32 or 64 channels (the head's Cout 4: 75%; none at 16, 32, 64), and a W
// or H that is no multiple of 32 or 8 masks the last tile's pixels (none
// on the main path).
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

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
// (src must still be a valid global address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

// every cp.async of this thread has landed in shared memory
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Shared memory of conv_mma_tile for NB n8 tiles and of its epilogue,
// whose output plane holds out_bytes-byte elements (2: bf16, 4: f32).
__host__ __device__ constexpr int mma_tile_smem(int nb, int out_bytes = 2) {
  return (dg::kSPix + 9 * 8 * nb) * dg::kCH * 16 >
                 8 * nb * dg::kOutStride * out_bytes
             ? (dg::kSPix + 9 * 8 * nb) * dg::kCH * 16
             : 8 * nb * dg::kOutStride * out_bytes;
}

// The tiles of one image plane: the per-channel partials' row count of a
// conv_mma_tile kernel is batch times this.
inline int mma_tiles_per_image(int h, int wd) {
  return ((h + dg::kTH - 1) / dg::kTH) * ((wd + dg::kTW - 1) / dg::kTW);
}

// The grid of a conv_mma_tile kernel writing nout channels in groups of
// 8 NB: (column tiles, row tiles, image * groups).
template <int NB>
inline dim3 mma_grid(int batch, int nout, int h, int wd) {
  return dim3((wd + dg::kTW - 1) / dg::kTW, (h + dg::kTH - 1) / dg::kTH,
              batch * ((nout + 8 * NB - 1) / (8 * NB)));
}

// The channel groups of the forwards' tensor-core grid (launch_conv_fwd_mma
// and the NHWC forward take NB = 2, 4 or 8 by nout): one up to 32 output
// channels, else groups of 64.
inline int mma_fwd_groups(int nout) {
  return nout <= 32 ? 1 : (nout + 63) / 64;
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

// Pixels of one channel that stage_tile_vec reads with one load (8
// bytes). On an H100 4 pixels staged the plain forwards faster than 8 (16
// bytes, whose 32 registers of loaded values cost the NB = 2 tiles a
// block an SM) and than one value a load (PERF.md, section 6).
constexpr int kVecPx = 4;

// Whether the loader In reads 4 bf16 pixels of one channel at a time: a
// static kVec4 (PlainLoad, block_conv.cu's FoldLoad) that is true, then
// In::vec4_ok() for this call's pointers and W and At::vec4(ch, gy, gx),
// the 4 values (rounded to bf16 as operator() rounds them) as two words.
template <typename In, typename = void>
struct HasVec4 : std::false_type {};
template <typename In>
struct HasVec4<In, std::void_t<decltype(In::kVec4)>>
    : std::integral_constant<bool, In::kVec4> {};

// The input tile of conv_mma_tile (kTH + 2 rows of kSW pixels, nchunk
// 8-channel chunks of the nk channels at rd) from a bf16 NCHW loader whose
// vec4 read applies (W a multiple of kVecPx, so every kVecPx-pixel group
// of a row is 8-byte aligned and lies wholly inside or outside the
// image): each interior group of a row is read as one vec4 per channel,
// and 8 channels are transposed in registers into the group's 4 16-byte
// units; the two halo columns are read one value a load. Consecutive
// threads take consecutive rows of a group, which spreads the units of a
// quarter warp's store over the swizzle's bank groups.
template <typename Rd>
__device__ __forceinline__ void stage_tile_vec(uint4* xs, const Rd& rd,
                                               int nchunk, int nk,
                                               const MmaTile& t, int h,
                                               int wd) {
  constexpr int kRows = dg::kTH + 2;
  constexpr int kGroups = dg::kTW / kVecPx;
  const int nvec = nchunk * kRows * kGroups;
  const int nall = nvec + nchunk * kRows * 2;
#pragma unroll 1
  for (int i = threadIdx.x; i < nall; i += dg::kThreads) {
    if (i < nvec) {
      const int r = i % kRows;
      const int q = (i / kRows) % kGroups;
      const int c = i / (kRows * kGroups);
      const int gy = t.y0 - 1 + r;
      const int gx = t.x0 + kVecPx * q;
      const bool in = gy >= 0 && gy < h && gx < wd;
      uint2 v[8];   // [channel]: pixels 0-1, 2-3
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = make_uint2(0u, 0u);
        if (in && 8 * c + j < nk) v[j] = rd.vec4(8 * c + j, gy, gx);
      }
#pragma unroll
      for (int px = 0; px < kVecPx; ++px) {
        // channels 2w (low half) and 2w + 1 of pixel px
        const uint32_t sel = (px & 1) ? 0x7632u : 0x5410u;
        const auto word = [&](int j) { return px < 2 ? v[j].x : v[j].y; };
        xs[unit<dg::kCH>(r * dg::kSW + 1 + kVecPx * q + px, c)] =
            make_uint4(__byte_perm(word(0), word(1), sel),
                       __byte_perm(word(2), word(3), sel),
                       __byte_perm(word(4), word(5), sel),
                       __byte_perm(word(6), word(7), sel));
      }
    } else {
      const int k = i - nvec;
      const int side = k & 1;
      const int r = (k / 2) % kRows;
      const int c = k / (2 * kRows);
      const int gy = t.y0 - 1 + r;
      const int gx = side ? t.x0 + dg::kTW : t.x0 - 1;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = in && 8 * c + j < nk ? rd(8 * c + j, gy, gx) : 0.f;
      xs[unit<dg::kCH>(r * dg::kSW + (side ? dg::kSW - 1 : 0), c)] =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    }
  }
}

// The input tile of conv_mma_tile from a bf16 NHWC tensor whose channel
// count is a multiple of 8 and whose base is 16-byte aligned: unit (p, c)
// is channels 8c .. 8c + 7 of one pixel, 16 contiguous bytes of x, copied
// as they are by cp.async into their swizzled slot (no transpose); the halo
// and the chunks past nk are zero-filled by the copy (source size 0).
// Consecutive threads take consecutive chunks of a pixel, then consecutive
// pixels, so a warp reads whole pixels of one tile row, contiguous in x
// where the staged chunks are all of its channels. nchunk is 2 or 4. The
// caller waits (cp_async_wait_all) before the barrier that publishes the
// tile.
__device__ __forceinline__ void stage_tile_nhwc(
    uint4* xs, const NhwcLoad<__nv_bfloat16>::At& rd, int nchunk, int nk,
    const MmaTile& t, int h, int wd) {
  const int shift = nchunk == 4 ? 2 : 1;
#pragma unroll 1
  for (int i = threadIdx.x; i < dg::kSPix * nchunk; i += dg::kThreads) {
    const int c = i & (nchunk - 1);
    const int p = i >> shift;
    const int gy = t.y0 - 1 + p / dg::kSW;
    const int gx = t.x0 - 1 + p % dg::kSW;
    const bool in =
        gy >= 0 && gy < h && gx >= 0 && gx < wd && 8 * c < nk;
    const __nv_bfloat16* src =
        in ? rd.p + static_cast<size_t>(gy * wd + gx) * rd.c + 8 * c : rd.p;
    cp_async16(smem_addr(xs + unit<dg::kCH>(p, c)), src, in ? 16 : 0);
  }
}

// acc[hh][n][e] = the sum over input channels k < kin and the 9 taps (kh,
// kw) of in[b, k, y + kh - 1, x + kw - 1] * W(tap, k, n0 + n'), for the
// warp's output row y = y0 + warp and its two m16 tiles (columns x0 + 16 hh
// + 0..15): a GEMM with M = pixels, N = output channels (NB n8 tiles), K =
// (tap, input channel). The input tile (kKC channels and the 1-pixel halo)
// and the weights sit in shared memory, staged per kKC input channels;
// `stage_w(ws, k0, nk)` writes the weights of input channels [k0, k0 + nk)
// in one of two layouts, as StageW::kKMajor says: n-major, units [9 * 8
// NB][kCH] (row tap * 8 NB + n, chunk c: the 8 weights of input channels
// k0 + 8c .. 8c + 7), read with ldmatrix; or k-major, units [9 * kKC][NB]
// (row tap * kKC + k, chunk c: the 8 weights of output channels n0 + 8c ..
// 8c + 7), read with ldmatrix.trans; both swizzled with unit<>. Per (tap,
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
  constexpr bool kVec = HasVec4<In>::value;
  constexpr bool kNhwc = std::is_same<In, NhwcLoad<__nv_bfloat16>>::value;
  static_assert(kVecPx == 4, "the loaders' vec4 reads 4 pixels");
  bool vec = false;
  if constexpr (kVec) vec = in.vec4_ok();
  if constexpr (kNhwc)
    vec = (in.c % 8) == 0 && (reinterpret_cast<uintptr_t>(in.x) & 15) == 0;
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
    if (vec) {
      if constexpr (kVec) stage_tile_vec(xs, rd, 2 * kc, nk, t, h, wd);
      if constexpr (kNhwc) stage_tile_nhwc(xs, rd, 2 * kc, nk, t, h, wd);
    } else {
      stage<dg::kCH, dg::kSPix, dg::kThreads>(
          xs, rd, 2 * kc, nk, [&](int p, int& gy, int& gx) {
            gy = t.y0 - 1 + p / dg::kSW;
            gx = t.x0 - 1 + p % dg::kSW;
            return gy >= 0 && gy < h && gx >= 0 && gx < wd;
          });
    }
    stage_w(ws, k0, nk);
    if constexpr (kNhwc) cp_async_wait_all();   // the copies overlap stage_w
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      for (int kk = 0; kk < kc; ++kk) {
        uint32_t bf[NB][2];
#pragma unroll
        for (int q = 0; q < NB / 2; ++q) {
          uint32_t t4[4];
          if constexpr (StageW::kKMajor) {
            const int row = tap * dg::kKC + 16 * kk + (mi & 1) * 8 +
                            (lane & 7);
            ldsm_x4_t(t4, smem_addr(ws + unit<NB>(row, 2 * q + (mi >> 1))));
          } else {
            const int row =
                tap * 8 * NB + 8 * (2 * q + (mi >> 1)) + (lane & 7);
            ldsm_x4(t4,
                    smem_addr(ws + unit<dg::kCH>(row, 2 * kk + (mi & 1))));
          }
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

// Accumulator e of n8 tile n of the warp's m16 tile hh: tile pixel
// (row warp, column 16 hh + lane / 4 (+8 for e >= 2)), channel 8 n + 2 (lane
// % 4) (+1 for odd e).
__device__ __forceinline__ int mma_px(int hh, int e, int lane) {
  return 16 * hh + (lane >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int mma_ch(int n, int e, int lane) {
  return 8 * n + 2 * (lane & 3) + (e & 1);
}

// The tile's accumulators rounded to Tout (bf16: round to nearest even, as
// store_tile; f32: as they are) in the output plane os (the operand tiles'
// shared memory, consumed): channel n0 + ch, tile row r, column x at
// ch * kOutStride + r * kTW + x. Every thread of the block calls it; the plane is complete
// when it returns.
template <int NB, typename Tout>
__device__ __forceinline__ void mma_tile_to_smem(Tout* os,
                                                 const float (&acc)[2][NB][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the operand tiles are consumed
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        os[mma_ch(n, e, lane) * dg::kOutStride + warp * dg::kTW +
           mma_px(hh, e, lane)] = from_f32<Tout>(acc[hh][n][e]);
  __syncthreads();
}

// y[b, n0 + n, y, x] = acc rounded to Tout for the tile's in-image pixels
// and the channels below nout (y contiguous [B, nout, H, W]): through a
// [8 NB][kTH][kTW] Tout tile in shared memory (mma_tile_to_smem), then
// 16-byte stores (8 bf16 or 4 f32 pixels) where W % 8 == 0.
template <int NB, typename Tout>
__device__ __forceinline__ void store_mma_tile(Tout* __restrict__ y,
                                               const float (&acc)[2][NB][4],
                                               unsigned char* smem,
                                               const MmaTile& t, int nout,
                                               int h, int wd) {
  Tout* os = reinterpret_cast<Tout*>(smem);
  mma_tile_to_smem<NB>(os, acc);
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
    Tout* dst = y + (static_cast<size_t>(t.b) * nout + t.n0 + ch) * plane +
                static_cast<size_t>(gy) * wd + gx;
    const Tout* src = os + ch * dg::kOutStride + r * dg::kTW + c8;
    if (vec) {
#pragma unroll
      for (int v = 0; v < static_cast<int>(8 * sizeof(Tout)) / 16; ++v)
        reinterpret_cast<uint4*>(dst)[v] =
            reinterpret_cast<const uint4*>(src)[v];
    } else {
      for (int j = 0; j < 8 && gx + j < wd; ++j) dst[j] = src[j];
    }
  }
}

// The block's per-channel moments of the f32 accumulator over its in-image
// pixels: part[n0 + n] = sum(acc), part[cout + n0 + n] = sum(acc^2) for the
// channels below cout (part: the block's [2, cout] slot). Each lane sums its
// fragment's pixels, a butterfly over the 8 lanes of one channel pair sums
// the warp's, and the 8 warps are added in order through shared memory
// (red: 2 * 8 NB * kTH floats; the operand tiles, consumed): a fixed order,
// no atomics.
template <int NB>
__device__ __forceinline__ void mma_tile_moments(
    const float (&acc)[2][NB][4], float* red, const MmaTile& t, int h,
    int wd, float* __restrict__ part, int cout) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool row_in = t.y0 + warp < h;
  __syncthreads();  // the operand tiles are consumed
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // [channel parity][s1, s2]
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row_in && t.x0 + mma_px(hh, e, lane) < wd) {
          const float v = acc[hh][n][e];
          s[e & 1][0] += v;
          s[e & 1][1] = fmaf(v, v, s[e & 1][1]);
        }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j >> 1][j & 1] +=
            __shfl_xor_sync(0xffffffffu, s[j >> 1][j & 1], off);
    if (lane < 4)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int ch = mma_ch(n, par, lane);
        red[(warp * 8 * NB + ch) * 2] = s[par][0];
        red[(warp * 8 * NB + ch) * 2 + 1] = s[par][1];
      }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < 8 * NB; ch += dg::kThreads) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int w = 0; w < dg::kTH; ++w) {
      s1 += red[(w * 8 * NB + ch) * 2];
      s2 += red[(w * 8 * NB + ch) * 2 + 1];
    }
    if (t.n0 + ch < cout) {
      part[t.n0 + ch] = s1;
      part[cout + t.n0 + ch] = s2;
    }
  }
}

// The weights of conv_mma_tile staged k-major (its kKMajor layout) from an
// HWIO view w with strides s (W(tap, k, n) = w at tap, input channel k,
// output channel n): unit (tap * kKC + k, chunk c) holds W(tap, k0 + k,
// n0 + 8c .. n0 + 8c + 7), zeros past kin's chunk and nout. One 16-byte
// load a unit where n has unit stride (a contiguous HWIO or [9, cin, cout]
// weight), else 8 loads of one value; consecutive threads take consecutive
// chunks, then consecutive k.
template <int NB>
struct KMajorWeights {
  static constexpr bool kKMajor = true;
  const __nv_bfloat16* w;
  WStrides s;
  int nout, n0;
  __device__ __forceinline__ void operator()(uint4* ws, int k0,
                                             int nk) const {
    const int rows = 16 * ((nk + 15) / 16);   // k rows a tap
    const bool vec = s.co == 1 && (nout % 8) == 0 && (s.ci % 8) == 0 &&
                     (s.kh % 8) == 0 && (s.kw % 8) == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    for (int i = threadIdx.x; i < 9 * rows * NB; i += dg::kThreads) {
      const int c = i % NB;
      const int tap = i / (NB * rows);
      const int k = (i / NB) % rows;
      const int n = n0 + 8 * c;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (k < nk && n < nout) {
        const __nv_bfloat16* src = w + (tap / 3) * s.kh + (tap % 3) * s.kw +
                                   (k0 + k) * s.ci + n * s.co;
        if (vec) {
          u = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t e[4] = {0u, 0u, 0u, 0u};
          for (int j = 0; j < 8 && n + j < nout; ++j)
            e[j / 2] |= static_cast<uint32_t>(
                            __bfloat16_as_ushort(__ldg(src + j * s.co)))
                        << (16 * (j & 1));
          u = make_uint4(e[0], e[1], e[2], e[3]);
        }
      }
      ws[unit<NB>(tap * dg::kKC + k, c)] = u;
    }
  }
};

// The rotated weight of the input gradient as conv_mma_tile stages it: W(tap,
// k = co, n = ci) = w9[8 - tap, ci, co] (w9 the forward's [9, cin, cout]),
// whose rows [ci][co] are already the B fragment's [n][k]; 16-byte loads
// where cout % 8 == 0.
template <int NB>
struct RotWeights {
  static constexpr bool kKMajor = false;
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
  const dim3 grid = mma_grid<NB>(batch, cin, h, wd);
  dgrad_mma_kernel<NB, G><<<grid, dg::kThreads, kSmem, stream>>>(
      ge, w9, dx, cin, cout, h, wd, static_cast<int>(grid.z) / batch);
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

// y = conv3x3(x, W) in bf16 with bf16 or f32 output (conv3x3_nchw.cu's
// forward and, through a rotated weight view, its dgrad): x's cin channels
// are the tile's K, W's cout its N.
template <int NB, typename Tout>
__global__ void __launch_bounds__(dg::kThreads, 2)
    conv_fwd_mma_kernel(PlainLoad<__nv_bfloat16> in,
                        const __nv_bfloat16* __restrict__ w, WStrides ws,
                        Tout* __restrict__ y, int cin, int cout, int h,
                        int wd, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaTile t = mma_tile_of_block<NB>(groups);
  float acc[2][NB][4];
  conv_mma_tile<NB>(acc, smem, t, in, KMajorWeights<NB>{w, ws, cout, t.n0},
                    cin, h, wd);
  store_mma_tile<NB>(y, acc, smem, t, cout, h, wd);
}

template <int NB, typename Tout>
cudaError_t conv_fwd_mma_launch(const __nv_bfloat16* x,
                                const __nv_bfloat16* w, WStrides ws,
                                Tout* y, int batch, int cin, int cout, int h,
                                int wd, cudaStream_t stream) {
  constexpr int kSmem = mma_tile_smem(NB, sizeof(Tout));
  // above 48 KB only after opting in, once per kernel
  static const cudaError_t opt = cudaFuncSetAttribute(
      conv_fwd_mma_kernel<NB, Tout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt != cudaSuccess) return opt;
  const dim3 grid = mma_grid<NB>(batch, cout, h, wd);
  conv_fwd_mma_kernel<NB, Tout><<<grid, dg::kThreads, kSmem, stream>>>(
      PlainLoad<__nv_bfloat16>{x, cin, h, wd}, w, ws, y, cin, cout, h, wd,
      static_cast<int>(grid.z) / batch);
  return cudaGetLastError();
}

// NB n8 tiles of output channels a block: 16, 32 or 64, in groups of 64
// above (a Cout of 4, the logits head, pads to 16: 75% of its products are
// zeros, as the tile is bound by its loads, not its products)
template <typename Tout>
cudaError_t launch_conv_fwd_mma(const __nv_bfloat16* x,
                                const __nv_bfloat16* w, WStrides ws,
                                Tout* y, int batch, int cin, int cout, int h,
                                int wd, cudaStream_t stream) {
  if (cout <= 16)
    return conv_fwd_mma_launch<2>(x, w, ws, y, batch, cin, cout, h, wd,
                                  stream);
  if (cout <= 32)
    return conv_fwd_mma_launch<4>(x, w, ws, y, batch, cin, cout, h, wd,
                                  stream);
  return conv_fwd_mma_launch<8>(x, w, ws, y, batch, cin, cout, h, wd,
                                stream);
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
