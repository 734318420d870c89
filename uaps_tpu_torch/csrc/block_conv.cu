// The fused ConvBlock convolutions, for Hopper (sm_90a): a 3x3 SAME stride-1
// NCHW conv that can apply BN-normalise + LeakyReLU + dropout to its input as
// it loads it (the prologue) and can emit the per-channel moments of its f32
// accumulator (the epilogue), with the matching backward.
//
// Replaces uaps_tpu/pallas/block_conv.py (_chain_fwd_call and
// _chain_bwd_call, the ConvBlock chain of conv_backend="chain":
// chain_conv_plain and chain_conv_bnl) and uaps_tpu/pallas/conv_bnl.py
// (_bnl_call_fwd and _bnl_vjp_bwd's dgrad and wgrad kernels, the second conv
// of conv_backend="fused"). Both compute, for x [B, Cin, H, W] (f32 or bf16),
// w [9, Cin, Cout] (tap-major HWIO, x's dtype) and f, s [Cin] f32:
//
//   prologue  z = x, or z = dropout(leaky(x * f + s)) cast to x's dtype;
//             leaky slope 0.01; dropout keeps an element where
//             hash(pos, seed) <= thr and scales it by `scale`, pos =
//             ((b * Cin + c) * H + y) * W + x mod 2^32 and hash the
//             murmur3-style avalanche of block_conv.py's _hash_u32, bit for
//             bit; the halo outside the image is zero of z (not leaky(s));
//   forward   y = conv3x3(z, w) in x's dtype (f32 accumulation), no bias;
//             with the moments on, s1 = sum(acc), s2 = sum(acc^2) per output
//             channel over (B, H, W), from the f32 accumulator;
//   backward  ge = g + ds1 + 2 y ds2 (the moment-cotangent fold, in f32,
//             cast to x's dtype; either ds may be absent), dz =
//             conv3x3(ge, w rotated), then without the prologue dx = dz, and
//             with it da = dz * keep * scale * leaky'(a) (a = x * f + s),
//             dx = da * f, df = sum(da * x), ds = sum(da); dW[t, ci, co] =
//             sum(z shifted by tap t * ge), z recomputed by the prologue.
// Every float operation of the prologue and its backward is an explicit
// round-to-nearest intrinsic (no fused multiply-add), so z, and the mask,
// equal those of the plain PyTorch versions in kernels/block_conv.py bit for
// bit; only the conv's summation order differs.
//
// The TPU kernels accumulate the moments, df/ds and dW in VMEM across a
// sequential grid, and run dgrad and wgrad in one pass per block. Blocks on
// Hopper run in no order, so each cross-block sum is written as per-block
// partials and added by conv3x3_tile.cuh's reduce_kernel in a fixed order
// (deterministic, no atomics), and dgrad and wgrad are two kernels that share
// the prologue code (a loader). Launches per call: forward 1 conv + 1 moment
// reduce (conv_bnl: 1); backward 1 dgrad (+ 1 df/ds reduce with the
// prologue; none for the first conv of a network, whose input needs no
// gradient) + 1 wgrad pass + 1 wgrad reduce.
//
// Routing (by dtype, in the entry points): in bf16 every forward (plain +
// moments, prologue + moments, prologue only: block_fwd_mma_kernel), the
// backward's wgrad pass (with or without the prologue), the dgrad without
// the prologue (chain_conv_plain's: dgrad_mma_kernel) and the dgrad with it
// (bnl_bwd_mma_kernel, below) run on the tensor cores (conv3x3_mma.cuh:
// conv_mma_tile, wgrad_mma_kernel; its note says what bounds them and how
// they answer it); every f32 kernel runs on the CUDA cores, as below.
//
// The bf16 dgrad with the prologue (bnl_bwd_mma_kernel) replaces the
// dgrad of uaps_tpu/pallas/block_conv.py:345 _chain_bwd_call (:368) with
// the prologue and of uaps_tpu/pallas/conv_bnl.py:196 _bnl_vjp_bwd (:211).
// Its bound is bytes: g, y (with ds2) and x read once, dx written once,
// 2 bytes an element each (~0.04 ms at 16 channels @ 256^2, B = 16),
// against ~0.01 ms of products at the bf16 peak. What the design does:
// the conv is conv_mma_tile's (the folded cotangent staged 4 pixels a
// load, the rotated weight as dgrad_mma_kernel stages it); the epilogue
// reads x once, 16 bytes a lane, and writes dx once, 16 bytes a lane, from
// the f32 accumulators parked in shared memory, and reduces df and ds per
// channel inside one warp, so the prologue's backward costs one pass over x
// and dx and no extra launch but the fixed-order reduce.
//
// What bounds the CUDA-core kernels: the conv is conv3x3_nchw.cu's tiling
// (conv3x3_tile.cuh: kTH x kTW output tile, Cin chunks of kCK channels in
// shared memory, f32 register accumulators), bound by FMA throughput; the
// prologue is a few operations per input element at load time, and the
// epilogue one warp butterfly per output channel, both small beside the
// 9 * Cout FMAs each input element feeds. What the design removes is memory
// traffic: the normalised, activated and dropped tensor z is never written,
// the moments cost no extra pass over y, and the backward's fold, mask and
// activation derivative happen where ge and x are loaded.

#include <stdint.h>

#include <type_traits>

#include "conv3x3_mma.cuh"
#include "conv3x3_tile.cuh"

namespace {

using uaps::from_f32;
using uaps::to_f32;
using uaps::conv::kPX;
using uaps::conv::kThreads;
using uaps::conv::kWarps;

constexpr float kNegSlope = 0.01f;

// block_conv.py _hash_u32 (wrapping int32 arithmetic = uint32 arithmetic)
__device__ __forceinline__ uint32_t hash_u32(uint32_t pos, uint32_t seed) {
  uint32_t h = (pos * 0x9e3779b9u) ^ seed;
  h ^= h >> 15;
  h *= 0x85ebca77u;
  h ^= h >> 13;
  h *= 0xc2b2ae3du;
  return h ^ (h >> 16);
}

// The BN-normalise + LeakyReLU + dropout prologue of input channel c.
struct Prologue {
  const float* __restrict__ f;
  const float* __restrict__ s;
  const long long* __restrict__ seed;  // the low 32 bits are the int32 seed
  uint32_t thr;
  float scale;
  int drop;
  int c, h, wd;  // x's channels and spatial size (for the hash position)

  __device__ __forceinline__ float pre(float v, int ch) const {
    return __fadd_rn(__fmul_rn(v, f[ch]), s[ch]);
  }
  __device__ __forceinline__ bool keep(int b, int ch, int gy, int gx) const {
    const uint32_t pos =
        ((static_cast<uint32_t>(b) * c + ch) * h + gy) * wd + gx;
    return hash_u32(pos, static_cast<uint32_t>(__ldg(seed))) <= thr;
  }
  // z before the cast to x's dtype
  __device__ __forceinline__ float z(float v, int b, int ch, int gy,
                                     int gx) const {
    const float a = pre(v, ch);
    float zz = a >= 0.f ? a : __fmul_rn(a, kNegSlope);
    if (drop) zz = keep(b, ch, gy, gx) ? __fmul_rn(zz, scale) : 0.f;
    return zz;
  }
};

// z of x[b, c0 + ch, gy, gx], rounded to T as the conv consumes it.
template <typename T>
struct ProLoad {
  const T* x;
  Prologue pro;
  struct At {
    const T* p;   // channel c0 of image b
    size_t plane;
    Prologue pro;
    int b, c0;
    __device__ __forceinline__ float operator()(int ch, int gy,
                                                int gx) const {
      const float v = to_f32(__ldg(p + ch * plane + (gy * pro.wd + gx)));
      return to_f32(from_f32<T>(pro.z(v, b, c0 + ch, gy, gx)));
    }
  };
  __device__ __forceinline__ At at(int b, int c0) const {
    const size_t plane = static_cast<size_t>(pro.h) * pro.wd;
    return At{x + static_cast<size_t>(b * pro.c + c0) * plane, plane, pro, b,
              c0};
  }
};

// ge = g + ds1[c] + (2 y) ds2[c] in f32, rounded to T (either ds may be
// null). In bf16 (kVec4) the tensor-core tile reads 4 pixels of g (and of y)
// a load where W % 4 == 0 and g and y are 8-byte aligned (vec4_ok), folds
// each value in f32 and rounds it once, as operator() does.
template <typename T>
struct FoldLoad {
  static constexpr bool kVec4 = std::is_same<T, __nv_bfloat16>::value;
  const T* g;
  const T* y;
  const float* __restrict__ ds1;
  const float* __restrict__ ds2;
  int c, h, wd;
  struct At {
    const T* g;   // channel c0 of image b
    const T* y;   // likewise, or null
    const float* ds1;
    const float* ds2;
    size_t plane;
    int wd, c0;
    __device__ __forceinline__ float operator()(int ch, int gy,
                                                int gx) const {
      const size_t i = ch * plane + (gy * wd + gx);
      float v = to_f32(__ldg(g + i));
      if (ds1 == nullptr && ds2 == nullptr) return v;
      if (ds1 != nullptr) v = __fadd_rn(v, ds1[c0 + ch]);
      if (ds2 != nullptr)
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(2.f, to_f32(__ldg(y + i))),
                                   ds2[c0 + ch]));
      return to_f32(from_f32<T>(v));
    }
    // pixels gx .. gx + 3 (bf16): the words of g, or of the folded values
    __device__ __forceinline__ uint2 vec4(int ch, int gy, int gx) const {
      const size_t i = ch * plane + (gy * wd + gx);
      const uint2 gv = __ldg(reinterpret_cast<const uint2*>(g + i));
      if (ds1 == nullptr && ds2 == nullptr) return gv;
      const uint2 yv = ds2 == nullptr
                           ? make_uint2(0u, 0u)
                           : __ldg(reinterpret_cast<const uint2*>(y + i));
      const uint32_t gw[2] = {gv.x, gv.y};
      const uint32_t yw[2] = {yv.x, yv.y};
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // a word holds pixels 2w (low half) and 2w + 1
        const auto half = [k](uint32_t w) {
          return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
        };
        v[k] = half(gw[k >> 1]);
        if (ds1 != nullptr) v[k] = __fadd_rn(v[k], ds1[c0 + ch]);
        if (ds2 != nullptr)
          v[k] = __fadd_rn(v[k], __fmul_rn(__fmul_rn(2.f, half(yw[k >> 1])),
                                           ds2[c0 + ch]));
      }
      return make_uint2(uaps::conv::tc::pack_bf16(v[0], v[1]),
                        uaps::conv::tc::pack_bf16(v[2], v[3]));
    }
  };
  __device__ __forceinline__ At at(int b, int c0) const {
    const size_t plane = static_cast<size_t>(h) * wd;
    const size_t base = static_cast<size_t>(b * c + c0) * plane;
    return At{g + base, y == nullptr ? nullptr : y + base, ds1, ds2, plane,
              wd, c0};
  }
  __device__ __forceinline__ bool vec4_ok() const {
    return (wd % 4) == 0 && (reinterpret_cast<uintptr_t>(g) & 7) == 0 &&
           (reinterpret_cast<uintptr_t>(y) & 7) == 0;
  }
};

// Index of the block's (image, tile row, tile column) among all of them: the
// slot of its per-channel partial sums.
__device__ __forceinline__ size_t partial_slot(int b) {
  return (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * gridDim.x +
         blockIdx.x;
}

template <typename T>
struct FwdArgs {
  const T* x;
  const T* w9;   // [9, cin, cout]
  Prologue pro;
  T* y;
  float* part;   // [blocks, 2, cout] moment partials
  int cin, cout, h, wd, groups;
};

// The f32 forward (bf16 takes block_fwd_mma_kernel below). PRO: the
// prologue on the input; MOM: the moments epilogue.
template <bool PRO, bool MOM, int COP>
__global__ void __launch_bounds__(kThreads, uaps::conv::min_blocks(COP))
    block_conv_fwd_kernel(FwdArgs<float> a) {
  __shared__ uaps::conv::TileSmem<COP> sm;
  __shared__ float red[kWarps];
  const uaps::conv::Tile t = uaps::conv::tile_of_block(a.groups, COP);
  auto wt = [&](int c, int tap, int co) {
    return a.w9[(static_cast<size_t>(tap) * a.cin + c) * a.cout + co];
  };
  float acc[kPX][COP];
  if constexpr (PRO) {
    const ProLoad<float> in{a.x, a.pro};
    uaps::conv::conv_tile(acc, sm, t, in, wt, a.cin, a.cout, a.h, a.wd);
  } else {
    const uaps::conv::PlainLoad<float> in{a.x, a.cin, a.h, a.wd};
    uaps::conv::conv_tile(acc, sm, t, in, wt, a.cin, a.cout, a.h, a.wd);
  }
  uaps::conv::store_tile<float, COP>(a.y, acc, t, a.cout, a.h, a.wd);
  if constexpr (MOM) {
    const int oy = t.y0 + t.ty;
    const int ox = t.x0 + t.tx;
    float* out = a.part + partial_slot(t.b) * 2 * a.cout;
#pragma unroll
    for (int co = 0; co < COP; ++co) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int p = 0; p < kPX; ++p)
        if (oy < a.h && ox + p < a.wd) {
          s1 += acc[p][co];
          s2 = fmaf(acc[p][co], acc[p][co], s2);
        }
      s1 = uaps::conv::block_sum(s1, red);
      s2 = uaps::conv::block_sum(s2, red);
      if (threadIdx.x == 0 && t.co0 + co < a.cout) {
        out[t.co0 + co] = s1;
        out[a.cout + t.co0 + co] = s2;
      }
    }
  }
}

// The bf16 forward on the tensor cores (conv3x3_mma.cuh's conv_mma_tile):
// y = conv3x3(z, w9) with z read through the loader In (PlainLoad, or
// ProLoad with the prologue: z rounded to bf16 as it is staged, so the
// value multiplied equals the CUDA-core kernel's and the plain version's),
// w9 staged k-major ([tap][ci] rows of cout, 16-byte loads where cout % 8
// == 0); with MOM the moments of the f32 accumulator, one [2, cout]
// partial a block (mma_tile_moments).
template <int NB, bool MOM, typename In>
__global__ void __launch_bounds__(uaps::conv::tc::dg::kThreads, 2)
    block_fwd_mma_kernel(In in, FwdArgs<__nv_bfloat16> a) {
  namespace tc = uaps::conv::tc;
  extern __shared__ __align__(16) unsigned char smem[];
  const tc::MmaTile t = tc::mma_tile_of_block<NB>(a.groups);
  const uaps::conv::WStrides ws{3 * a.cin * a.cout, a.cin * a.cout, a.cout,
                                1};   // [9, cin, cout]
  float acc[2][NB][4];
  tc::conv_mma_tile<NB>(acc, smem, t, in,
                        tc::KMajorWeights<NB>{a.w9, ws, a.cout, t.n0}, a.cin,
                        a.h, a.wd);
  if constexpr (MOM)
    tc::mma_tile_moments<NB>(acc, reinterpret_cast<float*>(smem), t, a.h,
                             a.wd, a.part + partial_slot(t.b) * 2 * a.cout,
                             a.cout);
  tc::store_mma_tile<NB>(a.y, acc, smem, t, a.cout, a.h, a.wd);
}

template <int NB, bool MOM, typename In>
cudaError_t fwd_mma_launch(const In& in, FwdArgs<__nv_bfloat16> a,
                           int batch, cudaStream_t stream) {
  namespace tc = uaps::conv::tc;
  constexpr int kSmem = tc::mma_tile_smem(NB);
  // above 48 KB only after opting in, once per kernel
  static const cudaError_t opt = cudaFuncSetAttribute(
      block_fwd_mma_kernel<NB, MOM, In>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt != cudaSuccess) return opt;
  const dim3 grid = tc::mma_grid<NB>(batch, a.cout, a.h, a.wd);
  a.groups = static_cast<int>(grid.z) / batch;
  block_fwd_mma_kernel<NB, MOM, In>
      <<<grid, tc::dg::kThreads, kSmem, stream>>>(in, a);
  return cudaGetLastError();
}

// NB n8 tiles of output channels a block, as conv3x3_mma.cuh's
// launch_conv_fwd_mma: 16, 32 or 64, in groups of 64 above
template <bool MOM, typename In>
cudaError_t launch_fwd_mma(const In& in, const FwdArgs<__nv_bfloat16>& a,
                           int batch, cudaStream_t stream) {
  if (a.cout <= 16) return fwd_mma_launch<2, MOM>(in, a, batch, stream);
  if (a.cout <= 32) return fwd_mma_launch<4, MOM>(in, a, batch, stream);
  return fwd_mma_launch<8, MOM>(in, a, batch, stream);
}

template <typename T>
struct DgradArgs {
  FoldLoad<T> ge;     // the folded cotangent, [B, cout, H, W]
  const T* w9;        // the forward's [9, cin, cout]
  const T* x;         // the forward's input (for the prologue's backward)
  Prologue pro;
  T* dx;              // [B, cin, H, W]
  float* part;        // [blocks, 2, cin] df / ds partials
  int cin, cout, h, wd, groups;
};

// dz = conv3x3(ge, w rotated): the forward tile with the cotangent's cout
// channels as its input and the forward's cin as its output; tap t of the
// rotated weight is the forward's tap 8 - t, channels swapped. With PRO the
// epilogue turns dz into dx, df and ds. f32 only (bf16 takes
// dgrad_mma_kernel and bnl_bwd_mma_kernel).
template <typename T, bool PRO, int COP>
__global__ void __launch_bounds__(kThreads, uaps::conv::min_blocks(COP))
    block_conv_dgrad_kernel(DgradArgs<T> a) {
  __shared__ uaps::conv::TileSmem<COP> sm;
  __shared__ float red[kWarps];
  const uaps::conv::Tile t = uaps::conv::tile_of_block(a.groups, COP);
  auto wt = [&](int co, int tap, int ci) {
    return to_f32(
        a.w9[(static_cast<size_t>(8 - tap) * a.cin + ci) * a.cout + co]);
  };
  float acc[kPX][COP];
  uaps::conv::conv_tile(acc, sm, t, a.ge, wt, a.cout, a.cin, a.h, a.wd);
  if constexpr (PRO) {
    const int oy = t.y0 + t.ty;
    const int ox = t.x0 + t.tx;
    const size_t plane = static_cast<size_t>(a.h) * a.wd;
    float* out = a.part + partial_slot(t.b) * 2 * a.cin;
#pragma unroll
    for (int co = 0; co < COP; ++co) {
      const int ci = t.co0 + co;
      float sdx = 0.f, sda = 0.f;
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        if (ci < a.cin && oy < a.h && ox + p < a.wd) {
          const float xv = to_f32(a.x[(static_cast<size_t>(t.b) * a.cin + ci) *
                                          plane +
                                      static_cast<size_t>(oy) * a.wd + ox + p]);
          float dl = acc[p][co];
          if (a.pro.drop)
            dl = a.pro.keep(t.b, ci, oy, ox + p) ? __fmul_rn(dl, a.pro.scale)
                                                 : 0.f;
          const float da =
              __fmul_rn(dl, a.pro.pre(xv, ci) >= 0.f ? 1.f : kNegSlope);
          acc[p][co] = __fmul_rn(da, a.pro.f[ci]);
          sdx = __fadd_rn(sdx, __fmul_rn(da, xv));
          sda = __fadd_rn(sda, da);
        }
      }
      sdx = uaps::conv::block_sum(sdx, red);
      sda = uaps::conv::block_sum(sda, red);
      if (threadIdx.x == 0 && ci < a.cin) {
        out[ci] = sdx;
        out[a.cin + ci] = sda;
      }
    }
  }
  uaps::conv::store_tile<T, COP>(a.dx, acc, t, a.cin, a.h, a.wd);
}

// The bf16 dgrad with the prologue's backward on the tensor cores: dz =
// conv3x3(ge, w rotated) by conv_mma_tile with the FoldLoad and the
// RotWeights of dgrad_mma_kernel, its f32 accumulators parked in the
// output plane in shared memory (mma_tile_to_smem). Then warp w takes
// channels w, w + 8, ... of the block's 8 NB, one at a time, and lane l
// the 8 pixels (l / 4, 8 (l % 4) .. + 7) of the 8 x 32 tile: x read there
// (one 16-byte load where W % 8 == 0 and x and dx are 16-byte aligned,
// else one value a load), dl = dz * keep * scale (the mask hashed per
// element only with dropout), da = dl * leaky'(x f + s), dx = da f rounded
// to bf16 once (16 bytes a store likewise), and the lane's sums of da x and
// da over its in-image pixels, added over the warp by a butterfly into the
// channel's entries of the block's [2, cin] slot: a fixed order, no
// atomics. Each float operation is the CUDA-core kernel's intrinsic, so
// dx and the partials differ from it only by the conv's summation order.
// The plane is read with each lane's two 16-byte halves in the order of its
// row's parity, so that the 8 lanes of a quarter warp hit 8 bank groups.
template <int NB>
__global__ void __launch_bounds__(uaps::conv::tc::dg::kThreads, 2)
    bnl_bwd_mma_kernel(DgradArgs<__nv_bfloat16> a) {
  namespace tc = uaps::conv::tc;
  namespace dg = tc::dg;
  extern __shared__ __align__(16) unsigned char smem[];
  const tc::MmaTile t = tc::mma_tile_of_block<NB>(a.groups);
  float acc[2][NB][4];
  tc::conv_mma_tile<NB>(acc, smem, t, a.ge,
                        tc::RotWeights<NB>{a.w9, a.cin, a.cout, t.n0},
                        a.cout, a.h, a.wd);
  float* os = reinterpret_cast<float*>(smem);
  tc::mma_tile_to_smem<NB>(os, acc);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2;
  const int c8 = 8 * (lane & 3);
  const int gy = t.y0 + r;
  const int gx = t.x0 + c8;
  const bool live = gy < a.h && gx < a.wd;
  const bool vec = (a.wd % 8) == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.x) |
                     reinterpret_cast<uintptr_t>(a.dx)) & 15) == 0;
  const uint32_t seed =
      a.pro.drop ? static_cast<uint32_t>(__ldg(a.pro.seed)) : 0u;
  const size_t plane = static_cast<size_t>(a.h) * a.wd;
  float* part = a.part + partial_slot(t.b) * 2 * a.cin;
  const int odd = r & 1;
#pragma unroll 1
  for (int k = 0; k < NB; ++k) {
    const int ci = t.n0 + warp + 8 * k;
    if (ci >= a.cin) break;   // the same for the whole warp
    float sdx = 0.f, sda = 0.f;
    if (live) {
      const float* src = os + (warp + 8 * k) * dg::kOutStride + r * dg::kTW +
                         c8;
      const float4 p = *reinterpret_cast<const float4*>(src + 4 * odd);
      const float4 q = *reinterpret_cast<const float4*>(src + 4 - 4 * odd);
      const float4 lo = odd ? q : p;
      const float4 hi = odd ? p : q;
      const float dz[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const size_t off = (static_cast<size_t>(t.b) * a.cin + ci) * plane +
                         static_cast<size_t>(gy) * a.wd + gx;
      float xv[8];
      if (vec) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(a.x + off));
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xv[j] = __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u)
                                          : (w[j >> 1] << 16));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xv[j] = gx + j < a.wd ? to_f32(a.x[off + j]) : 0.f;
      }
      const float f = a.pro.f[ci];
      const float s = a.pro.s[ci];
      const uint32_t pos =
          ((static_cast<uint32_t>(t.b) * a.cin + ci) * a.h + gy) * a.wd + gx;
      float dx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dl = dz[j];
        if (a.pro.drop)
          dl = hash_u32(pos + j, seed) <= a.pro.thr
                   ? __fmul_rn(dl, a.pro.scale)
                   : 0.f;
        const float da = __fmul_rn(
            dl, __fadd_rn(__fmul_rn(xv[j], f), s) >= 0.f ? 1.f : kNegSlope);
        dx[j] = __fmul_rn(da, f);
        if (gx + j < a.wd) {
          sdx = __fadd_rn(sdx, __fmul_rn(da, xv[j]));
          sda = __fadd_rn(sda, da);
        }
      }
      if (vec) {
        *reinterpret_cast<uint4*>(a.dx + off) =
            make_uint4(tc::pack_bf16(dx[0], dx[1]), tc::pack_bf16(dx[2], dx[3]),
                       tc::pack_bf16(dx[4], dx[5]),
                       tc::pack_bf16(dx[6], dx[7]));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (gx + j < a.wd) a.dx[off + j] = from_f32<__nv_bfloat16>(dx[j]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sdx += __shfl_xor_sync(0xffffffffu, sdx, o);
      sda += __shfl_xor_sync(0xffffffffu, sda, o);
    }
    if (lane == 0) {
      part[ci] = sdx;
      part[a.cin + ci] = sda;
    }
  }
}

template <int NB>
cudaError_t bnl_bwd_mma_launch(DgradArgs<__nv_bfloat16> a, int batch,
                               cudaStream_t stream) {
  namespace tc = uaps::conv::tc;
  constexpr int kSmem = tc::mma_tile_smem(NB, 4);   // the f32 plane
  // above 48 KB only after opting in, once per kernel
  static const cudaError_t opt = cudaFuncSetAttribute(
      bnl_bwd_mma_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (opt != cudaSuccess) return opt;
  const dim3 grid = tc::mma_grid<NB>(batch, a.cin, a.h, a.wd);
  a.groups = static_cast<int>(grid.z) / batch;
  bnl_bwd_mma_kernel<NB><<<grid, tc::dg::kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

// NB n8 tiles of the forward's input channels a block, as
// launch_dgrad_mma: 16, 32 or 64, in groups of 64 above (each group writes
// its own channels of the block's partial slot)
cudaError_t launch_bnl_bwd_mma(const DgradArgs<__nv_bfloat16>& a, int batch,
                               cudaStream_t stream) {
  if (a.cin <= 16) return bnl_bwd_mma_launch<2>(a, batch, stream);
  if (a.cin <= 32) return bnl_bwd_mma_launch<4>(a, batch, stream);
  return bnl_bwd_mma_launch<8>(a, batch, stream);
}

template <bool PRO, bool MOM>
cudaError_t launch_fwd(const FwdArgs<float>& a, int batch,
                       cudaStream_t stream) {
  const dim3 grid = uaps::conv::tile_grid(batch, a.cout, a.h, a.wd);
  if (a.cout <= 4)
    block_conv_fwd_kernel<PRO, MOM, 4><<<grid, kThreads, 0, stream>>>(a);
  else if (a.cout <= 8)
    block_conv_fwd_kernel<PRO, MOM, 8><<<grid, kThreads, 0, stream>>>(a);
  else if (a.cout <= 16)
    block_conv_fwd_kernel<PRO, MOM, 16><<<grid, kThreads, 0, stream>>>(a);
  else
    block_conv_fwd_kernel<PRO, MOM, 32><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool PRO>
cudaError_t launch_dgrad(const DgradArgs<T>& a, int batch,
                         cudaStream_t stream) {
  const dim3 grid = uaps::conv::tile_grid(batch, a.cin, a.h, a.wd);
  if (a.cin <= 4)
    block_conv_dgrad_kernel<T, PRO, 4><<<grid, kThreads, 0, stream>>>(a);
  else if (a.cin <= 8)
    block_conv_dgrad_kernel<T, PRO, 8><<<grid, kThreads, 0, stream>>>(a);
  else if (a.cin <= 16)
    block_conv_dgrad_kernel<T, PRO, 16><<<grid, kThreads, 0, stream>>>(a);
  else
    block_conv_dgrad_kernel<T, PRO, 32><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The number of CUDA-core tiles of one image plane: the per-channel
// partials' row count of their forward and of the dgrad with the prologue
// (both f32) is batch times this.
int tiles_per_image(int h, int wd) {
  const dim3 g = uaps::conv::tile_grid(1, 1, h, wd);
  return static_cast<int>(g.x * g.y);
}

template <typename T>
cudaError_t fwd(const void* x, const void* w9, const Prologue& pro,
                int prologue, int moments, void* y, void* part, void* mom,
                int batch, int cin, int cout, int h, int wd,
                cudaStream_t stream) {
  const FwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(w9),
                     pro, static_cast<T*>(y), static_cast<float*>(part), cin,
                     cout, h, wd, uaps::conv::tile_groups(cout)};
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  cudaError_t err;
  if (!prologue && !moments) return cudaErrorInvalidValue;
  if constexpr (kBf16) {
    // bf16: the tensor cores
    const ProLoad<T> pin{a.x, pro};
    const uaps::conv::PlainLoad<T> in{a.x, cin, h, wd};
    if (prologue && moments)
      err = launch_fwd_mma<true>(pin, a, batch, stream);
    else if (prologue)
      err = launch_fwd_mma<false>(pin, a, batch, stream);
    else
      err = launch_fwd_mma<true>(in, a, batch, stream);
  } else {
    if (prologue && moments)
      err = launch_fwd<true, true>(a, batch, stream);
    else if (prologue)
      err = launch_fwd<true, false>(a, batch, stream);
    else
      err = launch_fwd<false, true>(a, batch, stream);
  }
  if (err != cudaSuccess || !moments) return err;
  const float* pp = static_cast<const float*>(part);
  float* m = static_cast<float*>(mom);
  if constexpr (kBf16)
    return uaps::conv::reduce_partials_tall(
        pp, m, batch * uaps::conv::tc::mma_tiles_per_image(h, wd), 2 * cout,
        stream);
  else
    return uaps::conv::reduce_partials(pp, m, batch * tiles_per_image(h, wd),
                                       2 * cout, stream);
}

template <typename T>
cudaError_t bwd(const void* g, const void* y, const float* ds1,
                const float* ds2, const void* x, const void* w9,
                const Prologue& pro, int prologue, void* dx, void* part_d,
                void* dfds, void* part_w, void* dw, int batch, int cin,
                int cout, int h, int wd, int strip_rows,
                cudaStream_t stream) {
  const FoldLoad<T> ge{static_cast<const T*>(g), static_cast<const T*>(y),
                       ds1, ds2, cout, h, wd};
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) {
    const DgradArgs<T> a{ge, static_cast<const T*>(w9),
                         static_cast<const T*>(x), pro, static_cast<T*>(dx),
                         static_cast<float*>(part_d), cin, cout, h, wd,
                         uaps::conv::tile_groups(cin)};
    // bf16 on the tensor cores, f32 on the CUDA cores
    if constexpr (kBf16)
      err = prologue ? launch_bnl_bwd_mma(a, batch, stream)
                     : uaps::conv::tc::launch_dgrad_mma(
                           ge, a.w9, a.dx, batch, cin, cout, h, wd, stream);
    else
      err = prologue ? launch_dgrad<T, true>(a, batch, stream)
                     : launch_dgrad<T, false>(a, batch, stream);
    if (err != cudaSuccess) return err;
    if (prologue) {
      const float* pp = static_cast<const float*>(part_d);
      float* m = static_cast<float*>(dfds);
      if constexpr (kBf16)
        err = uaps::conv::reduce_partials_tall(
            pp, m, batch * uaps::conv::tc::mma_tiles_per_image(h, wd),
            2 * cin, stream);
      else
        err = uaps::conv::reduce_partials(pp, m, batch * tiles_per_image(h, wd),
                                          2 * cin, stream);
      if (err != cudaSuccess) return err;
    }
  }
  float* pw = static_cast<float*>(part_w);
  float* d = static_cast<float*>(dw);
  if (prologue) {
    const ProLoad<T> in{static_cast<const T*>(x), pro};
    return uaps::conv::launch_wgrad_dtype<T>(in, ge, pw, d, batch, cin, cout,
                                             h, wd, strip_rows, stream);
  }
  const uaps::conv::PlainLoad<T> in{static_cast<const T*>(x), cin, h, wd};
  return uaps::conv::launch_wgrad_dtype<T>(in, ge, pw, d, batch, cin, cout,
                                           h, wd, strip_rows, stream);
}

bool bad_shape(int batch, int cin, int cout, int h, int wd) {
  return batch < 1 || cin < 1 || cout < 1 || h < 1 || wd < 1 ||
         !uaps::conv::index_fits(batch, cin > cout ? cin : cout, h, wd) ||
         static_cast<long long>(batch) * uaps::conv::tile_groups(cin) >
             65535 ||
         static_cast<long long>(batch) * uaps::conv::tile_groups(cout) >
             65535 ||
         (cin + uaps::conv::wgrad::kCK - 1) / uaps::conv::wgrad::kCK > 65535;
}

}  // namespace

// The forward. x [B, Cin, H, W] and w9 [9, Cin, Cout] in dtype (contiguous);
// with `prologue`, f and s [Cin] f32 and, with `drop`, seed (a device int64
// whose low 32 bits are the seed), thr and scale; y [B, Cout, H, W] in dtype;
// with `moments`, part: f32 scratch of B * ceil(H / 8) * ceil(W / 64) (f32)
// or B * ceil(H / 8) * ceil(W / 32) (bf16: the tensor-core tile) * 2 * Cout
// elements (kernels/block_conv.py fwd_tiles) and mom [2, Cout] f32 (s1,
// s2). Returns a cudaError_t code.
extern "C" int uaps_block_conv_fwd(const void* x, const void* w9,
                                   const void* f, const void* s,
                                   const void* seed, void* y, void* part,
                                   void* mom, int batch, int cin, int cout,
                                   int h, int wd, int prologue, int moments,
                                   unsigned int thr, float scale, int drop,
                                   int dtype, void* stream) {
  if (bad_shape(batch, cin, cout, h, wd) || (prologue && (!f || !s)) ||
      (drop && (!prologue || !seed)) || (moments && (!part || !mom)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Prologue pro{static_cast<const float*>(f),
                     static_cast<const float*>(s),
                     static_cast<const long long*>(seed), thr, scale, drop,
                     cin, h, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == uaps::kF32)
    return static_cast<int>(fwd<float>(x, w9, pro, prologue, moments, y,
                                       part, mom, batch, cin, cout, h, wd,
                                       st));
  if (dtype == uaps::kBF16)
    return static_cast<int>(fwd<__nv_bfloat16>(x, w9, pro, prologue, moments,
                                               y, part, mom, batch, cin, cout,
                                               h, wd, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward. g and y [B, Cout, H, W], x [B, Cin, H, W] and w9 in dtype
// (contiguous); ds1, ds2 [Cout] f32 or null (a zero cotangent); the
// prologue's f, s, seed, thr, scale and drop as in the forward. Writes dx
// [B, Cin, H, W] in dtype (skipped when dx is null; not allowed with the
// prologue), with the prologue dfds [2, Cin] f32 (df, ds) through part_d (f32
// scratch of B * ceil(H / 8) * ceil(W / 64) (f32) or B * ceil(H / 8) *
// ceil(W / 32) (bf16: the tensor-core tile) * 2 * Cin elements,
// kernels/block_conv.py fwd_tiles, as the forward's), and dw [9, Cin,
// Cout] f32 through part_w (f32 scratch of B * ceil(H / strip_rows) * 9 *
// Cin * Cout; strip_rows as uaps_conv3x3_wgrad_nchw takes it). Returns a
// cudaError_t code.
extern "C" int uaps_block_conv_bwd(const void* g, const void* y,
                                   const void* ds1, const void* ds2,
                                   const void* x, const void* w9,
                                   const void* f, const void* s,
                                   const void* seed, void* dx, void* part_d,
                                   void* dfds, void* part_w, void* dw,
                                   int batch, int cin, int cout, int h,
                                   int wd, int prologue, unsigned int thr,
                                   float scale, int drop, int strip_rows,
                                   int dtype, void* stream) {
  if (bad_shape(batch, cin, cout, h, wd) ||
      !uaps::conv::wgrad_shape_ok(batch, cin, cout, h, wd, strip_rows,
                                  dtype) ||
      (prologue && (!f || !s || !dx || !part_d || !dfds)) ||
      (drop && (!prologue || !seed)) || (ds2 && !y) || !part_w || !dw)
    return static_cast<int>(cudaErrorInvalidValue);
  const Prologue pro{static_cast<const float*>(f),
                     static_cast<const float*>(s),
                     static_cast<const long long*>(seed), thr, scale, drop,
                     cin, h, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d1 = static_cast<const float*>(ds1);
  const float* d2 = static_cast<const float*>(ds2);
  if (dtype == uaps::kF32)
    return static_cast<int>(bwd<float>(g, y, d1, d2, x, w9, pro, prologue,
                                       dx, part_d, dfds, part_w, dw, batch,
                                       cin, cout, h, wd, strip_rows, st));
  if (dtype == uaps::kBF16)
    return static_cast<int>(bwd<__nv_bfloat16>(g, y, d1, d2, x, w9, pro,
                                               prologue, dx, part_d, dfds,
                                               part_w, dw, batch, cin, cout,
                                               h, wd, strip_rows, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
