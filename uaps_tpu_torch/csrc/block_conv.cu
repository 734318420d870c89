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
// Routing (by dtype, in the entry points): in bf16 the backward's wgrad
// pass (with or without the prologue) and the dgrad without the prologue
// (chain_conv_plain's) run on the tensor cores (conv3x3_mma.cuh:
// wgrad_mma_kernel, dgrad_mma_kernel; their note says what bounds them and
// how they answer it); the forwards, the dgrad with the prologue and every
// f32 kernel run on the CUDA cores, as below.
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

// ge = g + ds1[c] + (2 y) ds2[c] in f32, rounded to T (either ds may be null)
template <typename T>
struct FoldLoad {
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
  };
  __device__ __forceinline__ At at(int b, int c0) const {
    const size_t plane = static_cast<size_t>(h) * wd;
    const size_t base = static_cast<size_t>(b * c + c0) * plane;
    return At{g + base, y == nullptr ? nullptr : y + base, ds1, ds2, plane,
              wd, c0};
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

// PRO: the prologue on the input; MOM: the moments epilogue.
template <typename T, bool PRO, bool MOM, int COP>
__global__ void __launch_bounds__(kThreads, uaps::conv::min_blocks(COP))
    block_conv_fwd_kernel(FwdArgs<T> a) {
  __shared__ uaps::conv::TileSmem<COP> sm;
  __shared__ float red[kWarps];
  const uaps::conv::Tile t = uaps::conv::tile_of_block(a.groups, COP);
  auto wt = [&](int c, int tap, int co) {
    return to_f32(a.w9[(static_cast<size_t>(tap) * a.cin + c) * a.cout + co]);
  };
  float acc[kPX][COP];
  if constexpr (PRO) {
    const ProLoad<T> in{a.x, a.pro};
    uaps::conv::conv_tile(acc, sm, t, in, wt, a.cin, a.cout, a.h, a.wd);
  } else {
    const uaps::conv::PlainLoad<T> in{a.x, a.cin, a.h, a.wd};
    uaps::conv::conv_tile(acc, sm, t, in, wt, a.cin, a.cout, a.h, a.wd);
  }
  uaps::conv::store_tile<T, COP>(a.y, acc, t, a.cout, a.h, a.wd);
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
// epilogue turns dz into dx, df and ds.
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

template <typename T, bool PRO, bool MOM>
cudaError_t launch_fwd(const FwdArgs<T>& a, int batch, cudaStream_t stream) {
  const dim3 grid = uaps::conv::tile_grid(batch, a.cout, a.h, a.wd);
  if (a.cout <= 4)
    block_conv_fwd_kernel<T, PRO, MOM, 4><<<grid, kThreads, 0, stream>>>(a);
  else if (a.cout <= 8)
    block_conv_fwd_kernel<T, PRO, MOM, 8><<<grid, kThreads, 0, stream>>>(a);
  else if (a.cout <= 16)
    block_conv_fwd_kernel<T, PRO, MOM, 16><<<grid, kThreads, 0, stream>>>(a);
  else
    block_conv_fwd_kernel<T, PRO, MOM, 32><<<grid, kThreads, 0, stream>>>(a);
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

// The number of forward tiles of one image plane: the per-channel partials'
// row count is batch times this.
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
  cudaError_t err;
  if (prologue && moments)
    err = launch_fwd<T, true, true>(a, batch, stream);
  else if (prologue)
    err = launch_fwd<T, true, false>(a, batch, stream);
  else if (moments)
    err = launch_fwd<T, false, true>(a, batch, stream);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || !moments) return err;
  return uaps::conv::reduce_partials(
      static_cast<const float*>(part), static_cast<float*>(mom),
      batch * tiles_per_image(h, wd), 2 * cout, stream);
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
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) {
    const DgradArgs<T> a{ge, static_cast<const T*>(w9),
                         static_cast<const T*>(x), pro, static_cast<T*>(dx),
                         static_cast<float*>(part_d), cin, cout, h, wd,
                         uaps::conv::tile_groups(cin)};
    if (prologue) {
      err = launch_dgrad<T, true>(a, batch, stream);
    } else {
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        err = uaps::conv::tc::launch_dgrad_mma(
            ge, a.w9, a.dx, batch, cin, cout, h, wd, stream);
      else
        err = launch_dgrad<T, false>(a, batch, stream);
    }
    if (err != cudaSuccess) return err;
    if (prologue) {
      err = uaps::conv::reduce_partials(
          static_cast<const float*>(part_d), static_cast<float*>(dfds),
          batch * tiles_per_image(h, wd), 2 * cin, stream);
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
// with `moments`, part: f32 scratch of B * ceil(H / 8) * ceil(W / 64) * 2 *
// Cout elements and mom [2, Cout] f32 (s1, s2). Returns a cudaError_t code.
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
// scratch of B * ceil(H / 8) * ceil(W / 64) * 2 * Cin), and dw [9, Cin,
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
