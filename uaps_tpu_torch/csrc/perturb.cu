// Perturbation kernels of the UAPS auxiliary decoders (and the encoder's
// dropout), for Hopper (sm_90a), with a counter-based generator.
//
// Replaces uaps_tpu/pallas/perturb.py: fused_dropout (_dropout_kernel and
// _dropout_kernel_lanes through _elemwise_call / _batched_call),
// fused_feature_noise (_noise_kernel, _noise_kernel_lanes) and
// fused_feature_dropout (_fdrop_kernel, and its backward _fdrop_bwd). The TPU
// seeds its in-core generator per grid step; here the random value at an
// element is a pure function of (seed, index), so a backward regenerates its
// forward's draw from the same seed and nothing is stored:
//
//   bits(seed, i) = mix32(mix32(i ^ key) + seed), key = mix32(seed ^ salt),
//   mix32 = the "lowbias32" integer hash; uniform24 = (bits >> 8) * 2^-24.
//
//   dropout          i = flat index (masks differ per example); keep when
//                    bits < threshold; kept values x * scale in f32.
//   feature noise    i = index within one example (noise shared across the
//                    batch); out = x * (1 + (u * span - r)) in f32.
//   feature dropout  one draw at i = 0: scale = u * 0.2 + 0.7; attention =
//                    channel mean in f32 in a fixed grouped order (each
//                    group of kGroup channels summed in order, the groups'
//                    sums added in group order, times f32(1 / C)); keep a
//                    pixel where attention < (its example's max) * scale.
//                    Pass 1 (fdrop_att_kernel) writes the attention [B, HW]
//                    in f32 and takes each example's max with atomicMax on
//                    an order-preserving integer key (max is
//                    order-independent, so the result is deterministic);
//                    pass 2 (fdrop_apply_kernel) writes src * mask from the
//                    attention, the max and the seed. The backward is pass
//                    2 with src = g on the forward's attention and maxima:
//                    it never reads x.
//
// The seed is read through a device pointer, so the host never waits for it.
// Every float operation that decides or forms a value is an explicit
// round-to-nearest intrinsic (no fused multiply-add), so the plain PyTorch
// versions in kernels/perturb.py give the same bits.
//
// What bounds them. Feature dropout is bound by bytes: a UAPS step (10
// forwards and 10 backwards at the 5 skip levels, B = 16) reads x and
// writes out, 260 MB in bf16, and writes 11.2 MB of attention, 0.081 ms
// at 3.35 TB/s; the backward reads g and the attention and writes dx, as
// much. A sum over the channels in channel order would tie one pixel to
// one thread, which at the deep levels ([16, 256, 16, 16]: 4 K pixels)
// leaves most SMs idle and each thread a chain of 256 dependent loads.
// What the design does: the grouped order splits the channels, so pass 1
// gives a thread one group of 8 channels at one 16-byte pixel vector (8
// bf16 or 4 f32 pixels), its 8 loads issued together (at [16, 256, 16,
// 16]: 16 K threads, all 2 MB of x in flight), and a block folds its
// groups' sums through shared memory in group order, kAttGroups groups a
// round. Pass 2 is elementwise: 16-byte vectors of src, kApplyVecs a
// thread, each against its pixels' attention (16 or 32 bytes), the seed
// read and the threshold formed once a thread (a thread stays in one
// example), its blocks in reverse order, so that the forward's pass 2
// starts on the rows of x that pass 1 read last, the likeliest still in
// L2. x is read once a pass, g once. Where H*W is no multiple of the
// vector or a pointer is not 16-byte aligned (a view with a storage
// offset), both passes take one pixel (pass 1) or element (pass 2) a unit
// in the same kernels, with the same bits; pass 1 decides from x, pass 2
// from src, out and the attention.
//
// Feature noise is bound by bytes once its hashes are shared: a UAPS step
// moves 130 M elements through it (20 launches at the 5 skip levels, B =
// 16), 0.52 GB in bf16, 0.155 ms at 3.35 TB/s, while one draw an element
// (two mix32 hashes, ~15 integer instructions) would cost as much integer
// issue as dropout's. What the design does: the noise depends on the index
// within one example only, so a thread draws the factors of one in-example
// 16-byte vector once (the seed read and the key hashed once a thread,
// mix32's first xorshift shared by the vector, as keep_vec) and applies them
// to that vector in each of its examples, the loads of kNoiseEx examples
// issued together; the batch is split over blockIdx.y only as far as it
// takes to give every SM two blocks (at B = 16: one draw for 16 elements
// at the level-0 shape, for 2 at the smallest), so the hashes are a
// fraction of the bytes' time at every level. 32-bit indices; where the
// in-example count is no multiple of the vector or x or out is not 16-byte
// aligned, the same kernel takes one element a thread with the same bits.
//
// Dropout is bound by bytes and integer issue together. A UAPS step drops
// 260 M elements (5 encoder levels of 32.5 M at B = 16, 8 launches each):
// 1.04 GB in bf16, 0.31 ms at 3.35 TB/s. Each element also takes two mix32
// hashes, the compare and the bf16 unpacking: 20.2 integer instructions an
// element in the bf16 kernel's loop (cuobjdump -sass; conv_times.py counts
// them), and an H100 SM issues 64 integer lanes a clock: 0.31 ms a step at
// 1.98 GHz, as much as the bytes. The two overlap, so the kernel can
// approach the larger, not their sum.
// What the design does about both: each thread reads the seed and hashes
// the key once, then takes kDropVecs 16-byte vectors (8 bf16 or 4 f32
// elements) per iteration with 32-bit indices, its loads issued first and
// the iteration free of branches, so that the hashes run while 32 bytes a
// thread are in flight; a warp's loads at one vector slot are 512
// contiguous bytes. A vector's first index is a multiple of its length, so
// mix32's first xorshift of the index is shared by the vector
// (keep_vec). Where x and out are both 16-byte aligned, the elements past
// the last whole vector (the tail) go through a scalar loop in the same
// kernel, with the same bits at the same flat index; where either is not
// (x a view with a storage offset: out is a fresh allocation, so no scalar
// head could align both), every element takes that loop. The path is
// decided from the pointers.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kKeySalt = 0x9e3779b9u;

// mix32 after its first xorshift
__device__ __forceinline__ uint32_t mix32_tail(uint32_t x) {
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  return mix32_tail(x ^ (x >> 16));
}

struct Stream {
  uint32_t seed, key;
  __device__ __forceinline__ explicit Stream(const long long* seed_ptr)
      : seed(static_cast<uint32_t>(*seed_ptr)), key(mix32(seed ^ kKeySalt)) {}
  __device__ __forceinline__ uint32_t bits(uint32_t i) const {
    return mix32(mix32(i ^ key) + seed);
  }
  __device__ __forceinline__ float uniform(uint32_t i) const {
    return __fmul_rn(__uint2float_rn(bits(i) >> 8), 5.9604644775390625e-08f);
  }
};

// Dropout: 16-byte vectors a thread per loop iteration.
constexpr int kDropVecs = 2;

// keep(bits) = bits < threshold for a threshold <= 2^32, in 32-bit compares,
// without a branch (a short-circuit || would let the compiler skip the hash
// where every element is kept, and branch around it)
struct KeepTest {
  uint32_t lo;
  bool all;   // threshold == 2^32: every element is kept
  __device__ __forceinline__ explicit KeepTest(unsigned long long threshold)
      : lo(static_cast<uint32_t>(threshold)), all((threshold >> 32) != 0) {}
  __device__ __forceinline__ bool operator()(uint32_t bits) const {
    return (bits < lo) | all;
  }
};

__device__ __forceinline__ float drop1(float v, bool keep, float scale) {
  return keep ? __fmul_rn(v, scale) : 0.f;
}

// Stream::bits(i0 + j) for j < N, i0 a multiple of N (a power of two <=
// 8): then i0 + j = i0 ^ j, and (i0 + j) ^ key = t ^ j with t = i0 ^ key,
// whose bits above the lowest 3 do not depend on j; so mix32's first
// xorshift of it is (t ^ (t >> 16)) ^ j, shared by the vector but for the
// one xor.
template <int N>
__device__ __forceinline__ void bits_vec(uint32_t (&bits)[N], uint32_t i0,
                                         const Stream& rng) {
  const uint32_t t = i0 ^ rng.key;
  const uint32_t h = t ^ (t >> 16);
#pragma unroll
  for (int j = 0; j < N; ++j) bits[j] = mix32(mix32_tail(h ^ j) + rng.seed);
}

// Whether elements i0 + j (j < N) of a vector are kept (bits_vec's i0)
template <int N>
__device__ __forceinline__ void keep_vec(bool (&kept)[N], uint32_t i0,
                                         const Stream& rng,
                                         const KeepTest& keep) {
  uint32_t bits[N];
  bits_vec(bits, i0, rng);
#pragma unroll
  for (int j = 0; j < N; ++j) kept[j] = keep(bits[j]);
}

// The dropped 16-byte vector u of elements i0, i0 + 1, ... (i0 % 4 == 0)
__device__ __forceinline__ uint4 drop_vec(uint4 u, uint32_t i0,
                                          const Stream& rng,
                                          const KeepTest& keep, float scale,
                                          float) {
  bool kept[4];
  keep_vec(kept, i0, rng, keep);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    r[j] = __float_as_uint(drop1(__uint_as_float(w[j]), kept[j], scale));
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// ... of 8 bf16 elements (i0 % 8 == 0); each rounds once
__device__ __forceinline__ uint4 drop_vec(uint4 u, uint32_t i0,
                                          const Stream& rng,
                                          const KeepTest& keep, float scale,
                                          __nv_bfloat16) {
  bool kept[8];
  keep_vec(kept, i0, rng, keep);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // a word holds elements 2j (low half) and 2j + 1
    const __nv_bfloat162 p = __floats2bfloat162_rn(
        drop1(__uint_as_float(w[j] << 16), kept[2 * j], scale),
        drop1(__uint_as_float(w[j] & 0xffff0000u), kept[2 * j + 1], scale));
    r[j] = static_cast<uint32_t>(__bfloat16_as_ushort(p.x)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(p.y)) << 16);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Elements [0, nvec * kPer) as nvec 16-byte vectors (x and out 16-byte
// aligned; nvec = 0 where either is not), the rest one at a time. A
// thread's kDropVecs loads are issued first; an index past the last vector
// loads the last one again (never stored), so that the iteration has no
// branch and the hashes overlap the loads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const long long* __restrict__ seed, uint32_t n,
                   uint32_t nvec, unsigned long long threshold, float scale) {
  constexpr uint32_t kPer = 16 / sizeof(T);
  const Stream rng(seed);
  const KeepTest keep(threshold);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const uint32_t stride = gridDim.x * kThreads * kDropVecs;
  for (uint32_t v0 = blockIdx.x * kThreads * kDropVecs + threadIdx.x;
       v0 < nvec; v0 += stride) {
    uint4 u[kDropVecs];
#pragma unroll
    for (int k = 0; k < kDropVecs; ++k)
      u[k] = __ldg(xv + min(v0 + k * kThreads, nvec - 1));
#pragma unroll
    for (int k = 0; k < kDropVecs; ++k) {
      const uint32_t v = v0 + k * kThreads;
      const uint4 r = drop_vec(u[k], v * kPer, rng, keep, scale, T());
      if (v < nvec) ov[v] = r;
    }
  }
  // the tail past the last whole vector, or every element (a 64-bit count:
  // with no vectors it runs to n < 2^32)
  for (unsigned long long i = static_cast<unsigned long long>(nvec) * kPer +
                              blockIdx.x * kThreads + threadIdx.x;
       i < n; i += static_cast<unsigned long long>(gridDim.x) * kThreads)
    out[i] = uaps::from_f32<T>(drop1(
        uaps::to_f32(x[i]), keep(rng.bits(static_cast<uint32_t>(i))), scale));
}

// Feature noise: examples whose loads a thread issues together.
constexpr int kNoiseEx = 4;

// 1 + (u * span - r), u = uniform24(bits): the factor of one element
__device__ __forceinline__ float noise_factor(uint32_t bits, float span,
                                              float r) {
  const float u =
      __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
  return __fadd_rn(1.f, __fsub_rn(__fmul_rn(u, span), r));
}

// x * m elementwise over a 16-byte vector of 4 f32 ...
__device__ __forceinline__ uint4 scale_vec(uint4 u, const float (&m)[4]) {
  return make_uint4(__float_as_uint(__fmul_rn(__uint_as_float(u.x), m[0])),
                    __float_as_uint(__fmul_rn(__uint_as_float(u.y), m[1])),
                    __float_as_uint(__fmul_rn(__uint_as_float(u.z), m[2])),
                    __float_as_uint(__fmul_rn(__uint_as_float(u.w), m[3])));
}

// ... or of 8 bf16, each rounded once
__device__ __forceinline__ uint4 scale_vec(uint4 u, const float (&m)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // a word holds elements 2j (low half) and 2j + 1
    const __nv_bfloat162 p = __floats2bfloat162_rn(
        __fmul_rn(__uint_as_float(w[j] << 16), m[2 * j]),
        __fmul_rn(__uint_as_float(w[j] & 0xffff0000u), m[2 * j + 1]));
    r[j] = static_cast<uint32_t>(__bfloat16_as_ushort(p.x)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(p.y)) << 16);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// x, out [batch, inner]; grid (blocks over one example's vectors, or over
// its elements where nvec = 0; groups of per_ex examples). Thread t draws
// the factors of in-example vector t (elements t * kPer ..) once and
// scales that vector in examples [blockIdx.y * per_ex, + per_ex), kNoiseEx
// loads issued first (an example past the group loads the group's last
// again and is not stored); with nvec = 0 it takes element t alike, one
// value a load.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    noise_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const long long* __restrict__ seed, uint32_t inner,
                 uint32_t nvec, int batch, int per_ex, float span, float r) {
  constexpr uint32_t kPer = 16 / sizeof(T);
  const Stream rng(seed);
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  const int b0 = blockIdx.y * per_ex;
  const int b1 = min(batch, b0 + per_ex);
  if (nvec != 0) {
    if (t >= nvec) return;
    uint32_t bits[kPer];
    bits_vec(bits, t * kPer, rng);
    float m[kPer];
#pragma unroll
    for (uint32_t j = 0; j < kPer; ++j) m[j] = noise_factor(bits[j], span, r);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (int b = b0; b < b1; b += kNoiseEx) {
      uint4 u[kNoiseEx];
#pragma unroll
      for (int k = 0; k < kNoiseEx; ++k)
        u[k] = __ldg(xv + static_cast<uint32_t>(min(b + k, b1 - 1)) * nvec + t);
#pragma unroll
      for (int k = 0; k < kNoiseEx; ++k)
        if (b + k < b1)
          ov[static_cast<uint32_t>(b + k) * nvec + t] = scale_vec(u[k], m);
    }
  } else {
    if (t >= inner) return;
    const float m = noise_factor(rng.bits(t), span, r);
    for (int b = b0; b < b1; ++b) {
      const uint32_t i = static_cast<uint32_t>(b) * inner + t;
      out[i] = uaps::from_f32<T>(__fmul_rn(uaps::to_f32(x[i]), m));
    }
  }
}

// float -> unsigned key with the same order (NaN-free input)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Feature dropout: channels a pass-1 thread sums in order (a group); the
// groups' sums are then added in group order (kernels/perturb.py
// FDROP_GROUP, channel_mean)
constexpr int kGroup = 8;
// pass 1: threads a block, and groups a block sums at once (a round)
constexpr int kAttThreads = 128;
constexpr int kAttGroups = 32;
// pass 2: 16-byte vectors a thread
constexpr int kApplyVecs = 2;

// The values of a 16-byte vector in f32: 4 f32 ...
__device__ __forceinline__ void unpack(uint4 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// ... or 8 bf16 (a word holds elements 2j, the low half, and 2j + 1)
__device__ __forceinline__ void unpack(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Pass 1. x [batch, c, hw]; att [batch, hw] f32; mx[b] starts at 0 (below
// every key). Grid (blocks of vx units, batch); a unit is a 16-byte pixel
// vector (nvec != 0: hw a multiple of the vector, x 16-byte aligned) or
// one pixel. Thread (tx, ty) = (t % vx, t / vx), ty < gy, sums group
// r + ty at unit tx in each round r = 0, gy, 2 gy, ..., its loads issued
// together, into shared memory; then thread t adds the round's groups in
// order to the running sums of pixels t, t + kAttThreads, ... of the
// block. gy * vx <= kAttThreads.
template <typename T>
__global__ void __launch_bounds__(kAttThreads)
    fdrop_att_kernel(const T* __restrict__ x, float* __restrict__ att,
                     unsigned* __restrict__ mx, int c, uint32_t hw,
                     uint32_t nvec, int gy, int vx, float inv_c) {
  constexpr int kPer = 16 / sizeof(T);
  __shared__ __align__(16) float part[kAttThreads * kPer];
  __shared__ unsigned wmax[kAttThreads / 32];
  const int per = nvec ? kPer : 1;   // pixels a unit
  const int npx = vx * per;          // pixels a block
  const int tx = threadIdx.x % vx, ty = threadIdx.x / vx;
  const uint32_t unit = blockIdx.x * vx + tx;
  const uint32_t p0 = blockIdx.x * static_cast<uint32_t>(npx);
  const T* xb = x + blockIdx.y * static_cast<uint32_t>(c) * hw;
  const int groups = (c + kGroup - 1) / kGroup;
  float acc[kPer] = {};
  for (int r = 0; r < groups; r += gy) {
    const int grp = r + ty;
    if (ty < gy && grp < groups) {
      const int k0 = grp * kGroup;
      const int nk = min(kGroup, c - k0);
      const T* row = xb + static_cast<uint32_t>(k0) * hw;
      if (nvec != 0 && unit < nvec) {
        const uint4* xv = reinterpret_cast<const uint4*>(row) + unit;
        const uint32_t stride = hw / kPer;
        uint4 u[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (k < nk) u[k] = __ldg(xv + k * stride);
        float s[kPer] = {};
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (k < nk) {
            float v[kPer];
            unpack(u[k], v);
#pragma unroll
            for (int j = 0; j < kPer; ++j) s[j] = __fadd_rn(s[j], v[j]);
          }
        }
        float4* dst = reinterpret_cast<float4*>(part + ty * npx + tx * kPer);
#pragma unroll
        for (int j = 0; j < kPer / 4; ++j)
          dst[j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                               s[4 * j + 3]);
      } else if (nvec == 0 && unit < hw) {
        T u[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (k < nk) u[k] = row[k * hw + unit];
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (k < nk) s = __fadd_rn(s, uaps::to_f32(u[k]));
        part[ty * npx + tx] = s;
      }
    }
    __syncthreads();
    const int ng = min(gy, groups - r);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = threadIdx.x + j * kAttThreads;
      if (p < npx) {
        float a = r == 0 ? part[p] : __fadd_rn(acc[j], part[p]);
        for (int q = 1; q < ng; ++q) a = __fadd_rn(a, part[q * npx + p]);
        acc[j] = a;
      }
    }
    __syncthreads();
  }
  unsigned key = 0u;
  float* ab = att + blockIdx.y * hw;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const uint32_t p = p0 + threadIdx.x + j * kAttThreads;
    if (threadIdx.x + j * kAttThreads < npx && p < hw) {
      const float a = __fmul_rn(acc[j], inv_c);
      ab[p] = a;
      key = max(key, order_key(a));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    key = max(key, __shfl_down_sync(0xffffffffu, key, off));
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned m = wmax[0];
#pragma unroll
    for (int w = 1; w < kAttThreads / 32; ++w) m = max(m, wmax[w]);
    atomicMax(mx + blockIdx.y, m);
  }
}

// Pass 2: out = src * (att < max * scale) in f32, cast once. src, out
// [batch, c, hw], att [batch, hw]; grid (blocks over one example's units,
// batch), so that a thread forms its example's threshold once, taken in
// reverse order. Units are 16-byte vectors (nvec = c * hw / kPer != 0: hw
// a multiple of the vector; src, out and att 16-byte aligned), kApplyVecs
// a thread with their loads issued first (an index past the example's
// last vector loads that one again and is not stored), else single
// elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fdrop_apply_kernel(const T* __restrict__ src,
                       const float* __restrict__ att,
                       const unsigned* __restrict__ mx,
                       const long long* __restrict__ seed,
                       T* __restrict__ out, uint32_t hw, uint32_t n_ex,
                       uint32_t nvec) {
  // blocks in reverse: in the forward, the rows of x that pass 1 read
  // last are the likeliest still in L2
  const uint32_t bx = gridDim.x - 1 - blockIdx.x;
  const uint32_t by = gridDim.y - 1 - blockIdx.y;
  constexpr uint32_t kPer = 16 / sizeof(T);
  const Stream rng(seed);
  const float scale = __fadd_rn(__fmul_rn(rng.uniform(0u), 0.2f), 0.7f);
  const float thr = __fmul_rn(from_order_key(mx[by]), scale);
  const float* ab = att + by * hw;
  const uint32_t off = by * n_ex;
  if (nvec != 0) {
    const uint4* sv = reinterpret_cast<const uint4*>(src + off);
    uint4* ov = reinterpret_cast<uint4*>(out + off);
    const uint32_t row = hw / kPer;   // vectors a channel
    const uint32_t v0 = bx * kThreads * kApplyVecs + threadIdx.x;
    uint4 u[kApplyVecs];
    float4 a[kApplyVecs][kPer / 4];
#pragma unroll
    for (int k = 0; k < kApplyVecs; ++k) {
      const uint32_t v = min(v0 + k * kThreads, nvec - 1);
      u[k] = __ldg(sv + v);
      const float4* av = reinterpret_cast<const float4*>(ab) +
                         (v % row) * (kPer / 4);
#pragma unroll
      for (int j = 0; j < static_cast<int>(kPer / 4); ++j)
        a[k][j] = __ldg(av + j);
    }
#pragma unroll
    for (int k = 0; k < kApplyVecs; ++k) {
      float m[kPer];
#pragma unroll
      for (int j = 0; j < static_cast<int>(kPer / 4); ++j) {
        m[4 * j] = a[k][j].x < thr ? 1.f : 0.f;
        m[4 * j + 1] = a[k][j].y < thr ? 1.f : 0.f;
        m[4 * j + 2] = a[k][j].z < thr ? 1.f : 0.f;
        m[4 * j + 3] = a[k][j].w < thr ? 1.f : 0.f;
      }
      const uint32_t v = v0 + k * kThreads;
      const uint4 r = scale_vec(u[k], m);
      if (v < nvec) ov[v] = r;
    }
  } else {
    const uint32_t i = bx * kThreads + threadIdx.x;
    if (i < n_ex)
      out[off + i] = uaps::from_f32<T>(
          __fmul_rn(uaps::to_f32(src[off + i]), ab[i % hw] < thr ? 1.f : 0.f));
  }
}

// The vector path where x and out are both 16-byte aligned (out, a fresh
// allocation, always is; x may be a view with a storage offset), else the
// scalar loop for every element.
template <typename T>
cudaError_t dropout(const void* x, void* out, const long long* seed,
                    uint32_t n, unsigned long long threshold, float scale,
                    cudaStream_t s) {
  constexpr uint32_t kPer = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (xa % sizeof(T) != 0 || oa % sizeof(T) != 0) return cudaErrorInvalidValue;
  const uint32_t nvec = (xa % 16 == 0 && oa % 16 == 0) ? n / kPer : 0;
  // one pass: every thread takes kDropVecs vectors (or one scalar element)
  const unsigned long long per_block = nvec ? kThreads * kDropVecs : kThreads;
  const unsigned long long want = nvec ? nvec : n;
  const unsigned blocks =
      static_cast<unsigned>((want + per_block - 1) / per_block);
  dropout_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), seed, n, nvec,
      threshold, scale);
  return cudaGetLastError();
}

// The SMs of the current device, read once.
int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

// The vector path where the in-example count is a multiple of the vector
// and x and out are both 16-byte aligned, else one element a thread; the
// batch split into the fewest groups that give every SM two blocks.
template <typename T>
cudaError_t noise(const void* x, void* out, const long long* seed, int batch,
                  uint32_t inner, float span, float r, cudaStream_t s) {
  constexpr uint32_t kPer = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (xa % sizeof(T) != 0 || oa % sizeof(T) != 0) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const uint32_t nvec =
      (inner % kPer == 0 && xa % 16 == 0 && oa % 16 == 0) ? inner / kPer : 0;
  const unsigned bx = ((nvec ? nvec : inner) + kThreads - 1) / kThreads;
  const int want = static_cast<int>((2u * sms + bx - 1) / bx);
  const int groups = want < batch ? want : batch;
  const int per_ex = (batch + groups - 1) / groups;
  const dim3 grid(bx, (batch + per_ex - 1) / per_ex);
  noise_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                           static_cast<T*>(out), seed, inner,
                                           nvec, batch, per_ex, span, r);
  return cudaGetLastError();
}

// Pass 1 with mx zeroed first; the vector path where hw is a multiple of
// the vector and x is 16-byte aligned, else one pixel a unit. A block takes
// up to kAttGroups groups at once (the power of two at or above the count
// sets the block's width in units).
template <typename T>
cudaError_t fdrop_att(const void* x, float* att, unsigned* mx, int batch,
                      int c, uint32_t hw, float inv_c, cudaStream_t s) {
  constexpr uint32_t kPer = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (xa % sizeof(T) != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(mx, 0, sizeof(unsigned) * batch, s);
  if (err != cudaSuccess) return err;
  const uint32_t nvec = (hw % kPer == 0 && xa % 16 == 0) ? hw / kPer : 0;
  const int groups = (c + kGroup - 1) / kGroup;
  const int gy = groups < kAttGroups ? groups : kAttGroups;
  int span = 1;
  while (span < gy) span *= 2;
  const int vx = kAttThreads / span;
  const uint32_t units = nvec ? nvec : hw;
  const dim3 grid((units + vx - 1) / vx, batch);
  fdrop_att_kernel<T><<<grid, kAttThreads, 0, s>>>(
      static_cast<const T*>(x), att, mx, c, hw, nvec, gy, vx, inv_c);
  return cudaGetLastError();
}

// Pass 2; the vector path where hw is a multiple of the vector and src,
// out and att are 16-byte aligned, else one element a thread.
template <typename T>
cudaError_t fdrop_apply(const void* src, const float* att,
                        const unsigned* mx, const long long* seed, void* out,
                        int batch, int c, uint32_t hw, cudaStream_t s) {
  constexpr uint32_t kPer = 16 / sizeof(T);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const uintptr_t aa = reinterpret_cast<uintptr_t>(att);
  if (sa % sizeof(T) != 0 || oa % sizeof(T) != 0 || aa % 4 != 0)
    return cudaErrorInvalidValue;
  const uint32_t n_ex = static_cast<uint32_t>(c) * hw;
  const uint32_t nvec =
      (hw % kPer == 0 && sa % 16 == 0 && oa % 16 == 0 && aa % 16 == 0)
          ? n_ex / kPer
          : 0;
  const uint32_t per_block = nvec ? kThreads * kApplyVecs : kThreads;
  const dim3 grid(((nvec ? nvec : n_ex) + per_block - 1) / per_block, batch);
  fdrop_apply_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(src), att, mx, seed, static_cast<T*>(out), hw,
      n_ex, nvec);
  return cudaGetLastError();
}

bool bad_dtype(int dtype) { return dtype != uaps::kF32 && dtype != uaps::kBF16; }

bool bad_fdrop(int batch, int c, long long hw, int dtype) {
  return batch < 1 || batch > 65535 || c < 1 || hw < 1 ||
         static_cast<long long>(batch) * c * hw > 0xffffffffLL ||
         bad_dtype(dtype);
}

}  // namespace

// x, out: n contiguous elements of `dtype`; seed: one int64 on the device.
// An element is kept when bits(seed, i) < threshold (threshold <= 2^32).
extern "C" int uaps_dropout(const void* x, void* out, const void* seed,
                            long long n, unsigned long long threshold,
                            float scale, int dtype, void* stream) {
  if (n < 1 || n > 0xffffffffLL || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t n32 = static_cast<uint32_t>(n);
  return static_cast<int>(
      dtype == uaps::kF32
          ? dropout<float>(x, out, sd, n32, threshold, scale, s)
          : dropout<__nv_bfloat16>(x, out, sd, n32, threshold, scale, s));
}

// x, out: [batch, inner] contiguous, fewer than 2^32 elements; the noise
// depends on the inner index.
extern "C" int uaps_feature_noise(const void* x, void* out, const void* seed,
                                  int batch, long long inner, float span,
                                  float r, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || inner < 1 ||
      static_cast<long long>(batch) * inner > 0xffffffffLL || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t n = static_cast<uint32_t>(inner);
  return static_cast<int>(
      dtype == uaps::kF32
          ? noise<float>(x, out, sd, batch, n, span, r, s)
          : noise<__nv_bfloat16>(x, out, sd, batch, n, span, r, s));
}

// Feature dropout's pass 1. x: [batch, c, hw] contiguous, fewer than 2^32
// elements; att: [batch, hw] f32; mx: [batch] order keys of each example's
// max attention.
extern "C" int uaps_feature_dropout_att(const void* x, void* att, void* mx,
                                        int batch, int c, long long hw,
                                        float inv_c, int dtype,
                                        void* stream) {
  if (bad_fdrop(batch, c, hw, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  float* a = static_cast<float*>(att);
  unsigned* m = static_cast<unsigned*>(mx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t n = static_cast<uint32_t>(hw);
  return static_cast<int>(
      dtype == uaps::kF32
          ? fdrop_att<float>(x, a, m, batch, c, n, inv_c, s)
          : fdrop_att<__nv_bfloat16>(x, a, m, batch, c, n, inv_c, s));
}

// Pass 2: out = src * mask(att, mx, seed); src, out: [batch, c, hw]
// contiguous, one dtype; att, mx: pass 1's.
extern "C" int uaps_feature_dropout_apply(const void* src, const void* att,
                                          const void* mx, const void* seed,
                                          void* out, int batch, int c,
                                          long long hw, int dtype,
                                          void* stream) {
  if (bad_fdrop(batch, c, hw, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(att);
  const unsigned* m = static_cast<const unsigned*>(mx);
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t n = static_cast<uint32_t>(hw);
  return static_cast<int>(
      dtype == uaps::kF32
          ? fdrop_apply<float>(src, a, m, sd, out, batch, c, n, s)
          : fdrop_apply<__nv_bfloat16>(src, a, m, sd, out, batch, c, n, s));
}
