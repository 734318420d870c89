// Fused cross-entropy + soft-Dice statistics and their logit gradient, for
// Hopper (sm_90a).
//
// Replaces uaps_tpu/pallas/ce_dice.py: the forward kernel _run_fwd
// (_fwd_kernel) and the backward _vjp_bwd (_bwd_kernel). Logits are f32 in
// JAX's public layout [B, H, W, C], read through their element strides (the
// port's logits head writes NCHW, so the model hands over a permuted view
// and no transpose is copied); labels are int32 [B, H, W], contiguous.
//
//   forward  per pixel p = softmax(logits), y = one_hot(label) (a label
//            outside [0, C) is all-zero, as in the JAX kernel); sums over
//            every pixel of nll = log(sum_c exp(x_c)) - x_label and, per
//            class, I_c = sum p_c y_c, P_c = sum p_c, Y_c = sum y_c, into
//            stats [4, C] f32 (rows I, P, Y; row 3 holds the nll sum in
//            column 0). The scalar combine (CE = nll / N, Dice = 1 -
//            mean_c 2 I_c / (P_c + Y_c + 1e-7)) is the caller's, as in JAX.
//   backward dlogits = gce (p - y) + p (q - sum_c q_c p_c) with
//            q_c = qa_c y_c + qb_c; qa, qb [C] and gce [1] are formed by
//            the caller from the stats and the two cotangents, as at
//            ce_dice.py:163-171. dlogits has the logits' strides.
//
// The TPU kernel accumulates the stats across its sequential grid. Here one
// launch of ce_dice_fwd_kernel reduces every pixel in a fixed order, so the
// result is deterministic (the same bits on every call): each block sums
// its pixels with warp shuffles and a fixed-order pass over its warps and
// writes its [4, C] partial; the last block to finish (an atomic ticket
// taken after __threadfence) sums every partial in block order and writes
// the stats. The ticket wraps to 0 in that last atomicInc, so no call
// needs a memset and a CUDA graph can replay the kernel unchanged. The
// ticket and the partials live in one per-device scratch buffer that the
// wrapper allocates once: calls that share it must be ordered, as calls
// on one stream are.
//
// What bounds it: ~10 flops and one exp per pixel and class, one
// reciprocal and one log per pixel, against 4 C + 4 bytes read per pixel (forward: 21.0 MB at the neu step's
// [16, 256, 256, 4], 0.0063 ms at 3.35 TB/s), or 8 C + 4 bytes moved
// (backward), so device-memory bandwidth and, for a call this short, the
// fixed cost of a launch. What the forward's design does: one launch a
// call (the partials stay in L2); a grid of (pixel blocks of one example,
// examples strided over blockIdx.y) with a 32-bit index inside the
// example, so a planar view (each class plane of an example dense: sw == 1,
// sh == W) finds a pixel at b sb + c sc + i with no division; on that
// layout, when the planes and labels are 16-byte aligned and H W, sb and
// sc are multiples of 4, a thread takes 4 consecutive pixels with one
// float4 a class plane and one int4 of labels, all issued before the
// first use; each exp is computed once and each pixel takes one
// reciprocal. Any other view (ragged H W, a storage offset, NHWC storage)
// takes one pixel a thread in the same kernel (a 32-bit divmod by W for a
// non-planar view) with the same arithmetic. The backward (one thread a
// pixel over the flat index, softmax_row) is the design this replaced for
// the forward. Consecutive threads take consecutive pixels, so each
// class's loads and stores are coalesced in the NCHW storage the strides
// describe; the per-pixel softmax stays in registers (C <= 8 is a
// template).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;   // pixels a thread takes on the vector path
// the forward's blocks: about 2 on each of the H100's 132 SMs (fewer
// partials for the last block to sum; 1, 3 and 4 a SM timed slower at the
// neu step's shape), and never more partials than the scratch holds (the
// batch is strided over blockIdx.y, so any batch size fits)
constexpr int kTargetBlocks = 2 * 132;
constexpr int kMaxPartials = 1024;
constexpr int kMaxRow = 4 * 8;   // a partial's row: 4 C floats at C = 8

struct Strides {
  long long b, h, w, c;
};

// softmax inputs of pixel i of the flat [B, H, W] grid (the backward's)
template <int C>
__device__ __forceinline__ void softmax_row(const float* __restrict__ lg,
                                            const Strides& st, long long i,
                                            int h, int w, float (&v)[C],
                                            float& m, float& s) {
  const int x = static_cast<int>(i % w);
  const long long r = i / w;
  const int y = static_cast<int>(r % h);
  const long long b = r / h;
  const float* p = lg + b * st.b + y * st.h + x * st.w;
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = p[c * st.c];
  m = v[0];
#pragma unroll
  for (int c = 1; c < C; ++c) m = fmaxf(m, v[c]);
  s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s += expf(v[c] - m);
}

// The forward's view of the logits: the example stride in 64 bits, the
// in-example strides in 32 (the entry point checks that every offset
// inside an example fits), and the path it takes.
struct View {
  long long sb;
  int sh, sw, sc;
  int w, hw, batch;
  int planar;   // sw == 1 and sh == W: pixel i of an example at c sc + i
  int vec;      // planar, 16-byte aligned planes and labels: kVec pixels
};

// one pixel's terms into acc: I_c, P_c, Y_c at c, C + c, 2 C + c and the
// nll at 3 C; each exp once, one reciprocal
template <int C>
__device__ __forceinline__ void add_pixel(const float (&v)[C], int label,
                                          float (&acc)[3 * C + 1]) {
  float m = v[0];
#pragma unroll
  for (int c = 1; c < C; ++c) m = fmaxf(m, v[c]);
  float e[C], s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    e[c] = expf(v[c] - m);
    s += e[c];
  }
  const float inv = 1.f / s;
  float logit_y = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float yc = label == c ? 1.f : 0.f;
    const float pc = e[c] * inv;
    logit_y += yc * v[c];
    acc[c] += pc * yc;
    acc[C + c] += pc;
    acc[2 * C + c] += yc;
  }
  acc[3 * C] += logf(s) + m - logit_y;
}

// v summed over the block in a fixed order (a shuffle tree in each warp,
// then the warps in order): thread j < K returns the sum of v[j], the
// others 0. Ends after a __syncthreads, so sm is free again only after
// the next one.
template <int K>
__device__ __forceinline__ float block_sum(const float (&v)[K],
                                           float (&sm)[kWarps][K]) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float a = v[j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) sm[warp][j] = a;
  }
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x < K) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += sm[k][threadIdx.x];
  }
  return sum;
}

// Grid (blocks over an example's units, blocks over the batch). part holds
// one row of 4 C floats a block, ticket the count of blocks done.
template <int C>
__global__ void __launch_bounds__(kThreads)
    ce_dice_fwd_kernel(const float* __restrict__ lg, View v,
                       const int* __restrict__ lab, float* __restrict__ part,
                       unsigned* __restrict__ ticket,
                       float* __restrict__ stats) {
  constexpr int K = 3 * C + 1;   // the accumulated stats (row 3: the nll)
  constexpr int R = 4 * C;
  __shared__ float sm[kWarps][K];
  __shared__ bool last;
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  for (int b = blockIdx.y; b < v.batch; b += gridDim.y) {
    const float* x = lg + b * v.sb;
    const int* y = lab + static_cast<long long>(b) * v.hw;
    if (v.vec) {
      const float4* xv = reinterpret_cast<const float4*>(x);
      const int4* yv = reinterpret_cast<const int4*>(y);
      const int sc4 = v.sc / kVec;
      for (int i = first; i < v.hw / kVec; i += stride) {
        float4 q[C];
#pragma unroll
        for (int c = 0; c < C; ++c) q[c] = xv[c * sc4 + i];
        const int4 l = yv[i];
        float p0[C], p1[C], p2[C], p3[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          p0[c] = q[c].x;
          p1[c] = q[c].y;
          p2[c] = q[c].z;
          p3[c] = q[c].w;
        }
        add_pixel<C>(p0, l.x, acc);
        add_pixel<C>(p1, l.y, acc);
        add_pixel<C>(p2, l.z, acc);
        add_pixel<C>(p3, l.w, acc);
      }
    } else {
      for (int i = first; i < v.hw; i += stride) {
        int off = i;
        if (!v.planar) {
          const int r = i / v.w;
          off = r * v.sh + (i - r * v.w) * v.sw;
        }
        float p[C];
#pragma unroll
        for (int c = 0; c < C; ++c) p[c] = x[off + c * v.sc];
        add_pixel<C>(p, y[i], acc);
      }
    }
  }
  const float sum = block_sum<K>(acc, sm);
  const unsigned blocks = gridDim.x * gridDim.y;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x < K) {
    part[blk * R + threadIdx.x] = sum;
    __threadfence();   // the partial reaches L2 before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the count wraps to 0 at the last block, ready for the next call
    last = atomicInc(ticket, blocks - 1) == blocks - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // every partial, in block order, read from L2
  float tot[K];
#pragma unroll
  for (int j = 0; j < K; ++j) tot[j] = 0.f;
  for (int k = threadIdx.x; k < static_cast<int>(blocks); k += kThreads) {
#pragma unroll
    for (int j = 0; j < K; ++j) tot[j] += __ldcg(part + k * R + j);
  }
  const float total = block_sum<K>(tot, sm);
  if (threadIdx.x < R) stats[threadIdx.x] = total;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    ce_dice_bwd_kernel(const float* __restrict__ lg, Strides st,
                       const int* __restrict__ lab,
                       const float* __restrict__ q,
                       const float* __restrict__ gce_ptr,
                       float* __restrict__ out, long long n, int h, int w) {
  float qa[C], qb[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qa[c] = q[c];
    qb[c] = q[C + c];
  }
  const float gce = *gce_ptr;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    float v[C], m, s;
    softmax_row<C>(lg, st, i, h, w, v, m, s);
    const int label = lab[i];
    float p[C], qc[C];
    float qdot = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float yc = label == c ? 1.f : 0.f;
      p[c] = expf(v[c] - m) / s;
      qc[c] = qa[c] * yc + qb[c];
      qdot += qc[c] * p[c];
    }
    const int x = static_cast<int>(i % w);
    const long long r = i / w;
    const int y = static_cast<int>(r % h);
    const long long b = r / h;
    float* o = out + b * st.b + y * st.h + x * st.w;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float yc = label == c ? 1.f : 0.f;
      o[c * st.c] = gce * (p[c] - yc) + p[c] * (qc[c] - qdot);
    }
  }
}

template <int C>
cudaError_t fwd(const float* lg, const View& v, const int* lab, float* part,
                unsigned* ticket, float* stats, cudaStream_t s) {
  const int units = v.vec ? v.hw / kVec : v.hw;
  const int gy = v.batch < kMaxPartials ? v.batch : kMaxPartials;
  int gx = kTargetBlocks / gy;
  const int need = (units + kThreads - 1) / kThreads;
  if (gx > need) gx = need;
  if (gx < 1) gx = 1;
  ce_dice_fwd_kernel<C><<<dim3(gx, gy), kThreads, 0, s>>>(lg, v, lab, part,
                                                          ticket, stats);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd(const float* lg, Strides st, const int* lab, const float* q,
                const float* gce, float* out, long long n, int h, int w,
                cudaStream_t s) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  ce_dice_bwd_kernel<C><<<blocks, kThreads, 0, s>>>(lg, st, lab, q, gce, out,
                                                    n, h, w);
  return cudaGetLastError();
}

}  // namespace

// The forward's scratch, in 32-bit words: kMaxPartials rows of kMaxRow
// floats, then the ticket, which must be 0 before the first call (the
// wrapper allocates it zeroed, once a device; each call leaves it 0).
extern "C" int uaps_ce_dice_scratch_words() {
  return kMaxPartials * kMaxRow + 1;
}

// logits: f32 [B, H, W, C] with element strides (sb, sh, sw, sc), every
// offset inside an example below 2^31; labels int32 [B, H, W] contiguous;
// scratch: uaps_ce_dice_scratch_words() words; stats f32 [4, C]. 1 <= C
// <= 8.
extern "C" int uaps_ce_dice_fwd(const void* logits, long long sb,
                                long long sh, long long sw, long long sc,
                                const void* labels, void* scratch,
                                void* stats, int batch, int h, int w, int c,
                                void* stream) {
  const long long lim = 0x7fffffffLL;
  if (batch < 1 || h < 1 || w < 1 || c < 1 || c > 8 || sb < 0 || sh < 0 ||
      sw < 0 || sc < 0 || sh > lim || sw > lim || sc > lim ||
      static_cast<long long>(h) * w > lim ||
      (h - 1) * sh + (w - 1) * sw + (c - 1) * sc > lim)
    return static_cast<int>(cudaErrorInvalidValue);
  View v{};
  v.sb = sb;
  v.sh = static_cast<int>(sh);
  v.sw = static_cast<int>(sw);
  v.sc = static_cast<int>(sc);
  v.w = w;
  v.hw = h * w;
  v.batch = batch;
  v.planar = sw == 1 && sh == w;
  v.vec = v.planar && v.hw % kVec == 0 && sb % kVec == 0 &&
          sc % kVec == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  const float* lg = static_cast<const float*>(logits);
  const int* lab = static_cast<const int*>(labels);
  float* part = static_cast<float*>(scratch);
  unsigned* ticket =
      static_cast<unsigned*>(scratch) + kMaxPartials * kMaxRow;
  float* out = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 1: err = fwd<1>(lg, v, lab, part, ticket, out, s); break;
    case 2: err = fwd<2>(lg, v, lab, part, ticket, out, s); break;
    case 3: err = fwd<3>(lg, v, lab, part, ticket, out, s); break;
    case 4: err = fwd<4>(lg, v, lab, part, ticket, out, s); break;
    case 5: err = fwd<5>(lg, v, lab, part, ticket, out, s); break;
    case 6: err = fwd<6>(lg, v, lab, part, ticket, out, s); break;
    case 7: err = fwd<7>(lg, v, lab, part, ticket, out, s); break;
    default: err = fwd<8>(lg, v, lab, part, ticket, out, s); break;
  }
  return static_cast<int>(err);
}

// dlogits: f32 with the logits' strides; q f32 [2C] (qa then qb), gce f32
// [1], both on the device.
extern "C" int uaps_ce_dice_bwd(const void* logits, long long sb,
                                long long sh, long long sw, long long sc,
                                const void* labels, const void* q,
                                const void* gce, void* dlogits, int batch,
                                int h, int w, int c, void* stream) {
  if (batch < 1 || h < 1 || w < 1 || c < 1 || c > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{sb, sh, sw, sc};
  const float* lg = static_cast<const float*>(logits);
  const int* lab = static_cast<const int*>(labels);
  const float* qq = static_cast<const float*>(q);
  const float* g = static_cast<const float*>(gce);
  float* out = static_cast<float*>(dlogits);
  const long long n = static_cast<long long>(batch) * h * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 1: err = bwd<1>(lg, st, lab, qq, g, out, n, h, w, s); break;
    case 2: err = bwd<2>(lg, st, lab, qq, g, out, n, h, w, s); break;
    case 3: err = bwd<3>(lg, st, lab, qq, g, out, n, h, w, s); break;
    case 4: err = bwd<4>(lg, st, lab, qq, g, out, n, h, w, s); break;
    case 5: err = bwd<5>(lg, st, lab, qq, g, out, n, h, w, s); break;
    case 6: err = bwd<6>(lg, st, lab, qq, g, out, n, h, w, s); break;
    case 7: err = bwd<7>(lg, st, lab, qq, g, out, n, h, w, s); break;
    default: err = bwd<8>(lg, st, lab, qq, g, out, n, h, w, s); break;
  }
  return static_cast<int>(err);
}
