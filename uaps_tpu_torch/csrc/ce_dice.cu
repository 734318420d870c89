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
// The TPU kernel accumulates the stats across its sequential grid. Here the
// forward takes two passes in a fixed order, so the result is
// deterministic: each block of ce_dice_partial_kernel walks a fixed stride
// of pixels, sums its threads with warp shuffles and a fixed-order pass
// over its warps, and writes its [4, C] row of a scratch buffer (allocated
// by the wrapper with torch.empty); ce_dice_finalize_kernel then sums the
// rows, one block per statistic.
//
// What bounds it: ~10 flops and one exp per class and pixel against 4 C + 4
// bytes read (forward) or 8 C + 4 bytes moved (backward), so device-memory
// bandwidth. Consecutive threads take consecutive pixels, so each class's
// loads and stores are coalesced in the NCHW storage the strides describe;
// the per-pixel softmax stays in registers (C <= 8 is a template).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPartials = 1024;   // blocks of the forward's first pass

struct Strides {
  long long b, h, w, c;
};

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

template <int C>
__global__ void __launch_bounds__(kThreads)
    ce_dice_partial_kernel(const float* __restrict__ lg, Strides st,
                           const int* __restrict__ lab,
                           float* __restrict__ part, long long n, int h,
                           int w) {
  constexpr int N = 4 * C;
  __shared__ float sm[kWarps][N];
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    float v[C], m, s;
    softmax_row<C>(lg, st, i, h, w, v, m, s);
    const int label = lab[i];
    float logit_y = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float yc = label == c ? 1.f : 0.f;
      const float pc = expf(v[c] - m) / s;
      logit_y += yc * v[c];
      acc[c] += pc * yc;
      acc[C + c] += pc;
      acc[2 * C + c] += yc;
    }
    acc[3 * C] += logf(s) + m - logit_y;
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float a = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) sm[warp][j] = a;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += sm[k][threadIdx.x];
    part[static_cast<size_t>(blockIdx.x) * N + threadIdx.x] = sum;
  }
}

// stats[j] = sum over blocks of part[block, j]; one block per statistic
__global__ void __launch_bounds__(kThreads)
    ce_dice_finalize_kernel(const float* __restrict__ part,
                            float* __restrict__ stats, int n_part, int n_stat) {
  __shared__ float sm[kThreads];
  const int j = blockIdx.x;
  float v = 0.f;
  for (int k = threadIdx.x; k < n_part; k += kThreads)
    v += part[static_cast<size_t>(k) * n_stat + j];
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) sm[threadIdx.x] += sm[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[j] = sm[0];
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

int partial_blocks(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxPartials ? want : kMaxPartials);
}

template <int C>
cudaError_t fwd(const float* lg, Strides st, const int* lab, float* part,
                float* stats, long long n, int h, int w, cudaStream_t s) {
  const int blocks = partial_blocks(n);
  ce_dice_partial_kernel<C><<<blocks, kThreads, 0, s>>>(lg, st, lab, part, n,
                                                        h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_dice_finalize_kernel<<<4 * C, kThreads, 0, s>>>(part, stats, blocks,
                                                     4 * C);
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

// The scratch `part` of the forward needs kMaxPartials * 4 * C floats.
extern "C" int uaps_ce_dice_max_partials() { return kMaxPartials; }

// logits: f32 [B, H, W, C] with element strides (sb, sh, sw, sc); labels
// int32 [B, H, W] contiguous; stats f32 [4, C]. 1 <= C <= 8.
extern "C" int uaps_ce_dice_fwd(const void* logits, long long sb,
                                long long sh, long long sw, long long sc,
                                const void* labels, void* part, void* stats,
                                int batch, int h, int w, int c,
                                void* stream) {
  if (batch < 1 || h < 1 || w < 1 || c < 1 || c > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{sb, sh, sw, sc};
  const float* lg = static_cast<const float*>(logits);
  const int* lab = static_cast<const int*>(labels);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(stats);
  const long long n = static_cast<long long>(batch) * h * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 1: err = fwd<1>(lg, st, lab, p, out, n, h, w, s); break;
    case 2: err = fwd<2>(lg, st, lab, p, out, n, h, w, s); break;
    case 3: err = fwd<3>(lg, st, lab, p, out, n, h, w, s); break;
    case 4: err = fwd<4>(lg, st, lab, p, out, n, h, w, s); break;
    case 5: err = fwd<5>(lg, st, lab, p, out, n, h, w, s); break;
    case 6: err = fwd<6>(lg, st, lab, p, out, n, h, w, s); break;
    case 7: err = fwd<7>(lg, st, lab, p, out, n, h, w, s); break;
    default: err = fwd<8>(lg, st, lab, p, out, n, h, w, s); break;
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
