// Backward of the max-pool attention scores for Hopper (sm_90a).
//
// The TPU kernel camradepth_tpu/ops/attention_pallas.py `_scores_fwd_impl`
// (:66-104, pl.pallas_call at :76) has no Pallas backward: the JAX package
// differentiates the scores through the custom VJP of
// camradepth_tpu/ops/attention.py:79-97 (`_scores_bwd`), an XLA gather and
// scatter-add over the argmax indices the forward saved. This file is that
// VJP on the card, fed by the forward kernel's `_argmax` entry points
// (maxpool_attention_scores.cu). For q [B, N, C], k [B, M, C] (C = heads *
// d), amax [B, heads, N] (int32), the cotangent g [B, N] (fp32) and
// gs[b, n] = g[b, n] * scale in fp32:
//
//   dq[b, n, h*d + i] = gs[b, n] * k[b, amax[b, h, n], h*d + i]     (gather)
//   dk[b, m, h*d + i] = sum over n with amax[b, h, n] = m of
//                       gs[b, n] * q[b, n, h*d + i]           (scatter-add)
//
// each product and the sums in fp32, and both cast to the q/k dtype.
//
// dq: one thread per element, a gather from the argmax key's row.
// dk: deterministic, with no float atomics, so two runs give the same bits.
// Pass 1 (dk_partial_kernel): a block owns one image, a chunk of T tokens
// and a range of MC keys; its threads own channels, and each thread walks
// the chunk's tokens in order and adds gs * q into a [MC][C] fp32
// accumulator in shared memory for the tokens whose argmax falls in the
// block's keys (a column belongs to one thread, so no two threads write one
// address). The accumulator goes to a [B][chunks][M][C] fp32 workspace.
// Pass 2 (dk_reduce_kernel): dk is the sum of the chunks' partials, in chunk
// order. The sum per key runs over the tokens in token order within a chunk
// and the chunks in order, whatever the schedule. Heads of any d (40 too)
// need nothing special: a channel's head is c / d. The wrapper
// (ops/attention.py `scores_backward_plan`) sizes T, the chunks and MC.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ k, const int* __restrict__ amax,
              const float* __restrict__ g, T* __restrict__ dq, int N, int M,
              int C, int heads, int d, long long total, float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += stride) {
    const int c = static_cast<int>(e % C);
    const long long bn = e / C;  // b * N + n
    const int n = static_cast<int>(bn % N);
    const int b = static_cast<int>(bn / N);
    const int h = c / d;
    const int m = amax[(static_cast<long long>(b) * heads + h) * N + n];
    const float gs = __fmul_rn(g[bn], scale);
    dq[e] = from_f32<T>(
        __fmul_rn(gs, to_f32(k[(static_cast<long long>(b) * M + m) * C + c])));
  }
}

// grid (chunks, key ranges, B); dynamic shared memory MC * C floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dk_partial_kernel(const T* __restrict__ q, const int* __restrict__ amax,
                      const float* __restrict__ g, float* __restrict__ partial,
                      int N, int M, int C, int heads, int d, int tokens,
                      int MC, float scale) {
  extern __shared__ float acc[];  // [MC][C]
  const int chunk = blockIdx.x;
  const int m0 = blockIdx.y * MC;
  const int b = blockIdx.z;
  const int mc = min(MC, M - m0);
  const int n0 = chunk * tokens;
  const int n1 = min(N, n0 + tokens);
  for (int i = threadIdx.x; i < mc * C; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  const float* gb = g + static_cast<long long>(b) * N;
  const T* qb = q + static_cast<long long>(b) * N * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int* ab = amax + (static_cast<long long>(b) * heads + c / d) * N;
    for (int n = n0; n < n1; ++n) {
      const int m = ab[n] - m0;
      if (m >= 0 && m < mc) {
        const float gs = __fmul_rn(gb[n], scale);
        float* a = acc + m * C + c;
        *a = __fadd_rn(*a, __fmul_rn(gs, to_f32(qb[static_cast<long long>(n) *
                                                       C + c])));
      }
    }
  }
  __syncthreads();
  float* out = partial +
               ((static_cast<long long>(b) * gridDim.x + chunk) * M + m0) * C;
  for (int i = threadIdx.x; i < mc * C; i += kThreads) out[i] = acc[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dk_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dk,
                     int chunks, int M, int C, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long mc = static_cast<long long>(M) * C;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += stride) {
    const long long b = e / mc;
    const long long r = e - b * mc;
    const float* p = partial + b * chunks * mc + r;
    float s = p[0];
    for (int j = 1; j < chunks; ++j) s = __fadd_rn(s, p[j * mc]);
    dk[e] = from_f32<T>(s);
  }
}

int grid_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = 16LL * sm_count();
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T>
int launch(const void* q, const void* k, const void* amax, const void* g,
           void* dq, void* dk, void* partial, int B, int N, int M, int C,
           int heads, int tokens, int MC, float scale, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (M <= 0 || heads <= 0 || C % heads != 0 || tokens <= 0 || MC <= 0 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / heads;
  const int chunks = (N + tokens - 1) / tokens;
  const int ranges = (M + MC - 1) / MC;
  if (chunks > 2147483647 / 2 || ranges > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* a = static_cast<const int*>(amax);
  const auto* gt = static_cast<const float*>(g);
  auto* pt = static_cast<float*>(partial);
  const long long nq = static_cast<long long>(B) * N * C;
  dq_kernel<T><<<grid_for(nq), kThreads, 0, s>>>(
      kt, a, gt, static_cast<T*>(dq), N, M, C, heads, d, nq, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = MC * C * static_cast<int>(sizeof(float));
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    err = cudaFuncSetAttribute(dk_partial_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  dk_partial_kernel<T><<<dim3(chunks, ranges, B), kThreads, smem, s>>>(
      qt, a, gt, pt, N, M, C, heads, d, tokens, MC, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nk = static_cast<long long>(B) * M * C;
  dk_reduce_kernel<T><<<grid_for(nk), kThreads, 0, s>>>(
      pt, static_cast<T*>(dk), chunks, M, C, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (q, k, amax, g, dq, dk, partial [B][chunks][M][C] fp32, B, N, M, C, heads,
//  tokens per chunk, keys per block, scale, stream)
extern "C" int maxpool_attention_scores_bwd_f32(
    const void* q, const void* k, const void* amax, const void* g, void* dq,
    void* dk, void* partial, int B, int N, int M, int C, int heads,
    int tokens, int MC, float scale, void* stream) {
  return launch<float>(q, k, amax, g, dq, dk, partial, B, N, M, C, heads,
                       tokens, MC, scale, stream);
}

extern "C" int maxpool_attention_scores_bwd_bf16(
    const void* q, const void* k, const void* amax, const void* g, void* dq,
    void* dk, void* partial, int B, int N, int M, int C, int heads,
    int tokens, int MC, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, amax, g, dq, dk, partial, B, N, M, C,
                               heads, tokens, MC, scale, stream);
}
