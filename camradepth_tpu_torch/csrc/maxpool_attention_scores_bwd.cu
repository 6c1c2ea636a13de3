// Backward of the max-pool attention scores for Hopper (sm_90a).
//
// The TPU kernel camradepth_tpu/ops/attention_pallas.py `_scores_fwd_impl`
// (:66-104, pl.pallas_call at :76) has no Pallas backward: the JAX package
// differentiates the scores through the custom VJP of
// camradepth_tpu/ops/attention.py:79-97 (`_scores_bwd`), an XLA gather and
// scatter-add over the argmax indices the forward saved. This file is that
// VJP on the card, fed by the forward kernel's `_argmax` entry points
// (maxpool_attention_scores.cu). For q [B, N, C], k [B, M, C] (C = heads *
// d, d <= 64), amax [B, heads, N] (int32), the cotangent g [B, N] (fp32)
// and gs[b, n] = g[b, n] * scale in fp32:
//
//   dq[b, n, h*d + i] = gs[b, n] * k[b, amax[b, h, n], h*d + i]     (gather)
//   dk[b, m, h*d + i] = sum over n with amax[b, h, n] = m of
//                       gs[b, n] * q[b, n, h*d + i]           (scatter-add)
//
// each product and the sums in fp32, and both cast to the q/k dtype.
//
// Bound on the H100: bytes (q, k, amax and g read once, dq and dk written
// once; 0.039 ms per bf16 batch-2 microbatch of `base` at 416x800, 34
// calls, most of them a few MB).
//
// Two launches, no float atomics, deterministic.
// Pass 1 (gather_partial_kernel), a block per (chunk of `tokens` tokens,
//   head, image), all 256 threads busy: it stages the chunk's q head slice
//   in shared memory by 16-byte cp.async; writes dq for its tokens (16-byte
//   gathers of k's rows, 16-byte stores) while the copy is in flight;
//   sorts its tokens by key, stably (ranks by warp match, the warps in
//   token order; a block scan of the key counts), so that each key hit in
//   the chunk gets a slot and a segment of its tokens in token order; then
//   a warp per slot sums gs * q over its segment, lanes over the d
//   channels, and writes one fp32 partial row [d] per slot, plus the
//   chunk's [M] slot map (-1: no hit). Only the keys a chunk hits get a
//   row: where one key takes every token (a skewed argmax) a chunk writes
//   one row, and the sum stays spread over the chunks.
// Pass 2 (dk_sum_kernel), a warp per (key, head, image): dk is the sum of
//   the key's partial rows over the chunks, in chunk order, 8 rows in
//   flight at once.
// Both are programmatic dependent launches: a pass's blocks are scheduled
// while the kernel ahead of it in the stream ends, and wait on the card
// (griddepcontrol.wait) before they touch device memory.
// So dk's sum order is: within a chunk the tokens in token order, from
// +0; then the chunks' sums in chunk order, from +0. The launch (tokens
// per chunk, chunks, slots, pass 1's shared bytes) is the wrapper's plan
// (ops/attention.py `scores_backward_plan`), taken as given; it is fixed
// for a shape and a card, so two launches give the same bits.
// What bounds it on the H100 is latency, not bytes: most of the 34 calls
// a microbatch move under 3 MB, and each waits on a chain of dependent
// loads and barriers in both passes (PERF.md §6).

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;  // per block on the H100

__device__ __forceinline__ int align16(int v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ unsigned word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// element e of 16 bytes of T, in fp32 (e a compile-time index)
__device__ __forceinline__ float elem(const uint4& w, int e, float*) {
  return __uint_as_float(word(w, e));
}
__device__ __forceinline__ float elem(const uint4& w, int e,
                                      __nv_bfloat16*) {
  const unsigned u = word(w, e / 2);
  return __uint_as_float(e % 2 ? u & 0xffff0000u : u << 16);
}

// s * each element of 16 bytes of T, rounded to T
__device__ __forceinline__ uint4 scale_pack(const uint4& w, float s,
                                            float* tag) {
  return make_uint4(__float_as_uint(__fmul_rn(s, elem(w, 0, tag))),
                    __float_as_uint(__fmul_rn(s, elem(w, 1, tag))),
                    __float_as_uint(__fmul_rn(s, elem(w, 2, tag))),
                    __float_as_uint(__fmul_rn(s, elem(w, 3, tag))));
}
__device__ __forceinline__ uint4 scale_pack(const uint4& w, float s,
                                            __nv_bfloat16* tag) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = __bfloat16_as_ushort(
        __float2bfloat16_rn(__fmul_rn(s, elem(w, 2 * i, tag))));
    const unsigned hi = __bfloat16_as_ushort(
        __float2bfloat16_rn(__fmul_rn(s, elem(w, 2 * i + 1, tag))));
    u[i] = lo | hi << 16;
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// grid (chunks, heads, B)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const int* __restrict__ amax,
                          const float* __restrict__ g, T* __restrict__ dq,
                          float* __restrict__ partial,
                          int* __restrict__ slotmap, int N, int M, int C,
                          int heads, int tokens, int slots, float scale) {
  constexpr int V = 16 / sizeof(T);
  // in this order: q slice, segments, scaled cotangents, keys, sorted
  // order, per-key offsets and slots, the scan's warp totals
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = C / heads;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n0 = chunk * tokens, nt = min(tokens, N - n0);
  T* const qs = reinterpret_cast<T*>(smem);  // [nt][d]
  int2* const seg = reinterpret_cast<int2*>(
      smem + align16(tokens * d * static_cast<int>(sizeof(T))));
  float* const gs = reinterpret_cast<float*>(seg + slots);  // [tokens]
  int* const am = reinterpret_cast<int*>(gs + tokens);      // [tokens]
  int* const order = am + tokens;  // [tokens]: sorted position -> token
  int* const start = order + tokens;  // [M]: count, then first position
  int* const slot = start + M;        // [M]: slot of a hit key, else -1
  int* const scan = slot + M;         // [2][kWarps]

  // launched while the stream's previous kernel ends (programmatic
  // dependent launch): wait for it before touching device memory; pass 2
  // may be scheduled from now on, and waits for this grid to end
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tok0 = static_cast<long long>(b) * N + n0;
  const T* __restrict__ qb = q + tok0 * C + h * d;
  const T* __restrict__ kb = k + static_cast<long long>(b) * M * C + h * d;
  T* __restrict__ dqb = dq + tok0 * C + h * d;
  const bool vec = d % V == 0 && C % V == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(dq)) % 16 == 0;
  const int per = d / V;  // vectors per token (vec)

  // 1. the chunk's q head slice, in flight while dq and the sort run
  if (vec) {
    for (int v = tid; v < nt * per; v += kThreads) {
      const int t = v / per, j = v - t * per;
      cp_async16(smem_addr(qs + t * d + j * V),
                 qb + static_cast<long long>(t) * C + j * V, true);
    }
  } else {
    for (int e = tid; e < nt * d; e += kThreads) {
      const int t = e / d;
      qs[e] = qb[static_cast<long long>(t) * C + e - t * d];
    }
  }
  cp_async_commit();

  // 2. keys and scaled cotangents of the chunk; key counts start at 0
  int key = 0;
  if (tid < nt) {
    key = amax[(static_cast<long long>(b) * heads + h) * N + n0 + tid];
    am[tid] = key;
    gs[tid] = __fmul_rn(g[tok0 + tid], scale);
  }
  for (int m = tid; m < M; m += kThreads) start[m] = 0;
  __syncthreads();

  // 3. dq: the gather
  if (vec) {
    for (int v = tid; v < nt * per; v += kThreads) {
      const int t = v / per, j = v - t * per;
      const uint4 w = *reinterpret_cast<const uint4*>(
          kb + static_cast<long long>(am[t]) * C + j * V);
      *reinterpret_cast<uint4*>(dqb + static_cast<long long>(t) * C +
                                j * V) =
          scale_pack(w, gs[t], static_cast<T*>(nullptr));
    }
  } else {
    for (int e = tid; e < nt * d; e += kThreads) {
      const int t = e / d, i = e - t * d;
      dqb[static_cast<long long>(t) * C + i] = from_f32<T>(__fmul_rn(
          gs[t], to_f32(kb[static_cast<long long>(am[t]) * C + i])));
    }
  }

  // 4. stable ranks: a token's rank among the chunk's earlier tokens of
  // its key; warps in token order, each adding its counts after its ranks
  int rank = 0;
  const int twarps = (nt + 31) / 32;
  for (int w = 0; w < twarps; ++w) {
    if (warp == w) {
      const bool live = tid < nt;
      const unsigned active = __ballot_sync(0xffffffffu, live);
      if (live) {
        const unsigned peers = __match_any_sync(active, key);
        const int before = __popc(peers & ((1u << lane) - 1u));
        rank = start[key] + before;
        __syncwarp(active);
        if (before == 0) start[key] += __popc(peers);
      }
    }
    __syncthreads();
  }

  // 5. exclusive scan of the counts over the keys (first sorted position)
  // and of the hit keys (slots); thread tid takes keys [mb, me)
  const int kper = (M + kThreads - 1) / kThreads;
  const int mb = min(M, tid * kper), me = min(M, mb + kper);
  int csum = 0, hsum = 0;
  for (int m = mb; m < me; ++m) {
    const int c = start[m];
    csum += c;
    hsum += c > 0;
  }
  int cinc = csum, hinc = hsum;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int cu = __shfl_up_sync(0xffffffffu, cinc, o);
    const int hu = __shfl_up_sync(0xffffffffu, hinc, o);
    if (lane >= o) {
      cinc += cu;
      hinc += hu;
    }
  }
  if (lane == 31) {
    scan[warp] = cinc;
    scan[kWarps + warp] = hinc;
  }
  __syncthreads();
  int cx = cinc - csum, hx = hinc - hsum, nslots = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      cx += scan[w];
      hx += scan[kWarps + w];
    }
    nslots += scan[kWarps + w];
  }
  for (int m = mb; m < me; ++m) {
    const int c = start[m];
    start[m] = cx;
    slot[m] = c > 0 ? hx : -1;
    if (c > 0) seg[hx++] = make_int2(cx, c);
    cx += c;
  }
  __syncthreads();

  // 6. the sorted order, and the chunk's slot map
  if (tid < nt) order[start[key] + rank] = tid;
  int* const sm =
      slotmap + ((static_cast<long long>(b) * heads + h) * gridDim.x +
                 chunk) * M;
  for (int m = tid; m < M; m += kThreads) sm[m] = slot[m];
  cp_async_wait<0>();
  __syncthreads();

  // 7. a warp per slot: gs * q summed over its segment in token order
  float* const pb =
      partial + ((static_cast<long long>(b) * heads + h) * gridDim.x +
                 chunk) * slots * d;
  for (int s = warp; s < nslots; s += kWarps) {
    const int2 sg = seg[s];
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int i = 0; i < sg.y; ++i) {
      const int t = order[sg.x + i];
      const float gv = gs[t];
      if (lane < d)
        a0 = __fadd_rn(a0, __fmul_rn(gv, to_f32(qs[t * d + lane])));
      if (lane + 32 < d)
        a1 = __fadd_rn(a1, __fmul_rn(gv, to_f32(qs[t * d + lane + 32])));
    }
    if (lane < d) pb[s * d + lane] = a0;
    if (lane + 32 < d) pb[s * d + lane + 32] = a1;
  }
}

// grid (ceil(M / kWarps), heads, B): a warp per key
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dk_sum_kernel(const float* __restrict__ partial,
                  const int* __restrict__ slotmap, T* __restrict__ dk, int M,
                  int C, int heads, int chunks, int slots) {
  constexpr int kAhead = 8;  // partial rows in flight per warp
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const int d = C / heads, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * heads + h;
  // launched while pass 1 runs (programmatic dependent launch): wait here
  // until pass 1 has finished and its partials and slot map are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int* __restrict__ sm = slotmap + bh * chunks * M + m;
  const float* __restrict__ pb = partial + bh * chunks * slots * d;
  float a0 = 0.f, a1 = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    // the slots of 32 chunks, a lane each; then their rows, kAhead at once
    const int mine =
        c0 + lane < chunks ? sm[static_cast<long long>(c0 + lane) * M] : -1;
    const int nc = min(32, chunks - c0);
    for (int j = 0; j < nc; j += kAhead) {
      float v0[kAhead], v1[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        // a chunk that missed the key adds +0, which leaves the sum as it
        // is (a sum from +0 is never -0)
        const int s = __shfl_sync(0xffffffffu, mine, j + u);
        const float* row =
            pb + (static_cast<long long>(c0 + j + u) * slots + max(s, 0)) * d;
        v0[u] = s >= 0 && lane < d ? row[lane] : 0.f;
        v1[u] = s >= 0 && lane + 32 < d ? row[lane + 32] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        a0 = __fadd_rn(a0, v0[u]);
        a1 = __fadd_rn(a1, v1[u]);
      }
    }
  }
  T* out = dk + (static_cast<long long>(b) * M + m) * C + h * d;
  if (lane < d) out[lane] = from_f32<T>(a0);
  if (lane + 32 < d) out[lane + 32] = from_f32<T>(a1);
}

template <typename T>
int launch(const void* q, const void* k, const void* amax, const void* g,
           void* dq, void* dk, void* partial, void* slotmap, int B, int N,
           int M, int C, int heads, int tokens, int chunks, int slots,
           int smem, float scale, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (N < 0 || M <= 0 || heads <= 0 || C % heads != 0 || C / heads > 64 ||
      tokens <= 0 || tokens > kThreads || B > 65535 || heads > 65535 ||
      chunks < 0 || static_cast<long long>(chunks) * tokens < N ||
      slots < (tokens < M ? tokens : M) || smem <= 0 || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  // Both passes are programmatic dependent launches: each may be scheduled
  // before the kernel ahead of it in the stream ends and waits for it on
  // the card, so that its launch latency overlaps that kernel's tail.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (chunks > 0) {
    cudaError_t err = allow_smem<gather_partial_kernel<T>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(chunks, heads, B);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    err = cudaLaunchKernelEx(
        &cfg, gather_partial_kernel<T>, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const int*>(amax),
        static_cast<const float*>(g), static_cast<T*>(dq),
        static_cast<float*>(partial), static_cast<int*>(slotmap), N, M, C,
        heads, tokens, slots, scale);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cfg.gridDim = dim3((M + kWarps - 1) / kWarps, heads, B);
  cfg.dynamicSmemBytes = 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, dk_sum_kernel<T>, static_cast<const float*>(partial),
      static_cast<const int*>(slotmap), static_cast<T*>(dk), M, C, heads,
      chunks, slots));
}

}  // namespace

// (q, k, amax, g, dq, dk, partial [B][heads][chunks][slots][d] fp32,
//  slotmap [B][heads][chunks][M] int32, B, N, M, C, heads, then the plan:
//  tokens per chunk, chunks, slots per chunk, pass 1's shared bytes; scale,
//  stream)
extern "C" int maxpool_attention_scores_bwd_f32(
    const void* q, const void* k, const void* amax, const void* g, void* dq,
    void* dk, void* partial, void* slotmap, int B, int N, int M, int C,
    int heads, int tokens, int chunks, int slots, int smem, float scale,
    void* stream) {
  return launch<float>(q, k, amax, g, dq, dk, partial, slotmap, B, N, M, C,
                       heads, tokens, chunks, slots, smem, scale, stream);
}

extern "C" int maxpool_attention_scores_bwd_bf16(
    const void* q, const void* k, const void* amax, const void* g, void* dq,
    void* dk, void* partial, void* slotmap, int B, int N, int M, int C,
    int heads, int tokens, int chunks, int slots, int smem, float scale,
    void* stream) {
  return launch<__nv_bfloat16>(q, k, amax, g, dq, dk, partial, slotmap, B,
                               N, M, C, heads, tokens, chunks, slots, smem,
                               scale, stream);
}
