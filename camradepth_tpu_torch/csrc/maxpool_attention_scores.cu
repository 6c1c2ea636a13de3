// Max-pool attention scores for Hopper (sm_90a).
//
// Replaces the TPU kernel camradepth_tpu/ops/attention_pallas.py
// `_scores_fwd_impl` (:66-104, pl.pallas_call at :76) with its body
// `_kernel` (:40-63). Contract (camradepth_tpu/ops/attention.py:32-48):
//
//   s[b, n] = sum_h max_m <q[b, n, h, :], k[b, m, h, :]> * scale
//
// for q [B, N, C] and k [B, M, C] (C = heads * d, d <= 64) in bf16 or fp32,
// and s [B, N] in fp32. The dot is taken in fp32 and the scale is applied
// before the max, as in the XLA function.
//
// Bound on the H100. At 416x800 a frame launches this 34 times (one per
// encoder block), with (N, M, C, heads) = (20800, 325, 64, 1) x3,
// (5200, 325, 128, 2) x10, (1300, 325, 160, 4) x16, (325, 325, 256, 8) x5:
// sum 2*N*M*C*depth = 9.36 GFLOP per frame, ~9.5 us on the tensor cores
// (989 TFLOP/s bf16). The bytes are about as many: q, k and s come to
// ~33 MB per frame in bf16 (a stage-1 launch reads 2.66 MB of q), ~10 us
// at 3.35 TB/s.
//
// bf16 design (scores_mma_kernel): q.k^T runs on the tensor cores,
// mma.sync m16n8k16 with fp32 accumulators; a bf16 product is exact in
// fp32, so only the order of the d-sum differs from the plain einsum. A
// block of 8 warps covers T tokens of one image (256 down to 16: the
// largest tile that still gives every SM a block, so that a small N, as
// stage 4's 325 tokens with 8 heads, takes tiles of 16). It stages its q
// tile and the image's keys, all heads at once, by cp.async into shared
// memory as bf16 rows [row][head][d16] (each head zero padded to d16, a
// multiple of 16, so a k-step never reads the next head; the row pitch is an odd number of 16-byte units, so
// ldmatrix reads without bank conflicts). Keys beyond what shared memory
// holds are taken in further chunks. The work items are (16 tokens, head)
// pairs, dealt to the warps in a fixed order: a warp loads its q fragments
// with ldmatrix once, runs over the keys 64 at a time (ldmatrix of the key
// rows as the "col" B operand; eight independent mma per k-step, so the
// tensor cores' latency is hidden within the warp), scales, masks keys >= M
// to -inf and keeps the running max in registers, then takes the max over
// the four lanes of a row with shuffles. The score tile never leaves
// registers, as the TPU kernel kept it in VMEM. Each head's row maxima meet
// in shared memory and one thread per token adds them in head order. The
// max is exact, so neither the token tile nor the key chunks change the
// result.
//
// fp32 design (scores_kernel): fp32 FMAs on the CUDA cores (the JAX dot is
// Precision.HIGHEST, attention_pallas.py:46-51, which TF32 would break). A
// block of kThreads threads covers kThreads / S tokens of one batch; the S
// threads of a token split the keys between them (S is 1, 2, 4 or 8, chosen
// so that a small N still gives the card enough blocks). For each head the
// block stages that head's keys, kKeys at a time, in shared memory as fp32
// rows padded to a multiple of 4, so a thread reads 4 key values with one
// 16-byte load. Each thread keeps its token's q_h in registers and runs four
// keys at a time, four independent FMA chains, keeping max(dot * scale).
// The S partial maxima of a token meet in shared memory and one thread adds
// their max over the heads, in head order. Every dot is summed in the same
// order whatever S is, so S does not change the result.
//
// In both, the head sum stays inside the block: blocks run in no fixed
// order, so nothing is carried across them the way the TPU grid carries it
// in out_ref (:57-63), and no float atomics are used.
//
// Argmax for the backward (the `_argmax` entry points, used when gradients
// are needed): both kernels also write int32 amax [B, heads, N], the key
// of each row's largest unscaled fp32 dot, the first one on a tie
// (camradepth_tpu/ops/attention.py:46-47 takes jnp.argmax before the
// scale). Each thread keeps the unscaled maximum with its key, and the
// partial maxima meet by value, then by the lower key. The score is that
// maximum times the scale: rounding is monotone, so fl(max v * scale) =
// max fl(v * scale) and the scores equal those of the inference launches
// bit for bit. The inference entry points compile the same templates with
// the argmax off: no argmax instruction and no argmax byte is in them.

#include <math_constants.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kKeys = 128;     // keys staged in shared memory at a time

// dot(q, row) over the first dp (<= DMAX, a multiple of 4) lanes, summed
// in lane order with fp32 FMAs.
template <int DMAX>
__device__ __forceinline__ float dot_row(const float (&qr)[DMAX],
                                         const float* row, int dp) {
  const float4* kr = reinterpret_cast<const float4*>(row);
  float dot = 0.f;
#pragma unroll
  for (int i4 = 0; i4 < DMAX / 4; ++i4) {
    if (4 * i4 < dp) {
      const float4 kv = kr[i4];
      dot = fmaf(qr[4 * i4 + 0], kv.x, dot);
      dot = fmaf(qr[4 * i4 + 1], kv.y, dot);
      dot = fmaf(qr[4 * i4 + 2], kv.z, dot);
      dot = fmaf(qr[4 * i4 + 3], kv.w, dot);
    }
  }
  return dot;
}

// (v, key) beats (bv, bkey): a larger value, or an equal one at a lower
// key (a key of -1 stands for none and never wins a tie).
__device__ __forceinline__ bool beats(float v, int key, float bv, int bkey) {
  return v > bv ||
         (v == bv && static_cast<unsigned>(key) < static_cast<unsigned>(bkey));
}

__device__ __forceinline__ void take(float& bv, int& bkey, float v, int key) {
  if (beats(v, key, bv, bkey)) {
    bv = v;
    bkey = key;
  }
}

template <typename T, int DMAX, bool ARG>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  float* __restrict__ out, int* __restrict__ amax, int N,
                  int M, int C, int heads, int d, int dp, int splits,
                  float scale) {
  __shared__ __align__(16) float ks[kKeys * DMAX];
  __shared__ float part[kThreads];
  __shared__ int part_key[ARG ? kThreads : 1];
  const int tokens = kThreads / splits;
  const int t = threadIdx.x % tokens;
  const int slice = threadIdx.x / tokens;
  const int b = blockIdx.y;
  const int n = blockIdx.x * tokens + t;
  const bool live = n < N;
  const T* qb = q + (static_cast<long long>(b) * N + (live ? n : 0)) * C;
  const T* kb = k + static_cast<long long>(b) * M * C;

  float acc = 0.f;
  for (int h = 0; h < heads; ++h) {
    float qr[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      qr[i] = (i < d) ? to_f32(qb[h * d + i]) : 0.f;
    }
    float mx = -CUDART_INF_F;
    int mkey = -1;  // ARG: mx is the unscaled maximum, at key mkey
    for (int m0 = 0; m0 < M; m0 += kKeys) {
      const int mt = min(kKeys, M - m0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int e = threadIdx.x; e < mt * dp; e += kThreads) {
        const int j = e / dp;
        const int i = e - j * dp;
        ks[e] = (i < d)
                    ? to_f32(kb[static_cast<long long>(m0 + j) * C + h * d + i])
                    : 0.f;
      }
      __syncthreads();
      // this thread's share of the chunk's keys: [j0, j1)
      const int per = (mt + splits - 1) / splits;
      const int j0 = min(slice * per, mt);
      const int j1 = min(j0 + per, mt);
      int j = j0;
      for (; j + 4 <= j1; j += 4) {
        const float d0 = dot_row(qr, ks + (j + 0) * dp, dp);
        const float d1 = dot_row(qr, ks + (j + 1) * dp, dp);
        const float d2 = dot_row(qr, ks + (j + 2) * dp, dp);
        const float d3 = dot_row(qr, ks + (j + 3) * dp, dp);
        if (ARG) {
          take(mx, mkey, d0, m0 + j);
          take(mx, mkey, d1, m0 + j + 1);
          take(mx, mkey, d2, m0 + j + 2);
          take(mx, mkey, d3, m0 + j + 3);
        } else {
          mx = fmaxf(mx, fmaxf(fmaxf(d0 * scale, d1 * scale),
                               fmaxf(d2 * scale, d3 * scale)));
        }
      }
      for (; j < j1; ++j) {
        const float dj = dot_row(qr, ks + j * dp, dp);
        if (ARG) {
          take(mx, mkey, dj, m0 + j);
        } else {
          mx = fmaxf(mx, dj * scale);
        }
      }
    }
    part[threadIdx.x] = mx;
    if (ARG) part_key[threadIdx.x] = mkey;
    __syncthreads();
    if (slice == 0) {
      float m = part[t];
      if (ARG) {
        int key = part_key[t];
        for (int s = 1; s < splits; ++s)
          take(m, key, part[s * tokens + t], part_key[s * tokens + t]);
        if (live)
          amax[(static_cast<long long>(b) * heads + h) * N + n] = max(key, 0);
        m = __fmul_rn(m, scale);  // not fused into the head sum's add
      } else {
        for (int s = 1; s < splits; ++s) m = fmaxf(m, part[s * tokens + t]);
      }
      acc += m;
    }
    // the next head's first chunk loop synchronises before `part` is
    // written again
  }
  if (live && slice == 0) out[static_cast<long long>(b) * N + n] = acc;
}

// ---- bf16 on the tensor cores -------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kKeyTiles = 4;  // 16-key tiles multiplied together (ILP)
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kSmemMax = 232448;  // 227 KB, what one block may use

// Rows r0 .. r0+rows-1 of x ([*, C] bf16) into dst[rows][pitch], each head
// zero padded from d to d16 channels; rows at or beyond `limit` are zero.
// 16-byte cp.async where the layout allows (vec: d and C multiples of 8,
// 16-byte aligned storage), element by element where not.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* x, int r0,
                                           int rows, int limit, int C, int d,
                                           int d16, int heads, int pitch,
                                           int vec) {
  const int vph = d16 / 8;        // 8-channel vectors per padded head
  const int vpr = heads * vph;    // per staged row
  for (int i = threadIdx.x; i < rows * vpr; i += kMmaThreads) {
    const int r = i / vpr;
    const int v = i - r * vpr;
    const int hh = v / vph;
    const int j0 = (v - hh * vph) * 8;
    const int row = r0 + r;
    const bool live = row < limit;
    const __nv_bfloat16* g =
        x + static_cast<long long>(live ? row : 0) * C + hh * d + j0;
    __nv_bfloat16* sdst = dst + r * pitch + v * 8;
    if (vec && j0 < d) {
      cp_async16(smem_addr(sdst), g, live);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sdst[j] = (live && j0 + j < d) ? g[j] : __float2bfloat16_rn(0.0f);
    }
  }
}

// max(v * scale) over the pairs of keys (key, key + 1) and (key + 8,
// key + 9) of one accumulator row, keys >= M masked to -inf.
__device__ __forceinline__ float row_max(float mx, float v0, float v1,
                                         float v8, float v9, int key, int M,
                                         float scale) {
  const float ninf = -CUDART_INF_F;
  v0 = key < M ? v0 * scale : ninf;
  v1 = key + 1 < M ? v1 * scale : ninf;
  v8 = key + 8 < M ? v8 * scale : ninf;
  v9 = key + 9 < M ? v9 * scale : ninf;
  return fmaxf(mx, fmaxf(fmaxf(v0, v1), fmaxf(v8, v9)));
}

// ARG: the unscaled values of one accumulator row's pairs of keys (key,
// key + 1) and (key + 8, key + 9), in key order, into (bv, bkey).
__device__ __forceinline__ void row_arg(float& bv, int& bkey, float v0,
                                        float v1, float v8, float v9, int key,
                                        int M) {
  if (key < M) take(bv, bkey, v0, key);
  if (key + 1 < M) take(bv, bkey, v1, key + 1);
  if (key + 8 < M) take(bv, bkey, v8, key + 8);
  if (key + 9 < M) take(bv, bkey, v9, key + 9);
}

// DK: k-steps of 16 per head (d16 = 16 * DK channels, d <= d16).
template <int DK, bool ARG>
__global__ void __launch_bounds__(kMmaThreads)
    scores_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      float* __restrict__ out, int* __restrict__ amax, int N,
                      int M, int C, int heads, int d, int pitch, int T, int MC,
                      int vec, float scale) {
  constexpr int d16 = 16 * DK;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [T][pitch]
  __nv_bfloat16* ks = qs + T * pitch;                          // [MC][pitch]
  float* s_max = reinterpret_cast<float*>(ks + MC * pitch);    // [items][16]
  int* s_key = reinterpret_cast<int*>(s_max + T * heads);  // ARG: [items][16]

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int groups = T / 16;
  const int items = groups * heads;  // (16 tokens, head), item = h*groups+tg
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * M * C;

  for (int i = threadIdx.x; i < items * 16; i += kMmaThreads) {
    s_max[i] = -CUDART_INF_F;
    if (ARG) s_key[i] = -1;
  }
  stage_rows(qs, q + (static_cast<long long>(b) * N + n0) * C, 0, T, N - n0,
             C, d, d16, heads, pitch, vec);
  // ldmatrix rows and columns of this lane: A (q) and B (keys)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int b_col = 8 * ((lane >> 3) & 1);

  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mc = min(MC, (M - m0 + 15) & ~15);
    if (m0 > 0) __syncthreads();  // every warp is done with the last chunk
    stage_rows(ks, kb, m0, mc, M, C, d, d16, heads, pitch, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int it = warp; it < items; it += kMmaWarps) {
      const int hh = it / groups;
      const int tg = it - hh * groups;
      unsigned a[DK][4];
#pragma unroll
      for (int s = 0; s < DK; ++s)
        ldmatrix_x4(a[s], smem_addr(qs + (tg * 16 + a_row) * pitch +
                                    hh * d16 + s * 16 + a_col));
      const __nv_bfloat16* kh = ks + b_row * pitch + hh * d16 + b_col;
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;  // rows g, g + 8
      int key0 = -1, key1 = -1;  // ARG: keys of the unscaled maxima
      // kKeyTiles tiles of 16 keys at a time: 2 * kKeyTiles independent
      // accumulators per k-step keep the tensor cores' pipeline full
      for (int j0 = 0; j0 < mc; j0 += 16 * kKeyTiles) {
        float c[kKeyTiles][2][4];
#pragma unroll
        for (int u = 0; u < kKeyTiles; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[u][0][e] = c[u][1][e] = 0.f;
#pragma unroll
        for (int s = 0; s < DK; ++s) {
          unsigned bb[kKeyTiles][4];  // keys j0+16u .. +7 and +8 .. +15
#pragma unroll
          for (int u = 0; u < kKeyTiles; ++u)
            if (j0 + 16 * u < mc)
              ldmatrix_x4(bb[u],
                          smem_addr(kh + (j0 + 16 * u) * pitch + s * 16));
#pragma unroll
          for (int u = 0; u < kKeyTiles; ++u) {
            if (j0 + 16 * u < mc) {
              mma_bf16(c[u][0], a[s], bb[u][0], bb[u][1]);
              mma_bf16(c[u][1], a[s], bb[u][2], bb[u][3]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kKeyTiles; ++u) {
          const int key = m0 + j0 + 16 * u + 2 * t;
          if (ARG) {
            if (j0 + 16 * u < mc) {
              row_arg(mx0, key0, c[u][0][0], c[u][0][1], c[u][1][0],
                      c[u][1][1], key, M);
              row_arg(mx1, key1, c[u][0][2], c[u][0][3], c[u][1][2],
                      c[u][1][3], key, M);
            }
          } else if (m0 + j0 + 16 * u + 16 <= M) {
            mx0 = fmaxf(mx0, fmaxf(fmaxf(c[u][0][0] * scale,
                                         c[u][0][1] * scale),
                                   fmaxf(c[u][1][0] * scale,
                                         c[u][1][1] * scale)));
            mx1 = fmaxf(mx1, fmaxf(fmaxf(c[u][0][2] * scale,
                                         c[u][0][3] * scale),
                                   fmaxf(c[u][1][2] * scale,
                                         c[u][1][3] * scale)));
          } else if (j0 + 16 * u < mc) {
            mx0 = row_max(mx0, c[u][0][0], c[u][0][1], c[u][1][0],
                          c[u][1][1], key, M, scale);
            mx1 = row_max(mx1, c[u][0][2], c[u][0][3], c[u][1][2],
                          c[u][1][3], key, M, scale);
          }
        }
      }
      // the four lanes of a row hold its maxima over disjoint keys
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        if (ARG) {
          const float v0 = __shfl_xor_sync(0xffffffffu, mx0, o);
          const int k0 = __shfl_xor_sync(0xffffffffu, key0, o);
          const float v1 = __shfl_xor_sync(0xffffffffu, mx1, o);
          const int k1 = __shfl_xor_sync(0xffffffffu, key1, o);
          take(mx0, key0, v0, k0);
          take(mx1, key1, v1, k1);
        } else {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
      }
      if (t == 0) {  // the same warp owns this item in every chunk
        float* sm = s_max + it * 16;
        if (ARG) {
          int* sk = s_key + it * 16;
          float v = sm[g];
          int kk = sk[g];
          take(v, kk, mx0, key0);
          sm[g] = v;
          sk[g] = kk;
          v = sm[g + 8];
          kk = sk[g + 8];
          take(v, kk, mx1, key1);
          sm[g + 8] = v;
          sk[g + 8] = kk;
        } else {
          sm[g] = fmaxf(sm[g], mx0);
          sm[g + 8] = fmaxf(sm[g + 8], mx1);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += kMmaThreads) {
    if (n0 + i < N) {
      const int tg = i >> 4;
      float acc = 0.f;
      for (int hh = 0; hh < heads; ++hh) {
        const int at = (hh * groups + tg) * 16 + (i & 15);
        if (ARG) {
          acc += __fmul_rn(s_max[at], scale);  // rounded, then added
          amax[(static_cast<long long>(b) * heads + hh) * N + n0 + i] =
              max(s_key[at], 0);
        } else {
          acc += s_max[at];
        }
      }
      out[static_cast<long long>(b) * N + n0 + i] = acc;
    }
  }
}

template <int DK, bool ARG>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, float* out,
               int* amax, int B, int N, int M, int C, int heads, int d,
               float scale, cudaStream_t stream) {
  const int pitch = heads * 16 * DK + 8;  // an odd number of 16-byte units
  // the largest token tile that still gives every SM a block: each block
  // stages all keys, so fewer, larger tiles move fewer bytes
  int T = 256;
  while (T > 16 && static_cast<long long>((N + T - 1) / T) * B < sm_count())
    T /= 2;
  // q tile, row maxima (and their keys)
  const int fixed = T * pitch * 2 + T * heads * 4 * (ARG ? 2 : 1);
  const int m16 = (M + 15) & ~15;
  const int MC = min(m16, (kSmemMax - fixed) / (pitch * 2) / 16 * 16);
  if (MC < 16) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fixed + MC * pitch * 2;
  const cudaError_t err = allow_smem<scores_mma_kernel<DK, ARG>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int vec = d % 8 == 0 && C % 8 == 0 && aligned(q) && aligned(k);
  const dim3 grid((N + T - 1) / T, B);
  scores_mma_kernel<DK, ARG><<<grid, kMmaThreads, smem, stream>>>(
      q, k, out, amax, N, M, C, heads, d, pitch, T, MC, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int M, int C, int heads) {
  return M <= 0 || heads <= 0 || C % heads != 0 || C / heads > 64 ||
         B > 65535;
}

template <bool ARG>
int launch_bf16(const void* q, const void* k, void* out, void* amax, int B,
                int N, int M, int C, int heads, float scale, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(B, M, C, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / heads;
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  auto* o = static_cast<float*>(out);
  auto* a = static_cast<int*>(amax);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1:
      return launch_mma<1, ARG>(qt, kt, o, a, B, N, M, C, heads, d, scale, s);
    case 2:
      return launch_mma<2, ARG>(qt, kt, o, a, B, N, M, C, heads, d, scale, s);
    case 3:
      return launch_mma<3, ARG>(qt, kt, o, a, B, N, M, C, heads, d, scale, s);
    default:
      return launch_mma<4, ARG>(qt, kt, o, a, B, N, M, C, heads, d, scale, s);
  }
}

template <bool ARG>
int launch_f32(const void* q, const void* k, void* out, void* amax, int B,
               int N, int M, int C, int heads, float scale, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(B, M, C, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / heads;
  const int dp = (d + 3) & ~3;
  // split the keys until the grid has at least two blocks per SM
  const long long want_blocks = 2LL * sm_count();
  int splits = 1;
  while (splits < 8 &&
         static_cast<long long>((N + kThreads / splits - 1) /
                                (kThreads / splits)) * B < want_blocks) {
    splits *= 2;
  }
  const int tokens = kThreads / splits;
  const dim3 grid((N + tokens - 1) / tokens, B);
  auto s = static_cast<cudaStream_t>(stream);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  float* o = static_cast<float*>(out);
  int* a = static_cast<int*>(amax);
  if (dp <= 32) {
    scores_kernel<float, 32, ARG><<<grid, kThreads, 0, s>>>(
        qt, kt, o, a, N, M, C, heads, d, dp, splits, scale);
  } else {
    scores_kernel<float, 64, ARG><<<grid, kThreads, 0, s>>>(
        qt, kt, o, a, N, M, C, heads, d, dp, splits, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int maxpool_attention_scores_f32(const void* q, const void* k,
                                            void* out, int B, int N, int M,
                                            int C, int heads, float scale,
                                            void* stream) {
  return launch_f32<false>(q, k, out, nullptr, B, N, M, C, heads, scale,
                           stream);
}

extern "C" int maxpool_attention_scores_bf16(const void* q, const void* k,
                                             void* out, int B, int N, int M,
                                             int C, int heads, float scale,
                                             void* stream) {
  return launch_bf16<false>(q, k, out, nullptr, B, N, M, C, heads, scale,
                            stream);
}

// The same scores, and amax [B, heads, N] (int32) for the backward.
extern "C" int maxpool_attention_scores_argmax_f32(
    const void* q, const void* k, void* out, void* amax, int B, int N, int M,
    int C, int heads, float scale, void* stream) {
  return launch_f32<true>(q, k, out, amax, B, N, M, C, heads, scale, stream);
}

extern "C" int maxpool_attention_scores_argmax_bf16(
    const void* q, const void* k, void* out, void* amax, int B, int N, int M,
    int C, int heads, float scale, void* stream) {
  return launch_bf16<true>(q, k, out, amax, B, N, M, C, heads, scale, stream);
}
