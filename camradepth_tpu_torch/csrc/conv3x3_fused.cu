// Fused 3x3 convolution + GroupNorm statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel camradepth_tpu/ops/conv_fused.py
// `_conv_fused_call` (:237-332, pl.pallas_call at :316) with its body
// `_conv_kernel` (:78-225). It computes what that kernel computes:
//
//   raw[b, y, x, n] = sum over taps (di, dj) and concat channels k of
//                     src(b, y + di - 1, x + dj - 1, k) * W[di, dj, k, n]
//
// a SAME, bias-free 3x3 convolution over the channel concat of up to four
// NHWC sources, accumulated in fp32. A source with a GroupNorm affine gets
// v * scale + shift on load, multiply and add each rounded to the
// activation type (an FMA would round once and differ by one ulp from the
// JAX package), then GELU when asked (the tanh form in bf16, the exact erf
// form in fp32, evaluated in fp32 as PyTorch's CUDA GELU). SAME padding is
// zero *after* that transform (conv_fused.py:184-194). The raw output is
// written in the activation type, and the per-(batch, channel) fp32 sums
// and sums of squares are taken from the fp32 accumulator before rounding
// (conv_fused.py:219-223).
//
// Bound on the H100. The 15 ShortResBlock convolutions of `base` at
// 416x800, batch 8, are 2.1e12 multiply-adds: ~4.3 ms at the 989 TFLOP/s of
// the bf16 tensor cores against ~2 ms for their ~7 GB of activations at
// 3.35 TB/s, so they are bound by operations; in fp32 (67 TFLOP/s outside
// the tensor cores) by operations too.
//
// Design (simple and right first; wgmma and TMA are later work). One block
// of 256 threads computes a 16x16-pixel tile of one image for 64 output
// channels. The K axis (9 taps x concat channels) is walked in chunks of 16
// (bf16) or 8 (fp32) concat channels: for each chunk the block stages the
// 18x18 halo of the tile, transformed as above, and the 9 x chunk x 64
// weight slice in shared memory, then accumulates the nine taps from it.
// Staging moves 16-byte vectors (8 bf16 or 4 fp32 channels) wherever the
// source layout is aligned, and falls back to scalar loads where it is not
// (channel counts such as 129, sources that meet inside a vector).
// bf16 runs on the tensor cores through nvcuda::wmma 16x16x16 fragments with
// fp32 accumulators: each warp holds two 16-pixel output rows by up to four
// 16-channel fragments. fp32 runs on the CUDA cores: each thread holds 8
// pixels by 8 channels in registers. The TPU kernel's flat zero-pad-column
// staging buffer and 128-lane output padding are not carried over: any H,
// W, K and N are taken and the output is [B, H, W, N] unpadded.
//
// Statistics are deterministic: each block sums its pixels in a fixed
// order into a per-tile partial, and a second small kernel adds the
// partials of all tiles in tile order. No float atomics.

// common.cuh first: it includes cuda_bf16.h, which <mma.h> needs for its
// bf16 fragments
#include "common.cuh"

#include <mma.h>

namespace {

constexpr int kMaxSources = 4;
constexpr int kTile = 16;                    // output tile: 16 x 16 pixels
constexpr int kHalo = kTile + 2;             // staged rows and columns
constexpr int kHaloPix = kHalo * kHalo;      // 324
constexpr int kTileN = 64;                   // output channels per block
constexpr int kThreads = 256;                // 8 warps
constexpr int kWarps = kThreads / 32;

struct Source {
  const void* x;      // [B, H, W, c] in the activation type
  const void* scale;  // [B, valid] in the activation type, or null
  const void* shift;  // [B, valid], null when scale is
  int c;              // channels stored per pixel
  int valid;          // channels read: the first `valid`
  int gelu;           // GELU after the affine
  int vec;            // x (and the affine) load as aligned 16-byte vectors
};

struct Sources {
  Source s[kMaxSources];
  int k_begin[kMaxSources + 1];  // offset of each source in the concat
  int n;
};

// PyTorch's CUDA GELU (ATen GeluKernel): fp32 arithmetic, tanh form for
// bf16 activations and the exact erf form for fp32 ones.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_erf(float x) {
  const float kAlpha = 0.7071067811865476f;  // 1 / sqrt(2)
  return 0.5f * x * (1.0f + erff(x * kAlpha));
}

template <typename T>
__device__ __forceinline__ float gelu_of(float x);
template <>
__device__ __forceinline__ float gelu_of<float>(float x) {
  return gelu_erf(x);
}
template <>
__device__ __forceinline__ float gelu_of<__nv_bfloat16>(float x) {
  return gelu_tanh(x);
}

// Staging moves 16-byte vectors: V = 16 / sizeof(T) values of type T.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The j-th T of a 16-byte vector, as fp32 (j a compile-time constant after
// unrolling; little-endian, element 0 in the low bits of u.x).
template <typename T>
__device__ __forceinline__ float vec_get(const uint4& u, int j);
template <>
__device__ __forceinline__ float vec_get<float>(const uint4& u, int j) {
  return __uint_as_float(j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w);
}
template <>
__device__ __forceinline__ float vec_get<__nv_bfloat16>(const uint4& u,
                                                       int j) {
  const int i = j >> 1;
  const unsigned w = i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

// V fp32 values, each exact in T, packed as T into a 16-byte vector.
template <typename T>
__device__ __forceinline__ uint4 vec_pack(const float* f);
template <>
__device__ __forceinline__ uint4 vec_pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 vec_pack<__nv_bfloat16>(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
    const unsigned hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// v through the source's affine (scale s, shift h) and GELU, every step
// rounded to the activation type T.
template <typename T>
__device__ __forceinline__ float apply_source(const Source& src, float v,
                                              float s, float h) {
  if (src.scale != nullptr) {
    v = to_f32(from_f32<T>(__fmul_rn(v, s)));
    v = to_f32(from_f32<T>(__fadd_rn(v, h)));
  }
  if (src.gelu) v = to_f32(from_f32<T>(gelu_of<T>(v)));
  return v;
}

// Channels c .. c+V-1 of one source at pixel `pix` (flat b*H*W index),
// transformed, into f: 16-byte loads of x and of the affine where they are
// aligned, V scalar loads where not.
template <typename T>
__device__ __forceinline__ void load_vector(const Source& src, long long pix,
                                            int c, int b, float* f) {
  constexpr int V = kVec<T>;
  const T* x = static_cast<const T*>(src.x) + pix * src.c + c;
  const long long a = static_cast<long long>(b) * src.valid + c;
  const T* sc = static_cast<const T*>(src.scale);
  const T* sh = static_cast<const T*>(src.shift);
  const bool affine = sc != nullptr;
  if (src.vec && c % V == 0) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x);
    uint4 sv = make_uint4(0, 0, 0, 0), hv = sv;
    if (affine) {
      sv = *reinterpret_cast<const uint4*>(sc + a);
      hv = *reinterpret_cast<const uint4*>(sh + a);
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      f[j] = apply_source<T>(src, vec_get<T>(xv, j), vec_get<T>(sv, j),
                             vec_get<T>(hv, j));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      f[j] = apply_source<T>(src, to_f32(x[j]),
                             affine ? to_f32(sc[a + j]) : 0.0f,
                             affine ? to_f32(sh[a + j]) : 0.0f);
  }
}

// The source holding concat channel k < K.
__device__ __forceinline__ int source_of(const Sources& S, int k) {
  int s = 0;
  while (s + 1 < S.n && k >= S.k_begin[s + 1]) ++s;
  return s;
}

// Stage the 18x18 halo of the tile for concat channels k0 .. k0+KC-1 into
// s_in[pixel][KC], transformed, one 16-byte vector of channels per step;
// zero outside the image and beyond K.
template <typename T, int KC>
__device__ __forceinline__ void stage_input(T* s_in, const Sources& S, int b,
                                            int y0, int x0, int k0, int H,
                                            int W, int K) {
  constexpr int V = kVec<T>;
  constexpr int G = KC / V;  // vectors per staged pixel
  for (int i = threadIdx.x; i < kHaloPix * G; i += kThreads) {
    const int p = i / G;
    const int k = k0 + (i - p * G) * V;
    const int gy = y0 - 1 + p / kHalo;
    const int gx = x0 - 1 + p % kHalo;
    float f[V];
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && k < K) {
      const long long pix = (static_cast<long long>(b) * H + gy) * W + gx;
      const int s = source_of(S, k);
      if (k + V <= S.k_begin[s + 1]) {
        load_vector<T>(S.s[s], pix, k - S.k_begin[s], b, f);
      } else {  // the vector straddles two sources or the end of K
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (k + j < K) {
            const int sj = source_of(S, k + j);
            const Source& src = S.s[sj];
            const int c = k + j - S.k_begin[sj];
            const long long a = static_cast<long long>(b) * src.valid + c;
            const bool affine = src.scale != nullptr;
            f[j] = apply_source<T>(
                src, to_f32(static_cast<const T*>(src.x)[pix * src.c + c]),
                affine ? to_f32(static_cast<const T*>(src.scale)[a]) : 0.0f,
                affine ? to_f32(static_cast<const T*>(src.shift)[a]) : 0.0f);
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(s_in + p * KC + (i - p * G) * V) =
        vec_pack<T>(f);
  }
}

// Stage W[t, k0 .. k0+KC-1, n0 .. n0+63] (HWIO flattened to [9, K, N]) into
// s_w[t][KC][LDW], 16 bytes per step; zero beyond K and N.
template <typename T, int KC, int LDW>
__device__ __forceinline__ void stage_weights(T* s_w, const T* __restrict__ w,
                                              int w_vec, int k0, int n0,
                                              int K, int N) {
  constexpr int V = kVec<T>;
  constexpr int NV = kTileN / V;  // vectors per weight row of the tile
  for (int i = threadIdx.x; i < 9 * KC * NV; i += kThreads) {
    const int t = i / (KC * NV);
    const int r = i - t * (KC * NV);
    const int kk = r / NV;
    const int nv = r - kk * NV;
    const int k = k0 + kk;
    const int n = n0 + nv * V;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (k < K && n < N) {
      const T* src = w + (static_cast<long long>(t) * K + k) * N + n;
      if (w_vec) {  // N % V == 0, so n + V <= N and src is aligned
        u = *reinterpret_cast<const uint4*>(src);
      } else {
        float f[V];
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = n + j < N ? to_f32(src[j]) : 0.0f;
        u = vec_pack<T>(f);
      }
    }
    *reinterpret_cast<uint4*>(s_w + (t * KC + kk) * LDW + nv * V) = u;
  }
}

// Block partials -> partial[0 or 1][b][tile][n]: the sums of the warps (or
// pixel groups) in their fixed order.
template <int ROWS>
__device__ __forceinline__ void write_partials(const float (*s_sum)[kTileN],
                                               const float (*s_sq)[kTileN],
                                               float* partial, int b, int tile,
                                               int n_tiles, int n0, int N,
                                               long long plane) {
  const int nn = threadIdx.x;
  if (nn < kTileN && n0 + nn < N) {
    float s = 0.0f, q = 0.0f;
    for (int r = 0; r < ROWS; ++r) {
      s += s_sum[r][nn];
      q += s_sq[r][nn];
    }
    const long long o =
        (static_cast<long long>(b) * n_tiles + tile) * N + n0 + nn;
    partial[o] = s;
    partial[plane + o] = q;
  }
}

__global__ void __launch_bounds__(kThreads)
    conv_bf16_kernel(const __grid_constant__ Sources S,
                     const __nv_bfloat16* __restrict__ w, int w_vec,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ partial, int H, int W, int K, int N,
                     int tiles_x, int n_tiles) {
  using namespace nvcuda;
  constexpr int KC = 16;           // one wmma k-step per chunk
  constexpr int LDW = kTileN + 8;  // weight row pitch (bank spread)
  __shared__ __align__(128) __nv_bfloat16 s_in[kHaloPix * KC];
  __shared__ __align__(128) __nv_bfloat16 s_w[9 * KC * LDW];
  __shared__ __align__(128) float s_scr[kWarps][16 * 16];
  __shared__ float s_sum[kWarps][kTileN];
  __shared__ float s_sq[kWarps][kTileN];

  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kTile;
  const int x0 = (tile % tiles_x) * kTile;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // 16-channel fragments of this block that hold a channel below N
  const int nf = min(kTileN / 16, (N - n0 + 15) / 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[mi][f], 0.0f);

  for (int k0 = 0; k0 < K; k0 += KC) {
    stage_input<__nv_bfloat16, KC>(s_in, S, b, y0, x0, k0, H, W, K);
    stage_weights<__nv_bfloat16, KC, LDW>(s_w, w, w_vec, k0, n0, K, N);
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int di = t / 3;
      const int dj = t - di * 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        if (f < nf) wmma::load_matrix_sync(bf[f], s_w + t * KC * LDW + f * 16,
                                           LDW);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // output row 2*warp+mi, its 16 pixels shifted by the tap
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        const int row = warp * 2 + mi;
        wmma::load_matrix_sync(af, s_in + ((row + di) * kHalo + dj) * KC, KC);
#pragma unroll
        for (int f = 0; f < 4; ++f)
          if (f < nf) wmma::mma_sync(acc[mi][f], af, bf[f], acc[mi][f]);
      }
    }
    __syncthreads();
  }

  // Epilogue: each fragment goes through the warp's 16x16 scratch; lane
  // (half, c) writes channel c of pixels 8*half .. 8*half+7 and sums them.
  float* scr = s_scr[warp];
  const int c = lane & 15;
  const int half = lane >> 4;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float s = 0.0f, q = 0.0f;
    const int n = n0 + f * 16 + c;
    if (f < nf) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int gy = y0 + warp * 2 + mi;
        wmma::store_matrix_sync(scr, acc[mi][f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int j = 0; j < 8; ++j) {
          const int px = half * 8 + j;
          const int gx = x0 + px;
          const float v = scr[px * 16 + c];
          if (gy < H && gx < W && n < N) {
            out[((static_cast<long long>(b) * H + gy) * W + gx) * N + n] =
                __float2bfloat16_rn(v);
            s += v;
            q += v * v;
          }
        }
        __syncwarp();
      }
    }
    s += __shfl_down_sync(0xffffffffu, s, 16);
    q += __shfl_down_sync(0xffffffffu, q, 16);
    if (half == 0) {
      s_sum[warp][f * 16 + c] = s;
      s_sq[warp][f * 16 + c] = q;
    }
  }
  __syncthreads();
  write_partials<kWarps>(s_sum, s_sq, partial, b, tile, n_tiles, n0, N,
                         static_cast<long long>(gridDim.z) * n_tiles * N);
}

__global__ void __launch_bounds__(kThreads)
    conv_f32_kernel(const __grid_constant__ Sources S,
                    const float* __restrict__ w, int w_vec,
                    float* __restrict__ out, float* __restrict__ partial, int H,
                    int W, int K, int N, int tiles_x, int n_tiles) {
  constexpr int KC = 8;
  constexpr int kGroups = kThreads / 8;  // 32 groups of 8 pixels
  __shared__ __align__(16) float s_in[kHaloPix * KC];
  __shared__ __align__(16) float s_w[9 * KC * kTileN];
  __shared__ float s_sum[kGroups][kTileN];
  __shared__ float s_sq[kGroups][kTileN];

  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kTile;
  const int x0 = (tile % tiles_x) * kTile;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;
  // thread = (pixel group pg, channel group cg): pixels (row, col0 .. +7),
  // channels n0 + 8*cg .. +7
  const int cg = threadIdx.x & 7;
  const int pg = threadIdx.x >> 3;
  const int row = pg >> 1;
  const int col0 = (pg & 1) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    stage_input<float, KC>(s_in, S, b, y0, x0, k0, H, W, K);
    stage_weights<float, KC, kTileN>(s_w, w, w_vec, k0, n0, K, N);
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int di = t / 3;
      const int dj = t - di * 3;
      const float* ip = s_in + ((row + di) * kHalo + col0 + dj) * KC;
      const float* wp = s_w + t * KC * kTileN + cg * 8;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float a[8], wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ip[i * KC + kk];
        const float4 w0 = *reinterpret_cast<const float4*>(wp + kk * kTileN);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wp + kk * kTileN + 4);
        wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
        wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.0f;
  const int gy = y0 + row;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gx = x0 + col0 + i;
    if (gy < H && gx < W) {
      const long long o =
          ((static_cast<long long>(b) * H + gy) * W + gx) * N + n0 + cg * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (n0 + cg * 8 + j < N) {
          const float v = acc[i][j];
          out[o + j] = v;
          s[j] += v;
          q[j] += v * v;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s_sum[pg][cg * 8 + j] = s[j];
    s_sq[pg][cg * 8 + j] = q[j];
  }
  __syncthreads();
  write_partials<kGroups>(s_sum, s_sq, partial, b, tile, n_tiles, n0, N,
                          static_cast<long long>(gridDim.z) * n_tiles * N);
}

// stats[0][b][n] = sum over tiles of partial[0][b][tile][n], in tile order;
// stats[1] the same for the squares.
__global__ void __launch_bounds__(kThreads)
    reduce_stats_kernel(const float* __restrict__ partial,
                        float* __restrict__ stats, int B, int n_tiles, int N) {
  const long long total = static_cast<long long>(B) * N;
  const long long plane = total * n_tiles;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long b = i / N;
    const int n = static_cast<int>(i - b * N);
    float s = 0.0f, q = 0.0f;
    for (int t = 0; t < n_tiles; ++t) {
      const long long o = (b * n_tiles + t) * N + n;
      s += partial[o];
      q += partial[plane + o];
    }
    stats[i] = s;
    stats[total + i] = q;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// ptrs: per source (x, scale, shift); meta: per source (c, valid, gelu).
// partial: fp32 [2, B, n_tiles, N] scratch; stats: fp32 [2, B, N].
template <typename T>
int launch(const void* const* ptrs, const int* meta, int n_src, const void* w,
           void* out, float* partial, float* stats, int B, int H, int W, int K,
           int N, void* stream) {
  if (n_src < 1 || n_src > kMaxSources || B <= 0 || H <= 0 || W <= 0 ||
      K <= 0 || N <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Sources S{};
  S.n = n_src;
  S.k_begin[0] = 0;
  for (int s = 0; s < n_src; ++s) {
    Source& d = S.s[s];
    d.x = ptrs[3 * s];
    d.scale = ptrs[3 * s + 1];
    d.shift = ptrs[3 * s + 2];
    d.c = meta[3 * s];
    d.valid = meta[3 * s + 1];
    d.gelu = meta[3 * s + 2];
    d.vec = aligned16(d.x) && aligned16(d.scale) && aligned16(d.shift) &&
            d.c % kVec<T> == 0 &&
            (d.scale == nullptr || d.valid % kVec<T> == 0);
    if (d.x == nullptr || d.valid <= 0 || d.valid > d.c ||
        (d.scale == nullptr) != (d.shift == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    S.k_begin[s + 1] = S.k_begin[s] + d.valid;
  }
  for (int s = n_src; s < kMaxSources; ++s) S.k_begin[s + 1] = S.k_begin[s];
  if (S.k_begin[n_src] != K) return static_cast<int>(cudaErrorInvalidValue);

  const int tiles_x = (W + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((H + kTile - 1) / kTile);
  const dim3 grid(n_tiles, (N + kTileN - 1) / kTileN, B);
  const int w_vec = aligned16(w) && N % kVec<T> == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    conv_bf16_kernel<<<grid, kThreads, 0, st>>>(
        S, static_cast<const __nv_bfloat16*>(w), w_vec,
        static_cast<__nv_bfloat16*>(out), partial, H, W, K, N, tiles_x,
        n_tiles);
  } else {
    conv_f32_kernel<<<grid, kThreads, 0, st>>>(
        S, static_cast<const float*>(w), w_vec, static_cast<float*>(out),
        partial, H,
        W, K, N, tiles_x, n_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (static_cast<long long>(B) * N + kThreads - 1) /
                         kThreads;
  const long long cap = 8LL * sm_count();
  reduce_stats_kernel<<<static_cast<int>(want < cap ? want : cap), kThreads, 0,
                        st>>>(partial, stats, B, n_tiles, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv3x3_fused_f32(const void* const* ptrs, const int* meta,
                                 int n_src, const void* w, void* out,
                                 float* partial, float* stats, int B, int H,
                                 int W, int K, int N, void* stream) {
  return launch<float>(ptrs, meta, n_src, w, out, partial, stats, B, H, W, K,
                       N, stream);
}

extern "C" int conv3x3_fused_bf16(const void* const* ptrs, const int* meta,
                                  int n_src, const void* w, void* out,
                                  float* partial, float* stats, int B, int H,
                                  int W, int K, int N, void* stream) {
  return launch<__nv_bfloat16>(ptrs, meta, n_src, w, out, partial, stats, B,
                               H, W, K, N, stream);
}
