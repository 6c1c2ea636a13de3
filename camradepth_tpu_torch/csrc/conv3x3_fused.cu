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
// JAX package), then GELU when asked: in bf16 the JAX package's tanh form,
// eight bf16 operations each rounded (gelu_bf16.cuh), in fp32 the exact erf
// form. SAME padding is zero *after* that transform (conv_fused.py:184-194).
// The raw output is written in the activation type, and the per-(batch,
// channel) fp32 sums and sums of squares are taken from the fp32
// accumulator before rounding (conv_fused.py:219-223).
//
// Bound on the H100. The 15 ShortResBlock convolutions of `base` at
// 416x800, batch 8, are 2.1e12 multiply-adds: ~4.3 ms at the 989 TFLOP/s of
// the bf16 tensor cores against ~2 ms for their ~7 GB of activations at
// 3.35 TB/s, so they are bound by operations; in fp32 (67 TFLOP/s outside
// the tensor cores) by operations too.
//
// bf16 design (conv_bf16_mma_kernel): implicit GEMM on the tensor cores,
// mma.sync m16n8k16 with fp32 accumulators. One block of 16 warps computes
// a 16x16-pixel tile of one image for all output channels up to 128 (N
// rounded up to 32; wider N takes further blocks of 128), so each input
// element is loaded and transformed once per tile, apart from the halo.
// The K axis is walked in chunks of 32 concat channels through a
// two-stage ring in shared memory: per stage the 18x18 halo [324 pixels]
// [32 channels] and the weight slice [9 taps][32][N], both filled by
// cp.async (zero filled outside the image and in padding). While chunk k
// multiplies, chunk k+1 is in flight, and each warp, between two of chunk
// k's taps, transforms its share of chunk k+1 in place (affine, GELU; a
// source read as it is needs nothing), so the transform overlaps other
// warps' products; one barrier per chunk frees a stage for chunk k+2. A
// warp holds two output rows (two m16 tiles) by N/2 channels; for each of
// the nine taps its A fragments are read by ldmatrix straight from the
// halo at the tap's shifted pixel offset (no copy per tap), and its B
// fragments by ldmatrix.trans from the weight slice. Row pitches are odd
// multiples of 16 bytes, so ldmatrix reads without bank conflicts. wgmma
// and TMA are later work.
//
// fp32 design (conv_f32_kernel): the CUDA cores, since TF32 would break the
// JAX package's fp32 limits. A block of 256 threads computes a 16x16 tile
// for 64 output channels; it stages the 18x18 halo, transformed, and the
// 9 x 8 x 64 weight slice per chunk of 8 concat channels, 16-byte vectors
// where the layout is aligned and scalar loads where not; each thread holds
// 8 pixels by 8 channels in registers.
//
// The TPU kernel's flat zero-pad-column staging buffer and 128-lane output
// padding are not carried over: any H, W, K and N are taken and the output
// is [B, H, W, N] unpadded.
//
// Statistics are deterministic: each block sums its pixels in a fixed
// order into a per-tile partial, and a second small kernel adds the
// partials of all tiles in tile order. No float atomics.

#include "common.cuh"
#include "gelu_bf16.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxSources = 4;
constexpr int kTile = 16;                    // output tile: 16 x 16 pixels
constexpr int kHalo = kTile + 2;             // staged rows and columns
constexpr int kHaloPix = kHalo * kHalo;      // 324
constexpr int kTileN = 64;                   // fp32: channels per block
constexpr int kThreads = 256;                // fp32: 8 warps

struct Source {
  const void* x;      // [B, H, W, c] in the activation type
  const void* scale;  // [B, valid] in the activation type, or null
  const void* shift;  // [B, valid], null when scale is
  int c;              // channels stored per pixel
  int valid;          // channels read: the first `valid`
  int gelu;           // GELU after the affine
  int vec;            // x (fp32: and the affine) loads as 16-byte vectors
  int avec;           // bf16: the affine loads as 16-byte vectors
};

struct Sources {
  Source s[kMaxSources];
  int k_begin[kMaxSources + 1];   // offset of each source in the concat
  int kp_begin[kMaxSources + 1];  // the same, each source padded to 8 (bf16)
  int n;
};

// GELU after the affine: in fp32 the exact erf form of torch's nn.GELU (in
// bf16 the JAX package's op-by-op tanh form, gelu_bf16.cuh, in the bf16
// kernel's transform).
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

// ---- bf16 on the tensor cores -------------------------------------------
//
// The K axis inside the kernel is the concat of the sources with each one
// padded to a multiple of 8 channels (Sources::kp_begin), so every 16-byte
// vector of 8 staged channels lies in one source and starts at one of its
// channels 8j: a source that starts inside a vector of the concat (K0 =
// 129) still loads by cp.async. The padding channels are zero in the halo
// and in the weights; a bf16 product is exact in fp32, so the padding adds
// exact zeros and only the order of the sum differs from the plain conv.

constexpr int kKC = 32;                  // concat channels per K chunk
constexpr int kApitch = kKC + 8;         // halo row pitch: 5 x 16 bytes, odd
constexpr int kMmaThreads = 512;         // 16 warps: 8 along M x 2 along N
constexpr int kWarpsM = 8;
constexpr int kNTmax = 128;              // output channels per block
constexpr int kVecsPerPix = kKC / 8;     // 16-byte vectors per halo pixel

template <int NT>
struct Bf16Smem {
  static constexpr int kWpitch = NT + 8;  // odd number of 16-byte units
  static constexpr int kWstage = 9 * kKC * kWpitch;  // elements
  static constexpr int kAstage = kHaloPix * kApitch;  // elements
  // two stages of weights and halo, then the bf16 GELU table (copied in
  // 16-byte vectors)
  static constexpr int kBytes = (2 * kWstage + 2 * kAstage + kGeluTable) * 2;
  static_assert((2 * kWstage + 2 * kAstage) % 8 == 0, "table alignment");
};

// The source of internal channel kin (< Kp) and its channel there.
__device__ __forceinline__ int source_of_padded(const Sources& S, int kin,
                                                int* c) {
  int s = 0;
  while (s + 1 < S.n && kin >= S.kp_begin[s + 1]) ++s;
  *c = kin - S.kp_begin[s];
  return s;
}

// Start the copies of chunk k0: the raw halo (vector-aligned sources) into
// s_a[pixel][kApitch], where transform_chunk later rewrites it in place,
// and the weight slice W[t, k0 .. k0+31, n0 .. n0+NT-1] into
// s_w[t][kKC][kWpitch]. Out-of-image pixels, padding channels and channels
// beyond N are zero filled or left to the transform. A thread issues the
// halo vectors that it transforms later (the same loop over i), so its own
// cp.async.wait_group is all the transform waits for.
template <int NT>
__device__ __forceinline__ void issue_chunk(
    __nv_bfloat16* s_a, __nv_bfloat16* s_w, const Sources& S,
    const __nv_bfloat16* __restrict__ w, int w_vec, int b, int y0, int x0,
    int k0, int n0, int H, int W, int Kp, int K, int N) {
  constexpr int WP = Bf16Smem<NT>::kWpitch;
  for (int i = threadIdx.x; i < kHaloPix * kVecsPerPix; i += kMmaThreads) {
    const int p = i / kVecsPerPix;
    const int v = i - p * kVecsPerPix;
    const int kin = k0 + 8 * v;
    const int gy = y0 - 1 + p / kHalo;
    const int gx = x0 - 1 + p % kHalo;
    int c = 0;
    const Source* src = nullptr;
    if (kin < Kp && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      src = &S.s[source_of_padded(S, kin, &c)];
      if (c >= src->valid) src = nullptr;  // a padding vector
    }
    // zero outside the image and in padding; the raw vector where the
    // source is vector aligned; left to the transform where it is not
    if (src == nullptr) {
      cp_async16(smem_addr(s_a + p * kApitch + 8 * v), S.s[0].x, false);
    } else if (src->vec) {
      const long long pix = (static_cast<long long>(b) * H + gy) * W + gx;
      cp_async16(smem_addr(s_a + p * kApitch + 8 * v),
                 static_cast<const __nv_bfloat16*>(src->x) + pix * src->c + c,
                 true);
    }
  }
  constexpr int NV = NT / 8;  // weight vectors per staged row
  for (int i = threadIdx.x; i < 9 * kKC * NV; i += kMmaThreads) {
    const int row = i / NV;  // t * kKC + kk
    const int nv = i - row * NV;
    const int t = row / kKC;
    const int kin = k0 + (row - t * kKC);
    const int n = n0 + 8 * nv;
    __nv_bfloat16* dst = s_w + row * WP + 8 * nv;
    int k = -1;  // the weights' row of this channel; -1 for padding
    if (kin < Kp) {
      int c;
      const int s = source_of_padded(S, kin, &c);
      if (c < S.s[s].valid) k = S.k_begin[s] + c;
    }
    const __nv_bfloat16* src =
        w + (static_cast<long long>(t) * K + (k < 0 ? 0 : k)) * N +
        (n < N ? n : 0);
    if (w_vec) {
      cp_async16(smem_addr(dst), src, k >= 0 && n < N);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (k >= 0 && n + j < N) ? src[j] : __float2bfloat16_rn(0.0f);
    }
  }
  cp_async_commit();
}

// The halo of chunk k0 as the conv reads it, in place in s_a[pixel]
// [kApitch]: the raw vectors that issue_chunk copied there (or, for sources
// that are not vector aligned, device memory) through each source's affine
// and GELU. Vectors that need nothing (zeros, whole vectors of a source
// read as it is) are left as issue_chunk wrote them.
__device__ __forceinline__ void transform_chunk(
    __nv_bfloat16* s_a, const unsigned short* gelu_table, const Sources& S,
    int b, int y0, int x0, int k0, int H, int W, int Kp) {
  for (int i = threadIdx.x; i < kHaloPix * kVecsPerPix; i += kMmaThreads) {
    const int p = i / kVecsPerPix;
    const int v = i - p * kVecsPerPix;
    const int kin = k0 + 8 * v;
    const int gy = y0 - 1 + p / kHalo;
    const int gx = x0 - 1 + p % kHalo;
    if (kin >= Kp || gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    int c;
    const Source& src = S.s[source_of_padded(S, kin, &c)];
    if (c >= src.valid) continue;  // a padding vector
    const bool whole = c + 8 <= src.valid;
    const bool affine = src.scale != nullptr;
    if (src.vec && whole && !affine && !src.gelu) continue;
    __nv_bfloat16* dst = s_a + p * kApitch + 8 * v;
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(src.x);
    const long long pix = (static_cast<long long>(b) * H + gy) * W + gx;
    const uint4 raw = src.vec ? *reinterpret_cast<const uint4*>(dst)
                              : make_uint4(0, 0, 0, 0);
    const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(src.scale);
    const __nv_bfloat16* sh = static_cast<const __nv_bfloat16*>(src.shift);
    const long long a = static_cast<long long>(b) * src.valid + c;
    uint4 sv = make_uint4(0, 0, 0, 0), hv = sv;
    if (affine && src.avec && whole) {
      sv = *reinterpret_cast<const uint4*>(sc + a);
      hv = *reinterpret_cast<const uint4*>(sh + a);
    }
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      f[j] = 0.0f;
      if (c + j < src.valid) {
        const float xv = src.vec ? vec_get<__nv_bfloat16>(raw, j)
                                 : to_f32(x[pix * src.c + c + j]);
        float v = xv;
        if (affine) {  // multiply, then add, each rounded to bf16
          const float s = src.avec && whole ? vec_get<__nv_bfloat16>(sv, j)
                                            : to_f32(sc[a + j]);
          const float h = src.avec && whole ? vec_get<__nv_bfloat16>(hv, j)
                                            : to_f32(sh[a + j]);
          v = bf16_round(__fadd_rn(bf16_round(__fmul_rn(v, s)), h));
        }
        f[j] = src.gelu ? gelu_bf16_table(v, gelu_table) : v;
      }
    }
    *reinterpret_cast<uint4*>(dst) = vec_pack<__nv_bfloat16>(f);
  }
}

// One block: a 16x16-pixel tile of one image and NT (<= 128) output
// channels n0 .. n0+NT-1, all of them when N <= 128. Warp (wm, wn) holds
// output rows 2wm, 2wm+1 (two m16 tiles of 16 pixels) by NT/2 channels
// (NT/16 n8 tiles): 2 * NT/16 * 4 fp32 accumulators a thread.
template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    conv_bf16_mma_kernel(const __grid_constant__ Sources S,
                         const __nv_bfloat16* __restrict__ w, int w_vec,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ partial, int H, int W, int K,
                         int Kp, int N, int tiles_x, int n_tiles) {
  using L = Bf16Smem<NT>;
  constexpr int WP = L::kWpitch;
  constexpr int NW = NT / 2;   // channels per warp
  constexpr int NJ = NW / 8;   // n8 tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 stages
  __nv_bfloat16* s_a = s_w + 2 * L::kWstage;  // 2 stages
  unsigned short* gelu_table =
      reinterpret_cast<unsigned short*>(s_a + 2 * L::kAstage);

  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kTile;
  const int x0 = (tile % tiles_x) * kTile;
  const int n0 = blockIdx.y * kNTmax;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  float acc[2][NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

  // ldmatrix lanes: A rows are pixels (16 per m16 tile), B rows channels k
  const int a_pix = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 8 * (lane >> 4);
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_n = wn * NW + 8 * (lane >> 4);

  // A two-stage ring of halo and weight buffers. Chunk ck+1 is copied
  // while chunk ck multiplies; each warp transforms its share of chunk ck+1
  // in place between two of chunk ck's taps (a tap that differs between
  // warps, so the tensor cores never wait on all of them at once); one
  // barrier per chunk then frees chunk ck's buffers for chunk ck+2.
  const int nc = (Kp + kKC - 1) / kKC;
  const int t_transform = 4 + (warp & 3);
  issue_chunk<NT>(s_a, s_w, S, w, w_vec, b, y0, x0, 0, n0, H, W, Kp, K, N);
  load_gelu_table(gelu_table);
  __syncthreads();
  if (nc > 1)
    issue_chunk<NT>(s_a + L::kAstage, s_w + L::kWstage, S, w, w_vec, b, y0,
                    x0, kKC, n0, H, W, Kp, K, N);
  if (nc > 1) cp_async_wait<1>(); else cp_async_wait<0>();
  transform_chunk(s_a, gelu_table, S, b, y0, x0, 0, H, W, Kp);
  __syncthreads();
  for (int ck = 0; ck < nc; ++ck) {
    const int cur = ck & 1;
    const __nv_bfloat16* sa = s_a + cur * L::kAstage;
    const __nv_bfloat16* sw = s_w + cur * L::kWstage;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      if (t == t_transform && ck + 1 < nc) {
        cp_async_wait<0>();  // this thread's copies of chunk ck+1
        transform_chunk(s_a + (cur ^ 1) * L::kAstage, gelu_table, S, b, y0,
                        x0, (ck + 1) * kKC, H, W, Kp);
      }
      const int di = t / 3;
      const int dj = t - di * 3;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int hp = (2 * wm + mi + di) * kHalo + dj + a_pix;
          ldmatrix_x4(a[mi], smem_addr(sa + hp * kApitch + ks * 16 + a_col));
        }
        const __nv_bfloat16* wrow = sw + (t * kKC + ks * 16 + b_k) * WP + b_n;
#pragma unroll
        for (int nb = 0; nb < NJ / 2; ++nb) {
          unsigned bf[4];  // n8 tiles 2nb (bf[0], bf[1]) and 2nb+1
          ldmatrix_x4_trans(bf, smem_addr(wrow + nb * 16));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nb], a[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * nb + 1], a[mi], bf[2], bf[3]);
          }
        }
      }
    }
    // every warp is done with chunk ck's buffers, has transformed its share
    // of chunk ck+1 and has waited for its copies of chunk ck+1's weights
    __syncthreads();
    if (ck + 2 < nc)
      issue_chunk<NT>(s_a + cur * L::kAstage, s_w + cur * L::kWstage, S, w,
                      w_vec, b, y0, x0, (ck + 2) * kKC, n0, H, W, Kp, K, N);
  }

  // Epilogue: raw output in bf16 and per-channel sums of the fp32
  // accumulators over this thread's pixels (columns g and g+8 of rows
  // 2wm, 2wm+1), then over the 8 lanes g of a column pair by shuffles, in
  // a fixed order. The warp sums meet in shared memory (the halo ring's
  // space, free after the loop's last barrier).
  float (*s_sum)[kNTmax] = reinterpret_cast<float (*)[kNTmax]>(s_a);
  float (*s_sq)[kNTmax] = s_sum + kWarpsM;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int nl = wn * NW + j * 8 + 2 * t4;  // channel in the block tile
    const int n = n0 + nl;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int gy = y0 + 2 * wm + mi;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int gx = x0 + g + 8 * hf;
        if (gy < H && gx < W) {
          const float v0 = acc[mi][j][2 * hf];
          const float v1 = acc[mi][j][2 * hf + 1];
          __nv_bfloat16* o =
              out + ((static_cast<long long>(b) * H + gy) * W + gx) * N + n;
          if (n + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < N) o[0] = __float2bfloat16_rn(v0);
            if (n + 1 < N) o[1] = __float2bfloat16_rn(v1);
          }
          s0 += v0;
          q0 += v0 * v0;
          s1 += v1;
          q1 += v1 * v1;
        }
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      q0 += __shfl_xor_sync(0xffffffffu, q0, o);
      q1 += __shfl_xor_sync(0xffffffffu, q1, o);
    }
    if (g == 0) {
      s_sum[wm][nl] = s0;
      s_sum[wm][nl + 1] = s1;
      s_sq[wm][nl] = q0;
      s_sq[wm][nl + 1] = q1;
    }
  }
  __syncthreads();
  const int nn = threadIdx.x;
  if (nn < NT && n0 + nn < N) {
    float s = 0.0f, q = 0.0f;
    for (int r = 0; r < kWarpsM; ++r) {
      s += s_sum[r][nn];
      q += s_sq[r][nn];
    }
    const long long o =
        (static_cast<long long>(b) * n_tiles + tile) * N + n0 + nn;
    partial[o] = s;
    partial[static_cast<long long>(gridDim.z) * n_tiles * N + o] = q;
  }
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

template <int NT>
cudaError_t launch_bf16(dim3 grid, cudaStream_t st, const Sources& S,
                        const __nv_bfloat16* w, int w_vec, __nv_bfloat16* out,
                        float* partial, int H, int W, int K, int Kp, int N,
                        int tiles_x, int n_tiles) {
  constexpr int kBytes = Bf16Smem<NT>::kBytes;
  const cudaError_t ready = gelu_table_ready(st);
  if (ready != cudaSuccess) return ready;
  const cudaError_t err = allow_smem<conv_bf16_mma_kernel<NT>>(kBytes);
  if (err != cudaSuccess) return err;
  conv_bf16_mma_kernel<NT><<<grid, kMmaThreads, kBytes, st>>>(
      S, w, w_vec, out, partial, H, W, K, Kp, N, tiles_x, n_tiles);
  return cudaGetLastError();
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
    if constexpr (sizeof(T) == 2) {
      d.vec = aligned16(d.x) && d.c % 8 == 0;
      d.avec = d.scale != nullptr && aligned16(d.scale) &&
               aligned16(d.shift) && d.valid % 8 == 0;
    } else {
      d.vec = aligned16(d.x) && aligned16(d.scale) && aligned16(d.shift) &&
              d.c % kVec<T> == 0 &&
              (d.scale == nullptr || d.valid % kVec<T> == 0);
    }
    if (d.x == nullptr || d.valid <= 0 || d.valid > d.c ||
        (d.scale == nullptr) != (d.shift == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    S.k_begin[s + 1] = S.k_begin[s] + d.valid;
    S.kp_begin[s + 1] = S.kp_begin[s] + (d.valid + 7) / 8 * 8;
  }
  for (int s = n_src; s < kMaxSources; ++s) {
    S.k_begin[s + 1] = S.k_begin[s];
    S.kp_begin[s + 1] = S.kp_begin[s];
  }
  if (S.k_begin[n_src] != K) return static_cast<int>(cudaErrorInvalidValue);

  const int tiles_x = (W + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((H + kTile - 1) / kTile);
  const int w_vec = aligned16(w) && N % kVec<T> == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    // NT: the block's channel tile, N rounded up to 32 (128 at most)
    const int nt = N > kNTmax ? kNTmax : (N + 31) / 32 * 32;
    const dim3 grid(n_tiles, (N + kNTmax - 1) / kNTmax, B);
    const auto* wt = static_cast<const __nv_bfloat16*>(w);
    auto* o = static_cast<__nv_bfloat16*>(out);
    const int Kp = S.kp_begin[n_src];
    switch (nt) {
      case 32: err = launch_bf16<32>(grid, st, S, wt, w_vec, o, partial, H, W,
                                     K, Kp, N, tiles_x, n_tiles); break;
      case 64: err = launch_bf16<64>(grid, st, S, wt, w_vec, o, partial, H, W,
                                     K, Kp, N, tiles_x, n_tiles); break;
      case 96: err = launch_bf16<96>(grid, st, S, wt, w_vec, o, partial, H, W,
                                     K, Kp, N, tiles_x, n_tiles); break;
      default: err = launch_bf16<128>(grid, st, S, wt, w_vec, o, partial, H,
                                      W, K, Kp, N, tiles_x, n_tiles); break;
    }
  } else {
    const dim3 grid(n_tiles, (N + kTileN - 1) / kTileN, B);
    conv_f32_kernel<<<grid, kThreads, 0, st>>>(
        S, static_cast<const float*>(w), w_vec, static_cast<float*>(out),
        partial, H, W, K, N, tiles_x, n_tiles);
    err = cudaGetLastError();
  }
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
