// Bicubic x2 upsampling over NHWC for Hopper (sm_90a).
//
// Replaces the TPU kernel camradepth_tpu/ops/resize_pallas.py
// `_upsample_pallas_4d` (:190-228, pl.pallas_call at :209) with its body
// `_upsample_kernel` (:55-187). Semantics are PyTorch's
// nn.Upsample(scale_factor=2, mode="bicubic", align_corners=False):
// a = -0.75, edge replication, and for an exact x2 two static 4-tap phases
// (camradepth_tpu/ops/resize.py:40-45):
//   even output 2k filters inputs k-2..k+1 with W(1.75) W(0.75) W(0.25) W(1.25)
//   odd output 2k+1 filters inputs k-1..k+2 with the same weights reversed.
// H is filtered first and then W. Each axis accumulates in fp32 and is
// rounded to the I/O type between the axes, exactly where the JAX path
// stores its H-upsampled intermediate. Products and sums are rounded one
// by one (__fmul_rn / __fadd_rn, taps in order 0..3), as the plain PyTorch
// version evaluates them, so the two agree bit for bit. Any B, H, W and C
// (C up to what the shared memory holds, see upsample_plan in
// ops/resize.py).
//
// Bound on the H100: bytes. One read and four writes of the image; the
// five decoder inputs of `base` at 416x800 (13x25x256, 26x50x128,
// 52x100x128, 104x200x129, 208x400x129) move 1.15 GB per bf16 batch-8
// forward, 0.342 ms at 3.35 TB/s, against ~42 fp32 operations per input
// element. The two C = 129 launches carry 94 % of the bytes, and at
// C = 129 a pixel is 258 bytes, so the design works on flat rows of W*C
// elements and never on vectors of one pixel's channels.
//
// Design. A block of 256 threads owns one image b, a strip of `rows` input
// rows and a span of `tw` input columns (grid: spans x strips x B); it
// writes the 2 x 2 outputs of each of them. Per input row ky of its strip:
//   H pass: the H filter reads the same flat offset kx*C + c of five input
//     rows, so it needs no pixel alignment. Each thread owns two 16-byte
//     vectors (8 bf16 or 4 fp32 each) of the flat span of columns
//     [kx0-2, kx1+2) and keeps their five rows in registers as a sliding
//     window of raw 32-bit words: one 16-byte load of the next row per
//     step, issued a step ahead, so each input element is read from device
//     memory about once. Both filtered rows (outputs 2ky and 2ky+1) are
//     rounded to the I/O type and stored to shared memory as float pairs.
//   W pass: one thread per (kx, c) of the block's span reads the five
//     columns kx-2..kx+2 of both rows (one 8-byte pair each) at offsets of
//     C elements (any C, 129 included: shared memory takes any 4-byte
//     offset) and writes its 2 x 2 outputs into a shared staging copy of
//     the two output rows, laid out on the 16-byte grid of the output.
//   Store pass: 16-byte vector stores of the staged rows.
// Two barriers per row; 78 registers, no spills, 3 blocks per SM. What
// remains between the kernel and its bound is instruction issue: the exact
// rounding rules out FMAs, so each output costs 7 fp32 operations in each
// pass, plus its conversions and shared-memory traffic.
// A row that does not start on 16 bytes (W*C*es not a multiple of 16, or
// a view at an odd storage offset) takes scalar loads; a vector that
// straddles the end of the span or of a row is loaded and stored element
// by element. Offsets inside a row are 32-bit; no 64-bit divide remains.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// 16-byte vectors of the H span that each thread keeps in its register
// window; ops/resize.py sizes the span to fit (kThreads * kWindow vectors)
// and any vectors beyond it load their five rows anew at each step.
constexpr int kWindow = 2;
constexpr int kSmemMax = 232448;  // per block on the H100

// 16 bytes of T (8 bf16 or 4 fp32), kept as four 32-bit words so that a
// window of them stays in 4 registers each
template <typename T>
struct Pack {
  static constexpr int kN = 16 / sizeof(T);
  uint4 w;
};

// element e (a compile-time index after unrolling) of p, in fp32
__device__ __forceinline__ unsigned word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
__device__ __forceinline__ float elem(const Pack<float>& p, int e) {
  return __uint_as_float(word(p.w, e));
}
__device__ __forceinline__ float elem(const Pack<__nv_bfloat16>& p, int e) {
  const unsigned u = word(p.w, e / 2);
  return __uint_as_float(e % 2 ? u & 0xffff0000u : u << 16);
}

// raw bits of T, for element-wise loads into a Pack
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 2, unsigned short,
                                       unsigned>::type;

// Cubic-kernel weights W(1.75), W(0.75), W(0.25), W(1.25) for a = -0.75;
// all four are exact in fp32. The odd phase uses them reversed.
__device__ __forceinline__ float tap_weight(int phase, int t) {
  const int i = phase ? 3 - t : t;
  return i == 0 ? -0.03515625f
       : i == 1 ? 0.26171875f
       : i == 2 ? 0.87890625f
                : -0.10546875f;
}

// sum_t v[o + t] * W_phase(t), t = 0..3, rounding each product and each
// sum in tap order, as the plain version does.
__device__ __forceinline__ float filter4(const float* v, int o, int phase) {
  float a = __fmul_rn(v[o], tap_weight(phase, 0));
#pragma unroll
  for (int t = 1; t < 4; ++t) {
    a = __fadd_rn(a, __fmul_rn(v[o + t], tap_weight(phase, t)));
  }
  return a;
}

// The 16 bytes at flat offset f of a row of n elements: one vector load
// where the row's vectors are aligned and f..f+N-1 lies inside the row,
// else element by element (zeros outside the row, never read back).
template <typename T>
__device__ __forceinline__ Pack<T> load_pack(const T* __restrict__ row,
                                             int f, int n, bool vec) {
  constexpr int N = Pack<T>::kN;
  Pack<T> p;
  if (vec && f >= 0 && f + N <= n) {
    p.w = *reinterpret_cast<const uint4*>(row + f);
  } else {
    const Bits<T>* bits = reinterpret_cast<const Bits<T>*>(row);
    unsigned u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int g = f + e;
      const unsigned b = (g >= 0 && g < n) ? bits[g] : 0u;
      u[e * 4 / N] |= b << (sizeof(T) == 2 ? 16 * (e % 2) : 0);
    }
    p.w = make_uint4(u[0], u[1], u[2], u[3]);
  }
  return p;
}

// x rounded to T and back: the value the H-upsampled intermediate holds
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// H pass of one vector: win holds input rows ky-2..ky+2; even output row
// 2ky filters rows 0..3, odd output row 2ky+1 rows 1..4. Each element's
// pair (even, odd), rounded to T, is stored as two floats at h[e].
template <typename T>
__device__ __forceinline__ void h_filter(const Pack<T> (&win)[5],
                                         float2* h) {
  constexpr int N = Pack<T>::kN;
  float4* dst = reinterpret_cast<float4*>(h);
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    float v[5], u[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      v[i] = elem(win[i], e);
      u[i] = elem(win[i], e + 1);
    }
    dst[e / 2] = make_float4(
        round_to<T>(filter4(v, 0, 0)), round_to<T>(filter4(v, 1, 1)),
        round_to<T>(filter4(u, 0, 0)), round_to<T>(filter4(u, 1, 1)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    upsample_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W,
                    int C, int tw, int rows, int cap, int scap) {
  constexpr int N = Pack<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  // H-filtered rows 2ky and 2ky+1, as (even, odd) float pairs
  float2* const hrow = reinterpret_cast<float2*>(smem);
  T* const stage = reinterpret_cast<T*>(hrow + cap);  // output rows, scap each

  const int tid = threadIdx.x;
  const int WC = W * C, W2C = 2 * WC;
  const int kx0 = blockIdx.x * tw, kx1 = min(kx0 + tw, W);
  const int ky0 = blockIdx.y * rows, ky1 = min(ky0 + rows, H);
  const T* __restrict__ xb = x + static_cast<long long>(blockIdx.z) * H * WC;
  T* __restrict__ yb = y + static_cast<long long>(blockIdx.z) * 2 * H * W2C;

  // H span: flat offsets [fs, fs + nvec*N) of an input row, covering the
  // columns [ca, cb) that the W pass reads. When every row starts at the
  // same phase of the 16-byte grid, fs is put on that grid, so that every
  // whole vector inside a row is one aligned load.
  const int ca = max(kx0 - 2, 0), cb = min(kx1 + 2, W);
  const bool vec = WC % N == 0;
  const int phase = static_cast<int>(
      reinterpret_cast<uintptr_t>(xb) / sizeof(T) % N);
  const int fs = ca * C - (vec ? (phase + ca * C) % N : 0);
  const int nvec = (cb * C - fs + N - 1) / N;
  const auto row_ptr = [&](int r) {
    return xb + static_cast<long long>(min(max(r, 0), H - 1)) * WC;
  };

  // output span [o0, o1) of each output row, staged on the row's own
  // 16-byte grid: stage position = o - o0 + lead
  const int o0 = 2 * kx0 * C, o1 = 2 * kx1 * C;
  const unsigned yphase = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(yb) / sizeof(T) % N);

  // register window: rows ky0-2..ky0+1 in slots 1..4 (shifted down at the
  // first step), row ky0+2 in flight in `next`
  Pack<T> win[kWindow][5], next[kWindow];
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int k = tid + j * kThreads;
    if (k < nvec) {
      const int f = fs + k * N;
#pragma unroll
      for (int i = 1; i < 5; ++i)
        win[j][i] = load_pack(row_ptr(ky0 - 3 + i), f, WC, vec);
      next[j] = load_pack(row_ptr(ky0 + 2), f, WC, vec);
    }
  }

  // W-pass work items (kx - kx0, c) of this thread: i = tid + n*kThreads
  const int n_items = (kx1 - kx0) * C;
  const int q0 = tid / C, c0 = tid % C;
  const int dq = kThreads / C, dc = kThreads % C;
  // a block whose columns' halo lies inside the image needs no clamping
  const bool interior = kx0 >= 2 && kx1 + 2 <= W;
  const int base = kx0 * C - fs;  // H-row index of item 0

  for (int ky = ky0; ky < ky1; ++ky) {
    // ---- H pass
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      const int k = tid + j * kThreads;
      if (k < nvec) {
#pragma unroll
        for (int i = 0; i < 4; ++i) win[j][i] = win[j][i + 1];
        win[j][4] = next[j];
        if (ky + 1 < ky1)  // the next step's row, in flight meanwhile
          next[j] = load_pack(row_ptr(ky + 3), fs + k * N, WC, vec);
        h_filter(win[j], hrow + k * N);
      }
    }
    for (int k = tid + kWindow * kThreads; k < nvec; k += kThreads) {
      Pack<T> w5[5];
#pragma unroll
      for (int i = 0; i < 5; ++i)
        w5[i] = load_pack(row_ptr(ky - 2 + i), fs + k * N, WC, vec);
      h_filter(w5, hrow + k * N);
    }
    long long rbase[2];
    int lead[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rbase[r] = static_cast<long long>(2 * ky + r) * W2C;
      lead[r] = static_cast<int>((yphase + rbase[r] + o0) % N);
    }
    __syncthreads();  // H rows ready; the last store pass is done

    // ---- W pass: item i is (kx0 + q, c) with i = q*C + c, at flat
    // offset kx0*C + i of the input row; its outputs are at 2*q*C + c and
    // 2*q*C + c + C of the output span
    for (int i = tid, q = q0, c = c0; i < n_items;
         i += kThreads, q += dq, c += dc) {
      if (c >= C) {
        c -= C;
        ++q;
      }
      int s[5];
      if (interior) {
#pragma unroll
        for (int d = 0; d < 5; ++d) s[d] = base + i + (d - 2) * C;
      } else {
        const int kx = kx0 + q;
#pragma unroll
        for (int d = 0; d < 5; ++d)
          s[d] = min(max(kx - 2 + d, 0), W - 1) * C + c - fs;
      }
      float2 hv[5];
#pragma unroll
      for (int d = 0; d < 5; ++d) hv[d] = hrow[s[d]];
      const int o = i + q * C;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[5];
#pragma unroll
        for (int d = 0; d < 5; ++d) v[d] = r ? hv[d].y : hv[d].x;
        T* st = stage + r * scap + o + lead[r];
        st[0] = from_f32<T>(filter4(v, 0, 0));
        st[C] = from_f32<T>(filter4(v, 1, 1));
      }
    }
    __syncthreads();  // staged rows ready; the H rows are free

    // ---- store pass (overlaps the next step's H pass)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = o1 - o0 + lead[r];
      T* yr = yb + rbase[r] + o0 - lead[r];
      const T* st = stage + r * scap;
      for (int p = tid * N; p < n; p += kThreads * N) {
        if (p >= lead[r] && p + N <= n) {
          *reinterpret_cast<uint4*>(yr + p) =
              *reinterpret_cast<const uint4*>(st + p);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e)
            if (p + e >= lead[r] && p + e < n) yr[p + e] = st[p + e];
        }
      }
    }
  }
}

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename T>
int launch(const void* x, void* y, int B, int H, int W, int C, int tw,
           int rows, void* stream) {
  constexpr int N = Pack<T>::kN;
  if (B < 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || tw <= 0 ||
      rows <= 0 || 2LL * W * C + 4LL * C + 2 * N > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  // H rows: the span's columns, the alignment lead and a ragged end;
  // staged output rows: 2*tw pixels, lead and ragged end. Both multiples
  // of N, so every buffer starts on 16 bytes. ops/resize.py upsample_plan
  // computes the same size.
  const long long cap = round_up(min(tw + 4, W) * C + 2 * N, N);
  const long long scap = round_up(2 * min(tw, W) * C + 2 * N, N);
  const long long smem = cap * 8LL + 2 * scap * static_cast<long long>(
      sizeof(T));
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<upsample_kernel<T>>(
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + tw - 1) / tw, (H + rows - 1) / rows, B);
  upsample_kernel<T><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), H, W, C, tw, rows,
      static_cast<int>(cap), static_cast<int>(scap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int upsample_bicubic_x2_f32(const void* x, void* y, int B, int H,
                                       int W, int C, int tw, int rows,
                                       void* stream) {
  return launch<float>(x, y, B, H, W, C, tw, rows, stream);
}

extern "C" int upsample_bicubic_x2_bf16(const void* x, void* y, int B, int H,
                                        int W, int C, int tw, int rows,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, y, B, H, W, C, tw, rows, stream);
}
