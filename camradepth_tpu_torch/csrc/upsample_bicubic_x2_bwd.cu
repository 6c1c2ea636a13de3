// Adjoint of the bicubic x2 upsample for Hopper (sm_90a).
//
// The TPU kernel camradepth_tpu/ops/resize_pallas.py `_upsample_pallas_4d`
// (:190-228, pl.pallas_call at :209) has no Pallas backward: its VJP is
// XLA's transpose of the two-phase filter (:250-255, of
// camradepth_tpu/ops/resize.py:79-122). This kernel is that transpose on
// the card, for the forward of upsample_bicubic_x2.cu: the forward filters
// H, rounds to the I/O type, then filters W; the adjoint takes the W axis
// back, then the H axis, each rounded where XLA rounds it (below), so in
// bf16 it equals the JAX package's VJP and the plain version
// (ops/resize.py `upsample_bicubic_x2_backward_reference`) bit for bit.
//
// One axis of length n (2n outputs). The forward pads the axis by two
// copies of each edge row (jnp.pad(mode="edge"), camradepth_tpu/ops/
// resize.py:84-86) and filters the padded rows j = 0 .. n + 3: output
// o = 2k + p reads padded rows k + p .. k + p + 3 with the phase's weights.
// So padded row j receives the outputs o = 2j - 7 + s (s = 0..7) with the
// eight weights W(1.75) W(1.25) W(0.75) W(0.25) W(0.25) W(0.75) W(1.25)
// W(1.75), and XLA's transpose, read from its optimized HLO on bf16, is:
//   1. each padded row sums its eight terms in fp32 and rounds to the I/O
//      type (slots outside [0, 2n) contribute weight * 0);
//   2. the last two padded rows are added, rounded, and added into row
//      n - 1, rounded; then the first two are added, rounded, and added
//      into row 0, rounded (for n = 1 both folds land on row 0, in that
//      order).
// The kernel does exactly this, every product and sum rounded on its own
// (__fmul_rn, __fadd_rn; in bf16 a fused multiply-add where the product
// is exact, see `mad`), in the order of the plain version (ops/resize.py
// `_adjoint_axis_x2`), so the two agree bit for bit. It is the gather
// form: no atomics, deterministic.
//
// Bound on the H100: bytes. gy is read once and gx written once: the five
// decoder shapes of `base` at 416x800 move 287 MB per bf16 batch-2
// microbatch, 0.086 ms at 3.35 TB/s; 94 % of it at C = 129.
//
// Design: one launch, both axes, no workspace. A block owns a run of
// kRun = 4 gx columns [x0, x0 + 4) at a tile of blockDim channels (a
// thread a channel), and a strip of `rows` gx rows [r0, r1) of one image
// (grid: runs x tiles, strips, B). The launch is ops/resize.py
// `upsample_backward_plan`'s: block size, tiles, rows, grid, staged row
// sizes and shared bytes come from it as they are.
//   Stream: the block reads the gy rows that feed its strip in order of o,
//     two at a time (o = 2m - 1, 2m for m = j0 - 3 .. j1 - 1, with j the
//     padded gx row: j0 = r0 + 2, j1 = r1 + 2, and j0 = 0 or j1 = H + 4 at
//     the image's first or last strip, for the pad rows the H folds read).
//     Each row's gy columns 2 x0 - 3 .. 2 x0 + 10, every channel, are
//     staged in shared memory by 16-byte cp.async, three pairs ahead, one
//     barrier a pair.
//     That is 2R + 6 rows for R gx rows; rows o outside [0, 2H) are the H
//     pad's zeros and are not read.
//   W axis: a thread reads its channel's 14 staged columns once (a warp
//     reads neighbouring channels, neighbouring words) and takes steps 1
//     and 2 along W for its four columns from those registers, rounded to
//     the I/O type: 14 shared loads for four columns, where a gather per
//     column takes 32.
//   H axis: padded row j takes the W results of rows o = 2j - 7 .. 2j, so
//     a pair (2m - 1, 2m) adds its terms to padded rows m .. m + 3 (s = 6,
//     4, 2, 0, then 7, 5, 3, 1) and completes row m. The four are a ring of
//     fp32 accumulators in registers, in the plain version's order of s.
//     A completed row is rounded to the I/O type, folded (rows 0 and H - 1
//     keep what the folds need in shared memory until it arrives), staged
//     in shared memory at its place on the 16-byte grid and stored with
//     16-byte vectors during the next pair (element stores where gx rows
//     lie off the grid or the block covers part of the channels).
// gy is read once from device memory plus a halo of 6 rows per strip (the
// 3 + 4 halo columns come from L2); gx is written once. Offsets inside an
// image are 32-bit. A gy row off the 16-byte grid is staged element by
// element, inside the kernel (no copy aside, no fallback).
// At the largest shape it reaches 28 % of its DRAM bound (NVIDIA H100 80GB
// HBM3 at 700 W): the staging, the shared loads and the H ring alone,
// without the W sums, take 73 % of its time, and each variant measured
// beside it (PERF.md §6: a thread per element gathering 8 taps; global
// loads with no staging; runs spread over blocks of 256 items; 8 columns
// a thread; 2 to 4 runs a block) was slower.

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxThreads = 256;    // threads (channels) of a block, at most
constexpr int kRun = 4;             // gx columns of a block
constexpr int kWin = 2 * kRun + 6;  // gy columns they read
constexpr int kSmemMax = 232448;    // per block on the H100
constexpr int kStages = 4;          // staged gy row pairs, 3 in flight

// The transpose's weight for slot s (W(1.75) W(1.25) W(0.75) W(0.25) ...),
// s a compile-time index after unrolling.
__device__ __forceinline__ float tap(int s) {
  const int i = s < 4 ? s : 7 - s;
  return i == 0 ? -0.03515625f
       : i == 1 ? -0.10546875f
       : i == 2 ? 0.26171875f
                : 0.87890625f;
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// acc + w * v, rounded as the plain version rounds it: the product, then
// the sum. In bf16 the product of a tap (a multiple of 1/256 below 1 in
// magnitude) and a bf16 value is exact in fp32 (at most 16 significant
// bits, none below 2^-141, whatever the value), so one fused multiply-add
// rounds exactly as the two operations do; in fp32 they stay apart.
template <typename T>
__device__ __forceinline__ float mad(float w, float v, float acc);
template <>
__device__ __forceinline__ float mad<float>(float w, float v, float acc) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}
template <>
__device__ __forceinline__ float mad<__nv_bfloat16>(float w, float v,
                                                    float acc) {
  return __fmaf_rn(w, v, acc);
}

// Step 1 along W: the padded column whose first gy column is window index
// `base` (a compile-time index after unrolling): sum over s of tap(s) *
// v[base + s], zero outside the window and the row.
template <typename T>
__device__ __forceinline__ float padded(const float (&v)[kWin], int base) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int j = base + s;
    const float g = j >= 0 && j < kWin ? v[j] : 0.f;
    acc = s == 0 ? __fmul_rn(tap(s), g) : mad<T>(tap(s), g, acc);
  }
  return round_to<T>(acc);
}

// Steps 1 and 2 along W for column x = x0 + k of the run, from the window
// of gy columns 2 x0 - 3 .. 2 x0 + 10 (the far edge's pads read columns
// 2k + 2 .. and 2k + 4 .., the near edge's 2k - 4 .. and 2k - 2 ..).
template <typename T>
__device__ __forceinline__ float w_adjoint(const float (&v)[kWin], int k,
                                           int x, int W) {
  float gw = padded<T>(v, 2 * k);
  if (x == W - 1) {  // the far edge first
    const float tail = round_to<T>(
        __fadd_rn(padded<T>(v, 2 * k + 2), padded<T>(v, 2 * k + 4)));
    gw = round_to<T>(__fadd_rn(gw, tail));
  }
  if (x == 0) {
    const float head = round_to<T>(
        __fadd_rn(padded<T>(v, 2 * k - 4), padded<T>(v, 2 * k - 2)));
    gw = round_to<T>(__fadd_rn(gw, head));
  }
  return gw;
}

// Stage gy row o's flat elements [ga_al, gb) (ga_al on the 16-byte grid
// when `vec`) at dst; whole vectors inside the row by cp.async, the rest
// (and every element of a row off the grid) element by element.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* __restrict__ src,
                                          int ga_al, int gb, int w2c,
                                          bool vec) {
  constexpr int N = 16 / sizeof(T);
  if (vec) {
    const int nv = (gb - ga_al + N - 1) / N;
    for (int k = threadIdx.x; k < nv; k += blockDim.x) {
      const int f = ga_al + k * N;
      if (f >= 0 && f + N <= w2c) {
        cp_async16(smem_addr(dst + k * N), src + f, true);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (f + e >= 0 && f + e < w2c) dst[k * N + e] = src[f + e];
      }
    }
  } else {
    for (int p = threadIdx.x; p < gb - ga_al; p += blockDim.x)
      dst[p] = src[ga_al + p];
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 3)
    adjoint_kernel(const T* __restrict__ gy, T* __restrict__ gx, int H,
                   int W, int C, int rows, int tiles, int rowcap, int ocap) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);  // [kStages][2 rows][rowcap]
  T* const orow = stage + 2 * kStages * rowcap;  // [2][ocap] gx rows to store
  T* const hold = orow + 2 * ocap;  // [3][kRun][blockDim] fold operands

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int WC = W * C, W2C = 2 * WC;
  const int run = blockIdx.x / tiles;
  const int c = (blockIdx.x - run * tiles) * nthr + tid;
  const bool live = c < C;
  const int x0 = kRun * run, x1 = min(x0 + kRun, W);
  const int r0 = blockIdx.y * rows, r1 = min(r0 + rows, H);
  if (x0 >= W || r0 >= H) return;  // past the image: the whole block
  const T* __restrict__ gyb =
      gy + static_cast<long long>(blockIdx.z) * 2 * H * W2C;
  T* __restrict__ gxb = gx + static_cast<long long>(blockIdx.z) * H * WC;

  // staged gy: columns [col0, col0 + kWin) of each row, flat [ga, gb),
  // from ga_al
  const int col0 = 2 * x0 - 3;
  const int ga = max(0, col0 * C), gb = min(W2C, (col0 + kWin) * C);
  const bool vec_in = W2C % N == 0;
  const int phase = static_cast<int>(
      reinterpret_cast<uintptr_t>(gyb) / sizeof(T) % N);
  const int ga_al = vec_in ? ga - (phase + ga) % N : ga;
  const bool inside = col0 >= 0 && col0 + kWin <= 2 * W;
  const int idx0 = col0 * C + c - ga_al;  // shared index of column col0

  // gx: the run's elements [e0, e0 + len) of a row, staged from `lead`
  const bool vec_out = tiles == 1 && WC % N == 0 &&
                       reinterpret_cast<uintptr_t>(gxb) % 16 == 0;
  const int e0 = x0 * C, len = (x1 - x0) * C, lead = e0 % N;

  const int j0 = r0 == 0 ? 0 : r0 + 2, j1 = r1 == H ? H + 4 : r1 + 2;
  const int m_first = j0 - 3, m_last = j1 - 1;
  const auto stage_pair = [&](int m, int buf) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int o = 2 * m - 1 + t;
      if (o >= 0 && o < 2 * H)
        stage_row(stage + (2 * buf + t) * rowcap,
                  gyb + static_cast<long long>(o) * W2C, ga_al, gb, W2C,
                  vec_in);
    }
  };
  const auto store_row = [&](int r, int buf) {
    T* dst = gxb + static_cast<long long>(r) * WC + e0 - lead;
    const T* src = orow + buf * ocap;
    const int n = lead + len;
    for (int p = tid * N; p < n; p += nthr * N) {
      if (p >= lead && p + N <= n) {
        *reinterpret_cast<uint4*>(dst + p) =
            *reinterpret_cast<const uint4*>(src + p);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (p + e >= lead && p + e < n) dst[p + e] = src[p + e];
      }
    }
  };

  // ring: padded rows m, m + 1, m + 2 carried into pair m
  float acc[3][kRun];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int k = 0; k < kRun; ++k) acc[q][k] = 0.f;

  // pairs m_first .. m_first + kStages - 2 in flight before the first
  for (int i = 0; i < kStages - 1; ++i) {
    if (m_first + i <= m_last) stage_pair(m_first + i, i);
    cp_async_commit();
  }
  int pending = -1;  // gx row in orow waiting to be stored
  for (int m = m_first; m <= m_last; ++m) {
    const int it = m - m_first, buf = it & 1, sbuf = it % kStages;
    cp_async_wait<kStages - 2>();
    // pair m staged; every thread is done with pair m - 1 and orow[buf ^ 1]
    // holds its row
    __syncthreads();
    // the buffer pair m - 1 used takes pair m + kStages - 1
    if (m + kStages - 1 <= m_last)
      stage_pair(m + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    if (pending >= 0) store_row(pending, buf ^ 1);

    // the W adjoint of both rows of the pair at the thread's columns
    float w[2][kRun];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int o = 2 * m - 1 + t;
      if (o >= 0 && o < 2 * H && live) {
        const T* row = stage + (2 * sbuf + t) * rowcap;
        float v[kWin];
#pragma unroll
        for (int j = 0; j < kWin; ++j) {
          const int col = col0 + j;
          v[j] = inside || (col >= 0 && col < 2 * W)
                     ? to_f32(row[idx0 + j * C])
                     : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kRun; ++k)
          w[t][k] = w_adjoint<T>(v, k, x0 + k, W);
      } else {
#pragma unroll
        for (int k = 0; k < kRun; ++k) w[t][k] = 0.f;
      }
    }

    // row m completes in this pair: what to do with it (block-uniform)
    const int r = m - 2;
    const bool own = m >= j0;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      // odd row o = 2m - 1: slots s = 6, 4, 2, 0; even row 2m: 7, 5, 3, 1
      const float a0 =
          mad<T>(tap(7), w[1][k], mad<T>(tap(6), w[0][k], acc[0][k]));
      const float a1 =
          mad<T>(tap(5), w[1][k], mad<T>(tap(4), w[0][k], acc[1][k]));
      const float a2 =
          mad<T>(tap(3), w[1][k], mad<T>(tap(2), w[0][k], acc[2][k]));
      const float a3 =
          mad<T>(tap(1), w[1][k], __fmul_rn(tap(0), w[0][k]));
      acc[0][k] = a1;
      acc[1][k] = a2;
      acc[2][k] = a3;
      if (!own || !live || x0 + k >= W) continue;
      float P = round_to<T>(a0);  // padded row m, step 1
      T* const h = hold + k * nthr + tid;  // hold[slot][k][tid]
      const int stride = kRun * nthr;
      bool done = false;
      if (m < 2) {  // the first pads: P(0), then the head
        h[0] = from_f32<T>(m == 0 ? P
                                  : round_to<T>(__fadd_rn(to_f32(h[0]), P)));
      } else if (r < H - 1) {
        if (r == 0) P = round_to<T>(__fadd_rn(P, to_f32(h[0])));
        done = true;
      } else if (r == H - 1) {
        h[stride] = from_f32<T>(P);
      } else if (m == H + 2) {
        h[2 * stride] = from_f32<T>(P);
      } else {  // m == H + 3: the tail, into row H - 1, then the head
        const float tail = round_to<T>(__fadd_rn(to_f32(h[2 * stride]), P));
        P = round_to<T>(__fadd_rn(to_f32(h[stride]), tail));
        if (H == 1) P = round_to<T>(__fadd_rn(P, to_f32(h[0])));
        done = true;
      }
      if (done) {
        const int row = min(r, H - 1);
        if (vec_out)
          orow[buf * ocap + lead + k * C + c] = from_f32<T>(P);
        else
          gxb[static_cast<long long>(row) * WC + (x0 + k) * C + c] =
              from_f32<T>(P);
      }
    }
    pending = vec_out && own && r >= 0 && (r < H - 1 || m == H + 3)
                  ? min(r, H - 1)
                  : -1;
  }
  __syncthreads();  // orow of the last pair complete
  if (pending >= 0) store_row(pending, (m_last - m_first) & 1);
}

template <typename T>
int launch(const void* gy, void* gx, int B, int H, int W, int C, int threads,
           int tiles, int rows, int grid_x, int grid_y, int rowcap, int ocap,
           int smem, void* stream) {
  constexpr int N = 16 / sizeof(T);
  if (B < 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 || tiles <= 0 || rows <= 0 ||
      grid_x <= 0 || grid_y <= 0 || rowcap <= 0 || rowcap % N ||
      ocap <= 0 || ocap % N || smem <= 0 || smem > kSmemMax ||
      4LL * W * C + 16LL * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = allow_smem<adjoint_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  adjoint_kernel<T><<<dim3(grid_x, grid_y, B), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gy), static_cast<T*>(gx), H, W, C, rows, tiles,
      rowcap, ocap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (gy [B, 2H, 2W, C], gx [B, H, W, C], B, H, W, C, then the plan: threads
//  per block, channel tiles, gx rows per block, grid x and y, elements
//  staged per gy row and per gx row, shared bytes; stream)
extern "C" int upsample_bicubic_x2_bwd_f32(const void* gy, void* gx, int B,
                                           int H, int W, int C, int threads,
                                           int tiles, int rows, int grid_x,
                                           int grid_y, int rowcap, int ocap,
                                           int smem, void* stream) {
  return launch<float>(gy, gx, B, H, W, C, threads, tiles, rows, grid_x,
                       grid_y, rowcap, ocap, smem, stream);
}

extern "C" int upsample_bicubic_x2_bwd_bf16(const void* gy, void* gx, int B,
                                            int H, int W, int C, int threads,
                                            int tiles, int rows, int grid_x,
                                            int grid_y, int rowcap, int ocap,
                                            int smem, void* stream) {
  return launch<__nv_bfloat16>(gy, gx, B, H, W, C, threads, tiles, rows,
                               grid_x, grid_y, rowcap, ocap, smem, stream);
}
