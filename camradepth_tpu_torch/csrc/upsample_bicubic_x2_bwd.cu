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
// (__fmul_rn, __fadd_rn), in the order of the plain version
// (ops/resize.py `_adjoint_axis_x2`), so the two agree bit for bit. This
// is the gather form: each input collects from its own outputs (an edge
// row also from the pad rows' outputs), so there are no atomics and the
// result is deterministic.
//
// Two launches of one kernel: the W axis (outer B*2H rows, n = W, inner C)
// into a [B, 2H, W, C] workspace of the I/O type, then the H axis (outer B,
// n = H, inner W*C). One thread per output element, the inner axis
// fastest, so the eight loads of a warp are each coalesced.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The transpose's taps, in the order of s (W(1.75) W(1.25) W(0.75) ...).
__device__ __constant__ float kTaps[8] = {
    -0.03515625f, -0.10546875f, 0.26171875f, 0.87890625f,
    0.87890625f,  0.26171875f,  -0.10546875f, -0.03515625f};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Step 1 for padded row j of the axis at `base` (stride `inner`).
template <typename T>
__device__ __forceinline__ float padded_row(const T* __restrict__ g,
                                            long long base, long long inner,
                                            int n, int j) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int o = 2 * j - 7 + s;
    const bool in = o >= 0 && o < 2 * n;
    const float v = in ? to_f32(g[base + o * inner]) : 0.f;
    const float term = __fmul_rn(kTaps[s], v);
    acc = s == 0 ? term : __fadd_rn(acc, term);
  }
  return round_to<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    adjoint_axis_kernel(const T* __restrict__ g, T* __restrict__ out,
                        long long outer, int n, long long inner) {
  const long long total = outer * n * inner;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += stride) {
    const long long c = e % inner;
    const long long r = e / inner;
    const int i = static_cast<int>(r % n);
    const long long base = (r / n) * (2LL * n) * inner + c;
    float v = padded_row(g, base, inner, n, i + 2);
    if (i == n - 1) {  // step 2, the far edge first
      const float tail = round_to<T>(
          __fadd_rn(padded_row(g, base, inner, n, n + 2),
                    padded_row(g, base, inner, n, n + 3)));
      v = round_to<T>(__fadd_rn(v, tail));
    }
    if (i == 0) {
      const float head = round_to<T>(
          __fadd_rn(padded_row(g, base, inner, n, 0),
                    padded_row(g, base, inner, n, 1)));
      v = round_to<T>(__fadd_rn(v, head));
    }
    out[e] = from_f32<T>(v);
  }
}

int grid_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = 16LL * sm_count();
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T>
int launch(const void* gy, void* work, void* gx, int B, int H, int W, int C,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  const long long wc = static_cast<long long>(W) * C;
  // W axis: [B*2H, 2W, C] -> [B*2H, W, C]
  adjoint_axis_kernel<T><<<grid_for(2LL * B * H * wc), kThreads, 0, s>>>(
      static_cast<const T*>(gy), static_cast<T*>(work), 2LL * B * H, W, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // H axis: [B, 2H, W*C] -> [B, H, W*C]
  adjoint_axis_kernel<T><<<grid_for(static_cast<long long>(B) * H * wc),
                           kThreads, 0, s>>>(
      static_cast<const T*>(work), static_cast<T*>(gx), B, H, wc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (gy [B, 2H, 2W, C], work [B, 2H, W, C], gx [B, H, W, C], B, H, W, C,
//  stream)
extern "C" int upsample_bicubic_x2_bwd_f32(const void* gy, void* work,
                                           void* gx, int B, int H, int W,
                                           int C, void* stream) {
  return launch<float>(gy, work, gx, B, H, W, C, stream);
}

extern "C" int upsample_bicubic_x2_bwd_bf16(const void* gy, void* work,
                                            void* gx, int B, int H, int W,
                                            int C, void* stream) {
  return launch<__nv_bfloat16>(gy, work, gx, B, H, W, C, stream);
}
