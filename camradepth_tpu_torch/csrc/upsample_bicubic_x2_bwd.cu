// Adjoint of the bicubic x2 upsample for Hopper (sm_90a).
//
// The TPU kernel camradepth_tpu/ops/resize_pallas.py `_upsample_pallas_4d`
// (:190-228, pl.pallas_call at :209) has no Pallas backward: its VJP is
// XLA's transpose of the two-phase filter (:250-255, of
// camradepth_tpu/ops/resize.py:79-122). This kernel is that transpose on
// the card, for the forward of upsample_bicubic_x2.cu: the forward filters
// H, rounds to the I/O type, then filters W; the adjoint takes the W axis
// back in fp32, rounds to the I/O type, then takes the H axis back in fp32
// and rounds, so in bf16 it rounds where the plain version
// (ops/resize.py `upsample_bicubic_x2_backward_reference`) rounds.
//
// One axis of length n (2n outputs). Output o = 2k + p reads the padded
// inputs k + p .. k + p + 3 with the phase's weights, and a padded input j
// is the input clamp(j - 2, 0, n - 1) (edge replication). So input i
// receives from the outputs o in [2i - 3, 2i + 4], with a coefficient
// A[o][i] = sum of the phase weights whose clamped tap is i: the eight
// weights W(1.75) W(1.25) W(0.75) W(0.25) W(0.25) W(0.75) W(1.25) W(1.75)
// inside the image, and at the two edges the taps that fall outside fold
// into rows (or columns) 0 and n - 1. The weights are dyadic with few bits,
// so every A[o][i] is exact in fp32 whatever the order of its sum. Each
// input then sums A[o][i] * g[o] over its eight slots in the order of o,
// every product and sum rounded on its own (__fmul_rn, __fadd_rn), with
// slots outside [0, 2n) contributing 0 * 0, as the plain version sums them.
// This is the gather form: each input collects from its own eight
// outputs, so there are no atomics and the result is deterministic.
//
// Two launches of one kernel: the W axis (outer B*2H rows, n = W, inner C)
// into a [B, 2H, W, C] workspace of the I/O type, then the H axis (outer B,
// n = H, inner W*C). One thread per output element, the inner axis
// fastest, so the eight loads of a warp are each coalesced.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Bicubic weights at distances 1.75, 0.75, 0.25, 1.25 (a = -0.75): the even
// phase's taps 0..3; the odd phase uses them reversed.
__device__ __constant__ float kWEven[4] = {-0.03515625f, 0.26171875f,
                                           0.87890625f, -0.10546875f};

// A[o][i] for one axis of length n, 0 outside [0, 2n).
__device__ __forceinline__ float coef(int o, int i, int n) {
  if (o < 0 || o >= 2 * n) return 0.f;
  const int k = o >> 1;
  const int p = o & 1;
  float a = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int tap = min(max(k + p + t - 2, 0), n - 1);
    if (tap == i) a += p ? kWEven[3 - t] : kWEven[t];
  }
  return a;
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
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int o = 2 * i - 3 + s;
      const bool in = o >= 0 && o < 2 * n;
      const float v = in ? to_f32(g[base + o * inner]) : 0.f;
      const float term = __fmul_rn(coef(o, i, n), v);
      acc = s == 0 ? term : __fadd_rn(acc, term);
    }
    out[e] = from_f32<T>(acc);
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
