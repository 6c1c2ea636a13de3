// bf16 GELU, rounded as the JAX package rounds it, for Hopper (sm_90a).
//
// No TPU kernel: this is XLA's elementwise GELU of the JAX package
// (camradepth_tpu/models/layers.py:33-41, jax.nn.gelu(x, approximate=True)
// on bf16), which evaluates the tanh form as eight bf16 operations, each
// rounded to bf16, with bf16 constants:
//
//   y = x * (0.5 * (1 + tanh(0.796875 * (x + 0.044677734375 * x*x*x))))
//
// The kernel repeats those operations in that order, rounding after each
// (__float2bfloat16_rn), as the plain version camradepth_tpu_torch/ops/
// gelu.py `gelu_bf16_reference` does with torch's bf16 operators, so the two
// agree bit for bit. One launch replaces the plain version's eight.
//
// Bound on the H100: 2 bytes read and 2 written per element at 3.35 TB/s.
// The eight rounded operations with an accurate tanhf take ~45
// instructions per element, which would bound the kernel by instructions
// instead; so each block first evaluates them for the 2,816 inputs whose
// result is not x/2, x or -0 into a shared-memory table (gelu_bf16.cuh),
// and looks every element up. Each thread moves 8 elements as one 16-byte
// vector; a tail, or a tensor whose storage is not 16-byte aligned, goes
// element by element.

#include "gelu_bf16.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ __nv_bfloat16 gelu_of(__nv_bfloat16 v,
                                                 const unsigned short* table) {
  return __float2bfloat16_rn(gelu_bf16_table(__bfloat162float(v), table));
}

__global__ void __launch_bounds__(kThreads)
    gelu_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     __nv_bfloat16* __restrict__ y, long long n, int vec) {
  __shared__ unsigned short table[kGeluTable];
  fill_gelu_table(table);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec) {
    const long long nv = n / 8;
    for (; i < nv; i += stride) {
      uint4 u = reinterpret_cast<const uint4*>(x)[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = gelu_of(e[j], table);
      reinterpret_cast<uint4*>(y)[i] = u;
    }
    i = nv * 8 + (i - nv);  // the first tail element of this thread
  }
  for (; i < n; i += stride) y[i] = gelu_of(x[i], table);
}

}  // namespace

extern "C" int gelu_bf16(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int vec = reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                  reinterpret_cast<unsigned long long>(y) % 16 == 0;
  const long long work = vec ? (n + 7) / 8 : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = 8LL * sm_count();  // full occupancy: 2048 threads
  gelu_bf16_kernel<<<static_cast<int>(want < cap ? want : cap), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n,
      vec);
  return static_cast<int>(cudaGetLastError());
}
