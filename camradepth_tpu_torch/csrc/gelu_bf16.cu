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
//
// Backward (`gelu_bf16_bwd`): the VJP of the same bf16 GELU as JAX computes
// it (the jaxpr of jax.vjp(partial(jax.nn.gelu, approximate=True), x)[1]
// on bf16), 21 operations, each rounded to bf16: from x alone
//   d = x*x, e = 3*d, c = d*x, f = 0.044677734375*c, g = x + f,
//   h = 0.796875*g, i = tanh(h), j = 1 - i, k = 1 + i, l = 0.5*k,
// and with the cotangent b
//   m = x*b, n = b*l, o = 0.5*m, p = o*j, q = p*i, r = p + q,
//   s = 0.796875*r, t = n + s, u = 0.044677734375*s, v = u*e, dx = t + v.
// The plain version (ops/gelu.py `gelu_bf16_backward_reference`) repeats
// them with torch's bf16 operators, bit for bit. One thread per 8 elements
// (two 16-byte loads, one store), each evaluated in full; 6 bytes per
// element, and the accurate tanhf, which makes this kernel bound by
// instructions at about 90 per element, not by bytes.

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

__device__ __forceinline__ float gelu_bwd_of(float x, float b) {
  const float d = bf16_round(x * x);
  const float e = bf16_round(3.0f * d);
  const float c = bf16_round(d * x);
  const float f = bf16_round(0.044677734375f * c);
  const float g = bf16_round(x + f);
  const float h = bf16_round(0.796875f * g);
  const float i = bf16_round(tanhf(h));
  const float j = bf16_round(1.0f - i);
  const float k = bf16_round(1.0f + i);
  const float l = bf16_round(0.5f * k);
  const float m = bf16_round(x * b);
  const float n = bf16_round(b * l);
  const float o = bf16_round(0.5f * m);
  const float p = bf16_round(o * j);
  const float q = bf16_round(p * i);
  const float r = bf16_round(p + q);
  const float s = bf16_round(0.796875f * r);
  const float t = bf16_round(n + s);
  const float u = bf16_round(0.044677734375f * s);
  const float v = bf16_round(u * e);
  return t + v;  // rounded by the caller's store
}

__global__ void __launch_bounds__(kThreads)
    gelu_bf16_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ gy,
                         __nv_bfloat16* __restrict__ gx, long long n,
                         int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec) {
    const long long nv = n / 8;
    for (; i < nv; i += stride) {
      const uint4 ux = reinterpret_cast<const uint4*>(x)[i];
      uint4 ug = reinterpret_cast<const uint4*>(gy)[i];
      const __nv_bfloat16* ex = reinterpret_cast<const __nv_bfloat16*>(&ux);
      __nv_bfloat16* eg = reinterpret_cast<__nv_bfloat16*>(&ug);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        eg[j] = __float2bfloat16_rn(gelu_bwd_of(__bfloat162float(ex[j]),
                                                __bfloat162float(eg[j])));
      reinterpret_cast<uint4*>(gx)[i] = ug;
    }
    i = nv * 8 + (i - nv);  // the first tail element of this thread
  }
  for (; i < n; i += stride)
    gx[i] = __float2bfloat16_rn(
        gelu_bwd_of(__bfloat162float(x[i]), __bfloat162float(gy[i])));
}

}  // namespace

extern "C" int gelu_bf16_bwd(const void* x, const void* gy, void* gx,
                             long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int vec = aligned(x) && aligned(gy) && aligned(gx);
  const long long work = vec ? (n + 7) / 8 : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = 8LL * sm_count();
  gelu_bf16_bwd_kernel<<<static_cast<int>(want < cap ? want : cap), kThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(gx),
      n, vec);
  return static_cast<int>(cudaGetLastError());
}

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
