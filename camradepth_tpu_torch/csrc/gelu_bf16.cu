// bf16 GELU and its VJP, rounded as the JAX package rounds them, for
// Hopper (sm_90a).
//
// No TPU kernel: this is XLA's elementwise GELU of the JAX package
// (camradepth_tpu/models/layers.py:33-41, jax.nn.gelu(x, approximate=True)
// on bf16), which evaluates the tanh form as eight bf16 operations, each
// rounded to bf16, with bf16 constants:
//
//   y = x * (0.5 * (1 + tanh(0.796875 * (x + 0.044677734375 * x*x*x))))
//
// and its VJP (the jaxpr of jax.vjp(partial(jax.nn.gelu, approximate=True),
// x)[1] on bf16), 21 operations, each rounded to bf16: from x alone
//   d = x*x, e = 3*d, c = d*x, f = 0.044677734375*c, g = x + f,
//   h = 0.796875*g, i = tanh(h), j = 1 - i, k = 1 + i, l = 0.5*k,
// and with the cotangent b
//   m = x*b, n = b*l, o = 0.5*m, p = o*j, q = p*i, r = p + q,
//   s = 0.796875*r, t = n + s, u = 0.044677734375*s, v = u*e, dx = t + v.
// The plain versions (ops/gelu.py `gelu_bf16_reference` and
// `gelu_bf16_backward_reference`) repeat them with torch's bf16 operators;
// the kernels agree with them bit for bit.
//
// Bound on the H100: bytes, at 3.35 TB/s; 4 per element forward (x in, y
// out), 6 backward (x and b in, dx out). Evaluated as written, the
// operations take ~45 (forward) and ~90 (backward) instructions per
// element, mostly the accurate tanhf and the roundings, which bounds the
// kernels by instructions instead. The design removes that:
// - Every x-only value is a function of x's 16 bits, and is trivial outside
//   the inputs of exponent fields 118 to 128 (gelu_bf16.cuh; checked on
//   every bf16 input by tests/test_torch_gelu.py). The forward's result
//   for those 2,816 inputs, and the VJP's term i = tanh(h) for the 1,408
//   positive ones (i is odd in x), are evaluated once per device into
//   tables in global memory, at the first launch on it (one launch and
//   one wait); each block copies its table (5.5 or 2.75 KB) into shared
//   memory, a read from L2, and looks every element up. Outside the
//   fields: forward x*0.5 rounded, x or -0; backward i = 0.796875*x
//   rounded below, +-1 above. inf and NaN take the operations as written.
// - Backward, per element there remain the cheap x-only terms e (two
//   products), j and l (two sums, one product) and the 11 cotangent
//   operations m..dx, on pairs of elements in bf16x2 arithmetic, which
//   rounds each result once from its exact value: a product of two bf16
//   values is exact in fp32 and so is the sum of two whose exponents
//   differ by at most 16, and a smaller addend lies far inside the larger
//   one's rounding interval, so every result equals the plain version's
//   fp32 operation rounded (and the sweep of chip_smoke.py (h) checks it
//   on every x against 545 cotangents). Each operation names its
//   rounding (.rn), so that no product is contracted into an FMA.
// - One 16-byte vector of each input per thread, one thread per vector:
//   a grid that strides over the tensor with fewer, longer-lived blocks,
//   more vectors per thread, the table read from global memory, and
//   streaming loads or stores were each timed beside this design
//   (tools/port_gelu_variants.py; PERF.md). A tail, or a tensor whose
//   storage is not 16-byte aligned, goes element by element.

#include <cuda_bf16.h>

#include "gelu_bf16.cuh"

namespace {

constexpr int kThreads = 256;

// bf16x2 products and sums, each rounded once from its exact value to
// nearest even. That is the plain version's fp32 operation rounded, for
// every input: a product of two bf16 values is exact in fp32, and so is
// the sum of two whose exponents differ by at most 16 (at most 24
// significant bits); when they differ by more, the smaller is under
// 2^-15 of the larger's binade, so the exact and the fp32 sum both lie
// far inside the larger value's rounding interval. The rounding is
// named (.rn) so that no product is contracted with a sum into an FMA,
// which would round once where the plain version rounds twice.
__device__ __forceinline__ unsigned mul_rn(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned add_rn(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// --- the VJP ------------------------------------------------------------

// g_vjp_table[p] = the bf16 bits of the term i = tanh(h) of the p-th
// tabled positive input. i is odd in x, bit for bit (each operation of
// its chain is, and so is rounding to nearest even), so a negative x
// reads its magnitude's entry and flips the sign.
__device__ __align__(16) unsigned short g_vjp_table[kGeluHalf];
constexpr int kVjpTableVecs = kGeluHalf * 2 / 16;

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// i as the operations give it (x a value of bf16).
__device__ __forceinline__ float vjp_tanh_of(float x) {
  const float d = bf16_round(x * x);
  const float c = bf16_round(d * x);
  const float f = bf16_round(0.044677734375f * c);
  const float g = bf16_round(x + f);
  const float h = bf16_round(0.796875f * g);
  return bf16_round(tanhf(h));
}

__global__ void vjp_table_kernel() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kGeluHalf)
    g_vjp_table[i] =
        bf16_bits(vjp_tanh_of(bf16_bits_to_float(gelu_table_input(i))));
}

cudaError_t vjp_table_ready(cudaStream_t stream) {
  return fill_once_per_device(
      [](cudaStream_t s) {
        vjp_table_kernel<<<(kGeluHalf + 255) / 256, 256, 0, s>>>();
      },
      stream);
}

// The bits of i for the bf16 bits u: the table, or the shortcuts around
// it (0.796875 x rounded below, +-1 above).
__device__ __forceinline__ unsigned vjp_tanh(unsigned u,
                                             const unsigned short* table) {
  const unsigned pos = gelu_table_pos(u);
  if (pos < kGeluHalf) return table[pos] ^ (u & 0x8000u);
  const unsigned field = (u >> 7) & 0xffu;
  const float x = bf16_bits_to_float(u);
  if (field < kGeluLo) return bf16_bits(0.796875f * x);
  if (field == 0xffu) return bf16_bits(vjp_tanh_of(x));  // inf and NaN
  return (u >> 15) ? 0xbf80u : 0x3f80u;
}

// i of a pair of bf16 values x (element 0 in the low half).
__device__ __forceinline__ unsigned vjp_tanh_pair(
    unsigned x, const unsigned short* table) {
  const unsigned lo = gelu_table_pos(x & 0xffffu);
  const unsigned hi = gelu_table_pos(x >> 16);
  if (lo < kGeluHalf && hi < kGeluHalf)  // both in the table
    return (table[lo] | static_cast<unsigned>(table[hi]) << 16) ^
           (x & 0x80008000u);
  return vjp_tanh(x & 0xffffu, table) | vjp_tanh(x >> 16, table) << 16;
}

// dx of two elements: x and the cotangent b as bf16x2 bits (element 0 in
// the low half).
__device__ __forceinline__ unsigned vjp_pair(unsigned x, unsigned b,
                                             const unsigned short* table) {
  // 1, 0.5, 3, 0.796875 and 0.044677734375 in both halves
  constexpr unsigned kOne = 0x3f803f80u, kHalf = 0x3f003f00u,
                     kThree = 0x40404040u, kSq = 0x3f4c3f4cu,
                     kKappa = 0x3d373d37u;
  const unsigned i = vjp_tanh_pair(x, table);
  const unsigned e = mul_rn(kThree, mul_rn(x, x));
  const unsigned j = add_rn(kOne, i ^ 0x80008000u);  // 1 - i
  const unsigned l = mul_rn(kHalf, add_rn(kOne, i));
  const unsigned m = mul_rn(x, b);
  const unsigned n = mul_rn(b, l);
  const unsigned o = mul_rn(kHalf, m);
  const unsigned p = mul_rn(o, j);
  const unsigned q = mul_rn(p, i);
  const unsigned r = add_rn(p, q);
  const unsigned s = mul_rn(kSq, r);
  const unsigned t = add_rn(n, s);
  const unsigned u = mul_rn(kKappa, s);
  const unsigned v = mul_rn(u, e);
  return add_rn(t, v);
}

__device__ __forceinline__ uint4 vjp_vec(uint4 x, uint4 b,
                                         const unsigned short* table) {
  return make_uint4(vjp_pair(x.x, b.x, table), vjp_pair(x.y, b.y, table),
                    vjp_pair(x.z, b.z, table), vjp_pair(x.w, b.w, table));
}

// --- the forward -----------------------------------------------------------

// gelu_bf16_table on bf16 bits.
__device__ __forceinline__ unsigned gelu_bits(unsigned u,
                                              const unsigned short* table) {
  const unsigned pos = gelu_table_pos(u);
  if (pos < kGeluHalf) return table[pos + (u >> 15) * kGeluHalf];
  const unsigned field = (u >> 7) & 0xffu;
  const float x = bf16_bits_to_float(u);
  if (field < kGeluLo) return bf16_bits(x * 0.5f);
  if (field == 0xffu) return bf16_bits(gelu_bf16_jax(x));  // inf and NaN
  return (u >> 15) ? 0x8000u : u;  // -0 or x
}

__device__ __forceinline__ unsigned gelu_pair(unsigned x,
                                              const unsigned short* table) {
  return gelu_bits(x & 0xffffu, table) | gelu_bits(x >> 16, table) << 16;
}

__device__ __forceinline__ uint4 gelu_vec(uint4 x,
                                          const unsigned short* table) {
  return make_uint4(gelu_pair(x.x, table), gelu_pair(x.y, table),
                    gelu_pair(x.z, table), gelu_pair(x.w, table));
}

// --- the launches ----------------------------------------------------------

// Thread t of the grid takes vector t, issuing its loads before the block
// copies its table, and element nv * 8 + t of the tail (every element,
// one per thread, when nv is 0).
__global__ void __launch_bounds__(kThreads)
    gelu_bf16_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                     const __nv_bfloat16* __restrict__ xs,
                     __nv_bfloat16* __restrict__ ys, long long nv,
                     long long n) {
  __shared__ __align__(16) unsigned short table[kGeluTable];
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  uint4 v;
  if (t < nv) v = x[t];
  load_gelu_table(table);
  __syncthreads();
  if (t < nv) y[t] = gelu_vec(v, table);
  const long long e = nv * 8 + t;
  if (e < n)
    ys[e] = __ushort_as_bfloat16(
        gelu_bits(__bfloat16_as_ushort(xs[e]), table));
}

__global__ void __launch_bounds__(kThreads)
    gelu_bf16_bwd_kernel(const uint4* __restrict__ x,
                         const uint4* __restrict__ b, uint4* __restrict__ dx,
                         const __nv_bfloat16* __restrict__ xs,
                         const __nv_bfloat16* __restrict__ bs,
                         __nv_bfloat16* __restrict__ dxs, long long nv,
                         long long n) {
  __shared__ __align__(16) unsigned short table[kGeluHalf];
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  uint4 vx, vb;
  if (t < nv) {
    vx = x[t];
    vb = b[t];
  }
  copy_table(table, g_vjp_table, kVjpTableVecs);
  __syncthreads();
  if (t < nv) dx[t] = vjp_vec(vx, vb, table);
  const long long e = nv * 8 + t;
  if (e < n)
    dxs[e] = __ushort_as_bfloat16(static_cast<unsigned short>(
        vjp_pair(__bfloat16_as_ushort(xs[e]), __bfloat16_as_ushort(bs[e]),
                 table)));
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Blocks of kThreads for nv vectors and the tail (n elements when nv is
// 0); 0 past the grid's limit.
unsigned grid_for(long long nv, long long n) {
  const long long items = nv > 0 ? nv : n;
  const long long blocks = (items + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int gelu_bf16(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t ready = gelu_table_ready(st);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const long long nv = aligned16(x) && aligned16(y) ? n / 8 : 0;
  const unsigned grid = grid_for(nv, n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  gelu_bf16_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      nv, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gelu_bf16_bwd(const void* x, const void* gy, void* gx,
                             long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t ready = vjp_table_ready(st);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const long long nv =
      aligned16(x) && aligned16(gy) && aligned16(gx) ? n / 8 : 0;
  const unsigned grid = grid_for(nv, n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  gelu_bf16_bwd_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(gy),
      static_cast<uint4*>(gx), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(gx),
      nv, n);
  return static_cast<int>(cudaGetLastError());
}
