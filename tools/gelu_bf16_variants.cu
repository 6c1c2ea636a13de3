// Launch-shape variants of the bf16 GELU kernels, for timing beside the
// design of camradepth_tpu_torch/csrc/gelu_bf16.cu
// (tools/port_gelu_variants.py builds one library per variant). The file
// includes that source, so each variant shares its per-element code, its
// tables and its entry points, and adds two entry points of its own,
// gelu_bf16_variant and gelu_bf16_bwd_variant, whose launch shape the
// build sets with these macros:
//   UNROLL      16-byte vectors of each input per thread per iteration
//   SMEM_TABLE  0 to read the global table through L1 instead of a copy
//               in shared memory
//   FWD_STREAM, BWD_STREAM
//               1 to stream the loads (evict first), 2 the stores too
//   WAVES       a cap on the grid in waves of resident blocks, which then
//               strides over the tensor (0: no cap)

#include "gelu_bf16.cu"

#ifndef UNROLL
#define UNROLL 1
#endif
#ifndef SMEM_TABLE
#define SMEM_TABLE 1
#endif
#ifndef FWD_STREAM
#define FWD_STREAM 0
#endif
#ifndef BWD_STREAM
#define BWD_STREAM 0
#endif
#ifndef WAVES
#define WAVES 0
#endif

namespace {

template <int Stream>
__device__ __forceinline__ uint4 load_vec(const uint4* p) {
  if (Stream >= 1) return __ldcs(p);
  return *p;
}

template <int Stream>
__device__ __forceinline__ void store_vec(uint4* p, uint4 v) {
  if (Stream >= 2)
    __stcs(p, v);
  else
    *p = v;
}

// Thread t of a block takes the vectors base + k * kThreads (k < Unroll)
// of each iteration, base = the block's first vector + t, plus grid
// strides. The first iteration's loads are issued before the block
// copies its table, the next iteration's before the current one is
// computed.
template <int Unroll, bool SmemTable, int Stream>
__global__ void __launch_bounds__(kThreads)
    variant_fwd_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                       const __nv_bfloat16* __restrict__ xs,
                       __nv_bfloat16* __restrict__ ys, long long nv,
                       long long n) {
  __shared__ __align__(16) unsigned short s_table[SmemTable ? kGeluTable
                                                            : 8];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads *
                           Unroll;
  long long v = static_cast<long long>(blockIdx.x) * kThreads * Unroll +
                threadIdx.x;
  uint4 cur[Unroll];
#pragma unroll
  for (int k = 0; k < Unroll; ++k)
    if (v + k * kThreads < nv) cur[k] = load_vec<Stream>(x + v + k * kThreads);
  const unsigned short* table = g_gelu_table;
  if (SmemTable) {
    load_gelu_table(s_table);
    __syncthreads();
    table = s_table;
  }
  for (; v < nv; v += stride) {
    uint4 next[Unroll];
#pragma unroll
    for (int k = 0; k < Unroll; ++k)
      if (v + stride + k * kThreads < nv)
        next[k] = load_vec<Stream>(x + v + stride + k * kThreads);
#pragma unroll
    for (int k = 0; k < Unroll; ++k)
      if (v + k * kThreads < nv)
        store_vec<Stream>(y + v + k * kThreads, gelu_vec(cur[k], table));
#pragma unroll
    for (int k = 0; k < Unroll; ++k) cur[k] = next[k];
  }
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  for (long long e = nv * 8 + t; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads)
    ys[e] = __ushort_as_bfloat16(
        gelu_bits(__bfloat16_as_ushort(xs[e]), table));
}

template <int Unroll, bool SmemTable, int Stream>
__global__ void __launch_bounds__(kThreads)
    variant_bwd_kernel(const uint4* __restrict__ x, const uint4* __restrict__ b,
                       uint4* __restrict__ dx,
                       const __nv_bfloat16* __restrict__ xs,
                       const __nv_bfloat16* __restrict__ bs,
                       __nv_bfloat16* __restrict__ dxs, long long nv,
                       long long n) {
  __shared__ __align__(16) unsigned short s_table[SmemTable ? kGeluHalf
                                                            : 8];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads *
                           Unroll;
  long long v = static_cast<long long>(blockIdx.x) * kThreads * Unroll +
                threadIdx.x;
  uint4 cx[Unroll], cb[Unroll];
#pragma unroll
  for (int k = 0; k < Unroll; ++k)
    if (v + k * kThreads < nv) {
      cx[k] = load_vec<Stream>(x + v + k * kThreads);
      cb[k] = load_vec<Stream>(b + v + k * kThreads);
    }
  const unsigned short* table = g_vjp_table;
  if (SmemTable) {
    copy_table(s_table, g_vjp_table, kVjpTableVecs);
    __syncthreads();
    table = s_table;
  }
  for (; v < nv; v += stride) {
    uint4 nx[Unroll], nb[Unroll];
#pragma unroll
    for (int k = 0; k < Unroll; ++k)
      if (v + stride + k * kThreads < nv) {
        nx[k] = load_vec<Stream>(x + v + stride + k * kThreads);
        nb[k] = load_vec<Stream>(b + v + stride + k * kThreads);
      }
#pragma unroll
    for (int k = 0; k < Unroll; ++k)
      if (v + k * kThreads < nv)
        store_vec<Stream>(dx + v + k * kThreads,
                          vjp_vec(cx[k], cb[k], table));
#pragma unroll
    for (int k = 0; k < Unroll; ++k) {
      cx[k] = nx[k];
      cb[k] = nb[k];
    }
  }
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  for (long long e = nv * 8 + t; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads)
    dxs[e] = __ushort_as_bfloat16(static_cast<unsigned short>(
        vjp_pair(__bfloat16_as_ushort(xs[e]), __bfloat16_as_ushort(bs[e]),
                 table)));
}

// Blocks for nv vectors (n elements when nv is 0) of UNROLL vectors per
// thread, at most WAVES waves of resident blocks (no cap at 0).
template <typename Kernel>
int variant_grid(Kernel kernel, long long nv, long long n) {
  const long long per_block = nv > 0 ? kThreads * UNROLL : kThreads;
  long long want = ((nv > 0 ? nv : n) + per_block - 1) / per_block;
  if (want > 0x7fffffffLL) want = 0x7fffffffLL;  // the grid strides on
  if (WAVES <= 0) return static_cast<int>(want);
  static int per_sm = 0;  // blocks of `kernel` resident on one SM
  if (per_sm <= 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                     kThreads, 0) !=
           cudaSuccess ||
       per_sm <= 0))
    per_sm = 1;
  const long long cap = static_cast<long long>(per_sm) * sm_count() * WAVES;
  return static_cast<int>(want > cap ? cap : want);
}

}  // namespace

extern "C" int gelu_bf16_variant(const void* x, void* y, long long n,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t ready = gelu_table_ready(st);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const long long nv = aligned16(x) && aligned16(y) ? n / 8 : 0;
  const auto kernel =
      &variant_fwd_kernel<UNROLL, SMEM_TABLE != 0, FWD_STREAM>;
  kernel<<<variant_grid(kernel, nv, n), kThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      nv, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gelu_bf16_bwd_variant(const void* x, const void* gy, void* gx,
                                     long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t ready = vjp_table_ready(st);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const long long nv =
      aligned16(x) && aligned16(gy) && aligned16(gx) ? n / 8 : 0;
  const auto kernel =
      &variant_bwd_kernel<UNROLL, SMEM_TABLE != 0, BWD_STREAM>;
  kernel<<<variant_grid(kernel, nv, n), kThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(gy),
      static_cast<uint4*>(gx), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(gx),
      nv, n);
  return static_cast<int>(cudaGetLastError());
}
