// The bf16 GELU of the JAX package, operation by operation, shared by the
// elementwise GELU kernels and the fused conv's on-load transform, and the
// same function as a lookup that both kernels use on their hot path.
#pragma once

#include <atomic>
#include <mutex>

#include "common.cuh"

// Internal linkage for everything below: each kernel library that includes
// this header keeps its own table on each device and its own record of
// the devices it has filled. (With external linkage the function-local
// statics of fill_once_per_device are unique symbols shared by every
// library loaded in the process: one library's fill would mark another's
// table as filled.)
namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The fp32 value of bf16 bits.
__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// jax.nn.gelu(x, approximate=True) on bf16: eight operations, each rounded
// to bf16, with the constants sqrt(2/pi) and 0.044715 rounded to bf16
// (0.796875 and 0.044677734375). tanhf is the accurate fp32 tanh, as
// torch's bf16 tanh uses.
__device__ __forceinline__ float gelu_bf16_jax(float x) {
  const float cube = bf16_round(bf16_round(x * x) * x);
  const float inner =
      bf16_round(bf16_round(x + bf16_round(cube * 0.044677734375f)) *
                 0.796875f);
  const float half =
      bf16_round(bf16_round(bf16_round(tanhf(inner)) + 1.0f) * 0.5f);
  return bf16_round(x * half);
}

__device__ __forceinline__ __nv_bfloat16 gelu_bf16_jax(__nv_bfloat16 x) {
  return __float2bfloat16_rn(gelu_bf16_jax(__bfloat162float(x)));
}

// A bf16 input has 65,536 values, so the eight rounded operations above
// are a function of its bits. Checked over every input (tests/
// test_torch_gelu.py): for |x| < 2^-9 (exponent field below 118) the
// result is x * 0.5 rounded, for finite |x| >= 4 (field 129 and up) it is
// x when x > 0 and -0 when x < 0. Only the 2,816 inputs in between (both
// signs, fields 118 to 128) need the operations. They are evaluated once
// per device into a table in global memory (gelu_table_ready), and each
// block copies it into shared memory (load_gelu_table).
constexpr int kGeluLo = 118;  // exponent fields of the table: [kGeluLo,
constexpr int kGeluHi = 129;  // kGeluHi)
constexpr int kGeluHalf = (kGeluHi - kGeluLo) * 128;  // entries per sign
constexpr int kGeluTable = 2 * kGeluHalf;
constexpr int kGeluTableVecs = kGeluTable * 2 / 16;  // as 16-byte vectors
static_assert(kGeluHalf * 2 % 16 == 0, "the tables copy as uint4");

// The position of bf16 bits u in its sign's half of a table: below
// kGeluHalf exactly when u's exponent field is in [kGeluLo, kGeluHi) (it
// wraps around below). Its entry is then pos + (u >> 15) * kGeluHalf.
__device__ __forceinline__ unsigned gelu_table_pos(unsigned u) {
  return (u & 0x7fffu) - kGeluLo * 128u;
}

// The bf16 bits of the i-th tabled input.
__device__ __forceinline__ unsigned gelu_table_input(int i) {
  const int sign = i / kGeluHalf;
  const int r = i - sign * kGeluHalf;
  return (static_cast<unsigned>(sign) << 15) |
         (static_cast<unsigned>(kGeluLo + r / 128) << 7) |
         static_cast<unsigned>(r % 128);
}

// g_gelu_table[i] = the bf16 bits of gelu(x) for the i-th tabled input.
__device__ __align__(16) unsigned short g_gelu_table[kGeluTable];

__global__ void gelu_table_kernel() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kGeluTable)
    g_gelu_table[i] = __bfloat16_as_ushort(__float2bfloat16_rn(
        gelu_bf16_jax(bf16_bits_to_float(gelu_table_input(i)))));
}

// Runs `fill(stream)` (a launch that fills a table in global memory) at
// the first call on the current device, then waits for it, so that a
// kernel on any stream finds the table filled. Each fill (each lambda
// type) keeps its own record of the devices it has filled; a later call
// reads it without the lock. Not inside a CUDA graph capture: the first
// call on a device synchronises.
template <typename Fill>
inline cudaError_t fill_once_per_device(Fill fill, cudaStream_t stream) {
  static std::mutex lock;
  static std::atomic<bool> ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> guard(lock);
  if (ready[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  fill(stream);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return err;
}

// Fills g_gelu_table on the current device at its first use there.
inline cudaError_t gelu_table_ready(cudaStream_t stream) {
  return fill_once_per_device(
      [](cudaStream_t s) {
        gelu_table_kernel<<<(kGeluTable + 255) / 256, 256, 0, s>>>();
      },
      stream);
}

// Copies `vecs` 16-byte vectors of a table from global memory into
// `table` (16-byte aligned shared memory) with the block's threads; the
// caller synchronises before reading it.
__device__ __forceinline__ void copy_table(unsigned short* table,
                                           const unsigned short* global,
                                           int vecs) {
  const uint4* src = reinterpret_cast<const uint4*>(global);
  uint4* dst = reinterpret_cast<uint4*>(table);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void load_gelu_table(unsigned short* table) {
  copy_table(table, g_gelu_table, kGeluTableVecs);
}

// gelu_bf16_jax(x) for x holding a bf16 value, through the table.
__device__ __forceinline__ float gelu_bf16_table(float x,
                                                 const unsigned short* table) {
  const unsigned u = __float_as_uint(x) >> 16;
  const unsigned pos = gelu_table_pos(u);
  if (pos < kGeluHalf)
    return bf16_bits_to_float(table[pos + (u >> 15) * kGeluHalf]);
  const unsigned e = (u >> 7) & 0xffu;
  if (e < kGeluLo) return bf16_round(x * 0.5f);
  if (e == 0xffu) return gelu_bf16_jax(x);  // inf and NaN
  return (u >> 15) ? -0.0f : x;
}

}  // namespace
