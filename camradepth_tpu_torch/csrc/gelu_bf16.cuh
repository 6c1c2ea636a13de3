// The bf16 GELU of the JAX package, operation by operation, shared by the
// elementwise GELU kernel and the fused conv's on-load transform, and the
// same function as a lookup that both kernels use on their hot path.
#pragma once

#include "common.cuh"

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
// signs, fields 118 to 128) need the operations, and a block evaluates
// them once into a table in shared memory.
constexpr int kGeluLo = 118;  // exponent fields of the table: [kGeluLo,
constexpr int kGeluHi = 129;  // kGeluHi)
constexpr int kGeluHalf = (kGeluHi - kGeluLo) * 128;  // entries per sign
constexpr int kGeluTable = 2 * kGeluHalf;

// table[i] = the bf16 bits of gelu(x) for the i-th tabled input, filled by
// the block's threads; the caller synchronises before reading it.
__device__ __forceinline__ void fill_gelu_table(unsigned short* table) {
  for (int i = threadIdx.x; i < kGeluTable; i += blockDim.x) {
    const int sign = i / kGeluHalf;
    const int r = i - sign * kGeluHalf;
    const unsigned bits = (static_cast<unsigned>(sign) << 15) |
                          (static_cast<unsigned>(kGeluLo + r / 128) << 7) |
                          static_cast<unsigned>(r % 128);
    table[i] = __bfloat16_as_ushort(
        __float2bfloat16_rn(gelu_bf16_jax(__uint_as_float(bits << 16))));
  }
}

// gelu_bf16_jax(x) for x holding a bf16 value, through the table.
__device__ __forceinline__ float gelu_bf16_table(float x,
                                                 const unsigned short* table) {
  const unsigned u = __float_as_uint(x) >> 16;
  const unsigned e = (u >> 7) & 0xffu;
  if (e < kGeluLo) return bf16_round(x * 0.5f);
  if (e >= kGeluHi) {
    if (e == 0xffu) return gelu_bf16_jax(x);  // inf and NaN
    return (u >> 15) ? -0.0f : x;
  }
  const unsigned i =
      (u >> 15) * kGeluHalf + (e - kGeluLo) * 128 + (u & 0x7fu);
  return __uint_as_float(static_cast<unsigned>(table[i]) << 16);
}
