// Shared helpers of the port's CUDA kernels: typed loads and stores that
// compute in fp32 over bf16 or fp32 storage, and the error-string export
// every kernel library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// Round to nearest even, as PyTorch's float -> bfloat16 conversion.
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Streaming multiprocessors of the current device (132 on an H100 SXM).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

// Let `Kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// ask) on the current device; asked once per kernel and device.
template <auto Kernel>
inline cudaError_t allow_smem(int bytes) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kDevices) allowed[dev] = bytes;
  return err;
}

extern "C" const char* camradepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
