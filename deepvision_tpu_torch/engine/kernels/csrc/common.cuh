// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is exported through a plain C function that takes raw
// device pointers, shapes and the caller's stream, launches, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DvDtype { DV_BF16 = 0, DV_F32 = 1, DV_I8 = 2 };

constexpr float DV_NEG_INF = -1e30f;  // the JAX kernels' mask value

template <typename T>
__device__ __forceinline__ float dv_to_f32(T x);
template <>
__device__ __forceinline__ float dv_to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float dv_to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float dv_to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T dv_from_f32(float x);
template <>
__device__ __forceinline__ float dv_from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 dv_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Raise a kernel's dynamic shared-memory cap once per instantiation.
template <typename Kernel>
inline cudaError_t dv_allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Registers, shared memory (static and dynamic), local (spill) bytes,
// blocks an SM and threads of one kernel, as the card will run it:
// out[0..4].
template <typename Kernel>
inline int dv_kernel_info(Kernel kernel, int threads, int bytes, int* out) {
  cudaError_t err = dv_allow_smem(kernel, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = bytes + static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = blocks;
  out[4] = threads;
  return 0;
}
