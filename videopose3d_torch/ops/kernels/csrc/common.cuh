// Pieces every kernel of the port shares: dtype conversion at the points the TPU
// kernels cast, the block size of the row-tile and elementwise kernels, the
// cp.async group fences, and the launch with dynamic shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace vp3d {

constexpr int NT = 256;           // threads per CUDA block (row-tile, elementwise)
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may opt in to

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as the reference casts
}

// The value v takes once stored as T, held in float32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Opts the kernel in to `smem` bytes of dynamic shared memory and launches it.
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kern, dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace vp3d
