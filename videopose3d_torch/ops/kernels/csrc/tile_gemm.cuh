// The CUDA-core row-tile GEMM the evaluation block kernels (K3) are built on; its
// TM and CPT also shape the int8 kernels' dp4a tiles (int8_gemm.cuh).
//
// gemm_tile: a CUDA block of NT=256 threads owns TM=16 rows of A (float32, in
// shared memory) and up to NP=1024 output columns per pass; each thread owns CPT=4
// columns (col0 + tid + q*256), strided so that every weight load of a warp is one
// contiguous 128-byte line, and accumulates a 16x4 register tile.  A operands are
// read from shared memory as float4 broadcasts; the next 4 weight rows are loaded
// into registers, unconverted, while the current 4 are used.

#pragma once

#include "common.cuh"

namespace vp3d {

constexpr int TM = 16;            // rows of A per CUDA block
constexpr int CPT = 4;            // output columns per thread per pass
constexpr int NP = NT * CPT;      // output columns per pass

// Loads 4 weight rows k..k+3 of this thread's columns as stored (type T).  Kept
// unconverted so the loads of the next rows stay in flight while the current
// rows are used; a conversion right after the load would wait for it.
template <typename T>
__device__ __forceinline__ void load_w(T (&w)[4][CPT], const T* __restrict__ W, int ldw,
                                       int n, int k_end, int k, const int (&col)[CPT]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      w[kk][q] = (k + kk < k_end && col[q] < n) ? W[(size_t)(k + kk) * ldw + col[q]]
                                                : from_f<T>(0.f);
    }
  }
}

// acc[r][q] += sum_{k < K} A[r * lda + k] * W[k * ldw + col0 + tid + q * NT].
// A lives in shared memory, 16-byte aligned, lda % 4 == 0, and holds zeros from K
// up to the next multiple of 4.  Columns at or past n contribute nothing.
template <typename T>
__device__ __forceinline__ void gemm_tile(float (&acc)[TM][CPT], const float* A, int lda,
                                          int K, const T* __restrict__ W, int ldw, int n,
                                          int col0) {
  int col[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) col[q] = col0 + threadIdx.x + q * NT;
  T raw[4][CPT];
  load_w<T>(raw, W, ldw, n, K, 0, col);
  for (int k = 0; k < K; k += 4) {
    float w[4][CPT];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < CPT; ++q) w[kk][q] = to_f<T>(raw[kk][q]);
    }
    if (k + 4 < K) load_w<T>(raw, W, ldw, n, K, k + 4, col);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        float s = acc[r][q];
        s = fmaf(a.x, w[0][q], s);
        s = fmaf(a.y, w[1][q], s);
        s = fmaf(a.z, w[2][q], s);
        s = fmaf(a.w, w[3][q], s);
        acc[r][q] = s;
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][CPT]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[r][q] = 0.f;
  }
}

}  // namespace vp3d
