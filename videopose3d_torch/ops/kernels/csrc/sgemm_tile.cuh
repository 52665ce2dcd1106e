// The 128 x 128-tile CUDA-core SGEMM pieces the train-block GEMMs share
// (dw_gemm, and the tap GEMMs of conv_stats, norm_drop_matmul_stats, dz_matmul_dd
// and du_dtaps_res).
//
// A CUDA block of GT_THREADS = 256 threads owns a GT x GT (128 x 128) output tile;
// thread (ty, tx) owns rows ty * 4 + {0, 64} + 0..3 and columns tx * 4 + {0, 64} +
// 0..3, an 8 x 8 register tile (four FMAs per shared-memory float read).  A warp
// holds the 4 x 8 threads ty = 4 (warp / 2) + lane / 8, tx = 8 (warp % 2) + lane % 8,
// so that each fragment read of a warp is one 64-byte (rows) or 128-byte (columns)
// line of shared memory.  Both operands sit in shared memory K-major: slabs of
// GK = 32 rows of the summed dimension, each row GT values of the tile's rows or
// columns.  Every sum is a float32 FMA chain in k order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vp3d {

constexpr int GT = 128;         // output tile (GT x GT)
constexpr int GK = 32;          // summed-dimension rows per shared-memory slab
constexpr int GRT = 8;          // register tile per thread (GRT x GRT)
constexpr int GT_THREADS = (GT / GRT) * (GT / GRT);

// 4 elements (16 bytes of float32, 8 of bf16) from global to shared memory without
// passing through registers; zeros where !valid (no global read then).
template <typename T>
__device__ __forceinline__ void cp_async4(T* smem, const T* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 * (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of rows [r0, min(r0 + GK, r_end)) and columns [c0, c0 + GT) of
// the row-major g (leading dimension ld, c_end columns) into the slab s
// ([GK][GT]); rows and columns outside are zero-filled.  Each warp copies whole
// 512-byte (float32) row segments.  c_end % 4 == 0.
template <typename T>
__device__ __forceinline__ void slab_cp_async(T* s, const T* __restrict__ g, size_t ld,
                                              int r0, int r_end, int c0, int c_end) {
  constexpr int PER_ROW = GT / 4;
#pragma unroll
  for (int q = 0; q < GK * PER_ROW / GT_THREADS; ++q) {
    const int e = threadIdx.x + q * GT_THREADS;
    const int rr = e / PER_ROW, cc = (e % PER_ROW) * 4, r = r0 + rr;
    const bool ok = r < r_end && c0 + cc < c_end;
    cp_async4(s + rr * GT + cc, g + (ok ? (size_t)r * ld + c0 + cc : 0), ok);
  }
}

// 8 values of one staged row as float32: elements base + 0..3 and base + 64 + 0..3,
// read as 16-byte (float32) or 8-byte (bf16) vectors.
template <typename T>
__device__ __forceinline__ void tile_frag(float (&f)[GRT], const T* row, int base) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const T* p = row + base + g * (GT / 2);
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      f[4 * g] = v.x;
      f[4 * g + 1] = v.y;
      f[4 * g + 2] = v.z;
      f[4 * g + 3] = v.w;
    } else {  // bf16 is the top half of a float32: widening is a shift, exact
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      f[4 * g] = __uint_as_float(v.x << 16);
      f[4 * g + 1] = __uint_as_float(v.x & 0xffff0000u);
      f[4 * g + 2] = __uint_as_float(v.y << 16);
      f[4 * g + 3] = __uint_as_float(v.y & 0xffff0000u);
    }
  }
}

// acc[p][q] += af[p] * bf[q]: row p of the register tile left to right, row p + 1
// right to left, so each FMA shares an operand with the one before (the register
// reuse cache).
__device__ __forceinline__ void tile_fma(float (&acc)[GRT][GRT], const float (&af)[GRT],
                                         const float (&bf)[GRT]) {
#pragma unroll
  for (int p = 0; p < GRT; ++p) {
#pragma unroll
    for (int x = 0; x < GRT; ++x) {
      const int q = p % 2 ? GRT - 1 - x : x;
      acc[p][q] = fmaf(af[p], bf[q], acc[p][q]);
    }
  }
}

__device__ __forceinline__ void tile_zero(float (&acc)[GRT][GRT]) {
#pragma unroll
  for (int p = 0; p < GRT; ++p) {
#pragma unroll
    for (int q = 0; q < GRT; ++q) acc[p][q] = 0.f;
  }
}

// This thread's (ty, tx) in the warp layout above.
__device__ __forceinline__ int tile_ty() {
  return (threadIdx.x / 64) * 4 + threadIdx.x % 32 / 8;
}
__device__ __forceinline__ int tile_tx() {
  return (threadIdx.x / 32) % 2 * 8 + threadIdx.x % 8;
}

// Row (p = 0..7) and column group (g = 0, 1) offsets of the register tile.
__device__ __forceinline__ int tile_row(int ty, int p) {
  return ty * 4 + (p / 4) * (GT / 2) + p % 4;
}
__device__ __forceinline__ int tile_col(int tx, int g) { return tx * 4 + g * (GT / 2); }

}  // namespace vp3d
