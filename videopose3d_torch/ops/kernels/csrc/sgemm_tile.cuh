// The 128 x 128-tile CUDA-core SGEMM pieces the train-block GEMMs (dw_gemm, and
// the tap GEMMs of conv_stats, norm_drop_matmul_stats, dz_matmul_dd and
// du_dtaps_res) and the float32 evaluation blocks (temporal_block.cu) share.
//
// A CUDA block of GT_THREADS = 256 threads owns a GT x GT (128 x 128) output tile;
// thread (ty, tx) owns rows ty * 4 + {0, 64} + 0..3 and columns tx * 4 + {0, 64} +
// 0..3, an 8 x 8 register tile (four FMAs per shared-memory float read).  A warp
// holds the 4 x 8 threads ty = 4 (warp / 2) + lane / 8, tx = 8 (warp % 2) + lane % 8,
// so that each fragment read of a warp is one 64-byte (rows) or 128-byte (columns)
// line of shared memory.  Both operands sit in shared memory K-major: slabs of
// GK = 32 rows of the summed dimension, each row GT values of the tile's rows or
// columns.  Every sum is a float32 FMA chain in k order.
//
// A tap GEMM's A operand is row-major in the summed dimension: each thread reads a
// 4 x 4 block of its next slab into registers (rows 4 (threadIdx.x / 8) + 0..3,
// summed-dimension columns (threadIdx.x % 8) * 4 + 0..3) and a_store_slab stores it
// transposed into an A_STAGES-deep ring; B flows through a B_STAGES-deep cp.async
// ring.  tile_gemm_loop is that main loop, with the caller's map from tile rows to
// A's rows; tile_store_part stores a split's float32 sums of a tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace vp3d {

constexpr int GT = 128;         // output tile (GT x GT)
constexpr int GK = 32;          // summed-dimension rows per shared-memory slab
constexpr int GRT = 8;          // register tile per thread (GRT x GRT)
constexpr int GT_THREADS = (GT / GRT) * (GT / GRT);
constexpr int A_STAGES = 2;  // A slabs in shared memory (staged through registers)
constexpr int B_STAGES = 3;  // B slabs in the cp.async ring
constexpr int TAP_SLAB = GK * GT;

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

// 4 consecutive values of T at p (global or shared) as float32 into f[0..3]: one
// 16-byte (float32) or 8-byte (bf16) load.
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* f) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {  // bf16 is the top half of a float32: widening is a shift, exact
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// 8 values of one staged row as float32: elements base + 0..3 and base + 64 + 0..3,
// read as 16-byte (float32) or 8-byte (bf16) vectors.
template <typename T>
__device__ __forceinline__ void tile_frag(float (&f)[GRT], const T* row, int base) {
#pragma unroll
  for (int g = 0; g < 2; ++g) load4(row + base + g * (GT / 2), f + 4 * g);
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

// 4 consecutive elements of T in one register word group.
template <typename T> struct Vec4 { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

// The XOR swizzle of A's slabs: slab row kk keeps 4-row group gi at group
// gi ^ a_swizzle<T>(kk).  It puts the transposing stores of a_store_slab in
// distinct banks (float32: 8 lanes of 16 bytes per phase, bf16: 16 of 8 bytes) and
// keeps a fragment read one 16-byte (8-byte) vector.
template <typename T>
__device__ __forceinline__ int a_swizzle(int kk) {
  return ((kk / 4) % 8) * (sizeof(T) == 4 ? 1 : 2);
}

// Stores this thread's 4 x 4 block ra of A (rows 4 (threadIdx.x / 8) + r, slab
// columns (threadIdx.x % 8) * 4 + 0..3) transposed into the slab as ([GK][GT],
// K-major): four vector stores, one per slab row, of the block's 4 rows.
template <typename T>
__device__ __forceinline__ void a_store_slab(T* as, const typename Vec4<T>::type (&ra)[4]) {
  const int kl = (threadIdx.x % 8) * 4, gi = threadIdx.x / 8;
  T* dst = as + kl * GT + (gi ^ a_swizzle<T>(kl)) * 4;
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(ra[0].x, ra[1].x, ra[2].x, ra[3].x);
    *reinterpret_cast<float4*>(dst + GT) = make_float4(ra[0].y, ra[1].y, ra[2].y, ra[3].y);
    *reinterpret_cast<float4*>(dst + 2 * GT) =
        make_float4(ra[0].z, ra[1].z, ra[2].z, ra[3].z);
    *reinterpret_cast<float4*>(dst + 3 * GT) =
        make_float4(ra[0].w, ra[1].w, ra[2].w, ra[3].w);
  } else {  // 0x5410: the low bf16 of each word, 0x7632: the high one
    *reinterpret_cast<uint2*>(dst) = make_uint2(__byte_perm(ra[0].x, ra[1].x, 0x5410),
                                                __byte_perm(ra[2].x, ra[3].x, 0x5410));
    *reinterpret_cast<uint2*>(dst + GT) = make_uint2(__byte_perm(ra[0].x, ra[1].x, 0x7632),
                                                     __byte_perm(ra[2].x, ra[3].x, 0x7632));
    *reinterpret_cast<uint2*>(dst + 2 * GT) =
        make_uint2(__byte_perm(ra[0].y, ra[1].y, 0x5410), __byte_perm(ra[2].y, ra[3].y, 0x5410));
    *reinterpret_cast<uint2*>(dst + 3 * GT) =
        make_uint2(__byte_perm(ra[0].y, ra[1].y, 0x7632), __byte_perm(ra[2].y, ra[3].y, 0x7632));
  }
}

// 4 values of T from float32 (already rounded to T) at dst: one 16- or 8-byte store.
template <typename T>
__device__ __forceinline__ void store4(T* dst, float v0, float v1, float v2, float v3) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v0, v1, v2, v3);
  } else {  // the top halves of the float32 values are their bf16 bits
    const uint32_t lo = __float_as_uint(v0) >> 16 | (__float_as_uint(v1) & 0xffff0000u);
    const uint32_t hi = __float_as_uint(v2) >> 16 | (__float_as_uint(v3) & 0xffff0000u);
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  }
}

// The main loop of the GT x GT tile at columns j0.. over the summed rows [k_begin,
// k_end): acc = A @ B, a float32 FMA chain in k order.  B (row-major, n columns, n
// also its leading dimension) flows through the B_STAGES-deep cp.async ring b_s;
// a_load(ra, k0) reads this thread's 4 x 4 block of A's slab from summed row k0
// into registers while the slab before is used, and a_store(slab, ra, k0) stores it
// transposed into a slab of the A_STAGES-deep ring a_s (a_store_slab, and whatever
// else the caller keeps of A).
template <typename T, typename ALoad, typename AStore>
__device__ __forceinline__ void tile_gemm_loop(float (&acc)[GRT][GRT], T* a_s, T* b_s,
                                               const T* __restrict__ b, int n, int j0,
                                               int k_begin, int k_end, ALoad&& a_load,
                                               AStore&& a_store) {
  const int slabs = (k_end - k_begin + GK - 1) / GK;
  const int ty = tile_ty(), tx = tile_tx();
  tile_zero(acc);
  for (int s = 0; s < B_STAGES - 1; ++s) {
    if (s < slabs) slab_cp_async(b_s + s * TAP_SLAB, b, n, k_begin + s * GK, k_end, j0, n);
    cp_async_commit();
  }
  typename Vec4<T>::type ra[4];
  a_load(ra, k_begin);
  a_store(a_s, ra, k_begin);
  if (slabs > 1) a_load(ra, k_begin + GK);
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<B_STAGES - 2>();  // this thread's copies of B's slab t have landed
    __syncthreads();                // everyone's, and A's slab t; slab t - 1 is consumed
    if (t + B_STAGES - 1 < slabs) {
      const int next = t + B_STAGES - 1;
      slab_cp_async(b_s + (next % B_STAGES) * TAP_SLAB, b, n, k_begin + next * GK, k_end, j0,
                    n);
    }
    cp_async_commit();
    if (t + 1 < slabs) {  // A's slab t + 1 into the stage slab t - 1 left
      a_store(a_s + ((t + 1) % A_STAGES) * TAP_SLAB, ra, k_begin + (t + 1) * GK);
      if (t + 2 < slabs) a_load(ra, k_begin + (t + 2) * GK);
    }
    const T* as = a_s + (t % A_STAGES) * TAP_SLAB;
    const T* bs = b_s + (t % B_STAGES) * TAP_SLAB;
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      float af[GRT], bf[GRT];
      tile_frag(af, as + k * GT, (ty ^ a_swizzle<T>(k)) * 4);
      tile_frag(bf, bs + k * GT, tx * 4);
      tile_fma(acc, af, bf);
    }
  }
}

// A split's products: the tile's float32 sums (rows i0.., columns j0..) as slice
// blockIdx.z of part, (slices, m, n) row-major; what lies past m or n is dropped.
__device__ __forceinline__ void tile_store_part(const float (&acc)[GRT][GRT], float* part,
                                                int m, int n, int i0, int j0) {
  part += (size_t)blockIdx.z * m * n;
  const int ty = tile_ty(), tx = tile_tx();
#pragma unroll
  for (int r = 0; r < GRT; ++r) {
    const int i = i0 + tile_row(ty, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + tile_col(tx, h);
      if (i < m && j < n) {
        *reinterpret_cast<float4*>(part + (size_t)i * n + j) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
      }
    }
  }
}

}  // namespace vp3d
