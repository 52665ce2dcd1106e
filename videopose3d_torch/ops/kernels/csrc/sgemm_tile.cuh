// The 128 x 128-tile GEMM pieces the train-block GEMMs (dw_gemm, and the tap GEMMs
// of conv_stats, norm_drop_matmul_stats, dz_matmul_dd and du_dtaps_res) and the
// float32 evaluation blocks (temporal_block.cu) share.
//
// A CUDA block of GT_THREADS = 256 threads (8 warps) owns a GT x GT (128 x 128)
// output tile; warp w computes its 64 x 32 part (rows 64 (w / 4).., columns
// 32 (w % 4)..) as 4 x 4 tiles of mma.sync m16n8k8 on the tensor cores, so each
// thread holds 8 rows x 8 columns of the tile in the m16n8 accumulator layout
// (tile_row, tile_col).  The operands sit in shared memory in slabs of GK = 32 of
// the summed dimension, padded so that the fragment reads (lane (g, t) reads summed
// index t of tile row or column g) fall in 32 distinct banks: B and dw_gemm's A
// summed-index-major ([GK][GLD], GLD = GT + 8), a tap GEMM's A (row-major in the
// summed dimension in memory) tile-row-major ([GT][a_ld<T>], 16 bytes of padding a
// row).  Every slab arrives by 16-byte (bf16: 8-byte) cp.async through a
// B_STAGES-deep ring, so no thread holds operands in registers between slabs.
//
// float32 operands run in 3xTF32: each fragment value x is split as it is read
// into big = tf32(x) and small = tf32(x - big) (round to nearest, ties away from
// zero: cvt.rna.tf32.f32's rounding), and every product is a_small b_big +
// a_big b_small + a_big b_big, three MMAs, the small terms first (the a_small
// b_small term, ~2^-22 of the product, is dropped).  The three MMAs of one k8 step
// start from zero and their sum is added to the thread's float32 accumulator by a
// rounded add: the MMA's own float32 accumulation does not round to nearest, and
// carried over the whole summed dimension it read 26x the error of a float32
// torch.matmul (dWa at 27,648 rows, on an H100).  That keeps float32's accuracy on
// the tensor cores (495 TFLOP/s TF32 dense on an H100, against 67 for float32
// FMAs); one-pass TF32 does not.  A bf16 value is exact in TF32, so bf16 operands
// take the one MMA of their exact product.
//
// tile_gemm_loop is a tap GEMM's main loop, with the caller's map from tile rows to
// A's rows; tile_store_part stores a split's float32 sums of a tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace vp3d {

constexpr int GT = 128;         // output tile (GT x GT)
constexpr int GK = 32;          // summed-dimension rows per shared-memory slab
constexpr int GLD = GT + 8;     // a slab row's stride: rows t and t + 1 8 banks apart
constexpr int GRT = 8;          // rows and columns of the tile a thread holds
constexpr int GT_THREADS = 256;
constexpr int B_STAGES = 3;  // slabs of each operand in the cp.async rings
constexpr int TAP_SLAB = GK * GLD;

// A tile-row-major A slab: GT rows of GK summed values, each row padded by 16 bytes
// (rows g and g + 1 4 banks apart, summed index t one bank).
template <typename T>
__host__ __device__ constexpr int a_ld() { return GK + 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int a_slab() { return GT * a_ld<T>(); }

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
// ([GK][GLD]); rows and columns outside are zero-filled.  Each warp copies whole
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
    cp_async4(s + rr * GLD + cc, g + (ok ? (size_t)r * ld + c0 + cc : 0), ok);
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

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds, with the 13 bits below zero, so that x - it is exact.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The operand value at p as the TF32 pair (big, small) of the 3xTF32 products; a
// bf16 value is exact in TF32 (small unused).
template <typename T>
__device__ __forceinline__ void tf32_split(const T* p, uint32_t& big, uint32_t& small) {
  if constexpr (sizeof(T) == 4) {
    const float x = *p;
    big = tf32_rna(x);
    small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
  } else {
    big = static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16;
  }
}

// d = c + a @ b on the tensor cores: an m16n8k8 TF32 product, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// acc += the products of one slab pair: as (ROW_MAJOR_A: [GT][a_ld<T>()], element
// (i, k) of the tile's row i; else [GK][GLD], element (k, i)) and bs ([GK][GLD],
// element (k, j) of column j).  acc[p][q] is tile row tile_row(p), column
// tile_col(q); m16n8 tile (mt, nt) of the warp accumulates into acc[2 mt + {0, 1}]
// [2 nt + {0, 1}].
template <bool ROW_MAJOR_A, typename T>
__device__ __forceinline__ void tile_mma_slab(float (&acc)[GRT][GRT], const T* as,
                                              const T* bs) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // strides of A's tile row and summed index
  constexpr int AI = ROW_MAJOR_A ? a_ld<T>() : 1, AK = ROW_MAJOR_A ? 1 : GLD;
  const T* a = as + (lane % 4) * AK + ((warp / 4) * 64 + lane / 4) * AI;
  const T* b = bs + (lane % 4) * GLD + (warp % 4) * 32 + lane / 4;
#pragma unroll
  for (int k = 0; k < GK; k += 8) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tf32_split(b + (k + 4 * j) * GLD + nt * 8, bh[nt][j], bl[nt][j]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      // a[q]: row 8 (q % 2), summed row 4 (q / 2) of the m16k8 fragment
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tf32_split(a + (k + 4 * (q / 2)) * AK + (mt * 16 + 8 * (q % 2)) * AI, ah[q], al[q]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        float d[4];
        if constexpr (sizeof(T) == 4) {
          mma_tf32(d, al, bh[nt], zero);
          mma_tf32(d, ah, bl[nt], d);
          mma_tf32(d, ah, bh[nt], d);
        } else {
          mma_tf32(d, ah, bh[nt], zero);
        }
        // d is row lane / 4 (+ 8 for d[2], d[3]), columns 2 (lane % 4) + {0, 1}
        acc[2 * mt][2 * nt] = __fadd_rn(acc[2 * mt][2 * nt], d[0]);
        acc[2 * mt][2 * nt + 1] = __fadd_rn(acc[2 * mt][2 * nt + 1], d[1]);
        acc[2 * mt + 1][2 * nt] = __fadd_rn(acc[2 * mt + 1][2 * nt], d[2]);
        acc[2 * mt + 1][2 * nt + 1] = __fadd_rn(acc[2 * mt + 1][2 * nt + 1], d[3]);
      }
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

// The tile row of this thread's accumulator row p (0..7): row lane / 4 (+ 8) of
// m16 tile p / 2 of its warp.  Ascending in p.
__device__ __forceinline__ int tile_row(int p) {
  return (threadIdx.x / 128) * 64 + (p / 2) * 16 + (p % 2) * 8 + threadIdx.x % 32 / 4;
}
// The tile column of accumulator column q (0..7): columns tile_col(2 h) and
// tile_col(2 h) + 1 are adjacent.
__device__ __forceinline__ int tile_col(int q) {
  return (threadIdx.x / 32) % 4 * 32 + (q / 2) * 8 + 2 * (threadIdx.x % 4) + q % 2;
}
// Which of the 16 threads that hold a tile column this one is, in row order.
__device__ __forceinline__ int tile_row_group() {
  return (threadIdx.x / 128) * 8 + threadIdx.x % 32 / 4;
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

// 2 values of T from float32 (already rounded to T) at dst: one 8- or 4-byte store.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float v0, float v1) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<uint32_t*>(dst) =
        __float_as_uint(v0) >> 16 | (__float_as_uint(v1) & 0xffff0000u);
  }
}

// Starts this thread's copies of a tile-row-major A slab: the 4-value words of summed
// index k0 + 4 (threadIdx.x % 8) .. + 3 of tile rows threadIdx.x / 8 + 32 q, each
// from a_src(row, kk), the word's address, or null (zero-filled; `any` is a valid
// global address that such a copy names and does not read).
template <typename T, typename ASrc>
__device__ __forceinline__ void a_slab_cp_async(T* as, int k0, const T* any, ASrc&& a_src) {
  const int kk = k0 + 4 * (threadIdx.x % 8);
#pragma unroll
  for (int q = 0; q < GK * GT / 4 / GT_THREADS; ++q) {
    const int r = threadIdx.x / 8 + 32 * q;
    const T* src = a_src(r, kk);
    cp_async4(as + r * a_ld<T>() + kk - k0, src == nullptr ? any : src, src != nullptr);
  }
}

// The main loop of the GT x GT tile at columns j0.. over the summed rows [k_begin,
// k_end): acc = A @ B, slab by slab in k order.  B (row-major, n columns, n also its
// leading dimension) and A (a_slab_cp_async's a_src, `any` its fallback address)
// flow through B_STAGES-deep cp.async rings b_s and a_s; a_seen(slab, k0) runs on
// each landed A slab before its products.
template <typename T, typename ASrc, typename ASeen>
__device__ __forceinline__ void tile_gemm_loop(float (&acc)[GRT][GRT], T* a_s, T* b_s,
                                               const T* __restrict__ b, int n, int j0,
                                               int k_begin, int k_end, const T* any,
                                               ASrc&& a_src, ASeen&& a_seen) {
  const int slabs = (k_end - k_begin + GK - 1) / GK;
  tile_zero(acc);
  for (int s = 0; s < B_STAGES - 1; ++s) {
    if (s < slabs) {
      a_slab_cp_async(a_s + s * a_slab<T>(), k_begin + s * GK, any, a_src);
      slab_cp_async(b_s + s * TAP_SLAB, b, n, k_begin + s * GK, k_end, j0, n);
    }
    cp_async_commit();
  }
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<B_STAGES - 2>();  // this thread's copies of slab t have landed
    __syncthreads();                // everyone's have, and slab t - 1 is consumed
    const int next = t + B_STAGES - 1;
    if (next < slabs) {
      a_slab_cp_async(a_s + (next % B_STAGES) * a_slab<T>(), k_begin + next * GK, any,
                      a_src);
      slab_cp_async(b_s + (next % B_STAGES) * TAP_SLAB, b, n, k_begin + next * GK, k_end, j0,
                    n);
    }
    cp_async_commit();
    const T* as = a_s + (t % B_STAGES) * a_slab<T>();
    a_seen(as, k_begin + t * GK);
    tile_mma_slab<true>(acc, as, b_s + (t % B_STAGES) * TAP_SLAB);
  }
}

// A split's products: the tile's float32 sums (rows i0.., columns j0..) as slice
// blockIdx.z of part, (slices, m, n) row-major; what lies past m or n is dropped
// (n % 4 == 0: a column pair is wholly in or out).
__device__ __forceinline__ void tile_store_part(const float (&acc)[GRT][GRT], float* part,
                                                int m, int n, int i0, int j0) {
  part += (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int p = 0; p < GRT; ++p) {
    const int i = i0 + tile_row(p);
#pragma unroll
    for (int h = 0; h < GRT / 2; ++h) {
      const int j = j0 + tile_col(2 * h);
      if (i < m && j < n) {
        *reinterpret_cast<float2*>(part + (size_t)i * n + j) =
            make_float2(acc[p][2 * h], acc[p][2 * h + 1]);
      }
    }
  }
}

}  // namespace vp3d
