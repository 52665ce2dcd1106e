// The warpgroup-MMA (wgmma) main loop of the train block's float32 GEMMs: the
// 128 x 128 output tile of sgemm_tile.cuh, 3xTF32 at Hopper's full TF32 rate.
//
// mma.sync m16n8k8 issues one TF32 MMA per ~9 cycles of an SM quarter on an H100,
// which caps 3xTF32 near 75-80 TFLOP/s of float32 work; wgmma.mma_async, four
// warps issuing one 64-row product that reads B from shared memory, is the only
// path to the 495 TFLOP/s of TF32 (165 of float32 work in 3xTF32).  wgmma takes
// TF32 operands from shared memory only K-major (the summed index contiguous), and
// A may come from registers instead.  So:
// - A (the tile's 128 rows) lands in shared memory as it is and each consumer
//   thread loads its fragments (ld.shared) and splits them in registers into big
//   = tf32(x) and small = tf32(x - big), as sgemm_tile.cuh's tf32_split does.  A
//   tap GEMM's A is row-major in the summed dimension: 128 rows of WK values, in
//   the 128-byte swizzle (16-byte word c of row r at word c ^ (r % 8)), so a warp's
//   fragment reads hit 32 banks.  dw_gemm's A is a^T, a row-major over the summed
//   rows: four 32-column boxes of WK rows, each in the same swizzle.
// - B (the tile's 128 output columns) comes K-major and already split: big and
//   small (n_cols x ldb) float32 arrays that a split pass (train_block.cu
//   tf32_split_kernel) writes from the weights, or from dw_gemm's second operand
//   transposed.  Each lands in shared memory in the 128-byte swizzle that the wgmma
//   descriptor names (8-row groups 1,024 bytes apart).
// Every tile arrives by TMA (cp.async.bulk.tensor) through a tensor map of its
// operand (wg_tensor_map), which zero-fills what lies past the operand's rows or
// summed values.
// Each product is a_small b_big + a_big b_small + a_big b_big (the small-by-small
// term, ~2^-22 of the product, dropped), three m64n128k8 wgmmas a k8 step.  The
// MMA's own float32 accumulation does not round to nearest (carried over a whole
// summed dimension it read 26x a float32 matmul's error on an H100), so the wgmmas of
// each W_CHUNK summed values start from zero and their sum is added to the
// thread's float32 total by a rounded add.  At 32 (one slab) every product stayed
// within 0.85x a float32 matmul's error on an H100, and ran fastest of 8, 16, 32.
//
// A persistent CUDA block of WG_THREADS, one an SM, works through a grid of tiles:
// two consumer warpgroups (threads 0-255, 64 tile rows each) and a producer
// warpgroup (256-383), of which one thread issues, for each WK-deep slab of each
// tile, the TMA copies of A, B big and B small into a W_STAGES-deep ring, their
// bytes expected on the stage's `full` mbarrier (a producer warp issuing 16-byte
// cp.async copies held the loop near 55 TFLOP/s on an H100: its address arithmetic
// set the pace); each consumer waits on `full`, runs the slab's products and
// arrives on the stage's `empty` mbarrier, which the producer waits on before it
// refills the stage.  The producer runs on into the next tile while the consumers
// finish one, and the warpgroups run apart, so one's rounded adds overlap the
// other's MMAs.  The producer's warpgroup gives up registers (setmaxnreg) to the
// consumers, whose sums and chunk products take 128 of them.  The epilogues read
// the sums in wgmma's accumulator layout.  No float atomics: a tile's sums run in
// one fixed order.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sgemm_tile.cuh"

namespace vp3d {

constexpr int WG_CONSUMERS = 2 * 128;            // two warpgroups of consumers
constexpr int WG_THREADS = WG_CONSUMERS + 128;   // and the producer's warpgroup
constexpr int WG_PRODUCER_REGS = 40;             // registers a thread (setmaxnreg)
constexpr int WG_CONSUMER_REGS = 232;
constexpr int WK = 32;                           // summed values a slab: 128 bytes a row
constexpr int W_STAGES = 4;                      // slabs in the ring
constexpr int W_CHUNK = 32;                      // summed values a zero-started MMA sum
constexpr int W_TILE_BYTES = GT * WK * 4;        // one operand's slab: 128 x 128 bytes
// A stage: B big, B small, A, each 1,024-byte aligned (the swizzle's period).
constexpr int W_STAGE_BYTES = 3 * W_TILE_BYTES;
constexpr int W_RED_BYTES = 2 * (WG_CONSUMERS / 32) * GT * 4;  // a tile's column sums
constexpr int W_BAR_BYTES = 2 * W_STAGES * 8;
// The ring, the epilogue's sums, the barriers, and 1,024 bytes to align the dynamic
// shared memory.
constexpr int W_SMEM_BYTES = W_STAGES * W_STAGE_BYTES + W_RED_BYTES + W_BAR_BYTES + 1024;
static_assert(W_SMEM_BYTES <= kMaxSmem, "one CUDA block an SM");
static_assert(WG_PRODUCER_REGS * 128 + WG_CONSUMER_REGS * WG_CONSUMERS <= 65536,
              "the producer's registers pay for the consumers'");
static_assert(WK % W_CHUNK == 0 && W_CHUNK % 8 == 0, "whole k8 steps a chunk");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte word c (0..7) of row r in a [rows][128 bytes] tile in the
// 128-byte swizzle.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// The TMA copy of the box at (column c0, row r0) of `map` into shared address s,
// its bytes counted on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t s, const CUtensorMap* map, uint32_t bar,
                                         int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(s),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(r0)
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The wgmma descriptor of a K-major [rows][128 bytes] tile in the 128-byte swizzle
// at shared address s (1,024-byte aligned): 8-row groups 1,024 bytes apart (SBO),
// the leading offset unused by a swizzled K-major operand (1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t s) {
  return (uint64_t)((s & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (+)= a @ b: one m64n128k8 TF32 product of the warpgroup, a in registers (the
// m16k8 fragment of the warp's 16 rows), b by descriptor; scale_d 0 starts from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving register reads or writes of v across the
// asynchronous MMAs that use it.
__device__ __forceinline__ void fence_reg(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

// The 256 consumer threads' barrier (named barrier 1; the producer warp is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
}

// The TMA maps of one wgmma tile's operands: out (m x n) = A (m x k) @ B over the
// summed values [k_begin, k_end).  a: with A_ROWS, A row-major, (m rows, k columns),
// boxes of 128 rows x WK; else A^T row-major, (k rows, m columns), boxes of WK rows x
// 32.  b_big, b_small: B's split parts K-major, (n rows, k columns), boxes of 128
// rows x WK.  All float32 in the 128-byte swizzle (wg_tensor_map).
struct WgMaps {
  CUtensorMap a, b_big, b_small;
};

// The map of a row-major float32 matrix (rows x cols, row stride ld floats, ld % 4 ==
// 0, base 16-byte aligned) in boxes of box_rows rows x 32 columns (128 bytes) in the
// 128-byte swizzle, zeros past its edges.  cuTensorMapEncodeTiled comes from the
// driver through the runtime, so the library links no driver library.
inline cudaError_t wg_tensor_map(CUtensorMap* map, const float* base, uint64_t rows,
                                 uint64_t cols, uint64_t ld, uint32_t box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      fn = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 4};
  const cuuint32_t box[2] = {32, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The producer's TMA copies of the slab at summed values k0.. into stage st, all
// counted on `full`: B big and small (columns j0..), A (rows i0..).
template <bool A_ROWS>
__device__ __forceinline__ void wg_load_slab(uint32_t st, const WgMaps& maps, uint32_t full,
                                             int i0, int j0, int k0) {
  mbar_expect(full, W_STAGE_BYTES);
  tma_load(st, &maps.b_big, full, k0, j0);
  tma_load(st + W_TILE_BYTES, &maps.b_small, full, k0, j0);
  if constexpr (A_ROWS) {
    tma_load(st + 2 * W_TILE_BYTES, &maps.a, full, k0, i0);
  } else {
#pragma unroll
    for (int b = 0; b < GT / 32; ++b) {
      tma_load(st + 2 * W_TILE_BYTES + b * WK * 128, &maps.a, full, i0 + 32 * b, k0);
    }
  }
}

// The consumer's A fragment value at tile row r, summed index k of a landed slab.
template <bool A_ROWS>
__device__ __forceinline__ float wg_a_at(const unsigned char* a_s, int r, int k) {
  if constexpr (A_ROWS) {
    return *reinterpret_cast<const float*>(a_s + sw128(r, k / 4) + 4 * (k % 4));
  } else {  // box r / 32, its row k, column r % 32
    return *reinterpret_cast<const float*>(a_s + (r / 32) * WK * 128 + sw128(k, r % 32 / 4) +
                                           4 * (r % 4));
  }
}

// The tile row and column of a consumer's accumulator value d[4 j + 2 h + e] in
// wgmma's layout: row r0 + 8 h of the warpgroup's 64 (warp % 4 picks 16 of them),
// column 8 j + 2 tq + e.
__device__ __forceinline__ int wg_row(int h) {
  return threadIdx.x / 32 * 16 + threadIdx.x % 32 / 4 + 8 * h;
}
__device__ __forceinline__ int wg_col(int j) { return 8 * j + 2 * (threadIdx.x % 4); }

// A persistent CUDA block of WG_THREADS works through the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of a grid of tiles_x (columns, fastest) x tiles_y
// (rows) x slices GT x GT tiles; tile (x, y, z) sums [z k_slice, min(k, (z + 1)
// k_slice)).  The producer runs on into the next tile's slabs while the consumers
// finish a tile: for each, done(d, x, y, z, red) runs in the 256 consumers with d
// the tile's float32 sums in wgmma's layout (wg_row, wg_col) and red W_RED_BYTES of
// shared memory for its sums (consumer_sync their barrier).  seen(a_s, k0, x, y)
// runs in every consumer on each slab's A (summed values k0..) once it has landed,
// before the products.
template <bool A_ROWS, typename Seen, typename Done>
__device__ __forceinline__ void wg_tiles(unsigned char* smem, const WgMaps& maps, int tiles_x,
                                         int tiles_y, int slices, int k, int k_slice,
                                         Seen&& seen, Done&& done) {
  const int tiles = tiles_x * tiles_y * slices;
  const uint32_t ring = smem_addr(smem);
  float* red = reinterpret_cast<float*>(smem + W_STAGES * W_STAGE_BYTES);
  const uint32_t bars = ring + W_STAGES * W_STAGE_BYTES + W_RED_BYTES;  // full, empty
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                          // the producer's expect_tx
      mbar_init(bars + 8 * (W_STAGES + s), WG_CONSUMERS);  // every consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= WG_CONSUMERS) {  // the producer's warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (threadIdx.x == WG_CONSUMERS) {
      int g = 0;  // slabs issued by this block
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int x = tile % tiles_x, y = tile / tiles_x % tiles_y, z = tile / tiles_x / tiles_y;
        const int k_begin = z * k_slice, k_end = min(k, k_begin + k_slice);
        for (int k0 = k_begin; k0 < k_end; k0 += WK, ++g) {
          const int s = g % W_STAGES;
          if (g >= W_STAGES) mbar_wait(bars + 8 * (W_STAGES + s), (g / W_STAGES - 1) & 1);
          wg_load_slab<A_ROWS>(ring + s * W_STAGE_BYTES, maps, bars + 8 * s, y * GT, x * GT,
                               k0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  const int tq = threadIdx.x % 4;
  constexpr int STEPS = W_CHUNK / 8;
  int g = 0;  // slabs consumed by this block
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x = tile % tiles_x, y = tile / tiles_x % tiles_y, z = tile / tiles_x / tiles_y;
    const int k_begin = z * k_slice, k_end = min(k, k_begin + k_slice);
    float total[64], d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = d[i] = 0.f;
    for (int k0 = k_begin; k0 < k_end; k0 += WK, ++g) {
      const int s = g % W_STAGES;
      mbar_wait(bars + 8 * s, (g / W_STAGES) & 1);
      const uint64_t big = sw128_desc(ring + s * W_STAGE_BYTES);
      const uint64_t small = sw128_desc(ring + s * W_STAGE_BYTES + W_TILE_BYTES);
      const unsigned char* a_s = smem + s * W_STAGE_BYTES + 2 * W_TILE_BYTES;
      seen(a_s, k0, x, y);
#pragma unroll
      for (int ch = 0; ch < WK / W_CHUNK; ++ch) {
        uint32_t ah[STEPS][4], al[STEPS][4];
#pragma unroll
        for (int j = 0; j < STEPS; ++j) {
          const int kk = (ch * STEPS + j) * 8 + tq;
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // a[q]: row 8 (q % 2), summed index 4 (q / 2)
            const float v = wg_a_at<A_ROWS>(a_s, wg_row(q % 2), kk + 4 * (q / 2));
            ah[j][q] = tf32_rna(v);
            al[j][q] = tf32_rna(__fsub_rn(v, __uint_as_float(ah[j][q])));
          }
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_reg(d[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < STEPS; ++j) {
          // k8 step: 32 bytes into each 128-byte row of the swizzled B parts
          const uint64_t kk = (uint64_t)(ch * STEPS + j) * 2;
          wgmma_tf32(d, al[j], big + kk, j == 0 ? 0 : 1);
          wgmma_tf32(d, ah[j], small + kk, 1);
          wgmma_tf32(d, ah[j], big + kk, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_reg(d[i]);
#pragma unroll
        for (int j = 0; j < STEPS; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            fence_reg(ah[j][q]);
            fence_reg(al[j][q]);
          }
        }
        if (ch == WK / W_CHUNK - 1) mbar_arrive(bars + 8 * (W_STAGES + s));
#pragma unroll
        for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], d[i]);
      }
    }
    done(total, x, y, z, red);
  }
}

// The tile's float32 sums d (wgmma's layout) at rows i0.., columns j0.. of out, (m, n)
// row-major; what lies past m or n is dropped (n % 4 == 0: a column pair is wholly
// in or out).
__device__ __forceinline__ void wg_store(const float (&d)[64], float* out, int m, int n, int i0,
                                         int j0) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wg_row(h), c = j0 + wg_col(j);
      if (i < m && c < n) {
        *reinterpret_cast<float2*>(out + (size_t)i * n + c) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
}

}  // namespace vp3d
