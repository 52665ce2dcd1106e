// What the two streaming steps on the tensor cores (stream_bf16.cu, stream_int8.cu)
// share: the cluster's column slices, the check of a plan (which streaming_fused.py
// chooses and passes in), the cluster launch, the cp.async / ldmatrix / barrier
// instructions, the sum of the two warp groups' halves and the walk over a warp's
// mma accumulators.  Besides, written over the operand kind for the int8 step: the
// two products it runs on mma.sync (its int8 x int8 products summed exactly in int32,
// its bf16 x bf16 shrink summed in float32), and the per-thread K-tile loader and its
// cp.async ring.  The bf16 step keeps its
// own loader and ring over bf16 (compiled through the generic ones it ran 1.5-5 %
// slower in the same call, and spilled once: kernel_ab.py on an H100; PERF.md).
//
// The kernel is kTcThreads = two warp groups of NT threads.  Every product's
// output columns are split over a cluster of n <= kTcMaxSlices CUDA blocks, each
// owning slice_cols(c, n) columns (a multiple of 8), in passes of kTcNP columns.  A
// K tile is 64 bytes of each A row (32 bf16 or 64 int8) and the B rows those K
// values meet, 8,704 bytes for both kinds, so the two share one stage layout:
//   A: M rows x 80 bytes (64 + 16 bytes of padding, so the 8 rows an ldmatrix
//      reads hit distinct banks);
//   B: bf16, 32 rows x 136 bf16 of the row-major (K, N) weights;
//      int8, 16 rows x 136 int32 of the packed weights (pack_int8_step in
//      streaming_fused.py: int32 (g, n) holds K values 4g..4g+3 of column n, the
//      order of an m16n8k32 B fragment register), rows padded to 8 words mod 32
//      banks, so a fragment's 4 rows x 8 columns hit 32 distinct banks.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace vp3d {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kTcNP = 128;       // output columns per pass
constexpr int kTcStages = 4;     // cp.async ring depth
constexpr int kTcMaxSlices = 8;  // cluster size (portable)
constexpr int kTcMaxRows = 80;   // rows per CUDA block (more spill at 128 registers)
constexpr int kTcSlotInts = 16;  // the taps' ring slots in shared memory; the last is 0
constexpr int kTcLdaBytes = 80;  // padded A stage row
constexpr int kTcBBytes = 8704;  // B stage
// Warp groups of NT threads per CUDA block: each sums a contiguous half of every
// product's K tiles through its own cp.async ring, and the halves are added in a
// fixed order, so an SM keeps 16 warps in flight.
constexpr int kTcGroups = 2;
constexpr int kTcThreads = kTcGroups * NT;

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

// Columns a block of an n-block cluster owns (the last may own fewer).
__host__ __device__ inline int slice_cols(int c, int n) { return round8((c + n - 1) / n); }

__host__ __device__ constexpr int stage_bytes(int m) { return m * kTcLdaBytes + kTcBBytes; }

// Both warp groups' cp.async rings.
__host__ __device__ constexpr size_t rings_bytes(int m) {
  return (size_t)kTcGroups * kTcStages * stage_bytes(m);
}

// The most column slices (a power of two up to kTcMaxSlices) that leave every block
// of the cluster at least one column.
inline int max_slices(int c) {
  int best = 1;
  for (int n = 2; n <= kTcMaxSlices; n *= 2) {
    if ((n - 1) * slice_cols(c, n) < c) best = n;
  }
  return best;
}

// Whether plan (m, n) fits k frames and c channels in `smem` bytes per CUDA block.
inline bool plan_fits(int m, int n, int k, int c, size_t smem) {
  return m % 16 == 0 && m >= 16 && m <= kTcMaxRows && m >= k && n >= 1 &&
         n <= max_slices(c) && (n & (n - 1)) == 0 && smem <= kMaxSmem;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// Four 8 x 8 matrices of 16-bit elements (8 rows x 16 bytes) from shared memory.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Barrier of warp group `group` alone (named barrier 1 + group).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(NT) : "memory");
}

// Global writes of the cluster's blocks before it, visible to all of them after it.
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  cg::this_cluster().sync();
}

// The unsigned integer of a type's size, for element-by-element copies.
template <int S> struct Bits;
template <> struct Bits<1> { using T = uint8_t; };
template <> struct Bits<2> { using T = uint16_t; };
template <> struct Bits<4> { using T = uint32_t; };

// 16 bytes of T from global memory into shared memory: one 16-byte cp.async, or,
// for rows that are not 16-byte aligned, element by element (through L2, as
// cp.async.cg).  Element i is zero where !(i < valid_n); `src` is read only where
// valid, `any` is a readable address for an empty copy.
template <typename T>
__device__ __forceinline__ void load16(T* dst, const T* src, bool vec, int valid_n,
                                       const T* any) {
  constexpr int E = 16 / sizeof(T);
  const int n = max(0, min(E, valid_n));
  if (vec) {
    cp_async16(dst, n > 0 ? src : any, n * (int)sizeof(T));
    return;
  }
  using U = typename Bits<sizeof(T)>::T;
  U* d = reinterpret_cast<U*>(dst);
  const U* s = reinterpret_cast<const U*>(src);
#pragma unroll
  for (int i = 0; i < E; ++i) d[i] = i < n ? __ldcg(s + i) : U(0);
}

// Warp layout of an M-row tile: warps_m x warps_n warps, each MT m16 tiles by NT8
// n8 tiles of a 128-column pass (warps_m 2 where that leaves each warp at least
// two m16 tiles, else 1); the stage geometry of the operand kind Op, and each
// thread's share of a stage's copies (A_ITERS and B_ITERS 16-byte chunks).
template <typename Op, int M>
struct Geo {
  using A = typename Op::A;
  using B = typename Op::B;
  static constexpr int WARPS_M = M % 32 == 0 && M >= 64 ? 2 : 1;
  static constexpr int WARPS_N = (NT / 32) / WARPS_M;
  static constexpr int MT = M / (16 * WARPS_M);
  static constexpr int NT8 = kTcNP / (8 * WARPS_N);
  static constexpr int WM = MT * 16;
  static constexpr int WN = NT8 * 8;
  static constexpr int BK = Op::kBK;                 // A elements (K) per tile
  static constexpr int LDA = kTcLdaBytes / sizeof(A);
  static constexpr int B_ROWS = BK / Op::kPack;      // B rows per tile
  static constexpr int LDB = kTcNP + 8;
  static constexpr int A_BYTES = M * kTcLdaBytes;
  static constexpr int STAGE = stage_bytes(M);
  static constexpr int A_EPC = 16 / sizeof(A);       // elements per 16-byte chunk
  static constexpr int B_EPC = 16 / sizeof(B);
  static constexpr int A_CPR = BK / A_EPC;           // chunks per A row
  static constexpr int B_CPR = kTcNP / B_EPC;        // chunks per B row
  static constexpr int A_ITERS = (M * A_CPR + NT - 1) / NT;
  static constexpr int B_ITERS = B_ROWS * B_CPR / NT;
  static_assert(WARPS_M * WARPS_N * 32 == NT && NT8 % 2 == 0, "warp layout");
  static_assert(BK * sizeof(A) + 16 == kTcLdaBytes && B_ROWS * LDB * sizeof(B) == kTcBBytes,
                "stage layout");
  static_assert(B_ITERS >= 1 && NT % A_CPR == 0 && NT % B_CPR == 0, "K tile");
};

// bf16 x bf16 summed in float32, mma.sync m16n8k16; B the row-major (K, N) weights.
struct Bf16Mma {
  using A = bf16;
  using B = bf16;
  using Acc = float;
  static constexpr int kBK = 32;
  static constexpr int kPack = 1;  // K values per B element

  // acc += the stage's A (M x 32) @ B (32 x 128), this warp's tile.
  template <typename G>
  static __device__ __forceinline__ void mma_stage(float (&acc)[G::MT][G::NT8][4],
                                                   const char* stage) {
    const bf16* as = reinterpret_cast<const bf16*>(stage);
    const bf16* bs = reinterpret_cast<const bf16*>(stage + G::A_BYTES);
    const int warp = threadIdx.x % NT >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp / G::WARPS_N;
    const int wn = warp - wm * G::WARPS_N;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        ldsm_x4(a[mt], as + (wm * G::WM + mt * 16 + (lane & 15)) * G::LDA + ks + (lane >> 4) * 8);
      }
      uint32_t b[G::NT8][2];
#pragma unroll
      for (int np = 0; np < G::NT8 / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, bs + (ks + (lane & 15)) * G::LDB + wn * G::WN + np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt) {
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
              "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(acc[mt][nt][0]), "+f"(acc[mt][nt][1]), "+f"(acc[mt][nt][2]),
                "+f"(acc[mt][nt][3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]), "r"(b[nt][0]),
                "r"(b[nt][1]));
        }
      }
    }
  }
};

// int8 x int8 summed exactly in int32, mma.sync m16n8k32; B the packed weights.
struct I8Mma {
  using A = int8_t;
  using B = int32_t;
  using Acc = int;
  static constexpr int kBK = 64;
  static constexpr int kPack = 4;

  // acc += the stage's A (M x 64) @ B (64 x 128), this warp's tile.  The A
  // fragment (rows r and r + 8, bytes 4 (lane % 4) .. + 3 and + 16) is the four
  // 8 x 16-byte matrices of one ldmatrix.x4; the B fragment's two registers are
  // packed rows lane % 4 and lane % 4 + 4 of column lane / 4.
  template <typename G>
  static __device__ __forceinline__ void mma_stage(int (&acc)[G::MT][G::NT8][4],
                                                   const char* stage) {
    const int8_t* as = reinterpret_cast<const int8_t*>(stage);
    const int32_t* bs = reinterpret_cast<const int32_t*>(stage + G::A_BYTES);
    const int warp = threadIdx.x % NT >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp / G::WARPS_N;
    const int wn = warp - wm * G::WARPS_N;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        ldsm_x4(a[mt], as + (wm * G::WM + mt * 16 + (lane & 15)) * G::LDA + ks + (lane >> 4) * 16);
      }
      uint32_t b[G::NT8][2];
      const int32_t* brow = bs + (ks / 4 + (lane & 3)) * G::LDB + wn * G::WN + (lane >> 2);
#pragma unroll
      for (int nt = 0; nt < G::NT8; ++nt) {
        b[nt][0] = static_cast<uint32_t>(brow[nt * 8]);
        b[nt][1] = static_cast<uint32_t>(brow[4 * G::LDB + nt * 8]);
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt) {
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
              "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+r"(acc[mt][nt][0]), "+r"(acc[mt][nt][1]), "+r"(acc[mt][nt][2]),
                "+r"(acc[mt][nt][3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]), "r"(b[nt][0]),
                "r"(b[nt][1]));
        }
      }
    }
  }
};

// The A and B operands of one product, summed over `terms` (the taps):
// A_t row (frame f, stream b) at a + ((slot[t] + f) * batch + b) * lda, B_t the
// (k / kPack, ldb) row-major matrix at b + t * b_step; A columns at or past k and B
// columns at or past n_end read as 0.
template <typename Op>
struct Operand {
  const typename Op::A* a;
  const typename Op::B* b;
  size_t b_step;
  const int* slot;  // in shared memory, one per term
  int terms, k, lda, ldb, n_end;
  bool vec_a, vec_b;
};

// One thread's share of a product's K-tile copies: its A chunks' row addresses for
// the current term (null past the batch) and its B chunk column, stepped K tile by
// K tile and term by term.
template <typename Op, int M>
struct Loader {
  using G = Geo<Op, M>;
  using A = typename Op::A;
  using B = typename Op::B;
  const A* a_row[G::A_ITERS];
  const B* b_col;
  int a_c, b_c, b_valid, term, k0;

  __device__ __forceinline__ void set_term(const Operand<Op>& op, const int* row_off,
                                           int batch, int n0) {
#pragma unroll
    for (int i = 0; i < G::A_ITERS; ++i) {
      const int r = threadIdx.x % NT / G::A_CPR + i * (NT / G::A_CPR);
      const int ro = r < M ? row_off[r] : -1;
      a_row[i] = ro >= 0 ? op.a + ((size_t)op.slot[term] * batch + ro) * op.lda + a_c : nullptr;
    }
    b_col = op.b + (size_t)term * op.b_step + n0 + b_c;
  }

  // Starts at K tile q0 of the product (tap q0 / kt_n).
  __device__ __forceinline__ void start(const Operand<Op>& op, const int* row_off, int batch,
                                        int n0, int q0) {
    const int kt_n = (op.k + G::BK - 1) / G::BK;
    a_c = (threadIdx.x % G::A_CPR) * G::A_EPC;
    b_c = (threadIdx.x % G::B_CPR) * G::B_EPC;
    b_valid = op.n_end - (n0 + b_c);
    term = q0 / kt_n;
    k0 = (q0 - term * kt_n) * G::BK;
    if (term < op.terms) set_term(op, row_off, batch, n0);
  }

  // Starts the copy of the next K tile into `stage` and steps to the one after.
  __device__ __forceinline__ void load(char* stage, const Operand<Op>& op, const int* row_off,
                                       int batch, int n0) {
    A* as = reinterpret_cast<A*>(stage);
    B* bs = reinterpret_cast<B*>(stage + G::A_BYTES);
    const int va = op.k - (k0 + a_c);
#pragma unroll
    for (int i = 0; i < G::A_ITERS; ++i) {
      const int r = threadIdx.x % NT / G::A_CPR + i * (NT / G::A_CPR);
      if (M * G::A_CPR % NT == 0 || r < M) {
        load16(as + r * G::LDA + a_c, a_row[i] ? a_row[i] + k0 : op.a, op.vec_a,
               a_row[i] ? va : 0, op.a);
      }
    }
#pragma unroll
    for (int i = 0; i < G::B_ITERS; ++i) {
      const int rr = threadIdx.x % NT / G::B_CPR + i * (NT / G::B_CPR);
      const int kk = k0 / Op::kPack + rr;
      load16(bs + rr * G::LDB + b_c, b_col + (size_t)kk * op.ldb, op.vec_b,
             kk * Op::kPack < op.k ? b_valid : 0, op.b);
    }
    k0 += G::BK;
    if (k0 >= op.k) {
      k0 = 0;
      if (++term < op.terms) set_term(op, row_off, batch, n0);
    }
  }
};

// acc = the sum over the product's K tiles [q0, q1) (tap-major) of A @ B for output
// columns [n0, n0 + kTcNP), through warp group `group`'s kTcStages-deep cp.async
// ring at `stages`.
template <typename Op, int M>
__device__ __forceinline__ void gemm_pass(
    typename Op::Acc (&acc)[Geo<Op, M>::MT][Geo<Op, M>::NT8][4], const Operand<Op>& op,
    int n0, char* stages, const int* row_off, int batch, int q0, int q1, int group) {
  using G = Geo<Op, M>;
  constexpr int ST = kTcStages;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    }
  }
  const int q_n = q1 - q0;
  Loader<Op, M> ld;
  ld.start(op, row_off, batch, n0, q0);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < q_n) ld.load(stages + s * G::STAGE, op, row_off, batch, n0);
    cp_async_commit();
  }
  int load_at = ST - 1, use_at = 0;
  for (int q = 0; q < q_n; ++q) {
    cp_async_wait<ST - 2>();
    group_sync(group);  // stage q landed; every warp is done with stage q - 1
    if (q + ST - 1 < q_n) ld.load(stages + load_at * G::STAGE, op, row_off, batch, n0);
    cp_async_commit();
    load_at = load_at + 1 == ST ? 0 : load_at + 1;
    Op::template mma_stage<G>(acc, stages + use_at * G::STAGE);
    use_at = use_at + 1 == ST ? 0 : use_at + 1;
  }
  cp_async_wait<0>();
  group_sync(group);  // the ring is free
}

// Adds warp group 1's sums into group 0's accumulators through `red` (one value per
// accumulator and thread; group 1's ring, free after its pass): group 0's K tiles
// first, then group 1's, the same order in every launch.
template <typename G, typename T>
__device__ __forceinline__ void combine(T (&acc)[G::MT][G::NT8][4], T* red, int group) {
  const int gt = threadIdx.x % NT;
  if (group == 1) {
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) red[((mt * G::NT8 + nt) * 4 + i) * NT + gt] = acc[mt][nt][i];
      }
    }
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += red[((mt * G::NT8 + nt) * 4 + i) * NT + gt];
      }
    }
  }
  __syncthreads();  // red is group 1's ring again
}

// acc = the pass's whole sums in warp group 0 (group 1's are added to them): each
// group sums half of the product's K tiles through its own ring; `stages` holds
// both groups' rings.
template <typename Op, int M>
__device__ __forceinline__ void product_pass(
    typename Op::Acc (&acc)[Geo<Op, M>::MT][Geo<Op, M>::NT8][4], const Operand<Op>& op,
    int n0, char* stages, const int* row_off, int batch, int group) {
  using G = Geo<Op, M>;
  const int q_n = op.terms * ((op.k + G::BK - 1) / G::BK);
  const int half = (q_n + 1) / 2;
  gemm_pass<Op, M>(acc, op, n0, stages + group * kTcStages * G::STAGE, row_off, batch,
                   group ? half : 0, group ? q_n : half, group);
  combine<G>(acc, reinterpret_cast<typename Op::Acc*>(stages + kTcStages * G::STAGE), group);
}

// Calls fn(row, col, value) for each of this thread's accumulators (the m16n8 mma
// layout) whose pass column col (relative to the pass start) lies below `cols`.
template <typename G, typename T, typename Fn>
__device__ __forceinline__ void for_each_acc(const T (&acc)[G::MT][G::NT8][4], int cols,
                                             Fn fn) {
  const int warp = threadIdx.x % NT >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / G::WARPS_N;
  const int wn = warp - wm * G::WARPS_N;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * G::WM + mt * 16 + (lane >> 2) + (i >> 1) * 8;
        const int col = wn * G::WN + nt * 8 + 2 * (lane & 3) + (i & 1);
        if (col < cols) fn(r, col, acc[mt][nt][i]);
      }
    }
  }
}

// Row r of an M-row tile of k frames: frame f = r / (M / k) of stream
// tile * (M / k) + r % (M / k), at row_off[r] = f * batch + b; -1 past the batch or
// the k * (M / k) rows in use.  Slot kTcSlotInts - 1 is 0 (the one-term products).
__device__ __forceinline__ void tile_rows(int* row_off, int* slot_s, int m, int k, int batch,
                                          int tile) {
  const int sb = m / k;
  for (int r = threadIdx.x; r < m; r += kTcThreads) {
    const int f = r / sb;
    const int b = tile * sb + r - f * sb;
    row_off[r] = f < k && b < batch ? f * batch + b : -1;
  }
  if (threadIdx.x == 0) slot_s[kTcSlotInts - 1] = 0;
}

// A launch of `blocks` CUDA blocks of kTcThreads in clusters of `slices`.
inline void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, unsigned blocks,
                          int slices, size_t smem, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kTcThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Launches kernel `kern` at the plan of `p` (p.rows per CUDA block, p.slices per
// cluster) with `smem` bytes per CUDA block: one cluster of p.slices blocks per tile
// of p.rows / p.k streams.
template <typename Kern, typename Args>
cudaError_t launch_plan(Kern kern, size_t smem, const Args& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int sb = p.rows / p.k;
  const unsigned tiles = (p.batch + sb - 1) / sb;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, tiles * p.slices, p.slices, smem, stream);
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The current device's SM count (132 where it cannot be read).
inline int device_sms() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0) {
      return 132;
    }
    cached[dev] = sms;
  }
  return cached[dev];
}

// How many clusters of `slices` CUDA blocks of kernel `kern` at `smem` bytes the
// card runs at once (cudaOccupancyMaxActiveClusters), or -1.
template <typename Kern>
int max_active_clusters(Kern kern, int slices, size_t smem) {
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess) {
    return -1;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, 64 * slices, slices, smem, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) != cudaSuccess) return -1;
  return clusters;
}

}  // namespace vp3d
