// The fused bf16 streaming step on the tensor cores, for Hopper (sm_90a): every
// residual block and the shrink projection for one frame (K5) or k frames (K6) of B
// streams in one launch, pushing each block's input into its ring in place.
//
// Replaces the Pallas TPU kernels of videopose3d_tpu/ops/pallas/streaming_fused.py:
//   fused_blocks_step_bf16 (_fused_blocks_bf16_kernel) at k = 1, and
//   fused_blocks_step_bf16_multi (_fused_blocks_bf16_multi_kernel) at k > 1.
//
// What it computes, per row (frame f, stream b) and residual block:
//   push bf16(act) into the ring at `write` + f (and + cap when doubled);
//   h = bf16(relu(sum_j tap_j @ W1_j * s1 + t1)), tap j the ring row slot_j + f
//       (the newest tap, lag 0, at slot `write`);
//   act += relu(h @ W2 * s2 + t2), the carry act in float32;
// and at the end poses = bf16(act) @ Ws + bs.  Products are bf16 x bf16 summed in
// float32 (mma.sync m16n8k16); each epilogue step is one IEEE operation with one
// rounding (__fmul_rn, __fadd_rn), in the plain version's order.
//
// What bounds it on this card: per row (width + 1) C x C products per block, 34.5
// GFLOP at B = 1,024, k = 1, C = 1,024 and -arc 3,3,3,3,3 (989 TFLOP/s dense bf16:
// 0.035 ms); the bytes are the weights (33.5 MB, held in the 50 MB L2), the taps and
// the pushes.  What sets the pace in practice is how many K tiles each SM can have
// in flight: an SM with 8 warps waits on its loads (a lone CUDA block streams ~50
// GB/s from L2), 16 warps do about twice the work in the same time, and the step's
// weight footprint makes no difference (kernel_ab.py --sweep stream_bf16, PERF.md).
//
// Design.  Rows are tiled M at a time (M a multiple of 16 up to 80; with k frames a
// tile holds M / k streams x k frames, so every frame of a stream stays in one
// tile), and the output columns of every product are split over a thread-block
// cluster of n CUDA blocks (n = 1, 2, 4 or 8): each owns C / n columns (rounded up
// to 8) and its slice of the float32 carry in shared memory, and streams only its
// own columns of the weights.  A block's operand rows come from global memory (L2),
// never from a block's shared memory: the taps from the ring, after each block of
// the cluster has pushed its columns of the block input and the cluster has
// synchronised (so the step's own frames, lag < k, are read back as the plain
// version's push-then-read does); h and the last bf16(act) through a (k * B, C)
// exchange buffer, written by column slice and read whole after the next cluster
// barrier.  Each CUDA block is two warp groups of 8 warps; each group sums half of
// a product's K tiles (tap-major) through its own 4-stage cp.async ring of 32-deep K
// tiles (A: M x 32, B: 32 x 128, rows padded by 16 bytes so ldmatrix is
// conflict-free), each warp an (M / warps_m) x (128 / warps_n) tile of m16n8k16
// products, and group 0 adds group 1's sums to its own and runs the epilogue.  Each
// thread keeps its tile rows' addresses for the current tap and steps them, so a K
// tile costs a few cp.async and one group barrier.  The shrink's output columns are
// split over the cluster as well, each summed whole by one block; every sum runs in
// a fixed order, so two launches from one state give equal bits.  Rows of C % 8 !=
// 0 channels (or J3 % 8 != 0 shrink columns) are not 16-byte aligned and are loaded
// element by element; K and N tails are zero-filled.  One CUDA block per SM (512
// threads of at most 128 registers), so a cluster of 8 fits in 120 of an H100's 132
// SMs: the plan (M, n), chosen by streaming_fused.stream_bf16_plan and passed with
// the launch, keeps a step's clusters to one wave where it can (M = 80 at B = 1,024:
// 13 clusters); plan_valid refuses one this kernel cannot take.

#include "stream_step.cuh"
#include "stream_tc.cuh"

namespace vp3d {
namespace {

constexpr int kBK = 32;  // summed-dimension columns per K tile

// Shared memory of one CUDA block: the float32 carry slice (M x nc), the row offsets
// and tap slots, each warp group's cp.async ring.
size_t smem_bytes(int m, int n, int c) {
  return (size_t)m * slice_cols(c, n) * sizeof(float) +
         (size_t)(m + kTcSlotInts) * sizeof(int) + rings_bytes(m);
}

bool plan_valid(int m, int n, int k, int c) { return plan_fits(m, n, k, c, smem_bytes(m, n, c)); }

// The K-tile machinery below is this kernel's own, not stream_tc.cuh's generic
// Geo / Loader / gemm_pass over the operand kind: compiled through those, this step
// ran 1.5-5 % slower in the same call and spilled once (kernel_ab.py on an H100).
//
// Warp layout of an M-row tile and the K tile's copy: warps_m x warps_n warps, each
// MT m16 tiles by NT8 n8 tiles of a 128-column pass; each thread copies A_ITERS
// 16-byte chunks of the A tile and B_ITERS of the B tile per stage.
// warps_m is 2 where that leaves each warp at least two m16 tiles, else 1.
template <int M, int BK>
struct Bf16Geo {
  static constexpr int WARPS_M = M % 32 == 0 && M >= 64 ? 2 : 1;
  static constexpr int WARPS_N = (NT / 32) / WARPS_M;
  static constexpr int MT = M / (16 * WARPS_M);
  static constexpr int NT8 = kTcNP / (8 * WARPS_N);
  static constexpr int WM = MT * 16;
  static constexpr int WN = NT8 * 8;
  static constexpr int LDA = BK + 8;     // padded rows: the 8 rows of an ldmatrix hit
  static constexpr int LDB = kTcNP + 8;  // distinct banks
  static constexpr int STAGE = M * LDA + BK * LDB;  // bf16 elements per stage
  static constexpr int A_CPR = BK / 8;              // 16-byte chunks per A row
  static constexpr int A_ITERS = (M * A_CPR + NT - 1) / NT;
  static constexpr int B_ITERS = BK * (kTcNP / 8) / NT;
  static_assert(WARPS_M * WARPS_N * 32 == NT && NT8 % 2 == 0, "warp layout");
  static_assert(BK % 16 == 0 && B_ITERS >= 1 && NT % A_CPR == 0, "K tile");
  static_assert(STAGE * sizeof(bf16) == stage_bytes(M), "stage layout");
};

using Op = Operand<Bf16Mma>;

// One thread's share of a product's K-tile copies: its A chunks' row addresses for
// the current term (null past the batch) and its B chunk column, stepped K tile by
// K tile and term by term.
template <int M, int BK>
struct Bf16Loader {
  using G = Bf16Geo<M, BK>;
  const bf16* a_row[G::A_ITERS];
  const bf16* b_col;
  int a_c, b_c, b_valid, term, k0;

  __device__ __forceinline__ void set_term(const Op& op, const int* row_off, int batch, int n0) {
#pragma unroll
    for (int i = 0; i < G::A_ITERS; ++i) {
      const int r = threadIdx.x % NT / G::A_CPR + i * (NT / G::A_CPR);
      const int ro = r < M ? row_off[r] : -1;
      a_row[i] = ro >= 0 ? op.a + ((size_t)op.slot[term] * batch + ro) * op.lda + a_c : nullptr;
    }
    b_col = op.b + (size_t)term * op.b_step + n0 + b_c;
  }

  // Starts at K tile q0 of the product (tap q0 / kt_n).
  __device__ __forceinline__ void start(const Op& op, const int* row_off, int batch, int n0,
                                        int q0) {
    const int kt_n = (op.k + BK - 1) / BK;
    a_c = (threadIdx.x % G::A_CPR) * 8;
    b_c = (threadIdx.x % (kTcNP / 8)) * 8;
    b_valid = op.n_end - (n0 + b_c);
    term = q0 / kt_n;
    k0 = (q0 - term * kt_n) * BK;
    if (term < op.terms) set_term(op, row_off, batch, n0);
  }

  // Starts the copy of the next K tile into `stage` and steps to the one after.
  __device__ __forceinline__ void load(bf16* stage, const Op& op, const int* row_off, int batch,
                                       int n0) {
    bf16* as = stage;
    bf16* bs = stage + M * G::LDA;
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
      const int rr = threadIdx.x % NT / (kTcNP / 8) + i * (NT / (kTcNP / 8));
      const int kk = k0 + rr;
      load16(bs + rr * G::LDB + b_c, b_col + (size_t)kk * op.ldb, op.vec_b,
             kk < op.k ? b_valid : 0, op.b);
    }
    k0 += BK;
    if (k0 >= op.k) {
      k0 = 0;
      if (++term < op.terms) set_term(op, row_off, batch, n0);
    }
  }
};

// d += a @ b on one m16n8k16 tile, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += the stage's A (M x BK) @ B (BK x kTcNP), this warp's tile.
template <int M, int BK>
__device__ __forceinline__ void bf16_mma_stage(
    float (&acc)[Bf16Geo<M, BK>::MT][Bf16Geo<M, BK>::NT8][4], const bf16* stage) {
  using G = Bf16Geo<M, BK>;
  const bf16* as = stage;
  const bf16* bs = stage + M * G::LDA;
  const int warp = threadIdx.x % NT >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / G::WARPS_N;
  const int wn = warp - wm * G::WARPS_N;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
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
      for (int nt = 0; nt < G::NT8; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }
}

// acc = the sum over the product's K tiles [q0, q1) (tap-major) of A @ B for output
// columns [n0, n0 + kTcNP), through warp group `group`'s ST-deep cp.async ring at
// `stages`.
template <int M, int BK, int ST>
__device__ __forceinline__ void bf16_gemm_pass(
    float (&acc)[Bf16Geo<M, BK>::MT][Bf16Geo<M, BK>::NT8][4], const Op& op, int n0,
    bf16* stages, const int* row_off, int batch, int q0, int q1, int group) {
  using G = Bf16Geo<M, BK>;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
  const int q_n = q1 - q0;
  Bf16Loader<M, BK> ld;
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
    bf16_mma_stage<M, BK>(acc, stages + use_at * G::STAGE);
    use_at = use_at + 1 == ST ? 0 : use_at + 1;
  }
  cp_async_wait<0>();
  group_sync(group);  // the ring is free
}

// Eight floats of the carry, rounded to bf16, as one 16-byte word.
__device__ __forceinline__ int4 bf16x8(const float* a) {
  const float4 x = reinterpret_cast<const float4*>(a)[0];
  const float4 y = reinterpret_cast<const float4*>(a)[1];
  __nv_bfloat162 h[4] = {__floats2bfloat162_rn(x.x, x.y), __floats2bfloat162_rn(x.z, x.w),
                         __floats2bfloat162_rn(y.x, y.y), __floats2bfloat162_rn(y.z, y.w)};
  return *reinterpret_cast<int4*>(h);
}

// bf16(act) of this block's rows and column slice into dst (row stride c) at
// column col0, and into dst + copy when copy != 0.
__device__ __forceinline__ void store_act(bf16* dst, size_t copy, const float* act_s,
                                          const int* row_off, int rows, int nc, int own,
                                          int col0, int c, bool vec) {
  if (vec) {  // c % 8 == 0: own and col0 are multiples of 8
    const int cpr = nc / 8;
    for (int i = threadIdx.x; i < rows * cpr; i += kTcThreads) {
      const int r = i / cpr;
      const int cl = (i - r * cpr) * 8;
      const int ro = row_off[r];
      if (ro < 0 || cl >= own) continue;
      const int4 v = bf16x8(act_s + r * nc + cl);
      bf16* at = dst + (size_t)ro * c + col0 + cl;
      *reinterpret_cast<int4*>(at) = v;
      if (copy) *reinterpret_cast<int4*>(at + copy) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * nc; i += kTcThreads) {
    const int r = i / nc;
    const int cl = i - r * nc;
    const int ro = row_off[r];
    if (ro < 0 || cl >= own) continue;
    const bf16 v = __float2bfloat16(act_s[i]);
    bf16* at = dst + (size_t)ro * c + col0 + cl;
    *at = v;
    if (copy) at[copy] = v;
  }
}

template <int M>
__global__ void __launch_bounds__(kTcThreads, 1) stream_bf16_kernel(const StepArgs p) {
  constexpr int BK = kBK, ST = kTcStages;
  using G = Bf16Geo<M, BK>;
  const int group = threadIdx.x / NT;
  extern __shared__ float4 smem4[];
  const int n = p.slices;
  const int rank = blockIdx.x % n;  // this block's rank in its cluster
  const int tile = blockIdx.x / n;
  const int c = p.c;
  const int nc = slice_cols(c, n);
  const int col0 = rank * nc;
  const int own = min(nc, c - col0);
  const size_t plane = (size_t)p.k * p.batch * c;
  float* act_s = reinterpret_cast<float*>(smem4);  // M x nc, the float32 carry slice
  int* row_off = reinterpret_cast<int*>(act_s + (size_t)M * nc);
  int* slot_s = row_off + M;
  const int* zero_slot = slot_s + kTcSlotInts - 1;
  bf16* stages = reinterpret_cast<bf16*>(slot_s + kTcSlotInts) + group * ST * G::STAGE;
  float* red = reinterpret_cast<float*>(reinterpret_cast<bf16*>(slot_s + kTcSlotInts) +
                                        ST * G::STAGE);
  bf16* hbuf = static_cast<bf16*>(p.xbuf);  // h of the current block
  bf16* abuf = hbuf + plane;                // the last block's bf16(act), for the shrink

  tile_rows(row_off, slot_s, M, p.k, p.batch, tile);
  __syncthreads();
  const float* x = static_cast<const float*>(p.x);
  for (int i = threadIdx.x; i < M * nc; i += kTcThreads) {
    const int r = i / nc;
    const int cl = i - r * nc;
    const int ro = row_off[r];
    act_s[i] = ro >= 0 && cl < own ? x[(size_t)ro * c + col0 + cl] : 0.f;
  }
  __syncthreads();

  const bool vec = c % 8 == 0;
  float acc[G::MT][G::NT8][4];
  // acc = this pass's sums, whole in warp group 0: each group sums half the K tiles.
  auto sums = [&](const Op& op, int n0) {
    const int q_n = op.terms * ((op.k + BK - 1) / BK);
    const int half = (q_n + 1) / 2;
    bf16_gemm_pass<M, BK, ST>(acc, op, n0, stages, row_off, p.batch, group ? half : 0,
                              group ? q_n : half, group);
    combine<G>(acc, red, group);
  };
  for (int bi = 0; bi < p.n_blocks; ++bi) {
    const BlockArgs& bk = p.blk[bi];
    bf16* ring = static_cast<bf16*>(bk.ring);
    const size_t copy = p.doubled ? (size_t)bk.cap * p.batch * c : 0;
    store_act(ring + (size_t)bk.write * p.batch * c, copy, act_s, row_off, M, nc, own, col0, c,
              vec);
    // Tap j's first ring row, oldest first; the newest tap is the pushed row.
    const int t = threadIdx.x;
    if (t <= kMaxTaps) slot_s[t] = t + 1 < bk.width ? bk.slot[t] : bk.write;
    cluster_barrier();  // every slice of this block's input is in the ring

    Op op;
    op.a = ring;
    op.b = static_cast<const bf16*>(bk.wa);
    op.b_step = (size_t)c * c;
    op.terms = bk.width;
    op.k = c;
    op.lda = c;
    op.ldb = c;
    op.n_end = col0 + own;
    op.vec_a = vec;
    op.vec_b = vec;
    op.slot = slot_s;
    const float* s1 = bk.v[0];
    const float* t1 = bk.v[1];
    for (int pass = 0; pass < own; pass += kTcNP) {
      sums(op, col0 + pass);
      if (group) continue;
      for_each_acc<G>(acc, own - pass, [&](int r, int col, float v) {
        const int ro = row_off[r];
        const int gc = col0 + pass + col;
        if (ro >= 0) {
          hbuf[(size_t)ro * c + gc] =
              __float2bfloat16(fmaxf(__fadd_rn(__fmul_rn(v, s1[gc]), t1[gc]), 0.f));
        }
      });
    }
    cluster_barrier();  // h whole in the exchange buffer

    op.a = hbuf;
    op.b = static_cast<const bf16*>(bk.wb);
    op.terms = 1;
    op.slot = zero_slot;
    const float* s2 = bk.v[2];
    const float* t2 = bk.v[3];
    for (int pass = 0; pass < own; pass += kTcNP) {
      sums(op, col0 + pass);
      if (group) continue;
      for_each_acc<G>(acc, own - pass, [&](int r, int col, float v) {
        const int cl = pass + col;
        const int gc = col0 + cl;
        float& a = act_s[r * nc + cl];
        a = __fadd_rn(a, fmaxf(__fadd_rn(__fmul_rn(v, s2[gc]), t2[gc]), 0.f));
      });
    }
    __syncthreads();  // the carry slice is whole before the next push reads it
  }

  // Shrink: bf16(act) @ Ws + bs, float32, frame-major poses; the J3 output columns
  // split over the cluster as the channels are.
  store_act(abuf, 0, act_s, row_off, M, nc, own, col0, c, vec);
  cluster_barrier();
  const int ncj = slice_cols(p.j3, n);
  const int j0 = rank * ncj;
  const int jown = min(ncj, p.j3 - j0);
  Op op;
  op.a = abuf;
  op.b = p.ws;
  op.b_step = 0;
  op.terms = 1;
  op.k = c;
  op.lda = c;
  op.ldb = p.j3;
  op.n_end = j0 + max(jown, 0);
  op.vec_a = vec;
  op.vec_b = p.j3 % 8 == 0;
  op.slot = zero_slot;
  for (int pass = 0; pass < jown; pass += kTcNP) {
    sums(op, j0 + pass);
    if (group) continue;
    for_each_acc<G>(acc, jown - pass, [&](int r, int col, float v) {
      const int ro = row_off[r];
      const int jc = j0 + pass + col;
      if (ro >= 0) p.out[(size_t)ro * p.j3 + jc] = __fadd_rn(v, p.bs[jc]);
    });
  }
}

using Kern = void (*)(const StepArgs);

Kern kernel_for(int rows) {
  switch (rows) {
    case 16: return stream_bf16_kernel<16>;
    case 32: return stream_bf16_kernel<32>;
    case 48: return stream_bf16_kernel<48>;
    case 64: return stream_bf16_kernel<64>;
    default: return stream_bf16_kernel<80>;
  }
}

}  // namespace

size_t stream_bf16_min_smem(int c) { return smem_bytes(16, max_slices(c), c); }

cudaError_t launch_stream_bf16(const StepArgs& p, cudaStream_t stream) {
  if (p.xbuf == nullptr || !plan_valid(p.rows, p.slices, p.k, p.c)) {
    return cudaErrorInvalidValue;
  }
  return launch_plan(kernel_for(p.rows), smem_bytes(p.rows, p.slices, p.c), p, stream);
}

}  // namespace vp3d

extern "C" {

// Dynamic shared memory of the bf16 step at plan (rows, slices) and c channels.
size_t vp3d_stream_bf16_smem(int rows, int slices, int channels) {
  return vp3d::smem_bytes(rows, slices, channels);
}

// How many clusters of plan (rows, slices) at c channels the card runs at once
// (cudaOccupancyMaxActiveClusters), or -1 when the plan is invalid: the check of
// the cost model's 120 usable SMs for clusters of 4 and 8 (kernel_ab.py --sweep).
int vp3d_stream_bf16_max_clusters(int rows, int slices, int channels) {
  if (!vp3d::plan_valid(rows, slices, 1, channels)) return -1;
  return vp3d::max_active_clusters(vp3d::kernel_for(rows), slices,
                                   vp3d::smem_bytes(rows, slices, channels));
}

}  // extern "C"
