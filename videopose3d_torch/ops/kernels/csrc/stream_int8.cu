// The fused int8 streaming step on the tensor cores, for Hopper (sm_90a): every w8a8
// residual block and the shrink projection for one frame (K5) or k frames (K6) of B
// streams in one launch, pushing each block's int8 input into its ring in place.
//
// Replaces the Pallas TPU kernels of videopose3d_tpu/ops/pallas/streaming_fused.py:
//   fused_blocks_step (_fused_blocks_kernel, launched by _fused_call) at k = 1, and
//   fused_blocks_step_multi (_fused_blocks_multi_kernel) at k > 1.
//
// What it computes, per row (frame f, stream b) and residual block (the plain
// version, streaming_fused.block_step_i8):
//   push the int8 input x into the ring at `write` + f (and + cap when doubled);
//   acc  = sum_j tap_j @ Wa_j, exact in int32, tap j the ring row slot_j + f (the
//          newest tap, lag 0, at slot `write`);
//   real = relu(acc * A1 + B1);  m = max(max over the C columns of real, 1);
//   hq   = rint(real * (127 / m));
//   y    = relu(float(hq @ Wb) * (m * (1/127)) * A2 + B2);  v = float(x) * R + y;
//   the next block's input clip(rint(v), 0, 127); after the last block
//   poses = bf16(v) @ Ws + bs in float32.
// The products are int8 x int8 on mma.sync m16n8k32 summed exactly in int32 (the
// shrink bf16 x bf16 on m16n8k16, summed in float32); every float step is one IEEE
// operation with one rounding (__fmul_rn, __fadd_rn, __fdiv_rn) in the plain
// version's order, so every int8 ring equals the plain version's bit for bit.
//
// What bounds it on this card: per row (width + 1) C x C int8 products per block,
// 34.4 GOP at B = 1,024, k = 1, C = 1,024 and -arc 3,3,3,3,3 (1,979 dense int8
// TOP/s: 0.0175 ms); the bytes are the weights (8.4 MB, held in the 50 MB L2), the
// taps and the pushes.  As for the bf16 step, what sets the pace is how many K tiles
// each SM keeps in flight, and a K tile here holds twice the bf16 step's K values.
//
// Design: the bf16 step's (stream_bf16.cu), through stream_tc.cuh.  Rows are tiled
// M at a time (a multiple of 16 up to 80; with k frames a tile holds M / k streams x
// k frames) and every product's output columns are split over a cluster of n = 1, 2,
// 4 or 8 CUDA blocks, each owning a slice of C / n columns (rounded up to 8) of the
// int8 carry and of real in shared memory; each block is two warp groups that sum
// half a product's 64-deep K tiles each through their own 4-stage cp.async ring,
// added in a fixed order.  What int8 adds, where the cluster meets:
//   1. the row maximum of real: each block writes its slice's maxima to its shared
//      memory, and after a cluster barrier reads its peers' over distributed shared
//      memory (max is exact, so the order does not matter);
//   2. hq: each block writes its column slice of it into a (k * B, C) int8 exchange
//      buffer and, after the next cluster barrier, reads whole hq rows as A of the
//      1x1 product;
//   3. the next block's input: each block pushes its columns of it into the ring and
//      after a cluster barrier reads every tap from the ring, the step's own frames
//      (lag < k) included, as the plain version's push-then-read;
//   4. after the last block bf16(v) goes through a (k * B, C) bf16 exchange buffer,
//      and the shrink's output columns are split over the cluster, each summed whole
//      by one block in a fixed order, so two launches from one state give equal bits.
// Ring positions: from the host's ints by value, or, per frame (k = 1, single rings),
// from the positions on the card (StepArgs::pos, the streaming lifter's CUDA graph):
// each block then takes its write row and tap rows as (pos - lag) mod cap, so one
// captured launch serves every dispatch.
// Any C: the weights are packed once with K zero-padded to a multiple of 32 and N to
// one of 8 (streaming_fused.pack_int8_step), K and N tails are zero-filled, and ring
// and hq rows of C % 16 != 0 bytes, not 16-byte aligned, are loaded element by
// element.  The ceiling is the smallest plan's shared memory (16 rows, 8 slices: C
// up to 15,168).  The plan (M, n) comes with the launch, chosen by
// streaming_fused.stream_int8_plan (the bf16 step's cost model over this kernel's
// shared memory, with a term for the cluster's meetings); plan_valid refuses one
// this kernel cannot take.

#include "int8_quant.cuh"
#include "stream_step.cuh"
#include "stream_tc.cuh"

namespace vp3d {
namespace {

// Shared memory of one CUDA block: real (float32, M x nc), the row maxima, 127 / m
// and m / 127 (M floats each), the row offsets and tap slots, the int8 carry slice
// (M x nc), and each warp group's cp.async ring.
size_t smem_bytes(int m, int n, int c) {
  const size_t nc = slice_cols(c, n);
  return (size_t)m * nc * (sizeof(float) + 1) + (size_t)(4 * m + kTcSlotInts) * sizeof(int) +
         rings_bytes(m);
}

bool plan_valid(int m, int n, int k, int c) { return plan_fits(m, n, k, c, smem_bytes(m, n, c)); }

// This block's rows and column slice of the int8 carry into dst (row stride c) at
// column col0, and into dst + copy when copy != 0; 8 bytes at a time where c % 8 == 0.
__device__ __forceinline__ void push_rows(int8_t* dst, size_t copy, const int8_t* act_s,
                                          const int* row_off, int rows, int nc, int own,
                                          int col0, int c) {
  if (c % 8 == 0) {  // own and col0 are multiples of 8
    const int cpr = nc / 8;
    for (int i = threadIdx.x; i < rows * cpr; i += kTcThreads) {
      const int r = i / cpr;
      const int cl = (i - r * cpr) * 8;
      const int ro = row_off[r];
      if (ro < 0 || cl >= own) continue;
      const uint2 v = *reinterpret_cast<const uint2*>(act_s + r * nc + cl);
      int8_t* at = dst + (size_t)ro * c + col0 + cl;
      *reinterpret_cast<uint2*>(at) = v;
      if (copy) *reinterpret_cast<uint2*>(at + copy) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * nc; i += kTcThreads) {
    const int r = i / nc;
    const int cl = i - r * nc;
    const int ro = row_off[r];
    if (ro < 0 || cl >= own) continue;
    int8_t* at = dst + (size_t)ro * c + col0 + cl;
    *at = act_s[i];
    if (copy) at[copy] = act_s[i];
  }
}

// rmax_s[r] = the maximum of row r of real_s over this block's `own` columns
// (real >= 0), one warp per row.
__device__ __forceinline__ void row_max(const float* real_s, float* rmax_s, int rows, int nc,
                                        int own) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kTcThreads / 32) {
    float v = 0.f;
    for (int cl = lane; cl < own; cl += 32) v = fmaxf(v, real_s[r * nc + cl]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
    if (lane == 0) rmax_s[r] = v;
  }
}

template <int M>
__global__ void __launch_bounds__(kTcThreads, 1) stream_int8_kernel(const StepArgs p) {
  using GI = Geo<I8Mma, M>;
  using GB = Geo<Bf16Mma, M>;
  const int group = threadIdx.x / NT;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = p.slices;
  const int rank = blockIdx.x % n;  // this block's rank in its cluster
  const int tile = blockIdx.x / n;
  const int c = p.c;
  const int nc = slice_cols(c, n);
  const int col0 = rank * nc;
  const int own = min(nc, c - col0);
  const size_t plane = (size_t)p.k * p.batch * c;
  float* real_s = reinterpret_cast<float*>(smem4);  // M x nc
  float* rmax_s = real_s + (size_t)M * nc;          // this slice's row maxima
  float* inv_s = rmax_s + M;                        // 127 / m
  float* rs_s = inv_s + M;                          // m * (1/127)
  int* row_off = reinterpret_cast<int*>(rs_s + M);
  int* slot_s = row_off + M;
  const int* zero_slot = slot_s + kTcSlotInts - 1;
  int8_t* act_s = reinterpret_cast<int8_t*>(slot_s + kTcSlotInts);  // M x nc, the carry
  char* stages = reinterpret_cast<char*>(act_s + (size_t)M * nc);
  bf16* abuf = static_cast<bf16*>(p.xbuf);                 // the last block's bf16(v)
  int8_t* hbuf = reinterpret_cast<int8_t*>(abuf + plane);  // hq of the current block

  tile_rows(row_off, slot_s, M, p.k, p.batch, tile);
  __syncthreads();
  const int8_t* x = static_cast<const int8_t*>(p.x);
  for (int i = threadIdx.x; i < M * nc; i += kTcThreads) {
    const int r = i / nc;
    const int cl = i - r * nc;
    const int ro = row_off[r];
    act_s[i] = ro >= 0 && cl < own ? x[(size_t)ro * c + col0 + cl] : int8_t(0);
  }
  __syncthreads();

  const bool vec = c % 16 == 0;  // int8 rows of c bytes, 16-byte aligned
  const int ldw = packed_n(c);
  int acc[GI::MT][GI::NT8][4];
  for (int bi = 0; bi < p.n_blocks; ++bi) {
    const BlockArgs& bk = p.blk[bi];
    const bool last = bi == p.n_blocks - 1;
    int8_t* ring = static_cast<int8_t*>(bk.ring);
    const size_t copy = p.doubled ? (size_t)bk.cap * p.batch * c : 0;
    // The ring's position: the host's ints, or this block's position on the card.
    const int at = p.pos ? p.pos[1 + bi] : 0;
    const int write = p.pos ? ring_slot(at, 0, bk.cap) : bk.write;
    push_rows(ring + (size_t)write * p.batch * c, copy, act_s, row_off, M, nc, own, col0, c);
    // Tap j's first ring row, oldest first; the newest tap is the pushed row.
    const int t = threadIdx.x;
    if (t <= kMaxTaps) {
      slot_s[t] = t + 1 >= bk.width ? write
                  : p.pos        ? ring_slot(at, bk.lag[t], bk.cap)
                                 : bk.slot[t];
    }
    cluster_barrier();  // every slice of this block's input is in the ring

    Operand<I8Mma> op;
    op.a = ring;
    op.b = static_cast<const int32_t*>(bk.wa);
    op.b_step = (size_t)packed_k(c) / 4 * ldw;
    op.terms = bk.width;
    op.k = c;
    op.lda = c;
    op.ldb = ldw;
    op.n_end = col0 + own;
    op.vec_a = vec;
    op.vec_b = true;
    op.slot = slot_s;
    const float* a1 = bk.v[0];
    const float* b1 = bk.v[1];
    for (int pass = 0; pass < own; pass += kTcNP) {
      product_pass<I8Mma, M>(acc, op, col0 + pass, stages, row_off, p.batch, group);
      if (group) continue;
      for_each_acc<GI>(acc, own - pass, [&](int r, int col, int v) {
        const int gc = col0 + pass + col;
        real_s[r * nc + pass + col] =
            fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(v), a1[gc]), b1[gc]), 0.f);
      });
    }
    __syncthreads();  // real's slice is whole
    row_max(real_s, rmax_s, M, nc, own);
    cluster.sync();  // every slice's maxima readable across the cluster
    for (int r = threadIdx.x; r < M; r += kTcThreads) {
      float m = 0.f;
      for (int q = 0; q < n; ++q) m = fmaxf(m, cluster.map_shared_rank(rmax_s, q)[r]);
      m = fmaxf(m, 1.f);
      inv_s[r] = __fdiv_rn(kQmax, m);
      rs_s[r] = __fmul_rn(m, kInvQmax);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M * nc; i += kTcThreads) {
      const int r = i / nc;
      const int cl = i - r * nc;
      const int ro = row_off[r];
      if (ro >= 0 && cl < own) {
        hbuf[(size_t)ro * c + col0 + cl] =
            static_cast<int8_t>(static_cast<int>(rintf(__fmul_rn(real_s[i], inv_s[r]))));
      }
    }
    cluster_barrier();  // hq whole in the exchange buffer; the peers' maxima read

    op.a = hbuf;
    op.b = static_cast<const int32_t*>(bk.wb);
    op.b_step = 0;
    op.terms = 1;
    op.slot = zero_slot;
    const float* a2 = bk.v[2];
    const float* b2 = bk.v[3];
    const float* res = bk.v[4];
    for (int pass = 0; pass < own; pass += kTcNP) {
      product_pass<I8Mma, M>(acc, op, col0 + pass, stages, row_off, p.batch, group);
      if (group) continue;
      for_each_acc<GI>(acc, own - pass, [&](int r, int col, int v) {
        const int cl = pass + col;
        const int gc = col0 + cl;
        const float y = fmaxf(
            __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v), rs_s[r]), a2[gc]), b2[gc]), 0.f);
        int8_t& a = act_s[r * nc + cl];
        const float out = __fadd_rn(__fmul_rn(static_cast<float>(a), res[gc]), y);
        if (!last) {
          a = to_stream(out);
        } else if (row_off[r] >= 0) {
          abuf[(size_t)row_off[r] * c + gc] = __float2bfloat16(out);
        }
      });
    }
    __syncthreads();  // the carry slice is whole before the next push reads it
  }

  // Shrink: bf16(v) @ Ws + bs, float32, frame-major poses; the J3 output columns
  // split over the cluster as the channels are.
  cluster_barrier();
  const int ncj = slice_cols(p.j3, n);
  const int j0 = rank * ncj;
  const int jown = min(ncj, p.j3 - j0);
  Operand<Bf16Mma> op;
  op.a = abuf;
  op.b = p.ws;
  op.b_step = 0;
  op.terms = 1;
  op.k = c;
  op.lda = c;
  op.ldb = p.j3;
  op.n_end = j0 + max(jown, 0);
  op.vec_a = c % 8 == 0;
  op.vec_b = p.j3 % 8 == 0;
  op.slot = zero_slot;
  float sacc[GB::MT][GB::NT8][4];
  for (int pass = 0; pass < jown; pass += kTcNP) {
    product_pass<Bf16Mma, M>(sacc, op, j0 + pass, stages, row_off, p.batch, group);
    if (group) continue;
    for_each_acc<GB>(sacc, jown - pass, [&](int r, int col, float v) {
      const int ro = row_off[r];
      const int jc = j0 + pass + col;
      if (ro >= 0) p.out[(size_t)ro * p.j3 + jc] = __fadd_rn(v, p.bs[jc]);
    });
  }
}

using Kern = void (*)(const StepArgs);

Kern kernel_for(int rows) {
  switch (rows) {
    case 16: return stream_int8_kernel<16>;
    case 32: return stream_int8_kernel<32>;
    case 48: return stream_int8_kernel<48>;
    case 64: return stream_int8_kernel<64>;
    default: return stream_int8_kernel<80>;
  }
}

}  // namespace

size_t stream_int8_min_smem(int c) { return smem_bytes(16, max_slices(c), c); }

cudaError_t launch_stream_int8(const StepArgs& p, cudaStream_t stream) {
  if (p.xbuf == nullptr || !plan_valid(p.rows, p.slices, p.k, p.c)) {
    return cudaErrorInvalidValue;
  }
  return launch_plan(kernel_for(p.rows), smem_bytes(p.rows, p.slices, p.c), p, stream);
}

}  // namespace vp3d

extern "C" {

// Dynamic shared memory of the int8 step at plan (rows, slices) and c channels.
size_t vp3d_stream_int8_smem(int rows, int slices, int channels) {
  return vp3d::smem_bytes(rows, slices, channels);
}

// How many clusters of plan (rows, slices) at c channels the card runs at once, or
// -1 when the plan is invalid (kernel_ab.py --sweep stream_int8).
int vp3d_stream_int8_max_clusters(int rows, int slices, int channels) {
  if (!vp3d::plan_valid(rows, slices, 1, channels)) return -1;
  return vp3d::max_active_clusters(vp3d::kernel_for(rows), slices,
                                   vp3d::smem_bytes(rows, slices, channels));
}

}  // extern "C"
