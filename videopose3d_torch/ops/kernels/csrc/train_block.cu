// Fused strided residual block of the training model, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of videopose3d_tpu/ops/pallas/train_block.py
// (fused_train_block and its custom VJP):
//   conv_stats             -> _conv_stats_kernel
//   norm_drop_matmul_stats -> _norm_drop_matmul_stats_kernel
//   norm_drop_res          -> _norm_drop_res_kernel
//   relu_mask_bn_sums      -> _relu_mask_bn_sums_kernel (both BatchNorms)
//   dz_matmul_dd + dw_gemm -> _dz_matmul_dw_kernel
//   du_dtaps_res           -> _du_dtaps_res_kernel
// stats_reduce finishes the cross-tile BatchNorm sums of the GEMM kernels;
// relu_mask_bn_sums finishes its own inside its launch, over a thread block cluster.
//
// The block, over n = B * T/fw rows of fw taps (x3 is the free (n, fw, C) view of x):
//   u = x3 @ Wa;  d = mask_a * relu(bn_a(u));  v = d @ Wb;
//   out = x3[:, center] + mask_b * relu(bn_b(v))
// with train-mode BatchNorm: the biased batch statistics come from per-channel sums
// of (u - shift) and (u - shift)^2 taken in the GEMM epilogues.  Its backward runs
// the ReLU/dropout gate with the BatchNorm sums (relu_mask_bn_sums), the BatchNorm
// input gradient and the next product (dz_matmul_dd, du_dtaps_res), and both weight
// gradients as their own GEMMs (dw_gemm: dWb = d^T dz, and dWa = x3^T du, which the
// JAX package leaves to XLA).
//
// Numerics: values are cast to the activation type T (float or bf16) at exactly the
// points the Pallas bodies cast; the elementwise BatchNorm affine is evaluated in T
// with one rounding per operation and no fused multiply-add (the same operations
// torch performs elementwise), so the backward gate replays the forward's
// pre-activation bit for bit and a bf16 value near 0 opens the same ReLU gate in
// both passes.  Every sum is float32.
//
// What bounds it on this card: the products, 2 * n * C^2 * (fw + 1) FLOP forward and
// 2 * n * C^2 * (2 fw + 2) backward, on the tensor cores in 3xTF32 (three TF32 MMAs a
// float32 product, float32's accuracy; 495 TFLOP/s of TF32 dense, so 165 of float32
// work at most, against 67 for float32 FMAs).  mma.sync m16n8k8 reaches about half
// of that rate (one TF32 MMA per ~9 cycles of an SM quarter on an H100); wgmma,
// which takes TF32 operands only K-major in shared memory, is later work.
//
// Every product is a 128 x 128-tile GEMM on sgemm_tile.cuh: a CUDA block of 256
// threads owns a 128 x 128 output tile, each warp 64 x 32 of it in m16n8k8 MMAs,
// 32-deep slabs of both operands flow through 3-stage cp.async rings of shared
// memory, and two CUDA blocks share an SM.
// - dw_gemm (dW (m, C) = a^T b over the n rows: dWb = d^T dz, m = C, and dWa = x3^T
//   du, m = fw C): both operands are row-major in the summed dimension, so both
//   are staged summed-index-major.  At C = 1,024 the 64 (dWb) or 192 (dWa) tiles
//   leave the 132 SMs a ragged round, so the rows are split into slices (split-K,
//   planned by the Python wrapper with the tap GEMMs' cost model: 2 slices); each
//   slice writes a float32 partial and dw_reduce adds the partials in slice order.
// - The other four products are tap GEMMs (tap_gemm_kernel): conv_stats (u = x3
//   (n, fw C) @ Wa (fw C, C)), du_dtaps_res (dx3 (n, fw C) = du (n, C) @ Wa^T (C, fw
//   C)) and the one-tap norm_drop_matmul_stats (v = d @ Wb) and dz_matmul_dd (dd =
//   dz @ Wb^T).  A is row-major in the summed dimension and is staged so, tile row
//   by tile row.  The epilogues are fused: the cast to T, the BatchNorm partial
//   sums per 128-row tile (conv_stats, norm_drop_matmul_stats), conv_stats's
//   residual tap (copied out by column tile 0 from the A slabs it stages),
//   du_dtaps_res's residual cotangent added to the center tap in T.  The one-tap
//   kernels' and du_dtaps_res's A operands (d, dz, du) are outputs too, so a
//   first, elementwise launch writes them (norm_drop_kernel, bn_grad_kernel) and
//   the GEMM reads them back: one more read of n x C, ~0.03 ms at n = 27,648.
//   Where shorter blocks even out the SMs' shares of a ragged last round of tiles
//   (at C = 1,024: 64 tiles at n = 1,024, 192 at n = 3,072), the summed dimension
//   is split (planned by the wrapper) and tap_gemm_reduce adds the slices in order
//   before the epilogue.
// bf16 operands are staged as they are and widened when read from shared memory:
// exact in TF32, each product is one MMA.
//
// The TPU grid runs in order, so the Pallas bodies carry the BatchNorm sums and dWb
// in VMEM scratch across grid steps.  CUDA blocks run in parallel, so each row tile
// writes its per-channel partial sums to an (n_tiles, C) buffer that stats_reduce
// adds up in tile order, and the split products' slices are added up in slice
// order.  No float atomics: two runs give bitwise-equal results.  Partial row
// tiles, slabs and output tiles are masked, and nothing is held per channel in
// shared memory, so any n and any C % 4 == 0 are taken (the Python block pads
// other widths with zero channels).
//
// relu_mask_bn_sums is the backward's elementwise pass: it reads g, z and the mask
// and writes gz, four n x C tensors, so bytes bound it (0.135 ms at n = 27,648, C =
// 1,024, float32).  Each thread owns four adjacent columns and moves them as one
// 16-byte float32 word (8 bytes of bf16) per tensor and row, with RS_UNROLL rows of
// loads in flight; a CUDA block owns a strip of RS_COLS columns over a slice of the
// rows, and the slices of one strip are one thread block cluster.  Each block adds
// its threads' partial sums in slot order in shared memory; after a cluster barrier
// the cluster's first block reads its peers' sums over distributed shared memory and
// adds them in rank order.  One launch, no global scratch or counter, no float
// atomics: any stream, graph replays and two launches give bitwise-equal results.
// The wrapper sizes the clusters (relu_sums_plan) so that the grid keeps ~6 MiB of
// loads in flight: at C = 1,024, 8 slices in float32 and 16 in bf16, 256 and 512
// CUDA blocks of 128 threads at every n of the step.  On an H100 that beat half and
// twice as much in flight, in both dtypes (kernel_ab.py --sweep k2ew; PERF.md,
// section 6).

#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "sgemm_tile.cuh"

namespace {

using namespace vp3d;
namespace cg = cooperative_groups;

constexpr int DW_STAGES = 3;   // dw_gemm slabs in the ring

// relu_mask_bn_sums's geometry, mirrored in train_block.py (SUM_COLS, SUM_SLOTS,
// SUM_UNROLL, SUM_MAX_CLUSTER): threads and columns per CUDA block (four per thread),
// the rows a block reads at once, rows of loads in flight per thread, and the most
// blocks of a cluster (past 8, the H100's non-portable sizes).
constexpr int RS_THREADS = 128;
constexpr int RS_COLS = 32;
constexpr int RS_LANES = RS_COLS / 4;
constexpr int RS_SLOTS = RS_THREADS / RS_LANES;
constexpr int RS_UNROLL = 4;
constexpr int RS_MAX_CLUSTER = 16;
static_assert(2 * RS_COLS <= RS_THREADS, "one thread per column sum");

// (a - b) * c + e in T, rounded after every operation, without contraction.
template <typename T>
__device__ __forceinline__ float affine(float a, float b, float c, float e) {
  const float t = round_to<T>(__fsub_rn(a, b));
  const float s = round_to<T>(__fmul_rn(t, c));
  return round_to<T>(__fadd_rn(s, e));
}

template <typename T>
__device__ __forceinline__ float mask_at(const T* mask, size_t i) {
  return mask == nullptr ? 1.f : to_f<T>(mask[i]);
}

// out = res + mask * relu(bn(v)), all in T; without res (null), out = mask *
// relu(bn(v)): norm_drop_res, and the first pass of norm_drop_matmul_stats (d).
// gate rows: [mean, inv, bias] in T.
template <typename T>
__global__ void __launch_bounds__(NT) norm_drop_kernel(
    const T* __restrict__ v, const T* __restrict__ mask, const T* __restrict__ gate,
    const T* __restrict__ res, size_t total, int c, T* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < total;
       i += (size_t)gridDim.x * NT) {
    const int k = (int)(i % c);
    const float y = affine<T>(to_f<T>(v[i]), to_f<T>(gate[k]), to_f<T>(gate[c + k]),
                              to_f<T>(gate[2 * c + k]));
    const float e = round_to<T>(__fmul_rn(fmaxf(y, 0.f), mask_at(mask, i)));
    out[i] = from_f<T>(res == nullptr ? e : __fadd_rn(to_f<T>(res[i]), e));
  }
}

// Grid of the elementwise kernels over `total` values: 16 waves of NT-thread
// blocks on 132 SMs at most, each thread striding over the rest.
dim3 elementwise_grid(size_t total) {
  return dim3((unsigned)std::min<size_t>((total + NT - 1) / NT, 132 * 16));
}

// gz = g * mask * [bn(z) > 0] (gate replayed in T), stored in T, and the finished
// float32 sums of gz and gz * zhat, zhat = (z - mean) * inv, into sums (2, c).
// stat rows: [mean, inv] float32; gate rows: [mean, inv, bias] in T.  Launched in
// clusters: cluster i owns columns [RS_COLS i, RS_COLS (i + 1)), its block of rank r
// rows [r rows, min(n, (r + 1) rows)).  Thread (slot, lane) reads columns 4 lane..
// of rows slot, slot + RS_SLOTS, ... of its block's slice, in order.
template <typename T>
__global__ void __launch_bounds__(RS_THREADS) relu_mask_bn_sums_kernel(
    const T* __restrict__ g, const T* __restrict__ z, const T* __restrict__ mask,
    const float* __restrict__ stat, const T* __restrict__ gate, int n, int c, int rows,
    T* __restrict__ gz, float* __restrict__ sums) {
  __shared__ float4 slot_sums[2][RS_SLOTS][RS_LANES];
  __shared__ float block_sums[2][RS_COLS];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int col0 = (blockIdx.x / k) * RS_COLS;
  const int lane = threadIdx.x % RS_LANES, slot = threadIdx.x / RS_LANES;
  const int col = col0 + 4 * lane;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < c) {
    float gm[4], gi[4], gb[4], mean[4], inv[4];
    load4(gate + col, gm);
    load4(gate + c + col, gi);
    load4(gate + 2 * c + col, gb);
    load4(stat + col, mean);
    load4(stat + c + col, inv);
    const int r1 = min(n, (rank + 1) * rows);
    for (int r = rank * rows + slot; r < r1; r += RS_SLOTS * RS_UNROLL) {
      float gv[RS_UNROLL][4], zv[RS_UNROLL][4], mv[RS_UNROLL][4];
#pragma unroll
      for (int u = 0; u < RS_UNROLL; ++u) {
        const int row = r + u * RS_SLOTS;
        if (row < r1) {
          const size_t i = (size_t)row * c + col;
          load4(g + i, gv[u]);
          load4(z + i, zv[u]);
          if (mask != nullptr) {
            load4(mask + i, mv[u]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) mv[u][j] = 1.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < RS_UNROLL; ++u) {
        const int row = r + u * RS_SLOTS;
        if (row < r1) {
          float out[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float keep = affine<T>(zv[u][j], gm[j], gi[j], gb[j]) > 0.f ? 1.f : 0.f;
            out[j] = __fmul_rn(__fmul_rn(gv[u][j], mv[u][j]), keep);
            const float zhat = __fmul_rn(__fsub_rn(zv[u][j], mean[j]), inv[j]);
            s1[j] = __fadd_rn(s1[j], out[j]);
            s2[j] = __fadd_rn(s2[j], __fmul_rn(out[j], zhat));
          }
          store4<T>(gz + (size_t)row * c + col, round_to<T>(out[0]), round_to<T>(out[1]),
                    round_to<T>(out[2]), round_to<T>(out[3]));
        }
      }
    }
  }
  slot_sums[0][slot][lane] = make_float4(s1[0], s1[1], s1[2], s1[3]);
  slot_sums[1][slot][lane] = make_float4(s2[0], s2[1], s2[2], s2[3]);
  __syncthreads();
  // The block's sums of each column: its slots in order.
  const int which = threadIdx.x / RS_COLS, cc = threadIdx.x % RS_COLS;
  if (which < 2) {
    const float* part = reinterpret_cast<const float*>(slot_sums[which]);
    float s = part[cc];
    for (int q = 1; q < RS_SLOTS; ++q) s = __fadd_rn(s, part[q * RS_COLS + cc]);
    block_sums[which][cc] = s;
  }
  cluster.sync();  // every block's sums readable across the cluster
  if (rank == 0 && which < 2 && col0 + cc < c) {  // the cluster's: blocks in rank order
    float s = block_sums[which][cc];
    for (int q = 1; q < k; ++q) {
      s = __fadd_rn(s, *cluster.map_shared_rank(&block_sums[which][cc], q));
    }
    sums[(size_t)which * c + col0 + cc] = s;
  }
  cluster.sync();  // no block leaves while the first still reads its shared memory
}

// The BatchNorm input gradient dz = c0 * (gz - c1 - zhat * c2), zhat = (z - mean) * inv,
// of one row, cast to T.  coef rows: [inv * scale, c1, c2, inv, mean].
template <typename T>
__device__ __forceinline__ float bn_input_grad(float gzf, float zf, const float* coef,
                                               int c, int k) {
  const float zhat = __fmul_rn(__fsub_rn(zf, coef[4 * c + k]), coef[3 * c + k]);
  const float t = __fsub_rn(__fsub_rn(gzf, coef[c + k]), __fmul_rn(zhat, coef[2 * c + k]));
  return round_to<T>(__fmul_rn(coef[k], t));
}

// du = the BatchNorm input gradient of ga, cast to T: the first pass of
// du_dtaps_res and dz_matmul_dd, whose products then run as tap GEMMs.
template <typename T>
__global__ void __launch_bounds__(NT) bn_grad_kernel(
    const T* __restrict__ ga, const T* __restrict__ u, const float* __restrict__ coef,
    size_t total, int c, T* __restrict__ du) {
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < total;
       i += (size_t)gridDim.x * NT) {
    const float v = bn_input_grad<T>(to_f<T>(ga[i]), to_f<T>(u[i]), coef, c, (int)(i % c));
    du[i] = from_f<T>(v);
  }
}

// A tap GEMM: out (m x n) = A (m x k) @ B (k x n), all row-major, cast to T, with
// the epilogue of conv_stats (shift set: per-column partial sums, as
// norm_drop_matmul_stats's; res set: A's columns [res_k0, res_k0 + res_n) copied out
// as they are staged) or of du_dtaps_res (g set: g added in T to columns [g_col0,
// g_col0 + g_n)); dz_matmul_dd's has none of these.  With part set, each
// blockIdx.z slice of k_slice summed rows writes its float32 product there and
// tap_gemm_reduce adds the slices in order and runs the epilogue.
template <typename T>
struct TapGemm {
  const T* a;
  const T* b;
  int m, k, n, k_slice;
  float* part;  // (slices, m, n), or null
  T* out;
  const float* shift;
  float* part1;  // (row tiles, n)
  float* part2;
  T* res;
  int res_k0, res_n;
  const T* g;
  int g_col0, g_n;
};

// Copies the residual tap's part of a landed A slab (summed rows [k0, k0 + GK)) to
// res: this thread's own words of a_slab_cp_async, read back from shared memory.
template <typename T>
__device__ __forceinline__ void copy_res(const TapGemm<T>& p, const T* as, int i0, int k0,
                                         int k_end) {
  using V = std::conditional_t<sizeof(T) == 4, float4, uint2>;
  const int kk = k0 + 4 * (threadIdx.x % 8);
  if (kk >= k_end || kk < p.res_k0 || kk >= p.res_k0 + p.res_n) return;
#pragma unroll
  for (int q = 0; q < GK * GT / 4 / GT_THREADS; ++q) {
    const int r = threadIdx.x / 8 + 32 * q;
    if (i0 + r < p.m) {
      *reinterpret_cast<V*>(p.res + (size_t)(i0 + r) * p.res_n + kk - p.res_k0) =
          *reinterpret_cast<const V*>(as + r * a_ld<T>() + kk - k0);
    }
  }
}

// The epilogue of a finished tile: cast to T (then + g in T), store, and the
// tile's per-column sums of (out - shift) and its square, each thread's 8 rows in
// order, then the 16 threads of a column in row-group order (red: 2 x 16 x GT
// floats of shared memory), written to row tile blockIdx.y of part1 / part2.
template <typename T>
__device__ __forceinline__ void tap_epilogue(const TapGemm<T>& p, float (&acc)[GRT][GRT],
                                             float* red) {
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
#pragma unroll
  for (int r = 0; r < GRT; ++r) {
    const int i = i0 + tile_row(r);
#pragma unroll
    for (int h = 0; h < GRT / 2; ++h) {
      const int j = j0 + tile_col(2 * h);
      const bool add_g = p.g != nullptr && i < p.m && j >= p.g_col0 && j < p.g_col0 + p.g_n;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = round_to<T>(acc[r][2 * h + e]);
        if (add_g) {
          v = round_to<T>(__fadd_rn(v, to_f<T>(p.g[(size_t)i * p.g_n + j + e - p.g_col0])));
        }
        acc[r][2 * h + e] = v;
      }
      if (i < p.m && j < p.n) {
        store2<T>(p.out + (size_t)i * p.n + j, acc[r][2 * h], acc[r][2 * h + 1]);
      }
    }
  }
  if (p.shift == nullptr) return;
  constexpr int GROUPS = GT / GRT;
  const int group = tile_row_group();
#pragma unroll
  for (int q = 0; q < GRT; ++q) {
    const int col = tile_col(q);
    const float sh = j0 + col < p.n ? p.shift[j0 + col] : 0.f;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int r = 0; r < GRT; ++r) {
      if (i0 + tile_row(r) < p.m) {
        const float y = __fsub_rn(acc[r][q], sh);
        s1 = __fadd_rn(s1, y);
        s2 = __fadd_rn(s2, __fmul_rn(y, y));
      }
    }
    red[group * GT + col] = s1;
    red[(GROUPS + group) * GT + col] = s2;
  }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (threadIdx.x < GT && j < p.n) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < GROUPS; ++t) {
      s1 = __fadd_rn(s1, red[t * GT + threadIdx.x]);
      s2 = __fadd_rn(s2, red[(GROUPS + t) * GT + threadIdx.x]);
    }
    p.part1[(size_t)blockIdx.y * p.n + j] = s1;
    p.part2[(size_t)blockIdx.y * p.n + j] = s2;
  }
}

// One GT x GT tile of out (blockIdx.x: column tile, blockIdx.y: row tile) over the
// summed rows of slice blockIdx.z: sgemm_tile.cuh's main loop over A's rows as they
// are (column tile 0 also copies the residual tap's), then the epilogue, or the
// float32 sums of a split.
template <typename T>
__global__ void __launch_bounds__(GT_THREADS, 2) tap_gemm_kernel(
    const __grid_constant__ TapGemm<T> p) {
  extern __shared__ float4 smem4[];
  T* a_s = reinterpret_cast<T*>(smem4);     // [B_STAGES][GT][a_ld]
  T* b_s = a_s + B_STAGES * a_slab<T>();    // [B_STAGES][GK][GLD]
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  const int k_begin = blockIdx.z * p.k_slice;
  const int k_end = min(p.k, k_begin + p.k_slice);
  const bool res = p.res != nullptr && blockIdx.x == 0;
  float acc[GRT][GRT];
  tile_gemm_loop(
      acc, a_s, b_s, p.b, p.n, j0, k_begin, k_end, p.a,
      [&](int r, int kk) -> const T* {
        return i0 + r < p.m && kk < k_end ? p.a + (size_t)(i0 + r) * p.k + kk : nullptr;
      },
      [&](const T* as, int k0) {
        if (res) copy_res(p, as, i0, k0, k_end);
      });
  if (p.part != nullptr) {
    tile_store_part(acc, p.part, p.m, p.n, i0, j0);
    return;
  }
  __syncthreads();  // the rings are free: the epilogue's sums reuse them
  tap_epilogue(p, acc, reinterpret_cast<float*>(smem4));
}

// The split form's second launch, in a grid of (column tiles, row tiles): the
// tile's slices of the float32 products added in slice order into the accumulator
// layout (zeros past m or n), then the epilogue.  Each slice's 32 loads of a thread
// are issued before its adds, so that they are in flight together.
template <typename T>
__global__ void __launch_bounds__(GT_THREADS) tap_gemm_reduce_kernel(
    const __grid_constant__ TapGemm<T> p, int slices) {
  __shared__ float red[2 * (GT / GRT) * GT];
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  float acc[GRT][GRT];
  tile_zero(acc);
  const float* part = p.part;
  for (int z = 0; z < slices; ++z, part += (size_t)p.m * p.n) {
    float2 v[GRT][GRT / 2];
#pragma unroll
    for (int r = 0; r < GRT; ++r) {
      const int i = i0 + tile_row(r);
#pragma unroll
      for (int h = 0; h < GRT / 2; ++h) {
        const int j = j0 + tile_col(2 * h);
        v[r][h] = i < p.m && j < p.n
                      ? *reinterpret_cast<const float2*>(part + (size_t)i * p.n + j)
                      : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int r = 0; r < GRT; ++r) {
#pragma unroll
      for (int h = 0; h < GRT / 2; ++h) {
        acc[r][2 * h] = z == 0 ? v[r][h].x : __fadd_rn(acc[r][2 * h], v[r][h].x);
        acc[r][2 * h + 1] = z == 0 ? v[r][h].y : __fadd_rn(acc[r][2 * h + 1], v[r][h].y);
      }
    }
  }
  tap_epilogue(p, acc, red);
}

template <typename T>
cudaError_t launch_tap_gemm(const TapGemm<T>& p, int slices, cudaStream_t s) {
  const dim3 grid((p.n + GT - 1) / GT, (p.m + GT - 1) / GT, slices);
  const size_t smem = sizeof(T) * B_STAGES * (a_slab<T>() + TAP_SLAB);
  // Two CUDA blocks of 105 KB (float32) share an SM only with the whole carveout.
  cudaError_t err = cudaFuncSetAttribute(tap_gemm_kernel<T>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = launch_with_smem(tap_gemm_kernel<T>, grid, dim3(GT_THREADS), smem, s, p);
  if (err != cudaSuccess || slices == 1) return err;
  return launch_with_smem(tap_gemm_reduce_kernel<T>, dim3(grid.x, grid.y), dim3(GT_THREADS),
                          0, s, p, slices);
}

// Starts the copy of rows [r0, min(r0 + GK, r_end)) of a's columns i0.. (a: m
// columns) and b's columns j0.. (b: c columns), GT each, into one slab of dw_gemm's
// ring; rows and columns outside are zero-filled.  Each warp copies whole 512-byte
// (float32) row segments.  One loop for both operands: two slab_cp_async calls
// spill dw_gemm's registers.
template <typename T>
__device__ __forceinline__ void dw_load_slab(T* a_s, T* b_s, const T* __restrict__ a,
                                             const T* __restrict__ b, int m, int c, int r0,
                                             int r_end, int i0, int j0) {
  constexpr int PER_ROW = GT / 4;
#pragma unroll
  for (int q = 0; q < GK * PER_ROW / GT_THREADS; ++q) {
    const int e = threadIdx.x + q * GT_THREADS;
    const int rr = e / PER_ROW, cc = (e % PER_ROW) * 4, r = r0 + rr;
    const bool a_ok = r < r_end && i0 + cc < m, b_ok = r < r_end && j0 + cc < c;
    cp_async4(a_s + rr * GLD + cc, a + (a_ok ? (size_t)r * m + i0 + cc : 0), a_ok);
    cp_async4(b_s + rr * GLD + cc, b + (b_ok ? (size_t)r * c + j0 + cc : 0), b_ok);
  }
}

// out[blockIdx.z] = a[rows]^T @ b[rows] (m x c), float32, over the rows of slice
// blockIdx.z: [z * slice_rows, min(n, (z + 1) * slice_rows)), one GT x GT tile of dw
// per CUDA block (blockIdx.x: column tile, blockIdx.y: row tile).  Both operands
// are row-major in the summed dimension, so their slabs go to shared memory by
// cp.async as they are, in a DW_STAGES-deep ring.
template <typename T>
__global__ void __launch_bounds__(GT_THREADS, 2) dw_gemm_kernel(
    const T* __restrict__ a, const T* __restrict__ b, int n, int m, int c, int slice_rows,
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  T* a_s = reinterpret_cast<T*>(smem4);  // [DW_STAGES][GK][GLD]
  T* b_s = a_s + DW_STAGES * TAP_SLAB;
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  const int r_begin = blockIdx.z * slice_rows;
  const int r_end = min(n, r_begin + slice_rows);
  const int slabs = (r_end - r_begin + GK - 1) / GK;
  float acc[GRT][GRT];
  tile_zero(acc);
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < slabs) {
      dw_load_slab(a_s + s * TAP_SLAB, b_s + s * TAP_SLAB, a, b, m, c, r_begin + s * GK,
                   r_end, i0, j0);
    }
    cp_async_commit();
  }
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<DW_STAGES - 2>();  // this thread's copies of slab t have landed
    __syncthreads();                 // everyone's have, and slab t - 1 is consumed
    const int next = t + DW_STAGES - 1;
    if (next < slabs) {
      const int st = next % DW_STAGES;
      dw_load_slab(a_s + st * TAP_SLAB, b_s + st * TAP_SLAB, a, b, m, c, r_begin + next * GK,
                   r_end, i0, j0);
    }
    cp_async_commit();
    tile_mma_slab<false>(acc, a_s + (t % DW_STAGES) * TAP_SLAB,
                         b_s + (t % DW_STAGES) * TAP_SLAB);
  }
  out += (size_t)blockIdx.z * m * c;
#pragma unroll
  for (int r = 0; r < GRT; ++r) {
    const int i = i0 + tile_row(r);
    if (i >= m) continue;
#pragma unroll
    for (int h = 0; h < GRT / 2; ++h) {
      const int j = j0 + tile_col(2 * h);
      if (j < c) {  // c % 4 == 0: a column pair is wholly in or out
        *reinterpret_cast<float2*>(out + (size_t)i * c + j) =
            make_float2(acc[r][2 * h], acc[r][2 * h + 1]);
      }
    }
  }
}

// dw[k] = sum over slices s, in order, of part[s][k]: (slices, n4 float4) -> (n4).
__global__ void __launch_bounds__(NT) dw_reduce_kernel(const float4* __restrict__ part,
                                                       int slices, size_t n4,
                                                       float4* __restrict__ dw) {
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * NT) {
    float4 s = part[i];
    for (int p = 1; p < slices; ++p) {
      const float4 v = part[p * n4 + i];
      s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                      __fadd_rn(s.w, v.w));
    }
    dw[i] = s;
  }
}

template <typename T>
cudaError_t launch_dw_gemm(int n, int m, int c, int slices, int slice_rows, const void* a,
                           const void* b, void* part, void* dw, cudaStream_t s) {
  const size_t smem = 2 * sizeof(T) * DW_STAGES * TAP_SLAB;
  float* target = static_cast<float*>(slices == 1 ? dw : part);
  // Two CUDA blocks of 102 KB (float32) share an SM only with the whole carveout.
  cudaError_t err = cudaFuncSetAttribute(dw_gemm_kernel<T>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = launch_with_smem(dw_gemm_kernel<T>, dim3((c + GT - 1) / GT, (m + GT - 1) / GT, slices),
                         dim3(GT_THREADS), smem, s, static_cast<const T*>(a),
                         static_cast<const T*>(b), n, m, c, slice_rows, target);
  if (err != cudaSuccess || slices == 1) return err;
  const size_t n4 = (size_t)m * c / 4;
  const dim3 grid((unsigned)std::min<size_t>((n4 + NT - 1) / NT, 132 * 8));
  return launch_with_smem(dw_reduce_kernel, grid, dim3(NT), 0, s,
                          static_cast<const float4*>(part), slices, n4,
                          static_cast<float4*>(dw));
}

// out[k] = sum over parts in order of part[p * c + k], for two buffers at once.
__global__ void __launch_bounds__(NT) stats_reduce_kernel(const float* __restrict__ part1,
                                                          const float* __restrict__ part2,
                                                          int n_parts, int c,
                                                          float* __restrict__ out1,
                                                          float* __restrict__ out2) {
  const int k = blockIdx.x * NT + threadIdx.x;
  if (k >= c) return;
  float s1 = 0.f, s2 = 0.f;
  for (int p = 0; p < n_parts; ++p) {
    s1 = __fadd_rn(s1, part1[(size_t)p * c + k]);
    s2 = __fadd_rn(s2, part2[(size_t)p * c + k]);
  }
  out1[k] = s1;
  out2[k] = s2;
}

bool bad_shape(int n, int c) { return n <= 0 || c <= 0 || c % 4 != 0; }

template <typename T> const T* cp(const void* p) { return static_cast<const T*>(p); }
template <typename T> T* mp(void* p) { return static_cast<T*>(p); }

// A tap GEMM's shape: m rows of k summed columns into n columns, in `slices` slices
// of k_slice summed rows (the last one ragged) tiling [0, k).
bool bad_tap_gemm(int m, int k, int n, int slices, int k_slice, const void* part) {
  return m <= 0 || k <= 0 || n <= 0 || k % 4 != 0 || n % 4 != 0 ||
         (m + GT - 1) / GT > 65535 || slices <= 0 || slices > 65535 || k_slice <= 0 ||
         k_slice % 4 != 0 || (long long)(slices - 1) * k_slice >= k ||
         (long long)slices * k_slice < k || (slices > 1 && part == nullptr);
}

// Whether any pointer misses the 16-byte (float32) or 8-byte (bf16) alignment of
// the kernels' vector loads and stores.
bool misaligned(int dtype, std::initializer_list<const void*> ptrs) {
  const uintptr_t align = dtype == 0 ? 16 : 8;
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % align) return true;
  }
  return false;
}

// The tap GEMM out (m, n) = a (m, k) @ b (k, n) in `slices` slices of k_slice summed
// rows (part: their float32 products when slices > 1), without an epilogue's extras.
template <typename T>
TapGemm<T> tap_gemm_of(const void* a, const void* b, int m, int k, int n, int slices,
                       int k_slice, void* part, void* out) {
  TapGemm<T> p{};
  p.a = cp<T>(a);
  p.b = cp<T>(b);
  p.m = m;
  p.k = k;
  p.n = n;
  p.k_slice = k_slice;
  p.part = slices > 1 ? mp<float>(part) : nullptr;
  p.out = mp<T>(out);
  return p;
}

template <typename T>
cudaError_t conv_stats_t(int n, int c, int fw, int center, int slices, int k_slice,
                         const void* x3, const void* wa, const void* shift, void* u,
                         void* res, void* part1, void* part2, void* part, cudaStream_t s) {
  TapGemm<T> p = tap_gemm_of<T>(x3, wa, n, fw * c, c, slices, k_slice, part, u);
  p.shift = cp<float>(shift);
  p.part1 = mp<float>(part1);
  p.part2 = mp<float>(part2);
  p.res = mp<T>(res);
  p.res_k0 = center * c;
  p.res_n = c;
  return launch_tap_gemm(p, slices, s);
}

template <typename T>
cudaError_t norm_drop_matmul_stats_t(int n, int c, int slices, int k_slice, const void* u,
                                     const void* mask, const void* gate, const void* wb,
                                     const void* shift, void* d, void* v, void* part1,
                                     void* part2, void* part, cudaStream_t s) {
  const size_t total = (size_t)n * c;
  cudaError_t err = launch_with_smem(norm_drop_kernel<T>, elementwise_grid(total), dim3(NT),
                                     0, s, cp<T>(u), cp<T>(mask), cp<T>(gate),
                                     static_cast<const T*>(nullptr), total, c, mp<T>(d));
  if (err != cudaSuccess) return err;
  TapGemm<T> p = tap_gemm_of<T>(d, wb, n, c, c, slices, k_slice, part, v);
  p.shift = cp<float>(shift);
  p.part1 = mp<float>(part1);
  p.part2 = mp<float>(part2);
  return launch_tap_gemm(p, slices, s);
}

template <typename T>
cudaError_t dz_matmul_dd_t(int n, int c, int slices, int k_slice, const void* gz,
                           const void* z, const void* coef, const void* wbt, void* dz,
                           void* dd, void* part, cudaStream_t s) {
  const size_t total = (size_t)n * c;
  cudaError_t err = launch_with_smem(bn_grad_kernel<T>, elementwise_grid(total), dim3(NT), 0,
                                     s, cp<T>(gz), cp<T>(z), cp<float>(coef), total, c,
                                     mp<T>(dz));
  if (err != cudaSuccess) return err;
  return launch_tap_gemm(tap_gemm_of<T>(dz, wbt, n, c, c, slices, k_slice, part, dd), slices,
                         s);
}

template <typename T>
cudaError_t du_dtaps_res_t(int n, int c, int fw, int center, int slices, int k_slice,
                           const void* ga, const void* u, const void* g, const void* coef,
                           const void* wt, void* du, void* dx3, void* part, cudaStream_t s) {
  const size_t total = (size_t)n * c;
  cudaError_t err = launch_with_smem(bn_grad_kernel<T>, elementwise_grid(total), dim3(NT), 0,
                                     s, cp<T>(ga), cp<T>(u), cp<float>(coef), total, c,
                                     mp<T>(du));
  if (err != cudaSuccess) return err;
  TapGemm<T> p = tap_gemm_of<T>(du, wt, n, c, fw * c, slices, k_slice, part, dx3);
  p.g = cp<T>(g);
  p.g_col0 = center * c;
  p.g_n = c;
  return launch_tap_gemm(p, slices, s);
}

// Launches relu_mask_bn_sums_kernel<T> in clusters of `cluster` blocks.
template <typename T>
cudaError_t launch_relu_mask_bn_sums(int n, int c, int cluster, int rows, const void* g,
                                     const void* z, const void* mask, const void* stat,
                                     const void* gate, void* gz, void* sums,
                                     cudaStream_t stream) {
  auto kern = relu_mask_bn_sums_kernel<T>;
  if (cluster > 8) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((c + RS_COLS - 1) / RS_COLS) * cluster));
  cfg.blockDim = dim3(RS_THREADS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, cp<T>(g), cp<T>(z), cp<T>(mask),
                                       cp<float>(stat), cp<T>(gate), n, c, rows, mp<T>(gz),
                                       mp<float>(sums));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns cudaGetLastError()
// after the launch (0 on success).  dtype 0 = float32, 1 = bfloat16 for the T
// operands; BatchNorm statistics, shifts, coefficients, partial sums and dw are
// float32.  A null mask means no dropout.  Shapes are checked by the Python wrapper.

// u (n, c) = x3 (n, fw * c) @ wa (fw * c, c) cast to T, res = x3[:, center], and
// per 128-row tile partial sums of (u - shift) and its square into part1 / part2
// ((n + 127) / 128, c); the summed dimension in `slices` slices of k_slice (part:
// (slices, n, c) float32 scratch when slices > 1).  x3 and wa 16-byte (float32) or
// 8-byte (bf16) aligned.
int vp3d_tb_conv_stats(int dtype, int n, int c, int fw, int center, int slices, int k_slice,
                       const void* x3, const void* wa, const void* shift, void* u, void* res,
                       void* part1, void* part2, void* part, void* stream) {
  if (c <= 0 || fw <= 0 || center < 0 || center >= fw ||
      bad_tap_gemm(n, fw * c, c, slices, k_slice, part)) {
    return cudaErrorInvalidValue;
  }
  if (misaligned(dtype, {x3, wa, u, res, part})) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return conv_stats_t<float>(n, c, fw, center, slices, k_slice, x3, wa, shift, u, res,
                               part1, part2, part, s);
  }
  if (dtype == 1) {
    return conv_stats_t<__nv_bfloat16>(n, c, fw, center, slices, k_slice, x3, wa, shift, u,
                                       res, part1, part2, part, s);
  }
  return cudaErrorInvalidValue;
}

// d (n, c) = mask * relu(bn(u)) in T (one launch), then v (n, c) = d @ wb (c, c) cast
// to T with the per 128-row tile partial sums of (v - shift) and its square into
// part1 / part2 ((n + 127) / 128, c) (a second launch, split as conv_stats's).  gate
// rows: [mean, inv, bias] in T.  wb 16-byte (float32) or 8-byte (bf16) aligned.
int vp3d_tb_norm_drop_matmul_stats(int dtype, int n, int c, int slices, int k_slice,
                                   const void* u, const void* mask, const void* gate,
                                   const void* wb, const void* shift, void* d, void* v,
                                   void* part1, void* part2, void* part, void* stream) {
  if (bad_tap_gemm(n, c, c, slices, k_slice, part)) return cudaErrorInvalidValue;
  if (misaligned(dtype, {wb, d, v, part})) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return norm_drop_matmul_stats_t<float>(n, c, slices, k_slice, u, mask, gate, wb, shift,
                                           d, v, part1, part2, part, s);
  }
  if (dtype == 1) {
    return norm_drop_matmul_stats_t<__nv_bfloat16>(n, c, slices, k_slice, u, mask, gate, wb,
                                                   shift, d, v, part1, part2, part, s);
  }
  return cudaErrorInvalidValue;
}

int vp3d_tb_norm_drop_res(int dtype, int n, int c, const void* v, const void* mask,
                          const void* gate, const void* res, void* out, void* stream) {
  if (bad_shape(n, c) || res == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)n * c;
  const dim3 grid = elementwise_grid(total);
  if (dtype == 0) {
    return launch_with_smem(norm_drop_kernel<float>, grid, dim3(NT), 0, s, cp<float>(v),
                            cp<float>(mask), cp<float>(gate), cp<float>(res), total, c,
                            mp<float>(out));
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(norm_drop_kernel<B>, grid, dim3(NT), 0, s, cp<B>(v), cp<B>(mask),
                            cp<B>(gate), cp<B>(res), total, c, mp<B>(out));
  }
  return cudaErrorInvalidValue;
}

// gz (n, c) = g * mask * [bn(z) > 0] in T, and sums (2, c) float32: the sums of gz
// and of gz * zhat over the rows, in one launch of clusters of `cluster` CUDA blocks
// (at most 16), each block `rows` rows of the slice, (cluster - 1) * rows < n <=
// cluster * rows.  Every T operand 16-byte (float32) or 8-byte (bf16) aligned, stat
// 16-byte aligned.
int vp3d_tb_relu_mask_bn_sums(int dtype, int n, int c, int cluster, int rows,
                              const void* g, const void* z, const void* mask,
                              const void* stat, const void* gate, void* gz, void* sums,
                              void* stream) {
  if (bad_shape(n, c) || cluster < 1 || cluster > RS_MAX_CLUSTER || rows < 1 ||
      (long long)(cluster - 1) * rows >= n || (long long)cluster * rows < n) {
    return cudaErrorInvalidValue;
  }
  if (misaligned(dtype, {g, z, mask, gate, gz}) || misaligned(0, {stat})) {
    return cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_relu_mask_bn_sums<float>(n, c, cluster, rows, g, z, mask, stat, gate, gz,
                                           sums, s);
  }
  if (dtype == 1) {
    return launch_relu_mask_bn_sums<__nv_bfloat16>(n, c, cluster, rows, g, z, mask, stat,
                                                   gate, gz, sums, s);
  }
  return cudaErrorInvalidValue;
}

// dz (n, c) = the BatchNorm input gradient of gz, cast to T (one launch), then dd
// (n, c) = dz @ wbt (c, c) cast to T (a second launch, split as conv_stats's); wbt is
// Wb transposed, 16-byte (float32) or 8-byte (bf16) aligned.
int vp3d_tb_dz_matmul_dd(int dtype, int n, int c, int slices, int k_slice, const void* gz,
                         const void* z, const void* coef, const void* wbt, void* dz, void* dd,
                         void* part, void* stream) {
  if (bad_tap_gemm(n, c, c, slices, k_slice, part)) return cudaErrorInvalidValue;
  if (misaligned(dtype, {wbt, dz, dd, part})) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dz_matmul_dd_t<float>(n, c, slices, k_slice, gz, z, coef, wbt, dz, dd, part, s);
  }
  if (dtype == 1) {
    return dz_matmul_dd_t<__nv_bfloat16>(n, c, slices, k_slice, gz, z, coef, wbt, dz, dd,
                                         part, s);
  }
  return cudaErrorInvalidValue;
}

// du (n, c) = the BatchNorm input gradient of ga (one launch), then dx3 (n, fw * c)
// = du @ wt (c, fw * c) cast to T, with g (n, c) added in T to the center tap's
// columns (a second launch, split as conv_stats's).  wt[o][j * c + i] = wa[j][i][o].
int vp3d_tb_du_dtaps_res(int dtype, int n, int c, int fw, int center, int slices,
                         int k_slice, const void* ga, const void* u, const void* g,
                         const void* coef, const void* wt, void* du, void* dx3, void* part,
                         void* stream) {
  if (fw <= 0 || center < 0 || center >= fw ||
      bad_tap_gemm(n, c, fw * c, slices, k_slice, part)) {
    return cudaErrorInvalidValue;
  }
  if (misaligned(dtype, {wt, du, dx3, part})) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return du_dtaps_res_t<float>(n, c, fw, center, slices, k_slice, ga, u, g, coef, wt, du,
                                 dx3, part, s);
  }
  if (dtype == 1) {
    return du_dtaps_res_t<__nv_bfloat16>(n, c, fw, center, slices, k_slice, ga, u, g, coef,
                                         wt, du, dx3, part, s);
  }
  return cudaErrorInvalidValue;
}

// dw (m, c) = a^T @ b over n rows, a (n, m) and b (n, c), split into `slices` row
// slices of slice_rows rows (the last one ragged): with one slice the kernel writes
// dw itself; otherwise each slice writes its (m, c) partial into part (slices, m, c)
// and a second launch adds them up in slice order.  a and b must be 16-byte
// (float32) or 8-byte (bf16) aligned; every slice must hold at least one row.
int vp3d_tb_dw_gemm(int dtype, int n, int m, int c, int slices, int slice_rows,
                    const void* a, const void* b, void* part, void* dw, void* stream) {
  if (bad_shape(n, c) || bad_shape(n, m) || (m + GT - 1) / GT > 65535 || slices <= 0 ||
      slice_rows <= 0 ||
      (long long)(slices - 1) * slice_rows >= n || (long long)slices * slice_rows < n ||
      slices > 65535 || (slices > 1 && part == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t align = dtype == 0 ? 16 : 8;
  if (reinterpret_cast<uintptr_t>(a) % align || reinterpret_cast<uintptr_t>(b) % align) {
    return cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dw_gemm<float>(n, m, c, slices, slice_rows, a, b, part, dw, s);
  }
  if (dtype == 1) {
    return launch_dw_gemm<__nv_bfloat16>(n, m, c, slices, slice_rows, a, b, part, dw, s);
  }
  return cudaErrorInvalidValue;
}

int vp3d_tb_stats_reduce(int n_parts, int c, const void* part1, const void* part2,
                         void* out1, void* out2, void* stream) {
  if (n_parts <= 0 || c <= 0) return cudaErrorInvalidValue;
  return launch_with_smem(stats_reduce_kernel, dim3((c + NT - 1) / NT), dim3(NT), 0,
                          static_cast<cudaStream_t>(stream), cp<float>(part1),
                          cp<float>(part2), n_parts, c, mp<float>(out1), mp<float>(out2));
}

// The geometry train_block.py mirrors: 0, rows per partial-sum tile of the tap GEMMs
// (conv_stats, norm_drop_matmul_stats; DW_TILE); then relu_mask_bn_sums's 1, columns
// per CUDA block (SUM_COLS), 2, rows a block reads at once (SUM_SLOTS), 3, rows of
// loads in flight per thread (SUM_UNROLL), 4, most blocks per cluster
// (SUM_MAX_CLUSTER).
int vp3d_tb_geometry(int what) {
  const int values[] = {GT, RS_COLS, RS_SLOTS, RS_UNROLL, RS_MAX_CLUSTER};
  return what >= 0 && what < 5 ? values[what] : -1;
}

}  // extern "C"
