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
// stats_reduce finishes the cross-tile BatchNorm sums of the kernels that produce them.
//
// The block, over n = B * T/fw rows of fw taps (x3 is the free (n, fw, C) view of x):
//   u = x3 @ Wa;  d = mask_a * relu(bn_a(u));  v = d @ Wb;
//   out = x3[:, center] + mask_b * relu(bn_b(v))
// with train-mode BatchNorm: the biased batch statistics come from per-channel sums
// of (u - shift) and (u - shift)^2 taken in the GEMM epilogues.  Its backward runs
// the ReLU/dropout gate with the BatchNorm sums (relu_mask_bn_sums), the BatchNorm
// input gradient fused with the next product (dz_matmul_dd, du_dtaps_res), and dWb
// as its own GEMM; dWa stays a plain matmul outside, as in the JAX package.
//
// Numerics: values are cast to the activation type T (float or bf16) at exactly the
// points the Pallas bodies cast; the elementwise BatchNorm affine is evaluated in T
// with one rounding per operation and no fused multiply-add (the same operations
// torch performs elementwise), so the backward gate replays the forward's
// pre-activation bit for bit and a bf16 value near 0 opens the same ReLU gate in
// both passes.  Every sum is float32.
//
// What bounds it on this card: the products, 2 * n * C^2 * (fw + 1) FLOP forward and
// 2 * n * C^2 * (fw + 2) in these kernels backward, on CUDA-core FP32 FMAs (67 TFLOP/s
// peak); tensor cores (wgmma) are later work.  The one-tap row-tile kernels
// (norm_drop_matmul_stats, dz_matmul_dd) stream the C x C weights from L2 once per
// 16-row tile (8 FLOP per weight byte) and keep the tile's A operand in shared memory.
//
// The GEMMs with the most work are 128 x 128-tile SGEMMs on sgemm_tile.cuh: a CUDA
// block of 256 threads owns a 128 x 128 output tile, each thread an 8 x 8 register
// tile (four FMAs per shared-memory float, ~32 FLOP per byte staged), 32-deep slabs
// of the summed dimension flow through rings of shared memory, and two CUDA blocks
// share an SM.
// - dw_gemm (dWb = d^T dz over the n rows): both operands are row-major in the
//   summed dimension, so both go to shared memory by 16-byte cp.async as they are,
//   in a 3-stage ring.  At C = 1,024 there are only 64 tiles for 132 SMs, so the
//   rows are split into slices (split-K, planned by the Python wrapper: 4 slices,
//   256 CUDA blocks, one wave); each slice writes a float32 partial and dw_reduce
//   adds the partials in slice order.
// - conv_stats (u = x3 (n, fw C) @ Wa (fw C, C)) and du_dtaps_res (dx3 (n, fw C) =
//   du (n, C) @ Wa^T (C, fw C)) are tap GEMMs (tap_gemm_kernel): B goes through the
//   same cp.async ring, but A is row-major in the summed dimension, so each thread
//   reads a 4 x 4 block of its next slab into registers by 16-byte loads while the
//   current one is used, then stores it transposed by four vector stores
//   (XOR-swizzled by 4-row group, no bank conflicts) into a 2-stage ring.  The
//   epilogues are fused: the cast to T, conv_stats's BatchNorm partial sums per
//   128-row tile and its residual tap (written by column tile 0 from the A values
//   it stages), du_dtaps_res's residual cotangent added to the center tap in T.  du
//   itself is a first, elementwise launch (bn_grad_kernel).  Where shorter blocks
//   even out the SMs' shares of a ragged last round of tiles (conv_stats at
//   n <= 9,216, du_dtaps_res at n = 1,024), the summed dimension is split (planned
//   by the wrapper) and tap_gemm_reduce adds the slices in order before the
//   epilogue.
// bf16 operands are staged as they are and widened when read from shared memory.
//
// The TPU grid runs in order, so the Pallas bodies carry the BatchNorm sums and dWb
// in VMEM scratch across grid steps.  CUDA blocks run in parallel, so each row tile
// writes its per-channel partial sums to an (n_tiles, C) buffer that stats_reduce
// adds up in tile order, and the split products' slices are added up in slice
// order.  No float atomics: two runs give bitwise-equal results.  Partial row
// tiles, slabs and output tiles are masked, so any n and any C % 4 == 0 are taken;
// the row-tile kernels also need their 16 x C float32 tile in shared memory
// (C <= 3,632).

#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "sgemm_tile.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace vp3d;

constexpr int SUM_ROWS = 64;   // rows per CUDA block of relu_mask_bn_sums
constexpr int DW_STAGES = 3;   // dw_gemm slabs in the ring

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

// Per-channel sums of this thread's columns over the valid rows of its tile.
__device__ __forceinline__ void write_partials(const float (&val)[TM][CPT], int rows,
                                               int c, int col0, const float* shift,
                                               float* part1, float* part2) {
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int col = col0 + threadIdx.x + q * NT;
    if (col >= c) continue;
    const float sh = shift[col];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      if (r < rows) {
        const float y = __fsub_rn(val[r][q], sh);
        s1 = __fadd_rn(s1, y);
        s2 = __fadd_rn(s2, __fmul_rn(y, y));
      }
    }
    part1[(size_t)blockIdx.x * c + col] = s1;
    part2[(size_t)blockIdx.x * c + col] = s2;
  }
}

// d = mask * relu(bn(u)) in T (stored); v = d @ Wb cast to T; partial sums of
// (v - shift) and its square.  gate rows: [mean, inv, bias] in T.
template <typename T>
__global__ void __launch_bounds__(NT, 1) norm_drop_matmul_stats_kernel(
    const T* __restrict__ u, const T* __restrict__ mask, const T* __restrict__ gate,
    const T* __restrict__ wb, const float* __restrict__ shift, int n, int c,
    T* __restrict__ d, T* __restrict__ v, float* __restrict__ part1,
    float* __restrict__ part2) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  const int i0 = blockIdx.x * TM;
  const int rows = min(TM, n - i0);
  for (int r = 0; r < TM; ++r) {
    for (int k = threadIdx.x; k < c; k += NT) {
      float val = 0.f;
      if (r < rows) {
        const size_t i = (size_t)(i0 + r) * c + k;
        const float y = affine<T>(to_f<T>(u[i]), to_f<T>(gate[k]), to_f<T>(gate[c + k]),
                                  to_f<T>(gate[2 * c + k]));
        val = round_to<T>(__fmul_rn(fmaxf(y, 0.f), mask_at(mask, i)));
        d[i] = from_f<T>(val);
      }
      a_s[r * c + k] = val;
    }
  }
  __syncthreads();
  float acc[TM][CPT];
  for (int col0 = 0; col0 < c; col0 += NP) {
    zero(acc);
    gemm_tile<T>(acc, a_s, c, c, wb, c, c, col0);
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = col0 + threadIdx.x + q * NT;
      if (col >= c) continue;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        acc[r][q] = round_to<T>(acc[r][q]);
        if (r < rows) v[(size_t)(i0 + r) * c + col] = from_f<T>(acc[r][q]);
      }
    }
    write_partials(acc, rows, c, col0, shift, part1, part2);
  }
}

// out = res + mask * relu(bn(v)), all in T.
template <typename T>
__global__ void __launch_bounds__(NT) norm_drop_res_kernel(
    const T* __restrict__ v, const T* __restrict__ mask, const T* __restrict__ gate,
    const T* __restrict__ res, size_t total, int c, T* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < total;
       i += (size_t)gridDim.x * NT) {
    const int k = (int)(i % c);
    const float y = affine<T>(to_f<T>(v[i]), to_f<T>(gate[k]), to_f<T>(gate[c + k]),
                              to_f<T>(gate[2 * c + k]));
    const float e = round_to<T>(__fmul_rn(fmaxf(y, 0.f), mask_at(mask, i)));
    out[i] = from_f<T>(__fadd_rn(to_f<T>(res[i]), e));
  }
}

// gz = g * mask * [bn(z) > 0] (gate replayed in T), stored in T; partial sums of
// gz and gz * zhat with zhat = (z - mean) * inv in float32.  stat rows: [mean, inv].
template <typename T>
__global__ void __launch_bounds__(NT) relu_mask_bn_sums_kernel(
    const T* __restrict__ g, const T* __restrict__ z, const T* __restrict__ mask,
    const float* __restrict__ stat, const T* __restrict__ gate, int n, int c,
    T* __restrict__ gz, float* __restrict__ part1, float* __restrict__ part2) {
  const int col = blockIdx.x * NT + threadIdx.x;
  if (col >= c) return;
  const int i0 = blockIdx.y * SUM_ROWS;
  const int rows = min(SUM_ROWS, n - i0);
  const float gm = to_f<T>(gate[col]), gi = to_f<T>(gate[c + col]);
  const float gb = to_f<T>(gate[2 * c + col]);
  const float mean = stat[col], inv = stat[c + col];
  float s1 = 0.f, s2 = 0.f;
  for (int r = 0; r < rows; ++r) {
    const size_t i = (size_t)(i0 + r) * c + col;
    const float zf = to_f<T>(z[i]);
    const float keep = affine<T>(zf, gm, gi, gb) > 0.f ? 1.f : 0.f;
    const float gzf = __fmul_rn(__fmul_rn(to_f<T>(g[i]), mask_at(mask, i)), keep);
    gz[i] = from_f<T>(gzf);
    const float zhat = __fmul_rn(__fsub_rn(zf, mean), inv);
    s1 = __fadd_rn(s1, gzf);
    s2 = __fadd_rn(s2, __fmul_rn(gzf, zhat));
  }
  part1[(size_t)blockIdx.y * c + col] = s1;
  part2[(size_t)blockIdx.y * c + col] = s2;
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

// dz (stored, for dWb) and dd = dz @ Wb^T cast to T; wbt is Wb transposed.
template <typename T>
__global__ void __launch_bounds__(NT, 1) dz_matmul_dd_kernel(
    const T* __restrict__ gz, const T* __restrict__ z, const float* __restrict__ coef,
    const T* __restrict__ wbt, int n, int c, T* __restrict__ dz, T* __restrict__ dd) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  const int i0 = blockIdx.x * TM;
  const int rows = min(TM, n - i0);
  for (int r = 0; r < TM; ++r) {
    for (int k = threadIdx.x; k < c; k += NT) {
      float val = 0.f;
      if (r < rows) {
        const size_t i = (size_t)(i0 + r) * c + k;
        val = bn_input_grad<T>(to_f<T>(gz[i]), to_f<T>(z[i]), coef, c, k);
        dz[i] = from_f<T>(val);
      }
      a_s[r * c + k] = val;
    }
  }
  __syncthreads();
  float acc[TM][CPT];
  for (int col0 = 0; col0 < c; col0 += NP) {
    zero(acc);
    gemm_tile<T>(acc, a_s, c, c, wbt, c, c, col0);
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = col0 + threadIdx.x + q * NT;
      if (col >= c) continue;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        if (r < rows) dd[(size_t)(i0 + r) * c + col] = from_f<T>(acc[r][q]);
      }
    }
  }
}

// du = the BatchNorm input gradient of ga, cast to T: the first pass of
// du_dtaps_res, whose product then runs as a tap GEMM.
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

// A tap GEMM: out (m x n) = A (m x k) @ B (k x n), all row-major, with the epilogue
// of conv_stats (shift set: per-column partial sums; res set: A's columns
// [res_k0, res_k0 + res_n) copied out as they are staged) or of du_dtaps_res (g
// set: g added in T to columns [g_col0, g_col0 + g_n)).  With part set, each
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

constexpr int A_STAGES = 2;  // A slabs in shared memory (staged through registers)
constexpr int B_STAGES = 3;  // B slabs in the cp.async ring
constexpr int TAP_SLAB = GK * GT;

// 4 consecutive elements of T in one register word group.
template <typename T> struct Vec4 { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

// The XOR swizzle of A's slabs: slab row kk keeps 4-row group gi at group
// gi ^ a_swizzle<T>(kk).  It puts the transposing stores of a_store in distinct
// banks (float32: 8 lanes of 16 bytes per phase, bf16: 16 of 8 bytes) and keeps a
// fragment read one 16-byte (8-byte) vector.
template <typename T>
__device__ __forceinline__ int a_swizzle(int kk) {
  return ((kk / 4) % 8) * (sizeof(T) == 4 ? 1 : 2);
}

// Loads this thread's 4 x 4 block of A's slab [k0, k0 + GK) into registers: rows
// i0 + 4 (threadIdx.x / 8) + r, columns k0 + (threadIdx.x % 8) * 4 .. + 3, so that
// 8 lanes read one row's whole slab segment; zeros outside.
template <typename T>
__device__ __forceinline__ void a_load(typename Vec4<T>::type (&ra)[4],
                                       const TapGemm<T>& p, int i0, int k0, int k_end) {
  using V = typename Vec4<T>::type;
  const int kc = k0 + (threadIdx.x % 8) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * (threadIdx.x / 8) + r;
    ra[r] = (i < p.m && kc < k_end)
                ? __ldg(reinterpret_cast<const V*>(p.a + (size_t)i * p.k + kc))
                : V{};
  }
}

// Stores the block of a_load transposed into the slab as ([GK][GT], K-major): four
// vector stores, one per slab row, of the block's 4 rows.  Column tile 0 also
// copies the rows that lie in the residual tap to res.
template <typename T>
__device__ __forceinline__ void a_store(T* as, const typename Vec4<T>::type (&ra)[4],
                                        const TapGemm<T>& p, int i0, int k0, int k_end,
                                        bool res) {
  using V = typename Vec4<T>::type;
  const int kl = (threadIdx.x % 8) * 4, kc = k0 + kl, gi = threadIdx.x / 8;
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
  if (res && kc < k_end && kc >= p.res_k0 && kc < p.res_k0 + p.res_n) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * gi + r;
      if (i < p.m) *reinterpret_cast<V*>(p.res + (size_t)i * p.res_n + kc - p.res_k0) = ra[r];
    }
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

// The epilogue of a finished tile: cast to T (then + g in T), store, and the
// tile's per-column sums of (out - shift) and its square, each thread's 8 rows in
// order, then the 16 row groups in order (red: 2 x 16 x GT floats of shared
// memory), written to row tile blockIdx.y of part1 / part2.
template <typename T>
__device__ __forceinline__ void tap_epilogue(const TapGemm<T>& p, float (&acc)[GRT][GRT],
                                             float* red) {
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT, ty = tile_ty(), tx = tile_tx();
#pragma unroll
  for (int r = 0; r < GRT; ++r) {
    const int i = i0 + tile_row(ty, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + tile_col(tx, h);
      const bool add_g = p.g != nullptr && i < p.m && j >= p.g_col0 && j < p.g_col0 + p.g_n;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = round_to<T>(acc[r][4 * h + e]);
        if (add_g) {
          v = round_to<T>(__fadd_rn(v, to_f<T>(p.g[(size_t)i * p.g_n + j + e - p.g_col0])));
        }
        acc[r][4 * h + e] = v;
      }
      if (i < p.m && j < p.n) {
        store4<T>(p.out + (size_t)i * p.n + j, acc[r][4 * h], acc[r][4 * h + 1],
                  acc[r][4 * h + 2], acc[r][4 * h + 3]);
      }
    }
  }
  if (p.shift == nullptr) return;
  constexpr int GROUPS = GT / GRT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = tile_col(tx, h) + e;
      const float sh = j0 + col < p.n ? p.shift[j0 + col] : 0.f;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int r = 0; r < GRT; ++r) {
        if (i0 + tile_row(ty, r) < p.m) {
          const float y = __fsub_rn(acc[r][4 * h + e], sh);
          s1 = __fadd_rn(s1, y);
          s2 = __fadd_rn(s2, __fmul_rn(y, y));
        }
      }
      red[ty * GT + col] = s1;
      red[(GROUPS + ty) * GT + col] = s2;
    }
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
// summed rows of slice blockIdx.z.  B's slabs flow through a B_STAGES-deep
// cp.async ring as in dw_gemm; A is row-major in the summed dimension, so its next
// slab is read into registers by 16-byte (8-byte bf16) loads while the current
// one is used, and stored transposed into an A_STAGES-deep ring.
template <typename T>
__global__ void __launch_bounds__(GT_THREADS, 2) tap_gemm_kernel(
    const __grid_constant__ TapGemm<T> p) {
  using V = typename Vec4<T>::type;
  extern __shared__ float4 smem4[];
  T* a_s = reinterpret_cast<T*>(smem4);  // [A_STAGES][GK][GT]
  T* b_s = a_s + A_STAGES * TAP_SLAB;    // [B_STAGES][GK][GT]
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  const int k_begin = blockIdx.z * p.k_slice;
  const int k_end = min(p.k, k_begin + p.k_slice);
  const int slabs = (k_end - k_begin + GK - 1) / GK;
  const bool res = p.res != nullptr && blockIdx.x == 0;
  const int ty = tile_ty(), tx = tile_tx();
  float acc[GRT][GRT];
  tile_zero(acc);
  for (int s = 0; s < B_STAGES - 1; ++s) {
    if (s < slabs) {
      slab_cp_async(b_s + s * TAP_SLAB, p.b, p.n, k_begin + s * GK, k_end, j0, p.n);
    }
    cp_async_commit();
  }
  V ra[4];
  a_load(ra, p, i0, k_begin, k_end);
  a_store(a_s, ra, p, i0, k_begin, k_end, res);
  if (slabs > 1) a_load(ra, p, i0, k_begin + GK, k_end);
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<B_STAGES - 2>();  // this thread's copies of B's slab t have landed
    __syncthreads();                // everyone's, and A's slab t; slab t - 1 is consumed
    if (t + B_STAGES - 1 < slabs) {
      const int next = t + B_STAGES - 1;
      slab_cp_async(b_s + (next % B_STAGES) * TAP_SLAB, p.b, p.n, k_begin + next * GK,
                    k_end, j0, p.n);
    }
    cp_async_commit();
    if (t + 1 < slabs) {  // A's slab t + 1 into the stage slab t - 1 left
      a_store(a_s + ((t + 1) % A_STAGES) * TAP_SLAB, ra, p, i0, k_begin + (t + 1) * GK,
              k_end, res);
      if (t + 2 < slabs) a_load(ra, p, i0, k_begin + (t + 2) * GK, k_end);
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
  if (p.part != nullptr) {
    float* part = p.part + (size_t)blockIdx.z * p.m * p.n;
#pragma unroll
    for (int r = 0; r < GRT; ++r) {
      const int i = i0 + tile_row(ty, r);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + tile_col(tx, h);
        if (i < p.m && j < p.n) {
          *reinterpret_cast<float4*>(part + (size_t)i * p.n + j) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                          acc[r][4 * h + 3]);
        }
      }
    }
    return;
  }
  __syncthreads();  // the rings are free: the epilogue's sums reuse them
  tap_epilogue(p, acc, reinterpret_cast<float*>(smem4));
}

// The split form's second launch: the slices' float32 products added in slice
// order into the same register tile, then the epilogue.
template <typename T>
__global__ void __launch_bounds__(GT_THREADS) tap_gemm_reduce_kernel(
    const __grid_constant__ TapGemm<T> p, int slices) {
  __shared__ float red[2 * (GT / GRT) * GT];
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT, ty = tile_ty(), tx = tile_tx();
  const size_t stride = (size_t)p.m * p.n;
  float acc[GRT][GRT];
  tile_zero(acc);
#pragma unroll
  for (int r = 0; r < GRT; ++r) {
    const int i = i0 + tile_row(ty, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + tile_col(tx, h);
      if (i >= p.m || j >= p.n) continue;
      const float4* src = reinterpret_cast<const float4*>(p.part + (size_t)i * p.n + j);
      float4 s = src[0];
      for (int z = 1; z < slices; ++z) {
        const float4 v = src[z * stride / 4];
        s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                        __fadd_rn(s.w, v.w));
      }
      acc[r][4 * h] = s.x;
      acc[r][4 * h + 1] = s.y;
      acc[r][4 * h + 2] = s.z;
      acc[r][4 * h + 3] = s.w;
    }
  }
  tap_epilogue(p, acc, red);
}

template <typename T>
cudaError_t launch_tap_gemm(const TapGemm<T>& p, int slices, cudaStream_t s) {
  const dim3 grid((p.n + GT - 1) / GT, (p.m + GT - 1) / GT, slices);
  const size_t smem = sizeof(T) * (A_STAGES + B_STAGES) * TAP_SLAB;
  // Two CUDA blocks of 80 KB (float32) share an SM only with the whole carveout.
  cudaError_t err = cudaFuncSetAttribute(tap_gemm_kernel<T>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = launch_with_smem(tap_gemm_kernel<T>, grid, dim3(GT_THREADS), smem, s, p);
  if (err != cudaSuccess || slices == 1) return err;
  return launch_with_smem(tap_gemm_reduce_kernel<T>, dim3(grid.x, grid.y), dim3(GT_THREADS),
                          0, s, p, slices);
}

// Starts the copy of rows [r0, min(r0 + GK, r_end)) of a's columns i0.. and b's
// columns j0.. (GT each) into one slab of dw_gemm's ring; rows and columns outside
// are zero-filled.  Each warp copies whole 512-byte (float32) row segments.  One
// loop for both operands: two slab_cp_async calls spill dw_gemm's registers.
template <typename T>
__device__ __forceinline__ void dw_load_slab(T* a_s, T* b_s, const T* __restrict__ a,
                                             const T* __restrict__ b, int c, int r0,
                                             int r_end, int i0, int j0) {
  constexpr int PER_ROW = GT / 4;
#pragma unroll
  for (int q = 0; q < GK * PER_ROW / GT_THREADS; ++q) {
    const int e = threadIdx.x + q * GT_THREADS;
    const int rr = e / PER_ROW, cc = (e % PER_ROW) * 4, r = r0 + rr;
    const bool a_ok = r < r_end && i0 + cc < c, b_ok = r < r_end && j0 + cc < c;
    const size_t row = r < r_end ? (size_t)r * c : 0;
    cp_async4(a_s + rr * GT + cc, a + (a_ok ? row + i0 + cc : 0), a_ok);
    cp_async4(b_s + rr * GT + cc, b + (b_ok ? row + j0 + cc : 0), b_ok);
  }
}

// out[blockIdx.z] = a[rows]^T @ b[rows], float32, over the rows of slice blockIdx.z:
// [z * slice_rows, min(n, (z + 1) * slice_rows)), one GT x GT tile of dw per CUDA
// block.  Both operands are row-major in the summed dimension, so their slabs go
// to shared memory by cp.async as they are, in a DW_STAGES-deep ring.
template <typename T>
__global__ void __launch_bounds__(GT_THREADS, 2) dw_gemm_kernel(
    const T* __restrict__ a, const T* __restrict__ b, int n, int c, int slice_rows,
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  T* a_s = reinterpret_cast<T*>(smem4);  // [DW_STAGES][GK][GT]
  T* b_s = a_s + DW_STAGES * TAP_SLAB;
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  const int r_begin = blockIdx.z * slice_rows;
  const int r_end = min(n, r_begin + slice_rows);
  const int slabs = (r_end - r_begin + GK - 1) / GK;
  const int ty = tile_ty(), tx = tile_tx();
  float acc[GRT][GRT];
  tile_zero(acc);
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < slabs) {
      dw_load_slab(a_s + s * TAP_SLAB, b_s + s * TAP_SLAB, a, b, c, r_begin + s * GK, r_end,
                   i0, j0);
    }
    cp_async_commit();
  }
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<DW_STAGES - 2>();  // this thread's copies of slab t have landed
    __syncthreads();                 // everyone's have, and slab t - 1 is consumed
    const int next = t + DW_STAGES - 1;
    if (next < slabs) {
      const int st = next % DW_STAGES;
      dw_load_slab(a_s + st * TAP_SLAB, b_s + st * TAP_SLAB, a, b, c, r_begin + next * GK,
                   r_end, i0, j0);
    }
    cp_async_commit();
    const T* as = a_s + (t % DW_STAGES) * TAP_SLAB;
    const T* bs = b_s + (t % DW_STAGES) * TAP_SLAB;
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      float af[GRT], bf[GRT];
      tile_frag(af, as + k * GT, ty * 4);
      tile_frag(bf, bs + k * GT, tx * 4);
      tile_fma(acc, af, bf);
    }
  }
  out += (size_t)blockIdx.z * c * c;
#pragma unroll
  for (int r = 0; r < GRT; ++r) {
    const int i = i0 + tile_row(ty, r);
    if (i >= c) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + tile_col(tx, h);
      if (j < c) {  // c % 4 == 0: a 4-column group is wholly in or out
        *reinterpret_cast<float4*>(out + (size_t)i * c + j) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
      }
    }
  }
}

// dw[k] = sum over slices s, in order, of part[s][k]: (slices, c * c) -> (c * c).
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
cudaError_t launch_dw_gemm(int n, int c, int slices, int slice_rows, const void* a,
                           const void* b, void* part, void* dw, cudaStream_t s) {
  const int tiles = (c + GT - 1) / GT;
  const size_t smem = 2 * sizeof(T) * DW_STAGES * TAP_SLAB;
  float* target = static_cast<float*>(slices == 1 ? dw : part);
  // Two CUDA blocks of 96 KB (float32) share an SM only with the whole carveout.
  cudaError_t err = cudaFuncSetAttribute(dw_gemm_kernel<T>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = launch_with_smem(dw_gemm_kernel<T>, dim3(tiles, tiles, slices), dim3(GT_THREADS),
                         smem, s, static_cast<const T*>(a), static_cast<const T*>(b), n, c,
                         slice_rows, target);
  if (err != cudaSuccess || slices == 1) return err;
  const size_t n4 = (size_t)c * c / 4;
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

size_t tile_smem(int c) { return sizeof(float) * (size_t)TM * c; }

dim3 row_tiles(int n) { return dim3((n + TM - 1) / TM); }

bool bad_shape(int n, int c) {
  return n <= 0 || c <= 0 || c % 4 != 0 || tile_smem(c) > kMaxSmem;
}

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

template <typename T>
cudaError_t conv_stats_t(int n, int c, int fw, int center, int slices, int k_slice,
                         const void* x3, const void* wa, const void* shift, void* u,
                         void* res, void* part1, void* part2, void* part, cudaStream_t s) {
  TapGemm<T> p{};
  p.a = cp<T>(x3);
  p.b = cp<T>(wa);
  p.m = n;
  p.k = fw * c;
  p.n = c;
  p.k_slice = k_slice;
  p.part = slices > 1 ? mp<float>(part) : nullptr;
  p.out = mp<T>(u);
  p.shift = cp<float>(shift);
  p.part1 = mp<float>(part1);
  p.part2 = mp<float>(part2);
  p.res = mp<T>(res);
  p.res_k0 = center * c;
  p.res_n = c;
  return launch_tap_gemm(p, slices, s);
}

template <typename T>
cudaError_t du_dtaps_res_t(int n, int c, int fw, int center, int slices, int k_slice,
                           const void* ga, const void* u, const void* g, const void* coef,
                           const void* wt, void* du, void* dx3, void* part, cudaStream_t s) {
  const size_t total = (size_t)n * c;
  const dim3 grid((unsigned)std::min<size_t>((total + NT - 1) / NT, 132 * 16));
  cudaError_t err = launch_with_smem(bn_grad_kernel<T>, grid, dim3(NT), 0, s, cp<T>(ga),
                                     cp<T>(u), cp<float>(coef), total, c, mp<T>(du));
  if (err != cudaSuccess) return err;
  TapGemm<T> p{};
  p.a = mp<T>(du);
  p.b = cp<T>(wt);
  p.m = n;
  p.k = c;
  p.n = fw * c;
  p.k_slice = k_slice;
  p.part = slices > 1 ? mp<float>(part) : nullptr;
  p.out = mp<T>(dx3);
  p.g = cp<T>(g);
  p.g_col0 = center * c;
  p.g_n = c;
  return launch_tap_gemm(p, slices, s);
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

int vp3d_tb_norm_drop_matmul_stats(int dtype, int n, int c, const void* u, const void* mask,
                                   const void* gate, const void* wb, const void* shift,
                                   void* d, void* v, void* part1, void* part2,
                                   void* stream) {
  if (bad_shape(n, c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_with_smem(norm_drop_matmul_stats_kernel<float>, row_tiles(n), dim3(NT),
                            tile_smem(c), s, cp<float>(u), cp<float>(mask), cp<float>(gate),
                            cp<float>(wb), cp<float>(shift), n, c, mp<float>(d),
                            mp<float>(v), mp<float>(part1), mp<float>(part2));
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(norm_drop_matmul_stats_kernel<B>, row_tiles(n), dim3(NT),
                            tile_smem(c), s, cp<B>(u), cp<B>(mask), cp<B>(gate), cp<B>(wb),
                            cp<float>(shift), n, c, mp<B>(d), mp<B>(v), mp<float>(part1),
                            mp<float>(part2));
  }
  return cudaErrorInvalidValue;
}

int vp3d_tb_norm_drop_res(int dtype, int n, int c, const void* v, const void* mask,
                          const void* gate, const void* res, void* out, void* stream) {
  if (bad_shape(n, c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)n * c;
  const dim3 grid((unsigned)std::min<size_t>((total + NT - 1) / NT, 132 * 16));
  if (dtype == 0) {
    return launch_with_smem(norm_drop_res_kernel<float>, grid, dim3(NT), 0, s, cp<float>(v),
                            cp<float>(mask), cp<float>(gate), cp<float>(res), total, c,
                            mp<float>(out));
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(norm_drop_res_kernel<B>, grid, dim3(NT), 0, s, cp<B>(v),
                            cp<B>(mask), cp<B>(gate), cp<B>(res), total, c, mp<B>(out));
  }
  return cudaErrorInvalidValue;
}

int vp3d_tb_relu_mask_bn_sums(int dtype, int n, int c, const void* g, const void* z,
                              const void* mask, const void* stat, const void* gate,
                              void* gz, void* part1, void* part2, void* stream) {
  if (bad_shape(n, c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + NT - 1) / NT, (n + SUM_ROWS - 1) / SUM_ROWS);
  if (dtype == 0) {
    return launch_with_smem(relu_mask_bn_sums_kernel<float>, grid, dim3(NT), 0, s,
                            cp<float>(g), cp<float>(z), cp<float>(mask), cp<float>(stat),
                            cp<float>(gate), n, c, mp<float>(gz), mp<float>(part1),
                            mp<float>(part2));
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(relu_mask_bn_sums_kernel<B>, grid, dim3(NT), 0, s, cp<B>(g),
                            cp<B>(z), cp<B>(mask), cp<float>(stat), cp<B>(gate), n, c,
                            mp<B>(gz), mp<float>(part1), mp<float>(part2));
  }
  return cudaErrorInvalidValue;
}

int vp3d_tb_dz_matmul_dd(int dtype, int n, int c, const void* gz, const void* z,
                         const void* coef, const void* wbt, void* dz, void* dd,
                         void* stream) {
  if (bad_shape(n, c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_with_smem(dz_matmul_dd_kernel<float>, row_tiles(n), dim3(NT),
                            tile_smem(c), s, cp<float>(gz), cp<float>(z), cp<float>(coef),
                            cp<float>(wbt), n, c, mp<float>(dz), mp<float>(dd));
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(dz_matmul_dd_kernel<B>, row_tiles(n), dim3(NT), tile_smem(c),
                            s, cp<B>(gz), cp<B>(z), cp<float>(coef), cp<B>(wbt), n, c,
                            mp<B>(dz), mp<B>(dd));
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

// dw (c, c) = a^T @ b over n rows, split into `slices` row slices of slice_rows rows
// (the last one ragged): with one slice the kernel writes dw itself; otherwise each
// slice writes its (c, c) partial into part (slices, c, c) and a second launch adds
// them up in slice order.  a and b must be 16-byte (float32) or 8-byte (bf16)
// aligned; every slice must hold at least one row.
int vp3d_tb_dw_gemm(int dtype, int n, int c, int slices, int slice_rows, const void* a,
                    const void* b, void* part, void* dw, void* stream) {
  if (bad_shape(n, c) || slices <= 0 || slice_rows <= 0 ||
      (long long)(slices - 1) * slice_rows >= n || (long long)slices * slice_rows < n ||
      slices > 65535 || (slices > 1 && part == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t align = dtype == 0 ? 16 : 8;
  if (reinterpret_cast<uintptr_t>(a) % align || reinterpret_cast<uintptr_t>(b) % align) {
    return cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dw_gemm<float>(n, c, slices, slice_rows, a, b, part, dw, s);
  if (dtype == 1) {
    return launch_dw_gemm<__nv_bfloat16>(n, c, slices, slice_rows, a, b, part, dw, s);
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

// Rows per partial-sum tile: kind 0 for the row-tile GEMM kernels, 1 for
// relu_mask_bn_sums, 2 for the tap GEMM (conv_stats).
int vp3d_tb_sum_rows(int kind) { return kind == 0 ? TM : kind == 1 ? SUM_ROWS : GT; }

// Dynamic shared memory of the row-tile kernels at c channels.
size_t vp3d_tb_smem_bytes(int c) { return tile_smem(c); }

}  // extern "C"
