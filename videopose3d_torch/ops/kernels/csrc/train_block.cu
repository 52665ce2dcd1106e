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
// peak); tensor cores (wgmma) are later work.  Row-tile kernels stream the C x C
// weights from L2 once per 16-row tile (8 FLOP per weight byte) and keep the tile's A
// operand in shared memory.
//
// dw_gemm (dWb = d^T dz over the n rows) is a plain SGEMM with both operands
// row-major in the summed dimension, so no transpose is needed: a CUDA block of 256
// threads owns a 128 x 128 tile of dWb, each thread an 8 x 8 register tile (four
// FMAs per shared-memory float), and 32-row slabs of both operands flow through a
// 3-stage ring of shared memory filled by 16-byte cp.async copies, so the copies of
// slab s + 2 overlap the FMAs of slab s.  Two CUDA blocks (96 KB of shared memory
// and 128 registers a thread each) share an SM.  At C = 1,024 there are only 64
// tiles for 132 SMs, so the rows are split into slices (split-K, planned by the
// Python wrapper: 4 slices, 256 CUDA blocks, one wave); each slice writes a float32
// partial and dw_reduce adds the partials in slice order.  bf16 operands are staged
// as they are and widened when read from shared memory.
//
// The TPU grid runs in order, so the Pallas bodies carry the BatchNorm sums and dWb
// in VMEM scratch across grid steps.  CUDA blocks run in parallel, so each row tile
// writes its per-channel partial sums to an (n_tiles, C) buffer that stats_reduce
// adds up in tile order, and dWb's row slices are added up in slice order.  No
// float atomics: two runs give bitwise-equal results.  Partial row tiles, slabs and
// output tiles are masked, so any n and any C % 4 == 0 are taken.

#include <stdint.h>

#include <algorithm>

#include "tile_gemm.cuh"

namespace {

using namespace vp3d;

constexpr int SUM_ROWS = 64;   // rows per CUDA block of relu_mask_bn_sums
constexpr int DW_TILE = 128;   // dw_gemm output tile (DW_TILE x DW_TILE)
constexpr int DW_ROWS = 32;    // dw_gemm rows per shared-memory slab
constexpr int DW_STAGES = 3;   // slabs in the ring
constexpr int DW_RT = 8;       // dw_gemm register tile per thread (DW_RT x DW_RT)
constexpr int DW_THREADS = (DW_TILE / DW_RT) * (DW_TILE / DW_RT);

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

// u = x3 @ Wa (fw taps of C x C), cast to T; res = x3[:, center]; partial sums of
// (u - shift) and its square.
template <typename T>
__global__ void __launch_bounds__(NT, 1) conv_stats_kernel(
    const T* __restrict__ x3, const T* __restrict__ wa, const float* __restrict__ shift,
    int n, int c, int fw, int center, T* __restrict__ u, T* __restrict__ res,
    float* __restrict__ part1, float* __restrict__ part2) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  const int i0 = blockIdx.x * TM;
  const int rows = min(TM, n - i0);
  float acc[TM][CPT];
  for (int col0 = 0; col0 < c; col0 += NP) {
    zero(acc);
    for (int j = 0; j < fw; ++j) {
      __syncthreads();  // every thread is done with the previous tap's rows
      for (int r = 0; r < TM; ++r) {
        for (int k = threadIdx.x; k < c; k += NT) {
          float v = 0.f;
          if (r < rows) {
            const T raw = x3[((size_t)(i0 + r) * fw + j) * c + k];
            v = to_f<T>(raw);
            if (j == center && col0 == 0) res[(size_t)(i0 + r) * c + k] = raw;
          }
          a_s[r * c + k] = v;
        }
      }
      __syncthreads();
      gemm_tile<T>(acc, a_s, c, c, wa + (size_t)j * c * c, c, c, col0);
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = col0 + threadIdx.x + q * NT;
      if (col >= c) continue;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        acc[r][q] = round_to<T>(acc[r][q]);
        if (r < rows) u[(size_t)(i0 + r) * c + col] = from_f<T>(acc[r][q]);
      }
    }
    write_partials(acc, rows, c, col0, shift, part1, part2);
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

// du = the BatchNorm input gradient of ga (stored in T), then per tap
// dx3[:, j] = du @ Wa[j]^T cast to T, with the residual cotangent g added to the
// center tap in T; wat[j] is Wa[j] transposed.
template <typename T>
__global__ void __launch_bounds__(NT, 1) du_dtaps_res_kernel(
    const T* __restrict__ ga, const T* __restrict__ u, const T* __restrict__ g,
    const float* __restrict__ coef, const T* __restrict__ wat, int n, int c, int fw,
    int center, T* __restrict__ du, T* __restrict__ dx3) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  const int i0 = blockIdx.x * TM;
  const int rows = min(TM, n - i0);
  for (int r = 0; r < TM; ++r) {
    for (int k = threadIdx.x; k < c; k += NT) {
      float val = 0.f;
      if (r < rows) {
        const size_t i = (size_t)(i0 + r) * c + k;
        val = bn_input_grad<T>(to_f<T>(ga[i]), to_f<T>(u[i]), coef, c, k);
        du[i] = from_f<T>(val);
      }
      a_s[r * c + k] = val;
    }
  }
  __syncthreads();
  float acc[TM][CPT];
  for (int j = 0; j < fw; ++j) {
    for (int col0 = 0; col0 < c; col0 += NP) {
      zero(acc);
      gemm_tile<T>(acc, a_s, c, c, wat + (size_t)j * c * c, c, c, col0);
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = col0 + threadIdx.x + q * NT;
        if (col >= c) continue;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          if (r >= rows) continue;
          float val = round_to<T>(acc[r][q]);
          if (j == center) val = __fadd_rn(val, to_f<T>(g[(size_t)(i0 + r) * c + col]));
          dx3[((size_t)(i0 + r) * fw + j) * c + col] = from_f<T>(val);
        }
      }
    }
  }
}

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

// Starts the copy of rows [r0, min(r0 + DW_ROWS, r_end)) of a's columns i0.. and b's
// columns j0.. (DW_TILE each) into one slab of the ring; rows and columns outside
// are zero-filled.  Each warp copies whole 512-byte (float32) row segments.
template <typename T>
__device__ __forceinline__ void dw_load_slab(T* a_s, T* b_s, const T* __restrict__ a,
                                             const T* __restrict__ b, int c, int r0,
                                             int r_end, int i0, int j0) {
  constexpr int PER_ROW = DW_TILE / 4;
#pragma unroll
  for (int q = 0; q < DW_ROWS * PER_ROW / DW_THREADS; ++q) {
    const int e = threadIdx.x + q * DW_THREADS;
    const int rr = e / PER_ROW, cc = (e % PER_ROW) * 4, r = r0 + rr;
    const bool a_ok = r < r_end && i0 + cc < c, b_ok = r < r_end && j0 + cc < c;
    const size_t row = r < r_end ? (size_t)r * c : 0;
    cp_async4(a_s + rr * DW_TILE + cc, a + (a_ok ? row + i0 + cc : 0), a_ok);
    cp_async4(b_s + rr * DW_TILE + cc, b + (b_ok ? row + j0 + cc : 0), b_ok);
  }
}

// 8 values of one staged row as float32: elements base + 0..3 and base + 64 + 0..3,
// read as 16-byte (float32) or 8-byte (bf16) vectors.
template <typename T>
__device__ __forceinline__ void dw_frag(float (&f)[DW_RT], const T* row, int base) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const T* p = row + base + g * (DW_TILE / 2);
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

// out[blockIdx.z] = a[rows]^T @ b[rows], float32, over the rows of slice blockIdx.z:
// [z * slice_rows, min(n, (z + 1) * slice_rows)).  One DW_TILE x DW_TILE output tile
// per CUDA block of DW_THREADS; thread (ty, tx) owns rows ty * 4 + {0, 64} + 0..3 and
// columns tx * 4 + {0, 64} + 0..3, and a warp the 4 x 8 threads
// ty = 4 (warp / 2) + lane / 8, tx = 8 (warp % 2) + lane % 8, so that each fragment
// read of a warp is one 64-byte (a) or 128-byte (b) line of shared memory.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS, 2) dw_gemm_kernel(
    const T* __restrict__ a, const T* __restrict__ b, int n, int c, int slice_rows,
    float* __restrict__ out) {
  constexpr int SLAB = DW_ROWS * DW_TILE;
  extern __shared__ float4 smem4[];
  T* a_s = reinterpret_cast<T*>(smem4);  // [DW_STAGES][DW_ROWS][DW_TILE]
  T* b_s = a_s + DW_STAGES * SLAB;
  const int i0 = blockIdx.y * DW_TILE, j0 = blockIdx.x * DW_TILE;
  const int r_begin = blockIdx.z * slice_rows;
  const int r_end = min(n, r_begin + slice_rows);
  const int slabs = (r_end - r_begin + DW_ROWS - 1) / DW_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  float acc[DW_RT][DW_RT];
#pragma unroll
  for (int p = 0; p < DW_RT; ++p) {
#pragma unroll
    for (int q = 0; q < DW_RT; ++q) acc[p][q] = 0.f;
  }
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < slabs) {
      dw_load_slab(a_s + s * SLAB, b_s + s * SLAB, a, b, c, r_begin + s * DW_ROWS, r_end,
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
      dw_load_slab(a_s + st * SLAB, b_s + st * SLAB, a, b, c, r_begin + next * DW_ROWS,
                   r_end, i0, j0);
    }
    cp_async_commit();
    const T* as = a_s + (t % DW_STAGES) * SLAB;
    const T* bs = b_s + (t % DW_STAGES) * SLAB;
#pragma unroll
    for (int k = 0; k < DW_ROWS; ++k) {
      float af[DW_RT], bf[DW_RT];
      dw_frag(af, as + k * DW_TILE, ty * 4);
      dw_frag(bf, bs + k * DW_TILE, tx * 4);
      // Row p of the register tile left to right, row p + 1 right to left: each FMA
      // shares an operand with the one before (the register reuse cache).
#pragma unroll
      for (int p = 0; p < DW_RT; ++p) {
#pragma unroll
        for (int x = 0; x < DW_RT; ++x) {
          const int q = p % 2 ? DW_RT - 1 - x : x;
          acc[p][q] = fmaf(af[p], bf[q], acc[p][q]);
        }
      }
    }
  }
  out += (size_t)blockIdx.z * c * c;
#pragma unroll
  for (int p = 0; p < DW_RT; ++p) {
    const int i = i0 + ty * 4 + (p / 4) * (DW_TILE / 2) + p % 4;
    if (i >= c) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = j0 + tx * 4 + g * (DW_TILE / 2);
      if (j < c) {  // c % 4 == 0: a 4-column group is wholly in or out
        *reinterpret_cast<float4*>(out + (size_t)i * c + j) =
            make_float4(acc[p][4 * g], acc[p][4 * g + 1], acc[p][4 * g + 2],
                        acc[p][4 * g + 3]);
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
  const int tiles = (c + DW_TILE - 1) / DW_TILE;
  const size_t smem = 2 * sizeof(T) * DW_STAGES * DW_ROWS * DW_TILE;
  float* target = static_cast<float*>(slices == 1 ? dw : part);
  // Two CUDA blocks of 96 KB (float32) share an SM only with the whole carveout.
  cudaError_t err = cudaFuncSetAttribute(dw_gemm_kernel<T>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = launch_with_smem(dw_gemm_kernel<T>, dim3(tiles, tiles, slices), dim3(DW_THREADS),
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

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns cudaGetLastError()
// after the launch (0 on success).  dtype 0 = float32, 1 = bfloat16 for the T
// operands; BatchNorm statistics, shifts, coefficients, partial sums and dw are
// float32.  A null mask means no dropout.  Shapes are checked by the Python wrapper.

int vp3d_tb_conv_stats(int dtype, int n, int c, int fw, int center, const void* x3,
                       const void* wa, const void* shift, void* u, void* res, void* part1,
                       void* part2, void* stream) {
  if (bad_shape(n, c) || fw <= 0 || center < 0 || center >= fw) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_with_smem(conv_stats_kernel<float>, row_tiles(n), dim3(NT), tile_smem(c),
                            s, cp<float>(x3), cp<float>(wa), cp<float>(shift), n, c, fw,
                            center, mp<float>(u), mp<float>(res), mp<float>(part1),
                            mp<float>(part2));
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(conv_stats_kernel<B>, row_tiles(n), dim3(NT), tile_smem(c), s,
                            cp<B>(x3), cp<B>(wa), cp<float>(shift), n, c, fw, center,
                            mp<B>(u), mp<B>(res), mp<float>(part1), mp<float>(part2));
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

int vp3d_tb_du_dtaps_res(int dtype, int n, int c, int fw, int center, const void* ga,
                         const void* u, const void* g, const void* coef, const void* wat,
                         void* du, void* dx3, void* stream) {
  if (bad_shape(n, c) || fw <= 0 || center < 0 || center >= fw) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_with_smem(du_dtaps_res_kernel<float>, row_tiles(n), dim3(NT),
                            tile_smem(c), s, cp<float>(ga), cp<float>(u), cp<float>(g),
                            cp<float>(coef), cp<float>(wat), n, c, fw, center,
                            mp<float>(du), mp<float>(dx3));
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(du_dtaps_res_kernel<B>, row_tiles(n), dim3(NT), tile_smem(c), s,
                            cp<B>(ga), cp<B>(u), cp<B>(g), cp<float>(coef), cp<B>(wat), n,
                            c, fw, center, mp<B>(du), mp<B>(dx3));
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

// Rows per partial-sum tile: kind 0 for the GEMM kernels, 1 for relu_mask_bn_sums.
int vp3d_tb_sum_rows(int kind) { return kind == 0 ? TM : SUM_ROWS; }

// Dynamic shared memory of the row-tile kernels at c channels.
size_t vp3d_tb_smem_bytes(int c) { return tile_smem(c); }

}  // extern "C"
