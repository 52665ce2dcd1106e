// Shared pieces of the w8a8 int8 kernels: the dp4a row-tile GEMM with exact int32
// sums and the per-row dynamic requantization of h in the IEEE operation order of
// the plain PyTorch versions (temporal_block_int8.cu), and the int8 stream's
// rounding and scale constants (also stream_int8.cu).
//
// gemm_i8: a CUDA block of NT=256 threads owns TM=16 rows of int8 A (in shared
// memory) and up to NP=1024 output columns per pass; each thread owns CPT=4 columns
// (col0 + tid + q*256).  The weights are dp4a-packed (K/4, N) int32, so a warp's
// weight load is one 128-byte line, and the rows of A are read as 16-byte broadcasts.

#pragma once

#include <stdint.h>

#include "tile_gemm.cuh"

namespace vp3d {

constexpr float kQmax = 127.0f;
constexpr float kInvQmax = static_cast<float>(1.0 / 127.0);  // torch's f32(1.0 / QMAX)
constexpr int kWarps = NT / 32;

__device__ __forceinline__ void zero_i(int (&acc)[TM][CPT]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[r][q] = 0;
  }
}

// Loads 4 packed weight groups g..g+3 of this thread's columns (16 int8 of K).
__device__ __forceinline__ void load_wp(int (&w)[4][CPT], const int* __restrict__ W, int n,
                                        int g, const int (&col)[CPT]) {
#pragma unroll
  for (int gg = 0; gg < 4; ++gg) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      w[gg][q] = col[q] < n ? __ldg(W + (size_t)(g + gg) * n + col[q]) : 0;
    }
  }
}

// acc[r][q] += sum_{k < K} A[r * lda + k] * Wk[col0 + tid + q*NT], exact in int32.
// A: TM rows of int8 in shared memory, 16-byte aligned, lda % 16 == 0, K % 16 == 0.
// W: dp4a-packed (K/4, n) int32.  Columns at or past n contribute nothing.
__device__ __forceinline__ void gemm_i8(int (&acc)[TM][CPT], const int8_t* A, int lda,
                                        int K, const int* __restrict__ W, int n,
                                        int col0) {
  int col[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) col[q] = col0 + threadIdx.x + q * NT;
  int w[4][CPT];
  load_wp(w, W, n, 0, col);
  for (int k = 0; k < K; k += 16) {
    int cur[4][CPT];
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
#pragma unroll
      for (int q = 0; q < CPT; ++q) cur[gg][q] = w[gg][q];
    }
    if (k + 16 < K) load_wp(w, W, n, (k + 16) / 4, col);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int4 a = *reinterpret_cast<const int4*>(A + r * lda + k);
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        int s = acc[r][q];
        s = __dp4a(a.x, cur[0][q], s);
        s = __dp4a(a.y, cur[1][q], s);
        s = __dp4a(a.z, cur[2][q], s);
        s = __dp4a(a.w, cur[3][q], s);
        acc[r][q] = s;
      }
    }
  }
}

// clip(rint(v), 0, 127) as int8: the int8 stream's rounding (half to even, as torch.round).
__device__ __forceinline__ int8_t to_stream(float v) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(v), 0.f), kQmax)));
}

// Per-row dynamic requantization of the TM x c tile real_s (float, >= 0), given each
// thread's maxima rmax[TM] over its own columns:
//   m = max(max over all c columns, 1);  inv_s[r] = 127 / m (IEEE division);
//   rs_s[r] = m * (1/127);               hq_s = rint(real_s * inv_s[r]) as int8.
// red_s holds kWarps * TM floats of per-warp maxima.  Every thread of the block
// calls it; it ends with a barrier, so hq_s, inv_s and rs_s are then visible to all.
__device__ __forceinline__ void requantize_rows(const float (&rmax)[TM], const float* real_s,
                                                int8_t* hq_s, float* inv_s, float* rs_s,
                                                float* red_s, int c) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float v = rmax[r];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
    if (lane == 0) red_s[warp * TM + r] = v;
  }
  __syncthreads();
  if (tid < TM) {
    float m = red_s[tid];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_s[w * TM + tid]);
    m = fmaxf(m, 1.f);
    inv_s[tid] = __fdiv_rn(kQmax, m);
    rs_s[tid] = __fmul_rn(m, kInvQmax);
  }
  __syncthreads();
  for (int i = tid; i < TM * c; i += NT) {
    hq_s[i] = static_cast<int8_t>(static_cast<int>(rintf(__fmul_rn(real_s[i], inv_s[i / c]))));
  }
  __syncthreads();
}

}  // namespace vp3d
