// The fused streaming step's launch arguments, shared by the int8 step kernel
// (stream_int8.cu) and the bf16 step kernel (stream_bf16.cu).  Both are launched
// through vp3d_stream_step (streaming_fused.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace vp3d {

constexpr int kMaxBlocks = 8;   // residual blocks
constexpr int kMaxTaps = 8;     // older taps per block (filter width <= 9)
constexpr int kMaxFrames = 16;  // frames per step

struct BlockArgs {
  const void* wa;     // int8: (width, kp/4, np) packed int32; bf16: (width, c, c)
  const void* wb;     // int8: (kp/4, np) packed; bf16: (c, c)
  const float* v[5];  // int8: A1, B1, A2, B2, R; bf16: s1, t1, s2, t2
  void* ring;         // (cap, batch, c), or (2 * cap, batch, c) when doubled
  int width, cap, write;
  int slot[kMaxTaps];  // older taps' first ring rows, oldest first
  int lag[kMaxTaps];   // older taps' lags (width - 1 - j) * dilation, oldest first
};

struct StepArgs {
  int n_blocks, batch, c, k, doubled, j3;
  const void* x;      // block 0's input, (k, batch, c): int8 e, or f32 a0
  const __nv_bfloat16* ws;  // (c, j3)
  const float* bs;    // (j3,)
  float* out;         // (k * batch, j3), frame-major
  BlockArgs blk[kMaxBlocks];
  // The exchange buffer of the cluster's column slices: bf16, (2, k * batch, c) bf16
  // (h, then the last bf16(act)); int8, (k * batch, c) bf16 (the last bf16(v)), then
  // (k * batch, c) int8 (hq).  And the launch's plan, chosen in Python
  // (streaming_fused.py): rows per CUDA block (which pick the kernel's template
  // instance) and column slices per cluster.
  void* xbuf;
  int rows, slices;
  // Null, or the rings' positions on the card: the raw ring's, then one per residual
  // block.  With them a per-frame int8 step (k = 1, single rings) takes `write` and
  // every tap slot from its block's position and `lag`, not from the host's ints.
  const int* pos;
};

// Ring row (pos - lag) mod cap, never negative: the floor modulo of the host's slots
// (streaming._slots); pos and lag are below cap.
__host__ __device__ __forceinline__ int ring_slot(int pos, int lag, int cap) {
  const int s = (pos - lag) % cap;
  return s < 0 ? s + cap : s;
}

// int8 weights packed for the m16n8k32 B fragment (streaming_fused.pack_int8_step):
// (kp / 4, np) int32 with K zero-padded to a multiple of 32 and N to one of 8.
__host__ __device__ constexpr int packed_k(int c) { return (c + 31) / 32 * 32; }
__host__ __device__ constexpr int packed_n(int c) { return (c + 7) / 8 * 8; }

// The bf16 and int8 steps: each launches at the plan of `p`, or refuses one it
// cannot take with cudaErrorInvalidValue.
cudaError_t launch_stream_bf16(const StepArgs& p, cudaStream_t stream);
cudaError_t launch_stream_int8(const StepArgs& p, cudaStream_t stream);
// Dynamic shared memory of each step's smallest plan at c channels: c fits if
// this does.
size_t stream_bf16_min_smem(int c);
size_t stream_int8_min_smem(int c);

}  // namespace vp3d
