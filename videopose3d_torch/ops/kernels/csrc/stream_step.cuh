// The fused streaming step's launch arguments, shared by the int8 step kernel
// (streaming_fused.cu) and the bf16 step kernel (stream_bf16.cu).  Both are
// launched through vp3d_stream_step (streaming_fused.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace vp3d {

constexpr int kMaxBlocks = 8;   // residual blocks
constexpr int kMaxTaps = 8;     // older taps per block (filter width <= 9)
constexpr int kMaxFrames = 16;  // frames per step

struct BlockArgs {
  const void* wa;     // int8: (width, c/4, c) dp4a-packed int32; bf16: (width, c, c)
  const void* wb;     // int8: (c/4, c) packed; bf16: (c, c)
  const float* v[5];  // int8: A1, B1, A2, B2, R; bf16: s1, t1, s2, t2
  void* ring;         // (cap, batch, c), or (2 * cap, batch, c) when doubled
  int width, cap, write;
  int lag[kMaxTaps];  // older taps, oldest first
  int slot[kMaxTaps];
};

struct StepArgs {
  int n_blocks, batch, c, k, doubled, j3;
  const void* x;      // block 0's input, (k, batch, c): int8 e, or f32 a0
  const __nv_bfloat16* ws;  // (c, j3)
  const float* bs;    // (j3,)
  float* out;         // (k * batch, j3), frame-major
  BlockArgs blk[kMaxBlocks];
  // bf16 only: the (2, k * batch, c) exchange buffer (h, then the last bf16(act)),
  // and the launch's column slices per cluster (its rows per CUDA block are the
  // kernel's template argument).
  __nv_bfloat16* xbuf;
  int slices;
};

// The bf16 step (stream_bf16.cu): launches it with its plan, or the forced one.
cudaError_t launch_stream_bf16(StepArgs& p, cudaStream_t stream);
// Dynamic shared memory of the bf16 step's smallest plan at c channels: c fits if
// this does.
size_t stream_bf16_min_smem(int c);

}  // namespace vp3d
