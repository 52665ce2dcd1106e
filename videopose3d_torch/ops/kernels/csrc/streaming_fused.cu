// Entry points of the fused streaming step of the causal model, for Hopper
// (sm_90a): every residual block and the shrink projection for one frame (K5) or k
// frames (K6) of B independent streams in one launch, reading the older taps from
// per-block ring buffers and pushing each block's input into its ring in place; and
// the in-place ring push (K7).  The step kernels are in stream_int8.cu and
// stream_bf16.cu; this file holds the ring push and the entry points.
//
// Replaces the Pallas TPU kernel of videopose3d_tpu/streaming.py:
//   ring_push_kernel -> _ring_push_dma (_ring_push_dma_kernel)
// The step kernels take the frame count k and whether the rings are doubled as
// arguments: k = 1 with single rings is K5, k > 1 with doubled rings is K6.  Tap j
// of a block reads lag L_j = (width-1-j) * dilation frames back; the newest tap (L
// = 0) is the block's input itself.  The ring positions come from the host every
// step, by value in the launch's argument struct: `write` (k-aligned with doubled
// rings) and per tap its first slot `slot` (the ring row of frame 0's tap); or, for
// the per-frame int8 step, from an int array on the card (`pos`: the raw ring's
// position, then one per block), which ring_advance_kernel moves on by one frame
// after the step, so that a CUDA graph of the step replays for every frame.

#include <stdint.h>

#include "common.cuh"
#include "stream_step.cuh"

namespace {

using namespace vp3d;

// ---------------------------------------------------------------------------
// K7: one (B, C) row of n bytes into a (cap, B, C) ring at any byte offset.  Thread
// w owns the 16-byte-aligned word w of the destination's span.  A row of whole words
// between 16-byte aligned addresses (WORDS) is one 16-byte copy per thread; else a
// whole word whose source has the same alignment is one 16-byte copy, and the
// partial head and tail words and a row whose source is aligned otherwise are
// copied byte by byte.  The WORDS instance is kept for the aligned rows the rings
// hold: the general one copies them the same way but took 4 % longer on an H100 at
// (1,024, 1,024) bf16 (kernel_ab.py, PERF.md).  Bound by bytes: the row is read once
// and written once.
// ---------------------------------------------------------------------------

template <bool WORDS>
__global__ void ring_push_kernel(char* __restrict__ dst, const char* __restrict__ src,
                                 long long n) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (WORDS) {
    if (w * 16 < n) {
      reinterpret_cast<int4*>(dst)[w] = reinterpret_cast<const int4*>(src)[w];
    }
    return;
  }
  const long long head = (long long)(reinterpret_cast<uintptr_t>(dst) & 15);
  const long long lo = w * 16 - head;  // the word's first byte, relative to dst
  if (lo >= n) return;
  const bool same = ((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src)) &
                     15) == 0;
  if (same && lo >= 0 && lo + 16 <= n) {
    *reinterpret_cast<int4*>(dst + lo) = *reinterpret_cast<const int4*>(src + lo);
    return;
  }
  for (long long i = lo < 0 ? 0 : lo; i < lo + 16 && i < n; ++i) dst[i] = src[i];
}

// The rings' capacities, by value: the raw ring's, then one per residual block.
struct RingCaps {
  int n;
  int cap[kMaxBlocks + 1];
};

// Every ring's position on the card one frame on, modulo its capacity (each wraps at
// its own: a shared frame counter would wrap at the capacities' least common multiple).
__global__ void ring_advance_kernel(int* __restrict__ pos, const RingCaps caps) {
  const int i = threadIdx.x;
  if (i < caps.n) pos[i] = ring_slot(pos[i] + 1, 0, caps.cap[i]);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CUDA block of the step's smallest plan at c
// channels (c fits if this does); act_type 0 = int8, 1 = bf16.
size_t vp3d_stream_smem_bytes(int act_type, int channels) {
  return act_type == 0 ? stream_int8_min_smem(channels) : stream_bf16_min_smem(channels);
}

int vp3d_stream_max_blocks() { return kMaxBlocks; }
int vp3d_stream_max_taps() { return kMaxTaps; }

// Launches one fused streaming step at plan (rows, slices) on `stream`, with `xbuf`
// its exchange buffer (stream_step.cuh).  Per residual block, `ptrs` holds 8 device pointers (wa, wb, the
// 5 epilogue vectors, ring; bf16 takes 4 vectors) and `ints` 3 + 2 * kMaxTaps values
// (width, cap, write, slot[kMaxTaps], lag[kMaxTaps]), both host arrays.
// `pos` is null, or the rings' positions on the card (int8, k = 1, single rings only):
// the kernel then derives every slot from them and the lags, and not from `write` and
// `slot`.  Returns cudaGetLastError() after the launch (0 on success).  Shapes are
// checked and the plan chosen by the Python wrapper; this only refuses what would
// make the launch itself invalid, a plan the kernel cannot take included.
int vp3d_stream_step(int act_type, int n_blocks, int batch, int channels, int k,
                     int doubled, int rows, int slices, const void* x, const void* ws,
                     const void* bs, int j3, void* out, void* xbuf, const void* const* ptrs,
                     const int* ints, const void* pos, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || batch <= 0 || channels <= 0 || k < 1 ||
      k > kMaxFrames || j3 <= 0 || (act_type != 0 && act_type != 1) ||
      (pos != nullptr && (act_type != 0 || k != 1 || doubled))) {
    return cudaErrorInvalidValue;
  }
  StepArgs p{};
  p.n_blocks = n_blocks;
  p.batch = batch;
  p.c = channels;
  p.k = k;
  p.doubled = doubled;
  p.rows = rows;
  p.slices = slices;
  p.j3 = j3;
  p.x = x;
  p.ws = static_cast<const __nv_bfloat16*>(ws);
  p.bs = static_cast<const float*>(bs);
  p.out = static_cast<float*>(out);
  p.xbuf = xbuf;
  p.pos = static_cast<const int*>(pos);
  constexpr int kInts = 3 + 2 * kMaxTaps;
  for (int i = 0; i < n_blocks; ++i) {
    BlockArgs& bk = p.blk[i];
    const void* const* pp = ptrs + 8 * i;
    const int* ii = ints + kInts * i;
    bk.wa = pp[0];
    bk.wb = pp[1];
    for (int v = 0; v < 5; ++v) bk.v[v] = static_cast<const float*>(pp[2 + v]);
    bk.ring = const_cast<void*>(pp[7]);
    bk.width = ii[0];
    bk.cap = ii[1];
    bk.write = ii[2];
    if (bk.width < 1 || bk.width > kMaxTaps + 1 || bk.cap < 1) return cudaErrorInvalidValue;
    for (int j = 0; j < kMaxTaps; ++j) {
      bk.slot[j] = ii[3 + j];
      bk.lag[j] = ii[3 + kMaxTaps + j];
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act_type == 0 ? launch_stream_int8(p, s) : launch_stream_bf16(p, s);
}

// Copies n_bytes from `row` to `ring` + offset_bytes, any sizes and alignments, on
// `stream`.
int vp3d_ring_push(void* ring, const void* row, long long offset_bytes, long long n_bytes,
                   void* stream) {
  if (n_bytes <= 0 || offset_bytes < 0) return cudaErrorInvalidValue;
  char* dst = static_cast<char*>(ring) + offset_bytes;
  const char* src = static_cast<const char*>(row);
  const uintptr_t head = reinterpret_cast<uintptr_t>(dst) & 15;
  const long long words = ((long long)head + n_bytes + 15) / 16;
  const int threads = 256;
  const unsigned blocks = (unsigned)((words + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 && n_bytes % 16 == 0) {
    ring_push_kernel<true><<<blocks, threads, 0, s>>>(dst, src, n_bytes);
  } else {
    ring_push_kernel<false><<<blocks, threads, 0, s>>>(dst, src, n_bytes);
  }
  return cudaGetLastError();
}

// Moves the n rings' positions `pos` (int32, on the card) one frame on, modulo their
// capacities `caps` (a host array), on `stream`: the last node of the streaming
// lifter's graph.
int vp3d_ring_advance(void* pos, const int* caps, int n, void* stream) {
  if (pos == nullptr || n < 1 || n > kMaxBlocks + 1) return cudaErrorInvalidValue;
  RingCaps rc{};
  rc.n = n;
  for (int i = 0; i < n; ++i) {
    if (caps[i] < 1) return cudaErrorInvalidValue;
    rc.cap[i] = caps[i];
  }
  ring_advance_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int*>(pos),
                                                                      rc);
  return cudaGetLastError();
}

}  // extern "C"
