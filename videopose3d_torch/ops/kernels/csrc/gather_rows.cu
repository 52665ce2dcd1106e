// Row-window gather of the training batch assembly, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel videopose3d_tpu/ops/pallas/gather_rows.py
// (gather_windows, _gather_kernel): out[b] = flat[row0[b] : row0[b] + window, :out_cols]
// over a row-major (rows, cols) stream.  row0 is clamped to [0, rows - window], the
// dynamic_slice semantics the TPU kernel is bitwise-equal to, so no read leaves the
// stream.
//
// What bounds it on this card: pure data movement, 2 * B * window * out_cols * esize
// bytes (68 MB at B=1024, window=243, 34 float32 columns), against 3.35 TB/s of HBM.
// The TPU kernel keeps a ring of window DMAs in flight because one DMA moves one
// row.  Here, with out_cols == cols, a window is one contiguous span of bytes, and
// window_kernel copies its body with 16-byte loads and stores whatever the span's
// alignment: a 34-float32 row is 136 bytes, so a window's source starts at 0 or 8
// (mod 16) with the parity of row0 and its destination with the parity of b.  The
// head up to the first 16-byte boundary of the destination and the tail are copied
// element by element; where source and destination phases differ, each thread
// loads the aligned 16-byte source words and takes the next word's bytes from its
// neighbour lane (__shfl_down_sync), so every load and store stays a whole aligned
// 16-byte word inside the window.  Each thread keeps kUnroll independent loads in
// flight, and the grid is sized to the SMs, each CUDA block walking windows with a
// stride of the grid.  A column prefix (out_cols < cols) copies each row's prefix
// with the widest word that divides the strides and addresses (prefix_kernel).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;            // independent 16-byte loads per thread and pass
constexpr int kMaxBlocks = 132 * 8;   // 8 resident CUDA blocks on each of the 132 SMs
constexpr unsigned kFullMask = 0xffffffffu;

// The 16 bytes that start p bytes into lo: lo[p:16] ++ hi[0:p], p a multiple of 2.
template <int Q>
__device__ __forceinline__ uint4 funnel(const unsigned (&w)[8], int r) {
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], r), __funnelshift_r(w[Q + 1], w[Q + 2], r),
                    __funnelshift_r(w[Q + 2], w[Q + 3], r),
                    __funnelshift_r(w[Q + 3], w[Q + 4], r));
}

__device__ __forceinline__ uint4 shift16(uint4 lo, uint4 hi, int p) {
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int r = (p & 3) * 8;
  switch (p >> 2) {  // uniform over the window
    case 0: return funnel<0>(w, r);
    case 1: return funnel<1>(w, r);
    case 2: return funnel<2>(w, r);
    default: return funnel<3>(w, r);
  }
}

// Copies elements [begin, end) of E-sized words, one per thread in turn.
template <typename E>
__device__ __forceinline__ void copy_words(const char* src, char* dst, long long begin,
                                           long long end) {
  const E* s = reinterpret_cast<const E*>(src);
  E* d = reinterpret_cast<E*>(dst);
  for (long long j = begin / (long long)sizeof(E) + threadIdx.x; j < end / (long long)sizeof(E);
       j += kThreads) {
    d[j] = s[j];
  }
}

// dst[0:len] = src[0:len], both E-aligned, len a multiple of sizeof(E); the whole
// CUDA block takes part (the shuffles need every lane of every warp).
template <typename E>
__device__ __forceinline__ void copy_span(const char* src, char* dst, long long len) {
  // head [0, h): up to the destination's first 16-byte boundary, and one word more
  // where the phases differ, so that the aligned source words of the body all lie
  // past the window's first byte; body [h, h + 16 m); tail [h + 16 m, len).
  long long h = (16 - (long long)(reinterpret_cast<uintptr_t>(dst) % 16)) % 16;
  const int p = (int)((reinterpret_cast<uintptr_t>(src) + h) % 16);
  if (p) h += 16;
  // With p != 0 the body reads m + 1 aligned words, the last ending p bytes
  // before src + h + 16 (m + 1) <= src + len.
  long long m = len > h ? (len - h) / 16 - (p ? 1 : 0) : 0;
  if (m <= 0) {
    m = 0;
    h = len;
  }
  copy_words<E>(src, dst, 0, h);
  copy_words<E>(src, dst, h + 16 * m, len);
  uint4* d4 = reinterpret_cast<uint4*>(dst + h);
  const int lane = threadIdx.x % 32;
  if (p == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + h);
    for (long long base = 0; base < m; base += kThreads * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + threadIdx.x + u * kThreads;
        if (i < m) v[u] = s4[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + threadIdx.x + u * kThreads;
        if (i < m) d4[i] = v[u];
      }
    }
    return;
  }
  // Output word i = bytes p.. of aligned source word i, then bytes ..p of word i + 1,
  // which lane + 1 loaded (lane 31 loads it itself).
  const uint4* a4 = reinterpret_cast<const uint4*>(src + h - p);
  for (long long base = 0; base < m; base += kThreads * kUnroll) {
    uint4 lo[kUnroll], next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + threadIdx.x + u * kThreads;
      lo[u] = i <= m ? a4[i] : make_uint4(0, 0, 0, 0);
      next[u] = lane == 31 && i < m ? a4[i + 1] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + threadIdx.x + u * kThreads;
      uint4 hi;
      hi.x = __shfl_down_sync(kFullMask, lo[u].x, 1);
      hi.y = __shfl_down_sync(kFullMask, lo[u].y, 1);
      hi.z = __shfl_down_sync(kFullMask, lo[u].z, 1);
      hi.w = __shfl_down_sync(kFullMask, lo[u].w, 1);
      if (lane == 31) hi = next[u];
      if (i < m) d4[i] = shift16(lo[u], hi, p);
    }
  }
}

__device__ __forceinline__ int clamp_row(int r0, int rows, int window) {
  return r0 < 0 ? 0 : (r0 > rows - window ? rows - window : r0);
}

// out_cols == cols: each window one contiguous span; E is the element's word.
template <typename E>
__global__ void __launch_bounds__(kThreads) window_kernel(
    const char* __restrict__ flat, int rows, long long row_bytes,
    const int* __restrict__ row0, int batch, int window, char* __restrict__ out) {
  const long long span = (long long)window * row_bytes;
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const int r0 = clamp_row(row0[b], rows, window);
    copy_span<E>(flat + (long long)r0 * row_bytes, out + (long long)b * span, span);
  }
}

// out_cols < cols: the first out_row_words W-words of each row, one CUDA block per
// window.
template <typename W>
__global__ void __launch_bounds__(kThreads) prefix_kernel(
    const char* __restrict__ flat, int rows, long long src_row_bytes,
    const int* __restrict__ row0, int window, int row_words, char* __restrict__ out) {
  const int b = blockIdx.x;
  const int r0 = clamp_row(row0[b], rows, window);
  const W* src = reinterpret_cast<const W*>(flat + (long long)r0 * src_row_bytes);
  W* dst = reinterpret_cast<W*>(out) + (size_t)b * window * row_words;
  const long long src_row_words = src_row_bytes / (long long)sizeof(W);
  const int total = window * row_words;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / row_words;
    dst[i] = src[(long long)r * src_row_words + (i - r * row_words)];
  }
}

template <typename W>
cudaError_t launch_prefix(const void* flat, int rows, long long src_row_bytes,
                          const int* row0, int batch, int window, int out_row_bytes,
                          void* out, cudaStream_t stream) {
  prefix_kernel<W><<<batch, kThreads, 0, stream>>>(
      static_cast<const char*>(flat), rows, src_row_bytes, row0, window,
      out_row_bytes / (int)sizeof(W), static_cast<char*>(out));
  return cudaGetLastError();
}

bool divides(size_t w, uintptr_t a, uintptr_t b, long long c, long long d) {
  return a % w == 0 && b % w == 0 && c % (long long)w == 0 && d % (long long)w == 0;
}

}  // namespace

extern "C" {

// Launches the gather on `stream`: flat (rows, cols) of esize-byte elements,
// row0 (batch,) int32 on the device, out (batch, window, out_cols).  Returns
// cudaGetLastError() after the launch (0 on success).
int vp3d_gather_rows(const void* flat, int rows, int cols, int esize, const void* row0,
                     int batch, int window, int out_cols, void* out, void* stream) {
  if (batch <= 0 || window <= 0 || window > rows || out_cols <= 0 || out_cols > cols ||
      (esize != 2 && esize != 4)) {
    return cudaErrorInvalidValue;
  }
  const long long src_row_bytes = (long long)cols * esize;
  const int out_row_bytes = out_cols * esize;
  const uintptr_t a = reinterpret_cast<uintptr_t>(flat);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if (a % esize || o % esize) return cudaErrorMisalignedAddress;
  const int* r = static_cast<const int*>(row0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_cols == cols) {
    const int grid = batch < kMaxBlocks ? batch : kMaxBlocks;
    const char* f = static_cast<const char*>(flat);
    char* dst = static_cast<char*>(out);
    if (esize == 4) {
      window_kernel<uint32_t><<<grid, kThreads, 0, s>>>(f, rows, src_row_bytes, r, batch,
                                                         window, dst);
    } else {
      window_kernel<uint16_t><<<grid, kThreads, 0, s>>>(f, rows, src_row_bytes, r, batch,
                                                         window, dst);
    }
    return cudaGetLastError();
  }
  if (divides(16, a, o, src_row_bytes, out_row_bytes)) {
    return launch_prefix<uint4>(flat, rows, src_row_bytes, r, batch, window, out_row_bytes,
                                out, s);
  }
  if (divides(8, a, o, src_row_bytes, out_row_bytes)) {
    return launch_prefix<uint2>(flat, rows, src_row_bytes, r, batch, window, out_row_bytes,
                                out, s);
  }
  if (divides(4, a, o, src_row_bytes, out_row_bytes)) {
    return launch_prefix<uint32_t>(flat, rows, src_row_bytes, r, batch, window,
                                   out_row_bytes, out, s);
  }
  return launch_prefix<uint16_t>(flat, rows, src_row_bytes, r, batch, window, out_row_bytes,
                                 out, s);
}

}  // extern "C"
