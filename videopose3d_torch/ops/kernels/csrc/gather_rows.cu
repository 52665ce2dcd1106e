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
// row; here each CUDA block copies one window with coalesced loads of the widest
// word (16, 8, 4 or 2 bytes) that divides the row strides, the window's byte span
// and both base addresses, and enough blocks are resident to hide the latency.
// With out_cols == cols a window is one contiguous span; otherwise each row's
// prefix is copied.  No DMA ring, sublane floor or lane pad is needed.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const char* __restrict__ flat, int rows, long long src_row_bytes,
    const int* __restrict__ row0, int window, int row_words, char* __restrict__ out) {
  const int b = blockIdx.x;
  int r0 = row0[b];
  r0 = r0 < 0 ? 0 : (r0 > rows - window ? rows - window : r0);
  const W* src = reinterpret_cast<const W*>(flat + (long long)r0 * src_row_bytes);
  W* dst = reinterpret_cast<W*>(out) + (size_t)b * window * row_words;
  const long long src_row_words = src_row_bytes / (long long)sizeof(W);
  const int total = window * row_words;
  if (src_row_words == row_words) {  // the whole window is one contiguous span
    for (int i = threadIdx.x; i < total; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / row_words;
      dst[i] = src[(long long)r * src_row_words + (i - r * row_words)];
    }
  }
}

template <typename W>
cudaError_t launch(const void* flat, int rows, long long src_row_bytes, const int* row0,
                   int batch, int window, int out_row_bytes, void* out,
                   cudaStream_t stream) {
  gather_kernel<W><<<batch, kThreads, 0, stream>>>(
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
  const int* r = static_cast<const int*>(row0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (divides(16, a, o, src_row_bytes, out_row_bytes)) {
    return launch<uint4>(flat, rows, src_row_bytes, r, batch, window, out_row_bytes, out, s);
  }
  if (divides(8, a, o, src_row_bytes, out_row_bytes)) {
    return launch<uint2>(flat, rows, src_row_bytes, r, batch, window, out_row_bytes, out, s);
  }
  if (divides(4, a, o, src_row_bytes, out_row_bytes)) {
    return launch<uint32_t>(flat, rows, src_row_bytes, r, batch, window, out_row_bytes,
                            out, s);
  }
  return launch<uint16_t>(flat, rows, src_row_bytes, r, batch, window, out_row_bytes, out,
                          s);
}

}  // extern "C"
