// w8a8 int8 serving stages of the dilated model, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of videopose3d_tpu/ops/pallas/temporal_block_int8.py:
//   kExpand -> int8_expand_block   (_expand_block_i8_kernel, launched at :603)
//   kMid    -> int8_dilated_block  (_mid_block_i8_kernel, launched by _mid_block_i8 at :492)
//   kShrink -> int8_shrink_block   (_shrink_block_i8_kernel, launched at :669)
// and, as the accshift tap mode of all three, tools/exp_realign.py's _mid_block_psum
// (launched at :122).  expand_kernel also serves the streaming front (F,
// vp3d_stream_front), which replaces no TPU kernel: videopose3d_tpu/streaming.py's
// stream_step_int8_fused (:535-540) leaves the raw ring push and the expand to XLA.
// F reads its taps from the raw ring at a position on the card, so that the
// per-frame int8 streaming step replays as one CUDA graph (streaming.py); its bound
// is the float64 FMAs, 2 * B * 102 * C (6.3 us at B = C = 1,024 on 34 TFLOP/s).
//
// One stage, for output row t of batch row b (x an int8 stream in 0..127):
//   acc  = sum_j x[t + j*d] @ Wa_j                     exact int32
//   real = relu(float(acc) * A1 + B1)
//   m    = max(max over all C columns of real, 1)       per-row dynamic requantization
//   hq   = rint(real * (127 / m))                        int8 in 0..127
//   y    = relu(float(hq @ Wb) * (m * (1/127)) * A2 + B2)
//   v    = float(x[t + res_offset]) * R + y
//   out  = clip(rint(v), 0, 127) as int8 (kMid, kExpand), or for kShrink
//          bf16(v) @ Ws + bs in float32.
// kExpand first makes its int8 input from the pre-tapped bf16 keypoints:
//   e = clip(rint(relu(float(raw @ W0) * s0 + b0)), 0, 127), the dot summed in float64.
// Every float step is one IEEE operation with one rounding (__fmul_rn / __fadd_rn,
// which the compiler does not contract into FMAs; __fdiv_rn; rintf rounds half to
// even, as torch.round), in the order of the plain PyTorch versions, so the int8
// streams equal theirs bit for bit.  The expand dot's bf16 products are exact and
// their float64 sum is rounded once to float32 by both versions.
//
// What bounds it on this card: the int8 products, 2 * C * C * (k + 1) per output row,
// on the int8 tensor cores (1,979 dense TOP/s).  vp3d_int8_block, one host call per
// stage, enqueues the stage as a chain of launches over M = B * T_out rows:
//   (kExpand) expand_kernel: e once per input row, (B, T_e, C) int8, float64 FMAs on
//       the CUDA cores over 64 x 64 output tiles;
//   the tap GEMM: acc on mma.sync m16n8k32 (int8 x int8, int32 sums; tc_tile.cuh's
//       128 x 128 tile: stream_tc.cuh's I8Mma, a 4-stage cp.async ring, ldmatrix),
//       its epilogue writing real (float32, 18.3 MB at M = 4,468, C = 1,024, within
//       the 50 MB L2) and each row's maximum over the tile's 128 columns into a
//       (ceil(C/128), M) buffer;
//   requant_kernel: m, 127/m and m * (1/127) once per row, then hq (M, C) int8, a
//       byte-bound pass (5.5-7.5 us; requantizing in the 1x1's A loads instead, which
//       read real's 4 bytes per value for each of its column tiles, made the stage
//       16-25 % slower on an H100: PERF.md);
//   the 1x1 GEMM hq @ Wb on the same tile, its epilogue y, the residual read in
//       place, and the int8 stream (kShrink: bf16(v), (M, C));
//   (kShrink) the projection on K3's bf16 GEMM (temporal_block.cu, k3_project_bf16),
//       float32 sums plus the bias.
// Row i of a GEMM is frame t = i % T_out of batch row b = i / T_out, and its tap j
// reads input row t + j * d of batch row b in place: the taps are never
// materialised.  Where the tiles leave a ragged last wave, the summed dimension is
// split into slices of the rows the caller plans (temporal_block_int8.int8_plan's
// wave count); the slices write int32 partials that i8_reduce_kernel adds, exact in any
// order, before the epilogue.  Nothing is held per channel in shared memory, so any
// C runs (a multiple of 16: int8 rows are copied in 16-byte words, and the model
// pads other widths with zero channels once).
//
// accshift: a tap whose offset j*d is not a multiple of 32 is multiplied over the
// 32-aligned window of each batch row, rows [j*d & ~31, + T_out + 32) (zeros past
// the input), into int32 partials: one GEMM over these taps, split at the tap
// boundaries, each slice's sums kept; the tap GEMM of the aligned taps adds rows
// [j*d & 31, + T_out) of each before its epilogue.  Integer sums
// commute, so both modes give the same bits; the extra rows (32 per batch row and
// shifted tap) are the mode's own cost.  The TPU form also converts the residual
// over the aligned window before slicing it; the convert is elementwise, so both
// modes read the residual row directly here.

#include <stdint.h>

#include <algorithm>
#include <climits>
#include <cstring>

#include "common.cuh"
#include "int8_quant.cuh"
#include "tc_tile.cuh"

namespace vp3d {
cudaError_t k3_project_bf16(const bf16* a, int m, int k, const bf16* w, int n,
                            const float* bias, int k_slice, float* part,
                            long long part_floats, float* out, cudaStream_t stream);
}  // namespace vp3d

namespace {

using namespace vp3d;

enum Variant { kMid = 0, kExpand = 1, kShrink = 2 };
enum Epilogue { kReal = 0, kResidual = 1 };

constexpr int kAlign = 32;     // accshift window alignment
constexpr int kMaxTerms = 16;  // taps of one GEMM

using IGeo = Geo<I8Mma, kTile>;

// One int8 GEMM of a stage's chain: (m x k) @ (k x n) with exact int32 sums.
struct I8Gemm {
  // Row i = (b, u), u = i % rows, reads term s's input row u + a_off[s] of batch row b
  // at a + (b * a_rows + u + a_off[s]) * lda (zero at or past a_rows), kc int8 per
  // term; k = terms * kc.
  const int8_t* a;
  int lda, kc, a_rows, rows, terms;
  int a_off[kMaxTerms];
  int w_tap[kMaxTerms];  // the tap of the packed weights term s multiplies
  const int* w;          // (taps, w_rows, n) int32, pack_int8_step of each tap
  int w_rows;
  int m, k, n, k_slice;
  int* part;  // int32 (slices, m, n) of a split or of the accshift taps, or null
  int epi;
  const float* scale;  // kReal: A1, kResidual: A2
  const float* shift;  // B1, B2
  // kReal: adds the accshift taps' partials, n_shift (B, rows + kAlign, n) int32
  // buffers at `shifted`, row u + shift_off[s]; writes real to out (float32) and
  // the row maxima of each 128-column tile to rmax (ceil(n / 128), m).
  const int* shifted;
  int n_shift;
  int shift_off[kMaxTerms];
  float* rmax;
  // kResidual: y with the row scales rs (m), the residual row (b, u + res_off) of
  // res (res_rows per batch row, n wide) times r; out int8, or bf16 where `shrink`.
  const float* rs;
  const float* r;
  const int8_t* res;
  int res_rows, res_off, shrink;
  void* out;
};

// N consecutive 4-byte values (N = 2 or 4) as one 8- or 16-byte access; `p` aligned.
template <int N, typename T>
__device__ __forceinline__ void load_n(T (&v)[N], const T* p) {
  static_assert(sizeof(T) == 4 && (N == 2 || N == 4), "4-byte values, 2 or 4");
  if constexpr (N == 4) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    memcpy(v, &w, 16);
  } else {
    const int2 w = *reinterpret_cast<const int2*>(p);
    memcpy(v, &w, 8);
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_n(T* p, const T (&v)[N]) {
  static_assert(sizeof(T) == 4 && (N == 2 || N == 4), "4-byte values, 2 or 4");
  if constexpr (N == 4) {
    int4 w;
    memcpy(&w, v, 16);
    *reinterpret_cast<int4*>(p) = w;
  } else {
    int2 w;
    memcpy(&w, v, 8);
    *reinterpret_cast<int2*>(p) = w;
  }
}

// The kReal epilogue of N consecutive columns col.. of row i (i < m, col < n,
// n % 16 == 0); returns the largest of their real values.
template <int N>
__device__ __forceinline__ float real_store(const I8Gemm& p, int i, int col, int (&v)[N]) {
  const int b = i / p.rows;
  const int u = i - b * p.rows;
  for (int s = 0; s < p.n_shift; ++s) {
    const size_t window_row = ((size_t)s * (p.m / p.rows) + b) * (p.rows + kAlign);
    int w[N];
    load_n<N>(w, p.shifted + (window_row + u + p.shift_off[s]) * p.n + col);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] += w[e];
  }
  float a[N], sh[N], x[N];
  load_n<N>(a, p.scale + col);
  load_n<N>(sh, p.shift + col);
  float mx = 0.f;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    x[e] = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(v[e]), a[e]), sh[e]), 0.f);
    mx = fmaxf(mx, x[e]);
  }
  store_n<N>(static_cast<float*>(p.out) + (size_t)i * p.n + col, x);
  return mx;
}

// The kResidual epilogue of N consecutive columns col.. of row i.
template <int N>
__device__ __forceinline__ void residual_store(const I8Gemm& p, int i, int col,
                                               const int (&v)[N]) {
  const int b = i / p.rows;
  const int u = i - b * p.rows;
  const float rs = p.rs[i];
  const int8_t* res = p.res + ((size_t)b * p.res_rows + u + p.res_off) * p.n + col;
  float a[N], sh[N], r[N], x[N];
  load_n<N>(a, p.scale + col);
  load_n<N>(sh, p.shift + col);
  load_n<N>(r, p.r + col);
  // The N int8 residual values as one 2- or 4-byte load.
  int8_t rv[N];
  if constexpr (N == 4) {
    *reinterpret_cast<char4*>(rv) = *reinterpret_cast<const char4*>(res);
  } else {
    *reinterpret_cast<char2*>(rv) = *reinterpret_cast<const char2*>(res);
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float y =
        fmaxf(__fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v[e]), rs), a[e]), sh[e]), 0.f);
    x[e] = __fadd_rn(__fmul_rn(static_cast<float>(rv[e]), r[e]), y);
  }
  const size_t at = (size_t)i * p.n + col;
  if (p.shrink) {
    bf16* o = static_cast<bf16*>(p.out) + at;
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = from_f<bf16>(x[e]);
  } else {
    int8_t q[N];
#pragma unroll
    for (int e = 0; e < N; ++e) q[e] = to_stream(x[e]);
    int8_t* o = static_cast<int8_t*>(p.out) + at;
    if constexpr (N == 4) {
      *reinterpret_cast<char4*>(o) = *reinterpret_cast<const char4*>(q);
    } else {
      *reinterpret_cast<char2*>(o) = *reinterpret_cast<const char2*>(q);
    }
  }
}

// One 128 x 128 tile of an int8 GEMM (blockIdx.x: column tile, blockIdx.y: row tile)
// over the summed columns of slice blockIdx.z, on mma.sync m16n8k32: both operands by
// 16-byte cp.async through tc_tile.cuh's ring, A rows read in place through the row
// map, B rows from the packed weights of each column's tap.
__global__ void __launch_bounds__(NT, 2) i8_mma_kernel(const __grid_constant__ I8Gemm p) {
  using G = IGeo;
  extern __shared__ float4 smem4[];
  char* stages = reinterpret_cast<char*>(smem4);
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int k_begin = blockIdx.z * p.k_slice;
  const int k_end = min(p.k, k_begin + p.k_slice);
  const int q_n = (k_end - k_begin + G::BK - 1) / G::BK;
  // This thread's 16-byte copies of a stage: A rows ar and ar + 64, chunk ac (16 int8)
  // of the 64 K values; packed B rows br and br + 8 (4 K values each), chunk bc (4
  // columns) of the 128.
  const int ac = threadIdx.x % 4, ar = threadIdx.x / 4;
  const int bc = threadIdx.x % 32, br = threadIdx.x / 32;
  size_t base[2];
  int u_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + ar + 64 * h;
    const int b = i / p.rows;
    u_row[h] = i < p.m ? i - b * p.rows : INT_MAX / 2;  // rows past m read as zero
    base[h] = (size_t)b * p.a_rows;
  }
  const int col = j0 + bc * 4;
  int kk = k_begin + ac * 16, kb = k_begin + 4 * br;
  TapPos pa, pb[2];
  pa.start(kk, p.kc);
  pb[0].start(kb, p.kc);
  pb[1].start(kb + 32, p.kc);
  auto load = [&](char* stage) {
    int8_t* as = reinterpret_cast<int8_t*>(stage);
    int* bs = reinterpret_cast<int*>(stage + G::A_BYTES);
    const int j = min(pa.j, p.terms - 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = u_row[h] + p.a_off[j];
      const bool ok = kk < k_end && t < p.a_rows;
      const int8_t* src = ok ? p.a + (base[h] + t) * p.lda + pa.kin : p.a;
      cp_async16(as + (ar + 64 * h) * G::LDA + ac * 16, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = col < p.n && kb + 32 * h < k_end;
      const int* src =
          ok ? p.w + ((size_t)p.w_tap[min(pb[h].j, p.terms - 1)] * p.w_rows + pb[h].kin / 4) *
                         p.n + col
             : p.w;
      cp_async16(bs + (br + 8 * h) * G::LDB + bc * 4, src, ok ? 16 : 0);
    }
    kk += G::BK;
    kb += G::BK;
    pa.step(G::BK, p.kc);
    pb[0].step(G::BK, p.kc);
    pb[1].step(G::BK, p.kc);
  };
  int acc[G::MT][G::NT8][4];
  tile_mma_loop<I8Mma, G>(acc, stages, q_n, load);
  // The m16n8 accumulator layout: acc[mt][nt][2 hh + e] is row lane / 4 + 8 hh of
  // m16 tile mt, column 2 (lane % 4) + e of n8 tile nt.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / G::WARPS_N, wn = warp - wm * G::WARPS_N;
  if (p.part != nullptr) {
    int* part = p.part + (size_t)blockIdx.z * p.m * p.n;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT8; ++nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = i0 + wm * G::WM + mt * 16 + (lane >> 2) + hh * 8;
          const int j = j0 + wn * G::WN + nt * 8 + 2 * (lane & 3);
          if (i < p.m && j < p.n) {
            *reinterpret_cast<int2*>(part + (size_t)i * p.n + j) =
                make_int2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
          }
        }
      }
    }
    return;
  }
  float rmax[G::MT][2];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rmax[mt][hh] = 0.f;
      const int i = i0 + wm * G::WM + mt * 16 + (lane >> 2) + hh * 8;
#pragma unroll
      for (int nt = 0; nt < G::NT8; ++nt) {
        const int j = j0 + wn * G::WN + nt * 8 + 2 * (lane & 3);
        if (i >= p.m || j >= p.n) continue;
        int v[2] = {acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]};
        if (p.epi == kReal) {
          rmax[mt][hh] = fmaxf(rmax[mt][hh], real_store<2>(p, i, j, v));
        } else {
          residual_store<2>(p, i, j, v);
        }
      }
    }
  }
  if (p.epi != kReal) return;
  // Each row's maximum over the tile's columns: the 4 lanes of a row, then the
  // WARPS_N warps of its 128 columns through shared memory (the ring is free).
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem4);  // [WARPS_N][kTile]
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = rmax[mt][hh];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if ((lane & 3) == 0) red[wn * kTile + wm * G::WM + mt * 16 + (lane >> 2) + hh * 8] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kTile && i0 + threadIdx.x < p.m) {
    float v = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < G::WARPS_N; ++w) v = fmaxf(v, red[w * kTile + threadIdx.x]);
    p.rmax[(size_t)blockIdx.x * p.m + i0 + threadIdx.x] = v;
  }
}

// The split form's second launch: each warp owns one row's 128-column tile, each lane
// 4 of its columns; it adds the slices' int32 partials, then runs the epilogue (and,
// for kReal, writes the tile's row maximum).
template <int EPI>
__global__ void __launch_bounds__(NT) i8_reduce_kernel(const __grid_constant__ I8Gemm p,
                                                       int slices) {
  const int tiles_n = (p.n + kTile - 1) / kTile;
  const long long warps = (long long)p.m * tiles_n;
  const long long stride = (long long)gridDim.x * (NT / 32);
  const int lane = threadIdx.x & 31;
  const size_t slice = (size_t)p.m * p.n;
  for (long long w = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5); w < warps;
       w += stride) {
    const int i = (int)(w / tiles_n);
    const int tile = (int)(w - (long long)i * tiles_n);
    const int col = tile * kTile + lane * 4;
    float mx = 0.f;
    if (col < p.n) {
      const int* src = p.part + (size_t)i * p.n + col;
      int4 s = *reinterpret_cast<const int4*>(src);
      for (int z = 1; z < slices; ++z) {
        const int4 v = *reinterpret_cast<const int4*>(src + z * slice);
        s = make_int4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      int v[4] = {s.x, s.y, s.z, s.w};
      if constexpr (EPI == kReal) {
        mx = real_store<4>(p, i, col, v);
      } else {
        residual_store<4>(p, i, col, v);
      }
    }
    if constexpr (EPI == kReal) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) p.rmax[(size_t)tile * p.m + i] = mx;
    }
  }
}

// Per row i: m = max(the row maxima of its column tiles, 1); rs[i] = m * (1/127);
// hq = rint(real * (127 / m)) as int8 (real >= 0, so 0..127).  One warp per row, 16
// columns a lane at a time (n % 16 == 0).
__global__ void __launch_bounds__(NT) requant_kernel(const float* __restrict__ real,
                                                     const float* __restrict__ rmax, int m,
                                                     int n, float* __restrict__ rs,
                                                     int8_t* __restrict__ hq) {
  const int tiles_n = (n + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * (NT / 32) + (threadIdx.x >> 5); i < m; i += gridDim.x * (NT / 32)) {
    float mx = 0.f;
    for (int t = lane; t < tiles_n; t += 32) mx = fmaxf(mx, rmax[(size_t)t * m + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mx = fmaxf(mx, 1.f);
    const float inv = __fdiv_rn(kQmax, mx);
    if (lane == 0) rs[i] = __fmul_rn(mx, kInvQmax);
    const float4* src = reinterpret_cast<const float4*>(real + (size_t)i * n);
    int4* dst = reinterpret_cast<int4*>(hq + (size_t)i * n);
    for (int g = lane; g < n / 16; g += 32) {
      uint32_t words[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = src[4 * g + q];
        const float f[4] = {v.x, v.y, v.z, v.w};
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          word |= (uint32_t)(uint8_t)(int)rintf(__fmul_rn(f[e], inv)) << (8 * e);
        }
        words[q] = word;
      }
      dst[g] = make_int4((int)words[0], (int)words[1], (int)words[2], (int)words[3]);
    }
  }
}

// Where expand_kernel reads row r's summed column k (of k_in) of its A operand.
// K4's: the pre-tapped bf16 keypoints, (rows, k_in).
struct PreTapped {
  const bf16* raw;
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void push(int, int) const {}
  __device__ __forceinline__ float operator()(int r, int k, int k_in) const {
    return __bfloat162float(raw[(size_t)r * k_in + k]);
  }
};

// The streaming front's (F): the expand conv's taps of B streams, the older frames
// from the raw ring at its position on the card, oldest first, then this dispatch's
// float32 frame rounded to bf16.  The raw ring holds the conv's `cap` taps, so tap j
// lags cap - 1 - j frames, and the frame's own row (lag 0) is the one `push` writes.
struct FrontTaps {
  const float* frame;  // (rows, c_in)
  bf16* ring;          // (cap, rows, c_in)
  const int* pos;      // the raw ring's position
  int rows, c_in, cap;
  int at;  // *pos, read once at the start
  __device__ __forceinline__ void start() { at = *pos; }
  // Rows [r0, r0 + n) of the frame into the ring's row `at`, rounded to bf16.  The
  // taps read the other cap - 1 rows, so no block reads what another writes.
  __device__ __forceinline__ void push(int r0, int n) const {
    bf16* dst = ring + ((size_t)at * rows + r0) * c_in;
    const float* src = frame + (size_t)r0 * c_in;
    for (int i = threadIdx.x; i < n * c_in; i += NT) dst[i] = __float2bfloat16(src[i]);
  }
  __device__ __forceinline__ float operator()(int r, int k, int) const {
    const int j = k / c_in, ch = k - j * c_in;
    if (j == cap - 1) return round_to<bf16>(frame[(size_t)r * c_in + ch]);
    // Ring row (at - lag) mod cap with lag = cap - 1 - j: at + 1 + j < 2 * cap.
    const int s = at + 1 + j;
    return __bfloat162float(ring[((size_t)(s < cap ? s : s - cap) * rows + r) * c_in + ch]);
  }
};

// e (rows, c) int8 of the bf16 taps `src` gives (rows, k_in) and w0 (k_in, c):
// clip(rint(relu(float(sum_k raw * w0) * s0 + b0)), 0, 127), the sum in float64 FMAs.
// A CUDA block owns 64 rows x 64 columns: warp w rows 16 (w % 4) .., columns
// 32 (w / 4) .., and each lane 4 consecutive rows (4 (lane % 4) ..) by 4 consecutive
// columns (4 (lane / 4) ..) of its warp's.  The operands are staged as float64 in
// equal chunks of kek <= kEK summed columns (k_in = 102 of the Human3.6M model: 3 of
// 34), A transposed, so that per summed column a lane reads its 4 A and 4 W values
// as four 16-byte words, for 16 FMAs.  The blocks of the first column tile also
// `push` their rows (the streaming front's ring write).  Any c: where c % 4 == 0 a
// lane stores its 4 columns of a row as one word, else byte by byte.
constexpr int kER = 64, kEC = 64, kEK = 40, kLdaT = kER + 2;

template <class Src>
__global__ void __launch_bounds__(NT) expand_kernel(Src src, int rows, int k_in, int kek,
                                                    const bf16* __restrict__ w0,
                                                    const float* __restrict__ s0,
                                                    const float* __restrict__ b0, int c,
                                                    int8_t* __restrict__ e) {
  __shared__ __align__(16) double a_t[kEK][kLdaT];  // [k][row]
  __shared__ __align__(16) double w_s[kEK][kEC];
  const int r0 = blockIdx.y * kER, c0 = blockIdx.x * kEC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = 16 * (warp % 4) + 4 * (lane % 4);  // this lane's first row
  const int tc = 32 * (warp / 4) + 4 * (lane / 4);  // and first column
  src.start();
  if (blockIdx.x == 0) src.push(r0, min(kER, rows - r0));
  double acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0;
  }
  for (int k0 = 0; k0 < k_in; k0 += kek) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int x = threadIdx.x; x < kER * kek; x += NT) {
      const int r = x / kek, k = x - r * kek;
      a_t[k][r] = r0 + r < rows && k0 + k < k_in ? (double)src(r0 + r, k0 + k, k_in) : 0.0;
    }
    for (int x = threadIdx.x; x < kek * kEC; x += NT) {
      const int k = x / kEC, j = x - k * kEC;
      w_s[k][j] = k0 + k < k_in && c0 + j < c
                      ? (double)__bfloat162float(w0[(size_t)(k0 + k) * c + c0 + j])
                      : 0.0;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kek; ++k) {
      const double2 al = *reinterpret_cast<const double2*>(&a_t[k][tr]);
      const double2 ah = *reinterpret_cast<const double2*>(&a_t[k][tr + 2]);
      const double2 wl = *reinterpret_cast<const double2*>(&w_s[k][tc]);
      const double2 wh = *reinterpret_cast<const double2*>(&w_s[k][tc + 2]);
      const double a[4] = {al.x, al.y, ah.x, ah.y};
      const double w[4] = {wl.x, wl.y, wh.x, wh.y};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fma(a[r], w[q], acc[r][q]);
      }
    }
  }
  const int col = c0 + tc;
  if (col >= c) return;
  const int nq = min(4, c - col);  // this lane's columns within c
  float s[4], sh[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    s[q] = q < nq ? s0[col + q] : 0.f;
    sh[q] = q < nq ? b0[col + q] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + tr + r;
    if (row >= rows) continue;
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = __fadd_rn(__fmul_rn(__double2float_rn(acc[r][q]), s[q]), sh[q]);
      word |= (uint32_t)(uint8_t)to_stream(fmaxf(v, 0.f)) << (8 * q);
    }
    if (c % 4 == 0) {
      *reinterpret_cast<uint32_t*>(e + (size_t)row * c + col) = word;
    } else {
      for (int q = 0; q < nq; ++q) e[(size_t)row * c + col + q] = (int8_t)(word >> (8 * q));
    }
  }
}

// One GEMM of the chain on `stream`, in slices of g.k_slice summed columns; a split's
// int32 partials go to `part` and i8_reduce_kernel adds them before the epilogue.
// With g.part set on entry (the accshift taps, one slice each), the GEMM writes each
// slice's int32 sums there and the tap GEMM's epilogue reads them.
cudaError_t launch_gemm(I8Gemm g, int* part, long long part_ints, cudaStream_t s) {
  // A slice ends on a whole 16-byte chunk of A (and packed row of B): the K tile that
  // crosses its end reads zeros past it.
  if (g.k_slice <= 0 || (g.k_slice < g.k && g.k_slice % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  const int slices = (g.k + g.k_slice - 1) / g.k_slice;
  const bool reduce = slices > 1 && g.part == nullptr;
  if (reduce) {
    if (part == nullptr || (long long)slices * g.m * g.n > part_ints) {
      return cudaErrorInvalidValue;
    }
    g.part = part;
  }
  const size_t smem = (size_t)kTcStages * IGeo::STAGE;
  cudaError_t err = configure<i8_mma_kernel>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.n + kTile - 1) / kTile, (g.m + kTile - 1) / kTile, slices);
  i8_mma_kernel<<<grid, NT, smem, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess || !reduce) return err;
  const long long warps = (long long)g.m * ((g.n + kTile - 1) / kTile);
  const unsigned blocks = (unsigned)std::min<long long>((warps + NT / 32 - 1) / (NT / 32),
                                                        16LL * device_sms());
  if (g.epi == kReal) {
    i8_reduce_kernel<kReal><<<blocks, NT, 0, s>>>(g, slices);
  } else {
    i8_reduce_kernel<kResidual><<<blocks, NT, 0, s>>>(g, slices);
  }
  return cudaGetLastError();
}

// Workspace of a stage, in the order of `work` in vp3d_int8_block.
enum Work { kE = 0, kShifted, kRealBuf, kRmax, kRs, kHq, kPartBuf, kY, kFpart, kWorkParts };

struct Stage {
  int variant, accshift, batch, t_in, t_out, c;
  const void* x;  // kExpand: (batch, t_in, k_in) bf16 pre-tapped keypoints, else int8
  int k_in;
  const bf16* w0;  // kExpand: (k_in, c)
  const float* s0;
  const float* b0;
  const int* wa;  // (n_taps, w_rows, c) packed
  const float* a1;
  const float* b1;
  int n_taps, dilation, res_offset;
  const int* wb;  // (w_rows, c) packed
  const float* a2;
  const float* b2;
  const float* r;
  const bf16* ws;  // kShrink: (c, j3)
  const float* bs;
  int j3;
  void* const* work;
  long long part_ints, fpart_floats;
  const int* k_slices;  // the tap GEMM's, the 1x1's, the projection's
  void* out;
};

cudaError_t run_stage(const Stage& st, cudaStream_t stream) {
  const int c = st.c;
  const int m = st.batch * st.t_out;
  const int w_rows = (c + 31) / 32 * 8;
  const int8_t* src = static_cast<const int8_t*>(st.x);
  int* part = static_cast<int*>(st.work[kPartBuf]);
  cudaError_t err;
  if (st.variant == kExpand) {
    int8_t* e = static_cast<int8_t*>(st.work[kE]);
    const int rows = st.batch * st.t_in;
    const dim3 grid((c + kEC - 1) / kEC, (rows + kER - 1) / kER);
    const int chunks = (st.k_in + kEK - 1) / kEK;
    expand_kernel<<<grid, NT, 0, stream>>>(PreTapped{static_cast<const bf16*>(st.x)}, rows,
                                           st.k_in, (st.k_in + chunks - 1) / chunks, st.w0,
                                           st.s0, st.b0, c, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = e;
  }
  // The tap GEMM over the taps at offsets that are multiples of kAlign (all of them
  // in slice mode); in accshift mode the other taps first run over their aligned
  // windows, one launch split at the tap boundaries, each slice into its own int32
  // partials.
  I8Gemm g{};
  g.a = src;
  g.lda = c;
  g.kc = c;
  g.a_rows = st.t_in;
  g.w = st.wa;
  g.w_rows = w_rows;
  g.n = c;
  g.k_slice = c;
  int* shifted = static_cast<int*>(st.work[kShifted]);
  I8Gemm tap = g, sg = g;
  tap.rows = st.t_out;
  tap.m = m;
  sg.rows = st.t_out + kAlign;
  sg.m = st.batch * sg.rows;
  sg.part = shifted;
  for (int j = 0; j < st.n_taps; ++j) {
    const int rel = j * st.dilation;
    const int off = st.accshift ? rel % kAlign : 0;
    if (off == 0) {
      tap.a_off[tap.terms] = rel;
      tap.w_tap[tap.terms++] = j;
    } else {
      sg.a_off[sg.terms] = rel - off;
      sg.w_tap[sg.terms++] = j;
      tap.shift_off[tap.n_shift++] = off;
    }
  }
  if (sg.terms > 0) {
    sg.k = sg.terms * c;
    err = launch_gemm(sg, nullptr, 0, stream);
    if (err != cudaSuccess) return err;
  }
  float* real = static_cast<float*>(st.work[kRealBuf]);
  float* rmax = static_cast<float*>(st.work[kRmax]);
  tap.k = tap.terms * c;
  tap.k_slice = st.k_slices[0];
  tap.epi = kReal;
  tap.scale = st.a1;
  tap.shift = st.b1;
  tap.shifted = shifted;
  tap.rmax = rmax;
  tap.out = real;
  err = launch_gemm(tap, part, st.part_ints, stream);
  if (err != cudaSuccess) return err;
  float* rs = static_cast<float*>(st.work[kRs]);
  int8_t* hq = static_cast<int8_t*>(st.work[kHq]);
  const unsigned rq_blocks = (unsigned)std::min<long long>(
      ((long long)m + NT / 32 - 1) / (NT / 32), 16LL * device_sms());
  requant_kernel<<<rq_blocks, NT, 0, stream>>>(real, rmax, m, c, rs, hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  I8Gemm one = g;
  one.a = hq;
  one.a_rows = st.t_out;
  one.rows = st.t_out;
  one.m = m;
  one.terms = 1;
  one.w = st.wb;
  one.k = c;
  one.k_slice = st.k_slices[1];
  one.epi = kResidual;
  one.scale = st.a2;
  one.shift = st.b2;
  one.rs = rs;
  one.r = st.r;
  one.res = src;
  one.res_rows = st.t_in;
  one.res_off = st.res_offset;
  one.shrink = st.variant == kShrink;
  one.out = st.variant == kShrink ? st.work[kY] : st.out;
  err = launch_gemm(one, part, st.part_ints, stream);
  if (err != cudaSuccess || st.variant != kShrink) return err;
  return k3_project_bf16(static_cast<const bf16*>(st.work[kY]), m, c, st.ws, st.j3, st.bs,
                         st.k_slices[2], static_cast<float*>(st.work[kFpart]),
                         st.fpart_floats, static_cast<float*>(st.out), stream);
}

}  // namespace

extern "C" {

// Enqueues one int8 stage on `stream`.  `work` is a host array of kWorkParts device
// pointers (e, the accshift taps' partials, real, the row maxima, the row scales,
// hq, a split's int32 partials, the shrink's block output and the projection's
// float32 partials; null where the stage has no such part), `part_ints` and
// `fpart_floats` the sizes of the two split buffers, and k_slices the summed columns
// per slice of the tap GEMM, the 1x1 and the projection (temporal_block_int8._layout).
// Returns the first launch error (0 on success).  Shapes and workspace are checked by
// the Python wrapper; this refuses what would make a launch invalid or read out of
// bounds.
int vp3d_int8_block(int variant, int accshift, int batch, int t_in, int t_out,
                    int channels, const void* x, int k_in, const void* w0, const void* s0,
                    const void* b0, const void* wa, const void* a1, const void* b1,
                    int n_taps, int dilation,
                    int res_offset, const void* wb, const void* a2, const void* b2,
                    const void* r, const void* ws, const void* bs, int j3,
                    void* const* work, long long part_ints, long long fpart_floats,
                    const int* k_slices, void* out, void* stream) {
  const int span = (n_taps - 1) * dilation;
  if (variant < kMid || variant > kShrink || batch <= 0 || t_out <= 0 || channels <= 0 ||
      channels % 16 != 0 || n_taps <= 0 || n_taps > kMaxTerms || dilation <= 0 ||
      res_offset < 0 || t_out + span > t_in || res_offset + t_out > t_in ||
      work == nullptr || k_slices == nullptr ||
      (long long)batch * (t_out + kAlign) > (long long)kTile * 65535 ||
      (variant == kExpand && (k_in <= 0 || work[kE] == nullptr)) ||
      (variant == kShrink && (j3 <= 0 || j3 % 8 != 0 || work[kY] == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const Stage st{variant, accshift, batch, t_in, t_out, channels, x, k_in,
                 static_cast<const bf16*>(w0), static_cast<const float*>(s0),
                 static_cast<const float*>(b0), static_cast<const int*>(wa),
                 static_cast<const float*>(a1), static_cast<const float*>(b1), n_taps,
                 dilation, res_offset, static_cast<const int*>(wb),
                 static_cast<const float*>(a2), static_cast<const float*>(b2),
                 static_cast<const float*>(r), static_cast<const bf16*>(ws),
                 static_cast<const float*>(bs), j3, work, part_ints, fpart_floats, k_slices,
                 out};
  return run_stage(st, static_cast<cudaStream_t>(stream));
}

// The streaming front (F) of a per-frame int8 step on `stream`, for `batch` streams:
// frame (batch, c_in) float32 rounded to bf16 into the raw ring (cap, batch, c_in)
// bf16 at its position `pos` (int32, on the card); the expand conv over the ring's
// cap taps, older frames oldest first and the frame last, with w0 (cap * c_in,
// channels) bf16 and s0, b0 (channels) float32, as expand_kernel computes K4's:
// eq (batch, channels) int8, block 0's input.  Reads `pos` on the card and moves
// nothing, so a CUDA graph of it serves every frame.  Returns cudaGetLastError().
int vp3d_stream_front(const void* frame, void* ring, const void* pos, int batch, int c_in,
                      int cap, const void* w0, const void* s0, const void* b0, int channels,
                      void* eq, void* stream) {
  if (batch <= 0 || c_in <= 0 || cap <= 0 || channels <= 0 || pos == nullptr ||
      (batch + kER - 1) / kER > 65535) {
    return cudaErrorInvalidValue;
  }
  const int k_in = cap * c_in;
  const int chunks = (k_in + kEK - 1) / kEK;
  const FrontTaps src{static_cast<const float*>(frame), static_cast<bf16*>(ring),
                      static_cast<const int*>(pos), batch, c_in, cap, 0};
  const dim3 grid((channels + kEC - 1) / kEC, (batch + kER - 1) / kER);
  expand_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      src, batch, k_in, (k_in + chunks - 1) / chunks, static_cast<const bf16*>(w0),
      static_cast<const float*>(s0), static_cast<const float*>(b0), channels,
      static_cast<int8_t*>(eq));
  return cudaGetLastError();
}

}  // extern "C"
