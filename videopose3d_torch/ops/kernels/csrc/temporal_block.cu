// Fused dilated residual blocks of the evaluation model, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of videopose3d_tpu/ops/pallas/temporal_block.py:
//   kExpand -> fused_expand_block  (_expand_block_kernel)
//   kMid    -> fused_dilated_block (_block_kernel)
//   kShrink -> fused_shrink_block  (_shrink_block_kernel)
//
// One residual block in inference mode, with BatchNorm folded into (scale, shift):
//   h   = act(relu(sum_j x[t + j*d] @ W_j * s1 + b1))
//   out = act(x[t + res_offset] + relu(h @ W2 * s2 + b2))
// kExpand first computes x itself as e = act(relu(conv_k0(raw) * s0 + b0)) from the
// raw (B, T, c_in) keypoints; kShrink projects the block output, act(out) @ Ws + bs,
// to (B, T_out, j3) in float32.  act() is the cast to the activation type T (float or
// bf16) at exactly the points where the TPU kernel casts; every sum is float32.
//
// What bounds it on this card: the products, 8 * C^2 FLOP per output row (3 taps +
// the 1x1), on the tensor cores in 3xTF32 in float32 (three TF32 MMAs a product, at
// most 495 / 3 TFLOP/s) and in bf16 (989 TFLOP/s).  vp3d_temporal_block, one host
// call per stage, enqueues the stage as a chain of tile GEMMs over M = B * T_out
// rows, each of 128 x 128 output tiles, so a stage reads its weights once per
// 128-row tile:
//   (kExpand) e = act(relu(raw window @ W0 * s0 + b0)), K = k0 * c_in;
//   h = act(relu(taps @ W_taps * s1 + b1)), K = n_taps * C;
//   out = act(res + relu(h @ W2 * s2 + b2)), the residual row read in the epilogue;
//   (kShrink) y = out @ Ws + bs in float32, one column tile.
// e, h and kShrink's block output go through device memory in T (h: 9 MB in bf16 at
// B = 2, T_out = 2,234, C = 1,024, within the 50 MB L2).  Row i of a GEMM is frame
// t = i % T_out of batch row b = i / T_out, and its tap j reads input row t + j * d
// of batch row b in place: the taps are never materialised.
// - float32 (k3_sgemm_kernel): the train block's tap GEMM main loop, tile_gemm_loop
//   of sgemm_tile.cuh, on its 128 x 128 tile with this row map: A's rows and B
//   through 3-stage cp.async rings, 3xTF32 mma.sync m16n8k8 (float32's accuracy),
//   two CUDA blocks per SM.
// - bf16 (k3_mma_kernel): mma.sync m16n8k16 with float32 sums on tc_tile.cuh's
//   128 x 128 tile (stream_tc.cuh's instruction wrappers and stage layout, 8 warps of
//   64 x 32), both operands staged by 16-byte cp.async into padded tiles of a 4-stage
//   ring and read by ldmatrix, two CUDA blocks per SM; the int8 stages' GEMMs
//   (temporal_block_int8.cu) run the same tile, and their shrink this projection.
// Where the tiles leave a ragged last wave, the summed dimension is split into slices
// of the rows the caller plans for each GEMM (temporal_block.k3_plan); each slice
// writes its float32 product (sgemm_tile.cuh's tile_store_part) and
// k3_reduce_kernel adds the slices in slice order before the epilogue.  No float atomics: two
// launches give bitwise-equal results.  Rows are copied in 16-byte words (C, the
// raw columns and the projection's width: multiples of 4 in float32, of 8 in bf16;
// the model pads other widths with zero channels once); K and N tails read as zero
// and rows past M are neither read nor stored.  Nothing is held per channel in
// shared memory, so any width runs.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "sgemm_tile.cuh"
#include "tc_tile.cuh"

namespace {

using namespace vp3d;

enum Variant { kMid = 0, kExpand = 1, kShrink = 2 };
enum Epilogue { kBnRelu = 0, kResidual = 1, kProject = 2 };

// One GEMM of a stage's chain: out (m x n) = A (m x k) @ W (k x n), then the epilogue.
template <typename T>
struct K3Gemm {
  // A row i = (b, t) reads tap j at a + (b * a_rows + t + j * dil) * lda, kc values
  // per tap (k = taps * kc).
  const T* a;
  int lda, kc, dil, a_rows;
  const T* w;  // (k, n) row-major
  int m, t_out, k, n, k_slice;
  float* part;  // (slices, m, n) float32 products of a split, or null
  int epi;
  const float* scale;  // kProject: the bias
  const float* shift;
  const T* res;  // kResidual: row (b, t + res_off) of res, n wide, res_rows per batch row
  int res_rows, res_off;
  void* out;  // (m, n) of T, or float for kProject
};

// Row b * a_rows + t of A's input for GEMM row i, or -1 past m.
template <typename T>
__device__ __forceinline__ int a_row(const K3Gemm<T>& p, int i) {
  if (i >= p.m) return -1;
  const int b = i / p.t_out;
  return b * p.a_rows + i - b * p.t_out;
}

// The epilogue of N consecutive columns col.. of row i (i < m, col < n, n % N == 0).
template <typename T, int N>
__device__ __forceinline__ void k3_store(const K3Gemm<T>& p, int i, int col,
                                         const float (&v)[N]) {
  if (p.epi == kProject) {
    float* o = static_cast<float*>(p.out) + (size_t)i * p.n + col;
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = __fadd_rn(v[e], p.scale[col + e]);
    return;
  }
  float y[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    y[e] = fmaxf(__fadd_rn(__fmul_rn(v[e], p.scale[col + e]), p.shift[col + e]), 0.f);
  }
  if (p.epi == kResidual) {
    const int b = i / p.t_out;
    const T* r = p.res + (size_t)(b * p.res_rows + i - b * p.t_out + p.res_off) * p.n + col;
#pragma unroll
    for (int e = 0; e < N; ++e) y[e] = __fadd_rn(to_f<T>(r[e]), y[e]);
  }
  T* o = static_cast<T*>(p.out) + (size_t)i * p.n + col;
  if constexpr (N == 4) {
    store4<T>(o, round_to<T>(y[0]), round_to<T>(y[1]), round_to<T>(y[2]), round_to<T>(y[3]));
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = from_f<T>(y[e]);
  }
}

// The epilogue of this thread's part of a finished 128 x 128 tile (sgemm_tile.cuh's
// accumulator layout: column pairs).
template <typename T>
__device__ __forceinline__ void k3_store_tile(const K3Gemm<T>& p,
                                              const float (&acc)[GRT][GRT]) {
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
#pragma unroll
  for (int r = 0; r < GRT; ++r) {
    const int i = i0 + tile_row(r);
#pragma unroll
    for (int h = 0; h < GRT / 2; ++h) {
      const int j = j0 + tile_col(2 * h);
      if (i >= p.m || j >= p.n) continue;
      const float v[2] = {acc[r][2 * h], acc[r][2 * h + 1]};
      k3_store<T, 2>(p, i, j, v);
    }
  }
}

// One 128 x 128 tile of the float32 GEMM (blockIdx.x: column tile, blockIdx.y: row
// tile) over the summed rows of slice blockIdx.z: sgemm_tile.cuh's tile_gemm_loop,
// A's 16-byte loads taken from the stage's input row (b, t + j * d) of each tile row.
__global__ void __launch_bounds__(GT_THREADS, 2) k3_sgemm_kernel(
    const __grid_constant__ K3Gemm<float> p) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);    // [B_STAGES][GT][a_ld]
  float* b_s = a_s + B_STAGES * a_slab<float>();   // [B_STAGES][GK][GLD]
  int* rows_s = reinterpret_cast<int*>(b_s + B_STAGES * TAP_SLAB);  // a_row of each tile row
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  const int k_begin = blockIdx.z * p.k_slice;
  const int k_end = min(p.k, k_begin + p.k_slice);
  if (threadIdx.x < GT) rows_s[threadIdx.x] = a_row(p, i0 + threadIdx.x);
  __syncthreads();
  float acc[GRT][GRT];
  // Summed columns kk .. kk + 3 of tile row r: all in tap kk / kc (kc % 4 == 0).
  tile_gemm_loop(
      acc, a_s, b_s, p.w, p.n, j0, k_begin, k_end, p.a,
      [&](int r, int kk) -> const float* {
        const int row = rows_s[r], j = kk / p.kc;
        return row >= 0 && kk < k_end
                   ? p.a + (size_t)(row + j * p.dil) * p.lda + (kk - j * p.kc)
                   : nullptr;
      },
      [](const float*, int) {});
  if (p.part != nullptr) {
    tile_store_part(acc, p.part, p.m, p.n, i0, j0);
  } else {
    k3_store_tile(p, acc);
  }
}

// The bf16 tile: stream_tc.cuh's stage of 128 A rows x 32 K values (80-byte padded
// rows) and 32 B rows x 128 columns (136-element padded rows), read by ldmatrix.
using MmaGeo = Geo<Bf16Mma, GT>;

// One 128 x 128 tile of the bf16 GEMM over the summed rows of slice blockIdx.z on
// mma.sync: both operands by cp.async through a kTcStages-deep ring.
__global__ void __launch_bounds__(NT, 2) k3_mma_kernel(const __grid_constant__ K3Gemm<bf16> p) {
  using G = MmaGeo;
  extern __shared__ float4 smem4[];
  char* stages = reinterpret_cast<char*>(smem4);
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  const int k_begin = blockIdx.z * p.k_slice;
  const int k_end = min(p.k, k_begin + p.k_slice);
  const int q_n = (k_end - k_begin + G::BK - 1) / G::BK;
  // This thread's 16-byte copies of a stage: A rows ar and ar + 64, chunk ac of the
  // 32 K values; B rows br and br + 16, chunk bc of the 128 columns.
  const int ac = threadIdx.x % 4, ar = threadIdx.x / 4;
  const int bc = threadIdx.x % 16, br = threadIdx.x / 16;
  const int rows[2] = {a_row(p, i0 + ar), a_row(p, i0 + ar + 64)};
  const int col = j0 + bc * 8;
  int kk = k_begin + ac * 8, kb = k_begin;
  TapPos pos;
  pos.start(kk, p.kc);
  auto load = [&](char* stage) {
    bf16* as = reinterpret_cast<bf16*>(stage);
    bf16* bs = reinterpret_cast<bf16*>(stage + G::A_BYTES);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool ok = rows[u] >= 0 && kk < k_end;
      const bf16* src =
          ok ? p.a + ((size_t)rows[u] + (size_t)pos.j * p.dil) * p.lda + pos.kin : p.a;
      cp_async16(as + (ar + 64 * u) * G::LDA + ac * 8, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = kb + br + 16 * u;
      const bool ok = col < p.n && r < k_end;
      cp_async16(bs + (br + 16 * u) * G::LDB + bc * 8, ok ? p.w + (size_t)r * p.n + col : p.w,
                 ok ? 16 : 0);
    }
    kk += G::BK;
    kb += G::BK;
    pos.step(G::BK, p.kc);
  };
  float acc[G::MT][G::NT8][4];
  tile_mma_loop<Bf16Mma, G>(acc, stages, q_n, load);
  // The m16n8 accumulator layout: acc[mt][nt][2 hh + e] is row lane / 4 + 8 hh of
  // m16 tile mt, column 2 (lane % 4) + e of n8 tile nt.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / G::WARPS_N, wn = warp - wm * G::WARPS_N;
  float* part = p.part == nullptr ? nullptr : p.part + (size_t)blockIdx.z * p.m * p.n;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + wm * G::WM + mt * 16 + (lane >> 2) + hh * 8;
        const int j = j0 + wn * G::WN + nt * 8 + 2 * (lane & 3);
        if (i >= p.m || j >= p.n) continue;
        const float v[2] = {acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]};
        if (part != nullptr) {
          *reinterpret_cast<float2*>(part + (size_t)i * p.n + j) = make_float2(v[0], v[1]);
        } else {
          k3_store<bf16, 2>(p, i, j, v);
        }
      }
    }
  }
}

// The split form's second launch: each thread adds the slices' float32 products of
// 4 consecutive columns in slice order, then runs the epilogue.  Row by row, not by
// 128 x 128 tiles as the train block's reduce (whose column sums need the tile):
// 38 registers, a full SM of threads, and no tail wave of tiles (4 % faster per
// split stage than a tile-shaped reduce on an H100, kernel_ab.py).
template <typename T>
__global__ void __launch_bounds__(NT) k3_reduce_kernel(const __grid_constant__ K3Gemm<T> p,
                                                       int slices) {
  const int groups_per_row = p.n / 4;
  const size_t groups = (size_t)p.m * groups_per_row, stride = (size_t)p.m * p.n;
  for (size_t g = (size_t)blockIdx.x * NT + threadIdx.x; g < groups;
       g += (size_t)gridDim.x * NT) {
    const int i = (int)(g / groups_per_row);
    const int col = (int)(g - (size_t)i * groups_per_row) * 4;
    const float* src = p.part + (size_t)i * p.n + col;
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int z = 1; z < slices; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(src + z * stride);
      s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                      __fadd_rn(s.w, v.w));
    }
    const float v[4] = {s.x, s.y, s.z, s.w};
    k3_store<T, 4>(p, i, col, v);
  }
}

// One GEMM of the chain, in slices of g.k_slice summed rows.
template <typename T>
cudaError_t launch_gemm(K3Gemm<T> g, float* part, long long part_floats, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (g.k_slice <= 0 || (g.k_slice < g.k && g.k_slice % GK != 0)) return cudaErrorInvalidValue;
  const int slices = (g.k + g.k_slice - 1) / g.k_slice;
  g.part = nullptr;
  if (slices > 1) {
    if (part == nullptr || (long long)slices * g.m * g.n > part_floats) {
      return cudaErrorInvalidValue;
    }
    g.part = part;
  }
  const dim3 grid((g.n + GT - 1) / GT, (g.m + GT - 1) / GT, slices);
  if constexpr (kBf16) {
    const size_t smem = (size_t)kTcStages * MmaGeo::STAGE;
    cudaError_t err = configure<k3_mma_kernel>(smem);
    if (err != cudaSuccess) return err;
    k3_mma_kernel<<<grid, NT, smem, s>>>(g);
  } else {
    const size_t smem =
        sizeof(float) * B_STAGES * (a_slab<float>() + TAP_SLAB) + sizeof(int) * GT;
    cudaError_t err = configure<k3_sgemm_kernel>(smem);
    if (err != cudaSuccess) return err;
    k3_sgemm_kernel<<<grid, GT_THREADS, smem, s>>>(g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const size_t groups = (size_t)g.m * (g.n / 4);
  const unsigned blocks =
      (unsigned)std::min<size_t>((groups + NT - 1) / NT, 16 * (size_t)device_sms());
  k3_reduce_kernel<T><<<blocks, NT, 0, s>>>(g, slices);
  return cudaGetLastError();
}

struct Stage {
  int variant, batch, t_in, t_out, c;
  const void* x;  // (batch, t_in, x_cols): raw keypoints for kExpand, else (.., c)
  int x_cols;
  const void* w0;  // kExpand: (k0, x_cols, c)
  const float* s0;
  const float* b0;
  int k0;
  const void* w_taps;  // (n_taps, c, c)
  const float* s1;
  const float* b1;
  int n_taps, dilation, res_offset;
  const void* w2;  // (c, c)
  const float* s2;
  const float* b2;
  const void* ws;  // kShrink: (c, j3)
  const float* bs;
  int j3;
  void* e;  // kExpand: (batch, t_in - k0 + 1, c) of T
  void* h;  // (batch, t_out, c) of T
  void* y;  // kShrink: (batch, t_out, c) of T, the block output
  float* part;
  long long part_floats;
  const int* k_slices;  // summed rows per slice of each GEMM of the chain, in order
  void* out;  // (batch, t_out, c) of T, or (batch, t_out, j3) float for kShrink
};

// The stage's chain of GEMMs on `stream`.
template <typename T>
cudaError_t run_stage(const Stage& st, cudaStream_t stream) {
  const int c = st.c;
  const int* k_slice = st.k_slices;
  const T* src = static_cast<const T*>(st.x);
  int src_rows = st.t_in;
  K3Gemm<T> g{};
  if (st.variant == kExpand) {
    // The window of k0 raw rows from row t is k0 * x_cols consecutive values.
    const int t_e = st.t_in - st.k0 + 1;
    g = K3Gemm<T>{};
    g.a = src;
    g.lda = st.x_cols;
    g.kc = st.k0 * st.x_cols;
    g.a_rows = st.t_in;
    g.w = static_cast<const T*>(st.w0);
    g.m = st.batch * t_e;
    g.t_out = t_e;
    g.k = g.kc;
    g.n = c;
    g.epi = kBnRelu;
    g.scale = st.s0;
    g.shift = st.b0;
    g.out = st.e;
    g.k_slice = *k_slice++;
    cudaError_t err = launch_gemm(g, st.part, st.part_floats, stream);
    if (err != cudaSuccess) return err;
    src = static_cast<const T*>(st.e);
    src_rows = t_e;
  }
  const int m = st.batch * st.t_out;
  g = K3Gemm<T>{};
  g.a = src;
  g.lda = c;
  g.kc = c;
  g.dil = st.dilation;
  g.a_rows = src_rows;
  g.w = static_cast<const T*>(st.w_taps);
  g.m = m;
  g.t_out = st.t_out;
  g.k = st.n_taps * c;
  g.n = c;
  g.epi = kBnRelu;
  g.scale = st.s1;
  g.shift = st.b1;
  g.out = st.h;
  g.k_slice = *k_slice++;
  cudaError_t err = launch_gemm(g, st.part, st.part_floats, stream);
  if (err != cudaSuccess) return err;
  g.a = static_cast<const T*>(st.h);
  g.dil = 0;
  g.a_rows = st.t_out;
  g.w = static_cast<const T*>(st.w2);
  g.k = c;
  g.epi = kResidual;
  g.scale = st.s2;
  g.shift = st.b2;
  g.res = src;
  g.res_rows = src_rows;
  g.res_off = st.res_offset;
  g.out = st.variant == kShrink ? st.y : st.out;
  g.k_slice = *k_slice++;
  err = launch_gemm(g, st.part, st.part_floats, stream);
  if (err != cudaSuccess || st.variant != kShrink) return err;
  g.a = static_cast<const T*>(st.y);
  g.w = static_cast<const T*>(st.ws);
  g.n = st.j3;
  g.epi = kProject;
  g.scale = st.bs;
  g.shift = nullptr;
  g.res = nullptr;
  g.out = st.out;
  g.k_slice = *k_slice;
  return launch_gemm(g, st.part, st.part_floats, stream);
}

}  // namespace

namespace vp3d {

// The projection GEMM of K3's bf16 chain on its own: out (m, n) = a (m, k) @ w (k, n)
// + bias, float32 sums, in slices of k_slice summed rows (the int8 shrink's last
// GEMM, temporal_block_int8.cu).
cudaError_t k3_project_bf16(const bf16* a, int m, int k, const bf16* w, int n,
                            const float* bias, int k_slice, float* part,
                            long long part_floats, float* out, cudaStream_t stream) {
  K3Gemm<bf16> g{};
  g.a = a;
  g.lda = k;
  g.kc = k;
  g.a_rows = m;
  g.w = w;
  g.m = m;
  g.t_out = m;
  g.k = k;
  g.n = n;
  g.k_slice = k_slice;
  g.epi = kProject;
  g.scale = bias;
  g.out = out;
  return launch_gemm(g, part, part_floats, stream);
}

}  // namespace vp3d

extern "C" {

// The most dynamic shared memory a CUDA block may opt in to, in bytes (SMEM_OPT_IN).
size_t vp3d_block_max_smem_bytes() { return kMaxSmem; }

const char* vp3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one fused stage on `stream`; dtype 0 = float32, 1 = bfloat16.  k_slices
// holds the summed rows per slice of each GEMM of the stage's chain, in order (the
// expand window's, the taps', the 1x1's, the projection's; temporal_block.k3_plan).
// Returns the first launch error (0 on success).  Shapes and scratch sizes are
// checked by the Python wrapper; this refuses what would make a launch invalid or
// read out of bounds: widths that are not whole 16-byte words, geometry that reaches
// past the input, slices that are not whole slabs, and a split whose products do not
// fit in `part`.
int vp3d_temporal_block(int variant, int dtype, int batch, int t_in, int t_out,
                        int channels, const void* x, int x_cols, const void* w0,
                        const void* s0, const void* b0, int k0, const void* w_taps,
                        const void* s1, const void* b1, int n_taps, int dilation,
                        int res_offset, const void* w2, const void* s2, const void* b2,
                        const void* ws, const void* bs, int j3, void* e, void* h, void* y,
                        void* part, long long part_floats, const int* k_slices, void* out,
                        void* stream) {
  const int align = dtype == 1 ? 8 : 4;
  const int src_rows = variant == kExpand ? t_in - k0 + 1 : t_in;
  const int span = (n_taps - 1) * dilation;
  if ((dtype != 0 && dtype != 1) || variant < kMid || variant > kShrink || batch <= 0 ||
      t_out <= 0 || channels <= 0 || channels % align != 0 || n_taps <= 0 || dilation <= 0 ||
      res_offset < 0 || t_out + span > src_rows || res_offset + t_out > src_rows ||
      k_slices == nullptr || (long long)(channels + GT - 1) / GT > 65535 ||
      ((long long)batch * std::max(t_in, t_out) + GT - 1) / GT > 65535) {
    return cudaErrorInvalidValue;
  }
  if (variant == kExpand && (k0 <= 0 || x_cols <= 0 || x_cols % align != 0 || e == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (variant == kShrink && (j3 <= 0 || j3 % align != 0 || y == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Stage st{variant, batch, t_in, t_out, channels, x, x_cols, w0,
                 static_cast<const float*>(s0), static_cast<const float*>(b0), k0, w_taps,
                 static_cast<const float*>(s1), static_cast<const float*>(b1), n_taps,
                 dilation, res_offset, w2, static_cast<const float*>(s2),
                 static_cast<const float*>(b2), ws, static_cast<const float*>(bs), j3, e, h, y,
                 static_cast<float*>(part), part_floats, k_slices, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run_stage<float>(st, s) : run_stage<bf16>(st, s);
}

}  // extern "C"
