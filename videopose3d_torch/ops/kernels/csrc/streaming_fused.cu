// Fused streaming step of the causal model, for Hopper (sm_90a): every residual block
// and the shrink projection for one frame (K5) or k frames (K6) of B independent
// streams in one launch, reading the older taps from per-block ring buffers and
// pushing each block's input into its ring in place; and the in-place ring push (K7).
// This file holds the int8 step kernel, the ring push and the entry points; the bf16
// step kernel is in stream_bf16.cu.
//
// Replaces the Pallas TPU kernels of videopose3d_tpu/ops/pallas/streaming_fused.py
// and videopose3d_tpu/streaming.py:
//   stream_int8_kernel -> fused_blocks_step (_fused_blocks_kernel, launched by _fused_call)
//       at k = 1, fused_blocks_step_multi (_fused_blocks_multi_kernel) at k > 1
//   ring_push_kernel   -> streaming.py _ring_push_dma (_ring_push_dma_kernel)
// The step kernels take the frame count k and whether the rings are doubled as
// arguments: k = 1 with single rings is K5, k > 1 with doubled rings is K6.
//
// One int8 residual block on the rows of one CUDA block, x its input (B, C) per frame:
// the w8a8 block of temporal_block_int8.cu (K4) with the taps read from ring slots
// instead of dilated offsets: exact int32 dp4a sums, real = relu(acc*A1+B1), per-row
// requantization of h, y = relu(float(hq @ Wb) * (m/127) * A2 + B2), v = float(x) * R
// + y; clip(rint(v), 0, 127) feeds the next block, and the last block's f32 v, cast
// to bf16, is projected by the bf16 shrink.  Every float step is one IEEE operation
// with one rounding, in the plain version's order, so the int8 rings equal the plain
// version's bit for bit.
// Tap j of a block reads lag L_j = (width-1-j) * dilation frames back; the newest tap
// (L = 0) is x itself.  The ring positions come from the host every step, by value
// in the launch's argument struct: `write` (k-aligned with doubled rings) and per tap
// its first slot `slot` (the ring row of frame 0's tap).
//
// Design.  The step has no dependence between streams, and within one stream a block
// needs only that stream's rows, their ring history and the whole previous row (the
// row maximum of int8 requantization).  So a CUDA block owns TM = 16 rows, all C
// columns, through every residual block and the shrink, with no grid-wide sync, as
// K4's kernels own 16 rows.  With k frames (K6) the rows are k frames x 16/k streams,
// row r = frame f * (16/k) + stream s: a tap with lag L < k reads frame f - L of the
// block's own input from shared memory (the JAX kernel's push-then-read of the doubled
// ring), older frames from ring slot `slot` + f.  With doubled rings every push writes
// the k rows at `write` and at `write` + cap.  The rows a block pushes are never the
// rows its taps read (lags lie in (0, cap) and k-aligned doubled rings hold
// cap >= max lag + k), and other CUDA blocks touch other streams' rows only, so the
// pushes need no ordering against the reads.
//
// What bounds it on this card: per frame and stream 2 * (width + 1) * C^2 operations
// per block, on the CUDA cores (dp4a) in this first version; int8 mma (1,979 dense
// TOP/s on an H100 SXM) is later work.  The weights (8 MB at C = 1024, -arc
// 3,3,3,3,3) stay in the 50 MB L2 and are streamed once per CUDA block.  Known limit:
// at k = 1 and B = 1,024 the grid is only 64 CUDA blocks for 132 SMs, and a CUDA
// block's shared memory (~113 KB at C = 1024) admits one block per SM; K6 at k = 8
// runs 512.

#include "int8_gemm.cuh"
#include "stream_step.cuh"

namespace {

using namespace vp3d;

template <typename T> struct Layout;
// int8: act (int8 input of the current block) | tap (staged tap rows, int8) |
//       real (float) | hq (int8) | 3 + kWarps rows of TM floats (row scales, maxima).
template <> struct Layout<int8_t> {
  static __host__ __device__ size_t act(int) { return 0; }
  static __host__ __device__ size_t tap(int c) { return (size_t)TM * c; }
  static __host__ __device__ size_t real(int c) { return 2 * (size_t)TM * c; }
  static __host__ __device__ size_t hq(int c) { return 6 * (size_t)TM * c; }
  static __host__ __device__ size_t red(int c) { return 7 * (size_t)TM * c; }
  static __host__ __device__ size_t total(int c) {
    return red(c) + sizeof(float) * (3 + kWarps) * TM;
  }
};
// Row r of this CUDA block: frame f, stream b; false for a row past the batch or the
// k * (TM / k) rows in use.
struct Row {
  int f, b;
  bool valid;
};

__device__ __forceinline__ Row row_of(int r, int k, int batch) {
  const int sb = TM / k;
  Row w;
  w.f = r / sb;
  w.b = blockIdx.x * sb + (r - w.f * sb);
  w.valid = w.f < k && w.b < batch;
  return w;
}

// Pushes the block's input rows into ring rows `write` + f (and + cap when doubled).
// src(r, i) gives the i-th 16-byte vector of row r's ring values.
template <typename R, typename Src>
__device__ __forceinline__ void push_rows(const StepArgs& p, const BlockArgs& bk, Src src) {
  const int vec = p.c * (int)sizeof(R) / 16;
  R* ring = static_cast<R*>(bk.ring);
  for (int i = threadIdx.x; i < TM * vec; i += NT) {
    const int r = i / vec;
    const int v = i - r * vec;
    const Row w = row_of(r, p.k, p.batch);
    if (!w.valid) continue;
    const int4 val = src(r, v);
    const size_t at = ((size_t)(bk.write + w.f) * p.batch + w.b) * p.c;
    reinterpret_cast<int4*>(ring + at)[v] = val;
    if (p.doubled) {
      reinterpret_cast<int4*>(ring + at + (size_t)bk.cap * p.batch * p.c)[v] = val;
    }
  }
}

// The ring row older tap j of row w reads: frame f's tap sits at slot + f.
template <typename R>
__device__ __forceinline__ const R* tap_row(const StepArgs& p, const BlockArgs& bk, int j,
                                            const Row& w) {
  return static_cast<const R*>(bk.ring) + ((size_t)(bk.slot[j] + w.f) * p.batch + w.b) * p.c;
}

__device__ __forceinline__ int4 load_vec(const void* base, int v) {
  return reinterpret_cast<const int4*>(base)[v];
}

// ---------------------------------------------------------------------------
// int8
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) stream_int8_kernel(const StepArgs p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  using L = Layout<int8_t>;
  const int c = p.c;
  const int tid = threadIdx.x;
  const int vec = c / 16;
  int8_t* act_s = reinterpret_cast<int8_t*>(smem + L::act(c));
  int8_t* tap_s = reinterpret_cast<int8_t*>(smem + L::tap(c));
  float* real_s = reinterpret_cast<float*>(smem + L::real(c));
  int8_t* hq_s = reinterpret_cast<int8_t*>(smem + L::hq(c));
  float* inv_s = reinterpret_cast<float*>(smem + L::red(c));
  float* rs_s = inv_s + TM;
  float* red_s = rs_s + TM;

  // Block 0's input: the expand stream e of this block's rows.
  const int8_t* x = static_cast<const int8_t*>(p.x);
  for (int i = tid; i < TM * vec; i += NT) {
    const int r = i / vec;
    const Row w = row_of(r, p.k, p.batch);
    int4 v = make_int4(0, 0, 0, 0);
    if (w.valid) v = load_vec(x + ((size_t)w.f * p.batch + w.b) * c, i - r * vec);
    reinterpret_cast<int4*>(act_s)[i] = v;
  }
  __syncthreads();

  int acc[TM][CPT];
  for (int bi = 0; bi < p.n_blocks; ++bi) {
    const BlockArgs& bk = p.blk[bi];
    const bool last = bi == p.n_blocks - 1;
    push_rows<int8_t>(p, bk, [&](int r, int v) { return load_vec(act_s + (size_t)r * c, v); });

    float rmax[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) rmax[r] = 0.f;
    for (int col0 = 0; col0 < c; col0 += NP) {
      zero_i(acc);
      for (int j = 0; j < bk.width; ++j) {
        const int8_t* A = act_s;  // the newest tap, lag 0
        if (j < bk.width - 1) {
          const int lag = bk.lag[j];
          __syncthreads();  // every thread is done with the previous tap's rows
          for (int i = tid; i < TM * vec; i += NT) {
            const int r = i / vec;
            const int v = i - r * vec;
            const Row w = row_of(r, p.k, p.batch);
            int4 val = make_int4(0, 0, 0, 0);
            if (w.valid) {
              val = w.f >= lag ? load_vec(act_s + (size_t)(r - lag * (TM / p.k)) * c, v)
                               : load_vec(tap_row<int8_t>(p, bk, j, w), v);
            }
            reinterpret_cast<int4*>(tap_s)[i] = val;
          }
          __syncthreads();
          A = tap_s;
        }
        gemm_i8(acc, A, c, c, static_cast<const int*>(bk.wa) + (size_t)j * (c / 4) * c, c,
                col0);
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = col0 + tid + q * NT;
        if (col >= c) continue;
        const float s = bk.v[0][col];
        const float sh = bk.v[1][col];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float v = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[r][q]), s), sh), 0.f);
          real_s[r * c + col] = v;
          rmax[r] = fmaxf(rmax[r], v);
        }
      }
    }
    requantize_rows(rmax, real_s, hq_s, inv_s, rs_s, red_s, c);

    // 1x1 product of hq, y, the residual; the block output replaces its input in
    // act_s column by column (each thread reads and writes only its own columns).
    for (int col0 = 0; col0 < c; col0 += NP) {
      zero_i(acc);
      gemm_i8(acc, hq_s, c, c, static_cast<const int*>(bk.wb), c, col0);
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = col0 + tid + q * NT;
        if (col >= c) continue;
        const float a2 = bk.v[2][col];
        const float b2 = bk.v[3][col];
        const float rr = bk.v[4][col];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float y = fmaxf(
              __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[r][q]), rs_s[r]), a2), b2),
              0.f);
          const float v = __fadd_rn(__fmul_rn((float)act_s[r * c + col], rr), y);
          if (last) {
            real_s[r * c + col] = round_to<__nv_bfloat16>(v);
          } else {
            act_s[r * c + col] = to_stream(v);
          }
        }
      }
    }
    __syncthreads();
  }

  // Shrink: bf16(v) @ Ws + bs, float32, frame-major poses.
  for (int o = tid; o < TM * p.j3; o += NT) {
    const int r = o / p.j3;
    const int col = o - r * p.j3;
    const Row w = row_of(r, p.k, p.batch);
    if (!w.valid) continue;
    const float* a = real_s + (size_t)r * c;
    float s = 0.f;
    for (int kk = 0; kk < c; kk += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + kk);
      s = fmaf(av.x, __bfloat162float(p.ws[(size_t)kk * p.j3 + col]), s);
      s = fmaf(av.y, __bfloat162float(p.ws[(size_t)(kk + 1) * p.j3 + col]), s);
      s = fmaf(av.z, __bfloat162float(p.ws[(size_t)(kk + 2) * p.j3 + col]), s);
      s = fmaf(av.w, __bfloat162float(p.ws[(size_t)(kk + 3) * p.j3 + col]), s);
    }
    p.out[((size_t)w.f * p.batch + w.b) * p.j3 + col] = s + p.bs[col];
  }
}

// ---------------------------------------------------------------------------
// K7: one (B, C) row into a (cap, B, C) ring, one thread per 16 bytes.  Bound by
// bytes: the row is read once and written once.
// ---------------------------------------------------------------------------

__global__ void ring_push_kernel(int4* __restrict__ dst, const int4* __restrict__ src,
                                 long long n_vec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_vec) dst[i] = src[i];
}

size_t smem_bytes(int act_type, int c) {
  return act_type == 0 ? Layout<int8_t>::total(c) : stream_bf16_min_smem(c);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CUDA block of the step; act_type 0 = int8, 1 = bf16
// (its smallest plan: c channels fit if this does).
size_t vp3d_stream_smem_bytes(int act_type, int channels) {
  return smem_bytes(act_type, channels);
}

int vp3d_stream_max_blocks() { return kMaxBlocks; }
int vp3d_stream_max_taps() { return kMaxTaps; }

// Launches one fused streaming step on `stream`.  Per residual block, `ptrs` holds 8
// device pointers (wa, wb, the 5 epilogue vectors, ring); bf16 takes 4 vectors and
// in block 0's fifth slot its (2, k * batch, c) bf16 exchange buffer.  `ints` holds
// 3 + 2 * kMaxTaps values (width, cap, write, lag[kMaxTaps], slot[kMaxTaps]),
// both host arrays.  Returns cudaGetLastError() after the launch (0 on success).
// Shapes are checked by the Python wrapper; this only refuses what would make the
// launch itself invalid.
int vp3d_stream_step(int act_type, int n_blocks, int batch, int channels, int k,
                     int doubled, const void* x, const void* ws, const void* bs, int j3,
                     void* out, const void* const* ptrs, const int* ints, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || batch <= 0 || channels <= 0 ||
      (act_type == 0 && channels % 16 != 0) || k < 1 || k > kMaxFrames || j3 <= 0) {
    return cudaErrorInvalidValue;
  }
  StepArgs p{};
  p.n_blocks = n_blocks;
  p.batch = batch;
  p.c = channels;
  p.k = k;
  p.doubled = doubled;
  p.j3 = j3;
  p.x = x;
  p.ws = static_cast<const __nv_bfloat16*>(ws);
  p.bs = static_cast<const float*>(bs);
  p.out = static_cast<float*>(out);
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
    if (bk.width < 1 || bk.width > kMaxTaps + 1) return cudaErrorInvalidValue;
    for (int j = 0; j < kMaxTaps; ++j) {
      bk.lag[j] = ii[3 + j];
      bk.slot[j] = ii[3 + kMaxTaps + j];
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_type == 1) {
    p.xbuf = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[6]));
    return launch_stream_bf16(p, s);
  }
  if (act_type != 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(act_type, channels);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int sb = TM / k;
  const dim3 grid((batch + sb - 1) / sb);
  return launch_with_smem(stream_int8_kernel, grid, dim3(NT), smem, s, p);
}

// Copies n_bytes (a multiple of 16) from `row` to `ring` + offset_bytes, both 16-byte
// aligned, on `stream`.
int vp3d_ring_push(void* ring, const void* row, long long offset_bytes, long long n_bytes,
                   void* stream) {
  if (n_bytes <= 0 || n_bytes % 16 != 0 || offset_bytes % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const long long n_vec = n_bytes / 16;
  const int threads = 256;
  const long long blocks = (n_vec + threads - 1) / threads;
  ring_push_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<int4*>(static_cast<char*>(ring) + offset_bytes),
      static_cast<const int4*>(row), n_vec);
  return cudaGetLastError();
}

}  // extern "C"
