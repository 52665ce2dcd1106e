// w8a8 int8 serving stages of the dilated model, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of videopose3d_tpu/ops/pallas/temporal_block_int8.py:
//   kExpand -> int8_expand_block   (_expand_block_i8_kernel, launched at :603)
//   kMid    -> int8_dilated_block  (_mid_block_i8_kernel, launched by _mid_block_i8 at :492)
//   kShrink -> int8_shrink_block   (_shrink_block_i8_kernel, launched at :669)
// and, as the ACC template parameter of all three, the accshift tap mode of
// tools/exp_realign.py (_mid_block_psum, launched at :122).
//
// One stage, for output row t of batch row b (x an int8 stream in 0..127):
//   acc  = sum_j x[t + j*d] @ Wa_j                     exact int32 (dp4a)
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
// which the compiler does not contract into FMAs; IEEE division; rintf rounds half
// to even, as torch.round), in the order of the plain PyTorch versions, so the int8
// streams equal theirs bit for bit.  The expand dot's bf16 products are exact and
// their float64 sum is rounded once to float32 by both versions.
//
// accshift (ACC): a tap whose row offset j*d within the tile window is not a multiple
// of 32 is computed over the 32-aligned rows [t0 + (j*d & ~31), + TM + 32) into int32
// partials, of which rows [j*d & 31, + TM) are added to the tap sum.  Integer sums
// commute, so both modes give the same bits; on this card a row offset costs no
// realignment, so accshift only adds work (3x the dot rows of each shifted tap).  The
// TPU form also converts the residual over the aligned window before slicing it; the
// convert is elementwise, so both modes read the residual row directly here.
//
// What bounds it on this card: 2*C*C*(k+1) int8 multiply-adds per output row on the
// CUDA cores as __dp4a (4 products per instruction, int32 sums) in this first
// version.  Tensor cores (mma.sync or wgmma with s8 operands, 1,979 dense int8 TOPS on
// an H100 SXM) and TMA pipelining are later work.  The weights (3 MB + 1 MB per block
// at C = 1024, int8) stay in the 50 MB L2 and are streamed once per 16-row tile, one
// byte per 16 multiply-adds.  As the TPU kernel keeps them in VMEM, every intermediate
// stays in shared memory: the staged tap rows, real (float32), hq (int8), and e
// (kExpand) or the bf16-rounded block output (kShrink); a stage reads its input
// stream once per tap and writes only its output.
//
// Thread mapping: a CUDA block owns TM = 16 consecutive output rows of one batch row
// and all C columns, since the row maximum needs every column of a row before the
// 1x1 product can start.  Each of the 256 threads owns 4 columns per pass of 1,024
// (vp3d::CPT); the weights are dp4a-packed (C_in/4, C_out) int32, so a warp's weight
// load is one 128-byte line, and the tile's int8 rows are read from shared memory as
// 16-byte broadcasts.  Ragged tails are masked: rows past the input are zero and rows
// past T_out are not stored.

#include "int8_gemm.cuh"

namespace {

using namespace vp3d;

enum Variant { kMid = 0, kExpand = 1, kShrink = 2 };

constexpr int kSlack = 32;                          // accshift window alignment

struct Args {
  int batch, t_in, t_out, c;
  const void* x;           // kExpand: (batch, t_in, k_in) bf16, else (batch, t_in, c) int8
  int k_in;
  const __nv_bfloat16* w0; // kExpand: (k_in, c)
  const float* s0;
  const float* b0;
  const int* wa;           // (n_taps, c/4, c) dp4a-packed int8
  const float* a1;
  const float* b1;
  int n_taps, dilation, res_offset;
  const int* wb;           // (c/4, c) dp4a-packed int8
  const float* a2;
  const float* b2;
  const float* r;
  const __nv_bfloat16* ws; // kShrink: (c, j3)
  const float* bs;
  int j3;
  void* out;               // (batch, t_out, c) int8, or (batch, t_out, j3) float for kShrink
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline int slack(bool acc) { return acc ? kSlack : 0; }
// Rows of e kExpand computes: every row a tap or the residual of the tile reads.
__host__ __device__ inline int expand_rows(int span, bool acc) {
  return (TM + span + slack(acc) + TM - 1) / TM * TM;
}
__host__ __device__ inline int raw_ld(int k_in) { return (k_in + 3) & ~3; }

// Shared memory of one CUDA block, in this order: [raw (float), e (int8) | staged
// tap rows (int8)], real (float; int32 tap partials in accshift), hq (int8), row
// scales (3*TM floats) and per-warp row maxima (kWarps*TM floats).
struct Smem {
  size_t raw, rows, real, hq, red, total;
};

__host__ __device__ inline Smem smem_layout(int variant, bool acc, int c, int k_in,
                                            int span) {
  Smem s;
  s.raw = 0;
  size_t o = 0;
  if (variant == kExpand) {
    o = align16(sizeof(float) * (size_t)expand_rows(span, acc) * raw_ld(k_in));
    s.rows = o;
    o += align16((size_t)expand_rows(span, acc) * c);
  } else {
    s.rows = o;
    o += align16((size_t)(TM + slack(acc)) * c);
  }
  s.real = o;
  o += sizeof(float) * (size_t)TM * c;
  s.hq = o;
  o += align16((size_t)TM * c);
  s.red = o;
  o += sizeof(float) * (size_t)(3 + kWarps) * TM;
  s.total = o;
  return s;
}

// Copies rows [t, t + n) of the (t_in, c) int8 stream into dst (zeros past t_in).
__device__ __forceinline__ void stage_rows(int8_t* dst, const int8_t* x, int t, int n,
                                           int t_in, int c) {
  const int vec = c / 16;
  for (int i = threadIdx.x; i < n * vec; i += NT) {
    const int r = i / vec;
    const int k = i - r * vec;
    int4 v = make_int4(0, 0, 0, 0);
    if (t + r < t_in) v = *reinterpret_cast<const int4*>(x + (size_t)(t + r) * c + k * 16);
    *reinterpret_cast<int4*>(dst + (size_t)r * c + k * 16) = v;
  }
}

template <int V, bool ACC>
__global__ void __launch_bounds__(NT, 1) int8_block_kernel(const Args p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int c = p.c;
  const int tid = threadIdx.x;
  const int span = (p.n_taps - 1) * p.dilation;
  const Smem L = smem_layout(V, ACC, c, p.k_in, span);
  int8_t* rows_s = reinterpret_cast<int8_t*>(smem + L.rows);  // e, or staged tap rows
  float* real_s = reinterpret_cast<float*>(smem + L.real);
  int* part_s = reinterpret_cast<int*>(smem + L.real);        // accshift tap partials
  int8_t* hq_s = reinterpret_cast<int8_t*>(smem + L.hq);
  float* inv_s = reinterpret_cast<float*>(smem + L.red);       // 127 / m
  float* rs_s = inv_s + TM;                                    // m * (1/127)
  float* red_s = rs_s + TM;                                    // kWarps x TM maxima
  const int8_t* x = nullptr;
  if constexpr (V != kExpand) {
    x = static_cast<const int8_t*>(p.x) + (size_t)b * p.t_in * c;
  }

  if constexpr (V == kExpand) {
    // e for rows t0 .. t0 + re - 1 from the pre-tapped bf16 keypoints.
    const int k_in = p.k_in;
    const int ldr = raw_ld(k_in);
    const int re = expand_rows(span, ACC);
    float* raw_s = reinterpret_cast<float*>(smem + L.raw);
    const __nv_bfloat16* raw =
        static_cast<const __nv_bfloat16*>(p.x) + (size_t)b * p.t_in * k_in;
    for (int i = tid; i < re * ldr; i += NT) {
      const int r = i / ldr;
      const int k = i - r * ldr;
      const int t = t0 + r;
      raw_s[i] = (k < k_in && t < p.t_in) ? __bfloat162float(raw[(size_t)t * k_in + k])
                                          : 0.f;
    }
    __syncthreads();
    for (int r0 = 0; r0 < re; r0 += TM) {
      for (int col0 = 0; col0 < c; col0 += NP) {
        double eacc[TM][CPT];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
#pragma unroll
          for (int q = 0; q < CPT; ++q) eacc[r][q] = 0.0;
        }
        for (int k = 0; k < k_in; ++k) {
          double w[CPT];
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            const int col = col0 + tid + q * NT;
            w[q] = col < c ? (double)__bfloat162float(p.w0[(size_t)k * c + col]) : 0.0;
          }
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const double a = raw_s[(r0 + r) * ldr + k];
#pragma unroll
            for (int q = 0; q < CPT; ++q) eacc[r][q] = fma(a, w[q], eacc[r][q]);
          }
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int col = col0 + tid + q * NT;
          if (col >= c) continue;
          const float s = p.s0[col];
          const float sh = p.b0[col];
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float v = __fadd_rn(__fmul_rn(__double2float_rn(eacc[r][q]), s), sh);
            rows_s[(size_t)(r0 + r) * c + col] = to_stream(fmaxf(v, 0.f));
          }
        }
      }
    }
    __syncthreads();
  }

  // Dilated taps: exact int32 sums, then real = relu(acc * A1 + B1) and the
  // per-thread row maxima.
  float rmax[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) rmax[r] = 0.f;
  int acc[TM][CPT];
  for (int col0 = 0; col0 < c; col0 += NP) {
    zero_i(acc);
    if constexpr (ACC) {
      for (int q = 0; q < CPT; ++q) {
        const int col = col0 + tid + q * NT;
        if (col < c) {
          for (int r = 0; r < TM; ++r) part_s[r * c + col] = 0;
        }
      }
    }
    for (int j = 0; j < p.n_taps; ++j) {
      const int rel = j * p.dilation;
      const int off = ACC ? (rel & (kSlack - 1)) : 0;
      const int base = rel - off;             // first row the tap's dot reads
      const int n_rows = off ? TM + kSlack : TM;
      const int8_t* A;
      if constexpr (V == kExpand) {
        A = rows_s + (size_t)base * c;
      } else {
        __syncthreads();  // every thread is done with the previous tap's rows
        stage_rows(rows_s, x, t0 + base, n_rows, p.t_in, c);
        __syncthreads();
        A = rows_s;
      }
      const int* W = p.wa + (size_t)j * (c / 4) * c;
      if (!off) {
        gemm_i8(acc, A, c, c, W, c, col0);
      } else {
        // accshift: partials over the aligned TM + 32 rows, rows [off, off + TM) kept.
        for (int r0 = 0; r0 < n_rows; r0 += TM) {
          int part[TM][CPT];
          zero_i(part);
          gemm_i8(part, A + (size_t)r0 * c, c, c, W, c, col0);
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            const int col = col0 + tid + q * NT;
            if (col >= c) continue;
#pragma unroll
            for (int r = 0; r < TM; ++r) {
              const int dst = r0 + r - off;
              if (dst >= 0 && dst < TM) part_s[dst * c + col] += part[r][q];
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = col0 + tid + q * NT;
      if (col >= c) continue;
      const float s = p.a1[col];
      const float sh = p.b1[col];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        int a = acc[r][q];
        if constexpr (ACC) a += part_s[r * c + col];  // this thread's own columns
        const float v = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(a), s), sh), 0.f);
        real_s[r * c + col] = v;
        rmax[r] = fmaxf(rmax[r], v);
      }
    }
  }

  requantize_rows(rmax, real_s, hq_s, inv_s, rs_s, red_s, c);

  // 1x1 product of hq, y, the residual, and the stage output.
  for (int col0 = 0; col0 < c; col0 += NP) {
    zero_i(acc);
    gemm_i8(acc, hq_s, c, c, p.wb, c, col0);
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = col0 + tid + q * NT;
      if (col >= c) continue;
      const float a2 = p.a2[col];
      const float b2 = p.b2[col];
      const float rr = p.r[col];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int t = t0 + r;
        const float y = fmaxf(
            __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[r][q]), rs_s[r]), a2), b2),
            0.f);
        float res;
        if constexpr (V == kExpand) {
          res = (float)rows_s[(size_t)(p.res_offset + r) * c + col];
        } else {
          const int tr = t + p.res_offset;
          res = tr < p.t_in ? (float)x[(size_t)tr * c + col] : 0.f;
        }
        const float v = __fadd_rn(__fmul_rn(res, rr), y);
        if constexpr (V == kShrink) {
          real_s[r * c + col] = round_to<__nv_bfloat16>(v);
        } else if (t < p.t_out) {
          static_cast<int8_t*>(p.out)[((size_t)b * p.t_out + t) * c + col] = to_stream(v);
        }
      }
    }
  }

  if constexpr (V == kShrink) {
    // Projection of the bf16-rounded block output: (TM, c) @ (c, j3) + bias, float32.
    __syncthreads();
    float* outf = static_cast<float*>(p.out);
    const int j3 = p.j3;
    for (int o = tid; o < TM * j3; o += NT) {
      const int r = o / j3;
      const int col = o - r * j3;
      const int t = t0 + r;
      if (t >= p.t_out) continue;
      const float* a = real_s + r * c;
      float s = 0.f;
      for (int k = 0; k < c; k += 4) {
        const float4 av = *reinterpret_cast<const float4*>(a + k);
        s = fmaf(av.x, __bfloat162float(p.ws[(size_t)k * j3 + col]), s);
        s = fmaf(av.y, __bfloat162float(p.ws[(size_t)(k + 1) * j3 + col]), s);
        s = fmaf(av.z, __bfloat162float(p.ws[(size_t)(k + 2) * j3 + col]), s);
        s = fmaf(av.w, __bfloat162float(p.ws[(size_t)(k + 3) * j3 + col]), s);
      }
      outf[((size_t)b * p.t_out + t) * j3 + col] = s + p.bs[col];
    }
  }
}

template <int V, bool ACC>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  const dim3 grid((p.t_out + TM - 1) / TM, p.batch);
  return launch_with_smem(int8_block_kernel<V, ACC>, grid, dim3(NT), smem, stream, p);
}

template <bool ACC>
cudaError_t dispatch(int variant, const Args& p, size_t smem, cudaStream_t stream) {
  switch (variant) {
    case kMid: return launch<kMid, ACC>(p, smem, stream);
    case kExpand: return launch<kExpand, ACC>(p, smem, stream);
    case kShrink: return launch<kShrink, ACC>(p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CUDA block of the stage needs, in bytes.
size_t vp3d_i8_smem_bytes(int variant, int accshift, int channels, int k_in, int span) {
  return smem_layout(variant, accshift != 0, channels, k_in, span).total;
}

// Launches one int8 stage on `stream`.  Returns cudaGetLastError() after the launch
// (0 on success).  Shapes are checked by the Python wrapper; this only refuses what
// would make the launch itself invalid.
int vp3d_int8_block(int variant, int accshift, int batch, int t_in, int t_out,
                    int channels, const void* x, int k_in, const void* w0, const void* s0,
                    const void* b0, const void* wa, const void* a1, const void* b1,
                    int n_taps, int dilation, int res_offset, const void* wb,
                    const void* a2, const void* b2, const void* r, const void* ws,
                    const void* bs, int j3, void* out, void* stream) {
  if (batch <= 0 || t_out <= 0 || channels <= 0 || channels % 16 != 0 || batch > 65535 ||
      (variant == kExpand && k_in <= 0) || (variant == kShrink && j3 <= 0)) {
    return cudaErrorInvalidValue;
  }
  const Args p{batch, t_in, t_out, channels, x, k_in,
               static_cast<const __nv_bfloat16*>(w0), static_cast<const float*>(s0),
               static_cast<const float*>(b0), static_cast<const int*>(wa),
               static_cast<const float*>(a1), static_cast<const float*>(b1), n_taps,
               dilation, res_offset, static_cast<const int*>(wb),
               static_cast<const float*>(a2), static_cast<const float*>(b2),
               static_cast<const float*>(r), static_cast<const __nv_bfloat16*>(ws),
               static_cast<const float*>(bs), j3, out};
  const size_t smem =
      smem_layout(variant, accshift != 0, channels, k_in, (n_taps - 1) * dilation).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return accshift ? dispatch<true>(variant, p, smem, s) : dispatch<false>(variant, p, smem, s);
}

}  // extern "C"
