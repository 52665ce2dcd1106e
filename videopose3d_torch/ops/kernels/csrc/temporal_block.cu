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
// What bounds it on this card: four C x C GEMMs per block (3 taps + 1x1), 8*C*C FLOP
// per output row, all on CUDA-core FP32 FMAs (67 TFLOP/s peak on an H100 SXM) in this
// first version; tensor cores (wgmma) and TMA pipelining are left for later work.
// The weights (16 MB at C=1024 in float32) stay in the 50 MB L2 and are streamed
// once per 16-row tile, 8 FLOP per weight byte loaded, so L2 bandwidth is the other
// limit.  The design keeps every intermediate out of device memory, as the TPU kernel
// keeps them in VMEM: the staged input rows, h, and (kExpand) e, (kShrink) the block
// output live in shared memory as float32 (values already rounded to T), so a block
// reads its input once per tap and writes only its output.
//
// Thread mapping: a CUDA block owns TM=16 consecutive output rows of one batch row
// and all C output columns, through gemm_tile (tile_gemm.cuh).  Ragged tails are
// masked: rows past the input are read as zero and rows past T_out are not stored.

#include "tile_gemm.cuh"

namespace {

using namespace vp3d;

enum Variant { kMid = 0, kExpand = 1, kShrink = 2 };

struct Args {
  int batch, t_in, t_out, c;
  const void* x;      // (batch, t_in, x_cols): raw keypoints for kExpand, else (.., c)
  int x_cols;
  const void* w0;     // kExpand: (k0, x_cols, c)
  const float* s0;
  const float* b0;
  int k0;
  const void* w_taps; // (n_taps, c, c)
  const float* s1;
  const float* b1;
  int n_taps, dilation, res_offset;
  const void* w2;     // (c, c)
  const float* s2;
  const float* b2;
  const void* ws;     // kShrink: (c, j3)
  const float* bs;
  int j3;
  void* out;          // (batch, t_out, c) of T, or (batch, t_out, j3) float for kShrink
};

__host__ __device__ inline int raw_ld(int c_in) { return (c_in + 3) & ~3; }
__host__ __device__ inline int expand_rows(int span) { return TM + span; }
__host__ __device__ inline int raw_rows(int span, int k0) {
  return (expand_rows(span) + TM - 1) / TM * TM + k0 - 1;
}

size_t smem_bytes(int variant, int c, int c_in, int k0, int span) {
  if (variant == kExpand) {
    return sizeof(float) * ((size_t)raw_rows(span, k0) * raw_ld(c_in) +
                            (size_t)expand_rows(span) * c + (size_t)TM * c);
  }
  return sizeof(float) * 2 * (size_t)TM * c;
}

template <typename T, int V>
__global__ void __launch_bounds__(NT, 1) temporal_block_kernel(const Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int c = p.c;
  const int tid = threadIdx.x;
  const int span = (p.n_taps - 1) * p.dilation;
  const T* x = static_cast<const T*>(p.x) + (size_t)b * p.t_in * p.x_cols;
  const T* w_taps = static_cast<const T*>(p.w_taps);
  const T* w2 = static_cast<const T*>(p.w2);

  float* a_s = smem;  // staged input rows of one tap; later the block output (kShrink)
  float* h_s;
  float* e_s = nullptr;
  float acc[TM][CPT];

  if constexpr (V == kExpand) {
    // Expand conv over the raw window, rows t0 .. t0 + TM + span - 1 of its output.
    const int c_in = p.x_cols;
    const int ldr = raw_ld(c_in);
    const int re = expand_rows(span);
    const int rr = raw_rows(span, p.k0);
    float* raw_s = smem;
    e_s = raw_s + rr * ldr;
    h_s = e_s + re * c;
    for (int i = tid; i < rr * ldr; i += NT) {
      const int r = i / ldr;
      const int k = i - r * ldr;
      const int t = t0 + r;
      raw_s[i] = (k < c_in && t < p.t_in) ? to_f<T>(x[(size_t)t * c_in + k]) : 0.f;
    }
    __syncthreads();
    const T* w0 = static_cast<const T*>(p.w0);
    for (int r0 = 0; r0 < re; r0 += TM) {
      for (int col0 = 0; col0 < c; col0 += NP) {
        zero(acc);
        for (int j = 0; j < p.k0; ++j) {
          gemm_tile<T>(acc, raw_s + (r0 + j) * ldr, ldr, c_in,
                       w0 + (size_t)j * c_in * c, c, c, col0);
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int col = col0 + tid + q * NT;
          if (col >= c) continue;
          const float s = p.s0[col];
          const float sh = p.b0[col];
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            if (r0 + r < re) {
              e_s[(r0 + r) * c + col] = round_to<T>(fmaxf(acc[r][q] * s + sh, 0.f));
            }
          }
        }
      }
    }
    __syncthreads();
  } else {
    h_s = a_s + TM * c;
  }

  // Dilated conv: n_taps GEMMs accumulated in float32, then BN1 + ReLU -> h.
  for (int col0 = 0; col0 < c; col0 += NP) {
    zero(acc);
    for (int j = 0; j < p.n_taps; ++j) {
      const float* A;
      if constexpr (V == kExpand) {
        A = e_s + j * p.dilation * c;
      } else {
        __syncthreads();  // every thread is done with the previous tap's rows
        for (int r = 0; r < TM; ++r) {
          const int t = t0 + j * p.dilation + r;
          for (int k = tid; k < c; k += NT) {
            a_s[r * c + k] = t < p.t_in ? to_f<T>(x[(size_t)t * c + k]) : 0.f;
          }
        }
        __syncthreads();
        A = a_s;
      }
      gemm_tile<T>(acc, A, c, c, w_taps + (size_t)j * c * c, c, c, col0);
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = col0 + tid + q * NT;
      if (col >= c) continue;
      const float s = p.s1[col];
      const float sh = p.b1[col];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        h_s[r * c + col] = round_to<T>(fmaxf(acc[r][q] * s + sh, 0.f));
      }
    }
  }
  __syncthreads();

  // 1x1 conv, BN2 + ReLU, residual added in float32, cast to T.
  T* out = static_cast<T*>(p.out);
  for (int col0 = 0; col0 < c; col0 += NP) {
    zero(acc);
    gemm_tile<T>(acc, h_s, c, c, w2, c, c, col0);
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int col = col0 + tid + q * NT;
      if (col >= c) continue;
      const float s = p.s2[col];
      const float sh = p.b2[col];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int t = t0 + r;
        float res;
        if constexpr (V == kExpand) {
          res = e_s[(p.res_offset + r) * c + col];
        } else {
          const int tr = t + p.res_offset;
          res = tr < p.t_in ? to_f<T>(x[(size_t)tr * c + col]) : 0.f;
        }
        const float v = res + fmaxf(acc[r][q] * s + sh, 0.f);
        if constexpr (V == kShrink) {
          a_s[r * c + col] = round_to<T>(v);
        } else if (t < p.t_out) {
          out[((size_t)b * p.t_out + t) * c + col] = from_f<T>(v);
        }
      }
    }
  }

  if constexpr (V == kShrink) {
    // Shrink projection of the block output tile: (TM, c) @ (c, j3) + bias, float32.
    __syncthreads();
    const T* ws = static_cast<const T*>(p.ws);
    float* outf = static_cast<float*>(p.out);
    const int j3 = p.j3;
    for (int o = tid; o < TM * j3; o += NT) {
      const int r = o / j3;
      const int col = o - r * j3;
      const int t = t0 + r;
      if (t >= p.t_out) continue;
      const float* a = a_s + r * c;
      float s = 0.f;
      for (int k = 0; k < c; k += 4) {
        const float4 av = *reinterpret_cast<const float4*>(a + k);
        s = fmaf(av.x, to_f<T>(ws[(size_t)k * j3 + col]), s);
        s = fmaf(av.y, to_f<T>(ws[(size_t)(k + 1) * j3 + col]), s);
        s = fmaf(av.z, to_f<T>(ws[(size_t)(k + 2) * j3 + col]), s);
        s = fmaf(av.w, to_f<T>(ws[(size_t)(k + 3) * j3 + col]), s);
      }
      outf[((size_t)b * p.t_out + t) * j3 + col] = s + p.bs[col];
    }
  }
}

template <typename T, int V>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  auto kern = temporal_block_kernel<T, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t_out + TM - 1) / TM, p.batch);
  kern<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int variant, const Args& p, size_t smem, cudaStream_t stream) {
  switch (variant) {
    case kMid: return launch<T, kMid>(p, smem, stream);
    case kExpand: return launch<T, kExpand>(p, smem, stream);
    case kShrink: return launch<T, kShrink>(p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CUDA block of the variant needs, in bytes.
size_t vp3d_block_smem_bytes(int variant, int channels, int c_in, int k0, int span) {
  return smem_bytes(variant, channels, c_in, k0, span);
}

size_t vp3d_block_max_smem_bytes() { return kMaxSmem; }

const char* vp3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one fused block on `stream`; dtype 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success).  Shapes are checked by the
// Python wrapper; this only refuses what would make the launch itself invalid.
int vp3d_temporal_block(int variant, int dtype, int batch, int t_in, int t_out,
                        int channels, const void* x, int x_cols, const void* w0,
                        const void* s0, const void* b0, int k0, const void* w_taps,
                        const void* s1, const void* b1, int n_taps, int dilation,
                        int res_offset, const void* w2, const void* s2, const void* b2,
                        const void* ws, const void* bs, int j3, void* out, void* stream) {
  if (batch <= 0 || t_out <= 0 || channels <= 0 || channels % 4 != 0 || batch > 65535) {
    return cudaErrorInvalidValue;
  }
  const Args p{batch, t_in, t_out, channels, x, x_cols, w0,
               static_cast<const float*>(s0), static_cast<const float*>(b0), k0, w_taps,
               static_cast<const float*>(s1), static_cast<const float*>(b1), n_taps,
               dilation, res_offset, w2, static_cast<const float*>(s2),
               static_cast<const float*>(b2), ws, static_cast<const float*>(bs), j3, out};
  const size_t smem = smem_bytes(variant, channels, x_cols, k0, (n_taps - 1) * dilation);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(variant, p, smem, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(variant, p, smem, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
