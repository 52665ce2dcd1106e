// The four evaluation protocols of one video, for Hopper (sm_90a): MPJPE, P-MPJPE,
// N-MPJPE and MPJVE, each the mean over the video's frames and joints.
//
// Replaces no TPU kernel: the JAX package fetches every video's poses and runs the
// protocols in host NumPy (videopose3d_tpu/ops/losses.py), and so did the port.  Here
// the poses stay where they were predicted and only four float64 means a video come
// back.  Semantics are those of ops/losses.py (mpjpe_np, p_mpjpe, n_mpjpe_np,
// mean_velocity_error), the target's root joint zeroed on load:
//   MPJPE    |p - t| per joint;
//   N-MPJPE  |s p - t|, s = sum(t . p) / sum(p . p) over the frame;
//   P-MPJPE  |g (p - mp) R - (t - mt)|, (R, g) the frame's similarity alignment: the
//            SVD H = U S V^T of the cross-covariance H = (p - mp)^T (t - mt), the
//            smallest singular axis reflected when det(U V^T) < 0, R = U V^T and
//            g = sum(S) / |p - mp|^2;
//   MPJVE    |(p[f+1] - p[f]) - (t[f+1] - t[f])| over the n - 1 frame differences.
//
// What bounds it: nothing on this card.  A 3,500-frame video is ~13 MFLOP of float64
// over ~1.4 MB: the kernel takes a few tens of microseconds, bound by latency and its
// launch.  The design is for exactness and repeatability, not speed: one thread a
// frame, the frame's poses loaded once as float32 into shared memory (a warp's 33
// frames, the 33rd for the last velocity, in whole coalesced rows), every sum, the
// 3 x 3 SVD and the distances in float64 registers.  The SVD is a one-sided Jacobi
// SVD of fixed sweeps with proper rotations only, so V is proper; U's third axis is
// the cross product of the first two, so the reflection comes out as the sign of
// the third singular value and R = U V^T is proper (no determinant, no branch on it).
// Partial sums go warp -> block -> a fixed slot per block, and a second launch of one
// warp adds the slots in a fixed order: no atomics and no state kept between calls,
// so two calls agree bit for bit.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 32;              // frames a tile, one thread (one warp) each
constexpr int kMaxBlocks = 132 * 4;       // tiles in flight; more frames loop
constexpr int kMaxJoints = 32;
constexpr int kSweeps = 8;                // Jacobi sweeps (float64 converges in ~4)
constexpr int kTile = (kThreads + 1) * kMaxJoints * 3;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ double norm3(double x, double y, double z) {
  return sqrt(x * x + y * y + z * z);
}

// A unit vector orthogonal to the unit vector u (for rank-deficient frames).
__device__ void any_orthogonal(const double u[3], double out[3]) {
  const double ax = fabs(u[0]), ay = fabs(u[1]), az = fabs(u[2]);
  // cross(u, e) with e the axis u is least along
  if (ax <= ay && ax <= az) {
    out[0] = 0.0; out[1] = u[2]; out[2] = -u[1];
  } else if (ay <= az) {
    out[0] = -u[2]; out[1] = 0.0; out[2] = u[0];
  } else {
    out[0] = u[1]; out[1] = -u[0]; out[2] = 0.0;
  }
  const double len = norm3(out[0], out[1], out[2]);
  for (int i = 0; i < 3; ++i) out[i] /= len;
}

// Swaps columns k and l of a and v and negates the new column l of both, so v stays
// a proper rotation and a = H v still holds.
__device__ __forceinline__ void swap_columns(double a[3][3], double v[3][3], int k, int l) {
  for (int i = 0; i < 3; ++i) {
    const double ak = a[i][k], vk = v[i][k];
    a[i][k] = a[i][l];
    v[i][k] = v[i][l];
    a[i][l] = -ak;
    v[i][l] = -vk;
  }
}

// The best proper rotation r of the frame's cross-covariance a (maximising
// trace(r^T a)) and that maximum, the sum of the singular values with the smallest
// one reflected when the polar factor is improper.  a is overwritten.
__device__ double align_rotation(double a[3][3], double r[3][3]) {
  double v[3][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0;
      const int q = pair == 0 ? 1 : 2;
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
      for (int i = 0; i < 3; ++i) {
        alpha += a[i][p] * a[i][p];
        beta += a[i][q] * a[i][q];
        gamma += a[i][p] * a[i][q];
      }
      if (gamma == 0.0) continue;
      // The rotation that makes columns p and q orthogonal, by the smaller angle.
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t);
      const double s = c * t;
      for (int i = 0; i < 3; ++i) {
        const double ap = a[i][p], aq = a[i][q];
        a[i][p] = c * ap - s * aq;
        a[i][q] = s * ap + c * aq;
        const double vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - s * vq;
        v[i][q] = s * vp + c * vq;
      }
    }
  }
  // Columns of a = H v are now orthogonal, their norms the singular values: order
  // them by norm, largest first.
  double sig[3];
  for (int k = 0; k < 3; ++k) sig[k] = norm3(a[0][k], a[1][k], a[2][k]);
  for (int k = 0; k < 2; ++k) {
    for (int l = 2; l > k; --l) {
      if (sig[l] > sig[l - 1]) {
        swap_columns(a, v, l - 1, l);
        const double tmp = sig[l];
        sig[l] = sig[l - 1];
        sig[l - 1] = tmp;
      }
    }
  }
  // U = [u1, u2, u1 x u2], proper; the third singular value comes out signed.
  double u[3][3];
  if (sig[0] > 0.0) {
    for (int i = 0; i < 3; ++i) u[i][0] = a[i][0] / sig[0];
  } else {
    u[0][0] = 1.0; u[1][0] = 0.0; u[2][0] = 0.0;
  }
  double d = 0.0;
  for (int i = 0; i < 3; ++i) d += u[i][0] * a[i][1];
  double w[3];
  for (int i = 0; i < 3; ++i) w[i] = a[i][1] - d * u[i][0];
  const double wn = norm3(w[0], w[1], w[2]);
  if (wn > 1e-300 && wn > 1e-12 * sig[0]) {
    for (int i = 0; i < 3; ++i) u[i][1] = w[i] / wn;
  } else {
    const double u0[3] = {u[0][0], u[1][0], u[2][0]};
    double o[3];
    any_orthogonal(u0, o);
    for (int i = 0; i < 3; ++i) u[i][1] = o[i];
  }
  u[0][2] = u[1][0] * u[2][1] - u[2][0] * u[1][1];
  u[1][2] = u[2][0] * u[0][1] - u[0][0] * u[2][1];
  u[2][2] = u[0][0] * u[1][1] - u[1][0] * u[0][1];
  double total = sig[0];
  for (int k = 1; k < 3; ++k) {
    for (int i = 0; i < 3; ++i) total += u[i][k] * a[i][k];
  }
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      r[i][k] = u[i][0] * v[k][0] + u[i][1] * v[k][1] + u[i][2] * v[k][2];
    }
  }
  return total;
}

// The four protocol sums of one frame's joints (p, t: joints x 3 in shared memory,
// the target's root already zeroed; pn, tn the next frame's, or null for the last).
__device__ void frame_sums(const float* p, const float* t, const float* pn, const float* tn,
                           int joints, double acc[4]) {
  double mp[3] = {0.0, 0.0, 0.0}, mt[3] = {0.0, 0.0, 0.0};
  double tp = 0.0, pp = 0.0;
  for (int j = 0; j < joints; ++j) {
    const double px = p[3 * j], py = p[3 * j + 1], pz = p[3 * j + 2];
    const double tx = t[3 * j], ty = t[3 * j + 1], tz = t[3 * j + 2];
    acc[0] += norm3(px - tx, py - ty, pz - tz);
    tp += tx * px + ty * py + tz * pz;
    pp += px * px + py * py + pz * pz;
    mp[0] += px; mp[1] += py; mp[2] += pz;
    mt[0] += tx; mt[1] += ty; mt[2] += tz;
  }
  for (int i = 0; i < 3; ++i) {
    mp[i] /= joints;
    mt[i] /= joints;
  }
  const double scale = tp / pp;
  double h[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
  double pc2 = 0.0;
  for (int j = 0; j < joints; ++j) {
    double pc[3], ac[3];
    for (int i = 0; i < 3; ++i) {
      pc[i] = p[3 * j + i] - mp[i];
      ac[i] = t[3 * j + i] - mt[i];
    }
    acc[2] += norm3(scale * p[3 * j] - t[3 * j], scale * p[3 * j + 1] - t[3 * j + 1],
                    scale * p[3 * j + 2] - t[3 * j + 2]);
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 3; ++k) h[i][k] += pc[i] * ac[k];
    }
    pc2 += pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2];
  }
  double r[3][3];
  const double gain = align_rotation(h, r) / pc2;
  for (int j = 0; j < joints; ++j) {
    double pc[3], e[3];
    for (int i = 0; i < 3; ++i) pc[i] = p[3 * j + i] - mp[i];
    for (int k = 0; k < 3; ++k) {
      e[k] = gain * (pc[0] * r[0][k] + pc[1] * r[1][k] + pc[2] * r[2][k]) -
             (t[3 * j + k] - mt[k]);
    }
    acc[1] += norm3(e[0], e[1], e[2]);
  }
  if (pn != nullptr) {
    for (int j = 0; j < joints; ++j) {
      double e[3];
      for (int i = 0; i < 3; ++i) {
        e[i] = ((double)pn[3 * j + i] - p[3 * j + i]) - ((double)tn[3 * j + i] - t[3 * j + i]);
      }
      acc[3] += norm3(e[0], e[1], e[2]);
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

// Each block's four sums over its frames (in protocol order) into part[blockIdx.x].
__global__ void __launch_bounds__(kThreads) protocols_kernel(
    const float* __restrict__ pred, const float* __restrict__ target, int n, int joints,
    double* __restrict__ part) {
  __shared__ float sp[kTile], st[kTile];
  const int w = joints * 3;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (long long f0 = (long long)blockIdx.x * kThreads; f0 < n;
       f0 += (long long)gridDim.x * kThreads) {
    const long long left = n - f0;
    const int frames = left < kThreads + 1 ? (int)left : kThreads + 1;
    __syncthreads();
    for (int i = threadIdx.x; i < frames * w; i += kThreads) {
      sp[i] = pred[f0 * w + i];
      st[i] = i % w < 3 ? 0.0f : target[f0 * w + i];
    }
    __syncthreads();
    const int f = threadIdx.x;
    if (f < frames && f0 + f < n) {
      const bool next = f + 1 < frames;
      frame_sums(sp + f * w, st + f * w, next ? sp + (f + 1) * w : nullptr,
                 next ? st + (f + 1) * w : nullptr, joints, acc);
    }
  }
  for (int k = 0; k < 4; ++k) acc[k] = warp_sum(acc[k]);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) part[4 * blockIdx.x + k] = acc[k];
  }
}

// One warp: the blocks' sums, lane l taking blocks l, l + 32, ... in order, into the
// four means.
__global__ void __launch_bounds__(kThreads) protocols_reduce_kernel(
    const double* __restrict__ part, int blocks, int n, int joints, double* __restrict__ out) {
  double acc[4];
  for (int k = 0; k < 4; ++k) {
    double s = 0.0;
    for (int b = threadIdx.x; b < blocks; b += kThreads) s += part[4 * b + k];
    acc[k] = warp_sum(s);
  }
  if (threadIdx.x == 0) {
    const double frames = (double)n * joints;
    out[0] = acc[0] / frames;
    out[1] = acc[1] / frames;
    out[2] = acc[2] / frames;
    out[3] = acc[3] / ((double)(n - 1) * joints);
  }
}

}  // namespace

extern "C" {

// Enqueues the protocols of one video on `stream`, two launches: pred and target
// float32 (n, joints, 3) row-major (pred may hold more frames; the first n are read),
// part scratch of at least 4 * 528 float64 (kMaxBlocks rows of four sums), out four
// float64 means (MPJPE, P-MPJPE, N-MPJPE, MPJVE; MPJVE is NaN for n = 1).  Returns
// cudaGetLastError() after the launches (0 on success).
int vp3d_video_protocols(const void* pred, const void* target, int n, int joints,
                         void* part, void* out, void* stream) {
  if (n <= 0 || joints <= 0 || joints > kMaxJoints) return cudaErrorInvalidValue;
  const long long tiles = ((long long)n + kThreads - 1) / kThreads;
  const int grid = tiles < kMaxBlocks ? (int)tiles : kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  protocols_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(pred),
                                            static_cast<const float*>(target), n, joints,
                                            static_cast<double*>(part));
  protocols_reduce_kernel<<<1, kThreads, 0, s>>>(static_cast<const double*>(part), grid,
                                                 n, joints, static_cast<double*>(out));
  return cudaGetLastError();
}

}  // extern "C"
