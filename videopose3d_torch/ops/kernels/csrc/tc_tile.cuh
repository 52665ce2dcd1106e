// The 128 x 128 output tile of the evaluation stages' GEMM chains on mma.sync, which
// K3's bf16 GEMM (temporal_block.cu) and K4's int8 GEMMs (temporal_block_int8.cu)
// share: the kTcStages-deep cp.async ring over K tiles (stream_tc.cuh's stage layout,
// 8 warps of 64 x 32), the walk of a summed dimension over taps read in place, and
// the kernels' shared-memory opt-in.

#pragma once

#include "stream_tc.cuh"

namespace vp3d {

constexpr int kTile = 128;  // rows and columns of an output tile

// Where a summed-dimension column lies: tap j, column kin of the tap's kc.
struct TapPos {
  int j, kin;
  __device__ __forceinline__ void start(int kk, int kc) {
    j = kk / kc;
    kin = kk - j * kc;
  }
  __device__ __forceinline__ void step(int by, int kc) {
    kin += by;
    while (kin >= kc) {
      kin -= kc;
      ++j;
    }
  }
};

// Sets kernel Kern's dynamic shared memory and the whole carveout (two CUDA blocks of
// 75-82 KB share an SM only with it), once per device (one instance per kernel).
template <auto Kern>
cudaError_t configure(size_t smem) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev >= 0 && dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

// acc = the sum over q_n K tiles of this warp's part of A @ B: load(stage) starts the
// copies of the next K tile into `stage`, and the tiles go through the kTcStages-deep
// ring at `stages` (G::STAGE bytes each).  Every thread of the CUDA block calls it.
template <typename Op, typename G, typename Load>
__device__ __forceinline__ void tile_mma_loop(typename Op::Acc (&acc)[G::MT][G::NT8][4],
                                              char* stages, int q_n, Load&& load) {
  constexpr int ST = kTcStages;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < q_n) load(stages + s * G::STAGE);
    cp_async_commit();
  }
  int load_at = ST - 1, use_at = 0;
  for (int q = 0; q < q_n; ++q) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage q landed; every warp is done with stage q - 1
    if (q + ST - 1 < q_n) load(stages + load_at * G::STAGE);
    cp_async_commit();
    load_at = load_at + 1 == ST ? 0 : load_at + 1;
    Op::template mma_stage<G>(acc, stages + use_at * G::STAGE);
    use_at = use_at + 1 == ST ? 0 : use_at + 1;
  }
  cp_async_wait<0>();
}

}  // namespace vp3d
