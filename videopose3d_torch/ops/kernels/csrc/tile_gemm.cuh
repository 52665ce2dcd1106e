// The row-tile geometry of the int8 stage kernels' dp4a GEMM (int8_gemm.cuh): a
// CUDA block of NT=256 threads owns TM=16 rows and up to NP=1024 output columns per
// pass, CPT=4 columns per thread (col0 + tid + q*256), strided so that every weight
// load of a warp is one contiguous 128-byte line.

#pragma once

#include "common.cuh"

namespace vp3d {

constexpr int TM = 16;            // rows of A per CUDA block
constexpr int CPT = 4;            // output columns per thread per pass
constexpr int NP = NT * CPT;      // output columns per pass

}  // namespace vp3d
