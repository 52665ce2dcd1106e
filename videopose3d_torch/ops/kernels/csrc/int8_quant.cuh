// The int8 stream's rounding and scale constants, shared by the w8a8 evaluation
// stages (temporal_block_int8.cu) and the fused int8 streaming step (stream_int8.cu).

#pragma once

#include <stdint.h>

namespace vp3d {

constexpr float kQmax = 127.0f;
constexpr float kInvQmax = static_cast<float>(1.0 / 127.0);  // torch's f32(1.0 / QMAX)

// clip(rint(v), 0, 127) as int8: the int8 stream's rounding (half to even, as torch.round).
__device__ __forceinline__ int8_t to_stream(float v) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(v), 0.f), kQmax)));
}

}  // namespace vp3d
