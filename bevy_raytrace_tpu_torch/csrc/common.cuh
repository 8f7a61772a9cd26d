// Device helpers shared by the port's CUDA kernels.
//
// CUDA counterparts of kernels/common.py (and of the helpers the JAX
// package's Pallas kernels use): PCG4D in native uint32_t arithmetic,
// the 24-bit unit-float map, the guarded rsqrt and the positive cube root.
// Keep the two in step: the kernels' plain PyTorch twins use the Python side.
#pragma once

#include <cstdint>

namespace brt {

// RNG stream of camera-ray generation; bounce events use stream = bounce.
constexpr uint32_t CAMERA_STREAM = 0x9E3779B9u;
constexpr float TWO_PI = 6.28318530717958647692f;  // rounds to float32(2*pi)
constexpr float INV_2POW24 = 1.0f / 16777216.0f;

__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w) {
  const uint32_t mul = 1664525u, add = 1013904223u;
  x = x * mul + add;
  y = y * mul + add;
  z = z * mul + add;
  w = w * mul + add;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return static_cast<float>(bits >> 8) * INV_2POW24;
}

__device__ __forceinline__ float rsqrt_guard(float n2) {
  return rsqrtf(fmaxf(n2, 1e-20f));
}

__device__ __forceinline__ float cbrt_pos(float v) {
  return v < 1e-30f ? 0.0f : expf(logf(fmaxf(v, 1e-30f)) * (1.0f / 3.0f));
}

}  // namespace brt
