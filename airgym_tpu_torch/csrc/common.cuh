// Device functions shared by the port's kernels: the counter-based hash
// RNG, the euler -> quaternion helper and the polynomial transcendentals.
//
// They reproduce airgym_tpu/ops/fused_hovering.py (_mix, _make_uniform,
// _quat_from_euler) and airgym_tpu/ops/transcendental.py bit for bit where
// the arithmetic is integer (the RNG) and to float32 rounding elsewhere.
// The env step built on them is quad_step.cuh.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace airgym {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr uint32_t kTile = 1024u;  // envs per Pallas tile: the RNG's unit

// murmur3-style 32-bit finalizer
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Per-tile seed: the Pallas grid cell is a 1024-env tile, so the tile
// comes from the env index, whatever the CUDA block is.
__device__ __forceinline__ uint32_t tile_seed(uint32_t seed, uint32_t env) {
  return seed + (env / kTile) * 0x01000193u;
}

__device__ __forceinline__ uint32_t step_key(uint32_t base, int step) {
  return base ^ ((uint32_t)(step + 1) * 0x9E3779B1u);
}

// Uniform draws in [0, 1) for one env at one step; the counter restarts
// at 1 for every step key.
struct HashUniform {
  uint32_t key_part, lane_part, counter;
  __device__ __forceinline__ HashUniform(uint32_t key, uint32_t lane)
      : key_part(key * 0x9E3779B9u), lane_part(lane + 0x85EBCA6Bu),
        counter(0u) {}
  __device__ __forceinline__ float operator()() {
    counter += 1u;
    const uint32_t bits = mix32(key_part ^ lane_part ^ (counter * 0xC2B2AE35u));
    return (float)(int)(bits >> 1) * (1.0f / 2147483648.0f);
  }
};

// Box-Muller, cosine branch only: two draws per normal
__device__ __forceinline__ float normal(HashUniform& draw) {
  const float u1 = fminf(fmaxf(draw(), 1e-7f), 1.0f);
  const float u2 = draw();
  return sqrtf(-2.0f * logf(u1)) * cosf((float)(2.0 * 3.14159265358979323846) * u2);
}

// Intrinsic XYZ euler -> xyzw quaternion: q = qx(a) * qy(b) * qz(c)
__device__ __forceinline__ void quat_from_euler(float ax, float ay, float az,
                                                float& qx, float& qy,
                                                float& qz, float& qw) {
  const float cx = cosf(ax * 0.5f), sx = sinf(ax * 0.5f);
  const float cy = cosf(ay * 0.5f), sy = sinf(ay * 0.5f);
  const float cz = cosf(az * 0.5f), sz = sinf(az * 0.5f);
  const float x1 = sx * cy, y1 = cx * sy, z1 = sx * sy, w1 = cx * cy;
  qx = x1 * cz + y1 * sz;
  qy = y1 * cz - x1 * sz;
  qz = w1 * sz + z1 * cz;
  qw = w1 * cz - z1 * sz;
}

// atan: 11th-order odd minimax polynomial on [-1, 1] with the |x| > 1
// range reduction (Abramowitz-Stegun 4.4.49 family)
__device__ __forceinline__ float poly_atan(float x) {
  const float ax = fabsf(x);
  const bool inv = ax > 1.0f;
  const float z = inv ? 1.0f / fmaxf(ax, 1e-30f) : ax;
  const float z2 = z * z;
  const float p = z * (0.99997726f + z2 * (-0.33262347f + z2 * (0.19354346f
                  + z2 * (-0.11643287f + z2 * (0.05265332f
                  + z2 * -0.01172120f)))));
  const float r = inv ? kHalfPi - p : p;
  return x > 0.0f ? r : (x < 0.0f ? -r : 0.0f * r);
}

// quadrant-correct atan2 (atan2(0, -1) = pi, as numpy)
__device__ __forceinline__ float poly_atan2(float y, float x) {
  const bool tiny = fabsf(x) < 1e-30f;
  const float base = poly_atan(y / (tiny ? 1e-30f : x));
  const float r = x < 0.0f ? base + (y < 0.0f ? -kPi : kPi) : base;
  return tiny ? (y >= 0.0f ? kHalfPi : -kHalfPi) : r;
}

// 1 - x*x without an FMA contraction, as the plain version rounds it
__device__ __forceinline__ float one_minus_sq(float x) {
  return fmaxf(__fsub_rn(1.0f, __fmul_rn(x, x)), 0.0f);
}

__device__ __forceinline__ float poly_asin(float x) {
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  return poly_atan2(x, sqrtf(one_minus_sq(x)));
}

__device__ __forceinline__ float poly_acos(float x) {
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  return poly_atan2(sqrtf(one_minus_sq(x)), x);
}

}  // namespace airgym

// Each shared library exports its own error-string lookup for ctypes.
#define AIRGYM_EXPORT_ERROR_STRING                                  \
  extern "C" const char* airgym_error_string(int err) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(err));      \
  }
