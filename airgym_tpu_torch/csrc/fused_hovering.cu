// Env-only fused Hovering rollout (rate mode): T env steps under one
// constant remapped action in one launch, no observation and no policy.
//
// Replaces: airgym_tpu/ops/fused_hovering.py `_kernel` (wrapper
// `rollout_fused`). Per env and step: the PX4 rate PID + mixer + yaw
// desaturation on the constant action (thrust clipped to [0, 1]), optional
// motor lag, the 6-DoF physics with exp-map quaternion integration, the
// hovering reward summed over the steps, die / timeout, and the 12
// hash-RNG reset draws (counter 1..12 of each step's key). Rows 0:29 of
// the [40, N] state are read once and written once, rows 29:40 pass
// through, and the per-env reward sums [N] are written once.
//
// Bound on the card: a step is about 580 FP32 operations per env (counted
// by hand from quad_step.cuh, each division, square root and
// transcendental as one; the hash's integer work not counted): the
// controller ~140, the physics ~180, the reward with its polynomial acos /
// atan2 ~150, the reset's float math ~110. The bytes are 324 per env for
// all T steps (the state in and out, the reward sum). At T = 64 that is
// ~115 operations per byte, far above the H100's 20 FP32 operations per
// byte (67 TFLOP/s over 3.35 TB/s): the kernel is FP32 compute-bound.
// chip_smoke.py computes the bound from the shapes it runs.
//
// Design (simple first): one thread owns one env for all T steps, its 29
// state rows in registers (quad_step.cuh, shared with fused_rollout.cu);
// nothing is staged in shared memory. Blocks are 128 envs. The RNG
// reproduces the Pallas bits: tile and lane come from the env index.
//
// Left on the table: the transcendentals (sinf / cosf for the exp-map and
// the reset quaternion, expf and the polynomial atan2 in the reward) go
// through the full-range library calls; fast intrinsics would break
// parity with the reference.
#include "quad_step.cuh"

namespace {

using namespace airgym;

constexpr int BLOCK = 128;
constexpr float MAX_LEN_M1 = 2399.0f;          // 24 s / 0.01 - 1

__global__ void __launch_bounds__(BLOCK)
fused_hovering_kernel(const float* __restrict__ s_in, float a0, float a1,
                      float a2, float a3, float* __restrict__ s_out,
                      float* __restrict__ rew, int n, int steps, uint32_t seed,
                      float alpha, float one_m_alpha, int use_lag) {
  const int env = blockIdx.x * BLOCK + threadIdx.x;
  if (env >= n) return;
  const uint32_t base = tile_seed(seed, (uint32_t)env);
  const uint32_t lane = (uint32_t)env % kTile;

  Quad s;
  load_quad(s, s_in, n, env);
  const float thrust = clampf(a3, 0.0f, 1.0f);   // thrust_min, thrust_max
  float rew_sum = 0.0f;
  for (int step = 0; step < steps; ++step) {
    float c[4];
    control_physics<true>(s, a0, a1, a2, thrust, alpha, one_m_alpha, use_lag != 0, c);
    bool die;
    rew_sum = rew_sum + hover_reward(s, a0, a1, a2, a3, c, die);
    s.pa0 = a0; s.pa1 = a1; s.pa2 = a2; s.pa3 = a3;
    const float new_rstf = (die || s.prog >= MAX_LEN_M1) ? 1.0f : 0.0f;
    HashUniform draw(step_key(base, step), lane);
    float root[13];
    reset_root<kHovering>(draw, root);
    apply_reset(s, new_rstf, root);
  }
  store_quad(s, s_out, n, env);
  for (int i = NROWS; i < NF; ++i) s_out[(size_t)i * n + env] = s_in[(size_t)i * n + env];
  rew[env] = rew_sum;
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Returns a cudaError_t (0 = launched). Launches on `stream`, never syncs.
extern "C" int fused_hovering_launch(const float* s_in, float a0, float a1,
                                     float a2, float a3, float* s_out,
                                     float* rew, int n, int steps,
                                     unsigned int seed, float alpha,
                                     float one_m_alpha, int use_lag,
                                     void* stream) {
  if (n <= 0 || n % BLOCK != 0 || steps < 0) return (int)cudaErrorInvalidValue;
  fused_hovering_kernel<<<n / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      s_in, a0, a1, a2, a3, s_out, rew, n, steps, seed, alpha, one_m_alpha,
      use_lag);
  return (int)cudaGetLastError();
}
