// Env-only fused Hovering rollout (rate mode): T env steps under one
// constant remapped action in one launch, no observation and no policy.
//
// Replaces: airgym_tpu/ops/fused_hovering.py `_kernel` (wrapper
// `rollout_fused`). Per env and step: the PX4 rate PID + mixer + yaw
// desaturation on the constant action (thrust clipped to [0, 1]), optional
// motor lag, the 6-DoF physics with exp-map quaternion integration, the
// hovering reward summed over the steps, die / timeout, and where an env
// resets its 12 hash-RNG draws (counter 1..12 of each step's key) and the
// reset mix. Rows 0:29 of the [40, N] state are read once and written
// once, rows 29:40 pass through, and the per-env reward sums [N] are
// written once.
//
// Bound on the card: FP32 operations, counted by hand from this source
// and quad_step.cuh (each add, multiply, division, square root,
// transcendental, comparison, minimum, maximum and int-to-float
// conversion as one; the hash's integer work not counted): every env-step
// 452 (controller 138, physics 177, the reward without its action terms
// 136, the time-out test 1; the motor lag adds 12), each reset 137 (12
// draws, quat_from_euler, the mix), each env 57 once (the reward's action
// terms). The bytes are 236 per env for all T steps. At T = 64 that is
// ~120 operations per byte against the H100's 20 (67 TFLOP/s over 3.35
// TB/s): FP32 compute-bound. kernels/hovering_ab.py and chip_smoke.py
// compute the bound from the resets their runs make.
//
// What bounds it in fact is the issue rate. At 64 registers 8 blocks of
// 128 threads fit an SM, so 131,072 envs run in one wave at ~7.8 warps per
// scheduler. The parent design drew and mixed a reset for every env and
// step: its loop issued 1,066 hot SASS instructions per step (IEEE
// division and square root ~10 each with their slow-path guards,
// full-range sinf / cosf ~25 each, 12 hash draws of ~14 integer
// instructions), and a warp's step took the 8,200-8,700 cycles that 7.8
// warps x 1,066 instructions take to issue: the schedulers issued every
// cycle. So this design issues fewer instructions and keeps every
// rounding:
//   - one thread owns one env for all T steps, its state rows in
//     registers (quad_step.cuh, shared with fused_rollout.cu); blocks of
//     128 capped at 64 registers (__launch_bounds__(128, 8)): one wave;
//   - the reset work (the 12 draws, quat_from_euler and the mix: 366 hot
//     instructions) runs only in a warp where some env resets
//     (__any_sync), with the draws' keys and counters unchanged, so a
//     resetting env gets the root it got before; skipping the mix where
//     keep = 1 could change only the sign of a zero;
//   - the reward's action terms, fixed by the constant action and the
//     previous one, are computed once: after step 0 the previous action is
//     the action itself, or zero after a reset (only squares of the
//     differences enter, so the sign of that zero does not matter);
// The loop now issues 676 hot instructions per step (the motor-lag branch
// included, which a run without lag skips), and the reset block in 29.5%
// of warp-steps under a climbing action (every env leaves the box in 64
// steps) and 8.2% under bench.py's near-hover one over 8,000 steps:
// 0.41-0.42 -> 0.32-0.33 ms at 131,072 x 64 climbing and 43.0-43.3 ->
// 29.4-29.7 ms at 131,072 x 8,000 hovering, in turns, the output bit for
// bit the parent's (kernels/hovering_ab.py on an H100 80GB HBM3 at 700 W;
// PERF.md). sincosf
// gives the bits of sinf / cosf on all 2^32 inputs and would save 3%, but
// nvcc then contracts other products into FMAs: 0.9-1.6 M of the 5.4 M
// output elements change, so the separate calls stay.
// The RNG reproduces the Pallas bits: tile and lane come from the env
// index. Fast intrinsics, reciprocal multiplies and a different FMA
// contraction would change the rounding and stay out.
#include "quad_step.cuh"

namespace {

using namespace airgym;

constexpr int BLOCK = 128;
constexpr int MIN_BLOCKS = 8;        // per SM at <= 64 registers: one wave
constexpr unsigned FULL = 0xffffffffu;
constexpr float MAX_LEN_M1 = 2399.0f;          // 24 s / 0.01 - 1

#ifdef AIRGYM_HOVER_CLOCKS
// [0..3] cycles of thread 0 of every block in control + physics, the
// reward with the die / time-out test, the reset draws + quat_from_euler
// and the reset mix; [4] warp-steps that ran the reset work; [5] resets
// (envs x steps); [6] cycles of thread 0 of every block from its start to
// its end
__device__ unsigned long long g_hover_counts[7];
#define HOVER_CLOCK(var) const long long var = clock64()
#define HOVER_COUNT(i, x) counts[i] += (unsigned long long)(x)
#else
#define HOVER_CLOCK(var)
#define HOVER_COUNT(i, x)
#endif

// n is a multiple of BLOCK, so every warp is whole: the vote needs all 32
// lanes.
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
fused_hovering_kernel(const float* __restrict__ s_in, float a0, float a1,
                      float a2, float a3, float* __restrict__ s_out,
                      float* __restrict__ rew, int n, int steps, uint32_t seed,
                      float alpha, float one_m_alpha, int use_lag) {
  HOVER_CLOCK(t_start);
#ifdef AIRGYM_HOVER_CLOCKS
  unsigned long long counts[6] = {0, 0, 0, 0, 0, 0};
#endif
  const int env = blockIdx.x * BLOCK + threadIdx.x;
  const uint32_t base = tile_seed(seed, (uint32_t)env);
  const uint32_t lane = (uint32_t)env % kTile;

  Quad s;
  load_quad(s, s_in, n, env);
  const float thrust = clampf(a3, 0.0f, 1.0f);   // thrust_min, thrust_max
  const float thrust_r = thrust_reward(a3);
  const float cont_kept = cont_reward(a0, a1, a2, a3, a0, a1, a2, a3);
  const float cont_reset = cont_reward(a0, a1, a2, a3, 0.0f, 0.0f, 0.0f, 0.0f);
  float cont_r = cont_reward(a0, a1, a2, a3, s.pa0, s.pa1, s.pa2, s.pa3);
  float rew_sum = 0.0f;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    HOVER_CLOCK(c0);
    float c[4];
    control_physics<true>(s, a0, a1, a2, thrust, alpha, one_m_alpha, use_lag != 0, c);
    HOVER_CLOCK(c1);
    bool die;
    rew_sum = rew_sum + hover_reward(s, cont_r, thrust_r, c, die);
    const bool reset = die || s.prog >= MAX_LEN_M1;
    s.pa0 = a0; s.pa1 = a1; s.pa2 = a2; s.pa3 = a3;
    s.rstf = reset ? 1.0f : 0.0f;
    HOVER_CLOCK(c2);
    HOVER_COUNT(0, c1 - c0);
    HOVER_COUNT(1, c2 - c1);
    HOVER_COUNT(5, reset);
    if (__any_sync(FULL, reset)) {
      HashUniform draw(step_key(base, step), lane);
      float root[13];
      reset_root<kHovering>(draw, root);
      HOVER_CLOCK(c3);
      apply_reset(s, s.rstf, root);
      HOVER_CLOCK(c4);
      HOVER_COUNT(2, c3 - c2);
      HOVER_COUNT(3, c4 - c3);
      HOVER_COUNT(4, threadIdx.x % 32 == 0);
    }
    cont_r = reset ? cont_reset : cont_kept;
  }
  store_quad(s, s_out, n, env);
  for (int i = NROWS; i < NF; ++i) s_out[(size_t)i * n + env] = s_in[(size_t)i * n + env];
  rew[env] = rew_sum;
#ifdef AIRGYM_HOVER_CLOCKS
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) atomicAdd(&g_hover_counts[i], counts[i]);
    atomicAdd(&g_hover_counts[6], (unsigned long long)(clock64() - t_start));
  }
  if (threadIdx.x % 32 == 0) atomicAdd(&g_hover_counts[4], counts[4]);
  atomicAdd(&g_hover_counts[5], counts[5]);
#endif
}

#ifdef AIRGYM_HOVER_CLOCKS
__device__ unsigned long long g_sincos_mismatches;

// Every float bit pattern: does sincosf give the bits of sinf and cosf?
// (NaN against NaN counts as equal.)
__global__ void sincos_check_kernel() {
  auto same = [](float a, float b) {
    return __float_as_uint(a) == __float_as_uint(b) || (isnan(a) && isnan(b));
  };
  unsigned long long bad = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float((uint32_t)i);
    float sn, cs;
    sincosf(x, &sn, &cs);
    bad += !same(sn, sinf(x)) || !same(cs, cosf(x));
  }
  atomicAdd(&g_sincos_mismatches, bad);
}
#endif

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
  AIRGYM_LAUNCH(fused_hovering_kernel, n / BLOCK, BLOCK, 0, (cudaStream_t)stream,
                s_in, a0, a1, a2, a3, s_out, rew, n, steps, seed, alpha,
                one_m_alpha, use_lag);
  return (int)cudaGetLastError();
}

// The launch at n envs on the current card: out[0..4] = threads per
// block, blocks, resident blocks per SM (the occupancy calculator's),
// registers per thread, local memory bytes per thread.
extern "C" int fused_hovering_shape(int n, int* out) {
  if (n <= 0 || n % BLOCK != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fused_hovering_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = BLOCK;
  out[1] = n / BLOCK;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fused_hovering_kernel, BLOCK, 0);
}

#ifdef AIRGYM_HOVER_CLOCKS
// Reads and zeroes the seven counters (g_hover_counts).
extern "C" int fused_hovering_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_hover_counts, sizeof(g_hover_counts));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_hover_counts, zero, sizeof(zero));
}

// The float bit patterns where sincosf differs from sinf / cosf; syncs.
extern "C" int fused_hovering_sincos_mismatches(unsigned long long* out) {
  const unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyToSymbol(g_sincos_mismatches, &zero, sizeof(zero));
  if (err != cudaSuccess) return (int)err;
  sincos_check_kernel<<<1056, 256>>>();
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, g_sincos_mismatches, sizeof(zero));
}
#endif
