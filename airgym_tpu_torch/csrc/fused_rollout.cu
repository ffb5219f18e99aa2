// Fused PPO rollout (rate mode): policy + env for the whole horizon in one
// launch. One source, three instances: Hovering, Balloon and Tracking.
//
// Replaces: airgym_tpu/ops/fused_rollout.py `_kernel` with task="hovering",
// "balloon" and "tracking" (wrapper `rollout_fused_policy`). Per env and
// step: the observation (18 state features with hash-RNG Box-Muller noise;
// Tracking adds 10 closed-form lemniscate points relative to the drone,
// noise-free), (x - mean) * istd clipped to +-5, the [64,128,64] elu MLP
// to mu and value, the Gaussian sample and neglogp, clamp + remap (body
// rates +-6, Balloon +-1), the PX4 rate PID + mixer + yaw desaturation,
// optional motor lag, the 6-DoF physics with exp-map quaternion
// integration, the task's reward and kill rules, die / timeout, and the
// hash-RNG reset in the task's distribution. Each step streams a record
// [H, OBS + 13, N]; the [40, N] state is read once and written once.
//
// Bound on the card: the MLP is 17,856 MAC per env-step at 18 features
// and 19,776 at 48, in float32 (parity with the reference rules out
// TF32). Hovering (4096 envs x 24 steps) 3.51 GFLOP, 52 us at the H100's
// 67 TFLOP/s of FP32; Balloon (4096 x 32) 4.68 GFLOP, 70 us; Tracking
// (4096 x 24) 3.89 GFLOP, 58 us. The bytes are the record plus the state
// in and out (13.6 / 17.6 / 25.3 MB, 4-8 us at 3.35 TB/s). So each
// instance is FP32 compute-bound.
//
// Design: a block owns E = 16 envs and runs 8 warps (256 threads); two
// blocks share an SM (256 blocks at 4096 envs, 91-101 KB of shared memory
// each), so that one block's env step overlaps the other's MLP. E = 32
// (one block per SM) was as fast for Hovering and Balloon and 15% slower
// for Tracking (airgym_tpu_torch/kernels/rollout_ab.py on an H100). The
// weights are staged once per block in shared memory, k-major (W^T),
// beside the activation columns X [OBS][E], H0 [64][E], H1 [128][E] and
// H2 [64][E]. Per step, one __syncthreads between phases:
//   (a) threads 0..E-1, one per env, build the observation with its noise
//       draws, write it to the record and its normalized value to X;
//   (b) all 256 threads run each layer as a register tile of 4 neurons x
//       TE envs (TE = 2 for layer 1, 1 for layers 0 and 2): per k one
//       float4 of W^T and TE activations, then 4 x TE independent FMAs;
//       4 x 4 tiles on 64-128 threads (fewer shared-memory loads per FMA)
//       were slower: the layers are latency-bound, not load-bound;
//   (c) threads 0..5E-1 each sum one head output (mu 0..3 or the value);
//   (d) threads 0..E-1 sample, run the controller, physics, reward and
//       kill rules, the rest of the record and the reset.
// Each output is summed over k in ascending order in one float32
// accumulator with FMAs, the bias added after the sum, then elu: the
// arithmetic of the one-thread-per-env kernel this replaced. Its mu,
// value and neglogp agree with that kernel's to the bit where the
// observation does; the env step's source is unchanged, but nvcc fuses
// some of its a * b + c * d terms into FMAs differently in the two
// kernels, so later steps differ in the last bits (PERF.md, section 6). No
// tensor cores: a step's MLP is ~0.29 M MAC per block, ~2.2 us at one
// SM's SIMT FP32 peak, the order of the env step; TF32 breaks the float32
// gates, and 3xTF32 mma.sync would triple the work of a unit that is not
// the limit. The RNG reproduces the Pallas bits: tile = env / 1024 and
// lane = env % 1024 come from the env index, not from the CUDA block;
// only the env thread draws, 36 noise uniforms, 8 for the sample, then 12
// reset draws (Balloon 15) per step.
//
// What bounds it now: phases (a) and (d) run on 16 threads of one warp
// while the block's other warps wait at the barrier, and the MLP phases
// are latency-bound at 8 warps a block. Built with
// -DAIRGYM_ROLLOUT_CLOCKS, thread 0 of each block adds its cycles in (a),
// (b) + (c) and (d) to three device counters
// (fused_rollout_phase_cycles); chip_smoke.py prints the split. On an
// H100 a Hovering block's step took ~28k cycles: 29% observation (18 noise
// normals, serial in the env thread), 51% MLP + heads, 20% env step
// (Balloon 29 / 50 / 21%; Tracking, with its 10 reference points, 39 / 44
// / 17% of ~35k), at 0.43 / 0.56 / 0.54 ms per rollout, 8-9x the bound.
// Left for later: the draws that do not depend on the state (the noise
// normals, the sample's eps, the reset root) computed by the idle warps
// from their counters; the env step spread over more threads (its body
// is fused_hovering.cu's too); 3xTF32 mma.sync for the MLP should it set
// the pace again.
#include "quad_step.cuh"

namespace {

using namespace airgym;

constexpr int ACT = 4, H0 = 64, H1 = 128, H2 = 64;
constexpr int NT = 256;           // threads per block: 8 warps
constexpr int E = 16;             // envs per block; two blocks per SM
constexpr int TN = 4;             // neurons per thread in a layer's tile
constexpr int HD = 8;             // head columns of W^T: mu 0..3, value 4

#ifdef AIRGYM_ROLLOUT_CLOCKS
__device__ unsigned long long g_phase_cycles[3];
#endif

template <int TASK>
struct Cfg {
  static constexpr int OBS = TASK == kTracking ? 48 : 18;
  static constexpr int REC = OBS + 13;
  static constexpr int ROWS = TASK == kBalloon ? 35 : NROWS;  // rows the step owns
  // episode length (8 / 24 / 36 s at dt 0.01) - 1
  static constexpr float MAX_LEN_M1 =
      TASK == kHovering ? 2399.0f : (TASK == kBalloon ? 799.0f : 3599.0f);
  static constexpr float RATE_LIM = TASK == kBalloon ? 1.0f : 6.0f;
  // flat PolicyPack offsets (airgym_tpu_torch/ops/fused_rollout.py)
  static constexpr int O_W0 = 0;
  static constexpr int O_B0 = O_W0 + H0 * OBS;
  static constexpr int O_W1 = O_B0 + H0;
  static constexpr int O_B1 = O_W1 + H1 * H0;
  static constexpr int O_W2 = O_B1 + H1;
  static constexpr int O_B2 = O_W2 + H2 * H1;
  static constexpr int O_WMU = O_B2 + H2;
  static constexpr int O_BMU = O_WMU + ACT * H2;
  static constexpr int O_WV = O_BMU + ACT;
  static constexpr int O_BV = O_WV + H2;
  static constexpr int O_LOGSTD = O_BV + 1;
  static constexpr int O_MEAN = O_LOGSTD + ACT;
  static constexpr int O_ISTD = O_MEAN + OBS;
  // shared memory (floats): k-major weights, biases, obs stats, then the
  // activation columns and the heads' outputs
  static constexpr int S_W0T = 0;                   // [OBS][H0]
  static constexpr int S_W1T = S_W0T + OBS * H0;    // [H0][H1]
  static constexpr int S_W2T = S_W1T + H0 * H1;     // [H1][H2]
  static constexpr int S_WHT = S_W2T + H1 * H2;     // [H2][HD]
  static constexpr int S_B0 = S_WHT + H2 * HD;
  static constexpr int S_B1 = S_B0 + H0;
  static constexpr int S_B2 = S_B1 + H1;
  static constexpr int S_BH = S_B2 + H2;            // bmu 0..3, bv 4
  static constexpr int S_LOGSTD = S_BH + HD;
  static constexpr int S_MEAN = S_LOGSTD + ACT;
  static constexpr int S_ISTD = S_MEAN + OBS;
  static constexpr int S_X = (S_ISTD + OBS + 3) / 4 * 4;  // [OBS][E]
  static constexpr int S_H0 = S_X + OBS * E;        // [H0][E]
  static constexpr int S_H1 = S_H0 + H0 * E;        // [H1][E]
  static constexpr int S_H2 = S_H1 + H1 * E;        // [H2][E]
  static constexpr int S_OUT = S_H2 + H2 * E;       // [ACT + 1][E]
  static constexpr size_t SMEM_BYTES = (S_OUT + (ACT + 1) * E) * sizeof(float);
  static_assert(S_W1T % 4 == 0 && S_W2T % 4 == 0 && S_WHT % 4 == 0
                && S_H0 % 4 == 0 && S_H1 % 4 == 0 && S_H2 % 4 == 0,
                "float4 rows");
  static_assert(2 * (SMEM_BYTES + 1024) <= 233472, "two blocks per SM");
};

__device__ __forceinline__ float elu(float z) {
  return z > 0.0f ? z : expf(fminf(z, 0.0f)) - 1.0f;
}

// dst[c * ld + r] = src[r * cols + c]: a row-major [rows][cols] matrix
// staged k-major, the block's threads reading it in order
__device__ __forceinline__ void stage_t(float* dst, const float* __restrict__ src,
                                        int rows, int cols, int ld) {
  for (int i = threadIdx.x; i < rows * cols; i += NT)
    dst[(i % cols) * ld + i / cols] = src[i];
}

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count; i += NT) dst[i] = src[i];
}

// TE (1 or 2) consecutive floats of an activation row
template <int TE>
__device__ __forceinline__ void load_cols(const float* p, float v[TE]) {
  if constexpr (TE == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// y[OUT][E] = elu(W x + b) from x[K][E] and wt = W^T [K][OUT]: each thread
// owns 4 neurons x TE envs, summed over k in ascending order
template <int K, int OUT>
__device__ __forceinline__ void dense_elu(const float* wt, const float* b,
                                          const float* x, float* y) {
  constexpr int TE = OUT * E / (NT * TN);
  constexpr int EG = E / TE;                        // env groups
  static_assert((TE == 1 || TE == 2) && EG * TE == E && (OUT / TN) * EG == NT,
                "the tile covers the layer");
  const int e0 = (threadIdx.x % EG) * TE;
  const int j0 = (threadIdx.x / EG) * TN;
  float acc[TN][TE];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int j = 0; j < TE; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 w = *reinterpret_cast<const float4*>(wt + k * OUT + j0);
    float xv[TE];
    load_cols<TE>(x + k * E + e0, xv);
#pragma unroll
    for (int j = 0; j < TE; ++j) {
      acc[0][j] = fmaf(w.x, xv[j], acc[0][j]);
      acc[1][j] = fmaf(w.y, xv[j], acc[1][j]);
      acc[2][j] = fmaf(w.z, xv[j], acc[2][j]);
      acc[3][j] = fmaf(w.w, xv[j], acc[3][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const float bias = b[j0 + i];
#pragma unroll
    for (int j = 0; j < TE; ++j) y[(j0 + i) * E + e0 + j] = elu(acc[i][j] + bias);
  }
}

#ifdef AIRGYM_ROLLOUT_CLOCKS
#define AIRGYM_CLOCK(var) const long long var = clock64()
#else
#define AIRGYM_CLOCK(var)
#endif

template <int TASK>
__global__ void __launch_bounds__(NT, 2)
fused_rollout_kernel(const float* __restrict__ s_in,
                     const float* __restrict__ weights,
                     float* __restrict__ s_out, float* __restrict__ rec,
                     int n, int steps, uint32_t seed, int obs_noise,
                     float alpha, float one_m_alpha, int use_lag) {
  using C = Cfg<TASK>;
  constexpr int OBS = C::OBS;
  AIRGYM_DYN_SMEM(sm);
  float* w = sm;
  float* xs = sm + C::S_X;
  float* hout = sm + C::S_OUT;
  stage_t(w + C::S_W0T, weights + C::O_W0, H0, OBS, H0);
  stage_t(w + C::S_W1T, weights + C::O_W1, H1, H0, H1);
  stage_t(w + C::S_W2T, weights + C::O_W2, H2, H1, H2);
  stage_t(w + C::S_WHT, weights + C::O_WMU, ACT, H2, HD);
  stage_t(w + C::S_WHT + ACT, weights + C::O_WV, 1, H2, HD);
  stage(w + C::S_B0, weights + C::O_B0, H0);
  stage(w + C::S_B1, weights + C::O_B1, H1);
  stage(w + C::S_B2, weights + C::O_B2, H2);
  stage(w + C::S_BH, weights + C::O_BMU, ACT);
  stage(w + C::S_BH + ACT, weights + C::O_BV, 1);
  stage(w + C::S_LOGSTD, weights + C::O_LOGSTD, ACT);
  stage(w + C::S_MEAN, weights + C::O_MEAN, OBS);
  stage(w + C::S_ISTD, weights + C::O_ISTD, OBS);
  __syncthreads();

  // threads 0..E-1 own one env each; every thread reaches every barrier
  const int t = threadIdx.x;
  const bool env_thread = t < E;
  const int env = blockIdx.x * E + (env_thread ? t : 0);
  const uint32_t base = tile_seed(seed, (uint32_t)env);
  const uint32_t lane = (uint32_t)env % kTile;

  Quad s;
  // Balloon: balloon position (rows 29:32) and pre_root_pos (32:35)
  float bx = 0.0f, by = 0.0f, bz = 0.0f, ppx = 0.0f, ppy = 0.0f, ppz = 0.0f;
  if (env_thread) {
    load_quad(s, s_in, n, env);
    if constexpr (TASK == kBalloon) {
      bx = s_in[29 * (size_t)n + env]; by = s_in[30 * (size_t)n + env];
      bz = s_in[31 * (size_t)n + env]; ppx = s_in[32 * (size_t)n + env];
      ppy = s_in[33 * (size_t)n + env]; ppz = s_in[34 * (size_t)n + env];
    }
  }

  float sig[ACT];
#pragma unroll
  for (int k = 0; k < ACT; ++k) sig[k] = expf(w[C::S_LOGSTD + k]);
  const float lsum = ((w[C::S_LOGSTD] + w[C::S_LOGSTD + 1]) + w[C::S_LOGSTD + 2])
                     + w[C::S_LOGSTD + 3];
  const float nlp_c = (float)(0.5 * 1.8378770664093453 * ACT);  // 0.5 log(2 pi) A
#ifdef AIRGYM_ROLLOUT_CLOCKS
  long long cyc_obs = 0, cyc_mlp = 0, cyc_env = 0;
#endif

  for (int step = 0; step < steps; ++step) {
    AIRGYM_CLOCK(c0);
    HashUniform draw(step_key(base, step), lane);
    float* r = rec + (size_t)step * C::REC * n + env;

    // ---- (a) observation: each feature to the record, normalized into X ----
    if (env_thread) {
      auto feed = [&](int k, float x) {
        r[(size_t)k * n] = x;
        xs[k * E + t] = clampf((x - w[C::S_MEAN + k]) * w[C::S_ISTD + k], -5.0f, 5.0f);
      };
      {
        // rotation matrix (minus identity, but for Tracking), pos (relative
        // to the balloon for Balloon), vel, angvel
        const float diag = TASK == kTracking ? 0.0f : 1.0f;
        const float qx = s.qx, qy = s.qy, qz = s.qz, qw = s.qw;
        float x[18];
        x[0] = (1.0f - 2.0f * (qy * qy + qz * qz)) - diag;
        x[1] = 2.0f * (qx * qy - qw * qz);
        x[2] = 2.0f * (qx * qz + qw * qy);
        x[3] = 2.0f * (qx * qy + qw * qz);
        x[4] = (1.0f - 2.0f * (qx * qx + qz * qz)) - diag;
        x[5] = 2.0f * (qy * qz - qw * qx);
        x[6] = 2.0f * (qx * qz - qw * qy);
        x[7] = 2.0f * (qy * qz + qw * qx);
        x[8] = (1.0f - 2.0f * (qx * qx + qy * qy)) - diag;
        x[9] = s.px - bx; x[10] = s.py - by; x[11] = s.pz - bz;
        x[12] = s.vx; x[13] = s.vy; x[14] = s.vz;
        x[15] = s.wx; x[16] = s.wy; x[17] = s.wz;
#pragma unroll
        for (int i = 0; i < 18; ++i) {
          const float scale = i < 9 ? 1e-3f : (i < 12 ? 5e-3f : (i < 15 ? 2e-2f : 4e-1f));
          feed(i, obs_noise ? x[i] + scale * normal(draw) : x[i]);
        }
      }
      if constexpr (TASK == kTracking) {
        // 10 future reference points (traj_scale 0.25, stride 5) at the
        // progress before this step's increment
#pragma unroll
        for (int i = 0; i < 10; ++i) {
          const float t_ref = (s.prog + (float)(i * 5)) * (float)(DT * 0.25);
          float st, ct;
          sincosf(t_ref, &st, &ct);
          const float den = 1.0f + ct * ct;
          feed(18 + 3 * i, 3.0f * st / den - s.px);
          feed(19 + 3 * i, 3.0f * st * ct / den - s.py);
          feed(20 + 3 * i, 1.0f - s.pz);
        }
      }
    }
    __syncthreads();
    AIRGYM_CLOCK(c1);

    // ---- (b) policy MLP over the block's E envs ---------------------------
    dense_elu<OBS, H0>(w + C::S_W0T, w + C::S_B0, xs, sm + C::S_H0);
    __syncthreads();
    dense_elu<H0, H1>(w + C::S_W1T, w + C::S_B1, sm + C::S_H0, sm + C::S_H1);
    __syncthreads();
    dense_elu<H1, H2>(w + C::S_W2T, w + C::S_B2, sm + C::S_H1, sm + C::S_H2);
    __syncthreads();
    // ---- (c) heads: output a (mu 0..3, value 4) of env e per thread -------
    if (t < (ACT + 1) * E) {
      const int a = t / E, e = t % E;
      const float* h2 = sm + C::S_H2 + e;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H2; ++k) acc = fmaf(w[C::S_WHT + k * HD + a], h2[k * E], acc);
      hout[a * E + e] = acc + w[C::S_BH + a];
    }
    __syncthreads();
    AIRGYM_CLOCK(c2);

    // ---- (d) sample, env step, record, reset: one thread per env ----------
    if (env_thread) {
      float mu[ACT];
#pragma unroll
      for (int k = 0; k < ACT; ++k) mu[k] = hout[k * E + t];
      const float value = hout[ACT * E + t];

      float act[ACT], eps[ACT];
#pragma unroll
      for (int k = 0; k < ACT; ++k) eps[k] = normal(draw);
#pragma unroll
      for (int k = 0; k < ACT; ++k) act[k] = mu[k] + sig[k] * eps[k];
      const float nlp = (0.5f * (((eps[0] * eps[0] + eps[1] * eps[1]) + eps[2] * eps[2])
                                 + eps[3] * eps[3]) + nlp_c) + lsum;

      const float lim = C::RATE_LIM;
      const float a0r = clampf(clampf(act[0], -1.0f, 1.0f), -lim, lim);
      const float a1r = clampf(clampf(act[1], -1.0f, 1.0f), -lim, lim);
      const float a2r = clampf(clampf(act[2], -1.0f, 1.0f), -lim, lim);
      const float a3r = clampf(0.5f + 0.5f * clampf(act[3], -1.0f, 1.0f), 0.0f, 1.0f);

      // ---- controller + physics, then the task's reward and kill rules ---
      float c[4];
      control_physics<false>(s, a0r, a1r, a2r, a3r, alpha, one_m_alpha, use_lag != 0, c);
      float reward;
      bool die;
      if constexpr (TASK == kHovering) {
        reward = hover_reward(s, a0r, a1r, a2r, a3r, c, die);
      } else if constexpr (TASK == kTracking) {
        const float effort_r = 0.1f * (4.0f - (((c[0] + c[1]) + c[2]) + c[3])) / 4.0f;
        const float d0 = a0r - s.pa0, d1 = a1r - s.pa1, d2 = a2r - s.pa2, d3 = a3r - s.pa3;
        const float dn = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        const float cont_r = 0.1f * expf(-dn) + 0.5f / (1.0f + sq(2.0f * d3));
        const float thrust_r = 0.1f * (1.0f - fabsf(0.1533f - a3r));
        // the reference point at the incremented progress
        const float t_ref = s.prog * (float)(DT * 0.25);
        float st, ct;
        sincosf(t_ref, &st, &ct);
        const float den = 1.0f + ct * ct;
        const float ex = 3.0f * st / den - s.px;
        const float ey = 3.0f * st * ct / den - s.py;
        const float ez = 1.0f - s.pz;
        const float dist = sqrtf(ex * ex + ey * ey + ez * ez);
        const float dist_r = 1.0f / (1.0f + sq(1.8f * dist));
        const float yaw_r = 1.0f / (1.0f + sq(4.0f * yaw_of(s) / (float)PI_D));
        const float spin_r = 1.0f / (1.0f + sq(2.0f * (s.wz * s.wz)));
        const float ups_r = sq((ups_z(s) + 1.0f) * 0.5f);
        reward = (((cont_r + effort_r) + thrust_r) + dist_r)
                 + dist_r * ((spin_r + yaw_r) + ups_r);
        die = dist > 1.0f;
      } else {
        const float relx = bx - s.px, rely = by - s.py, relz = bz - s.pz;
        const float check = sqrtf(relx * relx + rely * rely + relz * relz);
        const float dyaw = yaw_of(s) - poly_atan2(rely, relx);
        float sd, cd;
        sincosf(dyaw, &sd, &cd);
        const float yaw_r = 1.0f / (1.0f + sq(1.6f * fabsf(poly_atan2(sd, cd))));
        const float dpx = bx - ppx, dpy = by - ppy, dpz = bz - ppz;
        const float guidance_r = 30.0f * (sqrtf(dpx * dpx + dpy * dpy + dpz * dpz) - check);
        const float ups_r = 0.5f * sq((ups_z(s) + 1.0f) * 0.5f);
        const bool hit = check < 0.1f;
        const float hit_r = hit ? 800.0f : 0.0f;
        const float effort_r = 0.1f * expf(-(((a0r * a0r + a1r * a1r) + a2r * a2r) + a3r * a3r));
        const float d0 = a0r - s.pa0, d1 = a1r - s.pa1, d2 = a2r - s.pa2, d3 = a3r - s.pa3;
        const float smooth_r = 0.1f * expf(-sqrtf(((d0 * d0 + d1 * d1) + d2 * d2) + d3 * d3));
        reward = ((((guidance_r + yaw_r) + hit_r) + smooth_r) + ups_r) + effort_r;
        // kill rules + ground collision (base sphere of 0.2 m)
        die = (relx < -0.2f) || (s.vx < 0.0f) || (check > 4.0f) || (s.pz < 0.5f)
              || (s.pz > 1.5f) || hit || (s.pz < 0.2f);
        ppx = s.px; ppy = s.py; ppz = s.pz;   // pre_root_pos after the reward
      }
      s.pa0 = a0r; s.pa1 = a1r; s.pa2 = a2r; s.pa3 = a3r;
      const bool over = s.prog >= C::MAX_LEN_M1;
      const float timeout = (over && !die) ? 1.0f : 0.0f;
      const float new_rstf = (die || over) ? 1.0f : 0.0f;

      // ---- rest of the record [H, OBS + 13, N] ----------------------------
#pragma unroll
      for (int k = 0; k < ACT; ++k) r[(size_t)(OBS + k) * n] = act[k];
      r[(size_t)(OBS + 4) * n] = nlp;
      r[(size_t)(OBS + 5) * n] = value;
#pragma unroll
      for (int k = 0; k < ACT; ++k) r[(size_t)(OBS + 6 + k) * n] = mu[k];
      r[(size_t)(OBS + 10) * n] = reward;
      r[(size_t)(OBS + 11) * n] = new_rstf;
      r[(size_t)(OBS + 12) * n] = timeout;

      // ---- hash-RNG reset: drawn for every env, mixed in by the flag ------
      float root[13];
      reset_root<TASK>(draw, root);
      if constexpr (TASK == kBalloon) {
        const float nbx = 2.5f + 0.5f * (draw() * 2.0f - 1.0f);
        const float nby = 2.0f * (draw() * 2.0f - 1.0f);
        const float nbz = 1.0f + 0.3f * (draw() * 2.0f - 1.0f);
        const float keep = apply_reset(s, new_rstf, root);
        bx = bx * keep + nbx * new_rstf;
        by = by * keep + nby * new_rstf;
        bz = bz * keep + nbz * new_rstf;
        ppx *= keep; ppy *= keep; ppz *= keep;
      } else {
        apply_reset(s, new_rstf, root);
      }
    }
#ifdef AIRGYM_ROLLOUT_CLOCKS
    const long long c3 = clock64();
    cyc_obs += c1 - c0; cyc_mlp += c2 - c1; cyc_env += c3 - c2;
#endif
  }

  if (env_thread) {
    store_quad(s, s_out, n, env);
    if constexpr (TASK == kBalloon) {
      s_out[29 * (size_t)n + env] = bx; s_out[30 * (size_t)n + env] = by;
      s_out[31 * (size_t)n + env] = bz; s_out[32 * (size_t)n + env] = ppx;
      s_out[33 * (size_t)n + env] = ppy; s_out[34 * (size_t)n + env] = ppz;
    }
    for (int i = C::ROWS; i < NF; ++i) s_out[(size_t)i * n + env] = s_in[(size_t)i * n + env];
  }
#ifdef AIRGYM_ROLLOUT_CLOCKS
  if (t == 0) {
    atomicAdd(&g_phase_cycles[0], (unsigned long long)cyc_obs);
    atomicAdd(&g_phase_cycles[1], (unsigned long long)cyc_mlp);
    atomicAdd(&g_phase_cycles[2], (unsigned long long)cyc_env);
  }
#endif
}

template <int TASK>
int launch(const float* s_in, const float* weights, float* s_out, float* rec,
           int n, int steps, unsigned int seed, int obs_noise, float alpha,
           float one_m_alpha, int use_lag, cudaStream_t stream) {
  const size_t smem = Cfg<TASK>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_kernel<TASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  AIRGYM_LAUNCH(fused_rollout_kernel<TASK>, n / E, NT, smem, stream, s_in,
                weights, s_out, rec, n, steps, seed, obs_noise, alpha,
                one_m_alpha, use_lag);
  return (int)cudaGetLastError();
}

// out[0..4]: envs per block, threads per block, blocks, resident blocks
// per SM, dynamic shared memory bytes per block
template <int TASK>
int shape(int n, int* out) {
  const size_t smem = Cfg<TASK>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_kernel<TASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = E;
  out[1] = NT;
  out[2] = n / E;
  out[4] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], fused_rollout_kernel<TASK>, NT, smem);
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// task: 0 hovering, 1 balloon, 2 tracking; n a multiple of 16. Returns a
// cudaError_t (0 = launched). Launches on `stream`, never syncs.
extern "C" int fused_rollout_launch(int task, const float* s_in,
                                    const float* weights, float* s_out,
                                    float* rec, int n, int steps,
                                    unsigned int seed, int obs_noise,
                                    float alpha, float one_m_alpha,
                                    int use_lag, void* stream) {
  if (n <= 0 || n % E != 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (task) {
    case kHovering:
      return launch<kHovering>(s_in, weights, s_out, rec, n, steps, seed,
                               obs_noise, alpha, one_m_alpha, use_lag, st);
    case kBalloon:
      return launch<kBalloon>(s_in, weights, s_out, rec, n, steps, seed,
                              obs_noise, alpha, one_m_alpha, use_lag, st);
    case kTracking:
      return launch<kTracking>(s_in, weights, s_out, rec, n, steps, seed,
                               obs_noise, alpha, one_m_alpha, use_lag, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launch shape of one task's instance at n envs (see `shape`).
extern "C" int fused_rollout_shape(int task, int n, int* out) {
  if (n <= 0 || n % E != 0) return (int)cudaErrorInvalidValue;
  switch (task) {
    case kHovering: return shape<kHovering>(n, out);
    case kBalloon: return shape<kBalloon>(n, out);
    case kTracking: return shape<kTracking>(n, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef AIRGYM_ROLLOUT_CLOCKS
// Reads and zeroes the three phase counters: cycles of thread 0 of every
// block in (a) the observation, (b) + (c) the MLP and heads, (d) the env
// step, summed over steps and blocks.
extern "C" int fused_rollout_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[3] = {0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif
