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
// Design (simple first): one thread owns one env for all H steps, its
// state rows in registers. The weights and obs stats (18,157 floats at 18
// features, 20,137 at 48) are staged once per block in dynamic shared
// memory, beside the per-thread activation columns ([192][BLOCK] floats).
// Each observation feature is written to the record and its normalized
// value to the thread's shared-memory column as soon as it is computed, so
// no thread holds the 48-wide observation in registers. Blocks are 32 envs.
// The RNG reproduces the Pallas bits: tile = env / 1024 and lane = env %
// 1024 come from the env index, not from the CUDA block; the draws per step
// are 36 noise uniforms, 8 for the sample, then 12 reset draws (Balloon 15).
//
// Left on the table: the MLP runs as scalar FP32 FMAs with one
// shared-memory operand each (no tensor cores, no register tiling), and
// one warp per SM gives low occupancy. A batched MMA over the block's envs
// is later work.
#include "quad_step.cuh"

namespace {

using namespace airgym;

constexpr int ACT = 4, H0 = 64, H1 = 128, H2 = 64;
constexpr int BLOCK = 32;

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
  static constexpr int N_W = O_ISTD + OBS;          // 18,157 / 20,137
  static constexpr int N_W_PAD = (N_W + 3) / 4 * 4;
  static constexpr size_t SMEM_BYTES = (N_W_PAD + (H0 + H1) * BLOCK) * sizeof(float);
  static_assert(O_W1 % 4 == 0 && O_W2 % 4 == 0, "float4 weight rows");
};

__device__ __forceinline__ float elu(float z) {
  return z > 0.0f ? z : expf(fminf(z, 0.0f)) - 1.0f;
}

template <int TASK>
__global__ void __launch_bounds__(BLOCK)
fused_rollout_kernel(const float* __restrict__ s_in,
                     const float* __restrict__ weights,
                     float* __restrict__ s_out, float* __restrict__ rec,
                     int n, int steps, uint32_t seed, int obs_noise,
                     float alpha, float one_m_alpha, int use_lag) {
  using C = Cfg<TASK>;
  constexpr int OBS = C::OBS;
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* ha = smem + C::N_W_PAD;     // [H0][BLOCK]: normalized obs, then h2
  float* hb = ha + H0 * BLOCK;       // [H1][BLOCK]: h1
  for (int i = threadIdx.x; i < C::N_W; i += BLOCK) w[i] = weights[i];
  __syncthreads();
  // no block-wide barrier below: each thread touches its own columns only

  const int t = threadIdx.x;
  const int env = blockIdx.x * BLOCK + t;
  if (env >= n) return;
  const uint32_t base = tile_seed(seed, (uint32_t)env);
  const uint32_t lane = (uint32_t)env % kTile;

  Quad s;
  load_quad(s, s_in, n, env);
  // Balloon: balloon position (rows 29:32) and pre_root_pos (32:35)
  float bx = 0.0f, by = 0.0f, bz = 0.0f, ppx = 0.0f, ppy = 0.0f, ppz = 0.0f;
  if constexpr (TASK == kBalloon) {
    bx = s_in[29 * (size_t)n + env]; by = s_in[30 * (size_t)n + env];
    bz = s_in[31 * (size_t)n + env]; ppx = s_in[32 * (size_t)n + env];
    ppy = s_in[33 * (size_t)n + env]; ppz = s_in[34 * (size_t)n + env];
  }

  float sig[ACT];
#pragma unroll
  for (int k = 0; k < ACT; ++k) sig[k] = expf(w[C::O_LOGSTD + k]);
  const float lsum = ((w[C::O_LOGSTD] + w[C::O_LOGSTD + 1]) + w[C::O_LOGSTD + 2])
                     + w[C::O_LOGSTD + 3];
  const float nlp_c = (float)(0.5 * 1.8378770664093453 * ACT);  // 0.5 log(2 pi) A

  for (int step = 0; step < steps; ++step) {
    HashUniform draw(step_key(base, step), lane);
    float* r = rec + (size_t)step * C::REC * n + env;

    // ---- observation: each feature to the record, normalized into xs ----
    float* xs = ha;                  // [OBS][BLOCK] until layer 2 writes h2
    auto feed = [&](int k, float x) {
      r[(size_t)k * n] = x;
      xs[k * BLOCK + t] = clampf((x - w[C::O_MEAN + k]) * w[C::O_ISTD + k], -5.0f, 5.0f);
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

    // ---- policy MLP ----------------------------------------------------
    float h0[H0];
#pragma unroll
    for (int j = 0; j < H0; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < OBS; ++k) acc += w[C::O_W0 + j * OBS + k] * xs[k * BLOCK + t];
      h0[j] = elu(acc + w[C::O_B0 + j]);
    }
#pragma unroll 1
    for (int j = 0; j < H1; ++j) {
      const float4* row = reinterpret_cast<const float4*>(w + C::O_W1 + j * H0);
      float acc = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < H0 / 4; ++k4) {
        const float4 c = row[k4];
        acc += c.x * h0[4 * k4];
        acc += c.y * h0[4 * k4 + 1];
        acc += c.z * h0[4 * k4 + 2];
        acc += c.w * h0[4 * k4 + 3];
      }
      hb[j * BLOCK + t] = elu(acc + w[C::O_B1 + j]);
    }
#pragma unroll 1
    for (int j = 0; j < H2; ++j) {
      const float4* row = reinterpret_cast<const float4*>(w + C::O_W2 + j * H1);
      float acc = 0.0f;
#pragma unroll 8
      for (int k4 = 0; k4 < H1 / 4; ++k4) {
        const float4 c = row[k4];
        acc += c.x * hb[(4 * k4) * BLOCK + t];
        acc += c.y * hb[(4 * k4 + 1) * BLOCK + t];
        acc += c.z * hb[(4 * k4 + 2) * BLOCK + t];
        acc += c.w * hb[(4 * k4 + 3) * BLOCK + t];
      }
      ha[j * BLOCK + t] = elu(acc + w[C::O_B2 + j]);
    }
    float mu[ACT], value;
    {
      float acc[ACT + 1] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int k = 0; k < H2; ++k) {
        const float h = ha[k * BLOCK + t];
#pragma unroll
        for (int a = 0; a < ACT; ++a) acc[a] += w[C::O_WMU + a * H2 + k] * h;
        acc[ACT] += w[C::O_WV + k] * h;
      }
#pragma unroll
      for (int a = 0; a < ACT; ++a) mu[a] = acc[a] + w[C::O_BMU + a];
      value = acc[ACT] + w[C::O_BV];
    }

    // ---- sample + neglogp -----------------------------------------------
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

    // ---- controller + physics, then the task's reward and kill rules -----
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

    // ---- rest of the record [H, OBS + 13, N] --------------------------------
#pragma unroll
    for (int k = 0; k < ACT; ++k) r[(size_t)(OBS + k) * n] = act[k];
    r[(size_t)(OBS + 4) * n] = nlp;
    r[(size_t)(OBS + 5) * n] = value;
#pragma unroll
    for (int k = 0; k < ACT; ++k) r[(size_t)(OBS + 6 + k) * n] = mu[k];
    r[(size_t)(OBS + 10) * n] = reward;
    r[(size_t)(OBS + 11) * n] = new_rstf;
    r[(size_t)(OBS + 12) * n] = timeout;

    // ---- hash-RNG reset: drawn for every env, mixed in by the flag ----------
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

  store_quad(s, s_out, n, env);
  if constexpr (TASK == kBalloon) {
    s_out[29 * (size_t)n + env] = bx; s_out[30 * (size_t)n + env] = by;
    s_out[31 * (size_t)n + env] = bz; s_out[32 * (size_t)n + env] = ppx;
    s_out[33 * (size_t)n + env] = ppy; s_out[34 * (size_t)n + env] = ppz;
  }
  for (int i = C::ROWS; i < NF; ++i) s_out[(size_t)i * n + env] = s_in[(size_t)i * n + env];
}

template <int TASK>
int launch(const float* s_in, const float* weights, float* s_out, float* rec,
           int n, int steps, unsigned int seed, int obs_noise, float alpha,
           float one_m_alpha, int use_lag, cudaStream_t stream) {
  const size_t smem = Cfg<TASK>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_kernel<TASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_rollout_kernel<TASK><<<n / BLOCK, BLOCK, smem, stream>>>(
      s_in, weights, s_out, rec, n, steps, seed, obs_noise, alpha, one_m_alpha,
      use_lag);
  return (int)cudaGetLastError();
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// task: 0 hovering, 1 balloon, 2 tracking. Returns a cudaError_t
// (0 = launched). Launches on `stream`, never syncs.
extern "C" int fused_rollout_launch(int task, const float* s_in,
                                    const float* weights, float* s_out,
                                    float* rec, int n, int steps,
                                    unsigned int seed, int obs_noise,
                                    float alpha, float one_m_alpha,
                                    int use_lag, void* stream) {
  if (n <= 0 || n % BLOCK != 0 || steps < 0) return (int)cudaErrorInvalidValue;
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
