// Fused PPO rollout for the Hovering task (rate mode): policy + env for the
// whole horizon in one launch.
//
// Replaces: airgym_tpu/ops/fused_rollout.py `_kernel` with task="hovering"
// (wrapper `rollout_fused_policy`). Per env and step: the 18-dim
// observation with hash-RNG Box-Muller noise, (x - mean) * istd clipped to
// +-5, the [64,128,64] elu MLP to mu and value, the Gaussian sample and
// neglogp, clamp + remap, the PX4 rate PID + mixer + yaw desaturation,
// optional motor lag, the 6-DoF physics with exp-map quaternion
// integration, the hovering reward, die / timeout, and the hash-RNG reset.
// Each step streams a 31-row record [H, 31, N]; the [40, N] state is read
// once and written once.
//
// Bound on the card (default trainer, 4096 envs x 24 steps): the MLP is
// 17,856 MAC per env-step, 3.51 GFLOP in all, in float32 (parity with the
// reference rules out TF32): 52 us at the H100's 67 TFLOP/s of FP32. The
// bytes are 12.2 MB of record plus 1.3 MB of state in and out, 4 us at
// 3.35 TB/s. So the kernel is FP32 compute-bound.
//
// Design (simple first): one thread owns one env for all H steps, its 29
// state rows in registers. The weights and obs stats (18,157 floats,
// 72.6 KB) are staged once per block in dynamic shared memory, beside the
// per-thread activation columns ([192][BLOCK] floats). Blocks are 32 envs,
// so 4096 envs give 128 blocks on the 132 SMs. The RNG reproduces the
// Pallas bits: tile = env / 1024 and lane = env % 1024 come from the env
// index, not from the CUDA block.
//
// Left on the table: the MLP runs as scalar FP32 FMAs with one
// shared-memory operand each (no tensor cores, no register tiling), and
// one warp per SM gives low occupancy. A batched MMA over the block's envs
// is later work.
#include "common.cuh"

namespace {

constexpr int OBS = 18, ACT = 4, H0 = 64, H1 = 128, H2 = 64;
constexpr int REC = OBS + 13;
constexpr int NF = 40;        // rows of the packed state
constexpr int NROWS = 29;     // rows the hovering step reads and writes

// flat PolicyPack offsets (airgym_tpu_torch/ops/fused_rollout.py)
constexpr int O_W0 = 0;
constexpr int O_B0 = O_W0 + H0 * OBS;
constexpr int O_W1 = O_B0 + H0;
constexpr int O_B1 = O_W1 + H1 * H0;
constexpr int O_W2 = O_B1 + H1;
constexpr int O_B2 = O_W2 + H2 * H1;
constexpr int O_WMU = O_B2 + H2;
constexpr int O_BMU = O_WMU + ACT * H2;
constexpr int O_WV = O_BMU + ACT;
constexpr int O_BV = O_WV + H2;
constexpr int O_LOGSTD = O_BV + 1;
constexpr int O_MEAN = O_LOGSTD + ACT;
constexpr int O_ISTD = O_MEAN + OBS;
constexpr int N_W = O_ISTD + OBS;               // 18,157
constexpr int N_W_PAD = (N_W + 3) / 4 * 4;
static_assert(O_W1 % 4 == 0 && O_W2 % 4 == 0, "float4 weight rows");

constexpr int BLOCK = 32;
constexpr size_t SMEM_BYTES = (N_W_PAD + (H0 + H1) * BLOCK) * sizeof(float);

// constants: the reference computes them in double and rounds once
constexpr double DT = 0.01;
constexpr double L_ARM = 0.05374;
constexpr double PROP_M = 0.004;
constexpr double MASS = 0.585 + 4.0 * PROP_M;
constexpr double IXX = 0.04 + 4 * 1e-6 + 4 * PROP_M * (L_ARM * L_ARM + 0.024 * 0.024);
constexpr double IZZ = 0.04 + 4 * 1e-6 + 4 * PROP_M * (2 * L_ARM * L_ARM);
constexpr double TS = 9.59, TQ = 0.2, GRAV = 9.81;
constexpr double PI_D = 3.14159265358979323846;
constexpr float MAX_LEN_M1 = 2399.0f;          // 24 s / 0.01 - 1

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float elu(float z) {
  return z > 0.0f ? z : expf(fminf(z, 0.0f)) - 1.0f;
}

__device__ __forceinline__ float sq(float x) { return x * x; }

struct Pid {
  float torque, integ;
};

__device__ __forceinline__ Pid pid(float err, float integ, float wprev,
                                   float wnow, float kp, float ki, float kd) {
  Pid r;
  r.integ = clampf(integ + err * (float)DT * ki, -0.3f, 0.3f);
  const float d = -(wnow - wprev) / (float)DT * kd;
  r.torque = clampf(kp * err + r.integ + d, -1.0f, 1.0f);
  return r;
}

__global__ void __launch_bounds__(BLOCK)
fused_rollout_kernel(const float* __restrict__ s_in,
                     const float* __restrict__ weights,
                     float* __restrict__ s_out, float* __restrict__ rec,
                     int n, int steps, uint32_t seed, int obs_noise,
                     float alpha, float one_m_alpha, int use_lag) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* ha = smem + N_W_PAD;        // [H0][BLOCK]: h0, then h2
  float* hb = ha + H0 * BLOCK;       // [H1][BLOCK]: h1
  for (int i = threadIdx.x; i < N_W; i += BLOCK) w[i] = weights[i];
  __syncthreads();
  // no block-wide barrier below: each thread touches its own columns only

  const int t = threadIdx.x;
  const int env = blockIdx.x * BLOCK + t;
  if (env >= n) return;
  const uint32_t base = airgym::tile_seed(seed, (uint32_t)env);
  const uint32_t lane = (uint32_t)env % airgym::kTile;

  float px = s_in[0 * n + env], py = s_in[1 * n + env], pz = s_in[2 * n + env];
  float qx = s_in[3 * n + env], qy = s_in[4 * n + env];
  float qz = s_in[5 * n + env], qw = s_in[6 * n + env];
  float vx = s_in[7 * n + env], vy = s_in[8 * n + env], vz = s_in[9 * n + env];
  float wx = s_in[10 * n + env], wy = s_in[11 * n + env], wz = s_in[12 * n + env];
  float rix = s_in[13 * n + env], riy = s_in[14 * n + env], riz = s_in[15 * n + env];
  float prx = s_in[16 * n + env], pry = s_in[17 * n + env], prz = s_in[18 * n + env];
  float prog = s_in[19 * n + env], rstf = s_in[20 * n + env];
  float pa0 = s_in[21 * n + env], pa1 = s_in[22 * n + env];
  float pa2 = s_in[23 * n + env], pa3 = s_in[24 * n + env];
  float r1 = s_in[25 * n + env], r2 = s_in[26 * n + env];
  float r3 = s_in[27 * n + env], r4 = s_in[28 * n + env];

  float sig[ACT];
#pragma unroll
  for (int k = 0; k < ACT; ++k) sig[k] = expf(w[O_LOGSTD + k]);
  const float lsum = ((w[O_LOGSTD] + w[O_LOGSTD + 1]) + w[O_LOGSTD + 2]) + w[O_LOGSTD + 3];
  const float nlp_c = (float)(0.5 * 1.8378770664093453 * ACT);  // 0.5 log(2 pi) A

  for (int step = 0; step < steps; ++step) {
    airgym::HashUniform draw(airgym::step_key(base, step), lane);

    // ---- observation: rotation matrix - identity, pos, vel, angvel -------
    float X[OBS];
    X[0] = (1.0f - 2.0f * (qy * qy + qz * qz)) - 1.0f;
    X[1] = 2.0f * (qx * qy - qw * qz);
    X[2] = 2.0f * (qx * qz + qw * qy);
    X[3] = 2.0f * (qx * qy + qw * qz);
    X[4] = (1.0f - 2.0f * (qx * qx + qz * qz)) - 1.0f;
    X[5] = 2.0f * (qy * qz - qw * qx);
    X[6] = 2.0f * (qx * qz - qw * qy);
    X[7] = 2.0f * (qy * qz + qw * qx);
    X[8] = (1.0f - 2.0f * (qx * qx + qy * qy)) - 1.0f;
    X[9] = px; X[10] = py; X[11] = pz;
    X[12] = vx; X[13] = vy; X[14] = vz;
    X[15] = wx; X[16] = wy; X[17] = wz;
    if (obs_noise) {
#pragma unroll
      for (int i = 0; i < OBS; ++i) {
        const float scale = i < 9 ? 1e-3f : (i < 12 ? 5e-3f : (i < 15 ? 2e-2f : 4e-1f));
        X[i] = X[i] + scale * airgym::normal(draw);
      }
    }

    // ---- policy MLP ----------------------------------------------------
    float xn[OBS];
#pragma unroll
    for (int k = 0; k < OBS; ++k)
      xn[k] = clampf((X[k] - w[O_MEAN + k]) * w[O_ISTD + k], -5.0f, 5.0f);

    float h0[H0];
#pragma unroll
    for (int j = 0; j < H0; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < OBS; ++k) acc += w[O_W0 + j * OBS + k] * xn[k];
      h0[j] = elu(acc + w[O_B0 + j]);
    }
#pragma unroll 1
    for (int j = 0; j < H1; ++j) {
      const float4* row = reinterpret_cast<const float4*>(w + O_W1 + j * H0);
      float acc = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < H0 / 4; ++k4) {
        const float4 c = row[k4];
        acc += c.x * h0[4 * k4];
        acc += c.y * h0[4 * k4 + 1];
        acc += c.z * h0[4 * k4 + 2];
        acc += c.w * h0[4 * k4 + 3];
      }
      hb[j * BLOCK + t] = elu(acc + w[O_B1 + j]);
    }
#pragma unroll 1
    for (int j = 0; j < H2; ++j) {
      const float4* row = reinterpret_cast<const float4*>(w + O_W2 + j * H1);
      float acc = 0.0f;
#pragma unroll 8
      for (int k4 = 0; k4 < H1 / 4; ++k4) {
        const float4 c = row[k4];
        acc += c.x * hb[(4 * k4) * BLOCK + t];
        acc += c.y * hb[(4 * k4 + 1) * BLOCK + t];
        acc += c.z * hb[(4 * k4 + 2) * BLOCK + t];
        acc += c.w * hb[(4 * k4 + 3) * BLOCK + t];
      }
      ha[j * BLOCK + t] = elu(acc + w[O_B2 + j]);
    }
    float mu[ACT], value;
    {
      float acc[ACT + 1] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int k = 0; k < H2; ++k) {
        const float h = ha[k * BLOCK + t];
#pragma unroll
        for (int a = 0; a < ACT; ++a) acc[a] += w[O_WMU + a * H2 + k] * h;
        acc[ACT] += w[O_WV + k] * h;
      }
#pragma unroll
      for (int a = 0; a < ACT; ++a) mu[a] = acc[a] + w[O_BMU + a];
      value = acc[ACT] + w[O_BV];
    }

    // ---- sample + neglogp -----------------------------------------------
    float act[ACT], eps[ACT];
#pragma unroll
    for (int k = 0; k < ACT; ++k) eps[k] = airgym::normal(draw);
#pragma unroll
    for (int k = 0; k < ACT; ++k) act[k] = mu[k] + sig[k] * eps[k];
    const float nlp = (0.5f * (((eps[0] * eps[0] + eps[1] * eps[1]) + eps[2] * eps[2])
                               + eps[3] * eps[3]) + nlp_c) + lsum;

    const float a0r = clampf(clampf(act[0], -1.0f, 1.0f), -6.0f, 6.0f);
    const float a1r = clampf(clampf(act[1], -1.0f, 1.0f), -6.0f, 6.0f);
    const float a2r = clampf(clampf(act[2], -1.0f, 1.0f), -6.0f, 6.0f);
    const float a3r = clampf(0.5f + 0.5f * clampf(act[3], -1.0f, 1.0f), 0.0f, 1.0f);

    // ---- PX4 rate loop + mixer --------------------------------------------
    const float flip = qw < 0.0f ? -1.0f : 1.0f;
    const float qx_ = qx * flip, qy_ = qy * flip, qz_ = qz * flip, qw_ = qw * flip;
    float wbx, wby, wbz;
    {
      const float a = 2.0f * qw_ * qw_ - 1.0f;
      const float cx = -qy_ * wz + qz_ * wy;
      const float cy = -qz_ * wx + qx_ * wz;
      const float cz = -qx_ * wy + qy_ * wx;
      const float d = -(qx_ * wx + qy_ * wy + qz_ * wz);
      wbx = a * wx + 2.0f * qw_ * cx - 2.0f * d * qx_;
      wby = a * wy + 2.0f * qw_ * cy - 2.0f * d * qy_;
      wbz = a * wz + 2.0f * qw_ * cz - 2.0f * d * qz_;
    }
    const Pid px_pid = pid(a0r - wbx, rix, prx, wbx, 0.15f, 0.2f, 0.003f);
    const Pid py_pid = pid(a1r - wby, riy, pry, wby, 0.15f, 0.2f, 0.003f);
    const Pid pz_pid = pid(a2r - wbz, riz, prz, wbz, 0.2f, 0.1f, 0.0f);
    const float tx = px_pid.torque, ty = py_pid.torque, tz = pz_pid.torque;
    rix = px_pid.integ; riy = py_pid.integ; riz = pz_pid.integ;
    prx = wbx; pry = wby; prz = wbz;

    float f1 = a3r - tx - ty, f2 = a3r + tx + ty, f3 = a3r + tx - ty, f4 = a3r - tx + ty;
    float mn = fminf(fminf(f1, f2), fminf(f3, f4));
    float mx = fmaxf(fmaxf(f1, f2), fmaxf(f3, f4));
    const float shift = fmaxf(0.0f, -mn) - fmaxf(0.0f, mx - 1.0f);
    f1 = f1 + shift; f2 = f2 + shift; f3 = f3 + shift; f4 = f4 + shift;
    mn = fminf(fminf(f1, f2), fminf(f3, f4));
    mx = fmaxf(fmaxf(f1, f2), fmaxf(f3, f4));
    const float ysc = clampf(fminf(1.0f - mx, mn) / fmaxf(fabsf(tz), 1e-6f), 0.0f, 1.0f);
    const float ytz = tz * ysc;
    const float alive = 1.0f - rstf;
    const float c1 = clampf(f1 - ytz, 0.0f, 1.0f) * alive;
    const float c2 = clampf(f2 - ytz, 0.0f, 1.0f) * alive;
    const float c3 = clampf(f3 + ytz, 0.0f, 1.0f) * alive;
    const float c4 = clampf(f4 + ytz, 0.0f, 1.0f) * alive;
    if (use_lag) {
      r1 = alpha * r1 + one_m_alpha * c1;
      r2 = alpha * r2 + one_m_alpha * c2;
      r3 = alpha * r3 + one_m_alpha * c3;
      r4 = alpha * r4 + one_m_alpha * c4;
    } else {
      r1 = c1; r2 = c2; r3 = c3; r4 = c4;
    }

    // ---- physics ------------------------------------------------------------
    const float fz = (((r1 + r2) + r3) + r4) * (float)TS;
    const float a_ = 2.0f * qw_ * qw_ - 1.0f;
    const float fwx = 2.0f * qw_ * (qy_ * fz) + 2.0f * qx_ * (qz_ * fz);
    const float fwy = 2.0f * qw_ * (-qx_ * fz) + 2.0f * qy_ * (qz_ * fz);
    const float fwz = a_ * fz + 2.0f * qz_ * (qz_ * fz);
    vx = vx + (float)DT * (fwx / (float)MASS);
    vy = vy + (float)DT * (fwy / (float)MASS);
    vz = vz + (float)DT * (fwz / (float)MASS - (float)GRAV);

    const float tbx = (float)(TS * L_ARM) * (((-r1 + r2) + r3) - r4);
    const float tby = (float)(-TS * L_ARM) * (((r1 - r2) + r3) - r4);
    const float tbz = (float)TQ * (((-r1 - r2) + r3) + r4);
    const float gyx = wby * ((float)IZZ * wbz) - wbz * ((float)IXX * wby);
    const float gyy = wbz * ((float)IXX * wbx) - wbx * ((float)IZZ * wbz);
    const float gyz = wbx * ((float)IXX * wby) - wby * ((float)IXX * wbx);
    const float wbx_n = wbx + (float)DT * (tbx - gyx) / (float)IXX;
    const float wby_n = wby + (float)DT * (tby - gyy) / (float)IXX;
    const float wbz_n = wbz + (float)DT * (tbz - gyz) / (float)IZZ;

    const float wn = sqrtf(wbx_n * wbx_n + wby_n * wby_n + wbz_n * wbz_n);
    const float half = (float)(0.5 * DT) * wn;
    const float sinc = half < 1e-8f ? 1.0f : sinf(half) / fmaxf(half, 1e-8f);
    const float k_ = (float)(0.5 * DT) * sinc;
    const float dx = k_ * wbx_n, dy = k_ * wby_n, dz = k_ * wbz_n, dw = cosf(half);
    const float nqx = qw_ * dx + qx_ * dw + qy_ * dz - qz_ * dy;
    const float nqy = qw_ * dy + qy_ * dw + qz_ * dx - qx_ * dz;
    const float nqz = qw_ * dz + qz_ * dw + qx_ * dy - qy_ * dx;
    const float nqw = qw_ * dw - qx_ * dx - qy_ * dy - qz_ * dz;
    const float qn = 1.0f / sqrtf(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw);
    qx = nqx * qn; qy = nqy * qn; qz = nqz * qn; qw = nqw * qn;

    px = px + (float)DT * vx;
    py = py + (float)DT * vy;
    pz = pz + (float)DT * vz;
    {
      const float a2 = 2.0f * qw * qw - 1.0f;
      const float cx = qy * wbz_n - qz * wby_n;
      const float cy = qz * wbx_n - qx * wbz_n;
      const float cz = qx * wby_n - qy * wbx_n;
      const float d = qx * wbx_n + qy * wby_n + qz * wbz_n;
      wx = a2 * wbx_n + 2.0f * qw * cx + 2.0f * d * qx;
      wy = a2 * wby_n + 2.0f * qw * cy + 2.0f * d * qy;
      wz = a2 * wbz_n + 2.0f * qw * cz + 2.0f * d * qz;
    }
    prog = prog + 1.0f;

    // ---- hovering reward (target: identity at the origin) -------------------
    const float ups_z = 1.0f - 2.0f * (qx * qx + qy * qy);
    const float effort_r = 0.1f * (4.0f - (((c1 + c2) + c3) + c4)) / 4.0f;
    const float d0 = a0r - pa0, d1 = a1r - pa1, d2 = a2r - pa2, d3 = a3r - pa3;
    const float dn = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
    const float cont_r = 0.2f * expf(-dn) + 0.5f / (1.0f + sq(3.0f * d3));
    const float thrust_r = 0.1f * (1.0f - fabsf(0.1533f - a3r));
    const float dist = sqrtf(px * px + py * py + pz * pz);
    const float pos_r = 0.7f / (1.0f + sq(1.6f * dist));
    const float vn = sqrtf(vx * vx + vy * vy + vz * vz);
    const float dot = ((-px * vx - py * vy) - pz * vz) / fmaxf(dist * vn, 1e-6f);
    const float angle = fabsf(airgym::poly_acos(clampf(dot, -1.0f, 1.0f)));
    const float veldir_r = 0.1f * expf(-angle / (float)PI_D);
    const float nm00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float nm01 = 2.0f * (qx * qy - qw * qz);
    const float yawang = airgym::poly_atan2(-nm01, nm00);
    const float yaw_r = 1.0f / (1.0f + sq(3.0f * yawang / (float)PI_D));
    const float spin = wz * wz;
    const float spin_r = 1.0f / (1.0f + sq(3.0f * spin));
    const float ups_r = sq((ups_z + 1.0f) * 0.5f);
    const float reward = (((cont_r + effort_r) + thrust_r) + pos_r)
                         + pos_r * (((veldir_r + ups_r) + spin_r) + yaw_r);
    const bool die = (dist > 4.0f) || (pz < -2.0f) || (pz > 2.0f) || (ups_z < 0.0f);
    pa0 = a0r; pa1 = a1r; pa2 = a2r; pa3 = a3r;
    const bool over = prog >= MAX_LEN_M1;
    const float timeout = (over && !die) ? 1.0f : 0.0f;
    const float new_rstf = (die || over) ? 1.0f : 0.0f;

    // ---- record [H, 31, N] --------------------------------------------------
    float* r = rec + (size_t)step * REC * n + env;
#pragma unroll
    for (int i = 0; i < OBS; ++i) r[(size_t)i * n] = X[i];
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
    const float keep = 1.0f - new_rstf;
    const float npx = draw() * 2.0f - 1.0f;
    const float npy = draw() * 2.0f - 1.0f;
    const float npz = draw() * 2.0f - 1.0f;
    const float eax = (float)(0.01 * PI_D) * (draw() * 2.0f - 1.0f);
    const float eay = (float)(0.01 * PI_D) * (draw() * 2.0f - 1.0f);
    const float eaz = (float)(0.05 * PI_D) * (draw() * 2.0f - 1.0f);
    float rqx, rqy, rqz, rqw;
    airgym::quat_from_euler(eax, eay, eaz, rqx, rqy, rqz, rqw);
    const float nvx = 0.5f * (draw() * 2.0f - 1.0f);
    const float nvy = 0.5f * (draw() * 2.0f - 1.0f);
    const float nvz = 0.5f * (draw() * 2.0f - 1.0f);
    const float nwx = 0.2f * (draw() * 2.0f - 1.0f);
    const float nwy = 0.2f * (draw() * 2.0f - 1.0f);
    const float nwz = 0.2f * (draw() * 2.0f - 1.0f);

    px = px * keep + npx * new_rstf; py = py * keep + npy * new_rstf;
    pz = pz * keep + npz * new_rstf;
    qx = qx * keep + rqx * new_rstf; qy = qy * keep + rqy * new_rstf;
    qz = qz * keep + rqz * new_rstf; qw = qw * keep + rqw * new_rstf;
    vx = vx * keep + nvx * new_rstf; vy = vy * keep + nvy * new_rstf;
    vz = vz * keep + nvz * new_rstf;
    wx = wx * keep + nwx * new_rstf; wy = wy * keep + nwy * new_rstf;
    wz = wz * keep + nwz * new_rstf;
    rix *= keep; riy *= keep; riz *= keep;
    prx *= keep; pry *= keep; prz *= keep;
    pa0 *= keep; pa1 *= keep; pa2 *= keep; pa3 *= keep;
    r1 *= keep; r2 *= keep; r3 *= keep; r4 *= keep;
    prog *= keep;
    rstf = new_rstf;
  }

  const float out[NROWS] = {px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz,
                            rix, riy, riz, prx, pry, prz, prog, rstf,
                            pa0, pa1, pa2, pa3, r1, r2, r3, r4};
#pragma unroll
  for (int i = 0; i < NROWS; ++i) s_out[(size_t)i * n + env] = out[i];
  for (int i = NROWS; i < NF; ++i) s_out[(size_t)i * n + env] = s_in[(size_t)i * n + env];
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Returns a cudaError_t (0 = launched). Launches on `stream`, never syncs.
extern "C" int fused_rollout_launch(const float* s_in, const float* weights,
                                    float* s_out, float* rec, int n, int steps,
                                    unsigned int seed, int obs_noise,
                                    float alpha, float one_m_alpha,
                                    int use_lag, void* stream) {
  if (n % BLOCK != 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fused_rollout_kernel<<<n / BLOCK, BLOCK, SMEM_BYTES, (cudaStream_t)stream>>>(
      s_in, weights, s_out, rec, n, steps, seed, obs_noise, alpha,
      one_m_alpha, use_lag);
  return (int)cudaGetLastError();
}
