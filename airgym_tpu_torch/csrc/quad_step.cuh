// Env step pieces shared by the fused rollout kernels (fused_rollout.cu,
// fused_hovering.cu): the PX4 rate PID + mixer + yaw desaturation, the
// optional motor lag, the 6-DoF physics with exp-map quaternion
// integration, the hovering reward, the reset draws and the reset mix.
//
// They follow airgym_tpu/ops/fused_hovering.py `_kernel` and
// airgym_tpu/ops/fused_rollout.py `_kernel`; the plain versions are the
// functions of the same names in airgym_tpu_torch/ops/fused_hovering.py.
// Constants the reference computes in Python doubles are constexpr double
// here, rounded once to float where they are used.
#pragma once

#include "common.cuh"

namespace airgym {

enum Task { kHovering = 0, kBalloon = 1, kTracking = 2 };

constexpr int NF = 40;        // rows of the packed state
constexpr int NROWS = 29;     // rows every task's step reads and writes

constexpr double DT = 0.01;
constexpr double L_ARM = 0.05374;
constexpr double PROP_M = 0.004;
constexpr double MASS = 0.585 + 4.0 * PROP_M;
constexpr double IXX = 0.04 + 4 * 1e-6 + 4 * PROP_M * (L_ARM * L_ARM + 0.024 * 0.024);
constexpr double IZZ = 0.04 + 4 * 1e-6 + 4 * PROP_M * (2 * L_ARM * L_ARM);
constexpr double TS = 9.59, TQ = 0.2, GRAV = 9.81;
constexpr double PI_D = 3.14159265358979323846;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

// The 29 state rows of one env, in registers.
struct Quad {
  float px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz;
  float rix, riy, riz, prx, pry, prz, prog, rstf;
  float pa0, pa1, pa2, pa3, r1, r2, r3, r4;
};

// the rows in packed-state order
#define AIRGYM_QUAD_ROWS(X)                                              \
  X(px) X(py) X(pz) X(qx) X(qy) X(qz) X(qw) X(vx) X(vy) X(vz) X(wx)     \
  X(wy) X(wz) X(rix) X(riy) X(riz) X(prx) X(pry) X(prz) X(prog) X(rstf) \
  X(pa0) X(pa1) X(pa2) X(pa3) X(r1) X(r2) X(r3) X(r4)

__device__ __forceinline__ void load_quad(Quad& s, const float* __restrict__ in,
                                          int n, int env) {
  size_t i = 0;
#define AIRGYM_LOAD(name) s.name = in[(i++) * n + env];
  AIRGYM_QUAD_ROWS(AIRGYM_LOAD)
#undef AIRGYM_LOAD
}

__device__ __forceinline__ void store_quad(const Quad& s, float* __restrict__ out,
                                           int n, int env) {
  size_t i = 0;
#define AIRGYM_STORE(name) out[(i++) * n + env] = s.name;
  AIRGYM_QUAD_ROWS(AIRGYM_STORE)
#undef AIRGYM_STORE
}

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

// Rate PID + mixer + yaw desaturation, motor lag, physics. Updates `s`
// (rate integrators, previous rates, rotors, root, progress) and writes the
// commanded thrusts to c[4] (zero on the first step after a reset).
// kEnvOnlyMix adds the roll / pitch mixer columns before the thrust, as
// the env-only Pallas kernel rounds them.
template <bool kEnvOnlyMix>
__device__ __forceinline__ void control_physics(Quad& s, float a0, float a1,
                                                float a2, float thrust,
                                                float alpha, float one_m_alpha,
                                                bool use_lag, float c[4]) {
  const float flip = s.qw < 0.0f ? -1.0f : 1.0f;
  const float qx_ = s.qx * flip, qy_ = s.qy * flip, qz_ = s.qz * flip, qw_ = s.qw * flip;
  float wbx, wby, wbz;
  {
    const float a = 2.0f * qw_ * qw_ - 1.0f;
    const float cx = -qy_ * s.wz + qz_ * s.wy;
    const float cy = -qz_ * s.wx + qx_ * s.wz;
    const float cz = -qx_ * s.wy + qy_ * s.wx;
    const float d = -(qx_ * s.wx + qy_ * s.wy + qz_ * s.wz);
    wbx = a * s.wx + 2.0f * qw_ * cx - 2.0f * d * qx_;
    wby = a * s.wy + 2.0f * qw_ * cy - 2.0f * d * qy_;
    wbz = a * s.wz + 2.0f * qw_ * cz - 2.0f * d * qz_;
  }
  const Pid px_pid = pid(a0 - wbx, s.rix, s.prx, wbx, 0.15f, 0.2f, 0.003f);
  const Pid py_pid = pid(a1 - wby, s.riy, s.pry, wby, 0.15f, 0.2f, 0.003f);
  const Pid pz_pid = pid(a2 - wbz, s.riz, s.prz, wbz, 0.2f, 0.1f, 0.0f);
  const float tx = px_pid.torque, ty = py_pid.torque, tz = pz_pid.torque;
  s.rix = px_pid.integ; s.riy = py_pid.integ; s.riz = pz_pid.integ;
  s.prx = wbx; s.pry = wby; s.prz = wbz;

  float f1, f2, f3, f4;
  if (kEnvOnlyMix) {
    f1 = thrust + (-tx - ty); f2 = thrust + (tx + ty);
    f3 = thrust + (tx - ty); f4 = thrust + (-tx + ty);
  } else {
    f1 = thrust - tx - ty; f2 = thrust + tx + ty;
    f3 = thrust + tx - ty; f4 = thrust - tx + ty;
  }
  float mn = fminf(fminf(f1, f2), fminf(f3, f4));
  float mx = fmaxf(fmaxf(f1, f2), fmaxf(f3, f4));
  const float shift = fmaxf(0.0f, -mn) - fmaxf(0.0f, mx - 1.0f);
  f1 = f1 + shift; f2 = f2 + shift; f3 = f3 + shift; f4 = f4 + shift;
  mn = fminf(fminf(f1, f2), fminf(f3, f4));
  mx = fmaxf(fmaxf(f1, f2), fmaxf(f3, f4));
  const float ysc = clampf(fminf(1.0f - mx, mn) / fmaxf(fabsf(tz), 1e-6f), 0.0f, 1.0f);
  const float ytz = tz * ysc;
  const float alive = 1.0f - s.rstf;
  c[0] = clampf(f1 - ytz, 0.0f, 1.0f) * alive;
  c[1] = clampf(f2 - ytz, 0.0f, 1.0f) * alive;
  c[2] = clampf(f3 + ytz, 0.0f, 1.0f) * alive;
  c[3] = clampf(f4 + ytz, 0.0f, 1.0f) * alive;
  if (use_lag) {
    s.r1 = alpha * s.r1 + one_m_alpha * c[0];
    s.r2 = alpha * s.r2 + one_m_alpha * c[1];
    s.r3 = alpha * s.r3 + one_m_alpha * c[2];
    s.r4 = alpha * s.r4 + one_m_alpha * c[3];
  } else {
    s.r1 = c[0]; s.r2 = c[1]; s.r3 = c[2]; s.r4 = c[3];
  }
  const float r1 = s.r1, r2 = s.r2, r3 = s.r3, r4 = s.r4;

  const float fz = (((r1 + r2) + r3) + r4) * (float)TS;
  const float a_ = 2.0f * qw_ * qw_ - 1.0f;
  const float fwx = 2.0f * qw_ * (qy_ * fz) + 2.0f * qx_ * (qz_ * fz);
  const float fwy = 2.0f * qw_ * (-qx_ * fz) + 2.0f * qy_ * (qz_ * fz);
  const float fwz = a_ * fz + 2.0f * qz_ * (qz_ * fz);
  s.vx = s.vx + (float)DT * (fwx / (float)MASS);
  s.vy = s.vy + (float)DT * (fwy / (float)MASS);
  s.vz = s.vz + (float)DT * (fwz / (float)MASS - (float)GRAV);

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
  const float qx = nqx * qn, qy = nqy * qn, qz = nqz * qn, qw = nqw * qn;
  s.qx = qx; s.qy = qy; s.qz = qz; s.qw = qw;

  s.px = s.px + (float)DT * s.vx;
  s.py = s.py + (float)DT * s.vy;
  s.pz = s.pz + (float)DT * s.vz;
  {
    const float a2 = 2.0f * qw * qw - 1.0f;
    const float cx = qy * wbz_n - qz * wby_n;
    const float cy = qz * wbx_n - qx * wbz_n;
    const float cz = qx * wby_n - qy * wbx_n;
    const float d = qx * wbx_n + qy * wby_n + qz * wbz_n;
    s.wx = a2 * wbx_n + 2.0f * qw * cx + 2.0f * d * qx;
    s.wy = a2 * wby_n + 2.0f * qw * cy + 2.0f * d * qy;
    s.wz = a2 * wbz_n + 2.0f * qw * cz + 2.0f * d * qz;
  }
  s.prog = s.prog + 1.0f;
}

// XYZ-euler yaw of the attitude (pytorch3d convention)
__device__ __forceinline__ float yaw_of(const Quad& s) {
  const float m00 = 1.0f - 2.0f * (s.qy * s.qy + s.qz * s.qz);
  const float m01 = 2.0f * (s.qx * s.qy - s.qw * s.qz);
  return poly_atan2(-m01, m00);
}

__device__ __forceinline__ float ups_z(const Quad& s) {
  return 1.0f - 2.0f * (s.qx * s.qx + s.qy * s.qy);
}

// Hovering reward (target: identity at the origin), against the previous
// actions still in s.pa*; sets `die`.
__device__ __forceinline__ float hover_reward(const Quad& s, float a0, float a1,
                                              float a2, float a3,
                                              const float c[4], bool& die) {
  const float up = ups_z(s);
  const float effort_r = 0.1f * (4.0f - (((c[0] + c[1]) + c[2]) + c[3])) / 4.0f;
  const float d0 = a0 - s.pa0, d1 = a1 - s.pa1, d2 = a2 - s.pa2, d3 = a3 - s.pa3;
  const float dn = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
  const float cont_r = 0.2f * expf(-dn) + 0.5f / (1.0f + sq(3.0f * d3));
  const float thrust_r = 0.1f * (1.0f - fabsf(0.1533f - a3));
  const float dist = sqrtf(s.px * s.px + s.py * s.py + s.pz * s.pz);
  const float pos_r = 0.7f / (1.0f + sq(1.6f * dist));
  const float vn = sqrtf(s.vx * s.vx + s.vy * s.vy + s.vz * s.vz);
  const float dot = ((-s.px * s.vx - s.py * s.vy) - s.pz * s.vz) / fmaxf(dist * vn, 1e-6f);
  const float angle = fabsf(poly_acos(clampf(dot, -1.0f, 1.0f)));
  const float veldir_r = 0.1f * expf(-angle / (float)PI_D);
  const float yaw_r = 1.0f / (1.0f + sq(3.0f * yaw_of(s) / (float)PI_D));
  const float spin_r = 1.0f / (1.0f + sq(3.0f * (s.wz * s.wz)));
  const float ups_r = sq((up + 1.0f) * 0.5f);
  die = (dist > 4.0f) || (s.pz < -2.0f) || (s.pz > 2.0f) || (up < 0.0f);
  return (((cont_r + effort_r) + thrust_r) + pos_r)
         + pos_r * (((veldir_r + ups_r) + spin_r) + yaw_r);
}

// 12 reset draws -> root[13] (pos, xyzw quat, linvel, angvel), in the
// task's distribution. Each draw is a named statement: C++ leaves the
// order of function arguments open, the reference draws left to right.
template <int TASK>
__device__ __forceinline__ void reset_root(HashUniform& draw, float root[13]) {
  if (TASK == kHovering) {
    root[0] = draw() * 2.0f - 1.0f;
    root[1] = draw() * 2.0f - 1.0f;
    root[2] = draw() * 2.0f - 1.0f;
  } else {
    root[0] = 0.1f * (draw() * 2.0f - 1.0f);
    root[1] = 0.1f * (draw() * 2.0f - 1.0f);
    root[2] = 1.0f + (TASK == kBalloon ? 0.2f : 0.1f) * (draw() * 2.0f - 1.0f);
  }
  constexpr double e0 = TASK == kHovering ? 0.01 : 0.1;
  constexpr double e2 = TASK == kHovering ? 0.05 : 0.2;
  const float eax = (float)(e0 * PI_D) * (draw() * 2.0f - 1.0f);
  // Balloon's pitch is one-sided: 0.1 pi U(0, 1)
  const float eay = TASK == kBalloon ? (float)(e0 * PI_D) * draw()
                                     : (float)(e0 * PI_D) * (draw() * 2.0f - 1.0f);
  const float eaz = (float)(e2 * PI_D) * (draw() * 2.0f - 1.0f);
  quat_from_euler(eax, eay, eaz, root[3], root[4], root[5], root[6]);
#pragma unroll
  for (int i = 7; i < 10; ++i) root[i] = 0.5f * (draw() * 2.0f - 1.0f);
#pragma unroll
  for (int i = 10; i < 13; ++i) root[i] = 0.2f * (draw() * 2.0f - 1.0f);
}

// Mix root[13] in where new_rstf is 1, zero the controller, action, rotor
// and progress rows there; returns keep = 1 - new_rstf.
__device__ __forceinline__ float apply_reset(Quad& s, float new_rstf,
                                             const float root[13]) {
  const float keep = 1.0f - new_rstf;
  s.px = s.px * keep + root[0] * new_rstf;
  s.py = s.py * keep + root[1] * new_rstf;
  s.pz = s.pz * keep + root[2] * new_rstf;
  s.qx = s.qx * keep + root[3] * new_rstf;
  s.qy = s.qy * keep + root[4] * new_rstf;
  s.qz = s.qz * keep + root[5] * new_rstf;
  s.qw = s.qw * keep + root[6] * new_rstf;
  s.vx = s.vx * keep + root[7] * new_rstf;
  s.vy = s.vy * keep + root[8] * new_rstf;
  s.vz = s.vz * keep + root[9] * new_rstf;
  s.wx = s.wx * keep + root[10] * new_rstf;
  s.wy = s.wy * keep + root[11] * new_rstf;
  s.wz = s.wz * keep + root[12] * new_rstf;
  s.rix *= keep; s.riy *= keep; s.riz *= keep;
  s.prx *= keep; s.pry *= keep; s.prz *= keep;
  s.pa0 *= keep; s.pa1 *= keep; s.pa2 *= keep; s.pa3 *= keep;
  s.r1 *= keep; s.r2 *= keep; s.r3 *= keep; s.r4 *= keep;
  s.prog *= keep;
  s.rstf = new_rstf;
  return keep;
}

}  // namespace airgym
