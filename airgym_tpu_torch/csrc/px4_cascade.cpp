// Batched PX4-style flight-control cascade: a host-side C++ controller.
//
// Role (the reference's external rlPx4Controller C++ library, reference
// airgym/envs/base/hovering.py:10,235-254): a dependency-free controller
// for real-robot deployment (AirGym-Real) that runs without PyTorch, and a
// golden reference for the port's cascade in
// airgym_tpu_torch/control/px4.py: both implement the same math, and the
// tests hold them to float32 round-off in all five modes
// (pos / vel / atti / rate / prop).
//
// Plain C ABI (cascade_run / cascade_reset), float32 throughout. The gains
// are compiled in (struct Gains below, CascadeGains()'s defaults): the ABI
// takes none.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libpx4cascade.so px4_cascade.cpp
// (airgym_tpu_torch/control/native.py builds it under build/ and loads it
// with ctypes).

#include <cmath>
#include <cstring>
#include <algorithm>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 v3(float x, float y, float z) { return {x, y, z}; }
inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(float s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float norm(Vec3 a) { return std::sqrt(dot(a, a)); }

// quaternions stored xyzw (IsaacGym layout)
struct Quat {
  float x, y, z, w;
};

inline Quat qnormalize(Quat q) {
  float n = std::sqrt(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w);
  n = std::max(n, 1e-9f);
  return {q.x / n, q.y / n, q.z / n, q.w / n};
}

inline Quat qconj(Quat q) { return {-q.x, -q.y, -q.z, q.w}; }

inline Quat qmul(Quat a, Quat b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y + a.y * b.w + a.z * b.x - a.x * b.z,
          a.w * b.z + a.z * b.w + a.x * b.y - a.y * b.x,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}

inline Quat qcanonical(Quat q) {
  if (q.w < 0.0f) return {-q.x, -q.y, -q.z, -q.w};
  return q;
}

// rotate v by q (body -> world)
inline Vec3 qrotate(Quat q, Vec3 v) {
  Vec3 qv = {q.x, q.y, q.z};
  Vec3 a = (2.0f * q.w * q.w - 1.0f) * v;
  Vec3 b = 2.0f * q.w * cross(qv, v);
  Vec3 c = 2.0f * dot(qv, v) * qv;
  return a + b + c;
}

inline Vec3 qrotate_inv(Quat q, Vec3 v) { return qrotate(qconj(q), v); }

// rotation matrix columns -> quaternion (Shepperd), canonical w >= 0
inline Quat mat_to_quat(const float m[3][3]) {
  float qw2 = 1.0f + m[0][0] + m[1][1] + m[2][2];
  float qx2 = 1.0f + m[0][0] - m[1][1] - m[2][2];
  float qy2 = 1.0f - m[0][0] + m[1][1] - m[2][2];
  float qz2 = 1.0f - m[0][0] - m[1][1] + m[2][2];
  int best = 0;
  float mx = qw2;
  if (qx2 > mx) { mx = qx2; best = 1; }
  if (qy2 > mx) { mx = qy2; best = 2; }
  if (qz2 > mx) { mx = qz2; best = 3; }
  Quat q;
  auto ssqrt = [](float v) { return std::sqrt(std::max(v, 1e-12f)); };
  switch (best) {
    case 0: {
      float w = 0.5f * ssqrt(qw2);
      q = {(m[2][1] - m[1][2]) / (4 * w), (m[0][2] - m[2][0]) / (4 * w),
           (m[1][0] - m[0][1]) / (4 * w), w};
      break;
    }
    case 1: {
      float x = 0.5f * ssqrt(qx2);
      q = {x, (m[0][1] + m[1][0]) / (4 * x), (m[0][2] + m[2][0]) / (4 * x),
           (m[2][1] - m[1][2]) / (4 * x)};
      break;
    }
    case 2: {
      float y = 0.5f * ssqrt(qy2);
      q = {(m[0][1] + m[1][0]) / (4 * y), y, (m[1][2] + m[2][1]) / (4 * y),
           (m[0][2] - m[2][0]) / (4 * y)};
      break;
    }
    default: {
      float z = 0.5f * ssqrt(qz2);
      q = {(m[0][2] + m[2][0]) / (4 * z), (m[1][2] + m[2][1]) / (4 * z), z,
           (m[1][0] - m[0][1]) / (4 * z)};
    }
  }
  return qcanonical(qnormalize(q));
}

inline float yaw_from_quat(Quat q) {
  return std::atan2(2.0f * (q.w * q.z + q.x * q.y),
                    1.0f - 2.0f * (q.y * q.y + q.z * q.z));
}

inline float wrap_angle(float a) {
  // jnp.mod semantics: result in [0, 2*pi) before the shift
  float m = std::fmod(a + (float)M_PI, 2.0f * (float)M_PI);
  if (m < 0) m += 2.0f * (float)M_PI;
  return m - (float)M_PI;
}

// Gains: MUST stay in sync with airgym_tpu_torch/control/px4.py CascadeGains.
struct Gains {
  float rate_p[3] = {0.15f, 0.15f, 0.2f};
  float rate_i[3] = {0.2f, 0.2f, 0.1f};
  float rate_d[3] = {0.003f, 0.003f, 0.0f};
  float rate_int_lim = 0.30f;
  float torque_lim = 1.0f;
  float att_p[3] = {6.5f, 6.5f, 2.8f};
  float rate_max[3] = {3.8f, 3.8f, 3.5f};
  float vel_p[3] = {1.8f, 1.8f, 4.0f};
  float vel_i[3] = {0.4f, 0.4f, 2.0f};
  float vel_d[3] = {0.2f, 0.2f, 0.0f};
  float vel_int_lim = 5.0f;
  float pos_p[3] = {0.95f, 0.95f, 1.0f};
  float vel_max_xy = 12.0f;
  float vel_max_up = 3.0f;
  float vel_max_dn = 1.5f;
  float max_tilt = 0.78f;
  float thrust_min = 0.0f;
  float thrust_max = 1.0f;
  float mass = 0.601f;
  float thrust_scale = 9.59f;
  float gravity = 9.81f;
};

const Gains G;

}  // namespace

extern "C" {

// per-env controller memory; layout mirrors px4.CascadeState
struct CState {
  float rate_int[3];
  float prev_rate[3];
  float vel_int[3];
  float prev_vel_err[3];
  float yaw_sp;
};

void cascade_reset(int n, const unsigned char* mask, const float* quats_xyzw,
                   CState* cs) {
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    std::memset(&cs[i], 0, sizeof(CState));
    Quat q = {quats_xyzw[4 * i], quats_xyzw[4 * i + 1], quats_xyzw[4 * i + 2],
              quats_xyzw[4 * i + 3]};
    cs[i].yaw_sp = yaw_from_quat(q);
  }
}

}  // extern "C"

namespace {

// X-quad mixer with PX4-style desaturation (px4.mix_to_rotors)
void mix_to_rotors(const float tq[3], float thrust, float out[4]) {
  float tx = tq[0], ty = tq[1], tz = tq[2];
  float rp[4] = {-tx - ty, tx + ty, tx - ty, -tx + ty};
  float yaw[4] = {-tz, -tz, tz, tz};
  float f[4];
  float mn = 1e9f, mx = -1e9f;
  for (int i = 0; i < 4; ++i) {
    f[i] = thrust + rp[i];
    mn = std::min(mn, f[i]);
    mx = std::max(mx, f[i]);
  }
  float boost = std::max(0.0f, -mn);
  float reduce = std::max(0.0f, mx - 1.0f);
  mn = 1e9f; mx = -1e9f;
  for (int i = 0; i < 4; ++i) {
    f[i] += boost - reduce;
    mn = std::min(mn, f[i]);
    mx = std::max(mx, f[i]);
  }
  float margin_hi = 1.0f - mx;
  float margin_lo = mn;
  float yaw_mag = 0.0f;
  for (int i = 0; i < 4; ++i) yaw_mag = std::max(yaw_mag, std::fabs(yaw[i]));
  float yaw_scale = std::min(margin_hi, margin_lo) / std::max(yaw_mag, 1e-6f);
  yaw_scale = std::min(std::max(yaw_scale, 0.0f), 1.0f);
  for (int i = 0; i < 4; ++i)
    out[i] = std::min(std::max(f[i] + yaw[i] * yaw_scale, 0.0f), 1.0f);
}

void rate_control(CState& cs, Quat q, Vec3 w_world, const float rate_sp[3],
                  float thrust, float dt, float out[4]) {
  Vec3 wb = qrotate_inv(q, w_world);
  float w_body[3] = {wb.x, wb.y, wb.z};
  float torque[3];
  for (int a = 0; a < 3; ++a) {
    float err = rate_sp[a] - w_body[a];
    cs.rate_int[a] = std::min(std::max(cs.rate_int[a] + err * dt * G.rate_i[a],
                                       -G.rate_int_lim), G.rate_int_lim);
    float d_term = -(w_body[a] - cs.prev_rate[a]) / dt * G.rate_d[a];
    torque[a] = std::min(std::max(G.rate_p[a] * err + cs.rate_int[a] + d_term,
                                  -G.torque_lim), G.torque_lim);
    cs.prev_rate[a] = w_body[a];
  }
  mix_to_rotors(torque, thrust, out);
}

void attitude_rates(Quat q, Quat q_sp, const float* yaw_ff,
                    float rate_sp[3]) {
  Quat qe = qcanonical(qmul(qconj(qnormalize(q)), qnormalize(q_sp)));
  float e[3] = {2.0f * qe.x, 2.0f * qe.y, 2.0f * qe.z};
  for (int a = 0; a < 3; ++a) rate_sp[a] = G.att_p[a] * e[a];
  if (yaw_ff) rate_sp[2] += *yaw_ff;
  for (int a = 0; a < 3; ++a)
    rate_sp[a] = std::min(std::max(rate_sp[a], -G.rate_max[a]), G.rate_max[a]);
}

void accel_to_att_thrust(Vec3 acc_sp, float yaw_sp, Quat& q_sp,
                         float& thrust) {
  Vec3 f = acc_sp + v3(0, 0, G.gravity);
  float fz = std::max(f.z, 1e-3f);
  float max_xy = std::tan(G.max_tilt) * fz;
  float xy = std::sqrt(f.x * f.x + f.y * f.y);
  float scale = std::min(1.0f, max_xy / std::max(xy, 1e-6f));
  f = v3(f.x * scale, f.y * scale, fz);
  float fn = norm(f);
  Vec3 b3 = (1.0f / std::max(fn, 1e-6f)) * f;
  Vec3 xc = v3(std::cos(yaw_sp), std::sin(yaw_sp), 0.0f);
  Vec3 b2 = cross(b3, xc);
  float b2n = std::max(norm(b2), 1e-6f);
  b2 = (1.0f / b2n) * b2;
  Vec3 b1 = cross(b2, b3);
  float m[3][3] = {{b1.x, b2.x, b3.x}, {b1.y, b2.y, b3.y}, {b1.z, b2.z, b3.z}};
  q_sp = mat_to_quat(m);
  thrust = std::min(std::max(fn * G.mass / (4.0f * G.thrust_scale),
                             G.thrust_min), G.thrust_max);
}

void velocity_control(CState& cs, Vec3 vel, Vec3 vel_sp, float yaw_sp,
                      float dt, Quat& q_sp, float& thrust) {
  float err[3] = {vel_sp.x - vel.x, vel_sp.y - vel.y, vel_sp.z - vel.z};
  float acc[3];
  for (int a = 0; a < 3; ++a) {
    cs.vel_int[a] = std::min(std::max(cs.vel_int[a] + err[a] * dt * G.vel_i[a],
                                      -G.vel_int_lim), G.vel_int_lim);
    float d_term = (err[a] - cs.prev_vel_err[a]) / dt * G.vel_d[a];
    acc[a] = G.vel_p[a] * err[a] + cs.vel_int[a] + d_term;
    cs.prev_vel_err[a] = err[a];
  }
  accel_to_att_thrust(v3(acc[0], acc[1], acc[2]), yaw_sp, q_sp, thrust);
}

}  // namespace

extern "C" {

// mode: 0 pos, 1 vel, 2 atti, 3 rate, 4 prop
// root_states: [n, 13] xyzw quats; actions: [n, 5 if atti else 4]
// cmds_out: [n, 4]
void cascade_run(int mode, int n, const float* root, const float* actions,
                 float dt, CState* cs, float* cmds_out) {
  int act_w = (mode == 2) ? 5 : 4;
  for (int i = 0; i < n; ++i) {
    const float* s = root + 13 * i;
    const float* a = actions + act_w * i;
    float* out = cmds_out + 4 * i;
    Quat q = qcanonical({s[3], s[4], s[5], s[6]});
    Vec3 pos = v3(s[0], s[1], s[2]);
    Vec3 vel = v3(s[7], s[8], s[9]);
    Vec3 w_world = v3(s[10], s[11], s[12]);

    switch (mode) {
      case 4: {  // prop passthrough
        for (int k = 0; k < 4; ++k)
          out[k] = std::min(std::max(a[k], 0.0f), 1.0f);
        break;
      }
      case 3: {  // rate (CTBR)
        float rate_sp[3] = {a[0], a[1], a[2]};
        float thrust = std::min(std::max(a[3], G.thrust_min), G.thrust_max);
        rate_control(cs[i], q, w_world, rate_sp, thrust, dt, out);
        break;
      }
      case 2: {  // atti (CTA): [qw qx qy qz thrust]
        Quat q_sp = qnormalize({a[1], a[2], a[3], a[0]});
        float thrust = std::min(std::max(a[4], G.thrust_min), G.thrust_max);
        float rate_sp[3];
        attitude_rates(q, q_sp, nullptr, rate_sp);
        rate_control(cs[i], q, w_world, rate_sp, thrust, dt, out);
        break;
      }
      case 1: {  // vel (LV): [vx vy vz yaw_rate]
        float yaw_rate = a[3];
        cs[i].yaw_sp = wrap_angle(cs[i].yaw_sp + yaw_rate * dt);
        Quat q_sp;
        float thrust;
        velocity_control(cs[i], vel, v3(a[0], a[1], a[2]), cs[i].yaw_sp, dt,
                         q_sp, thrust);
        float rate_sp[3];
        attitude_rates(q, q_sp, &yaw_rate, rate_sp);
        rate_control(cs[i], q, w_world, rate_sp, thrust, dt, out);
        break;
      }
      case 0: {  // pos (PY): [x y z yaw]
        Vec3 vel_sp = v3(G.pos_p[0] * (a[0] - pos.x),
                         G.pos_p[1] * (a[1] - pos.y),
                         G.pos_p[2] * (a[2] - pos.z));
        float vxy = std::sqrt(vel_sp.x * vel_sp.x + vel_sp.y * vel_sp.y);
        float sc = std::min(1.0f, G.vel_max_xy / std::max(vxy, 1e-6f));
        vel_sp.x *= sc;
        vel_sp.y *= sc;
        vel_sp.z = std::min(std::max(vel_sp.z, -G.vel_max_dn), G.vel_max_up);
        Quat q_sp;
        float thrust;
        velocity_control(cs[i], vel, vel_sp, a[3], dt, q_sp, thrust);
        float rate_sp[3];
        attitude_rates(q, q_sp, nullptr, rate_sp);
        rate_control(cs[i], q, w_world, rate_sp, thrust, dt, out);
        break;
      }
    }
  }
}

}  // extern "C"
