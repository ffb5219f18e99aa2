// Ray caster device functions of the depth camera: the ray of a pixel, the
// ground plane and one intersection routine per packed scene record kind,
// folded into a running minimum of the euclidean hit distance t.
//
// They repeat airgym_tpu/render/pallas_raycast.py `_make_caster` and the
// ray set-up of `_kernel` / `_kernel_image` operation for operation. The
// plain PyTorch version (airgym_tpu_torch/render/raycast.py) rounds every
// product and sum on its own, so a source that includes this header is
// built with -fmad=false: a contracted a*b+c would round once and could
// flip a grazing ray between hit and miss. For the same reason the
// reciprocal norm is the correctly rounded 1 / sqrtf, not rsqrtf.
//
// Packed record (12 floats, render/raycast.pack_scene):
//   [0] kind: 0 invalid | 1 cylinder | 2 sphere | 3 box | 4 annulus
//   [1:4] center
//   cylinder: [4:7] unit axis, [7] half length, [8] radius
//   sphere:   [8] radius
//   box:      [4] cos(yaw), [5] sin(yaw), [9:12] half extents
//   annulus:  [4:7] unit normal, [7] half thickness, [8] r_in, [9] r_out
// Records are laid out by kind segment (cylinders | spheres | boxes |
// annuli | padding). An optional per-env count of live records per segment
// (the culling prepass compacts survivors to the segment's front) skips
// whole groups of kGroup records past it, as the TPU kernel's guards do.
#pragma once

#include <cuda_runtime.h>

namespace airgym {

constexpr float kBig = 1e9f;
constexpr int kRecFloats = 12;
constexpr int kGroup = 8;
constexpr int kLanes = 128;   // the TPU image block's lane width: the hash
                              // RNG's pixel index is u * kLanes + v

enum RecordKind { kCylinder = 1, kSphere = 2, kBox = 3, kAnnulus = 4 };

struct Ray {
  float ox, oy, oz;    // origin
  float ux, uy, uz;    // unit direction
  float inv_norm;      // 1 / |d| of the unnormalised direction (x == 1)
};

// Ray of pixel (u, v) (u across the width, v down the height) for a
// camera at origin o with body rotation m (row-major 3x3).
__device__ __forceinline__ Ray make_ray(const float* m, float ox, float oy,
                                        float oz, int u, int v, int W, int H,
                                        float tan_h, float tan_v) {
  const float uf = (float)u, vf = (float)v;
  const float y = tan_h * (1.0f - 2.0f * (uf + 0.5f) / (float)W);
  const float z = tan_v * (1.0f - 2.0f * (vf + 0.5f) / (float)H);
  const float dx = m[0] + m[1] * y + m[2] * z;
  const float dy = m[3] + m[4] * y + m[5] * z;
  const float dz = m[6] + m[7] * y + m[8] * z;
  const float nsq = dx * dx + dy * dy + dz * dz;
  float inv = 1.0f / sqrtf(nsq);
  inv = inv * (1.5f - 0.5f * nsq * inv * inv);   // the TPU kernel's Newton step
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.ux = dx * inv; r.uy = dy * inv; r.uz = dz * inv;
  r.inv_norm = inv;
  return r;
}

__device__ __forceinline__ float safe_eps(float x, float eps) {
  return fabsf(x) < eps ? eps : x;
}

__device__ __forceinline__ float cast_ground(const Ray& r, float t) {
  const float tg = (0.0f - r.oz) / safe_eps(r.uz, 1e-9f);
  return tg > 1e-6f ? fminf(t, tg) : t;
}

template <int KIND>
__device__ __forceinline__ float cast_record(const float* rec, const Ray& r,
                                             float t_eu) {
  const float valid = rec[0];
  const float ocx = r.ox - rec[1];
  const float ocy = r.oy - rec[2];
  const float ocz = r.oz - rec[3];
  const float ux = r.ux, uy = r.uy, uz = r.uz;
  float t_p;
  bool hit;
  if (KIND == kCylinder) {
    const float ax = rec[4], ay = rec[5], az = rec[6];
    const float hl = rec[7], rad = rec[8];
    const float v_par = ux * ax + uy * ay + uz * az;
    const float o_par = ocx * ax + ocy * ay + ocz * az;
    const float vpx = ux - v_par * ax, vpy = uy - v_par * ay,
                vpz = uz - v_par * az;
    const float opx = ocx - o_par * ax, opy = ocy - o_par * ay,
                opz = ocz - o_par * az;
    const float a = vpx * vpx + vpy * vpy + vpz * vpz;
    const float b = opx * vpx + opy * vpy + opz * vpz;
    const float c = opx * opx + opy * opy + opz * opz - rad * rad;
    const float disc = b * b - a * c;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    t_p = (-b - sq) / (a < 1e-9f ? 1e-9f : a);
    const float h = o_par + t_p * v_par;
    hit = (disc > 0.0f) && (t_p > 1e-6f) && (fabsf(h) <= hl);
  } else if (KIND == kSphere) {
    const float rad = rec[8];
    const float b_s = ocx * ux + ocy * uy + ocz * uz;
    const float c_s = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc_s = b_s * b_s - c_s;
    t_p = -b_s - sqrtf(fmaxf(disc_s, 0.0f));
    hit = (disc_s > 0.0f) && (t_p > 1e-6f);
  } else if (KIND == kBox) {
    const float cyaw = rec[4], syaw = rec[5];
    const float lox = cyaw * ocx + syaw * ocy;
    const float loy = -syaw * ocx + cyaw * ocy;
    const float lvx = cyaw * ux + syaw * uy;
    const float lvy = -syaw * ux + cyaw * uy;
    const float o3[3] = {lox, loy, ocz};
    const float d3[3] = {lvx, lvy, uz};
    float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float he = rec[9 + k];
      const float d = safe_eps(d3[k], 1e-9f);
      const float t1 = (-he - o3[k]) / d;
      const float t2 = (he - o3[k]) / d;
      const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
      tmin = k == 0 ? lo : fmaxf(tmin, lo);
      tmax = k == 0 ? hi : fminf(tmax, hi);
    }
    t_p = tmin > 1e-6f ? tmin : tmax;
    hit = (tmax >= tmin) && (tmax > 1e-6f);
  } else {  // annulus: the thickness slab intersected with the radial band
    const float nx = rec[4], ny = rec[5], nz = rec[6];
    const float ht = rec[7], ri = rec[8], ro = rec[9];
    const float vh = ux * nx + uy * ny + uz * nz;
    const float oh = ocx * nx + ocy * ny + ocz * nz;
    const float vh_safe = safe_eps(vh, 1e-9f);
    const float tsa = (-ht - oh) / vh_safe;
    const float tsb = (ht - oh) / vh_safe;
    float ts1 = fminf(tsa, tsb), ts2 = fmaxf(tsa, tsb);
    if (fabsf(vh) < 1e-9f) {           // ray parallel to the disc
      const bool in_slab = fabsf(oh) <= ht;
      ts1 = in_slab ? -kBig : kBig;
      ts2 = in_slab ? kBig : -kBig;
    }
    const float vpx = ux - vh * nx, vpy = uy - vh * ny, vpz = uz - vh * nz;
    const float opx = ocx - oh * nx, opy = ocy - oh * ny, opz = ocz - oh * nz;
    const float a = vpx * vpx + vpy * vpy + vpz * vpz;
    const float b = opx * vpx + opy * vpy + opz * vpz;
    const float osq = opx * opx + opy * opy + opz * opz;
    const float a_safe = fmaxf(a, 1e-12f);
    const bool par = a < 1e-12f;       // ray along the normal
    const float c_o = osq - ro * ro;
    const float disc_o = b * b - a * c_o;
    const float sq_o = sqrtf(fmaxf(disc_o, 0.0f));
    float to1 = (-b - sq_o) / a_safe;
    float to2 = (-b + sq_o) / a_safe;
    const float c_i = osq - ri * ri;
    const bool in_band = (c_o <= 0.0f) && (c_i > 0.0f);
    if (par) {
      to1 = in_band ? -kBig : kBig;
      to2 = in_band ? kBig : -kBig;
    } else {
      to1 = disc_o > 0.0f ? to1 : kBig;
      to2 = disc_o > 0.0f ? to2 : -kBig;
    }
    const float disc_i = b * b - a * c_i;
    const float sq_i = sqrtf(fmaxf(disc_i, 0.0f));
    const float ti1 = (-b - sq_i) / a_safe;
    const float ti2 = (-b + sq_i) / a_safe;
    const bool has_inner = (disc_i > 0.0f) && !par && (ri > 0.0f);
    float lo = fmaxf(ts1, to1);
    const float hi = fminf(ts2, to2);
    if (has_inner && (lo > ti1) && (lo < ti2)) lo = ti2;
    t_p = lo;
    hit = (lo <= hi) && (lo > 1e-6f);
  }
  return fminf(t_eu, (hit && valid > 0.0f) ? t_p : kBig);
}

// One kind segment of n records starting at record p: groups of kGroup
// records run while the group's first index is below `live`.
template <int KIND>
__device__ __forceinline__ float cast_segment(const float* prims, int p,
                                              int n, int live, const Ray& r,
                                              float t) {
  for (int g0 = 0; g0 < n; g0 += kGroup) {
    if (g0 >= live) break;              // live records are a prefix
    const int g = min(kGroup, n - g0);
    for (int k = 0; k < g; ++k)
      t = cast_record<KIND>(prims + (p + g0 + k) * kRecFloats, r, t);
  }
  return t;
}

// Every segment of the table: seg[k] records of kind k + 1, live[k] of
// them live.
__device__ __forceinline__ float cast_scene(const float* prims,
                                            const int* seg, const int* live,
                                            const Ray& r, float t) {
  int p = 0;
  t = cast_segment<kCylinder>(prims, p, seg[0], live[0], r, t);
  p += seg[0];
  t = cast_segment<kSphere>(prims, p, seg[1], live[1], r, t);
  p += seg[1];
  t = cast_segment<kBox>(prims, p, seg[2], live[2], r, t);
  p += seg[2];
  t = cast_segment<kAnnulus>(prims, p, seg[3], live[3], r, t);
  return t;
}

}  // namespace airgym
