// Ray caster of the depth camera, shared by render_process.cu and
// render_depth.cu: the ray of a pixel, the ground plane and one
// intersection routine per packed scene record kind, folded into a running
// minimum of the euclidean hit distance t.
//
// They repeat airgym_tpu/render/pallas_raycast.py `_make_caster` and the
// ray set-up of `_kernel` / `_kernel_image` operation for operation. The
// plain PyTorch version (airgym_tpu_torch/render/raycast.py) rounds every
// product and sum on its own, so a source that includes this header is
// built with -fmad=false: a contracted a*b+c would round once and could
// flip a grazing ray between hit and miss. For the same reason the
// reciprocal norm is the correctly rounded 1 / sqrtf, not rsqrtf, and
// every division stays an IEEE division by the same operands.
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
//
// The camera origin is the same for every pixel of an env, so once per
// block build_scene turns the env's records into per-kind structs in
// shared memory that hold every term built from the record and the origin
// alone (oc, the cylinder's o_par / op / c, the sphere's c, the box's slab
// numerators, the annulus's oh / op / c_o / c_i and its in-slab / in-band
// choices), laid out as float4s for 128-bit broadcast loads. The pixel
// loop computes only the terms that depend on the ray's direction, with
// the same operations on the same operands in the same order, so every
// rounded value keeps its bits. A record that is invalid, or sits in a
// group past the live count, cannot lower t (its term is fminf(t, kBig)),
// so the prepass leaves it out; the minimum is exact and does not depend
// on the order. build_tables stores the ray's pixel-column and pixel-row
// terms, so a pixel's direction costs three additions.
#pragma once

#ifndef AIRGYM_CUDA_EMU
#include <cuda_runtime.h>
#endif

namespace airgym {

constexpr float kBig = 1e9f;
constexpr int kRecFloats = 12;
constexpr int kGroup = 8;
constexpr int kLanes = 128;   // the TPU image block's lane width: the hash
                              // RNG's pixel index is u * kLanes + v
constexpr int kKinds = 4;

enum RecordKind { kCylinder = 1, kSphere = 2, kBox = 3, kAnnulus = 4 };

// float4s of one record's struct, by kind slot (kind - 1)
__host__ __device__ constexpr int struct_f4(int slot) {
  return slot == 0 ? 3 : slot == 1 ? 1 : slot == 2 ? 2 : 4;
}
constexpr int kMaxStructF4 = 4;

// float4s of the ray tables: one per pixel column, one per pixel row
__host__ __device__ constexpr int table_f4(int W, int H) { return W + H; }

__device__ __forceinline__ float safe_eps(float x, float eps) {
  return fabsf(x) < eps ? eps : x;
}

// Ray tables of one env, for a camera with body rotation m (row-major
// 3x3): col[u] = (m0 + m1 y, m3 + m4 y, m6 + m7 y), row[v] = (m2 z, m5 z,
// m8 z), with y and z of the pixel as the TPU kernel computes them, so
// that d = col[u] + row[v] is its m[0] + m[1] * y + m[2] * z, bit for bit.
__device__ __forceinline__ void build_tables(const float* m, int W, int H,
                                             float tan_h, float tan_v,
                                             float4* col, float4* row) {
  for (int i = threadIdx.x; i < W + H; i += blockDim.x) {
    if (i < W) {
      const float y = tan_h * (1.0f - 2.0f * ((float)i + 0.5f) / (float)W);
      col[i] = make_float4(m[0] + m[1] * y, m[3] + m[4] * y, m[6] + m[7] * y,
                           0.0f);
    } else {
      const int v = i - W;
      const float z = tan_v * (1.0f - 2.0f * ((float)v + 0.5f) / (float)H);
      row[v] = make_float4(m[2] * z, m[5] * z, m[8] * z, 0.0f);
    }
  }
}

// One record's struct from its packed floats r and the origin o.
template <int KIND>
__device__ __forceinline__ void build_struct(const float* r, float ox,
                                             float oy, float oz, float4* s) {
  const float ocx = ox - r[1];
  const float ocy = oy - r[2];
  const float ocz = oz - r[3];
  if (KIND == kCylinder) {
    const float ax = r[4], ay = r[5], az = r[6], rad = r[8];
    const float o_par = ocx * ax + ocy * ay + ocz * az;
    const float opx = ocx - o_par * ax, opy = ocy - o_par * ay,
                opz = ocz - o_par * az;
    const float c = opx * opx + opy * opy + opz * opz - rad * rad;
    s[0] = make_float4(ax, ay, az, o_par);
    s[1] = make_float4(opx, opy, opz, c);
    s[2] = make_float4(r[7], 0.0f, 0.0f, 0.0f);     // half length
  } else if (KIND == kSphere) {
    const float rad = r[8];
    const float c_s = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    s[0] = make_float4(ocx, ocy, ocz, c_s);
  } else if (KIND == kBox) {
    const float cyaw = r[4], syaw = r[5];
    const float lox = cyaw * ocx + syaw * ocy;
    const float loy = -syaw * ocx + cyaw * ocy;
    // the slab numerators -he - o and he - o of each local axis
    s[0] = make_float4(cyaw, syaw, -r[9] - lox, r[9] - lox);
    s[1] = make_float4(-r[10] - loy, r[10] - loy, -r[11] - ocz, r[11] - ocz);
  } else {
    const float nx = r[4], ny = r[5], nz = r[6];
    const float ht = r[7], ri = r[8], ro = r[9];
    const float oh = ocx * nx + ocy * ny + ocz * nz;
    const bool in_slab = fabsf(oh) <= ht;
    const float opx = ocx - oh * nx, opy = ocy - oh * ny, opz = ocz - oh * nz;
    const float osq = opx * opx + opy * opy + opz * opz;
    const float c_o = osq - ro * ro;
    const float c_i = osq - ri * ri;
    const bool in_band = (c_o <= 0.0f) && (c_i > 0.0f);
    s[0] = make_float4(nx, ny, nz, -ht - oh);
    // the slab's and the band's (t1, t2) for a ray parallel to the disc /
    // along the normal
    s[1] = make_float4(ht - oh, in_slab ? -kBig : kBig,
                       in_slab ? kBig : -kBig, c_o);
    s[2] = make_float4(opx, opy, opz, c_i);
    s[3] = make_float4(in_band ? -kBig : kBig, in_band ? kBig : -kBig, ri,
                       0.0f);
  }
}

// Warp k (k < 4, the block must hold 4 warps) compacts segment k of the
// table (seg_k records of kind k + 1, live[k] of them live): the valid
// records of its live groups, in order, each built into its struct at
// recs + base[k] + i * struct_f4(k); n[k] is their count.
__device__ __forceinline__ void build_scene(const float* prims, int seg_0,
                                            int seg_1, int seg_2, int seg_3,
                                            const int* live, float ox,
                                            float oy, float oz, float4* recs,
                                            int* base, int* n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= kKinds) return;
  const int p = (warp > 0 ? seg_0 : 0) + (warp > 1 ? seg_1 : 0)
                + (warp > 2 ? seg_2 : 0);
  const int b = (warp > 0 ? seg_0 * struct_f4(0) : 0)
                + (warp > 1 ? seg_1 * struct_f4(1) : 0)
                + (warp > 2 ? seg_2 * struct_f4(2) : 0);
  const int seg = warp == 0 ? seg_0 : warp == 1 ? seg_1
                  : warp == 2 ? seg_2 : seg_3;
  // a record is cast when its group starts below the live count
  const int lim = min(seg, (live[warp] + kGroup - 1) / kGroup * kGroup);
  int count = 0;
  for (int j0 = 0; j0 < lim; j0 += 32) {
    const int j = j0 + lane;
    const float* r = prims + (size_t)(p + j) * kRecFloats;
    const bool keep = j < lim && r[0] > 0.0f;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      float4* s = recs + b + (count + __popc(mask & ((1u << lane) - 1u)))
                  * struct_f4(warp);
      switch (warp) {
        case 0: build_struct<kCylinder>(r, ox, oy, oz, s); break;
        case 1: build_struct<kSphere>(r, ox, oy, oz, s); break;
        case 2: build_struct<kBox>(r, ox, oy, oz, s); break;
        default: build_struct<kAnnulus>(r, ox, oy, oz, s); break;
      }
    }
    count += __popc(mask);
  }
  if (lane == 0) {
    base[warp] = b;
    n[warp] = count;
  }
}

// A pixel's unit direction and 1 / |d| (the TPU kernel's Newton step on
// the correctly rounded 1 / sqrtf), from its column and row terms.
struct PixelRay {
  float ux, uy, uz, inv_norm;
};

__device__ __forceinline__ PixelRay pixel_ray(float4 c, float4 r) {
  const float dx = c.x + r.x, dy = c.y + r.y, dz = c.z + r.z;
  const float nsq = dx * dx + dy * dy + dz * dz;
  float inv = 1.0f / sqrtf(nsq);
  inv = inv * (1.5f - 0.5f * nsq * inv * inv);
  return {dx * inv, dy * inv, dz * inv, inv};
}

// the ground plane z = 0; neg_oz = 0 - oz
__device__ __forceinline__ float cast_ground(float neg_oz, float uz, float t) {
  const float tg = neg_oz / safe_eps(uz, 1e-9f);
  return tg > 1e-6f ? fminf(t, tg) : t;
}

// One record's struct s against a ray of unit direction (ux, uy, uz).
template <int KIND>
__device__ __forceinline__ float cast_struct(const float4* s, float ux,
                                             float uy, float uz, float t) {
  float t_p;
  bool hit;
  if (KIND == kCylinder) {
    const float4 A = s[0], B = s[1];     // ax ay az o_par | opx opy opz c
    const float hl = s[2].x;
    const float v_par = ux * A.x + uy * A.y + uz * A.z;
    const float vpx = ux - v_par * A.x, vpy = uy - v_par * A.y,
                vpz = uz - v_par * A.z;
    const float a = vpx * vpx + vpy * vpy + vpz * vpz;
    const float b = B.x * vpx + B.y * vpy + B.z * vpz;
    const float disc = b * b - a * B.w;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    t_p = (-b - sq) / (a < 1e-9f ? 1e-9f : a);
    const float h = A.w + t_p * v_par;
    hit = (disc > 0.0f) && (t_p > 1e-6f) && (fabsf(h) <= hl);
  } else if (KIND == kSphere) {
    const float4 A = s[0];               // ocx ocy ocz c_s
    const float b_s = A.x * ux + A.y * uy + A.z * uz;
    const float disc_s = b_s * b_s - A.w;
    t_p = -b_s - sqrtf(fmaxf(disc_s, 0.0f));
    hit = (disc_s > 0.0f) && (t_p > 1e-6f);
  } else if (KIND == kBox) {
    const float4 A = s[0], B = s[1];     // cyaw syaw n1x n2x | n1y n2y n1z n2z
    const float lvx = A.x * ux + A.y * uy;
    const float lvy = -A.y * ux + A.x * uy;
    const float d3[3] = {lvx, lvy, uz};
    const float n1[3] = {A.z, B.x, B.z}, n2[3] = {A.w, B.y, B.w};
    float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = safe_eps(d3[k], 1e-9f);
      const float t1 = n1[k] / d;
      const float t2 = n2[k] / d;
      const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
      tmin = k == 0 ? lo : fmaxf(tmin, lo);
      tmax = k == 0 ? hi : fminf(tmax, hi);
    }
    t_p = tmin > 1e-6f ? tmin : tmax;
    hit = (tmax >= tmin) && (tmax > 1e-6f);
  } else {  // annulus: the thickness slab intersected with the radial band
    // nx ny nz (-ht - oh) | (ht - oh) slab_t1 slab_t2 c_o |
    // opx opy opz c_i | band_t1 band_t2 r_in -
    const float4 A = s[0], B = s[1], C = s[2], D = s[3];
    const float vh = ux * A.x + uy * A.y + uz * A.z;
    const float vh_safe = safe_eps(vh, 1e-9f);
    const float tsa = A.w / vh_safe;
    const float tsb = B.x / vh_safe;
    float ts1 = fminf(tsa, tsb), ts2 = fmaxf(tsa, tsb);
    if (fabsf(vh) < 1e-9f) {           // ray parallel to the disc
      ts1 = B.y;
      ts2 = B.z;
    }
    const float vpx = ux - vh * A.x, vpy = uy - vh * A.y, vpz = uz - vh * A.z;
    const float a = vpx * vpx + vpy * vpy + vpz * vpz;
    const float b = C.x * vpx + C.y * vpy + C.z * vpz;
    const float a_safe = fmaxf(a, 1e-12f);
    const bool par = a < 1e-12f;       // ray along the normal
    const float disc_o = b * b - a * B.w;
    const float sq_o = sqrtf(fmaxf(disc_o, 0.0f));
    float to1 = (-b - sq_o) / a_safe;
    float to2 = (-b + sq_o) / a_safe;
    if (par) {
      to1 = D.x;
      to2 = D.y;
    } else {
      to1 = disc_o > 0.0f ? to1 : kBig;
      to2 = disc_o > 0.0f ? to2 : -kBig;
    }
    const float disc_i = b * b - a * C.w;
    const float sq_i = sqrtf(fmaxf(disc_i, 0.0f));
    const float ti1 = (-b - sq_i) / a_safe;
    const float ti2 = (-b + sq_i) / a_safe;
    const bool has_inner = (disc_i > 0.0f) && !par && (D.z > 0.0f);
    float lo = fmaxf(ts1, to1);
    const float hi = fminf(ts2, to2);
    if (has_inner && (lo > ti1) && (lo < ti2)) lo = ti2;
    t_p = lo;
    hit = (lo <= hi) && (lo > 1e-6f);
  }
  return fminf(t, hit ? t_p : kBig);
}

// Every struct of one kind against NP rays (their directions u[i][0..2],
// their running t[i]). Cylinders and spheres take the NP rays together: a
// struct is read once for all, and their chains interleave. Boxes and
// annuli take one ray at a time: each cast carries six IEEE divisions, and
// with NP chains in flight across their slow-path calls the registers run
// out at 64 a thread (spills); one at a time they fit, and run faster.
template <int KIND, int NP>
__device__ __forceinline__ void cast_kind(const float4* recs, int n,
                                          const float (&u)[NP][3],
                                          float (&t)[NP]) {
  constexpr int F = struct_f4(KIND - 1);
  if (KIND == kBox || KIND == kAnnulus) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      for (int i = 0; i < n; ++i)
        t[p] = cast_struct<KIND>(recs + i * F, u[p][0], u[p][1], u[p][2],
                                 t[p]);
  } else {
    for (int i = 0; i < n; ++i) {
      float4 s[F];
#pragma unroll
      for (int f = 0; f < F; ++f) s[f] = recs[i * F + f];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        t[p] = cast_struct<KIND>(s, u[p][0], u[p][1], u[p][2], t[p]);
    }
  }
}

// The scene built by build_scene against NP rays.
template <int NP>
__device__ __forceinline__ void cast_scene(const float4* recs,
                                           const int* base, const int* n,
                                           const float (&u)[NP][3],
                                           float (&t)[NP]) {
  cast_kind<kCylinder>(recs + base[0], n[0], u, t);
  cast_kind<kSphere>(recs + base[1], n[1], u, t);
  cast_kind<kBox>(recs + base[2], n[2], u, t);
  cast_kind<kAnnulus>(recs + base[3], n[3], u, t);
}

// A block's walk over pixels p = p0 + k * step of an image of H rows:
// (u, v) advance by (step / H, step % H), so no pixel needs a division.
struct PixelWalk {
  int u, v, du, dv, H;
  __device__ __forceinline__ PixelWalk(int p0, int step, int H_)
      : u(p0 / H_), v(p0 % H_), du(step / H_), dv(step % H_), H(H_) {}
  __device__ __forceinline__ void next() {
    u += du;
    v += dv;
    if (v >= H) {
      v -= H;
      ++u;
    }
  }
};

#ifdef AIRGYM_RENDER_CLOCKS
// The per-pixel body of one record kind (KIND 0: none) for the SASS
// counts of the clock build: a struct from shared memory against one ray.
template <int KIND>
__global__ void sass_probe(const float4* rec_g, const float* ray_g,
                           float* out) {
  __shared__ float4 rec[kMaxStructF4];
  if (threadIdx.x < kMaxStructF4) rec[threadIdx.x] = rec_g[threadIdx.x];
  __syncthreads();
  const float* g = ray_g + 4 * threadIdx.x;
  float t = g[3];
  if (KIND) t = cast_struct<KIND ? KIND : 1>(rec, g[0], g[1], g[2], t);
  out[threadIdx.x] = t;
}
template __global__ void sass_probe<0>(const float4*, const float*, float*);
template __global__ void sass_probe<1>(const float4*, const float*, float*);
template __global__ void sass_probe<2>(const float4*, const float*, float*);
template __global__ void sass_probe<3>(const float4*, const float*, float*);
template __global__ void sass_probe<4>(const float4*, const float*, float*);
#endif

}  // namespace airgym
