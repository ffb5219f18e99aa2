// Fused depth render + post-processing: one block renders and processes
// one env's whole camera image, and the raw depth never reaches device
// memory.
//
// Replaces: airgym_tpu/render/pallas_raycast.py `_kernel_image` (wrapper
// `render_process_pallas`). Per env: the ray of every pixel, the ground
// plane and every packed scene record folded into the nearest hit
// (raycast.cuh; with culling on, whole groups of 8 records past the env's
// live count are skipped), z-depth = t * inv_norm, then the reference's
// post-processing (customized.py:399-427): clip to [0, clamp] / clamp;
// + 0.1 N(0,1) clipped to [0, image max]; * (1 + 0.3 N(0,1)) clipped to
// [0, new max]; an unnormalised 5x5 cross-correlation with the env's 25
// hashed taps, zero-padded SAME. The normals come from the hash RNG of
// common.cuh keyed by the env seed and the pixel index u * 128 + v
// (counters 1-2 for the first normal, 3-4 for the second), as the TPU
// kernel draws them over its 128-lane image block.
//
// Bound on the card: FP32 operations, counted by hand from this source
// and raycast.cuh (chip_smoke.py's RAY_OPS ... TABLE_OPS: each add,
// multiply, division, square root, log, cosine, comparison, minimum,
// maximum and absolute value as one; selects, negations and the hash's
// integer work not counted). Per pixel 18 for the ray, 5 for the ground,
// 5 for the clip / normalise and 17 for each noise; per blur tap inside
// the image 2; per pixel and cast record (a valid record of a live
// group) 36 for a cylinder, 13 a sphere, 32 a box, 60 an annulus; per
// cast record and env the prepass's 22, 11, 16, 30. At Planning's shape
// (4096 envs, 212 x 120, 17.0 of 40 cylinders cast per env after
// culling) that is 7.5e10 operations, 1.12 ms at 67 TFLOP/s, against
// 417 MB written (0.12 ms at 3.35 TB/s). chip_smoke.py computes the
// bound from the records its run casts. Built with -fmad=false the code
// has no FMA, so its FP32 pipes retire at most half of that peak.
//
// Design: one block of 512 threads per env, two blocks per SM (at most 64
// registers a thread), 32 warps an SM. The prepass (raycast.cuh) builds
// the env's record structs and ray tables in shared memory; the loops over
// records are uniform across the block (broadcast float4 reads). The
// clipped image (W * H floats, 101,760 bytes at 212 x 120) stays in
// dynamic shared memory between the cast, the two whole-image maxima
// (block reductions) and the blur. Each thread keeps the pixels
// p = tid + k * 512 through the cast and both noise passes, walking their
// (u, v) without a division; the cast takes kPix of them at once, so that
// a record's struct is read once for all and their chains interleave.
// The blur gives each thread kStrip consecutive rows u of one column v:
// it reads rows u - 2 .. u + kStrip + 1 once each into a window of 5
// values and keeps the 25 taps in registers. Every output keeps its sum
// order (a outer, b inner); a tap outside the image adds tap * 0 = +0 to
// a sum that is >= +0, which leaves it as the skip did.
//
// Built with -DAIRGYM_RENDER_CLOCKS, thread 0 of every block adds the
// cycles of the prepass, the cast (with the first maximum), noise 1 (with
// the second), noise 2 and the blur to five device counters
// (render_process_phase_cycles); kernels/render_ab.py and chip_smoke.py
// print the split. What bounds it now: on an H100 the cast takes 86% of a
// Planning block (0.59 M cycles per env, 5.7 ms a render), the noises 5%
// each and the blur 4%; the cast issues about 60 instructions per
// cylinder and pixel, a sixth of them in the IEEE division and square
// root, which keep the plain version's bits.
//
// Built with -fmad=false (see raycast.cuh): the plain version in
// render/raycast.py rounds like this source, so the two agree to the last
// bit except where the library's log / cos differ.
#include <cstdint>

#include "common.cuh"
#include "raycast.cuh"

namespace {

using namespace airgym;

constexpr int kThreads = 512;
constexpr int kPix = 2;             // pixels a thread casts at once
constexpr int kStrip = 4;           // blur rows per thread item
constexpr int kMaxSmem = 232448;    // bytes a block may use on sm_90
constexpr int kPhases = 5;

#ifdef AIRGYM_RENDER_CLOCKS
__device__ unsigned long long g_phase_cycles[kPhases];
// thread 0 keeps its timestamps in shared memory, not in registers
#define AIRGYM_CLOCK(i) \
  if (threadIdx.x == 0) clk[i] = clock64()
#else
#define AIRGYM_CLOCK(i)
#endif

// floats of the image, rounded up to whole float4s
__host__ __device__ constexpr int image_floats(int W, int H) {
  return (W * H + 3) / 4 * 4;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

__global__ void __launch_bounds__(kThreads, 2)
render_process_kernel(const float* __restrict__ origins,   // [N, 8]
                      const float* __restrict__ rots,      // [N, 16]
                      const float* __restrict__ prims,     // [N, P, 12]
                      const int* __restrict__ live,        // [N, 4]
                      const uint32_t* __restrict__ seeds,  // [N]
                      const float* __restrict__ taps,      // [N, 32]
                      float* __restrict__ out,             // [N, W, H]
                      int P, int n_cyl, int n_sph, int n_box, int n_ann,
                      int W, int H, float tan_h, float tan_v, int ground,
                      float clamp) {
  AIRGYM_DYN_SMEM(smem);
  float* img = smem;                                           // [W * H]
  float4* col = reinterpret_cast<float4*>(smem + image_floats(W, H));
  float4* row = col + W;                                       // [H]
  float4* recs = row + H;                                      // structs
  __shared__ float s_tap[25], s_red[kThreads / 32];
  __shared__ int s_base[kKinds], s_n[kKinds];
#ifdef AIRGYM_RENDER_CLOCKS
  __shared__ long long clk[kPhases + 1];
#endif
  AIRGYM_CLOCK(0);

  const int env = blockIdx.x, tid = threadIdx.x;
  const int R = W * H;
  // 0. prepass: record structs, ray tables, taps
  const float* o = origins + (size_t)env * 8;
  const float ox = o[0], oy = o[1], oz = o[2];
  build_scene(prims + (size_t)env * P * kRecFloats, n_cyl, n_sph, n_box,
              n_ann, live + (size_t)env * kKinds, ox, oy, oz, recs, s_base,
              s_n);
  build_tables(rots + (size_t)env * 16, W, H, tan_h, tan_v, col, row);
  if (tid < 25) s_tap[tid] = taps[(size_t)env * 32 + tid];
  __syncthreads();
  AIRGYM_CLOCK(1);

  // 1. cast, z-depth, clip / normalise
  const float neg_oz = 0.0f - oz;
  float lmax = 0.0f;
  {
    PixelWalk w(tid, kThreads, H);
    for (int p0 = tid; p0 < R; p0 += kPix * kThreads) {
      float u[kPix][3], t[kPix], inv[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const bool in = p0 + j * kThreads < R;
        const PixelRay r = pixel_ray(col[in ? w.u : 0], row[in ? w.v : 0]);
        u[j][0] = r.ux;
        u[j][1] = r.uy;
        u[j][2] = r.uz;
        inv[j] = r.inv_norm;
        t[j] = ground ? cast_ground(neg_oz, r.uz, kBig) : kBig;
        w.next();
      }
      cast_scene<kPix>(recs, s_base, s_n, u, t);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const int p = p0 + j * kThreads;
        if (p < R) {
          const float x = fminf(fmaxf(t[j] * inv[j], 0.0f), clamp) / clamp;
          img[p] = x;
          lmax = fmaxf(lmax, x);
        }
      }
    }
  }
  const float mx1 = block_max(lmax, s_red);
  AIRGYM_CLOCK(2);

  // 2. additive noise (draws 1, 2), clipped to [0, max]
  const uint32_t seed = seeds[env];
  lmax = 0.0f;
  {
    PixelWalk w(tid, kThreads, H);
#pragma unroll 2
    for (int p = tid; p < R; p += kThreads) {
      HashUniform draw(seed, (uint32_t)(w.u * kLanes + w.v));
      w.next();
      const float n1 = normal(draw);
      const float x = fminf(fmaxf(img[p] + 0.1f * n1, 0.0f), mx1);
      img[p] = x;
      lmax = fmaxf(lmax, x);
    }
  }
  const float mx2 = block_max(lmax, s_red);
  AIRGYM_CLOCK(3);

  // 3. multiplicative noise (draws 3, 4), clipped to [0, new max]
  {
    PixelWalk w(tid, kThreads, H);
#pragma unroll 2
    for (int p = tid; p < R; p += kThreads) {
      HashUniform draw(seed, (uint32_t)(w.u * kLanes + w.v));
      w.next();
      draw.counter = 2u;
      const float n2 = normal(draw);
      img[p] = fminf(fmaxf(img[p] * (1.0f + 0.3f * n2), 0.0f), mx2);
    }
  }
  __syncthreads();
  AIRGYM_CLOCK(4);

  // 4. blur: out[u, v] = sum_a sum_b tap[5a + b] * img[u + a - 2, v + b - 2]
  float tap[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) tap[i] = s_tap[i];
  float* my_out = out + (size_t)env * R;
  const int items = (W + kStrip - 1) / kStrip * H;
  {
    PixelWalk w(tid, kThreads, H);       // (strip, v)
    for (int i = tid; i < items; i += kThreads) {
      const int u0 = w.u * kStrip, v = w.v;
      w.next();
      float acc[kStrip];
#pragma unroll
      for (int s = 0; s < kStrip; ++s) acc[s] = 0.0f;
#pragma unroll
      for (int r = 0; r < kStrip + 4; ++r) {     // input row u0 + r - 2
        const int uu = u0 + r - 2;
        const bool row_in = uu >= 0 && uu < W;
        float x[5];
#pragma unroll
        for (int b = 0; b < 5; ++b) {
          const int vv = v + b - 2;
          x[b] = row_in && vv >= 0 && vv < H ? img[uu * H + vv] : 0.0f;
        }
#pragma unroll
        for (int s = 0; s < kStrip; ++s) {       // output row u0 + s
          const int a = r - s;
          if (a < 0 || a >= 5) continue;
#pragma unroll
          for (int b = 0; b < 5; ++b) acc[s] = acc[s] + tap[a * 5 + b] * x[b];
        }
      }
#pragma unroll
      for (int s = 0; s < kStrip; ++s)
        if (u0 + s < W) my_out[(u0 + s) * H + v] = acc[s];
    }
  }
#ifdef AIRGYM_RENDER_CLOCKS
  __syncthreads();
  AIRGYM_CLOCK(5);
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i)
      atomicAdd(&g_phase_cycles[i], (unsigned long long)(clk[i + 1] - clk[i]));
#endif
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Dynamic shared memory of one block, in bytes (0 if it exceeds the card's
// per-block limit): the image, the ray tables and room for P structs of
// the largest kind.
extern "C" int render_process_smem_bytes(int P, int W, int H) {
  const long long structs = (long long)P * kMaxStructF4;
  const long long bytes =
      (long long)image_floats(W, H) * 4 + 16LL * (table_f4(W, H) + structs);
  return bytes > kMaxSmem ? 0 : (int)bytes;
}

// Returns a cudaError_t (0 = launched). Launches on `stream`, never syncs.
extern "C" int render_process_launch(const float* origins, const float* rots,
                                     const float* prims, const int* live,
                                     const unsigned int* seeds,
                                     const float* taps, float* out, int n,
                                     int P, int n_cyl, int n_sph, int n_box,
                                     int n_ann, int W, int H, float tan_h,
                                     float tan_v, int ground, float clamp,
                                     void* stream) {
  if (n <= 0 || W <= 0 || H <= 0 || H > kLanes - 2 || P <= 0
      || n_cyl < 0 || n_sph < 0 || n_box < 0 || n_ann < 0
      || n_cyl + n_sph + n_box + n_ann > P)
    return (int)cudaErrorInvalidValue;
  const int smem = render_process_smem_bytes(P, W, H);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      render_process_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  AIRGYM_LAUNCH(render_process_kernel, n, kThreads, smem, (cudaStream_t)stream,
                origins, rots, prims, live, seeds, taps, out, P, n_cyl, n_sph,
                n_box, n_ann, W, H, tan_h, tan_v, ground, clamp);
  return (int)cudaGetLastError();
}

#ifdef AIRGYM_RENDER_CLOCKS
// Reads and zeroes the phase counters: cycles of thread 0 of every block
// in the prepass, the cast, noise 1, noise 2 and the blur, summed.
extern "C" int render_process_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif
