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
// Bound on the card: FP32 operations. Per pixel about 37 for the ray and
// the ground, about 58 per cylinder, 20 per sphere (more for boxes and
// annuli) and about 80 for the post-processing; at Planning's shape
// (4096 envs, 212 x 120, 40 cylinders and a sphere, unculled) that is
// ~2.5e11 operations, ~3.8 ms at 67 TFLOP/s, against 417 MB written
// (~0.12 ms at 3.35 TB/s). chip_smoke.py computes the bound from the
// records that survive culling in its run.
//
// Design (simple first): one block of 256 threads per env; threads stride
// over the pixels. The env's record table goes to shared memory and the
// loops over records and groups are uniform across the block (no
// divergence, broadcast reads). The clipped image (W * H floats, 101,760
// bytes at 212 x 120) stays in dynamic shared memory between the cast,
// the two whole-image maxima (block reductions) and the blur, which reads
// its neighbours there. Two blocks fit on an SM.
//
// Built with -fmad=false (see raycast.cuh): the plain version in
// render/raycast.py rounds like this source, so the two agree to the last
// bit except where the library's log / cos differ.
#include <cstdint>

#include "common.cuh"
#include "raycast.cuh"

namespace {

using namespace airgym;

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;    // bytes a block may use on sm_90

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
  extern __shared__ float smem[];
  float* img = smem;                         // [W * H]
  float* rec = smem + W * H;                 // [P * 12]
  __shared__ float s_tap[25], s_m[9], s_o[3], s_red[kThreads / 32];
  __shared__ int s_seg[4], s_live[4];

  const int env = blockIdx.x, tid = threadIdx.x;
  const float* my_prims = prims + (size_t)env * P * kRecFloats;
  for (int i = tid; i < P * kRecFloats; i += kThreads) rec[i] = my_prims[i];
  if (tid < 25) s_tap[tid] = taps[(size_t)env * 32 + tid];
  if (tid < 9) s_m[tid] = rots[(size_t)env * 16 + tid];
  if (tid < 3) s_o[tid] = origins[(size_t)env * 8 + tid];
  if (tid < 4) {
    s_seg[tid] = tid == 0 ? n_cyl : tid == 1 ? n_sph : tid == 2 ? n_box : n_ann;
    s_live[tid] = live[(size_t)env * 4 + tid];
  }
  __syncthreads();

  const int R = W * H;
  // 1. cast, z-depth, clip / normalise
  float lmax = 0.0f;
  for (int pix = tid; pix < R; pix += kThreads) {
    const int u = pix / H, v = pix - (pix / H) * H;
    const Ray r = make_ray(s_m, s_o[0], s_o[1], s_o[2], u, v, W, H, tan_h, tan_v);
    float t = kBig;
    if (ground) t = cast_ground(r, t);
    t = cast_scene(rec, s_seg, s_live, r, t);
    const float x = fminf(fmaxf(t * r.inv_norm, 0.0f), clamp) / clamp;
    img[pix] = x;
    lmax = fmaxf(lmax, x);
  }
  const float mx1 = block_max(lmax, s_red);

  // 2. additive noise (draws 1, 2), clipped to [0, max]
  const uint32_t seed = seeds[env];
  lmax = 0.0f;
  for (int pix = tid; pix < R; pix += kThreads) {
    const int u = pix / H, v = pix - (pix / H) * H;
    HashUniform draw(seed, (uint32_t)(u * kLanes + v));
    const float n1 = normal(draw);
    const float x = fminf(fmaxf(img[pix] + 0.1f * n1, 0.0f), mx1);
    img[pix] = x;
    lmax = fmaxf(lmax, x);
  }
  const float mx2 = block_max(lmax, s_red);

  // 3. multiplicative noise (draws 3, 4), clipped to [0, new max]
  for (int pix = tid; pix < R; pix += kThreads) {
    const int u = pix / H, v = pix - (pix / H) * H;
    HashUniform draw(seed, (uint32_t)(u * kLanes + v));
    draw.counter = 2u;
    const float n2 = normal(draw);
    img[pix] = fminf(fmaxf(img[pix] * (1.0f + 0.3f * n2), 0.0f), mx2);
  }
  __syncthreads();

  // 4. blur: out[u, v] = sum_a sum_b tap[5a + b] * img[u + a - 2, v + b - 2]
  float* my_out = out + (size_t)env * R;
  for (int pix = tid; pix < R; pix += kThreads) {
    const int u = pix / H, v = pix - (pix / H) * H;
    float acc = 0.0f;
    for (int a = 0; a < 5; ++a) {
      const int uu = u + a - 2;
      if (uu < 0 || uu >= W) continue;       // zero rows add exactly 0
      for (int b = 0; b < 5; ++b) {
        const int vv = v + b - 2;
        if (vv < 0 || vv >= H) continue;
        acc = acc + s_tap[a * 5 + b] * img[uu * H + vv];
      }
    }
    my_out[pix] = acc;
  }
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Dynamic shared memory of one block, in bytes (0 if it exceeds the card's
// per-block limit).
extern "C" int render_process_smem_bytes(int P, int W, int H) {
  const long long bytes = ((long long)W * H + (long long)P * kRecFloats) * 4;
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
  render_process_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      origins, rots, prims, live, seeds, taps, out, P, n_cyl, n_sph, n_box,
      n_ann, W, H, tan_h, tan_v, ground, clamp);
  return (int)cudaGetLastError();
}
