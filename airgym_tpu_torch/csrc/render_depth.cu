// Raw z-depth camera: every env's image as perpendicular depth in metres
// (kBig * inv_norm where a ray hits nothing), written to device memory.
//
// Replaces: airgym_tpu/render/pallas_raycast.py `_kernel` (wrapper
// `_raycast`, `render_depth_pallas`). Per pixel: the ray from the pixel
// index (1 / sqrtf plus the TPU kernel's Newton step), the ground plane
// folded into the initial t, a running minimum of the euclidean t over
// every packed scene record (raycast.cuh; with culling on, whole groups
// of 8 records past the env's live count are skipped), then z-depth =
// t * inv_norm. It is render_process.cu's first loop without the
// post-processing; MAPlanning and DepthGen clamp and normalise the image
// in plain PyTorch.
//
// Bound on the card: FP32 operations. Per pixel about 37 for the ray and
// the ground, per pixel and record about 58 (cylinder), 20 (sphere), 45
// (box), 90 (annulus). At MAPlanning's shape (16,384 cameras of 212 x
// 120, 5 spheres) that is ~5.7e10 operations, ~0.85 ms at 67 TFLOP/s,
// against 1.67 GB written (~0.50 ms at 3.35 TB/s); at DepthGen's (1024
// cameras, 75 cylinders, 72 spheres, 15 boxes, 3 annuli) ~1.8e11, ~2.6 ms.
// chip_smoke.py computes the bound from the records its run casts.
//
// Design (simple first): one thread per pixel, blocks of 256 pixels of
// one env (a 1-D grid of N x ceil(W * H / 256) blocks). Each block stages
// its env's record table and live counts in shared memory; the loops over
// records and groups are uniform across the block (no divergence,
// broadcast reads). Pixel p = u * H + v writes out[n, p], so a warp's
// stores are contiguous in the [N, W, H] image.
//
// Built with -fmad=false (see raycast.cuh): the plain version in
// render/raycast.py rounds like this source, so the two agree to the bit.
#include "common.cuh"
#include "raycast.cuh"

namespace {

using namespace airgym;

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;    // bytes a block may use on sm_90

__global__ void __launch_bounds__(kThreads)
render_depth_kernel(const float* __restrict__ origins,   // [N, 8]
                    const float* __restrict__ rots,      // [N, 16]
                    const float* __restrict__ prims,     // [N, P, 12]
                    const int* __restrict__ live,        // [N, 4]
                    float* __restrict__ out,             // [N, W, H]
                    int tiles, int P, int n_cyl, int n_sph, int n_box,
                    int n_ann, int W, int H, float tan_h, float tan_v,
                    int ground) {
  extern __shared__ float rec[];             // [P * 12]
  __shared__ float s_m[9], s_o[3];
  __shared__ int s_seg[4], s_live[4];

  const int env = blockIdx.x / tiles;
  const int tile = blockIdx.x - env * tiles;
  const int tid = threadIdx.x;
  const float* my_prims = prims + (size_t)env * P * kRecFloats;
  for (int i = tid; i < P * kRecFloats; i += kThreads) rec[i] = my_prims[i];
  if (tid < 9) s_m[tid] = rots[(size_t)env * 16 + tid];
  if (tid < 3) s_o[tid] = origins[(size_t)env * 8 + tid];
  if (tid < 4) {
    s_seg[tid] = tid == 0 ? n_cyl : tid == 1 ? n_sph : tid == 2 ? n_box : n_ann;
    s_live[tid] = live[(size_t)env * 4 + tid];
  }
  __syncthreads();

  const int R = W * H;
  const int pix = tile * kThreads + tid;
  if (pix >= R) return;
  const int u = pix / H, v = pix - (pix / H) * H;
  const Ray r = make_ray(s_m, s_o[0], s_o[1], s_o[2], u, v, W, H, tan_h, tan_v);
  float t = kBig;
  if (ground) t = cast_ground(r, t);
  t = cast_scene(rec, s_seg, s_live, r, t);
  out[(size_t)env * R + pix] = t * r.inv_norm;
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Dynamic shared memory of one block, in bytes (0 if it exceeds the card's
// per-block limit).
extern "C" int render_depth_smem_bytes(int P) {
  const long long bytes = (long long)P * kRecFloats * 4;
  return bytes > kMaxSmem ? 0 : (int)bytes;
}

// Returns a cudaError_t (0 = launched). Launches on `stream`, never syncs.
extern "C" int render_depth_launch(const float* origins, const float* rots,
                                   const float* prims, const int* live,
                                   float* out, int n, int P, int n_cyl,
                                   int n_sph, int n_box, int n_ann, int W,
                                   int H, float tan_h, float tan_v,
                                   int ground, void* stream) {
  if (n <= 0 || W <= 0 || H <= 0 || P <= 0 || n_cyl < 0 || n_sph < 0
      || n_box < 0 || n_ann < 0 || n_cyl + n_sph + n_box + n_ann > P)
    return (int)cudaErrorInvalidValue;
  const int smem = render_depth_smem_bytes(P);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)W * H + kThreads - 1) / kThreads;
  if (tiles * n > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      render_depth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  render_depth_kernel<<<(unsigned)(tiles * n), kThreads, smem,
                        (cudaStream_t)stream>>>(
      origins, rots, prims, live, out, (int)tiles, P, n_cyl, n_sph, n_box,
      n_ann, W, H, tan_h, tan_v, ground);
  return (int)cudaGetLastError();
}
