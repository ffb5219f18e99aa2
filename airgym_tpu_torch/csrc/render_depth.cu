// Raw z-depth camera: every env's image as perpendicular depth in metres
// (kBig * inv_norm where a ray hits nothing), written to device memory.
//
// Replaces: airgym_tpu/render/pallas_raycast.py `_kernel` (wrapper
// `_raycast`, `render_depth_pallas`). Per pixel: the ray from the pixel
// index (1 / sqrtf plus the TPU kernel's Newton step), the ground plane
// folded into the initial t, a running minimum of the euclidean t over
// every packed scene record (raycast.cuh; with culling on, whole groups
// of 8 records past the env's live count are skipped), then z-depth =
// t * inv_norm. It is render_process.cu's cast without the
// post-processing; MAPlanning and DepthGen clamp and normalise the image
// in plain PyTorch.
//
// Bound on the card: FP32 operations, counted by hand from raycast.cuh
// as in render_process.cu: per pixel 18 for the ray, 5 for the ground
// and 1 for the z-depth; per pixel and cast record (a valid record of a
// live group) 36 (cylinder), 13 (sphere), 32 (box), 60 (annulus); per
// cast record and env the prepass's 22, 11, 16, 30. At MAPlanning's
// shape (16,384 cameras of 212 x 120, 5 spheres) that is 3.7e10
// operations, 0.55 ms at 67 TFLOP/s, against 1.67 GB written (0.50 ms at
// 3.35 TB/s); at DepthGen's (1024 cameras; 47.4 of 75 cylinders, 72
// spheres, 9.3 of 15 boxes and 2.3 of 3 annuli valid per env) 8.1e10,
// 1.21 ms. chip_smoke.py computes the bound from the records its run
// casts.
//
// Design: blocks of 256 threads, four per SM (at most 64 registers a
// thread). A block covers a band of `chunk` consecutive pixels of one
// env (the whole image when there are enough envs to fill the card; the
// launch picks the bands so that the grid holds at least four waves of
// resident blocks). The prepass (raycast.cuh) builds the env's record
// structs and ray tables in shared memory once per band, and the loops
// over records are uniform across the block (broadcast float4 reads). Each thread casts kPix pixels p = band start + tid + k * 256 at
// once, walking their (u, v) without a division, so that a record's
// struct is read once for all and their chains interleave; a warp's
// stores stay contiguous in the [N, W, H] image.
//
// Built with -DAIRGYM_RENDER_CLOCKS, thread 0 of every block adds the
// cycles of the prepass and of the cast to two device counters
// (render_depth_phase_cycles); kernels/render_ab.py and chip_smoke.py
// print the split. What bounds it now: the cast, 99% of a block's cycles
// on MAPlanning's and DepthGen's scenes, issuing the IEEE divisions and
// square roots that keep the plain version's bits.
//
// Built with -fmad=false (see raycast.cuh): the plain version in
// render/raycast.py rounds like this source, so the two agree to the bit.
#include "common.cuh"
#include "raycast.cuh"

namespace {

using namespace airgym;

constexpr int kThreads = 256;
constexpr int kPix = 2;             // pixels a thread casts at once
constexpr int kStep = kThreads * kPix;
constexpr int kMaxSmem = 232448;    // bytes a block may use on sm_90
constexpr int kPhases = 2;
constexpr int kWaves = 4;           // least resident-block waves of a grid

#ifdef AIRGYM_RENDER_CLOCKS
__device__ unsigned long long g_phase_cycles[kPhases];
// thread 0 keeps its timestamps in shared memory, not in registers
#define AIRGYM_CLOCK(i) \
  if (threadIdx.x == 0) clk[i] = clock64()
#else
#define AIRGYM_CLOCK(i)
#endif

__global__ void __launch_bounds__(kThreads, 4)
render_depth_kernel(const float* __restrict__ origins,   // [N, 8]
                    const float* __restrict__ rots,      // [N, 16]
                    const float* __restrict__ prims,     // [N, P, 12]
                    const int* __restrict__ live,        // [N, 4]
                    float* __restrict__ out,             // [N, W, H]
                    int bands, int chunk, int P, int n_cyl, int n_sph,
                    int n_box, int n_ann, int W, int H, float tan_h,
                    float tan_v, int ground) {
  AIRGYM_DYN_SMEM(smem);
  float4* col = reinterpret_cast<float4*>(smem);               // [W]
  float4* row = col + W;                                       // [H]
  float4* recs = row + H;                                      // structs
  __shared__ int s_base[kKinds], s_n[kKinds];
#ifdef AIRGYM_RENDER_CLOCKS
  __shared__ long long clk[kPhases + 1];
#endif
  AIRGYM_CLOCK(0);

  const int env = blockIdx.x / bands;
  const int band = blockIdx.x - env * bands;
  const int tid = threadIdx.x;
  const int R = W * H;
  const float* o = origins + (size_t)env * 8;
  const float ox = o[0], oy = o[1], oz = o[2];
  build_scene(prims + (size_t)env * P * kRecFloats, n_cyl, n_sph, n_box,
              n_ann, live + (size_t)env * kKinds, ox, oy, oz, recs, s_base,
              s_n);
  build_tables(rots + (size_t)env * 16, W, H, tan_h, tan_v, col, row);
  __syncthreads();
  AIRGYM_CLOCK(1);

  const float neg_oz = 0.0f - oz;
  const int p_lo = band * chunk, p_hi = min(R, p_lo + chunk);
  float* my_out = out + (size_t)env * R;
  PixelWalk w(p_lo + tid, kThreads, H);
  for (int p0 = p_lo + tid; p0 < p_hi; p0 += kStep) {
    float u[kPix][3], t[kPix], inv[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const bool in = p0 + j * kThreads < p_hi;
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
    for (int j = 0; j < kPix; ++j)
      if (p0 + j * kThreads < p_hi) my_out[p0 + j * kThreads] = t[j] * inv[j];
  }
#ifdef AIRGYM_RENDER_CLOCKS
  __syncthreads();
  AIRGYM_CLOCK(2);
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i)
      atomicAdd(&g_phase_cycles[i], (unsigned long long)(clk[i + 1] - clk[i]));
#endif
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Dynamic shared memory of one block, in bytes (0 if it exceeds the card's
// per-block limit): the ray tables and room for P structs of the largest
// kind.
extern "C" int render_depth_smem_bytes(int P, int W, int H) {
  const long long bytes =
      16LL * (table_f4(W, H) + (long long)P * kMaxStructF4);
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
  const int smem = render_depth_smem_bytes(P, W, H);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      render_depth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // bands per env: enough blocks for kWaves waves of resident blocks, each
  // band a whole number of kStep-pixel steps
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, render_depth_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  const long long R = (long long)W * H;
  const long long steps = (R + kStep - 1) / kStep;
  const long long want = (long long)kWaves * sms * (per_sm > 0 ? per_sm : 1);
  long long bands = (want + n - 1) / n;
  if (bands > steps) bands = steps;
  const long long per_band = (steps + bands - 1) / bands;
  bands = (steps + per_band - 1) / per_band;
  if (bands * n > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  AIRGYM_LAUNCH(render_depth_kernel, (int)(bands * n), kThreads, smem,
                (cudaStream_t)stream, origins, rots, prims, live, out,
                (int)bands, (int)(per_band * kStep), P, n_cyl, n_sph, n_box,
                n_ann, W, H, tan_h, tan_v, ground);
  return (int)cudaGetLastError();
}

#ifdef AIRGYM_RENDER_CLOCKS
// Reads and zeroes the phase counters: cycles of thread 0 of every block
// in the prepass and in the cast, summed.
extern "C" int render_depth_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif
