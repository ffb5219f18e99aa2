// Fused CNN encoder: the whole conv stack of one camera image in one block,
// forward and parameter-only backward.
//
// Replaces: airgym_tpu/experiments/fused_cnn.py `_fwd_kernel` (forward) and
// `_bwd_kernel` (backward; wrapper `encode_pooled`). Semantics kept exactly:
// conv0 5x5 s2 -> ReLU -> BN -> conv1 3x3 s2 -> ReLU -> BN -> conv2 3x3 s2 ->
// ReLU -> BN -> mean pool, in the folded cell-grid form (plain version and
// layouts: airgym_tpu_torch/experiments/fused_cnn.py). Products take
// compute-dtype operands (bf16 or float, the template type T) and sum in
// float32; bias, ReLU and BN run in float32 (the BN multiply-add rounded
// twice, as the plain version, not contracted); a0 and a1 are rounded to T
// only as matmul operands; the backward rounds g2 / g1 / g0 to T before
// their products, sums each element of dA1 and dA0 over all its taps in
// float32, and returns float32 gradients (the wrapper rounds dw0-dw2 to the
// weights' dtype). The image gets no gradient.
//
// Bound on the card, counted as the convolutions' own multiply-adds: per
// 212 x 120 image conv0 106 x 60 outputs x 16 x 25 = 2.54 M, conv1 1590 x
// 32 x 144 = 7.33 M, conv2 405 x 64 x 288 = 7.46 M: 17.3 M (34.7 MFLOP).
// The backward recomputes the forward and adds dw2 + dA1 (2 x 7.46 M),
// dw1 + dA0 (2 x 7.33 M) and dw0 (2.54 M): 49.5 M (98.9 MFLOP). Planning's
// forward at B = 4096 is 142 GFLOP: 0.144 ms at 989 TFLOP/s of bf16 tensor
// cores, 2.12 ms at 67 TFLOP/s of FP32 (at B = 609, the update's unique
// frames: 0.021 / 0.32 ms); its backward at B = 609 is 60 GFLOP (0.061 /
// 0.90 ms). The image (bf16, 208 MB at B = 4096) moves in
// ~0.06 ms. Operation-bound. The folded products below execute 1.56x
// (forward) and 1.51x (backward) these counts: w0 holds 25 live taps in
// each 64-row column, w1 144 in 256 rows.
//
// Design: what runs where.
// - bf16 (the trained path): forward and backward on the tensor cores.
//   Every product is an implicit GEMM of warp-level mma.sync m16n8k16 bf16
//   tiles with float32 sums (mma_bf16.cuh). Every operand is a bf16 value
//   already (the image, the weights, a0, a1, g0, g1, g2) and bf16 x bf16
//   products are exact in float32, so the rounding points above do not
//   move; only the order of the float32 sums does. One 512-thread block per
//   SM; the weights sit in shared memory as bf16 in both orientations the
//   products need (126 KB), the rest (94 KB at 212 x 120) stages operands.
//   The forward and the backward's recompute are the same two routines,
//   with a compile-time flag (RESID) for the backward's residuals:
//   . conv0 + conv1 in chunks of 128 cells: x0 staged from the image (the
//     next chunk's pixels loaded into registers meanwhile), a0 kept in a
//     ring of 256 cells for conv1's 2 x 2 taps; a1 (bf16) to the block's
//     workspace, and with RESID r0 / r1 (float) and a0 too;
//   . conv2 in chunks of 64 positions, z2 copied in from a1 by cp.async,
//     double-buffered; with RESID r2 (float) out, else a2 = BN2(r2) summed
//     into the pool: each lane over its positions in chunk order, the
//     eight lanes of one t by a fixed butterfly, the four m-tile warps'
//     partials in warp order by threads 0..63, times 1 / P.
//   The forward is only that. Its workspace is a1 alone (hc x wc x 32
//   bf16: 101,760 bytes per block at 212 x 120, 13.4 MB over 132 blocks,
//   inside the 50 MB L2); it keeps conv2's cp.async copy-in as it is.
//   The backward goes on:
//   . conv2's backward in chunks of 32 positions: g2 (kept in shared
//     memory, [position][64]) and dw2 = z2^T g2 (z2^T and g2^T staged with
//     positions contiguous);
//   . dA1 by parity class of the a1 cell (its 1, 2 or 4 taps concatenated
//     along K, so each element is summed over its taps in the accumulator:
//     no atomics, no col2im buffer) -> g1 (bf16) to the workspace;
//   . conv1's and conv0's backward in chunks of 64 cells, double-buffered
//     (cp.async): dw1 = z1^T g1 with fragments read from the a0 cells and
//     g1 [cell][32] two bf16 values per register, dA0 gathered over its 4
//     taps -> g0 (kept in shared memory), dw0 = x0^T g0 on the same chunk.
//   Invalid taps read a zero row of shared memory (no branches). The
//   backward's workspace holds r0 / r1 / r2 as float (the BN scale
//   gradients need them) and a0 / a1 / g1 as bf16: 1.12 MB per block at
//   212 x 120. A failed or refused launch returns its cudaError_t and the
//   wrapper raises; there is no scalar bf16 path (Num has no bf16 case).
// - float32, both kernels: scalar FP32 FMAs, no tensor cores: f32 parity
//   (2e-5 of max|ref|) rules out TF32, so the float instance has no
//   tensor-core form. Forward: one block of 512 threads per image (a
//   persistent grid walks the batch); the weights as float (123 KB) and
//   the bias / BN rows in shared memory; the block sweeps conv2's output
//   rows two at a time, each step staging 20 image rows and computing 4
//   cell rows of a0 and a1 into 5-row rings and 2 rows of a2, whose
//   per-channel sums threads 0..63 keep in a fixed order. 202 KB of shared
//   memory at 212 x 120: one block per SM. The float backward reruns that
//   forward into a per-block float32 workspace (r0, a0, r1, a1, r2; 2.04 MB
//   at 212 x 120) and sweeps rows: conv2 (g2, dw2, the channel sums), dA1
//   -> g1 (each element gathered over its taps), conv1 (dw1, dA0 -> g0),
//   conv0 (dw0); lanes walk positions, not weight rows.
// - Determinism (both instances): the forward's grid is min(B, SMs), the
//   backward's a fixed min(B, 132), each block walking images b = block,
//   block + grid, ...; each thread (or warp) owns a fixed set of output or
//   gradient elements; the BN and pool sums are taken per thread over a
//   fixed set of positions in order and their partials added in a fixed
//   order; a second launch adds the backward's 132 partial rows in block
//   order. No float atomics, so two runs agree to the bit (the backward's
//   bits also do not depend on the card's SM count).
// - FUSED_CNN_DYN_SMEM / FUSED_CNN_LAUNCH wrap the two CUDA-only
//   constructs, so the source also compiles as C++ against cuda_emu.h,
//   which emulates this subset of CUDA (mma.sync, cp.async and warp
//   shuffles included) on the CPU for the tests (they hold it against the
//   plain version there).
// Left for later: wgmma (the only way to the full tensor-core rate) and
// TMA with warp specialisation in place of mma.sync and cp.async; two
// blocks per SM (the forward alone needs only w0^T / w1^T / w2^T and the
// recompute staging, about 142 KB, but the registers of 2 x 512 threads
// would cap each at 64); the folded products' structural zeros (1.56x the
// forward's multiply-adds); and the backward's workspace round trip (about
// 3 MB moved per image, beyond the 50 MB L2 over 132 blocks).
#include <cstddef>
#include <cstdint>
#include <type_traits>

#ifndef FUSED_CNN_EMU
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

#define FUSED_CNN_DYN_SMEM(name) extern __shared__ __align__(16) float name[]
#define FUSED_CNN_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDynSmem = 232448 - 1024;   // per block, less the static part
// the backward's grid: fixed, so the order of its partial sums (and the
// gradient's bits) does not depend on the card's SM count
constexpr int kBwdBlocks = 132;
constexpr int O_W0 = 0, O_W1 = 64 * 64, O_W2 = O_W1 + 256 * 32;
constexpr int O_ROWS = O_W2 + 288 * 64;            // 30,720
constexpr int N_ROWS = 480;
constexpr int N_PARAM = O_ROWS + N_ROWS;           // the flat gradient
// the rows: b0 s0 t0 (64 each, tiled x4), b1 s1 t1 (32), b2 s2 t2 (64)
constexpr int R_B0 = 0, R_S0 = 64, R_T0 = 128, R_B1 = 192, R_S1 = 224,
              R_T1 = 256, R_B2 = 288, R_S2 = 352, R_T2 = 416;
constexpr int RING = 5;        // live rows of a0 and a1: 4s - 1 .. 4s + 3
constexpr int IMG_ROWS = 20;   // image rows of 4 cell rows
// padded row strides of the backward's staged g2 / g1 rows: lanes reading
// neighbouring positions then hit distinct shared-memory banks
constexpr int GS2 = 68, GS1 = 36;
constexpr int R0S = 68;        // padded pixel stride of the forward's a0 ring

struct Geom {
  int H, W, hc, wc, ho, wo, P, ws;   // ws: padded image row (W + 4)
  __host__ __device__ Geom(int h, int w)
      : H(h), W(w), hc(h / 4), wc(w / 4), ho((h / 4 + 1) / 2),
        wo((w / 4 + 1) / 2), P(((h / 4 + 1) / 2) * ((w / 4 + 1) / 2)),
        ws(w + 4) {}
  // dynamic shared memory in floats: weights and rows, then the forward's
  // rings, image rows and two a2 rows (the backward's staging fits there)
  __host__ __device__ long long smem_floats() const {
    return (long long)N_PARAM + (long long)RING * wc * (R0S + 32)
           + (long long)IMG_ROWS * ws + 2LL * wo * 64;
  }
  // the bf16 forward's workspace per block in bf16 elements: a1
  __host__ __device__ long long fwd_work_halves() const { return 32LL * hc * wc; }
  // the backward's workspace per block: float r0 a0 g0 a1 r1 g1 r2 g2, or
  // (bf16) float r0 r1 r2 and bf16 a0 a1 g1
  __host__ __device__ long long work_floats(bool bf16) const {
    return bf16 ? 160LL * hc * wc + 64LL * ho * wo
                : 3LL * hc * wc * 96 + 2LL * ho * wo * 64;
  }
};

// per-block workspace of the backward: forward residuals and rounded g's
struct Work {
  float *a0, *r0, *g0, *a1, *r1, *g1, *r2, *g2;
  __device__ Work(float* base, const Geom& g) {
    const size_t n0 = (size_t)g.hc * g.wc * 64, n1 = (size_t)g.hc * g.wc * 32;
    const size_t n2 = (size_t)g.ho * g.wo * 64;
    a0 = base; r0 = a0 + n0; g0 = r0 + n0;
    a1 = g0 + n0; r1 = a1 + n1; g1 = r1 + n1;
    r2 = g1 + n1; g2 = r2 + n2;
  }
};

// the scalar kernels' loads and roundings: float only (the bf16 instances
// run on the tensor cores, so a scalar bf16 instance does not compile)
template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// r * s + t with both roundings, as the plain version
__device__ __forceinline__ float bn(float r, float s, float t) {
  return __fadd_rn(__fmul_rn(r, s), t);
}

__device__ __forceinline__ float relu_bias(float acc, float b) {
  return fmaxf(acc + b, 0.0f);
}

// (d * s) * [r > 0], as the JAX kernel's g = d * s * (r > 0)
__device__ __forceinline__ float gate(float d, float s, float r) {
  return __fmul_rn(d, s) * (r > 0.0f ? 1.0f : 0.0f);
}

template <typename T>
__device__ void stage_weights(const T* __restrict__ w0,
                              const T* __restrict__ w1,
                              const T* __restrict__ w2,
                              const float* __restrict__ rows, float* sm) {
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads) sm[O_W0 + i] = Num<T>::f(w0[i]);
  for (int i = threadIdx.x; i < 256 * 32; i += kThreads) sm[O_W1 + i] = Num<T>::f(w1[i]);
  for (int i = threadIdx.x; i < 288 * 64; i += kThreads) sm[O_W2 + i] = Num<T>::f(w2[i]);
  for (int i = threadIdx.x; i < N_ROWS; i += kThreads) sm[O_ROWS + i] = rows[i];
}

// The forward of one image. BWD: write the residuals to the workspace and
// no pooled output; otherwise out[0..63] = pooled. Ends synchronised.
template <typename T, bool BWD>
__device__ void forward_image(const T* __restrict__ img, float* sm,
                              const Geom& g, float* wbase, float* out) {
  const int tid = threadIdx.x;
  const float* W0 = sm + O_W0;
  const float* W1 = sm + O_W1;
  const float* W2 = sm + O_W2;
  const float* R = sm + O_ROWS;
  float* ring0 = sm + N_PARAM;                 // [RING][wc][R0S]
  float* ring1 = ring0 + RING * g.wc * R0S;    // [RING][wc][32]
  float* imgb = ring1 + RING * g.wc * 32;      // [IMG_ROWS][W + 4]
  float* a2b = imgb + IMG_ROWS * g.ws;         // [2][wo][64]
  float *wa0 = nullptr, *wr0 = nullptr, *wa1 = nullptr, *wr1 = nullptr,
        *wr2 = nullptr;
  if (BWD) {
    const Work wk(wbase, g);
    wa0 = wk.a0; wr0 = wk.r0; wa1 = wk.a1; wr1 = wk.r1; wr2 = wk.r2;
  }
  float pool = 0.0f;                           // threads 0..63: channel tid
  const int nsteps = (g.ho + 1) / 2;
  for (int s = 0; s < nsteps; ++s) {
    const int c0 = 4 * s;                      // first cell row of the step
    const int nr = imin(4, g.hc - c0);
    // (1) image rows 16s - 2 .. of the step's cells, cols -2 .. W + 1
    const int y0 = 16 * s - 2;
    for (int i = tid; i < (4 * nr + 4) * g.ws; i += kThreads) {
      const int rr = i / g.ws, x = i - rr * g.ws - 2, y = y0 + rr;
      imgb[i] = (y >= 0 && y < g.H && x >= 0 && x < g.W)
                    ? Num<T>::f(img[(size_t)y * g.W + x]) : 0.0f;
    }
    __syncthreads();
    // (2) conv0: cell (i, j) x channels cg*4 .. + 3 and 32 + cg*4 .. + 3;
    // k = a*16 + c*4 + p*2 + q reads pixel (4i - 2 + 2a + p, 4j - 2 + 2c + q)
    for (int t = tid; t < nr * g.wc * 8; t += kThreads) {
      const int cg = t & 7, j = (t >> 3) % g.wc, ii = (t >> 3) / g.wc;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const float* base = imgb + 4 * ii * g.ws + 4 * j;
      for (int dr = 0; dr < 8; ++dr) {
        const float4 va = ld4(base + dr * g.ws), vb = ld4(base + dr * g.ws + 4);
        const float v[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
        const float* wrow = W0 + ((dr >> 1) * 16 + (dr & 1) * 2) * 64 + cg * 4;
#pragma unroll
        for (int dc = 0; dc < 8; ++dc) {
          const float* w = wrow + ((dc >> 1) * 4 + (dc & 1)) * 64;
          const float4 wa = ld4(w), wb = ld4(w + 32);
          acc[0] = fmaf(v[dc], wa.x, acc[0]); acc[1] = fmaf(v[dc], wa.y, acc[1]);
          acc[2] = fmaf(v[dc], wa.z, acc[2]); acc[3] = fmaf(v[dc], wa.w, acc[3]);
          acc[4] = fmaf(v[dc], wb.x, acc[4]); acc[5] = fmaf(v[dc], wb.y, acc[5]);
          acc[6] = fmaf(v[dc], wb.z, acc[6]); acc[7] = fmaf(v[dc], wb.w, acc[7]);
        }
      }
      const int i = c0 + ii;
      float* dst = ring0 + ((i % RING) * g.wc + j) * R0S;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int ch = (n >> 2) * 32 + cg * 4 + (n & 3);
        const float r = relu_bias(acc[n], R[R_B0 + ch]);
        const float a = Num<T>::rnd(bn(r, R[R_S0 + ch], R[R_T0 + ch]));
        dst[ch] = a;
        if (BWD) {
          const size_t idx = ((size_t)i * g.wc + j) * 64 + ch;
          wr0[idx] = r;
          wa0[idx] = a;
        }
      }
    }
    __syncthreads();
    // (3) conv1: pixel (y, x) x 8 channels over a0 cells (y-1+a, x-1+c)
    for (int t = tid; t < nr * g.wc * 4; t += kThreads) {
      const int cg = t & 3, x = (t >> 2) % g.wc, y = c0 + (t >> 2) / g.wc;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int a = 0; a < 2; ++a) {
        const int row = y - 1 + a;
        if (row < 0) continue;
        for (int c = 0; c < 2; ++c) {
          const int col = x - 1 + c;
          if (col < 0) continue;
          const float* src = ring0 + ((row % RING) * g.wc + col) * R0S;
          const float* wt = W1 + (a * 2 + c) * 64 * 32 + cg * 8;
          for (int ch = 0; ch < 64; ch += 4) {
            const float4 av = ld4(src + ch);
            const float avs[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 wa = ld4(wt + (ch + e) * 32), wb = ld4(wt + (ch + e) * 32 + 4);
              acc[0] = fmaf(avs[e], wa.x, acc[0]); acc[1] = fmaf(avs[e], wa.y, acc[1]);
              acc[2] = fmaf(avs[e], wa.z, acc[2]); acc[3] = fmaf(avs[e], wa.w, acc[3]);
              acc[4] = fmaf(avs[e], wb.x, acc[4]); acc[5] = fmaf(avs[e], wb.y, acc[5]);
              acc[6] = fmaf(avs[e], wb.z, acc[6]); acc[7] = fmaf(avs[e], wb.w, acc[7]);
            }
          }
        }
      }
      float* dst = ring1 + ((y % RING) * g.wc + x) * 32 + cg * 8;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int ch = cg * 8 + n;
        const float r = relu_bias(acc[n], R[R_B1 + ch]);
        const float a = Num<T>::rnd(bn(r, R[R_S1 + ch], R[R_T1 + ch]));
        dst[n] = a;
        if (BWD) {
          const size_t idx = ((size_t)y * g.wc + x) * 32 + ch;
          wr1[idx] = r;
          wa1[idx] = a;
        }
      }
    }
    __syncthreads();
    // (4) conv2: output (u, v) x 4 channels over a1 (2u-1+di, 2v-1+dj)
    const int nu = imin(2, g.ho - 2 * s);
    for (int t = tid; t < nu * g.wo * 16; t += kThreads) {
      const int ng = t & 15, v = (t >> 4) % g.wo, uu = (t >> 4) / g.wo;
      const int u = 2 * s + uu;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int di = 0; di < 3; ++di) {
        const int row = 2 * u - 1 + di;
        if (row < 0 || row >= g.hc) continue;
        for (int dj = 0; dj < 3; ++dj) {
          const int col = 2 * v - 1 + dj;
          if (col < 0 || col >= g.wc) continue;
          const float* src = ring1 + ((row % RING) * g.wc + col) * 32;
          const float* wt = W2 + (di * 3 + dj) * 32 * 64 + ng * 4;
          for (int c = 0; c < 32; c += 4) {
            const float4 av = ld4(src + c);
            const float avs[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 w = ld4(wt + (c + e) * 64);
              acc[0] = fmaf(avs[e], w.x, acc[0]); acc[1] = fmaf(avs[e], w.y, acc[1]);
              acc[2] = fmaf(avs[e], w.z, acc[2]); acc[3] = fmaf(avs[e], w.w, acc[3]);
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = ng * 4 + e;
        const float r = relu_bias(acc[e], R[R_B2 + n]);
        if (BWD) wr2[((size_t)u * g.wo + v) * 64 + n] = r;
        else a2b[(uu * g.wo + v) * 64 + n] = bn(r, R[R_S2 + n], R[R_T2 + n]);
      }
    }
    __syncthreads();
    // (5) the pool's per-channel sums, positions in order
    if (!BWD && tid < 64)
      for (int i = 0; i < nu * g.wo; ++i) pool += a2b[i * 64 + tid];
  }
  if (!BWD && tid < 64) out[tid] = pool * (float)(1.0 / (double)g.P);
  __syncthreads();
}

// conv2's backward: g2 (rounded, to the workspace), dw2, db2 / ds2 / dt2.
template <typename T>
__device__ void conv2_bwd(float* sm, const Geom& g, const Work& wk,
                          const float* dys, float* part) {
  const int tid = threadIdx.x, cols = g.wc + 2;
  const float* R = sm + O_ROWS;
  float* g2s = sm + N_PARAM;                   // [wo][64]
  float* r2s = g2s + g.wo * 64;                // [wo][64]
  float* a1s = r2s + g.wo * 64;                // [3][wc + 2][32], col - 1 .. wc
  const int c = tid & 31, ng = tid >> 5;       // dw2 tile: 9 taps x 4 outputs
  float acc[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
  float sr = 0.0f, st = 0.0f, sb = 0.0f;       // threads 0..63
  for (int u = 0; u < g.ho; ++u) {
    const float* r2 = wk.r2 + (size_t)u * g.wo * 64;
    for (int i = tid; i < g.wo * 64; i += kThreads) {
      const int n = i & 63;
      const float r = r2[i];
      const float gc = Num<T>::rnd(gate(dys[n], R[R_S2 + n], r));
      g2s[i] = gc;
      r2s[i] = r;
      wk.g2[(size_t)u * g.wo * 64 + i] = gc;
    }
    for (int i = tid; i < 3 * cols * 32; i += kThreads) {
      const int cc = i & 31, col = (i >> 5) % cols - 1, row = 2 * u - 1 + (i >> 5) / cols;
      a1s[i] = (row >= 0 && row < g.hc && col >= 0 && col < g.wc)
                   ? wk.a1[((size_t)row * g.wc + col) * 32 + cc] : 0.0f;
    }
    __syncthreads();
    // the channel sums, positions in order, from shared memory
    if (tid < 64)
      for (int v = 0; v < g.wo; ++v) {
        const float r = r2s[v * 64 + tid];
        sr = sr + __fmul_rn(dys[tid], r);
        st = st + dys[tid];
        sb = sb + gate(dys[tid], R[R_S2 + tid], r);
      }
    __syncthreads();
    for (int v = 0; v < g.wo; ++v) {
      const float4 gv = ld4(g2s + v * 64 + ng * 4);
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float z = a1s[(di * cols + 2 * v + dj) * 32 + c];
          float* a = acc[di * 3 + dj];
          a[0] = fmaf(z, gv.x, a[0]); a[1] = fmaf(z, gv.y, a[1]);
          a[2] = fmaf(z, gv.z, a[2]); a[3] = fmaf(z, gv.w, a[3]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[O_W2 + (k * 32 + c) * 64 + ng * 4 + e] += acc[k][e];
  if (tid < 64) {
    part[O_ROWS + R_B2 + tid] += sb;
    part[O_ROWS + R_S2 + tid] += sr;
    part[O_ROWS + R_T2 + tid] += st;
  }
}

// dA1 = col2im(g2 @ w2^T), each element summed over its taps, then g1
// (rounded, to the workspace) and db1 / ds1 / dt1.
template <typename T>
__device__ void conv2_data_bwd(float* sm, const Geom& g, const Work& wk,
                               float* part) {
  const int tid = threadIdx.x, vcols = g.wo + 1;
  const float* W2 = sm + O_W2;
  const float* R = sm + O_ROWS;
  float* g2r = sm + N_PARAM;                   // [2][wo + 1][GS2]
  float* da1s = g2r + 2 * vcols * GS2;         // [wc][32] dA1 row y
  float* r1s = da1s + g.wc * 32;               // [wc][32] r1 row y
  float sr = 0.0f, st = 0.0f, sb = 0.0f;       // threads 0..31
  for (int y = 0; y < g.hc; ++y) {
    // slot 0: g2 row (y - 1) >> 1 (di = 2), slot 1: (y + 1) >> 1 (di = 0 for
    // odd y, 1 for even y)
    for (int i = tid; i < 2 * vcols * 64; i += kThreads) {
      const int n = i & 63, v = (i >> 6) % vcols, sl = (i >> 6) / vcols;
      const int u = sl ? (y + 1) >> 1 : (y - 1) >> 1;
      g2r[(sl * vcols + v) * GS2 + n] =
          (u >= 0 && u < g.ho && v < g.wo)
              ? wk.g2[((size_t)u * g.wo + v) * 64 + n] : 0.0f;
    }
    __syncthreads();
    const bool yodd = y & 1;
    // lanes over x, so a warp reads one or two weight rows (broadcast)
    for (int t = tid; t < g.wc * 16; t += kThreads) {
      const int c = (t / g.wc) * 2, x = t % g.wc;
      const bool xodd = x & 1;
      float d0 = 0.0f, d1 = 0.0f;
      for (int a = 0; a < (yodd ? 2 : 1); ++a) {
        const int sl = yodd ? a : 1, di = yodd ? 2 - 2 * a : 1;
        for (int b = 0; b < (xodd ? 2 : 1); ++b) {
          const int v = xodd ? ((x - 1) >> 1) + b : x >> 1;
          const int dj = xodd ? 2 - 2 * b : 1;
          const float* gp = g2r + (sl * vcols + v) * GS2;
          const float* w = W2 + ((di * 3 + dj) * 32 + c) * 64;
          float t0 = 0.0f, t1 = 0.0f;
          for (int o = 0; o < 64; o += 4) {
            const float4 gv = ld4(gp + o), wa = ld4(w + o), wb = ld4(w + 64 + o);
            t0 = fmaf(gv.x, wa.x, t0); t0 = fmaf(gv.y, wa.y, t0);
            t0 = fmaf(gv.z, wa.z, t0); t0 = fmaf(gv.w, wa.w, t0);
            t1 = fmaf(gv.x, wb.x, t1); t1 = fmaf(gv.y, wb.y, t1);
            t1 = fmaf(gv.z, wb.z, t1); t1 = fmaf(gv.w, wb.w, t1);
          }
          d0 += t0;
          d1 += t1;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = c + e;
        const float d = e ? d1 : d0;
        const size_t idx = ((size_t)y * g.wc + x) * 32 + ch;
        const float r = wk.r1[idx];
        const float gv = gate(d, R[R_S1 + ch], r);
        wk.g1[idx] = Num<T>::rnd(gv);
        da1s[x * 32 + ch] = d;
        r1s[x * 32 + ch] = r;
      }
    }
    __syncthreads();
    if (tid < 32)
      for (int x = 0; x < g.wc; ++x) {
        const float d = da1s[x * 32 + tid];
        const float r = r1s[x * 32 + tid];
        sr = sr + __fmul_rn(d, r);
        st = st + d;
        sb = sb + gate(d, R[R_S1 + tid], r);
      }
  }
  if (tid < 32) {
    part[O_ROWS + R_B1 + tid] += sb;
    part[O_ROWS + R_S1 + tid] += sr;
    part[O_ROWS + R_T1 + tid] += st;
  }
  __syncthreads();
}

// conv1's backward: dw1, then dA0 = col2im(g1 @ w1^T) -> g0 (rounded, to the
// workspace) and db0 / ds0 / dt0.
template <typename T>
__device__ void conv1_bwd(float* sm, const Geom& g, const Work& wk,
                          float* part) {
  const int tid = threadIdx.x, cols = g.wc + 1;
  const float* W1 = sm + O_W1;
  const float* R = sm + O_ROWS;
  float* g1s = sm + N_PARAM;                   // [2][wc + 1][GS1]: rows y, y + 1
  float* a0s = g1s + 2 * cols * GS1;           // [2][wc + 1][64]: rows y - 1, y
  float* da0s = a0s + 2 * cols * 64;           // [wc][64] dA0 row y
  float* r0s = da0s + g.wc * 64;               // [wc][64] r0 row y
  // dw1 tile: tap (ta, tc), channels ch4 .. + 3, outputs og * 4 .. + 3
  const int kg = tid >> 3, og = tid & 7;
  const int ta = kg >> 5, tc = (kg >> 4) & 1, ch4 = (kg & 15) * 4;
  float acc[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.0f;
  float sr = 0.0f, st = 0.0f, sb = 0.0f;       // threads 0..63
  for (int y = 0; y < g.hc; ++y) {
    for (int i = tid; i < 2 * cols * 32; i += kThreads) {
      const int cc = i & 31, col = (i >> 5) % cols, sl = (i >> 5) / cols;
      const int row = y + sl;
      g1s[(sl * cols + col) * GS1 + cc] =
          (row < g.hc && col < g.wc)
              ? wk.g1[((size_t)row * g.wc + col) * 32 + cc] : 0.0f;
    }
    for (int i = tid; i < 2 * cols * 64; i += kThreads) {
      const int cc = i & 63, col = (i >> 6) % cols - 1, row = y - 1 + (i >> 6) / cols;
      a0s[i] = (row >= 0 && col >= 0)
                   ? wk.a0[((size_t)row * g.wc + col) * 64 + cc] : 0.0f;
    }
    __syncthreads();
    // dw1 += z1^T g1 over pixel row y: z1[x][(a*2+c)*64 + ch] = a0[y-1+a][x-1+c][ch]
    for (int x = 0; x < g.wc; ++x) {
      const float4 av = ld4(a0s + (ta * cols + x + tc) * 64 + ch4);
      const float4 gv = ld4(g1s + x * GS1 + og * 4);
      const float avs[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e][0] = fmaf(avs[e], gv.x, acc[e][0]); acc[e][1] = fmaf(avs[e], gv.y, acc[e][1]);
        acc[e][2] = fmaf(avs[e], gv.z, acc[e][2]); acc[e][3] = fmaf(avs[e], gv.w, acc[e][3]);
      }
    }
    // dA0 row y: cell (y, j) is read by conv1 pixels (y + 1 - a, j + 1 - c)
    // lanes over j, so a warp reads one or two weight rows (broadcast)
    for (int t = tid; t < g.wc * 16; t += kThreads) {
      const int ch = (t / g.wc) * 4, j = t % g.wc;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int a = 0; a < 2; ++a)
        for (int c = 0; c < 2; ++c) {
          const float* gp = g1s + ((1 - a) * cols + j + 1 - c) * GS1;
          const float* w = W1 + ((a * 2 + c) * 64 + ch) * 32;
          float tt[4] = {0.f, 0.f, 0.f, 0.f};
          for (int o = 0; o < 32; o += 4) {
            const float4 gv = ld4(gp + o);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 wv = ld4(w + e * 32 + o);
              tt[e] = fmaf(gv.x, wv.x, tt[e]); tt[e] = fmaf(gv.y, wv.y, tt[e]);
              tt[e] = fmaf(gv.z, wv.z, tt[e]); tt[e] = fmaf(gv.w, wv.w, tt[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] += tt[e];
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t idx = ((size_t)y * g.wc + j) * 64 + ch + e;
        const float r = wk.r0[idx];
        const float gv = gate(d[e], R[R_S0 + ch + e], r);
        wk.g0[idx] = Num<T>::rnd(gv);
        da0s[j * 64 + ch + e] = d[e];
        r0s[j * 64 + ch + e] = r;
      }
    }
    __syncthreads();
    if (tid < 64)
      for (int j = 0; j < g.wc; ++j) {
        const float d = da0s[j * 64 + tid];
        const float r = r0s[j * 64 + tid];
        sr = sr + __fmul_rn(d, r);
        st = st + d;
        sb = sb + gate(d, R[R_S0 + tid], r);
      }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      part[O_W1 + ((ta * 2 + tc) * 64 + ch4 + e) * 32 + og * 4 + f] += acc[e][f];
  if (tid < 64) {
    part[O_ROWS + R_B0 + tid] += sb;
    part[O_ROWS + R_S0 + tid] += sr;
    part[O_ROWS + R_T0 + tid] += st;
  }
  __syncthreads();
}

// conv0's backward: dw0 = x0^T g0.
template <typename T>
__device__ void conv0_bwd(const T* __restrict__ img, float* sm, const Geom& g,
                          const Work& wk, float* part) {
  const int tid = threadIdx.x;
  float* imgs = sm + N_PARAM;                  // [8][W + 4]
  float* g0s = imgs + 8 * g.ws;                // [wc][64]
  const int k = tid >> 3, n4 = (tid & 7) * 4;   // channels n4 .. + 3, 32 + n4 .. + 3
  const int dr = 2 * (k >> 4) + ((k >> 1) & 1), dc = 2 * ((k >> 2) & 3) + (k & 1);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < g.hc; ++i) {
    for (int q = tid; q < 8 * g.ws; q += kThreads) {
      const int rr = q / g.ws, x = q - rr * g.ws - 2, y = 4 * i - 2 + rr;
      imgs[q] = (y >= 0 && y < g.H && x >= 0 && x < g.W)
                    ? Num<T>::f(img[(size_t)y * g.W + x]) : 0.0f;
    }
    for (int q = tid; q < g.wc * 64; q += kThreads)
      g0s[q] = wk.g0[(size_t)i * g.wc * 64 + q];
    __syncthreads();
    for (int j = 0; j < g.wc; ++j) {
      const float xv = imgs[dr * g.ws + 4 * j + dc];
      const float4 ga = ld4(g0s + j * 64 + n4), gb = ld4(g0s + j * 64 + 32 + n4);
      acc[0] = fmaf(xv, ga.x, acc[0]); acc[1] = fmaf(xv, ga.y, acc[1]);
      acc[2] = fmaf(xv, ga.z, acc[2]); acc[3] = fmaf(xv, ga.w, acc[3]);
      acc[4] = fmaf(xv, gb.x, acc[4]); acc[5] = fmaf(xv, gb.y, acc[5]);
      acc[6] = fmaf(xv, gb.z, acc[6]); acc[7] = fmaf(xv, gb.w, acc[7]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) part[O_W0 + k * 64 + (e >> 2) * 32 + n4 + (e & 3)] += acc[e];
}

// ---- the bf16 backward on the tensor cores ----------------------------------
//
// Each product is an implicit GEMM of m16n8k16 tiles (mma_bf16.cuh) over
// bf16 operands in shared memory. The weights sit there as bf16 in both
// orientations a product needs (w0^T, w1^T, w2^T for the recompute; w1,
// w2 as given for dA0 / dA1); the other operand is staged chunk by chunk
// from the image or the workspace. The weight gradients take K over
// positions (chunks of KC2 / KC1, zero-padded past the image); the data
// gradients gather their taps along K, so each element of dA1 / dA0 is
// summed over all its taps in float32 inside the accumulator. Row strides
// (LD*) are 4 words off a multiple of 32 banks, so a fragment's eight rows
// x four words hit 32 distinct banks. The BN sums: each thread (or lane)
// sums its own positions in a fixed order, then the partials are added in
// a fixed order, so the bits do not depend on timing.
constexpr int KC2 = 32, LD2 = 40;   // dw2: positions per chunk, tile stride
constexpr int KC1 = 64, LD1 = 72;   // conv0 / conv1 / dw1 / dA0 / dw0: cells
constexpr int KCP = 64, LDZ2 = 296; // recompute conv2: positions, z2 stride
constexpr int KCR = 128;            // recompute conv0 + conv1: cells per chunk
constexpr int RING_C = 256;         // a0 cells kept for conv1 (wc + 1 + KCR at most)
constexpr int LDG2 = 72;            // g2 [position][64]
constexpr int LDC = 40;             // g1 [cell][32]
constexpr int N_RED = 16 * 32 * 3;  // BN partials
// the weights, bf16 elements from the start of shared memory: [n][k]
// (k contiguous) for every product; then the 480 rows as float
constexpr int LW0T = 72, LW1T = 264, LW2T = 296, LW2 = 72, LW1 = 40;
constexpr int OB_W0T = 0, OB_W1T = OB_W0T + 64 * LW0T;
constexpr int OB_W2T = OB_W1T + 32 * LW1T, OB_W2 = OB_W2T + 64 * LW2T;
constexpr int OB_W1 = OB_W2 + 288 * LW2, OB_END = OB_W1 + 256 * LW1;
constexpr int OF_ROWS = OB_END / 2;              // float index of the rows
constexpr int OF_ZERO = OF_ROWS + N_ROWS;        // 80 bf16 zeros: invalid taps
constexpr int OF_STAGE = OF_ZERO + 40;           // float index of the staging
static_assert(OB_END % 8 == 0 && OF_STAGE % 4 == 0, "16-byte alignment");

__host__ __device__ inline long long al8(long long n) { return (n + 7) & ~7LL; }

// the staging, in bf16 elements from its base, all in the same place: the
// recompute's (x0 or z2, the a0 ring), conv2's (g2, z2^T, g2^T) or conv1's
// and conv0's (a0 and g1 cells, x0^T, g0^T); then the BN partials (float)
struct MmaLayout {
  long long xs, ring, g2s, z2t, g2t, a0h, g1c, x0t, g0t, end;
  __host__ __device__ explicit MmaLayout(const Geom& g) {
    const long long rc = 2LL * KCP * LDZ2 > (long long)(KCR + RING_C) * LD1
                             ? 2LL * KCP * LDZ2 : (long long)(KCR + RING_C) * LD1;
    xs = 0;
    ring = (long long)KCR * LD1;
    g2s = 0;
    z2t = g2s + al8((long long)g.P * LDG2);
    g2t = z2t + al8(288LL * LD2);
    const long long p2 = g2t + al8(64LL * LD2);
    a0h = 0;                                          // x2 buffers
    g1c = a0h + 2 * al8((long long)(KC1 + g.wc + 1) * LD1);
    x0t = g1c + 2 * al8((long long)(KC1 + g.wc + 1) * LDC);
    g0t = x0t + 2 * al8(64LL * LD1);
    const long long p4 = g0t + al8(64LL * LD1);
    end = rc > p2 ? rc : p2;
    end = end > p4 ? end : p4;
  }
  __host__ __device__ long long bytes() const { return 2 * end + 4LL * N_RED; }
};

struct MmaSmem {
  const uint16_t *w0t, *w1t, *w2t, *w2, *w1, *zero;
  const float* R;
  uint16_t *xs, *ring, *g2s, *z2t, *g2t, *a0h, *g1c, *x0t, *g0t;
  float* red;
  __device__ MmaSmem(float* sm, const Geom& g) {
    const uint16_t* wb = reinterpret_cast<const uint16_t*>(sm);
    w0t = wb + OB_W0T; w1t = wb + OB_W1T; w2t = wb + OB_W2T;
    w2 = wb + OB_W2; w1 = wb + OB_W1;
    R = sm + OF_ROWS;
    zero = reinterpret_cast<const uint16_t*>(sm + OF_ZERO);
    const MmaLayout L(g);
    uint16_t* h = reinterpret_cast<uint16_t*>(sm + OF_STAGE);
    xs = h + L.xs; ring = h + L.ring;
    g2s = h + L.g2s; z2t = h + L.z2t; g2t = h + L.g2t;
    a0h = h + L.a0h; g1c = h + L.g1c;
    x0t = h + L.x0t; g0t = h + L.g0t;
    red = reinterpret_cast<float*>(h + L.end);
  }
};

// per-block workspace of the bf16 backward: r0 / r1 / r2 float (the BN
// scale gradients need them), a0 / a1 / g1 as bf16 bits (bf16 values
// already); g2 and g0 stay in shared memory
struct WorkB {
  float *r0, *r1, *r2;
  uint16_t *a0, *a1, *g1;
  __device__ WorkB(float* base, const Geom& g) {
    const size_t C = (size_t)g.hc * g.wc;
    r0 = base; r1 = r0 + C * 64; r2 = r1 + C * 32;
    a0 = reinterpret_cast<uint16_t*>(r2 + (size_t)g.P * 64);
    a1 = a0 + C * 64; g1 = a1 + C * 32;
  }
  // the forward's: a1 alone (hc x wc x 32 bf16), the residuals unused
  __device__ explicit WorkB(uint16_t* a1_)
      : r0(nullptr), r1(nullptr), r2(nullptr), a0(nullptr), a1(a1_), g1(nullptr) {}
};

__device__ __forceinline__ void st_pair(uint16_t* p, uint16_t lo, uint16_t hi) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack(lo, hi);
}

__device__ __forceinline__ void st32(uint16_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// a 16-byte copy from device to shared memory that runs on while the
// block computes (zero-filled if !valid); cp_wait() waits for the
// thread's copies
__device__ __forceinline__ void cp16(uint16_t* dst, const uint16_t* src, bool valid) {
#ifdef AIRGYM_CUDA_EMU
  if (valid) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
#else
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
#endif
}

__device__ __forceinline__ void cp_wait() {
#ifndef AIRGYM_CUDA_EMU
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// eight bf16 values, one 16-byte load or store
__device__ __forceinline__ uint4 ld128(const uint16_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st128(uint16_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}
__device__ __forceinline__ uint16_t half_of(const uint4& v, int m) {
  const uint32_t w = m < 2 ? v.x : m < 4 ? v.y : m < 6 ? v.z : v.w;
  return (uint16_t)(m & 1 ? w >> 16 : w & 0xffffu);
}

// v summed over the eight lanes of the same t = lane & 3 (a fixed
// butterfly: all eight get the same bits)
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// the weights as bf16 in both orientations, the rows as float
__device__ void stage_weights_mma(const uint16_t* __restrict__ w0,
                                  const uint16_t* __restrict__ w1,
                                  const uint16_t* __restrict__ w2,
                                  const float* __restrict__ rows, float* sm) {
  uint16_t* wb = reinterpret_cast<uint16_t*>(sm);
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads)
    wb[OB_W0T + (i & 63) * LW0T + (i >> 6)] = w0[i];
  for (int i = threadIdx.x; i < 256 * 32; i += kThreads) {
    wb[OB_W1T + (i & 31) * LW1T + (i >> 5)] = w1[i];
    wb[OB_W1 + (i >> 5) * LW1 + (i & 31)] = w1[i];
  }
  for (int i = threadIdx.x; i < 288 * 64; i += kThreads) {
    wb[OB_W2T + (i & 63) * LW2T + (i >> 6)] = w2[i];
    wb[OB_W2 + (i >> 6) * LW2 + (i & 63)] = w2[i];
  }
  for (int i = threadIdx.x; i < N_ROWS; i += kThreads) sm[OF_ROWS + i] = rows[i];
  for (int i = threadIdx.x; i < 40; i += kThreads) sm[OF_ZERO + i] = 0.0f;
}

// conv0 and conv1 of every cell, in chunks of KCR cells: the backward's
// recompute (RESID: r0, a0, r1 and a1 to the workspace) and the forward
// (a1 alone). x0 [cell][k] is staged from the image (k = a*16 + c*4 +
// p*2 + q reads pixel (4i - 2 + 2a + p, 4j - 2 + 2c + q); q = 0, 1 are one
// aligned pair), the next chunk's pixels loaded into registers while this
// chunk's products run. a0 goes to a ring of RING_C cells, from which
// conv1 reads its taps (y - 1 + a, x - 1 + c). Ends synchronised.
template <bool RESID>
__device__ void conv01_fwd_mma(const uint16_t* __restrict__ img, const MmaSmem& s,
                               const Geom& g, const WorkB& wk) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3, mq = warp & 7, nh = warp >> 3;
  const int C = g.hc * g.wc;
  constexpr int NI = KCR * 8 / kThreads;       // (cell, patch row) items per thread
  uint32_t v[NI][4];
  auto load = [&](int c0) {
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const int it = tid + k * kThreads, dr = it & 7, cell = c0 + (it >> 3);
      v[k][0] = v[k][1] = v[k][2] = v[k][3] = 0u;
      if (cell < C) {
        const int i = cell / g.wc, j = cell - i * g.wc;
        const int yy = 4 * i - 2 + dr, xx = 4 * j - 2;
        if (yy >= 0 && yy < g.H)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (xx + 2 * c >= 0 && xx + 2 * c < g.W)
              v[k][c] = mma::ld32(img + (size_t)yy * g.W + xx + 2 * c);
      }
    }
  };
  load(0);
  for (int c0 = 0; c0 < C; c0 += KCR) {
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const int it = tid + k * kThreads, dr = it & 7;
      uint16_t* dst = s.xs + (it >> 3) * LD1 + (dr >> 1) * 16 + (dr & 1) * 2;
#pragma unroll
      for (int c = 0; c < 4; ++c) st32(dst + 4 * c, v[k][c]);
    }
    __syncthreads();
    if (c0 + KCR < C) load(c0 + KCR);
    // conv0: m-tile mq of the chunk, n-tiles nh * 4 .. + 3
    {
      float d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4];
        mma::load_a(a, s.xs + mq * 16 * LD1 + ks * 16, LD1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[2];
          mma::load_b(b, s.w0t + (nh * 4 + j) * 8 * LW0T + ks * 16, LW0T);
          mma::mma_16816(d[j], a, b);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cell = c0 + mq * 16 + gq + 8 * r;
        if (cell >= C) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = (nh * 4 + j) * 8 + 2 * t;
          float rr[2];
          uint16_t h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rr[e] = relu_bias(d[j][2 * r + e], s.R[R_B0 + ch + e]);
            h[e] = mma::bf16_bits(bn(rr[e], s.R[R_S0 + ch + e], s.R[R_T0 + ch + e]));
          }
          if constexpr (RESID) {
            *reinterpret_cast<float2*>(wk.r0 + (size_t)cell * 64 + ch) = float2{rr[0], rr[1]};
            st_pair(wk.a0 + (size_t)cell * 64 + ch, h[0], h[1]);
          }
          st_pair(s.ring + (cell & (RING_C - 1)) * LD1 + ch, h[0], h[1]);
        }
      }
    }
    __syncthreads();
    // conv1: m-tile mq, n-tiles nh * 2, + 1 over the ring's taps
    {
      int y[2], x[2];
      bool ok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cell = c0 + mq * 16 + gq + 8 * r;
        ok[r] = cell < C;
        y[r] = cell / g.wc;
        x[r] = cell - y[r] * g.wc;
      }
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int zo = (int)(s.zero - s.ring);
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        int src[2];          // offsets from the ring; the zero row if no tap
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = y[r] - 1 + (tap >> 1), col = x[r] - 1 + (tap & 1);
          src[r] = (ok[r] && row >= 0 && col >= 0)
                       ? ((row * g.wc + col) & (RING_C - 1)) * LD1 + 2 * t : zo + 2 * t;
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            a[r] = mma::ld32(s.ring + src[r] + ks * 16);
            a[r + 2] = mma::ld32(s.ring + src[r] + ks * 16 + 8);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t b[2];
            mma::load_b(b, s.w1t + (nh * 2 + j) * 8 * LW1T + tap * 64 + ks * 16, LW1T);
            mma::mma_16816(d[j], a, b);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!ok[r]) continue;
        const size_t cell = (size_t)y[r] * g.wc + x[r];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ch = (nh * 2 + j) * 8 + 2 * t;
          float rr[2];
          uint16_t h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rr[e] = relu_bias(d[j][2 * r + e], s.R[R_B1 + ch + e]);
            h[e] = mma::bf16_bits(bn(rr[e], s.R[R_S1 + ch + e], s.R[R_T1 + ch + e]));
          }
          if constexpr (RESID)
            *reinterpret_cast<float2*>(wk.r1 + cell * 32 + ch) = float2{rr[0], rr[1]};
          st_pair(wk.a1 + cell * 32 + ch, h[0], h[1]);
        }
      }
    }
  }
  __syncthreads();
}

// conv2 of every position, chunks of KCP positions: the backward's
// recompute (RESID: r2 to the workspace) and the forward (out [64] = the
// mean pool of a2 = BN2(r2)). z2 [position][tap * 32 + c] is copied in
// from a1 (cp.async, double-buffered: the next chunk's copies run while
// this chunk's products do). The pool in a fixed order: each lane sums
// its positions' a2 chunk by chunk in registers, the eight lanes of one t
// are added by sum_over_g, and threads 0..63 add the four m-tile warps'
// partials in warp order; no atomics. Ends synchronised.
template <bool RESID>
__device__ void conv2_fwd_mma(const MmaSmem& s, const Geom& g, const WorkB& wk,
                              float* out) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3, mq = warp & 3, nb = (warp >> 2) * 2;
  const int P = g.P;
  float pool[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // channels (nb + j) * 8 + 2t + e
  auto copy_in = [&](int p0, int q) {
    for (int it = tid; it < KCP * 36; it += kThreads) {
      const int kq = it % 36, pl = it / 36, p = p0 + pl;
      const int tap = kq >> 2, c = 8 * (kq & 3);
      bool ok = false;
      size_t at = 0;
      if (p < P) {
        const int u = p / g.wo, vv = p - u * g.wo;
        const int row = 2 * u - 1 + tap / 3, col = 2 * vv - 1 + tap % 3;
        ok = row >= 0 && row < g.hc && col >= 0 && col < g.wc;
        if (ok) at = ((size_t)row * g.wc + col) * 32 + c;
      }
      cp16(s.xs + (q * KCP + pl) * LDZ2 + 8 * kq, wk.a1 + at, ok);
    }
  };
  copy_in(0, 0);
  for (int p0 = 0, q = 0; p0 < P; p0 += KCP, q ^= 1) {
    cp_wait();
    __syncthreads();
    if (p0 + KCP < P) copy_in(p0 + KCP, q ^ 1);
    const uint16_t* z2 = s.xs + q * KCP * LDZ2;
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 6
    for (int ks = 0; ks < 18; ++ks) {
      uint32_t a[4];
      mma::load_a(a, z2 + mq * 16 * LDZ2 + ks * 16, LDZ2);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[2];
        mma::load_b(b, s.w2t + (nb + j) * 8 * LW2T + ks * 16, LW2T);
        mma::mma_16816(d[j], a, b);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + mq * 16 + gq + 8 * r;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = (nb + j) * 8 + 2 * t;
        const float r0 = relu_bias(d[j][2 * r], s.R[R_B2 + n]);
        const float r1 = relu_bias(d[j][2 * r + 1], s.R[R_B2 + n + 1]);
        if constexpr (RESID) {
          *reinterpret_cast<float2*>(wk.r2 + (size_t)p * 64 + n) = float2{r0, r1};
        } else {
          pool[j][0] += bn(r0, s.R[R_S2 + n], s.R[R_T2 + n]);
          pool[j][1] += bn(r1, s.R[R_S2 + n + 1], s.R[R_T2 + n + 1]);
        }
      }
    }
  }
  if constexpr (!RESID) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = sum_over_g(pool[j][e]);
        if (gq == 0) s.red[mq * 64 + (nb + j) * 8 + 2 * t + e] = v;
      }
    __syncthreads();
    if (tid < 64)
      out[tid] = (((s.red[tid] + s.red[64 + tid]) + s.red[128 + tid]) + s.red[192 + tid])
                 * (float)(1.0 / (double)P);
  }
  __syncthreads();
}

// conv2's backward: g2 (rounded, kept in shared memory for dA1), dw2 =
// z2^T g2 over chunks of KC2 positions, db2 / ds2 / dt2. Ends synchronised.
__device__ void conv2_bwd_mma(const MmaSmem& s, const Geom& g, const WorkB& wk,
                              const float* dys, float* part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = g.P;
  // the warp's tiles of dw2 (18 x 8): n-tile nt, m-tiles mt0 .. mt0 + 8
  const int nt = warp & 7, mt0 = (warp >> 3) * 9;
  float acc[9][4];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  // BN sums of channel tid & 63 over this thread's positions, in order
  float sr = 0.0f, st = 0.0f, sb = 0.0f;
  // items per thread: g2 at positions p0 + 2 pp, + 1 and channel n (it =
  // pp * 64 + n, so n = tid & 63); z2^T's eight channels c8 .. c8 + 7 of
  // one tap at two positions (it = (tap * 4 + c8 / 8) * KC2 / 2 + pp)
  constexpr int NG2 = (KC2 / 2) * 64 / kThreads, NZ = (36 * (KC2 / 2) + kThreads - 1) / kThreads;
  float rv[NG2][2];
  uint4 zv[NZ][2];
  auto load = [&](int p0) {
#pragma unroll
    for (int k = 0; k < NG2; ++k) {
      const int it = tid + k * kThreads, n = it & 63, p = p0 + 2 * (it >> 6);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rv[k][e] = p + e < P ? wk.r2[(size_t)(p + e) * 64 + n] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const int it = tid + k * kThreads;
      const int pp = it % (KC2 / 2), tq = it / (KC2 / 2);
      const int tap = tq >> 2, c8 = 8 * (tq & 3);
      const int di = tap / 3, dj = tap - 3 * di;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        zv[k][e] = uint4{0u, 0u, 0u, 0u};
        const int p = p0 + 2 * pp + e;
        if (it < 36 * (KC2 / 2) && p < P) {
          const int u = p / g.wo, vv = p - u * g.wo;
          const int row = 2 * u - 1 + di, col = 2 * vv - 1 + dj;
          if (row >= 0 && row < g.hc && col >= 0 && col < g.wc)
            zv[k][e] = ld128(wk.a1 + ((size_t)row * g.wc + col) * 32 + c8);
        }
      }
    }
  };
  load(0);
  for (int p0 = 0; p0 < P; p0 += KC2) {
#pragma unroll
    for (int k = 0; k < NG2; ++k) {
      const int it = tid + k * kThreads, n = it & 63, p = p0 + 2 * (it >> 6);
      uint16_t h[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (p + e < P) {
          const float r = rv[k][e];
          const float gv = gate(dys[n], s.R[R_S2 + n], r);
          h[e] = mma::bf16_bits(gv);
          s.g2s[(p + e) * LDG2 + n] = h[e];
          sr = sr + __fmul_rn(dys[n], r);
          st = st + dys[n];
          sb = sb + gv;
        }
      st_pair(s.g2t + n * LD2 + (p - p0), h[0], h[1]);
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const int it = tid + k * kThreads;
      if (it >= 36 * (KC2 / 2)) continue;
      const int pp = it % (KC2 / 2), tq = it / (KC2 / 2);
      const int tap = tq >> 2, c8 = 8 * (tq & 3);
#pragma unroll
      for (int m = 0; m < 8; ++m)
        st_pair(s.z2t + (tap * 32 + c8 + m) * LD2 + 2 * pp, half_of(zv[k][0], m),
                half_of(zv[k][1], m));
    }
    __syncthreads();
    if (p0 + KC2 < P) load(p0 + KC2);
#pragma unroll
    for (int ks = 0; ks < KC2 / 16; ++ks) {
      uint32_t b[2];
      mma::load_b(b, s.g2t + nt * 8 * LD2 + ks * 16, LD2);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        uint32_t a[4];
        mma::load_a(a, s.z2t + (mt0 + i) * 16 * LD2 + ks * 16, LD2);
        mma::mma_16816(acc[i], a, b);
      }
    }
    __syncthreads();
  }
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float* d = part + O_W2 + ((mt0 + i) * 16 + gq) * 64 + nt * 8 + 2 * t;
    d[0] += acc[i][0]; d[1] += acc[i][1];
    d[8 * 64] += acc[i][2]; d[8 * 64 + 1] += acc[i][3];
  }
  s.red[tid] = sr; s.red[kThreads + tid] = st; s.red[2 * kThreads + tid] = sb;
  __syncthreads();
  if (tid < 64) {
    float a = 0.0f, b = 0.0f, c = 0.0f;
    for (int k = tid; k < kThreads; k += 64) {
      a += s.red[k]; b += s.red[kThreads + k]; c += s.red[2 * kThreads + k];
    }
    part[O_ROWS + R_S2 + tid] += a;
    part[O_ROWS + R_T2 + tid] += b;
    part[O_ROWS + R_B2 + tid] += c;
  }
  __syncthreads();
}

// dA1 = g2 @ w2^T gathered over each a1 cell's taps, then g1 (rounded, to
// the workspace) and db1 / ds1 / dt1. The cells go by parity class (y odd,
// x odd): a class's cells share their taps (di = 0 and 2 for odd y, 1 for
// even; dj alike), so K is 64 x (its 1, 2 or 4 taps). Ends synchronised.
__device__ void conv2_data_bwd_mma(const MmaSmem& s, const Geom& g,
                                   const WorkB& wk, float* part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  // BN sums of channels nt * 8 + 2t + e, index nt * 2 + e
  float bs[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i) bs[i][0] = bs[i][1] = bs[i][2] = 0.0f;
  const int zo = (int)(s.zero - s.g2s);
  for (int cls = 0; cls < 4; ++cls) {
    const int py = cls >> 1, px = cls & 1;
    const int nx = (g.wc - px + 1) / 2, ncell = ((g.hc - py + 1) / 2) * nx;
    for (int mt = warp; mt * 16 < ncell; mt += kThreads / 32) {
      int y[2], x[2];
      bool ok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = mt * 16 + gq + 8 * r;
        ok[r] = q < ncell;
        y[r] = py + 2 * (q / nx);
        x[r] = px + 2 * (q % nx);
      }
      // r1 of the lane's cells, loaded ahead of the products
      float2 r1v[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          r1v[r][n] = ok[r] ? *reinterpret_cast<const float2*>(
                                  wk.r1 + ((size_t)y[r] * g.wc + x[r]) * 32 + n * 8 + 2 * t)
                            : float2{0.0f, 0.0f};
      float d[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.0f;
      for (int ta = 0; ta < (py ? 2 : 1); ++ta)
        for (int tb = 0; tb < (px ? 2 : 1); ++tb) {
          const int di = py ? 2 * ta : 1, dj = px ? 2 * tb : 1;
          int src[2];        // offsets from g2s; the zero row if no tap
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int u = (y[r] + 1 - di) >> 1, v = (x[r] + 1 - dj) >> 1;
            src[r] = (ok[r] && u >= 0 && u < g.ho && v >= 0 && v < g.wo)
                         ? (u * g.wo + v) * LDG2 + 2 * t : zo + 2 * t;
          }
          const uint16_t* wt = s.w2 + (di * 3 + dj) * 32 * LW2;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t a[4];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              a[r] = mma::ld32(s.g2s + src[r] + ks * 16);
              a[r + 2] = mma::ld32(s.g2s + src[r] + ks * 16 + 8);
            }
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              uint32_t b[2];
              mma::load_b(b, wt + n * 8 * LW2 + ks * 16, LW2);
              mma::mma_16816(d[n], a, b);
            }
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!ok[r]) continue;
        const size_t cell = (size_t)y[r] * g.wc + x[r];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int ch = n * 8 + 2 * t;
          const float2 rr = r1v[r][n];
          uint16_t h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dv = d[n][2 * r + e], re = e ? rr.y : rr.x;
            const float gv = gate(dv, s.R[R_S1 + ch + e], re);
            h[e] = mma::bf16_bits(gv);
            float* b3 = bs[n * 2 + e];
            b3[0] = b3[0] + __fmul_rn(dv, re);
            b3[1] = b3[1] + dv;
            b3[2] = b3[2] + gv;
          }
          st_pair(wk.g1 + cell * 32 + ch, h[0], h[1]);
        }
      }
    }
  }
  // per warp over its lanes, then over the warps in order
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = sum_over_g(bs[i][k]);
      if (gq == 0) s.red[(warp * 32 + (i >> 1) * 8 + 2 * t + (i & 1)) * 3 + k] = v;
    }
  __syncthreads();
  if (tid < 32) {
    float a = 0.0f, b = 0.0f, c = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) {
      const float* q = s.red + (w * 32 + tid) * 3;
      a += q[0]; b += q[1]; c += q[2];
    }
    part[O_ROWS + R_S1 + tid] += a;
    part[O_ROWS + R_T1 + tid] += b;
    part[O_ROWS + R_B1 + tid] += c;
  }
  __syncthreads();
}

// conv1's and conv0's backward over chunks of KC1 cells, double-buffered:
// the next chunk's a0 and g1 cells are copied in (cp.async) and its pixels
// loaded into registers while this chunk's products run.
// - dw1 = z1^T g1: z1^T's fragments are read from the a0 cells c0 - wc - 1
//   .. (z1 [cell][tap * 64 + ch] = a0 [cell - (1 - a) * wc - (1 - c)][ch])
//   and g1's from g1 [cell][32], two bf16 values per register;
// - dA0 = g1 @ w1^T gathered over each a0 cell's 4 taps (cell (y, x) is
//   read by conv1 pixels (y + 1 - a, x + 1 - c)) -> g0 (rounded, kept in
//   shared memory as g0^T) and db0 / ds0 / dt0;
// - dw0 = x0^T g0 on the same chunk.
// Ends synchronised.
__device__ void conv10_bwd_mma(const uint16_t* __restrict__ img, const MmaSmem& s,
                               const Geom& g, const WorkB& wk, float* part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int C = g.hc * g.wc, NG = KC1 + g.wc + 1;
  const long long BA = (long long)NG * LD1, BG = (long long)NG * LDC, BX = 64LL * LD1;
  // dw1 (16 x 4 tiles): m-tile = warp (tap = warp >> 2, channels
  // (warp & 3) * 16 + gq, + 8), all four n-tiles
  float acc1[4][4];
  const int tap1 = warp >> 2, ch1 = (warp & 3) * 16 + gq;
  const int a1_ = tap1 >> 1, c1_ = tap1 & 1;
  // dA0 and dw0 (4 x 8 tiles each): m-tile warp & 3, n-tiles nb, nb + 1
  const int mq = warp & 3, nb = (warp >> 2) * 2;
  float acc0[2][4];
  float bs[4][3];       // BN sums of channels (nb + j) * 8 + 2t + e, j * 2 + e
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.0f;
    bs[i][0] = bs[i][1] = bs[i][2] = 0.0f;
  }
  acc0[0][0] = acc0[0][1] = acc0[0][2] = acc0[0][3] = 0.0f;
  acc0[1][0] = acc0[1][1] = acc0[1][2] = acc0[1][3] = 0.0f;
  // the a0 cells c0 - wc - 1 .. c0 + KC1 - 1 and the g1 cells c0 .. c0 +
  // NG - 1 of a chunk, into buffer q
  auto copy_in = [&](int c0, int q) {
    const int h0 = c0 - g.wc - 1;
    for (int it = tid; it < NG * 8; it += kThreads) {
      const int cell = h0 + (it >> 3);
      const bool ok = cell >= 0 && cell < C;
      cp16(s.a0h + q * BA + (it >> 3) * LD1 + 8 * (it & 7),
           wk.a0 + (ok ? (size_t)cell * 64 + 8 * (it & 7) : 0), ok);
    }
    for (int it = tid; it < NG * 4; it += kThreads) {
      const int cell = c0 + (it >> 2);
      cp16(s.g1c + q * BG + (it >> 2) * LDC + 8 * (it & 3),
           wk.g1 + (cell < C ? (size_t)cell * 32 + 8 * (it & 3) : 0), cell < C);
    }
  };
  // x0^T: row k = a*16 + c*4 + p*2 + q reads pixel (4i - 2 + 2a + p,
  // 4j - 2 + 2c + q) of cell (i, j); items: patch row dr = 2a + p at cells
  // c0 + 2 pp, + 1 (threads 0 .. 8 * KC1 / 2 - 1)
  const int pp = tid % (KC1 / 2), dr = tid / (KC1 / 2);
  const bool xo = tid < 8 * (KC1 / 2);
  uint32_t xv[2][4];
  auto load_x = [&](int c0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      xv[e][0] = xv[e][1] = xv[e][2] = xv[e][3] = 0u;
      const int cell = c0 + 2 * pp + e;
      if (xo && cell < C) {
        const int i = cell / g.wc, j = cell - i * g.wc;
        const int yy = 4 * i - 2 + dr, xx = 4 * j - 2;
        if (yy >= 0 && yy < g.H)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (xx + 2 * c >= 0 && xx + 2 * c < g.W)
              xv[e][c] = mma::ld32(img + (size_t)yy * g.W + xx + 2 * c);
      }
    }
  };
  copy_in(0, 0);
  load_x(0);
  for (int c0 = 0, q = 0; c0 < C; c0 += KC1, q ^= 1) {
    const uint16_t* a0h = s.a0h + q * BA;
    const uint16_t* g1c = s.g1c + q * BG;
    uint16_t* x0t = s.x0t + q * BX;
    if (xo) {
      uint16_t* dst = x0t + ((dr >> 1) * 16 + (dr & 1) * 2) * LD1 + 2 * pp;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          st_pair(dst + (4 * c + k) * LD1,
                  (uint16_t)(k ? xv[0][c] >> 16 : xv[0][c] & 0xffffu),
                  (uint16_t)(k ? xv[1][c] >> 16 : xv[1][c] & 0xffffu));
    }
    cp_wait();
    __syncthreads();
    if (c0 + KC1 < C) {
      copy_in(c0 + KC1, q ^ 1);
      load_x(c0 + KC1);
    }
    // dA0's cells mq * 16 + gq (+ 8), their r0 loaded ahead of the products
    int y[2], x[2];
    bool ok[2];
    float2 r0v[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int cell = c0 + mq * 16 + gq + 8 * r;
      ok[r] = cell < C;
      y[r] = cell / g.wc;
      x[r] = cell - y[r] * g.wc;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        r0v[r][j] = ok[r] ? *reinterpret_cast<const float2*>(
                                wk.r0 + (size_t)cell * 64 + (nb + j) * 8 + 2 * t)
                          : float2{0.0f, 0.0f};
    }
    // dw1 += z1^T g1 over the chunk. The a0 rows are zero before the
    // image (the copies zero-fill them) and g1 past it, so the only tap to
    // mask is column x - 1 < 0 (tap c = 0 at x = 0): bit cl of x0m marks
    // the chunk's cells at x = 0
    uint64_t x0m = 0;
    if (c1_ == 0)
      for (int cl = (g.wc - c0 % g.wc) % g.wc; cl < KC1; cl += g.wc) x0m |= 1ull << cl;
    const int zo = (int)(s.zero - a0h);
#pragma unroll
    for (int ks = 0; ks < KC1 / 16; ++ks) {
      // the lane's cells ks * 16 + 2t + {0, 1, 8, 9}: offsets of their a0
      // tap rows (the zero row if masked)
      int z[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int cl = ks * 16 + 2 * t + (m & 1) + 8 * (m >> 1);
        z[m] = ((x0m >> cl) & 1) ? zo + (ch1 & 7) : (cl + a1_ * g.wc + c1_) * LD1 + ch1;
      }
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[r + 2 * h] = mma::pack(a0h[z[2 * h] + 8 * r], a0h[z[2 * h + 1] + 8 * r]);
      const uint16_t* gr = g1c + (ks * 16 + 2 * t) * LDC + gq;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t b[2];
        b[0] = mma::pack(gr[n * 8], gr[LDC + n * 8]);
        b[1] = mma::pack(gr[8 * LDC + n * 8], gr[9 * LDC + n * 8]);
        mma::mma_16816(acc1[n], a, b);
      }
    }
    // dA0 of the chunk's cells mq * 16 + gq (+ 8)
    {
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      // offsets from g1c (g1 is zero past the image: only the column
      // x + 1 = wc of tap c = 0 is masked, to the zero row)
      const int zg = (int)(s.zero - g1c);
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        int src[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int xx = x[r] + 1 - (tap & 1);
          src[r] = xx < g.wc ? (mq * 16 + gq + 8 * r + (1 - (tap >> 1)) * g.wc
                                + 1 - (tap & 1)) * LDC + 2 * t
                             : zg + 2 * t;
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            a[r] = mma::ld32(g1c + src[r] + ks * 16);
            a[r + 2] = mma::ld32(g1c + src[r] + ks * 16 + 8);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t b[2];
            mma::load_b(b, s.w1 + (tap * 64 + (nb + j) * 8) * LW1 + ks * 16, LW1);
            mma::mma_16816(d[j], a, b);
          }
        }
      }
      // g0 (rounded) to g0^T, zero past the image; BN sums
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cl = mq * 16 + gq + 8 * r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ch = (nb + j) * 8 + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint16_t h = 0;
            if (ok[r]) {
              const float dv = d[j][2 * r + e], re = e ? r0v[r][j].y : r0v[r][j].x;
              const float gv = gate(dv, s.R[R_S0 + ch + e], re);
              h = mma::bf16_bits(gv);
              float* b3 = bs[j * 2 + e];
              b3[0] = b3[0] + __fmul_rn(dv, re);
              b3[1] = b3[1] + dv;
              b3[2] = b3[2] + gv;
            }
            s.g0t[(ch + e) * LD1 + cl] = h;
          }
        }
      }
    }
    __syncthreads();
    // dw0 += x0^T g0 over the chunk
#pragma unroll
    for (int ks = 0; ks < KC1 / 16; ++ks) {
      uint32_t a[4];
      mma::load_a(a, x0t + mq * 16 * LD1 + ks * 16, LD1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[2];
        mma::load_b(b, s.g0t + (nb + j) * 8 * LD1 + ks * 16, LD1);
        mma::mma_16816(acc0[j], a, b);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float* d = part + O_W1 + (warp * 16 + gq) * 32 + n * 8 + 2 * t;
    d[0] += acc1[n][0]; d[1] += acc1[n][1];
    d[8 * 32] += acc1[n][2]; d[8 * 32 + 1] += acc1[n][3];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* d = part + O_W0 + (mq * 16 + gq) * 64 + (nb + j) * 8 + 2 * t;
    d[0] += acc0[j][0]; d[1] += acc0[j][1];
    d[8 * 64] += acc0[j][2]; d[8 * 64 + 1] += acc0[j][3];
  }
  // BN sums: per warp over its lanes, then over the four m-tile warps
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = sum_over_g(bs[i][k]);
      if (gq == 0)
        s.red[(mq * 64 + (nb + (i >> 1)) * 8 + 2 * t + (i & 1)) * 3 + k] = v;
    }
  __syncthreads();
  if (tid < 64) {
    float a = 0.0f, b = 0.0f, c = 0.0f;
    for (int m = 0; m < 4; ++m) {
      const float* q = s.red + (m * 64 + tid) * 3;
      a += q[0]; b += q[1]; c += q[2];
    }
    part[O_ROWS + R_S0 + tid] += a;
    part[O_ROWS + R_T0 + tid] += b;
    part[O_ROWS + R_B0 + tid] += c;
  }
  __syncthreads();
}

// The bf16 backward of the block's images: the recompute and the five
// gradient products on the tensor cores, all through mma_bf16.cuh.
__device__ void bwd_mma(const uint16_t* __restrict__ x, const float* __restrict__ dp,
                        const uint16_t* __restrict__ w0, const uint16_t* __restrict__ w1,
                        const uint16_t* __restrict__ w2, const float* __restrict__ rows,
                        float* wbase, float* part, float* sm, float* dys, int B,
                        const Geom& g) {
  const int tid = threadIdx.x;
  const WorkB wk(wbase, g);
  const MmaSmem s(sm, g);
  stage_weights_mma(w0, w1, w2, rows, sm);
  for (int i = tid; i < N_PARAM; i += kThreads) part[i] = 0.0f;
  __syncthreads();
  const float inv_p = (float)(1.0 / (double)g.P);
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const uint16_t* img = x + (size_t)b * g.H * g.W;
    conv01_fwd_mma<true>(img, s, g, wk);
    conv2_fwd_mma<true>(s, g, wk, nullptr);
    if (tid < 64) dys[tid] = dp[(size_t)b * 64 + tid] * inv_p;
    __syncthreads();
    conv2_bwd_mma(s, g, wk, dys, part);
    conv2_data_bwd_mma(s, g, wk, part);
    conv10_bwd_mma(img, s, g, wk, part);
  }
}

// The bf16 forward of the block's images on the tensor cores: conv0 and
// conv1 (a1 to the block's workspace), then conv2 and the pool, through
// the backward's recompute routines without their residuals.
__device__ void fwd_mma(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w0,
                        const uint16_t* __restrict__ w1, const uint16_t* __restrict__ w2,
                        const float* __restrict__ rows, uint16_t* a1, float* out,
                        float* sm, int B, const Geom& g) {
  const WorkB wk(a1);
  const MmaSmem s(sm, g);
  stage_weights_mma(w0, w1, w2, rows, sm);
  __syncthreads();
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    conv01_fwd_mma<false>(x + (size_t)b * g.H * g.W, s, g, wk);
    conv2_fwd_mma<false>(s, g, wk, out + (size_t)b * 64);
  }
}

// the probe of mma_bf16.cuh's lane layout: one warp, d = c + a @ b with
// a [16][16] row-major, b [8][16] ([n][k]) and c, d [16][8] float
__global__ void mma_probe_kernel(const uint16_t* a, const uint16_t* b,
                                 const float* c, float* d) {
  const int l = threadIdx.x & 31, gq = l >> 2, t = l & 3;
  uint32_t af[4], bf[2];
  mma::load_a(af, a, 16);
  mma::load_b(bf, b, 16);
  float acc[4] = {c[gq * 8 + 2 * t], c[gq * 8 + 2 * t + 1],
                  c[(gq + 8) * 8 + 2 * t], c[(gq + 8) * 8 + 2 * t + 1]};
  mma::mma_16816(acc, af, bf);
  d[gq * 8 + 2 * t] = acc[0];
  d[gq * 8 + 2 * t + 1] = acc[1];
  d[(gq + 8) * 8 + 2 * t] = acc[2];
  d[(gq + 8) * 8 + 2 * t + 1] = acc[3];
}

// bf16: the tensor-core forward; float: the scalar one (f32 parity rules
// out TF32)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_cnn_fwd_kernel(const T* __restrict__ x,        // [B, H, W]
                     const T* __restrict__ w0,       // [64, 64]
                     const T* __restrict__ w1,       // [256, 32]
                     const T* __restrict__ w2,       // [288, 64]
                     const float* __restrict__ rows, // [480]
                     uint16_t* work,                 // bf16: [blocks, hc * wc * 32]
                     float* __restrict__ out,        // [B, 64]
                     int B, int H, int W) {
  FUSED_CNN_DYN_SMEM(sm);
  const Geom g(H, W);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    fwd_mma(reinterpret_cast<const uint16_t*>(x), reinterpret_cast<const uint16_t*>(w0),
            reinterpret_cast<const uint16_t*>(w1), reinterpret_cast<const uint16_t*>(w2),
            rows, work + (size_t)blockIdx.x * g.fwd_work_halves(), out, sm, B, g);
  } else {
    stage_weights(w0, w1, w2, rows, sm);
    __syncthreads();
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      forward_image<T, false>(x + (size_t)b * H * W, sm, g, nullptr,
                              out + (size_t)b * 64);
  }
}

// the float32 backward: scalar FMAs (f32 parity rules out TF32)
template <typename T>
__device__ void bwd_scalar(const T* __restrict__ x, const float* __restrict__ dp,
                           const T* __restrict__ w0, const T* __restrict__ w1,
                           const T* __restrict__ w2, const float* __restrict__ rows,
                           float* wbase, float* part, float* sm, float* dys, int B,
                           const Geom& g) {
  const int tid = threadIdx.x;
  const Work wk(wbase, g);
  stage_weights(w0, w1, w2, rows, sm);
  for (int i = tid; i < N_PARAM; i += kThreads) part[i] = 0.0f;
  __syncthreads();
  const float inv_p = (float)(1.0 / (double)g.P);
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const T* img = x + (size_t)b * g.H * g.W;
    forward_image<T, true>(img, sm, g, wbase, nullptr);
    if (tid < 64) dys[tid] = dp[(size_t)b * 64 + tid] * inv_p;
    __syncthreads();
    conv2_bwd<T>(sm, g, wk, dys, part);
    conv2_data_bwd<T>(sm, g, wk, part);
    conv1_bwd<T>(sm, g, wk, part);
    conv0_bwd<T>(img, sm, g, wk, part);
  }
}

// bf16: the tensor-core backward; float: the scalar one
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_cnn_bwd_kernel(const T* __restrict__ x,        // [B, H, W]
                     const float* __restrict__ dp,   // [B, 64] d loss / d pooled
                     const T* __restrict__ w0, const T* __restrict__ w1,
                     const T* __restrict__ w2,
                     const float* __restrict__ rows,
                     float* work,                    // [blocks, work_floats]
                     float* part,                    // [blocks, N_PARAM]
                     int B, int H, int W) {
  FUSED_CNN_DYN_SMEM(sm);
  __shared__ float dys[64];
  const Geom g(H, W);
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  float* my_part = part + (size_t)blockIdx.x * N_PARAM;
  float* wbase = work + (size_t)blockIdx.x * g.work_floats(kMma);
  if constexpr (kMma)
    bwd_mma(reinterpret_cast<const uint16_t*>(x), dp,
            reinterpret_cast<const uint16_t*>(w0), reinterpret_cast<const uint16_t*>(w1),
            reinterpret_cast<const uint16_t*>(w2), rows, wbase, my_part, sm, dys, B, g);
  else
    bwd_scalar<T>(x, dp, w0, w1, w2, rows, wbase, my_part, sm, dys, B, g);
}

// grads[p] = sum of the blocks' partials, in block order
__global__ void fused_cnn_reduce_kernel(const float* __restrict__ part,
                                        float* __restrict__ grads, int blocks) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N_PARAM) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * N_PARAM + p];
  grads[p] = s;
}

// the bf16 kernels': the bf16 weights and the rows, then the staging
long long mma_smem_bytes(const Geom& g) {
  return 4LL * OF_STAGE + MmaLayout(g).bytes();
}

// the float kernels'; 0 unless the H x W image fits every kernel
int smem_bytes(int H, int W) {
  if (H < 4 || W < 4 || H % 4 || W % 4) return 0;
  const Geom g(H, W);
  const long long bytes = g.smem_floats() * 4;
  return bytes > kMaxDynSmem || mma_smem_bytes(g) > kMaxDynSmem
                 || g.wc + 1 + KCR > RING_C ? 0 : (int)bytes;
}

template <typename T>
int kernel_smem_bytes(int H, int W) {
  return std::is_same<T, __nv_bfloat16>::value ? (int)mma_smem_bytes(Geom(H, W))
                                               : smem_bytes(H, W);
}

// the forward's grid: one block per SM, at most B
cudaError_t fwd_grid(int B, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *grid = B < sms ? B : sms;
  return cudaSuccess;
}

template <typename T>
int launch_fwd(const void* x, const void* w0, const void* w1, const void* w2,
               const float* rows, void* work, float* out, int B, int H, int W,
               cudaStream_t st) {
  const int smem = kernel_smem_bytes<T>(H, W);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cnn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  if ((err = fwd_grid(B, &grid)) != cudaSuccess) return (int)err;
  FUSED_CNN_LAUNCH(fused_cnn_fwd_kernel<T>, grid, kThreads, smem, st,
                   (const T*)x, (const T*)w0, (const T*)w1, (const T*)w2,
                   rows, (uint16_t*)work, out, B, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const float* dp, const void* w0, const void* w1,
               const void* w2, const float* rows, float* work, float* part,
               float* grads, int B, int H, int W, cudaStream_t st) {
  const int smem = kernel_smem_bytes<T>(H, W);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cnn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B < kBwdBlocks ? B : kBwdBlocks;
  FUSED_CNN_LAUNCH(fused_cnn_bwd_kernel<T>, blocks, kThreads, smem, st,
                   (const T*)x, dp, (const T*)w0, (const T*)w1, (const T*)w2,
                   rows, work, part, B, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  FUSED_CNN_LAUNCH(fused_cnn_reduce_kernel, (N_PARAM + 255) / 256, 256, 0, st,
                   part, grads, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Dynamic shared memory of one float kernel's block at an H x W image, in
// bytes (0 if H or W is not a multiple of 4 or a block of any of the
// kernels, bf16 ones included, would exceed the card's limit).
extern "C" int fused_cnn_smem_bytes(int H, int W) { return smem_bytes(H, W); }

// Floats of the backward's workspace per block (bf16 = 1: the bf16
// instance's, which keeps a0 / a1 / g1 in bf16 and g0 / g2 on chip).
extern "C" int fused_cnn_workspace_floats(int H, int W, int bf16) {
  return (int)Geom(H, W).work_floats(bf16 != 0);
}

// Bytes of the forward's workspace per block (bf16 = 1: a1, hc x wc x 32
// bf16; the float forward keeps a1 in shared memory and needs none).
extern "C" int fused_cnn_fwd_workspace_bytes(int H, int W, int bf16) {
  return bf16 ? (int)(2 * Geom(H, W).fwd_work_halves()) : 0;
}

// Blocks of the forward at batch B on the current device (one per SM, at
// most B; 0 if the device cannot be queried).
extern "C" int fused_cnn_fwd_blocks(int B) {
  int grid = 0;
  return fwd_grid(B, &grid) == cudaSuccess ? grid : 0;
}

// Blocks of the backward (and rows of its partials) at batch B.
extern "C" int fused_cnn_bwd_blocks(int B) {
  return B < kBwdBlocks ? B : kBwdBlocks;
}

// Test hook of mma_bf16.cuh: d [16][8] = c + a [16][16] @ b^T, b given as
// [8][16] ([n][k]), a and b bf16 bits, on one warp.
extern "C" int fused_cnn_mma_probe(const void* a, const void* b, const float* c,
                                   float* d, void* stream) {
  FUSED_CNN_LAUNCH(mma_probe_kernel, 1, 32, 0, (cudaStream_t)stream,
                   (const uint16_t*)a, (const uint16_t*)b, c, d);
  return (int)cudaGetLastError();
}

// Pooled features out [B, 64] of the images x [B, H, W] (bf16 = 1: x and
// w0-w2 are bfloat16, else float). work holds fused_cnn_fwd_blocks(B) x
// fused_cnn_fwd_workspace_bytes. Returns a cudaError_t; never syncs.
extern "C" int fused_cnn_fwd_launch(const void* x, const void* w0,
                                    const void* w1, const void* w2,
                                    const float* rows, void* work, float* out,
                                    int B, int H, int W, int bf16, void* stream) {
  if (B <= 0 || smem_bytes(H, W) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w0, w1, w2, rows, work, out, B, H, W, st)
              : launch_fwd<float>(x, w0, w1, w2, rows, work, out, B, H, W, st);
}

// The flat float32 gradient grads [N_PARAM] of sum(pooled * dp): the
// backward over a fixed grid into part [blocks, N_PARAM], then the
// fixed-order reduction. work holds blocks x fused_cnn_workspace_floats.
extern "C" int fused_cnn_bwd_launch(const void* x, const float* dp,
                                    const void* w0, const void* w1,
                                    const void* w2, const float* rows,
                                    float* work, float* part, float* grads,
                                    int B, int H, int W, int bf16,
                                    void* stream) {
  if (B <= 0 || smem_bytes(H, W) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_bwd<__nv_bfloat16>(x, dp, w0, w1, w2, rows, work, part,
                                          grads, B, H, W, st)
              : launch_bwd<float>(x, dp, w0, w1, w2, rows, work, part, grads,
                                  B, H, W, st);
}
