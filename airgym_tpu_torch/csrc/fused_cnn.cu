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
// cores, 2.12 ms at 67 TFLOP/s of FP32; its backward at B = 609 is 60 GFLOP
// (0.061 / 0.90 ms). The image (bf16, 208 MB at B = 4096) moves in
// ~0.06 ms. Operation-bound. The folded products below execute 1.56x
// (forward) and 1.51x (backward) these counts: w0 holds 25 live taps in
// each 64-row column, w1 144 in 256 rows.
//
// Design (simple first): scalar FP32 FMAs, no tensor cores.
// - Forward: one block of 512 threads per image (a persistent grid walks
//   the batch). The three weight matrices (as float, 123 KB) and the bias /
//   BN rows sit in shared memory. The block sweeps conv2's output rows two
//   at a time: each step stages 20 image rows, computes 4 cell rows of a0
//   and of a1 into 5-row rings (no halo is recomputed) and 2 rows of a2,
//   whose per-channel sums the threads 0..63 keep in a fixed order. Each
//   thread computes a 1-pixel x 8 (or 4) channel tile with float4 reads of
//   the operand and the weights. 202 KB of shared memory at 212 x 120: one
//   block per SM.
// - Backward: a fixed grid of min(B, 132) blocks, each walking images b =
//   block, block + 132, ... It reruns the forward, writing r0, a0, r1, a1
//   and r2 to a per-block float32 workspace in device memory, then sweeps
//   rows: conv2 (g2, dw2 and the channel sums), dA1 -> g1 (each element
//   gathered over its taps), conv1 (dw1, dA0 -> g0), conv0 (dw0), staging
//   the rows each step reads in shared memory. Each thread owns a fixed set
//   of gradient elements and adds its sums into the block's partial row;
//   a second launch adds the 132 partials in block order. No float atomics,
//   so two runs agree to the bit.
// - Shared-memory banks: a warp's lanes walk positions, not weight rows
//   (a weight row is a broadcast), and the staged rows whose positions the
//   lanes walk are padded (R0S, GS1, GS2) off the 32-bank period; the
//   first version read weight rows 64 floats apart across lanes: 16-way
//   bank conflicts.
// - FUSED_CNN_DYN_SMEM / FUSED_CNN_LAUNCH wrap the two CUDA-only
//   constructs, so the source also compiles as C++ against cuda_emu.h,
//   which emulates this subset of CUDA on the CPU for the tests (they hold
//   it against the plain version there).
// Left for later: tensor cores (bf16 mma with float32 accumulation is
// exact here), the backward's device-memory round trips, one block per SM.
#include <cstddef>
#include <cstdint>

#ifndef FUSED_CNN_EMU
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

#define FUSED_CNN_DYN_SMEM(name) extern __shared__ __align__(16) float name[]
#define FUSED_CNN_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

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
  __host__ __device__ long long work_floats() const {
    return 3LL * hc * wc * 96 + 2LL * ho * wo * 64;
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

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_cnn_fwd_kernel(const T* __restrict__ x,        // [B, H, W]
                     const T* __restrict__ w0,       // [64, 64]
                     const T* __restrict__ w1,       // [256, 32]
                     const T* __restrict__ w2,       // [288, 64]
                     const float* __restrict__ rows, // [480]
                     float* __restrict__ out,        // [B, 64]
                     int B, int H, int W) {
  FUSED_CNN_DYN_SMEM(sm);
  const Geom g(H, W);
  stage_weights(w0, w1, w2, rows, sm);
  __syncthreads();
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    forward_image<T, false>(x + (size_t)b * H * W, sm, g, nullptr,
                            out + (size_t)b * 64);
}

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
  const int tid = threadIdx.x;
  float* my_part = part + (size_t)blockIdx.x * N_PARAM;
  float* wbase = work + (size_t)blockIdx.x * g.work_floats();
  const Work wk(wbase, g);
  stage_weights(w0, w1, w2, rows, sm);
  for (int i = tid; i < N_PARAM; i += kThreads) my_part[i] = 0.0f;
  __syncthreads();
  const float inv_p = (float)(1.0 / (double)g.P);
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const T* img = x + (size_t)b * H * W;
    forward_image<T, true>(img, sm, g, wbase, nullptr);
    if (tid < 64) dys[tid] = dp[(size_t)b * 64 + tid] * inv_p;
    __syncthreads();
    conv2_bwd<T>(sm, g, wk, dys, my_part);
    conv2_data_bwd<T>(sm, g, wk, my_part);
    conv1_bwd<T>(sm, g, wk, my_part);
    conv0_bwd<T>(img, sm, g, wk, my_part);
  }
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

int smem_bytes(int H, int W) {
  if (H < 4 || W < 4 || H % 4 || W % 4) return 0;
  const long long bytes = Geom(H, W).smem_floats() * 4;
  return bytes > kMaxDynSmem ? 0 : (int)bytes;
}

template <typename T>
int launch_fwd(const void* x, const void* w0, const void* w1, const void* w2,
               const float* rows, float* out, int B, int H, int W,
               cudaStream_t st) {
  const int smem = smem_bytes(H, W);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cnn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = B < sms ? B : sms;
  FUSED_CNN_LAUNCH(fused_cnn_fwd_kernel<T>, grid, kThreads, smem, st,
                   (const T*)x, (const T*)w0, (const T*)w1, (const T*)w2,
                   rows, out, B, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const float* dp, const void* w0, const void* w1,
               const void* w2, const float* rows, float* work, float* part,
               float* grads, int B, int H, int W, cudaStream_t st) {
  const int smem = smem_bytes(H, W);
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

// Dynamic shared memory of one block at an H x W image, in bytes (0 if H
// or W is not a multiple of 4 or the block would exceed the card's limit).
extern "C" int fused_cnn_smem_bytes(int H, int W) { return smem_bytes(H, W); }

// Floats of the backward's workspace per block.
extern "C" int fused_cnn_workspace_floats(int H, int W) {
  return (int)Geom(H, W).work_floats();
}

// Blocks of the backward (and rows of its partials) at batch B.
extern "C" int fused_cnn_bwd_blocks(int B) {
  return B < kBwdBlocks ? B : kBwdBlocks;
}

// Pooled features out [B, 64] of the images x [B, H, W] (bf16 = 1: x and
// w0-w2 are bfloat16, else float). Returns a cudaError_t; never syncs.
extern "C" int fused_cnn_fwd_launch(const void* x, const void* w0,
                                    const void* w1, const void* w2,
                                    const float* rows, float* out, int B,
                                    int H, int W, int bf16, void* stream) {
  if (B <= 0 || smem_bytes(H, W) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w0, w1, w2, rows, out, B, H, W, st)
              : launch_fwd<float>(x, w0, w1, w2, rows, out, B, H, W, st);
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
