// Fused PPO update phase: all mini_epochs x nmb minibatch Adam steps of one
// update call in ONE persistent, cooperatively launched kernel.
//
// Replaces: airgym_tpu/ops/fused_update.py `_kernel` (wrapper
// `fused_update`). Semantics kept exactly: the [64,128,64] elu MLP
// forward, the clipped PPO surrogate (hard clamp), critic MSE, bounds
// loss, entropy term, the hand-derived backward, the global-norm clip
// min(1, g / max(n, 1e-6)), optax Adam with lr folded in after the
// bias-corrected update and one shared step count, the per-minibatch mu /
// sigma write-back (mini-epoch 0 takes its KL reference from the rollout,
// later mini-epochs from the previous visit), the adaptive-KL lr at each
// mini-epoch end, and metrics averaged over the last mini-epoch.
//
// One source, two instances: 18 observation features (Hovering, Balloon)
// and 48 (Tracking); the width is a template parameter.
//
// Bound on the card, at 18 features (Hovering: B = 98,304, mb = 2048, 48
// minibatches, 5 mini-epochs): ~104.8 kFLOP per sample (forward 17,856
// MAC, weight gradients 17,856 MAC, input gradients 16,704 MAC), 51.5
// GFLOP per call in float32, 0.769 ms at 67 TFLOP/s of FP32; Balloon
// (B = 131,072, 64 minibatches) 68.7 GFLOP, 1.03 ms. At 48 features
// (Tracking, B = 98,304) ~112.5 kFLOP per sample, 55.3 GFLOP, 0.825 ms.
// The data is read once per mini-epoch (11-24 MB) and the parameters and
// moments (3 x 18,121 or 20,041 floats) move ~0.4 MB per step. FP32
// compute-bound.
//
// The first design (two launches per Adam step, 480 per Hovering epoch)
// took 30.88 ms per call at 18 features and 34.08 ms at 48 on an H100
// 80GB HBM3 at 700 W: its gradient kernel ran 64 blocks of 32 samples on
// half the card with both FMA operands read from shared memory, and its
// step kernel reduced 64 partial rows and applied Adam on one SM.
//
// Design: one cooperative launch of G blocks (G = SMs x resident blocks
// per SM, capped by the caller; all co-resident), each Adam step three
// phases split by grid barriers:
//   A. gradients: block b takes samples [mb b / G, mb (b+1) / G) of the
//      minibatch, in chunks of S = 16. It stages the parameters from
//      device memory (L2-resident) into shared memory in one pass of
//      float4 loads, runs the forward, the per-sample loss and head terms
//      and the backward with register tiles (a thread owns a few outputs x 4 samples, or a few
//      weight gradients, and reads weight rows and activation rows as
//      float4), and writes one partial row: its gradient, its 5 loss / KL /
//      clip sums and its 4 logstd terms; also its samples' mu write-back.
//   B. reduce: block b owns a 4-aligned slice of the parameters. It stages
//      the G x slice tile of partial rows in shared memory (float4 loads,
//      all in flight at once), sums each column over the G rows in block
//      order (minus entropy_coef on logstd), and writes the gradient and
//      its slice's sum of squares. The last block's slice runs on over the
//      5 loss / KL / clip slots, and that block keeps the books: metric
//      accumulators, sigma write-back from the pre-step logstd, the step
//      count.
//   C. Adam: every block sums the G squares in block order (so all get the
//      same norm), clips and applies optax Adam to its own slice. At a
//      mini-epoch's end the last block adapts lr and writes the metrics.
// Every sum is taken in a fixed order and there are no float atomics: two
// calls on the same inputs agree to the bit. Data that another block wrote
// during the launch is read with __ldcg (L2, not the SM's L1).
//
// AIRGYM_COOP_DYN_SMEM / AIRGYM_GRID_SYNC / AIRGYM_COOP_LAUNCH wrap the
// CUDA-only constructs, so the source also compiles as C++ against
// cuda_emu.h, which emulates them on the CPU for the tests.
//
// This design: 7.50 ms per call at 18 features and 8.03 ms at 48, about
// 9.7x the bound (chip_smoke.py, H100 80GB HBM3 at 700 W, G = 128).
//
// Left for later: tensor cores (for example 3xTF32 mma.sync in phase A,
// which keeps float32 accuracy), a CUDA graph of the whole epoch, and
// thread block clusters: a multicast of the parameters that every block
// stages each step, distributed shared memory for phase B.
#include <cstddef>

#ifndef AIRGYM_CUDA_EMU
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

#define AIRGYM_COOP_DYN_SMEM(name) extern __shared__ __align__(16) float name[]
#define AIRGYM_GRID_SYNC() cooperative_groups::this_grid().sync()
#define AIRGYM_COOP_LAUNCH(kernel, grid, block, smem, stream, arg)        \
  [&] {                                                                   \
    void* kargs_[] = {(void*)&(arg)};                                     \
    return (int)cudaLaunchCooperativeKernel((const void*)(kernel),        \
                                            dim3(grid), dim3(block),      \
                                            kargs_, (smem), (stream));    \
  }()
#endif

namespace {

constexpr int ACT = 4, H0 = 64, H1 = 128, H2 = 64, HEAD = ACT + 1;
constexpr int N_MET = 8;          // slots after the gradient in a partial row
constexpr int M_SQ = 5;           // ... slot of the block's sum of squares
constexpr int NT = 256;           // threads per block
constexpr int S = 16;             // samples per chunk
constexpr int SP = S + 4;         // activation row stride: float4 rows of
                                  // neighbouring lanes fall in other banks
constexpr int N_RED = 5 + ACT;    // per-sample scalars summed in the block
constexpr int MAX_GRID = 512;     // phase B's tile: < NP_PAD + 12 G floats

__host__ __device__ constexpr int r4(int n) { return (n + 3) / 4 * 4; }
// shared-memory row stride of a weight matrix with `in` columns
__host__ __device__ constexpr int ldw(int in) { return r4(in) + 4; }

template <int OBS>
struct Lay {
  // flat UpdatePack offsets (airgym_tpu_torch/ops/fused_update.py): the
  // parameters, moments, gradient and partial rows in device memory
  static constexpr int O_W0 = 0;
  static constexpr int O_B0 = O_W0 + H0 * OBS;
  static constexpr int O_W1 = O_B0 + H0;
  static constexpr int O_B1 = O_W1 + H1 * H0;
  static constexpr int O_W2 = O_B1 + H1;
  static constexpr int O_B2 = O_W2 + H2 * H1;
  static constexpr int O_WH = O_B2 + H2;
  static constexpr int O_BH = O_WH + HEAD * H2;
  static constexpr int O_LOGSTD = O_BH + HEAD;
  static constexpr int NP = O_LOGSTD + ACT;       // 18,121 / 20,041
  static constexpr int NP_PAD = (NP + 3) / 4 * 4;
  static constexpr int PSTRIDE = NP_PAD + N_MET;  // floats per partial row
  // shared memory: the parameters with padded rows (pads staged as 0) ...
  static constexpr int IN0 = r4(OBS);
  static constexpr int LW0 = ldw(OBS), LW1 = ldw(H0), LW2 = ldw(H1),
                       LWH = ldw(H2);
  static constexpr int S_W0 = 0;
  static constexpr int S_B0 = S_W0 + H0 * LW0;
  static constexpr int S_W1 = S_B0 + H0;
  static constexpr int S_B1 = S_W1 + H1 * LW1;
  static constexpr int S_W2 = S_B1 + H1;
  static constexpr int S_B2 = S_W2 + H2 * LW2;
  static constexpr int S_WH = S_B2 + H2;
  static constexpr int S_BH = S_WH + HEAD * LWH;
  static constexpr int S_LOGSTD = S_BH + 8;
  // ... then the chunk's activations and their gradients, [rows][SP]
  static constexpr int A_X = S_LOGSTD + 4;
  static constexpr int A_H0 = A_X + IN0 * SP;
  static constexpr int A_H1 = A_H0 + H0 * SP;
  static constexpr int A_H2 = A_H1 + H1 * SP;
  static constexpr int A_HD = A_H2 + H2 * SP;
  static constexpr int A_DZ0 = A_HD + 8 * SP;
  static constexpr int A_DZ1 = A_DZ0 + H0 * SP;
  static constexpr int A_DZ2 = A_DZ1 + H1 * SP;
  static constexpr int A_DOUT = A_DZ2 + H2 * SP;
  static constexpr int A_RED = A_DOUT + 8 * SP;   // [N_RED][S]
  // [NT], then lr, scale, the 5 loss / KL / clip sums, and the last
  // block's 8 mini-epoch accumulators and pre-step logstd
  static constexpr int A_SCR = A_RED + N_RED * S;
  static constexpr int FLOATS = A_SCR + NT + 20;
  // 122.7 KB at 18 features, 132.1 KB at 48: one block per SM
  static constexpr size_t SMEM = (size_t)FLOATS * sizeof(float);
  static_assert(NP_PAD + 12 * MAX_GRID <= A_SCR,
                "phase B's tile overruns A_SCR");
};

constexpr float B1 = 0.9f, B2 = 0.999f, ADAM_EPS = 1e-8f;
constexpr float ONE_M_B1 = (float)(1.0 - 0.9), ONE_M_B2 = (float)(1.0 - 0.999);
constexpr double LOG2PI = 1.8378770664093453;

}  // namespace

// Must match ops/fused_update.py `_UpdateArgs` field for field.
struct UpdateArgs {
  float* params;       // [NP_PAD] in/out (zero past NP)
  float* m;            // [NP] in/out
  float* v;            // [NP] in/out
  float* lr;           // [1] in/out
  float* count;        // [1] in/out
  float* metrics;      // [8] out
  float* mus;          // [B, ACT] in: rollout mus; then the write-back
  float* sig;          // [nmb, ACT] in: rollout sigma; then the write-back
  float* partials;     // [grid, PSTRIDE] one partial row per block
  float* grad;         // [NP] scratch
  const float* obs;    // [B, OBS] normalized
  const float* act;    // [B, ACT]
  const float* adv;    // [B]
  const float* ret;    // [B]
  const float* nlp_old;  // [B]
  int obs_dim, batch, nmb, mini_epochs, truncate_grads, adaptive_lr, grid;
  float clip_lo, clip_hi, e_clip;
  float inv_mb, critic_inv, bounds_inv;   // 1/mb, coef/mb
  float half_critic, bounds_coef, entropy_coef;
  float grad_norm, kl_threshold, min_lr, max_lr;
};

namespace {

__device__ __forceinline__ float elu(float z) {
  return z > 0.0f ? z : expf(fminf(z, 0.0f)) - 1.0f;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = float4{v[0], v[1], v[2], v[3]};
}

// w[0..N) = p[0..N), in one shared-memory load where N is 2 or 4
template <int N>
__device__ __forceinline__ void ldv(const float* p, float (&w)[N]) {
  if constexpr (N == 4) {
    const float4 q = ld4(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    w[0] = q.x; w[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = p[i];
  }
}

// acc[0..3] += w * x[0..3], in order
__device__ __forceinline__ void fma4(float (&acc)[4], float w, float4 x) {
  acc[0] += w * x.x; acc[1] += w * x.y; acc[2] += w * x.z; acc[3] += w * x.w;
}

// out[j][s] = act(b[j] + sum_k W[j][k] in[k][s]) for the chunk's S samples;
// a thread owns JT rows x 4 samples, k summed in order. Weights and inputs
// are zero past IN up to r4(IN).
template <int IN, int LD, int OUT, int JT, bool ELU>
__device__ __forceinline__ void dense(const float* W, const float* b,
                                     const float* in, float* out) {
  constexpr int TILES = OUT / JT * (S / 4);
  for (int t = threadIdx.x; t < TILES; t += NT) {
    const int s0 = t % (S / 4) * 4, j0 = t / (S / 4) * JT;
    float acc[JT][4];
#pragma unroll
    for (int jt = 0; jt < JT; ++jt)
      acc[jt][0] = acc[jt][1] = acc[jt][2] = acc[jt][3] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < r4(IN); k += 4) {
      const float4 x0 = ld4(in + (k + 0) * SP + s0);
      const float4 x1 = ld4(in + (k + 1) * SP + s0);
      const float4 x2 = ld4(in + (k + 2) * SP + s0);
      const float4 x3 = ld4(in + (k + 3) * SP + s0);
#pragma unroll
      for (int jt = 0; jt < JT; ++jt) {
        const float4 w = ld4(W + (j0 + jt) * LD + k);
        fma4(acc[jt], w.x, x0);
        fma4(acc[jt], w.y, x1);
        fma4(acc[jt], w.z, x2);
        fma4(acc[jt], w.w, x3);
      }
    }
#pragma unroll
    for (int jt = 0; jt < JT; ++jt) {
      const float bj = b[j0 + jt];
      float z[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        z[i] = acc[jt][i] + bj;
        if (ELU) z[i] = elu(z[i]);
      }
      st4(out + (j0 + jt) * SP + s0, z);
    }
  }
}

// dW[j][k] (+)= sum_s dz[j][s] in[k][s] and db[j] (+)= sum_s dz[j][s] into
// the block's partial row (flat, row stride IN); `add` after the first
// chunk. A thread owns JT rows x KT columns, the columns KG apart so that
// neighbouring lanes read neighbouring activation rows.
template <int IN, int OUT, int JT, int KT>
__device__ __forceinline__ void wgrad(const float* dz, const float* in,
                                      float* dW, float* db, bool add) {
  constexpr int KG = (IN + KT - 1) / KT;
  constexpr int TILES = OUT / JT * KG;
  for (int t = threadIdx.x; t < TILES; t += NT) {
    const int kg = t % KG, j0 = t / KG * JT;
    float acc[JT][KT];
#pragma unroll
    for (int jt = 0; jt < JT; ++jt)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) acc[jt][kt] = 0.0f;
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      float4 d[JT], x[KT];
#pragma unroll
      for (int jt = 0; jt < JT; ++jt) d[jt] = ld4(dz + (j0 + jt) * SP + s);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const int k = kg + kt * KG;
        x[kt] = k < IN ? ld4(in + k * SP + s) : float4{0.0f, 0.0f, 0.0f, 0.0f};
      }
#pragma unroll
      for (int jt = 0; jt < JT; ++jt)
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          float a = acc[jt][kt];
          a += d[jt].x * x[kt].x;
          a += d[jt].y * x[kt].y;
          a += d[jt].z * x[kt].z;
          a += d[jt].w * x[kt].w;
          acc[jt][kt] = a;
        }
    }
#pragma unroll
    for (int jt = 0; jt < JT; ++jt)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const int k = kg + kt * KG;
        if (k < IN) {
          float* o = dW + (j0 + jt) * IN + k;
          *o = add ? *o + acc[jt][kt] : acc[jt][kt];
        }
      }
  }
  for (int j = threadIdx.x; j < OUT; j += NT) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += dz[j * SP + s];
    db[j] = add ? db[j] + acc : acc;
  }
}

// dz_in[k][s] = (sum_j W[j][k] dz_out[j][s]) * elu'(h[k][s]), j in order;
// a thread owns KT inputs x 4 samples
template <int IN, int LD, int OUT, int KT>
__device__ __forceinline__ void bgrad(const float* W, const float* dz_out,
                                      const float* h, float* dz_in) {
  constexpr int TILES = IN / KT * (S / 4);
  for (int t = threadIdx.x; t < TILES; t += NT) {
    const int s0 = t % (S / 4) * 4, k0 = t / (S / 4) * KT;
    float acc[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      acc[kt][0] = acc[kt][1] = acc[kt][2] = acc[kt][3] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < OUT; ++j) {
      const float4 d = ld4(dz_out + j * SP + s0);
      float w[KT];
      ldv<KT>(W + j * LD + k0, w);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) fma4(acc[kt], w[kt], d);
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const float4 hv = ld4(h + (k0 + kt) * SP + s0);
      const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = acc[kt][i] * (hs[i] > 0.0f ? 1.0f : hs[i] + 1.0f);
      st4(dz_in + (k0 + kt) * SP + s0, o);
    }
  }
}

// for i in [0, n): put(i, get(i)), each thread with U loads in flight
// before its stores: the loads come from L2, and their latencies overlap
template <int U, class Get, class Put>
__device__ __forceinline__ void copy_batched(int n, Get get, Put put) {
  for (int i0 = threadIdx.x; i0 < n; i0 += NT * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      v[u] = i < n ? get(i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      if (i < n) put(i, v[u]);
    }
  }
}

// shared-memory position of flat parameter e < NP (sections in the same
// order in both layouts; the matrices' rows padded to LW*)
template <int OBS>
__device__ __forceinline__ int sm_index(int e) {
  using L = Lay<OBS>;
  // element i of a matrix with `cols` columns at shared row stride ld
  const auto mat = [](int i, int cols, int ld) {
    return i / cols * ld + i % cols;
  };
  if (e < L::O_B0) return L::S_W0 + mat(e, OBS, L::LW0);
  if (e < L::O_W1) return L::S_B0 + (e - L::O_B0);
  if (e < L::O_B1) return L::S_W1 + mat(e - L::O_W1, H0, L::LW1);
  if (e < L::O_W2) return L::S_B1 + (e - L::O_B1);
  if (e < L::O_B2) return L::S_W2 + mat(e - L::O_W2, H1, L::LW2);
  if (e < L::O_WH) return L::S_B2 + (e - L::O_B2);
  if (e < L::O_BH) return L::S_WH + mat(e - L::O_WH, H2, L::LWH);
  if (e < L::O_LOGSTD) return L::S_BH + (e - L::O_BH);
  return L::S_LOGSTD + (e - L::O_LOGSTD);
}

// The parameters (params padded to NP_PAD floats) into shared memory in
// one pass: each thread issues its float4 loads from L2 (other blocks wrote
// them during this launch) before its stores, so that their latencies
// overlap. Up to O_BH every section from FAST on starts 16-byte aligned in
// both layouts and its rows are multiples of 4 wide, so a float4 lands
// whole (FAST = 0 at 48 features, O_W1 at 18, whose W0 rows are 18 wide);
// the rest lands float by float.
template <int OBS>
__device__ __forceinline__ void stage_params(float* sm, const float* params) {
  using L = Lay<OBS>;
  // two rounds of U float4 loads per thread
  constexpr int N4 = L::NP_PAD / 4, U = (N4 + 2 * NT - 1) / (2 * NT);
  constexpr int FAST = OBS % 4 == 0 ? 0 : L::O_W1;
  for (int f0 = threadIdx.x; f0 < N4; f0 += U * NT) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = f0 + u * NT;
      v[u] = f < N4 ? __ldcg(reinterpret_cast<const float4*>(params) + f)
                    : float4{0.0f, 0.0f, 0.0f, 0.0f};
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = 4 * (f0 + u * NT);
      if (e >= FAST && e < L::O_BH) {
        *reinterpret_cast<float4*>(sm + sm_index<OBS>(e)) = v[u];
      } else if (e < L::NP) {
        const float q[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (e + i < L::NP) sm[sm_index<OBS>(e + i)] = q[i];
      }
    }
  }
  // W0's pad columns that the forward reads (phase B overwrote them)
  if constexpr (L::IN0 > OBS) {
    constexpr int PADS = L::IN0 - OBS;
    for (int i = threadIdx.x; i < H0 * PADS; i += NT)
      sm[L::S_W0 + i / PADS * L::LW0 + OBS + i % PADS] = 0.0f;
  }
}

// Phase A: this block's samples [first, last) of minibatch i_mb -> its
// partial row
template <int OBS>
__device__ void grad_phase(const UpdateArgs& a, float* sm, int i_mb, int mb,
                           int first, int last, float* part) {
  using L = Lay<OBS>;
  const int tid = threadIdx.x;
  stage_params<OBS>(sm, a.params);
  if (last <= first)                       // no samples: a zero row
    for (int p = tid; p < L::PSTRIDE; p += NT) part[p] = 0.0f;
  float* x = sm + L::A_X;
  float* h0 = sm + L::A_H0;
  float* h1 = sm + L::A_H1;
  float* h2 = sm + L::A_H2;
  float* hd = sm + L::A_HD;
  float* dz0 = sm + L::A_DZ0;
  float* dz1 = sm + L::A_DZ1;
  float* dz2 = sm + L::A_DZ2;
  float* dout = sm + L::A_DOUT;
  float* red = sm + L::A_RED;
  const float* w = sm;
  const float* ls = sm + L::S_LOGSTD;
  const float sig_old[ACT] = {__ldcg(a.sig + i_mb * ACT + 0),
                              __ldcg(a.sig + i_mb * ACT + 1),
                              __ldcg(a.sig + i_mb * ACT + 2),
                              __ldcg(a.sig + i_mb * ACT + 3)};
  for (int c = first; c < last; c += S) {
    const bool add = c > first;
    const int cnt = last - c < S ? last - c : S;
    const size_t base = (size_t)i_mb * mb + c;
    for (int idx = tid; idx < L::IN0 * S; idx += NT) {   // pad rows 0
      const int s = idx / L::IN0, f = idx % L::IN0;
      x[f * SP + s] = s < cnt && f < OBS ? a.obs[(base + s) * OBS + f] : 0.0f;
    }
    __syncthreads();
    dense<OBS, L::LW0, H0, 1, true>(w + L::S_W0, w + L::S_B0, x, h0);
    __syncthreads();
    dense<H0, L::LW1, H1, 2, true>(w + L::S_W1, w + L::S_B1, h0, h1);
    __syncthreads();
    dense<H1, L::LW2, H2, 2, true>(w + L::S_W2, w + L::S_B2, h1, h2);
    __syncthreads();
    dense<H2, L::LWH, HEAD, 1, false>(w + L::S_WH, w + L::S_BH, h2, hd);
    __syncthreads();

    // per-sample losses and head gradients (one thread per sample)
    if (tid < S) {
      const int s = tid;
      float vals[N_RED];
      if (s < cnt) {
        const size_t g = base + s;
        float mu[ACT], sigma[ACT], d[ACT];
        const float lsum = ((ls[0] + ls[1]) + ls[2]) + ls[3];
#pragma unroll
        for (int k = 0; k < ACT; ++k) {
          mu[k] = hd[k * SP + s];
          sigma[k] = expf(ls[k]);
          d[k] = (a.act[g * ACT + k] - mu[k]) / sigma[k];
        }
        const float v = hd[ACT * SP + s];
        const float adv = a.adv[g], ret = a.ret[g];
        const float nlp = (0.5f * (((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
                                   + d[3] * d[3])
                           + (float)(0.5 * LOG2PI * ACT)) + lsum;
        const float ratio = expf(a.nlp_old[g] - nlp);
        const float clamped = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
        const float n_s1 = -adv * ratio, n_s2 = -adv * clamped;
        const float a_loss = fmaxf(n_s1, n_s2);
        const float verr = v - ret;
        float b_loss = 0.0f;
        float mu_hi[ACT], mu_lo[ACT];
#pragma unroll
        for (int k = 0; k < ACT; ++k) {
          mu_hi[k] = fmaxf(mu[k] - 1.1f, 0.0f);
          mu_lo[k] = fminf(mu[k] + 1.1f, 0.0f);
          b_loss += mu_hi[k] * mu_hi[k] + mu_lo[k] * mu_lo[k];
        }
        const float use1 = n_s1 >= n_s2 ? 1.0f : 0.0f;
        const float inclip =
            (ratio > a.clip_lo && ratio < a.clip_hi) ? 1.0f : 0.0f;
        const float dnlp = a.inv_mb * (use1 * adv * ratio
                                       + (1.0f - use1) * adv * ratio * inclip);
        float kl = 0.0f;
#pragma unroll
        for (int k = 0; k < ACT; ++k) {
          dout[k * SP + s] =
              dnlp * (-d[k] / sigma[k])
              + a.bounds_inv * (2.0f * mu_hi[k] + 2.0f * mu_lo[k]);
          vals[5 + k] = dnlp * (1.0f - d[k] * d[k]);
          const float mo = a.mus[g * ACT + k], so = sig_old[k];
          const float dm = mu[k] - mo;
          kl += logf(sigma[k] / so + 1e-7f) + (so * so + dm * dm)
                / (2.0f * sigma[k] * sigma[k] + 1e-7f) - 0.5f;
          a.mus[g * ACT + k] = mu[k];
        }
        dout[ACT * SP + s] = a.critic_inv * verr;
        vals[0] = a_loss;
        vals[1] = verr * verr;
        vals[2] = b_loss;
        vals[3] = kl;
        vals[4] = fabsf(ratio - 1.0f) > a.e_clip ? 1.0f : 0.0f;
      } else {
#pragma unroll
        for (int k = 0; k < HEAD; ++k) dout[k * SP + s] = 0.0f;
#pragma unroll
        for (int k = 0; k < N_RED; ++k) vals[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < N_RED; ++k) red[k * S + s] = vals[k];
    }
    __syncthreads();

    // the chunk's sums of the per-sample scalars, in sample order
    if (tid < N_RED) {
      float acc = 0.0f;
      for (int s = 0; s < S; ++s) acc += red[tid * S + s];
      float* o = tid < 5 ? part + L::NP_PAD + tid
                         : part + L::O_LOGSTD + tid - 5;
      *o = add ? *o + acc : acc;
    }
    wgrad<H2, HEAD, 1, 4>(dout, h2, part + L::O_WH, part + L::O_BH, add);
    bgrad<H2, L::LWH, HEAD, 4>(w + L::S_WH, dout, h2, dz2);
    __syncthreads();
    wgrad<H1, H2, 8, 4>(dz2, h1, part + L::O_W2, part + L::O_B2, add);
    bgrad<H1, L::LW2, H2, 2>(w + L::S_W2, dz2, h1, dz1);
    __syncthreads();
    wgrad<H0, H1, 8, 4>(dz1, h0, part + L::O_W1, part + L::O_B1, add);
    bgrad<H0, L::LW1, H1, 2>(w + L::S_W1, dz1, h0, dz0);
    __syncthreads();
    wgrad<OBS, H0, 4, (OBS + 11) / 12>(dz0, x, part + L::O_W0,
                                       part + L::O_B0, add);
    __syncthreads();
  }
}

// p[0] + p[stride] + ... + p[(n - 1) stride] in that order (shared
// memory), with 8 loads ahead of the adds
__device__ __forceinline__ float sum_in_order(const float* p, int n,
                                              int stride) {
  float s = 0.0f;
  int b = 0;
  for (; b + 8 <= n; b += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = p[(b + u) * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; b < n; ++b) s += p[b * stride];
  return s;
}

// buf[0..n) = src[0..n) * stride, loaded by all threads at once, then
// summed by thread 0 in order; every thread must call it. Returns the sum
// on thread 0.
__device__ __forceinline__ float ordered_sum(float* buf, const float* src,
                                             size_t stride, int n) {
  copy_batched<4>(
      n, [&](int b) { return __ldcg(src + b * stride); },
      [&](int b, float v) { buf[b] = v; });
  __syncthreads();
  const float s = threadIdx.x == 0 ? sum_in_order(buf, n, 1) : 0.0f;
  __syncthreads();
  return s;
}

// Phase B: the gradient of parameters [p0, min(p1, NP)) summed over the G
// partial rows in block order, and its sum of squares into this block's
// row. The G x (p1 - p0) tile of partials is staged in shared memory first
// (over the parameters and activations: phase A stages them again). The
// last block's slice runs on over the 5 loss / KL / clip slots, so their
// sums come out of the same tile, and it keeps the books of step i_mb.
template <int OBS>
__device__ void reduce_phase(const UpdateArgs& a, float* sm, int i_mb, int mb,
                             int p0, int p1, float t) {
  using L = Lay<OBS>;
  const int tid = threadIdx.x, G = a.grid, W = p1 - p0;
  const bool books = blockIdx.x == G - 1;
  float* scr = sm + L::A_SCR;
  // the pre-step logstd, before the tile overwrites it
  if (books && tid < ACT) scr[NT + 16 + tid] = sm[L::S_LOGSTD + tid];
  __syncthreads();
  {
    // the tile as float4 (slices are 4-aligned), all of a thread's loads
    // in flight before its stores
    constexpr int U = 12;
    const int W4 = W / 4, n4 = G * W4;
    for (int f0 = tid; f0 < n4; f0 += NT * U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = f0 + u * NT, b = f / W4;
        const float* row = a.partials + (size_t)b * L::PSTRIDE + p0;
        v[u] = f < n4
                   ? __ldcg(reinterpret_cast<const float4*>(row) + f - b * W4)
                   : float4{0.0f, 0.0f, 0.0f, 0.0f};
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (f0 + u * NT < n4) reinterpret_cast<float4*>(sm)[f0 + u * NT] = v[u];
    }
  }
  __syncthreads();
  float sq = 0.0f;
  for (int q = tid; q < W; q += NT) {
    const int p = p0 + q;
    if (p >= L::NP && (p < L::NP_PAD || p >= L::NP_PAD + 5)) continue;
    float g = sum_in_order(sm + q, G, W);
    if (p >= L::NP_PAD) {              // a loss / KL / clip sum
      scr[NT + 2 + p - L::NP_PAD] = g;
      continue;
    }
    if (p >= L::O_LOGSTD) g -= a.entropy_coef;
    a.grad[p] = g;
    sq += g * g;
  }
  scr[tid] = sq;
  __syncthreads();
  for (int off = NT / 2; off > 0; off >>= 1) {
    if (tid < off) scr[tid] += scr[tid + off];
    __syncthreads();
  }
  if (tid == 0) {
    a.partials[(size_t)blockIdx.x * L::PSTRIDE + L::NP_PAD + M_SQ] = scr[0];
    scr[NT] = __ldcg(a.lr);     // lr changes only in phase C
  }
  if (books && tid == 0) {
    const float* sums = scr + NT + 2;
    const float* ls = scr + NT + 16;
    const float fmb = (float)mb;
    const float m_a = sums[0] / fmb, m_c = sums[1] / fmb, m_b = sums[2] / fmb;
    const float kl = sums[3] / fmb, clip = sums[4] / fmb;
    const float ent = (((ls[0] + ls[1]) + ls[2]) + ls[3])
                      + (float)(0.5 * ACT * (1.0 + LOG2PI));
    const float total = ((m_a + a.half_critic * m_c) - a.entropy_coef * ent)
                        + a.bounds_coef * m_b;
    float* acc = scr + NT + 8;
    if (i_mb == 0)
      for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    acc[0] += total; acc[1] += kl; acc[2] += m_a; acc[3] += m_c;
    acc[4] += m_b; acc[5] += ent; acc[6] += clip;
    for (int k = 0; k < ACT; ++k) a.sig[i_mb * ACT + k] = expf(ls[k]);
    a.count[0] = t;
  }
}

// Phase C: the global norm from the G block sums in block order, the clip,
// and optax Adam on parameters [p0, min(p1, NP)); the lr and metrics at a
// mini-epoch's end (the last block, which keeps the books)
template <int OBS>
__device__ void adam_phase(const UpdateArgs& a, float* sm, int i_mb, int p0,
                           int p1, float t) {
  using L = Lay<OBS>;
  const int tid = threadIdx.x, G = a.grid;
  float* scr = sm + L::A_SCR;
  // this thread's first parameter's operands, loaded before the norm's
  // sum so that their latency overlaps it
  const int pf = p0 + tid;
  float g0 = 0.0f, m0 = 0.0f, v0 = 0.0f, w0 = 0.0f;
  if (pf < p1 && pf < L::NP) {
    g0 = a.grad[pf]; m0 = a.m[pf]; v0 = a.v[pf]; w0 = a.params[pf];
  }
  const float sq = ordered_sum(sm, a.partials + L::NP_PAD + M_SQ, L::PSTRIDE,
                               G);
  if (tid == 0) {
    const float gn = sqrtf(sq);
    scr[NT + 1] = a.truncate_grads ? fminf(1.0f, a.grad_norm / fmaxf(gn, 1e-6f))
                                   : 1.0f;
  }
  __syncthreads();
  const float lr = scr[NT], scale = scr[NT + 1];
  const float bc1 = 1.0f - expf(t * logf(B1));
  const float bc2 = 1.0f - expf(t * logf(B2));
  for (int p = pf; p < p1 && p < L::NP; p += NT) {
    const bool first = p == pf;
    const float g = (first ? g0 : a.grad[p]) * scale;
    const float m = B1 * (first ? m0 : a.m[p]) + ONE_M_B1 * g;
    const float v = B2 * (first ? v0 : a.v[p]) + ONE_M_B2 * (g * g);
    a.m[p] = m;
    a.v[p] = v;
    a.params[p] = (first ? w0 : a.params[p])
                  - lr * ((m / bc1) / (sqrtf(v / bc2) + ADAM_EPS));
  }
  if (blockIdx.x == G - 1 && tid == 0 && i_mb == a.nmb - 1) {
    if (a.adaptive_lr) {
      const float av_kl = scr[NT + 8 + 1] / (float)a.nmb;
      float lr1 = lr;
      if (av_kl > 2.0f * a.kl_threshold) lr1 = fmaxf(lr1 / 1.5f, a.min_lr);
      if (av_kl < 0.5f * a.kl_threshold) lr1 = fminf(lr1 * 1.5f, a.max_lr);
      a.lr[0] = lr1;
    }
    for (int k = 0; k < 7; ++k) a.metrics[k] = scr[NT + 8 + k] / (float)a.nmb;
    a.metrics[7] = 0.0f;
  }
}

template <int OBS>
__global__ void __launch_bounds__(NT, 1) update_kernel(UpdateArgs a) {
  using L = Lay<OBS>;
  AIRGYM_COOP_DYN_SMEM(sm);
  const int b = blockIdx.x, G = a.grid;
  const int mb = a.batch / a.nmb;
  const int first = (int)((long long)mb * b / G);
  const int last = (int)((long long)mb * (b + 1) / G);
  // this block's parameters [p0, min(p1, NP)): 4-aligned slices of NP_PAD;
  // the last runs on over the partial rows' loss / KL / clip slots
  const int p0 = 4 * (int)((long long)(L::NP_PAD / 4) * b / G);
  const int p1 = b == G - 1
                     ? L::PSTRIDE
                     : 4 * (int)((long long)(L::NP_PAD / 4) * (b + 1) / G);
  float* part = a.partials + (size_t)b * L::PSTRIDE;
  // read before the last block first writes it (after the first grid
  // barrier)
  const float count0 = a.count[0];
  int step = 0;
  for (int e = 0; e < a.mini_epochs; ++e) {
    for (int i = 0; i < a.nmb; ++i, ++step) {
      const float t = count0 + (float)(step + 1);
      grad_phase<OBS>(a, sm, i, mb, first, last, part);
      AIRGYM_GRID_SYNC();
      reduce_phase<OBS>(a, sm, i, mb, p0, p1, t);
      AIRGYM_GRID_SYNC();
      adam_phase<OBS>(a, sm, i, p0, p1, t);
      AIRGYM_GRID_SYNC();
    }
  }
}

template <int OBS>
int grid_size(int cap, int* grid) {
  const size_t smem = Lay<OBS>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      update_kernel<OBS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      update_kernel<OBS>, NT,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0 || cap <= 0) return (int)cudaErrorInvalidConfiguration;
  if (cap > MAX_GRID) cap = MAX_GRID;
  *grid = sms * per_sm < cap ? sms * per_sm : cap;
  return 0;
}

template <int OBS>
int launch(const UpdateArgs& a, cudaStream_t st) {
  const size_t smem = Lay<OBS>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      update_kernel<OBS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  UpdateArgs arg = a;
  return AIRGYM_COOP_LAUNCH(update_kernel<OBS>, a.grid, NT, smem, st, arg);
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// The persistent grid at `obs` features: SMs x resident blocks per SM,
// at most `cap` and MAX_GRID, into *grid. Returns a cudaError_t.
extern "C" int fused_update_grid(int obs, int cap, int* grid) {
  switch (obs) {
    case 18: return grid_size<18>(cap, grid);
    case 48: return grid_size<48>(cap, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the whole update call (every Adam step) as one cooperative
// kernel of args->grid blocks on `stream`; returns a cudaError_t (0 =
// launched; a refused cooperative launch is an error). Never synchronises.
extern "C" int fused_update_launch(const UpdateArgs* args, void* stream) {
  const UpdateArgs a = *args;
  if (a.nmb <= 0 || a.batch % a.nmb != 0 || a.grid <= 0 || a.grid > MAX_GRID)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.obs_dim) {
    case 18: return launch<18>(a, st);
    case 48: return launch<48>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Floats per partial row at `obs` features (0 if not built).
extern "C" int fused_update_partials_stride(int obs) {
  return obs == 18 ? Lay<18>::PSTRIDE : (obs == 48 ? Lay<48>::PSTRIDE : 0);
}
