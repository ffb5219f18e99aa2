// Fused PPO update phase: all mini_epochs x nmb minibatch Adam steps,
// enqueued by one host call with no synchronisation.
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
// GFLOP per epoch in float32, 0.77 ms at 67 TFLOP/s of FP32; Balloon
// (B = 131,072, 64 minibatches) 68.7 GFLOP, 1.03 ms. At 48 features
// (Tracking, B = 98,304) ~112.5 kFLOP per sample, 55.3 GFLOP, 0.83 ms.
// The data is read once per mini-epoch (11-24 MB) and the parameters and
// moments (3 x 18,121 or 20,041 floats) move ~0.4 MB per step. FP32
// compute-bound.
//
// Design (simple first): the 18,121 params and two moments (217 KB; at 48
// features 20,041 and 240 KB) do not fit one block's shared memory beside
// a minibatch, and the 240 steps
// form a strict chain, so each Adam step is two launches:
//   (a) update_grad_kernel: one block per 32 samples stages the params in
//       shared memory, runs forward + backward for its samples and writes
//       per-block partial gradients and partial loss / KL / clip sums, and
//       the mu write-back rows;
//   (b) update_step_kernel: one block reduces the partials over blocks in
//       a FIXED order (no float atomics, so runs reproduce), clips, applies
//       Adam, accumulates the metrics and updates the lr at mini-epoch end.
// lr, the step count and the metric accumulators stay in device buffers.
//
// Left on the table: scalar FP32 loops in (a) (no tensor cores), the
// single-SM reduction in (b), 480 small launches per epoch, and no CUDA
// graph around them. Making it fast is later work.
#include "common.cuh"

namespace {

constexpr int ACT = 4, H0 = 64, H1 = 128, H2 = 64, HEAD = ACT + 1;
constexpr int N_MET = 8;                        // a, c, b, kl, clip partial sums
constexpr int S = 32;                           // samples per block
constexpr int SP = S + 1;                       // padded column stride
constexpr int NT = 256;                         // threads of (a)
constexpr int NT_STEP = 1024;                   // threads of (b)
constexpr int N_RED = 5 + ACT;                  // per-sample scalars reduced in (a)

// flat UpdatePack offsets at OBS features (airgym_tpu_torch/ops/fused_update.py)
template <int OBS>
struct Lay {
  static constexpr int O_W0 = 0;
  static constexpr int O_B0 = O_W0 + H0 * OBS;
  static constexpr int O_W1 = O_B0 + H0;
  static constexpr int O_B1 = O_W1 + H1 * H0;
  static constexpr int O_W2 = O_B1 + H1;
  static constexpr int O_B2 = O_W2 + H2 * H1;
  static constexpr int O_WH = O_B2 + H2;
  static constexpr int O_BH = O_WH + HEAD * H2;
  static constexpr int O_LOGSTD = O_BH + HEAD;
  static constexpr int NP = O_LOGSTD + ACT;     // 18,121 / 20,041
  static constexpr int NP_PAD = (NP + 3) / 4 * 4;
  static constexpr int PSTRIDE = NP_PAD + N_MET;  // floats per block of partials
  // 145 KB at 18 features, 157 KB at 48: under the 227 KB opt-in
  static constexpr size_t GRAD_SMEM =
      (size_t)(NP_PAD + SP * (OBS + 2 * (H0 + H1 + H2) + 2 * HEAD) + N_RED * S)
      * sizeof(float);
};

constexpr float B1 = 0.9f, B2 = 0.999f, ADAM_EPS = 1e-8f;
constexpr float ONE_M_B1 = (float)(1.0 - 0.9), ONE_M_B2 = (float)(1.0 - 0.999);
constexpr double LOG2PI = 1.8378770664093453;

}  // namespace

// Must match ops/fused_update.py `_UpdateArgs` field for field.
struct UpdateArgs {
  float* params;       // [NP] in/out
  float* m;            // [NP] in/out
  float* v;            // [NP] in/out
  float* lr;           // [1] in/out
  float* count;        // [1] in/out
  float* acc;          // [8] scratch: mini-epoch accumulators
  float* metrics;      // [8] out
  float* mus;          // [B, ACT] in: rollout mus; then the write-back
  float* sig;          // [nmb, ACT] in: rollout sigma; then the write-back
  float* partials;     // [nblk, PSTRIDE] scratch
  float* grad;         // [NP] scratch
  const float* obs;    // [B, OBS] normalized
  const float* act;    // [B, ACT]
  const float* adv;    // [B]
  const float* ret;    // [B]
  const float* nlp_old;  // [B]
  int obs_dim, batch, nmb, mini_epochs, truncate_grads, adaptive_lr;
  float clip_lo, clip_hi, e_clip;
  float inv_mb, critic_inv, bounds_inv;   // 1/mb, coef/mb
  float half_critic, bounds_coef, entropy_coef;
  float grad_norm, kl_threshold, min_lr, max_lr;
};

namespace {

__device__ __forceinline__ float elu(float z) {
  return z > 0.0f ? z : expf(fminf(z, 0.0f)) - 1.0f;
}

// out[j][s] = act(sum_k W[j][k] in[k][s] + b[j]) over the block's samples
template <int IN, int OUT, bool ELU>
__device__ __forceinline__ void dense(const float* __restrict__ W,
                                     const float* __restrict__ b,
                                     const float* in, float* out) {
  for (int idx = threadIdx.x; idx < OUT * S; idx += NT) {
    const int j = idx / S, s = idx % S;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < IN; ++k) acc += W[j * IN + k] * in[k * SP + s];
    const float z = acc + b[j];
    out[j * SP + s] = ELU ? elu(z) : z;
  }
}

// dW[j][k] = sum_s dz[j][s] in[k][s], db[j] = sum_s dz[j][s] -> partials
template <int IN, int OUT>
__device__ __forceinline__ void wgrad(const float* dz, const float* in,
                                      float* __restrict__ dW,
                                      float* __restrict__ db) {
  for (int idx = threadIdx.x; idx < OUT * IN; idx += NT) {
    const int j = idx / IN, k = idx % IN;
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) acc += dz[j * SP + s] * in[k * SP + s];
    dW[idx] = acc;
  }
  for (int j = threadIdx.x; j < OUT; j += NT) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += dz[j * SP + s];
    db[j] = acc;
  }
}

// dz_in[k][s] = (sum_j W[j][k] dz_out[j][s]) * elu'(h[k][s])
template <int IN, int OUT>
__device__ __forceinline__ void bgrad(const float* __restrict__ W,
                                      const float* dz_out, const float* h,
                                      float* dz_in) {
  for (int idx = threadIdx.x; idx < IN * S; idx += NT) {
    const int k = idx / S, s = idx % S;
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < OUT; ++j) acc += W[j * IN + k] * dz_out[j * SP + s];
    const float hv = h[k * SP + s];
    dz_in[k * SP + s] = acc * (hv > 0.0f ? 1.0f : hv + 1.0f);
  }
}

// (a) forward + backward of one 32-sample slice of minibatch i_mb
template <int OBS>
__global__ void __launch_bounds__(NT)
update_grad_kernel(UpdateArgs a, int i_mb, int mb) {
  using L = Lay<OBS>;
  constexpr int NP_PAD = L::NP_PAD, O_LOGSTD = L::O_LOGSTD;
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* x = w + NP_PAD;
  float* h0 = x + OBS * SP;
  float* h1 = h0 + H0 * SP;
  float* h2 = h1 + H1 * SP;
  float* hd = h2 + H2 * SP;
  float* dz0 = hd + HEAD * SP;
  float* dz1 = dz0 + H0 * SP;
  float* dz2 = dz1 + H1 * SP;
  float* dout = dz2 + H2 * SP;
  float* red = dout + HEAD * SP;              // [N_RED][S]

  const int tid = threadIdx.x;
  const int first = blockIdx.x * S;           // within the minibatch
  const int cnt = min(S, mb - first);
  const size_t base = (size_t)i_mb * mb + first;
  float* part = a.partials + (size_t)blockIdx.x * L::PSTRIDE;

  for (int i = tid; i < L::NP; i += NT) w[i] = a.params[i];
  for (int idx = tid; idx < OBS * S; idx += NT) {
    const int f = idx / S, s = idx % S;
    x[f * SP + s] = s < cnt ? a.obs[(base + s) * OBS + f] : 0.0f;
  }
  __syncthreads();
  dense<OBS, H0, true>(w + L::O_W0, w + L::O_B0, x, h0);
  __syncthreads();
  dense<H0, H1, true>(w + L::O_W1, w + L::O_B1, h0, h1);
  __syncthreads();
  dense<H1, H2, true>(w + L::O_W2, w + L::O_B2, h1, h2);
  __syncthreads();
  dense<H2, HEAD, false>(w + L::O_WH, w + L::O_BH, h2, hd);
  __syncthreads();

  // per-sample losses and head gradients (one thread per sample)
  if (tid < S) {
    const int s = tid;
    float vals[N_RED];
    if (s < cnt) {
      const size_t g = base + s;
      float mu[ACT], sigma[ACT], d[ACT];
      const float* ls = w + O_LOGSTD;
      const float lsum = ((ls[0] + ls[1]) + ls[2]) + ls[3];
#pragma unroll
      for (int k = 0; k < ACT; ++k) {
        mu[k] = hd[k * SP + s];
        sigma[k] = expf(ls[k]);
        d[k] = (a.act[g * ACT + k] - mu[k]) / sigma[k];
      }
      const float v = hd[ACT * SP + s];
      const float adv = a.adv[g], ret = a.ret[g];
      const float nlp = (0.5f * (((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) + d[3] * d[3])
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
      const float inclip = (ratio > a.clip_lo && ratio < a.clip_hi) ? 1.0f : 0.0f;
      const float dnlp = a.inv_mb * (use1 * adv * ratio
                                     + (1.0f - use1) * adv * ratio * inclip);
      float kl = 0.0f;
#pragma unroll
      for (int k = 0; k < ACT; ++k) {
        dout[k * SP + s] = dnlp * (-d[k] / sigma[k])
                           + a.bounds_inv * (2.0f * mu_hi[k] + 2.0f * mu_lo[k]);
        vals[5 + k] = dnlp * (1.0f - d[k] * d[k]);
        const float mo = a.mus[g * ACT + k], so = a.sig[i_mb * ACT + k];
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

  // block partial sums of the per-sample scalars, in sample order
  if (tid < N_RED) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += red[tid * S + s];
    if (tid < 5) part[NP_PAD + tid] = acc;
    else part[O_LOGSTD + tid - 5] = acc;
  }
  wgrad<H2, HEAD>(dout, h2, part + L::O_WH, part + L::O_BH);
  bgrad<H2, HEAD>(w + L::O_WH, dout, h2, dz2);
  __syncthreads();
  wgrad<H1, H2>(dz2, h1, part + L::O_W2, part + L::O_B2);
  bgrad<H1, H2>(w + L::O_W2, dz2, h1, dz1);
  __syncthreads();
  wgrad<H0, H1>(dz1, h0, part + L::O_W1, part + L::O_B1);
  bgrad<H0, H1>(w + L::O_W1, dz1, h0, dz0);
  __syncthreads();
  wgrad<OBS, H0>(dz0, x, part + L::O_W0, part + L::O_B0);
}

// (b) reduce over blocks, clip, Adam, metrics and the adaptive lr
template <int OBS>
__global__ void __launch_bounds__(NT_STEP)
update_step_kernel(UpdateArgs a, int i_mb, int nblk, int mb) {
  using L = Lay<OBS>;
  constexpr int NP = L::NP, NP_PAD = L::NP_PAD, PSTRIDE = L::PSTRIDE;
  constexpr int O_LOGSTD = L::O_LOGSTD;
  __shared__ float red[NT_STEP];
  __shared__ float sh[4];                      // lr, bc1, bc2, scale
  const int tid = threadIdx.x;
  const float* ls = a.params + O_LOGSTD;

  if (tid == 0) {
    float sums[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int b = 0; b < nblk; ++b)
      for (int k = 0; k < 5; ++k) sums[k] += a.partials[(size_t)b * PSTRIDE + NP_PAD + k];
    const float fmb = (float)mb;
    const float m_a = sums[0] / fmb, m_c = sums[1] / fmb, m_b = sums[2] / fmb;
    const float kl = sums[3] / fmb, clip = sums[4] / fmb;
    const float ent = (((ls[0] + ls[1]) + ls[2]) + ls[3])
                      + (float)(0.5 * ACT * (1.0 + LOG2PI));
    const float total = ((m_a + a.half_critic * m_c) - a.entropy_coef * ent)
                        + a.bounds_coef * m_b;
    if (i_mb == 0)
      for (int k = 0; k < 8; ++k) a.acc[k] = 0.0f;
    a.acc[0] += total; a.acc[1] += kl; a.acc[2] += m_a; a.acc[3] += m_c;
    a.acc[4] += m_b; a.acc[5] += ent; a.acc[6] += clip;
    // sigma write-back uses the pre-step logstd, like the forward pass
    for (int k = 0; k < ACT; ++k) a.sig[i_mb * ACT + k] = expf(ls[k]);
    const float t = a.count[0] + 1.0f;
    a.count[0] = t;
    sh[0] = a.lr[0];
    sh[1] = 1.0f - expf(t * logf(B1));
    sh[2] = 1.0f - expf(t * logf(B2));
  }

  // pass 1: gradient = fixed-order sum of the block partials
  float sq = 0.0f;
  for (int p = tid; p < NP; p += NT_STEP) {
    float g = 0.0f;
    for (int b = 0; b < nblk; ++b) g += a.partials[(size_t)b * PSTRIDE + p];
    if (p >= O_LOGSTD) g -= a.entropy_coef;
    a.grad[p] = g;
    sq += g * g;
  }
  red[tid] = sq;
  __syncthreads();
  for (int off = NT_STEP / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  if (tid == 0) {
    const float gn = sqrtf(red[0]);
    sh[3] = a.truncate_grads ? fminf(1.0f, a.grad_norm / fmaxf(gn, 1e-6f)) : 1.0f;
  }
  __syncthreads();

  // pass 2: Adam (optax rule, lr folded in after the bias correction)
  const float lr = sh[0], bc1 = sh[1], bc2 = sh[2], scale = sh[3];
  for (int p = tid; p < NP; p += NT_STEP) {
    const float g = a.grad[p] * scale;
    const float m = B1 * a.m[p] + ONE_M_B1 * g;
    const float v = B2 * a.v[p] + ONE_M_B2 * (g * g);
    a.m[p] = m;
    a.v[p] = v;
    a.params[p] = a.params[p] - lr * ((m / bc1) / (sqrtf(v / bc2) + ADAM_EPS));
  }

  if (tid == 0 && i_mb == a.nmb - 1) {
    if (a.adaptive_lr) {
      const float av_kl = a.acc[1] / (float)a.nmb;
      float lr1 = a.lr[0];
      if (av_kl > 2.0f * a.kl_threshold) lr1 = fmaxf(lr1 / 1.5f, a.min_lr);
      if (av_kl < 0.5f * a.kl_threshold) lr1 = fminf(lr1 * 1.5f, a.max_lr);
      a.lr[0] = lr1;
    }
    for (int k = 0; k < 7; ++k) a.metrics[k] = a.acc[k] / (float)a.nmb;
    a.metrics[7] = 0.0f;
  }
}

template <int OBS>
int launch(const UpdateArgs& a, cudaStream_t st) {
  const int mb = a.batch / a.nmb;
  const int nblk = (mb + S - 1) / S;
  const size_t smem = Lay<OBS>::GRAD_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      update_grad_kernel<OBS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int e = 0; e < a.mini_epochs; ++e) {
    for (int i = 0; i < a.nmb; ++i) {
      update_grad_kernel<OBS><<<nblk, NT, smem, st>>>(a, i, mb);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      update_step_kernel<OBS><<<1, NT_STEP, 0, st>>>(a, i, nblk, mb);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Enqueues all 2 x mini_epochs x nmb launches on `stream`; returns a
// cudaError_t (0 = all launched). Never synchronises.
extern "C" int fused_update_launch(const UpdateArgs* args, void* stream) {
  const UpdateArgs a = *args;
  if (a.nmb <= 0 || a.batch % a.nmb != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.obs_dim) {
    case 18: return launch<18>(a, st);
    case 48: return launch<48>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Floats per block of partial sums at `obs` features (0 if not built).
extern "C" int fused_update_partials_stride(int obs) {
  return obs == 18 ? Lay<18>::PSTRIDE : (obs == 48 ? Lay<48>::PSTRIDE : 0);
}
