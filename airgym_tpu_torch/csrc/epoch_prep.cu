// The fused trainers' epoch preparation between the rollout kernel (B2)
// and the update kernel (B3): GAE, the running-stat merges and the
// env-major dataset, in three launches.
//
// Replaces no TPU kernel: the JAX package ran this work as XLA ops inside
// its jitted epoch (airgym_tpu/rl/ppo.py: GAE's lax.scan, the running
// stats, the dataset). The port's eager version of it (rl/ppo.py
// compute_gae, the stats, the `flat` copies) takes ~265 launches a
// Hovering epoch, ~5 ms of host time in which the card idles; this chain
// takes three.
//
// Input: B2's record rec [H, K + 13, N] (rows 0:K the raw observation,
// K:K+4 the actions, K+4 neglogp, K+5 the model-space value, K+6:K+10 mu,
// K+10 reward, K+11 done, K+12 time-out), the bootstrap value [N] and the
// pre-update running stats (float64).
//   1. gae: blocks of 32 envs x 8 warps. Warp 0 runs GAE's reverse loop,
//      a lane per env, with compute_gae's float32 operations in its order
//      (the values and the bootstrap denormalised with the pre-update
//      value stats, the reward scale, the time-out bootstrap, the
//      recursion), and writes values, adv and returns [H, N]. Then warp w
//      takes the quantities q = w, w + 8, ... of the K + 3 (the K
//      observation features, the values, the returns, the advantages):
//      each lane its env's float64 mean and M2 over the H steps (two
//      passes), the 32 lanes merged by a shuffle tree (Chan's formula),
//      lane 0 writing the block's (count, mean, M2).
//   2. stats: one block; thread q merges quantity q's partials in block
//      order, then the RunningMeanStd updates with its float64 operations
//      (the observation stats; the value stats with the values, then with
//      the returns), the advantages' mean and population std (float64),
//      and the float32 constants of the normalisations.
//   3. dataset: one thread per env-major row j = n H + t: the observation
//      normalised with the new stats and clamped to +-5, the actions,
//      neglogp, mu, the normalised advantage and the normalised return
//      (clamped), each as RunningMeanStd.normalize rounds it.
// Every sum runs in a fixed order and there are no atomics: two calls on
// the same inputs agree to the bit. Built with -fmad=false, so each
// product and sum rounds as the PyTorch operations it repeats; the plain
// twin (ops/epoch_prep.epoch_prep_plain) repeats this arithmetic.
//
// Bound on the card: bytes. At Hovering's 4096 envs x 24 steps (K = 18)
// the chain reads the record's 31 rows once (12.2 MB) and writes values,
// adv and returns (1.2 MB) and the dataset's 29 floats a row (11.4 MB):
// 24.8 MB, 7.4 us at 3.35 TB/s. The float64 work is ~20 operations per
// observation element.
//
// Under AIRGYM_CUDA_EMU the source compiles as C++ against cuda_emu.h.
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kEnvs = 32;           // envs of a gae block: a lane each
constexpr int kWarps = 8;           // warps of a gae block
constexpr int kStatsThreads = 64;   // the stats block: a thread a quantity
constexpr int kRows = 256;          // rows of a dataset block

}  // namespace

// Must match ops/epoch_prep.py `_PrepArgs` field for field.
struct PrepArgs {
  const float* rec;
  const float* last_value;
  const double* obs_mean;
  const double* obs_var;
  const double* obs_count;
  const double* v_mean;
  const double* v_var;
  const double* v_count;
  float* values;      // [H, N]
  float* adv;         // [H, N]
  float* ret;         // [H, N]
  double* part;       // [N / 32, K + 3, 3]: (count, mean, M2)
  double* stats;      // obs mean [K], var [K], count; value mean, var,
                      // count; advantage mean, var
  float* consts;      // obs mean [K], sd [K]; return mean, sd; advantage
                      // mean, std + 1e-8
  float* obs_n;       // [N H, K]
  float* actions;     // [N H, 4]
  float* neglogp;     // [N H]
  float* mus;         // [N H, 4]
  float* adv_n;       // [N H]
  float* ret_n;       // [N H]
  int n;
  int horizon;
  int obs;
  int bootstrap;
  float gamma;
  float gamma_tau;
  float reward_scale;
};

namespace {

// Merges (nb, mb, m2b) into (n, mean, m2): Chan's formula.
__device__ __forceinline__ void chan(double& n, double& mean, double& m2,
                                     double nb, double mb, double m2b) {
  const double tot = n + nb;
  const double d = mb - mean;
  mean = mean + (d * nb) / tot;
  m2 = (m2 + m2b) + ((d * d) * (n * nb)) / tot;
  n = tot;
}

// RunningMeanStd.update's float64 operations: (mean, var, count) takes a
// batch of b_count samples with mean b_mean and variance b_var.
__device__ __forceinline__ void rms_update(double& mean, double& var,
                                           double& count, double b_mean,
                                           double b_var, double b_count) {
  const double delta = b_mean - mean;
  const double tot = count + b_count;
  const double m2 = ((var * count) + (b_var * b_count))
                    + (((delta * delta) * count) * b_count) / tot;
  mean = mean + (delta * b_count) / tot;
  var = m2 / tot;
  count = tot;
}

// torch.clamp(x, -5, 5), NaN kept
__device__ __forceinline__ float clamp5(float x) {
  return x < -5.0f ? -5.0f : (x > 5.0f ? 5.0f : x);
}

__global__ void __launch_bounds__(kEnvs * kWarps)
epoch_prep_gae_kernel(PrepArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t N = (size_t)a.n;
  const size_t n = (size_t)blockIdx.x * kEnvs + lane;
  const size_t step = (size_t)(a.obs + 13) * N;   // one step of the record
  const float* rec = a.rec + n;
  if (warp == 0) {
    const float mv = (float)*a.v_mean;
    const float sd = sqrtf((float)*a.v_var + 1e-5f);
    float next = a.last_value[n] * sd + mv;
    float gl = 0.0f;
    for (int t = a.horizon - 1; t >= 0; --t) {
      const float* r = rec + t * step;
      const float v = r[(a.obs + 5) * N] * sd + mv;
      float rew = r[(a.obs + 10) * N] * a.reward_scale;
      if (a.bootstrap)
        rew = rew + (a.gamma * v) * (r[(a.obs + 12) * N] > 0.5f ? 1.0f : 0.0f);
      const float nt = 1.0f - (r[(a.obs + 11) * N] > 0.5f ? 1.0f : 0.0f);
      const float delta = (rew + (a.gamma * next) * nt) - v;
      gl = delta + (a.gamma_tau * nt) * gl;
      a.values[t * N + n] = v;
      a.adv[t * N + n] = gl;
      a.ret[t * N + n] = gl + v;
      next = v;
    }
  }
  __syncthreads();
  const int Q = a.obs + 3;
  for (int q = warp; q < Q; q += kWarps) {
    const float* x = q < a.obs ? rec + q * N
                     : (q == a.obs ? a.values : q == a.obs + 1 ? a.ret : a.adv) + n;
    const size_t xs = q < a.obs ? step : N;
    double s = 0.0;
    for (int t = 0; t < a.horizon; ++t) s = s + (double)x[t * xs];
    double cnt = (double)a.horizon;
    double mean = s / cnt;
    double m2 = 0.0;
    for (int t = 0; t < a.horizon; ++t) {
      const double e = (double)x[t * xs] - mean;
      m2 = m2 + e * e;
    }
    // lane i < off merges lane i + off into itself; lanes from off up are
    // not read again
    for (int off = 16; off > 0; off >>= 1) {
      const double nb = __shfl_xor_sync(0xffffffffu, cnt, off);
      const double mb = __shfl_xor_sync(0xffffffffu, mean, off);
      const double m2b = __shfl_xor_sync(0xffffffffu, m2, off);
      chan(cnt, mean, m2, nb, mb, m2b);
    }
    if (lane == 0) {
      double* p = a.part + ((size_t)blockIdx.x * Q + q) * 3;
      p[0] = cnt;
      p[1] = mean;
      p[2] = m2;
    }
  }
}

__global__ void __launch_bounds__(kStatsThreads)
epoch_prep_stats_kernel(PrepArgs a) {
  __shared__ double sn[kStatsThreads], sm[kStatsThreads], s2[kStatsThreads];
  const int q = threadIdx.x, K = a.obs, Q = K + 3;
  const int blocks = a.n / kEnvs;
  if (q < Q) {
    const double* p = a.part + q * 3;
    double n = p[0], mean = p[1], m2 = p[2];
    for (int b = 1; b < blocks; ++b) {
      const double* pb = a.part + ((size_t)b * Q + q) * 3;
      chan(n, mean, m2, pb[0], pb[1], pb[2]);
    }
    sn[q] = n;
    sm[q] = mean;
    s2[q] = m2;
  }
  __syncthreads();
  if (q < K) {
    double mean = a.obs_mean[q], var = a.obs_var[q], count = *a.obs_count;
    rms_update(mean, var, count, sm[q], s2[q] / sn[q], sn[q]);
    a.stats[q] = mean;
    a.stats[K + q] = var;
    if (q == 0) a.stats[2 * K] = count;
    a.consts[q] = (float)mean;
    a.consts[K + q] = sqrtf((float)var + 1e-5f);
  } else if (q == K) {
    double mean = *a.v_mean, var = *a.v_var, count = *a.v_count;
    rms_update(mean, var, count, sm[K], s2[K] / sn[K], sn[K]);
    rms_update(mean, var, count, sm[K + 1], s2[K + 1] / sn[K + 1], sn[K + 1]);
    a.stats[2 * K + 1] = mean;
    a.stats[2 * K + 2] = var;
    a.stats[2 * K + 3] = count;
    a.consts[2 * K] = (float)mean;
    a.consts[2 * K + 1] = sqrtf((float)var + 1e-5f);
  } else if (q == K + 1) {
    const double var = s2[K + 2] / sn[K + 2];
    a.stats[2 * K + 4] = sm[K + 2];
    a.stats[2 * K + 5] = var;
    a.consts[2 * K + 2] = (float)sm[K + 2];
    a.consts[2 * K + 3] = (float)sqrt(var) + 1e-8f;
  }
}

__global__ void __launch_bounds__(kRows)
epoch_prep_dataset_kernel(PrepArgs a) {
  const size_t N = (size_t)a.n, H = (size_t)a.horizon, K = (size_t)a.obs;
  const size_t j = (size_t)blockIdx.x * kRows + threadIdx.x;
  if (j >= N * H) return;
  const size_t n = j / H, t = j % H;
  const float* r = a.rec + t * (K + 13) * N + n;
  const float* c = a.consts;
  for (size_t f = 0; f < K; ++f)
    a.obs_n[j * K + f] = clamp5((r[f * N] - c[f]) / c[K + f]);
  for (size_t i = 0; i < 4; ++i) {
    a.actions[j * 4 + i] = r[(K + i) * N];
    a.mus[j * 4 + i] = r[(K + 6 + i) * N];
  }
  a.neglogp[j] = r[(K + 4) * N];
  a.adv_n[j] = (a.adv[t * N + n] - c[2 * K + 2]) / c[2 * K + 3];
  a.ret_n[j] = clamp5((a.ret[t * N + n] - c[2 * K]) / c[2 * K + 1]);
}

bool valid(const PrepArgs* a) {
  return a->n > 0 && a->n % kEnvs == 0 && a->horizon > 0 && a->obs > 0
         && a->obs + 3 <= kStatsThreads;
}

}  // namespace

AIRGYM_EXPORT_ERROR_STRING

// Each returns a cudaError_t (0 = launched), launches on `stream` and
// never syncs; the three run in this order on one stream.
extern "C" int epoch_prep_gae_launch(const PrepArgs* a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  AIRGYM_LAUNCH(epoch_prep_gae_kernel, a->n / kEnvs, kEnvs * kWarps, 0,
                (cudaStream_t)stream, *a);
  return (int)cudaGetLastError();
}

extern "C" int epoch_prep_stats_launch(const PrepArgs* a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  AIRGYM_LAUNCH(epoch_prep_stats_kernel, 1, kStatsThreads, 0,
                (cudaStream_t)stream, *a);
  return (int)cudaGetLastError();
}

extern "C" int epoch_prep_dataset_launch(const PrepArgs* a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const int rows = a->n * a->horizon;
  AIRGYM_LAUNCH(epoch_prep_dataset_kernel, (rows + kRows - 1) / kRows, kRows,
                0, (cudaStream_t)stream, *a);
  return (int)cudaGetLastError();
}
