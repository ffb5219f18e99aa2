// Test builds only, never part of a card build: the subset of CUDA that
// fused_cnn.cu (with mma_bf16.cuh), fused_update.cu, fused_rollout.cu
// and fused_hovering.cu (with quad_step.cuh and common.cuh),
// render_process.cu and render_depth.cu (with raycast.cuh) and
// epoch_prep.cu use, emulated
// on the CPU, so the kernel sources themselves can be compiled with g++
// and held against their plain versions where there is no card
// (tests/test_torch_fused_cnn.py, tests/test_torch_fused_update.py,
// tests/test_torch_fused_rollout.py, tests/test_torch_fused_hovering.py,
// tests/test_torch_render.py, tests/test_torch_render_depth.py,
// tests/test_torch_epoch_prep.py):
//
//   g++ -std=c++20 -O1 -shared -fPIC -ffp-contract=off -include cuda_emu.h
//       -x c++ fused_cnn.cu -o libfused_cnn_emu.so -lpthread
//
// Each CUDA thread is a std::thread and __syncthreads is a std::barrier of
// the block. An ordinary launch (emu_launch) runs the blocks one after
// another, each with the launch's dynamic shared memory filled with NaN
// (a read of shared memory the kernel never wrote shows up). A
// cooperative launch (emu_launch_cooperative) runs all grid x block
// threads at once, gives each block its own dynamic shared memory (also
// NaN), and the grid barrier is one std::barrier over all of them. bf16 rounds to nearest even
// on the bits. It checks indexing, barriers and rounding points, not speed
// or the GPU compiler.
//
// A warp's vote (__ballot_sync, __any_sync) goes through its exchange
// buffer too.
//
// mma_bf16.cuh's warp-level product (emu_mma_16816): each lane writes its
// fragments to its warp's exchange buffer, waits at the warp's barrier of
// 32, reads the whole 16 x 16 A and 16 x 8 B tiles, computes its own four
// D elements (the float64 sum of C and the 16 products, rounded once to
// float32) and waits again before the buffer is reused.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <math.h>   // sincosf (glibc)
#include <thread>
#include <vector>

#define AIRGYM_CUDA_EMU 1
#define FUSED_CNN_EMU 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct EmuIdx { int x, y, z; };
inline thread_local EmuIdx threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// the block's dynamic shared memory; cooperative launches only: the
// barrier of the whole grid
inline thread_local float* emu_dyn_smem = nullptr;
inline thread_local std::barrier<>* emu_grid_barrier = nullptr;
inline void emu_grid_sync() { emu_grid_barrier->arrive_and_wait(); }
// the warp of this thread: its barrier of 32 and fragment exchange buffer
struct EmuWarp {
  std::barrier<> bar{32};
  uint32_t a[32][4], b[32][2];
  float x[32];
  double xd[32];
  uint32_t vote[32];
};
inline thread_local EmuWarp* emu_warp = nullptr;
#define AIRGYM_COOP_DYN_SMEM(name) float* name = emu_dyn_smem
#define AIRGYM_GRID_SYNC() emu_grid_sync()
template <class T> inline T __ldcg(const T* p) { return *p; }

// the block's dynamic shared memory, NaN-filled by the launch
#define AIRGYM_DYN_SMEM(name) float* name = emu_dyn_smem
#define FUSED_CNN_DYN_SMEM(name) AIRGYM_DYN_SMEM(name)

struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
struct float2 { float x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }

// a warp shuffle: each lane gets the value of lane ^ m
inline float __shfl_xor_sync(unsigned, float v, int m) {
  EmuWarp& w = *emu_warp;
  const int l = threadIdx.x & 31;
  w.x[l] = v;
  w.bar.arrive_and_wait();
  const float r = w.x[l ^ m];
  w.bar.arrive_and_wait();
  return r;
}

inline double __shfl_xor_sync(unsigned, double v, int m) {
  EmuWarp& w = *emu_warp;
  const int l = threadIdx.x & 31;
  w.xd[l] = v;
  w.bar.arrive_and_wait();
  const double r = w.xd[l ^ m];
  w.bar.arrive_and_wait();
  return r;
}

// a warp vote: bit l of the result is lane l's predicate
inline unsigned __ballot_sync(unsigned, int pred) {
  EmuWarp& w = *emu_warp;
  const int l = threadIdx.x & 31;
  w.vote[l] = pred ? 1u : 0u;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= w.vote[i] << i;
  w.bar.arrive_and_wait();
  return m;
}

inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0u;
}

// mma.sync m16n8k16 row.col f32.bf16.bf16.f32 (see the header note)
inline void emu_mma_16816(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  EmuWarp& w = *emu_warp;
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.b[l][0] = b[0];
  w.b[l][1] = b[1];
  w.bar.arrive_and_wait();
  auto half = [](uint32_t v, int hi) {
    return (double)__bfloat162float({(uint16_t)(hi ? v >> 16 : v & 0xffffu)});
  };
  // A (r, k): lane (r & 7) * 4 + (k & 7) / 2, register (r >> 3) + 2 (k >> 3)
  auto A = [&](int r, int k) {
    return half(w.a[(r & 7) * 4 + ((k & 7) >> 1)][(r >> 3) + 2 * (k >> 3)], k & 1);
  };
  // B (k, n): lane n * 4 + (k & 7) / 2, register k >> 3
  auto B = [&](int k, int n) {
    return half(w.b[n * 4 + ((k & 7) >> 1)][k >> 3], k & 1);
  };
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    double s = d[i];
    for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
    d[i] = (float)s;
  }
  w.bar.arrive_and_wait();
}
inline float __fadd_rn(float a, float b) { return a + b; }

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
template <class K> inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// the SM count the emulated card reports: at 2, the persistent grids walk
// more than one image per block from B = 3 on
constexpr int kEmuSMs = 2;
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = kEmuSMs;
  return 0;
}
// one block per SM: a cooperative grid of kEmuSMs blocks
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                                 size_t) {
  *n = 1;
  return 0;
}
// a kernel's attributes: the emulation has no registers or local memory
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class K>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = {0, 0};
  return 0;
}
inline const char* cudaGetErrorString(int) { return "emulated CUDA error"; }
#define AIRGYM_EXPORT_ERROR_STRING                          \
  extern "C" const char* airgym_error_string(int err) {     \
    return cudaGetErrorString(err);                         \
  }

template <class F>
void emu_launch(int grid, int block, size_t smem_bytes, F body) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    std::vector<float> smem(smem_bytes / sizeof(float) + 4,
                            std::numeric_limits<float>::quiet_NaN());
    std::vector<EmuWarp> warps((block + 31) / 32);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = {block, 1, 1};
        gridDim = {grid, 1, 1};
        emu_barrier = &bar;
        emu_warp = &warps[t / 32];
        emu_dyn_smem = smem.data();
        body();
      });
    for (auto& th : threads) th.join();
  }
}
#define AIRGYM_LAUNCH(kernel, grid, block, smem, stream, ...) \
  emu_launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
#define FUSED_CNN_LAUNCH AIRGYM_LAUNCH

// all grid x block threads at once; returns cudaSuccess
template <class F>
int emu_launch_cooperative(int grid, int block, size_t smem_bytes, F body) {
  std::barrier<> grid_bar(grid * block);
  std::vector<std::barrier<>*> bars;
  std::vector<std::vector<float>> smem(grid);
  for (int b = 0; b < grid; ++b) {
    bars.push_back(new std::barrier<>(block));
    // NaN: a read of shared memory the kernel never wrote shows up
    smem[b].assign(smem_bytes / sizeof(float) + 4,
                   std::numeric_limits<float>::quiet_NaN());
  }
  std::vector<std::thread> threads;
  for (int b = 0; b < grid; ++b)
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = {block, 1, 1};
        gridDim = {grid, 1, 1};
        emu_barrier = bars[b];
        emu_grid_barrier = &grid_bar;
        emu_dyn_smem = smem[b].data();
        body();
      });
  for (auto& th : threads) th.join();
  for (auto* bar : bars) delete bar;
  return cudaSuccess;
}
#define AIRGYM_COOP_LAUNCH(kernel, grid, block, smem, stream, arg) \
  emu_launch_cooperative(grid, block, smem, [&] { kernel(arg); })
