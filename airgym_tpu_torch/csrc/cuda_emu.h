// Test builds only, never part of a card build: the subset of CUDA that
// fused_cnn.cu uses, emulated on the CPU, so the kernel source itself can be
// compiled with g++ and held against its plain version where there is no
// card (tests/test_torch_fused_cnn.py):
//
//   g++ -std=c++20 -O1 -shared -fPIC -ffp-contract=off -include cuda_emu.h
//       -x c++ fused_cnn.cu -o libfused_cnn_emu.so -lpthread
//
// Each CUDA thread is a std::thread, __syncthreads is a std::barrier of the
// block, blocks run one after another, and each kernel's dynamic shared
// memory is a static array of the kernel's own kMaxDynSmem bytes. bf16 rounds to nearest even on the bits. It checks
// indexing, barriers and rounding points, not speed or the GPU compiler.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

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

// one array per kernel, shared by the block's threads
#define FUSED_CNN_DYN_SMEM(name) alignas(16) static float name[kMaxDynSmem / 4]

struct float4 { float x, y, z, w; };
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
inline float __fadd_rn(float a, float b) { return a + b; }

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
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
inline const char* cudaGetErrorString(int) { return "emulated CUDA error"; }
#define AIRGYM_EXPORT_ERROR_STRING                          \
  extern "C" const char* airgym_error_string(int err) {     \
    return cudaGetErrorString(err);                         \
  }

template <class F>
void emu_launch(int grid, int block, F body) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = {block, 1, 1};
        gridDim = {grid, 1, 1};
        emu_barrier = &bar;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
#define FUSED_CNN_LAUNCH(kernel, grid, block, smem, stream, ...) \
  emu_launch(grid, block, [&] { kernel(__VA_ARGS__); })
