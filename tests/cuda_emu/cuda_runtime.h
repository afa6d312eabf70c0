// A CPU stand-in for the CUDA runtime surface that the port's kernels use,
// so that tests/test_torch_cuda_emu.py can build csrc/*.cu with a host C++
// compiler.  Every CUDA thread of a block runs as one std::thread; blocks
// run one after another.  __syncthreads and __syncwarp are std::barriers
// over the block and over the warp (32 consecutive threads), warp shuffles
// and ballots go through an exchange buffer, and dynamic shared memory is
// one buffer, filled with NaN before each block so that a read of a value
// that no thread wrote shows up in the result.
//
// The test rewrites two CUDA-only constructs in the source before it
// compiles it: `extern __shared__ T name[];` becomes a pointer to that
// buffer, and `kernel<<<grid, block, smem, stream>>>(args)` becomes
// `ff_emu_launch(grid, block, smem, stream, kernel, args)`.
//
// What this checks: the kernels' indexing, barriers and arithmetic.  What it
// cannot: the GPU compiler, its FMA contraction and rounding, occupancy,
// races that this strict lockstep hides, timing.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}

// Arithmetic intrinsics.  x86-64 without -mfma has no fused multiply-add,
// so each operation rounds once, as the _rn intrinsics ask.  sincosf is
// glibc's.
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}
inline int __ffs(int v) { return v == 0 ? 0 : __builtin_ctz((unsigned)v) + 1; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum { cudaSharedmemCarveoutMaxShared = 100 };

constexpr int kEmuSmemPerSm = 233472;  // an H100 SM's shared memory, bytes
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 232448;
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncSetAttribute(T, int, int) {
  return cudaSuccess;
}
// By shared memory alone (1 KB reserved per block), as the card counts it.
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, T, int,
                                                          size_t smem) {
  *blocks = (int)(kEmuSmemPerSm / (smem + 1024));
  return cudaSuccess;
}

struct EmuBlock {
  std::barrier<>* block;
  std::vector<std::unique_ptr<std::barrier<>>>* warps;
  std::vector<uint32_t>* exchange;
};
inline thread_local dim3 threadIdx, blockIdx, blockDim;
inline thread_local EmuBlock emu_block;
inline float4* ff_emu_dyn_smem = nullptr;

inline int emu_linear_tid() {
  return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
}
inline void __syncthreads() { emu_block.block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*emu_block.warps)[emu_linear_tid() / 32]->arrive_and_wait();
}
// The value that this thread's warp-mate `src` (0..31) offered; every
// thread of the warp must call it, as the full-mask intrinsics require.
template <class T>
T emu_exchange(T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int t = emu_linear_tid();
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  (*emu_block.exchange)[t] = bits;
  __syncwarp();
  bits = (*emu_block.exchange)[(t / 32) * 32 + src];
  __syncwarp();
  std::memcpy(&v, &bits, 4);
  return v;
}
// Lane src of this thread's segment of `width` lanes.
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = emu_linear_tid() % 32;
  return emu_exchange(v, (lane / width) * width + ((src % width) + width) % width);
}
// Lane (this lane ^ lane_mask), or this lane if that leaves the segment.
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask, int width = 32) {
  const int lane = emu_linear_tid() % 32;
  const int other = lane ^ lane_mask;
  return emu_exchange(v, other / width == lane / width ? other : lane);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int t = emu_linear_tid();
  (*emu_block.exchange)[t] = pred ? 1u : 0u;
  __syncwarp();
  unsigned bits = 0;
  const int w0 = (t / 32) * 32;
  for (int l = 0; l < 32 && w0 + l < (int)emu_block.exchange->size(); ++l)
    bits |= (*emu_block.exchange)[w0 + l] << l;
  __syncwarp();
  return bits;
}

template <class... K, class... A>
void ff_emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                   void (*kernel)(K...), A... args) {
  std::vector<float4> dyn(smem / sizeof(float4) + 1);
  const int nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        const float nan = std::numeric_limits<float>::quiet_NaN();
        std::fill(dyn.begin(), dyn.end(), float4{nan, nan, nan, nan});
        ff_emu_dyn_smem = dyn.data();
        std::barrier<> block_barrier(nt);
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        for (int w = 0; w < (nt + 31) / 32; ++w)
          warps.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
        std::vector<uint32_t> exchange(nt);
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            blockDim = block;
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                             t / (block.x * block.y));
            emu_block = EmuBlock{&block_barrier, &warps, &exchange};
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
