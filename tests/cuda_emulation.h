// The few CUDA features of hartallo_tpu_torch/csrc/intra_encode.cu and
// me_search.cu on the CPU, for tests/test_torch_intra_kernel_emulated.py
// and tests/test_torch_me_kernel_emulated.py: one std::thread per CUDA
// thread of a block, the blocks of a grid one after another,
// std::barrier for __syncthreads and __syncwarp, a per-warp slot array
// for __shfl_xor_sync, and float operations that round once each, as
// __fadd_rn, __fmul_rn, __fdiv_rn and __fmaf_rn do.  Every lane of a warp
// must reach each __syncwarp and shuffle, as the kernels' code does.
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __constant__
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __shared__

struct EmuDim3 {
  unsigned x = 0, y = 0, z = 0;
};
thread_local EmuDim3 threadIdx;
EmuDim3 blockDim, blockIdx, gridDim;
std::unique_ptr<std::barrier<>> emu_block_barrier;
std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
int emu_shfl_slots[64][32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[threadIdx.x >> 5]->arrive_and_wait();
}

inline int __shfl_xor_sync(unsigned, int v, int lane_mask) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  emu_shfl_slots[w][l] = v;
  __syncwarp();
  const int r = emu_shfl_slots[w][l ^ lane_mask];
  __syncwarp();
  return r;
}

inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}

inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}

inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}

inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }

inline int __clz(int x) {
  return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
}

inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

// the block's dynamic shared memory (`extern __shared__ int smem[]`)
namespace {
alignas(16) int smem[1 << 16];
}

// Run `kernel(args)` as one block of `threads` threads (a multiple of 32,
// at most 2048).
template <class Kernel, class Args>
void emu_launch(Kernel kernel, const Args& args, int threads) {
  blockDim.x = threads;
  emu_block_barrier = std::make_unique<std::barrier<>>(threads);
  emu_warp_barriers.clear();
  for (int w = 0; w < threads / 32; ++w)
    emu_warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([t, &kernel, &args] {
      threadIdx.x = t;
      kernel(args);
    });
  for (auto& th : pool) th.join();
}

// Run `kernel(args)` on a grid of gx x gy blocks of `threads` threads
// each, one block after another in raster order.
template <class Kernel, class Args>
void emu_launch_grid(Kernel kernel, const Args& args, int gx, int gy,
                     int threads) {
  gridDim.x = gx;
  gridDim.y = gy;
  gridDim.z = 1;
  for (int y = 0; y < gy; ++y)
    for (int x = 0; x < gx; ++x) {
      blockIdx.x = x;
      blockIdx.y = y;
      emu_launch(kernel, args, threads);
    }
}
