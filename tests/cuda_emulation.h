// The few CUDA features of hartallo_tpu_torch/csrc/intra_encode.cu,
// intra_decode.cu, me_search.cu, p_encode.cu, mc_decode.cu and
// deblock.cu's parameter kernel on the CPU, for the tests
// tests/test_torch_*_emulated.py: one std::thread per CUDA thread of a
// block, sleeping barriers for
// __syncthreads and
// __syncwarp, a per-warp slot array for the warp shuffles (with their
// width), votes and reductions, float operations that round once each,
// as __fadd_rn, __fmul_rn, __fdiv_rn and __fmaf_rn do, and the byte-SIMD
// intrinsics (__vabsdiffu4, __vavgu4, __vsadu4, __dp4a, __byte_perm,
// __funnelshift_r) as integer code, atomicAdd on std::atomic_ref, and the
// int4 and int2 vector types.  Every lane of a warp must reach each
// __syncwarp and warp collective, as the kernels' code does.
//
// Two launches: emu_launch_grid runs the blocks of a grid one after
// another (me_search.cu, whose blocks share nothing); emu_launch_cooperative
// runs every block of the grid at once, as a cooperative launch keeps them
// resident (intra_encode.cu and intra_decode.cu, whose rows wait on each
// other), with the primitives of csrc/device_prims.cuh: acquire loads
// and release stores on std::atomic_ref, a spin-wait that sleeps between
// polls, barriers of some of a block's warps and their arrive-only half,
// and each block's own dynamic shared memory; it can start the blocks in
// reverse order, each some time after the block behind it, so that lower
// rows run first.  A spin-wait whose counter does not move for
// EMU_STALL_SECONDS, or a hand-written spin loop (spin_on) still running
// that long after the launch began, sets emu_stalled and returns, and so
// does every later one: the launch ends with wrong outputs instead of
// hanging.
#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __constant__
#define __device__
#define __forceinline__ inline
#define __global__
#define __host__
#define __launch_bounds__(...)
#define __shared__

struct EmuDim3 {
  unsigned x = 0, y = 0, z = 0;
};

// CUDA's int4 and int2, 16- and 8-byte aligned as vector_types.h declares
// them
struct alignas(16) int4 {
  int x, y, z, w;
};

struct alignas(8) int2 {
  int x, y;
};

inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

inline int2 make_int2(int x, int y) { return {x, y}; }

// A barrier whose waiters sleep at once (std::barrier spins first, which
// takes the cores of the threads it waits for when there are many more
// threads than cores).
class EmuBarrier {
 public:
  explicit EmuBarrier(int n) : n_(n) {}
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lock(m_);
    const unsigned phase = phase_;
    if (++count_ == n_) {
      count_ = 0;
      ++phase_;
      cv_.notify_all();
      return;
    }
    cv_.wait(lock, [&] { return phase_ != phase; });
  }
  // count one arrival without waiting (bar.arrive)
  void arrive() {
    std::lock_guard<std::mutex> lock(m_);
    if (++count_ == n_) {
      count_ = 0;
      ++phase_;
      cv_.notify_all();
    }
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  const int n_;
  int count_ = 0;
  unsigned phase_ = 0;
};

// One block's barriers, warp exchange slots and dynamic shared memory.
struct EmuBlock {
  EmuBlock(int threads, size_t smem_words)
      : bar(threads), slots(threads / 32 * 64), smem(smem_words) {
    for (int w = 0; w < threads / 32; ++w)
      warps.push_back(std::make_unique<EmuBarrier>(32));
  }
  EmuBarrier bar;
  std::vector<std::unique_ptr<EmuBarrier>> warps;
  std::array<std::unique_ptr<EmuBarrier>, 16> named;  // bar_sync's
  std::mutex named_mutex;
  std::vector<uint32_t> slots;  // per warp: two rounds of 32 lanes
  std::vector<int> smem;
};

thread_local EmuDim3 threadIdx, blockIdx;
thread_local EmuBlock* emu_block;
thread_local int emu_round;  // which of the warp's two slot rounds is next
EmuDim3 blockDim, gridDim;

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warps[threadIdx.x >> 5]->arrive_and_wait();
}

// Every lane posts v; returns the 32 posted values.  The two rounds
// alternate, so one barrier suffices: a lane posts into a round again only
// after every lane has passed the next collective, and so has read this
// one.
inline const uint32_t* emu_exchange(uint32_t v) {
  uint32_t* s = emu_block->slots.data() + (threadIdx.x >> 5) * 64 +
                emu_round * 32;
  emu_round ^= 1;
  s[threadIdx.x & 31] = v;
  __syncwarp();
  return s;
}

inline int __shfl_xor_sync(unsigned, int v, int lane_mask) {
  return (int)emu_exchange((uint32_t)v)[(threadIdx.x & 31) ^ lane_mask];
}

// width: the lanes form segments of `width` (a power of two up to 32), and
// a lane reads within its own segment, as CUDA's shuffles do
inline int __shfl_sync(unsigned, int v, int src_lane, int width = 32) {
  const int lane = threadIdx.x & 31;
  return (int)emu_exchange((uint32_t)v)[(lane & ~(width - 1)) |
                                        (src_lane & (width - 1))];
}

// the value of lane - delta of the lane's segment, its own below delta
inline int __shfl_up_sync(unsigned, int v, unsigned delta, int width = 32) {
  const int lane = threadIdx.x & 31;
  const uint32_t* s = emu_exchange((uint32_t)v);
  return (lane & (width - 1)) < (int)delta ? v : (int)s[lane - delta];
}

inline unsigned __ballot_sync(unsigned, int pred) {
  const uint32_t* s = emu_exchange(pred != 0);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= s[l] << l;
  return r;
}

inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const uint32_t* s = emu_exchange(v);
  return *std::min_element(s, s + 32);
}

inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  const uint32_t* s = emu_exchange(v);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= s[l];
  return r;
}

inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const uint32_t* s = emu_exchange(v);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r += s[l];
  return r;
}

inline int __ffs(int x) { return __builtin_ffs(x); }

inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}

// The byte-SIMD and byte-permute intrinsics, each its exact integer
// definition (bytes numbered from the least significant).
inline unsigned emu_byte(unsigned x, int i) { return (x >> (8 * i)) & 255u; }

inline unsigned __vabsdiffu4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) {
    const unsigned x = emu_byte(a, i), y = emu_byte(b, i);
    r |= (x > y ? x - y : y - x) << (8 * i);
  }
  return r;
}

// the per-byte average of a and b, rounded up
inline unsigned __vavgu4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= ((emu_byte(a, i) + emu_byte(b, i) + 1) >> 1) << (8 * i);
  return r;
}

inline unsigned __vsadu4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) {
    const unsigned x = emu_byte(a, i), y = emu_byte(b, i);
    r += x > y ? x - y : y - x;
  }
  return r;
}

inline unsigned __dp4a(unsigned a, unsigned b, unsigned c) {
  for (int i = 0; i < 4; ++i) c += emu_byte(a, i) * emu_byte(b, i);
  return c;
}

inline int __dp4a(int a, int b, int c) {
  for (int i = 0; i < 4; ++i)
    c += (int)(int8_t)emu_byte((unsigned)a, i) *
         (int)(int8_t)emu_byte((unsigned)b, i);
  return c;
}

// byte i of the result is byte (s >> 4 i) & 7 of the eight bytes {y, x}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t xy = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((xy >> (8 * ((s >> (4 * i)) & 7))) & 255u) << (8 * i);
  return r;
}

// the low 32 bits of {hi, lo} shifted right by shift & 31
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)((((uint64_t)hi << 32) | lo) >> (shift & 31));
}

template <class T>
inline T __ldcg(const T* p) {
  return *p;
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

// ---- csrc/device_prims.cuh ----------------------------------------------
constexpr double EMU_STALL_SECONDS = 300;
inline std::atomic<bool> emu_stalled{false};

inline int ld_acquire(const int* p) {
  return std::atomic_ref<int>(*const_cast<int*>(p))
      .load(std::memory_order_acquire);
}

inline void st_release(int* p, int v) {
  std::atomic_ref<int>(*p).store(v, std::memory_order_release);
}

inline int ld_acquire_cta(const int* p) { return ld_acquire(p); }

inline void st_release_cta(int* p, int v) { st_release(p, v); }


inline std::chrono::steady_clock::time_point emu_launch_start;

// A hand-written spin loop's pause: 50 us; false (give up) once the launch
// has run EMU_STALL_SECONDS or another wait stalled.
inline bool spin_on() {
  if (emu_stalled.load()) return false;
  std::this_thread::sleep_for(std::chrono::microseconds(50));
  if (std::chrono::steady_clock::now() - emu_launch_start >
      std::chrono::duration<double>(EMU_STALL_SECONDS)) {
    emu_stalled = true;
    return false;
  }
  return true;
}


// Polls every 100 us: a busy spin would take the cores that the rows it
// waits for need, and a host running other work slows every row alike.
inline void wait_progress(const int* p, int v) {
  auto last = std::chrono::steady_clock::now();
  int seen = ld_acquire(p);
  while (seen < v) {
    if (emu_stalled.load()) return;
    std::this_thread::sleep_for(std::chrono::microseconds(100));
    const int now = ld_acquire(p);
    if (now != seen) {
      seen = now;
      last = std::chrono::steady_clock::now();
    } else if (std::chrono::steady_clock::now() - last >
               std::chrono::duration<double>(EMU_STALL_SECONDS)) {
      emu_stalled = true;
      return;
    }
  }
}

inline void bar_sync(int id, int threads) {
  EmuBarrier* b;
  {
    std::lock_guard<std::mutex> lock(emu_block->named_mutex);
    auto& slot = emu_block->named[id];
    if (!slot) slot = std::make_unique<EmuBarrier>(threads);
    b = slot.get();
  }
  b->arrive_and_wait();
}

inline void bar_arrive(int id, int threads) {
  EmuBarrier* b;
  {
    std::lock_guard<std::mutex> lock(emu_block->named_mutex);
    auto& slot = emu_block->named[id];
    if (!slot) slot = std::make_unique<EmuBarrier>(threads);
    b = slot.get();
  }
  b->arrive();
}

inline int* block_smem() { return emu_block->smem.data(); }


// the dynamic shared memory of a kernel that declares
// `extern __shared__ int smem[]` (one block at a time)
namespace {
alignas(16) int smem[1 << 16];
}

// Run `kernel(args)` as `blocks` blocks of `threads` threads each (a
// multiple of 32), with `smem_words` ints of dynamic shared memory a
// block; every block at once with `concurrent`, else one after another.
// With `start_gap_us` > 0 (concurrent only), block b starts
// (blocks - 1 - b) * start_gap_us after the launch: the last block first.
template <class Kernel, class Args>
void emu_run(Kernel kernel, const Args& args, int blocks, int threads,
             size_t smem_words, bool concurrent, int start_gap_us = 0) {
  blockDim.x = threads;
  std::vector<std::unique_ptr<EmuBlock>> ctx;
  std::vector<std::thread> pool;
  auto start = [&](int b) {
    ctx.push_back(std::make_unique<EmuBlock>(threads, smem_words));
    EmuBlock* blk = ctx.back().get();
    EmuDim3 bi;
    bi.x = b % gridDim.x;
    bi.y = b / gridDim.x % gridDim.y;
    bi.z = b / gridDim.x / gridDim.y;
    const auto delay =
        std::chrono::microseconds((long)(blocks - 1 - b) * start_gap_us);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([t, bi, blk, delay, &kernel, &args] {
        std::this_thread::sleep_for(delay);
        threadIdx.x = t;
        blockIdx = bi;
        emu_block = blk;
        emu_round = 0;
        kernel(args);
      });
  };
  for (int b = 0; b < blocks; ++b) {
    start(b);
    if (!concurrent) {
      for (auto& th : pool) th.join();
      pool.clear();
    }
  }
  for (auto& th : pool) th.join();
}

// Run `kernel(args)` on a grid of gx x gy x gz blocks of `threads`
// threads each, one block after another in raster order.
template <class Kernel, class Args>
void emu_launch_grid(Kernel kernel, const Args& args, int gx, int gy,
                     int threads, int gz = 1) {
  gridDim.x = gx;
  gridDim.y = gy;
  gridDim.z = gz;
  emu_run(kernel, args, gx * gy * gz, threads, 0, false);
}

// Run `kernel(args)` on `blocks` blocks of `threads` threads with
// `smem_words` ints of dynamic shared memory each, all at once (with
// `start_gap_us`, the last block first, each block that long after the
// one behind it).  Returns false when a spin-wait stalled.
template <class Kernel, class Args>
bool emu_launch_cooperative(Kernel kernel, const Args& args, int blocks,
                            int threads, size_t smem_words,
                            int start_gap_us = 0) {
  gridDim.x = blocks;
  gridDim.y = gridDim.z = 1;
  emu_stalled = false;
  emu_launch_start = std::chrono::steady_clock::now();
  emu_run(kernel, args, blocks, threads, smem_words, true, start_gap_us);
  return !emu_stalled;
}
