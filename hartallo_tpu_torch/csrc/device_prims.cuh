// The device primitives of the row-wavefront kernels
// (deblock_wavefront.cuh, intra_encode.cu, intra_decode.cu) that plain
// C++ does not spell: acquire loads and release stores of the per-row
// progress counters (device scope) and of a block's own counters in
// shared memory (block scope), the spin-wait on them, a barrier of some of
// a block's warps and its arrive-only half, and the block's dynamic shared
// memory.
// tests/cuda_emulation.h defines CPU versions of the same names, so the
// intra kernels' code runs on the CPU with every block of its grid at
// once.
#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The same at block scope, on a generic address (shared memory).
static __device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Spin until the counter at p reaches v (an acquire load each round).
static __device__ __forceinline__ void wait_progress(const int* p, int v) {
  while (ld_acquire(p) < v) {
  }
}

// One more round of a spin loop that polls by hand: true on the card (the
// emulation pauses here, and gives up on a stall).
static __device__ __forceinline__ bool spin_on() { return true; }

// Barrier `id` (1..15; 0 is __syncthreads') of `threads` threads, whole
// warps, of the block.
static __device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// Arrive at barrier `id` without waiting: a producer's half of bar_sync.
static __device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

static __device__ __forceinline__ int* block_smem() {
  extern __shared__ int block_smem_words[];
  return block_smem_words;
}
