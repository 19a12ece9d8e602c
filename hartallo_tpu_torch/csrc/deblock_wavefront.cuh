// Row-wavefront deblock (H.264 8.7) of one picture on PAD-padded int32
// planes, shared by the whole-GOP decode (d_gop.cu) and the standalone
// frame deblock (deblock.cu).  Per-MB parameters come from `aux`
// (gh, gw, NAUX) int16, the layout of ops/deblock.edge_params and
// d_pool.pack_fast.
//
// What bounds it on the H100: bytes.  The planes are read once and
// written once (720p: 2 x 6.6 MB of int32 planes plus 0.45 MB of aux, about
// 4 us at 3.35 TB/s); the filter arithmetic is a few hundred integer
// operations per line.  What held the first version back was latency: one
// block walked the gw + gh - 1 MB anti-diagonals with two block-wide passes
// each, on one SM, every thread going through global memory at every edge
// (2.9 ms a 720p frame).
//
// Design.
// - One warp per MB row (gh blocks of 32 threads).  Row my walks its MBs
//   left to right, and starts MB (mx, my) once row my - 1 has finished
//   MB min(mx + 1, gw - 1): a progress counter per row in device memory,
//   written with a release store after the MB's samples and read with an
//   acquire load.  The lag of two MBs keeps the spec's raster order: the
//   top edge of (mx, my) reads rows that the left edge of (mx + 1, my - 1)
//   writes (its p samples lie in MB (mx, my - 1)), and no later MB of row
//   my - 1 touches a sample that (mx, my) reads or writes.  Likewise row
//   my + 1 reaches a sample of row my only after the MB that last writes
//   it.  The rows spin on each other, so the launch is cooperative: all gh
//   blocks are resident at once (gh <= 68 on 132 SMs) and the spin cannot
//   deadlock.  The critical path is about gw + 2 gh MB steps of one MB
//   each, instead of gw + gh - 1 diagonals of two block-wide passes.
// - Each MB is filtered in shared memory: its 16x16 luma and two 8x8
//   chroma blocks, with the left and top margins its edges touch (4 luma,
//   2 chroma samples).  The MB's own samples are read one MB ahead, while
//   the warp filters the MB before it (no earlier MB writes them), the
//   left margin is carried over from the previous MB in shared memory, and
//   only the top margin is read after the wait.  Lanes 0-15 filter the 16
//   luma lines, 16-23 the U lines, 24-31 the V lines: every V edge in
//   order, then every H edge, exactly the per-MB order of the spec.  What
//   the edges may change is written back once, and the row's counter is
//   published with a barrier and a release store.  Loads of the planes
//   bypass L1 (__ldcg), since other SMs write them during the launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "deblock_filters.cuh"
#include "device_prims.cuh"

namespace hl {

constexpr int PAD = 32;
constexpr int NAUX = 62;
constexpr int AUX_BS = 30;
// shared tiles: luma rows and columns y0 - 4 .. y0 + 15, chroma
// yc0 - 2 .. yc0 + 7; odd row strides keep the lanes of a V-edge pass on
// distinct banks
constexpr int LS = 21, CS = 11;

__device__ __forceinline__ int tc0_of(const int16_t* a, int it, int bs) {
  return bs <= 0 ? 0 : a[it + (bs >= 3 ? 2 : bs - 1)];
}

// One line (row for a V edge, column for an H edge) of one MB through its
// four luma or two chroma edges, in order, on the tile P whose MB origin is
// (y0, x0).
static __device__ void deblock_line(int32_t* P, int stride, int y0, int x0,
                                    int line, bool vertical, bool luma,
                                    const int16_t* a) {
  // (dy, dx): step along the line's samples; the line sits at `line`
  const int sy = vertical ? 0 : 1, sx = vertical ? 1 : 0;
  const int ly = vertical ? line : 0, lx = vertical ? 0 : line;
  const int bsb = AUX_BS + (vertical ? 0 : 16);
  if (luma) {
    const int seg = line >> 2;
    for (int e = 0; e < 4; ++e) {
      const int ia = e == 0 ? (vertical ? 0 : 2) : 4;
      const int it = e == 0 ? (vertical ? 12 : 15) : 18;
      const int bs = a[bsb + 4 * e + seg];
      int v[8];
      int32_t* base = P + (size_t)(y0 + ly + sy * (4 * e - 4)) * stride +
                      (x0 + lx + sx * (4 * e - 4));
      const size_t step = (size_t)sy * stride + sx;
      for (int k = 0; k < 8; ++k) v[k] = base[k * step];
      filter_luma(v, v + 4, bs, a[ia], a[ia + 1], tc0_of(a, it, bs));
      for (int k = 1; k < 7; ++k) base[k * step] = v[k];
    }
  } else {
    const int seg = line >> 1;
    for (int e = 0; e < 2; ++e) {
      const int ia = e == 0 ? (vertical ? 6 : 8) : 10;
      const int it = e == 0 ? (vertical ? 21 : 24) : 27;
      const int bs = a[bsb + 8 * e + seg];
      int v[4];
      int32_t* base = P + (size_t)(y0 + ly + sy * (4 * e - 2)) * stride +
                      (x0 + lx + sx * (4 * e - 2));
      const size_t step = (size_t)sy * stride + sx;
      for (int k = 0; k < 4; ++k) v[k] = base[k * step];
      filter_chroma(v, v + 2, bs, a[ia], a[ia + 1], tc0_of(a, it, bs));
      base[step] = v[1];
      base[2 * step] = v[2];
    }
  }
}

// gh blocks of 32 threads, launched by launch_deblock.  prog: gh zeroed
// ints, prog[my] = MBs of row my finished.  Wp / Wcp: row strides of the
// luma and chroma planes (16 gw + 2 PAD, 8 gw + 2 PAD).
static __global__ void __launch_bounds__(32)
k_deblock(const int16_t* __restrict__ aux, int32_t* py, int32_t* pu,
          int32_t* pv, int* prog, int gw, int gh, int Wp, int Wcp) {
  __shared__ int32_t L[20 * LS];
  __shared__ int32_t C[2][10 * CS];
  __shared__ int32_t A32[NAUX / 2];
  const int16_t* A = reinterpret_cast<const int16_t*>(A32);
  const int lane = threadIdx.x, my = blockIdx.x;
  const int ly0 = PAD + 16 * my - 4;        // plane row of luma tile row 0
  const int cy0 = PAD + 8 * my - 2;         // plane row of chroma tile row 0
  // lane's chroma margin sample: plane, tile row 2..9 / 0..1, column 0..1
  const int cp = lane >> 4;
  int32_t* const P = cp ? pv : pu;

  // left margin of MB 0: the pad left of the picture
  for (int i = lane; i < 64; i += 32) {
    const int r = 4 + (i >> 2), c = i & 3;
    L[r * LS + c] = __ldcg(py + (size_t)(ly0 + r) * Wp + PAD - 4 + c);
  }
  {
    const int r = 2 + ((lane >> 1) & 7), c = lane & 1;
    C[cp][r * CS + c] = __ldcg(P + (size_t)(cy0 + r) * Wcp + PAD - 2 + c);
  }

  // 1. an MB's own samples and parameters, read one MB ahead: no earlier
  // MB writes them
  int yin[8], cin[4], av;
  auto prefetch = [&](int mx) {
    const int lx0 = PAD + 16 * mx - 4, cx0 = PAD + 8 * mx - 2;
    for (int k = 0; k < 8; ++k) {
      const int i = lane + 32 * k, r = 4 + (i >> 4), c = 4 + (i & 15);
      yin[k] = __ldcg(py + (size_t)(ly0 + r) * Wp + lx0 + c);
    }
    for (int k = 0; k < 4; ++k) {
      const int i = lane + 32 * k, r = 2 + ((i >> 3) & 7), c = 2 + (i & 7);
      cin[k] = __ldcg((i >> 6 ? pv : pu) + (size_t)(cy0 + r) * Wcp + cx0 +
                      c);
    }
    av = lane < NAUX / 2
        ? reinterpret_cast<const int32_t*>(aux + (size_t)(my * gw + mx) *
                                                     NAUX)[lane]
        : 0;
  };
  prefetch(0);

  for (int mx = 0; mx < gw; ++mx) {
    const int lx0 = PAD + 16 * mx - 4, cx0 = PAD + 8 * mx - 2;
    // 2. wait for row my - 1 to finish MB min(mx + 1, gw - 1)
    if (my > 0) {
      if (lane == 0) wait_progress(prog + my - 1, mx + 2 < gw ? mx + 2 : gw);
      __syncwarp();
    }
    // 3. the top margin, which row my - 1 wrote
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k, r = i >> 4, c = 4 + (i & 15);
      L[r * LS + c] = __ldcg(py + (size_t)(ly0 + r) * Wp + lx0 + c);
    }
    {
      const int r = (lane >> 3) & 1, c = 2 + (lane & 7);
      C[cp][r * CS + c] = __ldcg(P + (size_t)(cy0 + r) * Wcp + cx0 + c);
    }
    for (int k = 0; k < 8; ++k) {
      const int i = lane + 32 * k;
      L[(4 + (i >> 4)) * LS + 4 + (i & 15)] = yin[k];
    }
    for (int k = 0; k < 4; ++k) {
      const int i = lane + 32 * k;
      C[i >> 6][(2 + ((i >> 3) & 7)) * CS + 2 + (i & 7)] = cin[k];
    }
    if (lane < NAUX / 2) A32[lane] = av;
    __syncwarp();
    if (mx + 1 < gw) prefetch(mx + 1);
    // 4. every V edge, then every H edge
    for (int ph = 0; ph < 2; ++ph) {
      if (lane < 16)
        deblock_line(L, LS, 4, 4, lane, ph == 0, true, A);
      else
        deblock_line(C[(lane - 16) >> 3], CS, 2, 2, lane & 7, ph == 0, false,
                     A);
      __syncwarp();
    }
    // 5. write back what the edges may change: luma tile rows 1..19 of
    // columns 4..19 and columns 1..3 of rows 4..19; chroma rows 1..9 of
    // columns 2..9 and column 1 of rows 2..9
    for (int i = lane; i < 19 * 16; i += 32) {
      const int r = 1 + (i >> 4), c = 4 + (i & 15);
      py[(size_t)(ly0 + r) * Wp + lx0 + c] = L[r * LS + c];
    }
    for (int i = lane; i < 16 * 3; i += 32) {
      const int r = 4 + i / 3, c = 1 + i % 3;
      py[(size_t)(ly0 + r) * Wp + lx0 + c] = L[r * LS + c];
    }
    for (int i = lane; i < 2 * 9 * 8; i += 32) {
      const int p = i / 72, j = i % 72, r = 1 + (j >> 3), c = 2 + (j & 7);
      (p ? pv : pu)[(size_t)(cy0 + r) * Wcp + cx0 + c] = C[p][r * CS + c];
    }
    if (lane < 16) {
      const int p = lane >> 3, r = 2 + (lane & 7);
      (p ? pv : pu)[(size_t)(cy0 + r) * Wcp + cx0 + 1] = C[p][r * CS + 1];
    }
    // 6. publish the MB to row my + 1: the barrier orders every lane's
    // stores before lane 0's release
    __syncthreads();
    if (lane == 0) st_release(prog + my, mx + 1);
    // 7. the MB's right columns become the next MB's left margin
    for (int i = lane; i < 64; i += 32) {
      const int r = 4 + (i >> 2), c = i & 3;
      L[r * LS + c] = L[r * LS + 16 + c];
    }
    {
      const int r = 2 + ((lane >> 1) & 7), c = lane & 1;
      C[cp][r * CS + c] = C[cp][r * CS + 8 + c];
    }
    __syncwarp();
  }
}

// Deblock one picture in place on `stream`: gh co-resident blocks of one
// warp (a cooperative launch).  prog: gh ints, zeroed by the caller.
static inline cudaError_t launch_deblock(const int16_t* aux, int32_t* py,
                                         int32_t* pu, int32_t* pv, int* prog,
                                         int gw, int gh,
                                         cudaStream_t stream) {
  int Wp = gw * 16 + 2 * PAD, Wcp = gw * 8 + 2 * PAD;
  void* args[] = {(void*)&aux, (void*)&py,  (void*)&pu,
                  (void*)&pv,  (void*)&prog, (void*)&gw,
                  (void*)&gh,  (void*)&Wp,  (void*)&Wcp};
  return cudaLaunchCooperativeKernel((const void*)k_deblock, dim3(gh),
                                     dim3(32), args, 0, stream);
}

}  // namespace hl
