// Slope-1 wavefront deblock (H.264 8.7) of one picture on PAD-padded
// int32 planes, shared by the whole-GOP decode (d_gop.cu) and the
// standalone frame deblock (deblock.cu).
//
// Schedule (the one of hartallo_tpu_torch/ops/deblock.deblock_filter):
// one block of 1024 threads walks the MB anti-diagonals d = mx + my; per
// diagonal every thread filters whole lines of the V edges of its MB
// (edges in order), __syncthreads, then the H edges, __syncthreads.  MBs
// of one diagonal touch disjoint samples within a phase, and running all
// V edges of a diagonal before all H edges reproduces the spec's per-MB
// raster order.  Per-MB parameters come from `aux` (gh, gw, NAUX) int16,
// the layout of ops/deblock.edge_params and d_pool.pack_fast.
#pragma once

#include <cstdint>

#include "deblock_filters.cuh"

namespace hl {

constexpr int PAD = 32;
constexpr int NAUX = 62;
constexpr int AUX_BS = 30;

__device__ __forceinline__ int tc0_of(const int16_t* a, int it, int bs) {
  return bs <= 0 ? 0 : a[it + (bs >= 3 ? 2 : bs - 1)];
}

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

// Launch with one block of 1024 threads.  Wp / Wcp: row strides of the
// luma and chroma planes (16 gw + 2 PAD, 8 gw + 2 PAD).
static __global__ void k_deblock(const int16_t* __restrict__ aux,
                                 int32_t* py, int32_t* pu, int32_t* pv,
                                 int gw, int gh, int Wp, int Wcp) {
  const int D = gw + gh - 1;
  for (int d = 0; d < D; ++d) {
    const int my_lo = d - (gw - 1) > 0 ? d - (gw - 1) : 0;
    const int my_hi = d < gh - 1 ? d : gh - 1;
    const int items = (my_hi - my_lo + 1) * 32;
    for (int phase = 0; phase < 2; ++phase) {
      const bool vertical = phase == 0;
      for (int t = threadIdx.x; t < items; t += blockDim.x) {
        const int my = my_lo + t / 32, sub = t % 32, mx = d - my;
        const int16_t* a = aux + (size_t)(my * gw + mx) * NAUX;
        if (sub < 16)
          deblock_line(py, Wp, PAD + my * 16, PAD + mx * 16, sub, vertical,
                       true, a);
        else
          deblock_line(sub < 24 ? pu : pv, Wcp, PAD + my * 8, PAD + mx * 8,
                       (sub - 16) & 7, vertical, false, a);
      }
      __syncthreads();
    }
  }
}

}  // namespace hl
