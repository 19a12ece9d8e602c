// The half-pel grids of spec 8.4.2.2.1 at one sample, shared by the GOP
// decode kernel's ring update (d_gop.cu, k_halfpel) and the encoder's
// half-pel stack (p_encode.cu, k_halfpel_enc): G, and the unrounded
// 6-tap sums H1 (horizontal, b), V1 (vertical, h) and J1 (vertical over
// H1, j) of ops/wide.halfpel_planes, each tap reading an int32 plane with
// its coordinates clamped to a box.  The decoder's box is the picture
// inside its work plane's pad (the pad is not filled there); the
// encoder's is its edge-padded plane itself, which is what
// _edge_pad(..., 2, 3) reads.  Integer only.
#pragma once

#include <cstdint>

struct ClampedPlane {
  const int32_t* p;
  int stride;          // row stride, in samples
  int y0, y1, x0, x1;  // the box that coordinates are clamped to
};

__device__ __forceinline__ int hp_tap(int i) {
  return (i == 0 || i == 5) ? 1 : (i == 1 || i == 4) ? -5 : 20;
}

__device__ __forceinline__ int hp_at(const ClampedPlane& g, int y, int x) {
  y = y < g.y0 ? g.y0 : (y > g.y1 ? g.y1 : y);
  x = x < g.x0 ? g.x0 : (x > g.x1 ? g.x1 : x);
  return g.p[(size_t)y * g.stride + x];
}

// unrounded horizontal 6-tap around (y, x): b's sum
__device__ __forceinline__ int hp_h1(const ClampedPlane& g, int y, int x) {
  int acc = 0;
  for (int i = 0; i < 6; ++i) acc += hp_tap(i) * hp_at(g, y, x - 2 + i);
  return acc;
}

// unrounded vertical 6-tap around (y, x): h's sum
__device__ __forceinline__ int hp_v1(const ClampedPlane& g, int y, int x) {
  int acc = 0;
  for (int j = 0; j < 6; ++j) acc += hp_tap(j) * hp_at(g, y - 2 + j, x);
  return acc;
}

// vertical 6-tap over the horizontal sums: j's sum
__device__ __forceinline__ int hp_j1(const ClampedPlane& g, int y, int x) {
  int acc = 0;
  for (int j = 0; j < 6; ++j) acc += hp_tap(j) * hp_h1(g, y - 2 + j, x);
  return acc;
}

__device__ __forceinline__ int hp_round5(int v) {
  v = (v + 16) >> 5;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int hp_round10(int v) {
  v = (v + 512) >> 10;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}
