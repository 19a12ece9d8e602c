// The integer transform and quantiser steps of one 4x4 block shared by the
// encoder kernels (intra_encode.cu, p_encode.cu): the forward core
// transform, the 2x2 chroma DC Hadamard, one stage of the inverse core
// transform, the quantiser and the flat-list dequantiser, each the
// arithmetic of its ops/transform.py counterpart.  Integer only; right
// shifts of negative ints floor, as torch's >> does.
// tests/cuda_emulation.h compiles them for the CPU as they are.
#pragma once

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// row u, column i of the forward core transform's matrix
// (1,1,1,1) (2,1,-1,-2) (1,-1,-1,1) (1,-2,2,-1)
__device__ __forceinline__ int fwd_coef(int u, int i) {
  if (u == 0) return 1;
  if (u == 2) return (i == 0 || i == 3) ? 1 : -1;
  if (u == 1) return i == 0 ? 2 : i == 1 ? 1 : i == 2 ? -1 : -2;
  return i == 0 ? 1 : i == 1 ? -2 : i == 2 ? 2 : -1;
}

// element (u, v) of C X C^T for the 4x4 block at x (row stride `stride`)
// (ops/transform.forward_dct_4x4: integer, so any order of the sums)
__device__ __forceinline__ int fdct(const int* x, int stride, int u, int v) {
  int acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int t = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) t += fwd_coef(u, i) * x[i * stride + j];
    acc += fwd_coef(v, j) * t;
  }
  return acc;
}

// element (r, s) of the 2x2 Hadamard of the matrix at x
// (ops/transform._hadamard_2x2)
__device__ __forceinline__ int hadamard2(const int* x, int r, int s) {
  const int a = x[0] + (r ? -x[2] : x[2]);
  const int b = x[1] + (r ? -x[3] : x[3]);
  return s ? a - b : a + b;
}

// element k of one 1-D stage of the inverse core transform (8.5.12.2)
__device__ __forceinline__ int ict(int d0, int d1, int d2, int d3, int k) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  return k == 0 ? e0 + e3 : k == 1 ? e1 + e2 : k == 2 ? e1 - e2 : e0 - e3;
}

// sign(w) * ((|w| * mf + f) >> qbits) (ops/transform.forward_quant_4x4)
__device__ __forceinline__ int quant(int w, int mf, int f, int qbits) {
  const int z = ((w < 0 ? -w : w) * mf + f) >> qbits;
  return w < 0 ? -z : (w > 0 ? z : 0);
}

// 8.5.12.1 flat-list dequant of level c; ls = 16 * QUANT_V entry
__device__ __forceinline__ int dequant(int c, int ls, int qp) {
  const int qdiv = qp / 6;
  return qp >= 24 ? c * ls * (1 << (qdiv - 4))
                  : (c * ls + (1 << (3 - qdiv))) >> (4 - qdiv);
}
