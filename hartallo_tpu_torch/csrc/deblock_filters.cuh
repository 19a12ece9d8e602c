// Deblocking edge filters (H.264 8.7.2.3 bS < 4 and 8.7.2.4 bS == 4) for
// one line of samples crossing one edge.
//
// Device ports of _filter_luma / _filter_chroma in
// hartallo_tpu/ops/deblock_pallas.py (the same math as
// hartallo_tpu/ops/deblock.py:_filter_luma_line / _filter_chroma_line and
// their torch ports in hartallo_tpu_torch/ops/deblock.py).  Samples are
// int, 0..255.  Left shifts of possibly negative values are written as
// multiplications (a left shift of a negative int is undefined in C++17);
// right shifts of negative ints are arithmetic (floor), as in the
// reference's `>>`.
#pragma once

namespace hl {

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// p[0..3] = p3, p2, p1, p0; q[0..3] = q0, q1, q2, q3.  Writes the new
// p2, p1, p0 into p[1..3] and q0, q1, q2 into q[0..2].
__device__ __forceinline__ void filter_luma(int* p, int* q, int bs,
                                            int alpha, int beta, int tc0) {
  const int p3 = p[0], p2 = p[1], p1 = p[2], p0 = p[3];
  const int q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  const bool fs = bs > 0 && iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
                  iabs(q1 - q0) < beta;
  if (!fs) return;
  const bool ap = iabs(p2 - p0) < beta;
  const bool aq = iabs(q2 - q0) < beta;
  if (bs == 4) {
    const bool gap = iabs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap && gap) {
      p[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      p[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      p[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      p[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && gap) {
      q[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      q[1] = (q2 + q1 + q0 + p0 + 2) >> 2;
      q[2] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      q[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  p[3] = clip3(0, 255, p0 + delta);
  q[0] = clip3(0, 255, q0 - delta);
  if (ap) p[2] = p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1);
  if (aq) q[1] = q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1);
}

// p[0..1] = p1, p0; q[0..1] = q0, q1.  Writes the new p0 into p[1] and
// q0 into q[0].
__device__ __forceinline__ void filter_chroma(int* p, int* q, int bs,
                                              int alpha, int beta, int tc0) {
  const int p1 = p[0], p0 = p[1], q0 = q[0], q1 = q[1];
  const bool fs = bs > 0 && iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
                  iabs(q1 - q0) < beta;
  if (!fs) return;
  if (bs == 4) {
    p[1] = (2 * p1 + p0 + q1 + 2) >> 2;
    q[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    return;
  }
  const int tc = tc0 + 1;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  p[1] = clip3(0, 255, p0 + delta);
  q[0] = clip3(0, 255, q0 - delta);
}

}  // namespace hl
