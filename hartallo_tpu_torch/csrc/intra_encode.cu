// Intra mode decision, transform, quantisation and reconstruction of one
// picture for Hopper (sm_90a): the encoder's intra wavefront.
//
// Replaces hartallo_tpu/encode/intra_encode.py:intra_encode_frame, the XLA
// wavefront inside e_device.i_frame_fused (IDR pictures) and p_gop_fused
// (P pictures with intra MBs).  Its plain twin is
// hartallo_tpu_torch/encode/intra_encode.py:intra_encode_frame, which this
// kernel matches bit for bit; the wrapper is
// hartallo_tpu_torch/encode/intra_encode_fast.py.
//
// Computes, for every MB: the SADs of the four Intra16x16 predictions with
// a 1e18 penalty on the modes whose neighbours are missing, the argmin,
// and the Intra16x16 residual (forward core transform, luma DC Hadamard,
// quantisation, dequantisation, inverse transform, clamp); the 16
// Intra4x4 blocks in blkIdx order, each choosing among 9 predictions by
// SAD + penalties + 4 lambda (3 lambda less for DC) and writing its recon
// back before the next block predicts from it; I16 against I4 by
// i16_cost + 6 lambda < i4_cost; the four chroma modes by the SAD of U and
// V, and the chroma DC/AC residual.  With a mask (intra-in-P) the
// decisions and levels are computed for every MB, and a masked-out MB's
// recon is its base recon.
//
// What bounds it on the H100: bytes, about 2.7 KB an MB (the source, the
// recon and 427 int32 words of levels and modes) or 0.6 us a CIF picture
// at 3.35 TB/s.  What the kernel takes is the chain of dependent MBs: an
// MB reads the recon of its left, top, top-left and top-right neighbours,
// so a picture is at least gw + 2 gh - 2 MB latencies long, and an MB's
// latency is its chained Intra4x4 blocks.
//
// Design.
// - MB rows across the SMs.  One block per MB row (gh blocks of 128
//   threads, a cooperative launch, so that all rows are resident at once
//   and their spin-waits cannot deadlock).  Row my walks its MBs left to
//   right and starts MB (mx, my) once row my - 1 has published MB
//   min(mx + 1, gw - 1): a progress counter per row in device memory,
//   read with an acquire load by thread 0 and written, after a block
//   barrier that orders the MB's bottom row stores, with a release store;
//   the MB's other outputs, which no other row reads, are written after
//   it.  The rows above are read after the wait and bypass L1 (__ldcg),
//   since other SMs write them during the launch; the row's own left
//   neighbour is carried over in shared memory, and its source is loaded
//   into registers one MB ahead.
// - Four warps share an MB.  Warps 0 and 1 run the Intra4x4 blocks as the
//   ten slope-2 steps of the MB's own 4x4 wavefront (block (bc, br) at
//   step bc + 2 br, at most two a step, one a warp, a barrier of the two
//   warps between steps), and sum i4_cost from 0 in blkIdx order after
//   the last; warp 2 runs the Intra16x16 decision and residual into a
//   tile of its own, warp 3 the chroma decision and residual (both read
//   only the neighbours' recon, final once the wait returns).  A block
//   barrier joins them; then i16_cost + 6 lambda < i4_cost picks the luma
//   recon and levels that every thread writes out.
// - An Intra4x4 block in one warp, one shared-memory round trip.  Every
//   sample of the eight directional predictions is one of 31 values of
//   the block's 13-sample edge vector s = [l3, l2, l1, l0, tl, t0..t7]
//   (the samples themselves, its 2-tap and 3-tap filters, two corner
//   cases: entry_taps); lane k forms value k from the tile, and lane
//   (g, r) = (lane / 4, lane % 4) gathers with shuffles the four samples
//   of row r of mode g (0, 1, 3..8; entry4 fixes the indices once per
//   launch) and sums its SAD and the DC mode's in one packed word.  Each
//   group carries its row of its own mode's residual through the forward
//   transform, quantisation, dequantisation and inverse transform in
//   registers (columns by butterfly shuffles within the group, with
//   per-lane coefficients, not branches) while the argmin runs: one
//   __reduce_min_sync of order-preserving cost keys and a ballot.  When
//   DC wins, every group codes DC's residual after it; the winning group
//   writes the recon rows to the tile.
// - A block of shared memory holds the quantiser tables, the source, a
//   17x25 luma tile (row 0 the top-left, top and top-right samples,
//   column 0 the left column, the body the Intra4x4 recon), the chroma
//   source and neighbours, the Intra16x16 recon and both sets of levels,
//   and the warps' scratch (10.4 KB).
//
// The forward transform, quantiser, dequantiser and inverse transform
// steps are shared with p_encode.cu (transform_prims.cuh).
//
// Rounding.  The costs are the only floating-point values.  nvcc contracts
// a*b + c into an FMA by default, and the twin rounds every operation, so
// each cost is spelt with __fadd_rn / __fmul_rn in the twin's order:
// ((sad + pen) + lam*4) [+ (-(lam*3)) for mode 2], pen = (top + left) +
// corner; i4_cost sums the chosen costs from 0 in blkIdx order;
// i16_cost + lam*6 < i4_cost.  Argmins take the first minimum, as
// torch.argmin does.  Everything else is int32 with flooring >> and no
// / or % of a negative value.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_prims.cuh"
#include "transform_prims.cuh"

namespace {

constexpr int PAD = 32;
// the block: two Intra4x4 warps, an Intra16x16 warp and a chroma warp
constexpr int THREADS = 128;
constexpr float BIG = 1e18f;
constexpr unsigned FULL = 0xffffffffu;

// the wrapper's table (intra_encode_fast._tables), int32 words: QUANT_MF
// (6,4,4), QUANT_V (6,4,4), QUANT_QBITS (52), the intra row of QUANT_F (52)
// and QP_SCALE_CHROMA (52) of core/tables.py
constexpr int T_MF = 0, T_V = 96, T_QBITS = 192, T_F = 244, T_QPC = 296,
              T_WORDS = 348;

// the block's shared memory, int32 words
constexpr int TW = 25;                  // row stride of the luma tile
constexpr int S_TAB = 0;
constexpr int S_SRC = S_TAB + T_WORDS;  // luma source, 16x16 raster
constexpr int S_TILE = S_SRC + 256;     // 17 x TW: row 0 the top-left
                                        // corner, top row and top-right
                                        // MB's 8 samples, column 0 the
                                        // left column, the body the
                                        // Intra4x4 recon
constexpr int S_CSRC = S_TILE + 17 * TW;  // chroma source [c][8][8]
constexpr int S_CN = S_CSRC + 128;      // chroma neighbours [c][tl, t0..7,
                                        // l0..7]
constexpr int S_R16 = S_CN + 34;        // Intra16x16 recon, 16x16 raster
constexpr int S_L16 = S_R16 + 256;      // Intra16x16 AC levels, (16 blkIdx,
                                        // 4, 4)
constexpr int S_DC16 = S_L16 + 256;     // Intra16x16 DC levels, raster
constexpr int S_L4 = S_DC16 + 16;       // Intra4x4 levels, (16 blkIdx, 4, 4)
constexpr int S_X16 = S_L4 + 256;       // warp 2's scratch
constexpr int S_XC = S_X16 + 304;       // warp 3's scratch
constexpr int S_LC = S_XC + 152;        // chroma coefficients
constexpr int S_LEFT = S_LC + 128;      // the left MB's right column: luma
                                        // 16, then U 8 and V 8
constexpr int S_BEST = S_LEFT + 32;     // the Intra4x4 blocks' costs
constexpr int S_SCAL = S_BEST + 16;     // i4_cost, i16_cost, i16_mode
constexpr int SMEM_WORDS = S_SCAL + 4;
constexpr int SMEM_BYTES = SMEM_WORDS * 4;

// Intra4x4 modes reading the top, left and corner samples (8.3.1.2), as
// bit masks over the mode number (the twin's _NEED_TOP / _NEED_LEFT /
// _NEED_TL)
constexpr int NEED_TOP = 0xF9, NEED_LEFT = 0x172, NEED_TL = 0x70;

struct Args {
  const int32_t *sy, *su, *sv;  // PAD-padded source planes
  const int32_t *by, *bu, *bv;  // PAD-padded base recon, or null (zero)
  const int32_t* qp;            // (gh, gw)
  const uint8_t *al, *at;       // (gh, gw) bool
  const uint8_t *atr, *atl, *mask;  // (gh, gw) bool, or null (all true)
  const int32_t* tab;
  const float* lam;             // one value
  int32_t *ry, *ru, *rv;        // PAD-padded recon, zeroed by the caller
  int32_t *use16, *i16m, *i4m, *cm, *ldc, *lac, *cdc, *cac;
  int* prog;                    // gh zeroed counters: MBs of a row done
  int gw, gh, cqo;
};

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(FULL, (unsigned)v);
}

// blkIdx -> the block's pixel offsets in its MB, and its raster position
__device__ __forceinline__ int blk_x(int b) {
  return 8 * ((b >> 2) & 1) + 4 * (b & 1);
}
__device__ __forceinline__ int blk_y(int b) {
  return 8 * (b >> 3) + 4 * ((b >> 1) & 1);
}
__device__ __forceinline__ int blk_raster(int b) {
  return (blk_y(b) >> 2) * 4 + (blk_x(b) >> 2);
}

// ops/intra._dc: the average of the available edges, 128 with neither
__device__ __forceinline__ int dc_rule(bool at, bool al, int ts, int ls,
                                       int both_sh, int one_sh) {
  if (at && al) return (ts + ls + (1 << (both_sh - 1))) >> both_sh;
  if (al) return (ls + (1 << (one_sh - 1))) >> one_sh;
  if (at) return (ts + (1 << (one_sh - 1))) >> one_sh;
  return 128;
}

// row u, column i of the 4x4 Hadamard matrix
// (1,1,1,1) (1,1,-1,-1) (1,-1,-1,1) (1,-1,1,-1)
__device__ __forceinline__ int had_coef(int u, int i) {
  if (u == 0) return 1;
  if (u == 1) return i < 2 ? 1 : -1;
  if (u == 2) return (i == 0 || i == 3) ? 1 : -1;
  return (i == 0 || i == 2) ? 1 : -1;
}

// element (u, v) of H X H for the 4x4 matrix at x (ops/transform
// ._hadamard_4x4)
__device__ __forceinline__ int hadamard4(const int* x, int u, int v) {
  int acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc += had_coef(u, i) * had_coef(v, j) * x[i * 4 + j];
  return acc;
}

// A float as an unsigned key of the same order (no NaN reaches it)
__device__ __forceinline__ unsigned cost_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_cost(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ---- the Intra4x4 predictions as 31 values of the edge vector -----------
// s = [l3, l2, l1, l0, tl, t0..t7]; value k is
// (s[i0] + w1 s[i1] + w2 s[i2] + rnd) >> sh:
//   0-7    s[i], i = 0 1 2 3 5 6 7 8 (the left and top samples)
//   8-17   (s[k] + s[k+1] + 1) >> 1, k = 0..9
//   18-28  (s[c-1] + 2 s[c] + s[c+1] + 2) >> 2, c = 1..11
//   29     (t6 + 3 t7 + 2) >> 2 (diagonal down-left at x = y = 3)
//   30     (l2 + 3 l3 + 2) >> 2 (horizontal up at x + 2y = 5)
struct Taps {
  int i0, i1, i2, w1, w2, sh;
};

__device__ Taps entry_taps(int k) {
  if (k < 8) {
    const int i = k < 4 ? k : k + 1;
    return {i, i, i, 0, 0, 0};
  }
  if (k < 18) return {k - 8, k - 7, k - 7, 1, 0, 1};
  if (k < 29) return {k - 18, k - 17, k - 16, 2, 1, 2};
  if (k == 29) return {11, 12, 12, 3, 0, 2};
  if (k == 30) return {1, 0, 0, 3, 0, 2};
  return {0, 0, 0, 0, 0, 0};
}

__device__ __forceinline__ int raw_e(int i) { return i < 4 ? i : i - 1; }
__device__ __forceinline__ int f2_e(int k) { return 8 + k; }
__device__ __forceinline__ int f3_e(int c) { return 17 + c; }

// The value that sample (x, y) of Intra4x4 mode `mode` (not 2) takes
// (8.3.1.2.1-9, ops/intra._mode_tables)
__device__ int entry4(int mode, int x, int y) {
  switch (mode) {
    case 0:  // vertical: t[x]
      return raw_e(5 + x);
    case 1:  // horizontal: l[y]
      return raw_e(3 - y);
    case 3:  // diagonal down-left
      return x == 3 && y == 3 ? 29 : f3_e(6 + x + y);
    case 4:  // diagonal down-right
      return f3_e(4 + x - y);
    case 5: {  // vertical right
      const int z = 2 * x - y, j = x - (y >> 1);
      if (z >= 0) return (z & 1) ? f3_e(4 + j) : f2_e(4 + j);
      return z == -1 ? f3_e(4) : f3_e(5 - y);
    }
    case 6: {  // horizontal down
      const int z = 2 * y - x, j = y - (x >> 1);
      if (z >= 0) return (z & 1) ? f3_e(4 - j) : f2_e(3 - j);
      return z == -1 ? f3_e(4) : f3_e(3 + x);
    }
    case 7: {  // vertical left
      const int j = x + (y >> 1);
      return (y & 1) ? f3_e(6 + j) : f2_e(5 + j);
    }
    default: {  // 8, horizontal up
      const int z = x + 2 * y, j = y + (x >> 1);
      if (z > 5) return raw_e(0);
      if (z == 5) return 30;
      return (z & 1) ? f3_e(2 - j) : f2_e(2 - j);
    }
  }
}

// offset in the tile of edge sample i from the block's top-left corner
// sample; the top-right four become t3 where the block never has them
__device__ __forceinline__ int edge_off(int i) {
  return i <= 4 ? (4 - i) * TW : i - 4;
}
__device__ __forceinline__ int edge_offs(int i) {
  return edge_off(i) | (edge_off(i >= 9 ? 8 : i) << 16);
}

// ---- the luma 16x16 and chroma predictions -------------------------------
struct Pred16 {
  const int* tile;
  int dc, pa, pb, pc;
  __device__ __forceinline__ int operator()(int mode, int y, int x) const {
    if (mode == 0) return tile[1 + x];
    if (mode == 1) return tile[(1 + y) * TW];
    if (mode == 2) return dc;
    return clip255((pa + pb * (x - 7) + pc * (y - 7) + 16) >> 5);
  }
};

struct PredC {  // one chroma component; n = [tl, t0..t7, l0..l7]
  const int* n;
  int v00, v10, v01, v11, pa, pb, pc;
  __device__ __forceinline__ int operator()(int mode, int y, int x) const {
    if (mode == 0)
      return y < 4 ? (x < 4 ? v00 : v10) : (x < 4 ? v01 : v11);
    if (mode == 1) return n[9 + y];
    if (mode == 2) return n[1 + x];
    return clip255((pa + pb * (x - 3) + pc * (y - 3) + 16) >> 5);
  }
};

__device__ PredC chroma_pred(const int* n, bool at, bool al) {
  PredC P;
  P.n = n;
  const int ts0 = n[1] + n[2] + n[3] + n[4], ts1 = n[5] + n[6] + n[7] + n[8];
  const int ls0 = n[9] + n[10] + n[11] + n[12];
  const int ls1 = n[13] + n[14] + n[15] + n[16];
  P.v00 = dc_rule(at, al, ts0, ls0, 3, 2);
  P.v11 = dc_rule(at, al, ts1, ls1, 3, 2);
  P.v10 = at ? (ts1 + 2) >> 2 : (al ? (ls0 + 2) >> 2 : 128);
  P.v01 = al ? (ls1 + 2) >> 2 : (at ? (ts0 + 2) >> 2 : 128);
  int Hs = 0, Vs = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Hs += (k + 1) * (n[1 + 4 + k] - (k == 3 ? n[0] : n[1 + 2 - k]));
    Vs += (k + 1) * (n[9 + 4 + k] - (k == 3 ? n[0] : n[9 + 2 - k]));
  }
  P.pa = 16 * (n[9 + 7] + n[1 + 7]);
  P.pb = (17 * Hs + 16) >> 5;
  P.pc = (17 * Vs + 16) >> 5;
  return P;
}

// What an MB's four warps share: its position and parameters.
struct Mb {
  int m, mx, y0, x0, yc0, xc0, qp, qpc;
  bool al, at, atr, atl, intra;
};

// Lane (g, r)'s constants of the Intra4x4 chain, fixed for the launch.
struct I4Lane {
  int offs0, offs1, offs2;  // edge_offs of value `lane`'s three taps
  int w1, w2, rnd, sh;
  int idx;                  // the values of row r of mode g, 8 bits each
  bool nt, nl, ntl;         // g's mode reads the top, left, top-left
};

__device__ I4Lane i4_lane(int lane) {
  I4Lane c;
  const Taps t = entry_taps(lane);
  c.offs0 = edge_offs(t.i0);
  c.offs1 = edge_offs(t.i1);
  c.offs2 = edge_offs(t.i2);
  c.w1 = t.w1;
  c.w2 = t.w2;
  c.rnd = t.sh ? 1 << (t.sh - 1) : 0;
  c.sh = t.sh;
  const int g = lane >> 2, r = lane & 3, mode = g < 2 ? g : g + 1;
  c.idx = 0;
  for (int x = 0; x < 4; ++x) c.idx |= entry4(mode, x, r) << (8 * x);
  c.nt = NEED_TOP >> mode & 1;
  c.nl = NEED_LEFT >> mode & 1;
  c.ntl = NEED_TL >> mode & 1;
  return c;
}

// ---- warps 0 and 1: the 16 Intra4x4 blocks ---------------------------------
// Lane (g, r)'s constants of one MB: the quantiser of coefficient row
// u(r), and the butterflies' coefficients of row r, so that the
// transforms take no branch on r (a branch around each shuffle would
// serialise them).
struct I4Mb {
  int mf[4], ls[4], fq, qbits, qp;
  int s1, a2, b2, sha, aa, ba;
};

__device__ __forceinline__ I4Mb i4_mb(const int* tab, int qp, int r) {
  I4Mb q;
  const int u = ((r & 1) << 1) | (r >> 1), q6 = (qp % 6) * 16;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    q.mf[v] = tab[T_MF + q6 + u * 4 + v];
    q.ls[v] = 16 * tab[T_V + q6 + u * 4 + v];
  }
  q.fq = tab[T_F + qp];
  q.qbits = tab[T_QBITS + qp];
  q.qp = qp;
  q.s1 = r < 2 ? 1 : -1;
  q.a2 = r == 1 ? -1 : 1;
  q.b2 = r < 2 ? 1 : (r == 2 ? 2 : -2);
  q.sha = r >> 1;
  q.aa = r == 1 ? -1 : 1;
  q.ba = r == 2 ? -1 : 1;
  return q;
}

// Row r of a block's residual src - pred through the forward transform
// (the row here, the column by two butterfly shuffles within the group of
// four lanes), quantisation, dequantisation and the inverse transform
// (likewise).  z: the levels of coefficient row u(r) = 0, 2, 1, 3 for
// r = 0..3; rec: recon row r.
__device__ __forceinline__ void code_row(const int* src, const int* pred,
                                         const I4Mb& q, int* z, int* rec) {
  int w[4];
  {
    const int x0 = src[0] - pred[0], x1 = src[1] - pred[1];
    const int x2 = src[2] - pred[2], x3 = src[3] - pred[3];
    const int s03 = x0 + x3, d03 = x0 - x3, s12 = x1 + x2, d12 = x1 - x2;
    w[0] = s03 + s12;
    w[1] = 2 * d03 + d12;
    w[2] = s03 - s12;
    w[3] = d03 - 2 * d12;
  }
  // the column: S03 S12 D12 D03, then coefficient rows 0 2 1 3
  int p[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) p[v] = __shfl_xor_sync(FULL, w[v], 3);
#pragma unroll
  for (int v = 0; v < 4; ++v) w[v] = p[v] + q.s1 * w[v];
#pragma unroll
  for (int v = 0; v < 4; ++v) p[v] = __shfl_xor_sync(FULL, w[v], 1);
  int d[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    z[v] = quant(q.a2 * w[v] + q.b2 * p[v], q.mf[v], q.fq, q.qbits);
    d[v] = dequant(z[v], q.ls[v], q.qp);
  }
  // the inverse: the row here, then the column: e0 e1 e2 e3, then rows
  // 0 1 2 3
  int h[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) h[x] = ict(d[0], d[1], d[2], d[3], x);
#pragma unroll
  for (int x = 0; x < 4; ++x) p[x] = __shfl_xor_sync(FULL, h[x], 1);
#pragma unroll
  for (int x = 0; x < 4; ++x) h[x] = q.aa * (h[x] >> q.sha) + q.ba * p[x];
#pragma unroll
  for (int x = 0; x < 4; ++x) p[x] = __shfl_xor_sync(FULL, h[x], 3);
#pragma unroll
  for (int x = 0; x < 4; ++x)
    rec[x] = clip255(pred[x] + ((p[x] + q.s1 * h[x] + 32) >> 6));
}

// Intra4x4 block `blk` by the 32 lanes of a warp: the mode decision, the
// recon rows into the tile T, the levels into L4 and the mode into i4m.
// Returns the chosen cost.
__device__ __forceinline__ float intra4_block(
    const Args& a, const Mb& b, const I4Lane& c, const I4Mb& q,
    const int* S, int* T, int* L4, int blk, int lane, float lam4,
    float nlam3) {
  const int g = lane >> 2, r = lane & 3;
  const int u = ((r & 1) << 1) | (r >> 1);  // the coefficient row r holds
  const int bx = blk_x(blk), by = blk_y(blk);
  // the block's flags without branches: the top-right samples never
  // available (blocks 3 7 11 13 15, and 5 at the right picture edge or
  // without the top-right MB), the top, left and top-left samples
  const bool sub = ((0xA888 >> blk) & 1) |
                   ((blk == 5) & ((b.mx == a.gw - 1) | !b.atr));
  const bool bat = b.at | (by != 0), bal = b.al | (bx != 0);
  const bool batl = (bx | by) ? bat & bal : b.atl;
  // value `lane` of the edge vector, the DC prediction, the source row
  const int* base = T + by * TW + bx;
  const int sel = sub ? 16 : 0;
  const int ent = (base[(c.offs0 >> sel) & 0xffff] +
                   c.w1 * base[(c.offs1 >> sel) & 0xffff] +
                   c.w2 * base[(c.offs2 >> sel) & 0xffff] + c.rnd) >> c.sh;
  int dc;
  {  // dc_rule(bat, bal, ts, ls, 3, 2) as selects
    const int ts = base[1] + base[2] + base[3] + base[4];
    const int ls = base[TW] + base[2 * TW] + base[3 * TW] + base[4 * TW];
    dc = bat ? (ts + 2) >> 2 : 128;
    dc = bal ? (ls + 2) >> 2 : dc;
    dc = bat & bal ? (ts + ls + 4) >> 3 : dc;
  }
  int src[4], pred[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    src[x] = S[(by + r) * 16 + bx + x];
    pred[x] = __shfl_sync(FULL, ent, (c.idx >> (8 * x)) & 0xff);
  }
  // the group's own mode coded ahead of the decision, which it does not
  // need
  int z[4], rec[4];
  code_row(src, pred, q, z, rec);
  // row r's SAD of mode g (low half) and of DC (high half), then the
  // group's: at most 16 x 255 each (8-bit samples)
  int sad = 0;
#pragma unroll
  for (int x = 0; x < 4; ++x)
    sad += abs(pred[x] - src[x]) + (abs(dc - src[x]) << 16);
  sad += __shfl_xor_sync(FULL, sad, 1);
  sad += __shfl_xor_sync(FULL, sad, 2);
  const float pen = __fadd_rn(
      __fadd_rn(c.nt && !bat ? BIG : 0.f, c.nl && !bal ? BIG : 0.f),
      c.ntl && !batl ? BIG : 0.f);
  const float cg = __fadd_rn(__fadd_rn((float)(sad & 0xffff), pen), lam4);
  // DC reads no neighbour it may lack: its penalty is 0, and adding +0 to
  // the SAD changes nothing
  const float cd = __fadd_rn(__fadd_rn((float)(sad >> 16), lam4), nlam3);
  // the first minimum in mode order 0, 1, 2 (DC), 3..8
  const unsigned kg = cost_key(cg), kd = cost_key(cd);
  const unsigned kmin = __reduce_min_sync(FULL, kg);
  const int low = (__ffs(__ballot_sync(FULL, kg == kmin)) - 1) >> 2;
  const bool dcw = kd < kmin || (kd == kmin && low >= 2);
  if (dcw) {  // the same in every lane
    const int flat[4] = {dc, dc, dc, dc};
    code_row(src, flat, q, z, rec);
  }
  if (g == (dcw ? 0 : low)) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      T[(by + 1 + r) * TW + 1 + bx + x] = rec[x];
      L4[blk * 16 + u * 4 + x] = z[x];
    }
  }
  if (lane == 0) a.i4m[b.m * 16 + blk] = dcw ? 2 : (low < 2 ? low : low + 1);
  return dcw ? cd : key_cost(kmin);
}

// Warps 0 and 1 (w): the 16 blocks as the ten slope-2 steps of the MB's
// own 4x4 wavefront, block (bc, br) at step bc + 2 br: it reads its left,
// top, top-left and top-right neighbours (steps - 1, - 2, - 3, - 1).  A
// step holds one or two blocks, the one with the larger bc for warp 0; a
// barrier of the two warps ends each step.  best: the 16 chosen costs,
// summed from 0 in blkIdx order into i4_cost.
__device__ __forceinline__ void intra4_chain(
    const Args& a, const int* tab, const Mb& b, const I4Lane& c,
    const int* S, int* T, int* L4, float* best, float* i4_cost, int w,
    int lane, float lam4, float nlam3) {
  const I4Mb q = i4_mb(tab, b.qp, lane & 3);
  for (int s = 0; s < 10; ++s) {
    const int br = (s < 3 ? 0 : (s - 2) >> 1) + w, bc = s - 2 * br;
    if (br <= 3 && bc >= 0) {
      const int blk = 8 * (br >> 1) + 2 * (br & 1) + 4 * (bc >> 1) + (bc & 1);
      const float cost = intra4_block(a, b, c, q, S, T, L4, blk, lane, lam4,
                                      nlam3);
      if (lane == 0) best[blk] = cost;
    }
    bar_sync(1, 64);
  }
  if (w == 0 && lane == 0) {
    float i4c = 0.f;
    for (int blk = 0; blk < 16; ++blk) i4c = __fadd_rn(i4c, best[blk]);
    *i4_cost = i4c;
  }
}

// ---- warp 2: the Intra16x16 decision, residual and recon -----------------
// Into R16 (the recon), L16 / DC16 (the levels) and the two scalars;
// X: 304 words of scratch.
__device__ void intra16(const int* tab, const Mb& b, const int* S,
                        const int* T, int* X, int* R16, int* L16, int* DC16,
                        float* i16_cost, int* i16_mode, int lane) {
  const int qp = b.qp, q6 = (qp % 6) * 16;
  Pred16 p16;
  p16.tile = T;
  {
    int ts = 0, ls = 0, Hs = 0, Vs = 0;
    for (int k = 0; k < 16; ++k) {
      ts += T[1 + k];
      ls += T[(1 + k) * TW];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      Hs += (k + 1) * (T[1 + 8 + k] - (k == 7 ? T[0] : T[1 + 6 - k]));
      Vs += (k + 1) * (T[(1 + 8 + k) * TW] -
                       (k == 7 ? T[0] : T[(1 + 6 - k) * TW]));
    }
    p16.dc = dc_rule(b.at, b.al, ts, ls, 5, 4);
    p16.pa = 16 * (T[16 * TW] + T[16]);
    p16.pb = (5 * Hs + 32) >> 6;
    p16.pc = (5 * Vs + 32) >> 6;
  }
  int i16m = 0;
  float i16c;
  {
    int sad[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = lane + 32 * i, y = p >> 4, x = p & 15, s = S[p];
#pragma unroll
      for (int k = 0; k < 4; ++k) sad[k] += abs(p16(k, y, x) - s);
    }
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = (float)warp_sum(sad[k]);
    c[0] = __fadd_rn(c[0], b.at ? 0.f : BIG);
    c[1] = __fadd_rn(c[1], b.al ? 0.f : BIG);
    c[3] = __fadd_rn(c[3], b.at && b.al && b.atl ? 0.f : BIG);
    i16c = c[0];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (c[k] < i16c) {
        i16c = c[k];
        i16m = k;
      }
  }
  // the residual into R16 (scratch until the recon), the forward
  // transform into registers (lane: coefficients ci = lane + 32 i of the
  // (16 blkIdx, 4, 4) layout), the DCs in raster order into X[0..15], the
  // DC levels into X[16..31], their dequantised values into X[32..47], the
  // dequantised levels into D
  int* D = X + 48;
  const int cu = (lane >> 2) & 3, cv = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = lane + 32 * i;
    R16[p] = S[p] - p16(i16m, p >> 4, p & 15);
  }
  __syncwarp();
  int coef[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int bk = (lane >> 4) + 2 * i;
    coef[i] = fdct(R16 + blk_y(bk) * 16 + blk_x(bk), 16, cu, cv);
    if ((lane & 15) == 0) X[blk_raster(bk)] = coef[i];
  }
  __syncwarp();
  // lanes 0-15: the luma DC level at raster (cu, cv) (16-31 repeat them)
  const int dcq = quant(hadamard4(X, cu, cv) >> 1, tab[T_MF + q6],
                        2 * tab[T_F + qp], tab[T_QBITS + qp] + 1);
  if (lane < 16) X[16 + lane] = dcq;
  __syncwarp();
  {
    const int g = hadamard4(X + 16, cu, cv);
    const int scale = 16 * tab[T_V + q6], qdiv = qp / 6;
    const int dcd = qp >= 36 ? g * scale * (1 << (qdiv - 6))
                             : (g * scale + (1 << (5 - qdiv))) >> (6 - qdiv);
    if (lane < 16) X[32 + lane] = dcd;
  }
  __syncwarp();
  const int mf = tab[T_MF + q6 + cu * 4 + cv], ls = 16 * tab[T_V + q6 +
                                                             cu * 4 + cv];
  const int fq = tab[T_F + qp], qbits = tab[T_QBITS + qp];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = lane + 32 * i;
    const bool dcs = (ci & 15) == 0;
    const int z = dcs ? 0 : quant(coef[i], mf, fq, qbits);
    L16[ci] = z;
    D[ci] = dcs ? X[32 + blk_raster(ci >> 4)] : dequant(z, ls, qp);
  }
  __syncwarp();
  // inverse transform: the rows into R16, then the columns
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ((lane + 32 * i) & ~15) + cu * 4;
    R16[lane + 32 * i] = ict(D[r], D[r + 1], D[r + 2], D[r + 3], cv);
  }
  __syncwarp();
  int rec[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = lane + 32 * i, base = ci & ~15, bk = ci >> 4;
    const int h = ict(R16[base + cv], R16[base + 4 + cv], R16[base + 8 + cv],
                      R16[base + 12 + cv], cu);
    rec[i] = clip255(p16(i16m, blk_y(bk) + cu, blk_x(bk) + cv) +
                     ((h + 32) >> 6));
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int bk = (lane + 32 * i) >> 4;
    R16[(blk_y(bk) + cu) * 16 + blk_x(bk) + cv] = rec[i];
  }
  if (lane < 16) DC16[lane] = dcq;
  if (lane == 0) {
    *i16_cost = i16c;
    *i16_mode = i16m;
  }
}

// ---- warp 3: the chroma decision, residual and recon ---------------------
// Writes the chroma outputs and recon planes, and the MB's right columns
// into left[16..31]; X: 152 words and L: 128 words of scratch.
__device__ void chroma(const Args& a, const int* tab, const Mb& b,
                       const int* CS, const int* CN, int* X, int* L,
                       int* left, int lane) {
  const int Wcp = a.gw * 8 + 2 * PAD, qpc = b.qpc, qc6 = (qpc % 6) * 16;
  const int cu = (lane >> 2) & 3, cv = lane & 3;
  const PredC pu = chroma_pred(CN, b.at, b.al);
  const PredC pv = chroma_pred(CN + 17, b.at, b.al);
  int cmode = 0;
  {
    int sad[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pc = lane + 32 * i, y = (pc >> 3) & 7, x = pc & 7;
      const PredC& P = pc < 64 ? pu : pv;
#pragma unroll
      for (int k = 0; k < 4; ++k) sad[k] += abs(P(k, y, x) - CS[pc]);
    }
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = (float)warp_sum(sad[k]);
    c[2] = __fadd_rn(c[2], b.at ? 0.f : BIG);
    c[1] = __fadd_rn(c[1], b.al ? 0.f : BIG);
    c[3] = __fadd_rn(c[3], b.at && b.al && b.atl ? 0.f : BIG);
    float best = c[0];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (c[k] < best) {
        best = c[k];
        cmode = k;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pc = lane + 32 * i;
    X[pc] = CS[pc] - (pc < 64 ? pu : pv)(cmode, (pc >> 3) & 7, pc & 7);
  }
  __syncwarp();
  // forward transform into L (lane: coefficients ci = lane + 32 i of the
  // (2 comp, 4 raster blocks, 4, 4) layout), DC Hadamard and quantisation
  // at X[128..], dequantised levels back into L
  for (int i = 0; i < 4; ++i) {
    const int ci = lane + 32 * i, bk = (ci >> 4) & 3;
    L[ci] = fdct(X + (ci >> 6) * 64 + (bk >> 1) * 32 + (bk & 1) * 4, 8, cu,
                 cv);
  }
  __syncwarp();
  if (lane < 8) X[128 + lane] = L[lane * 16];  // lane = comp * 4 + block
  __syncwarp();
  const int cq6 = tab[T_QBITS + qpc], cf = tab[T_F + qpc];
  if (lane < 8) {  // lane = comp * 4 + r * 2 + s
    const int cdq = quant(hadamard2(X + 128 + (lane & 4), (lane >> 1) & 1,
                                    lane & 1),
                          tab[T_MF + qc6], 2 * cf, cq6 + 1);
    a.cdc[b.m * 8 + lane] = cdq;
    X[136 + lane] = cdq;
  }
  __syncwarp();
  if (lane < 8) {
    const int g = hadamard2(X + 136 + (lane & 4), (lane >> 1) & 1, lane & 1);
    X[144 + lane] = (g * 16 * tab[T_V + qc6] * (1 << (qpc / 6))) >> 5;
  }
  __syncwarp();
  {
    const int cmf = tab[T_MF + qc6 + cu * 4 + cv];
    const int cls = 16 * tab[T_V + qc6 + cu * 4 + cv];
    for (int i = 0; i < 4; ++i) {
      const int ci = lane + 32 * i;
      const bool dcs = (ci & 15) == 0;
      const int z = dcs ? 0 : quant(L[ci], cmf, cf, cq6);
      a.cac[b.m * 128 + ci] = z;
      L[ci] = dcs ? X[144 + (ci >> 4)] : dequant(z, cls, qpc);
    }
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    const int r = ((lane + 32 * i) & ~15) + cu * 4;
    X[lane + 32 * i] = ict(L[r], L[r + 1], L[r + 2], L[r + 3], cv);
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    const int ci = lane + 32 * i, base = ci & ~15, bk = (ci >> 4) & 3;
    const int h = ict(X[base + cv], X[base + 4 + cv], X[base + 8 + cv],
                      X[base + 12 + cv], cu);
    const int y = (bk >> 1) * 4 + cu, x = (bk & 1) * 4 + cv;
    const size_t at_ = (size_t)(b.yc0 + y) * Wcp + b.xc0 + x;
    const bool v = ci >= 64;
    const int32_t* B = v ? a.bv : a.bu;
    const int val = b.intra
                        ? clip255((v ? pv : pu)(cmode, y, x) + ((h + 32) >> 6))
                        : (B ? B[at_] : 0);
    (v ? a.rv : a.ru)[at_] = val;
    if (x == 7) left[16 + 8 * v + y] = val;
  }
  if (lane == 0) a.cm[b.m] = cmode;
}

// One block of THREADS per MB row, SMEM_BYTES of dynamic shared memory;
// launched cooperatively by hl_intra_encode_frame.  One block an SM is
// all a launch needs (gh <= 68 rows up to 1080p on 132 SMs): without that
// bound ptxas keeps to 128 registers, and spills.
__global__ void __launch_bounds__(THREADS, 1) k_intra_encode(Args a) {
  int* sm = block_smem();
  int* tab = sm + S_TAB;
  int* S = sm + S_SRC;
  int* T = sm + S_TILE;
  int* CS = sm + S_CSRC;
  int* CN = sm + S_CN;
  int* R16 = sm + S_R16;
  int* L16 = sm + S_L16;
  int* DC16 = sm + S_DC16;
  int* L4 = sm + S_L4;
  int* left = sm + S_LEFT;
  float* cost = reinterpret_cast<float*>(sm + S_SCAL);  // I4, I16
  int* i16mode = sm + S_SCAL + 2;
  const int tid = threadIdx.x, nt = THREADS;
  const int lane = tid & 31, warp = tid >> 5;
  const int my = blockIdx.x, gw = a.gw;
  const int Wp = gw * 16 + 2 * PAD, Wcp = gw * 8 + 2 * PAD;
  for (int i = tid; i < T_WORDS; i += nt) tab[i] = a.tab[i];
  for (int i = tid; i < 32; i += nt) left[i] = 0;  // left of MB 0: the pad
  const float lam = *a.lam;
  const float lam4 = __fmul_rn(lam, 4.f), nlam3 = -__fmul_rn(lam, 3.f);
  const float lam6 = __fmul_rn(lam, 6.f);
  const I4Lane c4 = i4_lane(lane);

  // an MB's 384 source samples (luma raster, then U and V), three a
  // thread, read one MB ahead: nothing writes them
  constexpr int PF = 384 / THREADS;
  int pf[PF];
  auto prefetch = [&](int mx) {
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int i = tid + k * nt;
      if (i < 256)
        pf[k] = a.sy[(size_t)(PAD + 16 * my + (i >> 4)) * Wp + PAD + 16 * mx +
                     (i & 15)];
      else
        pf[k] = (i < 320 ? a.su : a.sv)[(size_t)(PAD + 8 * my +
                                                 ((i >> 3) & 7)) * Wcp +
                                        PAD + 8 * mx + (i & 7)];
    }
  };
  prefetch(0);
  __syncthreads();
  for (int mx = 0; mx < gw; ++mx) {
    Mb b;
    b.m = my * gw + mx;
    b.mx = mx;
    b.y0 = PAD + 16 * my;
    b.x0 = PAD + 16 * mx;
    b.yc0 = PAD + 8 * my;
    b.xc0 = PAD + 8 * mx;
    b.al = a.al[b.m] != 0;
    b.at = a.at[b.m] != 0;
    b.atr = a.atr ? a.atr[b.m] != 0 : true;
    b.atl = a.atl ? a.atl[b.m] != 0 : true;
    b.intra = a.mask ? a.mask[b.m] != 0 : true;
    // H.264 QPs lie in 0..51; a value outside is clamped, not read past
    // the tables
    b.qp = min(max(a.qp[b.m], 0), 51);
    b.qpc = tab[T_QPC + min(max(b.qp + a.cqo, 0), 51)];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int i = tid + k * nt;
      if (i < 256)
        S[i] = pf[k];
      else
        CS[i - 256] = pf[k];
    }
    // 1. wait for row my - 1 to publish MB min(mx + 1, gw - 1)
    if (my > 0 && tid == 0) wait_progress(a.prog + my - 1, min(mx + 2, gw));
    __syncthreads();
    if (mx + 1 < gw) prefetch(mx + 1);
    // 2. the neighbours: the row above from the planes, the left column
    // from the carry
    for (int i = tid; i < 25 + 16 + 34; i += nt) {
      if (i < 25) {
        T[i] = __ldcg(a.ry + (size_t)(b.y0 - 1) * Wp + b.x0 - 1 + i);
      } else if (i < 41) {
        T[(i - 24) * TW] = left[i - 25];
      } else {
        const int p = i - 41, c = p / 17, k = p % 17;
        CN[p] = k < 9 ? __ldcg((c ? a.rv : a.ru) + (size_t)(b.yc0 - 1) * Wcp +
                               b.xc0 - 1 + k)
                      : left[16 + 8 * c + k - 9];
      }
    }
    __syncthreads();
    // 3. the four warps
    if (warp < 2)
      intra4_chain(a, tab, b, c4, S, T, L4,
                   reinterpret_cast<float*>(sm + S_BEST), cost, warp, lane,
                   lam4, nlam3);
    else if (warp == 2)
      intra16(tab, b, S, T, sm + S_X16, R16, L16, DC16, cost + 1, i16mode,
              lane);
    else if (warp == 3)
      chroma(a, tab, b, CS, CN, sm + S_XC, sm + S_LC, left, lane);
    __syncthreads();
    // 4. I16 against I4; the MB's bottom luma row, all that row my + 1
    // reads of it (its chroma is written)
    const bool use16 = __fadd_rn(cost[1], lam6) < cost[0];
    auto luma = [&](int p) {
      const int y = p >> 4, x = p & 15;
      const size_t at_ = (size_t)(b.y0 + y) * Wp + b.x0 + x;
      const int v = !b.intra ? (a.by ? a.by[at_] : 0)
                    : use16  ? R16[p]
                             : T[(y + 1) * TW + 1 + x];
      a.ry[at_] = v;
      if (x == 15) left[y] = v;
    };
    if (tid < 16) luma(240 + tid);
    // 5. publish the MB to row my + 1: the barrier orders those stores
    // before thread 0's release
    __syncthreads();
    if (tid == 0) st_release(a.prog + my, mx + 1);
    // 6. the MB's other outputs, which no other row reads
    for (int p = tid; p < 240; p += nt) luma(p);
    for (int p = tid; p < 256; p += nt)
      a.lac[b.m * 256 + p] = use16 ? L16[p] : L4[p];
    if (tid < 16) a.ldc[b.m * 16 + tid] = use16 ? DC16[tid] : 0;
    if (tid == 0) {
      a.use16[b.m] = use16;
      a.i16m[b.m] = *i16mode;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is device memory
// that the caller allocated and checked: PAD-padded int32 planes of the
// picture's size (ry/ru/rv zeroed), (gh, gw) maps, the outputs contiguous
// int32 (gh, gw, ...) arrays, prog gh zeroed ints; by/bu/bv, atr, atl and
// mask may be null.  `threads`: the block size the caller expects, THREADS.
// Launches gh co-resident blocks (a cooperative
// launch, refused when they cannot all be resident).  Returns 0 or the
// CUDA error code of the launch.
extern "C" int hl_intra_encode_frame(
    const int32_t* sy, const int32_t* su, const int32_t* sv,
    const int32_t* by, const int32_t* bu, const int32_t* bv,
    const int32_t* qp, const uint8_t* al, const uint8_t* at,
    const uint8_t* atr, const uint8_t* atl, const uint8_t* mask,
    const int32_t* tab, const float* lam, int32_t* ry, int32_t* ru,
    int32_t* rv, int32_t* use16, int32_t* i16m, int32_t* i4m, int32_t* cm,
    int32_t* ldc, int32_t* lac, int32_t* cdc, int32_t* cac, int* prog,
    int gw, int gh, int chroma_qp_off, int threads, cudaStream_t stream) {
  if (threads != THREADS) return (int)cudaErrorInvalidValue;
  Args a{sy,  su,  sv,   by,  bu,  bv,  qp,  al,  at,  atr, atl, mask, tab,
         lam, ry,  ru,   rv,  use16, i16m, i4m, cm, ldc, lac, cdc, cac,
         prog, gw, gh, chroma_qp_off};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)k_intra_encode,
                                          dim3(gh), dim3(THREADS), args,
                                          SMEM_BYTES, stream);
}

// The kernel's resources as the runtime reports them: out[0..5] = the
// dynamic shared memory it launches with, registers per thread, local
// (spill) bytes per thread, static shared memory, the most threads a
// block may have, and the most blocks (MB rows) that the current device
// holds at once.  Returns 0 or the CUDA error code.
extern "C" int hl_intra_encode_attributes(int* out) {
  cudaFuncAttributes f;
  cudaError_t err = cudaFuncGetAttributes(&f, k_intra_encode);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_intra_encode,
                                                      THREADS, SMEM_BYTES);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = SMEM_BYTES;
  out[1] = f.numRegs;
  out[2] = (int)f.localSizeBytes;
  out[3] = (int)f.sharedSizeBytes;
  out[4] = f.maxThreadsPerBlock;
  out[5] = per_sm * sms;
  return (int)err;
}
