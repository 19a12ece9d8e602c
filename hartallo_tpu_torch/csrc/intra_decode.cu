// The decoder's intra reconstruction of one picture for Hopper (sm_90a):
// the Intra4x4, Intra16x16 and chroma predictions of every intra MB plus
// its residual, in the order the neighbours allow.
//
// Replaces hartallo_tpu/decode/intra_recon.py:intra_reconstruct, the XLA
// wavefront of the GOP scan's intra branch (decode/d_gop.py), the general
// route (decode/decoder.py) and the sharded band step (parallel/shard.py).
// Its plain twin is hartallo_tpu_torch/decode/intra_recon.py
// :intra_reconstruct, which this kernel matches bit for bit; the wrapper
// is hartallo_tpu_torch/decode/intra_recon_fast.py.
//
// Computes, for every MB: kind 0 (I4x4) the 16 Intra4x4 blocks in an order
// that respects blkIdx's dependencies, each predicted in its mode (clamped
// to 0..8) from its left, top, top-left and top-right samples (the
// top-right four replaced by the top's last where the block never has
// them: blocks 3, 7, 11, 13 and 15, and 5 at the right picture edge or
// without the above-right MB), plus its residual, clipped; kind 1 (I16)
// the Intra16x16 prediction in its mode plus the residual; for both the
// chroma prediction in its mode plus the residual.  Any other kind keeps
// its samples.  The twin's neighbour rules at the picture's edges are
// kept exactly: a neighbour above the picture reads 0; left of column 0
// it reads 0 on row 0 and MB (0, 0)'s input samples below (its right
// column, and for the top-left corner 0 on row 1 and MB (0, 0)'s input
// bottom-right sample below); above-right of the last column, MB (0, 0)'s
// input bottom row.  (The twin's skewed diagonals hold MB (0, 0)'s input
// tile in their empty slots; a conforming stream never predicts from
// these samples.)
//
// What bounds it on the H100: bytes.  On an all-intra picture the
// function writes its new padded planes, reads of its input planes only
// the pad (every interior sample is predicted anew) and reads the
// residual and modes: about 29 MB, 8.6 us a 1080p picture at 3.35 TB/s
// (chip_smoke.intra_dec_bound).  What it takes is the chain: an MB reads the
// recon of its left, top, top-left and top-right neighbours, so a picture
// is at least gw + 2 gh - 2 MB latencies long: gw in-row steps s and,
// down the rows, two steps and a hand-off h from row to row each.  The
// design keeps both short and puts nothing on the chain for an MB that
// is not intra.
//
// Design.
// - One block of five warps per MB row, a cooperative launch of gh
//   blocks, so all rows are resident and their spin-waits cannot
//   deadlock.  Warp 0 computes luma, warp 1 chroma; warp 2, the edge
//   warp, and warp 4, the tap warp, run ahead of them over the row's
//   intra MBs (a bitmask of the read-only kinds, made at the start),
//   filling NSLOT shared slots in turn; named barriers hand a slot over
//   (bar_arrive / bar_sync) and back, one hand-back barrier for each
//   producer so neither waits on the other.  A slot holds the MB's
//   parameters and residual (loaded into the edge warp's registers one
//   intra MB ahead), its 17x25 luma tile's top row (top-left, top,
//   above-right) and chroma top-left and top samples, the left columns
//   where the left MB is not intra (from the input planes, which are
//   read-only), and the Intra4x4 taps of every sample (below).
// - The row above is waited on only where it has an intra MB among
//   mx - 1, mx and mx + 1 (device_prims.cuh: an acquire load of its
//   progress counter until it reaches one past the largest); an inter MB
//   above is already final in the output plane.  Nothing of an inter MB
//   is loaded, waited on or published.
// - A row publishes mx + 1 after its intra MB mx is stored, and gw at its
//   end: warps 0 and 1 each raise a counter in shared memory after an MB
//   (a block-scope release), and warp 3, the publishing warp, releases
//   the smaller to the row's counter in global memory, so that the
//   device-scope fence stays off the other warps.
//   The counter is monotone, so a wait for "at least k + 1" is one for
//   MB k.
// - The left neighbours come from shared memory: when MB mx + 1 is intra,
//   the lanes that compute MB mx's right column (luma 15, chroma 7) also
//   store it into the next slot's left column, and the edge warp takes
//   the top-left corners from the previous slot's top row.  No sample of
//   the row's own chain is read back from L2.
// - Warp 0, I4x4: the ten steps of the MB's 4x4 wavefront (block (bc, br)
//   at step bc + 2 br reads its left, top, top-left and top-right
//   neighbours, steps - 1, - 2, - 3, - 1), up to two blocks a step, 16
//   lanes a block and one sample a lane.  The tap warp works out, from
//   the modes and the wrapper's table, every sample's three tap offsets
//   in the tile, weights, rounding and shift; the DC mode's sums are
//   width-8 shuffle sums of one edge sample a lane.  A step is three
//   tile loads, the multiply-adds, the rounding and residual as one
//   addend from a register, the clip, the stores and a __syncwarp.  I16:
//   the sums by warp reductions, 8 samples a lane.  Warp 1: 16 lanes a
//   chroma component, 4 samples a lane.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_prims.cuh"

namespace {

constexpr int PAD = 32;
// the block: the luma warp, the chroma warp, the edge warp, the
// publishing warp and the tap warp (warps 0-2 and 4 meet at the slots'
// named barriers)
constexpr int THREADS = 160, SLOT_THREADS = 128, BACK_THREADS = 96;
constexpr unsigned FULL = 0xffffffffu;
// slots the edge and tap warps fill ahead of warps 0-1: named barriers
// 1..NSLOT hand a slot over ("full"), NSLOT + 1..2 NSLOT hand it back to
// the edge warp and 2 NSLOT + 1..3 NSLOT to the tap warp ("empty")
constexpr int NSLOT = 2;

// the wrapper's table (intra_recon_fast._tables), int32 word pairs: for
// each directional Intra4x4 mode (row 0, 1, 2..7 holds mode 0, 1, 3..8),
// without and with the top-right substitution, each sample 4 y + x of a
// block: A, the three taps' offsets in the tile from the block's top-left
// corner sample, 9 bits each (bits 0, 9, 18); B, their weights, 2 bits
// each (bits 0, 2, 4), the rounding (bits 8-15) and the shift (bits 16-17)
constexpr int T_WORDS = 8 * 2 * 16 * 2;
// in a slot's taps, B's bit for the DC mode
constexpr int B_DC = 1 << 24;

// the MB's parameters in its slot: kind (-1: the row is done), Intra16x16
// mode, chroma mode, the left, top and top-right availability, the 16
// Intra4x4 modes (the P_IN words loaded), then the MB's column, whether
// MB mx + 1 is intra, and the Intra4x4 steps that hold a DC block
constexpr int P_KIND = 0, P_I16 = 1, P_CM = 2, P_AL = 3, P_AT = 4,
              P_ATR = 5, P_I4 = 6, P_IN = 22, P_MX = 22, P_NEXT = 23,
              P_DCM = 24;

// a slot, int32 words: the luma tile (row 0 the top-left corner, the top
// row and the above-right MB's first 8 samples, column 0 the left
// column), the chroma neighbours [c][tl, t0..7, l0..7], the residual
// (luma 16x16 raster, then U and V 8x8), the parameters, and the
// Intra4x4 taps [step][lane] as int4: the three taps' byte offsets in the
// tile and B (with B_DC)
constexpr int TW = 25;
constexpr int S_T = 0, T_SPARE = 17 * TW, S_CN = 428, S_R = 464, S_P = 848,
              S_TAP = 880, SLOT_WORDS = S_TAP + 10 * 32 * 4;
// the block's shared memory: the table, warps 0-1's done counters, the
// slots, then the intra masks of this row and the row above (nw words
// each)
constexpr int B_TAB = 0, B_DONE = T_WORDS, B_SLOT = B_DONE + 4,
              B_MASK = B_SLOT + NSLOT * SLOT_WORDS;

struct Args {
  const int32_t *iy, *iu, *iv;  // the input planes, PAD-padded
  int32_t *oy, *ou, *ov;        // the output planes: copies of the input
  const int32_t* res_y;         // (gh, gw, 16, 16)
  const int32_t* res_c;         // (gh, gw, 2, 8, 8)
  const int32_t *kind, *i16m, *i4m, *cm;  // (gh, gw), i4m (gh, gw, 16)
  const uint8_t *al, *at, *atr;  // (gh, gw) bool; atr may be null (true)
  const int32_t* tab;
  int* prog;                     // gh zeroed counters: MBs of a row done
  int gw, gh;
};

__device__ __forceinline__ bool is_intra(int kind) {
  return kind == 0 || kind == 1;
}

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

__device__ __forceinline__ int clampi(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/intra._dc: the average of the available edges, 128 with neither
__device__ __forceinline__ int dc_rule(bool at, bool al, int ts, int ls,
                                       int both_sh, int one_sh) {
  if (at && al) return (ts + ls + (1 << (both_sh - 1))) >> both_sh;
  if (al) return (ls + (1 << (one_sh - 1))) >> one_sh;
  if (at) return (ts + (1 << (one_sh - 1))) >> one_sh;
  return 128;
}

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(FULL, (unsigned)v);
}

__device__ __forceinline__ int* slot(int* sm, int i) {
  return sm + B_SLOT + (i % NSLOT) * SLOT_WORDS;
}

// The empty barrier of slot i % NSLOT for the edge warp (who 0) or the
// tap warp (1).
__device__ __forceinline__ int empty_bar(int i, int who) {
  return 1 + NSLOT * (1 + who) + i % NSLOT;
}

// The block (bc, br) that half h of warp 0 computes at Intra4x4 step st;
// false where the half has none.
__device__ __forceinline__ bool step_block(int st, int h, int& bc, int& br) {
  br = (st < 3 ? 0 : (st - 2) >> 1) + h;
  bc = st - 2 * br;
  return br <= 3 && bc >= 0;
}

// The tap warp: the taps of warp 0's lane `lane` at each step of an I4x4
// MB into TAP, and the steps that hold a DC block into P[P_DCM]; pp is
// the MB's parameter word of the lane (P's layout), so the modes come by
// shuffles, and every load is issued before the first store.
__device__ void make_taps(const int2* ptab, int pp, int* P, int4* TAP,
                          bool at_edge, int lane) {
  const int h = lane >> 4, j = lane & 15;
  const bool at = __shfl_sync(FULL, pp, P_AT) != 0;
  const bool al = __shfl_sync(FULL, pp, P_AL) != 0;
  const bool atr = __shfl_sync(FULL, pp, P_ATR) != 0;
  int mode[10];
#pragma unroll
  for (int st = 0; st < 10; ++st) {
    int bc, br;
    step_block(st, h, bc, br);
    const int blk = 8 * ((br >> 1) & 1) + 2 * (br & 1) + 4 * (bc >> 1) +
                    (bc & 1);
    mode[st] = clampi(0, 8, __shfl_sync(FULL, pp, P_I4 + (blk & 15)));
  }
  unsigned dcm = 0;
  int4 q[10];
#pragma unroll
  for (int st = 0; st < 10; ++st) {
    int bc, br;
    q[st] = make_int4(0, 0, 0, 0);
    if (step_block(st, h, bc, br)) {
      const int blk = 8 * (br >> 1) + 2 * (br & 1) + 4 * (bc >> 1) +
                      (bc & 1);
      const int base = 4 * br * TW + 4 * bc;
      if (mode[st] == 2) {
        // lane j's edge sample j & 7 (top 0..3, left 0..3), weight 1 where
        // that edge is available; the sum over 8 lanes, rounded, shifted
        const bool bat = br != 0 || at;
        const bool bal = bc != 0 || al;
        const int e = j & 7;
        const int off = base + (e < 4 ? 1 + e : (e - 3) * TW);
        const int rnd = bat && bal ? 4 : (bat || bal ? 2 : 128);
        const int sh = bat && bal ? 3 : (bat || bal ? 2 : 0);
        q[st] = make_int4(4 * off, 4 * base, 4 * base,
                          (int)(e < 4 ? bat : bal) | rnd << 8 | sh << 16 |
                              B_DC);
        dcm |= 1u << st;
      } else {
        // the top-right samples never available: blocks 3 7 11 13 15, and
        // 5 at the right picture edge or without the above-right MB
        const int sub = ((0xA888 >> blk) & 1) |
                        ((blk == 5) & (at_edge | (atr == 0)));
        const int m = mode[st];
        const int2 t = ptab[((m < 2 ? m : m - 1) * 2 + sub) * 16 + j];
        q[st] = make_int4(4 * (base + (t.x & 511)),
                          4 * (base + ((t.x >> 9) & 511)),
                          4 * (base + ((t.x >> 18) & 511)), t.y);
      }
    }
  }
#pragma unroll
  for (int st = 0; st < 10; ++st) TAP[st * 32 + lane] = q[st];
  dcm = __reduce_or_sync(FULL, dcm);
  if (lane == 0) P[P_DCM] = (int)dcm;
}

// Warp 0, I4x4: the ten steps of the MB's 4x4 wavefront, block (bc, br)
// at step bc + 2 br, two a step at most (lanes 0-15 the one with the
// larger bc); each sample to the tile and the plane, the right column
// also to the next slot's left column when MB mx + 1 is intra.  The
// rounding and the residual r are one addend: ((acc + rnd) >> sh) + r ==
// (acc + rnd + r 2^sh) >> sh with an arithmetic shift.  A lane with no
// block at a step stores its sample into the tile's spare word.
__device__ void luma_i4(const int* P, const int* R, const int4* TAP, int* T,
                        int* Tn, bool next, int32_t* oy, size_t y0, int x0,
                        int Wp, int lane) {
  const int h = lane >> 4, x = lane & 3, y = (lane >> 2) & 3;
  const unsigned dcm = (unsigned)P[P_DCM];
  const char* Tb = reinterpret_cast<const char*>(T);
  auto tile = [&](int off) { return *reinterpret_cast<const int*>(Tb + off); };
  int4 q[10];
  int add[10];
#pragma unroll
  for (int st = 0; st < 10; ++st) {
    int bc, br;
    q[st] = TAP[st * 32 + lane];
    const int r = step_block(st, h, bc, br)
                      ? R[(4 * br + y) * 16 + 4 * bc + x] : 0;
    add[st] = ((q[st].w >> 8) & 255) + r * (1 << ((q[st].w >> 16) & 3));
  }
  int32_t* const ol = oy + (y0 + y) * Wp + x0 + x;
#pragma unroll
  for (int st = 0; st < 10; ++st) {
    int bc, br;
    const bool mine = step_block(st, h, bc, br);
    const int B = q[st].w;
    int acc = (B & 3) * tile(q[st].x) + ((B >> 2) & 3) * tile(q[st].y) +
              ((B >> 4) & 3) * tile(q[st].z);
    if ((dcm >> st) & 1) {
      int t = acc;
      t += __shfl_xor_sync(FULL, t, 1);
      t += __shfl_xor_sync(FULL, t, 2);
      t += __shfl_xor_sync(FULL, t, 4);
      if (B & B_DC) acc = t;
    }
    const int v = clip255((acc + add[st]) >> ((B >> 16) & 3));
    const int ty = 4 * br + y + 1;
    T[mine ? ty * TW + 4 * bc + x + 1 : T_SPARE] = v;
    if (mine) ol[4 * br * Wp + 4 * bc] = v;
    if (mine && next && 4 * bc + x == 15) Tn[ty * TW] = v;
    __syncwarp();
  }
}

// Warp 0, I16: the four predictions' sums by warp reductions, then 8
// samples a lane.
__device__ void luma_i16(const int* P, const int* R, const int* T, int* Tn,
                         bool next, int32_t* oy, size_t y0, int x0, int Wp,
                         int lane) {
  const int k = lane & 15, k8 = lane & 7;
  // lanes 0-15 the top, 16-31 the left (both sums below 2^16)
  const int edge = lane < 16 ? T[1 + k] : T[(1 + k) * TW];
  const int tl = T[0];
  const int sums = warp_sum(lane < 16 ? edge : edge << 16);
  const int ts = sums & 0xffff, ls = sums >> 16;
  // lanes 0-7 H's terms, 8-15 V's
  int hv = 0;
  if (lane < 8)
    hv = (k8 + 1) * (T[1 + 8 + k8] - (k8 == 7 ? tl : T[1 + 6 - k8]));
  const int Hs = warp_sum(hv);
  hv = 0;
  if (lane >= 8 && lane < 16)
    hv = (k8 + 1) * (T[(1 + 8 + k8) * TW] -
                     (k8 == 7 ? tl : T[(1 + 6 - k8) * TW]));
  const int Vs = warp_sum(hv);
  const int mode = clampi(0, 3, P[P_I16]);
  const int dc = dc_rule(P[P_AT] != 0, P[P_AL] != 0, ts, ls, 5, 4);
  const int a = 16 * (T[16 * TW] + T[16]);
  const int b = (5 * Hs + 32) >> 6, c = (5 * Vs + 32) >> 6;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = lane + 32 * j, y = p >> 4, x = p & 15;
    int pred;
    if (mode == 0) pred = T[1 + x];
    else if (mode == 1) pred = T[(1 + y) * TW];
    else if (mode == 2) pred = dc;
    else pred = clip255((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
    const int v = clip255(pred + R[p]);
    oy[(y0 + y) * Wp + x0 + x] = v;
    if (next && x == 15) Tn[(y + 1) * TW] = v;
  }
}

// The chroma prediction of one component; n = [tl, t0..t7, l0..l7]
struct PredC {
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
  // the off-diagonal quarters prefer one edge: (x 4..7, y 0..3) the top,
  // (x 0..3, y 4..7) the left
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

// Warp 1: lanes 0-15 U, 16-31 V, 4 samples a lane; the right columns
// also to the next slot's left columns when MB mx + 1 is intra.
__device__ void chroma(const int* P, const int* R, const int* CN, int* CNn,
                       bool next, int32_t* ou, int32_t* ov, size_t yc0,
                       int xc0, int Wcp, int lane) {
  const bool at = P[P_AT] != 0, al = P[P_AL] != 0;
  const int mode = clampi(0, 3, P[P_CM]);
  const int c = lane >> 4;
  const PredC pc = chroma_pred(CN + 17 * c, at, al);
  int32_t* O = (c ? ov : ou) + yc0 * Wcp + xc0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = (lane & 15) + 16 * k, y = p >> 3, x = p & 7;
    const int v = clip255(pc(mode, y, x) + R[256 + 64 * c + p]);
    O[y * Wcp + x] = v;
    if (next && x == 7) CNn[17 * c + 9 + y] = v;
  }
}

// Warps 0 and 1: the MBs of the slots in turn until the edge warp's end
// mark; after each, the warp's done counter (block scope) to mx + 1 for
// the publishing warp, and the slot back to the edge and tap warps.
__device__ void compute_warp(const Args& a, int* sm, int my, int warp,
                             int lane) {
  const int Wp = a.gw * 16 + 2 * PAD, Wcp = a.gw * 8 + 2 * PAD;
  for (int i = 0;; ++i) {
    int* S = slot(sm, i);
    int* Sn = slot(sm, i + 1);
    bar_sync(1 + i % NSLOT, SLOT_THREADS);
    const int* P = S + S_P;
    const int kind = P[P_KIND];
    if (kind < 0) break;
    const int mx = P[P_MX];
    const bool next = P[P_NEXT] != 0;
    if (warp == 0) {
      const size_t y0 = PAD + 16 * my;
      const int x0 = PAD + 16 * mx;
      if (kind == 0)
        luma_i4(P, S + S_R, reinterpret_cast<const int4*>(S + S_TAP),
                S + S_T, Sn + S_T, next, a.oy, y0, x0, Wp, lane);
      else
        luma_i16(P, S + S_R, S + S_T, Sn + S_T, next, a.oy, y0, x0, Wp,
                 lane);
    } else {
      chroma(P, S + S_R, S + S_CN, Sn + S_CN, next, a.ou, a.ov,
             PAD + 8 * my, PAD + 8 * mx, Wcp, lane);
    }
    __syncwarp();
    if (lane == 0) st_release_cta(sm + B_DONE + warp, mx + 1);
    bar_arrive(empty_bar(i, 0), BACK_THREADS);
    bar_arrive(empty_bar(i, 1), BACK_THREADS);
  }
}

// This row's first intra MB from `from` on (gw when none), from the row's
// intra mask.
__device__ __forceinline__ int next_intra(const unsigned* mask, int gw,
                                          int from) {
  const int nw = (gw + 31) >> 5;
  for (int w = from >> 5; w < nw; ++w) {
    const unsigned m = mask[w] & (w == from >> 5 ? ~0u << (from & 31) : ~0u);
    if (m) return 32 * w + __ffs((int)m) - 1;
  }
  return gw;
}

// Lane k < P_IN: word k of MB (mx, my)'s parameters (nothing writes them).
__device__ __forceinline__ int load_param(const Args& a, int my, int mx,
                                          int lane) {
  const size_t m = (size_t)my * a.gw + mx;
  return lane == P_KIND  ? a.kind[m]
         : lane == P_I16 ? a.i16m[m]
         : lane == P_CM  ? a.cm[m]
         : lane == P_AL  ? (int)a.al[m]
         : lane == P_AT  ? (int)a.at[m]
         : lane == P_ATR ? (a.atr ? (int)a.atr[m] : 1)
         : lane < P_IN   ? a.i4m[m * 16 + lane - P_I4]
                         : 0;
}

// The warp waits until lane 0 finds ready() true.
template <class Ready>
__device__ __forceinline__ void warp_wait(Ready ready, int lane) {
  for (;;) {
    int ok = 0;
    if (lane == 0) ok = ready() || !spin_on();
    if (__shfl_sync(FULL, ok, 0)) break;
  }
  __syncwarp();
}

// The edge or tap warp before item i (an MB or the end mark) goes into
// its slot: the slot's last MB handed back (none for the first NSLOT).
__device__ __forceinline__ void wait_empty(int i, int who) {
  if (i >= NSLOT) bar_sync(empty_bar(i, who), BACK_THREADS);
}

// The edge or tap warp after the end mark, item `end`: the hand-backs of
// the MBs in the slots that no later item reused, so that every empty
// barrier's phase completes.
__device__ __forceinline__ void drain_empty(int end, int who) {
  for (int j = max(end - NSLOT + 1, 0); j < end; ++j)
    bar_sync(empty_bar(j, who), BACK_THREADS);
}

// The edge warp: loads MB mx's neighbours above (after the row above has
// its intra ones) and, where the left MB is not intra, its left columns,
// with the twin's values outside the picture, all loads before the first
// store.  Sp: the previous slot, which holds MB mx - 1 where `left` (that
// MB is intra).
__device__ void load_edges(const Args& a, int* S, const int* Sp, int mx,
                           int my, bool left, int lane) {
  const int gw = a.gw, Wp = gw * 16 + 2 * PAD, Wcp = gw * 8 + 2 * PAD;
  const size_t y0 = PAD + 16 * my, yc0 = PAD + 8 * my;
  const int x0 = PAD + 16 * mx, xc0 = PAD + 8 * mx;
  int val[3], dst[3];  // a lane's items lane, lane + 32, lane + 64
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = lane + 32 * k;
    int v = 0, d = -1;
    if (i < 25) {  // tile row 0: top-left, top, above-right
      d = S_T + i;
      if (my > 0) {
        if (i == 0 && mx == 0)
          v = my > 1 ? a.iy[(size_t)(PAD + 15) * Wp + PAD + 15] : 0;
        else if (i == 0 && left)
          v = Sp[S_T + 16];
        else if (i > 16 && mx == gw - 1)
          v = a.iy[(size_t)(PAD + 15) * Wp + PAD + i - 17];
        else
          v = __ldcg(a.oy + (y0 - 1) * Wp + x0 - 1 + i);
      }
    } else if (i < 41) {  // tile column 0: the left column
      const int r = i - 25;
      if (!left) {
        d = S_T + (r + 1) * TW;
        if (mx > 0)
          v = a.iy[(y0 + r) * Wp + x0 - 1];
        else if (my > 0)
          v = a.iy[(size_t)(PAD + r) * Wp + PAD + 15];
      }
    } else if (i < 75) {  // chroma: top-left, top, left
      const int p = i - 41, c = p / 17, e = p % 17;
      const int32_t* O = c ? a.ov : a.ou;
      const int32_t* I = c ? a.iv : a.iu;
      if (e < 9 || !left) d = S_CN + p;
      if (e == 0) {
        if (my > 0)
          v = mx == 0 ? (my > 1 ? I[(size_t)(PAD + 7) * Wcp + PAD + 7] : 0)
              : left  ? Sp[S_CN + 17 * c + 8]
                      : __ldcg(O + (yc0 - 1) * Wcp + xc0 - 1);
      } else if (e < 9) {
        if (my > 0) v = __ldcg(O + (yc0 - 1) * Wcp + xc0 + e - 1);
      } else if (left) {
      } else if (mx > 0) {
        v = I[(yc0 + e - 9) * Wcp + xc0 - 1];
      } else if (my > 0) {
        v = I[(size_t)(PAD + e - 9) * Wcp + PAD + 7];
      }
    }
    val[k] = v;
    dst[k] = d;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (dst[k] >= 0) S[dst[k]] = val[k];
}

// The edge warp: the row's intra MBs in turn, each into the next slot
// (once both compute warps are done with the MB it held), then the end
// mark.  An MB's parameters and residual are loaded into registers one
// intra MB ahead (nothing writes them).
__device__ void edge_warp(const Args& a, int* sm, int my, int lane) {
  const int gw = a.gw, nw = (gw + 31) >> 5;
  const unsigned* mask = reinterpret_cast<const unsigned*>(sm + B_MASK);
  // whether MB mx of this row (r 0) or the row above (r 1) is intra
  auto intra_at = [&](int r, int mx) {
    return mx >= 0 && mx < gw &&
           ((mask[r * nw + (mx >> 5)] >> (mx & 31)) & 1) != 0;
  };
  // the lane's parameter word and 16 bytes a copy of MB mx's residual
  // (luma, then U and V)
  int pp = 0;
  int4 rf[3];
  auto prefetch = [&](int mx) {
    const size_t m = (size_t)my * gw + mx;
    pp = load_param(a, my, mx, lane);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = lane + 32 * k;
      rf[k] = *reinterpret_cast<const int4*>(
          c < 64 ? a.res_y + m * 256 + 4 * c
                 : a.res_c + m * 128 + 4 * (c - 64));
    }
  };

  int n = next_intra(mask, gw, 0);
  if (n < gw) prefetch(n);
  int seen = 0;  // lane 0: the row above's counter as last read
  for (int i = 0;; ++i) {
    int* S = slot(sm, i);
    int* P = S + S_P;
    wait_empty(i, 0);
    if (n >= gw) {
      if (lane == 0) P[P_KIND] = -1;
      __syncwarp();
      bar_arrive(1 + i % NSLOT, SLOT_THREADS);
      drain_empty(i, 0);
      break;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<int4*>(S + S_R + 4 * (lane + 32 * k)) = rf[k];
    const int nn = next_intra(mask, gw, n + 1);
    if (lane < P_IN) P[lane] = pp;
    if (lane == 0) {
      P[P_MX] = n;
      P[P_NEXT] = nn == n + 1;
    }
    if (nn < gw) prefetch(nn);
    if (my > 0) {
      // the row above: its intra MBs among n - 1, n and n + 1
      const int t = intra_at(1, n + 1) ? n + 2
                    : intra_at(1, n)   ? n + 1
                    : intra_at(1, n - 1) ? n : 0;
      if (t > 0)
        warp_wait([&] {
          if (seen < t) seen = ld_acquire(a.prog + my - 1);
          return seen >= t;
        }, lane);
    }
    load_edges(a, S, slot(sm, i + NSLOT - 1), n, my, intra_at(0, n - 1),
               lane);
    __syncwarp();
    bar_arrive(1 + i % NSLOT, SLOT_THREADS);
    n = nn;
  }
}

// The tap warp: beside the edge warp, the Intra4x4 taps of each of the
// row's intra MBs into its slot (make_taps; nothing for an Intra16x16
// MB), the MB's parameters loaded one intra MB ahead.
__device__ void tap_warp(const Args& a, int* sm, int my, int lane) {
  const int gw = a.gw;
  const unsigned* mask = reinterpret_cast<const unsigned*>(sm + B_MASK);
  const int2* ptab = reinterpret_cast<const int2*>(sm + B_TAB);
  int n = next_intra(mask, gw, 0);
  int pp = n < gw ? load_param(a, my, n, lane) : 0;
  for (int i = 0;; ++i) {
    int* S = slot(sm, i);
    wait_empty(i, 1);
    if (n < gw && __shfl_sync(FULL, pp, P_KIND) == 0)
      make_taps(ptab, pp, S + S_P, reinterpret_cast<int4*>(S + S_TAP),
                n == gw - 1, lane);
    __syncwarp();
    bar_arrive(1 + i % NSLOT, SLOT_THREADS);
    if (n >= gw) {
      drain_empty(i, 1);
      break;
    }
    const int nn = next_intra(mask, gw, n + 1);
    if (nn < gw) pp = load_param(a, my, nn, lane);
    n = nn;
  }
}

// The publishing warp (lane 0): the row's counter to the smaller of warps
// 0-1's done counters whenever either moves, then gw once the row's last
// intra MB is published (at once when it has none).
__device__ void publish_warp(const Args& a, const int* sm, int my,
                             int lane) {
  if (lane != 0) return;
  const int nw = (a.gw + 31) >> 5;
  int end = 0;  // one past the row's last intra MB
  for (int w = 0; w < nw; ++w) {
    const int m = sm[B_MASK + w];
    if (m) end = 32 * w + 32 - __clz(m);
  }
  for (int pub = 0; pub < end;) {
    const int d = min(ld_acquire_cta(sm + B_DONE),
                      ld_acquire_cta(sm + B_DONE + 1));
    if (d > pub) {
      st_release(a.prog + my, d);
      pub = d;
    } else if (!spin_on()) {
      break;
    }
  }
  st_release(a.prog + my, a.gw);
}

// One block of THREADS per MB row, smem_bytes(gw) of dynamic shared
// memory; launched cooperatively by hl_intra_decode.
__global__ void __launch_bounds__(THREADS) k_intra_decode(Args a) {
  int* sm = block_smem();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int my = blockIdx.x, gw = a.gw, nw = (gw + 31) >> 5;
  for (int i = tid; i < T_WORDS; i += THREADS) sm[B_TAB + i] = a.tab[i];
  if (tid < 2) sm[B_DONE + tid] = 0;
  // the intra MBs of this row (words 0..nw-1) and the row above
  for (int i = warp; i < 2 * nw; i += THREADS / 32) {
    const int row = i < nw ? my : my - 1, mx = 32 * (i % nw) + lane;
    const bool in = row >= 0 && mx < gw &&
                    is_intra(a.kind[(size_t)row * gw + mx]);
    const unsigned m = __ballot_sync(FULL, in);
    if (lane == 0) sm[B_MASK + i] = (int)m;
  }
  __syncthreads();
  if (warp == 4)
    tap_warp(a, sm, my, lane);
  else if (warp == 3)
    publish_warp(a, sm, my, lane);
  else if (warp == 2)
    edge_warp(a, sm, my, lane);
  else
    compute_warp(a, sm, my, warp, lane);
}

// Bytes of dynamic shared memory a block takes at gw MBs a row.
constexpr int smem_bytes(int gw) {
  return 4 * (B_MASK + 2 * ((gw + 31) >> 5));
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is device memory
// that the caller allocated and checked: the PAD-padded int32 input planes
// and their copies (oy, ou, ov), which the kernel writes; the contiguous
// int32 residuals (gh, gw, 16, 16) and (gh, gw, 2, 8, 8), 16-byte aligned,
// kind, i16m and cm (gh, gw) and i4m (gh, gw, 16) int32, al, at and atr
// (gh, gw) bool (atr may be null), the mode table, and prog, gh zeroed
// ints.  `threads`: the block size the caller expects, THREADS.  Launches
// gh co-resident blocks (a cooperative launch, refused when they cannot
// all be resident).  Returns 0 or the CUDA error code of the launch.
extern "C" int hl_intra_decode(const int32_t* iy, const int32_t* iu,
                               const int32_t* iv, int32_t* oy, int32_t* ou,
                               int32_t* ov, const int32_t* res_y,
                               const int32_t* res_c, const int32_t* kind,
                               const int32_t* i16m, const int32_t* i4m,
                               const int32_t* cm, const uint8_t* al,
                               const uint8_t* at, const uint8_t* atr,
                               const int32_t* tab, int* prog, int gw, int gh,
                               int threads, cudaStream_t stream) {
  if (threads != THREADS) return (int)cudaErrorInvalidValue;
  Args a{iy, iu, iv, oy, ou, ov, res_y, res_c, kind, i16m, i4m, cm,
         al, at, atr, tab, prog, gw, gh};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)k_intra_decode,
                                          dim3(gh), dim3(THREADS), args,
                                          smem_bytes(gw), stream);
}
