// The encoder's P-picture body around the motion search for Hopper
// (sm_90a): the partition decision, the half-pel stack, the MC, residual,
// recon and intra-in-P estimate, and the in-loop deblock's parameters.
//
// Replaces the XLA program of hartallo_tpu/encode/e_device.py:p_gop_fused
// outside the motion search and the intra wavefront:
//   k_part_decide     hartallo_tpu/encode/p_device.py:79-105, the
//                     partition decision;
//   k_halfpel_enc     hartallo_tpu/ops/wide.py:halfpel_planes;
//   k_p_residual      hartallo_tpu/decode/inter_recon.py:inter_predict_frame
//                     (ops/interpol.py luma_mc_blocks, chroma_mc_blocks),
//                     ops/transform.py's forward and inverse steps, the
//                     JVT-O079 eliminations and the recon of
//                     p_device.p_frame_device, and the intra-in-P
//                     estimate of e_device.py:178-189 (ops/math.satd4x4);
//   k_deblock_params  hartallo_tpu/ops/deblock.py:compute_bs and
//                     ops/deblock_pallas.py:_edge_params, as gathered by
//                     e_device.deblock_recon_device.
// Their plain twins are hartallo_tpu_torch/encode/p_device.py
// (partition_decide, p_residual), ops/wide.halfpel_planes and
// encode/e_device.deblock_params, which these kernels match bit for bit;
// the wrappers are hartallo_tpu_torch/encode/p_body_fast.py.
//
// Design.
//   k_part_decide     16 lanes an MB, two MBs a warp, 256 threads a
//                     block: each lane loads the MB's nine costs (one
//                     address across the MB's lanes), forms the four
//                     costs in the twin's f32 order and the first minimum
//                     (the same in every lane: no reduction, no shuffle),
//                     then loads its block's MV of the chosen scheme and
//                     writes it (times 4, one 8-byte store) and its
//                     partition index; lane 0 the choice and the cost.
//   k_halfpel_enc     a block of 256 threads per 64 x 16 tile of the
//                     padded plane, on a 2-D grid.  The block stages the
//                     tile's G with a halo of 2 rows above, 3 below and 4
//                     columns a side in shared memory once (coalesced
//                     loads, the only place where coordinates are clamped
//                     to the plane, as the twin's _edge_pad(..., 2, 3)
//                     clamps them), forms the horizontal 6-tap sums H1 of
//                     every staged row once, then each thread takes 4
//                     samples of a row: b from H1, h from G's columns, j
//                     the vertical 6-tap over H1 (14 shared reads a
//                     sample, against 49 clamped global loads when every
//                     tap is recomputed), and writes them to each plane as
//                     one int4 where the row allows, scalars at a ragged
//                     edge.
//   k_p_residual      a warp per MB, 4 MBs of a row a block (128 threads),
//                     and no block-wide barrier: a warp past the row's
//                     end returns at once.  A warp's shared memory is
//                     2.9 KB, reused phase by phase.  Each 8x8 quadrant
//                     whose four blocks share one MV and whose block
//                     origins do not clamp (every quadrant of a path MV
//                     that stays out of the pad) stages one 13x13
//                     reference window, as bytes (recon samples are
//                     0..255); any other quadrant stages a 9x9 window per
//                     block with its own clamp (luma_mc_blocks').  The
//                     window rows' horizontal sums are formed once, and
//                     b, h and j of every sample come from them and the
//                     window's columns.  Luma lane 2 bl + h then holds
//                     rows 2h, 2h + 1 of raster block bl from prediction
//                     to recon: the row transforms in registers, the
//                     column transforms through a per-warp buffer, the
//                     quantiser, JVT-O079's significance (the pair of
//                     lanes by shuffle, the MB's sum by a warp reduction)
//                     and the intra-in-P SATDs (likewise).  Chroma lane
//                     16 comp + 4 b + r holds row r of 4x4 block b: the
//                     eighth-pel MC (lane 16 comp + bl forms block bl's
//                     2x2 samples), the transforms, the DC Hadamard by
//                     shuffles and the elimination by two ballots.  The
//                     recon goes out with its share of the edge pad (an
//                     MB on the picture's edge also writes the pad beside
//                     it, so that the planes leave the launch edge-padded
//                     as pad_edge pads them) as row-contiguous int4
//                     stores.  Shifts and masks of the MB's geometry
//                     index everything; the only / and % are the MB's
//                     qp % 6 and qp / 6 (and qpc's).
//   k_deblock_params  16 lanes an MB, a block of 128 threads per strip
//                     of 8 MBs of a row (blockIdx.y the row, so no / or
//                     %): lane (by, bx) loads its block's levels as four
//                     int4 words OR-ed together, its MV and reference,
//                     and across a filtered MB edge the neighbour MB's
//                     block beside it, all before the first use; the
//                     neighbours inside the MB come by width-16 shuffles
//                     from lanes l - 1 and l - 4.  Each lane forms the bS
//                     of 8.7.2.1 on its left and top edge segments, lanes
//                     0-5 one alpha / beta / tc0 set of the edge_params
//                     row each, and the MB's 62 int16 words are staged
//                     in a per-MB shared row and leave as 32-bit stores.
//
// What bounds them on the H100: bytes.  k_halfpel_enc reads the int32
// plane and writes four (20 B a sample: 46 MB, 14 us at 1080p): its
// shared-memory tile reads each input sample about 1.3 times (the halo)
// and forms every tap sum once, so it issues little besides its loads
// and stores.  k_p_residual reads the source, the reference windows and
// the MVs and writes the padded recon and the levels (about 55 MB, 16 us
// at 1080p).  Measured, it is bound by latency instead: an MB is one
// warp's chain of dependent steps (MVs, windows, sums, prediction,
// transforms, shuffles, recon), with 64 registers an SM holds 32 such
// warps, and a 1080p picture's 8,160 MBs take two waves of them (fewer
// registers spill and run slower).  The other two move about 1-10 MB
// (k_deblock_params' levels are 8.4 MB at 1080p) in one wave of the card,
// so what sets their pace is each lane's chain of dependent loads: at most
// two deep (the costs, then the chosen MV; the edge flags, then the
// neighbour MB's block), no load behind a store.
// PERF.md has their times beside these bounds.
//
// Rounding.  The partition and intra-in-P costs are the only floats, spelt
// with __fadd_rn / __fmul_rn in the twin's order (nvcc would contract a
// multiply and an add into an FMA): c16 = b16 + lam * 1, c168 =
// (b168[0] + b168[1]) + lam * 3, likewise c816, c88 = sum4(b88) + lam * 9
// with sum4 left to right, intra_est = f32(sum of SATDs) + lam * 24.
// Everything else is int32 with flooring >> and no / or % of a negative
// value.
#include <cstdint>
#include <cuda_runtime.h>

#include "deblock_params.cuh"
#include "halfpel_prims.cuh"
#include "transform_prims.cuh"

namespace {

constexpr int PAD = 32;
constexpr int NAUX = 62;

// the wrapper's table (p_body_fast._tables), int32 words: QUANT_MF
// (6,4,4), QUANT_V (6,4,4), QUANT_QBITS (52), the inter row of QUANT_F
// (52), QP_SCALE_CHROMA (52), DEBLOCK_ALPHA (52), DEBLOCK_BETA (52),
// DEBLOCK_TC0 (52,3) and ZIGZAG_4x4_INV (16) of core/tables.py; the four
// deblock tables from T_QPC on as deblock_params.cuh's hl::DPT_*
constexpr int T_MF = 0, T_V = 96, T_QBITS = 192, T_F = 244, T_QPC = 296,
              T_ZZ = 608;
static_assert(T_QPC + hl::DPT_TC0 + 52 * 3 == T_ZZ,
              "the deblock tables lie between T_QPC and T_ZZ");

// JVT-O079 2.3: the significance of a lone |level| == 1 by its zigzag run
// (p_device._T079), 0 from run 6 on
__device__ __forceinline__ int t079(int run) {
  return run == 0 ? 3 : run <= 2 ? 2 : run <= 5 ? 1 : 0;
}

using hl::clampi;

// raster block -> blkIdx
__device__ __forceinline__ int raster_blk(int by, int bx) {
  return ((by >> 1) << 3) | ((bx >> 1) << 2) | ((by & 1) << 1) | (bx & 1);
}

// ---------------------------------------------------------------------------
// k_part_decide
// ---------------------------------------------------------------------------
struct PdArgs {
  const float *__restrict__ c16, *__restrict__ c168;   // the full search's
  const float *__restrict__ c816, *__restrict__ c88;   // costs
  const int32_t *__restrict__ v16, *__restrict__ v168; // and integer MVs
  const int32_t *__restrict__ v816, *__restrict__ v88;
  const float* __restrict__ lam;                       // one value
  long long* __restrict__ choice;                      // (gh, gw)
  float* __restrict__ best;                            // (gh, gw)
  int32_t *__restrict__ mv, *__restrict__ part;        // (gh, gw, 16, 2),
                                                       // (gh, gw, 16)
  int n;                                               // MBs
};

constexpr int PD_THREADS = 256;   // 16 MBs a block, 16 lanes an MB

// me._PART_OF_BLK of partition scheme `choice` at raster block b
__device__ __forceinline__ int part_of(int choice, int b) {
  const int by = b >> 2, bx = b & 3;
  return choice == 0 ? 0
         : choice == 1 ? by >> 1
         : choice == 2 ? bx >> 1
                       : ((by >> 1) << 1) | (bx >> 1);
}

__device__ __forceinline__ int2 ld2(const int32_t* p) {
  return *reinterpret_cast<const int2*>(p);
}

// 16 lanes an MB, two MBs a warp; lane b takes raster block b.  Every lane
// loads the MB's nine costs (one address across the MB's lanes), forms the
// four costs in the twin's order and the first minimum, loads its block's
// MV of the chosen scheme and writes it times 4 (an MB's lanes write 128
// contiguous bytes) and its partition; lane 0 writes the choice and the
// cost.  No lane waits on another: a grid whose MB count is odd leaves the
// last warp's second half idle.
__global__ void __launch_bounds__(PD_THREADS) k_part_decide(PdArgs a) {
  const int t = blockIdx.x * PD_THREADS + threadIdx.x;
  const int m = t >> 4, b = t & 15;
  if (m >= a.n) return;
  const int ry = b >> 2, rx = b & 3;        // the block's row and column
  const float lam = a.lam[0];
  const float b16 = a.c16[m];
  const float h0 = a.c168[2 * m], h1 = a.c168[2 * m + 1];
  const float w0 = a.c816[2 * m], w1 = a.c816[2 * m + 1];
  const float q0 = a.c88[4 * m], q1 = a.c88[4 * m + 1],
              q2 = a.c88[4 * m + 2], q3 = a.c88[4 * m + 3];
  const float c16 = __fadd_rn(b16, __fmul_rn(lam, 1.0f));
  const float c168 = __fadd_rn(__fadd_rn(h0, h1), __fmul_rn(lam, 3.0f));
  const float c816 = __fadd_rn(__fadd_rn(w0, w1), __fmul_rn(lam, 3.0f));
  const float c88 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(q0, q1), q2), q3), __fmul_rn(lam, 9.0f));
  // the first minimum, as argmin
  int ch = 0;
  float cost = c16;
  if (c168 < cost) ch = 1, cost = c168;
  if (c816 < cost) ch = 2, cost = c816;
  if (c88 < cost) ch = 3, cost = c88;
  // the chosen partition's integer MV: one 8-byte load after the choice
  // (cheaper on the card than every scheme's MV loaded up front, as the
  // inputs sit in L2 after the full search)
  const int2 v = ld2(ch == 0   ? a.v16 + 2 * m
                     : ch == 1 ? a.v168 + 4 * m + 2 * (ry >> 1)
                     : ch == 2 ? a.v816 + 4 * m + 2 * (rx >> 1)
                               : a.v88 + 8 * m + 2 * (((ry >> 1) << 1) |
                                                      (rx >> 1)));
  const size_t o = (size_t)m * 16 + b;
  *reinterpret_cast<int2*>(a.mv + 2 * o) = make_int2(v.x * 4, v.y * 4);
  a.part[o] = part_of(ch, b);
  if (b == 0) {
    a.choice[m] = ch;
    a.best[m] = cost;
  }
}

// ---------------------------------------------------------------------------
// k_halfpel_enc
// ---------------------------------------------------------------------------
constexpr int HP_TW = 64;                // a block's output tile: columns
constexpr int HP_TH = 16;                // and rows
constexpr int HP_THREADS = 256;          // a thread per 4 samples of a row
constexpr int HP_GW = HP_TW + 8;         // G's staged row: 4 halo columns a
                                         // side (2 and 3 are read), so that
                                         // column x0 is int4-aligned
constexpr int HP_ROWS = HP_TH + 5;       // staged rows: 2 above, 3 below
constexpr int HP_SMEM_WORDS = HP_ROWS * (HP_GW + HP_TW);
constexpr int HP_SMEM_BYTES = HP_SMEM_WORDS * 4;
static_assert(HP_THREADS * 4 == HP_TW * HP_TH && HP_TW == 64,
              "k_halfpel_enc maps a thread to 4 samples of a 64-wide row");

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}
__device__ __forceinline__ void st4(int* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}
__device__ __forceinline__ int4 splat4(int v) { return make_int4(v, v, v, v); }

// The 6-tap sum of p[0], p[s], ..., p[5 s] (halfpel_prims.cuh's taps;
// integer, so any order)
template <class T>
__device__ __forceinline__ int tap6(const T* p, int s) {
  return (int)p[0] - 5 * (int)p[s] + 20 * (int)p[2 * s] +
         20 * (int)p[3 * s] - 5 * (int)p[4 * s] + (int)p[5 * s];
}

// A block per 64 x 16 tile of the padded plane: G of the tile and its halo
// staged once (each coordinate clamped to the plane, the twin's
// _edge_pad(..., 2, 3)), the horizontal sums H1 of every staged row once,
// then b from H1, h from G's columns and j as the vertical 6-tap over H1;
// each thread writes 4 samples of a row to each of the four planes.
__global__ void __launch_bounds__(HP_THREADS)
    k_halfpel_enc(const int32_t* __restrict__ plane, int stride, int hp,
                  int wp, int32_t* __restrict__ out) {
  extern __shared__ int smem[];
  int* sg = smem;                          // [HP_ROWS][HP_GW] G
  int* sh = smem + HP_ROWS * HP_GW;        // [HP_ROWS][HP_TW] H1
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * HP_TW, y0 = blockIdx.y * HP_TH;
  // staged row r is plane row y0 - 2 + r, staged column c plane column
  // x0 - 4 + c
  for (int r = tid >> 5; r < HP_ROWS; r += HP_THREADS / 32) {
    const int32_t* row =
        plane + (size_t)clampi(0, hp - 1, y0 - 2 + r) * stride;
    for (int c = tid & 31; c < HP_GW; c += 32)
      sg[r * HP_GW + c] = row[clampi(0, wp - 1, x0 - 4 + c)];
  }
  __syncthreads();
  for (int i = tid; i < HP_ROWS * (HP_TW / 4); i += HP_THREADS) {
    const int r = i >> 4, c = (i & 15) << 2;
    const int4 g0 = ld4(sg + r * HP_GW + c), g1 = ld4(sg + r * HP_GW + c + 4),
               g2 = ld4(sg + r * HP_GW + c + 8);
    // G at columns c - 4 .. c + 7 of the tile: b at c + k sums c + k - 2
    // .. c + k + 3
    const int g[12] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y,
                       g1.z, g1.w, g2.x, g2.y, g2.z, g2.w};
    st4(sh + r * HP_TW + c, make_int4(tap6(g + 2, 1), tap6(g + 3, 1),
                                      tap6(g + 4, 1), tap6(g + 5, 1)));
  }
  __syncthreads();
  const int r = tid >> 4, c = (tid & 15) << 2;
  const int y = y0 + r, x = x0 + c;
  if (y >= hp || x >= wp) return;
  int v[4][4];                             // [plane][sample]
  for (int k = 0; k < 4; ++k) {
    const int* gc = sg + r * HP_GW + c + 4 + k;   // G rows y - 2 .. y + 3
    const int* hc = sh + r * HP_TW + c + k;       // H1 rows y - 2 .. y + 3
    v[0][k] = gc[2 * HP_GW];
    v[1][k] = hp_round5(hc[2 * HP_TW]);
    v[2][k] = hp_round5(tap6(gc, HP_GW));
    v[3][k] = hp_round10(tap6(hc, HP_TW));
  }
  const size_t n = (size_t)hp * wp;
  int32_t* o = out + (size_t)y * wp + x;
  if ((wp & 3) == 0 && ((uintptr_t)out & 15) == 0 && x + 4 <= wp) {
    for (int p = 0; p < 4; ++p)
      st4(o + p * n, make_int4(v[p][0], v[p][1], v[p][2], v[p][3]));
  } else {
    for (int p = 0; p < 4; ++p)
      for (int k = 0; k < 4 && x + k < wp; ++k) o[p * n + k] = v[p][k];
  }
}

// ---------------------------------------------------------------------------
// k_p_residual
// ---------------------------------------------------------------------------
struct PrArgs {
  const int32_t *sy, *su, *sv;    // PAD-padded source planes
  const int32_t *ry, *ru, *rv;    // PAD-padded reference planes
  const int32_t* mv;              // (gh, gw, 16, 2) quarter-pel, raster
  const int32_t* qp;              // (gh, gw)
  const float* best;              // (gh, gw) the inter cost, or null
  const float* lam;               // one value
  const int32_t* tab;
  int32_t *wq, *dcq, *acq;        // (gh,gw,16,4,4), (gh,gw,2,2,2),
                                  // (gh,gw,2,4,4,4)
  int32_t *oy, *ou, *ov;          // recon, (16 gh + 2 PAD, 16 gw + 2 PAD)
                                  // and (8 gh + 2 PAD, 8 gw + 2 PAD)
  uint8_t* mask;                  // (gh, gw) intra-in-P, or null
  int sy_st, su_st, sv_st;        // the planes' row strides
  int ry_st, ru_st, rv_st;
  int ry_h, ry_w, rc_h, rc_w;     // the reference planes' dims
  int gw, gh, cqo;
};

constexpr int PR_MBS = 4;                 // MBs a block, a warp each
constexpr int PR_THREADS = PR_MBS * 32;
constexpr unsigned FULL = 0xffffffffu;
// A warp's shared memory, bytes.  Until the prediction is formed:
constexpr int PR_WIN = 0;                 // [4 quadrants][324] luma windows,
                                          // one 13x13 or four 9x9, bytes
constexpr int PR_H1 = PR_WIN + 4 * 324;   // [4][144] int16 H1 sums: 13x8
                                          // or four 9x4
// then, over the windows and sums:
constexpr int PR_XL = 0;                  // [16 blocks][4][4] int32 rows
constexpr int PR_XC = PR_XL + 1024;       // [2][4 blocks][4][4] int32 rows
constexpr int PR_REC = PR_XC + 512;       // [16][16] + [2][8][8] recon bytes
// throughout:
constexpr int PR_PC = PR_H1 + 4 * 144 * 2;    // [2][8][8] chroma prediction
constexpr int PR_TAB = PR_PC + 128;       // int32: the MB's QUANT_MF and
                                          // 16 QUANT_V rows, luma (qp % 6)
                                          // then chroma (qpc % 6), the
                                          // zigzag table, and QUANT_F and
                                          // QUANT_QBITS of qp and qpc
constexpr int PR_WARP_BYTES = PR_TAB + 96 * 4;
constexpr int PR_SMEM_BYTES = PR_MBS * PR_WARP_BYTES;
static_assert(PR_REC + 384 <= PR_PC && PR_WARP_BYTES % 16 == 0 &&
                  PR_TAB % 16 == 0,
              "k_p_residual's per-warp layout");

// quarter-pel case 4 fy + fx -> the two half-pel samples averaged as
// (A + B + 1) >> 1, (plane, dx, dy) each; planes 0 G, 1 b, 2 h, 3 j
// (ops/wide._QPT: b is only offset down, h only right)
__constant__ int PR_QPT[16 * 6] = {
    0, 0, 0, 0, 0, 0,  0, 0, 0, 1, 0, 0,  1, 0, 0, 1, 0, 0,
    1, 0, 0, 0, 1, 0,  0, 0, 0, 2, 0, 0,  1, 0, 0, 2, 0, 0,
    1, 0, 0, 3, 0, 0,  1, 0, 0, 2, 1, 0,  2, 0, 0, 2, 0, 0,
    2, 0, 0, 3, 0, 0,  3, 0, 0, 3, 0, 0,  3, 0, 0, 2, 1, 0,
    2, 0, 0, 0, 0, 1,  2, 0, 0, 1, 0, 1,  3, 0, 0, 1, 0, 1,
    2, 1, 0, 1, 0, 1};

__device__ __forceinline__ unsigned quad_lanes(int q) {
  // the lanes 2 bl + h of quadrant q's raster blocks bl
  return 0x0F0Fu << (4 * (q & 1) + 16 * (q >> 1));
}

// A lane's 8 samples (2 rows, 4 columns) of half-pel plane p at offset
// (dx, dy).  wl is the unit's window (row stride WS) two rows and two
// columns above-left of the lane's first sample; hl the window rows'
// horizontal 6-tap sums at the unit's columns (row stride HS), at the
// lane's first column and two rows above its first sample: G reads the
// window, b one sum, h six window rows of a column and j six sums
// (luma_mc_blocks' bank, value by value).
template <int WS, int HS>
__device__ __forceinline__ void plane8(const uint8_t* wl, const int16_t* hl,
                                       int p, int dx, int dy, int* v) {
  if (p == 0) {
    const uint8_t* g = wl + (2 + dy) * WS + 2 + dx;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[i * 4 + c] = g[i * WS + c];
  } else if (p == 1) {
    const int16_t* h = hl + (2 + dy) * HS;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[i * 4 + c] = hp_round5(h[i * HS + c]);
  } else if (p == 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint8_t* col = wl + 2 + dx + c;
      int t[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) t[k] = col[k * WS];
      v[c] = hp_round5(tap6(t, 1));
      v[4 + c] = hp_round5(tap6(t + 1, 1));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int t[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) t[k] = hl[k * HS + c];
      v[c] = hp_round10(tap6(t, 1));
      v[4 + c] = hp_round10(tap6(t + 1, 1));
    }
  }
}

// The lane's 8 quarter-pel prediction samples of case fcase: the two
// planes of PR_QPT averaged (one plane where both are the same sample)
template <int WS, int HS>
__device__ __forceinline__ void luma_pred(const uint8_t* wl,
                                          const int16_t* hl, int fcase,
                                          int* pred) {
  const int* t = PR_QPT + 6 * fcase;
  int b[8];
  plane8<WS, HS>(wl, hl, t[0], t[1], t[2], pred);
  if (t[0] == t[3] && t[1] == t[4] && t[2] == t[5]) return;
  plane8<WS, HS>(wl, hl, t[3], t[4], t[5], b);
#pragma unroll
  for (int k = 0; k < 8; ++k) pred[k] = (pred[k] + b[k] + 1) >> 1;
}

// One 1-D stage of the forward core transform, all four elements of C x
// (transform_prims.cuh's fwd_coef rows as butterflies; integer, so any
// order)
__device__ __forceinline__ void fwd4(const int* x, int* y) {
  const int s03 = x[0] + x[3], d03 = x[0] - x[3];
  const int s12 = x[1] + x[2], d12 = x[1] - x[2];
  y[0] = s03 + s12;
  y[1] = 2 * d03 + d12;
  y[2] = s03 - s12;
  y[3] = d03 - 2 * d12;
}

// The 2x2 Hadamard (transform_prims.cuh's hadamard2) of the values v of
// the four lanes lane ^ {0, 4, 8, 12}, element (r, s) = ((lane >> 3) & 1,
// (lane >> 2) & 1) on each: a butterfly along r, then along s
__device__ __forceinline__ int hadamard2_lanes(int v, int lane) {
  const int o = __shfl_xor_sync(FULL, v, 8);
  const int q = (lane & 8) ? o - v : v + o;
  const int p = __shfl_xor_sync(FULL, q, 4);
  return (lane & 4) ? p - q : q + p;
}

__device__ __forceinline__ void load4(const int32_t* p, bool vec, int* v) {
  if (vec) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    for (int k = 0; k < 4; ++k) v[k] = p[k];
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Write an MB's S x S recon `rec` (bytes, row stride S) into the padded
// plane `out` (row stride wp, contiguous, 16-byte aligned rows) with its
// share of the edge pad: the rows and columns of the pad beside a
// picture-edge MB, and the corner beside a corner MB, each sample the
// recon's at its position clamped into the MB.  Four samples an int4
// store, a row's stores on neighbouring lanes.
template <int S>
__device__ void put_owned(int32_t* out, int wp, const uint8_t* rec, int mx,
                          int my, int gw, int gh, int lane) {
  const int oy = PAD + S * my, ox = PAD + S * mx;
  const int y0 = my == 0 ? 0 : oy, y1 = oy + S + (my == gh - 1 ? PAD : 0);
  const int x0 = mx == 0 ? 0 : ox, x1 = ox + S + (mx == gw - 1 ? PAD : 0);
  const int cn = (x1 - x0) >> 2;          // S / 4, + 8 at each edge
  const int lg = cn <= 2 ? 1 : cn <= 4 ? 2 : cn <= 16 ? 4 : 5;
  const int c = lane & ((1 << lg) - 1), x = x0 + 4 * c;
  if (c >= cn) return;
  for (int y = y0 + (lane >> lg); y < y1; y += 32 >> lg) {
    const uint8_t* rr = rec + clampi(0, S - 1, y - oy) * S;
    const int4 v = x < ox       ? splat4(rr[0])
                   : x >= ox + S ? splat4(rr[S - 1])
                                 : make_int4(rr[x - ox], rr[x - ox + 1],
                                             rr[x - ox + 2], rr[x - ox + 3]);
    st4(out + (size_t)y * wp + x, v);
  }
}

// A warp per MB, PR_MBS MBs of a row a block; nothing waits on more than
// its warp.  Lanes: luma lane 2 bl + h takes rows 2h, 2h + 1 of raster
// block bl (its 8 prediction samples, residuals, coefficients and recon
// samples); chroma lane 16 comp + 4 b + r takes row r of the component's
// 4x4 block b (and, for the MC, lane 16 comp + bl the 2x2 samples of
// block bl).  Every global load that does not wait for another is issued
// before the first shared-memory step.
__global__ void __launch_bounds__(PR_THREADS) k_p_residual(PrArgs a) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mx = blockIdx.x * PR_MBS + warp, my = blockIdx.y;
  if (mx >= a.gw) return;        // past the row's end: no barrier waits
  uint8_t* ws = reinterpret_cast<uint8_t*>(smem) + warp * PR_WARP_BYTES;
  int* tb = reinterpret_cast<int*>(ws + PR_TAB);
  const int mb = my * a.gw + mx;
  const int* tab = a.tab;
  // lane 2 bl + k holds component k of raster block bl's MV
  const int mvw = a.mv[(size_t)mb * 32 + lane];
  const int qp = a.qp[mb];
  const int bl = lane >> 1, hh = lane & 1, by = bl >> 2, bx = bl & 3;
  const int comp = lane >> 4, cb4 = (lane >> 2) & 3, cr = lane & 3;
  const int cy = (cb4 >> 1) * 4 + cr, cx0 = (cb4 & 1) * 4;
  int src[8], csrc[4];
  {
    const int32_t* s0 = a.sy + (size_t)(PAD + my * 16 + by * 4 + 2 * hh) *
                                   a.sy_st + PAD + mx * 16 + bx * 4;
    const bool vy = aligned16(a.sy) && (a.sy_st & 3) == 0;
    load4(s0, vy, src);
    load4(s0 + a.sy_st, vy, src + 4);
    const int st = comp ? a.sv_st : a.su_st;
    const int32_t* cs = comp ? a.sv : a.su;
    load4(cs + (size_t)(PAD + my * 8 + cy) * st + PAD + mx * 8 + cx0,
          aligned16(cs) && (st & 3) == 0, csrc);
  }
  const int qpc = tab[T_QPC + clampi(0, 51, qp + a.cqo)];
  // the MB's table rows (PR_TAB's order), stored with the windows
  const int lo = lane & 15;
  const int t0 = tab[(lane < 16 ? T_MF : T_V) + (qp % 6) * 16 + lo];
  const int t1 = tab[(lane < 16 ? T_MF : T_V) + (qpc % 6) * 16 + lo];
  const int t2 = tab[lane < 16 ? T_ZZ + lane : lane == 16 ? T_F + qp
                     : lane == 17 ? T_QBITS + qp : lane == 18 ? T_F + qpc
                                                  : T_QBITS + qpc];

  // ---- luma lanes' blocks, their clamped origins and the quadrants
  const int mvx = __shfl_sync(FULL, mvw, lane & ~1);
  const int mvy = __shfl_sync(FULL, mvw, lane | 1);
  const int ux = mx * 16 + bx * 4 + (mvx >> 2);
  const int uy = my * 16 + by * 4 + (mvy >> 2);
  const int xi = clampi(-(PAD - 2), a.ry_w - PAD - 7, ux);
  const int yi = clampi(-(PAD - 2), a.ry_h - PAD - 7, uy);
  const int q = ((by >> 1) << 1) | (bx >> 1);
  const int lq = ((by & 2) << 3) | ((bx & 2) << 1);   // its first block's
  const int qmvx = __shfl_sync(FULL, mvx, lq);         // lane
  const int qmvy = __shfl_sync(FULL, mvy, lq);
  // a quadrant is split where a block's MV differs from its first
  // block's or any block's origin clamps
  const unsigned split = __ballot_sync(
      FULL, xi != ux || yi != uy || mvx != qmvx || mvy != qmvy);

  // ---- chroma MC windows: lane 16 comp + cb loads block cb's 3x3
  const int cb = lane & 15;
  const int cmx = __shfl_sync(FULL, mvw, 2 * cb);
  const int cmy = __shfl_sync(FULL, mvw, 2 * cb + 1);
  int cw[9];
  {
    const int cxi = clampi(-(PAD - 1), a.rc_w - PAD - 4,
                           mx * 8 + (cb & 3) * 2 + (cmx >> 3));
    const int cyi = clampi(-(PAD - 1), a.rc_h - PAD - 4,
                           my * 8 + (cb >> 2) * 2 + (cmy >> 3));
    const int st = comp ? a.rv_st : a.ru_st;
    const int32_t* c0 =
        (comp ? a.rv : a.ru) + (size_t)(cyi + PAD) * st + cxi + PAD;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) cw[r * 3 + c] = c0[(size_t)r * st + c];
  }

  // ---- the luma windows: lanes 8 sq .. 8 sq + 7 stage quadrant sq's
  const int sq = lane >> 3, sub = lane & 7, sk = sub >> 1;
  const bool sq_whole = (split & quad_lanes(sq)) == 0;
  const int sbl = ((sq >> 1) * 2 + (sk >> 1)) * 4 + (sq & 1) * 2 + (sk & 1);
  const int slane = sq_whole ? ((sq >> 1) << 4) | ((sq & 1) << 2) : 2 * sbl;
  const int sx = __shfl_sync(FULL, xi, slane);
  const int sy = __shfl_sync(FULL, yi, slane);
  const int sfx = __shfl_sync(FULL, mvx, slane) & 3;
  uint8_t* win = ws + PR_WIN + sq * 324;
  int16_t* h1 = reinterpret_cast<int16_t*>(ws + PR_H1) + sq * 144;
  {
    const int32_t* rw =
        a.ry + (size_t)(sy + PAD - 2) * a.ry_st + sx + PAD - 2;
    if (sq_whole) {               // one 13x13 window, columns sub, sub + 8
#pragma unroll
      for (int r = 0; r < 13; ++r) {
        win[r * 13 + sub] = (uint8_t)rw[(size_t)r * a.ry_st + sub];
        if (sub < 5)
          win[r * 13 + 8 + sub] = (uint8_t)rw[(size_t)r * a.ry_st + 8 + sub];
      }
    } else {                      // block sk's 9x9, rows sub & 1 + 2t
      uint8_t* wk = win + sk * 81;
      for (int r = sub & 1; r < 9; r += 2)
        for (int c = 0; c < 9; ++c)
          wk[r * 9 + c] = (uint8_t)rw[(size_t)r * a.ry_st + c];
    }
  }

  // ---- chroma MC: lane 16 comp + cb forms block cb's 2x2 samples
  uint8_t* pc = ws + PR_PC;
  {
    const int dx = cmx & 7, dy = cmy & 7;
    uint8_t* o = pc + comp * 64 + (cb >> 2) * 16 + (cb & 3) * 2;
#pragma unroll
    for (int iy = 0; iy < 2; ++iy)
#pragma unroll
      for (int ix = 0; ix < 2; ++ix)
        o[iy * 8 + ix] = (uint8_t)(((8 - dx) * (8 - dy) * cw[iy * 3 + ix] +
                                    dx * (8 - dy) * cw[iy * 3 + ix + 1] +
                                    (8 - dx) * dy * cw[(iy + 1) * 3 + ix] +
                                    dx * dy * cw[(iy + 1) * 3 + ix + 1] +
                                    32) >> 6);
  }
  tb[lane] = t0;
  tb[32 + lane] = t1;
  if (lane < 20) tb[64 + lane] = t2;
  __syncwarp();
  if (sfx != 0) {                 // b or j: the rows' sums, once each
    if (sq_whole) {
#pragma unroll
      for (int r = 0; r < 13; ++r)
        h1[r * 8 + sub] = (int16_t)tap6(win + r * 13 + sub, 1);
    } else {
      const uint8_t* wk = win + sk * 81;
      int16_t* hk = h1 + sk * 36;
      for (int r = 0; r < 9; ++r)
        for (int c = 2 * (sub & 1); c < 2 * (sub & 1) + 2; ++c)
          hk[r * 4 + c] = (int16_t)tap6(wk + r * 9 + c, 1);
    }
  }
  __syncwarp();

  // ---- luma prediction
  int pred[8];
  {
    const int fcase = ((mvy & 3) << 2) | (mvx & 3);
    const uint8_t* w = ws + PR_WIN + q * 324;
    const int16_t* hs = reinterpret_cast<const int16_t*>(ws + PR_H1) +
                        q * 144;
    if ((split & quad_lanes(q)) == 0) {
      const int iy0 = ((by & 1) << 2) + 2 * hh, ix0 = (bx & 1) << 2;
      luma_pred<13, 8>(w + iy0 * 13 + ix0, hs + iy0 * 8 + ix0, fcase, pred);
    } else {
      const int k = ((by & 1) << 1) | (bx & 1);     // block in the quadrant
      luma_pred<9, 4>(w + k * 81 + 2 * hh * 9, hs + k * 36 + 2 * hh * 4,
                      fcase, pred);
    }
  }
  __syncwarp();                  // the windows and sums are dead from here

  // ---- intra estimate: the SATD of each 4x4 block against its mean
  int satd = 0;
  if (a.mask) {
    int s = 0;
    for (int k = 0; k < 8; ++k) s += src[k];
    const int dc = (s + __shfl_xor_sync(FULL, s, 1)) >> 4;   // sum >= 0
    int pa[4], pb[4];            // the rows' Hadamard, summed and differed
    for (int c = 0; c < 4; ++c) {
      int hr[2];
      for (int i = 0; i < 2; ++i) {
        const int* d = src + i * 4;
        const int d0 = d[0] - dc, d1 = d[1] - dc, d2 = d[2] - dc,
                  d3 = d[3] - dc;
        hr[i] = c == 0 ? d0 + d1 + d2 + d3
                : c == 1 ? d0 + d1 - d2 - d3
                : c == 2 ? d0 - d1 - d2 + d3
                         : d0 - d1 + d2 - d3;
      }
      pa[c] = hr[0] + hr[1];
      pb[c] = hr[0] - hr[1];
    }
    // rows 0, 1 (lane h 0) and 2, 3 (h 1): the column stage's outputs are
    // pa0 +- pa1 and pb0 -+ pb1; each lane takes two
    int p = 0;
    for (int c = 0; c < 4; ++c) {
      const int got = __shfl_xor_sync(FULL, hh ? pa[c] : pb[c], 1);
      const int e0 = hh ? got - pb[c] : pa[c] + got;
      const int e1 = hh ? got + pb[c] : pa[c] - got;
      p += (e0 < 0 ? -e0 : e0) + (e1 < 0 ? -e1 : e1);
    }
    const int blk = (p + __shfl_xor_sync(FULL, p, 1)) >> 1;
    satd = (int)__reduce_add_sync(FULL, hh ? 0u : (unsigned)blk);
  }

  // ---- forward transform: rows in the lane, columns through the buffer
  int* xl = reinterpret_cast<int*>(ws + PR_XL) + bl * 16;
  int* xc = reinterpret_cast<int*>(ws + PR_XC) + (comp * 4 + cb4) * 16;
  const uint8_t* pcr = pc + comp * 64 + cy * 8 + cx0;
  for (int i = 0; i < 2; ++i) {
    int res[4], y[4];
    for (int c = 0; c < 4; ++c) res[c] = src[i * 4 + c] - pred[i * 4 + c];
    fwd4(res, y);
    st4(xl + (2 * hh + i) * 4, make_int4(y[0], y[1], y[2], y[3]));
  }
  {
    int res[4], y[4];
    for (int c = 0; c < 4; ++c) res[c] = csrc[c] - pcr[c];
    fwd4(res, y);
    st4(xc + cr * 4, make_int4(y[0], y[1], y[2], y[3]));
  }
  __syncwarp();
  int z[8], cz[4], cdc;
  const int lf = tb[80], lqb = tb[81], cf = tb[82], cqb = tb[83];
  {
    int t[4][4], y[4];           // t: [column][row]
    for (int i = 0; i < 4; ++i) {
      const int4 v = ld4(xl + i * 4);
      t[0][i] = v.x, t[1][i] = v.y, t[2][i] = v.z, t[3][i] = v.w;
    }
    const int4 m0 = ld4(tb + 8 * hh), m1 = ld4(tb + 8 * hh + 4);
    const int mf[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    for (int v = 0; v < 4; ++v) {   // rows 2h, 2h + 1 of column v
      fwd4(t[v], y);
      z[v] = quant(hh ? y[2] : y[0], mf[v], lf, lqb);
      z[4 + v] = quant(hh ? y[3] : y[1], mf[4 + v], lf, lqb);
    }
    for (int i = 0; i < 4; ++i) {
      const int4 v = ld4(xc + i * 4);
      t[0][i] = v.x, t[1][i] = v.y, t[2][i] = v.z, t[3][i] = v.w;
    }
    const int4 cm = ld4(tb + 32 + 4 * cr);
    const int cmf[4] = {cm.x, cm.y, cm.z, cm.w};
    for (int v = 0; v < 4; ++v) {   // row cr of column v
      fwd4(t[v], y);
      const int w = cr == 0 ? y[0] : cr == 1 ? y[1] : cr == 2 ? y[2] : y[3];
      if (v == 0) cdc = w;        // the block's DC, on lanes with cr == 0
      cz[v] = cr == 0 && v == 0 ? 0            // skip_dc
              : quant(w, cmf[v], cf, cqb);
    }
  }

  // ---- luma: JVT-O079 significance of each block, the MB's sum, levels
  int drop;
  {
    const int4 z0 = ld4(tb + 64 + 8 * hh), z1 = ld4(tb + 68 + 8 * hh);
    const int zz[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
    int nz = 0, run = 16, amax = 0;
    for (int k = 0; k < 8; ++k) {
      const int az = z[k] < 0 ? -z[k] : z[k];
      if (az > 0) {
        ++nz;
        run = min(run, zz[k]);
        amax = max(amax, az);
      }
    }
    nz += __shfl_xor_sync(FULL, nz, 1);
    run = min(run, __shfl_xor_sync(FULL, run, 1));
    amax = max(amax, __shfl_xor_sync(FULL, amax, 1));
    const int ctr = nz == 0 ? 0 : (nz == 1 && amax == 1) ? t079(run) : 9;
    drop = (int)__reduce_add_sync(FULL, hh ? 0u : (unsigned)ctr) < 6;
  }
  if (drop)
    for (int k = 0; k < 8; ++k) z[k] = 0;
  {
    int32_t* o = a.wq + (size_t)mb * 256 + raster_blk(by, bx) * 16 + hh * 8;
    st4(o, make_int4(z[0], z[1], z[2], z[3]));
    st4(o + 4, make_int4(z[4], z[5], z[6], z[7]));
  }

  // ---- chroma: DC Hadamard and quantiser, the elimination, levels
  // lanes 16 comp + 4 b hold block b's DC: element b of the Hadamard
  const int dq = quant(hadamard2_lanes(cdc, lane), tb[32], 2 * cf, cqb + 1);
  if (cr == 0) a.dcq[(size_t)mb * 8 + comp * 4 + cb4] = dq;
  {
    int cn = 0, cmax = 0;
    for (int v = 0; v < 4; ++v) {
      const int az = cz[v] < 0 ? -cz[v] : cz[v];
      cn += az > 0;
      cmax = max(cmax, az);
    }
    // a component whose one nonzero AC level is +-1 drops it
    const unsigned nzl = __ballot_sync(FULL, cn > 0);
    const unsigned lone = __ballot_sync(FULL, cn == 1 && cmax == 1);
    const unsigned cm = nzl & (comp ? 0xFFFF0000u : 0x0000FFFFu);
    if (__popc(cm) == 1 && (lone & cm) == cm)
      for (int v = 0; v < 4; ++v) cz[v] = 0;
  }
  st4(a.acq + (size_t)mb * 128 + comp * 64 + cb4 * 16 + cr * 4,
      make_int4(cz[0], cz[1], cz[2], cz[3]));

  // ---- dequantisation
  int d[8], cd[4];
  {
    const int4 v0 = ld4(tb + 16 + 8 * hh), v1 = ld4(tb + 20 + 8 * hh);
    const int lv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    for (int k = 0; k < 8; ++k) d[k] = dequant(z[k], 16 * lv[k], qp);
    const int4 cv = ld4(tb + 48 + 4 * cr);
    const int lc[4] = {cv.x, cv.y, cv.z, cv.w};
    // chroma_dc_descale of the DC levels' Hadamard, on lanes with cr == 0
    const int f = hadamard2_lanes(dq, lane);
    for (int v = 0; v < 4; ++v)
      cd[v] = cr == 0 && v == 0
                  ? (f * (16 * lc[0]) * (1 << (qpc / 6))) >> 5
                  : dequant(cz[v], 16 * lc[v], qpc);
  }

  // ---- inverse transform: rows in the lane, columns through the buffer
  __syncwarp();                  // every lane has read the forward rows
  for (int i = 0; i < 2; ++i) {
    const int* r = d + i * 4;
    st4(xl + (2 * hh + i) * 4,
        make_int4(ict(r[0], r[1], r[2], r[3], 0), ict(r[0], r[1], r[2], r[3], 1),
                  ict(r[0], r[1], r[2], r[3], 2),
                  ict(r[0], r[1], r[2], r[3], 3)));
  }
  st4(xc + cr * 4, make_int4(ict(cd[0], cd[1], cd[2], cd[3], 0),
                             ict(cd[0], cd[1], cd[2], cd[3], 1),
                             ict(cd[0], cd[1], cd[2], cd[3], 2),
                             ict(cd[0], cd[1], cd[2], cd[3], 3)));
  __syncwarp();
  // the recon: each lane's rows straight to the plane; an MB on the
  // picture's edge also stages it for its share of the pad
  const int wy = a.gw * 16 + 2 * PAD, wc = a.gw * 8 + 2 * PAD;
  const bool edge = mx == 0 || my == 0 || mx == a.gw - 1 || my == a.gh - 1;
  uint8_t* rec = ws + PR_REC;
  {
    int f[4][4];                 // [column][row]
    for (int i = 0; i < 4; ++i) {
      const int4 v = ld4(xl + i * 4);
      f[0][i] = v.x, f[1][i] = v.y, f[2][i] = v.z, f[3][i] = v.w;
    }
    for (int i = 0; i < 2; ++i) {
      const int y = by * 4 + 2 * hh + i;
      int o[4];
      for (int c = 0; c < 4; ++c)
        o[c] = clip255(pred[i * 4 + c] +
                       ((ict(f[c][0], f[c][1], f[c][2], f[c][3], y & 3) +
                         32) >> 6));
      st4(a.oy + (size_t)(PAD + my * 16 + y) * wy + PAD + mx * 16 + bx * 4,
          make_int4(o[0], o[1], o[2], o[3]));
      if (edge)
        for (int c = 0; c < 4; ++c) rec[y * 16 + bx * 4 + c] = (uint8_t)o[c];
    }
    for (int i = 0; i < 4; ++i) {
      const int4 v = ld4(xc + i * 4);
      f[0][i] = v.x, f[1][i] = v.y, f[2][i] = v.z, f[3][i] = v.w;
    }
    int o[4];
    for (int c = 0; c < 4; ++c)
      o[c] = clip255(pcr[c] +
                     ((ict(f[c][0], f[c][1], f[c][2], f[c][3], cr) + 32) >> 6));
    st4((comp ? a.ov : a.ou) + (size_t)(PAD + my * 8 + cy) * wc + PAD +
            mx * 8 + cx0,
        make_int4(o[0], o[1], o[2], o[3]));
    if (edge)
      for (int c = 0; c < 4; ++c)
        rec[256 + comp * 64 + cy * 8 + cx0 + c] = (uint8_t)o[c];
  }
  if (edge) {                    // warp-uniform
    __syncwarp();
    put_owned<16>(a.oy, wy, rec, mx, my, a.gw, a.gh, lane);
    put_owned<8>(a.ou, wc, rec + 256, mx, my, a.gw, a.gh, lane);
    put_owned<8>(a.ov, wc, rec + 320, mx, my, a.gw, a.gh, lane);
  }
  if (a.mask && lane == 0) {
    const float est = __fadd_rn((float)satd, __fmul_rn(a.lam[0], 24.0f));
    a.mask[mb] = est < a.best[mb];
  }
}

// ---------------------------------------------------------------------------
// k_deblock_params
// ---------------------------------------------------------------------------
struct DpArgs {
  const int32_t* __restrict__ wq;   // (gh, gw, 16, 4, 4) luma levels, blkIdx
                                    // order, 16-byte aligned
  const int32_t* __restrict__ mv;   // (gh, gw, 4, 4, 2), 8-byte aligned
  const int32_t* __restrict__ ref;  // (gh, gw, 4, 4)
  const uint8_t* __restrict__ intra;  // (gh, gw) bool
  const int32_t* __restrict__ qp;     // (gh, gw)
  const uint8_t *__restrict__ fv, *__restrict__ fh;  // (gh, gw) MB edge
                                    // flags, or null (inside the picture)
  const int32_t* __restrict__ tab;
  int16_t* __restrict__ aux;        // (gh, gw, NAUX), 4-byte aligned
  int gw, gh, cqo;
};

constexpr int DP_MBS = 8;                  // MBs of a row a block
constexpr int DP_THREADS = DP_MBS * 16;    // 16 lanes an MB, one a 4x4 block
constexpr int DP_ROW = 64;                 // int16 words of an MB's staged row
constexpr int DP_SMEM_BYTES = DP_MBS * DP_ROW * 2;
static_assert(NAUX <= DP_ROW && NAUX % 2 == 0 && NAUX / 2 <= 32,
              "k_deblock_params stages an MB's row as 32-bit words, two a "
              "lane");

// Whether a 4x4 block's 16 levels (four 16-byte words) hold a nonzero one
__device__ __forceinline__ bool any_level(const int4* w) {
  const int4 x = w[0], y = w[1], z = w[2], u = w[3];
  return ((x.x | x.y | x.z | x.w) | (y.x | y.y | y.z | y.w) |
          (z.x | z.y | z.z | z.w) | (u.x | u.y | u.z | u.w)) != 0;
}

__device__ __forceinline__ const int4* levels(const DpArgs& a, int m,
                                              int by, int bx) {
  return reinterpret_cast<const int4*>(
      a.wq + ((size_t)m * 16 + raster_blk(by, bx)) * 16);
}

// bS of the edge between block q and its neighbour p (8.7.2.1, as
// ops/wide.compute_bs_grids: 3 for an intra edge inside the MB)
__device__ __forceinline__ int edge_bs(bool intra, bool nz, int2 vq, int2 vp,
                                       int rq, int rp, bool internal) {
  const int bs = hl::bs_rule(intra, nz, vq, vp, rq, rp);
  return internal && bs == 4 ? 3 : bs;
}

// 16 lanes an MB, a block per strip of DP_MBS MBs of a row (blockIdx.y the
// row).  Lane (by, bx) makes every load before it uses one: its block's
// levels (OR-ed, no early exit), MV and reference, the MB's intra flag and
// qp, and where its left (top) edge is an MB edge that is filtered the
// same of the left (top) MB's block beside it.  The neighbours inside the
// MB come from lanes l - 1 and l - 4 by shuffles, so each block's levels
// are read once, the MB edge blocks twice.  Each lane forms the bS of its
// block's left and top edge segments, lanes 0-5 one of the six (alpha,
// beta, tc0) sets each (the luma left, top and internal edges, then the
// chroma ones), and the MB's NAUX int16 words leave through a per-MB row
// of shared memory as 32-bit stores.  A strip past the row's end works on
// the row's last MB and stores nothing, so the shuffles see full warps.
__global__ void __launch_bounds__(DP_THREADS) k_deblock_params(DpArgs a) {
  extern __shared__ int smem[];
  const int l = threadIdx.x & 15, by = l >> 2, bx = l & 3;
  const int gw = a.gw, my = blockIdx.y;
  const int mxs = blockIdx.x * DP_MBS + (threadIdx.x >> 4);
  const bool live = mxs < gw;
  const int mx = live ? mxs : gw - 1;
  const int m = my * gw + mx;
  // the neighbour across the picture's edge is the far column or row, as
  // torch.roll wraps; the edge flags gate it off there
  const int ml = m - mx + (mx ? mx - 1 : gw - 1);
  const int mt = (my ? my - 1 : a.gh - 1) * gw + mx;
  const bool fv = a.fv ? a.fv[m] != 0 : mx > 0;
  const bool fh = a.fh ? a.fh[m] != 0 : my > 0;
  const bool nzq = any_level(levels(a, m, by, bx));
  const int2 vq = ld2(a.mv + ((size_t)m * 16 + l) * 2);
  const int rq = a.ref[m * 16 + l];
  const bool iq = a.intra[m] != 0;
  const int qp = a.qp[m];
  // lanes 0-5: the left, top and own qp of sets 0 / 3, 1 / 4, 2 / 5
  const int qn = (l == 0 || l == 3) && mx > 0 ? a.qp[m - 1]
                 : (l == 1 || l == 4) && my > 0 ? a.qp[m - gw] : qp;
  // the MB edge blocks: block (by, 3) of the left MB, (3, bx) of the top
  bool nz_lmb = false, nz_tmb = false, i_lmb = false, i_tmb = false;
  int2 v_lmb = make_int2(0, 0), v_tmb = make_int2(0, 0);
  int r_lmb = 0, r_tmb = 0;
  if (bx == 0 && fv) {
    nz_lmb = any_level(levels(a, ml, by, 3));
    v_lmb = ld2(a.mv + ((size_t)ml * 16 + by * 4 + 3) * 2);
    r_lmb = a.ref[ml * 16 + by * 4 + 3];
    i_lmb = a.intra[ml] != 0;
  }
  if (by == 0 && fh) {
    nz_tmb = any_level(levels(a, mt, 3, bx));
    v_tmb = ld2(a.mv + ((size_t)mt * 16 + 12 + bx) * 2);
    r_tmb = a.ref[mt * 16 + 12 + bx];
    i_tmb = a.intra[mt] != 0;
  }
  // the neighbours inside the MB: lane l - 1 on the left, l - 4 on top
  const int nz_l = __shfl_up_sync(FULL, (int)nzq, 1, 16);
  const int vx_l = __shfl_up_sync(FULL, vq.x, 1, 16);
  const int vy_l = __shfl_up_sync(FULL, vq.y, 1, 16);
  const int r_l = __shfl_up_sync(FULL, rq, 1, 16);
  const int nz_t = __shfl_up_sync(FULL, (int)nzq, 4, 16);
  const int vx_t = __shfl_up_sync(FULL, vq.x, 4, 16);
  const int vy_t = __shfl_up_sync(FULL, vq.y, 4, 16);
  const int r_t = __shfl_up_sync(FULL, rq, 4, 16);
  const bool nzl = bx ? nz_l != 0 : nz_lmb;
  const bool nzt = by ? nz_t != 0 : nz_tmb;
  const int bs_v =
      bx || fv ? edge_bs(iq || i_lmb, nzq || nzl, vq,
                         bx ? make_int2(vx_l, vy_l) : v_lmb, rq,
                         bx ? r_l : r_lmb, bx != 0)
               : 0;
  const int bs_h =
      by || fh ? edge_bs(iq || i_tmb, nzq || nzt, vq,
                         by ? make_int2(vx_t, vy_t) : v_tmb, rq,
                         by ? r_t : r_tmb, by != 0)
               : 0;
  int16_t* row =
      reinterpret_cast<int16_t*>(smem) + (threadIdx.x >> 4) * DP_ROW;
  row[30 + bx * 4 + by] = (int16_t)bs_v;
  row[46 + l] = (int16_t)bs_h;
  if (l < 6) hl::edge_set(a.tab + T_QPC, l, qp, qn, a.cqo, 0, 0, row);
  __syncwarp();
  if (live) {
    const int* w = reinterpret_cast<const int*>(row);
    int* o = reinterpret_cast<int*>(a.aux + (size_t)m * NAUX);
    o[l] = w[l];
    if (l + 16 < NAUX / 2) o[l + 16] = w[l + 16];
  }
}

// The launches' grids (shared with the emulated tests' harness)
int pd_blocks(int n) {
  return (int)((16L * n + PD_THREADS - 1) / PD_THREADS);
}
int dp_strips(int gw) { return (gw + DP_MBS - 1) / DP_MBS; }

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is device
// memory that the caller allocated and checked (p_body_fast.py: the
// shapes above, int32, f32, int64 and bool as named, the maps and outputs
// contiguous, the planes with unit column stride).  Each returns 0 or the
// CUDA error code of the launch.
extern "C" int hl_part_decide(const float* c16, const int32_t* v16,
                              const float* c168, const int32_t* v168,
                              const float* c816, const int32_t* v816,
                              const float* c88, const int32_t* v88,
                              const float* lam, long long* choice,
                              float* best, int32_t* mv, int32_t* part, int n,
                              cudaStream_t stream) {
  const PdArgs a{c16,  c168, c816, c88,    v16,  v168, v816,
                 v88,  lam,  choice, best, mv,   part, n};
  k_part_decide<<<pd_blocks(n), PD_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hl_halfpel_enc(const int32_t* plane, int stride, int hp,
                              int wp, int32_t* out, cudaStream_t stream) {
  const dim3 grid((wp + HP_TW - 1) / HP_TW, (hp + HP_TH - 1) / HP_TH);
  k_halfpel_enc<<<grid, HP_THREADS, HP_SMEM_BYTES, stream>>>(plane, stride,
                                                            hp, wp, out);
  return (int)cudaGetLastError();
}

extern "C" int hl_p_residual(
    const int32_t* sy, const int32_t* su, const int32_t* sv,
    const int32_t* ry, const int32_t* ru, const int32_t* rv,
    const int32_t* mv, const int32_t* qp, const float* best,
    const float* lam, const int32_t* tab, int32_t* wq, int32_t* dcq,
    int32_t* acq, int32_t* oy, int32_t* ou, int32_t* ov, uint8_t* mask,
    int sy_st, int su_st, int sv_st, int ry_st, int ru_st, int rv_st,
    int ry_h, int ry_w, int rc_h, int rc_w, int gw, int gh, int cqo,
    cudaStream_t stream) {
  const PrArgs a{sy,    su,    sv,    ry,    ru,    rv,    mv,    qp,
                 best,  lam,   tab,   wq,    dcq,   acq,   oy,    ou,
                 ov,    mask,  sy_st, su_st, sv_st, ry_st, ru_st, rv_st,
                 ry_h,  ry_w,  rc_h,  rc_w,  gw,    gh,    cqo};
  k_p_residual<<<dim3((gw + PR_MBS - 1) / PR_MBS, gh), PR_THREADS,
                 PR_SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hl_deblock_params(const int32_t* wq, const int32_t* mv,
                                 const int32_t* ref, const uint8_t* intra,
                                 const int32_t* qp, const uint8_t* fv,
                                 const uint8_t* fh, const int32_t* tab,
                                 int16_t* aux, int gw, int gh, int cqo,
                                 cudaStream_t stream) {
  const DpArgs a{wq, mv, ref, intra, qp, fv, fh, tab, aux, gw, gh, cqo};
  k_deblock_params<<<dim3(dp_strips(gw), gh), DP_THREADS, DP_SMEM_BYTES,
                     stream>>>(a);
  return (int)cudaGetLastError();
}

// The four kernels' attributes, six ints each in the order k_part_decide,
// k_halfpel_enc, k_p_residual, k_deblock_params: registers, local (spill)
// bytes a thread, static shared bytes, dynamic shared bytes and threads a
// block of the launch, and the blocks of that launch an SM holds at once.
extern "C" int hl_p_encode_attributes(int* out) {
  const void* fns[4] = {(const void*)k_part_decide,
                        (const void*)k_halfpel_enc,
                        (const void*)k_p_residual,
                        (const void*)k_deblock_params};
  const int dyn[4] = {0, HP_SMEM_BYTES, PR_SMEM_BYTES, DP_SMEM_BYTES};
  const int threads[4] = {PD_THREADS, HP_THREADS, PR_THREADS, DP_THREADS};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes f;
    cudaError_t err = cudaFuncGetAttributes(&f, fns[i]);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i],
                                                        threads[i], dyn[i]);
    if (err != cudaSuccess) return (int)err;
    out[6 * i] = f.numRegs;
    out[6 * i + 1] = (int)f.localSizeBytes;
    out[6 * i + 2] = (int)f.sharedSizeBytes;
    out[6 * i + 3] = dyn[i];
    out[6 * i + 4] = threads[i];
    out[6 * i + 5] = blocks;
  }
  return 0;
}
