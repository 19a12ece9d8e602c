// The GOP scan's residual decode, motion compensation and ring write for
// Hopper (sm_90a): the per-picture work of the decoder's GOP scan around
// its intra wavefront and deblock, and of the sharded decode's band step.
//
// Replaces the XLA of hartallo_tpu/decode/d_gop.py's scan:
//   k_residual_dec    :120-127, ops/wide.py:259 residual_planes_wide: the
//                     flat dequant, the Intra16x16 luma DC Hadamard and
//                     descale, the chroma DC 2x2 Hadamard and descale on
//                     QP_SCALE_CHROMA[clip(qp + off, 0, 51)], the 4x4
//                     inverse transform and blkIdx -> raster order, K
//                     pictures a launch;
//   k_mc_dec          :183-191, ops/wide.py:117 mc_luma_plane and :161
//                     mc_chroma_plane: quarter-pel luma and eighth-pel
//                     chroma MC from the reference slots with explicit
//                     weights, the residual added and clipped, 0 for an MB
//                     that is not inter, and the zero pad of PAD around
//                     each plane, one picture a launch;
//   k_ring_write_dec  :208-229: the picture's half-pel stack [G, b, h, j]
//                     of its edge-padded luma and its edge-padded chroma
//                     written into ring slot ws as bytes, zeros in the
//                     slot's over-allocated margin, and the picture's
//                     (H * 3/2, W) byte row (U and V side by side).
// Their plain twins are hartallo_tpu_torch/ops/wide.residual_planes_wide
// (through decode/mc_decode_fast.residual_planes_plain),
// decode/mc_decode_fast.mc_recon_plain and ring_write_plain, which these
// kernels match bit for bit; the wrappers are decode/mc_decode_fast.py.
//
// What bounds them on the H100: bytes.  At 1080p the residual reads the
// 410 coefficient and parameter words of each MB and writes 384 int32
// samples (about 26 MB, 7.7 us at 3.35 TB/s); the MC reads the residual,
// the per-block MVs, slots and weights and about one reference sample per
// predicted sample, and writes three padded int32 planes (about 32 MB with
// 80% inter MBs, 9.5 us; chip_smoke.mc_dec_bound); the ring write reads
// the deblocked planes once and writes the byte slot and the output row
// (about 27 MB, 8.2 us; chip_smoke.ring_write_bound).  None holds a
// chain: every output sample is a short function of inputs read once.
//
// Design.
// - k_residual_dec (a first cut): a warp an MB, four MBs a block of 128
//   threads.  Lane l < 16 takes raster 4x4 block l: the Intra16x16 DC
//   Hadamard by width-16 shuffles (the four values of its column, then of
//   its row), its block's 16 coefficients dequantised and inverse
//   transformed in registers, four int4 row stores.  Lanes 16-23 take
//   chroma block (comp, b) = ((l - 16) >> 2, (l - 16) & 3): the 2x2 DC
//   Hadamard as a butterfly of two xor shuffles in groups of four, then
//   the same.  Lanes 24-31 only take part in the shuffles.
// - k_mc_dec: two warps an MB, a block per strip of four MBs of an MB
//   row (a 2-D grid, no division).  The MB's two warps read its 16
//   blocks' MVs, slots and weights once, 192 coalesced words into shared
//   memory (its residual rows meanwhile); then warp h's lane l forms luma
//   row 8 h + (l >> 2), columns 4 (l & 3) .. + 3, and two samples of
//   chroma plane h, row l >> 2, one row of 2x2 block (l >> 3, l & 3): an
//   MB's luma and both chroma planes from one block, one luma group and
//   one chroma pair a lane.  A tap's row of four reference bytes is two
//   aligned 32-bit loads joined by __funnelshift_r; the quarter-pel
//   average is one __vavgu4, a chroma sample's bilinear sum one __dp4a
//   over a __byte_perm of its two rows.  On the band's int32 stacks a row
//   is four scalar words.  The quarter-pel case table is two 64-bit
//   immediates, not constant memory, which would serialise a warp over
//   its lanes' distinct cases.  An MB that is not inter stores zeros and
//   reads no parameter.  One more block a row stores its side pads,
//   three more rows of blocks the pad rows of each plane.  The kernel is
//   a template on the reference type: uint8 (the scan's ring) or int32
//   (the band stacks), each read with its own dims as strides.
// - k_ring_write_dec: one flat grid, the luma slot's 64 x 32 tiles, then
//   the chroma slots' 64 x 32 tiles (no block idle).  A luma tile stages
//   its G with a halo of 2 rows above, 3 below and 4 columns a side in
//   shared memory once, as int4 (each coordinate clamped into the picture:
//   pad_edge, then _edge_pad's clamp into the padded plane, is one clamp
//   into the picture; a 4-column group is all inside or all one edge
//   sample); a thread takes 4 columns of 2 rows, walking down with G and
//   its horizontal sums of six rows in registers, and stores one word a
//   plane a row and, inside the picture, the output row's luma from the
//   same G.  A chroma tile reads each sample of both planes once (int4)
//   and writes the slots and the output row's chroma.  A tile wholly in
//   the slot's margin stores zeros.
//
// Integer only.  Sums and products wrap as torch's int32 does (they are
// formed in uint32_t); right shifts of negative values floor.  The
// qp of every MB is in 0..51 and logWD in 0..7, the parser's ranges.
#include <cstdint>
#include <cuda_runtime.h>

#include "halfpel_prims.cuh"

namespace {

constexpr int PAD = 32;
constexpr unsigned FULL = 0xffffffffu;

// ops/wide.py's tables (core/tables.py): QUANT_V[qp % 6] in raster
// order and QP_SCALE_CHROMA
__constant__ int c_quant_v[6][16] = {
    {10, 13, 10, 13, 13, 16, 13, 16, 10, 13, 10, 13, 13, 16, 13, 16},
    {11, 14, 11, 14, 14, 18, 14, 18, 11, 14, 11, 14, 14, 18, 14, 18},
    {13, 16, 13, 16, 16, 20, 16, 20, 13, 16, 13, 16, 16, 20, 16, 20},
    {14, 18, 14, 18, 18, 23, 18, 23, 14, 18, 14, 18, 18, 23, 18, 23},
    {16, 20, 16, 20, 20, 25, 20, 25, 16, 20, 16, 20, 20, 25, 20, 25},
    {18, 23, 18, 23, 23, 29, 23, 29, 18, 23, 18, 23, 23, 29, 23, 29}};
__constant__ int c_qpc[52] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
    34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

// int32 arithmetic that wraps as torch's does
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (int)((uint32_t)a << s);
}

__device__ __forceinline__ int clampi(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}
__device__ __forceinline__ void st4(int* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}

// four bytes as one little-endian word
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 255) | (uint32_t)(b & 255) << 8 |
         (uint32_t)(c & 255) << 16 | (uint32_t)(d & 255) << 24;
}

// ---------------------------------------------------------------------------
// k_residual_dec
// ---------------------------------------------------------------------------
constexpr int RD_THREADS = 128;          // a warp an MB
constexpr int RD_MBS = RD_THREADS / 32;

// word offsets of the fields in an MB's record (d_fused.DEC_FIELDS):
// luma_ac (16 blkIdx, 4, 4), luma_dc (4, 4), chroma_ac (2, 4, 4, 4),
// chroma_dc (2, 2, 2), qp, kind
struct RdFields {
  int luma_ac, luma_dc, chroma_ac, chroma_dc, qp, kind;
};

struct RdArgs {
  const int32_t* rec;      // (K, gh * gw, words)
  int32_t* res_y;          // (K, 16 gh, 16 gw)
  int32_t* res_c;          // (K, 2, 8 gh, 8 gw)
  RdFields f;
  int words, nmb, gw, gh, cqo;
};

__host__ __device__ inline int rd_blocks(int nmb) {
  return (nmb + RD_MBS - 1) / RD_MBS;
}

// 8.5.12.1 flat dequant (ops/wide.dequant_wide); ls = 16 QUANT_V entry
__device__ __forceinline__ int dequant_w(int c, int ls, int qp) {
  const int qdiv = qp / 6;
  return qp >= 24 ? wshl(wmul(c, ls), qdiv - 4)
                  : wadd(wmul(c, ls), 1 << (3 - qdiv)) >> (4 - qdiv);
}

// output k of the 1-D Hadamard stage of ops/wide._had_stage
__device__ __forceinline__ int had4(int d0, int d1, int d2, int d3, int k) {
  const int a0 = wadd(d0, d1), a1 = wsub(d0, d1);
  const int b0 = wadd(d2, d3), b1 = wsub(d2, d3);
  return k == 0 ? wadd(a0, b0)
                : k == 1 ? wsub(a0, b0) : k == 2 ? wsub(a1, b1) : wadd(a1, b1);
}

// the 4x4 inverse core transform of 8.5.12.2 in place (ops/wide.idct_wide:
// each row, then each column, then (x + 32) >> 6)
__device__ __forceinline__ void idct4x4(int (&x)[16]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int step = p ? 4 : 1, next = p ? 1 : 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int* d = x + i * next;
      const int d0 = d[0], d1 = d[step], d2 = d[2 * step], d3 = d[3 * step];
      const int e0 = wadd(d0, d2), e1 = wsub(d0, d2);
      const int e2 = wsub(d1 >> 1, d3), e3 = wadd(d1, d3 >> 1);
      d[0] = wadd(e0, e3);
      d[step] = wadd(e1, e2);
      d[2 * step] = wsub(e1, e2);
      d[3 * step] = wsub(e0, e3);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = wadd(x[i], 32) >> 6;
}

// raster block (by, bx) -> blkIdx
__device__ __forceinline__ int raster_blk(int by, int bx) {
  return ((by >> 1) << 3) | ((bx >> 1) << 2) | ((by & 1) << 1) | (bx & 1);
}

__global__ void __launch_bounds__(RD_THREADS) k_residual_dec(RdArgs a) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * RD_MBS + (threadIdx.x >> 5);
  if (g >= a.nmb) return;                 // the whole warp
  const int per = a.gw * a.gh;
  const int k = g / per, m = g - k * per, my = m / a.gw, mx = m - my * a.gw;
  const RdFields& f = a.f;
  const int32_t* r = a.rec + (size_t)g * a.words;
  const int qp = r[f.qp];
  const bool i16 = r[f.kind] == 1;
  // luma DC: lane l < 16 holds raster entry (l >> 2, l & 3); the Hadamard
  // over each column (_had_stage along dim 0), then over each row
  const int l16 = lane & 15, hi = l16 >> 2, hj = l16 & 3;
  const int dc = r[f.luma_dc + l16];
  int col[4], row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) col[i] = __shfl_sync(FULL, dc, (i << 2) | hj, 16);
  const int gcol = had4(col[0], col[1], col[2], col[3], hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) row[j] = __shfl_sync(FULL, gcol, (hi << 2) | j, 16);
  const int fl = had4(row[0], row[1], row[2], row[3], hj);
  // chroma: lane 16 + 4 comp + b; the 2x2 DC Hadamard as two butterflies
  const int qpc = c_qpc[clampi(0, 51, qp + a.cqo)];
  const int cl = (lane - 16) & 7, comp = cl >> 2, cb = cl & 3;
  const int cdc = r[f.chroma_dc + 4 * comp + cb];
  int p = __shfl_xor_sync(FULL, cdc, 1);
  const int c1 = (cb & 1) ? wsub(p, cdc) : wadd(cdc, p);
  p = __shfl_xor_sync(FULL, c1, 2);
  const int fc = (cb & 2) ? wsub(p, c1) : wadd(c1, p);
  if (lane >= 24) return;
  int x[16];
  if (lane < 16) {
    const int q6 = qp % 6;
    const int32_t* c = r + f.luma_ac + 16 * raster_blk(hi, hj);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = dequant_w(c[i], 16 * c_quant_v[q6][i], qp);
    if (i16) {                            // 8.5.10
      const int scale = 16 * c_quant_v[q6][0], qdiv = qp / 6;
      x[0] = qp >= 36 ? wshl(wmul(fl, scale), qdiv - 6)
                      : wadd(wmul(fl, scale), 1 << (5 - qdiv)) >> (6 - qdiv);
    }
  } else {
    const int q6 = qpc % 6;
    const int32_t* c = r + f.chroma_ac + 16 * cl;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = dequant_w(c[i], 16 * c_quant_v[q6][i], qpc);
    // 8.5.11: the shift may carry past bit 31, as torch's int32 << does
    x[0] = wshl(wmul(fc, 16 * c_quant_v[q6][0]), qpc / 6) >> 5;
  }
  idct4x4(x);
  int32_t* o;
  size_t stride;
  if (lane < 16) {
    const int W = 16 * a.gw;
    stride = W;
    o = a.res_y + (size_t)k * 16 * a.gh * W +
        (size_t)(16 * my + 4 * hi) * W + 16 * mx + 4 * hj;
  } else {
    const int Wc = 8 * a.gw;
    stride = Wc;
    o = a.res_c + ((size_t)k * 2 + comp) * 8 * a.gh * Wc +
        (size_t)(8 * my + 4 * (cb >> 1)) * Wc + 8 * mx + 4 * (cb & 1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st4(o + i * stride, make_int4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                  x[4 * i + 3]));
}

// ---------------------------------------------------------------------------
// k_mc_dec
// ---------------------------------------------------------------------------
constexpr int MC_MBS = 4;                // two warps an MB, a strip of 4
constexpr int MC_THREADS = 64 * MC_MBS;  // MBs of one MB row a block
// an MB's 16 blocks' parameters as staged: mv (16, 2) at 0, slot (16) at
// 32, wp_l (16, 3) at 48, wp_c (16, 2, 3) at 96
constexpr int MC_PARAM_WORDS = 192;
constexpr int MC_SMEM_BYTES = MC_MBS * MC_PARAM_WORDS * 4;

template <class T>
struct McArgs {
  const T* ref_y;          // (S, 4, ys_h, ys_w) [G, b, h, j] per slot
  const T* ref_u;          // (S, cs_h, cs_w) padded chroma per slot
  const T* ref_v;
  const int32_t* mv;       // (N, 2) quarter-pel, blocks (my, mx, by, bx)
  const int32_t* slot;     // (N,)
  const int32_t* wp_l;     // (N, 3) [w, o, logWD]
  const int32_t* wp_c;     // (N, 2, 3)
  const int32_t* res_y;    // (16 gh, 16 gw)
  const int32_t* res_c;    // (2, 8 gh, 8 gw)
  const uint8_t* inter;    // (gh, gw)
  int32_t* out_y;          // (16 gh + 2 PAD, 16 gw + 2 PAD)
  int32_t* out_u;          // (8 gh + 2 PAD, 8 gw + 2 PAD)
  int32_t* out_v;
  int ys_h, ys_w, cs_h, cs_w, gw, gh;
};

// the grid: a block per strip of MC_MBS MBs of an MB row, one more block
// a row for its side pads, and three more rows of blocks for the pad rows
// above and below each plane
__host__ __device__ inline int mc_strips(int gw) {
  return (gw + MC_MBS - 1) / MC_MBS;
}
__host__ __device__ inline int mc_grid_rows(int gh) { return gh + 3; }

// 8.4.2.3.2 explicit weighting (ops/wide._weigh), clipped
__device__ __forceinline__ int weigh(int pred, int w, int o, int lwd) {
  return clampi(0, 255,
                wadd(wadd(wmul(pred, w), (1 << lwd) >> 1) >> lwd, o));
}

// _QPT as bytes: case 4 fy + fx -> plane a | dx a << 2 | dy a << 3 |
// plane b << 4 | dx b << 6 | dy b << 7, case c in byte c & 7 of QPT_LO
// (c < 8) or QPT_HI (a lane's case is its own: a table in constant
// memory would serialise a warp over its distinct cases)
constexpr unsigned long long QPT_LO = 0x6131212041111000ull;
constexpr unsigned long long QPT_HI = 0x9693928263333222ull;

__device__ __forceinline__ int qpt_case(int c) {
  return (int)(((c & 8) ? QPT_HI : QPT_LO) >> ((c & 7) << 3)) & 255;
}

// Four consecutive reference samples from p, of which the first N are
// used.  Bytes: the two aligned words around them joined by a funnel
// shift, one little-endian word; the second word is read only where the
// N samples reach into it (a random block then touches no more sectors
// than its samples lie in), and at most 7 bytes past p, which the MC's
// clamps keep inside the plane's next row.  int32: N scalar words (two
// aligned int4 around them ran 13-16% slower on the H100 where the
// blocks' MVs scatter, and no faster on a stream's own motion).
template <int N>
__device__ __forceinline__ uint32_t row4(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  const unsigned sh = (unsigned)(a & 3) << 3;
  return __funnelshift_r(w[0], (int)(a & 3) > 4 - N ? w[1] : 0u, sh);
}

template <int N>
__device__ __forceinline__ int4 row4(const int32_t* p) {
  return make_int4(p[0], p[1], p[2], N > 3 ? p[3] : 0);
}

// the luma prediction of four samples: the rounded average of the two
// taps' rows (a byte-wise __vavgu4 on the ring)
__device__ __forceinline__ void luma4(const uint8_t* pa, const uint8_t* pb,
                                      int (&pred)[4]) {
  const uint32_t v = __vavgu4(row4<4>(pa), row4<4>(pb));
#pragma unroll
  for (int j = 0; j < 4; ++j) pred[j] = (int)(v >> (8 * j)) & 255;
}

__device__ __forceinline__ void luma4(const int32_t* pa, const int32_t* pb,
                                      int (&pred)[4]) {
  const int4 a = row4<4>(pa), b = row4<4>(pb);
  pred[0] = (a.x + b.x + 1) >> 1;
  pred[1] = (a.y + b.y + 1) >> 1;
  pred[2] = (a.z + b.z + 1) >> 1;
  pred[3] = (a.w + b.w + 1) >> 1;
}

// the bilinear chroma prediction of a 2x2 block's two samples of a row
// from rows p0 and p0 + stride (8.4.2.2.2); on the ring the four taps of a
// sample as one word (__byte_perm) and their weighted sum as one __dp4a
__device__ __forceinline__ void chroma2(const uint8_t* p0, int stride,
                                        int dx, int dy, int (&pred)[2]) {
  const uint32_t r0 = row4<3>(p0), r1 = row4<3>(p0 + stride);
  const uint32_t w = (uint32_t)((8 - dx) * (8 - dy)) |
                     (uint32_t)(dx * (8 - dy)) << 8 |
                     (uint32_t)((8 - dx) * dy) << 16 |
                     (uint32_t)(dx * dy) << 24;
  pred[0] = (int)(__dp4a(__byte_perm(r0, r1, 0x5410), w, 32u) >> 6);
  pred[1] = (int)(__dp4a(__byte_perm(r0, r1, 0x6521), w, 32u) >> 6);
}

__device__ __forceinline__ void chroma2(const int32_t* p0, int stride,
                                        int dx, int dy, int (&pred)[2]) {
  const int4 r0 = row4<3>(p0), r1 = row4<3>(p0 + stride);
  const int a = (8 - dx) * (8 - dy), b = dx * (8 - dy), c = (8 - dx) * dy,
            d = dx * dy;
  pred[0] = (a * r0.x + b * r0.y + c * r1.x + d * r1.y + 32) >> 6;
  pred[1] = (a * r0.y + b * r0.z + c * r1.y + d * r1.z + 32) >> 6;
}

// the zero pad of the three planes outside the MBs.  Rows gh + p of the
// grid: the PAD rows above and below plane p, row by row over its
// blocks; the extra block of an MB row: that row's PAD columns left and
// right.
template <class T>
__device__ __forceinline__ void mc_zero_pad(const McArgs<T>& a, int strips) {
  const int4 zero = make_int4(0, 0, 0, 0);
  const int H = 16 * a.gh, Wo = 16 * a.gw + 2 * PAD;
  const int Hc = 8 * a.gh, Wco = 8 * a.gw + 2 * PAD;
  const int tid = threadIdx.x;
  if (blockIdx.y >= a.gh) {
    const int p = blockIdx.y - a.gh;
    const int h = p ? Hc : H, w = p ? Wco : Wo;
    int32_t* o = p == 0 ? a.out_y : p == 1 ? a.out_u : a.out_v;
    for (int i = blockIdx.x; i < 2 * PAD; i += strips + 1) {
      int32_t* row = o + (size_t)(i < PAD ? i : h + i) * w;
      for (int c = tid << 2; c < w; c += MC_THREADS << 2) st4(row + c, zero);
    }
    return;
  }
  // MB row my's side pads: its 16 luma rows, then 8 rows of each chroma
  // plane, 2 PAD / 4 int4 a row (PAD / 4 a side)
  const int my = blockIdx.y;
  for (int i = tid; i < 32 * (2 * PAD / 4); i += MC_THREADS) {
    const int row = i >> 4, k = i & 15;        // 2 PAD / 4 == 16
    const int col = ((k & 7) << 2) + (k >> 3) * (row < 16 ? Wo - PAD
                                                          : Wco - PAD);
    int32_t* o = row < 16 ? a.out_y + (size_t)(PAD + 16 * my + row) * Wo
                          : (row < 24 ? a.out_u : a.out_v) +
                                (size_t)(PAD + 8 * my + ((row - 16) & 7)) *
                                    Wco;
    st4(o + col, zero);
  }
}

__device__ __forceinline__ int2 ld2(const int* p) {
  return *reinterpret_cast<const int2*>(p);
}
__device__ __forceinline__ void st2(int* p, int2 v) {
  *reinterpret_cast<int2*>(p) = v;
}

template <class T>
__global__ void __launch_bounds__(MC_THREADS) k_mc_dec(McArgs<T> a) {
  extern __shared__ int smem[];
  const int strips = mc_strips(a.gw);
  if (blockIdx.y >= a.gh || blockIdx.x == strips) {
    mc_zero_pad(a, strips);
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31;
  const int j = tid >> 6, half = (tid >> 5) & 1;    // MB j of the strip
  const int my = blockIdx.y, mx = blockIdx.x * MC_MBS + j;
  const int H = 16 * a.gh, W = 16 * a.gw, Wo = W + 2 * PAD;
  const int Hc = H >> 1, Wc = W >> 1, Wco = Wc + 2 * PAD;
  const int m = my * a.gw + mx;
  const bool live = mx < a.gw && a.inter[m];
  // luma: row ly of the MB, columns lc .. lc + 3, in block lb
  const int ly = 8 * half + (lane >> 2), lc = (lane & 3) << 2;
  const int lb = (ly >> 2 << 2) | (lane & 3);
  // chroma: plane half, row cy of the MB, columns cc, cc + 1: one row of
  // 2x2 block cb
  const int cy = lane >> 2, cc = (lane & 3) << 1;
  const int cb = (cy >> 1 << 2) | (lane & 3);
  int4 ry = make_int4(0, 0, 0, 0);
  int2 rc = make_int2(0, 0);
  int* sp = smem + j * MC_PARAM_WORDS;
  if (live) {
    // the MB's 16 blocks' parameters, read once by its two warps, three
    // coalesced words a thread; its residual rows meanwhile
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int w = (tid & 63) + 64 * k;
      const int32_t* src = w < 32   ? a.mv + 32 * (size_t)m + w
                           : w < 48 ? a.slot + 16 * (size_t)m + (w - 32)
                           : w < 96 ? a.wp_l + 48 * (size_t)m + (w - 48)
                                    : a.wp_c + 96 * (size_t)m + (w - 96);
      sp[w] = *src;
    }
    ry = ld4(a.res_y + (size_t)(16 * my + ly) * W + 16 * mx + lc);
    rc = ld2(a.res_c + ((size_t)half * Hc + 8 * my + cy) * Wc + 8 * mx + cc);
  }
  __syncthreads();
  if (mx >= a.gw) return;                 // both warps of the MB
  int32_t* oy =
      a.out_y + (size_t)(PAD + 16 * my + ly) * Wo + PAD + 16 * mx + lc;
  int32_t* oc = (half ? a.out_v : a.out_u) +
                (size_t)(PAD + 8 * my + cy) * Wco + PAD + 8 * mx + cc;
  if (!live) {                            // not inter: zeros, no parameter
    st4(oy, make_int4(0, 0, 0, 0));
    st2(oc, make_int2(0, 0));
    return;
  }
  {
    const int mvx = sp[2 * lb], mvy = sp[2 * lb + 1], s = sp[32 + lb];
    const int* wl = sp + 48 + 3 * lb;
    const int px = 16 * mx + lc, py = 16 * my + ly;
    // the block's clamped origin in the padded reference
    const int xi = clampi(-(PAD - 2), W + PAD - 7, px + (mvx >> 2)) + PAD;
    const int yi = clampi(-(PAD - 2), H + PAD - 7, (py & ~3) + (mvy >> 2)) +
                   PAD + (py & 3);
    const int q = qpt_case(4 * (mvy & 3) + (mvx & 3));
    const size_t plane = (size_t)a.ys_h * a.ys_w;
    const T* base =
        a.ref_y + (size_t)s * 4 * plane + (size_t)yi * a.ys_w + xi;
    const T* pa = base + (q & 3) * plane + ((q >> 3) & 1) * a.ys_w +
                  ((q >> 2) & 1);
    const T* pb = base + ((q >> 4) & 3) * plane + (q >> 7) * a.ys_w +
                  ((q >> 6) & 1);
    int pred[4];
    luma4(pa, pb, pred);
    const int w = wl[0], off = wl[1], lwd = wl[2];
    st4(oy,
        make_int4(clampi(0, 255, wadd(weigh(pred[0], w, off, lwd), ry.x)),
                  clampi(0, 255, wadd(weigh(pred[1], w, off, lwd), ry.y)),
                  clampi(0, 255, wadd(weigh(pred[2], w, off, lwd), ry.z)),
                  clampi(0, 255, wadd(weigh(pred[3], w, off, lwd), ry.w))));
  }
  {
    const int mvx = sp[2 * cb], mvy = sp[2 * cb + 1], s = sp[32 + cb];
    const int* wp = sp + 96 + 6 * cb + 3 * half;
    const int px = 8 * mx + cc, py = 8 * my + cy;   // the block's column
    const int xi = clampi(-(PAD - 1), Wc + PAD - 4, px + (mvx >> 3)) + PAD;
    const int yi = clampi(-(PAD - 1), Hc + PAD - 4, (py & ~1) + (mvy >> 3)) +
                   PAD + (py & 1);
    const int dx = mvx & 7, dy = mvy & 7;
    int pred[2];
    chroma2((half ? a.ref_v : a.ref_u) + ((size_t)s * a.cs_h + yi) * a.cs_w +
                xi,
            a.cs_w, dx, dy, pred);
    const int w = wp[0], off = wp[1], lwd = wp[2];
    st2(oc, make_int2(clampi(0, 255, wadd(weigh(pred[0], w, off, lwd), rc.x)),
                      clampi(0, 255, wadd(weigh(pred[1], w, off, lwd), rc.y))));
  }
}

// ---------------------------------------------------------------------------
// k_ring_write_dec
// ---------------------------------------------------------------------------
constexpr int RW_TW = 64;                // a tile: columns
constexpr int RW_TH = 32;                // and rows
constexpr int RW_RUN = 2;                // rows a thread walks down
constexpr int RW_THREADS = (RW_TW / 4) * (RW_TH / RW_RUN);
constexpr int RW_GW = RW_TW + 8;         // G's staged row: 4 halo columns a
                                         // side (2 and 3 are read)
constexpr int RW_ROWS = RW_TH + 5;       // staged rows: 2 above, 3 below
constexpr int RW_SMEM_BYTES = RW_ROWS * RW_GW * 4;
static_assert(RW_THREADS == 256 && RW_GW % 4 == 0,
              "k_ring_write_dec: 16 column groups of 4 by 16 runs of rows");

struct RwArgs {
  const int32_t* y;        // the deblocked picture (16 gh, 16 gw), row
  const int32_t* u;        // stride ys; chroma (8 gh, 8 gw), strides
  const int32_t* v;        // us, vs; each 16-byte aligned, strides
  uint8_t* ring_y;         // multiples of 4; slot ws: (4, hr, wr)
  uint8_t* ring_u;         // (hcr, wcr)
  uint8_t* ring_v;
  uint8_t* out;            // (24 gh, 16 gw)
  int ys, us, vs, hr, wr, hcr, wcr, gw, gh;
};

// the grid: the luma slot's 64 x 32 tiles (wr / 64 a row), then the
// chroma slots' (both planes a tile)
__host__ __device__ inline int rw_luma_tiles(int hr, int wr) {
  return (wr / RW_TW) * ((hr + RW_TH - 1) / RW_TH);
}
__host__ __device__ inline int rw_chroma_cols(int wcr) {
  return (wcr + RW_TW - 1) / RW_TW;
}
__host__ __device__ inline int rw_blocks(int hr, int wr, int hcr, int wcr) {
  return rw_luma_tiles(hr, wr) +
         rw_chroma_cols(wcr) * ((hcr + RW_TH - 1) / RW_TH);
}

// The 6-tap sum of p[0], p[s], ..., p[5 s] (halfpel_prims.cuh's taps)
__device__ __forceinline__ int tap6(const int* p, int s) {
  return p[0] - 5 * p[s] + 20 * p[2 * s] + 20 * p[3 * s] - 5 * p[4 * s] +
         p[5 * s];
}

// four samples of a plane row from column c (a multiple of 4), the
// columns clamped into [0, w - 1] (w a multiple of 4: the four are all
// inside, or all on one side and each the edge sample)
__device__ __forceinline__ int4 clamped4(const int32_t* row, int c, int w) {
  if (c < 0) return make_int4(row[0], row[0], row[0], row[0]);
  if (c >= w) return make_int4(row[w - 1], row[w - 1], row[w - 1], row[w - 1]);
  return ld4(row + c);
}

__device__ __forceinline__ uint32_t pack4(int4 v) {
  return pack4(v.x, v.y, v.z, v.w);
}

// the chroma slots and the output row's chroma: thread (rg, cg) takes
// columns x .. x + 3 of RW_RUN rows of both planes, each sample read once
__device__ void rw_chroma(const RwArgs& a, int tile) {
  const int cols = rw_chroma_cols(a.wcr);
  const int ty = tile / cols, tx = tile - ty * cols;
  const int x = tx * RW_TW + ((threadIdx.x & 15) << 2);
  const int yb = ty * RW_TH + (threadIdx.x >> 4) * RW_RUN;
  if (x >= a.wcr) return;
  const int H = 16 * a.gh, W = 16 * a.gw, Hc = H >> 1, Wc = W >> 1;
  const bool col_in = x < Wc + 2 * PAD;
  const bool col_out = x >= PAD && x < Wc + PAD;   // in the output row
  for (int k = 0; k < RW_RUN; ++k) {
    const int y = yb + k;
    if (y >= a.hcr) return;
    const bool in = col_in && y < Hc + 2 * PAD;
    const int sy = clampi(0, Hc - 1, y - PAD);
#pragma unroll
    for (int comp = 0; comp < 2; ++comp) {
      uint32_t q = 0;
      if (in) {
        q = pack4(clamped4((comp ? a.v : a.u) +
                               (size_t)sy * (comp ? a.vs : a.us),
                           x - PAD, Wc));
        if (col_out && y >= PAD && y < Hc + PAD)
          *reinterpret_cast<uint32_t*>(a.out + (size_t)(H + y - PAD) * W +
                                       comp * Wc + x - PAD) = q;
      }
      *reinterpret_cast<uint32_t*>((comp ? a.ring_v : a.ring_u) +
                                   (size_t)y * a.wcr + x) = q;
    }
  }
}

__global__ void __launch_bounds__(RW_THREADS) k_ring_write_dec(RwArgs a) {
  extern __shared__ int smem[];
  const int tile = blockIdx.x, luma_tiles = rw_luma_tiles(a.hr, a.wr);
  if (tile >= luma_tiles) {
    rw_chroma(a, tile - luma_tiles);
    return;
  }
  // the luma slot, [G, b, h, j] of the edge-padded picture, and the
  // output row's luma from the same staged G
  const int tid = threadIdx.x, cols = a.wr / RW_TW;
  const int ty = tile / cols, tx = tile - ty * cols;
  const int x0 = tx * RW_TW, y0 = ty * RW_TH;
  const int cg = tid & 15, rg = tid >> 4;
  const int x = x0 + (cg << 2), yb = y0 + rg * RW_RUN;
  const int H = 16 * a.gh, W = 16 * a.gw;
  const int hp = H + 2 * PAD, wp = W + 2 * PAD;
  const size_t plane = (size_t)a.hr * a.wr;
  uint8_t* o = a.ring_y + (size_t)yb * a.wr + x;
  const int rows = min(RW_RUN, a.hr - yb);   // this thread's, in the slot
  if (y0 >= hp || x0 >= wp) {             // a tile in the margin
    for (int k = 0; k < rows; ++k)
      for (int p = 0; p < 4; ++p)
        *reinterpret_cast<uint32_t*>(o + p * plane + (size_t)k * a.wr) = 0;
    return;
  }
  // staged row i is padded row y0 - 2 + i, staged column j padded column
  // x0 - 4 + j; both clamped into the picture; a row as 18 int4
  int* sg = smem;
  for (int i = tid; i < RW_ROWS * (RW_GW / 4); i += RW_THREADS) {
    const int r = i / (RW_GW / 4), k = i - r * (RW_GW / 4);
    st4(sg + r * RW_GW + 4 * k,
        clamped4(a.y + (size_t)clampi(0, H - 1, y0 - 2 + r - PAD) * a.ys,
                 x0 - 4 + 4 * k - PAD, W));
  }
  __syncthreads();
  const bool col_in = x < wp;
  const bool col_out = x >= PAD && x < W + PAD;
  // the window: G and its horizontal sums H1 of six staged rows, four
  // columns, moving down one row a step
  int g[6][4] = {}, h1[6][4] = {};
  const int* base = sg + rg * RW_RUN * RW_GW + (cg << 2);
#pragma unroll
  for (int i = 0; i < RW_RUN + 5; ++i) {
    const int* row = base + i * RW_GW;
    const int4 v0 = ld4(row), v1 = ld4(row + 4), v2 = ld4(row + 8);
    const int v[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                       v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        g[t][j] = g[t + 1][j];
        h1[t][j] = h1[t + 1][j];
      }
      g[5][j] = v[4 + j];
      h1[5][j] = tap6(v + 2 + j, 1);
    }
    if (i < 5) continue;
    const int k = i - 5, y = yb + k;       // the output row
    if (k >= rows) break;
    int q[4][4] = {};                      // [plane][sample]
    if (col_in && y < hp) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[0][j] = g[2][j];
        q[1][j] = hp_round5(h1[2][j]);
        q[2][j] = hp_round5(g[0][j] - 5 * g[1][j] + 20 * g[2][j] +
                            20 * g[3][j] - 5 * g[4][j] + g[5][j]);
        q[3][j] = hp_round10(h1[0][j] - 5 * h1[1][j] + 20 * h1[2][j] +
                             20 * h1[3][j] - 5 * h1[4][j] + h1[5][j]);
      }
      if (col_out && y >= PAD && y < H + PAD)
        *reinterpret_cast<uint32_t*>(a.out + (size_t)(y - PAD) * W + x -
                                     PAD) =
            pack4(q[0][0], q[0][1], q[0][2], q[0][3]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<uint32_t*>(o + p * plane + (size_t)k * a.wr) =
          pack4(q[p][0], q[p][1], q[p][2], q[p][3]);
  }
}

}  // namespace

// Plain C entry points (kernels.py loads them with ctypes).  Each
// launches on `stream` and returns cudaGetLastError().

extern "C" int hl_residual_dec(const int32_t* rec, int words,
                               const int* offs, int32_t* res_y,
                               int32_t* res_c, int K, int gw, int gh,
                               int cqo, cudaStream_t stream) {
  const RdFields f{offs[0], offs[1], offs[2], offs[3], offs[4], offs[5]};
  const RdArgs a{rec, res_y, res_c, f, words, K * gw * gh, gw, gh, cqo};
  k_residual_dec<<<rd_blocks(a.nmb), RD_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hl_mc_dec(const void* ref_y, const void* ref_u,
                         const void* ref_v, int bytes, const int32_t* mv,
                         const int32_t* slot, const int32_t* wp_l,
                         const int32_t* wp_c, const int32_t* res_y,
                         const int32_t* res_c, const uint8_t* inter,
                         int32_t* out_y, int32_t* out_u, int32_t* out_v,
                         int ys_h, int ys_w, int cs_h, int cs_w, int gw,
                         int gh, cudaStream_t stream) {
  const dim3 grid(mc_strips(gw) + 1, mc_grid_rows(gh));
  if (bytes == 1) {
    const McArgs<uint8_t> a{(const uint8_t*)ref_y, (const uint8_t*)ref_u,
                            (const uint8_t*)ref_v, mv, slot, wp_l, wp_c,
                            res_y, res_c, inter, out_y, out_u, out_v,
                            ys_h, ys_w, cs_h, cs_w, gw, gh};
    k_mc_dec<uint8_t><<<grid, MC_THREADS, MC_SMEM_BYTES, stream>>>(a);
  } else if (bytes == 4) {
    const McArgs<int32_t> a{(const int32_t*)ref_y, (const int32_t*)ref_u,
                            (const int32_t*)ref_v, mv, slot, wp_l, wp_c,
                            res_y, res_c, inter, out_y, out_u, out_v,
                            ys_h, ys_w, cs_h, cs_w, gw, gh};
    k_mc_dec<int32_t><<<grid, MC_THREADS, MC_SMEM_BYTES, stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int hl_ring_write_dec(const int32_t* y, const int32_t* u,
                                 const int32_t* v, int ys, int us, int vs,
                                 uint8_t* ring_y, uint8_t* ring_u,
                                 uint8_t* ring_v, uint8_t* out, int hr,
                                 int wr, int hcr, int wcr, int gw, int gh,
                                 cudaStream_t stream) {
  const RwArgs a{y, u, v, ring_y, ring_u, ring_v, out, ys, us, vs,
                 hr, wr, hcr, wcr, gw, gh};
  k_ring_write_dec<<<rw_blocks(hr, wr, hcr, wcr), RW_THREADS, RW_SMEM_BYTES,
                     stream>>>(a);
  return (int)cudaGetLastError();
}
