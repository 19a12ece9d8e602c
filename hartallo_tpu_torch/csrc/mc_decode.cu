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
// samples (about 26 MB, 8 us); the MC reads the residual, the per-block
// MVs, slots and weights and about one reference sample per predicted
// sample, and writes three padded int32 planes (about 40 MB, 12 us); the
// ring write reads the deblocked planes and writes the byte slot and the
// output row (about 27 MB, 8 us).  None holds a chain: every output
// sample is a short function of inputs read once.
//
// Design (a first cut, simple and right).
// - k_residual_dec: a warp an MB, four MBs a block of 128 threads.  Lane
//   l < 16 takes raster 4x4 block l: the Intra16x16 DC Hadamard by width-16
//   shuffles (the four values of its column, then of its row), its block's
//   16 coefficients dequantised and inverse transformed in registers, four
//   int4 row stores.  Lanes 16-23 take chroma block (comp, b) = ((l - 16)
//   >> 2, (l - 16) & 3): the 2x2 DC Hadamard as a butterfly of two xor
//   shuffles in groups of four, then the same.  Lanes 24-31 only take part
//   in the shuffles.
// - k_mc_dec: a thread per four samples of a row of the padded output
//   planes (luma, then U, then V, on a 1-D grid): outside the picture, or
//   in an MB that is not inter, it stores zeros; else it loads its block's
//   MV, slot and weights and forms the four samples (luma: the clamped
//   origin and the quarter-pel case's two taps over [G, b, h, j], averaged;
//   chroma: two 2x2 blocks' bilinear taps), weighs them, adds the
//   residual, clips, and stores one int4.  The reference stacks are read
//   with their own dims as strides, as bytes (the scan's ring) or int32
//   (the band stacks); the kernel is a template on that type.
// - k_ring_write_dec: blockIdx.z 0, the luma slot: k_halfpel_enc's scheme
//   (p_encode.cu), a block of 256 threads per 64 x 16 tile, G staged with
//   its halo in shared memory once, each coordinate clamped into the
//   picture (pad_edge, then _edge_pad's clamp into the padded plane, is
//   one clamp into the picture), the horizontal sums once, 4 samples of a
//   row a thread, one 32-bit store a plane; a tile wholly in the margin
//   stores zeros.  z 1: both chroma slots, z 2: the output row, 4 bytes a
//   thread.
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
// order, QP_SCALE_CHROMA, and _QPT, the quarter-pel cases 4 fy + fx ->
// (plane, dx, dy) of the two taps (planes 0 G, 1 b, 2 h, 3 j)
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
__constant__ int c_qpt[16][6] = {
    {0, 0, 0, 0, 0, 0}, {0, 0, 0, 1, 0, 0}, {1, 0, 0, 1, 0, 0},
    {1, 0, 0, 0, 1, 0}, {0, 0, 0, 2, 0, 0}, {1, 0, 0, 2, 0, 0},
    {1, 0, 0, 3, 0, 0}, {1, 0, 0, 2, 1, 0}, {2, 0, 0, 2, 0, 0},
    {2, 0, 0, 3, 0, 0}, {3, 0, 0, 3, 0, 0}, {3, 0, 0, 2, 1, 0},
    {2, 0, 0, 0, 0, 1}, {2, 0, 0, 1, 0, 1}, {3, 0, 0, 1, 0, 1},
    {2, 1, 0, 1, 0, 1}};

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
constexpr int MC_THREADS = 256;          // a thread per 4 samples of a row

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

// the luma and the chroma groups of four samples
__host__ __device__ inline long long mc_groups_y(int gw, int gh) {
  return (long long)(16 * gh + 2 * PAD) * ((16 * gw + 2 * PAD) >> 2);
}
__host__ __device__ inline long long mc_groups_c(int gw, int gh) {
  return (long long)(8 * gh + 2 * PAD) * ((8 * gw + 2 * PAD) >> 2);
}
__host__ __device__ inline int mc_blocks(int gw, int gh) {
  return (int)((mc_groups_y(gw, gh) + 2 * mc_groups_c(gw, gh) +
                MC_THREADS - 1) / MC_THREADS);
}

// 8.4.2.3.2 explicit weighting (ops/wide._weigh), clipped
__device__ __forceinline__ int weigh(int pred, int w, int o, int lwd) {
  return clampi(0, 255,
                wadd(wadd(wmul(pred, w), (1 << lwd) >> 1) >> lwd, o));
}

template <class T>
__global__ void __launch_bounds__(MC_THREADS) k_mc_dec(McArgs<T> a) {
  const long long t = (long long)blockIdx.x * MC_THREADS + threadIdx.x;
  const long long ny = mc_groups_y(a.gw, a.gh), nc = mc_groups_c(a.gw, a.gh);
  if (t >= ny + 2 * nc) return;
  int v[4] = {0, 0, 0, 0};
  int32_t* o;
  if (t < ny) {                           // luma
    const int H = 16 * a.gh, W = 16 * a.gw, gpr = (W + 2 * PAD) >> 2;
    const int y = (int)(t / gpr), x = (int)(t - (long long)y * gpr) << 2;
    o = a.out_y + (size_t)y * (W + 2 * PAD) + x;
    const int py = y - PAD, px = x - PAD;
    if (py >= 0 && py < H && px >= 0 && px < W &&
        a.inter[(py >> 4) * a.gw + (px >> 4)]) {
      const int n = ((((py >> 4) * a.gw + (px >> 4)) << 2 | ((py >> 2) & 3))
                     << 2) | ((px >> 2) & 3);
      const int mvx = a.mv[2 * n], mvy = a.mv[2 * n + 1];
      const int s = a.slot[n];
      const int w = a.wp_l[3 * n], off = a.wp_l[3 * n + 1],
                lwd = a.wp_l[3 * n + 2];
      // the block's clamped origin in the padded reference
      const int xi = clampi(-(PAD - 2), W + PAD - 7, px + (mvx >> 2)) + PAD;
      const int yi = clampi(-(PAD - 2), H + PAD - 7, (py & ~3) + (mvy >> 2)) +
                     PAD + (py & 3);
      const int* cs = c_qpt[4 * (mvy & 3) + (mvx & 3)];
      const T* pa = a.ref_y +
                    (((size_t)s * 4 + cs[0]) * a.ys_h + yi + cs[2]) * a.ys_w +
                    xi + cs[1];
      const T* pb = a.ref_y +
                    (((size_t)s * 4 + cs[3]) * a.ys_h + yi + cs[5]) * a.ys_w +
                    xi + cs[4];
      const int4 r = ld4(a.res_y + (size_t)py * W + px);
      const int rr[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pred = ((int)pa[j] + (int)pb[j] + 1) >> 1;
        v[j] = clampi(0, 255, wadd(weigh(pred, w, off, lwd), rr[j]));
      }
    }
  } else {                                // chroma, U then V
    const int comp = t - ny >= nc;
    const long long tc = t - ny - comp * nc;
    const int H = 8 * a.gh, W = 8 * a.gw, gpr = (W + 2 * PAD) >> 2;
    const int y = (int)(tc / gpr), x = (int)(tc - (long long)y * gpr) << 2;
    o = (comp ? a.out_v : a.out_u) + (size_t)y * (W + 2 * PAD) + x;
    const int py = y - PAD, px = x - PAD;
    if (py >= 0 && py < H && px >= 0 && px < W &&
        a.inter[(py >> 3) * a.gw + (px >> 3)]) {
      const T* ref = comp ? a.ref_v : a.ref_u;
      const int4 r = ld4(a.res_c + ((size_t)comp * H + py) * W + px);
      const int rr[4] = {r.x, r.y, r.z, r.w};
      // two 2x2 blocks side by side: blocks bx and bx + 1 of the MB row by
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cbx = px + 2 * h;       // the block's origin
        const int n = ((((py >> 3) * a.gw + (px >> 3)) << 2 |
                        ((py >> 1) & 3)) << 2) | ((cbx >> 1) & 3);
        const int mvx = a.mv[2 * n], mvy = a.mv[2 * n + 1];
        const int s = a.slot[n];
        const int* wp = a.wp_c + 6 * n + 3 * comp;
        const int xi = clampi(-(PAD - 1), W + PAD - 4, cbx + (mvx >> 3)) + PAD;
        const int yi = clampi(-(PAD - 1), H + PAD - 4, (py & ~1) + (mvy >> 3)) +
                       PAD + (py & 1);
        const int dx = mvx & 7, dy = mvy & 7;
        const T* p0 = ref + ((size_t)s * a.cs_h + yi) * a.cs_w + xi;
        const T* p1 = p0 + a.cs_w;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pred =
              ((8 - dx) * (8 - dy) * (int)p0[j] + dx * (8 - dy) * (int)p0[j + 1] +
               (8 - dx) * dy * (int)p1[j] + dx * dy * (int)p1[j + 1] + 32) >> 6;
          v[2 * h + j] = clampi(
              0, 255, wadd(weigh(pred, wp[0], wp[1], wp[2]), rr[2 * h + j]));
        }
      }
    }
  }
  st4(o, make_int4(v[0], v[1], v[2], v[3]));
}

// ---------------------------------------------------------------------------
// k_ring_write_dec
// ---------------------------------------------------------------------------
constexpr int RW_TW = 64;                // a tile: columns
constexpr int RW_TH = 16;                // and rows
constexpr int RW_THREADS = 256;          // a thread per 4 samples of a row
constexpr int RW_GW = RW_TW + 8;         // G's staged row: 4 halo columns a
                                         // side (2 and 3 are read)
constexpr int RW_ROWS = RW_TH + 5;       // staged rows: 2 above, 3 below
constexpr int RW_SMEM_WORDS = RW_ROWS * (RW_GW + RW_TW);
constexpr int RW_SMEM_BYTES = RW_SMEM_WORDS * 4;
static_assert(RW_THREADS * 4 == RW_TW * RW_TH && RW_TW == 64,
              "k_ring_write_dec maps a thread to 4 samples of a 64-wide row");

struct RwArgs {
  const int32_t* y;        // the deblocked picture (16 gh, 16 gw), row
  const int32_t* u;        // stride ys; chroma (8 gh, 8 gw), strides
  const int32_t* v;        // us, vs
  uint8_t* ring_y;         // slot ws: (4, hr, wr)
  uint8_t* ring_u;         // (hcr, wcr)
  uint8_t* ring_v;
  uint8_t* out;            // (24 gh, 16 gw)
  int ys, us, vs, hr, wr, hcr, wcr, gw, gh;
};

__host__ __device__ inline int rw_rows(int gh, int hr, int hcr) {
  int n = hr > 24 * gh ? hr : 24 * gh;
  n = n > hcr ? n : hcr;
  return (n + RW_TH - 1) / RW_TH;
}

// The 6-tap sum of p[0], p[s], ..., p[5 s] (halfpel_prims.cuh's taps)
__device__ __forceinline__ int tap6(const int* p, int s) {
  return p[0] - 5 * p[s] + 20 * p[2 * s] + 20 * p[3 * s] - 5 * p[4 * s] +
         p[5 * s];
}

__global__ void __launch_bounds__(RW_THREADS) k_ring_write_dec(RwArgs a) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * RW_TW, y0 = blockIdx.y * RW_TH;
  const int r = tid >> 4, c = (tid & 15) << 2;
  const int y = y0 + r, x = x0 + c;
  const int H = 16 * a.gh, W = 16 * a.gw;
  if (blockIdx.z == 1) {                  // the chroma slots
    if (y >= a.hcr || x >= a.wcr) return;
    const int Hc = H >> 1, Wc = W >> 1;
    const bool in = y < Hc + 2 * PAD && x < Wc + 2 * PAD;
    const int sy = clampi(0, Hc - 1, y - PAD);
    for (int comp = 0; comp < 2; ++comp) {
      const int32_t* p = (comp ? a.v : a.u) + (size_t)sy * (comp ? a.vs : a.us);
      int q[4] = {0, 0, 0, 0};
      if (in)
        for (int k = 0; k < 4; ++k) q[k] = p[clampi(0, Wc - 1, x + k - PAD)];
      *reinterpret_cast<uint32_t*>((comp ? a.ring_v : a.ring_u) +
                                   (size_t)y * a.wcr + x) =
          pack4(q[0], q[1], q[2], q[3]);
    }
    return;
  }
  if (blockIdx.z == 2) {                  // the output row
    if (y >= 24 * a.gh || x >= W) return;
    const int32_t* p;
    if (y < H) {
      p = a.y + (size_t)y * a.ys + x;
    } else if (x < (W >> 1)) {
      p = a.u + (size_t)(y - H) * a.us + x;
    } else {
      p = a.v + (size_t)(y - H) * a.vs + x - (W >> 1);
    }
    *reinterpret_cast<uint32_t*>(a.out + (size_t)y * W + x) =
        pack4(p[0], p[1], p[2], p[3]);
    return;
  }
  // the luma slot, [G, b, h, j] of the edge-padded picture (hr is a
  // multiple of 16: a tile's rows are all in the slot or none)
  if (y0 >= a.hr) return;
  const int hp = H + 2 * PAD, wp = W + 2 * PAD;
  const size_t plane = (size_t)a.hr * a.wr;
  uint8_t* o = a.ring_y + (size_t)y * a.wr + x;
  if (y0 >= hp || x0 >= wp) {             // a tile in the margin
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<uint32_t*>(o + p * plane) = 0;
    return;
  }
  int* sg = smem;                         // [RW_ROWS][RW_GW] G
  int* sh = smem + RW_ROWS * RW_GW;       // [RW_ROWS][RW_TW] H1
  // staged row i is padded row y0 - 2 + i, staged column j padded column
  // x0 - 4 + j; both clamped into the picture
  for (int i = tid >> 5; i < RW_ROWS; i += RW_THREADS / 32) {
    const int32_t* row =
        a.y + (size_t)clampi(0, H - 1, y0 - 2 + i - PAD) * a.ys;
    for (int j = tid & 31; j < RW_GW; j += 32)
      sg[i * RW_GW + j] = row[clampi(0, W - 1, x0 - 4 + j - PAD)];
  }
  __syncthreads();
  for (int i = tid; i < RW_ROWS * (RW_TW / 4); i += RW_THREADS) {
    const int rr = i >> 4, cc = (i & 15) << 2;
    const int4 g0 = ld4(sg + rr * RW_GW + cc), g1 = ld4(sg + rr * RW_GW + cc + 4),
               g2 = ld4(sg + rr * RW_GW + cc + 8);
    const int g[12] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y,
                       g1.z, g1.w, g2.x, g2.y, g2.z, g2.w};
    st4(sh + rr * RW_TW + cc, make_int4(tap6(g + 2, 1), tap6(g + 3, 1),
                                        tap6(g + 4, 1), tap6(g + 5, 1)));
  }
  __syncthreads();
  int q[4][4] = {};                       // [plane][sample]
  if (y < hp && x < wp) {
    for (int k = 0; k < 4; ++k) {
      const int* gc = sg + r * RW_GW + c + 4 + k;   // G rows y - 2 .. y + 3
      const int* hc = sh + r * RW_TW + c + k;       // H1 rows y - 2 .. y + 3
      q[0][k] = gc[2 * RW_GW];
      q[1][k] = hp_round5(hc[2 * RW_TW]);
      q[2][k] = hp_round5(tap6(gc, RW_GW));
      q[3][k] = hp_round10(tap6(hc, RW_TW));
    }
  }
  for (int p = 0; p < 4; ++p)
    *reinterpret_cast<uint32_t*>(o + p * plane) =
        pack4(q[p][0], q[p][1], q[p][2], q[p][3]);
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
  const int blocks = mc_blocks(gw, gh);
  if (bytes == 1) {
    const McArgs<uint8_t> a{(const uint8_t*)ref_y, (const uint8_t*)ref_u,
                            (const uint8_t*)ref_v, mv, slot, wp_l, wp_c,
                            res_y, res_c, inter, out_y, out_u, out_v,
                            ys_h, ys_w, cs_h, cs_w, gw, gh};
    k_mc_dec<uint8_t><<<blocks, MC_THREADS, 0, stream>>>(a);
  } else if (bytes == 4) {
    const McArgs<int32_t> a{(const int32_t*)ref_y, (const int32_t*)ref_u,
                            (const int32_t*)ref_v, mv, slot, wp_l, wp_c,
                            res_y, res_c, inter, out_y, out_u, out_v,
                            ys_h, ys_w, cs_h, cs_w, gw, gh};
    k_mc_dec<int32_t><<<blocks, MC_THREADS, 0, stream>>>(a);
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
  const dim3 grid((wr + RW_TW - 1) / RW_TW, rw_rows(gh, hr, hcr), 3);
  k_ring_write_dec<<<grid, RW_THREADS, RW_SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}
