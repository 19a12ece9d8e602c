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
// Design: simple and right first.
//   k_part_decide     one thread per MB: the four partition costs in the
//                     twin's f32 order, the first minimum, the MB's 16
//                     block MVs (times 4) and partition indices.
//   k_halfpel_enc     one thread per sample of the padded plane: G and
//                     the b, h, j grids of halfpel_prims.cuh, with the
//                     coordinates clamped to the plane (the twin's
//                     _edge_pad(..., 2, 3)).
//   k_p_residual      one block of PR_THREADS per MB.  The block stages
//                     the 9x9 reference window of each of its 16 luma
//                     blocks and the 3x3 window of each of its 32 chroma
//                     blocks in shared memory (block origins clamped as
//                     luma_mc_blocks and chroma_mc_blocks clamp them),
//                     forms the quarter-pel and eighth-pel predictions,
//                     then the residual's forward transform and
//                     quantisation (a coefficient a thread), the
//                     eliminations and the chroma DC Hadamard (a block a
//                     thread), the dequantisation and both stages of the
//                     inverse transform, and writes the recon with its
//                     share of the edge pad: an MB on the picture's edge
//                     also writes the pad beside it, so that the planes
//                     leave the launch edge-padded as pad_edge pads them.
//   k_deblock_params  one thread per 4x4 block: whether it and its left
//                     and top neighbours have luma levels, the bS of
//                     8.7.2.1 on its left and top edge segments, and for
//                     six of an MB's blocks one alpha / beta / tc0 set
//                     of the edge_params row, as int16.
//
// What bounds them on the H100: bytes.  k_halfpel_enc reads the int32
// plane and writes four (20 B a sample: 46 MB, 14 us at 1080p);
// k_p_residual reads the source, the reference windows and the MVs and
// writes the padded recon and the levels (about 55 MB, 16 us at 1080p);
// the other two move about 1-10 MB.  The kernels are written for
// correctness and take longer than that; PERF.md has their times.
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

#include "halfpel_prims.cuh"
#include "transform_prims.cuh"

namespace {

constexpr int PAD = 32;
constexpr int NAUX = 62;
constexpr int PR_THREADS = 128;   // k_p_residual's block
constexpr int MB_THREADS = 128;   // the per-MB and per-sample kernels' block
// k_p_residual gives each of its threads one chroma sample, one chroma
// coefficient and two luma ones
static_assert(PR_THREADS == 128, "k_p_residual maps 128 threads");

// the wrapper's table (p_body_fast._tables), int32 words: QUANT_MF
// (6,4,4), QUANT_V (6,4,4), QUANT_QBITS (52), the inter row of QUANT_F
// (52), QP_SCALE_CHROMA (52), DEBLOCK_ALPHA (52), DEBLOCK_BETA (52),
// DEBLOCK_TC0 (52,3) and ZIGZAG_4x4_INV (16) of core/tables.py
constexpr int T_MF = 0, T_V = 96, T_QBITS = 192, T_F = 244, T_QPC = 296,
              T_ALPHA = 348, T_BETA = 400, T_TC0 = 452, T_ZZ = 608;

// JVT-O079 2.3: the significance of a lone |level| == 1 by its zigzag run
// (p_device._T079), 0 from run 6 on
__device__ __forceinline__ int t079(int run) {
  return run == 0 ? 3 : run <= 2 ? 2 : run <= 5 ? 1 : 0;
}

__device__ __forceinline__ int clampi(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// blkIdx -> the block's pixel offsets in its MB; raster block -> blkIdx
__device__ __forceinline__ int blk_x(int b) {
  return 8 * ((b >> 2) & 1) + 4 * (b & 1);
}
__device__ __forceinline__ int blk_y(int b) {
  return 8 * (b >> 3) + 4 * ((b >> 1) & 1);
}
__device__ __forceinline__ int raster_blk(int by, int bx) {
  return ((by >> 1) << 3) | ((bx >> 1) << 2) | ((by & 1) << 1) | (bx & 1);
}

// ---------------------------------------------------------------------------
// k_part_decide
// ---------------------------------------------------------------------------
struct PdArgs {
  const float *c16, *c168, *c816, *c88;        // the full search's costs
  const int32_t *v16, *v168, *v816, *v88;      // and integer MVs
  const float* lam;                            // one value
  long long* choice;                           // (gh, gw)
  float* best;                                 // (gh, gw)
  int32_t *mv, *part;                          // (gh, gw, 16, 2), (.., 16)
  int n;                                       // MBs
};

// me._PART_OF_BLK of partition scheme `choice` at raster block b
__device__ __forceinline__ int part_of(int choice, int b) {
  const int by = b >> 2, bx = b & 3;
  return choice == 0 ? 0
         : choice == 1 ? by >> 1
         : choice == 2 ? bx >> 1
                       : ((by >> 1) << 1) | (bx >> 1);
}

__global__ void k_part_decide(PdArgs a) {
  const float lam = a.lam[0];
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < a.n;
       m += gridDim.x * blockDim.x) {
    float c[4];
    c[0] = __fadd_rn(a.c16[m], __fmul_rn(lam, 1.0f));
    c[1] = __fadd_rn(__fadd_rn(a.c168[2 * m], a.c168[2 * m + 1]),
                     __fmul_rn(lam, 3.0f));
    c[2] = __fadd_rn(__fadd_rn(a.c816[2 * m], a.c816[2 * m + 1]),
                     __fmul_rn(lam, 3.0f));
    const float* q = a.c88 + 4 * m;
    c[3] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(q[0], q[1]), q[2]), q[3]),
                     __fmul_rn(lam, 9.0f));
    int ch = 0;
    for (int k = 1; k < 4; ++k)
      if (c[k] < c[ch]) ch = k;       // the first minimum, as argmin
    a.choice[m] = ch;
    a.best[m] = c[ch];
    for (int b = 0; b < 16; ++b) {
      const int p = part_of(ch, b);
      const int32_t* v = ch == 0   ? a.v16 + 2 * m
                         : ch == 1 ? a.v168 + 4 * m + 2 * p
                         : ch == 2 ? a.v816 + 4 * m + 2 * p
                                   : a.v88 + 8 * m + 2 * p;
      a.mv[(m * 16 + b) * 2] = v[0] * 4;
      a.mv[(m * 16 + b) * 2 + 1] = v[1] * 4;
      a.part[m * 16 + b] = p;
    }
  }
}

// ---------------------------------------------------------------------------
// k_halfpel_enc
// ---------------------------------------------------------------------------
__global__ void k_halfpel_enc(const int32_t* __restrict__ plane, int stride,
                              int hp, int wp, int32_t* __restrict__ out) {
  const ClampedPlane g{plane, stride, 0, hp - 1, 0, wp - 1};
  const long n = (long)hp * wp;
  for (long t = (long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (long)gridDim.x * blockDim.x) {
    const int y = (int)(t / wp), x = (int)(t % wp);
    out[t] = hp_at(g, y, x);
    out[n + t] = hp_round5(hp_h1(g, y, x));
    out[2 * n + t] = hp_round5(hp_v1(g, y, x));
    out[3 * n + t] = hp_round10(hp_j1(g, y, x));
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

// shared memory, int32 words
constexpr int S_WIN = 0;                  // [16 blocks][9][9] luma windows
constexpr int S_CWIN = S_WIN + 16 * 81;   // [2][16 blocks][3][3] chroma
constexpr int S_PRED = S_CWIN + 288;      // luma prediction, 16x16 raster
constexpr int S_CPRED = S_PRED + 256;     // chroma prediction [2][8][8]
constexpr int S_RES = S_CPRED + 128;      // luma residual, then recon
constexpr int S_CRES = S_RES + 256;       // chroma residual, then recon
constexpr int S_LEV = S_CRES + 128;       // [16 blkIdx][4][4] levels, then
                                          // dequantised coefficients
constexpr int S_CLEV = S_LEV + 256;       // [2][4][4][4] likewise, chroma
constexpr int S_CDC = S_CLEV + 128;       // [2][4] chroma DC coefficients
constexpr int S_DCQ = S_CDC + 8;          // [2][2][2] chroma DC levels
constexpr int S_STAGE = S_DCQ + 8;        // the inverse transform's rows:
                                          // 256 luma, 128 chroma
constexpr int S_CTR = S_STAGE + 384;      // [16] the blocks' significance
constexpr int S_SATD = S_CTR + 16;        // [16] intra estimate SATDs
constexpr int S_FLAG = S_SATD + 16;       // drop_y, lone[2]
constexpr int PR_SMEM_WORDS = S_FLAG + 4;
constexpr int PR_SMEM_BYTES = PR_SMEM_WORDS * 4;

// sample (iy, ix) of a 4x4 block's quarter-pel prediction of case
// 4 fy + fx from its 9x9 window w (the window's (2, 2) is the block's
// integer origin): luma_mc_blocks' bank, value by value
__device__ int luma_sample(const int* w, int fcase, int iy, int ix) {
  auto W = [&](int r, int c) { return w[r * 9 + c]; };
  auto hsum = [&](int r, int c0) {
    int acc = 0;
    for (int k = 0; k < 6; ++k) acc += hp_tap(k) * W(r, c0 + k);
    return acc;
  };
  auto vsum = [&](int r0, int c) {
    int acc = 0;
    for (int k = 0; k < 6; ++k) acc += hp_tap(k) * W(r0 + k, c);
    return acc;
  };
  auto jval = [&]() {
    int acc = 0;
    for (int l = 0; l < 6; ++l) acc += hp_tap(l) * vsum(iy, ix + l);
    return hp_round10(acc);
  };
  const int G = W(2 + iy, 2 + ix);
  const int b = hp_round5(hsum(2 + iy, ix));
  const int h = hp_round5(vsum(iy, 2 + ix));
  switch (fcase) {
    case 0: return G;
    case 1: return (G + b + 1) >> 1;
    case 2: return b;
    case 3: return (b + W(2 + iy, 3 + ix) + 1) >> 1;
    case 4: return (G + h + 1) >> 1;
    case 5: return (b + h + 1) >> 1;
    case 6: return (b + jval() + 1) >> 1;
    case 7: return (b + hp_round5(vsum(iy, 3 + ix)) + 1) >> 1;
    case 8: return h;
    case 9: return (h + jval() + 1) >> 1;
    case 10: return jval();
    case 11: return (jval() + hp_round5(vsum(iy, 3 + ix)) + 1) >> 1;
    case 12: return (h + W(3 + iy, 2 + ix) + 1) >> 1;
    case 13: return (h + hp_round5(hsum(3 + iy, ix)) + 1) >> 1;
    case 14: return (jval() + hp_round5(hsum(3 + iy, ix)) + 1) >> 1;
    default:
      return (hp_round5(vsum(iy, 3 + ix)) + hp_round5(hsum(3 + iy, ix)) +
              1) >> 1;
  }
}

// Write an MB's S x S recon `rec` into the padded plane `out` (hp x wp,
// contiguous) with its share of the edge pad: the rows and columns of the
// pad beside a picture-edge MB, and the corner beside a corner MB
__device__ void write_owned(int32_t* out, int hp, int wp, const int* rec,
                            int S, int mx, int my, int gw, int gh) {
  const int y0 = my == 0 ? 0 : PAD + S * my;
  const int y1 = my == gh - 1 ? hp : PAD + S * (my + 1);
  const int x0 = mx == 0 ? 0 : PAD + S * mx;
  const int x1 = mx == gw - 1 ? wp : PAD + S * (mx + 1);
  const int w = x1 - x0, n = (y1 - y0) * w;
  for (int i = threadIdx.x; i < n; i += PR_THREADS) {
    const int y = y0 + i / w, x = x0 + i % w;
    out[(size_t)y * wp + x] =
        rec[clampi(0, S - 1, y - PAD - S * my) * S +
            clampi(0, S - 1, x - PAD - S * mx)];
  }
}

__global__ void __launch_bounds__(PR_THREADS) k_p_residual(PrArgs a) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  const int mx = blockIdx.x, my = blockIdx.y, mb = my * a.gw + mx;
  const int* tab = a.tab;
  const int qp = a.qp[mb];
  const int qpc = tab[T_QPC + clampi(0, 51, qp + a.cqo)];
  const int32_t* mvs = a.mv + (size_t)mb * 32;

  // ---- the reference windows
  for (int e = tid; e < 16 * 81; e += PR_THREADS) {
    const int bl = e / 81, r = (e % 81) / 9, c = e % 9;
    const int xi = clampi(-(PAD - 2), a.ry_w - PAD - 7,
                          mx * 16 + (bl & 3) * 4 + (mvs[2 * bl] >> 2));
    const int yi = clampi(-(PAD - 2), a.ry_h - PAD - 7,
                          my * 16 + (bl >> 2) * 4 + (mvs[2 * bl + 1] >> 2));
    smem[S_WIN + e] =
        a.ry[(size_t)(yi + PAD - 2 + r) * a.ry_st + xi + PAD - 2 + c];
  }
  for (int e = tid; e < 288; e += PR_THREADS) {
    const int comp = e / 144, bl = (e % 144) / 9, r = (e % 9) / 3, c = e % 3;
    const int xi = clampi(-(PAD - 1), a.rc_w - PAD - 4,
                          mx * 8 + (bl & 3) * 2 + (mvs[2 * bl] >> 3));
    const int yi = clampi(-(PAD - 1), a.rc_h - PAD - 4,
                          my * 8 + (bl >> 2) * 2 + (mvs[2 * bl + 1] >> 3));
    const int32_t* ref = comp ? a.rv : a.ru;
    const int st = comp ? a.rv_st : a.ru_st;
    smem[S_CWIN + e] = ref[(size_t)(yi + PAD + r) * st + xi + PAD + c];
  }
  __syncthreads();

  // ---- predictions and residuals
  for (int s = tid; s < 256; s += PR_THREADS) {
    const int y = s >> 4, x = s & 15, bl = (y >> 2) * 4 + (x >> 2);
    const int fcase = (mvs[2 * bl + 1] & 3) * 4 + (mvs[2 * bl] & 3);
    const int p = luma_sample(smem + S_WIN + bl * 81, fcase, y & 3, x & 3);
    smem[S_PRED + s] = p;
    smem[S_RES + s] =
        a.sy[(size_t)(PAD + my * 16 + y) * a.sy_st + PAD + mx * 16 + x] - p;
  }
  {
    const int comp = tid >> 6, cy = (tid & 63) >> 3, cx = tid & 7;
    const int bl = (cy >> 1) * 4 + (cx >> 1), iy = cy & 1, ix = cx & 1;
    const int dx = mvs[2 * bl] & 7, dy = mvs[2 * bl + 1] & 7;
    const int* w = smem + S_CWIN + comp * 144 + bl * 9;
    const int p = ((8 - dx) * (8 - dy) * w[iy * 3 + ix] +
                   dx * (8 - dy) * w[iy * 3 + ix + 1] +
                   (8 - dx) * dy * w[(iy + 1) * 3 + ix] +
                   dx * dy * w[(iy + 1) * 3 + ix + 1] + 32) >> 6;
    const int32_t* src = comp ? a.sv : a.su;
    const int st = comp ? a.sv_st : a.su_st;
    smem[S_CPRED + tid] = p;
    smem[S_CRES + tid] =
        src[(size_t)(PAD + my * 8 + cy) * st + PAD + mx * 8 + cx] - p;
  }
  __syncthreads();

  // ---- forward transform and quantisation, a coefficient a thread
  for (int k = tid; k < 256; k += PR_THREADS) {
    const int b = k >> 4, u = (k >> 2) & 3, v = k & 3;
    const int w = fdct(smem + S_RES + blk_y(b) * 16 + blk_x(b), 16, u, v);
    smem[S_LEV + k] = quant(w, tab[T_MF + (qp % 6) * 16 + u * 4 + v],
                            tab[T_F + qp], tab[T_QBITS + qp]);
  }
  {
    const int comp = tid >> 6, b = (tid >> 4) & 3, u = (tid >> 2) & 3,
              v = tid & 3;
    const int w = fdct(smem + S_CRES + comp * 64 + (b >> 1) * 32 +
                           (b & 1) * 4, 8, u, v);
    if (u == 0 && v == 0) {
      smem[S_CDC + comp * 4 + b] = w;
      smem[S_CLEV + tid] = 0;             // skip_dc
    } else {
      smem[S_CLEV + tid] =
          quant(w, tab[T_MF + (qpc % 6) * 16 + u * 4 + v], tab[T_F + qpc],
                tab[T_QBITS + qpc]);
    }
  }
  __syncthreads();

  // ---- per-block reductions: a block a thread
  if (tid < 16) {                         // luma significance (JVT-O079)
    const int* z = smem + S_LEV + tid * 16;
    int nz = 0, run = 16, mx_abs = 0;
    for (int i = 0; i < 16; ++i) {
      const int az = z[i] < 0 ? -z[i] : z[i];
      if (az > 0) {
        ++nz;
        run = min(run, tab[T_ZZ + i]);
        mx_abs = max(mx_abs, az);
      }
    }
    smem[S_CTR + tid] = nz == 0 ? 0 : (nz == 1 && mx_abs == 1) ? t079(run)
                                                               : 9;
  } else if (tid < 24) {                  // chroma DC Hadamard and quant
    const int i = tid - 16, comp = i >> 2;
    const int f = hadamard2(smem + S_CDC + comp * 4, (i >> 1) & 1, i & 1);
    smem[S_DCQ + i] = quant(f, tab[T_MF + (qpc % 6) * 16], 2 * tab[T_F + qpc],
                            tab[T_QBITS + qpc] + 1);
  } else if (tid < 26) {                  // the chroma elimination
    const int comp = tid - 24;
    int nz = 0, mx_abs = 0;
    for (int i = 0; i < 64; ++i) {
      const int z = smem[S_CLEV + comp * 64 + i], az = z < 0 ? -z : z;
      nz += az > 0;
      mx_abs = max(mx_abs, az);
    }
    smem[S_FLAG + 1 + comp] = nz == 1 && mx_abs == 1;
  } else if (tid >= 32 && tid < 48 && a.mask) {
    // intra estimate: the SATD of raster block i against its mean
    const int i = tid - 32;
    const int32_t* s = a.sy + (size_t)(PAD + my * 16 + (i >> 2) * 4) *
                                  a.sy_st + PAD + mx * 16 + (i & 3) * 4;
    int d[16], sum = 0;
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) sum += d[r * 4 + c] = s[r * a.sy_st + c];
    const int dc = sum >> 4;              // the sum is >= 0
    int t[16], acc = 0;
    for (int c = 0; c < 4; ++c) {         // columns (ops/math._hadamard4)
      const int a0 = d[c] - dc, a1 = d[4 + c] - dc, a2 = d[8 + c] - dc,
                a3 = d[12 + c] - dc;
      t[c] = a0 + a1 + a2 + a3;
      t[4 + c] = a0 + a1 - a2 - a3;
      t[8 + c] = a0 - a1 - a2 + a3;
      t[12 + c] = a0 - a1 + a2 - a3;
    }
    for (int r = 0; r < 4; ++r) {         // rows
      const int* q = t + r * 4;
      const int h0 = q[0] + q[1] + q[2] + q[3], h1 = q[0] + q[1] - q[2] - q[3],
                h2 = q[0] - q[1] - q[2] + q[3], h3 = q[0] - q[1] + q[2] - q[3];
      acc += (h0 < 0 ? -h0 : h0) + (h1 < 0 ? -h1 : h1) +
             (h2 < 0 ? -h2 : h2) + (h3 < 0 ? -h3 : h3);
    }
    smem[S_SATD + i] = acc >> 1;
  }
  __syncthreads();
  if (tid == 0) {
    int ctr = 0;
    for (int b = 0; b < 16; ++b) ctr += smem[S_CTR + b];
    smem[S_FLAG] = ctr < 6;               // drop the MB's luma residual
    if (a.mask) {
      int satd = 0;
      for (int i = 0; i < 16; ++i) satd += smem[S_SATD + i];
      const float est = __fadd_rn((float)satd, __fmul_rn(a.lam[0], 24.0f));
      a.mask[mb] = est < a.best[mb];
    }
  }
  __syncthreads();

  // ---- levels out, dequantisation
  const int drop = smem[S_FLAG];
  for (int k = tid; k < 256; k += PR_THREADS) {
    const int z = drop ? 0 : smem[S_LEV + k];
    a.wq[(size_t)mb * 256 + k] = z;
    smem[S_LEV + k] = dequant(z, 16 * tab[T_V + (qp % 6) * 16 + (k & 15)],
                              qp);
  }
  {
    const int comp = tid >> 6, b = (tid >> 4) & 3, uv = tid & 15;
    const int z = smem[S_FLAG + 1 + comp] ? 0 : smem[S_CLEV + tid];
    a.acq[(size_t)mb * 128 + tid] = z;
    int d;
    if (uv == 0) {                        // chroma_dc_descale
      const int f = hadamard2(smem + S_DCQ + comp * 4, b >> 1, b & 1);
      d = (f * (16 * tab[T_V + (qpc % 6) * 16]) * (1 << (qpc / 6))) >> 5;
    } else {
      d = dequant(z, 16 * tab[T_V + (qpc % 6) * 16 + uv], qpc);
    }
    smem[S_CLEV + tid] = d;
    if (tid < 8) a.dcq[(size_t)mb * 8 + tid] = smem[S_DCQ + tid];
  }
  __syncthreads();

  // ---- inverse transform: rows, then columns and the recon
  for (int k = tid; k < 384; k += PR_THREADS) {
    const int* d = smem + (k < 256 ? S_LEV + k : S_CLEV + k - 256) -
                   (k & 3);
    smem[S_STAGE + k] = ict(d[0], d[1], d[2], d[3], k & 3);
  }
  __syncthreads();
  for (int k = tid; k < 256; k += PR_THREADS) {
    const int b = k >> 4, r = (k >> 2) & 3, c = k & 3;
    const int* f = smem + S_STAGE + b * 16;
    const int h = ict(f[c], f[4 + c], f[8 + c], f[12 + c], r);
    const int s = (blk_y(b) + r) * 16 + blk_x(b) + c;
    smem[S_RES + s] = clip255(smem[S_PRED + s] + ((h + 32) >> 6));
  }
  {
    const int comp = tid >> 6, b = (tid >> 4) & 3, r = (tid >> 2) & 3,
              c = tid & 3;
    const int* f = smem + S_STAGE + 256 + (tid >> 4) * 16;
    const int h = ict(f[c], f[4 + c], f[8 + c], f[12 + c], r);
    const int s = comp * 64 + ((b >> 1) * 4 + r) * 8 + (b & 1) * 4 + c;
    smem[S_CRES + s] = clip255(smem[S_CPRED + s] + ((h + 32) >> 6));
  }
  __syncthreads();

  // ---- the recon and its pad
  const int hp = a.gh * 16 + 2 * PAD, wp = a.gw * 16 + 2 * PAD;
  const int hc = a.gh * 8 + 2 * PAD, wc = a.gw * 8 + 2 * PAD;
  write_owned(a.oy, hp, wp, smem + S_RES, 16, mx, my, a.gw, a.gh);
  write_owned(a.ou, hc, wc, smem + S_CRES, 8, mx, my, a.gw, a.gh);
  write_owned(a.ov, hc, wc, smem + S_CRES + 64, 8, mx, my, a.gw, a.gh);
}

// ---------------------------------------------------------------------------
// k_deblock_params
// ---------------------------------------------------------------------------
struct DpArgs {
  const int32_t* wq;        // (gh, gw, 16, 4, 4) luma levels, blkIdx order
  const int32_t* mv;        // (gh, gw, 4, 4, 2)
  const int32_t* ref;       // (gh, gw, 4, 4)
  const uint8_t* intra;     // (gh, gw) bool
  const int32_t* qp;        // (gh, gw)
  const uint8_t *fv, *fh;   // (gh, gw) MB edge flags, or null (inside the
                            // picture)
  const int32_t* tab;
  int16_t* aux;             // (gh, gw, NAUX)
  int gw, gh, cqo;
};

// block (R, C) of the picture's 4x4 grid
__device__ __forceinline__ int grid_mb(const DpArgs& a, int R, int C) {
  return (R >> 2) * a.gw + (C >> 2);
}
__device__ __forceinline__ int grid_blk(const DpArgs& a, int R, int C) {
  return grid_mb(a, R, C) * 16 + (R & 3) * 4 + (C & 3);
}
__device__ bool grid_nz(const DpArgs& a, int R, int C) {
  const int32_t* w = a.wq + ((size_t)grid_mb(a, R, C) * 16 +
                             raster_blk(R & 3, C & 3)) * 16;
  for (int i = 0; i < 16; ++i)
    if (w[i] != 0) return true;
  return false;
}

// bS of the edge between block q (nonzero levels: nzq) and its neighbour
// p (8.7.2.1, as ops/wide.compute_bs_grids: 3 for an intra edge inside
// the MB)
__device__ int edge_bs(const DpArgs& a, int Rq, int Cq, int Rp, int Cp,
                       bool internal, bool nzq) {
  int bs;
  if (a.intra[grid_mb(a, Rq, Cq)] || a.intra[grid_mb(a, Rp, Cp)]) {
    bs = 4;
  } else if (nzq || grid_nz(a, Rp, Cp)) {
    bs = 2;
  } else {
    const int q = grid_blk(a, Rq, Cq), p = grid_blk(a, Rp, Cp);
    const int dx = a.mv[2 * q] - a.mv[2 * p];
    const int dy = a.mv[2 * q + 1] - a.mv[2 * p + 1];
    bs = (dx >= 4 || dx <= -4 || dy >= 4 || dy <= -4 ||
          a.ref[q] != a.ref[p]) ? 1 : 0;
  }
  return internal && bs == 4 ? 3 : bs;
}

// One thread per 4x4 block: the bS of the block's left edge segment and
// of its top one, and for blocks 0-5 of an MB one of the MB's six
// (alpha, beta, tc0) sets: the luma left, top and internal edges, then
// the chroma ones.
__global__ void k_deblock_params(DpArgs a) {
  const int n = a.gw * a.gh * 16;
  const int GW = 4 * a.gw, GH = 4 * a.gh;
  const int* tab = a.tab;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x) {
    const int m = t >> 4, by = (t >> 2) & 3, bx = t & 3;
    const int my = m / a.gw, mx = m % a.gw;
    int16_t* o = a.aux + (size_t)m * NAUX;
    // the neighbour across the picture's edge is the far column or row,
    // as torch.roll wraps; the edge flags gate it off there
    const bool fv = bx ? true : (a.fv ? a.fv[m] != 0 : mx > 0);
    const bool fh = by ? true : (a.fh ? a.fh[m] != 0 : my > 0);
    const int R = 4 * my + by, C = 4 * mx + bx;
    const bool nzq = grid_nz(a, R, C);
    o[30 + bx * 4 + by] =
        fv ? edge_bs(a, R, C, R, (C + GW - 1) % GW, bx != 0, nzq) : 0;
    o[46 + by * 4 + bx] =
        fh ? edge_bs(a, R, C, (R + GH - 1) % GH, C, by != 0, nzq) : 0;
    const int i = t & 15;
    if (i < 6) {
      const int qp = a.qp[m];
      const int qn = i % 3 == 0 ? (mx > 0 ? a.qp[m - 1] : qp)
                     : i % 3 == 1 ? (my > 0 ? a.qp[m - a.gw] : qp) : qp;
      int qe = i % 3 == 2 ? qp : (qn + qp + 1) >> 1;
      if (i >= 3) {                     // chroma: the QPs' chroma QPs
        const int qpc = tab[T_QPC + clampi(0, 51, qp + a.cqo)];
        const int qnc = tab[T_QPC + clampi(0, 51, qn + a.cqo)];
        qe = i == 5 ? qpc : (qnc + qpc + 1) >> 1;
      }
      const int ia = clampi(0, 51, qe);
      o[2 * i] = (int16_t)tab[T_ALPHA + ia];
      o[2 * i + 1] = (int16_t)tab[T_BETA + ia];
      for (int k = 0; k < 3; ++k)
        o[12 + 3 * i + k] = (int16_t)tab[T_TC0 + 3 * ia + k];
    }
  }
}

int grid_of(long n, int threads) {
  const long b = (n + threads - 1) / threads;
  return (int)(b < 1 ? 1 : (b > 65535 ? 65535 : b));
}

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
  k_part_decide<<<grid_of(n, MB_THREADS), MB_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hl_halfpel_enc(const int32_t* plane, int stride, int hp,
                              int wp, int32_t* out, cudaStream_t stream) {
  k_halfpel_enc<<<grid_of((long)hp * wp, MB_THREADS), MB_THREADS, 0,
                  stream>>>(plane, stride, hp, wp, out);
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
  k_p_residual<<<dim3(gw, gh), PR_THREADS, PR_SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hl_deblock_params(const int32_t* wq, const int32_t* mv,
                                 const int32_t* ref, const uint8_t* intra,
                                 const int32_t* qp, const uint8_t* fv,
                                 const uint8_t* fh, const int32_t* tab,
                                 int16_t* aux, int gw, int gh, int cqo,
                                 cudaStream_t stream) {
  const DpArgs a{wq, mv, ref, intra, qp, fv, fh, tab, aux, gw, gh, cqo};
  k_deblock_params<<<grid_of(16L * gw * gh, MB_THREADS), MB_THREADS, 0,
                     stream>>>(a);
  return (int)cudaGetLastError();
}

// The four kernels' attributes, five ints each in the order k_part_decide,
// k_halfpel_enc, k_p_residual, k_deblock_params: registers, local (spill)
// bytes a thread, static shared bytes, dynamic shared bytes, threads a
// block.
extern "C" int hl_p_encode_attributes(int* out) {
  const void* fns[4] = {(const void*)k_part_decide,
                        (const void*)k_halfpel_enc,
                        (const void*)k_p_residual,
                        (const void*)k_deblock_params};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes f;
    const cudaError_t err = cudaFuncGetAttributes(&f, fns[i]);
    if (err != cudaSuccess) return (int)err;
    out[5 * i] = f.numRegs;
    out[5 * i + 1] = (int)f.localSizeBytes;
    out[5 * i + 2] = (int)f.sharedSizeBytes;
    out[5 * i + 3] = i == 2 ? PR_SMEM_BYTES : 0;
    out[5 * i + 4] = i == 2 ? PR_THREADS : MB_THREADS;
  }
  return 0;
}
