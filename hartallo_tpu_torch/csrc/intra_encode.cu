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
// Design.  An MB reads only the recon of its left, top, top-left and
// top-right neighbours, which lie on the slope-2 steps d - 1, d - 2, d - 3
// and d - 1 of d = mx + 2 my, so the MBs of one step are independent.  One
// block of 512 threads walks the steps; its 16 warps take the MBs of a
// step, one warp per MB, with a __syncthreads between steps (CIF 56 steps
// of at most 11 MBs, 720p 168 of at most 40, 1080p 254 of at most 60).
// A warp keeps its MB's source, a 17x17 neighbour tile that the Intra4x4
// blocks reconstruct into, the chroma source and neighbours, and scratch
// for the transforms in its slice of shared memory (4.9 KB); the 9
// Intra4x4 candidates of a block are spread over the lanes (lanes 0-15
// the even modes, 16-31 the odd ones, one pixel a lane) and each SAD is
// reduced with shuffles.  Neighbours are read from the output recon
// planes, which the caller zeroes: the pads read zero, as the twin's carry
// does.  The quantiser, chroma QP and Intra4x4 mode tables come in one
// int32 table that the wrapper uploads once per device.  512 threads
// leave a thread 128 registers; at 1024 (64 registers) the compiler
// spills, and a CIF picture took 2.7 ms instead of 1.8 on the H100, while
// 720p and 1080p pictures took about as long either way.
//
// Rounding.  The costs are the only floating-point values.  nvcc contracts
// a*b + c into an FMA by default, and the twin rounds every operation, so
// each cost is spelt with __fadd_rn / __fmul_rn in the twin's order:
// ((sad + pen) + lam*4) [+ (-(lam*3)) for mode 2], pen = (top + left) +
// corner; i4_cost sums the chosen costs from 0 in blkIdx order;
// i16_cost + lam*6 < i4_cost.  Argmins take the first minimum, as
// torch.argmin does.  Everything else is int32 with flooring >> and no
// / or % of a negative value.
//
// What bounds it on the H100: bytes, about 2.7 KB an MB (the source, the
// recon and 427 int32 words of levels and modes) or 0.6 us a CIF picture
// at 3.35 TB/s.  What the kernel takes is the chain of dependent steps:
// at CIF the latency of one MB a step (its 16 chained Intra4x4 blocks),
// at 720p and 1080p, whose widest steps hold more MBs than the block has
// warps, the issue rate of the one SM.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PAD = 32;
constexpr int THREADS = 512;
constexpr float BIG = 1e18f;
constexpr unsigned FULL = 0xffffffffu;

// the wrapper's table (intra_encode_fast._tables), int32 words: the
// Intra4x4 gather tables of ops/intra.py [idx (8,4,4,3) | wgt (8,4,4,3) |
// rnd (8,4,4) | sht (8,4,4)] (bank row 0, 1, 2.. 7 = spec modes 0, 1,
// 3.. 8), then QUANT_MF (6,4,4), QUANT_V (6,4,4), QUANT_QBITS (52), the
// intra row of QUANT_F (52) and QP_SCALE_CHROMA (52) of core/tables.py
constexpr int T_IDX = 0, T_WGT = 384, T_RND = 768, T_SHT = 896,
              T_MF = 1024, T_V = 1120, T_QBITS = 1216, T_F = 1268,
              T_QPC = 1320, T_WORDS = 1372;

// a warp's shared memory, int32 words
constexpr int W_SRC = 0;              // luma source, 16x16 raster
constexpr int W_TILE = W_SRC + 256;   // 17x17: row 0 the top-left corner
                                      // and top row, column 0 the left
                                      // column, the body the I4x4 recon
constexpr int W_TR = W_TILE + 289;    // the top-right MB's 8 samples
constexpr int W_X = W_TR + 8;         // scratch
constexpr int W_L = W_X + 256;        // coefficients, I4x4 levels
constexpr int W_CS = W_L + 256;       // chroma source [c][8][8]
constexpr int W_CN = W_CS + 128;      // chroma neighbours [c][tl, t0..7,
                                      // l0..7]
constexpr int W_WORDS = W_CN + 36;
constexpr int SMEM_BYTES = (T_WORDS + (THREADS / 32) * W_WORDS) * 4;

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
  int gw, gh, cqo;
};

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
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

// row u, column i of the forward core transform's matrix
// (1,1,1,1) (2,1,-1,-2) (1,-1,-1,1) (1,-2,2,-1)
__device__ __forceinline__ int fwd_coef(int u, int i) {
  if (u == 0) return 1;
  if (u == 2) return (i == 0 || i == 3) ? 1 : -1;
  if (u == 1) return i == 0 ? 2 : i == 1 ? 1 : i == 2 ? -1 : -2;
  return i == 0 ? 1 : i == 1 ? -2 : i == 2 ? 2 : -1;
}

// row u, column i of the 4x4 Hadamard matrix
// (1,1,1,1) (1,1,-1,-1) (1,-1,-1,1) (1,-1,1,-1)
__device__ __forceinline__ int had_coef(int u, int i) {
  if (u == 0) return 1;
  if (u == 1) return i < 2 ? 1 : -1;
  if (u == 2) return (i == 0 || i == 3) ? 1 : -1;
  return (i == 0 || i == 2) ? 1 : -1;
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

// Intra4x4 prediction of pixel p (raster in the block) in `mode`, from
// the edge vector s = [l3, l2, l1, l0, tl, t0..t7]
__device__ __forceinline__ int pred4(const int* tab, const int* s, int mode,
                                     int p, int dc) {
  if (mode == 2) return dc;
  const int e = (mode < 2 ? mode : mode - 1) * 16 + p;
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    acc += s[tab[T_IDX + e * 3 + k]] * tab[T_WGT + e * 3 + k];
  return (acc + tab[T_RND + e]) >> tab[T_SHT + e];
}

struct Pred16 {
  const int* tile;
  int dc, pa, pb, pc;
  __device__ __forceinline__ int operator()(int mode, int y, int x) const {
    if (mode == 0) return tile[1 + x];
    if (mode == 1) return tile[(1 + y) * 17];
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

// One MB by the 32 lanes of a warp; w is the warp's shared memory.
__device__ void encode_mb(const Args& a, const int* tab, int* w, int lane,
                          int mx, int my, float lam4, float nlam3,
                          float lam6) {
  const int gw = a.gw, m = my * gw + mx;
  const int Wp = gw * 16 + 2 * PAD, Wcp = gw * 8 + 2 * PAD;
  const int y0 = PAD + my * 16, x0 = PAD + mx * 16;
  const int yc0 = PAD + my * 8, xc0 = PAD + mx * 8;
  const bool al = a.al[m], at = a.at[m];
  const bool atr = a.atr ? a.atr[m] != 0 : true;
  const bool atl = a.atl ? a.atl[m] != 0 : true;
  const bool intra = a.mask ? a.mask[m] != 0 : true;
  // H.264 QPs lie in 0..51; a value outside is clamped, not read past the
  // tables
  const int qp = min(max(a.qp[m], 0), 51);
  const int qpc = tab[T_QPC + min(max(qp + a.cqo, 0), 51)];
  const int q6 = (qp % 6) * 16, qc6 = (qpc % 6) * 16;
  int* S = w + W_SRC;
  int* T = w + W_TILE;
  int* TR = w + W_TR;
  int* X = w + W_X;
  int* L = w + W_L;
  int* CS = w + W_CS;
  int* CN = w + W_CN;

  for (int p = lane; p < 256; p += 32)
    S[p] = a.sy[(y0 + (p >> 4)) * Wp + x0 + (p & 15)];
  for (int p = lane; p < 128; p += 32)
    CS[p] = (p < 64 ? a.su : a.sv)[(yc0 + ((p >> 3) & 7)) * Wcp + xc0 +
                                   (p & 7)];
  if (lane < 17)
    T[lane] = a.ry[(y0 - 1) * Wp + x0 - 1 + lane];
  else if (lane < 25)
    TR[lane - 17] = a.ry[(y0 - 1) * Wp + x0 + 16 + lane - 17];
  if (lane < 16) T[(lane + 1) * 17] = a.ry[(y0 + lane) * Wp + x0 - 1];
  for (int p = lane; p < 34; p += 32) {
    const int c = p / 17, k = p % 17;
    const int32_t* P = c ? a.rv : a.ru;
    CN[p] = k == 0 ? P[(yc0 - 1) * Wcp + xc0 - 1]
            : k < 9 ? P[(yc0 - 1) * Wcp + xc0 + k - 1]
                    : P[(yc0 + k - 9) * Wcp + xc0 - 1];
  }
  __syncwarp();

  // ---- Intra16x16 ----------------------------------------------------------
  Pred16 p16;
  p16.tile = T;
  {
    int ts = 0, ls = 0, Hs = 0, Vs = 0;
    for (int k = 0; k < 16; ++k) {
      ts += T[1 + k];
      ls += T[(1 + k) * 17];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      Hs += (k + 1) * (T[1 + 8 + k] - (k == 7 ? T[0] : T[1 + 6 - k]));
      Vs += (k + 1) * (T[(1 + 8 + k) * 17] -
                       (k == 7 ? T[0] : T[(1 + 6 - k) * 17]));
    }
    p16.dc = dc_rule(at, al, ts, ls, 5, 4);
    p16.pa = 16 * (T[16 * 17] + T[16]);
    p16.pb = (5 * Hs + 32) >> 6;
    p16.pc = (5 * Vs + 32) >> 6;
  }
  int i16m = 0;
  float i16c;
  {
    int sad[4] = {0, 0, 0, 0};
    for (int i = 0; i < 8; ++i) {
      const int p = lane + 32 * i, y = p >> 4, x = p & 15, s = S[p];
#pragma unroll
      for (int k = 0; k < 4; ++k) sad[k] += abs(p16(k, y, x) - s);
    }
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = (float)warp_sum(sad[k]);
    c[0] = __fadd_rn(c[0], at ? 0.f : BIG);
    c[1] = __fadd_rn(c[1], al ? 0.f : BIG);
    c[3] = __fadd_rn(c[3], at && al && atl ? 0.f : BIG);
    i16c = c[0];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (c[k] < i16c) {
        i16c = c[k];
        i16m = k;
      }
  }
  // residual into X, forward transform into L (lane: coefficients ci =
  // lane + 32 i of the (16 blkIdx, 4, 4) layout), DC Hadamard and
  // quantisation, dequantised levels back into L
  const int cu = (lane >> 2) & 3, cv = lane & 3;
  for (int i = 0; i < 8; ++i) {
    const int p = lane + 32 * i;
    X[p] = S[p] - p16(i16m, p >> 4, p & 15);
  }
  __syncwarp();
  for (int i = 0; i < 8; ++i) {
    const int b = (lane >> 4) + 2 * i;
    L[lane + 32 * i] = fdct(X + blk_y(b) * 16 + blk_x(b), 16, cu, cv);
  }
  __syncwarp();
  if (lane < 16) X[blk_raster(lane)] = L[lane * 16];  // DCs, raster order
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
  for (int i = 0; i < 8; ++i) {
    const int ci = lane + 32 * i;
    const bool dcs = (ci & 15) == 0;
    const int z = dcs ? 0 : quant(L[ci], mf, fq, qbits);
    a.lac[m * 256 + ci] = z;
    L[ci] = dcs ? X[32 + blk_raster(ci >> 4)] : dequant(z, ls, qp);
  }
  __syncwarp();
  // inverse transform: rows into X, then columns; the I16 recon goes
  // straight to the recon plane (replaced below when I4 wins or the MB is
  // not intra)
  for (int i = 0; i < 8; ++i) {
    const int r = ((lane + 32 * i) & ~15) + cu * 4;
    X[lane + 32 * i] = ict(L[r], L[r + 1], L[r + 2], L[r + 3], cv);
  }
  __syncwarp();
  for (int i = 0; i < 8; ++i) {
    const int ci = lane + 32 * i, base = ci & ~15, b = ci >> 4;
    const int h = ict(X[base + cv], X[base + 4 + cv], X[base + 8 + cv],
                      X[base + 12 + cv], cu);
    const int y = blk_y(b) + cu, x = blk_x(b) + cv;
    if (intra)
      a.ry[(y0 + y) * Wp + x0 + x] = clip255(p16(i16m, y, x) +
                                             ((h + 32) >> 6));
  }
  __syncwarp();

  // ---- Intra4x4, 16 blocks in blkIdx order ---------------------------------
  float i4c = 0.f;
  const int p = lane & 15, py = p >> 2, px = p & 3, half = lane >> 4;
  for (int blk = 0; blk < 16; ++blk) {
    const int bx = blk_x(blk), by = blk_y(blk);
    const bool sub = blk == 3 || blk == 7 || blk == 11 || blk == 13 ||
                     blk == 15 || (blk == 5 && (mx == gw - 1 || !atr));
    const bool bat = by == 0 ? at : true, bal = bx == 0 ? al : true;
    const bool batl = (bx == 0 && by == 0) ? atl
                      : by == 0            ? at
                      : bx == 0            ? al
                                           : true;
    // the edge vector s = [l3, l2, l1, l0, tl, t0..t7] into X[0..12], the
    // top-right four substituted by t3 where they are never available
    if (lane < 13) {
      int v;
      if (lane < 4) {
        v = T[(by + 4 - lane) * 17 + bx];
      } else if (lane == 4) {
        v = T[by * 17 + bx];
      } else {
        const int k = (sub && lane >= 9) ? 3 : lane - 5, xx = bx + k;
        v = (by == 0 && xx >= 16) ? TR[xx - 16] : T[by * 17 + 1 + xx];
      }
      X[lane] = v;
    }
    __syncwarp();
    const int src = S[(by + py) * 16 + bx + px];
    const int dc4 = dc_rule(bat, bal, X[5] + X[6] + X[7] + X[8],
                            X[0] + X[1] + X[2] + X[3], 3, 2);
    int sd[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int mode = 2 * k + half;  // half 0: 0 2 4 6 8, half 1: 1 3 5 7
      sd[k] = mode < 9 ? abs(pred4(tab, X, mode, p, dc4) - src) : 0;
#pragma unroll
      for (int o = 8; o; o >>= 1) sd[k] += __shfl_xor_sync(FULL, sd[k], o);
    }
    int od[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) od[k] = __shfl_xor_sync(FULL, sd[k], 16);
    float best = 0.f;
    int bm = 0;
#pragma unroll
    for (int mode = 0; mode < 9; ++mode) {
      const int s = ((mode & 1) == half) ? sd[mode >> 1] : od[mode >> 1];
      const float pen = __fadd_rn(
          __fadd_rn((NEED_TOP >> mode & 1) && !bat ? BIG : 0.f,
                    (NEED_LEFT >> mode & 1) && !bal ? BIG : 0.f),
          (NEED_TL >> mode & 1) && !batl ? BIG : 0.f);
      float c = __fadd_rn(__fadd_rn((float)s, pen), lam4);
      if (mode == 2) c = __fadd_rn(c, nlam3);
      if (mode == 0 || c < best) {
        best = c;
        bm = mode;
      }
    }
    i4c = __fadd_rn(i4c, best);
    const int pred = pred4(tab, X, bm, p, dc4);
    if (lane < 16) X[16 + p] = src - pred;
    if (lane == 0) a.i4m[m * 16 + blk] = bm;
    __syncwarp();
    const int q = quant(fdct(X + 16, 4, py, px), tab[T_MF + q6 + p], fq,
                        qbits);
    if (lane < 16) {
      L[blk * 16 + p] = q;
      X[32 + p] = dequant(q, 16 * tab[T_V + q6 + p], qp);
    }
    __syncwarp();
    const int f = ict(X[32 + py * 4], X[33 + py * 4], X[34 + py * 4],
                      X[35 + py * 4], px);
    if (lane < 16) X[48 + p] = f;
    __syncwarp();
    const int h = ict(X[48 + px], X[52 + px], X[56 + px], X[60 + px], py);
    if (lane < 16)
      T[(by + 1 + py) * 17 + 1 + bx + px] = clip255(pred + ((h + 32) >> 6));
    __syncwarp();
  }

  // ---- I16 against I4; the MB's luma outputs -------------------------------
  const bool use16 = __fadd_rn(i16c, lam6) < i4c;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = lane + 32 * i, b = ci >> 4;
    const int y = blk_y(b) + cu, x = blk_x(b) + cv;
    const int at_ = (y0 + y) * Wp + x0 + x;
    if (!intra)
      a.ry[at_] = a.by ? a.by[at_] : 0;
    else if (!use16)
      a.ry[at_] = T[(y + 1) * 17 + 1 + x];
    if (!use16) a.lac[m * 256 + ci] = L[ci];
  }
  if (lane < 16) a.ldc[m * 16 + lane] = use16 ? dcq : 0;
  if (lane == 0) {
    a.use16[m] = use16;
    a.i16m[m] = i16m;
  }
  __syncwarp();

  // ---- chroma --------------------------------------------------------------
  const PredC pu = chroma_pred(CN, at, al), pv = chroma_pred(CN + 17, at, al);
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
    c[2] = __fadd_rn(c[2], at ? 0.f : BIG);
    c[1] = __fadd_rn(c[1], al ? 0.f : BIG);
    c[3] = __fadd_rn(c[3], at && al && atl ? 0.f : BIG);
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
    const int ci = lane + 32 * i, b = (ci >> 4) & 3;
    L[ci] = fdct(X + (ci >> 6) * 64 + (b >> 1) * 32 + (b & 1) * 4, 8, cu,
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
    a.cdc[m * 8 + lane] = cdq;
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
      a.cac[m * 128 + ci] = z;
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
    const int ci = lane + 32 * i, base = ci & ~15, b = (ci >> 4) & 3;
    const int h = ict(X[base + cv], X[base + 4 + cv], X[base + 8 + cv],
                      X[base + 12 + cv], cu);
    const int y = (b >> 1) * 4 + cu, x = (b & 1) * 4 + cv;
    const int at_ = (yc0 + y) * Wcp + xc0 + x;
    const bool v = ci >= 64;
    const int32_t* B = v ? a.bv : a.bu;
    (v ? a.rv : a.ru)[at_] =
        intra ? clip255((v ? pv : pu)(cmode, y, x) + ((h + 32) >> 6))
              : (B ? B[at_] : 0);
  }
  if (lane == 0) a.cm[m] = cmode;
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS) k_intra_encode(Args a) {
  extern __shared__ int smem[];
  int* tab = smem;
  for (int i = threadIdx.x; i < T_WORDS; i += blockDim.x) tab[i] = a.tab[i];
  const float lam = *a.lam;
  const float lam4 = __fmul_rn(lam, 4.f), nlam3 = -__fmul_rn(lam, 3.f);
  const float lam6 = __fmul_rn(lam, 6.f);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int* w = smem + T_WORDS + warp * W_WORDS;
  __syncthreads();
  const int steps = a.gw + 2 * a.gh - 2;
  for (int d = 0; d < steps; ++d) {
    // the MBs (d - 2 my, my) inside the picture
    const int lo = max(0, (d - a.gw + 2) / 2), hi = min(a.gh - 1, d / 2);
    for (int my = lo + warp; my <= hi; my += nwarps)
      encode_mb(a, tab, w, lane, d - 2 * my, my, lam4, nlam3, lam6);
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is device memory
// that the caller allocated and checked: PAD-padded int32 planes of the
// picture's size (ry/ru/rv zeroed), (gh, gw) maps, the outputs contiguous
// int32 (gh, gw, ...) arrays; by/bu/bv, atr, atl and mask may be null.
// Returns 0 or the CUDA error code of the launch.
extern "C" int hl_intra_encode_frame(
    const int32_t* sy, const int32_t* su, const int32_t* sv,
    const int32_t* by, const int32_t* bu, const int32_t* bv,
    const int32_t* qp, const uint8_t* al, const uint8_t* at,
    const uint8_t* atr, const uint8_t* atl, const uint8_t* mask,
    const int32_t* tab, const float* lam, int32_t* ry, int32_t* ru,
    int32_t* rv, int32_t* use16, int32_t* i16m, int32_t* i4m, int32_t* cm,
    int32_t* ldc, int32_t* lac, int32_t* cdc, int32_t* cac, int gw, int gh,
    int chroma_qp_off, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      k_intra_encode, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Args a{sy, su, sv, by, bu, bv, qp, al, at, atr, atl, mask, tab, lam,
         ry, ru, rv, use16, i16m, i4m, cm, ldc, lac, cdc, cac, gw, gh,
         chroma_qp_off};
  k_intra_encode<<<1, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel's resources as the runtime reports them: out[0..4] = the
// dynamic shared memory it launches with, registers per thread, local
// (spill) bytes per thread, static shared memory, the most threads a
// block may have.  Returns 0 or the CUDA error code.
extern "C" int hl_intra_encode_attributes(int* out) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, k_intra_encode);
  out[0] = SMEM_BYTES;
  out[1] = f.numRegs;
  out[2] = (int)f.localSizeBytes;
  out[3] = (int)f.sharedSizeBytes;
  out[4] = f.maxThreadsPerBlock;
  return (int)err;
}
