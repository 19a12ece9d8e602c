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
// is at least gw + 2 gh - 2 MB latencies long.  There is no decision
// inside an MB.
//
// Design.
// - The schedule of intra_encode.cu: one block per MB row (gh blocks of
//   64 threads, a cooperative launch, so all rows are resident and their
//   spin-waits cannot deadlock).  Row my walks its MBs left to right and
//   starts an intra MB (mx, my) once row my - 1 has published MB
//   min(mx + 1, gw - 1) (device_prims.cuh: thread 0's acquire load of the
//   row's progress counter, a release store after a block barrier that
//   orders the MB's stores).  Every MB is published, intra or not; an MB
//   of another kind neither waits nor computes, since its samples are
//   the input's.  The neighbours are read from the output planes with
//   __ldcg (other SMs write them during the launch).
// - The MB's residual (384 words) and its modes and flags are loaded into
//   registers one MB ahead, and staged in shared memory.
// - Warp 0 runs luma.  I4x4: the ten steps of the MB's 4x4 wavefront
//   (block (bc, br) at step bc + 2 br reads its left, top, top-left and
//   top-right neighbours, steps - 1, - 2, - 3, - 1), up to two blocks a
//   step, 16 lanes a block and one sample a lane, in a 17x25 tile of
//   shared memory (row 0 the top-left corner, the top row and the
//   above-right MB's first 8 samples, column 0 the left column); each
//   sample is one entry of the integer mode tables of ops/intra (three
//   taps of the 13-sample edge vector, a rounding and a shift), the DC
//   mode the average of the available edges.  I16: the sums by warp
//   reductions, 8 samples a lane.  Warp 1 runs chroma beside it, 4
//   samples a lane.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_prims.cuh"

namespace {

constexpr int PAD = 32;
// the block: a luma warp and a chroma warp
constexpr int THREADS = 64;
constexpr unsigned FULL = 0xffffffffu;

// the wrapper's table (d_gop_fast._i4tab), int32 words: the Intra4x4
// directional modes' tap indices (8,4,4,3), weights (8,4,4,3), roundings
// (8,4,4) and shifts (8,4,4) over the edge vector s = [l3, l2, l1, l0,
// tl, t0..t7]; table row 0, 1, 2..7 holds mode 0, 1, 3..8
constexpr int T_IDX = 0, T_WGT = 384, T_RND = 768, T_SHT = 896,
              T_WORDS = 1024;

// the MB's parameters as staged: kind, Intra16x16 mode, chroma mode, the
// left, top and top-right availability, the 16 Intra4x4 modes
constexpr int P_KIND = 0, P_I16 = 1, P_CM = 2, P_AL = 3, P_AT = 4,
              P_ATR = 5, P_I4 = 6, P_WORDS = 22;

// the block's shared memory, int32 words
constexpr int TW = 25;                  // row stride of the luma tile
constexpr int S_TAB = 0;
constexpr int S_TILE = S_TAB + T_WORDS;  // 17 x TW
constexpr int S_CN = S_TILE + 17 * TW;  // chroma neighbours [c][tl, t0..7,
                                        // l0..7]
constexpr int S_RES = S_CN + 34;        // luma residual 16x16 raster, then
                                        // U and V 8x8
constexpr int S_PAR = S_RES + 384;
constexpr int SMEM_WORDS = S_PAR + P_WORDS;
constexpr int SMEM_BYTES = SMEM_WORDS * 4;

// residual words a thread prefetches
constexpr int PF = 384 / THREADS;

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

// blkIdx -> the block's pixel offsets in its MB
__device__ __forceinline__ int blk_x(int b) {
  return 8 * ((b >> 2) & 1) + 4 * (b & 1);
}
__device__ __forceinline__ int blk_y(int b) {
  return 8 * (b >> 3) + 4 * ((b >> 1) & 1);
}

// offset in the tile of edge sample i from the block's top-left corner
// sample
__device__ __forceinline__ int edge_off(int i) {
  return i <= 4 ? (4 - i) * TW : i - 4;
}

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(FULL, (unsigned)v);
}

// One Intra4x4 block by 16 lanes, lane l = 4 y + x its sample (x, y):
// the prediction from the tile, the residual, the recon into the tile.
__device__ __forceinline__ void intra4_block(const int* tab, const int* P,
                                             const int* R, int* T, int blk,
                                             int l, bool at_edge) {
  const int bx = blk_x(blk), by = blk_y(blk);
  const int x = l & 3, y = l >> 2;
  // the top-right samples never available: blocks 3 7 11 13 15, and 5 at
  // the right picture edge or without the above-right MB
  const bool sub = ((0xA888 >> blk) & 1) |
                   ((blk == 5) & (at_edge | (P[P_ATR] == 0)));
  const int* base = T + by * TW + bx;
  const int mode = clampi(0, 8, P[P_I4 + blk]);
  int pred;
  if (mode == 2) {
    const bool bat = by != 0 || P[P_AT] != 0;
    const bool bal = bx != 0 || P[P_AL] != 0;
    const int ts = base[1] + base[2] + base[3] + base[4];
    const int ls = base[TW] + base[2 * TW] + base[3 * TW] + base[4 * TW];
    pred = dc_rule(bat, bal, ts, ls, 3, 2);
  } else {
    const int e = ((mode < 2 ? mode : mode - 1) * 4 + y) * 4 + x;
    int acc = tab[T_RND + e];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = tab[T_IDX + e * 3 + k];
      acc += base[edge_off(sub && i >= 9 ? 8 : i)] * tab[T_WGT + e * 3 + k];
    }
    pred = acc >> tab[T_SHT + e];
  }
  T[(by + 1 + y) * TW + bx + 1 + x] =
      clip255(pred + R[(by + y) * 16 + bx + x]);
}

// Warp 0, I4x4: the ten steps of the MB's 4x4 wavefront, block (bc, br)
// at step bc + 2 br, two a step at most (lanes 0-15 the one with the
// larger bc), then the tile's body to the plane.
__device__ void luma_i4(const int* tab, const int* P, const int* R, int* T,
                        int32_t* oy, size_t y0, int x0, int Wp, int lane,
                        bool at_edge) {
  const int h = lane >> 4;
  for (int s = 0; s < 10; ++s) {
    const int br = (s < 3 ? 0 : (s - 2) >> 1) + h, bc = s - 2 * br;
    if (br <= 3 && bc >= 0)
      intra4_block(tab, P, R, T,
                   8 * (br >> 1) + 2 * (br & 1) + 4 * (bc >> 1) + (bc & 1),
                   lane & 15, at_edge);
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int p = lane + 32 * k, y = p >> 4, x = p & 15;
    oy[(y0 + y) * Wp + x0 + x] = T[(y + 1) * TW + 1 + x];
  }
}

// Warp 0, I16: the four predictions' sums by warp reductions, then 8
// samples a lane.
__device__ void luma_i16(const int* P, const int* R, const int* T,
                         int32_t* oy, size_t y0, int x0, int Wp, int lane) {
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
    oy[(y0 + y) * Wp + x0 + x] = clip255(pred + R[p]);
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

// Warp 1: both chroma components, 4 samples a lane (U for j < 2).
__device__ void chroma(const int* P, const int* R, const int* CN,
                       int32_t* ou, int32_t* ov, size_t yc0, int xc0,
                       int Wcp, int lane) {
  const bool at = P[P_AT] != 0, al = P[P_AL] != 0;
  const int mode = clampi(0, 3, P[P_CM]);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const PredC pc = chroma_pred(CN + 17 * c, at, al);
    int32_t* O = c ? ov : ou;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = lane + 32 * j, y = p >> 3, x = p & 7;
      O[(yc0 + y) * Wcp + xc0 + x] =
          clip255(pc(mode, y, x) + R[256 + 64 * c + p]);
    }
  }
}

// One block of THREADS per MB row, SMEM_BYTES of dynamic shared memory;
// launched cooperatively by hl_intra_decode.
__global__ void __launch_bounds__(THREADS) k_intra_decode(Args a) {
  int* sm = block_smem();
  int* tab = sm + S_TAB;
  int* T = sm + S_TILE;
  int* CN = sm + S_CN;
  int* R = sm + S_RES;
  int* P = sm + S_PAR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int my = blockIdx.x, gw = a.gw;
  const int Wp = gw * 16 + 2 * PAD, Wcp = gw * 8 + 2 * PAD;
  for (int i = tid; i < T_WORDS; i += THREADS) tab[i] = a.tab[i];

  // an MB's residual words (luma raster, then U and V) and its
  // parameters, read one MB ahead: nothing writes them
  int pf[PF], pp = 0;
  auto prefetch = [&](int mx) {
    const int m = my * gw + mx;
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int i = tid + k * THREADS;
      pf[k] = i < 256 ? a.res_y[(size_t)m * 256 + i]
                      : a.res_c[(size_t)m * 128 + i - 256];
    }
    if (tid < P_WORDS)
      pp = tid == P_KIND  ? a.kind[m]
           : tid == P_I16 ? a.i16m[m]
           : tid == P_CM  ? a.cm[m]
           : tid == P_AL  ? a.al[m]
           : tid == P_AT  ? a.at[m]
           : tid == P_ATR ? (a.atr ? a.atr[m] : 1)
                          : a.i4m[(size_t)m * 16 + tid - P_I4];
  };
  prefetch(0);
  for (int mx = 0; mx < gw; ++mx) {
    // the previous MB's readers of R, P, T and CN are done: the barrier
    // that ended it
#pragma unroll
    for (int k = 0; k < PF; ++k) R[tid + k * THREADS] = pf[k];
    if (tid < P_WORDS) P[tid] = pp;
    __syncthreads();
    const int kind = P[P_KIND];
    const bool intra = kind == 0 || kind == 1;  // the same in every thread
    if (intra) {
      // wait for row my - 1 to publish MB min(mx + 1, gw - 1)
      if (my > 0 && tid == 0) wait_progress(a.prog + my - 1, min(mx + 2, gw));
      __syncthreads();
    }
    if (mx + 1 < gw) prefetch(mx + 1);
    if (intra) {
      const size_t y0 = PAD + 16 * my, yc0 = PAD + 8 * my;
      const int x0 = PAD + 16 * mx, xc0 = PAD + 8 * mx;
      // the neighbours, with the twin's values outside the picture
      for (int i = tid; i < 25 + 16 + 34; i += THREADS) {
        int v = 0;
        if (i < 25) {  // tile row 0: top-left, top, above-right
          if (my > 0) {
            if (i == 0 && mx == 0)
              v = my > 1 ? a.iy[(size_t)(PAD + 15) * Wp + PAD + 15] : 0;
            else if (i > 16 && mx == gw - 1)
              v = a.iy[(size_t)(PAD + 15) * Wp + PAD + i - 17];
            else
              v = __ldcg(a.oy + (y0 - 1) * Wp + x0 - 1 + i);
          }
          T[i] = v;
        } else if (i < 41) {  // tile column 0: the left column
          const int r = i - 25;
          if (mx > 0)
            v = __ldcg(a.oy + (y0 + r) * Wp + x0 - 1);
          else if (my > 0)
            v = a.iy[(size_t)(PAD + r) * Wp + PAD + 15];
          T[(r + 1) * TW] = v;
        } else {  // chroma: top-left, top, left
          const int p = i - 41, c = p / 17, k = p % 17;
          const int32_t* O = c ? a.ov : a.ou;
          const int32_t* I = c ? a.iv : a.iu;
          if (k == 0) {
            if (my > 0)
              v = mx > 0 ? __ldcg(O + (yc0 - 1) * Wcp + xc0 - 1)
                  : my > 1 ? I[(size_t)(PAD + 7) * Wcp + PAD + 7]
                           : 0;
          } else if (k < 9) {
            if (my > 0) v = __ldcg(O + (yc0 - 1) * Wcp + xc0 + k - 1);
          } else if (mx > 0) {
            v = __ldcg(O + (yc0 + k - 9) * Wcp + xc0 - 1);
          } else if (my > 0) {
            v = I[(size_t)(PAD + k - 9) * Wcp + PAD + 7];
          }
          CN[p] = v;
        }
      }
      __syncthreads();
      if (warp == 0) {
        if (kind == 0)
          luma_i4(tab, P, R, T, a.oy, y0, x0, Wp, lane, mx == gw - 1);
        else
          luma_i16(P, R, T, a.oy, y0, x0, Wp, lane);
      } else {
        chroma(P, R, CN, a.ou, a.ov, yc0, xc0, Wcp, lane);
      }
    }
    // publish the MB to row my + 1: the barrier orders its stores before
    // thread 0's release
    __syncthreads();
    if (tid == 0) st_release(a.prog + my, mx + 1);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is device memory
// that the caller allocated and checked: the PAD-padded int32 input planes
// and their copies (oy, ou, ov), which the kernel writes; the contiguous
// int32 residuals (gh, gw, 16, 16) and (gh, gw, 2, 8, 8), kind, i16m and
// cm (gh, gw) and i4m (gh, gw, 16) int32, al, at and atr (gh, gw) bool
// (atr may be null), the mode table, and prog, gh zeroed ints.
// `threads`: the block size the caller expects, THREADS.  Launches gh
// co-resident blocks (a cooperative launch, refused when they cannot all
// be resident).  Returns 0 or the CUDA error code of the launch.
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
                                          SMEM_BYTES, stream);
}
