// The encoder's motion search for Hopper (sm_90a): the integer full search
// and the 9-point sub-pel refinement, one or two rounds in one launch.
//
// Replaces hartallo_tpu/encode/me.py:full_search_int and refine_subpel,
// the XLA code inside p_device.p_frame_device (one full search and two
// refinement rounds a P picture).  Their plain twins are
// hartallo_tpu_torch/encode/me.py:full_search_int and refine_subpel, which
// these kernels match bit for bit; the wrappers are
// hartallo_tpu_torch/encode/me_fast.py.
//
// Samples.  Every plane that reaches these kernels holds samples 0..255:
// the source is packed from uint8 (e_device.pack_src), the reference is a
// clamped recon, and the edge and halo pads copy samples.  The full search
// relies on it: it keeps the planes as bytes.  Nothing checks it on the
// device (that needs a host sync).
//
// k_full_search, one block per strip of `strip` neighbouring MBs of one MB
// row, one warp per MB.  For each candidate c of the (2R+1)^2 offsets
// (dy = c / side - R, dx = c % side - R) it computes the SADs s8[k] of the
// MB's four 8x8 quadrants against the reference shifted by (dy, dx); the
// cost of quadrant k is s8[k] + lam * (se(4 dx) + se(4 dy)), and the 16x16,
// 16x8 and 8x16 costs are sums of those.  For each of the 9 partitions it
// keeps the first minimum in candidate order, as the twin's chunked argmin
// with its "strictly better than the carry" does.
//   - The block loads the strip's (16 + 2R) x (16 strip + 2R) reference
//     window once, as bytes, in four copies: copy s holds the window
//     shifted left by s bytes, so that the four samples at any dx are one
//     aligned 32-bit word (dx = 4q + s reads copy s at word q).
//   - Each lane keeps its MB's 256 source samples in 64 registers and
//     takes items (dx, a run of FS_G candidate rows dy): it streams the
//     FS_G + 15 window rows once and adds each row's four words into the
//     SADs of every candidate of the run that the row overlaps, four
//     samples a __vsadu4.  So a window word is read from shared memory
//     once for FS_G candidates, and no source sample is.
//   - The items of an MB (side x ceil(side / FS_G): 125 at R = 12) are
//     strided over the warp's lanes (4 passes of 32, 3 lanes idle in the
//     last).  A lane keeps a best (cost, index) per partition, ties broken
//     by the index, and the warp reduces them as one 64-bit key each (the
//     cost's bits, ordered, above the candidate index plus one) with
//     shuffles.  Index 0 is the twin's carry (cost 1e18, MV 0), which a
//     candidate must beat strictly.
//   - The strip is 8 MBs where that still gives every SM a block, else 4,
//     2 or 1 (fs_strip: 8 at 720p and 1080p, 2 at CIF); the warps of a
//     ragged last strip past the row's end only help load.
//
// k_refine, a warp per two MBs, a lane per 4x4 block, the nine deltas in
// the lane's registers; blocks of RF_WARPS warps that share nothing but
// the QPT table, so nothing waits on more than its warp.  Each round the
// warp first stages its 32 blocks' windows into shared memory, a window a
// pass, neighbouring lanes on neighbouring words: a window is the RS x RS
// samples of each plane of the half-pel stack [G, b, h, j] that the
// block's nine deltas' taps reach (RS 6 for steps up to 2).  Then a lane
// computes each delta's quarter-pel prediction from its window exactly as
// ops/wide.mc_luma_plane does (clamped block origin, two taps chosen by
// the quarter-pel case, (A + B + 1) >> 1, identity weighting), the SATD
// (sum |H d H| >> 1, the last butterfly stage folded into a maximum) or
// SAD in registers and the MV's bits, and adds them into its partition's
// exact integer sums for the delta in shared memory (distortion and bits
// packed in one word, integer atomics: the order does not change a sum).
// Lane n of an MB then takes partition n: the mean bits, the cost
// lam * pbits + psad rounded once for each delta, and the first minimum
// in me._DELTAS order; every lane moves its block's MV by its
// partition's delta.  With two steps the MVs stay in the lanes' registers
// and the second round (the quarter-pel one on p_device's path) runs on
// the MVs the first just chose: the twin's chain refine_subpel(step 2) ->
// refine_subpel(step 1).  It writes the final MVs and the last round's
// costs.
//
// Rounding.  The costs are the only floating-point values.  nvcc contracts
// a*b + c into an FMA by default, so each is spelt out in the twin's order:
// __fmul_rn for the penalty, __fadd_rn for every sum of the full search
// (sum4 runs left to right), __fdiv_rn for the mean bits and one
// __fmaf_rn for the refinement cost (the twin's fma_f32, XLA's contraction
// on the CPU).  Integers: flooring >> and & on negative MVs, no / or % of
// a negative value.
//
// What bounds them on the H100.  The full search: operations, (2R+1)^2 H W
// candidate samples at four a byte-SIMD lane-instruction, 64 int32 lanes a
// clock on each of the 132 SMs: 19.5 us a 1080p picture (1,088 coded rows)
// at R = 12 and 1.98 GHz.  The kernel issues about two integer
// instructions (VABSDIFF4, add) per four samples, plus about 60 a
// candidate for the costs and keys.  The refinement launch: bytes, the
// source and the four half-pel planes over the picture read once, the MVs
// and the partition map read, the MVs and costs written (13.3 us a 1080p
// launch at 3.35 TB/s).  Measured, it issues instructions: the nine
// deltas' predictions and transforms are most of the work, and the
// staged windows keep the per-pair overhead and the global loads down.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PAD = 32;
constexpr int FS_STRIP_MAX = 8;       // MBs a full-search block, a warp each
constexpr int FS_G = 5;               // candidate rows an item runs over
constexpr int H100_SMS = 132;
constexpr int RF_WARPS = 2;           // warps a refinement block, 2 MBs each
constexpr int RF_THREADS = RF_WARPS * 32;
constexpr int RF_MAX_STEP = 8;        // the widest step the windows cover
constexpr float BIG = 1e18f;
constexpr unsigned FULL = 0xffffffffu;

// quarter-pel case 4 (mvy & 3) + (mvx & 3) -> (plane, dx, dy) of the two
// taps averaged; planes 0 = G, 1 = b, 2 = h, 3 = j (ops/wide._QPT)
__constant__ int QPT[16 * 6] = {
    0, 0, 0, 0, 0, 0,  0, 0, 0, 1, 0, 0,  1, 0, 0, 1, 0, 0,
    1, 0, 0, 0, 1, 0,  0, 0, 0, 2, 0, 0,  1, 0, 0, 2, 0, 0,
    1, 0, 0, 3, 0, 0,  1, 0, 0, 2, 1, 0,  2, 0, 0, 2, 0, 0,
    2, 0, 0, 3, 0, 0,  3, 0, 0, 3, 0, 0,  3, 0, 0, 2, 1, 0,
    2, 0, 0, 0, 0, 1,  2, 0, 0, 1, 0, 1,  3, 0, 0, 1, 0, 1,
    2, 1, 0, 1, 0, 1};
// the refinement deltas in the twin's order (me._DELTAS): (0, 0), (-1, 0),
// (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1), (1, 1)
__host__ __device__ constexpr int delta_x(int d) {
  return d == 0 ? 0 : d == 1 ? -1 : d == 2 ? 1 : d < 5 ? 0 : (d & 1) ? -1 : 1;
}
__host__ __device__ constexpr int delta_y(int d) {
  return d < 3 ? 0 : d == 3 ? -1 : d == 4 ? 1 : d < 7 ? -1 : 1;
}

// Exp-Golomb signed code length of v: 2 floor(log2(2|v| + 1)) + 1
__device__ __forceinline__ int se_bits(int v) {
  const int k = 2 * (v < 0 ? -v : v) + 1;
  return 2 * (31 - __clz(k)) + 1;
}

// (cost, idx) as one key whose unsigned order is the lexicographic order
__device__ __forceinline__ unsigned long long cost_key(float c,
                                                       unsigned idx) {
  unsigned u = __float_as_uint(c);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | idx;
}

__device__ __forceinline__ float key_cost(unsigned long long k) {
  unsigned u = (unsigned)(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned hi = (unsigned)__shfl_xor_sync(FULL, (int)(k >> 32), o);
    const unsigned lo = (unsigned)__shfl_xor_sync(FULL, (int)(unsigned)k, o);
    const unsigned long long other = ((unsigned long long)hi << 32) | lo;
    k = other < k ? other : k;
  }
  return k;
}

struct FsArgs {
  const int32_t* src;   // PAD-padded source plane, row stride src_stride
  const int32_t* ref;   // PAD-padded reference plane, row stride ref_stride
  const float* lam;     // lambda_motion, one f32 on the device
  float* c16;           // (gh, gw)
  int32_t* v16;         // (gh, gw, 2)
  float* c168;          // (gh, gw, 2)
  int32_t* v168;        // (gh, gw, 2, 2)
  float* c816;          // (gh, gw, 2)
  int32_t* v816;        // (gh, gw, 2, 2)
  float* c88;           // (gh, gw, 4)
  int32_t* v88;         // (gh, gw, 4, 2)
  int src_stride, ref_stride, gw, gh, rng;
  int strip;            // MBs a block
  int side, groups;     // 2R + 1 candidates a side; ceil(side / FS_G)
  int ww, copy;         // words a window row; words a window copy
};

// the widest strip (8, 4, 2 MBs) that still gives each SM a block, else 1
inline int fs_strip(int gw, int gh) {
  for (int k = FS_STRIP_MAX; k > 1; k >>= 1)
    if (gh * ((gw + k - 1) / k) >= H100_SMS) return k;
  return 1;
}

inline FsArgs fs_args(const int32_t* src, const int32_t* ref,
                      const float* lam, float* c16, int32_t* v16,
                      float* c168, int32_t* v168, float* c816,
                      int32_t* v816, float* c88, int32_t* v88,
                      int src_stride, int ref_stride, int gw, int gh,
                      int rng, int strip) {
  const int side = 2 * rng + 1, groups = (side + FS_G - 1) / FS_G;
  // the last word of a row is never read (it only feeds the shifts)
  const int ww = (16 * strip + 2 * rng + 3) / 4 + 1;
  // a copy's size is 8 words past a multiple of 32, so that the four
  // copies of one word sit in four banks 8 apart
  const int words = (groups * FS_G + 15) * ww;
  const int copy = words + (40 - words % 32) % 32;
  return FsArgs{src, ref, lam, c16, v16, c168, v168, c816, v816, c88, v88,
                src_stride, ref_stride, gw, gh, rng, strip, side, groups,
                ww, copy};
}

// dynamic shared memory of k_full_search, bytes: the four window copies
// and the strip's source, packed
inline int fs_smem_bytes(const FsArgs& a) {
  return 4 * (4 * a.copy + 64 * a.strip);
}

// sum of |a_i - b_i| over the four bytes, added to acc
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b,
                                         unsigned acc) {
  return __vsadu4(a, b) + acc;
}

__global__ void __launch_bounds__(FS_STRIP_MAX * 32) k_full_search(
    FsArgs a) {
  extern __shared__ int smem[];
  unsigned* win = reinterpret_cast<unsigned*>(smem);       // [4][copy]
  unsigned* s_src = win + 4 * a.copy;                      // [strip][16][4]
  const int rng = a.rng, ww = a.ww, side = a.side;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int m0 = blockIdx.x * a.strip, my = blockIdx.y;
  const int live = min(a.strip, a.gw - m0);                // MBs in the strip
  const int rows = a.groups * FS_G + 15;
  const int wrows = 16 + 2 * rng, wcols = 16 * live + 2 * rng;
  const int32_t* ref = a.ref + (long long)(PAD + my * 16 - rng) *
                       a.ref_stride + PAD + m0 * 16 - rng;
  // copy 0: the window as bytes (rows past the window, for the masked
  // candidates of a last run, and columns past it are 0)
  for (int r = warp; r < rows; r += nwarps) {
    const int32_t* p = ref + (long long)r * a.ref_stride;
    for (int w = lane; w < ww; w += 32) {
      unsigned word = 0;
      if (r < wrows) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * w + b < wcols) word |= (unsigned)p[4 * w + b] << (8 * b);
      }
      win[r * ww + w] = word;
    }
  }
  for (int i = t; i < live * 64; i += blockDim.x) {
    const int m = i >> 6, y = (i >> 2) & 15, w = i & 3;
    const int32_t* p = a.src + (long long)(PAD + my * 16 + y) *
                       a.src_stride + PAD + (m0 + m) * 16 + 4 * w;
    s_src[i] = (unsigned)p[0] | (unsigned)p[1] << 8 |
               (unsigned)p[2] << 16 | (unsigned)p[3] << 24;
  }
  __syncthreads();
  // copies 1..3: the window shifted left by 1..3 bytes
  for (int r = warp; r < rows; r += nwarps) {
    const unsigned* c0 = win + r * ww;
    for (int w = lane; w < ww; w += 32) {
      const unsigned lo = c0[w], hi = w + 1 < ww ? c0[w + 1] : 0u;
#pragma unroll
      for (int s = 1; s < 4; ++s)
        win[s * a.copy + r * ww + w] = __funnelshift_r(lo, hi, 8 * s);
    }
  }
  __syncthreads();
  const int m = warp;
  if (m >= live) return;                 // past the row's end: loads only

  unsigned S[16][4];
#pragma unroll
  for (int y = 0; y < 16; ++y)
#pragma unroll
    for (int w = 0; w < 4; ++w) S[y][w] = s_src[(m * 16 + y) * 4 + w];
  const float lam = *a.lam;
  float bc[9];
  unsigned bi[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    bc[p] = BIG;
    bi[p] = 0;
  }
  const int items = side * a.groups;
  for (int i = lane; i < items; i += 32) {
    const int g = i / side, ox = i - g * side, oy0 = g * FS_G;
    const unsigned* wp = win + (ox & 3) * a.copy + oy0 * ww + 4 * m +
                         (ox >> 2);
    unsigned acc[FS_G][4];
#pragma unroll
    for (int j = 0; j < FS_G; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0;
#pragma unroll
    for (int r = 0; r < FS_G + 15; ++r) {
      const unsigned w0 = wp[r * ww], w1 = wp[r * ww + 1],
                     w2 = wp[r * ww + 2], w3 = wp[r * ww + 3];
#pragma unroll
      for (int j = 0; j < FS_G; ++j) {
        const int y = r - j;             // the source row candidate j reads
        if (y >= 0 && y < 16) {
          const int h = (y >> 3) * 2;    // quadrants 0 1 above, 2 3 below
          acc[j][h] = sad4(w1, S[y][1], sad4(w0, S[y][0], acc[j][h]));
          acc[j][h + 1] = sad4(w3, S[y][3], sad4(w2, S[y][2],
                                                 acc[j][h + 1]));
        }
      }
    }
    const int bx = se_bits(4 * (ox - rng));
#pragma unroll
    for (int j = 0; j < FS_G; ++j) {
      const int oy = oy0 + j;
      if (oy >= side) break;
      const float pen = __fmul_rn(
          lam, (float)(bx + se_bits(4 * (oy - rng))));
      float q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = __fadd_rn((float)acc[j][k], pen);
      float cost[9];
      cost[0] = __fadd_rn(__fadd_rn(__fadd_rn(q[0], q[1]), q[2]), q[3]);
      cost[1] = __fadd_rn(q[0], q[1]);
      cost[2] = __fadd_rn(q[2], q[3]);
      cost[3] = __fadd_rn(q[0], q[2]);
      cost[4] = __fadd_rn(q[1], q[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) cost[5 + k] = q[k];
      const unsigned idx = (unsigned)(oy * side + ox) + 1u;
#pragma unroll
      for (int p = 0; p < 9; ++p) {
        if (cost[p] < bc[p] || (cost[p] == bc[p] && idx < bi[p])) {
          bc[p] = cost[p];
          bi[p] = idx;
        }
      }
    }
  }
  unsigned long long mine = 0;
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    const unsigned long long k = warp_min(cost_key(bc[p], bi[p]));
    if (lane == p) mine = k;
  }
  if (lane < 9) {
    const unsigned idx = (unsigned)mine;
    int dx = 0, dy = 0;
    if (idx != 0) {
      dx = (int)(idx - 1) % side - rng;
      dy = (int)(idx - 1) / side - rng;
    }
    const float cost = key_cost(mine);
    const int mb = my * a.gw + m0 + m;
    float* cp;
    int32_t* vp;
    if (lane == 0) {
      cp = a.c16 + mb;
      vp = a.v16 + mb * 2;
    } else if (lane < 3) {
      cp = a.c168 + mb * 2 + (lane - 1);
      vp = a.v168 + (mb * 2 + (lane - 1)) * 2;
    } else if (lane < 5) {
      cp = a.c816 + mb * 2 + (lane - 3);
      vp = a.v816 + (mb * 2 + (lane - 3)) * 2;
    } else {
      cp = a.c88 + mb * 4 + (lane - 5);
      vp = a.v88 + (mb * 4 + (lane - 5)) * 2;
    }
    *cp = cost;
    vp[0] = dx;
    vp[1] = dy;
  }
}

struct RfArgs {
  const int32_t* src;   // PAD-padded source plane, row stride src_stride
  const int32_t* hp;    // (4, hp_h, hp_w) half-pel stack [G, b, h, j]
  const int32_t* mv;    // (gh, gw, 16, 2) quarter-pel MVs
  const int32_t* part;  // (gh, gw, 16) partition of each 4x4 block
  const float* lam;     // lambda_motion, one f32 on the device
  int32_t* mv_out;      // (gh, gw, 16, 2)
  float* cost_out;      // (gh, gw, nparts), the last round's
  int src_stride, hp_h, hp_w, gw, gh, nparts;
  int nsteps, step0, step1, use_satd;
};

// A 4x4 block's window: the RS x RS samples of each of the four planes
// that the two taps of its nine deltas reach in a round.  The block
// origins of the deltas span ((2|step| + 3) >> 2) + 1 positions (the
// clamp only narrows them), and the taps reach 4 + 1 past an origin: RS 6
// covers |step| <= 2, RS 9 any |step| <= RF_MAX_STEP.  Windows are 16-bit
// (the samples are 0..255); a warp's 32 windows lie WS apart, WS = 2 mod
// 4, so that they start in 32 different banks.  (Staging the union of an
// MB's windows instead, a plane's row a warp load, serialised its rows'
// loads: slower at every size on the H100.)
template <int RS>
struct RfWin {
  static constexpr int WORDS = 4 * RS * RS;
  static constexpr int WS = WORDS + (6 - WORDS % 4) % 4;
};

inline int rf_side(int step0, int step1, int nsteps) {
  const int s0 = step0 < 0 ? -step0 : step0;
  const int s1 = nsteps > 1 ? (step1 < 0 ? -step1 : step1) : 0;
  const int widest = s0 > s1 ? s0 : s1;
  return widest <= 2 ? 6 : widest <= RF_MAX_STEP ? 9 : 0;
}

// shared memory of k_refine: the packed QPT table, then per warp its two
// MBs' partition sums [2][9][16] and chosen deltas [2][16], int32 words,
// then the warps' windows
constexpr int R_QPT = 0;
constexpr int R_WARP = 16;
constexpr int R_WARP_WORDS = 2 * 9 * 16 + 2 * 16;

inline int rf_smem_bytes(int rs) {
  const int ws = rs == 6 ? RfWin<6>::WS : RfWin<9>::WS;
  return 4 * (R_WARP + RF_WARPS * R_WARP_WORDS) + 2 * RF_WARPS * 32 * ws;
}

// Partition sums pack a block's distortion above its MV bits: 16 blocks'
// SATDs (each < 2^15 for samples 0..255) stay below 2^19, and their bits
// (each < 2 x 62 for |MV| < 2^30) below 2^11.
constexpr int BITS_SHIFT = 11;

// SATD (sum |H d H| >> 1) of a 4x4 difference block, or its SAD.  The
// last butterfly stage is folded: |a + b| + |a - b| = 2 max(|a|, |b|), so
// the halved sum is the sum of the maxima, exactly.
__device__ __forceinline__ int block_distortion(const int* d, int use_satd) {
  int s = 0;
  if (!use_satd) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s += abs(d[i]);
    return s;
  }
  int m[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a0 = d[c], a1 = d[4 + c], a2 = d[8 + c], a3 = d[12 + c];
    m[c] = a0 + a1 + a2 + a3;
    m[4 + c] = a0 + a1 - a2 - a3;
    m[8 + c] = a0 - a1 - a2 + a3;
    m[12 + c] = a0 - a1 + a2 - a3;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int a0 = m[4 * r], a1 = m[4 * r + 1], a2 = m[4 * r + 2],
              a3 = m[4 * r + 3];
    const int p0 = a0 + a1, p1 = a0 - a1, q0 = a2 + a3, q1 = a2 - a3;
    s += max(abs(p0), abs(q0)) + max(abs(p1), abs(q1));
  }
  return s;
}

template <int RS>
__global__ void __launch_bounds__(RF_THREADS) k_refine(RfArgs a) {
  constexpr int RS2 = RS * RS, WIN = RfWin<RS>::WORDS, WS = RfWin<RS>::WS;
  constexpr int ITEMS = (WIN + 31) / 32;   // words a lane stages a window
  extern __shared__ int smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int h = lane >> 4, b = lane & 15;  // the lane's MB and 4x4 block
  const int* s_qpt = smem + R_QPT;
  unsigned* s_sum = reinterpret_cast<unsigned*>(
      smem + R_WARP + warp * R_WARP_WORDS) + h * 144;     // [9][16]
  int* s_best = smem + R_WARP + warp * R_WARP_WORDS + 288 + h * 16;
  int16_t* s_win = reinterpret_cast<int16_t*>(
      smem + R_WARP + RF_WARPS * R_WARP_WORDS) + warp * 32 * WS;
  const int nmb = a.gw * a.gh;
  const int slot = (blockIdx.x * RF_WARPS + warp) * 2 + h;
  // a spare slot (an odd MB count) recomputes the last MB, writes nothing
  const bool live = slot < nmb;
  const int mb = live ? slot : nmb - 1;
  const int my = mb / a.gw, mx = mb - my * a.gw;
  const int H = a.gh * 16, W = a.gw * 16;
  const int bx = mx * 16 + (b & 3) * 4, by = my * 16 + (b >> 2) * 4;
  if (t < 16) {
    // a tap as plane | dx << 2 | dy << 3, the case's two taps a word
    const int* q = QPT + 6 * t;
    smem[R_QPT + t] = (q[0] | q[1] << 2 | q[2] << 3) |
                      (q[3] | q[4] << 2 | q[5] << 3) << 8;
  }
  int mvx = a.mv[(mb * 16 + b) * 2], mvy = a.mv[(mb * 16 + b) * 2 + 1];
  const int n_mine = a.part[mb * 16 + b];
  int src[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    src[i] = a.src[(long long)(PAD + by + (i >> 2)) * a.src_stride + PAD +
                   bx + (i & 3)];
  const float lam = *a.lam;
  int count = 0;                         // blocks in partition b of the MB
  for (int n = 0; n < a.nparts; ++n) {
    const unsigned m = __ballot_sync(FULL, n_mine == n) >> (16 * h);
    if (b == n) count = __popc(m & 0xffffu);
  }
  // the plane offsets of the window words this lane stages: word
  // lane + 32 q of a window is plane w / RS2, row and column of w % RS2
  const int plane = a.hp_h * a.hp_w;
  int goff[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int w = min(lane + 32 * q, WIN - 1), pl = w / RS2, rc = w % RS2;
    goff[q] = pl * plane + (rc / RS) * a.hp_w + rc % RS;
  }
  __syncthreads();                       // the QPT table
  for (int round = 0; round < a.nsteps; ++round) {
    const int step = round == 0 ? a.step0 : a.step1;
    const int low = step < 0 ? step : -step;
    // the window's origin in the padded planes: the block origin of the
    // lowest delta, pulled inside the planes where the clamp put the
    // block at their far edge
    const int y0 = min(min(max(by + ((mvy + low) >> 2), -(PAD - 2)),
                           H + PAD - 7) + PAD, a.hp_h - RS);
    const int x0 = min(min(max(bx + ((mvx + low) >> 2), -(PAD - 2)),
                           W + PAD - 7) + PAD, a.hp_w - RS);
    const int org = y0 * a.hp_w + x0;
#pragma unroll
    for (int d = 0; d < 9; ++d) s_sum[d * 16 + b] = 0;
    // the warp stages its 32 windows, one window a pass, four passes'
    // loads in flight
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const int ok = __shfl_sync(FULL, org, k);
#pragma unroll
      for (int q = 0; q < ITEMS; ++q)
        if (lane + 32 * q < WIN)
          s_win[k * WS + lane + 32 * q] = (int16_t)a.hp[ok + goff[q]];
    }
    __syncwarp();
    const int16_t* win = s_win + lane * WS;
#pragma unroll
    for (int d = 0; d < 9; ++d) {
      const int vx = mvx + delta_x(d) * step, vy = mvy + delta_y(d) * step;
      const int xi = min(max(bx + (vx >> 2), -(PAD - 2)), W + PAD - 7) +
                     PAD - x0;
      const int yi = min(max(by + (vy >> 2), -(PAD - 2)), H + PAD - 7) +
                     PAD - y0;
      const int taps = s_qpt[4 * (vy & 3) + (vx & 3)];
      const int16_t* A = win + (taps & 3) * RS2 +
                         (yi + ((taps >> 3) & 1)) * RS + xi +
                         ((taps >> 2) & 1);
      const int16_t* B = win + ((taps >> 8) & 3) * RS2 +
                         (yi + ((taps >> 11) & 1)) * RS + xi +
                         ((taps >> 10) & 1);
      int dd[16];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // the taps are 0..255, so their rounded mean needs no clamp
          dd[4 * r + c] = ((A[r * RS + c] + B[r * RS + c] + 1) >> 1) -
                          src[4 * r + c];
        }
      }
      const unsigned packed =
          (unsigned)block_distortion(dd, a.use_satd) << BITS_SHIFT |
          (unsigned)(se_bits(vx) + se_bits(vy));
      if (n_mine >= 0 && n_mine < 16) atomicAdd(&s_sum[d * 16 + n_mine],
                                                packed);
    }
    __syncwarp();
    if (b < a.nparts) {
      // partition b: its cost at each delta, the first minimum
      const float n = fmaxf((float)count, 1.f);
      float best = 0.f;
      int bd = 0;
      for (int d = 0; d < 9; ++d) {
        const unsigned sums = s_sum[d * 16 + b];
        const float cost = __fmaf_rn(
            lam, __fdiv_rn((float)(sums & ((1u << BITS_SHIFT) - 1)), n),
            (float)(sums >> BITS_SHIFT));
        if (d == 0 || cost < best) {
          best = cost;
          bd = d;
        }
      }
      s_best[b] = bd;
      if (round == a.nsteps - 1 && live) a.cost_out[mb * a.nparts + b] = best;
    }
    __syncwarp();
    const int bd = n_mine >= 0 && n_mine < a.nparts ? s_best[n_mine] : 0;
    mvx += delta_x(bd) * step;
    mvy += delta_y(bd) * step;
    __syncwarp();
  }
  if (live) {
    a.mv_out[(mb * 16 + b) * 2] = mvx;
    a.mv_out[(mb * 16 + b) * 2 + 1] = mvy;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is device
// memory that the caller allocated and checked (the shapes above, int32
// and f32, the maps contiguous, the planes with unit column stride);
// every plane sample is in 0..255 (see the top); 0 <= rng <= PAD,
// 1 <= nparts <= 16, 1 <= nsteps <= 2, |step| <= RF_MAX_STEP.  Each
// returns 0 or the CUDA error code of the launch.
extern "C" int hl_full_search_int(
    const int32_t* src, const int32_t* ref, const float* lam, float* c16,
    int32_t* v16, float* c168, int32_t* v168, float* c816, int32_t* v816,
    float* c88, int32_t* v88, int src_stride, int ref_stride, int gw,
    int gh, int rng, cudaStream_t stream) {
  const int strip = fs_strip(gw, gh);
  const FsArgs a = fs_args(src, ref, lam, c16, v16, c168, v168, c816, v816,
                           c88, v88, src_stride, ref_stride, gw, gh, rng,
                           strip);
  const int smem = fs_smem_bytes(a);
  if (smem > 48 * 1024) {                // R > 20 at a strip of 8
    const cudaError_t e = cudaFuncSetAttribute(
        k_full_search, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_full_search<<<dim3((gw + strip - 1) / strip, gh), 32 * strip, smem,
                  stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hl_refine_subpel(const int32_t* src, const int32_t* hp,
                                const int32_t* mv, const int32_t* part,
                                const float* lam, int32_t* mv_out,
                                float* cost_out, int src_stride, int hp_h,
                                int hp_w, int gw, int gh, int nparts,
                                int nsteps, int step0, int step1,
                                int use_satd, cudaStream_t stream) {
  const int rs = rf_side(step0, step1, nsteps);
  if (nsteps < 1 || nsteps > 2 || rs == 0) return (int)cudaErrorInvalidValue;
  const RfArgs a{src, hp, mv, part, lam, mv_out, cost_out, src_stride,
                 hp_h, hp_w, gw, gh, nparts, nsteps, step0, step1,
                 use_satd};
  const int blocks = (gw * gh + 2 * RF_WARPS - 1) / (2 * RF_WARPS);
  if (rs == 6)
    k_refine<6><<<blocks, RF_THREADS, rf_smem_bytes(6), stream>>>(a);
  else
    k_refine<9><<<blocks, RF_THREADS, rf_smem_bytes(9), stream>>>(a);
  return (int)cudaGetLastError();
}

// Both kernels' attributes at 1080p (120 x 68 MBs, range 12, the
// refinement's steps 2 and 1), seven ints each, the full search first:
// registers, local (spill) bytes a thread, static shared bytes, dynamic
// shared bytes, threads a block, grid x, y.
extern "C" int hl_me_attributes(int* out) {
  cudaFuncAttributes f;
  cudaError_t err = cudaFuncGetAttributes(&f, k_full_search);
  if (err != cudaSuccess) return (int)err;
  const int strip = fs_strip(120, 68);
  const FsArgs fa = fs_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, 0, 0, 120, 68, 12, strip);
  const int fs[7] = {f.numRegs, (int)f.localSizeBytes,
                     (int)f.sharedSizeBytes, fs_smem_bytes(fa), 32 * strip,
                     (120 + strip - 1) / strip, 68};
  err = cudaFuncGetAttributes(&f, k_refine<6>);
  if (err != cudaSuccess) return (int)err;
  const int rf[7] = {f.numRegs, (int)f.localSizeBytes,
                     (int)f.sharedSizeBytes, rf_smem_bytes(6), RF_THREADS,
                     (120 * 68 + 2 * RF_WARPS - 1) / (2 * RF_WARPS), 1};
  for (int i = 0; i < 7; ++i) {
    out[i] = fs[i];
    out[7 + i] = rf[i];
  }
  return 0;
}
