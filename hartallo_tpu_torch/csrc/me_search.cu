// The encoder's motion search for Hopper (sm_90a): the integer full search
// and one 9-point sub-pel refinement round.
//
// Replaces hartallo_tpu/encode/me.py:full_search_int and refine_subpel,
// the XLA code inside p_device.p_frame_device (one full search and two
// refinement rounds a P picture).  Their plain twins are
// hartallo_tpu_torch/encode/me.py:full_search_int and refine_subpel, which
// these kernels match bit for bit; the wrappers are
// hartallo_tpu_torch/encode/me_fast.py.
//
// k_full_search, one block per MB.  Computes, for each candidate c of the
// (2R+1)^2 offsets (dy = c / side - R, dx = c % side - R), the SADs s8[k]
// of the MB's four 8x8 quadrants against the reference shifted by
// (dy, dx); the cost of quadrant k is s8[k] + lam * (se(4 dx) + se(4 dy)),
// and the 16x16, 16x8 and 8x16 costs are sums of those.  For each of the 9
// partitions it keeps the first minimum in candidate order, as the twin's
// chunked argmin with its "strictly better than the carry" does.  The
// block holds the MB's source and the (16 + 2R)^2 reference window in
// shared memory, strides the candidates over its 256 threads, keeps a
// per-thread best for each partition as one 64-bit key (the cost's bits,
// ordered, above the candidate index plus one) and reduces the keys with
// warp shuffles and then across the warps.  Index 0 is the twin's carry
// (cost 1e18, MV 0), which a candidate must beat strictly.
//
// k_refine, one block per MB.  Computes, for each 4x4 block (raster in the
// MB) and each of the 9 deltas in the twin's order, the quarter-pel
// prediction from the half-pel stack [G, b, h, j] exactly as
// ops/wide.mc_luma_plane does (clamped block origin, two taps chosen by
// the quarter-pel case, (A + B + 1) >> 1, identity weighting) and its
// SATD (sum |H d H| >> 1) or SAD; then per partition of part_of_blk and
// delta the integer distortion sum and the mean MV bits, the cost
// lam * pbits + psad rounded once, the first minimum over the deltas,
// and every block's MV moved by its partition's delta.  Threads
// 0..143 take one (block, delta) pair each.
//
// Rounding.  The costs are the only floating-point values.  nvcc contracts
// a*b + c into an FMA by default, so each is spelt out in the twin's order:
// __fmul_rn for the penalty, __fadd_rn for every sum of the full search
// (sum4 runs left to right), __fdiv_rn for the mean bits and one
// __fmaf_rn for the refinement cost (the twin's fma_f32, XLA's contraction
// on the CPU).  Integers: flooring >> and & on negative MVs, no / or % of
// a negative value.
//
// What bounds them on the H100.  The full search: operations, 3 per
// candidate sample (difference, absolute value, sum), (2R+1)^2 H W 3 in
// all: 58.5 us a 1080p picture (1,088 coded rows) at R = 12 and 67 T/s.
// What the kernel takes is two int32 shared-memory loads a candidate
// sample (about 7.5x the bound at 1080p).  The refinement round: bytes,
// the source and the four half-pel planes over the picture read, the MVs
// and the partition map read, the MVs and costs written (13.3 us a 1080p
// round at 3.35 TB/s); it reads 9 x 2 taps a sample through L1.  At CIF
// and 720p a launch costs more on the host than on the card.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PAD = 32;
constexpr int FS_THREADS = 256;
constexpr int FS_WARPS = FS_THREADS / 32;
constexpr int RF_THREADS = 160;       // 144 (block, delta) pairs
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
// the refinement deltas in the twin's order (me._DELTAS)
__constant__ int DDX[9] = {0, -1, 1, 0, 0, -1, 1, -1, 1};
__constant__ int DDY[9] = {0, 0, 0, -1, 1, -1, -1, 1, 1};

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
};

// dynamic shared memory of k_full_search at range rng, bytes
inline int fs_smem_bytes(int rng) {
  const int ws = 16 + 2 * rng;
  return ((256 + ws * ws + 1) / 2) * 8 + 9 * FS_WARPS * 8;
}

__global__ void __launch_bounds__(FS_THREADS) k_full_search(FsArgs a) {
  extern __shared__ int smem[];
  const int rng = a.rng, ws = 16 + 2 * rng, side = 2 * rng + 1;
  const int n_cand = side * side;
  const int mx = blockIdx.x, my = blockIdx.y, t = threadIdx.x;
  int* s_src = smem;                                   // 16 x 16
  int* s_win = smem + 256;                             // ws x ws
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(
      smem + ((256 + ws * ws + 1) / 2) * 2);           // [9][FS_WARPS]
  for (int i = t; i < 256; i += blockDim.x)
    s_src[i] = a.src[(long long)(PAD + my * 16 + (i >> 4)) * a.src_stride +
                     PAD + mx * 16 + (i & 15)];
  const int y0 = PAD + my * 16 - rng, x0 = PAD + mx * 16 - rng;
  for (int i = t; i < ws * ws; i += blockDim.x)
    s_win[i] = a.ref[(long long)(y0 + i / ws) * a.ref_stride + x0 + i % ws];
  const float lam = *a.lam;
  __syncthreads();

  unsigned long long best[9];
  const unsigned long long carry = cost_key(BIG, 0);
#pragma unroll
  for (int p = 0; p < 9; ++p) best[p] = carry;
  for (int c = t; c < n_cand; c += blockDim.x) {
    const int oy = c / side, ox = c % side;            // dy + R, dx + R
    const int* w = s_win + oy * ws + ox;
    int s8[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int* sq = s_src + (k >> 1) * 128 + (k & 1) * 8;
      const int* wq = w + (k >> 1) * 8 * ws + (k & 1) * 8;
      int s = 0;
      for (int y = 0; y < 8; ++y) {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int d = sq[y * 16 + x] - wq[y * ws + x];
          s += d < 0 ? -d : d;
        }
      }
      s8[k] = s;
    }
    const float pen = __fmul_rn(
        lam, (float)(se_bits(4 * (ox - rng)) + se_bits(4 * (oy - rng))));
    float q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __fadd_rn((float)s8[k], pen);
    float cost[9];
    cost[0] = __fadd_rn(__fadd_rn(__fadd_rn(q[0], q[1]), q[2]), q[3]);
    cost[1] = __fadd_rn(q[0], q[1]);
    cost[2] = __fadd_rn(q[2], q[3]);
    cost[3] = __fadd_rn(q[0], q[2]);
    cost[4] = __fadd_rn(q[1], q[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) cost[5 + k] = q[k];
#pragma unroll
    for (int p = 0; p < 9; ++p) {
      const unsigned long long key = cost_key(cost[p], (unsigned)c + 1u);
      best[p] = key < best[p] ? key : best[p];
    }
  }
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    const unsigned long long k = warp_min(best[p]);
    if (lane == 0) s_key[p * FS_WARPS + warp] = k;
  }
  __syncthreads();
  if (t < 9) {
    unsigned long long k = s_key[t * FS_WARPS];
    for (int w = 1; w < FS_WARPS; ++w) {
      const unsigned long long o = s_key[t * FS_WARPS + w];
      k = o < k ? o : k;
    }
    const unsigned idx = (unsigned)k;
    int dx = 0, dy = 0;
    if (idx != 0) {
      dx = (int)(idx - 1) % side - rng;
      dy = (int)(idx - 1) / side - rng;
    }
    const float cost = key_cost(k);
    const int mb = my * a.gw + mx;
    float* cp;
    int32_t* vp;
    if (t == 0) {
      cp = a.c16 + mb;
      vp = a.v16 + mb * 2;
    } else if (t < 3) {
      cp = a.c168 + mb * 2 + (t - 1);
      vp = a.v168 + (mb * 2 + (t - 1)) * 2;
    } else if (t < 5) {
      cp = a.c816 + mb * 2 + (t - 3);
      vp = a.v816 + (mb * 2 + (t - 3)) * 2;
    } else {
      cp = a.c88 + mb * 4 + (t - 5);
      vp = a.v88 + (mb * 4 + (t - 5)) * 2;
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
  float* cost_out;      // (gh, gw, nparts)
  int src_stride, hp_h, hp_w, gw, gh, nparts, step, use_satd;
};

// shared memory of k_refine, int32 words
constexpr int R_SRC = 0;                // 16 x 16 source
constexpr int R_DIST = R_SRC + 256;     // [9][16] distortion per delta, block
constexpr int R_BITS = R_DIST + 144;    // [9][16] MV bits
constexpr int R_MV = R_BITS + 144;      // [16][2]
constexpr int R_PART = R_MV + 32;       // [16]
constexpr int R_COST = R_PART + 16;     // [16][9] f32 costs
constexpr int R_BEST = R_COST + 144;    // [16] chosen delta per partition
constexpr int R_WORDS = R_BEST + 16;

// the distortion of one 4x4 block: SATD (sum |H d H| >> 1) or SAD
__device__ __forceinline__ int block_distortion(const int* d, int use_satd) {
  if (!use_satd) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) s += d[i] < 0 ? -d[i] : d[i];
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
  int s = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int a0 = m[4 * r], a1 = m[4 * r + 1], a2 = m[4 * r + 2],
              a3 = m[4 * r + 3];
    const int v[4] = {a0 + a1 + a2 + a3, a0 + a1 - a2 - a3,
                      a0 - a1 - a2 + a3, a0 - a1 + a2 - a3};
#pragma unroll
    for (int i = 0; i < 4; ++i) s += v[i] < 0 ? -v[i] : v[i];
  }
  return s >> 1;
}

__global__ void __launch_bounds__(RF_THREADS) k_refine(RfArgs a) {
  extern __shared__ int smem[];
  const int mx = blockIdx.x, my = blockIdx.y, t = threadIdx.x;
  const int mb = my * a.gw + mx;
  const int H = a.gh * 16, W = a.gw * 16;
  float* s_cost = reinterpret_cast<float*>(smem + R_COST);
  for (int i = t; i < 256; i += blockDim.x)
    smem[R_SRC + i] = a.src[(long long)(PAD + my * 16 + (i >> 4)) *
                                a.src_stride + PAD + mx * 16 + (i & 15)];
  if (t < 16) {
    smem[R_MV + 2 * t] = a.mv[(mb * 16 + t) * 2];
    smem[R_MV + 2 * t + 1] = a.mv[(mb * 16 + t) * 2 + 1];
    smem[R_PART + t] = a.part[mb * 16 + t];
  }
  const float lam = *a.lam;
  __syncthreads();

  if (t < 144) {
    const int b = t & 15, dl = t >> 4;
    const int mvx = smem[R_MV + 2 * b] + DDX[dl] * a.step;
    const int mvy = smem[R_MV + 2 * b + 1] + DDY[dl] * a.step;
    const int bx = mx * 16 + (b & 3) * 4, by = my * 16 + (b >> 2) * 4;
    const int xi = min(max(bx + (mvx >> 2), -(PAD - 2)), W + PAD - 7);
    const int yi = min(max(by + (mvy >> 2), -(PAD - 2)), H + PAD - 7);
    const int* cs = QPT + (4 * (mvy & 3) + (mvx & 3)) * 6;
    const long long plane = (long long)a.hp_h * a.hp_w;
    const int32_t* A = a.hp + cs[0] * plane +
                       (long long)(yi + cs[2] + PAD) * a.hp_w + xi + cs[1] +
                       PAD;
    const int32_t* B = a.hp + cs[3] * plane +
                       (long long)(yi + cs[5] + PAD) * a.hp_w + xi + cs[4] +
                       PAD;
    const int* s = smem + R_SRC + (b >> 2) * 64 + (b & 3) * 4;
    int d[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = (A[r * a.hp_w + c] + B[r * a.hp_w + c] + 1) >> 1;
        d[4 * r + c] = min(max(p, 0), 255) - s[r * 16 + c];
      }
    }
    smem[R_DIST + dl * 16 + b] = block_distortion(d, a.use_satd);
    smem[R_BITS + dl * 16 + b] = se_bits(mvx) + se_bits(mvy);
  }
  __syncthreads();
  if (t < a.nparts * 9) {
    const int n = t / 9, dl = t % 9;
    int psad = 0, bits = 0, count = 0;
    for (int b = 0; b < 16; ++b) {
      if (smem[R_PART + b] == n) {
        psad += smem[R_DIST + dl * 16 + b];
        bits += smem[R_BITS + dl * 16 + b];
        ++count;
      }
    }
    const float pbits = __fdiv_rn((float)bits, fmaxf((float)count, 1.f));
    s_cost[n * 9 + dl] = __fmaf_rn(lam, pbits, (float)psad);
  }
  __syncthreads();
  if (t < a.nparts) {
    int bd = 0;
    float bc = s_cost[t * 9];
    for (int dl = 1; dl < 9; ++dl) {
      if (s_cost[t * 9 + dl] < bc) {
        bc = s_cost[t * 9 + dl];
        bd = dl;
      }
    }
    a.cost_out[mb * a.nparts + t] = bc;
    smem[R_BEST + t] = bd;
  }
  __syncthreads();
  if (t < 16) {
    const int n = smem[R_PART + t];
    const int bd = (n >= 0 && n < a.nparts) ? smem[R_BEST + n] : 0;
    a.mv_out[(mb * 16 + t) * 2] = smem[R_MV + 2 * t] + DDX[bd] * a.step;
    a.mv_out[(mb * 16 + t) * 2 + 1] =
        smem[R_MV + 2 * t + 1] + DDY[bd] * a.step;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is device
// memory that the caller allocated and checked (the shapes above, int32
// and f32 contiguous); 0 <= rng <= PAD, 1 <= nparts <= 16.  Each returns 0
// or the CUDA error code of the launch.
extern "C" int hl_full_search_int(
    const int32_t* src, const int32_t* ref, const float* lam, float* c16,
    int32_t* v16, float* c168, int32_t* v168, float* c816, int32_t* v816,
    float* c88, int32_t* v88, int src_stride, int ref_stride, int gw,
    int gh, int rng, cudaStream_t stream) {
  FsArgs a{src, ref, lam, c16, v16, c168, v168, c816, v816, c88, v88,
           src_stride, ref_stride, gw, gh, rng};
  k_full_search<<<dim3(gw, gh), FS_THREADS, fs_smem_bytes(rng), stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hl_refine_subpel(const int32_t* src, const int32_t* hp,
                                const int32_t* mv, const int32_t* part,
                                const float* lam, int32_t* mv_out,
                                float* cost_out, int src_stride, int hp_h,
                                int hp_w, int gw, int gh, int nparts,
                                int step, int use_satd, cudaStream_t stream) {
  RfArgs a{src, hp, mv, part, lam, mv_out, cost_out, src_stride, hp_h,
           hp_w, gw, gh, nparts, step, use_satd};
  k_refine<<<dim3(gw, gh), RF_THREADS, R_WORDS * 4, stream>>>(a);
  return (int)cudaGetLastError();
}
