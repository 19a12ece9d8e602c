// Whole-GOP H.264 decode for Hopper (sm_90a): MC, residual, intra,
// deblock, half-pel ring update and cropped output for K pictures.
//
// Replaces the Pallas TPU kernel decode_gop_pl / _make_kernel of
// hartallo_tpu/decode/d_gop_pallas.py and takes the same payload
// (hartallo_tpu_torch/decode/d_pool.py: quadrant MC window words, sparse
// residual tags, intra MB list, per-MB deblock parameters).
//
// Design.  Pictures are sequential (picture k+1 may read the ring slot
// picture k wrote), so the host function loops over the K pictures on one
// stream, and each picture is a few launches over int32 work planes
// (Hp, Wp) / (Hcp, Wcp) that the caller allocates once per call, zeroed:
// the pads stay zero, which is what intra prediction must read at frame
// edges.
//   MC       one thread per predicted sample, reading the reference slot
//            of the ring directly (no cache: the ring is read once).
//   residual one thread per sample of each 4x4 tag (tags are disjoint).
//   intra    one block of 1024 threads walks the slope-2 steps
//            t = mx + 2 my of the intra MBs.  An intra MB reads only its
//            left, top, top-left and top-right neighbours (steps t - 1,
//            t - 2, t - 3, t - 1), so the MBs of one step are independent:
//            the block sorts the list by step in shared memory (a
//            histogram and a scan), then its 32 warps take the MBs of a
//            step, one warp per MB doing the 16 Intra4x4 blocks in order
//            (__syncwarp between them), with a __syncthreads between
//            steps.  A 720p IDR picture is 168 steps instead of 3,600
//            MBs one after another.  Inter neighbours are final before
//            the stage starts.  Integer mode tables, no float.
//   deblock  launch_deblock of deblock_wavefront.cuh: one warp per MB row,
//            rows two MBs apart, each MB filtered in shared memory.
//   half-pel one thread per sample of the padded luma plane computes G and
//            the b/h/j 6-tap grids straight from the deblocked picture
//            with clamped coordinates (halfpel_prims.cuh, shared with
//            the encoder's k_halfpel_enc), and writes them to the ring
//            slot.
//   output   one thread per output sample of the cropped I420 row layout.
// What bounds it on the H100: bytes, about 1.6 MB a CIF picture (the
// payload, the reference slot read by MC, the slot written and the output)
// or 0.5 us at 3.35 TB/s; the half-pel 6-tap filters are the most
// arithmetic, well under that time at the card's integer rate.  What the
// kernel takes is latency: the dependency chains of the intra and deblock
// stages, which the schedules above shorten to about gw + 2 gh MB steps
// each.
#include <cstdint>
#include <cuda_runtime.h>

#include "deblock_wavefront.cuh"
#include "halfpel_prims.cuh"

namespace {

using hl::NAUX;
using hl::PAD;

// stage bits (the Python wrapper maps the stage letters onto them)
constexpr int ST_MC = 1, ST_RES = 2, ST_INTRA = 4, ST_DEBLOCK = 8,
              ST_HALFPEL = 16;

struct Geo {
  int gw, gh, H, W, Hc, Wc, Hp, Wp, Hcp, Wcp;
  int HrY, WrY, HrC, WrC;  // ring slot plane dims (over-allocated)
  int NR, NI;
};

// ---------------------------------------------------------------------------
// MC: luma quarter-pel as (A + B + 1) >> 1 of two half-pel-stack windows
// per 8x8 quadrant, chroma eighth-pel bilinear per 4x4 quadrant.
// ---------------------------------------------------------------------------
__global__ void k_mc(const int32_t* __restrict__ smb,
                     const int32_t* __restrict__ sf,
                     const uint8_t* __restrict__ ringY,
                     const uint8_t* __restrict__ ringU,
                     const uint8_t* __restrict__ ringV, int32_t* py,
                     int32_t* pu, int32_t* pv, Geo g) {
  const int nMB = g.gw * g.gh;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nMB * 384) return;
  const int m = t / 384, s = t % 384;
  const int mx = m % g.gw, my = m / g.gw;
  const int rslot = sf[1];
  if (s < 256) {
    const int r = s >> 4, c = s & 15;
    const uint32_t w = (uint32_t)smb[m * 8 + (r >> 3) * 2 + (c >> 3)];
    const int d1x = w & 1, d1y = (w >> 1) & 1, d0x = (w >> 2) & 1,
              d0y = (w >> 3) & 1, p1 = (w >> 4) & 3, p0 = (w >> 6) & 3,
              x0 = (w >> 8) & 4095, y0 = w >> 20;
    const size_t plane = (size_t)g.HrY * g.WrY;
    const uint8_t* slot = ringY + (size_t)rslot * 4 * plane;
    const int rr = r & 7, cc = c & 7;
    const int A = slot[p0 * plane + (size_t)(y0 + d0y + rr) * g.WrY +
                       (x0 + d0x + cc)];
    const int B = slot[p1 * plane + (size_t)(y0 + d1y + rr) * g.WrY +
                       (x0 + d1x + cc)];
    py[(PAD + my * 16 + r) * g.Wp + PAD + mx * 16 + c] = (A + B + 1) >> 1;
  } else {
    const int s2 = s - 256, pl = s2 >> 6, r = (s2 >> 3) & 7, c = s2 & 7;
    const uint32_t w = (uint32_t)smb[m * 8 + 4 + (r >> 2) * 2 + (c >> 2)];
    const int fx = w & 7, fy = (w >> 3) & 7, cx0 = (w >> 6) & 2047,
              cy0 = w >> 17;
    const uint8_t* R = (pl == 0 ? ringU : ringV) +
                       (size_t)rslot * g.HrC * g.WrC;
    const int y = cy0 + (r & 3), x = cx0 + (c & 3);
    const int A = R[(size_t)y * g.WrC + x], B = R[(size_t)y * g.WrC + x + 1];
    const int C = R[(size_t)(y + 1) * g.WrC + x],
              D = R[(size_t)(y + 1) * g.WrC + x + 1];
    const int v = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
                   (8 - fx) * fy * C + fx * fy * D + 32) >> 6;
    (pl == 0 ? pu : pv)[(PAD + my * 8 + r) * g.Wcp + PAD + mx * 8 + c] = v;
  }
}

// ---------------------------------------------------------------------------
// Sparse inter residual: tag = (y << 12) | x in padded-plane coordinates,
// values row-major; tags [0, nl) luma, [nl, nu) U, [nu, nr) V.
// ---------------------------------------------------------------------------
__global__ void k_residual(const int32_t* __restrict__ sf,
                           const int32_t* __restrict__ tags,
                           const int16_t* __restrict__ vals, int32_t* py,
                           int32_t* pu, int32_t* pv, Geo g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t >> 4, e = t & 15;
  const int nl = sf[2], nu = sf[3], nr = sf[4];
  if (i >= g.NR || i >= nr) return;
  const int tag = tags[i];
  const int y = (tag >> 12) + (e >> 2), x = (tag & 4095) + (e & 3);
  int32_t* P = i < nl ? py : (i < nu ? pu : pv);
  const int stride = i < nl ? g.Wp : g.Wcp;
  int32_t* dst = P + (size_t)y * stride + x;
  *dst = hl::clip3(0, 255, *dst + vals[i * 16 + e]);
}

// ---------------------------------------------------------------------------
// Intra MBs, one warp per MB, slope-2 steps in order.  i4tab: the Intra4x4
// directional mode tables of hartallo_tpu_torch/ops/intra.py as int32
// [idx (8,4,4,3) | wgt (8,4,4,3) | rnd (8,4,4) | sht (8,4,4)], over the
// 13-sample edge vector s = [l3, l2, l1, l0, tl, t0..t7]; bank row
// 0, 1, 2.. 7 holds spec modes 0, 1, 3.. 8.
// ---------------------------------------------------------------------------
constexpr int MAX_STEPS = 256;   // gw + 2 gh - 2 <= 254 at 1920x1088
constexpr int MAX_INTRA = 8192;  // intra MBs of a picture <= gw gh = 8160

__device__ __forceinline__ int blk_of(int y, int x) {  // raster -> blkIdx
  return (y >> 3) * 8 + (x >> 3) * 4 + ((y >> 2) & 1) * 2 + ((x >> 2) & 1);
}

__device__ __forceinline__ int dc_rule(bool at, bool al, int ts, int ls,
                                       int both_sh, int one_sh) {
  if (at && al) return (ts + ls + (1 << (both_sh - 1))) >> both_sh;
  if (al) return (ls + (1 << (one_sh - 1))) >> one_sh;
  if (at) return (ts + (1 << (one_sh - 1))) >> one_sh;
  return 128;
}

__device__ __forceinline__ int step_of(int m, int gw) {
  return m % gw + 2 * (m / gw);
}

// Intra MB `i` of the list, by the 32 lanes of one warp.
__device__ void intra_mb(int i, int lane, const int32_t* __restrict__ ilist,
                         const int16_t* __restrict__ ivals, const int* tab,
                         int32_t* py, int32_t* pu, int32_t* pv,
                         const Geo& g) {
  const int* IDX = tab;
  const int* WGT = tab + 384;
  const int* RND = tab + 768;
  const int* SHT = tab + 896;
  const int Wp = g.Wp, Wcp = g.Wcp;
  const int32_t* ent = ilist + i * 4;
  const int m = ent[0];
  const uint32_t w = (uint32_t)ent[1];
  const uint32_t i4a = (uint32_t)ent[2], i4b = (uint32_t)ent[3];
  const int my = m / g.gw, mx = m % g.gw;
  const bool is16 = w & 1;
  const int i16m = (w >> 1) & 3, cmode = (w >> 3) & 3;
  const bool alf = (w >> 5) & 1, atf = (w >> 6) & 1, atrf = (w >> 7) & 1;
  const bool at_edge = mx == g.gw - 1;
  const int y0p = PAD + my * 16, x0p = PAD + mx * 16;
  const int16_t* rv = ivals + (size_t)i * 24 * 16;

  if (!is16) {
    for (int b = 0; b < 16; ++b) {
      const int bx = 8 * ((b >> 2) & 1) + 4 * (b & 1);
      const int by = 8 * (b >> 3) + 4 * ((b >> 1) & 1);
      if (lane < 16) {
        const int yb = y0p + by, xb = x0p + bx;
        int s[13];
        for (int k = 0; k < 4; ++k) s[3 - k] = py[(yb + k) * Wp + xb - 1];
        s[4] = py[(yb - 1) * Wp + xb - 1];
        for (int k = 0; k < 8; ++k) s[5 + k] = py[(yb - 1) * Wp + xb + k];
        bool sub = false;
        if (b == 3 || b == 7 || b == 11 || b == 13 || b == 15) sub = true;
        else if (b == 5) sub = at_edge || !atrf;
        if (sub)
          for (int k = 4; k < 8; ++k) s[5 + k] = s[5 + 3];
        const int mode = ((b < 8 ? i4a : i4b) >> (4 * (b % 8))) & 15;
        const int y = lane >> 2, x = lane & 3;
        int pred;
        if (mode == 2) {
          const int ts = s[5] + s[6] + s[7] + s[8];
          const int ls = s[0] + s[1] + s[2] + s[3];
          pred = dc_rule(by == 0 ? atf : true, bx == 0 ? alf : true, ts, ls,
                         3, 2);
        } else {
          const int row = mode < 2 ? mode : mode - 1;
          const int e = (row * 4 + y) * 4 + x;
          int acc = RND[e];
          for (int k = 0; k < 3; ++k)
            acc += s[IDX[e * 3 + k]] * WGT[e * 3 + k];
          pred = acc >> SHT[e];
        }
        py[(yb + y) * Wp + xb + x] =
            hl::clip3(0, 255, pred + rv[b * 16 + y * 4 + x]);
      }
      __syncwarp();
    }
  } else {
    // every lane reads the neighbours outside the MB; sums are cheap
    int ts = 0, ls = 0, Hs = 0, Vs = 0;
    const int tl = py[(y0p - 1) * Wp + x0p - 1];
    for (int k = 0; k < 16; ++k) {
      ts += py[(y0p - 1) * Wp + x0p + k];
      ls += py[(y0p + k) * Wp + x0p - 1];
    }
    for (int k = 0; k < 8; ++k) {
      const int tp = k == 7 ? tl : py[(y0p - 1) * Wp + x0p + 6 - k];
      const int lp = k == 7 ? tl : py[(y0p + 6 - k) * Wp + x0p - 1];
      Hs += (k + 1) * (py[(y0p - 1) * Wp + x0p + 8 + k] - tp);
      Vs += (k + 1) * (py[(y0p + 8 + k) * Wp + x0p - 1] - lp);
    }
    const int a = 16 * (py[(y0p + 15) * Wp + x0p - 1] +
                        py[(y0p - 1) * Wp + x0p + 15]);
    const int bco = (5 * Hs + 32) >> 6, cco = (5 * Vs + 32) >> 6;
    const int dc = dc_rule(atf, alf, ts, ls, 5, 4);
    for (int p = lane; p < 256; p += 32) {
      const int y = p >> 4, x = p & 15;
      int pred;
      if (i16m == 0) pred = py[(y0p - 1) * Wp + x0p + x];
      else if (i16m == 1) pred = py[(y0p + y) * Wp + x0p - 1];
      else if (i16m == 2) pred = dc;
      else pred = hl::clip3(0, 255, (a + bco * (x - 7) + cco * (y - 7) + 16) >> 5);
      const int res = rv[blk_of(y, x) * 16 + (y & 3) * 4 + (x & 3)];
      py[(y0p + y) * Wp + x0p + x] = hl::clip3(0, 255, pred + res);
    }
  }

  // chroma (both intra kinds): 2 planes x 64 samples
  const int y0c = PAD + my * 8, x0c = PAD + mx * 8;
  for (int p = lane; p < 128; p += 32) {
    const int pl = p >> 6, y = (p >> 3) & 7, x = p & 7;
    int32_t* P = pl == 0 ? pu : pv;
    const int tl = P[(y0c - 1) * Wcp + x0c - 1];
    int t[8], l[8];
    for (int k = 0; k < 8; ++k) {
      t[k] = P[(y0c - 1) * Wcp + x0c + k];
      l[k] = P[(y0c + k) * Wcp + x0c - 1];
    }
    int pred;
    if (cmode == 0) {
      const int ts0 = t[0] + t[1] + t[2] + t[3], ts1 = t[4] + t[5] + t[6] + t[7];
      const int ls0 = l[0] + l[1] + l[2] + l[3], ls1 = l[4] + l[5] + l[6] + l[7];
      if (y < 4 && x < 4) pred = dc_rule(atf, alf, ts0, ls0, 3, 2);
      else if (y >= 4 && x >= 4) pred = dc_rule(atf, alf, ts1, ls1, 3, 2);
      else if (y < 4)  // x = 4..7, y = 0..3: the top edge first
        pred = atf ? (ts1 + 2) >> 2 : (alf ? (ls0 + 2) >> 2 : 128);
      else             // x = 0..3, y = 4..7: the left edge first
        pred = alf ? (ls1 + 2) >> 2 : (atf ? (ts0 + 2) >> 2 : 128);
    } else if (cmode == 1) {
      pred = l[y];
    } else if (cmode == 2) {
      pred = t[x];
    } else {
      int Hs = 0, Vs = 0;
      for (int k = 0; k < 4; ++k) {
        Hs += (k + 1) * (t[4 + k] - (k == 3 ? tl : t[2 - k]));
        Vs += (k + 1) * (l[4 + k] - (k == 3 ? tl : l[2 - k]));
      }
      const int a = 16 * (l[7] + t[7]);
      const int bco = (17 * Hs + 16) >> 5, cco = (17 * Vs + 16) >> 5;
      pred = hl::clip3(0, 255, (a + bco * (x - 3) + cco * (y - 3) + 16) >> 5);
    }
    const int b2 = (y >> 2) * 2 + (x >> 2);
    const int res = rv[(16 + 4 * pl + b2) * 16 + (y & 3) * 4 + (x & 3)];
    P[(y0c + y) * Wcp + x0c + x] = hl::clip3(0, 255, pred + res);
  }
  __syncwarp();
}

// One block of 1024 threads (32 warps).
__global__ void __launch_bounds__(1024)
k_intra(const int32_t* __restrict__ sf, const int32_t* __restrict__ ilist,
        const int16_t* __restrict__ ivals, const int32_t* __restrict__ i4tab,
        int32_t* py, int32_t* pu, int32_t* pv, Geo g) {
  __shared__ int tab[1024];
  __shared__ int start[MAX_STEPS + 1];  // step t: order[start[t]..start[t+1])
  __shared__ int fill[MAX_STEPS];
  __shared__ int16_t order[MAX_INTRA];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n_imb = sf[5];
  const int T = g.gw + 2 * g.gh - 2;
  for (int i = tid; i < 1024; i += blockDim.x) tab[i] = i4tab[i];
  for (int t = tid; t < T; t += blockDim.x) fill[t] = 0;
  __syncthreads();
  // sort the list by step: histogram, exclusive scan (warp 0, eight steps
  // a lane), scatter
  for (int i = tid; i < n_imb; i += blockDim.x)
    atomicAdd(&fill[step_of(ilist[i * 4], g.gw)], 1);
  __syncthreads();
  if (warp == 0) {
    int cnt[8], sum = 0;
    for (int k = 0; k < 8; ++k) {
      const int t = lane * 8 + k;
      cnt[k] = t < T ? fill[t] : 0;
      sum += cnt[k];
    }
    int inc = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += y;
    }
    int s = inc - sum;
    for (int k = 0; k < 8; ++k) {
      const int t = lane * 8 + k;
      if (t < T) start[t] = fill[t] = s;
      s += cnt[k];
    }
    if (lane == 0) start[T] = n_imb;
  }
  __syncthreads();
  for (int i = tid; i < n_imb; i += blockDim.x)
    order[atomicAdd(&fill[step_of(ilist[i * 4], g.gw)], 1)] = (int16_t)i;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int s = start[t], e = start[t + 1];
    if (s == e) continue;  // the same for every thread of the block
    for (int j = s + warp; j < e; j += nwarps)
      intra_mb(order[j], lane, ilist, ivals, tab, py, pu, pv, g);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Half-pel stack [G, b, h, j] of the edge-padded luma, and the padded
// chroma, into ring slot wslot; cropped output row.
// ---------------------------------------------------------------------------
// the work plane with the picture's box: the pad is not filled here, so
// a tap outside the picture reads the nearest picture sample
// (halfpel_prims.cuh)
__device__ __forceinline__ ClampedPlane picture_box(const int32_t* py,
                                                   const Geo& g) {
  return {py, g.Wp, PAD, PAD + g.H - 1, PAD, PAD + g.W - 1};
}

__global__ void k_halfpel(const int32_t* __restrict__ sf,
                          const int32_t* __restrict__ py, uint8_t* ringY,
                          Geo g, int sixtap) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.Hp * g.Wp) return;
  const int y = t / g.Wp, x = t % g.Wp;
  const ClampedPlane box = picture_box(py, g);
  const int G = hp_at(box, y, x);
  int H1 = G, V1 = G, J1 = G;
  if (sixtap) {
    H1 = hp_h1(box, y, x);
    V1 = hp_v1(box, y, x);
    J1 = hp_j1(box, y, x);
  }
  const size_t plane = (size_t)g.HrY * g.WrY;
  uint8_t* slot = ringY + (size_t)sf[0] * 4 * plane + (size_t)y * g.WrY + x;
  slot[0] = (uint8_t)G;
  slot[plane] = (uint8_t)hp_round5(H1);
  slot[2 * plane] = (uint8_t)hp_round5(V1);
  slot[3 * plane] = (uint8_t)hp_round10(J1);
}

__global__ void k_pad_chroma(const int32_t* __restrict__ sf,
                             const int32_t* __restrict__ pu,
                             const int32_t* __restrict__ pv, uint8_t* ringU,
                             uint8_t* ringV, Geo g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = g.Hcp * g.Wcp;
  if (t >= 2 * n) return;
  const int pl = t / n, y = (t % n) / g.Wcp, x = t % g.Wcp;
  const int32_t* P = pl == 0 ? pu : pv;
  const int v = P[(PAD + hl::clip3(0, g.Hc - 1, y - PAD)) * g.Wcp + PAD +
                  hl::clip3(0, g.Wc - 1, x - PAD)];
  uint8_t* R = (pl == 0 ? ringU : ringV) + (size_t)sf[0] * g.HrC * g.WrC;
  R[(size_t)y * g.WrC + x] = (uint8_t)v;
}

__global__ void k_output(const int32_t* __restrict__ py,
                         const int32_t* __restrict__ pu,
                         const int32_t* __restrict__ pv, uint8_t* out,
                         Geo g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (g.H + g.Hc) * g.W) return;
  const int y = t / g.W, x = t % g.W;
  int v;
  if (y < g.H) v = py[(PAD + y) * g.Wp + PAD + x];
  else if (x < g.Wc) v = pu[(PAD + y - g.H) * g.Wcp + PAD + x];
  else v = pv[(PAD + y - g.H) * g.Wcp + PAD + x - g.Wc];
  out[t] = (uint8_t)v;
}

inline int blocks(long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is device memory
// that the caller allocated and checked; py/pu/pv are zeroed int32 work
// planes and prog K * gh zeroed ints (the deblock's row progress, one set
// per picture).  Returns 0 or the first CUDA error code of a launch, or
// cudaErrorInvalidValue for a frame the intra schedule cannot hold.
extern "C" int hl_decode_gop(
    const int32_t* smb, const int16_t* aux, const int32_t* sf,
    const int32_t* tags, const int16_t* vals, const int32_t* ilist,
    const int16_t* ivals, const int32_t* i4tab, uint8_t* ringY,
    uint8_t* ringU, uint8_t* ringV, uint8_t* out, int32_t* py, int32_t* pu,
    int32_t* pv, int* prog, int K, int gw, int gh, int NR, int NI, int HrY,
    int WrY, int HrC, int WrC, int stages, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (gw + 2 * gh - 2 > MAX_STEPS || gw * gh > MAX_INTRA)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.gw = gw;
  g.gh = gh;
  g.H = gh * 16;
  g.W = gw * 16;
  g.Hc = gh * 8;
  g.Wc = gw * 8;
  g.Hp = g.H + 2 * PAD;
  g.Wp = g.W + 2 * PAD;
  g.Hcp = g.Hc + 2 * PAD;
  g.Wcp = g.Wc + 2 * PAD;
  g.HrY = HrY;
  g.WrY = WrY;
  g.HrC = HrC;
  g.WrC = WrC;
  g.NR = NR;
  g.NI = NI;
  const int nMB = gw * gh;
  const int T = 256;
  cudaError_t err;
#define HL_CHECK()                             \
  do {                                         \
    err = cudaGetLastError();                  \
    if (err != cudaSuccess) return (int)err;   \
  } while (0)
  for (int k = 0; k < K; ++k) {
    const int32_t* sf_k = sf + k * 8;
    if (stages & ST_MC) {
      k_mc<<<blocks((long)nMB * 384, T), T, 0, stream>>>(
          smb + (size_t)k * nMB * 8, sf_k, ringY, ringU, ringV, py, pu, pv, g);
      HL_CHECK();
    }
    if ((stages & ST_RES) && NR > 0) {
      k_residual<<<blocks((long)NR * 16, T), T, 0, stream>>>(
          sf_k, tags + (size_t)k * NR, vals + (size_t)k * NR * 16, py, pu, pv,
          g);
      HL_CHECK();
    }
    if ((stages & ST_INTRA) && NI > 0) {
      k_intra<<<1, 1024, 0, stream>>>(sf_k, ilist + (size_t)k * NI * 4,
                                      ivals + (size_t)k * NI * 24 * 16, i4tab,
                                      py, pu, pv, g);
      HL_CHECK();
    }
    if (stages & ST_DEBLOCK) {
      err = hl::launch_deblock(aux + (size_t)k * nMB * NAUX, py, pu, pv,
                               prog + (size_t)k * gh, gw, gh, stream);
      if (err != cudaSuccess) return (int)err;
    }
    k_halfpel<<<blocks((long)g.Hp * g.Wp, T), T, 0, stream>>>(
        sf_k, py, ringY, g, (stages & ST_HALFPEL) ? 1 : 0);
    HL_CHECK();
    k_pad_chroma<<<blocks(2L * g.Hcp * g.Wcp, T), T, 0, stream>>>(
        sf_k, pu, pv, ringU, ringV, g);
    HL_CHECK();
    k_output<<<blocks((long)(g.H + g.Hc) * g.W, T), T, 0, stream>>>(
        py, pu, pv, out + (size_t)k * (g.H + g.Hc) * g.W, g);
    HL_CHECK();
  }
#undef HL_CHECK
  return 0;
}

extern "C" const char* hl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
