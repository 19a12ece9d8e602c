// Standalone frame deblock for Hopper (sm_90a): the row wavefront of
// deblock_wavefront.cuh over one picture's PAD-padded int32 planes, and
// the decoder's deblock parameters that it filters with.
//
// Replaces the Pallas TPU kernel deblock_frame_pl / _kernel of
// hartallo_tpu/ops/deblock_pallas.py, with its _edge_params pre-gather.
// The Mosaic layout of that kernel
// (edge-major tiles, the skew and the row/column transposes, the lane
// shifts) was a TPU register-layout device and is not carried over: the
// kernel filters the natural planes in place.  Its parameters are the
// per-MB `aux` rows of hartallo_tpu_torch/ops/deblock.edge_params (the
// pre-gather of _edge_params), as int16.
//
// What bounds it on the H100: bytes (the planes read and written once,
// about 13.6 MB a 720p frame with aux, 4 us); the design that meets
// latency instead (one warp per MB row, a lag of two MBs between rows,
// each MB filtered in shared memory) is described in
// deblock_wavefront.cuh.
//
// k_deblock_params_dec gathers those rows for the decoder, K pictures a
// launch, straight from the per-MB words it parsed (d_fused.DEC_FIELDS,
// or the general route's record of the same fields): the bS of 8.7.2.1
// (ops/wide.compute_bs_grids, with torch.roll's wrap to the far column
// and row at the picture's edges, which the edge flags gate off), the
// left and top MBs' QPs (the edge MB its own) and chroma QPs, and the
// alpha / beta / tc0 sets of ops/deblock.edge_params with the slices'
// per-MB offsets.  Its plain twin is ops/deblock_fast
// .deblock_params_dec_plain.  The design is k_deblock_params' of
// p_encode.cu: 16 lanes an MB, one a 4x4 block, a block of 128 threads
// per strip of 8 MBs of a row (blockIdx.y the row, blockIdx.z the
// picture); each lane loads its block's TotalCoeff, MV and refIdx and,
// across a filtered MB edge, the neighbour MB's block beside it, all
// before the first use; the neighbours inside the MB come by width-16
// shuffles; lanes 0-5 form one (alpha, beta, tc0) set each, and an MB's
// 62 int16 words leave through a shared row as 32-bit stores.  The bS
// rule and the sets are deblock_params.cuh's, shared with
// k_deblock_params.  Bound:
// bytes, the 59 words an MB read and 124 bytes written (about 2.9 MB,
// 0.9 us a 1080p picture); what sets its pace is each lane's chain of
// loads, two deep (the edge flags, then the neighbour's block).
#include <cstdint>
#include <cuda_runtime.h>

#include "deblock_wavefront.cuh"
#include "deblock_params.cuh"

namespace {

using hl::NAUX;

constexpr unsigned FULL = 0xffffffffu;

// word offsets of the fields in an MB's record (deblock_fast
// .DEBLOCK_FIELDS): kind, qp, mv (4, 4, 2), ref_idx (2, 2), nnz (4, 4),
// alpha_off, beta_off, fmb_v, fmb_h, fint
struct Fields {
  int kind, qp, mv, ref, nnz, aoff, boff, fv, fh, fint;
};

struct DdArgs {
  const int32_t* __restrict__ rec;  // (K, gh * gw, words)
  const int32_t* __restrict__ tab;  // deblock_fast._param_tables: the
                                    // tables of deblock_params.cuh
  int16_t* __restrict__ aux;        // (K, gh, gw, NAUX), 4-byte aligned
  Fields f;
  int words, gw, gh, cqo;
};

constexpr int DD_MBS = 8;                  // MBs of a row a block
constexpr int DD_THREADS = DD_MBS * 16;    // 16 lanes an MB, one a 4x4 block
constexpr int DD_ROW = 64;                 // int16 words of an MB's staged row
constexpr int DD_SMEM_BYTES = DD_MBS * DD_ROW * 2;
static_assert(NAUX <= DD_ROW && NAUX % 2 == 0 && NAUX / 2 <= 32,
              "k_deblock_params_dec stages an MB's row as 32-bit words, two "
              "a lane");

// I4x4, I16, PCM and I_BL count as intra for the bS
__device__ __forceinline__ bool kind_intra(int kind) {
  return kind <= 2 || kind == 8;
}

// bS of the edge between block q and its neighbour p (8.7.2.1, as
// ops/wide.compute_bs_grids: 3 for an intra edge inside the MB)
__device__ __forceinline__ int edge_bs(bool intra, bool nz, int2 vq, int2 vp,
                                       int rq, int rp, bool internal) {
  const int bs = hl::bs_rule(intra, nz, vq, vp, rq, rp);
  return internal && bs == 4 ? 3 : bs;
}

// Block (by, bx) of the MB at `r`: TotalCoeff > 0, MV and refIdx.
struct Blk {
  bool nz;
  int2 v;
  int ref;
};

__device__ __forceinline__ Blk blk_at(const int32_t* r, const Fields& f,
                                      int by, int bx) {
  const int l = by * 4 + bx;
  return {r[f.nnz + l] > 0, make_int2(r[f.mv + 2 * l], r[f.mv + 2 * l + 1]),
          r[f.ref + (by >> 1) * 2 + (bx >> 1)]};
}

// 16 lanes an MB, a block per strip of DD_MBS MBs of a row (blockIdx.y the
// row, blockIdx.z the picture).  A strip past the row's end works on the
// row's last MB and stores nothing, so the shuffles see full warps.
__global__ void __launch_bounds__(DD_THREADS)
k_deblock_params_dec(DdArgs a) {
  extern __shared__ int smem[];
  const Fields& f = a.f;
  const int l = threadIdx.x & 15, by = l >> 2, bx = l & 3;
  const int gw = a.gw, my = blockIdx.y;
  const int mxs = blockIdx.x * DD_MBS + (threadIdx.x >> 4);
  const bool live = mxs < gw;
  const int mx = live ? mxs : gw - 1;
  const size_t pic = (size_t)blockIdx.z * a.gh * gw;
  const int m = my * gw + mx;
  const int32_t* rq = a.rec + (pic + m) * a.words;
  // the neighbour across the picture's edge is the far column or row, as
  // torch.roll wraps; the edge flags gate it off there
  const int32_t* rl = a.rec + (pic + m - mx + (mx ? mx - 1 : gw - 1)) *
                                  a.words;
  const int32_t* rt =
      a.rec + (pic + (size_t)(my ? my - 1 : a.gh - 1) * gw + mx) * a.words;
  const bool fv = rq[f.fv] != 0, fh = rq[f.fh] != 0, fi = rq[f.fint] != 0;
  const Blk q = blk_at(rq, f, by, bx);
  const bool iq = kind_intra(rq[f.kind]);
  const int qp = rq[f.qp];
  // lanes 0-5: the left, top and own qp of sets 0 / 3, 1 / 4, 2 / 5, and
  // the MB's offsets
  const int qn = (l == 0 || l == 3) && mx > 0   ? rq[f.qp - a.words]
                 : (l == 1 || l == 4) && my > 0 ? rq[f.qp - gw * a.words]
                                                : qp;
  const int aoff = rq[f.aoff], boff = rq[f.boff];
  // the MB edge blocks: block (by, 3) of the left MB, (3, bx) of the top
  Blk pl{false, make_int2(0, 0), 0}, pt{false, make_int2(0, 0), 0};
  bool i_l = false, i_t = false;
  if (bx == 0 && fv) {
    pl = blk_at(rl, f, by, 3);
    i_l = kind_intra(rl[f.kind]);
  }
  if (by == 0 && fh) {
    pt = blk_at(rt, f, 3, bx);
    i_t = kind_intra(rt[f.kind]);
  }
  // the neighbours inside the MB: lane l - 1 on the left, l - 4 on top
  const int nz_l = __shfl_up_sync(FULL, (int)q.nz, 1, 16);
  const int vx_l = __shfl_up_sync(FULL, q.v.x, 1, 16);
  const int vy_l = __shfl_up_sync(FULL, q.v.y, 1, 16);
  const int r_l = __shfl_up_sync(FULL, q.ref, 1, 16);
  const int nz_t = __shfl_up_sync(FULL, (int)q.nz, 4, 16);
  const int vx_t = __shfl_up_sync(FULL, q.v.x, 4, 16);
  const int vy_t = __shfl_up_sync(FULL, q.v.y, 4, 16);
  const int r_t = __shfl_up_sync(FULL, q.ref, 4, 16);
  if (bx) pl = {nz_l != 0, make_int2(vx_l, vy_l), r_l};
  if (by) pt = {nz_t != 0, make_int2(vx_t, vy_t), r_t};
  const int bs_v = (bx ? fi : fv) ? edge_bs(iq || i_l, q.nz || pl.nz, q.v,
                                            pl.v, q.ref, pl.ref, bx != 0)
                                  : 0;
  const int bs_h = (by ? fi : fh) ? edge_bs(iq || i_t, q.nz || pt.nz, q.v,
                                            pt.v, q.ref, pt.ref, by != 0)
                                  : 0;
  int16_t* row =
      reinterpret_cast<int16_t*>(smem) + (threadIdx.x >> 4) * DD_ROW;
  row[30 + bx * 4 + by] = (int16_t)bs_v;
  row[46 + l] = (int16_t)bs_h;
  if (l < 6) hl::edge_set(a.tab, l, qp, qn, a.cqo, aoff, boff, row);
  __syncwarp();
  if (live) {
    const int* w = reinterpret_cast<const int*>(row);
    int* o = reinterpret_cast<int*>(a.aux + (pic + m) * NAUX);
    o[l] = w[l];
    if (l + 16 < NAUX / 2) o[l + 16] = w[l + 16];
  }
}

// The launch's strips of a row (shared with the emulated test's harness)
int dd_strips(int gw) { return (gw + DD_MBS - 1) / DD_MBS; }

}  // namespace


// Plain C entry points (loaded with ctypes).  aux (gh, gw, NAUX) int16,
// the planes Y (16 gh + 64, 16 gw + 64), U and V (8 gh + 64, 8 gw + 64)
// int32 and prog (gh zeroed ints) are device memory the caller allocated
// and checked; the planes are filtered in place.  Returns 0 or the CUDA
// error code of the launch.
extern "C" int hl_deblock_frame(const int16_t* aux, int32_t* py, int32_t* pu,
                                int32_t* pv, int* prog, int gw, int gh,
                                cudaStream_t stream) {
  return (int)hl::launch_deblock(aux, py, pu, pv, prog, gw, gh, stream);
}

// rec (K, gh * gw, words) int32 records, tab the wrapper's table and aux
// (K, gh, gw, NAUX) int16 are device memory the caller allocated and
// checked; offs (host memory) the ten field offsets in Fields' order.
// Returns 0 or the CUDA error code of the launch.
extern "C" int hl_deblock_params_dec(const int32_t* rec, int words,
                                     const int* offs, const int32_t* tab,
                                     int16_t* aux, int K, int gw, int gh,
                                     int cqo, cudaStream_t stream) {
  const Fields f{offs[0], offs[1], offs[2], offs[3], offs[4],
                 offs[5], offs[6], offs[7], offs[8], offs[9]};
  const DdArgs a{rec, tab, aux, f, words, gw, gh, cqo};
  k_deblock_params_dec<<<dim3(dd_strips(gw), gh, K), DD_THREADS, DD_SMEM_BYTES,
                         stream>>>(a);
  return (int)cudaGetLastError();
}
