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
// launch, straight from the per-MB int16 words it parsed
// (d_fused.DEC_FIELDS as uploaded, or the general route's record of the
// same fields): the bS of 8.7.2.1
// (ops/wide.compute_bs_grids, with torch.roll's wrap to the far column
// and row at the picture's edges, which the edge flags gate off), the
// left and top MBs' QPs (the edge MB its own) and chroma QPs, and the
// alpha / beta / tc0 sets of ops/deblock.edge_params with the slices'
// per-MB offsets.  Its plain twin is ops/deblock_fast
// .deblock_params_dec_plain.  The design: 16 lanes an MB, one a 4x4
// block, a block of 128 threads per strip of 8 MBs of a row (blockIdx.y
// the row, blockIdx.z the picture).  The block stages, once, the span of
// each record that holds the fields (80 int16 words of the scan's
// record, 60 of the general route's) for the strip's MBs, the MBs above
// them and the strip's left neighbour, as coalesced 8-byte vectors, and
// the threshold tables (1,248 bytes, int4), into shared memory, so that
// no load waits on another; each lane then reads its block, and across a filtered
// MB edge the neighbour MB's block beside it, from there; the
// neighbours inside the MB come by width-16 shuffles; lanes 0-5 form one
// (alpha, beta, tc0) set each, and an MB's 62 int16 words leave through a
// shared row as 32-bit stores.  The bS rule and the sets are
// deblock_params.cuh's, shared with k_deblock_params.  Bound: bytes, the
// 59 int16 words an MB read and 124 bytes written (about 2.0 MB, 0.59
// us a 1080p picture); one round of loads, then shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "deblock_wavefront.cuh"
#include "deblock_params.cuh"

namespace {

using hl::NAUX;

constexpr unsigned FULL = 0xffffffffu;

// int16 word offsets of the fields in an MB's record (deblock_fast
// .DEBLOCK_FIELDS): kind, qp, mv (4, 4, 2), ref_idx (2, 2), nnz (4, 4),
// alpha_off, beta_off, fmb_v, fmb_h, fint; relative to the staged span's
// first word
struct Fields {
  int kind, qp, mv, ref, nnz, aoff, boff, fv, fh, fint;
};

struct DdArgs {
  const int16_t* __restrict__ rec;  // (K, gh * gw, words), words a
                                    // multiple of 4, 8-byte aligned
  const int32_t* __restrict__ tab;  // deblock_fast._param_tables: the
                                    // tables of deblock_params.cuh
  int16_t* __restrict__ aux;        // (K, gh, gw, NAUX), 4-byte aligned
  Fields f;
  int words, lo, span, gw, gh, cqo; // words lo .. lo + span - 1 of a
                                    // record are staged (multiples of 4)
};

constexpr int DD_MBS = 8;                  // MBs of a row a block
constexpr int DD_THREADS = DD_MBS * 16;    // 16 lanes an MB, one a 4x4 block
constexpr int DD_ROW = 64;                 // int16 words of an MB's staged row
constexpr int DD_STAGED = 2 * DD_MBS + 1;  // records staged a block
constexpr int DD_SPAN_MAX = 128;           // int16 words staged a record
static_assert(NAUX <= DD_ROW && NAUX % 2 == 0 && NAUX / 2 <= 32,
              "k_deblock_params_dec stages an MB's row as 32-bit words, two "
              "a lane");

// the tables of deblock_params.cuh, int32 words (QP_SCALE_CHROMA,
// DEBLOCK_ALPHA, DEBLOCK_BETA, DEBLOCK_TC0), staged with the records
constexpr int DD_TAB_WORDS = hl::DPT_TC0 + 3 * 52;
static_assert(DD_TAB_WORDS % 4 == 0 && DD_TAB_WORDS / 4 <= DD_THREADS,
              "the tables are staged as int4, one a thread");
// the staging's vectors a thread at most
constexpr int DD_ROUNDS = (DD_STAGED * DD_SPAN_MAX / 4 + DD_THREADS - 1) /
                          DD_THREADS;

// the dynamic shared memory of a launch staging `span` words a record:
// the tables, the DD_STAGED records, then the strip's output rows
__host__ __device__ inline int dd_smem_bytes(int span) {
  return DD_TAB_WORDS * 4 + DD_STAGED * span * 2 + DD_MBS * DD_ROW * 2;
}

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

// Block (by, bx) of the staged record `r`: TotalCoeff > 0, MV and refIdx.
struct Blk {
  bool nz;
  int2 v;
  int ref;
};

__device__ __forceinline__ Blk blk_at(const int16_t* r, const Fields& f,
                                      int by, int bx) {
  const int l = by * 4 + bx;
  return {r[f.nnz + l] > 0, make_int2(r[f.mv + 2 * l], r[f.mv + 2 * l + 1]),
          r[f.ref + (by >> 1) * 2 + (bx >> 1)]};
}

// 16 lanes an MB, a block per strip of DD_MBS MBs of a row (blockIdx.y the
// row, blockIdx.z the picture).  The block first stages, as coalesced
// 8-byte vectors, the span of DD_STAGED records it reads: the left
// neighbour of the strip's first MB (record 0), the strip's MBs (1 ..
// DD_MBS) and the MBs above them (DD_MBS + 1 ..); the neighbour across
// the picture's edge is the far column or row, as torch.roll wraps (the
// edge flags gate it off there).  A strip past the row's end works on the
// row's last MB and stores nothing, so the shuffles see full warps.
__global__ void __launch_bounds__(DD_THREADS)
k_deblock_params_dec(DdArgs a) {
  extern __shared__ int smem[];
  int* tab = smem;
  int16_t* stage = reinterpret_cast<int16_t*>(smem + DD_TAB_WORDS);
  const Fields& f = a.f;
  const int gw = a.gw, my = blockIdx.y, mx0 = blockIdx.x * DD_MBS;
  const size_t pic = (size_t)blockIdx.z * a.gh * gw;
  const int top = (my ? my - 1 : a.gh - 1) * gw;
  // every vector into registers first, then into shared memory (a store
  // between two loads would hold the second behind the first)
  const int nv = a.span >> 2, total = DD_STAGED * nv;
  int2 v[DD_ROUNDS];
#pragma unroll
  for (int k = 0; k < DD_ROUNDS; ++k) {
    const int i = threadIdx.x + DD_THREADS * k, j = i / nv, w = i - j * nv;
    if (i >= total) continue;
    const int m = j == 0 ? my * gw + (mx0 ? mx0 - 1 : gw - 1)
                  : j <= DD_MBS ? my * gw + min(mx0 + j - 1, gw - 1)
                                : top + min(mx0 + j - 1 - DD_MBS, gw - 1);
    v[k] = *reinterpret_cast<const int2*>(a.rec + (pic + m) * a.words +
                                          a.lo + 4 * w);
  }
  int4 tv;
  if (threadIdx.x < DD_TAB_WORDS / 4)
    tv = reinterpret_cast<const int4*>(a.tab)[threadIdx.x];
#pragma unroll
  for (int k = 0; k < DD_ROUNDS; ++k) {
    const int i = threadIdx.x + DD_THREADS * k, j = i / nv, w = i - j * nv;
    if (i < total)
      *reinterpret_cast<int2*>(stage + j * a.span + 4 * w) = v[k];
  }
  if (threadIdx.x < DD_TAB_WORDS / 4)
    reinterpret_cast<int4*>(tab)[threadIdx.x] = tv;
  __syncthreads();
  const int l = threadIdx.x & 15, by = l >> 2, bx = l & 3;
  const int j = threadIdx.x >> 4, mxs = mx0 + j;
  const bool live = mxs < gw;
  const int mx = live ? mxs : gw - 1;
  const int16_t* rq = stage + (j + 1) * a.span;
  const int16_t* rl = stage + j * a.span;
  const int16_t* rt = stage + (j + 1 + DD_MBS) * a.span;
  const bool fv = rq[f.fv] != 0, fh = rq[f.fh] != 0, fi = rq[f.fint] != 0;
  const Blk q = blk_at(rq, f, by, bx);
  const bool iq = kind_intra(rq[f.kind]);
  const int qp = rq[f.qp];
  // lanes 0-5: the left, top and own qp of sets 0 / 3, 1 / 4, 2 / 5, and
  // the MB's offsets
  const int qn = (l == 0 || l == 3) && mx > 0   ? rl[f.qp]
                 : (l == 1 || l == 4) && my > 0 ? rt[f.qp]
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
  int16_t* row = stage + DD_STAGED * a.span + j * DD_ROW;
  row[30 + bx * 4 + by] = (int16_t)bs_v;
  row[46 + l] = (int16_t)bs_h;
  if (l < 6) hl::edge_set(tab, l, qp, qn, a.cqo, aoff, boff, row);
  __syncwarp();
  if (live) {
    const int* w = reinterpret_cast<const int*>(row);
    int* o = reinterpret_cast<int*>(a.aux + (pic + my * gw + mx) * NAUX);
    o[l] = w[l];
    if (l + 16 < NAUX / 2) o[l + 16] = w[l + 16];
  }
}

// The launch's strips of a row and its arguments (shared with the
// emulated test's harness): the records' words are staged from the
// lowest field's, down to a multiple of 4, to the highest's, up to one;
// false where that span is longer than DD_SPAN_MAX or runs past the
// record, or the records are not 8-byte vectors.
int dd_strips(int gw) { return (gw + DD_MBS - 1) / DD_MBS; }

bool dd_args(const int16_t* rec, int words, const int* offs,
             const int32_t* tab, int16_t* aux, int gw, int gh, int cqo,
             DdArgs* a) {
  // each field's words: kind, qp, mv, ref, nnz, aoff, boff, fv, fh, fint
  constexpr int sizes[10] = {1, 1, 32, 4, 16, 1, 1, 1, 1, 1};
  int lo = offs[0], hi = offs[0] + 1;
  for (int i = 0; i < 10; ++i) {
    lo = offs[i] < lo ? offs[i] : lo;
    hi = offs[i] + sizes[i] > hi ? offs[i] + sizes[i] : hi;
  }
  lo &= ~3;
  hi = (hi + 3) & ~3;
  if (words & 3 || hi > words || hi - lo > DD_SPAN_MAX ||
      reinterpret_cast<uintptr_t>(rec) & 7)
    return false;
  const Fields f{offs[0] - lo, offs[1] - lo, offs[2] - lo, offs[3] - lo,
                 offs[4] - lo, offs[5] - lo, offs[6] - lo, offs[7] - lo,
                 offs[8] - lo, offs[9] - lo};
  *a = DdArgs{rec, tab, aux, f, words, lo, hi - lo, gw, gh, cqo};
  return true;
}

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

// rec (K, gh * gw, words) int16 records (words a multiple of 4, 8-byte
// aligned), tab the wrapper's table and aux (K, gh, gw, NAUX) int16 are
// device memory the caller allocated and checked; offs (host memory) the
// ten field offsets in Fields' order (dd_args; cudaErrorInvalidValue
// where it refuses them).  Returns 0 or the CUDA error code of the
// launch.
extern "C" int hl_deblock_params_dec(const int16_t* rec, int words,
                                     const int* offs, const int32_t* tab,
                                     int16_t* aux, int K, int gw, int gh,
                                     int cqo, cudaStream_t stream) {
  DdArgs a;
  if (!dd_args(rec, words, offs, tab, aux, gw, gh, cqo, &a))
    return (int)cudaErrorInvalidValue;
  k_deblock_params_dec<<<dim3(dd_strips(gw), gh, K), DD_THREADS,
                         dd_smem_bytes(a.span), stream>>>(a);
  return (int)cudaGetLastError();
}
