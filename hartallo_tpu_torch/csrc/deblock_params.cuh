// The deblock parameters' arithmetic, shared by the encoder's
// k_deblock_params (p_encode.cu) and the decoder's k_deblock_params_dec
// (deblock.cu): the bS rule of 8.7.2.1 and one (alpha, beta, tc0) set of
// an ops/deblock.edge_params row.  Each kernel applies the rule for an
// intra edge inside the MB (bS 3, not 4) in its own edge_bs.
#pragma once

#include <cstdint>

namespace hl {

// the deblock tables as both wrappers lay them out, int32 words from
// QP_SCALE_CHROMA on: QP_SCALE_CHROMA (52), DEBLOCK_ALPHA (52),
// DEBLOCK_BETA (52) and DEBLOCK_TC0 (52, 3) of core/tables.py
constexpr int DPT_QPC = 0, DPT_ALPHA = 52, DPT_BETA = 104, DPT_TC0 = 156;

__device__ __forceinline__ int clampi(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// bS of the edge between block q and its neighbour p (8.7.2.1, as
// ops/wide.compute_bs_grids) before the internal-edge rule: intra either
// side, levels either side, their MVs and references
__device__ __forceinline__ int bs_rule(bool intra, bool nz, int2 vq, int2 vp,
                                       int rq, int rp) {
  if (intra) return 4;
  if (nz) return 2;
  const int dx = vq.x - vp.x, dy = vq.y - vp.y;
  return (dx >= 4 || dx <= -4 || dy >= 4 || dy <= -4 || rq != rp) ? 1 : 0;
}

// Set l of an MB's edge_params row (0-2 the luma left, top and internal
// edges, 3-5 the chroma ones): alpha and beta into row[2 l], row[2 l + 1],
// tc0 into row[12 + 3 l ..].  qp is the MB's QP, qn the left MB's (sets 0
// and 3) or the top MB's (1 and 4); aoff and boff the slice's offsets; tab
// the tables above.
__device__ __forceinline__ void edge_set(const int* tab, int l, int qp,
                                         int qn, int cqo, int aoff, int boff,
                                         int16_t* row) {
  const int k = l < 3 ? l : l - 3;       // 0 left, 1 top, 2 internal
  int qe = k == 2 ? qp : (qn + qp + 1) >> 1;
  if (l >= 3) {                          // chroma: the QPs' chroma QPs
    const int qpc = tab[DPT_QPC + clampi(0, 51, qp + cqo)];
    const int qnc = tab[DPT_QPC + clampi(0, 51, qn + cqo)];
    qe = l == 5 ? qpc : (qnc + qpc + 1) >> 1;
  }
  const int ia = clampi(0, 51, qe + aoff), ib = clampi(0, 51, qe + boff);
  row[2 * l] = (int16_t)tab[DPT_ALPHA + ia];
  row[2 * l + 1] = (int16_t)tab[DPT_BETA + ib];
  for (int j = 0; j < 3; ++j)
    row[12 + 3 * l + j] = (int16_t)tab[DPT_TC0 + 3 * ia + j];
}

}  // namespace hl
