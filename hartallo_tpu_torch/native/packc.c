/* The GOP kernel's per-picture payload (decode/d_pool.pack_fast) in one
 * pass over the parsed macroblocks, in raster order.
 *
 * Writes exactly what d_pool.pack_fast_py writes, byte for byte:
 *   smb    (n, 8) int32      the quadrant MC window words;
 *   aux    (gh, gw, 62) int16 the deblock thresholds and bS of each MB;
 *   tags / vals               the coded inter 4x4 blocks (luma, then U,
 *                             then V), dequantised and inverse-transformed;
 *   ilist / ivals             each intra MB's word, mode words and its 24
 *                             dense inverse-transformed blocks.
 * The arithmetic is numpy's int32 arithmetic: sums and products wrap
 * (done in uint32), right shifts are arithmetic.  A 4x4 block's dequant
 * and inverse transform run as four 4-lane rows (GCC vector extensions,
 * SSE2 on x86-64).
 *
 * The tables (QUANT_V, the deblock tables, the chroma QP map, the
 * quarter-pel case table, the 4x4 block layout) and the constants PAD and
 * MAX_RES are handed over once from Python (hl_pack_tables); nothing of
 * them is typed here.
 *
 * Build: gcc -O3 -shared -fPIC -o packc.so packc.c
 */
#include <stdint.h>
#include <string.h>

typedef uint32_t u32;
typedef int32_t v4si __attribute__((vector_size(16)));
typedef uint32_t v4su __attribute__((vector_size(16)));
typedef int16_t v4hi __attribute__((vector_size(8)));
#define SRA(x, k) ((v4su)((v4si)(x) >> (k)))

static int32_t QV[6][16];          /* QUANT_V[qp % 6], raster 4x4 */
static int32_t ALPHA[52], BETA[52], TC0[52][3], QPC[52];
static int32_t QPT[16][6];         /* case 4*fy + fx -> p0,dx0,dy0,p1,dx1,dy1 */
static int32_t BLK_X[16], BLK_Y[16];   /* blkIdx -> pixel offset in the MB */
static int32_t RASTER_OF[16];      /* blkIdx -> raster 4x4 position */
static int32_t PAD, MAX_RES;

#define NAUX 62

void hl_pack_tables(const int32_t *quant_v, const int32_t *alpha,
                    const int32_t *beta, const int32_t *tc0,
                    const int32_t *qp_scale_chroma, const int32_t *qpt,
                    const int32_t *blk_xy, const int32_t *raster_of,
                    int32_t pad, int32_t max_res)
{
    for (int i = 0; i < 6 * 16; i++) QV[i / 16][i % 16] = quant_v[i];
    for (int i = 0; i < 52; i++) {
        ALPHA[i] = alpha[i];
        BETA[i] = beta[i];
        QPC[i] = qp_scale_chroma[i];
        for (int k = 0; k < 3; k++) TC0[i][k] = tc0[i * 3 + k];
    }
    for (int i = 0; i < 16 * 6; i++) QPT[i / 6][i % 6] = qpt[i];
    for (int b = 0; b < 16; b++) {
        BLK_X[b] = blk_xy[2 * b];
        BLK_Y[b] = blk_xy[2 * b + 1];
        RASTER_OF[b] = raster_of[b];
    }
    PAD = pad;
    MAX_RES = max_res;
}

/* numpy's floor division and modulo by 6 */
static inline int32_t fdiv6(int32_t q) { return q >= 0 ? q / 6 : -((5 - q) / 6); }
static inline int32_t clip3(int32_t lo, int32_t hi, int32_t v)
{
    return v < lo ? lo : (v > hi ? hi : v);
}
static inline int64_t clip64(int64_t lo, int64_t hi, int64_t v)
{
    return v < lo ? lo : (v > hi ? hi : v);
}

/* d_pool._dequant_np's constants for one QP (8.5.12.1 flat dequant) */
typedef struct {
    v4su ls[4];        /* 16 * QUANT_V[qp % 6], a row a vector */
    v4su rnd;          /* the rounding term where qp < 24 */
    int hi, shift;     /* qp >= 24: << shift; else (+ rnd) >> shift */
} Dq;

static inline void dq_init(Dq *q, int32_t qp)
{
    int32_t qdiv = fdiv6(qp), qmod = qp - 6 * qdiv;
    for (int r = 0; r < 4; r++)
        for (int c = 0; c < 4; c++)
            q->ls[r][c] = (u32)(16 * QV[qmod][4 * r + c]);
    q->hi = qp >= 24;
    q->shift = q->hi ? (qdiv - 4 > 0 ? qdiv - 4 : 0)
                     : (4 - qdiv > 0 ? 4 - qdiv : 0);
    u32 rnd = (u32)1 << (3 - qdiv > 0 ? 3 - qdiv : 0);
    q->rnd = (v4su){rnd, rnd, rnd, rnd};
}

/* one block's levels (raster 4x4) dequantised, a row a vector */
static inline void dequant(const int32_t *c, const Dq *q, v4su r[4])
{
    for (int k = 0; k < 4; k++) {
        v4su x;
        memcpy(&x, c + 4 * k, 16);
        r[k] = q->hi ? (x * q->ls[k]) << q->shift
                     : SRA(x * q->ls[k] + q->rnd, q->shift);
    }
}

static inline void transpose4(v4su *a, v4su *b, v4su *c, v4su *d)
{
    v4su t0 = __builtin_shuffle(*a, *b, (v4su){0, 4, 1, 5});
    v4su t1 = __builtin_shuffle(*c, *d, (v4su){0, 4, 1, 5});
    v4su t2 = __builtin_shuffle(*a, *b, (v4su){2, 6, 3, 7});
    v4su t3 = __builtin_shuffle(*c, *d, (v4su){2, 6, 3, 7});
    *a = __builtin_shuffle(t0, t1, (v4su){0, 1, 4, 5});
    *b = __builtin_shuffle(t0, t1, (v4su){2, 3, 6, 7});
    *c = __builtin_shuffle(t2, t3, (v4su){0, 1, 4, 5});
    *d = __builtin_shuffle(t2, t3, (v4su){2, 3, 6, 7});
}

/* 8.5.12.2 inverse core transform, rows then columns (d_pool._idct_np),
 * in place on the rows r[0..3] */
static inline void idct(v4su r[4])
{
    v4su c0 = r[0], c1 = r[1], c2 = r[2], c3 = r[3];
    transpose4(&c0, &c1, &c2, &c3);          /* cj: element j of each row */
    v4su e0 = c0 + c2, e1 = c0 - c2;
    v4su e2 = SRA(c1, 1) - c3, e3 = c1 + SRA(c3, 1);
    v4su f0 = e0 + e3, f1 = e1 + e2, f2 = e1 - e2, f3 = e0 - e3;
    transpose4(&f0, &f1, &f2, &f3);          /* fi: row i */
    v4su g0 = f0 + f2, g1 = f0 - f2;
    v4su g2 = SRA(f1, 1) - f3, g3 = f1 + SRA(f3, 1);
    r[0] = SRA(g0 + g3 + 32, 6);
    r[1] = SRA(g1 + g2 + 32, 6);
    r[2] = SRA(g1 - g2 + 32, 6);
    r[3] = SRA(g0 - g3 + 32, 6);
}

/* a chroma block's residual: its AC levels dequantised, its descaled DC
 * put in, inverse-transformed.  With no AC level the transform of the DC
 * alone is (dc + 32) >> 6 in every sample. */
static inline void chroma_block(const int32_t *c, const Dq *q, int32_t dc,
                                v4su r[4])
{
    int32_t any = 0;
    for (int i = 1; i < 16; i++) any |= c[i];
    if (!any) {
        u32 v = (u32)((int32_t)((u32)dc + 32u) >> 6);
        r[0] = r[1] = r[2] = r[3] = (v4su){v, v, v, v};
        return;
    }
    dequant(c, q, r);
    r[0][0] = (u32)dc;
    idct(r);
}

/* store a block as int16 (truncating, as numpy's astype) and flag
 * numpy's |x| > MAX_RES, on the int32 value (inter pool, ``wide``) or on
 * the stored int16 value (intra pool); numpy's abs wraps, so |INT32_MIN|
 * and |INT16_MIN| stay negative */
static inline v4su store_block(const v4su r[4], int16_t *o, int wide)
{
    v4si lim = {MAX_RES, MAX_RES, MAX_RES, MAX_RES};
    v4su over = {0, 0, 0, 0};
    for (int k = 0; k < 4; k++) {
        v4su x = wide ? r[k] : SRA(r[k] << 16, 16);
        v4su s = SRA(x, 31);
        v4su a = (x ^ s) - s;
        if (!wide) a = SRA(a << 16, 16);
        over |= (v4su)((v4si)a > lim);
        v4hi h = __builtin_convertvector((v4si)r[k], v4hi);
        memcpy(o + 4 * k, &h, 8);
    }
    return over;
}

/* 8.5.10 Intra16x16 luma DC (raster 4x4), d_pool._luma_dc_descale_np */
static void luma_dc(const int32_t *x, int32_t qp, int32_t *out)
{
    u32 t[16];
    for (int c = 0; c < 4; c++) {          /* rows combined, per column */
        u32 a0 = (u32)x[c] + (u32)x[4 + c], a1 = (u32)x[c] - (u32)x[4 + c];
        u32 b0 = (u32)x[8 + c] + (u32)x[12 + c];
        u32 b1 = (u32)x[8 + c] - (u32)x[12 + c];
        t[c] = a0 + b0;
        t[4 + c] = a0 - b0;
        t[8 + c] = a1 - b1;
        t[12 + c] = a1 + b1;
    }
    int32_t qdiv = fdiv6(qp), qmod = qp - 6 * qdiv;
    u32 scale = (u32)(16 * QV[qmod][0]);
    for (int r = 0; r < 4; r++) {
        u32 *y = t + 4 * r;
        u32 c0 = y[0] + y[1], c1 = y[0] - y[1];
        u32 d0 = y[2] + y[3], d1 = y[2] - y[3];
        u32 f[4] = {c0 + d0, c0 - d0, c1 - d1, c1 + d1};
        for (int c = 0; c < 4; c++) {
            if (qp >= 36) {
                int s = qdiv - 6 > 0 ? qdiv - 6 : 0;
                out[4 * r + c] = (int32_t)((f[c] * scale) << s);
            } else {
                int s = 6 - qdiv > 0 ? 6 - qdiv : 0;
                u32 rnd = (u32)1 << (5 - qdiv > 0 ? 5 - qdiv : 0);
                out[4 * r + c] = (int32_t)(f[c] * scale + rnd) >> s;
            }
        }
    }
}

/* 8.5.11 chroma DC (4:2:0) of one plane, d_pool._chroma_dc_descale_np;
 * c and out raster 2x2 (== blkIdx order) */
static inline void chroma_dc(const int32_t *c, int32_t qp, int32_t *out)
{
    if (!(c[0] | c[1] | c[2] | c[3])) {
        out[0] = out[1] = out[2] = out[3] = 0;
        return;
    }
    u32 t00 = (u32)c[0] + (u32)c[2], t01 = (u32)c[1] + (u32)c[3];
    u32 t10 = (u32)c[0] - (u32)c[2], t11 = (u32)c[1] - (u32)c[3];
    u32 f[4] = {t00 + t01, t00 - t01, t10 + t11, t10 - t11};
    int32_t qdiv = fdiv6(qp), qmod = qp - 6 * qdiv;
    u32 scale = (u32)(16 * QV[qmod][0]);
    for (int i = 0; i < 4; i++)
        out[i] = (int32_t)((f[i] * scale) << qdiv) >> 5;
}

static inline int32_t chroma_qp(int32_t qp, int32_t off)
{
    return QPC[clip3(0, 51, qp + off)];
}

/* the TotalCoeff flags of MB (mx, my) as 16 bits, bit 4 * row + column
 * (the 4x4 block's raster position; also its index in the MB's MVs) */
static inline unsigned nz_bits(const int16_t *nnz, int64_t gw4, int32_t mx,
                               int32_t my)
{
    unsigned z = 0;
    for (int k = 0; k < 4; k++) {
        const int16_t *row = nnz + (4 * (int64_t)my + k) * gw4 + 4 * mx;
        for (int j = 0; j < 4; j++)
            z |= (unsigned)(row[j] > 0) << (4 * k + j);
    }
    return z;
}

/* the chroma blocks an inter MB sends to the pool, bit 4 * plane + blkIdx:
 * those with AC coefficients or a nonzero descaled DC (dcc) */
static inline unsigned chroma_bits(const int16_t *nnz_chroma, int64_t gw,
                                   int32_t mx, int32_t my,
                                   const int32_t dcc[2][4])
{
    unsigned z = 0;
    for (int p = 0; p < 2; p++)
        for (int b = 0; b < 4; b++) {
            int64_t g = ((2 * (int64_t)my + b / 2) * 2 * gw + 2 * mx + b % 2)
                        * 2 + p;
            z |= (unsigned)(nnz_chroma[g] > 0 || dcc[p][b] != 0)
                 << (4 * p + b);
        }
    return z;
}

/* Coded inter blocks of the picture, and its intra MBs:
 * out = {luma blocks, U blocks, V blocks, intra MBs}. */
void hl_pack_count(int32_t gw, int32_t gh, int32_t chroma_qp_off,
                   const int8_t *kind, const int8_t *qp,
                   const int32_t *chroma_dc_lv, const int16_t *nnz_luma,
                   const int16_t *nnz_chroma, int64_t *out)
{
    int64_t nl = 0, nu = 0, nv = 0, ni = 0;
    for (int32_t my = 0; my < gh; my++)
        for (int32_t mx = 0; mx < gw; mx++) {
            int64_t m = (int64_t)my * gw + mx;
            if (kind[m] <= 2) {
                ni++;
                continue;
            }
            nl += __builtin_popcount(nz_bits(nnz_luma, 4 * (int64_t)gw, mx,
                                             my));
            int32_t qc = chroma_qp(qp[m], chroma_qp_off), dcc[2][4];
            chroma_dc(chroma_dc_lv + m * 8, qc, dcc[0]);
            chroma_dc(chroma_dc_lv + m * 8 + 4, qc, dcc[1]);
            unsigned c = chroma_bits(nnz_chroma, gw, mx, my, dcc);
            nu += __builtin_popcount(c & 15);
            nv += __builtin_popcount(c >> 4);
        }
    out[0] = nl;
    out[1] = nu;
    out[2] = nv;
    out[3] = ni;
}

/* -1 in lane k where bit k of a 4-bit mask is set */
static inline v4si lanes_of(unsigned bits)
{
    v4si b = {(int32_t)bits, (int32_t)bits, (int32_t)bits, (int32_t)bits};
    return (b & (v4si){1, 2, 4, 8}) != 0;
}

/* bits 0, 4, 8, 12 of z >> c (column c of an MB's 4x4 bits) as bits 0-3 */
static inline unsigned column_bits(unsigned z, int c)
{
    unsigned x = (z >> c) & 0x1111;
    return (x | (x >> 3) | (x >> 6) | (x >> 9)) & 15;
}

/* an MB's 16 MVs as rows of x and of y components */
static inline void mv_rows(const int32_t *mv, v4si x[4], v4si y[4])
{
    for (int k = 0; k < 4; k++) {
        v4si a, b;
        memcpy(&a, mv + 8 * k, 16);
        memcpy(&b, mv + 8 * k + 4, 16);
        x[k] = __builtin_shuffle(a, b, (v4si){0, 2, 4, 6});
        y[k] = __builtin_shuffle(a, b, (v4si){1, 3, 5, 7});
    }
}

/* -1 where |q - p| >= 4 in either MV component, with numpy's int32 wrap
 * (|INT32_MIN| stays negative) */
static inline v4si mv_far(v4si xq, v4si yq, v4si xp, v4si yp)
{
    v4su dx = (v4su)xq - (v4su)xp, dy = (v4su)yq - (v4su)yp;
    v4su sx = SRA(dx, 31), sy = SRA(dy, 31);
    v4si ax = (v4si)((dx ^ sx) - sx), ay = (v4si)((dy ^ sy) - sy);
    return (ax >= 4) | (ay >= 4);
}

/* one edge line's four bS: 2 where either block has coefficients, else 1
 * where the MVs lie 4 or more apart; 4 across an intra neighbour; 0 where
 * the edge is not filtered */
static inline void edge_line(int16_t *out, unsigned nz_pq, v4si far,
                             int intra_p, int on)
{
    v4si nzm = lanes_of(nz_pq);
    v4si bs = (nzm & 2) | (~nzm & far & 1);
    if (intra_p) bs = (v4si){4, 4, 4, 4};
    if (!on) bs = (v4si){0, 0, 0, 0};
    v4hi h = __builtin_convertvector(bs, v4hi);
    memcpy(out, &h, 8);
}

/* 8.7.2.1 bS of an inter MB's 16 vertical edges (v[4 * e + k], edge
 * column e, row k) and 16 horizontal ones (h[4 * e + k], edge row e,
 * column k), as d_pool._bs_grids_np.  Edge 0 faces the left (top) MB; an
 * MB on the picture's edge is its own neighbour there, each block facing
 * itself. */
static inline void mb_bs(int16_t *v, int16_t *h, unsigned nz,
                         const int32_t *mv, int has_l, int intra_l,
                         unsigned nz_l, const int32_t *mv_l, int has_t,
                         int intra_t, unsigned nz_t, const int32_t *mv_t,
                         int fmb_v, int fmb_h, int fint)
{
    v4si x[4], y[4], xp, yp;
    mv_rows(mv, x, y);
    if (has_t) {
        v4si xt[4], yt[4];
        mv_rows(mv_t, xt, yt);
        xp = xt[3];
        yp = yt[3];
    } else {
        xp = x[0];
        yp = y[0];
    }
    for (int e = 0; e < 4; e++) {
        unsigned q = (nz >> (4 * e)) & 15;
        unsigned p = e ? (nz >> (4 * e - 4)) & 15
                       : (has_t ? (nz_t >> 12) & 15 : q);
        if (e) {
            xp = x[e - 1];
            yp = y[e - 1];
        }
        edge_line(h + 4 * e, q | p, mv_far(x[e], y[e], xp, yp),
                  e == 0 && has_t && intra_t, e ? fint : fmb_h);
    }
    v4su cx[4] = {(v4su)x[0], (v4su)x[1], (v4su)x[2], (v4su)x[3]};
    v4su cy[4] = {(v4su)y[0], (v4su)y[1], (v4su)y[2], (v4su)y[3]};
    transpose4(&cx[0], &cx[1], &cx[2], &cx[3]);   /* cx[e]: column e */
    transpose4(&cy[0], &cy[1], &cy[2], &cy[3]);
    if (has_l) {
        xp = (v4si){mv_l[6], mv_l[14], mv_l[22], mv_l[30]};
        yp = (v4si){mv_l[7], mv_l[15], mv_l[23], mv_l[31]};
    } else {
        xp = (v4si)cx[0];
        yp = (v4si)cy[0];
    }
    for (int e = 0; e < 4; e++) {
        unsigned q = column_bits(nz, e);
        unsigned p = e ? column_bits(nz, e - 1)
                       : (has_l ? column_bits(nz_l, 3) : q);
        if (e) {
            xp = (v4si)cx[e - 1];
            yp = (v4si)cy[e - 1];
        }
        edge_line(v + 4 * e, q | p,
                  mv_far((v4si)cx[e], (v4si)cy[e], xp, yp),
                  e == 0 && has_l && intra_l, e ? fint : fmb_v);
    }
}

static inline void ab_t(int16_t *ab, int16_t *ts, int32_t qe, int32_t offa,
                        int32_t offb)
{
    int32_t ia = clip3(0, 51, qe + offa), ib = clip3(0, 51, qe + offb);
    ab[0] = (int16_t)ALPHA[ia];
    ab[1] = (int16_t)BETA[ib];
    ts[0] = (int16_t)TC0[ia][0];
    ts[1] = (int16_t)TC0[ia][1];
    ts[2] = (int16_t)TC0[ia][2];
}

/* The payload.  cnt: hl_pack_count's output for the same picture.
 * Returns 0, or 1 where a residual exceeds MAX_RES (the caller raises
 * OverflowError, as pack_fast_py does). */
int64_t hl_pack_fast(int32_t gw, int32_t gh, int32_t chroma_qp_off,
                     const int8_t *kind, const int8_t *qp,
                     const int8_t *i16_mode, const int8_t *i4_modes,
                     const int8_t *chroma_mode,
                     const int32_t *luma_ac, const int32_t *luma_dc_lv,
                     const int32_t *chroma_dc_lv, const int32_t *chroma_ac,
                     const int16_t *nnz_luma, const int16_t *nnz_chroma,
                     const int32_t *mv, const int8_t *alpha_off,
                     const int8_t *beta_off, const uint8_t *fmb_v,
                     const uint8_t *fmb_h, const uint8_t *fint,
                     const uint8_t *al, const uint8_t *at, const uint8_t *atr,
                     const int64_t *cnt,
                     int32_t *smb, int16_t *aux, int32_t *tags, int16_t *vals,
                     int32_t *ilist, int16_t *ivals)
{
    const int64_t W = 16 * (int64_t)gw, H = 16 * (int64_t)gh;
    const int64_t Wc = 8 * (int64_t)gw, Hc = 8 * (int64_t)gh;
    const int64_t gw4 = 4 * (int64_t)gw;
    int64_t il = 0, iu = cnt[0], iv = cnt[0] + cnt[1], ii = 0;
    v4su over = {0, 0, 0, 0};
    v4su r[4];
    unsigned nz_up[gw > 0 ? gw : 1];       /* the row above's TotalCoeff bits */
    unsigned nz_left = 0;
    memset(nz_up, 0, sizeof nz_up);

    for (int32_t my = 0; my < gh; my++)
        for (int32_t mx = 0; mx < gw; mx++) {
            const int64_t m = (int64_t)my * gw + mx;
            const int intra = kind[m] <= 2;
            const int64_t ml = mx > 0 ? m - 1 : m, mt = my > 0 ? m - gw : m;
            const unsigned nz = nz_bits(nnz_luma, gw4, mx, my);

            /* ---- smb: the quadrant MC windows -------------------------- */
            for (int q = 0; q < 4; q++) {
                const int qx = q & 1, qy = q >> 1;
                const int32_t *v = mv + (m * 16 + (2 * qy) * 4 + 2 * qx) * 2;
                const int64_t mvx = v[0], mvy = v[1];
                int64_t xi = clip64(-(PAD - 2), W + PAD - 7,
                                    mx * 16 + qx * 8 + (mvx >> 2));
                int64_t yi = clip64(-(PAD - 2), H + PAD - 7,
                                    my * 16 + qy * 8 + (mvy >> 2));
                const int32_t *c = QPT[(mvy & 3) * 4 + (mvx & 3)];
                int64_t wl = ((yi + PAD) << 20) | ((xi + PAD) << 8) |
                             (c[0] << 6) | (c[3] << 4) | (c[2] << 3) |
                             (c[1] << 2) | (c[5] << 1) | c[4];
                int64_t cxi = clip64(-(PAD - 1), Wc + PAD - 4,
                                     mx * 8 + qx * 4 + (mvx >> 3));
                int64_t cyi = clip64(-(PAD - 1), Hc + PAD - 4,
                                     my * 8 + qy * 4 + (mvy >> 3));
                int64_t wc = ((cyi + PAD) << 17) | ((cxi + PAD) << 6) |
                             ((mvy & 7) << 3) | (mvx & 7);
                smb[m * 8 + q] = (int32_t)wl;
                smb[m * 8 + 4 + q] = (int32_t)wc;
            }

            /* ---- aux: thresholds, then the bS of 32 edges --------------- */
            int16_t *a = aux + m * NAUX;
            const int32_t q0 = qp[m], offa = alpha_off[m], offb = beta_off[m];
            const int32_t qc = chroma_qp(q0, chroma_qp_off);
            const int32_t qcl = chroma_qp(qp[ml], chroma_qp_off);
            const int32_t qct = chroma_qp(qp[mt], chroma_qp_off);
            ab_t(a + 0, a + 12, (qp[ml] + q0 + 1) >> 1, offa, offb);
            ab_t(a + 2, a + 15, (qp[mt] + q0 + 1) >> 1, offa, offb);
            ab_t(a + 4, a + 18, q0, offa, offb);
            ab_t(a + 6, a + 21, (qcl + qc + 1) >> 1, offa, offb);
            ab_t(a + 8, a + 24, (qct + qc + 1) >> 1, offa, offb);
            ab_t(a + 10, a + 27, qc, offa, offb);
            if (intra) {                         /* bS 4 at MB edges, 3 inside */
                for (int k = 0; k < 16; k++) {
                    a[30 + k] = (int16_t)(k < 4 ? (fmb_v[m] ? 4 : 0)
                                                : (fint[m] ? 3 : 0));
                    a[46 + k] = (int16_t)(k < 4 ? (fmb_h[m] ? 4 : 0)
                                                : (fint[m] ? 3 : 0));
                }
            } else {
                mb_bs(a + 30, a + 46, nz, mv + m * 32,
                      mx > 0, kind[ml] <= 2, nz_left, mv + ml * 32,
                      my > 0, kind[mt] <= 2, nz_up[mx], mv + mt * 32,
                      fmb_v[m], fmb_h[m], fint[m]);
            }
            nz_left = nz_up[mx] = nz;

            /* ---- residual ---------------------------------------------- */
            Dq dq_l, dq_c;
            dq_init(&dq_l, q0);
            dq_init(&dq_c, qc);
            int32_t dcc[2][4];
            chroma_dc(chroma_dc_lv + m * 8, qc, dcc[0]);
            chroma_dc(chroma_dc_lv + m * 8 + 4, qc, dcc[1]);
            if (!intra) {
                for (int b = 0; b < 16; b++) {   /* blkIdx order */
                    if (!((nz >> RASTER_OF[b]) & 1)) continue;
                    dequant(luma_ac + m * 256 + b * 16, &dq_l, r);
                    idct(r);
                    over |= store_block(r, vals + il * 16, 1);
                    tags[il++] = (int32_t)(((PAD + my * 16 + BLK_Y[b]) << 12) |
                                           (PAD + mx * 16 + BLK_X[b]));
                }
                const unsigned cb = chroma_bits(nnz_chroma, gw, mx, my, dcc);
                for (int p = 0; p < 2; p++)
                    for (int b = 0; b < 4; b++) {
                        if (!((cb >> (4 * p + b)) & 1)) continue;
                        chroma_block(chroma_ac + m * 128 + p * 64 + b * 16,
                                     &dq_c, dcc[p][b], r);
                        int64_t j = p == 0 ? iu++ : iv++;
                        over |= store_block(r, vals + j * 16, 1);
                        tags[j] = (int32_t)(((PAD + my * 8 + (b / 2) * 4) << 12) |
                                            (PAD + mx * 8 + (b % 2) * 4));
                    }
                continue;
            }

            /* ---- intra MB: its word, modes and 24 dense blocks ---------- */
            const int i16 = kind[m] == 1;
            int32_t *li = ilist + ii * 4;
            li[0] = (int32_t)m;
            li[1] = i16 | (clip3(0, 3, i16_mode[m]) << 1) |
                    (clip3(0, 3, chroma_mode[m]) << 3) |
                    ((int32_t)al[m] << 5) | ((int32_t)at[m] << 6) |
                    ((int32_t)atr[m] << 7);
            u32 w0 = 0, w1 = 0;
            for (int k = 0; k < 8; k++) {
                w0 += (u32)clip3(0, 8, i4_modes[m * 16 + k]) << (4 * k);
                w1 += (u32)clip3(0, 8, i4_modes[m * 16 + 8 + k]) << (4 * k);
            }
            li[2] = (int32_t)w0;
            li[3] = (int32_t)w1;
            int32_t ldc[16];
            if (i16) luma_dc(luma_dc_lv + m * 16, q0, ldc);
            int16_t *o = ivals + ii * 24 * 16;
            for (int b = 0; b < 16; b++) {
                dequant(luma_ac + m * 256 + b * 16, &dq_l, r);
                if (i16) r[0][0] = (u32)ldc[RASTER_OF[b]];
                idct(r);
                over |= store_block(r, o + b * 16, 0);
            }
            for (int k = 0; k < 8; k++) {        /* U blocks, then V */
                chroma_block(chroma_ac + m * 128 + k * 16, &dq_c,
                             dcc[k / 4][k % 4], r);
                over |= store_block(r, o + (16 + k) * 16, 0);
            }
            ii++;
        }
    return (over[0] | over[1] | over[2] | over[3]) != 0;
}
