/* Native host codec: CAVLC slice_data parse + pack.
 *
 * This is the framework's C runtime for the serial bitstream stage — the
 * TPU-native analog of the reference's hand-written entropy hot loop
 * (hl_codec_264_slice.c slice_data_decode/encode + hl_codec_264_cavlc.c).
 * Semantics mirror hartallo_tpu/decode/slice_decode.py and
 * hartallo_tpu/encode/slice_encode.py exactly (differential-tested).
 *
 * Built as a shared library, bound via ctypes (no pybind11 dependency).
 */
#include <stdint.h>
#include <string.h>

/* ---------------------------------------------------------------- tables */

/* Table 9-5 coeff_token (len,code)[ctx][T1][TC] */
static const uint8_t CT_LEN[3][4][17] = {
    {{1,6,8,9,10,11,13,13,13,14,14,15,15,16,16,16,16},
     {0,2,6,8,9,10,11,13,13,14,14,15,15,15,16,16,16},
     {0,0,3,7,8,9,10,11,13,13,14,14,15,15,16,16,16},
     {0,0,0,5,6,7,8,9,10,11,13,14,14,15,15,16,16}},
    {{2,6,6,7,8,8,9,11,11,12,12,12,13,13,13,14,14},
     {0,2,5,6,6,7,8,9,11,11,12,12,13,13,14,14,14},
     {0,0,3,6,6,7,8,9,11,11,12,12,13,13,13,14,14},
     {0,0,0,4,4,5,6,6,7,9,11,11,12,13,13,13,14}},
    {{4,6,6,6,7,7,7,7,8,8,9,9,9,10,10,10,10},
     {0,4,5,5,5,5,6,6,7,8,8,9,9,9,10,10,10},
     {0,0,4,5,5,5,6,6,7,7,8,8,9,9,10,10,10},
     {0,0,0,4,4,4,4,4,5,6,7,8,8,9,10,10,10}},
};
static const uint8_t CT_VAL[3][4][17] = {
    {{1,5,7,7,7,7,15,11,8,15,11,15,11,15,11,7,4},
     {0,1,4,6,6,6,6,14,10,14,10,14,10,1,14,10,6},
     {0,0,1,5,5,5,5,5,13,9,13,9,13,9,13,9,5},
     {0,0,0,3,3,4,4,4,4,4,12,12,8,12,8,12,8}},
    {{3,11,7,7,7,4,7,15,11,15,11,8,15,11,7,9,7},
     {0,2,7,10,6,6,6,6,14,10,14,10,14,10,11,8,6},
     {0,0,3,9,5,5,5,5,13,9,13,9,13,9,6,10,5},
     {0,0,0,5,4,6,8,4,4,4,12,8,12,12,8,1,4}},
    {{15,15,11,8,15,11,9,8,15,11,15,11,8,13,9,5,1},
     {0,14,15,12,10,8,14,10,14,14,10,14,10,7,12,8,4},
     {0,0,13,14,11,9,13,9,13,10,13,9,13,9,11,7,3},
     {0,0,0,12,11,10,9,8,13,12,12,12,8,12,10,6,2}},
};
static const uint8_t CT_CDC_LEN[4][5] = {
    {2,6,6,6,6},{0,1,6,7,8},{0,0,3,7,8},{0,0,0,6,7}};
static const uint8_t CT_CDC_VAL[4][5] = {
    {1,7,4,3,2},{0,1,6,3,3},{0,0,1,2,2},{0,0,0,5,0}};

/* Tables 9-7/9-8 total_zeros (len,code)[TC-1][tz] */
static const uint8_t TZ_LEN[15][16] = {
    {1,3,3,4,4,5,5,6,6,7,7,8,8,9,9,9},
    {3,3,3,3,3,4,4,4,4,5,5,6,6,6,6,0},
    {4,3,3,3,4,4,3,3,4,5,5,6,5,6,0,0},
    {5,3,4,4,3,3,3,4,3,4,5,5,5,0,0,0},
    {4,4,4,3,3,3,3,3,4,5,4,5,0,0,0,0},
    {6,5,3,3,3,3,3,3,4,3,6,0,0,0,0,0},
    {6,5,3,3,3,2,3,4,3,6,0,0,0,0,0,0},
    {6,4,5,3,2,2,3,3,6,0,0,0,0,0,0,0},
    {6,6,4,2,2,3,2,5,0,0,0,0,0,0,0,0},
    {5,5,3,2,2,2,4,0,0,0,0,0,0,0,0,0},
    {4,4,3,3,1,3,0,0,0,0,0,0,0,0,0,0},
    {4,4,2,1,3,0,0,0,0,0,0,0,0,0,0,0},
    {3,3,1,2,0,0,0,0,0,0,0,0,0,0,0,0},
    {2,2,1,0,0,0,0,0,0,0,0,0,0,0,0,0},
    {1,1,0,0,0,0,0,0,0,0,0,0,0,0,0,0},
};
static const uint8_t TZ_VAL[15][16] = {
    {1,3,2,3,2,3,2,3,2,3,2,3,2,3,2,1},
    {7,6,5,4,3,5,4,3,2,3,2,3,2,1,0,0},
    {5,7,6,5,4,3,4,3,2,3,2,1,1,0,0,0},
    {3,7,5,4,6,5,4,3,3,2,2,1,0,0,0,0},
    {5,4,3,7,6,5,4,3,2,1,1,0,0,0,0,0},
    {1,1,7,6,5,4,3,2,1,1,0,0,0,0,0,0},
    {1,1,5,4,3,3,2,1,1,0,0,0,0,0,0,0},
    {1,1,1,3,3,2,2,1,0,0,0,0,0,0,0,0},
    {1,0,1,3,2,1,1,1,0,0,0,0,0,0,0,0},
    {1,0,1,3,2,1,1,0,0,0,0,0,0,0,0,0},
    {0,1,1,2,1,3,0,0,0,0,0,0,0,0,0,0},
    {0,1,1,1,1,0,0,0,0,0,0,0,0,0,0,0},
    {0,1,1,1,0,0,0,0,0,0,0,0,0,0,0,0},
    {0,1,1,0,0,0,0,0,0,0,0,0,0,0,0,0},
    {0,1,0,0,0,0,0,0,0,0,0,0,0,0,0,0},
};
static const uint8_t TZC_LEN[3][4] = {{1,2,3,3},{1,2,2,0},{1,1,0,0}};
static const uint8_t TZC_VAL[3][4] = {{1,1,1,0},{1,1,0,0},{1,0,0,0}};

/* Table 9-10 run_before (len,code)[min(zl,7)-1][run] */
static const uint8_t RB_LEN[7][15] = {
    {1,1,0,0,0,0,0,0,0,0,0,0,0,0,0},
    {1,2,2,0,0,0,0,0,0,0,0,0,0,0,0},
    {2,2,2,2,0,0,0,0,0,0,0,0,0,0,0},
    {2,2,2,3,3,0,0,0,0,0,0,0,0,0,0},
    {2,2,3,3,3,3,0,0,0,0,0,0,0,0,0},
    {2,3,3,3,3,3,3,0,0,0,0,0,0,0,0},
    {3,3,3,3,3,3,3,4,5,6,7,8,9,10,11},
};
static const uint8_t RB_VAL[7][15] = {
    {1,0,0,0,0,0,0,0,0,0,0,0,0,0,0},
    {1,1,0,0,0,0,0,0,0,0,0,0,0,0,0},
    {3,2,1,0,0,0,0,0,0,0,0,0,0,0,0},
    {3,2,1,1,0,0,0,0,0,0,0,0,0,0,0},
    {3,2,3,2,1,0,0,0,0,0,0,0,0,0,0},
    {3,0,1,3,2,5,4,0,0,0,0,0,0,0,0},
    {7,6,5,4,3,2,1,1,1,1,1,1,1,1,1},
};

/* zig-zag scan: coeff i -> raster pos */
static const int ZZ[16] = {0,1,4,8,5,2,3,6,9,12,13,10,7,11,14,15};
/* luma blkIdx -> (bx,by) in 4-pel units */
static const int BLKX[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
static const int BLKY[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};
/* raster (by,bx) -> blkIdx */
static const int BLKIDX[4][4] = {
    {0,1,4,5},{2,3,6,7},{8,9,12,13},{10,11,14,15}};

/* cbp me(v) mappings (Table 9-4, ChromaArrayType 1) */
static const uint8_t CBP_INTRA[48] = {
    47,31,15,0,23,27,29,30,7,11,13,14,39,43,45,46,16,3,5,10,12,19,21,26,
    28,35,37,42,44,1,2,4,8,17,18,20,24,6,9,22,25,32,33,34,36,40,38,41};
static const uint8_t CBP_INTER[48] = {
    0,16,1,2,4,8,32,3,5,10,12,15,47,7,11,13,14,6,9,31,35,37,42,44,33,34,
    36,40,39,43,45,46,17,18,20,24,19,21,26,28,23,27,29,30,22,25,38,41};
static uint8_t CBP_INTRA_INV[48], CBP_INTER_INV[48];

/* decode LUTs (built on init) */
static int16_t ct_lut_sym[3][1 << 16];
static uint8_t ct_lut_len[3][1 << 16];
static int16_t cdc_lut_sym[1 << 8];
static uint8_t cdc_lut_len[1 << 8];
static int16_t tz_lut_sym[15][1 << 9];
static uint8_t tz_lut_len[15][1 << 9];
static int16_t tzc_lut_sym[3][1 << 3];
static uint8_t tzc_lut_len[3][1 << 3];
static int16_t rb_lut_sym[7][1 << 11];
static uint8_t rb_lut_len[7][1 << 11];
static int initialized = 0;

static void build_lut(const uint8_t *lens, const uint8_t *vals,
                      const int16_t *syms, int count, int maxlen,
                      int16_t *lut_sym, uint8_t *lut_len)
{
    int size = 1 << maxlen, i;
    for (i = 0; i < size; ++i) { lut_sym[i] = -1; lut_len[i] = 0; }
    for (i = 0; i < count; ++i) {
        int ln = lens[i];
        if (!ln) continue;
        int base = vals[i] << (maxlen - ln);
        int span = 1 << (maxlen - ln);
        int16_t sym = syms ? syms[i] : (int16_t)i;
        for (int k = 0; k < span; ++k) {
            lut_sym[base + k] = sym;
            lut_len[base + k] = (uint8_t)ln;
        }
    }
}

void hl_slicec_init(void)
{
    if (initialized) return;
    int16_t syms[4 * 17];
    for (int t1 = 0; t1 < 4; ++t1)
        for (int tc = 0; tc < 17; ++tc)
            syms[t1 * 17 + tc] = (int16_t)(tc * 4 + t1);
    for (int c = 0; c < 3; ++c)
        build_lut(&CT_LEN[c][0][0], &CT_VAL[c][0][0], syms, 68, 16,
                  ct_lut_sym[c], ct_lut_len[c]);
    int16_t syms2[4 * 5];
    for (int t1 = 0; t1 < 4; ++t1)
        for (int tc = 0; tc < 5; ++tc)
            syms2[t1 * 5 + tc] = (int16_t)(tc * 4 + t1);
    build_lut(&CT_CDC_LEN[0][0], &CT_CDC_VAL[0][0], syms2, 20, 8,
              cdc_lut_sym, cdc_lut_len);
    for (int tc = 0; tc < 15; ++tc)
        build_lut(TZ_LEN[tc], TZ_VAL[tc], 0, 16, 9,
                  tz_lut_sym[tc], tz_lut_len[tc]);
    for (int tc = 0; tc < 3; ++tc)
        build_lut(TZC_LEN[tc], TZC_VAL[tc], 0, 4, 3,
                  tzc_lut_sym[tc], tzc_lut_len[tc]);
    for (int z = 0; z < 7; ++z)
        build_lut(RB_LEN[z], RB_VAL[z], 0, 15, 11,
                  rb_lut_sym[z], rb_lut_len[z]);
    for (int i = 0; i < 48; ++i) {
        CBP_INTRA_INV[CBP_INTRA[i]] = (uint8_t)i;
        CBP_INTER_INV[CBP_INTER[i]] = (uint8_t)i;
    }
    initialized = 1;
}

/* ------------------------------------------------------------- bitreader */

typedef struct {
    const uint8_t *data;
    int64_t nbits;
    int64_t pos;
    int error;
} BR;

static inline uint32_t br_peek(BR *b, int n)
{
    /* up to 24-bit fast peek; pads with zeros past the end */
    int64_t byte = b->pos >> 3;
    int off = (int)(b->pos & 7);
    uint32_t w = 0;
    int64_t nb = (b->nbits + 7) >> 3;
    for (int i = 0; i < 4; ++i)
        w = (w << 8) | (byte + i < nb ? b->data[byte + i] : 0);
    w <<= off;               /* drop consumed bits; 32-bit window */
    return n ? (w >> (32 - n)) : 0;
}

static inline uint32_t br_peek16(BR *b) { return br_peek(b, 16); }

/* Reads may run a bounded distance past the RBSP end, returning zero
 * bits: the reference decoder's NAL buffer is zero-padded
 * (hl_codec_264.c:193-205) and its cursor reads the padding silently,
 * which matters because the reference *encoder* under-writes the final
 * CAVLC level escape on dense content (stale entries in its level table,
 * hl_codec_264_cavlc.c:76 `level_suffix <= (1<<levelSuffixSize)`); a
 * bit-exact decode of such streams must consume the same zero tail. */
#define BR_PAD_BITS 256

static inline void br_skip(BR *b, int n)
{
    b->pos += n;
    if (b->pos > b->nbits + BR_PAD_BITS) b->error = 1;
}

static inline uint32_t br_u(BR *b, int n)
{
    if (n > 24) {
        uint32_t hi = br_u(b, n - 16);
        return (hi << 16) | br_u(b, 16);
    }
    uint32_t v = br_peek(b, n);
    br_skip(b, n);
    return v;
}

static inline uint32_t br_u1(BR *b) { return br_u(b, 1); }

static inline uint32_t br_ue(BR *b)
{
    /* reference semantics (hl_codec_264_bits.h:697-705, non-legacy):
     * leadingZeroBits = clz16(show(16)), capped at 16 — an all-zero
     * window decodes deterministically instead of scanning on */
    uint32_t w = br_peek(b, 16);
    int zeros = 16;
    if (w) {
        zeros = 0;
        while (!(w & 0x8000u)) { w <<= 1; ++zeros; }
    }
    if (!zeros) { br_skip(b, 1); return 0; }
    br_skip(b, zeros + 1);
    return (1u << zeros) - 1 + br_u(b, zeros);
}

static inline int32_t br_se(BR *b)
{
    uint32_t k = br_ue(b);
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
}

static inline int32_t br_te(BR *b, int range)
{
    if (range == 1) return 1 - (int32_t)br_u1(b);
    return (int32_t)br_ue(b);
}

static int br_more_rbsp(BR *b)
{
    int64_t idx = b->pos >> 3;
    int used = (int)(b->pos & 7);
    int64_t nb = (b->nbits + 7) >> 3;
    if (idx >= nb) return 0;
    /* find last set bit in the remaining stream */
    int64_t last = -1;
    for (int64_t i = nb - 1; i >= idx; --i) {
        uint8_t v = b->data[i];
        if (i == idx && used) v &= (uint8_t)(0xFF >> used);
        if (v) {
            int bit = 0;
            while (!(v & 1)) { v >>= 1; ++bit; }
            last = i * 8 + (7 - bit);
            break;
        }
    }
    if (last < 0) return 0;
    return last > b->pos;    /* data bits remain before the stop bit */
}

/* ------------------------------------------------------ residual decode */

/* Bit patterns outside the spec VLCs follow the reference decoder's
 * total-table semantics (hl_codec_264_cavlc.c:176-210): unassigned
 * coeff_token patterns land on explicit error entries {TO=0, TC=0,
 * consume 16/14/10 bits by nC context}, required for bit-exact decode
 * of streams the reference encoder itself mis-writes. */
static const int ct_error_skip[3] = { 16, 14, 10 };

static int read_coeff_token(BR *b, int nC, int *tc, int *t1)
{
    if (nC >= 8) {
        uint32_t code = br_u(b, 6);
        if (code == 3) { *tc = 0; *t1 = 0; return 0; }
        *tc = (int)(code >> 2) + 1;
        *t1 = (int)(code & 3);
        return 0;
    }
    if (nC == -1) {
        uint32_t p = br_peek(b, 8);
        int16_t sym = cdc_lut_sym[p];
        if (sym < 0) return -1;
        br_skip(b, cdc_lut_len[p]);
        *tc = sym >> 2; *t1 = sym & 3;
        return 0;
    }
    int ctx = nC < 2 ? 0 : (nC < 4 ? 1 : 2);
    uint32_t p = br_peek16(b);
    int16_t sym = ct_lut_sym[ctx][p];
    if (sym < 0) {
        br_skip(b, ct_error_skip[ctx]);
        *tc = 0; *t1 = 0;
        return 0;
    }
    br_skip(b, ct_lut_len[ctx][p]);
    *tc = sym >> 2; *t1 = sym & 3;
    return 0;
}

/* Reference semantics (hl_codec_264_cavlc.c:407-420): prefix is clz16
 * of a 16-bit window, capped at 16; an all-zero window consumes 17 bits
 * and yields 16 instead of scanning on. */
static int read_level_prefix(BR *b)
{
    uint32_t w = br_peek(b, 16);
    int zeros = 16;
    if (w) {
        zeros = 0;
        while (!(w & 0x8000u)) { w <<= 1; ++zeros; }
    }
    br_skip(b, zeros + 1);
    return zeros;
}

/* levels in scan order into out[max_coeff]; returns TotalCoeff or <0 */
static int read_residual_block(BR *b, int nC, int max_coeff, int32_t *out)
{
    int tc, t1;
    memset(out, 0, sizeof(int32_t) * (size_t)max_coeff);
    if (read_coeff_token(b, nC, &tc, &t1)) return -1;
    if (tc == 0) return 0;
    int64_t lev[16];
    int suffix_len = (tc > 10 && t1 < 3) ? 1 : 0;
    for (int i = 0; i < tc; ++i) {
        if (i < t1) {
            lev[i] = 1 - 2 * (int64_t)br_u1(b);
            continue;
        }
        int prefix = read_level_prefix(b);
        if (prefix < 0) return -2;
        int ssize = suffix_len;
        if (prefix == 14 && suffix_len == 0) ssize = 4;
        else if (prefix >= 15) ssize = prefix - 3;
        int64_t suffix = ssize ? br_u(b, ssize) : 0;
        int64_t code = ((int64_t)(prefix < 15 ? prefix : 15)
                        << suffix_len) + suffix;
        if (prefix >= 15 && suffix_len == 0) code += 15;
        if (prefix >= 16) code += ((int64_t)1 << (prefix - 3)) - 4096;
        if (i == t1 && t1 < 3) code += 2;
        lev[i] = (code & 1) ? -((code + 1) >> 1) : ((code + 2) >> 1);
        if (suffix_len == 0) suffix_len = 1;
        int64_t a = lev[i] < 0 ? -lev[i] : lev[i];
        if (a > (3LL << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
    }
    int total_zeros = 0;
    if (tc < max_coeff) {
        if (nC == -1) {
            uint32_t p = br_peek(b, 3);
            int16_t s = tzc_lut_sym[tc - 1][p];
            if (s < 0) return -3;
            br_skip(b, tzc_lut_len[tc - 1][p]);
            total_zeros = s;
        } else {
            uint32_t p = br_peek(b, 9);
            int16_t s = tz_lut_sym[tc - 1][p];
            if (s < 0) return -3;
            br_skip(b, tz_lut_len[tc - 1][p]);
            total_zeros = s;
        }
    }
    int zl = total_zeros;
    int runs[16];
    for (int i = 0; i < tc - 1; ++i) {
        int run = 0;
        if (zl > 0) {
            if (zl >= 7) {
                /* reference algorithm (hl_codec_264_cavlc.c:609-651):
                 * 3-bit code, run = 7 - code; code 0 escapes to a
                 * clz16-bounded unary tail (run up to 7 + 16). */
                uint32_t t3 = br_u(b, 3);
                if (t3) {
                    run = 7 - (int)t3;
                } else {
                    uint32_t p9 = br_peek(b, 9);
                    int ind = 16;
                    if (p9) {
                        ind = 0;
                        while (!(p9 & 0x100u)) { p9 <<= 1; ++ind; }
                    }
                    run = 7 + ind;
                    br_skip(b, ind + 1);
                }
            } else {
                uint32_t p = br_peek(b, 11);
                int16_t s = rb_lut_sym[zl - 1][p];
                if (s < 0) return -4;
                br_skip(b, rb_lut_len[zl - 1][p]);
                run = s;
            }
        }
        runs[i] = run;
        zl -= run;
    }
    runs[tc - 1] = zl;
    int posi = total_zeros + tc - 1;
    for (int i = 0; i < tc; ++i) {
        /* garbage runs can push posi out of range; the reference
         * scatters those into scratch slack (residual.c:573-578) —
         * drop them here */
        if (posi >= 0 && posi < max_coeff)
            out[posi] = (int32_t)lev[i];
        posi -= runs[i] + 1;
    }
    return tc;
}

/* ------------------------------------------------------------ bitwriter */

typedef struct {
    uint8_t *buf;
    int64_t cap;      /* bytes */
    int64_t pos;      /* bit position */
    int error;
} BW;

static inline void bw_u(BW *w, uint32_t v, int n)
{
    if (!n) return;
    if ((w->pos + n + 7) / 8 >= w->cap) { w->error = 1; return; }
    for (int i = n - 1; i >= 0; --i) {
        int64_t byte = w->pos >> 3;
        int off = 7 - (int)(w->pos & 7);
        if ((v >> i) & 1) w->buf[byte] |= (uint8_t)(1u << off);
        else w->buf[byte] &= (uint8_t)~(1u << off);
        ++w->pos;
    }
}

static inline void bw_ue(BW *w, uint32_t v)
{
    uint32_t code = v + 1;
    int n = 0;
    while ((code >> n) > 1) ++n;
    bw_u(w, 0, n);
    bw_u(w, code, n + 1);
}

static inline void bw_se(BW *w, int32_t v)
{
    bw_ue(w, v > 0 ? (uint32_t)(2 * v - 1) : (uint32_t)(-2 * v));
}

static inline void bw_te(BW *w, int32_t v, int range)
{
    if (range == 1) bw_u(w, (uint32_t)(1 - v), 1);
    else bw_ue(w, (uint32_t)v);
}

static void write_level_code(BW *w, int64_t code, int suffix_len)
{
    int64_t rem;
    if (suffix_len == 0) {
        if (code < 14) { bw_u(w, 1, (int)code + 1); return; }
        if (code < 30) { bw_u(w, 1, 15); bw_u(w, (uint32_t)(code - 14), 4);
                         return; }
        rem = code - 30;
    } else {
        if (code < (15LL << suffix_len)) {
            int prefix = (int)(code >> suffix_len);
            bw_u(w, 1, prefix + 1);
            bw_u(w, (uint32_t)(code & ((1 << suffix_len) - 1)), suffix_len);
            return;
        }
        rem = code - (15LL << suffix_len);
    }
    if (rem < 4096) { bw_u(w, 1, 16); bw_u(w, (uint32_t)rem, 12); return; }
    int p = 16;
    while (rem >= ((int64_t)1 << (p - 2)) - 4096) ++p;
    bw_u(w, 1, p + 1);
    bw_u(w, (uint32_t)(rem - (((int64_t)1 << (p - 3)) - 4096)), p - 3);
}

static void write_coeff_token(BW *w, int tc, int t1, int nC)
{
    if (nC >= 8) {
        bw_u(w, tc == 0 ? 3u : (uint32_t)(((tc - 1) << 2) | t1), 6);
    } else if (nC == -1) {
        bw_u(w, CT_CDC_VAL[t1][tc], CT_CDC_LEN[t1][tc]);
    } else {
        int ctx = nC < 2 ? 0 : (nC < 4 ? 1 : 2);
        bw_u(w, CT_VAL[ctx][t1][tc], CT_LEN[ctx][t1][tc]);
    }
}

/* levels in scan order; returns TotalCoeff */
static int write_residual_block(BW *w, const int32_t *levels, int nC,
                                int max_coeff)
{
    int pos[16], n = 0;
    for (int i = 0; i < max_coeff; ++i)
        if (levels[i]) pos[n++] = i;
    if (!n) { write_coeff_token(w, 0, 0, nC); return 0; }
    int hi = pos[n - 1];
    int total_zeros = hi + 1 - n;
    int t1 = 0;
    for (int i = n - 1; i >= 0 && t1 < 3; --i) {
        int32_t v = levels[pos[i]];
        if (v == 1 || v == -1) ++t1; else break;
    }
    write_coeff_token(w, n, t1, nC);
    int suffix_len = (n > 10 && t1 < 3) ? 1 : 0;
    for (int i = 0; i < n; ++i) {
        int32_t v = levels[pos[n - 1 - i]];
        if (i < t1) { bw_u(w, v > 0 ? 0u : 1u, 1); continue; }
        int64_t code = v > 0 ? 2LL * v - 2 : -2LL * v - 1;
        if (i == t1 && t1 < 3) code -= 2;
        write_level_code(w, code, suffix_len);
        if (suffix_len == 0) suffix_len = 1;
        int64_t a = v < 0 ? -(int64_t)v : v;
        if (a > (3LL << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
    }
    if (n < max_coeff) {
        if (nC == -1) bw_u(w, TZC_VAL[n - 1][total_zeros],
                           TZC_LEN[n - 1][total_zeros]);
        else bw_u(w, TZ_VAL[n - 1][total_zeros],
                  TZ_LEN[n - 1][total_zeros]);
    }
    int zl = total_zeros;
    for (int i = 0; i < n - 1 && zl > 0; ++i) {
        int run = pos[n - 1 - i] - pos[n - 2 - i] - 1;
        int row = (zl < 7 ? zl : 7) - 1;
        bw_u(w, RB_VAL[row][run], RB_LEN[row][run]);
        zl -= run;
    }
    return n;
}

/* -------------------------------------------------------- parse context */

typedef struct {
    int gw, gh, sid;
    int8_t *mb_kind, *qp, *i16_mode, *i4_modes, *chroma_mode;
    uint8_t *cbp_luma, *cbp_chroma;
    int32_t *luma_ac, *luma_dc, *chroma_dc, *chroma_ac;
    int16_t *nnz_luma, *nnz_chroma;
    uint8_t *pcm_luma, *pcm_chroma;
    int32_t *slice_id, *mvd;
    int8_t *ref_idx, *sub_types;
    int8_t *deblock_idc, *alpha_off, *beta_off;
} Ctx;

static inline int nc_luma(Ctx *c, int bgx, int bgy)
{
    int W = 4 * c->gw;
    int aA = bgx > 0 && c->slice_id[(bgy >> 2) * c->gw + ((bgx - 1) >> 2)]
        == c->sid;
    int aB = bgy > 0 && c->slice_id[((bgy - 1) >> 2) * c->gw + (bgx >> 2)]
        == c->sid;
    if (aA && aB)
        return (c->nnz_luma[bgy * W + bgx - 1] +
                c->nnz_luma[(bgy - 1) * W + bgx] + 1) >> 1;
    if (aA) return c->nnz_luma[bgy * W + bgx - 1];
    if (aB) return c->nnz_luma[(bgy - 1) * W + bgx];
    return 0;
}

static inline int nc_chroma(Ctx *c, int cgx, int cgy, int plane)
{
    int W = 2 * c->gw;
    int aA = cgx > 0 && c->slice_id[(cgy >> 1) * c->gw + ((cgx - 1) >> 1)]
        == c->sid;
    int aB = cgy > 0 && c->slice_id[((cgy - 1) >> 1) * c->gw + (cgx >> 1)]
        == c->sid;
    if (aA && aB)
        return (c->nnz_chroma[(cgy * W + cgx - 1) * 2 + plane] +
                c->nnz_chroma[((cgy - 1) * W + cgx) * 2 + plane] + 1) >> 1;
    if (aA) return c->nnz_chroma[(cgy * W + cgx - 1) * 2 + plane];
    if (aB) return c->nnz_chroma[((cgy - 1) * W + cgx) * 2 + plane];
    return 0;
}

static int pred_i4_mode(Ctx *c, int mx, int my, int blk,
                        const int8_t *cur)
{
    int bx = BLKX[blk], by = BLKY[blk];
    int availA, i4A, ma, availB, i4B, mb;
    if (bx > 0) {
        availA = 1; i4A = c->mb_kind[my * c->gw + mx] == 0;
        ma = cur[BLKIDX[by][bx - 1]];
    } else if (mx > 0 && c->slice_id[my * c->gw + mx - 1] == c->sid) {
        availA = 1; i4A = c->mb_kind[my * c->gw + mx - 1] == 0;
        ma = c->i4_modes[(my * c->gw + mx - 1) * 16 + BLKIDX[by][3]];
    } else { availA = 0; i4A = 0; ma = 2; }
    if (by > 0) {
        availB = 1; i4B = c->mb_kind[my * c->gw + mx] == 0;
        mb = cur[BLKIDX[by - 1][bx]];
    } else if (my > 0 && c->slice_id[(my - 1) * c->gw + mx] == c->sid) {
        availB = 1; i4B = c->mb_kind[(my - 1) * c->gw + mx] == 0;
        mb = c->i4_modes[((my - 1) * c->gw + mx) * 16 + BLKIDX[3][bx]];
    } else { availB = 0; i4B = 0; mb = 2; }
    if (!availA || !availB) return 2;
    int pa = i4A ? ma : 2, pb = i4B ? mb : 2;
    return pa < pb ? pa : pb;
}

static void unzigzag16(const int32_t *scan, int32_t *raster)
{
    memset(raster, 0, 16 * sizeof(int32_t));
    for (int i = 0; i < 16; ++i) raster[ZZ[i]] = scan[i];
}

static void unzigzag15(const int32_t *scan15, int32_t *raster)
{
    memset(raster, 0, 16 * sizeof(int32_t));
    for (int i = 0; i < 15; ++i) raster[ZZ[i + 1]] = scan15[i];
}

static int read_luma_residual(Ctx *c, BR *b, int mx, int my, int i16,
                              int cbp_luma)
{
    int W = 4 * c->gw;
    int32_t scan[16];
    if (i16) {
        int nc = nc_luma(c, mx * 4, my * 4);
        if (read_residual_block(b, nc, 16, scan) < 0) return -1;
        unzigzag16(scan, c->luma_dc + (my * c->gw + mx) * 16);
    }
    for (int blk = 0; blk < 16; ++blk) {
        int bx = BLKX[blk], by = BLKY[blk];
        int bgx = mx * 4 + bx, bgy = my * 4 + by;
        if (!(cbp_luma & (1 << (blk >> 2)))) {
            c->nnz_luma[bgy * W + bgx] = 0;
            continue;
        }
        int nc = nc_luma(c, bgx, bgy);
        int tc;
        int32_t *dst = c->luma_ac + ((my * c->gw + mx) * 16 + blk) * 16;
        if (i16) {
            tc = read_residual_block(b, nc, 15, scan);
            if (tc < 0) return -1;
            unzigzag15(scan, dst);
        } else {
            tc = read_residual_block(b, nc, 16, scan);
            if (tc < 0) return -1;
            unzigzag16(scan, dst);
        }
        c->nnz_luma[bgy * W + bgx] = (int16_t)tc;
    }
    return 0;
}

static int read_chroma_residual(Ctx *c, BR *b, int mx, int my,
                                int cbp_chroma)
{
    int W = 2 * c->gw;
    int32_t scan[16];
    if (cbp_chroma == 0) return 0;
    for (int plane = 0; plane < 2; ++plane) {
        if (read_residual_block(b, -1, 4, scan) < 0) return -1;
        int32_t *dst = c->chroma_dc + ((my * c->gw + mx) * 2 + plane) * 4;
        for (int i = 0; i < 4; ++i) dst[i] = scan[i];
    }
    if (cbp_chroma == 2) {
        for (int plane = 0; plane < 2; ++plane)
            for (int blk = 0; blk < 4; ++blk) {
                int bx = blk & 1, by = blk >> 1;
                int cgx = mx * 2 + bx, cgy = my * 2 + by;
                int nc = nc_chroma(c, cgx, cgy, plane);
                int tc = read_residual_block(b, nc, 15, scan);
                if (tc < 0) return -1;
                unzigzag15(scan, c->chroma_ac +
                           (((my * c->gw + mx) * 2 + plane) * 4 + blk)
                           * 16);
                c->nnz_chroma[(cgy * W + cgx) * 2 + plane] = (int16_t)tc;
            }
    } else {
        for (int yy = 0; yy < 2; ++yy)
            for (int xx = 0; xx < 2; ++xx)
                for (int p = 0; p < 2; ++p)
                    c->nnz_chroma[((my * 2 + yy) * W + mx * 2 + xx) * 2
                                  + p] = 0;
    }
    return 0;
}

static int parse_i_mb(Ctx *c, BR *b, int mx, int my, int mb_type_i,
                      int *qp_state)
{
    int idx = my * c->gw + mx;
    c->slice_id[idx] = c->sid;
    int W = 4 * c->gw, Wc = 2 * c->gw;
    if (mb_type_i == 25) {        /* I_PCM */
        c->mb_kind[idx] = 2;
        while (b->pos & 7) br_u1(b);
        uint8_t *py = c->pcm_luma + (int64_t)idx * 256;
        for (int i = 0; i < 256; ++i) py[i] = (uint8_t)br_u(b, 8);
        uint8_t *pc = c->pcm_chroma + (int64_t)idx * 128;
        for (int i = 0; i < 128; ++i) pc[i] = (uint8_t)br_u(b, 8);
        for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
                c->nnz_luma[(my * 4 + yy) * W + mx * 4 + xx] = 16;
        for (int yy = 0; yy < 2; ++yy)
            for (int xx = 0; xx < 2; ++xx)
                for (int p = 0; p < 2; ++p)
                    c->nnz_chroma[((my * 2 + yy) * Wc + mx * 2 + xx) * 2
                                  + p] = 16;
        c->qp[idx] = (int8_t)*qp_state;
        return 0;
    }
    int cbp_luma, cbp_chroma;
    if (mb_type_i == 0) {         /* I_4x4 */
        c->mb_kind[idx] = 0;
        int8_t cur[16];
        for (int i = 0; i < 16; ++i) cur[i] = 2;
        for (int blk = 0; blk < 16; ++blk) {
            int pred = pred_i4_mode(c, mx, my, blk, cur);
            if (br_u1(b)) cur[blk] = (int8_t)pred;
            else {
                int rem = (int)br_u(b, 3);
                cur[blk] = (int8_t)(rem < pred ? rem : rem + 1);
            }
        }
        memcpy(c->i4_modes + idx * 16, cur, 16);
        c->chroma_mode[idx] = (int8_t)br_ue(b);
        uint32_t code = br_ue(b);
        if (code > 47) return -1;
        int cbp = CBP_INTRA[code];
        cbp_luma = cbp & 15;
        cbp_chroma = cbp >> 4;
    } else {                      /* I_16x16 */
        c->mb_kind[idx] = 1;
        int m = mb_type_i - 1;
        c->i16_mode[idx] = (int8_t)(m & 3);
        cbp_chroma = (m >> 2) % 3;
        cbp_luma = m >= 12 ? 15 : 0;
        c->chroma_mode[idx] = (int8_t)br_ue(b);
    }
    c->cbp_luma[idx] = (uint8_t)cbp_luma;
    c->cbp_chroma[idx] = (uint8_t)cbp_chroma;
    int i16 = c->mb_kind[idx] == 1;
    if (cbp_luma || cbp_chroma || i16) {
        int delta = br_se(b);
        *qp_state = (*qp_state + delta + 52) % 52;
    }
    c->qp[idx] = (int8_t)*qp_state;
    if (i16 || cbp_luma) {
        if (read_luma_residual(c, b, mx, my, i16, cbp_luma)) return -1;
    } else {
        for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
                c->nnz_luma[(my * 4 + yy) * W + mx * 4 + xx] = 0;
    }
    return read_chroma_residual(c, b, mx, my, cbp_chroma);
}

static int parse_p_mb(Ctx *c, BR *b, int mx, int my, int mb_type,
                      int *qp_state, int num_ref)
{
    int idx = my * c->gw + mx;
    c->slice_id[idx] = c->sid;
    static const int kinds[5] = {4, 5, 6, 7, 7};
    int kind = kinds[mb_type];
    c->mb_kind[idx] = (int8_t)kind;
    int rr = num_ref - 1;
    int32_t *mvd = c->mvd + (int64_t)idx * 32;   /* (4,4,2) */
    int8_t *refs = c->ref_idx + idx * 4;
    int W = 4 * c->gw;

#define SET_MVD(y0, x0, h, wdt, dx, dy) \
    for (int yy = (y0); yy < (y0) + (h); ++yy) \
        for (int xx = (x0); xx < (x0) + (wdt); ++xx) { \
            mvd[(yy * 4 + xx) * 2] = (dx); \
            mvd[(yy * 4 + xx) * 2 + 1] = (dy); }

    if (kind == 4) {              /* 16x16 */
        int ref = rr > 0 ? br_te(b, rr) : 0;
        refs[0] = refs[1] = refs[2] = refs[3] = (int8_t)ref;
        int dx = br_se(b), dy = br_se(b);
        SET_MVD(0, 0, 4, 4, dx, dy);
    } else if (kind == 5) {       /* 16x8 */
        int r0 = rr > 0 ? br_te(b, rr) : 0;
        int r1 = rr > 0 ? br_te(b, rr) : 0;
        refs[0] = refs[1] = (int8_t)r0;
        refs[2] = refs[3] = (int8_t)r1;
        for (int p = 0; p < 2; ++p) {
            int dx = br_se(b), dy = br_se(b);
            SET_MVD(p * 2, 0, 2, 4, dx, dy);
        }
    } else if (kind == 6) {       /* 8x16 */
        int r0 = rr > 0 ? br_te(b, rr) : 0;
        int r1 = rr > 0 ? br_te(b, rr) : 0;
        refs[0] = refs[2] = (int8_t)r0;
        refs[1] = refs[3] = (int8_t)r1;
        for (int p = 0; p < 2; ++p) {
            int dx = br_se(b), dy = br_se(b);
            SET_MVD(0, p * 2, 4, 2, dx, dy);
        }
    } else {                      /* P_8x8 */
        int subs[4];
        for (int p = 0; p < 4; ++p) {
            subs[p] = (int)br_ue(b);
            if (subs[p] > 3) return -1;
            c->sub_types[idx * 4 + p] = (int8_t)subs[p];
        }
        if (mb_type == 4) {       /* P_8x8ref0 */
            refs[0] = refs[1] = refs[2] = refs[3] = 0;
        } else {
            for (int p = 0; p < 4; ++p)
                refs[p] = (int8_t)(rr > 0 ? br_te(b, rr) : 0);
        }
        for (int part = 0; part < 4; ++part) {
            int py = (part >> 1) * 2, px = (part & 1) * 2;
            int st = subs[part];
            int nsub = st == 0 ? 1 : (st == 3 ? 4 : 2);
            for (int s = 0; s < nsub; ++s) {
                int sy, sx, sh, sw;
                if (st == 1) { sy = py + s; sx = px; sh = 1; sw = 2; }
                else if (st == 2) { sy = py; sx = px + s; sh = 2; sw = 1; }
                else if (st == 3) { sy = py + (s >> 1); sx = px + (s & 1);
                                    sh = 1; sw = 1; }
                else { sy = py; sx = px; sh = 2; sw = 2; }
                int dx = br_se(b), dy = br_se(b);
                SET_MVD(sy, sx, sh, sw, dx, dy);
            }
        }
    }
#undef SET_MVD

    uint32_t code = br_ue(b);
    if (code > 47) return -1;
    int cbp = CBP_INTER[code];
    int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
    c->cbp_luma[idx] = (uint8_t)cbp_luma;
    c->cbp_chroma[idx] = (uint8_t)cbp_chroma;
    if (cbp_luma || cbp_chroma) {
        int delta = br_se(b);
        *qp_state = (*qp_state + delta + 52) % 52;
    }
    c->qp[idx] = (int8_t)*qp_state;
    if (cbp_luma) {
        if (read_luma_residual(c, b, mx, my, 0, cbp_luma)) return -1;
    } else {
        for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
                c->nnz_luma[(my * 4 + yy) * W + mx * 4 + xx] = 0;
    }
    return read_chroma_residual(c, b, mx, my, cbp_chroma);
}

int64_t hl_parse_slice_data(
    const uint8_t *data, int64_t nbytes, int64_t bitpos,
    int32_t gw, int32_t gh, int32_t first_mb, int32_t slice_qp,
    int32_t is_p, int32_t num_ref, int32_t sid,
    int32_t deblock_idc, int32_t alpha_off, int32_t beta_off,
    int8_t *mb_kind, int8_t *qp, int8_t *i16_mode, int8_t *i4_modes,
    int8_t *chroma_mode, uint8_t *cbp_luma, uint8_t *cbp_chroma,
    int32_t *luma_ac, int32_t *luma_dc, int32_t *chroma_dc,
    int32_t *chroma_ac, int16_t *nnz_luma, int16_t *nnz_chroma,
    uint8_t *pcm_luma, uint8_t *pcm_chroma, int32_t *slice_id,
    int32_t *mvd, int8_t *ref_idx, int8_t *sub_types,
    int8_t *deblock_idc_arr, int8_t *alpha_arr, int8_t *beta_arr,
    int64_t *out_bitpos)
{
    hl_slicec_init();
    BR b = { data, nbytes * 8, bitpos, 0 };
    Ctx c = { gw, gh, sid, mb_kind, qp, i16_mode, i4_modes, chroma_mode,
              cbp_luma, cbp_chroma, luma_ac, luma_dc, chroma_dc,
              chroma_ac, nnz_luma, nnz_chroma, pcm_luma, pcm_chroma,
              slice_id, mvd, ref_idx, sub_types,
              deblock_idc_arr, alpha_arr, beta_arr };
    int qp_state = slice_qp;
    int64_t addr = first_mb;
    int64_t n_mbs = (int64_t)gw * gh;
    int64_t parsed = 0;

#define MARK_DEBLOCK(mx, my) do { \
        deblock_idc_arr[(my) * gw + (mx)] = (int8_t)deblock_idc; \
        alpha_arr[(my) * gw + (mx)] = (int8_t)alpha_off; \
        beta_arr[(my) * gw + (mx)] = (int8_t)beta_off; } while (0)

    while (addr < n_mbs) {
        if (!br_more_rbsp(&b)) break;
        int mx = (int)(addr % gw), my = (int)(addr / gw);
        if (is_p) {
            uint32_t run = br_ue(&b);
            for (uint32_t k = 0; k < run; ++k) {
                if (addr >= n_mbs) return -10;
                mx = (int)(addr % gw); my = (int)(addr / gw);
                int idx = my * gw + mx;
                mb_kind[idx] = 3;     /* PSKIP */
                slice_id[idx] = sid;
                qp[idx] = (int8_t)qp_state;
                for (int yy = 0; yy < 4; ++yy)
                    for (int xx = 0; xx < 4; ++xx)
                        nnz_luma[(my * 4 + yy) * 4 * gw + mx * 4 + xx] = 0;
                for (int yy = 0; yy < 2; ++yy)
                    for (int xx = 0; xx < 2; ++xx)
                        for (int p = 0; p < 2; ++p)
                            nnz_chroma[((my * 2 + yy) * 2 * gw
                                        + mx * 2 + xx) * 2 + p] = 0;
                MARK_DEBLOCK(mx, my);
                ++addr; ++parsed;
            }
            if (addr >= n_mbs || !br_more_rbsp(&b)) break;
            mx = (int)(addr % gw); my = (int)(addr / gw);
            uint32_t mb_type = br_ue(&b);
            int rc;
            if (mb_type < 5) rc = parse_p_mb(&c, &b, mx, my, (int)mb_type,
                                             &qp_state, num_ref);
            else rc = parse_i_mb(&c, &b, mx, my, (int)mb_type - 5,
                                 &qp_state);
            if (rc || b.error) return -11;
            MARK_DEBLOCK(mx, my);
        } else {
            uint32_t mb_type = br_ue(&b);
            if (parse_i_mb(&c, &b, mx, my, (int)mb_type, &qp_state) ||
                b.error) return -12;
            MARK_DEBLOCK(mx, my);
        }
        ++addr; ++parsed;
    }
#undef MARK_DEBLOCK
    *out_bitpos = b.pos;
    return parsed;
}

/* --------------------------------------------------------------- packing */

typedef struct {
    int gw, gh, sid;
    const int32_t *use_i16, *i16_mode, *i4_modes, *chroma_mode;
    const int32_t *luma_dc, *luma_ac, *chroma_dc, *chroma_ac;
    const int8_t *ref_idx, *sub_types;
    const int32_t *mvd;
    const int32_t *qp;
    const int8_t *mb_kind;
    int16_t *nnz_luma, *nnz_chroma;   /* scratch, caller-provided zeroed */
    int32_t *slice_of_mb;             /* scratch, caller-provided -1 */
} PCtx;

static inline int pk_nc_luma(PCtx *c, int bgx, int bgy)
{
    int W = 4 * c->gw;
    int aA = bgx > 0 && c->slice_of_mb[(bgy >> 2) * c->gw + ((bgx - 1) >> 2)]
        == c->sid;
    int aB = bgy > 0 && c->slice_of_mb[((bgy - 1) >> 2) * c->gw + (bgx >> 2)]
        == c->sid;
    if (aA && aB)
        return (c->nnz_luma[bgy * W + bgx - 1] +
                c->nnz_luma[(bgy - 1) * W + bgx] + 1) >> 1;
    if (aA) return c->nnz_luma[bgy * W + bgx - 1];
    if (aB) return c->nnz_luma[(bgy - 1) * W + bgx];
    return 0;
}

static inline int pk_nc_chroma(PCtx *c, int cgx, int cgy, int plane)
{
    int W = 2 * c->gw;
    int aA = cgx > 0 &&
        c->slice_of_mb[(cgy >> 1) * c->gw + ((cgx - 1) >> 1)] == c->sid;
    int aB = cgy > 0 &&
        c->slice_of_mb[((cgy - 1) >> 1) * c->gw + (cgx >> 1)] == c->sid;
    if (aA && aB)
        return (c->nnz_chroma[(cgy * W + cgx - 1) * 2 + plane] +
                c->nnz_chroma[((cgy - 1) * W + cgx) * 2 + plane] + 1) >> 1;
    if (aA) return c->nnz_chroma[(cgy * W + cgx - 1) * 2 + plane];
    if (aB) return c->nnz_chroma[((cgy - 1) * W + cgx) * 2 + plane];
    return 0;
}

static int pk_pred_i4_mode(PCtx *c, int mx, int my, int blk)
{
    int bx = BLKX[blk], by = BLKY[blk];
    const int32_t *cur = c->i4_modes + (int64_t)(my * c->gw + mx) * 16;
    int availA, i4A, ma, availB, i4B, mb;
    if (bx > 0) {
        availA = 1; i4A = 1;
        ma = (int)cur[BLKIDX[by][bx - 1]];
    } else if (mx > 0 && c->slice_of_mb[my * c->gw + mx - 1] == c->sid) {
        availA = 1; i4A = c->mb_kind[my * c->gw + mx - 1] == 0;
        ma = (int)c->i4_modes[(int64_t)(my * c->gw + mx - 1) * 16
                              + BLKIDX[by][3]];
    } else { availA = 0; i4A = 0; ma = 2; }
    if (by > 0) {
        availB = 1; i4B = 1;
        mb = (int)cur[BLKIDX[by - 1][bx]];
    } else if (my > 0 && c->slice_of_mb[(my - 1) * c->gw + mx] == c->sid) {
        availB = 1; i4B = c->mb_kind[(my - 1) * c->gw + mx] == 0;
        mb = (int)c->i4_modes[(int64_t)((my - 1) * c->gw + mx) * 16
                              + BLKIDX[3][bx]];
    } else { availB = 0; i4B = 0; mb = 2; }
    if (!availA || !availB) return 2;
    int pa = i4A ? ma : 2, pb = i4B ? mb : 2;
    return pa < pb ? pa : pb;
}

static void pk_derive_cbp(PCtx *c, int mx, int my, int i16,
                          int *cbp_luma, int *cbp_chroma)
{
    const int32_t *ac = c->luma_ac + (int64_t)(my * c->gw + mx) * 256;
    int cl = 0;
    for (int g = 0; g < 4; ++g) {
        int any = 0;
        for (int k = 0; k < 4 && !any; ++k)
            for (int i = 0; i < 16; ++i)
                if (ac[(g * 4 + k) * 16 + i]) { any = 1; break; }
        if (any) cl |= 1 << g;
    }
    if (i16) cl = cl ? 15 : 0;
    const int32_t *cdc = c->chroma_dc + (int64_t)(my * c->gw + mx) * 8;
    const int32_t *cac = c->chroma_ac + (int64_t)(my * c->gw + mx) * 128;
    int any_ac = 0, any_dc = 0;
    for (int i = 0; i < 128 && !any_ac; ++i) if (cac[i]) any_ac = 1;
    for (int i = 0; i < 8 && !any_dc; ++i) if (cdc[i]) any_dc = 1;
    *cbp_luma = cl;
    *cbp_chroma = any_ac ? 2 : (any_dc ? 1 : 0);
}

static void pk_write_luma(PCtx *c, BW *w, int mx, int my, int i16,
                          int cbp_luma)
{
    int W = 4 * c->gw;
    int32_t scan[16];
    const int32_t *acbase = c->luma_ac + (int64_t)(my * c->gw + mx) * 256;
    if (i16) {
        int nc = pk_nc_luma(c, mx * 4, my * 4);
        const int32_t *dc = c->luma_dc + (int64_t)(my * c->gw + mx) * 16;
        for (int i = 0; i < 16; ++i) scan[i] = dc[ZZ[i]];
        write_residual_block(w, scan, nc, 16);
    }
    for (int blk = 0; blk < 16; ++blk) {
        int bx = BLKX[blk], by = BLKY[blk];
        int bgx = mx * 4 + bx, bgy = my * 4 + by;
        if (!(cbp_luma & (1 << (blk >> 2)))) {
            c->nnz_luma[bgy * W + bgx] = 0;
            continue;
        }
        int nc = pk_nc_luma(c, bgx, bgy);
        const int32_t *coefs = acbase + blk * 16;
        int tc;
        if (i16) {
            for (int i = 0; i < 15; ++i) scan[i] = coefs[ZZ[i + 1]];
            tc = write_residual_block(w, scan, nc, 15);
        } else {
            for (int i = 0; i < 16; ++i) scan[i] = coefs[ZZ[i]];
            tc = write_residual_block(w, scan, nc, 16);
        }
        c->nnz_luma[bgy * W + bgx] = (int16_t)tc;
    }
}

static void pk_write_chroma(PCtx *c, BW *w, int mx, int my, int cbp_chroma)
{
    int W = 2 * c->gw;
    int32_t scan[16];
    if (cbp_chroma == 0) {
        for (int yy = 0; yy < 2; ++yy)
            for (int xx = 0; xx < 2; ++xx)
                for (int p = 0; p < 2; ++p)
                    c->nnz_chroma[((my * 2 + yy) * W + mx * 2 + xx) * 2
                                  + p] = 0;
        return;
    }
    for (int plane = 0; plane < 2; ++plane) {
        const int32_t *dc = c->chroma_dc +
            (int64_t)((my * c->gw + mx) * 2 + plane) * 4;
        write_residual_block(w, dc, -1, 4);
    }
    if (cbp_chroma == 2) {
        for (int plane = 0; plane < 2; ++plane)
            for (int blk = 0; blk < 4; ++blk) {
                int bx = blk & 1, by = blk >> 1;
                int cgx = mx * 2 + bx, cgy = my * 2 + by;
                int nc = pk_nc_chroma(c, cgx, cgy, plane);
                const int32_t *coefs = c->chroma_ac +
                    (int64_t)(((my * c->gw + mx) * 2 + plane) * 4 + blk)
                    * 16;
                for (int i = 0; i < 15; ++i) scan[i] = coefs[ZZ[i + 1]];
                int tc = write_residual_block(w, scan, nc, 15);
                c->nnz_chroma[(cgy * W + cgx) * 2 + plane] = (int16_t)tc;
            }
    } else {
        for (int yy = 0; yy < 2; ++yy)
            for (int xx = 0; xx < 2; ++xx)
                for (int p = 0; p < 2; ++p)
                    c->nnz_chroma[((my * 2 + yy) * W + mx * 2 + xx) * 2
                                  + p] = 0;
    }
}

static void pk_write_i_mb(PCtx *c, BW *w, int mx, int my, int *qp_state,
                          int slice_is_p)
{
    int idx = my * c->gw + mx;
    c->slice_of_mb[idx] = c->sid;
    int i16 = c->use_i16[idx] != 0;
    int cbp_luma, cbp_chroma;
    pk_derive_cbp(c, mx, my, i16, &cbp_luma, &cbp_chroma);
    int mb_type;
    if (i16) {
        int m = (int)c->i16_mode[idx] + cbp_chroma * 4 +
            (cbp_luma ? 12 : 0);
        mb_type = 1 + m;
    } else mb_type = 0;
    bw_ue(w, (uint32_t)(mb_type + (slice_is_p ? 5 : 0)));
    if (!i16) {
        for (int blk = 0; blk < 16; ++blk) {
            int pred = pk_pred_i4_mode(c, mx, my, blk);
            int mode = (int)c->i4_modes[(int64_t)idx * 16 + blk];
            if (mode == pred) bw_u(w, 1, 1);
            else {
                bw_u(w, 0, 1);
                bw_u(w, (uint32_t)(mode < pred ? mode : mode - 1), 3);
            }
        }
        bw_ue(w, (uint32_t)c->chroma_mode[idx]);
        bw_ue(w, CBP_INTRA_INV[cbp_luma | (cbp_chroma << 4)]);
    } else {
        bw_ue(w, (uint32_t)c->chroma_mode[idx]);
    }
    if (cbp_luma || cbp_chroma || i16) {
        bw_se(w, (int32_t)c->qp[idx] - *qp_state);
        *qp_state = (int)c->qp[idx];
    }
    if (i16 || cbp_luma) pk_write_luma(c, w, mx, my, i16, cbp_luma);
    else {
        int W = 4 * c->gw;
        for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
                c->nnz_luma[(my * 4 + yy) * W + mx * 4 + xx] = 0;
    }
    pk_write_chroma(c, w, mx, my, cbp_chroma);
}

static void pk_write_p_mb(PCtx *c, BW *w, int mx, int my, int *qp_state,
                          int num_ref)
{
    int idx = my * c->gw + mx;
    c->slice_of_mb[idx] = c->sid;
    int kind = c->mb_kind[idx];
    static const int types[8] = {0, 0, 0, 0, 0, 1, 2, 3};
    bw_ue(w, (uint32_t)types[kind]);
    const int8_t *refs = c->ref_idx + idx * 4;
    const int32_t *d = c->mvd + (int64_t)idx * 32;
    int rr = num_ref - 1;

#define WREF(s) do { if (rr > 0) bw_te(w, refs[s], rr); } while (0)
#define WMVD(iy, ix) do { bw_se(w, d[((iy) * 4 + (ix)) * 2]); \
        bw_se(w, d[((iy) * 4 + (ix)) * 2 + 1]); } while (0)

    if (kind == 4) { WREF(0); WMVD(0, 0); }
    else if (kind == 5) { WREF(0); WREF(2); WMVD(0, 0); WMVD(2, 0); }
    else if (kind == 6) { WREF(0); WREF(1); WMVD(0, 0); WMVD(0, 2); }
    else {
        const int8_t *subs = c->sub_types + idx * 4;
        for (int p = 0; p < 4; ++p) bw_ue(w, (uint32_t)subs[p]);
        for (int p = 0; p < 4; ++p) WREF(p);
        for (int part = 0; part < 4; ++part) {
            int py = (part >> 1) * 2, px = (part & 1) * 2;
            int st = subs[part];
            if (st == 0) WMVD(py, px);
            else if (st == 1) { WMVD(py, px); WMVD(py + 1, px); }
            else if (st == 2) { WMVD(py, px); WMVD(py, px + 1); }
            else { WMVD(py, px); WMVD(py, px + 1);
                   WMVD(py + 1, px); WMVD(py + 1, px + 1); }
        }
    }
#undef WREF
#undef WMVD

    int cbp_luma, cbp_chroma;
    pk_derive_cbp(c, mx, my, 0, &cbp_luma, &cbp_chroma);
    bw_ue(w, CBP_INTER_INV[cbp_luma | (cbp_chroma << 4)]);
    if (cbp_luma || cbp_chroma) {
        bw_se(w, (int32_t)c->qp[idx] - *qp_state);
        *qp_state = (int)c->qp[idx];
    }
    if (cbp_luma) pk_write_luma(c, w, mx, my, 0, cbp_luma);
    else {
        int W = 4 * c->gw;
        for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
                c->nnz_luma[(my * 4 + yy) * W + mx * 4 + xx] = 0;
    }
    pk_write_chroma(c, w, mx, my, cbp_chroma);
}

/* Pack slice_data for a contiguous MB range [first_mb, first_mb+mb_count)
 * (a full frame when first_mb=0, mb_count=gw*gh — the reference's
 * per-slice contiguous MB ranges, hl_codec_264_encode.c:479-524).  buf
 * already holds the slice header bits (bitpos = current position).
 * Returns final bit position or <0. */
int64_t hl_pack_slice_data(
    uint8_t *buf, int64_t bufcap, int64_t bitpos,
    int32_t gw, int32_t gh, int32_t first_mb, int32_t mb_count,
    int32_t slice_qp, int32_t is_p,
    int32_t num_ref, int32_t sid,
    const int32_t *use_i16, const int32_t *i16_mode,
    const int32_t *i4_modes, const int32_t *chroma_mode,
    const int32_t *luma_dc, const int32_t *luma_ac,
    const int32_t *chroma_dc, const int32_t *chroma_ac,
    const int8_t *ref_idx, const int8_t *sub_types, const int32_t *mvd,
    const int32_t *qp, const int8_t *mb_kind, const uint8_t *skip_ok,
    int16_t *nnz_luma_scratch, int16_t *nnz_chroma_scratch,
    int32_t *slice_of_mb_scratch)
{
    hl_slicec_init();
    BW w = { buf, bufcap, bitpos, 0 };
    PCtx c = { gw, gh, sid, use_i16, i16_mode, i4_modes, chroma_mode,
               luma_dc, luma_ac, chroma_dc, chroma_ac, ref_idx, sub_types,
               mvd, qp, mb_kind, nnz_luma_scratch, nnz_chroma_scratch,
               slice_of_mb_scratch };
    int qp_state = slice_qp;
    int64_t run = 0;
    for (int addr = first_mb; addr < first_mb + mb_count; ++addr) {
        {
            int my = addr / gw, mx = addr % gw;
            int idx = addr;
            if (is_p) {
                if (skip_ok && skip_ok[idx]) {
                    c.slice_of_mb[idx] = sid;
                    int W4 = 4 * gw, W2 = 2 * gw;
                    for (int yy = 0; yy < 4; ++yy)
                        for (int xx = 0; xx < 4; ++xx)
                            c.nnz_luma[(my * 4 + yy) * W4 + mx * 4 + xx]
                                = 0;
                    for (int yy = 0; yy < 2; ++yy)
                        for (int xx = 0; xx < 2; ++xx)
                            for (int p = 0; p < 2; ++p)
                                c.nnz_chroma[((my * 2 + yy) * W2
                                              + mx * 2 + xx) * 2 + p] = 0;
                    ++run;
                    continue;
                }
                bw_ue(&w, (uint32_t)run);
                run = 0;
                if (mb_kind[idx] <= 2)
                    pk_write_i_mb(&c, &w, mx, my, &qp_state, 1);
                else
                    pk_write_p_mb(&c, &w, mx, my, &qp_state, num_ref);
            } else {
                pk_write_i_mb(&c, &w, mx, my, &qp_state, 0);
            }
            if (w.error) return -1;
        }
    }
    if (is_p && run > 0) bw_ue(&w, (uint32_t)run);
    /* rbsp trailing bits */
    bw_u(&w, 1, 1);
    while (w.pos & 7) bw_u(&w, 0, 1);
    return w.error ? -1 : w.pos;
}

/* ================================================================== */
/* 8.4.1 MV prediction + derivation (native mirror of decode/mv.py,
 * reference hl_codec_264_utils.c:620-965: median MV prediction, P-Skip
 * rule, partition/sub-partition geometry).  Two passes share one core:
 * hl_derive_mvs (decoder: mvd -> mv) and hl_compute_mvds_and_skip
 * (encoder: mv -> mvd + skip eligibility). */

#include <stdlib.h>

enum { SH_16X16 = 0, SH_16X8_TOP, SH_16X8_BOT, SH_8X16_L, SH_8X16_R };

typedef struct {
    int gw, gh;
    int32_t *mv_g;           /* (4gh,4gw,2) */
    int32_t *ref_g;          /* (4gh,4gw) */
    uint8_t *done;           /* (4gh,4gw) */
    const int32_t *mb_slice; /* (gh,gw) */
} MP;

static inline int med3(int a, int b, int c)
{
    int mx = a > b ? a : b, mn = a < b ? a : b;
    return mx < c ? mx : (mn > c ? mn : c);
}

static int mp_neighbor(const MP *m, int bx, int by, int mbx, int mby,
                       int *mvx, int *mvy, int *ref)
{
    if (bx < 0 || by < 0 || bx >= 4 * m->gw || by >= 4 * m->gh)
        return 0;
    if (m->mb_slice[(by >> 2) * m->gw + (bx >> 2)] !=
        m->mb_slice[mby * m->gw + mbx])
        return 0;
    if (!m->done[by * 4 * m->gw + bx])
        return 0;
    *mvx = m->mv_g[(by * 4 * m->gw + bx) * 2];
    *mvy = m->mv_g[(by * 4 * m->gw + bx) * 2 + 1];
    *ref = m->ref_g[by * 4 * m->gw + bx];
    return 1;
}

static void mp_predict(const MP *m, int gx4, int gy4, int w4, int h4,
                       int ref, int mbx, int mby, int shape,
                       int *px, int *py)
{
    int ax = 0, ay = 0, ar = -1, bx = 0, by = 0, br = -1;
    int cx = 0, cy = 0, cr = -1;
    int aA = mp_neighbor(m, gx4 - 1, gy4, mbx, mby, &ax, &ay, &ar);
    int aB = mp_neighbor(m, gx4, gy4 - 1, mbx, mby, &bx, &by, &br);
    int aC = mp_neighbor(m, gx4 + w4, gy4 - 1, mbx, mby, &cx, &cy, &cr);
    (void)h4;
    if (!aC)
        aC = mp_neighbor(m, gx4 - 1, gy4 - 1, mbx, mby, &cx, &cy, &cr);
    if (shape == SH_16X8_TOP && aB && br == ref) { *px = bx; *py = by; return; }
    if (shape == SH_16X8_BOT && aA && ar == ref) { *px = ax; *py = ay; return; }
    if (shape == SH_8X16_L && aA && ar == ref) { *px = ax; *py = ay; return; }
    if (shape == SH_8X16_R && aC && cr == ref) { *px = cx; *py = cy; return; }
    {
        int mA = aA && ar == ref, mB = aB && br == ref, mC = aC && cr == ref;
        if (mA && !mB && !mC) { *px = ax; *py = ay; return; }
        if (!mA && mB && !mC) { *px = bx; *py = by; return; }
        if (!mA && !mB && mC) { *px = cx; *py = cy; return; }
    }
    if (aA && !aB && !aC) { *px = ax; *py = ay; return; }
    {
        int mAx = aA ? ax : 0, mAy = aA ? ay : 0;
        int mBx = aB ? bx : 0, mBy = aB ? by : 0;
        int mCx = aC ? cx : 0, mCy = aC ? cy : 0;
        *px = med3(mAx, mBx, mCx);
        *py = med3(mAy, mBy, mCy);
    }
}

static void mp_pskip(const MP *m, int mbx, int mby, int *px, int *py)
{
    int x4 = mbx * 4, y4 = mby * 4;
    int ax, ay, ar, bx, by, br;
    int aA = mp_neighbor(m, x4 - 1, y4, mbx, mby, &ax, &ay, &ar);
    int aB = mp_neighbor(m, x4, y4 - 1, mbx, mby, &bx, &by, &br);
    if (!aA || !aB ||
        (aA && ar == 0 && ax == 0 && ay == 0) ||
        (aB && br == 0 && bx == 0 && by == 0)) {
        *px = 0; *py = 0;
        return;
    }
    mp_predict(m, x4, y4, 4, 4, 0, mbx, mby, SH_16X16, px, py);
}

static void mp_assign(MP *m, int gx4, int gy4, int w4, int h4,
                      int mvx, int mvy, int ref)
{
    int W = 4 * m->gw;
    for (int y = gy4; y < gy4 + h4; ++y)
        for (int x = gx4; x < gx4 + w4; ++x) {
            m->mv_g[(y * W + x) * 2] = mvx;
            m->mv_g[(y * W + x) * 2 + 1] = mvy;
            m->ref_g[y * W + x] = ref;
            m->done[y * W + x] = 1;
        }
}

/* sub_mb geometry: fills (ox,oy,w4,h4) quadruples, returns count */
static int sub_geom(int st, int g[4][4])
{
    if (st == 0) { g[0][0]=0;g[0][1]=0;g[0][2]=2;g[0][3]=2; return 1; }
    if (st == 1) { g[0][0]=0;g[0][1]=0;g[0][2]=2;g[0][3]=1;
                   g[1][0]=0;g[1][1]=1;g[1][2]=2;g[1][3]=1; return 2; }
    if (st == 2) { g[0][0]=0;g[0][1]=0;g[0][2]=1;g[0][3]=2;
                   g[1][0]=1;g[1][1]=0;g[1][2]=1;g[1][3]=2; return 2; }
    g[0][0]=0;g[0][1]=0;g[0][2]=1;g[0][3]=1;
    g[1][0]=1;g[1][1]=0;g[1][2]=1;g[1][3]=1;
    g[2][0]=0;g[2][1]=1;g[2][2]=1;g[2][3]=1;
    g[3][0]=1;g[3][1]=1;g[3][2]=1;g[3][3]=1;
    return 4;
}

/* partition geometry per kind (4=16x16, 5=16x8, 6=8x16):
 * (shape, ref_slot, ox, oy, w4, h4, mvd_iy, mvd_ix) */
static int part_geom(int kind, int g[2][8])
{
    if (kind == 4) {
        int t[8] = {SH_16X16, 0, 0, 0, 4, 4, 0, 0};
        memcpy(g[0], t, sizeof t); return 1;
    }
    if (kind == 5) {
        int t0[8] = {SH_16X8_TOP, 0, 0, 0, 4, 2, 0, 0};
        int t1[8] = {SH_16X8_BOT, 2, 0, 2, 4, 2, 2, 0};
        memcpy(g[0], t0, sizeof t0); memcpy(g[1], t1, sizeof t1); return 2;
    }
    {
        int t0[8] = {SH_8X16_L, 0, 0, 0, 2, 4, 0, 0};
        int t1[8] = {SH_8X16_R, 1, 2, 0, 2, 4, 0, 2};
        memcpy(g[0], t0, sizeof t0); memcpy(g[1], t1, sizeof t1); return 2;
    }
}

static MP *mp_create(int gw, int gh, const int32_t *mb_slice)
{
    MP *m = (MP *)malloc(sizeof(MP));
    int n = 16 * gw * gh;
    m->gw = gw; m->gh = gh;
    m->mv_g = (int32_t *)calloc((size_t)n * 2, 4);
    m->ref_g = (int32_t *)malloc((size_t)n * 4);
    for (int i = 0; i < n; ++i) m->ref_g[i] = -1;
    m->done = (uint8_t *)calloc((size_t)n, 1);
    m->mb_slice = mb_slice;
    return m;
}

static void mp_free(MP *m)
{
    free(m->mv_g); free(m->ref_g); free(m->done); free(m);
}

/* Decoder pass: mvd -> final MV field.  mv_out (gh,gw,4,4,2). */
int64_t hl_derive_mvs(int32_t gw, int32_t gh, const int8_t *mb_kind,
                      const int32_t *mvd, const int8_t *ref_idx,
                      const int8_t *sub_types, const int32_t *slice_id,
                      int32_t *mv_out)
{
    MP *m = mp_create(gw, gh, slice_id);
    int W = 4 * gw;
    for (int mby = 0; mby < gh; ++mby)
        for (int mbx = 0; mbx < gw; ++mbx) {
            int kind = mb_kind[mby * gw + mbx];
            int x4 = mbx * 4, y4 = mby * 4;
            int64_t mb = (int64_t)mby * gw + mbx;
            if (kind < 3) { mp_assign(m, x4, y4, 4, 4, 0, 0, -1); continue; }
            if (kind == 3) {                    /* P_Skip */
                int mx_, my_;
                mp_pskip(m, mbx, mby, &mx_, &my_);
                mp_assign(m, x4, y4, 4, 4, mx_, my_, 0);
                continue;
            }
            if (kind >= 4 && kind <= 6) {
                int g[2][8];
                int np = part_geom(kind, g);
                for (int p = 0; p < np; ++p) {
                    int shape = g[p][0], slot = g[p][1];
                    int ox = g[p][2], oy = g[p][3];
                    int w4 = g[p][4], h4 = g[p][5];
                    int iy = g[p][6], ix = g[p][7];
                    int ref = ref_idx[mb * 4 + slot];
                    int px, py;
                    mp_predict(m, x4 + ox, y4 + oy, w4, h4, ref, mbx, mby,
                               shape, &px, &py);
                    int dx = mvd[((mb * 4 + iy) * 4 + ix) * 2];
                    int dy = mvd[((mb * 4 + iy) * 4 + ix) * 2 + 1];
                    mp_assign(m, x4 + ox, y4 + oy, w4, h4, px + dx,
                              py + dy, ref);
                }
            } else {                            /* P_8x8 */
                for (int part = 0; part < 4; ++part) {
                    int py0 = (part >> 1) * 2, px0 = (part & 1) * 2;
                    int ref = ref_idx[mb * 4 + part];
                    int st = sub_types[mb * 4 + part];
                    int sg[4][4];
                    int ns = sub_geom(st, sg);
                    for (int s = 0; s < ns; ++s) {
                        int ox = sg[s][0], oy = sg[s][1];
                        int w4 = sg[s][2], h4 = sg[s][3];
                        int gx = x4 + px0 + ox, gy = y4 + py0 + oy;
                        int px, py;
                        mp_predict(m, gx, gy, w4, h4, ref, mbx, mby,
                                   SH_16X16, &px, &py);
                        int dx = mvd[((mb * 4 + py0 + oy) * 4
                                      + px0 + ox) * 2];
                        int dy = mvd[((mb * 4 + py0 + oy) * 4
                                      + px0 + ox) * 2 + 1];
                        mp_assign(m, gx, gy, w4, h4, px + dx, py + dy,
                                  ref);
                    }
                }
            }
        }
    /* mv_g (4gh,4gw,2) -> (gh,gw,4,4,2) */
    for (int mby = 0; mby < gh; ++mby)
        for (int mbx = 0; mbx < gw; ++mbx)
            for (int by = 0; by < 4; ++by)
                for (int bx = 0; bx < 4; ++bx) {
                    int64_t src = ((int64_t)(mby * 4 + by) * W
                                   + mbx * 4 + bx) * 2;
                    int64_t dst = ((((int64_t)mby * gw + mbx) * 4 + by)
                                   * 4 + bx) * 2;
                    mv_out[dst] = m->mv_g[src];
                    mv_out[dst + 1] = m->mv_g[src + 1];
                }
    mp_free(m);
    return 0;
}

/* Encoder pass: final MVs -> mvd + P-Skip eligibility. */
int64_t hl_compute_mvds_and_skip(
    int32_t gw, int32_t gh, const int8_t *mb_kind, const int32_t *mv,
    const int8_t *ref_idx, const int8_t *sub_types, const uint8_t *coded,
    const int32_t *slice_id, int32_t *mvd_out, uint8_t *skip_out)
{
    MP *m = mp_create(gw, gh, slice_id);
    for (int mby = 0; mby < gh; ++mby)
        for (int mbx = 0; mbx < gw; ++mbx) {
            int kind = mb_kind[mby * gw + mbx];
            int x4 = mbx * 4, y4 = mby * 4;
            int64_t mb = (int64_t)mby * gw + mbx;
            const int32_t *mv_mb = mv + mb * 32;
            if (kind < 3) { mp_assign(m, x4, y4, 4, 4, 0, 0, -1); continue; }
            if (kind == 4) {                    /* 16x16 */
                int mx_ = mv_mb[0], my_ = mv_mb[1];
                int ref = ref_idx[mb * 4];
                if (ref == 0 && !coded[mb]) {
                    int sx, sy;
                    mp_pskip(m, mbx, mby, &sx, &sy);
                    if (sx == mx_ && sy == my_)
                        skip_out[mb] = 1;
                }
                {
                    int px, py;
                    mp_predict(m, x4, y4, 4, 4, ref, mbx, mby, SH_16X16,
                               &px, &py);
                    for (int i = 0; i < 16; ++i) {
                        mvd_out[(mb * 16 + i) * 2] = mx_ - px;
                        mvd_out[(mb * 16 + i) * 2 + 1] = my_ - py;
                    }
                }
                mp_assign(m, x4, y4, 4, 4, mx_, my_, ref);
            } else if (kind == 5 || kind == 6) {
                int g[2][8];
                int np = part_geom(kind, g);
                for (int p = 0; p < np; ++p) {
                    int shape = g[p][0], slot = g[p][1];
                    int ox = g[p][2], oy = g[p][3];
                    int w4 = g[p][4], h4 = g[p][5];
                    int iy = g[p][6], ix = g[p][7];
                    int ref = ref_idx[mb * 4 + slot];
                    int mx_ = mv_mb[(iy * 4 + ix) * 2];
                    int my_ = mv_mb[(iy * 4 + ix) * 2 + 1];
                    int px, py;
                    mp_predict(m, x4 + ox, y4 + oy, w4, h4, ref, mbx, mby,
                               shape, &px, &py);
                    mvd_out[((mb * 4 + iy) * 4 + ix) * 2] = mx_ - px;
                    mvd_out[((mb * 4 + iy) * 4 + ix) * 2 + 1] = my_ - py;
                    mp_assign(m, x4 + ox, y4 + oy, w4, h4, mx_, my_, ref);
                }
            } else {                            /* P_8x8 */
                for (int part = 0; part < 4; ++part) {
                    int py0 = (part >> 1) * 2, px0 = (part & 1) * 2;
                    int ref = ref_idx[mb * 4 + part];
                    int st = sub_types[mb * 4 + part];
                    int sg[4][4];
                    int ns = sub_geom(st, sg);
                    for (int s = 0; s < ns; ++s) {
                        int ox = sg[s][0], oy = sg[s][1];
                        int w4 = sg[s][2], h4 = sg[s][3];
                        int gx = x4 + px0 + ox, gy = y4 + py0 + oy;
                        int mx_ = mv_mb[((py0 + oy) * 4 + px0 + ox) * 2];
                        int my_ = mv_mb[((py0 + oy) * 4 + px0 + ox) * 2
                                        + 1];
                        int px, py;
                        mp_predict(m, gx, gy, w4, h4, ref, mbx, mby,
                                   SH_16X16, &px, &py);
                        mvd_out[((mb * 4 + py0 + oy) * 4 + px0 + ox) * 2]
                            = mx_ - px;
                        mvd_out[((mb * 4 + py0 + oy) * 4 + px0 + ox) * 2
                                + 1] = my_ - py;
                        mp_assign(m, gx, gy, w4, h4, mx_, my_, ref);
                    }
                }
            }
        }
    mp_free(m);
    return 0;
}
