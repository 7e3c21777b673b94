/* JPEG entropy decoding (T.81 Huffman, libjpeg-turbo's jdhuff.c and
   jdphuff.c), the counterpart of data/jpeg.py's plain _decode_segment and
   _decode_progressive_scan.

   tdt_jpeg_scan decodes one scan: its restart segments (unstuffed, one after
   another in `data`, segment s at data[seg_start[s]:seg_start[s + 1]]) into
   the zigzag-ordered int64 coefficient blocks of the frame. A segment is
   read MSB first with zeros past its end, and fails when its MCUs take more
   bits than it holds. Each segment starts with DC predictions of 0 (one a
   component) and no EOB run. Huffman codes are looked up in the plain
   version's table of every 16-bit window (length << 8 | symbol; length 0:
   no code starts the window), with a 9-bit table in front of it.

   geom (int64), as data/jpeg.py::_scan_geometry writes it:
     [0] MCUs in the scan, [1] MCUs a segment, [2] members (0-4),
     [3] MCUs a row (a one-component scan: that component's blocks a row),
     [4] progressive, [5] Ss, [6] Se, [7] Ah, [8] Al,
     then for each member: component (0-3), offset of the component's first
     coefficient in `coef`, its blocks a row in `coef`, h, v (1 for a
     one-component scan), DC table, AC table (indices into `luts`, -1: none). */
#include <stdlib.h>
#include <string.h>

#include "decode.h"

#define GEOM_HEAD 9
#define GEOM_MEMBER 7
#define MAX_LUTS 8

typedef struct {
    const uint8_t *p;
    int64_t nbytes, nbits, pos;
} bits_t;

typedef struct {
    const uint16_t *lut;
    uint16_t fast[512];
} huff_t;

typedef struct {
    int64_t comp, base, cols, h, v;
    const huff_t *dc, *ac;
} member_t;

/* The 16 bits from bit `pos` on, zeros past the end. */
static inline uint32_t peek16(const bits_t *b) {
    int64_t i = b->pos >> 3;
    uint32_t w;
    if (i + 2 < b->nbytes) {
        w = (uint32_t)b->p[i] << 16 | (uint32_t)b->p[i + 1] << 8 | b->p[i + 2];
    } else {
        w = 0;
        for (int k = 0; k < 3; k++) w = w << 8 | (i + k < b->nbytes ? b->p[i + k] : 0);
    }
    return (w >> (8 - (b->pos & 7))) & 0xFFFF;
}

static inline int64_t get_bits(bits_t *b, int n) {
    if (n == 0) return 0;
    int64_t v = peek16(b) >> (16 - n);
    b->pos += n;
    return v;
}

static inline int64_t extend(int64_t v, int s) {
    return s == 0 ? 0 : v < ((int64_t)1 << (s - 1)) ? v - ((int64_t)1 << s) + 1 : v;
}

static void huff_init(huff_t *h, const uint16_t *lut) {
    h->lut = lut;
    for (int i = 0; i < 512; i++) {
        uint16_t e = lut[i << 7];
        int len = e >> 8;
        h->fast[i] = len >= 1 && len <= 9 ? e : 0xFFFF;
    }
}

/* The next symbol, or -1 where no code starts. */
static inline int huff_decode(bits_t *b, const huff_t *h) {
    uint32_t w = peek16(b);
    uint16_t e = h->fast[w >> 7];
    if (e == 0xFFFF) e = h->lut[w];
    if (!(e >> 8)) return -1;
    b->pos += e >> 8;
    return e & 255;
}

/* One block of a sequential scan. */
static int block_sequential(bits_t *b, const member_t *m, int64_t *pred, int64_t *c) {
    int s = huff_decode(b, m->dc);
    if (s < 0 || s > 15) return TDT_ERR_CODE;
    pred[m->comp] += extend(get_bits(b, s), s);
    c[0] = pred[m->comp];
    for (int k = 1; k < 64; k++) {
        int rs = huff_decode(b, m->ac);
        if (rs < 0) return TDT_ERR_CODE;
        if (rs == 0) break;
        k += rs >> 4;
        int size = rs & 15;
        if (size) {
            if (k > 63) return TDT_ERR_RANGE;
            c[k] = extend(get_bits(b, size), size);
        }
    }
    return TDT_OK;
}

/* Corrections for the nonzero coefficients of c[k..se] while `r` zeros
   are skipped (r < 0: to se); returns the k it stops at. */
static inline int refine_until(bits_t *b, int64_t *c, int k, int se, int *r, int64_t p1,
                               int64_t m1) {
    for (; k <= se; k++) {
        int64_t v = c[k];
        if (v) {
            if (get_bits(b, 1) && !(v & p1)) c[k] = v + (v >= 0 ? p1 : m1);
        } else if (*r >= 0 && --*r < 0) {
            break;
        }
    }
    return k;
}

/* One block of a progressive scan. */
static int block_progressive(bits_t *b, const member_t *m, int ss, int se, int ah, int al,
                             int64_t *pred, int64_t *eobrun, int64_t *c) {
    int64_t p1 = (int64_t)1 << al, m1 = -p1;
    if (ss == 0 && ah == 0) { /* DC first */
        int s = huff_decode(b, m->dc);
        if (s < 0 || s > 15) return TDT_ERR_CODE;
        pred[m->comp] += extend(get_bits(b, s), s);
        c[0] = pred[m->comp] * p1;
        return TDT_OK;
    }
    if (ss == 0) { /* DC refinement */
        if (get_bits(b, 1)) c[0] |= p1;
        return TDT_OK;
    }
    if (ah == 0) { /* AC first */
        if (*eobrun) {
            --*eobrun;
            return TDT_OK;
        }
        for (int k = ss; k <= se;) {
            int rs = huff_decode(b, m->ac);
            if (rs < 0) return TDT_ERR_CODE;
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                int64_t v = extend(get_bits(b, s), s);
                if (k > 63) return TDT_ERR_RANGE;
                c[k++] = v * p1;
            } else if (r == 15) {
                k += 16;
            } else {
                *eobrun = ((int64_t)1 << r) + get_bits(b, r) - 1;
                break;
            }
        }
        return TDT_OK;
    }
    /* AC refinement */
    int k = ss;
    if (!*eobrun) {
        while (k <= se) {
            int rs = huff_decode(b, m->ac);
            if (rs < 0) return TDT_ERR_CODE;
            int r = rs >> 4, s = rs & 15;
            int64_t v = 0;
            if (s) {
                v = get_bits(b, 1) ? p1 : m1;
            } else if (r != 15) {
                *eobrun = ((int64_t)1 << r) + get_bits(b, r);
                break;
            }
            k = refine_until(b, c, k, se, &r, p1, m1);
            if (v) {
                if (k > 63) return TDT_ERR_RANGE;
                c[k] = v;
            }
            k++;
        }
    }
    if (*eobrun) {
        int none = -1;
        refine_until(b, c, k, se, &none, p1, m1);
        --*eobrun;
    }
    return TDT_OK;
}

int tdt_jpeg_scan(const uint8_t *data, const int64_t *seg_start, int64_t n_segs,
                  const uint16_t *luts, int64_t n_luts, const int64_t *geom, int64_t n_geom,
                  int64_t *coef, int64_t coef_len) {
    if (n_geom < GEOM_HEAD || n_segs < 0 || n_luts < 0 || n_luts > MAX_LUTS) return TDT_ERR_ARGS;
    int64_t n_mcus = geom[0], per = geom[1], n_members = geom[2], mcux = geom[3];
    int progressive = geom[4] != 0;
    int64_t ss = geom[5], se = geom[6], ah = geom[7], al = geom[8];
    if (n_mcus < 0 || per <= 0 || mcux <= 0 || n_members < 0 || n_members > 4
        || n_geom < GEOM_HEAD + GEOM_MEMBER * n_members || ss < 0 || se > 63 || ss > se
        || ah < 0 || ah > 15 || al < 0 || al > 15)
        return TDT_ERR_ARGS;
    huff_t tables[MAX_LUTS];
    for (int64_t t = 0; t < n_luts; t++) huff_init(&tables[t], luts + (t << 16));
    member_t members[4];
    for (int64_t j = 0; j < n_members; j++) {
        const int64_t *g = geom + GEOM_HEAD + GEOM_MEMBER * j;
        member_t *m = &members[j];
        m->comp = g[0], m->base = g[1], m->cols = g[2], m->h = g[3], m->v = g[4];
        if (m->comp < 0 || m->comp > 3 || m->base < 0 || m->cols <= 0 || m->h < 1 || m->h > 4
            || m->v < 1 || m->v > 4 || g[5] < -1 || g[5] >= n_luts || g[6] < -1
            || g[6] >= n_luts)
            return TDT_ERR_ARGS;
        m->dc = g[5] < 0 ? NULL : &tables[g[5]];
        m->ac = g[6] < 0 ? NULL : &tables[g[6]];
        /* The tables this kind of scan reads. */
        int dc_read = !progressive || (ss == 0 && ah == 0);
        int ac_read = !progressive || ss > 0;
        if ((dc_read && !m->dc) || (ac_read && !m->ac)) return TDT_ERR_ARGS;
    }
    int64_t done = 0;
    for (int64_t s = 0; s < n_segs && done < n_mcus; s++) {
        if (seg_start[s] < 0 || seg_start[s + 1] < seg_start[s]) return TDT_ERR_ARGS;
        bits_t b = {data + seg_start[s], seg_start[s + 1] - seg_start[s], 0, 0};
        b.nbits = 8 * b.nbytes;
        int64_t count = per < n_mcus - done ? per : n_mcus - done;
        int64_t pred[4] = {0, 0, 0, 0}, eobrun = 0;
        for (int64_t i = done; i < done + count; i++) {
            int64_t mr = i / mcux, mc = i % mcux;
            for (int64_t j = 0; j < n_members; j++) {
                const member_t *m = &members[j];
                for (int64_t y = 0; y < m->v; y++) {
                    for (int64_t x = 0; x < m->h; x++) {
                        int64_t off = m->base + ((mr * m->v + y) * m->cols + mc * m->h + x) * 64;
                        if (off < 0 || off > coef_len - 64) return TDT_ERR_ARGS;
                        int rc = progressive
                            ? block_progressive(&b, m, (int)ss, (int)se, (int)ah, (int)al, pred,
                                                &eobrun, coef + off)
                            : block_sequential(&b, m, pred, coef + off);
                        if (rc) return rc;
                        /* The position only grows: past the end is final. */
                        if (b.pos > b.nbits) return TDT_ERR_TRUNCATED;
                    }
                }
            }
        }
        done += count;
    }
    return done < n_mcus ? TDT_ERR_SEGMENTS : TDT_OK;
}

/* ---- arithmetic coding: data/jpeg.py::_decode_arith_scan --------------------

   tdt_jpeg_arith_scan decodes one arithmetic-coded scan (libjpeg's jdarith.c:
   T.81 Annex D's QM decoder, F.1.4.4 and G.1.3) into the same coefficient
   blocks as tdt_jpeg_scan, from the same segments and geom, whose DC and AC
   table slots here name conditioning tables (0-15, -1: none). cond: L of each
   of the 16 DC tables, U of each, Kx of each AC table (DAC). Each scan and
   restart segment starts with zeroed statistics, DC predictions and
   conditioning of 0 and two fresh bytes; past a segment's end the decoder
   reads zeros (the marker that ends it), unless last_open says the file
   itself ends after the last segment: a read past it is then
   TDT_ERR_TRUNCATED. fetched[s]: the bytes segment s's decoder asked for
   (past its length: it read the marker), for the caller's check of where
   libjpeg read. */

/* jaricom.c's jpeg_aritab: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7
   | Next_Index_LPS; entry 113 is the fixed estimate of 0.5. */
static const uint32_t ARITAB[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};
#define ARITH_FIXED 113
#define DC_BINS 64
#define AC_BINS 256
#define ARITH_TABLES 16

typedef struct {
    const uint8_t *p;
    int64_t n, pos;
    int open_end;
    int64_t c, a;
    int ct;
    int err; /* set once: a read past an open end */
} arith_t;

static void arith_init(arith_t *d, const uint8_t *p, int64_t n, int open_end) {
    d->p = p, d->n = n, d->pos = 0, d->open_end = open_end;
    d->c = 0, d->a = 0, d->ct = -16, d->err = 0;
}

/* jdarith.c's arith_decode: one binary decision from the bin *st. */
static int arith_decode(arith_t *d, uint8_t *st) {
    while (d->a < 0x8000) {
        if (--d->ct < 0) {
            int byte = 0;
            if (d->pos < d->n) {
                byte = d->p[d->pos];
            } else if (d->open_end) {
                d->err = 1;
            }
            d->pos++;
            d->c = (d->c << 8) | byte;
            if ((d->ct += 8) < 0 && ++d->ct == 0) d->a = 0x8000;
        }
        d->a <<= 1;
    }
    int sv = *st;
    uint32_t e = ARITAB[sv & 0x7F];
    int64_t qe = e >> 16;
    uint8_t nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t temp = d->a - qe;
    d->a = temp;
    temp <<= d->ct;
    if (d->c >= temp) {
        d->c -= temp;
        if (d->a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
        d->a = qe;
    } else if (d->a < 0x8000) {
        if (d->a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

static inline int64_t wrap16(int64_t v) { return (int64_t)(int16_t)(uint16_t)(v & 0xFFFF); }

/* A DC difference (F.19, F.21-F.24); sets *ctx by its size against L and U.
   Returns TDT_ERR_CORRUPT on a magnitude past 15 bits. */
static int arith_dc(arith_t *d, uint8_t *stats, int *ctx, int lower, int upper, int64_t *v) {
    uint8_t *st = stats + *ctx;
    if (!arith_decode(d, st)) {
        *ctx = 0;
        *v = 0;
        return TDT_OK;
    }
    int sign = arith_decode(d, st + 1);
    st += 2 + sign;
    int m = arith_decode(d, st);
    if (m) {
        st = stats + 20;
        while (arith_decode(d, st)) {
            if ((m <<= 1) == 0x8000) return TDT_ERR_CORRUPT;
            st++;
        }
    }
    if (m < (1 << lower) >> 1)
        *ctx = 0;
    else if (m > (1 << upper) >> 1)
        *ctx = 12 + sign * 4;
    else
        *ctx = 4 + sign * 4;
    int val = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(d, st)) val |= m;
    *v = sign ? -(int64_t)(val + 1) : (int64_t)(val + 1);
    return TDT_OK;
}

/* An AC value whose nonzero decision was read at bin st (F.21-F.24). */
static int arith_ac(arith_t *d, uint8_t *stats, uint8_t *fixed, uint8_t *st, int k, int kx,
                    int64_t *v) {
    int sign = arith_decode(d, fixed);
    st += 2;
    int m = arith_decode(d, st);
    if (m && arith_decode(d, st)) {
        m <<= 1;
        st = stats + (k <= kx ? 189 : 217);
        while (arith_decode(d, st)) {
            if ((m <<= 1) == 0x8000) return TDT_ERR_CORRUPT;
            st++;
        }
    }
    int val = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(d, st)) val |= m;
    *v = sign ? -(int64_t)(val + 1) : (int64_t)(val + 1);
    return TDT_OK;
}

typedef struct {
    int64_t comp, base, cols, h, v;
    int dc, ac; /* conditioning tables, -1: none */
} arith_member_t;

/* One block of an arithmetic scan; j is its member's place in the scan. */
static int arith_block(arith_t *d, const arith_member_t *m, int j, int progressive, int ss,
                       int se, int ah, int al, uint8_t (*dc_stats)[DC_BINS],
                       uint8_t (*ac_stats)[AC_BINS], uint8_t *fixed, const int64_t *cond,
                       int64_t *last_dc, int *ctx, int64_t *c) {
    int64_t p1 = (int64_t)1 << al, m1 = -p1, v;
    if (!progressive || (ss == 0 && ah == 0)) {
        int rc = arith_dc(d, dc_stats[m->dc], &ctx[j], (int)cond[m->dc],
                          (int)cond[ARITH_TABLES + m->dc], &v);
        if (rc) return rc;
        last_dc[j] = (last_dc[j] + v) & 0xFFFF;
        c[0] = wrap16(last_dc[j] << al);
        if (progressive) return TDT_OK;
        uint8_t *stats = ac_stats[m->ac];
        int kx = (int)cond[2 * ARITH_TABLES + m->ac];
        int k = 0;
        do {
            uint8_t *st = stats + 3 * k;
            if (arith_decode(d, st)) break;
            for (;;) {
                k++;
                if (arith_decode(d, st + 1)) break;
                st += 3;
                if (k >= 63) return TDT_ERR_RANGE;
            }
            rc = arith_ac(d, stats, fixed, st, k, kx, &v);
            if (rc) return rc;
            c[k] = wrap16(v);
        } while (k < 63);
        return TDT_OK;
    }
    if (ss == 0) { /* DC refinement */
        if (arith_decode(d, fixed)) c[0] |= p1;
        return TDT_OK;
    }
    uint8_t *stats = ac_stats[m->ac];
    int kx = (int)cond[2 * ARITH_TABLES + m->ac];
    if (ah == 0) { /* AC first */
        for (int k = ss; k <= se; k++) {
            uint8_t *st = stats + 3 * (k - 1);
            if (arith_decode(d, st)) break;
            while (!arith_decode(d, st + 1)) {
                st += 3;
                if (++k > se) return TDT_ERR_RANGE;
            }
            int rc = arith_ac(d, stats, fixed, st, k, kx, &v);
            if (rc) return rc;
            c[k] = wrap16(v * p1);
        }
        return TDT_OK;
    }
    /* AC refinement: EOB decisions past the previous stage's last nonzero */
    int kex = se;
    while (kex > 0 && !c[kex]) kex--;
    for (int k = ss; k <= se; k++) {
        uint8_t *st = stats + 3 * (k - 1);
        if (k > kex && arith_decode(d, st)) break;
        for (;;) {
            int64_t now = c[k];
            if (now) {
                if (arith_decode(d, st + 2)) c[k] = wrap16(now + (now < 0 ? m1 : p1));
                break;
            }
            if (arith_decode(d, st + 1)) {
                c[k] = arith_decode(d, fixed) ? m1 : p1;
                break;
            }
            st += 3;
            if (++k > se) return TDT_ERR_RANGE;
        }
    }
    return TDT_OK;
}

int tdt_jpeg_arith_scan(const uint8_t *data, const int64_t *seg_start, int64_t n_segs,
                        const int64_t *cond, int64_t last_open, const int64_t *geom,
                        int64_t n_geom, int64_t *coef, int64_t coef_len, int64_t *fetched) {
    if (n_geom < GEOM_HEAD || n_segs < 0) return TDT_ERR_ARGS;
    int64_t n_mcus = geom[0], per = geom[1], n_members = geom[2], mcux = geom[3];
    int progressive = geom[4] != 0;
    int64_t ss = geom[5], se = geom[6], ah = geom[7], al = geom[8];
    if (n_mcus < 0 || per <= 0 || mcux <= 0 || n_members < 1 || n_members > 4
        || n_geom < GEOM_HEAD + GEOM_MEMBER * n_members || ss < 0 || se > 63 || ss > se
        || ah < 0 || ah > 13 || al < 0 || al > 13 || (progressive && ss > 0 && n_members != 1))
        return TDT_ERR_ARGS;
    for (int t = 0; t < 3 * ARITH_TABLES; t++)
        if (cond[t] < 0 || cond[t] > 255 || (t < 2 * ARITH_TABLES && cond[t] > 15))
            return TDT_ERR_ARGS;
    int dc_read = !progressive || (ss == 0 && ah == 0), ac_read = !progressive || ss > 0;
    arith_member_t members[4];
    for (int64_t j = 0; j < n_members; j++) {
        const int64_t *g = geom + GEOM_HEAD + GEOM_MEMBER * j;
        arith_member_t *m = &members[j];
        m->comp = g[0], m->base = g[1], m->cols = g[2], m->h = g[3], m->v = g[4];
        m->dc = (int)g[5], m->ac = (int)g[6];
        if (m->comp < 0 || m->comp > 3 || m->base < 0 || m->cols <= 0 || m->h < 1 || m->h > 4
            || m->v < 1 || m->v > 4 || m->dc < -1 || m->dc >= ARITH_TABLES || m->ac < -1
            || m->ac >= ARITH_TABLES || (dc_read && m->dc < 0) || (ac_read && m->ac < 0))
            return TDT_ERR_ARGS;
    }
    uint8_t dc_stats[ARITH_TABLES][DC_BINS], ac_stats[ARITH_TABLES][AC_BINS];
    int64_t done = 0;
    for (int64_t s = 0; s < n_segs && done < n_mcus; s++) {
        if (seg_start[s] < 0 || seg_start[s + 1] < seg_start[s]) return TDT_ERR_ARGS;
        arith_t d;
        arith_init(&d, data + seg_start[s], seg_start[s + 1] - seg_start[s],
                   last_open && s == n_segs - 1);
        for (int64_t j = 0; j < n_members; j++) {
            if (dc_read) memset(dc_stats[members[j].dc], 0, DC_BINS);
            if (ac_read) memset(ac_stats[members[j].ac], 0, AC_BINS);
        }
        uint8_t fixed = ARITH_FIXED;
        int64_t last_dc[4] = {0, 0, 0, 0};
        int ctx[4] = {0, 0, 0, 0};
        int64_t count = per < n_mcus - done ? per : n_mcus - done;
        for (int64_t i = done; i < done + count; i++) {
            int64_t mr = i / mcux, mc = i % mcux;
            for (int64_t j = 0; j < n_members; j++) {
                const arith_member_t *m = &members[j];
                for (int64_t y = 0; y < m->v; y++) {
                    for (int64_t x = 0; x < m->h; x++) {
                        int64_t off = m->base + ((mr * m->v + y) * m->cols + mc * m->h + x) * 64;
                        if (off < 0 || off > coef_len - 64) return TDT_ERR_ARGS;
                        int rc = arith_block(&d, m, (int)j, progressive, (int)ss, (int)se,
                                             (int)ah, (int)al, dc_stats, ac_stats, &fixed, cond,
                                             last_dc, ctx, coef + off);
                        if (d.err) return TDT_ERR_TRUNCATED;
                        if (rc) return rc;
                    }
                }
            }
        }
        fetched[s] = d.pos;
        done += count;
    }
    return done < n_mcus ? TDT_ERR_SEGMENTS : TDT_OK;
}

/* ---- the pixels: data/jpeg.py::_pixels ------------------------------------ */

static const int ZIGZAG[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum { MODE_GREY, MODE_YCC, MODE_RGB, MODE_CMYK, MODE_YCCK };
#define PIX_HEAD 6
#define PIX_COMP 5

/* jidctint.c's jpeg_idct_islow, one pass over eight values d[0], d[s], ...
   (int64 as in the plain version), descaled by `shift`. */
static inline void idct_1d(int64_t *d, int s, int shift) {
    int64_t z1 = (d[2 * s] + d[6 * s]) * 4433;
    int64_t tmp2 = z1 - d[6 * s] * 15137, tmp3 = z1 + d[2 * s] * 6270;
    int64_t tmp0 = (d[0] + d[4 * s]) * 8192, tmp1 = (d[0] - d[4 * s]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = d[7 * s], t1 = d[5 * s], t2 = d[3 * s], t3 = d[s];
    int64_t w1 = t0 + t3, w2 = t1 + t2, w3 = t0 + t2, w4 = t1 + t3;
    int64_t w5 = (w3 + w4) * 9633;
    t0 *= 2446, t1 *= 16819, t2 *= 25172, t3 *= 12299;
    w1 *= -7373, w2 *= -20995;
    w3 = w3 * -16069 + w5, w4 = w4 * -3196 + w5;
    t0 += w1 + w3, t1 += w2 + w4, t2 += w2 + w3, t3 += w1 + w4;
    int64_t half = (int64_t)1 << (shift - 1);
    int64_t out[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                      tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
    for (int k = 0; k < 8; k++) d[k * s] = (out[k] + half) >> shift;
}

/* jdmaster.c's range limit of value + 128, indexed by value & 1023. */
static inline uint8_t idct_limit(int64_t v) {
    int64_t i = v & 1023;
    return i < 128 ? (uint8_t)(i + 128) : i < 512 ? 255 : i < 896 ? 0 : (uint8_t)(i - 896);
}

/* A component's blocks (rows x cols, zigzag) -> samples (8 rows x 8 cols). */
static void idct_plane(const int64_t *coef, const int64_t *q, int64_t rows, int64_t cols,
                       uint8_t *plane) {
    int64_t stride = cols * 8;
    for (int64_t r = 0; r < rows; r++) {
        for (int64_t c = 0; c < cols; c++) {
            const int64_t *in = coef + (r * cols + c) * 64;
            int64_t d[64];
            for (int k = 0; k < 64; k++) d[ZIGZAG[k]] = in[k];
            for (int k = 0; k < 64; k++) d[k] *= q[k];
            for (int x = 0; x < 8; x++) idct_1d(d + x, 8, 11);       /* columns */
            for (int y = 0; y < 8; y++) idct_1d(d + 8 * y, 1, 18);   /* rows */
            uint8_t *out = plane + r * 8 * stride + c * 8;
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++) out[y * stride + x] = idct_limit(d[8 * y + x]);
        }
    }
}

/* jdsample.c's upsampling of src (ph x pw, row stride `stride`) by (fh, fv),
   the result cropped to dst (h x w): h2v2 and h2v1 fancy where the plane is
   over 2 columns wide (else replication), h1v2 fancy, or a copy. */
static void upsample(const uint8_t *src, int64_t ph, int64_t pw, int64_t stride, int fh, int fv,
                     uint8_t *dst, int64_t h, int64_t w) {
    for (int64_t y = 0; y < h; y++) {
        int64_t i = y / fv;
        const uint8_t *row = src + i * stride;
        const uint8_t *near = fv == 2 ? src + (y & 1 ? (i + 1 < ph ? i + 1 : i) : (i > 0 ? i - 1 : 0)) * stride
                                      : row;
        uint8_t *out = dst + y * w;
        for (int64_t x = 0; x < w; x++) {
            int64_t j = x / fh;
            int v;
            if (fh == 1 && fv == 1) {
                v = row[j];
            } else if (fh == 2 && pw <= 2) {
                v = row[j];
            } else if (fh == 1) { /* h1v2: 3/4 of this row, 1/4 of the nearer one */
                v = (3 * row[j] + near[j] + (y & 1 ? 2 : 1)) >> 2;
            } else {
                int64_t jn = x & 1 ? (j + 1 < pw ? j + 1 : j) : (j > 0 ? j - 1 : 0);
                if (fv == 1) { /* h2v1 */
                    v = (3 * row[j] + row[jn] + (x & 1 ? 2 : 1)) >> 2;
                } else { /* h2v2: the column sums first, then along the row */
                    int c = 3 * row[j] + near[j], cn = 3 * row[jn] + near[jn];
                    v = (3 * c + cn + (x & 1 ? 7 : 8)) >> 4;
                }
            }
            out[x] = (uint8_t)v;
        }
    }
}

static inline int clamp255(int64_t v) { return v < 0 ? 0 : v > 255 ? 255 : (int)v; }

static inline int muldiv255(int a, int b) {
    int t = a * b + 128;
    return ((t >> 8) + t) >> 8;
}

/* The inverse DCT, upsampling and colour conversion of a decoded frame.
   geom: height, width, hmax, vmax, components (1, 3 or 4), mode, then for
   each component: offset of its first coefficient, block rows, block
   columns, h, v. qtables: 64 natural-order int64 a component. */
int tdt_jpeg_pixels(const int64_t *coef, int64_t coef_len, const int64_t *qtables,
                    const int64_t *geom, int64_t n_geom, uint8_t *rgb, int64_t rgb_len) {
    if (n_geom < PIX_HEAD) return TDT_ERR_ARGS;
    int64_t height = geom[0], width = geom[1], hmax = geom[2], vmax = geom[3], n = geom[4];
    int mode = (int)geom[5];
    if (height <= 0 || width <= 0 || hmax < 1 || vmax < 1 || (n != 1 && n != 3 && n != 4)
        || n_geom < PIX_HEAD + PIX_COMP * n || rgb_len != height * width * 3 || mode < 0
        || mode > MODE_YCCK)
        return TDT_ERR_ARGS;
    uint8_t *planes[4] = {NULL, NULL, NULL, NULL};
    uint8_t *samples = NULL;
    int rc = TDT_OK;
    for (int64_t ci = 0; ci < n && rc == TDT_OK; ci++) {
        const int64_t *g = geom + PIX_HEAD + PIX_COMP * ci;
        int64_t base = g[0], rows = g[1], cols = g[2], h = g[3], v = g[4];
        if (base < 0 || rows <= 0 || cols <= 0 || h < 1 || v < 1 || hmax % h || vmax % v
            || rows * cols * 64 > coef_len - base) {
            rc = TDT_ERR_ARGS;
            break;
        }
        int fh = (int)(hmax / h), fv = (int)(vmax / v);
        int64_t ph = (height * v + vmax - 1) / vmax, pw = (width * h + hmax - 1) / hmax;
        if (fh > 2 || fv > 2 || ph > rows * 8 || pw > cols * 8 || ph * fv < height
            || pw * fh < width) {
            rc = TDT_ERR_ARGS;
            break;
        }
        samples = malloc((size_t)(rows * cols * 64));
        planes[ci] = malloc((size_t)(height * width));
        if (!samples || !planes[ci]) {
            rc = TDT_ERR_MEMORY;
            break;
        }
        idct_plane(coef + base, qtables + 64 * ci, rows, cols, samples);
        upsample(samples, ph, pw, cols * 8, fh, fv, planes[ci], height, width);
        free(samples);
        samples = NULL;
    }
    if (rc == TDT_OK) {
        int64_t npix = height * width;
        for (int64_t i = 0; i < npix; i++) {
            uint8_t *out = rgb + 3 * i;
            if (mode == MODE_GREY) {
                out[0] = out[1] = out[2] = planes[0][i];
                continue;
            }
            if (mode == MODE_RGB) {
                for (int k = 0; k < 3; k++) out[k] = planes[k][i];
                continue;
            }
            int64_t y = planes[0][i], cb = planes[1][i] - 128, cr = planes[2][i] - 128;
            int64_t half = 1 << 15;
            int64_t r = y + ((91881 * cr + half) >> 16);
            int64_t gg = y + ((-22554 * cb + half - 46802 * cr) >> 16);
            int64_t b = y + ((116130 * cb + half) >> 16);
            if (mode == MODE_YCC) {
                out[0] = (uint8_t)clamp255(r), out[1] = (uint8_t)clamp255(gg),
                out[2] = (uint8_t)clamp255(b);
                continue;
            }
            /* CMYK (Adobe's inverted), or YCCK: 255 less the YCbCr sums. */
            int cmy[3];
            if (mode == MODE_YCCK) {
                cmy[0] = clamp255(255 - r), cmy[1] = clamp255(255 - gg), cmy[2] = clamp255(255 - b);
            } else {
                for (int k = 0; k < 3; k++) cmy[k] = planes[k][i];
            }
            int nk = 255 - (255 - planes[3][i]);
            for (int k = 0; k < 3; k++) out[k] = (uint8_t)clamp255(nk - muldiv255(255 - cmy[k], nk));
        }
    }
    free(samples);
    for (int k = 0; k < 4; k++) free(planes[k]);
    return rc;
}

/* ---- lossless (SOF3): data/jpeg.py::_decode_lossless_scan -------------------

   tdt_jpeg_lossless_scan decodes one Huffman-coded lossless scan (T.81
   Annex H, as libjpeg-turbo 3's jdlhuff.c, jddiffct.c and jdlossls.c read
   it) into the undifferenced samples of its components, before the point
   transform. Each sample is a DC-style difference: a category 0-15 and
   that many extra bits, or 16 with none (32768). The differences of a scan
   are decoded first (a member's MCU holds h x v of its samples, in raster
   order; an interleaved scan's samples past the component's width are
   decoded and dropped), then undifferenced row by row, mod 2^16: the first
   row of the scan, and the first row of each MCU row a restart interval
   starts (prediction resets there), from the left neighbour, its first
   sample from 2^(P - Pt - 1); every other row's first sample from the one
   above, the rest by the scan's predictor (1-7) of the left (Ra), upper (Rb)
   and upper-left (Rc) neighbours.

   geom (int64), as data/jpeg.py::_lossless_geometry writes it:
     [0] MCUs in the scan, [1] MCUs a segment, [2] members (1-4), [3] MCUs a
     row, [4] predictor, [5] the first row's initial prediction, [6] MCU rows
     between prediction resets (0: none after the first),
     then for each member: offset of its first sample in `planes`, its row
     stride, the samples a row and rows to undifference, h, v (1 for a
     one-component scan), its table (an index into `luts`). */
#define GEOM_LL_HEAD 7
#define GEOM_LL_MEMBER 7

int tdt_jpeg_lossless_scan(const uint8_t *data, const int64_t *seg_start, int64_t n_segs,
                           const uint16_t *luts, int64_t n_luts, const int64_t *geom,
                           int64_t n_geom, int64_t *planes, int64_t planes_len) {
    if (n_geom < GEOM_LL_HEAD || n_segs < 0 || n_luts < 1 || n_luts > MAX_LUTS)
        return TDT_ERR_ARGS;
    int64_t n_mcus = geom[0], per = geom[1], n_members = geom[2], mcux = geom[3];
    int64_t predictor = geom[4], initial = geom[5], reset_rows = geom[6];
    if (n_mcus < 0 || per <= 0 || mcux <= 0 || n_members < 1 || n_members > 4
        || n_geom < GEOM_LL_HEAD + GEOM_LL_MEMBER * n_members || predictor < 1 || predictor > 7
        || reset_rows < 0)
        return TDT_ERR_ARGS;
    huff_t tables[MAX_LUTS];
    for (int64_t t = 0; t < n_luts; t++) huff_init(&tables[t], luts + (t << 16));
    int64_t mcu_rows = (n_mcus + mcux - 1) / mcux;
    int64_t base[4], stride[4], width[4], rows[4], h[4], v[4], dbase[4], total = 0;
    const huff_t *table[4];
    for (int64_t j = 0; j < n_members; j++) {
        const int64_t *g = geom + GEOM_LL_HEAD + GEOM_LL_MEMBER * j;
        base[j] = g[0], stride[j] = g[1], width[j] = g[2], rows[j] = g[3], h[j] = g[4];
        v[j] = g[5];
        if (base[j] < 0 || width[j] < 1 || rows[j] < 1 || h[j] < 1 || h[j] > 4 || v[j] < 1
            || v[j] > 4 || g[6] < 0 || g[6] >= n_luts || width[j] > mcux * h[j]
            || rows[j] > mcu_rows * v[j] || stride[j] < width[j]
            || base[j] + (rows[j] - 1) * stride[j] + width[j] > planes_len)
            return TDT_ERR_ARGS;
        table[j] = &tables[g[6]];
        dbase[j] = total;
        total += mcu_rows * v[j] * mcux * h[j];
    }
    int32_t *diff = malloc((size_t)(total ? total : 1) * sizeof(int32_t));
    if (!diff) return TDT_ERR_MEMORY;
    int rc = TDT_OK;
    int64_t done = 0;
    for (int64_t s = 0; s < n_segs && done < n_mcus && rc == TDT_OK; s++) {
        if (seg_start[s] < 0 || seg_start[s + 1] < seg_start[s]) {
            rc = TDT_ERR_ARGS;
            break;
        }
        bits_t b = {data + seg_start[s], seg_start[s + 1] - seg_start[s], 0, 0};
        b.nbits = 8 * b.nbytes;
        int64_t count = per < n_mcus - done ? per : n_mcus - done;
        for (int64_t i = done; i < done + count && rc == TDT_OK; i++) {
            int64_t mr = i / mcux, mc = i % mcux;
            for (int64_t j = 0; j < n_members && rc == TDT_OK; j++) {
                int64_t cols = mcux * h[j];
                for (int64_t y = 0; y < v[j] && rc == TDT_OK; y++) {
                    for (int64_t x = 0; x < h[j]; x++) {
                        int sym = huff_decode(&b, table[j]);
                        if (sym < 0 || sym > 16) {
                            rc = TDT_ERR_CODE;
                            break;
                        }
                        int32_t d = sym == 16 ? 32768 : (int32_t)extend(get_bits(&b, sym), sym);
                        diff[dbase[j] + (mr * v[j] + y) * cols + mc * h[j] + x] = d;
                        if (b.pos > b.nbits) {
                            rc = TDT_ERR_TRUNCATED;
                            break;
                        }
                    }
                }
            }
        }
        done += count;
    }
    if (rc == TDT_OK && done < n_mcus) rc = TDT_ERR_SEGMENTS;
    for (int64_t j = 0; j < n_members && rc == TDT_OK; j++) {
        int64_t cols = mcux * h[j];
        for (int64_t r = 0; r < rows[j]; r++) {
            const int32_t *d = diff + dbase[j] + r * cols;
            int64_t *out = planes + base[j] + r * stride[j];
            const int64_t *prev = out - stride[j];
            int64_t band = r / v[j];
            int first = r == 0 || (r % v[j] == 0 && reset_rows && band % reset_rows == 0);
            int64_t ra, rb, rc_ = 0;
            if (first) {
                ra = (d[0] + initial) & 0xFFFF;
                out[0] = ra;
                for (int64_t c = 1; c < width[j]; c++) out[c] = ra = (d[c] + ra) & 0xFFFF;
                continue;
            }
            rb = prev[0];
            out[0] = ra = (d[0] + rb) & 0xFFFF;
            for (int64_t c = 1; c < width[j]; c++) {
                rc_ = rb;
                rb = prev[c];
                int64_t p;
                switch (predictor) {
                    case 1: p = ra; break;
                    case 2: p = rb; break;
                    case 3: p = rc_; break;
                    case 4: p = ra + rb - rc_; break;
                    case 5: p = ra + ((rb - rc_) >> 1); break;
                    case 6: p = rb + ((ra - rc_) >> 1); break;
                    default: p = (ra + rb) >> 1; break;
                }
                out[c] = ra = (d[c] + p) & 0xFFFF;
            }
        }
    }
    free(diff);
    return rc;
}
