/* JPEG 2000 (ISO 15444-1) tile decoding as OpenJPEG 2.5 does it, the
   counterpart of the decoder Pillow calls: tier-2 (packet headers with their
   tag trees, in each of the five progression orders, over precincts and
   code-blocks), tier-1 (EBCOT: the MQ decoder and its three coding passes,
   OpenJPEG's mid-point reconstruction), dequantisation, the inverse 5/3
   (integer) and 9/7 (float32, OpenJPEG's constants, order of operations and
   its two_invK scaling) wavelets, the inverse RCT and ICT, the DC level
   shift and the clamp to the component's range.

   data/jpeg2000.py parses the boxes and marker segments and calls
   tdt_j2k_tile once a tile, with the tile's packet data (its tile-parts
   joined) and its coding parameters as an int64 table (the P_* and C_*
   offsets below). Every tile component is written to `out` as int32, one
   after another, each (tcy1 - tcy0) rows of (tcx1 - tcx0). Code-block styles
   other than RESET, TERMALL, PTERM and SEGSYM are refused (the caller names
   them). Float operations must not be contracted into FMAs
   (-ffp-contract=off) to give OpenJPEG's bits. */
#include <stdlib.h>
#include <string.h>

#include "decode.h"

/* The parameter table. */
enum { P_NCOMPS, P_NLAYERS, P_PROG, P_CSTY, P_MCT, P_TX0, P_TY0, P_TX1, P_TY1, P_HEADER = 16 };
#define MAX_RES 33
#define MAX_BANDS (3 * (MAX_RES - 1) + 1)
enum {
    C_DX, C_DY, C_PREC, C_SGND, C_NUMRES, C_XCB, C_YCB, C_CBLKSTY, C_QMFBID, C_NUMGBITS, C_ROISHIFT,
    C_PPX, C_PPY = C_PPX + MAX_RES, C_EXPN = C_PPY + MAX_RES, C_MANT = C_EXPN + MAX_BANDS,
    C_FIELDS = C_MANT + MAX_BANDS
};
enum { LRCP, RLCP, RPCL, PCRL, CPRL };
#define STY_BYPASS 0x01
#define STY_RESET 0x02
#define STY_TERMALL 0x04
#define STY_VSC 0x08
#define STY_SEGSYM 0x20
#define MAX_CBLKS (1 << 24)
#define MAX_INCLUDE ((int64_t)1 << 28) /* bits */

/* ---- small helpers ---------------------------------------------------- */

static int64_t ceil_div(int64_t a, int64_t b) { return a >= 0 ? (a + b - 1) / b : -((-a) / b); }
static int64_t floor_pow2(int64_t a, int b) { return a >> b; } /* arithmetic shift: floor */
static int64_t ceil_pow2(int64_t a, int b) { return -((-a) >> b); }
static int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }
static int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
static int floorlog2(uint32_t a) {
    int l = 0;
    while (a > 1) a >>= 1, l++;
    return l;
}

/* ---- packet-header bits (OpenJPEG's opj_bio: 0xFF bytes stuffed, zeros
   past the end) ---------------------------------------------------------- */

typedef struct {
    const uint8_t *start, *bp, *end;
    uint32_t buf;
    int ct;
} bio_t;

static void bio_init(bio_t *b, const uint8_t *p, int64_t n) {
    b->start = b->bp = p, b->end = p + n, b->buf = 0, b->ct = 0;
}
static void bio_bytein(bio_t *b) {
    b->buf = (b->buf << 8) & 0xffff;
    b->ct = b->buf == 0xff00 ? 7 : 8;
    if (b->bp < b->end) b->buf |= *b->bp++;
}
static uint32_t bio_read(bio_t *b, int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) {
        if (b->ct == 0) bio_bytein(b);
        b->ct--;
        v |= ((b->buf >> b->ct) & 1u) << i;
    }
    return v;
}
static void bio_inalign(bio_t *b) {
    b->ct = 0;
    if ((b->buf & 0xff) == 0xff) {
        bio_bytein(b);
        b->ct = 0;
    }
}

/* ---- tag trees --------------------------------------------------------- */

typedef struct {
    int32_t value, low, parent;
} tnode_t;

typedef struct {
    tnode_t *nodes;
} tgt_t;

static int tgt_init(tgt_t *t, int64_t w, int64_t h) {
    int64_t ws[64], hs[64], levels = 0, total = 0;
    t->nodes = NULL;
    if (w <= 0 || h <= 0) return TDT_OK;
    ws[0] = w, hs[0] = h;
    do {
        total += ws[levels] * hs[levels];
        ws[levels + 1] = (ws[levels] + 1) / 2, hs[levels + 1] = (hs[levels] + 1) / 2;
        levels++;
    } while (ws[levels - 1] * hs[levels - 1] > 1 && levels < 62);
    t->nodes = malloc((size_t)total * sizeof(tnode_t));
    if (!t->nodes) return TDT_ERR_MEMORY;
    int64_t base = 0;
    for (int64_t l = 0; l < levels; l++) {
        int64_t next = base + ws[l] * hs[l];
        for (int64_t j = 0; j < hs[l]; j++)
            for (int64_t i = 0; i < ws[l]; i++) {
                tnode_t *node = &t->nodes[base + j * ws[l] + i];
                node->value = 999, node->low = 0;
                node->parent = l + 1 < levels ? (int32_t)(next + (j / 2) * ws[l + 1] + i / 2) : -1;
            }
        base = next;
    }
    return TDT_OK;
}

/* 1 when leaf `leaf`'s value is below `threshold` (OpenJPEG's opj_tgt_decode). */
static int tgt_decode(tgt_t *t, bio_t *b, int64_t leaf, int32_t threshold) {
    int32_t stack[64];
    int depth = 0;
    int32_t k = (int32_t)leaf;
    while (t->nodes[k].parent >= 0 && depth < 64) stack[depth++] = k, k = t->nodes[k].parent;
    int32_t low = 0;
    for (;;) {
        tnode_t *node = &t->nodes[k];
        if (low > node->low) node->low = low;
        else low = node->low;
        while (low < threshold && low < node->value) {
            if (bio_read(b, 1)) node->value = low;
            else ++low;
        }
        node->low = low;
        if (depth == 0) break;
        k = stack[--depth];
    }
    return t->nodes[k].value < threshold;
}

/* ---- the tile's structure ---------------------------------------------- */

typedef struct {
    int32_t numpasses, maxpasses, numnewpasses;
    int64_t len, newlen;
} seg_t;

typedef struct {
    int64_t x0, y0, x1, y1;
    int32_t numbps, numlenbits, numnewpasses, numsegs;
    int32_t nseg_alloc;
    seg_t *segs;
    uint8_t *data;
    int64_t len, cap;
} cblk_t;

typedef struct {
    int64_t cw, ch;
    cblk_t *cblks;
    tgt_t incl, imsb;
} prec_t;

typedef struct {
    int bandno, empty;
    int64_t x0, y0, x1, y1;
    int32_t numbps; /* Mb */
    float stepsize;
    prec_t *precs;
} band_t;

typedef struct {
    int64_t x0, y0, x1, y1, pw, ph;
    int pdx, pdy, nbands;
    band_t bands[3];
} res_t;

typedef struct {
    int64_t dx, dy, x0, y0, x1, y1;
    int prec, sgnd, numres, cblksty, qmfbid, roishift;
    res_t res[MAX_RES];
    int32_t *ints; /* the coefficients of a reversible component (qmfbid 1) */
    float *floats; /* those of an irreversible one */
} comp_t;

typedef struct {
    int ncomps, nlayers, prog, csty, mct, maxres;
    int64_t tx0, ty0, tx1, ty1, nprecs, ncblks;
    comp_t *comps;
} tile_t;

static void free_tile(tile_t *t) {
    if (!t->comps) return;
    for (int c = 0; c < t->ncomps; c++) {
        comp_t *comp = &t->comps[c];
        for (int r = 0; r < comp->numres; r++)
            for (int b = 0; b < comp->res[r].nbands; b++) {
                band_t *band = &comp->res[r].bands[b];
                if (!band->precs) continue;
                for (int64_t p = 0; p < comp->res[r].pw * comp->res[r].ph; p++) {
                    prec_t *prec = &band->precs[p];
                    if (prec->cblks)
                        for (int64_t k = 0; k < prec->cw * prec->ch; k++)
                            free(prec->cblks[k].segs), free(prec->cblks[k].data);
                    free(prec->cblks), free(prec->incl.nodes), free(prec->imsb.nodes);
                }
                free(band->precs);
            }
        free(comp->ints), free(comp->floats);
    }
    free(t->comps);
}

/* OpenJPEG's opj_tcd_init_tile: resolutions, bands, precincts, code-blocks. */
static int build_comp(tile_t *t, comp_t *comp, const int64_t *cp) {
    comp->x0 = ceil_div(t->tx0, comp->dx), comp->y0 = ceil_div(t->ty0, comp->dy);
    comp->x1 = ceil_div(t->tx1, comp->dx), comp->y1 = ceil_div(t->ty1, comp->dy);
    int64_t area = (comp->x1 - comp->x0) * (comp->y1 - comp->y0);
    if (comp->qmfbid == 1) comp->ints = calloc((size_t)(area > 0 ? area : 1), sizeof(int32_t));
    else comp->floats = calloc((size_t)(area > 0 ? area : 1), sizeof(float));
    if (!comp->ints && !comp->floats) return TDT_ERR_MEMORY;
    int xcb = (int)cp[C_XCB], ycb = (int)cp[C_YCB], numgbits = (int)cp[C_NUMGBITS];
    for (int r = 0; r < comp->numres; r++) {
        res_t *res = &comp->res[r];
        int level = comp->numres - 1 - r;
        res->x0 = ceil_pow2(comp->x0, level), res->y0 = ceil_pow2(comp->y0, level);
        res->x1 = ceil_pow2(comp->x1, level), res->y1 = ceil_pow2(comp->y1, level);
        res->pdx = (int)cp[C_PPX + r], res->pdy = (int)cp[C_PPY + r];
        if (r > 0 && (res->pdx == 0 || res->pdy == 0)) return TDT_ERR_CORRUPT;
        int64_t tlx = floor_pow2(res->x0, res->pdx) << res->pdx;
        int64_t tly = floor_pow2(res->y0, res->pdy) << res->pdy;
        int64_t brx = ceil_pow2(res->x1, res->pdx) << res->pdx;
        int64_t bry = ceil_pow2(res->y1, res->pdy) << res->pdy;
        res->pw = res->x0 == res->x1 ? 0 : (brx - tlx) >> res->pdx;
        res->ph = res->y0 == res->y1 ? 0 : (bry - tly) >> res->pdy;
        if (res->pw * res->ph > MAX_CBLKS) return TDT_ERR_RANGE;
        t->nprecs += res->pw * res->ph;
        if (t->nprecs > MAX_CBLKS) return TDT_ERR_RANGE;
        int64_t cbgx = r == 0 ? tlx : ceil_pow2(tlx, 1), cbgy = r == 0 ? tly : ceil_pow2(tly, 1);
        int cbgw = r == 0 ? res->pdx : res->pdx - 1, cbgh = r == 0 ? res->pdy : res->pdy - 1;
        int cblkw = xcb < cbgw ? xcb : cbgw, cblkh = ycb < cbgh ? ycb : cbgh;
        res->nbands = r == 0 ? 1 : 3;
        for (int b = 0; b < res->nbands; b++) {
            band_t *band = &res->bands[b];
            band->bandno = r == 0 ? 0 : b + 1;
            int64_t index = r == 0 ? 0 : 3 * (r - 1) + b + 1;
            if (r == 0) {
                band->x0 = res->x0, band->y0 = res->y0, band->x1 = res->x1, band->y1 = res->y1;
            } else {
                int64_t x0b = band->bandno & 1, y0b = band->bandno >> 1;
                band->x0 = ceil_pow2(comp->x0 - ((int64_t)1 << level) * x0b, level + 1);
                band->y0 = ceil_pow2(comp->y0 - ((int64_t)1 << level) * y0b, level + 1);
                band->x1 = ceil_pow2(comp->x1 - ((int64_t)1 << level) * x0b, level + 1);
                band->y1 = ceil_pow2(comp->y1 - ((int64_t)1 << level) * y0b, level + 1);
            }
            int64_t expn = cp[C_EXPN + index], mant = cp[C_MANT + index];
            band->numbps = (int32_t)(expn + numgbits - 1);
            /* Delta_b with Rb = prec (OpenJPEG's decoder: log2 gain 0 with the 9/7). */
            double step = (1.0 + (double)mant / 2048.0);
            int e = comp->prec - (int)expn;
            for (; e > 0; e--) step *= 2.0;
            for (; e < 0; e++) step *= 0.5;
            band->stepsize = (float)step;
            band->empty = band->x1 - band->x0 <= 0 || band->y1 - band->y0 <= 0;
            if (band->empty || res->pw * res->ph == 0) continue;
            band->precs = calloc((size_t)(res->pw * res->ph), sizeof(prec_t));
            if (!band->precs) return TDT_ERR_MEMORY;
            for (int64_t p = 0; p < res->pw * res->ph; p++) {
                prec_t *prec = &band->precs[p];
                int64_t sx = cbgx + (p % res->pw) * ((int64_t)1 << cbgw);
                int64_t sy = cbgy + (p / res->pw) * ((int64_t)1 << cbgh);
                int64_t px0 = max64(sx, band->x0), py0 = max64(sy, band->y0);
                int64_t px1 = min64(sx + ((int64_t)1 << cbgw), band->x1);
                int64_t py1 = min64(sy + ((int64_t)1 << cbgh), band->y1);
                int64_t tcx = floor_pow2(px0, cblkw) << cblkw, tcy = floor_pow2(py0, cblkh) << cblkh;
                int64_t bcx = ceil_pow2(px1, cblkw) << cblkw, bcy = ceil_pow2(py1, cblkh) << cblkh;
                prec->cw = bcx > tcx ? (bcx - tcx) >> cblkw : 0;
                prec->ch = bcy > tcy ? (bcy - tcy) >> cblkh : 0;
                int64_t n = prec->cw * prec->ch;
                t->ncblks += n;
                if (t->ncblks > MAX_CBLKS) return TDT_ERR_RANGE;
                if (n == 0) continue;
                prec->cblks = calloc((size_t)n, sizeof(cblk_t));
                if (!prec->cblks) return TDT_ERR_MEMORY;
                if (tgt_init(&prec->incl, prec->cw, prec->ch) || tgt_init(&prec->imsb, prec->cw, prec->ch))
                    return TDT_ERR_MEMORY;
                for (int64_t k = 0; k < n; k++) {
                    cblk_t *cb = &prec->cblks[k];
                    int64_t cx = tcx + (k % prec->cw) * ((int64_t)1 << cblkw);
                    int64_t cy = tcy + (k / prec->cw) * ((int64_t)1 << cblkh);
                    cb->x0 = max64(cx, px0), cb->y0 = max64(cy, py0);
                    cb->x1 = min64(cx + ((int64_t)1 << cblkw), px1);
                    cb->y1 = min64(cy + ((int64_t)1 << cblkh), py1);
                }
            }
        }
    }
    return TDT_OK;
}

/* ---- tier-2 ------------------------------------------------------------ */

static int seg_at(cblk_t *cb, int32_t index, int cblksty) {
    if (index >= cb->nseg_alloc) {
        int32_t n = cb->nseg_alloc ? 2 * cb->nseg_alloc : 4;
        while (n <= index) n *= 2;
        seg_t *segs = realloc(cb->segs, (size_t)n * sizeof(seg_t));
        if (!segs) return TDT_ERR_MEMORY;
        memset(segs + cb->nseg_alloc, 0, (size_t)(n - cb->nseg_alloc) * sizeof(seg_t));
        cb->segs = segs, cb->nseg_alloc = n;
    }
    seg_t *seg = &cb->segs[index];
    seg->numpasses = 0, seg->len = 0;
    seg->maxpasses = (cblksty & STY_TERMALL) ? 1 : 109;
    return TDT_OK;
}

static int append(cblk_t *cb, const uint8_t *p, int64_t n) {
    if (cb->len + n > cb->cap) {
        int64_t cap = cb->cap ? cb->cap : 256;
        while (cap < cb->len + n) cap *= 2;
        uint8_t *data = realloc(cb->data, (size_t)cap);
        if (!data) return TDT_ERR_MEMORY;
        cb->data = data, cb->cap = cap;
    }
    memcpy(cb->data + cb->len, p, (size_t)n);
    cb->len += n;
    return TDT_OK;
}

static uint32_t numpasses(bio_t *b) {
    uint32_t n;
    if (!bio_read(b, 1)) return 1;
    if (!bio_read(b, 1)) return 2;
    if ((n = bio_read(b, 2)) != 3) return 3 + n;
    if ((n = bio_read(b, 5)) != 31) return 6 + n;
    return 37 + bio_read(b, 7);
}

/* One packet (opj_t2_read_packet_header and _data): `*pos` advances past it. */
static int read_packet(tile_t *t, int c, int r, int64_t p, int layer, const uint8_t *data,
                       int64_t n, int64_t *pos) {
    comp_t *comp = &t->comps[c];
    res_t *res = &comp->res[r];
    const uint8_t *cur = data + *pos;
    int64_t left = n - *pos;
    if ((t->csty & 2) && left >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6, left -= 6;
    bio_t b;
    bio_init(&b, cur, left);
    int present = (int)bio_read(&b, 1);
    if (present) {
        for (int bi = 0; bi < res->nbands; bi++) {
            band_t *band = &res->bands[bi];
            if (band->empty) continue;
            prec_t *prec = &band->precs[p];
            for (int64_t k = 0; k < prec->cw * prec->ch; k++) {
                cblk_t *cb = &prec->cblks[k];
                int included;
                if (!cb->numsegs) included = tgt_decode(&prec->incl, &b, k, layer + 1);
                else included = (int)bio_read(&b, 1);
                if (!included) {
                    cb->numnewpasses = 0;
                    continue;
                }
                int32_t segno;
                if (!cb->numsegs) {
                    int32_t i = 0;
                    while (!tgt_decode(&prec->imsb, &b, k, i)) ++i;
                    cb->numbps = band->numbps + 1 - i;
                    cb->numlenbits = 3;
                    segno = 0;
                    if (seg_at(cb, 0, comp->cblksty)) return TDT_ERR_MEMORY;
                } else {
                    segno = cb->numsegs - 1;
                    if (cb->segs[segno].numpasses == cb->segs[segno].maxpasses) {
                        ++segno;
                        if (seg_at(cb, segno, comp->cblksty)) return TDT_ERR_MEMORY;
                    }
                }
                cb->numnewpasses = (int32_t)numpasses(&b);
                uint32_t inc = 0;
                while (bio_read(&b, 1)) {
                    if (++inc > 64) return TDT_ERR_CORRUPT;
                }
                cb->numlenbits += (int32_t)inc;
                int32_t left_passes = cb->numnewpasses;
                for (;;) {
                    seg_t *seg = &cb->segs[segno];
                    int32_t room = seg->maxpasses - seg->numpasses;
                    seg->numnewpasses = room < left_passes ? room : left_passes;
                    int bits = cb->numlenbits + floorlog2((uint32_t)seg->numnewpasses);
                    if (bits > 32) return TDT_ERR_CORRUPT;
                    seg->newlen = bits ? (int64_t)bio_read(&b, bits) : 0;
                    left_passes -= seg->numnewpasses;
                    if (left_passes <= 0) break;
                    ++segno;
                    if (seg_at(cb, segno, comp->cblksty)) return TDT_ERR_MEMORY;
                }
            }
        }
    }
    bio_inalign(&b);
    cur += b.bp - b.start;
    left = n - (cur - data);
    if ((t->csty & 4) && left >= 2 && cur[0] == 0xff && cur[1] == 0x92) cur += 2, left -= 2;
    if (present) {
        for (int bi = 0; bi < res->nbands; bi++) {
            band_t *band = &res->bands[bi];
            if (band->empty) continue;
            prec_t *prec = &band->precs[p];
            for (int64_t k = 0; k < prec->cw * prec->ch; k++) {
                cblk_t *cb = &prec->cblks[k];
                if (!cb->numnewpasses) continue;
                seg_t *seg;
                if (!cb->numsegs) {
                    seg = &cb->segs[0];
                    cb->numsegs = 1;
                } else {
                    seg = &cb->segs[cb->numsegs - 1];
                    if (seg->numpasses == seg->maxpasses) ++seg, ++cb->numsegs;
                }
                for (;;) {
                    if (seg->newlen > left) return TDT_ERR_TRUNCATED;
                    if (seg->newlen && append(cb, cur, seg->newlen)) return TDT_ERR_MEMORY;
                    cur += seg->newlen, left -= seg->newlen;
                    seg->numpasses += seg->numnewpasses;
                    cb->numnewpasses -= seg->numnewpasses;
                    seg->len += seg->newlen;
                    if (cb->numnewpasses <= 0) break;
                    ++seg, ++cb->numsegs;
                }
            }
        }
    }
    *pos = cur - data;
    return TDT_OK;
}

/* The packet order (OpenJPEG's pi.c): calls read_packet for each packet.
   The position-driven orders keep a bit a packet read, as pi.c's `include`,
   so that no packet is read twice. */
typedef struct {
    tile_t *t;
    const uint8_t *data;
    int64_t n, pos;
    uint8_t *include; /* NULL for LRCP and RLCP */
    int64_t *first;   /* each component's first precinct index, by resolution */
} walk_t;

static int visit(walk_t *w, int c, int r, int64_t p, int l) {
    tile_t *t = w->t;
    if (w->include) {
        int64_t index = (int64_t)l * t->nprecs + w->first[c * MAX_RES + r] + p;
        if (w->include[index >> 3] & (1 << (index & 7))) return TDT_OK;
        w->include[index >> 3] |= (uint8_t)(1 << (index & 7));
    }
    return read_packet(t, c, r, p, l, w->data, w->n, &w->pos);
}

/* The precinct of comp c, resolution r at position (x, y), or -1 (the
   position tests of pi.c's opj_pi_next_rpcl/pcrl/cprl). */
static int64_t precinct_at(tile_t *t, comp_t *comp, int r, int64_t x, int64_t y) {
    if (r >= comp->numres) return -1;
    res_t *res = &comp->res[r];
    int level = comp->numres - 1 - r;
    int64_t trx0 = ceil_div(t->tx0, comp->dx << level), try0 = ceil_div(t->ty0, comp->dy << level);
    int64_t trx1 = ceil_div(t->tx1, comp->dx << level), try1 = ceil_div(t->ty1, comp->dy << level);
    int rpx = res->pdx + level, rpy = res->pdy + level;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!(y % (comp->dy << rpy) == 0 || (y == t->ty0 && (try0 << level) % ((int64_t)1 << rpy))))
        return -1;
    if (!(x % (comp->dx << rpx) == 0 || (x == t->tx0 && (trx0 << level) % ((int64_t)1 << rpx))))
        return -1;
    if (res->pw == 0 || res->ph == 0 || trx0 == trx1 || try0 == try1) return -1;
    int64_t prci = floor_pow2(ceil_div(x, comp->dx << level), res->pdx) - floor_pow2(trx0, res->pdx);
    int64_t prcj = floor_pow2(ceil_div(y, comp->dy << level), res->pdy) - floor_pow2(try0, res->pdy);
    if (prci < 0 || prcj < 0 || prci >= res->pw || prcj >= res->ph) return -1;
    return prci + prcj * res->pw;
}

static void steps(tile_t *t, int only, int64_t *dx, int64_t *dy) {
    *dx = *dy = 0;
    for (int c = 0; c < t->ncomps; c++) {
        if (only >= 0 && c != only) continue;
        comp_t *comp = &t->comps[c];
        for (int r = 0; r < comp->numres; r++) {
            int sx = comp->res[r].pdx + comp->numres - 1 - r, sy = comp->res[r].pdy + comp->numres - 1 - r;
            if (sx < 32) {
                int64_t v = comp->dx << sx;
                *dx = *dx ? min64(*dx, v) : v;
            }
            if (sy < 32) {
                int64_t v = comp->dy << sy;
                *dy = *dy ? min64(*dy, v) : v;
            }
        }
    }
}

static int walk(walk_t *w) {
    tile_t *t = w->t;
    int rc = TDT_OK;
#define VISIT(c, r, p, l)                            \
    do {                                             \
        if ((rc = visit(w, (c), (r), (p), (l)))) return rc; \
    } while (0)
    if (t->prog == LRCP || t->prog == RLCP) {
        int outer = t->prog == LRCP ? t->nlayers : t->maxres;
        int inner = t->prog == LRCP ? t->maxres : t->nlayers;
        for (int a = 0; a < outer; a++)
            for (int b = 0; b < inner; b++) {
                int l = t->prog == LRCP ? a : b, r = t->prog == LRCP ? b : a;
                for (int c = 0; c < t->ncomps; c++) {
                    comp_t *comp = &t->comps[c];
                    if (r >= comp->numres) continue;
                    for (int64_t p = 0; p < comp->res[r].pw * comp->res[r].ph; p++) VISIT(c, r, p, l);
                }
            }
        return TDT_OK;
    }
    int64_t dx, dy;
    if (t->prog == RPCL || t->prog == PCRL) {
        steps(t, -1, &dx, &dy);
        if (!dx || !dy) return TDT_ERR_CORRUPT;
    }
    if (t->prog == RPCL) {
        for (int r = 0; r < t->maxres; r++)
            for (int64_t y = t->ty0; y < t->ty1; y += dy - (y % dy))
                for (int64_t x = t->tx0; x < t->tx1; x += dx - (x % dx))
                    for (int c = 0; c < t->ncomps; c++) {
                        int64_t p = precinct_at(t, &t->comps[c], r, x, y);
                        if (p < 0) continue;
                        for (int l = 0; l < t->nlayers; l++) VISIT(c, r, p, l);
                    }
    } else if (t->prog == PCRL) {
        for (int64_t y = t->ty0; y < t->ty1; y += dy - (y % dy))
            for (int64_t x = t->tx0; x < t->tx1; x += dx - (x % dx))
                for (int c = 0; c < t->ncomps; c++)
                    for (int r = 0; r < t->comps[c].numres; r++) {
                        int64_t p = precinct_at(t, &t->comps[c], r, x, y);
                        if (p < 0) continue;
                        for (int l = 0; l < t->nlayers; l++) VISIT(c, r, p, l);
                    }
    } else if (t->prog == CPRL) {
        for (int c = 0; c < t->ncomps; c++) {
            steps(t, c, &dx, &dy);
            if (!dx || !dy) return TDT_ERR_CORRUPT;
            for (int64_t y = t->ty0; y < t->ty1; y += dy - (y % dy))
                for (int64_t x = t->tx0; x < t->tx1; x += dx - (x % dx))
                    for (int r = 0; r < t->comps[c].numres; r++) {
                        int64_t p = precinct_at(t, &t->comps[c], r, x, y);
                        if (p < 0) continue;
                        for (int l = 0; l < t->nlayers; l++) VISIT(c, r, p, l);
                    }
        }
    } else {
        return TDT_ERR_CORRUPT;
    }
#undef VISIT
    return TDT_OK;
}

/* ---- tier-1: the MQ decoder -------------------------------------------- */

static const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
    0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
static const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                                 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                                 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                                 15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                                 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

/* Contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run, 18 uniform. */
enum { CTX_MAG = 14, CTX_RL = 17, CTX_UNI = 18, NCTX = 19 };

typedef struct {
    const uint8_t *bp, *end;
    uint32_t a, c;
    int ct;
    uint8_t state[NCTX], mps[NCTX];
} mqc_t;

static uint8_t mq_byte(const mqc_t *m, const uint8_t *p) { return p < m->end ? *p : 0xff; }

static void mq_bytein(mqc_t *m) {
    if (mq_byte(m, m->bp) == 0xff) {
        if (mq_byte(m, m->bp + 1) > 0x8f) {
            m->c += 0xff00;
            m->ct = 8;
        } else {
            m->bp++;
            m->c += (uint32_t)mq_byte(m, m->bp) << 9;
            m->ct = 7;
        }
    } else {
        m->bp++;
        m->c += (uint32_t)mq_byte(m, m->bp) << 8;
        m->ct = 8;
    }
}

static void mq_init(mqc_t *m, const uint8_t *p, int64_t n) {
    m->bp = p, m->end = p + n;
    m->c = (uint32_t)mq_byte(m, m->bp) << 16;
    mq_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
}

static void mq_reset(mqc_t *m) {
    memset(m->state, 0, sizeof m->state);
    memset(m->mps, 0, sizeof m->mps);
    m->state[CTX_UNI] = 46, m->state[CTX_RL] = 3, m->state[0] = 4;
}

static void mq_renorm(mqc_t *m) {
    do {
        if (m->ct == 0) mq_bytein(m);
        m->a <<= 1, m->c <<= 1, m->ct--;
    } while (!(m->a & 0x8000));
}

static int mq_decode(mqc_t *m, int cx) {
    int s = m->state[cx], d;
    uint32_t qe = QE[s];
    m->a -= qe;
    if ((m->c >> 16) < qe) { /* LPS exchange */
        if (m->a < qe) {
            d = m->mps[cx], m->state[cx] = NMPS[s];
        } else {
            d = 1 - m->mps[cx];
            if (SWITCH[s]) m->mps[cx] = (uint8_t)(1 - m->mps[cx]);
            m->state[cx] = NLPS[s];
        }
        m->a = qe;
        mq_renorm(m);
    } else {
        m->c -= qe << 16;
        if (!(m->a & 0x8000)) { /* MPS exchange */
            if (m->a < qe) {
                d = 1 - m->mps[cx];
                if (SWITCH[s]) m->mps[cx] = (uint8_t)(1 - m->mps[cx]);
                m->state[cx] = NLPS[s];
            } else {
                d = m->mps[cx], m->state[cx] = NMPS[s];
            }
            mq_renorm(m);
        } else {
            d = m->mps[cx];
        }
    }
    return d;
}

/* ---- tier-1: the coding passes ------------------------------------------ */

enum { F_SIG = 1, F_NEG = 2, F_VISIT = 4, F_REFINED = 8 };

typedef struct {
    int w, h, stride, orient;
    int32_t *data;
    uint8_t *flags; /* (h + 2) x (w + 2), a border of zeros */
    mqc_t mq;
} t1_t;

#define FL(t, i, j) ((t)->flags[((j) + 1) * (t)->stride + (i) + 1])

static int sig_at(const t1_t *t, int i, int j) { return FL(t, i, j) & F_SIG; }

static int has_sig_neighbour(const t1_t *t, int i, int j) {
    return sig_at(t, i - 1, j - 1) | sig_at(t, i, j - 1) | sig_at(t, i + 1, j - 1) | sig_at(t, i - 1, j) |
           sig_at(t, i + 1, j) | sig_at(t, i - 1, j + 1) | sig_at(t, i, j + 1) | sig_at(t, i + 1, j + 1);
}

/* Zero coding (T.800 Table D.1): h the horizontal neighbours, v the
   vertical, d the diagonal; the horizontally high-pass band (HL, band 1)
   swaps h and v. */
static int zc_ctx(const t1_t *t, int i, int j) {
    int h = sig_at(t, i - 1, j) + sig_at(t, i + 1, j);
    int v = sig_at(t, i, j - 1) + sig_at(t, i, j + 1);
    int d = sig_at(t, i - 1, j - 1) + sig_at(t, i + 1, j - 1) + sig_at(t, i - 1, j + 1) +
            sig_at(t, i + 1, j + 1);
    if (t->orient == 3) {
        int hv = h + v;
        if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
        if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
        if (d == 2) return hv == 0 ? 6 : 7;
        return 8;
    }
    if (t->orient == 1) {
        int s = h;
        h = v, v = s;
    }
    if (h == 0) {
        if (v == 0) return d == 0 ? 0 : d == 1 ? 1 : 2;
        return v == 1 ? 3 : 4;
    }
    if (h == 1) return v ? 7 : (d ? 6 : 5);
    return 8;
}

static int contribution(const t1_t *t, int i, int j) {
    uint8_t f = FL(t, i, j);
    return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0;
}

/* Sign decoding (Table D.3): the bit, after the XOR. */
static int decode_sign(t1_t *t, int i, int j) {
    int h = contribution(t, i - 1, j) + contribution(t, i + 1, j);
    int v = contribution(t, i, j - 1) + contribution(t, i, j + 1);
    h = h < -1 ? -1 : h > 1 ? 1 : h;
    v = v < -1 ? -1 : v > 1 ? 1 : v;
    int ctx, x = 0;
    if (h == 0 && v == 0) ctx = 9;
    else if (h == 0) ctx = 10, x = v < 0;
    else if (h == 1) ctx = v == 1 ? 13 : v == 0 ? 12 : 11;
    else ctx = v == -1 ? 13 : v == 0 ? 12 : 11, x = 1;
    return mq_decode(&t->mq, ctx) ^ x;
}

static void become_significant(t1_t *t, int i, int j, int32_t oneplushalf) {
    int neg = decode_sign(t, i, j);
    t->data[j * t->w + i] = neg ? -oneplushalf : oneplushalf;
    FL(t, i, j) |= (uint8_t)(F_SIG | (neg ? F_NEG : 0));
}

static void sigpass(t1_t *t, int bp) {
    int32_t one = (int32_t)1 << bp, oneplushalf = one | (one >> 1);
    for (int k = 0; k < t->h; k += 4)
        for (int i = 0; i < t->w; i++)
            for (int j = k; j < k + 4 && j < t->h; j++) {
                uint8_t f = FL(t, i, j);
                if ((f & (F_SIG | F_VISIT)) || !has_sig_neighbour(t, i, j)) continue;
                if (mq_decode(&t->mq, zc_ctx(t, i, j))) become_significant(t, i, j, oneplushalf);
                FL(t, i, j) |= F_VISIT;
            }
}

static void refpass(t1_t *t, int bp) {
    int32_t poshalf = ((int32_t)1 << bp) >> 1;
    for (int k = 0; k < t->h; k += 4)
        for (int i = 0; i < t->w; i++)
            for (int j = k; j < k + 4 && j < t->h; j++) {
                uint8_t f = FL(t, i, j);
                if ((f & (F_SIG | F_VISIT)) != F_SIG) continue;
                int ctx = (f & F_REFINED) ? CTX_MAG + 2 : has_sig_neighbour(t, i, j) ? CTX_MAG + 1 : CTX_MAG;
                int v = mq_decode(&t->mq, ctx);
                int32_t *d = &t->data[j * t->w + i];
                *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
                FL(t, i, j) |= F_REFINED;
            }
}

static void clnpass(t1_t *t, int bp, int segsym) {
    int32_t one = (int32_t)1 << bp, oneplushalf = one | (one >> 1);
    for (int k = 0; k < t->h; k += 4)
        for (int i = 0; i < t->w; i++) {
            int start = k;
            if (k + 4 <= t->h) {
                int quiet = 1;
                for (int j = k - 1; j <= k + 4 && quiet; j++)
                    for (int di = -1; di <= 1; di++)
                        if (FL(t, i + di, j) & F_SIG) quiet = 0;
                for (int j = k; j < k + 4 && quiet; j++)
                    if (FL(t, i, j) & F_VISIT) quiet = 0;
                if (quiet) {
                    if (!mq_decode(&t->mq, CTX_RL)) continue;
                    int run = mq_decode(&t->mq, CTX_UNI) << 1;
                    run |= mq_decode(&t->mq, CTX_UNI);
                    become_significant(t, i, k + run, oneplushalf);
                    start = k + run + 1;
                }
            }
            for (int j = start; j < k + 4 && j < t->h; j++) {
                if (FL(t, i, j) & (F_SIG | F_VISIT)) continue;
                if (mq_decode(&t->mq, zc_ctx(t, i, j))) become_significant(t, i, j, oneplushalf);
            }
            for (int j = k; j < k + 4 && j < t->h; j++) FL(t, i, j) &= (uint8_t)~F_VISIT;
        }
    if (segsym)
        for (int q = 0; q < 4; q++) mq_decode(&t->mq, CTX_UNI);
}

/* One code-block into the component's coefficients (opj_t1_decode_cblk and
   opj_t1_clbl_decode_processor). */
static int decode_cblk(comp_t *comp, band_t *band, int r, cblk_t *cb, int32_t *data, uint8_t *flags) {
    int w = (int)(cb->x1 - cb->x0), h = (int)(cb->y1 - cb->y0);
    if (w <= 0 || h <= 0) return TDT_OK;
    t1_t t = {w, h, w + 2, band->bandno, data, flags, {0}};
    memset(data, 0, (size_t)w * (size_t)h * sizeof(int32_t));
    memset(flags, 0, (size_t)(w + 2) * (size_t)(h + 2));
    int bp = comp->roishift + cb->numbps;
    if (bp >= 31) return TDT_ERR_RANGE;
    mq_reset(&t.mq);
    int passtype = 2;
    int64_t at = 0;
    for (int s = 0; s < cb->numsegs; s++) {
        seg_t *seg = &cb->segs[s];
        if (at + seg->len > cb->len) return TDT_ERR_CORRUPT;
        mq_init(&t.mq, cb->data + at, seg->len);
        at += seg->len;
        for (int pass = 0; pass < seg->numpasses && bp >= 1; pass++) {
            if (passtype == 0) sigpass(&t, bp);
            else if (passtype == 1) refpass(&t, bp);
            else clnpass(&t, bp, comp->cblksty & STY_SEGSYM);
            if (comp->cblksty & STY_RESET) mq_reset(&t.mq);
            if (++passtype == 3) passtype = 0, bp--;
        }
    }
    if (comp->roishift) {
        int32_t thresh = (int32_t)1 << comp->roishift;
        for (int64_t q = 0; q < (int64_t)w * h; q++) {
            int32_t v = data[q], mag = v < 0 ? -v : v;
            if (mag >= thresh) mag >>= comp->roishift, data[q] = v < 0 ? -mag : mag;
        }
    }
    /* Placed in the tile component at the band's offset in the resolution. */
    int64_t x = cb->x0 - band->x0, y = cb->y0 - band->y0;
    if (band->bandno & 1) x += comp->res[r - 1].x1 - comp->res[r - 1].x0;
    if (band->bandno & 2) y += comp->res[r - 1].y1 - comp->res[r - 1].y0;
    int64_t stride = comp->x1 - comp->x0;
    const float step = 0.5f * band->stepsize;
    for (int j = 0; j < h; j++) {
        const int32_t *src = data + j * w;
        if (comp->qmfbid == 1) {
            int32_t *dst = comp->ints + (y + j) * stride + x;
            for (int i = 0; i < w; i++) dst[i] = src[i] / 2;
        } else {
            float *dst = comp->floats + (y + j) * stride + x;
            for (int i = 0; i < w; i++) dst[i] = (float)src[i] * step;
        }
    }
    return TDT_OK;
}

/* ---- the inverse wavelets ----------------------------------------------- */

/* One line of n samples, lows first (sn of them) then highs, to the
   interleaved signal: the 5/3 lifting in integers. */
static void idwt53(int32_t *line, int32_t *x, int64_t n, int64_t sn, int cas) {
    if (n == 1) {
        if (cas) line[0] /= 2;
        return;
    }
    for (int64_t i = 0; i < sn; i++) x[2 * i + cas] = line[i];
    for (int64_t i = 0; i < n - sn; i++) x[2 * i + 1 - cas] = line[sn + i];
#define AT(p) x[(p) < 0 ? -(p) : (p) >= n ? 2 * (n - 1) - (p) : (p)]
    for (int64_t p = cas; p < n; p += 2) x[p] -= (AT(p - 1) + AT(p + 1) + 2) >> 2;
    for (int64_t p = 1 - cas; p < n; p += 2) x[p] += (AT(p - 1) + AT(p + 1)) >> 1;
#undef AT
    memcpy(line, x, (size_t)n * sizeof(int32_t));
}

/* The 9/7 lifting in float32 as OpenJPEG's opj_v8dwt_decode: lows times K,
   highs times two_invK, then each sample plus (left + right) * c for
   c = -delta (lows), -gamma (highs), -beta (lows), -alpha (highs), the
   signal mirrored at both ends. */
static void idwt97(float *line, float *x, int64_t n, int64_t sn, int cas) {
    static const float K = 1.230174105f, TWO_INVK = 1.625732422f;
    static const float DELTA = 0.443506852f, GAMMA = 0.882911075f, BETA = -0.052980118f,
                       ALPHA = -1.586134342f;
    if (n == 1) return;
    for (int64_t i = 0; i < sn; i++) x[2 * i + cas] = line[i];
    for (int64_t i = 0; i < n - sn; i++) x[2 * i + 1 - cas] = line[sn + i];
    for (int64_t p = cas; p < n; p += 2) x[p] = x[p] * K;
    for (int64_t p = 1 - cas; p < n; p += 2) x[p] = x[p] * TWO_INVK;
#define AT(p) x[(p) < 0 ? -(p) : (p) >= n ? 2 * (n - 1) - (p) : (p)]
    const float c[4] = {-DELTA, -GAMMA, -BETA, -ALPHA};
    for (int s = 0; s < 4; s++) {
        int64_t first = (s % 2 == 0) ? cas : 1 - cas;
        for (int64_t p = first; p < n; p += 2) {
            float sum = AT(p - 1) + AT(p + 1);
            float prod = sum * c[s];
            x[p] = x[p] + prod;
        }
    }
#undef AT
    memcpy(line, x, (size_t)n * sizeof(float));
}

static int inverse_dwt(comp_t *comp) {
    int64_t stride = comp->x1 - comp->x0;
    int64_t longest = max64(stride, comp->y1 - comp->y0);
    size_t size = (size_t)(longest > 0 ? longest : 1) * 2;
    int32_t *line = comp->ints ? malloc(size * sizeof(int32_t)) : NULL;
    float *fline = comp->floats ? malloc(size * sizeof(float)) : NULL;
    if (!line && !fline) return TDT_ERR_MEMORY;
    int32_t *tmp = line ? line + longest : NULL;
    float *ftmp = fline ? fline + longest : NULL;
    for (int r = 1; r < comp->numres; r++) {
        res_t *res = &comp->res[r], *low = &comp->res[r - 1];
        int64_t rw = res->x1 - res->x0, rh = res->y1 - res->y0;
        int64_t snh = low->x1 - low->x0, snv = low->y1 - low->y0;
        int cash = (int)(res->x0 & 1), casv = (int)(res->y0 & 1);
        if (rw <= 0 || rh <= 0) continue;
        for (int64_t j = 0; j < rh; j++) {
            if (line) idwt53(comp->ints + j * stride, tmp, rw, snh, cash);
            else idwt97(comp->floats + j * stride, ftmp, rw, snh, cash);
        }
        for (int64_t i = 0; i < rw; i++) {
            if (line) {
                for (int64_t j = 0; j < rh; j++) line[j] = comp->ints[j * stride + i];
                idwt53(line, tmp, rh, snv, casv);
                for (int64_t j = 0; j < rh; j++) comp->ints[j * stride + i] = line[j];
            } else {
                for (int64_t j = 0; j < rh; j++) fline[j] = comp->floats[j * stride + i];
                idwt97(fline, ftmp, rh, snv, casv);
                for (int64_t j = 0; j < rh; j++) comp->floats[j * stride + i] = fline[j];
            }
        }
    }
    free(line), free(fline);
    return TDT_OK;
}

/* lrintf's round half to even, for |v| below 2^31. */
static int64_t round_even(float v) {
    double d = (double)v;
    int64_t t = (int64_t)d;
    double frac = d - (double)t;
    if (frac > 0.5 || (frac == 0.5 && (t & 1))) t++;
    else if (frac < -0.5 || (frac == -0.5 && (t & 1))) t--;
    return t;
}

/* ---- the tile ----------------------------------------------------------- */

int tdt_j2k_tile(const uint8_t *data, int64_t n, const int64_t *params, int64_t nparams, int32_t *out,
                 int64_t nout) {
    if (n < 0 || nparams < P_HEADER) return TDT_ERR_ARGS;
    tile_t t;
    memset(&t, 0, sizeof t);
    t.ncomps = (int)params[P_NCOMPS], t.nlayers = (int)params[P_NLAYERS], t.prog = (int)params[P_PROG];
    t.csty = (int)params[P_CSTY], t.mct = (int)params[P_MCT];
    t.tx0 = params[P_TX0], t.ty0 = params[P_TY0], t.tx1 = params[P_TX1], t.ty1 = params[P_TY1];
    if (t.ncomps < 1 || t.ncomps > 16384 || nparams < P_HEADER + (int64_t)t.ncomps * C_FIELDS)
        return TDT_ERR_ARGS;
    if (t.nlayers < 1 || t.nlayers > 65535 || t.prog < 0 || t.prog > CPRL) return TDT_ERR_CORRUPT;
    if (t.tx0 < 0 || t.ty0 < 0 || t.tx1 <= t.tx0 || t.ty1 <= t.ty0 || t.tx1 > ((int64_t)1 << 32) ||
        t.ty1 > ((int64_t)1 << 32))
        return TDT_ERR_ARGS;
    t.comps = calloc((size_t)t.ncomps, sizeof(comp_t));
    if (!t.comps) return TDT_ERR_MEMORY;
    int rc = TDT_OK;
    int64_t total = 0;
    int32_t *cdata = NULL;
    uint8_t *cflags = NULL;
    walk_t w = {&t, data, n, 0, NULL, NULL};
    for (int c = 0; c < t.ncomps && rc == TDT_OK; c++) {
        const int64_t *cp = params + P_HEADER + (int64_t)c * C_FIELDS;
        comp_t *comp = &t.comps[c];
        comp->dx = cp[C_DX], comp->dy = cp[C_DY], comp->prec = (int)cp[C_PREC], comp->sgnd = (int)cp[C_SGND];
        comp->numres = (int)cp[C_NUMRES], comp->cblksty = (int)cp[C_CBLKSTY];
        comp->qmfbid = (int)cp[C_QMFBID], comp->roishift = (int)cp[C_ROISHIFT];
        if (comp->dx < 1 || comp->dx > 255 || comp->dy < 1 || comp->dy > 255 || comp->prec < 1 ||
            comp->prec > 31 || comp->numres < 1 || comp->numres > MAX_RES || cp[C_XCB] < 2 ||
            cp[C_YCB] < 2 || cp[C_XCB] + cp[C_YCB] > 12 || cp[C_NUMGBITS] < 0 || cp[C_NUMGBITS] > 7 ||
            comp->roishift < 0 || comp->roishift > 37 || (comp->qmfbid != 0 && comp->qmfbid != 1) ||
            (comp->cblksty & (STY_BYPASS | STY_VSC | ~0x3f))) {
            rc = TDT_ERR_CORRUPT;
            break;
        }
        for (int r = 0; r < comp->numres; r++)
            if (cp[C_PPX + r] < 0 || cp[C_PPX + r] > 15 || cp[C_PPY + r] < 0 || cp[C_PPY + r] > 15)
                rc = TDT_ERR_CORRUPT;
        for (int b = 0; b < 3 * comp->numres - 2; b++)
            if (cp[C_EXPN + b] < 0 || cp[C_EXPN + b] > 31 || cp[C_MANT + b] < 0 || cp[C_MANT + b] > 2047)
                rc = TDT_ERR_CORRUPT;
        if (comp->numres > t.maxres) t.maxres = comp->numres;
        if (rc == TDT_OK) rc = build_comp(&t, comp, cp);
        total += (comp->x1 - comp->x0) * (comp->y1 - comp->y0);
    }
    if (rc == TDT_OK && total > nout) rc = TDT_ERR_ARGS;
    if (rc == TDT_OK && t.prog != LRCP && t.prog != RLCP) {
        int64_t bits = (int64_t)t.nlayers * t.nprecs;
        w.first = malloc((size_t)t.ncomps * MAX_RES * sizeof(int64_t));
        if (bits > MAX_INCLUDE) rc = TDT_ERR_RANGE;
        else if (!w.first || !(w.include = calloc((size_t)(bits / 8 + 1), 1))) rc = TDT_ERR_MEMORY;
        for (int64_t c = 0, at = 0; c < t.ncomps && rc == TDT_OK; c++)
            for (int r = 0; r < t.comps[c].numres; r++) {
                w.first[c * MAX_RES + r] = at;
                at += t.comps[c].res[r].pw * t.comps[c].res[r].ph;
            }
    }
    if (rc == TDT_OK) rc = walk(&w);
    /* Tier-1, each code-block in a scratch of at most 4096 coefficients. */
    if (rc == TDT_OK) {
        cdata = malloc(4096 * sizeof(int32_t));
        cflags = malloc(66 * 66);
        if (!cdata || !cflags) rc = TDT_ERR_MEMORY;
    }
    for (int c = 0; c < t.ncomps && rc == TDT_OK; c++) {
        comp_t *comp = &t.comps[c];
        for (int r = 0; r < comp->numres && rc == TDT_OK; r++) {
            res_t *res = &comp->res[r];
            for (int b = 0; b < res->nbands && rc == TDT_OK; b++) {
                band_t *band = &res->bands[b];
                if (band->empty || !band->precs) continue;
                for (int64_t p = 0; p < res->pw * res->ph && rc == TDT_OK; p++) {
                    prec_t *prec = &band->precs[p];
                    for (int64_t k = 0; k < prec->cw * prec->ch && rc == TDT_OK; k++) {
                        cblk_t *cb = &prec->cblks[k];
                        int64_t cw = cb->x1 - cb->x0, ch = cb->y1 - cb->y0;
                        if (cw * ch > 4096 || cw > 1024 || ch > 1024) {
                            rc = TDT_ERR_CORRUPT;
                            break;
                        }
                        if (cw > 64 || ch > 64) { /* a tall or wide block: its own flags */
                            uint8_t *f = malloc((size_t)((cw + 2) * (ch + 2)));
                            if (!f) {
                                rc = TDT_ERR_MEMORY;
                                break;
                            }
                            rc = decode_cblk(comp, band, r, cb, cdata, f);
                            free(f);
                        } else {
                            rc = decode_cblk(comp, band, r, cb, cdata, cflags);
                        }
                    }
                }
            }
        }
        if (rc == TDT_OK) rc = inverse_dwt(comp);
    }
    /* The multiple component transform, on the first three components. */
    if (rc == TDT_OK && t.mct && t.ncomps >= 3) {
        comp_t *c0 = &t.comps[0], *c1 = &t.comps[1], *c2 = &t.comps[2];
        int64_t w0 = c0->x1 - c0->x0, h0 = c0->y1 - c0->y0;
        if (w0 != c1->x1 - c1->x0 || w0 != c2->x1 - c2->x0 || h0 != c1->y1 - c1->y0 ||
            h0 != c2->y1 - c2->y0 || c1->qmfbid != c0->qmfbid || c2->qmfbid != c0->qmfbid) {
            rc = TDT_ERR_CORRUPT;
        } else if (c0->qmfbid == 1) {
            for (int64_t q = 0; q < w0 * h0; q++) {
                int32_t y = c0->ints[q], u = c1->ints[q], v = c2->ints[q];
                int32_t g = y - ((u + v) >> 2);
                c0->ints[q] = v + g, c1->ints[q] = g, c2->ints[q] = u + g;
            }
        } else {
            float *f0 = c0->floats, *f1 = c1->floats, *f2 = c2->floats;
            for (int64_t q = 0; q < w0 * h0; q++) {
                float y = f0[q], u = f1[q], v = f2[q];
                float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f) - (v * 0.71414f);
                float b = y + (u * 1.772f);
                f0[q] = r, f1[q] = g, f2[q] = b;
            }
        }
    }
    /* The DC level shift and the clamp to the component's range. */
    int64_t at = 0;
    for (int c = 0; c < t.ncomps && rc == TDT_OK; c++) {
        comp_t *comp = &t.comps[c];
        int64_t count = (comp->x1 - comp->x0) * (comp->y1 - comp->y0);
        int64_t lo = comp->sgnd ? -((int64_t)1 << (comp->prec - 1)) : 0;
        int64_t hi = comp->sgnd ? ((int64_t)1 << (comp->prec - 1)) - 1 : ((int64_t)1 << comp->prec) - 1;
        int64_t shift = comp->sgnd ? 0 : (int64_t)1 << (comp->prec - 1);
        for (int64_t q = 0; q < count; q++) {
            int64_t v;
            if (comp->qmfbid == 1) {
                v = (int64_t)comp->ints[q] + shift;
            } else {
                float f = comp->floats[q];
                if (f > 2147483648.0f) v = hi;
                else if (f < -2147483648.0f || f != f) v = lo;
                else v = round_even(f) + shift;
            }
            out[at + q] = (int32_t)(v < lo ? lo : v > hi ? hi : v);
        }
        at += count;
    }
    free(cdata), free(cflags), free(w.include), free(w.first);
    free_tile(&t);
    return rc;
}
