/* VP8L, lossless WebP (libwebp's vp8l_dec.c), the counterpart of
   data/webp.py's plain _vp8l_decode: the header, the transforms' data, the
   entropy-coded image (prefix codes by tiles of a meta image, LZ77 copies
   with the 120-entry distance map, the colour cache), then the transforms
   undone in reverse order (predictor, cross colour, subtract green, colour
   indexing), written out as RGB.

   The bit stream is read LSB first, zeros past its end. A prefix code is a
   table of its codes of up to 8 bits (symbol << 4 | length) and a canonical
   walk for the longer ones; a code of one symbol reads no bits. As in the
   plain version, a read that a length field announces fails as soon as it
   passes the end, and the pixels of the entropy-coded image fail after the
   pixel (or copy) that passes it. */
#include <stdlib.h>
#include <string.h>

#include "decode.h"

#define MAX_CACHE_BITS 11
#define NUM_CODES 5
#define LONG 0xFFFF

static const uint8_t CODE_LENGTH_ORDER[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                              7,  8,  9, 10, 11, 12, 13, 14, 15};
static const uint8_t CODE_TO_PLANE[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

typedef struct {
    const uint8_t *p;
    int64_t nbytes, nbits, pos;
} bits_t;

typedef struct {
    int single;       /* the one symbol of a one-symbol code, else -1 */
    uint16_t root[256];
    int first[16], count[16], offset[16];
    uint16_t *sorted; /* the symbols in code order */
} code_t;

typedef struct {
    code_t codes[NUM_CODES]; /* green (+ lengths, cache), red, blue, alpha, distance */
} group_t;

/* 64 bits from byte pos >> 3 on, shifted to bit pos: at least 56 valid. */
static inline uint64_t peek(const bits_t *b) {
    int64_t i = b->pos >> 3;
    uint64_t w = 0;
    for (int k = 0; k < 8; k++)
        if (i + k < b->nbytes) w |= (uint64_t)b->p[i + k] << (8 * k);
    return w >> (b->pos & 7);
}

/* n (0-24) bits, failing where they pass the end (_LosslessBits.read). */
static inline int read_bits(bits_t *b, int n, int *rc) {
    if (b->pos + n > b->nbits) {
        *rc = TDT_ERR_TRUNCATED;
        return 0;
    }
    int v = (int)(peek(b) & ((1u << n) - 1));
    b->pos += n;
    return v;
}

/* The next symbol, unchecked against the end. */
static inline int read_symbol(bits_t *b, const code_t *c) {
    if (c->single >= 0) return c->single;
    uint64_t w = peek(b);
    uint16_t e = c->root[w & 255];
    if (e != LONG) {
        b->pos += e & 15;
        return e >> 4;
    }
    int code = 0;
    for (int len = 1; len <= 15; len++) {
        code = code << 1 | (int)((w >> (len - 1)) & 1);
        if (code - c->first[len] < c->count[len]) {
            b->pos += len;
            return c->sorted[c->offset[len] + code - c->first[len]];
        }
    }
    return 0; /* not reached: a built code is complete */
}

/* _read_symbol: the symbol, failing where it passes the end. */
static inline int read_symbol_checked(bits_t *b, const code_t *c, int *rc) {
    int s = read_symbol(b, c);
    if (b->pos > b->nbits) *rc = TDT_ERR_TRUNCATED;
    return s;
}

static void code_free(code_t *c) {
    free(c->sorted);
    c->sorted = NULL;
}

/* _prefix_table: the canonical code of `lengths` (0-15 each); fails on an
   empty or incomplete code. */
static int code_build(code_t *c, const uint8_t *lengths, int alphabet) {
    memset(c, 0, sizeof(*c));
    c->single = -1;
    int used = 0, last = 0;
    int64_t kraft = 0;
    for (int s = 0; s < alphabet; s++) {
        if (lengths[s]) {
            used++, last = s;
            kraft += (int64_t)1 << (15 - lengths[s]);
            c->count[lengths[s]]++;
        }
    }
    if (used == 0) return TDT_ERR_CORRUPT;
    if (used == 1) {
        c->single = last;
        return TDT_OK;
    }
    if (kraft != (int64_t)1 << 15) return TDT_ERR_CORRUPT;
    c->sorted = malloc(sizeof(uint16_t) * (size_t)used);
    if (!c->sorted) return TDT_ERR_MEMORY;
    int code = 0, at = 0;
    for (int len = 1; len <= 15; len++) {
        c->first[len] = code, c->offset[len] = at;
        code = (code + c->count[len]) << 1;
        at += c->count[len];
    }
    int next[16];
    memcpy(next, c->offset, sizeof(next));
    for (int s = 0; s < alphabet; s++)
        if (lengths[s]) c->sorted[next[lengths[s]]++] = (uint16_t)s;
    for (int i = 0; i < 256; i++) c->root[i] = LONG;
    for (int len = 1; len <= 8; len++) {
        for (int k = 0; k < c->count[len]; k++) {
            int value = c->first[len] + k, rev = 0;
            for (int bit = 0; bit < len; bit++) rev |= ((value >> bit) & 1) << (len - 1 - bit);
            uint16_t e = (uint16_t)(c->sorted[c->offset[len] + k] << 4 | len);
            for (int i = rev; i < 256; i += 1 << len) c->root[i] = e;
        }
    }
    return TDT_OK;
}

/* _read_code: a simple code (one or two symbols of length 1) or a normal one
   (its code lengths coded by a code-length code, with repeats). */
static int read_code(bits_t *b, int alphabet, code_t *out) {
    int rc = TDT_OK;
    uint8_t *lengths = calloc((size_t)alphabet, 1);
    if (!lengths) return TDT_ERR_MEMORY;
    if (read_bits(b, 1, &rc)) {
        int count = read_bits(b, 1, &rc) + 1;
        int first = read_bits(b, read_bits(b, 1, &rc) ? 8 : 1, &rc);
        int second = count == 2 ? read_bits(b, 8, &rc) : -1;
        if (rc == TDT_OK && (first >= alphabet || second >= alphabet)) rc = TDT_ERR_CORRUPT;
        if (rc == TDT_OK) {
            lengths[first] = 1;
            if (second >= 0) lengths[second] = 1;
        }
    } else {
        uint8_t cl_lengths[19] = {0};
        int n = read_bits(b, 4, &rc) + 4;
        for (int i = 0; i < n && rc == TDT_OK; i++) cl_lengths[CODE_LENGTH_ORDER[i]] = (uint8_t)read_bits(b, 3, &rc);
        code_t cl;
        cl.sorted = NULL;
        if (rc == TDT_OK) rc = code_build(&cl, cl_lengths, 19);
        int max_symbol = alphabet;
        if (rc == TDT_OK && read_bits(b, 1, &rc)) {
            int nbits = 2 + 2 * read_bits(b, 3, &rc);
            max_symbol = 2 + read_bits(b, nbits, &rc);
            if (rc == TDT_OK && max_symbol > alphabet) rc = TDT_ERR_CORRUPT;
        }
        int symbol = 0, prev = 8;
        while (rc == TDT_OK && symbol < alphabet) {
            if (max_symbol == 0) break;
            max_symbol--;
            int length = read_symbol_checked(b, &cl, &rc);
            if (rc != TDT_OK) break;
            if (length < 16) {
                lengths[symbol++] = (uint8_t)length;
                if (length) prev = length;
                continue;
            }
            static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
            int repeat = read_bits(b, extra[length - 16], &rc) + offset[length - 16];
            if (rc != TDT_OK) break;
            if (symbol + repeat > alphabet) {
                rc = TDT_ERR_CORRUPT;
                break;
            }
            memset(lengths + symbol, length == 16 ? prev : 0, (size_t)repeat);
            symbol += repeat;
        }
        code_free(&cl);
    }
    if (rc == TDT_OK) rc = code_build(out, lengths, alphabet);
    free(lengths);
    return rc;
}

static inline int64_t sub_size(int64_t size, int bits) { return (size + (1 << bits) - 1) >> bits; }

/* _copy_length: a length or distance prefix symbol and its extra bits. */
static inline int64_t copy_length(bits_t *b, int symbol, int *rc) {
    if (symbol < 4) return symbol + 1;
    int extra = (symbol - 2) >> 1;
    return ((int64_t)(2 + (symbol & 1)) << extra) + read_bits(b, extra, rc) + 1;
}

static void groups_free(group_t *groups, int64_t n) {
    if (!groups) return;
    for (int64_t g = 0; g < n; g++)
        for (int k = 0; k < NUM_CODES; k++) code_free(&groups[g].codes[k]);
    free(groups);
}

/* _entropy_image: the ARGB pixels of one entropy-coded image, into a new
   buffer (*out) of width x height. */
static int entropy_image(bits_t *b, int64_t width, int64_t height, int top, uint32_t **out) {
    int rc = TDT_OK;
    *out = NULL;
    int cache_bits = 0;
    if (read_bits(b, 1, &rc)) {
        cache_bits = read_bits(b, 4, &rc);
        if (rc == TDT_OK && (cache_bits < 1 || cache_bits > MAX_CACHE_BITS)) return TDT_ERR_CORRUPT;
    }
    if (rc != TDT_OK) return rc;
    uint32_t *meta = NULL;
    int meta_bits = 0;
    int64_t meta_width = 1, n_groups = 1;
    if (top && read_bits(b, 1, &rc)) {
        meta_bits = read_bits(b, 3, &rc) + 2;
        if (rc != TDT_OK) return rc;
        meta_width = sub_size(width, meta_bits);
        int64_t meta_height = sub_size(height, meta_bits);
        rc = entropy_image(b, meta_width, meta_height, 0, &meta);
        if (rc != TDT_OK) return rc;
        int64_t most = 0;
        for (int64_t i = 0; i < meta_width * meta_height; i++) {
            meta[i] = (meta[i] >> 8) & 0xFFFF;
            if (meta[i] > most) most = meta[i];
        }
        n_groups = most + 1;
    }
    if (rc != TDT_OK) return rc;
    int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int alphabets[NUM_CODES] = {280 + cache_size, 256, 256, 256, 40};
    group_t *groups = calloc((size_t)n_groups, sizeof(group_t));
    uint32_t *cache = cache_size ? calloc((size_t)cache_size, sizeof(uint32_t)) : NULL;
    int64_t total = width * height;
    uint32_t *pixels = malloc(sizeof(uint32_t) * (size_t)(total ? total : 1));
    if (!groups || (cache_size && !cache) || !pixels) rc = TDT_ERR_MEMORY;
    int64_t built = 0;
    for (; built < n_groups && rc == TDT_OK; built++) {
        for (int k = 0; k < NUM_CODES && rc == TDT_OK; k++) {
            groups[built].codes[k].sorted = NULL;
            rc = read_code(b, alphabets[k], &groups[built].codes[k]);
        }
    }
    int shift = 32 - cache_bits;
    int64_t i = 0, x = 0, y = 0;
    while (rc == TDT_OK && i < total) {
        const group_t *g = &groups[meta ? meta[(y >> meta_bits) * meta_width + (x >> meta_bits)] : 0];
        int code = read_symbol(b, &g->codes[0]);
        int64_t from = i;
        if (code < 256) {
            int red = read_symbol(b, &g->codes[1]);
            int blue = read_symbol(b, &g->codes[2]);
            int alpha = read_symbol(b, &g->codes[3]);
            pixels[i++] = (uint32_t)alpha << 24 | (uint32_t)red << 16 | (uint32_t)code << 8
                        | (uint32_t)blue;
            if (++x == width) x = 0, y++;
        } else if (code < 280) {
            int64_t length = copy_length(b, code - 256, &rc);
            if (rc != TDT_OK) break;
            int dist_symbol = read_symbol_checked(b, &g->codes[4], &rc);
            if (rc != TDT_OK) break;
            int64_t plane = copy_length(b, dist_symbol, &rc), dist;
            if (rc != TDT_OK) break;
            if (plane > 120) {
                dist = plane - 120;
            } else {
                int c = CODE_TO_PLANE[plane - 1];
                dist = (c >> 4) * width + 8 - (c & 15);
                if (dist < 1) dist = 1;
            }
            if (dist > i || i + length > total) {
                rc = TDT_ERR_RANGE;
                break;
            }
            for (int64_t k = 0; k < length; k++, i++) pixels[i] = pixels[i - dist];
            x += length;
            y += x / width;
            x %= width;
        } else {
            if (!cache || code - 280 >= cache_size) {
                rc = TDT_ERR_CORRUPT;
                break;
            }
            pixels[i++] = cache[code - 280];
            if (++x == width) x = 0, y++;
        }
        if (cache)  /* every pixel into the cache, in order */
            for (int64_t k = from; k < i; k++) cache[(uint32_t)(0x1E35A7BDu * pixels[k]) >> shift] = pixels[k];
        if (b->pos > b->nbits) rc = TDT_ERR_TRUNCATED;
    }
    groups_free(groups, built);
    free(cache);
    free(meta);
    if (rc != TDT_OK) {
        free(pixels);
        return rc;
    }
    *out = pixels;
    return TDT_OK;
}

/* Per-channel sum of two ARGB pixels, mod 256. */
static inline uint32_t add_px(uint32_t a, uint32_t b) {
    return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u)
         | (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}

static inline uint32_t avg_px(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }

static inline int clamp8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

static inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 24; s >= 0; s -= 8)
        out |= (uint32_t)clamp8((int)((a >> s) & 255) + (int)((b >> s) & 255) - (int)((c >> s) & 255)) << s;
    return out;
}

static inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 24; s >= 0; s -= 8) {
        int ca = (int)((a >> s) & 255), cb = (int)((b >> s) & 255);
        out |= (uint32_t)clamp8(ca + (ca - cb) / 2) << s;
    }
    return out;
}

static inline uint32_t select_px(uint32_t top, uint32_t left, uint32_t top_left) {
    int d = 0;
    for (int s = 24; s >= 0; s -= 8) {
        int t = (int)((top >> s) & 255), l = (int)((left >> s) & 255), c = (int)((top_left >> s) & 255);
        d += abs(l - c) - abs(t - c);
    }
    return d <= 0 ? top : left;
}

static inline uint32_t predict(int mode, uint32_t left, uint32_t top, uint32_t top_right,
                               uint32_t top_left) {
    switch (mode) {
    case 0: return 0xFF000000u;
    case 1: return left;
    case 2: return top;
    case 3: return top_right;
    case 4: return top_left;
    case 5: return avg_px(avg_px(left, top_right), top);
    case 6: return avg_px(left, top_left);
    case 7: return avg_px(left, top);
    case 8: return avg_px(top_left, top);
    case 9: return avg_px(top, top_right);
    case 10: return avg_px(avg_px(left, top_left), avg_px(top, top_right));
    case 11: return select_px(top, left, top_left);
    case 12: return clamp_add_sub_full(left, top, top_left);
    default: return clamp_add_sub_half(avg_px(left, top), top_left); /* 13, and 14-15 as the plain version */
    }
}

static void inverse_predictor(uint32_t *px, int64_t width, int64_t height, int bits,
                              const uint32_t *modes) {
    int64_t tiles = sub_size(width, bits);
    for (int64_t x = 0; x < width; x++) px[x] = add_px(px[x], x == 0 ? 0xFF000000u : px[x - 1]);
    for (int64_t y = 1; y < height; y++) {
        uint32_t *row = px + y * width, *up = row - width;
        row[0] = add_px(row[0], up[0]);
        const uint32_t *tile = modes + (y >> bits) * tiles;
        for (int64_t x = 1; x < width; x++) {
            int mode = (int)((tile[x >> bits] >> 8) & 15);
            /* The last column's top-right is the first pixel of this row. */
            row[x] = add_px(row[x], predict(mode, row[x - 1], up[x], up[x + 1], up[x - 1]));
        }
    }
}

static inline int signed8(uint32_t v) { return (int)((v & 255) ^ 128) - 128; }

static void inverse_cross_color(uint32_t *px, int64_t width, int64_t height, int bits,
                                const uint32_t *codes) {
    int64_t tiles = sub_size(width, bits);
    for (int64_t y = 0; y < height; y++) {
        for (int64_t x = 0; x < width; x++) {
            uint32_t code = codes[(y >> bits) * tiles + (x >> bits)], argb = px[y * width + x];
            int g2r = signed8(code), g2b = signed8(code >> 8), r2b = signed8(code >> 16);
            int green = signed8(argb >> 8);
            int red = (int)(((argb >> 16) + (uint32_t)((g2r * green) >> 5)) & 255);
            int blue = (int)((argb + (uint32_t)((g2b * green) >> 5) + (uint32_t)((r2b * signed8((uint32_t)red)) >> 5)) & 255);
            px[y * width + x] = (argb & 0xFF00FF00u) | (uint32_t)red << 16 | (uint32_t)blue;
        }
    }
}

typedef struct {
    int kind, bits;
    int64_t xsize;
    uint32_t *data;
} transform_t;

int tdt_vp8l_decode(const uint8_t *data, int64_t n, uint8_t *rgb, int64_t width_in,
                    int64_t height_in) {
    if (n < 5 || data[0] != 0x2F) return TDT_ERR_CORRUPT;
    bits_t b = {data, n, 8 * n, 0};
    int rc = TDT_OK;
    read_bits(&b, 8, &rc);
    int64_t width = read_bits(&b, 14, &rc) + 1, height = read_bits(&b, 14, &rc) + 1;
    read_bits(&b, 1, &rc); /* alpha is used: dropped */
    if (rc != TDT_OK) return rc;
    if (width != width_in || height != height_in) return TDT_ERR_ARGS;
    if (read_bits(&b, 3, &rc) != 0) return TDT_ERR_CORRUPT;
    if (rc != TDT_OK) return rc;
    transform_t transforms[4];
    int n_transforms = 0, seen = 0;
    int64_t xsize = width;
    while (rc == TDT_OK && read_bits(&b, 1, &rc)) {
        int kind = read_bits(&b, 2, &rc);
        if (rc != TDT_OK) break;
        if (seen & (1 << kind)) {
            rc = TDT_ERR_CORRUPT;
            break;
        }
        seen |= 1 << kind;
        transform_t *t = &transforms[n_transforms];
        t->kind = kind, t->xsize = xsize, t->bits = 0, t->data = NULL;
        if (kind == 0 || kind == 1) {
            t->bits = read_bits(&b, 3, &rc) + 2;
            if (rc == TDT_OK)
                rc = entropy_image(&b, sub_size(xsize, t->bits), sub_size(height, t->bits), 0, &t->data);
        } else if (kind == 3) {
            int count = read_bits(&b, 8, &rc) + 1;
            t->bits = count > 16 ? 0 : count > 4 ? 1 : count > 2 ? 2 : 3;
            uint32_t *palette = NULL;
            if (rc == TDT_OK) rc = entropy_image(&b, count, 1, 0, &palette);
            if (rc == TDT_OK) {
                t->data = calloc(256, sizeof(uint32_t));
                if (!t->data) rc = TDT_ERR_MEMORY;
                else
                    for (int k = 0; k < count; k++) t->data[k] = k ? add_px(palette[k], t->data[k - 1]) : palette[k];
            }
            free(palette);
            xsize = sub_size(xsize, t->bits);
        }
        n_transforms++;
    }
    uint32_t *px = NULL, *spare = NULL;
    if (rc == TDT_OK) rc = entropy_image(&b, xsize, height, 1, &px);
    for (int k = n_transforms - 1; k >= 0 && rc == TDT_OK; k--) {
        transform_t *t = &transforms[k];
        int64_t size = t->xsize;
        if (t->kind == 0) {
            inverse_predictor(px, size, height, t->bits, t->data);
        } else if (t->kind == 1) {
            inverse_cross_color(px, size, height, t->bits, t->data);
        } else if (t->kind == 2) {
            for (int64_t i = 0; i < size * height; i++) {
                uint32_t argb = px[i], green = (argb >> 8) & 255;
                px[i] = (argb & 0xFF00FF00u) | (((argb >> 16) + green) & 255) << 16 | ((argb + green) & 255);
            }
        } else {
            int64_t packed = sub_size(size, t->bits);
            int depth = 8 >> t->bits;
            spare = malloc(sizeof(uint32_t) * (size_t)(size * height));
            if (!spare) {
                rc = TDT_ERR_MEMORY;
                break;
            }
            for (int64_t y = 0; y < height; y++)
                for (int64_t x = 0; x < size; x++) {
                    uint32_t v = (px[y * packed + (x >> t->bits)] >> 8) & 255;
                    int index = (int)((v >> (depth * (x & ((1 << t->bits) - 1)))) & ((1u << depth) - 1));
                    spare[y * size + x] = t->data[index];
                }
            free(px);
            px = spare;
            spare = NULL;
        }
    }
    if (rc == TDT_OK)
        for (int64_t i = 0; i < width * height; i++) {
            rgb[3 * i] = (uint8_t)(px[i] >> 16), rgb[3 * i + 1] = (uint8_t)(px[i] >> 8);
            rgb[3 * i + 2] = (uint8_t)px[i];
        }
    free(px);
    for (int k = 0; k < n_transforms; k++) free(transforms[k].data);
    return rc;
}
