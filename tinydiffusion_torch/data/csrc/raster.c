/* The simple raster formats' packet streams: TGA's and PCX's run-length
   packets and QOI's op stream, the counterparts of data/tga.py's and
   data/pcx.py's _rle_reference and data/qoi.py's _ops_reference.

   tdt_tga_rle expands the packets of an RLE TGA image (Pillow's
   TgaRleDecode.c, as it reads): a header byte, its low 7 bits + 1 pixels of
   `depth` bytes; with the top bit, one pixel repeated (a run), else that
   many literal pixels. The rows are one buffer in file order: a literal may
   run on into the next rows, a run that would cross the end of its row is
   an overrun (TDT_ERR_RANGE), and the packets end where the image is full;
   a literal past the last row is cut there, but its bytes must all be in
   the file. A file that ends first is TDT_ERR_TRUNCATED.

   tdt_qoi_decode runs the ops of a QOI image (Pillow's QoiDecoder) into
   `pixels` RGB pixels: the previous pixel starts as (0, 0, 0, 255) and the
   table of 64 seen pixels as zeros, an index op of a slot never written
   gives (0, 0, 0, 0), and every op but a run writes its pixel to the slot of
   its hash (r * 3 + g * 5 + b * 7 + a * 11) % 64; a run past the last pixel
   is cut there. An op whose bytes the file does not hold is
   TDT_ERR_TRUNCATED.

   tdt_pcx_rle expands a PCX image's packets (Pillow's PcxDecode.c) into
   `rows` lines of `line` bytes: a byte whose top two bits are set repeats
   the next byte its low six bits times, any other byte is itself. A run
   that would cross the end of its line is Pillow's overrun
   (TDT_ERR_RANGE); the packets end where the last line is full, and a file
   that ends first is TDT_ERR_TRUNCATED. */
#include <string.h>

#include "decode.h"

int tdt_tga_rle(const uint8_t *data, int64_t n, int64_t depth, uint8_t *out,
                int64_t row_bytes, int64_t rows) {
    if (n < 0 || depth < 1 || depth > 4 || row_bytes < depth || rows < 1) return TDT_ERR_ARGS;
    int64_t total = row_bytes * rows, at = 0, pos = 0;
    while (at < total) {
        if (pos >= n) return TDT_ERR_TRUNCATED;
        int head = data[pos];
        int64_t count = depth * ((head & 0x7F) + 1);
        if (head & 0x80) {
            if (pos + 1 + depth > n) return TDT_ERR_TRUNCATED;
            if (at % row_bytes + count > row_bytes) return TDT_ERR_RANGE;
            for (int64_t i = 0; i < count; i += depth) memcpy(out + at + i, data + pos + 1, depth);
            pos += 1 + depth;
        } else {
            if (pos + 1 + count > n) return TDT_ERR_TRUNCATED;
            memcpy(out + at, data + pos + 1, count < total - at ? count : total - at);
            pos += 1 + count;
        }
        at += count;
    }
    return TDT_OK;
}

int tdt_qoi_decode(const uint8_t *data, int64_t n, uint8_t *rgb, int64_t pixels) {
    if (n < 0 || pixels < 0) return TDT_ERR_ARGS;
    uint8_t seen[64][4], px[4] = {0, 0, 0, 255};
    memset(seen, 0, sizeof seen);
    int64_t pos = 0, done = 0;
    while (done < pixels) {
        if (pos >= n) return TDT_ERR_TRUNCATED;
        int op = data[pos++];
        if (op == 0xFE || op == 0xFF) { /* RGB (the alpha kept), RGBA */
            int k = op == 0xFE ? 3 : 4;
            if (pos + k > n) return TDT_ERR_TRUNCATED;
            memcpy(px, data + pos, k);
            pos += k;
        } else if (op >> 6 == 0) { /* INDEX */
            memcpy(px, seen[op & 63], 4);
        } else if (op >> 6 == 1) { /* DIFF */
            px[0] = (uint8_t)(px[0] + ((op >> 4) & 3) - 2);
            px[1] = (uint8_t)(px[1] + ((op >> 2) & 3) - 2);
            px[2] = (uint8_t)(px[2] + (op & 3) - 2);
        } else if (op >> 6 == 2) { /* LUMA */
            if (pos >= n) return TDT_ERR_TRUNCATED;
            int second = data[pos++], dg = (op & 63) - 32;
            px[0] = (uint8_t)(px[0] + dg + (second >> 4) - 8);
            px[1] = (uint8_t)(px[1] + dg);
            px[2] = (uint8_t)(px[2] + dg + (second & 15) - 8);
        } else { /* RUN: the previous pixel again, the table untouched */
            int64_t run = (op & 63) + 1;
            for (; run > 0 && done < pixels; run--, done++) memcpy(rgb + 3 * done, px, 3);
            continue;
        }
        memcpy(seen[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
        memcpy(rgb + 3 * done++, px, 3);
    }
    return TDT_OK;
}

int tdt_pcx_rle(const uint8_t *data, int64_t n, uint8_t *out, int64_t line, int64_t rows) {
    if (n < 0 || line < 1 || rows < 1) return TDT_ERR_ARGS;
    int64_t total = line * rows, at = 0, pos = 0;
    while (at < total) {
        if (pos >= n) return TDT_ERR_TRUNCATED;
        int b = data[pos];
        if ((b & 0xC0) == 0xC0) {
            if (pos + 1 >= n) return TDT_ERR_TRUNCATED;
            int64_t count = b & 0x3F;
            if (at % line + count > line) return TDT_ERR_RANGE;
            memset(out + at, data[pos + 1], (size_t)count);
            at += count;
            pos += 2;
        } else {
            out[at++] = (uint8_t)b;
            pos++;
        }
    }
    return TDT_OK;
}
