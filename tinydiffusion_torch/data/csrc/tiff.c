/* TIFF's LZW and PackBits, the counterparts of data/tiff.py's plain
   _lzw_decode and _packbits_decode.

   Each writes at most `count` bytes to `out` and sets `*written` to how many
   it wrote (fewer when the data ends first, or at LZW's end code); it
   returns 0 or a negative code.

   LZW is libtiff's new style: 9- to 12-bit codes, most significant bit
   first; 256 clears the table, 257 ends the data; the code width grows when
   the next entry would be the last of the current width ("early change").
   Each table entry is its prefix's code and its last byte; a string is
   written back to front from its length. */
#include "decode.h"

#define MAX_CODES 4096
#define CLEAR 256
#define END 257

int tdt_tiff_lzw(const uint8_t *data, int64_t n, uint8_t *out, int64_t count,
                 int64_t *written_out) {
    if (n < 0 || count < 0) return TDT_ERR_ARGS;
    if (n >= 2 && data[0] == 0 && (data[1] & 1)) return TDT_ERR_CORRUPT; /* old-style LZW */
    uint16_t prefix[MAX_CODES], length[MAX_CODES];
    uint8_t last[MAX_CODES], first[MAX_CODES];
    for (int i = 0; i < 256; i++) prefix[i] = 0, last[i] = first[i] = (uint8_t)i, length[i] = 1;
    int size = 9, table = END + 1, prev = -1;
    uint32_t acc = 0;
    int nacc = 0;
    int64_t pos = 0, written = 0;
    while (written < count) {
        while (nacc < size && pos < n) {
            acc = (acc << 8) | data[pos++];
            nacc += 8;
        }
        if (nacc < size) break; /* the data ends without an end code */
        int code = (int)((acc >> (nacc - size)) & ((1u << size) - 1));
        nacc -= size;
        acc &= (1u << nacc) - 1;
        if (code == CLEAR) {
            table = END + 1, size = 9, prev = -1;
            continue;
        }
        if (code == END) break;
        int entry;
        if (code < table) {
            entry = code;
            if (prev >= 0 && table < MAX_CODES) { /* prev + the entry's first byte */
                prefix[table] = (uint16_t)prev, last[table] = first[code];
                first[table] = first[prev], length[table] = (uint16_t)(length[prev] + 1);
                table++;
                if (table == (1 << size) - 1 && size < 12) size++;
            }
        } else if (code == table && prev >= 0) { /* prev + prev's first byte */
            if (table >= MAX_CODES) return TDT_ERR_CODE;
            prefix[table] = (uint16_t)prev, last[table] = first[prev];
            first[table] = first[prev], length[table] = (uint16_t)(length[prev] + 1);
            entry = table++;
            if (table == (1 << size) - 1 && size < 12) size++;
        } else {
            return TDT_ERR_CODE;
        }
        /* The entry's bytes, back to front; those past `count` are dropped. */
        int64_t at = written + length[entry];
        for (int c = entry; at > written; c = prefix[c]) {
            at--;
            if (at < count) out[at] = last[c];
        }
        written += length[entry];
        prev = entry;
    }
    *written_out = written < count ? written : count;
    return TDT_OK;
}

int tdt_tiff_packbits(const uint8_t *data, int64_t n, uint8_t *out, int64_t count,
                      int64_t *written_out) {
    if (n < 0 || count < 0) return TDT_ERR_ARGS;
    int64_t pos = 0, written = 0;
    while (written < count && pos < n) {
        int h = data[pos++];
        if (h < 128) { /* h + 1 literal bytes */
            if (pos + h + 1 > n) return TDT_ERR_TRUNCATED;
            for (int i = 0; i <= h; i++, written++)
                if (written < count) out[written] = data[pos + i];
            pos += h + 1;
        } else if (h > 128) { /* the next byte, 257 - h times */
            if (pos >= n) return TDT_ERR_TRUNCATED;
            for (int i = 0; i < 257 - h; i++, written++)
                if (written < count) out[written] = data[pos];
            pos++;
        }
    }
    *written_out = written < count ? written : count;
    return TDT_OK;
}
