/* GIF's LZW (variable code size from min_size + 1 to 12 bits, LSB first;
   clear and end codes; a full table kept until the next clear), the
   counterpart of data/gif.py's plain _lzw_decode.

   tdt_gif_lzw writes at most `count` indices to `out` and sets `*written`
   to how many it wrote (fewer when the data ends first, or at an end code);
   it returns 0 or a negative code. Each table entry is its prefix's code and
   its last byte; a string is written back to front from its length. */
#include "decode.h"

#define MAX_CODES 4096

int tdt_gif_lzw(const uint8_t *data, int64_t n, int64_t min_size, uint8_t *out, int64_t count,
                int64_t *written_out) {
    if (min_size < 1 || min_size > 11) return TDT_ERR_CORRUPT;
    if (n < 0 || count < 0) return TDT_ERR_ARGS;
    uint16_t prefix[MAX_CODES];
    uint8_t last[MAX_CODES], first[MAX_CODES];
    uint16_t length[MAX_CODES];
    const int clear = 1 << min_size, end = clear + 1;
    for (int i = 0; i < clear; i++) prefix[i] = 0, last[i] = first[i] = (uint8_t)i, length[i] = 1;
    int size = (int)min_size + 1, table = clear + 2, prev = -1;
    uint32_t acc = 0;
    int nacc = 0;
    int64_t pos = 0, written = 0;
    while (written < count) {
        while (nacc < size && pos < n) {
            acc |= (uint32_t)data[pos++] << nacc;
            nacc += 8;
        }
        if (nacc < size) break; /* the data ends without an end code */
        int code = (int)(acc & ((1u << size) - 1));
        acc >>= size;
        nacc -= size;
        if (code == clear) {
            table = clear + 2, size = (int)min_size + 1, prev = -1;
            continue;
        }
        if (code == end) break;
        int entry;
        if (code < table) {
            entry = code;
            if (prev >= 0 && table < MAX_CODES) { /* prev + the entry's first byte */
                prefix[table] = (uint16_t)prev, last[table] = first[code];
                first[table] = first[prev], length[table] = length[prev] + 1;
                table++;
                if (table == 1 << size && size < 12) size++;
            }
        } else if (code == table && prev >= 0) { /* prev + prev's first byte */
            prefix[table] = (uint16_t)prev, last[table] = first[prev];
            first[table] = first[prev], length[table] = length[prev] + 1;
            entry = table++;
            if (table == 1 << size && size < 12) size++;
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
