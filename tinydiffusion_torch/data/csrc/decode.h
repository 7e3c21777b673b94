/* Shared by the host image decoders (jpeg.c, vp8.c, vp8l.c, gif.c, tiff.c,
   jpeg2000.c, raster.c).

   Every entry point returns 0 or one of the negative codes below, which
   data/native.py turns into ValueError. Every buffer comes with its length:
   no read or write goes past it. There is no static mutable state, so
   threads may decode at once. */
#ifndef TDT_DECODE_H
#define TDT_DECODE_H

#include <stddef.h>
#include <stdint.h>

enum {
    TDT_OK = 0,
    TDT_ERR_ARGS = -1,      /* sizes or geometry the caller should not pass */
    TDT_ERR_TRUNCATED = -2, /* the data ends before what it announces */
    TDT_ERR_CODE = -3,      /* a bit pattern that is no prefix code */
    TDT_ERR_RANGE = -4,     /* a coefficient, copy or index outside its bounds */
    TDT_ERR_SEGMENTS = -5,  /* fewer restart segments than MCUs */
    TDT_ERR_CORRUPT = -6,   /* anything else the format forbids */
    TDT_ERR_MEMORY = -7     /* an allocation failed */
};

#endif
