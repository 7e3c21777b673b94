/* VP8, lossy WebP: one key frame (libwebp's vp8_dec.c, tree_dec.c,
   quant_dec.c, frame_dec.c, dsp/dec.c, upsampling.c, yuv.h), the
   counterpart of data/webp.py's plain _vp8_decode: the boolean decoder as
   libwebp reads it (VP8GetBit, and VP8GetSigned's fixed one-bit shift),
   segments, the coefficient probabilities and their updates, the intra
   modes, the tokens with their contexts, dequantisation, the
   Walsh-Hadamard and inverse DCT transforms, the predictions from
   unfiltered neighbours (127 above the frame, 129 to its left), then the
   simple or normal loop filter macroblock by macroblock, and the RGB of
   libwebp's default output (the fancy chroma upsampling and 14-bit YUV to
   RGB). The constant tables are RFC 6386's, as in the plain version.

   Each macroblock is predicted as soon as it is parsed (the plain version
   parses them all first: the pixels are the same), and the frame fails as
   the plain version's does, when a partition has read past its end. */
#include <stdlib.h>
#include <string.h>

#include "decode.h"

static const uint8_t DC_TABLE[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

static const uint16_t AC_TABLE[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

static const uint8_t COEF_UPDATE[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

static const uint8_t COEF_DEFAULT[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

static const uint8_t BMODE_PROBA[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};


static const uint8_t BANDS[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t ZIGZAG[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t CAT_PROBAS[4][11] = {{173, 148, 140},
                                          {176, 155, 140, 135},
                                          {180, 157, 141, 134, 130},
                                          {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129}};
static const uint8_t CAT_LENGTHS[4] = {3, 4, 5, 11};
/* The 4x4 intra mode tree: a positive entry is the next node, else minus the mode. */
static const int8_t BMODE_TREE[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

/* libwebp's VP8BitReader: rng is the range less 1, value holds bits + 8
   unread bits; past the data it reads one zero byte. */
typedef struct {
    const uint8_t *p;
    int64_t n, pos;
    uint64_t value;
    int bits, eof;
    uint32_t rng;
} bool_t;

static void bd_load(bool_t *br) {
    while (br->bits < 0) {
        if (br->pos < br->n) {
            br->value = br->value << 8 | br->p[br->pos++];
            br->bits += 8;
        } else if (!br->eof) {
            br->value <<= 8;
            br->bits += 8;
            br->eof = 1;
        } else {
            br->bits = 0;
        }
    }
}

static void bd_init(bool_t *br, const uint8_t *p, int64_t n) {
    br->p = p, br->n = n, br->pos = 0, br->value = 0, br->bits = -8, br->eof = 0, br->rng = 254;
    bd_load(br);
}

static inline int bd_bit(bool_t *br, int prob) {
    if (br->bits < 0) bd_load(br);
    uint32_t rng = br->rng;
    int pos = br->bits, bit;
    uint32_t split = (rng * (uint32_t)prob) >> 8;
    if ((br->value >> pos) > split) {
        rng -= split;
        br->value -= (uint64_t)(split + 1) << pos;
        bit = 1;
    } else {
        rng = split + 1;
        bit = 0;
    }
    int shift = 7 ^ (31 - __builtin_clz(rng));
    br->bits -= shift;
    br->rng = (rng << shift) - 1;
    return bit;
}

/* VP8GetSigned: one bit of probability 1/2, its shift fixed at 1. */
static inline int bd_signed(bool_t *br, int v) {
    if (br->bits < 0) bd_load(br);
    int pos = br->bits;
    uint32_t split = br->rng >> 1;
    br->bits -= 1;
    if ((br->value >> pos) > split) {
        br->rng = (br->rng - 1) | 1;
        br->value -= (uint64_t)(split + 1) << pos;
        return -v;
    }
    br->rng |= 1;
    return v;
}

static int bd_value(bool_t *br, int n) {
    int v = 0;
    for (int k = n - 1; k >= 0; k--) v |= bd_bit(br, 0x80) << k;
    return v;
}

static int bd_signed_value(bool_t *br, int n) {
    int v = bd_value(br, n);
    return bd_bit(br, 0x80) ? -v : v;
}

typedef uint8_t proba_t[8][3][11]; /* band, context, probability */

/* GetCoeffs: the tokens of one block from position n, each dequantised into
   out[zigzag]; returns the position after the last nonzero one (n when the
   block ends at once). */
static int coefficients(bool_t *br, const proba_t probas, int ctx, const int dq[2], int n,
                        int16_t *out) {
    const uint8_t *p = probas[BANDS[n]][ctx];
    while (n < 16) {
        if (!bd_bit(br, p[0])) return n;
        while (!bd_bit(br, p[1])) {
            if (++n == 16) return 16;
            p = probas[BANDS[n]][0];
        }
        int v, ctx_next;
        if (!bd_bit(br, p[2])) {
            v = 1, ctx_next = 1;
        } else {
            if (!bd_bit(br, p[3])) {
                v = !bd_bit(br, p[4]) ? 2 : 3 + bd_bit(br, p[5]);
            } else if (!bd_bit(br, p[6])) {
                if (!bd_bit(br, p[7])) {
                    v = 5 + bd_bit(br, 159);
                } else {
                    v = 7 + 2 * bd_bit(br, 165);
                    v += bd_bit(br, 145);
                }
            } else {
                int bit1 = bd_bit(br, p[8]);
                int cat = 2 * bit1 + bd_bit(br, p[9 + bit1]);
                v = 0;
                for (int k = 0; k < CAT_LENGTHS[cat]; k++) v += v + bd_bit(br, CAT_PROBAS[cat][k]);
                v += 3 + (8 << cat);
            }
            ctx_next = 2;
        }
        out[ZIGZAG[n]] = (int16_t)(bd_signed(br, v) * dq[n > 0]);
        if (++n < 16) p = probas[BANDS[n]][ctx_next];
    }
    return 16;
}

/* TransformOne: a block's 16 coefficients -> its 4x4 residuals (row-major),
   in int64 as the plain version computes them. */
static void transform(const int16_t *c, int *out) {
#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)
    int64_t tmp[16];
    for (int col = 0; col < 4; col++) { /* vertical pass: tmp[4 * r + col] */
        int64_t c0 = c[col], c1 = c[4 + col], c2 = c[8 + col], c3 = c[12 + col];
        int64_t a = c0 + c2, b = c0 - c2, cc = MUL2(c1) - MUL1(c3), d = MUL1(c1) + MUL2(c3);
        tmp[col] = a + d, tmp[4 + col] = b + cc, tmp[8 + col] = b - cc, tmp[12 + col] = a - d;
    }
    for (int r = 0; r < 4; r++) {
        const int64_t *t = tmp + 4 * r;
        int64_t dc = t[0] + 4;
        int64_t a = dc + t[2], b = dc - t[2];
        int64_t cc = MUL2(t[1]) - MUL1(t[3]), d = MUL1(t[1]) + MUL2(t[3]);
        out[4 * r] = (int)((a + d) >> 3), out[4 * r + 1] = (int)((b + cc) >> 3);
        out[4 * r + 2] = (int)((b - cc) >> 3), out[4 * r + 3] = (int)((a - d) >> 3);
    }
#undef MUL1
#undef MUL2
}

/* TransformWHT: the 16 luma DCs from the Y2 block's coefficients. */
static void wht(const int16_t *dc, int16_t *out) {
    int tmp[16];
    for (int i = 0; i < 4; i++) {
        int a0 = dc[i] + dc[12 + i], a1 = dc[4 + i] + dc[8 + i];
        int a2 = dc[4 + i] - dc[8 + i], a3 = dc[i] - dc[12 + i];
        tmp[i] = a0 + a1, tmp[8 + i] = a0 - a1, tmp[4 + i] = a3 + a2, tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; i++) {
        int d = tmp[4 * i] + 3;
        int a0 = d + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
        int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = d - tmp[4 * i + 3];
        out[4 * i] = (int16_t)((a0 + a1) >> 3), out[4 * i + 1] = (int16_t)((a3 + a2) >> 3);
        out[4 * i + 2] = (int16_t)((a0 - a1) >> 3), out[4 * i + 3] = (int16_t)((a3 - a2) >> 3);
    }
}

static inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
static inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
static inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

/* A 4x4 intra prediction (dsp/dec.c), row-major, from the 8 pixels above
   (4 and the 4 above-right), the 4 to the left and the one above-left. */
static void predict4(int mode, const int *top, const int *left, int X, int *out) {
    int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
        H = top[7];
    int I = left[0], J = left[1], K = left[2], L = left[3];
#define PUT(v, x, y) out[4 * (y) + (x)] = (v)
    switch (mode) {
    case B_DC: {
        int v = (A + B + C + D + I + J + K + L + 4) >> 3;
        for (int k = 0; k < 16; k++) out[k] = v;
        break;
    }
    case B_TM:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) out[4 * y + x] = clip255(top[x] + left[y] - X);
        break;
    case B_VE:
        for (int y = 0; y < 4; y++)
            PUT(avg3(X, A, B), 0, y), PUT(avg3(A, B, C), 1, y), PUT(avg3(B, C, D), 2, y),
                PUT(avg3(C, D, E), 3, y);
        break;
    case B_HE: {
        int rows[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) out[4 * y + x] = rows[y];
        break;
    }
    case B_RD:
        PUT(avg3(J, K, L), 0, 3);
        PUT(avg3(I, J, K), 1, 3), PUT(avg3(I, J, K), 0, 2);
        PUT(avg3(X, I, J), 2, 3), PUT(avg3(X, I, J), 1, 2), PUT(avg3(X, I, J), 0, 1);
        PUT(avg3(A, X, I), 3, 3), PUT(avg3(A, X, I), 2, 2), PUT(avg3(A, X, I), 1, 1),
            PUT(avg3(A, X, I), 0, 0);
        PUT(avg3(B, A, X), 3, 2), PUT(avg3(B, A, X), 2, 1), PUT(avg3(B, A, X), 1, 0);
        PUT(avg3(C, B, A), 3, 1), PUT(avg3(C, B, A), 2, 0);
        PUT(avg3(D, C, B), 3, 0);
        break;
    case B_VR:
        PUT(avg2(X, A), 0, 0), PUT(avg2(X, A), 1, 2);
        PUT(avg2(A, B), 1, 0), PUT(avg2(A, B), 2, 2);
        PUT(avg2(B, C), 2, 0), PUT(avg2(B, C), 3, 2);
        PUT(avg2(C, D), 3, 0);
        PUT(avg3(K, J, I), 0, 3);
        PUT(avg3(J, I, X), 0, 2);
        PUT(avg3(I, X, A), 0, 1), PUT(avg3(I, X, A), 1, 3);
        PUT(avg3(X, A, B), 1, 1), PUT(avg3(X, A, B), 2, 3);
        PUT(avg3(A, B, C), 2, 1), PUT(avg3(A, B, C), 3, 3);
        PUT(avg3(B, C, D), 3, 1);
        break;
    case B_LD:
        PUT(avg3(A, B, C), 0, 0);
        PUT(avg3(B, C, D), 1, 0), PUT(avg3(B, C, D), 0, 1);
        PUT(avg3(C, D, E), 2, 0), PUT(avg3(C, D, E), 1, 1), PUT(avg3(C, D, E), 0, 2);
        PUT(avg3(D, E, F), 3, 0), PUT(avg3(D, E, F), 2, 1), PUT(avg3(D, E, F), 1, 2),
            PUT(avg3(D, E, F), 0, 3);
        PUT(avg3(E, F, G), 3, 1), PUT(avg3(E, F, G), 2, 2), PUT(avg3(E, F, G), 1, 3);
        PUT(avg3(F, G, H), 3, 2), PUT(avg3(F, G, H), 2, 3);
        PUT(avg3(G, H, H), 3, 3);
        break;
    case B_VL:
        PUT(avg2(A, B), 0, 0);
        PUT(avg2(B, C), 1, 0), PUT(avg2(B, C), 0, 2);
        PUT(avg2(C, D), 2, 0), PUT(avg2(C, D), 1, 2);
        PUT(avg2(D, E), 3, 0), PUT(avg2(D, E), 2, 2);
        PUT(avg3(A, B, C), 0, 1);
        PUT(avg3(B, C, D), 1, 1), PUT(avg3(B, C, D), 0, 3);
        PUT(avg3(C, D, E), 2, 1), PUT(avg3(C, D, E), 1, 3);
        PUT(avg3(D, E, F), 3, 1), PUT(avg3(D, E, F), 2, 3);
        PUT(avg3(E, F, G), 3, 2);
        PUT(avg3(F, G, H), 3, 3);
        break;
    case B_HD:
        PUT(avg2(I, X), 0, 0), PUT(avg2(I, X), 2, 1);
        PUT(avg2(J, I), 0, 1), PUT(avg2(J, I), 2, 2);
        PUT(avg2(K, J), 0, 2), PUT(avg2(K, J), 2, 3);
        PUT(avg2(L, K), 0, 3);
        PUT(avg3(A, B, C), 3, 0);
        PUT(avg3(X, A, B), 2, 0);
        PUT(avg3(I, X, A), 1, 0), PUT(avg3(I, X, A), 3, 1);
        PUT(avg3(J, I, X), 1, 1), PUT(avg3(J, I, X), 3, 2);
        PUT(avg3(K, J, I), 1, 2), PUT(avg3(K, J, I), 3, 3);
        PUT(avg3(L, K, J), 1, 3);
        break;
    default: /* HU */
        PUT(avg2(I, J), 0, 0);
        PUT(avg2(J, K), 2, 0), PUT(avg2(J, K), 0, 1);
        PUT(avg2(K, L), 2, 1), PUT(avg2(K, L), 0, 2);
        PUT(avg3(I, J, K), 1, 0);
        PUT(avg3(J, K, L), 3, 0), PUT(avg3(J, K, L), 1, 1);
        PUT(avg3(K, L, L), 3, 1), PUT(avg3(K, L, L), 1, 2);
        PUT(L, 3, 2), PUT(L, 2, 2), PUT(L, 0, 3), PUT(L, 1, 3), PUT(L, 2, 3), PUT(L, 3, 3);
        break;
    }
#undef PUT
}

/* A 16x16 luma or 8x8 chroma prediction, plus its residuals, written at
   (y, x) of a plane padded by one row of 127 above and a column of 129 to
   the left: DC (from what exists of top and left), VE, HE or TM. res: the
   blocks' 4x4 residuals in raster order of the blocks. */
static void predict_block(int mode, uint8_t *plane, int64_t stride, int64_t y, int64_t x,
                          int size, int mb_x, int mb_y, const int *res) {
    const uint8_t *top = plane + (y - 1) * stride + x;
    int tl = top[-1];
    int dc = 128;
    if (mode == B_DC) {
        int shift = size == 16 ? 4 : 3, st = 0, sl = 0;
        for (int k = 0; k < size; k++) st += top[k], sl += plane[(y + k) * stride + x - 1];
        if (mb_x && mb_y) dc = (st + sl + size) >> (shift + 1);
        else if (mb_y) dc = (st + (size >> 1)) >> shift;
        else if (mb_x) dc = (sl + (size >> 1)) >> shift;
    }
    int blocks = size / 4;
    for (int r = 0; r < size; r++) {
        uint8_t *row = plane + (y + r) * stride + x;
        int left = row[-1];
        for (int c = 0; c < size; c++) {
            int pred = mode == B_DC ? dc : mode == B_VE ? top[c] : mode == B_HE ? left
                     : clip255(top[c] + left - tl);
            int v = res[16 * ((r >> 2) * blocks + (c >> 2)) + 4 * (r & 3) + (c & 3)];
            row[c] = (uint8_t)clip255(pred + v);
        }
    }
}

static inline int iabs(int v) { return v < 0 ? -v : v; }
static inline int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

/* The loop filter across one edge: `count` lines of 8 pixels p3..q3, the
   first at `px`, consecutive pixels `step` apart, lines `next` apart. */
static void filter_lines(uint8_t *px, int64_t step, int64_t next, int count, int thresh,
                         int ithresh, int hev_thresh, int inner, int simple) {
    int thresh2 = 2 * thresh + 1;
    for (int line = 0; line < count; line++, px += next) {
        int p3 = px[0], p2 = px[step], p1 = px[2 * step], p0 = px[3 * step];
        int q0 = px[4 * step], q1 = px[5 * step], q2 = px[6 * step], q3 = px[7 * step];
        if (4 * iabs(p0 - q0) + iabs(p1 - q1) > thresh2) continue;
        if (!simple && (iabs(p3 - p2) > ithresh || iabs(p2 - p1) > ithresh
                        || iabs(p1 - p0) > ithresh || iabs(q3 - q2) > ithresh
                        || iabs(q2 - q1) > ithresh || iabs(q1 - q0) > ithresh))
            continue;
        int hev = iabs(p1 - p0) > hev_thresh || iabs(q1 - q0) > hev_thresh;
        if (simple || hev) { /* DoFilter2 */
            int a = 3 * (q0 - p0) + clampi(p1 - q1, -128, 127);
            int a1 = clampi((a + 4) >> 3, -16, 15), a2 = clampi((a + 3) >> 3, -16, 15);
            px[3 * step] = (uint8_t)clip255(p0 + a2);
            px[4 * step] = (uint8_t)clip255(q0 - a1);
        } else if (inner) { /* DoFilter4 */
            int a = 3 * (q0 - p0);
            int a1 = clampi((a + 4) >> 3, -16, 15), a2 = clampi((a + 3) >> 3, -16, 15);
            int a3 = (a1 + 1) >> 1;
            px[2 * step] = (uint8_t)clip255(p1 + a3), px[3 * step] = (uint8_t)clip255(p0 + a2);
            px[4 * step] = (uint8_t)clip255(q0 - a1), px[5 * step] = (uint8_t)clip255(q1 - a3);
        } else { /* DoFilter6 */
            int a = clampi(3 * (q0 - p0) + clampi(p1 - q1, -128, 127), -128, 127);
            int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
            px[step] = (uint8_t)clip255(p2 + a3), px[2 * step] = (uint8_t)clip255(p1 + a2);
            px[3 * step] = (uint8_t)clip255(p0 + a1), px[4 * step] = (uint8_t)clip255(q0 - a1);
            px[5 * step] = (uint8_t)clip255(q1 - a2), px[6 * step] = (uint8_t)clip255(q2 - a3);
        }
    }
}

/* One macroblock's edges of one plane (DoFilter): the left edge and the
   inner vertical ones, then the top edge and the inner horizontal ones.
   `origin` is the macroblock's first pixel. */
static void filter_plane(uint8_t *origin, int64_t stride, int size, int left, int top,
                         int inner, int limit, int ilevel, int hev, int simple) {
    for (int horizontal = 0; horizontal < 2; horizontal++) {
        int edge = horizontal ? top : left;
        for (int offset = edge ? 0 : 4; offset < size; offset += 4) {
            if (offset && !inner) break;
            int thresh = offset ? limit : limit + 4;
            if (horizontal)
                filter_lines(origin + (offset - 4) * stride, stride, 1, size, thresh, ilevel, hev,
                             offset != 0, simple);
            else
                filter_lines(origin + offset - 4, 1, stride, size, thresh, ilevel, hev, offset != 0,
                             simple);
        }
    }
}

/* libwebp's fancy upsampling and VP8YUVToRGB: (h, w) luma, (ceil(h/2),
   ceil(w/2)) chroma (row strides given) -> rgb. */
static inline int clip8(int c) { return (c & ~16383) == 0 ? c >> 6 : c < 0 ? 0 : 255; }

static void upsample_row(const uint8_t *n, const uint8_t *f, int64_t w, int *out) {
    out[0] = (3 * n[0] + f[0] + 2) >> 2;
    int64_t last = (w - 1) >> 1;
    for (int64_t j = 0; j < last; j++) {
        int tl = n[j], t = n[j + 1], l = f[j], cur = f[j + 1];
        int avg = tl + t + l + cur + 8;
        out[2 * j + 1] = (((avg + 2 * (t + l)) >> 3) + tl) >> 1;
        out[2 * j + 2] = (((avg + 2 * (tl + cur)) >> 3) + t) >> 1;
    }
    if (w % 2 == 0) out[w - 1] = (3 * n[last] + f[last] + 2) >> 2;
}

static void yuv_to_rgb(const uint8_t *Y, int64_t ys, const uint8_t *U, const uint8_t *V,
                       int64_t cs, int64_t h, int64_t w, int *uu, int *vv, uint8_t *rgb) {
    int64_t ch = (h + 1) / 2;
    for (int64_t y = 0; y < h; y++) {
        int64_t near = y / 2, far = y == 0 ? 0 : y % 2 ? y / 2 + 1 : y / 2 - 1;
        if (far > ch - 1) far = ch - 1;
        upsample_row(U + near * cs, U + far * cs, w, uu);
        upsample_row(V + near * cs, V + far * cs, w, vv);
        for (int64_t x = 0; x < w; x++) {
            int yy = (Y[y * ys + x] * 19077) >> 8;
            uint8_t *o = rgb + 3 * (y * w + x);
            o[0] = (uint8_t)clip8(yy + ((vv[x] * 26149) >> 8) - 14234);
            o[1] = (uint8_t)clip8(yy - ((uu[x] * 6419) >> 8) - ((vv[x] * 13320) >> 8) + 8708);
            o[2] = (uint8_t)clip8(yy + ((uu[x] * 33050) >> 8) - 17685);
        }
    }
}

static inline int u24(const uint8_t *p) { return p[0] | p[1] << 8 | p[2] << 16; }

int tdt_vp8_decode(const uint8_t *data, int64_t n, uint8_t *rgb, int64_t width_in,
                   int64_t height_in) {
    if (n < 10) return TDT_ERR_TRUNCATED;
    int frame_bits = u24(data);
    if (frame_bits & 1 || ((frame_bits >> 1) & 7) > 3 || !((frame_bits >> 4) & 1))
        return TDT_ERR_CORRUPT;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return TDT_ERR_CORRUPT;
    int width = (data[6] | data[7] << 8) & 0x3FFF, height = (data[8] | data[9] << 8) & 0x3FFF;
    int64_t part0 = frame_bits >> 5;
    if (width == 0 || height == 0 || 10 + part0 > n) return TDT_ERR_CORRUPT;
    if (width != width_in || height != height_in) return TDT_ERR_ARGS;
    bool_t br;
    bd_init(&br, data + 10, part0);
    bd_value(&br, 2); /* colour space, clamping type */
    /* Segments. */
    int use_segment = bd_value(&br, 1), update_map = 0, absolute = 1;
    int quantizer[4] = {0}, strength[4] = {0}, seg_probs[3] = {255, 255, 255};
    if (use_segment) {
        update_map = bd_value(&br, 1);
        if (bd_value(&br, 1)) {
            absolute = bd_value(&br, 1);
            for (int s = 0; s < 4; s++) quantizer[s] = bd_value(&br, 1) ? bd_signed_value(&br, 7) : 0;
            for (int s = 0; s < 4; s++) strength[s] = bd_value(&br, 1) ? bd_signed_value(&br, 6) : 0;
        }
        if (update_map)
            for (int k = 0; k < 3; k++) seg_probs[k] = bd_value(&br, 1) ? bd_value(&br, 8) : 255;
    }
    /* The loop filter. */
    int simple = bd_value(&br, 1), level = bd_value(&br, 6), sharpness = bd_value(&br, 3);
    int ref_delta[4] = {0}, mode_delta[4] = {0};
    int use_delta = bd_value(&br, 1);
    if (use_delta && bd_value(&br, 1)) {
        for (int k = 0; k < 4; k++) if (bd_value(&br, 1)) ref_delta[k] = bd_signed_value(&br, 6);
        for (int k = 0; k < 4; k++) if (bd_value(&br, 1)) mode_delta[k] = bd_signed_value(&br, 6);
    }
    int filter_type = level == 0 ? 0 : simple ? 1 : 2;
    /* The token partitions. */
    int last = (1 << bd_value(&br, 2)) - 1;
    const uint8_t *rest = data + 10 + part0;
    int64_t rest_n = n - 10 - part0;
    if (rest_n < 3 * last) return TDT_ERR_TRUNCATED;
    bool_t parts[8];
    int64_t start = 3 * last, left = rest_n - 3 * last;
    for (int k = 0; k < last; k++) {
        int64_t size = u24(rest + 3 * k);
        if (size > left) size = left;
        bd_init(&parts[k], rest + start, size);
        start += size, left -= size;
    }
    bd_init(&parts[last], rest + start, rest_n - start);
    /* Dequantisation by segment: {dc, ac} of y1, y2 and uv. */
    int base_q = bd_value(&br, 7), dqs[5];
    for (int k = 0; k < 5; k++) dqs[k] = bd_value(&br, 1) ? bd_signed_value(&br, 4) : 0;
    int quant[4][3][2];
    for (int s = 0; s < 4; s++) {
        int q = use_segment ? quantizer[s] + (absolute ? 0 : base_q) : base_q;
        int y2_ac = (AC_TABLE[clampi(q + dqs[2], 0, 127)] * 101581) >> 16;
        quant[s][0][0] = DC_TABLE[clampi(q + dqs[0], 0, 127)];
        quant[s][0][1] = AC_TABLE[clampi(q, 0, 127)];
        quant[s][1][0] = DC_TABLE[clampi(q + dqs[1], 0, 127)] * 2;
        quant[s][1][1] = y2_ac < 8 ? 8 : y2_ac;
        quant[s][2][0] = DC_TABLE[clampi(q + dqs[3], 0, 117)];
        quant[s][2][1] = AC_TABLE[clampi(q + dqs[4], 0, 127)];
    }
    bd_value(&br, 1); /* refresh entropy probabilities: ignored, as libwebp does */
    proba_t probas[4];
    for (int i = 0; i < 4 * 8 * 3 * 11; i++)
        ((uint8_t *)probas)[i] = bd_bit(&br, COEF_UPDATE[i]) ? (uint8_t)bd_value(&br, 8) : COEF_DEFAULT[i];
    int skip_prob = bd_value(&br, 1) ? bd_value(&br, 8) : -1;
    /* Filter strengths by (segment, 4x4 mode): limit, interior limit, hev; limit 0: none. */
    int strengths[4][2][3];
    for (int s = 0; s < 4; s++) {
        int base = use_segment ? strength[s] + (absolute ? 0 : level) : level;
        for (int i4 = 0; i4 < 2; i4++) {
            int lv = base + (use_delta ? ref_delta[0] + (i4 ? mode_delta[0] : 0) : 0);
            lv = clampi(lv, 0, 63);
            int il = lv;
            if (sharpness) {
                il >>= sharpness > 4 ? 2 : 1;
                if (il > 9 - sharpness) il = 9 - sharpness;
            }
            if (il < 1) il = 1;
            strengths[s][i4][0] = lv ? 2 * lv + il : 0;
            strengths[s][i4][1] = il;
            strengths[s][i4][2] = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        }
    }
    int mb_w = (width + 15) >> 4, mb_h = (height + 15) >> 4;
    /* Planes padded by one row above (127) and a column to the left (129),
       luma 4 columns wider for the top-right pixels of the last macroblock. */
    int64_t ys = 16 * (int64_t)mb_w + 5, cs = 8 * (int64_t)mb_w + 1;
    int64_t yh = 16 * (int64_t)mb_h + 1, chh = 8 * (int64_t)mb_h + 1;
    uint8_t *Y = calloc((size_t)(ys * yh), 1), *U = calloc((size_t)(cs * chh), 1),
            *V = calloc((size_t)(cs * chh), 1);
    uint8_t *info = malloc((size_t)mb_w * mb_h * 3); /* segment, i4, inner */
    uint8_t *intra_top = calloc((size_t)mb_w * 4, 1), (*nz_top)[9] = calloc((size_t)mb_w, 9);
    int *uu = malloc(sizeof(int) * (size_t)width), *vv = malloc(sizeof(int) * (size_t)width);
    int rc = TDT_OK;
    if (!Y || !U || !V || !info || !intra_top || !nz_top || !uu || !vv) rc = TDT_ERR_MEMORY;
    if (rc == TDT_OK) {
        for (int64_t r = 0; r < yh; r++) Y[r * ys] = 129;
        for (int64_t r = 0; r < chh; r++) U[r * cs] = V[r * cs] = 129;
        for (int64_t c = 0; c < ys; c++) Y[c] = 127;
        for (int64_t c = 0; c < cs; c++) U[c] = V[c] = 127;
    }
    for (int mb_y = 0; mb_y < mb_h && rc == TDT_OK; mb_y++) {
        bool_t *token_br = &parts[mb_y & last];
        uint8_t intra_left[4] = {0}, nz_left[9] = {0};
        for (int mb_x = 0; mb_x < mb_w; mb_x++) {
            int segment = 0;
            if (update_map)
                segment = !bd_bit(&br, seg_probs[0]) ? bd_bit(&br, seg_probs[1])
                                                     : bd_bit(&br, seg_probs[2]) + 2;
            int skip = skip_prob >= 0 ? bd_bit(&br, skip_prob) : 0;
            int i4 = !bd_bit(&br, 145);
            int modes[16];
            uint8_t *itop = intra_top + 4 * mb_x;
            if (!i4) {
                int ymode = bd_bit(&br, 156) ? (bd_bit(&br, 128) ? B_TM : B_HE)
                                             : (bd_bit(&br, 163) ? B_VE : B_DC);
                modes[0] = ymode;
                for (int k = 0; k < 4; k++) itop[k] = intra_left[k] = (uint8_t)ymode;
            } else {
                for (int by = 0; by < 4; by++) {
                    int ymode = intra_left[by];
                    for (int bx = 0; bx < 4; bx++) {
                        const uint8_t *prob = BMODE_PROBA + (itop[bx] * 10 + ymode) * 9;
                        int i = BMODE_TREE[bd_bit(&br, prob[0])];
                        while (i > 0) i = BMODE_TREE[2 * i + bd_bit(&br, prob[i])];
                        ymode = -i;
                        itop[bx] = (uint8_t)ymode;
                        modes[4 * by + bx] = ymode;
                    }
                    intra_left[by] = (uint8_t)ymode;
                }
            }
            int uvmode = !bd_bit(&br, 142) ? B_DC : !bd_bit(&br, 114) ? B_VE
                       : bd_bit(&br, 183) ? B_TM : B_HE;
            /* The residuals. */
            int16_t coef[384];
            memset(coef, 0, sizeof(coef));
            uint8_t *top_nz = nz_top[mb_x];
            int nonzero = 0;
            if (skip) {
                memset(top_nz, 0, 8), memset(nz_left, 0, 8);
                if (!i4) top_nz[8] = nz_left[8] = 0;
            } else {
                const int (*q)[2] = quant[segment];
                int first = 0;
                const uint8_t(*ac)[3][11] = probas[3];
                if (!i4) {
                    int16_t dc[16] = {0}, y_dc[16];
                    int nz = coefficients(token_br, probas[1], top_nz[8] + nz_left[8], q[1], 0, dc);
                    top_nz[8] = nz_left[8] = nz > 0;
                    wht(dc, y_dc);
                    for (int k = 0; k < 16; k++) coef[16 * k] = y_dc[k];
                    first = 1, ac = probas[0];
                }
                for (int by = 0; by < 4; by++) {
                    for (int bx = 0; bx < 4; bx++) {
                        int16_t *blk = coef + 16 * (4 * by + bx);
                        int nz = coefficients(token_br, ac, nz_left[by] + top_nz[bx], q[0], first, blk);
                        top_nz[bx] = nz_left[by] = nz > first;
                        nonzero |= nz > 1 || blk[0] != 0;
                    }
                }
                for (int ch = 0; ch < 2; ch++) {
                    for (int by = 0; by < 2; by++) {
                        for (int bx = 0; bx < 2; bx++) {
                            int16_t *blk = coef + 256 + 64 * ch + 16 * (2 * by + bx);
                            int l = 4 + 2 * ch + by, t = 4 + 2 * ch + bx;
                            int nz = coefficients(token_br, probas[2], nz_left[l] + top_nz[t], q[2], 0, blk);
                            top_nz[t] = nz_left[l] = nz > 0;
                            nonzero |= nz > 1 || blk[0] != 0;
                        }
                    }
                }
            }
            uint8_t *mb = info + 3 * ((int64_t)mb_y * mb_w + mb_x);
            mb[0] = (uint8_t)segment, mb[1] = (uint8_t)i4, mb[2] = (uint8_t)(i4 || nonzero);
            /* The predictions, from unfiltered neighbours, and the residuals. */
            int res[384];
            for (int k = 0; k < 24; k++) transform(coef + 16 * k, res + 16 * k);
            int64_t y0 = 16 * (int64_t)mb_y + 1, x0 = 16 * (int64_t)mb_x + 1;
            if (i4) {
                int top_right[4];
                for (int k = 0; k < 4; k++)
                    top_right[k] = mb_y == 0 ? 127 : mb_x == mb_w - 1 ? Y[(y0 - 1) * ys + x0 + 15]
                                                   : Y[(y0 - 1) * ys + x0 + 16 + k];
                for (int k = 0; k < 16; k++) {
                    int by = k >> 2, bx = k & 3;
                    int64_t y = y0 + 4 * by, x = x0 + 4 * bx;
                    const uint8_t *above = Y + (y - 1) * ys + x - 1;
                    int top[8], lft[4], pred[16];
                    for (int j = 0; j < 4; j++) top[j] = above[1 + j];
                    for (int j = 0; j < 4; j++) top[4 + j] = bx == 3 ? top_right[j] : above[5 + j];
                    for (int j = 0; j < 4; j++) lft[j] = Y[(y + j) * ys + x - 1];
                    predict4(modes[k], top, lft, above[0], pred);
                    for (int r = 0; r < 4; r++)
                        for (int c = 0; c < 4; c++)
                            Y[(y + r) * ys + x + c] = (uint8_t)clip255(pred[4 * r + c] + res[16 * k + 4 * r + c]);
                }
            } else {
                predict_block(modes[0], Y, ys, y0, x0, 16, mb_x, mb_y, res);
            }
            int64_t c0 = 8 * (int64_t)mb_y + 1, c1 = 8 * (int64_t)mb_x + 1;
            predict_block(uvmode, U, cs, c0, c1, 8, mb_x, mb_y, res + 256);
            predict_block(uvmode, V, cs, c0, c1, 8, mb_x, mb_y, res + 320);
        }
    }
    if (rc == TDT_OK) {
        int eof = br.eof;
        for (int k = 0; k <= last; k++) eof |= parts[k].eof;
        if (eof) rc = TDT_ERR_TRUNCATED;
    }
    if (rc == TDT_OK && filter_type) { /* macroblock by macroblock */
        for (int64_t index = 0; index < (int64_t)mb_w * mb_h; index++) {
            const uint8_t *mb = info + 3 * index;
            const int *fs = strengths[mb[0]][mb[1]];
            if (!fs[0]) continue;
            int mb_y = (int)(index / mb_w), mb_x = (int)(index % mb_w);
            filter_plane(Y + (16 * (int64_t)mb_y + 1) * ys + 16 * mb_x + 1, ys, 16, mb_x > 0, mb_y > 0,
                         mb[2], fs[0], fs[1], fs[2], filter_type == 1);
            if (filter_type == 2) {
                int64_t off = (8 * (int64_t)mb_y + 1) * cs + 8 * mb_x + 1;
                filter_plane(U + off, cs, 8, mb_x > 0, mb_y > 0, mb[2], fs[0], fs[1], fs[2], 0);
                filter_plane(V + off, cs, 8, mb_x > 0, mb_y > 0, mb[2], fs[0], fs[1], fs[2], 0);
            }
        }
    }
    if (rc == TDT_OK) yuv_to_rgb(Y + ys + 1, ys, U + cs + 1, V + cs + 1, cs, height, width, uu, vv, rgb);
    free(Y), free(U), free(V), free(info), free(intra_top), free(nz_top), free(uu), free(vv);
    return rc;
}
