/*
 * mp3dec.c — from-scratch MPEG-1/2/2.5 Layer III decoder.
 *
 * Closes the reference's mp3 ingest path without an external backend:
 * the reference decodes mp3 through librosa -> audioread -> ffmpeg
 * (reference: inference.py:136-138; lib/dataset.py:147 lists the
 * accepted extensions) — this file makes `--input song.mp3` work on a
 * bare host, the same role flacdec.c plays for .flac.
 *
 * Scope: MPEG-1, MPEG-2 (LSF) and MPEG-2.5 Layer III, mono and all
 * stereo modes (stereo / joint MS + intensity / dual), CBR and VBR,
 * bit-reservoir streams, CRC frames (CRC skipped, not verified),
 * ID3v2/ID3v1 skipping, Xing/Info tag-frame skipping. Layers I/II and
 * free-format streams are rejected with a clear error.
 *
 * Correctness methodology (see tests/test_mp3.py and
 * scripts/mp3_extract_tables.py): every Huffman codeword, the
 * synthesis window and the scalefactor-band geometry are validated
 * against an independent oracle decoder (the system libmpg123, driven
 * via ctypes in the dev/test harness) using purpose-built probe
 * bitstreams; full-file decodes are compared against the oracle at
 * >90 dB SNR on LAME-encoded fixtures. The decoder itself has no
 * runtime dependency on either library.
 *
 * All spec data tables (Huffman codes, band edges, window
 * coefficients) are ISO/IEC 11172-3 / 13818-3 standard data.
 *
 * Exposed through _vrtnative.mp3_decode(bytes) ->
 *   (float32 interleaved pcm bytes, n_samples, channels, sample_rate).
 * Dev/test hooks (used by the extraction + verification harness):
 *   mp3_huff_get / mp3_huff_set / mp3_dwindow_get / mp3_dwindow_set /
 *   mp3_decode_trace (returns synthesis-stage U vectors for the
 *   window least-squares check) / mp3_table_stats.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* bit reader                                                          */

typedef struct {
    const uint8_t *buf;
    size_t nbits;   /* total bits */
    size_t pos;     /* bit position */
} Bits;

static void bits_init(Bits *b, const uint8_t *buf, size_t nbytes) {
    b->buf = buf;
    b->nbits = nbytes * 8;
    b->pos = 0;
}

static uint32_t bits_get(Bits *b, int n) {
    uint32_t v = 0;
    while (n > 0) {
        if (b->pos >= b->nbits) { b->pos += n; return v << n; }
        size_t byte = b->pos >> 3;
        int off = 7 - (int)(b->pos & 7);
        int take = off + 1;
        if (take > n) take = n;
        uint32_t chunk = (b->buf[byte] >> (off + 1 - take)) &
                         ((1u << take) - 1u);
        v = (v << take) | chunk;
        b->pos += (size_t)take;
        n -= take;
    }
    return v;
}

static int bits_get1(Bits *b) { return (int)bits_get(b, 1); }

/* ------------------------------------------------------------------ */
/* header tables                                                       */

static const int BITRATE_V1[16] = {0, 32, 40, 48, 56, 64, 80, 96, 112,
                                   128, 160, 192, 224, 256, 320, -1};
static const int BITRATE_V2[16] = {0, 8, 16, 24, 32, 40, 48, 56, 64,
                                   80, 96, 112, 128, 144, 160, -1};
static const int SR_V1[3] = {44100, 48000, 32000};

typedef struct {
    int version;       /* 1, 2, 25 */
    int lsf;           /* version != 1 */
    int sr, sr_row;    /* sample rate; row into band tables (0..8) */
    int bitrate;       /* kbps */
    int crc;           /* 1 = CRC present */
    int padding;
    int mode, mode_ext;
    int channels;
    int frame_bytes;
    int side_bytes;
} Header;

/* returns 0 ok, -1 not a valid/supported LIII header */
static int parse_header(const uint8_t *h, Header *o) {
    if (h[0] != 0xFF || (h[1] & 0xE0) != 0xE0) return -1;
    int verbits = (h[1] >> 3) & 3;
    int layer = (h[1] >> 1) & 3;
    if (verbits == 1 || layer != 1) return -1;  /* reserved / not LIII */
    o->version = verbits == 3 ? 1 : (verbits == 2 ? 2 : 25);
    o->lsf = o->version != 1;
    o->crc = !(h[1] & 1);
    int br = (h[2] >> 4) & 15;
    int srx = (h[2] >> 2) & 3;
    if (br == 0 || br == 15 || srx == 3) return -1; /* free-format/bad */
    o->bitrate = (o->lsf ? BITRATE_V2 : BITRATE_V1)[br];
    int sr = SR_V1[srx];
    if (o->version == 2) sr /= 2;
    if (o->version == 25) sr /= 4;
    o->sr = sr;
    o->sr_row = srx + (o->version == 1 ? 0 : (o->version == 2 ? 3 : 6));
    o->padding = (h[2] >> 1) & 1;
    o->mode = (h[3] >> 6) & 3;
    o->mode_ext = (h[3] >> 4) & 3;
    o->channels = o->mode == 3 ? 1 : 2;
    o->frame_bytes = (o->lsf ? 72 : 144) * o->bitrate * 1000 / sr +
                     o->padding;
    o->side_bytes = o->lsf ? (o->channels == 1 ? 9 : 17)
                           : (o->channels == 1 ? 17 : 32);
    return 0;
}

/* ------------------------------------------------------------------ */
/* scalefactor band tables: cumulative line starts.                    */
/* rows 0-2: MPEG1 44.1/48/32 k; 3-5: MPEG2 22.05/24/16 k;             */
/* 6-8: MPEG2.5 11.025/12/8 k.                                         */

static const short SFB_LONG[9][23] = {
    {0,4,8,12,16,20,24,30,36,44,52,62,74,90,110,134,162,196,238,288,342,418,576},
    {0,4,8,12,16,20,24,30,36,42,50,60,72,88,106,128,156,190,230,276,330,384,576},
    {0,4,8,12,16,20,24,30,36,44,54,66,82,102,126,156,194,240,296,364,448,550,576},
    {0,6,12,18,24,30,36,44,54,66,80,96,116,140,168,200,238,284,336,396,464,522,576},
    {0,6,12,18,24,30,36,44,54,66,80,96,114,136,162,194,232,278,332,394,464,540,576},
    {0,6,12,18,24,30,36,44,54,66,80,96,116,140,168,200,238,284,336,396,464,522,576},
    {0,6,12,18,24,30,36,44,54,66,80,96,116,140,168,200,238,284,336,396,464,522,576},
    {0,6,12,18,24,30,36,44,54,66,80,96,116,140,168,200,238,284,336,396,464,522,576},
    {0,12,24,36,48,60,72,88,108,132,160,192,232,280,336,400,476,566,568,570,572,574,576},
};

static const short SFB_SHORT[9][14] = {
    {0,4,8,12,16,22,30,40,52,66,84,106,136,192},
    {0,4,8,12,16,22,28,38,50,64,80,100,126,192},
    {0,4,8,12,16,22,30,42,58,78,104,138,180,192},
    {0,4,8,12,18,24,32,42,56,74,100,132,174,192},
    {0,4,8,12,18,26,36,48,62,80,104,136,180,192},
    {0,4,8,12,18,26,36,48,62,80,104,134,174,192},
    {0,4,8,12,18,26,36,48,62,80,104,134,174,192},
    {0,4,8,12,18,26,36,48,62,80,104,134,174,192},
    {0,8,16,24,36,52,72,96,124,160,162,164,166,192},
};

/* MPEG1 scalefac_compress -> (slen1, slen2) */
static const uint8_t SLEN[16][2] = {
    {0,0},{0,1},{0,2},{0,3},{3,0},{1,1},{1,2},{1,3},
    {2,1},{2,2},{2,3},{3,1},{3,2},{3,3},{4,2},{4,3}};

static const uint8_t PRETAB[22] =
    {0,0,0,0,0,0,0,0,0,0,0,1,1,1,1,2,2,3,3,3,2,0};

/* LSF scalefactor partition sizes: [table][blocktypenumber][4]        */
static const uint8_t LSF_NSFB[6][3][4] = {
    {{6,5,5,5},{9,9,9,9},{6,9,9,9}},
    {{6,5,7,3},{9,9,12,6},{6,9,12,6}},
    {{11,10,0,0},{18,18,0,0},{15,18,0,0}},
    {{7,7,7,0},{12,12,12,0},{6,15,12,0}},
    {{6,6,6,3},{12,9,9,6},{6,12,9,6}},
    {{8,8,5,0},{15,12,9,0},{6,18,9,0}}};

/* ------------------------------------------------------------------ */
/* Huffman tables.                                                     */
/*                                                                     */
/* Storage: per table, code lengths and codes in (x*ylen + y) order.   */
/* All data between the BEGIN/END EXTRACTED TABLES markers is           */
/* oracle-extracted (scripts/mp3_extract_tables.py): every codeword of */
/* every table was individually confirmed against libmpg123 via probe  */
/* streams, and each table's Kraft sum is exactly 1. The harness can   */
/* re-extract and re-bake at any time (mp3_huff_set + --bake).         */

typedef struct {
    uint8_t xlen, ylen, linbits;
    const uint8_t *hlen;
    const uint16_t *hcod;
    uint8_t *own_l;      /* non-NULL when replaced via mp3_huff_set */
    uint16_t *own_c;
    int16_t *tree;       /* built at init: node*2 children; leaf = -(1+(x<<5|y)) */
    int tree_n, valid;
} HuffTab;

/* BEGIN EXTRACTED TABLES */
/* ORACLE-EXTRACTED tables (scripts/mp3_extract_tables.py): every codeword
 * individually probed against libmpg123; see file header. */
static const uint8_t ht1_l[] = {
    1,3,2,3,
};
static const uint16_t ht1_c[] = {
    1,1,1,0,
};
static const uint8_t ht2_l[] = {
    1,3,6,3,3,5,5,5,6,
};
static const uint16_t ht2_c[] = {
    1,2,1,3,1,1,3,2,0,
};
static const uint8_t ht3_l[] = {
    2,2,6,3,2,5,5,5,6,
};
static const uint16_t ht3_c[] = {
    3,2,1,1,1,1,3,2,0,
};
static const uint8_t ht5_l[] = {
    1,3,6,7,3,3,6,7,6,6,7,8,7,6,7,8,
};
static const uint16_t ht5_c[] = {
    1,2,6,5,3,1,4,4,7,5,7,1,
    6,1,1,0,
};
static const uint8_t ht6_l[] = {
    3,3,5,7,3,2,4,5,4,4,5,6,6,5,6,7,
};
static const uint16_t ht6_c[] = {
    7,3,5,1,6,2,3,2,5,4,4,1,
    3,3,2,0,
};
static const uint8_t ht7_l[] = {
    1,3,6,8,8,9,3,4,6,7,7,8,6,5,7,8,8,9,
    7,7,8,9,9,9,7,7,8,9,9,10,8,8,9,10,10,10,
};
static const uint16_t ht7_c[] = {
    1,2,10,19,16,10,3,3,7,10,5,3,
    11,4,13,17,8,4,12,11,18,15,11,2,
    7,6,9,14,3,1,6,4,5,3,2,0,
};
static const uint8_t ht8_l[] = {
    2,3,6,8,8,9,3,2,4,8,8,8,6,4,6,8,8,9,
    8,8,8,9,9,10,8,7,8,9,10,10,9,8,9,9,11,11,
};
static const uint16_t ht8_c[] = {
    3,4,6,18,12,5,5,1,2,16,9,3,
    7,3,5,14,7,3,19,17,15,13,10,4,
    13,5,8,11,5,1,12,4,4,1,1,0,
};
static const uint8_t ht9_l[] = {
    3,3,5,6,8,9,3,3,4,5,6,8,4,4,5,6,7,8,
    6,5,6,7,7,8,7,6,7,7,8,9,8,7,8,8,9,9,
};
static const uint16_t ht9_c[] = {
    7,5,9,14,15,7,6,4,5,5,6,7,
    7,6,8,8,8,5,15,6,9,10,5,1,
    11,7,9,6,4,1,14,4,6,2,6,0,
};
static const uint8_t ht10_l[] = {
    1,3,6,8,9,9,9,10,3,4,6,7,8,9,8,8,6,6,
    7,8,9,10,9,9,7,7,8,9,10,10,9,10,8,8,9,10,
    10,10,10,10,9,9,10,10,11,11,10,11,8,8,9,10,10,10,
    11,11,9,8,9,10,10,11,11,11,
};
static const uint16_t ht10_c[] = {
    1,2,10,23,35,30,12,17,3,3,8,12,
    18,21,12,7,11,9,15,21,32,40,19,6,
    14,13,22,34,46,23,18,7,20,19,33,47,
    27,22,9,3,31,22,41,26,21,20,5,3,
    14,13,10,11,16,6,5,1,9,8,7,8,
    4,4,2,0,
};
static const uint8_t ht11_l[] = {
    2,3,5,7,8,9,8,9,3,3,4,6,8,8,7,8,5,5,
    6,7,8,9,8,8,7,6,7,9,8,10,8,9,8,8,8,9,
    9,10,9,10,8,8,9,10,10,11,10,11,8,7,7,8,9,10,
    10,10,8,7,8,9,10,10,10,10,
};
static const uint16_t ht11_c[] = {
    3,4,10,24,34,33,21,15,5,3,4,10,
    32,17,11,10,11,7,13,18,30,31,20,5,
    25,11,19,59,27,18,12,5,35,33,31,58,
    30,16,7,5,28,26,32,19,17,15,8,14,
    14,12,9,13,14,9,4,1,11,4,6,6,
    6,3,2,0,
};
static const uint8_t ht12_l[] = {
    4,3,5,7,8,9,9,9,3,3,4,5,7,7,8,8,5,4,
    5,6,7,8,7,8,6,5,6,6,7,8,8,8,7,6,7,7,
    8,8,8,9,8,7,8,8,8,9,8,9,8,7,7,8,8,9,
    9,10,9,8,8,9,9,9,9,10,
};
static const uint16_t ht12_c[] = {
    9,6,16,33,41,39,38,26,7,5,6,9,
    23,16,26,11,17,7,11,14,21,30,10,7,
    17,10,15,12,18,28,14,5,32,13,22,19,
    18,16,9,5,40,17,31,29,17,13,4,2,
    27,12,11,15,10,7,4,1,27,12,8,12,
    6,3,1,0,
};
static const uint8_t ht13_l[] = {
    1,4,6,7,8,9,9,10,9,10,11,11,12,12,13,13,3,4,
    6,7,8,8,9,9,9,9,10,10,11,12,12,12,6,6,7,8,
    9,9,10,10,9,10,10,11,11,12,13,13,7,7,8,9,9,10,
    10,10,10,11,11,11,11,12,13,13,8,7,9,9,10,10,11,11,
    10,11,11,12,12,13,13,14,9,8,9,10,10,10,11,11,11,11,
    12,11,13,13,14,14,9,9,10,10,11,11,11,11,11,12,12,12,
    13,13,14,14,10,9,10,11,11,11,12,12,12,12,13,13,13,14,
    16,16,9,8,9,10,10,11,11,12,12,12,12,13,13,14,15,15,
    10,9,10,10,11,11,11,13,12,13,13,14,14,14,16,15,10,10,
    10,11,11,12,12,13,12,13,14,13,14,15,16,17,11,10,10,11,
    12,12,12,12,13,13,13,14,15,15,15,16,11,11,11,12,12,13,
    12,13,14,14,15,15,15,16,16,16,12,11,12,13,13,13,14,14,
    14,14,14,15,16,15,16,16,13,12,12,13,13,13,15,14,14,17,
    15,15,15,17,16,16,12,12,13,14,14,14,15,14,15,15,16,16,
    19,18,19,16,
};
static const uint16_t ht13_c[] = {
    1,5,14,21,34,51,46,71,42,52,68,52,
    67,44,43,19,3,4,12,19,31,26,44,33,
    31,24,32,24,31,35,22,14,15,13,23,36,
    59,49,77,65,29,40,30,40,27,33,42,16,
    22,20,37,61,56,79,73,64,43,76,56,37,
    26,31,25,14,35,16,60,57,97,75,114,91,
    54,73,55,41,48,53,23,24,58,27,50,96,
    76,70,93,84,77,58,79,29,74,49,41,17,
    47,45,78,74,115,94,90,79,69,83,71,50,
    59,38,36,15,72,34,56,95,92,85,91,90,
    86,73,77,65,51,44,43,42,43,20,30,44,
    55,78,72,87,78,61,46,54,37,30,20,16,
    53,25,41,37,44,59,54,81,66,76,57,54,
    37,18,39,11,35,33,31,57,42,82,72,80,
    47,58,55,21,22,26,38,22,53,25,23,38,
    70,60,51,36,55,26,34,23,27,14,9,7,
    34,32,28,39,49,75,30,52,48,40,52,28,
    18,17,9,5,45,21,34,64,56,50,49,45,
    31,19,12,15,10,7,6,3,48,23,20,39,
    36,35,53,21,16,23,13,10,6,1,4,2,
    16,15,17,27,25,20,29,11,17,12,16,8,
    1,1,0,1,
};
static const uint8_t ht15_l[] = {
    3,4,5,7,7,8,9,9,9,10,10,11,11,11,12,13,4,3,
    5,6,7,7,8,8,8,9,9,10,10,10,11,11,5,5,5,6,
    7,7,8,8,8,9,9,10,10,11,11,11,6,6,6,7,7,8,
    8,9,9,9,10,10,10,11,11,11,7,6,7,7,8,8,9,9,
    9,9,10,10,10,11,11,11,8,7,7,8,8,8,9,9,9,9,
    10,10,11,11,11,12,9,7,8,8,8,9,9,9,9,10,10,10,
    11,11,12,12,9,8,8,9,9,9,9,10,10,10,10,10,11,11,
    11,12,9,8,8,9,9,9,9,10,10,10,10,11,11,12,12,12,
    9,8,9,9,9,9,10,10,10,11,11,11,11,12,12,12,10,9,
    9,9,10,10,10,10,10,11,11,11,11,12,13,12,10,9,9,9,
    10,10,10,10,11,11,11,11,12,12,12,13,11,10,9,10,10,10,
    11,11,11,11,11,11,12,12,13,13,11,10,10,10,10,11,11,11,
    11,12,12,12,12,12,13,13,12,11,11,11,11,11,11,11,12,12,
    12,12,13,13,12,13,12,11,11,11,11,11,11,12,12,12,12,12,
    13,13,13,13,
};
static const uint16_t ht15_c[] = {
    7,12,18,53,47,76,124,108,89,123,108,119,
    107,81,122,63,13,5,16,27,46,36,61,51,
    42,70,52,83,65,41,59,36,19,17,15,24,
    41,34,59,48,40,64,50,78,62,80,56,33,
    29,28,25,43,39,63,55,93,76,59,93,72,
    54,75,50,29,52,22,42,40,67,57,95,79,
    72,57,89,69,49,66,46,27,77,37,35,66,
    58,52,91,74,62,48,79,63,90,62,40,38,
    125,32,60,56,50,92,78,65,55,87,71,51,
    73,51,70,30,109,53,49,94,88,75,66,122,
    91,73,56,42,64,44,21,25,90,43,41,77,
    73,63,56,92,77,66,47,67,48,53,36,20,
    71,34,67,60,58,49,88,76,67,106,71,54,
    38,39,23,15,109,53,51,47,90,82,58,57,
    48,72,57,41,23,27,62,9,86,42,40,37,
    70,64,52,43,70,55,42,25,29,18,11,11,
    118,68,30,55,50,46,74,65,49,39,24,16,
    22,13,14,7,91,44,39,38,34,63,52,45,
    31,52,28,19,14,8,9,3,123,60,58,53,
    47,43,32,22,37,24,17,12,15,10,2,1,
    71,37,34,30,28,20,17,26,21,16,10,6,
    8,6,2,0,
};
static const uint8_t ht16_l[] = {
    1,4,6,8,9,9,10,10,11,11,11,12,12,12,13,9,3,4,
    6,7,8,9,9,9,10,10,10,11,12,11,12,8,6,6,7,8,
    9,9,10,10,11,10,11,11,11,12,12,9,8,7,8,9,9,10,
    10,10,11,11,12,12,12,13,13,10,9,8,9,9,10,10,11,11,
    11,12,12,12,13,13,13,9,9,8,9,9,10,11,11,12,11,12,
    12,13,13,13,14,10,10,9,9,10,11,11,11,11,12,12,12,12,
    13,13,14,10,10,9,10,10,11,11,11,12,12,13,13,13,13,15,
    15,10,10,10,10,11,11,11,12,12,13,13,13,13,14,14,14,10,
    11,10,10,11,11,12,12,13,13,13,13,14,13,14,13,11,11,11,
    10,11,12,12,12,12,13,14,14,14,15,15,14,10,12,11,11,11,
    12,12,13,14,14,14,14,14,14,13,14,11,12,12,12,12,12,13,
    13,13,13,15,14,14,14,14,16,11,14,12,12,12,13,13,14,14,
    14,16,15,15,15,17,15,11,13,13,11,12,14,14,13,14,14,15,
    16,15,17,15,14,11,9,8,8,9,9,10,10,10,11,11,11,11,
    11,11,11,8,
};
static const uint16_t ht16_c[] = {
    1,5,14,44,74,63,110,93,172,149,138,242,
    225,195,376,17,3,4,12,20,35,62,53,47,
    83,75,68,119,201,107,207,9,15,13,23,38,
    67,58,103,90,161,72,127,117,110,209,206,16,
    45,21,39,69,64,114,99,87,158,140,252,212,
    199,387,365,26,75,36,68,65,115,101,179,164,
    155,264,246,226,395,382,362,9,66,30,59,56,
    102,185,173,265,142,253,232,400,388,378,445,16,
    111,54,52,100,184,178,160,133,257,244,228,217,
    385,366,715,10,98,48,91,88,165,157,148,261,
    248,407,397,372,380,889,884,8,85,84,81,159,
    156,143,260,249,427,401,392,383,727,713,708,7,
    154,76,73,141,131,256,245,426,406,394,384,735,
    359,710,352,11,139,129,67,125,247,233,229,219,
    393,743,737,720,885,882,439,4,243,120,118,115,
    227,223,396,746,742,736,721,712,706,223,436,6,
    202,224,222,218,216,389,386,381,364,888,443,707,
    440,437,1728,4,747,211,210,208,370,379,734,723,
    714,1735,883,877,876,3459,865,2,377,369,102,187,
    726,722,358,711,709,866,1734,871,3458,870,434,0,
    12,10,7,11,10,17,11,9,13,12,10,7,
    5,3,1,3,
};
static const uint8_t ht24_l[] = {
    4,4,6,7,8,9,9,10,10,11,11,11,11,11,12,9,4,4,
    5,6,7,8,8,9,9,9,10,10,10,10,10,8,6,5,6,7,
    7,8,8,9,9,9,9,10,10,10,11,7,7,6,7,7,8,8,
    8,9,9,9,9,10,10,10,10,7,8,7,7,8,8,8,8,9,
    9,9,10,10,10,10,11,7,9,7,8,8,8,8,9,9,9,9,
    10,10,10,10,10,7,9,8,8,8,8,9,9,9,9,10,10,10,
    10,10,11,7,10,8,8,8,9,9,9,9,10,10,10,10,10,11,
    11,8,10,9,9,9,9,9,9,9,9,10,10,10,10,11,11,8,
    10,9,9,9,9,9,9,10,10,10,10,10,11,11,11,8,11,9,
    9,9,9,10,10,10,10,10,10,11,11,11,11,8,11,10,9,9,
    9,10,10,10,10,10,10,11,11,11,11,8,11,10,10,10,10,10,
    10,10,10,10,11,11,11,11,11,8,11,10,10,10,10,10,10,10,
    11,11,11,11,11,11,11,8,12,10,10,10,10,10,10,11,11,11,
    11,11,11,11,11,8,8,7,7,7,7,7,7,7,7,7,7,8,
    8,8,8,4,
};
static const uint16_t ht24_c[] = {
    15,13,46,80,146,262,248,434,426,669,653,649,
    621,517,1032,88,14,12,21,38,71,130,122,216,
    209,198,327,345,319,297,279,42,47,22,41,74,
    68,128,120,221,207,194,182,340,315,295,541,18,
    81,39,75,70,134,125,116,220,204,190,178,325,
    311,293,271,16,147,72,69,135,127,118,112,210,
    200,188,352,323,306,285,540,14,263,66,129,126,
    119,114,214,202,192,180,341,317,301,281,262,12,
    249,123,121,117,113,215,206,195,185,347,330,308,
    291,272,520,10,435,115,111,109,211,203,196,187,
    353,332,313,298,283,531,381,17,427,212,208,205,
    201,193,186,177,169,320,303,286,268,514,377,16,
    335,199,197,191,189,181,174,333,321,305,289,275,
    521,379,371,11,668,184,183,179,175,344,331,314,
    304,290,277,530,383,373,366,10,652,346,171,168,
    164,318,309,299,287,276,263,513,375,368,362,6,
    648,322,316,312,307,302,292,284,269,261,512,376,
    370,364,359,4,620,300,296,294,288,282,273,266,
    515,380,374,369,365,361,357,2,1033,280,278,274,
    267,264,259,382,378,372,367,363,360,358,356,0,
    43,20,19,17,15,13,11,9,7,6,4,7,
    5,3,1,3,
};
static const uint8_t ext_c1a_l[16] = {1,4,4,5,4,6,5,6,4,5,5,6,5,6,6,6};
static const uint16_t ext_c1a_c[16] = {1,5,4,5,6,5,4,4,7,3,6,0,7,2,3,1};
static const uint8_t ext_c1b_l[16] = {4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4};
static const uint16_t ext_c1b_c[16] = {15,14,13,12,11,10,9,8,7,6,5,4,3,2,1,0};
/* END EXTRACTED TABLES */


/* pair tables indexed by table_select 0..31 (4 and 14 unused/NULL);   */
/* 16-23 share table 16's codes, 24-31 share table 24's.               */
static HuffTab HT[34];  /* 0..31 pair tables; 32=count1 A; 33=count1 B */
static const uint8_t LINBITS[32] = {
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    1,2,3,4,6,8,10,13, 4,5,6,7,8,9,11,13};

static long tab_stats[34];   /* decode-use counters (dev/test) */

static int huff_build_tree(HuffTab *t) {
    int n = t->xlen * t->ylen;
    if (t->tree) { free(t->tree); t->tree = NULL; }
    int cap = 2 * n * 20 + 2;
    int16_t *tr = malloc(sizeof(int16_t) * 2 * cap);
    if (!tr) return -1;
    for (int i = 0; i < 2 * cap; i++) tr[i] = 0; /* 0 = unassigned */
    int nodes = 1;
    for (int i = 0; i < n; i++) {
        int len = t->hlen[i];
        unsigned code = t->hcod[i];
        if (len == 0 || len > 19) { free(tr); return -1; }
        int cur = 0;
        for (int b = len - 1; b >= 0; b--) {
            int bit = (code >> b) & 1;
            int16_t *slot = &tr[cur * 2 + bit];
            if (b == 0) {
                if (*slot != 0) { free(tr); return -1; } /* collision */
                *slot = (int16_t)(-(1 + i));
            } else {
                if (*slot == 0) {
                    if (nodes >= cap) { free(tr); return -1; }
                    *slot = (int16_t)nodes++;
                } else if (*slot < 0) { free(tr); return -1; }
                cur = *slot;
            }
        }
    }
    t->tree = tr;
    t->tree_n = nodes;
    t->valid = 1;
    return 0;
}

static void huff_init_tables(void) {
    static int done = 0;
    if (done) return;
    done = 1;
    memset(HT, 0, sizeof(HT));
    struct { int id, xlen; const uint8_t *l; const uint16_t *c; } defs[] = {
        {1, 2, ht1_l, ht1_c},   {2, 3, ht2_l, ht2_c},
        {3, 3, ht3_l, ht3_c},   {5, 4, ht5_l, ht5_c},
        {6, 4, ht6_l, ht6_c},   {7, 6, ht7_l, ht7_c},
        {8, 6, ht8_l, ht8_c},   {9, 6, ht9_l, ht9_c},
        {10, 8, ht10_l, ht10_c}, {11, 8, ht11_l, ht11_c},
        {12, 8, ht12_l, ht12_c}, {13, 16, ht13_l, ht13_c},
        {15, 16, ht15_l, ht15_c}, {16, 16, ht16_l, ht16_c},
        {24, 16, ht24_l, ht24_c},
        {32, 4, ext_c1a_l, ext_c1a_c}, {33, 4, ext_c1b_l, ext_c1b_c},
    };
    for (size_t i = 0; i < sizeof(defs) / sizeof(defs[0]); i++) {
        HuffTab *t = &HT[defs[i].id];
        t->xlen = (uint8_t)defs[i].xlen;
        t->ylen = (uint8_t)defs[i].xlen;
        t->hlen = defs[i].l;
        t->hcod = defs[i].c;
        huff_build_tree(t);
    }
    /* ESC tables share base codes */
    for (int s = 17; s <= 23; s++) HT[s] = HT[16];
    for (int s = 25; s <= 31; s++) HT[s] = HT[24];
    for (int s = 16; s <= 31; s++) HT[s].linbits = LINBITS[s];
}

/* walk tree; returns entry index or -1 */
static int huff_read(const HuffTab *t, Bits *b) {
    int cur = 0;
    for (int depth = 0; depth < 20; depth++) {
        int bit = bits_get1(b);
        int16_t s = t->tree[cur * 2 + bit];
        if (s < 0) return -(int)s - 1;
        if (s == 0) return -1;
        cur = s;
    }
    return -1;
}

/* ------------------------------------------------------------------ */
/* side info                                                           */

typedef struct {
    int part2_3_length, big_values, global_gain, scalefac_compress;
    int window_switching, block_type, mixed_block;
    int table_select[3], subblock_gain[3];
    int region0_count, region1_count;
    int preflag, scalefac_scale, count1table_select;
} GrInfo;

typedef struct {
    int main_data_begin;
    int scfsi[2][4];
    GrInfo gr[2][2];   /* [granule][channel] */
} SideInfo;

static int read_side_info(Bits *b, const Header *h, SideInfo *si) {
    memset(si, 0, sizeof(*si));
    int ngr = h->lsf ? 1 : 2;
    si->main_data_begin = (int)bits_get(b, h->lsf ? 8 : 9);
    bits_get(b, h->lsf ? (h->channels == 1 ? 1 : 2)
                       : (h->channels == 1 ? 5 : 3));
    if (!h->lsf)
        for (int ch = 0; ch < h->channels; ch++)
            for (int i = 0; i < 4; i++) si->scfsi[ch][i] = bits_get1(b);
    for (int g = 0; g < ngr; g++)
        for (int ch = 0; ch < h->channels; ch++) {
            GrInfo *gi = &si->gr[g][ch];
            gi->part2_3_length = (int)bits_get(b, 12);
            gi->big_values = (int)bits_get(b, 9);
            gi->global_gain = (int)bits_get(b, 8);
            gi->scalefac_compress = (int)bits_get(b, h->lsf ? 9 : 4);
            gi->window_switching = bits_get1(b);
            if (gi->window_switching) {
                gi->block_type = (int)bits_get(b, 2);
                gi->mixed_block = bits_get1(b);
                for (int r = 0; r < 2; r++)
                    gi->table_select[r] = (int)bits_get(b, 5);
                gi->table_select[2] = 0;
                for (int w = 0; w < 3; w++)
                    gi->subblock_gain[w] = (int)bits_get(b, 3);
                if (gi->block_type == 0) return -1;
                /* implied regions (mpg123 convention; oracle-checked) */
                gi->region0_count = -1; /* marker: use ws rule */
                gi->region1_count = 0;
            } else {
                gi->block_type = 0;
                gi->mixed_block = 0;
                for (int r = 0; r < 3; r++)
                    gi->table_select[r] = (int)bits_get(b, 5);
                gi->region0_count = (int)bits_get(b, 4);
                gi->region1_count = (int)bits_get(b, 3);
            }
            if (!h->lsf) gi->preflag = bits_get1(b);
            gi->scalefac_scale = bits_get1(b);
            gi->count1table_select = bits_get1(b);
            if (gi->big_values > 288) return -1;
        }
    return 0;
}

/* ------------------------------------------------------------------ */
/* scalefactors                                                        */

typedef struct {
    int l[23];        /* long sfbs */
    int s[3][13];     /* short windows x sfbs */
} Scalefac;

static int read_scalefac_v1(Bits *b, const Header *h, const SideInfo *si,
                            int gr, int ch, Scalefac *sf) {
    const GrInfo *gi = &si->gr[gr][ch];
    int s1 = SLEN[gi->scalefac_compress][0];
    int s2 = SLEN[gi->scalefac_compress][1];
    memset(sf, 0, sizeof(*sf));
    if (gi->window_switching && gi->block_type == 2) {
        if (gi->mixed_block) {
            for (int sfb = 0; sfb < 8; sfb++)
                sf->l[sfb] = (int)bits_get(b, s1);
            for (int sfb = 3; sfb < 6; sfb++)
                for (int w = 0; w < 3; w++)
                    sf->s[w][sfb] = (int)bits_get(b, s1);
            for (int sfb = 6; sfb < 12; sfb++)
                for (int w = 0; w < 3; w++)
                    sf->s[w][sfb] = (int)bits_get(b, s2);
        } else {
            for (int sfb = 0; sfb < 6; sfb++)
                for (int w = 0; w < 3; w++)
                    sf->s[w][sfb] = (int)bits_get(b, s1);
            for (int sfb = 6; sfb < 12; sfb++)
                for (int w = 0; w < 3; w++)
                    sf->s[w][sfb] = (int)bits_get(b, s2);
        }
    } else {
        /* long blocks; scfsi shares granule-0 factors in granule 1 */
        static const int grp[5] = {0, 6, 11, 16, 21};
        for (int g4 = 0; g4 < 4; g4++) {
            int slen = g4 < 2 ? s1 : s2;
            if (gr == 1 && si->scfsi[ch][g4]) continue; /* copied below */
            for (int sfb = grp[g4]; sfb < grp[g4 + 1]; sfb++)
                sf->l[sfb] = (int)bits_get(b, slen);
        }
    }
    return 0;
}

/* LSF (MPEG2/2.5) scalefactors; is_right = this channel is the        */
/* intensity-coded channel (right of a joint-stereo intensity pair).   */
/* `ill` (same layout as sf) receives per-band illegal is_positions    */
/* ((1<<slen)-1 of the partition the band was coded in).               */
static int read_scalefac_lsf(Bits *b, const Header *h, const GrInfo *gi,
                             int is_right, Scalefac *sf, int *int_scale,
                             int *preflag_out, Scalefac *ill) {
    int sc = gi->scalefac_compress;
    int slen[4] = {0, 0, 0, 0};
    int table;
    int pre = 0;
    *int_scale = 0;
    if (!is_right) {
        if (sc < 400) {
            slen[0] = (sc >> 4) / 5; slen[1] = (sc >> 4) % 5;
            slen[2] = (sc & 15) >> 2; slen[3] = sc & 3;
            table = 0;
        } else if (sc < 500) {
            sc -= 400;
            slen[0] = (sc >> 2) / 5; slen[1] = (sc >> 2) % 5;
            slen[2] = sc & 3; slen[3] = 0;
            table = 1;
        } else {
            sc -= 500;
            slen[0] = sc / 3; slen[1] = sc % 3; slen[2] = 0; slen[3] = 0;
            table = 2; pre = 1;
        }
    } else {
        *int_scale = sc & 1;
        sc >>= 1;
        if (sc < 180) {
            slen[0] = sc / 36; slen[1] = (sc % 36) / 6; slen[2] = sc % 6;
            slen[3] = 0; table = 3;
        } else if (sc < 244) {
            sc -= 180;
            slen[0] = (sc & 63) >> 4; slen[1] = (sc & 15) >> 2;
            slen[2] = sc & 3; slen[3] = 0; table = 4;
        } else {
            sc -= 244;
            slen[0] = sc / 3; slen[1] = sc % 3; slen[2] = 0; slen[3] = 0;
            table = 5;
        }
    }
    *preflag_out = pre;
    int btn = 0; /* blocktypenumber */
    if (gi->window_switching && gi->block_type == 2)
        btn = gi->mixed_block ? 2 : 1;
    int buf[54], ibuf[54];
    int n = 0;
    for (int part = 0; part < 4; part++) {
        int cnt = LSF_NSFB[table][btn][part];
        int illegal = slen[part] ? (1 << slen[part]) - 1 : 0;
        for (int i = 0; i < cnt; i++) {
            buf[n] = slen[part] ? (int)bits_get(b, slen[part]) : 0;
            ibuf[n] = illegal;
            n++;
        }
    }
    while (n < 54) { ibuf[n] = 0; buf[n++] = 0; }
    memset(sf, 0, sizeof(*sf));
    if (ill) memset(ill, 0, sizeof(*ill));
    if (btn == 1) {           /* pure short: (sfb, window) order */
        int k = 0;
        for (int sfb = 0; sfb < 12; sfb++)
            for (int w = 0; w < 3; w++, k++) {
                sf->s[w][sfb] = buf[k];
                if (ill) ill->s[w][sfb] = ibuf[k];
            }
    } else if (btn == 2) {    /* mixed: long part then short part */
        int k = 0;
        int nlong = LSF_NSFB[table][2][0];
        for (int sfb = 0; sfb < nlong; sfb++, k++) {
            sf->l[sfb] = buf[k];
            if (ill) ill->l[sfb] = ibuf[k];
        }
        for (int sfb = 3; sfb < 12; sfb++)
            for (int w = 0; w < 3; w++, k++) {
                sf->s[w][sfb] = buf[k];
                if (ill) ill->s[w][sfb] = ibuf[k];
            }
    } else {
        for (int sfb = 0; sfb < 21; sfb++) {
            sf->l[sfb] = buf[sfb];
            if (ill) ill->l[sfb] = ibuf[sfb];
        }
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* huffman spectral decode                                             */

/* decodes into is[576]; returns count of lines decoded or -1 */
static int decode_spectrum(Bits *b, const Header *h, const GrInfo *gi,
                           size_t part2_start, int is[580]) {
    size_t end = part2_start + (size_t)gi->part2_3_length;
    memset(is, 0, sizeof(int) * 580);
    const short *longtab = SFB_LONG[h->sr_row];
    int region1, region2;
    if (gi->window_switching) {
        /* implied regions (mpg123 semantics, each case oracle-measured
         * with single-line table-discriminating probes): MPEG1 ws
         * granules (any block type, mixed or not) use 36; LSF short use
         * 36 (72 at 8 kHz); LSF start/stop use 54 (108 at 8 kHz). */
        if (!h->lsf) region1 = 36;
        else if (gi->block_type == 2) region1 = h->sr_row == 8 ? 72 : 36;
        else region1 = h->sr_row == 8 ? 108 : 54;
        region2 = 576;
    } else {
        int r0 = gi->region0_count + 1;
        int r1 = r0 + gi->region1_count + 1;
        if (r0 > 22) r0 = 22;
        if (r1 > 22) r1 = 22;
        region1 = longtab[r0];
        region2 = longtab[r1];
    }
    int nlines = gi->big_values * 2;
    if (nlines > 576) return -1;
    for (int i = 0; i < nlines; i += 2) {
        /* a stream whose big_values region overruns part2_3_length is
         * decoded truncated: stop before the first pair that would
         * start at/after the boundary, zero the rest (mpg123-style
         * robustness; the per-pair check below keeps a straddling pair
         * that STARTED inside the region, matching the bit positions a
         * sequential decoder naturally consumes) */
        if (b->pos >= end) break;
        int reg = i < region1 ? 0 : (i < region2 ? 1 : 2);
        int sel = gi->table_select[reg];
        if (sel == 0) { is[i] = 0; is[i + 1] = 0; continue; }
        if (sel == 4 || sel == 14 || !HT[sel].valid) return -1;
        HuffTab *t = &HT[sel];
        tab_stats[sel]++;
        int e = huff_read(t, b);
        if (e < 0) return -1;
        int x = e / t->ylen, y = e % t->ylen;
        if (x == 15 && t->linbits) x += (int)bits_get(b, t->linbits);
        if (x) { if (bits_get1(b)) x = -x; }
        if (y == 15 && t->linbits) y += (int)bits_get(b, t->linbits);
        if (y) { if (bits_get1(b)) y = -y; }
        is[i] = x;
        is[i + 1] = y;
    }
    /* count1 region */
    int i = nlines;
    HuffTab *q = &HT[gi->count1table_select ? 33 : 32];
    tab_stats[gi->count1table_select ? 33 : 32]++;
    while (b->pos < end && i <= 572) {
        int e = huff_read(q, b);
        if (e < 0) return -1;
        int vals[4] = {(e >> 3) & 1, (e >> 2) & 1, (e >> 1) & 1, e & 1};
        for (int k = 0; k < 4; k++)
            if (vals[k] && bits_get1(b)) vals[k] = -vals[k];
        if (b->pos > end) break;   /* quad straddling the end: discard */
        for (int k = 0; k < 4; k++) is[i + k] = vals[k];
        i += 4;
    }
    if (i > 576) i = 576;
    b->pos = end;   /* hard resync to the declared region length */
    return i;
}

/* ------------------------------------------------------------------ */
/* requantization (+ line -> sfb geometry)                             */

static double pow43_tab[8208];
static void requant_init(void) {
    static int done = 0;
    if (done) return;
    done = 1;
    for (int i = 0; i < 8208; i++) pow43_tab[i] = pow((double)i, 4.0 / 3.0);
}

/* per-line band info for one granule geometry */
typedef struct {
    uint8_t window[576];   /* 0-2 (short), 0 for long lines */
    uint8_t is_short[576];
    short sfb[576];
} BandMap;

static void build_bandmap(const Header *h, const GrInfo *gi, BandMap *bm) {
    const short *lt = SFB_LONG[h->sr_row];
    const short *st = SFB_SHORT[h->sr_row];
    int shortblk = gi->window_switching && gi->block_type == 2;
    int line = 0;
    if (!shortblk) {
        for (int sfb = 0; sfb < 22; sfb++)
            for (int k = lt[sfb]; k < lt[sfb + 1]; k++) {
                bm->sfb[k] = (short)sfb;
                bm->is_short[k] = 0;
                bm->window[k] = 0;
            }
        return;
    }
    int long_end = 0, sfb_start = 0;
    if (gi->mixed_block) {
        while (lt[long_end + 1] <= 36 && long_end < 21) long_end++;
        for (int sfb = 0; sfb < long_end; sfb++)
            for (int k = lt[sfb]; k < lt[sfb + 1]; k++) {
                bm->sfb[k] = (short)sfb;
                bm->is_short[k] = 0;
                bm->window[k] = 0;
            }
        line = lt[long_end];          /* = 36 for all supported rows */
        while (3 * st[sfb_start] < line && sfb_start < 13) sfb_start++;
    }
    for (int sfb = sfb_start; sfb < 13 && line < 576; sfb++) {
        int width = st[sfb + 1] - st[sfb];
        for (int w = 0; w < 3; w++)
            for (int k = 0; k < width && line < 576; k++, line++) {
                bm->sfb[line] = (short)sfb;
                bm->is_short[line] = 1;
                bm->window[line] = (uint8_t)w;
            }
    }
    for (; line < 576; line++) {      /* safety fill */
        bm->sfb[line] = 12;
        bm->is_short[line] = 1;
        bm->window[line] = 2;
    }
}

static void requantize(const Header *h, const GrInfo *gi,
                       const Scalefac *sf, const BandMap *bm,
                       const int is[576], double xr[576]) {
    double shift = gi->scalefac_scale ? 1.0 : 0.5;
    double g_long = 0.25 * (gi->global_gain - 210);
    double gwin[3];
    for (int w = 0; w < 3; w++)
        gwin[w] = 0.25 * (gi->global_gain - 210 - 8 * gi->subblock_gain[w]);
    for (int i = 0; i < 576; i++) {
        int v = is[i];
        if (v == 0) { xr[i] = 0.0; continue; }
        int a = v < 0 ? -v : v;
        double mag = a < 8208 ? pow43_tab[a] : pow((double)a, 4.0 / 3.0);
        double e;
        if (bm->is_short[i]) {
            int w = bm->window[i];
            e = gwin[w] - shift * sf->s[w][bm->sfb[i]];
        } else {
            int sfb = bm->sfb[i];
            int pre = gi->preflag ? PRETAB[sfb] : 0;
            e = g_long - shift * (sf->l[sfb] + pre);
        }
        xr[i] = (v < 0 ? -mag : mag) * exp2(e);
    }
}

/* ------------------------------------------------------------------ */
/* joint stereo                                                        */

static void stereo_process(const Header *h, const GrInfo *gi_r,
                           const Scalefac *sf_r, const Scalefac *ill_r,
                           const BandMap *bm, int lsf_int_scale,
                           const int is_r[576],
                           double xl[576], double xr[576]) {
    int ms = h->mode_ext & 2;
    int intensity = h->mode_ext & 1;

    /* intensity region: whole scalefactor bands above the last
     * nonzero right-channel band — per window for short blocks
     * (reference semantics: ISO 2.4.3.4.9.3; decoders: dist10
     * III_stereo, mpg123 III_i_stereo). */
    int last_sfb_long = -1, last_sfb_s[3] = {-1, -1, -1};
    if (intensity)
        for (int i = 0; i < 576; i++)
            if (is_r[i]) {
                if (bm->is_short[i]) {
                    int w = bm->window[i];
                    if (bm->sfb[i] > last_sfb_s[w])
                        last_sfb_s[w] = bm->sfb[i];
                } else if (bm->sfb[i] > last_sfb_long) {
                    last_sfb_long = bm->sfb[i];
                }
            }
    for (int i = 0; i < 576; i++) {
        int in_intensity = 0, w = 0, sfb = bm->sfb[i];
        if (intensity) {
            if (bm->is_short[i]) {
                w = bm->window[i];
                in_intensity = sfb > last_sfb_s[w];
            } else {
                /* the long part of a mixed block is intensity-coded
                 * only if the whole short part of every window is
                 * zero too */
                in_intensity = sfb > last_sfb_long &&
                               last_sfb_s[0] < 0 && last_sfb_s[1] < 0 &&
                               last_sfb_s[2] < 0;
            }
        }
        if (in_intensity) {
            int pos = bm->is_short[i] ? sf_r->s[w][sfb] : sf_r->l[sfb];
            int illegal;
            if (h->lsf)
                illegal = bm->is_short[i] ? ill_r->s[w][sfb]
                                          : ill_r->l[sfb];
            else
                illegal = 7;
            double x = xl[i];
            if (pos == illegal) {
                if (ms) {
                    double l = x, r = xr[i];
                    xl[i] = (l + r) * M_SQRT1_2;
                    xr[i] = (l - r) * M_SQRT1_2;
                }
            } else if (!h->lsf) {
                if (pos == 6) {
                    xl[i] = x;
                    xr[i] = 0.0;
                } else {
                    double t = tan(pos * (M_PI / 12.0));
                    xl[i] = x * (t / (1.0 + t));
                    xr[i] = x * (1.0 / (1.0 + t));
                }
            } else {
                double io = lsf_int_scale ? 0.84089641525371454303
                                          : M_SQRT1_2; /* 2^-1/4, 2^-1/2 */
                if (pos == 0) {
                    xr[i] = x;
                } else if (pos & 1) {
                    xl[i] = x * pow(io, (pos + 1) >> 1);
                    xr[i] = x;
                } else {
                    xr[i] = x * pow(io, pos >> 1);
                }
            }
        } else if (ms) {
            double l = xl[i], r = xr[i];
            xl[i] = (l + r) * M_SQRT1_2;
            xr[i] = (l - r) * M_SQRT1_2;
        }
    }
}

/* ------------------------------------------------------------------ */
/* reorder (short blocks): natural (sfb, window, line) -> imdct order  */

static void reorder(const Header *h, const GrInfo *gi, const BandMap *bm,
                    double xr[576]) {
    if (!(gi->window_switching && gi->block_type == 2)) return;
    const short *st = SFB_SHORT[h->sr_row];
    double tmp[576];
    memcpy(tmp, xr, sizeof(tmp));
    /* find first short line (mixed blocks keep the long prefix) */
    int start_line = 0;
    while (start_line < 576 && !bm->is_short[start_line]) start_line++;
    int sfb0 = bm->sfb[start_line];
    int src = start_line;
    for (int sfb = sfb0; sfb < 13; sfb++) {
        int width = st[sfb + 1] - st[sfb];
        int base = 3 * st[sfb];
        for (int w = 0; w < 3; w++)
            for (int k = 0; k < width; k++, src++)
                if (src < 576) xr[base + k * 3 + w] = tmp[src];
    }
}

/* ------------------------------------------------------------------ */
/* antialias                                                           */

static double aa_cs[8], aa_ca[8];
static void aa_init(void) {
    static const double c[8] = {-0.6, -0.535, -0.33, -0.185, -0.095,
                                -0.041, -0.0142, -0.0037};
    for (int i = 0; i < 8; i++) {
        double cs = 1.0 / sqrt(1.0 + c[i] * c[i]);
        aa_cs[i] = cs;
        aa_ca[i] = c[i] * cs;
    }
}

static void antialias(const GrInfo *gi, double xr[576]) {
    int nb = 31;
    if (gi->window_switching && gi->block_type == 2)
        nb = gi->mixed_block ? 1 : 0;
    for (int sb = 1; sb <= nb; sb++)
        for (int i = 0; i < 8; i++) {
            double a = xr[18 * sb - 1 - i];
            double b = xr[18 * sb + i];
            xr[18 * sb - 1 - i] = a * aa_cs[i] - b * aa_ca[i];
            xr[18 * sb + i] = b * aa_cs[i] + a * aa_ca[i];
        }
}

/* ------------------------------------------------------------------ */
/* hybrid synthesis: IMDCT + windowing + overlap-add                   */

static double imdct36_cos[36][18];
static double imdct12_cos[12][6];
static double win_long[4][36];   /* block types 0,1,3 (2 unused) */
static double win_short12[12];

static void imdct_init(void) {
    static int done = 0;
    if (done) return;
    done = 1;
    for (int i = 0; i < 36; i++)
        for (int k = 0; k < 18; k++)
            imdct36_cos[i][k] =
                cos(M_PI / 72.0 * (2 * i + 1 + 18) * (2 * k + 1));
    for (int i = 0; i < 12; i++)
        for (int k = 0; k < 6; k++)
            imdct12_cos[i][k] =
                cos(M_PI / 24.0 * (2 * i + 1 + 6) * (2 * k + 1));
    for (int i = 0; i < 36; i++)
        win_long[0][i] = sin(M_PI / 36.0 * (i + 0.5));
    for (int i = 0; i < 36; i++) {           /* start */
        if (i < 18) win_long[1][i] = sin(M_PI / 36.0 * (i + 0.5));
        else if (i < 24) win_long[1][i] = 1.0;
        else if (i < 30) win_long[1][i] = sin(M_PI / 12.0 * (i - 18 + 0.5));
        else win_long[1][i] = 0.0;
    }
    for (int i = 0; i < 36; i++) {           /* stop */
        if (i < 6) win_long[3][i] = 0.0;
        else if (i < 12) win_long[3][i] = sin(M_PI / 12.0 * (i - 6 + 0.5));
        else if (i < 18) win_long[3][i] = 1.0;
        else win_long[3][i] = sin(M_PI / 36.0 * (i + 0.5));
    }
    for (int i = 0; i < 12; i++)
        win_short12[i] = sin(M_PI / 12.0 * (i + 0.5));
}

/* one subband: X[18] spectral -> out[18] time, updating overlap[18] */
static void hybrid_subband(const double X[18], int block_type,
                           float overlap[18], double out[18]) {
    double raw[36];
    if (block_type == 2) {
        for (int i = 0; i < 36; i++) raw[i] = 0.0;
        for (int w = 0; w < 3; w++) {
            double s[12];
            for (int i = 0; i < 12; i++) {
                double acc = 0.0;
                for (int k = 0; k < 6; k++)
                    acc += X[k * 3 + w] * imdct12_cos[i][k];
                s[i] = acc * win_short12[i];
            }
            int off = 6 + w * 6;
            for (int i = 0; i < 12; i++) raw[off + i] += s[i];
        }
    } else {
        const double *w = win_long[block_type];
        for (int i = 0; i < 36; i++) {
            double acc = 0.0;
            for (int k = 0; k < 18; k++) acc += X[k] * imdct36_cos[i][k];
            raw[i] = acc * w[i];
        }
    }
    for (int i = 0; i < 18; i++) {
        out[i] = raw[i] + overlap[i];
        overlap[i] = (float)raw[i + 18];
    }
}

/* ------------------------------------------------------------------ */
/* polyphase synthesis filterbank                                      */

static double synth_n[64][32];
/* D window: ISO synthesis window (dewindow), 512 coefficients, all    */
/* integer multiples of 1/65536. Values verified/extracted against     */
/* libmpg123 by least squares (scripts/mp3_extract_tables.py); see     */
/* tests/test_mp3.py::test_dwindow_verified.                           */
static float dwindow[512];
static int32_t dwindow_num[512];  /* numerators (value = num / 65536) */

static void synth_init(void) {
    static int done = 0;
    if (done) return;
    done = 1;
    for (int i = 0; i < 64; i++)
        for (int k = 0; k < 32; k++)
            synth_n[i][k] = cos((16 + i) * (2 * k + 1) * M_PI / 64.0);
    /* Extracted + verified against libmpg123 by per-lane least
     * squares over probe streams (scripts/mp3_extract_tables.py):
     * residual ~1e-13 relative, every value an exact multiple of
     * 1/65536 (the ISO dewindow grid), held-out full-stream SNR
     * 128 dB. Lane 16 of the solve is rank-deficient (the matrixing
     * is symmetric there), so those entries are the minimum-norm
     * representative — functionally identical for every input. */
    static const int32_t dnum[512] = {
    0, -1, -1, -1, -1, -1, -1, -2,
    -2, -2, -2, -3, -3, -4, -4, -5,
    0, -6, -7, -7, -8, -9, -10, -11,
    -13, -14, -16, -17, -19, -21, -24, -26,
    -29, -31, -35, -38, -41, -45, -49, -53,
    -58, -63, -68, -73, -79, -85, -91, -97,
    -104, -111, -117, -125, -132, -139, -147, -154,
    -161, -169, -176, -183, -190, -196, -202, -208,
    213, 218, 222, 225, 227, 228, 228, 227,
    224, 221, 215, 208, 200, 189, 177, 163,
    0, 127, 106, 83, 57, 29, -2, -36,
    -72, -111, -153, -197, -244, -294, -347, -401,
    -459, -519, -581, -645, -711, -779, -848, -919,
    -991, -1064, -1137, -1210, -1283, -1356, -1428, -1498,
    -1567, -1634, -1698, -1759, -1817, -1870, -1919, -1962,
    -2001, -2032, -2057, -2075, -2085, -2087, -2080, -2063,
    2037, 2000, 1952, 1893, 1822, 1739, 1644, 1535,
    1414, 1280, 1131, 970, 794, 605, 402, 185,
    0, -288, -545, -814, -1095, -1388, -1692, -2006,
    -2330, -2663, -3004, -3351, -3705, -4063, -4425, -4788,
    -5153, -5517, -5879, -6237, -6589, -6935, -7271, -7597,
    -7910, -8209, -8491, -8755, -8998, -9219, -9416, -9585,
    -9727, -9838, -9916, -9959, -9966, -9935, -9863, -9750,
    -9592, -9389, -9139, -8840, -8492, -8092, -7640, -7134,
    6574, 5959, 5288, 4561, 3776, 2935, 2037, 1082,
    70, -998, -2122, -3300, -4533, -5818, -7154, -8540,
    0, -11455, -12980, -14548, -16155, -17799, -19478, -21189,
    -22929, -24694, -26482, -28289, -30112, -31947, -33791, -35640,
    -37489, -39336, -41176, -43006, -44821, -46617, -48390, -50137,
    -51853, -53534, -55178, -56778, -58333, -59838, -61289, -62684,
    -64019, -65290, -66494, -67629, -68692, -69679, -70590, -71420,
    -72169, -72835, -73415, -73908, -74313, -74630, -74856, -74992,
    75038, 74992, 74856, 74630, 74313, 73908, 73415, 72835,
    72169, 71420, 70590, 69679, 68692, 67629, 66494, 65290,
    0, 62684, 61289, 59838, 58333, 56778, 55178, 53534,
    51853, 50137, 48390, 46617, 44821, 43006, 41176, 39336,
    37489, 35640, 33791, 31947, 30112, 28289, 26482, 24694,
    22929, 21189, 19478, 17799, 16155, 14548, 12980, 11455,
    9975, 8540, 7154, 5818, 4533, 3300, 2122, 998,
    -70, -1082, -2037, -2935, -3776, -4561, -5288, -5959,
    6574, 7134, 7640, 8092, 8492, 8840, 9139, 9389,
    9592, 9750, 9863, 9935, 9966, 9959, 9916, 9838,
    0, 9585, 9416, 9219, 8998, 8755, 8491, 8209,
    7910, 7597, 7271, 6935, 6589, 6237, 5879, 5517,
    5153, 4788, 4425, 4063, 3705, 3351, 3004, 2663,
    2330, 2006, 1692, 1388, 1095, 814, 545, 288,
    45, -185, -402, -605, -794, -970, -1131, -1280,
    -1414, -1535, -1644, -1739, -1822, -1893, -1952, -2000,
    2037, 2063, 2080, 2087, 2085, 2075, 2057, 2032,
    2001, 1962, 1919, 1870, 1817, 1759, 1698, 1634,
    0, 1498, 1428, 1356, 1283, 1210, 1137, 1064,
    991, 919, 848, 779, 711, 645, 581, 519,
    459, 401, 347, 294, 244, 197, 153, 111,
    72, 36, 2, -29, -57, -83, -106, -127,
    -146, -163, -177, -189, -200, -208, -215, -221,
    -224, -227, -228, -228, -227, -225, -222, -218,
    213, 208, 202, 196, 190, 183, 176, 169,
    161, 154, 147, 139, 132, 125, 117, 111,
    0, 97, 91, 85, 79, 73, 68, 63,
    58, 53, 49, 45, 41, 38, 35, 31,
    29, 26, 24, 21, 19, 17, 16, 14,
    13, 11, 10, 9, 8, 7, 7, 6,
    5, 5, 4, 4, 3, 3, 2, 2,
    2, 2, 1, 1, 1, 1, 1, 1,
    };
    memcpy(dwindow_num, dnum, sizeof(dnum));
    for (int i = 0; i < 512; i++)
        dwindow[i] = (float)(dwindow_num[i] / 65536.0);
}

typedef struct {
    float v[2][1024];
    float overlap[2][32][18];
} SynthState;

/* one granule-row: S[32] subband samples -> 32 PCM samples.           */
/* utrace, when non-NULL, receives the 512 U values for this row.      */
static void synth_row(SynthState *st, int ch, const double S[32],
                      float *pcm_out, int stride, float *utrace) {
    float *v = st->v[ch];
    memmove(v + 64, v, 960 * sizeof(float));
    for (int i = 0; i < 64; i++) {
        double acc = 0.0;
        for (int k = 0; k < 32; k++) acc += synth_n[i][k] * S[k];
        v[i] = (float)acc;
    }
    float u[512];
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 32; j++) {
            u[i * 64 + j] = v[i * 128 + j];
            u[i * 64 + 32 + j] = v[i * 128 + 96 + j];
        }
    if (utrace) memcpy(utrace, u, sizeof(u));
    for (int j = 0; j < 32; j++) {
        double acc = 0.0;
        for (int i = 0; i < 16; i++)
            acc += (double)u[j + 32 * i] * dwindow[j + 32 * i];
        pcm_out[j * stride] = (float)acc;
    }
}

/* ------------------------------------------------------------------ */
/* decoder state + frame decode                                        */

#define MD_CAP 65536

typedef struct {
    SynthState synth;
    uint8_t md[MD_CAP];
    int md_len;
    float *out;
    size_t out_cap, out_n;      /* samples per channel */
    int channels, sr;
    int frames_ok, frames_skipped;
    float *urows;               /* dev trace (ch 0) */
    size_t urows_n, urows_cap;
    int trace;
} Dec;

static int dec_out_ensure(Dec *d, size_t add) {
    size_t need = (d->out_n + add) * (size_t)d->channels;
    if (need <= d->out_cap) return 0;
    size_t cap = d->out_cap ? d->out_cap : 1 << 16;
    while (cap < need) cap *= 2;
    float *p = realloc(d->out, cap * sizeof(float));
    if (!p) return -1;
    d->out = p;
    d->out_cap = cap;
    return 0;
}

static int dec_trace_ensure(Dec *d, size_t add) {
    size_t need = (d->urows_n + add) * 512;
    if (need <= d->urows_cap) return 0;
    size_t cap = d->urows_cap ? d->urows_cap : 1 << 18;
    while (cap < need) cap *= 2;
    float *p = realloc(d->urows, cap * sizeof(float));
    if (!p) return -1;
    d->urows = p;
    d->urows_cap = cap;
    return 0;
}

/* decode the granules of one frame whose main data is ready.          */
static int decode_frame_audio(Dec *d, const Header *h, const SideInfo *si,
                              Bits *b) {
    int ngr = h->lsf ? 1 : 2;
    int nch = h->channels;
    int nsamp = ngr * 576 / 32 * 32;  /* 576 or 1152 */
    if (dec_out_ensure(d, (size_t)nsamp)) return -1;
    if (d->trace && dec_trace_ensure(d, (size_t)(ngr * 18))) return -1;

    Scalefac sf_gr0[2];
    memset(sf_gr0, 0, sizeof(sf_gr0));
    for (int g = 0; g < ngr; g++) {
        double xr[2][576];
        int is_dec[2][580];
        Scalefac sf[2], ill[2];
        BandMap bm[2];
        int lsf_int_scale = 0;
        for (int ch = 0; ch < nch; ch++) {
            const GrInfo *gi = &si->gr[g][ch];
            size_t part2_start = b->pos;
            if (h->lsf) {
                int is_right = (h->mode == 1) && (h->mode_ext & 1) &&
                               ch == 1;
                int pre;
                read_scalefac_lsf(b, h, gi, is_right, &sf[ch],
                                  &lsf_int_scale, &pre, &ill[ch]);
                ((GrInfo *)gi)->preflag = pre;
            } else {
                read_scalefac_v1(b, h, si, g, ch, &sf[ch]);
                if (g == 1) {
                    static const int grp[5] = {0, 6, 11, 16, 21};
                    for (int g4 = 0; g4 < 4; g4++)
                        if (si->scfsi[ch][g4])
                            for (int sfb = grp[g4]; sfb < grp[g4 + 1];
                                 sfb++)
                                sf[ch].l[sfb] = sf_gr0[ch].l[sfb];
                } else {
                    sf_gr0[ch] = sf[ch];
                }
            }
            if (decode_spectrum(b, h, gi, part2_start, is_dec[ch]) < 0)
                return -1;
            build_bandmap(h, gi, &bm[ch]);
            requantize(h, gi, &sf[ch], &bm[ch], is_dec[ch], xr[ch]);
        }
        if (nch == 2 && h->mode == 1 && (h->mode_ext & 3))
            stereo_process(h, &si->gr[g][1], &sf[1], &ill[1], &bm[1],
                           lsf_int_scale, is_dec[1], xr[0], xr[1]);
        for (int ch = 0; ch < nch; ch++) {
            const GrInfo *gi = &si->gr[g][ch];
            reorder(h, gi, &bm[ch], xr[ch]);
            antialias(gi, xr[ch]);
            /* hybrid per subband */
            double tdomain[576];
            for (int sb = 0; sb < 32; sb++) {
                int bt = gi->block_type;
                if (gi->window_switching && gi->block_type == 2 &&
                    gi->mixed_block && sb < 2)
                    bt = 0;
                else if (!gi->window_switching)
                    bt = 0;
                hybrid_subband(&xr[ch][sb * 18], bt,
                               d->synth.overlap[ch][sb],
                               &tdomain[sb * 18]);
            }
            /* frequency inversion */
            for (int sb = 1; sb < 32; sb += 2)
                for (int i = 1; i < 18; i += 2)
                    tdomain[sb * 18 + i] = -tdomain[sb * 18 + i];
            /* polyphase: 18 rows of 32 */
            for (int row = 0; row < 18; row++) {
                double S[32];
                for (int sb = 0; sb < 32; sb++)
                    S[sb] = tdomain[sb * 18 + row];
                float *dst = d->out +
                             (d->out_n + (size_t)(g * 576 + row * 32)) *
                                 d->channels + ch;
                float *ut = NULL;
                if (d->trace && ch == 0) {
                    ut = d->urows + d->urows_n * 512;
                    d->urows_n++;
                }
                synth_row(&d->synth, ch, S, dst, d->channels, ut);
            }
        }
    }
    d->out_n += (size_t)nsamp;
    return 0;
}

/* ------------------------------------------------------------------ */
/* stream walk                                                         */

static size_t skip_id3v2(const uint8_t *p, size_t n) {
    if (n >= 10 && p[0] == 'I' && p[1] == 'D' && p[2] == '3') {
        size_t sz = ((size_t)(p[6] & 0x7F) << 21) |
                    ((size_t)(p[7] & 0x7F) << 14) |
                    ((size_t)(p[8] & 0x7F) << 7) | (p[9] & 0x7F);
        size_t skip = 10 + sz + ((p[5] & 0x10) ? 10 : 0);
        return skip <= n ? skip : n;
    }
    return 0;
}

static int is_tag_frame(const uint8_t *frame, const Header *h, size_t n) {
    size_t off = 4 + (h->crc ? 2 : 0) + (size_t)h->side_bytes;
    if (off + 4 > n) return 0;
    const uint8_t *p = frame + off;
    return (memcmp(p, "Xing", 4) == 0 || memcmp(p, "Info", 4) == 0 ||
            memcmp(p, "VBRI", 4) == 0);
}

/* decode full stream; returns 0 ok (>=1 frame), -1 no frames */
static int decode_stream(Dec *d, const uint8_t *data, size_t n) {
    size_t pos = skip_id3v2(data, n);
    if (n >= 128 && memcmp(data + n - 128, "TAG", 3) == 0) n -= 128;
    int first = 1;
    while (pos + 4 <= n) {
        Header h;
        if (parse_header(data + pos, &h) != 0) { pos++; continue; }
        if (pos + (size_t)h.frame_bytes > n) break;
        /* guard against false sync: next header must parse too (when
         * there is room for one) */
        if (pos + (size_t)h.frame_bytes + 4 <= n) {
            Header h2;
            if (parse_header(data + pos + h.frame_bytes, &h2) != 0) {
                /* allow: could be last frame followed by a tag */
                size_t q = pos + (size_t)h.frame_bytes;
                if (!(q + 3 <= n && memcmp(data + q, "TAG", 3) == 0) &&
                    q + 4 <= n) {
                    pos++;
                    continue;
                }
            }
        }
        if (d->channels == 0) {
            d->channels = h.channels;
            d->sr = h.sr;
        } else if (h.channels != d->channels || h.sr != d->sr) {
            pos++;   /* mid-stream format change: treat as false sync */
            continue;
        }
        const uint8_t *frame = data + pos;
        if (first && is_tag_frame(frame, &h, (size_t)h.frame_bytes)) {
            first = 0;
            pos += (size_t)h.frame_bytes;
            continue;
        }
        first = 0;
        size_t hdr = 4 + (h.crc ? 2 : 0);
        Bits sb;
        bits_init(&sb, frame + hdr, (size_t)h.side_bytes);
        SideInfo si;
        int ok = read_side_info(&sb, &h, &si) == 0;
        /* reservoir append */
        int md_bytes = h.frame_bytes - (int)hdr - h.side_bytes;
        if (md_bytes < 0) { pos++; continue; }
        int start = d->md_len - si.main_data_begin;
        if (d->md_len + md_bytes > MD_CAP) {
            int drop = d->md_len + md_bytes - MD_CAP;
            if (drop > d->md_len) drop = d->md_len;
            memmove(d->md, d->md + drop, (size_t)(d->md_len - drop));
            d->md_len -= drop;
            start -= drop;
        }
        memcpy(d->md + d->md_len, frame + hdr + h.side_bytes,
               (size_t)md_bytes);
        d->md_len += md_bytes;
        if (ok && start >= 0) {
            Bits b;
            bits_init(&b, d->md, (size_t)d->md_len);
            b.pos = (size_t)start * 8;
            if (decode_frame_audio(d, &h, &si, &b) == 0)
                d->frames_ok++;
            else
                d->frames_skipped++;
        } else {
            d->frames_skipped++;
        }
        pos += (size_t)h.frame_bytes;
    }
    return d->frames_ok > 0 ? 0 : -1;
}

/* ------------------------------------------------------------------ */
/* python bindings                                                     */

static void mp3_init_all(void) {
    huff_init_tables();
    requant_init();
    aa_init();
    imdct_init();
    synth_init();
}

static PyObject *decode_common(PyObject *args, int trace) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    mp3_init_all();
    Dec *d = calloc(1, sizeof(Dec));
    if (!d) { PyBuffer_Release(&view); return PyErr_NoMemory(); }
    d->trace = trace;
    int rc;
    Py_BEGIN_ALLOW_THREADS
    rc = decode_stream(d, (const uint8_t *)view.buf, (size_t)view.len);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    if (rc != 0) {
        free(d->out);
        free(d->urows);
        free(d);
        PyErr_SetString(PyExc_ValueError,
                        "no decodable MPEG Layer III frames found "
                        "(Layer I/II and free-format streams are not "
                        "supported)");
        return NULL;
    }
    PyObject *pcm = PyBytes_FromStringAndSize(
        (const char *)d->out,
        (Py_ssize_t)(d->out_n * (size_t)d->channels * sizeof(float)));
    PyObject *res = NULL;
    if (pcm) {
        if (trace) {
            PyObject *ub = PyBytes_FromStringAndSize(
                (const char *)d->urows,
                (Py_ssize_t)(d->urows_n * 512 * sizeof(float)));
            if (ub)
                res = Py_BuildValue("(OniiOn)", pcm, (Py_ssize_t)d->out_n,
                                    d->channels, d->sr, ub,
                                    (Py_ssize_t)d->urows_n);
            Py_XDECREF(ub);
        } else {
            res = Py_BuildValue("(Onii)", pcm, (Py_ssize_t)d->out_n,
                                d->channels, d->sr);
        }
    }
    Py_XDECREF(pcm);
    free(d->out);
    free(d->urows);
    free(d);
    return res;
}

PyObject *vrt_mp3_decode(PyObject *self, PyObject *args) {
    (void)self;
    return decode_common(args, 0);
}

PyObject *vrt_mp3_decode_trace(PyObject *self, PyObject *args) {
    (void)self;
    return decode_common(args, 1);
}

/* mp3_huff_get(table_id) -> (xlen, ylen, linbits, lens, codes) */
PyObject *vrt_mp3_huff_get(PyObject *self, PyObject *args) {
    (void)self;
    int id;
    if (!PyArg_ParseTuple(args, "i", &id)) return NULL;
    mp3_init_all();
    if (id < 0 || id > 33 || HT[id].hlen == NULL) {
        PyErr_SetString(PyExc_ValueError, "unknown huffman table");
        return NULL;
    }
    HuffTab *t = &HT[id];
    int n = t->xlen * t->ylen;
    PyObject *lens = PyBytes_FromStringAndSize((const char *)t->hlen, n);
    PyObject *codes = PyBytes_FromStringAndSize((const char *)t->hcod,
                                                n * 2);
    PyObject *r = Py_BuildValue("(iiiOO)", t->xlen, t->ylen, t->linbits,
                                lens, codes);
    Py_XDECREF(lens);
    Py_XDECREF(codes);
    return r;
}

/* mp3_huff_set(table_id, lens_bytes, codes_bytes_u16le) — dev hook */
PyObject *vrt_mp3_huff_set(PyObject *self, PyObject *args) {
    (void)self;
    int id;
    Py_buffer lv, cv;
    if (!PyArg_ParseTuple(args, "iy*y*", &id, &lv, &cv)) return NULL;
    mp3_init_all();
    /* ESC tables 17-23/25-31 alias 16/24's code storage (struct copies in
     * huff_init_tables): rebuilding one in place would free the shared tree
     * out from under its siblings. Canonicalize to the owning base table —
     * per spec they share codes and differ only in linbits. */
    if (id >= 17 && id <= 23) id = 16;
    else if (id >= 25 && id <= 31) id = 24;
    if (id < 0 || id > 33 || HT[id].hlen == NULL) {
        PyBuffer_Release(&lv);
        PyBuffer_Release(&cv);
        PyErr_SetString(PyExc_ValueError, "unknown huffman table");
        return NULL;
    }
    HuffTab *t = &HT[id];
    int n = t->xlen * t->ylen;
    if (lv.len != n || cv.len != n * 2) {
        PyBuffer_Release(&lv);
        PyBuffer_Release(&cv);
        PyErr_SetString(PyExc_ValueError, "bad table size");
        return NULL;
    }
    uint8_t *nl = malloc((size_t)n);
    uint16_t *nc = malloc((size_t)n * 2);
    memcpy(nl, lv.buf, (size_t)n);
    memcpy(nc, cv.buf, (size_t)n * 2);
    PyBuffer_Release(&lv);
    PyBuffer_Release(&cv);
    free(t->own_l);
    free(t->own_c);
    t->own_l = nl;
    t->own_c = nc;
    t->hlen = nl;
    t->hcod = nc;
    int rc = huff_build_tree(t);
    /* ESC aliases share storage: re-point them */
    if (id == 16)
        for (int s = 17; s <= 23; s++) {
            int lb = HT[s].linbits;
            HT[s] = HT[16];
            HT[s].linbits = (uint8_t)lb;
        }
    if (id == 24)
        for (int s = 25; s <= 31; s++) {
            int lb = HT[s].linbits;
            HT[s] = HT[24];
            HT[s].linbits = (uint8_t)lb;
        }
    if (rc != 0) {
        PyErr_SetString(PyExc_ValueError,
                        "table rejected: not a valid prefix code");
        return NULL;
    }
    Py_RETURN_NONE;
}

PyObject *vrt_mp3_dwindow_get(PyObject *self, PyObject *args) {
    (void)self;
    (void)args;
    mp3_init_all();
    return PyBytes_FromStringAndSize((const char *)dwindow,
                                     512 * sizeof(float));
}

PyObject *vrt_mp3_dwindow_set(PyObject *self, PyObject *args) {
    (void)self;
    Py_buffer v;
    if (!PyArg_ParseTuple(args, "y*", &v)) return NULL;
    mp3_init_all();
    if (v.len != 512 * (Py_ssize_t)sizeof(float)) {
        PyBuffer_Release(&v);
        PyErr_SetString(PyExc_ValueError, "need 512 float32 values");
        return NULL;
    }
    memcpy(dwindow, v.buf, 512 * sizeof(float));
    PyBuffer_Release(&v);
    Py_RETURN_NONE;
}

PyObject *vrt_mp3_table_stats(PyObject *self, PyObject *args) {
    (void)self;
    (void)args;
    PyObject *d = PyDict_New();
    for (int i = 0; i < 34; i++)
        if (tab_stats[i]) {
            PyObject *k = PyLong_FromLong(i);
            PyObject *v = PyLong_FromLong(tab_stats[i]);
            PyDict_SetItem(d, k, v);
            Py_DECREF(k);
            Py_DECREF(v);
        }
    return d;
}
