/* aacdec.c — AAC-LC + HE-AAC decoder with ADTS and MP4/M4A demuxing.
 *
 * Closes the reference's .m4a/.mp4/.aac ingest path (the reference
 * decodes these through librosa -> audioread -> ffmpeg; reference
 * inference.py:136-138 and lib/dataset.py:147 list the accepted
 * extensions) without any external backend. ISO/IEC 14496-3 subpart 4
 * low-complexity profile: SCE/CPE/LFE elements, long/short window
 * sequences with sine and Kaiser-Bessel-derived shapes, pulse, TNS,
 * PNS, M/S and intensity stereo. MPEG-2 AAC-LC (13818-7) ADTS streams
 * decode through the same path (the LC syntax is identical).
 * HE-AAC (SBR) reconstructs the full band via sbrdec.c — implicit
 * ADTS signaling (SBR fill elements) and explicit aot-5 ASCs both
 * supported; HE-AAC v2 parametric stereo is not (clear error, the
 * Python layer falls back to ffmpeg when present).
 *
 * Huffman code tables and scalefactor-band offset tables are
 * ORACLE-EXTRACTED: every codeword was individually confirmed against
 * the system libav decoder by scripts/aac_extract_tables.py (see that
 * file's header for the probe methodology) — no table data is copied
 * from any decoder source. The dev hooks aac_huff_set / aac_swb_set
 * let the extraction rig re-verify the baked tables at test time
 * (tests/test_aac.py), mirroring mp3dec.c's mp3_huff_set.
 *
 * Like the mp3/flac decoders this file has no dependencies beyond
 * libc + CPython.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "sbrdec.h"

/* ------------------------------------------------------------------ */
/* bit reader                                                          */

typedef struct {
    const uint8_t *p;
    size_t len;      /* bytes */
    size_t pos;      /* bits */
    int error;
} Bits;

static void bits_init(Bits *b, const uint8_t *p, size_t len) {
    b->p = p;
    b->len = len;
    b->pos = 0;
    b->error = 0;
}

static uint32_t bits_get(Bits *b, int n) {
    uint32_t v = 0;
    if (b->pos + (size_t)n > b->len * 8) {
        b->error = 1;
        b->pos = b->len * 8;
        return 0;
    }
    for (int i = 0; i < n; i++) {
        v = (v << 1) | ((b->p[b->pos >> 3] >> (7 - (b->pos & 7))) & 1);
        b->pos++;
    }
    return v;
}

static int bits_get1(Bits *b) { return (int)bits_get(b, 1); }

static void bits_align(Bits *b) { b->pos = (b->pos + 7) & ~(size_t)7; }

/* ------------------------------------------------------------------ */
/* huffman tables (oracle-extracted; settable via dev hook)            */
/*                                                                     */
/* book 0 = scalefactor book (121 entries, value = index - 60);        */
/* books 1..11 = spectral. Spectral index order: signed books          */
/* idx = sum (v_i + LAV) * (2 LAV + 1)^(dims-1-i); unsigned books      */
/* idx = sum  v_i * (LAV + 1)^(dims-1-i)  (magnitudes; sign bits are   */
/* read separately). Book 11 uses LAV 16 (16 = ESC marker).            */

typedef struct {
    int n;            /* entries */
    int dims;         /* 2 or 4 (0 for the sf book) */
    int lav;
    int sign;         /* signed codebook (values baked into the index) */
    const uint8_t *len;
    const uint32_t *code;
    uint8_t *own_len;
    uint32_t *own_code;
    int16_t *tree;    /* [node][bit] -> >0 child, <=0 ~entry, built on init */
    int tree_n;
    int valid;
} AHuff;

/* table data + binder live in the EXTRACTED TABLES block at the end
 * of this file (written by scripts/aac_extract_tables.py --bake) */
static void aac_tables_bind(void);

static AHuff HCB[12]; /* 0 = sf, 1..11 spectral */
static const int BOOK_DIMS[12] = {0, 4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2};
static const int BOOK_LAV[12] = {0, 1, 1, 2, 2, 4, 4, 7, 7, 12, 12, 16};
static const int BOOK_SIGNED[12] = {0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0};

static int ahuff_build(AHuff *t) {
    free(t->tree);
    t->tree = NULL;
    t->valid = 0;
    if (!t->len || !t->code || t->n <= 0) return -1;
    int cap = 2 * t->n * 25 + 2;
    int16_t *tr = calloc((size_t)cap * 2, sizeof(int16_t));
    if (!tr) return -1;
    int nodes = 1;
    for (int i = 0; i < t->n; i++) {
        int L = t->len[i];
        uint32_t code = t->code[i];
        if (L == 0 || L > 24) { free(tr); return -1; }
        int cur = 0;
        for (int b = L - 1; b >= 0; b--) {
            int bit = (int)((code >> b) & 1);
            int16_t *slot = &tr[cur * 2 + bit];
            if (b == 0) {
                if (*slot != 0) { free(tr); return -1; }
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

static int ahuff_read(const AHuff *t, Bits *b) {
    int cur = 0;
    for (int depth = 0; depth < 25; depth++) {
        int bit = bits_get1(b);
        if (b->error) return -1;
        int16_t s = t->tree[cur * 2 + bit];
        if (s < 0) return -(int)s - 1;
        if (s == 0) return -1;
        cur = s;
    }
    return -1;
}

static void aac_tables_init(void) {
    static int done = 0;
    if (done) return;
    done = 1;
    memset(HCB, 0, sizeof(HCB));
    for (int i = 0; i < 12; i++) {
        HCB[i].dims = BOOK_DIMS[i];
        HCB[i].lav = BOOK_LAV[i];
        HCB[i].sign = BOOK_SIGNED[i];
        if (i == 0) {
            HCB[i].n = 121;
        } else if (BOOK_SIGNED[i]) {
            int base = 2 * BOOK_LAV[i] + 1, n = 1;
            for (int d = 0; d < BOOK_DIMS[i]; d++) n *= base;
            HCB[i].n = n;
        } else {
            int base = BOOK_LAV[i] + 1, n = 1;
            for (int d = 0; d < BOOK_DIMS[i]; d++) n *= base;
            HCB[i].n = n;
        }
    }
    aac_tables_bind();
    for (int i = 0; i < 12; i++)
        if (HCB[i].len) ahuff_build(&HCB[i]);
}

/* ------------------------------------------------------------------ */
/* scalefactor-band offset tables (oracle-extracted; settable)         */

static const int SR_TAB[16] = {96000, 88200, 64000, 48000, 44100, 32000,
                               24000, 22050, 16000, 12000, 11025, 8000,
                               7350, 0, 0, 0};

typedef struct {
    int num_long, num_short;
    uint16_t off_long[64];   /* num_long + 1 entries */
    uint16_t off_short[20];
    int valid;
} SwbTab;

static SwbTab SWB[13];

/* TNS band caps per sampling-frequency index (long windows); verified
 * against the oracle by crafted TNS probes (tests/test_aac.py). */
static uint8_t TNS_MAX_BANDS_LONG[13] = {31, 31, 34, 40, 42, 51, 46, 46,
                                         42, 42, 42, 39, 39};
static uint8_t TNS_MAX_BANDS_SHORT[13] = {9, 9, 10, 14, 14, 14, 14, 14,
                                          14, 14, 14, 14, 14};

/* ------------------------------------------------------------------ */
/* per-channel decode state                                            */

#define MAX_CH 2

typedef struct {
    float coef[1024];        /* dequantized spectrum (deinterleaved) */
    int band_cb[8][64];      /* per group */
    int sf[8][64];           /* scalefactor / noise energy / is position */
    int window_sequence;
    int window_shape;
    int max_sfb;
    int num_windows;
    int num_groups;
    int group_len[8];
    int pulse_present, pulse_n, pulse_start;
    int pulse_pos[4], pulse_amp[4];
    /* tns */
    int tns_present;
    int tns_n_filt[8];
    int tns_len[8][4], tns_order[8][4], tns_dir[8][4];
    float tns_coef[8][4][20];
} ICS;

typedef struct {
    float overlap[1024];
    int prev_shape;
    int prev_seq;
    uint32_t rng;            /* PNS state, per channel */
} ChanState;

/* output scale: maps dequantized spectral values (2^((sf-100)/4)
 * gains, spec 2/N IMDCT) to the reference decoder's float PCM
 * convention; oracle-calibrated to exactly 2^-15 — i.e. libav's
 * full-scale-int16 float normalization (tests pin this). */
static double out_scale = 1.0 / 32768.0;

/* ------------------------------------------------------------------ */
/* windows                                                             */

static float win_sine_long[1024], win_sine_short[128];
static float win_kbd_long[1024], win_kbd_short[128];

static double bessel_i0(double x) {
    double s = 1.0, t = 1.0;
    for (int k = 1; k < 64; k++) {
        t *= (x / (2.0 * k)) * (x / (2.0 * k));
        s += t;
        if (t < 1e-21 * s) break;
    }
    return s;
}

static void kbd_window(float *w, int n, double alpha) {
    /* KBD of transform size 2n: left half from a Kaiser kernel of
     * length n+1 */
    double *v = malloc(sizeof(double) * (size_t)(n + 1));
    double sum = 0.0;
    for (int j = 0; j <= n; j++) {
        double r = 2.0 * j / n - 1.0;
        v[j] = bessel_i0(M_PI * alpha * sqrt(1.0 - r * r));
        sum += v[j];
    }
    double c = 0.0;
    for (int j = 0; j < n; j++) {
        c += v[j];
        w[j] = (float)sqrt(c / sum);
    }
    free(v);
}

static void windows_init(void) {
    static int done = 0;
    if (done) return;
    done = 1;
    for (int n = 0; n < 1024; n++)
        win_sine_long[n] = (float)sin(M_PI / 2048.0 * (n + 0.5));
    for (int n = 0; n < 128; n++)
        win_sine_short[n] = (float)sin(M_PI / 256.0 * (n + 0.5));
    kbd_window(win_kbd_long, 1024, 4.0);
    kbd_window(win_kbd_short, 128, 6.0);
}

static const float *half_window(int shape, int is_short) {
    if (is_short) return shape ? win_kbd_short : win_sine_short;
    return shape ? win_kbd_long : win_sine_long;
}

/* ------------------------------------------------------------------ */
/* IMDCT via split-radix-free complex FFT (iterative radix-2)          */

typedef struct { double re, im; } Cpx;

static void fft_inplace(Cpx *a, int n, int inverse) {
    /* bit reversal */
    for (int i = 1, j = 0; i < n; i++) {
        int bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) { Cpx t = a[i]; a[i] = a[j]; a[j] = t; }
    }
    for (int len = 2; len <= n; len <<= 1) {
        double ang = 2.0 * M_PI / len * (inverse ? 1.0 : -1.0);
        double wr = cos(ang), wi = sin(ang);
        for (int i = 0; i < n; i += len) {
            double cr = 1.0, ci = 0.0;
            for (int j = 0; j < len / 2; j++) {
                Cpx u = a[i + j];
                Cpx v = a[i + j + len / 2];
                double vr = v.re * cr - v.im * ci;
                double vi = v.re * ci + v.im * cr;
                a[i + j].re = u.re + vr;
                a[i + j].im = u.im + vi;
                a[i + j + len / 2].re = u.re - vr;
                a[i + j + len / 2].im = u.im - vi;
                double ncr = cr * wr - ci * wi;
                ci = cr * wi + ci * wr;
                cr = ncr;
            }
        }
    }
}

/* IMDCT: n2 spectral coefficients -> n (=2*n2) time samples.
 * x[t] = sum_k X[k] cos(2*pi/n * (t + n0) * (k + 0.5)), n0 = n2/2+0.5
 * (14496-3 4.6.11.1 with the 2/N and reference-decoder output scale
 * folded into out_scale), computed through an n/4-point complex FFT:
 *   z[j]   = (X[2j] + i*X[n2-1-2j]) * e^{-i*2pi/n*(j + n0/2 ... )}
 * Derivation is in the comments of imdct_fft; imdct_direct is the
 * oracle form the FFT path is pinned against (tests/test_aac.py). */
static void imdct_direct(const float *X, float *x, int n) {
    int n2 = n / 2;
    double n0 = n2 / 2.0 + 0.5;
    double s = 2.0 / n;  /* spec 4.6.11.1 scale (window-size dependent) */
    for (int t = 0; t < n; t++) {
        double acc = 0.0;
        for (int k = 0; k < n2; k++)
            acc += X[k] * cos(2.0 * M_PI / n * (t + n0) * (k + 0.5));
        x[t] = (float)(acc * s);
    }
}

/* FFT path: one N/4-point complex DFT (e^{+i}) with pre/post
 * rotations, then the IMDCT output symmetries fill all N samples:
 *   d[j] = (X[2j] - i X[M-1-2j]) e^{i a n0 (2j+1/2)}   a = 2pi/N
 *   D[m] = sum_j d[j] e^{+i 2pi m j / Q}
 *   w    = D[m] e^{i 2pi m / N}
 *   x[2m] = (2/N) Re w        x[M+2m]  = -(2/N) Im w
 *   x[M-1-2m] = -x[2m]        x[N-1-2m] = x[M+2m]
 * (first half odd-symmetric, second half even-symmetric; verified
 * against imdct_direct to 4e-14 at N=2048 — tests/test_aac.py). */
static Cpx imdct_pre_2048[512], imdct_post_2048[512];
static Cpx imdct_pre_256[64], imdct_post_256[64];
static int imdct_tw_done = 0;

static void imdct_twiddles(Cpx *pre, Cpx *post, int n) {
    int n2 = n / 2, n4 = n / 4;
    double n0 = n2 / 2.0 + 0.5, al = 2.0 * M_PI / n;
    for (int j = 0; j < n4; j++) {
        double ph = al * n0 * (2 * j + 0.5);
        pre[j].re = cos(ph);
        pre[j].im = sin(ph);
        double pp = 2.0 * M_PI * j / n;
        post[j].re = cos(pp);
        post[j].im = sin(pp);
    }
}

static void imdct_fft(const float *X, float *x, int n) {
    if (!imdct_tw_done) {
        imdct_tw_done = 1;
        imdct_twiddles(imdct_pre_2048, imdct_post_2048, 2048);
        imdct_twiddles(imdct_pre_256, imdct_post_256, 256);
    }
    const Cpx *pre = n == 2048 ? imdct_pre_2048 : imdct_pre_256;
    const Cpx *post = n == 2048 ? imdct_post_2048 : imdct_post_256;
    int n2 = n / 2, n4 = n / 4;
    Cpx z[512];
    for (int j = 0; j < n4; j++) {
        double a = X[2 * j], b = -(double)X[n2 - 1 - 2 * j];
        z[j].re = a * pre[j].re - b * pre[j].im;
        z[j].im = a * pre[j].im + b * pre[j].re;
    }
    fft_inplace(z, n4, 1);
    double s = 2.0 / n;
    for (int m = 0; m < n4; m++) {
        double wr = z[m].re * post[m].re - z[m].im * post[m].im;
        double wi = z[m].re * post[m].im + z[m].im * post[m].re;
        float e = (float)(s * wr);         /* x[2m] */
        float o = (float)(-s * wi);        /* x[M+2m] */
        x[2 * m] = e;
        x[n2 + 2 * m] = o;
        x[n2 - 1 - 2 * m] = -e;
        x[n - 1 - 2 * m] = o;
    }
}

static void imdct(const float *X, float *x, int n) {
    imdct_fft(X, x, n);
    (void)imdct_direct;
}

/* ------------------------------------------------------------------ */
/* syntactic element parsing                                           */

enum { SEQ_LONG = 0, SEQ_START = 1, SEQ_SHORT = 2, SEQ_STOP = 3 };
enum { ZERO_HCB = 0, NOISE_HCB = 13, INTENSITY_HCB2 = 14,
       INTENSITY_HCB = 15 };

typedef struct {
    int sr_index;
    int sample_rate;
    int channels;        /* channelConfiguration */
} AacConfig;

static int decode_ics_info(Bits *b, ICS *ics, const SwbTab *swb) {
    if (bits_get1(b)) return -1;           /* ics_reserved */
    ics->window_sequence = (int)bits_get(b, 2);
    ics->window_shape = bits_get1(b);
    if (ics->window_sequence == SEQ_SHORT) {
        ics->max_sfb = (int)bits_get(b, 4);
        int grouping = (int)bits_get(b, 7);
        ics->num_windows = 8;
        ics->num_groups = 1;
        ics->group_len[0] = 1;
        for (int i = 6; i >= 0; i--) {
            if ((grouping >> i) & 1) {
                ics->group_len[ics->num_groups - 1]++;
            } else {
                ics->group_len[ics->num_groups++] = 1;
            }
        }
        if (ics->max_sfb > swb->num_short) return -1;
    } else {
        ics->max_sfb = (int)bits_get(b, 6);
        if (bits_get1(b)) return -1;       /* predictor: not LC */
        ics->num_windows = 1;
        ics->num_groups = 1;
        ics->group_len[0] = 1;
        if (ics->max_sfb > swb->num_long) return -1;
    }
    return b->error ? -1 : 0;
}

static int decode_section_data(Bits *b, ICS *ics) {
    int bits = ics->window_sequence == SEQ_SHORT ? 3 : 5;
    int esc = (1 << bits) - 1;
    for (int g = 0; g < ics->num_groups; g++) {
        int k = 0;
        while (k < ics->max_sfb) {
            int cb = (int)bits_get(b, 4);
            int len = 0, l;
            while ((l = (int)bits_get(b, bits)) == esc) len += esc;
            len += l;
            if (b->error || len == 0 || k + len > ics->max_sfb)
                return -1;
            if (cb == 12) return -1;       /* reserved */
            for (int i = 0; i < len; i++) ics->band_cb[g][k + i] = cb;
            k += len;
        }
    }
    return 0;
}

static int decode_scale_factors(Bits *b, ICS *ics, int global_gain) {
    int offset_spec = global_gain;
    int offset_noise = global_gain - 90;
    int offset_is = 0;
    int noise_first = 1;
    for (int g = 0; g < ics->num_groups; g++)
        for (int k = 0; k < ics->max_sfb; k++) {
            int cb = ics->band_cb[g][k];
            if (cb == ZERO_HCB) {
                ics->sf[g][k] = 0;
            } else if (cb == INTENSITY_HCB || cb == INTENSITY_HCB2) {
                int d = ahuff_read(&HCB[0], b);
                if (d < 0) return -1;
                offset_is += d - 60;
                ics->sf[g][k] = offset_is;
            } else if (cb == NOISE_HCB) {
                if (noise_first) {
                    offset_noise += (int)bits_get(b, 9) - 256;
                    noise_first = 0;
                } else {
                    int d = ahuff_read(&HCB[0], b);
                    if (d < 0) return -1;
                    offset_noise += d - 60;
                }
                ics->sf[g][k] = offset_noise;
            } else {
                int d = ahuff_read(&HCB[0], b);
                if (d < 0) return -1;
                offset_spec += d - 60;
                if (offset_spec > 255 || offset_spec < 0) return -1;
                ics->sf[g][k] = offset_spec;
            }
        }
    return b->error ? -1 : 0;
}

static int decode_pulse(Bits *b, ICS *ics, const SwbTab *swb) {
    if (ics->window_sequence == SEQ_SHORT) return -1;
    ics->pulse_n = (int)bits_get(b, 2) + 1;
    ics->pulse_start = (int)bits_get(b, 6);
    if (ics->pulse_start >= swb->num_long) return -1;
    int pos = swb->off_long[ics->pulse_start];
    for (int i = 0; i < ics->pulse_n; i++) {
        pos += (int)bits_get(b, 5);
        ics->pulse_pos[i] = pos;
        ics->pulse_amp[i] = (int)bits_get(b, 4);
        if (pos >= 1024) return -1;
    }
    return b->error ? -1 : 0;
}

static int decode_tns(Bits *b, ICS *ics) {
    int is_short = ics->window_sequence == SEQ_SHORT;
    int len_bits = is_short ? 4 : 6;
    int ord_bits = is_short ? 3 : 5;
    int max_order = is_short ? 7 : 12;  /* LC profile */
    for (int w = 0; w < ics->num_windows; w++) {
        ics->tns_n_filt[w] = (int)bits_get(b, is_short ? 1 : 2);
        if (!ics->tns_n_filt[w]) continue;
        int coef_res = bits_get1(b);
        for (int f = 0; f < ics->tns_n_filt[w]; f++) {
            ics->tns_len[w][f] = (int)bits_get(b, len_bits);
            int order = (int)bits_get(b, ord_bits);
            if (order > max_order) return -1;
            ics->tns_order[w][f] = order;
            if (!order) continue;
            ics->tns_dir[w][f] = bits_get1(b);
            int compress = bits_get1(b);
            int coef_len = coef_res + 3 - compress;
            int rng = 1 << (coef_len - 1);
            double iqfac = ((1 << (coef_res + 2)) - 0.5) / (M_PI / 2.0);
            double iqfac_m = ((1 << (coef_res + 2)) + 0.5) / (M_PI / 2.0);
            for (int i = 0; i < order; i++) {
                int c = (int)bits_get(b, coef_len);
                int v = c >= rng ? c - 2 * rng : c;  /* sign extend */
                ics->tns_coef[w][f][i] = (float)sin(
                    v / (v >= 0 ? iqfac : iqfac_m));
            }
        }
    }
    return b->error ? -1 : 0;
}

/* quantized spectral data -> ics->coef (deinterleaved, dequantized) */
static int decode_spectral(Bits *b, ICS *ics, const SwbTab *swb) {
    int is_short = ics->window_sequence == SEQ_SHORT;
    const uint16_t *off = is_short ? swb->off_short : swb->off_long;
    int quant[1024];
    memset(quant, 0, sizeof(quant));
    memset(ics->coef, 0, sizeof(ics->coef));

    /* grouped coefficient order: g, sfb, window-in-group, bins */
    int gpos = 0;   /* start window of group */
    int base = 0;   /* quant[] cursor in grouped order */
    for (int g = 0; g < ics->num_groups; g++) {
        for (int k = 0; k < ics->max_sfb; k++) {
            int cb = ics->band_cb[g][k];
            int width = off[k + 1] - off[k];
            int nvals = width * ics->group_len[g];
            if (cb == ZERO_HCB || cb == NOISE_HCB ||
                cb == INTENSITY_HCB || cb == INTENSITY_HCB2) {
                base += nvals;
                continue;
            }
            if (cb > 11 || !HCB[cb].valid) return -1;
            AHuff *t = &HCB[cb];
            int dims = t->dims;
            for (int i = 0; i < nvals; i += dims) {
                int idx = ahuff_read(t, b);
                if (idx < 0) return -1;
                int vals[4];
                if (t->sign) {
                    int basev = 2 * t->lav + 1;
                    for (int d = dims - 1; d >= 0; d--) {
                        vals[d] = idx % basev - t->lav;
                        idx /= basev;
                    }
                } else {
                    int basev = t->lav + 1;
                    for (int d = dims - 1; d >= 0; d--) {
                        vals[d] = idx % basev;
                        idx /= basev;
                    }
                    for (int d = 0; d < dims; d++)
                        if (vals[d] && bits_get1(b)) vals[d] = -vals[d];
                    if (cb == 11) {
                        for (int d = 0; d < dims; d++) {
                            if (abs(vals[d]) != 16) continue;
                            int n = 0;
                            while (bits_get1(b)) {
                                if (++n > 12 || b->error) return -1;
                            }
                            int mant = (int)bits_get(b, n + 4);
                            int mag = (1 << (n + 4)) + mant;
                            vals[d] = vals[d] < 0 ? -mag : mag;
                        }
                    }
                }
                for (int d = 0; d < dims; d++) quant[base + i + d] = vals[d];
            }
            base += nvals;
        }
        gpos += ics->group_len[g];
    }
    if (b->error) return -1;

    /* pulses operate on the quantized values (long windows only) */
    if (ics->pulse_present) {
        for (int i = 0; i < ics->pulse_n; i++) {
            int pos = ics->pulse_pos[i];
            /* grouped order == linear order for long windows */
            int q = quant[pos];
            /* reference-decoder semantics (oracle-pinned): a pulse on
             * a zero coefficient lands NEGATIVE; nonzero coefficients
             * grow away from zero. Only audible on coded bands (zero
             * bands are never dequantized). */
            if (q == 0)
                quant[pos] = -ics->pulse_amp[i];
            else
                quant[pos] = q > 0 ? q + ics->pulse_amp[i]
                                   : q - ics->pulse_amp[i];
        }
    }

    /* dequantize + band gain, deinterleave short groups */
    base = 0;
    gpos = 0;
    for (int g = 0; g < ics->num_groups; g++) {
        for (int k = 0; k < ics->max_sfb; k++) {
            int cb = ics->band_cb[g][k];
            int width = off[k + 1] - off[k];
            if (cb == ZERO_HCB || cb == NOISE_HCB ||
                cb == INTENSITY_HCB || cb == INTENSITY_HCB2) {
                base += width * ics->group_len[g];
                continue;
            }
            double gain = pow(2.0, 0.25 * (ics->sf[g][k] - 100)) *
                out_scale;
            for (int wi = 0; wi < ics->group_len[g]; wi++) {
                int dst = (gpos + wi) * 128 + off[k];
                for (int i = 0; i < width; i++) {
                    int q = quant[base++];
                    double v = (q < 0 ? -1.0 : 1.0) *
                        pow(fabs((double)q), 4.0 / 3.0) * gain;
                    if (is_short)
                        ics->coef[dst + i] = (float)v;
                    else
                        ics->coef[off[k] + i] = (float)v;
                }
            }
        }
        gpos += ics->group_len[g];
    }
    return 0;
}

/* PNS: fill noise bands; energy follows the scalefactor chain. The
 * noise SAMPLES are decoder-specific by spec (tests compare band
 * energy, not waveforms, against the oracle). */
static void apply_pns(ICS *ics, const SwbTab *swb, uint32_t *rng) {
    int is_short = ics->window_sequence == SEQ_SHORT;
    const uint16_t *off = is_short ? swb->off_short : swb->off_long;
    int gpos = 0;
    for (int g = 0; g < ics->num_groups; g++) {
        for (int k = 0; k < ics->max_sfb; k++) {
            if (ics->band_cb[g][k] != NOISE_HCB) continue;
            int width = off[k + 1] - off[k];
            /* band TOTAL energy convention (matches the reference
             * decoder's measured ladder): sqrt(sum x^2) =
             * 2^(sf/4) * out_scale — oracle-calibrated across
             * widths/gains in tests/test_aac.py */
            double gain = pow(2.0, 0.25 * ics->sf[g][k]) * out_scale;
            for (int wi = 0; wi < ics->group_len[g]; wi++) {
                int dst = is_short ? (gpos + wi) * 128 + off[k]
                                   : off[k];
                double energy = 0.0;
                float tmp[512];   /* widest possible scalefactor band */
                for (int i = 0; i < width; i++) {
                    *rng = *rng * 1664525u + 1013904223u;
                    tmp[i] = (float)((int32_t)*rng) / 2147483648.0f;
                    energy += tmp[i] * tmp[i];
                }
                double scale = gain / sqrt(energy + 1e-30);
                for (int i = 0; i < width; i++)
                    ics->coef[dst + i] = (float)(tmp[i] * scale);
            }
        }
        gpos += ics->group_len[g];
    }
}

static void apply_tns(ICS *ics, const SwbTab *swb, int sr_index) {
    if (!ics->tns_present) return;
    int is_short = ics->window_sequence == SEQ_SHORT;
    const uint16_t *off = is_short ? swb->off_short : swb->off_long;
    int num_swb = is_short ? swb->num_short : swb->num_long;
    int max_bands = is_short ? TNS_MAX_BANDS_SHORT[sr_index]
                             : TNS_MAX_BANDS_LONG[sr_index];
    int mmm = num_swb < max_bands ? num_swb : max_bands;
    for (int w = 0; w < ics->num_windows; w++) {
        int bottom = num_swb;
        for (int f = 0; f < ics->tns_n_filt[w]; f++) {
            int top = bottom;
            bottom = top - ics->tns_len[w][f];
            if (bottom < 0) bottom = 0;
            int order = ics->tns_order[w][f];
            if (!order) continue;
            /* reflection -> direct-form LPC */
            double lpc[21], tmp[21];
            lpc[0] = 1.0;
            for (int m = 1; m <= order; m++) {
                double r = ics->tns_coef[w][f][m - 1];
                for (int i = 1; i < m; i++)
                    tmp[i] = lpc[i] + r * lpc[m - i];
                for (int i = 1; i < m; i++) lpc[i] = tmp[i];
                lpc[m] = r;
            }
            int b1 = bottom < mmm ? bottom : mmm;
            int t1 = top < mmm ? top : mmm;
            if (t1 > ics->max_sfb) t1 = ics->max_sfb;
            if (b1 > t1) b1 = t1;
            int start = off[b1], end = off[t1];
            int size = end - start;
            if (size <= 0) continue;
            float *base = ics->coef + w * (is_short ? 128 : 0) + start;
            if (!ics->tns_dir[w][f]) {
                for (int i = 0; i < size; i++)
                    for (int j = 1; j <= order && j <= i; j++)
                        base[i] -= (float)(lpc[j]) * base[i - j];
            } else {
                for (int i = size - 1; i >= 0; i--)
                    for (int j = 1; j <= order && i + j < size; j++)
                        base[i] -= (float)(lpc[j]) * base[i + j];
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* filterbank: IMDCT + window + overlap-add -> 1024 output samples     */

static void filterbank(ICS *ics, ChanState *cs, float *out) {
    float buf[2048];
    int shape = ics->window_shape;
    int pshape = cs->prev_shape;
    if (ics->window_sequence != SEQ_SHORT) {
        float x[2048];
        imdct(ics->coef, x, 2048);
        const float *wl = half_window(pshape, 0);
        const float *wr = half_window(shape, 0);
        const float *ws_prev = half_window(pshape, 1);
        const float *ws_cur = half_window(shape, 1);
        for (int n = 0; n < 1024; n++) {
            float l;
            if (ics->window_sequence == SEQ_STOP) {
                if (n < 448) l = 0.0f;
                else if (n < 576) l = ws_prev[n - 448];
                else l = 1.0f;
            } else {
                l = wl[n];
            }
            buf[n] = x[n] * l;
        }
        for (int n = 0; n < 1024; n++) {
            float r;
            if (ics->window_sequence == SEQ_START) {
                if (n < 448) r = 1.0f;
                else if (n < 576) r = ws_cur[127 - (n - 448)];
                else r = 0.0f;
            } else {
                r = wr[1023 - n];
            }
            buf[1024 + n] = x[1024 + n] * r;
        }
    } else {
        memset(buf, 0, sizeof(buf));
        const float *ws_cur = half_window(shape, 1);
        const float *ws_prev = half_window(pshape, 1);
        for (int w = 0; w < 8; w++) {
            float x[256];
            imdct(ics->coef + w * 128, x, 256);
            const float *wl = w == 0 ? ws_prev : ws_cur;
            int o = 448 + 128 * w;
            for (int n = 0; n < 128; n++) {
                buf[o + n] += x[n] * wl[n];
                buf[o + 128 + n] += x[128 + n] * ws_cur[127 - n];
            }
        }
    }
    for (int n = 0; n < 1024; n++) out[n] = cs->overlap[n] + buf[n];
    memcpy(cs->overlap, buf + 1024, sizeof(float) * 1024);
    cs->prev_shape = shape;
    cs->prev_seq = ics->window_sequence;
}

/* ------------------------------------------------------------------ */
/* individual_channel_stream + elements                                */

static int decode_ics(Bits *b, ICS *ics, const SwbTab *swb,
                      int common_window, int sr_index) {
    int global_gain = (int)bits_get(b, 8);
    if (!common_window) {
        memset(ics->band_cb, 0, sizeof(ics->band_cb));
        if (decode_ics_info(b, ics, swb)) return -1;
    }
    if (decode_section_data(b, ics)) return -1;
    if (decode_scale_factors(b, ics, global_gain)) return -1;
    ics->pulse_present = bits_get1(b);
    if (ics->pulse_present && decode_pulse(b, ics, swb)) return -1;
    ics->tns_present = bits_get1(b);
    memset(ics->tns_n_filt, 0, sizeof(ics->tns_n_filt));
    if (ics->tns_present && decode_tns(b, ics)) return -1;
    if (bits_get1(b)) return -1;          /* gain control: not LC */
    if (decode_spectral(b, ics, swb)) return -1;
    /* TNS is applied by the caller AFTER the stereo tools (M/S,
     * intensity) — spec tool order; sr_index kept for that call */
    (void)sr_index;
    return 0;
}

/* M/S + intensity for a CPE */
static void apply_stereo(ICS *l, ICS *r, const SwbTab *swb,
                         int ms_present, const uint8_t *ms_used) {
    int is_short = l->window_sequence == SEQ_SHORT;
    const uint16_t *off = is_short ? swb->off_short : swb->off_long;
    int gpos = 0;
    for (int g = 0; g < l->num_groups; g++) {
        for (int k = 0; k < l->max_sfb; k++) {
            int cb = r->band_cb[g][k];
            int ms = ms_present == 2 ? 1 :
                (ms_present == 1 ? ms_used[g * 64 + k] : 0);
            for (int wi = 0; wi < l->group_len[g]; wi++) {
                int o = is_short ? (gpos + wi) * 128 + off[k] : off[k];
                int width = off[k + 1] - off[k];
                if (cb == INTENSITY_HCB || cb == INTENSITY_HCB2) {
                    double sgn = cb == INTENSITY_HCB ? 1.0 : -1.0;
                    if (ms) sgn = -sgn;
                    double scale = sgn *
                        pow(0.5, 0.25 * r->sf[g][k]);
                    for (int i = 0; i < width; i++)
                        r->coef[o + i] = (float)(l->coef[o + i] * scale);
                } else if (ms && cb != NOISE_HCB) {
                    for (int i = 0; i < width; i++) {
                        float m = l->coef[o + i], s = r->coef[o + i];
                        l->coef[o + i] = m + s;
                        r->coef[o + i] = m - s;
                    }
                }
            }
        }
        gpos += l->group_len[g];
    }
}

/* NOTE on PNS in channel pairs: each channel draws independent noise
 * even under ms_used — measured against the reference decoder
 * (channel correlation ~0.07 with ms_present=2), whose behavior we
 * match over a stricter reading of 4.6.13. */

/* ------------------------------------------------------------------ */
/* raw_data_block                                                      */

typedef struct {
    ChanState cs[MAX_CH];
    int channels;
    int sr_index;
    /* HE-AAC: one SBR element per audio syntactic element (SCE/CPE).
     * sbr_mode latches on the first successfully parsed SBR payload
     * (implicit ADTS signaling) or from an explicit aot-5 ASC; once
     * on, every frame emits 2048 samples at twice the core rate
     * (frames without SBR data upsample through the plain QMF). */
    SbrElem sbr[2];
    int sbr_mode;
} Decoder;

static int decode_raw_block(Decoder *dec, Bits *b,
                            float *out /*2048*MAX_CH*/, int *out_ch,
                            int *out_samples) {
    const SwbTab *swb = &SWB[dec->sr_index];
    static ICS icsL, icsR;  /* large; single-threaded under the GIL */
    static float core[1024 * MAX_CH];
    int ch = 0;
    /* audio syntactic elements of this block (for SBR association) */
    int elem_ch0[2], elem_nch[2], elem_sbr_ok[2], n_elems = 0;
    for (;;) {
        int id = (int)bits_get(b, 3);
        if (b->error) return -1;
        if (id == 7) break;               /* END */
        if (id == 0 || id == 3) {         /* SCE / LFE */
            bits_get(b, 4);               /* instance tag */
            memset(&icsL, 0, sizeof(icsL));
            if (decode_ics(b, &icsL, swb, 0, dec->sr_index)) return -1;
            if (ch >= MAX_CH) return -1;
            apply_pns(&icsL, swb, &dec->cs[ch].rng);
            apply_tns(&icsL, swb, dec->sr_index);
            filterbank(&icsL, &dec->cs[ch], core + 1024 * ch);
            if (n_elems < 2) {
                elem_ch0[n_elems] = ch;
                elem_nch[n_elems] = 1;
                elem_sbr_ok[n_elems] = (id == 0);  /* no SBR on LFE */
                n_elems++;
            }
            ch++;
        } else if (id == 1) {             /* CPE */
            bits_get(b, 4);
            memset(&icsL, 0, sizeof(icsL));
            memset(&icsR, 0, sizeof(icsR));
            int common = bits_get1(b);
            int ms_present = 0;
            static uint8_t ms_used[8 * 64];
            if (common) {
                if (decode_ics_info(b, &icsL, swb)) return -1;
                ms_present = (int)bits_get(b, 2);
                if (ms_present == 3) return -1;
                icsR = icsL;
                if (ms_present == 1)
                    for (int g = 0; g < icsL.num_groups; g++)
                        for (int k = 0; k < icsL.max_sfb; k++)
                            ms_used[g * 64 + k] = (uint8_t)bits_get1(b);
            }
            /* with common_window, icsR already carries the shared
             * ics_info via the struct copy above */
            if (decode_ics(b, &icsL, swb, common, dec->sr_index))
                return -1;
            if (decode_ics(b, &icsR, swb, common, dec->sr_index))
                return -1;
            if (ch + 2 > MAX_CH) return -1;
            /* tool order: PNS fill, stereo (M/S + intensity), then
             * TNS per channel, then the filterbank */
            apply_pns(&icsL, swb, &dec->cs[ch].rng);
            apply_pns(&icsR, swb, &dec->cs[ch + 1].rng);
            apply_stereo(&icsL, &icsR, swb, ms_present, ms_used);
            apply_tns(&icsL, swb, dec->sr_index);
            apply_tns(&icsR, swb, dec->sr_index);
            filterbank(&icsL, &dec->cs[ch], core + 1024 * ch);
            filterbank(&icsR, &dec->cs[ch + 1], core + 1024 * (ch + 1));
            if (n_elems < 2) {
                elem_ch0[n_elems] = ch;
                elem_nch[n_elems] = 2;
                elem_sbr_ok[n_elems] = 1;
                n_elems++;
            }
            ch += 2;
        } else if (id == 4) {             /* DSE */
            bits_get(b, 4);
            int align = bits_get1(b);
            int cnt = (int)bits_get(b, 8);
            if (cnt == 255) cnt += (int)bits_get(b, 8);
            if (align) bits_align(b);
            for (int i = 0; i < cnt; i++) bits_get(b, 8);
        } else if (id == 6) {             /* FIL */
            int cnt = (int)bits_get(b, 4);
            if (cnt == 15) cnt += (int)bits_get(b, 8) - 1;
            if (cnt > 0) {
                size_t fil_start = b->pos;      /* first payload bit */
                int ext = (int)bits_get(b, 4);
                if ((ext == 0x0D || ext == 0x0E) && n_elems > 0
                    && elem_sbr_ok[n_elems - 1]) {
                    /* sbr_extension_data for the preceding element */
                    int ei = n_elems - 1;
                    size_t avail = fil_start + 8 * (size_t)cnt;
                    if (avail > b->len * 8) return -1;
                    sbr_elem_init(&dec->sbr[ei],
                                  SR_TAB[dec->sr_index]);
                    if (sbr_parse_payload(
                            &dec->sbr[ei], b->p, b->pos,
                            avail - b->pos, elem_nch[ei] == 2,
                            ext == 0x0E))
                        return -1;
                    dec->sbr_mode = 1;
                    b->pos = avail;             /* FIL consumes cnt B */
                } else {
                    for (int i = 0; i < cnt - 1; i++) bits_get(b, 8);
                    bits_get(b, 4);
                }
            }
        } else {
            return -1;                    /* CCE / PCE unsupported */
        }
        if (b->error) return -1;
    }
    if (dec->sbr_mode) {
        for (int ei = 0; ei < n_elems; ei++) {
            int c0 = elem_ch0[ei], nch = elem_nch[ei];
            sbr_elem_init(&dec->sbr[ei], SR_TAB[dec->sr_index]);
            sbr_process(&dec->sbr[ei], nch, core + 1024 * c0,
                        nch == 2 ? core + 1024 * (c0 + 1) : NULL,
                        out + 2048 * c0,
                        nch == 2 ? out + 2048 * (c0 + 1) : NULL);
        }
        *out_samples = 2048;
    } else {
        for (int c = 0; c < ch; c++)
            memcpy(out + 2048 * c, core + 1024 * c,
                   1024 * sizeof(float));
        *out_samples = 1024;
    }
    *out_ch = ch;
    return 0;
}

/* ------------------------------------------------------------------ */
/* ADTS stream                                                         */

static int adts_parse_header(Bits *b, AacConfig *cfg, int *frame_len,
                             int *crc, int *nblocks) {
    if (bits_get(b, 12) != 0xFFF) return -1;
    bits_get(b, 1);                       /* ID (MPEG-2/4): same LC syntax */
    if (bits_get(b, 2) != 0) return -1;   /* layer */
    *crc = !bits_get1(b);
    int profile = (int)bits_get(b, 2);
    if (profile != 1) return -2;          /* not LC */
    cfg->sr_index = (int)bits_get(b, 4);
    if (cfg->sr_index > 12 || !SR_TAB[cfg->sr_index]) return -1;
    bits_get(b, 1);
    cfg->channels = (int)bits_get(b, 3);
    bits_get(b, 4);                       /* orig/home/copyright */
    *frame_len = (int)bits_get(b, 13);
    bits_get(b, 11);
    *nblocks = (int)bits_get(b, 2) + 1;   /* raw_data_blocks in frame */
    cfg->sample_rate = SR_TAB[cfg->sr_index];
    return b->error ? -1 : 0;
}

/* ------------------------------------------------------------------ */
/* Python API                                                          */

static int ensure_tables(int sr_index, char err[128]) {
    aac_tables_init();
    windows_init();
    for (int i = 0; i < 12; i++)
        if (!HCB[i].valid) {
            snprintf(err, 128,
                     "AAC huffman tables not loaded (book %d)", i);
            return -1;
        }
    if (!SWB[sr_index].valid) {
        snprintf(err, 128, "AAC swb table missing for sr index %d",
                 sr_index);
        return -1;
    }
    return 0;
}

/* decode an ADTS stream */
static PyObject *decode_adts(const uint8_t *data, Py_ssize_t len) {
    char err[128] = "truncated stream";
    AacConfig cfg = {0};
    Decoder dec;
    memset(&dec, 0, sizeof(dec));
    for (int c = 0; c < MAX_CH; c++) dec.cs[c].rng = 0x1f2e3d4cu ^ c;
    size_t pos = 0;
    float *pcm = NULL;
    long long cap = 0, n = 0;
    int out_channels = 0;
    int nframes = 0;
    int frame_samples = 0;
    while (pos + 7 <= (size_t)len) {
        /* resync */
        if (data[pos] != 0xFF || (data[pos + 1] & 0xF6) != 0xF0) {
            pos++;
            continue;
        }
        Bits hb;
        bits_init(&hb, data + pos, (size_t)len - pos);
        AacConfig hcfg = {0};
        int frame_len = 0, crc = 0, nblocks = 1;
        int rc = adts_parse_header(&hb, &hcfg, &frame_len, &crc,
                                   &nblocks);
        if (rc == -2) {
            /* a false sync can land here too: resync like every other
             * bad header, and only report non-LC if nothing decodes */
            snprintf(err, 128, "not an AAC-LC stream");
            pos++;
            continue;
        }
        size_t hdr_bytes = (size_t)(crc ? 9 : 7);
        if (rc != 0 || hb.error || (size_t)frame_len < hdr_bytes + 1 ||
            pos + (size_t)frame_len > (size_t)len) {
            pos++;
            continue;
        }
        if (ensure_tables(hcfg.sr_index, err)) goto fail;
        if (crc) bits_get(&hb, 16);
        if (nblocks > 1 && crc) {
            /* CRC-protected multi-block frames interleave check words
             * we don't track; exceedingly rare in the wild */
            snprintf(err, 128, "multi-block ADTS frame with CRC");
            goto fail;
        }
        dec.sr_index = hcfg.sr_index;
        Bits rb;
        bits_init(&rb, data + pos + hdr_bytes,
                  (size_t)frame_len - hdr_bytes);
        for (int blk = 0; blk < nblocks; blk++) {
            static float out[2048 * MAX_CH];
            int ch = 0, samples = 0;
            int brc = decode_raw_block(&dec, &rb, out, &ch, &samples);
            if (brc != 0 || ch <= 0) break;
            if (frame_samples && samples != frame_samples) {
                /* SBR appearing mid-stream would double the output
                 * rate after samples were already committed */
                snprintf(err, 128,
                         "HE-AAC (SBR) data appeared mid-stream — "
                         "decode via ffmpeg");
                goto fail;
            }
            frame_samples = samples;
            /* accepted: commit this frame's config */
            cfg = hcfg;
            if (!out_channels) out_channels = ch;
            if (ch != out_channels) break;
            if ((n + samples) > cap) {
                cap = (n + samples) * 2 + 8192;
                float *np_ = realloc(
                    pcm, (size_t)cap * out_channels * sizeof(float));
                if (!np_) { snprintf(err, 128, "oom"); goto fail; }
                pcm = np_;
            }
            for (int s = 0; s < samples; s++)
                for (int c = 0; c < out_channels; c++)
                    pcm[(n + s) * out_channels + c] =
                        out[2048 * c + s];
            n += samples;
            nframes++;
            bits_align(&rb);   /* raw_data_blocks are byte-aligned */
        }
        pos += (size_t)frame_len;
    }
    if (!nframes) {
        free(pcm);
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    PyObject *bytes = PyBytes_FromStringAndSize(
        (const char *)pcm, (Py_ssize_t)(n * out_channels * sizeof(float)));
    free(pcm);
    if (!bytes) return NULL;
    PyObject *r = Py_BuildValue(
        "(Nlii)", bytes, (long)n, out_channels,
        dec.sbr_mode ? cfg.sample_rate * 2 : cfg.sample_rate);
    return r;
fail:
    free(pcm);
    PyErr_SetString(PyExc_ValueError, err);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* MP4 / M4A demux (ISO-BMFF): locate the audio track's               */
/* AudioSpecificConfig (moov/trak/mdia/minf/stbl/stsd/mp4a/esds),      */
/* sample sizes (stsz), chunk layout (stsc + stco/co64), and the edit  */
/* list delay (edts/elst); feed each sample as one raw_data_block.     */

typedef struct {
    const uint8_t *asc;
    size_t asc_len;
    const uint8_t *stsz;     /* at entry table */
    uint32_t sample_count, fixed_size;
    const uint8_t *stsc;
    uint32_t stsc_n;
    const uint8_t *stco;
    uint32_t stco_n;
    int co64;
    int64_t media_time;      /* elst start trim (media samples) */
    int is_audio;
} Mp4Track;

static uint32_t rd32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
}
static uint64_t rd64(const uint8_t *p) {
    return ((uint64_t)rd32(p) << 32) | rd32(p + 4);
}

/* descriptor length: 1-4 bytes, 0x80 = continuation */
static size_t desc_len(const uint8_t *p, size_t avail, size_t *adv) {
    size_t v = 0, i = 0;
    while (i < 4 && i < avail) {
        v = (v << 7) | (p[i] & 0x7F);
        if (!(p[i++] & 0x80)) break;
    }
    *adv = i;
    return v;
}

static void parse_esds(const uint8_t *p, size_t len, Mp4Track *tr) {
    if (len < 4) return;
    p += 4; len -= 4;                    /* fullbox version/flags */
    /* ES_Descriptor (0x03) */
    if (!len || p[0] != 0x03) return;
    size_t adv, dl = desc_len(p + 1, len - 1, &adv);
    (void)dl;
    p += 1 + adv;
    if (len < 1 + adv + 3) return;
    len -= 1 + adv;
    uint8_t flags = p[2];
    p += 3; len -= 3;                    /* ES_ID + flags */
    if (flags & 0x80) { if (len < 2) return; p += 2; len -= 2; }
    if (flags & 0x40) {                  /* URL */
        if (!len) return;
        size_t ul = p[0] + 1;
        if (len < ul) return;
        p += ul; len -= ul;
    }
    if (flags & 0x20) { if (len < 2) return; p += 2; len -= 2; }
    /* DecoderConfigDescriptor (0x04) */
    if (!len || p[0] != 0x04) return;
    dl = desc_len(p + 1, len - 1, &adv);
    p += 1 + adv;
    if (len < 1 + adv + 13) return;
    len -= 1 + adv;
    p += 13; len -= 13;                  /* oti, stream type, rates */
    /* DecoderSpecificInfo (0x05) = AudioSpecificConfig */
    if (!len || p[0] != 0x05) return;
    dl = desc_len(p + 1, len - 1, &adv);
    p += 1 + adv;
    len -= 1 + adv;
    if (dl > len) return;
    tr->asc = p;
    tr->asc_len = dl;
}

static void parse_stbl(const uint8_t *p, size_t len, Mp4Track *tr);

static void walk_boxes(const uint8_t *p, size_t len, Mp4Track *tr,
                       int depth) {
    if (depth > 16) return;   /* crafted moov-in-moov nesting bomb */
    size_t pos = 0;
    while (pos + 8 <= len) {
        uint64_t sz = rd32(p + pos);
        const uint8_t *type = p + pos + 4;
        size_t hdr = 8;
        if (sz == 1) {
            if (pos + 16 > len) return;
            sz = rd64(p + pos + 8);
            hdr = 16;
        } else if (sz == 0) {
            sz = len - pos;
        }
        if (sz < hdr || pos + sz > len) return;
        const uint8_t *body = p + pos + hdr;
        size_t blen = (size_t)sz - hdr;
        if (!memcmp(type, "moov", 4) || !memcmp(type, "mdia", 4) ||
            !memcmp(type, "minf", 4) || !memcmp(type, "edts", 4)) {
            walk_boxes(body, blen, tr, depth + 1);
        } else if (!memcmp(type, "trak", 4)) {
            Mp4Track t2;
            memset(&t2, 0, sizeof(t2));
            t2.media_time = -1;
            walk_boxes(body, blen, &t2, depth + 1);
            if (t2.is_audio && t2.asc && !tr->asc) *tr = t2;
        } else if (!memcmp(type, "hdlr", 4)) {
            if (blen >= 12 && !memcmp(body + 8, "soun", 4))
                tr->is_audio = 1;
        } else if (!memcmp(type, "elst", 4)) {
            if (blen >= 8) {
                int ver = body[0];
                uint32_t n = rd32(body + 4);
                const uint8_t *e = body + 8;
                for (uint32_t i = 0; i < n; i++) {
                    int64_t mt;
                    if (ver == 1) {
                        if ((size_t)(e - body) + 20 > blen) break;
                        mt = (int64_t)rd64(e + 8);
                        e += 20;
                    } else {
                        if ((size_t)(e - body) + 12 > blen) break;
                        mt = (int32_t)rd32(e + 4);
                        e += 12;
                    }
                    if (mt >= 0) { tr->media_time = mt; break; }
                }
            }
        } else if (!memcmp(type, "stbl", 4)) {
            parse_stbl(body, blen, tr);
        }
        pos += (size_t)sz;
    }
}

static void parse_stbl(const uint8_t *p, size_t len, Mp4Track *tr) {
    size_t pos = 0;
    while (pos + 8 <= len) {
        uint64_t sz = rd32(p + pos);
        const uint8_t *type = p + pos + 4;
        size_t hdr = 8;
        if (sz == 1) {
            if (pos + 16 > len) return;
            sz = rd64(p + pos + 8);
            hdr = 16;
        } else if (sz == 0) {
            sz = len - pos;
        }
        if (sz < hdr || pos + sz > len) return;
        const uint8_t *body = p + pos + hdr;
        size_t blen = (size_t)sz - hdr;
        if (!memcmp(type, "stsd", 4) && blen >= 16) {
            /* first entry; want mp4a */
            const uint8_t *e = body + 8;
            size_t elen = blen - 8;
            if (elen >= 8 && !memcmp(e + 4, "mp4a", 4)) {
                uint32_t esz = rd32(e);
                if (esz >= 36 && esz <= elen) {
                    const uint8_t *se = e + 8;  /* AudioSampleEntry */
                    uint16_t version = (uint16_t)((se[8] << 8) | se[9]);
                    size_t skip = 28;           /* v0 fields */
                    if (version == 1) skip += 16;
                    else if (version == 2) skip += 36;
                    if (esz >= 8 + skip + 8) {
                        /* child boxes: esds */
                        const uint8_t *cb = se + skip;
                        size_t cl = esz - 8 - skip;
                        size_t cp = 0;
                        while (cp + 8 <= cl) {
                            uint32_t csz = rd32(cb + cp);
                            if (csz < 8 || cp + csz > cl) break;
                            if (!memcmp(cb + cp + 4, "esds", 4))
                                parse_esds(cb + cp + 8, csz - 8, tr);
                            cp += csz;
                        }
                    }
                }
            }
        } else if (!memcmp(type, "stsz", 4) && blen >= 12) {
            tr->fixed_size = rd32(body + 4);
            tr->sample_count = rd32(body + 8);
            tr->stsz = body + 12;
            if (!tr->fixed_size &&
                blen < 12 + (size_t)tr->sample_count * 4)
                tr->stsz = NULL;
        } else if (!memcmp(type, "stsc", 4) && blen >= 8) {
            tr->stsc_n = rd32(body + 4);
            tr->stsc = body + 8;
            if (blen < 8 + (size_t)tr->stsc_n * 12) tr->stsc = NULL;
        } else if ((!memcmp(type, "stco", 4) ||
                    !memcmp(type, "co64", 4)) && blen >= 8) {
            tr->co64 = type[0] == 'c' && type[1] == 'o';
            tr->stco_n = rd32(body + 4);
            tr->stco = body + 8;
            if (blen < 8 + (size_t)tr->stco_n * (tr->co64 ? 8 : 4))
                tr->stco = NULL;
        }
        pos += (size_t)sz;
    }
}

static int parse_asc(const uint8_t *p, size_t len, AacConfig *cfg,
                     int *sbr_explicit, char err[128]) {
    Bits b;
    bits_init(&b, p, len);
    *sbr_explicit = 0;
    int aot = (int)bits_get(&b, 5);
    if (aot == 31) aot = 32 + (int)bits_get(&b, 6);
    int sfi = (int)bits_get(&b, 4);
    int rate;
    if (sfi == 15) {
        rate = (int)bits_get(&b, 24);
        snprintf(err, 128, "explicit sample rate unsupported");
        return -1;
    } else {
        if (sfi > 12 || !SR_TAB[sfi]) {
            snprintf(err, 128, "bad sampling frequency index");
            return -1;
        }
        rate = SR_TAB[sfi];
    }
    int chan = (int)bits_get(&b, 4);
    if (aot == 5) {
        /* explicit hierarchical HE-AAC signaling: the first sfi is
         * the core rate, extensionSamplingFrequencyIndex the SBR
         * output rate, then the core object type follows */
        *sbr_explicit = 1;
        int ext_sfi = (int)bits_get(&b, 4);
        if (ext_sfi == 15) {
            bits_get(&b, 24);
            snprintf(err, 128, "explicit SBR sample rate unsupported");
            return -1;
        }
        if (ext_sfi > 12 || SR_TAB[ext_sfi] != 2 * rate) {
            snprintf(err, 128,
                     "SBR output rate is not twice the core rate");
            return -1;
        }
        aot = (int)bits_get(&b, 5);
        if (aot == 31) aot = 32 + (int)bits_get(&b, 6);
    }
    if (aot != 2) {
        snprintf(err, 128, "AAC object type %d unsupported "
                 "(LC / HE-AAC only)", aot);
        return -1;
    }
    if (bits_get1(&b)) {                 /* frameLengthFlag: 960 */
        snprintf(err, 128, "960-sample frames unsupported");
        return -1;
    }
    if (bits_get1(&b)) {                 /* dependsOnCoreCoder */
        snprintf(err, 128, "core coder dependency unsupported");
        return -1;
    }
    bits_get1(&b);                       /* extensionFlag */
    cfg->sr_index = sfi;
    cfg->sample_rate = rate;
    cfg->channels = chan;
    return b.error ? -1 : 0;
}

static PyObject *decode_mp4(const uint8_t *data, Py_ssize_t len) {
    char err[128] = "no AAC audio track found";
    Mp4Track tr;
    memset(&tr, 0, sizeof(tr));
    tr.media_time = -1;
    walk_boxes(data, (size_t)len, &tr, 0);
    if (!tr.asc || !tr.stsz || !tr.stsc || !tr.stco ||
        !tr.sample_count) {
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    AacConfig cfg = {0};
    int sbr_explicit = 0;
    if (parse_asc(tr.asc, tr.asc_len, &cfg, &sbr_explicit, err)) {
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    if (ensure_tables(cfg.sr_index, err)) {
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    Decoder dec;
    memset(&dec, 0, sizeof(dec));
    for (int c = 0; c < MAX_CH; c++) dec.cs[c].rng = 0x1f2e3d4cu ^ c;
    dec.sr_index = cfg.sr_index;
    dec.sbr_mode = sbr_explicit;

    float *pcm = NULL;
    long long cap = 0, n = 0;
    int out_channels = 0;
    int frame_samples = 0;
    uint32_t sample = 0;
    /* iterate chunks via stsc runs */
    for (uint32_t ci = 0; ci < tr.stco_n && sample < tr.sample_count;
         ci++) {
        uint64_t off = tr.co64 ? rd64(tr.stco + ci * 8)
                               : rd32(tr.stco + ci * 4);
        /* samples in this chunk: from the stsc run covering ci+1 */
        uint32_t spc = 1;
        for (uint32_t si = 0; si < tr.stsc_n; si++) {
            uint32_t first = rd32(tr.stsc + si * 12);
            if (first <= ci + 1) spc = rd32(tr.stsc + si * 12 + 4);
            else break;
        }
        for (uint32_t s = 0; s < spc && sample < tr.sample_count;
             s++, sample++) {
            uint32_t ssz = tr.fixed_size ? tr.fixed_size
                                         : rd32(tr.stsz + sample * 4);
            /* overflow-safe bounds: a crafted co64 offset near 2^64
             * must not wrap past the check */
            if (off > (uint64_t)len || ssz > (uint64_t)len - off) {
                snprintf(err, 128, "sample outside file");
                goto fail;
            }
            Bits b;
            bits_init(&b, data + off, ssz);
            static float out[2048 * MAX_CH];
            int ch = 0, samples = 0;
            int brc = decode_raw_block(&dec, &b, out, &ch, &samples);
            if (brc == 0 && ch > 0) {
                if (frame_samples && samples != frame_samples) {
                    snprintf(err, 128,
                             "HE-AAC (SBR) data appeared mid-stream — "
                             "decode via ffmpeg");
                    goto fail;
                }
                frame_samples = samples;
                if (!out_channels) out_channels = ch;
                if (ch == out_channels) {
                    if (n + samples > cap) {
                        cap = (n + samples) * 2 + 8192;
                        float *np_ = realloc(
                            pcm,
                            (size_t)cap * out_channels * sizeof(float));
                        if (!np_) { snprintf(err, 128, "oom"); goto fail; }
                        pcm = np_;
                    }
                    for (int t = 0; t < samples; t++)
                        for (int c = 0; c < out_channels; c++)
                            pcm[(n + t) * out_channels + c] =
                                out[2048 * c + t];
                    n += samples;
                }
            } else {
                snprintf(err, 128, "AAC frame %u failed to decode",
                         sample);
                goto fail;
            }
            off += ssz;
        }
    }
    if (!n) goto fail;
    {
        long long skip = tr.media_time > 0 ? tr.media_time : 0;
        if (skip > n) skip = n;
        PyObject *bytes = PyBytes_FromStringAndSize(
            (const char *)(pcm + skip * out_channels),
            (Py_ssize_t)((n - skip) * out_channels * sizeof(float)));
        free(pcm);
        if (!bytes) return NULL;
        /* for HE-AAC tracks the mvhd/mdhd timescale (and so the elst
         * media_time) is the SBR output rate, matching our doubled n */
        return Py_BuildValue("(Nlii)", bytes, (long)(n - skip),
                             out_channels,
                             dec.sbr_mode ? cfg.sample_rate * 2
                                          : cfg.sample_rate);
    }
fail:
    free(pcm);
    PyErr_SetString(PyExc_ValueError, err);
    return NULL;
}

PyObject *vrt_aac_decode(PyObject *self, PyObject *args) {
    (void)self;
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return NULL;
    const uint8_t *data = buf.buf;
    Py_ssize_t len = buf.len;
    PyObject *r;
    if (len > 8 && memcmp(data + 4, "ftyp", 4) == 0) {
        r = decode_mp4(data, len);
    } else {
        r = decode_adts(data, len);
    }
    PyBuffer_Release(&buf);
    return r;
}

/* ------------------------------------------------------------------ */
/* dev hooks: table load/readback for the extraction + regression rig  */

PyObject *vrt_aac_huff_set(PyObject *self, PyObject *args) {
    (void)self;
    int id;
    Py_buffer lv, cv;
    if (!PyArg_ParseTuple(args, "iy*y*", &id, &lv, &cv)) return NULL;
    aac_tables_init();
    if (id < 0 || id > 11) {
        PyBuffer_Release(&lv);
        PyBuffer_Release(&cv);
        PyErr_SetString(PyExc_ValueError, "bad huffman book id");
        return NULL;
    }
    AHuff *t = &HCB[id];
    int n = t->n;
    if (lv.len != n || cv.len != (Py_ssize_t)(n * 4)) {
        PyBuffer_Release(&lv);
        PyBuffer_Release(&cv);
        PyErr_SetString(PyExc_ValueError, "bad table size");
        return NULL;
    }
    uint8_t *nl = malloc((size_t)n);
    uint32_t *nc = malloc((size_t)n * 4);
    memcpy(nl, lv.buf, (size_t)n);
    memcpy(nc, cv.buf, (size_t)n * 4);
    PyBuffer_Release(&lv);
    PyBuffer_Release(&cv);
    free(t->own_len);
    free(t->own_code);
    t->own_len = nl;
    t->own_code = nc;
    t->len = nl;
    t->code = nc;
    if (ahuff_build(t)) {
        PyErr_SetString(PyExc_ValueError, "not a valid prefix code");
        return NULL;
    }
    Py_RETURN_NONE;
}

PyObject *vrt_aac_huff_get(PyObject *self, PyObject *args) {
    (void)self;
    int id;
    if (!PyArg_ParseTuple(args, "i", &id)) return NULL;
    aac_tables_init();
    if (id < 0 || id > 11 || !HCB[id].valid) {
        PyErr_SetString(PyExc_ValueError, "table not loaded");
        return NULL;
    }
    AHuff *t = &HCB[id];
    PyObject *lens = PyBytes_FromStringAndSize((const char *)t->len, t->n);
    PyObject *codes = PyBytes_FromStringAndSize((const char *)t->code,
                                                (Py_ssize_t)t->n * 4);
    PyObject *r = Py_BuildValue("(iiOO)", t->dims, t->lav, lens, codes);
    Py_XDECREF(lens);
    Py_XDECREF(codes);
    return r;
}

PyObject *vrt_aac_swb_set(PyObject *self, PyObject *args) {
    (void)self;
    int sr_index, is_long;
    Py_buffer ov;
    if (!PyArg_ParseTuple(args, "iiy*", &sr_index, &is_long, &ov))
        return NULL;
    if (sr_index < 0 || sr_index > 12 ||
        (size_t)ov.len / 2 > (is_long ? 64 : 20)) {
        PyBuffer_Release(&ov);
        PyErr_SetString(PyExc_ValueError, "bad swb table");
        return NULL;
    }
    SwbTab *s = &SWB[sr_index];
    int n = (int)(ov.len / 2);
    /* the decoder indexes coef[off[k]..off[k+1]) and fills noise into
     * a 512-wide scratch: reject non-monotonic/oversized tables here
     * rather than corrupting memory later (dev hook, but symmetric
     * with aac_huff_set's prefix-code validation) */
    const uint16_t *offv = (const uint16_t *)ov.buf;
    int limit = is_long ? 1024 : 128;
    int ok = n >= 2 && offv[0] == 0 && offv[n - 1] == limit;
    for (int i = 1; ok && i < n; i++)
        ok = offv[i] > offv[i - 1] && offv[i] - offv[i - 1] <= 512;
    if (!ok) {
        PyBuffer_Release(&ov);
        PyErr_SetString(PyExc_ValueError,
                        "swb offsets must rise monotonically from 0 "
                        "to 1024 (long) / 128 (short)");
        return NULL;
    }
    if (is_long) {
        memcpy(s->off_long, ov.buf, (size_t)n * 2);
        s->num_long = n - 1;
    } else {
        memcpy(s->off_short, ov.buf, (size_t)n * 2);
        s->num_short = n - 1;
    }
    PyBuffer_Release(&ov);
    if (s->num_long > 0 && s->num_short > 0) s->valid = 1;
    Py_RETURN_NONE;
}

PyObject *vrt_aac_swb_get(PyObject *self, PyObject *args) {
    (void)self;
    int sr_index, is_long;
    if (!PyArg_ParseTuple(args, "ii", &sr_index, &is_long)) return NULL;
    aac_tables_init();
    windows_init();
    if (sr_index < 0 || sr_index > 12 || !SWB[sr_index].valid) {
        PyErr_SetString(PyExc_ValueError, "swb table not loaded");
        return NULL;
    }
    SwbTab *s = &SWB[sr_index];
    int n = (is_long ? s->num_long : s->num_short) + 1;
    return PyBytes_FromStringAndSize(
        (const char *)(is_long ? s->off_long : s->off_short),
        (Py_ssize_t)n * 2);
}

PyObject *vrt_aac_set_out_scale(PyObject *self, PyObject *args) {
    (void)self;
    double v;
    if (!PyArg_ParseTuple(args, "d", &v)) return NULL;
    out_scale = v;
    Py_RETURN_NONE;
}

PyObject *vrt_aac_tns_max_set(PyObject *self, PyObject *args) {
    (void)self;
    int sr_index, lng, shrt;
    if (!PyArg_ParseTuple(args, "iii", &sr_index, &lng, &shrt))
        return NULL;
    if (sr_index < 0 || sr_index > 12) {
        PyErr_SetString(PyExc_ValueError, "bad sr index");
        return NULL;
    }
    TNS_MAX_BANDS_LONG[sr_index] = (uint8_t)lng;
    TNS_MAX_BANDS_SHORT[sr_index] = (uint8_t)shrt;
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* BEGIN EXTRACTED TABLES */
/* ORACLE-EXTRACTED tables (scripts/aac_extract_tables.py --bake): every codeword
 * individually probed against the libav decoder; see that file's header. */
static const uint8_t aac_sf_len[121] = {
    18,18,18,18,19,19,19,19,19,19,19,19,19,19,
    19,19,19,19,19,18,19,18,17,17,16,17,16,16,
    16,16,15,15,14,14,14,14,14,14,13,13,12,12,
    12,11,12,11,10,10,10,9,9,8,8,8,7,6,
    6,5,4,3,1,4,4,5,6,6,7,7,8,8,
    9,9,10,10,10,11,11,11,11,12,12,13,13,13,
    14,14,16,15,16,15,18,19,19,19,19,19,19,19,
    19,19,19,19,19,19,19,19,19,19,19,19,19,19,
    19,19,19,19,19,19,19,19,19,
};
static const uint32_t aac_sf_code[121] = {
    262120,262118,262119,262117,524277,524273,524269,524278,
    524270,524271,524272,524284,524285,524287,524286,524279,
    524280,524283,524281,262116,524282,262115,131055,131056,
    65525,131054,65522,65523,65524,65521,32758,32759,
    16377,16373,16375,16371,16374,16370,8183,8181,
    4089,4087,4086,2041,4084,2040,1017,1015,
    1013,504,503,250,248,246,121,58,
    56,26,11,4,0,10,12,27,
    57,59,120,122,247,249,502,505,
    1012,1014,1016,2037,2036,2038,2039,4085,
    4088,8180,8182,8184,16376,16372,65520,32756,
    65526,32757,262114,524249,524250,524251,524252,524253,
    524254,524248,524242,524243,524244,524245,524246,524274,
    524255,524263,524264,524265,524266,524267,524262,524256,
    524257,524258,524259,524260,524261,524247,524268,524276,
    524275,
};
static const uint8_t aac_b1_len[81] = {
    11,9,11,10,7,10,11,9,11,10,7,10,7,5,
    7,9,7,10,11,9,11,9,7,9,11,9,11,9,
    7,9,7,5,7,9,7,9,7,5,7,5,1,5,
    7,5,7,9,7,9,7,5,7,9,7,9,11,9,
    11,9,7,9,11,9,11,10,7,9,7,5,7,9,
    7,10,11,9,11,10,7,9,11,9,11,
};
static const uint32_t aac_b1_code[81] = {
    2040,497,2045,1013,104,1008,2039,492,
    2037,1009,114,1012,116,17,118,491,
    108,1014,2044,481,2033,496,97,502,
    2034,490,2043,498,105,493,119,23,
    111,486,100,485,103,21,98,18,
    0,20,101,22,109,489,99,484,
    107,19,113,483,112,499,2046,487,
    2035,495,96,494,2032,482,2042,1011,
    106,488,117,16,115,500,110,1015,
    2038,480,2041,1010,102,501,2047,503,
    2036,
};
static const uint8_t aac_b2_len[81] = {
    9,7,9,8,6,8,9,8,9,8,6,7,6,5,
    6,7,6,8,9,7,8,8,6,8,9,7,9,8,
    6,7,6,5,6,7,6,8,6,5,6,5,3,5,
    6,5,6,8,6,7,6,5,6,8,6,8,9,7,
    9,8,6,8,8,7,9,8,6,7,6,4,6,8,
    6,7,9,7,9,7,6,8,9,7,9,
};
static const uint32_t aac_b2_code[81] = {
    499,111,509,235,35,234,503,232,
    506,242,45,112,32,6,43,110,
    40,233,505,102,248,231,27,241,
    500,107,501,236,42,108,44,10,
    39,103,26,245,36,8,31,9,
    0,7,29,11,48,239,28,100,
    30,12,41,243,47,240,508,113,
    498,244,33,230,247,104,504,238,
    34,101,49,2,38,237,37,106,
    507,114,510,105,46,246,511,109,
    502,
};
static const uint8_t aac_b3_len[81] = {
    1,4,8,4,5,8,9,9,10,4,6,9,6,6,
    9,9,9,10,9,10,13,9,9,11,11,10,12,4,
    6,10,6,7,10,10,10,12,5,7,11,6,7,10,
    9,9,11,9,10,13,8,9,12,10,11,12,8,10,
    15,9,11,15,13,14,16,8,10,14,9,10,14,12,
    12,15,11,12,16,10,11,15,12,12,15,
};
static const uint32_t aac_b3_code[81] = {
    0,9,239,11,25,240,491,486,
    1010,10,53,495,52,55,489,493,
    487,1011,494,1005,8186,492,498,2041,
    2040,1016,4088,8,56,1014,54,117,
    1009,1003,1004,4084,24,118,2036,57,
    116,1007,499,500,2038,488,1002,8188,
    242,497,4091,1013,2035,4092,238,1015,
    32766,496,2037,32765,8187,16378,65535,241,
    1008,16380,490,1006,16379,4086,4090,32764,
    2034,4085,65534,1012,2039,32763,4087,4089,
    32762,
};
static const uint8_t aac_b4_len[81] = {
    4,5,8,5,4,8,9,8,11,5,5,8,5,4,
    8,8,7,10,9,8,11,8,8,10,11,10,11,4,
    5,8,4,4,8,8,8,10,4,4,8,4,4,7,
    8,7,9,8,8,10,7,7,9,10,9,10,8,8,
    11,8,7,10,11,10,12,8,7,10,7,7,9,10,
    9,11,11,10,12,10,9,11,11,10,11,
};
static const uint32_t aac_b4_code[81] = {
    7,22,246,24,8,239,495,243,
    2040,25,23,237,21,1,226,240,
    112,1008,494,241,2042,238,228,1010,
    2038,1007,2045,5,20,242,9,4,
    229,244,232,1012,6,2,231,3,
    0,107,227,105,499,235,230,1014,
    110,106,500,1004,496,1017,245,236,
    2043,234,111,1015,2041,1011,4095,233,
    109,1016,108,104,501,1006,498,2036,
    2039,1009,4094,1005,497,2037,2046,1013,
    2044,
};
static const uint8_t aac_b5_len[81] = {
    13,12,11,11,10,11,11,12,13,12,11,10,9,8,
    9,10,11,12,12,10,9,8,7,8,9,10,11,11,
    9,8,5,4,5,8,9,11,10,8,7,4,1,4,
    7,8,11,11,9,8,5,4,5,8,9,11,11,10,
    9,8,7,8,9,10,11,12,11,10,9,8,9,10,
    11,12,13,12,12,11,10,10,11,12,13,
};
static const uint32_t aac_b5_code[81] = {
    8191,4087,2036,2024,1009,2030,2041,4088,
    8189,4093,2033,1000,488,240,492,1006,
    2034,4090,4084,1007,498,232,112,236,
    496,1002,2035,2027,491,234,26,8,
    25,238,495,2029,1008,242,115,11,
    0,10,113,243,2025,2031,494,239,
    24,9,27,235,489,2028,2038,1003,
    499,237,114,233,497,1005,2039,4086,
    2032,1001,493,241,490,1004,2040,4089,
    8188,4092,4085,2026,1011,1010,2037,4091,
    8190,
};
static const uint8_t aac_b6_len[81] = {
    11,10,9,9,9,9,9,10,11,10,9,8,7,7,
    7,8,9,10,9,8,6,6,6,6,6,8,9,9,
    7,6,4,4,4,6,7,9,9,7,6,4,4,4,
    6,7,9,9,7,6,4,4,4,6,7,9,9,8,
    6,6,6,6,6,8,9,10,9,8,7,7,7,7,
    8,10,11,10,9,9,9,9,9,10,11,
};
static const uint32_t aac_b6_code[81] = {
    2046,1021,497,491,500,490,496,1020,
    2045,1014,485,234,108,113,104,240,
    486,1015,499,239,50,39,40,38,
    49,235,503,488,111,46,8,4,
    6,41,107,494,495,114,45,2,
    0,3,47,115,506,487,110,43,
    7,1,5,44,109,492,505,238,
    48,36,42,37,51,236,498,1016,
    484,237,106,112,105,116,241,1018,
    2047,1017,502,493,504,489,501,1019,
    2044,
};
static const uint8_t aac_b7_len[64] = {
    1,3,6,7,8,9,10,11,3,4,6,7,8,8,
    9,9,6,6,7,8,8,9,9,10,7,7,8,8,
    9,9,10,10,8,8,9,9,10,10,10,11,9,8,
    9,9,10,10,11,11,10,9,9,10,10,11,12,12,
    11,10,10,10,11,11,12,12,
};
static const uint32_t aac_b7_code[64] = {
    0,5,55,116,242,491,1005,2039,
    4,12,53,113,236,238,494,501,
    54,52,114,234,241,489,499,1013,
    115,112,235,240,497,496,1004,1018,
    243,237,488,495,1007,1009,1017,2043,
    493,239,490,498,1011,1016,2041,2044,
    1006,492,500,1012,1015,2040,4093,4094,
    2038,1008,1010,1014,2042,2045,4092,4095,
};
static const uint8_t aac_b8_len[64] = {
    5,4,5,6,7,8,9,10,4,3,4,5,6,7,
    7,8,5,4,4,5,6,7,7,8,6,5,5,6,
    6,7,8,8,7,6,6,6,7,7,8,9,8,7,
    6,7,7,8,8,10,9,7,7,8,8,8,9,9,
    10,8,8,8,9,9,9,10,
};
static const uint32_t aac_b8_code[64] = {
    14,5,16,48,111,241,506,1022,
    3,0,4,18,44,106,117,248,
    15,2,6,20,46,105,114,245,
    47,17,19,42,50,108,236,250,
    113,43,45,49,109,112,242,505,
    239,104,51,107,110,238,249,1020,
    504,116,115,237,240,246,502,509,
    1021,243,244,247,503,507,508,1023,
};
static const uint8_t aac_b9_len[169] = {
    1,3,6,8,9,10,10,11,11,12,12,13,13,3,
    4,6,7,8,8,9,10,10,10,11,12,12,6,6,
    7,8,8,9,10,10,10,11,12,12,12,8,7,8,
    9,9,10,10,11,11,11,12,12,13,9,8,9,9,
    10,10,11,11,11,12,12,12,13,10,9,9,10,11,
    11,11,12,11,12,12,13,13,11,9,10,11,11,11,
    12,12,12,12,13,13,13,11,10,10,11,11,12,12,
    13,13,13,13,13,13,11,10,10,11,11,11,12,12,
    13,13,14,13,14,11,10,11,11,12,12,12,12,13,
    13,14,14,14,12,11,11,12,12,12,13,13,13,14,
    14,14,15,12,11,12,12,12,13,13,13,13,14,14,
    15,15,13,12,12,12,13,13,13,13,14,14,14,14,
    15,
};
static const uint32_t aac_b9_code[169] = {
    0,5,55,231,478,974,985,1992,
    1997,4040,4061,8164,8172,4,12,53,
    114,234,237,482,977,979,992,2008,
    4047,4053,54,52,113,232,236,481,
    975,989,987,2000,4039,4052,4068,230,
    112,233,477,483,978,988,1996,1994,
    2014,4056,4074,8155,479,235,476,486,
    981,990,1995,2013,2012,4045,4066,4071,
    8161,976,480,484,982,1989,2001,2011,
    4050,2016,4057,4075,8163,8169,1988,485,
    983,1990,1999,2010,4043,4058,4067,4073,
    8166,8179,8183,2003,984,993,2004,2009,
    4051,4062,8157,8153,8162,8170,8177,8182,
    2002,980,986,1991,2007,2018,4046,4059,
    8152,8174,16368,8180,16370,2017,991,1993,
    2006,4042,4048,4069,4070,8171,8175,16371,
    16372,16373,4064,1998,2005,4038,4049,4065,
    8160,8168,8176,16369,16376,16374,32764,4072,
    2015,4041,4055,4060,8156,8159,8173,8181,
    16377,16379,32765,32766,8167,4044,4054,4063,
    8158,8154,8165,8178,16378,16375,16380,16381,
    32767,
};
static const uint8_t aac_b10_len[169] = {
    6,5,6,6,7,8,9,10,10,10,11,11,12,5,
    4,4,5,6,7,7,8,8,9,10,10,11,6,4,
    5,5,6,6,7,8,8,9,9,10,10,6,5,5,
    5,6,7,7,8,8,9,9,10,10,7,6,6,6,
    6,7,7,8,8,9,9,10,10,8,7,6,7,7,
    7,8,8,8,9,10,10,11,9,7,7,7,7,8,
    8,9,9,9,10,10,11,9,8,8,8,8,8,9,
    9,9,10,10,11,11,9,8,8,8,8,8,9,9,
    10,10,10,11,11,10,9,9,9,9,9,9,10,10,
    10,11,11,12,10,9,9,9,9,10,10,10,10,11,
    11,11,12,11,10,9,10,10,10,10,10,11,11,11,
    11,12,11,10,10,10,10,10,10,11,11,12,12,12,
    12,
};
static const uint32_t aac_b10_code[169] = {
    34,8,29,38,95,211,463,976,
    983,1005,2032,2038,4093,7,0,1,
    9,32,84,96,213,220,468,973,
    990,2023,28,2,6,12,30,40,
    91,205,217,462,476,985,1009,37,
    11,10,13,36,87,97,204,221,
    460,478,979,999,93,33,31,35,
    39,89,100,216,223,466,482,989,
    1006,209,85,41,86,88,98,206,
    224,226,474,980,995,2027,457,94,
    90,92,99,202,218,455,458,480,
    987,1000,2028,483,210,203,208,215,
    219,454,469,472,970,986,2026,2033,
    481,212,207,214,222,225,464,470,
    977,981,1010,2030,2043,1001,461,456,
    459,465,471,479,975,992,1007,2022,
    2040,4090,1003,477,467,473,475,978,
    972,988,1002,2029,2035,2041,4089,2034,
    974,484,971,984,982,994,997,2024,
    2036,2037,2039,4091,2042,1004,991,993,
    996,998,1008,2025,2031,4088,4094,4092,
    4095,
};
static const uint8_t aac_b11_len[289] = {
    4,5,6,7,8,8,9,10,10,10,11,11,12,11,
    12,12,10,5,4,5,6,7,7,8,8,9,9,9,
    10,10,10,10,11,8,6,5,5,6,7,7,8,8,
    8,9,9,9,10,10,10,10,8,7,6,6,6,7,
    7,8,8,8,9,9,9,10,10,10,10,8,8,7,
    7,7,7,8,8,8,8,9,9,9,10,10,10,10,
    8,8,7,7,7,7,8,8,8,9,9,9,9,10,
    10,10,10,8,9,8,8,8,8,8,8,8,9,9,
    9,10,10,10,10,10,8,9,8,8,8,8,8,8,
    9,9,9,10,10,10,10,10,10,8,10,9,8,8,
    9,9,9,9,9,10,10,10,10,10,10,11,8,10,
    9,9,9,9,9,9,9,10,10,10,10,10,10,11,
    11,8,11,9,9,9,9,9,9,10,10,10,10,10,
    11,10,11,11,8,11,10,9,9,10,9,10,10,10,
    10,10,11,11,11,11,11,8,11,10,10,10,10,10,
    10,10,10,10,10,11,11,11,11,11,9,11,10,9,
    9,10,10,10,10,10,10,11,11,11,11,11,11,9,
    11,10,10,10,10,10,10,10,10,10,11,11,11,11,
    11,11,9,12,10,10,10,10,10,10,10,11,11,11,
    11,11,11,12,12,9,9,8,8,8,8,8,8,8,
    8,8,8,8,8,8,8,9,5,
};
static const uint32_t aac_b11_code[289] = {
    0,6,25,61,156,198,423,912,
    962,991,2022,2035,4091,2028,4090,4094,
    910,5,1,8,20,55,66,146,
    175,401,421,437,926,960,930,973,
    2006,174,23,7,9,24,57,64,
    142,163,184,409,428,449,945,918,
    958,970,157,60,21,22,26,59,
    68,145,165,190,406,430,441,929,
    913,933,981,148,154,54,56,58,
    65,140,155,176,195,414,427,444,
    927,911,937,975,147,191,62,63,
    67,69,158,167,185,404,418,442,
    451,934,935,955,980,159,416,143,
    141,144,152,166,182,196,415,431,
    447,921,959,948,969,999,168,438,
    171,164,170,178,194,197,408,420,
    440,908,932,964,966,989,1000,173,
    943,402,189,188,398,407,410,419,
    433,909,920,951,979,977,987,2013,
    180,990,425,411,412,417,426,429,
    435,907,946,952,974,993,992,2002,
    2021,183,2019,443,424,422,432,434,
    439,923,922,954,949,982,2007,996,
    2008,2026,186,2024,928,445,436,906,
    452,914,938,944,956,983,2004,2012,
    2011,2005,2032,193,2043,968,931,917,
    925,940,942,965,984,994,998,2020,
    2023,2016,2025,2039,400,2034,915,446,
    448,916,919,941,963,961,978,2010,
    2009,2015,2027,2036,2042,405,2040,957,
    924,939,936,947,953,976,995,997,
    2018,2014,2029,2033,2041,2044,403,4093,
    988,950,967,972,971,985,986,2003,
    2017,2030,2031,2037,2038,4092,4095,413,
    450,181,161,150,151,149,153,160,
    162,172,169,177,179,187,192,399,
    4,
};
static const uint16_t aac_swbl_0[42] = {0,4,8,12,16,20,24,28,32,36,40,44,48,52,56,64,72,80,88,96,108,120,132,144,156,172,188,212,240,276,320,384,448,512,576,640,704,768,832,896,960,1024};
static const uint16_t aac_swbs_0[13] = {0,4,8,12,16,20,24,32,40,48,64,92,128};
static const uint16_t aac_swbl_1[42] = {0,4,8,12,16,20,24,28,32,36,40,44,48,52,56,64,72,80,88,96,108,120,132,144,156,172,188,212,240,276,320,384,448,512,576,640,704,768,832,896,960,1024};
static const uint16_t aac_swbs_1[13] = {0,4,8,12,16,20,24,32,40,48,64,92,128};
static const uint16_t aac_swbl_2[48] = {0,4,8,12,16,20,24,28,32,36,40,44,48,52,56,64,72,80,88,100,112,124,140,156,172,192,216,240,268,304,344,384,424,464,504,544,584,624,664,704,744,784,824,864,904,944,984,1024};
static const uint16_t aac_swbs_2[13] = {0,4,8,12,16,20,24,32,40,48,64,92,128};
static const uint16_t aac_swbl_3[50] = {0,4,8,12,16,20,24,28,32,36,40,48,56,64,72,80,88,96,108,120,132,144,160,176,196,216,240,264,292,320,352,384,416,448,480,512,544,576,608,640,672,704,736,768,800,832,864,896,928,1024};
static const uint16_t aac_swbs_3[15] = {0,4,8,12,16,20,28,36,44,56,68,80,96,112,128};
static const uint16_t aac_swbl_4[50] = {0,4,8,12,16,20,24,28,32,36,40,48,56,64,72,80,88,96,108,120,132,144,160,176,196,216,240,264,292,320,352,384,416,448,480,512,544,576,608,640,672,704,736,768,800,832,864,896,928,1024};
static const uint16_t aac_swbs_4[15] = {0,4,8,12,16,20,28,36,44,56,68,80,96,112,128};
static const uint16_t aac_swbl_5[52] = {0,4,8,12,16,20,24,28,32,36,40,48,56,64,72,80,88,96,108,120,132,144,160,176,196,216,240,264,292,320,352,384,416,448,480,512,544,576,608,640,672,704,736,768,800,832,864,896,928,960,992,1024};
static const uint16_t aac_swbs_5[15] = {0,4,8,12,16,20,28,36,44,56,68,80,96,112,128};
static const uint16_t aac_swbl_6[48] = {0,4,8,12,16,20,24,28,32,36,40,44,52,60,68,76,84,92,100,108,116,124,136,148,160,172,188,204,220,240,260,284,308,336,364,396,432,468,508,552,600,652,704,768,832,896,960,1024};
static const uint16_t aac_swbs_6[16] = {0,4,8,12,16,20,24,28,36,44,52,64,76,92,108,128};
static const uint16_t aac_swbl_7[48] = {0,4,8,12,16,20,24,28,32,36,40,44,52,60,68,76,84,92,100,108,116,124,136,148,160,172,188,204,220,240,260,284,308,336,364,396,432,468,508,552,600,652,704,768,832,896,960,1024};
static const uint16_t aac_swbs_7[16] = {0,4,8,12,16,20,24,28,36,44,52,64,76,92,108,128};
static const uint16_t aac_swbl_8[44] = {0,8,16,24,32,40,48,56,64,72,80,88,100,112,124,136,148,160,172,184,196,212,228,244,260,280,300,320,344,368,396,424,456,492,532,572,616,664,716,772,832,896,960,1024};
static const uint16_t aac_swbs_8[16] = {0,4,8,12,16,20,24,28,32,40,48,60,72,88,108,128};
static const uint16_t aac_swbl_9[44] = {0,8,16,24,32,40,48,56,64,72,80,88,100,112,124,136,148,160,172,184,196,212,228,244,260,280,300,320,344,368,396,424,456,492,532,572,616,664,716,772,832,896,960,1024};
static const uint16_t aac_swbs_9[16] = {0,4,8,12,16,20,24,28,32,40,48,60,72,88,108,128};
static const uint16_t aac_swbl_10[44] = {0,8,16,24,32,40,48,56,64,72,80,88,100,112,124,136,148,160,172,184,196,212,228,244,260,280,300,320,344,368,396,424,456,492,532,572,616,664,716,772,832,896,960,1024};
static const uint16_t aac_swbs_10[16] = {0,4,8,12,16,20,24,28,32,40,48,60,72,88,108,128};
static const uint16_t aac_swbl_11[41] = {0,12,24,36,48,60,72,84,96,108,120,132,144,156,172,188,204,220,236,252,268,288,308,328,348,372,396,420,448,476,508,544,580,620,664,712,764,820,880,944,1024};
static const uint16_t aac_swbs_11[16] = {0,4,8,12,16,20,24,28,36,44,52,60,72,88,108,128};

static void aac_tables_bind(void) {
    HCB[0].len = aac_sf_len; HCB[0].code = aac_sf_code;
    HCB[1].len = aac_b1_len; HCB[1].code = aac_b1_code;
    HCB[2].len = aac_b2_len; HCB[2].code = aac_b2_code;
    HCB[3].len = aac_b3_len; HCB[3].code = aac_b3_code;
    HCB[4].len = aac_b4_len; HCB[4].code = aac_b4_code;
    HCB[5].len = aac_b5_len; HCB[5].code = aac_b5_code;
    HCB[6].len = aac_b6_len; HCB[6].code = aac_b6_code;
    HCB[7].len = aac_b7_len; HCB[7].code = aac_b7_code;
    HCB[8].len = aac_b8_len; HCB[8].code = aac_b8_code;
    HCB[9].len = aac_b9_len; HCB[9].code = aac_b9_code;
    HCB[10].len = aac_b10_len; HCB[10].code = aac_b10_code;
    HCB[11].len = aac_b11_len; HCB[11].code = aac_b11_code;
    memcpy(SWB[0].off_long, aac_swbl_0, sizeof(aac_swbl_0));
    SWB[0].num_long = 41;
    memcpy(SWB[0].off_short, aac_swbs_0, sizeof(aac_swbs_0));
    SWB[0].num_short = 12;
    SWB[0].valid = 1;
    memcpy(SWB[1].off_long, aac_swbl_1, sizeof(aac_swbl_1));
    SWB[1].num_long = 41;
    memcpy(SWB[1].off_short, aac_swbs_1, sizeof(aac_swbs_1));
    SWB[1].num_short = 12;
    SWB[1].valid = 1;
    memcpy(SWB[2].off_long, aac_swbl_2, sizeof(aac_swbl_2));
    SWB[2].num_long = 47;
    memcpy(SWB[2].off_short, aac_swbs_2, sizeof(aac_swbs_2));
    SWB[2].num_short = 12;
    SWB[2].valid = 1;
    memcpy(SWB[3].off_long, aac_swbl_3, sizeof(aac_swbl_3));
    SWB[3].num_long = 49;
    memcpy(SWB[3].off_short, aac_swbs_3, sizeof(aac_swbs_3));
    SWB[3].num_short = 14;
    SWB[3].valid = 1;
    memcpy(SWB[4].off_long, aac_swbl_4, sizeof(aac_swbl_4));
    SWB[4].num_long = 49;
    memcpy(SWB[4].off_short, aac_swbs_4, sizeof(aac_swbs_4));
    SWB[4].num_short = 14;
    SWB[4].valid = 1;
    memcpy(SWB[5].off_long, aac_swbl_5, sizeof(aac_swbl_5));
    SWB[5].num_long = 51;
    memcpy(SWB[5].off_short, aac_swbs_5, sizeof(aac_swbs_5));
    SWB[5].num_short = 14;
    SWB[5].valid = 1;
    memcpy(SWB[6].off_long, aac_swbl_6, sizeof(aac_swbl_6));
    SWB[6].num_long = 47;
    memcpy(SWB[6].off_short, aac_swbs_6, sizeof(aac_swbs_6));
    SWB[6].num_short = 15;
    SWB[6].valid = 1;
    memcpy(SWB[7].off_long, aac_swbl_7, sizeof(aac_swbl_7));
    SWB[7].num_long = 47;
    memcpy(SWB[7].off_short, aac_swbs_7, sizeof(aac_swbs_7));
    SWB[7].num_short = 15;
    SWB[7].valid = 1;
    memcpy(SWB[8].off_long, aac_swbl_8, sizeof(aac_swbl_8));
    SWB[8].num_long = 43;
    memcpy(SWB[8].off_short, aac_swbs_8, sizeof(aac_swbs_8));
    SWB[8].num_short = 15;
    SWB[8].valid = 1;
    memcpy(SWB[9].off_long, aac_swbl_9, sizeof(aac_swbl_9));
    SWB[9].num_long = 43;
    memcpy(SWB[9].off_short, aac_swbs_9, sizeof(aac_swbs_9));
    SWB[9].num_short = 15;
    SWB[9].valid = 1;
    memcpy(SWB[10].off_long, aac_swbl_10, sizeof(aac_swbl_10));
    SWB[10].num_long = 43;
    memcpy(SWB[10].off_short, aac_swbs_10, sizeof(aac_swbs_10));
    SWB[10].num_short = 15;
    SWB[10].valid = 1;
    memcpy(SWB[11].off_long, aac_swbl_11, sizeof(aac_swbl_11));
    SWB[11].num_long = 40;
    memcpy(SWB[11].off_short, aac_swbs_11, sizeof(aac_swbs_11));
    SWB[11].num_short = 15;
    SWB[11].valid = 1;
}
/* END EXTRACTED TABLES */
