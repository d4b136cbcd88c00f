/* sbrdec.c — SBR (Spectral Band Replication) decoder: the HE-AAC
 * high-band reconstruction for the native AAC path (ISO/IEC 14496-3
 * §4.6.18).
 *
 * This is a C port of the repo's own Python reference chain —
 * scripts/sbr_parse.py (bitstream), scripts/sbr_bitstream.py
 * (frequency band tables) and scripts/sbr_ref.py (QMF banks, HF
 * generation, HF adjustment) — whose buffering offsets, phase
 * conventions and dequantization constants were pinned BEHAVIORALLY
 * against the system libav decoder on crafted streams
 * (tests/test_sbr.py, scripts/sbr_dev_check.py). Constant tables
 * (QMF prototype, noise vectors, the 10 Huffman codebooks) are the
 * probe-extracted ones baked into sbr_tables.h; no decoder source
 * was consulted.
 *
 * Reference context: the upstream project ingests HE-AAC through
 * librosa -> audioread -> ffmpeg (reference inference.py:136-138);
 * this file lets utils/audio.py decode such files full-band without
 * any external backend.
 *
 * Simplifications carried over from the pinned Python reference (both
 * documented in PARITY.md with measured bounds):
 *   - envelope borders beyond the frame (bs_var_bord_1 > 0) are
 *     clamped to the frame's 32 QMF slots instead of spilling into
 *     the next frame's adjustment run;
 *   - no inter-slot gain smoothing (bs_smoothing_mode == 0 streams
 *     decode, with the gains applied unsmoothed).
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "sbrdec.h"
#include "sbr_tables.h"

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

/* ------------------------------------------------------------------ */
/* bit reader (local to keep this file dependency-free)                */

typedef struct {
    const uint8_t *p;
    size_t pos, end;          /* absolute bit positions */
    int error;
} SBits;

static uint32_t sbits_get(SBits *b, int n) {
    uint32_t v = 0;
    if (b->pos + (size_t)n > b->end) {
        b->error = 1;
        b->pos = b->end;
        return 0;
    }
    for (int i = 0; i < n; i++) {
        v = (v << 1) | ((b->p[b->pos >> 3] >> (7 - (b->pos & 7))) & 1);
        b->pos++;
    }
    return v;
}

static int sbits_get1(SBits *b) { return (int)sbits_get(b, 1); }

/* ------------------------------------------------------------------ */
/* Huffman books (sbr_tables.h arrays, canonical (len, code) pairs)    */

typedef struct {
    const uint8_t *len;
    const uint32_t *code;
    int n, lav;
} SbrBook;

#define BOOK(name, lavv) {name##_len, name##_code, 2 * (lavv) + 1, (lavv)}

static const SbrBook BK_F_ENV[2] = {          /* [amp_res_used] */
    BOOK(sbr_f_env_1, 60), BOOK(sbr_f_env_3, 31)};
static const SbrBook BK_T_ENV[2] = {
    BOOK(sbr_t_env_1, 60), BOOK(sbr_t_env_3, 31)};
static const SbrBook BK_F_ENV_BAL[2] = {
    BOOK(sbr_f_env_bal_1, 24), BOOK(sbr_f_env_bal_3, 12)};
static const SbrBook BK_T_ENV_BAL[2] = {
    BOOK(sbr_t_env_bal_1, 24), BOOK(sbr_t_env_bal_3, 12)};
/* noise books ignore amp_res; freq deltas reuse the 3.0 dB env books */
static const SbrBook BK_T_NOISE = BOOK(sbr_t_noise_3, 31);
static const SbrBook BK_T_NOISE_BAL = BOOK(sbr_t_noise_bal_3, 12);
static const SbrBook BK_F_NOISE = BOOK(sbr_f_env_3, 31);
static const SbrBook BK_F_NOISE_BAL = BOOK(sbr_f_env_bal_3, 12);

static int huff_read(SBits *b, const SbrBook *bk) {
    uint32_t acc = 0;
    for (int len = 1; len <= 24; len++) {
        acc = (acc << 1) | (uint32_t)sbits_get1(b);
        if (b->error) return 0;
        for (int i = 0; i < bk->n; i++)
            if (bk->len[i] == len && bk->code[i] == acc)
                return i - bk->lav;
    }
    b->error = 1;
    return 0;
}

/* ------------------------------------------------------------------ */
/* frequency band tables (§4.6.18.3; scripts/sbr_bitstream.py)         */

static int sbr_round(double x) { return (int)floor(x + 0.5); }

static void isort(int *a, int n) {
    for (int i = 1; i < n; i++) {
        int v = a[i], j = i - 1;
        while (j >= 0 && a[j] > v) { a[j + 1] = a[j]; j--; }
        a[j + 1] = v;
    }
}

static int sbr_start_band(int fs_sbr, int bs_start_freq) {
    int start_min;
    if (fs_sbr < 32000) start_min = sbr_round(3000.0 * 128.0 / fs_sbr);
    else if (fs_sbr < 64000) start_min = sbr_round(4000.0 * 128.0 / fs_sbr);
    else start_min = sbr_round(5000.0 * 128.0 / fs_sbr);
    static const int off16k[16] =
        {-8, -7, -6, -5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7};
    static const int off22k[16] =
        {-5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13};
    static const int off24k[16] =
        {-5, -3, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16};
    static const int off32k[16] =
        {-6, -4, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16};
    static const int off48k[16] =
        {-4, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16, 20};
    static const int off96k[16] =
        {-2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16, 20, 24};
    const int *off;
    if (fs_sbr == 16000) off = off16k;
    else if (fs_sbr == 22050) off = off22k;
    else if (fs_sbr == 24000) off = off24k;
    else if (fs_sbr == 32000) off = off32k;
    else if (fs_sbr > 32000 && fs_sbr <= 64000) off = off48k;
    else if (fs_sbr > 64000) off = off96k;
    else return -1;
    return start_min + off[bs_start_freq & 15];
}

static int sbr_stop_band(int fs_sbr, int bs_stop_freq, int k0) {
    if (bs_stop_freq == 14) return 2 * k0 < 64 ? 2 * k0 : 64;
    if (bs_stop_freq == 15) return 3 * k0 < 64 ? 3 * k0 : 64;
    int stop_min;
    if (fs_sbr < 32000) stop_min = sbr_round(6000.0 * 128.0 / fs_sbr);
    else if (fs_sbr < 64000) stop_min = sbr_round(8000.0 * 128.0 / fs_sbr);
    else stop_min = sbr_round(10000.0 * 128.0 / fs_sbr);
    int dk[13];
    for (int i = 0; i < 13; i++)
        dk[i] = sbr_round(stop_min
                          * pow(64.0 / stop_min, (i + 1) / 13.0))
                - sbr_round(stop_min * pow(64.0 / stop_min, i / 13.0));
    isort(dk, 13);
    int k2 = stop_min;
    for (int i = 0; i < bs_stop_freq && i < 13; i++) k2 += dk[i];
    return k2 < 64 ? k2 : 64;
}

static int sbr_max_range(int fs_sbr) {
    if (fs_sbr <= 32000) return 48;
    if (fs_sbr == 44100) return 35;
    return 32;
}

/* fMaster; returns band count or <0 */
static int sbr_master_table(int k0, int k2, int freq_scale,
                            int alter_scale, int *out) {
    if (!(k0 < k2 && k2 <= 64)) return -1;
    if (freq_scale == 0) {
        int dk = alter_scale ? 2 : 1;
        int nbands = alter_scale ? (((k2 - k0 + 2) >> 2) << 1)
                                 : (((k2 - k0) >> 1) << 1);
        if (nbands <= 0 || nbands > SBR_MAXB) return -1;
        int vdk[SBR_MAXB + 1];
        for (int i = 0; i < nbands; i++) vdk[i] = dk;
        int k2_diff = k2 - (k0 + nbands * dk);
        int incr, k;
        if (k2_diff < 0) { incr = 1; k = 0; }
        else { incr = -1; k = nbands - 1; }
        while (k2_diff != 0) {
            vdk[k] -= incr;
            k += incr;
            k2_diff += incr;
        }
        out[0] = k0;
        for (int i = 0; i < nbands; i++) out[i + 1] = out[i] + vdk[i];
        return nbands;
    }
    int bands = freq_scale == 1 ? 12 : (freq_scale == 2 ? 10 : 8);
    int two_regions, k1;
    if ((double)k2 / k0 > 2.2449) { two_regions = 1; k1 = 2 * k0; }
    else { two_regions = 0; k1 = k2; }
    int nbands0 = 2 * sbr_round(bands * log2((double)k1 / k0) / 2.0);
    if (nbands0 <= 0 || nbands0 > SBR_MAXB) return -1;
    double q = pow((double)k1 / k0, 1.0 / nbands0);
    int vdk0[SBR_MAXB + 1];
    for (int i = 0; i < nbands0; i++)
        vdk0[i] = sbr_round(k0 * pow(q, i + 1)) - sbr_round(k0 * pow(q, i));
    isort(vdk0, nbands0);
    if (vdk0[0] <= 0) return -1;
    int vk0[SBR_MAXB + 2];
    vk0[0] = k0;
    for (int i = 0; i < nbands0; i++) vk0[i + 1] = vk0[i] + vdk0[i];
    if (!two_regions) {
        memcpy(out, vk0, (size_t)(nbands0 + 1) * sizeof(int));
        return nbands0;
    }
    double warp = alter_scale ? 1.3 : 1.0;
    int nbands1 =
        2 * sbr_round(bands * log2((double)k2 / k1) / (2.0 * warp));
    if (nbands1 > 0) {
        if (nbands0 + nbands1 > SBR_MAXB) return -1;
        q = pow((double)k2 / k1, 1.0 / nbands1);
        int vdk1[SBR_MAXB + 1];
        for (int i = 0; i < nbands1; i++)
            vdk1[i] = sbr_round(k1 * pow(q, i + 1))
                      - sbr_round(k1 * pow(q, i));
        isort(vdk1, nbands1);
        if (vdk1[0] < vdk0[nbands0 - 1]) {
            int change = vdk0[nbands0 - 1] - vdk1[0];
            int half = (vdk1[nbands1 - 1] - vdk1[0]) / 2;
            if (change > half) change = half;
            vdk1[0] += change;
            vdk1[nbands1 - 1] -= change;
            isort(vdk1, nbands1);
        }
        memcpy(out, vk0, (size_t)(nbands0 + 1) * sizeof(int));
        for (int i = 0; i < nbands1; i++)
            out[nbands0 + 1 + i] = out[nbands0 + i] + vdk1[i];
        return nbands0 + nbands1;
    }
    memcpy(out, vk0, (size_t)(nbands0 + 1) * sizeof(int));
    return nbands0;
}

/* patch construction (§4.6.18.6.3) */
static int sbr_patches(const int *master, int n_master, int k0, int kx,
                       int m, int fs_sbr, int *pn, int *ps) {
    int goal_sb = sbr_round(2.048e6 / fs_sbr);
    int k;
    if (goal_sb < kx + m) {
        k = 0;
        for (int i = 0; i <= n_master; i++)
            if (master[i] < goal_sb) k = i + 1;
    } else {
        k = n_master;
    }
    int msb = k0, usb = kx, n = 0, sb;
    for (;;) {
        int j = k + 1, odd;
        do {
            j--;
            sb = master[j];
            odd = (sb - 2 + k0) & 1;
        } while (sb > k0 - 1 + msb - odd);
        int n_sub = sb - usb > 0 ? sb - usb : 0;
        int start = k0 - odd - n_sub;
        if (n_sub > 0) {
            if (n > 6) return -1;
            pn[n] = n_sub;
            ps[n] = start;
            n++;
            usb = sb;
            msb = sb;
        } else {
            msb = kx;
        }
        if (master[k] - sb < 3) k = n_master;
        if (sb == kx + m) break;
        if (n > 6) return -1;
    }
    if (n > 1 && pn[n - 1] < 3) n--;
    return n;
}

/* fTableLim, kx-relative (§4.6.18.3.2.3); returns band count */
static int sbr_limiter_table(const int *low, int n_low, const int *pn,
                             int n_patches, int kx, int m,
                             int limiter_bands, int *out) {
    if (limiter_bands == 0) {
        out[0] = 0;
        out[1] = m;
        return 1;
    }
    double lim_bands = limiter_bands == 1 ? 1.2
                       : (limiter_bands == 2 ? 2.0 : 3.0);
    int pb[9], npb = 1;
    pb[0] = 0;
    for (int i = 0; i < n_patches; i++) {
        pb[npb] = pb[npb - 1] + pn[i];
        npb++;
    }
    int tab[SBR_MAXB * 2 + 16], nt = 0;
    for (int i = 0; i <= n_low; i++) tab[nt++] = low[i] - kx;
    for (int i = 0; i < npb; i++) tab[nt++] = pb[i];
    isort(tab, nt);
    /* unique + clamp to [0, m] */
    int u[SBR_MAXB * 2 + 16], nu = 0;
    for (int i = 0; i < nt; i++) {
        if (tab[i] < 0 || tab[i] > m) continue;
        if (nu == 0 || u[nu - 1] != tab[i]) u[nu++] = tab[i];
    }
    int i = 0;
    while (i < nu - 1) {
        int lo = u[i], hi = u[i + 1];
        double n_oct = log2((double)(hi + kx) / (lo + kx));
        if (n_oct * lim_bands < 0.49) {
            int lo_pb = 0, hi_pb = 0;
            for (int j = 0; j < npb; j++) {
                if (pb[j] == lo) lo_pb = 1;
                if (pb[j] == hi) hi_pb = 1;
            }
            /* lo == hi cannot survive the unique pass above */
            if (hi_pb && lo_pb) {
                i++;
            } else if (hi_pb) {
                memmove(u + i, u + i + 1, (size_t)(nu - i - 1)
                        * sizeof(int));
                nu--;
            } else {
                memmove(u + i + 1, u + i + 2, (size_t)(nu - i - 2)
                        * sizeof(int));
                nu--;
            }
        } else {
            i++;
        }
    }
    memcpy(out, u, (size_t)nu * sizeof(int));
    return nu - 1;
}

/* derive all band tables for the element's current header fields */
static int sbr_derive_tables(SbrElem *e) {
    int k0 = sbr_start_band(e->fs_sbr, e->start_freq);
    if (k0 < 0) return -1;
    int k2 = sbr_stop_band(e->fs_sbr, e->stop_freq, k0);
    if (k2 - k0 > sbr_max_range(e->fs_sbr)) return -1;
    int n_master = sbr_master_table(k0, k2, e->freq_scale,
                                    e->alter_scale, e->master);
    if (n_master <= 0) return -1;
    e->n_master = n_master;
    if (e->xover_band >= n_master) return -1;
    e->n_high = n_master - e->xover_band;
    for (int i = 0; i <= e->n_high; i++)
        e->high[i] = e->master[e->xover_band + i];
    e->n_low = e->n_high - e->n_high / 2;
    e->low[0] = e->high[0];
    for (int i = 1; i <= e->n_low; i++)
        e->low[i] = e->high[2 * i - (e->n_high & 1)];
    e->kx = e->high[0];
    e->m = e->high[e->n_high] - e->kx;
    if (e->kx > 32 || e->kx + e->m > 64) return -1;
    int n_q = sbr_round(e->noise_bands * log2((double)k2 / e->kx));
    if (n_q < 1) n_q = 1;
    if (n_q > 5) n_q = 5;
    e->n_q = n_q;
    e->noise_t[0] = e->low[0];
    int k = 0;
    for (int i = 1; i <= n_q; i++) {
        k += (e->n_low - k) / (n_q + 1 - i);
        e->noise_t[i] = e->low[k];
    }
    e->n_patches = sbr_patches(e->master, n_master, k0, e->kx, e->m,
                               e->fs_sbr, e->patch_n, e->patch_start);
    if (e->n_patches < 0) return -1;
    e->n_l = sbr_limiter_table(e->low, e->n_low, e->patch_n,
                               e->n_patches, e->kx, e->m,
                               e->limiter_bands, e->lim);
    if (e->n_l < 1) return -1;
    /* noise band of each absolute QMF band kx + i */
    for (int i = 0; i < e->m; i++) {
        int band = e->kx + i, q = e->n_q - 1;
        for (int j = 0; j < e->n_q; j++)
            if (e->noise_t[j] <= band && band < e->noise_t[j + 1]) {
                q = j;
                break;
            }
        e->band_noise[i] = q;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* bitstream parse (scripts/sbr_parse.py)                              */

static int ceil_log2i(int x) {
    int n = 0;
    x -= 1;
    while (x > 0) { n++; x >>= 1; }
    return n;
}

static const int *env_table_of(const SbrElem *e, int freq_res) {
    return freq_res ? e->high : e->low;
}

static int env_bands_of(const SbrElem *e, int freq_res) {
    return freq_res ? e->n_high : e->n_low;
}

static int n_noise_env(const SbrChData *d) {
    return d->num_env == 1 ? 1 : 2;
}

static int parse_grid(SBits *b, SbrChData *d) {
    d->frame_class = (int)sbits_get(b, 2);
    if (d->frame_class == 0) {                    /* FIXFIX */
        d->num_env = 1 << sbits_get(b, 2);
        if (d->num_env > 4) return -1;
        int fr = sbits_get1(b);
        for (int l = 0; l < d->num_env; l++) d->freq_res[l] = fr;
        d->pointer = 0;
        d->var_bord_0 = 0;
        d->var_bord_1 = 0;
    } else if (d->frame_class == 1) {             /* FIXVAR */
        d->var_bord_1 = (int)sbits_get(b, 2);
        int n_rel = (int)sbits_get(b, 2);
        int rel[4];
        for (int i = 0; i < n_rel; i++)
            rel[i] = 2 * (int)sbits_get(b, 2) + 2;
        d->num_env = n_rel + 1;
        d->pointer = (int)sbits_get(b, ceil_log2i(d->num_env + 1));
        for (int l = 0; l < d->num_env; l++)
            d->freq_res[d->num_env - 1 - l] = sbits_get1(b);
        d->var_bord_0 = 0;
        /* rel borders stashed out-of-band for env_time_borders (the
         * slots are never reached by real envelope/noise data) */
        for (int i = 0; i < n_rel; i++) d->noise_sf[2][i] = rel[i];
        d->noise_sf[2][4] = n_rel;                /* count stash */
    } else if (d->frame_class == 2) {             /* VARFIX */
        d->var_bord_0 = (int)sbits_get(b, 2);
        int n_rel = (int)sbits_get(b, 2);
        int rel[4];
        for (int i = 0; i < n_rel; i++)
            rel[i] = 2 * (int)sbits_get(b, 2) + 2;
        d->num_env = n_rel + 1;
        d->pointer = (int)sbits_get(b, ceil_log2i(d->num_env + 1));
        for (int l = 0; l < d->num_env; l++)
            d->freq_res[l] = sbits_get1(b);
        d->var_bord_1 = 0;
        for (int i = 0; i < n_rel; i++) d->noise_sf[2][i] = rel[i];
        d->noise_sf[2][4] = n_rel;
    } else {                                      /* VARVAR */
        d->var_bord_0 = (int)sbits_get(b, 2);
        d->var_bord_1 = (int)sbits_get(b, 2);
        int n0 = (int)sbits_get(b, 2);
        int n1 = (int)sbits_get(b, 2);
        if (n0 + n1 + 1 > SBR_MAXENV - 1) return -1;
        int rel0[4], rel1[4];
        for (int i = 0; i < n0; i++)
            rel0[i] = 2 * (int)sbits_get(b, 2) + 2;
        for (int i = 0; i < n1; i++)
            rel1[i] = 2 * (int)sbits_get(b, 2) + 2;
        d->num_env = n0 + n1 + 1;
        d->pointer = (int)sbits_get(b, ceil_log2i(d->num_env + 1));
        for (int l = 0; l < d->num_env; l++)
            d->freq_res[l] = sbits_get1(b);
        for (int i = 0; i < n0; i++) d->noise_sf[2][i] = rel0[i];
        d->noise_sf[2][4] = n0;
        /* second rel list stash */
        for (int i = 0; i < n1; i++) d->env_sf[SBR_MAXENV - 1][i] = rel1[i];
        d->env_sf[SBR_MAXENV - 1][4] = n1;
    }
    return b->error ? -1 : 0;
}

/* tE in core time slots (scripts/sbr_ref.py env_time_borders), using
 * the rel-border stashes left by parse_grid */
static int env_time_borders(const SbrChData *d, int *te) {
    int n = d->num_env;
    if (d->frame_class == 0) {                    /* FIXFIX */
        for (int l = 0; l <= n; l++)
            te[l] = sbr_round((double)SBR_SLOTS * l / n);
        return n + 1;
    }
    if (d->frame_class == 1) {                    /* FIXVAR */
        int n_rel = d->noise_sf[2][4];
        int tmp[SBR_MAXENV + 1], m = 0;
        tmp[m++] = SBR_SLOTS + d->var_bord_1;
        for (int i = 0; i < n_rel; i++)
            tmp[m] = tmp[m - 1] - d->noise_sf[2][i], m++;
        tmp[m++] = 0;
        for (int i = 0; i < m; i++) te[i] = tmp[m - 1 - i];
        return m;
    }
    if (d->frame_class == 2) {                    /* VARFIX */
        int n_rel = d->noise_sf[2][4];
        int m = 0;
        te[m++] = d->var_bord_0;
        for (int i = 0; i < n_rel; i++)
            te[m] = te[m - 1] + d->noise_sf[2][i], m++;
        te[m++] = SBR_SLOTS;
        return m;
    }
    /* VARVAR */
    {
        int n0 = d->noise_sf[2][4];
        int n1 = d->env_sf[SBR_MAXENV - 1][4];
        int m = 0;
        te[m++] = d->var_bord_0;
        for (int i = 0; i < n0; i++)
            te[m] = te[m - 1] + d->noise_sf[2][i], m++;
        int tail[SBR_MAXENV + 1], tm = 0;
        tail[tm++] = SBR_SLOTS + d->var_bord_1;
        for (int i = 0; i < n1; i++)
            tail[tm] = tail[tm - 1] - d->env_sf[SBR_MAXENV - 1][i], tm++;
        for (int i = 0; i < tm; i++) te[m + i] = tail[tm - 1 - i];
        return m + tm;
    }
}

static int l_a_of(const SbrChData *d) {
    int fc = d->frame_class, p = d->pointer;
    if (fc == 0) return -1;
    if (fc == 2) return p > 1 ? p - 1 : -1;
    return p > 0 ? d->num_env + 1 - p : -1;
}

static int middle_border(const SbrChData *d) {
    int fc = d->frame_class, p = d->pointer;
    if (fc == 0) return d->num_env / 2;
    if (fc == 2) {
        if (p == 0) return 1;
        if (p == 1) return d->num_env - 1;
        return p - 1;
    }
    if (p > 1) return d->num_env + 1 - p;
    return d->num_env - 1;
}

static void parse_dtdf(SBits *b, SbrChData *d) {
    for (int l = 0; l < d->num_env; l++) d->df_env[l] = sbits_get1(b);
    for (int l = 0; l < n_noise_env(d); l++)
        d->df_noise[l] = sbits_get1(b);
}

static int parse_envelope(SBits *b, SbrElem *e, SbrChan *c,
                          SbrChData *d, int balance) {
    int amp = d->amp_used;
    int start_bits = balance ? (amp ? 5 : 6) : (amp ? 6 : 7);
    const SbrBook *fbk = balance ? &BK_F_ENV_BAL[amp] : &BK_F_ENV[amp];
    const SbrBook *tbk = balance ? &BK_T_ENV_BAL[amp] : &BK_T_ENV[amp];
    for (int l = 0; l < d->num_env; l++) {
        int n = env_bands_of(e, d->freq_res[l]);
        if (d->df_env[l] == 0) {
            d->env_sf[l][0] = (int)sbits_get(b, start_bits);
            for (int k = 1; k < n; k++)
                d->env_sf[l][k] = d->env_sf[l][k - 1]
                                  + huff_read(b, fbk);
        } else {
            const int *pv;
            int pres;
            if (l == 0) {
                if (!c->env_prev_valid) return -1;
                pv = c->env_prev;
                pres = c->env_prev_res;
            } else {
                pv = d->env_sf[l - 1];
                pres = d->freq_res[l - 1];
            }
            const int *ptab = env_table_of(e, pres);
            int pnb = env_bands_of(e, pres);
            const int *ctab = env_table_of(e, d->freq_res[l]);
            for (int k = 0; k < n; k++) {
                int delta = huff_read(b, tbk);
                int lo = ctab[k], j = 0;
                while (j + 1 < pnb + 1 && ptab[j + 1] <= lo) j++;
                d->env_sf[l][k] = pv[j] + delta;
            }
        }
        if (b->error) return -1;
    }
    /* cross-frame reference = last envelope */
    {
        int lr = d->num_env - 1;
        int n = env_bands_of(e, d->freq_res[lr]);
        memcpy(c->env_prev, d->env_sf[lr], (size_t)n * sizeof(int));
        c->env_prev_res = d->freq_res[lr];
        c->env_prev_valid = 1;
    }
    return 0;
}

static int parse_noise(SBits *b, SbrElem *e, SbrChan *c, SbrChData *d,
                       int balance) {
    const SbrBook *fbk = balance ? &BK_F_NOISE_BAL : &BK_F_NOISE;
    const SbrBook *tbk = balance ? &BK_T_NOISE_BAL : &BK_T_NOISE;
    for (int l = 0; l < n_noise_env(d); l++) {
        if (d->df_noise[l] == 0) {
            d->noise_sf[l][0] = (int)sbits_get(b, 5);
            for (int k = 1; k < e->n_q; k++)
                d->noise_sf[l][k] = d->noise_sf[l][k - 1]
                                    + huff_read(b, fbk);
        } else {
            const int *pv;
            if (l == 0) {
                if (!c->noise_prev_valid) return -1;
                pv = c->noise_prev;
            } else {
                pv = d->noise_sf[l - 1];
            }
            for (int k = 0; k < e->n_q; k++)
                d->noise_sf[l][k] = pv[k] + huff_read(b, tbk);
        }
        if (b->error) return -1;
    }
    memcpy(c->noise_prev, d->noise_sf[n_noise_env(d) - 1],
           (size_t)e->n_q * sizeof(int));
    c->noise_prev_valid = 1;
    return 0;
}

static void parse_add_harmonic(SBits *b, const SbrElem *e,
                               SbrChData *d) {
    d->add_harm_flag = sbits_get1(b);
    if (d->add_harm_flag)
        for (int j = 0; j < e->n_high; j++)
            d->add_harm[j] = (uint8_t)sbits_get1(b);
    else
        memset(d->add_harm, 0, sizeof(d->add_harm));
}

static void copy_grid(SbrChData *dst, const SbrChData *src) {
    dst->frame_class = src->frame_class;
    dst->num_env = src->num_env;
    dst->pointer = src->pointer;
    dst->var_bord_0 = src->var_bord_0;
    dst->var_bord_1 = src->var_bord_1;
    memcpy(dst->freq_res, src->freq_res, sizeof(dst->freq_res));
    /* rel-border stashes */
    memcpy(dst->noise_sf[2], src->noise_sf[2], sizeof(dst->noise_sf[2]));
    memcpy(dst->env_sf[SBR_MAXENV - 1], src->env_sf[SBR_MAXENV - 1],
           sizeof(dst->env_sf[SBR_MAXENV - 1]));
    dst->amp_used = src->amp_used;
}

static int amp_res_used(const SbrChData *d, int header_amp) {
    if (d->frame_class == 0 && d->num_env == 1) return 0;
    return header_amp;
}

static void reset_parse_state(SbrElem *e) {
    for (int c = 0; c < 2; c++) {
        e->ch[c].env_prev_valid = 0;
        e->ch[c].noise_prev_valid = 0;
        memset(e->ch[c].bw, 0, sizeof(e->ch[c].bw));
        memset(e->ch[c].s_prev, 0, sizeof(e->ch[c].s_prev));
        e->ch[c].la_prev = -1;
    }
}

int sbr_parse_payload(SbrElem *e, const uint8_t *data, size_t bit_off,
                      size_t bit_len, int stereo, int crc) {
    SBits b = {data, bit_off, bit_off + bit_len, 0};
    if (crc) sbits_get(&b, 10);
    if (sbits_get1(&b)) {                       /* bs_header_flag */
        int h[11];
        h[0] = (int)sbits_get(&b, 1);           /* amp_res */
        h[1] = (int)sbits_get(&b, 4);           /* start_freq */
        h[2] = (int)sbits_get(&b, 4);           /* stop_freq */
        h[3] = (int)sbits_get(&b, 3);           /* xover_band */
        sbits_get(&b, 2);                       /* bs_reserved */
        int e1 = sbits_get1(&b), e2 = sbits_get1(&b);
        h[4] = 2; h[5] = 1; h[6] = 2;           /* extra1 defaults */
        h[7] = 2; h[8] = 2; h[9] = 1; h[10] = 1; /* extra2 defaults */
        if (e1) {
            h[4] = (int)sbits_get(&b, 2);       /* freq_scale */
            h[5] = (int)sbits_get(&b, 1);       /* alter_scale */
            h[6] = (int)sbits_get(&b, 2);       /* noise_bands */
        }
        if (e2) {
            h[7] = (int)sbits_get(&b, 2);       /* limiter_bands */
            h[8] = (int)sbits_get(&b, 2);       /* limiter_gains */
            h[9] = (int)sbits_get(&b, 1);       /* interpol_freq */
            h[10] = (int)sbits_get(&b, 1);      /* smoothing_mode */
        }
        if (b.error) return -1;
        int changed = !e->active || h[0] != e->amp_res
            || h[1] != e->start_freq || h[2] != e->stop_freq
            || h[3] != e->xover_band || h[4] != e->freq_scale
            || h[5] != e->alter_scale || h[6] != e->noise_bands
            || h[7] != e->limiter_bands;
        e->amp_res = h[0]; e->start_freq = h[1]; e->stop_freq = h[2];
        e->xover_band = h[3]; e->freq_scale = h[4];
        e->alter_scale = h[5]; e->noise_bands = h[6];
        e->limiter_bands = h[7]; e->limiter_gains = h[8];
        e->interpol_freq = h[9]; e->smoothing_mode = h[10];
        if (changed) {
            if (sbr_derive_tables(e)) {
                e->active = 0;
                return -1;
            }
            reset_parse_state(e);
        }
        e->active = 1;
    }
    if (!e->active) return -1;
    SbrChData *d0 = &e->ch[0].d, *d1 = &e->ch[1].d;
    memset(d0, 0, sizeof(*d0));
    if (!stereo) {
        if (sbits_get1(&b)) sbits_get(&b, 4);   /* bs_data_extra */
        if (parse_grid(&b, d0)) return -1;
        d0->amp_used = amp_res_used(d0, e->amp_res);
        parse_dtdf(&b, d0);
        for (int q = 0; q < e->n_q; q++)
            d0->invf[q] = (int)sbits_get(&b, 2);
        if (parse_envelope(&b, e, &e->ch[0], d0, 0)) return -1;
        if (parse_noise(&b, e, &e->ch[0], d0, 0)) return -1;
        parse_add_harmonic(&b, e, d0);
        e->coupling = 0;
        e->ch[0].have = !b.error;
        e->ch[1].have = 0;
    } else {
        memset(d1, 0, sizeof(*d1));
        if (sbits_get1(&b)) sbits_get(&b, 4);   /* bs_data_extra */
        e->coupling = sbits_get1(&b);
        if (e->coupling) {
            if (parse_grid(&b, d0)) return -1;
            d0->amp_used = amp_res_used(d0, e->amp_res);
            copy_grid(d1, d0);
            parse_dtdf(&b, d0);
            parse_dtdf(&b, d1);
            for (int q = 0; q < e->n_q; q++)
                d0->invf[q] = (int)sbits_get(&b, 2);
            memcpy(d1->invf, d0->invf, sizeof(d0->invf));
            if (parse_envelope(&b, e, &e->ch[0], d0, 0)) return -1;
            if (parse_noise(&b, e, &e->ch[0], d0, 0)) return -1;
            if (parse_envelope(&b, e, &e->ch[1], d1, 1)) return -1;
            if (parse_noise(&b, e, &e->ch[1], d1, 1)) return -1;
            parse_add_harmonic(&b, e, d0);
            parse_add_harmonic(&b, e, d1);
        } else {
            if (parse_grid(&b, d0)) return -1;
            if (parse_grid(&b, d1)) return -1;
            d0->amp_used = amp_res_used(d0, e->amp_res);
            d1->amp_used = amp_res_used(d1, e->amp_res);
            parse_dtdf(&b, d0);
            parse_dtdf(&b, d1);
            for (int q = 0; q < e->n_q; q++)
                d0->invf[q] = (int)sbits_get(&b, 2);
            for (int q = 0; q < e->n_q; q++)
                d1->invf[q] = (int)sbits_get(&b, 2);
            if (parse_envelope(&b, e, &e->ch[0], d0, 0)) return -1;
            if (parse_envelope(&b, e, &e->ch[1], d1, 0)) return -1;
            if (parse_noise(&b, e, &e->ch[0], d0, 0)) return -1;
            if (parse_noise(&b, e, &e->ch[1], d1, 0)) return -1;
            parse_add_harmonic(&b, e, d0);
            parse_add_harmonic(&b, e, d1);
        }
        e->ch[0].have = e->ch[1].have = !b.error;
    }
    if (sbits_get1(&b)) {                       /* bs_extended_data */
        size_t size = sbits_get(&b, 4);
        if (size == 15) size += sbits_get(&b, 8);
        b.pos += 8 * size;                      /* PS lives here */
        if (b.pos > b.end) b.error = 1;
    }
    return b.error ? -1 : 0;
}

/* ------------------------------------------------------------------ */
/* QMF filterbanks (scripts/sbr_ref.py QmfAnalysis / QmfSynthesis)     */

static double qmf_win[640];        /* full signed 640-tap prototype */
static double qmf_win_dec[320];    /* win[1::2] for analysis */
static double ana_mod_re[32][64], ana_mod_im[32][64];
static double syn_mod_re[128][64], syn_mod_im[128][64];
static double noise_re[512], noise_im[512];
static int sbr_dsp_ready = 0;

static void sbr_dsp_init(void) {
    if (sbr_dsp_ready) return;
    for (int i = 0; i < 640; i++) qmf_win[i] = (double)SBR_QMF_WIN[i];
    for (int i = 0; i < 320; i++) qmf_win_dec[i] = qmf_win[2 * i + 1];
    for (int k = 0; k < 32; k++)
        for (int n = 0; n < 64; n++) {
            double a = M_PI / 32.0 * (k + 0.5) * (n - 0.25);
            ana_mod_re[k][n] = 2.0 * cos(a);
            ana_mod_im[k][n] = 2.0 * sin(a);
        }
    for (int n = 0; n < 128; n++)
        for (int k = 0; k < 64; k++) {
            double a = M_PI / 128.0 * (k + 0.5) * (2 * n - 253);
            syn_mod_re[n][k] = cos(a);
            syn_mod_im[n][k] = sin(a);
        }
    for (int i = 0; i < 512; i++) {
        noise_re[i] = (double)SBR_NOISE[2 * i];
        noise_im[i] = (double)SBR_NOISE[2 * i + 1];
    }
    sbr_dsp_ready = 1;
}

static void qmf_analysis_slot(SbrChan *c, const float *pcm32,
                              double *Xre, double *Xim) {
    memmove(c->ana_x + 32, c->ana_x, 288 * sizeof(double));
    for (int i = 0; i < 32; i++) c->ana_x[i] = (double)pcm32[31 - i];
    double u[64];
    for (int n = 0; n < 64; n++) {
        double s = 0.0;
        for (int a = 0; a < 5; a++)
            s += c->ana_x[64 * a + n] * qmf_win_dec[64 * a + n];
        u[n] = s;
    }
    for (int k = 0; k < 32; k++) {
        double sr = 0.0, si = 0.0;
        const double *mr = ana_mod_re[k], *mi = ana_mod_im[k];
        for (int n = 0; n < 64; n++) {
            sr += u[n] * mr[n];
            si += u[n] * mi[n];
        }
        Xre[k] = sr;
        Xim[k] = si;
    }
}

static void qmf_synthesis_slot(SbrChan *c, const double *Xre,
                               const double *Xim, float *out64) {
    memmove(c->syn_v + 128, c->syn_v, (1280 - 128) * sizeof(double));
    for (int n = 0; n < 128; n++) {
        double s = 0.0;
        const double *mr = syn_mod_re[n], *mi = syn_mod_im[n];
        for (int k = 0; k < 64; k++)
            s += Xre[k] * mr[k] - Xim[k] * mi[k];
        c->syn_v[n] = s / 64.0;
    }
    for (int j = 0; j < 64; j++) {
        double s = 0.0;
        for (int a = 0; a < 5; a++) {
            s += c->syn_v[256 * a + j] * qmf_win[128 * a + j];
            s += c->syn_v[256 * a + 192 + j] * qmf_win[128 * a + 64 + j];
        }
        out64[j] = (float)s;
    }
}

/* ------------------------------------------------------------------ */
/* HF generation (scripts/sbr_ref.py _chirp/_lpc/_hf_generate)         */

#define NSLOT (SBR_T_HFGEN + SBR_SUB)   /* 40 buffered QMF slots */

static void sbr_chirp(SbrElem *e, SbrChan *c) {
    static const double invf_bw[4] = {0.0, 0.75, 0.9, 0.98};
    for (int q = 0; q < e->n_q; q++) {
        double nw = invf_bw[c->d.invf[q] & 3], pv = c->bw[q], bw;
        if (nw < pv) bw = 0.75 * nw + 0.25 * pv;
        else bw = 0.90625 * nw + 0.09375 * pv;
        if (bw < 0.015625) bw = 0.0;
        c->bw[q] = bw;
    }
}

/* 2nd-order complex covariance LPC over band p of the 40-slot buffer */
static void sbr_lpc(const double (*Xre)[32],
                    const double (*Xim)[32], int p,
                    double *a0r, double *a0i, double *a1r, double *a1i) {
    double p01r = 0, p01i = 0, p02r = 0, p02i = 0;
    double p11 = 0, p12r = 0, p12i = 0, p22 = 0;
    for (int t = 2; t < NSLOT; t++) {
        double x0r = Xre[t][p], x0i = Xim[t][p];
        double x1r = Xre[t - 1][p], x1i = Xim[t - 1][p];
        double x2r = Xre[t - 2][p], x2i = Xim[t - 2][p];
        p01r += x0r * x1r + x0i * x1i;     /* x0 * conj(x1) */
        p01i += x0i * x1r - x0r * x1i;
        p02r += x0r * x2r + x0i * x2i;
        p02i += x0i * x2r - x0r * x2i;
        p11 += x1r * x1r + x1i * x1i;
        p12r += x1r * x2r + x1i * x2i;
        p12i += x1i * x2r - x1r * x2i;
        p22 += x2r * x2r + x2i * x2i;
    }
    double d = p11 * p22 - (p12r * p12r + p12i * p12i) / 1.000001;
    double A1r = 0, A1i = 0, A0r = 0, A0i = 0;
    if (d != 0.0) {
        /* a1 = (p01 * p12 - p02 * p11) / d */
        A1r = (p01r * p12r - p01i * p12i - p02r * p11) / d;
        A1i = (p01r * p12i + p01i * p12r - p02i * p11) / d;
    }
    if (p11 != 0.0) {
        /* a0 = -(p01 + a1 * conj(p12)) / p11 */
        A0r = -(p01r + A1r * p12r + A1i * p12i) / p11;
        A0i = -(p01i + A1i * p12r - A1r * p12i) / p11;
    }
    if (A0r * A0r + A0i * A0i >= 16.0 || A1r * A1r + A1i * A1i >= 16.0) {
        A0r = A0i = A1r = A1i = 0.0;
    }
    *a0r = A0r; *a0i = A0i; *a1r = A1r; *a1i = A1i;
}

/* xh[t][k] for t in [0, SUB) (buffer slots [2, 34)), k in [0, 64) */
static void sbr_hf_generate(SbrElem *e, SbrChan *c,
                            const double (*Xre)[32],
                            const double (*Xim)[32],
                            double xh_re[SBR_SUB][64],
                            double xh_im[SBR_SUB][64]) {
    memset(xh_re, 0, sizeof(double) * SBR_SUB * 64);
    memset(xh_im, 0, sizeof(double) * SBR_SUB * 64);
    int k = e->kx;
    const int d0 = SBR_T_HFGEN - SBR_T_HFADJ;   /* content delay = 2 */
    for (int pi = 0; pi < e->n_patches; pi++) {
        for (int i = 0; i < e->patch_n[pi]; i++) {
            int p = e->patch_start[pi] + i;
            if (k >= 64 || k >= e->kx + e->m) return; /* guarded above */
            double b = c->bw[e->band_noise[k - e->kx]];
            double a0r = 0, a0i = 0, a1r = 0, a1i = 0;
            if (b > 0.0)
                sbr_lpc(Xre, Xim, p, &a0r, &a0i, &a1r, &a1i);
            double ba0r = b * a0r, ba0i = b * a0i;
            double b2a1r = b * b * a1r, b2a1i = b * b * a1i;
            for (int t = 0; t < SBR_SUB; t++) {
                int bt = d0 + t;
                double x0r = Xre[bt][p], x0i = Xim[bt][p];
                double x1r = Xre[bt - 1][p], x1i = Xim[bt - 1][p];
                double x2r = Xre[bt - 2][p], x2i = Xim[bt - 2][p];
                xh_re[t][k] = x0r + ba0r * x1r - ba0i * x1i
                              + b2a1r * x2r - b2a1i * x2i;
                xh_im[t][k] = x0i + ba0r * x1i + ba0i * x1r
                              + b2a1r * x2i + b2a1i * x2r;
            }
            k++;
        }
    }
}

/* ------------------------------------------------------------------ */
/* dequantization (§4.6.18.7.1-2; scale pinned vs oracle)              */

#define ENV_EXP_OFFSET 6.0
#define NOISE_FLOOR_OFFSET 6.0
#define E2_EXP 30.0          /* our-units -> spec-units energy shift */
#define BOOST_MAX 1.584893192
#define SBR_EPS 1e-12

static const double LIM_GAIN_TAB[4] = {0.70795, 1.0, 1.41254, 1e10};

/* fills e_orig[ch][l][k] and q_orig[ch][l][k]; coupling splits the
 * channel-0 energies by the channel-1 balance values (spec
 * §4.6.18.7.2: balance values act doubled; offsets 12/24, exponent
 * +7/+1 carry the factor-2 energy split — validated behaviorally
 * against the libav oracle in tests/test_sbr.py) */
static void sbr_dequant(SbrElem *e, int nch,
                        double e_orig[2][SBR_MAXENV][SBR_MAXB],
                        double q_orig[2][2][SBR_MAXNQ]) {
    SbrChData *d0 = &e->ch[0].d;
    if (nch == 2 && e->coupling) {
        SbrChData *d1 = &e->ch[1].d;
        double alpha = d0->amp_used ? 1.0 : 0.5;
        double pan = d0->amp_used ? 12.0 : 24.0;
        for (int l = 0; l < d0->num_env; l++) {
            int n = env_bands_of(e, d0->freq_res[l]);
            for (int k = 0; k < n; k++) {
                double t1 = exp2(d0->env_sf[l][k] * alpha + 7.0);
                double t2 = exp2((pan - 2.0 * d1->env_sf[l][k]) * alpha);
                double L = t1 / (1.0 + t2);
                e_orig[0][l][k] = L;
                e_orig[1][l][k] = L * t2;
            }
        }
        for (int l = 0; l < n_noise_env(d0); l++)
            for (int k = 0; k < e->n_q; k++) {
                double t1 = exp2(NOISE_FLOOR_OFFSET
                                 - d0->noise_sf[l][k] + 1.0);
                double t2 = exp2(12.0 - 2.0 * d1->noise_sf[l][k]);
                double L = t1 / (1.0 + t2);
                q_orig[0][l][k] = L;
                q_orig[1][l][k] = L * t2;
            }
        return;
    }
    for (int c = 0; c < nch; c++) {
        SbrChData *d = &e->ch[c].d;
        if (!e->ch[c].have) continue;
        double a = d->amp_used ? 1.0 : 2.0;
        for (int l = 0; l < d->num_env; l++) {
            int n = env_bands_of(e, d->freq_res[l]);
            for (int k = 0; k < n; k++)
                e_orig[c][l][k] =
                    exp2(d->env_sf[l][k] / a + ENV_EXP_OFFSET);
        }
        for (int l = 0; l < n_noise_env(d); l++)
            for (int k = 0; k < e->n_q; k++)
                q_orig[c][l][k] =
                    exp2(NOISE_FLOOR_OFFSET - d->noise_sf[l][k]);
    }
}

/* ------------------------------------------------------------------ */
/* HF adjustment (scripts/sbr_ref.py _adjust)                          */

static void sbr_adjust(SbrElem *e, SbrChan *c,
                       const double (*e_orig)[SBR_MAXB],
                       const double (*q_orig)[SBR_MAXNQ],
                       const double (*xh_re)[64],
                       const double (*xh_im)[64],
                       double y_re[SBR_SUB][64],
                       double y_im[SBR_SUB][64]) {
    SbrChData *d = &c->d;
    int te[SBR_MAXENV + 2];
    int nte = env_time_borders(d, te);
    (void)nte;
    int tq[3];
    if (d->num_env == 1) {
        tq[0] = te[0];
        tq[1] = te[d->num_env];
    } else {
        tq[0] = te[0];
        tq[1] = te[middle_border(d)];
        tq[2] = te[d->num_env];
    }
    int la = l_a_of(d);
    int m = e->m, kx = e->kx;
    memcpy(y_re, xh_re, sizeof(double) * SBR_SUB * 64);
    memcpy(y_im, xh_im, sizeof(double) * SBR_SUB * 64);
    /* sinusoid target band per high band */
    int sine_m[SBR_MAXB];
    for (int j = 0; j < e->n_high; j++)
        sine_m[j] = (e->high[j] + e->high[j + 1]) / 2 - kx;
    const uint8_t *new_sines = d->add_harm;
    double escale = exp2(E2_EXP);
    double amp_down = exp2(-E2_EXP / 2.0);
    for (int l = 0; l < d->num_env; l++) {
        int t0 = te[l] * SBR_RATE, t1 = te[l + 1] * SBR_RATE;
        if (t0 < 0) t0 = 0;
        if (t1 > SBR_SUB) t1 = SBR_SUB;   /* ref-faithful border clamp */
        if (t0 >= t1) continue;
        int fr = d->freq_res[l];
        const int *ftab = env_table_of(e, fr);
        int nb = env_bands_of(e, fr);
        double e_map[SBR_MAXB], q_map[SBR_MAXB];
        double s_idx_m[SBR_MAXB], s_map[SBR_MAXB];
        for (int j = 0; j < nb; j++) {
            int lo = ftab[j] - kx, hi = ftab[j + 1] - kx;
            for (int mi = lo; mi < hi && mi < m; mi++)
                e_map[mi] = e_orig[l][j];
        }
        int nl = 0;
        int n_tq = d->num_env == 1 ? 2 : 3;
        while (nl + 1 < n_tq - 1 && te[l] >= tq[nl + 1]) nl++;
        for (int j = 0; j < e->n_q; j++) {
            int lo = e->noise_t[j] - kx, hi = e->noise_t[j + 1] - kx;
            for (int mi = lo; mi < hi && mi < m; mi++)
                q_map[mi] = q_orig[nl][j];
        }
        memset(s_idx_m, 0, sizeof(double) * (size_t)m);
        memset(s_map, 0, sizeof(double) * (size_t)m);
        for (int j = 0; j < e->n_high; j++) {
            int present = new_sines[j]
                && (l >= (la >= 0 ? la : 0) || c->s_prev[j]);
            if (present) {
                s_idx_m[sine_m[j]] = 1.0;
                for (int jj = 0; jj < nb; jj++) {
                    int lo = ftab[jj] - kx, hi = ftab[jj + 1] - kx;
                    if (lo <= sine_m[j] && sine_m[j] < hi)
                        for (int mi = lo; mi < hi && mi < m; mi++)
                            s_map[mi] = 1.0;
                }
            }
        }
        double e_curr[SBR_MAXB];
        if (e->interpol_freq) {
            for (int mi = 0; mi < m; mi++) {
                double s = 0.0;
                for (int t = t0; t < t1; t++) {
                    double xr = xh_re[t][kx + mi], xi = xh_im[t][kx + mi];
                    s += xr * xr + xi * xi;
                }
                e_curr[mi] = s / (t1 - t0) * escale;
            }
        } else {
            for (int j = 0; j < nb; j++) {
                int lo = ftab[j] - kx, hi = ftab[j + 1] - kx;
                double s = 0.0;
                int cnt = 0;
                for (int t = t0; t < t1; t++)
                    for (int mi = lo; mi < hi && mi < m; mi++) {
                        double xr = xh_re[t][kx + mi];
                        double xi = xh_im[t][kx + mi];
                        s += xr * xr + xi * xi;
                        cnt++;
                    }
                double v = cnt ? s / cnt * escale : 0.0;
                for (int mi = lo; mi < hi && mi < m; mi++)
                    e_curr[mi] = v;
            }
        }
        double delta = (l == la || l == c->la_prev) ? 0.0 : 1.0;
        double s_m[SBR_MAXB], q_m[SBR_MAXB], gain[SBR_MAXB];
        for (int mi = 0; mi < m; mi++) {
            s_m[mi] = sqrt(e_map[mi] * s_idx_m[mi] / (1.0 + q_map[mi]));
            q_m[mi] = sqrt(e_map[mi] * q_map[mi] / (1.0 + q_map[mi]));
            if (s_map[mi] == 0.0)
                gain[mi] = sqrt(e_map[mi]
                                / ((1.0 + e_curr[mi])
                                   * (1.0 + q_map[mi] * delta)));
            else
                gain[mi] = sqrt(e_map[mi] * q_map[mi]
                                / ((1.0 + e_curr[mi])
                                   * (1.0 + q_map[mi])));
        }
        /* limiter + boost, per limiter band */
        for (int i = 0; i < e->n_l; i++) {
            int lo = e->lim[i], hi = e->lim[i + 1];
            if (hi <= lo) continue;
            if (hi > m) hi = m;
            double sum_e = 0.0, sum_c = 0.0;
            for (int mi = lo; mi < hi; mi++) {
                sum_e += e_map[mi];
                sum_c += e_curr[mi];
            }
            double g_max = LIM_GAIN_TAB[e->limiter_gains & 3]
                           * sqrt((SBR_EPS + sum_e) / (SBR_EPS + sum_c));
            if (g_max > 1e10) g_max = 1e10;
            for (int mi = lo; mi < hi; mi++) {
                if (gain[mi] > g_max) {
                    double g = gain[mi] > SBR_EPS ? gain[mi] : SBR_EPS;
                    q_m[mi] = q_m[mi] * g_max / g;
                    gain[mi] = g_max;
                }
            }
            double num = SBR_EPS + sum_e;
            double den = SBR_EPS;
            for (int mi = lo; mi < hi; mi++) {
                den += e_curr[mi] * gain[mi] * gain[mi];
                den += s_m[mi] * s_m[mi];
                if (s_idx_m[mi] == 0.0)
                    den += delta * q_m[mi] * q_m[mi];
            }
            double boost = sqrt(num / den);
            if (boost > BOOST_MAX) boost = BOOST_MAX;
            for (int mi = lo; mi < hi; mi++) {
                gain[mi] *= boost;
                q_m[mi] *= boost;
                s_m[mi] *= boost;
            }
        }
        for (int mi = 0; mi < m; mi++) {
            q_m[mi] *= amp_down;
            s_m[mi] *= amp_down;
        }
        int any_sine = 0;
        for (int mi = 0; mi < m; mi++)
            if (s_idx_m[mi] != 0.0) { any_sine = 1; break; }
        for (int t = t0; t < t1; t++) {
            for (int mi = 0; mi < m; mi++) {
                y_re[t][kx + mi] = xh_re[t][kx + mi] * gain[mi];
                y_im[t][kx + mi] = xh_im[t][kx + mi] * gain[mi];
            }
            int idx = c->f_index_noise;
            for (int mi = 0; mi < m; mi++) {
                idx = (idx + 1) & 511;
                if (s_idx_m[mi] == 0.0
                    && (delta == 1.0 || s_map[mi] == 0.0)) {
                    y_re[t][kx + mi] += q_m[mi] * noise_re[idx];
                    y_im[t][kx + mi] += q_m[mi] * noise_im[idx];
                }
            }
            c->f_index_noise = idx;
            if (any_sine) {
                int ph = c->f_index_sine & 3;
                /* i^ph: (1, i, -1, -i) */
                double pr = ph == 0 ? 1.0 : (ph == 2 ? -1.0 : 0.0);
                double pim = ph == 1 ? 1.0 : (ph == 3 ? -1.0 : 0.0);
                for (int mi = 0; mi < m; mi++)
                    if (s_idx_m[mi] != 0.0) {
                        y_re[t][kx + mi] += s_m[mi] * pr;
                        y_im[t][kx + mi] += s_m[mi] * pim;
                    }
            }
            c->f_index_sine = (c->f_index_sine + 1) & 3;
        }
    }
    memcpy(c->s_prev, new_sines, (size_t)e->n_high);
    c->la_prev = la;
}

/* ------------------------------------------------------------------ */
/* public entry points                                                 */

void sbr_elem_init(SbrElem *e, int fs_core) {
    if (e->inited && e->fs_sbr == 2 * fs_core) return;
    memset(e, 0, sizeof(*e));
    e->fs_sbr = 2 * fs_core;
    for (int c = 0; c < 2; c++) e->ch[c].la_prev = -1;
    e->inited = 1;
    sbr_dsp_init();
}

static void sbr_chan_frame(SbrElem *e, SbrChan *c, const float *core,
                           float *out, int have,
                           const double (*e_orig)[SBR_MAXB],
                           const double (*q_orig)[SBR_MAXNQ]) {
    double Xre[NSLOT][32], Xim[NSLOT][32];
    memcpy(Xre, c->xh_re, sizeof(c->xh_re));
    memcpy(Xim, c->xh_im, sizeof(c->xh_im));
    for (int s = 0; s < SBR_SUB; s++)
        qmf_analysis_slot(c, core + s * 32, Xre[SBR_T_HFGEN + s],
                          Xim[SBR_T_HFGEN + s]);
    memcpy(c->xh_re, Xre[SBR_SUB], sizeof(c->xh_re));
    memcpy(c->xh_im, Xim[SBR_SUB], sizeof(c->xh_im));
    const int d0 = SBR_T_HFGEN - SBR_T_HFADJ;
    if (!have || !e->active) {
        /* upsample-only: 32-band passthrough with the same content
         * delay, so mixed data / no-data streams stay aligned */
        double zr[64], zi[64];
        memset(zr + 32, 0, 32 * sizeof(double));
        memset(zi + 32, 0, 32 * sizeof(double));
        for (int t = 0; t < SBR_SUB; t++) {
            memcpy(zr, Xre[d0 + t], 32 * sizeof(double));
            memcpy(zi, Xim[d0 + t], 32 * sizeof(double));
            qmf_synthesis_slot(c, zr, zi, out + t * 64);
        }
        return;
    }
    sbr_chirp(e, c);
    static double xh_re[SBR_SUB][64], xh_im[SBR_SUB][64];
    static double y_re[SBR_SUB][64], y_im[SBR_SUB][64];
    sbr_hf_generate(e, c, Xre, Xim, xh_re, xh_im);
    sbr_adjust(e, c, e_orig, q_orig, xh_re, xh_im, y_re, y_im);
    double zr[64], zi[64];
    for (int t = 0; t < SBR_SUB; t++) {
        for (int k = 0; k < e->kx; k++) {
            zr[k] = Xre[d0 + t][k];
            zi[k] = Xim[d0 + t][k];
        }
        for (int k = e->kx; k < 64; k++) {
            zr[k] = y_re[t][k];
            zi[k] = y_im[t][k];
        }
        qmf_synthesis_slot(c, zr, zi, out + t * 64);
    }
}

void sbr_process(SbrElem *e, int nch, const float *core0,
                 const float *core1, float *out0, float *out1) {
    sbr_dsp_init();
    static double e_orig[2][SBR_MAXENV][SBR_MAXB];
    static double q_orig[2][2][SBR_MAXNQ];
    if (e->active && (e->ch[0].have || e->ch[1].have))
        sbr_dequant(e, nch, e_orig, q_orig);
    sbr_chan_frame(e, &e->ch[0], core0, out0, e->ch[0].have,
                   e_orig[0], q_orig[0]);
    if (nch == 2 && core1 && out1)
        sbr_chan_frame(e, &e->ch[1], core1, out1, e->ch[1].have,
                       e_orig[1], q_orig[1]);
    e->ch[0].have = 0;
    e->ch[1].have = 0;
}
