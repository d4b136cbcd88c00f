/* sbrdec.h — SBR (Spectral Band Replication, ISO/IEC 14496-3
 * §4.6.18) decoder interface for the native HE-AAC path.
 *
 * Closes the reference's HE-AAC ingest gap natively (the reference
 * decodes .m4a/.aac through librosa -> audioread -> ffmpeg; reference
 * inference.py:136-138). The algorithm port follows the repo's own
 * Python reference chain scripts/sbr_ref.py + scripts/sbr_parse.py,
 * whose every convention was pinned BEHAVIORALLY against the system
 * libav decoder (tests/test_sbr.py); the constant tables come from
 * the probe-extraction rig via the generated sbr_tables.h.
 */
#ifndef SBRDEC_H
#define SBRDEC_H

#include <stddef.h>
#include <stdint.h>

#define SBR_T_HFGEN 8       /* QMF history slots kept for LPC/patching */
#define SBR_T_HFADJ 6       /* content delay vs the envelope timeline */
#define SBR_SLOTS 16        /* core time slots per frame */
#define SBR_RATE 2          /* QMF subsamples per core slot */
#define SBR_SUB (SBR_SLOTS * SBR_RATE)   /* 32 QMF subsamples/frame */
#define SBR_MAXB 64         /* band-table bound (m <= 49 in practice) */
#define SBR_MAXNQ 5
#define SBR_MAXENV 8

typedef struct {
    /* one channel's parsed sbr_data for the current frame; envelope
     * and noise scalefactors are ABSOLUTE (delta resolution applied
     * at parse time, like scripts/sbr_parse.py) */
    int frame_class, num_env, pointer;
    int freq_res[SBR_MAXENV];
    int var_bord_0, var_bord_1;
    int df_env[SBR_MAXENV], df_noise[3];
    int invf[SBR_MAXNQ];
    int env_sf[SBR_MAXENV][SBR_MAXB];
    int noise_sf[3][SBR_MAXNQ];
    int add_harm_flag;
    uint8_t add_harm[SBR_MAXB];
    int amp_used;
} SbrChData;

typedef struct {
    /* cross-frame parse state (delta-time references) */
    int env_prev[SBR_MAXB];
    int env_prev_res;
    int env_prev_valid;
    int noise_prev[SBR_MAXNQ];
    int noise_prev_valid;
    /* cross-frame DSP state (scripts/sbr_ref.py ChannelState) */
    double xh_re[SBR_T_HFGEN][32], xh_im[SBR_T_HFGEN][32];
    double bw[SBR_MAXNQ];
    int f_index_noise, f_index_sine;
    uint8_t s_prev[SBR_MAXB];
    int la_prev;
    /* QMF filterbank state */
    double ana_x[320];
    double syn_v[1280];
    /* this frame */
    SbrChData d;
    int have;
} SbrChan;

typedef struct {
    int inited;             /* sbr_elem_init ran */
    int active;             /* a header has been received */
    int fs_sbr;             /* output rate = 2x core rate */
    /* header fields */
    int amp_res, start_freq, stop_freq, xover_band;
    int freq_scale, alter_scale, noise_bands;
    int limiter_bands, limiter_gains, interpol_freq, smoothing_mode;
    /* derived band tables (§4.6.18.3) */
    int master[SBR_MAXB + 2], n_master;
    int high[SBR_MAXB + 2], n_high;
    int low[SBR_MAXB + 2], n_low;
    int noise_t[SBR_MAXNQ + 1], n_q;
    int lim[SBR_MAXB + 2], n_l;      /* kx-relative */
    int kx, m;
    int patch_n[8], patch_start[8], n_patches;
    int band_noise[SBR_MAXB];        /* noise band of QMF band kx+i */
    int coupling;                    /* this frame's bs_coupling */
    SbrChan ch[2];
} SbrElem;

/* initialize an element for a core sample rate (idempotent) */
void sbr_elem_init(SbrElem *e, int fs_core);

/* parse one sbr_extension_data payload (FIL extension types 0x0D /
 * 0x0E). data/bit_off/bit_len delimit the payload AFTER the 4
 * extension_type bits; crc=1 for type 0x0E (skips bs_sbr_crc_bits).
 * Returns 0 and marks per-channel `have` flags on success, <0 on a
 * malformed payload (caller should fail the stream). */
int sbr_parse_payload(SbrElem *e, const uint8_t *data, size_t bit_off,
                      size_t bit_len, int stereo, int crc);

/* process one element's frame: 1024 core samples per channel in,
 * 2048 upsampled samples per channel out. nch = 1 (SCE) or 2 (CPE).
 * Channels without parsed data this frame (or before any header)
 * upsample through the plain QMF chain. Resets the per-frame `have`
 * flags. */
void sbr_process(SbrElem *e, int nch, const float *core0,
                 const float *core1, float *out0, float *out1);

#endif /* SBRDEC_H */
