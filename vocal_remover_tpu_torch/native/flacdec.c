/* Native FLAC decoder (subset sufficient for audio ingest).
 *
 * The reference ingests `.flac` (and other containers) through
 * librosa/audioread (reference lib/dataset.py:147-152 lists the
 * extensions, inference.py:136-138 decodes). Neither librosa nor an
 * ffmpeg binary exists in this environment, so the framework decodes
 * FLAC natively: full support for CONSTANT / VERBATIM / FIXED / LPC
 * subframes, Rice + Rice2 + escaped-raw residual partitions,
 * independent / left-side / right-side / mid-side channel layouts,
 * wasted bits, and variable block sizes. CRCs are parsed but not
 * verified (ingest favors robustness; a corrupt stream fails shape
 * checks downstream).
 *
 * Exposed through _vrtnative.flac_decode(bytes) ->
 *   (int32 ndarray (n_samples, channels), sample_rate, bits_per_sample)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------------- bit reader ---------------- */

typedef struct {
    const uint8_t *buf;
    Py_ssize_t len;   /* bytes */
    Py_ssize_t pos;   /* byte position */
    int bit;          /* bit position within buf[pos], 0 = MSB */
    int error;
} BitReader;

static void br_init(BitReader *br, const uint8_t *buf, Py_ssize_t len) {
    br->buf = buf; br->len = len; br->pos = 0; br->bit = 0; br->error = 0;
}

static int br_eof(const BitReader *br) { return br->pos >= br->len; }

static uint32_t br_bit(BitReader *br) {
    if (br->pos >= br->len) { br->error = 1; return 0; }
    uint32_t v = (br->buf[br->pos] >> (7 - br->bit)) & 1u;
    if (++br->bit == 8) { br->bit = 0; br->pos++; }
    return v;
}

static uint64_t br_bits(BitReader *br, int n) {
    uint64_t v = 0;
    /* fast byte-aligned path */
    while (n >= 8 && br->bit == 0 && br->pos < br->len) {
        v = (v << 8) | br->buf[br->pos++];
        n -= 8;
    }
    while (n-- > 0) v = (v << 1) | br_bit(br);
    return v;
}

static int64_t br_sbits(BitReader *br, int n) {
    uint64_t v = br_bits(br, n);
    if (n > 0 && (v >> (n - 1)) & 1u)
        v |= ~((1ull << n) - 1);   /* sign extend */
    return (int64_t)v;
}

static uint32_t br_unary(BitReader *br) {
    uint32_t q = 0;
    while (!br->error) {
        if (br_bit(br)) return q;
        q++;
        if (q > 1u << 24) { br->error = 1; return 0; }  /* corrupt */
    }
    return 0;
}

static void br_align(BitReader *br) {
    if (br->bit) { br->bit = 0; br->pos++; }
}

/* ---------------- FLAC structures ---------------- */

typedef struct {
    uint32_t sample_rate;
    int channels;
    int bps;
    uint64_t total_samples;
    uint32_t max_blocksize;
} StreamInfo;

/* decode one residual-coded sequence into out[order..blocksize) */
static int decode_residual(BitReader *br, int32_t *out, int blocksize,
                           int order) {
    uint32_t method = (uint32_t)br_bits(br, 2);
    if (method > 1) return -1;
    int plen = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 0xF : 0x1F;
    uint32_t partorder = (uint32_t)br_bits(br, 4);
    uint32_t nparts = 1u << partorder;
    if (blocksize % (int)nparts != 0) return -1;
    int psamples = blocksize >> partorder;
    int idx = order;
    for (uint32_t p = 0; p < nparts; p++) {
        int count = psamples - (p == 0 ? order : 0);
        if (count < 0) return -1;
        uint32_t param = (uint32_t)br_bits(br, plen);
        if (param == escape) {
            int raw = (int)br_bits(br, 5);
            for (int i = 0; i < count; i++)
                out[idx++] = (int32_t)(raw ? br_sbits(br, raw) : 0);
        } else {
            for (int i = 0; i < count; i++) {
                uint32_t q = br_unary(br);
                uint64_t r = param ? br_bits(br, param) : 0;
                uint64_t u = ((uint64_t)q << param) | r;
                out[idx++] = (int32_t)((u >> 1) ^ (~(u & 1) + 1));
            }
        }
        if (br->error) return -1;
    }
    return 0;
}

static const int FIXED_ORDER_COEFS[5][4] = {
    {0, 0, 0, 0},
    {1, 0, 0, 0},
    {2, -1, 0, 0},
    {3, -3, 1, 0},
    {4, -6, 4, -1},
};

/* decode one subframe into out[0..blocksize) */
static int decode_subframe(BitReader *br, int32_t *out, int blocksize,
                           int bps) {
    if (br_bits(br, 1) != 0) return -1;          /* padding bit */
    uint32_t type = (uint32_t)br_bits(br, 6);
    int wasted = 0;
    if (br_bits(br, 1)) {                        /* wasted bits flag */
        wasted = 1 + (int)br_unary(br);
        bps -= wasted;
        if (bps <= 0) return -1;
    }

    if (type == 0) {                             /* CONSTANT */
        int32_t v = (int32_t)br_sbits(br, bps);
        for (int i = 0; i < blocksize; i++) out[i] = v;
    } else if (type == 1) {                      /* VERBATIM */
        for (int i = 0; i < blocksize; i++)
            out[i] = (int32_t)br_sbits(br, bps);
    } else if (type >= 8 && type <= 12) {        /* FIXED order 0-4 */
        int order = (int)type - 8;
        if (order > blocksize) return -1;
        for (int i = 0; i < order; i++)
            out[i] = (int32_t)br_sbits(br, bps);
        if (decode_residual(br, out, blocksize, order) != 0) return -1;
        const int *c = FIXED_ORDER_COEFS[order];
        for (int i = order; i < blocksize; i++) {
            int64_t pred = 0;
            for (int j = 0; j < order; j++)
                pred += (int64_t)c[j] * out[i - 1 - j];
            out[i] += (int32_t)pred;
        }
    } else if (type >= 32) {                     /* LPC order 1-32 */
        int order = (int)type - 31;
        if (order > blocksize) return -1;
        for (int i = 0; i < order; i++)
            out[i] = (int32_t)br_sbits(br, bps);
        int precision = (int)br_bits(br, 4) + 1;
        if (precision == 16) return -1;          /* 0b1111 is invalid */
        int shift = (int)br_sbits(br, 5);
        if (shift < 0) return -1;
        int32_t coef[32];
        for (int j = 0; j < order; j++)
            coef[j] = (int32_t)br_sbits(br, precision);
        if (decode_residual(br, out, blocksize, order) != 0) return -1;
        for (int i = order; i < blocksize; i++) {
            int64_t pred = 0;
            for (int j = 0; j < order; j++)
                pred += (int64_t)coef[j] * out[i - 1 - j];
            out[i] += (int32_t)(pred >> shift);
        }
    } else {
        return -1;                               /* reserved */
    }

    if (wasted)
        for (int i = 0; i < blocksize; i++)
            out[i] = (int32_t)((uint32_t)out[i] << wasted);
    if (br->error) return -1;
    return 0;
}

/* parse the UTF-8-style coded frame/sample number (1-7 bytes); value
 * itself is unused (we decode sequentially) */
static int skip_utf8(BitReader *br) {
    uint32_t b0 = (uint32_t)br_bits(br, 8);
    int extra;
    if (b0 < 0x80) extra = 0;
    else if ((b0 & 0xE0) == 0xC0) extra = 1;
    else if ((b0 & 0xF0) == 0xE0) extra = 2;
    else if ((b0 & 0xF8) == 0xF0) extra = 3;
    else if ((b0 & 0xFC) == 0xF8) extra = 4;
    else if ((b0 & 0xFE) == 0xFC) extra = 5;
    else if (b0 == 0xFE) extra = 6;
    else return -1;
    for (int i = 0; i < extra; i++) {
        if ((br_bits(br, 8) & 0xC0) != 0x80) return -1;
    }
    return br->error ? -1 : 0;
}

static const uint32_t BLOCKSIZE_TABLE[16] = {
    0, 192, 576, 1152, 2304, 4608, 0, 0,
    256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
};

/* decode one frame; appends into pcm (n_alloc capacity). Returns
 * blocksize or -1. */
static int decode_frame(BitReader *br, const StreamInfo *si, int32_t *pcm,
                        uint64_t written, uint64_t capacity) {
    /* sync: 11111111 111110xx */
    uint32_t sync = (uint32_t)br_bits(br, 14);
    if (sync != 0x3FFE) return -1;
    br_bits(br, 1);                               /* reserved */
    br_bits(br, 1);                               /* blocking strategy */
    uint32_t bs_code = (uint32_t)br_bits(br, 4);
    uint32_t sr_code = (uint32_t)br_bits(br, 4);
    uint32_t ch_code = (uint32_t)br_bits(br, 4);
    uint32_t ss_code = (uint32_t)br_bits(br, 3);
    br_bits(br, 1);                               /* reserved */
    if (skip_utf8(br) != 0) return -1;

    uint32_t blocksize;
    if (bs_code == 6) blocksize = (uint32_t)br_bits(br, 8) + 1;
    else if (bs_code == 7) blocksize = (uint32_t)br_bits(br, 16) + 1;
    else blocksize = BLOCKSIZE_TABLE[bs_code];
    if (blocksize == 0) return -1;

    if (sr_code == 12) br_bits(br, 8);            /* kHz */
    else if (sr_code == 13 || sr_code == 14) br_bits(br, 16);

    int bps = si->bps;
    switch (ss_code) {
        case 0: break;                            /* from STREAMINFO */
        case 1: bps = 8; break;
        case 2: bps = 12; break;
        case 4: bps = 16; break;
        case 5: bps = 20; break;
        case 6: bps = 24; break;
        case 7: bps = 32; break;
        default: return -1;
    }
    br_bits(br, 8);                               /* header CRC-8 */
    if (br->error) return -1;

    int channels = si->channels;
    int32_t *tmp[8];
    /* Static scratch is safe ONLY because flac_decode never releases
     * the GIL: do not add Py_BEGIN_ALLOW_THREADS around the decode
     * loop without making this per-call (threaded Loader callers would
     * corrupt each other's blocks). */
    static int32_t *scratch = NULL;
    static uint64_t scratch_cap = 0;
    uint64_t need = (uint64_t)blocksize * channels;
    if (need > scratch_cap) {
        int32_t *ns = (int32_t *)realloc(scratch, need * sizeof(int32_t));
        if (!ns) return -1;
        scratch = ns; scratch_cap = need;
    }
    for (int c = 0; c < channels; c++) tmp[c] = scratch + (uint64_t)c * blocksize;

    if (ch_code <= 7) {
        if (ch_code + 1 != (uint32_t)channels) return -1;
        for (int c = 0; c < channels; c++)
            if (decode_subframe(br, tmp[c], (int)blocksize, bps) != 0)
                return -1;
    } else if (ch_code >= 8 && ch_code <= 10) {
        if (channels != 2) return -1;
        int bps0 = bps + (ch_code == 9 ? 1 : 0);  /* side first? */
        int bps1 = bps + (ch_code == 9 ? 0 : 1);
        /* left/side (8): ch1 is side (+1 bit); right/side (9): ch0 is
         * side; mid/side (10): ch1 is side */
        if (ch_code == 8 || ch_code == 10) { bps0 = bps; bps1 = bps + 1; }
        else { bps0 = bps + 1; bps1 = bps; }
        if (decode_subframe(br, tmp[0], (int)blocksize, bps0) != 0) return -1;
        if (decode_subframe(br, tmp[1], (int)blocksize, bps1) != 0) return -1;
        if (ch_code == 8) {                       /* left/side */
            for (uint32_t i = 0; i < blocksize; i++)
                tmp[1][i] = tmp[0][i] - tmp[1][i];
        } else if (ch_code == 9) {                /* right/side */
            for (uint32_t i = 0; i < blocksize; i++)
                tmp[0][i] = tmp[1][i] + tmp[0][i];
        } else {                                  /* mid/side */
            for (uint32_t i = 0; i < blocksize; i++) {
                int64_t side = tmp[1][i];
                int64_t mid = ((int64_t)tmp[0][i] << 1) | (side & 1);
                tmp[0][i] = (int32_t)((mid + side) >> 1);
                tmp[1][i] = (int32_t)((mid - side) >> 1);
            }
        }
    } else {
        return -1;
    }

    br_align(br);
    br_bits(br, 16);                              /* frame CRC-16 */
    if (br->error) return -1;

    /* interleave into output, clipping to capacity */
    uint64_t n = blocksize;
    if (written + n > capacity) n = capacity - written;
    for (uint64_t i = 0; i < n; i++)
        for (int c = 0; c < channels; c++)
            pcm[(written + i) * channels + c] = tmp[c][i];
    return (int)blocksize;
}

/* Exported: flac_decode(bytes) ->
 *   (pcm_bytes, n_samples, channels, sample_rate, bps)
 * pcm_bytes holds interleaved little-endian int32 samples; the Python
 * wrapper turns it into an (n, ch) ndarray with np.frombuffer (same
 * zero-numpy-dependency pattern as the other entry points here). */
PyObject *vrt_flac_decode(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    const uint8_t *buf = (const uint8_t *)view.buf;
    Py_ssize_t len = view.len;

    if (len < 42 || memcmp(buf, "fLaC", 4) != 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "not a FLAC stream");
        return NULL;
    }

    BitReader br;
    br_init(&br, buf, len);
    br.pos = 4;

    StreamInfo si;
    memset(&si, 0, sizeof si);
    int last = 0, have_si = 0;
    while (!last && !br_eof(&br)) {
        uint32_t hdr = (uint32_t)br_bits(&br, 8);
        last = (hdr >> 7) & 1;
        uint32_t type = hdr & 0x7F;
        uint32_t blen = (uint32_t)br_bits(&br, 24);
        if (type == 0) {                          /* STREAMINFO */
            br_bits(&br, 16); br_bits(&br, 16);   /* min/max blocksize */
            br_bits(&br, 24); br_bits(&br, 24);   /* min/max framesize */
            si.sample_rate = (uint32_t)br_bits(&br, 20);
            si.channels = (int)br_bits(&br, 3) + 1;
            si.bps = (int)br_bits(&br, 5) + 1;
            si.total_samples = br_bits(&br, 36);
            for (int i = 0; i < 16; i++) br_bits(&br, 8);  /* MD5 */
            have_si = 1;
        } else {
            br.pos += blen;                       /* skip */
        }
        if (br.error || br.pos > br.len) break;
    }
    if (!have_si || si.sample_rate == 0 || si.channels < 1 ||
        si.channels > 8 || si.bps < 4 || si.bps > 32) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "bad or missing STREAMINFO");
        return NULL;
    }

    uint64_t capacity = si.total_samples;
    int grow = (capacity == 0);
    if (grow) {
        /* unknown length: start from a stream-size estimate and grow on
         * demand below — CONSTANT subframes pack 65536 samples into a
         * few bytes, so no static heuristic bounds the output */
        capacity = (uint64_t)(len - br.pos) * 8u / si.channels + 65536;
    }

    PyObject *bytes_obj = PyBytes_FromStringAndSize(
        NULL, (Py_ssize_t)(capacity * si.channels * sizeof(int32_t)));
    if (!bytes_obj) { PyBuffer_Release(&view); return NULL; }
    int32_t *pcm = (int32_t *)PyBytes_AS_STRING(bytes_obj);

    uint64_t written = 0;
    while (!br_eof(&br)) {
        if (written + 65536 > capacity) {   /* 65536 = max FLAC blocksize */
            if (!grow) {
                if (written >= capacity) break;
            } else {
                uint64_t newcap = capacity * 2 + 65536;
                if (_PyBytes_Resize(
                        &bytes_obj,
                        (Py_ssize_t)(newcap * si.channels *
                                     sizeof(int32_t))) != 0) {
                    PyBuffer_Release(&view);
                    return NULL;
                }
                pcm = (int32_t *)PyBytes_AS_STRING(bytes_obj);
                capacity = newcap;
            }
        }
        int got = decode_frame(&br, &si, pcm, written, capacity);
        if (got < 0) break;
        written += (uint64_t)got;
        if (written > capacity) written = capacity;
    }

    PyBuffer_Release(&view);

    if (written == 0) {
        Py_DECREF(bytes_obj);
        PyErr_SetString(PyExc_ValueError, "no decodable FLAC frames");
        return NULL;
    }

    if (written < capacity &&
        _PyBytes_Resize(&bytes_obj,
                        (Py_ssize_t)(written * si.channels *
                                     sizeof(int32_t))) != 0)
        return NULL;

    return Py_BuildValue("NKiii", bytes_obj, (unsigned long long)written,
                         si.channels, (int)si.sample_rate, si.bps);
}
