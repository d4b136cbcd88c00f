/* Host data-path kernels of the port's native extension
 * (`_vrtnative_torch`, module table in decoders.c):
 *
 *   load_crop_abs(path, start_row, n_rows, coef) -> (bytes, F)
 *       chunked .npy read of complex64 rows laid out (T, 2, F), fused
 *       |z| / coef, written in the model's (C, F, T) layout as float32
 *       (the training crops' magnitudes; a malformed file or layout
 *       raises ValueError).
 *   pcm16_encode(float32 buffer) -> int16 bytes
 *       clip to [-1, 1-1/32768], scale by 32768, round half to even
 *       (the PCM_16 WAV conversion).
 *   pcm16_decode(int16 buffer) -> float32 bytes (x / 32768).
 *   quantize_u8(float32 buffer) -> (uint8 bytes, scale)
 *       255 at the buffer's largest value; int8 batch staging.
 *
 * The same code as the JAX package's native/vrtnative.c, compiled with
 * the same flags (build.py), so both give the same bits: the magnitudes
 * are sqrtf(re * re + im * im) * (float)(1 / coef), which is not always
 * numpy's |z| / coef (a few ulp apart in a third to a half of the
 * values). The GIL is released around each loop, so loader threads
 * overlap their reads.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* minimal .npy header parsing (format 1.0/2.0, C-order only)          */
/* ------------------------------------------------------------------ */

typedef struct {
    long shape[4];
    int ndim;
    int is_complex64;
    long header_end; /* file offset where data begins */
} NpyInfo;

static int parse_npy_header(FILE *f, NpyInfo *info) {
    unsigned char magic[8];
    if (fread(magic, 1, 8, f) != 8) return -1;
    if (memcmp(magic, "\x93NUMPY", 6) != 0) return -1;
    int major = magic[6];
    unsigned int hlen;
    if (major == 1) {
        unsigned char b[2];
        if (fread(b, 1, 2, f) != 2) return -1;
        hlen = b[0] | (b[1] << 8);
        info->header_end = 10 + hlen;
    } else {
        unsigned char b[4];
        if (fread(b, 1, 4, f) != 4) return -1;
        hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((unsigned)b[3] << 24);
        info->header_end = 12 + hlen;
    }
    char *hdr = (char *)malloc(hlen + 1);
    if (!hdr) return -1;
    if (fread(hdr, 1, hlen, f) != hlen) { free(hdr); return -1; }
    hdr[hlen] = 0;

    info->is_complex64 = strstr(hdr, "<c8") != NULL;
    if (strstr(hdr, "'fortran_order': True")) { free(hdr); return -1; }

    char *sh = strstr(hdr, "'shape':");
    if (!sh) { free(hdr); return -1; }
    sh = strchr(sh, '(');
    if (!sh) { free(hdr); return -1; }
    sh++;
    info->ndim = 0;
    while (*sh && *sh != ')' && info->ndim < 4) {
        while (*sh == ' ' || *sh == ',') sh++;
        if (*sh == ')') break;
        info->shape[info->ndim++] = strtol(sh, &sh, 10);
    }
    free(hdr);
    return 0;
}

/* load_crop_abs(path, start_row, n_rows, coef) -> bytes-backed object:
 * returns a new Python bytes of (2 * F * n_rows) float32 in (C, F, T)
 * order plus the F dimension, as a tuple (data_bytes, F). The Python
 * wrapper wraps it in a numpy array without copying. */
PyObject *vrt_load_crop_abs(PyObject *self, PyObject *args) {
    const char *path;
    long start_row, n_rows;
    double coef;
    if (!PyArg_ParseTuple(args, "slld", &path, &start_row, &n_rows, &coef))
        return NULL;

    NpyInfo info;
    float *out = NULL;
    float *rowbuf = NULL;
    long F = 0;

    Py_BEGIN_ALLOW_THREADS;
    FILE *f = fopen(path, "rb");
    if (f && parse_npy_header(f, &info) == 0 && info.ndim == 3 &&
        info.is_complex64 && info.shape[1] == 2) {
        F = info.shape[2];
        long row_elems = 2 * F;                /* complex64 per row */
        long row_bytes = row_elems * 8;
        if (fseek(f, info.header_end + start_row * row_bytes, SEEK_SET) == 0) {
            out = (float *)malloc(sizeof(float) * 2 * F * n_rows);
            rowbuf = (float *)malloc((size_t)row_bytes);
            if (out && rowbuf) {
                float inv = (float)(1.0 / coef);
                for (long t = 0; t < n_rows; t++) {
                    if (fread(rowbuf, 1, (size_t)row_bytes, f) !=
                        (size_t)row_bytes) {
                        free(out);
                        out = NULL;
                        break;
                    }
                    /* rowbuf: [c][f] complex64 -> out[c][f][t] = |z|*inv */
                    for (long c = 0; c < 2; c++) {
                        const float *src = rowbuf + c * F * 2;
                        float *dst = out + (c * F) * n_rows + t;
                        for (long ff = 0; ff < F; ff++) {
                            float re = src[2 * ff];
                            float im = src[2 * ff + 1];
                            dst[ff * n_rows] = sqrtf(re * re + im * im) * inv;
                        }
                    }
                }
            } else {
                free(out);
                out = NULL;
            }
        }
    }
    if (rowbuf) free(rowbuf);
    if (f) fclose(f);
    Py_END_ALLOW_THREADS;

    if (!out) {
        PyErr_SetString(PyExc_ValueError,
                        "load_crop_abs: bad npy file/layout (need C-order "
                        "(T, 2, F) complex64)");
        return NULL;
    }
    PyObject *data = PyBytes_FromStringAndSize((char *)out,
                                               sizeof(float) * 2 * F * n_rows);
    free(out);
    if (!data) return NULL;
    PyObject *ret = Py_BuildValue("(Nl)", data, F);
    return ret;
}

/* pcm16_encode(buffer of float32) -> bytes of int16 */
PyObject *vrt_pcm16_encode(PyObject *self, PyObject *args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return NULL;
    Py_ssize_t n = buf.len / (Py_ssize_t)sizeof(float);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n * 2);
    if (!out) { PyBuffer_Release(&buf); return NULL; }
    const float *src = (const float *)buf.buf;
    int16_t *dst = (int16_t *)PyBytes_AS_STRING(out);
    Py_BEGIN_ALLOW_THREADS;
    /* magic-number rounding: adding 1.5*2^23 forces the mantissa to
     * round-half-to-even at integer granularity (values are within
     * +-32768, far below 2^23) — identical to numpy's np.round and
     * fully SIMD-vectorizable, unlike lrintf. */
    const float MAGIC = 12582912.0f; /* 1.5 * 2^23 */
    for (Py_ssize_t i = 0; i < n; i++) {
        float v = src[i];
        if (v > 1.0f - 1.0f / 32768.0f) v = 1.0f - 1.0f / 32768.0f;
        if (v < -1.0f) v = -1.0f;
        float s = v * 32768.0f;
        dst[i] = (int16_t)((s + MAGIC) - MAGIC);
    }
    Py_END_ALLOW_THREADS;
    PyBuffer_Release(&buf);
    return out;
}

/* pcm16_decode(buffer of int16) -> bytes of float32 */
PyObject *vrt_pcm16_decode(PyObject *self, PyObject *args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return NULL;
    Py_ssize_t n = buf.len / (Py_ssize_t)sizeof(int16_t);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n * 4);
    if (!out) { PyBuffer_Release(&buf); return NULL; }
    const int16_t *src = (const int16_t *)buf.buf;
    float *dst = (float *)PyBytes_AS_STRING(out);
    Py_BEGIN_ALLOW_THREADS;
    for (Py_ssize_t i = 0; i < n; i++) {
        dst[i] = (float)src[i] / 32768.0f;
    }
    Py_END_ALLOW_THREADS;
    PyBuffer_Release(&buf);
    return out;
}

/* quantize_u8(buffer of float32) -> (bytes of uint8, scale)
 * Fused max-reduce + clip/scale/round in two streaming passes —
 * replaces four numpy passes on the int8 batch-staging path. */
PyObject *vrt_quantize_u8(PyObject *self, PyObject *args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return NULL;
    Py_ssize_t n = buf.len / (Py_ssize_t)sizeof(float);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n);
    if (!out) { PyBuffer_Release(&buf); return NULL; }
    const float *src = (const float *)buf.buf;
    uint8_t *dst = (uint8_t *)PyBytes_AS_STRING(out);
    float hi = 0.0f;
    Py_BEGIN_ALLOW_THREADS;
    for (Py_ssize_t i = 0; i < n; i++)
        if (src[i] > hi) hi = src[i];
    const float scale = hi > 0.0f ? hi / 255.0f : 1.0f;
    const float inv = 1.0f / scale;
    const float MAGIC = 12582912.0f; /* round-half-to-even, see above */
    for (Py_ssize_t i = 0; i < n; i++) {
        float s = src[i] * inv;
        /* !(s > 0) also catches NaN, which would otherwise fail both
         * clamp comparisons and hit the magic-number cast undefined */
        if (!(s > 0.0f)) s = 0.0f;
        if (s > 255.0f) s = 255.0f;
        dst[i] = (uint8_t)((s + MAGIC) - MAGIC);
    }
    Py_END_ALLOW_THREADS;
    float hi_out = hi > 0.0f ? hi / 255.0f : 1.0f;
    return Py_BuildValue("(Nf)", out, (double)hi_out);
}
