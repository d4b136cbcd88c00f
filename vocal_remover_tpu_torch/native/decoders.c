/* _vrtnative_torch: the port's native audio decoders and host data-path
 * kernels as one extension module.
 *
 *   flac_decode(bytes) -> (int32 pcm bytes, n, channels, sr, bps)
 *   mp3_decode(bytes)  -> (float32 pcm bytes, n, channels, sr)
 *   aac_decode(bytes)  -> (float32 pcm bytes, n, channels, sr)
 *   load_crop_abs, pcm16_encode, pcm16_decode, quantize_u8 (host.c)
 *
 * The decoders (flacdec.c, mp3dec.c, aacdec.c + sbrdec.c) are byte-for-
 * byte copies of the JAX package's, so both decode every stream to the
 * same samples; a malformed stream raises ValueError. host.c holds the
 * JAX package's vrtnative.c kernels, for the same bits. The module has its
 * own name, so one process can load it beside the JAX package's
 * `_vrtnative`. Built by build.py.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

/* flacdec.c */
extern PyObject *vrt_flac_decode(PyObject *self, PyObject *args);
/* mp3dec.c */
extern PyObject *vrt_mp3_decode(PyObject *self, PyObject *args);
/* aacdec.c */
extern PyObject *vrt_aac_decode(PyObject *self, PyObject *args);
/* host.c */
extern PyObject *vrt_load_crop_abs(PyObject *self, PyObject *args);
extern PyObject *vrt_pcm16_encode(PyObject *self, PyObject *args);
extern PyObject *vrt_pcm16_decode(PyObject *self, PyObject *args);
extern PyObject *vrt_quantize_u8(PyObject *self, PyObject *args);

static PyMethodDef Methods[] = {
    {"flac_decode", vrt_flac_decode, METH_VARARGS,
     "FLAC stream bytes -> (int32 pcm bytes, n, channels, sr, bps)"},
    {"mp3_decode", vrt_mp3_decode, METH_VARARGS,
     "MP3 stream bytes -> (float32 pcm bytes, n, channels, sr)"},
    {"aac_decode", vrt_aac_decode, METH_VARARGS,
     "AAC-LC / HE-AAC ADTS or MP4 bytes -> (float32 pcm bytes, n, "
     "channels, sr)"},
    {"load_crop_abs", vrt_load_crop_abs, METH_VARARGS,
     "fused npy chunk read + |complex|/coef in (C, F, T) layout"},
    {"pcm16_encode", vrt_pcm16_encode, METH_VARARGS,
     "float32 buffer -> int16 PCM bytes (clip+scale+round)"},
    {"pcm16_decode", vrt_pcm16_decode, METH_VARARGS,
     "int16 PCM buffer -> float32 bytes"},
    {"quantize_u8", vrt_quantize_u8, METH_VARARGS,
     "float32 buffer -> (uint8 bytes, scale): fused max+clip+round"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_vrtnative_torch", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__vrtnative_torch(void) {
    return PyModule_Create(&moduledef);
}
