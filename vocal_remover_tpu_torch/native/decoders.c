/* _vrtnative_torch: the port's native audio decoders as one extension
 * module.
 *
 *   flac_decode(bytes) -> (int32 pcm bytes, n, channels, sr, bps)
 *   mp3_decode(bytes)  -> (float32 pcm bytes, n, channels, sr)
 *   aac_decode(bytes)  -> (float32 pcm bytes, n, channels, sr)
 *
 * The decoders (flacdec.c, mp3dec.c, aacdec.c + sbrdec.c) are byte-for-
 * byte copies of the JAX package's, so both decode every stream to the
 * same samples; a malformed stream raises ValueError. The module has its
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

static PyMethodDef Methods[] = {
    {"flac_decode", vrt_flac_decode, METH_VARARGS,
     "FLAC stream bytes -> (int32 pcm bytes, n, channels, sr, bps)"},
    {"mp3_decode", vrt_mp3_decode, METH_VARARGS,
     "MP3 stream bytes -> (float32 pcm bytes, n, channels, sr)"},
    {"aac_decode", vrt_aac_decode, METH_VARARGS,
     "AAC-LC / HE-AAC ADTS or MP4 bytes -> (float32 pcm bytes, n, "
     "channels, sr)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_vrtnative_torch", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__vrtnative_torch(void) {
    return PyModule_Create(&moduledef);
}
