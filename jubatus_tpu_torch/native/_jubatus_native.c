/* Native host-layer hot paths.
 *
 * The reference's serving layer is C++ end to end; here the compute path
 * is CUDA kernels on the card and the host layer is Python with this C
 * extension under the hot loops:
 *
 *   fnv1a64(bytes) -> int          stable feature hashing (fv/hashing.py)
 *   crc32(bytes[, seed]) -> int    model-file checksum
 *                                  (reference common/crc32.cpp polynomial
 *                                  0xEDB88320 with pre/post inversion,
 *                                  chaining-compatible with zlib.crc32)
 *   hash_keys([bytes], dim) -> bytes
 *                                  batch feature hashing; native-endian
 *                                  int32 buffer for np.frombuffer (which
 *                                  also assumes native byte order)
 *   pack_rows(rows, k) -> (bytes, bytes)
 *                                  [(idx, val), ...] rows -> padded [B,K]
 *                                  int32 indices + float32 values buffers
 *                                  (the SparseBatch staging path that
 *                                  feeds device microbatches)
 *
 * Build: at first use, by jubatus_tpu_torch/native/__init__.py (cc -shared
 * -fPIC -O3 over this file and _fastconv.c into build/torch_native/)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ---- FNV-1a 64 ---------------------------------------------------------- */

static uint64_t fnv1a64_raw(const unsigned char* data, Py_ssize_t len) {
  uint64_t h = 0xCBF29CE484222325ULL;
  for (Py_ssize_t i = 0; i < len; ++i) {
    h ^= (uint64_t)data[i];
    h *= 0x100000001B3ULL;
  }
  return h;
}

static PyObject* py_fnv1a64(PyObject* self, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  uint64_t h = fnv1a64_raw((const unsigned char*)view.buf, view.len);
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLongLong(h);
}

/* ---- CRC32 (IEEE, zlib-chaining compatible) ----------------------------- */

static uint32_t crc_table[256];
static int crc_table_ready = 0;

static void crc_init(void) {
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? (0xEDB88320U ^ (c >> 1)) : (c >> 1);
    crc_table[n] = c;
  }
  crc_table_ready = 1;
}

static PyObject* py_crc32(PyObject* self, PyObject* args) {
  Py_buffer view;
  unsigned long seed = 0;
  if (!PyArg_ParseTuple(args, "y*|k", &view, &seed)) return NULL;
  if (!crc_table_ready) crc_init();
  uint32_t c = (uint32_t)seed ^ 0xFFFFFFFFU;
  const unsigned char* p = (const unsigned char*)view.buf;
  for (Py_ssize_t i = 0; i < view.len; ++i)
    c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLong(c ^ 0xFFFFFFFFU);
}

/* ---- batch key hashing --------------------------------------------------- */

static PyObject* py_hash_keys(PyObject* self, PyObject* args) {
  PyObject* seq;
  unsigned long dim;
  if (!PyArg_ParseTuple(args, "Ok", &seq, &dim)) return NULL;
  if (dim == 0 || (dim & (dim - 1)) != 0) {
    PyErr_SetString(PyExc_ValueError, "dim must be a power of two");
    return NULL;
  }
  PyObject* fast = PySequence_Fast(seq, "hash_keys expects a sequence");
  if (fast == NULL) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* out = PyBytes_FromStringAndSize(NULL, n * 4);
  if (out == NULL) { Py_DECREF(fast); return NULL; }
  int32_t* dst = (int32_t*)PyBytes_AS_STRING(out);
  uint64_t mask = (uint64_t)dim - 1;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    Py_buffer view;
    if (PyObject_GetBuffer(item, &view, PyBUF_SIMPLE) < 0) {
      Py_DECREF(fast);
      Py_DECREF(out);
      return NULL;
    }
    dst[i] = (int32_t)(fnv1a64_raw((const unsigned char*)view.buf, view.len)
                       & mask);
    PyBuffer_Release(&view);
  }
  Py_DECREF(fast);
  return out;
}

/* ---- padded row packing -------------------------------------------------- */

static PyObject* py_pack_rows(PyObject* self, PyObject* args) {
  PyObject* rows;
  Py_ssize_t k;
  if (!PyArg_ParseTuple(args, "On", &rows, &k)) return NULL;
  if (k <= 0) {
    PyErr_SetString(PyExc_ValueError, "k must be positive");
    return NULL;
  }
  PyObject* fast = PySequence_Fast(rows, "pack_rows expects a sequence");
  if (fast == NULL) return NULL;
  Py_ssize_t b = PySequence_Fast_GET_SIZE(fast);
  Py_ssize_t bb = b > 0 ? b : 1;
  PyObject* idx_out = PyBytes_FromStringAndSize(NULL, bb * k * 4);
  PyObject* val_out = PyBytes_FromStringAndSize(NULL, bb * k * 4);
  if (idx_out == NULL || val_out == NULL) {
    Py_XDECREF(idx_out); Py_XDECREF(val_out); Py_DECREF(fast);
    return NULL;
  }
  int32_t* idx = (int32_t*)PyBytes_AS_STRING(idx_out);
  float* val = (float*)PyBytes_AS_STRING(val_out);
  memset(idx, 0, bb * k * 4);
  memset(val, 0, bb * k * 4);
  for (Py_ssize_t i = 0; i < b; ++i) {
    PyObject* row = PySequence_Fast_GET_ITEM(fast, i);
    if (PyDict_Check(row)) {
      /* {index: value} rows (the SparseBatch.from_rows shape) — iterate
       * the dict in place, no intermediate tuple list */
      Py_ssize_t pos = 0;
      Py_ssize_t j = 0;
      PyObject *pk, *pv;
      while (PyDict_Next(row, &pos, &pk, &pv) && j < k) {
        long ival = PyLong_AsLong(pk);
        double fval = PyFloat_AsDouble(pv);
        if ((ival == -1 || fval == -1.0) && PyErr_Occurred()) goto fail;
        idx[i * k + j] = (int32_t)ival;
        val[i * k + j] = (float)fval;
        ++j;
      }
      continue;
    }
    PyObject* rfast = PySequence_Fast(row, "row must be a dict or sequence");
    if (rfast == NULL) goto fail;
    Py_ssize_t rn = PySequence_Fast_GET_SIZE(rfast);
    if (rn > k) rn = k;  /* truncate overly long rows to the pad width */
    for (Py_ssize_t j = 0; j < rn; ++j) {
      PyObject* pair = PySequence_Fast_GET_ITEM(rfast, j);
      PyObject* pfast = PySequence_Fast(pair, "entry must be (index, value)");
      if (pfast == NULL || PySequence_Fast_GET_SIZE(pfast) != 2) {
        Py_XDECREF(pfast);
        Py_DECREF(rfast);
        PyErr_SetString(PyExc_ValueError, "entry must be (index, value)");
        goto fail;
      }
      long ival = PyLong_AsLong(PySequence_Fast_GET_ITEM(pfast, 0));
      double fval = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(pfast, 1));
      Py_DECREF(pfast);
      if ((ival == -1 || fval == -1.0) && PyErr_Occurred()) {
        Py_DECREF(rfast);
        goto fail;
      }
      idx[i * k + j] = (int32_t)ival;
      val[i * k + j] = (float)fval;
    }
    Py_DECREF(rfast);
  }
  Py_DECREF(fast);
  return Py_BuildValue("(NN)", idx_out, val_out);
fail:
  Py_DECREF(fast);
  Py_DECREF(idx_out);
  Py_DECREF(val_out);
  return NULL;
}

/* ---- module -------------------------------------------------------------- */

static PyMethodDef methods[] = {
  {"fnv1a64", py_fnv1a64, METH_O,
   "fnv1a64(data) -> int: FNV-1a 64-bit hash of a bytes-like object."},
  {"crc32", py_crc32, METH_VARARGS,
   "crc32(data[, seed]) -> int: IEEE CRC-32, zlib-chaining compatible."},
  {"hash_keys", py_hash_keys, METH_VARARGS,
   "hash_keys(keys, dim) -> bytes: int32-LE buffer of fnv1a64(key) & (dim-1)."},
  {"pack_rows", py_pack_rows, METH_VARARGS,
   "pack_rows(rows, k) -> (idx_bytes, val_bytes): padded [B,K] buffers."},
  {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
  PyModuleDef_HEAD_INIT, "_jubatus_native",
  "Native host-layer hot paths (hashing, checksum, batch packing).",
  -1, methods,
};

/* in _fastconv.c: FastConverter type + parse_envelope */
extern int fastconv_register(PyObject* module);

PyMODINIT_FUNC PyInit__jubatus_native(void) {
  crc_init();
  PyObject* m = PyModule_Create(&module);
  if (m == NULL) return NULL;
  if (fastconv_register(m) < 0) {
    Py_DECREF(m);
    return NULL;
  }
  return m;
}
