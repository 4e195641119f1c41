/* Fast wire-to-device conversion: raw msgpack-RPC train/classify payloads
 * straight to padded [B,K] index/value buffers, no per-datum Python.
 *
 * This is the native replacement for the serving ingest hot loop the
 * reference runs in C++ (per-datum fv_convert called from
 * jubatus/server/server/classifier_serv.cpp:128-147).  The Python
 * fv_converter (jubatus_tpu_torch/fv/converter.py) stays the semantics
 * reference and the fallback for configs the fast path does not cover
 * (regex matchers, filters, idf/bm25 global weights, combination rules,
 * plugins); build_fast_spec() in fv/fast.py decides eligibility and
 * compiles the rule program passed to FastConverter.
 *
 * Exposed API (module _jubatus_native, compiled together with
 * _jubatus_native.c):
 *
 *   parse_envelope(buf, offset) -> (end, msgtype, msgid, method, params_off)
 *       frame + envelope-parse one msgpack-RPC message without building
 *       Python objects for the params subtree; returns None while the
 *       message is still incomplete, raises ValueError on garbage.
 *
 *   FastConverter(spec) with methods:
 *       set_label_row(label_bytes, row)
 *       label_rows() -> {bytes: int}
 *       convert(buf, params_off, mode) ->
 *           (n, b, k, aux, idx_bytes, val_bytes, unknowns)
 *       mode 0: params = [name, [[label, datum], ...]]   (classifier train)
 *               aux = int32 bytearray of label rows, unknowns = [(pos, bytes)]
 *       mode 1: params = [name, [[score, datum], ...]]   (regression train)
 *               aux = float32 bytearray of scores, unknowns = []
 *       mode 2: params = [name, [datum, ...]]            (classify/estimate)
 *               aux = None, unknowns = []
 *       b/k are bucket-padded; rows n..b-1 are zero padding.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- FNV-1a 64 (shared definition; must match fv/hashing.py) ----------- */

static uint64_t fc_fnv1a64(const unsigned char* data, size_t len) {
  uint64_t h = 0xCBF29CE484222325ULL;
  for (size_t i = 0; i < len; ++i) {
    h ^= (uint64_t)data[i];
    h *= 0x100000001B3ULL;
  }
  return h;
}

/* ======================================================================== */
/* msgpack subset reader                                                    */
/* ======================================================================== */

typedef struct {
  const uint8_t* p;
  const uint8_t* end;
} Rd;

enum { MP_OK = 0, MP_EOF = 1, MP_BAD = 2 };

static int rd_need(Rd* r, size_t n) { return (size_t)(r->end - r->p) >= n ? MP_OK : MP_EOF; }

static int rd_u8(Rd* r, uint8_t* v) {
  if (rd_need(r, 1)) return MP_EOF;
  *v = *r->p++;
  return MP_OK;
}

static uint16_t be16(const uint8_t* p) { return ((uint16_t)p[0] << 8) | p[1]; }
static uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}
static uint64_t be64(const uint8_t* p) {
  return ((uint64_t)be32(p) << 32) | be32(p + 4);
}

/* read array header */
static int mp_array(Rd* r, uint32_t* n) {
  uint8_t t;
  if (rd_u8(r, &t)) return MP_EOF;
  if ((t & 0xF0) == 0x90) { *n = t & 0x0F; return MP_OK; }
  if (t == 0xDC) { if (rd_need(r, 2)) return MP_EOF; *n = be16(r->p); r->p += 2; return MP_OK; }
  if (t == 0xDD) { if (rd_need(r, 4)) return MP_EOF; *n = be32(r->p); r->p += 4; return MP_OK; }
  return MP_BAD;
}

/* read str or bin payload */
static int mp_str(Rd* r, const uint8_t** s, uint32_t* len) {
  uint8_t t;
  if (rd_u8(r, &t)) return MP_EOF;
  uint32_t n;
  if ((t & 0xE0) == 0xA0) n = t & 0x1F;
  else if (t == 0xD9 || t == 0xC4) { uint8_t b; if (rd_u8(r, &b)) return MP_EOF; n = b; }
  else if (t == 0xDA || t == 0xC5) { if (rd_need(r, 2)) return MP_EOF; n = be16(r->p); r->p += 2; }
  else if (t == 0xDB || t == 0xC6) { if (rd_need(r, 4)) return MP_EOF; n = be32(r->p); r->p += 4; }
  else return MP_BAD;
  if (rd_need(r, n)) return MP_EOF;
  *s = r->p; *len = n; r->p += n;
  return MP_OK;
}

/* read any numeric as double (float32/64 + int/uint families) */
static int mp_num(Rd* r, double* v) {
  uint8_t t;
  if (rd_u8(r, &t)) return MP_EOF;
  if (t <= 0x7F) { *v = (double)t; return MP_OK; }
  if (t >= 0xE0) { *v = (double)(int8_t)t; return MP_OK; }
  switch (t) {
    case 0xCA: { if (rd_need(r, 4)) return MP_EOF; uint32_t u = be32(r->p); r->p += 4;
                 float f; memcpy(&f, &u, 4); *v = (double)f; return MP_OK; }
    case 0xCB: { if (rd_need(r, 8)) return MP_EOF; uint64_t u = be64(r->p); r->p += 8;
                 double d; memcpy(&d, &u, 8); *v = d; return MP_OK; }
    case 0xCC: { uint8_t b; if (rd_u8(r, &b)) return MP_EOF; *v = (double)b; return MP_OK; }
    case 0xCD: { if (rd_need(r, 2)) return MP_EOF; *v = (double)be16(r->p); r->p += 2; return MP_OK; }
    case 0xCE: { if (rd_need(r, 4)) return MP_EOF; *v = (double)be32(r->p); r->p += 4; return MP_OK; }
    case 0xCF: { if (rd_need(r, 8)) return MP_EOF; *v = (double)be64(r->p); r->p += 8; return MP_OK; }
    case 0xD0: { uint8_t b; if (rd_u8(r, &b)) return MP_EOF; *v = (double)(int8_t)b; return MP_OK; }
    case 0xD1: { if (rd_need(r, 2)) return MP_EOF; *v = (double)(int16_t)be16(r->p); r->p += 2; return MP_OK; }
    case 0xD2: { if (rd_need(r, 4)) return MP_EOF; *v = (double)(int32_t)be32(r->p); r->p += 4; return MP_OK; }
    case 0xD3: { if (rd_need(r, 8)) return MP_EOF; *v = (double)(int64_t)be64(r->p); r->p += 8; return MP_OK; }
    default: return MP_BAD;
  }
}

/* read any int (for msgid) */
static int mp_int(Rd* r, int64_t* v) {
  double d;
  int rc = mp_num(r, &d);
  if (rc) return rc;
  *v = (int64_t)d;
  return MP_OK;
}

/* skip one object (recursive, depth-limited) */
static int mp_skip(Rd* r, int depth) {
  if (depth > 96) return MP_BAD;
  uint8_t t;
  if (rd_u8(r, &t)) return MP_EOF;
  if (t <= 0x7F || t >= 0xE0 || t == 0xC0 || t == 0xC2 || t == 0xC3) return MP_OK;
  if ((t & 0xE0) == 0xA0) { uint32_t n = t & 0x1F; if (rd_need(r, n)) return MP_EOF; r->p += n; return MP_OK; }
  uint32_t n;
  switch (t) {
    case 0xC4: case 0xD9: { uint8_t b; if (rd_u8(r, &b)) return MP_EOF; n = b;
      if (rd_need(r, n)) return MP_EOF; r->p += n; return MP_OK; }
    case 0xC5: case 0xDA: { if (rd_need(r, 2)) return MP_EOF; n = be16(r->p); r->p += 2;
      if (rd_need(r, n)) return MP_EOF; r->p += n; return MP_OK; }
    case 0xC6: case 0xDB: { if (rd_need(r, 4)) return MP_EOF; n = be32(r->p); r->p += 4;
      if (rd_need(r, n)) return MP_EOF; r->p += n; return MP_OK; }
    case 0xCA: if (rd_need(r, 4)) return MP_EOF; r->p += 4; return MP_OK;
    case 0xCB: if (rd_need(r, 8)) return MP_EOF; r->p += 8; return MP_OK;
    case 0xCC: case 0xD0: if (rd_need(r, 1)) return MP_EOF; r->p += 1; return MP_OK;
    case 0xCD: case 0xD1: if (rd_need(r, 2)) return MP_EOF; r->p += 2; return MP_OK;
    case 0xCE: case 0xD2: if (rd_need(r, 4)) return MP_EOF; r->p += 4; return MP_OK;
    case 0xCF: case 0xD3: if (rd_need(r, 8)) return MP_EOF; r->p += 8; return MP_OK;
    case 0xD4: if (rd_need(r, 2)) return MP_EOF; r->p += 2; return MP_OK;  /* fixext1 */
    case 0xD5: if (rd_need(r, 3)) return MP_EOF; r->p += 3; return MP_OK;
    case 0xD6: if (rd_need(r, 5)) return MP_EOF; r->p += 5; return MP_OK;
    case 0xD7: if (rd_need(r, 9)) return MP_EOF; r->p += 9; return MP_OK;
    case 0xD8: if (rd_need(r, 17)) return MP_EOF; r->p += 17; return MP_OK;
    case 0xC7: { uint8_t b; if (rd_u8(r, &b)) return MP_EOF; n = (uint32_t)b + 1;
      if (rd_need(r, n)) return MP_EOF; r->p += n; return MP_OK; }
    case 0xC8: { if (rd_need(r, 2)) return MP_EOF; n = (uint32_t)be16(r->p) + 1; r->p += 2;
      if (rd_need(r, n)) return MP_EOF; r->p += n; return MP_OK; }
    case 0xC9: { if (rd_need(r, 4)) return MP_EOF; n = be32(r->p) + 1; r->p += 4;
      if (rd_need(r, n)) return MP_EOF; r->p += n; return MP_OK; }
    default: break;
  }
  uint32_t cnt;
  if ((t & 0xF0) == 0x90) cnt = t & 0x0F;
  else if (t == 0xDC) { if (rd_need(r, 2)) return MP_EOF; cnt = be16(r->p); r->p += 2; }
  else if (t == 0xDD) { if (rd_need(r, 4)) return MP_EOF; cnt = be32(r->p); r->p += 4; }
  else if ((t & 0xF0) == 0x80) cnt = (uint32_t)(t & 0x0F) * 2;
  else if (t == 0xDE) { if (rd_need(r, 2)) return MP_EOF; cnt = (uint32_t)be16(r->p) * 2; r->p += 2; }
  else if (t == 0xDF) { if (rd_need(r, 4)) return MP_EOF;
    uint32_t m = be32(r->p); r->p += 4;
    if (m > 0x7FFFFFFF) return MP_BAD; cnt = m * 2; }
  else return MP_BAD;
  for (uint32_t i = 0; i < cnt; ++i) {
    int rc = mp_skip(r, depth + 1);
    if (rc) return rc;
  }
  return MP_OK;
}

/* ---- parse_envelope ----------------------------------------------------- */

static PyObject* py_parse_envelope(PyObject* self, PyObject* args) {
  Py_buffer view;
  Py_ssize_t offset = 0;
  if (!PyArg_ParseTuple(args, "y*|n", &view, &offset)) return NULL;
  if (offset < 0 || offset > view.len) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "offset out of range");
    return NULL;
  }
  Rd r = { (const uint8_t*)view.buf + offset, (const uint8_t*)view.buf + view.len };
  const uint8_t* base = (const uint8_t*)view.buf;
  uint32_t n;
  int rc = mp_array(&r, &n);
  int64_t msgtype = -1, msgid = -1;
  const uint8_t* ms = NULL;
  uint32_t mlen = 0;
  Py_ssize_t params_off = -1;
  if (!rc) {
    if (n < 3 || n > 4) rc = MP_BAD;
  }
  if (!rc) rc = mp_int(&r, &msgtype);
  if (!rc) {
    if (msgtype == 0 && n == 4) {            /* request [0,id,method,params] */
      rc = mp_int(&r, &msgid);
      if (!rc) rc = mp_str(&r, &ms, &mlen);
      if (!rc) { params_off = r.p - base; rc = mp_skip(&r, 0); }
    } else if (msgtype == 2 && n == 3) {     /* notify [2,method,params] */
      rc = mp_str(&r, &ms, &mlen);
      if (!rc) { params_off = r.p - base; rc = mp_skip(&r, 0); }
    } else if (msgtype == 1 && n == 4) {     /* response [1,id,err,result] */
      rc = mp_int(&r, &msgid);
      if (!rc) { params_off = r.p - base; rc = mp_skip(&r, 0); }
      if (!rc) rc = mp_skip(&r, 0);
    } else {
      rc = MP_BAD;
    }
  }
  Py_ssize_t end = r.p - base;
  PyBuffer_Release(&view);
  if (rc == MP_EOF) Py_RETURN_NONE;
  if (rc == MP_BAD) {
    PyErr_SetString(PyExc_ValueError, "malformed msgpack-rpc message");
    return NULL;
  }
  PyObject* method = ms ? PyBytes_FromStringAndSize((const char*)ms, mlen)
                        : (Py_INCREF(Py_None), Py_None);
  PyObject* out = Py_BuildValue("(nLLNn)", end, (long long)msgtype,
                                (long long)msgid, method, params_off);
  return out;
}

/* ======================================================================== */
/* FrameSplitter — resumable msgpack-rpc stream framing                      */
/*                                                                           */
/* parse_envelope() re-walks the whole partial message on every socket read, */
/* which is O(message^2) per request for megabyte train() batches.  The      */
/* splitter owns the connection buffer and keeps an explicit skip stack      */
/* (container item counts + a raw-byte skip remainder), so every byte of the */
/* stream is scanned exactly once regardless of how it is chunked by TCP.    */
/* Replaces repeated-scan framing of the whole partial message.              */
/* ======================================================================== */

#define FS_MAXDEPTH 96

typedef struct {
  PyObject_HEAD
  uint8_t* buf;          /* owned, growable stream buffer */
  Py_ssize_t cap, len;
  Py_ssize_t start;      /* offset of current message start */
  Py_ssize_t scan;       /* resume point for the incremental skipper */
  int phase;             /* 0 = envelope prefix, 1 = skipping body */
  uint32_t counts[FS_MAXDEPTH];
  int depth;
  int64_t skip_bytes;    /* raw payload bytes still to skip */
  /* current message envelope */
  int64_t msgtype, msgid;
  PyObject* method;      /* bytes or None (owned) */
  Py_ssize_t params_off; /* relative to message start */
} FrameSplitter;

static int fs_init(FrameSplitter* self, PyObject* args, PyObject* kw) {
  (void)args; (void)kw;
  self->buf = NULL; self->cap = self->len = 0;
  self->start = self->scan = 0;
  self->phase = 0; self->depth = 0; self->skip_bytes = 0;
  self->msgtype = self->msgid = -1;
  self->method = NULL; self->params_off = -1;
  return 0;
}

static void fs_dealloc(FrameSplitter* self) {
  free(self->buf);
  Py_XDECREF(self->method);
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* fs_feed(FrameSplitter* self, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  /* compact: drop already-extracted prefix before appending */
  if (self->len + view.len - self->start > self->cap) {
    Py_ssize_t need = self->len + view.len - self->start;
    Py_ssize_t ncap = self->cap ? self->cap : 1 << 16;
    while (ncap < need) ncap *= 2;
    uint8_t* nb = malloc(ncap);
    if (!nb) { PyBuffer_Release(&view); PyErr_NoMemory(); return NULL; }
    uint8_t* ob = self->buf;
    Py_ssize_t tail = self->len - self->start, st = self->start;
    /* bulk copies run without the GIL: megabyte feeds must not add GIL
     * hold time that starves the threads feeding the device */
    Py_BEGIN_ALLOW_THREADS
    if (ob) memcpy(nb, ob + st, tail);
    memcpy(nb + tail, view.buf, view.len);
    Py_END_ALLOW_THREADS
    free(ob);
    self->buf = nb; self->cap = ncap;
    self->len = tail + view.len;
    self->scan -= st; self->start = 0;
  } else {
    uint8_t* buf = self->buf;
    Py_ssize_t st = self->start, tail = self->len - self->start;
    Py_ssize_t vlen = view.len;
    const void* vbuf = view.buf;
    Py_BEGIN_ALLOW_THREADS
    if (st > 0) memmove(buf, buf + st, tail);
    memcpy(buf + tail, vbuf, vlen);
    Py_END_ALLOW_THREADS
    self->len = tail + vlen;
    self->scan -= st; self->start = 0;
  }
  PyBuffer_Release(&view);
  Py_RETURN_NONE;
}

/* parse one object header at p (limit q).  Returns MP_OK and sets:
 *   *consumed = header bytes (including inline scalar payloads),
 *   *raw      = raw payload bytes that follow (str/bin/ext bodies),
 *   *items    = container item count (arrays; maps report 2x pairs),
 *   *is_cont  = 1 if container.
 * Scalars are fully consumed via *consumed; fixed numeric payloads are
 * treated as part of the header (<=9 bytes, so a boundary straddle just
 * re-reads the header next feed). */
static int fs_header(const uint8_t* p, const uint8_t* q, Py_ssize_t* consumed,
                     int64_t* raw, uint32_t* items, int* is_cont) {
  if (p >= q) return MP_EOF;
  uint8_t t = *p;
  *raw = 0; *items = 0; *is_cont = 0;
  if (t <= 0x7F || t >= 0xE0 || t == 0xC0 || t == 0xC2 || t == 0xC3) {
    *consumed = 1; return MP_OK;
  }
  if ((t & 0xE0) == 0xA0) { *consumed = 1; *raw = t & 0x1F; return MP_OK; }
  if ((t & 0xF0) == 0x90) { *consumed = 1; *items = t & 0x0F; *is_cont = 1; return MP_OK; }
  if ((t & 0xF0) == 0x80) { *consumed = 1; *items = (uint32_t)(t & 0x0F) * 2; *is_cont = 1; return MP_OK; }
  switch (t) {
    case 0xC4: case 0xD9:
      if (q - p < 2) return MP_EOF;
      *consumed = 2; *raw = p[1]; return MP_OK;
    case 0xC5: case 0xDA:
      if (q - p < 3) return MP_EOF;
      *consumed = 3; *raw = be16(p + 1); return MP_OK;
    case 0xC6: case 0xDB:
      if (q - p < 5) return MP_EOF;
      *consumed = 5; *raw = be32(p + 1); return MP_OK;
    case 0xCC: case 0xD0: if (q - p < 2) return MP_EOF; *consumed = 2; return MP_OK;
    case 0xCD: case 0xD1: if (q - p < 3) return MP_EOF; *consumed = 3; return MP_OK;
    case 0xCE: case 0xD2: case 0xCA: if (q - p < 5) return MP_EOF; *consumed = 5; return MP_OK;
    case 0xCF: case 0xD3: case 0xCB: if (q - p < 9) return MP_EOF; *consumed = 9; return MP_OK;
    case 0xD4: *consumed = 1; *raw = 2; return MP_OK;   /* fixext: tag+data as raw */
    case 0xD5: *consumed = 1; *raw = 3; return MP_OK;
    case 0xD6: *consumed = 1; *raw = 5; return MP_OK;
    case 0xD7: *consumed = 1; *raw = 9; return MP_OK;
    case 0xD8: *consumed = 1; *raw = 17; return MP_OK;
    case 0xC7: if (q - p < 2) return MP_EOF; *consumed = 2; *raw = (int64_t)p[1] + 1; return MP_OK;
    case 0xC8: if (q - p < 3) return MP_EOF; *consumed = 3; *raw = (int64_t)be16(p + 1) + 1; return MP_OK;
    case 0xC9: if (q - p < 5) return MP_EOF; *consumed = 5; *raw = (int64_t)be32(p + 1) + 1; return MP_OK;
    case 0xDC:
      if (q - p < 3) return MP_EOF;
      *consumed = 3; *items = be16(p + 1); *is_cont = 1; return MP_OK;
    case 0xDD:
      if (q - p < 5) return MP_EOF;
      *consumed = 5; *items = be32(p + 1); *is_cont = 1; return MP_OK;
    case 0xDE:
      if (q - p < 3) return MP_EOF;
      *consumed = 3; *items = (uint32_t)be16(p + 1) * 2; *is_cont = 1; return MP_OK;
    case 0xDF: {
      if (q - p < 5) return MP_EOF;
      uint32_t m = be32(p + 1);
      if (m > 0x7FFFFFFF) return MP_BAD;
      *consumed = 5; *items = m * 2; *is_cont = 1; return MP_OK;
    }
    default: return MP_BAD;
  }
}

static PyObject* fs_next(FrameSplitter* self) {
  const uint8_t* base = self->buf;
  if (self->phase == 0) {
    /* envelope prefix: array header + type (+id) (+method).  The prefix is
     * tiny (<~300 bytes), so re-parsing it until complete is O(1). */
    Rd r = { base + self->start, base + self->len };
    uint32_t n;
    int rc = mp_array(&r, &n);
    int64_t msgtype = -1, msgid = -1;
    const uint8_t* ms = NULL;
    uint32_t mlen = 0;
    Py_ssize_t params_off = -1;
    uint32_t remaining = 0;
    if (!rc && (n < 3 || n > 4)) rc = MP_BAD;
    if (!rc) rc = mp_int(&r, &msgtype);
    if (!rc) {
      if (msgtype == 0 && n == 4) {          /* request [0,id,method,params] */
        rc = mp_int(&r, &msgid);
        if (!rc) rc = mp_str(&r, &ms, &mlen);
        remaining = 1;
      } else if (msgtype == 2 && n == 3) {   /* notify [2,method,params] */
        rc = mp_str(&r, &ms, &mlen);
        remaining = 1;
      } else if (msgtype == 1 && n == 4) {   /* response [1,id,err,result] */
        rc = mp_int(&r, &msgid);
        remaining = 2;
      } else {
        rc = MP_BAD;
      }
    }
    if (rc == MP_EOF) Py_RETURN_NONE;
    if (rc == MP_BAD) {
      PyErr_SetString(PyExc_ValueError, "malformed msgpack-rpc message");
      return NULL;
    }
    params_off = (r.p - base) - self->start;
    Py_XDECREF(self->method);
    if (ms) {
      self->method = PyBytes_FromStringAndSize((const char*)ms, mlen);
      if (!self->method) return NULL;
    } else {
      Py_INCREF(Py_None);
      self->method = Py_None;
    }
    self->msgtype = msgtype;
    self->msgid = msgid;
    self->params_off = params_off;
    self->scan = r.p - base;
    self->counts[0] = remaining;
    self->depth = 1;
    self->skip_bytes = 0;
    self->phase = 1;
  }
  /* incremental body skip (GIL released: pure C scan over owned buffer) */
  {
    int rcode = 0;   /* 0 done, 1 need-more, 2 bad, 3 too-deep */
    Py_BEGIN_ALLOW_THREADS
    while (self->depth > 0) {
      if (self->skip_bytes > 0) {
        Py_ssize_t avail = self->len - self->scan;
        Py_ssize_t take = avail < self->skip_bytes ? avail : (Py_ssize_t)self->skip_bytes;
        self->scan += take;
        self->skip_bytes -= take;
        if (self->skip_bytes > 0) { rcode = 1; break; }  /* need more data */
      }
      if (self->counts[self->depth - 1] == 0) { self->depth--; continue; }
      Py_ssize_t consumed; int64_t raw; uint32_t items; int is_cont;
      int rc = fs_header(base + self->scan, base + self->len,
                         &consumed, &raw, &items, &is_cont);
      if (rc == MP_EOF) { rcode = 1; break; }      /* header straddles chunk */
      if (rc == MP_BAD) { rcode = 2; break; }
      self->counts[self->depth - 1]--;
      self->scan += consumed;
      if (is_cont) {
        if (self->depth >= FS_MAXDEPTH) { rcode = 3; break; }
        self->counts[self->depth++] = items;
      } else if (raw > 0) {
        self->skip_bytes = raw;
      }
    }
    Py_END_ALLOW_THREADS
    if (rcode == 1) Py_RETURN_NONE;
    if (rcode == 2) {
      PyErr_SetString(PyExc_ValueError, "malformed msgpack-rpc message");
      return NULL;
    }
    if (rcode == 3) {
      PyErr_SetString(PyExc_ValueError, "msgpack nesting too deep");
      return NULL;
    }
  }
  /* message complete: [start, scan) */
  PyObject* msg = PyBytes_FromStringAndSize((const char*)base + self->start,
                                            self->scan - self->start);
  if (!msg) return NULL;
  PyObject* method = self->method ? self->method : Py_None;
  if (!self->method) Py_INCREF(Py_None);
  PyObject* out = Py_BuildValue("(NLLNn)", msg, (long long)self->msgtype,
                                (long long)self->msgid, method,
                                self->params_off);
  self->method = NULL;                             /* ownership moved to out */
  self->start = self->scan;
  self->phase = 0;
  self->depth = 0;
  self->skip_bytes = 0;
  return out;
}

static PyObject* fs_pending(FrameSplitter* self, PyObject* noarg) {
  (void)noarg;
  return PyLong_FromSsize_t(self->len - self->start);
}

static PyMethodDef FrameSplitter_methods[] = {
  {"feed", (PyCFunction)fs_feed, METH_O,
   "feed(data): append stream bytes."},
  {"next", (PyCFunction)fs_next, METH_NOARGS,
   "next() -> (msg_bytes, msgtype, msgid, method, params_off) | None."},
  {"pending", (PyCFunction)fs_pending, METH_NOARGS,
   "pending() -> unconsumed byte count."},
  {NULL, NULL, 0, NULL},
};

static PyTypeObject FrameSplitterType = {
  PyVarObject_HEAD_INIT(NULL, 0)
  .tp_name = "_jubatus_native.FrameSplitter",
  .tp_basicsize = sizeof(FrameSplitter),
  .tp_dealloc = (destructor)fs_dealloc,
  .tp_flags = Py_TPFLAGS_DEFAULT,
  .tp_doc = "Resumable msgpack-rpc stream framer (each byte scanned once).",
  .tp_methods = FrameSplitter_methods,
  .tp_init = (initproc)fs_init,
  .tp_new = PyType_GenericNew,
};

/* ======================================================================== */
/* FastConverter                                                            */
/* ======================================================================== */

enum { M_ALL = 0, M_PREFIX = 1, M_SUFFIX = 2, M_EXACT = 3 };
enum { SP_STR = 0, SP_SPACE = 1, SP_NGRAM = 2 };
enum { SW_BIN = 0, SW_TF = 1, SW_LOG_TF = 2 };
enum { NM_NUM = 0, NM_LOG = 1, NM_STR = 2 };

typedef struct {
  int kind;
  char* pat;
  uint32_t patlen;
} Matcher;

typedef struct {
  Matcher m;
  int split;
  int char_num;
  int sample;
  char* suffix;       /* "@<type>#<sw>/<gw>" */
  uint32_t suffixlen;
} SRule;

typedef struct {
  Matcher m;
  int method;         /* NM_* */
} NRule;

/* label intern table: open addressing, FNV hash over label bytes */
typedef struct {
  uint64_t hash;
  uint32_t off;       /* into blob */
  uint32_t len;
  int32_t row;        /* -1 = empty slot */
} LSlot;

typedef struct {
  PyObject_HEAD
  uint64_t mask;
  SRule* srules; int n_srules;
  NRule* nrules; int n_nrules;
  LSlot* lt; uint32_t lt_cap; uint32_t lt_count;
  char* blob; uint32_t blob_len, blob_cap;
  int32_t* k_buckets; int n_kb;
  int32_t* b_buckets; int n_bb;
} FastConverter;

static int match_key(const Matcher* m, const uint8_t* k, uint32_t klen) {
  switch (m->kind) {
    case M_ALL: return 1;
    case M_PREFIX: return klen >= m->patlen && memcmp(k, m->pat, m->patlen) == 0;
    case M_SUFFIX: return klen >= m->patlen &&
                          memcmp(k + klen - m->patlen, m->pat, m->patlen) == 0;
    default: return klen == m->patlen && memcmp(k, m->pat, m->patlen) == 0;
  }
}

/* -- label table --------------------------------------------------------- */

static int lt_grow(FastConverter* fc) {
  uint32_t ncap = fc->lt_cap ? fc->lt_cap * 2 : 64;
  LSlot* nt = (LSlot*)malloc(ncap * sizeof(LSlot));
  if (!nt) return -1;
  for (uint32_t i = 0; i < ncap; ++i) nt[i].row = -1;
  for (uint32_t i = 0; i < fc->lt_cap; ++i) {
    if (fc->lt[i].row < 0) continue;
    uint32_t j = (uint32_t)fc->lt[i].hash & (ncap - 1);
    while (nt[j].row >= 0) j = (j + 1) & (ncap - 1);
    nt[j] = fc->lt[i];
  }
  free(fc->lt);
  fc->lt = nt;
  fc->lt_cap = ncap;
  return 0;
}

static LSlot* lt_find(FastConverter* fc, const uint8_t* s, uint32_t len, uint64_t h) {
  if (!fc->lt_cap) return NULL;
  uint32_t j = (uint32_t)h & (fc->lt_cap - 1);
  while (fc->lt[j].row >= 0) {
    if (fc->lt[j].hash == h && fc->lt[j].len == len &&
        memcmp(fc->blob + fc->lt[j].off, s, len) == 0)
      return &fc->lt[j];
    j = (j + 1) & (fc->lt_cap - 1);
  }
  return NULL;
}

static int lt_insert(FastConverter* fc, const uint8_t* s, uint32_t len, int32_t row) {
  uint64_t h = fc_fnv1a64(s, len);
  LSlot* sl = lt_find(fc, s, len, h);
  if (sl) { sl->row = row; return 0; }
  if (!fc->lt_cap || (fc->lt_count + 1) * 10 > fc->lt_cap * 7) {
    if (lt_grow(fc)) return -1;
  }
  if (fc->blob_len + len > fc->blob_cap) {
    uint32_t nc = fc->blob_cap ? fc->blob_cap : 1024;
    while (nc < fc->blob_len + len) nc *= 2;
    char* nb = (char*)realloc(fc->blob, nc);
    if (!nb) return -1;
    fc->blob = nb; fc->blob_cap = nc;
  }
  memcpy(fc->blob + fc->blob_len, s, len);
  uint32_t j = (uint32_t)h & (fc->lt_cap - 1);
  while (fc->lt[j].row >= 0) j = (j + 1) & (fc->lt_cap - 1);
  fc->lt[j].hash = h; fc->lt[j].off = fc->blob_len; fc->lt[j].len = len;
  fc->lt[j].row = row;
  fc->blob_len += len;
  fc->lt_count++;
  return 0;
}

/* -- per-call conversion state ------------------------------------------- */

typedef struct { uint32_t idx; float val; } Feat;

typedef struct {
  /* global feature arena (all datums, segmented by row_start) */
  Feat* feats; uint32_t n_feats, cap_feats;
  uint32_t* row_start;   /* [B+1] offsets into feats */
  uint32_t cap_rows;
  /* per-datum dedup table (generation-stamped) */
  uint32_t* dt_idx; uint32_t* dt_gen; uint32_t* dt_slot; /* slot list of cur datum */
  uint32_t dt_cap, dt_count, gen;
  /* token-count table (generation-stamped, per string expansion) */
  const uint8_t** tk_ptr; uint32_t* tk_len; uint32_t* tk_cnt; uint32_t* tk_gen;
  uint32_t* tk_slot;
  uint32_t tk_cap, tk_count, tk_genc;
  /* key scratch */
  char* kb; uint32_t kb_cap;
  /* ngram codepoint offsets scratch */
  uint32_t* cp; uint32_t cp_cap;
  /* unknown labels: (pos, byte offset, len) triples */
  uint32_t* unk; uint32_t n_unk, cap_unk;
  int oom;
} Conv;

static void conv_free(Conv* c) {
  free(c->feats); free(c->row_start);
  free(c->dt_idx); free(c->dt_gen); free(c->dt_slot);
  free(c->tk_ptr); free(c->tk_len); free(c->tk_cnt); free(c->tk_gen); free(c->tk_slot);
  free(c->kb); free(c->cp); free(c->unk);
}

static int conv_init(Conv* c, uint32_t rows_hint) {
  memset(c, 0, sizeof(*c));
  c->cap_feats = 4096;
  c->feats = (Feat*)malloc(c->cap_feats * sizeof(Feat));
  c->cap_rows = rows_hint + 1;
  c->row_start = (uint32_t*)malloc(c->cap_rows * sizeof(uint32_t));
  c->dt_cap = 256;
  c->dt_idx = (uint32_t*)malloc(c->dt_cap * 4);
  c->dt_gen = (uint32_t*)calloc(c->dt_cap, 4);
  c->dt_slot = (uint32_t*)malloc(c->dt_cap * 4);
  c->tk_cap = 512;
  c->tk_ptr = (const uint8_t**)malloc(c->tk_cap * sizeof(void*));
  c->tk_len = (uint32_t*)malloc(c->tk_cap * 4);
  c->tk_cnt = (uint32_t*)malloc(c->tk_cap * 4);
  c->tk_gen = (uint32_t*)calloc(c->tk_cap, 4);
  c->tk_slot = (uint32_t*)malloc(c->tk_cap * 4);
  c->kb_cap = 1024;
  c->kb = (char*)malloc(c->kb_cap);
  c->cp_cap = 256;
  c->cp = (uint32_t*)malloc(c->cp_cap * 4);
  c->cap_unk = 0; c->unk = NULL;
  if (!c->feats || !c->row_start || !c->dt_idx || !c->dt_gen || !c->dt_slot ||
      !c->tk_ptr || !c->tk_len || !c->tk_cnt || !c->tk_gen || !c->tk_slot ||
      !c->kb || !c->cp) {
    conv_free(c);
    return -1;
  }
  return 0;
}

/* The dedup table maps idx -> ordinal within the datum; the s-th distinct
   feature of the current datum lives at feats[row_base + s]. */

static int emit_feat(Conv* c, uint32_t row_base, uint32_t idx, float val) {
  uint32_t j = (idx * 2654435761u) & (c->dt_cap - 1);
  for (;;) {
    if (c->dt_gen[j] != c->gen) {
      /* claim: new distinct feature */
      if ((c->dt_count + 1) * 10 > c->dt_cap * 7) {
        /* grow: rebuild table from the datum's features in the arena */
        uint32_t ncap = c->dt_cap * 2;
        uint32_t* ni = (uint32_t*)malloc(ncap * 4);
        uint32_t* ng = (uint32_t*)calloc(ncap, 4);
        uint32_t* ns = (uint32_t*)malloc(ncap * 4);
        if (!ni || !ng || !ns) { free(ni); free(ng); free(ns); return -1; }
        for (uint32_t s = 0; s < c->dt_count; ++s) {
          uint32_t fidx = c->feats[row_base + s].idx;
          uint32_t jj = (fidx * 2654435761u) & (ncap - 1);
          while (ng[jj] == 1) jj = (jj + 1) & (ncap - 1);
          ng[jj] = 1; ni[jj] = fidx; ns[jj] = s;
        }
        free(c->dt_idx); free(c->dt_gen); free(c->dt_slot);
        c->dt_idx = ni; c->dt_gen = ng; c->dt_slot = ns;
        c->dt_cap = ncap; c->gen = 1;  /* fresh generation space */
        j = (idx * 2654435761u) & (c->dt_cap - 1);
        continue;
      }
      c->dt_gen[j] = c->gen;
      c->dt_idx[j] = idx;
      c->dt_slot[j] = c->dt_count;
      if (c->n_feats >= c->cap_feats) {
        uint32_t nc = c->cap_feats * 2;
        Feat* nf = (Feat*)realloc(c->feats, nc * sizeof(Feat));
        if (!nf) return -1;
        c->feats = nf; c->cap_feats = nc;
      }
      c->feats[c->n_feats].idx = idx;
      c->feats[c->n_feats].val = val;
      c->n_feats++;
      c->dt_count++;
      return 0;
    }
    if (c->dt_idx[j] == idx) {
      c->feats[row_base + c->dt_slot[j]].val += val;
      return 0;
    }
    j = (j + 1) & (c->dt_cap - 1);
  }
}

/* build key in scratch, hash, emit */
static int emit_key(Conv* c, const FastConverter* fc, uint32_t row_base,
                    const uint8_t* a, uint32_t alen,
                    const uint8_t* b, uint32_t blen,
                    const uint8_t* d, uint32_t dlen, float val) {
  /* key = a + ('$' + b if b) + d */
  uint32_t need = alen + 1 + blen + dlen;
  if (need > c->kb_cap) {
    uint32_t nc = c->kb_cap;
    while (nc < need) nc *= 2;
    char* nb = (char*)realloc(c->kb, nc);
    if (!nb) return -1;
    c->kb = nb; c->kb_cap = nc;
  }
  char* p = c->kb;
  memcpy(p, a, alen); p += alen;
  if (b) { *p++ = '$'; memcpy(p, b, blen); p += blen; }
  memcpy(p, d, dlen); p += dlen;
  uint32_t idx = (uint32_t)(fc_fnv1a64((const unsigned char*)c->kb,
                                       (size_t)(p - c->kb)) & fc->mask);
  return emit_feat(c, row_base, idx, val);
}

/* token-count table ops */
static int tk_add(Conv* c, const uint8_t* s, uint32_t len) {
  uint64_t h = fc_fnv1a64(s, len);
  uint32_t j = (uint32_t)h & (c->tk_cap - 1);
  for (;;) {
    if (c->tk_gen[j] != c->tk_genc) {
      if ((c->tk_count + 1) * 10 > c->tk_cap * 7) {
        uint32_t ncap = c->tk_cap * 2;
        const uint8_t** np = (const uint8_t**)malloc(ncap * sizeof(void*));
        uint32_t* nl = (uint32_t*)malloc(ncap * 4);
        uint32_t* ncnt = (uint32_t*)malloc(ncap * 4);
        uint32_t* ng = (uint32_t*)calloc(ncap, 4);
        uint32_t* ns = (uint32_t*)malloc(ncap * 4);
        if (!np || !nl || !ncnt || !ng || !ns) {
          free(np); free(nl); free(ncnt); free(ng); free(ns);
          return -1;
        }
        for (uint32_t s2 = 0; s2 < c->tk_count; ++s2) {
          uint32_t old = c->tk_slot[s2];
          uint64_t hh = fc_fnv1a64(c->tk_ptr[old], c->tk_len[old]);
          uint32_t jj = (uint32_t)hh & (ncap - 1);
          while (ng[jj] == 1) jj = (jj + 1) & (ncap - 1);
          ng[jj] = 1; np[jj] = c->tk_ptr[old]; nl[jj] = c->tk_len[old];
          ncnt[jj] = c->tk_cnt[old]; ns[s2] = jj;
        }
        free(c->tk_ptr); free(c->tk_len); free(c->tk_cnt); free(c->tk_gen);
        free(c->tk_slot);
        c->tk_ptr = np; c->tk_len = nl; c->tk_cnt = ncnt; c->tk_gen = ng;
        c->tk_slot = ns; c->tk_cap = ncap; c->tk_genc = 1;
        j = (uint32_t)h & (c->tk_cap - 1);
        continue;
      }
      c->tk_gen[j] = c->tk_genc;
      c->tk_ptr[j] = s; c->tk_len[j] = len; c->tk_cnt[j] = 1;
      c->tk_slot[c->tk_count] = j;
      c->tk_count++;
      return 0;
    }
    if (c->tk_len[j] == len && memcmp(c->tk_ptr[j], s, len) == 0) {
      c->tk_cnt[j]++;
      return 0;
    }
    j = (j + 1) & (c->tk_cap - 1);
  }
}

static float sample_weight(int kind, uint32_t tf) {
  if (kind == SW_BIN) return 1.0f;
  if (kind == SW_TF) return (float)tf;
  return (float)log(1.0 + (double)tf);
}

/* expand one (key, value) string pair through one rule */
static int expand_string(Conv* c, const FastConverter* fc, const SRule* r,
                         uint32_t row_base,
                         const uint8_t* k, uint32_t klen,
                         const uint8_t* v, uint32_t vlen) {
  if (r->split == SP_STR) {
    return emit_key(c, fc, row_base, k, klen, v, vlen,
                    (const uint8_t*)r->suffix, r->suffixlen, 1.0f);
  }
  /* tokenize with counts */
  c->tk_genc++;
  c->tk_count = 0;
  if (c->tk_genc == 0) { memset(c->tk_gen, 0, c->tk_cap * 4); c->tk_genc = 1; }
  if (r->split == SP_SPACE) {
    uint32_t i = 0;
    while (i < vlen) {
      while (i < vlen && (v[i] == ' ' || v[i] == '\t' || v[i] == '\n' ||
                          v[i] == '\r' || v[i] == '\v' || v[i] == '\f')) ++i;
      uint32_t s = i;
      while (i < vlen && !(v[i] == ' ' || v[i] == '\t' || v[i] == '\n' ||
                           v[i] == '\r' || v[i] == '\v' || v[i] == '\f')) ++i;
      if (i > s) { if (tk_add(c, v + s, i - s)) return -1; }
    }
  } else { /* SP_NGRAM over UTF-8 codepoints */
    uint32_t ncp = 0;
    for (uint32_t i = 0; i < vlen; ++i) {
      if ((v[i] & 0xC0) != 0x80) {
        if (ncp >= c->cp_cap) {
          uint32_t nc = c->cp_cap * 2;
          while (nc <= ncp) nc *= 2;
          uint32_t* np = (uint32_t*)realloc(c->cp, nc * 4);
          if (!np) return -1;
          c->cp = np; c->cp_cap = nc;
        }
        c->cp[ncp++] = i;
      }
    }
    if (ncp >= c->cp_cap) {
      uint32_t* np = (uint32_t*)realloc(c->cp, (c->cp_cap * 2) * 4);
      if (!np) return -1;
      c->cp = np; c->cp_cap *= 2;
    }
    c->cp[ncp] = vlen;  /* sentinel */
    uint32_t n = (uint32_t)r->char_num;
    if (ncp >= n) {
      for (uint32_t i = 0; i + n <= ncp; ++i) {
        uint32_t s = c->cp[i], e = c->cp[i + n];
        if (tk_add(c, v + s, e - s)) return -1;
      }
    }
  }
  for (uint32_t s = 0; s < c->tk_count; ++s) {
    uint32_t j = c->tk_slot[s];
    float val = sample_weight(r->sample, c->tk_cnt[j]);
    if (emit_key(c, fc, row_base, k, klen, c->tk_ptr[j], c->tk_len[j],
                 (const uint8_t*)r->suffix, r->suffixlen, val))
      return -1;
  }
  return 0;
}

/* parse one datum: [[sk,sv]...], [[nk,nv]...], optional [[bk,bv]...] */
static int parse_datum(Conv* c, const FastConverter* fc, Rd* r) {
  uint32_t row_base = c->n_feats;
  c->gen++;
  c->dt_count = 0;
  if (c->gen == 0) { memset(c->dt_gen, 0, c->dt_cap * 4); c->gen = 1; }
  uint32_t nparts;
  if (mp_array(r, &nparts) || nparts < 2) return MP_BAD;
  uint32_t ns;
  if (mp_array(r, &ns)) return MP_BAD;
  for (uint32_t i = 0; i < ns; ++i) {
    uint32_t two;
    const uint8_t *k, *v;
    uint32_t klen, vlen;
    if (mp_array(r, &two) || two != 2) return MP_BAD;
    if (mp_str(r, &k, &klen)) return MP_BAD;
    if (mp_str(r, &v, &vlen)) return MP_BAD;
    for (int ri = 0; ri < fc->n_srules; ++ri) {
      const SRule* sr = &fc->srules[ri];
      if (!match_key(&sr->m, k, klen)) continue;
      if (expand_string(c, fc, sr, row_base, k, klen, v, vlen)) return -2;
    }
  }
  uint32_t nn;
  if (mp_array(r, &nn)) return MP_BAD;
  for (uint32_t i = 0; i < nn; ++i) {
    uint32_t two;
    const uint8_t* k;
    uint32_t klen;
    double val;
    if (mp_array(r, &two) || two != 2) return MP_BAD;
    if (mp_str(r, &k, &klen)) return MP_BAD;
    if (mp_num(r, &val)) return MP_BAD;
    for (int ri = 0; ri < fc->n_nrules; ++ri) {
      const NRule* nr = &fc->nrules[ri];
      if (!match_key(&nr->m, k, klen)) continue;
      if (nr->method == NM_NUM) {
        if (emit_key(c, fc, row_base, k, klen, NULL, 0,
                     (const uint8_t*)"@num", 4, (float)val)) return -2;
      } else if (nr->method == NM_LOG) {
        double lv = log(val < 1.0 ? 1.0 : val);
        if (emit_key(c, fc, row_base, k, klen, NULL, 0,
                     (const uint8_t*)"@log", 4, (float)lv)) return -2;
      } else { /* NM_STR: key$<%g>@str */
        char nb[64];
        int nl = snprintf(nb, sizeof nb, "%g", val);
        if (nl < 0) return -2;
        if (emit_key(c, fc, row_base, k, klen, (const uint8_t*)nb, (uint32_t)nl,
                     (const uint8_t*)"@str", 4, 1.0f)) return -2;
      }
    }
  }
  if (nparts >= 3) {
    /* binary section present: fast spec guarantees no binary rules */
    if (mp_skip(r, 0)) return MP_BAD;
  }
  for (uint32_t extra = 3; extra < nparts; ++extra) {
    if (mp_skip(r, 0)) return MP_BAD;
  }
  return MP_OK;
}

/* -- FastConverter type --------------------------------------------------- */

static void FastConverter_dealloc(FastConverter* self) {
  for (int i = 0; i < self->n_srules; ++i) {
    free(self->srules[i].m.pat);
    free(self->srules[i].suffix);
  }
  free(self->srules);
  for (int i = 0; i < self->n_nrules; ++i) free(self->nrules[i].m.pat);
  free(self->nrules);
  free(self->lt);
  free(self->blob);
  free(self->k_buckets);
  free(self->b_buckets);
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static int load_matcher(PyObject* tup, int off, Matcher* m) {
  long kind = PyLong_AsLong(PyTuple_GET_ITEM(tup, off));
  if (kind == -1 && PyErr_Occurred()) return -1;
  m->kind = (int)kind;
  PyObject* pat = PyTuple_GET_ITEM(tup, off + 1);
  char* buf;
  Py_ssize_t len;
  if (PyBytes_AsStringAndSize(pat, &buf, &len) < 0) return -1;
  m->pat = (char*)malloc(len ? len : 1);
  if (!m->pat) { PyErr_NoMemory(); return -1; }
  memcpy(m->pat, buf, len);
  m->patlen = (uint32_t)len;
  return 0;
}

static int load_i32_list(PyObject* seq, int32_t** out, int* n) {
  PyObject* fast = PySequence_Fast(seq, "expected a sequence");
  if (!fast) return -1;
  Py_ssize_t cnt = PySequence_Fast_GET_SIZE(fast);
  *out = (int32_t*)malloc((cnt ? cnt : 1) * 4);
  if (!*out) { Py_DECREF(fast); PyErr_NoMemory(); return -1; }
  for (Py_ssize_t i = 0; i < cnt; ++i) {
    long v = PyLong_AsLong(PySequence_Fast_GET_ITEM(fast, i));
    if (v == -1 && PyErr_Occurred()) { Py_DECREF(fast); return -1; }
    (*out)[i] = (int32_t)v;
  }
  *n = (int)cnt;
  Py_DECREF(fast);
  return 0;
}

static int FastConverter_init(FastConverter* self, PyObject* args, PyObject* kw) {
  PyObject* spec;
  if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &spec)) return -1;
  PyObject* dim_o = PyDict_GetItemString(spec, "dim");
  if (!dim_o) { PyErr_SetString(PyExc_ValueError, "spec missing dim"); return -1; }
  unsigned long long dim = PyLong_AsUnsignedLongLong(dim_o);
  if (dim == 0 || (dim & (dim - 1)) != 0) {
    PyErr_SetString(PyExc_ValueError, "dim must be a power of two");
    return -1;
  }
  self->mask = dim - 1;

  PyObject* sr = PyDict_GetItemString(spec, "string_rules");
  PyObject* nr = PyDict_GetItemString(spec, "num_rules");
  Py_ssize_t nsr = sr ? PyList_Size(sr) : 0;
  Py_ssize_t nnr = nr ? PyList_Size(nr) : 0;
  if (nsr < 0 || nnr < 0) return -1;
  self->srules = (SRule*)calloc(nsr ? nsr : 1, sizeof(SRule));
  self->nrules = (NRule*)calloc(nnr ? nnr : 1, sizeof(NRule));
  if (!self->srules || !self->nrules) { PyErr_NoMemory(); return -1; }
  for (Py_ssize_t i = 0; i < nsr; ++i) {
    /* (kind, pat_bytes, split, char_num, sample, suffix_bytes) */
    PyObject* t = PyList_GET_ITEM(sr, i);
    if (!PyTuple_Check(t) || PyTuple_GET_SIZE(t) != 6) {
      PyErr_SetString(PyExc_ValueError, "bad string rule tuple");
      return -1;
    }
    SRule* R = &self->srules[i];
    if (load_matcher(t, 0, &R->m)) return -1;
    R->split = (int)PyLong_AsLong(PyTuple_GET_ITEM(t, 2));
    R->char_num = (int)PyLong_AsLong(PyTuple_GET_ITEM(t, 3));
    R->sample = (int)PyLong_AsLong(PyTuple_GET_ITEM(t, 4));
    char* buf; Py_ssize_t len;
    if (PyBytes_AsStringAndSize(PyTuple_GET_ITEM(t, 5), &buf, &len) < 0) return -1;
    R->suffix = (char*)malloc(len ? len : 1);
    if (!R->suffix) { PyErr_NoMemory(); return -1; }
    memcpy(R->suffix, buf, len);
    R->suffixlen = (uint32_t)len;
    self->n_srules = (int)(i + 1);
    if (PyErr_Occurred()) return -1;
  }
  for (Py_ssize_t i = 0; i < nnr; ++i) {
    /* (kind, pat_bytes, method) */
    PyObject* t = PyList_GET_ITEM(nr, i);
    if (!PyTuple_Check(t) || PyTuple_GET_SIZE(t) != 3) {
      PyErr_SetString(PyExc_ValueError, "bad num rule tuple");
      return -1;
    }
    NRule* R = &self->nrules[i];
    if (load_matcher(t, 0, &R->m)) return -1;
    R->method = (int)PyLong_AsLong(PyTuple_GET_ITEM(t, 2));
    self->n_nrules = (int)(i + 1);
    if (PyErr_Occurred()) return -1;
  }

  PyObject* kb = PyDict_GetItemString(spec, "k_buckets");
  PyObject* bb = PyDict_GetItemString(spec, "b_buckets");
  if (!kb || !bb) {
    PyErr_SetString(PyExc_ValueError, "spec missing k_buckets/b_buckets");
    return -1;
  }
  if (load_i32_list(kb, &self->k_buckets, &self->n_kb)) return -1;
  if (load_i32_list(bb, &self->b_buckets, &self->n_bb)) return -1;
  return 0;
}

static PyObject* FastConverter_set_label_row(FastConverter* self, PyObject* args) {
  Py_buffer label;
  int row;
  if (!PyArg_ParseTuple(args, "y*i", &label, &row)) return NULL;
  int rc = lt_insert(self, (const uint8_t*)label.buf, (uint32_t)label.len, row);
  PyBuffer_Release(&label);
  if (rc) return PyErr_NoMemory();
  Py_RETURN_NONE;
}

static PyObject* FastConverter_label_rows(FastConverter* self, PyObject* noarg) {
  PyObject* d = PyDict_New();
  if (!d) return NULL;
  for (uint32_t i = 0; i < self->lt_cap; ++i) {
    if (self->lt[i].row < 0) continue;
    PyObject* k = PyBytes_FromStringAndSize(self->blob + self->lt[i].off,
                                            self->lt[i].len);
    PyObject* v = PyLong_FromLong(self->lt[i].row);
    if (!k || !v || PyDict_SetItem(d, k, v) < 0) {
      Py_XDECREF(k); Py_XDECREF(v); Py_DECREF(d);
      return NULL;
    }
    Py_DECREF(k); Py_DECREF(v);
  }
  return d;
}

static int32_t round_bucket(const int32_t* buckets, int n, int32_t v, int32_t quantum) {
  for (int i = 0; i < n; ++i)
    if (v <= buckets[i]) return buckets[i];
  return ((v + quantum - 1) / quantum) * quantum;
}

static PyObject* FastConverter_convert(FastConverter* self, PyObject* args) {
  Py_buffer view;
  Py_ssize_t off;
  int mode;
  if (!PyArg_ParseTuple(args, "y*ni", &view, &off, &mode)) return NULL;
  if (off < 0 || off > view.len || mode < 0 || mode > 2) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "bad offset/mode");
    return NULL;
  }

  Rd r = { (const uint8_t*)view.buf + off, (const uint8_t*)view.buf + view.len };
  const uint8_t* base = (const uint8_t*)view.buf;
  int rc = 0;
  uint32_t nparams = 0, b_actual = 0;
  /* Conv is CALL-LOCAL scratch: convert() must stay reentrant — the
   * dispatcher's stale-generation redo path runs it concurrently with a
   * worker's stage-1 conversion (no shared lock).  All FastConverter
   * instance state read here is immutable after init except the label
   * table, which is only read/written with the GIL held. */
  Conv c;
  int32_t* lab_rows = NULL;     /* mode 0 */
  float* scores = NULL;         /* mode 1 */
  /* label byte ranges for mode 0 (resolved after the nogil phase) */
  uint32_t* lab_off = NULL;
  uint32_t* lab_len = NULL;

  if (conv_init(&c, 64)) { PyBuffer_Release(&view); return PyErr_NoMemory(); }

  Py_BEGIN_ALLOW_THREADS
  do {
    if ((rc = mp_array(&r, &nparams)) != 0) break;
    if (nparams < 2) { rc = MP_BAD; break; }
    if ((rc = mp_skip(&r, 0)) != 0) break;          /* name */
    uint32_t nd;
    if ((rc = mp_array(&r, &nd)) != 0) break;
    b_actual = nd;
    if (nd + 1 > c.cap_rows) {
      uint32_t nc2 = c.cap_rows;
      while (nc2 < nd + 1) nc2 *= 2;
      uint32_t* nrs = (uint32_t*)realloc(c.row_start, nc2 * 4);
      if (!nrs) { rc = -2; break; }
      c.row_start = nrs; c.cap_rows = nc2;
    }
    if (mode == 0) {
      lab_off = (uint32_t*)malloc((nd ? nd : 1) * 4);
      lab_len = (uint32_t*)malloc((nd ? nd : 1) * 4);
      if (!lab_off || !lab_len) { rc = -2; break; }
    } else if (mode == 1) {
      scores = (float*)malloc((nd ? nd : 1) * 4);
      if (!scores) { rc = -2; break; }
    }
    for (uint32_t i = 0; i < nd && !rc; ++i) {
      c.row_start[i] = c.n_feats;
      if (mode == 0 || mode == 1) {
        uint32_t two;
        if ((rc = mp_array(&r, &two)) != 0) break;
        if (two != 2) { rc = MP_BAD; break; }
        if (mode == 0) {
          const uint8_t* ls; uint32_t ll;
          if ((rc = mp_str(&r, &ls, &ll)) != 0) break;
          lab_off[i] = (uint32_t)(ls - base);
          lab_len[i] = ll;
        } else {
          double sc;
          if ((rc = mp_num(&r, &sc)) != 0) break;
          scores[i] = (float)sc;
        }
      }
      rc = parse_datum(&c, self, &r);
    }
    if (!rc) c.row_start[b_actual] = c.n_feats;
    /* trailing params (if any) are ignored */
  } while (0);
  Py_END_ALLOW_THREADS

  if (rc) {
    conv_free(&c);
    free(lab_off); free(lab_len); free(scores);
    PyBuffer_Release(&view);
    if (rc == -2) return PyErr_NoMemory();
    PyErr_SetString(PyExc_ValueError,
                    rc == MP_EOF ? "truncated params" : "malformed params");
    return NULL;
  }

  /* resolve labels (GIL held: the label table is only mutated under GIL) */
  PyObject* unknowns = PyList_New(0);
  if (!unknowns) goto fail;
  if (mode == 0) {
    lab_rows = (int32_t*)malloc((b_actual ? b_actual : 1) * 4);
    if (!lab_rows) { PyErr_NoMemory(); goto fail; }
    for (uint32_t i = 0; i < b_actual; ++i) {
      const uint8_t* ls = base + lab_off[i];
      uint64_t h = fc_fnv1a64(ls, lab_len[i]);
      LSlot* sl = lt_find(self, ls, lab_len[i], h);
      if (sl) {
        lab_rows[i] = sl->row;
      } else {
        lab_rows[i] = 0;
        PyObject* t = Py_BuildValue(
            "(Iy#)", i, (const char*)ls, (Py_ssize_t)lab_len[i]);
        if (!t || PyList_Append(unknowns, t) < 0) { Py_XDECREF(t); goto fail; }
        Py_DECREF(t);
      }
    }
  }

  /* K = max nnz, bucketed; B bucketed */
  {
    uint32_t kmax = 1;
    for (uint32_t i = 0; i < b_actual; ++i) {
      uint32_t n = c.row_start[i + 1] - c.row_start[i];
      if (n > kmax) kmax = n;
    }
    int32_t K = round_bucket(self->k_buckets, self->n_kb, (int32_t)kmax, 4096);
    int32_t B = round_bucket(self->b_buckets, self->n_bb,
                             (int32_t)(b_actual ? b_actual : 1), 8192);

    PyObject* idx_o = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)B * K * 4);
    PyObject* val_o = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)B * K * 4);
    if (!idx_o || !val_o) { Py_XDECREF(idx_o); Py_XDECREF(val_o); goto fail; }
    int32_t* idx = (int32_t*)PyBytes_AS_STRING(idx_o);
    float* val = (float*)PyBytes_AS_STRING(val_o);
    /* megabyte fill without the GIL (pure C over fresh PyBytes buffers) */
    Py_BEGIN_ALLOW_THREADS
    memset(idx, 0, (size_t)B * K * 4);
    memset(val, 0, (size_t)B * K * 4);
    for (uint32_t i = 0; i < b_actual; ++i) {
      uint32_t s = c.row_start[i], e = c.row_start[i + 1];
      uint32_t n = e - s;
      if (n > (uint32_t)K) n = (uint32_t)K;
      for (uint32_t j = 0; j < n; ++j) {
        idx[(size_t)i * K + j] = (int32_t)c.feats[s + j].idx;
        val[(size_t)i * K + j] = c.feats[s + j].val;
      }
    }
    Py_END_ALLOW_THREADS

    PyObject* aux = NULL;
    if (mode == 0) {
      aux = PyByteArray_FromStringAndSize(NULL, (Py_ssize_t)B * 4);
      if (aux) {
        int32_t* dst = (int32_t*)PyByteArray_AS_STRING(aux);
        memset(dst, 0, (size_t)B * 4);
        memcpy(dst, lab_rows, (size_t)b_actual * 4);
      }
    } else if (mode == 1) {
      aux = PyByteArray_FromStringAndSize(NULL, (Py_ssize_t)B * 4);
      if (aux) {
        float* dst = (float*)PyByteArray_AS_STRING(aux);
        memset(dst, 0, (size_t)B * 4);
        memcpy(dst, scores, (size_t)b_actual * 4);
      }
    } else {
      aux = Py_None;
      Py_INCREF(aux);
    }
    if (!aux) { Py_DECREF(idx_o); Py_DECREF(val_o); goto fail; }

    PyObject* out = Py_BuildValue("(IiiNNNN)", b_actual, (int)B, (int)K,
                                  aux, idx_o, val_o, unknowns);
    conv_free(&c);
    free(lab_off); free(lab_len); free(scores); free(lab_rows);
    PyBuffer_Release(&view);
    return out;
  }

fail:
  conv_free(&c);
  free(lab_off); free(lab_len); free(scores); free(lab_rows);
  Py_XDECREF(unknowns);
  PyBuffer_Release(&view);
  return NULL;
}

/* ======================================================================== */
/* convert_raw_batch — N raw train frames -> ONE packed arena, one C call   */
/*                                                                           */
/* The batched ingest entry point: parses every frame's msgpack params and  */
/* converts every datum with the GIL released, then fills a single packed   */
/* [idx | val | aux | mask] arena laid out EXACTLY like the Python          */
/* per-request path (per-frame bucket-padded blocks, K padded to the widest */
/* frame, batch axis bucketed over the total) — the fused device step is    */
/* bitwise identical to converting each request separately and coalescing   */
/* with batching/bucketing.fuse_sparse_batches + models._pack_batch.        */
/*                                                                           */
/* The arena layout matches models/classifier._pack_batch:                  */
/*   [ idx: B*K int32 | val: B*K f32 | aux: B i32/f32 | mask: B f32 ]       */
/* so the result reaches the device in one copy with no further host       */
/* copies.  An optional `acquire(nbytes)` callable supplies a recycled      */
/* writable buffer (batching/arenas.ArenaPool); otherwise a fresh bytearray */
/* is returned.                                                             */
/* ======================================================================== */

typedef struct {
  Py_buffer view;
  int have_view;
  Py_ssize_t off;
  uint32_t nd;          /* datum count of this frame */
  uint32_t first;       /* global datum index of the frame's first datum */
  int32_t kmax;         /* max nnz over the frame's datums */
  int64_t bb;           /* bucket-padded row count (0 for empty frames) */
  int64_t row0;         /* arena row offset of the frame's block */
} BFrame;

/* Python batching/bucketing.round_b: the table, then power-of-two
 * multiples of 8192 (NOT the per-request quantum ceil — the fused total
 * must bucket exactly like the Python coalescer's output). */
static int64_t fused_round_b(const int32_t* buckets, int n, int64_t v) {
  for (int i = 0; i < n; ++i)
    if (v <= buckets[i]) return buckets[i];
  int64_t x = 8192;
  while (x < v) x *= 2;
  return x;
}

static PyObject* FastConverter_convert_raw_batch(FastConverter* self,
                                                 PyObject* args) {
  PyObject* frames_obj;
  int mode;
  PyObject* acquire = Py_None;
  if (!PyArg_ParseTuple(args, "Oi|O", &frames_obj, &mode, &acquire))
    return NULL;
  if (mode < 0 || mode > 1) {
    PyErr_SetString(PyExc_ValueError,
                    "convert_raw_batch supports modes 0 (labeled) and "
                    "1 (scored) only");
    return NULL;
  }
  PyObject* seq = PySequence_Fast(frames_obj, "frames must be a sequence");
  if (!seq) return NULL;
  Py_ssize_t nf = PySequence_Fast_GET_SIZE(seq);

  BFrame* fr = (BFrame*)calloc(nf ? nf : 1, sizeof(BFrame));
  const uint8_t** lab_ptr = NULL;
  uint32_t* lab_len = NULL;
  float* scores = NULL;
  int32_t* lab_rows = NULL;
  uint32_t cap_d = 64, total_d = 0;
  Conv c;
  int conv_ready = 0;
  PyObject* unknowns = NULL;
  PyObject* arena = NULL;
  PyObject* result = NULL;
  int rc = 0;

  if (!fr) { PyErr_NoMemory(); goto done; }
  if (mode == 0) {
    lab_ptr = (const uint8_t**)malloc(cap_d * sizeof(void*));
    lab_len = (uint32_t*)malloc(cap_d * 4);
    if (!lab_ptr || !lab_len) { PyErr_NoMemory(); goto done; }
  } else {
    scores = (float*)malloc(cap_d * 4);
    if (!scores) { PyErr_NoMemory(); goto done; }
  }
  if (conv_init(&c, 64)) { PyErr_NoMemory(); goto done; }
  conv_ready = 1;

  /* pin every frame buffer up front (label pointers into them must
   * survive until `done`); offsets validated per view */
  for (Py_ssize_t f = 0; f < nf; ++f) {
    PyObject* it = PySequence_Fast_GET_ITEM(seq, f);
    PyObject* b_o = PySequence_GetItem(it, 0);
    PyObject* o_o = b_o ? PySequence_GetItem(it, 1) : NULL;
    if (!b_o || !o_o) { Py_XDECREF(b_o); Py_XDECREF(o_o); goto done; }
    Py_ssize_t off = PyNumber_AsSsize_t(o_o, PyExc_OverflowError);
    Py_DECREF(o_o);
    if (off == -1 && PyErr_Occurred()) { Py_DECREF(b_o); goto done; }
    int gb = PyObject_GetBuffer(b_o, &fr[f].view, PyBUF_SIMPLE);
    Py_DECREF(b_o);
    if (gb < 0) goto done;
    fr[f].have_view = 1;
    if (off < 0 || off > fr[f].view.len) {
      PyErr_SetString(PyExc_ValueError, "params offset out of range");
      goto done;
    }
    fr[f].off = off;
  }

  /* phase 1: parse + convert every frame's datums (no GIL) -------------- */
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t f = 0; f < nf && !rc; ++f) {
    Rd r = { (const uint8_t*)fr[f].view.buf + fr[f].off,
             (const uint8_t*)fr[f].view.buf + fr[f].view.len };
    uint32_t nparams, nd;
    if ((rc = mp_array(&r, &nparams)) != 0) break;
    if (nparams < 2) { rc = MP_BAD; break; }
    if ((rc = mp_skip(&r, 0)) != 0) break;          /* name */
    if ((rc = mp_array(&r, &nd)) != 0) break;
    fr[f].nd = nd;
    fr[f].first = total_d;
    fr[f].kmax = 0;
    for (uint32_t j = 0; j < nd && !rc; ++j) {
      if (total_d + 2 > c.cap_rows) {
        uint32_t nc2 = c.cap_rows;
        while (nc2 < total_d + 2) nc2 *= 2;
        uint32_t* nrs = (uint32_t*)realloc(c.row_start, nc2 * 4);
        if (!nrs) { rc = -2; break; }
        c.row_start = nrs; c.cap_rows = nc2;
      }
      if (total_d >= cap_d) {
        uint32_t nc2 = cap_d * 2;
        if (mode == 0) {
          const uint8_t** np2 = (const uint8_t**)realloc(
              (void*)lab_ptr, nc2 * sizeof(void*));
          if (np2) lab_ptr = np2;
          uint32_t* nl2 = (uint32_t*)realloc(lab_len, nc2 * 4);
          if (nl2) lab_len = nl2;
          if (!np2 || !nl2) { rc = -2; break; }
        } else {
          float* ns2 = (float*)realloc(scores, nc2 * 4);
          if (!ns2) { rc = -2; break; }
          scores = ns2;
        }
        cap_d = nc2;
      }
      c.row_start[total_d] = c.n_feats;
      uint32_t two;
      if ((rc = mp_array(&r, &two)) != 0) break;
      if (two != 2) { rc = MP_BAD; break; }
      if (mode == 0) {
        const uint8_t* ls; uint32_t ll;
        if ((rc = mp_str(&r, &ls, &ll)) != 0) break;
        lab_ptr[total_d] = ls;
        lab_len[total_d] = ll;
      } else {
        double sc;
        if ((rc = mp_num(&r, &sc)) != 0) break;
        scores[total_d] = (float)sc;
      }
      rc = parse_datum(&c, self, &r);
      if (rc) break;
      {
        int32_t nnz = (int32_t)(c.n_feats - c.row_start[total_d]);
        if (nnz > fr[f].kmax) fr[f].kmax = nnz;
      }
      total_d++;
    }
    /* trailing params (if any) are ignored */
  }
  if (!rc) c.row_start[total_d] = c.n_feats;
  Py_END_ALLOW_THREADS

  if (rc) {
    if (rc == -2) PyErr_NoMemory();
    else PyErr_SetString(PyExc_ValueError,
                         rc == MP_EOF ? "truncated params"
                                      : "malformed params");
    goto done;
  }

  /* shape bucketing: per-frame (b_i, k_i) exactly like convert(), then
   * the fused batch axis exactly like the Python coalescer */
  {
    int64_t K = 0, bsum = 0, single_b = 0;
    int n_nonempty = 0;
    for (Py_ssize_t f = 0; f < nf; ++f) {
      if (fr[f].nd == 0) { fr[f].bb = 0; continue; }
      int32_t kb = round_bucket(self->k_buckets, self->n_kb,
                                fr[f].kmax ? fr[f].kmax : 1, 4096);
      fr[f].bb = round_bucket(self->b_buckets, self->n_bb,
                              (int32_t)fr[f].nd, 8192);
      fr[f].row0 = bsum;
      bsum += fr[f].bb;
      single_b = fr[f].bb;
      if (kb > K) K = kb;
      n_nonempty++;
    }
    int64_t B = 0;
    if (n_nonempty == 1) B = single_b;      /* single request: no re-bucket */
    else if (n_nonempty > 1)
      B = fused_round_b(self->b_buckets, self->n_bb, bsum);
    if (B * K > ((int64_t)1 << 33)) {
      PyErr_SetString(PyExc_ValueError, "fused batch too large");
      goto done;
    }

    /* resolve labels + collect unknowns (GIL held: the label table is
     * only mutated with the GIL) */
    unknowns = PyList_New(0);
    if (!unknowns) goto done;
    if (mode == 0 && total_d) {
      lab_rows = (int32_t*)malloc(total_d * 4);
      if (!lab_rows) { PyErr_NoMemory(); goto done; }
      for (Py_ssize_t f = 0; f < nf; ++f) {
        for (uint32_t j = 0; j < fr[f].nd; ++j) {
          uint32_t d = fr[f].first + j;
          uint64_t h = fc_fnv1a64(lab_ptr[d], lab_len[d]);
          LSlot* sl = lt_find(self, lab_ptr[d], lab_len[d], h);
          if (sl) {
            lab_rows[d] = sl->row;
          } else {
            lab_rows[d] = 0;
            PyObject* t = Py_BuildValue(
                "(ny#)", (Py_ssize_t)(fr[f].row0 + j),
                (const char*)lab_ptr[d], (Py_ssize_t)lab_len[d]);
            if (!t || PyList_Append(unknowns, t) < 0) {
              Py_XDECREF(t);
              goto done;
            }
            Py_DECREF(t);
          }
        }
      }
    }

    /* arena: [idx B*K i32 | val B*K f32 | aux B | mask B f32] ----------- */
    if (B > 0) {
      Py_ssize_t total_bytes = (Py_ssize_t)(2 * B * K * 4 + 8 * B);
      uint8_t* base = NULL;
      if (acquire != NULL && acquire != Py_None) {
        PyObject* got = PyObject_CallFunction(acquire, "n", total_bytes);
        if (!got) goto done;
        if (got == Py_None) {
          Py_DECREF(got);
        } else {
          Py_buffer ob;
          if (PyObject_GetBuffer(got, &ob, PyBUF_WRITABLE) == 0) {
            if (ob.len >= total_bytes) {
              arena = got;
              base = (uint8_t*)ob.buf;
              /* the arena reference keeps the memory alive; the pool
               * guarantees the buffer stays stable while checked out */
              PyBuffer_Release(&ob);
            } else {
              PyBuffer_Release(&ob);
              Py_DECREF(got);
            }
          } else {
            PyErr_Clear();
            Py_DECREF(got);
          }
        }
      }
      if (!arena) {
        arena = PyByteArray_FromStringAndSize(NULL, total_bytes);
        if (!arena) goto done;
        base = (uint8_t*)PyByteArray_AS_STRING(arena);
      }
      {
        int32_t* idxp = (int32_t*)base;
        float* valp = (float*)(base + B * K * 4);
        uint8_t* auxp = base + 2 * B * K * 4;
        float* maskp = (float*)(base + 2 * B * K * 4 + 4 * B);
        Py_BEGIN_ALLOW_THREADS
        memset(base, 0, (size_t)total_bytes);
        for (Py_ssize_t f = 0; f < nf; ++f) {
          if (fr[f].nd == 0) continue;
          for (uint32_t j = 0; j < fr[f].nd; ++j) {
            uint32_t d = fr[f].first + j;
            int64_t row = fr[f].row0 + j;
            uint32_t s = c.row_start[d], e = c.row_start[d + 1];
            uint32_t n = e - s;
            if (n > (uint32_t)K) n = (uint32_t)K;
            for (uint32_t t = 0; t < n; ++t) {
              idxp[row * K + t] = (int32_t)c.feats[s + t].idx;
              valp[row * K + t] = c.feats[s + t].val;
            }
            if (mode == 0) ((int32_t*)auxp)[row] = lab_rows[d];
            else ((float*)auxp)[row] = scores[d];
            maskp[row] = 1.0f;
          }
        }
        Py_END_ALLOW_THREADS
      }
    } else {
      arena = Py_None;
      Py_INCREF(arena);
    }

    /* (ns, b, k, arena, unknowns) */
    {
      PyObject* ns = PyTuple_New(nf);
      if (!ns) goto done;
      for (Py_ssize_t f = 0; f < nf; ++f) {
        PyObject* v = PyLong_FromUnsignedLong(fr[f].nd);
        if (!v) { Py_DECREF(ns); goto done; }
        PyTuple_SET_ITEM(ns, f, v);
      }
      result = Py_BuildValue("(NnnOO)", ns, (Py_ssize_t)B,
                             (Py_ssize_t)(B ? K : 0), arena, unknowns);
    }
  }

done:
  if (conv_ready) conv_free(&c);
  free(lab_rows);
  free((void*)lab_ptr);
  free(lab_len);
  free(scores);
  if (fr) {
    for (Py_ssize_t f = 0; f < nf; ++f)
      if (fr[f].have_view) PyBuffer_Release(&fr[f].view);
    free(fr);
  }
  Py_XDECREF(arena);
  Py_XDECREF(unknowns);
  Py_DECREF(seq);
  return result;
}

static PyMethodDef FastConverter_methods[] = {
  {"set_label_row", (PyCFunction)FastConverter_set_label_row, METH_VARARGS,
   "set_label_row(label_bytes, row): register a label -> row mapping."},
  {"label_rows", (PyCFunction)FastConverter_label_rows, METH_NOARGS,
   "label_rows() -> {label_bytes: row}"},
  {"convert", (PyCFunction)FastConverter_convert, METH_VARARGS,
   "convert(buf, params_off, mode) -> (n, b, k, aux, idx, val, unknowns)"},
  {"convert_raw_batch",
   (PyCFunction)FastConverter_convert_raw_batch, METH_VARARGS,
   "convert_raw_batch(frames, mode[, acquire]) -> (ns, b, k, arena, "
   "unknowns): parse+convert N raw train frames into one packed "
   "[idx|val|aux|mask] arena in a single GIL-released call."},
  {NULL, NULL, 0, NULL},
};

static PyTypeObject FastConverterType = {
  PyVarObject_HEAD_INIT(NULL, 0)
  .tp_name = "_jubatus_native.FastConverter",
  .tp_basicsize = sizeof(FastConverter),
  .tp_dealloc = (destructor)FastConverter_dealloc,
  .tp_flags = Py_TPFLAGS_DEFAULT,
  .tp_doc = "Compiled fv-converter fast path over raw msgpack payloads.",
  .tp_methods = FastConverter_methods,
  .tp_init = (initproc)FastConverter_init,
  .tp_new = PyType_GenericNew,
};

/* ---- registration hook (called from _jubatus_native.c module init) ----- */

static PyMethodDef fastconv_module_methods[] = {
  {"parse_envelope", py_parse_envelope, METH_VARARGS,
   "parse_envelope(buf[, offset]) -> (end, msgtype, msgid, method, params_off) "
   "or None while incomplete."},
  {NULL, NULL, 0, NULL},
};

int fastconv_register(PyObject* module) {
  if (PyType_Ready(&FastConverterType) < 0) return -1;
  Py_INCREF(&FastConverterType);
  if (PyModule_AddObject(module, "FastConverter",
                         (PyObject*)&FastConverterType) < 0) {
    Py_DECREF(&FastConverterType);
    return -1;
  }
  if (PyType_Ready(&FrameSplitterType) < 0) return -1;
  Py_INCREF(&FrameSplitterType);
  if (PyModule_AddObject(module, "FrameSplitter",
                         (PyObject*)&FrameSplitterType) < 0) {
    Py_DECREF(&FrameSplitterType);
    return -1;
  }
  PyObject* d = PyModule_GetDict(module);
  for (PyMethodDef* m = fastconv_module_methods; m->ml_name; ++m) {
    PyObject* f = PyCFunction_New(m, NULL);
    if (!f || PyDict_SetItemString(d, m->ml_name, f) < 0) {
      Py_XDECREF(f);
      return -1;
    }
    Py_DECREF(f);
  }
  return 0;
}
