/* _specenc — compact binary codec for the control plane's hottest
 * payload, the TaskSpec (ray_tpu/_private/task_spec.py).
 *
 * Counterpart of the reference's compiled task-spec path: specs there
 * are protobufs built and parsed in C++ behind the Cython bridge
 * (reference: python/ray/_raylet.pyx:3709 submit_task building
 * TaskSpecification; src/ray/protobuf/common.proto TaskSpec). Here the
 * spec is a Python dataclass, and pickling it costs ~25-50 us per spec
 * across submit+dispatch — the dominant per-task head cost once result
 * payloads moved off the head. This module packs/unpacks the spec's
 * typed fields straight to bytes (tagged, varint-length, little
 * endian), leaving only the two arbitrary-object fields
 * (scheduling_strategy, runtime_env) to pickle — and those are None on
 * the hot path.
 *
 * Interface (see task_spec.pack_spec / unpack_spec wrappers):
 *   pack(tuple) -> bytes     tuple of tagged-codable values
 *   unpack(bytes) -> tuple
 *   pack_value(obj) -> bytes   one tagged value, no header (the binary
 *   unpack_value(bytes) -> obj wire frames supply their own header —
 *                              ray_tpu/_private/wirefmt.py)
 * Supported values: None, bool, int (64-bit signed), float, str,
 * bytes, list, tuple, dict with str keys, (str,int) pair. Anything
 * else raises TypeError — the wrapper falls back to pickle for the
 * whole spec/frame, so foreign producers (the C++ minipickle client)
 * and exotic field values keep working.
 *
 * The generic container tags (T_LIST/T_MAP/T_TUPLE) are ADDITIVE to
 * the v1 spec layout: pack() of a spec tuple emits exactly the same
 * bytes as before (all-numeric dicts keep the compact T_DSF form the
 * resources field always used), so packed specs stay byte-compatible
 * across the upgrade. ray_tpu/_private/wirefmt.py carries a pure-
 * Python codec for the identical byte format — mandatory fallback
 * where this extension can't build.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define MAGIC 0xA7u
#define VERSION 1u

/* Containers nest in practice <= ~6 deep (a frame body holding a list
 * of record dicts); the cap exists so a corrupt/hostile buffer cannot
 * recurse the C stack away. */
#define MAX_DEPTH 64

enum {
  T_NONE = 0,
  T_STR = 1,
  T_BYTES = 2,
  T_INT = 3,
  T_FLOAT = 4,
  T_TRUE = 5,
  T_FALSE = 6,
  T_LSTR = 7,    /* list of str */
  T_DSF = 8,     /* dict str -> float (all-numeric values) */
  T_PAIR_SI = 9, /* (str, int) — owner_addr */
  T_LIST = 10,   /* generic list: varint n, then n values */
  T_MAP = 11,    /* dict str -> any: varint n, then n (key, value) */
  T_TUPLE = 12,  /* generic tuple: varint n, then n values */
};

/* ---- growable output buffer ---- */

typedef struct {
  char *buf;
  Py_ssize_t len;
  Py_ssize_t cap;
} Out;

static int out_reserve(Out *o, Py_ssize_t extra) {
  if (o->len + extra <= o->cap) return 0;
  Py_ssize_t ncap = o->cap ? o->cap * 2 : 256;
  while (ncap < o->len + extra) ncap *= 2;
  char *nb = PyMem_Realloc(o->buf, ncap);
  if (!nb) {
    PyErr_NoMemory();
    return -1;
  }
  o->buf = nb;
  o->cap = ncap;
  return 0;
}

static int out_u8(Out *o, uint8_t v) {
  if (out_reserve(o, 1) < 0) return -1;
  o->buf[o->len++] = (char)v;
  return 0;
}

static int out_varint(Out *o, uint64_t v) {
  if (out_reserve(o, 10) < 0) return -1;
  while (v >= 0x80) {
    o->buf[o->len++] = (char)(v | 0x80);
    v >>= 7;
  }
  o->buf[o->len++] = (char)v;
  return 0;
}

static int out_bytes(Out *o, const char *p, Py_ssize_t n) {
  if (out_reserve(o, n) < 0) return -1;
  memcpy(o->buf + o->len, p, n);
  o->len += n;
  return 0;
}

static uint64_t zigzag(int64_t v) {
  return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}

static int64_t unzigzag(uint64_t v) {
  return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

/* ---- encode one value ---- */

static int enc_str_body(Out *o, PyObject *s) {
  Py_ssize_t n;
  const char *p = PyUnicode_AsUTF8AndSize(s, &n);
  if (!p) return -1;
  if (out_varint(o, (uint64_t)n) < 0) return -1;
  return out_bytes(o, p, n);
}

static int enc_value(Out *o, PyObject *v, int depth) {
  if (depth > MAX_DEPTH) {
    PyErr_SetString(PyExc_TypeError, "specenc: nesting too deep");
    return -1;
  }
  if (v == Py_None) return out_u8(o, T_NONE);
  if (v == Py_True) return out_u8(o, T_TRUE);
  if (v == Py_False) return out_u8(o, T_FALSE);
  if (PyUnicode_Check(v)) {
    if (out_u8(o, T_STR) < 0) return -1;
    return enc_str_body(o, v);
  }
  if (PyBytes_Check(v)) {
    if (out_u8(o, T_BYTES) < 0) return -1;
    if (out_varint(o, (uint64_t)PyBytes_GET_SIZE(v)) < 0) return -1;
    return out_bytes(o, PyBytes_AS_STRING(v), PyBytes_GET_SIZE(v));
  }
  if (PyLong_Check(v)) {
    int overflow = 0;
    int64_t i = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (overflow || (i == -1 && PyErr_Occurred())) {
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_TypeError, "int out of 64-bit range");
      return -1;
    }
    if (out_u8(o, T_INT) < 0) return -1;
    return out_varint(o, zigzag(i));
  }
  if (PyFloat_Check(v)) {
    double d = PyFloat_AS_DOUBLE(v);
    if (out_u8(o, T_FLOAT) < 0) return -1;
    return out_bytes(o, (const char *)&d, 8);
  }
  if (PyList_Check(v)) {
    Py_ssize_t n = PyList_GET_SIZE(v);
    /* All-str lists keep the compact T_LSTR tag (the v1 spec layout
     * for deps/return_ids); anything else takes the generic tag. */
    int all_str = 1;
    for (Py_ssize_t k = 0; k < n; k++)
      if (!PyUnicode_Check(PyList_GET_ITEM(v, k))) {
        all_str = 0;
        break;
      }
    if (out_u8(o, all_str ? T_LSTR : T_LIST) < 0) return -1;
    if (out_varint(o, (uint64_t)n) < 0) return -1;
    for (Py_ssize_t k = 0; k < n; k++) {
      PyObject *it = PyList_GET_ITEM(v, k);
      if (all_str ? enc_str_body(o, it) < 0
                  : enc_value(o, it, depth + 1) < 0)
        return -1;
    }
    return 0;
  }
  if (PyDict_Check(v)) {
    /* All-numeric (non-bool) values keep the compact T_DSF float map
     * (the v1 layout for the resources field — ints become floats,
     * exactly as before); mixed values take the generic map, which
     * preserves each value's type. */
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    int all_num = 1;
    while (PyDict_Next(v, &pos, &key, &val)) {
      if (!PyUnicode_Check(key)) {
        PyErr_SetString(PyExc_TypeError, "dict keys must be str");
        return -1;
      }
      if (!PyFloat_Check(val) && !(PyLong_Check(val) && !PyBool_Check(val)))
        all_num = 0;
    }
    if (out_u8(o, all_num ? T_DSF : T_MAP) < 0) return -1;
    if (out_varint(o, (uint64_t)PyDict_GET_SIZE(v)) < 0) return -1;
    pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
      if (enc_str_body(o, key) < 0) return -1;
      if (all_num) {
        double d;
        if (PyFloat_Check(val))
          d = PyFloat_AS_DOUBLE(val);
        else {
          d = PyLong_AsDouble(val);
          if (d == -1.0 && PyErr_Occurred()) return -1;
        }
        if (out_bytes(o, (const char *)&d, 8) < 0) return -1;
      } else {
        if (enc_value(o, val, depth + 1) < 0) return -1;
      }
    }
    return 0;
  }
  if (PyTuple_Check(v)) {
    if (PyTuple_GET_SIZE(v) == 2 && PyUnicode_Check(PyTuple_GET_ITEM(v, 0)) &&
        PyLong_Check(PyTuple_GET_ITEM(v, 1)) &&
        !PyBool_Check(PyTuple_GET_ITEM(v, 1))) {
      int64_t i = PyLong_AsLongLong(PyTuple_GET_ITEM(v, 1));
      if (i == -1 && PyErr_Occurred()) return -1;
      if (out_u8(o, T_PAIR_SI) < 0) return -1;
      if (enc_str_body(o, PyTuple_GET_ITEM(v, 0)) < 0) return -1;
      return out_varint(o, zigzag(i));
    }
    Py_ssize_t n = PyTuple_GET_SIZE(v);
    if (out_u8(o, T_TUPLE) < 0) return -1;
    if (out_varint(o, (uint64_t)n) < 0) return -1;
    for (Py_ssize_t k = 0; k < n; k++)
      if (enc_value(o, PyTuple_GET_ITEM(v, k), depth + 1) < 0) return -1;
    return 0;
  }
  PyErr_Format(PyExc_TypeError, "specenc: unsupported value type %s",
               Py_TYPE(v)->tp_name);
  return -1;
}

/* ---- decode ---- */

typedef struct {
  const char *p;
  const char *end;
} In;

static int in_u8(In *in, uint8_t *out) {
  if (in->p >= in->end) {
    PyErr_SetString(PyExc_ValueError, "specenc: truncated");
    return -1;
  }
  *out = (uint8_t)*in->p++;
  return 0;
}

static int in_varint(In *in, uint64_t *out) {
  uint64_t v = 0;
  int shift = 0;
  for (;;) {
    uint8_t b;
    if (in_u8(in, &b) < 0) return -1;
    v |= ((uint64_t)(b & 0x7F)) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 63) {
      PyErr_SetString(PyExc_ValueError, "specenc: varint overflow");
      return -1;
    }
  }
  *out = v;
  return 0;
}

static int in_span(In *in, uint64_t n, const char **out) {
  if ((uint64_t)(in->end - in->p) < n) {
    PyErr_SetString(PyExc_ValueError, "specenc: truncated");
    return -1;
  }
  *out = in->p;
  in->p += n;
  return 0;
}

static PyObject *dec_str(In *in) {
  uint64_t n;
  const char *p;
  if (in_varint(in, &n) < 0 || in_span(in, n, &p) < 0) return NULL;
  return PyUnicode_DecodeUTF8(p, (Py_ssize_t)n, "strict");
}

/* Preallocating containers from a length prefix lets a corrupt frame
 * demand petabytes; every element costs >= min_per bytes, so a count
 * exceeding the remaining buffer is provably truncation/corruption. */
static int in_count(In *in, uint64_t *n, uint64_t min_per) {
  if (in_varint(in, n) < 0) return -1;
  if (min_per && *n > (uint64_t)(in->end - in->p) / min_per) {
    PyErr_SetString(PyExc_ValueError, "specenc: implausible count");
    return -1;
  }
  return 0;
}

static PyObject *dec_value(In *in, int depth) {
  uint8_t tag;
  if (depth > MAX_DEPTH) {
    PyErr_SetString(PyExc_ValueError, "specenc: nesting too deep");
    return NULL;
  }
  if (in_u8(in, &tag) < 0) return NULL;
  switch (tag) {
    case T_NONE:
      Py_RETURN_NONE;
    case T_TRUE:
      Py_RETURN_TRUE;
    case T_FALSE:
      Py_RETURN_FALSE;
    case T_STR:
      return dec_str(in);
    case T_BYTES: {
      uint64_t n;
      const char *p;
      if (in_varint(in, &n) < 0 || in_span(in, n, &p) < 0) return NULL;
      return PyBytes_FromStringAndSize(p, (Py_ssize_t)n);
    }
    case T_INT: {
      uint64_t v;
      if (in_varint(in, &v) < 0) return NULL;
      return PyLong_FromLongLong(unzigzag(v));
    }
    case T_FLOAT: {
      const char *p;
      double d;
      if (in_span(in, 8, &p) < 0) return NULL;
      memcpy(&d, p, 8);
      return PyFloat_FromDouble(d);
    }
    case T_LSTR:
    case T_LIST:
    case T_TUPLE: {
      uint64_t n;
      if (in_count(in, &n, 1) < 0) return NULL;
      PyObject *lst = (tag == T_TUPLE) ? PyTuple_New((Py_ssize_t)n)
                                       : PyList_New((Py_ssize_t)n);
      if (!lst) return NULL;
      for (uint64_t k = 0; k < n; k++) {
        PyObject *s = (tag == T_LSTR) ? dec_str(in)
                                      : dec_value(in, depth + 1);
        if (!s) {
          Py_DECREF(lst);
          return NULL;
        }
        if (tag == T_TUPLE)
          PyTuple_SET_ITEM(lst, (Py_ssize_t)k, s);
        else
          PyList_SET_ITEM(lst, (Py_ssize_t)k, s);
      }
      return lst;
    }
    case T_MAP: {
      uint64_t n;
      if (in_count(in, &n, 2) < 0) return NULL;
      PyObject *d = PyDict_New();
      if (!d) return NULL;
      for (uint64_t k = 0; k < n; k++) {
        PyObject *key = dec_str(in);
        PyObject *val = key ? dec_value(in, depth + 1) : NULL;
        if (!val || PyDict_SetItem(d, key, val) < 0) {
          Py_XDECREF(key);
          Py_XDECREF(val);
          Py_DECREF(d);
          return NULL;
        }
        Py_DECREF(key);
        Py_DECREF(val);
      }
      return d;
    }
    case T_DSF: {
      uint64_t n;
      if (in_count(in, &n, 9) < 0) return NULL;
      PyObject *d = PyDict_New();
      if (!d) return NULL;
      for (uint64_t k = 0; k < n; k++) {
        PyObject *key = dec_str(in);
        if (!key) {
          Py_DECREF(d);
          return NULL;
        }
        const char *p;
        double val;
        if (in_span(in, 8, &p) < 0) {
          Py_DECREF(key);
          Py_DECREF(d);
          return NULL;
        }
        memcpy(&val, p, 8);
        PyObject *f = PyFloat_FromDouble(val);
        if (!f || PyDict_SetItem(d, key, f) < 0) {
          Py_XDECREF(f);
          Py_DECREF(key);
          Py_DECREF(d);
          return NULL;
        }
        Py_DECREF(key);
        Py_DECREF(f);
      }
      return d;
    }
    case T_PAIR_SI: {
      PyObject *s = dec_str(in);
      if (!s) return NULL;
      uint64_t v;
      if (in_varint(in, &v) < 0) {
        Py_DECREF(s);
        return NULL;
      }
      PyObject *i = PyLong_FromLongLong(unzigzag(v));
      if (!i) {
        Py_DECREF(s);
        return NULL;
      }
      PyObject *t = PyTuple_Pack(2, s, i);
      Py_DECREF(s);
      Py_DECREF(i);
      return t;
    }
    default:
      PyErr_Format(PyExc_ValueError, "specenc: bad tag %d", (int)tag);
      return NULL;
  }
}

/* ---- module functions ---- */

static PyObject *specenc_pack(PyObject *self, PyObject *arg) {
  if (!PyTuple_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "pack() expects a tuple");
    return NULL;
  }
  Out o = {0};
  Py_ssize_t n = PyTuple_GET_SIZE(arg);
  if (out_u8(&o, MAGIC) < 0 || out_u8(&o, VERSION) < 0 ||
      out_varint(&o, (uint64_t)n) < 0)
    goto fail;
  for (Py_ssize_t k = 0; k < n; k++)
    if (enc_value(&o, PyTuple_GET_ITEM(arg, k), 0) < 0) goto fail;
  {
    PyObject *res = PyBytes_FromStringAndSize(o.buf, o.len);
    PyMem_Free(o.buf);
    return res;
  }
fail:
  PyMem_Free(o.buf);
  return NULL;
}

static PyObject *specenc_unpack(PyObject *self, PyObject *arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  In in = {(const char *)view.buf, (const char *)view.buf + view.len};
  uint8_t magic, version;
  uint64_t n;
  PyObject *tup = NULL;
  if (in_u8(&in, &magic) < 0 || in_u8(&in, &version) < 0) goto done;
  if (magic != MAGIC || version != VERSION) {
    PyErr_SetString(PyExc_ValueError, "specenc: bad magic/version");
    goto done;
  }
  if (in_varint(&in, &n) < 0) goto done;
  if (n > 4096) {
    PyErr_SetString(PyExc_ValueError, "specenc: implausible field count");
    goto done;
  }
  tup = PyTuple_New((Py_ssize_t)n);
  if (!tup) goto done;
  for (uint64_t k = 0; k < n; k++) {
    PyObject *v = dec_value(&in, 0);
    if (!v) {
      Py_CLEAR(tup);
      goto done;
    }
    PyTuple_SET_ITEM(tup, (Py_ssize_t)k, v);
  }
done:
  PyBuffer_Release(&view);
  return tup;
}

static PyObject *specenc_pack_value(PyObject *self, PyObject *arg) {
  Out o = {0};
  if (enc_value(&o, arg, 0) < 0) {
    PyMem_Free(o.buf);
    return NULL;
  }
  PyObject *res = PyBytes_FromStringAndSize(o.buf, o.len);
  PyMem_Free(o.buf);
  return res;
}

static PyObject *specenc_unpack_value(PyObject *self, PyObject *arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  In in = {(const char *)view.buf, (const char *)view.buf + view.len};
  PyObject *v = dec_value(&in, 0);
  if (v && in.p != in.end) {
    /* A decoder that silently ignores trailing bytes would mask a
     * misframed stream; the wire layer treats this as corruption. */
    Py_CLEAR(v);
    PyErr_SetString(PyExc_ValueError, "specenc: trailing bytes");
  }
  PyBuffer_Release(&view);
  return v;
}

static PyMethodDef methods[] = {
    {"pack", specenc_pack, METH_O,
     "pack(tuple) -> bytes: tagged compact encoding"},
    {"unpack", specenc_unpack, METH_O,
     "unpack(bytes) -> tuple: inverse of pack"},
    {"pack_value", specenc_pack_value, METH_O,
     "pack_value(obj) -> bytes: one tagged value, no header"},
    {"unpack_value", specenc_unpack_value, METH_O,
     "unpack_value(bytes) -> obj: inverse of pack_value"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_specenc",
    "compact TaskSpec field codec (C fast path)", -1, methods,
};

PyMODINIT_FUNC PyInit__specenc(void) { return PyModule_Create(&moduledef); }
