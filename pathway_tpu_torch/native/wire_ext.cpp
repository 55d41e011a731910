// Native twin of pathway_tpu_torch/engine/wire.py — the typed binary wire codec
// for the exchange protocol, plus a C-speed delta consolidation pass.
//
// Implements the identical frame format (see wire.py's module docstring,
// which is the spec); rare value types (datetimes, ndarrays, opaque
// objects) are delegated to the registered Python helpers so the two
// codecs cannot drift on the long tail. Built as a CPython extension
// module by native/__init__.py via the system toolchain (the reference
// keeps this layer in Rust: src/engine/dataflow/config.rs bincode
// transport; here C++ per the build environment).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// value tags — must match engine/wire.py
enum Tag : uint8_t {
  TAG_NONE = 0,
  TAG_TRUE = 1,
  TAG_FALSE = 2,
  TAG_INT = 3,
  TAG_BIGINT = 4,
  TAG_FLOAT = 5,
  TAG_STR = 6,
  TAG_BYTES = 7,
  TAG_POINTER = 8,
  TAG_TUPLE = 9,
  TAG_LIST = 10,
  TAG_DICT = 11,
  TAG_JSON = 12,
  TAG_NDARRAY = 13,
  TAG_ERROR = 14,
  TAG_PENDING = 15,
};

enum MsgType : uint8_t {
  MSG_HELLO = 0x01,
  MSG_DATA = 0x02,
  MSG_PUNCT = 0x03,
  MSG_COORD = 0x04,
};

// registered Python objects (set once via register_types)
PyObject *g_pointer_cls = nullptr;   // engine.value.Pointer
PyObject *g_json_cls = nullptr;      // engine.value.Json
PyObject *g_error_obj = nullptr;     // engine.value.ERROR
PyObject *g_error_cls = nullptr;     // engine.value.Error
PyObject *g_pending_obj = nullptr;   // engine.value.Pending
PyObject *g_encode_rare = nullptr;   // wire._native_encode_rare(value)->bytes
PyObject *g_decode_rare = nullptr;   // wire._native_decode_rare(tag, bytes)
PyObject *g_wire_error = nullptr;    // wire.WireError

struct Buf {
  std::vector<uint8_t> d;
  int depth = 0;  // container-nesting recursion guard (mirrors wire.py)
  void put(uint8_t b) { d.push_back(b); }
  void put_raw(const void *p, size_t n) {
    const uint8_t *c = static_cast<const uint8_t *>(p);
    d.insert(d.end(), c, c + n);
  }
  void uvarint(uint64_t n) {
    while (true) {
      uint8_t b = n & 0x7f;
      n >>= 7;
      if (n) {
        put(b | 0x80);
      } else {
        put(b);
        return;
      }
    }
  }
  void zigzag(int64_t n) {
    uvarint((static_cast<uint64_t>(n) << 1) ^
            static_cast<uint64_t>(n >> 63));
  }
  void u32(uint32_t v) { put_raw(&v, 4); }
  void u64(uint64_t v) { put_raw(&v, 8); }
};

// Cap on container-nesting recursion in decode_value: a crafted frame of
// repeated 2-byte nested container headers would otherwise drive
// frame-length-deep C recursion and overflow the stack (must be a
// WireError, never a crash). Mirrors wire.py MAX_DECODE_DEPTH.
constexpr int kMaxDecodeDepth = 128;

struct Reader {
  const uint8_t *p;
  const uint8_t *end;
  PyObject *frame = nullptr;  // borrowed: the whole frame bytes object
  const uint8_t *base = nullptr;
  bool fail = false;
  int depth = 0;

  bool need(size_t n) {
    // fail is sticky: once any read failed, every later read fails too.
    // Otherwise a failed uvarint (returning 0) followed by take(0)
    // yields a valid empty slice and the decoder silently accepts a
    // truncated frame (fuzz-found: 5-byte hello → run_id "").
    if (fail || static_cast<size_t>(end - p) < n) {
      fail = true;
      return false;
    }
    return true;
  }
  uint8_t byte() {
    if (!need(1)) return 0;
    return *p++;
  }
  const uint8_t *take(size_t n) {
    if (!need(n)) return nullptr;
    const uint8_t *r = p;
    p += n;
    return r;
  }
  uint64_t uvarint() {
    // strict u64: a tenth byte may only contribute bit 63 (payload bits
    // above it would be silently shifted out) — mirrors wire.py exactly
    // so both decoders accept/reject the same byte strings
    uint64_t acc = 0;
    int shift = 0;
    while (true) {
      uint8_t b = byte();
      if (fail) return 0;
      if (shift == 63 && (b & 0x7e)) {
        fail = true;
        return 0;
      }
      acc |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return acc;
      shift += 7;
      if (shift > 63) {
        fail = true;
        return 0;
      }
    }
  }
  int64_t zigzag() {
    uint64_t z = uvarint();
    return static_cast<int64_t>((z >> 1) ^ (~(z & 1) + 1));
  }
};

void wire_err(const char *msg) {
  PyErr_SetString(g_wire_error ? g_wire_error : PyExc_ValueError, msg);
}

// 128-bit key <-> 16 bytes via Python int attr "value"
bool encode_key(Buf &out, PyObject *key) {
  PyObject *val = PyObject_GetAttrString(key, "value");
  if (!val) return false;
  uint8_t raw[16];
  if (_PyLong_AsByteArray(reinterpret_cast<PyLongObject *>(val), raw, 16, 1,
                          0) < 0) {
    Py_DECREF(val);
    return false;
  }
  Py_DECREF(val);
  out.put_raw(raw, 16);
  return true;
}

PyObject *decode_key(Reader &r) {
  const uint8_t *raw = r.take(16);
  if (!raw) {
    wire_err("truncated frame (key)");
    return nullptr;
  }
  PyObject *val = _PyLong_FromByteArray(raw, 16, 1, 0);
  if (!val) return nullptr;
  PyObject *ptr = PyObject_CallFunctionObjArgs(g_pointer_cls, val, nullptr);
  Py_DECREF(val);
  return ptr;
}

bool encode_value(Buf &out, PyObject *v);

bool encode_too_deep(Buf &) {
  // surface over-deep values at the producer (mirrors wire.py's
  // encode-side cap) instead of letting the peer die on decode
  wire_err("value nests too deeply; flatten it before sending");
  return false;
}

bool encode_rare(Buf &out, PyObject *v) {
  // python helper returns the already-tagged bytes for rare values
  PyObject *blob = PyObject_CallFunctionObjArgs(g_encode_rare, v, nullptr);
  if (!blob) return false;
  char *raw;
  Py_ssize_t n;
  if (PyBytes_AsStringAndSize(blob, &raw, &n) < 0) {
    Py_DECREF(blob);
    return false;
  }
  out.put_raw(raw, static_cast<size_t>(n));
  Py_DECREF(blob);
  return true;
}

bool encode_value(Buf &out, PyObject *v) {
  if (v == Py_None) {
    out.put(TAG_NONE);
  } else if (v == Py_True) {
    out.put(TAG_TRUE);
  } else if (v == Py_False) {
    out.put(TAG_FALSE);
  } else if (PyLong_CheckExact(v)) {
    int overflow = 0;
    int64_t n = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (!overflow) {
      out.put(TAG_INT);
      out.zigzag(n);
    } else {
      // arbitrary-precision escape
      size_t nbits = _PyLong_NumBits(v);
      size_t nbytes = nbits / 8 + 1;
      std::vector<uint8_t> raw(nbytes);
      if (_PyLong_AsByteArray(reinterpret_cast<PyLongObject *>(v), raw.data(),
                              nbytes, 1, 1) < 0)
        return false;
      out.put(TAG_BIGINT);
      out.uvarint(nbytes);
      out.put_raw(raw.data(), nbytes);
    }
  } else if (PyFloat_CheckExact(v)) {
    double d = PyFloat_AS_DOUBLE(v);
    out.put(TAG_FLOAT);
    out.put_raw(&d, 8);
  } else if (PyUnicode_CheckExact(v)) {
    Py_ssize_t n;
    const char *raw = PyUnicode_AsUTF8AndSize(v, &n);
    if (!raw) return false;
    out.put(TAG_STR);
    out.uvarint(static_cast<uint64_t>(n));
    out.put_raw(raw, static_cast<size_t>(n));
  } else if (PyBytes_CheckExact(v)) {
    char *raw;
    Py_ssize_t n;
    PyBytes_AsStringAndSize(v, &raw, &n);
    out.put(TAG_BYTES);
    out.uvarint(static_cast<uint64_t>(n));
    out.put_raw(raw, static_cast<size_t>(n));
  } else if (Py_TYPE(v) == reinterpret_cast<PyTypeObject *>(g_pointer_cls)) {
    out.put(TAG_POINTER);
    if (!encode_key(out, v)) return false;
  } else if (PyTuple_CheckExact(v)) {
    if (++out.depth > kMaxDecodeDepth) return encode_too_deep(out);
    Py_ssize_t n = PyTuple_GET_SIZE(v);
    out.put(TAG_TUPLE);
    out.uvarint(static_cast<uint64_t>(n));
    for (Py_ssize_t i = 0; i < n; i++)
      if (!encode_value(out, PyTuple_GET_ITEM(v, i))) return false;
    out.depth--;
  } else if (PyList_CheckExact(v)) {
    if (++out.depth > kMaxDecodeDepth) return encode_too_deep(out);
    Py_ssize_t n = PyList_GET_SIZE(v);
    out.put(TAG_LIST);
    out.uvarint(static_cast<uint64_t>(n));
    for (Py_ssize_t i = 0; i < n; i++)
      if (!encode_value(out, PyList_GET_ITEM(v, i))) return false;
    out.depth--;
  } else if (PyDict_CheckExact(v)) {
    if (++out.depth > kMaxDecodeDepth) return encode_too_deep(out);
    out.put(TAG_DICT);
    out.uvarint(static_cast<uint64_t>(PyDict_GET_SIZE(v)));
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &value)) {
      if (!encode_value(out, key)) return false;
      if (!encode_value(out, value)) return false;
    }
    out.depth--;
  } else if (Py_TYPE(v) == reinterpret_cast<PyTypeObject *>(g_json_cls)) {
    if (++out.depth > kMaxDecodeDepth) return encode_too_deep(out);
    PyObject *inner = PyObject_GetAttrString(v, "value");
    if (!inner) return false;
    out.put(TAG_JSON);
    bool ok = encode_value(out, inner);
    Py_DECREF(inner);
    if (!ok) return false;
    out.depth--;
  } else if (v == g_error_obj) {
    out.put(TAG_ERROR);
    out.uvarint(0);  // plain singleton, no trace
  } else if (Py_TYPE(v) == reinterpret_cast<PyTypeObject *>(g_error_cls)) {
    // Error carrying a trace: python encoder writes the payload
    if (!encode_rare(out, v)) return false;
  } else if (v == g_pending_obj) {
    out.put(TAG_PENDING);
  } else {
    // datetimes, ndarrays, np scalars, opaque objects: python helper
    if (!encode_rare(out, v)) return false;
  }
  return true;
}

PyObject *decode_value(Reader &r);

struct DepthGuard {
  Reader &r;
  bool ok;
  explicit DepthGuard(Reader &rr) : r(rr), ok(++rr.depth <= kMaxDecodeDepth) {
    if (!ok) wire_err("frame nesting too deep");
  }
  ~DepthGuard() { r.depth--; }
};

PyObject *decode_rare(Reader &r, uint8_t tag) {
  // hand (tag, whole frame, offset) to python — zero-copy; it returns
  // (value, bytes_consumed_after_tag)
  if (!r.frame) {
    wire_err("rare value outside a frame context");
    return nullptr;
  }
  PyObject *res = PyObject_CallFunction(
      g_decode_rare, "iOn", (int)tag, r.frame,
      static_cast<Py_ssize_t>(r.p - r.base));
  if (!res) return nullptr;
  PyObject *value = PyTuple_GetItem(res, 0);
  PyObject *consumed = PyTuple_GetItem(res, 1);
  if (!value || !consumed) {
    Py_DECREF(res);
    return nullptr;
  }
  long n = PyLong_AsLong(consumed);
  if (n < 0 || n > (r.end - r.p)) {
    Py_DECREF(res);
    wire_err("rare decoder consumed out of range");
    return nullptr;
  }
  r.p += n;
  Py_INCREF(value);
  Py_DECREF(res);
  return value;
}

PyObject *decode_value(Reader &r) {
  uint8_t tag = r.byte();
  if (r.fail) {
    wire_err("truncated frame (tag)");
    return nullptr;
  }
  switch (tag) {
    case TAG_NONE:
      Py_RETURN_NONE;
    case TAG_TRUE:
      Py_RETURN_TRUE;
    case TAG_FALSE:
      Py_RETURN_FALSE;
    case TAG_INT: {
      int64_t n = r.zigzag();
      if (r.fail) {
        wire_err("truncated frame (int)");
        return nullptr;
      }
      return PyLong_FromLongLong(n);
    }
    case TAG_BIGINT: {
      uint64_t n = r.uvarint();
      const uint8_t *raw = r.take(n);
      if (!raw) {
        wire_err("truncated frame (bigint)");
        return nullptr;
      }
      return _PyLong_FromByteArray(raw, n, 1, 1);
    }
    case TAG_FLOAT: {
      const uint8_t *raw = r.take(8);
      if (!raw) {
        wire_err("truncated frame (float)");
        return nullptr;
      }
      double d;
      std::memcpy(&d, raw, 8);
      return PyFloat_FromDouble(d);
    }
    case TAG_STR: {
      uint64_t n = r.uvarint();
      const uint8_t *raw = r.take(n);
      if (!raw) {
        wire_err("truncated frame (str)");
        return nullptr;
      }
      return PyUnicode_DecodeUTF8(reinterpret_cast<const char *>(raw), n,
                                  nullptr);
    }
    case TAG_BYTES: {
      uint64_t n = r.uvarint();
      const uint8_t *raw = r.take(n);
      if (!raw) {
        wire_err("truncated frame (bytes)");
        return nullptr;
      }
      return PyBytes_FromStringAndSize(reinterpret_cast<const char *>(raw),
                                       n);
    }
    case TAG_POINTER:
      return decode_key(r);
    case TAG_TUPLE: {
      DepthGuard dg(r);
      if (!dg.ok) return nullptr;
      uint64_t n = r.uvarint();
      // each element is >= 1 byte
      if (r.fail || n > static_cast<uint64_t>(r.end - r.p)) {
        wire_err("truncated frame (tuple)");
        return nullptr;
      }
      PyObject *t = PyTuple_New(n);
      if (!t) return nullptr;
      for (uint64_t i = 0; i < n; i++) {
        PyObject *x = decode_value(r);
        if (!x) {
          Py_DECREF(t);
          return nullptr;
        }
        PyTuple_SET_ITEM(t, i, x);
      }
      return t;
    }
    case TAG_LIST: {
      DepthGuard dg(r);
      if (!dg.ok) return nullptr;
      uint64_t n = r.uvarint();
      if (r.fail || n > static_cast<uint64_t>(r.end - r.p)) {
        wire_err("truncated frame (list)");
        return nullptr;
      }
      PyObject *t = PyList_New(n);
      if (!t) return nullptr;
      for (uint64_t i = 0; i < n; i++) {
        PyObject *x = decode_value(r);
        if (!x) {
          Py_DECREF(t);
          return nullptr;
        }
        PyList_SET_ITEM(t, i, x);
      }
      return t;
    }
    case TAG_DICT: {
      DepthGuard dg(r);
      if (!dg.ok) return nullptr;
      uint64_t n = r.uvarint();
      // each entry is a key + value, >= 2 bytes
      if (r.fail || n > static_cast<uint64_t>(r.end - r.p) / 2) {
        wire_err("truncated frame (dict)");
        return nullptr;
      }
      PyObject *d = PyDict_New();
      if (!d) return nullptr;
      for (uint64_t i = 0; i < n; i++) {
        PyObject *k = decode_value(r);
        if (!k) {
          Py_DECREF(d);
          return nullptr;
        }
        PyObject *v = decode_value(r);
        if (!v) {
          Py_DECREF(k);
          Py_DECREF(d);
          return nullptr;
        }
        if (PyDict_SetItem(d, k, v) < 0) {
          Py_DECREF(k);
          Py_DECREF(v);
          Py_DECREF(d);
          if (PyErr_ExceptionMatches(PyExc_TypeError)) {
            // unhashable decoded key: a malformed frame, not a crash
            PyErr_Clear();
            wire_err("bad dict key in frame (unhashable)");
          }
          return nullptr;
        }
        Py_DECREF(k);
        Py_DECREF(v);
      }
      return d;
    }
    case TAG_JSON: {
      DepthGuard dg(r);
      if (!dg.ok) return nullptr;
      PyObject *inner = decode_value(r);
      if (!inner) return nullptr;
      PyObject *j =
          PyObject_CallFunctionObjArgs(g_json_cls, inner, nullptr);
      Py_DECREF(inner);
      return j;
    }
    case TAG_ERROR: {
      uint64_t n = r.uvarint();
      if (r.fail) {
        wire_err("truncated frame (error)");
        return nullptr;
      }
      if (n == 0) {
        Py_INCREF(g_error_obj);
        return g_error_obj;
      }
      const uint8_t *raw = r.take(n);
      if (!raw) {
        wire_err("truncated frame (error trace)");
        return nullptr;
      }
      PyObject *trace = PyUnicode_DecodeUTF8(
          reinterpret_cast<const char *>(raw), n, nullptr);
      if (!trace) {
        PyErr_Clear();
        wire_err("bad error trace (invalid utf-8)");
        return nullptr;
      }
      PyObject *err =
          PyObject_CallFunctionObjArgs(g_error_cls, trace, nullptr);
      Py_DECREF(trace);
      return err;
    }
    case TAG_PENDING:
      Py_INCREF(g_pending_obj);
      return g_pending_obj;
    default:
      return decode_rare(r, tag);
  }
}

// -- deltas -----------------------------------------------------------------

bool encode_deltas(Buf &out, PyObject *deltas) {
  if (!PyList_CheckExact(deltas)) {
    wire_err("deltas must be a list");
    return false;
  }
  Py_ssize_t n = PyList_GET_SIZE(deltas);
  out.uvarint(static_cast<uint64_t>(n));
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PyList_GET_ITEM(deltas, i);
    if (!PyTuple_CheckExact(d) || PyTuple_GET_SIZE(d) != 3) {
      wire_err("delta must be a (key, values, diff) tuple");
      return false;
    }
    if (!encode_key(out, PyTuple_GET_ITEM(d, 0))) return false;
    PyObject *diff = PyTuple_GET_ITEM(d, 2);
    int64_t diff_n = PyLong_AsLongLong(diff);
    if (diff_n == -1 && PyErr_Occurred()) return false;
    out.zigzag(diff_n);
    PyObject *values = PyTuple_GET_ITEM(d, 1);
    if (!PyTuple_CheckExact(values)) {
      wire_err("delta values must be a tuple");
      return false;
    }
    Py_ssize_t ncols = PyTuple_GET_SIZE(values);
    out.uvarint(static_cast<uint64_t>(ncols));
    for (Py_ssize_t c = 0; c < ncols; c++)
      if (!encode_value(out, PyTuple_GET_ITEM(values, c))) return false;
  }
  return true;
}

PyObject *decode_deltas(Reader &r) {
  uint64_t n = r.uvarint();
  // each delta is at least key(16)+diff(1)+ncols(1) = 18 bytes
  if (r.fail || n > static_cast<uint64_t>(r.end - r.p) / 18) {
    wire_err("truncated frame (deltas)");
    return nullptr;
  }
  PyObject *out = PyList_New(n);
  if (!out) return nullptr;
  for (uint64_t i = 0; i < n; i++) {
    PyObject *key = decode_key(r);
    if (!key) {
      Py_DECREF(out);
      return nullptr;
    }
    int64_t diff = r.zigzag();
    uint64_t ncols = r.uvarint();
    // each value is >= 1 byte: bound the tuple allocation by the bytes
    // actually present (a lying ncols would otherwise drive a huge
    // PyTuple_New)
    if (r.fail || ncols > static_cast<uint64_t>(r.end - r.p)) {
      wire_err("truncated frame (delta header)");
      Py_DECREF(key);
      Py_DECREF(out);
      return nullptr;
    }
    PyObject *values = PyTuple_New(ncols);
    if (!values) {
      Py_DECREF(key);
      Py_DECREF(out);
      return nullptr;
    }
    for (uint64_t c = 0; c < ncols; c++) {
      PyObject *v = decode_value(r);
      if (!v) {
        Py_DECREF(values);
        Py_DECREF(key);
        Py_DECREF(out);
        return nullptr;
      }
      PyTuple_SET_ITEM(values, c, v);
    }
    PyObject *delta = PyTuple_New(3);
    if (!delta) {
      Py_DECREF(values);
      Py_DECREF(key);
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(delta, 0, key);
    PyTuple_SET_ITEM(delta, 1, values);
    PyTuple_SET_ITEM(delta, 2, PyLong_FromLongLong(diff));
    PyList_SET_ITEM(out, i, delta);
  }
  return out;
}

// -- module functions -------------------------------------------------------

PyObject *py_register_types(PyObject *, PyObject *args) {
  PyObject *pointer_cls, *json_cls, *error_obj, *error_cls, *pending_obj,
      *encode_rare_fn, *decode_rare_fn, *wire_error;
  if (!PyArg_ParseTuple(args, "OOOOOOOO", &pointer_cls, &json_cls, &error_obj,
                        &error_cls, &pending_obj, &encode_rare_fn,
                        &decode_rare_fn, &wire_error))
    return nullptr;
#define SET(g, v) \
  Py_XDECREF(g);  \
  Py_INCREF(v);   \
  g = v;
  SET(g_pointer_cls, pointer_cls)
  SET(g_json_cls, json_cls)
  SET(g_error_obj, error_obj)
  SET(g_error_cls, error_cls)
  SET(g_pending_obj, pending_obj)
  SET(g_encode_rare, encode_rare_fn)
  SET(g_decode_rare, decode_rare_fn)
  SET(g_wire_error, wire_error)
#undef SET
  Py_RETURN_NONE;
}

// Message-body encoder shared by encode_message (bare blob) and
// encode_frame (length-prefixed); appends to whatever `out` already holds.
bool encode_message_body(Buf &out, PyObject *arg) {
  if (!PyTuple_Check(arg) || PyTuple_GET_SIZE(arg) < 1) {
    wire_err("message must be a tuple");
    return false;
  }
  PyObject *kind = PyTuple_GET_ITEM(arg, 0);
  const char *k = PyUnicode_AsUTF8(kind);
  if (!k) return false;
  if (std::strcmp(k, "data") == 0 && PyTuple_GET_SIZE(arg) == 4) {
    out.put(MSG_DATA);
    long channel = PyLong_AsLong(PyTuple_GET_ITEM(arg, 1));
    if (channel == -1 && PyErr_Occurred()) return false;
    out.u32(static_cast<uint32_t>(channel));
    int64_t time = PyLong_AsLongLong(PyTuple_GET_ITEM(arg, 2));
    if (time == -1 && PyErr_Occurred()) return false;
    out.zigzag(time);
    if (!encode_deltas(out, PyTuple_GET_ITEM(arg, 3))) return false;
  } else if (std::strcmp(k, "punct") == 0 && PyTuple_GET_SIZE(arg) == 3) {
    out.put(MSG_PUNCT);
    long channel = PyLong_AsLong(PyTuple_GET_ITEM(arg, 1));
    if (channel == -1 && PyErr_Occurred()) return false;
    out.u32(static_cast<uint32_t>(channel));
    int64_t time = PyLong_AsLongLong(PyTuple_GET_ITEM(arg, 2));
    if (time == -1 && PyErr_Occurred()) return false;
    out.zigzag(time);
  } else if (std::strcmp(k, "coord") == 0 && PyTuple_GET_SIZE(arg) == 3) {
    out.put(MSG_COORD);
    uint64_t round_no =
        PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(arg, 1));
    if (PyErr_Occurred()) return false;
    out.u64(round_no);
    if (!encode_value(out, PyTuple_GET_ITEM(arg, 2))) return false;
  } else if (std::strcmp(k, "hello") == 0 && PyTuple_GET_SIZE(arg) == 3) {
    out.put(MSG_HELLO);
    long worker = PyLong_AsLong(PyTuple_GET_ITEM(arg, 1));
    if (worker == -1 && PyErr_Occurred()) return false;
    out.u32(static_cast<uint32_t>(worker));
    Py_ssize_t n;
    const char *run_id =
        PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(arg, 2), &n);
    if (!run_id) return false;
    out.uvarint(static_cast<uint64_t>(n));
    out.put_raw(run_id, static_cast<size_t>(n));
  } else {
    wire_err("unknown message kind");
    return false;
  }
  return true;
}

PyObject *py_encode_message(PyObject *, PyObject *arg) {
  Buf out;
  if (!encode_message_body(out, arg)) return nullptr;
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(out.d.data()),
      static_cast<Py_ssize_t>(out.d.size()));
}

// encode_frame(msg) -> the full length-prefixed wire frame in one pass:
// the 4-byte big-endian length slot is reserved up front and patched
// after the body lands, so there is no `_LEN.pack(n) + blob` concat copy.
PyObject *py_encode_frame(PyObject *, PyObject *arg) {
  Buf out;
  out.d.resize(4);
  if (!encode_message_body(out, arg)) return nullptr;
  size_t body = out.d.size() - 4;
  if (body > 0xFFFFFFFFu) {
    wire_err("frame too large");
    return nullptr;
  }
  uint32_t n = static_cast<uint32_t>(body);
  out.d[0] = static_cast<uint8_t>(n >> 24);
  out.d[1] = static_cast<uint8_t>(n >> 16);
  out.d[2] = static_cast<uint8_t>(n >> 8);
  out.d[3] = static_cast<uint8_t>(n);
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(out.d.data()),
      static_cast<Py_ssize_t>(out.d.size()));
}

PyObject *py_decode_message(PyObject *, PyObject *arg) {
  char *raw;
  Py_ssize_t n;
  if (PyBytes_AsStringAndSize(arg, &raw, &n) < 0) return nullptr;
  Reader r;
  r.p = reinterpret_cast<const uint8_t *>(raw);
  r.end = r.p + n;
  r.frame = arg;
  r.base = r.p;
  uint8_t kind = r.byte();
  if (r.fail) {
    wire_err("empty frame");
    return nullptr;
  }
  PyObject *msg = nullptr;
  if (kind == MSG_DATA) {
    const uint8_t *ch = r.take(4);
    if (!ch) {
      wire_err("truncated frame (channel)");
      return nullptr;
    }
    uint32_t channel;
    std::memcpy(&channel, ch, 4);
    int64_t time = r.zigzag();
    if (r.fail) {
      wire_err("truncated frame (time)");
      return nullptr;
    }
    PyObject *deltas = decode_deltas(r);
    if (!deltas) return nullptr;
    msg = Py_BuildValue("(sILN)", "data", (unsigned int)channel,
                        (long long)time, deltas);
  } else if (kind == MSG_PUNCT) {
    const uint8_t *ch = r.take(4);
    if (!ch) {
      wire_err("truncated frame (channel)");
      return nullptr;
    }
    uint32_t channel;
    std::memcpy(&channel, ch, 4);
    int64_t time = r.zigzag();
    if (r.fail) {
      wire_err("truncated frame (time)");
      return nullptr;
    }
    msg = Py_BuildValue("(sIL)", "punct", (unsigned int)channel,
                        (long long)time);
  } else if (kind == MSG_COORD) {
    const uint8_t *rd = r.take(8);
    if (!rd) {
      wire_err("truncated frame (round)");
      return nullptr;
    }
    uint64_t round_no;
    std::memcpy(&round_no, rd, 8);
    PyObject *payload = decode_value(r);
    if (!payload) return nullptr;
    msg = Py_BuildValue("(sKN)", "coord", (unsigned long long)round_no,
                        payload);
  } else if (kind == MSG_HELLO) {
    const uint8_t *w = r.take(4);
    if (!w) {
      wire_err("truncated frame (worker)");
      return nullptr;
    }
    uint32_t worker;
    std::memcpy(&worker, w, 4);
    uint64_t len = r.uvarint();
    const uint8_t *rid = r.take(len);
    if (!rid) {
      wire_err("truncated frame (run id)");
      return nullptr;
    }
    PyObject *rid_str = PyUnicode_DecodeUTF8(
        reinterpret_cast<const char *>(rid), static_cast<Py_ssize_t>(len),
        nullptr);
    if (!rid_str) {
      PyErr_Clear();
      wire_err("bad run id (invalid utf-8)");
      return nullptr;
    }
    msg = Py_BuildValue("(sIN)", "hello", (unsigned int)worker, rid_str);
  } else {
    wire_err("unknown message type");
    return nullptr;
  }
  if (!msg) return nullptr;
  if (r.p != r.end) {
    Py_DECREF(msg);
    wire_err("trailing bytes in frame");
    return nullptr;
  }
  return msg;
}

// C-speed consolidation: sum diffs of identical (key, values), drop zero
// nets, retractions before insertions (mirrors stream.consolidate's
// hashable fast path; raises TypeError for the caller's fallback on
// unhashable values).
PyObject *py_consolidate(PyObject *, PyObject *arg) {
  if (!PyList_CheckExact(arg)) {
    PyErr_SetString(PyExc_TypeError, "consolidate expects a list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  // validate shape up front: every element must be a (key, values, diff)
  // 3-tuple with an in-range int diff, so the loops below may use the
  // unchecked GET_ITEM / conversion paths safely. The same pass records
  // whether the batch is all-insert (the bulk-ingest fast-path test).
  bool all_insert = true;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PyList_GET_ITEM(arg, i);
    if (!PyTuple_CheckExact(d) || PyTuple_GET_SIZE(d) != 3) {
      PyErr_SetString(PyExc_TypeError,
                      "consolidate expects (key, values, diff) 3-tuples");
      return nullptr;
    }
    int overflow = 0;
    long long dv = PyLong_AsLongLongAndOverflow(PyTuple_GET_ITEM(d, 2),
                                                &overflow);
    if (dv == -1 && PyErr_Occurred()) return nullptr;  // non-int diff
    if (overflow) {
      PyErr_SetString(PyExc_TypeError, "consolidate diff out of i64 range");
      return nullptr;
    }
    if (dv < 0) all_insert = false;
  }
  if (all_insert) {
    PyObject *seen = PySet_New(nullptr);
    if (!seen) return nullptr;
    bool distinct = true;
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject *key = PyTuple_GET_ITEM(PyList_GET_ITEM(arg, i), 0);
      int r = PySet_Contains(seen, key);
      if (r < 0) {
        Py_DECREF(seen);
        return nullptr;
      }
      if (r) {
        distinct = false;
        break;
      }
      if (PySet_Add(seen, key) < 0) {
        Py_DECREF(seen);
        return nullptr;
      }
    }
    Py_DECREF(seen);
    if (distinct) {
      Py_INCREF(arg);
      return arg;
    }
  }
  PyObject *acc = PyDict_New();  // (key, values) -> summed diff
  if (!acc) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PyList_GET_ITEM(arg, i);
    PyObject *g = PyTuple_New(2);
    if (!g) {
      Py_DECREF(acc);
      return nullptr;
    }
    PyObject *key = PyTuple_GET_ITEM(d, 0);
    PyObject *values = PyTuple_GET_ITEM(d, 1);
    Py_INCREF(key);
    Py_INCREF(values);
    PyTuple_SET_ITEM(g, 0, key);
    PyTuple_SET_ITEM(g, 1, values);
    PyObject *prev = PyDict_GetItemWithError(acc, g);
    if (!prev && PyErr_Occurred()) {  // unhashable -> caller's fallback
      Py_DECREF(g);
      Py_DECREF(acc);
      return nullptr;
    }
    long long sum = PyLong_AsLongLong(PyTuple_GET_ITEM(d, 2));
    if (prev && __builtin_add_overflow(sum, PyLong_AsLongLong(prev), &sum)) {
      // i64 sum overflow: hand the batch to the caller's arbitrary-
      // precision python fallback rather than wrapping silently
      PyErr_SetString(PyExc_TypeError, "consolidate diff sum overflows i64");
      Py_DECREF(g);
      Py_DECREF(acc);
      return nullptr;
    }
    PyObject *sum_obj = PyLong_FromLongLong(sum);
    if (!sum_obj || PyDict_SetItem(acc, g, sum_obj) < 0) {
      Py_XDECREF(sum_obj);
      Py_DECREF(g);
      Py_DECREF(acc);
      return nullptr;
    }
    Py_DECREF(sum_obj);
    Py_DECREF(g);
  }
  PyObject *neg = PyList_New(0);
  PyObject *pos = PyList_New(0);
  if (!neg || !pos) {
    Py_XDECREF(neg);
    Py_XDECREF(pos);
    Py_DECREF(acc);
    return nullptr;
  }
  PyObject *g, *diff;
  Py_ssize_t pos_i = 0;
  while (PyDict_Next(acc, &pos_i, &g, &diff)) {
    long long dv = PyLong_AsLongLong(diff);
    if (dv == 0) continue;
    PyObject *delta = PyTuple_New(3);
    if (!delta) {
      Py_DECREF(neg);
      Py_DECREF(pos);
      Py_DECREF(acc);
      return nullptr;
    }
    PyObject *key = PyTuple_GET_ITEM(g, 0);
    PyObject *values = PyTuple_GET_ITEM(g, 1);
    Py_INCREF(key);
    Py_INCREF(values);
    Py_INCREF(diff);
    PyTuple_SET_ITEM(delta, 0, key);
    PyTuple_SET_ITEM(delta, 1, values);
    PyTuple_SET_ITEM(delta, 2, diff);
    if (PyList_Append(dv < 0 ? neg : pos, delta) < 0) {
      Py_DECREF(delta);
      Py_DECREF(neg);
      Py_DECREF(pos);
      Py_DECREF(acc);
      return nullptr;
    }
    Py_DECREF(delta);
  }
  Py_DECREF(acc);
  PyObject *result = PySequence_InPlaceConcat(neg, pos);
  Py_DECREF(pos);
  if (!result) {
    Py_DECREF(neg);
    return nullptr;
  }
  return result;  // == neg (in-place concat returns it)
}

// -- bulk Pointer construction ----------------------------------------------
//
// Pointer is a __slots__ class; CPython lays its slots out at fixed
// offsets reachable through the member descriptors in tp_dict. Building
// the objects with tp_alloc + direct slot stores skips the __init__
// bytecode — the per-row key-creation cost that dominates bulk ingest.
// The python side verifies one object built this way against a normally
// constructed Pointer before enabling the path.

Py_ssize_t slot_offset(PyTypeObject *tp, const char *name) {
  PyObject *descr = PyDict_GetItemString(tp->tp_dict, name);
  if (!descr || Py_TYPE(descr) != &PyMemberDescr_Type) return -1;
  PyMemberDef *m = reinterpret_cast<PyMemberDescrObject *>(descr)->d_member;
  if (!m || m->type != T_OBJECT_EX) return -1;
  return m->offset;
}

// Shared slot layout for direct Pointer construction (resolved per call;
// the probe on the Python side guards against layout drift).
struct PointerSlots {
  PyTypeObject *tp;
  Py_ssize_t off_value;
  Py_ssize_t off_origin;
  Py_ssize_t off_h;

  bool resolve() {
    tp = reinterpret_cast<PyTypeObject *>(g_pointer_cls);
    off_value = slot_offset(tp, "value");
    off_origin = slot_offset(tp, "_origin");
    off_h = slot_offset(tp, "_h");
    if (off_value < 0 || off_origin < 0 || off_h < 0) {
      PyErr_SetString(PyExc_TypeError, "Pointer slot layout not recognized");
      return false;
    }
    return true;
  }

  // Build one Pointer from a 16-byte little-endian value; nullptr on error.
  PyObject *build(const uint8_t raw[16]) const {
    uint64_t lo, hi;
    std::memcpy(&lo, raw, 8);
    std::memcpy(&hi, raw + 8, 8);
    PyObject *val = hi ? _PyLong_FromByteArray(raw, 16, 1, 0)
                       : PyLong_FromUnsignedLongLong(lo);
    if (!val) return nullptr;
    Py_hash_t h;
    if (static_cast<uint64_t>(_PyHASH_MODULUS) == ((1ULL << 61) - 1)) {
      // hash(v) of a non-negative int is v mod (2^61 - 1) on 64-bit
      // CPython; computing it from the raw limbs skips a Python call
      // per Pointer (the loader's probe compares against hash()).
      unsigned __int128 v =
          (static_cast<unsigned __int128>(hi) << 64) | lo;
      h = static_cast<Py_hash_t>(
          static_cast<uint64_t>(v % ((1ULL << 61) - 1)));
    } else {
      h = PyObject_Hash(val);
      if (h == -1 && PyErr_Occurred()) {
        Py_DECREF(val);
        return nullptr;
      }
    }
    PyObject *h_obj = PyLong_FromSsize_t(h);
    if (!h_obj) {
      Py_DECREF(val);
      return nullptr;
    }
    PyObject *obj = tp->tp_alloc(tp, 0);
    if (!obj) {
      Py_DECREF(val);
      Py_DECREF(h_obj);
      return nullptr;
    }
    *reinterpret_cast<PyObject **>(reinterpret_cast<char *>(obj) +
                                   off_value) = val;  // steals
    Py_INCREF(Py_None);
    *reinterpret_cast<PyObject **>(reinterpret_cast<char *>(obj) +
                                   off_origin) = Py_None;
    *reinterpret_cast<PyObject **>(reinterpret_cast<char *>(obj) + off_h) =
        h_obj;  // steals
    return obj;
  }
};

// -- blake2b-128 single block (RFC 7693) -------------------------------------
//
// Join output keys must be byte-identical to ref_scalar(lk, rk) — the
// python side hashes b"\x06"+l16+b"\x06"+r16 through hashlib.blake2b with
// digest_size=16. All such messages fit one compression block, so a
// specialized unkeyed single-block compress suffices (verified against
// hashlib by the Python loader before the path is enabled).

const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

#define B2B_G(a, b, c, d, x, y)          \
  do {                                   \
    a = a + b + (x);                     \
    d = rotr64(d ^ a, 32);               \
    c = c + d;                           \
    b = rotr64(b ^ c, 24);               \
    a = a + b + (y);                     \
    d = rotr64(d ^ a, 16);               \
    c = c + d;                           \
    b = rotr64(b ^ c, 63);               \
  } while (0)

// unkeyed blake2b, digest 16 bytes, message length <= 128 (one block)
void blake2b128_single(const uint8_t *msg, size_t len, uint8_t out[16]) {
  uint64_t m[16] = {0};
  std::memcpy(m, msg, len);
  uint64_t v[16];
  for (int i = 0; i < 8; i++) v[i] = B2B_IV[i];
  v[0] ^= 0x01010010ULL;  // digest_length=16, fanout=1, depth=1
  uint64_t h0 = v[0], h1 = v[1];
  for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
  v[12] ^= static_cast<uint64_t>(len);  // t0 = bytes compressed
  v[14] = ~v[14];                       // final-block flag
  for (int r = 0; r < 12; r++) {
    const uint8_t *s = B2B_SIGMA[r];
    B2B_G(v[0], v[4], v[8], v[12], m[s[0]], m[s[1]]);
    B2B_G(v[1], v[5], v[9], v[13], m[s[2]], m[s[3]]);
    B2B_G(v[2], v[6], v[10], v[14], m[s[4]], m[s[5]]);
    B2B_G(v[3], v[7], v[11], v[15], m[s[6]], m[s[7]]);
    B2B_G(v[0], v[5], v[10], v[15], m[s[8]], m[s[9]]);
    B2B_G(v[1], v[6], v[11], v[12], m[s[10]], m[s[11]]);
    B2B_G(v[2], v[7], v[8], v[13], m[s[12]], m[s[13]]);
    B2B_G(v[3], v[4], v[9], v[14], m[s[14]], m[s[15]]);
  }
  h0 ^= v[0] ^ v[8];
  h1 ^= v[1] ^ v[9];
  std::memcpy(out, &h0, 8);
  std::memcpy(out + 8, &h1, 8);
}

// make_pair_pointers(lvals: bytes n*16 LE, rvals: bytes n*16 LE) -> list
//
// The columnar join's output-key kernel: per row, blake2b-128 over the
// 34-byte message \x06+l16+\x06+r16 (identical to ref_scalar(lk, rk))
// and a direct-slot Pointer from the digest.
PyObject *py_make_pair_pointers(PyObject *, PyObject *args) {
  Py_buffer lvals, rvals;
  if (!PyArg_ParseTuple(args, "y*y*", &lvals, &rvals)) return nullptr;
  if (lvals.len % 16 != 0 || lvals.len != rvals.len) {
    PyBuffer_Release(&lvals);
    PyBuffer_Release(&rvals);
    PyErr_SetString(PyExc_ValueError,
                    "lvals/rvals must be equal-length 16-byte-aligned");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) {
    PyBuffer_Release(&lvals);
    PyBuffer_Release(&rvals);
    return nullptr;
  }
  Py_ssize_t n = lvals.len / 16;
  const uint8_t *lp = static_cast<const uint8_t *>(lvals.buf);
  const uint8_t *rp = static_cast<const uint8_t *>(rvals.buf);
  PyObject *out = PyList_New(n);
  if (!out) {
    PyBuffer_Release(&lvals);
    PyBuffer_Release(&rvals);
    return nullptr;
  }
  uint8_t msg[34];
  uint8_t dig[16];
  msg[0] = 0x06;
  msg[17] = 0x06;
  for (Py_ssize_t i = 0; i < n; i++) {
    std::memcpy(msg + 1, lp + i * 16, 16);
    std::memcpy(msg + 18, rp + i * 16, 16);
    blake2b128_single(msg, 34, dig);
    PyObject *obj = slots.build(dig);
    if (!obj) {
      PyBuffer_Release(&lvals);
      PyBuffer_Release(&rvals);
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, obj);
  }
  PyBuffer_Release(&lvals);
  PyBuffer_Release(&rvals);
  return out;
}

// make_pointers_u128(vals: bytes n*16 LE) -> list
//
// Bulk Pointer construction from precomputed 128-bit values with VARYING
// high limbs (make_seq_pointers covers only a constant hi) — the flatten
// path derives element keys vectorized in numpy and materializes the
// Pointer objects here.
PyObject *py_make_pointers_u128(PyObject *, PyObject *arg) {
  Py_buffer vals;
  if (PyObject_GetBuffer(arg, &vals, PyBUF_SIMPLE) != 0) return nullptr;
  if (vals.len % 16 != 0) {
    PyBuffer_Release(&vals);
    PyErr_SetString(PyExc_ValueError, "vals must be 16-byte-aligned bytes");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) {
    PyBuffer_Release(&vals);
    return nullptr;
  }
  Py_ssize_t n = vals.len / 16;
  const uint8_t *src = static_cast<const uint8_t *>(vals.buf);
  PyObject *out = PyList_New(n);
  if (!out) {
    PyBuffer_Release(&vals);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *obj = slots.build(src + i * 16);
    if (!obj) {
      PyBuffer_Release(&vals);
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, obj);
  }
  PyBuffer_Release(&vals);
  return out;
}

// Read a Pointer's 128-bit value slot as 16 little-endian bytes.
inline bool ptr_value_le16(PyObject *obj, const PointerSlots &slots,
                           uint8_t out[16]) {
  if (Py_TYPE(obj) != slots.tp) {
    PyErr_SetString(PyExc_TypeError, "expected Pointer");
    return false;
  }
  PyObject *val = *reinterpret_cast<PyObject **>(
      reinterpret_cast<char *>(obj) + slots.off_value);
  if (!val || !PyLong_Check(val)) {
    PyErr_SetString(PyExc_TypeError, "Pointer.value is not an int");
    return false;
  }
  return _PyLong_AsByteArray(reinterpret_cast<PyLongObject *>(val), out, 16,
                             1, 0) == 0;
}

// make_pair_pointers_list(lks: list[Pointer], rks: list[Pointer]) -> list
//
// ref_scalar(lk, rk) straight from the Pointer objects: the value slots
// are read in C, so callers need no 16-byte-LE buffer bookkeeping.
PyObject *py_make_pair_pointers_list(PyObject *, PyObject *args) {
  PyObject *lks, *rks;
  if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &lks, &PyList_Type,
                        &rks))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(lks);
  if (PyList_GET_SIZE(rks) != n) {
    PyErr_SetString(PyExc_ValueError, "lks/rks length mismatch");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) return nullptr;
  PyObject *out = PyList_New(n);
  if (!out) return nullptr;
  uint8_t msg[34];
  uint8_t dig[16];
  msg[0] = 0x06;
  msg[17] = 0x06;
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!ptr_value_le16(PyList_GET_ITEM(lks, i), slots, msg + 1) ||
        !ptr_value_le16(PyList_GET_ITEM(rks, i), slots, msg + 18)) {
      Py_DECREF(out);
      return nullptr;
    }
    blake2b128_single(msg, 34, dig);
    PyObject *obj = slots.build(dig);
    if (!obj) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, obj);
  }
  return out;
}

// make_join_triples(lks, rks, lrows, rrows, diffs) -> list
//
// The columnar join's fused output kernel: one C pass per match
// producing (ref_scalar(lk, rk), (lk, rk, *lrow, *rrow), diff) — the
// blake2b pair key, the direct-slot Pointer, and the output row tuple,
// replacing a Python zip/concat comprehension over five parallel lists.
PyObject *py_make_join_triples(PyObject *, PyObject *args) {
  PyObject *lks, *rks, *lrows, *rrows, *diffs;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!", &PyList_Type, &lks, &PyList_Type,
                        &rks, &PyList_Type, &lrows, &PyList_Type, &rrows,
                        &PyList_Type, &diffs))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(lks);
  if (PyList_GET_SIZE(rks) != n || PyList_GET_SIZE(lrows) != n ||
      PyList_GET_SIZE(rrows) != n || PyList_GET_SIZE(diffs) != n) {
    PyErr_SetString(PyExc_ValueError, "input list length mismatch");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) return nullptr;
  PyObject *out = PyList_New(n);
  if (!out) return nullptr;
  uint8_t msg[34];
  uint8_t dig[16];
  msg[0] = 0x06;
  msg[17] = 0x06;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *lk = PyList_GET_ITEM(lks, i);
    PyObject *rk = PyList_GET_ITEM(rks, i);
    PyObject *lrow = PyList_GET_ITEM(lrows, i);
    PyObject *rrow = PyList_GET_ITEM(rrows, i);
    if (!PyTuple_Check(lrow) || !PyTuple_Check(rrow)) {
      PyErr_SetString(PyExc_TypeError, "rows must be tuples");
      Py_DECREF(out);
      return nullptr;
    }
    if (!ptr_value_le16(lk, slots, msg + 1) ||
        !ptr_value_le16(rk, slots, msg + 18)) {
      Py_DECREF(out);
      return nullptr;
    }
    blake2b128_single(msg, 34, dig);
    PyObject *key = slots.build(dig);
    if (!key) {
      Py_DECREF(out);
      return nullptr;
    }
    Py_ssize_t nl = PyTuple_GET_SIZE(lrow);
    Py_ssize_t nr = PyTuple_GET_SIZE(rrow);
    PyObject *row = PyTuple_New(2 + nl + nr);
    if (!row) {
      Py_DECREF(key);
      Py_DECREF(out);
      return nullptr;
    }
    Py_INCREF(lk);
    PyTuple_SET_ITEM(row, 0, lk);
    Py_INCREF(rk);
    PyTuple_SET_ITEM(row, 1, rk);
    for (Py_ssize_t j = 0; j < nl; j++) {
      PyObject *v = PyTuple_GET_ITEM(lrow, j);
      Py_INCREF(v);
      PyTuple_SET_ITEM(row, 2 + j, v);
    }
    for (Py_ssize_t j = 0; j < nr; j++) {
      PyObject *v = PyTuple_GET_ITEM(rrow, j);
      Py_INCREF(v);
      PyTuple_SET_ITEM(row, 2 + nl + j, v);
    }
    PyObject *triple = PyTuple_New(3);
    if (!triple) {
      Py_DECREF(key);
      Py_DECREF(row);
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(triple, 0, key);  // steals
    PyTuple_SET_ITEM(triple, 1, row);  // steals
    PyObject *d = PyList_GET_ITEM(diffs, i);
    Py_INCREF(d);
    PyTuple_SET_ITEM(triple, 2, d);
    PyList_SET_ITEM(out, i, triple);
  }
  return out;
}

// join_delta_side(jv_code, jvs, deltas, left_rows, right_rows,
//                 left_side, error_cls, out) -> (saw_retract, n_errors)
//
// One C pass over a delta batch for the columnar join's delta mode:
// join-value -> dense code lookup (allocating a fresh code + empty
// buckets on both sides on a miss), match expansion against the other
// side's bucket with fused (ref_scalar key, (lk, rk, *lrow, *rrow),
// diff) triple construction appended to `out`, and own-bucket update
// in stream order — the exact interleaving of the classic
// JoinNode._delta_side. Error join values are counted and skipped;
// the caller logs them.
PyObject *py_join_delta_side(PyObject *, PyObject *args) {
  PyObject *jv_code, *jvs, *deltas, *left_rows, *right_rows, *error_cls,
      *out;
  int left_side;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!iOO!", &PyDict_Type, &jv_code,
                        &PyList_Type, &jvs, &PyList_Type, &deltas,
                        &PyList_Type, &left_rows, &PyList_Type, &right_rows,
                        &left_side, &error_cls, &PyList_Type, &out))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(deltas);
  if (PyList_GET_SIZE(jvs) != n) {
    PyErr_SetString(PyExc_ValueError, "jvs/deltas length mismatch");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) return nullptr;
  uint8_t msg[34];
  uint8_t dig[16];
  msg[0] = 0x06;
  msg[17] = 0x06;
  uint8_t *own16 = left_side ? msg + 1 : msg + 18;
  uint8_t *oth16 = left_side ? msg + 18 : msg + 1;
  int saw_retract = 0;
  long n_errors = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *delta = PyList_GET_ITEM(deltas, i);
    if (!PyTuple_Check(delta) || PyTuple_GET_SIZE(delta) != 3) {
      PyErr_SetString(PyExc_TypeError, "deltas must be (key, row, diff)");
      return nullptr;
    }
    PyObject *key = PyTuple_GET_ITEM(delta, 0);
    PyObject *row = PyTuple_GET_ITEM(delta, 1);
    PyObject *diff = PyTuple_GET_ITEM(delta, 2);
    if (!PyTuple_Check(row)) {
      PyErr_SetString(PyExc_TypeError, "rows must be tuples");
      return nullptr;
    }
    long d = PyLong_AsLong(diff);
    if (d == -1 && PyErr_Occurred()) return nullptr;
    PyObject *jv = PyList_GET_ITEM(jvs, i);
    Py_ssize_t code;
    PyObject *code_obj = PyDict_GetItemWithError(jv_code, jv);
    if (code_obj) {
      code = PyLong_AsSsize_t(code_obj);
      if (code == -1 && PyErr_Occurred()) return nullptr;
    } else {
      if (PyErr_Occurred()) return nullptr;
      int is_err = PyObject_IsInstance(jv, error_cls);
      if (is_err < 0) return nullptr;
      if (is_err) {
        n_errors++;
        continue;
      }
      code = PyList_GET_SIZE(left_rows);
      for (int side = 0; side < 2; side++) {
        PyObject *bucket = PyDict_New();
        if (!bucket) return nullptr;
        int rc = PyList_Append(side ? right_rows : left_rows, bucket);
        Py_DECREF(bucket);
        if (rc < 0) return nullptr;
      }
      code_obj = PyLong_FromSsize_t(code);
      if (!code_obj) return nullptr;
      int rc = PyDict_SetItem(jv_code, jv, code_obj);
      Py_DECREF(code_obj);
      if (rc < 0) return nullptr;
    }
    if (code < 0 || code >= PyList_GET_SIZE(left_rows) ||
        code >= PyList_GET_SIZE(right_rows)) {
      PyErr_SetString(PyExc_ValueError, "jv_code entry out of range");
      return nullptr;
    }
    PyObject *own =
        PyList_GET_ITEM(left_side ? left_rows : right_rows, code);
    PyObject *other =
        PyList_GET_ITEM(left_side ? right_rows : left_rows, code);
    if (!PyDict_Check(own) || !PyDict_Check(other)) {
      PyErr_SetString(PyExc_TypeError, "row buckets must be dicts");
      return nullptr;
    }
    if (PyDict_GET_SIZE(other) > 0) {
      if (!ptr_value_le16(key, slots, own16)) return nullptr;
      Py_ssize_t pos = 0;
      PyObject *okey, *orow;
      while (PyDict_Next(other, &pos, &okey, &orow)) {
        if (!PyTuple_Check(orow)) {
          PyErr_SetString(PyExc_TypeError, "rows must be tuples");
          return nullptr;
        }
        if (!ptr_value_le16(okey, slots, oth16)) return nullptr;
        blake2b128_single(msg, 34, dig);
        PyObject *pair = slots.build(dig);
        if (!pair) return nullptr;
        PyObject *lk = left_side ? key : okey;
        PyObject *rk = left_side ? okey : key;
        PyObject *lrow = left_side ? row : orow;
        PyObject *rrow = left_side ? orow : row;
        Py_ssize_t nl = PyTuple_GET_SIZE(lrow);
        Py_ssize_t nr = PyTuple_GET_SIZE(rrow);
        PyObject *orow_t = PyTuple_New(2 + nl + nr);
        if (!orow_t) {
          Py_DECREF(pair);
          return nullptr;
        }
        Py_INCREF(lk);
        PyTuple_SET_ITEM(orow_t, 0, lk);
        Py_INCREF(rk);
        PyTuple_SET_ITEM(orow_t, 1, rk);
        for (Py_ssize_t j = 0; j < nl; j++) {
          PyObject *v = PyTuple_GET_ITEM(lrow, j);
          Py_INCREF(v);
          PyTuple_SET_ITEM(orow_t, 2 + j, v);
        }
        for (Py_ssize_t j = 0; j < nr; j++) {
          PyObject *v = PyTuple_GET_ITEM(rrow, j);
          Py_INCREF(v);
          PyTuple_SET_ITEM(orow_t, 2 + nl + j, v);
        }
        PyObject *triple = PyTuple_New(3);
        if (!triple) {
          Py_DECREF(pair);
          Py_DECREF(orow_t);
          return nullptr;
        }
        PyTuple_SET_ITEM(triple, 0, pair);    // steals
        PyTuple_SET_ITEM(triple, 1, orow_t);  // steals
        Py_INCREF(diff);
        PyTuple_SET_ITEM(triple, 2, diff);
        int rc = PyList_Append(out, triple);
        Py_DECREF(triple);
        if (rc < 0) return nullptr;
      }
    }
    if (d > 0) {
      if (PyDict_SetItem(own, key, row) < 0) return nullptr;
    } else {
      saw_retract = 1;
      int has = PyDict_Contains(own, key);
      if (has < 0) return nullptr;
      if (has && PyDict_DelItem(own, key) < 0) return nullptr;
    }
  }
  return Py_BuildValue("(il)", saw_retract, n_errors);
}

// make_triples_u128(vals: bytes n*16 LE, rows: list, diffs: list) -> list
//
// Bulk (Pointer(v_i), rows[i], diffs[i]) triples from precomputed
// 128-bit key values — the flatten path's output assembly.
PyObject *py_make_triples_u128(PyObject *, PyObject *args) {
  Py_buffer vals;
  PyObject *rows, *diffs;
  if (!PyArg_ParseTuple(args, "y*O!O!", &vals, &PyList_Type, &rows,
                        &PyList_Type, &diffs))
    return nullptr;
  if (vals.len % 16 != 0) {
    PyBuffer_Release(&vals);
    PyErr_SetString(PyExc_ValueError, "vals must be 16-byte-aligned bytes");
    return nullptr;
  }
  Py_ssize_t n = vals.len / 16;
  if (PyList_GET_SIZE(rows) != n || PyList_GET_SIZE(diffs) != n) {
    PyBuffer_Release(&vals);
    PyErr_SetString(PyExc_ValueError, "vals/rows/diffs length mismatch");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) {
    PyBuffer_Release(&vals);
    return nullptr;
  }
  const uint8_t *src = static_cast<const uint8_t *>(vals.buf);
  PyObject *out = PyList_New(n);
  if (!out) {
    PyBuffer_Release(&vals);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *key = slots.build(src + i * 16);
    if (!key) {
      PyBuffer_Release(&vals);
      Py_DECREF(out);
      return nullptr;
    }
    PyObject *triple = PyTuple_New(3);
    if (!triple) {
      Py_DECREF(key);
      PyBuffer_Release(&vals);
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(triple, 0, key);
    PyObject *r = PyList_GET_ITEM(rows, i);
    Py_INCREF(r);
    PyTuple_SET_ITEM(triple, 1, r);
    PyObject *d = PyList_GET_ITEM(diffs, i);
    Py_INCREF(d);
    PyTuple_SET_ITEM(triple, 2, d);
    PyList_SET_ITEM(out, i, triple);
  }
  PyBuffer_Release(&vals);
  return out;
}

// flatten_triples(vals: bytes n*16 LE, parents: list[tuple],
//                 counts: list[int], elems: list, flat_idx: int,
//                 diffs: list) -> list
//
// The columnar flatten's fused output assembly: per element, build the
// output row (the parent row with the sequence column replaced by the
// element), the derived-key Pointer from the precomputed 128-bit value,
// and the delta triple — one C pass instead of a python row
// comprehension feeding make_triples_u128.
PyObject *py_flatten_triples(PyObject *, PyObject *args) {
  Py_buffer vals;
  PyObject *parents, *counts, *elems, *diffs;
  Py_ssize_t flat_idx;
  if (!PyArg_ParseTuple(args, "y*O!O!O!nO!", &vals, &PyList_Type, &parents,
                        &PyList_Type, &counts, &PyList_Type, &elems,
                        &flat_idx, &PyList_Type, &diffs))
    return nullptr;
  Py_ssize_t np_ = PyList_GET_SIZE(parents);
  Py_ssize_t total = PyList_GET_SIZE(elems);
  if (PyList_GET_SIZE(counts) != np_ || PyList_GET_SIZE(diffs) != np_ ||
      vals.len != total * 16) {
    PyBuffer_Release(&vals);
    PyErr_SetString(PyExc_ValueError,
                    "parents/counts/diffs/elems/vals length mismatch");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) {
    PyBuffer_Release(&vals);
    return nullptr;
  }
  const uint8_t *src = static_cast<const uint8_t *>(vals.buf);
  PyObject *out = PyList_New(total);
  if (!out) {
    PyBuffer_Release(&vals);
    return nullptr;
  }
  Py_ssize_t pos = 0;
  for (Py_ssize_t i = 0; i < np_; i++) {
    PyObject *row = PyList_GET_ITEM(parents, i);
    PyObject *diff = PyList_GET_ITEM(diffs, i);
    Py_ssize_t m = PyLong_AsSsize_t(PyList_GET_ITEM(counts, i));
    if (m == -1 && PyErr_Occurred()) goto fail;
    if (!PyTuple_Check(row) || flat_idx < 0 ||
        flat_idx >= PyTuple_GET_SIZE(row)) {
      PyErr_SetString(PyExc_TypeError,
                      "parent rows must be tuples containing flat_idx");
      goto fail;
    }
    if (pos + m > total) {
      PyErr_SetString(PyExc_ValueError, "counts exceed element total");
      goto fail;
    }
    {
      Py_ssize_t w = PyTuple_GET_SIZE(row);
      for (Py_ssize_t j = 0; j < m; j++, pos++) {
        PyObject *new_row = PyTuple_New(w);
        if (!new_row) goto fail;
        for (Py_ssize_t c = 0; c < w; c++) {
          PyObject *v = (c == flat_idx) ? PyList_GET_ITEM(elems, pos)
                                        : PyTuple_GET_ITEM(row, c);
          Py_INCREF(v);
          PyTuple_SET_ITEM(new_row, c, v);
        }
        PyObject *key = slots.build(src + pos * 16);
        if (!key) {
          Py_DECREF(new_row);
          goto fail;
        }
        PyObject *triple = PyTuple_New(3);
        if (!triple) {
          Py_DECREF(new_row);
          Py_DECREF(key);
          goto fail;
        }
        PyTuple_SET_ITEM(triple, 0, key);      // steals
        PyTuple_SET_ITEM(triple, 1, new_row);  // steals
        Py_INCREF(diff);
        PyTuple_SET_ITEM(triple, 2, diff);
        PyList_SET_ITEM(out, pos, triple);
      }
    }
  }
  if (pos != total) {
    PyErr_SetString(PyExc_ValueError, "counts do not cover element total");
    goto fail;
  }
  PyBuffer_Release(&vals);
  return out;
fail:
  PyBuffer_Release(&vals);
  Py_DECREF(out);
  return nullptr;
}

// make_seq_pointers(hi64: int, lows: bytes of little-endian u64) -> list
PyObject *py_make_seq_pointers(PyObject *, PyObject *args) {
  unsigned long long hi64;
  Py_buffer lows;
  if (!PyArg_ParseTuple(args, "Ky*", &hi64, &lows)) return nullptr;
  if (lows.len % 8 != 0) {
    PyBuffer_Release(&lows);
    PyErr_SetString(PyExc_ValueError, "lows must be u64-aligned bytes");
    return nullptr;
  }
  PyTypeObject *tp = reinterpret_cast<PyTypeObject *>(g_pointer_cls);
  Py_ssize_t off_value = slot_offset(tp, "value");
  Py_ssize_t off_origin = slot_offset(tp, "_origin");
  Py_ssize_t off_h = slot_offset(tp, "_h");
  if (off_value < 0 || off_origin < 0 || off_h < 0) {
    PyBuffer_Release(&lows);
    PyErr_SetString(PyExc_TypeError, "Pointer slot layout not recognized");
    return nullptr;
  }
  Py_ssize_t n = lows.len / 8;
  const uint8_t *src = static_cast<const uint8_t *>(lows.buf);
  PyObject *out = PyList_New(n);
  if (!out) {
    PyBuffer_Release(&lows);
    return nullptr;
  }
  uint8_t raw[16];
  std::memcpy(raw + 8, &hi64, 8);
  for (Py_ssize_t i = 0; i < n; i++) {
    std::memcpy(raw, src + i * 8, 8);
    PyObject *val =
        hi64 ? _PyLong_FromByteArray(raw, 16, 1, 0)
             : PyLong_FromUnsignedLongLong(
                   *reinterpret_cast<const uint64_t *>(src + i * 8));
    if (!val) goto fail;
    {
      Py_hash_t h = PyObject_Hash(val);
      if (h == -1 && PyErr_Occurred()) {
        Py_DECREF(val);
        goto fail;
      }
      PyObject *h_obj = PyLong_FromSsize_t(h);
      if (!h_obj) {
        Py_DECREF(val);
        goto fail;
      }
      PyObject *obj = tp->tp_alloc(tp, 0);
      if (!obj) {
        Py_DECREF(val);
        Py_DECREF(h_obj);
        goto fail;
      }
      *reinterpret_cast<PyObject **>(reinterpret_cast<char *>(obj) +
                                     off_value) = val;  // steals
      Py_INCREF(Py_None);
      *reinterpret_cast<PyObject **>(reinterpret_cast<char *>(obj) +
                                     off_origin) = Py_None;
      *reinterpret_cast<PyObject **>(reinterpret_cast<char *>(obj) + off_h) =
          h_obj;  // steals
      PyList_SET_ITEM(out, i, obj);
    }
  }
  PyBuffer_Release(&lows);
  return out;
fail:
  PyBuffer_Release(&lows);
  Py_DECREF(out);
  return nullptr;
}

// -- columnar exchange routing ----------------------------------------------
//
// The exchange node's shard codes in bulk: pointer_shards reads the low
// 16 bits of every key's value slot in one C pass; ref_shards computes
// ref_scalar(v).shard for the common scalar types by serializing each
// value exactly as value._serialize_for_hash does and taking the first
// two digest bytes of the single-block blake2b-128 (the low 16 bits of
// the little-endian digest int). Types the kernel does not cover come
// back as "unresolved" indices for the Python caller to patch — so the
// kernel can never silently diverge from the Python routing.

// pointer_shards(keys: list[Pointer]) -> bytes (n x u16 LE shard codes)
PyObject *py_pointer_shards(PyObject *, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "pointer_shards expects a list");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(arg);
  PyObject *out = PyBytes_FromStringAndSize(nullptr, n * 2);
  if (!out) return nullptr;
  uint8_t *dst = reinterpret_cast<uint8_t *>(PyBytes_AS_STRING(out));
  uint8_t raw[16];
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!ptr_value_le16(PyList_GET_ITEM(arg, i), slots, raw)) {
      Py_DECREF(out);
      return nullptr;
    }
    dst[2 * i] = raw[0];
    dst[2 * i + 1] = raw[1];
  }
  return out;
}

// ref_shards(values: list) -> (bytes n x u16 LE, list[int] unresolved)
PyObject *py_ref_shards(PyObject *, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "ref_shards expects a list");
    return nullptr;
  }
  PointerSlots slots;
  if (!slots.resolve()) return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(arg);
  PyObject *shards = PyBytes_FromStringAndSize(nullptr, n * 2);
  if (!shards) return nullptr;
  PyObject *unresolved = PyList_New(0);
  if (!unresolved) {
    Py_DECREF(shards);
    return nullptr;
  }
  uint8_t *dst = reinterpret_cast<uint8_t *>(PyBytes_AS_STRING(shards));
  uint8_t msg[128];
  uint8_t dig[16];
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *v = PyList_GET_ITEM(arg, i);
    size_t len = 0;
    bool ok = true;
    bool hashed = true;
    uint16_t code = 0;
    if (Py_TYPE(v) == slots.tp) {
      // a Pointer routes by its own shard bits, no rehash
      uint8_t raw[16];
      if (ptr_value_le16(v, slots, raw)) {
        code = static_cast<uint16_t>(raw[0] | (raw[1] << 8));
        hashed = false;
      } else {
        PyErr_Clear();
        ok = false;
      }
    } else if (v == Py_None) {
      msg[0] = 0x00;
      msg[1] = 'N';
      len = 2;
    } else if (PyBool_Check(v)) {
      msg[0] = 0x01;
      msg[1] = (v == Py_True) ? 0x01 : 0x00;
      len = 2;
    } else if (PyLong_CheckExact(v)) {
      msg[0] = 0x02;
      if (_PyLong_AsByteArray(reinterpret_cast<PyLongObject *>(v), msg + 1,
                              16, 1, 1) != 0) {
        PyErr_Clear();  // >128-bit int: Python path raises -> unroutable
        ok = false;
      } else {
        len = 17;
      }
    } else if (PyFloat_CheckExact(v)) {
      double d = PyFloat_AS_DOUBLE(v);
      if (d == std::floor(d) && std::fabs(d) < 4611686018427387904.0) {
        // integral floats hash as their int (1 == 1.0 for keying)
        int64_t iv = static_cast<int64_t>(d);
        uint64_t u = static_cast<uint64_t>(iv);
        msg[0] = 0x02;
        std::memcpy(msg + 1, &u, 8);
        std::memset(msg + 9, iv < 0 ? 0xFF : 0x00, 8);
        len = 17;
      } else {
        msg[0] = 0x03;
        std::memcpy(msg + 1, &d, 8);
        len = 9;
      }
    } else if (PyUnicode_CheckExact(v)) {
      Py_ssize_t sl;
      const char *s = PyUnicode_AsUTF8AndSize(v, &sl);
      if (!s) {
        PyErr_Clear();
        ok = false;
      } else if (sl <= 119) {  // 1 + 8 + len must fit one blake2b block
        uint64_t L = static_cast<uint64_t>(sl);
        msg[0] = 0x04;
        std::memcpy(msg + 1, &L, 8);
        std::memcpy(msg + 9, s, static_cast<size_t>(sl));
        len = 9 + static_cast<size_t>(sl);
      } else {
        ok = false;
      }
    } else if (PyBytes_CheckExact(v)) {
      Py_ssize_t bl = PyBytes_GET_SIZE(v);
      if (bl <= 119) {
        uint64_t L = static_cast<uint64_t>(bl);
        msg[0] = 0x05;
        std::memcpy(msg + 1, &L, 8);
        std::memcpy(msg + 9, PyBytes_AS_STRING(v), static_cast<size_t>(bl));
        len = 9 + static_cast<size_t>(bl);
      } else {
        ok = false;
      }
    } else {
      ok = false;  // containers, ndarrays, subclasses: Python fallback
    }
    if (ok && hashed) {
      blake2b128_single(msg, len, dig);
      code = static_cast<uint16_t>(dig[0] | (dig[1] << 8));
    }
    if (!ok) {
      code = 0;
      PyObject *idx = PyLong_FromSsize_t(i);
      if (!idx || PyList_Append(unresolved, idx) < 0) {
        Py_XDECREF(idx);
        Py_DECREF(shards);
        Py_DECREF(unresolved);
        return nullptr;
      }
      Py_DECREF(idx);
    }
    dst[2 * i] = static_cast<uint8_t>(code & 0xFF);
    dst[2 * i + 1] = static_cast<uint8_t>(code >> 8);
  }
  return Py_BuildValue("(NN)", shards, unresolved);
}

// partition_deltas(deltas: list, shards: bytes n x u16 LE, nparts: int)
//   -> list of nparts lists
//
// Single C pass replacing the per-row `parts[shard % n].append(d)` loop:
// count, allocate each partition exactly-sized, fill. Order within each
// partition preserves stream order.
PyObject *py_partition_deltas(PyObject *, PyObject *args) {
  PyObject *deltas;
  Py_buffer shards;
  Py_ssize_t nparts;
  if (!PyArg_ParseTuple(args, "O!y*n", &PyList_Type, &deltas, &shards,
                        &nparts))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(deltas);
  if (shards.len != n * 2 || nparts <= 0) {
    PyBuffer_Release(&shards);
    PyErr_SetString(PyExc_ValueError,
                    "shards must be 2*len(deltas) bytes, nparts > 0");
    return nullptr;
  }
  const uint8_t *sp = static_cast<const uint8_t *>(shards.buf);
  std::vector<Py_ssize_t> counts(static_cast<size_t>(nparts), 0);
  std::vector<uint32_t> part_of(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; i++) {
    uint32_t code = static_cast<uint32_t>(sp[2 * i] | (sp[2 * i + 1] << 8));
    uint32_t p = code % static_cast<uint32_t>(nparts);
    part_of[i] = p;
    counts[p]++;
  }
  PyObject *out = PyList_New(nparts);
  if (!out) {
    PyBuffer_Release(&shards);
    return nullptr;
  }
  for (Py_ssize_t p = 0; p < nparts; p++) {
    PyObject *part = PyList_New(counts[p]);
    if (!part) {
      PyBuffer_Release(&shards);
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, p, part);
  }
  std::vector<Py_ssize_t> fill(static_cast<size_t>(nparts), 0);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PyList_GET_ITEM(deltas, i);
    Py_INCREF(d);
    PyList_SET_ITEM(PyList_GET_ITEM(out, part_of[i]), fill[part_of[i]]++, d);
  }
  PyBuffer_Release(&shards);
  return out;
}

PyMethodDef methods[] = {
    {"make_seq_pointers", py_make_seq_pointers, METH_VARARGS,
     "bulk-construct Pointer objects from (hi64, u64-LE bytes)"},
    {"make_pair_pointers", py_make_pair_pointers, METH_VARARGS,
     "bulk ref_scalar(lk, rk): blake2b-128 over paired 16-byte LE key "
     "values, returned as Pointer objects"},
    {"make_pointers_u128", py_make_pointers_u128, METH_O,
     "bulk-construct Pointer objects from 16-byte LE value records"},
    {"make_pair_pointers_list", py_make_pair_pointers_list, METH_VARARGS,
     "bulk ref_scalar(lk, rk) from two Pointer lists"},
    {"make_join_triples", py_make_join_triples, METH_VARARGS,
     "fused join output: (pair key, (lk, rk, *lrow, *rrow), diff) triples"},
    {"make_triples_u128", py_make_triples_u128, METH_VARARGS,
     "bulk (Pointer, row, diff) triples from 16-byte LE key values"},
    {"flatten_triples", py_flatten_triples, METH_VARARGS,
     "fused flatten output: derived-key Pointer, element row, diff "
     "triples from per-parent rows + flat element list"},
    {"join_delta_side", py_join_delta_side, METH_VARARGS,
     "fused delta-mode join pass: code lookup, match expansion with "
     "triple construction, and own-bucket update in one C loop"},
    {"register_types", py_register_types, METH_VARARGS,
     "register engine value classes and rare-type helpers"},
    {"encode_message", py_encode_message, METH_O,
     "encode an exchange message tuple to bytes"},
    {"encode_frame", py_encode_frame, METH_O,
     "encode an exchange message tuple to a length-prefixed wire frame"},
    {"pointer_shards", py_pointer_shards, METH_O,
     "bulk shard codes (u16 LE bytes) from a list of Pointer keys"},
    {"ref_shards", py_ref_shards, METH_O,
     "bulk ref_scalar(v).shard codes for scalar values; returns "
     "(u16 LE bytes, unresolved index list)"},
    {"partition_deltas", py_partition_deltas, METH_VARARGS,
     "partition a delta list into nparts lists by shard % nparts in one "
     "C pass"},
    {"decode_message", py_decode_message, METH_O,
     "decode bytes to an exchange message tuple"},
    {"consolidate", py_consolidate, METH_O,
     "sum diffs of identical (key, values); raises TypeError on "
     "unhashable values"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "pw_wire_ext",
                      "native wire codec + consolidation", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_pw_wire_ext(void) { return PyModule_Create(&module); }
