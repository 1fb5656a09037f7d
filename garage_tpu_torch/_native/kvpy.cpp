// CPython C-API binding for the native metadata engine (kvlog.cpp).
//
// The ctypes FFI costs ~3 us per call — more than the engine's own
// std::map lookup — so the hot point ops (get/commit/len) go through a
// real extension module instead (~100 ns call overhead).  Compiled
// together with kvlog.cpp into garage_kv.so by _native.build_kv();
// db/native_engine.py falls back to the ctypes path when this module
// can't be built.
//
// All functions take the db handle as an int (the pointer from kv_open);
// handles are created/destroyed only via this module or the ctypes path,
// never mixed on one db.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

extern "C" {
void* kv_open(const char* path, int sync_mode);
int kv_close(void* h);
int kv_sync_barrier(void* h);
int kv_commit(void* h, const uint8_t* payload, size_t len);
int kv_get(void* h, const char* tree, size_t tlen, const uint8_t* k,
           size_t klen, const uint8_t** out, size_t* outlen);
uint64_t kv_tree_len(void* h, const char* tree, size_t tlen);
size_t kv_tree_names(void* h, uint8_t* buf, size_t cap);
size_t kv_iter_chunk(void* h, const char* tree, size_t tlen,
                     const uint8_t* start, size_t slen, int has_start,
                     const uint8_t* end, size_t elen, int has_end, int reverse,
                     uint32_t max_items, uint8_t* buf, size_t cap, int* done);
int kv_compact_now(void* h);
uint64_t kv_log_bytes(void* h);
uint64_t kv_live_bytes(void* h);
uint64_t kv_sync_failures(void* h);
}

namespace {

void* handle_of(PyObject* obj) {
  return PyLong_AsVoidPtr(obj);  // sets an exception on junk input
}

PyObject* py_open(PyObject*, PyObject* args) {
  const char* path;
  int sync_mode;  // 0 none, 1 full, 2 group
  if (!PyArg_ParseTuple(args, "si", &path, &sync_mode)) return nullptr;
  void* h = kv_open(path, sync_mode);
  if (h == nullptr) {
    PyErr_Format(PyExc_OSError, "cannot open native kv log at '%s'", path);
    return nullptr;
  }
  return PyLong_FromVoidPtr(h);
}

PyObject* py_close(PyObject*, PyObject* args) {
  PyObject* hobj;
  if (!PyArg_ParseTuple(args, "O", &hobj)) return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  kv_close(h);
  Py_RETURN_NONE;
}

PyObject* py_commit(PyObject*, PyObject* args) {
  PyObject* hobj;
  Py_buffer payload;
  if (!PyArg_ParseTuple(args, "Oy*", &hobj, &payload)) return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) {
    PyBuffer_Release(&payload);
    return nullptr;
  }
  int rc = kv_commit(h, static_cast<const uint8_t*>(payload.buf),
                     static_cast<size_t>(payload.len));
  PyBuffer_Release(&payload);
  if (rc != 0) {
    PyErr_Format(PyExc_OSError, "native kv commit failed (rc=%d)", rc);
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* py_get(PyObject*, PyObject* args) {
  PyObject* hobj;
  Py_buffer tree, key;
  if (!PyArg_ParseTuple(args, "Oy*y*", &hobj, &tree, &key)) return nullptr;
  void* h = handle_of(hobj);
  const uint8_t* out = nullptr;
  size_t outlen = 0;
  int found =
      (h != nullptr)
          ? kv_get(h, static_cast<const char*>(tree.buf),
                   static_cast<size_t>(tree.len),
                   static_cast<const uint8_t*>(key.buf),
                   static_cast<size_t>(key.len), &out, &outlen)
          : 0;
  PyBuffer_Release(&tree);
  PyBuffer_Release(&key);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  if (!found) Py_RETURN_NONE;
  return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out),
                                   static_cast<Py_ssize_t>(outlen));
}

PyObject* py_tree_len(PyObject*, PyObject* args) {
  PyObject* hobj;
  Py_buffer tree;
  if (!PyArg_ParseTuple(args, "Oy*", &hobj, &tree)) return nullptr;
  void* h = handle_of(hobj);
  uint64_t n = (h != nullptr)
                   ? kv_tree_len(h, static_cast<const char*>(tree.buf),
                                 static_cast<size_t>(tree.len))
                   : 0;
  PyBuffer_Release(&tree);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  return PyLong_FromUnsignedLongLong(n);
}

PyObject* py_tree_names(PyObject*, PyObject* args) {
  PyObject* hobj;
  if (!PyArg_ParseTuple(args, "O", &hobj)) return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  size_t need = kv_tree_names(h, nullptr, 0);
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)need);
  if (out == nullptr) return nullptr;
  if (need > 0)
    kv_tree_names(h, reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out)), need);
  return out;
}

// iter_chunk(h, tree, start|None, end|None, reverse, max_items, cap)
//   -> (chunk: bytes, done: bool)
PyObject* py_iter_chunk(PyObject*, PyObject* args) {
  PyObject* hobj;
  Py_buffer tree;
  PyObject *startobj, *endobj;
  int reverse;
  unsigned int max_items;
  Py_ssize_t cap;
  if (!PyArg_ParseTuple(args, "Oy*OOpIn", &hobj, &tree, &startobj, &endobj,
                        &reverse, &max_items, &cap))
    return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) {
    PyBuffer_Release(&tree);
    return nullptr;
  }
  Py_buffer start{}, end{};
  int has_start = 0, has_end = 0;
  if (startobj != Py_None) {
    if (PyObject_GetBuffer(startobj, &start, PyBUF_SIMPLE) != 0) {
      PyBuffer_Release(&tree);
      return nullptr;
    }
    has_start = 1;
  }
  if (endobj != Py_None) {
    if (PyObject_GetBuffer(endobj, &end, PyBUF_SIMPLE) != 0) {
      if (has_start) PyBuffer_Release(&start);
      PyBuffer_Release(&tree);
      return nullptr;
    }
    has_end = 1;
  }
  PyObject* buf = PyBytes_FromStringAndSize(nullptr, cap);
  if (buf == nullptr) {
    if (has_start) PyBuffer_Release(&start);
    if (has_end) PyBuffer_Release(&end);
    PyBuffer_Release(&tree);
    return nullptr;
  }
  int done = 0;
  size_t n = kv_iter_chunk(
      h, static_cast<const char*>(tree.buf), static_cast<size_t>(tree.len),
      has_start ? static_cast<const uint8_t*>(start.buf) : nullptr,
      has_start ? static_cast<size_t>(start.len) : 0, has_start,
      has_end ? static_cast<const uint8_t*>(end.buf) : nullptr,
      has_end ? static_cast<size_t>(end.len) : 0, has_end, reverse, max_items,
      reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(buf)),
      static_cast<size_t>(cap), &done);
  if (has_start) PyBuffer_Release(&start);
  if (has_end) PyBuffer_Release(&end);
  PyBuffer_Release(&tree);
  if (_PyBytes_Resize(&buf, static_cast<Py_ssize_t>(n)) != 0) return nullptr;
  PyObject* ret = Py_BuildValue("(NO)", buf, done ? Py_True : Py_False);
  return ret;
}

PyObject* py_compact(PyObject*, PyObject* args) {
  PyObject* hobj;
  if (!PyArg_ParseTuple(args, "O", &hobj)) return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  if (kv_compact_now(h) != 0) {
    PyErr_SetString(PyExc_OSError, "native kv compaction failed");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* py_sync_barrier(PyObject*, PyObject* args) {
  PyObject* hobj;
  if (!PyArg_ParseTuple(args, "O", &hobj)) return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  int rc;
  Py_BEGIN_ALLOW_THREADS  // may block on the flusher's fdatasync
  rc = kv_sync_barrier(h);
  Py_END_ALLOW_THREADS
  if (rc != 0) {
    PyErr_SetString(PyExc_OSError, "native kv sync barrier failed");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* py_log_bytes(PyObject*, PyObject* args) {
  PyObject* hobj;
  if (!PyArg_ParseTuple(args, "O", &hobj)) return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  return PyLong_FromUnsignedLongLong(kv_log_bytes(h));
}

PyObject* py_live_bytes(PyObject*, PyObject* args) {
  PyObject* hobj;
  if (!PyArg_ParseTuple(args, "O", &hobj)) return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  return PyLong_FromUnsignedLongLong(kv_live_bytes(h));
}

PyObject* py_sync_failures(PyObject*, PyObject* args) {
  PyObject* hobj;
  if (!PyArg_ParseTuple(args, "O", &hobj)) return nullptr;
  void* h = handle_of(hobj);
  if (h == nullptr && PyErr_Occurred()) return nullptr;
  return PyLong_FromUnsignedLongLong(kv_sync_failures(h));
}

PyMethodDef methods[] = {
    {"open", py_open, METH_VARARGS, "open(path, fsync) -> handle"},
    {"close", py_close, METH_VARARGS, "close(handle)"},
    {"commit", py_commit, METH_VARARGS, "commit(handle, payload)"},
    {"get", py_get, METH_VARARGS, "get(handle, tree, key) -> bytes | None"},
    {"tree_len", py_tree_len, METH_VARARGS, "tree_len(handle, tree) -> int"},
    {"tree_names", py_tree_names, METH_VARARGS, "tree_names(handle) -> bytes"},
    {"iter_chunk", py_iter_chunk, METH_VARARGS,
     "iter_chunk(handle, tree, start, end, reverse, max_items, cap) -> "
     "(bytes, done)"},
    {"compact", py_compact, METH_VARARGS, "compact(handle)"},
    {"sync_barrier", py_sync_barrier, METH_VARARGS,
     "sync_barrier(handle) — wait until all acked commits are durable"},
    {"log_bytes", py_log_bytes, METH_VARARGS, "log_bytes(handle) -> int"},
    {"live_bytes", py_live_bytes, METH_VARARGS, "live_bytes(handle) -> int"},
    {"sync_failures", py_sync_failures, METH_VARARGS,
     "sync_failures(handle) -> int — cumulative failed flusher syncs"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "garage_kv",
    "Native metadata KV engine (C-API binding over kvlog.cpp)", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit_garage_kv(void) { return PyModule_Create(&module); }
