// CPython-API batch packer: list[bytes] -> padded (B, P) uint8 rows.
//
// The engine's host hot loop (engine/dispatch.py::pack_pairs) turns a
// Python list of sequences into one padded uint8 tensor per side.  The
// numpy formulation (join + boolean-mask scatter) costs ~6 ms per side
// per 8192 pairs; fused here into one pass of PyBytes header reads +
// memcpy it is ~50x cheaper.  This is the TPU-native analog of the
// reference's zero-copy CString marshalling into parasail's C kernels
// (reference src/aligner/mod.rs:397-418: sequences cross the FFI
// boundary as raw pointers, no per-call re-encoding).
//
// Both entry points run WITH the GIL held (loaded via ctypes.PyDLL) —
// they touch PyObject internals.  Non-`bytes` items make them return a
// sentinel instead of raising: the Python caller falls back to the
// generic path (str normalization, numpy scatter).

#include <Python.h>

#include <cstdint>
#include <cstring>

extern "C" {

// Pass 1: per-item lengths (int32) and the max length.
// Returns the max, or -1 if any item is not exactly `bytes`.
long long pt_pack_lens(PyObject *seqs, int32_t n, int32_t *lens) {
  long long mx = 0;
  for (int32_t i = 0; i < n; ++i) {
    PyObject *o = PyList_GET_ITEM(seqs, i);  // borrowed
    if (!PyBytes_CheckExact(o)) return -1;
    Py_ssize_t l = PyBytes_GET_SIZE(o);
    lens[i] = (int32_t)l;
    if (l > mx) mx = l;
  }
  return mx;
}

// Pass 2: copy each row into the padded (n, P) buffer, zero-filling the
// tail.  Returns 0, or -1 on a non-bytes item, -2 on an interior NUL
// (the engine's InteriorNulByte contract), -3 if a row exceeds P.
int pt_pack_fill(PyObject *seqs, int32_t n, int32_t P, uint8_t *out) {
  for (int32_t i = 0; i < n; ++i) {
    PyObject *o = PyList_GET_ITEM(seqs, i);
    if (!PyBytes_CheckExact(o)) return -1;
    Py_ssize_t l = PyBytes_GET_SIZE(o);
    if (l > P) return -3;
    const char *src = PyBytes_AS_STRING(o);
    if (memchr(src, 0, (size_t)l)) return -2;
    uint8_t *dst = out + (size_t)i * (size_t)P;
    memcpy(dst, src, (size_t)l);
    memset(dst + l, 0, (size_t)(P - l));
  }
  return 0;
}

}  // extern "C"
