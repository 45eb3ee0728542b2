// Streamed row fill: list[bytes] -> padded (n, P) uint8 rows, as
// ptpack.cc's pt_pack_fill, with non-temporal stores where asked.
//
// A call of 1,024 pairs of 10 kbp fills 25 MB of pinned rows that the
// card's copy engine reads next, not a core.  Plain stores read each
// destination line into the cache before writing it; streamed stores
// skip that read, so the fill moves about a third fewer bytes through
// the host's memory, which a shared host's neighbours also use.
// Runs WITH the GIL held (loaded via ctypes.PyDLL): it reads PyBytes.

#include <Python.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include <cstdint>
#include <cstring>

namespace {

// One padded row: the sequence, then zeros to P; with `stream` the
// aligned 16-byte stretches go out as non-temporal stores.
void put_row(uint8_t *dst, const char *src, size_t l, size_t P, bool stream) {
#if defined(__SSE2__)
  if (stream) {
    size_t i = 0;
    while (i < P && ((uintptr_t)(dst + i) & 15)) {
      dst[i] = i < l ? (uint8_t)src[i] : 0;
      ++i;
    }
    for (; i + 16 <= l; i += 16)
      _mm_stream_si128((__m128i *)(dst + i),
                       _mm_loadu_si128((const __m128i *)(src + i)));
    if (i < l && i + 16 <= P) {
      alignas(16) uint8_t tail[16] = {0};
      memcpy(tail, src + i, l - i);
      _mm_stream_si128((__m128i *)(dst + i),
                       _mm_load_si128((const __m128i *)tail));
      i += 16;
    }
    const __m128i zero = _mm_setzero_si128();
    for (; i + 16 <= P; i += 16) _mm_stream_si128((__m128i *)(dst + i), zero);
    for (; i < P; ++i) dst[i] = i < l ? (uint8_t)src[i] : 0;
    return;
  }
#endif
  (void)stream;
  memcpy(dst, src, l);
  memset(dst + l, 0, P - l);
}

}  // namespace

extern "C" {

// Copy each row into the padded (n, P) buffer, zero-filling the tail.
// Returns 0, or -1 on a non-bytes item, -2 on an interior NUL, -3 if a
// row exceeds P: pt_pack_fill's codes, at the same rows.
int pt_fill_rows(PyObject *seqs, int32_t n, int32_t P, uint8_t *out,
                 int32_t stream) {
  int rc = 0;
  for (int32_t i = 0; i < n; ++i) {
    PyObject *o = PyList_GET_ITEM(seqs, i);  // borrowed
    if (!PyBytes_CheckExact(o)) {
      rc = -1;
      break;
    }
    Py_ssize_t l = PyBytes_GET_SIZE(o);
    if (l > P) {
      rc = -3;
      break;
    }
    const char *src = PyBytes_AS_STRING(o);
    if (memchr(src, 0, (size_t)l)) {
      rc = -2;
      break;
    }
    put_row(out + (size_t)i * (size_t)P, src, (size_t)l, (size_t)P,
            stream != 0);
  }
#if defined(__SSE2__)
  if (stream) _mm_sfence();  // the streamed rows, visible before the copy
#endif
  return rc;
}

}  // extern "C"
