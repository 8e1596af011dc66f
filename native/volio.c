/* volio — native decode hot path for the volume data layer.
 *
 * Counterpart of the reference's native C loader: the reference
 * links the vendored NrrdIO C library and widens every scalar type to
 * float32 in C++ (src/data/nrrd_file_parser.cpp:49-77, convert<T>).  Here
 * the format/header logic lives in Python (data/nrrd.py) and the bulk
 * byte-level work — endian swap, dtype widening to f32, and the global
 * min/max scan the renderer's density window needs — is this small C
 * library, loaded via ctypes (data/_native.py) with a NumPy fallback.
 *
 * Build: `make -C native` (produces libvolio.so).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>

#define EXPORT __attribute__((visibility("default")))

/* dtype codes, matching data/_native.py */
enum {
  VIO_I8 = 0, VIO_U8, VIO_I16, VIO_U16, VIO_I32, VIO_U32,
  VIO_I64, VIO_U64, VIO_F32, VIO_F64,
};

static inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
static inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
static inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

#define WIDEN_LOOP(T, LOAD)                                                  \
  do {                                                                       \
    const T *s = (const T *)src;                                             \
    for (size_t i = 0; i < count; i++) {                                     \
      float x = (float)(LOAD);                                               \
      dst[i] = x;                                                            \
      if (x < mn) mn = x;                                                    \
      if (x > mx) mx = x;                                                    \
    }                                                                        \
  } while (0)

/* Decode `count` elements of dtype `code` from `src` into float32 `dst`,
 * byte-swapping when `swap` is nonzero, and write the min/max of the
 * result into out_minmax[0..1].  Returns 0 on success, -1 on bad code. */
EXPORT int vio_widen_f32_minmax(const void *src, float *dst, size_t count,
                                int code, int swap, float *out_minmax) {
  float mn = 3.402823466e+38f, mx = -3.402823466e+38f;
  switch (code) {
    case VIO_I8:  WIDEN_LOOP(int8_t, s[i]); break;
    case VIO_U8:  WIDEN_LOOP(uint8_t, s[i]); break;
    case VIO_I16:
      if (swap) WIDEN_LOOP(uint16_t, (int16_t)bswap16(s[i]));
      else      WIDEN_LOOP(int16_t, s[i]);
      break;
    case VIO_U16:
      if (swap) WIDEN_LOOP(uint16_t, bswap16(s[i]));
      else      WIDEN_LOOP(uint16_t, s[i]);
      break;
    case VIO_I32:
      if (swap) WIDEN_LOOP(uint32_t, (int32_t)bswap32(s[i]));
      else      WIDEN_LOOP(int32_t, s[i]);
      break;
    case VIO_U32:
      if (swap) WIDEN_LOOP(uint32_t, bswap32(s[i]));
      else      WIDEN_LOOP(uint32_t, s[i]);
      break;
    case VIO_I64:
      if (swap) WIDEN_LOOP(uint64_t, (int64_t)bswap64(s[i]));
      else      WIDEN_LOOP(int64_t, s[i]);
      break;
    case VIO_U64:
      if (swap) WIDEN_LOOP(uint64_t, bswap64(s[i]));
      else      WIDEN_LOOP(uint64_t, s[i]);
      break;
    case VIO_F32:
      if (swap) {
        const uint32_t *s = (const uint32_t *)src;
        for (size_t i = 0; i < count; i++) {
          uint32_t b = bswap32(s[i]);
          float x;
          memcpy(&x, &b, 4);
          dst[i] = x;
          if (x < mn) mn = x;
          if (x > mx) mx = x;
        }
      } else {
        WIDEN_LOOP(float, s[i]);
      }
      break;
    case VIO_F64:
      if (swap) {
        const uint64_t *s = (const uint64_t *)src;
        for (size_t i = 0; i < count; i++) {
          uint64_t b = bswap64(s[i]);
          double x;
          memcpy(&x, &b, 8);
          dst[i] = (float)x;
          if (dst[i] < mn) mn = dst[i];
          if (dst[i] > mx) mx = dst[i];
        }
      } else {
        WIDEN_LOOP(double, s[i]);
      }
      break;
    default:
      return -1;
  }
  out_minmax[0] = mn;
  out_minmax[1] = mx;
  return 0;
}

/* Min/max scan over an f32 buffer (the density-window seed;
 * nrrd_file_parser.cpp:38-41 does this with std::min/max_element). */
EXPORT void vio_minmax_f32(const float *src, size_t count, float *out_minmax) {
  float mn = 3.402823466e+38f, mx = -3.402823466e+38f;
  for (size_t i = 0; i < count; i++) {
    float x = src[i];
    if (x < mn) mn = x;
    if (x > mx) mx = x;
  }
  out_minmax[0] = mn;
  out_minmax[1] = mx;
}

/* CSV slice parsing fast path — the reference parses CSV slices in C++
 * with std::getline + std::stof per cell (csv_file_parser.cpp:14-50).
 * Parse a whole CSV text buffer of comma-separated rows into float32,
 * returning the number of values written, or -(line+1) on a malformed
 * cell.  Rows are delimited by '\n' (a trailing '\r' is tolerated);
 * `out_cols` receives the column count of the first row so the caller
 * can enforce per-row consistency (the parser itself enforces equality
 * and returns an error on ragged rows, mirroring the reference's
 * dimension checks). */
EXPORT long vio_parse_csv(const char *text, size_t len, float *dst,
                          size_t cap, long *out_cols) {
  size_t n = 0;
  long cols = -1, col = 0, line = 0;
  const char *p = text, *end = text + len;
  while (p < end) {
    /* one cell */
    char *cell_end;
    float v = strtof(p, &cell_end);
    if (cell_end == p) return -(line + 1);
    if (n >= cap) return -(line + 1);
    dst[n++] = v;
    col++;
    p = cell_end;
    while (p < end && *p == '\r') p++;
    if (p >= end || *p == '\n') {
      if (cols < 0) cols = col;
      else if (col != cols) return -(line + 1);
      col = 0;
      line++;
      if (p < end) p++;
      /* skip blank trailing lines */
      while (p < end && (*p == '\n' || *p == '\r')) p++;
    } else if (*p == ',') {
      p++;
    } else {
      return -(line + 1);
    }
  }
  if (col != 0) {  /* last row without trailing newline */
    if (cols < 0) cols = col;
    else if (col != cols) return -(line + 1);
  }
  *out_cols = cols < 0 ? 0 : cols;
  return (long)n;
}
