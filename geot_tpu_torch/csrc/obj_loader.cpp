// Fast OBJ vertex parser, the port's copy of geot_tpu/native/obj_loader.cpp
// with the same C ABI and skip rules.
//
// Tooth scans are ~100k-300k vertices: mmap the file, scan for "v " lines,
// parse each coordinate.  Two changes from geot_tpu's copy, both so that the
// result is bit-equal to the numpy parser (geot_tpu_torch/data/io.py
// load_obj_vertices_numpy, which calls python float() and casts to float32):
// - a coordinate is parsed to double (strtod) and then rounded to float, as
//   float() and the float32 cast do; strtof rounds once and can differ from
//   that double rounding in the last bit;
// - parsing and the whitespace test use the C locale whatever LC_NUMERIC
//   says (strtod_l with a "C" locale_t), so "1.5" reads as 1.5 under a
//   locale whose decimal separator is a comma.
//
// C ABI for ctypes:
//   long obj_count_vertices(const char* path);
//   long obj_load_vertices(const char* path, float* out, long capacity);
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <locale.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
  ~Mapped() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) close(fd);
  }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) return m;
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) return m;
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

// whitespace as the C locale's isspace and python's str.split() on ASCII
inline bool space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

// is this position the start of a "v " vertex line?
inline bool vertex_line(const char* p, const char* begin) {
  return p[0] == 'v' && (p[1] == ' ' || p[1] == '\t') &&
         (p == begin || p[-1] == '\n' || p[-1] == '\r');
}

}  // namespace

extern "C" {

long obj_count_vertices(const char* path) {
  Mapped m = map_file(path);
  // distinguish "cannot open" (-1) from "empty file" (0 vertices): an empty
  // scan is a valid parse result, not an IO error
  if (!m.ok()) return m.fd >= 0 && m.size == 0 ? 0 : -1;
  long count = 0;
  const char* p = m.data;
  const char* end = m.data + m.size;
  while (p < end - 1) {
    if (vertex_line(p, m.data)) ++count;
    // jump to next line
    p = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!p) break;
    ++p;
  }
  return count;
}

long obj_load_vertices(const char* path, float* out, long capacity) {
  Mapped m = map_file(path);
  if (!m.ok()) return m.fd >= 0 && m.size == 0 ? 0 : -1;
  long count = 0;
  if (c_locale() == (locale_t)0) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  while (p < end - 1) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (vertex_line(p, m.data) && count < capacity) {
      // Parse from a NUL-terminated copy of THIS line only.  The copy is
      // mandatory twice over: (a) the mapping is not NUL-terminated, so on
      // the final newline-less line of a page-multiple file strtof would
      // scan past the mapping (SIGSEGV); (b) strtof skips leading
      // whitespace INCLUDING newlines, so a short line like "v 1 2\n"
      // must not steal the next line's first number.  Lines longer than
      // the stack buffer (vertex-color exports with many fields) go
      // through a heap copy — truncating would let a coordinate that
      // straddles the cutoff parse as a silently wrong prefix.
      size_t len = static_cast<size_t>((nl ? nl : end) - (p + 2));
      char stackbuf[256];
      char* heapbuf = nullptr;
      char* buf = stackbuf;
      if (len + 1 > sizeof(stackbuf)) {
        heapbuf = static_cast<char*>(malloc(len + 1));
        buf = heapbuf;  // skip the line if the allocation failed
      }
      if (buf != nullptr) {
        memcpy(buf, p + 2, len);
        buf[len] = '\0';
        // parse exactly 3 floats; a malformed vertex line (non-numeric
        // fields, fewer than 3 coordinates) is SKIPPED, not emitted as
        // silent zeros.  Each field must END at whitespace or
        // end-of-line — matching the python fallback's whitespace-split
        // + strict float() semantics ("3garbage" is malformed, not 3.0).
        char* cursor = buf;
        float v[3];
        bool ok = true;
        for (int d = 0; d < 3; ++d) {
          char* next = nullptr;
          v[d] = static_cast<float>(strtod_l(cursor, &next, c_locale()));
          if (next == cursor || !(*next == '\0' || space(*next))) {
            ok = false;
            break;
          }
          cursor = next;
        }
        if (ok) {
          out[count * 3 + 0] = v[0];
          out[count * 3 + 1] = v[1];
          out[count * 3 + 2] = v[2];
          ++count;
        }
      }
      free(heapbuf);
    }
    if (!nl) break;
    p = nl + 1;
  }
  return count;
}

}  // extern "C"
