// ANSI frame encoder — native host-side runtime component.
//
// Byte-identical to euler_tpu_torch/render/ansi.py:encode_frame_py (which
// itself reproduces draw_rows, main.c:914-951 of the reference): glyphs by
// clamped marker count, solids 'X', sinks '=', run-length colour-state
// tracking, truecolor escapes in rainbow mode, window clipping.
//
// Built as a plain shared library and bound via ctypes (no pybind11 in
// this toolchain).  The Python encoder is its plain version.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr char kReset[] = "\x1b[0m";
constexpr char kBlue[] = "\x1b[34m";
constexpr char kClearLine[] = "\x1b[K";
const char kSymbols[4] = {' ', 'o', 'O', '0'};

enum CellClass : uint8_t { kEmpty = 0, kSolid = 1, kSink = 2 };

struct Out {
  char* buf;
  long cap;
  long len;
  bool overflow;

  inline void put(const char* s, long n) {
    if (len + n > cap) {
      overflow = true;
      return;
    }
    std::memcpy(buf + len, s, n);
    len += n;
  }
  inline void putz(const char* s) { put(s, (long)std::strlen(s)); }
  inline void putc1(char c) { put(&c, 1); }
};

}  // namespace

extern "C" {

// Returns number of bytes written, or -1 if out_cap was insufficient.
// glyph/cls: [Y*X] row-major; rgb: [Y*X*3].
long euler_encode_frame(const uint8_t* glyph, const uint8_t* cls,
                        const uint8_t* rgb, long Y, long X, long wrows,
                        long wcols, int rainbow, char* out, long out_cap) {
  Out o{out, out_cap, 0, false};
  long y_cutoff = Y - 1 - wrows;
  if (y_cutoff < 1) y_cutoff = 1;
  long x_end = X - 1 < wcols + 1 ? X - 1 : wcols + 1;  // exclusive

  for (long y = Y - 2; y >= y_cutoff; --y) {
    bool prev_water = false;
    const uint8_t* gr = glyph + y * X;
    const uint8_t* cr = cls + y * X;
    const uint8_t* rr = rgb + y * X * 3;
    for (long x = 1; x < x_end; ++x) {
      uint8_t c = cr[x];
      if (c == kSolid) {
        if (prev_water) o.putz(kReset);
        o.putc1('X');
        prev_water = false;
      } else if (c == kSink) {
        if (prev_water) o.putz(kReset);
        o.putc1('=');
        // prev_water intentionally unchanged (main.c:927-931)
      } else {
        uint8_t i = gr[x] > 3 ? 3 : gr[x];
        bool has_water = i > 0;
        if (!prev_water && has_water && !rainbow) {
          o.putz(kBlue);
        } else if (has_water && rainbow) {
          char tmp[24];
          int n = std::snprintf(tmp, sizeof(tmp), "\x1b[38;2;%d;%d;%dm",
                                rr[x * 3], rr[x * 3 + 1], rr[x * 3 + 2]);
          o.put(tmp, n);
        } else if (prev_water && !has_water) {
          o.putz(kReset);
        }
        o.putc1(kSymbols[i]);
        prev_water = has_water;
      }
    }
    o.putz(kReset);
    o.putz(kClearLine);
    if (y > y_cutoff) o.putz("\r\n");
  }
  return o.overflow ? -1 : o.len;
}

}  // extern "C"
