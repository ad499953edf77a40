// Host-side row work of the port's PNG reader (io/images.py): PNG
// unfiltering, colour to 8-bit gray, and the big-endian 16-bit samples of a
// depth map to host order.  Python inflates the IDAT stream with the
// standard library's zlib and hands the raw rows here; the Paeth filter
// depends on the pixel to its left, so unfiltering is a sequential loop
// per row, some 360k pixels a 752x480 frame.
//
// Replaces the JAX package's native decoder (native/slamrt.cpp, which
// inflates and unfilters 8-bit PNG only) for the port.  Built with g++ into
// build/ at first use and called through ctypes; every function returns 0 or
// a negative code, and touches no Python object.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// raw: h rows of (1 filter byte + stride bytes), as inflated from IDAT.
// out: h * stride unfiltered bytes.  bpp: bytes per complete pixel (the
// filter's left neighbour distance, at least 1).
// Returns 0, -1 on a size mismatch, -2 on an unknown filter type.
int png_unfilter(const uint8_t* raw, long raw_len, int h, long stride, int bpp,
                 uint8_t* out) {
  if (h <= 0 || stride <= 0 || bpp <= 0 || raw_len != (long)h * (stride + 1))
    return -1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + (long)y * (stride + 1);
    const uint8_t filter = line[0];
    const uint8_t* src = line + 1;
    uint8_t* cur = out + (long)y * stride;
    const uint8_t* prev = y > 0 ? cur - stride : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(cur, src, stride);
        break;
      case 1:
        for (long x = 0; x < stride; ++x)
          cur[x] = (uint8_t)(src[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (long x = 0; x < stride; ++x)
          cur[x] = (uint8_t)(src[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (long x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          cur[x] = (uint8_t)(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          cur[x] = (uint8_t)(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return -2;
    }
  }
  return 0;
}

// n pixels of ch interleaved 8-bit channels to gray: gray (1) is copied,
// gray+alpha (2) keeps the gray, RGB (3) and RGBA (4) take BT.601 luma in
// integers, (299 R + 587 G + 114 B) / 1000, as the JAX package's native
// decoder does.  Returns 0, -1 on an unknown channel count.
int pixels_to_gray8(const uint8_t* px, long n, int ch, uint8_t* out) {
  switch (ch) {
    case 1:
      std::memcpy(out, px, n);
      return 0;
    case 2:
      for (long i = 0; i < n; ++i) out[i] = px[2 * i];
      return 0;
    case 3:
    case 4:
      for (long i = 0; i < n; ++i) {
        const uint8_t* p = px + (long)ch * i;
        out[i] = (uint8_t)((299 * p[0] + 587 * p[1] + 114 * p[2]) / 1000);
      }
      return 0;
    default:
      return -1;
  }
}

// n big-endian 16-bit samples to host-order uint16.
int be16_to_u16(const uint8_t* in, long n, uint16_t* out) {
  for (long i = 0; i < n; ++i)
    out[i] = (uint16_t)((in[2 * i] << 8) | in[2 * i + 1]);
  return 0;
}

}  // extern "C"
