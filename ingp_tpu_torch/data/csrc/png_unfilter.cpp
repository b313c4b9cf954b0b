// PNG row unfiltering on the host (a helper of data/image_io.py, not a
// device kernel; it replaces no TPU kernel).
//
// A PNG image's decompressed stream holds each row as one filter-type
// byte followed by row_bytes filtered bytes. Undoing the Sub, Average and
// Paeth filters is sequential along the row (each byte depends on the
// unfiltered byte bpp to its left), so a numpy version has to loop over
// the pixels in Python: ~4 s for an 800x800 RGBA image with Paeth rows.
// This loop is the same arithmetic in C++ (the plain version is
// image_io.unfilter_plain), built by g++ at first use and bound with
// ctypes.
//
// Returns 0, or 1 + the index of the first row whose filter type is not
// 0-4 (the rows before it are unfiltered).
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int64_t ingp_png_unfilter(const uint8_t* src, uint8_t* dst,
                                     int64_t height, int64_t row_bytes,
                                     int64_t bpp) {
  const uint8_t* prev = nullptr;  // the unfiltered row above, or none
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (row_bytes + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + y * row_bytes;
    switch (type) {
      case 0:  // None
        std::memcpy(out, in, row_bytes);
        break;
      case 1:  // Sub: + left
        for (int64_t i = 0; i < row_bytes; ++i)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:  // Up: + above
        for (int64_t i = 0; i < row_bytes; ++i)
          out[i] = in[i] + (prev ? prev[i] : 0);
        break;
      case 3:  // Average: + floor((left + above) / 2)
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          out[i] = in[i] + ((a + b) >> 1);
        }
        break;
      case 4:  // Paeth: + whichever of left, above, upper-left is nearest
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = in[i] + pred;
        }
        break;
      default:
        return y + 1;
    }
    prev = out;
  }
  return 0;
}
