// Baseline JPEG decoding on the host (a helper of data/image_io.py, not a
// device kernel; it replaces no TPU kernel).
//
// image_io.read_jpeg parses the markers (frame, tables, restart interval,
// colour transform) in Python and hands this function the entropy-coded
// data of the one scan that follows SOS. It decodes that scan with
// libjpeg-turbo's arithmetic, the library under PIL, cv2 and imageio, so
// that the pixels equal theirs bit for bit:
//   - Huffman decoding with byte stuffing (FF 00), fill bytes (FF FF ...)
//     and RSTn restart markers, which reset the DC predictors;
//   - the integer "islow" IDCT (jidctint.c), its output clamped to 0-255;
//   - "fancy" chroma upsampling (jdsample.c): triangle filters for h2v1,
//     h2v2 and h1v2 with the image's own edge rows and columns repeated,
//     plain replication for h2v1 and h2v2 when the chroma plane is at most
//     two samples wide;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c.
// The plain version is image_io.decode_jpeg_plain (numpy and Python: a
// Huffman loop in Python takes minutes for a 16-Mpx frame).
//
// Returns 0; -1 for an invalid Huffman code, -2 for a missing or
// out-of-order restart marker, -3 when the data ends before the last MCU
// (as libjpeg does on a marker, the missing bits read as zeros).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// natural (row-major) index of the k-th zigzag coefficient; the 16 extra
// entries keep a corrupt run inside the block, as jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kLookBits = 9;

struct Huffman {
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[18]; // index of a length's first value minus its code
  uint8_t vals[256];
  uint8_t look_len[1 << kLookBits];  // 0: longer than kLookBits
  uint8_t look_sym[1 << kLookBits];

  void build(const uint8_t* bits, const uint8_t* values) {
    std::memcpy(vals, values, 256);
    std::memset(look_len, 0, sizeof(look_len));
    int32_t code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      const int n = bits[l - 1];
      if (n) {
        valoffset[l] = k - code;
        for (int i = 0; i < n; ++i, ++code, ++k) {
          if (l <= kLookBits) {
            const int shift = kLookBits - l;
            for (int j = 0; j < (1 << shift); ++j) {
              look_len[(code << shift) | j] = static_cast<uint8_t>(l);
              look_sym[(code << shift) | j] = values[k];
            }
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // ends the slow loop on an invalid code
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t len, pos = 0;
  uint64_t buf = 0;
  int nbits = 0;
  bool marker = false;     // reached a marker: the rest reads as zeros
  bool ran_out = false;    // an interval read zeros past its data
  int marker_code = 0;
  int64_t real_bits = 0, used_bits = 0;  // of the current interval

  void fill() {
    while (nbits <= 56) {
      uint32_t c = 0;
      if (!marker && pos < len) {
        c = data[pos++];
        real_bits += 8;
        if (c == 0xFF) {
          while (pos < len && data[pos] == 0xFF) ++pos;  // fill bytes
          if (pos < len && data[pos] == 0x00) {
            ++pos;  // FF 00 is a stuffed FF data byte
          } else {
            marker = true;
            marker_code = pos < len ? data[pos] : 0;
            pos = pos < len ? pos + 1 : pos;
            c = 0;
            real_bits -= 8;
          }
        }
      } else {
        marker = true;
      }
      buf |= static_cast<uint64_t>(c) << (56 - nbits);
      nbits += 8;
    }
  }
  int bits(int n) {  // n in 1..16
    if (nbits < n) fill();
    used_bits += n;
    const int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }
  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    nbits -= n;
    used_bits += n;
  }
  bool check() {  // false once an interval has read past its data
    ran_out = ran_out || used_bits > real_bits;
    return !ran_out;
  }
  // Drop the bits left in the buffer and read the RSTn marker that must
  // come next; false when it is another marker or missing.
  bool restart(int expected) {
    check();
    buf = 0;
    nbits = 0;
    real_bits = used_bits = 0;
    if (!marker) {
      while (pos < len && !(data[pos] == 0xFF && pos + 1 < len &&
                            data[pos + 1] != 0x00 && data[pos + 1] != 0xFF))
        ++pos;
      if (pos + 1 >= len) return false;
      marker_code = data[pos + 1];
      pos += 2;
    }
    marker = false;
    return marker_code == 0xD0 + (expected & 7);
  }
};

int decode_symbol(BitReader& br, const Huffman& h) {
  const int look = br.peek(kLookBits);
  const int l = h.look_len[look];
  if (l) {
    br.skip(l);
    return h.look_sym[look];
  }
  int code = br.bits(kLookBits);
  int len = kLookBits;
  while (code > h.maxcode[len]) {
    code = (code << 1) | br.bits(1);
    if (++len > 16) return -1;
  }
  return h.vals[(h.valoffset[len] + code) & 0xFF];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c jpeg_idct_islow: coefficients in natural order, quant table
// in natural order; writes 8 rows of 8 samples at out, row stride stride.
const int64_t kConstBits = 13, kPass1Bits = 2;

inline void idct_1d(int64_t i0, int64_t i1, int64_t i2, int64_t i3,
                    int64_t i4, int64_t i5, int64_t i6, int64_t i7,
                    int64_t* o) {
  int64_t z2 = i2, z3 = i6;
  int64_t z1 = (z2 + z3) * 4433;
  int64_t tmp2 = z1 + z3 * -15137;
  int64_t tmp3 = z1 + z2 * 6270;
  int64_t tmp0 = (i0 + i4) * (int64_t{1} << kConstBits);
  int64_t tmp1 = (i0 - i4) * (int64_t{1} << kConstBits);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = i7;
  tmp1 = i5;
  tmp2 = i3;
  tmp3 = i1;
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  const int64_t z5 = (z3 + z4) * 9633;
  tmp0 *= 2446;
  tmp1 *= 16819;
  tmp2 *= 25172;
  tmp3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 *= -16069;
  z4 *= -3196;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  o[0] = tmp10 + tmp3;
  o[7] = tmp10 - tmp3;
  o[1] = tmp11 + tmp2;
  o[6] = tmp11 - tmp2;
  o[2] = tmp12 + tmp1;
  o[5] = tmp12 - tmp1;
  o[3] = tmp13 + tmp0;
  o[4] = tmp13 - tmp0;
}

inline uint8_t clamp255(int64_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

void idct_islow(const int32_t* coef, const uint16_t* q, uint8_t* out,
                int64_t stride) {
  int64_t ws[64], o[8];
  for (int c = 0; c < 8; ++c) {
    int64_t in[8];
    for (int r = 0; r < 8; ++r)
      in[r] = static_cast<int64_t>(coef[r * 8 + c]) * q[r * 8 + c];
    idct_1d(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], o);
    for (int r = 0; r < 8; ++r)
      ws[r * 8 + c] = descale(o[r], kConstBits - kPass1Bits);
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + r * 8;
    idct_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], o);
    for (int c = 0; c < 8; ++c) {
      const int64_t v = descale(o[c], kConstBits + kPass1Bits + 3) + 128;
      out[r * stride + c] = clamp255(v);
    }
  }
}

// one output row of a chroma plane (cw x ch samples) upsampled by h x v
// into row[0 .. cw * h)
void upsample_row(const uint8_t* plane, int64_t stride, int64_t cw,
                  int64_t ch, int h, int v, int64_t y, uint8_t* row) {
  const bool fancy_h = h == 2 && cw > 2;
  if (v == 2 && (h == 1 || fancy_h)) {
    const int64_t i = y >> 1;
    const int64_t far = (y & 1) ? std::min(i + 1, ch - 1)
                                : std::max<int64_t>(i - 1, 0);
    const uint8_t* n0 = plane + i * stride;
    const uint8_t* n1 = plane + far * stride;
    if (h == 1) {
      const int bias = (y & 1) ? 2 : 1;
      for (int64_t j = 0; j < cw; ++j)
        row[j] = static_cast<uint8_t>((n0[j] * 3 + n1[j] + bias) >> 2);
      return;
    }
    for (int64_t j = 0; j < cw; ++j) {
      const int t = n0[j] * 3 + n1[j];
      const int64_t jl = j > 0 ? j - 1 : 0, jr = j + 1 < cw ? j + 1 : cw - 1;
      const int l = n0[jl] * 3 + n1[jl], r = n0[jr] * 3 + n1[jr];
      row[2 * j] = static_cast<uint8_t>((t * 3 + l + 8) >> 4);
      row[2 * j + 1] = static_cast<uint8_t>((t * 3 + r + 7) >> 4);
    }
    return;
  }
  const uint8_t* src = plane + (v == 2 ? (y >> 1) : y) * stride;
  if (h == 1) {
    std::memcpy(row, src, cw);
  } else if (fancy_h) {  // h2v1
    for (int64_t j = 0; j < cw; ++j) {
      const int t = src[j] * 3;
      const int l = src[j > 0 ? j - 1 : 0];
      const int r = src[j + 1 < cw ? j + 1 : cw - 1];
      row[2 * j] = static_cast<uint8_t>((t + l + 1) >> 2);
      row[2 * j + 1] = static_cast<uint8_t>((t + r + 2) >> 2);
    }
  } else {  // replication (h2v1 or h2v2 at most two samples wide)
    for (int64_t j = 0; j < cw; ++j) row[2 * j] = row[2 * j + 1] = src[j];
  }
}

}  // namespace

// data/len: the bytes after the SOS header, to the end of the file.
// comp: per component (ncomp of them, 1 or 3) h, v, quant table, DC table,
// AC table. qt: 4 x 64 quant tables in natural order. hbits: 8 x 16 code
// counts (DC tables 0-3, then AC tables 0-3); hvals: 8 x 256 values.
// ycc: 1 to convert YCbCr to RGB, 0 to keep the components as they are.
// out: height x width x ncomp bytes.
extern "C" int64_t ingp_jpeg_decode(const uint8_t* data, int64_t len,
                                    int64_t width, int64_t height,
                                    int64_t ncomp, const int32_t* comp,
                                    const uint16_t* qt, const uint8_t* hbits,
                                    const uint8_t* hvals,
                                    int64_t restart_interval, int64_t ycc,
                                    uint8_t* out) {
  std::vector<Huffman> tables(8);
  for (int t = 0; t < 8; ++t) tables[t].build(hbits + 16 * t, hvals + 256 * t);

  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    hmax = std::max(hmax, comp[5 * c]);
    vmax = std::max(vmax, comp[5 * c + 1]);
  }
  // one component is coded block by block (a non-interleaved scan)
  const bool single = ncomp == 1;
  const int64_t mcu_w = single ? 8 : 8 * hmax, mcu_h = single ? 8 : 8 * vmax;
  const int64_t mcux = (width + mcu_w - 1) / mcu_w;
  const int64_t mcuy = (height + mcu_h - 1) / mcu_h;
  std::vector<std::vector<uint8_t>> planes(ncomp);
  std::vector<int64_t> strides(ncomp);
  int h[3], v[3];
  for (int c = 0; c < ncomp; ++c) {
    h[c] = single ? 1 : comp[5 * c];
    v[c] = single ? 1 : comp[5 * c + 1];
    strides[c] = mcux * h[c] * 8;
    planes[c].assign(static_cast<size_t>(strides[c] * mcuy * v[c] * 8), 0);
  }

  BitReader br{data, len};
  int dc_pred[3] = {0, 0, 0};
  int32_t coef[64];
  const int64_t n_mcu = mcux * mcuy;
  int64_t restarts = 0;
  for (int64_t m = 0; m < n_mcu; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      if (!br.restart(static_cast<int>(restarts++))) return -2;
      dc_pred[0] = dc_pred[1] = dc_pred[2] = 0;
    }
    const int64_t my = m / mcux, mx = m % mcux;
    for (int c = 0; c < ncomp; ++c) {
      const Huffman& dc = tables[comp[5 * c + 3]];
      const Huffman& ac = tables[4 + comp[5 * c + 4]];
      const uint16_t* q = qt + 64 * comp[5 * c + 2];
      for (int by = 0; by < v[c]; ++by) {
        for (int bx = 0; bx < h[c]; ++bx) {
          std::memset(coef, 0, sizeof(coef));
          const int s = decode_symbol(br, dc);
          if (s < 0) return -1;
          dc_pred[c] += s ? extend(br.bits(s), s) : 0;
          coef[0] = dc_pred[c];
          for (int k = 1; k < 64;) {
            const int rs = decode_symbol(br, ac);
            if (rs < 0) return -1;
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              coef[kNatural[k]] = extend(br.bits(sz), sz);
              ++k;
            } else if (r == 15) {
              k += 16;
            } else {
              break;
            }
          }
          const int64_t row0 = (my * v[c] + by) * 8;
          const int64_t col0 = (mx * h[c] + bx) * 8;
          idct_islow(coef, q, planes[c].data() + row0 * strides[c] + col0,
                     strides[c]);
        }
      }
    }
  }

  if (ncomp == 1) {
    for (int64_t y = 0; y < height; ++y)
      std::memcpy(out + y * width, planes[0].data() + y * strides[0], width);
    return br.check() ? 0 : -3;
  }

  // jdcolor.c build_ycc_rgb_table
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = static_cast<int>((91881 * x + 32768) >> 16);
    cb_b[i] = static_cast<int>((116130 * x + 32768) >> 16);
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + 32768;
  }
  std::vector<uint8_t> cb_row(static_cast<size_t>(strides[1] * hmax + 2));
  std::vector<uint8_t> cr_row(cb_row.size());
  const int64_t cw = (width + hmax / comp[5] - 1) / (hmax / comp[5]);
  const int64_t chh = (height + vmax / comp[6] - 1) / (vmax / comp[6]);
  const int uh = hmax / comp[5], uv = vmax / comp[6];
  for (int64_t y = 0; y < height; ++y) {
    upsample_row(planes[1].data(), strides[1], cw, chh, uh, uv, y,
                 cb_row.data());
    upsample_row(planes[2].data(), strides[2], cw, chh, uh, uv, y,
                 cr_row.data());
    const uint8_t* yr = planes[0].data() + y * strides[0];
    uint8_t* o = out + y * width * 3;
    for (int64_t x = 0; x < width; ++x) {
      const int Y = yr[x], cb = cb_row[x], cr = cr_row[x];
      if (ycc) {
        o[3 * x] = clamp255(Y + cr_r[cr]);
        o[3 * x + 1] = clamp255(Y + ((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(Y + cb_b[cb]);
      } else {
        o[3 * x] = static_cast<uint8_t>(Y);
        o[3 * x + 1] = static_cast<uint8_t>(cb);
        o[3 * x + 2] = static_cast<uint8_t>(cr);
      }
    }
  }
  return br.check() ? 0 : -3;
}
