// The port's image codec: JPEG decoding (baseline, extended Huffman and
// progressive), JPEG encoding with libjpeg's defaults, the exact libjpeg
// encode + decode round trip, and PNG's row filters and Adam7 passes.  C++17
// and the standard library only: no libjpeg, libpng or zlib.  PNG's chunks,
// CRCs, inflate and deflate are in Python (data/png.py).
//
// The arithmetic is that of libjpeg-turbo 2.1's default paths on x86-64, so
// that a file decodes to the bytes libjpeg gives:
//   - the accurate integer IDCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2) in
//     the form of its AVX2 version (jidctint-avx2.asm): 16-bit dequantised
//     coefficients and pass-1 outputs, in0 +- in4 and the odd part's z3, z4
//     summed in 16 bits, a whole-block shortcut when rows 1-7 are zero, and
//     the result saturated to 0..255;
//   - fancy upsampling (jdsample.c h2v1, h1v2, h2v2 with their rounding
//     biases and the image's edge rows as context), replication otherwise;
//   - YCbCr -> RGB by jdcolor.c's 16-bit fixed-point tables;
//   - the encoder's jccolor.c, jcsample.c h2v2_downsample (bias 1, 2, ...),
//     jcprepct.c's edge replication, jfdctint.c and jcdctmgr.c's reciprocal
//     quantiser, at jpeg_set_defaults + jpeg_set_quality(q, TRUE): 4:2:0,
//     the Annex K tables, JFIF APP0, baseline Huffman coding.
// The algorithms follow libjpeg-turbo, which carries this notice:
//   This software is based in part on the work of the Independent JPEG
//   Group.  Copyright (C) 1991-1998, Thomas G. Lane; libjpeg-turbo
//   Copyright (C) 2009-2023, D. R. Commander.  Distributed under the IJG
//   license and the Modified (3-clause) BSD License.
//
// Refused (the entry points return -1, the Python binding None): arithmetic
// coding, lossless and hierarchical frames, precision other than 8 bits,
// 2- and 4-component files, sampling ratios that are not integral, a file
// that ends or hits a marker inside its entropy-coded data, bad Huffman
// codes, restart markers out of sequence, progressive scans out of order,
// and progressive files whose first AC coefficients stay incomplete (where
// libjpeg would smooth the blocks).
//
// Built by data/native.py: g++ -std=c++17 -O3 -shared -fPIC imgcodec.cpp

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index, with 16 guard entries as in
// libjpeg (a corrupt run never writes outside the block)
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------ Annex K tables
constexpr uint16_t kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint16_t kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

constexpr uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                    1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                      1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                    5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                      7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

HuffSpec std_spec(const uint8_t* bits, const uint8_t* vals) {
  HuffSpec s;
  s.defined = true;
  int n = 0;
  for (int l = 1; l <= 16; ++l) {
    s.bits[l] = bits[l];
    n += bits[l];
  }
  std::memcpy(s.vals, vals, n);
  return s;
}

// canonical code lengths and codes (jpeg_make_{c,d}_derived_tbl); false
// where the table is over-subscribed
bool canonical(const HuffSpec& s, int* size, uint32_t* code, int* count) {
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (p + s.bits[l] > 256) return false;
    for (int i = 0; i < s.bits[l]; ++i) size[p++] = l;
  }
  size[p] = 0;
  *count = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return false;
    c <<= 1;
    ++si;
  }
  return true;
}

// ------------------------------------------------------------ JPEG decoding
constexpr int kLookBits = 9;

struct HuffDecoder {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0 = longer code
};

bool derive_decoder(const HuffSpec& s, bool is_dc, HuffDecoder* d) {
  if (!s.defined) return false;
  int size[257];
  uint32_t code[257];
  int count = 0;
  if (!canonical(s, size, code, &count)) return false;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s.bits[l]) {
      d->valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += s.bits[l];
      d->maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xFFFFF;
  std::memcpy(d->vals, s.vals, sizeof d->vals);
  std::memset(d->look, 0, sizeof d->look);
  for (int i = 0; i < count; ++i) {
    if (size[i] > kLookBits) continue;
    const int shift = kLookBits - size[i];
    const uint32_t base = code[i] << shift;
    for (uint32_t j = 0; j < (1u << shift); ++j)
      d->look[base + j] = static_cast<uint16_t>((size[i] << 8) | s.vals[i]);
  }
  if (is_dc) {
    for (int i = 0; i < count; ++i)
      if (s.vals[i] > 15) return false;
  }
  return true;
}

// The entropy-coded bytes of a scan: FF 00 is a data FF, FF FF... fill
// bytes, any other FF xx a marker.  Past a marker (or the end of the data)
// the reader feeds zero bits; a decode that consumes one of them fails.
struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  int npad = 0;
  bool stopped = false;
  bool bad = false;

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!stopped) {
        if (pos >= len) {
          stopped = true;
        } else if (data[pos] != 0xFF) {
          byte = data[pos++];
        } else {
          size_t p = pos + 1;
          while (p < len && data[p] == 0xFF) ++p;
          if (p < len && data[p] == 0x00) {
            byte = 0xFF;
            pos = p + 1;
          } else {
            stopped = true;
            pos = p - 1;  // at the marker's last FF
          }
        }
      }
      if (stopped) npad += 8;
      acc = (acc << 8) | static_cast<uint64_t>(byte);
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(acc >> (nbits - n)) & ((1u << n) - 1);
  }
  void consume(int n) {
    nbits -= n;
    if (nbits < npad) bad = true;
  }
  int bits(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    consume(n);
    return static_cast<int>(v);
  }
  int bit() { return bits(1); }
  int decode(const HuffDecoder& t) {
    if (nbits < 16) fill();
    const uint16_t e = t.look[peek(kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(peek(l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(peek(l));
    }
    if (l > 16) {
      bad = true;
      return 0;
    }
    consume(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // drop the bits left; the byte position stays where the data ended
  void reset() {
    acc = 0;
    nbits = 0;
    npad = 0;
    stopped = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // width, height in blocks
  int dw = 0, dh = 0;          // downsampled width, height in samples
  int stride = 0, rows = 0;    // allocated blocks a row, block rows
  std::vector<int16_t> coef;   // stride * rows blocks of 64, natural order
  bool latched = false;
  uint16_t q[64] = {};
  int coef_bits[64];
  bool scanned = false;
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * stride + bx) * 64;
  }
};

enum class ColorSpace { kGray, kYCbCr, kRGB };

struct Image {
  int width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1;
  ColorSpace color = ColorSpace::kYCbCr;
  Component comp[3];
};

// ------------------------------------------------------------- the IDCT
// jidctint.c's algorithm in the arithmetic of its AVX2 version.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int16_t wrap16(int32_t x) { return static_cast<int16_t>(x); }
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(std::min(32767, std::max(-32768, x)));
}

// one 1-D pass over in[0..7] (stride 1), results before the descale
inline void idct_1d(const int16_t* in, int32_t* out) {
  // even part: in0 +- in4 in 16 bits, then << CONST_BITS
  const int32_t tmp0e = static_cast<int32_t>(wrap16(in[0] + in[4]))
                        * (1 << kConstBits);
  const int32_t tmp1e = static_cast<int32_t>(wrap16(in[0] - in[4]))
                        * (1 << kConstBits);
  const int32_t z2 = in[2], z3 = in[6];
  const uint32_t tmp2e = static_cast<uint32_t>(z2 * F0541)
                         + static_cast<uint32_t>(z3 * (F0541 - F1847));
  const uint32_t tmp3e = static_cast<uint32_t>(z2 * (F0541 + F0765))
                         + static_cast<uint32_t>(z3 * F0541);
  const uint32_t tmp10 = static_cast<uint32_t>(tmp0e) + tmp3e;
  const uint32_t tmp13 = static_cast<uint32_t>(tmp0e) - tmp3e;
  const uint32_t tmp11 = static_cast<uint32_t>(tmp1e) + tmp2e;
  const uint32_t tmp12 = static_cast<uint32_t>(tmp1e) - tmp2e;
  // odd part: z3 = in7 + in3, z4 = in5 + in1 in 16 bits
  const int32_t t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  const int32_t oz3 = wrap16(t0 + t2), oz4 = wrap16(t1 + t3);
  const uint32_t z3r = static_cast<uint32_t>(oz3 * (F1175 - F1961))
                       + static_cast<uint32_t>(oz4 * F1175);
  const uint32_t z4r = static_cast<uint32_t>(oz3 * F1175)
                       + static_cast<uint32_t>(oz4 * (F1175 - F0390));
  const uint32_t o0 = static_cast<uint32_t>(t0 * (F0298 - F0899))
                      + static_cast<uint32_t>(t3 * -F0899) + z3r;
  const uint32_t o1 = static_cast<uint32_t>(t1 * (F2053 - F2562))
                      + static_cast<uint32_t>(t2 * -F2562) + z4r;
  const uint32_t o2 = static_cast<uint32_t>(t1 * -F2562)
                      + static_cast<uint32_t>(t2 * (F3072 - F2562)) + z3r;
  const uint32_t o3 = static_cast<uint32_t>(t0 * -F0899)
                      + static_cast<uint32_t>(t3 * (F1501 - F0899)) + z4r;
  out[0] = static_cast<int32_t>(tmp10 + o3);
  out[7] = static_cast<int32_t>(tmp10 - o3);
  out[1] = static_cast<int32_t>(tmp11 + o2);
  out[6] = static_cast<int32_t>(tmp11 - o2);
  out[2] = static_cast<int32_t>(tmp12 + o1);
  out[5] = static_cast<int32_t>(tmp12 - o1);
  out[3] = static_cast<int32_t>(tmp13 + o0);
  out[4] = static_cast<int32_t>(tmp13 - o0);
}

inline int32_t descale(int32_t x, int n) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + (1u << (n - 1)))
         >> n;
}

// coef: 64 coefficients in natural order; q: the quantisation table; out:
// 8 rows of 8 samples at the given stride
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int16_t dq[64];
  for (int i = 0; i < 64; ++i)
    dq[i] = wrap16(static_cast<int32_t>(coef[i]) * static_cast<int16_t>(q[i]));
  int16_t ws[64];  // ws[col * 8 + row]: pass 1 output, transposed
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; ++i) ac_zero = coef[i] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      const int16_t v = wrap16(static_cast<int32_t>(dq[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[c * 8 + r] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t col[8];
      for (int r = 0; r < 8; ++r) col[r] = dq[r * 8 + c];
      int32_t o[8];
      idct_1d(col, o);
      for (int r = 0; r < 8; ++r)
        ws[c * 8 + r] = sat16(descale(o[r], kConstBits - kPass1Bits));
    }
  }
  for (int r = 0; r < 8; ++r) {
    int16_t row[8];
    for (int c = 0; c < 8; ++c) row[c] = ws[c * 8 + r];
    int32_t o[8];
    idct_1d(row, o);
    uint8_t* dst = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = descale(o[c], kConstBits + kPass1Bits + 3);
      dst[c] = static_cast<uint8_t>(std::min(127, std::max(-128, v)) + 128);
    }
  }
}

// ------------------------------------------------ upsampling and colour
// jdcolor.c's tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kBits = 16;
    constexpr int32_t kHalf = 1 << (kBits - 1);
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1 << kBits) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kBits;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kBits;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(std::min(255, std::max(0, v)));
}

// The component's samples of output row y, columns 0..width-1, in `out`
// (which holds at least bw * 8 * max_h bytes).  plane: the component's IDCT
// output, bw * 8 samples a row.
void upsample_row(const Image& im, const Component& c,
                  const std::vector<uint8_t>& plane, int y, uint8_t* out) {
  const int hr = im.max_h / c.h, vr = im.max_v / c.v;
  const size_t pw = static_cast<size_t>(c.bw) * 8;
  auto row = [&](int r) {
    r = std::min(c.dh - 1, std::max(0, r));
    return plane.data() + r * pw;
  };
  const int dw = c.dw;
  if (hr == 1 && vr == 1) {
    std::memcpy(out, row(y), im.width);
  } else if (hr == 2 && vr == 1 && dw > 2) {
    const uint8_t* in = row(y);
    int v = in[0];
    out[0] = static_cast<uint8_t>(v);
    out[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      v = in[x] * 3;
      out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
    }
    v = in[dw - 1];
    out[2 * dw - 2] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = static_cast<uint8_t>(v);
  } else if (hr == 1 && vr == 2) {
    const int cy = y >> 1;
    const uint8_t* in0 = row(cy);
    const uint8_t* in1 = (y & 1) ? row(cy + 1) : row(cy - 1);
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < dw; ++x)
      out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
  } else if (hr == 2 && vr == 2 && dw > 2) {
    const int cy = y >> 1;
    const uint8_t* in0 = row(cy);
    const uint8_t* in1 = (y & 1) ? row(cy + 1) : row(cy - 1);
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int x = 1; x < dw - 1; ++x) {
      next_sum = in0[x + 1] * 3 + in1[x + 1];
      out[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      out[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    out[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
  } else {
    const uint8_t* in = row(y / vr);
    for (int x = 0; x < im.width; ++x) out[x] = in[x / hr];
  }
}

// IDCT of every block of the image's components, then upsampling and
// colour conversion into out (height * width * 3 RGB).
void output_rgb(Image& im, uint8_t* out) {
  std::vector<uint8_t> planes[3];
  for (int ci = 0; ci < im.ncomp; ++ci) {
    Component& c = im.comp[ci];
    const size_t pw = static_cast<size_t>(c.bw) * 8;
    planes[ci].assign(pw * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.block(bx, by), c.q, planes[ci].data() + by * 8 * pw + bx * 8,
                   pw);
  }
  size_t row_len = 0;
  for (int ci = 0; ci < im.ncomp; ++ci)
    row_len = std::max(row_len, static_cast<size_t>(im.comp[ci].bw) * 8 * im.max_h + 16);
  std::vector<uint8_t> rows(row_len * 3);
  uint8_t* r0 = rows.data();
  uint8_t* r1 = r0 + row_len;
  uint8_t* r2 = r1 + row_len;
  const YccTables& t = ycc_tables();
  for (int y = 0; y < im.height; ++y) {
    uint8_t* dst = out + static_cast<size_t>(y) * im.width * 3;
    upsample_row(im, im.comp[0], planes[0], y, r0);
    if (im.color == ColorSpace::kGray) {
      for (int x = 0; x < im.width; ++x)
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = r0[x];
      continue;
    }
    upsample_row(im, im.comp[1], planes[1], y, r1);
    upsample_row(im, im.comp[2], planes[2], y, r2);
    if (im.color == ColorSpace::kRGB) {
      for (int x = 0; x < im.width; ++x) {
        dst[3 * x] = r0[x];
        dst[3 * x + 1] = r1[x];
        dst[3 * x + 2] = r2[x];
      }
      continue;
    }
    for (int x = 0; x < im.width; ++x) {
      const int yy = r0[x], cb = r1[x], cr = r2[x];
      dst[3 * x] = clamp255(yy + t.cr_r[cr]);
      dst[3 * x + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      dst[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
}

// ------------------------------------------------------ the file decoder
struct Decoder {
  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  Image im;
  bool have_sof = false, progressive = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  bool qdef[4] = {};
  uint16_t qt[4][64];
  HuffSpec dc[4], ac[4];
  bool std_tables_set = false;
  int scans = 0;

  int u8() { return pos < len ? data[pos++] : -1; }
  int u16() {
    const int a = u8(), b = u8();
    return (a < 0 || b < 0) ? -1 : (a << 8) | b;
  }

  // libjpeg's next_marker: skip bytes up to FF, fill FFs, FF 00 pairs
  int next_marker() {
    for (;;) {
      int c = u8();
      while (c >= 0 && c != 0xFF) c = u8();
      if (c < 0) return -1;
      do c = u8();
      while (c == 0xFF);
      if (c < 0) return -1;
      if (c != 0) return c;
    }
  }

  bool read_sof(int marker) {
    if (have_sof) return false;
    const int length = u16();
    if (length < 8) return false;
    const int precision = u8();
    im.height = u16();
    im.width = u16();
    im.ncomp = u8();
    if (precision != 8 || im.height <= 0 || im.width <= 0
        || im.height > 65500 || im.width > 65500) return false;
    if (im.ncomp != 1 && im.ncomp != 3) return false;
    if (length != 8 + im.ncomp * 3 || pos + im.ncomp * 3 > len) return false;
    for (int i = 0; i < im.ncomp; ++i) {
      Component& c = im.comp[i];
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return false;
      im.max_h = std::max(im.max_h, c.h);
      im.max_v = std::max(im.max_v, c.v);
    }
    progressive = marker == 0xC2;
    const int mcus_x = (im.width + im.max_h * 8 - 1) / (im.max_h * 8);
    const int mcus_y = (im.height + im.max_v * 8 - 1) / (im.max_v * 8);
    for (int i = 0; i < im.ncomp; ++i) {
      Component& c = im.comp[i];
      if (im.max_h % c.h || im.max_v % c.v) return false;
      c.dw = static_cast<int>((static_cast<int64_t>(im.width) * c.h + im.max_h - 1) / im.max_h);
      c.dh = static_cast<int>((static_cast<int64_t>(im.height) * c.v + im.max_v - 1) / im.max_v);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.stride = mcus_x * c.h;
      c.rows = mcus_y * c.v;
      c.coef.assign(static_cast<size_t>(c.stride) * c.rows * 64, 0);
      for (int& b : c.coef_bits) b = -1;
    }
    have_sof = true;
    return true;
  }

  bool read_dqt() {
    int length = u16() - 2;
    if (length < 0) return false;
    while (length > 0) {
      const int pq_tq = u8();
      if (pq_tq < 0) return false;
      const int prec = pq_tq >> 4, n = pq_tq & 15;
      if (n > 3 || prec > 1) return false;
      const int need = 1 + 64 * (prec + 1);
      if (length < need) return false;
      for (int i = 0; i < 64; ++i) {
        const int v = prec ? u16() : u8();
        if (v < 0) return false;
        qt[n][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qdef[n] = true;
      length -= need;
    }
    return length == 0;
  }

  bool read_dht() {
    int length = u16() - 2;
    if (length < 0) return false;
    while (length > 16) {
      int index = u8();
      if (index < 0) return false;
      HuffSpec s;
      s.defined = true;
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        const int b = u8();
        if (b < 0) return false;
        s.bits[l] = static_cast<uint8_t>(b);
        count += b;
      }
      length -= 17;
      if (count > 256 || count > length) return false;
      for (int i = 0; i < count; ++i) s.vals[i] = static_cast<uint8_t>(u8());
      length -= count;
      const bool is_ac = index & 0x10;
      index &= ~0x10;
      if (index > 3) return false;
      (is_ac ? ac : dc)[index] = s;
    }
    return length == 0;
  }

  bool skip_segment() {
    const int length = u16();
    if (length < 2 || pos + length - 2 > len) return false;
    pos += length - 2;
    return true;
  }

  bool read_app(int marker) {
    const int length = u16();
    if (length < 2 || pos + length - 2 > len) return false;
    const uint8_t* p = data + pos;
    const int n = length - 2;
    if (marker == 0xE0 && n >= 14 && std::memcmp(p, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos += n;
    return true;
  }

  bool read_dri() {
    if (u16() != 4) return false;
    restart_interval = u16();
    return restart_interval >= 0;
  }

  bool read_sos();
  bool decode();
};

struct Scan {
  int n = 0;
  int ci[4];
  int td[4], ta[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

bool Decoder::read_sos() {
  if (!have_sof) return false;
  const int length = u16();
  const int n = u8();
  if (n < 1 || n > 4 || length != 6 + 2 * n) return false;
  Scan s;
  s.n = n;
  for (int i = 0; i < n; ++i) {
    const int id = u8(), t = u8();
    if (t < 0) return false;
    int found = -1;
    for (int k = 0; k < im.ncomp; ++k)
      if (im.comp[k].id == id) found = k;
    if (found < 0) return false;
    for (int k = 0; k < i; ++k)
      if (s.ci[k] == found) return false;
    s.ci[i] = found;
    s.td[i] = t >> 4;
    s.ta[i] = t & 15;
    if (s.td[i] > 3 || s.ta[i] > 3) return false;
  }
  s.ss = u8();
  s.se = u8();
  const int a = u8();
  if (a < 0) return false;
  s.ah = a >> 4;
  s.al = a & 15;
  ++scans;

  // libjpeg-turbo fills Huffman slots 0 and 1 left empty by the first scan
  // with the standard tables (Motion-JPEG files omit them)
  if (!std_tables_set) {
    std_tables_set = true;
    if (!dc[0].defined) dc[0] = std_spec(kDcLumBits, kDcVals);
    if (!ac[0].defined) ac[0] = std_spec(kAcLumBits, kAcLumVals);
    if (!dc[1].defined) dc[1] = std_spec(kDcChromBits, kDcVals);
    if (!ac[1].defined) ac[1] = std_spec(kAcChromBits, kAcChromVals);
  }

  // the blocks in the scan's MCUs: interleaved or one component's raster
  int blocks_in_mcu = 0;
  for (int i = 0; i < n; ++i) blocks_in_mcu += im.comp[s.ci[i]].h * im.comp[s.ci[i]].v;
  if (n > 1 && blocks_in_mcu > 10) return false;

  for (int i = 0; i < n; ++i) {
    Component& c = im.comp[s.ci[i]];
    if (!c.latched) {
      if (!qdef[c.tq]) return false;
      std::memcpy(c.q, qt[c.tq], sizeof c.q);
      c.latched = true;
    }
    c.scanned = true;
  }

  const bool dc_scan = s.ss == 0;
  if (progressive) {
    bool bad = false;
    if (dc_scan) {
      if (s.se != 0) bad = true;
    } else {
      if (s.ss > s.se || s.se > 63 || n != 1) bad = true;
    }
    if (s.ah != 0 && s.al != s.ah - 1) bad = true;
    if (s.al > 13) bad = true;
    if (bad) return false;
    for (int i = 0; i < n; ++i) {
      int* cb = im.comp[s.ci[i]].coef_bits;
      if (!dc_scan && cb[0] < 0) return false;
      for (int k = s.ss; k <= s.se; ++k) {
        const int expected = cb[k] < 0 ? 0 : cb[k];
        if (s.ah != expected) return false;
        cb[k] = s.al;
      }
    }
  } else if (s.ss != 0 || s.se != 63 || s.ah != 0 || s.al != 0) {
    return false;
  }

  HuffDecoder dct[4], act[4];
  for (int i = 0; i < n; ++i) {
    const bool need_dc = !progressive || (dc_scan && s.ah == 0);
    const bool need_ac = !progressive || !dc_scan;
    if (need_dc && !derive_decoder(dc[s.td[i]], true, &dct[i])) return false;
    if (need_ac && !derive_decoder(ac[s.ta[i]], false, &act[i])) return false;
  }

  BitReader br{data, len, pos};
  int last_dc[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int restarts_left = restart_interval;
  int next_rst = 0;

  int mcus_x, mcus_y;
  if (n == 1) {
    mcus_x = im.comp[s.ci[0]].bw;
    mcus_y = im.comp[s.ci[0]].bh;
  } else {
    mcus_x = (im.width + im.max_h * 8 - 1) / (im.max_h * 8);
    mcus_y = (im.height + im.max_v * 8 - 1) / (im.max_v * 8);
  }
  const int p1 = 1 << s.al;
  const int m1 = -(1 << s.al);

  auto decode_block = [&](int i, int16_t* blk) -> void {
    if (!progressive) {
      int t = br.decode(dct[i]);
      if (t) t = extend(br.bits(t), t);
      last_dc[i] += t;
      blk[0] = static_cast<int16_t>(last_dc[i]);
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(act[i]);
        const int r = rs >> 4;
        const int sz = rs & 15;
        if (sz) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (dc_scan) {
      if (s.ah == 0) {
        int t = br.decode(dct[i]);
        if (t) t = extend(br.bits(t), t);
        last_dc[i] += t;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(last_dc[i]) << s.al);
      } else if (br.bit()) {
        blk[0] = static_cast<int16_t>(blk[0] | p1);
      }
      return;
    }
    if (s.ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = s.ss; k <= s.se; ++k) {
        const int rs = br.decode(act[i]);
        int r = rs >> 4;
        const int sz = rs & 15;
        if (sz) {
          k += r;
          const int v = extend(br.bits(sz), sz);
          blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << s.al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // AC refinement
    int k = s.ss;
    if (eobrun == 0) {
      for (; k <= s.se; ++k) {
        const int rs = br.decode(act[i]);
        int r = rs >> 4;
        int sz = rs & 15;
        if (sz) {
          if (sz != 1) br.bad = true;
          sz = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= s.se);
        if (sz) blk[kNatural[k]] = static_cast<int16_t>(sz);
        if (br.bad) return;
      }
    }
    if (eobrun > 0) {
      for (; k <= s.se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  };

  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval) {
        if (restarts_left == 0) {
          br.reset();
          pos = br.pos;
          if (next_marker() != 0xD0 + next_rst) return false;
          next_rst = (next_rst + 1) & 7;
          br.pos = pos;
          for (int& d : last_dc) d = 0;
          eobrun = 0;
          restarts_left = restart_interval;
        }
        --restarts_left;
      }
      if (n == 1) {
        decode_block(0, im.comp[s.ci[0]].block(mx, my));
      } else {
        for (int i = 0; i < n; ++i) {
          Component& c = im.comp[s.ci[i]];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx)
              decode_block(i, c.block(mx * c.h + xx, my * c.v + yy));
        }
      }
      if (br.bad) return false;
    }
  }
  pos = br.pos;
  return true;
}

bool Decoder::decode() {
  if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) return false;
  pos = 2;
  for (;;) {
    const int m = next_marker();
    if (m < 0) {  // the data ended without EOI
      if (scans == 0) return false;
      break;
    }
    if (m == 0xD9) {
      if (scans == 0) return false;
      break;
    }
    bool ok = true;
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        ok = read_sof(m);
        break;
      case 0xC4:
        ok = read_dht();
        break;
      case 0xDB:
        ok = read_dqt();
        break;
      case 0xDD:
        ok = read_dri();
        break;
      case 0xDA:
        ok = read_sos();
        break;
      case 0xFE:
      case 0xCC:  // DAC: conditioning of the arithmetic coder, unused here
      case 0xDC:  // DNL
        ok = skip_segment();
        break;
      case 0xD8:
        ok = false;
        break;
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          ok = read_app(m);
        } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
          ok = true;  // a stray RSTn or TEM: no parameters
        } else {
          ok = false;  // other SOFs (lossless, hierarchical, arithmetic)
        }
    }
    if (!ok) return false;
  }
  for (int i = 0; i < im.ncomp; ++i) {
    const Component& c = im.comp[i];
    if (!c.scanned) return false;
    if (progressive) {
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) return false;
    }
  }
  if (im.ncomp == 1) {
    im.color = ColorSpace::kGray;
  } else if (jfif) {
    im.color = ColorSpace::kYCbCr;
  } else if (adobe) {
    im.color = adobe_transform == 0 ? ColorSpace::kRGB : ColorSpace::kYCbCr;
  } else {
    const int a = im.comp[0].id, b = im.comp[1].id, c = im.comp[2].id;
    im.color = (a == 'R' && b == 'G' && c == 'B') ? ColorSpace::kRGB
                                                  : ColorSpace::kYCbCr;
  }
  return true;
}

// ------------------------------------------------------------ JPEG encoding
// jpeg_set_defaults + jpeg_set_quality(q, TRUE) on an RGB image: YCbCr 4:2:0
struct Encoded {
  Image im;
  uint16_t qt[2][64];
};

int quality_scaling(int q) {
  q = std::min(100, std::max(1, q));
  return q < 50 ? 5000 / q : 200 - q * 2;
}

// jfdctint.c, in place on 64 level-shifted samples
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;     // along a row, then a column
    const int next = pass == 0 ? 8 : 1;
    for (int i = 0; i < 8; ++i) {
      int32_t* p = d + i * next;
      const int64_t tmp0 = p[0 * step] + p[7 * step];
      const int64_t tmp7 = p[0 * step] - p[7 * step];
      const int64_t tmp1 = p[1 * step] + p[6 * step];
      const int64_t tmp6 = p[1 * step] - p[6 * step];
      const int64_t tmp2 = p[2 * step] + p[5 * step];
      const int64_t tmp5 = p[2 * step] - p[5 * step];
      const int64_t tmp3 = p[3 * step] + p[4 * step];
      const int64_t tmp4 = p[3 * step] - p[4 * step];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass == 0 ? kConstBits - kPass1Bits
                               : kConstBits + kPass1Bits;
      auto ds = [](int64_t x, int n) {
        return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n);
      };
      if (pass == 0) {
        p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = static_cast<int32_t>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        p[0] = ds(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = ds(tmp10 - tmp11, kPass1Bits);
      }
      const int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = ds(z1 + tmp13 * F0765, sh);
      p[6 * step] = ds(z1 + tmp12 * -F1847, sh);
      int64_t o1 = tmp4 + tmp7, o2 = tmp5 + tmp6, o3 = tmp4 + tmp6,
              o4 = tmp5 + tmp7;
      const int64_t z5 = (o3 + o4) * F1175;
      const int64_t t4 = tmp4 * F0298, t5 = tmp5 * F2053, t6 = tmp6 * F3072,
                    t7 = tmp7 * F1501;
      o1 *= -F0899;
      o2 *= -F2562;
      o3 = o3 * -F1961 + z5;
      o4 = o4 * -F0390 + z5;
      p[7 * step] = ds(t4 + o1 + o3, sh);
      p[5 * step] = ds(t5 + o2 + o4, sh);
      p[3 * step] = ds(t6 + o2 + o3, sh);
      p[1 * step] = ds(t7 + o1 + o4, sh);
    }
  }
}

// jcdctmgr.c's compute_reciprocal and quantize (16-bit DCT elements)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t{1} << r) / divisor;
  const uint64_t fr = (uint64_t{1} << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {static_cast<uint32_t>(fq), c, r};
}

inline int16_t quantize(int32_t x, const Divisor& d) {
  const bool neg = x < 0;
  const uint32_t a = static_cast<uint32_t>(neg ? -x : x);
  const uint32_t v = static_cast<uint32_t>(
      (static_cast<uint64_t>(a + d.corr) * d.recip) >> d.shift);
  const int16_t q = static_cast<int16_t>(v);
  return neg ? static_cast<int16_t>(-q) : q;
}

// jccolor.c's tables
struct RgbYccTables {
  int32_t t[8 * 256];
  RgbYccTables() {
    constexpr int kBits = 16;
    constexpr int32_t kHalf = 1 << (kBits - 1);
    constexpr int32_t kOffset = 128 << kBits;
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1 << kBits) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      t[i] = fix(0.29900) * i;
      t[i + 256] = fix(0.58700) * i;
      t[i + 512] = fix(0.11400) * i + kHalf;
      t[i + 768] = -fix(0.16874) * i;
      t[i + 1024] = -fix(0.33126) * i;
      t[i + 1280] = fix(0.50000) * i + kOffset + kHalf - 1;  // B->Cb, R->Cr
      t[i + 1536] = -fix(0.41869) * i;
      t[i + 1792] = -fix(0.08131) * i;
    }
  }
};

const RgbYccTables& rgb_ycc_tables() {
  static const RgbYccTables t;
  return t;
}

void encode_coefficients(const uint8_t* rgb, int h, int w, int quality,
                         Encoded* e) {
  const int scale = quality_scaling(quality);
  for (int i = 0; i < 64; ++i) {
    const int64_t l = (static_cast<int64_t>(kLumQuant[i]) * scale + 50) / 100;
    const int64_t c = (static_cast<int64_t>(kChromQuant[i]) * scale + 50) / 100;
    e->qt[0][i] = static_cast<uint16_t>(std::min<int64_t>(255, std::max<int64_t>(1, l)));
    e->qt[1][i] = static_cast<uint16_t>(std::min<int64_t>(255, std::max<int64_t>(1, c)));
  }
  Image& im = e->im;
  im.width = w;
  im.height = h;
  im.ncomp = 3;
  im.max_h = im.max_v = 2;
  im.color = ColorSpace::kYCbCr;
  const int mcus_x = (w + 15) / 16, mcus_y = (h + 15) / 16;
  for (int ci = 0; ci < 3; ++ci) {
    Component& c = im.comp[ci];
    c.id = ci + 1;
    c.h = c.v = ci == 0 ? 2 : 1;
    c.tq = ci == 0 ? 0 : 1;
    c.dw = ci == 0 ? w : (w + 1) / 2;
    c.dh = ci == 0 ? h : (h + 1) / 2;
    c.bw = (c.dw + 7) / 8;
    c.bh = (c.dh + 7) / 8;
    c.stride = mcus_x * c.h;
    c.rows = mcus_y * c.v;
    c.coef.assign(static_cast<size_t>(c.stride) * c.rows * 64, 0);
    std::memcpy(c.q, e->qt[c.tq], sizeof c.q);
    c.latched = c.scanned = true;
  }
  // colour conversion into full-size planes, the right edge replicated out
  // to the blocks' width (luma) and to twice the chroma blocks' width
  const RgbYccTables& t = rgb_ycc_tables();
  const int wy = im.comp[0].bw * 8;
  const int wc = im.comp[1].bw * 16;
  const int pw = std::max(wy, wc);
  const int ph = std::max(im.comp[0].bh * 8, 2 * ((h + 1) / 2));
  std::vector<uint8_t> plane[3];
  for (auto& p : plane) p.assign(static_cast<size_t>(pw) * ph, 0);
  for (int y = 0; y < ph; ++y) {
    const int sy = std::min(y, h - 1);
    const uint8_t* src = rgb + static_cast<size_t>(sy) * w * 3;
    uint8_t* py = plane[0].data() + static_cast<size_t>(y) * pw;
    uint8_t* pb = plane[1].data() + static_cast<size_t>(y) * pw;
    uint8_t* pr = plane[2].data() + static_cast<size_t>(y) * pw;
    for (int x = 0; x < w; ++x) {
      const int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
      py[x] = static_cast<uint8_t>((t.t[r] + t.t[g + 256] + t.t[b + 512]) >> 16);
      pb[x] = static_cast<uint8_t>((t.t[r + 768] + t.t[g + 1024] + t.t[b + 1280]) >> 16);
      pr[x] = static_cast<uint8_t>((t.t[r + 1280] + t.t[g + 1536] + t.t[b + 1792]) >> 16);
    }
    for (int x = w; x < pw; ++x) {
      py[x] = py[w - 1];
      pb[x] = pb[w - 1];
      pr[x] = pr[w - 1];
    }
  }
  // h2v2_downsample: bias 1, 2, 1, 2, ... along each output row; the rows
  // past the downsampled height repeat its last row
  std::vector<uint8_t> chroma[2];
  const int cw = im.comp[1].bw * 8, chh = im.comp[1].bh * 8;
  const int dh = im.comp[1].dh;
  for (int k = 0; k < 2; ++k) {
    chroma[k].assign(static_cast<size_t>(cw) * chh, 0);
    const std::vector<uint8_t>& src = plane[1 + k];
    for (int y = 0; y < chh; ++y) {
      uint8_t* dst = chroma[k].data() + static_cast<size_t>(y) * cw;
      if (y >= dh) {
        std::memcpy(dst, chroma[k].data() + static_cast<size_t>(dh - 1) * cw, cw);
        continue;
      }
      const uint8_t* in0 = src.data() + static_cast<size_t>(2 * y) * pw;
      const uint8_t* in1 = in0 + pw;
      int bias = 1;
      for (int x = 0; x < cw; ++x) {
        dst[x] = static_cast<uint8_t>(
            (in0[2 * x] + in0[2 * x + 1] + in1[2 * x] + in1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  // forward DCT and quantisation of every block of real samples
  Divisor div[2][64];
  for (int k = 0; k < 2; ++k)
    for (int i = 0; i < 64; ++i) div[k][i] = reciprocal(e->qt[k][i] << 3);
  for (int ci = 0; ci < 3; ++ci) {
    Component& c = im.comp[ci];
    const uint8_t* src = ci == 0 ? plane[0].data() : chroma[ci - 1].data();
    const size_t stride = ci == 0 ? pw : cw;
    const Divisor* dv = div[c.tq];
    for (int by = 0; by < c.bh; ++by) {
      for (int bx = 0; bx < c.bw; ++bx) {
        int32_t ws[64];
        for (int r = 0; r < 8; ++r) {
          const uint8_t* s = src + (static_cast<size_t>(by) * 8 + r) * stride + bx * 8;
          for (int x = 0; x < 8; ++x) ws[r * 8 + x] = s[x] - 128;
        }
        fdct_islow(ws);
        int16_t* blk = c.block(bx, by);
        for (int i = 0; i < 64; ++i) blk[i] = quantize(ws[i], dv[i]);
      }
    }
  }
}

// jccoefct.c's dummy blocks at the right and bottom of the MCUs: zero AC,
// the DC of the block before
void fill_dummy_blocks(Image& im) {
  const int mcus_x = im.comp[0].stride / im.comp[0].h;
  const int mcus_y = im.comp[0].rows / im.comp[0].v;
  for (int ci = 0; ci < im.ncomp; ++ci) {
    Component& c = im.comp[ci];
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        const int16_t* prev = nullptr;
        for (int yy = 0; yy < c.v; ++yy) {
          for (int xx = 0; xx < c.h; ++xx) {
            const int bx = mx * c.h + xx, by = my * c.v + yy;
            int16_t* blk = c.block(bx, by);
            if (bx >= c.bw || by >= c.bh) {
              std::memset(blk, 0, 64 * sizeof(int16_t));
              blk[0] = prev[0];
            }
            prev = blk;
          }
        }
      }
    }
  }
}

struct HuffEncoder {
  uint32_t code[256] = {};
  int size[256] = {};
};

HuffEncoder derive_encoder(const HuffSpec& s) {
  int size[257];
  uint32_t code[257];
  int count = 0;
  canonical(s, size, code, &count);
  HuffEncoder e;
  for (int i = 0; i < count; ++i) {
    e.code[s.vals[i]] = code[i];
    e.size[s.vals[i]] = size[i];
  }
  return e;
}

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int nbits = 0;
  void put(uint32_t v, int n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
      nbits -= 8;
    }
  }
  void flush() { put(0x7F, 7); acc = 0; nbits = 0; }
};

void put_marker(std::vector<uint8_t>& out, int m) {
  out.push_back(0xFF);
  out.push_back(static_cast<uint8_t>(m));
}

void put16(std::vector<uint8_t>& out, int v) {
  out.push_back(static_cast<uint8_t>(v >> 8));
  out.push_back(static_cast<uint8_t>(v));
}

void put_dht(std::vector<uint8_t>& out, int index, const uint8_t* bits,
             const uint8_t* vals) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += bits[l];
  put_marker(out, 0xC4);
  put16(out, 2 + 1 + 16 + count);
  out.push_back(static_cast<uint8_t>(index));
  for (int l = 1; l <= 16; ++l) out.push_back(bits[l]);
  out.insert(out.end(), vals, vals + count);
}

void encode_block(BitWriter& bw, const int16_t* blk, int* last_dc,
                  const HuffEncoder& dc, const HuffEncoder& ac) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    const int i = (r << 4) + nbits;
    bw.put(ac.code[i], ac.size[i]);
    bw.put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

// the file libjpeg writes for these coefficients: SOI, JFIF APP0, DQT x2,
// SOF0, DHT x4, SOS, the entropy-coded MCUs, EOI
std::vector<uint8_t> write_jpeg(Encoded& e) {
  Image& im = e.im;
  fill_dummy_blocks(im);
  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(im.width) * im.height / 2 + 1024);
  put_marker(out, 0xD8);
  static const uint8_t kJfif[16] = {0x00, 0x10, 'J', 'F', 'I', 'F', 0,
                                    1,    1,    0,   0,   1,   0,   1, 0, 0};
  put_marker(out, 0xE0);
  out.insert(out.end(), kJfif, kJfif + 16);
  for (int k = 0; k < 2; ++k) {
    put_marker(out, 0xDB);
    put16(out, 67);
    out.push_back(static_cast<uint8_t>(k));
    for (int i = 0; i < 64; ++i)
      out.push_back(static_cast<uint8_t>(e.qt[k][kNatural[i]]));
  }
  put_marker(out, 0xC0);
  put16(out, 8 + 3 * 3);
  out.push_back(8);
  put16(out, im.height);
  put16(out, im.width);
  out.push_back(3);
  for (int ci = 0; ci < 3; ++ci) {
    out.push_back(static_cast<uint8_t>(im.comp[ci].id));
    out.push_back(static_cast<uint8_t>((im.comp[ci].h << 4) | im.comp[ci].v));
    out.push_back(static_cast<uint8_t>(im.comp[ci].tq));
  }
  put_dht(out, 0x00, kDcLumBits, kDcVals);
  put_dht(out, 0x10, kAcLumBits, kAcLumVals);
  put_dht(out, 0x01, kDcChromBits, kDcVals);
  put_dht(out, 0x11, kAcChromBits, kAcChromVals);
  put_marker(out, 0xDA);
  put16(out, 12);
  out.push_back(3);
  for (int ci = 0; ci < 3; ++ci) {
    out.push_back(static_cast<uint8_t>(im.comp[ci].id));
    out.push_back(ci == 0 ? 0x00 : 0x11);
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);
  const HuffEncoder dc[2] = {derive_encoder(std_spec(kDcLumBits, kDcVals)),
                             derive_encoder(std_spec(kDcChromBits, kDcVals))};
  const HuffEncoder ac[2] = {
      derive_encoder(std_spec(kAcLumBits, kAcLumVals)),
      derive_encoder(std_spec(kAcChromBits, kAcChromVals))};
  BitWriter bw{&out};
  int last_dc[3] = {0, 0, 0};
  const int mcus_x = im.comp[0].stride / 2, mcus_y = im.comp[0].rows / 2;
  for (int my = 0; my < mcus_y; ++my)
    for (int mx = 0; mx < mcus_x; ++mx)
      for (int ci = 0; ci < 3; ++ci) {
        Component& c = im.comp[ci];
        const int t = ci == 0 ? 0 : 1;
        for (int yy = 0; yy < c.v; ++yy)
          for (int xx = 0; xx < c.h; ++xx)
            encode_block(bw, c.block(mx * c.h + xx, my * c.v + yy),
                         &last_dc[ci], dc[t], ac[t]);
      }
  bw.flush();
  put_marker(out, 0xD9);
  return out;
}

// ---------------------------------------------------------------- PNG rows
inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// undo one row's filter in place; prev is the row above (zeros for the
// first row of a pass)
bool unfilter_row(int filter, uint8_t* row, const uint8_t* prev, size_t n,
                  int bpp) {
  switch (filter) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        const int left = i >= static_cast<size_t>(bpp) ? row[i - bpp] : 0;
        row[i] = static_cast<uint8_t>(row[i] + ((left + prev[i]) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        const bool has_left = i >= static_cast<size_t>(bpp);
        const int left = has_left ? row[i - bpp] : 0;
        const int up_left = has_left ? prev[i - bpp] : 0;
        row[i] = static_cast<uint8_t>(row[i] + paeth(left, prev[i], up_left));
      }
      return true;
    default:
      return false;
  }
}

// the sample at index i of a row of `depth`-bit samples (16 bits: the high
// byte, as png_set_strip_16)
inline uint8_t sample(const uint8_t* row, size_t i, int depth) {
  switch (depth) {
    case 8:
      return row[i];
    case 16:
      return row[2 * i];
    default: {
      const size_t bit = i * depth;
      const int shift = 8 - depth - static_cast<int>(bit & 7);
      return static_cast<uint8_t>((row[bit >> 3] >> shift) & ((1 << depth) - 1));
    }
  }
}

}  // namespace

extern "C" {

// A JPEG file (sniffed from its first bytes) as RGB uint8 (h, w, 3), in a
// buffer the caller frees with dg_free.  0 on success, -1 where the file is
// refused, -2 where it is not a JPEG (PNG is read by the Python side).
int dg_decode(const uint8_t* data, size_t len, uint8_t** out, int* h,
              int* w) {
  if (len < 3 || data[0] != 0xFF || data[1] != 0xD8 || data[2] != 0xFF)
    return -2;
  Decoder d{data, len};
  if (!d.decode()) return -1;
  *out = static_cast<uint8_t*>(std::malloc(
      static_cast<size_t>(d.im.height) * d.im.width * 3));
  if (*out == nullptr) return -1;
  output_rgb(d.im, *out);
  *h = d.im.height;
  *w = d.im.width;
  return 0;
}

// libjpeg's encode at `quality` (4:2:0, jpeg_set_defaults) and decode of an
// RGB uint8 image, on the coefficients (the entropy stage is lossless).
// out holds h * w * 3 bytes.  0 on success.
int dg_jpeg_roundtrip(const uint8_t* rgb, int h, int w, int quality,
                      uint8_t* out) {
  if (h <= 0 || w <= 0 || h > 65500 || w > 65500) return -1;
  Encoded e;
  encode_coefficients(rgb, h, w, quality, &e);
  output_rgb(e.im, out);
  return 0;
}

// The JPEG file of an RGB uint8 image at `quality`, in a buffer the caller
// frees with dg_free.  0 on success.
int dg_jpeg_encode(const uint8_t* rgb, int h, int w, int quality,
                   uint8_t** buf, size_t* len) {
  if (h <= 0 || w <= 0 || h > 65500 || w > 65500) return -1;
  Encoded e;
  encode_coefficients(rgb, h, w, quality, &e);
  const std::vector<uint8_t> file = write_jpeg(e);
  *buf = static_cast<uint8_t*>(std::malloc(file.size()));
  if (*buf == nullptr) return -1;
  std::memcpy(*buf, file.data(), file.size());
  *len = file.size();
  return 0;
}

void dg_free(void* p) { std::free(p); }

// PNG's image data after inflate: the filtered rows of the whole image, or
// of the seven Adam7 passes, to (h, w, channels) samples of 8 bits (16-bit
// samples keep their high byte; 1, 2, 4-bit samples are unpacked, not
// scaled).  0 on success, -1 where the data is short or a filter unknown.
int dg_png_unfilter(uint8_t* raw, size_t len, int w, int h, int depth,
                    int channels, int interlace, uint8_t* out) {
  static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                  {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                  {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kPass : kWhole;
  const int npass = interlace ? 7 : 1;
  const int bits = depth * channels;
  const int bpp = std::max(1, bits / 8);
  size_t pos = 0;
  for (int p = 0; p < npass; ++p) {
    const int x0 = passes[p][0], y0 = passes[p][1];
    const int dx = passes[p][2], dy = passes[p][3];
    const int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t n = (static_cast<size_t>(pw) * bits + 7) / 8;
    std::vector<uint8_t> zero(n, 0);
    const uint8_t* prev = zero.data();
    for (int r = 0; r < ph; ++r) {
      if (pos + 1 + n > len) return -1;
      uint8_t* row = raw + pos + 1;
      if (!unfilter_row(raw[pos], row, prev, n, bpp)) return -1;
      uint8_t* dst = out + ((static_cast<size_t>(y0) + static_cast<size_t>(r) * dy) * w) * channels;
      for (int x = 0; x < pw; ++x) {
        uint8_t* px = dst + (static_cast<size_t>(x0) + static_cast<size_t>(x) * dx) * channels;
        for (int c = 0; c < channels; ++c)
          px[c] = sample(row, static_cast<size_t>(x) * channels + c, depth);
      }
      prev = row;
      pos += 1 + n;
    }
  }
  return 0;
}

}  // extern "C"
