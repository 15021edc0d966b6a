// The port's image codec: JPEG decoding (baseline, extended and
// progressive, Huffman or arithmetic coding), JPEG encoding with libjpeg's
// defaults, the exact libjpeg encode + decode round trip, and PNG's row
// filters and Adam7 passes.  C++17 and the standard library only: no
// libjpeg, libpng or zlib.  PNG's chunks, CRCs, inflate and deflate are in
// Python (data/png.py).
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
// Corrupt files read as libjpeg reads them where it only warns: data that
// ends or meets a marker inside a scan (zero bits, then the rest of the
// segment left alone), bad Huffman codes, restart markers out of sequence,
// progressive scans out of order, a component no scan reached (gray),
// progressive files left incomplete (block smoothing), arithmetic codes
// that overflow.
// The algorithms follow libjpeg-turbo, which carries this notice:
//   This software is based in part on the work of the Independent JPEG
//   Group.  Copyright (C) 1991-1998, Thomas G. Lane; libjpeg-turbo
//   Copyright (C) 2009-2023, D. R. Commander.  Distributed under the IJG
//   license and the Modified (3-clause) BSD License.
//
// Refused (the entry points return -1, the Python binding None), as libjpeg
// refuses them: lossless and hierarchical frames, precision other than 8
// bits, 2- and 4-component files (CMYK, YCCK), sampling ratios that are not
// integral, files that end or break inside their headers before the first
// scan, a second scan in a one-scan sequential file, and the marker
// segments libjpeg stops at.
//
// Built by data/native.py: g++ -std=c++17 -O3 -shared -fPIC imgcodec.cpp

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <initializer_list>
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

// The file's bytes, and past its end what libjpeg's memory source gives
// there (jdatasrc.c's fill_mem_input_buffer, with a warning): a fake EOI
// marker, FF D9, again and again.
struct Source {
  const uint8_t* data;
  size_t len;
  int at(size_t p) const {
    return p < len ? data[p] : ((p - len) & 1) ? 0xD9 : 0xFF;
  }
};

// The entropy-coded bytes of a scan: FF 00 is a data FF, FF FF... fill
// bytes before a marker.  At a marker (libjpeg's unread_marker; at the end
// of the file the fake EOI) the reader stops and feeds zero bits.  The
// first decode that consumes one of them makes the data insufficient
// (jdhuff.c's jpeg_fill_bit_buffer: JWRN_HIT_MARKER, once); the decode
// goes on with the zeros, and the entropy decoders leave the rest of the
// segment's MCUs alone.
struct BitReader {
  Source src;
  size_t pos;
  int marker = 0;
  uint64_t acc = 0;
  int nbits = 0;  // bits in acc
  int npad = 0;   // of which zero bits fed past a marker
  bool insufficient = false;

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!marker) {
        byte = src.at(pos++);
        if (byte == 0xFF) {
          do byte = src.at(pos++);
          while (byte == 0xFF);
          if (byte == 0) {
            byte = 0xFF;
          } else {
            marker = byte;
            byte = 0;
          }
        }
      }
      if (marker) npad += 8;
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
    if (nbits < npad) {
      insufficient = true;
      npad = nbits;
    }
  }
  int bits(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    consume(n);
    return static_cast<int>(v);
  }
  int bit() { return bits(1); }
  // a code that matches no symbol takes 17 bits and reads as 0
  // (jpeg_huff_decode's JWRN_HUFF_BAD_CODE)
  int decode(const HuffDecoder& t) {
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
    consume(l);
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // drop the bits left (a restart); the byte position stays
  void discard() {
    acc = 0;
    nbits = 0;
    npad = 0;
  }
};

// ------------------------------------------------- arithmetic decoding
// ITU T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS of
// each probability state, and libjpeg's state 113, a fixed Qe of 0x5a1d
// (jaricom.c's entry for bits coded at an even chance).
struct QeState {
  uint16_t qe;
  uint8_t nlps, nmps, swtch;
};
constexpr QeState kQe[114] = {
    {0x5a1d,   1,   1, 1}, {0x2586,  14,   2, 0}, {0x1114,  16,   3, 0},
    {0x080b,  18,   4, 0}, {0x03d8,  20,   5, 0}, {0x01da,  23,   6, 0},
    {0x00e5,  25,   7, 0}, {0x006f,  28,   8, 0}, {0x0036,  30,   9, 0},
    {0x001a,  33,  10, 0}, {0x000d,  35,  11, 0}, {0x0006,   9,  12, 0},
    {0x0003,  10,  13, 0}, {0x0001,  12,  13, 0}, {0x5a7f,  15,  15, 1},
    {0x3f25,  36,  16, 0}, {0x2cf2,  38,  17, 0}, {0x207c,  39,  18, 0},
    {0x17b9,  40,  19, 0}, {0x1182,  42,  20, 0}, {0x0cef,  43,  21, 0},
    {0x09a1,  45,  22, 0}, {0x072f,  46,  23, 0}, {0x055c,  48,  24, 0},
    {0x0406,  49,  25, 0}, {0x0303,  51,  26, 0}, {0x0240,  52,  27, 0},
    {0x01b1,  54,  28, 0}, {0x0144,  56,  29, 0}, {0x00f5,  57,  30, 0},
    {0x00b7,  59,  31, 0}, {0x008a,  60,  32, 0}, {0x0068,  62,  33, 0},
    {0x004e,  63,  34, 0}, {0x003b,  32,  35, 0}, {0x002c,  33,   9, 0},
    {0x5ae1,  37,  37, 1}, {0x484c,  64,  38, 0}, {0x3a0d,  65,  39, 0},
    {0x2ef1,  67,  40, 0}, {0x261f,  68,  41, 0}, {0x1f33,  69,  42, 0},
    {0x19a8,  70,  43, 0}, {0x1518,  72,  44, 0}, {0x1177,  73,  45, 0},
    {0x0e74,  74,  46, 0}, {0x0bfb,  75,  47, 0}, {0x09f8,  77,  48, 0},
    {0x0861,  78,  49, 0}, {0x0706,  79,  50, 0}, {0x05cd,  48,  51, 0},
    {0x04de,  50,  52, 0}, {0x040f,  50,  53, 0}, {0x0363,  51,  54, 0},
    {0x02d4,  52,  55, 0}, {0x025c,  53,  56, 0}, {0x01f8,  54,  57, 0},
    {0x01a4,  55,  58, 0}, {0x0160,  56,  59, 0}, {0x0125,  57,  60, 0},
    {0x00f6,  58,  61, 0}, {0x00cb,  59,  62, 0}, {0x00ab,  61,  63, 0},
    {0x008f,  61,  32, 0}, {0x5b12,  65,  65, 1}, {0x4d04,  80,  66, 0},
    {0x412c,  81,  67, 0}, {0x37d8,  82,  68, 0}, {0x2fe8,  83,  69, 0},
    {0x293c,  84,  70, 0}, {0x2379,  86,  71, 0}, {0x1edf,  87,  72, 0},
    {0x1aa9,  87,  73, 0}, {0x174e,  72,  74, 0}, {0x1424,  72,  75, 0},
    {0x119c,  74,  76, 0}, {0x0f6b,  74,  77, 0}, {0x0d51,  75,  78, 0},
    {0x0bb6,  77,  79, 0}, {0x0a40,  77,  48, 0}, {0x5832,  80,  81, 1},
    {0x4d1c,  88,  82, 0}, {0x438e,  89,  83, 0}, {0x3bdd,  90,  84, 0},
    {0x34ee,  91,  85, 0}, {0x2eae,  92,  86, 0}, {0x299a,  93,  87, 0},
    {0x2516,  86,  71, 0}, {0x5570,  88,  89, 1}, {0x4ca9,  95,  90, 0},
    {0x44d9,  96,  91, 0}, {0x3e22,  97,  92, 0}, {0x3824,  99,  93, 0},
    {0x32b4,  99,  94, 0}, {0x2e17,  93,  86, 0}, {0x56a8,  95,  96, 1},
    {0x4f46, 101,  97, 0}, {0x47e5, 102,  98, 0}, {0x41cf, 103,  99, 0},
    {0x3c3d, 104, 100, 0}, {0x375e,  99,  93, 0}, {0x5231, 105, 102, 0},
    {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415e, 103,  99, 0},
    {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0},
};

// T.81 Annex D's decoder (D.2.4-D.2.6) as jdarith.c runs it: bytes as the
// Huffman reader takes them, and after a marker zero bytes, which is legal
// in arithmetic coding (no warning, nothing left undecoded).  ct == -1
// marks a code that overflowed (JWRN_ARITH_BAD_CODE): the rest of the
// segment is left alone.
struct ArithReader {
  Source src;
  size_t pos;
  int marker = 0;
  int64_t c = 0, a = 0;
  int ct = -16;  // two bytes to read before the first decision

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  // a decision in the context of statistics bin *st (its state index in
  // bits 0-6, its more probable symbol in bit 7)
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!marker) {
          data = src.at(pos++);
          if (data == 0xFF) {
            do data = src.at(pos++);
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const QeState& e = kQe[sv & 0x7F];
    const int64_t qe = e.qe;
    const int nl = e.nlps | (e.swtch << 7), nm = e.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
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
  bool latched = false;      // its quantisation table, from its first scan
  uint16_t q[64] = {};       // zero until then: the component reads gray
  // progressive: the successive-approximation bit of each coefficient
  // (-1: not yet coded), and its value before the component's last scan
  // (jdphuff.c's coef_bits and their second half)
  int coef_bits[64];
  int prev_bits[64];
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

// ------------------------------------------------- progressive smoothing
// jdcoefct.c's decompress_smooth_data as libjpeg-turbo 2.1 has it: where a
// progressive file leaves AC 1-9 incomplete, each block's missing low
// coefficients are estimated from the DC values of its 5x5 neighbourhood
// (and, where none of AC 1-9 is coded, its DC too); an estimate replaces
// only a coefficient that is still zero.
struct Smoothing {
  int total_rows = 0;   // iMCU rows
  int last_good = 0;    // the last iMCU row the last scan reached in full
  int cur[3][10];       // coef_bits of coefficients 0-9 after the scans
  int prev[3][10];      // and before each component's last scan
};

// the estimate of a coefficient whose quantiser is qk from num, clamped
// below 2^al where its first al bits are still to come
inline int16_t predict(int64_t q00, int64_t qk, int64_t num, int al,
                       bool clamp) {
  num *= q00;
  int64_t pred = num >= 0 ? ((qk << 7) + num) / (qk << 8)
                          : ((qk << 7) - num) / (qk << 8);
  if (clamp && al > 0 && pred >= (int64_t{1} << al))
    pred = (int64_t{1} << al) - 1;
  return static_cast<int16_t>(num >= 0 ? pred : -pred);
}

void smooth_plane(Component& c, const int* cur, const int* prev,
                  const Smoothing& sm, uint8_t* plane) {
  const size_t pw = static_cast<size_t>(c.bw) * 8;
  const int last = sm.total_rows - 1, v = c.v, last_col = c.bw - 1;
  const int64_t q00 = c.q[0];
  for (int row = 0; row <= last; ++row) {
    int block_rows = v;
    if (row == last) {
      block_rows = c.bh % v;
      if (block_rows == 0) block_rows = v;
    }
    const int* bits = row > sm.last_good ? prev : cur;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    for (int br = 0; br < block_rows; ++br) {
      const int y = row * v + br;
      int r[5];
      r[2] = y;
      r[1] = (br > 0 || row > 0) ? y - 1 : y;
      r[0] = (br > 1 || row > 1) ? y - 2 : r[1];
      r[3] = (br < block_rows - 1 || row < last) ? y + 1 : y;
      r[4] = (br < block_rows - 2 || row + 1 < last) ? y + 2 : r[3];
      // dc[i][j]: the DC of row r[i], column bx - 2 + j, as a sliding
      // register that starts with column 0 everywhere
      int dc[5][5];
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) dc[i][j] = c.block(0, r[i])[0];
      for (int bx = 0; bx <= last_col; ++bx) {
        if (bx == 0 && bx < last_col)
          for (int i = 0; i < 5; ++i) dc[i][3] = c.block(1, r[i])[0];
        if (bx + 1 < last_col)
          for (int i = 0; i < 5; ++i) dc[i][4] = c.block(bx + 2, r[i])[0];
        const int D01 = dc[0][0], D02 = dc[0][1], D03 = dc[0][2],
                  D04 = dc[0][3], D05 = dc[0][4], D06 = dc[1][0],
                  D07 = dc[1][1], D08 = dc[1][2], D09 = dc[1][3],
                  D10 = dc[1][4], D11 = dc[2][0], D12 = dc[2][1],
                  D13 = dc[2][2], D14 = dc[2][3], D15 = dc[2][4],
                  D16 = dc[3][0], D17 = dc[3][1], D18 = dc[3][2],
                  D19 = dc[3][3], D20 = dc[3][4], D21 = dc[4][0],
                  D22 = dc[4][1], D23 = dc[4][2], D24 = dc[4][3],
                  D25 = dc[4][4];
        int16_t ws[64];
        std::memcpy(ws, c.block(bx, y), sizeof ws);
        auto est = [&](int pos, int k, int64_t num) {
          if (bits[k] != 0 && ws[pos] == 0)
            ws[pos] = predict(q00, c.q[pos], num, bits[k], true);
        };
        est(1, 1, change_dc
            ? -D01 - D02 + D04 + D05 - 3 * D06 + 13 * D07 - 13 * D09
              + 3 * D10 - 3 * D11 + 38 * D12 - 38 * D14 + 3 * D15 - 3 * D16
              + 13 * D17 - 13 * D19 + 3 * D20 - D21 - D22 + D24 + D25
            : -7 * D11 + 50 * D12 - 50 * D14 + 7 * D15);
        est(8, 2, change_dc
            ? -D01 - 3 * D02 - 3 * D03 - 3 * D04 - D05 - D06 + 13 * D07
              + 38 * D08 + 13 * D09 - D10 + D16 - 13 * D17 - 38 * D18
              - 13 * D19 + D20 + D21 + 3 * D22 + 3 * D23 + 3 * D24 + D25
            : -7 * D03 + 50 * D08 - 50 * D18 + 7 * D23);
        est(16, 3, change_dc
            ? D03 + 2 * D07 + 7 * D08 + 2 * D09 - 5 * D12 - 14 * D13
              - 5 * D14 + 2 * D17 + 7 * D18 + 2 * D19 + D23
            : -D03 + 13 * D08 - 24 * D13 + 13 * D18 - D23);
        est(9, 4, change_dc
            ? -D01 + D05 + 9 * D07 - 9 * D09 - 9 * D17 + 9 * D19 + D21 - D25
            : D10 + D16 - 10 * D17 + 10 * D19 - D02 - D20 + D22 - D24 + D04
              - D06 + 10 * D07 - 10 * D09);
        est(2, 5, change_dc
            ? 2 * D07 - 5 * D08 + 2 * D09 + D11 + 7 * D12 - 14 * D13
              + 7 * D14 + D15 + 2 * D17 - 5 * D18 + 2 * D19
            : -D11 + 13 * D12 - 24 * D13 + 13 * D14 - D15);
        if (change_dc) {
          est(3, 6, D07 - D09 + 2 * D12 - 2 * D14 + D17 - D19);
          est(10, 7, D07 - 3 * D08 + D09 - D17 + 3 * D18 - D19);
          est(17, 8, D07 - D09 - 3 * D12 + 3 * D14 + D17 - D19);
          est(24, 9, D07 + 2 * D08 + D09 - D17 - 2 * D18 - D19);
          ws[0] = predict(q00, q00,
                          -2 * D01 - 6 * D02 - 8 * D03 - 6 * D04 - 2 * D05
                          - 6 * D06 + 6 * D07 + 42 * D08 + 6 * D09 - 6 * D10
                          - 8 * D11 + 42 * D12 + 152 * D13 + 42 * D14
                          - 8 * D15 - 6 * D16 + 6 * D17 + 42 * D18 + 6 * D19
                          - 6 * D20 - 2 * D21 - 6 * D22 - 8 * D23 - 6 * D24
                          - 2 * D25, 0, false);
        }
        idct_islow(ws, c.q, plane + static_cast<size_t>(y) * 8 * pw + bx * 8,
                   pw);
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 4; ++j) dc[i][j] = dc[i][j + 1];
      }
    }
  }
}

// IDCT of every block of the image's components (smoothed where sm says
// so), then upsampling and colour conversion into out (height * width * 3
// RGB).
void output_rgb(Image& im, uint8_t* out, const Smoothing* sm = nullptr) {
  std::vector<uint8_t> planes[3];
  for (int ci = 0; ci < im.ncomp; ++ci) {
    Component& c = im.comp[ci];
    const size_t pw = static_cast<size_t>(c.bw) * 8;
    planes[ci].assign(pw * c.bh * 8, 0);
    if (sm) {
      smooth_plane(c, sm->cur[ci], sm->prev[ci], *sm, planes[ci].data());
      continue;
    }
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
struct Scan {
  int n = 0;
  int ci[4];
  int td[4], ta[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

// jdmarker.c's markers and jdhuff.c's / jdphuff.c's scans, with what
// libjpeg does where the data is corrupt and it only warns: a scan whose
// data ends early or meets a marker fills with zero bits and leaves the
// rest of its segment alone; a bad Huffman code reads as 0; restart
// markers out of sequence are resynchronised (jpeg_resync_to_restart);
// progressive scans out of order are decoded as they come; a component no
// scan reached reads gray.
struct Decoder {
  Decoder(const uint8_t* d, size_t n) : src{d, n} {}
  Source src;
  size_t pos = 0;
  int unread = 0;  // the marker the last scan's data stopped at
  Image im;
  bool have_sof = false, progressive = false, arith = false, jfif = false,
       adobe = false;
  int adobe_transform = -1;
  bool multi_scan = false;  // jdinput.c's has_multiple_scans
  // the arithmetic coder's conditioning of each table (DAC; SOI's defaults)
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  int restart_interval = 0;
  bool qdef[4] = {};
  uint16_t qt[4][64];
  HuffSpec dc[4], ac[4];
  bool std_tables_set = false;
  int scans = 0;
  int last_good = 0;  // jdcoefct.c's last_good_iMCU_row

  int u8() { return src.at(pos++); }
  int u16() {
    const int a = u8();
    return (a << 8) | u8();
  }

  // libjpeg's next_marker: skip bytes up to FF, fill FFs, FF 00 pairs
  int next_marker() {
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do c = u8();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  bool read_sof(int marker) {
    if (have_sof) return false;
    const int length = u16();
    const int precision = u8();
    im.height = u16();
    im.width = u16();
    im.ncomp = u8();
    if (precision != 8 || im.height <= 0 || im.width <= 0
        || im.height > 65500 || im.width > 65500) return false;
    if (im.ncomp != 1 && im.ncomp != 3) return false;
    if (length != 8 + im.ncomp * 3) return false;
    for (int i = 0; i < im.ncomp; ++i) {
      Component& c = im.comp[i];
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return false;
      im.max_h = std::max(im.max_h, c.h);
      im.max_v = std::max(im.max_v, c.v);
    }
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker == 0xC9 || marker == 0xCA;
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
      for (int& b : c.prev_bits) b = -1;
    }
    have_sof = true;
    return true;
  }

  bool read_dqt() {
    int length = u16() - 2;
    while (length > 0) {
      --length;
      const int pq_tq = u8();
      const int prec = pq_tq >> 4, n = pq_tq & 15;
      if (n > 3) return false;
      for (int i = 0; i < 64; ++i)
        qt[n][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : u8());
      qdef[n] = true;
      length -= prec ? 128 : 64;
    }
    return length == 0;
  }

  bool read_dht() {
    int length = u16() - 2;
    while (length > 16) {
      int index = u8();
      HuffSpec s;
      s.defined = true;
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        s.bits[l] = static_cast<uint8_t>(u8());
        count += s.bits[l];
      }
      length -= 17;
      if (count > 256 || count > length) return false;
      for (int i = 0; i < count; ++i) s.vals[i] = static_cast<uint8_t>(u8());
      length -= count;
      const bool is_ac = index & 0x10;
      if (is_ac) index -= 0x10;
      if (index > 3) return false;
      (is_ac ? ac : dc)[index] = s;
    }
    return length == 0;
  }

  // DAC: the arithmetic coder's conditioning
  bool read_dac() {
    int length = u16() - 2;
    while (length > 0) {
      const int index = u8(), val = u8();
      length -= 2;
      if (index >= 32) return false;
      if (index >= 16) {
        ac_k[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_l[index] = static_cast<uint8_t>(val & 15);
        dc_u[index] = static_cast<uint8_t>(val >> 4);
        if (dc_l[index] > dc_u[index]) return false;
      }
    }
    return length == 0;
  }

  void skip_segment() {
    const int length = u16() - 2;
    if (length > 0) pos += length;
  }

  // APPn: JFIF (APP0) and Adobe (APP14) are looked at in the first 14
  // bytes, the rest skipped
  void read_app(int marker) {
    const int length = u16() - 2;
    const int n = std::min(std::max(length, 0), 14);
    uint8_t head[14];
    for (int i = 0; i < n; ++i) head[i] = static_cast<uint8_t>(u8());
    if (marker == 0xE0 && n >= 14 && std::memcmp(head, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(head, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = head[11];
    }
    if (length > n) pos += length - n;
  }

  bool read_dri() {
    if (u16() != 4) return false;
    restart_interval = u16();
    return true;
  }

  // jdcoefct.c's smoothing_ok, with the coefficient bits it latches
  bool smoothing(Smoothing* sm) const {
    if (!progressive) return false;
    bool useful = false;
    for (int ci = 0; ci < im.ncomp; ++ci) {
      const Component& c = im.comp[ci];
      if (!c.latched) return false;
      for (int p : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.q[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) {
        sm->cur[ci][k] = c.coef_bits[k];
        sm->prev[ci][k] = scans > 1 ? c.prev_bits[k] : -1;
        useful = useful || c.coef_bits[k] != 0;
      }
    }
    sm->total_rows = (im.height + im.max_v * 8 - 1) / (im.max_v * 8);
    sm->last_good = last_good;
    return useful;
  }

  void resync(size_t* rpos, int* marker, int* next_rst);
  bool read_sos();
  bool arith_scan(const Scan& s, bool need_dc, bool need_ac, int mcus_x,
                  int mcus_y, int mcu_rows_per_imcu);
  bool decode();
};


// jdmarker.c's read_restart_marker, for a reader at *rpos that stopped at
// *marker (0: none yet): read the expected RSTn, or resynchronise as
// jpeg_resync_to_restart does: a marker below SOF0 or one of the two RSTs
// before the expected one is skipped for the next marker; another marker,
// or one of the two RSTs after it, is left for later (the segment then
// reads as empty); any other RST is taken.
void Decoder::resync(size_t* rpos, int* marker, int* next_rst) {
  auto scan_on = [&] {
    pos = *rpos;
    *marker = next_marker();
    *rpos = pos;
  };
  if (!*marker) scan_on();
  const int want = *next_rst;
  auto rst = [](int k) { return 0xD0 + (k & 7); };
  while (*marker != rst(want)) {
    const int m = *marker;
    if (m < 0xC0 || m == rst(want - 1) || m == rst(want - 2)) {
      scan_on();
    } else if (m < 0xD0 || m > 0xD7 || m == rst(want + 1)
               || m == rst(want + 2)) {
      break;
    } else {
      *marker = 0;
      break;
    }
  }
  if (*marker == rst(want)) *marker = 0;
  *next_rst = (want + 1) & 7;
}

bool Decoder::read_sos() {
  if (!have_sof) return false;
  const int length = u16();
  const int n = u8();
  if (n < 1 || n > 4 || length != 6 + 2 * n) return false;
  Scan s;
  s.n = n;
  for (int i = 0; i < n; ++i) {
    const int id = u8(), t = u8();
    int found = -1;
    for (int k = 0; k < im.ncomp; ++k)
      if (im.comp[k].id == id) found = k;
    if (found < 0) return false;
    for (int k = 0; k < i; ++k)
      if (s.ci[k] == found) return false;
    s.ci[i] = found;
    s.td[i] = t >> 4;
    s.ta[i] = t & 15;
  }
  s.ss = u8();
  s.se = u8();
  const int a = u8();
  s.ah = a >> 4;
  s.al = a & 15;
  if (++scans == 1) {
    // jdinput.c: a file whose first scan holds every component of a
    // sequential frame has one scan; a second SOS is an error there
    multi_scan = progressive || n < im.ncomp;
    if (im.ncomp == 1) {
      im.color = ColorSpace::kGray;
    } else if (jfif) {
      im.color = ColorSpace::kYCbCr;
    } else if (adobe) {
      im.color = adobe_transform == 0 ? ColorSpace::kRGB : ColorSpace::kYCbCr;
    } else {
      const int c0 = im.comp[0].id, c1 = im.comp[1].id, c2 = im.comp[2].id;
      im.color = (c0 == 'R' && c1 == 'G' && c2 == 'B') ? ColorSpace::kRGB
                                                       : ColorSpace::kYCbCr;
    }
  } else if (!multi_scan) {
    return false;
  }

  // libjpeg-turbo's sequential decoder fills Huffman slots 0 and 1 left
  // empty by the first scan with the standard tables (Motion-JPEG files
  // omit them); its progressive decoder does not
  if (!std_tables_set && !progressive && !arith) {
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
      if (c.tq > 3 || !qdef[c.tq]) return false;
      std::memcpy(c.q, qt[c.tq], sizeof c.q);
      c.latched = true;
    }
  }

  // a sequential scan with other Ss, Se, Ah, Al draws only a warning
  // (JWRN_NOT_SEQUENTIAL) and decodes as a whole one
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
    // the progression's order is only warned about (JWRN_BOGUS_PROGRESSION)
    for (int i = 0; i < n; ++i) {
      Component& c = im.comp[s.ci[i]];
      for (int k = std::min(s.ss, 1); k <= std::max(s.se, 9); ++k)
        c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
      for (int k = s.ss; k <= s.se; ++k) c.coef_bits[k] = s.al;
    }
  }

  const bool need_dc = !progressive || (dc_scan && s.ah == 0);
  const bool need_ac = !progressive || !dc_scan;
  int mcus_x, mcus_y, mcu_rows_per_imcu = 1;
  if (n == 1) {
    mcus_x = im.comp[s.ci[0]].bw;
    mcus_y = im.comp[s.ci[0]].bh;
    mcu_rows_per_imcu = im.comp[s.ci[0]].v;
  } else {
    mcus_x = (im.width + im.max_h * 8 - 1) / (im.max_h * 8);
    mcus_y = (im.height + im.max_v * 8 - 1) / (im.max_v * 8);
  }
  if (arith) return arith_scan(s, need_dc, need_ac, mcus_x, mcus_y,
                               mcu_rows_per_imcu);

  HuffDecoder dct[4], act[4];
  for (int i = 0; i < n; ++i) {
    if (need_dc && (s.td[i] > 3 || !derive_decoder(dc[s.td[i]], true, &dct[i])))
      return false;
    if (need_ac && (s.ta[i] > 3 || !derive_decoder(ac[s.ta[i]], false, &act[i])))
      return false;
  }

  BitReader br{src, pos};
  int last_dc[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int restarts_left = restart_interval;
  int next_rst = 0;
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
    // AC refinement; a new coefficient of another size than 1 is only
    // warned about (JWRN_HUFF_BAD_CODE)
    int k = s.ss;
    if (eobrun == 0) {
      for (; k <= s.se; ++k) {
        const int rs = br.decode(act[i]);
        int r = rs >> 4;
        int sz = rs & 15;
        if (sz) {
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
      if (!br.insufficient) last_good = my / mcu_rows_per_imcu;
      if (restart_interval) {
        if (restarts_left == 0) {
          br.discard();  // jdhuff.c's process_restart
          resync(&br.pos, &br.marker, &next_rst);
          for (int& d : last_dc) d = 0;
          eobrun = 0;
          restarts_left = restart_interval;
          // the flag stays where the RST left the reader at a marker
          if (!br.marker) br.insufficient = false;
        }
        --restarts_left;
      }
      if (br.insufficient) continue;  // the MCU keeps what it has
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
    }
  }
  pos = br.pos;
  unread = br.marker;
  return true;
}

// jdarith.c's scans: T.81 F.1.4.4 (sequential) and G.1.3 (progressive),
// the statistics bins of each table zeroed at the scan's start and at each
// restart
bool Decoder::arith_scan(const Scan& s, bool need_dc, bool need_ac,
                         int mcus_x, int mcus_y, int mcu_rows_per_imcu) {
  const int n = s.n;
  for (int i = 0; i < n; ++i)
    if ((need_dc && s.td[i] > 15) || (need_ac && s.ta[i] > 15)) return false;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;
  int last_dc[4] = {0, 0, 0, 0};
  int dc_context[4] = {0, 0, 0, 0};
  auto reset_stats = [&] {
    for (int i = 0; i < n; ++i) {
      if (need_dc) {
        std::memset(dc_stats[s.td[i]], 0, sizeof dc_stats[0]);
        last_dc[i] = dc_context[i] = 0;
      }
      if (!progressive || s.ss) std::memset(ac_stats[s.ta[i]], 0, sizeof ac_stats[0]);
    }
  };
  reset_stats();
  ArithReader ar{src, pos};
  const int p1 = 1 << s.al;
  const int m1 = -(1 << s.al);

  // Figures F.19, F.21-F.24: a DC difference into last_dc[i]; false where
  // its magnitude overflows
  auto dc_diff = [&](int i) -> bool {
    const int tbl = s.td[i];
    uint8_t* st = dc_stats[tbl] + dc_context[i];
    if (ar.decode(st) == 0) {
      dc_context[i] = 0;
      return true;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;
          return false;
        }
        ++st;
      }
    }
    if (m < ((1 << dc_l[tbl]) >> 1))
      dc_context[i] = 0;
    else if (m > ((1 << dc_u[tbl]) >> 1))
      dc_context[i] = 12 + sign * 4;
    else
      dc_context[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[i] = (last_dc[i] + v) & 0xffff;
    return true;
  };
  // Figure F.20: AC coefficients k0..k1 of a block, scaled by al; false
  // where the band or a magnitude overflows
  auto ac_band = [&](int i, int16_t* blk, int k0, int k1, int al) -> bool {
    const int tbl = s.ta[i];
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) {
          ar.ct = -1;
          return false;
        }
      }
      const int sign = ar.decode(&fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
    return true;
  };
  // Figure G.10 as jdarith.c has it: correction bits of the coefficients
  // already nonzero, new ones of +-2^al
  auto ac_refine = [&](int i, int16_t* blk) {
    const int tbl = s.ta[i];
    int kex = s.se;
    while (kex > 0 && !blk[kNatural[kex]]) --kex;
    for (int k = s.ss; k <= s.se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ar.decode(st + 2))
            *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = static_cast<int16_t>(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > s.se) {
          ar.ct = -1;
          return;
        }
      }
    }
  };
  // one block; false where the rest of the MCU is to be left alone
  auto decode_block = [&](int i, int16_t* blk) -> bool {
    if (!progressive) {
      if (!dc_diff(i)) return false;
      blk[0] = static_cast<int16_t>(last_dc[i]);
      return ac_band(i, blk, 1, 63, 0);
    }
    if (s.ss == 0 && s.ah == 0) {
      if (!dc_diff(i)) return false;
      blk[0] = static_cast<int16_t>(static_cast<uint32_t>(last_dc[i]) << s.al);
      return true;
    }
    if (s.ss == 0) {
      if (ar.decode(&fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | p1);
      return true;
    }
    if (s.ah == 0) return ac_band(i, blk, s.ss, s.se, s.al);
    ac_refine(i, blk);
    return ar.ct != -1;
  };

  int restarts_left = restart_interval;
  int next_rst = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      last_good = my / mcu_rows_per_imcu;  // the data is never insufficient
      if (restart_interval) {
        if (restarts_left == 0) {
          resync(&ar.pos, &ar.marker, &next_rst);
          reset_stats();
          ar.reset();
          restarts_left = restart_interval;
        }
        --restarts_left;
      }
      if (ar.ct == -1) continue;
      if (n == 1) {
        decode_block(0, im.comp[s.ci[0]].block(mx, my));
        continue;
      }
      bool go = true;
      for (int i = 0; i < n && go; ++i) {
        Component& c = im.comp[s.ci[i]];
        for (int yy = 0; yy < c.v && go; ++yy)
          for (int xx = 0; xx < c.h && go; ++xx)
            go = decode_block(i, c.block(mx * c.h + xx, my * c.v + yy));
      }
    }
  }
  pos = ar.pos;
  unread = ar.marker;
  return true;
}

bool Decoder::decode() {
  if (src.len < 2 || src.data[0] != 0xFF || src.data[1] != 0xD8) return false;
  pos = 2;
  for (int t = 0; t < 16; ++t) {
    dc_l[t] = 0;
    dc_u[t] = 1;
    ac_k[t] = 5;
  }
  for (;;) {
    const int m = unread ? unread : next_marker();
    unread = 0;
    if (m == 0xD9) return scans > 0;  // EOI, real or at the end of the data
    bool ok = true;
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
      case 0xC9:
      case 0xCA:
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
      case 0xCC:
        ok = read_dac();
        break;
      case 0xFE:
      case 0xDC:  // DNL
        skip_segment();
        break;
      case 0xD8:
        ok = false;
        break;
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(m);
        } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
          ok = true;  // a stray RSTn or TEM: no parameters
        } else {
          ok = false;  // other SOFs (lossless, hierarchical, arithmetic)
        }
    }
    if (!ok) return false;
  }
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
    c.latched = true;
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
  Smoothing sm;
  const bool smooth = d.smoothing(&sm);
  *out = static_cast<uint8_t*>(std::malloc(
      static_cast<size_t>(d.im.height) * d.im.width * 3));
  if (*out == nullptr) return -1;
  output_rgb(d.im, *out, smooth ? &sm : nullptr);
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
