// Baseline JPEG (JFIF) encoder for the MJPEG AVI video path.
//
// Headless counterpart of the reference's video post-process
// (postprocess.cu:99-116), which hands GL frames to an OpenCV
// cv::VideoWriter with the XVID codec.  The simulator needs no GL and no
// OpenCV, so compression is done here: each rendered frame is
// encoded as a standalone baseline JPEG (4:4:4, standard Annex-K quant +
// Huffman tables) and the Python AviWriter streams them into an 'MJPG'
// RIFF container — a format every stock player opens, with no codec deps.
//
// Build: make -C native   ->  part of libpbot_render.so

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------- tables

// Annex K.1/K.2 base quantization tables (natural row-major order).
const int kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChrQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18,
                         11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                         13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                         36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                         38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.3 standard Huffman table specs: BITS (codes per length 1..16)
// followed by HUFFVAL symbol lists.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChrVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
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
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
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

// Derived Huffman code/size per symbol (JPEG Annex C generation procedure).
struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t bits[17], const uint8_t *vals, int nvals) {
    std::memset(size, 0, sizeof(size));
    int k = 0;
    uint16_t c = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len]; ++i) {
        code[vals[k]] = c++;
        size[vals[k]] = (uint8_t)len;
        ++k;
      }
      c <<= 1;
    }
    (void)nvals;
  }
};

struct BitWriter {
  uint8_t *out;
  int cap, pos;
  uint32_t acc;
  int nbits;
  bool overflow;
  BitWriter(uint8_t *o, int c)
      : out(o), cap(c), pos(0), acc(0), nbits(0), overflow(false) {}
  void byte(uint8_t b) {
    if (pos >= cap) {
      overflow = true;
      return;
    }
    out[pos++] = b;
  }
  void bits(uint32_t v, int n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      byte(b);
      if (b == 0xFF)
        byte(0x00); // byte stuffing inside entropy data
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0)
      bits(0x7F, 8 - nbits); // pad with 1s per spec
  }
};

inline int bit_category(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

// Separable float DCT-II with the JPEG normalization.
struct DctTables {
  float cs[8][8]; // cs[x][u] = cos((2x+1)u*pi/16)
  DctTables() {
    for (int x = 0; x < 8; ++x)
      for (int u = 0; u < 8; ++u)
        cs[x][u] = std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0);
  }
};
const DctTables kDct;

void fdct8x8(const float in[64], float out[64]) {
  float tmp[64];
  for (int y = 0; y < 8; ++y) { // rows
    for (int u = 0; u < 8; ++u) {
      float s = 0.0f;
      for (int x = 0; x < 8; ++x)
        s += in[y * 8 + x] * kDct.cs[x][u];
      tmp[y * 8 + u] = s;
    }
  }
  for (int u = 0; u < 8; ++u) { // cols
    for (int v = 0; v < 8; ++v) {
      float s = 0.0f;
      for (int y = 0; y < 8; ++y)
        s += tmp[y * 8 + u] * kDct.cs[y][v];
      float cu = (u == 0) ? 0.70710678f : 1.0f;
      float cv = (v == 0) ? 0.70710678f : 1.0f;
      out[v * 8 + u] = 0.25f * cu * cv * s;
    }
  }
}

void encode_block(BitWriter &bw, const float px[64], const int quant[64],
                  const HuffTable &dc, const HuffTable &ac, int &prev_dc) {
  float freq[64];
  fdct8x8(px, freq);
  int z[64];
  for (int i = 0; i < 64; ++i) {
    int nat = kZigzag[i];
    float q = freq[nat] / (float)quant[nat];
    z[i] = (int)std::lround(q);
  }
  // DC difference
  int diff = z[0] - prev_dc;
  prev_dc = z[0];
  int s = bit_category(diff);
  bw.bits(dc.code[s], dc.size[s]);
  if (s)
    bw.bits(diff < 0 ? (uint32_t)(diff + (1 << s) - 1) : (uint32_t)diff, s);
  // AC run-length
  int run = 0;
  for (int i = 1; i < 64; ++i) {
    if (z[i] == 0) {
      ++run;
      continue;
    }
    while (run >= 16) {
      bw.bits(ac.code[0xF0], ac.size[0xF0]); // ZRL
      run -= 16;
    }
    int sz = bit_category(z[i]);
    int sym = (run << 4) | sz;
    bw.bits(ac.code[sym], ac.size[sym]);
    bw.bits(z[i] < 0 ? (uint32_t)(z[i] + (1 << sz) - 1) : (uint32_t)z[i], sz);
    run = 0;
  }
  if (run > 0)
    bw.bits(ac.code[0x00], ac.size[0x00]); // EOB
}

void emit_marker_u16(BitWriter &bw, uint16_t v) {
  bw.byte((uint8_t)(v >> 8));
  bw.byte((uint8_t)v);
}

void emit_dht(BitWriter &bw, int tc, int th, const uint8_t bits[17],
              const uint8_t *vals) {
  int nv = 0;
  for (int i = 1; i <= 16; ++i)
    nv += bits[i];
  bw.byte(0xFF);
  bw.byte(0xC4);
  emit_marker_u16(bw, (uint16_t)(2 + 1 + 16 + nv));
  bw.byte((uint8_t)((tc << 4) | th));
  for (int i = 1; i <= 16; ++i)
    bw.byte(bits[i]);
  for (int i = 0; i < nv; ++i)
    bw.byte(vals[i]);
}

} // namespace

extern "C" {

// Encode an RGB frame (h rows x w cols x 3, row 0 = top) as a baseline
// 4:4:4 JFIF JPEG.  quality in [1, 100] (IJG scaling).  Returns the number
// of bytes written to out, or -1 if out_cap is too small.
int encode_jpeg(const uint8_t *rgb, int w, int h, int quality, uint8_t *out,
                int out_cap) {
  if (quality < 1)
    quality = 1;
  if (quality > 100)
    quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  int qlum[64], qchr[64];
  for (int i = 0; i < 64; ++i) {
    int l = (kLumQuant[i] * scale + 50) / 100;
    int c = (kChrQuant[i] * scale + 50) / 100;
    qlum[i] = l < 1 ? 1 : (l > 255 ? 255 : l);
    qchr[i] = c < 1 ? 1 : (c > 255 ? 255 : c);
  }

  HuffTable dc_lum, dc_chr, ac_lum, ac_chr;
  dc_lum.build(kDcLumBits, kDcLumVals, 12);
  dc_chr.build(kDcChrBits, kDcChrVals, 12);
  ac_lum.build(kAcLumBits, kAcLumVals, 162);
  ac_chr.build(kAcChrBits, kAcChrVals, 162);

  BitWriter bw(out, out_cap);
  // SOI + JFIF APP0
  bw.byte(0xFF);
  bw.byte(0xD8);
  bw.byte(0xFF);
  bw.byte(0xE0);
  emit_marker_u16(bw, 16);
  const char jfif[5] = {'J', 'F', 'I', 'F', 0};
  for (int i = 0; i < 5; ++i)
    bw.byte((uint8_t)jfif[i]);
  bw.byte(1);
  bw.byte(1); // version 1.1
  bw.byte(0); // density: aspect ratio
  emit_marker_u16(bw, 1);
  emit_marker_u16(bw, 1);
  bw.byte(0);
  bw.byte(0); // no thumbnail
  // DQT x2 (values in zigzag order)
  for (int t = 0; t < 2; ++t) {
    bw.byte(0xFF);
    bw.byte(0xDB);
    emit_marker_u16(bw, 67);
    bw.byte((uint8_t)t);
    const int *q = t == 0 ? qlum : qchr;
    for (int i = 0; i < 64; ++i)
      bw.byte((uint8_t)q[kZigzag[i]]);
  }
  // SOF0: 8-bit, 3 components, 1x1 sampling (4:4:4)
  bw.byte(0xFF);
  bw.byte(0xC0);
  emit_marker_u16(bw, 17);
  bw.byte(8);
  emit_marker_u16(bw, (uint16_t)h);
  emit_marker_u16(bw, (uint16_t)w);
  bw.byte(3);
  for (int c = 1; c <= 3; ++c) {
    bw.byte((uint8_t)c);
    bw.byte(0x11);
    bw.byte(c == 1 ? 0 : 1);
  }
  // DHT x4
  emit_dht(bw, 0, 0, kDcLumBits, kDcLumVals);
  emit_dht(bw, 1, 0, kAcLumBits, kAcLumVals);
  emit_dht(bw, 0, 1, kDcChrBits, kDcChrVals);
  emit_dht(bw, 1, 1, kAcChrBits, kAcChrVals);
  // SOS
  bw.byte(0xFF);
  bw.byte(0xDA);
  emit_marker_u16(bw, 12);
  bw.byte(3);
  for (int c = 1; c <= 3; ++c) {
    bw.byte((uint8_t)c);
    bw.byte(c == 1 ? 0x00 : 0x11);
  }
  bw.byte(0);
  bw.byte(63);
  bw.byte(0);

  // entropy-coded 8x8 MCUs (4:4:4 -> one block per component per MCU),
  // edge-replicated at the right/bottom borders
  int prev[3] = {0, 0, 0};
  float blk[3][64];
  for (int by = 0; by < h; by += 8) {
    for (int bx = 0; bx < w; bx += 8) {
      for (int yy = 0; yy < 8; ++yy) {
        int sy = by + yy;
        if (sy > h - 1)
          sy = h - 1;
        const uint8_t *row = rgb + (size_t)sy * w * 3;
        for (int xx = 0; xx < 8; ++xx) {
          int sx = bx + xx;
          if (sx > w - 1)
            sx = w - 1;
          float r = row[sx * 3 + 0], g = row[sx * 3 + 1], b = row[sx * 3 + 2];
          // BT.601 full-range, level-shifted by 128
          blk[0][yy * 8 + xx] = 0.299f * r + 0.587f * g + 0.114f * b - 128.0f;
          blk[1][yy * 8 + xx] = -0.168736f * r - 0.331264f * g + 0.5f * b;
          blk[2][yy * 8 + xx] = 0.5f * r - 0.418688f * g - 0.081312f * b;
        }
      }
      encode_block(bw, blk[0], qlum, dc_lum, ac_lum, prev[0]);
      encode_block(bw, blk[1], qchr, dc_chr, ac_chr, prev[1]);
      encode_block(bw, blk[2], qchr, dc_chr, ac_chr, prev[2]);
      if (bw.overflow)
        return -1;
    }
  }
  bw.flush();
  bw.byte(0xFF);
  bw.byte(0xD9); // EOI
  return bw.overflow ? -1 : bw.pos;
}

} // extern "C"
