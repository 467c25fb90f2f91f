// Image decoding, resizing and cropping of grayscale pages on the host, the
// way the data loaders read image files (data/images.py).  Each function
// gives what PIL gives for the same call, bit for bit:
//
//   decode_gray   Image.open(...).convert("L") of a JPEG (baseline or
//                 progressive Huffman, 8-bit, 1, 3 or 4 components, any
//                 integer sampling factors, restart intervals), a BMP (1 to
//                 32 bits, BI_BITFIELDS, RLE8/RLE4) or a PNM (P1-P6, any
//                 maxval).  JPEG follows libjpeg-turbo's default
//                 decompression as PIL's x86-64 build runs it: the ISLOW
//                 integer IDCT with the SIMD version's saturating output,
//                 block smoothing of progressive files whose scans leave
//                 low bits unsent, "fancy" (triangle) upsampling of h2v1,
//                 h1v2 and h2v2 chroma, the fixed-point YCbCr->RGB tables,
//                 YCCK->CMYK; then PIL's CMYK->RGB (inverted CMYK, as PIL
//                 reads it) and RGB->L, (R*19595 + G*38470 + B*7471 +
//                 0x8000) >> 16.  BMP and PNM follow PIL's own Python
//                 readers, quirks included.
//   png_to_gray   the unfiltering (plain or Adam7) and conversion to L of
//                 an inflated PNG of any depth (the zlib stream is
//                 inflated by Python's zlib).
//   resize_gray   Image.resize of a mode-L image with BILINEAR or BICUBIC:
//                 PIL's ImagingResample, 8-bit path (coefficients in 22
//                 fraction bits, the horizontal pass first over the rows
//                 the vertical pass reads).
//   crop_gray     Image.crop on integer coordinates, zeros off the page.
//
// Errors come back as a code and a message: 1 where PIL raises OSError
// (broken or truncated data, and the files PIL refuses), 3 where PIL's
// Python raises ValueError, 4 for more than twice PIL's MAX_IMAGE_PIXELS
// (its DecompressionBombError), 2 for a file PIL decodes and this decoder
// does not (arithmetic-coded or lossless JPEG; NotImplementedError).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { OK = 0, BROKEN = 1, UNSUPPORTED = 2, VALUE = 3, BOMB = 4 };

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Failure{code, msg}; }

// PIL's Image.MAX_IMAGE_PIXELS: an image of more than twice as many pixels
// is refused at open (DecompressionBombError)
const long kMaxImagePixels = 1024L * 1024 * 1024 / 4 / 3;

void check_size(long w, long h) {
  if ((w < 1 ? 1 : w) > 2 * kMaxImagePixels / (h < 1 ? 1 : h))
    fail(BOMB, "image of " + std::to_string(w) + "x" + std::to_string(h) +
                   " pixels exceeds twice PIL's limit");
}

inline uint8_t L24(int r, int g, int b) {
  return (uint8_t)((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
}

// ---------------------------------------------------------------- JPEG

// zigzag index -> natural index, padded as libjpeg pads it (a corrupt run
// past 63 lands on 63)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, 0 where the code is longer
  uint16_t look[1 << 9];

  // jdhuff.c jpeg_make_d_derived_tbl, at the start of a scan that uses the
  // table: a DC table's symbols must be 0..15
  void build(const uint8_t* counts, const uint8_t* symbols, int nsym, bool is_dc) {
    if (is_dc)
      for (int i = 0; i < nsym; ++i)
        if (symbols[i] > 15) fail(BROKEN, "bogus Huffman table definition");
    std::memcpy(vals, symbols, nsym);
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail(BROKEN, "bogus Huffman table definition");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (counts[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += counts[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < counts[l - 1]; ++i, ++p) {
        int lookbits = huffcode[p] << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); ++c)
          look[lookbits + c] = (uint16_t)((l << 8) | symbols[p]);
      }
    }
  }
};

// libjpeg's standard Huffman tables (jstdhuff.c, the JPEG standard's K.3),
// which libjpeg-turbo installs in slots 0 and 1 that a sequential file
// leaves undefined (motion-JPEG frames omit them): counts of each length,
// then the symbols
const uint8_t kStdDcCounts[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0}, {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdAcCounts[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125}, {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13,
    0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42,
    0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a,
    0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35,
    0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67,
    0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84,
    0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
    0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
};
const uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51,
    0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1,
    0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24,
    0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a,
    0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82,
    0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa,
    0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
    0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
};

// A table as DHT defines it; the decoding tables are built from it when a
// scan uses it
struct HuffSpec {
  bool present = false;
  uint8_t counts[16];
  uint8_t symbols[256];
  int n = 0;
  void set(const uint8_t* c, const uint8_t* sym, int count) {
    std::memcpy(counts, c, 16);
    std::memcpy(symbols, sym, count);
    n = count;
    present = true;
  }
};

struct Component {
  int id, h, v, tq;
  int bw, bh;          // blocks across and down, padded to whole MCUs
  int wb, hb;          // blocks that hold samples (libjpeg's width/height_in_blocks)
  int dw, dh;          // the downsampled size (libjpeg's downsampled_width/height)
  bool latched = false;  // its quantization table, copied at its first scan
  uint16_t q[64];
  int bits[64];        // progression: the Al of the last scan of each coefficient, -1 before
  int prev_bits[64];   // the same before the component's last scan (libjpeg's second half)
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane; // (bw * 8) x (bh * 8) samples after the IDCT
};

// The entropy-coded data of one scan, as libjpeg-turbo reads it (jdhuff.c
// jpeg_fill_bit_buffer): at a marker it feeds zero bits, and once a bit past
// the marker is taken the data is insufficient: the decoders leave the rest
// of the restart segment's MCUs as they are.
class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  inline void fill(int need) {
    while (bits_ < need) {
      int byte = 0;
      if (!marker_) {
        if (pos_ >= n_) fail(BROKEN, "image file is truncated");
        byte = d_[pos_];
        if (byte == 0xFF) {
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) ++q;  // fill bytes
          if (q >= n_) fail(BROKEN, "image file is truncated");
          if (d_[q] == 0x00) {
            pos_ = q + 1;
          } else {  // a marker: zeros from here on
            marker_ = true;
            marker_pos_ = pos_;
            byte = 0;
          }
        } else {
          ++pos_;
        }
      }
      if (marker_) fake_ += 8;
      acc_ = (acc_ << 8) | (uint32_t)byte;
      bits_ += 8;
    }
  }
  inline int peek(int n) {
    fill(n);
    return (int)((acc_ >> (bits_ - n)) & ((1u << n) - 1));
  }
  inline void skip(int n) {
    if (n > bits_ - fake_) insufficient_ = true;
    bits_ -= n;
    if (fake_ > bits_) fake_ = bits_;
  }
  inline int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  inline int decode(const Huffman& h) {
    int look = peek(9);
    int e = h.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int code = get(1);
    int l = 1;
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) return 0;  // bad code: libjpeg warns and takes symbol 0
    }
    return h.vals[code + h.valoffset[l]];
  }
  bool insufficient() const { return insufficient_; }
  // at a restart interval: drop the buffered bits and read RSTn; a wrong
  // marker is resynchronised as jdmarker.c's jpeg_resync_to_restart does
  void restart(int expected) {
    bits_ = fake_ = 0;
    acc_ = 0;
    size_t p = marker_ ? marker_pos_ : pos_;
    for (;;) {
      while (p < n_ && d_[p] != 0xFF) ++p;  // garbage before the marker is skipped
      size_t q = p;
      while (q < n_ && d_[q] == 0xFF) ++q;
      if (q >= n_) fail(BROKEN, "image file is truncated");
      const int m = d_[q];
      if (m == 0x00) {  // a stuffed byte, not a marker
        p = q + 1;
        continue;
      }
      const auto rst = [&](int k) { return 0xD0 + ((expected + k) & 7); };
      if (m == rst(0)) {  // the normal case
        pos_ = q + 1;
        marker_ = insufficient_ = false;
        return;
      }
      int action;
      if (m < 0xC0) action = 2;
      else if (m < 0xD0 || m > 0xD7) action = 3;
      else if (m == rst(1) || m == rst(2)) action = 3;
      else if (m == rst(-1) || m == rst(-2)) action = 2;
      else action = 1;
      if (action == 1) {  // discard the marker and go on after it
        pos_ = q + 1;
        marker_ = insufficient_ = false;
        return;
      }
      if (action == 3) {  // leave the marker: the segment reads as zeros
        marker_ = true;
        marker_pos_ = p;
        return;
      }
      p = q + 1;  // action 2: on to the next marker
    }
  }
  // the position after the scan's entropy-coded data (its ending marker)
  size_t end() {
    size_t p = marker_ ? marker_pos_ : pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 && d_[p + 1] != 0xFF)) ++p;
    if (p + 1 >= n_) fail(BROKEN, "image file is truncated");
    return p;
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t acc_ = 0;
  int bits_ = 0, fake_ = 0;  // bits buffered, the last fake_ of them zeros past a marker
  bool marker_ = false, insufficient_ = false;
  size_t marker_pos_ = 0;
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

// The post-IDCT range limit of libjpeg-turbo's SIMD ISLOW IDCT, which PIL's
// x86-64 build runs: recentred and saturated (packsswb), where the C code's
// table would wrap values 512 or more away from the centre
inline uint8_t idct_limit(long x) {
  const long v = x + 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

#define FIX_0_298631336 2446L
#define FIX_0_390180644 3196L
#define FIX_0_541196100 4433L
#define FIX_0_765366865 6270L
#define FIX_0_899976223 7373L
#define FIX_1_175875602 9633L
#define FIX_1_501321110 12299L
#define FIX_1_847759065 15137L
#define FIX_1_961570560 16069L
#define FIX_2_053119869 16819L
#define FIX_2_562915447 20995L
#define FIX_3_072711026 25172L
#define DESCALE(x, n) (((x) + (1L << ((n) - 1))) >> (n))

// One 8-point pass of libjpeg-turbo's SIMD ISLOW IDCT (jidctint-avx2.asm,
// dodct), which PIL's x86-64 build runs: the products of jidctint.c's
// constants paired as pmaddwd takes them, and the sums its 16-bit lanes
// make (in0 + in4, in0 - in4, in7 + in3, in5 + in1) wrapped to 16 bits.
// Exact integer arithmetic otherwise, so equal to the C code wherever no
// 16-bit value overflows.
inline long wrap16(long v) { return (int16_t)(uint16_t)(v & 0xFFFF); }
inline long sat16(long v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }

void idct_pass(const long* in, int step, long* out) {
  const long z2 = in[2 * step], z3 = in[6 * step];
  const long tmp3 = z2 * (FIX_0_541196100 + FIX_0_765366865) + z3 * FIX_0_541196100;
  const long tmp2 = z2 * FIX_0_541196100 + z3 * (FIX_0_541196100 - FIX_1_847759065);
  const long tmp0 = wrap16(in[0] + in[4 * step]) * 8192;
  const long tmp1 = wrap16(in[0] - in[4 * step]) * 8192;
  const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
             tmp12 = tmp1 - tmp2;
  const long t0 = in[7 * step], t1 = in[5 * step], t2 = in[3 * step], t3 = in[step];
  const long z3o = wrap16(t0 + t2), z4o = wrap16(t1 + t3);
  const long z3n = z3o * (FIX_1_175875602 - FIX_1_961570560) + z4o * FIX_1_175875602;
  const long z4n = z3o * FIX_1_175875602 + z4o * (FIX_1_175875602 - FIX_0_390180644);
  const long o0 = t0 * (FIX_0_298631336 - FIX_0_899976223) - t3 * FIX_0_899976223 + z3n;
  const long o1 = t1 * (FIX_2_053119869 - FIX_2_562915447) - t2 * FIX_2_562915447 + z4n;
  const long o2 = t2 * (FIX_3_072711026 - FIX_2_562915447) - t1 * FIX_2_562915447 + z3n;
  const long o3 = t3 * (FIX_1_501321110 - FIX_0_899976223) - t0 * FIX_0_899976223 + z4n;
  out[0] = tmp10 + o3;
  out[7] = tmp10 - o3;
  out[1] = tmp11 + o2;
  out[6] = tmp11 - o2;
  out[2] = tmp12 + o1;
  out[5] = tmp12 - o1;
  out[3] = tmp13 + o0;
  out[4] = tmp13 - o0;
}

// libjpeg-turbo's SIMD jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2): each
// coefficient dequantized to 16 bits (pmullw); the columns, or, where rows
// 1 to 7 of the block are all zero, each DC shifted left by PASS1_BITS in
// 16 bits; the column results descaled and saturated to 16 bits
// (packssdw); the rows descaled, saturated and recentred (idct_limit).
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  long deq[64], ws[64], col[8];
  bool ac = false;
  for (int k = 0; k < 64; ++k) {
    deq[k] = wrap16((long)in[k] * q[k]);
    ac |= k >= 8 && in[k] != 0;
  }
  for (int c = 0; c < 8; ++c) {
    if (!ac) {
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = wrap16(deq[c] * 4);
      continue;
    }
    idct_pass(deq + c, 8, col);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16(DESCALE(col[r], 11));
  }
  for (int r = 0; r < 8; ++r) {
    long row[8];
    idct_pass(ws + 8 * r, 1, row);
    uint8_t* op = out + (size_t)r * stride;
    for (int c = 0; c < 8; ++c) op[c] = idct_limit(DESCALE(row[c], 18));
  }
}

// One component upsampled to full size (W x H) as libjpeg-turbo upsamples
// it (jdsample.c) with do_fancy_upsampling on: h2v1, h1v2 and h2v2 by the
// triangle filter (h2v1/h2v2 only where the downsampled width exceeds 2),
// any other integer ratio by replication.  Rows above the first and below
// the last repeat them, as jdmainct.c's context pointers do.
void upsample(const Component& c, int hmax, int vmax, int W, int H, std::vector<uint8_t>& out) {
  const int sx = hmax / c.h, sy = vmax / c.v;
  const int stride = c.bw * 8, dw = c.dw, dh = c.dh;
  const uint8_t* p = c.plane.data();
  out.assign((size_t)W * H, 0);
  auto row = [&](int i) { return p + (size_t)(i < 0 ? 0 : i >= dh ? dh - 1 : i) * stride; };
  const int ow = dw * sx;  // the upsampled row width, cut to W below
  std::vector<uint8_t> line(ow + 2);
  std::vector<int> colsum(dw);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = line.data();
    if (sx == 1 && sy == 1) {
      std::memcpy(o, row(y), dw);
    } else if (sx == 2 && sy == 1 && dw > 2) {
      const uint8_t* in = row(y);
      o[0] = in[0];
      o[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int j = 1; j < dw - 1; ++j) {
        int v = in[j] * 3;
        o[2 * j] = (uint8_t)((v + in[j - 1] + 1) >> 2);
        o[2 * j + 1] = (uint8_t)((v + in[j + 1] + 2) >> 2);
      }
      int j = dw - 1;
      o[2 * j] = (uint8_t)((in[j] * 3 + in[j - 1] + 1) >> 2);
      o[2 * j + 1] = in[j];
    } else if (sx == 1 && sy == 2) {
      const int i = y >> 1, v = y & 1;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = row(v ? i + 1 : i - 1);
      const int bias = v ? 2 : 1;
      for (int j = 0; j < dw; ++j) o[j] = (uint8_t)((in0[j] * 3 + in1[j] + bias) >> 2);
    } else if (sx == 2 && sy == 2 && dw > 2) {
      const int i = y >> 1, v = y & 1;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = row(v ? i + 1 : i - 1);
      for (int j = 0; j < dw; ++j) colsum[j] = in0[j] * 3 + in1[j];
      o[0] = (uint8_t)((colsum[0] * 4 + 8) >> 4);
      o[1] = (uint8_t)((colsum[0] * 3 + colsum[1] + 7) >> 4);
      for (int j = 1; j < dw - 1; ++j) {
        o[2 * j] = (uint8_t)((colsum[j] * 3 + colsum[j - 1] + 8) >> 4);
        o[2 * j + 1] = (uint8_t)((colsum[j] * 3 + colsum[j + 1] + 7) >> 4);
      }
      int j = dw - 1;
      o[2 * j] = (uint8_t)((colsum[j] * 3 + colsum[j - 1] + 8) >> 4);
      o[2 * j + 1] = (uint8_t)((colsum[j] * 4 + 7) >> 4);
    } else {  // replication (int_upsample, h2v1_upsample, h2v2_upsample)
      const uint8_t* in = row(y / sy);
      for (int j = 0; j < dw; ++j)
        for (int k = 0; k < sx; ++k) o[j * sx + k] = in[j];
    }
    std::memcpy(out.data() + (size_t)y * W, o, W);
  }
}

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// libjpeg-turbo's block smoothing of a progressive image whose scans left
// low bits of some coefficients unsent (jdcoefct.c, decompress_smooth_data,
// the 5x5 version of 2.1 and later): each of the first nine AC coefficients
// still zero, and not known to be exact, is estimated from the DC values of
// the 5x5 neighbourhood of blocks; where no AC data came at all the DC is
// re-estimated too.  `cur_bits` are the latched coef_bits[0..9]; iMCU rows
// past `last_good` (the last row the last scan reached with data in hand)
// take `prev_bits`, those from before the component's last scan.  `T` is
// the image's iMCU rows.  The IDCT of every block that holds samples follows.
void smooth_idct(Component& c, int T, const int* cur_bits, const int* prev_bits,
                 int last_good) {
  const int stride = c.bw * 8;
  const long Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
             Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
  auto estimate = [](long num, long q, int al) {
    int pred;
    if (num >= 0) {
      pred = (int)(((q << 7) + num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = (int)(((q << 7) - num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return (int16_t)pred;
  };
  const int last_col = c.wb - 1;
  for (int r = 0; r < T; ++r) {
    const int* bits = r > last_good ? prev_bits : cur_bits;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                           bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                           bits[9] == -1;
    int block_rows = c.v;
    if (r == T - 1) {
      block_rows = c.hb % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    // libjpeg computes the edge tests from this iMCU row's block count
    const int image_block_rows = block_rows * T;
    for (int br = 0; br < block_rows; ++br) {
      const int ibr = r * block_rows + br;
      const int row = r * c.v + br;
      auto at = [&](int k) { return c.coef.data() + (size_t)(row + k) * c.bw * 64; };
      const int16_t* cur = at(0);
      const int16_t* prev = ibr > 0 ? at(-1) : cur;
      const int16_t* pprev = ibr > 1 ? at(-2) : prev;
      const int16_t* next = ibr < image_block_rows - 1 ? at(1) : cur;
      const int16_t* nnext = ibr < image_block_rows - 2 ? at(2) : next;
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14,
          DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = pprev[0];
      DC06 = DC07 = DC08 = DC09 = DC10 = prev[0];
      DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
      DC16 = DC17 = DC18 = DC19 = DC20 = next[0];
      DC21 = DC22 = DC23 = DC24 = DC25 = nnext[0];
      for (int bx = 0; bx <= last_col; ++bx) {
        int16_t ws[64];
        std::memcpy(ws, cur + (size_t)bx * 64, sizeof(ws));
        if (bx == 0 && bx < last_col) {
          DC04 = DC05 = pprev[64];
          DC09 = DC10 = prev[64];
          DC14 = DC15 = cur[64];
          DC19 = DC20 = next[64];
          DC24 = DC25 = nnext[64];
        }
        if (bx + 1 < last_col) {
          const size_t o = (size_t)(bx + 2) * 64;
          DC05 = pprev[o];
          DC10 = prev[o];
          DC15 = cur[o];
          DC20 = next[o];
          DC25 = nnext[o];
        }
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {
          const long num = Q00 * (change_dc
              ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
              : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = estimate(num, Q01, al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {
          const long num = Q00 * (change_dc
              ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
                 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
              : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = estimate(num, Q10, al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {
          const long num = Q00 * (change_dc
              ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
              : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = estimate(num, Q20, al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {
          const long num = Q00 * (change_dc
              ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
              : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                 DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = estimate(num, Q11, al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {
          const long num = Q00 * (change_dc
              ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                 DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
              : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = estimate(num, Q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)
            ws[3] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
          if ((al = bits[7]) != 0 && ws[10] == 0)
            ws[10] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
          if ((al = bits[8]) != 0 && ws[17] == 0)
            ws[17] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
          if ((al = bits[9]) != 0 && ws[24] == 0)
            ws[24] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
          const long num =
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                     6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                     152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                     6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = estimate(num, Q00, 0);
        }
        idct_islow(ws, c.q, c.plane.data() + (size_t)row * 8 * stride + bx * 8, stride);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

// jdcolor.c's YCbCr -> RGB tables, SCALEBITS 16
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((91881L * x + 32768) >> 16);
      cb_b[i] = (int)((116130L * x + 32768) >> 16);
      cr_g[i] = -46802L * x;
      cb_g[i] = -22554L * x + 32768;
    }
  }
};
const YccTables kYcc;

inline int clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// PIL's MULDIV255 and its CMYK -> RGB (Convert.c, cmyk2rgb)
inline int muldiv255(int a, int b) {
  const int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// A JPEG as PIL's JPEG plugin decodes it or, with `strip` 0 or 1, a
// JPEG-compressed TIFF strip or tile as libtiff has libjpeg decode it for
// PIL: libtiff ignores what jpeg_finish_decompress reports, so once a
// single-scan image has its lines nothing after its scan is read, and it
// sets the colour space itself: three components taken as they are (0) or
// converted from YCbCr (1), whatever the markers say.
void decode_jpeg(const uint8_t* d, size_t n, std::vector<uint8_t>& out, int& W, int& H,
                 int strip = -1) {
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  Huffman dc[4], ac[4];  // built for each scan from the specs it names
  std::vector<Component> comps;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0, restart_interval = 0, scans = 0, last_good = 0;
  bool jfif = false, adobe = false, frame = false, progressive = false;
  int adobe_transform = -1;
  W = H = 0;
  size_t pos = 2;
  bool multi = false;  // libjpeg's has_multiple_scans: it reads every scan before any output
  for (;;) {
    // after the one scan of a single-scan image PIL has its lines: data
    // that runs out before EOI is no fault there (libjpeg suspends)
    const bool lines_done = scans && !multi;
    if (strip >= 0 && lines_done) break;
    // the next marker (libjpeg skips garbage before it with a warning)
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) {
      if (lines_done) break;
      fail(BROKEN, "image file is truncated");
    }
    const int m = d[pos++];
    if (m == 0xD9) break;                            // EOI
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01 || m == 0x00) continue;  // FF00: garbage
    if (m == 0xD8) fail(BROKEN, "broken data stream (duplicate SOI marker)");
    if (m < 0xC0 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD))
      fail(BROKEN, "broken data stream (unknown JPEG marker " + std::to_string(m) + ")");
    const bool skipped = (m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC;  // APPn, COM, DNL
    if (lines_done && m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC)
      fail(BROKEN, "duplicate JPEG frame header");  // libjpeg's saw_SOF, before the length
    if (pos + 2 > n) {
      if (lines_done) break;
      fail(BROKEN, "image file is truncated");
    }
    const int len = u16(d + pos);
    if (m == 0xDD && len != 4) fail(BROKEN, "corrupt JPEG restart interval");  // read first
    if (len < 2) {
      if (!skipped) fail(BROKEN, "corrupt JPEG marker length");
      pos += 2;  // libjpeg skips nothing more
      continue;
    }
    if (m == 0xCC) {  // DAC (jdmarker.c get_dac): each pair is checked as it is read
      long left = len - 2;
      size_t p = pos + 2;
      for (; left > 0 && p + 2 <= n; p += 2, left -= 2) {
        if (d[p] >= 32) fail(BROKEN, "bad JPEG DAC index");
        if (d[p] < 16 && (d[p + 1] & 15) > (d[p + 1] >> 4)) fail(BROKEN, "bad JPEG DAC value");
      }
      if (left < 0) fail(BROKEN, "corrupt JPEG DAC length");
    }
    if (pos + len > n) {
      if (lines_done) break;
      fail(BROKEN, "image file is truncated");
    }
    const uint8_t* s = d + pos + 2;
    const int sl = len - 2;
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
      // a frame header.  PIL reads every SOFn itself first and refuses any
      // precision but 8 and any component count but 1, 3 or 4; libjpeg
      // then refuses the hierarchical processes (SOF5-7, SOF13-15) and JPG.
      if (m == 0xC8) fail(BROKEN, "cannot identify image file (JPG marker)");
      if (sl < 6) fail(BROKEN, "corrupt JPEG frame header");
      if (s[0] != 8) fail(BROKEN, "cannot identify image file (" + std::to_string(s[0]) +
                                      "-bit JPEG samples)");
      if (s[5] != 1 && s[5] != 3 && s[5] != 4)
        fail(BROKEN, "cannot identify image file (JPEG of " + std::to_string(s[5]) +
                         " components)");
      if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF)
        fail(BROKEN, "broken data stream (hierarchical JPEG, process " +
                         std::to_string(m - 0xC0) + ")");
      if (m == 0xC3) fail(UNSUPPORTED, "lossless JPEG");
      if (m == 0xC9 || m == 0xCA) fail(UNSUPPORTED, "arithmetic-coded JPEG");
      if (m == 0xCB) fail(UNSUPPORTED, "arithmetic-coded JPEG (lossless)");
      if (frame) fail(BROKEN, "duplicate JPEG frame header");
      progressive = m == 0xC2;
      H = u16(s + 1);
      W = u16(s + 3);
      const int nc = s[5];
      if (W == 0 || H == 0) fail(BROKEN, "JPEG of empty size");
      check_size(W, H);
      if (W > 65500 || H > 65500) fail(BROKEN, "broken data stream (JPEG too big)");
      if (sl != 6 + 3 * nc) fail(BROKEN, "corrupt JPEG frame header length");
      for (int i = 0; i < nc; ++i) {
        Component c;
        c.id = s[6 + 3 * i];
        c.h = s[7 + 3 * i] >> 4;
        c.v = s[7 + 3 * i] & 15;
        c.tq = s[8 + 3 * i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
          fail(BROKEN, "bogus JPEG sampling factors");
        hmax = c.h > hmax ? c.h : hmax;
        vmax = c.v > vmax ? c.v : vmax;
        for (int k = 0; k < 64; ++k) c.bits[k] = -1;
        comps.push_back(c);
      }
      mcux = (W + 8 * hmax - 1) / (8 * hmax);
      mcuy = (H + 8 * vmax - 1) / (8 * vmax);
      for (auto& c : comps) {
        if (hmax % c.h || vmax % c.v)  // jdsample.c refuses them
          fail(BROKEN, "broken data stream (fractional sampling ratios)");
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
        c.dw = (int)(((long)W * c.h + hmax - 1) / hmax);
        c.dh = (int)(((long)H * c.v + vmax - 1) / vmax);
        c.wb = (c.dw + 7) / 8;
        c.hb = (c.dh + 7) / 8;
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      }
      frame = true;
    } else if (m == 0xC4) {  // DHT
      int p = 0;
      while (p < sl) {
        if (p + 17 > sl) fail(BROKEN, "corrupt JPEG Huffman table");
        const int tc = s[p] >> 4, th = s[p] & 15;
        int total = 0;
        for (int i = 0; i < 16; ++i) total += s[p + 1 + i];
        if (tc > 1 || th > 3 || total > 256 || p + 17 + total > sl)
          fail(BROKEN, "corrupt JPEG Huffman table");
        (tc ? ac_spec : dc_spec)[th].set(s + p + 1, s + p + 17, total);
        p += 17 + total;
      }
    } else if (m == 0xDB) {  // DQT
      int p = 0;
      while (p < sl) {
        const int wide = s[p] >> 4 ? 2 : 1, tq = s[p] & 15;  // any precision but 0: 16-bit
        if (tq > 3 || p + 1 + 64 * wide > sl) fail(BROKEN, "corrupt JPEG quantization table");
        for (int i = 0; i < 64; ++i)
          qt[tq][kNatural[i]] = wide == 2 ? (uint16_t)u16(s + p + 1 + 2 * i) : s[p + 1 + i];
        qt_present[tq] = true;
        p += 1 + 64 * wide;
      }
    } else if (m == 0xDD) {  // DRI
      restart_interval = u16(s);
    } else if (m == 0xE0) {
      if (sl >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) jfif = true;
    } else if (m == 0xEE) {
      if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        adobe = true;
        adobe_transform = s[11];
      }
    } else if (m == 0xDA) {  // SOS: decode the scan
      if (!frame) fail(BROKEN, "JPEG scan before its frame header");
      if (lines_done) fail(BROKEN, "broken data stream (EOI expected)");
      const int ns = s[0];
      if (ns < 1 || ns > 4 || sl != 1 + 2 * ns + 3) fail(BROKEN, "corrupt JPEG scan header");
      if (!scans) {
        multi = progressive || ns < (int)comps.size();
        if (!progressive) {  // jdhuff.c jinit_huff_decoder: std_huff_tables
          static const uint8_t dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
          const uint8_t* ac_vals[2] = {kStdAcLuma, kStdAcChroma};
          for (int t = 0; t < 2; ++t) {
            if (!dc_spec[t].present) dc_spec[t].set(kStdDcCounts[t], dc_vals, 12);
            if (!ac_spec[t].present) ac_spec[t].set(kStdAcCounts[t], ac_vals[t], 162);
          }
        }
      }
      const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4,
                al = s[3 + 2 * ns] & 15;
      // a sequential scan ignores Ss, Se, Ah and Al (libjpeg warns); a
      // progressive one must be a legal band (jdphuff.c)
      const bool dc_band = ss == 0;
      if (progressive) {
        bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
        if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
        if (bad) fail(BROKEN, "broken data stream (bad progression parameters)");
      }
      std::vector<Component*> sc;
      std::vector<int> td, ta;
      Component* taken[4] = {nullptr, nullptr, nullptr, nullptr};
      int blocks = 0;
      for (int i = 0; i < ns; ++i) {
        // jdmarker.c get_sos: the first component of that id whose slot,
        // indexed by component, is still free
        Component* c = nullptr;
        for (size_t ci = 0; ci < comps.size() && ci < 4 && !c; ++ci)
          if (comps[ci].id == s[1 + 2 * i] && !taken[ci]) c = &comps[ci];
        if (!c) fail(BROKEN, "JPEG scan names an unknown component");
        for (int pi = 0; pi < i; ++pi)  // and one the scan named before is refused
          if (taken[pi] == c) fail(BROKEN, "JPEG scan names a component twice");
        taken[i] = c;
        blocks += c->h * c->v;
        td.push_back(s[2 + 2 * i] >> 4);
        ta.push_back(s[2 + 2 * i] & 15);
        const bool need_dc = !progressive || (dc_band && ah == 0);
        const bool need_ac = !progressive || !dc_band;
        if ((need_dc && (td.back() > 3 || !dc_spec[td.back()].present)) ||
            (need_ac && (ta.back() > 3 || !ac_spec[ta.back()].present)))
          fail(BROKEN, "JPEG scan uses an undefined Huffman table");
        if (need_dc) {
          const HuffSpec& h = dc_spec[td.back()];
          dc[td.back()].build(h.counts, h.symbols, h.n, true);
        }
        if (need_ac) {
          const HuffSpec& h = ac_spec[ta.back()];
          ac[ta.back()].build(h.counts, h.symbols, h.n, false);
        }
        if (!c->latched) {  // jdinput.c latch_quant_tables
          if (c->tq > 3 || !qt_present[c->tq])
            fail(BROKEN, "JPEG component uses an undefined table");
          std::memcpy(c->q, qt[c->tq], sizeof(c->q));
          c->latched = true;
        }
        sc.push_back(c);
      }
      if (ns > 1 && blocks > 10) fail(BROKEN, "broken data stream (MCU of more than 10 blocks)");
      ++scans;
      if (progressive) {  // the progression status (start_pass_phuff_decoder)
        for (Component* c : sc) {
          for (int k = ss < 1 ? ss : 1; k <= (se > 9 ? se : 9); ++k)
            c->prev_bits[k] = scans > 1 ? c->bits[k] : 0;
          for (int k = ss; k <= se; ++k) c->bits[k] = al;
        }
      }
      BitReader br(d, n, pos + len);
      std::vector<int> pred(ns, 0);
      unsigned eobrun = 0;
      const int p1 = 1 << al, m1 = -1 * (1 << al);
      // a sequential block: DC difference, then the 63 AC coefficients
      auto block = [&](int k, int16_t* b) {
        int t = br.decode(dc[td[k]]);
        int diff = t ? extend(br.get(t), t) : 0;
        pred[k] += diff;
        b[0] = (int16_t)pred[k];
        const Huffman& h = ac[ta[k]];
        for (int z = 1; z < 64; ++z) {
          int rs = br.decode(h);
          int r = rs >> 4, sz = rs & 15;
          if (sz) {
            z += r;
            b[kNatural[z]] = (int16_t)extend(br.get(sz), sz);
          } else {
            if (r != 15) break;
            z += 15;
          }
        }
      };
      // progressive blocks (jdphuff.c decode_mcu_DC_first / _DC_refine /
      // _AC_first / _AC_refine)
      auto dc_first = [&](int k, int16_t* b) {
        int t = br.decode(dc[td[k]]);
        int diff = t ? extend(br.get(t), t) : 0;
        pred[k] += diff;
        b[0] = (int16_t)(int)((unsigned)pred[k] << al);
      };
      auto dc_refine = [&](int, int16_t* b) {
        if (br.get(1)) b[0] = (int16_t)(b[0] | p1);
      };
      auto ac_first = [&](int, int16_t* b) {
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        const Huffman& h = ac[ta[0]];
        for (int k = ss; k <= se; ++k) {
          int rs = br.decode(h);
          int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            b[kNatural[k]] = (int16_t)(int)((unsigned)extend(br.get(sz), sz) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1u << r;
            if (r) eobrun += br.get(r);
            --eobrun;
            break;
          }
        }
      };
      auto correct = [&](int16_t* coef) {  // a correction bit for a nonzero coefficient
        if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
      };
      auto ac_refine = [&](int, int16_t* b) {
        const Huffman& h = ac[ta[0]];
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            int rs = br.decode(h);
            int r = rs >> 4, sz = rs & 15;
            int v = 0;
            if (sz) {  // a newly nonzero coefficient (size 1; libjpeg warns on others)
              v = br.get(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1u << r;
              if (r) eobrun += br.get(r);
              break;
            }
            do {
              int16_t* coef = b + kNatural[k];
              if (*coef != 0) {
                correct(coef);
              } else if (--r < 0) {
                break;
              }
              ++k;
            } while (k <= se);
            if (v) b[kNatural[k]] = (int16_t)v;
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) {
            int16_t* coef = b + kNatural[k];
            if (*coef != 0) correct(coef);
          }
          --eobrun;
        }
      };
      const int mode = !progressive ? 0 : dc_band ? (ah == 0 ? 1 : 2) : (ah == 0 ? 3 : 4);
      auto decode_block = [&](int k, int16_t* b) {
        switch (mode) {
          case 0: block(k, b); break;
          case 1: dc_first(k, b); break;
          case 2: dc_refine(k, b); break;
          case 3: ac_first(k, b); break;
          default: ac_refine(k, b); break;
        }
      };
      auto at = [](Component& c, int bx, int by) {
        return c.coef.data() + ((size_t)by * c.bw + bx) * 64;
      };
      long units;  // MCUs of the scan
      int ux;
      if (ns == 1) {
        Component& c = *sc[0];
        ux = c.wb;
        units = (long)ux * c.hb;
      } else {
        ux = mcux;
        units = (long)mcux * mcuy;
      }
      int rst = 0;
      for (long u = 0; u < units; ++u) {
        const int mx = (int)(u % ux), my = (int)(u / ux);
        // jdcoefct.c notes the last iMCU row begun with data in hand
        if (!br.insufficient()) last_good = ns == 1 ? my / sc[0]->v : my;
        if (restart_interval && u > 0 && u % restart_interval == 0) {
          br.restart(rst);
          rst = (rst + 1) & 7;
          for (auto& p : pred) p = 0;
          eobrun = 0;
        }
        if (br.insufficient()) continue;  // libjpeg leaves these MCUs untouched
        if (ns == 1) {
          decode_block(0, at(*sc[0], mx, my));
        } else {
          for (int k = 0; k < ns; ++k)
            for (int yy = 0; yy < sc[k]->v; ++yy)
              for (int xx = 0; xx < sc[k]->h; ++xx)
                decode_block(k, at(*sc[k], mx * sc[k]->h + xx, my * sc[k]->v + yy));
        }
      }
      pos = br.end();
      continue;
    }
    pos += len;
  }
  if (!frame || !scans) fail(BROKEN, "JPEG without image data");

  // libjpeg's block smoothing applies where the scans left some of the
  // first nine AC coefficients' low bits unsent (jdcoefct.c smoothing_ok)
  bool smooth = progressive;
  if (smooth) {
    bool useful = false;
    for (auto& c : comps) {
      if (!c.latched || c.bits[0] < 0 || !c.q[0] || !c.q[1] || !c.q[8] || !c.q[16] ||
          !c.q[9] || !c.q[2] || !c.q[3] || !c.q[10] || !c.q[17] || !c.q[24]) {
        smooth = false;
        break;
      }
      for (int k = 1; k < 10; ++k) useful |= c.bits[k] != 0;
    }
    smooth = smooth && useful;
  }
  for (auto& c : comps) {
    const int stride = c.bw * 8;
    c.plane.assign((size_t)stride * c.bh * 8, 0);
    if (!c.latched) std::memset(c.q, 0, sizeof(c.q));  // never scanned: all zero
    if (smooth) {
      // rows past the last one the last scan reached take the bits as they
      // were before it (a single scan leaves those at -1)
      int prev[10];
      for (int k = 0; k < 10; ++k) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
      smooth_idct(c, mcuy, c.bits, prev, last_good);
    } else {
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.q,
                     c.plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
    }
    std::vector<int16_t>().swap(c.coef);
  }
  out.assign((size_t)W * H, 0);
  if (comps.size() == 1) {
    std::vector<uint8_t> full;
    upsample(comps[0], hmax, vmax, W, H, full);
    out.swap(full);
    return;
  }
  std::vector<uint8_t> p[4];
  for (size_t k = 0; k < comps.size(); ++k) upsample(comps[k], hmax, vmax, W, H, p[k]);
  const size_t np = (size_t)W * H;
  if (comps.size() == 4) {
    // jdapimin.c: with an Adobe marker of transform 0 the data is CMYK,
    // with any other transform YCCK (converted to CMYK by jdcolor.c);
    // without one, CMYK.  PIL reads the CMYK as "CMYK;I" (inverted) and
    // converts it to RGB with cmyk2rgb, then to L.  Inverted, YCCK's C, M
    // and Y are the RGB of its YCC, clamped.
    const bool ycck = adobe && adobe_transform != 0;
    for (size_t i = 0; i < np; ++i) {
      int c, m, y;
      if (ycck) {
        const int yy = p[0][i], cb = p[1][i], cr = p[2][i];
        c = clamp255(yy + kYcc.cr_r[cr]);
        m = clamp255(yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        y = clamp255(yy + kYcc.cb_b[cb]);
      } else {
        c = 255 - p[0][i];
        m = 255 - p[1][i];
        y = 255 - p[2][i];
      }
      const int nk = p[3][i];  // 255 - K, K being the inverted sample
      out[i] = L24(clamp255(nk - muldiv255(c, nk)), clamp255(nk - muldiv255(m, nk)),
                   clamp255(nk - muldiv255(y, nk)));
    }
    return;
  }
  bool ycc;
  if (strip >= 0) {
    ycc = strip == 1;
  } else if (jfif) {
    ycc = true;
  } else if (adobe) {
    ycc = adobe_transform != 0;
  } else {
    ycc = !(comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66);
  }
  if (!ycc) {
    for (size_t i = 0; i < np; ++i) out[i] = L24(p[0][i], p[1][i], p[2][i]);
    return;
  }
  for (size_t i = 0; i < np; ++i) {
    const int y = p[0][i], cb = p[1][i], cr = p[2][i];
    const int r = clamp255(y + kYcc.cr_r[cr]);
    const int g = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    const int b = clamp255(y + kYcc.cb_b[cb]);
    out[i] = L24(r, g, b);
  }
}

// ---------------------------------------------------------------- BMP, PNM

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
inline int le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// BmpImagePlugin.py's reading of a BMP, then convert("L").  Pixels are read
// in the raw mode PIL picks (`raw_bits` a pixel from each row of the file's
// stride, which PIL does even where the mode's depth is not the file's), or
// decoded by its RLE8/RLE4 decoder with its quirks: an encoded run is cut at
// the row's end, a delta reads two bytes more than the escape's two and
// moves by the second pair, an odd RLE4 absolute run drops its last pixel,
// and absolute runs are word-aligned on the file's offset.
void decode_bmp(const uint8_t* d, size_t n, std::vector<uint8_t>& out, int& W, int& H) {
  if (n < 18) fail(BROKEN, "cannot identify image file");
  uint32_t offset = le32(d + 10);
  const uint32_t hsize = le32(d + 14);
  if (hsize != 12 && hsize != 40 && hsize != 52 && hsize != 56 && hsize != 64 && hsize != 108 &&
      hsize != 124)
    fail(BROKEN, "Unsupported BMP header type (" + std::to_string(hsize) + ")");
  if (14 + (size_t)hsize > n) fail(BROKEN, "Truncated File Read");
  const uint8_t* hd = d + 18;  // the header after its size
  long width, height;
  int bits, compression = 0, pal_entry, direction = -1;
  uint64_t colors = 0;
  uint32_t masks[4] = {0, 0, 0, 0};
  size_t after = 14 + hsize;  // where the palette (or a 40-byte header's masks) starts
  if (hsize == 12) {
    width = le16(hd);
    height = le16(hd + 2);
    bits = le16(hd + 6);
    pal_entry = 3;
  } else {
    const bool flip = hd[7] == 0xFF;
    direction = flip ? 1 : -1;
    width = le32(hd);
    height = flip ? (long)((1ull << 32) - le32(hd + 4)) : (long)le32(hd + 4);
    bits = le16(hd + 10);
    compression = (int)le32(hd + 12);
    colors = le32(hd + 28);
    pal_entry = 4;
    if (compression == 3) {
      if (hsize >= 52) {
        for (int k = 0; k < (hsize >= 56 ? 4 : 3); ++k) masks[k] = le32(hd + 36 + 4 * k);
      } else {
        if (after + 12 > n) fail(BROKEN, "cannot identify image file");
        for (int k = 0; k < 3; ++k) masks[k] = le32(d + after + 4 * k);
        after += 12;
      }
    }
  }
  if (colors == 0) colors = bits < 64 ? 1ull << bits : 0;
  if (offset == 14 + hsize && bits <= 8) offset += (uint32_t)(4 * colors);
  // the raw mode: its bits a pixel and how its bytes make a grey value
  enum Raw { ONE, GREY, PAL, BGR15, BGR16, BGR24, BGR32 };
  Raw raw;
  int raw_bits, pos_r = 2, pos_g = 1, pos_b = 0;
  switch (bits) {
    case 1: case 4: case 8: raw = PAL; raw_bits = bits; break;
    case 16: raw = BGR15; raw_bits = 16; break;
    case 24: raw = BGR24; raw_bits = 24; break;
    case 32: raw = BGR32; raw_bits = 32; break;
    default: fail(BROKEN, "Unsupported BMP pixel depth (" + std::to_string(bits) + ")");
  }
  const bool rle = compression == 1 || compression == 2;
  if (compression == 3) {
    const uint32_t r = masks[0], g = masks[1], b = masks[2], a = masks[3];
    // BmpImagePlugin's MASK_MODES: the raw mode names the byte order
    static const struct { uint32_t r, g, b, a; const char* mode; } k32[] = {
        {0xFF0000, 0xFF00, 0xFF, 0x0, "BGRX"},       {0xFF000000, 0xFF0000, 0xFF00, 0x0, "XBGR"},
        {0xFF000000, 0xFF00, 0xFF, 0x0, "BGXR"},     {0xFF000000, 0xFF0000, 0xFF00, 0xFF, "ABGR"},
        {0xFF, 0xFF00, 0xFF0000, 0xFF000000, "RGBA"}, {0xFF0000, 0xFF00, 0xFF, 0xFF000000, "BGRA"},
        {0xFF000000, 0xFF00, 0xFF, 0xFF0000, "BGAR"}, {0x0, 0x0, 0x0, 0x0, "BGRA"}};
    bool ok = false;
    if (bits == 32) {
      for (const auto& e : k32) {
        if (e.r == r && e.g == g && e.b == b && e.a == a) {
          const std::string m = e.mode;
          pos_r = (int)m.find('R');
          pos_g = (int)m.find('G');
          pos_b = (int)m.find('B');
          ok = true;
          break;
        }
      }
    } else if (bits == 24) {
      ok = r == 0xFF0000 && g == 0xFF00 && b == 0xFF;
    } else if (bits == 16) {
      if (r == 0xF800 && g == 0x7E0 && b == 0x1F) {
        raw = BGR16;
        ok = true;
      } else {
        ok = r == 0x7C00 && g == 0x3E0 && b == 0x1F;
      }
    }
    if (!ok) fail(BROKEN, "Unsupported BMP bitfields layout");
  } else if (compression != 0 && !rle) {
    fail(BROKEN, "Unsupported BMP compression (" + std::to_string(compression) + ")");
  }
  uint8_t lut[256];
  std::memset(lut, 0, sizeof(lut));
  if (raw == PAL) {
    if (colors == 0 || colors > 65536)
      fail(BROKEN, "Unsupported BMP Palette size (" + std::to_string(colors) + ")");
    const size_t want = (size_t)pal_entry * colors;
    const size_t have = after < n ? (n - after < want ? n - after : want) : 0;
    const uint8_t* pal = d + after;
    bool grey = true;  // a palette of greys i (black, white for two) is dropped: mode 1 or L
    for (uint64_t i = 0; i < colors && grey; ++i) {
      const int v = colors == 2 ? (i ? 255 : 0) : (int)(i & 0xFF);
      const size_t e = (size_t)i * pal_entry;
      grey = e + 3 <= have && pal[e] == v && pal[e + 1] == v && pal[e + 2] == v;
    }
    if (grey) {
      raw = colors == 2 ? ONE : GREY;
      raw_bits = colors == 2 ? 1 : 8;
    }
    for (size_t i = 0; i < 256 && i < colors && i * pal_entry + 3 <= have; ++i)
      lut[i] = L24(pal[i * pal_entry + 2], pal[i * pal_entry + 1], pal[i * pal_entry]);
  }
  check_size(width, height);
  if (width <= 0 || height <= 0) fail(BROKEN, "BMP of a bad size");
  W = (int)width;
  H = (int)height;
  out.assign((size_t)W * H, 0);
  const size_t np = (size_t)W * H;
  if (rle) {
    if (raw != PAL && raw != GREY) fail(VALUE, "unknown raw mode for given image mode");
    const bool rle4 = compression == 2;
    std::vector<uint8_t> px;
    px.reserve(np);
    size_t p = offset;
    size_t x = 0;
    auto avail = [&](size_t k) { return p < n ? (n - p < k ? n - p : k) : 0; };
    while (px.size() < np) {
      if (avail(2) < 2) break;
      size_t num = d[p];
      const int byte = d[p + 1];
      p += 2;
      if (num) {
        if (x + num > (size_t)W) num = x < (size_t)W ? W - x : 0;
        for (size_t i = 0; i < num; ++i)
          px.push_back(rle4 ? (uint8_t)(i % 2 == 0 ? byte >> 4 : byte & 0x0F) : (uint8_t)byte);
        x += num;
      } else if (byte == 0) {  // end of line
        while (px.size() % W) px.push_back(0);
        x = 0;
      } else if (byte == 1) {  // end of bitmap
        break;
      } else if (byte == 2) {  // delta
        if (avail(2) < 2) break;
        p += 2;
        if (avail(2) < 2) fail(VALUE, "not enough values to unpack");
        const size_t right = d[p], up = d[p + 1];
        p += 2;
        px.insert(px.end(), right + up * W, 0);
        x = px.size() % W;
      } else {  // absolute run
        const size_t count = rle4 ? byte / 2 : byte;
        const size_t got = avail(count);
        for (size_t i = 0; i < got; ++i) {
          if (rle4) {
            px.push_back(d[p + i] >> 4);
            px.push_back(d[p + i] & 0x0F);
          } else {
            px.push_back(d[p + i]);
          }
        }
        p += got;
        if (got < count) break;
        x += byte;
        if (p % 2) ++p;
      }
    }
    if (px.size() < np) fail(VALUE, "not enough image data");
    for (int y = 0; y < H; ++y) {
      const uint8_t* r = px.data() + (size_t)y * W;
      uint8_t* o = out.data() + (size_t)(direction < 0 ? H - 1 - y : y) * W;
      for (int i = 0; i < W; ++i) o[i] = raw == GREY ? r[i] : lut[r[i]];
    }
    return;
  }
  const size_t stride = (((size_t)W * bits + 31) >> 3) & ~(size_t)3;
  const size_t row_bytes = ((size_t)W * raw_bits + 7) / 8;
  if (row_bytes > stride) fail(BROKEN, "codec configuration error when reading image file");
  if ((size_t)offset + stride * (H - 1) + row_bytes > n) fail(BROKEN, "image file is truncated");
  for (int y = 0; y < H; ++y) {
    const uint8_t* r = d + offset + stride * (size_t)y;
    uint8_t* o = out.data() + (size_t)(direction < 0 ? H - 1 - y : y) * W;
    switch (raw) {
      case ONE:
        for (int x = 0; x < W; ++x) o[x] = (r[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0;
        break;
      case GREY:
        std::memcpy(o, r, W);
        break;
      case PAL:
        for (int x = 0; x < W; ++x) {
          int v = r[x];
          if (bits == 1) v = (r[x >> 3] >> (7 - (x & 7))) & 1;
          else if (bits == 4) v = (r[x >> 1] >> (x & 1 ? 0 : 4)) & 15;
          o[x] = lut[v];
        }
        break;
      case BGR15: case BGR16:
        for (int x = 0; x < W; ++x) {
          const int v = r[2 * x] | (r[2 * x + 1] << 8);
          const int red = raw == BGR16 ? ((v >> 11) & 31) * 255 / 31 : ((v >> 10) & 31) * 255 / 31;
          const int green = raw == BGR16 ? ((v >> 5) & 63) * 255 / 63 : ((v >> 5) & 31) * 255 / 31;
          o[x] = L24(red, green, (v & 31) * 255 / 31);
        }
        break;
      case BGR24:
        for (int x = 0; x < W; ++x) o[x] = L24(r[3 * x + 2], r[3 * x + 1], r[3 * x]);
        break;
      case BGR32:
        for (int x = 0; x < W; ++x) o[x] = L24(r[4 * x + pos_r], r[4 * x + pos_g], r[4 * x + pos_b]);
        break;
    }
  }
}

// PpmImagePlugin.py's reading of a PNM, then convert("L").  P1-P6; maxval
// 255 reads raw, 65535 (grey) as 16-bit "I", any other through its Python
// decoder, each sample round(v / maxval * out_max) (half to even; out_max
// 65535 for grey above maxval 255, whose "I" image convert("L") clips, 255
// otherwise).  Header tokens are PIL's: whitespace-separated, comments from
// "#" to the line's end anywhere, at most 10 characters.  PIL's own
// extensions (Pf, P0CMYK, Py*) are not PNM files the sniffer passes here.
void decode_pnm(const uint8_t* d, size_t n, std::vector<uint8_t>& out, int& W, int& H) {
  size_t p = 0;
  auto ws = [](int c) { return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r'; };
  std::string magic;
  for (int i = 0; i < 6 && p < n; ++i) {
    const int c = d[p++];
    if (ws(c)) break;
    magic += (char)c;
  }
  if (magic.size() != 2 || magic[0] != 'P' || magic[1] < '1' || magic[1] > '6')
    fail(BROKEN, "cannot identify image file");
  const int kind = magic[1] - '0';
  auto token = [&]() {
    std::string t;
    while (t.size() <= 10) {
      if (p >= n) break;
      const int c = d[p++];
      if (ws(c)) {
        if (t.empty()) continue;
        break;
      }
      if (c == '#') {  // to CR, LF or the end, consumed
        while (p < n && d[p] != '\r' && d[p] != '\n') ++p;
        if (p < n) ++p;
        continue;
      }
      t += (char)c;
    }
    if (t.empty()) fail(VALUE, "Reached EOF while reading header");
    if (t.size() > 10) fail(VALUE, "Token too long in file header");
    size_t i = t[0] == '+' || t[0] == '-' ? 1 : 0;
    if (i == t.size()) fail(VALUE, "invalid literal for int()");
    for (size_t k = i; k < t.size(); ++k)
      if (t[k] < '0' || t[k] > '9') fail(VALUE, "invalid literal for int()");
    const long v = std::stol(t);
    return v;
  };
  const long w = token(), h = token();
  check_size(w, h);
  if (w <= 0 || h <= 0) fail(BROKEN, "PNM of a bad size");
  W = (int)w;
  H = (int)h;
  const size_t np = (size_t)W * H;
  out.assign(np, 0);
  if (kind == 1 || kind == 4) {  // mode "1": 1 is black
    if (kind == 4) {
      const size_t rb = ((size_t)W + 7) / 8;
      if (p + rb * H > n) fail(BROKEN, "image file is truncated");
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x)
          out[(size_t)y * W + x] = (d[p + rb * y + (x >> 3)] >> (7 - (x & 7))) & 1 ? 0 : 255;
      return;
    }
    size_t k = 0;
    bool comment = false;
    for (; p < n && k < np; ++p) {
      const int c = d[p];
      if (comment) {
        comment = c != '\r' && c != '\n';
        continue;
      }
      if (c == '#') {
        comment = true;
      } else if (!ws(c)) {
        if (c != '0' && c != '1') fail(VALUE, "Invalid token for this mode");
        out[k++] = c == '0' ? 255 : 0;
      }
    }
    if (k < np) fail(VALUE, "not enough image data");
    return;
  }
  const long maxval = token();
  if (maxval <= 0 || maxval >= 65536)
    fail(VALUE, "maxval must be greater than 0 and less than 65536");
  const int bands = kind == 3 || kind == 6 ? 3 : 1;
  const bool wide = bands == 1 && maxval > 255;  // mode "I"
  const double out_max = wide ? 65535.0 : 255.0;
  auto scale = [&](long v) {
    long r = (long)std::nearbyint((double)v / (double)maxval * out_max);
    if (r > (long)out_max) r = (long)out_max;
    return (int)(r > 255 ? 255 : r);  // "I" -> L clips
  };
  std::vector<int> s(np * bands);
  if (kind == 2 || kind == 3) {  // plain: comments cut out (their line end too), then tokens
    std::string body;
    for (; p < n; ++p) {
      if (d[p] == '#') {
        while (p < n && d[p] != '\r' && d[p] != '\n') ++p;
      } else {
        body += (char)d[p];
      }
    }
    size_t k = 0, q = 0;
    while (k < s.size()) {
      while (q < body.size() && ws((uint8_t)body[q])) ++q;
      if (q >= body.size()) break;
      std::string t;
      while (q < body.size() && !ws((uint8_t)body[q])) t += body[q++];
      if (t.size() > 10) fail(VALUE, "Token too long found in data");
      size_t i = t[0] == '+' || t[0] == '-' ? 1 : 0;
      if (i == t.size()) fail(VALUE, "invalid literal for int()");
      for (size_t j = i; j < t.size(); ++j)
        if (t[j] < '0' || t[j] > '9') fail(VALUE, "invalid literal for int()");
      const long v = std::stol(t);
      if (v < 0) fail(VALUE, "Channel value is negative");
      if (v > maxval) fail(VALUE, "Channel value too large for this mode");
      s[k++] = scale(v);
    }
    if (k < s.size()) fail(VALUE, "not enough image data");
  } else if (maxval == 255 || (wide && maxval == 65535)) {  // raw
    const size_t bytes = maxval == 255 ? 1 : 2;
    if (p + s.size() * bytes > n) fail(BROKEN, "image file is truncated");
    for (size_t k = 0; k < s.size(); ++k) {
      const int v = bytes == 1 ? d[p + k] : (d[p + 2 * k] << 8) | d[p + 2 * k + 1];
      s[k] = v > 255 ? 255 : v;
    }
  } else {  // PIL's PpmDecoder
    const size_t bytes = maxval < 256 ? 1 : 2;
    const size_t have = (n - p) / (bytes * bands);
    if (have < np) fail(VALUE, "not enough image data");
    for (size_t k = 0; k < s.size(); ++k)
      s[k] = scale(bytes == 1 ? d[p + k] : (d[p + 2 * k] << 8) | d[p + 2 * k + 1]);
  }
  for (size_t i = 0; i < np; ++i)
    out[i] = bands == 1 ? (uint8_t)s[i] : L24(s[3 * i], s[3 * i + 1], s[3 * i + 2]);
}

// ---------------------------------------------------------------- resize

struct Filter {
  double (*f)(double);
  double support;
};
double bilinear(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}
double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

const int kPrecision = 22;  // 32 - 8 - 2

// precompute_coeffs + normalize_coeffs_8bpc (Resample.c)
int coeffs(int in_size, double in0, double in1, int out_size, const Filter& f,
           std::vector<int>& bounds, std::vector<int32_t>& kk) {
  double scale = (in1 - in0) / out_size, filterscale = scale;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = f.support * filterscale;
  const int ksize = (int)std::ceil(support) * 2 + 1;
  bounds.assign((size_t)out_size * 2, 0);
  kk.assign((size_t)out_size * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    int x = 0;
    for (; x < xmax; ++x) {
      const double w = f.f((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    for (; x < ksize; ++x) k[x] = 0;
    for (x = 0; x < ksize; ++x)
      kk[(size_t)xx * ksize + x] = k[x] < 0 ? (int)(-0.5 + k[x] * (1 << kPrecision))
                                            : (int)(0.5 + k[x] * (1 << kPrecision));
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int v) {
  v >>= kPrecision;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

}  // namespace

extern "C" {

// Decode a JPEG, BMP or binary PGM/PPM into a malloc'ed uint8 [h, w] page
// (free it with image_free); returns OK or an error code, with the
// reason in msg.
int decode_gray(const uint8_t* data, size_t n, uint8_t** out, int* w, int* h, char* msg,
                int msg_len) {
  *out = nullptr;
  try {
    std::vector<uint8_t> img;
    int W = 0, H = 0;
    if (n >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF) {
      decode_jpeg(data, n, img, W, H);
    } else if (n >= 2 && data[0] == 'B' && data[1] == 'M') {
      decode_bmp(data, n, img, W, H);
    } else if (n >= 2 && data[0] == 'P' && data[1] >= '1' && data[1] <= '7') {
      decode_pnm(data, n, img, W, H);
    } else {
      fail(BROKEN, "cannot identify image file");
    }
    *out = (uint8_t*)std::malloc(img.size() ? img.size() : 1);
    if (!*out) fail(BROKEN, "out of memory");
    std::memcpy(*out, img.data(), img.size());
    *w = W;
    *h = H;
    return OK;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_len, "%s", f.msg.c_str());
    return f.code;
  } catch (const std::bad_alloc&) {
    std::snprintf(msg, msg_len, "out of memory");
    return BROKEN;
  }
}

// A JPEG-compressed TIFF strip or tile (the JPEGTables spliced in) as
// libtiff decodes it: libjpeg's first marker must be SOI; `ycc` 1 converts
// three components from YCbCr, 0 takes them as they are; see decode_jpeg.
int decode_jpeg_strip(const uint8_t* data, size_t n, int ycc, uint8_t** out, int* w, int* h,
                      char* msg, int msg_len) {
  *out = nullptr;
  try {
    std::vector<uint8_t> img;
    int W = 0, H = 0;
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) {
      char text[64];
      std::snprintf(text, sizeof(text), "Not a JPEG file: starts with 0x%02x 0x%02x",
                    n > 0 ? data[0] : 0, n > 1 ? data[1] : 0);
      fail(BROKEN, text);
    }
    decode_jpeg(data, n, img, W, H, ycc ? 1 : 0);
    *out = (uint8_t*)std::malloc(img.size() ? img.size() : 1);
    if (!*out) fail(BROKEN, "out of memory");
    std::memcpy(*out, img.data(), img.size());
    *w = W;
    *h = H;
    return OK;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_len, "%s", f.msg.c_str());
    return f.code;
  } catch (const std::bad_alloc&) {
    std::snprintf(msg, msg_len, "out of memory");
    return BROKEN;
  }
}

void image_free(uint8_t* p) { std::free(p); }

// Unfilter an inflated PNG image (bit depth 1/2/4/8/16, plain or Adam7
// interlaced) and convert it to L as PIL's convert("L") does: grey of depth
// 1 -> 0/255, 2 -> x85, 4 -> x17, 16 ("I;16") -> the value clipped to 255;
// RGB(A) -> L24 (of the high bytes at 16 bits, Pillow's ";16B" raw modes);
// palette -> L24 of the entry; grey + alpha -> grey (its high byte at 16
// bits).  `palette` holds n_palette RGB triples.  An Adam7 pass that holds
// no pixel has no rows, and so no filter bytes.
int png_to_gray(const uint8_t* raw, size_t n, int w, int h, int color_type, int depth,
                int interlace, const uint8_t* palette, int n_palette, uint8_t* out, char* msg,
                int msg_len) {
  try {
    int channels;
    switch (color_type) {
      case 0: channels = 1; break;
      case 2: channels = 3; break;
      case 3: channels = 1; break;
      case 4: channels = 2; break;
      case 6: channels = 4; break;
      default: fail(BROKEN, "PNG of unknown colour type");
    }
    const int bpp = (channels * depth + 7) / 8;
    uint8_t lut[256];
    for (int i = 0; i < 256; ++i)
      lut[i] = i < n_palette ? L24(palette[3 * i], palette[3 * i + 1], palette[3 * i + 2]) : 0;
    // (x0, y0, dx, dy) of each pass
    static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                     {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
    static const int kWhole[1][4] = {{0, 0, 1, 1}};
    const int(*passes)[4] = interlace ? kAdam7 : kWhole;
    const int n_passes = interlace ? 7 : 1;
    size_t off = 0;
    for (int pi = 0; pi < n_passes; ++pi) {
      const int x0 = passes[pi][0], y0 = passes[pi][1], dx = passes[pi][2], dy = passes[pi][3];
      const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
      const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
      if (pw == 0 || ph == 0) continue;
      const size_t row_bytes = ((size_t)pw * channels * depth + 7) / 8;
      if (n < off + (row_bytes + 1) * ph) fail(BROKEN, "image file is truncated");
      std::vector<uint8_t> prev(row_bytes, 0), cur(row_bytes);
      for (int y = 0; y < ph; ++y) {
        const uint8_t* src = raw + off + (row_bytes + 1) * y;
        const int ft = src[0];
        ++src;
        for (size_t i = 0; i < row_bytes; ++i) {
          const int a = i >= (size_t)bpp ? cur[i - bpp] : 0;
          const int b = prev[i];
          const int c = i >= (size_t)bpp ? prev[i - bpp] : 0;
          int x = src[i];
          switch (ft) {
            case 0: break;
            case 1: x += a; break;
            case 2: x += b; break;
            case 3: x += (a + b) >> 1; break;
            case 4: {
              const int p = a + b - c;
              const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
              x += (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
              break;
            }
            default: fail(BROKEN, "PNG row of unknown filter type " + std::to_string(ft));
          }
          cur[i] = (uint8_t)x;
        }
        uint8_t* o = out + (size_t)(y0 + y * dy) * w + x0;
        if (depth == 16) {
          for (int x = 0; x < pw; ++x) {
            const uint8_t* p = cur.data() + (size_t)x * channels * 2;
            uint8_t v;
            switch (color_type) {
              case 0: v = p[0] ? 255 : p[1]; break;
              case 4: v = p[0]; break;
              default: v = L24(p[0], p[2], p[4]); break;
            }
            o[(size_t)x * dx] = v;
          }
        } else if (depth == 8) {
          for (int x = 0; x < pw; ++x) {
            const uint8_t* p = cur.data() + (size_t)x * channels;
            uint8_t v = 0;
            switch (color_type) {
              case 0: case 4: v = p[0]; break;
              case 2: case 6: v = L24(p[0], p[1], p[2]); break;
              case 3: v = lut[p[0]]; break;
            }
            o[(size_t)x * dx] = v;
          }
        } else {
          const int per = 8 / depth, mask = (1 << depth) - 1;
          const int scale = depth == 1 ? 255 : depth == 2 ? 85 : 17;
          for (int x = 0; x < pw; ++x) {
            const int v = (cur[x / per] >> (8 - depth * (x % per + 1))) & mask;
            o[(size_t)x * dx] = color_type == 3 ? lut[v] : (uint8_t)(v * scale);
          }
        }
        prev.swap(cur);
      }
      off += (row_bytes + 1) * ph;
    }
    return OK;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_len, "%s", f.msg.c_str());
    return f.code;
  }
}

// PIL's Image.resize of a mode-L image [h, w] to [oh, ow]; filter 2 is
// BILINEAR, 3 BICUBIC (PIL's numbering).  The caller copies where the size
// is unchanged.
void resize_gray(const uint8_t* in, int h, int w, uint8_t* out, int oh, int ow, int filter) {
  const Filter f = filter == 3 ? Filter{bicubic, 2.0} : Filter{bilinear, 1.0};
  const bool need_h = ow != w, need_v = oh != h;
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  const int ksh = coeffs(w, 0.0, w, ow, f, bh, kh);
  const int ksv = coeffs(h, 0.0, h, oh, f, bv, kv);
  const int first = bv[0], last = bv[oh * 2 - 2] + bv[oh * 2 - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int sw = w;
  if (need_h) {
    for (int i = 0; i < oh; ++i) bv[i * 2] -= first;
    const int rows = last - first;
    tmp.assign((size_t)rows * ow, 0);
    for (int yy = 0; yy < rows; ++yy) {
      const uint8_t* r = in + (size_t)(yy + first) * w;
      for (int xx = 0; xx < ow; ++xx) {
        const int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = kh.data() + (size_t)xx * ksh;
        int ss = 1 << (kPrecision - 1);
        for (int x = 0; x < xmax; ++x) ss += r[x + xmin] * k[x];
        tmp[(size_t)yy * ow + xx] = clip8(ss);
      }
    }
    src = tmp.data();
    sw = ow;
    if (!need_v) {
      std::memcpy(out, tmp.data(), (size_t)oh * ow);
      return;
    }
  }
  if (need_v) {
    for (int yy = 0; yy < oh; ++yy) {
      const int ymin = bv[yy * 2], ymax = bv[yy * 2 + 1];
      const int32_t* k = kv.data() + (size_t)yy * ksv;
      for (int xx = 0; xx < sw; ++xx) {
        int ss = 1 << (kPrecision - 1);
        for (int y = 0; y < ymax; ++y) ss += src[(size_t)(y + ymin) * sw + xx] * k[y];
        out[(size_t)yy * sw + xx] = clip8(ss);
      }
    }
    return;
  }
  std::memcpy(out, in, (size_t)h * w);
}

// PIL's ImagingCrop on integer coordinates: [y1 - y0, x1 - x0], zeros where
// the box leaves the page.
void crop_gray(const uint8_t* in, int h, int w, int x0, int y0, int x1, int y1, uint8_t* out) {
  const int ow = x1 - x0, oh = y1 - y0;
  std::memset(out, 0, (size_t)ow * oh);
  for (int y = y0 < 0 ? 0 : y0; y < (y1 < h ? y1 : h); ++y) {
    const int xa = x0 < 0 ? 0 : x0, xb = x1 < w ? x1 : w;
    if (xb > xa) std::memcpy(out + (size_t)(y - y0) * ow + (xa - x0), in + (size_t)y * w + xa, xb - xa);
  }
}

}  // extern "C"
