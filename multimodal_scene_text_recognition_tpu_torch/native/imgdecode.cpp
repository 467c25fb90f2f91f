// Image decoding, resizing and cropping of grayscale pages on the host, the
// way the data loaders read image files (data/images.py).  Each function
// gives what PIL gives for the same call, bit for bit:
//
//   decode_gray   Image.open(...).convert("L") of a baseline sequential
//                 Huffman JPEG (8-bit, 1 or 3 components, any integer
//                 sampling factors, restart intervals), an uncompressed
//                 8- or 24-bit BMP, or a binary PGM/PPM of maxval 255.
//                 JPEG follows libjpeg-turbo's default decompression: the
//                 ISLOW integer IDCT, "fancy" (triangle) upsampling of
//                 h2v1, h1v2 and h2v2 chroma, the fixed-point YCbCr->RGB
//                 tables; then PIL's RGB->L, (R*19595 + G*38470 + B*7471
//                 + 0x8000) >> 16.
//   png_to_gray   the unfiltering and RGB/palette->L of an inflated PNG
//                 (the zlib stream is inflated by Python's zlib).
//   resize_gray   Image.resize of a mode-L image with BILINEAR or BICUBIC:
//                 PIL's ImagingResample, 8-bit path (coefficients in 22
//                 fraction bits, the horizontal pass first over the rows
//                 the vertical pass reads).
//   crop_gray     Image.crop on integer coordinates, zeros off the page.
//
// Errors come back as a code and a message: 1 for broken or truncated data
// (Python raises OSError, as PIL does), 2 for a valid file of a kind this
// decoder does not cover (NotImplementedError).
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

enum { OK = 0, BROKEN = 1, UNSUPPORTED = 2 };

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Failure{code, msg}; }

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
  bool present = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, 0 where the code is longer
  uint16_t look[1 << 9];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
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
    present = true;
  }
};

struct Component {
  int id, h, v, tq;
  int bw, bh;          // blocks across and down, padded to whole MCUs
  int dw, dh;          // the downsampled size (libjpeg's downsampled_width/height)
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane; // (bw * 8) x (bh * 8) samples after the IDCT
};

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
          } else {  // a marker: libjpeg feeds zeros from here on
            marker_ = true;
            marker_pos_ = pos_;
            byte = 0;
          }
        } else {
          ++pos_;
        }
      }
      acc_ = (acc_ << 8) | (uint32_t)byte;
      bits_ += 8;
    }
  }
  inline int peek(int n) {
    fill(n);
    return (int)((acc_ >> (bits_ - n)) & ((1u << n) - 1));
  }
  inline void skip(int n) { bits_ -= n; }
  inline int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    bits_ -= n;
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
  // at a restart interval: drop the buffered bits and read RSTn
  void restart(int expected) {
    bits_ = 0;
    acc_ = 0;
    size_t p = marker_ ? marker_pos_ : pos_;
    while (p < n_ && d_[p] != 0xFF) ++p;  // libjpeg skips garbage before the marker
    while (p < n_ && d_[p] == 0xFF) ++p;
    if (p >= n_) fail(BROKEN, "image file is truncated");
    if (d_[p] != 0xD0 + expected) fail(BROKEN, "corrupt JPEG data: bad restart marker");
    pos_ = p + 1;
    marker_ = false;
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
  int bits_ = 0;
  bool marker_ = false;
  size_t marker_pos_ = 0;
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

// libjpeg's post-IDCT range limit: (x & 1023) read as a 10-bit signed value,
// recentred and clamped
inline uint8_t idct_limit(long x) {
  int v = (int)(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
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

// libjpeg's jpeg_idct_islow (jidctint.c): CONST_BITS 13, PASS1_BITS 2
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  long ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    long* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      long dc = ((long)ip[0] * qp[0]) * 4;
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    long z2 = (long)ip[16] * qp[16], z3 = (long)ip[48] * qp[48];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * -FIX_1_847759065;
    long tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (long)ip[0] * qp[0];
    z3 = (long)ip[32] * qp[32];
    long tmp0 = (z2 + z3) * 8192;
    long tmp1 = (z2 - z3) * 8192;
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (long)ip[56] * qp[56];
    tmp1 = (long)ip[40] * qp[40];
    tmp2 = (long)ip[24] * qp[24];
    tmp3 = (long)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = DESCALE(tmp10 + tmp3, 11);
    wp[56] = DESCALE(tmp10 - tmp3, 11);
    wp[8] = DESCALE(tmp11 + tmp2, 11);
    wp[48] = DESCALE(tmp11 - tmp2, 11);
    wp[16] = DESCALE(tmp12 + tmp1, 11);
    wp[40] = DESCALE(tmp12 - tmp1, 11);
    wp[24] = DESCALE(tmp13 + tmp0, 11);
    wp[32] = DESCALE(tmp13 - tmp0, 11);
  }
  for (int r = 0; r < 8; ++r) {
    const long* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t dc = idct_limit(DESCALE(wp[0], 5));
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * -FIX_1_847759065;
    long tmp3 = z1 + z2 * FIX_0_765366865;
    long tmp0 = (wp[0] + wp[4]) * 8192;
    long tmp1 = (wp[0] - wp[4]) * 8192;
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(DESCALE(tmp10 + tmp3, 18));
    op[7] = idct_limit(DESCALE(tmp10 - tmp3, 18));
    op[1] = idct_limit(DESCALE(tmp11 + tmp2, 18));
    op[6] = idct_limit(DESCALE(tmp11 - tmp2, 18));
    op[2] = idct_limit(DESCALE(tmp12 + tmp1, 18));
    op[5] = idct_limit(DESCALE(tmp12 - tmp1, 18));
    op[3] = idct_limit(DESCALE(tmp13 + tmp0, 18));
    op[4] = idct_limit(DESCALE(tmp13 - tmp0, 18));
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

void decode_jpeg(const uint8_t* d, size_t n, std::vector<uint8_t>& out, int& W, int& H) {
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0, restart_interval = 0;
  bool jfif = false, adobe = false, frame = false, scanned = false;
  int adobe_transform = -1;
  W = H = 0;
  size_t pos = 2;
  auto need = [&](size_t p, size_t k) {
    if (p + k > n) fail(BROKEN, "image file is truncated");
  };
  for (;;) {
    // the next marker (libjpeg skips garbage before it with a warning)
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) {
      if (scanned) break;  // no EOI after a whole scan
      fail(BROKEN, "image file is truncated");
    }
    const int m = d[pos++];
    if (m == 0xD9) break;                            // EOI
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    need(pos, 2);
    const int len = u16(d + pos);
    if (len < 2) fail(BROKEN, "corrupt JPEG marker length");
    need(pos, len);
    const uint8_t* s = d + pos + 2;
    const int sl = len - 2;
    if (m == 0xC0 || m == 0xC1) {  // baseline / extended sequential, Huffman
      if (frame) fail(BROKEN, "duplicate JPEG frame header");
      if (sl < 6) fail(BROKEN, "corrupt JPEG frame header");
      if (s[0] != 8) fail(UNSUPPORTED, "JPEG of " + std::to_string(s[0]) + "-bit samples");
      H = u16(s + 1);
      W = u16(s + 3);
      const int nc = s[5];
      if (W == 0 || H == 0) fail(BROKEN, "JPEG of empty size");
      if (nc == 4) fail(UNSUPPORTED, "CMYK/YCCK JPEG (4 components)");
      if (nc != 1 && nc != 3) fail(BROKEN, "JPEG of " + std::to_string(nc) + " components");
      if (sl < 6 + 3 * nc) fail(BROKEN, "corrupt JPEG frame header");
      for (int i = 0; i < nc; ++i) {
        Component c;
        c.id = s[6 + 3 * i];
        c.h = s[7 + 3 * i] >> 4;
        c.v = s[7 + 3 * i] & 15;
        c.tq = s[8 + 3 * i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
          fail(BROKEN, "bogus JPEG sampling factors or table");
        hmax = c.h > hmax ? c.h : hmax;
        vmax = c.v > vmax ? c.v : vmax;
        comps.push_back(c);
      }
      mcux = (W + 8 * hmax - 1) / (8 * hmax);
      mcuy = (H + 8 * vmax - 1) / (8 * vmax);
      for (auto& c : comps) {
        if (hmax % c.h || vmax % c.v) fail(UNSUPPORTED, "JPEG with fractional sampling ratios");
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
        c.dw = (int)(((long)W * c.h + hmax - 1) / hmax);
        c.dh = (int)(((long)H * c.v + vmax - 1) / vmax);
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      }
      frame = true;
    } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
      fail(UNSUPPORTED, "progressive JPEG");
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      fail(UNSUPPORTED, "lossless JPEG");
    } else if (m == 0xC5) {
      fail(UNSUPPORTED, "hierarchical JPEG");
    } else if (m == 0xC9) {
      fail(UNSUPPORTED, "arithmetic-coded JPEG");
    } else if (m == 0xCC) {
      fail(UNSUPPORTED, "arithmetic-coded JPEG");
    } else if (m == 0xC4) {  // DHT
      int p = 0;
      while (p < sl) {
        if (p + 17 > sl) fail(BROKEN, "corrupt JPEG Huffman table");
        const int tc = s[p] >> 4, th = s[p] & 15;
        int total = 0;
        for (int i = 0; i < 16; ++i) total += s[p + 1 + i];
        if (tc > 1 || th > 3 || total > 256 || p + 17 + total > sl)
          fail(BROKEN, "corrupt JPEG Huffman table");
        (tc ? ac : dc)[th].build(s + p + 1, s + p + 17, total);
        p += 17 + total;
      }
    } else if (m == 0xDB) {  // DQT
      int p = 0;
      while (p < sl) {
        const int pq = s[p] >> 4, tq = s[p] & 15;
        if (tq > 3 || pq > 1 || p + 1 + 64 * (pq + 1) > sl)
          fail(BROKEN, "corrupt JPEG quantization table");
        for (int i = 0; i < 64; ++i)
          qt[tq][kNatural[i]] = pq ? (uint16_t)u16(s + p + 1 + 2 * i) : s[p + 1 + i];
        qt_present[tq] = true;
        p += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xDD) {  // DRI
      if (sl < 2) fail(BROKEN, "corrupt JPEG restart interval");
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
      const int ns = s[0];
      if (ns < 1 || ns > 4 || sl < 1 + 2 * ns + 3) fail(BROKEN, "corrupt JPEG scan header");
      std::vector<Component*> sc;
      std::vector<int> td, ta;
      for (int i = 0; i < ns; ++i) {
        Component* c = nullptr;
        for (auto& k : comps)
          if (k.id == s[1 + 2 * i]) c = &k;
        if (!c) fail(BROKEN, "JPEG scan names an unknown component");
        td.push_back(s[2 + 2 * i] >> 4);
        ta.push_back(s[2 + 2 * i] & 15);
        if (td.back() > 3 || ta.back() > 3 || !dc[td.back()].present || !ac[ta.back()].present)
          fail(BROKEN, "JPEG scan uses an undefined Huffman table");
        if (!qt_present[c->tq]) fail(BROKEN, "JPEG component uses an undefined table");
        sc.push_back(c);
      }
      const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahl = s[3 + 2 * ns];
      if (ss != 0 || se != 63 || ahl != 0) fail(BROKEN, "corrupt JPEG scan parameters");
      BitReader br(d, n, pos + len);
      std::vector<int> pred(ns, 0);
      auto block = [&](int k, int bx, int by) {
        Component& c = *sc[k];
        int16_t* b = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
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
      long units;  // MCUs of the scan
      int ux;
      if (ns == 1) {
        Component& c = *sc[0];
        ux = (c.dw + 7) / 8;
        units = (long)ux * ((c.dh + 7) / 8);
      } else {
        ux = mcux;
        units = (long)mcux * mcuy;
      }
      int rst = 0;
      for (long u = 0; u < units; ++u) {
        if (restart_interval && u > 0 && u % restart_interval == 0) {
          br.restart(rst);
          rst = (rst + 1) & 7;
          for (auto& p : pred) p = 0;
        }
        const int mx = (int)(u % ux), my = (int)(u / ux);
        if (ns == 1) {
          block(0, mx, my);
        } else {
          for (int k = 0; k < ns; ++k)
            for (int yy = 0; yy < sc[k]->v; ++yy)
              for (int xx = 0; xx < sc[k]->h; ++xx)
                block(k, mx * sc[k]->h + xx, my * sc[k]->v + yy);
        }
      }
      pos = br.end();
      scanned = true;
      continue;
    } else if (m >= 0xC0 && m <= 0xCF) {
      fail(UNSUPPORTED, "JPEG process " + std::to_string(m - 0xC0));
    }
    pos += len;
  }
  if (!frame || !scanned) fail(BROKEN, "JPEG without image data");

  for (auto& c : comps) {
    const int stride = c.bw * 8;
    c.plane.assign((size_t)stride * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, qt[c.tq],
                   c.plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
    std::vector<int16_t>().swap(c.coef);
  }
  out.assign((size_t)W * H, 0);
  if (comps.size() == 1) {
    std::vector<uint8_t> full;
    upsample(comps[0], hmax, vmax, W, H, full);
    out.swap(full);
    return;
  }
  std::vector<uint8_t> p0, p1, p2;
  upsample(comps[0], hmax, vmax, W, H, p0);
  upsample(comps[1], hmax, vmax, W, H, p1);
  upsample(comps[2], hmax, vmax, W, H, p2);
  bool ycc;
  if (jfif) {
    ycc = true;
  } else if (adobe) {
    ycc = adobe_transform != 0;
  } else {
    ycc = !(comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66);
  }
  const size_t np = (size_t)W * H;
  if (!ycc) {
    for (size_t i = 0; i < np; ++i) out[i] = L24(p0[i], p1[i], p2[i]);
    return;
  }
  // jdcolor.c's tables, SCALEBITS 16
  static int cr_r[256], cb_b[256];
  static long cr_g[256], cb_g[256];
  static bool tables = false;
  if (!tables) {
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((91881L * x + 32768) >> 16);
      cb_b[i] = (int)((116130L * x + 32768) >> 16);
      cr_g[i] = -46802L * x;
      cb_g[i] = -22554L * x + 32768;
    }
    tables = true;
  }
  auto clamp = [](int v) { return v < 0 ? 0 : v > 255 ? 255 : v; };
  for (size_t i = 0; i < np; ++i) {
    const int y = p0[i], cb = p1[i], cr = p2[i];
    const int r = clamp(y + cr_r[cr]);
    const int g = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
    const int b = clamp(y + cb_b[cb]);
    out[i] = L24(r, g, b);
  }
}

// ---------------------------------------------------------------- BMP, PNM

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
inline int le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

void decode_bmp(const uint8_t* d, size_t n, std::vector<uint8_t>& out, int& W, int& H) {
  if (n < 26) fail(BROKEN, "image file is truncated");
  const uint32_t offset = le32(d + 10), hsize = le32(d + 14);
  int bpp, compression = 0, pal_entry;
  long width, height;
  uint32_t colors = 0;
  if (hsize == 12) {
    width = le16(d + 18);
    height = (int16_t)le16(d + 20);
    bpp = le16(d + 24);
    pal_entry = 3;
  } else if (hsize >= 40 && hsize <= 124) {
    if (n < 14 + 40) fail(BROKEN, "image file is truncated");
    width = (int32_t)le32(d + 18);
    height = (int32_t)le32(d + 22);
    bpp = le16(d + 28);
    compression = (int)le32(d + 30);
    colors = le32(d + 46);
    pal_entry = 4;
  } else {
    fail(UNSUPPORTED, "BMP with a " + std::to_string(hsize) + "-byte header");
  }
  if (compression != 0) fail(UNSUPPORTED, "compressed BMP");
  if (bpp != 8 && bpp != 24) fail(UNSUPPORTED, "BMP of " + std::to_string(bpp) + " bits a pixel");
  const bool top_down = height < 0;
  if (top_down) height = -height;
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
    fail(BROKEN, "BMP of a bad size");
  W = (int)width;
  H = (int)height;
  uint8_t lut[256];
  std::memset(lut, 0, sizeof(lut));
  if (bpp == 8) {
    if (colors == 0 || colors > 256) colors = 256;
    const size_t pal = 14 + hsize;
    if (pal + (size_t)colors * pal_entry > n) fail(BROKEN, "image file is truncated");
    for (uint32_t i = 0; i < colors; ++i) {
      const uint8_t* e = d + pal + (size_t)i * pal_entry;
      lut[i] = L24(e[2], e[1], e[0]);
    }
  }
  const size_t stride = (((size_t)W * bpp + 31) / 32) * 4;
  if ((size_t)offset + stride * (H - 1) + ((size_t)W * bpp + 7) / 8 > n)
    fail(BROKEN, "image file is truncated");
  out.assign((size_t)W * H, 0);
  for (int y = 0; y < H; ++y) {
    const uint8_t* r = d + offset + stride * (size_t)(top_down ? y : H - 1 - y);
    uint8_t* o = out.data() + (size_t)y * W;
    if (bpp == 8) {
      for (int x = 0; x < W; ++x) o[x] = lut[r[x]];
    } else {
      for (int x = 0; x < W; ++x) o[x] = L24(r[3 * x + 2], r[3 * x + 1], r[3 * x]);
    }
  }
}

void decode_pnm(const uint8_t* d, size_t n, std::vector<uint8_t>& out, int& W, int& H) {
  const char kind = (char)d[1];
  if (kind != '5' && kind != '6')
    fail(UNSUPPORTED, std::string("PNM of type P") + kind + " (only binary P5/P6 are decoded)");
  size_t p = 2;
  long vals[3];
  for (int k = 0; k < 3; ++k) {
    for (;;) {  // whitespace and comments
      if (p >= n) fail(BROKEN, "image file is truncated");
      if (d[p] == '#') {
        while (p < n && d[p] != '\n' && d[p] != '\r') ++p;
      } else if (d[p] == ' ' || d[p] == '\t' || d[p] == '\n' || d[p] == '\r' || d[p] == '\v' ||
                 d[p] == '\f') {
        ++p;
      } else {
        break;
      }
    }
    if (d[p] < '0' || d[p] > '9') fail(BROKEN, "corrupt PNM header");
    long v = 0;
    while (p < n && d[p] >= '0' && d[p] <= '9') {
      v = v * 10 + (d[p++] - '0');
      if (v > 1000000) fail(BROKEN, "corrupt PNM header");
    }
    vals[k] = v;
  }
  ++p;  // the one whitespace byte before the samples
  if (vals[0] <= 0 || vals[1] <= 0) fail(BROKEN, "PNM of a bad size");
  if (vals[2] != 255)
    fail(UNSUPPORTED, "PNM of maxval " + std::to_string(vals[2]) + " (only 255 is decoded)");
  W = (int)vals[0];
  H = (int)vals[1];
  const size_t ch = kind == '6' ? 3 : 1;
  if (p + (size_t)W * H * ch > n) fail(BROKEN, "image file is truncated");
  out.assign((size_t)W * H, 0);
  const uint8_t* s = d + p;
  if (ch == 1) {
    std::memcpy(out.data(), s, (size_t)W * H);
  } else {
    for (size_t i = 0; i < (size_t)W * H; ++i) out[i] = L24(s[3 * i], s[3 * i + 1], s[3 * i + 2]);
  }
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
// (free it with image_free); returns OK, BROKEN or UNSUPPORTED, with the
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

void image_free(uint8_t* p) { std::free(p); }

// Unfilter an inflated PNG image (non-interlaced, bit depth 1/2/4/8) and
// convert it to L as PIL's convert("L") does: grey of depth 1 -> 0/255,
// 2 -> x85, 4 -> x17; RGB(A) -> L24; palette -> L24 of the entry; grey +
// alpha -> grey.  `palette` holds n_palette RGB triples.
int png_to_gray(const uint8_t* raw, size_t n, int w, int h, int color_type, int depth,
                const uint8_t* palette, int n_palette, uint8_t* out, char* msg, int msg_len) {
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
    const size_t row_bytes = ((size_t)w * channels * depth + 7) / 8;
    const int bpp = (channels * depth + 7) / 8;
    if (n < (row_bytes + 1) * h) fail(BROKEN, "image file is truncated");
    std::vector<uint8_t> prev(row_bytes, 0), cur(row_bytes);
    uint8_t lut[256];
    for (int i = 0; i < 256; ++i)
      lut[i] = i < n_palette ? L24(palette[3 * i], palette[3 * i + 1], palette[3 * i + 2]) : 0;
    for (int y = 0; y < h; ++y) {
      const uint8_t* src = raw + (row_bytes + 1) * y;
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
      uint8_t* o = out + (size_t)y * w;
      if (depth == 8) {
        for (int x = 0; x < w; ++x) {
          const uint8_t* p = cur.data() + (size_t)x * channels;
          switch (color_type) {
            case 0: case 4: o[x] = p[0]; break;
            case 2: case 6: o[x] = L24(p[0], p[1], p[2]); break;
            case 3: o[x] = lut[p[0]]; break;
          }
        }
      } else {
        const int per = 8 / depth, mask = (1 << depth) - 1;
        const int scale = depth == 1 ? 255 : depth == 2 ? 85 : 17;
        for (int x = 0; x < w; ++x) {
          const int v = (cur[x / per] >> (8 - depth * (x % per + 1))) & mask;
          o[x] = color_type == 3 ? lut[v] : (uint8_t)(v * scale);
        }
      }
      prev.swap(cur);
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
