// WebP decoding of the image loaders' files (data/images.py), bit for bit
// as PIL gives them: Image.open(...).convert("L") (or "RGB") of a WebP.
//
// PIL (Pillow 12) reads every WebP, still or animated, through libwebp's
// WebPAnimDecoder: it demuxes the RIFF container, allocates a canvas of the
// VP8X canvas size (the frame's size for a simple file) filled with
// transparent black, and decodes frame 0 into it at the frame's offset, as
// non-premultiplied RGBA, without blending.  PIL's RGB->L is then L24.  This
// file follows libwebp (1.6) step by step:
//
//   * the container: WebPGetFeatures of the whole file, then the demuxer's
//     parse (RIFF size against the data, VP8X flags and canvas, ICCP / EXIF /
//     XMP / unknown chunks skipped, ANIM and the ANMF frames with their own
//     ALPH / VP8 / VP8L chunks) and its validity checks;
//   * VP8L, the lossless coding: the four transforms (predictor with its 14
//     modes, cross-colour, subtract-green, colour indexing with pixel
//     bundling), simple and normal prefix codes in libwebp's two-level
//     tables, meta prefix codes, LZ77 with the 120-entry distance map and
//     the colour cache; libwebp's bit reader is mirrored exactly, so a
//     stream that ends early fails where libwebp's does;
//   * VP8, the lossy key frame (RFC 6386): frame header, segments, the loop
//     filter header, 1/2/4/8 token partitions, the dequantisation tables and
//     clamps, coefficient probabilities and their updates, skip, the intra
//     modes, inverse WHT and DCT, prediction with the 127/129 edges, the
//     simple and normal loop filters; then libwebp's "fancy" upsampling of
//     the 4:2:0 chroma and its 14-bit fixed-point YUV->RGB;
//   * ALPH: decoded (raw or VP8L-compressed) only to fail where libwebp
//     fails; L does not read alpha.
//
// Errors come back as a code and a message, as in imgdecode.cpp: 1 where PIL
// raises OSError (PIL's "could not create decoder object" at open, "failed
// to read next frame" at load), 4 for a canvas of more than twice PIL's
// MAX_IMAGE_PIXELS (its DecompressionBombError).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { OK = 0, BROKEN = 1, BOMB = 4 };

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Failure{code, msg}; }

// PIL's Image.MAX_IMAGE_PIXELS
const long kMaxImagePixels = 1024L * 1024 * 1024 / 4 / 3;

inline uint8_t L24(int r, int g, int b) {
  return (uint8_t)((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
}

inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }
inline bool is_tag(const uint8_t* p, const char* t) { return std::memcmp(p, t, 4) == 0; }

const uint32_t kMaxChunkPayload = ~0U - 8 - 1;
const uint64_t kMaxImageArea = 1ULL << 32;

// A decoded frame: RGB, 3 bytes a pixel.
struct Rgb {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
};

// ---------------------------------------------------------------- VP8L

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };
const int kLiteralCodes = 256, kLengthCodes = 24;
const int kTableBits = 8;         // root bits of the prefix code tables
const int kLengthsTableBits = 7;  // of the code-length code
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7,  8,  9, 10, 11, 12, 13, 14, 15};
// the distance map: (yoffset << 4) | (8 - xoffset) of the 120 short codes
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

// libwebp's VP8LBitReader: a 64-bit window over the bytes, read LSB first;
// past the data it reads zeros until more than max(len, 8) bytes' worth of
// bits are consumed, which is its end of stream (a read then flags it and
// moves bit_pos to 0).  The 4-byte fast load of x86-64 is kept because it
// decides where the window is refilled, which shows in what a stream that
// runs out reads.
struct LBits {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  bool eos = false;

  void init(const uint8_t* b, size_t n) {
    buf = b;
    len = n;
    val = 0;
    bit_pos = 0;
    eos = false;
    size_t k = n < 8 ? n : 8;
    for (size_t i = 0; i < k; ++i) val |= (uint64_t)b[i] << (8 * i);
    pos = k;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= (uint64_t)buf[pos] << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  void fill() {
    if (bit_pos >= 32) {
      if (pos + 8 < len) {
        val >>= 32;
        bit_pos -= 32;
        val |= (uint64_t)le32(buf + pos) << 32;
        pos += 4;
      } else {
        shift_bytes();
      }
    }
  }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < 15) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: canonical codes with the bits reversed, a
// root table of root_bits and second-level tables behind it.  With a null
// table it only checks the lengths (at most 15, not all zero, a complete
// code unless there is one symbol) and returns the size; 0 is a bad code.
int build_table(HCode* root_table, int root_bits, const int* lengths, int n, uint16_t* sorted) {
  HCode* table = root_table;
  int total_size = 1 << root_bits;
  int count[16] = {0}, offset[16];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 15) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < 15; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  for (int s = 0; s < n; ++s) {
    int l = lengths[s];
    if (l > 0) {
      if (sorted)
        sorted[offset[l]++] = (uint16_t)s;
      else
        offset[l]++;
    }
  }
  if (offset[15] == 1) {  // one symbol: it takes no bits
    if (sorted) replicate(table, 1, total_size, HCode{0, sorted[0]});
    return total_size;
  }
  int step, len, symbol = 0;
  uint32_t low = 0xffffffffu, mask = total_size - 1, key = 0;
  int num_nodes = 1, num_open = 1, table_bits = root_bits, table_size = 1 << table_bits;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (!root_table) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, HCode{(uint8_t)len, sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= 15; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root_table) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root_table) {
          root_table[low].bits = (uint8_t)(table_bits + root_bits);
          root_table[low].value = (uint16_t)((table - root_table) - low);
        }
      }
      if (root_table)
        replicate(&table[key >> root_bits], step, table_size,
                  HCode{(uint8_t)(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[15] - 1) return 0;
  return total_size;
}

// The checked table appended to `store`; returns its offset there, or -1.
long append_table(std::vector<HCode>& store, int root_bits, const int* lengths, int n) {
  int size = build_table(nullptr, root_bits, lengths, n, nullptr);
  if (!size) return -1;
  // the largest two-level table: a full root and 2^7-entry tables behind
  // each of its entries
  std::vector<HCode> tmp(((size_t)1 << root_bits) * (1 + (1 << (15 - root_bits))));
  std::vector<uint16_t> sorted(n);
  size = build_table(tmp.data(), root_bits, lengths, n, sorted.data());
  long at = (long)store.size();
  store.insert(store.end(), tmp.begin(), tmp.begin() + size);
  return at;
}

int read_symbol(const HCode* table, LBits& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kTableBits) - 1);
  int nbits = table->bits - kTableBits;
  if (nbits > 0) {
    br.bit_pos += kTableBits;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

struct HTreeGroup {
  long htrees[5];
  bool is_trivial_literal = false, is_trivial_code = false;
  uint32_t literal_arb = 0;
};

// The prefix codes of one image of the stream (the main image or one of
// its sub-images: a transform's data, the entropy image, a colour map).
struct Meta {
  int cache_bits = 0;
  int sub_bits = 0, hxsize = 0, mask = ~0;
  std::vector<uint32_t> himage;  // the group of each tile
  std::vector<HTreeGroup> groups;
  std::vector<HCode> tables;

  const HTreeGroup& group(int x, int y) const {
    if (sub_bits == 0) return groups[0];
    return groups[himage[(size_t)hxsize * (y >> sub_bits) + (x >> sub_bits)]];
  }
  const HCode* tree(const HTreeGroup& g, int j) const { return tables.data() + g.htrees[j]; }
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct LDec {
  LBits br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  Meta hdr;            // the main image's codes
  int width = 0, height = 0;  // the main image's coded size (after bundling)
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

bool decode_stream(LDec& d, int xsize, int ysize, bool level0, std::vector<uint32_t>* out);

// ReadHuffmanCodeLengths
bool read_code_lengths(LDec& d, const int* cl_lengths, int num_symbols, int* lengths) {
  LBits& br = d.br;
  std::vector<HCode> table(1 << kLengthsTableBits);
  std::vector<uint16_t> sorted(19);
  if (!build_table(nullptr, kLengthsTableBits, cl_lengths, 19, nullptr)) return false;
  build_table(table.data(), kLengthsTableBits, cl_lengths, 19, sorted.data());
  int max_symbol;
  if (br.read(1)) {
    int length_nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(length_nbits);
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0, prev = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HCode& p = table[br.prefetch() & ((1u << kLengthsTableBits) - 1)];
    br.bit_pos += p.bits;
    int code_len = p.value;
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev = code_len;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      int slot = code_len - 16;
      int repeat = (int)br.read(kExtra[slot]) + kOffset[slot];
      if (symbol + repeat > num_symbols) return false;
      int length = code_len == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = length;
    }
  }
  return true;
}

// ReadHuffmanCode: a simple or a normal code of `alphabet` symbols, its
// table appended to m->tables (offset in *at), or only checked (m null).
bool read_code(LDec& d, int alphabet, Meta* m, long* at) {
  LBits& br = d.br;
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  bool ok;
  if (br.read(1)) {  // simple
    int num_symbols = (int)br.read(1) + 1;
    int first_len = (int)br.read(1);
    int symbol = (int)br.read(first_len == 0 ? 1 : 8);
    lengths[symbol] = 1;
    if (num_symbols == 2) lengths[br.read(8)] = 1;
    ok = true;
  } else {
    int cl[19] = {0};
    int num_codes = (int)br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthCodeOrder[i]] = (int)br.read(3);
    ok = read_code_lengths(d, cl, alphabet, lengths.data());
  }
  ok = ok && !br.eos;
  if (!ok) return false;
  if (!m) return build_table(nullptr, kTableBits, lengths.data(), alphabet, nullptr) != 0;
  *at = append_table(m->tables, kTableBits, lengths.data(), alphabet);
  return *at >= 0;
}

// ReadHuffmanCodes: the entropy image (main image only) and the groups of
// five codes; codes of groups no tile uses are read and checked only.
bool read_codes(LDec& d, Meta& m, int xsize, int ysize, int cache_bits, bool allow_recursion) {
  LBits& br = d.br;
  int num_groups = 1;
  std::vector<int> mapping;  // group index -> stored group, -1 unused
  if (allow_recursion && br.read(1)) {
    int bits = 2 + (int)br.read(3);
    int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
    std::vector<uint32_t> img;
    if (!decode_stream(d, hx, hy, false, &img)) return false;
    m.sub_bits = bits;
    for (auto& v : img) {
      v = (v >> 8) & 0xffff;
      num_groups = std::max(num_groups, (int)v + 1);
    }
    mapping.assign(num_groups, -1);
    int used = 0;
    for (auto& v : img) {
      if (mapping[v] < 0) mapping[v] = used++;
      v = mapping[v];
    }
    m.himage = std::move(img);
  } else {
    mapping.assign(1, 0);
  }
  if (br.eos) return false;
  int stored = 0;
  for (int v : mapping) stored += v >= 0;
  m.groups.assign(stored, HTreeGroup{});
  for (int i = 0; i < num_groups; ++i) {
    bool keep = mapping[i] >= 0;
    HTreeGroup g;
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabetSize[j] + (j == 0 && cache_bits > 0 ? 1 << cache_bits : 0);
      if (!read_code(d, alphabet, keep ? &m : nullptr, &g.htrees[j])) return false;
    }
    if (!keep) continue;
    const HCode* t[5];
    for (int j = 0; j < 5; ++j) t[j] = m.tables.data() + g.htrees[j];
    g.is_trivial_literal = t[RED][0].bits == 0 && t[BLUE][0].bits == 0 && t[ALPHA][0].bits == 0;
    int total_bits = 0;
    for (int j = 0; j < 5; ++j) total_bits += t[j][0].bits;
    if (g.is_trivial_literal) {
      g.literal_arb = ((uint32_t)t[ALPHA][0].value << 24) | (t[RED][0].value << 16) |
                      t[BLUE][0].value;
      if (total_bits == 0 && t[GREEN][0].value < kLiteralCodes) {
        g.is_trivial_code = true;
        g.literal_arb |= t[GREEN][0].value << 8;
      }
    }
    m.groups[mapping[i]] = g;
  }
  return true;
}

bool read_transform(LDec& d, int& xsize, int ysize) {
  LBits& br = d.br;
  int type = (int)br.read(2);
  if (d.seen & (1u << type)) return false;
  d.seen |= 1u << type;
  Transform t;
  t.type = type;
  t.xsize = xsize;
  t.ysize = ysize;
  bool ok = true;
  if (type == PREDICTOR || type == CROSS_COLOR) {
    t.bits = (int)br.read(3) + 2;
    ok = decode_stream(d, subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), false, &t.data);
  } else if (type == COLOR_INDEXING) {
    int num_colors = (int)br.read(8) + 1;
    int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
    xsize = subsample(t.xsize, bits);
    t.bits = bits;
    std::vector<uint32_t> colors;
    ok = decode_stream(d, num_colors, 1, false, &colors);
    if (ok) {  // ExpandColorMap: deltas summed bytewise; past the colours, 0
      int final_colors = 1 << (8 >> bits);
      t.data.assign(final_colors, 0);
      uint8_t* out = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* in = reinterpret_cast<const uint8_t*>(colors.data());
      for (int i = 0; i < 4; ++i) out[i] = in[i];
      for (int i = 4; i < 4 * num_colors; ++i) out[i] = (uint8_t)(in[i] + out[i - 4]);
    }
  }
  d.transforms.push_back(std::move(t));
  return ok;
}

inline int copy_length(int symbol, LBits& br) {  // GetCopyDistance (lengths alike)
  if (symbol < 4) return symbol + 1;
  int extra = (symbol - 2) >> 1;
  int offset = (2 + (symbol & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

inline int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  int dist_code = kCodeToPlane[code - 1];
  int yoffset = dist_code >> 4, xoffset = 8 - (dist_code & 0xf);
  int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

// DecodeImageData (the ARGB path), whole image, not incremental: any read
// past the end of the stream is an error.
bool decode_pixels(LDec& d, const Meta& m, uint32_t* data, int width, int height) {
  LBits& br = d.br;
  int row = 0, col = 0;
  uint32_t* src = data;
  uint32_t* last_cached = src;
  uint32_t* const src_end = data + (size_t)width * height;
  const int len_code_limit = kLiteralCodes + kLengthCodes;
  const int cache_size = m.cache_bits > 0 ? 1 << m.cache_bits : 0;
  const int cache_limit = len_code_limit + cache_size;
  std::vector<uint32_t> cache(cache_size);
  const int shift = 32 - m.cache_bits;
  auto insert = [&](uint32_t argb) { cache[(argb * 0x1e35a7bdu) >> shift] = argb; };
  const int mask = m.mask;
  const HTreeGroup* g = src < src_end ? &m.group(col, row) : nullptr;
  while (src < src_end) {
    int code;
    if ((col & mask) == 0) g = &m.group(col, row);
    if (g->is_trivial_code) {
      *src = g->literal_arb;
      goto advance;
    }
    br.fill();
    code = read_symbol(m.tree(*g, GREEN), br);
    if (br.at_end()) break;
    if (code < kLiteralCodes) {
      if (g->is_trivial_literal) {
        *src = g->literal_arb | (code << 8);
      } else {
        int red = read_symbol(m.tree(*g, RED), br);
        br.fill();
        int blue = read_symbol(m.tree(*g, BLUE), br);
        int alpha = read_symbol(m.tree(*g, ALPHA), br);
        if (br.at_end()) break;
        *src = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
      }
    advance:
      ++src;
      ++col;
      if (col >= width) {
        col = 0;
        ++row;
        if (cache_size)
          while (last_cached < src) insert(*last_cached++);
      }
    } else if (code < len_code_limit) {
      int length = copy_length(code - kLiteralCodes, br);
      int dist_symbol = read_symbol(m.tree(*g, DIST), br);
      br.fill();
      int dist = plane_distance(width, copy_length(dist_symbol, br));
      if (br.at_end()) break;
      if (src - data < (ptrdiff_t)dist || src_end - src < (ptrdiff_t)length) return false;
      for (int i = 0; i < length; ++i) src[i] = src[i - dist];
      src += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (col & mask) g = &m.group(col, row);
      if (cache_size)
        while (last_cached < src) insert(*last_cached++);
    } else if (code < cache_limit) {
      int key = code - len_code_limit;
      while (last_cached < src) insert(*last_cached++);
      *src = cache[key];
      goto advance;
    } else {
      return false;
    }
  }
  br.eos = br.at_end();
  return !br.eos;
}

// DecodeAlphaData: the 8-bit path libwebp takes for an alpha plane coded with
// the colour-indexing transform alone, no colour cache and one-symbol red,
// blue and alpha codes.  Unlike the ARGB path it accepts a stream whose end
// is reached by the symbol that completes the plane.
bool decode_alpha_indices(LDec& d, const Meta& m, int width, int height) {
  LBits& br = d.br;
  int row = 0, col = 0, pos = 0;
  const int end = width * height;
  std::vector<uint8_t> data(end);
  const int mask = m.mask;
  const HTreeGroup* g = pos < end ? &m.group(col, row) : nullptr;
  bool ok = true;
  while (!br.eos && pos < end) {
    if ((col & mask) == 0) g = &m.group(col, row);
    br.fill();
    int code = read_symbol(m.tree(*g, GREEN), br);
    if (code < kLiteralCodes) {
      data[pos] = (uint8_t)code;
      ++pos;
      ++col;
      if (col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < kLiteralCodes + kLengthCodes) {
      int length = copy_length(code - kLiteralCodes, br);
      int dist_symbol = read_symbol(m.tree(*g, DIST), br);
      br.fill();
      int dist = plane_distance(width, copy_length(dist_symbol, br));
      if (pos >= dist && end - pos >= length) {
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      } else {
        ok = false;
        break;
      }
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (pos < end && (col & mask)) g = &m.group(col, row);
    } else {
      ok = false;
      break;
    }
    br.eos = br.at_end();
  }
  br.eos = br.at_end();
  return ok && !(br.eos && pos < end);
}

// DecodeImageStream: transforms (main image), colour cache, codes, and for
// a sub-image its pixels.
bool decode_stream(LDec& d, int xsize, int ysize, bool level0, std::vector<uint32_t>* out) {
  LBits& br = d.br;
  int tx = xsize, ty = ysize;
  if (level0)
    while (br.read(1))
      if (!read_transform(d, tx, ty)) return false;
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  Meta m;
  if (!read_codes(d, m, tx, ty, cache_bits, level0)) return false;
  m.cache_bits = cache_bits;
  m.hxsize = subsample(tx, m.sub_bits);
  m.mask = m.sub_bits == 0 ? ~0 : (1 << m.sub_bits) - 1;
  if (level0) {
    d.hdr = std::move(m);
    d.width = tx;
    d.height = ty;
    return true;
  }
  out->assign((size_t)tx * ty, 0);
  return decode_pixels(d, m, out->data(), tx, ty) && !br.eos;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int add_sub_full(int a, int b, int c) { return (int)clip255((uint32_t)(a + b - c)); }
inline int add_sub_half(int a, int b) { return (int)clip255((uint32_t)(a + (a - b) / 2)); }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  uint32_t T = top[0], TL = top[-1], TR = top[1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {  // Select(T, L, TL)
      int d = 0;
      for (int s = 0; s < 32; s += 8)
        d += sub3((T >> s) & 0xff, (L >> s) & 0xff, (TL >> s) & 0xff);
      return d <= 0 ? T : L;
    }
    case 12: {
      uint32_t r = 0;
      for (int s = 0; s < 32; s += 8)
        r |= (uint32_t)add_sub_full((L >> s) & 0xff, (T >> s) & 0xff, (TL >> s) & 0xff) << s;
      return r;
    }
    case 13: {
      uint32_t ave = average2(L, T), r = 0;
      for (int s = 0; s < 32; s += 8)
        r |= (uint32_t)add_sub_half((ave >> s) & 0xff, (TL >> s) & 0xff) << s;
      return r;
    }
    default: return 0xff000000u;  // 0, and the unused 14 and 15
  }
}

// The inverse of transform t over the whole image: in -> out.
void inverse_transform(const Transform& t, int height, const std::vector<uint32_t>& in,
                       std::vector<uint32_t>& out) {
  const int width = t.xsize;
  out.assign((size_t)width * height, 0);
  if (t.type == SUBTRACT_GREEN) {
    for (size_t i = 0; i < out.size(); ++i) {
      uint32_t argb = in[i], green = (argb >> 8) & 0xff;
      uint32_t rb = ((argb & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
      out[i] = (argb & 0xff00ff00u) | rb;
    }
  } else if (t.type == PREDICTOR) {
    const int tiles_per_row = subsample(width, t.bits);
    for (int y = 0; y < height; ++y) {
      const uint32_t* src = in.data() + (size_t)y * width;
      uint32_t* dst = out.data() + (size_t)y * width;
      if (y == 0) {
        dst[0] = add_pixels(src[0], 0xff000000u);
        for (int x = 1; x < width; ++x) dst[x] = add_pixels(src[x], dst[x - 1]);
        continue;
      }
      const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
      dst[0] = add_pixels(src[0], dst[-width]);
      for (int x = 1; x < width; ++x) {
        int mode = (modes[x >> t.bits] >> 8) & 0xf;
        dst[x] = add_pixels(src[x], predict(mode, dst[x - 1], dst + x - width));
      }
    }
  } else if (t.type == CROSS_COLOR) {
    const int tiles_per_row = subsample(width, t.bits);
    for (int y = 0; y < height; ++y) {
      const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
      for (int x = 0; x < width; ++x) {
        uint32_t code = codes[x >> t.bits];
        int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
               r2b = (int8_t)((code >> 16) & 0xff);
        uint32_t argb = in[(size_t)y * width + x];
        int8_t green = (int8_t)(argb >> 8);
        int new_red = (argb >> 16) & 0xff, new_blue = argb & 0xff;
        new_red += ((int)g2r * green) >> 5;
        new_red &= 0xff;
        new_blue += ((int)g2b * green) >> 5;
        new_blue += ((int)r2b * (int8_t)new_red) >> 5;
        new_blue &= 0xff;
        out[(size_t)y * width + x] = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
      }
    }
  } else {  // COLOR_INDEXING
    const int in_width = subsample(width, t.bits);
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < height; ++y) {
      const uint32_t* src = in.data() + (size_t)y * in_width;
      uint32_t* dst = out.data() + (size_t)y * width;
      uint32_t packed = 0;
      for (int x = 0; x < width; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
  }
}

// ReadImageInfo: the 5-byte header, from the start of br.
bool read_vp8l_header(LBits& br, int* w, int* h) {
  if (br.read(8) != 0x2f) return false;
  *w = (int)br.read(14) + 1;
  *h = (int)br.read(14) + 1;
  br.read(1);  // alpha hint
  if (br.read(3) != 0) return false;
  return !br.eos;
}

// VP8LGetInfo
bool vp8l_info(const uint8_t* data, size_t size, int* w, int* h) {
  if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return false;
  LBits br;
  br.init(data, size);
  return read_vp8l_header(br, w, h);
}

// A VP8L bitstream (after its chunk header) decoded to RGB.
bool decode_vp8l(const uint8_t* data, size_t size, Rgb& out) {
  LDec d;
  d.br.init(data, size);
  int w, h;
  if (!read_vp8l_header(d.br, &w, &h) || !decode_stream(d, w, h, true, nullptr)) return false;
  std::vector<uint32_t> cur((size_t)d.width * d.height), next;
  if (!decode_pixels(d, d.hdr, cur.data(), d.width, d.height)) return false;
  for (int n = (int)d.transforms.size() - 1; n >= 0; --n) {
    inverse_transform(d.transforms[n], h, cur, next);
    cur.swap(next);
  }
  out.w = w;
  out.h = h;
  out.px.resize((size_t)w * h * 3);
  for (size_t i = 0; i < (size_t)w * h; ++i) {
    out.px[3 * i] = (cur[i] >> 16) & 0xff;
    out.px[3 * i + 1] = (cur[i] >> 8) & 0xff;
    out.px[3 * i + 2] = cur[i] & 0xff;
  }
  return true;
}

// An ALPH chunk's payload for a w x h frame: whether libwebp decodes it
// (ALPHInit and ALPHDecode; the plane itself is not kept).
bool alpha_ok(const uint8_t* data, size_t size, int w, int h) {
  if (size <= 1) return false;
  // compression (2 bits), filter (2 bits: any of the four), preprocessing
  // (2 bits), reserved (2 bits)
  const int method = data[0] & 3, pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved != 0) return false;
  if (method == 0) return size - 1 >= (size_t)w * h;
  LDec d;
  d.br.init(data + 1, size - 1);
  if (!decode_stream(d, w, h, true, nullptr)) return false;
  bool is8b = d.transforms.size() == 1 && d.transforms[0].type == COLOR_INDEXING &&
              d.hdr.cache_bits == 0;
  if (is8b)
    for (const HTreeGroup& g : d.hdr.groups)
      for (int j : {RED, BLUE, ALPHA})
        if (d.hdr.tree(g, j)[0].bits > 0) is8b = false;
  if (is8b) return decode_alpha_indices(d, d.hdr, d.width, d.height);
  std::vector<uint32_t> px((size_t)d.width * d.height);
  return decode_pixels(d, d.hdr, px.data(), d.width, d.height);
}

// ---------------------------------------------------------------- VP8

// RFC 6386's tables: default coefficient probabilities (13.5), their update
// probabilities (13.4), the key-frame 4x4 mode probabilities (11.5, indexed
// [above][left] in this file's mode order), DC and AC dequantisation (14.1).
const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
     {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
     {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{  1,  98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
     {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
     { 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
     {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
     { 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
     {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
     { 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
     {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
     {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
     {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
     { 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{  1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {246,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198,  35, 237, 223, 193, 187, 162, 160, 145, 155,  62},
     {131,  45, 198, 221, 172, 176, 220, 157, 252, 221,   1},
     { 68,  47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
     {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
     { 81,  99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
     { 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
     { 23,  91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
     {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
     { 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
     { 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
     { 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
     {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
     { 35,  77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
     {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
     { 45,  99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{  1,   1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
     {203,   1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {137,   1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253,   9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
     {175,  13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
     { 73,  17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{  1,  95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
     {239,  90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
     {155,  77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{  1,  24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
     {201,  51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
     { 69,  46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
     {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
     {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{  1,  16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {190,  36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
     {149,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
     {213,  62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
     { 55,  93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202,  24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
     {126,  38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
     { 61,  46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
     {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
     { 39,  77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{  1,  52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
     {124,  74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
     { 24,  71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
     {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
     { 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{  1,  81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
     {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
     { 20,  95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
     {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
     { 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
     {141,  84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
     { 42,  80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{  1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {244,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {238,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
     {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
     {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
     {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};

const uint8_t kBModesProba[10][10][9] = {
  {
    {231, 120,  48,  89, 115, 113, 120, 152, 112},
    {152, 179,  64, 126, 170, 118,  46,  70,  95},
    {175,  69, 143,  80,  85,  82,  72, 155, 103},
    { 56,  58,  10, 171, 218, 189,  17,  13, 152},
    {114,  26,  17, 163,  44, 195,  21,  10, 173},
    {121,  24,  80, 195,  26,  62,  44,  64,  85},
    {144,  71,  10,  38, 171, 213, 144,  34,  26},
    {170,  46,  55,  19, 136, 160,  33, 206,  71},
    { 63,  20,   8, 114, 114, 208,  12,   9, 226},
    { 81,  40,  11,  96, 182,  84,  29,  16,  36},
  },
  {
    {134, 183,  89, 137,  98, 101, 106, 165, 148},
    { 72, 187, 100, 130, 157, 111,  32,  75,  80},
    { 66, 102, 167,  99,  74,  62,  40, 234, 128},
    { 41,  53,   9, 178, 241, 141,  26,   8, 107},
    { 74,  43,  26, 146,  73, 166,  49,  23, 157},
    { 65,  38, 105, 160,  51,  52,  31, 115, 128},
    {104,  79,  12,  27, 217, 255,  87,  17,   7},
    { 87,  68,  71,  44, 114,  51,  15, 186,  23},
    { 47,  41,  14, 110, 182, 183,  21,  17, 194},
    { 66,  45,  25, 102, 197, 189,  23,  18,  22},
  },
  {
    { 88,  88, 147, 150,  42,  46,  45, 196, 205},
    { 43,  97, 183, 117,  85,  38,  35, 179,  61},
    { 39,  53, 200,  87,  26,  21,  43, 232, 171},
    { 56,  34,  51, 104, 114, 102,  29,  93,  77},
    { 39,  28,  85, 171,  58, 165,  90,  98,  64},
    { 34,  22, 116, 206,  23,  34,  43, 166,  73},
    {107,  54,  32,  26,  51,   1,  81,  43,  31},
    { 68,  25, 106,  22,  64, 171,  36, 225, 114},
    { 34,  19,  21, 102, 132, 188,  16,  76, 124},
    { 62,  18,  78,  95,  85,  57,  50,  48,  51},
  },
  {
    {193, 101,  35, 159, 215, 111,  89,  46, 111},
    { 60, 148,  31, 172, 219, 228,  21,  18, 111},
    {112, 113,  77,  85, 179, 255,  38, 120, 114},
    { 40,  42,   1, 196, 245, 209,  10,  25, 109},
    { 88,  43,  29, 140, 166, 213,  37,  43, 154},
    { 61,  63,  30, 155,  67,  45,  68,   1, 209},
    {100,  80,   8,  43, 154,   1,  51,  26,  71},
    {142,  78,  78,  16, 255, 128,  34, 197, 171},
    { 41,  40,   5, 102, 211, 183,   4,   1, 221},
    { 51,  50,  17, 168, 209, 192,  23,  25,  82},
  },
  {
    {138,  31,  36, 171,  27, 166,  38,  44, 229},
    { 67,  87,  58, 169,  82, 115,  26,  59, 179},
    { 63,  59,  90, 180,  59, 166,  93,  73, 154},
    { 40,  40,  21, 116, 143, 209,  34,  39, 175},
    { 47,  15,  16, 183,  34, 223,  49,  45, 183},
    { 46,  17,  33, 183,   6,  98,  15,  32, 183},
    { 57,  46,  22,  24, 128,   1,  54,  17,  37},
    { 65,  32,  73, 115,  28, 128,  23, 128, 205},
    { 40,   3,   9, 115,  51, 192,  18,   6, 223},
    { 87,  37,   9, 115,  59,  77,  64,  21,  47},
  },
  {
    {104,  55,  44, 218,   9,  54,  53, 130, 226},
    { 64,  90,  70, 205,  40,  41,  23,  26,  57},
    { 54,  57, 112, 184,   5,  41,  38, 166, 213},
    { 30,  34,  26, 133, 152, 116,  10,  32, 134},
    { 39,  19,  53, 221,  26, 114,  32,  73, 255},
    { 31,   9,  65, 234,   2,  15,   1, 118,  73},
    { 75,  32,  12,  51, 192, 255, 160,  43,  51},
    { 88,  31,  35,  67, 102,  85,  55, 186,  85},
    { 56,  21,  23, 111,  59, 205,  45,  37, 192},
    { 55,  38,  70, 124,  73, 102,   1,  34,  98},
  },
  {
    {125,  98,  42,  88, 104,  85, 117, 175,  82},
    { 95,  84,  53,  89, 128, 100, 113, 101,  45},
    { 75,  79, 123,  47,  51, 128,  81, 171,   1},
    { 57,  17,   5,  71, 102,  57,  53,  41,  49},
    { 38,  33,  13, 121,  57,  73,  26,   1,  85},
    { 41,  10,  67, 138,  77, 110,  90,  47, 114},
    {115,  21,   2,  10, 102, 255, 166,  23,   6},
    {101,  29,  16,  10,  85, 128, 101, 196,  26},
    { 57,  18,  10, 102, 102, 213,  34,  20,  43},
    {117,  20,  15,  36, 163, 128,  68,   1,  26},
  },
  {
    {102,  61,  71,  37,  34,  53,  31, 243, 192},
    { 69,  60,  71,  38,  73, 119,  28, 222,  37},
    { 68,  45, 128,  34,   1,  47,  11, 245, 171},
    { 62,  17,  19,  70, 146,  85,  55,  62,  70},
    { 37,  43,  37, 154, 100, 163,  85, 160,   1},
    { 63,   9,  92, 136,  28,  64,  32, 201,  85},
    { 75,  15,   9,   9,  64, 255, 184, 119,  16},
    { 86,   6,  28,   5,  64, 255,  25, 248,   1},
    { 56,   8,  17, 132, 137, 255,  55, 116, 128},
    { 58,  15,  20,  82, 135,  57,  26, 121,  40},
  },
  {
    {164,  50,  31, 137, 154, 133,  25,  35, 218},
    { 51, 103,  44, 131, 131, 123,  31,   6, 158},
    { 86,  40,  64, 135, 148, 224,  45, 183, 128},
    { 22,  26,  17, 131, 240, 154,  14,   1, 209},
    { 45,  16,  21,  91,  64, 222,   7,   1, 197},
    { 56,  21,  39, 155,  60, 138,  23, 102, 213},
    { 83,  12,  13,  54, 192, 255,  68,  47,  28},
    { 85,  26,  85,  85, 128, 128,  32, 146, 171},
    { 18,  11,   7,  63, 144, 171,   4,   4, 246},
    { 35,  27,  10, 146, 174, 171,  12,  26, 128},
  },
  {
    {190,  80,  35,  99, 180,  80, 126,  54,  45},
    { 85, 126,  47,  87, 176,  51,  41,  20,  32},
    {101,  75, 128, 139, 118, 146, 116, 128,  85},
    { 56,  41,  15, 176, 236,  85,  37,   9,  62},
    { 71,  30,  17, 119, 118, 255,  17,  18, 138},
    {101,  38,  60, 138,  55,  70,  43,  26, 142},
    {146,  36,  19,  30, 171, 255,  97,  27,  20},
    {138,  45,  61,  62, 219,   1,  81, 188,  64},
    { 32,  41,  20, 117, 151, 142,  20,  21, 163},
    {112,  19,  12,  61, 195, 128,  48,   4,  24},
  },
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// 4x4 modes in libwebp's order; the 16x16 and chroma modes share the first
// four (DC, TM, V = VE, H = HE)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

// The boolean decoder (RFC 6386 7.3) with libwebp's end of data: past the
// partition it shifts in one byte of zeros and flags eof, which fails the
// row or macroblock being read.
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // range - 1
  bool eof = false;

  void init(const uint8_t* b, size_t n) {
    buf = b;
    end = b + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= get(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    int v = value_bits(n);
    return get(0x80) ? -v : v;
  }
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4 = 0, uvmode = 0, segment = 0, skip = 0;
  // NzCodeBits of each block (16 luma, 4 U, 4 V): 0 nothing to add, 1 the
  // DC alone, 2 at most the first three coefficients in zigzag order, 3
  // more; libwebp picks its inverse transform by it
  uint8_t codes[24];
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

const int BPS = 32;  // stride of the prediction work area

// TransformOne_C (and TransformDC_C and TransformAC3_C, which it equals
// on the coefficients they read): the inverse DCT of 16 coefficients in
// int arithmetic, added to dst.
void add_idct(const int16_t* in, uint8_t* dst) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

// Transform_SSE2, which libwebp runs for a block of more than three
// coefficients on x86-64: TransformOne with every sum kept in 16 bits
// (wrapping), the products by 20091 / 65536 and 35468 / 65536 taken as
// _mm_mulhi_epi16 of the 16-bit value, and the sum with the prediction
// saturated to 8 bits.  It equals TransformOne until a coefficient is
// large enough to wrap, as damaged data can make it.
void add_idct_16bit(const int16_t* in, uint8_t* dst) {
  auto w16 = [](int v) { return (int)(int16_t)v; };
  auto mh = [](int x, int k) { return (x * k) >> 16; };  // x a 16-bit value
  int C[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass, a column a lane
    const int in0 = in[i], in1 = in[4 + i], in2 = in[8 + i], in3 = in[12 + i];
    const int a = in0 + in2, b = in0 - in2;
    const int c = (in1 - in3) + (mh(in1, -30068) - mh(in3, 20091));
    const int d = (in1 + in3) + (mh(in1, 20091) + mh(in3, -30068));
    C[4 * i + 0] = w16(a + d);
    C[4 * i + 1] = w16(b + c);
    C[4 * i + 2] = w16(b - c);
    C[4 * i + 3] = w16(a - d);
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass, an output row a lane
    const int T0 = C[i], T1 = C[4 + i], T2 = C[8 + i], T3 = C[12 + i];
    const int dc = T0 + 4;
    const int a = dc + T2, b = dc - T2;
    const int c = (T1 - T3) + (mh(T1, -30068) - mh(T3, 20091));
    const int d = (T1 + T3) + (mh(T1, 20091) + mh(T3, -30068));
    const int out[4] = {w16(a + d) >> 3, w16(b + c) >> 3, w16(b - c) >> 3, w16(a - d) >> 3};
    for (int x = 0; x < 4; ++x) dst[x + i * BPS] = clip8(dst[x + i * BPS] + out[x]);
  }
}

// DoTransform: the transform libwebp runs for a block's code
inline void add_block(int code, const int16_t* in, uint8_t* dst) {
  if (code == 3)
    add_idct_16bit(in, dst);
  else if (code)
    add_idct(in, dst);
}

// DoUVTransform: 4 chroma blocks; if one has more than its DC, all four
// take Transform_SSE2, else each non-zero DC TransformDC_C
void add_uv_blocks(const uint8_t* codes, const int16_t* in, uint8_t* dst) {
  bool any = false, ac = false;
  for (int n = 0; n < 4; ++n) {
    any = any || codes[n];
    ac = ac || codes[n] >= 2;
  }
  if (!any) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* const d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (ac)
      add_idct_16bit(in + n * 16, d);
    else if (in[n * 16])
      add_idct(in + n * 16, d);
  }
}

// TransformWHT: the inverse Walsh-Hadamard transform of the Y2 block into
// the DC of the 16 luma blocks.
void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
    dst += BPS;
  }
}

void fill_block(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// 16x16 luma or 8x8 chroma prediction; DC at the frame's top or left edge
// averages what there is, 0x80 at the top-left macroblock.
void predict_block(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = 0;
      if (mb_x > 0 && mb_y > 0) {
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        dc = (dc + size) >> (shift + 1);
      } else if (mb_y > 0) {
        for (int j = 0; j < size; ++j) dc += dst[j - BPS];
        dc = (dc + (size >> 1)) >> shift;
      } else if (mb_x > 0) {
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        dc = (dc + (size >> 1)) >> shift;
      } else {
        dc = 0x80;
      }
      fill_block(dst, size, dc);
      break;
    }
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    default:  // B_HE
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y)*BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill_block(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(X, I, J);
      DST(1, 2) = DST(3, 3) = avg3(I, J, K);
      DST(1, 3) = avg3(J, K, L);
      break;
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

#undef DST

// ---- loop filter (RFC 6386 15; libwebp's dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter across one edge of 16 pixels (hstride: across the
// edge, vstride: along it)
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) filter2(p, hstride);
}

// the normal filter across one edge: 6 taps at macroblock edges, 4 inside
void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      filter2(p, hstride);
    else if (mb_edge)
      filter6(p, hstride);
    else
      filter4(p, hstride);
  }
}

struct Frame8 {
  int mb_w = 0, mb_h = 0, ys = 0, uvs = 0;
  std::vector<uint8_t> y, u, v;
};

// DoFilter: left edge, inner vertical edges, top edge, inner horizontal
// edges, macroblock by macroblock in raster order.
void filter_frame(Frame8& f, const std::vector<FInfo>& info, int filter_type) {
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      const FInfo& fi = info[(size_t)mb_y * f.mb_w + mb_x];
      const int limit = fi.limit;
      if (limit == 0) continue;
      uint8_t* yd = f.y.data() + (size_t)mb_y * 16 * f.ys + mb_x * 16;
      const int ys = f.ys;
      if (filter_type == 1) {  // simple: luma only
        if (mb_x > 0) simple_edge(yd, 1, ys, limit + 4);
        if (fi.inner)
          for (int k = 4; k < 16; k += 4) simple_edge(yd + k, 1, ys, limit);
        if (mb_y > 0) simple_edge(yd, ys, 1, limit + 4);
        if (fi.inner)
          for (int k = 4; k < 16; k += 4) simple_edge(yd + k * ys, ys, 1, limit);
        continue;
      }
      const int uvs = f.uvs, il = fi.ilevel, hv = fi.hev;
      uint8_t* ud = f.u.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
      uint8_t* vd = f.v.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
      if (mb_x > 0) {
        normal_edge(yd, 1, ys, 16, limit + 4, il, hv, true);
        normal_edge(ud, 1, uvs, 8, limit + 4, il, hv, true);
        normal_edge(vd, 1, uvs, 8, limit + 4, il, hv, true);
      }
      if (fi.inner) {
        for (int k = 4; k < 16; k += 4) normal_edge(yd + k, 1, ys, 16, limit, il, hv, false);
        normal_edge(ud + 4, 1, uvs, 8, limit, il, hv, false);
        normal_edge(vd + 4, 1, uvs, 8, limit, il, hv, false);
      }
      if (mb_y > 0) {
        normal_edge(yd, ys, 1, 16, limit + 4, il, hv, true);
        normal_edge(ud, uvs, 1, 8, limit + 4, il, hv, true);
        normal_edge(vd, uvs, 1, 8, limit + 4, il, hv, true);
      }
      if (fi.inner) {
        for (int k = 4; k < 16; k += 4)
          normal_edge(yd + k * ys, ys, 1, 16, limit, il, hv, false);
        normal_edge(ud + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
        normal_edge(vd + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      }
    }
  }
}

// ---- YUV 4:2:0 -> RGB as libwebp's default output: "fancy" upsampling of
// the chroma (its two-stage rounding of the 9-3-3-1 filter) and VP8YUVToR/G/B

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbLinePair: two output rows from the chroma rows above (top_*)
// and below (cur_*); bottom may be null.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) { return (uint32_t)u | ((uint32_t)v << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 3);
    }
  }
}

// EmitFancyRGB over the whole picture: row 0 from chroma row 0 alone, rows
// 2k-1 and 2k from chroma rows k-1 and k, the last row of an even height
// from the last chroma row alone.
void frame_to_rgb(const Frame8& f, int w, int h, Rgb& out) {
  out.w = w;
  out.h = h;
  out.px.assign((size_t)w * h * 3, 0);
  auto Y = [&](int row) { return f.y.data() + (size_t)row * f.ys; };
  auto U = [&](int row) { return f.u.data() + (size_t)row * f.uvs; };
  auto V = [&](int row) { return f.v.data() + (size_t)row * f.uvs; };
  auto D = [&](int row) { return out.px.data() + (size_t)row * w * 3; };
  upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), D(0), nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const int k = y / 2;
    upsample_pair(Y(y + 1), Y(y + 2), U(k), V(k), U(k + 1), V(k + 1), D(y + 1), D(y + 2), w);
  }
  if (!(h & 1)) {
    const int k = (h - 1) / 2;
    upsample_pair(Y(h - 1), nullptr, U(k), V(k), U(k), V(k), D(h - 1), nullptr, w);
  }
}

// ---- the key frame

struct VP8Dec {
  BoolDec br;
  std::vector<BoolDec> parts;
  int num_parts_minus_one = 0;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t probas[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
};

void parse_segment_header(VP8Dec& d) {
  BoolDec& br = d.br;
  d.use_segment = br.get(0x80);
  if (d.use_segment) {
    d.update_map = br.get(0x80);
    if (br.get(0x80)) {
      d.absolute_delta = br.get(0x80);
      for (int s = 0; s < 4; ++s) d.quantizer[s] = br.get(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) d.filter_strength[s] = br.get(0x80) ? br.signed_value(6) : 0;
    }
    if (d.update_map)
      for (int s = 0; s < 3; ++s) d.segment_probs[s] = br.get(0x80) ? br.value_bits(8) : 255;
  } else {
    d.update_map = false;
  }
  if (br.eof) fail(BROKEN, "cannot parse segment header");
}

void parse_filter_header(VP8Dec& d) {
  BoolDec& br = d.br;
  d.simple = br.get(0x80);
  d.level = br.value_bits(6);
  d.sharpness = br.value_bits(3);
  d.use_lf_delta = br.get(0x80);
  if (d.use_lf_delta && br.get(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) d.ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) d.mode_lf_delta[i] = br.signed_value(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) fail(BROKEN, "cannot parse filter header");
}

// ParsePartitions: the last partition takes what is left and may not be empty
void parse_partitions(VP8Dec& d, const uint8_t* buf, size_t size) {
  d.num_parts_minus_one = (1 << d.br.value_bits(2)) - 1;
  const size_t last = d.num_parts_minus_one;
  if (size < 3 * last) fail(BROKEN, "cannot parse partitions");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last * 3;
  const uint8_t* buf_end = buf + size;
  size_t size_left = size - last * 3;
  d.parts.assign(last + 1, BoolDec());
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  d.parts[last].init(part_start, size_left);
  if (part_start >= buf_end) fail(BROKEN, "cannot parse partitions");
}

void parse_quant(VP8Dec& d) {
  BoolDec& br = d.br;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.get(0x80) ? br.signed_value(4) : 0;
  const int dquv_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int dquv_ac = br.get(0x80) ? br.signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i];
      if (!d.absolute_delta) q += base_q0;
    } else if (i > 0) {
      d.dqm[i] = d.dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = d.dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q + 0, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x 155 / 100
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void parse_proba(VP8Dec& d) {
  BoolDec& br = d.br;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          d.probas[t][b][c][p] =
              br.get(kCoeffsUpdateProba[t][b][c][p]) ? br.value_bits(8) : kCoeffsProba0[t][b][c][p];
  d.use_skip_proba = br.get(0x80);
  if (d.use_skip_proba) d.skip_p = br.value_bits(8);
}

void precompute_filter_strengths(VP8Dec& d) {
  if (d.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d.use_segment) {
      base_level = d.filter_strength[s];
      if (!d.absolute_delta) base_level += d.level;
    } else {
      base_level = d.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = d.fstrengths[s][i4x4];
      int level = base_level;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = (uint8_t)ilevel;
        info.limit = (uint8_t)(2 * level + ilevel);
        info.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = (uint8_t)i4x4;
    }
  }
}

// ParseIntraMode, for one macroblock; top/left are the 4x4 mode contexts.
void parse_intra_mode(VP8Dec& d, MBData& block, uint8_t* top, uint8_t* left) {
  BoolDec& br = d.br;
  if (d.update_map)
    block.segment = !br.get(d.segment_probs[0]) ? br.get(d.segment_probs[1])
                                                 : br.get(d.segment_probs[2]) + 2;
  else
    block.segment = 0;
  block.skip = d.use_skip_proba ? br.get(d.skip_p) : 0;
  block.is_i4x4 = !br.get(145);
  if (!block.is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
    block.imodes[0] = (uint8_t)ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        ymode = !br.get(prob[0])   ? B_DC
                : !br.get(prob[1]) ? B_TM
                : !br.get(prob[2]) ? B_VE
                : !br.get(prob[3]) ? (!br.get(prob[4]) ? B_HE : (!br.get(prob[5]) ? B_RD : B_VR))
                                   : (!br.get(prob[6])   ? B_LD
                                      : !br.get(prob[7]) ? B_VL
                                      : !br.get(prob[8]) ? B_HD
                                                         : B_HU);
        top[x] = (uint8_t)ymode;
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  block.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
}

int large_value(BoolDec& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// GetCoeffs: the tokens of one block from position n; returns the position
// after the last token read (16 after a run of zeros to the end).
int get_coeffs(BoolDec& br, const uint8_t (*probas)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = probas[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = probas[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = probas[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = probas[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = (int16_t)((br.get(0x80) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

struct NzCtx {
  uint8_t nz = 0, nz_dc = 0;
};

// ParseResiduals; returns whether the macroblock has no non-zero block.
bool parse_residuals(VP8Dec& d, MBData& block, NzCtx& mb, NzCtx& left, BoolDec& br) {
  const Quant& q = d.dqm[block.segment];
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  int first;
  const uint8_t(*ac_proba)[3][11];
  bool any = false;
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left.nz_dc;
    const int nz = get_coeffs(br, d.probas[1], ctx, q.y2, 0, dc);
    mb.nz_dc = left.nz_dc = nz > 0;
    inverse_wht(dc, dst);
    first = 1;
    ac_proba = d.probas[0];
  } else {
    first = 0;
    ac_proba = d.probas[3];
  }
  uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      block.codes[4 * y + x] = nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0;
      any = any || block.codes[4 * y + x];
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    tnz = (uint8_t)(mb.nz >> (4 + ch));
    lnz = (uint8_t)(left.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, d.probas[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        block.codes[16 + ch * 2 + 2 * y + x] = nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0;
        any = any || block.codes[16 + ch * 2 + 2 * y + x];
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  mb.nz = (uint8_t)out_t_nz;
  left.nz = (uint8_t)out_l_nz;
  return !any;
}

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

// A VP8 key frame (after its chunk header) decoded to RGB.
void decode_vp8(const uint8_t* data, size_t size, Rgb& out) {
  VP8Dec d;
  if (size < 4) fail(BROKEN, "truncated header");
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) fail(BROKEN, "incorrect keyframe parameters");
  if (!show) fail(BROKEN, "frame not displayable");
  const uint8_t* buf = data + 3;
  size_t buf_size = size - 3;
  if (!key_frame) fail(BROKEN, "not a key frame");
  if (buf_size < 7) fail(BROKEN, "cannot parse picture header");
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) fail(BROKEN, "bad code word");
  d.width = ((buf[4] << 8) | buf[3]) & 0x3fff;
  d.height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  buf_size -= 7;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  if (partition_length > buf_size) fail(BROKEN, "bad partition length");
  d.br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  d.br.get(0x80);  // colour space
  d.br.get(0x80);  // clamping type (libwebp always clamps)
  parse_segment_header(d);
  parse_filter_header(d);
  parse_partitions(d, buf, buf_size);
  parse_quant(d);
  d.br.get(0x80);  // refresh entropy probabilities: ignored for a key frame
  parse_proba(d);
  precompute_filter_strengths(d);

  Frame8 f;
  f.mb_w = d.mb_w;
  f.mb_h = d.mb_h;
  f.ys = d.mb_w * 16;
  f.uvs = d.mb_w * 8;
  f.y.assign((size_t)f.ys * d.mb_h * 16, 0);
  f.u.assign((size_t)f.uvs * d.mb_h * 8, 0);
  f.v.assign((size_t)f.uvs * d.mb_h * 8, 0);
  std::vector<FInfo> finfo((size_t)d.mb_w * d.mb_h);
  std::vector<MBData> blocks(d.mb_w);
  std::vector<NzCtx> nz(d.mb_w + 1);  // [0] is the left context
  std::vector<uint8_t> intra_t(4 * d.mb_w, B_DC);
  uint8_t intra_l[4];
  std::vector<TopSamples> top(d.mb_w);
  uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
  uint8_t* const ydst = ybuf + BPS + 8;
  uint8_t* const udst = ubuf + BPS + 8;
  uint8_t* const vdst = vbuf + BPS + 8;
  std::memset(ybuf, 0, sizeof(ybuf));
  std::memset(ubuf, 0, sizeof(ubuf));
  std::memset(vbuf, 0, sizeof(vbuf));

  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    // the modes of the row, from the first partition
    std::memset(intra_l, B_DC, 4);
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
      parse_intra_mode(d, blocks[mb_x], &intra_t[4 * mb_x], intra_l);
    if (d.br.eof) fail(BROKEN, "premature end of partition 0");
    // the tokens of the row
    BoolDec& token_br = d.parts[mb_y & d.num_parts_minus_one];
    nz[0] = NzCtx();
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBData& block = blocks[mb_x];
      NzCtx& mb = nz[mb_x + 1];
      bool skip = d.use_skip_proba ? block.skip : false;
      if (!skip) {
        skip = parse_residuals(d, block, mb, nz[0], token_br);
      } else {
        nz[0].nz = mb.nz = 0;
        if (!block.is_i4x4) nz[0].nz_dc = mb.nz_dc = 0;
        std::memset(block.codes, 0, sizeof(block.codes));
      }
      if (d.filter_type > 0) {
        FInfo fi = d.fstrengths[block.segment][block.is_i4x4];
        fi.inner |= !skip;
        finfo[(size_t)mb_y * d.mb_w + mb_x] = fi;
      }
      if (token_br.eof) fail(BROKEN, "premature end of file");
    }
    // reconstruct the row (ReconstructRow)
    for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
    } else {
      std::memset(ydst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(udst - BPS - 1, 127, 8 + 1);
      std::memset(vdst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      const MBData& block = blocks[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&ydst[j * BPS - 4], &ydst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&udst[j * BPS - 4], &udst[j * BPS + 4], 4);
          std::memcpy(&vdst[j * BPS - 4], &vdst[j * BPS + 4], 4);
        }
      }
      TopSamples* const top_yuv = &top[mb_x];
      if (mb_y > 0) {
        std::memcpy(ydst - BPS, top_yuv->y, 16);
        std::memcpy(udst - BPS, top_yuv->u, 8);
        std::memcpy(vdst - BPS, top_yuv->v, 8);
      }
      const int16_t* coeffs = block.coeffs;
      if (block.is_i4x4) {
        uint8_t* const top_right = ydst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= d.mb_w - 1)
            std::memset(top_right, top_yuv->y[15], 4);
          else
            std::memcpy(top_right, top_yuv[1].y, 4);
        }
        // the 4x4 blocks of the right column read the macroblock's
        // above-right pixels in every row
        for (int r = 1; r < 4; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* const dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, block.imodes[n]);
          add_block(block.codes[n], coeffs + n * 16, dst);
        }
      } else {
        predict_block(ydst, 16, block.imodes[0], mb_x, mb_y);
        for (int n = 0; n < 16; ++n)
          add_block(block.codes[n], coeffs + n * 16, ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      predict_block(udst, 8, block.uvmode, mb_x, mb_y);
      predict_block(vdst, 8, block.uvmode, mb_x, mb_y);
      add_uv_blocks(block.codes + 16, coeffs + 16 * 16, udst);
      add_uv_blocks(block.codes + 20, coeffs + 20 * 16, vdst);
      if (mb_y < d.mb_h - 1) {
        std::memcpy(top_yuv->y, ydst + 15 * BPS, 16);
        std::memcpy(top_yuv->u, udst + 7 * BPS, 8);
        std::memcpy(top_yuv->v, vdst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&f.y[(size_t)(mb_y * 16 + j) * f.ys + mb_x * 16], ydst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&f.u[(size_t)(mb_y * 8 + j) * f.uvs + mb_x * 8], udst + j * BPS, 8);
        std::memcpy(&f.v[(size_t)(mb_y * 8 + j) * f.uvs + mb_x * 8], vdst + j * BPS, 8);
      }
    }
  }
  if (d.filter_type > 0) filter_frame(f, finfo, d.filter_type);
  frame_to_rgb(f, d.width, d.height, out);
}

// ---------------------------------------------------------------- container

enum { ANIMATION_FLAG = 0x02, XMP_FLAG = 0x04, EXIF_FLAG = 0x08, ALPHA_FLAG = 0x10,
       ICCP_FLAG = 0x20, ALL_VALID_FLAGS = 0x3e };

enum Status { VP8_OK, NOT_ENOUGH_DATA, BITSTREAM_ERROR };

// What ParseHeadersInternal finds in a buffer.
struct Headers {
  const uint8_t* alpha_data = nullptr;
  size_t alpha_size = 0;
  size_t compressed_size = 0;
  bool is_lossless = false;
  size_t offset = 0;  // of the VP8/VP8L bitstream, past its chunk header
  int width = 0, height = 0;
};

// VP8GetInfo
bool vp8_info(const uint8_t* data, size_t size, size_t chunk_size, int* w, int* h) {
  if (size < 10) return false;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return false;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if (bits & 1) return false;  // not a key frame
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size) return false;
  *w = ((data[7] << 8) | data[6]) & 0x3fff;
  *h = ((data[9] << 8) | data[8]) & 0x3fff;
  return *w != 0 && *h != 0;
}

// ParseHeadersInternal (libwebp's webp_dec.c): RIFF, VP8X, the optional
// chunks before the bitstream, and the VP8/VP8L chunk header and frame
// header.  With have_all_data it is WebPDecode's call; without it
// WebPGetFeatures' (a VP8X file then only needs its VP8X chunk whole, and
// an animation only its VP8X chunk).
Status parse_headers(const uint8_t* data, size_t data_size, bool have_all_data, Headers& out) {
  const uint8_t* const start = data;
  int canvas_w = 0, canvas_h = 0, image_w = 0, image_h = 0;
  bool found_riff = false, found_vp8x = false, animation = false;
  size_t riff_size = 0;
  Status status = VP8_OK;
  Headers h;
  if (data_size < 12) return NOT_ENOUGH_DATA;
  // ParseRIFF
  if (is_tag(data, "RIFF")) {
    if (!is_tag(data + 8, "WEBP")) return BITSTREAM_ERROR;
    const uint32_t size = le32(data + 4);
    if (size < 4 + 8) return BITSTREAM_ERROR;
    if (size > kMaxChunkPayload) return BITSTREAM_ERROR;
    if (have_all_data && size > data_size - 8) return NOT_ENOUGH_DATA;
    riff_size = size;
    data += 12;
    data_size -= 12;
    found_riff = true;
  }
  // ParseVP8X
  if (data_size < 8) return NOT_ENOUGH_DATA;
  if (is_tag(data, "VP8X")) {
    if (le32(data + 4) != 10) return BITSTREAM_ERROR;
    if (data_size < 18) return NOT_ENOUGH_DATA;
    const uint32_t flags = le32(data + 8);
    const int w = 1 + (int)le24(data + 12), hh = 1 + (int)le24(data + 15);
    if ((uint64_t)w * hh >= kMaxImageArea) return BITSTREAM_ERROR;
    animation = flags & ANIMATION_FLAG;
    canvas_w = w;
    canvas_h = hh;
    data += 18;
    data_size -= 18;
    found_vp8x = true;
  }
  if (!found_riff && found_vp8x) return BITSTREAM_ERROR;
  image_w = canvas_w;
  image_h = canvas_h;
  if (found_vp8x && animation && !have_all_data) {
    out.width = image_w;
    out.height = image_h;
    return VP8_OK;
  }
  const uint8_t* alpha_data = nullptr;
  size_t alpha_size = 0;
  if (data_size < 4) {
    status = NOT_ENOUGH_DATA;
    goto done;
  }
  // ParseOptionalChunks
  if ((found_riff && found_vp8x) || (!found_riff && !found_vp8x && is_tag(data, "ALPH"))) {
    uint32_t total_size = 4 + 8 + 10;
    while (true) {
      if (data_size < 8) {
        status = NOT_ENOUGH_DATA;
        goto done;
      }
      const uint32_t chunk_size = le32(data + 4);
      if (chunk_size > kMaxChunkPayload) return BITSTREAM_ERROR;
      const uint32_t disk_chunk_size = (8 + chunk_size + 1) & ~1u;
      total_size += disk_chunk_size;
      if (riff_size > 0 && total_size > riff_size) return BITSTREAM_ERROR;
      if (is_tag(data, "VP8 ") || is_tag(data, "VP8L")) break;
      if (data_size < disk_chunk_size) {
        status = NOT_ENOUGH_DATA;
        goto done;
      }
      if (is_tag(data, "ALPH")) {
        alpha_data = data + 8;
        alpha_size = chunk_size;
      }
      data += disk_chunk_size;
      data_size -= disk_chunk_size;
    }
  }
  // ParseVP8Header
  {
    if (data_size < 8) {
      status = NOT_ENOUGH_DATA;
      goto done;
    }
    const bool is_vp8 = is_tag(data, "VP8 "), is_vp8l = is_tag(data, "VP8L");
    if (!is_vp8 && !is_vp8l) return BITSTREAM_ERROR;  // a raw bitstream: not in a RIFF file
    const uint32_t size = le32(data + 4);
    if (riff_size >= 12 && size > riff_size - 12) return BITSTREAM_ERROR;
    if (have_all_data && size > data_size - 8) {
      status = NOT_ENOUGH_DATA;
      goto done;
    }
    h.compressed_size = size;
    h.is_lossless = is_vp8l;
    data += 8;
    data_size -= 8;
  }
  if (h.compressed_size > kMaxChunkPayload) return BITSTREAM_ERROR;
  if (!h.is_lossless) {
    if (data_size < 10) {
      status = NOT_ENOUGH_DATA;
      goto done;
    }
    if (!vp8_info(data, data_size, h.compressed_size, &image_w, &image_h)) return BITSTREAM_ERROR;
  } else {
    if (data_size < 5) {
      status = NOT_ENOUGH_DATA;
      goto done;
    }
    if (!vp8l_info(data, data_size, &image_w, &image_h)) return BITSTREAM_ERROR;
  }
  if (found_vp8x && (canvas_w != image_w || canvas_h != image_h)) return BITSTREAM_ERROR;
  h.alpha_data = alpha_data;
  h.alpha_size = alpha_size;
  h.offset = data - start;
done:
  if (status == VP8_OK || (status == NOT_ENOUGH_DATA && found_vp8x && !have_all_data)) {
    h.width = image_w;
    h.height = image_h;
    out = h;
    return VP8_OK;
  }
  return status;
}

// ---- the demuxer (libwebp's demux.c), for a whole file

enum Parse { PARSE_OK, PARSE_NEED_MORE_DATA, PARSE_ERROR };

struct DFrame {
  int x_offset = 0, y_offset = 0, width = 0, height = 0;
  int frame_num = 0;
  bool complete = false, has_alpha = false;
  size_t img_offset = 0, img_size = 0, alpha_offset = 0, alpha_size = 0;
};

struct Demux {
  const uint8_t* buf = nullptr;
  size_t start = 0, end = 0, riff_end = 0;
  bool is_ext = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  int num_frames = 0;
  std::vector<DFrame> frames;

  size_t avail() const { return end - start; }
  bool size_invalid(size_t size) const { return size > riff_end - start; }
  uint32_t read_le32() {
    uint32_t v = le32(buf + start);
    start += 4;
    return v;
  }
  int read_le24s() {
    int v = (int)le24(buf + start);
    start += 3;
    return v;
  }
};

// StoreFrame: the ALPH and VP8/VP8L chunks of one frame, from the current
// position; stops (rewinding) at the first other chunk.
Parse store_frame(Demux& d, int frame_num, uint32_t min_size, DFrame& frame) {
  int alpha_chunks = 0, image_chunks = 0;
  bool done = d.avail() < 8 || d.avail() < min_size;
  Parse status = PARSE_OK;
  if (done) return PARSE_NEED_MORE_DATA;
  do {
    const size_t chunk_start = d.start;
    const uint8_t* fourcc = d.buf + d.start;
    d.start += 4;
    const uint32_t payload_size = d.read_le32();
    if (payload_size > kMaxChunkPayload) return PARSE_ERROR;
    const uint32_t padded = payload_size + (payload_size & 1);
    const size_t payload_available = padded > d.avail() ? d.avail() : padded;
    const size_t chunk_size = 8 + payload_available;
    if (d.size_invalid(padded)) return PARSE_ERROR;
    if (padded > d.avail()) status = PARSE_NEED_MORE_DATA;
    bool stop = false;
    if (is_tag(fourcc, "ALPH")) {
      if (alpha_chunks == 0) {
        ++alpha_chunks;
        frame.alpha_offset = chunk_start;
        frame.alpha_size = chunk_size;
        frame.has_alpha = true;
        frame.frame_num = frame_num;
        d.start += payload_available;
      } else {
        stop = true;
      }
    } else if (is_tag(fourcc, "VP8L") || is_tag(fourcc, "VP8 ")) {
      if (is_tag(fourcc, "VP8L") && alpha_chunks > 0) return PARSE_ERROR;
      if (image_chunks == 0) {
        Headers feat;
        const Status st = parse_headers(d.buf + chunk_start, chunk_size, false, feat);
        if (status == PARSE_NEED_MORE_DATA && st == NOT_ENOUGH_DATA) return PARSE_NEED_MORE_DATA;
        if (st != VP8_OK) return PARSE_ERROR;
        ++image_chunks;
        frame.img_offset = chunk_start;
        frame.img_size = chunk_size;
        frame.width = feat.width;
        frame.height = feat.height;
        frame.frame_num = frame_num;
        frame.complete = status == PARSE_OK;
        d.start += payload_available;
      } else {
        stop = true;
      }
    } else {
      stop = true;
    }
    if (stop) {
      d.start -= 8;
      done = true;
    }
    if (d.start == d.riff_end)
      done = true;
    else if (d.avail() < 8)
      status = PARSE_NEED_MORE_DATA;
  } while (!done && status == PARSE_OK);
  return status;
}

bool add_frame(Demux& d, const DFrame& f) {
  if (!d.frames.empty() && !d.frames.back().complete) return false;
  d.frames.push_back(f);
  return true;
}

Parse parse_single_image(Demux& d) {
  if (!d.frames.empty()) return PARSE_ERROR;
  if (d.size_invalid(8)) return PARSE_ERROR;
  if (d.avail() < 8) return PARSE_NEED_MORE_DATA;
  DFrame frame;
  Parse status = store_frame(d, 1, 0, frame);
  if (status != PARSE_ERROR) {
    if (!(d.flags & ALPHA_FLAG) && frame.alpha_size > 0) {  // alpha without the flag: ignored
      frame.alpha_offset = 0;
      frame.alpha_size = 0;
      frame.has_alpha = false;
    }
    if (!d.is_ext && frame.width > 0 && frame.height > 0) {
      d.canvas_w = frame.width;
      d.canvas_h = frame.height;
      d.flags |= frame.has_alpha ? ALPHA_FLAG : 0;
    }
    if (!add_frame(d, frame))
      status = PARSE_ERROR;
    else
      d.num_frames = 1;
  }
  return status;
}

Parse parse_animation_frame(Demux& d, uint32_t frame_chunk_size) {
  const bool is_animation = d.flags & ANIMATION_FLAG;
  const uint32_t anmf_payload_size = frame_chunk_size - 16;
  // NewFrame
  if (d.size_invalid(16)) return PARSE_ERROR;
  if (frame_chunk_size < 16) return PARSE_ERROR;
  if (d.avail() < 16) return PARSE_NEED_MORE_DATA;
  DFrame frame;
  frame.x_offset = 2 * d.read_le24s();
  frame.y_offset = 2 * d.read_le24s();
  frame.width = 1 + d.read_le24s();
  frame.height = 1 + d.read_le24s();
  d.read_le24s();  // duration
  d.start += 1;    // dispose and blend bits: frame 0 is drawn on a clear canvas
  if ((uint64_t)frame.width * frame.height >= kMaxImageArea) return PARSE_ERROR;
  const size_t start_offset = d.start;
  Parse status = store_frame(d, d.num_frames + 1, anmf_payload_size, frame);
  if (status != PARSE_ERROR && d.start - start_offset > anmf_payload_size) status = PARSE_ERROR;
  if (status != PARSE_ERROR && is_animation && frame.frame_num > 0) {
    if (add_frame(d, frame))
      ++d.num_frames;
    else
      status = PARSE_ERROR;
  }
  return status;
}

Parse parse_vp8x_chunks(Demux& d) {
  const bool is_animation = d.flags & ANIMATION_FLAG;
  int anim_chunks = 0;
  Parse status = PARSE_OK;
  do {
    const uint8_t* fourcc = d.buf + d.start;
    d.start += 4;
    const uint32_t chunk_size = d.read_le32();
    if (chunk_size > kMaxChunkPayload) return PARSE_ERROR;
    const uint32_t padded = chunk_size + (chunk_size & 1);
    if (d.size_invalid(padded)) return PARSE_ERROR;
    if (is_tag(fourcc, "VP8X")) {
      return PARSE_ERROR;
    } else if (is_tag(fourcc, "ALPH") || is_tag(fourcc, "VP8 ") || is_tag(fourcc, "VP8L")) {
      if (anim_chunks > 0 || is_animation) return PARSE_ERROR;
      d.start -= 8;
      status = parse_single_image(d);
    } else if (is_tag(fourcc, "ANIM")) {
      if (padded < 6) return PARSE_ERROR;
      if (d.avail() < padded) {
        status = PARSE_NEED_MORE_DATA;
      } else if (anim_chunks == 0) {
        ++anim_chunks;
        d.start += padded;  // background colour and loop count
      } else {
        d.start += padded;  // a second ANIM is skipped
      }
    } else if (is_tag(fourcc, "ANMF")) {
      if (anim_chunks == 0) return PARSE_ERROR;
      status = parse_animation_frame(d, padded);
    } else {  // ICCP, EXIF, XMP and unknown chunks
      if (padded <= d.avail())
        d.start += padded;
      else
        status = PARSE_NEED_MORE_DATA;
    }
    if (d.start == d.riff_end) break;
    if (d.avail() < 8) status = PARSE_NEED_MORE_DATA;
  } while (status == PARSE_OK);
  return status;
}

Parse parse_vp8x(Demux& d) {
  if (d.avail() < 8) return PARSE_NEED_MORE_DATA;
  d.is_ext = true;
  d.start += 4;
  uint32_t vp8x_size = d.read_le32();
  if (vp8x_size > kMaxChunkPayload) return PARSE_ERROR;
  if (vp8x_size < 10) return PARSE_ERROR;
  vp8x_size += vp8x_size & 1;
  if (d.size_invalid(vp8x_size)) return PARSE_ERROR;
  if (d.avail() < vp8x_size) return PARSE_NEED_MORE_DATA;
  d.flags = d.buf[d.start];
  d.start += 4;
  d.canvas_w = 1 + d.read_le24s();
  d.canvas_h = 1 + d.read_le24s();
  if ((uint64_t)d.canvas_w * d.canvas_h >= kMaxImageArea) return PARSE_ERROR;
  d.start += vp8x_size - 10;
  if (d.size_invalid(8)) return PARSE_ERROR;
  if (d.avail() < 8) return PARSE_NEED_MORE_DATA;
  return parse_vp8x_chunks(d);
}

bool frame_in_bounds(const DFrame& f, bool exact, int cw, int ch) {
  if (exact) return f.x_offset == 0 && f.y_offset == 0 && f.width == cw && f.height == ch;
  return f.x_offset >= 0 && f.y_offset >= 0 && f.width + f.x_offset <= cw &&
         f.height + f.y_offset <= ch;
}

bool valid_simple(const Demux& d) {
  if (d.canvas_w <= 0 || d.canvas_h <= 0 || d.frames.empty()) return false;
  return d.frames[0].width > 0 && d.frames[0].height > 0;
}

bool valid_extended(const Demux& d) {
  const bool is_animation = d.flags & ANIMATION_FLAG;
  if (d.canvas_w <= 0 || d.canvas_h <= 0) return false;
  if (d.frames.empty()) return false;
  if (d.flags & ~ALL_VALID_FLAGS) return false;
  for (size_t i = 0; i < d.frames.size(); ++i) {
    const DFrame& f = d.frames[i];
    if (!is_animation && f.frame_num > 1) return false;
    if (f.complete) {
      if (f.alpha_size == 0 && f.img_size == 0) return false;
      if (f.alpha_size > 0 && f.alpha_offset > f.img_offset) return false;
      if (f.width <= 0 || f.height <= 0) return false;
    } else {
      return false;  // a partial frame in a whole file
    }
    if (f.width > 0 && f.height > 0 && !frame_in_bounds(f, !is_animation, d.canvas_w, d.canvas_h))
      return false;
  }
  return true;
}

// WebPDemux of a whole file (not partial): false where it returns NULL.
bool demux(const uint8_t* data, size_t n, Demux& d) {
  if (n < 20) return false;
  if (!is_tag(data, "RIFF") || !is_tag(data + 8, "WEBP")) return false;
  const uint32_t riff_size = le32(data + 4);
  if (riff_size < 8 || riff_size > kMaxChunkPayload) return false;
  d.buf = data;
  d.riff_end = (size_t)riff_size + 8;
  d.end = n > d.riff_end ? d.riff_end : n;
  if (d.end < d.riff_end) return false;  // partial data
  d.start = 12;
  const uint8_t* fourcc = data + 12;
  Parse status;
  bool simple;
  if (is_tag(fourcc, "VP8 ") || is_tag(fourcc, "VP8L")) {
    status = parse_single_image(d);
    simple = true;
  } else if (is_tag(fourcc, "VP8X")) {
    status = parse_vp8x(d);
    simple = false;
  } else {
    return false;
  }
  if (status != PARSE_OK) return false;
  return simple ? valid_simple(d) : valid_extended(d);
}

// WebPDecode of one frame's payload (its ALPH chunk, if any, to the end of
// its VP8/VP8L chunk).
bool decode_frame(const uint8_t* payload, size_t size, Rgb& out) {
  Headers h;
  if (parse_headers(payload, size, true, h) != VP8_OK) return false;
  const uint8_t* data = payload + h.offset;
  const size_t data_size = size - h.offset;
  if (h.is_lossless) return decode_vp8l(data, data_size, out);
  decode_vp8(data, data_size, out);  // throws on a broken stream
  if (h.alpha_data && !alpha_ok(h.alpha_data, h.alpha_size, h.width, h.height)) return false;
  return true;
}

// Image.open(...).convert("L") (channels 1) or convert("RGB") (channels 3)
// of a WebP file.
std::vector<uint8_t> decode_webp(const uint8_t* data, size_t n, int channels, int& W, int& H) {
  Headers feat;
  Demux d;
  if (parse_headers(data, n, false, feat) != VP8_OK || !demux(data, n, d))
    fail(BROKEN, "could not create decoder object");
  W = d.canvas_w;
  H = d.canvas_h;
  if ((long)W > 2 * kMaxImagePixels / H)
    fail(BOMB, "image of " + std::to_string(W) + "x" + std::to_string(H) +
                   " pixels exceeds twice PIL's limit");
  const DFrame& f = d.frames[0];
  size_t start = f.img_offset, size = f.img_size;
  if (f.alpha_size > 0) {  // GetFramePayload: from the ALPH chunk on
    size += f.alpha_size + (f.img_offset > 0 ? f.img_offset - (f.alpha_offset + f.alpha_size) : 0);
    start = f.alpha_offset;
  }
  Rgb frame;
  bool ok;
  try {
    ok = decode_frame(data + start, size, frame);
  } catch (const Failure&) {
    ok = false;
  }
  if (!ok || frame.w != f.width || frame.h != f.height) fail(BROKEN, "failed to read next frame");
  std::vector<uint8_t> out((size_t)W * H * channels, 0);
  for (int y = 0; y < frame.h; ++y) {
    const uint8_t* src = frame.px.data() + (size_t)y * frame.w * 3;
    uint8_t* dst = out.data() + ((size_t)(y + f.y_offset) * W + f.x_offset) * channels;
    if (channels == 3) {
      std::memcpy(dst, src, (size_t)frame.w * 3);
    } else {
      for (int x = 0; x < frame.w; ++x) dst[x] = L24(src[3 * x], src[3 * x + 1], src[3 * x + 2]);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Decode a WebP into a malloc'ed uint8 [h, w] (channels 1, PIL's L) or
// [h, w, 3] (channels 3, PIL's RGB) canvas; free it with webp_free.
// Returns OK or an error code, with the reason in msg.
int webp_decode(const uint8_t* data, size_t n, int channels, uint8_t** out, int* w, int* h,
                char* msg, int msg_len) {
  *out = nullptr;
  try {
    int W = 0, H = 0;
    std::vector<uint8_t> img = decode_webp(data, n, channels == 3 ? 3 : 1, W, H);
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

void webp_free(uint8_t* p) { std::free(p); }

}  // extern "C"
