// The LZW and PackBits strips and tiles of a TIFF, decoded as libtiff 4.7
// decodes them for PIL (data/tiff.py reads the directory, inflates Deflate
// and LZMA data with Python's zlib and lzma, and undoes the predictor and
// the fill order).
//
//   tiff_lzw       libtiff's LZWDecode: codes MSB first, 9 to 12 bits with
//                  the early change (the width grows as the next free entry
//                  passes 2**n - 2), a clear code first (a stream that does
//                  not begin with one is corrupt), codes past the last
//                  defined entry corrupt, the end code or the end of the
//                  data before `occ` bytes are out "not enough data", and a
//                  string that runs past `occ` cut where the buffer ends.
//   tiff_packbits  libtiff's PackBitsDecode: -128 a no-op, a run or a
//                  literal cut at the end of the buffer, and "not enough
//                  data" when the input ends first.
//
// Errors come back as a code and a message: 1 where libtiff fails (PIL
// raises OSError).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { OK = 0, BROKEN = 1 };

struct Failure {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{msg}; }

const int kClear = 256, kEoi = 257, kFirst = 258, kBitsMin = 9, kBitsMax = 12;
const int kCsize = 4095 + 1024;  // MAXCODE(BITS_MAX) + 1024: entries past 4095 are made, not read

struct Code {
  int next;  // index of the prefix's entry, -1 for none
  uint16_t length;
  uint8_t value, firstchar;
};

void lzw(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  std::vector<Code> tab(kCsize);
  for (int c = 0; c < 256; c++) tab[c] = Code{-1, 1, (uint8_t)c, (uint8_t)c};
  for (int c = 256; c < kCsize; c++) tab[c] = Code{-1, 0, 0, 0};
  uint64_t bitsleft = (uint64_t)n * 8, acc = 0;
  size_t pos = 0;
  int accbits = 0, nbits = kBitsMin, free_ent = -1, maxcode = (1 << kBitsMin) - 2, old = 0;
  auto next_code = [&]() -> int {
    if (bitsleft < (uint64_t)nbits) return kEoi;  // "not terminated with EOI code"
    while (accbits < nbits) {
      acc = (acc << 8) | in[pos++];
      accbits += 8;
    }
    accbits -= nbits;
    bitsleft -= nbits;
    return (int)((acc >> accbits) & ((1u << nbits) - 1));
  };
  uint8_t* op = out;
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int c = kFirst; c < kCsize; c++) tab[c] = Code{-1, 0, 0, 0};
        nbits = kBitsMin;
        maxcode = (1 << kBitsMin) - 2;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) fail("LZWDecode: Corrupted LZW table");
      *op++ = (uint8_t)code;
      occ--;
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize) fail("LZWDecode: Corrupted LZW table");
    Code& e = tab[free_ent];
    e.next = old;
    e.firstchar = tab[old].firstchar;
    e.length = (uint16_t)(tab[old].length + 1);
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 2;
    }
    old = code;
    if (code >= 256) {
      const Code* c = &tab[code];
      if (c->length == 0) fail("LZWDecode: Wrong length of decoded string");
      if (c->length > occ) {  // what fits, and no more
        while (c->next >= 0 && c->length > occ) c = &tab[c->next];
        if (c->length <= occ) {
          uint8_t* tp = op + occ;
          for (;;) {
            *--tp = c->value;
            if (--occ == 0 || c->next < 0) break;
            c = &tab[c->next];
          }
        }
        break;
      }
      size_t len = c->length;
      uint8_t* tp = op + len;
      for (;;) {
        *--tp = c->value;
        if (c->next < 0 || tp <= op) break;
        c = &tab[c->next];
      }
      if (c->next >= 0 && tp <= op) fail("LZWDecode: Bogus encoding, loop in the code table");
      op += len;
      occ -= len;
    } else {
      *op++ = (uint8_t)code;
      occ--;
    }
  }
  if (occ > 0)
    fail("LZWDecode: Not enough data (short " + std::to_string(occ) + " bytes)");
}

void packbits(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  size_t cc = n;
  const uint8_t* bp = in;
  uint8_t* op = out;
  while (cc > 0 && occ > 0) {
    long k = *bp++;
    cc--;
    if (k >= 128) k -= 256;
    if (k < 0) {
      if (k == -128) continue;
      size_t run = (size_t)(-k + 1);
      if (occ < run) run = occ;
      if (cc == 0) break;
      occ -= run;
      uint8_t b = *bp++;
      cc--;
      std::memset(op, b, run);
      op += run;
    } else {
      size_t lit = (size_t)k + 1;
      if (occ < lit) lit = occ;
      if (cc < lit) break;
      std::memcpy(op, bp, lit);
      op += lit;
      occ -= lit;
      bp += lit;
      cc -= lit;
    }
  }
  if (occ > 0) fail("PackBitsDecode: Not enough data");
}

template <typename F>
int guarded(F f, char* msg, int msg_len) {
  try {
    f();
    return OK;
  } catch (const Failure& e) {
    std::snprintf(msg, msg_len, "%s", e.msg.c_str());
    return BROKEN;
  }
}

}  // namespace

extern "C" {

// Decode n bytes of LZW data into out, which takes occ bytes.
int tiff_lzw(const uint8_t* in, size_t n, uint8_t* out, size_t occ, char* msg, int msg_len) {
  return guarded([&] { lzw(in, n, out, occ); }, msg, msg_len);
}

// Decode n bytes of PackBits data into out, which takes occ bytes.
int tiff_packbits(const uint8_t* in, size_t n, uint8_t* out, size_t occ, char* msg,
                  int msg_len) {
  return guarded([&] { packbits(in, n, out, occ); }, msg, msg_len);
}

}  // extern "C"
