// The LZW image data of a GIF's first frame, decoded as Pillow's GifDecode.c
// decodes it for Image.open(...).convert("L") (data/gif.py reads the
// screen, the extensions and the image descriptor, as GifImagePlugin does,
// and calls gif_decode with what they give).
//
// What Pillow does, and this does bit for bit:
//   * codes are read LSB first from sub-blocks, and a sub-block is only
//     started once all of it is in the buffer;
//   * the code size grows when the next free entry equals the code mask
//     (so at minimum code sizes 0 and 1 it never grows), up to 12 bits; a
//     full table adds no entry and keeps its code size until a clear code
//     (the deferred clear);
//   * a code above the next free entry, or a first code after a clear
//     above the clear code, is a broken stream;
//   * pixels go into the frame's rectangle row by row, or in GIF's four
//     interlace passes, and the frame is done when its last row is full,
//     whatever follows;
//   * the end code and a buffer that runs out both hand control back to
//     ImageFile.load, which reads the file on from the tile's offset in
//     blocks of 65536 bytes: decoding goes on after an end code when the
//     file holds more bytes than were read so far, and the image is
//     truncated (OSError) when it does not.
// The canvas (the logical screen, grown to hold the frame) starts as
// `fill` everywhere; the frame's indices are written into it and the whole
// canvas is then mapped through `lut` (the palette's L values, or the
// identity for a frame without a palette).
//
// Errors come back as a code and a message: 1 where PIL raises OSError.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { OK = 0, BROKEN = 1 };
const int kTable = 4096;  // GIFTABLE
const int kMaxBits = 12;  // GIFBITS
const size_t kBlock = 65536;  // ImageFile.MAXBLOCK, the size of each read

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{BROKEN, msg}; }

struct Lzw {
  int bits, clear, end, next = 0, codesize = 0, codemask = 0, lastcode = 0, bufferindex = kTable;
  int state = 0;  // 0 fresh, 1 after a clear, 2 first code, 3 in a string
  uint8_t lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  uint8_t buffer[kTable];
  uint8_t data[kTable];
  uint16_t link[kTable];
};

// The frame's rectangle, filled as GifDecode.c's NEWLINE macro walks it.
struct Cursor {
  uint8_t* canvas;
  int stride, xoff, yoff, xsize, ysize;
  int x = 0, y = 0, step = 1, interlace = 0;

  // the next row; false once the frame is done
  bool newline() {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1: y = 4; interlace = 2; break;
        case 2: step = 4; y = 2; interlace = 3; break;
        case 3: step = 2; y = 1; interlace = 0; break;
        default: return false;
      }
    }
    return true;
  }
  // one pixel; false once the frame is done
  bool put(uint8_t v) {
    canvas[(size_t)(y + yoff) * stride + xoff + x] = v;
    if (++x >= xsize) return newline();
    return true;
  }
};

enum Status { DONE, PAUSE };

// One call of ImagingGifDecode on buf[*pos, avail): DONE when the frame is
// full, PAUSE at an end code or when the next sub-block is not all there.
Status decode(Lzw& z, Cursor& cur, const uint8_t* buf, size_t avail, size_t* pos) {
  size_t p = *pos;
  for (;;) {
    if (z.state == 1) {
      z.next = z.clear + 2;
      z.codesize = z.bits + 1;
      z.codemask = (1 << z.codesize) - 1;
      z.bufferindex = kTable;
      z.state = 2;
    }
    const uint8_t* out;
    int n;
    if (z.bufferindex < kTable) {  // the rest of the last string
      n = kTable - z.bufferindex;
      out = &z.buffer[z.bufferindex];
      z.bufferindex = kTable;
    } else {
      while (z.bitcount < z.codesize) {
        if (z.blocksize > 0) {
          z.bitbuffer |= (uint32_t)buf[p++] << z.bitcount;
          z.bitcount += 8;
          z.blocksize--;
        } else {  // a new sub-block, only when all of it is in the buffer
          if (p >= avail || avail - p < (size_t)buf[p] + 1) {
            *pos = p;
            return PAUSE;
          }
          z.blocksize = buf[p++];
        }
      }
      int c = (int)(z.bitbuffer & (uint32_t)z.codemask);
      z.bitbuffer >>= z.codesize;
      z.bitcount -= z.codesize;
      if (c == z.clear) {
        if (z.state != 2) z.state = 1;
        continue;
      }
      if (c == z.end) {
        *pos = p;
        return PAUSE;
      }
      if (z.state == 2) {
        if (c > z.clear) fail("broken data stream when reading image file");
        z.lastdata = (uint8_t)c;
        z.lastcode = c;
        z.state = 3;
      } else {
        int thiscode = c;
        if (c > z.next) fail("broken data stream when reading image file");
        if (c == z.next) {
          if (z.bufferindex <= 0) fail("broken data stream when reading image file");
          z.buffer[--z.bufferindex] = z.lastdata;
          c = z.lastcode;
        }
        while (c >= z.clear) {
          if (z.bufferindex <= 0 || c >= kTable)
            fail("broken data stream when reading image file");
          z.buffer[--z.bufferindex] = z.data[c];
          c = z.link[c];
        }
        z.lastdata = (uint8_t)c;
        if (z.next < kTable) {
          z.data[z.next] = (uint8_t)c;
          z.link[z.next] = (uint16_t)z.lastcode;
          if (z.next == z.codemask && z.codesize < kMaxBits) {
            z.codesize++;
            z.codemask = (1 << z.codesize) - 1;
          }
          z.next++;
        }
        z.lastcode = thiscode;
      }
      out = &z.lastdata;
      n = 1;
    }
    for (int i = 0; i < n; i++)
      if (!cur.put(out[i])) {
        *pos = p;
        return DONE;
      }
  }
}

}  // namespace

extern "C" {

// Decode the LZW data at data[offset:] (minimum code size `bits`) into the
// rectangle (x0, y0) + xsize x ysize of a W x H canvas of `fill`, then map
// the canvas through the 256-entry `lut` into out (uint8 [H, W]).  Returns
// OK or BROKEN with the reason in msg.
int gif_decode(const uint8_t* data, size_t n, size_t offset, int bits, int interlace, int x0,
               int y0, int xsize, int ysize, int W, int H, int fill, const uint8_t* lut,
               uint8_t* out, char* msg, int msg_len) {
  try {
    std::memset(out, fill, (size_t)W * H);
    size_t pos = offset < n ? offset : n, avail = pos + kBlock < n ? pos + kBlock : n;
    if (pos == avail) fail("image file is truncated (0 bytes not processed)");
    if (bits < 0 || bits > 12) fail("codec configuration error when reading image file");
    Lzw z;
    z.bits = bits;
    z.clear = 1 << bits;
    z.end = z.clear + 1;
    z.state = 1;
    Cursor cur{out, W, x0, y0, xsize, ysize};
    if (interlace) {
      cur.interlace = 1;
      cur.step = 8;
    }
    while (decode(z, cur, data, avail, &pos) != DONE) {
      if (avail >= n)
        fail("image file is truncated (" + std::to_string(n - pos) + " bytes not processed)");
      avail = avail + kBlock < n ? avail + kBlock : n;
    }
    for (size_t i = 0; i < (size_t)W * H; i++) out[i] = lut[out[i]];
    return OK;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_len, "%s", f.msg.c_str());
    return f.code;
  }
}

}  // extern "C"
