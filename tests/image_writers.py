"""Image files written by hand, in the kinds PIL reads and does not write:
Adam7-interlaced and 16-bit PNG with every filter type, BMP of 1 to 32 bits
with BI_BITFIELDS and RLE8/RLE4, the PNM variants, byte edits of JPEG
files (scans cut, the Adobe transform, the frame's marker and precision),
lossless WebP (:func:`webp_lossless`), WebP containers (RIFF, VP8X, ANMF
chunks) and VP8 key frames of random syntax (:func:`vp8_random_frame`).

numpy, zlib and struct only: the decode tests, ``tests/loader_fixtures.py``
and ``chip_smoke.py`` (whose card machine has no PIL) write with these.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# (x0, y0, dx, dy) of each Adam7 pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples as PNG bytes: big-endian at 16 bits, packed from
    the high bit below 8."""
    samples = np.asarray(samples, np.int64).ravel()
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    per = 8 // depth
    out = np.zeros((len(samples) + per - 1) // per, np.int64)
    for i in range(per):
        part = samples[i::per]
        out[:len(part)] |= part << (8 - depth * (i + 1))
    return out.astype(np.uint8).tobytes()


def _filter(row: bytes, prev: bytes, bpp: int, kind: int) -> bytes:
    """``row`` filtered with PNG filter ``kind`` against ``prev``."""
    r = np.frombuffer(row, np.uint8).astype(np.int64)
    b = np.frombuffer(prev, np.uint8).astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])[:len(r)]
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([kind]) + ((r - pred) & 255).astype(np.uint8).tobytes()


def png(img: np.ndarray, depth: int = 8, color_type: Optional[int] = None, palette: bytes = b"",
        interlace: bool = False, extra: bytes = b"", first_filter: int = 0) -> bytes:
    """A PNG of ``img`` (samples [H, W] or [H, W, C] below 2**depth),
    Adam7-interlaced if asked, its rows filtered with each of the five
    filter types in turn; ``extra`` chunks (tRNS) go before IDAT."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if color_type is None:
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    if PNG_CHANNELS[color_type] != ch:
        raise ValueError(f"colour type {color_type} takes {PNG_CHANNELS[color_type]} channels")
    bpp = max(1, ch * depth // 8)
    raw, kind = [], first_filter
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:  # an empty pass: no rows, no filter bytes
            continue
        rows = [_pack(r, depth) for r in sub]
        prev = bytes(len(rows[0]))
        for r in rows:
            raw.append(_filter(r, prev, bpp, kind % 5))
            prev, kind = r, kind + 1
    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace))
    return (PNG_MAGIC + png_chunk(b"IHDR", header)
            + (png_chunk(b"PLTE", palette) if palette else b"") + extra
            + png_chunk(b"IDAT", zlib.compress(b"".join(raw))) + png_chunk(b"IEND", b""))


def pack_bits(idx: Sequence[int], bits: int) -> bytes:
    """Palette indices of one row at 1, 4 or 8 bits a pixel, high bits first."""
    return _pack(np.asarray(idx), bits)


def bmp(width: int, height: int, bits: int, rows: Optional[List[bytes]] = None,
        palette: Optional[Sequence[Tuple[int, int, int]]] = None, compression: int = 0,
        header: int = 40, masks: Optional[Sequence[int]] = None, top_down: bool = False,
        data: Optional[bytes] = None, offset: Optional[int] = None) -> bytes:
    """A BMP: ``rows`` of packed pixel bytes top row first (padded to the
    4-byte stride and stored bottom-up unless ``top_down``), or the pixel
    ``data`` as it is (RLE streams); ``palette`` of (r, g, b); a header of
    12, 40, 52, 56, 64, 108 or 124 bytes; BI_BITFIELDS ``masks`` after a
    40-byte header or inside a longer one (the fourth, alpha, from 56)."""
    if data is None:
        stride = ((width * bits + 31) >> 3) & ~3
        padded = [r + bytes(stride - len(r)) for r in rows]
        data = b"".join(padded if top_down else padded[::-1])
    entry = 3 if header == 12 else 4
    pal = b"".join(bytes([b, g, r]) + bytes(entry - 3) for r, g, b in (palette or ()))
    after = b""
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        hdr = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1, bits,
                          compression, len(data), 2835, 2835, len(palette or ()), 0)
        if masks is not None:
            packed = struct.pack(f"<{len(masks)}I", *masks)
            if header == 40:
                after = packed[:12]
            else:
                hdr += packed[:16 if header >= 56 else 12]
        hdr += bytes(header - len(hdr))
    start = 14 + len(hdr) + len(after) + len(pal) if offset is None else offset
    return (b"BM" + struct.pack("<IHHI", start + len(data), 0, 0, start) + hdr + after + pal
            + data)


def rle8(rows: np.ndarray) -> bytes:
    """An RLE8 stream of the index rows [H, W] (top row first): runs of two
    or more as encoded pairs, other stretches of three or more as absolute
    runs (word-aligned), an end of line after each row, end of bitmap."""
    out = bytearray()
    for r in np.asarray(rows)[::-1]:
        r = [int(v) for v in r]
        i = 0
        while i < len(r):
            j = i + 1
            while j < len(r) and r[j] == r[i] and j - i < 255:
                j += 1
            if j - i >= 2:
                out += bytes([j - i, r[i]])
                i = j
                continue
            k = i + 1
            while k < len(r) and k - i < 255 and (k + 1 >= len(r) or r[k + 1] != r[k]):
                k += 1
            if k - i >= 3:
                out += bytes([0, k - i]) + bytes(r[i:k]) + bytes((k - i) % 2)
                i = k
            else:
                out += bytes([1, r[i]])
                i += 1
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def pnm(img: np.ndarray, kind: int, maxval: int = 255, comment: bool = True) -> bytes:
    """A PNM of ``img``: P1/P4 ([H, W] of 0/1, 1 black), P2/P5 ([H, W]) or
    P3/P6 ([H, W, 3]) below ``maxval`` (binary samples big-endian 16-bit
    above 255), with a comment line in the header."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    head = f"P{kind}\n" + ("# made by hand\n" if comment else "") + f"{w} {h}\n"
    if kind in (1, 4):
        if kind == 1:
            return (head + "\n".join("".join(str(int(v)) for v in r) for r in img) + "\n").encode()
        return head.encode() + b"".join(np.packbits(r.astype(np.uint8)).tobytes() for r in img)
    head += f"{maxval}\n"
    if kind in (2, 3):
        lines = [" ".join(str(int(v)) for v in r.ravel()) for r in img]
        return (head + "\n".join(lines) + "\n").encode()
    return head.encode() + img.astype(np.uint8 if maxval < 256 else ">u2").tobytes()


# ---------------------------------------------------------------- JPEG edits

def jpeg_segments(data: bytes) -> List[Tuple[int, int, int]]:
    """(marker, start, end) of each marker segment up to EOI; a scan's
    segment runs to the end of its entropy-coded data."""
    out, pos = [], 2
    while pos < len(data):
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        m, start = data[pos], pos - 1
        pos += 1
        if m == 0xD9:
            out.append((m, start, pos))
            break
        if 0xD0 <= m <= 0xD7 or m in (0x01, 0xD8):
            continue
        end = pos + struct.unpack(">H", data[pos:pos + 2])[0]
        if m == 0xDA:  # on past the entropy-coded data and its restart markers
            while end + 1 < len(data) and not (data[end] == 0xFF and data[end + 1] not in (
                    0x00, 0xFF) and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        out.append((m, start, end))
        pos = end
    return out


def cut_scans(data: bytes, keep: int) -> bytes:
    """The JPEG with only its first ``keep`` scans (and what precedes them),
    EOI kept."""
    scans = [s for s in jpeg_segments(data) if s[0] == 0xDA]
    if keep >= len(scans):
        return data
    return data[:scans[keep][1]] + b"\xff\xd9"


def n_scans(data: bytes) -> int:
    return sum(s[0] == 0xDA for s in jpeg_segments(data))


def adobe_transform(data: bytes, transform: Optional[int]) -> bytes:
    """The JPEG with its Adobe APP14 marker's transform byte set, or with
    the marker taken out (``None``)."""
    for m, start, end in jpeg_segments(data):
        if m == 0xEE and data[start + 4:start + 9] == b"Adobe":
            if transform is None:
                return data[:start] + data[end:]
            return data[:start + 15] + bytes([transform]) + data[start + 16:]
    raise ValueError("no Adobe marker")


def retag_frame(data: bytes, marker: Optional[int] = None, precision: Optional[int] = None) -> bytes:
    """The JPEG with its frame header's marker (SOFn) or sample precision
    replaced."""
    for m, start, _ in jpeg_segments(data):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            d = bytearray(data)
            if marker is not None:
                d[start + 1] = marker
            if precision is not None:
                d[start + 4] = precision
            return bytes(d)
    raise ValueError("no frame header")


# --- WebP -------------------------------------------------------------------------


def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk: its fourcc, its size and the payload, padded to even."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def webp_file(chunks: Sequence[bytes]) -> bytes:
    """``RIFF <size> WEBP`` and the chunks."""
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x_chunk(width: int, height: int, flags: int) -> bytes:
    """The extended header: ``flags`` (0x02 animation, 0x04 XMP, 0x08 EXIF,
    0x10 alpha, 0x20 ICC) and the canvas size."""
    return webp_chunk(b"VP8X", struct.pack("<I", flags) + (width - 1).to_bytes(3, "little")
                      + (height - 1).to_bytes(3, "little"))


def anmf_chunk(x: int, y: int, width: int, height: int, frame: bytes, duration: int = 100,
               bits: int = 0) -> bytes:
    """An animation frame at (x, y) (even) of width x height whose
    ``frame`` holds its ALPH/VP8/VP8L chunks."""
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, width - 1, height - 1,
                                                       duration))
    return webp_chunk(b"ANMF", head + bytes([bits]) + frame)


class _Bits:
    """An LSB-first bit stream, the order VP8L reads."""

    def __init__(self):
        self.values: List[np.ndarray] = []
        self.lengths: List[np.ndarray] = []

    def put(self, value, n) -> None:
        self.values.append(np.atleast_1d(np.asarray(value, np.int64)))
        self.lengths.append(np.broadcast_to(np.asarray(n, np.int64),
                                            self.values[-1].shape).copy())

    def tobytes(self) -> bytes:
        v, n = np.concatenate(self.values), np.concatenate(self.lengths)
        pos = np.concatenate([[0], np.cumsum(n)[:-1]])
        total = int(n.sum())
        bits = np.zeros(total + 7, np.uint8)
        for k in range(int(n.max(initial=0))):
            on = n > k
            bits[pos[on] + k] = (v[on] >> k) & 1
        return np.packbits(bits[:total + (-total) % 8], bitorder="little").tobytes()


def _code_lengths(counts: np.ndarray, limit: int) -> np.ndarray:
    """Huffman code lengths of at most ``limit`` bits for the symbol
    ``counts`` (at least two symbols used), flattening the counts until
    the longest code fits."""
    import heapq

    counts = np.asarray(counts, np.int64)
    while True:
        heap = [(int(c), int(s), [int(s)]) for s, c in enumerate(counts) if c > 0]
        heapq.heapify(heap)
        lengths = np.zeros(len(counts), np.int64)
        while len(heap) > 1:
            c1, t1, s1 = heapq.heappop(heap)
            c2, t2, s2 = heapq.heappop(heap)
            lengths[s1 + s2] += 1
            heapq.heappush(heap, (c1 + c2, min(t1, t2), s1 + s2))
        if lengths.max() <= limit:
            return lengths
        counts = np.where(counts > 0, np.maximum(counts >> 1, 1), 0)


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """The canonical codes of ``lengths``, bit-reversed for an LSB-first
    stream."""
    codes = np.zeros(len(lengths), np.int64)
    code = 0
    for n in range(1, 16):
        for s in np.flatnonzero(lengths == n):
            codes[s] = int(format(code, f"0{n}b")[::-1], 2)
            code += 1
        code <<= 1
    return codes


def _prefix_code(bits: _Bits, counts: np.ndarray):
    """Write the prefix code for the symbol ``counts``; returns (codes,
    lengths) to write the symbols with.  One used symbol (or none): the
    simple code; else a normal code whose code lengths are coded with a
    code-length code (no repeat codes)."""
    used = np.flatnonzero(counts)
    if len(used) <= 1:
        s = int(used[0]) if len(used) else 0
        bits.put([1, 0, int(s > 1)], [1, 1, 1])
        bits.put(s, 8 if s > 1 else 1)
        return np.zeros(len(counts), np.int64), np.zeros(len(counts), np.int64)
    lengths = _code_lengths(counts, 15)
    cl_counts = np.bincount(lengths, minlength=19)
    if np.count_nonzero(cl_counts) == 1:
        cl_lengths = (cl_counts > 0).astype(np.int64)  # one symbol: no bits
    else:
        cl_lengths = _code_lengths(cl_counts, 7)
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    n = max(4, max(i + 1 for i, s in enumerate(order) if cl_lengths[s]))
    bits.put([0, n - 4], [1, 4])
    bits.put([cl_lengths[s] for s in order[:n]], 3)
    bits.put(0, 1)  # every symbol's length is coded
    if np.count_nonzero(cl_counts) > 1:  # else the one code length takes no bits
        bits.put(_canonical_codes(cl_lengths)[lengths], cl_lengths[lengths])
    return _canonical_codes(lengths), lengths


def _entropy_image(bits: _Bits, argb: np.ndarray, main: bool = False) -> None:
    """The pixels ``argb`` (uint32, flat) as literals: no colour cache (and
    for the ``main`` image one group of prefix codes), the five prefix
    codes, then green, red, blue and alpha of each pixel."""
    bits.put(0, 1)  # no colour cache
    if main:
        bits.put(0, 1)  # no entropy image: one group of codes
    chans = [(argb >> 8) & 0xff, (argb >> 16) & 0xff, argb & 0xff, argb >> 24]
    sizes = (280, 256, 256, 256, 40)
    table = []
    for ch, size in zip(chans + [None], sizes):
        counts = np.zeros(size, np.int64) if ch is None else np.bincount(ch, minlength=size)
        table.append(_prefix_code(bits, counts))
    vals = np.stack([table[j][0][c] for j, c in enumerate(chans)], 1)
    lens = np.stack([table[j][1][c] for j, c in enumerate(chans)], 1)
    bits.put(vals.ravel(), lens.ravel())


def _avg(a, b):
    return (a + b) >> 1


def _predictions(p: np.ndarray) -> List[np.ndarray]:
    """The 14 VP8L predictors of every pixel of ``p`` (int64 [H, W, 4], one
    channel a byte) from its left, top, top-left and top-right neighbours
    (the top-right of the last column is the row's first pixel)."""
    L = np.roll(p, 1, axis=1)
    T = np.roll(p, 1, axis=0)
    TL = np.roll(T, 1, axis=1)
    TR = np.roll(T, -1, axis=1)
    TR[:, -1] = p[:, 0]
    black = np.zeros_like(p)
    black[..., 3] = 255
    sel = np.abs(L - TL).sum(-1, keepdims=True) - np.abs(T - TL).sum(-1, keepdims=True)
    a = _avg(L, T)
    return [black, L, T, TR, TL, _avg(_avg(L, TR), T), _avg(L, TL), _avg(L, T), _avg(TL, T),
            _avg(T, TR), _avg(_avg(L, TL), _avg(T, TR)), np.where(sel <= 0, T, L),
            np.clip(L + T - TL, 0, 255),
            np.clip(a + np.trunc((a - TL) / 2).astype(np.int64), 0, 255)]


def webp_lossless(img: np.ndarray, size_bits: int = 4) -> bytes:
    """``img`` (uint8 [H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA) as a
    lossless WebP (VP8L): the subtract-green transform, then the predictor
    transform with each ``2**size_bits`` tile's mode the one of the 14 with
    the smallest residuals, then Huffman-coded literals.  Reads back as
    ``img`` exactly (PIL and ``data/images``)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, 2)
    h, w = img.shape[:2]
    alpha = img[..., 3] if img.shape[2] == 4 else np.full((h, w), 255, np.uint8)
    # ARGB planes as (B, G, R, A) bytes, green subtracted from red and blue
    p = np.stack([img[..., 2], img[..., 1], img[..., 0], alpha], -1).astype(np.int64)
    p[..., 0] = (p[..., 0] - p[..., 1]) & 0xff
    p[..., 2] = (p[..., 2] - p[..., 1]) & 0xff
    preds = _predictions(p)
    res = [(p - q) & 0xff for q in preds]
    cost = [np.minimum(r, 256 - r).sum(-1) for r in res]
    tile = 1 << size_bits
    th, tw = -(-h // tile), -(-w // tile)
    pad = lambda c: np.pad(c, ((0, th * tile - h), (0, tw * tile - w)))
    tiles = np.stack([pad(c).reshape(th, tile, tw, tile).sum((1, 3)) for c in cost])
    modes = tiles.argmin(0)
    mode_px = np.repeat(np.repeat(modes, tile, 0), tile, 1)[:h, :w]
    mode_px[0, :] = 1  # the top row predicts from the left
    mode_px[:, 0] = 2  # the left column from the top
    mode_px[0, 0] = 0  # the first pixel from black
    r = np.take_along_axis(np.stack(res), mode_px[None, :, :, None], 0)[0]
    argb = (r[..., 3] << 24) | (r[..., 2] << 16) | (r[..., 1] << 8) | r[..., 0]
    bits = _Bits()
    bits.put([0x2f, w - 1, h - 1, int((alpha != 255).any()), 0], [8, 14, 14, 1, 3])
    bits.put([1, 2], [1, 2])  # subtract green
    bits.put([1, 0, size_bits - 2], [1, 2, 3])  # predictor, its tile size
    _entropy_image(bits, (modes.ravel().astype(np.int64) << 8))
    bits.put(0, 1)  # no more transforms
    _entropy_image(bits, argb.ravel(), main=True)
    return webp_file([webp_chunk(b"VP8L", bits.tobytes())])


class BoolWriter:
    """The VP8 boolean entropy encoder (RFC 6386, 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def signed(self, v: int, n: int) -> None:
        self.value(abs(v), n)
        self.put(int(v < 0), 128)

    def flag_signed(self, v: int, n: int) -> None:
        """A field present only when non-zero: its flag, then the value."""
        self.put(int(v != 0), 128)
        if v:
            self.signed(v, n)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


# libwebp's order of the 4x4 modes (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
# and the bits of each on the key-frame tree, node by node: (probability
# index, bit)
_BMODE_BITS = ([(0, 0)], [(0, 1), (1, 0)], [(0, 1), (1, 1), (2, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 0), (4, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)],
               [(0, 1), (1, 1), (2, 1), (3, 1), (6, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1)])
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _large_value(bw: BoolWriter, v: int, p) -> None:
    """GetLargeValue's bits for v >= 2."""
    if v <= 4:
        bw.put(0, p[3])
        bw.put(int(v > 2), p[4])
        if v > 2:
            bw.put(v - 3, p[5])
    elif v <= 10:
        bw.put(1, p[3])
        bw.put(0, p[6])
        bw.put(int(v > 6), p[7])
        if v <= 6:
            bw.put(v - 5, 159)
        else:
            bw.put((v - 7) >> 1, 165)
            bw.put((v - 7) & 1, 145)
    else:
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        bw.put(1, p[3])
        bw.put(1, p[6])
        bw.put(cat >> 1, p[8])
        bw.put(cat & 1, p[9 + (cat >> 1)])
        extra, probs = v - 3 - (8 << cat), _CATS[cat]
        for k, prob in enumerate(probs):
            bw.put((extra >> (len(probs) - 1 - k)) & 1, prob)


def _tokens(bw: BoolWriter, probas, ctx: int, first: int, levels, to_end: bool) -> int:
    """One block's tokens (``levels`` in zigzag order) from position
    ``first``; ``to_end`` ends a block with a run of zeros to position 16
    where an EOB would do (libwebp reads both).  Returns what libwebp's
    GetCoeffs returns: the position after the last token."""
    nz = [i for i in range(first, 16) if levels[i]]
    last = nz[-1] if nz else -1
    n, p = first, probas[_BANDS[first]][ctx]
    while n < 16:
        if n > last and not (to_end and n < 16):
            bw.put(0, p[0])  # end of block
            return n
        bw.put(1, p[0])
        while not levels[n]:
            bw.put(0, p[1])
            n += 1
            if n == 16:
                return 16
            p = probas[_BANDS[n]][0]
        bw.put(1, p[1])
        v = abs(int(levels[n]))
        if v == 1:
            bw.put(0, p[2])
        else:
            bw.put(1, p[2])
            _large_value(bw, v, p)
        bw.put(int(levels[n] < 0), 128)
        n += 1
        p = probas[_BANDS[n]][1 if v == 1 else 2]
    return 16


def vp8_random_frame(width: int, height: int, seed: int, tables, **opts) -> bytes:
    """A VP8 key frame of random but valid syntax (RFC 6386), its header
    switches drawn from ``seed`` unless ``opts`` sets them: segments with a
    map and absolute or relative quantizers and filter levels, the simple
    or the normal loop filter with sharpness and mode deltas, 1, 2, 4 or 8
    token partitions, quantizer deltas, coefficient probability updates,
    the skip flag on or off, every 16x16, 4x4 and chroma mode, levels up to
    DCT_CAT6's 2114.  ``tables`` gives RFC 6386's (coeff_update, coeff,
    bmode) probabilities as nested lists [4][8][3][11], [4][8][3][11] and
    [10][10][9] (the 4x4 modes in libwebp's order).  Returns the frame
    (the payload of a ``VP8 `` chunk)."""
    update_probs, default_probs, bmode_probs = tables
    rng = np.random.default_rng(seed)
    o = dict(
        segments=bool(rng.random() < 0.6), update_map=bool(rng.random() < 0.7),
        absolute=bool(rng.random() < 0.5), simple=bool(rng.random() < 0.4),
        level=int(rng.integers(0, 64)), sharpness=int(rng.integers(0, 8)),
        lf_delta=bool(rng.random() < 0.5), partitions=int(rng.integers(0, 4)),
        skip=bool(rng.random() < 0.5), base_q=int(rng.integers(0, 128)),
        big=float(rng.choice([0.0, 0.02, 0.2])), profile=int(rng.integers(0, 4)))
    o.update(opts)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    bw = BoolWriter()
    bw.put(int(rng.integers(0, 2)), 128)  # colour space
    bw.put(int(rng.integers(0, 2)), 128)  # clamping type
    bw.put(int(o["segments"]), 128)
    seg_probs = [255, 255, 255]
    if o["segments"]:
        bw.put(int(o["update_map"]), 128)
        update_data = bool(rng.random() < 0.8)
        bw.put(int(update_data), 128)
        if update_data:
            bw.put(int(o["absolute"]), 128)
            for _ in range(4):
                bw.flag_signed(int(rng.integers(-127, 128)) * int(rng.random() < 0.8), 7)
            for _ in range(4):
                bw.flag_signed(int(rng.integers(-63, 64)) * int(rng.random() < 0.8), 6)
        if o["update_map"]:
            for s in range(3):
                seg_probs[s] = int(rng.integers(0, 256)) if rng.random() < 0.8 else 255
                bw.put(int(seg_probs[s] != 255), 128)
                if seg_probs[s] != 255:
                    bw.value(seg_probs[s], 8)
    bw.put(int(o["simple"]), 128)
    bw.value(o["level"], 6)
    bw.value(o["sharpness"], 3)
    bw.put(int(o["lf_delta"]), 128)
    if o["lf_delta"]:
        update = bool(rng.random() < 0.8)
        bw.put(int(update), 128)
        if update:
            for _ in range(8):
                bw.flag_signed(int(rng.integers(-63, 64)) * int(rng.random() < 0.6), 6)
    bw.value(o["partitions"], 2)
    bw.value(o["base_q"], 7)
    for _ in range(5):  # y1 dc, y2 dc, y2 ac, uv dc, uv ac deltas
        bw.flag_signed(int(rng.integers(-15, 16)) * int(rng.random() < 0.5), 4)
    bw.put(int(rng.integers(0, 2)), 128)  # refresh entropy probabilities
    probas = [[[list(c) for c in b] for b in t] for t in default_probs]
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    upd = bool(rng.random() < 0.15)
                    bw.put(int(upd), update_probs[t][b][c][p])
                    if upd:
                        probas[t][b][c][p] = int(rng.integers(0, 256))
                        bw.value(probas[t][b][c][p], 8)
    bw.put(int(o["skip"]), 128)
    skip_prob = int(rng.integers(0, 256))
    if o["skip"]:
        bw.value(skip_prob, 8)

    parts = [BoolWriter() for _ in range(1 << o["partitions"])]
    intra_t = [0] * (4 * mb_w)
    nz_top = [[0, 0] for _ in range(mb_w)]  # (nz, nz_dc) a column
    for mb_y in range(mb_h):
        intra_l = [0] * 4
        blocks = []
        for mb_x in range(mb_w):  # the modes, in the first partition
            if o["segments"] and o["update_map"]:
                seg = int(rng.integers(0, 4))
                bw.put(seg >> 1, seg_probs[0])
                bw.put(seg & 1, seg_probs[1 + (seg >> 1)])
            skipped = bool(o["skip"] and rng.random() < 0.3)
            if o["skip"]:
                bw.put(int(skipped), skip_prob)
            i4x4 = bool(rng.random() < 0.5)
            bw.put(int(not i4x4), 145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not i4x4:
                ymode = int(rng.integers(0, 4))  # DC, TM, VE, HE
                bits = {0: [(156, 0), (163, 0)], 2: [(156, 0), (163, 1)],
                        3: [(156, 1), (128, 0)], 1: [(156, 1), (128, 1)]}[ymode]
                for prob, bit in bits:
                    bw.put(bit, prob)
                top, intra_l = [ymode] * 4, [ymode] * 4
            else:
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        mode = int(rng.integers(0, 10))
                        for k, bit in _BMODE_BITS[mode]:
                            bw.put(bit, bmode_probs[top[x]][left][k])
                        top[x] = left = mode
                    intra_l[y] = left
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            uv = int(rng.integers(0, 4))
            for prob, bit in {0: [(142, 0)], 2: [(142, 1), (114, 0)],
                              1: [(142, 1), (114, 1), (183, 1)],
                              3: [(142, 1), (114, 1), (183, 0)]}[uv]:
                bw.put(bit, prob)
            blocks.append((i4x4, skipped))
        part = parts[mb_y & (len(parts) - 1)]
        left = [0, 0]
        for mb_x, (i4x4, skipped) in enumerate(blocks):  # the tokens
            top = nz_top[mb_x]
            if skipped:
                top[0] = left[0] = 0
                if not i4x4:
                    top[1] = left[1] = 0
                continue

            def levels(n_first):
                lv = np.zeros(16, np.int64)
                count = int(rng.integers(0, 17 - n_first)) if rng.random() < 0.8 else 0
                for i in rng.choice(np.arange(n_first, 16), count, replace=False):
                    lv[i] = int(rng.integers(1, 12)) if rng.random() > o["big"] else int(
                        rng.integers(12, 2115))
                    lv[i] *= 1 if rng.random() < 0.5 else -1
                return lv

            to_end = lambda: bool(rng.random() < 0.1)  # noqa: E731
            first = 0
            if not i4x4:
                nz = _tokens(part, probas[1], top[1] + left[1], 0, levels(0), to_end())
                top[1] = left[1] = int(nz > 0)
                first = 1
            tnz, lnz = top[0] & 0x0f, left[0] & 0x0f
            for y in range(4):
                lbit = lnz & 1
                for x in range(4):
                    nz = _tokens(part, probas[0 if not i4x4 else 3], lbit + (tnz & 1), first,
                                 levels(first), to_end())
                    lbit = int(nz > first)
                    tnz = (tnz >> 1) | (lbit << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (lbit << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top[0] >> (4 + ch), left[0] >> (4 + ch)
                for y in range(2):
                    lbit = lnz & 1
                    for x in range(2):
                        nz = _tokens(part, probas[2], lbit + (tnz & 1), 0, levels(0), to_end())
                        lbit = int(nz > 0)
                        tnz = (tnz >> 1) | (lbit << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (lbit << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xf0) << ch
            top[0], left[0] = out_t & 0xff, out_l & 0xff
    first_part = bw.finish()
    token_parts = [p.finish() for p in parts]
    tag = (o["profile"] << 1) | (1 << 4) | (len(first_part) << 5)  # key frame, shown
    head = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", width, height)
    sizes = b"".join(struct.pack("<I", len(p))[:3] for p in token_parts[:-1])
    return head + first_part + sizes + b"".join(token_parts)


# --- GIF --------------------------------------------------------------------------


def gif_lzw(indices, bits: int, clear_after: Optional[int] = None, defer: bool = False,
            eoi: bool = True, lead_clear: bool = True) -> bytes:
    """GIF's LZW code stream of ``indices`` (ints below ``2**bits``) at the
    minimum code size ``bits``, packed LSB first: a clear code first
    (``lead_clear``), another after every ``clear_after`` codes (an early
    clear), and at a full table of 4096 codes either a clear or, with
    ``defer``, none (the deferred clear: 12-bit codes go on, no entry is
    added); the end code last (``eoi``)."""
    clear, end = 1 << bits, (1 << bits) + 1
    acc = nacc = 0
    out = bytearray()

    def emit(code, size):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    idx = [int(v) for v in np.asarray(indices).ravel()]
    table, nxt, size, since = {}, end + 1, bits + 1, 0
    if lead_clear:
        emit(clear, size)
    prefix = idx[0] if idx else None
    for px in idx[1:]:
        key = (prefix, px)
        if key in table:
            prefix = table[key]
            continue
        emit(prefix, size)
        since += 1
        if clear_after is not None and since >= clear_after:
            emit(clear, size)
            table, nxt, size, since = {}, end + 1, bits + 1, 0
        elif nxt < 4096:
            if nxt >= (1 << size) and size < 12:
                size += 1
            table[key] = nxt
            nxt += 1
        elif not defer:
            emit(clear, size)
            table, nxt, size, since = {}, end + 1, bits + 1, 0
        prefix = px
    if prefix is not None:
        emit(prefix, size)
        if nxt < 4096 and nxt >= (1 << size) and size < 12:
            size += 1
    if eoi:
        emit(end, size)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_blocks(data: bytes, size: int = 255, terminator: bool = True) -> bytes:
    """``data`` in GIF sub-blocks of at most ``size`` bytes, and the empty
    block that ends them."""
    out = b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                   for i in range(0, len(data), size))
    return out + (b"\x00" if terminator else b"")


def _gif_table(palette: bytes) -> int:
    n = len(palette) // 3
    bits = max(1, (n - 1).bit_length())
    if 3 << bits != len(palette) - len(palette) % 3 or len(palette) % 3:
        raise ValueError(f"a GIF colour table holds 2**k RGB entries, got {len(palette)} bytes")
    return bits - 1


def gif_frame(indices: np.ndarray, x: int = 0, y: int = 0, palette: Optional[bytes] = None,
              interlace: bool = False, transparency: Optional[int] = None,
              code_size: Optional[int] = None, data: Optional[bytes] = None,
              block: int = 255, **lzw) -> bytes:
    """One GIF image: a graphic-control extension where ``transparency`` is
    given, the image descriptor at (x, y) with ``indices``' size, a local
    colour table (``palette``, RGB bytes of 2**k entries), the minimum code
    size (``code_size``, else the table's bits, at least 2) and the LZW
    data (``data`` instead of ``indices`` coded, in sub-blocks of
    ``block`` bytes).  Interlaced frames are coded in GIF's four passes."""
    indices = np.asarray(indices)
    h, w = indices.shape
    out = b""
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1]) + struct.pack("<H", 10) + bytes([transparency]) + b"\x00"
    flags = (0x40 if interlace else 0)
    if palette is not None:
        flags |= 0x80 | _gif_table(palette)
    out += b"," + struct.pack("<HHHHB", x, y, w, h, flags) + (palette or b"")
    if code_size is None:
        code_size = max(2, int(indices.max(initial=0)).bit_length())
    if data is None:
        rows = indices
        if interlace:
            order = [r for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                     for r in range(start, h, step)]
            rows = indices[order]
        data = gif_lzw(rows, code_size, **lzw)
    return out + bytes([code_size]) + gif_blocks(data, block)


def gif_extension(label: int, *blocks: bytes) -> bytes:
    """An extension: its label and ``blocks`` as sub-blocks, then the end."""
    return b"!" + bytes([label]) + b"".join(bytes([len(b)]) + b for b in blocks) + b"\x00"


def gif(width: int, height: int, frames: Sequence[bytes], palette: Optional[bytes] = None,
        version: bytes = b"GIF89a", background: int = 0, trailer: bool = True) -> bytes:
    """A GIF file: the screen of width x height with a global colour table
    (``palette``), then ``frames`` (:func:`gif_frame`, :func:`gif_extension`
    or any bytes) and the trailer."""
    flags = 0x70
    if palette is not None:
        flags |= 0x80 | _gif_table(palette)
    head = version + struct.pack("<HHBBB", width, height, flags, background, 0)
    return head + (palette or b"") + b"".join(frames) + (b";" if trailer else b"")


def grey_ramp(n: int) -> bytes:
    """The identity grey palette of ``n`` entries, which PIL's GIF reader
    drops (the indices become the pixels)."""
    return bytes(v for i in range(n) for v in (i, i, i))


# --- TIFF -------------------------------------------------------------------------


def tiff_lzw(data: bytes) -> bytes:
    """TIFF's LZW of ``data`` as libtiff writes it: a clear code first,
    codes MSB first from 9 bits (one entry ahead of the decoder, so the
    decoder's early change), a clear when the table reaches 4094, and the
    end code."""
    acc = nacc = 0
    out = bytearray()

    def emit(code, size):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    table, nxt, size = {}, 258, 9
    emit(256, size)
    prefix = None
    for b in data:
        key = (prefix, b)
        if prefix is None:
            prefix = b
            continue
        if key in table:
            prefix = table[key]
            continue
        emit(prefix, size)
        table[key] = nxt
        nxt += 1
        if nxt == 4094:
            emit(256, size)
            table, nxt, size = {}, 258, 9
        elif nxt >= (1 << size):
            size += 1
        prefix = b
    if prefix is not None:
        emit(prefix, size)
        nxt += 1
        if nxt != 4094 and nxt >= (1 << size):
            size += 1
    emit(257, size)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return tiff_lzw(raw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return packbits(raw)
    if compression == 34925:
        import lzma

        return lzma.compress(raw, format=lzma.FORMAT_XZ)
    raise ValueError(f"compression {compression}")


def _tiff_rows(samples: np.ndarray, bits: int, order: str, predictor: int) -> np.ndarray:
    """[H, W, S] samples -> packed row bytes [H, B], horizontal differences
    taken first for predictor 2."""
    h, w, s = samples.shape
    v = samples.astype(np.int64)
    if predictor == 2:
        v = np.concatenate([v[:, :1], np.diff(v, axis=1)], axis=1) % (1 << bits)
    flat = v.reshape(h, w * s)
    if bits == 16:
        return flat.astype(order + "u2").view(np.uint8).reshape(h, -1)
    if bits == 8:
        return flat.astype(np.uint8)
    msb = (flat[:, :, None] >> np.arange(bits - 1, -1, -1)) & 1  # each sample's bits, high first
    return np.packbits(msb.reshape(h, -1).astype(np.uint8), axis=1)


def tiff(samples: np.ndarray, bits: int = 8, photometric: int = 1, compression: int = 1,
         order: str = "<", bigtiff: bool = False, magic: Optional[bytes] = None,
         rows_per_strip: Optional[int] = None, tile: Optional[Tuple[int, int]] = None,
         planar: int = 1, predictor: int = 1, fill_order: int = 1,
         colormap: Optional[np.ndarray] = None, extra_samples: Sequence[int] = (),
         tags: Optional[dict] = None, strips: Optional[List[bytes]] = None) -> bytes:
    """A TIFF of one image: ``samples`` [H, W] or [H, W, S] (uint8 or uint16
    values below ``2**bits``) as strips of ``rows_per_strip`` rows or tiles
    of ``tile`` = (width, length), chunky or planar (``planar`` 2),
    compressed (1 none, 5 LZW, 8 / 32946 Deflate, 32773 PackBits, 34925
    LZMA), with horizontal differencing (``predictor`` 2) and the bits of
    each compressed byte reversed (``fill_order`` 2); II (``order`` "<") or
    MM (">"), classic or BigTIFF, its first four bytes ``magic`` where
    given; ``colormap`` [3, 2**bits] of 16-bit values; ``tags`` {tag: (type,
    values)} added or put in place; ``strips`` instead of the coded
    samples."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, s = samples.shape
    tw, th = tile if tile else (w, rows_per_strip or h)
    planes = [samples[:, :, i:i + 1] for i in range(s)] if planar == 2 else [samples]
    segments = []
    for plane in planes:
        if tile:
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, plane.shape[2]), plane.dtype)
            padded[:h, :w] = plane
            for ty in range(0, padded.shape[0], th):
                for tx in range(0, padded.shape[1], tw):
                    segments.append(padded[ty:ty + th, tx:tx + tw])
        else:
            for y in range(0, h, th):
                segments.append(plane[y:y + th])
    if strips is None:
        strips = []
        for seg in segments:
            raw = _tiff_rows(seg, bits, order, predictor).tobytes()
            data = _tiff_compress(raw, compression)
            if fill_order == 2:
                data = bytes(int(f"{b:08b}"[::-1], 2) for b in data)
            strips.append(data)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * s), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [s]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap).ravel()))
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    off_tag, count_tag = (324, 325) if tile else (273, 279)
    if tile:
        entries[322], entries[323] = (4, [tw]), (4, [th])
    else:
        entries[278] = (4, [th])
    entries.update(tags or {})
    head = 16 if bigtiff else 8
    body = bytearray()
    offsets = []
    for data in strips:
        offsets.append(head + len(body))
        body += data + b"\0" * (len(data) & 1)
    long_type = 16 if bigtiff else 4
    entries[off_tag] = (long_type, offsets)
    entries[count_tag] = (long_type, [len(d) for d in strips])
    sizes = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 16: 8}
    codes = {1: "B", 2: "B", 3: "H", 4: "L", 16: "Q", 7: "B"}
    ifd_at = head + len(body)
    entry_size, inline = (20, 8) if bigtiff else (12, 4)
    extra_at = ifd_at + (8 if bigtiff else 2) + entry_size * len(entries) + (8 if bigtiff else 4)
    ifd, extra = bytearray(), bytearray()
    ifd += struct.pack(order + ("Q" if bigtiff else "H"), len(entries))
    for tag in sorted(entries):
        typ, values = entries[tag]
        if isinstance(values, (bytes, bytearray)):
            blob = bytes(values)
        elif typ == 5:
            blob = b"".join(struct.pack(order + "LL", *v) for v in values)
        else:
            blob = struct.pack(f"{order}{len(values)}{codes[typ]}", *values)
        count = len(blob) // sizes[typ]
        if len(blob) <= inline:
            value = blob + b"\0" * (inline - len(blob))
        else:
            value = struct.pack(order + ("Q" if bigtiff else "L"), extra_at + len(extra))
            extra += blob + b"\0" * (len(blob) & 1)
        ifd += struct.pack(order + ("HHQ" if bigtiff else "HHL"), tag, typ, count) + value
    ifd += b"\0" * (8 if bigtiff else 4)
    if bigtiff:
        header = (b"II" if order == "<" else b"MM") + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = (b"II" if order == "<" else b"MM") + struct.pack(order + "HL", 42, ifd_at)
    if magic is not None:
        header = magic + header[4:]
    return bytes(header + body + ifd + extra)


def jpeg_tables(jpeg: bytes) -> Tuple[bytes, bytes]:
    """A JPEG split as TIFF stores it: the tables (SOI, its DQT and DHT
    segments, EOI: the JPEGTables tag) and the abbreviated stream (SOI and
    the rest: a strip)."""
    tables, rest = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    for m, start, end in jpeg_segments(jpeg):
        if m == 0xD8:
            continue
        (tables if m in (0xDB, 0xC4) else rest).extend(jpeg[start:end])
    if not rest.endswith(b"\xff\xd9"):
        rest += b"\xff\xd9"
    return bytes(tables) + b"\xff\xd9", bytes(rest)


def jpeg_tiff(strips: Sequence[bytes], width: int, height: int, rows_per_strip: int,
              order: str = "<", split_tables: bool = True) -> bytes:
    """A JPEG-compressed TIFF (compression 7) of baseline JPEG ``strips``,
    each ``rows_per_strip`` rows of the image (the last one may be cut):
    YCbCr (PhotometricInterpretation 6, YCbCrSubSampling from the first
    component's sampling) for 3 components, grey for 1; with the tables of
    the first strip in JPEGTables and taken out of every strip
    (``split_tables``), or each strip whole."""
    frame = next(s for s in jpeg_segments(strips[0]) if s[0] in (0xC0, 0xC1))
    sof = strips[0][frame[1]:frame[2]]
    nc = sof[9]
    tags = {}
    if split_tables:
        tags[347] = (7, jpeg_tables(strips[0])[0])
        strips = [jpeg_tables(s)[1] for s in strips]
    if nc == 3:
        tags[530] = (3, [sof[11] >> 4, sof[11] & 15])
    shape = (height, width) if nc == 1 else (height, width, 3)
    return tiff(np.zeros(shape, np.uint8), photometric=6 if nc == 3 else 1, compression=7,
                order=order, rows_per_strip=rows_per_strip, tags=tags, strips=list(strips))


def gif_tiff_fixtures(g: np.ndarray, page_jpeg: bytes = b"") -> dict:
    """The GIF and TIFF fixtures made by hand from the grey crop ``g`` (and
    a JPEG-compressed TIFF around the baseline 4:2:0 JPEG ``page_jpeg``):
    {name: file bytes}, the same on any machine (numpy, zlib, lzma and
    struct only)."""
    g = np.asarray(g, np.uint8)
    h, w = g.shape
    rng = np.random.default_rng(24)
    pal256 = bytes(rng.integers(0, 256, 768, dtype=np.uint8))
    pal16 = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
    rgb = np.stack([g, 255 - g, (g.astype(np.int64) * 3 % 256).astype(np.uint8)], -1)
    noise = rng.integers(0, 256, (80, 90))
    out = {
        "gif87a_global_256.gif": gif(w, h, [gif_frame(g)], palette=pal256, version=b"GIF87a"),
        "gif_local_16_interlaced.gif": gif(w, h, [gif_frame(g >> 4, palette=pal16,
                                                            interlace=True)]),
        "gif_grey_ramp.gif": gif(w, h, [gif_frame(g)], palette=grey_ramp(256)),
        "gif_ramp_2.gif": gif(w, h, [gif_frame(g >> 7, code_size=2)],
                              palette=grey_ramp(2)),
        "gif_local_ramp_over_global.gif": gif(w, h, [gif_frame(g >> 4, palette=grey_ramp(16))],
                                              palette=pal256),
        "gif_small_frame_transparent.gif": gif(w + 10, h + 6, [gif_frame(
            g >> 4, x=4, y=3, transparency=5)], palette=pal16),
        "gif_small_frame.gif": gif(w + 7, h + 5, [gif_frame(g >> 4, x=6, y=1)], palette=pal16),
        "gif_frame_past_screen.gif": gif(w // 2, h // 2, [gif_frame(g >> 4, x=3, y=2)],
                                         palette=pal16),
        "gif_code_size_3_clears.gif": gif(w, h, [gif_frame(g >> 5, code_size=3, clear_after=40)],
                                          palette=pal256[:24]),
        "gif_code_size_5_no_eoi.gif": gif(w, h, [gif_frame(g >> 3, code_size=5, eoi=False)],
                                          palette=pal256[:96]),
        "gif_code_size_7_no_lead_clear.gif": gif(w, h, [gif_frame(g >> 1, code_size=7,
                                                                  lead_clear=False)],
                                                 palette=pal256[:384]),
        "gif_index_past_palette.gif": gif(w, h, [gif_frame(g >> 6)], palette=pal16[:6]),
        "gif_table_full_cleared.gif": gif(90, 80, [gif_frame(noise)], palette=pal256),
        "gif_table_full_deferred.gif": gif(90, 80, [gif_frame(noise, defer=True)],
                                           palette=pal256),
        "gif_extensions_two_frames.gif": gif(w, h, [
            gif_extension(254, b"a comment", b"in two blocks"),
            gif_extension(255, b"NETSCAPE2.0", b"\x01\x00\x00"),
            gif_extension(1, bytes(12), b"plain text"),
            gif_frame(g >> 4, transparency=3, block=17),
            gif_frame(255 - g, palette=pal256)], palette=pal16),
        "tiff_raw_strips.tif": tiff(g, rows_per_strip=7),
        "tiff_raw_mm_tiles.tif": tiff(g, order=">", tile=(16, 16)),
        "tiff_raw_rgb_planar.tif": tiff(rgb, photometric=2, planar=2, rows_per_strip=9),
        "tiff_raw_min_is_white_4bit.tif": tiff(g >> 4, bits=4, photometric=0),
        "tiff_raw_1bit_fill2.tif": tiff(g >> 7, bits=1, fill_order=2),
        "tiff_raw_16bit_mm.tif": tiff(g.astype(np.uint16) * 3, bits=16, order=">"),
        "tiff_lzw.tif": tiff(g, compression=5, rows_per_strip=10),
        "tiff_lzw_rgb_predictor.tif": tiff(rgb, photometric=2, compression=5, predictor=2),
        "tiff_lzw_bigtiff.tif": tiff(g, compression=5, bigtiff=True),
        "tiff_lzw_fill2.tif": tiff(g, compression=5, fill_order=2),
        "tiff_lzw_palette_4bit.tif": tiff(g >> 4, bits=4, photometric=3, compression=5,
                                          colormap=rng.integers(0, 65536, (3, 16))),
        "tiff_lzw_cmyk.tif": tiff(np.concatenate([rgb, g[..., None]], -1), photometric=5,
                                  compression=5),
        "tiff_lzw_rgba_associated.tif": tiff(np.concatenate([rgb, (g | 1)[..., None]], -1),
                                             photometric=2, compression=5, extra_samples=[1]),
        "tiff_deflate_tiles.tif": tiff(g, compression=8, tile=(32, 16)),
        "tiff_deflate_16bit_mm_predictor.tif": tiff(g.astype(np.uint16) * 257, bits=16,
                                                    order=">", compression=32946, predictor=2),
        "tiff_deflate_2bit.tif": tiff(g >> 6, bits=2, compression=8),
        "tiff_packbits_rgb_planar.tif": tiff(rgb, photometric=2, compression=32773, planar=2,
                                             rows_per_strip=5),
        "tiff_lzma.tif": tiff(g, compression=34925, rows_per_strip=16),
        "tiff_orientation_6.tif": tiff(g, compression=5, tags={274: (3, [6])}),
        "tiff_lzw_min_is_white_8bit.tif": tiff(g, photometric=0, compression=5),
        "tiff_lzw_min_is_white_1bit.tif": tiff(g >> 7, bits=1, photometric=0, compression=5),
        "tiff_deflate_min_is_white_16bit.tif": tiff(g.astype(np.uint16) * 2, bits=16,
                                                    photometric=0, compression=8),
        "tiff_lzw_12bit.tif": tiff(g.astype(np.uint16) * 16 + 7, bits=12, compression=5),
        "tiff_packbits_palette_1bit.tif": tiff(g >> 7, bits=1, photometric=3, compression=32773,
                                               colormap=rng.integers(0, 65536, (3, 2))),
        "tiff_deflate_palette_8bit.tif": tiff(g, photometric=3, compression=8, tile=(16, 32),
                                              colormap=rng.integers(0, 65536, (3, 256))),
        "tiff_packbits_rgba.tif": tiff(np.concatenate([rgb, (255 - g)[..., None]], -1),
                                       photometric=2, compression=32773, extra_samples=[2]),
        "tiff_deflate_rgba_16bit_predictor.tif": tiff(
            np.concatenate([rgb, g[..., None]], -1).astype(np.uint16) * 257, bits=16,
            photometric=2, compression=8, predictor=2, extra_samples=[2]),
        "tiff_mm_bigtiff.tif": tiff(g, order=">", bigtiff=True),  # PIL cannot identify it
    }
    out["tiff_lzw_strip_cut.tif"] = tiff(g, compression=5, strips=[tiff_lzw(g.tobytes())[:200]])
    out["gif_truncated.gif"] = out["gif87a_global_256.gif"][:-40]
    if page_jpeg:
        frame = next(s for s in jpeg_segments(page_jpeg) if s[0] == 0xC0)
        hh, ww = struct.unpack(">HH", page_jpeg[frame[1] + 5:frame[1] + 9])
        out["tiff_jpeg_page_tables.tif"] = jpeg_tiff([page_jpeg], ww, hh, hh)
        out["tiff_jpeg_page_whole.tif"] = jpeg_tiff([page_jpeg], ww, hh, hh,
                                                    split_tables=False)
    return out
