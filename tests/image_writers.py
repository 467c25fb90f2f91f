"""Image files written by hand, in the kinds PIL reads and does not write:
Adam7-interlaced and 16-bit PNG with every filter type, BMP of 1 to 32 bits
with BI_BITFIELDS and RLE8/RLE4, the PNM variants, and byte edits of JPEG
files (scans cut, the Adobe transform, the frame's marker and precision).

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
