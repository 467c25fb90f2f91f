"""TIFF files as PIL 12.1 reads them: ``Image.open(f).convert("L")`` of the
first image file directory, bit for bit (JAX counterpart: the PIL calls of
the data loaders).

:func:`open_tiff` is TiffImagePlugin's ``_open``, ``_seek(0)`` and
``_setup``: the header (II or MM, classic or BigTIFF, all six of PIL's
``PREFIXES``), the first directory read as ``ImageFileDirectory_v2`` reads
it (tags of an unknown type skipped, a directory that runs out of the file
cut where it does), the PIL mode and raw mode ``OPEN_INFO`` gives the tags,
and the tiles.  Where PIL's reader raises one of the errors ``Image.open``
takes for "not this format", so does this, and :mod:`.identify` goes on.

:func:`decode_tiff` then reads the pixels the way PIL does:

* uncompressed data through PIL's own raw decoder: tiles in file order,
  rows read from each tile's offset, PIL's unpacker for the raw mode
  (predictor ignored, a planar image read band by band);
* compressed data as libtiff decodes it for PIL, from the directory as
  libtiff reads it again (:func:`libtiff_dir`: its own type, count and
  value rules, which PIL's Python does not share) and Pillow's checks
  between the two (the same size, the strip size its unpacker expects,
  the planes it has bands for): each strip or tile read from its byte
  count (PackBits and LZW in ``native/tiffdecode.cpp``, Deflate with
  ``zlib``, LZMA with ``lzma``, imported at the first LZMA strip), fill
  order 2 undone on the compressed bytes, horizontal differencing
  (predictor 2) undone at 8 and 16 bits, 16-bit samples in the host's
  order; JPEG strips through the port's JPEG decoder in its strip mode
  (``decode_jpeg``, the caller's), with the ``JPEGTables`` spliced in
  (YCbCr converted to RGB as libtiff asks libjpeg to, RGB and grey taken
  as they are);
* the mode to L as ``convert("L")`` does: 1 to 0 and 255, ``I;16`` clipped,
  RGB and RGBA by ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``, CMYK
  through RGB, P through the colour map (0 past its end);
* the EXIF orientation PIL's TIFF reader applies at load.

What PIL decodes and this does not raises ``NotImplementedError`` naming the
tags (once the strips are known to be readable, where PIL's errors come
first): CCITT (2, 3, 4), old-style JPEG (6), ZSTD, WebP, SGILog,
ThunderScan and the 16-bit raw padding, float and 32-bit and signed
samples, YCbCr that is not JPEG-compressed, and a JPEG strip layout
libtiff reads through its own colour handling (CMYK, planar YCbCr).  LAB
is read for PIL's errors, then refused with the ValueError of its
``convert``.  It
names too what libtiff decodes in a way the port does not mirror: a JPEG
strip narrower or shorter than the strip (libtiff leaves the rest of the
strip as its buffer held), raised once every strip has been read, as
libtiff's errors in a later strip come first.  A corrupt LZMA strip is
kept where libtiff keeps it (:func:`_lzma_as_libtiff`).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..utils import native

SOURCE = native.NATIVE_DIR / "tiffdecode.cpp"
BUILD_DIR = native.BUILD_DIR
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
            b"II\x2b\x00")

(WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIPOFFSETS, ORIENTATION,
 SAMPLES, ROWSPERSTRIP, STRIPBYTECOUNTS, PLANAR, PREDICTOR, COLORMAP, TILEWIDTH, TILELENGTH,
 TILEOFFSETS, TILEBYTECOUNTS, EXTRASAMPLES, SAMPLEFORMAT, JPEGTABLES,
 YCBCRSUBSAMPLING) = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320,
                      322, 323, 324, 325, 338, 339, 347, 530)
# TiffTags' length of the tags read here: 1 is a single value, 0 or 2 a tuple
TAG_LENGTH = {WIDTH: 1, LENGTH: 1, COMPRESSION: 1, PHOTOMETRIC: 1, FILLORDER: 1,
              ORIENTATION: 1, SAMPLES: 1, ROWSPERSTRIP: 1, PLANAR: 1, TILEWIDTH: 1,
              TILELENGTH: 1}
# tag type -> (bytes per value, struct code; None: the bytes, "s": text, "r": rational)
TYPES = {1: (1, None), 2: (1, "s"), 3: (2, "H"), 4: (4, "L"), 5: (8, "r"), 6: (1, "b"),
         7: (1, None), 8: (2, "h"), 9: (4, "l"), 10: (8, "R"), 11: (4, "f"), 12: (8, "d"),
         13: (4, "L"), 16: (8, "Q")}
COMPRESSION_INFO = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
                    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
                    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
                    50000: "zstd", 50001: "webp"}
II, MM = b"II", b"MM"

# TiffImagePlugin.OPEN_INFO: (photometric, sample format, fill order, bits,
# extra samples) -> (mode, raw mode), for both byte orders ...
_BOTH = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"), (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"), (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"), (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"), (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"), (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"), (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"), (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (8,), ()): ("L", "L"), (1, (2,), 1, (8,), ()): ("L", "L"),
    (1, (1,), 2, (8,), ()): ("L", "L;R"), (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"), (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (3, (1,), 1, (1,), ()): ("P", "P;1"), (3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (3, (1,), 1, (2,), ()): ("P", "P;2"), (3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (3, (1,), 1, (4,), ()): ("P", "P;4"), (3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (3, (1,), 1, (8,), ()): ("P", "P"), (3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"), (3, (1,), 2, (8,), ()): ("P", "P;R"),
    (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (6, (1,), 1, (8,), ()): ("L", "L"), (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}
# ... and for one byte order each
_ONE = {
    II: {(1, (1,), 1, (12,), ()): ("I;16", "I;12"), (0, (1,), 1, (16,), ()): ("I;16", "I;16"),
         (1, (1,), 1, (16,), ()): ("I;16", "I;16"), (1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
         (1, (2,), 1, (16,), ()): ("I", "I;16S"), (0, (3,), 1, (32,), ()): ("F", "F;32F"),
         (1, (1,), 1, (32,), ()): ("I", "I;32N"), (1, (2,), 1, (32,), ()): ("I", "I;32S"),
         (1, (3,), 1, (32,), ()): ("F", "F;32F")},
    MM: {(1, (1,), 1, (16,), ()): ("I;16B", "I;16B"), (1, (2,), 1, (16,), ()): ("I", "I;16BS"),
         (0, (3,), 1, (32,), ()): ("F", "F;32BF"), (1, (2,), 1, (32,), ()): ("I", "I;32BS"),
         (1, (3,), 1, (32,), ()): ("F", "F;32BF")},
}
for _order, _end in ((II, "L"), (MM, "B")):
    for _extra, (_mode, _raw) in {(): ("RGB", "RGB"), (0,): ("RGB", "RGBX"), (1,): ("RGBA", "RGBa"),
                                  (2,): ("RGBA", "RGBA")}.items():
        _bits = (16,) * (3 + len(_extra))
        _ONE[_order][(2, (1,), 1, _bits, _extra)] = (_mode, f"{_raw};16{_end}")
    _ONE[_order][(2, (1,), 1, (16,) * 4, ())] = ("RGBA", f"RGBA;16{_end}")
    _ONE[_order][(5, (1,), 1, (16,) * 4, ())] = ("CMYK", f"CMYK;16{_end}")
OPEN_INFO = {(order,) + k: v for order in (II, MM) for k, v in {**_BOTH, **_ONE[order]}.items()}
MAX_SAMPLESPERPIXEL = 6

# the raw modes PIL 12.1 can unpack into each mode (Image._getdecoder
# raises ValueError for another)
UNPACKERS = {
    "1": {"1", "1;I", "1;IR", "1;R"},
    "L": {"L", "L;2", "L;2I", "L;2IR", "L;2R", "L;4", "L;4I", "L;4IR", "L;4R", "L;I", "L;R"},
    "P": {"L", "P", "P;1", "P;2", "P;4", "P;R", "PX"},
    "LA": {"LA"}, "PA": {"LA", "PA"},
    "I;16": {"I;12", "I;16", "I;16B", "I;16N", "I;16R"}, "I;16B": {"I;16B", "I;16N"},
    "RGB": {"B", "B;16N", "CMYK", "G", "G;16N", "R", "R;16N", "RGB", "RGB;16B", "RGB;16L",
            "RGB;16N", "RGB;R", "RGBX", "RGBX;16B", "RGBX;16L", "RGBX;16N", "RGBXX", "RGBXXX"},
    "RGBA": {"A", "A;16N", "B", "B;16N", "G", "G;16N", "LA", "R", "R;16N", "RGBA", "RGBA;16B",
             "RGBA;16L", "RGBA;16N", "RGBAX", "RGBAXX", "RGBa", "RGBa;16B", "RGBa;16L",
             "RGBa;16N", "RGBaX", "RGBaXX"},
    "CMYK": {"C", "CMYK", "CMYK;16B", "CMYK;16L", "CMYK;16N", "CMYKX", "CMYKXX", "K", "M", "Y"},
}
BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "LA": 2, "PA": 2, "RGB": 4, "RGBA": 4,
         "CMYK": 4}  # the bands each mode's pixel stores
MODE_BANDS = {**BANDS, "RGB": 3}  # the mode's own bands
PLANE_BANDS = {"R": 0, "G": 1, "B": 2, "A": 3, "C": 0, "M": 1, "Y": 2, "K": 3}
BITFLIP = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

_lib: Optional[ctypes.CDLL] = None
_MSG = 256


class _Tile(NamedTuple):
    extent: Tuple[int, int, int, int]
    offset: int
    rawmode: str
    stride: int


class TiffImage(NamedTuple):
    """The first directory and what ``_setup`` made of it."""

    tags: Dict[int, Any]
    order: bytes  # II or MM
    mode: str
    rawmode: str
    photometric: Any
    compression: str
    size: Tuple[int, int]  # (W, H) before the orientation
    bits: tuple
    tiles: List[_Tile]  # the raw decoder's tiles, in _setup's order
    palette: Optional[bytes]  # RGB;L colour map bytes of mode P/PA
    big: bool  # BigTIFF


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load_library(SOURCE, CXX_FLAGS, "the TIFF decoder", BUILD_DIR)
    for name in ("tiff_lzw", "tiff_packbits"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                       ctypes.c_char_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _value(raw: Tuple[int, bytes], tag: int, e: str):
    """A tag's value as ImageFileDirectory_v2 gives it: bytes for BYTE and
    UNDEFINED, text for ASCII, one number for a tag of length 1, else a
    tuple (rationals as floats)."""
    typ, data = raw
    size, code = TYPES[typ]
    if code is None:
        return data
    if code == "s":
        return (data[:-1] if data.endswith(b"\0") else data).decode("latin-1", "replace")
    if code in "rR":
        vals = struct.unpack(f"{e}{len(data) // 4}{'L' if code == 'r' else 'l'}", data)
        values = tuple(a / b if b else float("nan") for a, b in zip(vals[::2], vals[1::2]))
    else:
        values = struct.unpack(f"{e}{len(data) // size}{code}", data)
    if TAG_LENGTH.get(tag) == 1:
        return values[0]
    return values


def _read_ifd(data: bytes, pos: int, e: str, big: bool) -> Dict[int, Tuple[int, bytes]]:
    """ImageFileDirectory_v2.load: the tags (type, data) of the directory at
    ``pos``; a read past the end of the file ends the directory there, with
    what was read so far."""
    tags: Dict[int, Tuple[int, bytes]] = {}
    inline = 8 if big else 4
    try:
        count_fmt, entry_fmt, entry_size = ("Q", "HHQ8s", 20) if big else ("H", "HHL4s", 12)
        head = data[pos:pos + (8 if big else 2)]
        if len(head) != (8 if big else 2):
            raise OSError("Corrupt EXIF data")
        (count,) = struct.unpack(e + count_fmt, head)
        pos += len(head)
        for _ in range(count):
            entry = data[pos:pos + entry_size]
            if len(entry) != entry_size:
                raise OSError("Corrupt EXIF data")
            pos += entry_size
            tag, typ, n, value = struct.unpack(e + entry_fmt, entry)
            if typ not in TYPES:
                continue
            size = n * TYPES[typ][0]
            if size > inline:
                (off,) = struct.unpack(e + ("Q" if big else "L"), value)
                value = data[off:off + size] if size > 0 else b""
                if len(value) < size:
                    raise OSError("Truncated File Read")
            else:
                value = value[:size]
            if len(value) != size or not value:
                continue
            tags[tag] = (typ, value)
    except OSError:
        pass
    return tags


def open_tiff(data: bytes, check_size) -> TiffImage:
    """TiffImagePlugin's ``_open``, ``_seek(0)`` and ``_setup`` of ``data``;
    ``check_size(w, h)`` is PIL's decompression-bomb check."""
    ifh = data[:8]
    big = ifh[2] == 43
    if big:
        ifh += data[8:16]
    order = ifh[:2]
    if order not in (II, MM):
        raise SyntaxError("not a TIFF IFD")
    e = "<" if order == II else ">"
    (first,) = struct.unpack(e + ("Q" if big else "L"), ifh[8:] if big else ifh[4:])
    if not first:
        raise EOFError("no more images in TIFF file")
    if first >= 2 ** 63:
        raise ValueError("Unable to seek to frame")
    raw = _read_ifd(data, first, e, big)
    tags = {tag: _value(v, tag, e) for tag, v in raw.items()}

    if 0xBC01 in tags:
        raise OSError("Windows Media Photo files not yet supported")
    compression = COMPRESSION_INFO[tags.get(COMPRESSION, 1)]
    planar = tags.get(PLANAR, 1)
    photo = tags.get(PHOTOMETRIC, 0)
    if compression == "tiff_jpeg":
        photo = 6
    fillorder = tags.get(FILLORDER, 1)
    try:
        xsize, ysize = tags[WIDTH], tags[LENGTH]
    except KeyError as err:
        raise TypeError("Missing dimensions") from err
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise ValueError("Invalid dimensions")
    size = (ysize, xsize) if tags.get(ORIENTATION) in (5, 6, 7, 8) else (xsize, ysize)

    sample_format = tags.get(SAMPLEFORMAT, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = tags.get(BITS, (1,))
    extra = tags.get(EXTRASAMPLES, ())
    bps_count = 3 if photo in (2, 6, 8) else 4 if photo == 5 else 1
    bps_count += len(extra)
    spp = tags.get(SAMPLES, 3 if compression == "tiff_jpeg" and photo in (2, 6) else 1)
    if spp > MAX_SAMPLESPERPIXEL:
        raise SyntaxError("Invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise SyntaxError("unknown data organization")
    key = (order, photo, sample_format, fillorder, bps, extra)
    mode, rawmode = OPEN_INFO[key]

    tiles: List[_Tile] = []
    if compression != "raw":
        if fillorder == 2:
            mode, rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
        if photo == 6 and compression == "jpeg" and planar == 1:
            rawmode = "RGB"
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    elif STRIPOFFSETS in tags or TILEOFFSETS in tags:
        if STRIPOFFSETS in tags:
            offsets = tags[STRIPOFFSETS]
            h = tags.get(ROWSPERSTRIP, ysize)
            w = xsize
        else:
            offsets = tags[TILEOFFSETS]
            w, h = tags.get(TILEWIDTH), tags.get(TILELENGTH)
            if not isinstance(w, int) or not isinstance(h, int):
                raise ValueError("Invalid tile dimensions")
        if w == xsize and h == ysize and planar != 2:
            offsets = offsets[-1:]
        x = y = layer = 0
        for offset in offsets:
            stride = w * sum(bps) / 8 if x + w > xsize else 0
            tile_rawmode = rawmode
            if planar == 2:
                tile_rawmode = rawmode[layer]
                stride /= bps_count
            tiles.append(_Tile((x, y, min(x + w, xsize), min(y + h, ysize)), offset,
                               tile_rawmode, int(stride)))
            x += w
            if x >= xsize:
                x, y = 0, y + h
                if y >= ysize:
                    y = 0
                    layer += 1
    else:
        raise SyntaxError("unknown data organization")
    palette = None
    if mode in ("P", "PA"):
        palette = bytes((b // 256) & 255 for b in tags[COLORMAP])
    if xsize <= 0 or ysize <= 0:
        raise SyntaxError("not identified by this plugin")
    check_size(*size)
    return TiffImage(tags, order, mode, rawmode, photo, compression, (xsize, ysize), bps, tiles,
                     palette, big)


# --- unpacking: raw mode bytes -> the mode's bands ----------------------------------

def _bits_of(rawmode: str) -> int:
    """The bits a pixel takes in ``rawmode`` (PIL's unpacker table)."""
    r = rawmode
    if r.startswith(("1", "P;1")):
        return 1
    if r.startswith(("L;2", "P;2")):
        return 2
    if r.startswith(("L;4", "P;4")):
        return 4
    if r in ("L", "L;I", "L;R", "L;IR", "P", "P;R") or r in PLANE_BANDS:
        return 8
    if r == "I;12":
        return 12
    if r in ("LA", "PA", "PX") or r.startswith("I;16") or r[1:] == ";16N":
        return 16
    base, wide, _ = r.partition(";16")
    return len(base.split(";")[0]) * (16 if wide else 8)


def _samples(rows: np.ndarray, n: int, bits: int) -> np.ndarray:
    """uint8 rows [R, B] -> the first n samples of each row at ``bits``
    (1, 2 or 4: the high bits first)."""
    if bits == 8:
        return rows[:, :n]
    per = 8 // bits
    shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
    out = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return out.reshape(rows.shape[0], -1)[:, :n]


def _unpack(rows: np.ndarray, r: str, width: int, mode: str) -> Dict[int, np.ndarray]:
    """PIL's unpacker for (mode, raw mode ``r``): uint8 rows [R, bytes] ->
    {band: values [R, width]} of the mode (uint16 for the I;16 modes)."""
    if r[0] in PLANE_BANDS and r[1:] in ("", ";16N"):  # one band of a planar image
        band = PLANE_BANDS[r[0]]
        return {band: rows[:, 1:2 * width:2] if len(r) == 5 else rows[:, :width]}
    packed = r.startswith(("1", "L;2", "L;4", "P;1", "P;2", "P;4")) or r in ("L;R", "P;R")
    if packed:
        bits = _bits_of(r)
        if r.endswith("R"):
            rows = BITFLIP[rows]
        v = _samples(rows, width, bits)
        if mode == "1":
            v = np.where(v != 0, 255, 0)
        elif mode == "L":
            v = v * (255 // ((1 << bits) - 1))
        if "I" in r.partition(";")[2]:
            v = 255 - v
        return {0: v.astype(np.uint8)}
    if r in ("L", "P"):  # (also the first band of a planar L or P image)
        return {0: rows[:, :width]}
    if r == "L;I":
        return {0: 255 - rows[:, :width]}
    if r in ("LA", "PA", "PX"):
        return {0: rows[:, 0:2 * width:2]}
    if r == "I;12":  # two samples in three bytes, the high bits first
        b = np.concatenate([rows, np.zeros((rows.shape[0], 2), np.uint8)], 1).astype(np.uint16)
        k = np.arange(width)
        hi, lo = b[:, k // 2 * 3 + k % 2], b[:, k // 2 * 3 + k % 2 + 1]
        return {0: np.where(k % 2 == 0, (hi << 4) | (lo >> 4), ((hi & 15) << 8) | lo)}
    if r.startswith("I;16"):
        pairs = rows[:, :2 * width]
        if r == "I;16R":
            pairs = BITFLIP[pairs]
        lo, hi = pairs[:, 0::2].astype(np.uint16), pairs[:, 1::2].astype(np.uint16)
        return {0: (lo << 8) | hi if r == "I;16B" else (hi << 8) | lo}
    base, wide, end = r.partition(";16")
    if r == "RGB;R":
        rows, base = BITFLIP[rows], "RGB"
    n, step = len(base), 2 if wide else 1
    pick = (1 if end in ("L", "N") else 0) if wide else 0
    px = rows[:, :n * step * width].reshape(rows.shape[0], width, n, step)[..., pick]
    out = {i: px[..., i] for i in range(min(n, 4))}
    if base.startswith("RGBa"):
        out.update(_unpremultiply(out))
    return out


def _unpremultiply(bands: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """Pillow's RGBa to RGBA: each colour times 255 over alpha, clipped;
    0 where alpha is 0."""
    a = bands[3].astype(np.int64)
    return {i: np.where(a == 0, 0, np.minimum(bands[i].astype(np.int64) * 255 // np.maximum(a, 1),
                                              255)).astype(np.uint8) for i in range(3)}


def _to_l(bands: Dict[int, np.ndarray], mode: str, palette: Optional[bytes]) -> np.ndarray:
    if mode in ("1", "L", "LA"):
        return bands[0]
    if mode in ("I;16", "I;16B"):
        return np.minimum(bands[0], 255).astype(np.uint8)
    if mode in ("P", "PA"):
        n = len(palette) // 3
        rgb = np.frombuffer(palette, np.uint8)
        rgb = np.stack([rgb[:n], rgb[n:2 * n], rgb[2 * n:3 * n]], 1).astype(np.int64)
        lut = np.zeros(256, np.uint8)
        lut[:n] = (rgb[:, 0] * 19595 + rgb[:, 1] * 38470 + rgb[:, 2] * 7471 + 0x8000) >> 16
        return lut[bands[0]]
    r, g, b = (bands[i].astype(np.int64) for i in range(3))
    if mode == "CMYK":  # Pillow's cmyk2rgb, then RGB to L
        nk = 255 - bands[3].astype(np.int64)

        def mul(c):
            t = c * nk + 128
            return np.clip(nk - ((t >> 8) + t >> 8), 0, 255)
        r, g, b = mul(r), mul(g), mul(b)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _empty_bands(mode: str, w: int, h: int) -> Dict[int, np.ndarray]:
    dtype = np.uint16 if mode.startswith("I;16") else np.uint8
    return {i: np.zeros((h, w), dtype) for i in range(BANDS[mode])}


def _orient(img: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose, which PIL's TIFF reader applies at load."""
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.T, 6: lambda a: a.T[:, ::-1], 7: lambda a: a[::-1, ::-1].T,
           8: lambda a: a.T[::-1]}
    op = ops.get(orientation)
    return np.ascontiguousarray(op(img)) if op else img


# --- the raw path: ImageFile.load with PIL's raw decoder ------------------------------

def _decode_raw(data: bytes, t: TiffImage) -> Dict[int, np.ndarray]:
    W, H = t.size
    bands = _empty_bands(t.mode, W, H)
    tiles = sorted(t.tiles, key=lambda tile: tile.offset)
    kept: List[_Tile] = []
    for tile in tiles:  # consecutive tiles that differ only in offset: the last one
        if kept and (kept[-1].extent, kept[-1].rawmode, kept[-1].stride) == (
                tile.extent, tile.rawmode, tile.stride):
            kept[-1] = tile
        else:
            kept.append(tile)
    err = -3
    for tile in kept:  # ImageFile.load: seek, the unpacker, setimage, the reads
        if not isinstance(tile.offset, int):
            raise TypeError("an integer is required (the tile's offset)")
        if tile.rawmode not in UNPACKERS.get(t.mode, ()):
            raise ValueError("unknown raw mode for given image mode")
        if not all(isinstance(v, int) for v in tile.extent):
            raise TypeError("'float' object cannot be interpreted as an integer")
        x0, y0, x1, y1 = tile.extent
        if x0 == 0 and x1 == 0:
            x0, y0, x1, y1 = 0, 0, W, H
        if x1 - x0 <= 0 or x1 > W or y1 - y0 <= 0 or y1 > H:
            raise ValueError("tile cannot extend outside image")
        if tile.offset >= len(data):
            raise OSError("image file is truncated (0 bytes not processed)")
        width, rows = x1 - x0, y1 - y0
        row_bytes = (width * _bits_of(tile.rawmode) + 7) // 8
        skip = tile.stride - row_bytes if tile.stride else 0
        if skip < 0:
            err = -8
            continue
        need = rows * row_bytes + (rows - 1) * skip
        if tile.offset + need > len(data):
            raise OSError("image file is truncated")
        buf = np.frombuffer(data, np.uint8, need, tile.offset)
        if skip:  # the last row has no padding after it
            buf = np.concatenate([buf, np.zeros(skip, np.uint8)])
        block = buf.reshape(rows, row_bytes + skip)[:, :row_bytes]
        for band, v in _unpack(block, tile.rawmode, width, t.mode).items():
            bands[band][y0:y1, x0:x1] = v
        err = 0
    if err < 0:
        raise OSError(f"decoder error {err}" if err != -8 else
                      "codec configuration error when reading image file")
    return bands


# --- the libtiff path -----------------------------------------------------------------

class LibtiffDir(NamedTuple):
    """The first directory as libtiff's TIFFReadDirectory leaves it: the
    fields Pillow's libtiff decoder reads."""

    width: int
    length: int
    samples: int
    bits: int
    compression: int
    photometric: Optional[int]
    planar: int
    rows_per_strip: int  # 2**32 - 1 where the tag is absent
    fillorder: int
    predictor: int
    tile: Optional[Tuple[int, int]]  # (width, length) of a tiled image
    offsets: List[int]
    counts: List[int]
    jpegtables: Optional[bytes]
    subsampling: Optional[Tuple[int, int]]


# the integer types libtiff reads these tags from (not IFD or IFD8, which PIL takes)
_INTS = {1: "B", 6: "b", 3: "H", 8: "h", 4: "L", 9: "l", 16: "Q", 17: "q"}


class _Bad(Exception):
    """A directory libtiff refuses (TIFFReadDirectory goes to ``bad``)."""


def _entry_values(data: bytes, e: str, big: bool, entry, limit: Optional[int] = None) -> list:
    """The integer values of a directory entry as libtiff's
    TIFFReadDirEntry*Array reads them: integer types only, no negative
    value, at most ``limit`` of them, the inline or out-of-line data in
    the file."""
    typ, count, raw = entry
    if typ not in _INTS:
        raise _Bad("Incompatible type")
    size = struct.calcsize("<" + _INTS[typ])
    n = count if limit is None else min(count, limit)
    inline = 8 if big else 4
    if min(count, 10) * size <= inline:
        blob = raw[:n * size]
    else:
        (off,) = struct.unpack(e + ("Q" if big else "L"), raw[:8 if big else 4])
        blob = data[off:off + n * size]
        if len(blob) < n * size:
            raise _Bad("IO error")
    values = list(struct.unpack(f"{e}{n}{_INTS[typ]}", blob))
    if any(v < 0 for v in values):
        raise _Bad("Bad value")
    return values


def _entry_one(data, e, big, entry, limit: int, per_sample: int = 0) -> int:
    """TIFFReadDirEntryShort or Long (``limit`` 2**16 or 2**32): one value;
    with ``per_sample``, TIFFReadDirEntryPersampleShort's count of at least
    that many, all equal."""
    count = entry[1]
    if count != 1 and not (per_sample and count >= per_sample):
        raise _Bad("Incorrect count")
    values = _entry_values(data, e, big, entry, per_sample or 1)
    if any(v >= limit for v in values):
        raise _Bad("Bad value")
    if len(set(values)) > 1:
        raise _Bad("Cannot handle different values per sample")
    return values[0]


def libtiff_dir(data: bytes, order: bytes, big: bool) -> LibtiffDir:
    """libtiff 4.7's TIFFClientOpen and TIFFReadDirectory of the first
    directory, as far as Pillow's decoder reads it: its header checks, the
    directory's entries in the file, the tags it must read whole
    (SamplesPerPixel, Compression, the dimensions, PlanarConfiguration,
    RowsPerStrip, ExtraSamples, BitsPerSample, SampleFormat, the strip or
    tile arrays) and those it drops when they are bad (FillOrder,
    Predictor, PhotometricInterpretation, JPEGTables, YCbCrSubSampling).
    A directory libtiff refuses raises OSError, as PIL's decoder does."""
    e = "<" if order == II else ">"
    try:
        version = struct.unpack(e + "H", data[2:4])[0]
        if version != (43 if big else 42):
            raise _Bad(f"bad version number {version}")
        if big:
            if struct.unpack(e + "HH", data[4:8]) != (8, 0):
                raise _Bad("bad BigTIFF offset size")
            (first,) = struct.unpack(e + "Q", data[8:16])
        else:
            (first,) = struct.unpack(e + "L", data[4:8])
        head = data[first:first + (8 if big else 2)]
        if len(head) < (8 if big else 2):
            raise _Bad("Can not read TIFF directory count")
        (n,) = struct.unpack(e + ("Q" if big else "H"), head)
        if n == 0 or n > 4096:
            raise _Bad("Sanity check on directory count failed")
        size = 20 if big else 12
        body = data[first + len(head):first + len(head) + n * size]
        if len(body) < n * size:
            raise _Bad("Can not read TIFF directory")
        entries: Dict[int, tuple] = {}
        for k in range(n):
            tag, typ, count, raw = struct.unpack(e + ("HHQ8s" if big else "HHL4s"),
                                                 body[k * size:(k + 1) * size])
            entries.setdefault(tag, (typ, count, raw))

        def one(tag, default, limit=2 ** 16, per_sample=0):
            return default if tag not in entries else _entry_one(data, e, big, entries[tag], limit,
                                                                 per_sample)

        def dropped(tag, default, limit=2 ** 16):  # a bad value leaves the default
            try:
                return one(tag, default, limit)
            except _Bad:
                return default

        spp = one(SAMPLES, 1)
        if spp == 0:
            raise _Bad("Bad value 0 for SamplesPerPixel")
        compression = one(COMPRESSION, 1, per_sample=spp)
        if WIDTH not in entries or LENGTH not in entries:
            raise _Bad('MissingRequired "ImageLength"')
        width, length = one(WIDTH, 0, 2 ** 32), one(LENGTH, 0, 2 ** 32)
        planar = one(PLANAR, 1)
        if planar not in (1, 2):
            raise _Bad(f"Bad value {planar} for PlanarConfiguration")
        rps = one(ROWSPERSTRIP, 2 ** 32 - 1, 2 ** 32)
        if rps == 0:
            raise _Bad("Bad value 0 for RowsPerStrip")
        if EXTRASAMPLES in entries:
            extra = _entry_values(data, e, big, entries[EXTRASAMPLES])
            if len(extra) > spp or any(v > 2 and v != 999 for v in extra):
                raise _Bad("Bad value for ExtraSamples")
        tile = None
        if TILEWIDTH in entries or TILELENGTH in entries:
            tile = (one(TILEWIDTH, 0, 2 ** 32), one(TILELENGTH, 0, 2 ** 32))
            across = -(-width // tile[0]) if tile[0] else 0
            down = -(-length // tile[1]) if tile[1] else 0
        else:
            across, down = 1, (1 if rps == 2 ** 32 - 1 else -(-length // rps))
        nstrips = across * down * (spp if planar == 2 else 1)
        if nstrips == 0:
            raise _Bad("Cannot handle zero number of strips or tiles")
        # the strip and tile tags share libtiff's fields: the later entry wins
        offsets_tag = ([t for t in entries if t in (STRIPOFFSETS, TILEOFFSETS)] or [None])[-1]
        counts_tag = ([t for t in entries if t in (STRIPBYTECOUNTS, TILEBYTECOUNTS)] or [None])[-1]
        if offsets_tag is None:
            raise _Bad('MissingRequired "StripOffsets"')
        bits = one(BITS, 1, per_sample=spp)
        if one(SAMPLEFORMAT, 1, per_sample=spp) not in range(1, 7):
            raise _Bad("Bad value for SampleFormat")
        offsets = _entry_values(data, e, big, entries[offsets_tag], nstrips)
        offsets += [0] * (nstrips - len(offsets))
        photometric = None
        try:
            photometric = one(PHOTOMETRIC, None)
        except _Bad:
            pass
        if photometric == 3 and bits < 8:
            try:  # libtiff ignores a Colormap while BitsPerSample is unset
                if BITS not in entries:
                    raise _Bad("Colormap before BitsPerSample")
                cmap = _entry_values(data, e, big, entries[COLORMAP])
                if len(cmap) != 3 << bits:
                    raise _Bad("Incorrect count for Colormap")
            except (_Bad, KeyError):
                raise _Bad('MissingRequired "Colormap"') from None
        if counts_tag is not None:
            counts = _entry_values(data, e, big, entries[counts_tag], nstrips)
            counts += [0] * (nstrips - len(counts))
        if counts_tag is None or (nstrips == 1 and tile is None and counts[0] == 0
                                  and offsets[0] != 0):
            if counts_tag is None and nstrips != (spp if planar == 2 else 1):
                raise _Bad('MissingRequired "StripByteCounts"')
            counts = _estimated_counts(data, e, big, entries, offsets, spp if planar == 2 else 1)
        fillorder = dropped(FILLORDER, 1)
        if fillorder not in (1, 2):
            fillorder = 1
        tables = None
        if JPEGTABLES in entries and entries[JPEGTABLES][0] in (1, 2, 6, 7):
            typ, count, raw = entries[JPEGTABLES]
            if count <= (8 if big else 4):
                tables = raw[:count]
            else:
                (off,) = struct.unpack(e + ("Q" if big else "L"), raw[:8 if big else 4])
                tables = data[off:off + count] if off + count <= len(data) else None
            if typ == 6 and tables is not None and max(tables, default=0) > 127:
                tables = None  # a negative SBYTE is out of a byte's range
        sub = None
        if YCBCRSUBSAMPLING in entries:
            try:
                sub = _entry_values(data, e, big, entries[YCBCRSUBSAMPLING])
                sub = tuple(sub) if len(sub) == 2 else None
            except _Bad:
                pass
    except (_Bad, struct.error) as err:
        raise OSError(f"decoder error -2 (libtiff refuses the directory: {err})") from err
    return LibtiffDir(width, length, spp, bits, compression, photometric, planar, rps, fillorder,
                      dropped(PREDICTOR, 1), tile, offsets, counts, tables, sub)


def _estimated_counts(data, e, big, entries, offsets, planes) -> List[int]:
    """libtiff's EstimateStripByteCounts for compressed data: what the file
    holds past its header and directory, shared by the planes, the last
    strip cut at the end of the file."""
    space = (16 if big else 8) + (8 if big else 2) + len(entries) * (20 if big else 12) + (
        8 if big else 4)
    for typ, count, _ in entries.values():
        width = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
                 13: 4, 16: 8, 17: 8, 18: 8}.get(typ, 0)
        if width * count > (8 if big else 4):
            space += width * count
    space = max(len(data) - space, 0) // planes
    counts = [space] * len(offsets)
    if offsets[-1] + counts[-1] > len(data):
        counts[-1] = max(len(data) - offsets[-1], 0)
    return counts


def _segments(t: TiffImage, lt: LibtiffDir, planes: int):
    """(index, offset, byte count, x, y, width, rows decoded, rows kept,
    plane) of each strip or tile Pillow's decoder has libtiff read for
    ``planes`` planes, in its order (rows and columns as PIL's directory
    gives them, strips and tiles as libtiff's); a byte count over 1 MiB and
    ten times the strip's size is cut there, as libtiff cuts it."""
    W, H = t.size
    spp = 1 if lt.planar == 2 else lt.samples
    seg_w, seg_h = lt.tile or (lt.width, min(lt.rows_per_strip, lt.length))
    size = seg_h * ((seg_w * lt.bits * spp + 7) // 8)

    def count(i):
        c = lt.counts[i]
        return size * 10 + 4096 if c > 2 ** 20 and size and (c - 4096) // 10 > size else c

    out = []
    if lt.tile:
        tw, th = lt.tile
        across, down = -(-lt.width // tw), -(-lt.length // th)
        for ty in range(0, H, th):
            for p in range(planes):
                for tx in range(0, W, tw):
                    i = p * across * down + (ty // th) * across + tx // tw
                    if tx >= lt.width or ty >= lt.length or i >= len(lt.offsets):
                        raise OSError(f"decoder error -2 (tile {tx}x{ty} out of range)")
                    out.append((i, lt.offsets[i], count(i), tx, ty, tw, th, min(th, H - ty),
                                p))
        return out
    rps = H if lt.rows_per_strip == 2 ** 32 - 1 else lt.rows_per_strip
    full = min(lt.rows_per_strip, lt.length)
    per_plane = -(-lt.length // full)
    for y in range(0, H, rps):
        for p in range(planes):
            s = y // rps
            i = s + p * per_plane
            if s >= per_plane or i >= len(lt.offsets):
                raise OSError(f"decoder error -2 (strip {i} out of range)")
            rows = lt.length - s * full if s == per_plane - 1 else full
            out.append((i, lt.offsets[i], count(i), 0, y, W, rows, min(rps, H - y), p))
    return out


CODECS = {1: "none", 5: "lzw", 32773: "packbits", 8: "deflate", 32946: "deflate",
          34925: "lzma", 7: "jpeg"}  # libtiff's Compression values the port decodes


def _decompress(lt: LibtiffDir, raw: bytes, need: int) -> bytes:
    """One strip or tile's ``need`` bytes, as libtiff's codec gives them."""
    msg = ctypes.create_string_buffer(_MSG)
    codec = CODECS[lt.compression]
    if lt.fillorder == 2:
        raw = BITFLIP[np.frombuffer(raw, np.uint8)].tobytes()
    if codec in ("lzw", "packbits"):
        out = ctypes.create_string_buffer(max(need, 1))
        fn = _library().tiff_lzw if codec == "lzw" else _library().tiff_packbits
        if fn(raw, len(raw), out, need, msg, _MSG):
            raise OSError(f"decoder error -2 ({msg.value.decode(errors='replace')})")
        return out.raw[:need]
    if codec == "none":
        out = raw[:need]
    elif codec == "deflate":
        try:
            out = zlib.decompressobj().decompress(raw, need)
        except zlib.error as err:
            raise OSError(f"decoder error -2 (zlib: {err})") from err
    else:
        import lzma  # no fallback: a Python without lzma raises here

        try:
            out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(raw, need)
        except lzma.LZMAError as err:
            out = _lzma_as_libtiff(lzma, raw, need, err)
    if len(out) < need:
        raise OSError("decoder error -2 (not enough data)")
    return out


def _lzma2_lengthened(raw: bytes, need: int) -> Optional[bytes]:
    """``raw``, an xz stream of LZMA2 chunks, with the chunk that holds its
    ``need``-th byte made longer: 273 bytes (a match) more output, and input
    to the end of the strip; None where there is no such LZMA chunk."""
    if len(raw) < 13:
        return None
    pos, done = 12 + (raw[12] + 1) * 4, 0  # past the stream and block headers
    while pos + 3 <= len(raw):
        c = raw[pos]
        if c in (1, 2):  # an uncompressed chunk
            done += struct.unpack_from(">H", raw, pos + 1)[0] + 1
            pos += 3 + struct.unpack_from(">H", raw, pos + 1)[0] + 1
            if done >= need:
                return None
            continue
        if c < 0x80 or pos + 5 > len(raw):
            return None
        size = ((c & 0x1F) << 16) + struct.unpack_from(">H", raw, pos + 1)[0] + 1
        head = 6 if (c >> 5) & 3 >= 2 else 5
        if done + size >= need:
            longer = min(size + 273, 1 << 21) - 1
            packed = min(len(raw) - pos - head, 1 << 16) - 1
            return (raw[:pos] + bytes([(c & 0xE0) | longer >> 16])
                    + struct.pack(">HH", longer & 0xFFFF, packed) + raw[pos + 5:])
        done += size
        pos += head + struct.unpack_from(">H", raw, pos + 3)[0] + 1
    return None


def _lzma_as_libtiff(lzma: Any, raw: bytes, need: int, err: Exception) -> bytes:
    """The strip libtiff keeps from an xz stream Python's ``lzma`` fails:
    libtiff keeps a strip liblzma filled before it reported the fault, and
    PIL's liblzma (5.8) fills it where the data runs past the sizes of its
    last LZMA2 chunk (a match across its end, a check read after the
    data), which Python's (5.4 here) reports first.  So the chunk is
    decoded again made longer, and only a fault of the data itself before
    the strip's last byte fails it.  Held to PIL on flipped LZMA strips in
    the tests; a stream corrupted in its last bytes can still fail here
    where PIL decodes it."""
    longer = _lzma2_lengthened(raw, need)
    out = b""
    if longer is not None:
        try:
            out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(longer, need)
        except lzma.LZMAError:
            pass
    if len(out) < need:
        raise OSError(f"decoder error -2 (lzma: {err})") from err
    return out


def _predict(rows: np.ndarray, stride: int) -> np.ndarray:
    """libtiff's horizontal differencing undone on decoded samples [R, N]."""
    shape = rows.shape
    v = rows.reshape(shape[0], -1, stride)
    return np.cumsum(v, axis=1, dtype=rows.dtype).reshape(shape)


def _open_libtiff(data: bytes, t: TiffImage) -> LibtiffDir:
    """What Pillow's libtiff decoder does before it reads a strip: its
    unpacker for the raw mode (ValueError), libtiff's directory (OSError),
    then what the port refuses by name: a codec it does not decode, YCbCr
    that libtiff would read through TIFFRGBAImage, a mode it has no
    conversion for."""
    if t.mode in BANDS and t.rawmode not in UNPACKERS[t.mode]:
        raise ValueError("unknown raw mode for given image mode")
    lt = libtiff_dir(data, t.order, t.big)
    if (lt.width, lt.length) != t.size:  # Pillow's "Inconsistent Image Error"
        raise OSError(f"decoder error -2 (libtiff reads {lt.width}x{lt.length}, PIL {t.size})")
    if lt.compression not in COMPRESSION_INFO and lt.compression not in (32766, 32909):
        # libtiff's own view of a value PIL's Python read as another: no codec
        # (NeXT and PixarLog, which it has, are named below)
        raise OSError(f"decoder error -2 (Compression scheme {lt.compression} strip decoding "
                      "is not implemented)")
    if lt.compression in (2, 3, 4, 32771) and lt.bits != 1:  # Fax3SetupState
        raise OSError("decoder error -2 (Bits/sample must be 1 for Group 3/4)")
    named = lt.compression not in CODECS or (
        lt.photometric == 6 and not (lt.compression == 7 and lt.planar == 1))
    if named and t.mode in BANDS:  # what fails before any codec runs fails first
        planes = 1 if lt.compression == 7 else _planes(t, lt)
        _check_sizes(t, lt, planes)
        for i, off, count, *_ in _segments(t, lt, planes):
            _strip(data, i, off, count)
    if lt.compression not in CODECS:
        raise NotImplementedError(f"image decoding: TIFF of Compression {lt.compression} "
                                  f"({COMPRESSION_INFO.get(lt.compression, 'unknown')}) is not "
                                  "decoded")
    if lt.photometric == 6 and not (lt.compression == 7 and lt.planar == 1):
        raise NotImplementedError("image decoding: TIFF of PhotometricInterpretation 6 (YCbCr) "
                                  "is not decoded unless it is JPEG-compressed, one plane")
    if t.mode not in BANDS:
        raise NotImplementedError(f"image decoding: TIFF of mode {t.mode} (BitsPerSample "
                                  f"{t.bits}, SampleFormat {t.tags.get(SAMPLEFORMAT, (1,))}, "
                                  f"PhotometricInterpretation {t.photometric}) is not decoded")
    return lt


def _strip(data: bytes, i: int, off: int, count: int) -> bytes:
    """The bytes of strip or tile ``i``, or libtiff's read error."""
    if count <= 0 or off + count > len(data):
        raise OSError(f"decoder error -2 (read error on strip {i})")
    return data[off:off + count]


def _planes(t: TiffImage, lt: LibtiffDir) -> int:
    """The planes Pillow's decoder reads: each sample's of a planar image
    into a mode of more than one band (an error past the mode's bands),
    else only the first."""
    planes = lt.samples if lt.planar == 2 and MODE_BANDS[t.mode] > 1 else 1
    if planes > MODE_BANDS[t.mode]:  # a plane Pillow has no band for
        raise OSError(f"decoder error -2 ({planes} planes into mode {t.mode})")
    return planes


def _check_sizes(t: TiffImage, lt: LibtiffDir, planes: int) -> None:
    """Pillow's check that libtiff's strip or tile size is no larger than
    its unpacker expects (IMAGING_CODEC_MEMORY)."""
    W, H = t.size
    bits = _bits_of(t.rawmode)
    spp = 1 if lt.planar == 2 else lt.samples
    if lt.tile:
        tw, th = lt.tile
        if th * ((tw * lt.bits * spp + 7) // 8) > ((th * bits // planes + 7) // 8) * tw:
            raise OSError("decoder error -9 (tile size)")
        return
    rps = H if lt.rows_per_strip == 2 ** 32 - 1 else lt.rows_per_strip
    if rps >= 2 ** 31:  # past a C int in Pillow's strip arithmetic
        raise OSError("decoder error -9 (rows per strip)")
    strip = min(lt.rows_per_strip, lt.length) * ((lt.width * lt.bits * spp + 7) // 8)
    if strip > ((W * bits // planes + 7) // 8) * rps:
        raise OSError("decoder error -9 (strip size)")


def _decode_libtiff(data: bytes, t: TiffImage, lt: LibtiffDir) -> Dict[int, np.ndarray]:
    mode = t.mode
    W, H = t.size
    bands = _empty_bands(mode, W, H)
    bits = lt.bits
    predictor = lt.predictor if CODECS[lt.compression] in ("lzw", "deflate", "lzma") else 1
    if predictor not in (1, 2) or (predictor == 2 and bits not in (8, 16)):
        raise OSError(f"decoder error -2 (Predictor {predictor} at {bits} bits)")
    planes = _planes(t, lt)
    _check_sizes(t, lt, planes)
    spp = 1 if lt.planar == 2 else lt.samples
    unpacked = (W * _bits_of(t.rawmode) // planes + 7) // 8
    for i, off, count, x, y, w, rows, kept, plane in _segments(t, lt, planes):
        scan = (w * bits * spp + 7) // 8
        buf = _decompress(lt, _strip(data, i, off, count), scan * rows)
        block = np.frombuffer(buf, np.uint8).reshape(rows, scan)
        if bits == 16:
            words = block[:, :scan // 2 * 2].view(">u2" if t.order == MM else "<u2")
            words = words.astype(np.uint16)
            if predictor == 2:
                words = _predict(words, spp)
            block = words.astype("<u2").view(np.uint8).reshape(rows, -1)
        elif predictor == 2:
            block = _predict(block, spp)
        if not lt.tile:  # Pillow steps through a strip by the smaller row size
            block = block[:, :min(scan, unpacked)]
        width = min(w, W - x)
        if planes > 1:  # each plane into its band, as Pillow's planar unpackers
            v = block[:kept, 1:2 * width:2] if bits == 16 else block[:kept, :width]
            bands[plane][y:y + kept, x:x + width] = v
            continue
        for band, v in _unpack(block[:kept], t.rawmode, width, mode).items():
            bands[band][y:y + kept, x:x + width] = v[:, :width]
    if planes > 1 and t.rawmode.startswith("RGBa"):
        bands.update(_unpremultiply(bands))
    return bands


def _sof(stream: bytes):
    """(height, width, [(id, h, v)]) of a JPEG's frame header."""
    pos = 2
    while pos + 4 <= len(stream):
        if stream[pos] != 0xFF:
            pos += 1
            continue
        m = stream[pos + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7 or m == 0xFF:
            pos += 1 if m == 0xFF else 2
            continue
        length = struct.unpack_from(">H", stream, pos + 2)[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            h, w, nc = struct.unpack_from(">HHB", stream, pos + 5)
            comps = [(stream[pos + 10 + 3 * k], stream[pos + 11 + 3 * k] >> 4,
                      stream[pos + 11 + 3 * k] & 15) for k in range(nc)]
            return h, w, comps
        if m == 0xDA:
            break
        pos += 2 + length
    return None


def _tables(tables: bytes) -> bytes:
    """The JPEGTables as libjpeg reads them from libtiff's source, up to the
    EOI it stops at (not included): past their end the source gives FF D9
    again and again, so a segment they cut short reads those bytes."""
    fake = b"\xff\xd9"
    data, pos = bytearray(tables), 2

    def at(i: int) -> int:
        while i >= len(data):
            data.extend(fake)
        return data[i]

    while True:
        while at(pos) != 0xFF:  # libjpeg skips what is not a marker
            pos += 1
        start = pos
        while at(pos) == 0xFF:
            pos += 1
        m = at(pos)
        pos += 1
        if m == 0xD9:
            return bytes(data[:start])
        if m in (0x00, 0x01) or 0xD0 <= m <= 0xD8:
            continue
        pos += max(at(pos) << 8 | at(pos + 1), 2)


def _decode_jpeg(data: bytes, t: TiffImage, lt: LibtiffDir,
                 decode_jpeg: Callable[[bytes, bool], np.ndarray]) -> np.ndarray:
    """JPEG strips and tiles, each a JPEG stream with the JPEGTables spliced
    in, decoded by ``decode_jpeg`` as libjpeg decodes them for libtiff:
    libtiff has libjpeg convert YCbCr to RGB (PhotometricInterpretation 6)
    and take the samples of any other as they are, whatever the JPEG's
    markers say, and holds each JPEG's sampling factors and size to the
    directory's (JPEGPreDecode)."""
    photo = t.photometric if lt.photometric is None else lt.photometric
    _check_sizes(t, lt, 1)
    W, H = t.size
    if lt.tile is None and (W * _bits_of(t.rawmode) + 7) // 8 > W * lt.samples:
        raise OSError("decoder error -2 (Pillow's row is longer than libtiff's)")  # RGBX of RGB
    out = np.zeros((H, W), np.uint8)
    sampling = lt.subsampling  # absent, libtiff takes the first strip's (JPEGFixupTags)
    refused = None  # what libtiff decodes and the port does not, once every strip is read
    tables = None if lt.jpegtables is None or len(lt.jpegtables) < 4 else _tables(lt.jpegtables)
    for i, off, count, x, y, w, rows, kept, _ in _segments(t, lt, 1):
        strip = _strip(data, i, off, count)
        if tables and strip[:2] == b"\xff\xd8":
            strip = tables + strip[2:]
        if not strip.endswith(b"\xff\xd9"):  # libtiff's source ends the data with a fake EOI
            strip += b"\xff\xd9"
        # libjpeg's errors first: the checks below raise OSError too, or name
        # what libtiff decodes with libjpeg's errors all the same
        page = decode_jpeg(strip, photo == 6)
        sof = _sof(strip)
        if sof is None:
            raise OSError(f"decoder error -2 (no JPEG frame in strip {i})")
        jh, jw, comps = sof
        if sampling is None:
            sampling = (comps[0][1], comps[0][2]) if photo == 6 and len(comps) == 3 else (2, 2)
        if len(comps) != lt.samples:
            raise OSError("decoder error -2 (Improper JPEG component count)")
        first = sampling if photo == 6 else (1, 1)  # TIFF 6.0 subsamples YCbCr alone
        if (comps[0][1], comps[0][2]) != first or any((c[1], c[2]) != (1, 1) for c in comps[1:]):
            raise OSError("decoder error -2 (Improper JPEG sampling factors)")
        if (jw > w or jh > rows) and not (jw == w and y + rows == lt.length and lt.tile is None):
            raise OSError("decoder error -2 (JPEG strip/tile size exceeds expected dimensions)")
        if photo not in (0, 1, 2, 6) or lt.bits != 8 or lt.planar != 1:
            refused = refused or (f"JPEG-compressed TIFF of PhotometricInterpretation {photo}, "
                                  f"BitsPerSample {lt.bits}, PlanarConfiguration {lt.planar}")
        elif jw < w or jh < rows:  # libtiff decodes it, the rest of the strip as it was
            refused = refused or f"a JPEG-compressed TIFF strip of {jw}x{jh} for one of {w}x{rows}"
        if refused:  # the strips left are read for libtiff's errors alone
            continue
        width = min(w, W - x)
        v = page[:kept, :width]
        out[y:y + kept, x:x + width] = 255 - v if photo == 0 else v
    if refused:
        raise NotImplementedError(f"image decoding: {refused} is not decoded")
    return out


def decode_tiff(data: bytes, t: TiffImage,
                decode_jpeg: Callable[[bytes, bool], np.ndarray]) -> np.ndarray:
    """The first image of a TIFF, opened by :func:`open_tiff`, as PIL's
    ``convert("L")``: uint8 [H, W].  ``decode_jpeg`` decodes a JPEG strip
    as libtiff's libjpeg does (``images._decode_jpeg_strip``)."""
    if t.mode == "LAB":  # PIL loads it as three bytes a pixel, then convert refuses LAB
        try:
            decode_tiff(data, t._replace(mode="RGB", rawmode="RGB"), decode_jpeg)
        except NotImplementedError:
            if t.compression != "jpeg":  # a JPEG strip layout libtiff decodes all the same
                raise
        raise ValueError("conversion from LAB to RGB not supported")
    if t.compression == "raw":
        if t.mode not in BANDS:
            raise NotImplementedError(f"image decoding: TIFF of mode {t.mode} (BitsPerSample "
                                      f"{t.bits}, SampleFormat {t.tags.get(SAMPLEFORMAT, (1,))}, "
                                      f"PhotometricInterpretation {t.photometric}) is not decoded")
        img = _to_l(_decode_raw(data, t), t.mode, t.palette)
    else:
        lt = _open_libtiff(data, t)
        if lt.compression == 7:
            img = _decode_jpeg(data, t, lt, decode_jpeg)
        else:
            img = _to_l(_decode_libtiff(data, t, lt), t.mode, t.palette)
    return _orient(img, t.tags.get(ORIENTATION))
