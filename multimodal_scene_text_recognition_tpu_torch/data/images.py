"""Decoding, resizing and cropping grayscale images on the host, as the data
loaders read image files (JAX counterpart: the PIL calls of
data/cocotext.py, data/lmdb_data.py, data/raw.py).

The port does not use PIL.  These functions give what PIL gives, bit for
bit, through ``native/imgdecode.cpp``, ``native/webpdecode.cpp``,
``native/gifdecode.cpp`` and ``native/tiffdecode.cpp`` beside this package,
built at first use with ``g++`` (``utils.native``; a failed build raises,
there is no fallback):

* :func:`decode_gray`: ``Image.open(io.BytesIO(data)).convert("L")``:

  - JPEG: baseline and progressive Huffman (8-bit; 1, 3 or 4 components:
    grey, YCbCr or RGB, CMYK or YCCK as PIL reads them; any integer
    sampling factors; restart intervals; libjpeg-turbo's block smoothing
    where a progressive file's scans leave low bits unsent; its SIMD IDCT,
    whose 16-bit lanes wrap and saturate on corrupt data; what libjpeg
    does with a scan cut before its EOI);
  - PNG of every colour type and depth, 1 to 16 bits, plain or Adam7
    (inflated by ``zlib`` here, unfiltered in the C++);
  - BMP of 1, 4, 8, 16, 24 and 32 bits, BI_BITFIELDS, RLE8 and RLE4;
  - PNM P1 to P6 at any maxval;
  - WebP, lossless (VP8L) and lossy (VP8), with or without alpha, in the
    simple, extended (VP8X) and animated containers: frame 0 on the
    canvas, as libwebp's WebPAnimDecoder gives it to PIL;
  - GIF, frame 0 (``data/gif``, ``native/gifdecode.cpp``);
  - TIFF, the first directory: raw, PackBits, LZW, Deflate, LZMA and JPEG
    strips or tiles, as PIL and libtiff decode them (``data/tiff``,
    ``native/tiffdecode.cpp``; JPEG strips through this JPEG decoder as
    libtiff drives libjpeg, :func:`_decode_jpeg_strip`), its EXIF
    orientation applied as PIL's TIFF reader applies it.

  Which format a file is follows ``PIL.Image.open``'s walk over its
  plugins (``data/identify``).  Where PIL raises an ``OSError`` (broken or
  truncated data, a file no plugin takes, and its own refusals: 12-bit or
  hierarchical JPEG, the BMP layouts and PNM headers it does not read, a
  WebP that libwebp fails, EPS without Ghostscript and the stub formats)
  the decoder raises an ``OSError``; where PIL's Python raises
  ``ValueError`` (a short RLE or plain PNM), ``ValueError``; over twice
  PIL's ``MAX_IMAGE_PIXELS``, :class:`DecompressionBombError`.  A file PIL
  decodes and this decoder does not raises ``NotImplementedError`` naming
  its kind: arithmetic-coded or lossless JPEG, the TIFF compressions and
  layouts ``data/tiff`` names, and every format ``data/identify`` names
  (DIB, ICO/CUR, TGA, PCX, SGI, IM, SPIDER, PIL's PNM extensions, DDS,
  ICNS, JPEG 2000, AVIF, ...).  EXIF orientation is not applied to other
  formats, as ``convert`` does not apply it.
* :func:`resize_gray`: ``Image.resize`` of a mode-L image with ``BILINEAR``
  or ``BICUBIC``.
* :func:`crop_gray`: ``Image.crop`` (coordinates rounded half to even,
  zeros off the page).

``data/images_plain.py`` mirrors each of the three in numpy, the decoding
of the baseline kinds only.
"""

from __future__ import annotations

import ctypes
import re
import struct
import zlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..utils import native
from . import gif, identify, tiff

SOURCE = native.NATIVE_DIR / "imgdecode.cpp"
WEBP_SOURCE = native.NATIVE_DIR / "webpdecode.cpp"
BUILD_DIR = native.BUILD_DIR
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
FILTERS = {"bilinear": 2, "bicubic": 3}  # PIL's numbers
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHUNK_TYPE = re.compile(rb"\w\w\w\w").match  # PngImagePlugin's is_cid

MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3  # PIL's Image.MAX_IMAGE_PIXELS
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass

_lib: Optional[ctypes.CDLL] = None
_webp_lib: Optional[ctypes.CDLL] = None
_MSG = 256


class DecompressionBombError(Exception):
    """PIL's: an image of more than twice ``MAX_IMAGE_PIXELS`` pixels is
    refused before it is decoded (not an OSError, as PIL's is not)."""


def _check_size(width: int, height: int) -> None:
    if max(1, width) * max(1, height) > 2 * MAX_IMAGE_PIXELS:
        raise DecompressionBombError(f"image of {width}x{height} pixels exceeds twice "
                                     f"PIL's limit of {MAX_IMAGE_PIXELS}")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load_library(SOURCE, CXX_FLAGS, "the image decoder", BUILD_DIR)
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.decode_gray.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(u8p), i32p, i32p,
                                ctypes.c_char_p, ctypes.c_int]
    lib.decode_gray.restype = ctypes.c_int
    lib.decode_jpeg_strip.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                      ctypes.POINTER(u8p), i32p, i32p, ctypes.c_char_p, ctypes.c_int]
    lib.decode_jpeg_strip.restype = ctypes.c_int
    lib.image_free.argtypes = [u8p]
    lib.image_free.restype = None
    lib.png_to_gray.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.png_to_gray.restype = ctypes.c_int
    lib.resize_gray.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.resize_gray.restype = None
    lib.crop_gray.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.crop_gray.restype = None
    _lib = lib
    return lib


def _webp_library() -> ctypes.CDLL:
    global _webp_lib
    if _webp_lib is not None:
        return _webp_lib
    lib = native.load_library(WEBP_SOURCE, CXX_FLAGS, "the WebP decoder", BUILD_DIR)
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                ctypes.POINTER(u8p), i32p, i32p, ctypes.c_char_p, ctypes.c_int]
    lib.webp_decode.restype = ctypes.c_int
    lib.webp_free.argtypes = [u8p]
    lib.webp_free.restype = None
    _webp_lib = lib
    return lib


def _raise(code: int, msg: bytes) -> None:
    text = msg.decode(errors="replace")
    if code == 2:
        raise NotImplementedError(f"image decoding: {text}")
    if code == 3:  # where PIL's own Python raises ValueError
        raise ValueError(text)
    if code == 4:
        raise DecompressionBombError(text)
    raise OSError(text)


class PngImage(NamedTuple):
    """A PNG's header fields, palette and inflated image data."""

    width: int
    height: int
    depth: int
    color_type: int
    palette: bytes
    raw: bytes
    interlace: int


def read_png(data: bytes) -> PngImage:
    """The chunks of a PNG, its IDAT stream inflated by ``zlib``, read as
    PIL reads them: each chunk before the image data must have a word-like
    type and a matching CRC, and the image data ends at the first chunk
    that is not IDAT.  Raises OSError for broken or truncated data (a short
    IHDR: ValueError, as PIL's)."""
    pos, header, palette, idat = 8, None, b"", []
    while True:
        if pos + 8 > len(data):
            if idat:  # no IEND: the image data decides, as PIL reads it
                break
            raise OSError("image file is truncated")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if idat and kind != b"IDAT":
            break
        if not _CHUNK_TYPE(kind):
            raise OSError(f"broken PNG file (chunk {kind!r})")
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        pos += 12 + length
        if len(body) < length:
            if kind == b"IDAT":  # a short stream is caught where it is unfiltered
                idat.append(body)
                break
            raise OSError("image file is truncated")
        if kind == b"IDAT":
            idat.append(body)
            continue
        if kind == b"IEND":
            break
        if kind == b"IHDR" and length < 13:
            raise ValueError("Truncated IHDR chunk")
        if len(crc) < 4 or zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise OSError(f"broken PNG file (bad header checksum in {kind!r})")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = body
    if header is None:
        raise OSError("broken PNG file: no IHDR")
    width, height, depth, color_type, _, filter_method, interlace = header
    if filter_method:
        raise OSError("broken PNG file: unknown filter category")
    _check_size(width, height)
    if (color_type, depth) not in {(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
                                   (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
                                   (6, 16)}:
        raise OSError(f"broken PNG file: colour type {color_type} at {depth} bits")
    if width == 0 or height == 0:
        raise OSError("broken PNG file: empty size")
    if color_type == 3 and not palette:
        raise OSError("broken PNG file: no palette")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    need = 0  # the inflated bytes the image takes: PIL inflates no more
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = max(0, -(-(width - x0) // dx)), max(0, -(-(height - y0) // dy))
        if pw and ph:
            need += ph * (1 + (pw * channels * depth + 7) // 8)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise OSError(f"broken PNG file: {e}") from e
    return PngImage(width, height, depth, color_type, palette, raw, interlace)


def decode_gray(data: bytes) -> np.ndarray:
    """``Image.open(io.BytesIO(data)).convert("L")`` as uint8 [H, W]."""
    data = bytes(data)
    kind, info = identify.identify(data, _check_size)
    if kind == "GIF":
        return gif.decode_gif(data, info)
    if kind == "TIFF":
        return tiff.decode_tiff(data, info, _decode_jpeg_strip)
    if kind == "WEBP":
        return _decode_webp(data)
    lib = _library()
    msg = ctypes.create_string_buffer(_MSG)
    if kind == "PNG":
        png = read_png(data)
        out = np.empty((png.height, png.width), np.uint8)
        code = lib.png_to_gray(png.raw, len(png.raw), png.width, png.height, png.color_type,
                               png.depth, png.interlace, png.palette, len(png.palette) // 3,
                               out.ctypes.data, msg, _MSG)
        if code:
            _raise(code, msg.value)
        return out
    buf = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    code = lib.decode_gray(data, len(data), ctypes.byref(buf), ctypes.byref(w), ctypes.byref(h),
                           msg, _MSG)
    if code:
        _raise(code, msg.value)
    try:
        return np.ctypeslib.as_array(buf, shape=(h.value, w.value)).copy()
    finally:
        lib.image_free(buf)


def _decode_jpeg_strip(strip: bytes, ycc: bool) -> np.ndarray:
    """A JPEG-compressed TIFF strip or tile, its JPEGTables spliced in, as
    libtiff has libjpeg decode it: uint8 [H, W] (``native/imgdecode.cpp``,
    ``decode_jpeg_strip``: SOI first, nothing read after a single scan,
    three components converted from YCbCr if ``ycc``, else as they are)."""
    lib = _library()
    msg = ctypes.create_string_buffer(_MSG)
    buf = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    code = lib.decode_jpeg_strip(strip, len(strip), int(ycc), ctypes.byref(buf),
                                 ctypes.byref(w), ctypes.byref(h), msg, _MSG)
    if code:
        _raise(code, msg.value)
    try:
        return np.ctypeslib.as_array(buf, shape=(h.value, w.value)).copy()
    finally:
        lib.image_free(buf)


def _decode_webp(data: bytes, channels: int = 1) -> np.ndarray:
    """A WebP file as PIL's ``convert("L")`` (``channels`` 1, uint8 [H, W])
    or, for the tests, its ``convert("RGB")`` (3, uint8 [H, W, 3])."""
    lib = _webp_library()
    msg = ctypes.create_string_buffer(_MSG)
    buf = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    code = lib.webp_decode(bytes(data), len(data), channels, ctypes.byref(buf), ctypes.byref(w),
                           ctypes.byref(h), msg, _MSG)
    if code:
        _raise(code, msg.value)
    shape = (h.value, w.value) if channels == 1 else (h.value, w.value, 3)
    try:
        return np.ctypeslib.as_array(buf, shape=shape).copy()
    finally:
        lib.webp_free(buf)


def read_gray(path: str) -> np.ndarray:
    """:func:`decode_gray` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_gray(f.read())


def _gray(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"a grayscale page is uint8 [H, W], got {img.dtype} {img.shape}")
    return img


def resize_gray(img: np.ndarray, out_w: int, out_h: int, filter: str = "bilinear") -> np.ndarray:
    """``Image.resize((out_w, out_h), BILINEAR or BICUBIC)`` of the mode-L
    image ``img`` (uint8 [H, W]); a call that keeps the size returns a
    copy, as ``Image.resize`` does."""
    img = _gray(img)
    if filter not in FILTERS:
        raise ValueError(f"filter {filter!r}: one of {sorted(FILTERS)}")
    if out_w < 1 or out_h < 1 or img.size == 0:
        raise ValueError(f"resize of a {img.shape} image to {out_h}x{out_w}: "
                         "height and width must be > 0")
    if img.shape == (out_h, out_w):
        return img.copy()
    out = np.empty((out_h, out_w), np.uint8)
    _library().resize_gray(img.ctypes.data, img.shape[0], img.shape[1], out.ctypes.data, out_h,
                           out_w, FILTERS[filter])
    return out


def crop_box(box: Sequence[float]) -> Tuple[int, int, int, int]:
    """PIL's ``Image._crop`` rounding of an (x0, y0, x1, y1) box: Python's
    ``round`` (half to even) of each coordinate."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    return x0, y0, x1, y1


def crop_gray(img: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """``Image.crop(box)`` of the mode-L image ``img``, ``box`` (x0, y0, x1,
    y1): the rounded box's pixels, zeros where it leaves the page."""
    img = _gray(img)
    x0, y0, x1, y1 = crop_box(box)
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)), np.uint8)
    if out.size:
        _library().crop_gray(img.ctypes.data, img.shape[0], img.shape[1], x0, y0, x1, y1,
                             out.ctypes.data)
    return out
