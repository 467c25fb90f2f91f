"""GIF files as PIL reads them: ``Image.open(f).convert("L")`` of frame 0,
bit for bit (JAX counterpart: the PIL calls of the data loaders).

:func:`open_gif` is GifImagePlugin's ``_open`` and ``_seek(0)``: the
logical screen and its global colour table, the extensions before the
first image (a graphic-control extension's transparency index; comment,
application and unknown extensions skipped as PIL skips them) and the image
descriptor.  Where PIL's reader raises one of the errors ``Image.open``
takes for "not this format" (SyntaxError, IndexError, struct.error,
EOFError), so does this, and :mod:`.identify` goes on to the next format.

:func:`decode_gif` then decodes the LZW data in ``native/gifdecode.cpp``
(built at first use with ``g++``; a failed build raises) into the canvas PIL
prepares, and maps it to L:

* a colour table that is the identity grey ramp is dropped, as
  ``_is_palette_needed`` drops it: the frame opens in mode L and its raw
  indices are the pixels (a local ramp drops the global table too);
* otherwise mode P, whose L is ``(R*19595 + G*38470 + B*7471 + 0x8000) >>
  16`` of each entry, and 0 for an index past the table;
* a frame that leaves the screen grows it; the canvas outside the frame
  holds the frame's transparency index if it has one, else 0;
* a frame of zero width at x 0 is the whole canvas (PIL's ``setimage``);
  another empty or outside frame raises ValueError, as PIL's does;
* frames after the first are not read.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional

import numpy as np

from ..utils import native

SOURCE = native.NATIVE_DIR / "gifdecode.cpp"
BUILD_DIR = native.BUILD_DIR
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
MAGIC = (b"GIF87a", b"GIF89a")

_lib: Optional[ctypes.CDLL] = None
_MSG = 256


class GifFrame(NamedTuple):
    """Frame 0 as ``_seek(0)`` leaves it."""

    size: tuple  # (W, H) of the canvas, grown to hold the frame
    extent: tuple  # (x0, y0, x1, y1)
    palette: Optional[bytes]  # the frame's colour table; None for mode L
    transparency: Optional[int]
    interlace: bool
    bits: int  # the LZW minimum code size
    offset: int  # of the first sub-block of image data


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load_library(SOURCE, CXX_FLAGS, "the GIF decoder", BUILD_DIR)
    lib.gif_decode.argtypes = ([ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t]
                               + [ctypes.c_int] * 9
                               + [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int])
    lib.gif_decode.restype = ctypes.c_int
    _lib = lib
    return lib


def _palette_needed(p: bytes) -> bool:
    """GifImagePlugin's ``_is_palette_needed``, its chained comparison and
    its IndexError on a cut table included."""
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def block(self) -> Optional[bytes]:
        """GifImageFile.data: one sub-block, None at its end."""
        s = self.read(1)
        if s and s[0]:
            return self.read(s[0])
        return None


def open_gif(data: bytes, check_size) -> GifFrame:
    """GifImagePlugin's ``_open`` and ``_seek(0)`` of ``data``;
    ``check_size(w, h)`` is PIL's decompression-bomb check."""
    f = _Reader(data)
    s = f.read(13)
    if not s.startswith(MAGIC):
        raise SyntaxError("not a GIF file")
    width, height = struct.unpack_from("<HH", s, 6)
    flags = s[10]
    global_palette = None
    if flags & 128:
        p = f.read(3 << ((flags & 7) + 1))
        if _palette_needed(p):
            global_palette = p
    s = f.read(1)
    if not s or s == b";":
        raise EOFError("no more images in GIF file")
    palette = None  # None: no local table; False: a local grey ramp
    transparency = interlace = extent = None
    while True:
        if not s:
            s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = f.read(1)
            block = f.block()
            if s[0] == 249 and block is not None:
                if block[0] & 1:
                    transparency = block[3]
                struct.unpack_from("<H", block, 1)  # the duration, read as PIL reads it
            elif s[0] == 254:
                while block:
                    block = f.block()
                s = b""
                continue
            elif s[0] == 255 and block is not None:
                if block.startswith(b"NETSCAPE2.0"):
                    f.block()
            while f.block():
                pass
        elif s == b",":
            s = f.read(9)
            x0, y0, w, h = struct.unpack_from("<HHHH", s)
            x1, y1 = x0 + w, y0 + h
            if x1 > width or y1 > height:
                width, height = max(x1, width), max(y1, height)
                check_size(width, height)
            extent = (x0, y0, x1, y1)
            flags = s[8]
            interlace = bool(flags & 64)
            if flags & 128:
                p = f.read(3 << ((flags & 7) + 1))
                palette = p if _palette_needed(p) else False
            bits = f.read(1)[0]
            offset = f.pos
            break
        s = b""
    if interlace is None:
        raise EOFError("image not found in GIF frame")
    if width <= 0 or height <= 0:
        raise SyntaxError("not identified by this plugin")
    frame_palette = palette if palette is not None else global_palette
    return GifFrame((width, height), extent, frame_palette or None, transparency, interlace,
                    bits, offset)


def decode_gif(data: bytes, frame: GifFrame) -> np.ndarray:
    """Frame 0 of a GIF, opened by :func:`open_gif`, as PIL's
    ``convert("L")``: uint8 [H, W]."""
    W, H = frame.size
    x0, y0, x1, y1 = frame.extent
    if x0 == 0 and x1 == 0:  # PIL's setimage: the whole image
        x0 = y0 = 0
        x1, y1 = W, H
    if x1 - x0 <= 0 or x1 > W or y1 - y0 <= 0 or y1 > H:
        raise ValueError("tile cannot extend outside image")
    if frame.palette is None:
        lut = np.arange(256, dtype=np.uint8)
    else:
        rgb = np.frombuffer(frame.palette[:len(frame.palette) // 3 * 3], np.uint8)
        rgb = rgb.reshape(-1, 3).astype(np.int64)
        lut = np.zeros(256, np.uint8)
        lut[:len(rgb)] = (rgb[:, 0] * 19595 + rgb[:, 1] * 38470 + rgb[:, 2] * 7471
                          + 0x8000) >> 16
    out = np.empty((H, W), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    fill = frame.transparency if frame.transparency is not None else 0
    code = _library().gif_decode(data, len(data), frame.offset, frame.bits,
                                 int(frame.interlace), x0, y0, x1 - x0, y1 - y0, W, H, fill,
                                 lut.tobytes(), out.ctypes.data, msg, _MSG)
    if code:
        raise OSError(msg.value.decode(errors="replace"))
    return out
