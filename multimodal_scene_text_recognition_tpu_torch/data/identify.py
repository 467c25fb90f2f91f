"""Which format ``PIL.Image.open`` takes a file for (JAX counterpart: the
``Image.open`` of the data loaders).

PIL 12.1 walks its plugins in the order of ``Image.ID`` once every plugin
is registered (:data:`ORDER`): a plugin whose ``_accept`` takes the first 16
bytes (or that has none) runs its ``_open``, and an ``_open`` that raises
SyntaxError, IndexError, TypeError, KeyError, EOFError or struct.error
passes the file on to the next plugin; any other error ends the walk.  A
file no plugin takes is "cannot identify image file" (OSError).

:func:`identify` does the same with each plugin's ``_accept`` and the
header checks its ``_open`` makes before it returns: in full for GIF and
TIFF (:mod:`.gif`, :mod:`.tiff`, whose decoders take what they read), for
the plugins that take any file (IM, IMT, IPTC, PCD, SPIDER, TGA) and for the
small headers; the other plugins are taken at their ``_accept`` and the
first checks of their headers.  The JPEG, PNG, BMP, PPM and WebP decoders
of :mod:`.images` read their own headers and raise their own errors, as
before.  It returns the format's name and what its reader needs, or
raises:

* ``NotImplementedError("image decoding: <FORMAT> files are not decoded")``
  for a format PIL decodes and the port does not (:data:`NAMED`, and PIL's
  PNM extensions Pf, P0CMYK and Py*, named "PPM (Pf)" and so on);
* ``OSError`` for a format PIL opens and cannot load where the port runs
  (:data:`UNLOADABLE`: EPS without Ghostscript; BUFR, GRIB, HDF5 and WMF,
  whose loaders are stubs), and for a file no plugin takes;
* what PIL's ``_open`` raises past the walk (an OSError, a ValueError) and
  :class:`~.images.DecompressionBombError` for more than twice PIL's pixel
  limit.
"""

from __future__ import annotations

import re
import struct
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

from . import gif, tiff

# Image.ID after Image.init() in PIL 12.1
ORDER = ("AVIF", "BLP", "BMP", "DIB", "BUFR", "CUR", "PCX", "DCX", "DDS", "EPS", "FITS", "FLI",
         "FTEX", "GBR", "GIF", "GRIB", "HDF5", "PNG", "JPEG2000", "ICNS", "ICO", "IM", "IMT",
         "IPTC", "JPEG", "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PPM", "PSD", "QOI",
         "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")
DECODED = ("JPEG", "PNG", "BMP", "PPM", "WEBP", "GIF", "TIFF")
UNLOADABLE = ("EPS", "BUFR", "GRIB", "HDF5", "WMF")
NAMED = tuple(f for f in ORDER if f not in DECODED and f not in UNLOADABLE)
# Image.open's "not this plugin" errors (ImageFile.__init__ turns the rest
# of these into SyntaxError)
PASS_ON = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)
PPM_MODES = {b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"}
PPM_EXTENSIONS = {b"P0CMYK", b"Pf", b"PyP", b"PyRGBA", b"PyCMYK"}
WEBP_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")
IM_TAGS = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
           "Name", "Scale (x,y)", "Image size (x*y)", "Image type"}
IM_NUMBERS = {"File size (no of images)", "Scale (x,y)", "Image size (x*y)"}
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")
_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")
_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
SGI_MODES = {(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (1, 3, 3), (2, 3, 3), (1, 3, 4),
             (2, 3, 4)}
PSD_MODES = {(0, 1): 1, (0, 8): 1, (1, 8): 1, (2, 8): 1, (3, 8): 3, (4, 8): 4, (7, 8): 1,
             (8, 8): 1, (9, 8): 3}
TGA_DEPTHS = (1, 8, 16, 24, 32)


class Kind(NamedTuple):
    """A format the port decodes, and what its reader read."""

    name: str
    info: Any = None


def _u16(d, o=0, e="<"):
    return struct.unpack_from(e + "H", d, o)[0]


def _u32(d, o=0, e="<"):
    return struct.unpack_from(e + "I", d, o)[0]


def _sized(w, h):
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this plugin")
    return w, h


# --- each plugin's _open, as far as its header checks go --------------------------
# A check returns the (width, height) PIL reads, or None where it does not
# read them here; it raises as PIL's _open raises.

def _blp(d):
    if d[:4] == b"BLP1":
        struct.unpack_from("<iIIIi", d, 4)
    else:
        struct.unpack_from("<ibbb", d, 4)
    return _sized(*struct.unpack_from("<II", d, 12))


def _cur(d):
    count, m = _u16(d, 4), b""
    for i in range(count):
        s = d[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise TypeError("No cursors were found")
    _u32(m, 12)


def _ico(d):
    """IcoFile's header: its entries, and the first one's size (an icon of
    no entry is an IndexError there)."""
    entries = [d[6 + 16 * i:22 + 16 * i] for i in range(_u16(d, 4))]
    for s in entries:
        struct.unpack_from("<HHII", s, 4)
    return entries[0][0] or 256, entries[0][1] or 256


def _pcx(d):
    s = d[:68]
    x0, y0, x1, y1 = (_u16(s, o) for o in (4, 6, 8, 10))
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise SyntaxError("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    if not ((bits == 1 and planes in (1, 2, 4)) or (version == 5 and bits == 8
                                                     and planes in (1, 3))):
        raise OSError("unknown PCX mode")
    return x1 + 1 - x0, y1 + 1 - y0


def _dds(d):
    if _u32(d, 4) != 124:
        raise OSError(f"Unsupported header size {_u32(d, 4)}")
    if len(d[8:128]) != 120:
        raise OSError("Incomplete header")
    height, width = struct.unpack_from("<II", d, 12)
    return _sized(width, height)


def _fits(d):
    card = d[:80]
    value = card[8:].split(b"/")[0].strip()
    if value.startswith(b"="):
        value = value[1:].strip()
    if not card[:8].strip().startswith(b"SIMPLE") or value != b"T":
        raise SyntaxError("Not a FITS file")


def _fli(d):
    s = d[:128]
    if not (s[20:22] == b"\0" * 2 and s[42:80] == b"\0" * 38 and s[88:] == b"\0" * 40):
        raise SyntaxError("not an FLI/FLC file")
    return _sized(_u16(s, 8), _u16(s, 10))


def _gbr(d):
    header, version, width, height, depth = struct.unpack_from(">5I", d)
    if header < 20 or version not in (1, 2) or width == 0 or height == 0 or depth not in (1, 4):
        raise SyntaxError("not a GIMP brush")
    if version == 2 and d[20:24] != b"GIMP":
        raise SyntaxError("not a GIMP brush, bad magic number")
    return width, height


def _im(d):
    """ImImagePlugin: header lines "key: value" up to a NUL, ^Z or the end
    of the file, at least one of them a known key, then ^Z."""
    if b"\n" not in d[:100]:
        raise SyntaxError("not an IM file")
    pos, n, line = 0, 0, b""
    while True:
        s = d[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        end = d.find(b"\n", pos)
        end = len(d) if end < 0 else end + 1
        line, pos = s + d[pos:end], end
        if len(line) > 100:
            raise SyntaxError("not an IM file")
        line = line[:-2] if line.endswith(b"\r\n") else line[:-1] if line.endswith(b"\n") else line
        m = _IM_LINE.match(line)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        key = m.group(1).decode("latin-1", "replace")
        if key in IM_NUMBERS:  # ImImagePlugin's number(): int, else float (ValueError)
            for v in m.group(2).decode("latin-1", "replace").replace("*", ",").split(","):
                try:
                    int(v)
                except ValueError:
                    float(v)
        if key in IM_TAGS:
            n += 1
        s = line
    if not n:
        raise SyntaxError("Not an IM file")
    if b"\x1a" not in d[pos - 1:]:
        raise SyntaxError("File truncated")


def _imt(d):
    """ImtImagePlugin: "width", "height" and "pixel n8" fields before a
    form feed."""
    buf = d[:100]
    if b"\n" not in buf:
        raise SyntaxError("not an IM file")
    pos, size, mode = 100, (0, 0), ""
    xsize = ysize = 0
    while True:
        if buf:
            s, buf = buf[:1], buf[1:]
        else:
            s, pos = d[pos:pos + 1], pos + 1
        if not s or s == b"\x0c":
            break
        if b"\n" not in buf:
            buf += d[pos:pos + 100]
            pos += 100
        lines = buf.split(b"\n")
        s += lines.pop(0)
        buf = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
            size = xsize, ysize
        elif k == b"height":
            ysize = int(v)
            size = xsize, ysize
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode:
        raise SyntaxError("not identified by this plugin")
    return _sized(*size)


def _iptc(d):
    s = d[:5]
    if not s.strip(b"\0"):
        raise KeyError((3, 60))
    if s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")


def _mcidas(d):
    if len(d[:256]) != 256:
        raise SyntaxError("not an McIdas area file")
    w = (0,) + struct.unpack_from("!64i", d)
    if w[11] not in (1, 2, 4):
        raise SyntaxError("unsupported McIdas format")
    return _sized(w[10], w[9])


def _mpeg(d):
    bits = int.from_bytes(d[4:7], "big")
    return _sized(bits >> 12, bits & 0xFFF)


def _msp(d):
    s = d[:32]
    check = 0
    for i in range(0, 32, 2):
        check ^= _u16(s, i)
    if check:
        raise SyntaxError("bad MSP checksum")
    return _sized(_u16(s, 4), _u16(s, 6))


def _pcd(d):
    s = d[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    s[1538]


def _pixar(d):
    s = d[:512]
    w, h = _u16(s, 418), _u16(s, 416)
    if (_u16(s, 424), _u16(s, 426)) != (14, 2):
        raise SyntaxError("not identified by this plugin")
    return _sized(w, h)


def _ppm_magic(d) -> bytes:
    magic = b""
    for c in d[:6]:
        if c in b" \t\n\x0b\x0c\r":
            break
        magic += bytes([c])
    return magic


def _ppm(d):
    magic = _ppm_magic(d)
    if magic not in PPM_MODES and magic not in PPM_EXTENSIONS:
        raise SyntaxError("not a PPM file")
    return magic


def _psd(d):
    s = d[:26]
    if _u16(s, 4, ">") != 1:
        raise SyntaxError("not a PSD file")
    channels = PSD_MODES[(_u16(s, 24, ">"), _u16(s, 22, ">"))]
    if channels > _u16(s, 12, ">"):
        raise OSError("not enough channels")
    return _sized(_u32(s, 18, ">"), _u32(s, 14, ">"))


def _qoi(d):
    w, h = struct.unpack_from(">II", d, 4)
    d[12]
    return _sized(w, h)


def _sgi(d):
    s = d[:512]
    bpc, dim, xs, ys, zs = s[3], _u16(s, 4, ">"), _u16(s, 6, ">"), _u16(s, 8, ">"), _u16(s, 10, ">")
    if (bpc, dim, zs) not in SGI_MODES:
        raise ValueError("Unsupported SGI image mode")
    return _sized(xs, ys)


def _spider_header(t) -> int:
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    if int(h[22]) != int(h[13]) * int(h[23]):
        return 0
    return int(h[22])


def _spider(d):
    f = d[:108]
    try:
        t = struct.unpack(">27f", f)
        if not _spider_header(t):
            t = struct.unpack("<27f", f)
            if not _spider_header(t):
                raise SyntaxError("not a valid Spider file")
    except struct.error as e:
        raise SyntaxError("not a valid Spider file") from e
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    stack, number = int(h[24]), int(h[27])
    if not ((stack == 0 and number >= 0) or (stack > 0 and number == 0)):
        raise SyntaxError("inconsistent stack header values")
    return _sized(int(h[12]), int(h[2]))


def _sun(d):
    s = d[:32]
    w, h, depth = _u32(s, 4, ">"), _u32(s, 8, ">"), _u32(s, 12, ">")
    palette_type, palette_length = _u32(s, 24, ">"), _u32(s, 28, ">")
    if depth not in (1, 4, 8, 24, 32):
        raise SyntaxError("Unsupported Mode/Bit Depth")
    if palette_length and (palette_length > 1024 or palette_type != 1):
        raise SyntaxError("Unsupported Color Palette")
    return _sized(w, h)


def _tga(d):
    """TgaImagePlugin's header checks: no magic, so any file may pass."""
    s = d[:18]
    colormaptype, imagetype, depth, flags = s[1], s[2], s[16], s[17]
    w, h = _u16(s, 12), _u16(s, 14)
    if colormaptype not in (0, 1) or w <= 0 or h <= 0 or depth not in TGA_DEPTHS:
        raise SyntaxError("not a TGA file")
    if imagetype not in (1, 2, 3, 9, 10, 11):
        raise SyntaxError("unknown TGA mode")
    if flags & 0x30 not in (0, 0x10, 0x20, 0x30):
        raise SyntaxError("unknown TGA orientation")
    if colormaptype and s[7] not in (16, 24, 32):
        raise SyntaxError("unknown TGA map depth")
    return w, h


def _xbm(d):
    m = _XBM_HEAD.match(d[:512])
    if not m:
        raise SyntaxError("not a XBM file")
    return _sized(int(m.group("width")), int(m.group("height")))


def _xpm(d):
    for line in d[9:].splitlines(keepends=True):
        if _XPM_HEAD.match(line):
            return None
    raise SyntaxError("broken XPM file")


def _xvthumb(d):
    for s in d[6:].split(b"\n")[1:]:
        if s[0] != 35:
            w, h = s.strip().split(maxsplit=2)[:2]
            return _sized(int(w), int(h))
    raise SyntaxError("Unexpected EOF reading XV thumbnail file")


def _wmf(d):
    s = d[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        if _u16(s, 14) == 0:
            raise ValueError("Invalid inch")
        if s[22:26] != b"\x01\x00\t\x00":
            raise SyntaxError("Unsupported WMF file format")
    elif not (s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF"):
        raise SyntaxError("Unsupported file format")


def _eps(d):
    if b"%!PS-Adobe" not in d[:1024] and not d.startswith(b"\xc5\xd0\xd3\xc6"):
        raise SyntaxError('EPS header missing "%!PS-Adobe" comment')


def _avif_accept(p):
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


def _none(d):
    return None


# format -> (_accept of the first 16 bytes or None, _open's checks)
PLUGINS: Dict[str, Tuple[Optional[Callable[[bytes], bool]], Callable[[bytes], Any]]] = {
    "AVIF": (_avif_accept, _none),
    "BLP": (lambda p: p.startswith((b"BLP1", b"BLP2")), _blp),
    "BMP": (lambda p: p.startswith(b"BM"), _none),
    "DIB": (lambda p: _u32(p) in (12, 40, 52, 56, 64, 108, 124), _none),
    "BUFR": (lambda p: p.startswith((b"BUFR", b"ZCZC")), _none),
    "CUR": (lambda p: p.startswith(b"\0\0\2\0"), _cur),
    "PCX": (lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5), _pcx),
    "DCX": (lambda p: len(p) >= 4 and _u32(p) == 0x3ADE68B1, _none),
    "DDS": (lambda p: p.startswith(b"DDS "), _dds),
    "EPS": (lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and _u32(p) == 0xC6D3D0C5), _eps),
    "FITS": (lambda p: p.startswith(b"SIMPLE"), _fits),
    "FLI": (lambda p: len(p) >= 16 and _u16(p, 4) in (0xAF11, 0xAF12)
            and _u16(p, 14) in (0, 3), _fli),
    "FTEX": (lambda p: p.startswith(b"FTEX"), _none),
    "GBR": (lambda p: len(p) >= 8 and _u32(p, 0, ">") >= 20 and _u32(p, 4, ">") in (1, 2), _gbr),
    "GIF": (lambda p: p.startswith(gif.MAGIC), None),
    "GRIB": (lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1, _none),
    "HDF5": (lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"), _none),
    "PNG": (lambda p: p.startswith(b"\x89PNG\r\n\x1a\n"), _none),
    "JPEG2000": (lambda p: p.startswith((b"\xff\x4f\xff\x51",
                                         b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")), _none),
    "ICNS": (lambda p: p.startswith(b"icns"), _none),
    "ICO": (lambda p: p.startswith(b"\0\0\1\0"), _ico),
    "IM": (None, _im),
    "IMT": (None, _imt),
    "IPTC": (None, _iptc),
    "JPEG": (lambda p: p.startswith(b"\xff\xd8\xff"), _none),
    "MCIDAS": (lambda p: p.startswith(b"\0\0\0\0\0\0\0\4"), _mcidas),
    "MPEG": (lambda p: p.startswith(b"\0\0\1\xb3"), _mpeg),
    "TIFF": (lambda p: p.startswith(tiff.PREFIXES), None),
    "MSP": (lambda p: p.startswith((b"DanM", b"LinS")), _msp),
    "PCD": (None, _pcd),
    "PIXAR": (lambda p: p.startswith(b"\200\350\000\000"), _pixar),
    "PPM": (lambda p: len(p) >= 2 and p.startswith(b"P") and p[1] in b"0123456fy", _ppm),
    "PSD": (lambda p: p.startswith(b"8BPS"), _psd),
    "QOI": (lambda p: p.startswith(b"qoif"), _qoi),
    "SGI": (lambda p: len(p) >= 2 and _u16(p, 0, ">") == 474, _sgi),
    "SPIDER": (None, _spider),
    "SUN": (lambda p: len(p) >= 4 and _u32(p, 0, ">") == 0x59A66A95, _sun),
    "TGA": (None, _tga),
    "WEBP": (lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP" and p[12:16] in WEBP_CHUNKS,
             _none),
    "WMF": (lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")), _wmf),
    "XBM": (lambda p: p.lstrip().startswith(b"#define"), _xbm),
    "XPM": (lambda p: p.startswith(b"/* XPM */"), _xpm),
    "XVTHUMB": (lambda p: p.startswith(b"P7 332"), _xvthumb),
}


def identify(data: bytes, check_size: Callable[[int, int], None]) -> Kind:
    """The format PIL 12.1's ``Image.open`` takes ``data`` for, and its
    reader's state for GIF and TIFF; raises as described above.
    ``check_size(w, h)`` is PIL's decompression-bomb check."""
    prefix = data[:16]
    for name in ORDER:
        accept, check = PLUGINS[name]
        try:
            if accept is not None and not accept(prefix):
                continue
            if name == "GIF":
                info = gif.open_gif(data, check_size)
                check_size(*info.size)
                return Kind(name, info)
            if name == "TIFF":
                info = tiff.open_tiff(data, check_size)
                return Kind(name, info)
            found = check(data)
        except PASS_ON:
            continue
        if name == "PPM" and found not in PPM_MODES:
            raise NotImplementedError(f"image decoding: PPM ({found.decode()}) files are not "
                                      "decoded")
        if isinstance(found, tuple):
            check_size(*found)
        if name in DECODED:
            return Kind(name)
        if name in UNLOADABLE:
            raise OSError(f"cannot load {name} files (PIL opens them and cannot load them "
                          "without an outside program)")
        raise NotImplementedError(f"image decoding: {name} files are not decoded")
    raise OSError("cannot identify image file")
