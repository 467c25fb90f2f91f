"""The port's image decoding, resizing and cropping (``data/images``, the C++
of ``native/imgdecode.cpp`` and ``native/webpdecode.cpp``) against PIL,
which the JAX loaders call, and its numpy mirror (``data/images_plain``)
against the C++: bit for bit on every case.  Images are made here from
seeded arrays, by PIL or, in the kinds PIL does not write, by
``tests/image_writers.py``; the kinds the mirror does not cover
(progressive and CMYK/YCCK JPEG, interlaced and 16-bit PNG, the other BMPs
and PNMs, WebP) are held to PIL alone."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import image_writers as iw
from multimodal_scene_text_recognition_tpu_torch.data import identify, images
from multimodal_scene_text_recognition_tpu_torch.data import images_plain as plain
from multimodal_scene_text_recognition_tpu_torch.utils import images as uimages
from multimodal_scene_text_recognition_tpu_torch.utils import native
import torch_threads

torch_threads.limit()


def smooth(h, w, channels, seed):
    """A photo-like array: bicubic-smoothed blobs plus mild noise."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.uint8)
    a = np.asarray(Image.fromarray(low).resize((w, h), Image.BICUBIC), np.int32)
    a = np.clip(a + rng.integers(-24, 24, a.shape), 0, 255).astype(np.uint8)
    return a if channels == 3 else a[..., 0]


def encoded(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, **kw)
    return buf.getvalue()


def to_440(data: bytes) -> bytes:
    """A 4:4:0 JPEG from a 4:2:2 one: its frame's width and height swapped
    and the luma sampling 2x1 made 1x2, which keeps the MCU count, so the
    scan stays valid (PIL cannot write 4:4:0)."""
    d = bytearray(data)
    i = d.index(b"\xff\xc0")
    h, w = struct.unpack(">HH", d[i + 5:i + 9])
    d[i + 5:i + 9] = struct.pack(">HH", w, h)
    assert d[i + 11] == 0x21
    d[i + 11] = 0x12
    return bytes(d)


def held(data: bytes):
    """The C++ equals PIL's ``open().convert("L")`` and the mirror equals
    the C++, bit for bit."""
    want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    got = images.decode_gray(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain.decode_gray_plain(data), got)


SIZES = {"1x1": (1, 1), "17x9": (9, 17), "333x77": (77, 333)}  # width x height
SAMPLING = {"grey": None, "4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "4:4:0": "440"}


@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("size", list(SIZES))
def test_jpeg_matches_pil(size, sampling, quality):
    """Baseline JPEGs at every sampling factor and three qualities, at sizes
    that are not whole MCUs."""
    h, w = SIZES[size]
    sub = SAMPLING[sampling]
    if sub is None:
        data = encoded(Image.fromarray(smooth(h, w, 1, quality)), format="JPEG", quality=quality)
    elif sub == "440":  # the 4:2:2 file transposed: the frame is w high, h wide
        data = to_440(encoded(Image.fromarray(smooth(w, h, 3, quality)), format="JPEG",
                              quality=quality, subsampling=1))
    else:
        data = encoded(Image.fromarray(smooth(h, w, 3, quality)), format="JPEG",
                       quality=quality, subsampling=sub)
    held(data)


@pytest.mark.parametrize("extra", [{"optimize": True}, {"restart_marker_blocks": 3},
                                   {"restart_marker_rows": 1}], ids=["optimize", "rst-blocks",
                                                                     "rst-rows"])
@pytest.mark.parametrize("sampling", ["grey", "4:4:4", "4:2:0"])
def test_jpeg_tables_and_restarts_match_pil(sampling, extra):
    """Optimized Huffman tables and restart intervals (markers every 3 MCUs,
    or every MCU row)."""
    img = Image.fromarray(smooth(77, 333, 1 if sampling == "grey" else 3, 7))
    kw = {} if sampling == "grey" else {"subsampling": SAMPLING[sampling]}
    held(encoded(img, format="JPEG", quality=80, **kw, **extra))


def png(w, h, depth, color_type, rows, palette=b""):
    """A PNG written by hand from filter-tagged rows (PIL writes no grey
    image of 2 or 4 bits)."""
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I",
                                                                         zlib.crc32(kind + body))
    raw = b"".join(bytes([f]) + r for f, r in rows)
    return (images.PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0))
            + (chunk(b"PLTE", palette) if palette else b"")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _png_case(name, seed):
    rng = np.random.default_rng(seed)
    h, w = 9, 17
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (h, w), dtype=np.uint8)
    if name.startswith("L") and name[1:] in ("2", "4"):  # by hand, every filter type
        depth = int(name[1:])
        rb = (w * depth + 7) // 8
        return png(w, h, depth, 0, [(y % 5, rng.integers(0, 256, rb, dtype=np.uint8).tobytes())
                                    for y in range(h)])
    if name.startswith("P"):
        bits = int(name[1:])
        im = Image.fromarray(rng.integers(0, 1 << bits, (h, w), dtype=np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 << bits, dtype=np.uint8).tobytes())
        return encoded(im, format="PNG", bits=bits)
    im = {"L8": lambda: Image.fromarray(grey), "L1": lambda: Image.fromarray(grey > 127),
          "RGB": lambda: Image.fromarray(rgb),
          "RGBA": lambda: Image.fromarray(np.dstack([rgb, grey])),
          "LA": lambda: Image.merge("LA", [Image.fromarray(grey), Image.fromarray(grey[::-1])])
          }[name]()
    return encoded(im, format="PNG", optimize=seed % 2 == 0)


@pytest.mark.parametrize("name", ["L1", "L2", "L4", "L8", "RGB", "RGBA", "LA", "P1", "P2", "P4",
                                  "P8"])
def test_png_matches_pil(name):
    """PNG in every colour type at 8 bits, grey at 1, 2 and 4 bits, palette
    at 1, 2, 4 and 8 bits."""
    held(_png_case(name, len(name)))


@pytest.mark.parametrize("fmt,mode", [("BMP", "L"), ("BMP", "P"), ("BMP", "RGB"), ("PPM", "L"),
                                      ("PPM", "RGB")])
def test_bmp_and_pnm_match_pil(fmt, mode):
    """Uncompressed 8-bit (grey and palette) and 24-bit BMP; P5 and P6."""
    rng = np.random.default_rng(3)
    if mode == "RGB":
        im = Image.fromarray(rng.integers(0, 256, (13, 21, 3), dtype=np.uint8))
    else:
        im = Image.fromarray(rng.integers(0, 256, (13, 21), dtype=np.uint8), mode)
        if mode == "P":
            im.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    held(encoded(im, format=fmt))


RESIZES = [((32, 100), (32, 100)), ((64, 200), (32, 100)), ((20, 60), (32, 100)),
           ((47, 213), (32, 100)), ((32, 100), (32, 33)), ((9, 17), (40, 5)),
           ((1, 1), (32, 100)), ((480, 640), (32, 100))]


@pytest.mark.parametrize("filter", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                                                  for a, b in RESIZES])
def test_resize_matches_pil(src, dst, filter):
    """``Image.resize`` of a mode-L image, up and down in each direction,
    the size kept (a copy), from and to one pixel."""
    img = np.random.default_rng(sum(src)).integers(0, 256, src, dtype=np.uint8)
    pil = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[filter]
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], pil))
    got = images.resize_gray(img, dst[1], dst[0], filter)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain.resize_gray_plain(img, dst[1], dst[0], filter), got)
    if src == dst:
        assert got is not img and not np.shares_memory(got, img)


CROPS = [(0, 0, 70, 50), (10.5, 3.5, 40.5, 20.5), (11.49, 7.51, 31.5, 29.5),
         (-5.2, -3.0, 20.0, 10.7), (60.2, 40.7, 90.1, 70.3), (-10, -10, -2, -2),
         (2.5, 2.5, 3.5, 3.5), (30, 20, 30, 40)]


@pytest.mark.parametrize("box", CROPS, ids=[str(b) for b in CROPS])
def test_crop_matches_pil(box):
    """``Image.crop``: coordinates rounded half to even, zeros outside the
    page, empty boxes."""
    img = np.random.default_rng(5).integers(1, 256, (50, 70), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).crop(box))
    got = images.crop_gray(img, box)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain.crop_gray_plain(img, box), got)


@pytest.mark.parametrize("shape", [(32, 100, 1), (17, 9), (5, 7, 3)])
def test_png_writer_reads_back_in_pil(shape, tmp_path):
    """``save_image`` writes a PNG that PIL reads bit for bit, and so does
    the decoder; float crops go through ``array_to_image`` as in JAX."""
    from multimodal_scene_text_recognition_tpu.utils import images as jimages

    arr = np.random.default_rng(len(shape)).random(shape).astype(np.float32)
    path = str(tmp_path / "crop.png")
    uimages.save_image(arr, path)
    want = jimages.array_to_image(arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(images.read_gray(path),
                                  np.asarray(Image.open(path).convert("L")))
    with pytest.raises(NotImplementedError, match="PNG files only"):
        uimages.save_image(arr, str(tmp_path / "crop.jpg"))


def _jpeg():
    return encoded(Image.fromarray(smooth(40, 60, 3, 11)), format="JPEG", quality=75)


BROKEN = {
    "12-bit": lambda: iw.retag_frame(_jpeg(), precision=12),
    "hierarchical JPEG": lambda: iw.retag_frame(_jpeg(), marker=0xC5),
    "truncated JPEG": lambda: _jpeg()[:len(_jpeg()) // 2],
    "JPEG without EOI": lambda: _jpeg()[:-2],
    "JPEG header cut": lambda: _jpeg()[:120],
    "not an image": lambda: b"notanimage",
    "empty": lambda: b"",
    "truncated PNG": lambda: _png_case("RGB", 1)[:60],
    "truncated BMP": lambda: encoded(Image.fromarray(smooth(13, 21, 3, 1)), format="BMP")[:300],
    "truncated PPM": lambda: encoded(Image.fromarray(smooth(13, 21, 3, 1)), format="PPM")[:100],
}


@pytest.mark.parametrize("name", list(BROKEN))
def test_broken_data_raises_oserror(name):
    """Broken or truncated data raises an OSError in PIL, the C++ and the
    mirror (LmdbReader's dummy substitution catches it)."""
    data = BROKEN[name]()
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).convert("L")
    with pytest.raises(OSError):
        images.decode_gray(data)
    with pytest.raises(OSError):
        plain.decode_gray_plain(data)


UNSUPPORTED = {
    "arithmetic-coded JPEG": lambda: _jpeg().replace(b"\xff\xc0", b"\xff\xc9", 1),
    "lossless JPEG": lambda: iw.retag_frame(_jpeg(), marker=0xC3),
    "GIF": lambda: encoded(Image.fromarray(smooth(20, 30, 1, 2)), format="GIF"),
    "TIFF": lambda: encoded(Image.fromarray(smooth(20, 30, 1, 2) > 128), format="TIFF",
                            compression="group4"),
}
DECODED_NOT_MIRRORED = {"GIF"}  # the C++ decodes these; the numpy mirror does not


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_formats_not_covered_raise_not_implemented(name):
    """A file of a kind a decoder does not cover raises NotImplementedError
    naming it (not OSError: no loader takes it for a broken record).  The
    lossless JPEG is a baseline file retagged SOF3: its frame marker is
    what is refused.  GIF is decoded by the C++ (equal to PIL) and not
    mirrored; a CCITT (group 4) TIFF is decoded by neither."""
    data = UNSUPPORTED[name]()
    decoders = [plain.decode_gray_plain]
    if name in DECODED_NOT_MIRRORED:
        np.testing.assert_array_equal(images.decode_gray(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("L")))
    else:
        decoders.append(images.decode_gray)
    for decode in decoders:
        with pytest.raises(NotImplementedError, match=name):
            decode(data)


def test_decoder_raises_when_it_cannot_be_built(monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile, or no compiler,
    raises RuntimeError."""
    bad = tmp_path / "imgdecode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(images, "_lib", None)
    monkeypatch.setattr(images, "SOURCE", bad)
    monkeypatch.setattr(images, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed"):
        images.decode_gray(_jpeg())
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        images.decode_gray(_jpeg())
    assert not list((tmp_path / "_build").glob("*.so"))


# --- the kinds the mirror does not cover, held to PIL alone -------------------------


def pil_equal(data: bytes):
    """The C++ equals PIL's ``open().convert("L")`` bit for bit; the mirror
    raises NotImplementedError for a kind it does not cover, and equals the
    C++ where it does (a BMP palette or header it knows)."""
    want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    got = images.decode_gray(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    try:
        mirrored = plain.decode_gray_plain(data)
    except NotImplementedError:
        return
    np.testing.assert_array_equal(mirrored, got)


def _progressive(size, sampling, seed, **kw):
    h, w = SIZES[size] if isinstance(size, str) else size
    if sampling == "grey":
        return encoded(Image.fromarray(smooth(h, w, 1, seed)), format="JPEG", progressive=True, **kw)
    return encoded(Image.fromarray(smooth(h, w, 3, seed)), format="JPEG", progressive=True,
                   subsampling=SAMPLING[sampling], **kw)


@pytest.mark.parametrize("sampling", ["grey", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", list(SIZES))
def test_progressive_jpeg_matches_pil(size, sampling):
    """Progressive JPEGs (PIL's scan script: DC and AC first scans, then
    successive-approximation refinements) at every sampling, at sizes that
    are not whole MCUs, at two qualities."""
    for quality in (40, 90):
        pil_equal(_progressive(size, sampling, quality, quality=quality))


@pytest.mark.parametrize("extra", [{"optimize": True}, {"restart_marker_blocks": 3},
                                   {"restart_marker_rows": 1}], ids=["optimize", "rst-blocks",
                                                                     "rst-rows"])
@pytest.mark.parametrize("sampling", ["grey", "4:4:4", "4:2:0"])
def test_progressive_tables_and_restarts_match_pil(sampling, extra):
    """Optimized Huffman tables (long EOB runs) and restart intervals, which
    reset the EOB run as well as the DC predictions."""
    pil_equal(_progressive((77, 333), sampling, 7, quality=80, **extra))


@pytest.mark.parametrize("keep", range(1, 10))
def test_progressive_scans_cut_match_pil(keep):
    """A progressive JPEG with only its first ``keep`` scans, EOI kept: the
    low bits its scans leave unsent make libjpeg-turbo smooth the blocks
    (the 5x5 estimate of the first AC coefficients, and of the DC too where
    a component has no AC data yet); a 4:2:0 colour file (10 scans) and a
    grey one (6 scans), the colour one also cut in the middle of a scan."""
    data = _progressive((77, 333), "4:2:0", 3, quality=85)
    assert iw.n_scans(data) == 10
    pil_equal(iw.cut_scans(data, keep))
    grey = _progressive((40, 61), "grey", 4, quality=70)
    pil_equal(iw.cut_scans(grey, min(keep, 5)))
    cut = iw.cut_scans(data, keep + 1)
    pil_equal(cut[:len(cut) - 2 - 150] + b"\xff\xd9")


def _cmyk(sampling, seed, progressive=False):
    h, w = 37, 61
    a = np.asarray(Image.fromarray(smooth(h, w, 3, seed)).convert("CMYK")).copy()
    a[..., 3] = smooth(h, w, 1, seed + 1) // 3
    return encoded(Image.fromarray(a, "CMYK"), format="JPEG", quality=85,
                   subsampling=SAMPLING[sampling], progressive=progressive)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("adobe", ["CMYK", "no Adobe", "YCCK", "YCCK transform 1"])
def test_cmyk_and_ycck_jpeg_match_pil(adobe, sampling, progressive):
    """Four-component JPEGs: PIL reads the CMYK inverted ("CMYK;I") with or
    without an Adobe marker, libjpeg converts YCCK (Adobe transform 2, and
    any other non-zero transform) to CMYK first, and convert("L") goes
    through Pillow's multiplicative CMYK -> RGB."""
    data = _cmyk(sampling, 5, progressive)
    data = {"CMYK": data, "no Adobe": iw.adobe_transform(data, None),
            "YCCK": iw.adobe_transform(data, 2),
            "YCCK transform 1": iw.adobe_transform(data, 1)}[adobe]
    pil_equal(data)


def test_cmyk_conversion_is_pillows():
    """The probe behind the CMYK path: (10, 200, 30, 40) reads L 111 in PIL,
    not the 91 of a subtractive conversion, and the decoder gives it."""
    im = Image.new("CMYK", (8, 8), (10, 200, 30, 40))
    assert im.convert("L").getpixel((0, 0)) == 111
    data = encoded(im, format="JPEG", quality=100, subsampling=0)
    pil_equal(data)


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _samples(rng, h, w, color_type, depth):
    if color_type == 0 and depth == 16:  # values on both sides of 255, which L clips
        return rng.choice([0, 1, 100, 255, 256, 300, 4000, 65535], (h, w))
    return rng.integers(0, 1 << depth, (h, w, iw.PNG_CHANNELS[color_type]))


@pytest.mark.parametrize("size", [(1, 1), (5, 3), (3, 5), (9, 17)], ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", PNG_KINDS, ids=lambda k: f"type{k[0]}-{k[1]}bit")
def test_interlaced_png_matches_pil(kind, size):
    """Adam7 PNGs of every colour type and depth, every filter type, at
    sizes whose small passes are empty (1x1, 3x5) and others; the same
    image non-interlaced too."""
    color_type, depth = kind
    rng = np.random.default_rng(depth * 10 + color_type)
    img = _samples(rng, *size, color_type, depth)
    pal = rng.integers(0, 256, 3 << depth, dtype=np.uint8).tobytes() if color_type == 3 else b""
    pil_equal(iw.png(img, depth, color_type, pal, interlace=True, first_filter=sum(size)))
    if depth == 16 or size == (9, 17):
        data = iw.png(img, depth, color_type, pal)
        if depth == 16:
            pil_equal(data)
        else:
            held(data)


@pytest.mark.parametrize("name", ["grey", "grey+tRNS", "RGB", "LA", "RGBA"])
def test_16bit_png_matches_pil(name):
    """16-bit PNGs: grey is PIL's "I;16", which convert("L") clips at 255
    (not scales); RGB, LA and RGBA take the high bytes (";16B" raw modes);
    a tRNS chunk changes no grey value."""
    rng = np.random.default_rng(len(name))
    color_type = {"grey": 0, "grey+tRNS": 0, "RGB": 2, "LA": 4, "RGBA": 6}[name]
    img = _samples(rng, 13, 21, color_type, 16)
    extra = iw.png_chunk(b"tRNS", struct.pack(">H", 300)) if name == "grey+tRNS" else b""
    for interlace in (False, True):
        pil_equal(iw.png(img, 16, color_type, interlace=interlace, extra=extra))


def test_16bit_grey_png_clips():
    """The probe: 0, 100, 255, 256, 65535 read 0, 100, 255, 255, 255."""
    data = iw.png(np.array([[0, 100, 255, 256, 65535]]), 16, 0)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("L")),
                                  [[0, 100, 255, 255, 255]])
    pil_equal(data)


def _bmp_case(name):
    rng = np.random.default_rng(len(name))
    h, w = 13, 21

    def palette(n):
        return [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(n)]

    def indexed(bits, **kw):
        idx = rng.integers(0, 1 << bits, (h, w))
        return iw.bmp(w, h, bits, [iw.pack_bits(r, bits) for r in idx], palette(1 << bits), **kw)

    def direct(bits, **kw):
        return iw.bmp(w, h, bits, [rng.integers(0, 256, w * bits // 8, dtype=np.uint8).tobytes()
                                   for _ in range(h)], **kw)

    runs = rng.integers(0, 5, (h, w))
    runs[:, :w // 2] = runs[:, :1]  # long encoded runs, then absolute ones
    return {
        "1-bit": lambda: indexed(1),
        "1-bit black-white": lambda: iw.bmp(w, h, 1, [iw.pack_bits(r, 1) for r in
                                                        rng.integers(0, 2, (h, w))],
                                              [(0, 0, 0), (255, 255, 255)]),
        "4-bit": lambda: indexed(4),
        "4-bit top-down": lambda: indexed(4, top_down=True),
        "8-bit 12-byte header": lambda: indexed(8, header=12),
        "8-bit 124-byte header": lambda: indexed(8, header=124),
        "8-bit grey palette": lambda: iw.bmp(w, h, 8, [bytes(r) for r in rng.integers(
            0, 256, (h, w), dtype=np.uint8)], [(i, i, i) for i in range(256)]),
        "16-bit": lambda: direct(16),
        "16-bit 565 bitfields": lambda: direct(16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "16-bit 555 bitfields": lambda: direct(16, compression=3, masks=(0x7C00, 0x3E0, 0x1F),
                                               header=56),
        "24-bit bitfields": lambda: direct(24, compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
        "32-bit": lambda: direct(32),
        "32-bit BGRX bitfields": lambda: direct(32, compression=3,
                                                masks=(0xFF0000, 0xFF00, 0xFF, 0)),
        "32-bit XBGR bitfields": lambda: direct(32, compression=3,
                                                masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
        "32-bit RGBA bitfields": lambda: direct(32, compression=3, header=108,
                                                masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
        "32-bit BGAR bitfields": lambda: direct(32, compression=3, header=124,
                                                masks=(0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
        "RLE8": lambda: iw.bmp(w, h, 8, palette=palette(256), compression=1,
                               data=iw.rle8(runs)),
        "RLE8 grey": lambda: iw.bmp(w, h, 8, palette=[(i, i, i) for i in range(256)],
                                    compression=1, data=iw.rle8(runs)),
        # a delta (PIL reads two bytes past the escape's and moves by the
        # second pair), end-of-line codes on part-filled rows
        "RLE8 delta": lambda: iw.bmp(w, h, 8, palette=palette(256), compression=1, data=bytes(
            [3, 7, 0, 0, 0, 2, 9, 9, 2, 1, 4, 5, 0, 0]) + bytes([w, 2, 0, 0]) * h + b"\x00\x01"),
        # encoded runs cut at the row's end, an odd absolute run (PIL drops
        # its last pixel), word alignment
        "RLE4": lambda: iw.bmp(w, h, 4, palette=palette(16), compression=2, data=bytes(
            [5, 0x3A, 0, 5, 0x12, 0x34, 0x50, 0, w, 0xC1, 0, 0] * h) + b"\x00\x01"),
    }[name]()


BMP_KINDS = ["1-bit", "1-bit black-white", "4-bit", "4-bit top-down", "8-bit 12-byte header",
             "8-bit 124-byte header", "8-bit grey palette", "16-bit", "16-bit 565 bitfields",
             "16-bit 555 bitfields", "24-bit bitfields", "32-bit", "32-bit BGRX bitfields",
             "32-bit XBGR bitfields", "32-bit RGBA bitfields", "32-bit BGAR bitfields", "RLE8",
             "RLE8 grey", "RLE8 delta", "RLE4"]


@pytest.mark.parametrize("name", BMP_KINDS)
def test_bmp_variants_match_pil(name):
    """The BMPs PIL decodes beyond 8- and 24-bit: 1/4-bit palettes (a
    black-white or grey-ramp palette makes PIL's mode "1" or "L"),
    top-down rows, the 12-byte and v5 headers, 16-bit 5-5-5 and 5-6-5,
    32-bit, each BI_BITFIELDS layout PIL knows, RLE8 and RLE4."""
    pil_equal(_bmp_case(name))


def _pnm_case(name):
    rng = np.random.default_rng(len(name))
    h, w = 11, 19
    kind, maxval = {"P1": (1, 1), "P4": (4, 1), "P2": (2, 255), "P3": (3, 255),
                    "P2 maxval 1000": (2, 1000), "P5 maxval 15": (5, 15),
                    "P5 maxval 1000": (5, 1000), "P5 maxval 65535": (5, 65535),
                    "P6 maxval 100": (6, 100), "P6 maxval 4095": (6, 4095)}[name]
    shape = (h, w, 3) if kind in (3, 6) else (h, w)
    return iw.pnm(rng.integers(0, maxval + 1, shape), kind, maxval)


PNM_KINDS = ["P1", "P4", "P2", "P3", "P2 maxval 1000", "P5 maxval 15", "P5 maxval 1000",
             "P5 maxval 65535", "P6 maxval 100", "P6 maxval 4095"]


@pytest.mark.parametrize("name", PNM_KINDS)
def test_pnm_variants_match_pil(name):
    """The PNMs PIL decodes beyond P5/P6 at maxval 255: plain P1/P2/P3 with
    comments, bitmap P4, and other maxvals, where grey above 255 is PIL's
    mode "I" (round(v / maxval * 65535), which convert("L") clips) and the
    rest round(v / maxval * 255)."""
    pil_equal(_pnm_case(name))


def test_pnm_maxval_1000_clips():
    """The probe: P5 of maxval 1000 opens as mode "I" and 255 reads 255."""
    data = b"P5 2 1 1000\n" + np.array([1, 255], ">u2").tobytes()
    assert Image.open(io.BytesIO(data)).mode == "I"
    np.testing.assert_array_equal(images.decode_gray(data), [[66, 255]])
    pil_equal(data)


def _segment_edit(marker: int, edit) -> bytes:
    """``_jpeg()`` with the body of its first ``marker`` segment edited, its
    length field set to match."""
    data = _jpeg()
    m, start, end = next(x for x in iw.jpeg_segments(data) if x[0] == marker)
    body = edit(data[start + 4:end])
    return data[:start + 2] + struct.pack(">H", len(body) + 2) + body + data[end:]


def _png_crc_flipped(kind: bytes) -> bytes:
    """A grey PNG with a tEXt chunk before its IDAT, one bit of ``kind``'s
    CRC flipped."""
    data = iw.png(np.arange(60, dtype=np.uint8).reshape(6, 10))
    i = data.index(b"IDAT") - 4
    data = data[:i] + iw.png_chunk(b"tEXt", b"key\x00value") + data[i:]
    i = data.index(kind)
    end = i + 4 + struct.unpack(">I", data[i - 4:i])[0]
    return data[:end] + bytes([data[end] ^ 1]) + data[end + 1:]


PIL_REFUSES = {
    "SOF5 in a progressive file": lambda: iw.retag_frame(_progressive((40, 60), "4:2:0", 1),
                                                         marker=0xC5),
    "SOF13 hierarchical arithmetic": lambda: iw.retag_frame(_jpeg(), marker=0xCD),
    "12-bit progressive": lambda: iw.retag_frame(_progressive((40, 60), "4:2:0", 1),
                                                 precision=12),
    "baseline scan in a progressive frame": lambda: iw.retag_frame(_jpeg(), marker=0xC2),
    "fractional sampling": lambda: _jpeg()[:_jpeg().index(b"\xff\xc0") + 14] + b"\x31"
    + _jpeg()[_jpeg().index(b"\xff\xc0") + 15:],
    "truncated progressive": lambda: _progressive((40, 60), "4:2:0", 1)[:900],
    "progressive without EOI": lambda: _progressive((40, 60), "4:2:0", 1)[:-2],
    "truncated CMYK": lambda: _cmyk("4:2:0", 2)[:700],
    "truncated interlaced PNG": lambda: iw.png(np.zeros((20, 33, 3), np.uint8), interlace=True)[:60],
    "BMP header of 20 bytes": lambda: b"BM" + bytes(12) + struct.pack("<I", 20) + bytes(40),
    "BMP of 2 bits": lambda: iw.bmp(4, 2, 2, [b"\x1b", b"\xe4"], [(1, 2, 3)] * 4),
    "BMP compression 4": lambda: iw.bmp(4, 2, 24, [bytes(12)] * 2, compression=4),
    "BMP bitfields PIL does not know": lambda: iw.bmp(4, 2, 32, [bytes(16)] * 2, compression=3,
                                                      masks=(0xF00, 0xF0, 0xF, 0), header=56),
    "BMP 4-bit grey ramp": lambda: iw.bmp(6, 2, 4, [b"\x01\x23\x45"] * 2,
                                          [(i, i, i) for i in range(16)]),
    "frame header longer than its components": lambda: _segment_edit(0xC0, lambda b: b + b"\0"),
    "DC table symbol above 15": lambda: _segment_edit(0xC4, lambda b: b[:17 + 5] + b"\x10"
                                                      + b[17 + 6:]),
    "MCU of more than 10 blocks": lambda: _segment_edit(0xC0, lambda b: b[:7] + b"\x44" + b[8:]),
    "PNG header checksum": lambda: _png_crc_flipped(b"IHDR"),
    "PNG ancillary chunk checksum": lambda: _png_crc_flipped(b"tEXt"),
    "PAM (P7)": lambda: b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x00\x01",
    "truncated P4": lambda: iw.pnm(np.ones((9, 20)), 4)[:-3],
}


@pytest.mark.parametrize("name", list(PIL_REFUSES))
def test_pil_refusals_raise_oserror(name):
    """Files PIL refuses with an OSError (including UnidentifiedImageError:
    its own header checks) raise an OSError from the C++ too, so the LMDB
    reader's dummy substitution matches JAX's."""
    data = PIL_REFUSES[name]()
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).convert("L")
    with pytest.raises(OSError) as err:
        images.decode_gray(data)
    assert not isinstance(err.value, NotImplementedError)


PIL_VALUE_ERRORS = {
    "RLE8 ending early": lambda: iw.bmp(5, 3, 8, palette=[(1, 2, 3)] * 256, compression=1,
                                        data=b"\x05\x01\x00\x01"),
    "P5 of maxval 1000 cut short": lambda: b"P5 3 1 1000\n" + bytes(4),
    "P2 sample above maxval": lambda: b"P2 3 1 15 1 2 30",
    "P1 token not 0 or 1": lambda: b"P1 3 1 0 2 1",
    "PNM maxval 0": lambda: b"P5 3 1 0\n" + bytes(3),
}


@pytest.mark.parametrize("name", list(PIL_VALUE_ERRORS))
def test_pil_value_errors_raise_value_error(name):
    """Where PIL's own Python decoders raise ValueError (which the JAX
    loaders do not catch), the C++ raises ValueError too."""
    data = PIL_VALUE_ERRORS[name]()
    with pytest.raises(ValueError):
        Image.open(io.BytesIO(data)).convert("L")
    with pytest.raises(ValueError):
        images.decode_gray(data)


@pytest.mark.parametrize("name", ["scan parameters", "DAC marker", "truncated after the scan",
                                  "cut mid-scan, EOI kept", "wrong restart marker",
                                  "no Huffman tables", "no Huffman tables, grey"])
def test_baseline_oddities_match_pil(name):
    """Baseline files libjpeg reads with a warning: scan parameters other
    than 0, 63, 0, 0; an arithmetic-conditioning (DAC) marker; tables cut
    after the one scan (PIL has its lines); a scan cut before an EOI (the
    MCUs after the cut left grey); a restart marker out of sequence
    (resynchronised); no DHT at all (motion-JPEG frames: libjpeg installs
    the standard tables, which PIL wrote)."""
    base = encoded(Image.fromarray(smooth(40, 61, 3, 11)), format="JPEG", quality=75,
                   restart_marker_blocks=2)
    sos = base.index(b"\xff\xda")
    if name.startswith("no Huffman tables"):
        if name.endswith("grey"):
            base = encoded(Image.fromarray(smooth(40, 61, 1, 11)), format="JPEG", quality=75)
        data = base
        for m, a, b in reversed(iw.jpeg_segments(base)):
            if m == 0xC4:
                data = data[:a] + data[b:]
        assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    elif name == "scan parameters":
        d = bytearray(base)
        d[sos + 5 + 2 * base[sos + 4]:sos + 8 + 2 * base[sos + 4]] = b"\x05\x02\x11"
        data = bytes(d)
    elif name == "DAC marker":
        data = base[:sos] + b"\xff\xcc\x00\x04\x00\x10" + base[sos:]
    elif name == "truncated after the scan":
        dht = base[base.index(b"\xff\xc4"):]
        data = base[:-2] + dht[:12]
    elif name == "cut mid-scan, EOI kept":
        data = base[:len(base) * 2 // 3] + b"\xff\xd9"
    else:
        i = base.index(b"\xff\xd3")
        data = base[:i + 1] + b"\xd5" + base[i + 2:]
    want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    np.testing.assert_array_equal(images.decode_gray(data), want)


@pytest.mark.parametrize("name", ["IDAT checksum", "IEND checksum", "IDAT split, one empty",
                                  "IDAT after another chunk"])
def test_png_oddities_match_pil(name):
    """PNG data PIL reads without a complaint: the CRCs of IDAT and IEND
    are not checked, the image data may span chunks (an empty one too),
    and it ends at the first chunk that is not IDAT (a later IDAT is not
    read: here the rows it held read as truncated)."""
    img = np.arange(60, dtype=np.uint8).reshape(6, 10)
    data = iw.png(img)
    i = data.index(b"IDAT")
    n = struct.unpack(">I", data[i - 4:i])[0]
    if name == "IDAT checksum":
        data = data[:i + 4 + n] + bytes([data[i + 4 + n] ^ 1]) + data[i + 5 + n:]
    elif name == "IEND checksum":
        data = data[:-1] + bytes([data[-1] ^ 1])
    else:
        stream = data[i + 4:i + 4 + n]
        head, tail = stream[:n // 2], stream[n // 2:]
        mid = iw.png_chunk(b"IDAT", b"") if name == "IDAT split, one empty" else (
            iw.png_chunk(b"tEXt", b"k\x00v"))
        data = (data[:i - 4] + iw.png_chunk(b"IDAT", head) + mid + iw.png_chunk(b"IDAT", tail)
                + iw.png_chunk(b"IEND", b""))
        if name == "IDAT after another chunk":
            with pytest.raises(OSError):
                Image.open(io.BytesIO(data)).convert("L")
            with pytest.raises(OSError):
                images.decode_gray(data)
            return
    held(data)


@pytest.mark.parametrize("kind", ["JPEG", "PNG", "BMP", "PNM"])
def test_decompression_bombs_raise_as_pil(kind):
    """A header claiming more than twice PIL's MAX_IMAGE_PIXELS: PIL's
    DecompressionBombError (not an OSError) before any pixel is decoded,
    and the decoder's own, without allocating the image."""
    side = 20000  # 4e8 pixels against a limit of 2 * 89478485
    if kind == "JPEG":
        data = iw.retag_frame(_jpeg())
        i = data.index(b"\xff\xc0")
        data = data[:i + 5] + struct.pack(">HH", side, side) + data[i + 9:]
    elif kind == "PNG":
        data = iw.png(np.zeros((1, 1), np.uint8))
        ihdr = struct.pack(">IIBBBBB", side, side, 8, 0, 0, 0, 0)
        data = data[:8] + iw.png_chunk(b"IHDR", ihdr) + data[33:]
    elif kind == "BMP":
        data = iw.bmp(side, side, 24, data=bytes(64))
    else:
        data = f"P5 {side} {side} 255\n".encode() + bytes(64)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data)).convert("L")
    with pytest.raises(images.DecompressionBombError) as err:
        images.decode_gray(data)
    assert not isinstance(err.value, OSError)


# --- WebP, held to PIL alone ----------------------------------------------------


def webp(img: np.ndarray, **kw) -> bytes:
    return encoded(Image.fromarray(img), format="WEBP", **kw)


def webp_held(data: bytes):
    """``decode_gray`` equals PIL's ``convert("L")`` and the decoder's RGB
    output its ``convert("RGB")``, bit for bit, or both raise OSError."""
    try:
        im = Image.open(io.BytesIO(data))
        want_l, want_rgb = np.asarray(im.convert("L")), np.asarray(im.convert("RGB"))
    except OSError:
        with pytest.raises(OSError) as err:
            images.decode_gray(data)
        assert not isinstance(err.value, NotImplementedError)
        return False
    got = images.decode_gray(data)
    assert got.dtype == np.uint8 and got.shape == want_l.shape
    np.testing.assert_array_equal(got, want_l)
    np.testing.assert_array_equal(images._decode_webp(data, 3), want_rgb)
    return True


def _webp_case(seed: int):
    """A small random image and PIL save options: lossless or lossy, method,
    quality, exact, alpha; odd sizes and widths not a multiple of 16."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 60)), int(rng.integers(1, 90))
    kind = seed % 4
    if kind == 0:
        img = smooth(h + 8, w + 8, 3, seed)[:h, :w]
    elif kind == 1:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    elif kind == 2:  # few colours: colour indexing
        pal = rng.integers(0, 256, (int(rng.integers(1, 20)), 3))
        img = pal[rng.integers(0, len(pal), (h, w))].astype(np.uint8)
    else:
        img = np.repeat(smooth(h + 8, w + 8, 3, seed)[:h, :1], w, 1)
    if rng.random() < 0.4:
        alpha = rng.choice([0, 128, 255], (h, w)) if rng.random() < 0.5 else \
            rng.integers(0, 256, (h, w))
        img = np.dstack([img, alpha]).astype(np.uint8)
    if seed % 2:
        kw = dict(lossless=True, method=int(rng.integers(0, 7)),
                  quality=int(rng.integers(0, 101)), exact=bool(rng.random() < 0.5))
    else:
        kw = dict(quality=int(rng.integers(0, 101)), method=int(rng.integers(0, 7)),
                  alpha_quality=int(rng.integers(0, 101)))
    return img, kw


@pytest.mark.parametrize("seed", range(48))
def test_webp_sweep_matches_pil(seed):
    """Small random images written by PIL across lossless and lossy,
    ``method``, ``quality``, ``exact`` and alpha, at odd heights and widths
    that are not multiples of 16: L and RGB as PIL's."""
    img, kw = _webp_case(seed)
    assert webp_held(webp(img, **kw))


@pytest.mark.parametrize("shape", [(1, 1), (16, 16), (17, 33), (32, 100), (48, 129)])
@pytest.mark.parametrize("quality", [5, 40, 75, 100])
def test_webp_lossy_sizes_match_pil(shape, quality):
    """Lossy RGB at sizes around the 16-pixel macroblock and 2x2 chroma:
    the fancy upsampler's last odd row and column, the right-most
    macroblock's 4x4 predictors."""
    assert webp_held(webp(smooth(*shape, 3, quality), quality=quality))


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("quality", [10, 60, 95])
def test_webp_fast_methods_match_pil(method, quality):
    """Flat areas around some detail at methods 0-2: there libwebp turns the
    macroblocks' skip flag on (at its default method 4 it leaves it off),
    and method 0 keeps segments without a segment map."""
    img = np.full((64, 96, 3), 120, np.uint8)
    img[20:30, 10:50] = smooth(10, 40, 3, method)
    assert webp_held(webp(img, quality=quality, method=method))


@pytest.mark.parametrize("config", [
    dict(filter_type=0, filter_strength=60), dict(filter_type=0, filter_sharpness=4),
    dict(filter_strength=100, filter_sharpness=7), dict(filter_strength=30, filter_sharpness=1),
    dict(filter_strength=0), dict(segments=1, sns_strength=0), dict(segments=4, sns_strength=100),
    dict(segments=2, quality=5.0), dict(method=0, quality=90.0), dict(preprocessing=4),
    dict(use_sharp_yuv=1), dict(alpha_compression=0), dict(alpha_filtering=0),
    dict(alpha_filtering=2, alpha_quality=40)],
    ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_webp_libwebp_options_match_pil(config):
    """Options PIL's save does not pass on, through libwebp's advanced
    encoder API: the simple loop filter, filter sharpness and strength,
    segments, raw and filtered alpha."""
    import loader_fixtures as lf

    img = smooth(37, 70, 3, 7)
    if "alpha_compression" in config or "alpha_filtering" in config:
        img = np.dstack([img, smooth(37, 70, 1, 8)])
    assert webp_held(lf.libwebp_encode(img, **config))


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (32, 100), (17, 33, 3), (20, 9, 4)])
def test_webp_writer_reads_back_in_pil(shape):
    """``image_writers.webp_lossless`` (subtract-green, predictor, Huffman
    literals): PIL and the decoder read back the written pixels."""
    rng = np.random.default_rng(len(shape) + shape[0])
    img = rng.integers(0, 256, shape).astype(np.uint8)
    data = iw.webp_lossless(img)
    want = img if img.ndim == 2 else np.asarray(Image.fromarray(img).convert("L"))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("L")), want)
    assert webp_held(data)


def _webp_damaged():
    """(name, data): lossless, lossy and lossy-with-alpha files cut at
    several offsets and with single bytes flipped."""
    rng = np.random.default_rng(5)
    rgb = smooth(40, 56, 3, 5)
    rgba = np.dstack([rgb, np.where(np.arange(56) % 3, 255, 90) * np.ones((40, 1))]).astype(
        np.uint8)
    files = {"lossless": webp(rgb, lossless=True), "lossy": webp(rgb, quality=70),
             "lossy+alpha": webp(rgba, quality=70, alpha_quality=60)}
    cases = []
    for name, data in files.items():
        for cut in (8, 15, 19, 30, len(data) // 2, len(data) - 1):
            cases.append((f"{name} cut at {cut}", data[:cut]))
        for pos in sorted(rng.choice(np.arange(12, len(data)), 8, replace=False)):
            d = bytearray(data)
            d[pos] ^= int(rng.integers(1, 256))
            cases.append((f"{name} byte {pos} flipped", bytes(d)))
    return cases


WEBP_DAMAGED = dict(_webp_damaged())


@pytest.mark.parametrize("name", list(WEBP_DAMAGED))
def test_webp_damage_matches_pil(name):
    """Truncations and single-byte flips: OSError where PIL raises, PIL's
    pixels where libwebp decodes the damaged data."""
    webp_held(WEBP_DAMAGED[name])


def _container(kind: str) -> bytes:
    """WebP containers built by hand around PIL-written bitstreams."""
    import loader_fixtures as lf

    rgb = smooth(24, 40, 3, 9)
    lossless = dict(lf._riff_chunks(webp(rgb, lossless=True)))[b"VP8L"]
    lossy = lf._riff_chunks(webp(np.dstack([rgb, np.full((24, 40), 77, np.uint8)]), quality=60))
    alph, vp8 = dict(lossy)[b"ALPH"], dict(lossy)[b"VP8 "]
    c = iw.webp_chunk
    still = [iw.vp8x_chunk(40, 24, 0x10), c(b"ALPH", alph), c(b"VP8 ", vp8)]
    anim = [iw.vp8x_chunk(64, 40, 0x02), c(b"ANIM", bytes(6))]
    return {
        "trailing bytes after the RIFF chunk": iw.webp_file([c(b"VP8L", lossless)]) + b"junk!",
        "unknown chunk after the image": iw.webp_file([c(b"VP8L", lossless), c(b"ABCD", b"xyz")]),
        "VP8X with unknown and metadata chunks": iw.webp_file(
            [iw.vp8x_chunk(40, 24, 0x2c), c(b"ICCP", b"icc"), c(b"ABCD", b"1"),
             c(b"VP8L", lossless), c(b"EXIF", b"exif"), c(b"XMP ", b"<x/>")]),
        "ALPH without the alpha flag": iw.webp_file(
            [iw.vp8x_chunk(40, 24, 0), c(b"ALPH", b"\x03broken"), c(b"VP8 ", vp8)]),
        "ALPH and VP8": iw.webp_file(still),
        "raw ALPH": iw.webp_file([iw.vp8x_chunk(40, 24, 0x10), c(b"ALPH", b"\x00" + bytes(
            range(240)) * 4), c(b"VP8 ", vp8)]),
        "raw ALPH too short": iw.webp_file([iw.vp8x_chunk(40, 24, 0x10),
                                            c(b"ALPH", b"\x00" + bytes(959)), c(b"VP8 ", vp8)]),
        "ALPH with a reserved bit": iw.webp_file([iw.vp8x_chunk(40, 24, 0x10),
                                                  c(b"ALPH", bytes([alph[0] | 0x40]) + alph[1:]),
                                                  c(b"VP8 ", vp8)]),
        "ALPH after VP8": iw.webp_file([still[0], still[2], still[1]]),
        "VP8X reserved flag": iw.webp_file([iw.vp8x_chunk(40, 24, 0x11)] + still[1:]),
        "VP8X canvas not the frame's": iw.webp_file([iw.vp8x_chunk(41, 24, 0x10)] + still[1:]),
        "two images": iw.webp_file([iw.vp8x_chunk(40, 24, 0), c(b"VP8L", lossless),
                                    c(b"VP8L", lossless)]),
        "frames at offsets": iw.webp_file(anim + [
            iw.anmf_chunk(10, 4, 40, 24, c(b"VP8L", lossless)),
            iw.anmf_chunk(0, 0, 40, 24, c(b"ALPH", alph) + c(b"VP8 ", vp8))]),
        "first frame lossy with alpha at an odd place": iw.webp_file(anim + [
            iw.anmf_chunk(24, 16, 40, 24, c(b"ALPH", alph) + c(b"VP8 ", vp8))]),
        "frame past the canvas": iw.webp_file(anim + [
            iw.anmf_chunk(26, 0, 40, 24, c(b"VP8L", lossless))]),
        "ANMF without ANIM": iw.webp_file([anim[0], iw.anmf_chunk(0, 0, 40, 24,
                                                                   c(b"VP8L", lossless))]),
        "animation flag, a still image": iw.webp_file([anim[0], c(b"VP8L", lossless)]),
        "frames without the animation flag": iw.webp_file(
            [iw.vp8x_chunk(64, 40, 0), anim[1], iw.anmf_chunk(0, 0, 40, 24, c(b"VP8L", lossless))]),
        "RIFF size odd": iw.webp_file([c(b"VP8L", lossless)])[:4] + struct.pack(
            "<I", 4 + 8 + len(lossless) + (len(lossless) & 1) - 1)
        + iw.webp_file([c(b"VP8L", lossless)])[8:],
        "VP8L with a version": iw.webp_file([c(b"VP8L", lossless[:4] + bytes(
            [lossless[4] | 0x20]) + lossless[5:])]),
        "VP8 not a key frame": iw.webp_file([c(b"VP8 ", bytes([vp8[0] | 1]) + vp8[1:])]),
        "VP8 chunk size past the RIFF": iw.webp_file([c(b"VP8 ", vp8)])[:16] + struct.pack(
            "<I", len(vp8) + 9) + vp8,
    }[kind]


WEBP_CONTAINERS = ["trailing bytes after the RIFF chunk", "unknown chunk after the image",
                   "VP8X with unknown and metadata chunks", "ALPH without the alpha flag",
                   "ALPH and VP8", "raw ALPH", "raw ALPH too short", "ALPH with a reserved bit",
                   "ALPH after VP8", "VP8X reserved flag", "VP8X canvas not the frame's",
                   "two images", "frames at offsets",
                   "first frame lossy with alpha at an odd place", "frame past the canvas",
                   "ANMF without ANIM", "animation flag, a still image",
                   "frames without the animation flag", "RIFF size odd", "VP8L with a version",
                   "VP8 not a key frame", "VP8 chunk size past the RIFF"]


@pytest.mark.parametrize("kind", WEBP_CONTAINERS)
def test_webp_containers_match_pil(kind):
    """The simple, extended and animated containers as libwebp's demuxer
    reads them for PIL: chunks skipped, alpha ignored without its flag,
    frame 0 on a transparent black canvas at its offset; and the layouts it
    refuses (OSError)."""
    webp_held(_container(kind))


def vp8_tables():
    """RFC 6386's coefficient update and default probabilities and the
    key-frame 4x4 mode probabilities, as ``native/webpdecode.cpp`` types
    them (the writer's and the decoder's tables; PIL, reading the frames,
    holds both to libwebp's)."""
    import re

    text = images.WEBP_SOURCE.read_text()

    def table(name):
        body = re.search(name + r"[^=]*= \{(.*?)\};", text, re.S).group(1)
        return [int(v) for v in re.findall(r"\d+", body)]

    upd, p0, bm = (np.asarray(table(n)) for n in ("kCoeffsUpdateProba", "kCoeffsProba0",
                                                    "kBModesProba"))
    return (upd.reshape(4, 8, 3, 11).tolist(), p0.reshape(4, 8, 3, 11).tolist(),
            bm.reshape(10, 10, 9).tolist())


@pytest.mark.parametrize("seed", range(40))
def test_webp_vp8_syntax_matches_pil(seed):
    """Hand-written VP8 key frames of random syntax (``image_writers.
    vp8_random_frame``): what libwebp's encoder never writes (2, 4 and 8
    token partitions, segment quantizers out of range, relative segment
    deltas, mode and reference filter deltas, blocks ending in a run of
    zeros, levels up to DCT_CAT6's that wrap int16 when dequantized, every
    mode in any place) and what it rarely does, at sizes that are not
    multiples of 16; decoded as PIL decodes them."""
    rng = np.random.default_rng(1000 + seed)
    w, h = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    opts = {"partitions": seed % 4} if seed < 8 else {}
    frame = iw.vp8_random_frame(w, h, seed, vp8_tables(), **opts)
    assert webp_held(iw.webp_file([iw.webp_chunk(b"VP8 ", frame)]))


def test_webp_unknown_fourcc_cannot_be_identified():
    """A RIFF/WEBP file whose first chunk is not VP8, VP8L or VP8X: PIL's
    WebP plugin does not take it ("cannot identify image file")."""
    data = webp(smooth(8, 8, 3, 1), lossless=True)
    data = data[:12] + b"VP8Y" + data[16:]
    with pytest.raises(OSError, match="cannot identify"):
        Image.open(io.BytesIO(data))
    with pytest.raises(OSError, match="cannot identify"):
        images.decode_gray(data)
    with pytest.raises(OSError, match="cannot identify"):
        identify.identify(data, images._check_size)


def test_webp_canvas_bomb_raises_as_pil():
    """An animation's canvas of more than twice MAX_IMAGE_PIXELS (a small
    first frame): PIL's DecompressionBombError, and the decoder's own."""
    side = 13400  # 1.8e8 pixels
    lossless = dict(__import__("loader_fixtures")._riff_chunks(
        webp(smooth(8, 8, 3, 1), lossless=True)))[b"VP8L"]
    data = iw.webp_file([iw.vp8x_chunk(side, side, 0x02), iw.webp_chunk(b"ANIM", bytes(6)),
                         iw.anmf_chunk(0, 0, 8, 8, iw.webp_chunk(b"VP8L", lossless))])
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data)).convert("L")
    with pytest.raises(images.DecompressionBombError) as err:
        images.decode_gray(data)
    assert not isinstance(err.value, OSError)


def test_webp_decoder_raises_when_it_cannot_be_built(monkeypatch, tmp_path):
    """The WebP decoder's own library: a source that does not compile
    raises RuntimeError, no quiet fallback."""
    bad = tmp_path / "webpdecode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(images, "_webp_lib", None)
    monkeypatch.setattr(images, "WEBP_SOURCE", bad)
    monkeypatch.setattr(images, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed"):
        images.decode_gray(webp(smooth(8, 8, 3, 1)))
    assert not list((tmp_path / "_build").glob("*.so"))


def _jpeg_flips():
    """(name, data): baseline 4:2:0, 4:4:4 and grey JPEGs and a progressive
    one, each with single bits flipped in its entropy-coded data (after its
    first scan header, before its EOI)."""
    rng = np.random.default_rng(11)
    rgb = smooth(48, 64, 3, 21)
    files = {"4:2:0": dict(quality=90), "4:4:4": dict(quality=95, subsampling=0),
             "grey": dict(quality=80), "progressive": dict(quality=85, progressive=True)}
    cases = []
    for name, kw in files.items():
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("L" if name == "grey" else "RGB").save(buf, "JPEG", **kw)
        data = buf.getvalue()
        start = data.index(b"\xff\xda") + 14
        for pos in sorted(rng.choice(np.arange(start, len(data) - 2), 8, replace=False)):
            bit = int(rng.integers(0, 8))
            cases.append((f"{name} byte {pos} bit {bit}",
                          data[:pos] + bytes([data[pos] ^ (1 << bit)]) + data[pos + 1:]))
    return cases


JPEG_FLIPS = dict(_jpeg_flips())


@pytest.mark.parametrize("name", list(JPEG_FLIPS))
def test_jpeg_entropy_flips_match_pil(name):
    """Corrupt entropy-coded data: PIL's class, and PIL's pixels where it
    decodes, from the C++ and (baseline files) its numpy mirror.  Such data
    makes coefficients whose dequantized values overflow 16 bits; PIL's
    libjpeg-turbo runs its SIMD IDCT, whose 16-bit lanes wrap and saturate
    where jidctint.c's C does not."""
    data = JPEG_FLIPS[name]
    try:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    except OSError:
        with pytest.raises(OSError):
            images.decode_gray(data)
        return
    np.testing.assert_array_equal(images.decode_gray(data), want)
    if not name.startswith("progressive"):
        np.testing.assert_array_equal(plain.decode_gray_plain(data), want)
