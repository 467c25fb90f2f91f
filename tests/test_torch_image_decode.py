"""The port's image decoding, resizing and cropping (``data/images``, the C++
of ``native/imgdecode.cpp``) against PIL, which the JAX loaders call, and
its numpy mirror (``data/images_plain``) against the C++: bit for bit on
every case.  Images are made here by PIL from seeded arrays."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from multimodal_scene_text_recognition_tpu_torch.data import images
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


def png(w, h, depth, color_type, rows, palette=b"", interlace=0):
    """A PNG written by hand from filter-tagged rows (PIL writes no grey
    image of 2 or 4 bits)."""
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I",
                                                                         zlib.crc32(kind + body))
    raw = b"".join(bytes([f]) + r for f, r in rows)
    return (images.PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
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
    "progressive JPEG": lambda: encoded(Image.fromarray(smooth(40, 60, 3, 2)), format="JPEG",
                                        progressive=True),
    "CMYK/YCCK JPEG": lambda: encoded(Image.fromarray(smooth(40, 60, 3, 2)).convert("CMYK"),
                                      format="JPEG"),
    "arithmetic-coded JPEG": lambda: _jpeg().replace(b"\xff\xc0", b"\xff\xc9", 1),
    "12-bit": lambda: _jpeg().replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1),
    "16-bit PNG": lambda: encoded(Image.fromarray(
        np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000), format="PNG"),
    "interlaced PNG": lambda: png(4, 3, 8, 0, [(0, b"\0" * 4)] * 3, interlace=1),
    "WEBP": lambda: encoded(Image.fromarray(smooth(20, 30, 3, 2)), format="WEBP"),
    "GIF": lambda: encoded(Image.fromarray(smooth(20, 30, 1, 2)), format="GIF"),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_formats_not_covered_raise_not_implemented(name):
    """A valid file of a kind the decoder does not cover raises
    NotImplementedError naming it (not OSError: no loader takes it for a
    broken record)."""
    data = UNSUPPORTED[name]()
    for decode in (images.decode_gray, plain.decode_gray_plain):
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
