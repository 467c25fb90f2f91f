"""GIF and TIFF in the port's image decoder, and the identification of every
format PIL 12.1 opens, held to PIL (the reference) and to the JAX
package's loaders:

* every GIF and TIFF fixture (``loader_fixtures.gif_tiff_files``: made by
  ``image_writers.gif_tiff_fixtures`` and stored in ``formats/``) decodes
  to PIL's ``convert("L")`` bit for bit, or raises the class PIL raises,
  and the sha256 ``expected.npz`` keeps of PIL's decode;
* every format PIL saves here, on a small image, either equals PIL or
  raises NotImplementedError naming it, never OSError where PIL decodes;
* truncations and byte flips of the GIF and TIFF fixtures (hypothesis):
  the port's outcome class is PIL's, and where both decode, the arrays;
  NotImplementedError only where PIL decodes, or where the compression
  the port names is really in the flipped file (PIL's libtiff then fails
  on data the port does not decode: CCITT, old-style JPEG);
* JPEG-compressed strips as libtiff has libjpeg read them, and LZMA
  strips kept where libtiff keeps them;
* the JAX ``LmdbReader`` on ``tests/fake_lmdb.py`` and the JAX
  ``RawImageFolder`` on misnamed files, against the port's, over GIF and
  TIFF records: the same samples, the dummies where JAX's fall; a record
  of a kind refused by name raises, and is no dummy.
"""

import io
import json
import struct
import sys
import warnings

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import fake_lmdb
import image_writers as iw
import loader_fixtures as lf
from multimodal_scene_text_recognition_tpu.data import lmdb_data as jlmdb
from multimodal_scene_text_recognition_tpu.data import raw as jraw
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.data import (gif, identify, images,
                                                              lmdb_data, raw, tiff)
from test_torch_loaders import same_samples, write_lmdb

import torch_threads

torch_threads.limit()

FILES = lf.gif_tiff_files()
REFUSED_BY_NAME = {"tiff_ccitt_g4.tif": "TIFF of Compression 4"}  # PIL decodes, the port names it


def outcome(decode, data):
    """("ok", array) or (the class of the error, its message)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return "ok", decode(data)
        except NotImplementedError as e:
            return "NotImplementedError", str(e)
        except Exception as e:  # noqa: BLE001 - the class is compared
            return ("OSError" if isinstance(e, OSError) else type(e).__name__), str(e)


def pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("L"))


def same_outcome(data):
    want, got = outcome(pil_decode, data), outcome(images.decode_gray, data)
    assert got[0] == want[0], (want, got)
    if want[0] == "ok":
        assert got[1].dtype == np.uint8 and got[1].shape == want[1].shape
        np.testing.assert_array_equal(got[1], want[1])


# --- the fixtures -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FILES))
def test_gif_tiff_fixtures_decode_as_pil(name):
    """Each fixture: PIL's array bit for bit (or its error class), and the
    sha256 of PIL's decode that ``expected.npz`` keeps; the CCITT TIFF is
    refused by name."""
    data = FILES[name]
    exp = np.load(lf.OUT / "expected.npz")
    i = list(exp["format_gif_tiff/name"]).index(name)
    if name in REFUSED_BY_NAME:
        assert exp["format_gif_tiff/outcome"][i] == "ok"
        with pytest.raises(NotImplementedError, match=REFUSED_BY_NAME[name]):
            images.decode_gray(data)
        return
    same_outcome(data)
    got = outcome(images.decode_gray, data)
    assert got[0] == exp["format_gif_tiff/outcome"][i]
    if got[0] == "ok":
        np.testing.assert_array_equal(lf.gray_sha256(got[1]), exp["format_gif_tiff/sha256"][i])


def test_fixtures_made_from_the_ports_decode_are_the_same():
    """The card's host makes the hand-written fixtures from the crop as the
    port decodes it: the bytes are those made from PIL's decode."""
    ported = lf.gif_tiff_files(decode=images.read_gray)
    assert ported.keys() == FILES.keys()
    for name in FILES:
        assert ported[name] == FILES[name], name


def test_jpeg_tiff_sampling_is_held_to_its_tag():
    """A JPEG-compressed YCbCr TIFF whose YCbCrSubSampling tag disagrees with
    its JPEG (4:4:4 strips tagged 2x2): libtiff refuses it, so does the
    port, with PIL's OSError."""
    data = FILES["tiff_jpeg_444_strips.tif"]
    pos = data.index(struct.pack("<HHL", 530, 3, 2))
    bad = data[:pos + 8] + struct.pack("<HH", 2, 2) + data[pos + 12:]
    with pytest.raises(OSError):
        pil_decode(bad)
    with pytest.raises(OSError) as err:
        images.decode_gray(bad)
    assert not isinstance(err.value, NotImplementedError)


# --- identification -----------------------------------------------------------------


def _saved():
    Image.init()
    rng = np.random.default_rng(0)
    for fmt in sorted(Image.SAVE):
        for mode in ("L", "RGB", "1", "P", "RGBA"):
            img = Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)).convert(mode)
            buf = io.BytesIO()
            try:
                img.save(buf, format=fmt)
            except (OSError, ValueError, KeyError):
                continue
            yield f"{fmt}-{mode}", buf.getvalue()


SAVED = dict(_saved())


@pytest.mark.parametrize("name", sorted(SAVED))
def test_every_format_pil_saves_is_decoded_or_named(name):
    """A small image in every format PIL saves here: the port equals PIL,
    or raises NotImplementedError naming the format; never an OSError
    where PIL decodes (which a loader would take for a broken record)."""
    data = SAVED[name]
    want, got = outcome(pil_decode, data), outcome(images.decode_gray, data)
    if want[0] == "ok" and got[0] == "NotImplementedError":
        fmt = Image.open(io.BytesIO(data)).format
        assert f"{fmt} files are not decoded" in got[1]
        assert fmt in identify.NAMED
        return
    assert got[0] == want[0], (want, got)
    if want[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])


NAMED_FILES = {
    "PPM (Pf)": b"Pf\n4 2\n-1.0\n" + bytes(32),
    "PPM (P0CMYK)": b"P0CMYK 2 2 255\n" + bytes(16),
    "PPM (PyP)": b"PyP 2 2 255\n" + bytes(4),
    "TGA": b"\0\0\3" + bytes(9) + struct.pack("<HH", 4, 2) + b"\x08\x20" + bytes(8),
    "SPIDER": struct.pack(">27f", *([1.0, 2.0, 0, 0, 1.0] + [0] * 6 + [4.0, 1.0]
                                    + [0] * 8 + [16.0, 16.0] + [0] * 4)) + bytes(400),
}


@pytest.mark.parametrize("name", sorted(NAMED_FILES))
def test_kinds_without_magic_and_pnm_extensions_are_named(name):
    """PIL's PNM extensions, and formats without a magic number (TGA,
    SPIDER) that PIL's header checks take: NotImplementedError naming
    them, where PIL opens the file."""
    data = NAMED_FILES[name]
    assert Image.open(io.BytesIO(data)).format == name.split(" ")[0]
    with pytest.raises(NotImplementedError, match=name.replace("(", r"\(").replace(")", r"\)")):
        images.decode_gray(data)


UNLOADABLE = {
    "EPS": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 4 4\n%%EndComments\n",
    "BUFR": b"BUFR" + bytes(40),
    "GRIB": b"GRIB\0\0\0\x01" + bytes(40),
    "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(40),
}


@pytest.mark.parametrize("name", sorted(UNLOADABLE))
def test_kinds_pil_cannot_load_here_raise_oserror(name):
    """EPS without Ghostscript and the stub formats: PIL opens them and its
    convert raises OSError; so does the port (a loader's dummy, as JAX's)."""
    data = UNLOADABLE[name]
    with pytest.raises(OSError):
        pil_decode(data)
    with pytest.raises(OSError) as err:
        images.decode_gray(data)
    assert not isinstance(err.value, NotImplementedError)


def test_broken_files_are_not_taken_for_tga():
    """Files no plugin takes stay "cannot identify" (OSError), not TGA: the
    truncated and corrupt fixtures, and bytes whose TGA header fails."""
    for data in (b"notanimage", b"", b"\0\0\2" + bytes(20),
                 (lf.OUT / "formats" / "webp_corrupt.webp").read_bytes(),
                 (lf.OUT / "crops" / "truncated.jpg").read_bytes()):
        with pytest.raises(OSError):
            pil_decode(data)
        with pytest.raises(OSError) as err:
            images.decode_gray(data)
        assert not isinstance(err.value, NotImplementedError)


# --- truncations and byte flips -------------------------------------------------------

FUZZED = ["gif87a_global_256.gif", "gif_local_16_interlaced.gif", "gif_small_frame_transparent.gif",
          "gif_extensions_two_frames.gif", "gif_code_size_3_clears.gif", "tiff_raw_strips.tif",
          "tiff_raw_rgb_planar.tif", "tiff_raw_mm_tiles.tif", "tiff_lzw.tif",
          "tiff_lzw_rgb_predictor.tif", "tiff_deflate_tiles.tif", "tiff_packbits_rgb_planar.tif",
          "tiff_lzw_palette_4bit.tif", "tiff_deflate_16bit_mm_predictor.tif",
          "tiff_jpeg_libtiff.tif", "tiff_jpeg_444_strips.tif", "tiff_lzma.tif",
          "tiff_ccitt_g4.tif"]


def named_in_file(data: bytes, msg: str) -> bool:
    """Whether the compression a NotImplementedError names is the one PIL
    reads from the file."""
    import re

    m = re.search(r"TIFF of Compression (\d+)", msg)
    if m is None:
        return False
    return Image.open(io.BytesIO(data)).tag_v2.get(259) == int(m.group(1))


@settings(max_examples=400, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.sampled_from(FUZZED), st.integers(0, 2 ** 31), st.integers(0, 7),
       st.booleans())
def test_truncations_and_flips_match_pil(name, where, bit, flip):
    """A fixture cut at any length, or with one bit flipped anywhere (its
    TIFF directory too, which PIL reads twice: in Python, and in libtiff
    for compressed data): the port raises the class PIL raises, or both
    decode to the same array.  The port may name what it does not decode
    (NotImplementedError) where PIL decodes the file, and where PIL fails
    on the data of a compression the port names (a flip into the CCITT
    data, or into a CCITT or old-style JPEG compression): never where PIL
    raises for a reason the port reads."""
    data = FILES[name]
    if flip:
        i = where % len(data)
        data = data[:i] + bytes([data[i] ^ (1 << bit)]) + data[i + 1:]
    else:
        data = data[:where % len(data)]
    want, got = outcome(pil_decode, data), outcome(images.decode_gray, data)
    if got[0] == "NotImplementedError":
        assert "is not decoded" in got[1]
        assert want[0] == "ok" or named_in_file(data, got[1]), (want[:1], got)
        return
    assert got[0] == want[0], (want, got)
    if want[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])


def _flip(data: bytes, pos: int, bit: int) -> bytes:
    return data[:pos] + bytes([data[pos] ^ (1 << bit)]) + data[pos + 1:]


# (byte, bit) flips of tiff_lzma.tif's first strip that Python's lzma fails:
# PIL's libtiff keeps the first three (its liblzma fills the strip first,
# the first one a flip of the LZMA2 chunk's compressed size) and fails the
# last two
LZMA_FLIPS = {"chunk size, kept": (35, 3), "data, kept": (1008, 0), "late data, kept": (1092, 6),
              "block header, fails": (28, 0), "early data, fails": (42, 0)}


@pytest.mark.parametrize("case", sorted(LZMA_FLIPS))
def test_lzma_strip_kept_where_libtiff_keeps_it(case):
    """A corrupt LZMA strip: PIL's array where libtiff keeps the strip, its
    OSError where libtiff fails it (a loader's dummy, as JAX's)."""
    data = _flip(FILES["tiff_lzma.tif"], *LZMA_FLIPS[case])
    want, got = outcome(pil_decode, data), outcome(images.decode_gray, data)
    assert want[0] == ("ok" if "kept" in case else "OSError")
    assert got[0] == want[0], (want, got)
    if want[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])


def _retag(data: bytes, tag: int, value: bytes, field: int = 8) -> bytes:
    """A little-endian TIFF with bytes ``field`` on of directory entry
    ``tag`` replaced (2: its type, 4: its count, 8: its value)."""
    first = struct.unpack_from("<L", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, first)[0]):
        o = first + 2 + 12 * k
        if struct.unpack_from("<H", data, o)[0] == tag:
            return data[:o + field] + value + data[o + field + len(value):]
    raise KeyError(tag)


def _jpeg_tiff_cases():
    """(name, data, PIL's outcome class) of JPEG-compressed TIFFs that
    libtiff reads otherwise than PIL's JPEG plugin would read the strip."""
    rgb, ycc = FILES["tiff_jpeg_libtiff.tif"], FILES["tiff_jpeg_444_strips.tif"]
    end = 8 + 1069  # tiff_jpeg_libtiff.tif's one strip: its EOI's marker byte at end - 1
    sos = ycc.index(b"\xff\xda", 584)  # the third strip's scan header
    return [
        # an unknown marker after the scan: jpeg_finish_decompress fails, libtiff ignores it
        ("marker after the scan", rgb[:end - 1] + b"\x04" + rgb[end:], "ok"),
        # the strip's colour space is libtiff's: YCbCr for PhotometricInterpretation 6
        ("RGB JPEG tagged YCbCr", _retag(rgb, 262, b"\x06\x00"), "ok"),
        # JPEGTables cut inside a table: libtiff's source reads FF D9 past their end
        ("JPEGTables cut short", _retag(rgb, 347, struct.pack("<L", 33), 4), "ok"),
        # JPEGTables as SBYTE: libtiff drops them (bytes over 127), no table is defined
        ("JPEGTables as SBYTE", _retag(rgb, 347, b"\x06\x00", 2), "OSError"),
        # libjpeg wants SOI first
        ("strip without SOI", rgb[:8] + b"\x00" + rgb[9:], "OSError"),
        # a scan that names one component twice: libjpeg refuses it
        ("scan names a component twice", ycc[:sos + 7] + b"\x03" + ycc[sos + 8:], "OSError"),
    ]


JPEG_TIFF = {name: (data, want) for name, data, want in _jpeg_tiff_cases()}


@pytest.mark.parametrize("name", sorted(JPEG_TIFF))
def test_jpeg_tiff_strips_read_as_libtiff(name):
    """JPEG strips as libtiff has libjpeg read them, not as PIL's JPEG
    plugin reads a file: PIL's outcome class and array."""
    data, want_class = JPEG_TIFF[name]
    want, got = outcome(pil_decode, data), outcome(images.decode_gray, data)
    assert want[0] == want_class
    assert got[0] == want[0], (want, got)
    if want[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])


def short_jpeg_strips() -> bytes:
    """tiff_jpeg_444_strips.tif with RowsPerStrip 10 for its JPEG strips of
    8 rows: libtiff decodes them, leaving two rows of each strip as its
    buffer held; PIL decodes the file, the port names it."""
    return _retag(FILES["tiff_jpeg_444_strips.tif"], 278, struct.pack("<L", 10))


def test_short_jpeg_strips_are_named():
    data = short_jpeg_strips()
    pil_decode(data)
    with pytest.raises(NotImplementedError, match="strip of 105x8 for one of 105x10"):
        images.decode_gray(data)


# --- the loaders ----------------------------------------------------------------------


def gif_tiff_records():
    """LMDB records of GIF and TIFF crops: PIL decodes all but the broken
    ones; the CCITT one is refused by the port by name."""
    names = ["gif87a_global_256.gif", "gif_local_16_interlaced.gif", "gif_grey_ramp.gif",
             "gif_small_frame_transparent.gif", "gif_truncated.gif", "tiff_lzw.tif",
             "tiff_raw_rgb_planar.tif", "tiff_jpeg_libtiff.tif", "tiff_jpeg_444_strips.tif",
             "tiff_deflate_16bit_mm_predictor.tif", "tiff_lzma.tif", "tiff_orientation_6.tif",
             "tiff_lzw_strip_cut.tif", "tiff_mm_bigtiff.tif"]
    return [(f"word{i}", FILES[n]) for i, n in enumerate(names)]


@pytest.mark.parametrize("keep_ratio", [False, True], ids=["squash", "keep ratio"])
def test_lmdb_reader_on_gif_tiff_matches_jax(tmp_path, monkeypatch, keep_ratio):
    """A corpus of GIF and TIFF records: the port's samples are JAX's, the
    dummies at the same (broken) records."""
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)
    records = gif_tiff_records()
    write_lmdb(tmp_path / "gt", records)
    chars = ModelConfig().chars
    got = lmdb_data.LmdbReader(str(tmp_path / "gt"), chars, keep_ratio=keep_ratio)
    want = jlmdb.LmdbReader(str(tmp_path / "gt"), chars, keep_ratio=keep_ratio)
    assert got.index == want.index and len(got) == len(records)
    dummies = []
    for i in range(len(records)):
        same_samples([got[i]], [want[i]])
        if want[i].label == "[dummy_label]":
            dummies.append(i)
    assert dummies == [4, 12, 13]


def test_lmdb_record_refused_by_name_raises(tmp_path, monkeypatch):
    """A record of a kind the port names (a CCITT TIFF, a TGA, JPEG strips
    shorter than the TIFF's) raises NotImplementedError, where JAX's reader
    returns its sample: no dummy hides it."""
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)
    records = [("ccitt", FILES["tiff_ccitt_g4.tif"]), ("tga", NAMED_FILES["TGA"]),
               ("short", short_jpeg_strips())]
    write_lmdb(tmp_path / "named", records)
    chars = ModelConfig().chars
    got = lmdb_data.LmdbReader(str(tmp_path / "named"), chars)
    want = jlmdb.LmdbReader(str(tmp_path / "named"), chars)
    for i in range(len(records)):
        assert want[i].label != "[dummy_label]"
        with pytest.raises(NotImplementedError):
            got[i]


def test_raw_image_folder_reads_misnamed_gif_tiff_as_jax(tmp_path):
    """GIF and TIFF files under the folder's extensions (``.png``, ``.jpg``;
    GIF and TIFF are not among them, in JAX's list or the port's): the
    same paths and samples as JAX's folder."""
    assert raw.IMAGE_EXTS == jraw.IMAGE_EXTS
    for i, name in enumerate(["gif_local_16_interlaced.gif", "gif_frame_past_screen.gif",
                              "tiff_lzw_rgb_predictor.tif", "tiff_jpeg_444_strips.tif",
                              "tiff_raw_mm_tiles.tif"]):
        (tmp_path / f"w{i}{'.png' if i % 2 else '.jpg'}").write_bytes(FILES[name])
    (tmp_path / "w9.gif").write_bytes(FILES["gif87a_global_256.gif"])  # not an image name
    got, want = raw.RawImageFolder(str(tmp_path)), jraw.RawImageFolder(str(tmp_path))
    assert got.paths == want.paths and len(got) == 5
    same_samples(got, want)


# --- no fallback ----------------------------------------------------------------------


def test_decoders_raise_when_they_cannot_be_built(monkeypatch, tmp_path):
    """The GIF and TIFF libraries: a source that does not compile raises
    RuntimeError, no quiet fallback."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    for mod, name in ((gif, "gif87a_global_256.gif"), (tiff, "tiff_lzw.tif")):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "SOURCE", bad)
        monkeypatch.setattr(mod, "BUILD_DIR", tmp_path / "_build")
        with pytest.raises(RuntimeError, match="failed"):
            images.decode_gray(FILES[name])
    assert not list((tmp_path / "_build").glob("*.so"))


def test_lzma_strips_need_the_lzma_module(monkeypatch):
    """LZMA strips are inflated by Python's lzma, imported at the first one:
    without it the decode raises ImportError, no fallback; other TIFFs do
    not need it."""
    monkeypatch.setitem(sys.modules, "lzma", None)
    with pytest.raises(ImportError):
        images.decode_gray(FILES["tiff_lzma.tif"])
    np.testing.assert_array_equal(images.decode_gray(FILES["tiff_lzw.tif"]),
                                  pil_decode(FILES["tiff_lzw.tif"]))


@pytest.mark.parametrize("kind", ["gif screen", "gif frame", "tiff"])
def test_gif_tiff_bombs_raise_as_pil(kind):
    """More than twice PIL's pixel limit: DecompressionBombError at open, in
    PIL and in the port (a GIF screen, a GIF frame that grows it, a TIFF)."""
    small = np.zeros((2, 2), np.uint8)
    if kind == "gif screen":
        data = iw.gif(65535, 65535, [iw.gif_frame(small)], palette=iw.grey_ramp(4)[:6] + b"\1" * 6)
    elif kind == "gif frame":
        data = iw.gif(4, 4, [b"," + struct.pack("<HHHHB", 0, 0, 65535, 65535, 0) + b"\x02"
                             + iw.gif_blocks(iw.gif_lzw([1, 1], 2))])
    else:
        data = iw.tiff(small, tags={256: (4, [100000]), 257: (4, [100000])})
    with pytest.raises(Image.DecompressionBombError):
        pil_decode(data)
    with pytest.raises(images.DecompressionBombError):
        images.decode_gray(data)


def test_labels_json_unchanged():
    """formats/labels.json names only the JPEG crops of formats/: the GIF
    and TIFF files are not folder crops."""
    labels = json.loads((lf.OUT / "formats" / "labels.json").read_text())
    assert not [n for n in labels if n.endswith((".gif", ".tif"))]


def _codes(codes, size: int) -> bytes:
    """GIF codes of one width, packed LSB first."""
    acc = nacc = 0
    out = bytearray()
    for c in codes:
        acc |= c << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
    return bytes(out + (bytes([acc]) if nacc else b""))


@pytest.mark.parametrize("at", [500, 60000, 119999], ids=["early", "near 64k", "last pixel"])
def test_gif_end_code_pauses_as_pil(at):
    """PIL's GIF decoder stops at an end code and goes on where ImageFile
    reads more of the file (64 KiB at a time): a frame coded as a clear and a
    pixel each (3-bit codes) with an end code after pixel ``at`` decodes
    whole when the file holds more than was read, and is truncated when it
    does not."""
    rng = np.random.default_rng(at)
    px = rng.integers(0, 4, 300 * 400)
    codes = [c for p in px[:at] for c in (4, int(p))] + [5]
    codes += [c for p in px[at:] for c in (4, int(p))] + [5]
    frame = iw.gif_frame(px.reshape(300, 400), code_size=2, data=_codes(codes, 3))
    data = iw.gif(400, 300, [frame], palette=bytes(rng.integers(0, 256, 12, dtype=np.uint8)))
    same_outcome(data)
