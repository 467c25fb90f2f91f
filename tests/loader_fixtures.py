"""The loader fixtures in ``assets/loader_fixtures/``: small stand-ins for
COCO-Text, TextOCR and the MJSynth/SynthText LMDBs, made from the committed
synthetic validation set, and the values the loaders must read from them.

    python tests/loader_fixtures.py          # writes the files and expected.npz
    python tests/loader_fixtures.py --expected-only
    python tests/loader_fixtures.py --formats-only   # formats/ and expected.npz

Not a test module.  It imports PIL and the JAX package (the port does
neither).  :func:`make_files` writes, from one seed:

* six pages of 640x480: crops of the committed validation set scaled and
  pasted at recorded boxes onto a textured RGB background; five saved by
  PIL as baseline JPEG (4:2:0, 4:2:2 with optimized tables, 4:4:4, grey, 4:2:0
  with restart markers), one as PNG;
* ``cocotext.json`` (COCO-Text v2 layout: train and val pages, illegible
  and non-English words, training labels that fail the charset and length
  filter) and ``object_tags.json`` (coco, vg and vinvl detections: boxes
  around words, boxes across them, boxes elsewhere);
* ``TextOCR_train.json`` and ``TextOCR_val.json`` over the same pages
  (string ids, "." for illegible words, an image of the wrong set) and
  ``textocr_tags.json`` (vinvl only; one page has no entry);
* ``crops/``: sixteen word-crop JPEGs at other sizes than 32x100,
  ``labels.json`` and ``truncated.jpg``, half of a JPEG.

:func:`make_format_files` writes ``formats/`` from the committed pages and
crops: two 640x480 pages (page 1 re-saved as a progressive JPEG, page 4 as
a CMYK JPEG), twelve word crops in the lossy kinds the port's decoder
gained (progressive at each sampling, one with its last three scans cut so
that libjpeg smooths its blocks; CMYK with and without the Adobe marker,
YCCK), ``labels.json``, and two JPEGs PIL refuses with an OSError
(``twelve_bit.jpg``, ``hierarchical.jpg``); and, by :func:`make_webp_files`,
the WebP files of ``WEBP_FILES`` and ``WEBP_PAGES`` (PIL's save, or
libwebp's advanced API through :func:`libwebp_encode` for what PIL's save
does not pass on, or built by hand), a truncated and a corrupt WebP, and
the 192 committed crops as lossy WebP in one ``webp_crops_q30.npz``.  The
lossless kinds (Adam7 and 16-bit PNG, BMP, PNM, lossless WebP) are
written where they are used, by ``tests/image_writers.py``.

:func:`expected` reads the committed files back with PIL and the JAX
package: PIL's ``convert("L")`` of every page and crop, JAX's
``CocoTextSamples`` of the COCO-Text val split (images, ids, labels,
vectors) and the strings the trained flagship reads from them in float32
with each step's top-2 logit gap; for ``formats/``, PIL's decode of each
file (``format/<name>``) and the flagship's float32 strings and gaps of the
lossy crops read as JAX's ``RawImageFolder`` reads them
(``format_crops/...``); for the WebP files and crops, the sha256 of PIL's
decode (``format_webp/<name>``, ``format_webp_crops/sha256``: their arrays
would take the directory past the 2 MB its test allows).  A tier-1 test
recomputes it and checks it equals the committed ``expected.npz``.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "assets" / "loader_fixtures"
VAL_SET = ROOT / "assets" / "synthetic" / "synth_512_1000_10_f43b04_open_o2000_v1.npz"
BUNDLE = ROOT / "assets" / "trained" / "synth_openvocab_xxl.params.npz"
SEED = 2024
PAGE_W, PAGE_H = 640, 480
WORDS_PER_PAGE = 11
# (file name, split, how PIL saves it)
PAGES = (
    ("page_0.jpg", "train", dict(format="JPEG", quality=90, subsampling=2)),
    ("page_1.jpg", "val", dict(format="JPEG", quality=75, subsampling=1, optimize=True)),
    ("page_2.jpg", "train", dict(format="JPEG", quality=95, subsampling=0)),
    ("page_3.jpg", "val", dict(format="JPEG", quality=85, grey=True)),
    ("page_4.jpg", "val", dict(format="JPEG", quality=60, subsampling=2, restart_marker_blocks=5)),
    ("page_5.png", "val", dict(format="PNG")),
)
N_CROPS = 16
IMAGE_ID0, ANNO_ID0 = 4000, 900000


def _background(rng) -> np.ndarray:
    from PIL import Image

    low = rng.integers(60, 230, (6, 8, 3), dtype=np.uint8)
    return np.array(Image.fromarray(low).resize((PAGE_W, PAGE_H), Image.BICUBIC))


def _save(img: np.ndarray, path: Path, how: dict) -> None:
    from PIL import Image

    how = dict(how)
    im = Image.fromarray(img)
    if how.pop("grey", False):
        im = im.convert("L")
    im.save(path, **how)


def make_files(out: Path = OUT) -> None:
    """Write the pages, annotations, tags and crops (not expected.npz)."""
    from PIL import Image

    rng = np.random.default_rng(SEED)
    out.mkdir(parents=True, exist_ok=True)
    with np.load(VAL_SET) as z:
        crops, labels = z["image"][..., 0], [str(s) for s in z["labels"]]
    order = rng.permutation(len(crops))
    words = []  # (page index, box [x, y, w, h], label, crop index)
    k = 0
    for p, (name, split, how) in enumerate(PAGES):
        page = _background(rng)
        for cell in range(WORDS_PER_PAGE):
            i = int(order[k])
            k += 1
            h = int(rng.integers(26, 56))
            w = int(round(100 * h / 32 * rng.uniform(0.85, 1.25)))
            word = np.asarray(Image.fromarray(crops[i]).resize((w, h), Image.BICUBIC), np.float32)
            col, row = cell % 3, cell // 3
            x = int(col * 213 + rng.integers(2, max(3, 211 - w)))
            y = int(row * 120 + rng.integers(2, max(3, 118 - h)))
            w, h = min(w, PAGE_W - x), min(h, PAGE_H - y)
            tint = rng.uniform(0.8, 1.0, 3)
            page[y:y + h, x:x + w] = np.clip(word[:h, :w, None] * tint, 0, 255).astype(np.uint8)
            # annotated boxes are floats a little off the pasted rectangle
            box = [round(x - float(rng.uniform(0, 1.5)), 2), round(y - float(rng.uniform(0, 1.5)), 2),
                   round(w + float(rng.uniform(-0.5, 2.0)), 2),
                   round(h + float(rng.uniform(-0.5, 2.0)), 2)]
            words.append((p, box, labels[i], i))
        _save(page, out / name, how)

    # COCO-Text v2 layout
    imgs, anns, img_to_anns = {}, {}, {}
    for p, (name, split, _) in enumerate(PAGES):
        imgs[str(IMAGE_ID0 + p)] = {"id": IMAGE_ID0 + p, "file_name": name, "set": split,
                                    "width": PAGE_W, "height": PAGE_H}
    imgs[str(IMAGE_ID0 + len(PAGES))] = {"id": IMAGE_ID0 + len(PAGES),
                                         "file_name": PAGES[0][0], "set": "test",
                                         "width": PAGE_W, "height": PAGE_H}
    for n, (p, box, label, _) in enumerate(words):
        aid, split = ANNO_ID0 + n, PAGES[p][1]
        j = n % WORDS_PER_PAGE
        legible = "illegible" if j == 3 else "legible"
        language = "not english" if j == 7 else "english"
        if split == "train" and j == 5:
            label = label + "é"  # outside the charset
        if split == "train" and j == 9:
            label = (label * 30)[:27]  # longer than 25
        x, y, w, h = box
        anns[str(aid)] = {"id": aid, "image_id": IMAGE_ID0 + p, "bbox": box,
                          "area": round(w * h * 0.92, 2), "utf8_string": label,
                          "legibility": legible, "language": language,
                          "class": "machine printed",
                          "mask": [x, y, x + w, y, x + w, y + h, x, y + h]}
        img_to_anns.setdefault(str(IMAGE_ID0 + p), []).append(aid)
    with open(out / "cocotext.json", "w") as f:
        json.dump({"imgs": imgs, "anns": anns, "imgToAnns": img_to_anns, "cats": {},
                   "info": {"description": "loader fixtures"}}, f)

    def objects(page_words, n_extra):
        objs = []
        for _, (x, y, w, h), _, _ in page_words:
            kind = rng.integers(0, 3)
            cls = int(rng.integers(1, 1600))
            if kind == 0:  # around the word: contains it
                m = rng.uniform(8, 30, 4)
                objs.append({"class": cls, "bbox": [round(x - m[0], 2), round(y - m[1], 2),
                                                     round(w + m[0] + m[2], 2),
                                                     round(h + m[1] + m[3], 2)]})
            elif kind == 1:  # across it
                objs.append({"class": cls, "bbox": [round(x + w * 0.4, 2), round(y - 5, 2),
                                                     round(w, 2), round(h + 10, 2)]})
        for _ in range(n_extra):
            objs.append({"class": int(rng.integers(1, 1600)),
                         "bbox": [float(rng.uniform(0, 500)), float(rng.uniform(0, 400)),
                                  float(rng.uniform(20, 140)), float(rng.uniform(20, 80))]})
        if objs:  # a repeated class: the vectors keep its first occurrence
            objs.append(dict(objs[0], bbox=[1.0, 1.0, 30.0, 30.0]))
        return [objs[i] for i in rng.permutation(len(objs))]

    tags = {}
    for p in range(len(PAGES)):
        page_words = [wd for wd in words if wd[0] == p]
        tags[str(IMAGE_ID0 + p)] = {
            "coco": objects(page_words, 3), "vinvl": objects(page_words, 5),
            "vg": [] if p == 2 else objects(page_words, 4)}
    with open(out / "object_tags.json", "w") as f:
        json.dump(tags, f)

    # TextOCR layout over the same pages: string ids, "." for illegible
    textocr_tags = {}
    for split in ("train", "val"):
        timgs, tanns = {}, {}
        for p, (name, page_split, _) in enumerate(PAGES):
            iid = f"{0xa4e0 + p:04x}b7c{p}d2e"
            if page_split != split and not (split == "val" and p == 0):
                continue
            # page 0 appears in the val file marked train: skipped there
            timgs[iid] = {"id": iid, "file_name": name, "set": page_split,
                          "width": PAGE_W, "height": PAGE_H}
            if split == page_split and p != 3:  # page 3 has no detections
                textocr_tags[iid] = {"vinvl": objects([wd for wd in words if wd[0] == p], 4)}
            for n, (wp, box, label, _) in enumerate(words):
                if wp != p:
                    continue
                j = n % WORDS_PER_PAGE
                aid = str(ANNO_ID0 + n) if j % 4 == 0 else f"{iid}_{j}"
                if j == 6:
                    label = "."
                if split == "train" and j == 2:
                    label = label + "ü"
                tanns[aid] = {"id": aid, "image_id": iid, "bbox": box,
                              "area": round(box[2] * box[3] * 0.9, 2), "utf8_string": label}
        with open(out / f"TextOCR_{split}.json", "w") as f:
            json.dump({"imgs": timgs, "anns": tanns, "imgToAnns": {}}, f)
    with open(out / "textocr_tags.json", "w") as f:
        json.dump(textocr_tags, f)

    # word crops for the LMDB stand-ins, at other sizes than 32x100
    (out / "crops").mkdir(exist_ok=True)
    crop_labels = {}
    for c in range(N_CROPS):
        i = int(order[k])
        k += 1
        h, w = int(rng.integers(18, 64)), int(rng.integers(40, 260))
        if (h, w) == (32, 100):
            w += 1
        im = Image.fromarray(crops[i]).resize((w, h), Image.BICUBIC)
        name = f"crop_{c:02d}.jpg"
        if c % 3 == 0:
            im.save(out / "crops" / name, format="JPEG", quality=92)
        else:
            tint = rng.uniform(0.75, 1.0, 3)
            rgb = np.clip(np.asarray(im, np.float32)[..., None] * tint, 0, 255).astype(np.uint8)
            Image.fromarray(rgb).save(out / "crops" / name, format="JPEG", quality=88,
                                      subsampling=[0, 1, 2][c % 3])
        crop_labels[name] = labels[i]
    data = (out / "crops" / "crop_00.jpg").read_bytes()
    (out / "crops" / "truncated.jpg").write_bytes(data[:len(data) // 2])
    crop_labels["truncated.jpg"] = "broken"
    with open(out / "crops" / "labels.json", "w") as f:
        json.dump(crop_labels, f, indent=0, sort_keys=True)


FORMATS = OUT / "formats"
# (file name, the committed crop it is made from, how)
FORMAT_CROPS = (
    ("prog_grey.jpg", "crop_00.jpg", dict(grey=True, quality=85)),
    ("prog_444.jpg", "crop_01.jpg", dict(quality=90, subsampling=0)),
    ("prog_422.jpg", "crop_02.jpg", dict(quality=75, subsampling=1, optimize=True)),
    ("prog_420.jpg", "crop_04.jpg", dict(quality=80, subsampling=2, restart_marker_blocks=2)),
    ("prog_420_cut.jpg", "crop_05.jpg", dict(quality=88, subsampling=2, cut=3)),
    ("prog_grey_cut.jpg", "crop_06.jpg", dict(grey=True, quality=80, cut=3)),
    ("cmyk_444.jpg", "crop_07.jpg", dict(cmyk=True, quality=90, subsampling=0)),
    ("cmyk_420.jpg", "crop_08.jpg", dict(cmyk=True, quality=85, subsampling=2)),
    ("cmyk_no_adobe.jpg", "crop_09.jpg", dict(cmyk=True, quality=85, adobe=None)),
    ("ycck_420.jpg", "crop_10.jpg", dict(cmyk=True, quality=85, subsampling=2, adobe=2)),
    ("ycck_444.jpg", "crop_11.jpg", dict(cmyk=True, quality=92, subsampling=0, adobe=2)),
    ("cmyk_prog.jpg", "crop_12.jpg", dict(cmyk=True, quality=85, progressive=True)),
)
FORMAT_PAGES = (("page_progressive.jpg", "page_1.jpg", dict(quality=75, subsampling=1)),
                ("page_cmyk.jpg", "page_4.jpg", dict(cmyk=True, quality=60, subsampling=2)))
FORMAT_REFUSED = ("twelve_bit.jpg", "hierarchical.jpg")


def _format_jpeg(rgb: np.ndarray, how: dict) -> bytes:
    """``rgb`` saved by PIL as a progressive (or CMYK) JPEG as ``how``
    says, then edited: scans cut, the Adobe marker's transform set or the
    marker taken out."""
    import io

    import image_writers as iw
    from PIL import Image

    how = dict(how)
    im = Image.fromarray(rgb)
    if how.pop("grey", False):
        im = im.convert("L")
    cmyk = how.pop("cmyk", False)
    if cmyk:
        im = im.convert("CMYK")
    cut, adobe = how.pop("cut", 0), how.pop("adobe", 0)
    buf = io.BytesIO()
    im.save(buf, format="JPEG", progressive=how.pop("progressive", not cmyk), **how)
    data = buf.getvalue()
    if cut:
        data = iw.cut_scans(data, iw.n_scans(data) - cut)
    if adobe != 0:
        data = iw.adobe_transform(data, adobe)
    return data


def make_format_files(out: Path = OUT) -> None:
    """Write ``formats/`` from the committed pages and crops."""
    import image_writers as iw
    from PIL import Image

    fmt = out / "formats"
    fmt.mkdir(parents=True, exist_ok=True)
    for name, src, how in FORMAT_PAGES:
        rgb = np.asarray(Image.open(out / src).convert("RGB"))
        (fmt / name).write_bytes(_format_jpeg(rgb, how))
    labels_of = json.loads((out / "crops" / "labels.json").read_text())
    labels = {}
    for name, src, how in FORMAT_CROPS:
        rgb = np.asarray(Image.open(out / "crops" / src).convert("RGB"))
        (fmt / name).write_bytes(_format_jpeg(rgb, how))
        labels[name] = labels_of[src]
    with open(fmt / "labels.json", "w") as f:
        json.dump(labels, f, indent=0, sort_keys=True)
    base = (out / "crops" / "crop_03.jpg").read_bytes()
    (fmt / "twelve_bit.jpg").write_bytes(iw.retag_frame(base, precision=12))
    (fmt / "hierarchical.jpg").write_bytes(iw.retag_frame(base, marker=0xC5))
    make_webp_files(out)
    make_gif_tiff_files(out)


# WebP files of formats/: (file name, the committed crop or page it is made
# from, how).  "libwebp" options go to libwebp's advanced encoder API (the
# simple loop filter and the filter sharpness, raw alpha), which PIL's save
# does not reach; "pad" adds a flat margin (at method 0 libwebp then turns
# the macroblock skip flag on); "colors" quantizes first (colour indexing with 2, 4 or 16
# colours bundles 8, 4 or 2 pixels a byte); "alpha" adds an alpha plane of
# 255, 128 and 0 bands; "anim" saves the crop and its mirror as two frames;
# "small_first" builds an animation by hand whose first frame is smaller
# than its canvas.
WEBP_FILES = (
    ("webp_lossless_m0.webp", "crop_13.jpg", dict(lossless=True, method=0)),
    ("webp_lossless_m3.webp", "crop_09.jpg", dict(lossless=True, method=3, quality=50)),
    ("webp_lossless_m6.webp", "crop_01.jpg", dict(lossless=True, method=6, quality=100)),
    ("webp_lossless_rgba_exact.webp", "crop_08.jpg", dict(lossless=True, exact=True, alpha=True)),
    ("webp_palette_2.webp", "crop_12.jpg", dict(lossless=True, colors=2)),
    ("webp_palette_4.webp", "crop_06.jpg", dict(lossless=True, colors=4)),
    ("webp_palette_16.webp", "crop_03.jpg", dict(lossless=True, colors=16)),
    ("webp_lossy_q10.webp", "crop_00.jpg", dict(quality=10)),
    ("webp_lossy_q50.webp", "crop_02.jpg", dict(quality=50)),
    ("webp_lossy_q95.webp", "crop_13.jpg", dict(quality=95)),
    ("webp_lossy_skip.webp", "crop_10.jpg", dict(quality=40, method=0, pad=40)),
    ("webp_alpha_raw.webp", "crop_06.jpg",
     dict(alpha=True, libwebp=dict(quality=60, alpha_compression=0))),
    ("webp_alpha_lossless.webp", "crop_08.jpg", dict(quality=60, alpha=True, alpha_quality=100)),
    ("webp_alpha_q20.webp", "crop_03.jpg", dict(quality=60, alpha=True, alpha_quality=20)),
    ("webp_simple_filter.webp", "crop_05.jpg",
     dict(libwebp=dict(quality=70, filter_type=0, filter_strength=80, filter_sharpness=3))),
    ("webp_sharpness_7.webp", "crop_11.jpg",
     dict(libwebp=dict(quality=35, filter_strength=100, filter_sharpness=7, sns_strength=100))),
    ("webp_vp8x_meta.webp", "crop_09.jpg",
     dict(quality=75, icc_profile=b"\0" * 131, exif=b"Exif\0\0" + bytes(range(40)),
          xmp=b"<x:xmpmeta/>")),
    ("webp_anim.webp", "crop_04.jpg", dict(quality=70, anim=True)),
    ("webp_anim_small_first.webp", "crop_12.jpg", dict(small_first=True)),
)
WEBP_PAGES = (("page_0_lossy.webp", "page_0.jpg", dict(quality=50)),)
# a lossy crop cut in half, and a lossless one with a byte of its image data
# flipped (libwebp, and PIL, refuse both)
WEBP_REFUSED = ("webp_truncated.webp", "webp_corrupt.webp")
# the 192 crops that chip_smoke.py recognizes from a folder, as lossy WebP
WEBP_CROPS, WEBP_CROPS_N, WEBP_CROPS_QUALITY = "webp_crops_q30.npz", 192, 30

# the fields of libwebp's WebPConfig, in order (4 bytes each)
_WEBP_CONFIG = ("lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
                "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
                "show_compressed", "preprocessing", "partitions", "partition_limit",
                "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
                "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")


def libwebp_encode(rgb: np.ndarray, **config) -> bytes:
    """``rgb`` (uint8 [H, W, 3] or [H, W, 4]) encoded by the libwebp that
    Pillow bundles, through its advanced API (``WebPConfig`` fields by name)
    by ``ctypes``: the options PIL's save does not pass on."""
    import ctypes
    from pathlib import Path as P

    import PIL

    libs = P(PIL.__file__).parent.parent / "pillow.libs"
    for dep in sorted(libs.glob("libsharpyuv*.so*")):
        ctypes.CDLL(str(dep), mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(str(sorted(libs.glob("libwebp-*.so*"))[0]))
    abi = 0x0210
    cfg = (ctypes.c_int32 * 64)()
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), abi):
        raise RuntimeError("libwebp: WebPConfigInit failed")
    for key, value in config.items():
        typ = ctypes.c_float if key in ("quality", "target_PSNR") else ctypes.c_int32
        ctypes.cast(ctypes.byref(cfg, 4 * _WEBP_CONFIG.index(key)), ctypes.POINTER(typ))[0] = value
    if not lib.WebPValidateConfig(cfg):
        raise ValueError(f"libwebp refuses the config {config}")

    class Writer(ctypes.Structure):
        _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                    ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]

    pic = (ctypes.c_uint64 * 64)()  # WebPPicture, zeroed and set by its init
    if not lib.WebPPictureInitInternal(pic, abi):
        raise RuntimeError("libwebp: WebPPictureInit failed")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    ints = ctypes.cast(pic, ctypes.POINTER(ctypes.c_int32))
    ints[0], ints[2], ints[3] = 0, w, h  # use_argb, width, height
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    writer = Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not importer(pic, rgb.ctypes.data_as(ctypes.c_void_p), w * c):
            raise RuntimeError("libwebp: import failed")
        ptrs = ctypes.cast(pic, ctypes.POINTER(ctypes.c_void_p))
        ptrs[12] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value  # writer
        ptrs[13] = ctypes.addressof(writer)  # custom_ptr
        if not lib.WebPEncode(cfg, pic):
            raise RuntimeError("libwebp: WebPEncode failed")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(pic)
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def _alpha_bands(rgb: np.ndarray) -> np.ndarray:
    """``rgb`` with an alpha plane: 255 on the left half, then bands of 128
    and 0."""
    h, w = rgb.shape[:2]
    alpha = np.full((h, w), 255, np.uint8)
    alpha[:, w // 2:] = np.where(np.arange(w - w // 2) % 6 < 3, 128, 0)
    return np.dstack([rgb, alpha])


def _riff_chunks(data: bytes):
    """The (fourcc, payload) chunks of a WebP file."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def webp_encode(rgb: np.ndarray, how: dict) -> bytes:
    """``rgb`` as a WebP file as ``how`` says (see WEBP_FILES)."""
    import io

    import image_writers as iw
    from PIL import Image

    how = dict(how)
    pad = how.pop("pad", 0)
    if pad:  # a flat margin: macroblocks without residuals
        rgb = np.pad(rgb, ((pad, pad), (pad, pad), (0, 0)), constant_values=128)
    if how.pop("alpha", False):
        rgb = _alpha_bands(rgb)
    colors = how.pop("colors", 0)
    if colors:
        rgb = np.asarray(Image.fromarray(rgb).quantize(colors).convert("RGB"))
    if "libwebp" in how:
        return libwebp_encode(rgb, **how["libwebp"])
    if how.pop("anim", False):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="WEBP", save_all=True,
                                  append_images=[Image.fromarray(rgb[::-1].copy())],
                                  duration=100, loop=0, **how)
        return buf.getvalue()
    if how.pop("small_first", False):
        # frame 0, lossy with alpha, at (4, 6) of a canvas 10 and 8 pixels
        # larger; frame 1, lossless, over all of it
        h, w = rgb.shape[:2]
        buf = io.BytesIO()
        Image.fromarray(_alpha_bands(rgb)).save(buf, format="WEBP", quality=60)
        first = b"".join(iw.webp_chunk(t, p) for t, p in _riff_chunks(buf.getvalue())
                         if t in (b"ALPH", b"VP8 "))
        whole = np.pad(rgb, ((6, 2), (4, 6), (0, 0)), mode="edge")
        buf = io.BytesIO()
        Image.fromarray(whole).save(buf, format="WEBP", lossless=True)
        second = b"".join(iw.webp_chunk(t, p) for t, p in _riff_chunks(buf.getvalue())
                          if t == b"VP8L")
        return iw.webp_file([iw.vp8x_chunk(w + 10, h + 8, 0x02 | 0x10),
                             iw.webp_chunk(b"ANIM", bytes(6)),
                             iw.anmf_chunk(4, 6, w, h, first),
                             iw.anmf_chunk(0, 0, w + 10, h + 8, second)])
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="WEBP", **how)
    return buf.getvalue()


def webp_crops(out: Path = OUT):
    """The WebP files of ``formats/webp_crops_q30.npz``: a list of bytes."""
    with np.load(out / "formats" / WEBP_CROPS) as z:
        data, ends = z["data"].tobytes(), z["ends"]
    return [data[a:b] for a, b in zip(np.concatenate([[0], ends[:-1]]), ends)]


def gray_sha256(img: np.ndarray) -> np.ndarray:
    """sha256 of a decoded image's shape and bytes, as uint8 [32]: the
    expectation kept for the WebP pages and the 192 crops, whose arrays
    would take the fixture directory past its 2 MB."""
    import hashlib

    img = np.ascontiguousarray(img, np.uint8)
    digest = hashlib.sha256(str(img.shape).encode() + img.tobytes()).digest()
    return np.frombuffer(digest, np.uint8).copy()


def make_webp_files(out: Path = OUT) -> None:
    """Write the WebP files of ``formats/`` from the committed pages and
    crops, and the 192 lossy crops from the committed validation set."""
    import io

    from PIL import Image

    fmt = out / "formats"
    fmt.mkdir(parents=True, exist_ok=True)
    for name, src, how in WEBP_FILES:
        rgb = np.asarray(Image.open(out / "crops" / src).convert("RGB"))
        (fmt / name).write_bytes(webp_encode(rgb, how))
    for name, src, how in WEBP_PAGES:
        rgb = np.asarray(Image.open(out / src).convert("RGB"))
        (fmt / name).write_bytes(webp_encode(rgb, how))
    lossy = webp_encode(np.asarray(Image.open(out / "crops" / "crop_07.jpg").convert("RGB")),
                        dict(quality=80))
    (fmt / "webp_truncated.webp").write_bytes(lossy[:len(lossy) // 2])
    lossless = bytearray((fmt / "webp_lossless_m3.webp").read_bytes())
    for pos in range(len(lossless) // 2, len(lossless)):  # the first flip PIL refuses
        data = bytearray(lossless)
        data[pos] ^= 0xff
        try:
            Image.open(io.BytesIO(bytes(data))).convert("L")
        except OSError:
            break
    (fmt / "webp_corrupt.webp").write_bytes(bytes(data))
    with np.load(VAL_SET) as z:
        crops = z["image"][:WEBP_CROPS_N, ..., 0]
    files = [webp_encode(np.repeat(c[..., None], 3, 2), dict(quality=WEBP_CROPS_QUALITY))
             for c in crops]
    np.savez(fmt / WEBP_CROPS, data=np.frombuffer(b"".join(files), np.uint8),
             ends=np.cumsum([len(f) for f in files]))


# GIF and TIFF: the files of formats/ that need PIL's encoders (JPEG strips,
# CCITT), and the rest made by image_writers.gif_tiff_fixtures from CROP_GT
# and page_0.jpg wherever they are read.  expected.npz keeps, for every one,
# what PIL's open().convert("L") gives: "ok" and the sha256 of the array, or
# the class of its error (format_gif_tiff/...)
GIF_TIFF_STORED = ("tiff_jpeg_libtiff.tif", "tiff_jpeg_444_strips.tif", "tiff_ccitt_g4.tif")
CROP_GT = "crop_02.jpg"


def make_gif_tiff_files(out: Path = OUT) -> None:
    """Write the GIF and TIFF files of ``formats/`` that only PIL's
    encoders make: a JPEG-compressed TIFF by PIL's libtiff save (YCbCr
    4:2:0 strips, JPEGTables), one of 4:4:4 JPEG strips of PIL's JPEG
    encoder with their tables spliced out, and a CCITT group 4 TIFF (the
    port refuses it by name)."""
    import io

    import image_writers as iw
    from PIL import Image

    fmt = out / "formats"
    rgb = np.asarray(Image.open(out / "crops" / "crop_01.jpg").convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="TIFF", compression="jpeg")
    (fmt / "tiff_jpeg_libtiff.tif").write_bytes(buf.getvalue())
    rows, strips = 8, []
    for y in range(0, rgb.shape[0], rows):
        buf = io.BytesIO()
        Image.fromarray(rgb[y:y + rows]).save(buf, format="JPEG", quality=85, subsampling=0)
        strips.append(buf.getvalue())
    (fmt / "tiff_jpeg_444_strips.tif").write_bytes(
        iw.jpeg_tiff(strips, rgb.shape[1], rgb.shape[0], rows))
    buf = io.BytesIO()
    Image.fromarray(rgb[..., 0] > 128).save(buf, format="TIFF", compression="group4")
    (fmt / "tiff_ccitt_g4.tif").write_bytes(buf.getvalue())


def gif_tiff_files(out: Path = OUT, decode=None) -> dict:
    """{name: bytes} of every GIF and TIFF fixture: the stored ones and
    those made by hand from the committed crop and page (``decode`` reads
    the crop: PIL's by default)."""
    import image_writers as iw

    if decode is None:
        from PIL import Image

        decode = lambda path: np.asarray(Image.open(path).convert("L"))  # noqa: E731
    files = iw.gif_tiff_fixtures(decode(out / "crops" / CROP_GT),
                                 (out / "page_0.jpg").read_bytes())
    for name in GIF_TIFF_STORED:
        files[name] = (out / "formats" / name).read_bytes()
    return files


def pil_outcome(data: bytes):
    """("ok", sha256 of PIL's decode) or (the class of its error, zeros)."""
    import io

    from PIL import Image

    try:
        return "ok", gray_sha256(Image.open(io.BytesIO(data)).convert("L"))
    except Exception as e:  # noqa: BLE001 - the class is what is kept
        name = "OSError" if isinstance(e, OSError) else type(e).__name__
        return name, np.zeros(32, np.uint8)


def format_files(out: Path = OUT):
    return [name for name, _, _ in FORMAT_PAGES + FORMAT_CROPS]


def webp_files(out: Path = OUT):
    return [name for name, _, _ in WEBP_FILES + WEBP_PAGES]


def format_crop_files(out: Path = OUT):
    return [name for name, _, _ in FORMAT_CROPS]


def apply(cfg, sets: dict, jax: bool = True):
    """``cfg`` with the dotted overrides ``sets``, by JAX's (or with
    ``jax=False`` the port's) ``apply_overrides``."""
    if jax:
        from multimodal_scene_text_recognition_tpu.core.config import apply_overrides
    else:
        from multimodal_scene_text_recognition_tpu_torch.config import apply_overrides
    return apply_overrides(cfg, sets)


def fixture_config(out: Path = OUT, jax: bool = True, **model):
    """The JAX (or with ``jax=False`` the port's) ``Config`` that points the
    loaders at the fixtures in ``out``."""
    if jax:
        from multimodal_scene_text_recognition_tpu.core.config import Config
    else:
        from multimodal_scene_text_recognition_tpu_torch.config import Config
    sets = {"data.cocotext_api_path": str(out / "cocotext.json"),
            "data.cocotext_image_path": str(out),
            "data.cocotext_object_tags_path": str(out / "object_tags.json"),
            "data.textocr_anno_path": str(out), "data.textocr_image_path": str(out),
            "data.textocr_object_tags_path": str(out / "textocr_tags.json")}
    sets.update({f"model.{k}": v for k, v in model.items()})
    return apply(Config(), sets, jax)


def page_files(out: Path = OUT):
    return [name for name, _, _ in PAGES]


def crop_files(out: Path = OUT):
    return sorted(p.name for p in (out / "crops").glob("crop_*.jpg"))


def jax_flagship_read(images: np.ndarray):
    """The trained flagship in JAX, float32, greedy (its scan decode equals
    the fused kernel in float32): strings and each step's top-2 logit gap
    [N, 25] of ``images`` float32 [N, 32, 100, 1]."""
    import jax
    import jax.numpy as jnp

    from multimodal_scene_text_recognition_tpu.core.charset import AttnCodec
    from multimodal_scene_text_recognition_tpu.core.config import ModelConfig
    from multimodal_scene_text_recognition_tpu.models.model import build_model

    flat = np.load(BUNDLE)
    variables = {}
    for key in flat.files:
        if key.startswith("__"):
            continue
        *path, leaf = key.split(".")
        node = variables
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(flat[key].astype(np.float32))
    cfg = ModelConfig(compute_dtype="float32", decode_fused=False)
    B = len(images)
    logits = np.asarray(jax.jit(lambda v, x: build_model(cfg).apply(
        v, x, None, jnp.zeros((B, 15), jnp.int32), jnp.zeros((B, 52), jnp.int32),
        jnp.full((B, 52), -1000.0), train=False))(variables, jnp.asarray(images)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return AttnCodec(cfg.chars).decode(logits.argmax(-1)), (top2[..., 1] - top2[..., 0])


def expected(out: Path = OUT, strings: bool = True) -> dict:
    """What PIL and the JAX package read from the committed files."""
    import io

    from PIL import Image

    from multimodal_scene_text_recognition_tpu.data.cocotext import get_cocotext_datasets

    exp = {}
    for name in page_files(out):
        exp[f"page/{name}"] = np.asarray(Image.open(out / name).convert("L"))
    for name in crop_files(out):
        exp[f"crop/{name}"] = np.asarray(Image.open(out / "crops" / name).convert("L"))
    _, val = get_cocotext_datasets(fixture_config(out))
    samples = [val[i] for i in range(len(val))]
    exp["cocotext_val/image"] = np.stack([s.image for s in samples]).astype(np.float32)
    exp["cocotext_val/anno_id"] = np.asarray([s.anno_id for s in samples], np.int64)
    exp["cocotext_val/label"] = np.asarray([s.label for s in samples])
    exp["cocotext_val/overlap"] = np.stack([s.overlap for s in samples])
    exp["cocotext_val/scene"] = np.stack([s.scene for s in samples])
    if strings:
        texts, gaps = jax_flagship_read(exp["cocotext_val/image"])
        exp["cocotext_val/jax_f32_text"] = np.asarray(texts)
        exp["cocotext_val/jax_f32_top2_gap"] = gaps.astype(np.float32)
    fmt = out / "formats"
    for name in format_files(out):
        exp[f"format/{name}"] = np.asarray(Image.open(fmt / name).convert("L"))
    names = format_crop_files(out)
    exp["format_crops/name"] = np.asarray(names)
    if strings:
        from multimodal_scene_text_recognition_tpu.data.raw import RawImageFolder

        folder = RawImageFolder(str(fmt))
        folder.paths = [str(fmt / n) for n in names]  # not the files PIL refuses
        texts, gaps = jax_flagship_read(np.stack([folder[i].image for i in range(len(names))]))
        exp["format_crops/jax_f32_text"] = np.asarray(texts)
        exp["format_crops/jax_f32_top2_gap"] = gaps.astype(np.float32)
    for name in webp_files(out):
        exp[f"format_webp/{name}"] = gray_sha256(Image.open(fmt / name).convert("L"))
    exp["format_webp_crops/sha256"] = np.stack(
        [gray_sha256(Image.open(io.BytesIO(f)).convert("L")) for f in webp_crops(out)])
    files = gif_tiff_files(out)
    outcomes = [pil_outcome(files[n]) for n in sorted(files)]
    exp["format_gif_tiff/name"] = np.asarray(sorted(files))
    exp["format_gif_tiff/outcome"] = np.asarray([o for o, _ in outcomes])
    exp["format_gif_tiff/sha256"] = np.stack([h for _, h in outcomes])
    return exp


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    from multimodal_scene_text_recognition_tpu.utils import native

    if not native.have_native():
        raise SystemExit("the JAX package's native crop resize did not build (make -C native)")
    if "--formats-only" in argv:
        make_format_files()
    elif "--expected-only" not in argv:
        make_files()
        make_format_files()
    np.savez_compressed(OUT / "expected.npz", **expected())
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT}: {total} bytes")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
