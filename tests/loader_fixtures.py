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
(``twelve_bit.jpg``, ``hierarchical.jpg``).  The lossless kinds (Adam7 and
16-bit PNG, BMP, PNM) are written where they are used, by
``tests/image_writers.py``.

:func:`expected` reads the committed files back with PIL and the JAX
package: PIL's ``convert("L")`` of every page and crop, JAX's
``CocoTextSamples`` of the COCO-Text val split (images, ids, labels,
vectors) and the strings the trained flagship reads from them in float32
with each step's top-2 logit gap; for ``formats/``, PIL's decode of each
file (``format/<name>``) and the flagship's float32 strings and gaps of the
lossy crops read as JAX's ``RawImageFolder`` reads them
(``format_crops/...``).  A tier-1 test recomputes it and checks it equals
the committed ``expected.npz``.
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


def format_files(out: Path = OUT):
    return [name for name, _, _ in FORMAT_PAGES + FORMAT_CROPS]


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
