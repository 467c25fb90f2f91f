"""The COCO-Text annotation index and its word-crop dataset (JAX counterpart:
data/cocotext.py).

* :class:`COCOTextIndex`: the annotation JSON (COCO-Text v2) indexed by
  annotation, image and image -> annotations; the train/val/test image
  lists; property and area queries; results loaded over the same images.
* :func:`build_cocotext_annotations`: the legible annotations of a split,
  each with its image path and the overlap/scene vectors of the objects
  detected on its page (the object-tag JSON, by ``semantic_source``);
  training labels filtered by charset and length, validation ones to
  ``language == "english"``.
* :class:`CocoTextSamples`: the word crops, decoded lazily: the page once
  (an LRU of 64 pages), then a bilinear crop resize to 32x100
  (``ops/resize``), or with ``use_native=False`` PIL's crop-then-resize.

Pages are decoded by ``data/images`` (no PIL; JPEG, PNG, BMP, PNM, WebP,
GIF and TIFF): a page PIL refuses raises its ``OSError``, as in JAX; a page
of a kind PIL opens and the port does not decode (arithmetic-coded or
lossless JPEG, the TIFF compressions and layouts ``data/tiff`` names, and
the formats ``data/identify`` names: DIB, ICO, TGA, PCX, SGI, ...) raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..charset import check_text
from ..config import Config
from . import geometry, images
from .sample import Sample


class COCOTextIndex:
    """An indexed COCO-Text v2 annotation file."""

    def __init__(self, annotation_file: Optional[str] = None):
        self.dataset: Dict = {}
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.img_to_anns: Dict[int, List[int]] = {}
        self.cats: Dict = {}
        self.train: List[int] = []
        self.val: List[int] = []
        self.test: List[int] = []
        if annotation_file:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self._index()

    def _index(self) -> None:
        ds = self.dataset
        self.img_to_anns = {int(k): v for k, v in ds.get("imgToAnns", {}).items()}
        self.imgs = {int(k): v for k, v in ds.get("imgs", {}).items()}
        self.anns = {int(k): v for k, v in ds.get("anns", {}).items()}
        self.cats = ds.get("cats", {})
        for img_id, img in self.imgs.items():
            getattr(self, img.get("set", "train")).append(img_id)

    def get_ann_by_props(self, properties: Sequence[Tuple[str, object]]) -> List[int]:
        """Ann ids matching all (key, value) property pairs."""
        return [aid for aid, ann in self.anns.items()
                if all(ann.get(k) == v for k, v in properties)]

    def get_ann_ids(self, img_ids: Sequence[int] = (), props: Sequence[Tuple[str, object]] = (),
                    area_range: Sequence[float] = ()) -> List[int]:
        if not img_ids and not props and not area_range:
            return list(self.anns.keys())
        if img_ids:
            ids: Iterable[int] = [a for i in img_ids for a in self.img_to_anns.get(int(i), [])]
        else:
            ids = list(self.anns.keys())
        if props:
            keep = set(self.get_ann_by_props(props))
            ids = [a for a in ids if a in keep]
        if area_range:
            lo, hi = area_range
            ids = [a for a in ids if lo < self.anns[a]["area"] < hi]
        return list(ids)

    def get_img_ids(self, img_ids: Sequence[int] = (),
                    props: Sequence[Tuple[str, object]] = ()) -> List[int]:
        if not img_ids and not props:
            return list(self.imgs.keys())
        ids = set(int(i) for i in img_ids) if img_ids else set(self.imgs.keys())
        if props:
            ids &= {self.anns[a]["image_id"] for a in self.get_ann_by_props(props)}
        return list(ids)

    def load_anns(self, ids) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[int(i)] for i in ids]

    def load_imgs(self, ids) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[int(i)] for i in ids]

    def load_results(self, result_file: str) -> "COCOTextIndex":
        """An index over the detection/recognition results in
        ``result_file`` (a JSON list of dicts), sharing this index's
        images; a result without an ``id`` is numbered from 1."""
        res = COCOTextIndex()
        res.dataset = {"imgs": self.dataset.get("imgs", {})}
        with open(result_file) as f:
            results = json.load(f)
        assert isinstance(results, list), "results must be a list of dicts"
        anns, img_to_anns = {}, {}
        for i, r in enumerate(results):
            rid = r.get("id", i + 1)
            assert r["image_id"] in self.imgs, f"result image_id {r['image_id']} not in dataset"
            anns[rid] = dict(r, id=rid)
            img_to_anns.setdefault(int(r["image_id"]), []).append(rid)
        res.anns = anns
        res.img_to_anns = img_to_anns
        res.imgs = self.imgs
        return res


def ann_rects(anns: Sequence[Dict]) -> List[Tuple[float, float, float, float]]:
    """The xywh rectangles that :func:`show_annotations` draws."""
    return [tuple(a["bbox"]) for a in anns]


def show_annotations(anns: Sequence[Dict], ax=None, show_text: bool = True,
                     show_mask: bool = False):
    """Draw annotations on a matplotlib axis: a filled patch of a random
    colour for each (its box, or with ``show_mask`` its ``mask`` polygon's
    outline) and its text.  matplotlib is imported here, when called."""
    import matplotlib.pyplot as plt
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import PathPatch, Rectangle
    from matplotlib.path import Path

    if not len(anns):
        return None
    ax = ax or plt.gca()
    rng = np.random.default_rng(0)
    patches, colors = [], []
    for a in anns:
        c = rng.random(3).tolist()
        if show_mask:  # a flat [x0, y0, x1, y1, ...] polygon, closed
            verts = list(zip(*[iter(a["mask"])] * 2)) + [(0, 0)]
            codes = [Path.MOVETO] + [Path.LINETO] * (len(verts) - 2) + [Path.CLOSEPOLY]
            patches.append(PathPatch(Path(verts, codes), facecolor="none"))
            tx, ty = verts[0]
        else:
            x, y, w, h = a["bbox"]
            patches.append(Rectangle((x, y), w, h, alpha=0.4))
            tx, ty = x, y
        colors.append(c)
        if show_text and a.get("utf8_string"):
            ax.annotate(a["utf8_string"], (tx, ty - 4), color=c)
    ax.add_collection(PatchCollection(patches, facecolors=colors, edgecolors=(0, 0, 0, 1),
                                      linewidths=3, alpha=0.4))
    return ax


@dataclass
class CocoTextAnnotation:
    anno_id: int
    image_path: str
    bbox: Tuple[float, float, float, float]
    label: str
    overlap: List[int]
    scene: List[int]


def semantic_vectors(objs: Sequence[Dict], bbox, area: float,
                     assignment: str) -> Tuple[List[int], List[int]]:
    """(overlap, scene) of a word box from its page's detected objects
    (dicts with ``class`` and an xywh ``bbox``)."""
    if not objs:
        return [], []
    classes = np.asarray([o["class"] for o in objs])
    boxes = np.asarray([o["bbox"] for o in objs], np.float64)
    overlap = geometry.overlap_vector(bbox, area, classes, boxes, assignment)
    scene, _ = geometry.scene_vector(classes)
    return overlap, scene


def build_cocotext_annotations(cfg: Config, split: str, index: Optional[COCOTextIndex] = None,
                               anno_filter: Optional[Sequence[int]] = None
                               ) -> List[CocoTextAnnotation]:
    """The legible annotations of ``split`` ("train" or "val"), in the
    annotation file's order, optionally only the ids in ``anno_filter``.
    Training labels must pass :func:`check_text`; validation ones must be
    English.  With ``semantic_source`` coco, vg or vinvl, each gets the
    vectors of its page's objects of that source."""
    mcfg = cfg.model
    index = index or COCOTextIndex(cfg.data.cocotext_api_path)
    with open(cfg.data.cocotext_object_tags_path) as f:
        object_tags = json.load(f)

    use_geometry = mcfg.semantic_source in ("coco", "vg", "vinvl")
    allowed = set(int(a) for a in anno_filter) if anno_filter else None
    out: List[CocoTextAnnotation] = []
    for anno_id, anno in index.anns.items():
        if allowed is not None and anno_id not in allowed:
            continue
        if anno.get("legibility") != "legible":
            continue
        img = index.imgs[int(anno["image_id"])]
        if img.get("set") != split:
            continue
        label = anno.get("utf8_string", "")
        if split == "train":
            if not check_text(label, mcfg.chars, mcfg.max_text_length):
                continue
        elif anno.get("language") != "english":
            continue
        overlap: List[int] = []
        scene: List[int] = []
        if use_geometry:
            objs = object_tags.get(str(anno["image_id"]), {}).get(mcfg.semantic_source.lower(), [])
            overlap, scene = semantic_vectors(objs, anno["bbox"], anno.get("area", 0.0),
                                              mcfg.semantic_assignment)
        out.append(CocoTextAnnotation(
            anno_id=anno_id, image_path=os.path.join(cfg.data.cocotext_image_path,
                                                     img["file_name"]),
            bbox=tuple(anno["bbox"]), label=label, overlap=overlap, scene=scene))
    return out


def load_crop(image_path: str, bbox: Sequence[float], out_h: int = 32,
              out_w: int = 100) -> np.ndarray:
    """Decode the page, crop the xywh ``bbox`` (PIL's rounding and zero
    fill) and resize it bilinearly: float32 [out_h, out_w, 1] in [0, 1]."""
    x, y, w, h = bbox
    crop = images.crop_gray(images.read_gray(image_path), (x, y, x + w, y + h))
    return (np.asarray(images.resize_gray(crop, out_w, out_h), np.float32) / 255.0)[..., None]


@functools.lru_cache(maxsize=64)
def _load_page(image_path: str) -> np.ndarray:
    """The decoded grayscale page, kept for its next crops (many word crops
    share a page)."""
    return images.read_gray(image_path)


def load_crop_native(image_path: str, bbox: Sequence[float], out_h: int = 32,
                     out_w: int = 100) -> np.ndarray:
    """The cached page cropped to ``bbox`` and resized in one bilinear pass
    by ``ops/resize.crop_resize_gray_batch`` (float box, half-pixel
    centres): float32 [out_h, out_w, 1]."""
    from ..ops.resize import crop_resize_gray_batch

    page = _load_page(image_path)
    return crop_resize_gray_batch([page], np.asarray([bbox], np.float32), out_h, out_w,
                                  threads=1)[0]


class CocoTextSamples:
    """The word crops of a list of annotations as :class:`Sample`s, each
    decoded when it is read (``load_crop_native``, or ``load_crop`` with
    ``use_native=False``)."""

    def __init__(self, annotations: List[CocoTextAnnotation], cfg: Config,
                 use_native: bool = True):
        self.annotations = annotations
        self.cfg = cfg
        self.use_native = use_native

    def __len__(self) -> int:
        return len(self.annotations)

    def __getitem__(self, i: int) -> Sample:
        a = self.annotations[i]
        m = self.cfg.model
        ov, sc, ious = geometry.pad_semantic_vectors(a.overlap, a.scene, m.max_overlap_objs,
                                                     m.max_scene_objs)
        loader = load_crop_native if self.use_native else load_crop
        return Sample(anno_id=a.anno_id, image=loader(a.image_path, a.bbox, m.img_h, m.img_w),
                      label=a.label, overlap=ov, scene=sc, ious=ious)


def get_cocotext_datasets(cfg: Config):
    """``(train, val)`` :class:`CocoTextSamples` of ``cfg.data``'s files."""
    index = COCOTextIndex(cfg.data.cocotext_api_path)
    train = CocoTextSamples(build_cocotext_annotations(cfg, "train", index), cfg)
    val = CocoTextSamples(build_cocotext_annotations(cfg, "val", index), cfg)
    print(f"  - cocotext: {len(train)} train / {len(val)} val word crops")
    return train, val
