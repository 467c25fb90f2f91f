"""TextOCR annotations and their word-crop dataset (JAX counterpart:
data/textocr.py): the split's ``TextOCR_<split>.json`` with its illegible
words (``utf8_string == "."``) dropped, only the images that the object-tag
JSON lists, each word with the overlap/scene vectors of its page's VinVL
objects, training labels filtered by charset and length."""

from __future__ import annotations

import json
import os
import zlib
from typing import List

from ..charset import check_text
from ..config import Config
from .cocotext import CocoTextAnnotation, CocoTextSamples, semantic_vectors


def build_textocr_annotations(cfg: Config, split: str) -> List[CocoTextAnnotation]:
    mcfg = cfg.model
    with open(os.path.join(cfg.data.textocr_anno_path, f"TextOCR_{split}.json")) as f:
        data = json.load(f)
    with open(cfg.data.textocr_object_tags_path) as f:
        object_tags = json.load(f)

    out: List[CocoTextAnnotation] = []
    for anno_id, anno in data["anns"].items():
        label = anno.get("utf8_string", "")
        if label == ".":  # TextOCR's mark of an illegible word
            continue
        img = data["imgs"][anno["image_id"]]
        if img.get("set") != split:
            continue
        if str(anno["image_id"]) not in object_tags:  # no detections: skipped
            continue
        if split == "train" and not check_text(label, mcfg.chars, mcfg.max_text_length):
            continue
        overlap, scene = semantic_vectors(object_tags[str(anno["image_id"])].get("vinvl", []),
                                          anno["bbox"], anno.get("area", 0.0),
                                          mcfg.semantic_assignment)
        out.append(CocoTextAnnotation(
            anno_id=_to_int_id(anno_id),
            image_path=os.path.join(cfg.data.textocr_image_path, img["file_name"]),
            bbox=tuple(anno["bbox"]), label=label, overlap=overlap, scene=scene))
    return out


def _to_int_id(anno_id) -> int:
    """A TextOCR id as an int: its value where it is numeric, else the
    CRC-32 of its text."""
    try:
        return int(anno_id)
    except (TypeError, ValueError):
        return zlib.crc32(str(anno_id).encode())


def get_textocr_datasets(cfg: Config):
    """``(train, val)`` :class:`CocoTextSamples` of ``cfg.data``'s files."""
    train = CocoTextSamples(build_textocr_annotations(cfg, "train"), cfg)
    val = CocoTextSamples(build_textocr_annotations(cfg, "val"), cfg)
    print(f"  - textocr: {len(train)} train / {len(val)} val word crops")
    return train, val
