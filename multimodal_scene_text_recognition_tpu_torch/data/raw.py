"""A folder of word-crop images for inference (JAX counterpart:
data/raw.py): the image files under a directory, natural-sorted, each
decoded to grey (``data/images``) and resized bilinearly to the model's
input; a sample's label is its file name."""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from . import images
from .sample import Sample, blank_semantics

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")


def natural_key(s: str):
    """Natural sort key: digit runs compare as numbers, the rest lowercased."""
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def list_images(root: str) -> List[str]:
    paths = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.lower().endswith(IMAGE_EXTS):
                paths.append(os.path.join(dirpath, f))
    return sorted(paths, key=natural_key)


class RawImageFolder:
    """The images under ``root`` as :class:`Sample`s, decoded when read.
    What PIL refuses raises its ``OSError``, as in JAX; a file of a kind
    PIL opens and ``data/images`` does not decode (arithmetic-coded or
    lossless JPEG, or a format ``data/identify`` names, under one of these
    extensions) raises ``NotImplementedError`` naming it.  GIF and TIFF
    files come here only misnamed (``IMAGE_EXTS`` is JAX's list) and are
    decoded as PIL decodes them."""

    def __init__(self, root: str, img_h: int = 32, img_w: int = 100):
        self.paths = list_images(root)
        self.img_h, self.img_w = img_h, img_w

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> Sample:
        path = self.paths[i]
        img = images.resize_gray(images.read_gray(path), self.img_w, self.img_h)
        ov, sc, ious = blank_semantics()
        return Sample(anno_id=i, image=(np.asarray(img, np.float32) / 255.0)[..., None],
                      label=os.path.basename(path), overlap=ov, scene=sc, ious=ious)
