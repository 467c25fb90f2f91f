"""The overlap and scene vectors of a word crop from the objects detected
on its page, in numpy over all objects at once (JAX counterpart:
data/geometry.py, of which this is a copy; the reference tested one
shapely polygon per object, but the boxes are axis-aligned, so IoU is box
arithmetic).

Conventions kept exactly:
  * class ids are shifted +1 so that 0 is padding;
  * 'overlap' = the unique classes of the objects whose box strictly
    contains the word box rescaled by its mask area (assignment "resize"),
    or whose IoU + 1 reaches the threshold (a numeric assignment: the
    reference's IoU score is iou + 1, and the thresholds 0.25/0.50/0.75 are
    compared with that shifted value);
  * 'scene' = the unique classes of all objects, relevance scores 1.0;
  * unique classes keep their first-occurrence order;
  * ious are filled with -1000 (the reference never loads them).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def rescale_bbox_by_mask_area(bbox: Sequence[float], area: float) -> np.ndarray:
    """Shrink/grow an xywh box about its centre by mask_area / box_area."""
    x, y, w, h = bbox
    box_area = w * h
    if box_area == 0:
        box_area = 1.0
    s = area / box_area
    cx, cy = x + w / 2.0, y + h / 2.0
    nw, nh = w * s, h * s
    return np.asarray([cx - nw / 2.0, cy - nh / 2.0, nw, nh], np.float64)


def contains(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """Strict containment of `inner` [4] in each `outer` [N, 4] (xywh)
    (reference: coco_dataset.py:356)."""
    ox, oy, ow, oh = outer.T
    ix, iy, iw, ih = inner
    return (ox < ix) & (oy < iy) & (ox + ow > ix + iw) & (oy + oh > iy + ih)


def iou_xywh(boxes: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """IoU of each xywh box in `boxes` [N, 4] with `ref` [4].

    Replaces the reference's shapely polygons (coco_dataset.py:361-373) —
    the polygons are always axis-aligned rectangles.
    """
    bx, by, bw, bh = boxes.T
    rx, ry, rw, rh = ref
    ix1 = np.maximum(bx, rx)
    iy1 = np.maximum(by, ry)
    ix2 = np.minimum(bx + bw, rx + rw)
    iy2 = np.minimum(by + bh, ry + rh)
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    union = bw * bh + rw * rh - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def _unique_preserve_order(ids: np.ndarray) -> List[int]:
    seen = set()
    out = []
    for i in ids:
        i = int(i)
        if i not in seen:
            seen.add(i)
            out.append(i)
    return out


def overlap_vector(
    anno_bbox: Sequence[float],
    anno_area: float,
    obj_classes: np.ndarray,
    obj_boxes: np.ndarray,
    assignment: str = "resize",
) -> List[int]:
    """Unique +1-shifted classes of objects containing/overlapping the text
    region (reference: coco_dataset.py:275-290)."""
    if len(obj_classes) == 0:
        return []
    shifted = np.asarray(obj_classes) + 1
    if assignment == "resize":
        target = rescale_bbox_by_mask_area(anno_bbox, anno_area)
        keep = contains(np.asarray(obj_boxes, np.float64), target)
    else:
        thr = float(assignment)
        # reference get_iou_score returns iou + 1 (coco_dataset.py:373)
        keep = (iou_xywh(np.asarray(obj_boxes, np.float64),
                         np.asarray(anno_bbox, np.float64)) + 1.0) >= thr
    return _unique_preserve_order(shifted[keep])


def scene_vector(
    obj_classes: np.ndarray,
) -> Tuple[List[int], List[float]]:
    """All unique +1-shifted classes + rel-scores (hardcoded 1.0, reference:
    coco_dataset.py:292-312)."""
    uniq = _unique_preserve_order(np.asarray(obj_classes) + 1)
    return uniq, [1.0] * len(uniq)


def pad_semantic_vectors(
    overlap: Sequence[int],
    scene: Sequence[int],
    max_overlap: int = 15,
    max_scene: int = 52,
    iou_fill: float = -1000.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-shape padding (reference: coco_dataset.py:245-262): overlap ->
    15, scene -> 52, ious -> 52 filled with -1000 (iou loading is commented
    out in the reference, :259-260)."""
    ov = np.zeros(max_overlap, np.int32)
    ov[: len(overlap)] = np.asarray(list(overlap)[:max_overlap], np.int32)
    sc = np.zeros(max_scene, np.int32)
    sc[: len(scene)] = np.asarray(list(scene)[:max_scene], np.int32)
    ious = np.full(max_scene, iou_fill, np.float32)
    return ov, sc, ious
