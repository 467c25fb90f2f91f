"""The sample every dataset yields (JAX counterpart: ``SyntheticSample`` in
data/synthetic.py): one word crop with its label and semantic vectors, the
input of ``pipeline.Batcher.collate`` and ``PackedSamples.from_samples``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Sample:
    anno_id: int
    image: np.ndarray  # [32, 100, 1] float32 in [0, 1]
    label: str
    overlap: np.ndarray  # [15] int32
    scene: np.ndarray  # [52] int32
    ious: np.ndarray  # [52] float32


def blank_semantics(max_overlap: int = 15, max_scene: int = 52):
    """The vectors of a crop without detections: zero overlap and scene
    ids, ious filled with -1000."""
    return (np.zeros(max_overlap, np.int32), np.zeros(max_scene, np.int32),
            np.full(max_scene, -1000.0, np.float32))
