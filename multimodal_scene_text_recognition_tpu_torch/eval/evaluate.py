"""Evaluation: greedy validation with per-crop records, and the
error-correction study against a baseline's errors (JAX counterpart:
eval/evaluate.py).  An eval step from ``train.steps.make_eval_step`` decodes
whole batches on its model's device (``eval_step.device``); rows marked
``valid=False`` (the pad rows of a short final batch) are decoded and not
counted."""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

from ..charset import AttnCodec
from ..data.pipeline import device_batch
from ..metrics import EvalResult, PredRecord


def _decoded(eval_step: Callable, batch: Dict, codec: AttnCodec):
    ids = eval_step(device_batch(batch, eval_step.device))
    valid = batch.get("valid", np.ones(len(batch["labels"]), bool))
    return codec.decode(ids.cpu().numpy()), valid


def validate(eval_step: Callable, batches: Iterable[Dict[str, np.ndarray]], codec: AttnCodec,
             print_samples: bool = False, return_records: bool = False) -> EvalResult:
    """Greedy validation: exact-match word accuracy in percent, rounded to 5
    decimals, over the valid rows of ``batches``; with ``return_records``
    a :class:`PredRecord` per valid row."""
    correct = 0
    total = 0
    records: List[PredRecord] = []
    for batch in batches:
        preds, valid = _decoded(eval_step, batch, codec)
        if print_samples and total == 0:
            print("  - Ground truth:", batch["labels"][0])
            print("  - Prediction:  ", preds[0], "\n")
        for anno_id, label, pred, ok in zip(batch["anno_id"], batch["labels"], preds, valid):
            if not ok:
                continue
            is_correct = label == pred
            correct += int(is_correct)
            total += 1
            if return_records:
                records.append(PredRecord(int(anno_id), label, pred, is_correct))
    score = round(correct * 100 / max(total, 1), 5)
    return EvalResult(score, records if return_records else None)


def load_class_labels(class_labels_dir: str, source: str) -> List[str]:
    """The detector's class-id -> label list (``<source>_classes.txt``)."""
    path = os.path.join(class_labels_dir, f"{source.lower()}_classes.txt")
    with open(path) as f:
        return f.read().splitlines()


def tags_for(ids: Sequence[int], class_labels: List[str]) -> List[str]:
    """Labels of object ids, which are shifted by +1 so that 0 pads."""
    return [class_labels[int(i) - 1] for i in ids if int(i) != 0]


def error_diff_eval(eval_step: Callable, batches: Iterable[Dict[str, np.ndarray]],
                    codec: AttnCodec, base_error_ids: Set[str],
                    class_labels: Optional[List[str]] = None,
                    semantic_vector: str = "overlap",
                    print_sem: bool = False) -> Dict[str, object]:
    """Of the valid crops a baseline got wrong (``base_error_ids``: anno ids
    as strings), how many this model reads right; with ``class_labels``
    each one's object tags (its ``overlap`` ids, or ``scene`` for another
    ``semantic_vector``)."""
    corrected = 0
    total = 0
    detail = []
    for batch in batches:
        preds, valid = _decoded(eval_step, batch, codec)
        for i, (anno_id, label, pred, ok) in enumerate(
                zip(batch["anno_id"], batch["labels"], preds, valid)):
            if not ok or str(int(anno_id)) not in base_error_ids:
                continue
            total += 1
            tags = None
            if class_labels is not None:
                vec = batch["overlap"][i] if semantic_vector == "overlap" else batch["scene"][i]
                tags = tags_for(vec, class_labels)
                if print_sem:
                    print(tags)
            if label == pred:
                corrected += 1
                if print_sem:
                    print(label, pred)
            detail.append({"anno_id": int(anno_id), "label": label, "pred": pred,
                           "corrected": label == pred, "tags": tags})
    return {"corrected": corrected, "total": total,
            "correction_rate": corrected / max(total, 1), "detail": detail}
