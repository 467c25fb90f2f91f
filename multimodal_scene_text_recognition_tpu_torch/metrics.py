"""Metrics: exact-match word accuracy, character accuracy, running
averages, and the records of a validation (JAX counterpart:
core/metrics.py).  Word accuracy is a case-sensitive exact match of the
[s]-pruned prediction, in percent rounded to 5 decimals."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence


class Averager:
    """Running mean of added values (each counted ``count`` times)."""

    def __init__(self) -> None:
        self.reset()

    def add(self, value: float, count: int = 1) -> None:
        self.total += float(value) * count
        self.n += count

    def reset(self) -> None:
        self.total = 0.0
        self.n = 0

    def val(self) -> float:
        return self.total / self.n if self.n else 0.0


def word_accuracy(preds: Sequence[str], targets: Sequence[str],
                  case_sensitive: bool = True) -> float:
    """Exact-match word accuracy in percent, rounded to 5 decimals (0 for
    no targets); ``case_sensitive=False`` compares lower-cased strings."""
    assert len(preds) == len(targets)
    if not targets:
        return 0.0
    if not case_sensitive:
        preds = [p.lower() for p in preds]
        targets = [t.lower() for t in targets]
    correct = sum(p == t for p, t in zip(preds, targets))
    return round(correct * 100 / len(targets), 5)


def char_accuracy(preds: Sequence[str], targets: Sequence[str]) -> float:
    """Mean per-word share of positions where prediction and target agree,
    over the longer of the two, in percent rounded to 5 decimals; an empty
    target scores 1 only against an empty prediction."""
    assert len(preds) == len(targets)
    if not targets:
        return 0.0
    total = 0.0
    for p, t in zip(preds, targets):
        if not t:
            total += float(p == t)
            continue
        total += sum(a == b for a, b in zip(p, t)) / max(len(p), len(t))
    return round(total * 100 / len(targets), 5)


@dataclass
class PredRecord:
    anno_id: int
    ground_truth: str
    prediction: str
    correct: bool


@dataclass
class EvalResult:
    """A validation's accuracy, and with ``return_records`` its per-crop
    records."""

    accuracy: float
    records: Optional[List[PredRecord]] = field(default=None)

    def to_dataframe(self):
        """The records as a pandas DataFrame (pandas is imported here only;
        without it, raises ImportError and ``records`` stays the list)."""
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError("EvalResult.to_dataframe needs pandas, which is not installed; "
                              "the per-crop records are in EvalResult.records") from e
        return pd.DataFrame([r.__dict__ for r in (self.records or [])])
