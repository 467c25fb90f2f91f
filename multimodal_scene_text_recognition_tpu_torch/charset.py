"""Attention-decoder label codec (JAX counterpart: core/charset.py).

Vocabulary layout: 0 = [GO], 1 = [s], 2 = [PAD], 3.. = charset.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

GO_ID = 0
EOS_ID = 1
PAD_ID = 2


class AttnCodec:
    """Strings -> label rows, and index rows -> strings pruned at the first
    [s]."""

    def __init__(self, chars: str, max_text_length: int = 25):
        self.chars = chars
        self.max_text_length = max_text_length
        self.itos: List[str] = ["[GO]", "[s]", "[PAD]"] + list(chars)
        self.stoi = {c: i for i, c in enumerate(self.itos)}

    def encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Label rows ``int32 [B, max_text_length + 2]``: [GO], the
        characters, [s], then [PAD]; and ``int32 [B]`` lengths counting the
        characters and the [s]."""
        out = np.full((len(texts), self.max_text_length + 2), PAD_ID, dtype=np.int32)
        out[:, 0] = GO_ID
        lengths = np.zeros((len(texts),), dtype=np.int32)
        for i, t in enumerate(texts):
            if len(t) > self.max_text_length:
                raise ValueError(
                    f"text longer than max_text_length={self.max_text_length}: {t!r}")
            n = len(t)
            out[i, 1:1 + n] = [self.stoi[c] for c in t]
            out[i, 1 + n] = EOS_ID
            lengths[i] = n + 1
        return out, lengths

    def decode(self, indices: np.ndarray) -> List[str]:
        """``indices`` is [B, T] of predicted class ids (no [GO] column)."""
        out = []
        for row in np.asarray(indices):
            chars = []
            for i in row:
                i = int(i)
                if i == EOS_ID:
                    break
                chars.append(self.itos[i])
            out.append("".join(chars))
        return out
