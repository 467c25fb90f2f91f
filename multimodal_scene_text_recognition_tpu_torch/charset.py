"""Attention-decoder label codec (JAX counterpart: core/charset.py).

Vocabulary layout: 0 = [GO], 1 = [s], 2 = [PAD], 3.. = charset.
"""

from __future__ import annotations

from typing import List

import numpy as np

GO_ID = 0
EOS_ID = 1


class AttnCodec:
    """Index rows -> strings, pruned at the first [s]."""

    def __init__(self, chars: str, max_text_length: int = 25):
        self.chars = chars
        self.max_text_length = max_text_length
        self.itos: List[str] = ["[GO]", "[s]", "[PAD]"] + list(chars)

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
