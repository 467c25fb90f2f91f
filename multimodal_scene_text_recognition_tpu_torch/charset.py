"""Label codecs and the training-label filter (JAX counterpart:
core/charset.py).

``AttnCodec``, the attention decoders': 0 = [GO], 1 = [s], 2 = [PAD], 3.. =
charset.  ``CTCCodec``, the CTC recipe's: 0 = [CTCblank], 1.. = charset.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

GO_ID = 0
EOS_ID = 1
PAD_ID = 2
BLANK_ID = 0  # the CTC codec's blank


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


class CTCCodec:
    """Strings -> 0-padded rows of character ids shifted by one, and
    per-column argmax rows -> strings by the best-path collapse: repeats
    merged, then blanks dropped."""

    def __init__(self, chars: str, max_text_length: int = 25):
        self.chars = chars
        self.max_text_length = max_text_length
        self.itos: List[str] = ["[CTCblank]"] + list(chars)
        self.stoi = {c: i + 1 for i, c in enumerate(chars)}

    @property
    def num_classes(self) -> int:
        return len(self.itos)

    def encode(self, texts: Sequence[str],
               max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Label rows ``int32 [B, max_len]`` (default ``max_text_length``),
        0 after the characters, and ``int32 [B]`` lengths."""
        max_len = self.max_text_length if max_len is None else max_len
        out = np.zeros((len(texts), max_len), dtype=np.int32)
        lengths = np.zeros((len(texts),), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.stoi[c] for c in t]
            if len(ids) > max_len:
                raise ValueError(f"text longer than max_text_length={max_len}: {t!r}")
            out[i, :len(ids)] = ids
            lengths[i] = len(ids)
        return out, lengths

    def decode(self, indices: np.ndarray,
               lengths: Optional[Sequence[int]] = None) -> List[str]:
        """The best-path collapse of each row of ``indices`` [B, T] (its
        first ``lengths[i]`` columns where given, else the whole row)."""
        indices = np.asarray(indices)
        if lengths is None:
            lengths = [indices.shape[1]] * indices.shape[0]
        texts = []
        for row, n in zip(indices, lengths):
            chars, prev = [], -1
            for i in row[:int(n)]:
                i = int(i)
                if i != BLANK_ID and i != prev:
                    chars.append(self.itos[i])
                prev = i
            texts.append("".join(chars))
        return texts


Codec = Union[AttnCodec, CTCCodec]


def check_text(text: str, chars: str, max_len: int = 25) -> bool:
    """The charset/length filter of training annotations: at most
    ``max_len`` characters, every one in ``chars``."""
    if len(text) > max_len:
        return False
    return all(c in chars for c in text)
