"""Class tags -> token-id rows for the BERT semantic embedder (JAX
counterpart: data/bert_tokens.py; numpy only, kept here as its own copy).

The vocabulary is built from the detector class-label lines themselves:
the four specials (``[PAD]`` = 0, ``[CLS]``, ``[SEP]``, ``[UNK]``), then
each new lower-cased word of the labels in order, so it needs no download.
A row is ``[CLS] tag1 [SEP] tag2 [SEP] ...`` cut and zero-padded to
``max_len``; the BERT embedder reads it in ``overlap``, whose pad id is 0
too (``assets/features/vinvl_classes.txt`` is the repo's label file)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, CLS, SEP, UNK = "[PAD]", "[CLS]", "[SEP]", "[UNK]"
SPECIALS = [PAD, CLS, SEP, UNK]


class TagTokenizer:
    """Word-level tokenizer over detector class labels, or over ``vocab``
    (word -> id) where one is given."""

    def __init__(self, class_labels: Sequence[str],
                 vocab: Optional[Dict[str, int]] = None):
        if vocab is not None:
            self.vocab = dict(vocab)
            return
        self.vocab = {t: i for i, t in enumerate(SPECIALS)}
        for label in class_labels:
            for word in label.strip().lower().split():
                self.vocab.setdefault(word, len(self.vocab))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode_tags(self, tags: Sequence[str], max_len: int = 64,
                    encode_frequency: bool = False,
                    counts: Optional[Sequence[int]] = None) -> np.ndarray:
        """int32 [max_len]: ``[CLS]``, then each tag's words (unknown words
        ``[UNK]``) followed by ``[SEP]``, the last ``[SEP]`` dropped, cut to
        ``max_len`` and zero-padded.  With ``encode_frequency`` and
        ``counts``, tag i is repeated ``counts[i]`` times."""
        ids: List[int] = [self.vocab[CLS]]
        unk, sep = self.vocab[UNK], self.vocab[SEP]
        reps = counts if (encode_frequency and counts) else [1] * len(tags)
        for tag, n in zip(tags, reps):
            for _ in range(int(n)):
                ids.extend(self.vocab.get(w, unk) for w in tag.strip().lower().split())
                ids.append(sep)
        if len(ids) > 1:
            ids.pop()
        ids = ids[:max_len]
        out = np.zeros(max_len, np.int32)
        out[: len(ids)] = ids
        return out


def tokenizer_from_class_file(path: str) -> TagTokenizer:
    """The tokenizer over the labels of ``path``, one class a line."""
    with open(path) as f:
        return TagTokenizer(f.read().splitlines())
