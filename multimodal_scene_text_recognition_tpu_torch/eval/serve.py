"""Serving facade: crops in, strings out, in fixed batch buckets, by greedy
decoding or beam search (JAX counterpart: eval/serve.Recognizer)."""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..charset import AttnCodec


class Recognizer:
    """Recognition of grayscale crops through a
    :class:`~..models.model.SceneTextModel` (from ``api.get_model``).

    Crops must already be ``img_h x img_w`` (32x100): float in [0, 1] or
    uint8 (any crop whose maximum exceeds 1.5 is scaled by 1/255).  Resizing
    other sizes is not ported yet.
    """

    def __init__(self, model, batch_sizes: Sequence[int] = (1, 8, 64)):
        self.model = model
        self.cfg = model.cfg
        self.codec = AttnCodec(self.cfg.chars, self.cfg.max_text_length)
        self.batch_sizes = tuple(sorted(batch_sizes))
        self.device = next(model.parameters()).device

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def prepare(self, crops: Sequence[np.ndarray], B: int):
        """Stack ``crops`` into a zero-padded [B, H, W, 1] float32 batch and
        the (empty) object ids [B, max_overlap_objs] on the model's device."""
        m = self.cfg
        img = np.zeros((B, m.img_h, m.img_w, 1), np.float32)
        for i, c in enumerate(crops):
            c = np.asarray(c).astype(np.float32)
            if c.max() > 1.5:  # uint8-range input
                c = c / 255.0
            if c.ndim == 2:
                c = c[..., None]
            if c.shape != (m.img_h, m.img_w, 1):
                raise ValueError(
                    f"crop {i} has shape {c.shape}; this recognizer takes "
                    f"{m.img_h}x{m.img_w} grayscale crops (resizing is not ported)")
            img[i] = c
        image = torch.from_numpy(img).to(self.device)
        overlap = torch.zeros(B, m.max_overlap_objs, dtype=torch.long, device=self.device)
        return image, overlap

    @torch.no_grad()
    def recognize(self, crops: Sequence[np.ndarray], beam_size: int = 0,
                  return_scores: bool = False
                  ) -> Union[List[str], Tuple[List[str], List[float]]]:
        """Recognise a list of grayscale crops; returns the decoded strings,
        or with ``return_scores`` (strings, scores).

        ``beam_size`` > 0 decodes by beam search of that width, and a
        crop's score is its best beam's cumulative log-probability; greedy
        decoding (``beam_size=0``) scores every crop 0.0."""
        texts: List[str] = []
        scores: List[float] = []
        step = self.batch_sizes[-1]
        for i in range(0, len(crops), step):
            chunk = crops[i:i + step]
            n = len(chunk)
            image, overlap = self.prepare(chunk, self._bucket(n))
            if beam_size:
                ids, best = self.model.beam_decode(image, overlap, int(beam_size))
                scores.extend(best[:n].tolist())
            else:
                ids = self.model(image, overlap).argmax(dim=-1)
                scores.extend([0.0] * n)
            texts.extend(self.codec.decode(ids.cpu().numpy())[:n])
        return (texts, scores) if return_scores else texts
