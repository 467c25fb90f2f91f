"""Semantic-vector embedder (JAX counterpart: models/semantic.py,
``LinearEmbedding`` in its default 'overlap' mode)."""

from __future__ import annotations

import torch
from torch import nn


class LinearEmbedding(nn.Module):
    """Learned table over detector class ids (id 0 is the pad slot)."""

    def __init__(self, num_obj_classes: int = 2000, embed_dim: int = 256):
        super().__init__()
        self.embed = nn.Embedding(num_obj_classes, embed_dim)

    def forward(self, overlap: torch.Tensor) -> torch.Tensor:
        """overlap [B, n] int ids -> [B, n, embed_dim]."""
        return self.embed(overlap)
