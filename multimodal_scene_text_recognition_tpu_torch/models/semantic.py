"""Semantic-vector embedders: detector class ids -> [B, n_obj, embed_dim]
(JAX counterpart: models/semantic.py, ``LinearEmbedding`` in its three
modes, ``ZeroEmbedding`` and ``build_semantic_embedder``).

Every embedder takes ``(overlap [B, n_ov] ids, scene [B, n_sc] ids, ious
[B, n_sc] float32)``; id 0 is the pad slot.  The random and BERT embedders
are not ported (``SceneTextModel`` refuses them)."""

from __future__ import annotations

import torch
from torch import nn

MODES = ("overlap", "scene", "combined")


class LinearEmbedding(nn.Module):
    """Learned tables over detector class ids.

    * ``overlap``: the table ``embed`` over the overlap ids;
    * ``scene``: ``embed`` over the scene ids, each row weighted by the
      softmax of ``ious`` over the objects;
    * ``combined``: ``overlap_embed`` over the overlap ids and
      ``scene_embed`` over the scene ids cut to the overlap width,
      concatenated and mapped back to ``embed_dim`` by the dense layer
      ``combine``."""

    def __init__(self, num_obj_classes: int = 2000, embed_dim: int = 256,
                 mode: str = "overlap"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown semantic mode {mode!r}")
        self.mode = mode
        if mode == "combined":
            self.overlap_embed = nn.Embedding(num_obj_classes, embed_dim)
            self.scene_embed = nn.Embedding(num_obj_classes, embed_dim)
            self.combine = nn.Linear(2 * embed_dim, embed_dim)
        else:
            self.embed = nn.Embedding(num_obj_classes, embed_dim)

    def forward(self, overlap: torch.Tensor, scene: torch.Tensor,
                ious: torch.Tensor) -> torch.Tensor:
        if self.mode == "overlap":
            return self.embed(overlap)
        if self.mode == "scene":
            return self.embed(scene) * torch.softmax(ious, dim=1)[..., None]
        ov = self.overlap_embed(overlap)
        sc = self.scene_embed(scene[:, : overlap.shape[1]])
        return self.combine(torch.cat([ov, sc], dim=-1))


class ZeroEmbedding(nn.Module):
    """All-zero semantics (the ``zero`` source ablation)."""

    def __init__(self, embed_dim: int = 256):
        super().__init__()
        self.embed_dim = embed_dim

    def forward(self, overlap: torch.Tensor, scene: torch.Tensor,
                ious: torch.Tensor) -> torch.Tensor:
        return torch.zeros(*overlap.shape, self.embed_dim, device=overlap.device)


def build_semantic_embedder(cfg) -> nn.Module:
    """The embedder ``cfg`` selects (JAX ``build_semantic_embedder``);
    raises NotImplementedError for the unported ``rand`` source and
    ``bert`` embedding."""
    if cfg.semantic_source == "zero":
        return ZeroEmbedding(cfg.embed_dim)
    if cfg.semantic_source == "rand":
        raise NotImplementedError("the random semantic source (semantic_source='rand') "
                                  "is not ported")
    if cfg.semantic_embedding == "bert":
        raise NotImplementedError("the BERT semantic embedding (semantic_embedding='bert') "
                                  "is not ported")
    if cfg.semantic_embedding == "linear":
        return LinearEmbedding(cfg.num_obj_classes, cfg.embed_dim, mode=cfg.semantic_vector)
    raise ValueError(f"bad semantic config: source={cfg.semantic_source} "
                     f"embedding={cfg.semantic_embedding}")
