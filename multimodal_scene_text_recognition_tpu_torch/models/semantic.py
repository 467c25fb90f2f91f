"""Semantic-vector embedders: detector class ids -> [B, n_obj, embed_dim]
(JAX counterpart: models/semantic.py, ``LinearEmbedding`` in its three
modes, ``ZeroEmbedding``, ``RandomEmbedding``, ``BertEmbedding`` and
``build_semantic_embedder``).

Every embedder takes ``(overlap [B, n_ov] ids, scene [B, n_sc] ids, ious
[B, n_sc] float32)`` and a ``generator``, which only the random one reads;
id 0 is the pad slot.  The BERT embedder reads token ids
(``data/bert_tokens.TagTokenizer``) in ``overlap``.  Everything runs in
float32."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import feed_forward, uniform

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

    def forward(self, overlap: torch.Tensor, scene: torch.Tensor, ious: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
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

    def forward(self, overlap: torch.Tensor, scene: torch.Tensor, ious: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.zeros(*overlap.shape, self.embed_dim, device=overlap.device)


class RandomEmbedding(nn.Module):
    """Random semantics (the ``rand`` source ablation): fresh uniform [0, 1)
    noise [B, n_ov, embed_dim] each call, drawn from ``generator`` (on
    ``overlap``'s device).  Only training passes one: as JAX's eval paths
    give its module no ``semantics`` stream, serving and validating a
    ``rand`` model raise."""

    def __init__(self, embed_dim: int = 256):
        super().__init__()
        self.embed_dim = embed_dim

    def forward(self, overlap: torch.Tensor, scene: torch.Tensor, ious: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            raise ValueError("semantic_source='rand' draws its semantics from the train "
                             "step's generator: a rand model is trained, not served or "
                             "validated (the JAX package's eval paths raise too)")
        return uniform((*overlap.shape, self.embed_dim), generator, overlap.device)


class BertEmbedding(nn.Module):
    """A DistilBERT-shaped text encoder over the tag token ids in
    ``overlap`` [B, T]: the ``tok`` and ``pos`` tables, ``embed_ln``, then
    ``num_layers`` post-LN layers (separate ``q_lin``/``k_lin``/``v_lin``/
    ``out_lin``, ``sa_ln``, the FF ``ff1_``/``ff2_`` with exact erf GELU,
    ``out_ln``; every norm eps 1e-12), and ``proj`` model_dim ->
    embed_dim.  No attention mask (pad tokens are attended) and no dropout,
    as in the JAX module."""

    def __init__(self, vocab_size: int = 30522, embed_dim: int = 256, model_dim: int = 768,
                 num_layers: int = 6, num_heads: int = 12, ff_dim: int = 3072,
                 max_positions: int = 512):
        super().__init__()
        self.num_layers, self.num_heads = num_layers, num_heads
        self.tok = nn.Embedding(vocab_size, model_dim)
        self.pos = nn.Embedding(max_positions, model_dim)
        self.embed_ln = nn.LayerNorm(model_dim, eps=1e-12)
        for i in range(num_layers):
            for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
                self.add_module(f"{name}{i}", nn.Linear(model_dim, model_dim))
            self.add_module(f"sa_ln{i}", nn.LayerNorm(model_dim, eps=1e-12))
            self.add_module(f"ff1_{i}", nn.Linear(model_dim, ff_dim))
            self.add_module(f"ff2_{i}", nn.Linear(ff_dim, model_dim))
            self.add_module(f"out_ln{i}", nn.LayerNorm(model_dim, eps=1e-12))
        self.proj = nn.Linear(model_dim, embed_dim)

    def forward(self, overlap: torch.Tensor, scene: torch.Tensor, ious: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T = overlap.shape
        H = self.num_heads
        x = self.tok(overlap) + self.pos.weight[:T]
        x = self.embed_ln(x)
        D = x.shape[-1]
        hd = D // H

        def heads(t):  # [B, T, D] -> [B, H, T, hd]
            return t.reshape(B, T, H, hd).transpose(1, 2)

        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}{i}")  # noqa: E731
            q, k, v = (heads(layer(n)(x)) for n in ("q_lin", "k_lin", "v_lin"))
            a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
            o = layer("out_lin")((a @ v).transpose(1, 2).reshape(B, T, D))
            x = layer("sa_ln")(x + o)
            h = feed_forward(layer("ff1_"), layer("ff2_"), F.gelu, x)
            x = layer("out_ln")(x + h)
        return self.proj(x)


def build_semantic_embedder(cfg) -> nn.Module:
    """The embedder ``cfg`` selects, in JAX ``build_semantic_embedder``'s
    order: the ``zero`` and ``rand`` sources first, then the embedding."""
    if cfg.semantic_source == "zero":
        return ZeroEmbedding(cfg.embed_dim)
    if cfg.semantic_source == "rand":
        return RandomEmbedding(cfg.embed_dim)
    if cfg.semantic_embedding == "bert":
        return BertEmbedding(embed_dim=cfg.embed_dim)
    if cfg.semantic_embedding == "linear":
        return LinearEmbedding(cfg.num_obj_classes, cfg.embed_dim, mode=cfg.semantic_vector)
    raise ValueError(f"bad semantic config: source={cfg.semantic_source} "
                     f"embedding={cfg.semantic_embedding}")
