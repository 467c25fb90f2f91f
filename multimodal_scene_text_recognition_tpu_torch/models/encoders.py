"""Transformer encoder over the visual columns (JAX counterpart:
models/encoders.py, ``TransformerEncoder`` with the reference norm order).

``drop`` is the dropout of train mode (``x -> x`` at eval), applied at the
JAX module's sites: the positional encoding's output, the attention output
(``drop1``), the FF's hidden ReLU (``drop_ff``) and the FF output
(``drop2``).  With ``int8`` the attention projections and the FF matmuls
run through the int8 matmul (ops/int8.py) in eval mode; training stays
float.  With ``pre_encoder_mlp`` the semantic vectors are fused into the
columns before the positional encoding (:meth:`TransformerEncoder.fuse`)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.int8 import int8_linear
from .layers import FusionMLP, MultiHeadAttention, layer_norm, positional_rows, relevance_fusion

Drop = Callable[[torch.Tensor], torch.Tensor]


def no_dropout(x: torch.Tensor) -> torch.Tensor:
    return x


class EncoderLayer(nn.Module):
    """Attention reads the un-normed input; the residual stream is normed
    before each add (the reference model's order)."""

    def __init__(self, d_model: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ff_dim)
        self.linear2 = nn.Linear(ff_dim, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)

    def forward(self, x: torch.Tensor, drop: Drop = no_dropout,
                int8: bool = False) -> torch.Tensor:
        def dense(mod, h):
            if int8:
                return int8_linear(h, mod.weight.t(), mod.bias).to(h.dtype)
            return mod(h)

        a = self.self_attn(x, x, int8=int8)
        x = self.norm1(x) + drop(a)
        f = dense(self.linear2, drop(torch.relu(dense(self.linear1, x))))
        return self.norm2(x) + drop(f)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 512, num_heads: int = 8, ff_dim: int = 2048,
                 num_layers: int = 6, max_len: int = 26, int8: bool = False,
                 pre_encoder_mlp: bool = False, embed_dim: int = 256):
        super().__init__()
        self.max_len, self.d_model, self.num_layers = max_len, d_model, num_layers
        self.int8, self.pre_encoder_mlp = int8, pre_encoder_mlp
        if pre_encoder_mlp:
            width = d_model + embed_dim  # [column; semantic vector]
            self.sem_relevance_mlp = FusionMLP(width, d_model, 1, 3)
            self.combine_mlp = FusionMLP(width, d_model, d_model, 3)
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(d_model, num_heads, ff_dim))
        self.final_norm = layer_norm(d_model)

    def fuse(self, cols: torch.Tensor, semantics: Optional[torch.Tensor]) -> torch.Tensor:
        """The pre-encoder fusion (JAX encoders.py:131-145): each column plus
        ``combine_mlp`` of it beside its relevance-weighted semantic vector;
        ``cols`` unchanged without ``pre_encoder_mlp``."""
        if not self.pre_encoder_mlp:
            return cols
        rel = relevance_fusion(cols, semantics, self.sem_relevance_mlp)
        return cols + self.combine_mlp(torch.cat([cols, rel], dim=-1))

    def forward(self, cols: torch.Tensor, drop: Drop = no_dropout, train: bool = False,
                semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cols [B, T, d_model] float32 (semantics [B, O, embed_dim] with
        ``pre_encoder_mlp``) -> [B, T, d_model]; ``train`` turns the int8
        route off."""
        return self.encode(self.fuse(cols, semantics), drop, train)

    def encode(self, x: torch.Tensor, drop: Drop = no_dropout,
               train: bool = False) -> torch.Tensor:
        """The positional encoding, the layers and the final norm."""
        pe = positional_rows(self.max_len, self.d_model, x.device)
        x = drop(x + pe[: x.shape[1]])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, drop, int8=self.int8 and not train)
        return self.final_norm(x)
