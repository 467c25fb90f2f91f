"""Transformer encoder over the visual columns (JAX counterpart:
models/encoders.py, ``TransformerEncoder`` with the reference norm order).

``drop`` is the dropout of train mode (``x -> x`` at eval), applied at the
JAX module's sites: the positional encoding's output, the attention output
(``drop1``), the FF's hidden ReLU (``drop_ff``) and the FF output
(``drop2``)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .layers import MultiHeadAttention, layer_norm, positional_rows

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

    def forward(self, x: torch.Tensor, drop: Drop = no_dropout) -> torch.Tensor:
        a = self.self_attn(x, x)
        x = self.norm1(x) + drop(a)
        f = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm2(x) + drop(f)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 512, num_heads: int = 8, ff_dim: int = 2048,
                 num_layers: int = 6, max_len: int = 26):
        super().__init__()
        self.max_len, self.d_model, self.num_layers = max_len, d_model, num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(d_model, num_heads, ff_dim))
        self.final_norm = layer_norm(d_model)

    def forward(self, cols: torch.Tensor, drop: Drop = no_dropout) -> torch.Tensor:
        """cols [B, T, d_model] float32 -> [B, T, d_model]."""
        pe = positional_rows(self.max_len, self.d_model, cols.device)
        x = drop(cols + pe[: cols.shape[1]])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, drop)
        return self.final_norm(x)
