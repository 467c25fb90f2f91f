"""Transformer encoder over the visual columns (JAX counterpart:
models/encoders.py, ``TransformerEncoder`` with the reference norm order)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import MultiHeadAttention, layer_norm, positional_rows


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.self_attn(x, x)
        x = self.norm1(x) + a
        f = self.linear2(torch.relu(self.linear1(x)))
        return self.norm2(x) + f


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 512, num_heads: int = 8, ff_dim: int = 2048,
                 num_layers: int = 6, max_len: int = 26):
        super().__init__()
        self.max_len, self.d_model, self.num_layers = max_len, d_model, num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(d_model, num_heads, ff_dim))
        self.final_norm = layer_norm(d_model)

    def forward(self, cols: torch.Tensor) -> torch.Tensor:
        """cols [B, T, d_model] float32 -> [B, T, d_model]."""
        pe = positional_rows(self.max_len, self.d_model, cols.device)
        x = cols + pe[: cols.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return self.final_norm(x)
