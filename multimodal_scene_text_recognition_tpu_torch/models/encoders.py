"""Sequence encoders over the visual columns (JAX counterpart:
models/encoders.py): ``BiLSTMEncoder``, two BiLSTM blocks,
``TransformerEncoder``, in the reference model's norm order or textbook
post-LN (``norm_style``), and ``OscarEncoder``, the columns and the
semantic vectors through one BERT-shaped encoder.

The BiLSTM and Oscar encoders run in float32 whatever the compute type, as
the JAX package's do (their columns are cast to float32 and their
parameters stay float32); the BiLSTM encoder takes no semantics and has no
dropout, as there.

``drop`` is the dropout of train mode (``x -> x`` at eval), applied at the
JAX module's sites: the positional encoding's output, the attention output
(``drop1``), the FF's hidden ReLU (``drop_ff``) and the FF output
(``drop2``).  With ``int8`` the attention projections and the FF matmuls
run through the int8 matmul (ops/int8.py) in eval mode; training stays
float.  With ``pre_encoder_mlp`` the semantic vectors are fused into the
columns before the positional encoding (:meth:`TransformerEncoder.fuse`);
its relevance softmax [B, T, O] is kept under ``pre_encoder_scores`` in
``intermediates`` while that is a dict (``eval/attention.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import int8_linear
from ..ops.lstm import bilstm
from .layers import (FusionMLP, MultiHeadAttention, feed_forward, layer_norm, positional_rows,
                     relevance_fusion)

Drop = Callable[[torch.Tensor], torch.Tensor]


def no_dropout(x: torch.Tensor, columns=None) -> torch.Tensor:
    return x


class BiLSTMBlock(nn.Module):
    """A bidirectional LSTM (``fwd`` and ``bwd``, one ``nn.LSTM`` each) and
    the projection of its [B, T, 2H] states to ``out_dim``."""

    def __init__(self, input_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fwd = nn.LSTM(input_dim, hidden_dim, batch_first=True)
        self.bwd = nn.LSTM(input_dim, hidden_dim, batch_first=True)
        self.proj = nn.Linear(2 * hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(bilstm(x, self.fwd, self.bwd))


class BiLSTMEncoder(nn.Module):
    """Two stacked BiLSTM blocks ``l0`` and ``l1``: [B, T, input_dim] ->
    [B, T, out_dim] float32."""

    def __init__(self, input_dim: int = 512, hidden_dim: int = 256, out_dim: int = 256):
        super().__init__()
        self.l0 = BiLSTMBlock(input_dim, hidden_dim, out_dim)
        self.l1 = BiLSTMBlock(out_dim, hidden_dim, out_dim)

    def forward(self, cols: torch.Tensor, drop: Drop = no_dropout, train: bool = False,
                semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``drop``, ``train`` and ``semantics`` are taken and ignored, as
        the JAX encoder ignores them."""
        return self.l1(self.l0(cols.float()))


class EncoderLayer(nn.Module):
    """With ``norm_style="reference"`` attention reads the un-normed input
    and the residual stream is normed before each add (the reference
    model's order); with ``"standard"`` each sublayer's sum is normed
    (post-LN)."""

    def __init__(self, d_model: int, num_heads: int, ff_dim: int,
                 norm_style: str = "reference"):
        super().__init__()
        if norm_style not in ("reference", "standard"):
            raise ValueError(f"unknown encoder_norm_style {norm_style!r}")
        self.norm_style = norm_style
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

        def ff(h):
            if int8:
                return dense(self.linear2, drop(torch.relu(dense(self.linear1, h))))
            return feed_forward(self.linear1, self.linear2, torch.relu, h, drop)

        a = self.self_attn(x, x, int8=int8)
        if self.norm_style == "standard":
            x = self.norm1(x + drop(a))
            return self.norm2(x + drop(ff(x)))
        x = self.norm1(x) + drop(a)
        return self.norm2(x) + drop(ff(x))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 512, num_heads: int = 8, ff_dim: int = 2048,
                 num_layers: int = 6, max_len: int = 26, int8: bool = False,
                 pre_encoder_mlp: bool = False, embed_dim: int = 256,
                 norm_style: str = "reference"):
        super().__init__()
        self.max_len, self.d_model, self.num_layers = max_len, d_model, num_layers
        self.int8, self.pre_encoder_mlp = int8, pre_encoder_mlp
        if pre_encoder_mlp:
            width = d_model + embed_dim  # [column; semantic vector]
            self.sem_relevance_mlp = FusionMLP(width, d_model, 1, 3)
            self.combine_mlp = FusionMLP(width, d_model, d_model, 3)
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(d_model, num_heads, ff_dim, norm_style))
        self.final_norm = layer_norm(d_model)
        self.intermediates: Optional[dict] = None

    def fuse(self, cols: torch.Tensor, semantics: Optional[torch.Tensor]) -> torch.Tensor:
        """The pre-encoder fusion (JAX encoders.py:131-145): each column plus
        ``combine_mlp`` of it beside its relevance-weighted semantic vector;
        ``cols`` unchanged without ``pre_encoder_mlp``."""
        if not self.pre_encoder_mlp:
            return cols
        rel, scores = relevance_fusion(cols, semantics, self.sem_relevance_mlp,
                                       return_scores=True)
        if self.intermediates is not None:
            self.intermediates["pre_encoder_scores"] = scores.detach()
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


class OscarEncoder(nn.Module):
    """The columns, and with ``fuse_semantics`` the semantic vectors after
    them, through a BERT-shaped encoder (JAX ``OscarEncoder``).

    ``hid_to_bert`` maps the columns [B, T, d_model] to ``bert_dim``; with
    ``fuse_semantics`` ``sem_to_bert`` maps the semantic vectors [B, O,
    embed_dim] and appends them with segment id 1 (the columns' is 0).
    Then the ``pos_embed`` rows (``max_positions`` of them) and the
    ``seg_embed`` rows, ``embed_ln``, the one dropout site, and
    ``num_layers`` post-LN layers: ``attn{i}`` (packed q/k/v), ``ln1_{i}``,
    ``ff1_{i}``, exact erf GELU, ``ff2_{i}``, ``ln2_{i}``; every norm eps
    1e-12.  ``bert_to_hid`` maps the first T positions back to d_model."""

    def __init__(self, d_model: int = 512, embed_dim: int = 256, bert_dim: int = 768,
                 num_heads: int = 12, ff_dim: int = 3072, num_layers: int = 12,
                 max_positions: int = 512, fuse_semantics: bool = False):
        super().__init__()
        self.num_layers, self.fuse_semantics = num_layers, fuse_semantics
        self.hid_to_bert = nn.Linear(d_model, bert_dim)
        if fuse_semantics:
            self.sem_to_bert = nn.Linear(embed_dim, bert_dim)
        self.pos_embed = nn.Embedding(max_positions, bert_dim)
        self.seg_embed = nn.Embedding(2, bert_dim)
        self.embed_ln = nn.LayerNorm(bert_dim, eps=1e-12)
        for i in range(num_layers):
            self.add_module(f"attn{i}", MultiHeadAttention(bert_dim, num_heads))
            self.add_module(f"ln1_{i}", nn.LayerNorm(bert_dim, eps=1e-12))
            self.add_module(f"ff1_{i}", nn.Linear(bert_dim, ff_dim))
            self.add_module(f"ff2_{i}", nn.Linear(ff_dim, bert_dim))
            self.add_module(f"ln2_{i}", nn.LayerNorm(bert_dim, eps=1e-12))
        self.bert_to_hid = nn.Linear(bert_dim, d_model)

    def forward(self, cols: torch.Tensor, drop: Drop = no_dropout, train: bool = False,
                semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cols [B, T, d_model] (and semantics [B, O, embed_dim] with
        ``fuse_semantics``) -> [B, T, d_model] float32; ``drop`` is applied
        once, after ``embed_ln``."""
        T = cols.shape[1]
        x = self.hid_to_bert(cols.float())
        seg = self.seg_embed.weight[0].expand(T, -1)
        if self.fuse_semantics:
            sem = self.sem_to_bert(semantics.float())
            x = torch.cat([x, sem], dim=1)
            seg = torch.cat([seg, self.seg_embed.weight[1].expand(sem.shape[1], -1)])
        x = drop(self.embed_ln(x + self.pos_embed.weight[: x.shape[1]] + seg))
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}{i}")  # noqa: E731
            x = layer("ln1_")(x + layer("attn")(x, x))
            x = layer("ln2_")(x + feed_forward(layer("ff1_"), layer("ff2_"), F.gelu, x))
        return self.bert_to_hid(x[:, :T])
