"""Transformer decoder (JAX counterpart: models/decoders.py
``TransformerDecoder``).

Serving: the memory projection ``hid_to_emb`` and the per-layer
cross-attention K/V run once in float32; the whole 25-step greedy loop is
one launch of the fused decode kernel (ops/fused_decode.py) in the compute
type.  Training: one teacher-forced causal pass in float32, as the JAX
package trains its decoder.  The scan stepper, early stop and beam search
are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..charset import GO_ID
from ..ops.attention import causal_mask, qkv_projections
from ..ops.fused_decode import cast_weights, fused_greedy_decode, stack_decoder_weights
from .encoders import Drop
from .layers import EPS, MultiHeadAttention, layer_norm, positional_rows


class DecoderLayer(nn.Module):
    """One decoder layer (self-attention, cross-attention, ReLU FF, three
    layernorms).  Serving runs its arithmetic in the fused kernel; the
    forward here is the teacher-forced pass (JAX ``dec_layer_full``)."""

    def __init__(self, E: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(E, num_heads)
        self.cross_attn = MultiHeadAttention(E, num_heads)
        self.linear1 = nn.Linear(E, ff_dim)
        self.linear2 = nn.Linear(ff_dim, E)
        self.norm1 = layer_norm(E)
        self.norm2 = layer_norm(E)
        self.norm3 = layer_norm(E)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor,
                drop: Drop) -> torch.Tensor:
        """x [B, T, E] targets, memory [B, Tm, E], additive causal mask [T, T]."""
        x = self.norm1(x + drop(self.self_attn(x, x, mask)))
        x = self.norm2(x + drop(self.cross_attn(x, memory)))
        f = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm3(x + drop(f))


class TransformerDecoder(nn.Module):
    def __init__(self, num_classes: int, d_model: int = 256, memory_dim: int = 512,
                 num_heads: int = 8, ff_dim: int = 2048, num_layers: int = 6,
                 max_text_length: int = 25, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.d_model, self.num_heads, self.num_layers = d_model, num_heads, num_layers
        self.max_text_length = max_text_length
        self.dtype = dtype
        self.use_kernels = True
        self._fused = {}  # dtype -> (parameter versions, cast weight tables)
        self.hid_to_emb = nn.Linear(memory_dim, d_model)
        self.emb = nn.Embedding(num_classes, d_model)
        self.emb_to_classes = nn.Linear(d_model, num_classes)
        self.final_norm = layer_norm(d_model)
        for i in range(num_layers):
            self.add_module(f"layer{i}", DecoderLayer(d_model, num_heads, ff_dim))

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def cross_kv(self, memory: torch.Tensor):
        """Per-layer cross-attention K/V over ``memory`` [B, Tm, E], stacked
        [L, B, Tm, E] float32."""
        ks, vs = [], []
        for layer in self.layers():
            a = layer.cross_attn
            _, k, v = qkv_projections(memory, memory, a.in_proj_weight, a.in_proj_bias)
            ks.append(k)
            vs.append(v)
        return torch.stack(ks), torch.stack(vs)

    def fused_weights(self, dtype: torch.dtype | None = None):
        """The stacked weight tables the fused decode takes, in ``dtype``
        (default: the compute type) on the parameters' device, positional
        rows float32.  Built on first use and kept until a parameter changes
        (its storage or its version), so a served call stacks and casts
        nothing."""
        dtype = dtype or self.dtype
        params = list(self.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params)
        hit = self._fused.get(dtype)
        if hit is None or hit[0] != key:
            T = self.max_text_length
            with torch.no_grad():
                pe = positional_rows(T + 1, self.d_model, params[0].device)[:T]
                w = cast_weights(stack_decoder_weights(
                    self.layers(), self.final_norm, self.emb_to_classes,
                    self.emb.weight, pe), dtype)
            hit = self._fused[dtype] = (key, w)
        return hit[1]

    def teacher_forced(self, enc_out: torch.Tensor, text: torch.Tensor,
                       drop: Drop) -> torch.Tensor:
        """Training pass: enc_out [B, Tm, memory_dim] float32, text [B, T]
        input ids (starting with [GO]) -> logits [B, T, C] float32."""
        memory = self.hid_to_emb(enc_out)
        T = text.shape[1]
        pe = positional_rows(self.max_text_length + 1, self.d_model, text.device)
        x = drop(self.emb(text) + pe[:T])
        mask = causal_mask(T, text.device)
        for layer in self.layers():
            x = layer(x, memory, mask, drop)
        return self.emb_to_classes(self.final_norm(x))

    def greedy_decode(self, enc_out: torch.Tensor) -> torch.Tensor:
        """enc_out [B, Tm, memory_dim] -> logits [B, max_text_length, C] f32."""
        ck, cv = self.cross_kv(self.hid_to_emb(enc_out))
        return fused_greedy_decode(
            self.fused_weights(), ck, cv, num_heads=self.num_heads,
            steps=self.max_text_length, dtype=self.dtype, go_id=GO_ID, eps=EPS,
            plain=not self.use_kernels)
