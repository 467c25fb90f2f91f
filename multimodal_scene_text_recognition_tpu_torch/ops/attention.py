"""Multi-head attention with a packed in-projection (JAX counterpart:
ops/attention.py).  Weights follow PyTorch's layout: ``in_proj_weight``
[3E, E] (q, k, v rows stacked), ``in_proj_bias`` [3E]."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def qkv_projections(q_in: torch.Tensor, kv_in: torch.Tensor,
                    in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project the query input and the key/value input with the packed
    weights; returns (q, k, v), each [..., E]."""
    E = q_in.shape[-1]
    w, b = in_proj_weight, in_proj_bias
    q = F.linear(q_in, w[:E], b[:E])
    k = F.linear(kv_in, w[E:2 * E], b[E:2 * E])
    v = F.linear(kv_in, w[2 * E:], b[2 * E:])
    return q, k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over projected q [B, Tq, E], k/v [B, Tk, E].

    ``mask`` is additive (0 = attend, -inf = blocked), broadcastable to
    [B, H, Tq, Tk].  Logits and softmax are float32.
    """
    B, Tq, E = q.shape
    Tk = k.shape[1]
    hd = E // num_heads

    def heads(x, T):
        return x.reshape(B, T, num_heads, hd).transpose(1, 2)

    logits = torch.matmul(heads(q, Tq).float(), heads(k, Tk).float().transpose(-1, -2))
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), heads(v, Tk).float()).to(q.dtype)
    return out.transpose(1, 2).reshape(B, Tq, E)


def causal_mask(T: int, device=None) -> torch.Tensor:
    """Additive causal mask [T, T] float32: 0 on and below the diagonal,
    -inf above."""
    blocked = torch.ones(T, T, dtype=torch.bool, device=device).triu(1)
    return torch.zeros(T, T, device=device).masked_fill(blocked, float("-inf"))
