"""Multi-head attention with a packed in-projection (JAX counterpart:
ops/attention.py, with its int8 route).  Weights follow PyTorch's layout:
``in_proj_weight`` [3E, E] (q, k, v rows stacked), ``in_proj_bias``
[3E]."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .int8 import int8_linear


def qkv_projections(q_in: torch.Tensor, kv_in: torch.Tensor,
                    in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
                    int8: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project the query input and the key/value input with the packed
    weights; returns (q, k, v), each [..., E].  ``int8`` runs the three
    projections through :func:`~.int8.int8_linear` (inference only), each
    result cast back to the query input's type."""
    E = q_in.shape[-1]
    w, b = in_proj_weight, in_proj_bias
    if int8:
        dt = q_in.dtype
        return tuple(int8_linear(x, w[i * E:(i + 1) * E].t(), b[i * E:(i + 1) * E]).to(dt)
                     for i, x in enumerate((q_in, kv_in, kv_in)))
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


def attend_ancestry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    anc_onehot: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Beam-search attention over unreordered per-beam caches.

    The caches stay in write order: slot j of a batch row's K slots holds
    what the beam occupying row j wrote at each position.  Each query scores
    all K slots, keeps per position the slot its ancestry names (contracted
    before the softmax) and takes the values the same way.

    q [B*K, 1, E] current queries in beam order; k, v [B*K, T, E] caches;
    ``anc_onehot`` [B, K, T, K] with [b, k, t, j] = 1 iff beam k's
    position-t entry lives in slot j; ``mask`` additive, broadcastable to
    [B, K, H, T].  Returns [B*K, 1, E], equal to :func:`attend` over
    physically reordered caches (one product selected per position).
    """
    BK, T, E = k.shape
    B, K = anc_onehot.shape[:2]
    hd = E // num_heads
    qh = q.reshape(B, K, num_heads, hd).float()
    kh = k.reshape(B, K, T, num_heads, hd).float()
    vh = v.reshape(B, K, T, num_heads, hd)
    s_all = torch.einsum("bkhd,bjthd->bkhjt", qh, kh) / math.sqrt(hd)
    sel = anc_onehot.float()
    s = torch.einsum("bkhjt,bktj->bkht", s_all, sel) + mask
    probs = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.einsum("bkht,bktj,bjthd->bkhd", probs.float(), sel, vh.float()).to(q.dtype)
    return out.reshape(BK, 1, E)


def attend_ancestry_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                         anc_onehot: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`attend_ancestry` as plain attention over the flattened (slot,
    position) axis of length K*T, with the (slot, position) pairs outside a
    beam's ancestry masked to -inf before the softmax; the same signature
    and result.  The cross-check of the select form."""
    BK, T, E = k.shape
    B, K = anc_onehot.shape[:2]
    hd = E // num_heads
    qh = q.reshape(B, K, num_heads, hd).float()
    kh = k.reshape(B, K * T, num_heads, hd).float()  # m = j * T + t
    vh = v.reshape(B, K * T, num_heads, hd)
    s = torch.einsum("bkhd,bmhd->bkhm", qh, kh) / math.sqrt(hd)
    allow = anc_onehot.transpose(2, 3).reshape(B, K, 1, K * T)
    causal = torch.broadcast_to(mask, mask.shape[:-1] + (T,)).repeat(
        (1,) * (mask.dim() - 1) + (K,))
    s = s.masked_fill(allow <= 0, float("-inf")) + causal
    probs = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.einsum("bkhm,bmhd->bkhd", probs.float(), vh.float()).to(q.dtype)
    return out.reshape(BK, 1, E)


def causal_mask(T: int, device=None) -> torch.Tensor:
    """Additive causal mask [T, T] float32: 0 on and below the diagonal,
    -inf above."""
    blocked = torch.ones(T, T, dtype=torch.bool, device=device).triu(1)
    return torch.zeros(T, T, device=device).masked_fill(blocked, float("-inf"))
