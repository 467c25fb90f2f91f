"""Transformer decoder (JAX counterpart: models/decoders.py
``TransformerDecoder``).

Serving: the memory projection ``hid_to_emb`` and the per-layer
cross-attention K/V run once in float32; the whole 25-step greedy loop is
one launch of the fused decode kernel (ops/fused_decode.py) in the compute
type, and with ``beam_fused`` the whole beam search one launch of the fused
beam kernel (ops/fused_beam.py).  Otherwise beam search runs the
single-position stepper over KV caches, as the JAX package's XLA path does.
Training: one teacher-forced causal pass in float32, as the JAX package
trains its decoder.  The decoder has no fusion sites (the JAX package's
``multihead_*`` options), and greedy decoding through the stepper is not
ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..charset import EOS_ID, GO_ID
from ..ops.attention import attend, attend_ancestry, causal_mask, qkv_projections
from ..ops.fused_beam import NEG, fused_beam_decode
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
                 max_text_length: int = 25, dtype: torch.dtype = torch.bfloat16,
                 early_stop: bool = False, beam_fused: bool = False):
        super().__init__()
        self.d_model, self.num_heads, self.num_layers = d_model, num_heads, num_layers
        self.max_text_length = max_text_length
        self.dtype = dtype
        self.early_stop, self.beam_fused = early_stop, beam_fused
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
        """enc_out [B, Tm, memory_dim] -> logits [B, max_text_length, C] f32.

        With ``early_stop`` a row stops once it has emitted [s], and its
        later logit rows are the [s] one-hot: [s]-pruned strings are those
        of the full-length loop."""
        ck, cv = self.cross_kv(self.hid_to_emb(enc_out))
        return fused_greedy_decode(
            self.fused_weights(), ck, cv, num_heads=self.num_heads,
            steps=self.max_text_length, dtype=self.dtype, go_id=GO_ID,
            eos_id=EOS_ID if self.early_stop else None, eps=EPS,
            plain=not self.use_kernels)

    def _make_stepper(self, memory: torch.Tensor):
        """Single-position decode machinery over ``memory`` [B', Tm, E] in
        the compute type (norm statistics and logits float32).

        Returns ``(step_all, make_caches)``: ``step_all(x [B', 1, E], t,
        caches, anc_onehot=None)`` runs every layer, the final norm and the
        class head for position t, writing the self-attention K/V of that
        position into ``caches`` (``make_caches()``: [L, B', T, E] K and V,
        zeroed) in place, and returns logits [B', C] float32.  With
        ``anc_onehot`` [B, K, T, K] the attention reads the caches through
        beam ancestry (:func:`~..ops.attention.attend_ancestry`).  The
        cross-attention K/V over ``memory`` are projected once per layer.
        """
        dt = self.dtype
        E, H, T, L = self.d_model, self.num_heads, self.max_text_length, self.num_layers
        memory = memory.to(dt)
        Bp = memory.shape[0]

        def cast(*ts):
            return [t.detach().to(dt) for t in ts]

        def linear(mod):
            return cast(mod.weight, mod.bias)

        layer_ws, cross_kv = [], []
        for layer in self.layers():
            sa, ca = layer.self_attn, layer.cross_attn
            w_in, b_in = cast(ca.in_proj_weight, ca.in_proj_bias)
            _, k, v = qkv_projections(memory, memory, w_in, b_in)
            cross_kv.append((k, v))
            layer_ws.append(dict(
                self_in=cast(sa.in_proj_weight, sa.in_proj_bias), self_out=linear(sa.out_proj),
                cross_q=(w_in[:E], b_in[:E]), cross_out=linear(ca.out_proj),
                ff1=linear(layer.linear1), ff2=linear(layer.linear2),
                norms=[linear(n) for n in (layer.norm1, layer.norm2, layer.norm3)]))
        final_norm, head = linear(self.final_norm), linear(self.emb_to_classes)
        pos = torch.arange(T, device=memory.device)

        def ln(x, w):
            return F.layer_norm(x.float(), (E,), w[0].float(), w[1].float(), EPS).to(x.dtype)

        def make_caches() -> Dict[str, torch.Tensor]:
            return {n: torch.zeros(L, Bp, T, E, dtype=dt, device=memory.device)
                    for n in ("k", "v")}

        def step_all(x, t, caches, anc_onehot=None):
            x = x.to(dt)
            mask = torch.zeros(T, device=x.device).masked_fill(pos > t, float("-inf"))
            for i, w in enumerate(layer_ws):
                q, k_t, v_t = qkv_projections(x, x, *w["self_in"])
                caches["k"][i, :, t] = k_t[:, 0]
                caches["v"][i, :, t] = v_t[:, 0]
                if anc_onehot is None:
                    a = attend(q, caches["k"][i], caches["v"][i], H, mask)
                else:
                    a = attend_ancestry(q, caches["k"][i], caches["v"][i], H, anc_onehot, mask)
                x = ln(x + F.linear(a, *w["self_out"]), w["norms"][0])
                a = attend(F.linear(x, *w["cross_q"]), *cross_kv[i], H)
                x = ln(x + F.linear(a, *w["cross_out"]), w["norms"][1])
                f = F.linear(torch.relu(F.linear(x, *w["ff1"])), *w["ff2"])
                x = ln(x + f, w["norms"][2])
            return F.linear(ln(x, final_norm), *head)[:, 0].float()

        return step_all, make_caches

    def beam_decode(self, enc_out: torch.Tensor, beam_size: int = 5,
                    length_penalty: float = 0.0, reorder_caches: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched beam search: enc_out [B, Tm, memory_dim] -> (tokens
        [B, max_text_length], scores [B]) of the best beam per row.

        Only beam 0 is live at step 0; a finished beam ([s] emitted)
        continues only with [s], at zero cost; the best K of the K*C
        continuations are kept, ties to the lowest flat index (JAX's
        ``lax.top_k``).  Three forms with the same result:

        * ``beam_fused`` (and not ``reorder_caches``): the fused beam kernel
          (ops/fused_beam.py), its plain version where ``use_kernels`` is
          off or on CPU tensors;
        * the ancestry scan (the default otherwise): the stepper over caches
          that are never reordered, attention through each beam's ancestry;
        * ``reorder_caches=True``: the stepper with the caches gathered by
          beam origin every step.

        With ``early_stop`` the search ends once every beam has finished;
        tokens up to each beam's first [s] and the scores are those of the
        full-length search.  ``length_penalty`` > 0 ranks the beams by
        GNMT-normalised scores (:meth:`rank_beams`).
        """
        memory = self.hid_to_emb(enc_out)
        B, K, T = memory.shape[0], beam_size, self.max_text_length
        if self.beam_fused and not reorder_caches:
            ck, cv = self.cross_kv(memory)
            tokens, scores = fused_beam_decode(
                self.fused_weights(), ck, cv, beam_size=K, num_heads=self.num_heads,
                steps=T, dtype=self.dtype, go_id=GO_ID, eos_id=EOS_ID, eps=EPS,
                early_stop=self.early_stop, plain=not self.use_kernels)
            return self.rank_beams(tokens, scores, length_penalty)

        dev = memory.device
        C = self.emb.num_embeddings
        step_all, make_caches = self._make_stepper(memory.repeat_interleave(K, dim=0))
        caches = make_caches()
        pe = positional_rows(T + 1, self.d_model, dev)
        tok = torch.full((B, K), GO_ID, dtype=torch.long, device=dev)
        scores = torch.full((B, K), NEG, device=dev)
        scores[:, 0] = 0.0  # only beam 0 live at step 0
        finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
        seqs = torch.zeros(B, K, T, dtype=torch.long, device=dev)
        anc = torch.zeros(B, K, T, dtype=torch.long, device=dev)  # cache slot per position
        frozen = torch.full((C,), NEG, device=dev)
        frozen[EOS_ID] = 0.0
        for t in range(T):
            if self.early_stop and finished.all():
                break
            x = self.emb.weight[tok.reshape(-1)][:, None] + pe[t]
            if reorder_caches:
                logits = step_all(x, t, caches)
            else:
                anc[:, :, t] = torch.arange(K, device=dev)  # beam k writes slot k
                logits = step_all(x, t, caches, F.one_hot(anc, K).float())
            logp = torch.log_softmax(logits, dim=-1).reshape(B, K, C)
            logp = torch.where(finished[..., None], frozen, logp)
            # top-K, equal values in index order (lax.top_k's; torch.topk
            # promises no order)
            ranked, order = torch.sort((scores[..., None] + logp).reshape(B, K * C), dim=-1,
                                       descending=True, stable=True)
            scores, flat_idx = ranked[:, :K], order[:, :K]
            beam_idx, tok = flat_idx // C, flat_idx % C
            if reorder_caches:
                for name, c in caches.items():
                    idx = beam_idx.reshape(1, B, K, 1, 1).expand(c.shape[0], B, K, *c.shape[2:])
                    caches[name] = c.reshape(c.shape[0], B, K, *c.shape[2:]).gather(
                        2, idx).reshape(c.shape)
            else:
                anc = anc.gather(1, beam_idx[..., None].expand(B, K, T))
            finished = finished.gather(1, beam_idx) | (tok == EOS_ID)
            seqs = seqs.gather(1, beam_idx[..., None].expand(B, K, T))
            seqs[:, :, t] = tok
        return self.rank_beams(seqs, scores, length_penalty)

    @staticmethod
    def rank_beams(seqs: torch.Tensor, scores: torch.Tensor, length_penalty: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The best of K beams per row: seqs [B, K, T], raw cumulative
        log-probabilities [B, K] -> (tokens [B, T], scores [B]).  With
        ``length_penalty`` > 0 the scores are divided by the GNMT factor
        ``((5 + length) / 6) ** length_penalty``, length counting the
        tokens before the first [s] plus one (JAX ``_rank_beams``)."""
        if length_penalty > 0.0:
            lengths = torch.cumprod((seqs != EOS_ID).long(), dim=-1).sum(-1).float() + 1.0
            ranked = scores / ((5.0 + lengths) / 6.0) ** length_penalty
        else:
            ranked = scores
        best = torch.argmax(ranked, dim=1)  # first index of the maximum
        rows = torch.arange(seqs.shape[0], device=seqs.device)
        return seqs[rows, best], ranked[rows, best]
