"""The decoders (JAX counterpart: models/decoders.py): the transformer
decoder, and the classic recognizers' LSTM-attention decoder and per-column
linear decoder (at the end of the module).

Serving: the memory projection ``hid_to_emb`` and the per-layer
cross-attention K/V run once in float32; with ``fused`` the whole 25-step
greedy loop is one launch of the fused decode kernel (ops/fused_decode.py)
in the compute type (with ``int8`` its six projections int8, K1q), and with
``beam_fused`` the whole beam search one launch of the fused beam kernel
(ops/fused_beam.py), in float in every mode (as in the JAX package).
Otherwise greedy decoding and beam search run the single-position stepper
over KV caches, as the JAX package's XLA path does; so do both whenever a
per-layer fusion site is on (the kernels carry none), and ``int8`` is then
ignored, as in JAX.  Training: one teacher-forced causal pass in float32,
as the JAX package trains its decoder.

The semantic fusion hooks run in float32 around the loops:
``pre_decoder_mlp`` fuses the semantics into the memory
(:meth:`TransformerDecoder.memory`), ``cls_decoder_init`` replaces the
[GO] embedding at step 0 by the semantic CLS vector (:meth:`sem_cls`, the
kernels' ``cls0`` row), and ``post_decoder_mlp`` fuses them into the
greedy logits (:meth:`post_decoder`; beam search refuses it, as the JAX
package does).  The per-layer fusion sites (``sites``, the JAX package's
``multihead_pre_target``, ``multihead_pre_memory`` and
``multihead_post_memory``) each add the causal attention of the stream
over its relevance-weighted semantics inside every layer
(:meth:`DecoderLayer.fusion`); the stepper keeps their K/V rows in caches
of their own.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..charset import EOS_ID, GO_ID
from ..ops.attention import attend, attend_ancestry, causal_mask, qkv_projections
from ..ops.fused_beam import NEG, fused_beam_decode
from ..ops.fused_decode import (cast_weights, fused_greedy_decode, pack_cluster_tables,
                                pack_cluster_tables_int8,
                                quantize_fused_weights, stack_decoder_weights)
from .encoders import Drop
from .layers import EPS, FusionMLP, MultiHeadAttention, feed_forward, layer_norm, \
    positional_rows, relevance_fusion


SITES = ("pre_target", "pre_memory", "post_memory")  # the per-layer fusion sites, in order


class DecoderLayer(nn.Module):
    """One decoder layer (self-attention, cross-attention, ReLU FF, three
    layernorms) and, for each fusion site in ``sites``, an attention
    ``mha_<site>`` and a relevance MLP ``mlp_<site>`` (2E -> E -> E -> 1).
    Serving runs its arithmetic in the fused kernel or the stepper; the
    forward here is the teacher-forced pass (JAX ``dec_layer_full``)."""

    def __init__(self, E: int, num_heads: int, ff_dim: int, sites: Sequence[str] = ()):
        super().__init__()
        self.self_attn = MultiHeadAttention(E, num_heads)
        self.cross_attn = MultiHeadAttention(E, num_heads)
        self.linear1 = nn.Linear(E, ff_dim)
        self.linear2 = nn.Linear(ff_dim, E)
        self.norm1 = layer_norm(E)
        self.norm2 = layer_norm(E)
        self.norm3 = layer_norm(E)
        unknown = set(sites) - set(SITES)
        if unknown:
            raise ValueError(f"unknown fusion sites {sorted(unknown)} (sites are {SITES})")
        self.sites = tuple(s for s in SITES if s in sites)
        for site in self.sites:
            self.add_module(f"mha_{site}", MultiHeadAttention(E, num_heads))
            self.add_module(f"mlp_{site}", FusionMLP(2 * E, E, 1, 3))

    def fusion(self, site: str, x: torch.Tensor, sem: torch.Tensor, mask: torch.Tensor,
               drop: Drop) -> torch.Tensor:
        """Fusion site ``site``: x plus the causal attention of x over its
        relevance-weighted semantics, the site's dropout applied twice (JAX
        ``dec_layer_full``'s ``fusion``; causal where the reference's site
        could not run, so that the stepper equals this pass)."""
        rel = relevance_fusion(x, sem, getattr(self, f"mlp_{site}"))
        return drop(x + drop(getattr(self, f"mha_{site}")(x, rel, mask)))

    def forward(self, x: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor,
                drop: Drop, sem: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, E] targets, memory [B, Tm, E], additive causal mask
        [T, T], the semantic vectors [B, O, E] the fusion sites read."""
        if "pre_target" in self.sites:
            x = self.fusion("pre_target", x, sem, mask, drop)
        x = self.norm1(x + drop(self.self_attn(x, x, mask)))
        if "pre_memory" in self.sites:
            x = self.fusion("pre_memory", x, sem, mask, drop)
        x = self.norm2(x + drop(self.cross_attn(x, memory)))
        if "post_memory" in self.sites:
            x = self.fusion("post_memory", x, sem, mask, drop)
        f = feed_forward(self.linear1, self.linear2, torch.relu, x, drop)
        return self.norm3(x + drop(f))


class TransformerDecoder(nn.Module):
    def __init__(self, num_classes: int, d_model: int = 256, memory_dim: int = 512,
                 num_heads: int = 8, ff_dim: int = 2048, num_layers: int = 6,
                 max_text_length: int = 25, dtype: torch.dtype = torch.bfloat16,
                 early_stop: bool = False, beam_fused: bool = False, int8: bool = False,
                 pre_decoder_mlp: bool = False, cls_decoder_init: bool = False,
                 post_decoder_mlp: bool = False, fused: bool = True,
                 sites: Sequence[str] = ()):
        super().__init__()
        self.d_model, self.num_heads, self.num_layers = d_model, num_heads, num_layers
        self.max_text_length = max_text_length
        self.dtype = dtype
        self.early_stop, self.beam_fused, self.int8 = early_stop, beam_fused, int8
        self.fused = fused
        self.use_kernels = True
        self.intermediates: Optional[dict] = None
        # (dtype, int8) -> (parameter versions, cast weight tables and, for
        # int8, their scales); (dtype, "cluster", int8) -> (versions, the
        # cluster kernel's units: K1's, or with int8 K1q's)
        self._fused = {}
        self.hid_to_emb = nn.Linear(memory_dim, d_model)
        self.emb = nn.Embedding(num_classes, d_model)
        self.emb_to_classes = nn.Linear(d_model, num_classes)
        self.final_norm = layer_norm(d_model)
        for i in range(num_layers):
            self.add_module(f"layer{i}", DecoderLayer(d_model, num_heads, ff_dim, sites))
        self.sites = tuple(s for s in SITES if s in sites)
        E, C = d_model, num_classes
        self.pre_decoder_mlp = pre_decoder_mlp
        self.cls_decoder_init = cls_decoder_init
        self.post_decoder_mlp = post_decoder_mlp
        if pre_decoder_mlp:
            self.relevant_mlp = FusionMLP(2 * E, E, 1, 3)
            self.combine_mlp = FusionMLP(2 * E, E, E, 2)
        if cls_decoder_init:
            self.sem_cls_mlp = FusionMLP(2 * E, E, 1, 3)
        if post_decoder_mlp:
            self.post_mlp = FusionMLP(2 * C, C, 1, 3)
            self.post_combine_mlp = FusionMLP(2 * C, C, C, 3)
            self.sem_to_classes = nn.Linear(E, C)

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

    def fused_weights(self, dtype: torch.dtype | None = None, int8: bool = False):
        """The stacked weight tables the fused decode takes, in ``dtype``
        (default: the compute type) on the parameters' device, positional
        rows float32.  With ``int8`` returns ``(tables, scales)``: the six
        projection tables int8 in K1q's layout (packed here, once),
        quantized from the float32 parameters (as
        the JAX package does before it casts; quantizing the cast tables
        would give other int8 values), the others cast.  Built on first use
        and kept until a parameter changes (its storage or its version), so
        a served call stacks, quantizes and casts nothing."""
        dtype = dtype or self.dtype
        params = list(self.parameters())
        key = self._versions()
        hit = self._fused.get((dtype, int8))
        if hit is None or hit[0] != key:
            T = self.max_text_length
            with torch.no_grad():
                pe = positional_rows(T + 1, self.d_model, params[0].device)[:T]
                w = stack_decoder_weights(self.layers(), self.final_norm, self.emb_to_classes,
                                          self.emb.weight, pe)
                if int8:
                    w, scales = quantize_fused_weights(w)
                    w = (cast_weights(w, dtype), scales)
                else:
                    w = cast_weights(w, dtype)
            hit = self._fused[dtype, int8] = (key, w)
        return hit[1]

    def _versions(self):
        return tuple((p.data_ptr(), p._version) for p in self.parameters())

    def cluster_tables(self, dtype: torch.dtype | None = None, int8: bool = False) -> torch.Tensor:
        """The tables of :meth:`fused_weights` in ``dtype`` repacked once
        for the cluster kernel: the float ones for K1
        (``ops.fused_decode.pack_cluster_tables``), or with ``int8`` the
        int8 ones and the class head for K1q
        (``ops.fused_decode.pack_cluster_tables_int8``); kept as those are."""
        dtype = dtype or self.dtype
        key = self._versions()
        hit = self._fused.get((dtype, "cluster", int8))
        if hit is None or hit[0] != key:
            with torch.no_grad():
                if int8:
                    packed = pack_cluster_tables_int8(self.fused_weights(dtype, int8=True)[0],
                                                      self.num_heads)
                else:
                    packed = pack_cluster_tables(self.fused_weights(dtype), self.num_heads)
            hit = self._fused[dtype, "cluster", int8] = (key, packed)
        return hit[1]

    def teacher_forced(self, enc_out: torch.Tensor, text: torch.Tensor, drop: Drop,
                       semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Training pass (JAX ``__call__`` with ``train=True``): enc_out
        [B, Tm, memory_dim] float32, text [B, T] input ids (starting with
        [GO]) and the semantic vectors [B, O, E] the fusion hooks read ->
        logits [B, T, C] float32.  With ``cls_decoder_init`` position 0
        takes the semantic CLS vector in place of the [GO] embedding, before
        the positional rows and the dropout."""
        memory = self.memory(enc_out, semantics)
        T = text.shape[1]
        x = self.emb(text)
        if self.cls_decoder_init:
            x = torch.cat([self.sem_cls(memory, semantics)[:, None], x[:, 1:]], dim=1)
        pe = positional_rows(self.max_text_length + 1, self.d_model, text.device)
        x = drop(x + pe[:T])
        mask = causal_mask(T, text.device)
        for layer in self.layers():
            x = layer(x, memory, mask, drop, semantics)
        logits = self.emb_to_classes(self.final_norm(x))
        return self.post_decoder(logits, semantics) if self.post_decoder_mlp else logits

    def memory(self, enc_out: torch.Tensor,
               semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The memory the decoder attends to (JAX ``_memory``):
        ``hid_to_emb`` of enc_out [B, Tm, memory_dim] -> [B, Tm, E] float32,
        with ``pre_decoder_mlp`` plus ``combine_mlp`` of it beside its
        relevance-weighted semantics [B, O, E]; its relevance softmax
        [B, Tm, O] is kept under ``pre_decoder_scores`` in ``intermediates``
        while that is a dict (``eval/attention.py``)."""
        memory = self.hid_to_emb(enc_out)
        if not self.pre_decoder_mlp:
            return memory
        rel, scores = relevance_fusion(memory, semantics, self.relevant_mlp,
                                       return_scores=True)
        if self.intermediates is not None:
            self.intermediates["pre_decoder_scores"] = scores.detach()
        return memory + self.combine_mlp(torch.cat([memory, rel], dim=-1))

    def sem_cls(self, memory: torch.Tensor, semantics: torch.Tensor) -> torch.Tensor:
        """The semantic CLS vector [B, E] float32, the step-0 input with
        ``cls_decoder_init`` (JAX ``_sem_cls``): the relevance-weighted
        semantics of each memory position, softmaxed over the positions and
        summed over them.  As written in the JAX package (and the reference
        model it copies), the sum is over the softmax's own axis, so every
        element is 1 up to float32 rounding whatever ``sem_cls_mlp`` holds."""
        rel = relevance_fusion(memory, semantics, self.sem_cls_mlp)
        return torch.softmax(rel, dim=1).sum(dim=1)

    def post_decoder(self, logits: torch.Tensor, semantics: torch.Tensor) -> torch.Tensor:
        """Logit-space fusion with ``post_decoder_mlp`` (JAX
        ``_post_decoder``): logits [B, T, C] plus ``post_combine_mlp`` of
        them beside the relevance-weighted semantics mapped to classes."""
        sem_c = self.sem_to_classes(semantics)
        rel = relevance_fusion(logits, sem_c, self.post_mlp)
        return logits + self.post_combine_mlp(torch.cat([logits, rel], dim=-1))

    def memory_and_cls0(self, enc_out: torch.Tensor, semantics: Optional[torch.Tensor]):
        """The memory and, with ``cls_decoder_init``, the step-0 rows (else
        None)."""
        memory = self.memory(enc_out, semantics)
        return memory, self.sem_cls(memory, semantics) if self.cls_decoder_init else None

    @property
    def uses_stepper(self) -> bool:
        """Whether greedy decoding runs the stepper (``fused`` off, or a
        fusion site on) rather than the fused decode (K1, K1e, K1q)."""
        return not self.fused or bool(self.sites)

    def greedy_decode(self, enc_out: torch.Tensor,
                      semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """enc_out [B, Tm, memory_dim] (and the semantic vectors [B, O, E]
        the fusion hooks read) -> logits [B, max_text_length, C] f32.

        With ``early_stop`` the fused decode stops a row once it has
        emitted [s] (K1e: a cluster of rows once all of its rows have), the
        stepper the batch once every row has; the logit rows after the stop
        are the [s] one-hot, so [s]-pruned strings are those of the
        full-length loop.  With ``int8`` the fused loop's six projections
        run int8 (K1q)."""
        logits = self.greedy_from_memory(*self.memory_and_cls0(enc_out, semantics), semantics)
        return self.post_decoder(logits, semantics) if self.post_decoder_mlp else logits

    def greedy_from_memory(self, memory: torch.Tensor, cls0: Optional[torch.Tensor] = None,
                           semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The greedy loop over ``memory`` [B, Tm, E] (from :meth:`memory`),
        with step-0 rows ``cls0`` [B, E] where given: the stepper where
        :attr:`uses_stepper` (the fusion sites read ``semantics``), else the
        cross-attention K/V, then the fused decode (K1, K1e or K1q)."""
        if self.uses_stepper:
            return self.greedy_stepper(memory, cls0, semantics)
        ck, cv = self.cross_kv(memory)
        w, scales = self.fused_weights(int8=True) if self.int8 else (self.fused_weights(), None)
        return fused_greedy_decode(
            w, ck, cv, num_heads=self.num_heads,
            steps=self.max_text_length, dtype=self.dtype, go_id=GO_ID,
            eos_id=EOS_ID if self.early_stop else None, eps=EPS,
            plain=not self.use_kernels, scales=scales, cls0=cls0, units=self.cluster_tables)

    def greedy_stepper(self, memory: torch.Tensor, cls0: Optional[torch.Tensor] = None,
                       semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The greedy loop one position at a time through the stepper (JAX
        ``greedy_decode``'s scan, or with ``early_stop`` its while loop):
        argmax feedback, ``cls0`` in place of the [GO] embedding at step 0.
        With ``early_stop`` the loop ends once every row has emitted [s]
        (one host sync a step), and the rows never written are the [s]
        one-hot.  -> logits [B, max_text_length, C] float32."""
        B, T, C = memory.shape[0], self.max_text_length, self.emb.num_embeddings
        dev = memory.device
        step_all, make_caches = self._make_stepper(memory, semantics)
        caches = make_caches()
        pe = positional_rows(T + 1, self.d_model, dev)
        logits = torch.zeros(B, T, C, device=dev)
        logits[..., EOS_ID] = 1.0
        tok = torch.full((B,), GO_ID, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for t in range(T):
            if self.early_stop and done.all():
                break
            x = cls0[:, None] if t == 0 and cls0 is not None else self.emb.weight[tok][:, None]
            logits[:, t] = step_all(x + pe[t], t, caches)
            tok = logits[:, t].argmax(-1)
            done |= tok == EOS_ID
        return logits

    def _make_stepper(self, memory: torch.Tensor, sem: Optional[torch.Tensor] = None):
        """Single-position decode machinery over ``memory`` [B', Tm, E] and
        the semantic vectors ``sem`` [B', O, E] the fusion sites read, in
        the compute type (norm statistics and logits float32), as JAX's
        ``_make_stepper`` casts them.

        Returns ``(step_all, make_caches)``: ``step_all(x [B', 1, E], t,
        caches, anc_onehot=None)`` runs every layer, the final norm and the
        class head for position t, writing the K/V of that position into
        ``caches`` (``make_caches()``: [L, B', T, E], zeroed: ``k`` and
        ``v`` of the self-attention, ``<site>_k`` and ``<site>_v`` of each
        fusion site) in place, and returns logits [B', C] float32.  With
        ``anc_onehot`` [B, K, T, K] every cached attention reads its caches
        through beam ancestry (:func:`~..ops.attention.attend_ancestry`).
        The cross-attention K/V over ``memory`` are projected once per
        layer.  A fusion site attends from the position's row over the
        cached projections of its relevance-weighted semantics
        (:meth:`_relevance`), and adds the result to the row.
        """
        dt = self.dtype
        E, H, T, L = self.d_model, self.num_heads, self.max_text_length, self.num_layers
        memory = memory.to(dt)
        sem = None if sem is None else sem.to(dt)
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
            sites = {}
            for site in layer.sites:
                mha, mlp = getattr(layer, f"mha_{site}"), getattr(layer, f"mlp_{site}")
                sites[site] = dict(qkv=cast(mha.in_proj_weight, mha.in_proj_bias),
                                   out=linear(mha.out_proj),
                                   mlp=[linear(getattr(mlp, f"fc{j}"))
                                        for j in range(mlp.num_layers)])
            layer_ws.append(dict(
                self_in=cast(sa.in_proj_weight, sa.in_proj_bias), self_out=linear(sa.out_proj),
                cross_q=(w_in[:E], b_in[:E]), cross_out=linear(ca.out_proj),
                ff1=linear(layer.linear1), ff2=linear(layer.linear2),
                norms=[linear(n) for n in (layer.norm1, layer.norm2, layer.norm3)], sites=sites))
        final_norm, head = linear(self.final_norm), linear(self.emb_to_classes)
        pos = torch.arange(T, device=memory.device)

        def ln(x, w):
            return F.layer_norm(x.float(), (E,), w[0].float(), w[1].float(), EPS).to(x.dtype)

        def make_caches() -> Dict[str, torch.Tensor]:
            names = ["k", "v"] + [f"{site}_{kv}" for site in self.sites for kv in "kv"]
            return {n: torch.zeros(L, Bp, T, E, dtype=dt, device=memory.device) for n in names}

        def cached_attend(x, src, qkv, out, prefix, i, t, caches, anc_onehot, mask):
            """x's attention over the cached projections of ``src`` (its
            position-t row written into the caches ``<prefix>k``/``v``)."""
            q, k_t, v_t = qkv_projections(x, src, *qkv)
            k, v = caches[prefix + "k"][i], caches[prefix + "v"][i]
            k[:, t] = k_t[:, 0]
            v[:, t] = v_t[:, 0]
            if anc_onehot is None:
                a = attend(q, k, v, H, mask)
            else:
                a = attend_ancestry(q, k, v, H, anc_onehot, mask)
            return F.linear(a, *out)

        def fusion(x, site, i, *at):
            """Fusion site ``site`` of layer i: x plus x's cached attention
            over its relevance-weighted semantics."""
            s = layer_ws[i]["sites"][site]
            rel = self._relevance(x, sem, s["mlp"])
            return x + cached_attend(x, rel, s["qkv"], s["out"], f"{site}_", i, *at)

        def step_all(x, t, caches, anc_onehot=None):
            x = x.to(dt)
            mask = torch.zeros(T, device=x.device).masked_fill(pos > t, float("-inf"))
            for i, w in enumerate(layer_ws):
                at = (t, caches, anc_onehot, mask)
                if "pre_target" in w["sites"]:
                    x = fusion(x, "pre_target", i, *at)
                a = cached_attend(x, x, w["self_in"], w["self_out"], "", i, *at)
                x = ln(x + a, w["norms"][0])
                if "pre_memory" in w["sites"]:
                    x = fusion(x, "pre_memory", i, *at)
                a = attend(F.linear(x, *w["cross_q"]), *cross_kv[i], H)
                x = ln(x + F.linear(a, *w["cross_out"]), w["norms"][1])
                if "post_memory" in w["sites"]:
                    x = fusion(x, "post_memory", i, *at)
                f = F.linear(torch.relu(F.linear(x, *w["ff1"])), *w["ff2"])
                x = ln(x + f, w["norms"][2])
            return F.linear(ln(x, final_norm), *head)[:, 0].float()

        return step_all, make_caches

    @staticmethod
    def _relevance(x: torch.Tensor, sem: torch.Tensor, mlp) -> torch.Tensor:
        """JAX ``_relevance`` in x's type, as the stepper runs it: x
        [B', 1, E] rows, sem [B', O, E], ``mlp`` the relevance MLP's
        (weight, bias) pairs -> [B', 1, E].  The pair tensor [B', 1, O, 2E]
        is formed whole (one product of its first layer, where
        :func:`~.layers.relevance_fusion` splits it), the softmax over the
        objects and the weighted sum in x's type."""
        Bp, O = x.shape[0], sem.shape[1]
        h = torch.cat([x[:, :, None].expand(Bp, 1, O, x.shape[-1]),
                       sem[:, None].expand(Bp, 1, O, sem.shape[-1])], dim=-1)
        for j, w in enumerate(mlp):
            h = F.linear(torch.relu(h) if j else h, *w)
        scores = torch.softmax(h, dim=2)  # [B', 1, O, 1]
        return (sem[:, None] * scores).sum(dim=2)

    def beam_decode(self, enc_out: torch.Tensor, semantics: Optional[torch.Tensor] = None,
                    beam_size: int = 5, length_penalty: float = 0.0,
                    reorder_caches: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched beam search: enc_out [B, Tm, memory_dim] (and the
        semantic vectors [B, O, E] the fusion hooks read) -> (tokens
        [B, max_text_length], scores [B]) of the best beam per row.

        Only beam 0 is live at step 0; a finished beam ([s] emitted)
        continues only with [s], at zero cost; the best K of the K*C
        continuations are kept, ties to the lowest flat index (JAX's
        ``lax.top_k``).  Three forms with the same result:

        * ``beam_fused`` (and not ``reorder_caches``, and no fusion site
          on): the fused beam kernel (ops/fused_beam.py), its plain version
          where ``use_kernels`` is off or on CPU tensors;
        * the ancestry scan (the default otherwise): the stepper over caches
          that are never reordered, attention through each beam's ancestry;
        * ``reorder_caches=True``: the stepper with the caches gathered by
          beam origin every step.

        With ``early_stop`` the search ends once every beam has finished;
        tokens up to each beam's first [s] and the scores are those of the
        full-length search.  ``length_penalty`` > 0 ranks the beams by
        GNMT-normalised scores (:meth:`rank_beams`).  With
        ``cls_decoder_init`` every beam starts from its row's semantic CLS
        vector; the fusion sites' caches follow the beams as the
        self-attention's do.  ``post_decoder_mlp`` raises: its logit fusion is a
        whole-sequence transform that per-step beam scores cannot take.
        """
        if self.post_decoder_mlp:
            raise NotImplementedError(
                "beam_decode does not support post_decoder_mlp (its logit fusion is a "
                "whole-sequence transform applied after decoding); use greedy decoding")
        return self.beam_from_memory(*self.memory_and_cls0(enc_out, semantics), beam_size,
                                     length_penalty, reorder_caches, semantics)

    def beam_from_memory(self, memory: torch.Tensor, cls0: Optional[torch.Tensor] = None,
                         beam_size: int = 5, length_penalty: float = 0.0,
                         reorder_caches: bool = False,
                         semantics: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`beam_decode` over ``memory`` [B, Tm, E] (from
        :meth:`memory`), with step-0 rows ``cls0`` [B, E] where given, and
        the semantic vectors [B, O, E] the fusion sites read."""
        B, K, T = memory.shape[0], beam_size, self.max_text_length
        if self.beam_fused and not reorder_caches and not self.sites:
            ck, cv = self.cross_kv(memory)
            tokens, scores = fused_beam_decode(
                self.fused_weights(), ck, cv, beam_size=K, num_heads=self.num_heads,
                steps=T, dtype=self.dtype, go_id=GO_ID, eos_id=EOS_ID, eps=EPS,
                early_stop=self.early_stop, plain=not self.use_kernels, cls0=cls0)
            return self.rank_beams(tokens, scores, length_penalty)

        dev = memory.device
        C = self.emb.num_embeddings
        step_all, make_caches = self._make_stepper(
            memory.repeat_interleave(K, dim=0),
            None if semantics is None else semantics.repeat_interleave(K, dim=0))
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
            if t == 0 and cls0 is not None:  # every beam of a row from its cls0
                x = cls0.repeat_interleave(K, dim=0)[:, None] + pe[0]
            else:
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


class LSTMAttentionDecoder(nn.Module):
    """The additive-attention LSTM decoder (JAX ``LSTMAttentionDecoder``).

    Each step scores the memory by ``score(tanh(i2h(memory) + h2h(h)))``,
    softmaxes the scores over the memory's positions, and feeds the cell
    the context beside the one-hot of the previous class, ``[context ;
    one_hot(prev)]`` in that order (``w_ih`` [4H, I + C], ``w_hh`` [4H, H],
    ``b_ih``, ``b_hh``: torch's layout, gates i, f, g, o); ``generator``
    maps h to the class logits.  h and c start at zero.  Everything runs in
    float32.  It has no dropout, fusion hook, early stop, kernel or beam
    search, as in the JAX package."""

    def __init__(self, num_classes: int, input_dim: int = 256, hidden_dim: int = 256,
                 max_text_length: int = 25):
        super().__init__()
        I, H, C = input_dim, hidden_dim, num_classes
        self.num_classes, self.max_text_length = C, max_text_length
        self.i2h = nn.Linear(I, H, bias=False)
        self.h2h = nn.Linear(H, H)
        self.score = nn.Linear(H, 1, bias=False)
        self.w_ih = nn.Parameter(torch.empty(4 * H, I + C))
        self.w_hh = nn.Parameter(torch.empty(4 * H, H))
        self.b_ih = nn.Parameter(torch.empty(4 * H))
        self.b_hh = nn.Parameter(torch.empty(4 * H))
        self.generator = nn.Linear(H, C)

    def _start(self, enc_out: torch.Tensor):
        """enc_out as float32, its projection ``i2h`` (once for every
        step), and the zero h and c."""
        enc_out = enc_out.float()
        h = enc_out.new_zeros(enc_out.shape[0], self.w_hh.shape[1])
        return enc_out, self.i2h(enc_out), h, h

    def _step(self, enc_out, proj_mem, h, c, onehot):
        """One step: attend over the memory with h, then the cell on
        ``[context ; onehot]`` -> (h, c)."""
        e = self.score(torch.tanh(proj_mem + self.h2h(h)[:, None]))  # [B, Tm, 1]
        context = (torch.softmax(e, dim=1) * enc_out).sum(dim=1)
        # gates i, f, g, o from both biases, as JAX's lstm_cell; on the card
        # the nonlinearities and the state update are one fused launch
        return torch.lstm_cell(torch.cat([context, onehot], dim=-1), (h, c), self.w_ih,
                               self.w_hh, self.b_ih, self.b_hh)

    def teacher_forced(self, enc_out: torch.Tensor, text: torch.Tensor, drop: Drop = None,
                       semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """enc_out [B, Tm, I], text [B, T] input ids (from [GO]) -> logits
        [B, T, C] float32, step t fed the one-hot of ``text[:, t]``;
        ``drop`` and ``semantics`` are ignored."""
        enc_out, proj_mem, h, c = self._start(enc_out)
        onehots = F.one_hot(text.long(), self.num_classes).float()
        hidden = []
        for t in range(text.shape[1]):
            h, c = self._step(enc_out, proj_mem, h, c, onehots[:, t])
            hidden.append(h)
        return self.generator(torch.stack(hidden, dim=1))

    def greedy_decode(self, enc_out: torch.Tensor,
                      semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """enc_out [B, Tm, I] -> logits [B, max_text_length + 1, C] float32
        (one step more than the transformer decoder's, for [s]), step 0
        fed [GO] and each later step the previous one's argmax."""
        enc_out, proj_mem, h, c = self._start(enc_out)
        prev = torch.full((enc_out.shape[0],), GO_ID, dtype=torch.long, device=enc_out.device)
        logits = []
        for _ in range(self.max_text_length + 1):
            h, c = self._step(enc_out, proj_mem, h, c, F.one_hot(prev, self.num_classes).float())
            logits.append(self.generator(h))
            prev = logits[-1].argmax(dim=-1)
        return torch.stack(logits, dim=1)

    def beam_decode(self, *args, **kwargs):
        raise NotImplementedError("beam decode requires the TF decoder")


class LinearDecoder(nn.Module):
    """Per-column class logits, ``head`` of each encoder column (JAX
    ``LinearDecoder``): [B, Tm, in_dim] -> [B, Tm, C] float32, in training
    and serving alike; the CTC recipe's decoder."""

    def __init__(self, num_classes: int, in_dim: int = 512):
        super().__init__()
        self.head = nn.Linear(in_dim, num_classes)

    def greedy_decode(self, enc_out: torch.Tensor,
                      semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head(enc_out.float())

    def teacher_forced(self, enc_out: torch.Tensor, text: torch.Tensor, drop: Drop = None,
                       semantics: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The columns' logits; ``text``, ``drop`` and ``semantics`` are
        ignored."""
        return self.head(enc_out.float())

    def beam_decode(self, *args, **kwargs):
        raise NotImplementedError("beam decode requires the TF decoder")
