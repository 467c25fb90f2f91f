"""Whole beam search in one kernel (JAX counterpart: ops/fused_beam.py,
without the CLS step-0 row).

Two versions of one function, ``(tokens [B, K, T] int32, scores [B, K]
float32)`` with the K beams of each row best first, from the stacked
decoder weights (``ops.fused_decode.FusedDecodeWeights``) and the per-layer
cross-attention K/V of the unexpanded batch (the K beams of a row share
one copy):

* :func:`fused_beam_decode_plain`, a PyTorch loop with the TPU kernel's
  exact casts.  The CPU path and the oracle of the kernel.
* :func:`fused_beam_decode_cuda`, the CUDA kernel ``kernels/fused_beam.cu``,
  which replaces the TPU kernel ``ops/fused_beam.py::_beam_kernel``.

:func:`fused_beam_decode` casts the weights to the compute type and picks
by device: the plain version for CPU tensors, the kernel for CUDA tensors.

The search, per batch row: only beam 0 is live at step 0 (the others start
at -1e9); each step embeds every beam's previous token, runs the decoder
layers over caches that are never reordered (beam k writes slot k, and an
ancestry map says which slot holds each position of each beam's history),
takes an f32 log-softmax, lets a finished beam continue only with
``eos_id`` at zero cost, keeps the best K of the K*C continuations (ties to
the lowest flat index ``k * C + c``, as ``lax.top_k``), and folds the
parents' ancestry, tokens and finished flags into the new beams.  With
``early_stop`` a row stops once all its beams have finished; its later
token positions stay 0 and its scores are those of the full-length search
(a finished beam adds 0).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .fused_decode import (SMEM_LIMIT, THREADS, FusedDecodeWeights, cast_weights,
                           check_kernel_inputs, launch, launcher, plain_ops)

NEG = -1e9  # the score of a dead beam and of a taken or barred continuation


def fused_beam_decode_plain(w: FusedDecodeWeights, cross_k: torch.Tensor,
                            cross_v: torch.Tensor, *, beam_size: int, num_heads: int,
                            steps: int, go_id: int = 0, eos_id: int = 1, eps: float = 1e-5,
                            early_stop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The beam search in PyTorch with the TPU kernel's casts.

    ``w`` is already in the compute type (:func:`cast_weights`);
    cross_k/cross_v [L, B, Tm, E] in the same type.  Values of the compute
    type are carried in float32 tensors; ``rd`` rounds to the compute type.
    The casts differ from the greedy kernel's in one place: the
    self-attention value sum multiplies the rounded probabilities by the
    cached values in float32 without rounding the product.
    """
    dt = w.w_qkv.dtype
    L, B, Tm, E = cross_k.shape
    K, H, T = beam_size, num_heads, steps
    hd = E // H
    C = w.head_w.shape[1]
    scale = 1.0 / math.sqrt(hd)
    dev = cross_k.device

    rd, lin, ln = plain_ops(dt, eps)
    f = {k: v.float() for k, v in w._asdict().items()}
    ck, cv = cross_k.float(), cross_v.float()
    kc = torch.zeros(L, B, K, T, E, device=dev)  # slot k of row b at position t
    vc = torch.zeros_like(kc)

    def softmax_rd(s):
        """Softmax over dim 2 of [B, K, S, H] scores, rounded to the type."""
        m = s.max(dim=2, keepdim=True).values
        e = torch.exp(s - m)
        return rd(e / e.sum(dim=2, keepdim=True))

    def heads(P):
        """[B, K, S, E] products -> per-head scores [B, K, S, H]."""
        return P.reshape(*P.shape[:3], H, hd).sum(-1) * scale

    rows = torch.arange(B, device=dev)[:, None, None]
    anc = torch.zeros(B, K, T, dtype=torch.long, device=dev)  # slot per position
    seqs = torch.zeros(B, K, T, dtype=torch.long, device=dev)
    scores = torch.full((B, K), NEG, device=dev)
    scores[:, 0] = 0.0
    fin = torch.zeros(B, K, dtype=torch.bool, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)  # rows still searching
    tok = torch.full((B, K), go_id, dtype=torch.long, device=dev)
    beam_ids = torch.arange(K, device=dev)
    cls = torch.arange(C, device=dev)
    flat_ids = torch.arange(K * C, device=dev)
    for t in range(T):
        if early_stop:
            live = live & ~fin.all(dim=1)
            if not live.any():
                break
        anc[:, :, t] = beam_ids
        x = f["emb"][tok] + f["pe"][t]                          # [B, K, E]
        for l in range(L):
            qkv = lin(x, f["w_qkv"][l], f["b_qkv"][l])
            kc[l, :, :, t] = rd(qkv[..., E:2 * E])
            vc[l, :, :, t] = rd(qkv[..., 2 * E:])
            # each beam's history: position p from the slot anc[b, k, p]
            a = anc[:, :, :t + 1]
            k_sel = kc[l][rows, a, torch.arange(t + 1, device=dev)]   # [B, K, t+1, E]
            v_sel = vc[l][rows, a, torch.arange(t + 1, device=dev)]
            q = rd(qkv[..., :E])
            probs = softmax_rd(heads(rd(q[:, :, None] * k_sel)))
            ctx = (probs.repeat_interleave(hd, dim=3) * v_sel).sum(2)
            x = ln(x + lin(ctx, f["w_out"][l], f["b_out"][l]), f["n1_s"][l], f["n1_b"][l])
            q2 = rd(lin(x, f["cw_q"][l], f["cb_q"][l]))
            probs2 = softmax_rd(heads(rd(q2[:, :, None] * ck[l][:, None])))
            ctx2 = rd(probs2.repeat_interleave(hd, dim=3) * cv[l][:, None]).sum(2)
            x = ln(x + lin(ctx2, f["cw_o"][l], f["cb_o"][l]), f["n2_s"][l], f["n2_b"][l])
            h = torch.relu(lin(x, f["ff1_w"][l], f["ff1_b"][l]))
            x = ln(x + lin(h, f["ff2_w"][l], f["ff2_b"][l]), f["n3_s"][l], f["n3_b"][l])
        x = ln(x, f["fn_s"], f["fn_b"])
        lg = lin(x, f["head_w"], f["head_b"])                   # [B, K, C]
        mx = lg.max(dim=-1, keepdim=True).values
        lse = torch.log(torch.exp(lg - mx).sum(dim=-1, keepdim=True))
        logp = lg - mx - lse
        frozen = torch.where(cls == eos_id, 0.0, NEG)
        logp = torch.where(fin[:, :, None], frozen, logp)
        comb = (logp + scores[:, :, None]).reshape(B, K * C)

        # top-K: K extractions of the maximum at its first flat index
        vals = torch.empty(B, K, device=dev)
        idx = torch.empty(B, K, dtype=torch.long, device=dev)
        for k in range(K):
            i = torch.argmax(comb, dim=1)                       # first index
            vals[:, k] = comb.gather(1, i[:, None])[:, 0]
            idx[:, k] = i
            comb = torch.where(flat_ids == i[:, None], NEG, comb)
        par, new_tok = idx // C, idx % C

        keep = live[:, None]
        anc = torch.where(keep[..., None], anc.gather(1, par[..., None].expand(-1, -1, T)), anc)
        new_seqs = seqs.gather(1, par[..., None].expand(-1, -1, T))
        new_seqs[:, :, t] = new_tok
        seqs = torch.where(keep[..., None], new_seqs, seqs)
        fin = torch.where(keep, fin.gather(1, par) | (new_tok == eos_id), fin)
        scores = torch.where(keep, vals, scores)
        tok = torch.where(keep, new_tok, tok)
    return seqs.to(torch.int32), scores


MAX_BEAMS = 8  # beams one CTA holds (the widest tile the kernel is built for)


def smem_bytes(K: int, E: int, F: int, C: int, H: int, S: int, T: int, vec: int) -> int:
    """Shared memory of one CTA (``smem_bytes`` in the kernel): per beam the
    residual, rounded input, FF hidden, projections, probabilities, scores
    and split-K partial sums in float32; the ancestry and token histories
    (two copies each) and four per-beam scalars."""
    return 4 * K * (E + E + F + 3 * E + H * S + C + THREADS * vec) + 4 * K * (4 * T + 4)


def fused_beam_decode_cuda(w: FusedDecodeWeights, cross_k: torch.Tensor,
                           cross_v: torch.Tensor, *, beam_size: int, num_heads: int,
                           steps: int, go_id: int = 0, eos_id: int = 1, eps: float = 1e-5,
                           early_stop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA beam kernel on inputs that
    ``fused_decode.check_kernel_inputs`` accepts, with 1 <= ``beam_size``
    <= min(MAX_BEAMS, C) and a tile that fits one CTA's shared memory.
    Returns (tokens [B, K, T] int32, scores [B, K] float32)."""
    L, B, Tm, E, F, C = check_kernel_inputs(w, cross_k, cross_v, num_heads=num_heads,
                                            steps=steps, class_ids=(go_id, eos_id),
                                            what="fused beam")
    dt, K, T, H = w.w_qkv.dtype, beam_size, steps, num_heads
    if not 1 <= K <= min(MAX_BEAMS, C):
        raise ValueError(f"fused beam: beam_size {K} outside 1..{min(MAX_BEAMS, C)}")
    smem = smem_bytes(K, E, F, C, H, max(T, Tm), T, 16 // dt.itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused beam: {smem} bytes of shared memory per CTA "
                         f"exceed {SMEM_LIMIT}")

    dev = cross_k.device
    # caches zeroed before use, as the TPU kernel's are
    kc = torch.zeros(L, B, K, T, E, dtype=dt, device=dev)
    vc = torch.zeros_like(kc)
    tokens = torch.empty(B, K, T, dtype=torch.int32, device=dev)
    scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    launch(launcher("fused_beam"), w, cross_k, cross_v, (kc, vc, tokens, scores),
           (B, T, L, E, F, C, H, Tm, go_id, eos_id, K, int(early_stop)),
           num_heads=H, eps=eps, what="fused beam")
    fused_beam_decode_cuda.launches += 1
    return tokens, scores


fused_beam_decode_cuda.launches = 0


def fused_beam_decode(w: FusedDecodeWeights, cross_k: torch.Tensor, cross_v: torch.Tensor,
                      *, beam_size: int, num_heads: int, steps: int,
                      dtype: torch.dtype = torch.bfloat16, go_id: int = 0, eos_id: int = 1,
                      eps: float = 1e-5, early_stop: bool = False,
                      plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search -> (tokens [B, beam_size, steps] int32, scores
    [B, beam_size] float32), best first; scores are raw cumulative
    log-probabilities.

    cross_k/cross_v: [L, B, Tm, E] memory projections per layer, one per
    batch row.  Weights and cross K/V are cast to ``dtype``.  CPU tensors
    (or ``plain=True``) take the plain version; CUDA tensors launch the
    kernel.
    """
    w = cast_weights(w, dtype)
    ck = cross_k.detach().to(dtype).contiguous()
    cv = cross_v.detach().to(dtype).contiguous()
    kw = dict(beam_size=beam_size, num_heads=num_heads, steps=steps, go_id=go_id,
              eos_id=eos_id, eps=eps, early_stop=early_stop)
    if plain or ck.device.type == "cpu":
        return fused_beam_decode_plain(w, ck, cv, **kw)
    return fused_beam_decode_cuda(w, ck, cv, **kw)
