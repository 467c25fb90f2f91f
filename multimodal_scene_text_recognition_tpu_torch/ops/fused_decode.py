"""Whole greedy decode loop in one kernel (JAX counterpart:
ops/fused_decode.py, float mode, no early stop, no CLS step-0 row).

Two versions of one function, ``logits [B, T, C] float32`` from the stacked
decoder weights and the per-layer cross-attention K/V:

* :func:`fused_greedy_decode_plain`, a PyTorch loop with the TPU kernel's
  exact casts.  The CPU path and the oracle of the kernel.
* :func:`fused_greedy_decode_cuda`, the CUDA kernel
  ``kernels/fused_decode.cu``, which replaces the TPU kernel
  ``ops/fused_decode.py::_decode_kernel``.

:func:`fused_greedy_decode` casts the weights to the compute type and picks
by device: the plain version for CPU tensors, the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch

from ..kernels import build


class FusedDecodeWeights(NamedTuple):
    """Per-layer weights stacked on a leading L axis, matrices [in, out].

      w_qkv [L,E,3E]  b_qkv [L,3E]   self-attention packed projection
      w_out [L,E,E]   b_out [L,E]    self-attention output projection
      cw_q  [L,E,E]   cb_q  [L,E]    cross-attention query projection
      cw_o  [L,E,E]   cb_o  [L,E]    cross-attention output projection
      ff1_w [L,E,F]   ff1_b [L,F]
      ff2_w [L,F,E]   ff2_b [L,E]
      n{1,2,3}_s/b [L,E]             the three layernorms
      fn_s / fn_b [E]                final norm
      head_w [E,C]    head_b [C]     emb_to_classes
      emb [C,E]       pe [T,E]       embedding table / positional rows
    """

    w_qkv: torch.Tensor
    b_qkv: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    cw_q: torch.Tensor
    cb_q: torch.Tensor
    cw_o: torch.Tensor
    cb_o: torch.Tensor
    ff1_w: torch.Tensor
    ff1_b: torch.Tensor
    ff2_w: torch.Tensor
    ff2_b: torch.Tensor
    n1_s: torch.Tensor
    n1_b: torch.Tensor
    n2_s: torch.Tensor
    n2_b: torch.Tensor
    n3_s: torch.Tensor
    n3_b: torch.Tensor
    fn_s: torch.Tensor
    fn_b: torch.Tensor
    head_w: torch.Tensor
    head_b: torch.Tensor
    emb: torch.Tensor
    pe: torch.Tensor


def stack_decoder_weights(layers: Sequence, final_norm, head, emb: torch.Tensor,
                          pe: torch.Tensor) -> FusedDecodeWeights:
    """Stack the port's decoder layers (``models.decoders.DecoderLayer``)
    into :class:`FusedDecodeWeights`.  The cross attention contributes only
    the query third of its packed projection: its K/V over the memory are
    computed once outside the loop."""
    E = layers[0].self_attn.in_proj_weight.shape[1]

    def mat(ws):  # torch [out, in] -> stacked [L, in, out]
        return torch.stack([w.t() for w in ws])

    def vec(vs):
        return torch.stack(list(vs))

    return FusedDecodeWeights(
        w_qkv=mat(l.self_attn.in_proj_weight for l in layers),
        b_qkv=vec(l.self_attn.in_proj_bias for l in layers),
        w_out=mat(l.self_attn.out_proj.weight for l in layers),
        b_out=vec(l.self_attn.out_proj.bias for l in layers),
        cw_q=mat(l.cross_attn.in_proj_weight[:E] for l in layers),
        cb_q=vec(l.cross_attn.in_proj_bias[:E] for l in layers),
        cw_o=mat(l.cross_attn.out_proj.weight for l in layers),
        cb_o=vec(l.cross_attn.out_proj.bias for l in layers),
        ff1_w=mat(l.linear1.weight for l in layers),
        ff1_b=vec(l.linear1.bias for l in layers),
        ff2_w=mat(l.linear2.weight for l in layers),
        ff2_b=vec(l.linear2.bias for l in layers),
        n1_s=vec(l.norm1.weight for l in layers),
        n1_b=vec(l.norm1.bias for l in layers),
        n2_s=vec(l.norm2.weight for l in layers),
        n2_b=vec(l.norm2.bias for l in layers),
        n3_s=vec(l.norm3.weight for l in layers),
        n3_b=vec(l.norm3.bias for l in layers),
        fn_s=final_norm.weight,
        fn_b=final_norm.bias,
        head_w=head.weight.t(),
        head_b=head.bias,
        emb=emb,
        pe=pe,
    )


def cast_weights(w: FusedDecodeWeights, dtype: torch.dtype) -> FusedDecodeWeights:
    """Every table in the compute type, contiguous; positional rows stay
    float32 (as in the TPU kernel).  Tables already so are passed through
    untouched, so weights cast once cost nothing on later calls."""
    def cast(v, dt):
        v = v.detach()
        return v if v.dtype == dt and v.is_contiguous() else v.to(dt).contiguous()

    fields = {k: cast(v, dtype) for k, v in w._asdict().items()}
    fields["pe"] = cast(w.pe, torch.float32)
    return FusedDecodeWeights(**fields)


def fused_greedy_decode_plain(w: FusedDecodeWeights, cross_k: torch.Tensor,
                              cross_v: torch.Tensor, *, num_heads: int,
                              steps: int, go_id: int = 0,
                              eps: float = 1e-5) -> torch.Tensor:
    """The greedy loop in PyTorch with the TPU kernel's casts.

    ``w`` is already in the compute type (:func:`cast_weights`);
    cross_k/cross_v [L, B, Tm, E] in the same type.  Values of the compute
    type are carried in float32 tensors; ``rd`` rounds to the compute type.
    """
    dt = w.w_qkv.dtype
    L, B, Tm, E = cross_k.shape
    H = num_heads
    hd = E // H
    C = w.head_w.shape[1]
    T = steps
    scale = 1.0 / math.sqrt(hd)
    dev = cross_k.device

    def rd(x):
        return x.to(dt).float()

    f = {k: v.float() for k, v in w._asdict().items()}
    ck, cv = cross_k.float(), cross_v.float()
    kc = torch.zeros(L, B, T, E, device=dev)
    vc = torch.zeros(L, B, T, E, device=dev)

    def lin(x, W, b):
        return rd(x) @ W + b

    def ln(x, s, b):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * s + b

    def attend(q, K, V):
        """q [B, E] (values of the compute type), K/V [B, S, E] -> [B, E]."""
        S = K.shape[1]
        P = rd(q[:, None, :] * K)                           # [B, S, E]
        scores = P.reshape(B, S, H, hd).sum(-1) * scale     # [B, S, H]
        m = scores.max(dim=1, keepdim=True).values
        e = torch.exp(scores - m)
        probs = rd(e / e.sum(dim=1, keepdim=True))
        probsE = probs.repeat_interleave(hd, dim=2)         # [B, S, E]
        return rd(probsE * V).sum(1)

    logits = torch.empty(B, T, C, device=dev)
    tok = torch.full((B,), go_id, dtype=torch.long, device=dev)
    for t in range(T):
        x = f["emb"][tok] + f["pe"][t]
        for l in range(L):
            qkv = lin(x, f["w_qkv"][l], f["b_qkv"][l])
            kc[l, :, t] = rd(qkv[:, E:2 * E])
            vc[l, :, t] = rd(qkv[:, 2 * E:])
            ctx = attend(rd(qkv[:, :E]), kc[l, :, :t + 1], vc[l, :, :t + 1])
            x = ln(x + lin(ctx, f["w_out"][l], f["b_out"][l]), f["n1_s"][l], f["n1_b"][l])
            q2 = rd(lin(x, f["cw_q"][l], f["cb_q"][l]))
            ctx2 = attend(q2, ck[l], cv[l])
            x = ln(x + lin(ctx2, f["cw_o"][l], f["cb_o"][l]), f["n2_s"][l], f["n2_b"][l])
            h = torch.relu(lin(x, f["ff1_w"][l], f["ff1_b"][l]))
            x = ln(x + lin(h, f["ff2_w"][l], f["ff2_b"][l]), f["n3_s"][l], f["n3_b"][l])
        x = ln(x, f["fn_s"], f["fn_b"])
        lg = lin(x, f["head_w"], f["head_b"])
        logits[:, t] = lg
        tok = torch.argmax(lg, dim=-1)  # first index of the maximum
    return logits


_N_TABLES = 23  # FusedDecodeWeights fields before pe


def _lib():
    fn = build.load("fused_decode").fused_decode
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
_THREADS = 256  # threads per CTA (kThreads in the kernel)
_ROWS = 1  # batch rows per CTA (kRows in the kernel)


def fused_greedy_decode_cuda(w: FusedDecodeWeights, cross_k: torch.Tensor,
                             cross_v: torch.Tensor, *, num_heads: int,
                             steps: int, go_id: int = 0, eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA decode kernel.  Every table of ``w`` and cross_k/v
    must be contiguous CUDA tensors of one compute type (float32 or
    bfloat16) on one device, ``pe`` float32.  Returns logits [B, T, C]."""
    dev = cross_k.device
    dt = w.w_qkv.dtype
    if dt not in _KERNEL_DTYPES:
        raise TypeError(f"fused decode kernel takes float32 or bfloat16, got {dt}")
    if dev.type != "cuda":
        raise ValueError("fused_greedy_decode_cuda takes CUDA tensors")
    tables = list(w)[:_N_TABLES]
    for name, t in zip(FusedDecodeWeights._fields, tables):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"fused decode: table {name} must be contiguous "
                             f"{dt} on {dev}, got {t.dtype} on {t.device}")
    for name, t, want in (("pe", w.pe, torch.float32), ("cross_k", cross_k, dt),
                          ("cross_v", cross_v, dt)):
        if t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"fused decode: {name} must be contiguous {want} on {dev}")
    L, B, Tm, E = cross_k.shape
    F = w.ff1_w.shape[2]
    C = w.head_w.shape[1]
    T = steps
    H = num_heads
    if cross_v.shape != cross_k.shape or E % H or w.w_qkv.shape != (L, E, 3 * E):
        raise ValueError("fused decode: inconsistent shapes")
    if w.pe.shape[0] < T or w.emb.shape != (C, E) or not 0 <= go_id < C:
        raise ValueError("fused decode: pe/emb/go_id do not fit the tables")
    R = _ROWS
    S = max(T, Tm)
    vec = 16 // dt.itemsize  # weight columns per 16-byte load
    smem = 4 * R * (E + E + F + 3 * E + H * S + C + _THREADS * vec) + 4 * R
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused decode: {smem} bytes of shared memory per CTA "
                         f"exceed {_SMEM_LIMIT}")

    # caches zeroed before use, as the TPU kernel's are
    kc = torch.zeros(L, B, T, E, dtype=dt, device=dev)
    vc = torch.zeros_like(kc)
    logits = torch.empty(B, T, C, dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in tables] + [
        w.pe.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), logits.data_ptr()]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * 9)(B, T, L, E, F, C, H, Tm, go_id)
    fn = _lib()
    with torch.cuda.device(dev):  # the launcher uses the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_KERNEL_DTYPES[dt], c_ptrs, c_dims, eps, 1.0 / math.sqrt(E // H), stream)
    if rc != 0:
        raise RuntimeError(f"fused decode kernel launch failed: CUDA error {rc}")
    fused_greedy_decode_cuda.launches += 1
    return logits


fused_greedy_decode_cuda.launches = 0


def fused_greedy_decode(w: FusedDecodeWeights, cross_k: torch.Tensor,
                        cross_v: torch.Tensor, *, num_heads: int, steps: int,
                        dtype: torch.dtype = torch.bfloat16, go_id: int = 0,
                        eps: float = 1e-5, plain: bool = False) -> torch.Tensor:
    """Greedy decode -> logits [B, steps, C] float32.

    cross_k/cross_v: [L, B, Tm, E] memory projections per layer.  Weights
    and cross K/V are cast to ``dtype``.  CPU tensors (or ``plain=True``)
    take the plain version; CUDA tensors launch the kernel.
    """
    w = cast_weights(w, dtype)
    ck = cross_k.detach().to(dtype).contiguous()
    cv = cross_v.detach().to(dtype).contiguous()
    kw = dict(num_heads=num_heads, steps=steps, go_id=go_id, eps=eps)
    if plain or ck.device.type == "cpu":
        return fused_greedy_decode_plain(w, ck, cv, **kw)
    return fused_greedy_decode_cuda(w, ck, cv, **kw)
