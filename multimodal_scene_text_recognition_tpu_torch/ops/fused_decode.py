"""Whole greedy decode loop in one kernel (JAX counterpart:
ops/fused_decode.py, float mode with its ``eos_id`` early stop; no CLS
step-0 row).

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
from typing import NamedTuple, Optional, Sequence

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


def plain_ops(dt: torch.dtype, eps: float):
    """The plain versions' arithmetic in compute type ``dt``, on float32
    tensors: ``rd`` rounds to ``dt``; ``lin(x, W, b)`` is the rounded input
    times W (float32 accumulation) plus b; ``ln(x, s, b)`` a float32
    layernorm."""
    def rd(x):
        return x.to(dt).float()

    def lin(x, W, b):
        return rd(x) @ W + b

    def ln(x, s, b):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * s + b

    return rd, lin, ln


def fused_greedy_decode_plain(w: FusedDecodeWeights, cross_k: torch.Tensor,
                              cross_v: torch.Tensor, *, num_heads: int,
                              steps: int, go_id: int = 0, eos_id: Optional[int] = None,
                              eps: float = 1e-5) -> torch.Tensor:
    """The greedy loop in PyTorch with the TPU kernel's casts.

    ``w`` is already in the compute type (:func:`cast_weights`);
    cross_k/cross_v [L, B, Tm, E] in the same type.  Values of the compute
    type are carried in float32 tensors; ``rd`` rounds to the compute type.

    With ``eos_id`` a row stops once it has emitted that token: its later
    logit rows stay the ``eos_id`` one-hot, and the loop ends when every
    row has stopped.
    """
    dt = w.w_qkv.dtype
    L, B, Tm, E = cross_k.shape
    H = num_heads
    hd = E // H
    C = w.head_w.shape[1]
    T = steps
    scale = 1.0 / math.sqrt(hd)
    dev = cross_k.device

    rd, lin, ln = plain_ops(dt, eps)
    f = {k: v.float() for k, v in w._asdict().items()}
    ck, cv = cross_k.float(), cross_v.float()
    kc = torch.zeros(L, B, T, E, device=dev)
    vc = torch.zeros(L, B, T, E, device=dev)

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

    logits = _logits_buffer(B, T, C, eos_id, dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
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
        logits[:, t] = torch.where(done[:, None], logits[:, t], lg)
        tok = torch.argmax(lg, dim=-1)  # first index of the maximum
        if eos_id is not None:
            done |= tok == eos_id
            if done.all():
                break
    return logits


def _logits_buffer(B: int, T: int, C: int, eos_id: Optional[int], device) -> torch.Tensor:
    """The logits output: with ``eos_id``, prefilled with its one-hot (the
    rows a stopped row never visits keep it), else uninitialised."""
    if eos_id is None:
        return torch.empty(B, T, C, device=device)
    logits = torch.zeros(B, T, C, device=device)
    logits[..., eos_id] = 1.0
    return logits


_N_TABLES = 23  # FusedDecodeWeights fields before pe
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
THREADS = 256  # threads per CTA (kThreads in the decode kernels)
_ROWS = 1  # batch rows per CTA (kRows in the kernel)


def check_kernel_inputs(w: FusedDecodeWeights, cross_k: torch.Tensor, cross_v: torch.Tensor,
                        *, num_heads: int, steps: int, class_ids: Sequence[int], what: str):
    """What the decode kernels (greedy and beam) take: every table of ``w``
    and cross_k/v contiguous CUDA tensors of one compute type (float32 or
    bfloat16) on one device, ``pe`` float32, consistent shapes, ``steps``
    positional rows and valid ``class_ids``.  Raises TypeError or
    ValueError otherwise; returns (L, B, Tm, E, F, C)."""
    dev = cross_k.device
    dt = w.w_qkv.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dt}")
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel takes CUDA tensors")
    for name, t in zip(FusedDecodeWeights._fields, list(w)[:_N_TABLES]):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: table {name} must be contiguous "
                             f"{dt} on {dev}, got {t.dtype} on {t.device}")
    for name, t, want in (("pe", w.pe, torch.float32), ("cross_k", cross_k, dt),
                          ("cross_v", cross_v, dt)):
        if t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {want} on {dev}")
    L, B, Tm, E = cross_k.shape
    C = w.head_w.shape[1]
    if cross_v.shape != cross_k.shape or E % num_heads or w.w_qkv.shape != (L, E, 3 * E):
        raise ValueError(f"{what}: inconsistent shapes")
    if w.pe.shape[0] < steps or w.emb.shape != (C, E):
        raise ValueError(f"{what}: pe/emb do not fit the tables")
    if not all(0 <= i < C for i in class_ids):
        raise ValueError(f"{what}: class ids {list(class_ids)} outside 0..{C - 1}")
    return L, B, Tm, E, w.ff1_w.shape[2], C


def launch(fn, w: FusedDecodeWeights, cross_k: torch.Tensor, cross_v: torch.Tensor,
           buffers: Sequence[torch.Tensor], dims: Sequence[int], *, num_heads: int,
           eps: float, what: str) -> None:
    """Call a decode kernel's C launcher ``fn(dtype, pointers, dims, eps,
    scale, stream)`` on the current stream of the tensors' device, with the
    pointers of the tables, pe, cross_k, cross_v and ``buffers``; raises if
    the launch fails."""
    dev = cross_k.device
    ptrs = [t.data_ptr() for t in list(w)[:_N_TABLES]] + [
        w.pe.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr()] + [b.data_ptr() for b in buffers]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    scale = 1.0 / math.sqrt(cross_k.shape[-1] // num_heads)
    with torch.cuda.device(dev):  # the launcher uses the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(KERNEL_DTYPES[w.w_qkv.dtype], c_ptrs, c_dims, eps, scale, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def launcher(name: str):
    """The C launcher of kernel library ``name``, built on first use: the
    function of the same name, ``int name(dtype, pointers, dims, eps, scale,
    stream)``, which both decode kernels export."""
    fn = getattr(build.load(name), name)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_greedy_decode_cuda(w: FusedDecodeWeights, cross_k: torch.Tensor,
                             cross_v: torch.Tensor, *, num_heads: int,
                             steps: int, go_id: int = 0, eos_id: Optional[int] = None,
                             eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA decode kernel on inputs :func:`check_kernel_inputs`
    accepts.  Returns logits [B, T, C]."""
    ids = [go_id] + ([] if eos_id is None else [eos_id])
    L, B, Tm, E, F, C = check_kernel_inputs(w, cross_k, cross_v, num_heads=num_heads,
                                            steps=steps, class_ids=ids, what="fused decode")
    dt, T, H, R = w.w_qkv.dtype, steps, num_heads, _ROWS
    S = max(T, Tm)
    vec = 16 // dt.itemsize  # weight columns per 16-byte load
    smem = 4 * R * (E + E + F + 3 * E + H * S + C + THREADS * vec) + 8 * R
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused decode: {smem} bytes of shared memory per CTA "
                         f"exceed {SMEM_LIMIT}")

    # caches zeroed before use, as the TPU kernel's are
    kc = torch.zeros(L, B, T, E, dtype=dt, device=cross_k.device)
    vc = torch.zeros_like(kc)
    logits = _logits_buffer(B, T, C, eos_id, cross_k.device)
    launch(launcher("fused_decode"), w, cross_k, cross_v, (kc, vc, logits),
           (B, T, L, E, F, C, H, Tm, go_id, -1 if eos_id is None else eos_id),
           num_heads=H, eps=eps, what="fused decode")
    fused_greedy_decode_cuda.launches += 1
    return logits


fused_greedy_decode_cuda.launches = 0


def fused_greedy_decode(w: FusedDecodeWeights, cross_k: torch.Tensor,
                        cross_v: torch.Tensor, *, num_heads: int, steps: int,
                        dtype: torch.dtype = torch.bfloat16, go_id: int = 0,
                        eos_id: Optional[int] = None, eps: float = 1e-5,
                        plain: bool = False) -> torch.Tensor:
    """Greedy decode -> logits [B, steps, C] float32.

    cross_k/cross_v: [L, B, Tm, E] memory projections per layer.  Weights
    and cross K/V are cast to ``dtype``.  ``eos_id`` stops each row once it
    has emitted that token (see :func:`fused_greedy_decode_plain`).  CPU tensors (or ``plain=True``)
    take the plain version; CUDA tensors launch the kernel.
    """
    w = cast_weights(w, dtype)
    ck = cross_k.detach().to(dtype).contiguous()
    cv = cross_v.detach().to(dtype).contiguous()
    kw = dict(num_heads=num_heads, steps=steps, go_id=go_id, eos_id=eos_id, eps=eps)
    if plain or ck.device.type == "cpu":
        return fused_greedy_decode_plain(w, ck, cv, **kw)
    return fused_greedy_decode_cuda(w, ck, cv, **kw)
