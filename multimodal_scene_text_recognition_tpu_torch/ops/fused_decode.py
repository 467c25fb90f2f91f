"""Whole greedy decode loop in one kernel (JAX counterpart:
ops/fused_decode.py, float mode and ``quantized=True``, with its ``eos_id``
early stop and its ``cls0`` step-0 row).

Two versions of one function, ``logits [B, T, C] float32`` from the stacked
decoder weights and the per-layer cross-attention K/V:

* :func:`fused_greedy_decode_plain`, a PyTorch loop with the TPU kernel's
  exact casts.  The CPU path and the oracle of the kernel.
* :func:`fused_greedy_decode_cuda`, the CUDA kernels that replace the TPU
  kernel ``ops/fused_decode.py::_decode_kernel``: K1 in float mode
  (``kernels/fused_decode_cluster.cu``: one thread-block cluster of up to
  8 CTAs per tile of R rows, the weights split across the cluster, read
  from the units :func:`pack_cluster_tables` lays out, and run on the
  tensor cores in bf16; :func:`cluster_plan` is its launch), K1q with
  ``scales`` (tables from :func:`quantize_fused_weights`): the same
  kernel's int8 mode, its six projections int8 x int8 -> int32 on the
  tensor cores from the units of :func:`pack_cluster_tables_int8`, or, for
  small batches and for rows wider than the cluster kernel takes,
  ``kernels/fused_decode.cu`` (one row a CTA, ``__dp4a``); :func:`k1q_route`
  picks by the shapes.

With ``cls0`` [B, E] float32 (the semantic CLS vector of
``cls_decoder_init``) the step-0 input row is ``cls0 + pe[0]`` in float32,
unrounded, in place of the [GO] embedding (the TPU kernel's ``use_cls``
row): rounded to the compute type where a float-mode projection reads it,
quantized as it stands in K1q.

:func:`fused_greedy_decode` casts the weights to the compute type and picks
by device: the plain version for CPU tensors, the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels import build
from .int8 import dequantize, div, quantize_rows


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


class FusedDecodeScales(NamedTuple):
    """Per-output-channel dequantization scales of the six int8 projection
    tables (table = table_q * scale), float32 [L, N]: N = 3E, E, E, E, F, E."""

    s_qkv: torch.Tensor
    s_out: torch.Tensor
    s_cq: torch.Tensor
    s_co: torch.Tensor
    s_ff1: torch.Tensor
    s_ff2: torch.Tensor


QUANTIZED = ("w_qkv", "w_out", "cw_q", "cw_o", "ff1_w", "ff2_w")  # scale order


def pack_int8_table(t: torch.Tensor) -> torch.Tensor:
    """An int8 table [L, K, N] in K1q's layout [L, K/4, N, 4]: the four
    K-rows of a group side by side per column, so one 32-bit word feeds one
    ``__dp4a``.  Raises unless K is a multiple of 4."""
    L, K, N = t.shape
    if K % 4:
        raise ValueError(f"the int8 decode takes E and F in multiples of 4, got a table "
                         f"of {K} input rows")
    return t.reshape(L, K // 4, 4, N).transpose(2, 3).contiguous()


def unpack_int8_table(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_int8_table`: [L, K/4, N, 4] -> [L, K, N]."""
    L, Kw, N, _ = t.shape
    return t.transpose(2, 3).reshape(L, 4 * Kw, N)


def quantize_fused_weights(w: FusedDecodeWeights):
    """Symmetric per-output-channel int8 quantization of the six projection
    tables, from their float32 values: scale ``max(absmax, 1e-12) / 127``
    over each table's input axis, values ``round(t / scale)`` (half to
    even) clipped to +-127.  Returns ``(w_q, scales)``: ``w`` with those six
    tables int8 in K1q's layout (:func:`pack_int8_table`; both versions of
    the decode take them so, and :func:`unpack_int8_table` gives [L, in,
    out]), and :class:`FusedDecodeScales`."""
    tables, scales = {}, []
    for name in QUANTIZED:
        t = getattr(w, name).detach().float()
        scale = div(torch.clamp(t.abs().amax(dim=1, keepdim=True), min=1e-12), 127.0)
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        tables[name] = pack_int8_table(q)
        scales.append(scale[:, 0])
    return w._replace(**tables), FusedDecodeScales(*scales)


def cast_weights(w: FusedDecodeWeights, dtype: torch.dtype) -> FusedDecodeWeights:
    """Every float table in the compute type, contiguous; positional rows
    stay float32 (as in the TPU kernel) and int8 tables int8.  Tables
    already so are passed through untouched, so weights cast once cost
    nothing on later calls."""
    def cast(v, dt):
        v = v.detach()
        dt = torch.int8 if v.dtype == torch.int8 else dt
        return v if v.dtype == dt and v.is_contiguous() else v.to(dt).contiguous()

    fields = {k: cast(v, dtype) for k, v in w._asdict().items()}
    fields["pe"] = cast(w.pe, torch.float32)
    return FusedDecodeWeights(**fields)


def plain_ops(dt: torch.dtype, eps: float):
    """The plain versions' arithmetic in compute type ``dt``, on float32
    tensors: ``rd`` rounds to ``dt``; ``lin(x, W, b)`` is the rounded input
    times W (float32 accumulation) plus b, or with a scale ``s`` (W an int8
    table as integer values) the quantized projection of
    :func:`quantized_linear`; ``ln(x, s, b)`` a float32 layernorm."""
    def rd(x):
        return x.to(dt).float()

    def lin(x, W, b, s=None):
        if s is not None:
            return quantized_linear(x, W, s, b)
        return rd(x) @ W + b

    def ln(x, s, b):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * s + b

    return rd, lin, ln


def quantized_linear(x: torch.Tensor, Wq: torch.Tensor, s: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's quantized ``lin``: x [B, K] float32, quantized per
    row from its unrounded values (scale ``row absmax / 127``, half to
    even, clipped to +-127); the exact integer product with the int8 table
    ``Wq`` [K, N] (held as float32 or int8), formed in float64; then
    ``acc.f32 * ((absmax / 127) * s) + b``."""
    xq, ax = quantize_rows(x)
    return dequantize((xq.double() @ Wq.double()).float(), div(ax, 127.0), s, b)


def fused_greedy_decode_plain(w: FusedDecodeWeights, cross_k: torch.Tensor,
                              cross_v: torch.Tensor, *, num_heads: int,
                              steps: int, go_id: int = 0, eos_id: Optional[int] = None,
                              eps: float = 1e-5,
                              scales: Optional[FusedDecodeScales] = None,
                              cls0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The greedy loop in PyTorch with the TPU kernel's casts.

    ``w`` is already in the compute type (:func:`cast_weights`);
    cross_k/cross_v [L, B, Tm, E] in the same type.  Values of the compute
    type are carried in float32 tensors; ``rd`` rounds to the compute type.

    With ``scales`` the six projection tables of ``w`` are int8 in K1q's
    layout (:func:`quantize_fused_weights`) and their products run as the TPU
    kernel's ``quantized=True`` mode: each projection quantizes its float32
    input unrounded (the float mode rounds it to the compute type first),
    so the attention contexts and the FF hidden are not rounded either.

    With ``eos_id`` a row stops once it has emitted that token: its later
    logit rows stay the ``eos_id`` one-hot, and the loop ends when every
    row has stopped.  With ``cls0`` the step-0 row is ``cls0 + pe[0]``.
    """
    dt = w.w_qkv.dtype if scales is None else w.b_qkv.dtype
    L, B, Tm, E = cross_k.shape
    check_cls0(cls0, B, E, cross_k.device, "fused decode")
    H = num_heads
    hd = E // H
    C = w.head_w.shape[1]
    T = steps
    scale = 1.0 / math.sqrt(hd)
    dev = cross_k.device

    rd, lin, ln = plain_ops(dt, eps)
    f = {k: (unpack_int8_table(v) if scales is not None and k in QUANTIZED else v).float()
         for k, v in w._asdict().items()}
    q = dict(zip(QUANTIZED, [None] * 6 if scales is None else [s.float() for s in scales]))
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
        x = (cls0 if t == 0 and cls0 is not None else f["emb"][tok]) + f["pe"][t]
        for l in range(L):
            def proj(name, bias, inp):
                s = q[name]
                return lin(inp, f[name][l], f[bias][l], None if s is None else s[l])

            qkv = proj("w_qkv", "b_qkv", x)
            kc[l, :, t] = rd(qkv[:, E:2 * E])
            vc[l, :, t] = rd(qkv[:, 2 * E:])
            ctx = attend(rd(qkv[:, :E]), kc[l, :, :t + 1], vc[l, :, :t + 1])
            x = ln(x + proj("w_out", "b_out", ctx), f["n1_s"][l], f["n1_b"][l])
            q2 = rd(proj("cw_q", "cb_q", x))
            ctx2 = attend(q2, ck[l], cv[l])
            x = ln(x + proj("cw_o", "cb_o", ctx2), f["n2_s"][l], f["n2_b"][l])
            h = torch.relu(proj("ff1_w", "ff1_b", x))
            x = ln(x + proj("ff2_w", "ff2_b", h), f["n3_s"][l], f["n3_b"][l])
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
_ROWS = 1  # batch rows per CTA of K1q's wide-row route (kRows in fused_decode.cu)


def check_cls0(cls0: Optional[torch.Tensor], B: int, E: int, device: torch.device,
               what: str) -> None:
    """A step-0 row ``cls0``, where one is given, must be a contiguous
    float32 [B, E] tensor on ``device``; raises ValueError otherwise."""
    if cls0 is not None and (cls0.dtype != torch.float32 or cls0.device != device
                             or not cls0.is_contiguous() or tuple(cls0.shape) != (B, E)):
        raise ValueError(f"{what}: cls0 must be contiguous float32 [{B}, {E}] on {device}, "
                         f"got {cls0.dtype} {tuple(cls0.shape)} on {cls0.device}")


def check_kernel_inputs(w: FusedDecodeWeights, cross_k: torch.Tensor, cross_v: torch.Tensor,
                        *, num_heads: int, steps: int, class_ids: Sequence[int], what: str,
                        scales: Optional[FusedDecodeScales] = None,
                        cls0: Optional[torch.Tensor] = None):
    """What the decode kernels (greedy and beam) take: every table of ``w``
    and cross_k/v contiguous CUDA tensors of one compute type (float32 or
    bfloat16) on one device, ``pe`` float32, consistent shapes, ``steps``
    positional rows and valid ``class_ids``.  With ``scales`` (K1q) the six
    projection tables are int8 in K1q's layout [L, K/4, N, 4] instead, and
    the scales contiguous float32 [L, N] on the same device; a ``cls0`` is
    what :func:`check_cls0` takes.  Raises TypeError or ValueError
    otherwise; returns (L, B, Tm, E, F, C)."""
    dev = cross_k.device
    dt = w.b_qkv.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dt}")
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel takes CUDA tensors")
    for name, t in zip(FusedDecodeWeights._fields, list(w)[:_N_TABLES]):
        want = torch.int8 if scales is not None and name in QUANTIZED else dt
        if t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: table {name} must be contiguous "
                             f"{want} on {dev}, got {t.dtype} on {t.device}")
    for name, t, want in (("pe", w.pe, torch.float32), ("cross_k", cross_k, dt),
                          ("cross_v", cross_v, dt)):
        if t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {want} on {dev}")
    L, B, Tm, E = cross_k.shape
    C, F = w.head_w.shape[1], w.ff1_w.shape[2]
    if cross_v.shape != cross_k.shape or E % num_heads:
        raise ValueError(f"{what}: inconsistent shapes")
    check_cls0(cls0, B, E, dev, what)
    if scales is None and w.w_qkv.shape != (L, E, 3 * E):
        raise ValueError(f"{what}: inconsistent shapes")
    if scales is not None:
        shapes = ((E, 3 * E), (E, E), (E, E), (E, E), (E, F), (F, E))
        for name, (K, N) in zip(QUANTIZED, shapes):
            if K % 4 or getattr(w, name).shape != (L, K // 4, N, 4):
                raise ValueError(f"{what}: table {name} must be int8 [{L}, {K}/4, {N}, 4] "
                                 f"(quantize_fused_weights); the int8 kernel takes E and F "
                                 f"in multiples of 4")
    if w.pe.shape[0] < steps or w.emb.shape != (C, E):
        raise ValueError(f"{what}: pe/emb do not fit the tables")
    if not all(0 <= i < C for i in class_ids):
        raise ValueError(f"{what}: class ids {list(class_ids)} outside 0..{C - 1}")
    if scales is not None:
        for name, s, t in zip(FusedDecodeScales._fields, scales,
                              (getattr(w, n) for n in QUANTIZED)):
            if (s.dtype != torch.float32 or s.device != dev or not s.is_contiguous()
                    or s.shape != (L, t.shape[2])):
                raise ValueError(f"{what}: scale {name} must be contiguous float32 "
                                 f"[{L}, {t.shape[2]}] on {dev}")
    return L, B, Tm, E, F, C


def launch(fn, w: FusedDecodeWeights, cross_k: torch.Tensor, cross_v: torch.Tensor,
           buffers: Sequence[torch.Tensor], dims: Sequence[int], *, num_heads: int,
           eps: float, what: str, cls0: Optional[torch.Tensor] = None) -> None:
    """Call a decode kernel's C launcher ``fn(dtype, pointers, dims, eps,
    scale, cls0, stream)`` on the current stream of the tensors' device,
    with the pointers of the tables, pe, cross_k, cross_v and ``buffers``
    (null for None), and ``cls0``'s (null without one); raises if the
    launch fails."""
    dev = cross_k.device
    ptrs = [t.data_ptr() for t in list(w)[:_N_TABLES]] + [
        w.pe.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr()] + [
        0 if b is None else b.data_ptr() for b in buffers]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    scale = 1.0 / math.sqrt(cross_k.shape[-1] // num_heads)
    with torch.cuda.device(dev):  # the launcher uses the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(KERNEL_DTYPES[w.b_qkv.dtype], c_ptrs, c_dims, eps, scale,
                None if cls0 is None else cls0.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def launcher(name: str, fn_name: Optional[str] = None):
    """The C launcher ``int fn_name(dtype, pointers, dims, eps, scale, cls0,
    stream)`` (default: the library's own name) of kernel library ``name``,
    built on first use; every decode kernel exports one."""
    fn = getattr(build.load(name), fn_name or name)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_smem_bytes(E: int, F: int, C: int, H: int, S: int, vec: int) -> int:
    """Shared memory of one CTA of K1q's wide-row route (``smem_bytes`` in
    fused_decode.cu):
    float32 rows, the split-K sums, the token and stop flags, the row
    abs-max and its inverse, a max per warp and the int8 row."""
    R = _ROWS
    return (4 * R * (E + E + F + 3 * E + H * S + C + THREADS * vec) + 8 * R
            + 4 * R * (2 + THREADS // 32) + R * max(E, F))


# -- K1's cluster design (kernels/fused_decode_cluster.cu) --------------------

# the phases of a step K1's profile tells apart (Marks in the kernel); K1q's
# adds the cluster-wide abs-max before each K-split projection
CLUSTER_PHASES = ("embedding", "qkv", "cache write", "self-attention", "out-proj", "exchange 1",
                  "cross-q", "cross-attention", "cross-out", "exchange 2", "ff1", "ff2",
                  "exchange 3", "class head", "logits, argmax, stop")
INT8_CLUSTER_PHASES = CLUSTER_PHASES + ("abs-max 1", "abs-max 2", "abs-max 3")
# rows a cluster owns (kRows in the kernel): the M side of one mma.sync tile;
# tiles of 32 rows were slower at B=192 on an H100 (PERF.md)
CLUSTER_ROWS = 16
_DEPTH = 16  # weight units in flight a lane (kDepth in the kernel)
MAX_CLUSTER = 8  # CTAs a cluster (one a head): the portable cluster size
_WARPS = THREADS // 32
_UNIT = 512  # bytes of one weight unit: 16 a lane
_MAX_E = 512  # row width the kernel's exchange holds in registers
_INT8_COLS, _INT8_STEP = 16, 32  # an int8 unit: two m16n8k32 n8 tiles, 32 deep


def unit_cols(dtype: torch.dtype) -> int:
    """Output columns of one weight unit: 16 in bf16 (two mma.sync n8
    tiles), 8 in float32 (one column a lane quad)."""
    return 16 if dtype.itemsize == 2 else 8


def _kk(step: int) -> torch.Tensor:
    """The k order of a unit's lanes within one k-step: lane quad q holds
    the words at k = w q and w q + step / 2 (w = step / 8 values a 32-bit
    fragment word: two bf16, or in float32 the same k-values; four int8)."""
    w = step // 8
    return torch.tensor([w * q + (j % w) + step // 2 * (j // w)
                         for q in range(4) for j in range(2 * w)])


class ClusterPlan(NamedTuple):
    """The launch of K1's cluster kernel: ``clusters`` clusters of ``G``
    CTAs (:func:`cluster_size`), each owning ``R`` batch rows; ``smem`` bytes of
    shared memory a CTA, ``depth`` weight units in flight a lane; each of
    the seven projections (qkv, out, cross-q, cross-out, ff1, ff2 and the
    class head, its columns padded to ``Cp``) has ``shapes`` [K, N] in a
    CTA's slice; a CTA reads ``units`` units of 512 bytes a layer and
    ``head_units`` for the head, ``cta_step_bytes`` of weights a step."""

    G: int
    R: int
    clusters: int
    smem: int
    depth: int
    Cp: int
    shapes: Tuple[Tuple[int, int], ...]
    units: int
    head_units: int
    cta_step_bytes: int

    @property
    def ctas(self) -> int:
        return self.clusters * self.G

    def call_bytes(self, steps: int) -> int:
        """Weight bytes the CTAs of a call read from L2 over ``steps``
        steps (every cluster running them all)."""
        return self.ctas * self.cta_step_bytes * steps


class ClusterWidths(NamedTuple):
    """How K1 (K1q) cuts the widths: rows of E padded to ``Ep`` columns,
    ``G`` CTAs a cluster, ``Hc`` heads a CTA of ``hd`` columns each (padded
    to ``hdp``), ``Fg`` FF columns a CTA (the last may own fewer; padded to
    ``Fgp``), the class head padded to ``Cp`` columns, ``un`` output
    columns and ``ks`` k-values a weight unit of the six projections (16 a
    k-step in float mode, 32 in int8 mode, which is also the padding), ``hu``
    output columns a unit of the class head (16 deep, in the compute type),
    and the [K, N] slice a CTA owns of each of the seven projections (qkv,
    out, cross-q, cross-out, ff1, ff2, head)."""

    Ep: int
    G: int
    Hc: int
    hd: int
    hdp: int
    Fg: int
    Fgp: int
    Cp: int
    un: int
    ks: int
    hu: int
    shapes: Tuple[Tuple[int, int], ...]

    def kinds(self):
        """(output columns, k-step) of a unit of each of the seven slices."""
        return [(self.un, self.ks)] * 6 + [(self.hu, 16)]

    def unit_counts(self):
        """Units of each of the seven slices (its columns by its k-steps)."""
        return [N // u * (K // k) for (K, N), (u, k) in zip(self.shapes, self.kinds())]


def cluster_size(Ep: int, H: int) -> int:
    """CTAs a K1 cluster (``cluster_size`` in the kernel) for rows of Ep
    (padded) columns: the largest divisor of H that is at most
    :data:`MAX_CLUSTER` and divides Ep / 4 (the exchange moves 16-byte
    column groups); 0 where none does."""
    return next((g for g in range(MAX_CLUSTER, 0, -1) if H % g == 0 and Ep % (4 * g) == 0), 0)


def _pad(n: int, k: int) -> int:
    return -(-n // k) * k


def _cluster_shapes(E: int, H: int, F: int, C: int, dtype: torch.dtype,
                    int8: bool = False) -> ClusterWidths:
    """The cut of the widths (``Geometry`` in the kernel computes the
    same): rows of E zero-padded to Ep, a multiple of the k-step of the
    six projections' units (16, or 32 in int8 mode); a cluster of G =
    :func:`cluster_size` CTAs, each owning H / G heads and ceil(F / G) FF
    columns, zero-padded to multiples of the k-step too.  Raises ValueError
    where the kernel cannot tile the widths: heads that do not divide E, or
    E beyond the exchange's registers."""
    what = "fused int8 decode" if int8 else "fused decode"
    if H < 1 or E % H:
        raise ValueError(f"{what}: {H} heads do not divide E={E}")
    if E > _MAX_E:
        raise ValueError(f"{what}: E={E} exceeds the cluster kernel's {_MAX_E}")
    hu = unit_cols(dtype)
    un, ks = (_INT8_COLS, _INT8_STEP) if int8 else (hu, 16)
    Ep = _pad(E, ks)
    G = cluster_size(Ep, H)
    Hc, hd, Fg = H // G, E // H, -(-F // G)
    hdp, Fgp = _pad(hd, ks), _pad(Fg, ks)
    Cp = -(-C // (_WARPS * hu)) * _WARPS * hu
    W = Hc * hdp
    shapes = ((Ep, 3 * W), (W, Ep), (Ep, W), (W, Ep), (Ep, Fgp), (Fgp, Ep), (Ep, Cp))
    return ClusterWidths(Ep, G, Hc, hd, hdp, Fg, Fgp, Cp, un, ks, hu, shapes)


def cluster_plan(B: int, L: int, E: int, H: int, F: int, C: int, T: int, Tm: int,
                 dtype: torch.dtype, int8: bool = False) -> ClusterPlan:
    """The launch of K1's cluster kernel (``int8``: of K1q, its int8 mode)
    for these widths (``Geometry`` in the kernel computes the same): G =
    :func:`cluster_size` CTAs a cluster, :data:`CLUSTER_ROWS` rows a
    cluster, ceil(B / CLUSTER_ROWS) clusters.  Raises ValueError for widths
    the kernel cannot tile (:func:`_cluster_shapes`) or shared memory
    beyond the card's."""
    cw = _cluster_shapes(E, H, F, C, dtype, int8)
    units = cw.unit_counts()
    R, depth, es, Ep = CLUSTER_ROWS, _DEPTH, dtype.itemsize, cw.Ep
    W = cw.Hc * cw.hdp
    ldf = max(W, cw.Fgp)
    red = max(R * cw.Cp, -(-max(T, Tm) // 8) * R * cw.hd)  # the head's logits, the attention's chunks
    if int8:  # A operands: the head's in T and the N-split inputs' int8 in one region; the
        # K-split inputs' int8, then their float32 rows; then the abs-max exchange and scales
        operands = max(es * R * (Ep + 8), R * (Ep + 16)) + R * (ldf + 16) + 4 * R * ldf
        operands += 4 * R * (MAX_CLUSTER + 2)
    else:
        operands = es * R * ((Ep + 8) + ldf + 8)
    smem = (_WARPS * depth * _UNIT + 4 * R * Ep + operands
            + 4 * R * 3 * W + 8 * R * Ep + 4 * red + 4 * R * max(T, Tm) + 8 * R)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{'fused int8 decode' if int8 else 'fused decode'}: {smem} bytes of "
                         f"shared memory a CTA ({dtype}) exceed {SMEM_LIMIT}")
    return ClusterPlan(G=cw.G, R=R, clusters=-(-B // R), smem=smem, depth=depth, Cp=cw.Cp,
                       shapes=cw.shapes, units=sum(units[:-1]), head_units=units[-1],
                       cta_step_bytes=(L * sum(units[:-1]) + units[-1]) * _UNIT)


# K1q's batches that take the wide-row kernel: a cluster runs a whole
# 16-row tile however few rows it has, and the wide-row kernel one CTA a
# row.  On an H100 (bf16, the trained flagship; chip_smoke.py's K1Q_SWEEP,
# PERF.md §6) the wide-row kernel took 6.54-7.28 ms at full length for
# B <= 64 and 8.34 at B=96 against the cluster's 8.44-8.99; from B=128 the
# cluster kernel was faster (9.27 against 10.05, and 9.46 against 10.94 at
# B=192).  The crossover was measured at those widths in bf16 only; the
# route applies it to every width and to float32 unmeasured.
K1Q_WIDE_BATCH = 96


class K1qRoute(NamedTuple):
    """Where K1q runs for given shapes: ``kernel`` "cluster" (the cluster
    kernel's int8 mode, launched as ``plan``) or "wide" (``fused_decode.cu``,
    one row a CTA, for batches up to :data:`K1Q_WIDE_BATCH` rows and for
    widths the cluster plan refuses: ``why``)."""

    kernel: str
    plan: Optional[ClusterPlan]
    why: str = ""


def k1q_route(B: int, L: int, E: int, H: int, F: int, C: int, T: int, Tm: int,
              dtype: torch.dtype) -> K1qRoute:
    """K1q's kernel for these shapes, chosen before any launch: for at
    most :data:`K1Q_WIDE_BATCH` rows the wide-row kernel where its shared
    memory fits, else the cluster kernel's int8 mode where
    :func:`cluster_plan` tiles the widths; for more rows the other way
    round.  Raises ValueError where neither kernel takes the shapes (heads
    that do not divide E: neither)."""
    if H < 1 or E % H:
        raise ValueError(f"fused int8 decode: {H} heads do not divide E={E}")
    smem = decode_smem_bytes(E, F, C, H, max(T, Tm), 16 // dtype.itemsize)
    if B <= K1Q_WIDE_BATCH and smem <= SMEM_LIMIT:
        return K1qRoute("wide", None, f"fused int8 decode: B={B} rows, at most {K1Q_WIDE_BATCH}")
    try:
        plan = cluster_plan(B, L, E, H, F, C, T, Tm, dtype, int8=True)
        return K1qRoute("cluster", plan)
    except ValueError as refused:
        why = str(refused)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{why}; and the wide-row int8 kernel's {smem} bytes of shared memory "
                         f"per CTA exceed {SMEM_LIMIT}")
    return K1qRoute("wide", None, why)


def _slices(w: FusedDecodeWeights, cw: ClusterWidths):
    """The slice [L, G, K, N] of each projection CTA h owns (qkv: the q, k
    and v columns of its Hc heads, part by part), each head's columns, the
    CTA's FF columns and the rows' E (as K or N) zero-padded
    (:func:`_cluster_shapes`), and the class head padded to [1, 1, Ep,
    Cp]."""
    L, E, _ = w.w_qkv.shape
    F = w.ff1_w.shape[2]
    G, Hc, hd, hdp, Fg, Fgp, Ep = cw.G, cw.Hc, cw.hd, cw.hdp, cw.Fg, cw.Fgp, cw.Ep
    H = G * Hc

    def pad(t, dim, n):  # zero-pad dimension dim of t up to n
        extra = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, n - t.shape[dim]]
        return torch.nn.functional.pad(t, extra)

    head = pad(pad(w.head_w, 1, cw.Cp), 0, Ep)
    f1 = pad(pad(w.ff1_w, 2, G * Fg).reshape(L, E, G, Fg), 3, Fgp)
    f2 = pad(pad(w.ff2_w, 1, G * Fg).reshape(L, G, Fg, E), 2, Fgp)
    return (pad(pad(w.w_qkv.reshape(L, E, 3, H, hd), 4, hdp).reshape(L, E, 3, G, Hc, hdp)
                .permute(0, 3, 1, 2, 4, 5).reshape(L, G, E, 3 * Hc * hdp), 2, Ep),
            pad(pad(w.w_out.reshape(L, H, hd, E), 2, hdp).reshape(L, G, Hc * hdp, E), 3, Ep),
            pad(pad(w.cw_q.reshape(L, E, H, hd), 3, hdp).reshape(L, E, G, Hc * hdp)
                .transpose(1, 2), 2, Ep),
            pad(pad(w.cw_o.reshape(L, H, hd, E), 2, hdp).reshape(L, G, Hc * hdp, E), 3, Ep),
            pad(f1.transpose(1, 2), 2, Ep),
            pad(f2, 3, Ep),
            head[None, None])


def _to_units(m: torch.Tensor, un: int, step: int = 16) -> torch.Tensor:
    """[A, B, K, N] -> its units [A, B, items, K/step, 32, vals]: unit
    (column tile c, k-step k) holds lane (g, q)'s k-values :func:`_kk` of
    columns c * un + nt * 8 + g, nt < un / 8: its mma.sync B fragments
    (bf16, m16n8k16: k 2q, 2q+1, 2q+8, 2q+9; int8, m16n8k32: k 4q..4q+3,
    16+4q..16+4q+3), or in float32 the same four k-values of one column."""
    A, B, K, N = m.shape
    ks, nc, nt, jn = K // step, N // un, un // 8, step // 4
    x = m.reshape(A, B, ks, step, nc, nt, 8).index_select(3, _kk(step).to(m.device))
    x = x.reshape(A, B, ks, 4, jn, nc, nt, 8).permute(0, 1, 5, 2, 7, 3, 6, 4)
    return x.reshape(A, B, nc, ks, 32, nt * jn)


def _from_units(x: torch.Tensor, K: int, N: int, un: int, step: int = 16) -> torch.Tensor:
    """The inverse of :func:`_to_units`."""
    A, B = x.shape[:2]
    ks, nc, nt, jn = K // step, N // un, un // 8, step // 4
    x = x.reshape(A, B, nc, ks, 8, 4, nt, jn).permute(0, 1, 3, 5, 7, 2, 6, 4)
    x = x.reshape(A, B, ks, step, nc, nt, 8).index_select(3, torch.argsort(_kk(step)).to(x.device))
    return x.reshape(A, B, K, N)


def _warp_passes(items: int):
    """The column tiles warp w reads, for each warp, as the kernel's
    ``project`` takes them: two at a time (c, c + 8; c = w, w + 16, ...),
    the last alone where c + 8 is past the end."""
    return [[(c, c + _WARPS) if c + _WARPS < items else (c,)
             for c in range(w, items, 2 * _WARPS)] for w in range(_WARPS)]


def _runs(parts) -> torch.Tensor:
    """Units [A, B, items, k-steps, 32, vals] of projections ``parts`` as
    the warps read them: warp by warp, each warp's passes of every part
    (:func:`_warp_passes`, the two tiles' k-steps interleaved) -> [A, B,
    units, 32, vals]."""
    return torch.cat([p[:, :, list(tiles)].transpose(2, 3).flatten(2, 3) for w in range(_WARPS)
                      for p in parts for tiles in _warp_passes(p.shape[2])[w]], 2)


def pack_cluster_tables(w: FusedDecodeWeights, num_heads: int) -> torch.Tensor:
    """The six projection tables and the class head of ``w`` (already in
    the compute type) as K1's cluster kernel reads them: one flat tensor of
    512-byte units (:func:`_to_units`), first per (layer, CTA h) the units
    of CTA h's slices, warp by warp, each warp's in the order it reads them
    (its column tiles of qkv, out, cross-q, cross-out, ff1 and ff2 two at a
    time, :func:`_warp_passes`, the two tiles' k-steps interleaved), then
    the class head's (padded with zero columns), which every CTA reads,
    warp by warp.  :func:`unpack_cluster_tables` is its inverse."""
    L, E, _ = w.w_qkv.shape
    F, C = w.ff1_w.shape[2], w.head_w.shape[1]
    cw = _cluster_shapes(E, num_heads, F, C, w.w_qkv.dtype)
    parts = [_to_units(m.detach(), cw.un) for m in _slices(w, cw)]
    return torch.cat([_runs(parts[:-1]).reshape(-1), _runs(parts[-1:]).reshape(-1)]).contiguous()


def pack_cluster_tables_int8(w: FusedDecodeWeights, num_heads: int) -> torch.Tensor:
    """K1q's weight units: ``w`` as :func:`quantize_fused_weights` leaves
    it (the six projection tables int8 in K1q's layout, the class head in
    the compute type) laid out as :func:`pack_cluster_tables` lays out K1's,
    but the six tables' units int8 m16n8k32 B fragments (32 deep, 16
    columns; widths padded to multiples of 32), the head's in the compute
    type.  One flat int8 tensor of bytes (the head's units after the
    layers', as bytes); :func:`unpack_cluster_tables_int8` is its
    inverse."""
    tables = {n: unpack_int8_table(getattr(w, n).detach()) for n in QUANTIZED}  # [L, in, out]
    L, E, _ = tables["w_qkv"].shape
    F, C = tables["ff1_w"].shape[2], w.head_w.shape[1]
    cw = _cluster_shapes(E, num_heads, F, C, w.head_w.dtype, int8=True)
    slices = _slices(w._replace(**tables, head_w=w.head_w.detach()), cw)
    layers = _runs([_to_units(m, cw.un, cw.ks) for m in slices[:-1]])
    head = _runs([_to_units(slices[-1], cw.hu)])
    return torch.cat([layers.reshape(-1), head.reshape(-1).view(torch.int8)]).contiguous()


def _unpack(blocks, cw: ClusterWidths, L: int, E: int, F: int, C: int) -> dict:
    """The tables, their padding dropped, from ``blocks``: the layers'
    units [L, G, U, 32, vals] and the head's [1, 1, UH, 32, vals]."""
    G, Hc, hd, hdp, Fg, shapes, kinds = cw.G, cw.Hc, cw.hd, cw.hdp, cw.Fg, cw.shapes, cw.kinds()
    items = [torch.zeros(A, B, N // u, K // k, 32, blk.shape[-1], dtype=blk.dtype,
                         device=blk.device)
             for (A, B), (K, N), (u, k), blk in zip([(L, G)] * 6 + [(1, 1)], shapes, kinds,
                                                     [blocks[0]] * 6 + [blocks[1]])]
    for block, ps in ((blocks[0], range(6)), (blocks[1], range(6, 7))):
        at = 0
        for w in range(_WARPS):
            for p in ps:
                for tiles in _warp_passes(items[p].shape[2])[w]:
                    n = items[p].shape[3] * len(tiles)
                    run = block[:, :, at:at + n].unflatten(2, (-1, len(tiles)))
                    items[p][:, :, list(tiles)] = run.transpose(2, 3)
                    at += n
    qkv, out, cq, co, f1, f2, head = (_from_units(x, K, N, u, k)
                                      for x, (K, N), (u, k) in zip(items, shapes, kinds))
    # the rows' padding (as K or N) dropped
    qkv, cq, f1, head = (m.narrow(2, 0, E) for m in (qkv, cq, f1, head))
    out, co, f2 = (m.narrow(3, 0, E) for m in (out, co, f2))

    def heads(m, dim):  # the padded heads' columns at dim -> [.., Hc, hd, ..]
        return m.unflatten(dim, (Hc, hdp)).narrow(dim + 1, 0, hd)

    qkv = heads(qkv.unflatten(3, (3, Hc * hdp)), 4)                    # [L, G, E, 3, Hc, hd]
    out, co = (heads(m, 2) for m in (out, co))                         # [L, G, Hc, hd, E]
    cq = heads(cq, 3)                                                  # [L, G, E, Hc, hd]
    return dict(
        w_qkv=qkv.permute(0, 2, 3, 1, 4, 5).reshape(L, E, 3 * E),
        w_out=out.reshape(L, E, E),
        cw_q=cq.transpose(1, 2).reshape(L, E, E),
        cw_o=co.reshape(L, E, E),
        ff1_w=f1[..., :Fg].transpose(1, 2).reshape(L, E, G * Fg)[..., :F],
        ff2_w=f2[:, :, :Fg].reshape(L, G * Fg, E)[:, :F],
        head_w=head[0, 0, :, :C])


def unpack_cluster_tables(packed: torch.Tensor, *, L: int, E: int, H: int, F: int,
                          C: int) -> dict:
    """The inverse of :func:`pack_cluster_tables`: the tables w_qkv, w_out,
    cw_q, cw_o, ff1_w, ff2_w [L, in, out] and head_w [E, C], their padding
    dropped."""
    cw = _cluster_shapes(E, H, F, C, packed.dtype)
    vals = 16 // packed.itemsize
    units = cw.unit_counts()
    n_layers = L * cw.G * sum(units[:-1]) * 32 * vals
    return _unpack((packed[:n_layers].reshape(L, cw.G, -1, 32, vals),
                    packed[n_layers:].reshape(1, 1, -1, 32, vals)), cw, L, E, F, C)


def unpack_cluster_tables_int8(packed: torch.Tensor, *, L: int, E: int, H: int, F: int,
                               C: int, dtype: torch.dtype) -> dict:
    """The inverse of :func:`pack_cluster_tables_int8` (the head in
    ``dtype``): the int8 tables w_qkv, w_out, cw_q, cw_o, ff1_w, ff2_w [L,
    in, out] and head_w [E, C], their padding dropped."""
    cw = _cluster_shapes(E, H, F, C, dtype, int8=True)
    n_layers = L * cw.G * sum(cw.unit_counts()[:-1]) * _UNIT
    return _unpack((packed[:n_layers].reshape(L, cw.G, -1, 32, 16),
                    packed[n_layers:].view(dtype).reshape(1, 1, -1, 32, 16 // dtype.itemsize)),
                   cw, L, E, F, C)


def fused_greedy_decode_cuda(w: FusedDecodeWeights, cross_k: torch.Tensor,
                             cross_v: torch.Tensor, *, num_heads: int,
                             steps: int, go_id: int = 0, eos_id: Optional[int] = None,
                             eps: float = 1e-5,
                             scales: Optional[FusedDecodeScales] = None,
                             cls0: Optional[torch.Tensor] = None,
                             packed: Optional[torch.Tensor] = None,
                             profile: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA decode kernel (K1, or with ``scales`` K1q; with
    ``cls0`` its step-0 row) on inputs :func:`check_kernel_inputs` accepts.
    K1 reads its weights as ``packed``, :func:`pack_cluster_tables` of
    ``w`` made once by the caller (required: it is never packed here), in
    clusters of :data:`CLUSTER_ROWS` rows (:func:`cluster_plan`, which
    raises ValueError for widths it cannot tile); with ``profile`` (int64
    [len(CLUSTER_PHASES)] on the device) it adds the cycles the first
    thread of CTA 0 spent in each phase.  K1q runs where :func:`k1q_route`
    says: on the cluster kernel with ``packed`` = :func:`pack_cluster_tables_int8`
    of ``w`` (required) and ``profile`` int64 [len(INT8_CLUSTER_PHASES)], or
    on the wide-row kernel, which reads no ``packed`` and keeps no profile.
    Returns logits [B, T, C]."""
    ids = [go_id] + ([] if eos_id is None else [eos_id])
    what = "fused decode" if scales is None else "fused int8 decode"
    L, B, Tm, E, F, C = check_kernel_inputs(w, cross_k, cross_v, num_heads=num_heads,
                                            steps=steps, class_ids=ids, what=what,
                                            scales=scales, cls0=cls0)
    dt, T, H, dev = w.b_qkv.dtype, steps, num_heads, cross_k.device
    if scales is None:
        plan = cluster_plan(B, L, E, H, F, C, T, Tm, dt)
        phases, maker, dtp = CLUSTER_PHASES, "pack_cluster_tables", dt
    else:
        route = k1q_route(B, L, E, H, F, C, T, Tm, dt)
        plan = route.plan
        phases, maker, dtp = INT8_CLUSTER_PHASES, "pack_cluster_tables_int8", torch.int8
        if plan is None and profile is not None:
            raise ValueError(f"{what}: the wide-row kernel ({route.why}) keeps no profile")
    if plan is not None:
        want = (L * plan.G * plan.units + plan.head_units) * _UNIT // dtp.itemsize
        if (packed is None or packed.dtype != dtp or packed.device != dev
                or not packed.is_contiguous() or packed.numel() != want):
            raise ValueError(f"{what}: packed must be {maker} of the tables, contiguous {dtp} "
                             f"on {dev} with {want} elements")
        if profile is not None and (profile.dtype != torch.int64 or profile.device != dev
                                    or profile.shape != (len(phases),)):
            raise ValueError(f"{what}: profile must be int64 [{len(phases)}] on {dev}")
    # caches zeroed before use, as the TPU kernel's are
    kc = torch.zeros(L, B, T, E, dtype=dt, device=dev)
    vc = torch.zeros_like(kc)
    logits = _logits_buffer(B, T, C, eos_id, dev)
    dims = (B, T, L, E, F, C, H, Tm, go_id, -1 if eos_id is None else eos_id)
    if scales is None:
        launch(launcher("fused_decode_cluster"), w, cross_k, cross_v,
               (kc, vc, logits, packed, profile), dims + (plan.smem, plan.G), num_heads=H,
               eps=eps, what=what, cls0=cls0)
        fused_greedy_decode_cuda.launches += 1
    elif plan is not None:
        launch(launcher("fused_decode_cluster", "fused_decode_cluster_int8"), w, cross_k,
               cross_v, (kc, vc, logits, packed, profile) + tuple(scales),
               dims + (plan.smem, plan.G), num_heads=H, eps=eps, what=what, cls0=cls0)
        fused_greedy_decode_cuda.launches_int8 += 1
    else:
        launch(launcher("fused_decode", "fused_decode_int8"), w, cross_k, cross_v,
               (kc, vc, logits) + tuple(scales), dims, num_heads=H, eps=eps, what=what,
               cls0=cls0)
        fused_greedy_decode_cuda.launches_int8_wide += 1
    if cls0 is not None:
        fused_greedy_decode_cuda.launches_cls0 += 1
    return logits


fused_greedy_decode_cuda.launches = 0  # K1 (float mode)
fused_greedy_decode_cuda.launches_int8 = 0  # K1q on the cluster kernel
fused_greedy_decode_cuda.launches_int8_wide = 0  # K1q on the wide-row kernel
fused_greedy_decode_cuda.launches_cls0 = 0  # any of them, with a cls0 row


def packed_units(w: FusedDecodeWeights, cross_k: torch.Tensor, *, num_heads: int, steps: int,
                 dtype: torch.dtype, scales: Optional[FusedDecodeScales],
                 units: Optional[Callable[..., torch.Tensor]]) -> Optional[torch.Tensor]:
    """The weight units the CUDA kernel will read, from the caller's
    ``units``: ``units(dtype)`` for K1, ``units(dtype, int8=True)`` for K1q
    where :func:`k1q_route` picks the cluster kernel; None where no units
    are read (the wide-row K1q) or the caller keeps none."""
    if units is None:
        return None
    if scales is None:
        return units(dtype)
    L, B, Tm, E = cross_k.shape
    route = k1q_route(B, L, E, num_heads, w.ff1_w.shape[2], w.head_w.shape[1], steps, Tm, dtype)
    return units(dtype, int8=True) if route.kernel == "cluster" else None


def fused_greedy_decode(w: FusedDecodeWeights, cross_k: torch.Tensor,
                        cross_v: torch.Tensor, *, num_heads: int, steps: int,
                        dtype: torch.dtype = torch.bfloat16, go_id: int = 0,
                        eos_id: Optional[int] = None, eps: float = 1e-5,
                        plain: bool = False,
                        scales: Optional[FusedDecodeScales] = None,
                        cls0: Optional[torch.Tensor] = None,
                        units: Optional[Callable[..., torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Greedy decode -> logits [B, steps, C] float32.

    cross_k/cross_v: [L, B, Tm, E] memory projections per layer.  Weights
    and cross K/V are cast to ``dtype`` (int8 tables stay int8).
    ``eos_id`` stops each row once it has emitted that token (see
    :func:`fused_greedy_decode_plain`).  ``scales`` (with the int8 tables
    of :func:`quantize_fused_weights`) selects the quantized mode.  ``cls0``
    [B, E] float32 replaces the [GO] embedding at step 0 (both versions
    raise on another type or shape).  CPU tensors (or ``plain=True``) take
    the plain version; CUDA tensors launch the kernel, with the units
    ``units`` returns (:func:`packed_units`: ``units(dtype)``,
    :func:`pack_cluster_tables` of ``w`` in ``dtype``, for K1;
    ``units(dtype, int8=True)``, :func:`pack_cluster_tables_int8`, for K1q
    on the cluster kernel; the caller keeps them, and they are asked for
    only where the kernel reads them).
    """
    w = cast_weights(w, dtype)
    ck = cross_k.detach().to(dtype).contiguous()
    cv = cross_v.detach().to(dtype).contiguous()
    kw = dict(num_heads=num_heads, steps=steps, go_id=go_id, eos_id=eos_id, eps=eps,
              scales=scales, cls0=None if cls0 is None else cls0.detach())
    if plain or ck.device.type == "cpu":
        return fused_greedy_decode_plain(w, ck, cv, **kw)
    packed = packed_units(w, ck, num_heads=num_heads, steps=steps, dtype=dtype, scales=scales,
                          units=units)
    return fused_greedy_decode_cuda(w, ck, cv, packed=packed, **kw)
