"""Whole beam search in one kernel (JAX counterpart: ops/fused_beam.py,
with its ``cls0`` step-0 row).

Two versions of one function, ``(tokens [B, K, T] int32, scores [B, K]
float32)`` with the K beams of each row best first, from the stacked
decoder weights (``ops.fused_decode.FusedDecodeWeights``) and the per-layer
cross-attention K/V of the unexpanded batch (the K beams of a row share
one copy):

* :func:`fused_beam_decode_plain`, a PyTorch loop with the TPU kernel's
  exact casts.  The CPU path and the oracle of the kernel.
* :func:`fused_beam_decode_cuda`, the CUDA kernel
  ``kernels/fused_beam_grid.cu``, which replaces the TPU kernel
  ``ops/fused_beam.py::_beam_kernel``: one cooperative launch of a CTA an
  SM, each step 6L + 1 phases of tiles (tensor-core products over all B*K
  beam rows, the attention, then the top-K) between grid barriers;
  :func:`beam_plan` is its launch.

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
(a finished beam adds 0).  With ``cls0`` [B, E] float32 every one of a
row's K beams takes ``cls0[row] + pe[0]`` (float32, unrounded) as its
step-0 input in place of the [GO] embedding, as the TPU kernel stacks
``cls0`` K times; only beam 0 is live then, and the caches the others write
at step 0 are read through the ancestry map as any other.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import build
from .fused_decode import (SMEM_LIMIT, FusedDecodeWeights, cast_weights, check_cls0,
                           check_kernel_inputs, launch, launcher, plain_ops)

NEG = -1e9  # the score of a dead beam and of a taken or barred continuation


def fused_beam_decode_plain(w: FusedDecodeWeights, cross_k: torch.Tensor,
                            cross_v: torch.Tensor, *, beam_size: int, num_heads: int,
                            steps: int, go_id: int = 0, eos_id: int = 1, eps: float = 1e-5,
                            early_stop: bool = False, cls0: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
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
    check_cls0(cls0, B, E, dev, "fused beam")

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
        x = (cls0[:, None].expand(B, K, E) if t == 0 and cls0 is not None
             else f["emb"][tok]) + f["pe"][t]                   # [B, K, E]
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


MAX_BEAMS = 8  # beams a batch row (the widest search the kernel serves)

# -- the kernel's geometry (kernels/fused_beam_grid.cu) ------------------------

ROWS = 64  # beam rows of a product tile (kBM)
_MAX_BN, _LDW = 256, 264  # columns of a product pass, the weight chunk's row stride
_ROWS7 = 16  # beam rows of a top-K tile at most (kRows7)
_BNS = (32, 64, 128, 256)  # the column tiles a plan picks from
# the phases of a step, each a set of tiles and a grid barrier; the
# kernel's profile (``profile=``) has the cycles of each phase's work and
# of the barrier after it, then of the parts the phases share
BEAM_PHASES = ("qkv, self-attention", "out-proj", "cross-q, cross-attention", "cross-out",
               "ff1", "ff2", "head, top-K")
BEAM_PARTS = ("product: bias and first chunks", "product: waiting for a chunk",
              "product: out tile", "layernorm: normalizing", "attention: keys, values staged",
              "attention: scores", "attention: softmax", "attention: context", "epilogues",
              "top-K: candidates, extraction, fold, next rows",
              "product: issuing a chunk's copies", "product: a chunk's products",
              "layernorm: rows staged")
PROFILE_SLOTS = 2 * len(BEAM_PHASES) + len(BEAM_PARTS)


class BeamPhase(NamedTuple):
    """One phase of a step: ``tiles`` tiles (``per_layer``: a set each
    layer), each of ``rows`` beam rows (batch rows for the top-K) by
    ``cols`` output columns over depth ``k``; ``l2_bytes`` the operand and
    weight bytes its tiles read (each tile reads its A rows and its weight
    columns once)."""

    name: str
    tiles: int
    rows: int
    cols: int
    k: int
    per_layer: bool
    l2_bytes: int


class BeamPlan(NamedTuple):
    """The launch of K4: ``ctas`` CTAs (one an SM, all resident); row tiles
    of :data:`ROWS` beam rows (``row_tiles`` of them); column tiles of
    ``bn_out`` (out-proj, cross-out), ``bn_ff1`` and ``bn_ff2`` columns;
    top-K tiles of ``rows7`` batch rows; ``phases`` of a step and
    ``barriers`` grid barriers a step; ``smem`` bytes of shared memory a
    CTA; ``resident``: a layernorm's output rows [64][E] stay in shared
    memory as the A operand (else they are staged a chunk at a time); the
    attention takes a tile's rows ``attn_rows`` at a time and stages the
    keys or values of ``positions`` positions at a time; ``l2_step_bytes``
    of operands and weights read a step by the products and the class head
    (the attention's key and value reads not counted)."""

    ctas: int
    row_tiles: int
    bn_out: int
    bn_ff1: int
    bn_ff2: int
    rows7: int
    phases: Tuple[BeamPhase, ...]
    barriers: int
    smem: int
    resident: bool
    attn_rows: int
    positions: int
    l2_step_bytes: int


class _Layout(NamedTuple):
    smem: int
    resident: bool
    attn_rows: int
    positions: int


def _layout(K: int, E: int, H: int, C: int, T: int, Tm: int, es: int, bn: int,
            rows7: int) -> _Layout:
    """A CTA's shared memory, as the kernel's ``Layout``: the larger of (the
    product's weight-chunk ring, its A region (the chunk ring, or the
    resident rows where they fit), the residual rows of a column tile of
    ``bn``, the bias and the row statistics) and the top-K tile's logits,
    histories and per-beam scalars, which reuse shared memory once the class
    head's product is done (its rows are staged in the weight ring:
    ``smem`` is past the limit where they do not fit).  The attention
    reuses the ring and the A region for groups of ``attn_rows`` rows:
    ``positions`` of keys or values, the queries, scores and slots."""
    BK, stages = (64, 4) if es == 2 else (32, 3)
    vw = 16 // es
    hd = E // H
    hdp, S = -(-hd // vw) * vw, max(T, Tm)
    ldr = -(-E // BK) * BK + 8
    ring_w = stages * BK * _LDW * es
    a_ring, a_res = stages * ROWS * (BK + 8) * es, ROWS * ldr * es
    tail = 4 * ROWS * bn + 4 * _MAX_BN + 8 * ROWS
    resident = 4 * (ROWS + 2) * E <= ring_w and ring_w + max(a_res, a_ring) + tail <= SMEM_LIMIT
    a_region = max(a_res, a_ring) if resident else a_ring
    room, per_row = ring_w + a_region, 4 * (hdp + S + T)
    ra = ROWS
    while ra > 1 and ra * (per_row + hdp * es) > room:
        ra //= 2
    positions = min(S, max(0, room - ra * per_row) // (ra * hdp * es))
    R = rows7 * K
    top = -(-4 * (R * C + 2 * R * T + 6 * R + rows7) // 16) * 16
    smem = max(ring_w + a_region + tail, top) if 4 * R * E <= ring_w else SMEM_LIMIT + 1
    return _Layout(smem, resident, ra, positions)


def _pass_cols(nseg: int, w: int) -> int:
    """Columns a tile computes for nseg segments of w (each padded to 8)."""
    return nseg * (-(-w // 8) * 8)


def _pick_bn(N: int, k: int, a_bytes: int, w_bytes: int, row_tiles: int, ctas: int,
             bns: Tuple[int, ...] = _BNS) -> int:
    """The column tile of a product over N columns at depth k, of ``bns``:
    the one whose waves of tiles read the fewest operand and weight bytes a
    CTA (the smaller tile on a tie)."""
    def cost(bn):
        waves = -(-row_tiles * -(-N // bn) // ctas)
        return waves * (ROWS * k * a_bytes + k * min(bn, N) * w_bytes), bn
    return min(bns, key=cost)


def beam_plan(B: int, K: int, L: int, E: int, H: int, F: int, C: int, T: int, Tm: int,
              dtype: torch.dtype, ctas: int = 132) -> BeamPlan:
    """K4's launch for these widths on ``ctas`` SMs (``Layout`` in the
    kernel computes the same shared memory and checks it).  Raises
    ValueError where the top-K tile of one batch row, or one row's query
    and one position of a head's keys, does not fit a CTA's shared
    memory."""
    es, M = dtype.itemsize, B * K
    Mt = -(-M // ROWS)
    hd = E // H
    # the residual rows of a column tile sit beside the product's rings
    bns = tuple(bn for bn in _BNS if _layout(K, E, H, C, T, Tm, es, bn, 1).smem <= SMEM_LIMIT
                or bn == _BNS[0])
    bn_out = _pick_bn(E, E, es, es, Mt, ctas, bns)
    bn_ff1 = _pick_bn(F, E, 4, es, Mt, ctas)
    bn_ff2 = _pick_bn(E, F, es, es, Mt, ctas, bns)
    rows7 = max(1, min(_ROWS7 // K, -(-B // ctas)))
    layout = lambda r7: _layout(K, E, H, C, T, Tm, es, max(bn_out, bn_ff2), r7)  # noqa: E731
    while rows7 > 1 and layout(rows7).smem > SMEM_LIMIT:
        rows7 -= 1
    lay = layout(rows7)
    if lay.smem > SMEM_LIMIT or lay.positions < 1:
        raise ValueError(f"fused beam: {lay.smem} bytes of shared memory per CTA exceed "
                         f"{SMEM_LIMIT} (the top-K tile of one batch row, or one row's "
                         f"query and one position of a head's keys)")

    def product(name, tiles, cols, k, a_bytes, passes=1, res=0):
        return BeamPhase(name, tiles, ROWS, cols, k, True,
                         tiles * passes * ROWS * k * a_bytes + tiles * k * cols * es
                         + tiles * ROWS * res * 4)

    qkv_passes = 1 if _pass_cols(3, hd) <= _MAX_BN else 3 * -(-hd // _MAX_BN)
    cq_passes = -(-hd // _MAX_BN)
    n7 = -(-B // rows7)
    phases = (
        product(BEAM_PHASES[0], Mt * H, 3 * hd, E, 4, qkv_passes),
        product(BEAM_PHASES[1], Mt * -(-E // bn_out), bn_out, E, es, res=bn_out),
        product(BEAM_PHASES[2], Mt * H, hd, E, 4, cq_passes),
        product(BEAM_PHASES[3], Mt * -(-E // bn_out), bn_out, E, es, res=bn_out),
        product(BEAM_PHASES[4], Mt * -(-F // bn_ff1), bn_ff1, E, 4),
        product(BEAM_PHASES[5], Mt * -(-E // bn_ff2), bn_ff2, F, es, res=bn_ff2),
        BeamPhase(BEAM_PHASES[6], n7, rows7, C, E, False, n7 * E * C * es + M * E * 4))
    return BeamPlan(ctas=ctas, row_tiles=Mt, bn_out=bn_out, bn_ff1=bn_ff1, bn_ff2=bn_ff2,
                    rows7=rows7, phases=phases, barriers=6 * L + 1, smem=lay.smem,
                    resident=lay.resident, attn_rows=lay.attn_rows, positions=lay.positions,
                    l2_step_bytes=sum(p.l2_bytes * (L if p.per_layer else 1) for p in phases))


def tile_outputs(plan: BeamPlan, phase: int, tile: int, *, B: int, K: int, E: int, H: int,
                 F: int, C: int) -> Tuple[range, range, range]:
    """What tile ``tile`` of phase ``phase`` (an index of
    :data:`BEAM_PHASES`) produces, as the kernel indexes it: (its beam rows,
    the output columns it writes (qkv: of [q | k | v], 3E wide; the top-K:
    the C logits of its rows), the batch rows whose memory K/V it reads
    (the cross-attention; empty elsewhere))."""
    M, hd = B * K, E // H
    if phase == 6:
        b0 = tile * plan.rows7
        rows = range(b0 * K, min(B, b0 + plan.rows7) * K)
        return rows, range(C), range(0)
    N, bn, head = {0: (E, None, True), 1: (E, plan.bn_out, False), 2: (E, None, True),
                   3: (E, plan.bn_out, False), 4: (F, plan.bn_ff1, False),
                   5: (E, plan.bn_ff2, False)}[phase]
    nt = H if head else -(-N // bn)
    mt, n = divmod(tile, nt)
    rows = range(mt * ROWS, min(M, (mt + 1) * ROWS))
    if head:
        cols = [c for part in range(3 if phase == 0 else 1)
                for c in range(part * E + n * hd, part * E + (n + 1) * hd)]
    else:
        cols = range(n * bn, min(N, (n + 1) * bn))
    mem = range(rows.start // K, (rows.stop - 1) // K + 1) if phase == 2 else range(0)
    return rows, cols, mem


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_beam_decode_cuda(w: FusedDecodeWeights, cross_k: torch.Tensor,
                           cross_v: torch.Tensor, *, beam_size: int, num_heads: int,
                           steps: int, go_id: int = 0, eos_id: int = 1, eps: float = 1e-5,
                           early_stop: bool = False, cls0: Optional[torch.Tensor] = None,
                           profile: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA beam kernel (with ``cls0`` its step-0 row) on inputs
    that ``fused_decode.check_kernel_inputs`` accepts, with 1 <=
    ``beam_size`` <= min(MAX_BEAMS, C), on a CTA an SM of the tensors'
    device (:func:`beam_plan`, which raises for a top-K tile or a head's
    keys beyond the shared memory; the launch raises where the grid cannot
    be resident).
    With ``profile`` (int64 [PROFILE_SLOTS] on the device) it adds the
    cycles the first thread of CTA 0 spent in each phase and in the grid
    barrier after it, then in each of BEAM_PARTS.  Returns (tokens [B, K,
    T] int32, scores [B, K] float32)."""
    L, B, Tm, E, F, C = check_kernel_inputs(w, cross_k, cross_v, num_heads=num_heads,
                                            steps=steps, class_ids=(go_id, eos_id),
                                            what="fused beam", cls0=cls0)
    dt, K, T, H = w.w_qkv.dtype, beam_size, steps, num_heads
    if not 1 <= K <= min(MAX_BEAMS, C):
        raise ValueError(f"fused beam: beam_size {K} outside 1..{min(MAX_BEAMS, C)}")
    dev = cross_k.device
    plan = beam_plan(B, K, L, E, H, F, C, T, Tm, dt, ctas=_sm_count(dev))
    if profile is not None and (profile.dtype != torch.int64 or profile.device != dev
                                or profile.shape != (PROFILE_SLOTS,)):
        raise ValueError(f"fused beam: profile must be int64 [{PROFILE_SLOTS}] on {dev}")

    M = B * K
    # caches zeroed before use, as the TPU kernel's are
    kc = torch.zeros(L, B, K, T, E, dtype=dt, device=dev)
    vc = torch.zeros_like(kc)
    tokens = torch.empty(B, K, T, dtype=torch.int32, device=dev)
    scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    rows = torch.empty(2, M, E, dtype=torch.float32, device=dev)  # x, pre
    ctx = torch.empty(M, E, dtype=dt, device=dev)
    hid = torch.empty(M, F, dtype=dt, device=dev)
    anc = torch.empty(B, K, T, dtype=torch.int32, device=dev)
    state = torch.empty(2 * M + B + T, dtype=torch.int32, device=dev)
    logits = torch.empty(M, C, dtype=torch.float32, device=dev)
    launch(launcher("fused_beam_grid"), w, cross_k, cross_v,
           (kc, vc, tokens, scores, rows[0], rows[1], ctx, hid, anc, state, logits, profile),
           (B, T, L, E, F, C, H, Tm, go_id, eos_id, K, int(early_stop), plan.bn_out,
            plan.bn_ff1, plan.bn_ff2, plan.rows7, plan.ctas, plan.smem),
           num_heads=H, eps=eps, what="fused beam", cls0=cls0)
    fused_beam_decode_cuda.launches += 1
    if cls0 is not None:
        fused_beam_decode_cuda.launches_cls0 += 1
    return tokens, scores


fused_beam_decode_cuda.launches = 0
fused_beam_decode_cuda.launches_cls0 = 0  # with a cls0 row


def barrier_floor_cuda(n: int, device: torch.device, ctas: Optional[int] = None) -> None:
    """Launch K4's grid (``ctas`` CTAs, default one an SM of ``device``)
    doing nothing but ``n`` grid barriers: the floor of a step's phases.
    Raises where the launch fails."""
    fn = getattr(build.load("fused_beam_grid"), "fused_beam_barriers")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(_sm_count(device) if ctas is None else ctas, n,
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused beam barrier launch failed: CUDA error {rc}")


def fused_beam_decode(w: FusedDecodeWeights, cross_k: torch.Tensor, cross_v: torch.Tensor,
                      *, beam_size: int, num_heads: int, steps: int,
                      dtype: torch.dtype = torch.bfloat16, go_id: int = 0, eos_id: int = 1,
                      eps: float = 1e-5, early_stop: bool = False, plain: bool = False,
                      cls0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search -> (tokens [B, beam_size, steps] int32, scores
    [B, beam_size] float32), best first; scores are raw cumulative
    log-probabilities.

    cross_k/cross_v: [L, B, Tm, E] memory projections per layer, one per
    batch row.  Weights and cross K/V are cast to ``dtype``.  ``cls0``
    [B, E] float32 is every beam's step-0 row of its batch row (both
    versions raise on another type or shape).  CPU tensors (or
    ``plain=True``) take the plain version; CUDA tensors launch the kernel.
    """
    w = cast_weights(w, dtype)
    ck = cross_k.detach().to(dtype).contiguous()
    cv = cross_v.detach().to(dtype).contiguous()
    kw = dict(beam_size=beam_size, num_heads=num_heads, steps=steps, go_id=go_id,
              eos_id=eos_id, eps=eps, early_stop=early_stop,
              cls0=None if cls0 is None else cls0.detach())
    if plain or ck.device.type == "cpu":
        return fused_beam_decode_plain(w, ck, cv, **kw)
    return fused_beam_decode_cuda(w, ck, cv, **kw)
