"""K1q on the cluster kernel (kernels/fused_decode_cluster.cu, int8 mode) on
the CPU: its launch, its weight layout and its arithmetic across the
cluster, without a card.

* ``pack_cluster_tables_int8`` then ``unpack_cluster_tables_int8`` gives
  the int8 tables and the class head back exactly;
* a Python walk of the kernel's stream and of the mma.sync m16n8k32
  fragment layout (A: lane l = 4 g + q holds rows g and g + 8, k 4q..4q+3
  and 16+4q..16+4q+3; B: k 4q..4q+3 and 16+4q..16+4q+3 of column g; C:
  rows g and g + 8, columns 2q and 2q + 1) forms every projection of every
  CTA from the packed units as its warps read them, and the slices summed
  or joined over the cluster equal ``xq @ Wq`` bit for bit, padded widths
  included;
* the cluster's K-split on int32 partials, with the row abs-max taken over
  every CTA's slice, equals ``quantized_linear`` bit for bit; float32
  partials dequantized per CTA would not;
* the int8 plan for the flagship and the card tests' widths, its
  refusals, and the route ``k1q_route`` picks (the wide-row kernel for at
  most K1Q_WIDE_BATCH rows and for E=640);
* the decoder's int8 units are built once per parameter version, and the
  dispatch asks for them only where the cluster K1q runs, never on the CPU.
"""

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu_torch.models.decoders import TransformerDecoder
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd
from multimodal_scene_text_recognition_tpu_torch.ops.int8 import dequantize, div
import torch_threads

torch_threads.limit()

WARPS, R = 8, 16


def _weights(L, E, F, C, seed, dtype):
    """Seeded decoder tables, quantized: (int8 tables in K1q's layout with
    the rest in ``dtype``, scales)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    w = fd.FusedDecodeWeights(
        w_qkv=t(L, E, 3 * E), b_qkv=t(L, 3 * E), w_out=t(L, E, E), b_out=t(L, E),
        cw_q=t(L, E, E), cb_q=t(L, E), cw_o=t(L, E, E), cb_o=t(L, E), ff1_w=t(L, E, F),
        ff1_b=t(L, F), ff2_w=t(L, F, E), ff2_b=t(L, E), n1_s=t(L, E), n1_b=t(L, E),
        n2_s=t(L, E), n2_b=t(L, E), n3_s=t(L, E), n3_b=t(L, E), fn_s=t(E), fn_b=t(E),
        head_w=t(E, C), head_b=t(C), emb=t(C, E), pe=t(6, E))
    wq, scales = fd.quantize_fused_weights(w)
    return fd.cast_weights(wq, dtype), scales


# (L, E, H, F, C): the card tests' small widths, the flagship's (L cut),
# then widths whose slices are padded to the int8 k-step of 32: head slices
# 12 wide, FF slices 24 wide, rows 40 and 36 wide (padded to 64; three
# heads of 12 in a cluster of one).  The int8 tables take E and F in
# multiples of 4 (quantize_fused_weights).
SHAPES = [(2, 64, 4, 128, 97), (1, 256, 8, 2048, 97), (2, 48, 4, 128, 97),
          (2, 64, 4, 96, 97), (2, 40, 4, 128, 97), (1, 36, 3, 100, 97)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_pack_then_unpack_gives_the_tables_back(shape, dtype):
    L, E, H, F, C = shape
    w, _ = _weights(L, E, F, C, seed=E + H, dtype=dtype)
    packed = fd.pack_cluster_tables_int8(w, H)
    assert packed.dtype == torch.int8 and packed.dim() == 1 and packed.is_contiguous()
    plan = fd.cluster_plan(4, L, E, H, F, C, 6, 8, dtype, int8=True)
    assert packed.numel() == (L * plan.G * plan.units + plan.head_units) * 512
    back = fd.unpack_cluster_tables_int8(packed, L=L, E=E, H=H, F=F, C=C, dtype=dtype)
    assert set(back) == {"w_qkv", "w_out", "cw_q", "cw_o", "ff1_w", "ff2_w", "head_w"}
    for name, table in back.items():
        want = w.head_w if name == "head_w" else fd.unpack_int8_table(getattr(w, name))
        assert table.dtype == want.dtype and torch.equal(table, want), name


def _index_maps(E, H, F, cw, h):
    """Where the rows and columns of CTA h's padded slices come from in the
    [in, out] tables, written out from their definitions (-1: padding):
    the rows' Ep columns, its heads' columns (each head padded to hdp), its
    q, k and v columns, its FF columns."""
    rows = [e if e < E else -1 for e in range(cw.Ep)]
    heads = [(h * cw.Hc + j) * cw.hd + d if d < cw.hd else -1
             for j in range(cw.Hc) for d in range(cw.hdp)]
    qkv = [p * E + c if c >= 0 else -1 for p in range(3) for c in heads]
    ff = [h * cw.Fg + c if c < cw.Fg and h * cw.Fg + c < F else -1 for c in range(cw.Fgp)]
    return rows, heads, qkv, ff


def _take(m, rows, cols):
    """m[rows][:, cols] with zero rows and columns where an index is -1."""
    r, c = torch.tensor(rows), torch.tensor(cols)
    out = m[r.clamp(min=0)][:, c.clamp(min=0)].clone()
    out[r < 0] = 0
    out[:, c < 0] = 0
    return out


# lane (g, q) of a warp
_G, _Q = torch.arange(32) // 4, torch.arange(32) % 4


def _mma_s8(a, b):
    """mma.sync m16n8k32 s8 -> s32 on the lanes' fragments as the PTX ISA
    defines them: a [32, 4, 4] (four words of four int8 a lane), b [32, 2,
    4] -> d [32, 4] (int64)."""
    A = torch.zeros(16, 32, dtype=torch.int64)
    B = torch.zeros(32, 8, dtype=torch.int64)
    for word in range(4):
        row = _G + 8 * (word & 1)
        col = 4 * _Q + 16 * (word >> 1)
        for byte in range(4):
            A[row, col + byte] = a[:, word, byte].long()
    for word in range(2):
        for byte in range(4):
            B[4 * _Q + 16 * word + byte, _G] = b[:, word, byte].long()
    D = A @ B
    return torch.stack([D[_G + 8 * (i >> 1), 2 * _Q + (i & 1)] for i in range(4)], 1)


def _load_a(xp, k0):
    """FragQ::load_a: lane (g, q)'s words of rows g, g + 8 at k0 + 4q and
    k0 + 16 + 4q of the int8 rows xp [16, K] -> [32, 4, 4]."""
    words = []
    for word in range(4):
        row = _G + 8 * (word & 1)
        col = k0 + 4 * _Q + 16 * (word >> 1)
        words.append(torch.stack([xp[row, col + byte] for byte in range(4)], 1))
    return torch.stack(words, 1)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[4], SHAPES[5]])
def test_int8_units_form_every_projection_bit_for_bit(shape):
    """Walk each warp's run of each CTA's layer as project<FragQ> reads
    it (items w, w + 8, ... two at a time, their 32-deep k-steps
    interleaved), form its outputs with the emulated m16n8k32 products
    from the A fragments of seeded int8 rows, and join (N-split) or sum
    (K-split) the CTAs' slices: xq @ Wq exactly, every padding output 0."""
    L, E, H, F, C = shape
    w, _ = _weights(L, E, F, C, seed=7, dtype=torch.bfloat16)
    units = fd.pack_cluster_tables_int8(w, H).reshape(-1, 32, 16)
    plan = fd.cluster_plan(4, L, E, H, F, C, 6, 8, torch.bfloat16, int8=True)
    cw = fd._cluster_shapes(E, H, F, C, torch.bfloat16, int8=True)
    G = cw.G
    tables = {n: fd.unpack_int8_table(getattr(w, n)).long() for n in fd.QUANTIZED}
    rng = np.random.default_rng(8)
    inputs = {n: torch.from_numpy(rng.integers(-127, 128, (R, t.shape[1]), dtype=np.int64))
              for n, t in tables.items()}
    per_warp = lambda K, N: [(N // 16 // WARPS + (wp < N // 16 % WARPS)) * (K // 32)  # noqa: E731
                             for wp in range(WARPS)]
    runs = [sum(x) for x in zip(*(per_warp(K, N) for K, N in plan.shapes[:-1]))]
    assert sum(runs) == plan.units
    for l in range(L):
        full = {n: torch.zeros(R, t.shape[2], dtype=torch.int64) for n, t in tables.items()}
        for h in range(G):
            rows, heads, qkv, ff = _index_maps(E, H, F, cw, h)
            maps = {"w_qkv": (rows, qkv), "w_out": (heads, rows), "cw_q": (rows, heads),
                    "cw_o": (heads, rows), "ff1_w": (rows, ff), "ff2_w": (ff, rows)}
            outs = {n: torch.zeros(R, len(maps[n][1]), dtype=torch.int64) for n in tables}
            for wp in range(WARPS):
                at = (l * G + h) * plan.units + sum(runs[:wp])
                for name in fd.QUANTIZED:
                    kmap, nmap = maps[name]
                    xp = _take(inputs[name], list(range(R)), kmap)  # [R, K] padded
                    items = len(nmap) // 16
                    for c0 in range(wp, items, 2 * WARPS):
                        tiles = (c0, c0 + WARPS) if c0 + WARPS < items else (c0,)
                        acc = {c: torch.zeros(32, 2, 4, dtype=torch.int64) for c in tiles}
                        for k in range(len(kmap) // 32):
                            a = _load_a(xp, 32 * k)
                            for c in tiles:
                                b = units[at].reshape(32, 2, 2, 4)  # [lane, tile, word, byte]
                                for n in range(2):
                                    acc[c][:, n] += _mma_s8(a, b[:, n])
                                at += 1
                        for c in tiles:  # FragQ::each
                            for n in range(2):
                                for i in range(4):
                                    outs[name][_G + 8 * (i >> 1),
                                               c * 16 + n * 8 + 2 * _Q + (i & 1)] = acc[c][:, n, i]
                assert at == (l * G + h) * plan.units + sum(runs[:wp + 1])
            for name, out in outs.items():
                kmap, nmap = maps[name]
                xp = _take(inputs[name], list(range(R)), kmap)
                assert torch.equal(out, xp @ _take(tables[name][l], kmap, nmap)), name
                nm = torch.tensor(nmap)
                assert not out[:, nm < 0].any()  # padding columns come out 0
                if name in ("w_out", "cw_o", "ff2_w"):  # K-split: partial sums
                    full[name] += out[:, nm >= 0]
                else:  # N-split: this CTA's columns
                    full[name][:, nm[nm >= 0]] = out[:, nm >= 0]
        for name, t in tables.items():
            assert torch.equal(full[name], inputs[name] @ t[l]), name


def _cluster_quantized_linear(x, Wq, s, b, G, int32_partials=True):
    """K1q's K-split projection across a cluster of G CTAs, CTA h owning
    input columns h * K / G..: each CTA's abs-max of its slice of every
    row, exchanged; the row's abs-max the maximum over the G; each slice
    quantized with it and multiplied by its rows of Wq; then the owner's
    sum of the G partials, dequantized once (int32_partials), or float32
    partials dequantized by each CTA and then summed."""
    xs, ws = x.chunk(G, 1), Wq.chunk(G, 0)
    ax = torch.stack([xh.abs().amax(1, keepdim=True) for xh in xs]).amax(0)
    inv = div(127.0, torch.clamp(ax, min=1e-12))
    parts = [torch.clamp(torch.round(xh * inv), -127, 127).double() @ wh.double()
             for xh, wh in zip(xs, ws)]
    xscale = div(ax, 127.0)
    if int32_partials:
        acc = sum(p.to(torch.int32) for p in parts)  # exact, in rank order
        return dequantize(acc.float(), xscale, s, b)
    out = sum(dequantize(p.float(), xscale, s, None) for p in parts)
    return out + b


@pytest.mark.parametrize("K,G", [(256, 8), (2048, 8), (64, 4)])
def test_int32_k_split_equals_quantized_linear(K, G):
    """The K-split of out-proj and cross-out (K = E over G CTAs) and ff2
    (K = F): int32 partials are bit-equal to the TPU kernel's quantized
    lin; float32 partials dequantized per CTA round otherwise."""
    rng = np.random.default_rng(K + G)
    x = torch.from_numpy((rng.standard_normal((R, K)) * rng.uniform(0.1, 10, (R, 1)))
                         .astype(np.float32))
    x[3, : K // G] *= 50.0  # a row whose abs-max lies in the first CTA's slice only
    Wq = torch.from_numpy(rng.integers(-127, 128, (K, 256)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(1e-3, 1e-2, 256).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    want = fd.quantized_linear(x, Wq, s, b)
    assert torch.equal(_cluster_quantized_linear(x, Wq, s, b, G), want)
    floats = _cluster_quantized_linear(x, Wq, s, b, G, int32_partials=False)
    assert (floats != want).any()


@pytest.mark.parametrize("B,L,E,H,F,T,Tm,dtype,want", [
    # the flagship: 12 clusters of 8 CTAs at B=192, 1.147 MB a CTA a step
    # (K1: 2.228 MB)
    (192, 6, 256, 8, 2048, 25, 26, torch.bfloat16, (8, 12, 96, 160640, 352, 128, 1146880)),
    (192, 6, 256, 8, 2048, 25, 26, torch.float32, (8, 12, 96, 169088, 352, 256, 1212416)),
    (1, 6, 256, 8, 2048, 25, 26, torch.bfloat16, (8, 1, 8, 160640, 352, 128, 1146880)),
    (13, 6, 256, 8, 2048, 25, 26, torch.bfloat16, (8, 1, 8, 160640, 352, 128, 1146880)),
    (300, 6, 256, 8, 2048, 25, 26, torch.bfloat16, (8, 19, 152, 160640, 352, 128, 1146880)),
    # the card tests' widths: clusters of 4 (heads of 16, 12 and 10 and FF
    # slices of 24 padded to 32) and, with the rows padded to 64, of 1 (three
    # heads of 14); sixteen heads, two a CTA
    (64, 2, 64, 4, 128, 8, 8, torch.float32, (4, 4, 16, 100864, 32, 64, 65536)),
    (13, 2, 48, 4, 128, 6, 8, torch.bfloat16, (4, 1, 4, 98560, 32, 32, 49152)),
    (13, 2, 40, 4, 128, 6, 8, torch.bfloat16, (4, 1, 4, 98560, 32, 32, 49152)),
    (13, 2, 64, 4, 96, 6, 8, torch.bfloat16, (4, 1, 4, 98560, 32, 32, 49152)),
    (13, 2, 36, 3, 100, 6, 8, torch.bfloat16, (1, 1, 1, 118528, 104, 32, 122880)),
    (192, 6, 256, 16, 2048, 25, 26, torch.bfloat16, (8, 12, 96, 166784, 448, 128, 1441792)),
])
def test_int8_cluster_plan(B, L, E, H, F, T, Tm, dtype, want):
    plan = fd.cluster_plan(B, L, E, H, F, 97, T, Tm, dtype, int8=True)
    assert (plan.G, plan.clusters, plan.ctas, plan.smem, plan.units, plan.head_units,
            plan.cta_step_bytes) == want
    assert plan.R == 16 and plan.smem <= fd.SMEM_LIMIT
    route = fd.k1q_route(B, L, E, H, F, 97, T, Tm, dtype)
    if B > fd.K1Q_WIDE_BATCH:
        assert route.kernel == "cluster" and route.plan == plan
    else:  # small batches take the wide-row kernel
        assert route.kernel == "wide" and route.plan is None and f"B={B}" in route.why


@pytest.mark.parametrize("E,H,F,dtype,route,why", [
    (640, 8, 2048, torch.bfloat16, "wide", "exceeds"),  # rows wider than the exchange holds
    (1024, 8, 2048, torch.float32, "wide", "exceeds"),
    (512, 8, 16384, torch.float32, "wide", "shared memory"),  # the cluster's FF slice
    (256, 8, 49152, torch.bfloat16, None, "shared memory"),  # neither kernel's fits
    (64, 5, 128, torch.bfloat16, None, "do not divide"),
])
def test_int8_plan_refusals_and_route(E, H, F, dtype, route, why):
    with pytest.raises(ValueError, match=why):
        fd.cluster_plan(192, 6, E, H, F, 97, 25, 26, dtype, int8=True)
    if route is None:
        with pytest.raises(ValueError):
            fd.k1q_route(192, 6, E, H, F, 97, 25, 26, dtype)
        return
    r = fd.k1q_route(192, 6, E, H, F, 97, 25, 26, dtype)
    assert r.kernel == route and r.plan is None and why in r.why
    assert fd.decode_smem_bytes(E, F, 97, H, 26, 16 // dtype.itemsize) <= fd.SMEM_LIMIT


def _decoder():
    torch.manual_seed(0)
    dec = TransformerDecoder(num_classes=97, d_model=64, memory_dim=32, num_heads=4, ff_dim=128,
                             num_layers=2, max_text_length=6, int8=True)
    with torch.no_grad():  # the packed attention projections start uninitialised (torch.empty)
        for p in dec.parameters():
            p.normal_(0.0, 0.1)
    return dec


def test_decoder_repacks_its_int8_units_once_per_parameter_version():
    dec = _decoder()
    bf16 = torch.bfloat16
    packed = dec.cluster_tables(bf16, int8=True)
    assert torch.equal(packed, fd.pack_cluster_tables_int8(dec.fused_weights(bf16, int8=True)[0],
                                                           4))
    assert dec.cluster_tables(bf16, int8=True) is packed
    assert dec.cluster_tables(bf16) is not packed  # K1's units are kept apart
    assert dec.cluster_tables(bf16).dtype == bf16
    with torch.no_grad():
        dec.layer1.linear1.weight.add_(1.0)
    again = dec.cluster_tables(bf16, int8=True)
    assert again is not packed
    assert torch.equal(again, fd.pack_cluster_tables_int8(dec.fused_weights(bf16, int8=True)[0],
                                                          4))


def test_dispatch_asks_for_int8_units_only_where_the_cluster_k1q_runs():
    """``packed_units`` (what the dispatch hands the CUDA kernel) asks the
    caller for the int8 units where the cluster kernel runs K1q, for none
    where the wide-row kernel does (a small batch, E=640), and for K1's
    otherwise; on the CPU the plain version runs and nothing is asked
    for."""
    asked = []

    def units(dtype, int8=False):
        asked.append((dtype, int8))
        return "units"

    B = fd.K1Q_WIDE_BATCH + 1
    for E, rows, want in ((64, B, [(torch.bfloat16, True)]), (64, 2, []), (640, B, [])):
        w, scales = _weights(1, E, 128, 97, seed=3, dtype=torch.bfloat16)
        ck = torch.zeros(1, rows, 8, E, dtype=torch.bfloat16)
        asked.clear()
        got = fd.packed_units(w, ck, num_heads=4, steps=6, dtype=torch.bfloat16, scales=scales,
                              units=units)
        assert asked == want and got == ("units" if want else None)
    asked.clear()
    w, _ = _weights(1, 64, 128, 97, seed=3, dtype=torch.bfloat16)
    assert fd.packed_units(w, ck[..., :64], num_heads=4, steps=6, dtype=torch.bfloat16,
                           scales=None, units=units) == "units"
    assert asked == [(torch.bfloat16, False)]

    def refuse(dtype, int8=False):
        raise AssertionError("units asked for on the CPU")

    dec = _decoder()
    with torch.no_grad():
        out = dec.greedy_from_memory(torch.randn(3, 8, 64))
    assert out.shape == (3, 6, 97)
    dec.cluster_tables = refuse
    with torch.no_grad():
        assert torch.equal(dec.greedy_from_memory(torch.zeros(3, 8, 64)),
                           dec.greedy_from_memory(torch.zeros(3, 8, 64)))
