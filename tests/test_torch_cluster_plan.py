"""K1's cluster kernel (kernels/fused_decode_cluster.cu) on the CPU: what
its launch and its weight layout are, without a card.

* ``pack_cluster_tables`` then ``unpack_cluster_tables`` gives the tables
  back exactly;
* the packed units hold what the kernel reads: a Python walk of the
  kernel's stream (a warp's run of each layer at its offset, its column
  tiles w, w + 8, ... of each projection two at a time, their K / 16
  units interleaved by k-step) and
  of the mma.sync fragment layout (lane l = 4 g + q holds k-values 2q,
  2q + 1, 2q + 8, 2q + 9 of column g of each 8-column tile) finds every
  weight of every CTA's slices, and the zero padding of the class head;
* ``cluster_plan``'s G, R, grid, shared memory and weight bytes for the
  flagship, the card tests' widths and widths whose head or FF slices are
  padded (more than eight heads, slices not 16 wide), and its refusals;
* the decoder's repacked tables are built once and rebuilt after a
  parameter changes, and the dispatch asks for them only where K1 runs.
"""

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu_torch.models.decoders import TransformerDecoder
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd

WARPS, UNIT = 8, 512


def _weights(L, E, F, C, seed, dtype):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    w = fd.FusedDecodeWeights(
        w_qkv=t(L, E, 3 * E), b_qkv=t(L, 3 * E), w_out=t(L, E, E), b_out=t(L, E),
        cw_q=t(L, E, E), cb_q=t(L, E), cw_o=t(L, E, E), cb_o=t(L, E), ff1_w=t(L, E, F),
        ff1_b=t(L, F), ff2_w=t(L, F, E), ff2_b=t(L, E), n1_s=t(L, E), n1_b=t(L, E),
        n2_s=t(L, E), n2_b=t(L, E), n3_s=t(L, E), n3_b=t(L, E), fn_s=t(E), fn_b=t(E),
        head_w=t(E, C), head_b=t(C), emb=t(C, E), pe=t(6, E))
    return fd.cast_weights(w, dtype)


# (L, E, H, F, C): the card tests' small widths, the flagship's (L cut), a
# cluster of two and a class count under 32; then widths whose slices are
# padded: head slices 12 wide, sixteen heads in clusters of eight (two a
# CTA), FF slices 24 wide, and F=100 over four CTAs (25 each); rows not a
# multiple of 16 wide (E=40 and 42, padded to 48; three heads of 14)
SHAPES = [(2, 64, 4, 128, 97), (1, 256, 8, 2048, 97), (1, 32, 2, 32, 5),
          (2, 48, 4, 128, 97), (1, 256, 16, 2048, 97), (2, 64, 4, 96, 97), (1, 64, 4, 100, 97),
          (2, 40, 4, 128, 97), (1, 42, 3, 100, 97)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_then_unpack_gives_the_tables_back(shape, dtype):
    L, E, H, F, C = shape
    w = _weights(L, E, F, C, seed=E + H, dtype=dtype)
    packed = fd.pack_cluster_tables(w, H)
    assert packed.dtype == dtype and packed.dim() == 1 and packed.is_contiguous()
    back = fd.unpack_cluster_tables(packed, L=L, E=E, H=H, F=F, C=C)
    assert set(back) == {"w_qkv", "w_out", "cw_q", "cw_o", "ff1_w", "ff2_w", "head_w"}
    for name, table in back.items():
        assert torch.equal(table, getattr(w, name)), name


def _slices(w, L, E, H, F):
    """What CTA h owns of each projection, [K, N], written out from the
    tables' definitions: head h's q, k and v columns, its rows of the
    out-projection, ..."""
    hd, Fg = E // H, F // H
    cols = lambda h, n: slice(h * n, (h + 1) * n)  # noqa: E731
    return lambda l, h: [
        torch.cat([w.w_qkv[l][:, p * E:][:, cols(h, hd)] for p in range(3)], 1),
        w.w_out[l][cols(h, hd)], w.cw_q[l][:, cols(h, hd)], w.cw_o[l][cols(h, hd)],
        w.ff1_w[l][:, cols(h, Fg)], w.ff2_w[l][cols(h, Fg)]]


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_units_hold_what_the_kernel_reads(shape, dtype):
    L, E, H, F, C = shape
    w = _weights(L, E, F, C, seed=1, dtype=dtype)
    units = fd.pack_cluster_tables(w, H).reshape(-1, 32, 16 // dtype.itemsize)
    un = fd.unit_cols(dtype)
    plan = fd.cluster_plan(4, L, E, H, F, C, 6, 8, dtype)
    slices = _slices(w, L, E, H, F)
    head = torch.zeros(E, plan.Cp, dtype=dtype)
    head[:, :C] = w.head_w

    def per_warp(shapes):  # units a warp reads of these projections (Geometry::units)
        return [sum((N // un // WARPS + (wp < N // un % WARPS)) * (K // 16) for K, N in shapes)
                for wp in range(WARPS)]

    # lane (g, q)'s value v: k-value kk of column n of the unit's tile
    g, q = np.divmod(np.arange(32), 4)
    v = np.arange(16 // dtype.itemsize)
    kk = torch.from_numpy(2 * q[:, None] + (v % 4) % 2 + 8 * ((v % 4) // 2))
    n = torch.from_numpy((v // 4) * 8 + g[:, None])

    def read(at, mats):  # walk one warp's run from unit `at`; returns the next unit
        for m in mats:
            K, N = m.shape
            for c0 in range(wp, N // un, 2 * WARPS):  # two tiles a pass, k-steps interleaved
                for k in range(K // 16):
                    for c in (c0, c0 + WARPS) if c0 + WARPS < N // un else (c0,):
                        assert torch.equal(units[at], m[16 * k + kk, c * un + n])
                        at += 1
        return at

    layer_runs = per_warp(plan.shapes[:-1])
    assert sum(layer_runs) == plan.units
    for l in range(L):
        for h in range(H):
            for wp in range(WARPS):
                at = (l * H + h) * plan.units + sum(layer_runs[:wp])
                assert read(at, slices(l, h)) == at + layer_runs[wp]
    head_runs = per_warp(plan.shapes[-1:])
    assert all(r > 0 for r in head_runs) and sum(head_runs) == plan.head_units
    for wp in range(WARPS):
        at = L * H * plan.units + sum(head_runs[:wp])
        read(at, [head])
    assert units.shape[0] == L * H * plan.units + plan.head_units


@pytest.mark.parametrize("B,L,E,H,F,T,Tm,dtype,want", [
    # the flagship at B=192: 12 clusters of 8 CTAs, 2.228 MB a CTA a step
    (192, 6, 256, 8, 2048, 25, 26, torch.bfloat16, (8, 16, 12, 96, 147712, 16, 2228224)),
    (192, 6, 256, 8, 2048, 25, 26, torch.float32, (8, 16, 12, 96, 164608, 16, 4456448)),
    (1, 6, 256, 8, 2048, 25, 26, torch.bfloat16, (8, 16, 1, 8, 147712, 16, 2228224)),
    (300, 6, 256, 8, 2048, 25, 26, torch.bfloat16, (8, 16, 19, 152, 147712, 16, 2228224)),
    # the card tests' widths: clusters of 4, ragged tiles
    (13, 2, 64, 4, 128, 6, 8, torch.bfloat16, (4, 16, 1, 4, 93312, 16, 57344)),
    (300, 2, 64, 4, 128, 6, 8, torch.float32, (4, 16, 19, 76, 96896, 16, 114688)),
    # padded slices: sixteen heads, two a CTA of a cluster of 8 (the same
    # units as eight heads); head slices 12 wide padded to 16; FF slices 24
    # wide padded to 32
    (192, 6, 256, 16, 2048, 25, 26, torch.bfloat16, (8, 16, 12, 96, 147712, 16, 2228224)),
    (13, 2, 48, 4, 128, 6, 8, torch.bfloat16, (4, 16, 1, 4, 89728, 16, 43008)),
    (13, 2, 64, 4, 96, 6, 8, torch.float32, (4, 16, 1, 4, 96896, 16, 114688)),
    # rows padded to 48 columns: E=40 (four heads of 10) and E=42 (three of
    # 14, a cluster of three)
    (13, 2, 40, 4, 128, 6, 8, torch.bfloat16, (4, 16, 1, 4, 89728, 16, 43008)),
    (13, 2, 40, 4, 128, 6, 8, torch.float32, (4, 16, 1, 4, 92800, 16, 86016)),
    (13, 2, 42, 3, 100, 6, 8, torch.bfloat16, (3, 16, 1, 3, 90240, 16, 49152)),
])
def test_cluster_plan(B, L, E, H, F, T, Tm, dtype, want):
    plan = fd.cluster_plan(B, L, E, H, F, 97, T, Tm, dtype)
    assert (plan.G, plan.R, plan.clusters, plan.ctas, plan.smem, plan.depth,
            plan.cta_step_bytes) == want
    assert plan.smem <= fd.SMEM_LIMIT
    assert plan.call_bytes(T) == plan.ctas * plan.cta_step_bytes * T


@pytest.mark.parametrize("E,H,F,dtype,why", [
    (64, 5, 128, torch.bfloat16, "do not divide"),
    (1024, 8, 2048, torch.bfloat16, "exceeds"),  # rows wider than the exchange holds
    (512, 8, 2048, torch.float32, "shared memory"),
])
def test_cluster_plan_refuses_what_it_cannot_tile(E, H, F, dtype, why):
    with pytest.raises(ValueError, match=why):
        fd.cluster_plan(192, 6, E, H, F, 97, 25, 26, dtype)


def test_decoder_repacks_its_tables_once_per_parameter_version():
    torch.manual_seed(0)
    dec = TransformerDecoder(num_classes=97, d_model=64, memory_dim=32, num_heads=4, ff_dim=128,
                             num_layers=2, max_text_length=6)
    with torch.no_grad():  # the packed attention projections start uninitialised (torch.empty)
        for p in dec.parameters():
            p.normal_(0.0, 0.1)
    packed = dec.cluster_tables(torch.bfloat16)
    assert torch.equal(packed, fd.pack_cluster_tables(dec.fused_weights(torch.bfloat16), 4))
    assert dec.cluster_tables(torch.bfloat16) is packed
    with torch.no_grad():
        dec.layer1.linear2.weight.add_(1.0)
    again = dec.cluster_tables(torch.bfloat16)
    assert again is not packed
    assert torch.equal(again, fd.pack_cluster_tables(dec.fused_weights(torch.bfloat16), 4))


def test_dispatch_asks_for_the_packed_tables_only_where_k1_runs():
    """The decoder hands the dispatch its cache (``units``); on the CPU the
    plain version runs and the tables are never packed."""
    w = _weights(2, 64, 128, 97, seed=2, dtype=torch.float32)
    rng = np.random.default_rng(2)
    ck, cv = (torch.from_numpy(rng.standard_normal((2, 3, 8, 64)).astype(np.float32))
              for _ in range(2))

    def units(dtype):
        raise AssertionError("packed on the CPU")

    out = fd.fused_greedy_decode(w, ck, cv, num_heads=4, steps=6, dtype=torch.float32,
                                 units=units)
    assert out.shape == (3, 6, 97)
