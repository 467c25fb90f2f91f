"""The geometry and order of P1 and P2, the probe's chain kernels
(``kernels/gemm_probe.cu``), on the CPU.

The kernels split a step: chain CTAs carry the first E = 256 columns from
step to step (16 rows each; P1's share the abs-max through their cluster)
and publish each step's A operand (P1 with its ``inv``); wide CTAs add the
other columns from that history afterwards, in step order.  An emulation of
that order in plain PyTorch must equal the plain chains: P1 bit for bit,
P2 within ``BF16_CHAIN_TOL``.  Then ``probe_plan`` against the kernels'
limits and the wrappers' refusals, a walk of its tiles, and the exact
integer tricks the kernel rounds and converts with.
"""

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu_torch.ops import gemm_probe as gp
from multimodal_scene_text_recognition_tpu_torch.ops.int8 import div
from multimodal_scene_text_recognition_tpu_torch.ops.precision import full_fp32
import torch_threads

torch_threads.limit()

E = gp.E
NARROW_F = 512  # the wide part's columns cost the CPU's int32 product most


def _abs_bits(x: torch.Tensor) -> torch.Tensor:
    """|x|'s bits as int64: ordered as |x| is, NaN above inf."""
    return (x.abs().view(torch.int32).to(torch.int64)) & 0xFFFFFFFF


def split_int8_chain(x, wq, ws, iters):
    """P1 in the kernel's order: each 16-row chain CTA takes the max of its
    rows' |x| bits, the cluster the max over the CTAs, every CTA the same
    inv; the chain's columns step by step, publishing (xq, inv); then the
    wide columns from that history, in step order."""
    B, F = x.shape[0], wq.shape[1]
    chain = B // 16
    acc_chain = torch.zeros(B, E)
    hist = []
    for _ in range(iters):
        per_cta = _abs_bits(x).view(chain, -1).amax(dim=1)
        m = per_cta.max().to(torch.int32).view(torch.float32)  # exact, NaN-propagating
        inv = div(127.0, torch.clamp(m, min=1e-12))
        xq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
        hist.append((xq, inv))
        out = gp._int_product(xq, wq[:, :E]).float() * div(ws[:, :E], inv)
        acc_chain = acc_chain + out
        x = out
    acc_wide = torch.zeros(B, F - E)
    for xq, inv in hist:
        acc_wide = acc_wide + gp._int_product(xq, wq[:, E:]).float() * div(ws[:, E:], inv)
    return torch.cat([acc_chain, acc_wide], dim=1)


def split_bf16_chain(x, wbf, iters):
    """P2 in the kernel's order: the chain's columns from bf16(x), the
    history of bf16 operands, then the wide columns from it."""
    w = wbf.float()
    acc_chain = torch.zeros(x.shape[0], E)
    hist = []
    with full_fp32():
        for _ in range(iters):
            a = x.bfloat16().float()
            hist.append(a)
            out = a @ w[:, :E]
            acc_chain = acc_chain + out
            x = out
        acc_wide = torch.zeros(x.shape[0], w.shape[1] - E)
        for a in hist:
            acc_wide = acc_wide + a @ w[:, E:]
    return torch.cat([acc_chain, acc_wide], dim=1)


@pytest.fixture(scope="module")
def narrow():
    x, wq, ws, wbf = gp.probe_inputs(0, device="cpu")
    return x, wq[:, :NARROW_F].contiguous(), ws[:, :NARROW_F].contiguous(), \
        wbf[:, :NARROW_F].contiguous()


def _x(kind, x):
    if kind == "ties":
        return gp.tie_input(0, device="cpu")
    if kind == "nan":
        x = x.clone()
        x[3, 5] = float("nan")
    return x


@pytest.mark.parametrize("kind,iters", [("normal", 1), ("normal", 4), ("ties", 1),
                                        ("ties", 4), ("nan", 1), ("nan", 4)])
def test_split_int8_order_is_bit_equal_to_the_plain_chain(narrow, kind, iters):
    x, wq, ws, _ = narrow
    x = _x(kind, x)
    got = split_int8_chain(x, wq, ws, iters)
    want = gp.int8_chain_plain(x, wq, ws, iters)
    if kind == "nan":
        assert torch.isnan(want).all()
    else:
        assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_split_int8_order_at_the_probes_width():
    """The whole F = 2048 at one step, as the kernel runs it."""
    x, wq, ws, _ = gp.probe_inputs(0, device="cpu")
    torch.testing.assert_close(split_int8_chain(x, wq, ws, 1), gp.int8_chain_plain(x, wq, ws, 1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("iters", [1, 4])
def test_split_bf16_order_is_within_the_chain_tolerance(narrow, iters):
    x, _, _, wbf = narrow
    got = split_bf16_chain(x, wbf, iters)
    want = gp.bf16_chain_plain(x, wbf, iters)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= gp.BF16_CHAIN_TOL[iters], err


def test_a_ctas_own_abs_max_would_break_bit_equality(narrow):
    """What the own-abs-max mutant of chip_smoke.py does: quantizing each
    16-row block with its own max gives other numbers at once."""
    x, wq, ws, _ = narrow
    xq_own = torch.cat([torch.clamp(torch.round(b * div(127.0, b.abs().amax())), -127, 127)
                        for b in x.view(-1, 16, E)])
    xq = torch.clamp(torch.round(x * div(127.0, x.abs().amax())), -127, 127)
    assert not torch.equal(xq_own, xq.view(-1, E))


PLANS = [  # (B, F, int8): chain CTAs, cluster, wide CTAs, wide tile, grid
    (192, 2048, True, 12, 12, 42, (64, 128), 60),
    (192, 2048, False, 12, 1, 84, (32, 128), 96),
    (64, 384, True, 4, 4, 1, (64, 128), 8),
    (64, 384, False, 4, 1, 2, (32, 128), 6),
    (96, 256, True, 6, 6, 0, (64, 128), 6),
    (32, 640, True, 2, 2, 3, (64, 128), 6),
]


@pytest.mark.parametrize("B,F,int8,chain,cluster,wide,tile,grid", PLANS,
                         ids=[f"B{p[0]}-F{p[1]}-{'int8' if p[2] else 'bf16'}" for p in PLANS])
def test_probe_plan_geometry(B, F, int8, chain, cluster, wide, tile, grid):
    plan = gp.probe_plan(B, F, int8)
    assert (plan.chain_ctas, plan.rows, plan.cluster, plan.wide_ctas, plan.wide_tile,
            plan.grid) == (chain, 16, cluster, wide, tile, grid)
    assert plan.smem_bytes <= gp.SMEM_LIMIT and plan.cluster <= 16
    es = 1 if int8 else 2
    want = chain * 4
    if wide:
        want += gp.ITERS * B * E * es + (gp.ITERS * chain * 16 if int8 else 0)
    assert plan.scratch_bytes == want


def test_probe_plan_shared_memory_at_the_probes_shapes():
    """Dynamic shared memory as the kernel lays it out (chain: the weight
    staged and 8 A operands; wide: its slice and a ring of 4), plus the
    static block of barriers and slots, under the H100's 232,448 bytes."""
    p1, p2 = gp.probe_plan(192, 2048, True), gp.probe_plan(192, 2048, False)
    assert p1.smem_bytes == max(256 + 8 * 16, 128 + 4 * 64) * 272 + gp._STATIC_SMEM
    assert p2.smem_bytes == max(256 + 8 * 16, 128 + 4 * 32) * 528 + gp._STATIC_SMEM
    assert max(p1.smem_bytes, p2.smem_bytes) <= 232_448


SHAPES = [(B, F) for B in (-32, 0, 16, 32, 48, 64, 100, 192, 256, 288, 512, 4096)
          for F in (128, 200, 256, 384, 1000, 2048)]


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_wrappers_refuse_exactly_what_probe_plan_refuses(int8):
    """``_shape``, the wrappers' shape check, raises ValueError for a (B, F)
    exactly where ``probe_plan`` does; P1 alone refuses B > 256 (16 chain
    CTAs a cluster)."""
    refused = []
    for B, F in SHAPES:
        try:
            gp.probe_plan(B, F, int8)
            plan_ok = True
        except ValueError:
            plan_ok = False
        x = torch.empty(max(B, 0), E, device="meta")
        w = torch.empty(E, F, device="meta")
        ws = torch.empty(1, F, device="meta") if int8 else None
        try:
            gp._shape("t", x, w, ws)
            shape_ok = True
        except ValueError:
            shape_ok = False
        assert plan_ok == shape_ok, (B, F)
        if not plan_ok:
            refused.append((B, F))
    assert ((288, 2048) in refused) == int8 and ((4096, 2048) in refused) == int8
    assert (100, 2048) in refused and (192, 1000) in refused and (192, 128) in refused
    assert (192, 2048) not in refused and (64, 384) not in refused


@pytest.mark.parametrize("B,F,int8", [(192, 2048, True), (192, 2048, False), (64, 384, True),
                                      (96, 384, True), (160, 640, True), (32, 256, False)])
def test_tiles_cover_every_output_once(B, F, int8):
    """The kernel's tiles (chain CTA c: rows 16c.., columns 0..256; wide
    CTA wi: rows R (wi / tiles).., at most R and no further than B, 128
    columns from 256 + 128 (wi % tiles)) write every element of out once,
    and each wide tile waits only on chain CTAs that exist."""
    plan = gp.probe_plan(B, F, int8)
    count = np.zeros((B, F), dtype=np.int64)
    for c in range(plan.chain_ctas):
        count[16 * c:16 * c + 16, :E] += 1
    R, C = plan.wide_tile
    tiles = (F - E) // C
    for wi in range(plan.wide_ctas):
        row0, col0 = wi // tiles * R, E + wi % tiles * C
        rows = min(R, B - row0)
        assert rows > 0 and rows % 16 == 0
        src = row0 // 16
        assert src + rows // 16 <= plan.chain_ctas
        count[row0:row0 + rows, col0:col0 + C] += 1
    assert (count == 1).all()
    assert plan.grid % plan.cluster == 0 and plan.grid >= plan.chain_ctas + plan.wide_ctas


def _quantize_like_the_kernel(y: np.ndarray) -> np.ndarray:
    """The kernel's quantize: y + 1.5 * 2^23 rounded by the float32 adder,
    its bits less 0x4B400000, clamped to +-127, NaN to 0."""
    y = y.astype(np.float32)
    q = (y + np.float32(12582912.0)).view(np.int32).astype(np.int64) - 0x4B400000
    q = np.clip(q, -127, 127)
    return np.where(np.isnan(y), 0, q)


def test_the_kernels_rounding_is_half_to_even_and_clamps():
    rng = np.random.default_rng(3)
    y = np.concatenate([rng.uniform(-130, 130, 100_000).astype(np.float32),
                        np.arange(-128, 128, dtype=np.float32) + np.float32(0.5),
                        np.float32([0.0, -0.0, 127.0, -127.0, 126.5, -126.5, 0.49999997,
                                    np.inf, -np.inf])])
    want = np.clip(np.round(y), -127, 127)  # numpy rounds half to even
    got = _quantize_like_the_kernel(y)
    finite = np.isfinite(y)
    np.testing.assert_array_equal(got[finite], want[finite])
    assert _quantize_like_the_kernel(np.float32([np.nan]))[0] == 0
    assert list(got[~finite]) == [127, -127]


def test_the_kernels_int_to_float_is_exact():
    """float(a) as the float with bits 0x4B400000 + a, less 1.5 * 2^23:
    exact for every int32 sum of a step (|a| <= 127 * 127 * 256)."""
    top = 127 * 127 * 256
    a = np.concatenate([np.arange(-2000, 2000), np.array([top, -top, top - 1, 1 - top]),
                        np.random.default_rng(4).integers(-top, top + 1, 100_000)])
    got = (a.astype(np.int64) + 0x4B400000).astype(np.int32).view(np.float32) \
        - np.float32(12582912.0)
    np.testing.assert_array_equal(got, a.astype(np.float32))
