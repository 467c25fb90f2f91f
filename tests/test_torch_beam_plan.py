"""K4's grid kernel (kernels/fused_beam_grid.cu) on the CPU: what its launch
is, without a card.

* ``beam_plan``'s CTAs, tiles a phase, barriers a step and shared memory a
  CTA (within Hopper's 227 KB) at the flagship, at B = 1, 13 and 300, at
  the card tests' widths and at every beam width the kernel serves;
* a Python walk of the tiles as the kernel indexes them
  (``tile_outputs``): every (beam row, output column) of every phase is
  produced by exactly one tile, every top-K tile holds whole batch rows
  and every cross-attention tile reads the memory K/V of its own rows'
  batch rows.
"""

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu_torch.ops import fused_beam as fb
from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd

FLAGSHIP = dict(L=6, E=256, H=8, F=2048, C=97, T=25, Tm=26)
CARD = dict(L=2, E=64, H=4, F=128, C=97, T=8, Tm=8)  # tests/test_torch_cuda.py's widths


def _plan(B, K, dtype, w=FLAGSHIP, ctas=132):
    return fb.beam_plan(B, K, w["L"], w["E"], w["H"], w["F"], w["C"], w["T"], w["Tm"], dtype,
                        ctas=ctas)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,K,want", [
    # the flagship at B=192: 15 row tiles of 64 beam rows, 120 tiles in each
    # layer phase, 96 top-K tiles of 2 batch rows
    (192, 5, (15, (120, 120, 120, 120, 120, 120, 96), 2)),
    (1, 5, (1, (8, 8, 8, 8, 64, 8, 1), 1)),
    (13, 5, (2, (16, 16, 16, 16, 128, 16, 13), 1)),
    (300, 5, (24, (192, 96, 192, 96, 384, 96, 100), 3)),
])
def test_beam_plan_at_the_flagship(B, K, dtype, want):
    plan = _plan(B, K, dtype)
    assert (plan.row_tiles, tuple(p.tiles for p in plan.phases), plan.rows7) == want
    assert plan.ctas == 132 and plan.barriers == 6 * 6 + 1
    assert [p.name for p in plan.phases] == list(fb.BEAM_PHASES)
    assert plan.smem <= fd.SMEM_LIMIT
    assert plan.l2_step_bytes == sum(p.l2_bytes * (6 if p.per_layer else 1) for p in plan.phases)


@pytest.mark.parametrize("dtype,smem,positions", [(torch.bfloat16, 181760, 26),
                                                   (torch.float32, 178688, 18)])
def test_beam_smem_at_the_flagship(dtype, smem, positions):
    """A CTA's shared memory at the flagship (the product's weight-chunk
    ring, the layernorm's rows resident as its A operand, the residual
    rows, the bias, the row statistics; the top-K tile's logits, histories
    and per-beam scalars reuse it after the class head) fits Hopper's 227
    KB in both compute types, at five beams and at eight, the widest the
    kernel serves; the attention takes all 64 rows of a tile at once and
    stages every position's keys at once in bf16, 18 of 26 at a time in
    float32."""
    plan = _plan(192, 5, dtype)
    assert (plan.smem, plan.resident, plan.attn_rows, plan.positions) == (smem, True, 64,
                                                                          positions)
    wide = _plan(192, fb.MAX_BEAMS, dtype)
    assert wide.resident and max(plan.smem, wide.smem) <= fd.SMEM_LIMIT


def _cuda_core_smem(K, E, F, C, H, S, T, es):
    """Shared memory of the CUDA-core K4 (kernels/fused_beam.cu, PRs 6-10,
    one CTA a batch row), the only limit on what it served: per beam the
    residual, rounded input, FF hidden, projections, probabilities, scores
    and 256 threads' split-K sums in float32, the histories and scalars."""
    return 4 * K * (5 * E + F + H * S + C + 256 * (16 // es)) + 4 * K * (4 * T + 4)


@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_beam_plan_serves_the_cuda_core_kernels_largest_class_count(K, dtype):
    """At the flagship's widths, the most classes the CUDA-core K4 served
    (bf16: 52,424 at K=1, 5,934 at K=5, 1,576 at K=8) fit the grid
    kernel's plan, whose top-K tile reuses the product's shared memory."""
    w, es = FLAGSHIP, dtype.itemsize
    S = max(w["T"], w["Tm"])
    C = max(c for c in range(K, 60000, 1) if _cuda_core_smem(
        K, w["E"], w["F"], c, w["H"], S, w["T"], es) <= fd.SMEM_LIMIT)
    plan = fb.beam_plan(192, K, w["L"], w["E"], w["H"], w["F"], C, w["T"], w["Tm"], dtype)
    assert plan.smem <= fd.SMEM_LIMIT and plan.rows7 >= 1


@pytest.mark.parametrize("K", range(1, fb.MAX_BEAMS + 1))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_beam_plan_serves_every_width_the_cuda_core_kernel_served(K, dtype):
    """Seeded random widths (heads of 1 to 2,000 columns, FF columns,
    classes, steps and memory positions up to what one beam's shared
    memory could hold, B up to 5,000), kept where the CUDA-core K4's shared memory held them: the grid
    kernel's plan fits every one (the attention in smaller row groups or
    fewer positions at a time, narrower column tiles, fewer batch rows a
    top-K tile)."""
    rng = np.random.default_rng(K * 10 + dtype.itemsize)
    es, n = dtype.itemsize, 0
    room = fd.SMEM_LIMIT // (4 * K) - 256 * (16 // es) - 4  # floats a beam had left
    while n < 300:
        H = int(rng.choice([1, 2, 3, 4, 5, 8, 16, 32]))
        E = H * int(rng.integers(1, max(2, min(2000 if H == 1 else 300, room // (5 * H)))))
        F, C = int(rng.integers(1, room)), int(rng.integers(max(2, K), room))
        T, Tm = int(rng.integers(1, room // 8)), int(rng.integers(1, room // 8))
        if _cuda_core_smem(K, E, F, C, H, max(T, Tm), T, es) > fd.SMEM_LIMIT:
            continue
        n += 1
        B = int(rng.choice([1, 7, 192, 5000]))
        plan = fb.beam_plan(B, K, 2, E, H, F, C, T, Tm, dtype)
        assert plan.smem <= fd.SMEM_LIMIT and plan.positions >= 1 and plan.attn_rows >= 1


@pytest.mark.parametrize("K", range(1, fb.MAX_BEAMS + 1))
@pytest.mark.parametrize("B", [1, 7, 13, 64, 300])
def test_beam_plan_at_the_card_tests_widths(B, K):
    for dtype in (torch.float32, torch.bfloat16):
        plan = _plan(B, K, dtype, CARD)
        M = B * K
        assert plan.row_tiles == -(-M // fb.ROWS) and plan.barriers == 2 * 6 + 1
        assert 1 <= plan.rows7 and plan.rows7 * K <= 16
        assert plan.phases[6].tiles == -(-B // plan.rows7)
        assert plan.smem <= fd.SMEM_LIMIT


def test_beam_plan_refuses_a_top_k_tile_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        fb.beam_plan(2, 5, 2, 64, 4, 128, 20000, 6, 8, torch.float32)


@pytest.mark.parametrize("E,dtype,resident", [(512, torch.bfloat16, True),
                                              (512, torch.float32, False),
                                              (1024, torch.bfloat16, False)])
def test_wide_rows_are_staged_a_chunk_at_a_time(E, dtype, resident):
    """Rows too wide to stay in shared memory beside the weight ring take
    the chunked layernorm path; the plan still fits."""
    plan = fb.beam_plan(192, 5, 2, E, 8, 2048, 97, 25, 26, dtype)
    assert plan.resident == resident and plan.smem <= fd.SMEM_LIMIT and plan.positions >= 1


def _walk(plan, B, K, E, H, F, C):
    """Every tile of every phase through ``tile_outputs``; checks that each
    (row, column) is made once and returns the top-K tiles' rows and the
    cross-attention tiles' (rows, memory rows)."""
    M = B * K
    widths = (3 * E, E, E, E, F, E, C)
    tops, crosses = [], []
    for i, phase in enumerate(plan.phases):
        seen = torch.zeros(M, widths[i], dtype=torch.int32)
        for tile in range(phase.tiles):
            rows, cols, mem = fb.tile_outputs(plan, i, tile, B=B, K=K, E=E, H=H, F=F, C=C)
            assert len(rows) and len(rows) <= (fb.ROWS if i < 6 else plan.rows7 * K)
            seen[rows.start:rows.stop, list(cols)] += 1
            if i == 6:
                tops.append(rows)
            if i == 2:
                crosses.append((rows, mem))
        assert (seen == 1).all(), plan.phases[i].name
    return tops, crosses


@pytest.mark.parametrize("B,K,widths", [(192, 5, FLAGSHIP), (13, 5, FLAGSHIP), (7, 8, CARD),
                                        (300, 3, CARD), (1, 1, CARD)])
def test_every_output_is_made_by_one_tile(B, K, widths):
    w = widths
    plan = _plan(B, K, torch.bfloat16, w)
    tops, crosses = _walk(plan, B, K, w["E"], w["H"], w["F"], w["C"])
    for rows in tops:  # whole batch rows
        assert rows.start % K == 0 and rows.stop % K == 0
    for rows, mem in crosses:  # the memory of exactly its rows' batch rows
        assert list(mem) == sorted({r // K for r in rows})
