"""The launch of the BatchNorm backward kernel (``kernels/bn_backward.cu``),
on the CPU: ``bn_bwd_plan`` at the train step's 36 BatchNorm shapes, a
ragged N, C = 3 and a C of two channel groups, and a walk of the kernel's
rows that mirrors its index arithmetic: every row of every column summed
once in pass 1 and written once in pass 2, the ring of each thread never
overwriting a row before it is written, shared memory within one SM's
227 KB and the CTAs at most one wave."""

import functools
import math
from collections import Counter

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
from multimodal_scene_text_recognition_tpu_torch.models.layers import BatchNorm2d
from multimodal_scene_text_recognition_tpu_torch.models.model import SceneTextModel
from multimodal_scene_text_recognition_tpu_torch.ops import batchnorm as bn
import torch_threads

torch_threads.limit()

SMS = 132  # the H100's
SMEM_PER_SM = 232448  # the shared memory one CTA may take (227 KB)
THREADS, AHEAD = 256, 12  # kThreads and kAhead of the kernel


@pytest.fixture(scope="module")
def step_shapes():
    """(shape, count) of the BatchNorm inputs of one flagship train step at
    B=192, read off the model's BatchNorm inputs at B=1 (the batch changes
    no other dimension)."""
    torch.manual_seed(0)
    model = SceneTextModel(FLAGSHIP)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.register_forward_hook(lambda mod, inp, out: seen.append(
                (192,) + tuple(inp[0].shape[1:])))
    with torch.no_grad(), model.precision():
        model.features(model.rectify(torch.rand(1, 32, 100, 1)))
    return Counter(seen)


def _threads(plan, span, group):
    """The kernel's per-thread geometry in CTA (span, group): (row lane,
    first row, rows) of each thread that has rows, and the CTA's columns."""
    row_cols = plan.C // plan.V
    col0 = group * THREADS
    ncols = min(THREADS, row_cols - col0)
    lanes = THREADS // ncols
    r0 = plan.N * span // plan.spans
    r1 = plan.N * (span + 1) // plan.spans
    out = []
    for sub in range(lanes):
        if r0 + sub < r1:
            out.append((sub, r0 + sub, (r1 - r0 - sub + lanes - 1) // lanes))
    return out, lanes, ncols


@functools.lru_cache(maxsize=None)
def _ring(n, slots, tid=THREADS - 3):
    """One thread's ring through both passes, with the kernel's own offset
    arithmetic (``s = slot * kThreads + tid``, ``next_slot``, ``prev_slot``;
    two rows an iteration, pass 1 fetching kAhead rows ahead of its sums,
    pass 2 refilling the two slots it frees): returns the rows written in pass 2, in order, and the
    number fetched again; raises if an offset leaves the thread's column of
    the ring, a slot is overwritten before its row is read, or a row is read
    from a slot that does not hold it."""
    held = {}

    def next_slot(s):
        return s + THREADS if s + THREADS < slots * THREADS else tid

    def prev_slot(s):
        return (slots * THREADS + tid if s == tid else s) - THREADS

    def fetch(s, j):
        assert s % THREADS == tid and 0 <= s < slots * THREADS and s // THREADS == j % slots
        if s in held and not held[s][1]:
            raise AssertionError(f"slot {s} of row {held[s][0]} overwritten by row {j}")
        held[s] = [j, False]

    def read(s, j):
        assert held[s][0] == j, (j, held[s])
        held[s][1] = True

    sf = sc = tid

    def refill(j):
        nonlocal sf
        if j < n:
            fetch(sf, j)
            sf = next_slot(sf)

    for j in range(AHEAD):  # pass 1's prologue
        refill(j)
    for j in range(0, n, 2):  # two rows an iteration, both fetched ahead first
        refill(j + AHEAD)
        refill(j + 1 + AHEAD)
        for u in range(min(2, n - j)):
            read(sc, j + u)  # summed
            sc = next_slot(sc)
    for s in held:
        held[s][1] = False  # not yet written
    written, refetched = [], 0
    s = ((n - 1) % max(slots, 1)) * THREADS + tid
    for q in range(0, n, 2):  # pass 2: the slot a row frees takes the row `slots` older
        j = n - 1 - q
        pair = [(s, j)] + ([(prev_slot(s), j - 1)] if j > 0 else [])
        for sj, i in pair:
            read(sj, i)
            written.append(i)
        for sj, i in pair:
            if i >= slots:
                fetch(sj, i - slots)
                refetched += 1
        s = prev_slot(pair[-1][0])
    return tuple(written), refetched


def walk(plan):
    """Rows summed and written per column over the whole grid, and the rows
    the widest group keeps (never fetched again)."""
    row_cols = plan.C // plan.V
    summed = np.zeros((row_cols, plan.N), np.int64)
    written = np.zeros_like(summed)
    kept = 0
    for span in range(plan.spans):
        for group in range(plan.groups):
            threads, lanes, ncols = _threads(plan, span, group)
            cols = slice(group * THREADS, group * THREADS + ncols)
            for sub, first, n in threads:
                rows = first + lanes * np.arange(n)
                summed[cols, rows] += 1
                if plan.vec:
                    order, refetched = _ring(n, plan.slots)
                    assert sorted(order) == list(range(n))
                    if group == 0:
                        kept += n - refetched
                written[cols, rows] += 1
    return summed, written, kept


def _check(plan):
    assert plan.ctas == plan.spans * plan.groups <= SMS  # one CTA an SM, one wave
    assert plan.smem_bytes <= SMEM_PER_SM
    summed, written, kept = walk(plan)
    assert (summed == 1).all() and (written == 1).all()
    if plan.vec:
        assert kept == plan.rows_kept
        # a ring that wraps holds more rows than the copies in flight and
        # the two rows an iteration reads
        assert plan.slots >= plan.rows_per_thread or plan.slots > AHEAD + 1
    else:
        assert plan.slots == 0 and plan.rows_kept == 0
    nbytes = plan.N * plan.C * plan.itemsize
    assert plan.bound_bytes == 3 * nbytes
    assert plan.reread_bytes == 2 * nbytes - 2 * plan.rows_kept * plan.C * plan.itemsize
    assert 0 <= plan.l2_bytes <= plan.reread_bytes
    assert plan.bound_bytes <= plan.dram_bytes <= plan.bound_bytes + plan.reread_bytes


def test_step_shapes_are_the_flagships(step_shapes):
    """36 BatchNorms a step, 462,028,800 elements of x (1.848 GB of bf16 x
    and dy): the shapes the kernel's row in PERF.md is counted on."""
    assert sum(step_shapes.values()) == 36
    assert sum(n * math.prod(s) for s, n in step_shapes.items()) == 462_028_800
    assert step_shapes[(192, 512, 4, 26)] == 18 and step_shapes[(192, 64, 32, 100)] == 2


def test_plan_covers_the_step_shapes(step_shapes):
    """Every shape of the step in bf16: rows summed and written once, the
    ring sound, one wave of CTAs within shared memory; the shapes whose x
    and dy fit the ring across the grid (<= 27 MB) keep every row."""
    for (B, C, H, W) in step_shapes:
        plan = bn.bn_bwd_plan(B * H * W, C, 2, SMS, True)
        _check(plan)
        assert plan.vec and plan.V == 8 and plan.groups == 1 and plan.spans == SMS
        if 2 * B * C * H * W * 2 <= 27 * 2 ** 20:
            assert plan.rows_kept == plan.N and plan.reread_bytes == 0


def test_plan_bytes_of_a_step(step_shapes):
    """Summed over the step: the bound's 2.772 GB (x and dy read once, dx
    written once) and the expected DRAM traffic, under 1.3 times it."""
    bound = dram = 0
    for (B, C, H, W), n in step_shapes.items():
        plan = bn.bn_bwd_plan(B * H * W, C, 2, SMS, True)
        bound += n * plan.bound_bytes
        dram += n * plan.dram_bytes
    assert bound == 2_772_172_800
    assert bound < dram < 1.3 * bound


@pytest.mark.parametrize("N,C,itemsize,vec", [
    (231, 96, 2, True),        # ragged: fewer rows than lanes * spans
    (13_313, 64, 4, True),     # float32, N prime to the spans
    (4 * 5 * 9, 3, 2, False),  # C = 3: the scalar path
    (3 * 7 * 11, 3, 4, False),
    (1, 64, 2, True),          # one row
    (5_000, 4096, 2, True),    # two channel groups of 256 columns
    (700, 600, 4, False),      # three scalar groups, the last of 88 columns
    (50_000, 512, 2, True),    # rows past the ring: pass 2 fetches again
])
def test_plan_walk(N, C, itemsize, vec):
    _check(bn.bn_bwd_plan(N, C, itemsize, SMS, vec))


def test_plan_refuses():
    with pytest.raises(ValueError):
        bn.bn_bwd_plan(100, 12, 2, SMS, True)  # 12 bf16 channels are not 16 bytes
    with pytest.raises(ValueError):
        bn.bn_bwd_plan(100, 256 * 133, 4, SMS, False)  # 133 groups: more than a wave
    with pytest.raises(ValueError):
        bn.bn_bwd_plan(0, 64, 2, SMS, True)
