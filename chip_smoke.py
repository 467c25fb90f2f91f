#!/usr/bin/env python3
"""Chip check of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--mutants]

Builds the port's CUDA kernels from source, holds each against its plain
PyTorch version on the card, serves the trained flagship recognizer through
``api.get_model`` -> ``Recognizer`` at B=192, and checks that the served run
went through the decode and warp kernels, with where the time of one served
call goes (stage times and the card's idle share).  Serves it again by beam
search (k=5, early stop, the fused beam kernel) and greedily with early
stop, and checks those runs went through the beam, early-stop decode and
warp kernels, with the beam call's time split the same way.  The float32
phases turn TF32 on first: the model must not use it.  Then trains the
flagship through ``api.get_trainer`` for a few steps at B=192, once with the
kernels and once with their plain versions from the same weights and
dropout seed, and checks that the two agree and that the training run went
through the warp and BatchNorm-backward kernels (K3: the whole backward,
sums and dx, one launch a BatchNorm); K3 is held against its plain version
at every BatchNorm shape of the step, and the step's device time is split
by kernel.  The int8 phase serves
the flagship in the JAX package's int8 mode (int8 loc-net, backbone and
encoder with the committed activation scales, the whole greedy loop in
K1q), greedily and by beam search, holds K1q against its plain version on
the trained decoder and the served strings against the plain path's, and
splits the served call's time by stage.  The semantic phase holds K1 (in
its float, early-stop and int8 modes) and K4 with a random semantic CLS
step-0 row (``cls0``) against their plain versions on the trained decoder,
then serves the semantic-fusion configuration (random weights from a seed:
no bundle holds trained fusion weights) through ``Recognizer.recognize(
crops, semantics=)`` with seeded objects, greedily, by beam search, with
the logit fusion and in int8, checks the cls0 launches, the strings
against the plain path's, and splits each call's time by stage, the
fusion MLPs as a stage of their own.  The stepper phases serve the
trained bundle with ``decode_fused=False`` greedily through the
single-position stepper in bf16 and f32, its strings held against K1's and
its time beside K1's; serve the semantic configuration with the three
per-layer fusion sites on greedily and by beam search through the stepper
(no K1 or K4 launch), hold its two beam forms against each other and 16 of
its rows in f32 against the same model on the CPU; train it for three
steps with the kernels and with their plain versions (36 K3 and 1 K2
launches a step); and serve crops of other sizes, resized on the host,
against the same crops resized by the plain routes.  The phase "train and
validate on the committed set" loads the committed synthetic set
(``api.get_dataset``), validates the trained flagship on its 512
validation crops through ``api.validate`` with the kernels and with their
plain versions (bf16 and f32) against the JAX package's accuracy
(JAX_VAL_ACC), trains it one epoch through ``api.train`` with device data
and validation every 10 steps, and one through the host prefetcher,
counting K1, K2 and K3 and timing the loop beside the bare train step,
then saves the trainer's full state, restores it into a fresh trainer
(bit-equal) and steps both.  The phase "classic recognizers" runs the
JAX package's BiLSTM-Attn and BiLSTM-CTC at full width with seeded random
weights: BiLSTM-Attn served at B=192 in float32 (TF32 allowed by the
caller) against the same model on the CPU, a differing string allowed
only at a CPU top-2 gap below CLASSIC_FLIP_GAP, then in bf16 with its K2
launch, ms, stage split and idle share; three train steps of each with
the kernels and with their plain versions (36 K3 and 1 K2 launches a
step); and one epoch of BiLSTM-CTC through ``api.train`` on the committed
set, whose loss must fall, then its CTC validation of the 512 crops.  The
phase "model variants" runs the other variants with seeded random
weights: Oscar-BERT (the Oscar encoder fusing the BERT embedder's tag
vectors, ``TagTokenizer`` rows of seeded tags in ``overlap``) served at
B=192 greedily (K1 with cls0) and by beam search (K4 with cls0) in bf16,
in float32 (TF32 allowed by the caller) against the plain path and the
CPU, and through the int8 backbone with K1q; BiLSTM-Attn through the int8
backbone; three train steps each of Oscar-BERT, the flagship with the
random semantic source and with ``remat``, kernels against plain, and
remat against the same steps without it (running statistics equal, both
peak memories).  The gemm probe phase holds the
int8-vs-bf16 probe's two chain kernels (P1, P2) against their plain
versions at 1, 4 and 30 steps, on a tie input and a NaN input, checks both
end all NaN at the probe's 200 steps, prints their launch plan
(``probe_plan``), times each against its bound, its plain version and the
same chain through library products, and runs the probe's own entry point.
Every phase prints one flushed line with the elapsed seconds; any failure raises and the script exits
non-zero.  ``--mutants`` also builds copies of the beam kernel with one
bf16 rounding dropped each (the ReLU outputs': rounded toward zero), of
K1q's cluster kernel with one of four faults each (three roundings, and
the abs-max of a K-split input taken over a CTA's own slice) and of its
wide-row kernel with one of the three roundings each (K1Q_WIDE_MUTANTS),
each held at the flagship and read at a padded or wide width, of K1 with one bf16 rounding dropped each (the ReLU outputs': rounded
toward zero; read with and without cls0), and of the probe's kernels with
one of four rounding faults or a chain CTA's own abs-max each
(PROBE_MUTANTS), and prints whether their limits catch them, of K3 with
one of four faults each (K3_MUTANTS: a CTA's partial sums dropped, dx
before the sums are final, the kept rows never written, dbeta's sign),
each of which its checks must catch; and copies of
K1 and of the probe's kernels with one part of their step left out each,
timed beside them (K1_TIMING_VARIANTS, PROBE_TIMING_VARIANTS).  The K1 phase prints K1's launch (its
cluster plan and the weight bytes a call reads from L2), its times
(``k1_times``: B=192 at full length and with early stop, B=1) and its
cycles by phase (``fused_greedy_decode_cuda(profile=)``); a second K1
phase holds it at widths it serves by padding or by grouping heads
(K1_WIDTHS).  The int8 phase prints K1q's plan, times (``k1q_times``),
cycles by phase and L2 bytes a call likewise, and holds it at widths its
units pad and at E=640, which its plan sends to the wide-row kernel
(K1Q_WIDTHS), and times both its kernels by batch (K1Q_SWEEP, behind the
route's K1Q_WIDE_BATCH).  The K4 phase prints its grid plan (``beam_plan``), its
times (``k4_times``: B=192 with early stop and at full length, B=1), the
floor of its grid barriers and its cycles by phase, barrier and part
(``fused_beam_decode_cuda(profile=)``).  A watchdog turns a hang into a
printed failure (exit code 3).

Output: per-phase lines, the ``nvidia-smi`` name/power-limit line, one JSON
line ``{"kernels": [...]}`` before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs no network and nothing outside the repository; imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

WATCHDOG_S = 600
BUNDLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "assets", "trained", "synth_openvocab_xxl.params.npz")
SCALES = BUNDLE.replace(".params.npz", ".scales.npz")  # persisted int8 activation scales
B = 192
# H100 SXM data-sheet peaks (dense): the card's least time for a given work
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
# K1 bf16 vs its plain version, max |logit diff| on the trained decoder at
# B=192 (logits of scale ~5).  On an H100 the kernel is 0.071 off (the
# CUDA-core design before it 0.070); with one of its bf16 roundings dropped
# (probabilities, q*K products, value products) or the ReLU outputs rounded
# toward zero (K1_MUTANTS) it was 0.111-0.231 off with every token still
# equal, so the limit sits between the two.
BF16_LOGIT_TOL = 0.1
# K3 vs its plain version (the whole backward, ops/batchnorm.bn_bwd_plain):
# dgamma and dbeta as the max over channels of |kernel - plain| over the sum
# of |terms| (at least 1).  Both sum float32 in another order: this kernel
# is 1.5e-7 to 3.8e-7 off on an H100 at the step's shapes (the sums-only
# kernel before it, on inputs without dy's offsets, 2.7e-9 to 3.2e-8); one
# element left out of the ragged shape's 231 per channel would be ~4e-3
# off, the last CTA's partial sums 7.6e-3 (K3_MUTANTS).  dx in
# float32 within BN_DX_TOL of its scale (max |dx|); in bfloat16 within one
# bf16 step of the plain value, or BN_DX_TOL of the scale where the step is
# smaller (near 0): the sums' last-bit differences move dx's float32 value
# by ~1e-7 of its terms, and so its rounding by at most one step.
BN_TOL = 1e-6
BN_DX_TOL = 1e-5
BN_SHAPES = (((192, 64, 32, 100), torch.bfloat16), ((192, 512, 4, 26), torch.bfloat16),
             ((192, 128, 16, 50), torch.float32), ((3, 96, 7, 11), torch.bfloat16))
# the BatchNorm inputs of one flagship train step at B=192 (bf16), by count:
# 36 launches, 462,028,800 elements (tests/test_torch_bn_plan.py reads them
# off the model; train_phase checks them against the step's own)
TRAIN_BN_SHAPES = {(192, 64, 32, 100): 2, (192, 128, 16, 50): 5, (192, 256, 8, 25): 7,
                   (192, 512, 4, 12): 1, (192, 32, 32, 100): 1, (192, 512, 4, 26): 18,
                   (192, 512, 2, 27): 1, (192, 512, 1, 26): 1}
# Broken copies of K3 (--mutants), each of which bn_mutant_caught must catch
# at BN_MUTANT_SHAPES: the last CTA's partial sums left out, dx read before
# the sums are final (no second grid barrier), the rows kept in shared memory
# never written, and the sign of dbeta's term.
K3_SOURCE = "bn_backward"
K3_MUTANTS = (
    ("one CTA's partial dropped", ("pg[i] = s < p.spans ?", "pb[i] = s < p.spans ?"),
     ("pg[i] = s < p.spans - 1 ?", "pb[i] = s < p.spans - 1 ?")),
    ("pass 2 before the sums are final", "grid.sync();  // the sums are final", ""),
    ("kept rows never written", "dx_row(x0, d0, at(j));",
     "if (q >= p.slots) dx_row(x0, d0, at(j));"),
    ("dbeta term's sign", "__fsub_rn(__fsub_rn(df[k], bn[k])", "__fsub_rn(__fadd_rn(df[k], bn[k])"),
)
BN_MUTANT_SHAPES = (((192, 64, 32, 100), torch.bfloat16), ((192, 512, 4, 26), torch.bfloat16),
                    ((16, 512, 4, 26), torch.float32))
# Copies of K3 that stop early (--mutants), timed at TRAIN_BN_SHAPES beside
# it: what a launch costs, and what the sums and pass 1 cost without dx.
K3_TIMING_VARIANTS = (
    ("launch only", "  cg::grid_group grid = cg::this_grid();\n",
     "  if (p.N > 0) return;\n  cg::grid_group grid = cg::this_grid();\n"),
    ("pass 1 and the CTAs' partial sums", "grid.sync();  // every CTA's partial sums are written",
     "return;"),
    ("the sums, without pass 2", "grid.sync();  // the sums are final",
     "grid.sync();\n  return;"),
)
TRAIN_STEPS = 3
# Kernel vs plain training runs (same weights, batch and dropout masks),
# relative differences.  A step's gradient is bitwise repeatable on the card,
# but in bf16 a rounding-level change flips roundings that the backward
# spreads: on an H100 the kernels' float32-level differences from their plain
# versions (K2 ~1e-7, K3 ~1e-8) moved the first step's loss by 9.7e-5 (K2's
# forward) and its gradient norm by 6.2e-3 (K3 alone: loss unchanged, norm
# 3.9e-4).  After the first AdamW update the runs part faster: Adam's first
# steps move every parameter by about the learning rate whatever the size of
# its gradient, and the gradient norms of steps 2 and 3 parted by 4-12% (two
# plain runs, which differ from step 2 on through the backward's
# nondeterministic ops, by 0.9-4.5% at step 3; the phase prints both).  So
# the gradient norm is held at step 1 only, the loss at every step (measured
# 6.2e-5 and 5.4e-4 to 6.7e-4 at steps 2 and 3).
TRAIN_LOSS_TOL = (1e-3, 5e-3, 5e-3)
TRAIN_NORM_TOL = 3e-2
BEAM = 5
# K4 bf16 vs its plain version on the trained decoder at B=192, K=5, as
# shares of beams identical up to their first [s].  On an H100 the kernel
# has every best beam and 98.33% of all 960 beams identical (a rounding that
# lands the other way swaps two close candidates), its best scores 0.026
# off.  With one of its bf16 roundings dropped (probabilities, q*K products,
# cross-attention value products or ReLU outputs: --mutants) it had 98.96-
# 100% of the best beams and 96.67-97.92% of all beams identical, so the
# all-beam limit sits between the two and catches all four, the best-beam
# one three.  The best scores (0.021-0.040 off for the mutants) separate
# nothing: their limit bounds the rounding noise.
BEAM_BF16_BEST_AGREE = 0.995
BEAM_BF16_ALL_AGREE = 0.98
BEAM_BF16_SCORE_TOL = 0.05
# K1q vs its plain version on the trained decoder at B=192.  Its int8
# products are exact in both, so they differ only where the attention and
# layernorm sums (other orders) move an activation across a rounding
# boundary of its int8 step.  On an H100 the kernel is 0.108 (f32) and
# 0.099 (bf16) off in the logits, every [s]-pruned row identical.  Three
# faulty copies (--mutants: roundf for rintf, quantizing the bf16-rounded
# input, rounding the ReLU output) were 0.90-20.9 off in bf16 with 97.4-
# 99.5% of the rows identical, so the logit limit sits between the two and
# catches all three, the row limit two.
K1Q_F32_LOGIT_TOL = 0.3
K1Q_BF16_LOGIT_TOL = 0.3
K1Q_BF16_AGREE = 0.99
# The served semantic configuration has random weights (no bundle holds
# trained fusion weights); its strings, kernels vs plain versions, are held
# at 100% in float32.  In bf16 and int8 an H100 read 100% (greedy, the
# logit fusion, int8) and 99.48% (beam: one beam swap); the limits are the
# flagship's bf16 and int8 ones.  These random decoders emit one class for
# every row and step, so the strings show the path more than the numerics,
# which the cls0 kernel checks hold on the trained decoder.
SEM_BF16_AGREE = 0.98
SEM_INT8_AGREE = 0.98
# K1 and K1e bf16 with a random N(0, 1) cls0 vs their plain versions on the
# trained decoder, max |logit diff|.  An H100 read 0.112 (K1) and 0.098
# (K1e), over BF16_LOGIT_TOL: the random step-0 row lies outside what the
# trained decoder sees, and its larger activations round larger.  With
# cls0 the four K1_MUTANTS (--mutants) read 0.259-3.17, so the limit sits
# between the two and catches all four.  Row 151 has a near tie at step 7
# (the plain version's top two logits 0.0037 apart): a K1 whose sums take
# another order can flip that token, and the row's later logits then read
# ~0.26 off (K1 with split-K sums did, on an H100; PERF.md).
CLS0_BF16_LOGIT_TOL = 0.2
# The JAX package's word accuracy (%) on the committed 512 validation crops
# with the trained bundle, greedy through its XLA scan at B=192 (zero crops
# pad the last batch), measured once on the CPU by its own api:
#   JAX_PLATFORMS=cpu python -c "from multimodal_scene_text_recognition_tpu
#   import api; from multimodal_scene_text_recognition_tpu.core.config import
#   Config, ModelConfig; print(api.validate(api.get_model('assets/trained/
#   synth_openvocab_xxl.params.npz', Config(model=ModelConfig(
#   compute_dtype='bfloat16')))))"
# (and compute_dtype='float32'): 494 of 512 in both.  The port's kernel
# path must come within VAL_ACC_TOL points of it.
JAX_VAL_ACC = {"bfloat16": 96.48438, "float32": 96.48438}
VAL_ACC_TOL = 1.0
# the phase "train and validate on the committed set": one epoch of the
# 4096 training crops at B=192 (21 steps), validating every 10 steps
LOOP_STEPS = 21
LOOP_VALIDATION_STEPS = 10
RESUME_LOSS_TOL = 1e-5

T0 = time.time()
PHASE = ["start"]


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f} s] {msg}", flush=True)


def phase(name: str) -> None:
    PHASE[0] = name
    log(f"phase {name}")


def _watchdog() -> None:
    print(f"chip_smoke: watchdog fired in phase {PHASE[0]} after "
          f"{time.time() - T0:.1f} s", flush=True)
    try:
        from multimodal_scene_text_recognition_tpu_torch.kernels import build
        build.kill_running()
    finally:
        os._exit(3)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time in ms of one ``fn()`` call: the summed durations of
    the kernels it launches, by ``torch.profiler``.  CUDA events over
    back-to-back calls also count the host's launch cost wherever a call's
    device work is shorter than it (tens of microseconds here).  Raises
    where the profiler saw no kernel of the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no kernel of the timed calls run on the card")
    return busy_us / 1e3 / iters


_FLUSH = []  # a 128 MB buffer, written to push what a call reads out of the 50 MB L2


def queued_ms(fn, reps: int = 5, cold: bool = False) -> float:
    """Mean ms of one ``fn()`` on the card, by CUDA events around the call
    alone: a spin kernel holds the card until the call is queued behind it,
    so the events bracket the call's device work and not the host's launch
    of it (no profiler).  ``cold``: 128 MB are written before each timed
    call (the L2 holds 50)."""
    if cold and not _FLUSH:
        _FLUSH.append(torch.empty(32 << 20, dtype=torch.float32, device="cuda"))
    fn()
    total = 0.0
    for _ in range(reps):
        if cold:
            _FLUSH[0].fill_(1.0)
        torch.cuda._sleep(1_000_000)  # ~0.5 ms, longer than any launch here
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_crops(n: int, seed: int):
    """Seeded uint8 32x100 crops: a background level, a few dark or light
    strokes and bars (glyph-like structure), and pixel noise."""
    rng = np.random.default_rng(seed)
    crops = []
    for _ in range(n):
        bg = rng.uniform(40, 215)
        img = np.full((32, 100), bg)
        ink = 255 - bg + rng.uniform(-30, 30)
        x = rng.integers(2, 12)
        while x < 92:
            w = rng.integers(2, 5)
            h0, h1 = sorted(rng.integers(4, 29, 2))
            img[h0:h1 + 2, x:x + w] = ink
            if rng.random() < 0.5:
                y = rng.integers(6, 26)
                img[y:y + 2, x:x + rng.integers(4, 9)] = ink
            x += w + rng.integers(3, 9)
        img += rng.normal(0, 8, img.shape)
        crops.append(np.clip(img, 0, 255).astype(np.uint8))
    return crops


def grid_sample_inputs():
    """Seeded K2 inputs at B=192: crops [192, 32, 100, 1] and grids [192,
    32, 100, 2] with points outside [-1, 1], on integer pixel coordinates
    and on both corners."""
    rng = np.random.default_rng(0)
    H, W = 32, 100
    img = torch.from_numpy(rng.random((B, H, W, 1), dtype=np.float32)).cuda()
    g = ((rng.random((B, H, W, 2)) * 2 - 1) * 1.3).astype(np.float32)
    flat = g.reshape(B, -1, 2)
    n = flat.shape[1] // 4
    flat[:, :n, 0] = 2.0 * rng.integers(0, W, n) / (W - 1) - 1.0
    flat[:, :n, 1] = 2.0 * rng.integers(0, H, n) / (H - 1) - 1.0
    flat[:, n:n + 16] = [1.0, 1.0]
    flat[:, n + 16:n + 32] = [-1.0, -1.0]
    flat[:, n + 32:2 * n] *= 4.0
    return img, torch.from_numpy(g).cuda()


def check_grid_sample(gs):
    """K2 against its plain version at B=192 on ``grid_sample_inputs``."""
    img, grid = grid_sample_inputs()
    H, W = img.shape[1:3]
    out = gs.grid_sample_cuda(img, grid)
    ref = gs.grid_sample_plain(img, grid)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    log(f"grid_sample kernel vs plain: max |diff| {err:.3e} (limit 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"grid_sample kernel disagrees with its plain version: {err}")

    nchw = img.permute(0, 3, 1, 2).contiguous()
    lib = torch.nn.functional.grid_sample(nchw, grid, mode="bilinear",
                                          padding_mode="border", align_corners=True)
    lib_err = (lib.permute(0, 2, 3, 1) - ref).abs().max().item()
    calls = (lambda: gs.grid_sample_cuda(img, grid), lambda: gs.grid_sample_plain(img, grid),
             lambda: torch.nn.functional.grid_sample(
                 nchw, grid, mode="bilinear", padding_mode="border", align_corners=True))
    ms, plain_ms, library_ms = (device_ms(f) for f in calls)
    events = [cuda_ms(f, n, warmup=3) for f, n in zip(calls, (200, 10, 200))]
    N = H * W
    bound_ms, bound_by = bound(B * (H * W + 3 * N) * 4, B * N * 20, PEAK_F32_FLOPS)
    log(f"grid_sample, device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"F.grid_sample {library_ms:.4f} ms (max |diff| {lib_err:.2e}), "
        f"bound {bound_ms:.4f} ms ({bound_by}); by CUDA events over back-to-back calls "
        f"{events[0]:.4f} / {events[1]:.4f} / {events[2]:.4f} ms")
    return dict(name="grid_sample", route="cuda",
                source="multimodal_scene_text_recognition_tpu_torch/kernels/grid_sample.cu",
                replaces="multimodal_scene_text_recognition_tpu/ops/grid_sample.py:105",
                jax="ops/grid_sample.py::_grid_sample_kernel",
                max_abs_err=err, max_abs_err_f32=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                ms_events=events[0], plain_ms_events=events[1], library_ms_events=events[2])


def bn_inputs(shape, dtype, seed: int):
    """x and dy (a per-channel offset on unit noise each, so that dbeta's
    term of dx counts), both channels-last as the backbone's convs hand
    them over, x's float32 batch mean and rstd, and a float32 weight near 1,
    on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C, cl = shape[1], torch.channels_last

    def act():
        return (torch.randn(shape, generator=g, device="cuda")
                + torch.randn((1, C, 1, 1), generator=g, device="cuda")).to(dtype).contiguous(
                    memory_format=cl)

    x, dy = act(), act()
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    rstd = torch.rsqrt(xf.var(dim=(0, 2, 3), unbiased=False) + 1e-5)
    weight = 1.0 + 0.1 * torch.randn(C, generator=g, device="cuda")
    return x, dy, mean, rstd, weight


def library_bn_backward(x, dy, mean, rstd, weight):
    """(dx, dgamma, dbeta) by one PyTorch call, the yardstick of K3 (never
    on the port's path)."""
    return torch.ops.aten.native_batch_norm_backward(
        dy, x, weight, None, None, mean, rstd, True, 1e-5, [True, True, True])


def bn_errors(x, dy, mean, rstd, got, ref) -> dict:
    """The kernel's (dx, dgamma, dbeta) ``got`` against the plain version's
    ``ref``: the sums' error over the sum of |terms| (``err``), dx's max
    |diff| over its scale (``dx_err``) and, in bfloat16, in bf16 steps at
    the plain value where that scale's floor does not cover it
    (``dx_steps``), and whether all are within their limits (``ok``)."""
    dyf = dy.float()
    xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    scales = ((dyf * xhat).abs().sum(dim=(0, 2, 3)), dyf.abs().sum(dim=(0, 2, 3)))
    del dyf, xhat
    err = max(((a - b).abs() / sc.clamp(min=1.0)).max().item()
              for a, b, sc in zip(got[1:], ref[1:], scales))
    d, r = got[0].float(), ref[0].float()
    diff = (d - r).abs()
    floor = BN_DX_TOL * r.abs().max().item()
    steps = 0.0
    if got[0].dtype == torch.bfloat16:
        _, e = torch.frexp(r)
        step = torch.where(r == 0, 0.0, torch.ldexp(torch.ones_like(r), e - 8))
        steps = torch.where(diff <= floor, 0.0, diff / step.clamp(min=1e-30)).max().item()
        dx_ok = steps <= 1.0
    else:
        dx_ok = diff.max().item() <= floor
    out = dict(err=err, err_abs=max((a - b).abs().max().item() for a, b in zip(got, ref)),
               dx_err=diff.max().item() / max(r.abs().max().item(), 1e-30), dx_steps=steps)
    out["ok"] = err <= BN_TOL and dx_ok
    return out


def bn_check(bn, shape, dtype, seed: int) -> dict:
    """K3 against its plain version at one shape: twice, bit-equal from run
    to run, the sums within BN_TOL of the sum of |terms| per channel and dx
    within its limits (``bn_errors``; raises otherwise).  Then the device
    ms of the kernel, the plain version and the library call, warm and, for
    the kernel and the library call, on a cold L2 (``queued_ms``: CUDA
    events around one queued call), the kernel's ms by CUDA events over
    back-to-back calls, and the bound (x and dy read once, dx written once,
    mean, rstd and weight read, dgamma and dbeta written)."""
    x, dy, mean, rstd, w = bn_inputs(shape, dtype, seed)
    got = bn.bn_bwd_cuda(x, dy, mean, rstd, w)
    again = bn.bn_bwd_cuda(x, dy, mean, rstd, w)
    ref = bn.bn_bwd_plain(x, dy, mean, rstd, w)
    lib = library_bn_backward(x, dy, mean, rstd, w)
    torch.cuda.synchronize()
    out = bn_errors(x, dy, mean, rstd, got, ref)
    out["lib"] = bn_errors(x, dy, mean, rstd, lib, ref)
    out["repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
    if not (out["ok"] and out["repeat"]):
        raise AssertionError(f"bn_backward disagrees with its plain version at {shape} "
                             f"{dtype}: {out}")
    del got, again, ref, lib
    kernel = lambda: bn.bn_bwd_cuda(x, dy, mean, rstd, w)  # noqa: E731
    library = lambda: library_bn_backward(x, dy, mean, rstd, w)  # noqa: E731
    out["ms"] = queued_ms(kernel, 10)
    out["plain_ms"] = queued_ms(lambda: bn.bn_bwd_plain(x, dy, mean, rstd, w), 10)
    out["library_ms"] = queued_ms(library, 10)
    out["cold_ms"] = queued_ms(kernel, cold=True)
    out["library_cold_ms"] = queued_ms(library, cold=True)
    n = x.numel()
    out["bound_ms"], out["bound_by"] = bound(3 * n * x.element_size() + 5 * shape[1] * 4,
                                             12 * n, PEAK_F32_FLOPS)
    out["events_ms"] = cuda_ms(kernel, 50, warmup=3)
    return out


def bn_line(shape, dtype, r: dict) -> str:
    return (f"{list(shape)} {str(dtype)[6:]}: sums {r['err']:.3e} of sum |terms| (limit "
            f"{BN_TOL:g}; library call {r['lib']['err']:.3e}), dx {r['dx_err']:.3e} of its "
            f"scale, {r['dx_steps']:.2f} bf16 steps past {BN_DX_TOL:g} of it (library call "
            f"{r['lib']['dx_err']:.3e}, {r['lib']['dx_steps']:.2f}), max |diff| "
            f"{r['err_abs']:.3e}, repeatable {r['repeat']}; device time: kernel {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, native_batch_norm_backward "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); kernel "
            f"by CUDA events {r['events_ms']:.4f} ms; on a cold L2 kernel {r['cold_ms']:.4f} "
            f"ms, native_batch_norm_backward {r['library_cold_ms']:.4f} ms")


def check_bn_backward(bn):
    """K3 against its plain version on the flagship's shapes at B=192 and a
    ragged one, with the kernel's, plain version's, library call's and
    bound's ms at each shape; the worst errors."""
    worst = worst_abs = 0.0
    for i, (shape, dtype) in enumerate(BN_SHAPES):
        r = bn_check(bn, shape, dtype, seed=i)
        log("bn_backward " + bn_line(shape, dtype, r))
        worst, worst_abs = max(worst, r["err"]), max(worst_abs, r["err_abs"])
    return worst, worst_abs


def bn_mutant_caught(bn, shape, dtype) -> tuple:
    """Whether the checks of ``bn_check`` catch the K3 library now loaded
    at one shape: it runs on other inputs first (so that memory it leaves
    unwritten or reads too early holds another call's values), then on the
    checked inputs twice.  Returns (caught, errors)."""
    bn.bn_bwd_cuda(*bn_inputs(shape, dtype, 7))
    x, dy, mean, rstd, w = bn_inputs(shape, dtype, 8)
    got = bn.bn_bwd_cuda(x, dy, mean, rstd, w)
    again = bn.bn_bwd_cuda(x, dy, mean, rstd, w)
    r = bn_errors(x, dy, mean, rstd, got, bn.bn_bwd_plain(x, dy, mean, rstd, w))
    r["repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
    return not (r["ok"] and r["repeat"]), r


def bn_step_times(bn) -> dict:
    """K3's bf16 ms warm and cold (``queued_ms``) summed over the train
    step's 36 launches (TRAIN_BN_SHAPES, seeded inputs)."""
    warm = cold = 0.0
    for i, (shape, n) in enumerate(TRAIN_BN_SHAPES.items()):
        args = bn_inputs(shape, torch.bfloat16, 300 + i)
        warm += n * queued_ms(lambda: bn.bn_bwd_cuda(*args), 10)
        cold += n * queued_ms(lambda: bn.bn_bwd_cuda(*args), cold=True)
        del args
    return {"warm": warm, "cold": cold}


def time_k3_variants(bn, build) -> dict:
    """K3's step sums (``bn_step_times``) with each of K3_TIMING_VARIANTS
    built in (their results are wrong and not read), beside the kernel."""
    out = {"kernel": bn_step_times(bn)}
    with mutant_libraries(build, K3_SOURCE, K3_TIMING_VARIANTS) as paths:
        for (name, _, _), path in zip(K3_TIMING_VARIANTS, paths):
            with loaded_as(build, K3_SOURCE, path):
                out[name] = bn_step_times(bn)
    out["kernel again"] = bn_step_times(bn)
    log("K3 ms a train step, warm / cold, stopped early: " + "; ".join(
        f"{k} {t['warm']:.4f} / {t['cold']:.4f}" for k, t in out.items()))
    return out


def check_bn_mutants(bn, build):
    """K3's checks against K3_MUTANTS: each copy of the kernel is held at
    BN_MUTANT_SHAPES as the kernel is; raises if one is caught at none."""
    with mutant_libraries(build, K3_SOURCE, K3_MUTANTS) as paths:
        for (name, _, _), path in zip(K3_MUTANTS, paths):
            with loaded_as(build, K3_SOURCE, path):
                seen = [(shape, dtype, *bn_mutant_caught(bn, shape, dtype))
                        for shape, dtype in BN_MUTANT_SHAPES]
            torch.cuda.synchronize()
            for shape, dtype, caught, r in seen:
                log(f"K3 mutant ({name}) at {list(shape)} {str(dtype)[6:]}: sums {r['err']:.3e}, "
                    f"dx {r['dx_err']:.3e} ({r['dx_steps']:.2f} steps), repeatable "
                    f"{r['repeat']}; caught {caught}")
            if not any(c for _, _, c, _ in seen):
                raise AssertionError(f"K3 mutant ({name}) passed the checks")


# -- the int8-vs-bf16 GEMM probe: P1 (int8 chain) and P2 (bf16 chain)

# P1 is held bit-equal to its plain version (NaN equal to NaN) at every
# depth, on the tie input and on an x with one NaN: every step is the same
# IEEE operation in the same order and the int32 sums are exact.  P2 is held
# to ops/gemm_probe.BF16_CHAIN_TOL (max |diff| over max |acc|, by depth;
# measured on the card and stated there).  At the probe's 200 steps the
# chain has overflowed: both versions of both kernels must be all NaN.  On
# an H100 the first four PROBE_MUTANTS were caught: roundf by the tie input
# and at 4 and 30 steps (random data hits no tie at the first step), the
# contraction from the second step on, toward-zero bf16 by every P2 limit;
# fmaxf by none of these (the 200-step chain ends all NaN with it too),
# which the NaN input now catches.  The fifth, a chain CTA that quantizes
# with the abs-max of its own 16 rows instead of the cluster's, must be
# caught by bit-equality.
PROBE_DEPTHS = (1, 4, 30)
PROBE_TIE_DEPTHS = (1, 4)

# the faults the probe's limits must catch, for --mutants: (name, text in
# gemm_probe.cu, replacement)
PROBE_MUTANTS = (
    ("P1 roundf for half to even", "__fadd_rn(y, kRound)", "__fadd_rn(roundf(y), kRound)"),
    ("P1 acc + a*q contracted to an FMA", "acc = __fadd_rn(acc, o);",
     "acc = acc + (float)a * s;"),
    ("P1 fmaxf for the NaN-propagating max", "nan_max(__uint_as_float(m), 1e-12f)",
     "fmaxf(__uint_as_float(m), 1e-12f)"),
    ("P2 x rounded to bf16 toward zero", "__float2bfloat16_rn(", "__float2bfloat16_rz("),
    ("P1 a chain CTA's own abs-max for the cluster's",
     "for (int s = lane; s < G * kMmaWarps; s += 32) m = max(m, sh.slots[q][s]);",
     "for (int s = lane; s < kMmaWarps; s += 32) m = max(m, sh.slots[q][rank * kMmaWarps + s]);"),
)
# copies with one part of the new step left out, timed (not checked) with
# --mutants to split a step: the chain alone (no wide CTAs, so no history
# published; P1 and P2), and P1's chain without its cluster abs-max
# exchange (each CTA its own warps' maxima, no cluster barrier):
# (name, text, replacement, kernels timed)
PROBE_TIMING_VARIANTS = (
    ("the chain alone",
     "p.wide = (p.B + kWideRows<Q> - 1) / kWideRows<Q> * ((p.F - kE) / kWideCols);",
     "p.wide = 0;", ("p1", "p2")),
    ("P1 without the cluster abs-max exchange",
     ("if (lane < G) st_async(&sh.slots[q][rank * kMmaWarps + warp], &sh.amax_bar[q], lane, m);",
      "mbar_wait(&sh.amax_bar[q], (it >> 1) & 1);",
      "if (tid == 0 && it + 2 < p.iters) mbar_expect(&sh.amax_bar[q], amax_bytes);"),
     ("if (lane == 0) sh.slots[q][rank * kMmaWarps + warp] = m;", "", ""), ("p1",)),
)


def differing(got, want) -> dict:
    """Elements that differ (NaN equal to NaN) and the most ulps between
    two finite float32 values of one sign."""
    diff = ~((got == want) | (torch.isnan(got) & torch.isnan(want)))
    n = int(diff.sum())
    ulps = 0
    if n:
        both = diff & torch.isfinite(got) & torch.isfinite(want) & (
            torch.sign(got) == torch.sign(want))
        if both.any():
            ulps = int((got[both].view(torch.int32).long()
                        - want[both].view(torch.int32).long()).abs().max())
    return {"differing": n, "max_ulps": ulps}


def probe_errors(gp, x, wq, ws, wbf, xt) -> dict:
    """Both chain kernels against their plain versions: P1's differing
    elements at each depth, on the tie input and at one step from an x
    with one NaN, P2's max |diff| over max |plain| at each depth, and the
    NaN shares of all four at the probe's 200 steps."""
    r = {}
    for n in PROBE_DEPTHS:
        got, want = gp.int8_chain_cuda(x, wq, ws, n), gp.int8_chain_plain(x, wq, ws, n)
        r[f"p1_{n}"] = differing(got, want)
        if n == 1:
            r["abs_err_p1"] = (got - want).abs().max().item()
        got, want = gp.bf16_chain_cuda(x, wbf, n), gp.bf16_chain_plain(x, wbf, n)
        r[f"p2_{n}"] = ((got - want).abs().max() / want.abs().max()).item()
        if n == 1:
            r["abs_err_p2"] = (got - want).abs().max().item()
    for n in PROBE_TIE_DEPTHS:
        r[f"p1_tie_{n}"] = differing(gp.int8_chain_cuda(xt, wq, ws, n),
                                     gp.int8_chain_plain(xt, wq, ws, n))
    xn = x.clone()
    xn[3, 5] = float("nan")  # the abs-max is NaN: every out NaN from the first step
    r["p1_nan_1"] = differing(gp.int8_chain_cuda(xn, wq, ws, 1), gp.int8_chain_plain(xn, wq, ws, 1))
    r["nan_share"] = {name: torch.isnan(f()).float().mean().item() for name, f in (
        ("p1", lambda: gp.int8_chain_cuda(x, wq, ws, gp.ITERS)),
        ("p1_plain", lambda: gp.int8_chain_plain(x, wq, ws, gp.ITERS)),
        ("p2", lambda: gp.bf16_chain_cuda(x, wbf, gp.ITERS)),
        ("p2_plain", lambda: gp.bf16_chain_plain(x, wbf, gp.ITERS)))}
    return r


def probe_caught(gp, r: dict) -> list:
    """The limits that ``r`` breaks (empty if the kernels pass)."""
    caught = [f"P1 bit-equality at {k[3:]}" for k in r
              if k.startswith("p1_") and r[k]["differing"]]
    caught += [f"P2 limit at {n} steps" for n in PROBE_DEPTHS
               if not r[f"p2_{n}"] <= gp.BF16_CHAIN_TOL[n]]
    if any(v != 1.0 for v in r["nan_share"].values()):
        caught.append("all NaN at 200 steps")
    return caught


def probe_line(r: dict) -> str:
    p1 = ", ".join(f"{k[3:]}: {v['differing']} differ ({v['max_ulps']} ulps)"
                   for k, v in r.items() if k.startswith("p1_"))
    p2 = ", ".join(f"{n}: {r[f'p2_{n}']:.3e}" for n in PROBE_DEPTHS)
    return (f"P1 vs plain {p1}; P2 vs plain, max |diff| of max |acc|, {p2}; NaN shares at "
            f"200 steps {r['nan_share']}")


def library_int8_chain(x, wq_cm, ws, iters: int):
    """P1's chain with its product as one library call (``torch._int_mm``,
    ``wq_cm`` column-major) and the same glue in torch: the yardstick of
    P1's time, never on the port's path."""
    from multimodal_scene_text_recognition_tpu_torch.ops.int8 import div

    acc = torch.zeros(x.shape[0], wq_cm.shape[1], device=x.device)
    for _ in range(iters):
        inv = div(127.0, torch.clamp(x.abs().amax(), min=1e-12))
        xq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
        out = torch._int_mm(xq, wq_cm).float() * div(ws, inv)
        acc = acc + out
        x = out[:, :x.shape[1]]
    return acc


def library_bf16_chain(x, wbf, iters: int):
    """P2's chain with its product as one library call, ``torch.mm(...,
    out_dtype=torch.float32)``."""
    acc = torch.zeros(x.shape[0], wbf.shape[1], device=x.device)
    for _ in range(iters):
        out = torch.mm(x.bfloat16(), wbf, out_dtype=torch.float32)
        acc = acc + out
        x = out[:, :x.shape[1]]
    return acc


def graphed(fn):
    """``fn`` captured once as a CUDA graph; returns its replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def step_times(kernel, iters: int) -> dict:
    """ms of ``kernel(n)`` at 0, 30 and ``iters`` steps, by CUDA events over
    1 warm + 10 back-to-back calls (which also count the host's cost of a
    call where it exceeds the device's) and as device time (``queued_ms``),
    and the us a step of device time over the first 30 (finite) steps and
    over the overflowed rest."""
    ms_0, ms_30, ms = (cuda_ms(lambda: kernel(n), 10) for n in (0, 30, iters))
    dev = [queued_ms(lambda: kernel(n), 10) for n in (0, 30, iters)]
    return dict(ms=ms, ms_0_steps=ms_0, ms_30_steps=ms_30, device_ms=dev[2],
                device_ms_0_steps=dev[0], device_ms_30_steps=dev[1],
                step_us_finite=(dev[1] - dev[0]) / 30 * 1e3,
                step_us_overflowed=(dev[2] - dev[1]) / (iters - 30) * 1e3)


def step_line(t: dict, iters: int) -> str:
    return (f"{t['ms']:.4f} ms at {iters} steps, {t['ms_0_steps']:.4f} at 0, "
            f"{t['ms_30_steps']:.4f} at 30 (CUDA events); device time {t['device_ms']:.4f} / "
            f"{t['device_ms_0_steps']:.4f} / {t['device_ms_30_steps']:.4f} ms; a step "
            f"{t['step_us_finite']:.3f} us over the first 30, {t['step_us_overflowed']:.3f} us "
            f"over the rest")


def check_gemm_probe(gp, probe, build, mutants: bool):
    """P1 and P2 against their plain versions (PROBE_DEPTHS, the tie
    input, all NaN at 200 steps), raising on any broken limit; then each
    at the probe's 200 steps: ms (CUDA events, 1 warm + 10 calls, with the
    launch count checked), rate, bound, the plain version's ms and the
    library chain's ms, eager and as one CUDA graph.  Then the probe's
    own entry point (``scripts/probe_int8.main(["--run"])``) with the launch
    counts set to 0 just before it and read just after.  ``mutants`` holds
    broken copies of the kernels to the same limits (raising if one is
    missed) and times PROBE_TIMING_VARIANTS: the chain's us a step and the
    wide part's ms (the whole less the chain alone)."""
    x, wq, ws, wbf = gp.probe_inputs(0)
    xt = gp.tie_input(0)
    r = probe_errors(gp, x, wq, ws, wbf, xt)
    log("gemm probe: " + probe_line(r))
    broken = probe_caught(gp, r)
    if broken:
        raise AssertionError(f"the gemm probe kernels break their limits: {broken}")
    for name, int8 in (("p1", True), ("p2", False)):
        log(f"{name} plan: {gp.probe_plan(gp.B, gp.F, int8)}")
    kernels = {"p1": lambda n: gp.int8_chain_cuda(x, wq, ws, n),
               "p2": lambda n: gp.bf16_chain_cuda(x, wbf, n)}
    variants = {}
    if mutants:
        variants_in = [v[:3] for v in PROBE_TIMING_VARIANTS]
        with mutant_libraries(build, "gemm_probe", PROBE_MUTANTS + tuple(variants_in)) as paths:
            missed = []
            for (name, _, _), path in zip(PROBE_MUTANTS, paths):
                with loaded_as(build, "gemm_probe", path):
                    rm = probe_errors(gp, x, wq, ws, wbf, xt)
                caught = probe_caught(gp, rm)
                log(f"probe mutant {name}: {probe_line(rm)}; caught by {caught or 'no limit'}")
                if not caught:
                    missed.append(name)
            for (name, _, _, which), path in zip(PROBE_TIMING_VARIANTS,
                                                 paths[len(PROBE_MUTANTS):]):
                with loaded_as(build, "gemm_probe", path):
                    for k in which:
                        variants[(k, name)] = step_times(kernels[k], gp.ITERS)
                        log(f"{k} {name}: {step_line(variants[(k, name)], gp.ITERS)} "
                            f"(timing only)")
            if missed:
                raise AssertionError(f"the probe's limits missed the mutants {missed}")

    wq_cm = wq.t().contiguous().t()
    ops = 2 * gp.B * gp.E * gp.F * gp.ITERS
    out_bytes = gp.B * gp.F * 4
    rows = {}
    for name, plain, library, nbytes, peak in (
            ("p1", lambda n: gp.int8_chain_plain(x, wq, ws, n),
             lambda n: library_int8_chain(x, wq_cm, ws, n),
             x.numel() * 4 + wq.numel() + ws.numel() * 4 + out_bytes, PEAK_INT8_OPS),
            ("p2", lambda n: gp.bf16_chain_plain(x, wbf, n),
             lambda n: library_bf16_chain(x, wbf, n),
             x.numel() * 4 + wbf.numel() * 2 + out_bytes, PEAK_BF16_FLOPS)):
        kernel = kernels[name]
        counter = gp.int8_chain_cuda if name == "p1" else gp.bf16_chain_cuda
        before = counter.launches
        ms = cuda_ms(lambda: kernel(gp.ITERS), 10)
        if counter.launches - before != 11:
            raise AssertionError(f"{name}: {counter.launches - before} launches in 11 calls")
        want = plain(4)
        library_err = ((library(4) - want).abs().max() / want.abs().max()).item()
        bound_ms, bound_by = bound(nbytes, ops, peak)
        # the launch, weight staging and output alone; the first 30 steps,
        # whose values are finite; the overflowed rest (inf and NaN operands)
        t = step_times(kernel, gp.ITERS)
        ms_0, ms_30 = t["ms_0_steps"], t["ms_30_steps"]
        rows[name] = dict(
            t, ms=ms, tf_s=ops / ms / 1e9,
            plain_ms=cuda_ms(lambda: plain(gp.ITERS), 10),
            library_ms_eager=cuda_ms(lambda: library(gp.ITERS), 10),
            library_ms=cuda_ms(graphed(lambda: library(gp.ITERS)), 10),
            bound_ms=bound_ms, bound_by=bound_by, library_err_4=library_err)
        log(f"{name} at {gp.ITERS} steps: kernel {ms:.4f} ms ({rows[name]['tf_s']:.2f} TF/s; "
            f"{ms_0:.4f} ms at 0 steps, {ms_30:.4f} at 30; device time {t['device_ms']:.4f} / "
            f"{t['device_ms_0_steps']:.4f} / {t['device_ms_30_steps']:.4f} ms; a step "
            f"{rows[name]['step_us_finite']:.3f} us over the first 30, "
            f"{rows[name]['step_us_overflowed']:.3f} us over the rest), "
            f"plain {rows[name]['plain_ms']:.3f} ms, library chain "
            f"{rows[name]['library_ms_eager']:.3f} ms eager / {rows[name]['library_ms']:.3f} "
            f"ms as one CUDA graph (at 4 steps {library_err:.3e} of max |acc| off the plain "
            f"version), bound {bound_ms:.4f} ms ({bound_by}); CUDA events, 1 warm + 10 calls")
        alone = variants.get((name, "the chain alone"))
        if alone is not None:
            rows[name]["chain_alone"] = alone
            rows[name]["wide_part_ms"] = ms - alone["ms"]
            log(f"{name}: the chain {alone['step_us_finite']:.3f} us a step finite, "
                f"{alone['step_us_overflowed']:.3f} overflowed; the wide part "
                f"{rows[name]['wide_part_ms']:.4f} ms of {ms:.4f} (the whole less the chain "
                f"alone)")
        exchange = variants.get((name, "P1 without the cluster abs-max exchange"))
        if exchange is not None:
            rows[name]["without_exchange"] = exchange

    gp.int8_chain_cuda.launches = gp.bf16_chain_cuda.launches = 0
    res = probe.main(["--run"])
    launches = {"p1": gp.int8_chain_cuda.launches, "p2": gp.bf16_chain_cuda.launches}
    log(f"the probe's own run: launches {launches}; int8 {res['int8_tf_s']:.2f} TF/s, bf16 "
        f"{res['bf16_tf_s']:.2f} TF/s")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the probe never launched the {name} kernel")
    return [dict(name=name, route="cuda",
                 source="multimodal_scene_text_recognition_tpu_torch/kernels/gemm_probe.cu",
                 replaces=f"scripts/probe_int8_pallas.py:{line}",
                 jax=f"scripts/probe_int8_pallas.py::{fn}", launches=launches[name],
                 max_abs_err=r[f"abs_err_{name}"], probe_tf_s=res[f"{kind}_tf_s"],
                 **rows[name])
            for name, fn, line, kind in (("p1", "kern_int8", 21, "int8"),
                                         ("p2", "kern_bf16", 42, "bf16"))]


def decode_cost(w, ck, T, dt_bytes):
    """Bytes each input/output moves once, and the flops of the projections
    and attention, for one fused decode call."""
    L, Bn, Tm, E = ck.shape
    F = w.ff1_w.shape[2]
    C = w.head_w.shape[1]
    tables = sum(t.numel() for t in list(w)[:-1])
    nbytes = tables * dt_bytes + 2 * ck.numel() * dt_bytes + w.pe[:T].numel() * 4 \
        + Bn * T * C * 4
    proj = L * (E * 3 * E + 3 * E * E + 2 * E * F) + E * C
    attn = sum(L * 2 * 2 * E * ((t + 1) + Tm) for t in range(T))
    return nbytes, 2 * Bn * T * proj + Bn * attn


def check_fused_decode(fd, model, image, overlap):
    """K1 against its plain version at full width on the trained decoder
    weights and the cross K/V the port's encoder makes from B=192 crops."""
    dec = model.decoder
    T, H = dec.max_text_length, dec.num_heads
    with torch.no_grad():
        enc = model.encoder(model.features(model.rectify(image)))
        ck, cv = dec.cross_kv(dec.hid_to_emb(enc))
    kw = dict(num_heads=H, steps=T, go_id=0, eps=1e-5)
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        wd = dec.fused_weights(dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        # the tables repacked once, as the served path does
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=dec.cluster_tables(dt), **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"fused decode ({dt}) produced non-finite logits")
        err = (out - ref).abs().max().item()
        agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
        results[dt] = (err, agree, wd, ckd, cvd)
        log(f"fused_decode {dt}: kernel vs plain max |logit diff| {err:.3e}, "
            f"token agreement {agree:.6f} over {out.shape[0]}x{out.shape[1]}")
    err32, agree32 = results[torch.float32][:2]
    if not (err32 <= 1e-3 and agree32 == 1.0):
        raise AssertionError(f"fused decode f32: max diff {err32}, agreement {agree32}")
    err16, agree16 = results[torch.bfloat16][:2]
    if not agree16 >= 0.99:
        raise AssertionError(f"fused decode bf16 token agreement {agree16} < 0.99")
    if not err16 <= BF16_LOGIT_TOL:
        raise AssertionError(f"fused decode bf16: max |logit diff| {err16} > {BF16_LOGIT_TOL}")

    _, _, wd, ckd, cvd = results[torch.bfloat16]
    kw["packed"] = dec.cluster_tables(torch.bfloat16)
    first, again = (fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw) for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("fused decode bf16: two launches on the same input differ")
    L, _, Tm, E = ckd.shape
    F, C = wd.ff1_w.shape[2], wd.head_w.shape[1]
    plan = fd.cluster_plan(B, L, E, H, F, C, T, Tm, torch.bfloat16)
    log(f"fused_decode bf16 launch: G={plan.G} CTAs a cluster, R={plan.R} rows a cluster, "
        f"{plan.clusters} clusters ({plan.ctas} CTAs), {plan.smem} B shared memory a CTA, "
        f"{plan.depth} units in flight a lane; weights read from L2 "
        f"{plan.cta_step_bytes / 1e6:.3f} MB a CTA a step, "
        f"{plan.call_bytes(T) / 1e9:.3f} GB a full-length call")
    times = k1_times(fd, dec, ck, cv, packed=kw["packed"])
    ms, ms_b1 = times["full"], times["b1"]
    one = [t[:, :1].contiguous() for t in (ckd, cvd)]
    shares = {}
    for name, (k, v) in (("B=192", (ckd, cvd)), ("B=1", one)):
        prof = torch.zeros(len(fd.CLUSTER_PHASES), dtype=torch.int64, device=k.device)
        fd.fused_greedy_decode_cuda(wd, k, v, profile=prof, **kw)
        cycles = prof.tolist()
        shares[name] = {p: c / sum(cycles) for p, c in zip(fd.CLUSTER_PHASES, cycles)}
        log(f"fused_decode bf16 {name}: {sum(cycles)} cycles of CTA 0's first thread, by phase "
            + ", ".join(f"{p} {v:.3f}" for p, v in shares[name].items()))
    del kw["packed"]
    plain_ms = cuda_ms(lambda: fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw), 3)
    nbytes, flops = decode_cost(wd, ckd, T, 2)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    log(f"fused_decode bf16: kernel {ms:.3f} ms at B={B} (early stop {times['early_stop']:.3f} "
        f"ms), {ms_b1:.3f} ms at B=1; two launches bit-identical; plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return dict(name="fused_decode", route="cuda",
                source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_decode_cluster.cu",
                replaces="multimodal_scene_text_recognition_tpu/ops/fused_decode.py:207",
                jax="ops/fused_decode.py::_decode_kernel",
                max_abs_err=err32, max_abs_err_f32=err32, max_abs_err_bf16=err16,
                bf16_token_agreement=agree16,
                ms=ms, ms_b1=ms_b1, ms_early_stop=times["early_stop"], phase_shares=shares,
                rows=plan.R, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def k1_times(fd, dec, ck, cv, **kw) -> dict:
    """K1 bf16 ms on ``dec``'s tables and the cross K/V ``ck``, ``cv``
    [L, B, Tm, E]: at full length (``full``) and with early stop
    (``early_stop``), and at full length on the first row alone (``b1``);
    one warm call, then the mean of 10 by CUDA events.  ``kw``: more
    arguments of every call (``packed``)."""
    bf16 = torch.bfloat16
    wd = dec.fused_weights(bf16)
    ckd, cvd = ck.to(bf16).contiguous(), cv.to(bf16).contiguous()
    one = [t[:, :1].contiguous() for t in (ckd, cvd)]
    kw = dict(num_heads=dec.num_heads, steps=dec.max_text_length, go_id=0, eps=1e-5, **kw)
    k1 = fd.fused_greedy_decode_cuda
    return dict(full=cuda_ms(lambda: k1(wd, ckd, cvd, **kw), 10),
                early_stop=cuda_ms(lambda: k1(wd, ckd, cvd, eos_id=1, **kw), 10),
                b1=cuda_ms(lambda: k1(wd, *one, **kw), 10))


# (E, H, F) that K1 serves by padding its slices or rows or by two heads a
# CTA: head slices 12 wide, sixteen heads, FF slices 24 wide, rows 40 and
# 42 wide (padded to 48; three heads of 14)
K1_WIDTHS = ((48, 4, 128), (256, 16, 2048), (64, 4, 96), (40, 4, 128), (42, 3, 100))


def random_decoder(L, E, F, C, T, Tm, B, seed: int):
    """Seeded random decoder tables and cross K/V at these widths (the card
    tests' scales), float32 on the card."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=None, base=0.0):
        s = 1.0 / np.sqrt(shape[-2]) if scale is None else scale
        return torch.from_numpy((base + s * rng.standard_normal(shape)).astype(np.float32)).cuda()

    from multimodal_scene_text_recognition_tpu_torch.ops.fused_decode import FusedDecodeWeights
    w = FusedDecodeWeights(
        w_qkv=t(L, E, 3 * E), b_qkv=t(L, 3 * E, scale=0.1), w_out=t(L, E, E),
        b_out=t(L, E, scale=0.1), cw_q=t(L, E, E), cb_q=t(L, E, scale=0.1), cw_o=t(L, E, E),
        cb_o=t(L, E, scale=0.1), ff1_w=t(L, E, F), ff1_b=t(L, F, scale=0.1), ff2_w=t(L, F, E),
        ff2_b=t(L, E, scale=0.1), n1_s=t(L, E, scale=0.1, base=1.0), n1_b=t(L, E, scale=0.1),
        n2_s=t(L, E, scale=0.1, base=1.0), n2_b=t(L, E, scale=0.1),
        n3_s=t(L, E, scale=0.1, base=1.0), n3_b=t(L, E, scale=0.1),
        fn_s=t(E, scale=0.1, base=1.0), fn_b=t(E, scale=0.1), head_w=t(E, C, scale=0.5),
        head_b=t(C, scale=0.1), emb=t(C, E, scale=1.0), pe=t(T, E, scale=1.0))
    return w, t(L, B, Tm, E, scale=1.0), t(L, B, Tm, E, scale=1.0)


def check_k1_widths(fd) -> dict:
    """K1 at K1_WIDTHS (seeded random tables, L=2, B=64, T=6, C=97) against
    its plain version, float32 and bfloat16, at the flagship's limits:
    float32 within 1e-3 and every token, bfloat16 at least 99% of tokens."""
    out = {}
    for E, H, F in K1_WIDTHS:
        w, ck, cv = random_decoder(2, E, F, 97, 6, 8, 64, seed=E + H + F)
        plan = fd.cluster_plan(64, 2, E, H, F, 97, 6, 8, torch.bfloat16)
        kw = dict(num_heads=H, steps=6, go_id=0, eps=1e-5)
        r = {}
        for dt in (torch.float32, torch.bfloat16):
            wd = fd.cast_weights(w, dt)
            ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
            got = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=fd.pack_cluster_tables(wd, H),
                                              **kw)
            ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"K1 at E={E}, H={H}, F={F} ({dt}): non-finite logits")
            r[dt] = ((got - ref).abs().max().item(),
                     (got.argmax(-1) == ref.argmax(-1)).float().mean().item())
        log(f"K1 at E={E}, H={H}, F={F} (clusters of {plan.G} CTAs, {H // plan.G} heads a "
            f"CTA): f32 max |logit diff| {r[torch.float32][0]:.3e}, tokens "
            f"{r[torch.float32][1]:.4f}; bf16 {r[torch.bfloat16][0]:.3e}, tokens "
            f"{r[torch.bfloat16][1]:.4f}")
        if not (r[torch.float32][0] <= 1e-3 and r[torch.float32][1] == 1.0
                and r[torch.bfloat16][1] >= 0.99):
            raise AssertionError(f"K1 at E={E}, H={H}, F={F} outside the flagship's limits: {r}")
        out[f"{E},{H},{F}"] = {"f32_err": r[torch.float32][0], "bf16_err": r[torch.bfloat16][0],
                               "bf16_tokens": r[torch.bfloat16][1]}
    return out


def first_eos_steps(tokens, steps: int):
    """Steps each row's loop ran: one past the last of its beams' first
    [s] (tokens [B, K, T] or [B, T]), or ``steps`` where a beam never ends."""
    t = tokens.reshape(tokens.shape[0], -1, tokens.shape[-1])
    is_eos = t == 1
    first = torch.where(is_eos.any(-1), is_eos.int().argmax(-1), steps - 1)
    return (first.max(dim=1).values + 1).clamp(max=steps)


def pruned_agreement(a, b) -> float:
    """Share of token rows ([..., T]) equal up to and including the first
    [s] of ``b`` (in float64: a float32 mean puts 99 rows of 100 below
    0.99)."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    n = first_eos_steps(b[:, None], b.shape[-1])
    keep = torch.arange(b.shape[-1], device=b.device)[None] < n[:, None]
    return ((a == b) | ~keep).all(-1).double().mean().item()


def loop_cost(w, ck, K, row_steps, dt_bytes, out_bytes):
    """Bytes each input and output moves once (tables, memory K/V, the
    cache writes of the steps taken, ``out_bytes`` of outputs) and the
    flops of the projections and attention of the steps each row took, for
    one call of a decode loop over K rows a batch row (the beam kernel; the
    greedy kernel at K=1)."""
    L, Bn, Tm, E = ck.shape
    F = w.ff1_w.shape[2]
    C = w.head_w.shape[1]
    T = w.pe.shape[0]
    S = int(row_steps.sum())
    tables = sum(t.numel() for t in list(w)[:-1])
    nbytes = tables * dt_bytes + 2 * ck.numel() * dt_bytes + w.pe.numel() * 4 \
        + 2 * L * K * S * E * dt_bytes + out_bytes
    proj = L * (E * 3 * E + 3 * E * E + 2 * E * F) + E * C
    attn = sum(L * 2 * 2 * E * ((t + 1) + Tm) for n in row_steps.tolist() for t in range(n))
    return nbytes, 2 * K * S * proj + K * attn


def check_fused_decode_early_stop(fd, model, rec, rec_es, crops, image):
    """K1e against its plain version at full width (trained decoder, the
    cross K/V of the B=192 crops), then on the served path: greedy strings
    with early stop against the full-length K1's, which must be identical."""
    dec = model.decoder
    T, H = dec.max_text_length, dec.num_heads
    with torch.no_grad():
        enc = model.encoder(model.features(model.rectify(image)))
        ck, cv = dec.cross_kv(dec.hid_to_emb(enc))
    kw = dict(num_heads=H, steps=T, go_id=0, eos_id=1, eps=1e-5)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        wd, packed = dec.fused_weights(dt), dec.cluster_tables(dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=packed, **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw)
        full = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=packed, **dict(kw, eos_id=None))
        torch.cuda.synchronize()
        ids = out.argmax(-1)
        agree = pruned_agreement(ids, ref.argmax(-1))
        vs_full = pruned_agreement(ids, full.argmax(-1))
        errs[dt] = (out - ref).abs().max().item()
        log(f"fused_decode early stop {dt}: kernel vs plain max |logit diff| {errs[dt]:.3e}, "
            f"[s]-pruned rows identical {agree:.6f}; vs the full-length kernel {vs_full:.6f}")
        if not (vs_full == 1.0 and (agree == 1.0 if dt == torch.float32 else agree >= 0.99)):
            raise AssertionError(f"fused decode early stop {dt}: agreement {agree}, "
                                 f"with the full-length loop {vs_full}")
        if dt == torch.float32 and not errs[dt] <= 1e-3:
            raise AssertionError(f"fused decode early stop f32: max diff {errs[dt]}")
        if dt == torch.bfloat16 and not errs[dt] <= BF16_LOGIT_TOL:
            raise AssertionError(f"fused decode early stop bf16: max diff {errs[dt]}")
    steps = first_eos_steps(ids, T)
    es = lambda: fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=packed, **kw)  # noqa: E731
    ms = cuda_ms(es, 10)
    full_kw = dict(kw, eos_id=None, packed=packed)
    ms_full = cuda_ms(lambda: fd.fused_greedy_decode_cuda(wd, ckd, cvd, **full_kw), 10)
    plain_ms = cuda_ms(lambda: fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw), 2)
    nbytes, flops = loop_cost(wd, ckd, 1, steps, 2, out.numel() * 4)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    R = fd.CLUSTER_ROWS
    tiles = torch.nn.functional.pad(steps, (0, -len(steps) % R)).reshape(-1, R).amax(1)
    log(f"fused_decode early stop bf16: kernel {ms:.3f} ms (full length {ms_full:.3f} ms), "
        f"plain {plain_ms:.3f} ms, steps per row mean {steps.float().mean().item():.2f} max "
        f"{steps.max().item()}, per cluster of {R} rows mean {tiles.float().mean().item():.2f} "
        f"(the steps each cluster ran: {tiles.tolist()}), bound {bound_ms:.4f} ms "
        f"({bound_by}; {flops / 1e9:.1f} GFLOP)")

    fd.fused_greedy_decode_cuda.launches = 0
    texts_es = rec_es.recognize(crops)
    launches = fd.fused_greedy_decode_cuda.launches
    texts = rec.recognize(crops)
    same = sum(a == b for a, b in zip(texts_es, texts)) / len(texts)
    log(f"served greedy with early stop vs full length: {same:.4f} of strings identical "
        f"(limit 1.0); K1 launches with early stop {launches}")
    if same != 1.0 or launches < 1:
        raise AssertionError(f"early-stop greedy serving: agreement {same}, launches {launches}")
    return dict(name="fused_decode_early_stop", route="cuda",
                source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_decode_cluster.cu",
                replaces="multimodal_scene_text_recognition_tpu/ops/fused_decode.py:340",
                jax="ops/fused_decode.py::_decode_kernel, eos_id",
                launches=launches, max_abs_err=errs[torch.float32],
                max_abs_err_bf16=errs[torch.bfloat16], ms=ms, ms_full_length=ms_full,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                mean_steps=steps.float().mean().item(),
                mean_cluster_steps=tiles.float().mean().item())


def beam_inputs(model, image):
    """The trained decoder and the per-layer cross K/V of ``image``'s crops."""
    dec = model.decoder
    with torch.no_grad():
        enc = model.encoder(model.features(model.rectify(image)))
        ck, cv = dec.cross_kv(dec.hid_to_emb(enc))
    return dec, ck, cv


def beam_vs_plain(fb, dec, ck, cv, dt, early_stop: bool, cls0=None) -> dict:
    """K4 against its plain version at K=5 in compute type ``dt`` (with
    ``cls0`` every beam's step-0 row): the best beams' and all beams'
    agreement up to their first [s], the largest score difference (of all
    beams and of the best), the steps each row took."""
    T = dec.max_text_length
    wd = dec.fused_weights(dt)
    ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
    kw = dict(beam_size=BEAM, num_heads=dec.num_heads, steps=T, go_id=0, eos_id=1, eps=1e-5,
              early_stop=early_stop, cls0=cls0)
    tok, sc = fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw)
    ref_tok, ref_sc = fb.fused_beam_decode_plain(wd, ckd, cvd, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(sc).all():
        raise AssertionError(f"fused beam ({dt}, early stop {early_stop}): non-finite scores")
    return dict(best=pruned_agreement(tok[:, 0], ref_tok[:, 0]),
                beams=pruned_agreement(tok, ref_tok),
                err=(sc - ref_sc).abs().max().item(),
                err_best=(sc[:, 0] - ref_sc[:, 0]).abs().max().item(),
                steps=first_eos_steps(tok, T) if early_stop else torch.full_like(tok[:, 0, 0], T),
                out_bytes=(tok.numel() + sc.numel()) * 4)


def beam_bf16_ok(r: dict) -> bool:
    return (r["best"] >= BEAM_BF16_BEST_AGREE and r["beams"] >= BEAM_BF16_ALL_AGREE
            and r["err_best"] <= BEAM_BF16_SCORE_TOL)


def beam_line(r: dict) -> str:
    return (f"best beams identical {r['best']:.6f}, all beams {r['beams']:.6f}, max |score "
            f"diff| {r['err']:.3e} (best beam {r['err_best']:.3e})")


# one bf16 rounding of K4 dropped at a time (the ReLU outputs': rounded
# toward zero, since ff2 takes them as a bf16 tensor-core operand): (name,
# text in K4_SOURCE.cu, replacement), for --mutants
K4_SOURCE = "fused_beam_grid"
MUTANTS = (
    ("probabilities", "pr[s] = Num<T>::round(pr[s] / sum[j]);", "pr[s] = pr[s] / sum[j];"),
    ("q*K products", "acc += Num<T>::round(qd * kd);", "acc += qd * kd;"),
    ("cross-attention value products", "acc += Num<T>::round(pr[s] * v);", "acc += pr[s] * v;"),
    ("ReLU outputs", "const T h = Num<T>::from_f(fmaxf(v, 0.0f));",
     "const T h = (T)__float2bfloat16_rz(fmaxf(v, 0.0f));"),
)


def _edits(old, new):
    """A mutant's (text, replacement) pairs: one pair, or tuples of texts
    and of their replacements."""
    return tuple(zip(old, new)) if isinstance(old, tuple) else ((old, new),)


@contextlib.contextmanager
def mutant_libraries(build, source: str, mutants):
    """Copies of kernel ``source`` (its .cu and the shared headers), each
    with one (name, text, replacement) of ``mutants`` applied wherever the
    text stands (text and replacement may be tuples, applied pairwise),
    built all at once in a temporary directory; yields their library
    paths.  Raises if a text is in no source or a copy fails to build."""
    names = (f"{source}.cu", *sorted(p.name for p in build.KERNEL_DIR.glob("*.cuh")))
    sources = {n: (build.KERNEL_DIR / n).read_text() for n in names}
    for name, old, new in mutants:
        for o, _ in _edits(old, new):
            if not any(o in text for text in sources.values()):
                raise AssertionError(f"mutant {name}: its text is in no source of the kernel")
    tmp = tempfile.mkdtemp(prefix=f"{source}_mutants_")
    procs = []
    try:
        for i, (_, old, new) in enumerate(mutants):
            os.makedirs(os.path.join(tmp, str(i)))
            for n, text in sources.items():
                for o, r in _edits(old, new):
                    text = text.replace(o, r)
                with open(os.path.join(tmp, str(i), n), "w") as f:
                    f.write(text)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(tmp, f"{i}.so"),
                   os.path.join(tmp, str(i), f"{source}.cu")]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
        for p in procs:
            if p.wait(timeout=300) != 0:
                raise AssertionError(f"a mutant failed to build: {p.stdout.read()[-2000:]}")
        yield [os.path.join(tmp, f"{i}.so") for i in range(len(mutants))]
    finally:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def loaded_as(build, name: str, path: str):
    """Library ``path`` in the place of kernel library ``name`` for the
    block."""
    real = build.load(name)
    build._loaded[name] = ctypes.CDLL(path)
    try:
        yield
    finally:
        build._loaded[name] = real


def check_mutants(fb, build, model, image):
    """The bf16 limits of K4 against broken copies of it: each mutant drops
    one bf16 rounding in a copy of the kernel's sources and is held against
    the plain version as the kernel is.  Prints what each reads and whether
    the limits catch it."""
    dec, ck, cv = beam_inputs(model, image)
    with mutant_libraries(build, K4_SOURCE, MUTANTS) as paths:
        for (name, _, _), path in zip(MUTANTS, paths):
            with loaded_as(build, K4_SOURCE, path):
                r = beam_vs_plain(fb, dec, ck, cv, torch.bfloat16, early_stop=True)
            log(f"mutant without the bf16 rounding of the {name}: {beam_line(r)}; caught "
                f"by the limits {not beam_bf16_ok(r)}")


def check_fused_beam(fb, model, image):
    """K4 against its plain version at full width on the trained decoder
    and the cross K/V of the B=192 crops, K=5, float32 and bfloat16, early
    stop on and off; then its time, the plain version's and the bound of
    the steps the rows took."""
    dec, ck, cv = beam_inputs(model, image)
    T, H = dec.max_text_length, dec.num_heads
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        for es in (False, True):
            r = res[dt, es] = beam_vs_plain(fb, dec, ck, cv, dt, es)
            log(f"fused_beam {dt} early stop {es}: kernel vs plain, {beam_line(r)}; steps per "
                f"row mean {r['steps'].float().mean().item():.2f}")
    for es in (False, True):
        r32, r16 = res[torch.float32, es], res[torch.bfloat16, es]
        if not (r32["best"] == 1.0 and r32["err_best"] <= 1e-3):
            raise AssertionError(f"fused beam f32 (early stop {es}): {r32}")
        if not beam_bf16_ok(r16):
            raise AssertionError(
                f"fused beam bf16 (early stop {es}): best beams identical {r16['best']} "
                f"(limit {BEAM_BF16_BEST_AGREE}), all beams {r16['beams']} (limit "
                f"{BEAM_BF16_ALL_AGREE}), best score diff {r16['err_best']} (limit "
                f"{BEAM_BF16_SCORE_TOL})")

    wd = dec.fused_weights(torch.bfloat16)
    ckd, cvd = ck.to(torch.bfloat16).contiguous(), cv.to(torch.bfloat16).contiguous()
    kw = dict(beam_size=BEAM, num_heads=H, steps=T, go_id=0, eos_id=1, eps=1e-5)
    first, again = (fb.fused_beam_decode_cuda(wd, ckd, cvd, early_stop=True, **kw)
                    for _ in range(2))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("fused beam bf16: two launches on the same input differ")
    L, _, Tm, E = ckd.shape
    F, C = wd.ff1_w.shape[2], wd.head_w.shape[1]
    plan = fb.beam_plan(B, BEAM, L, E, H, F, C, T, Tm, torch.bfloat16,
                        ctas=torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"fused_beam bf16 launch: {plan.ctas} CTAs (one an SM), {plan.row_tiles} row tiles of "
        f"{fb.ROWS} beam rows, tiles a phase " + ", ".join(
            f"{p.name} {p.tiles}" for p in plan.phases) + f"; {plan.barriers} grid barriers a "
        f"step, {plan.smem} B shared memory a CTA, attention rows {plan.attn_rows} and positions "
        f"{plan.positions} at a time, {plan.l2_step_bytes / 1e6:.1f} MB of operands "
        f"and weights read from L2 a step; two launches bit-identical")
    times = k4_times(fb, dec, ck, cv)
    ms, ms_full, ms_b1 = times["early_stop"], times["full"], times["b1"]
    barriers = plan.barriers * T
    floor_ms = cuda_ms(lambda: fb.barrier_floor_cuda(barriers, ckd.device), 10)
    log(f"fused_beam barrier floor: {barriers} grid barriers of {plan.ctas} CTAs (a full-length "
        f"call's) {floor_ms:.3f} ms, {floor_ms / barriers * 1e3:.3f} us a barrier")
    shares = {}
    one = [t[:, :1].contiguous() for t in (ckd, cvd)]
    for name, (k, v) in (("B=192", (ckd, cvd)), ("B=1", one)):
        prof = torch.zeros(fb.PROFILE_SLOTS, dtype=torch.int64, device=k.device)
        fb.fused_beam_decode_cuda(wd, k, v, profile=prof, **kw)
        cycles = prof.tolist()
        phases, parts = cycles[:2 * len(fb.BEAM_PHASES)], cycles[2 * len(fb.BEAM_PHASES):]
        total = sum(phases)
        shares[name] = {f"{p} {part}": c / total for p, pair in
                        zip(fb.BEAM_PHASES, zip(phases[::2], phases[1::2]))
                        for part, c in zip(("work", "barrier"), pair)}
        shares[name].update({f"part: {p}": c / total for p, c in zip(fb.BEAM_PARTS, parts)})
        log(f"fused_beam bf16 {name} at full length: {total} cycles of CTA 0's first thread, "
            f"{total / T / plan.barriers:.0f} a phase; by phase and part "
            + ", ".join(f"{p} {v:.3f}" for p, v in shares[name].items()))
    plain_ms = cuda_ms(lambda: fb.fused_beam_decode_plain(wd, ckd, cvd, early_stop=True, **kw),
                       2)
    steps = res[torch.bfloat16, True]["steps"]
    out_bytes = res[torch.bfloat16, True]["out_bytes"]
    nbytes, flops = loop_cost(wd, ckd, BEAM, steps, 2, out_bytes)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    nbytes_full, flops_full = loop_cost(wd, ckd, BEAM, torch.full_like(steps, T), 2, out_bytes)
    bound_full, _ = bound(nbytes_full, flops_full, PEAK_BF16_FLOPS)
    log(f"fused_beam bf16 K={BEAM}: kernel {ms:.3f} ms with early stop (steps per row mean "
        f"{steps.float().mean().item():.2f}, max {steps.max().item()}), {ms_full:.3f} ms at "
        f"full length, {ms_b1:.3f} ms at B=1 at full length; plain {plain_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}; "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), {bound_full:.4f} ms at full length "
        f"({flops_full / 1e9:.1f} GFLOP)")
    r32, r16 = res[torch.float32, True], res[torch.bfloat16, True]
    return dict(name="fused_beam", route="cuda",
                source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_beam_grid.cu",
                replaces="multimodal_scene_text_recognition_tpu/ops/fused_beam.py:69",
                jax="ops/fused_beam.py::_beam_kernel",
                max_abs_err=max(res[torch.float32, e]["err"] for e in (False, True)),
                max_abs_err_bf16=max(res[torch.bfloat16, e]["err"] for e in (False, True)),
                best_beam_agreement_f32=min(res[torch.float32, e]["best"] for e in (False, True)),
                best_beam_agreement_bf16=min(r["best"] for k, r in res.items()
                                             if k[0] == torch.bfloat16),
                all_beam_agreement_bf16=min(r["beams"] for k, r in res.items()
                                            if k[0] == torch.bfloat16),
                ms=ms, ms_full_length=ms_full, ms_b1=ms_b1, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_ms_full_length=bound_full,
                library_ms=None, mean_steps=steps.float().mean().item(),
                f32_err_best=r32["err_best"], bf16_err_best=r16["err_best"], ctas=plan.ctas,
                barriers_a_step=plan.barriers, barrier_floor_ms=floor_ms,
                l2_step_bytes=plan.l2_step_bytes, phase_shares=shares)


def k4_times(fb, dec, ck, cv) -> dict:
    """K4 bf16 ms (K=5) on ``dec``'s tables and the cross K/V ``ck``, ``cv``
    [L, B, Tm, E]: with early stop (``early_stop``) and at full length
    (``full``), and at full length on the first row alone (``b1``); one
    warm call, then the mean of 10 by CUDA events."""
    bf16 = torch.bfloat16
    wd = dec.fused_weights(bf16)
    ckd, cvd = ck.to(bf16).contiguous(), cv.to(bf16).contiguous()
    one = [t[:, :1].contiguous() for t in (ckd, cvd)]
    kw = dict(beam_size=BEAM, num_heads=dec.num_heads, steps=dec.max_text_length, go_id=0,
              eos_id=1, eps=1e-5)
    k4 = fb.fused_beam_decode_cuda
    return dict(early_stop=cuda_ms(lambda: k4(wd, ckd, cvd, early_stop=True, **kw), 10),
                full=cuda_ms(lambda: k4(wd, ckd, cvd, **kw), 10),
                b1=cuda_ms(lambda: k4(wd, *one, **kw), 10))


# the K1q faults its limits must catch, for --mutants: (name, text in
# K1_SOURCE.cu or the shared headers, replacement)
K1_SOURCE = "fused_decode_cluster"  # K1 and K1q's cluster kernel
K1Q_MUTANTS = (
    ("roundf (half away from zero) for rintf",
     "const float q = rintf(__fmul_rn(quant_input<T>(v), inv));",
     "const float q = roundf(__fmul_rn(quant_input<T>(v), inv));"),
    ("quantizing the bf16-rounded input", "__device__ float quant_input(float v) {\n  return v;",
     "__device__ float quant_input(float v) {\n  return Num<T>::round(v);"),
    ("rounding the ReLU output of ff1", "MODE == kQRelu ? fmaxf(y, 0.0f) : y",
     "MODE == kQRelu ? Num<T>::round(fmaxf(y, 0.0f)) : y"),
    ("the abs-max of a K-split input over the CTA's own slice only",
     "for (int g = 0; g < G; ++g) m = fmaxf(m, amx[g * R + r]);", "m = amx[h * R + r];"),
)


# the same three rounding faults in K1q's wide-row kernel (fused_decode.cu),
# which serves batches of at most K1Q_WIDE_BATCH rows and rows wider than
# the cluster kernel takes: (name, text in fused_decode.cu, replacement)
K1Q_WIDE_SOURCE = "fused_decode"
K1Q_WIDE_MUTANTS = (
    ("roundf (half away from zero) for rintf", "float v = rintf(quant_input<T>(",
     "float v = roundf(quant_input<T>("),
    K1Q_MUTANTS[1],
    ("rounding the ReLU output of ff1", "return RELU ? fmaxf(v, 0.0f) : v;",
     "return RELU ? Num<T>::round(fmaxf(v, 0.0f)) : v;"),
)

# the served int8 path's bucket at which check_k1q holds the wide-row
# kernel through the wrapper, on all B crops a bucket at a time
K1Q_WIDE_BUCKET = 64


def k1q_packed(dec, dt):
    """The int8 units K1q reads on the cluster kernel, cached by the
    decoder; None for a checkout whose K1q reads none."""
    if "int8" not in inspect.signature(dec.cluster_tables).parameters:
        return None
    return dec.cluster_tables(dt, int8=True)


def k1q_vs_plain(fd, dec, ck, cv, dt, early_stop: bool, cls0=None, batch=None) -> dict:
    """K1q against its plain version on the trained decoder's int8 tables
    in compute type ``dt`` (with ``cls0`` its step-0 row), through
    ``fused_greedy_decode_cuda`` on all rows at once or, with ``batch``,
    ``batch`` rows a call (each call on the kernel its route picks, whose
    counter must move): the largest logit difference, the share of rows
    identical up to their first [s], the steps each row took, the kernel."""
    T, B = dec.max_text_length, ck.shape[1]
    wq, scales = dec.fused_weights(dt, int8=True)
    ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
    L, _, Tm, E = ckd.shape
    F, C = wq.ff1_w.shape[2], wq.head_w.shape[1]
    kw = dict(num_heads=dec.num_heads, steps=T, go_id=0, eos_id=1 if early_stop else None,
              eps=1e-5, scales=scales)
    counters = {"cluster": "launches_int8", "wide": "launches_int8_wide"}
    outs, refs, kernels = [], [], set()
    for r0 in range(0, B, batch or B):
        rows = slice(r0, min(B, r0 + (batch or B)))
        k, v = (t[:, rows].contiguous() for t in (ckd, cvd))
        c0 = None if cls0 is None else cls0[rows].contiguous()
        route = fd.k1q_route(k.shape[1], L, E, dec.num_heads, F, C, T, Tm, dt)
        counter = counters[route.kernel]
        before = getattr(fd.fused_greedy_decode_cuda, counter)
        packed = k1q_packed(dec, dt) if route.kernel == "cluster" else None
        outs.append(fd.fused_greedy_decode_cuda(wq, k, v, packed=packed, cls0=c0, **kw))
        refs.append(fd.fused_greedy_decode_plain(wq, k, v, cls0=c0, **kw))
        if getattr(fd.fused_greedy_decode_cuda, counter) != before + 1:
            raise AssertionError(f"K1q at B={k.shape[1]}: the {route.kernel} kernel's counter "
                                 f"did not move")
        kernels.add(route.kernel)
    out, ref = torch.cat(outs), torch.cat(refs)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"K1q ({dt}, early stop {early_stop}) produced non-finite logits")
    ids = out.argmax(-1)
    return dict(err=(out - ref).abs().max().item(), agree=pruned_agreement(ids, ref.argmax(-1)),
                steps=first_eos_steps(ids, T) if early_stop else torch.full_like(ids[:, 0], T),
                kernel="/".join(sorted(kernels)))


def k1q_results(fd, dec, ck, cv, dts=(torch.float32, torch.bfloat16), cls0=None,
                batch=None) -> dict:
    """K1q against its plain version in each compute type of ``dts``, early
    stop on and off (with ``cls0`` its step-0 row; ``batch`` rows a call)."""
    return {(dt, es): k1q_vs_plain(fd, dec, ck, cv, dt, es, cls0, batch)
            for dt in dts for es in (False, True)}


def k1q_f32_ok(res: dict) -> bool:
    return all(res[torch.float32, es]["err"] <= K1Q_F32_LOGIT_TOL
               and res[torch.float32, es]["agree"] == 1.0 for es in (False, True))


def k1q_bf16_ok(res: dict) -> bool:
    return all(res[torch.bfloat16, es]["err"] <= K1Q_BF16_LOGIT_TOL
               and res[torch.bfloat16, es]["agree"] >= K1Q_BF16_AGREE for es in (False, True))


def k1q_line(res: dict) -> str:
    return "; ".join(f"{str(dt)[6:]} early stop {es}: max |logit diff| {r['err']:.3e}, "
                     f"[s]-pruned rows identical {r['agree']:.6f}" for (dt, es), r in res.items())


def k1q_cost(wq, scales, ck, row_steps, dt_bytes: int, out_bytes: int):
    """Bytes each input and output moves once (the int8 tables, the float
    ones in the compute type, the scales, memory K/V, positional rows, the
    cache writes of the steps taken, the logits) and the least time of the
    operations: the int8 projections at the int8 peak plus the class head
    and attention at the bf16 peak, for the steps each row took."""
    from multimodal_scene_text_recognition_tpu_torch.ops.fused_decode import (
        FusedDecodeWeights, QUANTIZED)

    L, Bn, Tm, E = ck.shape
    F, C = wq.ff1_w.shape[2], wq.head_w.shape[1]
    S = int(row_steps.sum())
    fields = list(zip(FusedDecodeWeights._fields, wq))[:-1]
    nbytes = (sum(t.numel() for n, t in fields if n in QUANTIZED)
              + sum(t.numel() for n, t in fields if n not in QUANTIZED) * dt_bytes
              + sum(s.numel() for s in scales) * 4 + 2 * ck.numel() * dt_bytes
              + wq.pe.numel() * 4 + 2 * L * S * E * dt_bytes + out_bytes)
    int8_ops = 2 * S * L * (E * 3 * E + 3 * E * E + 2 * E * F)
    float_ops = 2 * S * E * C + sum(L * 2 * 2 * E * ((t + 1) + Tm)
                                    for n in row_steps.tolist() for t in range(n))
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (int8_ops / PEAK_INT8_OPS + float_ops / PEAK_BF16_FLOPS) * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound_ms, bound_by, nbytes, int8_ops, float_ops


def k1q_times(fd, dec, ck, cv) -> dict:
    """K1q bf16 ms on ``dec``'s int8 tables and the cross K/V ``ck``, ``cv``
    [L, B, Tm, E], as :func:`k1_times` times K1: at full length, with
    early stop, and at full length on the first row alone; with the
    decoder's int8 units where its K1q reads them."""
    bf16 = torch.bfloat16
    wq, scales = dec.fused_weights(bf16, int8=True)
    ckd, cvd = ck.to(bf16).contiguous(), cv.to(bf16).contiguous()
    one = [t[:, :1].contiguous() for t in (ckd, cvd)]
    kw = dict(num_heads=dec.num_heads, steps=dec.max_text_length, go_id=0, eps=1e-5,
              scales=scales, packed=k1q_packed(dec, bf16))
    k1q = fd.fused_greedy_decode_cuda
    return dict(full=cuda_ms(lambda: k1q(wq, ckd, cvd, **kw), 10),
                early_stop=cuda_ms(lambda: k1q(wq, ckd, cvd, eos_id=1, **kw), 10),
                b1=cuda_ms(lambda: k1q(wq, *one, **kw), 10))


# (E, H, F, route) of K1q beyond the flagship: widths its units pad to the
# int8 k-step of 32 (heads of 12, sixteen heads, FF slices of 24, rows of 36
# in a cluster of one), and rows wider than the cluster kernel's exchange
# holds, which the plan sends to the wide-row kernel (fused_decode.cu)
K1Q_WIDTHS = ((48, 4, 128, "cluster"), (256, 16, 2048, "cluster"), (64, 4, 96, "cluster"),
              (36, 3, 100, "cluster"), (640, 8, 1024, "wide"))


# K1q at K1Q_WIDTHS against its plain version: both products are exact, but
# a float32 sum of another order (attention, layernorm) moves an activation
# across a rounding boundary of its int8 step now and then, and that moves
# every later logit of its row.  The chance grows with the values a row
# quantizes a step, L(5E + F), and the shift with the logits' scale: on an
# H100 with random tables (logits ~10) E=256 with sixteen heads read 0.334
# and E=640 0.399-0.555 with every token equal, and once (E=640, B=100) a
# row took the other token at a near tie in float32.  So the float32 logits
# are held on each row up to and at its first differing token (past it the
# rows decode different prefixes), and the rows to a share: one row of
# B=100 may differ.
K1Q_WIDTHS_F32_TOL = 1.0
K1Q_WIDTHS_F32_ROWS = 0.99
K1Q_WIDTHS_BF16_ROWS = 0.9  # the card tests' limit at random widths
K1Q_WIDTHS_BATCH = 100  # past K1Q_WIDE_BATCH: the cluster kernel where it tiles


def err_to_first_flip(got, ref) -> tuple:
    """The largest |logit difference| over each row's steps up to and at
    its first differing token (every step of a row whose tokens agree), and
    for each row whose tokens differ (row, step, the plain version's top-2
    gap at that step)."""
    diff = got.argmax(-1) != ref.argmax(-1)
    upto = (diff.int().cumsum(-1) - diff.int()) == 0
    err = torch.where(upto, (got - ref).abs().amax(-1), 0.0).max().item()
    top2 = ref.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    flips = [(r, int(diff[r].int().argmax()), gap[r, int(diff[r].int().argmax())].item())
             for r in diff.any(-1).nonzero().flatten().tolist()]
    return err, flips


def k1q_width_reading(fd, E, H, F, want) -> dict:
    """K1q at one of K1Q_WIDTHS (seeded random tables, L=2, B=
    K1Q_WIDTHS_BATCH, T=6, C=97) through the route its plan picks (which
    must be ``want``, and whose counter must move), against its plain
    version in f32 and bf16: per type the error up to each row's first
    differing token, the share of [s]-pruned rows identical, the error over
    whole rows and the flips (:func:`err_to_first_flip`)."""
    counters = {"cluster": "launches_int8", "wide": "launches_int8_wide"}
    Bw = K1Q_WIDTHS_BATCH
    w, ck, cv = random_decoder(2, E, F, 97, 6, 8, Bw, seed=E + H + F)
    wq, scales = fd.quantize_fused_weights(w)
    route = fd.k1q_route(Bw, 2, E, H, F, 97, 6, 8, torch.bfloat16)
    if route.kernel != want:
        raise AssertionError(f"K1q at E={E}, H={H}, F={F}: route {route.kernel}, not {want}")
    kw = dict(num_heads=H, steps=6, go_id=0, eps=1e-5, scales=scales)
    r = dict(route=route)
    for dt in (torch.float32, torch.bfloat16):
        wd = fd.cast_weights(wq, dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        packed = fd.pack_cluster_tables_int8(wd, H) if want == "cluster" else None
        before = getattr(fd.fused_greedy_decode_cuda, counters[want])
        got = fd.fused_greedy_decode_cuda(wd, ckd, cvd, packed=packed, **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw)
        torch.cuda.synchronize()
        if getattr(fd.fused_greedy_decode_cuda, counters[want]) != before + 1:
            raise AssertionError(f"K1q at E={E}: the {want} kernel's counter did not move")
        if not torch.isfinite(got).all():
            raise AssertionError(f"K1q at E={E}, H={H}, F={F} ({dt}): non-finite logits")
        err, flips = err_to_first_flip(got, ref)
        r[dt] = dict(err=err, rows=pruned_agreement(got.argmax(-1), ref.argmax(-1)),
                     err_all=(got - ref).abs().max().item(), flips=flips)
    return r


def k1q_widths_ok(r: dict) -> bool:
    f32, bf16 = r[torch.float32], r[torch.bfloat16]
    return (f32["err"] <= K1Q_WIDTHS_F32_TOL and f32["rows"] >= K1Q_WIDTHS_F32_ROWS
            and bf16["rows"] >= K1Q_WIDTHS_BF16_ROWS)


def k1q_width_line(r: dict) -> str:
    def flips(x):
        return ", ".join(f"row {i} step {t} top-2 gap {g:.4g}" for i, t, g in x["flips"][:4])

    return "; ".join(
        f"{str(dt)[6:]} max |logit diff| {r[dt]['err']:.3e} up to each row's first differing "
        f"token ({r[dt]['err_all']:.3e} on whole rows), rows {r[dt]['rows']:.4f}"
        + (f", {len(r[dt]['flips'])} rows differ ({flips(r[dt])})" if r[dt]["flips"] else "")
        for dt in (torch.float32, torch.bfloat16))


def check_k1q_widths(fd) -> dict:
    """K1q at K1Q_WIDTHS through the route its plan picks, against its plain
    version (:func:`k1q_width_reading`), held to K1Q_WIDTHS_F32_TOL and
    K1Q_WIDTHS_F32_ROWS in f32 and K1Q_WIDTHS_BF16_ROWS in bf16."""
    out = {}
    for E, H, F, want in K1Q_WIDTHS:
        r = k1q_width_reading(fd, E, H, F, want)
        route = r["route"]
        log(f"K1q at E={E}, H={H}, F={F} ({route.kernel} kernel"
            + (f", clusters of {route.plan.G} CTAs" if route.plan else f": {route.why}")
            + "): " + k1q_width_line(r))
        if not k1q_widths_ok(r):
            raise AssertionError(f"K1q at E={E}, H={H}, F={F} outside its limits: "
                                 + k1q_width_line(r))
        out[f"{E},{H},{F}"] = {"route": route.kernel, "f32_err": r[torch.float32]["err"],
                               "f32_rows": r[torch.float32]["rows"],
                               "f32_flips": r[torch.float32]["flips"],
                               "bf16_err": r[torch.bfloat16]["err"],
                               "bf16_rows": r[torch.bfloat16]["rows"]}
    return out


# batches at which check_k1q times K1q on both of its kernels (the route
# takes the one-row-a-CTA kernel up to K1Q_WIDE_BATCH rows)
K1Q_SWEEP = (1, 8, 64, 96, 128, 192)


def k1q_sweep(fd, dec, ck, cv) -> dict:
    """K1q bf16 ms on both kernels, whatever the route would pick, at each
    batch of K1Q_SWEEP (the first rows of ``ck``, ``cv``), at full length
    and with early stop: the measurement behind K1Q_WIDE_BATCH."""
    bf16 = torch.bfloat16
    wq, scales = dec.fused_weights(bf16, int8=True)
    packed = dec.cluster_tables(bf16, int8=True)
    T, H = dec.max_text_length, dec.num_heads
    L, _, Tm, E = ck.shape
    F, C = wq.ff1_w.shape[2], wq.head_w.shape[1]
    wide_fn = fd.launcher("fused_decode", "fused_decode_int8")
    kw = dict(num_heads=H, steps=T, go_id=0, eps=1e-5, scales=scales)

    def wide(k, v, eos):  # the one-row-a-CTA kernel, launched directly
        B = k.shape[1]
        kc = torch.zeros(L, B, T, E, dtype=bf16, device=k.device)
        out = fd._logits_buffer(B, T, C, eos, k.device)
        fd.launch(wide_fn, wq, k, v, (kc, torch.zeros_like(kc), out) + tuple(scales),
                  (B, T, L, E, F, C, H, Tm, 0, -1 if eos is None else eos), num_heads=H,
                  eps=1e-5, what="K1q sweep")
        return out

    def cluster(k, v, eos):  # the cluster kernel, launched directly
        B = k.shape[1]
        plan = fd.cluster_plan(B, L, E, H, F, C, T, Tm, bf16, int8=True)
        kc = torch.zeros(L, B, T, E, dtype=bf16, device=k.device)
        out = fd._logits_buffer(B, T, C, eos, k.device)
        fd.launch(fd.launcher("fused_decode_cluster", "fused_decode_cluster_int8"), wq, k, v,
                  (kc, torch.zeros_like(kc), out, packed, None) + tuple(scales),
                  (B, T, L, E, F, C, H, Tm, 0, -1 if eos is None else eos, plan.smem, plan.G),
                  num_heads=H, eps=1e-5, what="K1q sweep")
        return out

    out = {}
    for B in K1Q_SWEEP:
        k, v = (t[:, :B].to(bf16).contiguous() for t in (ck, cv))
        for eos in (None, 1):
            ref = fd.fused_greedy_decode_plain(wq, k, v, eos_id=eos, **kw)
            for name, fn in (("cluster", cluster), ("one row a CTA", wide)):
                got = fn(k, v, eos)
                torch.cuda.synchronize()
                if pruned_agreement(got.argmax(-1), ref.argmax(-1)) < K1Q_BF16_AGREE:
                    raise AssertionError(f"K1q sweep: the {name} kernel at B={B} parts from the "
                                         f"plain version")
                out[B, eos is not None, name] = cuda_ms(lambda: fn(k, v, eos), 10)
    log("K1q bf16 ms by batch, cluster / one row a CTA (full length; early stop): " + "; ".join(
        f"B={B} {out[B, False, 'cluster']:.3f} / {out[B, False, 'one row a CTA']:.3f} "
        f"({out[B, True, 'cluster']:.3f} / {out[B, True, 'one row a CTA']:.3f})"
        for B in K1Q_SWEEP) + f"; the route takes the one-row-a-CTA kernel up to "
        f"{fd.K1Q_WIDE_BATCH} rows")
    return {f"{B},{'early_stop' if es else 'full'},{name}": ms
            for (B, es, name), ms in out.items()}


def check_k1q(fd, model_q, image, step, k1: dict, k1e: dict):
    """K1q against its plain version at full width on the trained decoder's
    int8 tables and the cross K/V that the served int8 step (``step``: its
    rectify and features stages) makes from the B=192 crops; two launches
    bit-equal; the same at the served bucket of K1Q_WIDE_BUCKET rows, which
    the route sends to the wide-row kernel; then its plan, times with early
    stop, at full length and at B=1 beside K1's, cycles by phase, the plain
    version's time and the bound; then K1q at K1Q_WIDTHS."""
    dec = model_q.decoder
    with torch.no_grad():
        enc = model_q.encoder(step.features(step.rectify(image)))
        ck, cv = dec.cross_kv(dec.hid_to_emb(enc))
    res = k1q_results(fd, dec, ck, cv)
    log("K1q vs plain: " + k1q_line(res))
    if not k1q_f32_ok(res):
        raise AssertionError(f"K1q f32 outside its limits (logits {K1Q_F32_LOGIT_TOL}, rows "
                             f"identical 1.0): " + k1q_line(res))
    if not k1q_bf16_ok(res):
        raise AssertionError(f"K1q bf16 outside its limits (logits {K1Q_BF16_LOGIT_TOL}, rows "
                             f"{K1Q_BF16_AGREE}): " + k1q_line(res))
    wide = k1q_results(fd, dec, ck, cv, batch=K1Q_WIDE_BUCKET)
    log(f"K1q vs plain at the served bucket B={K1Q_WIDE_BUCKET} (all {ck.shape[1]} rows, "
        f"{wide[torch.float32, False]['kernel']} kernel): " + k1q_line(wide))
    if {r["kernel"] for r in wide.values()} != {"wide"}:
        raise AssertionError(f"K1q at B={K1Q_WIDE_BUCKET} did not take the wide-row kernel")
    if not (k1q_f32_ok(wide) and k1q_bf16_ok(wide)):
        raise AssertionError(f"K1q at B={K1Q_WIDE_BUCKET} outside its limits: " + k1q_line(wide))

    dt = torch.bfloat16
    wq, scales = dec.fused_weights(dt, int8=True)
    ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
    T, H = dec.max_text_length, dec.num_heads
    kw = dict(num_heads=H, steps=T, go_id=0, eps=1e-5, scales=scales)
    packed = dec.cluster_tables(dt, int8=True)
    first, again = (fd.fused_greedy_decode_cuda(wq, ckd, cvd, packed=packed, **kw)
                    for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("K1q bf16: two launches on the same input differ")
    L, _, Tm, E = ckd.shape
    F, C = wq.ff1_w.shape[2], wq.head_w.shape[1]
    route = fd.k1q_route(B, L, E, H, F, C, T, Tm, dt)
    if route.kernel != "cluster":
        raise AssertionError(f"K1q at the flagship takes the {route.kernel} kernel")
    plan = route.plan
    log(f"K1q bf16 launch: G={plan.G} CTAs a cluster, R={plan.R} rows a cluster, "
        f"{plan.clusters} clusters ({plan.ctas} CTAs), {plan.smem} B shared memory a CTA; "
        f"weight units read from L2 {plan.cta_step_bytes / 1e6:.3f} MB a CTA a step, "
        f"{plan.call_bytes(T) / 1e9:.3f} GB a full-length call")
    times = k1q_times(fd, dec, ck, cv)
    ms, ms_full, ms_b1 = times["early_stop"], times["full"], times["b1"]
    b1_route = fd.k1q_route(1, L, E, H, F, C, T, Tm, dt).kernel
    prof = torch.zeros(len(fd.INT8_CLUSTER_PHASES), dtype=torch.int64, device=ckd.device)
    fd.fused_greedy_decode_cuda(wq, ckd, cvd, packed=packed, profile=prof, **kw)
    cycles = prof.tolist()
    shares = {p: c / sum(cycles) for p, c in zip(fd.INT8_CLUSTER_PHASES, cycles)}
    log(f"K1q bf16 B=192: {sum(cycles)} cycles of CTA 0's first thread, by phase "
        + ", ".join(f"{p} {v:.3f}" for p, v in shares.items()))
    plain_ms = cuda_ms(lambda: fd.fused_greedy_decode_plain(wq, ckd, cvd, eos_id=1, **kw), 2)
    steps = res[dt, True]["steps"]
    out_bytes = B * dec.max_text_length * wq.head_w.shape[1] * 4
    bound_ms, bound_by, nbytes, int8_ops, float_ops = k1q_cost(wq, scales, ckd, steps, 2,
                                                               out_bytes)
    full = torch.full_like(steps, dec.max_text_length)
    bound_full, bound_by_full = k1q_cost(wq, scales, ckd, full, 2, out_bytes)[:2]
    log(f"K1q bf16: {ms:.3f} ms with early stop (steps per row mean "
        f"{steps.float().mean().item():.2f}, max {steps.max().item()}), {ms_full:.3f} ms at full "
        f"length, {ms_b1:.3f} ms at B=1 ({b1_route} kernel); two launches bit-identical; K1 "
        f"(float tables, same "
        f"run) {k1['ms']:.3f} ms at full length, K1e "
        f"{k1e['ms']:.3f} ms with early stop; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}; {int8_ops / 1e9:.1f} G int8 ops, {float_ops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), {bound_full:.4f} ms at full length ({bound_by_full})")
    r32 = [res[torch.float32, es] for es in (False, True)]
    r16 = [res[dt, es] for es in (False, True)]
    widths = check_k1q_widths(fd)
    sweep = k1q_sweep(fd, dec, ck, cv)
    k1q = dict(name="fused_decode_int8", route="cuda",
               source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_decode_cluster.cu",
               wide_row_source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_decode.cu",
               replaces="multimodal_scene_text_recognition_tpu/ops/fused_decode.py:239",
               jax="ops/fused_decode.py::_decode_kernel, quantized=True",
               max_abs_err=max(r["err"] for r in r32), max_abs_err_bf16=max(r["err"] for r in r16),
               rows_identical_f32=min(r["agree"] for r in r32),
               rows_identical_bf16=min(r["agree"] for r in r16),
               wide_bucket=K1Q_WIDE_BUCKET,
               wide_max_abs_err=max(wide[torch.float32, es]["err"] for es in (False, True)),
               wide_max_abs_err_bf16=max(wide[dt, es]["err"] for es in (False, True)),
               wide_rows_identical_bf16=min(wide[dt, es]["agree"] for es in (False, True)),
               ms=ms, ms_full_length=ms_full,
               ms_b1=ms_b1, b1_kernel=b1_route, wide_row_max_batch=fd.K1Q_WIDE_BATCH,
               phase_shares=shares, clusters=plan.clusters, cluster_ctas=plan.G,
               l2_weight_bytes_full_length=plan.call_bytes(T), widths=widths, batch_ms=sweep,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_ms_full_length=bound_full, bound_by_full_length=bound_by_full,
               library_ms=None, mean_steps=steps.float().mean().item(),
               k1_ms_full_length=k1["ms"],
               k1e_ms=k1e["ms"])
    return k1q, (dec, ck, cv)


# the width at which --mutants reads each K1q kernel's faults beside the
# sound kernel, at K1Q_WIDTHS' limits: a padded cluster width (sixteen
# heads of 16) and the wide-row kernel's E=640
K1Q_MUTANT_WIDTHS = {K1_SOURCE: (256, 16, 2048, "cluster"),
                     K1Q_WIDE_SOURCE: (640, 8, 1024, "wide")}


def check_k1q_mutants(fd, build, dec, ck, cv):
    """K1q's limits against broken copies of its two kernels: K1Q_MUTANTS
    of the cluster kernel, held on all rows at once, and K1Q_WIDE_MUTANTS
    of the wide-row kernel, held a served bucket of K1Q_WIDE_BUCKET rows at
    a time, each against the plain version as the kernel is, in bf16 and in
    f32; raises if the limits miss one.  Each is also read at its kernel's
    width of K1Q_MUTANT_WIDTHS against K1Q_WIDTHS' limits (printed, not
    required)."""
    missed = []
    for source, mutants, batch in ((K1_SOURCE, K1Q_MUTANTS, None),
                                   (K1Q_WIDE_SOURCE, K1Q_WIDE_MUTANTS, K1Q_WIDE_BUCKET)):
        E, H, F, want = K1Q_MUTANT_WIDTHS[source]
        with mutant_libraries(build, source, mutants) as paths:
            for (name, _, _), path in zip(mutants, paths):
                with loaded_as(build, source, path):
                    res = k1q_results(fd, dec, ck, cv, batch=batch)
                    wr = k1q_width_reading(fd, E, H, F, want)
                caught = not (k1q_bf16_ok(res) and k1q_f32_ok(res))
                log(f"K1q mutant of {source}.cu, {name}: {k1q_line(res)}; caught by the bf16 "
                    f"limits {not k1q_bf16_ok(res)}, by the f32 limits {not k1q_f32_ok(res)}; "
                    f"at E={E}, H={H}, F={F}: {k1q_width_line(wr)}; caught by the widths' "
                    f"limits {not k1q_widths_ok(wr)}")
                if not caught:
                    missed.append(f"{source}.cu: {name}")
    if missed:
        raise AssertionError(f"K1q's limits missed the mutants {missed}")


def int8_phase(api, fd, fb, gs, build, crops, texts, btexts, k1, k1e, mutants: bool):
    """Serve the trained flagship in int8 mode through ``api.get_model`` ->
    ``Recognizer(int8_backbone=True)`` with the committed scales (found
    beside the bundle): K1q against its plain version, the served greedy
    and beam calls with their launches against the plain path's strings
    and the bf16 flagship's, throughput, stage split and idle share."""
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer

    cfg = dataclasses.replace(FLAGSHIP, decode_early_stop=True, decode_beam_fused=True,
                              decode_int8=True, encoder_int8=True, tps_int8=True)
    model_q = api.get_model(BUNDLE, cfg)
    rec_q = Recognizer(model_q, batch_sizes=(1, 8, 64, B), int8_backbone=True)
    if rec_q.int8_scales_path != SCALES or rec_q._int8_absmax is None:
        raise AssertionError(f"the int8 recognizer did not load {SCALES}")
    fd.fused_greedy_decode_cuda.launches = fd.fused_greedy_decode_cuda.launches_int8 = 0
    fd.fused_greedy_decode_cuda.launches_int8_wide = 0
    gs.grid_sample_cuda.launches = 0
    texts_q = rec_q.recognize(crops)
    launches = {"fused_decode_int8": fd.fused_greedy_decode_cuda.launches_int8,
                "grid_sample": gs.grid_sample_cuda.launches,
                "fused_decode (float)": fd.fused_greedy_decode_cuda.launches,
                "fused_decode_int8 (wide rows)": fd.fused_greedy_decode_cuda.launches_int8_wide}
    log(f"served {len(texts_q)} crops in int8 mode; kernel launches {launches}; "
        f"e.g. {texts_q[:4]}")
    if launches["fused_decode_int8"] < 1 or launches["grid_sample"] < 1:
        raise AssertionError(f"the int8 served path did not launch K1q and K2: {launches}")
    if launches["fused_decode (float)"] != 0 or launches["fused_decode_int8 (wide rows)"] != 0:
        raise AssertionError(f"the int8 served path launched another decode kernel: {launches}")
    if len(texts_q) != B or not any(texts_q):
        raise AssertionError("the int8 recognizer returned no strings")
    # a request of K1Q_WIDE_BUCKET crops, a served bucket the route sends to
    # the wide-row kernel
    small = crops[:K1Q_WIDE_BUCKET]
    fd.fused_greedy_decode_cuda.launches_int8 = fd.fused_greedy_decode_cuda.launches_int8_wide = 0
    texts_s = rec_q.recognize(small)
    launches_s = {"fused_decode_int8": fd.fused_greedy_decode_cuda.launches_int8,
                  "fused_decode_int8 (wide rows)": fd.fused_greedy_decode_cuda.launches_int8_wide}
    model_q.set_use_kernels(False)
    plain_s = rec_q.recognize(small)
    plain_q = rec_q.recognize(crops)
    model_q.set_use_kernels(True)
    agree_s = sum(a == b for a, b in zip(texts_s, plain_s)) / len(small)
    log(f"served {len(small)} crops in int8 mode: K1q launches {launches_s}; strings, kernels "
        f"vs plain versions, {agree_s:.4f} identical (limit 0.98)")
    if launches_s != {"fused_decode_int8": 0, "fused_decode_int8 (wide rows)": 1}:
        raise AssertionError(f"the int8 call of {len(small)} crops did not take the wide-row "
                             f"kernel once: {launches_s}")
    if not agree_s >= 0.98:
        raise AssertionError(f"int8 end-to-end agreement at {len(small)} crops {agree_s} < 0.98")
    agree_q = sum(a == b for a, b in zip(texts_q, plain_q)) / B
    vs_bf16 = sum(a == b for a, b in zip(texts_q, texts)) / B
    log(f"int8 strings, kernels vs plain versions: {agree_q:.4f} identical (limit 0.98); "
        f"int8 vs the bf16 flagship's strings: {vs_bf16:.4f} identical (for information)")
    if not agree_q >= 0.98:
        raise AssertionError(f"int8 end-to-end agreement {agree_q} < 0.98")
    # where the strings part from the bf16 flagship's: the same int8 serving
    # with the float loc-net (tps_int8 off)
    model_f = api.get_model(BUNDLE, dataclasses.replace(cfg, tps_int8=False))
    texts_f = Recognizer(model_f, batch_sizes=(B,), int8_backbone=True).recognize(crops)
    del model_f
    log(f"int8 with the float loc-net vs the bf16 flagship's strings: "
        f"{sum(a == b for a, b in zip(texts_f, texts)) / B:.4f} identical; vs int8 with the "
        f"int8 loc-net {sum(a == b for a, b in zip(texts_f, texts_q)) / B:.4f} (for information)")

    fb.fused_beam_decode_cuda.launches = gs.grid_sample_cuda.launches = 0
    btexts_q, bscores_q = rec_q.recognize(crops, beam_size=BEAM, return_scores=True)
    blaunches = {"fused_beam": fb.fused_beam_decode_cuda.launches,
                 "grid_sample": gs.grid_sample_cuda.launches}
    if min(blaunches.values()) < 1:
        raise AssertionError(f"the int8 beam path did not launch K4 and K2: {blaunches}")
    if not np.isfinite(bscores_q).all() or max(bscores_q) > 0:
        raise AssertionError("int8 beam serving: scores not finite and <= 0")
    model_q.set_use_kernels(False)
    plain_bq = rec_q.recognize(crops, beam_size=BEAM)
    model_q.set_use_kernels(True)
    agree_bq = sum(a == b for a, b in zip(btexts_q, plain_bq)) / B
    bvs_bf16 = sum(a == b for a, b in zip(btexts_q, btexts)) / B
    log(f"int8 beam (k={BEAM}): launches {blaunches}; kernels vs plain versions "
        f"{agree_bq:.4f} identical (limit 0.98); vs the bf16 flagship's beam strings "
        f"{bvs_bf16:.4f} (for information)")
    if not agree_bq >= 0.98:
        raise AssertionError(f"int8 beam end-to-end agreement {agree_bq} < 0.98")

    image = rec_q.prepare(crops, B)[0]
    step_q = rec_q._int8_steps[None]  # the greedy step the served calls ran
    k1q, (dec, ck, cv) = check_k1q(fd, model_q, image, step_q, k1, k1e)
    k1q["launches"] = launches["fused_decode_int8"]
    k1q["launches_wide_bucket"] = launches_s["fused_decode_int8 (wide rows)"]
    if mutants:
        phase("K1q mutants")
        check_k1q_mutants(fd, build, dec, ck, cv)

    phase("int8 timing")
    ms_call = cuda_ms(lambda: rec_q.recognize(crops), 10)
    ms_beam = cuda_ms(lambda: rec_q.recognize(crops, beam_size=BEAM), 10)
    log(f"int8 throughput: greedy {B / ms_call * 1e3:.1f} crops/s ({ms_call:.2f} ms per "
        f"{B}-crop call), beam {B / ms_beam * 1e3:.1f} crops/s ({ms_beam:.2f} ms), 10 warm "
        f"calls each, CUDA events")
    stages = stage_times(model_q, rec_q, crops,
                         lambda enc: model_q.decoder.greedy_decode(enc).argmax(-1),
                         rectify=step_q.rectify, features=step_q.features)
    log("int8 stage ms (median of 10; rectify = int8 loc-net + TPS + K2, features = int8 "
        "backbone, encoder = int8 encoder, decoder = cross K/V + K1q): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
    bstages = stage_times(model_q, rec_q, crops,
                          lambda enc: model_q.decoder.beam_decode(enc, beam_size=BEAM)[0],
                          rectify=step_q.rectify, features=step_q.features)
    log("int8 beam stage ms (median of 10; decoder = cross K/V + K4, bf16 tables, early stop): "
        + ", ".join(f"{k} {v:.3f}" for k, v in bstages.items()))
    prof = kernel_profile(lambda: rec_q.recognize(crops), calls=3)
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiler saw no kernel run on the card")
    log(f"int8 profile of {prof['calls']} calls: wall {prof['wall_ms']:.2f} ms, kernels busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.4f}; by kernel "
        f"{prof['kernels_ms']}")
    summary = {"string_agreement_kernels_vs_plain": agree_q, "vs_bf16_strings": vs_bf16,
               "beam_string_agreement_kernels_vs_plain": agree_bq,
               "beam_vs_bf16_strings": bvs_bf16, "crops_per_s": B / ms_call * 1e3,
               "ms_per_call": ms_call, "beam_crops_per_s": B / ms_beam * 1e3,
               "beam_ms_per_call": ms_beam, "batch": B, "stage_ms": stages,
               "beam_stage_ms": bstages, "profile": prof,
               "launches": launches, "beam_launches": blaunches}
    del model_q, rec_q
    torch.cuda.empty_cache()
    return k1q, summary, blaunches


def stage_times(model, rec, crops, decode, reps: int = 10, rectify=None, features=None):
    """Median CUDA-event milliseconds of each stage of one recognize call:
    host preparation and upload, TPS rectification (``rectify``, default
    the model's), ResNet-31 features (``features``: rectified -> columns,
    default the model's), semantics + encoder, decoder (``decode(enc)`` ->
    ids: cross K/V and the decode kernel), strings."""
    rectify = rectify or model.rectify
    features = features or model.features
    names = ["prepare", "rectify", "features", "encoder", "decoder", "decode_strings"]
    samples = {n: [] for n in names}
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        with torch.no_grad():
            ev[0].record()
            image, overlap, scene, ious = rec.prepare(crops, len(crops))
            ev[1].record()
            rect = rectify(image)
            ev[2].record()
            cols = features(rect)
            ev[3].record()
            model.semantics(overlap, scene, ious)
            enc = model.encoder(cols)
            ev[4].record()
            ids = decode(enc)
            ev[5].record()
            rec.codec.decode(ids.cpu().numpy())
            ev[6].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(v[1:]) for n, v in samples.items()}


def kernel_profile(fn, calls: int):
    """``torch.profiler`` over ``calls`` warm calls of ``fn()``: device time
    per kernel name (its first 80 characters; the largest 12), the wall
    time of the calls, the share of it with no kernel running (the card's
    idle share), and K3's device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end  # microseconds
        per_name[e.name] = per_name.get(e.name, 0.0) + (end - start) / 1e3
        spans.append((start, end))
    busy_us, last = 0.0, None
    for s, t in sorted(spans):  # union of kernel intervals
        if last is None or s > last:
            busy_us += t - s
            last = t
        elif t > last:
            busy_us += t - last
            last = t
    short = {}  # by the first 80 characters of the name: instantiations of one template add up
    for k, v in per_name.items():
        short[k[:80]] = short.get(k[:80], 0.0) + v
    top = sorted(short.items(), key=lambda kv: -kv[1])[:12]
    bn_ms = sum(v for k, v in per_name.items() if "bn_backward_kernel" in k)
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms, "bn_backward_ms": bn_ms,
            "kernels_ms": dict(top)}


# -- the semantic phase: the cls0 rows of K1/K1e/K1q and K4, and the served
# -- semantic-fusion recognizer

SEMANTIC_SEED = 8  # the random weights of the semantic model (no trained bundle holds them)


def semantic_config(flagship):
    """The served semantic configuration: the combined overlap + scene
    embedder and every fusion hook the fused kernels carry (pre-encoder and
    pre-decoder fusion, the semantic CLS step-0 row), early stop, fused
    beam."""
    return dataclasses.replace(flagship, semantic_vector="combined", pre_encoder_mlp=True,
                               pre_decoder_mlp=True, cls_decoder_init=True,
                               decode_early_stop=True, decode_beam_fused=True)


def make_semantics(n: int, seed: int):
    """Seeded objects per crop, as a detector hands them over: overlap ids
    [n, 15] and scene ids [n, 52] in 1..1999, each row with trailing 0 pads,
    scene ious float32 with -1000 at the pads."""
    rng = np.random.default_rng(seed)
    ov = rng.integers(1, 2000, (n, 15))
    sc = rng.integers(1, 2000, (n, 52))
    ious = rng.uniform(0.0, 1.0, (n, 52)).astype(np.float32)
    for i in range(n):
        ov[i, rng.integers(4, 16):] = 0
        pad = rng.integers(8, 53)
        sc[i, pad:] = 0
        ious[i, pad:] = -1000.0
    return {"overlap": ov, "scene": sc, "ious": ious}


def random_cls0(seed: int, E: int):
    """A seeded N(0, 1) step-0 row per batch row, float32 [B, E] on the
    card.  The model's own cls0 is all ones up to rounding (its softmax over
    memory positions is summed over the same axis), which cannot tell a
    kernel that reads it from one that writes 1.0 or reads row 0 for every
    row; a random one can."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, E)).astype(np.float32)).cuda()


def greedy_vs_plain(fd, dec, ck, cv, dt, early_stop: bool, cls0) -> dict:
    """K1 (with ``early_stop`` K1e) on the trained decoder in compute type
    ``dt`` with step-0 rows ``cls0`` (or none), against its plain version:
    the largest logit difference, token and [s]-pruned row agreement, the
    steps the rows took, and the smallest over rows of the largest step-0
    logit change from the same launch without cls0."""
    T = dec.max_text_length
    wd = dec.fused_weights(dt)
    ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
    kw = dict(num_heads=dec.num_heads, steps=T, go_id=0, eos_id=1 if early_stop else None,
              eps=1e-5)
    ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, cls0=cls0, **kw)
    kw["packed"] = dec.cluster_tables(dt)
    out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, cls0=cls0, **kw)
    without = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw) if cls0 is not None else out
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"K1 ({dt}, early stop {early_stop}, cls0 {cls0 is not None}): "
                             f"non-finite logits")
    ids, ref_ids = out.argmax(-1), ref.argmax(-1)
    full = torch.full_like(ids[:, 0], T)
    where = (out - ref).abs().amax(-1)  # [B, T]
    worst = divmod(int(where.argmax()), T)
    flips = [(b, t, (lambda v: (v[0] - v[1]).item())(ref[b, t].topk(2).values))
             for b, t in (ids != ref_ids).nonzero().tolist()[:3]]
    return dict(err=(out - ref).abs().max().item(), worst=worst, flips=flips,
                tokens=(ids == ref_ids).float().mean().item(),
                rows=pruned_agreement(ids, ref_ids),
                steps=first_eos_steps(ids, T) if early_stop else full,
                steps_without=first_eos_steps(without.argmax(-1), T) if early_stop else full,
                step0_moved=(out[:, 0] - without[:, 0]).abs().amax(-1).min().item())


# K1's bf16 roundings dropped (the ReLU outputs': rounded toward zero) one
# at a time, for --mutants: (name, text in K1_SOURCE.cu or the shared
# headers, replacement); they set the limit of K1 with a random cls0
K1_MUTANTS = (
    ("probabilities", "pr[s] = Num<T>::round(pr[s] / sum);", "pr[s] = pr[s] / sum;"),
    ("q*K products",
     "acc[w] += Num<T>::round(Num<T>::round(qr[d + u * VW + i2]) * widen<T>(kv[w][u], i2));",
     "acc[w] += Num<T>::round(qr[d + u * VW + i2]) * widen<T>(kv[w][u], i2);"),
    ("value products", "acc[i2] += Num<T>::round(pr[s0 + j] * widen<T>(vv[j], i2));",
     "acc[i2] += pr[s0 + j] * widen<T>(vv[j], i2);"),
    # ff2 takes the ReLU outputs as a bf16 operand of the tensor cores, so
    # their rounding cannot be dropped: this copy rounds them toward zero
    ("ReLU outputs", "Num<T>::from_f(epilogue<T, kReluRound>(v, bias, bi));",
     "(T)__float2bfloat16_rz(fmaxf(v + Num<T>::to_f(bias[bi]), 0.0f));"),
)


# copies of K1 with one part of its step left out, timed (not checked) with
# --mutants to split its time by phase: (name, text, replacement).  The
# exchange has none: left out, its mbarrier waits would never end; nor the
# wait for the weight stream: a copy without it hung the card when run
# after the others in one process.
K1_TIMING_VARIANTS = (
    ("without the attention key loads",
     "if (d + u * VW < hd) kv[w][u] = load16(kr[w] + (size_t)s * ps + d + u * VW);",
     "if (d + u * VW < 0) kv[w][u] = load16(kr[w] + (size_t)s * ps + d + u * VW);"),
    ("without the attention value loads",
     "if (s0 + j < len) vv[j] = load16(vr[w] + (size_t)(s0 + j) * ps + d);",
     "if (s0 + j < 0) vv[j] = load16(vr[w] + (size_t)(s0 + j) * ps + d);"),
    ("without the weight stream",
     'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst), "l"(src) : "memory");',
     ""),
    ("without the tensor-core products", "mma(d0, af.v[m], b0);\n      mma(d1, af.v[m], b1);", ""),
)


def time_k1_variants(fd, build, dec, ck, cv) -> dict:
    """K1 bf16 at full length, B=192 and B=1, with each of
    K1_TIMING_VARIANTS built in (their results are wrong and not read),
    beside the kernel itself in the same loop; ms by CUDA events."""
    packed = dec.cluster_tables(torch.bfloat16)
    times = lambda: k1_times(fd, dec, ck, cv, packed=packed)  # noqa: E731
    out = {"kernel": times()}
    log("K1 timing variants: building")
    with mutant_libraries(build, K1_SOURCE, K1_TIMING_VARIANTS) as paths:
        for (name, _, _), path in zip(K1_TIMING_VARIANTS, paths):
            log(f"K1 timing variant {name}")
            with loaded_as(build, K1_SOURCE, path):
                out[name] = times()
    log("K1 bf16 ms at full length, B=192 / B=1, with a part of the step left out: " + "; ".join(
        f"{k} {t['full']:.3f} / {t['b1']:.3f}" for k, t in out.items()))
    return out


def check_k1_cls0_mutants(fd, build, dec, ck, cv, cls0):
    """K1's bf16 limits with and without a random cls0 against broken
    copies of it (K1_MUTANTS), each held against the plain version as the
    kernel is, at full length."""
    with mutant_libraries(build, K1_SOURCE, K1_MUTANTS) as paths:
        for (name, _, _), path in zip(K1_MUTANTS, paths):
            with loaded_as(build, K1_SOURCE, path):
                r = {c is not None: greedy_vs_plain(fd, dec, ck, cv, torch.bfloat16, False, c)
                     for c in (None, cls0)}
            log(f"K1 mutant without the bf16 rounding of the {name}: max |logit diff| "
                f"{r[False]['err']:.3e} without cls0 (caught by {BF16_LOGIT_TOL}: "
                f"{r[False]['err'] > BF16_LOGIT_TOL}), {r[True]['err']:.3e} with it (caught "
                f"by {CLS0_BF16_LOGIT_TOL}: {r[True]['err'] > CLS0_BF16_LOGIT_TOL}); tokens "
                f"identical {r[False]['tokens']:.6f} / {r[True]['tokens']:.6f}")


def check_cls0_kernels(fd, fb, build, dec, ck, cv, mutants: bool) -> tuple:
    """K1-cls0 (K1, K1e and K1q modes) and K4-cls0 against their plain
    versions on the trained flagship decoder and the cross K/V of the
    smoke's B=192 crops, with a random cls0 [192, 256] and the limits the
    modes have without it (K1 and K1e in bf16: CLS0_BF16_LOGIT_TOL); their
    times with cls0 beside those without it, their plain versions' and
    bounds.  Returns the two kernel entries and the list of the limits
    broken (every check runs and prints first)."""
    cls0 = random_cls0(SEMANTIC_SEED, dec.d_model)
    failures = []
    T, H = dec.max_text_length, dec.num_heads
    f32, bf16 = torch.float32, torch.bfloat16
    g = {(dt, es): greedy_vs_plain(fd, dec, ck, cv, dt, es, cls0)
         for dt in (f32, bf16) for es in (False, True)}
    for (dt, es), r in g.items():
        log(f"K1{'e' if es else ''} with cls0, {str(dt)[6:]}: kernel vs plain max |logit diff| "
            f"{r['err']:.3e} (row, step {r['worst']}), tokens identical {r['tokens']:.6f} "
            f"(first differing (row, step, plain's top-2 logit gap) {r['flips']}), [s]-pruned "
            f"rows {r['rows']:.6f}; step-0 logits moved by cls0 at least "
            f"{r['step0_moved']:.3e} in every row")
        if not r["step0_moved"] > 1e-3:
            failures.append(f"K1 with cls0 ({dt}, early stop {es}): step-0 logits as without "
                            f"it ({r['step0_moved']})")
        agree = r["rows"] if es else r["tokens"]
        ok = (r["err"] <= 1e-3 and agree == 1.0) if dt == f32 else (
            r["err"] <= CLS0_BF16_LOGIT_TOL and agree >= 0.99)
        if not ok:
            failures.append(f"K1 with cls0 ({dt}, early stop {es}): max |logit diff| "
                            f"{r['err']}, agreement {agree} (limits 1e-3 and 1.0 in f32, "
                            f"{CLS0_BF16_LOGIT_TOL} and 0.99 in bf16)")
    if mutants:
        check_k1_cls0_mutants(fd, build, dec, ck, cv, cls0)
    for batch in (None, K1Q_WIDE_BUCKET):
        q = k1q_results(fd, dec, ck, cv, cls0=cls0, batch=batch)
        where = f"{q[f32, False]['kernel']} kernel" + (f", B={batch}" if batch else "")
        log(f"K1q with cls0 vs plain ({where}): " + k1q_line(q))
        if not (k1q_f32_ok(q) and k1q_bf16_ok(q)):
            failures.append(f"K1q with cls0 ({where}) outside K1q's limits: " + k1q_line(q))
    b = {(dt, es): beam_vs_plain(fb, dec, ck, cv, dt, es, cls0)
         for dt in (f32, bf16) for es in (False, True)}
    for (dt, es), r in b.items():
        log(f"K4 with cls0, {str(dt)[6:]} early stop {es}: kernel vs plain, {beam_line(r)}")
        ok = (r["best"] == 1.0 and r["err_best"] <= 1e-3) if dt == f32 else beam_bf16_ok(r)
        if not ok:
            failures.append(f"K4 with cls0 ({dt}, early stop {es}) outside K4's limits: "
                            f"{beam_line(r)}")

    # times in bf16, each with cls0 beside the same launch without it
    wd, (wq, scales) = dec.fused_weights(bf16), dec.fused_weights(bf16, int8=True)
    packed, packed_q = dec.cluster_tables(bf16), dec.cluster_tables(bf16, int8=True)
    ckd, cvd = ck.to(bf16).contiguous(), cv.to(bf16).contiguous()
    kw = dict(num_heads=H, steps=T, go_id=0, eps=1e-5)
    bkw = dict(beam_size=BEAM, num_heads=H, steps=T, go_id=0, eos_id=1, eps=1e-5)
    launches = {
        "K1": lambda c: fd.fused_greedy_decode_cuda(wd, ckd, cvd, cls0=c, packed=packed, **kw),
        "K1e": lambda c: fd.fused_greedy_decode_cuda(wd, ckd, cvd, eos_id=1, cls0=c,
                                                     packed=packed, **kw),
        "K1q": lambda c: fd.fused_greedy_decode_cuda(wq, ckd, cvd, scales=scales, cls0=c,
                                                     packed=packed_q, **kw),
        "K1q early stop": lambda c: fd.fused_greedy_decode_cuda(wq, ckd, cvd, eos_id=1,
                                                                scales=scales, cls0=c,
                                                                packed=packed_q, **kw),
        "K4": lambda c: fb.fused_beam_decode_cuda(wd, ckd, cvd, cls0=c, **bkw),
        "K4 early stop": lambda c: fb.fused_beam_decode_cuda(wd, ckd, cvd, early_stop=True,
                                                             cls0=c, **bkw)}
    ms = {}
    for name, fn in launches.items():
        ms[name] = (cuda_ms(lambda: fn(cls0), 10), cuda_ms(lambda: fn(None), 10))
    # with early stop a CTA runs until its rows end: cls0 changes the tokens
    # and so the steps, and a launch lasts as long as its longest rows
    bsteps_without = first_eos_steps(launches["K4 early stop"](None)[0], T)
    pairs = (("K1e", g[bf16, True]["steps"], g[bf16, True]["steps_without"]),
             ("K4", b[bf16, True]["steps"], bsteps_without))
    steps_line = "; ".join(
        f"{k}: mean {w.float().mean().item():.2f} max {w.max().item()} with cls0, mean "
        f"{wo.float().mean().item():.2f} max {wo.max().item()} without" for k, w, wo in pairs)
    plain_k1 = cuda_ms(lambda: fd.fused_greedy_decode_plain(wd, ckd, cvd, eos_id=1, cls0=cls0,
                                                            **kw), 2)
    plain_k4 = cuda_ms(lambda: fb.fused_beam_decode_plain(wd, ckd, cvd, early_stop=True,
                                                          cls0=cls0, **bkw), 2)
    log("times with cls0 / without, bf16, ms (10 launches each, CUDA events): " + ", ".join(
        f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in ms.items())
        + f"; plain with cls0: K1e {plain_k1:.3f}, K4 early stop {plain_k4:.3f}; steps per row "
        f"(bf16 early stop): {steps_line}")
    cls0_bytes = cls0.numel() * 4
    steps = g[bf16, True]["steps"]
    nb, fl = loop_cost(wd, ckd, 1, steps, 2, B * T * wd.head_w.shape[1] * 4)
    k1_bound, k1_by = bound(nb + cls0_bytes, fl, PEAK_BF16_FLOPS)
    nb_f, fl_f = decode_cost(wd, ckd, T, 2)
    k1_bound_full, _ = bound(nb_f + cls0_bytes, fl_f, PEAK_BF16_FLOPS)
    bsteps = b[bf16, True]["steps"]
    nb, fl = loop_cost(wd, ckd, BEAM, bsteps, 2, b[bf16, True]["out_bytes"])
    k4_bound, k4_by = bound(nb + cls0_bytes, fl, PEAK_BF16_FLOPS)
    nb, fl = loop_cost(wd, ckd, BEAM, torch.full_like(bsteps, T), 2, b[bf16, True]["out_bytes"])
    k4_bound_full, _ = bound(nb + cls0_bytes, fl, PEAK_BF16_FLOPS)
    log(f"bounds with cls0: K1e {k1_bound:.4f} ms ({k1_by}; steps per row mean "
        f"{steps.float().mean().item():.2f}), K1 at full length {k1_bound_full:.4f} ms; K4 "
        f"early stop {k4_bound:.4f} ms ({k4_by}; steps per row mean "
        f"{bsteps.float().mean().item():.2f}), at full length {k4_bound_full:.4f} ms")
    k1c = dict(name="fused_decode_cls0", route="cuda",
               source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_decode_cluster.cu",
               replaces="multimodal_scene_text_recognition_tpu/ops/fused_decode.py:294",
               jax="ops/fused_decode.py::_decode_kernel, use_cls (cls0 step-0 row)",
               max_abs_err=max(r["err"] for (dt, _), r in g.items() if dt == f32),
               max_abs_err_bf16=max(r["err"] for (dt, _), r in g.items() if dt == bf16),
               k1q_max_abs_err=max(r["err"] for (dt, _), r in q.items() if dt == f32),
               k1q_max_abs_err_bf16=max(r["err"] for (dt, _), r in q.items() if dt == bf16),
               ms=ms["K1e"][0], ms_without_cls0=ms["K1e"][1],
               ms_full_length=ms["K1"][0], ms_full_length_without_cls0=ms["K1"][1],
               k1q_ms=ms["K1q early stop"][0], k1q_ms_without_cls0=ms["K1q early stop"][1],
               k1q_ms_full_length=ms["K1q"][0], k1q_ms_full_length_without_cls0=ms["K1q"][1],
               plain_ms=plain_k1, bound_ms=k1_bound, bound_by=k1_by,
               bound_ms_full_length=k1_bound_full, library_ms=None,
               mean_steps=steps.float().mean().item())
    k4c = dict(name="fused_beam_cls0", route="cuda",
               source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_beam_grid.cu",
               replaces="multimodal_scene_text_recognition_tpu/ops/fused_beam.py:170",
               jax="ops/fused_beam.py::_beam_kernel, cls0 step-0 row of every beam",
               max_abs_err=max(r["err"] for (dt, _), r in b.items() if dt == f32),
               max_abs_err_bf16=max(r["err"] for (dt, _), r in b.items() if dt == bf16),
               best_beam_agreement_bf16=min(r["best"] for (dt, _), r in b.items() if dt == bf16),
               all_beam_agreement_bf16=min(r["beams"] for (dt, _), r in b.items() if dt == bf16),
               ms=ms["K4 early stop"][0], ms_without_cls0=ms["K4 early stop"][1],
               ms_full_length=ms["K4"][0], ms_full_length_without_cls0=ms["K4"][1],
               plain_ms=plain_k4, bound_ms=k4_bound, bound_by=k4_by,
               bound_ms_full_length=k4_bound_full, library_ms=None,
               mean_steps=bsteps.float().mean().item())
    return k1c, k4c, failures


def semantic_stage_times(model, rec, crops, sem, decode, reps: int = 10, rectify=None,
                         features=None):
    """:func:`stage_times` of a semantic recognize call, with the stage
    ``semantics + fusion MLPs``: the embedder and the pre-encoder fusion
    before the encoder, the pre-decoder fusion and the semantic CLS vector
    after it.  ``decode(memory, cls0, semantics)`` -> ids is the decoder
    stage (cross K/V and the kernel)."""
    rectify = rectify or model.rectify
    features = features or model.features
    names = ["prepare", "rectify", "features", "semantics + fusion MLPs", "encoder", "decoder",
             "decode_strings"]
    samples = {n: [] for n in names}
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
        with torch.no_grad(), model.precision():
            ev[0].record()
            image, overlap, scene, ious = rec.prepare(crops, len(crops), semantics=sem)
            ev[1].record()
            rect = rectify(image)
            ev[2].record()
            cols = features(rect)
            ev[3].record()
            s = model.semantics(overlap, scene, ious)
            x = model.encoder.fuse(cols, s)
            ev[4].record()
            enc = model.encoder.encode(x)
            ev[5].record()
            memory, cls0 = model.decoder.memory_and_cls0(enc, s)
            ev[6].record()
            ids = decode(memory, cls0, s)
            ev[7].record()
            rec.codec.decode(ids.cpu().numpy())
            ev[8].record()
        torch.cuda.synchronize()
        t = [ev[i].elapsed_time(ev[i + 1]) for i in range(8)]
        for n, v in zip(names, (t[0], t[1], t[2], t[3] + t[5], t[4], t[6], t[7])):
            samples[n].append(v)
    return {n: statistics.median(v[1:]) for n, v in samples.items()}


def semantic_phase(api, fd, fb, gs, build, crops, mutants: bool):
    """The kernel checks of the cls0 rows on the trained flagship decoder,
    then the semantic configuration served through ``api.get_model(None,
    cfg, seed)`` -> ``Recognizer.recognize(crops, semantics=)`` at B=192
    with seeded objects: greedily, by beam search (k=5), greedily with
    ``post_decoder_mlp`` and in int8 (calibrated on the crops: the
    committed scales belong to the trained flagship), each checked for its
    kernel launches, held against the plain path's strings and timed, with
    its stage split and idle share; then greedy, beam and
    ``post_decoder_mlp`` in float32 with TF32 turned on by the caller,
    which must give the plain path's strings exactly.  ``mutants`` adds
    K1_MUTANTS with and without cls0.  Every check runs and prints before
    the phase raises on the limits broken."""
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer

    model = api.get_model(BUNDLE)
    image = Recognizer(model).prepare(crops, B)[0]
    dec, ck, cv = beam_inputs(model, image)
    k1c, k4c, failures = check_cls0_kernels(fd, fb, build, dec, ck, cv, mutants)
    del model, dec, ck, cv
    torch.cuda.empty_cache()

    cfg = semantic_config(FLAGSHIP)
    sem = make_semantics(B, SEMANTIC_SEED)
    int8 = dict(decode_int8=True, encoder_int8=True, tps_int8=True)
    calls = {  # name: (config changes, beam size, int8 backbone)
        "greedy": ({}, 0, False),
        "beam": ({}, BEAM, False),
        "post_decoder_mlp greedy": ({"post_decoder_mlp": True}, 0, False),
        "int8 greedy": (int8, 0, True),
    }
    summary, served = {}, {}
    for name, (changes, beam_size, int8_backbone) in calls.items():
        if name != "beam":  # beam search serves the greedy call's model
            model = api.get_model(None, dataclasses.replace(cfg, **changes), seed=SEMANTIC_SEED)
            rec = Recognizer(model, batch_sizes=(1, 8, 64, B), int8_backbone=int8_backbone)
        for counter in ("launches", "launches_int8", "launches_cls0"):
            setattr(fd.fused_greedy_decode_cuda, counter, 0)
        fb.fused_beam_decode_cuda.launches = fb.fused_beam_decode_cuda.launches_cls0 = 0
        gs.grid_sample_cuda.launches = 0
        texts, scores = rec.recognize(crops, beam_size, return_scores=True, semantics=sem)
        n = {"fused_decode": fd.fused_greedy_decode_cuda.launches,
             "fused_decode_int8": fd.fused_greedy_decode_cuda.launches_int8,
             "fused_decode with cls0": fd.fused_greedy_decode_cuda.launches_cls0,
             "fused_beam": fb.fused_beam_decode_cuda.launches,
             "fused_beam with cls0": fb.fused_beam_decode_cuda.launches_cls0,
             "grid_sample": gs.grid_sample_cuda.launches}
        want = (["fused_beam", "fused_beam with cls0"] if beam_size else
                ["fused_decode_int8" if int8_backbone else "fused_decode",
                 "fused_decode with cls0"]) + ["grid_sample"]
        log(f"semantic {name}: served {len(texts)} crops; kernel launches {n}; e.g. "
            f"{texts[:3]}")
        if min(n[k] for k in want) < 1:
            raise AssertionError(f"the served semantic {name} call did not launch {want}: {n}")
        if int8_backbone and (n["fused_decode"] or rec.int8_scales_path is not None
                              or rec._int8_absmax is None):
            raise AssertionError("the semantic int8 call launched K1 or did not calibrate on "
                                 "its crops")
        if len(texts) != B or not np.isfinite(scores).all() or max(scores) > 0:
            raise AssertionError(f"semantic {name}: missing strings or bad scores")
        model.set_use_kernels(False)
        plain = rec.recognize(crops, beam_size, semantics=sem)
        model.set_use_kernels(True)
        agree = sum(a == b for a, b in zip(texts, plain)) / B
        ms_call = cuda_ms(lambda: rec.recognize(crops, beam_size, semantics=sem), 10)
        if int8_backbone:
            step = rec._int8_steps[None]
            parts = dict(rectify=step.rectify, features=step.features)
        else:
            parts = {}
        dec = model.decoder
        if beam_size:
            decode = lambda m, c, s: dec.beam_from_memory(m, c, beam_size)[0]  # noqa: E731
        elif dec.post_decoder_mlp:
            decode = lambda m, c, s: dec.post_decoder(  # noqa: E731
                dec.greedy_from_memory(m, c), s).argmax(-1)
        else:
            decode = lambda m, c, s: dec.greedy_from_memory(m, c).argmax(-1)  # noqa: E731
        stages = semantic_stage_times(model, rec, crops, sem, decode, **parts)
        prof = kernel_profile(lambda: rec.recognize(crops, beam_size, semantics=sem), calls=3)
        if prof["device_busy_ms"] <= 0:
            raise AssertionError("the profiler saw no kernel run on the card")
        log(f"semantic {name}: kernels vs plain strings {agree:.4f} identical; {ms_call:.2f} "
            f"ms per {B}-crop call ({B / ms_call * 1e3:.1f} crops/s, 10 warm calls, CUDA "
            f"events); stage ms (median of 10): " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items())
            + f"; profile of 3 calls: wall {prof['wall_ms']:.2f} ms, kernels busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.4f}; by kernel "
            f"{prof['kernels_ms']}")
        served[name] = texts
        summary[name] = {"string_agreement_kernels_vs_plain": agree, "ms_per_call": ms_call,
                         "crops_per_s": B / ms_call * 1e3, "stage_ms": stages,
                         "profile": prof, "launches": n}
        if name != "greedy":
            del model, rec
            torch.cuda.empty_cache()

    with tf32_on():  # the float32 model must not take it
        for name in ("greedy", "beam", "post_decoder_mlp greedy"):
            changes, beam_size, _ = calls[name]
            if name != "beam":
                model = api.get_model(None, dataclasses.replace(cfg, compute_dtype="float32",
                                                                **changes), seed=SEMANTIC_SEED)
                rec = Recognizer(model, batch_sizes=(B,))
            texts = rec.recognize(crops, beam_size, semantics=sem)
            model.set_use_kernels(False)
            plain = rec.recognize(crops, beam_size, semantics=sem)
            model.set_use_kernels(True)
            agree = sum(a == b for a, b in zip(texts, plain)) / B
            vs_bf16 = sum(a == b for a, b in zip(texts, served[name])) / B
            summary[name]["f32_string_agreement"] = agree
            log(f"semantic {name} f32 with TF32 allowed by the caller, kernels vs plain "
                f"strings: {agree:.4f} identical (limit 1.0); bf16 vs f32 serving {vs_bf16:.4f}")
            if name != "greedy":
                del model, rec
                torch.cuda.empty_cache()
    f32_low = {k: v["f32_string_agreement"] for k, v in summary.items()
               if "f32_string_agreement" in v and v["f32_string_agreement"] != 1.0}
    limits = {"greedy": SEM_BF16_AGREE, "beam": SEM_BF16_AGREE,
              "post_decoder_mlp greedy": SEM_BF16_AGREE, "int8 greedy": SEM_INT8_AGREE}
    low = {k: v["string_agreement_kernels_vs_plain"] for k, v in summary.items()
           if not v["string_agreement_kernels_vs_plain"] >= limits[k]}
    if f32_low or low:
        failures.append(f"semantic strings, kernels vs plain: f32 below 1.0 {f32_low}; bf16 "
                        f"and int8 below the limits {limits}: {low}")
    if failures:
        raise AssertionError("semantic phase: " + "; ".join(failures))
    k1c["launches"] = summary["greedy"]["launches"]["fused_decode with cls0"]
    k1c["launches_int8"] = summary["int8 greedy"]["launches"]["fused_decode with cls0"]
    k4c["launches"] = summary["beam"]["launches"]["fused_beam with cls0"]
    return k1c, k4c, summary


# -- greedy decoding through the stepper, the per-layer fusion sites,
# -- training with every fusion hook, and crop resizing

SITES_ROWS = 16  # rows of the fusion-site model held against the CPU in float32
SITES_CPU_TOL = 1e-4  # of max(1, max |logit|)


def call_ms(fn, reps: int = 3, warm_up: bool = True):
    """The median CUDA-event ms of ``reps`` warm calls of ``fn()`` (one
    warm-up call first, unless the caller has just made one), each timed
    alone, and the samples."""
    if warm_up:
        fn()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples), samples


def encoded(model, rec, crops, sem=None):
    """The memory and step-0 rows the decoder of ``model`` reads for
    ``crops`` (and their objects), and the semantic vectors."""
    image, overlap, scene, ious = rec.prepare(crops, len(crops), semantics=sem)
    with torch.no_grad(), model.precision():
        s = model.semantics(overlap, scene, ious)
        enc = model.encoder(model.features(model.rectify(image)), semantics=s)
        memory, cls0 = model.decoder.memory_and_cls0(enc, s)
    return memory, cls0, s


def stepper_phase(api, fd, gs, crops):
    """The trained bundle under ``decode_fused=False`` (the flagship's other
    settings): greedy decoding through the stepper, served on the 192
    crops in bf16 and in f32 (TF32 off), its strings held against the K1
    path's (100% identical in f32, at least 98% in bf16), its decoder's
    and whole call's ms (CUDA events, median of 3 warm calls) beside K1's,
    and the decoder stage's share of the call."""
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer

    summary, failures = {}, []
    for dt in ("bfloat16", "float32"):
        runs = {}
        for name, fused in (("K1", True), ("stepper", False)):
            cfg = dataclasses.replace(FLAGSHIP, compute_dtype=dt, decode_fused=fused)
            model = api.get_model(BUNDLE, cfg)
            rec = Recognizer(model, batch_sizes=(B,))
            fd.fused_greedy_decode_cuda.launches = 0
            gs.grid_sample_cuda.launches = 0
            texts = rec.recognize(crops)
            n = {"fused_decode": fd.fused_greedy_decode_cuda.launches,
                 "grid_sample": gs.grid_sample_cuda.launches}
            if n["grid_sample"] < 1 or (n["fused_decode"] > 0) != fused:
                raise AssertionError(f"{dt} {name} greedy call launched {n}")
            memory, _, _ = encoded(model, rec, crops)

            def decode():
                with torch.no_grad(), model.precision():
                    return model.decoder.greedy_from_memory(memory)

            logits = decode()
            if logits.shape != (B, 25, 97) or not torch.isfinite(logits).all():
                raise AssertionError(f"{dt} {name} logits: shape {tuple(logits.shape)} or "
                                     f"non-finite")
            dec_ms, dec_samples = call_ms(decode)
            call, _ = call_ms(lambda: rec.recognize(crops))
            stages = stage_times(model, rec, crops,
                                 lambda enc: model.decoder.greedy_decode(enc).argmax(-1), reps=3)
            runs[name] = dict(texts=texts, launches=n, decoder_ms=dec_ms,
                              decoder_ms_samples=dec_samples, ms_per_call=call,
                              stage_ms=stages,
                              decoder_share=stages["decoder"] / sum(stages.values()))
            del model, rec, memory, logits
            torch.cuda.empty_cache()
        agree = sum(a == b for a, b in zip(runs["K1"]["texts"], runs["stepper"]["texts"])) / B
        limit = 1.0 if dt == "float32" else 0.98
        st, k1 = runs["stepper"], runs["K1"]
        log(f"stepper greedy {dt}: strings vs K1's {agree:.4f} identical (limit {limit}); "
            f"decoder {st['decoder_ms']:.3f} ms (samples {st['decoder_ms_samples']}) against "
            f"K1's {k1['decoder_ms']:.3f}; whole call {st['ms_per_call']:.2f} ms against "
            f"{k1['ms_per_call']:.2f}; decoder share {st['decoder_share']:.3f} against "
            f"{k1['decoder_share']:.3f}; stepper stage ms " + ", ".join(
                f"{k} {v:.3f}" for k, v in st["stage_ms"].items()))
        if not agree >= limit:
            failures.append(f"{dt}: strings vs K1's {agree} < {limit}")
        for r in runs.values():
            del r["texts"]
        summary[dt] = {"string_agreement_vs_k1": agree, **{n: r for n, r in runs.items()}}
    if failures:
        raise AssertionError("stepper greedy vs K1: " + "; ".join(failures))
    return summary


def sites_config(flagship):
    """The semantic configuration with the three per-layer fusion sites on:
    every fusion hook of the JAX package; greedy decoding and beam search
    run the stepper."""
    return dataclasses.replace(semantic_config(flagship), multihead_pre_target=True,
                               multihead_pre_memory=True, multihead_post_memory=True)


def fusion_sites_phase(api, fd, fb, gs, crops):
    """``sites_config`` with random weights from SEMANTIC_SEED and the
    objects of ``make_semantics``, served on the 192 crops greedily (the
    stepper, early stop) and by beam search (k=5: the fused beam gives way
    to the stepper's ancestry form), with no K1 or K4 launch; the two
    calls' ms and the two beam forms' (ancestry, reorder) agreement in
    bf16, printed; then SITES_ROWS rows in f32 on the card held against
    the same model on the CPU: greedy logits within SITES_CPU_TOL of
    max(1, max |logit|), tokens identical, and the ancestry and reorder
    beam forms on the card and the ancestry form on the CPU with identical
    tokens, scores within SITES_CPU_TOL of their size.

    The forms are held in float32 only: this random decoder's next-token
    distribution is nearly flat (a beam's 25 steps sum to -50 to -65), so
    its K-th and (K+1)-th candidates often lie closer than a bf16 rounding,
    and the two forms' attention sums, in other orders, then keep other
    beams."""
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer

    cfg = sites_config(FLAGSHIP)
    sem = make_semantics(B, SEMANTIC_SEED)
    model = api.get_model(None, cfg, seed=SEMANTIC_SEED)
    rec = Recognizer(model, batch_sizes=(1, 8, 64, B))
    fd.fused_greedy_decode_cuda.launches = fb.fused_beam_decode_cuda.launches = 0
    gs.grid_sample_cuda.launches = 0
    texts = rec.recognize(crops, semantics=sem)
    btexts, bscores = rec.recognize(crops, BEAM, return_scores=True, semantics=sem)
    n = {"fused_decode": fd.fused_greedy_decode_cuda.launches,
         "fused_beam": fb.fused_beam_decode_cuda.launches,
         "grid_sample": gs.grid_sample_cuda.launches}
    log(f"fusion sites: served {len(texts)} crops greedily and by beam search; kernel launches "
        f"{n}; e.g. {texts[:2]}, {list(zip(btexts[:2], bscores[:2]))}")
    if n["fused_decode"] or n["fused_beam"] or n["grid_sample"] != 2:
        raise AssertionError(f"the fusion-site calls launched {n}: expected the stepper and 2 K2")
    if len(btexts) != B or not np.isfinite(bscores).all() or max(bscores) > 0:
        raise AssertionError("fusion sites beam: missing strings or bad scores")
    greedy_ms, greedy_samples = call_ms(lambda: rec.recognize(crops, semantics=sem))
    beam_ms, beam_samples = call_ms(lambda: rec.recognize(crops, BEAM, semantics=sem))
    dec = model.decoder
    stages = semantic_stage_times(
        model, rec, crops, sem, lambda m, c, s: dec.greedy_from_memory(m, c, s).argmax(-1),
        reps=3)
    memory, cls0, s = encoded(model, rec, crops, sem)
    with torch.no_grad():
        forms = {r: dec.beam_from_memory(memory, cls0, BEAM, reorder_caches=r, semantics=s)
                 for r in (False, True)}
        step_ms = {"ancestry": call_ms(lambda: dec.beam_from_memory(
            memory, cls0, BEAM, semantics=s))[0], "reorder": call_ms(lambda: dec.beam_from_memory(
                memory, cls0, BEAM, reorder_caches=True, semantics=s))[0]}
    forms_bf16 = (forms[False][0] == forms[True][0]).all(-1).float().mean().item()
    score_diff = (forms[False][1] - forms[True][1]).abs().max().item()
    log(f"fusion sites: greedy {greedy_ms:.2f} ms per {B}-crop call (samples {greedy_samples}), "
        f"beam {beam_ms:.2f} (samples {beam_samples}); greedy stage ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items())
        + f"; bf16 beam forms: ancestry {step_ms['ancestry']:.2f} ms, reorder "
        f"{step_ms['reorder']:.2f} ms, best beams identical {forms_bf16:.4f} (printed only), "
        f"scores max |diff| {score_diff:.3e}")
    del model, rec, memory, cls0, s, forms
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    card = api.get_model(None, cfg32, seed=SEMANTIC_SEED)
    host = api.get_model(None, cfg32, device="cpu", seed=SEMANTIC_SEED)
    rows = {k: v[:SITES_ROWS] for k, v in sem.items()}
    r = SITES_ROWS
    batch = Recognizer(card, batch_sizes=(r,)).prepare(crops[:r], r, semantics=rows)
    with torch.no_grad():
        got = card(batch[0], batch[1], scene=batch[2], ious=batch[3]).cpu()
        want = host(*(t.cpu() for t in batch[:2]), scene=batch[2].cpu(), ious=batch[3].cpu())
        beams = {}
        for name, model, reorder in (("card ancestry", card, False), ("card reorder", card, True),
                                     ("CPU ancestry", host, False)):
            memory, cls0, s = encoded(model, Recognizer(model, batch_sizes=(r,)), crops[:r], rows)
            t, sc = model.decoder.beam_from_memory(memory, cls0, BEAM, reorder_caches=reorder,
                                                   semantics=s)
            beams[name] = (t.cpu(), sc.cpu())
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    tokens_same = torch.equal(got.argmax(-1), want.argmax(-1))
    ref_t, ref_s = beams["CPU ancestry"]
    beams_same = all(torch.equal(t, ref_t) for t, _ in beams.values())
    beam_err = max((sc - ref_s).abs().max().item() for _, sc in beams.values())
    beam_scale = ref_s.abs().max().item()
    log(f"fusion sites f32, card vs CPU on {r} rows: greedy max |logit diff| {err:.3e} (limit "
        f"{SITES_CPU_TOL:g} x {scale:.3f}), tokens identical {tokens_same}; beam (k={BEAM}) "
        f"card ancestry, card reorder and CPU ancestry tokens identical {beams_same}, scores "
        f"max |diff| {beam_err:.3e} (limit {SITES_CPU_TOL:g} x {beam_scale:.3f})")
    del card, host
    torch.cuda.empty_cache()
    if not (tokens_same and err <= SITES_CPU_TOL * scale and beams_same
            and beam_err <= SITES_CPU_TOL * beam_scale):
        raise AssertionError(f"fusion sites f32: card vs CPU logits {err} (limit "
                             f"{SITES_CPU_TOL * scale}), tokens identical {tokens_same}; beam "
                             f"forms identical {beams_same}, scores {beam_err}")
    return {"launches": n, "greedy_ms_per_call": greedy_ms, "greedy_ms_samples": greedy_samples,
            "beam_ms_per_call": beam_ms, "beam_ms_samples": beam_samples, "stage_ms": stages,
            "beam_form_ms": step_ms, "bf16_beam_forms_identical_share": forms_bf16,
            "bf16_beam_forms_score_diff": score_diff, "f32_vs_cpu_max_abs_err": err,
            "f32_vs_cpu_scale": scale, "f32_beam_forms_identical": beams_same,
            "f32_beam_score_diff": beam_err}


def train_hooks_phase(api, bn, gs):
    """``sites_config`` (every fusion hook and site) trained for
    TRAIN_STEPS bf16 steps at B=192 from SEMANTIC_SEED's weights, with the
    kernels and with their plain versions, held to the train phase's
    limits (TRAIN_LOSS_TOL, TRAIN_NORM_TOL); 36 K3 and 1 K2 launches a
    step; the median step ms and the peak memory."""
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP

    cfg = sites_config(FLAGSHIP)
    batch = make_train_batch(B, 4321, FLAGSHIP.chars)
    batch.update(make_semantics(B, 4322))
    torch.cuda.reset_peak_memory_stats()
    trainer, kmetrics, kcounts, shapes = train_run(api, bn, gs, batch, use_kernels=True, cfg=cfg)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step, step_samples = call_ms(lambda: trainer(batch))
    del trainer
    torch.cuda.empty_cache()
    trainer, pmetrics, pcounts, _ = train_run(api, bn, gs, batch, use_kernels=False, cfg=cfg)
    del trainer
    torch.cuda.empty_cache()
    want = [(36 * (i + 1), i + 1) for i in range(TRAIN_STEPS)]
    diffs = rel_diffs(kmetrics, pmetrics)
    loss_diffs, norm_diff = [d[0] for d in diffs], diffs[0][1]
    log(f"train with every hook: kernels {kmetrics}, K3/K2 launches after each step {kcounts}; "
        f"plain {pmetrics}, launches {pcounts}; relative loss {[f'{d:.3e}' for d in loss_diffs]} "
        f"(limits {TRAIN_LOSS_TOL}), step-1 grad norm {norm_diff:.3e} (limit {TRAIN_NORM_TOL:g}); "
        f"median step {ms_step:.2f} ms of {step_samples} ({B / ms_step * 1e3:.1f} crops/s), "
        f"peak memory {peak_gb:.3f} GB")
    for m in kmetrics + pmetrics:
        if not np.isfinite([m["loss"], m["grad_norm"]]).all():
            raise AssertionError(f"non-finite training metrics with the hooks: {m}")
    if len(shapes) != 36 or kcounts != want or any(c != (0, 0) for c in pcounts):
        raise AssertionError(f"training with the hooks launched K3/K2 {kcounts} with "
                             f"{len(shapes)} BatchNorms a step (expected {want}), plain {pcounts}")
    if not (all(d <= t for d, t in zip(loss_diffs, TRAIN_LOSS_TOL))
            and norm_diff <= TRAIN_NORM_TOL):
        raise AssertionError(f"kernel and plain training runs with the hooks disagree: {diffs}")
    return {"batch": B, "steps": TRAIN_STEPS, "metrics_kernels": kmetrics,
            "metrics_plain": pmetrics, "rel_diff_by_step": diffs, "ms_per_step": ms_step,
            "ms_samples": step_samples, "crops_per_s": B / ms_step * 1e3,
            "peak_memory_gb": peak_gb, "launches": kcounts[-1]}


def make_resize_crops(n: int, seed: int):
    """Seeded crops of other sizes: ``make_crops``' glyph-like crops
    resampled to heights 16-64 and widths 40-400 by the plain bilinear
    route; even ones uint8, odd ones float in [0, 1]."""
    from multimodal_scene_text_recognition_tpu_torch.ops.resize import crop_resize_gray_plain

    rng = np.random.default_rng(seed)
    box = np.array([[0, 0, 100, 32]], np.float32)
    out = []
    for i, c in enumerate(make_crops(n, seed)):
        h, w = int(rng.integers(16, 65)), int(rng.integers(40, 401))
        r = crop_resize_gray_plain([c], box, h, w)[0, ..., 0]
        out.append(np.round(r * 255).astype(np.uint8) if i % 2 == 0 else r)
    return out


def resize_phase(api, gs, crops):
    """192 seeded crops of other sizes (``make_resize_crops``), half uint8
    and half float, served on the trained flagship: the strings must be
    those of the same crops resized first by the plain routes on the host
    (the C++'s numpy mirror, the float bicubic); ``prepare``'s ms for the
    batch beside the 32x100 batch's."""
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
    from multimodal_scene_text_recognition_tpu_torch.ops.resize import (crop_resize_gray_plain,
                                                                        resize_float)

    model = api.get_model(BUNDLE)
    rec = Recognizer(model, batch_sizes=(1, 8, 64, B))
    other = make_resize_crops(B, 77)
    gs.grid_sample_cuda.launches = 0
    texts = rec.recognize(other)
    launches = gs.grid_sample_cuda.launches
    resized = [crop_resize_gray_plain([c], np.array([[0, 0, c.shape[1], c.shape[0]]],
                                                    np.float32))[0, ..., 0]
               if c.dtype == np.uint8 else resize_float(c) for c in other]
    plain = rec.recognize(resized)
    same = sum(a == b for a, b in zip(texts, plain)) / B
    prep_ms, prep_samples = call_ms(lambda: rec.prepare(other, B))
    prep32_ms, _ = call_ms(lambda: rec.prepare(crops, B))
    call, _ = call_ms(lambda: rec.recognize(other))
    shapes = [c.shape for c in other]
    log(f"resize: {B} crops of heights {min(s[0] for s in shapes)}-{max(s[0] for s in shapes)} "
        f"and widths {min(s[1] for s in shapes)}-{max(s[1] for s in shapes)}, half uint8 and "
        f"half float; K2 launches {launches}; strings vs the plain-resized crops' {same:.4f} "
        f"identical (limit 1.0), e.g. {texts[:3]}; prepare {prep_ms:.3f} ms (samples "
        f"{prep_samples}) against {prep32_ms:.3f} ms for 32x100 crops; whole call "
        f"{call:.2f} ms")
    del model, rec
    torch.cuda.empty_cache()
    if launches < 1 or same != 1.0:
        raise AssertionError(f"resize: K2 launches {launches}, strings identical {same}")
    return {"string_agreement_vs_plain_resize": same, "prepare_ms": prep_ms,
            "prepare_ms_samples": prep_samples, "prepare_ms_32x100": prep32_ms,
            "ms_per_call": call}


def make_train_batch(n: int, seed: int, chars: str, codec=None):
    """One batch in the wire format: uint8 crops, label rows of seeded
    random words (in ``codec``, default ``AttnCodec``), overlap ids in
    [0, 100)."""
    from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec

    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789")
    words = ["".join(rng.choice(letters, rng.integers(3, 11))) for _ in range(n)]
    text, _ = (codec or AttnCodec(chars)).encode(words)
    return {"image": np.stack(make_crops(n, seed))[..., None], "text": text,
            "overlap": rng.integers(0, 100, (n, 15)).astype(np.int32)}


def train_run(api, bn, gs, batch, use_kernels: bool, steps: int = TRAIN_STEPS,
              warp_kernel: bool = None, cfg=None, train_cfg=None, seed: int = SEMANTIC_SEED,
              trained: bool = False):
    """``steps`` steps of the trained flagship (``TrainConfig()`` defaults,
    dropout 0.1), or of ``cfg`` with the random weights of ``seed`` (and
    ``train_cfg``, default ``TrainConfig()``; with ``trained`` the trained
    bundle's weights over them, ``trained_over``), with the kernels or their
    plain versions (``warp_kernel`` sets K2 apart); the per-step metrics
    (with the step's CUDA-event ``ms``), the K3 and K2 counts after each
    step, and the (shape, dtype) of each BatchNorm input of the first
    step."""
    from multimodal_scene_text_recognition_tpu_torch.models.layers import BatchNorm2d

    if cfg is None:
        trainer = api.get_trainer(BUNDLE)
    else:
        trainer = api.get_trainer(None, cfg, train_cfg, seed=seed)
        if trained:
            trained_over(trainer.model)
    trainer.model.set_use_kernels(use_kernels)
    if warp_kernel is not None:
        trainer.model.transformation.use_kernels = warp_kernel
    shapes = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: shapes.append(
        (tuple(inp[0].shape), inp[0].dtype))) for m in trainer.model.modules()
        if isinstance(m, BatchNorm2d)]
    bn.bn_bwd_cuda.launches = 0
    gs.grid_sample_cuda.launches = 0
    metrics, counts = [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = trainer(batch)
        end.record()
        torch.cuda.synchronize()
        metrics.append({**{k: v.item() for k, v in m.items()}, "ms": start.elapsed_time(end)})
        counts.append((bn.bn_bwd_cuda.launches, gs.grid_sample_cuda.launches))
    for h in hooks:
        h.remove()
    return trainer, metrics, counts, shapes[:len(shapes) // steps]


def rel_diffs(a, b):
    """Per step, the relative differences of the loss and the gradient norm
    of run ``a`` from run ``b``."""
    return [(abs(x["loss"] - y["loss"]) / abs(y["loss"]),
             abs(x["grad_norm"] - y["grad_norm"]) / abs(y["grad_norm"])) for x, y in zip(a, b)]


def train_phase(api, bn, gs):
    """Train bf16 at B=192 with the kernels, then with their plain versions
    from the same weights and dropout seed; compare, count, time."""
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP

    batch = make_train_batch(B, 4321, FLAGSHIP.chars)
    torch.cuda.reset_peak_memory_stats()
    trainer, kmetrics, kcounts, shapes = train_run(api, bn, gs, batch, use_kernels=True)
    log(f"train with kernels: {kmetrics}; K3/K2 launches after each step {kcounts}")
    per_step = len(shapes)
    want = [(per_step * (i + 1), i + 1) for i in range(TRAIN_STEPS)]
    if per_step != 36 or kcounts != want:
        raise AssertionError(f"training launched K3/K2 {kcounts} with {per_step} BatchNorms "
                             f"a step; expected {want} with 36")

    step_ms = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer(batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    ms_step = statistics.median(step_ms)
    prof = kernel_profile(lambda: trainer(batch), calls=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the profiler's own host cost stretches the profiled step's wall time;
    # the busy time over the unprofiled step's time is the other estimate
    prof["idle_share_of_unprofiled_step"] = 1.0 - prof["device_busy_ms"] / ms_step
    log(f"train step: median {ms_step:.2f} ms of {step_ms} ({B / ms_step * 1e3:.1f} crops/s), "
        f"profile of one step: wall {prof['wall_ms']:.2f} ms, kernels busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.4f} "
        f"({prof['idle_share_of_unprofiled_step']:.4f} of the unprofiled step), the BatchNorm "
        f"backward (K3) {prof['bn_backward_ms']:.4f} ms of it; peak memory {peak_gb:.1f} GB")
    log("train step, device ms by kernel (largest 12): " + ", ".join(
        f"{k} {v:.3f}" for k, v in prof["kernels_ms"].items()))
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiler saw no kernel run on the card during a train step")
    del trainer
    torch.cuda.empty_cache()

    runs = {}
    for name, kw in (("plain", dict(use_kernels=False)),
                     ("plain again", dict(use_kernels=False)),
                     ("K3 alone", dict(use_kernels=True, warp_kernel=False, steps=1))):
        trainer, runs[name], counts, _ = train_run(api, bn, gs, batch, **kw)
        del trainer
        torch.cuda.empty_cache()
        log(f"train, {name}: {runs[name]}; K3/K2 launches {counts}")
        if name != "K3 alone" and any(c != (0, 0) for c in counts):
            raise AssertionError(f"the plain training run launched a kernel: {counts}")
    pmetrics = runs["plain"]
    for m in kmetrics + pmetrics:
        if not np.isfinite([m["loss"], m["grad_norm"]]).all():
            raise AssertionError(f"non-finite training metrics: {m}")
    diffs = rel_diffs(kmetrics, pmetrics)
    floor = rel_diffs(runs["plain again"], pmetrics)
    k3_alone = rel_diffs(runs["K3 alone"], pmetrics)[0]
    log(f"train, relative (loss, grad norm) by step: plain run to run {floor}; K3 alone "
        f"at step 1 {k3_alone}")
    loss_diffs = [d[0] for d in diffs]
    norm_diff = diffs[0][1]
    log(f"train kernels vs plain, relative: loss {[f'{d:.3e}' for d in loss_diffs]} by step "
        f"(limits {TRAIN_LOSS_TOL}), step-1 grad norm {norm_diff:.3e} (limit "
        f"{TRAIN_NORM_TOL:g}; steps 2-3: {[f'{d[1]:.3e}' for d in diffs[1:]]})")
    if not (all(d <= t for d, t in zip(loss_diffs, TRAIN_LOSS_TOL))
            and norm_diff <= TRAIN_NORM_TOL):
        raise AssertionError(f"kernel and plain training runs disagree: {diffs}")

    # K3 held against its plain version at each of the step's BatchNorm
    # shapes, and its cost per step
    tally = {}
    for key in shapes:
        tally[key] = tally.get(key, 0) + 1
    if {s: n for (s, _), n in tally.items()} != TRAIN_BN_SHAPES:
        raise AssertionError(f"the step's BatchNorm shapes {tally} are not TRAIN_BN_SHAPES")
    totals, bound_by, worst, worst_abs = np.zeros(7), set(), 0.0, 0.0
    for i, ((shape, dtype), n) in enumerate(tally.items()):
        r = bn_check(bn, shape, dtype, 100 + i)
        log(f"  K3 x{n} at " + bn_line(shape, dtype, r))
        bound_by.add(r["bound_by"])
        totals += n * np.array([r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "events_ms", "cold_ms", "library_cold_ms")])
        worst, worst_abs = max(worst, r["err"]), max(worst_abs, r["err_abs"])
    nbytes = sum(3 * int(np.prod(s)) * (2 if d == torch.bfloat16 else 4) for s, d in shapes)
    log(f"K3 per train step ({per_step} launches, {nbytes / 1e9:.3f} GB of x and dy read and "
        f"dx written), device time: kernel {totals[0]:.4f} ms, plain {totals[1]:.4f} ms, "
        f"native_batch_norm_backward {totals[2]:.4f} ms, bound {totals[3]:.4f} ms; kernel by "
        f"CUDA events {totals[4]:.4f} ms, in the profiled step {prof['bn_backward_ms']:.4f} ms; "
        f"on a cold L2 (queued_ms) kernel {totals[5]:.4f} ms, native_batch_norm_backward "
        f"{totals[6]:.4f} ms")
    summary = {"batch": B, "steps": TRAIN_STEPS, "loss_kernels": [m["loss"] for m in kmetrics],
               "loss_plain": [m["loss"] for m in pmetrics],
               "grad_norm_kernels": [m["grad_norm"] for m in kmetrics],
               "grad_norm_plain": [m["grad_norm"] for m in pmetrics],
               "rel_loss_diff": loss_diffs, "rel_grad_norm_diff_step1": norm_diff,
               "rel_diff_by_step": diffs, "plain_run_to_run": floor,
               "k3_alone_step1": k3_alone,
               "ms_per_step": ms_step, "crops_per_s": B / ms_step * 1e3,
               "profile": prof, "peak_memory_gb": peak_gb}
    k3 = dict(name="bn_backward", route="cuda",
              source="multimodal_scene_text_recognition_tpu_torch/kernels/bn_backward.cu",
              replaces="multimodal_scene_text_recognition_tpu/ops/batchnorm.py:41",
              jax="ops/batchnorm.py::_bn_bwd_reduce_kernel and _bn_bwd's dx",
              launches=kcounts[-1][0], launches_per_step=per_step,
              ms=totals[0], plain_ms=totals[1], library_ms=totals[2], bound_ms=totals[3],
              bound_by="/".join(sorted(bound_by)), per="train step (all 36 launches)",
              ms_events=totals[4], ms_in_profiled_step=prof["bn_backward_ms"],
              ms_cold=totals[5], library_ms_cold=totals[6],
              step_bytes=nbytes, max_abs_err=worst_abs, max_err_of_sum_terms=worst)
    return summary, k3, kcounts[-1][1]


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    """``obj.name`` replaced by ``wrap(original)`` inside the block."""
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


class LoopProbe:
    """Counts and times what a training loop does: its train steps (the
    first step's start, every step's metrics), its validations and its
    checkpoint saves (host wall time around each, the card synchronized)."""

    def __init__(self):
        self.t_first, self.metrics, self.validations, self.saves = None, [], [], []
        self.starts = []  # host time at each step's call

    def step(self, real):
        def call(trainer, batch):
            if self.t_first is None:
                torch.cuda.synchronize()
                self.t_first = time.perf_counter()
            self.starts.append(time.perf_counter())
            m = real(trainer, batch)
            self.metrics.append(m)
            return m
        return call

    def timed(self, into):
        def wrap(real):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t)
                return out
            return call
        return wrap

    def run(self, fn):
        """Run ``fn()`` (a loop) with the probes in; returns the seconds of
        the loop's steps: from the first step's start to the end of the
        run, less the validations and saves that fell in between."""
        from multimodal_scene_text_recognition_tpu_torch.train import loop
        from multimodal_scene_text_recognition_tpu_torch.train.steps import TrainStep

        with patched(TrainStep, "__call__", self.step), \
                patched(loop, "validate", self.timed(self.validations)), \
                patched(loop, "save_checkpoint", self.timed(self.saves)):
            n_val = len(self.validations)
            fn()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        # the first validation runs before the first step
        return t_end - self.t_first - sum(self.validations[n_val + 1:]) - sum(self.saves)

    def rate_after_first_step(self, seconds: float) -> float:
        """Crops/s of the steps after the first, of a run that ``run``
        timed at ``seconds``."""
        return (len(self.metrics) - 1) * B / (seconds - (self.starts[1] - self.starts[0]))


def validation_records(model, val_set, codec):
    """The per-crop records of a greedy validation of ``val_set`` at B=192,
    as ``api.validate`` batches it."""
    from multimodal_scene_text_recognition_tpu_torch.data.pipeline import Batcher, batches
    from multimodal_scene_text_recognition_tpu_torch.eval.evaluate import validate
    from multimodal_scene_text_recognition_tpu_torch.train.steps import make_eval_step

    return validate(make_eval_step(model), batches(val_set, Batcher(codec, B), shuffle=False,
                                                   drop_last=False),
                    codec, return_records=True)


def data_phase(api, fd, gs, bn):
    """Train and validate on the committed set: load it (numpy alone);
    validate the trained flagship on its 512 validation crops through
    ``api.validate`` (K1 and K2 at least 3 launches each), with the kernels
    and with their plain versions, against the JAX package's accuracy;
    train one epoch through ``api.train`` with device data and validation
    every 10 steps (36 K3 and 1 K2 launches a step, 3 K1 and K2 launches a
    validation, a checkpoint on the first new best), then one epoch through
    the host prefetcher, each beside the bare ``TrainStep``'s rate; save the
    trainer's full state, restore it into a fresh trainer (bit-equal
    parameters, moments and step count) and take one step from each."""
    import importlib.util

    from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP, Config, TrainConfig
    from multimodal_scene_text_recognition_tpu_torch.data.pipeline import device_batch
    from multimodal_scene_text_recognition_tpu_torch.train import checkpoint

    t = time.perf_counter()
    train_set, val_set = api.get_dataset("synthetic")
    load_s = time.perf_counter() - t
    log(f"committed set: {len(train_set)} train and {len(val_set)} validation crops "
        f"({train_set.image.dtype}, {train_set.nbytes() / 1e6:.1f} MB packed) loaded in "
        f"{load_s:.3f} s")
    if (len(train_set), len(val_set)) != (4096, 512) or train_set.image.dtype != np.uint8:
        raise AssertionError("the committed set did not load as 4096 + 512 uint8 crops")
    codec = AttnCodec(FLAGSHIP.chars, FLAGSHIP.max_text_length)

    # validation of the trained flagship: kernels, plain, f32.  The
    # accuracies and strings come from one records pass a mode (the
    # evaluate.validate that api.validate runs); api.validate gives the
    # launch count and the times
    model = api.get_model(BUNDLE)
    fd.fused_greedy_decode_cuda.launches = 0
    gs.grid_sample_cuda.launches = 0
    acc_api = api.validate(model)
    val_launches = {"K1": fd.fused_greedy_decode_cuda.launches,
                    "K2": gs.grid_sample_cuda.launches}
    val_ms, val_samples = call_ms(lambda: api.validate(model), warm_up=False)
    kernel = validation_records(model, val_set, codec)
    model.set_use_kernels(False)
    plain = validation_records(model, val_set, codec)  # also the plain path's warm-up
    plain_ms, _ = call_ms(lambda: api.validate(model), reps=1, warm_up=False)
    model.set_use_kernels(True)
    acc, acc_plain = kernel.accuracy, plain.accuracy
    same = sum(a.prediction == b.prediction
               for a, b in zip(kernel.records, plain.records)) / len(kernel.records)
    if acc_api != acc:
        raise AssertionError(f"api.validate gave {acc_api}%, its records {acc}%")
    if importlib.util.find_spec("pandas") is None:
        try:
            api.validate(model, return_dataframe=True)
        except ImportError as e:
            frame = f"ImportError as expected without pandas: {e}"
        else:
            raise AssertionError("validate(return_dataframe=True) ran without pandas")
    else:
        frame = f"a DataFrame of {len(api.validate(model, return_dataframe=True)[1])} rows"
    del model
    model32 = api.get_model(BUNDLE, dataclasses.replace(FLAGSHIP, compute_dtype="float32"))
    acc32 = api.validate(model32)
    del model32
    torch.cuda.empty_cache()
    log(f"validate on {len(val_set)} crops: kernels {acc}% ({val_ms:.2f} ms, samples "
        f"{[round(x, 2) for x in val_samples]}; K1/K2 launches {val_launches}), plain "
        f"{acc_plain}% ({plain_ms:.2f} ms), strings {same:.4f} identical (limit 0.98); f32 "
        f"{acc32}%; the JAX package {JAX_VAL_ACC} (limit {VAL_ACC_TOL} point); "
        f"return_dataframe: {frame}")
    if min(val_launches.values()) < 3:
        raise AssertionError(f"validation launched K1/K2 {val_launches}, fewer than 3")
    if not (abs(acc - JAX_VAL_ACC["bfloat16"]) <= VAL_ACC_TOL
            and abs(acc32 - JAX_VAL_ACC["float32"]) <= VAL_ACC_TOL and same >= 0.98):
        raise AssertionError(f"validation: bf16 {acc}%, f32 {acc32}% against JAX "
                             f"{JAX_VAL_ACC}, strings {same}")

    # one epoch with device data, validating every 10 steps
    results = tempfile.mkdtemp(prefix="chip_smoke_results_")
    try:  # the checkpoints (~1.8 GB) go on every exit
        cfg = Config(experiment="smoke", model=FLAGSHIP, train=TrainConfig(),
                     results_dir=results)
        trainer = api.get_trainer(BUNDLE)
        for k in (fd.fused_greedy_decode_cuda, gs.grid_sample_cuda, bn.bn_bwd_cuda):
            k.launches = 0
        probe = LoopProbe()
        loop_s = probe.run(lambda: api.train(trainer, "synthetic", LOOP_VALIDATION_STEPS,
                                             LOOP_STEPS, cfg=cfg))
        launches = {"K1": fd.fused_greedy_decode_cuda.launches,
                    "K2": gs.grid_sample_cuda.launches, "K3": bn.bn_bwd_cuda.launches}
        n_val, steps = len(probe.validations), len(probe.metrics)
        losses = torch.stack([m["loss"] for m in probe.metrics]).tolist()
        with open(os.path.join(results, "smoke_training_log.csv")) as f:
            rows = f.read().splitlines()
        ckpt = os.path.join(results, "models", "smoke", checkpoint.STATE_FILE)
        device_rate = steps * B / loop_s
        # the first step of a new trainer also pays its first-call costs
        warm_rate = probe.rate_after_first_step(loop_s)
        log(f"api.train, device data: {steps} steps in {loop_s:.3f} s of steps "
            f"({device_rate:.1f} crops/s in the loop, {warm_rate:.1f} after its first step), "
            f"{n_val} validations ({[round(x, 3) for x in probe.validations]} s), "
            f"{len(probe.saves)} checkpoint saves ({[round(x, 3) for x in probe.saves]} s); "
            f"launches {launches}; losses {[round(x, 4) for x in losses]}; CSV {rows}")
        # validation before training, then at the first block ends (blocks of
        # steps_per_call=8 steps: 8, 16, 21) at or past each multiple of 10
        want = {"K1": 3 * n_val, "K2": steps + 3 * n_val, "K3": 36 * steps}
        if (steps != LOOP_STEPS or trainer.step_count != LOOP_STEPS or n_val != 3
                or launches != want):
            raise AssertionError(f"the loop took {steps} steps with {n_val} validations and "
                                 f"launched {launches}; expected {LOOP_STEPS}, 3 and {want}")
        if (not np.isfinite(losses).all() or not os.path.exists(ckpt) or len(rows) < 3
                or not rows[2].startswith("16,") or not probe.saves):
            raise AssertionError(f"the loop's losses {losses}, CSV rows {rows} or checkpoint "
                                 f"{os.path.exists(ckpt)} are wrong")
        batch = device_batch(train_set.take(np.arange(B)), trainer.device)
        step_ms, step_samples = call_ms(lambda: trainer(batch), reps=5)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(LOOP_STEPS):
            trainer(batch)
        torch.cuda.synchronize()
        bare_rate = LOOP_STEPS * B / (time.perf_counter() - t)

        # one epoch through the host prefetcher (no validation but the first)
        cfg_host = dataclasses.replace(cfg, experiment="smoke_host", train=dataclasses.replace(
            cfg.train, device_data=False))
        probe_host = LoopProbe()
        host_s = probe_host.run(lambda: api.train(trainer, "synthetic", 10 ** 6,
                                                  trainer.step_count + LOOP_STEPS, cfg=cfg_host))
        host_losses = torch.stack([m["loss"] for m in probe_host.metrics]).tolist()
        host_rate = len(probe_host.metrics) * B / host_s
        host_warm_rate = probe_host.rate_after_first_step(host_s)
        gaps = {name: [round((b - a) * 1e3, 1) for a, b in zip(p.starts, p.starts[1:])]
                for name, p in (("device data", probe), ("host prefetcher", probe_host))}
        log(f"api.train, host prefetcher: {len(probe_host.metrics)} steps in {host_s:.3f} s "
            f"({host_rate:.1f} crops/s in the loop, {host_warm_rate:.1f} after its first "
            f"step); the bare TrainStep {step_ms:.2f} ms a step "
            f"({B / step_ms * 1e3:.1f} crops/s, samples {[round(x, 2) for x in step_samples]}), "
            f"{LOOP_STEPS} bare steps back to back {bare_rate:.1f} crops/s; after the first "
            f"step, device data / bare {warm_rate / bare_rate:.4f}, host prefetcher / bare "
            f"{host_warm_rate / bare_rate:.4f}; host ms between the loops' step calls {gaps}")
        if len(probe_host.metrics) != LOOP_STEPS or not np.isfinite(host_losses).all():
            raise AssertionError(f"the host route took {len(probe_host.metrics)} steps, losses "
                                 f"{host_losses}")

        # the full state: save, restore into a fresh trainer, one step each
        path = os.path.join(results, "resume")
        torch.cuda.synchronize()
        t = time.perf_counter()
        checkpoint.save_checkpoint(path, trainer)
        save_s = time.perf_counter() - t
        nbytes = os.path.getsize(os.path.join(path, checkpoint.STATE_FILE))
        fresh = api.get_trainer(BUNDLE)
        torch.cuda.synchronize()
        t = time.perf_counter()
        checkpoint.restore_checkpoint(path, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        sa, sb = trainer.model.state_dict(), fresh.model.state_dict()
        equal = (all(torch.equal(sa[k], sb[k]) for k in sa)
                 and all(torch.equal(x, y)
                         for x, y in zip(trainer.optimizer.mu + trainer.optimizer.nu,
                                         fresh.optimizer.mu + fresh.optimizer.nu))
                 and trainer.step_count == fresh.step_count)
        best = api.get_trainer(BUNDLE)
        best_step = checkpoint.restore_checkpoint(os.path.dirname(ckpt), best).step_count
        del best
        la, lb = trainer(batch)["loss"].item(), fresh(batch)["loss"].item()
        rel = abs(la - lb) / abs(lb)
        log(f"resume: saved in {save_s:.3f} s ({nbytes} bytes), restored in {restore_s:.3f} s; "
            f"parameters, moments and step count bit-equal: {equal}; next step's loss "
            f"{la:.6f} / {lb:.6f} (relative {rel:.2e}, limit {RESUME_LOSS_TOL:g}); the loop's "
            f"best checkpoint restores at step {best_step}")
        del trainer, fresh
        torch.cuda.empty_cache()
        if not equal or not rel <= RESUME_LOSS_TOL or best_step not in (16, 21):
            raise AssertionError(f"resume: bit-equal {equal}, relative loss {rel}, best "
                                 f"checkpoint at step {best_step}")
    finally:
        shutil.rmtree(results, ignore_errors=True)
    return {"load_s": load_s, "val_acc": acc, "val_acc_plain": acc_plain, "val_acc_f32": acc32,
            "val_acc_jax": JAX_VAL_ACC, "val_string_agreement": same, "val_ms": val_ms,
            "val_ms_samples": val_samples, "val_ms_plain": plain_ms,
            "val_launches": val_launches, "loop_steps": steps, "loop_validations": n_val,
            "loop_launches": launches, "loop_s": loop_s, "loop_crops_per_s": device_rate,
            "loop_crops_per_s_after_first_step": warm_rate,
            "validation_s": probe.validations, "save_s_in_loop": probe.saves,
            "host_loop_s": host_s, "host_loop_crops_per_s": host_rate,
            "host_loop_crops_per_s_after_first_step": host_warm_rate,
            "step_ms": step_ms, "step_crops_per_s": B / step_ms * 1e3,
            "bare_steps_crops_per_s": bare_rate, "step_gaps_ms": gaps, "csv": rows,
            "checkpoint_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "resume_rel_loss": rel, "best_checkpoint_step": best_step}


# -- the command line: a reference .pth of the trained flagship, validated,
# -- trained from and evaluated through cli.main on the committed set

CLI_TRAIN_STEPS = 3


def reference_pth(bundle_path: str, path: str) -> int:
    """Write the bundle at ``bundle_path`` as the reference codebase's
    ``.pth`` at ``path``: each entry through the inverse of the transform
    that ``train/torch_import.torch_key_for`` names (a packed q/k/v split
    back into three), under nn.DataParallel's ``module.`` prefix, plus
    keys the import ignores: a ``num_batches_tracked`` beside every
    BatchNorm's running mean and decoder layer 0's weights again as the
    reference's clone prototype (``decoder.decoder_layer.*``).  Returns the
    number of keys written."""
    from multimodal_scene_text_recognition_tpu_torch import convert
    from multimodal_scene_text_recognition_tpu_torch.train import torch_import

    inverse = {torch_import._t_linear: lambda a: a.T,
               torch_import._t_conv: lambda a: a.transpose(3, 2, 0, 1)}
    sd = {}
    for key, arr in convert.load_bundle(bundle_path).items():
        if key in convert.META_KEYS:
            continue
        collection, *path_keys = key.split(".")
        km = torch_import.torch_key_for(collection, tuple(path_keys))
        if km is None:
            continue
        tkey, transform = km
        arr = arr.astype(np.float32)
        if isinstance(tkey, tuple):  # the packed q/k/v of an Oscar attention
            for k, part in zip(tkey, np.split(arr, len(tkey), axis=-1)):
                sd[k] = part.T if transform is torch_import._t_qkv_w else part
        else:
            sd[tkey] = inverse.get(transform, lambda a: a)(arr)
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k.replace(".running_mean", ".num_batches_tracked")] = np.asarray(1000, np.int64)
    for k in [k for k in sd if k.startswith("decoder.decoder.layers.0.")]:
        sd[k.replace("decoder.decoder.layers.0.", "decoder.decoder_layer.")] = sd[k]
    torch.save({"module." + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               path)
    return len(sd)


def run_cli(main, argv, counted):
    """``main(argv)`` with its standard output kept: (exit code, output
    lines, wall seconds with the card synchronized, launches of each
    kernel of ``counted`` ({name: wrapper}) in the call)."""
    import io

    for k in counted.values():
        k.launches = 0
    out = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    return rc, out.getvalue().splitlines(), secs, {n: k.launches for n, k in counted.items()}


def _cli_line(lines, start: str) -> str:
    hit = [x for x in lines if x.startswith(start)]
    if not hit:
        raise AssertionError(f"the command line printed no line starting {start!r}: "
                             f"{lines[-5:]}")
    return hit[-1]


def _cli_accuracy(lines) -> float:
    return float(_cli_line(lines, "val accuracy: ")[len("val accuracy: "):].rstrip("%"))


def cli_phase(api, fd, gs, bn, smi: str):
    """The command line on the card, in process: write the trained
    flagship as a reference ``.pth``; ``validate --checkpoint <pth>
    --records`` on the 512 committed crops in bf16 (``decode_fused``: K1),
    whose accuracy must equal ``api.validate`` of the bundle; ``train`` for
    CLI_TRAIN_STEPS steps from the ``.pth`` (a validation before and after,
    a checkpoint at the last); ``validate --checkpoint <dir>`` of that
    checkpoint, equal to ``api.validate`` of a trainer restored from it;
    and ``evaluate --base-errors`` on the anno ids the ``.pth`` read wrong,
    whose "Corrected" line must count the trained model's right readings
    of them.  The flagship's fusion hooks are off, so no path reads the
    semantic embed table: the import skips it, as the reference loader
    does.  Each verb's wall time includes its first call (model build,
    import or restore, the datasets, the first K1 call's tables)."""
    import ast
    import importlib.util

    from multimodal_scene_text_recognition_tpu_torch import cli
    from multimodal_scene_text_recognition_tpu_torch.config import Config, apply_overrides
    from multimodal_scene_text_recognition_tpu_torch.train import checkpoint

    counted = {"K1": fd.fused_greedy_decode_cuda, "K2": gs.grid_sample_cuda, "K3": bn.bn_bwd_cuda}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:  # the .pth (~0.3 GB) and the checkpoint (~0.9 GB) go on every exit
        pth = os.path.join(tmp, "flagship.pth")
        t = time.perf_counter()
        n_keys = reference_pth(BUNDLE, pth)
        write_s = time.perf_counter() - t
        # no class labels for evaluate: the committed set's object ids run to
        # 1999, past every class list in assets/features
        common = ["--set", "model.decode_fused=true", "--set", f"results_dir={tmp}",
                  "--set", f"data.class_labels_dir={tmp}", "--experiment", "cli"]
        pandas = importlib.util.find_spec("pandas") is not None
        records = os.path.join(tmp, "records.csv")
        secs, launches = {}, {}

        argv = ["validate", "--checkpoint", pth] + common
        rc, lines, secs["validate_pth"], launches["validate_pth"] = run_cli(
            cli.main, argv + (["--records", records] if pandas else []), counted)
        acc_pth = _cli_accuracy(lines)
        stats = ast.literal_eval(_cli_line(lines, "  - imported torch checkpoint: ")
                                 .split(": ", 1)[1])
        acc_api = api.validate(api.get_model(BUNDLE))
        log(f"cli validate --checkpoint <reference .pth of {n_keys} keys, written in "
            f"{write_s:.2f} s>: {acc_pth}% (api.validate of the bundle {acc_api}%) in "
            f"{secs['validate_pth']:.2f} s; import: {stats['loaded']} loaded, "
            f"{len(stats['missing'])} missing, skipped {stats['skipped']}, "
            f"{len(stats['unused_torch_keys'])} unused; launches {launches['validate_pth']}")
        if rc != 0 or acc_pth != acc_api or stats["missing"] or stats["unused_torch_keys"] != \
                stats["skipped"]:
            raise AssertionError(f"cli validate from the .pth: rc {rc}, {acc_pth}% against "
                                 f"api.validate's {acc_api}%, stats {stats}")
        if pandas:  # the records CSV that pandas wrote, read back with csv
            import csv

            with open(records, newline="") as f:
                wrong = [r["anno_id"] for r in csv.DictReader(f) if r["correct"] != "True"]
        else:  # no pandas on the card: the same records from evaluate.validate
            from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec
            from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP

            val_set = api.get_dataset("synthetic")[1]
            res = validation_records(api.get_model(BUNDLE), val_set,
                                     AttnCodec(FLAGSHIP.chars, FLAGSHIP.max_text_length))
            wrong = [str(r.anno_id) for r in res.records if not r.correct]
        if len(wrong) != round(512 * (1 - acc_pth / 100)):
            raise AssertionError(f"{len(wrong)} wrong records at {acc_pth}%")

        train_argv = ["train", "--checkpoint", pth, "--set",
                      f"train.iteration_limit={CLI_TRAIN_STEPS}", "--set",
                      f"train.validation_steps={CLI_TRAIN_STEPS}"] + common
        rc, lines, secs["train"], launches["train"] = run_cli(cli.main, train_argv, counted)
        ckpt = os.path.join(tmp, "models", "cli")
        if (rc != 0 or f"--- Iteration limit reached: {CLI_TRAIN_STEPS}" not in lines
                or not os.path.exists(os.path.join(ckpt, checkpoint.STATE_FILE))):
            raise AssertionError(f"cli train: rc {rc}, no checkpoint or no stop: {lines[-6:]}")
        want = {"K1": 6, "K2": CLI_TRAIN_STEPS + 6, "K3": 36 * CLI_TRAIN_STEPS}
        if launches["train"] != want:
            raise AssertionError(f"cli train launched {launches['train']}, expected {want}")

        rc, lines, secs["validate_checkpoint"], launches["validate_checkpoint"] = run_cli(
            cli.main, ["validate", "--checkpoint", ckpt] + common, counted)
        acc_trained = _cli_accuracy(lines)
        cfg = apply_overrides(Config(), [a for a in common if a != "--set"][:-2])
        trainer = api.get_trainer(None, cfg.model, cfg.train)
        checkpoint.restore_checkpoint(ckpt, trainer)
        acc_restored = api.validate(trainer, cfg=cfg)
        del trainer

        base = os.path.join(tmp, "base_errors.txt")
        with open(base, "w") as f:
            f.write("\n".join(wrong) + "\n")
        rc_e, lines, secs["evaluate"], launches["evaluate"] = run_cli(
            cli.main, ["evaluate", "--checkpoint", ckpt, "--base-errors", base] + common, counted)
        corrected = _cli_line(lines, "Corrected: ")
        log(f"cli train from the .pth: {CLI_TRAIN_STEPS} steps in {secs['train']:.2f} s "
            f"(launches {launches['train']}); validate --checkpoint <its directory>: "
            f"{acc_trained}% (api.validate of the restored trainer {acc_restored}%) in "
            f"{secs['validate_checkpoint']:.2f} s; evaluate --base-errors <{len(wrong)} ids the "
            f".pth read wrong>: {corrected!r} in {secs['evaluate']:.2f} s (launches "
            f"{launches['evaluate']})")
        n = int(corrected.split()[1])
        if (rc != 0 or rc_e != 0 or acc_trained != acc_restored
                or corrected != f"Corrected: {n} / {len(wrong)}"):
            raise AssertionError(f"cli validate of the checkpoint {acc_trained}% against "
                                 f"{acc_restored}%, or evaluate printed {corrected!r}")
        for verb in ("validate_pth", "validate_checkpoint", "evaluate"):
            if launches[verb]["K1"] < 3 or launches[verb]["K2"] < 3:
                raise AssertionError(f"cli {verb} launched {launches[verb]}")
        log("cli verbs' wall s (first call included): " + ", ".join(
            f"{k} {v:.2f}" for k, v in secs.items()) + f"; card {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"pth_keys": n_keys, "pth_write_s": write_s, "import_stats": {
        "loaded": stats["loaded"], "missing": len(stats["missing"]),
        "skipped": stats["skipped"], "unused": len(stats["unused_torch_keys"])},
        "val_acc_pth": acc_pth, "val_acc_api": acc_api, "val_acc_trained": acc_trained,
        "val_acc_restored": acc_restored, "corrected": corrected, "wall_s": secs,
        "launches": launches, "card": smi}


# -- the classic recognizers: BiLSTM-Attn served and trained, BiLSTM-CTC
# -- trained and validated, at full width with seeded random weights

CLASSIC_SEED = 17  # their random weights (no bundle holds them)
# f32 BiLSTM-Attn on the card (TF32 turned on by the caller) against the
# same model on the CPU: a row whose string differs must flip its first
# differing token at a CPU top-2 gap below this (a rounding-level tie)
CLASSIC_FLIP_GAP = 1e-4
CLASSIC_SERVE_REPS = 5


def classic_configs():
    """BiLSTM-Attn (the reference's TPS-ResNet-BiLSTM-Attn) and BiLSTM-CTC:
    the JAX defaults with these switches."""
    from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig

    return (ModelConfig(encoder="lstm", decoder="lstm"),
            ModelConfig(encoder="lstm", decoder="linear", label_codec="ctc"))


def classic_serve(api, gs, crops, cfg):
    """BiLSTM-Attn served by ``Recognizer.recognize`` at B=192: in f32 with
    TF32 allowed by the caller against the same model on the CPU (strings,
    and the logits up to each row's first differing token), then in bf16
    its K2 launches, its ms a call, its stage split and the card's idle
    share, and its strings against the plain path (printed)."""
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    card = api.get_model(None, cfg32, seed=CLASSIC_SEED)
    rec = Recognizer(card, batch_sizes=(B,))
    with tf32_on():  # the float32 model (its LSTMs too) must not take it
        texts32 = rec.recognize(crops)
        image, overlap, _, _ = rec.prepare(crops, B)
        with torch.no_grad():
            got = card(image, overlap).cpu()
    del card
    host = api.get_model(None, cfg32, device="cpu", seed=CLASSIC_SEED)
    t = time.perf_counter()
    with torch.no_grad():
        want = host(image.cpu(), overlap.cpu())
    cpu_s = time.perf_counter() - t
    del host
    host_texts = rec.codec.decode(want.argmax(-1).numpy())
    same = sum(a == b for a, b in zip(texts32, host_texts)) / B
    err, flips = err_to_first_flip(got, want)
    distinct = len(set(host_texts))
    log(f"BiLSTM-Attn f32 with TF32 allowed by the caller, card vs CPU on {B} rows: strings "
        f"{same:.4f} identical ({distinct} distinct strings on the CPU; e.g. "
        f"{host_texts[:3]}), logits {tuple(got.shape)} max |diff| up to each row's first "
        f"differing token {err:.3e}, rows that differ (row, step, CPU top-2 gap) {flips} "
        f"(gap limit {CLASSIC_FLIP_GAP:g}); the CPU forward {cpu_s:.2f} s")
    if got.shape != (B, cfg.max_text_length + 1, cfg.num_classes) or not torch.isfinite(
            got).all():
        raise AssertionError(f"BiLSTM-Attn logits: shape {tuple(got.shape)} or non-finite")
    if any(gap >= CLASSIC_FLIP_GAP for _, _, gap in flips):
        raise AssertionError(f"BiLSTM-Attn f32 card strings differ from the CPU's at gaps "
                             f"{flips} (limit {CLASSIC_FLIP_GAP})")

    model = api.get_model(None, cfg, seed=CLASSIC_SEED)
    rec = Recognizer(model, batch_sizes=(B,))
    gs.grid_sample_cuda.launches = 0
    texts = rec.recognize(crops)
    k2 = gs.grid_sample_cuda.launches
    if k2 != 1 or len(texts) != B:
        raise AssertionError(f"a served BiLSTM-Attn call launched K2 {k2} times (expected 1) "
                             f"or returned {len(texts)} strings")
    beam_texts, scores = rec.recognize(crops, beam_size=BEAM, return_scores=True)
    if beam_texts != texts or any(scores):
        raise AssertionError("BiLSTM-Attn with a beam width: not the greedy strings with 0.0")
    model.set_use_kernels(False)
    plain = rec.recognize(crops)
    model.set_use_kernels(True)
    agree = sum(a == b for a, b in zip(texts, plain)) / B
    ms, samples = call_ms(lambda: rec.recognize(crops), reps=CLASSIC_SERVE_REPS)
    stages = stage_times(model, rec, crops, lambda enc: model.decoder.greedy_decode(enc).argmax(-1),
                         reps=CLASSIC_SERVE_REPS)
    prof = kernel_profile(lambda: rec.recognize(crops), calls=3)
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiler saw no kernel run on the card")
    log(f"BiLSTM-Attn bf16: {ms:.2f} ms per {B}-crop call (median of {CLASSIC_SERVE_REPS} warm "
        f"calls, CUDA events; samples {[round(x, 2) for x in samples]}), "
        f"{B / ms * 1e3:.1f} crops/s; K2 launches a call {k2}; stage ms (median of "
        f"{CLASSIC_SERVE_REPS}) " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; profile of 3 calls: wall {prof['wall_ms']:.2f} ms, kernels busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.4f}; strings, "
        f"kernels vs plain: {agree:.4f} identical (printed only); beam_size={BEAM} gave the "
        f"greedy strings with scores 0.0")
    del model, rec
    torch.cuda.empty_cache()
    return {"f32_vs_cpu_strings": same, "f32_vs_cpu_err_to_first_flip": err,
            "f32_vs_cpu_flips": flips, "cpu_distinct_strings": distinct, "cpu_forward_s": cpu_s,
            "ms_per_call": ms, "ms_samples": samples, "crops_per_s": B / ms * 1e3,
            "stage_ms": stages, "profile": prof, "k2_launches_per_call": k2,
            "bf16_kernels_vs_plain_strings": agree}


def classic_train(api, bn, gs, name: str, cfg, train_cfg, codec):
    """TRAIN_STEPS bf16 steps at B=192 of ``cfg`` from CLASSIC_SEED's
    weights, with the kernels and with their plain versions, held to the
    train phase's limits; 36 K3 and 1 K2 launches a step; the median step
    ms and the peak memory."""
    batch = make_train_batch(B, 4321, cfg.chars, codec)
    torch.cuda.reset_peak_memory_stats()
    trainer, kmetrics, kcounts, shapes = train_run(api, bn, gs, batch, True, cfg=cfg,
                                                   train_cfg=train_cfg, seed=CLASSIC_SEED)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step, step_samples = call_ms(lambda: trainer(batch))
    del trainer
    torch.cuda.empty_cache()
    trainer, pmetrics, pcounts, _ = train_run(api, bn, gs, batch, False, cfg=cfg,
                                              train_cfg=train_cfg, seed=CLASSIC_SEED)
    del trainer
    torch.cuda.empty_cache()
    want = [(36 * (i + 1), i + 1) for i in range(TRAIN_STEPS)]
    diffs = rel_diffs(kmetrics, pmetrics)
    loss_diffs, norm_diff = [d[0] for d in diffs], diffs[0][1]
    log(f"train {name}: kernels {kmetrics}, K3/K2 launches after each step {kcounts}; plain "
        f"{pmetrics}, launches {pcounts}; relative loss {[f'{d:.3e}' for d in loss_diffs]} "
        f"(limits {TRAIN_LOSS_TOL}), step-1 grad norm {norm_diff:.3e} (limit {TRAIN_NORM_TOL:g}); "
        f"median step {ms_step:.2f} ms of {[round(x, 2) for x in step_samples]} "
        f"({B / ms_step * 1e3:.1f} crops/s), peak memory {peak_gb:.3f} GB")
    for m in kmetrics + pmetrics:
        if not np.isfinite([m["loss"], m["grad_norm"]]).all():
            raise AssertionError(f"non-finite {name} training metrics: {m}")
    if len(shapes) != 36 or kcounts != want or any(c != (0, 0) for c in pcounts):
        raise AssertionError(f"training {name} launched K3/K2 {kcounts} with {len(shapes)} "
                             f"BatchNorms a step (expected {want}), plain {pcounts}")
    if not (all(d <= t for d, t in zip(loss_diffs, TRAIN_LOSS_TOL))
            and norm_diff <= TRAIN_NORM_TOL):
        raise AssertionError(f"kernel and plain {name} training runs disagree: {diffs}")
    return {"metrics_kernels": kmetrics, "metrics_plain": pmetrics, "rel_diff_by_step": diffs,
            "ms_per_step": ms_step, "ms_samples": step_samples,
            "crops_per_s": B / ms_step * 1e3, "peak_memory_gb": peak_gb,
            "launches": kcounts[-1]}


def classic_ctc_epoch(api, bn, gs, cfg, train_cfg, codec):
    """``api.train`` of BiLSTM-CTC for one epoch of the committed set
    (LOOP_STEPS steps at B=192, device data, the validation before training
    only): every loss finite, the last below the first; then
    ``eval.evaluate.validate`` with ``CTCCodec`` on the 512 committed
    validation crops, its accuracy (no limit: one epoch from random
    weights) and ms."""
    from multimodal_scene_text_recognition_tpu_torch.config import Config
    from multimodal_scene_text_recognition_tpu_torch.data.pipeline import Batcher, batches
    from multimodal_scene_text_recognition_tpu_torch.eval.evaluate import validate
    from multimodal_scene_text_recognition_tpu_torch.train.steps import make_eval_step

    results = tempfile.mkdtemp(prefix="chip_smoke_ctc_")
    try:
        run_cfg = Config(experiment="smoke_ctc", model=cfg, train=train_cfg,
                         results_dir=results)
        trainer = api.get_trainer(None, cfg, train_cfg, seed=CLASSIC_SEED)
        bn.bn_bwd_cuda.launches = 0
        gs.grid_sample_cuda.launches = 0
        probe = LoopProbe()
        loop_s = probe.run(lambda: api.train(trainer, "synthetic", 10 ** 6, LOOP_STEPS,
                                             cfg=run_cfg))
        launches = {"K2": gs.grid_sample_cuda.launches, "K3": bn.bn_bwd_cuda.launches}
    finally:
        shutil.rmtree(results, ignore_errors=True)
    losses = torch.stack([m["loss"] for m in probe.metrics]).tolist()
    steps = len(losses)
    _, val_set = api.get_dataset("synthetic", run_cfg)
    if val_set.text.shape != (512, cfg.max_text_length):
        raise AssertionError(f"the CTC validation rows are {val_set.text.shape}")

    def run():
        return validate(make_eval_step(trainer.model),
                        batches(val_set, Batcher(codec, B), shuffle=False, drop_last=False),
                        codec, return_records=True)

    gs.grid_sample_cuda.launches = 0
    result = run()
    val_k2 = gs.grid_sample_cuda.launches
    val_ms, val_samples = call_ms(run, reps=3, warm_up=False)
    log(f"api.train BiLSTM-CTC, device data: {steps} steps in {loop_s:.3f} s of steps "
        f"({steps * B / loop_s:.1f} crops/s), the initial validation "
        f"{[round(x, 3) for x in probe.validations]} s; launches {launches}; losses "
        f"{[round(x, 4) for x in losses]}; then validate with CTCCodec on {len(val_set)} crops: "
        f"{result.accuracy}% ({val_ms:.2f} ms, samples {[round(x, 2) for x in val_samples]}; "
        f"K2 launches {val_k2}), e.g. "
        f"{[(r.ground_truth, r.prediction) for r in result.records[:3]]}")
    want = {"K2": steps + 3 * len(probe.validations), "K3": 36 * steps}
    if steps != LOOP_STEPS or launches != want or val_k2 != 3:
        raise AssertionError(f"the CTC loop took {steps} steps and launched {launches} "
                             f"(expected {LOOP_STEPS} and {want}); its validation K2 {val_k2}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the CTC epoch's losses did not fall or are not finite: {losses}")
    del trainer
    torch.cuda.empty_cache()
    return {"steps": steps, "loop_s": loop_s, "loop_crops_per_s": steps * B / loop_s,
            "losses": losses, "launches": launches, "val_acc": result.accuracy,
            "val_ms": val_ms, "val_ms_samples": val_samples, "val_k2_launches": val_k2}


def classic_phase(api, bn, gs, crops):
    """The classic recognizers at full width with seeded random weights:
    BiLSTM-Attn served (``classic_serve``), three train steps of BiLSTM-Attn
    (cross-entropy) and of BiLSTM-CTC, kernels against plain
    (``classic_train``), and an epoch of BiLSTM-CTC on the committed set
    with its CTC validation (``classic_ctc_epoch``)."""
    from multimodal_scene_text_recognition_tpu_torch.charset import CTCCodec
    from multimodal_scene_text_recognition_tpu_torch.config import TrainConfig

    attn, ctc = classic_configs()
    ctc_train = TrainConfig(loss="ctc")
    ctc_codec = CTCCodec(ctc.chars, ctc.max_text_length)
    return {"serve_bilstm_attn": classic_serve(api, gs, crops, attn),
            "train_bilstm_attn": classic_train(api, bn, gs, "BiLSTM-Attn", attn, TrainConfig(),
                                               None),
            "train_bilstm_ctc": classic_train(api, bn, gs, "BiLSTM-CTC", ctc, ctc_train,
                                              ctc_codec),
            "epoch_bilstm_ctc": classic_ctc_epoch(api, bn, gs, ctc, ctc_train, ctc_codec)}


# -- the model variants: Oscar-BERT served (greedy, beam, f32, int8),
# -- BiLSTM-Attn in int8, and training Oscar-BERT, the random semantic
# -- source and backbone remat, at full width with seeded random weights

VARIANT_SEED = 19  # their random weights (no bundle holds them)
VARIANT_TAG_SEED = 20  # the served crops' tag lists (a train batch's: VARIANT_TAG_SEED + 1)
VARIANT_SERVE_REPS = 5
# Oscar-BERT bf16 beam search against its plain version: the least share of
# rows whose best beam is the plain one's.  A floor against a broken path,
# not a precision limit: these seeded weights leave near ties in many rows
# (the greedy flips sit at plain top-2 gaps of 3e-4-7e-3), after which two
# searches part for good; an H100 read 71.35% identical.
VARIANT_BEAM_MIN_SAME = 0.5
CLASS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "features",
                          "vinvl_classes.txt")


def oscar_bert_config():
    """The Oscar-BERT recognizer: the Oscar encoder fusing the BERT
    embedder's tag vectors, the semantic CLS step-0 row, the fused greedy
    decode and beam search; the JAX defaults otherwise."""
    from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig

    return ModelConfig(encoder="oscar", oscar_encoder=True, semantic_embedding="bert",
                       decode_fused=True, decode_beam_fused=True, cls_decoder_init=True)


def make_tag_rows(n: int, seed: int, max_len: int = 15):
    """Seeded detector tags per crop (1-8 labels of ``vinvl_classes.txt``)
    as ``TagTokenizer`` rows [n, max_len]: the ``overlap`` input the
    recognizer prepares for the BERT embedder."""
    from multimodal_scene_text_recognition_tpu_torch.data.bert_tokens import (
        tokenizer_from_class_file)

    tok = tokenizer_from_class_file(CLASS_FILE)
    with open(CLASS_FILE) as f:
        labels = [line.strip() for line in f if line.strip()]
    rng = np.random.default_rng(seed)
    return {"overlap": np.stack([tok.encode_tags(list(rng.choice(labels, rng.integers(1, 9))),
                                                 max_len=max_len) for _ in range(n)])}


def zero_counts(fd, fb, gs) -> None:
    for counter in ("launches", "launches_int8", "launches_int8_wide", "launches_cls0"):
        setattr(fd.fused_greedy_decode_cuda, counter, 0)
    fb.fused_beam_decode_cuda.launches = fb.fused_beam_decode_cuda.launches_cls0 = 0
    gs.grid_sample_cuda.launches = 0


def read_counts(fd, fb, gs) -> dict:
    return {"K1": fd.fused_greedy_decode_cuda.launches,
            "K1q": fd.fused_greedy_decode_cuda.launches_int8,
            "K1q wide": fd.fused_greedy_decode_cuda.launches_int8_wide,
            "K1 or K1q with cls0": fd.fused_greedy_decode_cuda.launches_cls0,
            "K4": fb.fused_beam_decode_cuda.launches,
            "K4 with cls0": fb.fused_beam_decode_cuda.launches_cls0,
            "K2": gs.grid_sample_cuda.launches}


def variant_stage_times(model, rec, crops, sem, decode, reps: int = VARIANT_SERVE_REPS,
                        rectify=None, features=None):
    """Median CUDA-event ms of each stage of one recognize call of a model
    with a semantic embedder: host prepare, rectify, features, the semantic
    embedder, the encoder, the decoder (``decode(enc, semantics)`` -> ids:
    memory, cls0, cross K/V and the kernel), strings."""
    rectify = rectify or model.rectify
    features = features or model.features
    names = ["prepare", "rectify", "features", "semantic embedder", "encoder", "decoder",
             "decode_strings"]
    samples = {n: [] for n in names}
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        with torch.no_grad(), model.precision():
            ev[0].record()
            image, overlap, scene, ious = rec.prepare(crops, len(crops), semantics=sem)
            ev[1].record()
            rect = rectify(image)
            ev[2].record()
            cols = features(rect)
            ev[3].record()
            s = model.semantics(overlap, scene, ious)
            ev[4].record()
            enc = model.encoder(cols, semantics=s)
            ev[5].record()
            ids = decode(enc, s)
            ev[6].record()
            rec.codec.decode(ids.cpu().numpy())
            ev[7].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(v[1:]) for n, v in samples.items()}


def oscar_f32(api, crops, tags, cfg):
    """Oscar-BERT in float32 with TF32 turned on by the caller: the greedy
    strings, kernels against plain, must be identical, and the beam ones
    may differ only at a tie (every row's best score within
    CLASSIC_FLIP_GAP of the plain one); then the greedy logits against the
    same model moved to the CPU (a differing string only at a CPU top-2 gap
    below CLASSIC_FLIP_GAP).  -> (summary, failures)."""
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer

    card = api.get_model(None, dataclasses.replace(cfg, compute_dtype="float32"),
                         seed=VARIANT_SEED)
    rec = Recognizer(card, batch_sizes=(B,))
    agree, texts = {}, {}
    with tf32_on():  # the float32 model (its Oscar and BERT matmuls too) must not take it
        for name, beam_size in (("greedy", 0), ("beam", BEAM)):
            texts[name], kscores = rec.recognize(crops, beam_size, return_scores=True,
                                                 semantics=tags)
            card.set_use_kernels(False)
            plain, pscores = rec.recognize(crops, beam_size, return_scores=True, semantics=tags)
            card.set_use_kernels(True)
            agree[name] = sum(a == b for a, b in zip(texts[name], plain)) / B
        beam_err = max(abs(a - b) for a, b in zip(kscores, pscores))
        beam_rows = sum(a != b for a, b in zip(texts["beam"], plain))
        image, overlap, scene, ious = rec.prepare(crops, B, semantics=tags)
        with torch.no_grad():
            got = card(image, overlap, scene=scene, ious=ious).cpu()
    host = card.to("cpu")  # the same weights
    t = time.perf_counter()
    with torch.no_grad():
        want = host(image.cpu(), overlap.cpu(), scene=scene.cpu(), ious=ious.cpu())
    cpu_s = time.perf_counter() - t
    host_texts = rec.codec.decode(want.argmax(-1).numpy())
    del card, host, rec
    torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(texts["greedy"], host_texts)) / B
    err, flips = err_to_first_flip(got, want)
    log(f"Oscar-BERT f32 with TF32 allowed by the caller: strings, kernels vs plain {agree} "
        f"(greedy limit 1.0; beam: {beam_rows} rows differ, best scores max |diff| "
        f"{beam_err:.3e}, limit {CLASSIC_FLIP_GAP:g}: a differing beam only at a tie); greedy "
        f"card vs CPU {same:.4f} identical ({len(set(host_texts))} distinct "
        f"on the CPU, e.g. {host_texts[:3]}), logits max |diff| up to each row's first "
        f"differing token {err:.3e}, rows that differ (row, step, CPU top-2 gap) {flips} (gap "
        f"limit {CLASSIC_FLIP_GAP:g}); the CPU forward {cpu_s:.2f} s")
    failures = []
    if agree["greedy"] != 1.0 or not beam_err < CLASSIC_FLIP_GAP:
        failures.append(f"f32 strings, kernels vs plain: {agree}; beam scores {beam_err} off")
    if got.shape != (B, cfg.max_text_length, cfg.num_classes) or not torch.isfinite(got).all():
        failures.append(f"f32 logits of shape {tuple(got.shape)} or not finite")
    if any(gap >= CLASSIC_FLIP_GAP for _, _, gap in flips):
        failures.append(f"f32 card strings differ from the CPU's at gaps {flips}")
    return {"f32_kernels_vs_plain_strings": agree, "f32_beam_score_err": beam_err,
            "f32_beam_rows_differing": beam_rows, "f32_vs_cpu_strings": same,
            "f32_vs_cpu_err_to_first_flip": err, "f32_vs_cpu_flips": flips,
            "cpu_distinct_strings": len(set(host_texts)), "cpu_forward_s": cpu_s}, failures


def kernels_vs_plain(model, rec, crops, sem, beam_size: int, int8: bool):
    """The decoder of one served call with the kernels and with their plain
    versions on one encoder output, computed once, so that what differs is
    the decoder's kernel alone (K2's float32-ulp differences upstream are
    held in the K2 phase).  Greedy: the logits [B, T, C] of each; beam:
    (tokens, best scores) of each."""
    with torch.no_grad(), model.precision():
        image, overlap, scene, ious = rec.prepare(crops, B, semantics=sem)
        if int8:
            step = rec._int8_steps[None]
            cols = step.features(step.rectify(image))
        else:
            cols = model.features(model.rectify(image))
        s = model.semantics(overlap, scene, ious)
        enc = model.encoder(cols, semantics=s)
        out = {}
        for on in (True, False):
            model.set_use_kernels(on)
            out[on] = (model.decoder.beam_decode(enc, s, beam_size) if beam_size
                       else model.decoder.greedy_decode(enc, s))
        model.set_use_kernels(True)
    return out[True], out[False]


def served_variant(api, fd, fb, gs, crops, name: str, cfg, sem, beam_size: int, want: dict,
                   tol: float, int8: bool = False, model=None):
    """One served call of ``cfg`` (random weights of VARIANT_SEED, or
    ``model``) at B=192: its launches (each of ``want``'s counters must read
    its value, the others 0; K2 at least 1), its strings against the plain
    path's (printed), the decoder with the kernels against its plain
    version (``kernels_vs_plain``) within ``tol``, ms a call, the stage
    split (a model with a semantic embedder) and the idle share.

    The seeded decoders have near ties in many rows (the plain version's
    own top-2 gaps show them), where a rounding-level difference flips a
    token and the rest of the row; so the strings' share is printed, and
    what is held is the numbers: greedy, the logits up to and at each
    row's first differing token within ``tol``, and each flip at a plain
    top-2 gap below ``tol`` (a flip at a wider gap is a fault); beam, the
    best score of every row whose best beam is the plain one's within
    ``tol``, and at least VARIANT_BEAM_MIN_SAME of the rows so (a floor
    against a broken path: two searches part for good after a near tie, and
    then their best scores are those of other beams; the float32 call holds
    K4's beams on this model at ties).  -> (summary, failures, model)."""
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer

    if model is None:
        model = api.get_model(None, cfg, seed=VARIANT_SEED)
    rec = Recognizer(model, batch_sizes=(1, 8, 64, B), int8_backbone=int8)
    zero_counts(fd, fb, gs)
    texts, scores = rec.recognize(crops, beam_size, return_scores=True, semantics=sem)
    n = read_counts(fd, fb, gs)
    failures = []
    wrong = {k: v for k, v in n.items() if v != want.get(k, 0) and k != "K2"}
    if wrong or n["K2"] < 1:
        failures.append(f"{name}: launches {n}, expected {want} (K2 at least 1)")
    if len(texts) != B or not np.isfinite(scores).all() or max(scores) > 0:
        failures.append(f"{name}: missing strings or bad scores")
    model.set_use_kernels(False)
    plain = rec.recognize(crops, beam_size, semantics=sem)
    model.set_use_kernels(True)
    agree = sum(a == b for a, b in zip(texts, plain)) / B
    got, ref = kernels_vs_plain(model, rec, crops, sem, beam_size, int8)
    if beam_size:
        differ = (got[0] != ref[0]).any(-1)
        gap = (got[1] - ref[1]).abs()
        flips = int(differ.sum())
        err = gap[~differ].max().item() if flips < B else float("inf")
        apart = gap[differ].max().item() if flips else 0.0
        numbers = (f"beams, kernels vs plain: {B - flips} rows' best beams identical, their "
                   f"best scores max |diff| {err:.3e} (limit {tol:g}); {flips} differ, their "
                   f"best scores up to {apart:.3e} apart")
        if not err <= tol or flips > (1 - VARIANT_BEAM_MIN_SAME) * B:
            failures.append(f"{name}: {flips} best beams differ from the plain version's, the "
                            f"identical ones' scores {err} off (limit {tol})")
    else:
        err, flips = err_to_first_flip(got, ref)
        wide = [f for f in flips if f[2] >= tol]
        numbers = (f"logits up to each row's first differing token max |diff| {err:.3e} (limit "
                   f"{tol:g}); {len(flips)} rows differ, plain top-2 gaps at their flips "
                   f"{sorted(round(g, 4) for _, _, g in flips)}")
        if not err <= tol or wide:
            failures.append(f"{name}: logits {err} off the plain version's, flips at gaps >= "
                            f"{tol}: {wide}")
    ms, samples = call_ms(lambda: rec.recognize(crops, beam_size, semantics=sem),
                          reps=VARIANT_SERVE_REPS)
    stages = None
    if sem is not None:
        dec = model.decoder
        if beam_size:
            decode = lambda e, s: dec.beam_decode(e, s, beam_size)[0]  # noqa: E731
        else:
            decode = lambda e, s: dec.greedy_decode(e, s).argmax(-1)  # noqa: E731
        parts = {}
        if int8:
            step = rec._int8_steps[None]
            parts = dict(rectify=step.rectify, features=step.features)
        stages = variant_stage_times(model, rec, crops, sem, decode, **parts)
    prof = kernel_profile(lambda: rec.recognize(crops, beam_size, semantics=sem), calls=3)
    if prof["device_busy_ms"] <= 0:
        failures.append(f"{name}: the profiler saw no kernel run on the card")
    log(f"{name}: launches {n}; strings, kernels vs plain {agree:.4f} identical; {numbers}; "
        f"{ms:.2f} ms per {B}-crop call (median of {VARIANT_SERVE_REPS} warm calls, CUDA "
        f"events; samples {[round(x, 2) for x in samples]}), {B / ms * 1e3:.1f} crops/s; "
        + ("stage ms " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + "; "
           if stages else "")
        + f"profile of 3 calls: wall {prof['wall_ms']:.2f} ms, kernels busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.4f}; by kernel "
        f"{prof['kernels_ms']}; e.g. {texts[:3]}")
    return ({"launches": n, "string_agreement_kernels_vs_plain": agree,
             "max_abs_err": err, "differing_rows": flips, "ms_per_call": ms,
             "ms_samples": samples, "crops_per_s": B / ms * 1e3, "stage_ms": stages,
             "profile": prof}, failures, model)


def trained_over(model) -> None:
    """Load the trained bundle's weights into ``model`` (a flagship with
    more modules, or another semantic source: the rest keep their seeded
    weights); every bundle key but the semantic table must find its place."""
    from multimodal_scene_text_recognition_tpu_torch import convert

    own = model.state_dict()
    sd = {k: v for k, v in convert.bundle_to_state_dict(convert.load_bundle(BUNDLE)).items()
          if k in own or not k.startswith("semantic.")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or len(missing) + len(sd) != len(own):
        raise AssertionError(f"the bundle does not fit: unexpected {unexpected}")


def variant_train(api, bn, gs, name: str, cfg, batch, trained: bool = False):
    """TRAIN_STEPS bf16 steps at B=192 of ``cfg`` from VARIANT_SEED's
    weights (with ``trained`` the trained bundle's where it has them), with
    the kernels and with their plain versions (the same generator seed: the
    same dropout masks and ``rand`` semantics), held to the train phase's
    limits; 36 K3 and 1 K2 launches a step; the median step ms and the peak
    memory.  -> (summary, failures)."""
    torch.cuda.reset_peak_memory_stats()
    trainer, kmetrics, kcounts, _ = train_run(api, bn, gs, batch, True, cfg=cfg,
                                              seed=VARIANT_SEED, trained=trained)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step, step_samples = call_ms(lambda: trainer(batch))
    del trainer
    torch.cuda.empty_cache()
    trainer, pmetrics, pcounts, _ = train_run(api, bn, gs, batch, False, cfg=cfg,
                                              seed=VARIANT_SEED, trained=trained)
    del trainer
    torch.cuda.empty_cache()
    want = [(36 * (i + 1), i + 1) for i in range(TRAIN_STEPS)]
    diffs = rel_diffs(kmetrics, pmetrics)
    loss_diffs, norm_diff = [d[0] for d in diffs], diffs[0][1]
    log(f"train {name}: kernels {kmetrics}, K3/K2 launches after each step {kcounts}; plain "
        f"{pmetrics}, launches {pcounts}; relative loss {[f'{d:.3e}' for d in loss_diffs]} "
        f"(limits {TRAIN_LOSS_TOL}), step-1 grad norm {norm_diff:.3e} (limit {TRAIN_NORM_TOL:g}); "
        f"median step {ms_step:.2f} ms of {[round(x, 2) for x in step_samples]} "
        f"({B / ms_step * 1e3:.1f} crops/s), peak memory {peak_gb:.3f} GB")
    failures = []
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in kmetrics + pmetrics):
        failures.append(f"train {name}: non-finite metrics")
    if kcounts != want or any(c != (0, 0) for c in pcounts):
        failures.append(f"train {name}: K3/K2 launches {kcounts} (expected {want}), plain "
                        f"{pcounts}")
    if not (all(d <= t for d, t in zip(loss_diffs, TRAIN_LOSS_TOL))
            and norm_diff <= TRAIN_NORM_TOL):
        failures.append(f"train {name}: kernels vs plain {diffs}")
    return ({"metrics_kernels": kmetrics, "metrics_plain": pmetrics, "rel_diff_by_step": diffs,
             "ms_per_step": ms_step, "ms_samples": step_samples, "crops_per_s": B / ms_step * 1e3,
             "peak_memory_gb": peak_gb, "launches": kcounts[-1]}, failures)


def remat_against_none(api, cfg, batch):
    """TRAIN_STEPS kernel steps of the trained bundle in ``cfg`` with
    ``remat`` and without it, one trainer at a time: the running statistics after
    the first step must be equal (the recomputed forward moves none), the
    losses within TRAIN_LOSS_TOL of each other (the backward's
    nondeterministic sums part the runs from step 2 on, as two runs without
    remat part), with each run's peak memory and median step ms.  ->
    (summary, failures)."""
    runs = {}
    for remat in (True, False):
        torch.cuda.reset_peak_memory_stats()
        trainer = api.get_trainer(BUNDLE, dataclasses.replace(cfg, remat=remat))
        losses, stats = [], None
        for i in range(TRAIN_STEPS):
            losses.append(trainer(batch)["loss"].item())
            if i == 0:
                stats = {k: t.clone() for k, t in trainer.model.state_dict().items()
                         if "running_" in k}
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms, samples = call_ms(lambda: trainer(batch), warm_up=False)
        runs[remat] = {"losses": losses, "stats": stats, "peak_memory_gb": peak_gb,
                       "ms_per_step": ms, "ms_samples": samples}
        del trainer
        torch.cuda.empty_cache()
    r, n = runs[True], runs[False]
    unequal = [k for k in n["stats"] if not torch.equal(r["stats"][k], n["stats"][k])]
    rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], n["losses"])]
    log(f"remat vs none: losses {r['losses']} / {n['losses']} (relative {rel}, limits "
        f"{TRAIN_LOSS_TOL}); running statistics after step 1: {len(n['stats']) - len(unequal)} "
        f"of {len(n['stats'])} equal; peak memory {r['peak_memory_gb']:.3f} GB with remat, "
        f"{n['peak_memory_gb']:.3f} GB without; median step {r['ms_per_step']:.2f} / "
        f"{n['ms_per_step']:.2f} ms")
    failures = []
    if unequal:
        failures.append(f"remat: running statistics differ from those without it: {unequal[:4]}")
    if not all(d <= t for d, t in zip(rel, TRAIN_LOSS_TOL)):
        failures.append(f"remat: losses {r['losses']} against {n['losses']}")
    if not r["peak_memory_gb"] < n["peak_memory_gb"]:
        failures.append("remat: the peak memory did not fall")
    return ({"losses_remat": r["losses"], "losses_none": n["losses"], "rel_loss": rel,
             "stats_equal_after_step_1": not unequal,
             "peak_memory_gb_remat": r["peak_memory_gb"],
             "peak_memory_gb_none": n["peak_memory_gb"], "ms_per_step_remat": r["ms_per_step"],
             "ms_per_step_none": n["ms_per_step"]}, failures)


def variants_phase(api, fd, fb, gs, bn, crops):
    """The model variants at full width: Oscar-BERT (``oscar_bert_config``,
    seeded random weights) served at B=192 on seeded tag rows greedily (K1
    with cls0, K2) and by beam search (K4 with cls0) in bf16, then in
    float32 (``oscar_f32``), then through the int8 backbone with
    ``decode_int8`` (K1q with cls0), each held by ``served_variant``'s
    rules; BiLSTM-Attn through the int8 backbone (K2); three train steps
    each of Oscar-BERT, the flagship with the random semantic source and
    the pre-encoder fusion (the trained bundle, seeded fusion MLPs), and
    the trained flagship with ``remat``, kernels against plain
    (``variant_train``); and remat against none (``remat_against_none``).  Every check runs and prints
    before the phase raises on the limits broken."""
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP, ModelConfig

    cfg = oscar_bert_config()
    tags = make_tag_rows(B, VARIANT_TAG_SEED)
    out, failures = {}, []
    out["greedy"], f, model = served_variant(
        api, fd, fb, gs, crops, "Oscar-BERT greedy bf16", cfg, tags, 0,
        {"K1": 1, "K1 or K1q with cls0": 1}, CLS0_BF16_LOGIT_TOL)
    failures += f
    out["beam"], f, _ = served_variant(
        api, fd, fb, gs, crops, f"Oscar-BERT beam (k={BEAM}) bf16", cfg, tags, BEAM,
        {"K4": 1, "K4 with cls0": 1}, BEAM_BF16_SCORE_TOL, model=model)
    failures += f
    del model
    torch.cuda.empty_cache()
    out["f32"], f = oscar_f32(api, crops, tags, cfg)
    failures += f
    out["int8"], f, model = served_variant(
        api, fd, fb, gs, crops, "Oscar-BERT int8 greedy", dataclasses.replace(
            cfg, decode_int8=True, tps_int8=True), tags, 0,
        {"K1q": 1, "K1 or K1q with cls0": 1}, K1Q_BF16_LOGIT_TOL, int8=True)
    failures += f
    del model
    torch.cuda.empty_cache()
    out["bilstm_attn_int8"], f, model = served_variant(
        api, fd, fb, gs, crops, "BiLSTM-Attn int8 greedy",
        ModelConfig(encoder="lstm", decoder="lstm", tps_int8=True), None, 0, {},
        BF16_LOGIT_TOL, int8=True)
    failures += f
    del model
    torch.cuda.empty_cache()

    batch = make_train_batch(B, 4321, cfg.chars)
    oscar_batch = dict(batch, **make_tag_rows(B, VARIANT_TAG_SEED + 1))
    rand = dataclasses.replace(FLAGSHIP, semantic_source="rand", pre_encoder_mlp=True)
    remat = dataclasses.replace(FLAGSHIP, remat=True)
    for key, name, tcfg, b, trained in (
            ("train_oscar_bert", "Oscar-BERT", cfg, oscar_batch, False),
            ("train_rand", "rand semantics (the trained bundle, seeded fusion MLPs)", rand, batch,
             True),
            ("train_remat", "remat (the trained bundle)", remat, batch, True)):
        out[key], f = variant_train(api, bn, gs, name, tcfg, b, trained)
        failures += f
    out["remat_vs_none"], f = remat_against_none(api, FLAGSHIP, batch)
    failures += f
    if failures:
        raise AssertionError("model variants: " + "; ".join(failures))
    return out


@contextlib.contextmanager
def tf32_on():
    """TF32 allowed for float32 matmuls and convs, as a caller may set it."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def main() -> int:
    timer = threading.Timer(WATCHDOG_S, _watchdog)
    timer.daemon = True
    timer.start()

    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs on an NVIDIA GPU")
    # every comparison below is exact float32 where it is float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card_line()
    log(f"device {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    from multimodal_scene_text_recognition_tpu_torch import api
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
    from multimodal_scene_text_recognition_tpu_torch.kernels import build
    from multimodal_scene_text_recognition_tpu_torch.ops import batchnorm as bn
    from multimodal_scene_text_recognition_tpu_torch.ops import fused_beam as fb
    from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd
    from multimodal_scene_text_recognition_tpu_torch.ops import gemm_probe as gp
    from multimodal_scene_text_recognition_tpu_torch.ops import grid_sample as gs
    from multimodal_scene_text_recognition_tpu_torch.scripts import probe_int8

    phase("build")
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # a cold build, timed
    t = time.time()
    logs = build.build()
    log(f"built {', '.join(logs)} in {time.time() - t:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    phase("grid_sample vs plain")
    k2 = check_grid_sample(gs)

    phase("bn_backward vs plain")
    bn_err, bn_err_abs = check_bn_backward(bn)
    k3_variants = None
    if "--mutants" in sys.argv[1:]:
        phase("bn_backward mutants")
        check_bn_mutants(bn, build)
        phase("bn_backward timing variants")
        k3_variants = time_k3_variants(bn, build)

    phase("gemm probe (P1, P2) vs plain")
    p1, p2 = check_gemm_probe(gp, probe_int8, build, "--mutants" in sys.argv[1:])

    phase("load model")
    BEAM_CFG = dataclasses.replace(FLAGSHIP, decode_early_stop=True, decode_beam_fused=True)
    model = api.get_model(BUNDLE)
    rec = Recognizer(model, batch_sizes=(1, 8, 64, B))
    crops = make_crops(B, seed=1234)
    image, overlap, _, _ = rec.prepare(crops, B)
    model_b = api.get_model(BUNDLE, BEAM_CFG)  # early stop, fused beam
    rec_b = Recognizer(model_b, batch_sizes=(1, 8, 64, B))

    phase("fused_decode vs plain")
    k1 = check_fused_decode(fd, model, image, overlap)

    phase("fused_decode early stop vs plain")
    k1e = check_fused_decode_early_stop(fd, model, rec, rec_b, crops, image)

    phase("fused_decode at padded widths vs plain")
    k1["widths"] = check_k1_widths(fd)

    if "--mutants" in sys.argv[1:]:
        phase("K1 timing variants")
        k1["ms_without"] = time_k1_variants(fd, build, *beam_inputs(model, image))

    phase("fused_beam vs plain")
    k4 = check_fused_beam(fb, model, image)
    if "--mutants" in sys.argv[1:]:
        phase("fused_beam mutants")
        check_mutants(fb, build, model, image)

    phase("end-to-end bf16")
    fd.fused_greedy_decode_cuda.launches = 0
    gs.grid_sample_cuda.launches = 0
    texts = rec.recognize(crops)
    launches = {"fused_decode": fd.fused_greedy_decode_cuda.launches,
                "grid_sample": gs.grid_sample_cuda.launches}
    log(f"served {len(texts)} crops; kernel launches {launches}; e.g. {texts[:4]}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the served path never launched the {name} kernel")
    k1["launches"], k2["launches"] = launches["fused_decode"], launches["grid_sample"]
    with torch.no_grad():
        logits = model(image, overlap)
    if logits.shape != (B, 25, 97) or not torch.isfinite(logits).all():
        raise AssertionError(f"served logits: shape {tuple(logits.shape)} or non-finite")
    if len(texts) != B or not any(texts):
        raise AssertionError("the recognizer returned no strings")
    model.set_use_kernels(False)
    plain_texts = rec.recognize(crops)
    model.set_use_kernels(True)
    agree16 = sum(a == b for a, b in zip(texts, plain_texts)) / B
    log(f"bf16 strings, kernels vs plain versions: {agree16:.4f} identical (limit 0.98)")
    if not agree16 >= 0.98:
        raise AssertionError(f"bf16 end-to-end agreement {agree16} < 0.98")
    ms_call = cuda_ms(lambda: rec.recognize(crops), 10)
    crops_s = B / (ms_call / 1e3)
    log(f"throughput: {crops_s:.1f} crops/s ({ms_call:.2f} ms per {B}-crop call, "
        f"10 warm calls, CUDA events)")
    stages = stage_times(model, rec, crops, lambda enc: model.decoder.greedy_decode(enc).argmax(-1))
    log("stage ms (median of 10): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    prof = kernel_profile(lambda: rec.recognize(crops), calls=3)
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiler saw no kernel run on the card")
    log(f"profile of {prof['calls']} calls: wall {prof['wall_ms']:.2f} ms, kernels busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.4f}")
    # the same greedy call with early stop (K1e), through the beam config
    ms_call_es = cuda_ms(lambda: rec_b.recognize(crops), 10)
    stages_es = stage_times(model_b, rec_b, crops,
                            lambda enc: model_b.decoder.greedy_decode(enc).argmax(-1))
    log(f"greedy with early stop: {B / (ms_call_es / 1e3):.1f} crops/s ({ms_call_es:.2f} ms per "
        f"{B}-crop call, 10 warm calls, CUDA events); stage ms (median of 10): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages_es.items()))

    phase("end-to-end beam bf16")
    fb.fused_beam_decode_cuda.launches = 0
    gs.grid_sample_cuda.launches = 0
    btexts, bscores = rec_b.recognize(crops, beam_size=BEAM, return_scores=True)
    launches = {"fused_beam": fb.fused_beam_decode_cuda.launches,
                "grid_sample": gs.grid_sample_cuda.launches}
    log(f"served {len(btexts)} crops by beam search (k={BEAM}); kernel launches {launches}; "
        f"e.g. {list(zip(btexts[:3], bscores[:3]))}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the served beam path never launched the {name} kernel")
    if len(btexts) != B or not np.isfinite(bscores).all() or max(bscores) > 0:
        raise AssertionError("beam serving: missing strings or scores not finite and <= 0")
    k4["launches"] = launches["fused_beam"]
    k2["launches_beam"] = launches["grid_sample"]
    model_b.set_use_kernels(False)
    plain_btexts = rec_b.recognize(crops, beam_size=BEAM)
    model_b.set_use_kernels(True)
    agree_b16 = sum(a == b for a, b in zip(btexts, plain_btexts)) / B
    beam_vs_greedy = sum(a == b for a, b in zip(btexts, texts)) / B
    log(f"bf16 beam strings, kernels vs plain versions: {agree_b16:.4f} identical (limit 0.98); "
        f"beam vs greedy strings {beam_vs_greedy:.4f} identical (for information)")
    if not agree_b16 >= 0.98:
        raise AssertionError(f"bf16 beam end-to-end agreement {agree_b16} < 0.98")
    ms_beam = cuda_ms(lambda: rec_b.recognize(crops, beam_size=BEAM), 10)
    beam_crops_s = B / (ms_beam / 1e3)
    log(f"beam throughput: {beam_crops_s:.1f} crops/s ({ms_beam:.2f} ms per {B}-crop call, "
        f"10 warm calls, CUDA events)")
    beam_stages = stage_times(model_b, rec_b, crops,
                              lambda enc: model_b.decoder.beam_decode(enc, beam_size=BEAM)[0])
    share = beam_stages["decoder"] / sum(beam_stages.values())
    log("beam stage ms (median of 10): " + ", ".join(
        f"{k} {v:.3f}" for k, v in beam_stages.items()) + f"; decoder share {share:.3f}")
    beam_prof = kernel_profile(lambda: rec_b.recognize(crops, beam_size=BEAM), calls=3)
    if beam_prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiler saw no kernel run on the card")
    log(f"beam profile of {beam_prof['calls']} calls: wall {beam_prof['wall_ms']:.2f} ms, "
        f"kernels busy {beam_prof['device_busy_ms']:.2f} ms, idle share "
        f"{beam_prof['idle_share']:.4f}; by kernel {beam_prof['kernels_ms']}")
    del model, rec, model_b, rec_b
    torch.cuda.empty_cache()

    phase("int8")
    k1q, e2e_int8, _ = int8_phase(api, fd, fb, gs, build, crops, texts, btexts, k1, k1e,
                                  "--mutants" in sys.argv[1:])

    phase("end-to-end f32")
    agree32, beam_agree32 = {}, {}
    with tf32_on():  # the float32 model must not take it
        for name, cfg in (("greedy", FLAGSHIP), ("beam", BEAM_CFG)):
            model32 = api.get_model(BUNDLE, dataclasses.replace(cfg, compute_dtype="float32"))
            rec32 = Recognizer(model32, batch_sizes=(B,))
            beam_size = BEAM if name == "beam" else 0
            texts32 = rec32.recognize(crops, beam_size=beam_size)
            model32.set_use_kernels(False)
            plain32 = rec32.recognize(crops, beam_size=beam_size)
            agree32[name] = sum(a == b for a, b in zip(texts32, plain32)) / B
            ref = texts if name == "greedy" else btexts
            log(f"f32 {name} strings with TF32 allowed by the caller, kernels vs plain "
                f"versions: {agree32[name]:.4f} identical (limit 1.0); bf16 vs f32 serving: "
                f"{sum(a == b for a, b in zip(ref, texts32)) / B:.4f}")
            del model32, rec32
    if min(agree32.values()) != 1.0:
        raise AssertionError(f"f32 end-to-end agreement {agree32} < 1")

    phase("semantic")
    k1c, k4c, e2e_semantic = semantic_phase(api, fd, fb, gs, build, crops,
                                            "--mutants" in sys.argv[1:])

    phase("stepper greedy vs K1")
    stepper = stepper_phase(api, fd, gs, crops)

    phase("fusion sites")
    sites = fusion_sites_phase(api, fd, fb, gs, crops)

    phase("train with the hooks")
    train_hooks = train_hooks_phase(api, bn, gs)

    phase("resize")
    resized = resize_phase(api, gs, crops)

    phase("train bf16")
    torch.cuda.empty_cache()
    train, k3, k2_train = train_phase(api, bn, gs)
    k3["max_abs_err"] = max(k3["max_abs_err"], bn_err_abs)
    k3["max_err_of_sum_terms"] = max(k3["max_err_of_sum_terms"], bn_err)
    if k3_variants is not None:
        k3["step_ms_stopped_early"] = k3_variants
    k2["launches_train"] = k2_train
    k3["launches_train_with_hooks"] = train_hooks["launches"][0]
    k2["launches_train_with_hooks"] = train_hooks["launches"][1]
    k2["launches_fusion_sites"] = sites["launches"]["grid_sample"]

    phase("train and validate on the committed set")
    data = data_phase(api, fd, gs, bn)
    k1["launches_validate"] = data["val_launches"]["K1"]
    k1["launches_train_loop"] = data["loop_launches"]["K1"]
    k2["launches_validate"] = data["val_launches"]["K2"]
    k2["launches_train_loop"] = data["loop_launches"]["K2"]
    k3["launches_train_loop"] = data["loop_launches"]["K3"]

    phase("command line")
    cli_run = cli_phase(api, fd, gs, bn, smi)
    k1["launches_cli"] = sum(v["K1"] for v in cli_run["launches"].values())
    k2["launches_cli"] = sum(v["K2"] for v in cli_run["launches"].values())
    k3["launches_cli"] = sum(v["K3"] for v in cli_run["launches"].values())

    phase("classic recognizers")
    classic = classic_phase(api, bn, gs, crops)
    k2["launches_classic_serve"] = classic["serve_bilstm_attn"]["k2_launches_per_call"]
    for name in ("train_bilstm_attn", "train_bilstm_ctc"):
        k3[f"launches_{name}"], k2[f"launches_{name}"] = classic[name]["launches"]
    k2["launches_train_loop_ctc"] = classic["epoch_bilstm_ctc"]["launches"]["K2"]
    k3["launches_train_loop_ctc"] = classic["epoch_bilstm_ctc"]["launches"]["K3"]
    k2["launches_validate_ctc"] = classic["epoch_bilstm_ctc"]["val_k2_launches"]

    phase("model variants")
    variants = variants_phase(api, fd, fb, gs, bn, crops)
    k1c["launches_oscar_bert"] = variants["greedy"]["launches"]["K1 or K1q with cls0"]
    k1c["launches_int8_oscar_bert"] = variants["int8"]["launches"]["K1 or K1q with cls0"]
    k1q["launches_oscar_bert"] = variants["int8"]["launches"]["K1q"]
    k4c["launches_oscar_bert"] = variants["beam"]["launches"]["K4 with cls0"]
    for name in ("greedy", "beam", "int8", "bilstm_attn_int8"):
        k2[f"launches_variants_{name}"] = variants[name]["launches"]["K2"]
    for name in ("train_oscar_bert", "train_rand", "train_remat"):
        k3[f"launches_{name}"], k2[f"launches_{name}"] = variants[name]["launches"]

    phase("report")
    log(f"done in {time.time() - T0:.1f} s")
    print(json.dumps({"e2e": {"bf16_string_agreement": agree16,
                              "f32_string_agreement": agree32["greedy"],
                              "crops_per_s": crops_s, "ms_per_call": ms_call, "batch": B,
                              "stage_ms": stages, "profile": prof,
                              "early_stop": {"ms_per_call": ms_call_es, "stage_ms": stages_es}},
                      "e2e_beam": {"beam_size": BEAM, "bf16_string_agreement": agree_b16,
                                   "f32_string_agreement": agree32["beam"],
                                   "beam_vs_greedy_strings": beam_vs_greedy,
                                   "crops_per_s": beam_crops_s, "ms_per_call": ms_beam,
                                   "batch": B, "stage_ms": beam_stages,
                                   "decoder_share": share, "profile": beam_prof},
                      "e2e_int8": e2e_int8, "e2e_semantic": e2e_semantic,
                      "stepper": stepper, "fusion_sites": sites, "resize": resized,
                      "train": train, "train_with_hooks": train_hooks,
                      "train_and_validate": data, "command_line": cli_run,
                      "classic": classic,
                      "variants": variants}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [k1, k1e, k1q, k2, k3, k4, k1c, k4c, p1, p2]}),
          flush=True)
    timer.cancel()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
