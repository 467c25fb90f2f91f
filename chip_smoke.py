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
through the warp and BatchNorm-backward kernels; K3 is held against its
plain version at every BatchNorm shape of the step.  Every phase prints one
flushed line with the elapsed seconds; any failure raises and the script
exits non-zero.  ``--mutants`` also builds copies of the beam kernel with
one bf16 rounding dropped each and prints whether its bf16 limits catch
them.  A watchdog turns a hang into a printed failure (exit code
3).

Output: per-phase lines, the ``nvidia-smi`` name/power-limit line, one JSON
line ``{"kernels": [...]}`` before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs no network and nothing outside the repository; imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

WATCHDOG_S = 480
BUNDLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "assets", "trained", "synth_openvocab_xxl.params.npz")
B = 192
# H100 SXM data-sheet peaks (dense): the card's least time for a given work
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# K1 bf16 vs its plain version, max |logit diff| on the trained decoder at
# B=192 (logits of scale ~5).  On an H100 the kernel is 0.070 off; with any
# one of its bf16 roundings dropped (ReLU output, probabilities, q*K
# products) it was 0.127-0.161 off with every token still equal, so the
# limit sits between the two.
BF16_LOGIT_TOL = 0.1
# K3 vs its plain version: max over channels of |kernel - plain| over the
# sum of |terms| (at least 1).  Both sum float32 in another order: 2.7e-9 to
# 3.2e-8 on an H100; one element left out of the ragged shape's 231 per
# channel would be ~4e-3 off.
BN_TOL = 1e-6
BN_SHAPES = (((192, 64, 32, 100), torch.bfloat16), ((192, 512, 4, 26), torch.bfloat16),
             ((192, 128, 16, 50), torch.float32), ((3, 96, 7, 11), torch.bfloat16))
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
    device work is shorter than it (tens of microseconds here)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 / iters


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


def check_grid_sample(gs):
    """K2 against its plain version at B=192 on seeded grids, including
    points outside [-1, 1] and on integer pixel coordinates."""
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
    grid = torch.from_numpy(g).cuda()

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
    """x (a per-channel offset on unit noise), dy, both channels-last as the
    backbone's convs hand them over, and x's float32 batch mean and rstd, on
    the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C, cl = shape[1], torch.channels_last
    x = (torch.randn(shape, generator=g, device="cuda")
         + torch.randn((1, C, 1, 1), generator=g, device="cuda")).to(dtype).contiguous(
             memory_format=cl)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype).contiguous(memory_format=cl)
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    rstd = torch.rsqrt(xf.var(dim=(0, 2, 3), unbiased=False) + 1e-5)
    return x, dy, mean, rstd


def library_bn_sums(x, dy, mean, rstd):
    """(dgamma, dbeta) by one PyTorch call, the yardstick of K3 (never on
    the port's path)."""
    _, dgamma, dbeta = torch.ops.aten.native_batch_norm_backward(
        dy, x, torch.ones_like(mean), None, None, mean, rstd, True, 1e-5,
        [False, True, True])
    return dgamma, dbeta


def bn_check(bn, shape, dtype, seed: int) -> dict:
    """K3 against its plain version at one shape: twice, bit-equal from run
    to run, within BN_TOL of the sum of |terms| per channel (raises
    otherwise).  Then the device ms of the kernel, the plain version and the
    library call, the kernel's ms by CUDA events, and the bound (x and dy
    read once, mean and rstd read, dgamma and dbeta written)."""
    x, dy, mean, rstd = bn_inputs(shape, dtype, seed)
    got = bn.bn_bwd_sums_cuda(x, dy, mean, rstd)
    again = bn.bn_bwd_sums_cuda(x, dy, mean, rstd)
    ref = bn.bn_bwd_sums_plain(x, dy, mean, rstd)
    lib = library_bn_sums(x, dy, mean, rstd)
    torch.cuda.synchronize()
    dyf = dy.float()
    xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    scales = ((dyf * xhat).abs().sum(dim=(0, 2, 3)), dyf.abs().sum(dim=(0, 2, 3)))
    del dyf, xhat
    out = dict(err_abs=max((a - b).abs().max().item() for a, b in zip(got, ref)),
               err=max(((a - b).abs() / sc.clamp(min=1.0)).max().item()
                       for a, b, sc in zip(got, ref, scales)),
               lib_err=max(((a - b).abs() / sc.clamp(min=1.0)).max().item()
                           for a, b, sc in zip(lib, ref, scales)),
               repeat=all(torch.equal(a, b) for a, b in zip(got, again)))
    if not (out["err"] <= BN_TOL and out["repeat"]):
        raise AssertionError(f"bn_bwd_reduce disagrees with its plain version at {shape} "
                             f"{dtype}: {out}")
    kernel = lambda: bn.bn_bwd_sums_cuda(x, dy, mean, rstd)  # noqa: E731
    out["ms"] = device_ms(kernel)
    out["plain_ms"] = device_ms(lambda: bn.bn_bwd_sums_plain(x, dy, mean, rstd))
    out["library_ms"] = device_ms(lambda: library_bn_sums(x, dy, mean, rstd))
    n = x.numel()
    out["bound_ms"], out["bound_by"] = bound(2 * n * x.element_size() + 4 * shape[1] * 4,
                                             4 * n, PEAK_F32_FLOPS)
    out["events_ms"] = cuda_ms(kernel, 50, warmup=3)
    return out


def bn_line(shape, dtype, r: dict) -> str:
    return (f"{list(shape)} {str(dtype)[6:]}: error {r['err']:.3e} of sum |terms| (limit "
            f"{BN_TOL:g}; library call {r['lib_err']:.3e}), max |diff| {r['err_abs']:.3e}, "
            f"repeatable {r['repeat']}; device time: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, native_batch_norm_backward {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); kernel by CUDA events "
            f"{r['events_ms']:.4f} ms")


def check_bn_bwd_reduce(bn):
    """K3 against its plain version on the flagship's shapes at B=192 and a
    ragged one, with the kernel's, plain version's, library call's and
    bound's ms at each shape; the worst errors."""
    worst = worst_abs = 0.0
    for i, (shape, dtype) in enumerate(BN_SHAPES):
        r = bn_check(bn, shape, dtype, seed=i)
        log("bn_bwd_reduce " + bn_line(shape, dtype, r))
        worst, worst_abs = max(worst, r["err"]), max(worst_abs, r["err_abs"])
    return worst, worst_abs


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
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)
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
    ms = cuda_ms(lambda: fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw), 10)
    plain_ms = cuda_ms(lambda: fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw), 3)
    nbytes, flops = decode_cost(wd, ckd, T, 2)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    log(f"fused_decode bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return dict(name="fused_decode", route="cuda",
                source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_decode.cu",
                replaces="multimodal_scene_text_recognition_tpu/ops/fused_decode.py:207",
                jax="ops/fused_decode.py::_decode_kernel",
                max_abs_err=err32, max_abs_err_f32=err32, max_abs_err_bf16=err16,
                bf16_token_agreement=agree16,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def first_eos_steps(tokens, steps: int):
    """Steps each row's loop ran: one past the last of its beams' first
    [s] (tokens [B, K, T] or [B, T]), or ``steps`` where a beam never ends."""
    t = tokens.reshape(tokens.shape[0], -1, tokens.shape[-1])
    is_eos = t == 1
    first = torch.where(is_eos.any(-1), is_eos.int().argmax(-1), steps - 1)
    return (first.max(dim=1).values + 1).clamp(max=steps)


def pruned_agreement(a, b) -> float:
    """Share of token rows ([..., T]) equal up to and including the first
    [s] of ``b``."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    n = first_eos_steps(b[:, None], b.shape[-1])
    keep = torch.arange(b.shape[-1], device=b.device)[None] < n[:, None]
    return ((a == b) | ~keep).all(-1).float().mean().item()


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
        wd = dec.fused_weights(dt)
        ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
        out = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)
        ref = fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw)
        full = fd.fused_greedy_decode_cuda(wd, ckd, cvd, **dict(kw, eos_id=None))
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
    es = lambda: fd.fused_greedy_decode_cuda(wd, ckd, cvd, **kw)  # noqa: E731
    ms = cuda_ms(es, 10)
    full_kw = dict(kw, eos_id=None)
    ms_full = cuda_ms(lambda: fd.fused_greedy_decode_cuda(wd, ckd, cvd, **full_kw), 10)
    plain_ms = cuda_ms(lambda: fd.fused_greedy_decode_plain(wd, ckd, cvd, **kw), 2)
    nbytes, flops = loop_cost(wd, ckd, 1, steps, 2, out.numel() * 4)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    log(f"fused_decode early stop bf16: kernel {ms:.3f} ms (full length {ms_full:.3f} ms), "
        f"plain {plain_ms:.3f} ms, steps per row mean {steps.float().mean().item():.2f} max "
        f"{steps.max().item()}, bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP)")

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
                source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_decode.cu",
                replaces="multimodal_scene_text_recognition_tpu/ops/fused_decode.py:340",
                jax="ops/fused_decode.py::_decode_kernel, eos_id",
                launches=launches, max_abs_err=errs[torch.float32],
                max_abs_err_bf16=errs[torch.bfloat16], ms=ms, ms_full_length=ms_full,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                mean_steps=steps.float().mean().item())


def beam_inputs(model, image):
    """The trained decoder and the per-layer cross K/V of ``image``'s crops."""
    dec = model.decoder
    with torch.no_grad():
        enc = model.encoder(model.features(model.rectify(image)))
        ck, cv = dec.cross_kv(dec.hid_to_emb(enc))
    return dec, ck, cv


def beam_vs_plain(fb, dec, ck, cv, dt, early_stop: bool) -> dict:
    """K4 against its plain version at K=5 in compute type ``dt``: the best
    beams' and all beams' agreement up to their first [s], the largest
    score difference (of all beams and of the best), the steps each row
    took."""
    T = dec.max_text_length
    wd = dec.fused_weights(dt)
    ckd, cvd = ck.to(dt).contiguous(), cv.to(dt).contiguous()
    kw = dict(beam_size=BEAM, num_heads=dec.num_heads, steps=T, go_id=0, eos_id=1, eps=1e-5,
              early_stop=early_stop)
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


# one bf16 rounding of K4 dropped at a time: (name, text in fused_beam.cu,
# replacement), for --mutants
MUTANTS = (
    ("probabilities", "pr[s] = Num<T>::round(pr[s] / sum);", "pr[s] = pr[s] / sum;"),
    ("q*K products", "acc += Num<T>::round(Num<T>::round(qr[d]) * Num<T>::to_f(kr[d]));",
     "acc += Num<T>::round(qr[d]) * Num<T>::to_f(kr[d]);"),
    ("cross-attention value products",
     "acc += Num<T>::round(pr[s] * Num<T>::to_f(V[(size_t)s * E + d]));",
     "acc += pr[s] * Num<T>::to_f(V[(size_t)s * E + d]);"),
    ("ReLU outputs", "Num<T>::round(fmaxf(v, 0.0f))", "fmaxf(v, 0.0f)"),
)


def check_mutants(fb, build, model, image):
    """The bf16 limits of K4 against broken copies of it: each mutant drops
    one bf16 rounding in a copy of the kernel's sources (``fused_beam.cu``
    and the shared header) in a temporary directory; all are built at once
    and each is held against the plain version as the kernel is.  Prints
    what each reads and whether the limits catch it."""
    import ctypes
    import tempfile

    names = ("fused_beam.cu", "decode_common.cuh")
    sources = {n: (build.KERNEL_DIR / n).read_text() for n in names}
    for name, old, _ in MUTANTS:
        if not any(old in text for text in sources.values()):
            raise AssertionError(f"mutant {name}: its text is in no source of the kernel")
    tmp = tempfile.mkdtemp(prefix="k4_mutants_")
    procs = []
    try:
        for i, (_, old, new) in enumerate(MUTANTS):
            os.makedirs(os.path.join(tmp, str(i)))
            for n, text in sources.items():
                with open(os.path.join(tmp, str(i), n), "w") as f:
                    f.write(text.replace(old, new))
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(tmp, f"{i}.so"),
                   os.path.join(tmp, str(i), "fused_beam.cu")]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
        for p in procs:
            if p.wait(timeout=300) != 0:
                raise AssertionError(f"a mutant failed to build: {p.stdout.read()[-2000:]}")
        dec, ck, cv = beam_inputs(model, image)
        real = build.load("fused_beam")
        try:
            for i, (name, _, _) in enumerate(MUTANTS):
                build._loaded["fused_beam"] = ctypes.CDLL(os.path.join(tmp, f"{i}.so"))
                r = beam_vs_plain(fb, dec, ck, cv, torch.bfloat16, early_stop=True)
                log(f"mutant without the bf16 rounding of the {name}: {beam_line(r)}; caught "
                    f"by the limits {not beam_bf16_ok(r)}")
        finally:
            build._loaded["fused_beam"] = real
    finally:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


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
    ms = cuda_ms(lambda: fb.fused_beam_decode_cuda(wd, ckd, cvd, early_stop=True, **kw), 10)
    ms_full = cuda_ms(lambda: fb.fused_beam_decode_cuda(wd, ckd, cvd, **kw), 10)
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
        f"full length; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}; "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), {bound_full:.4f} ms at full length "
        f"({flops_full / 1e9:.1f} GFLOP)")
    r32, r16 = res[torch.float32, True], res[torch.bfloat16, True]
    return dict(name="fused_beam", route="cuda",
                source="multimodal_scene_text_recognition_tpu_torch/kernels/fused_beam.cu",
                replaces="multimodal_scene_text_recognition_tpu/ops/fused_beam.py:69",
                jax="ops/fused_beam.py::_beam_kernel",
                max_abs_err=max(res[torch.float32, e]["err"] for e in (False, True)),
                max_abs_err_bf16=max(res[torch.bfloat16, e]["err"] for e in (False, True)),
                best_beam_agreement_f32=min(res[torch.float32, e]["best"] for e in (False, True)),
                best_beam_agreement_bf16=min(r["best"] for k, r in res.items()
                                             if k[0] == torch.bfloat16),
                all_beam_agreement_bf16=min(r["beams"] for k, r in res.items()
                                            if k[0] == torch.bfloat16),
                ms=ms, ms_full_length=ms_full, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_ms_full_length=bound_full, library_ms=None,
                mean_steps=steps.float().mean().item(), f32_err_best=r32["err_best"],
                bf16_err_best=r16["err_best"])


def stage_times(model, rec, crops, decode, reps: int = 10):
    """Median CUDA-event milliseconds of each stage of one recognize call:
    host preparation and upload, TPS rectification, ResNet-31 features,
    semantics + encoder, decoder (``decode(enc)`` -> ids: cross K/V and the
    decode kernel), strings."""
    names = ["prepare", "rectify", "features", "encoder", "decoder", "decode_strings"]
    samples = {n: [] for n in names}
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        with torch.no_grad():
            ev[0].record()
            image, overlap = rec.prepare(crops, len(crops))
            ev[1].record()
            rect = model.rectify(image)
            ev[2].record()
            cols = model.features(rect)
            ev[3].record()
            model.semantic(overlap)
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
    per kernel name (the largest 12), the wall time of the calls, and the
    share of it with no kernel running (the card's idle share)."""
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
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    bn_ms = {part: sum(v for k, v in per_name.items() if f"bn_bwd_{part}" in k)
             for part in ("partial", "finalize")}
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms, "bn_bwd_reduce_ms": bn_ms,
            "kernels_ms": {k[:80]: v for k, v in top}}


def make_train_batch(n: int, seed: int, chars: str):
    """One batch in the wire format: uint8 crops, label rows of seeded
    random words, overlap ids in [0, 100)."""
    from multimodal_scene_text_recognition_tpu_torch.charset import AttnCodec

    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789")
    words = ["".join(rng.choice(letters, rng.integers(3, 11))) for _ in range(n)]
    text, _ = AttnCodec(chars).encode(words)
    return {"image": np.stack(make_crops(n, seed))[..., None], "text": text,
            "overlap": rng.integers(0, 100, (n, 15)).astype(np.int32)}


def train_run(api, bn, gs, batch, use_kernels: bool, steps: int = TRAIN_STEPS,
              warp_kernel: bool = None):
    """``steps`` steps of the trained flagship (``TrainConfig()`` defaults,
    dropout 0.1) with the kernels or their plain versions (``warp_kernel``
    sets K2 apart); the per-step metrics, the K3 and K2 counts after each
    step, and the (shape, dtype) of each BatchNorm input of the first step."""
    from multimodal_scene_text_recognition_tpu_torch.models.layers import BatchNorm2d

    trainer = api.get_trainer(BUNDLE)
    trainer.model.set_use_kernels(use_kernels)
    if warp_kernel is not None:
        trainer.model.transformation.use_kernels = warp_kernel
    shapes = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: shapes.append(
        (tuple(inp[0].shape), inp[0].dtype))) for m in trainer.model.modules()
        if isinstance(m, BatchNorm2d)]
    bn.bn_bwd_sums_cuda.launches = 0
    gs.grid_sample_cuda.launches = 0
    metrics, counts = [], []
    for _ in range(steps):
        m = trainer(batch)
        metrics.append({k: v.item() for k, v in m.items()})
        counts.append((bn.bn_bwd_sums_cuda.launches, gs.grid_sample_cuda.launches))
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
        f"({prof['idle_share_of_unprofiled_step']:.4f} of the unprofiled step), K3 in the "
        f"step {prof['bn_bwd_reduce_ms']} ms; peak memory {peak_gb:.1f} GB")
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
    totals, bound_by, worst, worst_abs = np.zeros(5), set(), 0.0, 0.0
    for i, ((shape, dtype), n) in enumerate(tally.items()):
        r = bn_check(bn, shape, dtype, 100 + i)
        log(f"  K3 x{n} at " + bn_line(shape, dtype, r))
        bound_by.add(r["bound_by"])
        totals += n * np.array([r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "events_ms")])
        worst, worst_abs = max(worst, r["err"]), max(worst_abs, r["err_abs"])
    nbytes = sum(2 * int(np.prod(s)) * (2 if d == torch.bfloat16 else 4) for s, d in shapes)
    log(f"K3 per train step ({per_step} launches, {nbytes / 1e9:.3f} GB of x and dy), device "
        f"time: kernel {totals[0]:.4f} ms, plain {totals[1]:.4f} ms, library {totals[2]:.4f} ms, "
        f"bound {totals[3]:.4f} ms; kernel by CUDA events {totals[4]:.4f} ms, in the profiled "
        f"step {prof['bn_bwd_reduce_ms']} ms")
    summary = {"batch": B, "steps": TRAIN_STEPS, "loss_kernels": [m["loss"] for m in kmetrics],
               "loss_plain": [m["loss"] for m in pmetrics],
               "grad_norm_kernels": [m["grad_norm"] for m in kmetrics],
               "grad_norm_plain": [m["grad_norm"] for m in pmetrics],
               "rel_loss_diff": loss_diffs, "rel_grad_norm_diff_step1": norm_diff,
               "rel_diff_by_step": diffs, "plain_run_to_run": floor,
               "k3_alone_step1": k3_alone,
               "ms_per_step": ms_step, "crops_per_s": B / ms_step * 1e3,
               "profile": prof, "peak_memory_gb": peak_gb}
    k3 = dict(name="bn_bwd_reduce", route="cuda",
              source="multimodal_scene_text_recognition_tpu_torch/kernels/bn_bwd_reduce.cu",
              replaces="multimodal_scene_text_recognition_tpu/ops/batchnorm.py:41",
              jax="ops/batchnorm.py::_bn_bwd_reduce_kernel",
              launches=kcounts[-1][0], launches_per_step=per_step,
              ms=totals[0], plain_ms=totals[1], library_ms=totals[2], bound_ms=totals[3],
              bound_by="/".join(sorted(bound_by)), per="train step (all 36 launches)",
              ms_events=totals[4], ms_in_profiled_step=sum(prof["bn_bwd_reduce_ms"].values()),
              step_bytes=nbytes, max_abs_err=worst_abs, max_err_of_sum_terms=worst)
    return summary, k3, kcounts[-1][1]


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    from multimodal_scene_text_recognition_tpu_torch import api
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
    from multimodal_scene_text_recognition_tpu_torch.kernels import build
    from multimodal_scene_text_recognition_tpu_torch.ops import batchnorm as bn
    from multimodal_scene_text_recognition_tpu_torch.ops import fused_beam as fb
    from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd
    from multimodal_scene_text_recognition_tpu_torch.ops import grid_sample as gs

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

    phase("bn_bwd_reduce vs plain")
    bn_err, bn_err_abs = check_bn_bwd_reduce(bn)

    phase("load model")
    BEAM_CFG = dataclasses.replace(FLAGSHIP, decode_early_stop=True, decode_beam_fused=True)
    model = api.get_model(BUNDLE)
    rec = Recognizer(model, batch_sizes=(1, 8, 64, B))
    crops = make_crops(B, seed=1234)
    image, overlap = rec.prepare(crops, B)
    model_b = api.get_model(BUNDLE, BEAM_CFG)  # early stop, fused beam
    rec_b = Recognizer(model_b, batch_sizes=(1, 8, 64, B))

    phase("fused_decode vs plain")
    k1 = check_fused_decode(fd, model, image, overlap)

    phase("fused_decode early stop vs plain")
    k1e = check_fused_decode_early_stop(fd, model, rec, rec_b, crops, image)

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
                              lambda enc: model_b.decoder.beam_decode(enc, BEAM)[0])
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

    phase("train bf16")
    torch.cuda.empty_cache()
    train, k3, k2_train = train_phase(api, bn, gs)
    k3["max_abs_err"] = max(k3["max_abs_err"], bn_err_abs)
    k3["max_err_of_sum_terms"] = max(k3["max_err_of_sum_terms"], bn_err)
    k2["launches_train"] = k2_train

    phase("report")
    log(f"done in {time.time() - T0:.1f} s")
    print(json.dumps({"e2e": {"bf16_string_agreement": agree16,
                              "f32_string_agreement": agree32["greedy"],
                              "crops_per_s": crops_s, "ms_per_call": ms_call, "batch": B,
                              "stage_ms": stages, "profile": prof},
                      "e2e_beam": {"beam_size": BEAM, "bf16_string_agreement": agree_b16,
                                   "f32_string_agreement": agree32["beam"],
                                   "beam_vs_greedy_strings": beam_vs_greedy,
                                   "crops_per_s": beam_crops_s, "ms_per_call": ms_beam,
                                   "batch": B, "stage_ms": beam_stages,
                                   "decoder_share": share, "profile": beam_prof},
                      "train": train}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [k1, k1e, k2, k3, k4]}), flush=True)
    timer.cancel()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
