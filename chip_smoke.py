#!/usr/bin/env python3
"""Chip check of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from source, holds each against its plain
PyTorch version on the card, serves the trained flagship recognizer through
``api.get_model`` -> ``Recognizer`` at B=192, and checks that the served run
went through both kernels, with where the time of one served call goes
(stage times and the card's idle share).  Every phase prints one flushed line with the
elapsed seconds; any failure raises and the script exits non-zero.  A
watchdog turns a hang into a printed failure (exit code 3).

Output: per-phase lines, the ``nvidia-smi`` name/power-limit line, one JSON
line ``{"kernels": [...]}`` before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs no network and nothing outside the repository; imports no JAX.
"""

from __future__ import annotations

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
    ms = cuda_ms(lambda: gs.grid_sample_cuda(img, grid), 200, warmup=5)
    plain_ms = cuda_ms(lambda: gs.grid_sample_plain(img, grid), 10)
    library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="border", align_corners=True), 200, warmup=5)
    N = H * W
    bound_ms, bound_by = bound(B * (H * W + 3 * N) * 4, B * N * 20, PEAK_F32_FLOPS)
    log(f"grid_sample: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"F.grid_sample {library_ms:.4f} ms (max |diff| {lib_err:.2e}), "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return dict(name="grid_sample", route="cuda",
                source="multimodal_scene_text_recognition_tpu_torch/kernels/grid_sample.cu",
                replaces="multimodal_scene_text_recognition_tpu/ops/grid_sample.py:105",
                jax="ops/grid_sample.py::_grid_sample_kernel",
                max_abs_err=err, max_abs_err_f32=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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


def stage_times(model, rec, crops, reps: int = 10):
    """Median CUDA-event milliseconds of each stage of one recognize call:
    host preparation and upload, TPS rectification, ResNet-31 features,
    semantics + encoder, decoder (cross K/V and K1), argmax + strings."""
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
            logits = model.decoder.greedy_decode(enc)
            ev[5].record()
            rec.codec.decode(logits.argmax(-1).cpu().numpy())
            ev[6].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(v[1:]) for n, v in samples.items()}


def kernel_profile(rec, crops, calls: int = 3):
    """``torch.profiler`` over ``calls`` warm recognize calls: device time
    per kernel name (the largest 12), the wall time of the calls, and the
    share of it with no kernel running (the card's idle share)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            rec.recognize(crops)
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
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "kernels_ms": {k[:80]: v for k, v in top}}


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

    phase("load model")
    model = api.get_model(BUNDLE)
    rec = Recognizer(model, batch_sizes=(1, 8, 64, B))
    crops = make_crops(B, seed=1234)
    image, overlap = rec.prepare(crops, B)

    phase("fused_decode vs plain")
    k1 = check_fused_decode(fd, model, image, overlap)

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
    stages = stage_times(model, rec, crops)
    log("stage ms (median of 10): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    prof = kernel_profile(rec, crops)
    if prof["device_busy_ms"] <= 0:
        raise AssertionError("the profiler saw no kernel run on the card")
    log(f"profile of {prof['calls']} calls: wall {prof['wall_ms']:.2f} ms, kernels busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.4f}")

    phase("end-to-end f32")
    del model, rec
    model32 = api.get_model(BUNDLE, dataclasses.replace(FLAGSHIP, compute_dtype="float32"))
    rec32 = Recognizer(model32, batch_sizes=(B,))
    texts32 = rec32.recognize(crops)
    model32.set_use_kernels(False)
    plain32 = rec32.recognize(crops)
    agree32 = sum(a == b for a, b in zip(texts32, plain32)) / B
    log(f"f32 strings, kernels vs plain versions: {agree32:.4f} identical (limit 1.0); "
        f"bf16 vs f32 serving: {sum(a == b for a, b in zip(texts, texts32)) / B:.4f}")
    if agree32 != 1.0:
        raise AssertionError(f"f32 end-to-end agreement {agree32} < 1")

    phase("report")
    log(f"done in {time.time() - T0:.1f} s")
    print(json.dumps({"e2e": {"bf16_string_agreement": agree16,
                              "f32_string_agreement": agree32,
                              "crops_per_s": crops_s, "ms_per_call": ms_call, "batch": B,
                              "stage_ms": stages, "profile": prof}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    timer.cancel()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
