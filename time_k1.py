"""Time K1, the float greedy decode kernel, K1q, the int8 one, K4, the
beam-search kernel, P1 and P2, the probe's chain kernels, and the BatchNorm
backward and K2, the warp, of a checkout of this repository on the card, so
that two checkouts can be compared on one card, in turns.

    python3 time_k1.py [--repo DIR] [--probe-only | --bn-only]

It imports the port from DIR (default: this checkout), whose kernels build
in DIR's ``kernels/_build``, and takes the rest from this checkout's
``chip_smoke.py``: the trained flagship (``BUNDLE``), the seeded B=192
crops it serves, the cross K/V its encoder makes of them, ``k1_times``
(bf16 at B=192 at full length and with early stop, and at B=1) and
``k1q_times`` (the int8 decoder's tables, likewise; ``int8`` below) and
``k4_times`` (bf16, K=5, at B=192 with early stop and at full length, and at
B=1).  A checkout whose decoder keeps no int8 units times its K1q as its
served path calls it.  P1 and P2 (``ops/gemm_probe``) are timed on the
probe's inputs (``probe_inputs(0)``) at 0, 30 and 200 steps, CUDA events
over 1 warm + 10 calls (``probe_ms``); ``--probe-only`` times them alone
and adds the widest F each launches at, by B (``probe_capacity``).
``--bn-only`` times the checkout's BatchNorm backward as a train step runs
it (``torch.autograd.grad`` of its ``bn_train`` on bf16 channels-last
inputs: K3 and whatever else its backward launches) at each of the step's
36 shapes (``chip_smoke.TRAIN_BN_SHAPES``), summed a step, warm and on a
cold L2 (``bn_step_ms``), and K2 on ``chip_smoke.grid_sample_inputs``
(``k2_ms``), both the median of single calls timed by
``chip_smoke.queued_ms`` (a host stall longer than its spin kernel moves one
call, not the sum); it needs no bundle.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

import chip_smoke  # this checkout's, imported before DIR goes first on the path


def probe_times(gp) -> dict:
    """ms of P1 and P2 at 0, 30 and the probe's 200 steps."""
    x, wq, ws, wbf = gp.probe_inputs(0)
    calls = {"p1": lambda n: gp.int8_chain_cuda(x, wq, ws, n),
             "p2": lambda n: gp.bf16_chain_cuda(x, wbf, n)}
    return {k: {n: chip_smoke.cuda_ms(lambda: f(n), 10) for n in (0, 30, gp.ITERS)}
            for k, f in calls.items()}


def median_ms(fn, reps: int, cold: bool = False) -> float:
    """The median of ``reps`` single calls of ``fn``, each by
    ``chip_smoke.queued_ms``."""
    return statistics.median(chip_smoke.queued_ms(fn, 1, cold=cold) for _ in range(reps))


def bn_step_ms(bnmod) -> dict:
    """ms of the BatchNorm backward of ``bnmod`` (a checkout's
    ``ops/batchnorm``) at each of the train step's shapes, warm and cold,
    and summed over the step's 36 launches."""
    import torch

    by_shape, warm, cold = {}, 0.0, 0.0
    for i, (shape, count) in enumerate(chip_smoke.TRAIN_BN_SHAPES.items()):
        x, dy, _, _, w = chip_smoke.bn_inputs(shape, torch.bfloat16, 200 + i)
        x.requires_grad_()
        w.requires_grad_()
        b = torch.zeros_like(w, requires_grad=True)
        y = bnmod.bn_train(x, w, b)[0]

        def backward():
            return torch.autograd.grad(y, (x, w, b), dy, retain_graph=True)

        t = (median_ms(backward, 9), median_ms(backward, 7, cold=True))
        by_shape[str(list(shape))] = t
        warm += count * t[0]
        cold += count * t[1]
        del x, dy, w, b, y
        torch.cuda.empty_cache()
    return {"warm": warm, "cold": cold, "by_shape": by_shape}


# the batches at which probe_capacity finds the widest F each kernel serves
PROBE_CAPACITY_B = tuple(range(32, 513, 32))


def probe_capacity(gp, f_max: int = 8192) -> dict:
    """The largest F (a multiple of 128 from 256 to ``f_max``) at which each
    chain kernel of ``gp`` launches, at each B of PROBE_CAPACITY_B, by
    0-step calls on zeros (0 where it serves no F); a refusal (ValueError,
    or RuntimeError from the launch) counts as not served.  More columns
    never take fewer CTAs, so the served F at a B are a prefix."""
    import torch

    found = {}
    for name in ("p1", "p2"):
        found[name] = {}
        for b in PROBE_CAPACITY_B:
            x = torch.zeros(b, gp.E, device="cuda")

            def serves(f):
                try:
                    if name == "p1":
                        gp.int8_chain_cuda(x, torch.zeros(gp.E, f, dtype=torch.int8, device="cuda"),
                                           torch.ones(1, f, device="cuda"), 0)
                    else:
                        gp.bf16_chain_cuda(x, torch.zeros(gp.E, f, dtype=torch.bfloat16,
                                                          device="cuda"), 0)
                    return True
                except (ValueError, RuntimeError):
                    return False

            lo, hi = 1, f_max // 128  # 128 lo is served (or lo == 1), 128 (hi + 1) is not
            if not serves(256):
                hi = 1
            else:
                lo = 2
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    lo, hi = (mid, hi) if serves(128 * mid) else (lo, mid - 1)
            found[name][b] = 128 * lo if lo > 1 else 0
    torch.cuda.synchronize()
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose kernels are timed")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--probe-only", action="store_true", help="time P1 and P2 alone")
    only.add_argument("--bn-only", action="store_true",
                      help="time the BatchNorm backward and K2 alone")
    args = ap.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_k1: no CUDA device; the kernels run only on the card")
    from multimodal_scene_text_recognition_tpu_torch import api
    from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
    from multimodal_scene_text_recognition_tpu_torch.eval.serve import Recognizer
    from multimodal_scene_text_recognition_tpu_torch.ops import fused_beam as fb
    from multimodal_scene_text_recognition_tpu_torch.ops import fused_decode as fd
    from multimodal_scene_text_recognition_tpu_torch.ops import batchnorm as bnmod
    from multimodal_scene_text_recognition_tpu_torch.ops import gemm_probe as gp
    from multimodal_scene_text_recognition_tpu_torch.ops import grid_sample as gs

    for mod in (fd, fb, gp, bnmod, gs):
        if not os.path.abspath(mod.__file__).startswith(repo + os.sep):
            raise SystemExit(f"time_k1: imported {mod.__file__}, not the port of {repo}")
    card = chip_smoke.card_line()
    if args.bn_only:
        img, grid = chip_smoke.grid_sample_inputs()
        k2 = median_ms(lambda: gs.grid_sample_cuda(img, grid), 21)
        print(card, flush=True)
        print(json.dumps({"repo": repo, "card": card, "bn_step_ms": bn_step_ms(bnmod),
                          "k2_ms": k2}), flush=True)
        return 0
    probe = probe_times(gp)
    if args.probe_only:
        print(card, flush=True)
        print(json.dumps({"repo": repo, "card": card, "probe_ms": probe,
                          "probe_widest_f": probe_capacity(gp)}), flush=True)
        return 0
    B = chip_smoke.B
    model = api.get_model(chip_smoke.BUNDLE)
    int8 = api.get_model(chip_smoke.BUNDLE, dataclasses.replace(
        FLAGSHIP, decode_early_stop=True, decode_int8=True)).decoder
    image = Recognizer(model, batch_sizes=(B,)).prepare(chip_smoke.make_crops(B, seed=1234), B)[0]
    dec, ck, cv = chip_smoke.beam_inputs(model, image)
    # a checkout whose K1 reads repacked tables takes them, as its served path does
    kw = {"packed": dec.cluster_tables(torch.bfloat16)} if hasattr(dec, "cluster_tables") else {}
    times = chip_smoke.k1_times(fd, dec, ck, cv, **kw)
    k1q = chip_smoke.k1q_times(fd, int8, ck, cv)
    k4 = chip_smoke.k4_times(fb, dec, ck, cv)
    print(card, flush=True)
    print(json.dumps({"repo": repo, "card": card, "batch": B, "k1_bf16_ms": times,
                      "k1q_bf16_ms": k1q, "k4_bf16_ms": k4, "probe_ms": probe}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
