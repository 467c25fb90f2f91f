"""Slope timing (JAX counterpart: utils/timing.py): the time of one
iteration of a loop body as the slope between two trip counts, so that a
fixed cost per call (the host's launch of the first kernels, a sync)
cancels.  On the card each run is timed by CUDA events; on the CPU by
``time.perf_counter`` around a run whose result is brought to the host."""

from __future__ import annotations

import time
from typing import Any, Callable, Mapping

import numpy as np
import torch


def _seconds(f: Callable[[], Any], device: str) -> float:
    if device == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = f()
    if isinstance(out, torch.Tensor):
        out.cpu()
    return time.perf_counter() - t0


def slope_ms(make_fn: Callable[[int], Callable], k1: int, k2: int, reps: int = 3,
             pairs: int = 5, retries: int = 2, device: str = "cuda") -> "float | None":
    """ms per loop iteration from the two-trip-count slope, as JAX's:
    ``make_fn(k)`` returns a zero-argument callable running the body k
    times.  The estimate is the median of ``pairs`` interleaved (t1, t2)
    pair slopes, each time the best of ``reps``; where fewer than half the
    pairs come out increasing, the pairs are timed again with twice the
    reps, up to ``retries`` times, and then None is returned rather than a
    rate that is no measurement.  ``device``: "cuda" (CUDA events) or
    "cpu"."""
    f1, f2 = make_fn(k1), make_fn(k2)
    _seconds(f1, device)  # warm-up: builds and first launches
    _seconds(f2, device)

    def best(f, r):
        return min(_seconds(f, device) for _ in range(r))

    r = reps
    for _ in range(retries + 1):
        slopes = []
        for _ in range(pairs):
            t1, t2 = best(f1, r), best(f2, r)
            if t2 > t1:
                slopes.append((t2 - t1) / (k2 - k1))
        if len(slopes) >= (pairs + 1) // 2:
            return float(np.median(slopes)) * 1e3
        r *= 2
    return None


def roundrobin(step_out: Callable, stacked: Mapping[str, torch.Tensor], n_batches: int,
               consts=()) -> Callable[[int], Callable]:
    """A ``make_fn`` for :func:`slope_ms` over varied real batches: the
    loop takes batch ``i % n_batches`` of ``stacked`` (tensors [n_batches,
    ...], on the device) and adds the float32 sum of ``step_out(batch,
    *consts)`` to an accumulator, which the run returns (the dependence
    that keeps every iteration's work)."""

    def make_fn(k: int) -> Callable[[], torch.Tensor]:
        def run() -> torch.Tensor:
            acc = torch.zeros((), dtype=torch.float32,
                              device=next(iter(stacked.values())).device)
            for i in range(k):
                batch = {key: v[i % n_batches] for key, v in stacked.items()}
                acc = acc + step_out(batch, *consts).sum().float()
            return acc

        return run

    return make_fn
