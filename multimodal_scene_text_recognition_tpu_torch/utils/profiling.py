"""Step timing and trace regions (JAX counterpart: utils/profiling.py).

  * :class:`StepTimer`: wall time between ticks and the throughput, with
    running percentiles, the same ``stats()`` as JAX's;
  * :func:`trace`: ``torch.profiler`` over the block (the card's kernels
    where there is one), its Chrome trace written under a directory;
  * :func:`annotate`: a named region in that trace (``record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


class StepTimer:
    """Seconds between consecutive :meth:`tick` calls, the last ``window``
    of them.  A tick does not wait for the card: tick after something that
    does (a ``.item()``, a synchronise) for the card's time."""

    def __init__(self, batch_size: int, window: int = 200):
        self.batch_size = batch_size
        self.window = window
        self.times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        """``step_ms_p50``, ``step_ms_p90`` and ``crops_per_sec`` (at the
        median step); empty before the second tick."""
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "step_ms_p50": float(np.median(t)) * 1e3,
            "step_ms_p90": float(np.percentile(t, 90)) * 1e3,
            "crops_per_sec": self.batch_size / float(np.median(t)),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write its Chrome trace to ``logdir/trace.json``;
    yields the profiler (its ``key_averages()`` for kernel sums)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the host's work in :func:`trace`'s timeline."""
    with torch.profiler.record_function(name):
        yield
