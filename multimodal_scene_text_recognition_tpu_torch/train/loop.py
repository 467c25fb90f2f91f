"""Training loop: a number of train steps over an iterable of batches, with
running averages of loss and accuracy (JAX counterpart: train/loop.py,
without validation, the CSV log and checkpoints, which are not ported)."""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch

from .steps import TrainStep


def train(step: TrainStep, batches: Iterable[Mapping[str, Any]], num_steps: int,
          log_every: int = 50) -> Dict[str, Any]:
    """Run ``num_steps`` steps over ``batches`` (raises if it runs out).

    The metrics stay on the device between logs and are fetched in one
    transfer every ``log_every`` steps and at the end, where a line with the
    running averages and the crops/s since the last log is printed.
    Returns the running averages ``loss`` and ``token_acc`` over the run and
    the per-step metrics ``history`` (a list of float dicts)."""
    history: List[Dict[str, float]] = []
    pending: List[Dict[str, torch.Tensor]] = []
    it = iter(batches)
    crops, t_last = 0, time.perf_counter()
    for i in range(num_steps):
        try:
            batch = next(it)
        except StopIteration:
            raise ValueError(f"train: the batches ran out after {i} of {num_steps} steps")
        pending.append(step(batch))
        crops += len(batch["text"])
        if (i + 1) % log_every and i + 1 != num_steps:
            continue
        keys = list(pending[0])
        rows = torch.stack([torch.stack([m[k].float() for k in keys]) for m in pending])
        history.extend(dict(zip(keys, row)) for row in rows.tolist())
        pending = []
        now = time.perf_counter()
        print(f"    iter {i + 1}: loss {np.mean([h['loss'] for h in history]):.4f} "
              f"token_acc {np.mean([h['token_acc'] for h in history]):.3f} "
              f"({crops / (now - t_last):.0f} crops/s)", flush=True)
        crops, t_last = 0, now
    return {"loss": float(np.mean([h["loss"] for h in history])),
            "token_acc": float(np.mean([h["token_acc"] for h in history])),
            "history": history}
