"""Training loop: epochs over a dataset with validation, the CSV log and
best-model checkpoints, and a bare step runner (JAX counterpart:
train/loop.py).

:func:`train` is the JAX ``train``: a validation pass before training
(logged as iter 0), shuffled epochs, running loss and token-accuracy
averages fetched from the device once per log or validation window,
validation whenever the step count reaches the next multiple of
``validation_steps``, a CSV row and a checkpoint on each new best (gated
by ``model_save_threshold``), and a stop at ``iteration_limit``.  A
resumed trainer (``train.checkpoint.restore_checkpoint``) continues from
its restored step count.  :func:`run_steps` takes a number of steps over
ready batches, with no validation, log or checkpoint."""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch

from ..charset import AttnCodec, CTCCodec
from ..config import Config, check_single_process
from ..data.lmdb_data import BalancedMixture
from ..data.pipeline import (DEVICE_KEYS, Batcher, PackedSamples, Prefetcher, device_batch,
                             packed_batches, pinned)
from ..eval.evaluate import validate
from ..metrics import Averager
from .checkpoint import save_checkpoint
from .steps import TrainStep, make_eval_step


class CSVLog:
    """Append-only training log with the columns iter, cost_avg, val_acc
    and train_acc ("n/a" where a row has no value)."""

    COLUMNS = ["iter", "cost_avg", "val_acc", "train_acc"]

    def __init__(self, path: str):
        self.path = path
        self.rows: List[Dict] = []
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._has_header = os.path.exists(path) and os.path.getsize(path) > 0

    def append(self, **row) -> None:
        r = {c: row.get(c, "n/a") for c in self.COLUMNS}
        self.rows.append(r)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.COLUMNS)
            if not self._has_header:
                w.writeheader()
                self._has_header = True
            w.writerow(r)


def _fetch(pending: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """The per-step metric tensors of a window in one transfer."""
    keys = list(pending[0])
    rows = torch.stack([torch.stack([m[k].float() for k in keys]) for m in pending])
    return [dict(zip(keys, row)) for row in rows.tolist()]


def build_codec(cfg: Config):
    """The label codec of the configured recipe: ``CTCCodec`` for the CTC
    one (``train.loss="ctc"``, ``model.label_codec="ctc"`` and
    ``model.decoder="linear"``, all three), else ``AttnCodec``; a ValueError
    for a CTC recipe that lacks one of them."""
    if cfg.train.loss == "ctc" or cfg.model.label_codec == "ctc":
        if cfg.train.loss != "ctc" or cfg.model.label_codec != "ctc":
            raise ValueError(
                "CTC training needs BOTH train.loss=ctc and model.label_codec=ctc (got "
                f"loss={cfg.train.loss!r}, codec={cfg.model.label_codec!r})")
        if cfg.model.decoder != "linear":
            raise ValueError("train.loss=ctc requires model.decoder=linear (per-column "
                             f"logits); got {cfg.model.decoder!r}")
        return CTCCodec(cfg.model.chars, cfg.model.max_text_length)
    return AttnCodec(cfg.model.chars, cfg.model.max_text_length)


def train(cfg: Config, step: TrainStep, train_samples, val_samples, log_every: int = 50,
          verbose: bool = True) -> TrainStep:
    """Train ``step`` (a :class:`TrainStep`, whose optimizer takes
    ``cfg.train``'s settings and StepLR boundaries of ``len(train_samples)
    // batch_size`` steps) on ``train_samples`` and validate greedily on
    ``val_samples`` (sample sequences or :class:`PackedSamples`, whose label
    rows must be in the recipe's codec, :func:`build_codec`), on the step's
    device; validation decodes in that codec (a CTC model's columns by the
    best-path collapse).  Writes ``<results_dir>/<experiment>_training_log.csv``
    and, on each new best, the full state into
    ``<results_dir>/models/<experiment>``.  Returns ``step``.

    Batch order, as in the JAX loop:

    * device data (``cfg.train.device_data`` and the packed set at most
      ``device_data_max_mb``): the set is copied to the device once; epoch
      e takes ``default_rng(seed + e).permutation(n)``, cut to whole
      batches and to the steps left before ``iteration_limit``, in blocks
      of ``steps_per_call`` batches gathered on the device by index.  JAX
      runs a block as one jitted ``lax.scan``; that grouping has no eager
      counterpart, so the block's steps run one after another here, and the
      log, validation and limit checks fall at the block's end, as in JAX;
    * host data: ``packed_batches(shuffle=True, seed=seed + e)``, collated
      and pinned in a :class:`Prefetcher`'s thread, each batch copied to
      the device on the loop's stream; the checks follow every step;
    * a :class:`~..data.lmdb_data.BalancedMixture` (``train_samples``) is a
      stream of batches, not a set: it is never packed, and each epoch of
      ``sum(len(source)) // batch_size`` steps collates its next batches in
      the prefetcher's thread, as host data.
    """
    check_single_process(cfg)
    tc = cfg.train
    codec = build_codec(cfg)
    device = step.device
    mixture = isinstance(train_samples, BalancedMixture)
    n_train = (sum(len(s) for s in train_samples.sources) if mixture
               else len(train_samples))
    steps_per_epoch = max(n_train // tc.batch_size, 1)
    step.configure(tc, steps_per_epoch)
    packed_train = None if mixture else PackedSamples.from_samples(train_samples, codec)
    packed_val = PackedSamples.from_samples(val_samples, codec)

    use_device_data = (not mixture and tc.device_data
                       and packed_train.nbytes() <= tc.device_data_max_mb * 2 ** 20)
    if use_device_data:
        data_dev = {k: torch.from_numpy(np.ascontiguousarray(getattr(packed_train, k))).to(device)
                    for k in DEVICE_KEYS}
    eval_step = make_eval_step(step.model)

    def run_validation() -> float:
        val_iter = packed_batches(packed_val, tc.batch_size, shuffle=False, drop_last=False,
                                  seed=tc.seed)
        return validate(eval_step, val_iter, codec, print_samples=verbose).accuracy

    if verbose:
        n_params = sum(p.numel() for p in step.model.parameters())
        print(f"--- Training for {tc.epochs} epochs. Number of parameters: {n_params}")
    log = CSVLog(os.path.join(cfg.results_dir, f"{cfg.experiment}_training_log.csv"))

    val_acc = run_validation()
    log.append(iter=0, cost_avg="n/a", val_acc=val_acc, train_acc="n/a")
    if verbose:
        print(f"  - initial val acc: {val_acc}%", flush=True)

    best_accuracy = tc.model_save_threshold
    loss_avg, acc_avg = Averager(), Averager()
    iteration = step.step_count
    stop = False
    for epoch in range(tc.epochs):
        if stop:
            break
        if verbose:
            print(f"  - Epoch: {epoch + 1}", flush=True)
        if use_device_data:
            B = tc.batch_size
            n_steps = n_train // B
            K = max(1, min(tc.steps_per_call, n_steps))
            n_avail = n_steps
            if tc.iteration_limit:
                n_avail = min(n_steps, max(tc.iteration_limit - iteration, 0))
            order = np.random.default_rng(tc.seed + epoch).permutation(n_train)
            flat = torch.from_numpy(order[: n_avail * B].reshape(-1, B)).to(device)
            epoch_iter = (flat[i: i + K] for i in range(0, len(flat), K))
        else:
            if mixture:
                batcher = Batcher(codec, tc.batch_size)
                host = (batcher.collate(train_samples.next_batch())
                        for _ in range(steps_per_epoch))
            else:
                host = packed_batches(packed_train, tc.batch_size, shuffle=True,
                                      seed=tc.seed + epoch)
            epoch_iter = Prefetcher((pinned(b) if device.type == "cuda" else b for b in host),
                                    depth=4)
        t_last, iter_last = time.perf_counter(), iteration
        pending: List[Dict[str, torch.Tensor]] = []
        next_log = (iteration // log_every + 1) * log_every
        next_val = (iteration // tc.validation_steps + 1) * tc.validation_steps
        # closed on every exit, a failing step's too: the prefetcher's thread
        # ends and drops the pinned batches it holds
        with contextlib.closing(epoch_iter):
            for item in epoch_iter:
                if use_device_data:
                    for idx in item:  # one block: its steps in order
                        pending.append(step({k: v[idx] for k, v in data_dev.items()}))
                    iteration += int(item.shape[0])
                else:
                    pending.append(step(device_batch(item, device)))
                    iteration += 1

                hit_log = iteration >= next_log
                hit_val = iteration >= next_val
                if hit_log or hit_val:
                    for m in _fetch(pending):
                        loss_avg.add(m["loss"])
                        acc_avg.add(m["token_acc"])
                    pending = []
                if hit_log:
                    next_log = (iteration // log_every + 1) * log_every
                    if verbose:
                        dt = (time.perf_counter() - t_last) / max(iteration - iter_last, 1)
                        t_last, iter_last = time.perf_counter(), iteration
                        print(f"    iter {iteration}: loss {loss_avg.val():.4f} "
                              f"token_acc {acc_avg.val():.3f} ({tc.batch_size / dt:.0f} crops/s)",
                              flush=True)

                if hit_val:
                    next_val = (iteration // tc.validation_steps + 1) * tc.validation_steps
                    val_acc = run_validation()
                    if verbose:
                        print(f"  - iter {iteration}: {val_acc}% | Best: {best_accuracy}%",
                              flush=True)
                    if val_acc > best_accuracy:
                        best_accuracy = val_acc
                        log.append(iter=iteration, cost_avg=loss_avg.val(), val_acc=val_acc,
                                   train_acc=acc_avg.val())
                        save_checkpoint(os.path.join(cfg.results_dir, "models", cfg.experiment),
                                        step)
                        if verbose:
                            print("  - New best model saved")
                        loss_avg.reset()
                        acc_avg.reset()

                if tc.iteration_limit and iteration >= tc.iteration_limit:
                    if verbose:
                        print(f"--- Iteration limit reached: {iteration}")
                    stop = True
                    break
    if verbose:
        print("--- Finished Training")
    return step


def run_steps(step: TrainStep, batches: Iterable[Mapping[str, Any]], num_steps: int,
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
            raise ValueError(f"run_steps: the batches ran out after {i} of {num_steps} steps")
        pending.append(step(batch))
        crops += len(batch["text"])
        if (i + 1) % log_every and i + 1 != num_steps:
            continue
        history.extend(_fetch(pending))
        pending = []
        now = time.perf_counter()
        print(f"    iter {i + 1}: loss {np.mean([h['loss'] for h in history]):.4f} "
              f"token_acc {np.mean([h['token_acc'] for h in history]):.3f} "
              f"({crops / (now - t_last):.0f} crops/s)", flush=True)
        crops, t_last = 0, now
    return {"loss": float(np.mean([h["loss"] for h in history])),
            "token_acc": float(np.mean([h["token_acc"] for h in history])),
            "history": history}
