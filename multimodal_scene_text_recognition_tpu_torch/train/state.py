"""Optimiser of the train step: AdamW after a global-norm clip, with a
linear warmup and StepLR schedule, to optax's semantics (JAX counterpart:
train/state.py, ``optax.chain(clip_by_global_norm, adamw)``)."""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch

from ..config import TrainConfig

Schedule = Callable[[int], float]


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int = 1) -> Schedule:
    """Learning rate at an update's 0-based count, as optax evaluates it
    (so a run with warmup takes lr 0 on its first step).

    StepLR: ``lr * lr_gamma ** k`` after ``k`` boundaries, one every
    ``lr_step_size * steps_per_epoch`` steps, at most 100 (the JAX package
    lists 100).  Warmup: ``lr * count / warmup_steps`` for the first
    ``warmup_steps`` counts; the StepLR boundaries are counted after it
    (``optax.join_schedules`` re-bases the step)."""

    def base(count: int) -> float:
        if not cfg.lr_step_size:
            return cfg.lr
        return cfg.lr * cfg.lr_gamma ** min(100, count // (cfg.lr_step_size * steps_per_epoch))

    if cfg.warmup_steps <= 0:
        return base

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return cfg.lr * count / cfg.warmup_steps
        return base(count - cfg.warmup_steps)

    return schedule


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay))`` over ``params``, updated in place from their ``.grad``.

    * clip: ``g * clip_norm / |g|`` where the global norm ``|g| >= clip_norm``
      (no epsilon added to the norm, unlike ``clip_grad_norm_``);
    * Adam with b1 0.9, b2 0.999, bias correction, eps outside the square
      root; decoupled weight decay ``weight_decay * p`` on every parameter;
    * the step is ``-lr(count) * update`` with ``count`` before the update.

    A parameter with no gradient counts as a zero gradient: its moments
    decay and weight decay still applies, as in optax.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 weight_decay: float, clip_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update; returns the global gradient norm before the
        clip (a 0-dim tensor on the parameters' device, not synchronised)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        grads = torch._foreach_mul(grads, scale)

        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        update = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        return norm


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                   steps_per_epoch: int = 1) -> AdamW:
    return AdamW(params, make_lr_schedule(cfg, steps_per_epoch),
                 weight_decay=cfg.weight_decay, clip_norm=cfg.grad_clip_norm)
