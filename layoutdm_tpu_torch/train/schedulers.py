"""Epoch-level LR schedules driven from host, matching `helpers/scheduler.py`.

The reference steps torch schedulers once per epoch (`main.py:112-118`).
Here each scheduler is a tiny stateful host object producing the next LR,
which the loop writes into the optimizer's injected hyperparams
(`train.step.set_learning_rate`).
"""

from __future__ import annotations

import math
from typing import Optional


class VoidScheduler:
    """(`scheduler.py:12-23`) — constant LR."""

    def __init__(self, base_lr: float, **kw):
        self.lr = base_lr

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        return self.lr


class D3PMScheduler:
    """1/sqrt decay after 10 warmup epochs (`scheduler.py:12-23`).

    The reference wraps `_d3pm_func` in torch's LambdaLR, whose k-th
    post-epoch step yields ``init_lr * f(k + 1)`` — matched here with our
    0-based post-epoch calling convention."""

    def __init__(self, base_lr: float, **kw):
        self.base_lr = base_lr

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        e = epoch + 1  # the reference's 1-based post-epoch counter
        if e <= 10:
            return self.base_lr
        return self.base_lr / math.sqrt(e - 10)


class ReduceLROnPlateauWithWarmup:
    """(`scheduler.py:50-273`): additive linear warmup from the optimizer's
    base LR toward ``warmup_lr`` (the reference's `_increase_lr`, fed by
    `config/scheduler/reduce_lr_on_plateau_with_warmup.yaml`: lr 1e-4 ->
    warmup_lr 5e-4 over 5 epochs), then multiply by ``factor`` after
    ``patience`` epochs without rel-threshold val-loss improvement; LR
    writes smaller than ``eps`` are ignored (`scheduler.py:204-214`)."""

    def __init__(
        self,
        base_lr: float,
        warmup_epochs: int = 0,
        warmup_lr: Optional[float] = None,
        factor: float = 0.5,
        patience: int = 2,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
        eps: float = 1e-8,
        **kw,
    ):
        self.base_lr = base_lr
        self.warmup = warmup_epochs
        self.warmup_lr = base_lr if warmup_lr is None else warmup_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.eps = eps
        self.best = float("inf")
        self.num_bad = 0
        self.lr = base_lr

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        if self.warmup and epoch < self.warmup:
            # cumulative additive ramp (`scheduler.py:216-226`)
            step = max(0.0, (self.warmup_lr - self.base_lr) / self.warmup)
            self.lr = max(self.lr + step, self.min_lr)
            return self.lr
        if val_loss is None:
            return self.lr
        if val_loss < self.best * (1 - self.threshold):
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                new_lr = max(self.lr * self.factor, self.min_lr)
                if self.lr - new_lr > self.eps:  # `scheduler.py:208`
                    self.lr = new_lr
                self.num_bad = 0
        return self.lr


class CosineAnnealingLRWithWarmup:
    """(`scheduler.py:276-383`): additive warmup toward ``warmup_lr``
    (tracking the reached peak), then ``peak * 0.5*(1+cos(pi*progress))``
    clamped at ``min_lr``.

    Epoch counter quirk mirrored exactly: the reference inits
    ``last_epoch=-1`` (unlike its plateau scheduler's 0), so warmup spans
    ``warmup + 1`` step calls and the peak OVERSHOOTS ``warmup_lr`` by one
    increment — trace-parity-tested against the reference's own module.

    Deliberate deviation: with ``warmup == 0`` the reference constructor
    crashes (warmup_lr_steps from a None warmup_lrs); here the peak defaults
    to ``base_lr`` so a warmup-free cosine anneals from the base LR.
    """

    def __init__(
        self,
        base_lr: float,
        total_epochs: int = 50,
        warmup_epochs: int = 0,
        warmup_lr: Optional[float] = None,
        min_lr: float = 0.0,
        **kw,
    ):
        self.base_lr = base_lr
        self.total = total_epochs
        self.warmup = warmup_epochs
        self.warmup_lr = base_lr if warmup_lr is None else warmup_lr
        self.min_lr = min_lr
        self.lr = base_lr
        self.peak = base_lr

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        # the k-th call sees the reference's epoch = k (last_epoch=-1 + 1)
        if self.warmup and epoch <= self.warmup:
            step = max(0.0, (self.warmup_lr - self.base_lr) / self.warmup)
            self.lr = self.lr + step
            self.peak = max(self.peak, self.lr)
            return self.lr
        # no clamp on progress, like the reference: stepping past
        # total_epochs re-raises the LR (cosine periodicity) — the training
        # loop never steps beyond cfg.training.epochs, same as the reference
        progress = (epoch - self.warmup) / max(1, self.total - self.warmup)
        factor = max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))
        self.lr = max(self.peak * factor, self.min_lr)
        return self.lr


SCHEDULERS = {
    "void": VoidScheduler,
    "d3pm": D3PMScheduler,
    "reduce_lr_on_plateau": ReduceLROnPlateauWithWarmup,
    "cosine": CosineAnnealingLRWithWarmup,
}


def build_scheduler(name: str, base_lr: float, **kw):
    return SCHEDULERS[name](base_lr, **kw)


def scheduler_state(sched) -> dict:
    """Serializable host state for preemption resume (schedulers are tiny
    host objects; without this, resume restarts the LR at base — a warm
    restart that silently changes training dynamics)."""
    keys = ("best", "num_bad", "lr", "peak")
    return {k: getattr(sched, k) for k in keys if hasattr(sched, k)}


def restore_scheduler_state(sched, state: dict) -> None:
    for k, v in (state or {}).items():
        if hasattr(sched, k):
            setattr(sched, k, v)
