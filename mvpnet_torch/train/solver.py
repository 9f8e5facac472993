"""Optimizer and learning-rate schedule factories.

Counterpart of ``mvpnet_tpu/train/solver.py`` (optax): Adam, AdamW or SGD
with momentum from ``SolverConfig``; step (staircase), multistep, cosine or
constant schedules; the ``clip_lr`` floor; multiplicative warmup; and
global-norm gradient clipping.

The schedule is a function of the global step, evaluated before the step
counter moves, as optax evaluates it on its ``count``: update n uses
``schedule(n)``. ``Optimizer.step`` sets it into every param group first.
Clipping follows ``optax.clip_by_global_norm``: ``(g / norm) * max_norm``
only when ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds
1e-6 to the norm and scales always, so it is not used). For SGD, weight
decay is added to the gradients before clipping, as the optax chain does
(``solver.py:106-107``); AdamW decays the weights as ``optax.adamw``.
``flatten_update`` is accepted and has no effect: it reshaped optax's
update for the TPU; ``torch.optim`` updates every tensor in one foreach
call on the card.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from mvpnet_torch.config import SolverConfig


def build_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    """Learning rate of update ``step`` (0-based)."""
    base_lr = cfg.base_lr
    if cfg.scheduler == "none":
        def base(step):
            return base_lr
    elif cfg.scheduler == "step":
        def base(step):
            return base_lr * cfg.gamma ** (step // cfg.step_size)
    elif cfg.scheduler == "multistep":
        def base(step):
            return base_lr * cfg.gamma ** sum(1 for m in cfg.milestones if step >= m)
    elif cfg.scheduler == "cosine":
        def base(step):
            t = min(step, cfg.step_size)
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / cfg.step_size))
    else:
        raise ValueError(f"unknown scheduler {cfg.scheduler!r}")

    def sched(step: int) -> float:
        lr = base(step)
        if cfg.clip_lr > 0:
            lr = max(lr, cfg.clip_lr)
        if cfg.warmup_steps > 0:
            # multiplicative warmup over the global-step schedule: the decay
            # keeps counting from step 0
            lr *= min(1.0, (step + 1) / cfg.warmup_steps)
        return lr

    return sched


class Optimizer:
    """A ``torch.optim`` optimizer driven by the schedule, with the clipping
    and decay order of the optax chain. ``count`` is the number of updates
    made; ``state_dict`` / ``load_state_dict`` carry it."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: SolverConfig):
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.schedule = build_schedule(cfg)
        self.count = 0
        if cfg.optimizer == "adam":
            self.inner = torch.optim.Adam(self.params, lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8)
        elif cfg.optimizer == "adamw":
            self.inner = torch.optim.AdamW(
                self.params, lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay
            )
        elif cfg.optimizer == "sgd":
            # weight decay is added to the gradients in step(), before clipping
            self.inner = torch.optim.SGD(self.params, lr=cfg.base_lr, momentum=cfg.momentum, nesterov=False)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.cfg.optimizer == "sgd" and self.cfg.weight_decay > 0:
            for p in self.params:
                if p.grad is not None:
                    p.grad.add_(p, alpha=self.cfg.weight_decay)
        if self.cfg.max_grad_norm > 0 and grads:
            clip_by_global_norm_(grads, self.cfg.max_grad_norm)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.inner.load_state_dict(state["inner"])


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's rule in place: g <- (g / norm) * max_norm where norm >= max_norm,
    decided on the device (no host sync). Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


def build_optimizer(cfg: SolverConfig, params: Iterable[torch.nn.Parameter]) -> Optimizer:
    return Optimizer(params, cfg)
