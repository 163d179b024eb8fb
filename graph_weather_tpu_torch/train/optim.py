"""AdamW with global-norm clipping and the warmup-cosine schedule, with
optax's semantics (port of graph_weather_tpu/train/optim.py).

Defaults mirror the reference recipes: AdamW (lr 1e-3, wd 0.1, betas
0.9/0.95, eps 1e-8) after clipping the global gradient norm to 1. Where
optax and torch's defaults differ, this follows optax:

  * clipping scales every gradient by max_norm / max(norm, max_norm)
    (torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6);
  * weight decay applies to every parameter, biases and norms included;
  * a schedule is read at the step count before the step: the warmup
    starts from lr 0 at step 0.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Union

import torch

Schedule = Callable[[int], float]


def cosine_warmup_schedule(
    peak_lr: float = 1e-3,
    warmup_steps: int = 1000,
    total_steps: int = 100_000,
    end_lr_ratio: float = 0.0,
) -> Schedule:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak_lr, warmup_steps,
    decay_steps=total_steps, end_value=peak_lr * end_lr_ratio): linear from 0
    to peak_lr over warmup_steps, then a cosine over total_steps - warmup_steps."""
    if total_steps - warmup_steps <= 0:
        raise ValueError("total_steps must exceed warmup_steps")
    end_lr = peak_lr * end_lr_ratio

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * step / warmup_steps
        t = min(step - warmup_steps, total_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (total_steps - warmup_steps)))
        return end_lr + (peak_lr - end_lr) * cosine

    return schedule


class ClippedAdamW(torch.optim.AdamW):
    """optax.chain(clip_by_global_norm(grad_clip), adamw(...)) as one torch
    optimizer: torch's AdamW update (decoupled decay on every parameter,
    which is optax's u = m_hat / (sqrt(v_hat) + eps) + wd p, p -= lr u) after
    optax's clipping, with the learning rate read from the schedule at the
    step count before the step. `step()` returns the global norm of the
    gradients before clipping."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        learning_rate: Union[float, Schedule] = 1e-3,
        weight_decay: float = 0.1,
        b1: float = 0.9,
        b2: float = 0.95,
        eps: float = 1e-8,
        grad_clip: float | None = 1.0,
    ):
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        super().__init__(
            params, lr=self.schedule(0), betas=(b1, b2), eps=eps, weight_decay=weight_decay
        )
        self.grad_clip = grad_clip
        self.count = 0  # optax's step count: steps taken so far

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("ClippedAdamW.step takes no closure")
        grads = [p.grad for group in self.param_groups for p in group["params"] if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        if self.grad_clip is not None:
            torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        for group in self.param_groups:
            group["lr"] = self.schedule(self.count)
        super().step()
        self.count += 1
        return norm


def make_optimizer(
    learning_rate: Union[float, Schedule] = 1e-3,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float | None = 1.0,
    accumulate_steps: int = 1,
) -> Callable[[Iterable[torch.Tensor]], ClippedAdamW]:
    """AdamW with optional global-norm clipping. Returns a factory
    `params -> optimizer` (as optax's transformation is `init`ed on its
    parameters)."""
    if accumulate_steps > 1:
        raise NotImplementedError(
            "accumulate_steps > 1 (optax.MultiSteps) is not ported yet. See "
            "ROADMAP.md §1 item 7, 'Training harness'."
        )

    def build(params: Iterable[torch.Tensor]) -> ClippedAdamW:
        return ClippedAdamW(
            params, learning_rate, weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip
        )

    return build
