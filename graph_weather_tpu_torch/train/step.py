"""The training step (port of graph_weather_tpu/train/step.py).

    step = make_train_step(params, forward_fn, loss_fn, make_optimizer(1e-4))
    loss = step(*inputs, targets)

One step: zero the gradients, forward, loss, backward, then the optimizer's
step (clipping and AdamW for `make_optimizer`'s). The parameters are
updated in place.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def make_train_step(
    params: Iterable[torch.Tensor],
    forward_fn: Callable,
    loss_fn: Callable,
    optimizer: Callable,
    return_grad_norm: bool = False,
):
    """Build `step(*inputs, targets) -> loss` (or `(loss, grad_norm)` with
    return_grad_norm; the norm is that of the gradients before clipping).

    forward_fn: (*inputs) -> predictions; loss_fn: (predictions, targets) ->
    scalar; optimizer: a factory `params -> torch.optim.Optimizer` whose
    `step()` returns the gradient norm (`train.make_optimizer`'s does). The
    optimizer is `step.optimizer`.
    """
    opt = optimizer(list(params))

    def step(*batch):
        inputs, targets = batch[:-1], batch[-1]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(forward_fn(*inputs), targets)
        loss.backward()
        grad_norm = opt.step()
        loss = loss.detach()
        return (loss, grad_norm) if return_grad_norm else loss

    step.optimizer = opt
    return step
