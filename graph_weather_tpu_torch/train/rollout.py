"""Autoregressive rollout (port of graph_weather_tpu/train/rollout.py).

The JAX package compiles the rollout into one `lax.scan`; PyTorch runs
eagerly, so here it is a Python loop over the forward.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def make_rollout_fn(
    forward_fn: Callable[[torch.Tensor], torch.Tensor],
    num_steps: int,
    feature_dim: Optional[int] = None,
    collect: bool = True,
):
    """Build features -> trajectory for an autoregressive model.

    forward_fn maps [B, N, feature+aux] -> [B, N, out]. When the model
    carries aux channels (out < input channels), the aux tail of the input
    is held fixed across steps; `feature_dim` defaults to the forward output
    width.

    Returns trajectory [num_steps, B, N, out] when collect=True, else only
    the final state [B, N, out].
    """

    @torch.no_grad()
    def rollout(features: torch.Tensor) -> torch.Tensor:
        state = features
        preds = []
        for _ in range(num_steps):
            pred = forward_fn(state)
            f_out = pred.shape[-1] if feature_dim is None else feature_dim
            state = torch.cat([pred, state[..., f_out:]], dim=-1)
            if collect:
                preds.append(pred)
        return torch.stack(preds) if collect else state[..., :f_out]

    return rollout
