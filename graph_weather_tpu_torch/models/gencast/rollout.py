"""Autoregressive GenCast forecasting: chained diffusion samples.

Port of graph_weather_tpu/models/gencast/rollout.py. The JAX package runs
the whole trajectory as one `lax.scan`; here it is a Python loop over
`Sampler.sample`, with the state kept on the device.

Conditioning layout: `prev_inputs` is [B, lon, lat, 2 F_in], the two most
recent input frames concatenated. Each AR step samples a residual
[B, lon, lat, F_out] for the next frame; the default `update_fn` shifts the
window: frame1 <- frame2, and the new frame's first F_out channels are
frame2's plus the residual, the other channels carried unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def default_update_fn(prev_inputs: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Shift the 2-frame conditioning window by one predicted frame."""
    f_in = prev_inputs.shape[-1] // 2
    f_out = sample.shape[-1]
    frame2 = prev_inputs[..., f_in:]
    next_frame = torch.cat([frame2[..., :f_out] + sample, frame2[..., f_out:]], dim=-1)
    return torch.cat([frame2, next_frame], dim=-1)


def make_ar_rollout_fn(
    sampler,
    denoiser,
    num_ar_steps: int,
    update_fn: Optional[Callable] = None,
    collect: bool = True,
    device="cuda",
):
    """Build (prev_inputs, generator) -> residual trajectory, on `device`
    ("cuda" unless the caller asks for "cpu"; the sampler and the denoiser
    must live there).

    Returns [num_ar_steps, B, lon, lat, F_out] when collect=True, else the
    final conditioning window [B, lon, lat, 2 F_in].
    """
    device = torch.device(device)
    if sampler.device != device or denoiser.device != device:
        raise ValueError(
            f"rollout on {device}: the sampler ({sampler.device}) and the "
            f"denoiser ({denoiser.device}) must live there"
        )
    update = update_fn if update_fn is not None else default_update_fn

    @torch.no_grad()
    def rollout(prev_inputs, generator: torch.Generator) -> torch.Tensor:
        prev = torch.as_tensor(prev_inputs, dtype=torch.float32, device=device)
        samples = []
        for _ in range(num_ar_steps):
            sample = sampler.sample(denoiser, prev, generator)
            prev = update(prev, sample)
            if collect:
                samples.append(sample)
        return torch.stack(samples) if collect else prev

    return rollout
