"""Noise levels for GenCast training (port of
graph_weather_tpu/models/gencast/noise.py)."""

from __future__ import annotations

import torch


def noise_level_from_uniform(
    u: torch.Tensor, sigma_min: float = 0.02, sigma_max: float = 88.0, rho: float = 7.0
) -> torch.Tensor:
    """The training distribution's map from u ~ U[0, 1) to sigma: u = 0 gives
    sigma_max, u -> 1 gives sigma_min, interpolated in sigma^(1/rho)."""
    return (
        sigma_max ** (1 / rho) + u * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))
    ) ** rho


def sample_noise_level(
    generator: torch.Generator,
    shape=(),
    sigma_min: float = 0.02,
    sigma_max: float = 88.0,
    rho: float = 7.0,
) -> torch.Tensor:
    """Training noise levels of `shape`, drawn from `generator` (on its device)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return noise_level_from_uniform(u, sigma_min, sigma_max, rho)
