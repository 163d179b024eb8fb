"""GenCast's per-sample noise-weighted, area-weighted, feature-weighted MSE
(port of graph_weather_tpu/models/gencast/weighted_mse_loss.py).

Tensors use the reference layout [batch, lon, lat, var]; noise levels are
[batch, 1]. The weights live on `device` ("cuda" unless the caller asks for
"cpu").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class WeightedMSELoss:
    """mean_b lambda(sigma_b) mean_(lon, lat, var) w_lat w_var (pred - target)^2,
    lambda(sigma) = (sigma^2 + sigma_data^2) / (sigma sigma_data)^2,
    sigma_data = 1. Area weights |cos(lat)| normalised to mean 1 (when
    grid_lat is given); feature weights are the pressure levels normalised
    to sum 1, tiled over the atmospheric features, then the single-level
    weights (all three arguments, or none)."""

    def __init__(
        self,
        grid_lat: Optional[np.ndarray] = None,
        pressure_levels: Optional[np.ndarray] = None,
        num_atmospheric_features: Optional[int] = None,
        single_features_weights: Optional[np.ndarray] = None,
        device="cuda",
    ):
        area_weights = features_weights = None
        if grid_lat is not None:
            grid_lat = np.asarray(grid_lat, dtype=np.float32)
            area_weights = np.abs(np.cos(np.deg2rad(grid_lat)))
            area_weights = area_weights / area_weights.mean()
        provided = (pressure_levels, num_atmospheric_features, single_features_weights)
        if all(p is not None for p in provided):
            pressure_levels = np.asarray(pressure_levels, dtype=np.float32)
            single = np.asarray(single_features_weights, dtype=np.float32)
            pressure_weights = pressure_levels / pressure_levels.sum()
            features_weights = np.concatenate(
                [np.tile(pressure_weights, num_atmospheric_features), single]
            )
        elif any(p is not None for p in provided):
            raise ValueError(
                "Provide all three of pressure_levels, num_atmospheric_features "
                "and single_features_weights, or none."
            )
        self.sigma_data = 1.0
        self.device = torch.device(device)
        self.area_weights = self._tensor(area_weights)
        self.features_weights = self._tensor(features_weights)

    def _tensor(self, weights):
        if weights is None:
            return None
        return torch.as_tensor(weights, dtype=torch.float32, device=self.device)

    def _lambda_sigma(self, noise_level):
        return (noise_level**2 + self.sigma_data**2) / (noise_level * self.sigma_data) ** 2

    def __call__(
        self, pred: torch.Tensor, noise_level: torch.Tensor, target: torch.Tensor
    ) -> torch.Tensor:
        """pred/target: [batch, lon, lat, var]; noise_level: [batch, 1]."""
        if pred.shape != target.shape:
            raise ValueError(
                f"Predictions and targets must have same shape: {tuple(pred.shape)} vs "
                f"{tuple(target.shape)}."
            )
        if pred.dim() != 4:
            raise ValueError(f"Expected [batch, lon, lat, var], got {tuple(pred.shape)}.")
        if tuple(noise_level.shape) != (pred.shape[0], 1):
            raise ValueError(
                f"Expected noise levels of shape [batch, 1], got {tuple(noise_level.shape)}."
            )
        loss = (pred - target) ** 2
        if self.area_weights is not None:
            if self.area_weights.shape[0] != pred.shape[2]:
                raise ValueError(
                    f"grid_lat size ({self.area_weights.shape[0]}) != prediction "
                    f"latitudes ({pred.shape[2]})."
                )
            loss = loss * self.area_weights[None, None, :, None]
        if self.features_weights is not None:
            if self.features_weights.shape[0] != pred.shape[-1]:
                raise ValueError(
                    f"features weights size ({self.features_weights.shape[0]}) != "
                    f"prediction features ({pred.shape[-1]})."
                )
            loss = loss * self.features_weights[None, None, None, :]
        loss = loss.reshape(loss.shape[0], -1).mean(-1)
        loss = loss * self._lambda_sigma(noise_level).reshape(-1)
        return loss.mean()
