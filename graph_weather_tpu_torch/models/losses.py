"""Weather loss functions (port of graph_weather_tpu/models/losses.py)."""

from __future__ import annotations

import numpy as np
import torch


class NormalizedMSELoss:
    """Cos(lat)-weighted (optionally variance-normalized) MSE.

    Squared error, optional division by per-feature variance, mean over
    features, multiplied by a per-unique-latitude cos(lat) weight tiled
    across longitudes (assumes node ordering groups rows of constant
    latitude), then mean.
    """

    def __init__(self, feature_variance, lat_lons, normalize: bool = False, device="cuda"):
        fv = np.asarray(feature_variance, dtype=np.float32)
        if not np.all(np.isfinite(fv)):
            raise ValueError("feature_variance contains non-finite values")
        self.feature_variance = torch.as_tensor(fv, device=device)
        unique_lats = sorted(set(lat for lat, _ in lat_lons))
        weights = np.cos(np.deg2rad(np.asarray(unique_lats, dtype=np.float32)))
        self.weights = torch.as_tensor(weights, device=device)
        self.normalize = normalize

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        out = (pred - target) ** 2
        if self.normalize:
            out = out / self.feature_variance
        out = out.mean(dim=-1)  # mean over physical variables -> [B, ...nodes]
        out = out.reshape(out.shape[0], -1)  # [B, num_nodes]
        num_nodes = out.shape[1]
        num_lon = num_nodes // self.weights.shape[0]
        weight_grid = self.weights.repeat_interleave(num_lon).reshape(1, num_nodes)
        return (out * weight_grid).mean()
