"""Inference-time rollout (training is not ported yet)."""

from graph_weather_tpu_torch.train.rollout import make_rollout_fn

__all__ = ["make_rollout_fn"]
