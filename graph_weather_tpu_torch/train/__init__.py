"""Training: the optimizer, the train step and the inference rollout."""

from graph_weather_tpu_torch.train.optim import cosine_warmup_schedule, make_optimizer
from graph_weather_tpu_torch.train.rollout import make_rollout_fn
from graph_weather_tpu_torch.train.step import make_train_step

__all__ = [
    "cosine_warmup_schedule",
    "make_optimizer",
    "make_rollout_fn",
    "make_train_step",
]
