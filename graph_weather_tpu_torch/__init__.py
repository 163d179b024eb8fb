"""graph_weather_tpu_torch: the PyTorch/CUDA port of graph_weather_tpu.

Keeps the JAX package's module paths and class names. Plain tensor code is
PyTorch; every Pallas kernel of the JAX package on a ported path is a
hand-written CUDA kernel (csrc/) with a plain PyTorch twin that runs on CPU
tensors. Imports torch, never jax. Entry points run on the card (device
"cuda") unless the caller passes device="cpu".
"""

from graph_weather_tpu_torch.convert import from_jax_params, weathermesh_from_jax
from graph_weather_tpu_torch.models.forecast import GraphWeatherForecaster
from graph_weather_tpu_torch.models.gencast import (
    Denoiser,
    Sampler,
    WeightedMSELoss,
    make_ar_rollout_fn,
    sample_noise_level,
)
from graph_weather_tpu_torch.models.losses import NormalizedMSELoss
from graph_weather_tpu_torch.models.weathermesh import WeatherMesh, WeatherMeshConfig
from graph_weather_tpu_torch.train import cosine_warmup_schedule, make_optimizer, make_train_step

__version__ = "0.1.0"

__all__ = [
    "Denoiser",
    "GraphWeatherForecaster",
    "NormalizedMSELoss",
    "Sampler",
    "WeatherMesh",
    "WeatherMeshConfig",
    "WeightedMSELoss",
    "cosine_warmup_schedule",
    "from_jax_params",
    "make_ar_rollout_fn",
    "make_optimizer",
    "make_train_step",
    "sample_noise_level",
    "weathermesh_from_jax",
]
