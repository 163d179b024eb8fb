"""graph_weather_tpu_torch: the PyTorch/CUDA port of graph_weather_tpu.

Keeps the JAX package's module paths and class names. Plain tensor code is
PyTorch; every Pallas kernel of the JAX package on a ported path is a
hand-written CUDA kernel (csrc/) with a plain PyTorch twin that runs on CPU
tensors. Imports torch, never jax.
"""

from graph_weather_tpu_torch.convert import from_jax_params
from graph_weather_tpu_torch.models.forecast import GraphWeatherForecaster
from graph_weather_tpu_torch.models.losses import NormalizedMSELoss

__version__ = "0.1.0"

__all__ = ["GraphWeatherForecaster", "NormalizedMSELoss", "from_jax_params"]
