"""GenCast: graph-diffusion ensemble forecasting (port of
graph_weather_tpu.models.gencast): the denoiser, the sampler, the
autoregressive rollout, and the training loss and noise levels."""

from graph_weather_tpu_torch.models.gencast.denoiser import (
    Denoiser,
    DenoiserConfig,
    Preconditioner,
)
from graph_weather_tpu_torch.models.gencast.graphs import (
    GraphCastGraphs,
    build_graphcast_graphs,
)
from graph_weather_tpu_torch.models.gencast.noise import (
    noise_level_from_uniform,
    sample_noise_level,
)
from graph_weather_tpu_torch.models.gencast.rollout import (
    default_update_fn,
    make_ar_rollout_fn,
)
from graph_weather_tpu_torch.models.gencast.sampler import Sampler
from graph_weather_tpu_torch.models.gencast.weighted_mse_loss import WeightedMSELoss
from graph_weather_tpu_torch.ops.sht import generate_isotropic_noise

__all__ = [
    "Denoiser",
    "DenoiserConfig",
    "GraphCastGraphs",
    "Preconditioner",
    "Sampler",
    "WeightedMSELoss",
    "build_graphcast_graphs",
    "default_update_fn",
    "generate_isotropic_noise",
    "make_ar_rollout_fn",
    "noise_level_from_uniform",
    "sample_noise_level",
]
