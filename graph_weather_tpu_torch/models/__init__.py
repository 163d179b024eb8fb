"""Model handles of the port."""

from graph_weather_tpu_torch.models.forecast import GraphWeatherForecaster
from graph_weather_tpu_torch.models.losses import NormalizedMSELoss

__all__ = ["GraphWeatherForecaster", "NormalizedMSELoss"]
