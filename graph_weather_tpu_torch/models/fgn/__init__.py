"""FGN: Functional Generative Network ensemble forecasting (port of
graph_weather_tpu.models.fgn)."""

from graph_weather_tpu_torch.models.fgn.model import (
    FGNModule,
    FunctionalGenerativeNetwork,
    FunctionalGenerativeNetworkConfig,
)

__all__ = ["FGNModule", "FunctionalGenerativeNetwork", "FunctionalGenerativeNetworkConfig"]
