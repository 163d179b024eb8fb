"""WeatherMesh-3: conv encoder + 3D neighborhood-attention processors."""

from graph_weather_tpu_torch.models.weathermesh.model import (
    ConvDownBlock,
    ConvUpBlock,
    NeighborhoodAttention3D,
    WeatherMesh,
    WeatherMeshConfig,
    WeatherMeshDecoder,
    WeatherMeshDecoderConfig,
    WeatherMeshEncoder,
    WeatherMeshEncoderConfig,
    WeatherMeshModule,
    WeatherMeshOutput,
    WeatherMeshProcessor,
    WeatherMeshProcessorConfig,
)

__all__ = [
    "ConvDownBlock",
    "ConvUpBlock",
    "NeighborhoodAttention3D",
    "WeatherMesh",
    "WeatherMeshConfig",
    "WeatherMeshDecoder",
    "WeatherMeshDecoderConfig",
    "WeatherMeshEncoder",
    "WeatherMeshEncoderConfig",
    "WeatherMeshModule",
    "WeatherMeshOutput",
    "WeatherMeshProcessor",
    "WeatherMeshProcessorConfig",
]
