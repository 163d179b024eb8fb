"""Host-side graph construction (NumPy/SciPy copies of graph_weather_tpu.meshes)."""
