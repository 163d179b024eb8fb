"""Shared validation helpers (equivalent of reference graph_weather/utils.py)."""

from __future__ import annotations

import numpy as np


def validate_lat_lons(lat_lons) -> None:
    """Validate a list/array of (lat, lon) pairs.

    Latitude must be in [-90, 90]; longitude in [-180, 360) to accept both
    signed and 0-360 conventions (matching the reference's tolerance,
    reference graph_weather/utils.py:5).
    """
    arr = np.asarray(lat_lons, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != 2 or arr.shape[0] == 0:
        raise ValueError(
            f"lat_lons must be a non-empty sequence of (lat, lon) pairs, got shape {arr.shape}"
        )
    if not np.all(np.isfinite(arr)):
        raise ValueError("lat_lons contains non-finite values")
    lat, lon = arr[:, 0], arr[:, 1]
    if lat.min() < -90.0 or lat.max() > 90.0:
        raise ValueError(f"latitude out of range [-90, 90]: [{lat.min()}, {lat.max()}]")
    if lon.min() < -180.0 or lon.max() >= 360.0:
        raise ValueError(f"longitude out of range [-180, 360): [{lon.min()}, {lon.max()}]")
