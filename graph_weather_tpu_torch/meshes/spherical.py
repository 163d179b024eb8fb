"""Spherical geometry primitives (host-side NumPy precompute).

Copy of graph_weather_tpu/meshes/spherical.py.

All graph construction in this framework happens on the host in NumPy and
emits static index/feature arrays consumed by the device programs. These are
the shared geometric helpers.

Conventions:
  * lat/lon are in degrees unless suffixed `_rad`.
  * 3D points are unit vectors on S^2, shape [..., 3], with
    x = cos(lat)cos(lon), y = cos(lat)sin(lon), z = sin(lat).
"""

from __future__ import annotations

import numpy as np


def latlon_to_xyz(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """Convert latitude/longitude in degrees to unit vectors [..., 3]."""
    lat = np.deg2rad(np.asarray(lat, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon, dtype=np.float64))
    clat = np.cos(lat)
    return np.stack([clat * np.cos(lon), clat * np.sin(lon), np.sin(lat)], axis=-1)


def xyz_to_latlon(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Convert unit vectors [..., 3] to (lat, lon) in degrees."""
    xyz = np.asarray(xyz, dtype=np.float64)
    lat = np.rad2deg(np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0)))
    lon = np.rad2deg(np.arctan2(xyz[..., 1], xyz[..., 0]))
    return lat, lon


def great_circle_distance_xyz(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Great-circle (arc) distance in radians between unit vectors.

    Uses the atan2 formulation, which is numerically stable for both very
    small and near-antipodal separations (unlike arccos of the dot product).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    cross = np.linalg.norm(np.cross(a, b), axis=-1)
    dot = np.sum(a * b, axis=-1)
    return np.arctan2(cross, dot)


def normalize_rows(v: np.ndarray) -> np.ndarray:
    """Normalize the last axis of `v` to unit length."""
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def canonical_point_order(xyz: np.ndarray) -> np.ndarray:
    """Deterministic ordering of points on the sphere.

    Sorts by (rounded lat, rounded lon) so cell enumeration is reproducible
    across runs and platforms. Analogous role to the reference sorting H3
    string ids (reference models/layers/encoder.py:76).
    """
    lat, lon = xyz_to_latlon(xyz)
    key_lat = np.round(lat, 7)
    key_lon = np.round(lon, 7)
    return np.lexsort((key_lon, key_lat))


def dedupe_points(xyz: np.ndarray, tol: float = 1e-7) -> tuple[np.ndarray, np.ndarray]:
    """Deduplicate near-identical unit vectors.

    Returns (unique_xyz, inverse) such that xyz[i] ~= unique_xyz[inverse[i]].
    Uses a kd-tree pair query plus union-find, which (unlike rounding-based
    hashing) cannot split a duplicate pair straddling a rounding boundary.
    `tol` must be far below the minimum point spacing (typically >1e-2).
    """
    from scipy.spatial import cKDTree

    xyz = np.asarray(xyz, dtype=np.float64)
    n = xyz.shape[0]
    tree = cKDTree(xyz)
    pairs = tree.query_pairs(r=tol, output_type="ndarray")

    parent = np.arange(n)

    def find(i: int) -> int:
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for i, j in pairs:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)

    roots = np.array([find(i) for i in range(n)])
    unique_roots, inverse = np.unique(roots, return_inverse=True)
    return xyz[unique_roots], inverse
