"""GraphCast-style spatial features with receiver-local rotated coordinates.

NumPy copy of graph_weather_tpu/meshes/spatial.py;
tests/test_torch_gencast_graphs.py holds the two bit-identical.

Semantics match reference models/gencast/graph/model_utils.py:25-508:
  * node features: [cos(theta), cos(phi), sin(phi)] (lat as cos of polar
    angle, lon as cos/sin) — 3 dims with the default config.
  * edge features: [|d| / norm, d / norm] where d is the 3D relative
    position of sender minus receiver expressed in a rotated frame where the
    receiver sits at latitude 0, longitude 0 (position (1, 0, 0)) with the
    pole direction aligned to +z — 4 dims. Normalization is the max edge
    length unless given.

Rotations are built directly from trigonometric products (vectorized over
all nodes) instead of scipy Rotation objects: the extrinsic Euler "zy"
sequence with angles (-phi, pi/2 - theta) is
    R = Ry(pi/2 - theta) @ Rz(-phi).
"""

from __future__ import annotations

import numpy as np


def lat_lon_deg_to_spherical(lat: np.ndarray, lon: np.ndarray):
    """(lat, lon) degrees -> (phi azimuth, theta polar) radians."""
    phi = np.deg2rad(np.asarray(lon, dtype=np.float64))
    theta = np.deg2rad(90.0 - np.asarray(lat, dtype=np.float64))
    return phi, theta


def spherical_to_cartesian(phi: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Unit vectors [..., 3] from azimuth/polar angles."""
    st = np.sin(theta)
    return np.stack([np.cos(phi) * st, np.sin(phi) * st, np.cos(theta)], axis=-1)


def _rz(a: np.ndarray) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    z = np.zeros_like(a)
    o = np.ones_like(a)
    return np.stack(
        [
            np.stack([c, -s, z], axis=-1),
            np.stack([s, c, z], axis=-1),
            np.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )


def _ry(a: np.ndarray) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    z = np.zeros_like(a)
    o = np.ones_like(a)
    return np.stack(
        [
            np.stack([c, z, s], axis=-1),
            np.stack([z, o, z], axis=-1),
            np.stack([-s, z, c], axis=-1),
        ],
        axis=-2,
    )


def rotation_matrices_to_local_coordinates(
    phi: np.ndarray,
    theta: np.ndarray,
    rotate_latitude: bool = True,
    rotate_longitude: bool = True,
) -> np.ndarray:
    """[N, 3, 3] rotations taking each reference point to its local frame.

    Equivalent of reference model_utils.py:291-361 (extrinsic Euler
    compositions), built from explicit elementary rotations.
    """
    az = -phi
    pol = np.pi / 2.0 - theta
    if rotate_longitude and rotate_latitude:
        return _ry(pol) @ _rz(az)
    if rotate_longitude:
        return _rz(az)
    if rotate_latitude:
        return _rz(-az) @ _ry(pol) @ _rz(az)
    raise ValueError("At least one of longitude and latitude must be rotated.")


def relative_positions_in_receiver_local_coordinates(
    sender_phi: np.ndarray,
    sender_theta: np.ndarray,
    receiver_phi: np.ndarray,
    receiver_theta: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    rotate_latitude: bool = True,
    rotate_longitude: bool = True,
) -> np.ndarray:
    """[E, 3] sender-minus-receiver positions in each receiver's frame."""
    sender_pos = spherical_to_cartesian(sender_phi, sender_theta)
    receiver_pos = spherical_to_cartesian(receiver_phi, receiver_theta)
    if not (rotate_latitude or rotate_longitude):
        return sender_pos[senders] - receiver_pos[receivers]
    rot = rotation_matrices_to_local_coordinates(
        receiver_phi, receiver_theta, rotate_latitude, rotate_longitude
    )
    edge_rot = rot[receivers]  # [E, 3, 3]
    s = np.einsum("eij,ej->ei", edge_rot, sender_pos[senders])
    r = np.einsum("eij,ej->ei", edge_rot, receiver_pos[receivers])
    return s - r


def node_spatial_features(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """[N, 3] features: [cos(theta), cos(phi), sin(phi)]."""
    phi, theta = lat_lon_deg_to_spherical(lat, lon)
    return np.stack(
        [np.cos(theta), np.cos(phi), np.sin(phi)], axis=-1
    ).astype(np.float32)


def edge_spatial_features(
    sender_lat: np.ndarray,
    sender_lon: np.ndarray,
    receiver_lat: np.ndarray,
    receiver_lon: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_normalization_factor: float | None = None,
) -> np.ndarray:
    """[E, 4] features: [scaled length, scaled relative position (3)]."""
    s_phi, s_theta = lat_lon_deg_to_spherical(sender_lat, sender_lon)
    r_phi, r_theta = lat_lon_deg_to_spherical(receiver_lat, receiver_lon)
    rel = relative_positions_in_receiver_local_coordinates(
        s_phi, s_theta, r_phi, r_theta, senders, receivers
    )
    length = np.linalg.norm(rel, axis=-1, keepdims=True)
    norm = (
        edge_normalization_factor
        if edge_normalization_factor is not None
        else length.max()
    )
    return np.concatenate([length / norm, rel / norm], axis=-1).astype(np.float32)
