"""Grid <-> icosphere connectivity queries (host precompute, SciPy only).

NumPy/SciPy copy of graph_weather_tpu/meshes/connectivity.py;
tests/test_torch_gencast_graphs.py holds the two bit-identical.

Equivalents of reference models/gencast/graph/grid_mesh_connectivity.py:
45-134, without the trimesh dependency:
  * radius_query_indices — kd-tree ball query: every (grid, mesh-vertex)
    pair within a 3D chord radius.
  * in_mesh_triangle_indices — the containing triangle per grid point, via
    kd-tree candidate faces + exact barycentric containment on the gnomonic
    (central) projection: a point on the unit sphere lies in a spherical
    triangle iff the ray from the origin through it intersects the planar
    triangle of the three vertices.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from graph_weather_tpu_torch.meshes.icosphere import TriangularMesh
from graph_weather_tpu_torch.meshes.spatial import (
    lat_lon_deg_to_spherical,
    spherical_to_cartesian,
)


def _grid_positions(grid_latitude: np.ndarray, grid_longitude: np.ndarray) -> np.ndarray:
    lon_grid, lat_grid = np.meshgrid(grid_longitude, grid_latitude)
    phi, theta = lat_lon_deg_to_spherical(lat_grid.reshape(-1), lon_grid.reshape(-1))
    return spherical_to_cartesian(phi, theta)


def radius_query_indices(
    grid_latitude: np.ndarray,
    grid_longitude: np.ndarray,
    mesh: TriangularMesh,
    radius: float,
) -> tuple[np.ndarray, np.ndarray]:
    """All (grid_idx, mesh_idx) pairs within `radius` (3D chord distance).

    Grid points iterate lat-major ((lat, lon) meshgrid flattened), matching
    the reference (grid_mesh_connectivity.py:45-85).
    """
    grid_pos = _grid_positions(grid_latitude, grid_longitude)
    tree = cKDTree(mesh.vertices)
    neighbors = tree.query_ball_point(grid_pos, r=radius)
    grid_idx = []
    mesh_idx = []
    for g, nbrs in enumerate(neighbors):
        grid_idx.extend([g] * len(nbrs))
        mesh_idx.extend(nbrs)
    return (
        np.asarray(grid_idx, dtype=np.int32),
        np.asarray(mesh_idx, dtype=np.int32),
    )


def containing_triangles(points: np.ndarray, mesh: TriangularMesh) -> np.ndarray:
    """[P] face index containing each unit-vector point.

    Candidate faces come from a kd-tree over face centroids (expanding k
    until every point is matched); containment is the gnomonic barycentric
    test with a tolerant epsilon so edge/vertex hits resolve to an adjacent
    face deterministically (smallest face index wins via first-match).
    """
    v = mesh.vertices
    faces = mesh.faces
    centroids = v[faces].mean(axis=1)
    centroids /= np.linalg.norm(centroids, axis=-1, keepdims=True)
    tree = cKDTree(centroids)

    n = points.shape[0]
    result = np.full(n, -1, dtype=np.int64)
    remaining = np.arange(n)
    k = 8
    eps = 1e-12
    while remaining.size:
        if k > faces.shape[0]:
            raise RuntimeError("containing-triangle query failed to converge")
        _, cand = tree.query(points[remaining], k=min(k, faces.shape[0]))
        cand = np.atleast_2d(cand)
        p = points[remaining]  # [R, 3]
        a = v[faces[cand, 0]]  # [R, K, 3]
        b = v[faces[cand, 1]]
        c = v[faces[cand, 2]]
        # Scalar triple products: p is inside the cone spanned by (a, b, c)
        # iff det(p,a,b), det(p,b,c), det(p,c,a) all share the face's
        # orientation sign (faces are CCW from outside, so all >= 0).
        d_ab = np.einsum("rkj,rkj->rk", p[:, None, :], np.cross(a, b))
        d_bc = np.einsum("rkj,rkj->rk", p[:, None, :], np.cross(b, c))
        d_ca = np.einsum("rkj,rkj->rk", p[:, None, :], np.cross(c, a))
        inside = (d_ab >= -eps) & (d_bc >= -eps) & (d_ca >= -eps)
        has = inside.any(axis=1)
        first = inside.argmax(axis=1)
        result[remaining[has]] = cand[np.arange(cand.shape[0])[has], first[has]]
        remaining = remaining[~has]
        k *= 2
    return result


def in_mesh_triangle_indices(
    grid_latitude: np.ndarray,
    grid_longitude: np.ndarray,
    mesh: TriangularMesh,
) -> tuple[np.ndarray, np.ndarray]:
    """(grid_idx, mesh_idx) pairs: 3 vertices of the containing triangle.

    Equivalent of reference grid_mesh_connectivity.py:88-134 (which uses
    trimesh); each grid point yields exactly 3 edges.
    """
    grid_pos = _grid_positions(grid_latitude, grid_longitude)
    face_idx = containing_triangles(grid_pos, mesh)
    mesh_idx = mesh.faces[face_idx].reshape(-1)  # [P * 3]
    grid_idx = np.repeat(np.arange(grid_pos.shape[0], dtype=np.int64), 3)
    return grid_idx.astype(np.int32), mesh_idx.astype(np.int32)
