"""Hierarchical hexagonal sphere mesh (replacement for H3).

NumPy/SciPy copy of graph_weather_tpu/meshes/hexmesh.py, held bit-identical
to it by tests/test_torch_meshes.py.

The reference framework uses Uber's H3 C library to build its latent graphs
(reference models/layers/encoder.py:76-114, models/layers/encoder.py:244-268).
H3 is unavailable here and is, in any case, only used at graph-construction
time — so this module provides an equivalent hierarchical aperture-7
hexagonal tiling of the sphere built from first principles with NumPy+SciPy,
emitting static arrays for the device compute path.

Construction: the Goldberg–Coxeter (GC) subdivision of the icosahedron.
Resolution `r` uses the Eisenstein-integer parameter (2, 2) * (2, 1)^r,
whose norm is T(r) = 12 * 7^r, giving exactly

    num_cells(r) = 10 * T(r) + 2 = 120 * 7^r + 2

cells — identical counts to H3 (122 / 842 / 5,882 / 41,162 at r = 0..3),
with 12 pentagonal cells and the rest hexagonal. The latent graph built from
`grid_disk(cell, 1)` therefore has the same edge counts as the reference
(41,162 directed edges incl. self-loops at r=2, cf. reference
tests/test_model.py:31).

Cell centers are the projected GC lattice points; `latlng_to_cell` is the
Voronoi assignment (nearest center), which is exact for this tiling.
Adjacency comes from the spherical Delaunay triangulation (convex hull).

Differences from H3 (deliberate, documented): cell indices are dense ints in
a deterministic (lat, lon) sort order rather than 64-bit H3 ids, and the
icosahedron orientation differs, so cell boundaries do not geographically
coincide with H3's — topology, counts and statistics match.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
from scipy.spatial import ConvexHull, cKDTree

from graph_weather_tpu_torch.meshes.spherical import (
    canonical_point_order,
    dedupe_points,
    latlon_to_xyz,
    normalize_rows,
    xyz_to_latlon,
)

# Eisenstein-lattice basis vectors (60 degrees apart, unit length).
_U = np.array([1.0, 0.0])
_V = np.array([0.5, np.sqrt(3.0) / 2.0])


def _gc_parameter(resolution: int) -> tuple[int, int]:
    """(m, n) with m^2 + m*n + n^2 = 12 * 7^resolution.

    Computed by Eisenstein multiplication: start at (2, 2) (norm 12) and
    multiply by (2, 1) (norm 7) per resolution step:
    (a, b) * (c, d) = (a*c - b*d, a*d + b*c + b*d).
    """
    m, n = 2, 2
    for _ in range(resolution):
        m, n = 2 * m - n, m + 3 * n
    return m, n


def _icosahedron_vertices_faces() -> tuple[np.ndarray, np.ndarray]:
    """Regular icosahedron: 12 unit vertices, 20 CCW-oriented faces.

    Built from the golden-ratio rectangle construction and oriented with a
    vertex at the north pole for deterministic, pole-symmetric output.
    """
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = []
    for a in (-1.0, 1.0):
        for b in (-phi, phi):
            verts.append([0.0, a, b])
            verts.append([a, b, 0.0])
            verts.append([b, 0.0, a])
    verts = normalize_rows(np.array(verts))
    # Rotate so vertex (0, 1, phi)/|.| goes to the north pole (0, 0, 1).
    top = normalize_rows(np.array([0.0, 1.0, phi]))
    z = top
    x = normalize_rows(np.cross(np.array([1.0, 0.0, 0.0]), z))
    x = normalize_rows(np.cross(z, np.cross(z, np.array([1.0, 0.0, 0.0]))) * -1.0)
    # Build an orthonormal frame (x, y, z) and map z->north pole.
    y = np.cross(z, x)
    rot = np.stack([x, y, z])  # rows are the new basis
    verts = verts @ rot.T

    # Faces via convex hull, reoriented CCW (outward normal).
    hull = ConvexHull(verts)
    faces = []
    for simplex in hull.simplices:
        a, b, c = verts[simplex]
        if np.dot(np.cross(b - a, c - a), a + b + c) < 0.0:
            simplex = simplex[[0, 2, 1]]
        faces.append(simplex)
    faces = np.array(sorted(map(tuple, faces)))
    return verts, faces


def _lattice_points_in_triangle(m: int, n: int) -> np.ndarray:
    """Barycentric coords of Eisenstein lattice points in the GC triangle.

    The GC "breakdown" triangle has 2D corners P0 = 0, P1 = m*u + n*v and
    P2 = rot60(P1) = -n*u + (m+n)*v. Returns [K, 3] barycentric coordinates
    (w.r.t. P0, P1, P2) of every lattice point in the closed triangle.
    """
    p1 = m * _U + n * _V
    p2 = -n * _U + (m + n) * _V

    # Conservative integer bounding box in lattice coordinates.
    corners_ij = np.array([[0, 0], [m, n], [-n, m + n]])
    i_min, j_min = corners_ij.min(axis=0)
    i_max, j_max = corners_ij.max(axis=0)

    ii, jj = np.meshgrid(
        np.arange(i_min, i_max + 1), np.arange(j_min, j_max + 1), indexing="ij"
    )
    pts = ii[..., None] * _U + jj[..., None] * _V  # [I, J, 2]
    pts = pts.reshape(-1, 2)

    # Solve p = b1 * P1 + b2 * P2 (P0 is the origin).
    mat = np.stack([p1, p2], axis=1)  # columns P1, P2
    inv = np.linalg.inv(mat)
    b12 = pts @ inv.T
    b0 = 1.0 - b12.sum(axis=1)
    bary = np.concatenate([b0[:, None], b12], axis=1)

    eps = 1e-9
    keep = np.all(bary >= -eps, axis=1)
    bary = np.clip(bary[keep], 0.0, 1.0)
    bary /= bary.sum(axis=1, keepdims=True)
    return bary


@dataclass(frozen=True)
class HexMesh:
    """An immutable hexagonal sphere tiling at one resolution.

    Attributes:
        resolution: hierarchy level (aperture-7 steps from the 122-cell base).
        cell_xyz: [N, 3] float64 unit-vector cell centers, canonically sorted.
        cell_latlon: [N, 2] degrees.
        neighbor_idx: [N, 6] int32 neighbor cell ids, -1-padded (pentagons
            have 5 valid entries). Sorted ascending per row with pads last.
        neighbor_mask: [N, 6] bool validity mask.
    """

    resolution: int
    cell_xyz: np.ndarray
    cell_latlon: np.ndarray
    neighbor_idx: np.ndarray
    neighbor_mask: np.ndarray

    @property
    def num_cells(self) -> int:
        return self.cell_xyz.shape[0]

    @property
    def kdtree(self) -> cKDTree:
        return _mesh_kdtree(self.resolution)

    def latlng_to_cell(self, lat, lon) -> np.ndarray:
        """Containing cell (Voronoi / nearest center) for points in degrees."""
        pts = latlon_to_xyz(np.asarray(lat, dtype=np.float64), np.asarray(lon, dtype=np.float64))
        _, idx = self.kdtree.query(pts.reshape(-1, 3))
        return idx.astype(np.int32).reshape(np.shape(lat))

    def grid_disks(self, cells: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized 1-ring disks: returns ([M, 7] ids, [M, 7] mask).

        Row i is [cells[i], neighbors...] with -1 padding for pentagons.
        """
        cells = np.asarray(cells, dtype=np.int32)
        disks = np.concatenate(
            [cells[:, None], self.neighbor_idx[cells]], axis=1
        )
        return disks, disks >= 0


def _build_hexmesh(resolution: int) -> HexMesh:
    m, n = _gc_parameter(resolution)
    verts, faces = _icosahedron_vertices_faces()
    bary = _lattice_points_in_triangle(m, n)  # [K, 3]

    # Map the breakdown lattice onto every (consistently oriented) face.
    pts = np.einsum("kb,fbd->fkd", bary, verts[faces]).reshape(-1, 3)
    pts = normalize_rows(pts)
    cell_xyz, _ = dedupe_points(pts, tol=1e-7)

    expected = 120 * 7**resolution + 2
    if cell_xyz.shape[0] != expected:
        raise AssertionError(
            f"GC construction produced {cell_xyz.shape[0]} cells at res "
            f"{resolution}, expected {expected}"
        )

    order = canonical_point_order(cell_xyz)
    cell_xyz = cell_xyz[order]

    # Adjacency from the spherical Delaunay triangulation (= convex hull).
    hull = ConvexHull(cell_xyz)
    nbr_sets: list[set[int]] = [set() for _ in range(cell_xyz.shape[0])]
    for a, b, c in hull.simplices:
        nbr_sets[a].update((b, c))
        nbr_sets[b].update((a, c))
        nbr_sets[c].update((a, b))

    degrees = np.array([len(s) for s in nbr_sets])
    n_pent = int(np.sum(degrees == 5))
    if n_pent != 12 or not np.all((degrees == 5) | (degrees == 6)):
        raise AssertionError(
            f"Hex mesh adjacency invalid at res {resolution}: "
            f"degree histogram {np.bincount(degrees)}"
        )

    neighbor_idx = np.full((cell_xyz.shape[0], 6), -1, dtype=np.int32)
    for i, s in enumerate(nbr_sets):
        nbrs = sorted(s)
        neighbor_idx[i, : len(nbrs)] = nbrs

    lat, lon = xyz_to_latlon(cell_xyz)
    return HexMesh(
        resolution=resolution,
        cell_xyz=cell_xyz,
        cell_latlon=np.stack([lat, lon], axis=1),
        neighbor_idx=neighbor_idx,
        neighbor_mask=neighbor_idx >= 0,
    )


@lru_cache(maxsize=8)
def get_hexmesh(resolution: int = 2) -> HexMesh:
    """Cached hexagonal sphere mesh at `resolution` (H3-equivalent)."""
    return _build_hexmesh(resolution)


@lru_cache(maxsize=8)
def _mesh_kdtree(resolution: int) -> cKDTree:
    return cKDTree(get_hexmesh(resolution).cell_xyz)

