"""Icosahedral triangular sphere meshes (GenCast/GraphCast mesh family).

NumPy copy of graph_weather_tpu/meshes/icosphere.py;
tests/test_torch_gencast_graphs.py holds the two bit-identical.

Capability-equivalent to the reference's icosahedral mesh utilities
(reference models/gencast/graph/icosahedral_mesh.py:39-264) but implemented
as vectorized NumPy: each 1->4 subdivision step deduplicates edge midpoints
with a single np.unique over canonicalized edge pairs instead of per-face
Python dict bookkeeping. splits=s gives 10*4^s + 2 vertices (2,562 at s=4,
40,962 at s=6 — the reference's asserted constants, tests/test_gencast.py:61).

Vertex ordering is deterministic: parents first, then new midpoints in
np.unique order of their (lo, hi) parent pairs, so every level's vertices are
a prefix of the next level's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from graph_weather_tpu_torch.meshes.spherical import normalize_rows


class TriangularMesh(NamedTuple):
    """A triangular mesh on the unit sphere.

    Attributes:
        vertices: [V, 3] float unit-norm vertex positions.
        faces: [F, 3] int32 vertex indices, counter-clockwise from outside.
    """

    vertices: np.ndarray
    faces: np.ndarray


def get_icosahedron(orientation: str = "pole") -> TriangularMesh:
    """Regular icosahedron with circumscribed unit sphere.

    orientation:
      * "pole" (default): one vertex exactly at the north pole — keeps
        output symmetric under longitude rotation of the grid.
      * "graphcast": the reference/GraphCast orientation (reference
        icosahedral_mesh.py:144-152): the standard coordinates rotated
        about the y axis by half the supplement of the dihedral angle
        2*arcsin(phi/sqrt(3)), which puts a face plane on top. Use this to
        build graphs GEOMETRICALLY identical to the reference's, e.g. when
        loading weights pretrained against its meshes (vertex ORDER still
        differs, which is immaterial: GenCast-family models have no
        per-vertex parameters and are permutation-equivariant over mesh
        nodes).
    """
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = []
    for a in (-1.0, 1.0):
        for b in (-phi, phi):
            verts.append([0.0, a, b])
            verts.append([a, b, 0.0])
            verts.append([b, 0.0, a])
    verts = normalize_rows(np.asarray(verts, dtype=np.float64))

    if orientation == "pole":
        # Rotate vertex closest to +z exactly onto the pole.
        top = verts[np.argmax(verts[:, 2])]
        z = top
        x = np.cross([0.0, 1.0, 0.0], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        rot = np.stack([x, y, z])
        verts = verts @ rot.T
    elif orientation == "graphcast":
        angle_between_faces = 2.0 * np.arcsin(phi / np.sqrt(3.0))
        theta = (np.pi - angle_between_faces) / 2.0
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        # Rotation about y (matching scipy's Rotation.from_euler("y", t)
        # applied as vertices @ R, i.e. the inverse rotation of points).
        rot = np.array(
            [[cos_t, 0.0, -sin_t], [0.0, 1.0, 0.0], [sin_t, 0.0, cos_t]]
        )
        verts = verts @ rot.T
    else:
        raise ValueError(f"unknown orientation {orientation!r}")

    # Faces from the convex hull, consistently CCW seen from outside.
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    faces = []
    for simplex in hull.simplices:
        a, b, c = verts[simplex]
        if np.dot(np.cross(b - a, c - a), a + b + c) < 0.0:
            simplex = simplex[[0, 2, 1]]
        faces.append(tuple(simplex))
    faces = np.asarray(sorted(faces), dtype=np.int32)
    return TriangularMesh(vertices=verts, faces=faces)


def split_mesh(mesh: TriangularMesh) -> TriangularMesh:
    """One 1->4 face subdivision, vectorized, preserving orientation.

    New midpoint vertices are deduplicated across adjacent faces by
    np.unique over canonical (lo, hi) parent index pairs.
    """
    v, f = mesh.vertices, mesh.faces
    # All 3 edges of all faces: (v0,v1), (v1,v2), (v2,v0).
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e_sorted = np.sort(e, axis=1)
    uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)

    midpoints = normalize_rows(v[uniq[:, 0]] + v[uniq[:, 1]])
    new_vertices = np.concatenate([v, midpoints], axis=0)

    n_faces = f.shape[0]
    m01 = v.shape[0] + inv[:n_faces]
    m12 = v.shape[0] + inv[n_faces : 2 * n_faces]
    m20 = v.shape[0] + inv[2 * n_faces :]

    new_faces = np.concatenate(
        [
            np.stack([f[:, 0], m01, m20], axis=1),
            np.stack([m01, f[:, 1], m12], axis=1),
            np.stack([m20, m12, f[:, 2]], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ],
        axis=0,
    ).astype(np.int32)
    return TriangularMesh(vertices=new_vertices, faces=new_faces)


def get_hierarchy_of_triangular_meshes_for_sphere(
    splits: int, orientation: str = "pole"
) -> list[TriangularMesh]:
    """Icosphere hierarchy from 0 to `splits` subdivisions (coarse first)."""
    meshes = [get_icosahedron(orientation)]
    for _ in range(splits):
        meshes.append(split_mesh(meshes[-1]))
    return meshes


def merge_meshes(mesh_list: list[TriangularMesh]) -> TriangularMesh:
    """Multiscale mesh: finest vertices, union of all levels' faces.

    Because every level's vertices are a prefix of the next level's, coarse
    faces index directly into the finest vertex array. This is the GraphCast
    multi-scale mesh trick: message passing over the union of edges at all
    refinement levels gives long-range connectivity without deep stacks.
    """
    for i, mesh in enumerate(mesh_list[:-1]):
        num_next = mesh_list[i + 1].vertices.shape[0]
        if mesh.vertices.shape[0] >= num_next:
            raise ValueError("mesh_list must be ordered coarse to fine")
    return TriangularMesh(
        vertices=mesh_list[-1].vertices,
        faces=np.concatenate([m.faces for m in mesh_list], axis=0),
    )


def faces_to_edges(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Directed edges of consistently oriented closed faces.

    Face [a, b, c] contributes a->b, b->c, c->a; on a closed orientable
    surface every undirected edge therefore appears in both directions.
    """
    faces = np.asarray(faces)
    senders = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    receivers = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    return senders, receivers


def num_vertices(splits: int) -> int:
    """Vertex count after `splits` subdivisions: 10 * 4^splits + 2."""
    return 10 * 4**splits + 2
