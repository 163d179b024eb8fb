"""GraphCast-family graphs: g2m (radius), mesh, m2g (triangle), k-hop.

NumPy/SciPy copy of graph_weather_tpu/models/gencast/graphs.py, emitting
static GraphBundles plus precomputed spatial node features. Two
differences, neither of which changes a graph:

  * the k-hop expansion always takes the SciPy boolean-matrix-power path
    (the JAX package prefers a native BFS when it can build one). Both give
    the same edge SET; after the stable sort by receiver, senders within a
    receiver may come in another order, which changes nothing downstream:
    segment sums are order-free up to f32 rounding, and the cluster layout
    `np.unique`s each block's senders;
  * there is no disk cache: the splits-5 graphs build in about a second.

tests/test_torch_gencast_graphs.py holds g2m, mesh and m2g bit-identical to
the JAX package's, and the k-hop graph equal as a set per receiver.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from graph_weather_tpu_torch.meshes.connectivity import (
    in_mesh_triangle_indices,
    radius_query_indices,
)
from graph_weather_tpu_torch.meshes.graphs import GraphBundle
from graph_weather_tpu_torch.meshes.icosphere import (
    TriangularMesh,
    faces_to_edges,
    get_hierarchy_of_triangular_meshes_for_sphere,
)
from graph_weather_tpu_torch.meshes.spatial import (
    edge_spatial_features,
    node_spatial_features,
)

RADIUS_QUERY_FRACTION_EDGE_LENGTH = 0.6  # reference graph_builder.py:60


def _max_edge_length(mesh: TriangularMesh) -> float:
    s, r = faces_to_edges(mesh.faces)
    return float(np.linalg.norm(mesh.vertices[s] - mesh.vertices[r], axis=-1).max())


def khop_edges(
    senders: np.ndarray, receivers: np.ndarray, n: int, num_hops: int
) -> tuple[np.ndarray, np.ndarray]:
    """Edges of the <=num_hops-neighborhood graph (no self loops), by
    scipy boolean matrix powers (reference graph_builder.py:309-355)."""
    adj = sp.csr_matrix(
        (np.ones_like(senders, dtype=bool), (senders, receivers)), shape=(n, n)
    )
    adj_k = adj.copy()
    for _ in range(num_hops - 1):
        adj_k = (adj_k + adj_k @ adj).astype(bool)
        adj_k.setdiag(False)
        adj_k.eliminate_zeros()
    coo = adj_k.tocoo()
    return coo.row.astype(np.int32), coo.col.astype(np.int32)


def _mesh_latlon(mesh: TriangularMesh) -> tuple[np.ndarray, np.ndarray]:
    v = mesh.vertices
    lat = 90.0 - np.rad2deg(np.arccos(np.clip(v[:, 2], -1, 1)))
    lon = np.mod(np.rad2deg(np.arctan2(v[:, 1], v[:, 0])), 360.0)
    return lat.astype(np.float32), lon.astype(np.float32)


@dataclass(frozen=True)
class GraphCastGraphs:
    """All static arrays for a GenCast/GraphCast-style model."""

    g2m: GraphBundle
    mesh: GraphBundle
    m2g: GraphBundle
    khop: GraphBundle | None
    grid_node_feats: np.ndarray  # [N_grid, 3]
    mesh_node_feats: np.ndarray  # [N_mesh, 3]
    mesh_vertices: np.ndarray  # [N_mesh, 3]

    @property
    def grid_nodes_dim(self) -> int:
        return self.grid_node_feats.shape[1]

    @property
    def mesh_nodes_dim(self) -> int:
        return self.mesh_node_feats.shape[1]

    @property
    def g2m_edges_dim(self) -> int:
        return self.g2m.edge_attr.shape[1]

    @property
    def mesh_edges_dim(self) -> int:
        return self.mesh.edge_attr.shape[1]

    @property
    def m2g_edges_dim(self) -> int:
        return self.m2g.edge_attr.shape[1]


def build_graphcast_graphs(
    grid_lon: np.ndarray,
    grid_lat: np.ndarray,
    splits: int = 5,
    num_hops: int = 0,
    add_edge_features_to_khop: bool = True,
    mesh2grid_edge_normalization_factor: float | None = None,
    spatial_sort: bool | str = True,
    mesh_orientation: str = "pole",
) -> GraphCastGraphs:
    """Build g2m / mesh / m2g (/ k-hop) bundles for a lon-major grid.

    Grid node order is the lat-major flattening of meshgrid(lon, lat):
    index = lat_i * n_lon + lon_i. spatial_sort renumbers MESH vertices:
    True/"latlon" sorts by (lat, lon); "rcb" orders by recursive coordinate
    bisection, so every aligned 512-vertex slice is a compact geodesic
    patch (the layout the clustered attention needs); False keeps the
    subdivision order.
    """
    grid_lon = np.asarray(grid_lon, dtype=np.float64)
    grid_lat = np.asarray(grid_lat, dtype=np.float64)
    mesh = get_hierarchy_of_triangular_meshes_for_sphere(
        splits, orientation=mesh_orientation
    )[-1]
    if spatial_sort:
        if spatial_sort == "rcb":
            from graph_weather_tpu_torch.meshes.clustering import rcb_order

            order = rcb_order(mesh.vertices, leaf=512)
        else:
            from graph_weather_tpu_torch.meshes.spherical import canonical_point_order

            order = canonical_point_order(mesh.vertices)
        inverse = np.empty_like(order)
        inverse[order] = np.arange(order.shape[0])
        mesh = TriangularMesh(vertices=mesh.vertices[order], faces=inverse[mesh.faces])
    mesh_lat, mesh_lon = _mesh_latlon(mesh)

    lon_g, lat_g = np.meshgrid(grid_lon, grid_lat)
    grid_nodes_lat = lat_g.reshape(-1).astype(np.float32)
    grid_nodes_lon = lon_g.reshape(-1).astype(np.float32)
    n_grid = grid_nodes_lat.shape[0]
    n_mesh = mesh.vertices.shape[0]

    radius = _max_edge_length(mesh) * RADIUS_QUERY_FRACTION_EDGE_LENGTH

    # g2m
    g_idx, m_idx = radius_query_indices(grid_lat, grid_lon, mesh, radius)
    g2m_attr = edge_spatial_features(
        grid_nodes_lat, grid_nodes_lon, mesh_lat, mesh_lon, g_idx, m_idx
    )
    g2m = GraphBundle(
        senders=g_idx, receivers=m_idx, edge_attr=g2m_attr,
        n_senders=n_grid, n_receivers=n_mesh,
    ).sorted_by_receiver()

    # mesh
    s, r = faces_to_edges(mesh.faces)
    s = s.astype(np.int32)
    r = r.astype(np.int32)
    mesh_attr = edge_spatial_features(mesh_lat, mesh_lon, mesh_lat, mesh_lon, s, r)
    mesh_bundle = GraphBundle(
        senders=s, receivers=r, edge_attr=mesh_attr, n_senders=n_mesh, n_receivers=n_mesh
    ).sorted_by_receiver()

    # m2g: senders are the 3 vertices of each grid point's containing triangle
    g_idx2, m_idx2 = in_mesh_triangle_indices(grid_lat, grid_lon, mesh)
    m2g_attr = edge_spatial_features(
        mesh_lat, mesh_lon, grid_nodes_lat, grid_nodes_lon, m_idx2, g_idx2,
        edge_normalization_factor=mesh2grid_edge_normalization_factor,
    )
    m2g = GraphBundle(
        senders=m_idx2, receivers=g_idx2, edge_attr=m2g_attr,
        n_senders=n_mesh, n_receivers=n_grid,
    ).sorted_by_receiver()

    # k-hop
    khop = None
    if num_hops > 0:
        ks, kr = khop_edges(s, r, n_mesh, num_hops)
        if add_edge_features_to_khop:
            k_attr = edge_spatial_features(mesh_lat, mesh_lon, mesh_lat, mesh_lon, ks, kr)
        else:
            k_attr = np.zeros((ks.shape[0], 0), dtype=np.float32)
        khop = GraphBundle(
            senders=ks, receivers=kr, edge_attr=k_attr, n_senders=n_mesh, n_receivers=n_mesh
        ).sorted_by_receiver()

    return GraphCastGraphs(
        g2m=g2m,
        mesh=mesh_bundle,
        m2g=m2g,
        khop=khop,
        grid_node_feats=node_spatial_features(grid_nodes_lat, grid_nodes_lon),
        mesh_node_feats=node_spatial_features(mesh_lat, mesh_lon),
        mesh_vertices=mesh.vertices,
    )
