"""The port's NumPy GenCast graph builders against the JAX package's.

The port carries its own copies of the icosphere, spatial-feature,
connectivity and clustering code (it cannot import the JAX package, whose
__init__ imports flax). Arrays must be bit-identical. The k-hop graph is
compared as an edge set per receiver: the JAX package may take a native BFS
whose sender order within a receiver differs from the port's SciPy path;
the cluster layout, which `np.unique`s each block's senders, is compared
bit for bit. Sizes are those of the small GenCast tests: a 32 x 16 grid,
splits 2, 2 hops.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graph_weather_tpu.meshes import clustering as jax_clustering
from graph_weather_tpu.meshes import connectivity as jax_connectivity
from graph_weather_tpu.meshes import icosphere as jax_icosphere
from graph_weather_tpu.meshes import spatial as jax_spatial
from graph_weather_tpu.meshes.graphs import GraphBundle as JaxGraphBundle
from graph_weather_tpu.models.gencast.graphs import build_graphcast_graphs as jax_build
from graph_weather_tpu.nn.graph_blocks import DeviceGraph as JaxDeviceGraph
from graph_weather_tpu_torch.meshes import clustering, connectivity, icosphere, spatial
from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph

torch.set_num_threads(1)
GRID_LON = np.arange(0.0, 360.0, 360.0 / 32)
GRID_LAT = np.linspace(-90.0, 90.0, 16)


def _same(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    np.testing.assert_array_equal(a, b, err_msg=name)


def _same_bundle(port, ref):
    assert (port.n_senders, port.n_receivers) == (ref.n_senders, ref.n_receivers)
    for name in ("senders", "receivers", "edge_attr"):
        _same(getattr(port, name), getattr(ref, name), name)


def _same_edge_set(port, ref):
    """Equal edge sets per receiver (and equal features per edge)."""
    assert (port.n_senders, port.n_receivers) == (ref.n_senders, ref.n_receivers)
    po = np.lexsort((port.senders, port.receivers))
    ro = np.lexsort((ref.senders, ref.receivers))
    for name in ("senders", "receivers", "edge_attr"):
        _same(getattr(port, name)[po], getattr(ref, name)[ro], name)
    _same(port.receivers, ref.receivers, "receiver order")


@pytest.mark.parametrize("orientation", ["pole", "graphcast"])
def test_icosphere_hierarchy_is_identical(orientation):
    port = icosphere.get_hierarchy_of_triangular_meshes_for_sphere(2, orientation)
    ref = jax_icosphere.get_hierarchy_of_triangular_meshes_for_sphere(2, orientation)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        _same(p.vertices, r.vertices, "vertices")
        _same(p.faces, r.faces, "faces")
    assert port[-1].vertices.shape[0] == icosphere.num_vertices(2) == 162
    for p, r in zip(icosphere.faces_to_edges(port[-1].faces), jax_icosphere.faces_to_edges(ref[-1].faces)):
        _same(p, r)
    _same(icosphere.merge_meshes(port).faces, jax_icosphere.merge_meshes(ref).faces)


def test_spatial_features_are_identical():
    rng = np.random.default_rng(0)
    lat_s, lon_s = rng.uniform(-90, 90, 40), rng.uniform(0, 360, 40)
    lat_r, lon_r = rng.uniform(-90, 90, 30), rng.uniform(0, 360, 30)
    s, r = rng.integers(0, 40, 100), rng.integers(0, 30, 100)
    _same(spatial.node_spatial_features(lat_s, lon_s), jax_spatial.node_spatial_features(lat_s, lon_s))
    for factor in (None, 0.7):
        _same(
            spatial.edge_spatial_features(lat_s, lon_s, lat_r, lon_r, s, r, factor),
            jax_spatial.edge_spatial_features(lat_s, lon_s, lat_r, lon_r, s, r, factor),
        )


@pytest.mark.parametrize("orientation", ["pole", "graphcast"])
def test_connectivity_is_identical(orientation):
    mesh = icosphere.get_hierarchy_of_triangular_meshes_for_sphere(2, orientation)[-1]
    for p, r in zip(
        connectivity.radius_query_indices(GRID_LAT, GRID_LON, mesh, 0.3),
        jax_connectivity.radius_query_indices(GRID_LAT, GRID_LON, mesh, 0.3),
    ):
        _same(p, r)
    for p, r in zip(
        connectivity.in_mesh_triangle_indices(GRID_LAT, GRID_LON, mesh),
        jax_connectivity.in_mesh_triangle_indices(GRID_LAT, GRID_LON, mesh),
    ):
        _same(p, r)


def test_clustering_is_identical():
    mesh = icosphere.get_hierarchy_of_triangular_meshes_for_sphere(3)[-1]
    _same(clustering.rcb_order(mesh.vertices, 64), jax_clustering.rcb_order(mesh.vertices, 64))
    rng = np.random.default_rng(1)
    receivers = np.sort(rng.integers(0, 300, 2000))
    senders = rng.integers(0, 280, 2000)
    port = clustering.build_cluster_layout(senders, receivers, 300, 280, block=64)
    ref = jax_clustering.build_cluster_layout(senders, receivers, 300, 280, block=64)
    assert port.block == ref.block and (port.n_blocks, port.u_pad) == (ref.n_blocks, ref.u_pad)
    _same(port.gather_ids, ref.gather_ids)
    _same(port.masks, ref.masks)
    sym_s, sym_r = np.concatenate([senders, receivers]), np.concatenate([receivers, senders])
    for s, r in ((senders, receivers), (sym_s, sym_r)):
        assert clustering.is_symmetric_edges(s, r) == jax_clustering.is_symmetric_edges(s, r)
    with pytest.raises(ValueError, match="out of range"):
        clustering.build_cluster_layout(senders, receivers, 300, 100, block=64)


@pytest.mark.parametrize(
    "spatial_sort,orientation,edge_feats",
    [(True, "pole", True), ("rcb", "pole", False), ("rcb", "graphcast", True), (False, "graphcast", False)],
    ids=["latlon_pole", "rcb_pole", "rcb_graphcast", "unsorted_graphcast"],
)
def test_graphcast_graphs_are_identical(spatial_sort, orientation, edge_feats):
    kw = dict(
        splits=2, num_hops=2, add_edge_features_to_khop=edge_feats,
        spatial_sort=spatial_sort, mesh_orientation=orientation,
    )
    port = build_graphcast_graphs(GRID_LON, GRID_LAT, **kw)
    ref = jax_build(GRID_LON, GRID_LAT, **kw)
    for name in ("g2m", "mesh", "m2g"):
        _same_bundle(getattr(port, name), getattr(ref, name))
    _same_edge_set(port.khop, ref.khop)
    for name in ("grid_node_feats", "mesh_node_feats", "mesh_vertices"):
        _same(getattr(port, name), getattr(ref, name), name)
    assert port.khop.edge_attr.shape[1] == (4 if edge_feats else 0)
    # The cluster layout does not depend on the senders' order.
    kh, rk = port.khop, ref.khop
    lp = clustering.build_cluster_layout(kh.senders, kh.receivers, kh.n_receivers, kh.n_senders, block=64)
    lr = jax_clustering.build_cluster_layout(rk.senders, rk.receivers, rk.n_receivers, rk.n_senders, block=64)
    _same(lp.gather_ids, lr.gather_ids)
    _same(lp.masks, lr.masks)


def test_device_graph_cluster_fields():
    """from_bundle(clustered=True) carries the JAX package's layout: int32
    ids, int8 masks, the block and the symmetric flag; the inverse index
    only for a graph that is not symmetric."""
    graphs = build_graphcast_graphs(
        GRID_LON, GRID_LAT, splits=2, num_hops=2, add_edge_features_to_khop=False, spatial_sort="rcb"
    )
    port = DeviceGraph.from_bundle(graphs.khop, "cpu", clustered=True, cluster_block=64)
    # The JAX package's own bundle type: the port's arrays now default to the card.
    ref = JaxDeviceGraph.from_bundle(
        JaxGraphBundle(**dataclasses.asdict(graphs.khop)), clustered=True, cluster_block=64
    )
    assert port.cluster_ids.dtype == torch.int32 and port.cluster_masks.dtype == torch.int8
    _same(port.cluster_ids.numpy(), np.asarray(ref.cluster_ids))
    _same(port.cluster_masks.numpy(), np.asarray(ref.cluster_masks))
    assert port.cluster_block == ref.cluster_block == 64
    assert port.cluster_symmetric == ref.cluster_symmetric is True
    assert port.cluster_scatter is None  # K3c needs no inverse index
    # A bipartite graph is not symmetric: K3b's inverse index comes with it.
    g2m = DeviceGraph.from_bundle(graphs.g2m, "cpu", clustered=True, cluster_block=64)
    assert g2m.cluster_symmetric is False
    assert g2m.cluster_scatter.dtype == torch.int64
    assert g2m.cluster_scatter.shape[0] == graphs.g2m.n_senders
    plain = DeviceGraph.from_bundle(graphs.khop, "cpu")
    assert plain.cluster_ids is None and plain.cluster_block == 0
