"""The port's NumPy graph builders against the JAX package's, bit for bit.

The port carries its own copies of the host-side mesh code (it cannot
import the JAX package, whose __init__ imports flax). These tests hold the
copies to the originals on the golden 30° grid and on a 4° grid.
"""

import numpy as np
import pytest
import torch

from graph_weather_tpu.meshes import graphs as jax_graphs
from graph_weather_tpu.meshes.hexmesh import get_hexmesh as jax_get_hexmesh
from graph_weather_tpu.models.forecast import (
    reversal_conjugated_latent as jax_conjugated,
)
from graph_weather_tpu.ops.scatter import build_padded_csr as jax_build_padded_csr
from graph_weather_tpu_torch.meshes import graphs as port_graphs
from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh as port_get_hexmesh
from graph_weather_tpu_torch.models.forecast import (
    reversal_conjugated_latent as port_conjugated,
)
from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
from graph_weather_tpu_torch.ops.scatter import build_padded_csr as port_build_padded_csr

torch.set_num_threads(1)


def _grid(spacing):
    return np.asarray(
        [
            (a, b)
            for a in np.arange(-90.0, 90.0, spacing)
            for b in np.arange(0.0, 360.0, spacing)
        ],
        dtype=np.float64,
    )


def _assert_same_bundle(port, ref):
    assert (port.n_senders, port.n_receivers) == (ref.n_senders, ref.n_receivers)
    for name in ("senders", "receivers", "edge_attr"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_hexmesh_is_identical():
    port, ref = port_get_hexmesh(2), jax_get_hexmesh(2)
    assert port.num_cells == ref.num_cells == 5882
    for name in ("cell_xyz", "cell_latlon", "neighbor_idx", "neighbor_mask"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize("spacing", [30.0, 4.0])
def test_bipartite_graphs_are_identical(spacing):
    ll = _grid(spacing)
    port_mesh, ref_mesh = port_get_hexmesh(2), jax_get_hexmesh(2)
    _assert_same_bundle(
        port_graphs.build_grid_to_mesh_graph(ll, port_mesh),
        jax_graphs.build_grid_to_mesh_graph(ll, ref_mesh),
    )
    port_m2g = port_graphs.build_mesh_to_grid_graph(ll, port_mesh)
    ref_m2g = jax_graphs.build_mesh_to_grid_graph(ll, ref_mesh)
    _assert_same_bundle(port_m2g, ref_m2g)
    # 6 senders per point whose cell is a pentagon, else 7.
    assert port_m2g.n_edges <= 7 * len(ll)


@pytest.mark.parametrize("order", ["native", "reference"])
def test_latent_graph_is_identical(order):
    port = port_graphs.build_latent_graph(port_get_hexmesh(2))
    ref = jax_graphs.build_latent_graph(jax_get_hexmesh(2))
    if order == "reference":
        port, ref = port_conjugated(port), jax_conjugated(ref)
    assert port.n_edges == 41162
    _assert_same_bundle(port, ref)


@pytest.mark.parametrize("spacing", [30.0, 4.0])
def test_padded_csr_is_identical(spacing):
    ll = _grid(spacing)
    for build in (
        jax_graphs.build_mesh_to_grid_graph,
        jax_graphs.build_grid_to_mesh_graph,
    ):
        bundle = build(ll, jax_get_hexmesh(2))
        port_ids, port_mask = port_build_padded_csr(bundle.receivers, bundle.n_receivers)
        ref_ids, ref_mask = jax_build_padded_csr(bundle.receivers, bundle.n_receivers)
        assert port_ids.dtype == ref_ids.dtype and port_mask.dtype == ref_mask.dtype
        np.testing.assert_array_equal(port_ids, ref_ids)
        np.testing.assert_array_equal(port_mask, ref_mask)


def test_device_graph_arrays():
    """device_arrays gives int32 indices and f32 edge features; the CSR
    table is chosen for bounded in-degree only, as in the JAX package."""
    ll = _grid(30.0)
    mesh = port_get_hexmesh(2)
    m2g = DeviceGraph.from_bundle(port_graphs.build_mesh_to_grid_graph(ll, mesh))
    g2m = DeviceGraph.from_bundle(port_graphs.build_grid_to_mesh_graph(ll, mesh))
    assert m2g.senders.dtype == torch.int32 and m2g.receivers.dtype == torch.int32
    assert m2g.edge_attr.dtype == torch.float32
    assert m2g.csr_edge_ids is not None and m2g.csr_edge_ids.shape[1] <= 7
    # 30° grid: the polar cells receive 12 points each, under the CSR limit,
    # so the g2m choice follows the JAX package's threshold too.
    counts = np.bincount(g2m.receivers.numpy(), minlength=g2m.n_receivers)
    assert (g2m.csr_edge_ids is not None) == (counts.max() <= 16)
    bad = port_graphs.GraphBundle(
        senders=np.array([0, 9], np.int32),
        receivers=np.array([0, 1], np.int32),
        edge_attr=np.zeros((2, 2), np.float32),
        n_senders=5,
        n_receivers=2,
    )
    with pytest.raises(ValueError, match="senders out of range"):
        DeviceGraph.from_bundle(bad)
